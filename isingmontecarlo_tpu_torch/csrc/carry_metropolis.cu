// K3 (Metropolis variant): the diagonal sweep's op-count carry scan.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/diag_carry.py::carry_decisions (body
// _kernel_metropolis). Each slot's insert/remove decision depends on the op
// count n entering the slot, which the decisions before it change, so the
// scan over M is sequential per replica: one thread per replica walks the M
// slots and keeps n in a register.
//
// Bound on the card: latency. The serial chain through n is short (an int
// add, an int to float conversion, a multiply and a compare per slot), so
// what would dominate is the global-memory latency of each slot's five
// loads. None of them depends on n, so each thread loads a tile of kTile
// slots into registers before it walks them: one memory latency per tile.
// The [M, R] planes are read coalesced along R.
//
// The arithmetic is the f32 expressions of isingmontecarlo_tpu/sse/
// diagonal.py::_ins_rem, with the two strict < comparisons, evaluated with
// round-to-nearest intrinsics so that nothing is contracted into an FMA:
//   mmn    = float(M - n)
//   insert = idp && u0 * mmn < num_ins
//   remove = dgp && u0 * num_rem < mmn + 1

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;

__global__ void carry_metropolis_kernel(const int32_t* __restrict__ n0,
                                        const float* __restrict__ u0,
                                        const uint8_t* __restrict__ idp,
                                        const uint8_t* __restrict__ dgp,
                                        const float* __restrict__ num_ins,
                                        const float* __restrict__ num_rem,
                                        uint8_t* __restrict__ insert,
                                        uint8_t* __restrict__ remove,
                                        int M, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int n = n0[r];
  for (int p0 = 0; p0 < M; p0 += kTile) {
    const int cnt = min(kTile, M - p0);
    float u[kTile], ni[kTile], nr[kTile];
    bool ip[kTile], dp[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int64_t i = (int64_t)(p0 + j) * R + r;
      const bool in = j < cnt;
      u[j] = in ? u0[i] : 0.0f;
      ni[j] = in ? num_ins[i] : 0.0f;
      nr[j] = in ? num_rem[i] : 0.0f;
      ip[j] = in && idp[i] != 0;
      dp[j] = in && dgp[i] != 0;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= cnt) break;
      const int64_t i = (int64_t)(p0 + j) * R + r;
      const float mmn = __int2float_rn(M - n);
      const bool ins = ip[j] & (__fmul_rn(u[j], mmn) < ni[j]);
      const bool rem = dp[j] & (__fmul_rn(u[j], nr[j]) < __fadd_rn(mmn, 1.0f));
      insert[i] = ins;
      remove[i] = rem;
      n += (int)ins - (int)rem;
    }
  }
}

}  // namespace

extern "C" int ising_carry_metropolis(const void* n0, const void* u0,
                                      const void* idp, const void* dgp,
                                      const void* num_ins, const void* num_rem,
                                      void* insert, void* remove, int M, int R,
                                      void* stream) {
  if (R == 0 || M == 0) return (int)cudaGetLastError();
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  carry_metropolis_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)n0, (const float*)u0, (const uint8_t*)idp,
      (const uint8_t*)dgp, (const float*)num_ins, (const float*)num_rem,
      (uint8_t*)insert, (uint8_t*)remove, M, R);
  return (int)cudaGetLastError();
}
