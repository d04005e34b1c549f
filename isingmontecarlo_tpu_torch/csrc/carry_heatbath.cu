// K3-hb (heat-bath variant): the diagonal sweep's op-count carry scan.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/diag_carry.py::carry_decisions (body
// _kernel_heatbath). The twin of carry_metropolis.cu: each slot's
// insert/remove decision depends on the op count n entering the slot, which
// the decisions before it change, so the scan over M is sequential per
// replica: one thread per replica walks the M slots and keeps n in a
// register, with the replica's bwt = beta * sum_b max_w(b) in another.
//
// Bound on the card: latency. The bytes are 9 per slot and replica (u0,
// the three masks, the two outputs), which the card moves in microseconds;
// what would dominate is the global-memory latency of each slot's loads and
// then the serial chain through n (an int add, an int to float conversion,
// two adds, two multiplies and two compares per slot). No load depends on
// n, so each thread loads a tile of kTile slots into registers before it
// walks them: one memory latency per tile. The [M, R] planes are read
// coalesced along R.
//
// The arithmetic is the f32 expressions of isingmontecarlo_tpu/sse/
// diagonal.py::_ins_rem (heat-bath branch), with the strict < comparisons
// and JAX's left-to-right association, evaluated with round-to-nearest
// intrinsics so that nothing is contracted into an FMA:
//   mmn    = float(M - n)
//   insert = idp && insw && u0 * (mmn + bwt) < bwt
//   remove = dgp && u0 * ((mmn + 1) + bwt) < mmn + 1

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;

__global__ void carry_heatbath_kernel(const int32_t* __restrict__ n0,
                                      const float* __restrict__ u0,
                                      const uint8_t* __restrict__ idp,
                                      const uint8_t* __restrict__ dgp,
                                      const uint8_t* __restrict__ insw,
                                      const float* __restrict__ bwt,
                                      uint8_t* __restrict__ insert,
                                      uint8_t* __restrict__ remove,
                                      int M, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int n = n0[r];
  const float bw = bwt[r];
  for (int p0 = 0; p0 < M; p0 += kTile) {
    const int cnt = min(kTile, M - p0);
    float u[kTile];
    bool ip[kTile], iw[kTile], dp[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      // Each load hangs on the slot's bound check only, never on another
      // load's value, so all of a tile's loads are in flight together.
      const int64_t i = (int64_t)(p0 + j) * R + r;
      const bool in = j < cnt;
      u[j] = in ? u0[i] : 0.0f;
      ip[j] = in && idp[i] != 0;
      iw[j] = in && insw[i] != 0;
      dp[j] = in && dgp[i] != 0;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= cnt) break;
      const int64_t i = (int64_t)(p0 + j) * R + r;
      const float mmn = __int2float_rn(M - n);
      const float mmn1 = __fadd_rn(mmn, 1.0f);
      const bool ins = ip[j] & iw[j] & (__fmul_rn(u[j], __fadd_rn(mmn, bw)) < bw);
      const bool rem = dp[j] & (__fmul_rn(u[j], __fadd_rn(mmn1, bw)) < mmn1);
      insert[i] = ins;
      remove[i] = rem;
      n += (int)ins - (int)rem;
    }
  }
}

}  // namespace

extern "C" int ising_carry_heatbath(const void* n0, const void* u0,
                                    const void* idp, const void* dgp,
                                    const void* insw, const void* bwt,
                                    void* insert, void* remove, int M, int R,
                                    void* stream) {
  if (R == 0 || M == 0) return (int)cudaGetLastError();
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  carry_heatbath_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)n0, (const float*)u0, (const uint8_t*)idp,
      (const uint8_t*)dgp, (const uint8_t*)insw, (const float*)bwt,
      (uint8_t*)insert, (uint8_t*)remove, M, R);
  return (int)cudaGetLastError();
}
