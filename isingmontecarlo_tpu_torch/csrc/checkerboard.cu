// K1: nsweeps checkerboard Metropolis sweeps of a periodic L x L field.
//
// Replaces the Pallas kernel isingmontecarlo_tpu/ops/checkerboard.py::
// checkerboard_multi_sweep, which holds one replica's field in VMEM for all
// sweeps and touches HBM twice. Here one block per replica holds both
// compact colour planes (L x L/2 int8 each, L*L bytes in all) in dynamic
// shared memory: the field is read from global memory once, all nsweeps
// sweeps run between __syncthreads() barriers, and it is written once.
//
// Layout and arithmetic are those of ops/checkerboard.py (its plain version
// gives the same spins bit for bit): plane E holds s[y, 2k + (y & 1)], plane
// O the rest; a site's neighbours are the other plane at rows y +- 1 and at
// columns k and k -+ 1 by row parity. The draw of site i of a plane is word
// i % 4 of Philox4x32-10(counter = (i / 4, sweep, colour, replica), key =
// the 64-bit seed), u = (word >> 8) * 2^-24, and the site flips when
// u < p[s][up neighbours], a table of the 10 acceptance probabilities that
// the wrapper computes once with torch.exp. Nothing here evaluates exp.
//
// Bound on the card: integer operations. Each attempt costs a quarter of a
// Philox call (10 rounds of two 32x32 multiplies, hi and lo, and four XORs;
// ~25 operations an attempt) and ~10 for the neighbour sum and the test,
// while the bytes are 2 * L * L per replica per call. Each thread draws one
// Philox output for four consecutive sites, so no word is wasted.
//
// Limits of this simple design: one block per replica, so R = 64 replicas
// occupy 64 of the 132 SMs; and both planes must fit one block's shared
// memory, L * L <= 232,448 bytes (L <= 482). The wrapper raises beyond it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Random123's
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 1024;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
checkerboard_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    const float* __restrict__ table, uint32_t k0, uint32_t k1,
                    int L, int nsweeps) {
  extern __shared__ uint8_t planes[];  // [2][L][H]
  __shared__ float p[10];              // p[5 * s + up neighbours]
  const int H = L / 2, LH = L * H;
  const int r = blockIdx.x;
  const uint8_t* src = in + (size_t)r * L * L;
  uint8_t* dst = out + (size_t)r * L * L;

  if (threadIdx.x < 10) p[threadIdx.x] = table[threadIdx.x];
  for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
    const int y = i / L, x = i - y * L;
    planes[((x + y) & 1) * LH + y * H + (x >> 1)] = src[i] != 0;
  }
  __syncthreads();

  const int n_groups = (LH + 3) / 4;
  for (int t = 0; t < nsweeps; ++t) {
    for (int c = 0; c < 2; ++c) {
      uint8_t* own = planes + c * LH;
      const uint8_t* oth = planes + (1 - c) * LH;
      for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
        const uint4 w = philox4x32_10(make_uint4(g, t, c, r), k0, k1);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        int y = (4 * g) / H, k = 4 * g - y * H;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (y < L) {
            const int yu = y == 0 ? L - 1 : y - 1;
            const int yd = y == L - 1 ? 0 : y + 1;
            // Column k - 1 for plane E on even rows and plane O on odd
            // rows, else k + 1 (periodic).
            const bool back = ((y & 1) == 0) == (c == 0);
            const int ks = back ? (k == 0 ? H - 1 : k - 1) : (k == H - 1 ? 0 : k + 1);
            const int ups = oth[yu * H + k] + oth[yd * H + k] + oth[y * H + k] +
                            oth[y * H + ks];
            const int s = own[y * H + k];
            const float u = __fmul_rn(__uint2float_rn(words[i] >> 8), 0x1p-24f);
            own[y * H + k] = s ^ (u < p[5 * s + ups]);
          }
          if (++k == H) {
            k = 0;
            ++y;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < L * L; i += blockDim.x) {
    const int y = i / L, x = i - y * L;
    dst[i] = planes[((x + y) & 1) * LH + y * H + (x >> 1)];
  }
}

}  // namespace

extern "C" int ising_checkerboard(const void* in, void* out, const void* table,
                                  unsigned k0, unsigned k1, int R, int L,
                                  int nsweeps, void* stream) {
  if (R == 0 || L == 0) return (int)cudaGetLastError();
  const int smem = L * L;
  const cudaError_t e = cudaFuncSetAttribute(
      checkerboard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  checkerboard_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const float*)table, k0, k1, L, nsweeps);
  return (int)cudaGetLastError();
}
