// K4: per-replica gather out[e, r] = table[idx[e, r], r].
//
// Replaces the Pallas kernel isingmontecarlo_tpu/ops/take_kernel.py::take0,
// which routes the gather through base-128 digit planes on the TPU's matrix
// unit because per-lane gathers scalarise there (exact only for C < 2^14
// rows and values < 2^24). A GPU gathers natively, so this is one thread per
// output element, with none of those caps: any C, any int32 value.
//
// Bound on the card: memory latency of the scattered table reads. idx and
// out are read and written coalesced along R; the table reads of one warp
// land on up to 32 rows. At the cluster update's shapes (C ~ 8000,
// R = 256, int32) the table is 8 MB and stays in the 50 MB L2, so the
// scattered reads are served from L2, not HBM.
//
// An index outside [0, C) reads nothing and writes INT32_MIN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The caller keeps E * R and C * R below 2^31, so index math is 32-bit (a
// 64-bit modulo costs tens of instructions on the GPU).
__global__ void take0_kernel(const int32_t* __restrict__ table,
                             const int32_t* __restrict__ idx,
                             int32_t* __restrict__ out,
                             int C, int total, int R) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int r = t % R;
  const int i = idx[t];
  out[t] = ((unsigned)i < (unsigned)C) ? table[i * R + r] : INT32_MIN;
}

}  // namespace

extern "C" int ising_take0(const void* table, const void* idx, void* out,
                           int C, int E, int R, void* stream) {
  const int total = E * R;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  take0_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)idx, (int32_t*)out, C, total, R);
  return (int)cudaGetLastError();
}

extern "C" const char* ising_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
