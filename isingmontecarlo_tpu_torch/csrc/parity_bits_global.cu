// K2's global-memory variant: the diagonal precompute's flip-parity scan for
// any number of spins N.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/parity_kernel.py::parity_bits, as parity_bits.cu
// does, for the N whose carry no CTA's shared memory holds (parity_bits.cu
// keeps one or two N-bit vectors of 32 replicas in a CTA's shared memory, so
// it takes N up to 53,472 on an H100; the wrapper's k2_variant picks). Same
// three passes
// over the same scratch, seg[s][w][r]:
//
// 1. parity_global_segments: a thread per (replica, segment) XORs its
//    segment's toggles into its own column of seg[s] (zeroed by the
//    wrapper), in place in global memory;
// 2. parity_global_prefix: a thread per (word, replica) replaces the
//    segments' vectors by their exclusive XOR prefix and packs the p=0
//    state into row nseg (parity_bits.cu's prefix pass);
// 3. parity_global_walk: a thread per (replica, segment) walks its segment
//    from its prefix, reading each proposal leg's parity and p=0 spin from
//    seg[s] and seg[nseg] before the slot's toggles, then XORing them into
//    seg[s] in place.
//
// A slot touches K words of a thread's carry, and each thread owns its
// replica's column, so no two threads write one word. Slot rows are read
// and pb/sb written coalesced along R; the carry words a warp touches at
// once lie in different rows (its lanes' variables differ), one sector
// each. The wrapper caps the scratch so that it stays in the 50 MB L2.
// Bound on the card: the latency of those scattered read-modify-writes,
// one chain a thread; a simple kernel, kept for the N past what
// parity_bits.cu's wide walk holds (one warp's carry in a CTA's shared
// memory: N up to 53,472 on an H100). As in parity_bits.cu, a slot's
// toggled legs act as a set: two legs on one variable flip it once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "parity_legs.cuh"

namespace {

__global__ void parity_global_segments(const int32_t* __restrict__ v_idx,
                                       const uint8_t* __restrict__ tog,
                                       uint32_t* __restrict__ seg, int K, int M, int R,
                                       int N, int seg_len, int nseg) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  // The last segment's toggles are never needed.
  if (r >= R || s >= nseg - 1) return;
  const int64_t plane = (int64_t)M * R, row = (int64_t)((N + 31) >> 5) * R;
  uint32_t* par = seg + s * row + r;
  const int p_end = min(M, (s + 1) * seg_len);
  for (int p = s * seg_len; p < p_end; ++p) {
    for (int k = 0; k < K; ++k) {
      int w = 0;
      const uint32_t m = leg_toggle(v_idx, tog, k, plane, (int64_t)p * R + r, N, &w);
      if (m) par[(int64_t)w * R] ^= m;
    }
  }
}

// seg[s] := XOR of the vectors of segments < s (segment nseg - 1 was not
// written), and seg[nseg] := the packed p=0 state; a thread per (word,
// replica), replicas fastest.
__global__ void parity_global_prefix(const uint8_t* __restrict__ state,
                                     uint32_t* __restrict__ seg, int R, int N, int nseg) {
  const int W = (N + 31) >> 5;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)W * R) return;
  const int w = (int)(i / R), r = (int)(i - (int64_t)w * R);
  const int64_t row = (int64_t)W * R;
  uint32_t word = 0;
  const uint8_t* st = state + (int64_t)r * N + 32 * w;
  const int nb = min(32, N - 32 * w);
  for (int b = 0; b < nb; ++b) word |= (uint32_t)(st[b] != 0) << b;
  seg[(int64_t)nseg * row + i] = word;
  uint32_t acc = 0;
  for (int s = 0; s < nseg; ++s) {
    const uint32_t x = s < nseg - 1 ? seg[s * row + i] : 0u;
    seg[s * row + i] = acc;
    acc ^= x;
  }
}

__global__ void parity_global_walk(const int32_t* __restrict__ v_idx,
                                   const uint8_t* __restrict__ tog,
                                   const int32_t* __restrict__ vq, uint32_t* seg,
                                   uint8_t* __restrict__ pb, uint8_t* __restrict__ sb,
                                   int K, int M, int R, int N, int seg_len, int nseg) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (r >= R || s >= nseg) return;
  const int64_t plane = (int64_t)M * R, row = (int64_t)((N + 31) >> 5) * R;
  uint32_t* par = seg + s * row + r;
  const uint32_t* stw = seg + nseg * row + r;
  const int p_end = min(M, (s + 1) * seg_len);
  for (int p = s * seg_len; p < p_end; ++p) {
    const int64_t at = (int64_t)p * R + r;
    // The fetches read the carry before slot p, so before its toggles.
    for (int k = 0; k < K; ++k) {
      const int q = vq[k * plane + at];
      const bool ok = (unsigned)q < (unsigned)N;
      const int64_t w = ok ? (int64_t)(q >> 5) * R : 0;
      const int sh = q & 31;
      pb[k * plane + at] = ok ? (par[w] >> sh) & 1u : 0u;
      sb[k * plane + at] = ok ? (stw[w] >> sh) & 1u : 0u;
    }
    for (int k = 0; k < K; ++k) {
      int w = 0;
      const uint32_t m = leg_toggle(v_idx, tog, k, plane, at, N, &w);
      if (m) par[(int64_t)w * R] ^= m;
    }
  }
}

}  // namespace

// seg: scratch of (nseg + 1) * ceil(N / 32) * R words, rows 0 .. nseg - 2
// zeroed, nseg = ceil(M / seg_len) <= 65535.
extern "C" int ising_parity_bits_global(const void* state, const void* v_idx,
                                        const void* tog, const void* vq, void* seg,
                                        void* pb, void* sb, int K, int M, int R, int N,
                                        int seg_len, void* stream) {
  if (R == 0 || M == 0) return (int)cudaGetLastError();
  if (seg_len <= 0 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int nseg = (M + seg_len - 1) / seg_len;
  if (nseg > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = R >= 128 ? 128 : 32 * ((R + 31) / 32);
  const unsigned rblocks = (unsigned)((R + threads - 1) / threads);
  const int W = (N + 31) / 32;
  if (nseg > 1) {
    parity_global_segments<<<dim3(rblocks, nseg - 1), threads, 0, s>>>(
        (const int32_t*)v_idx, (const uint8_t*)tog, (uint32_t*)seg, K, M, R, N, seg_len,
        nseg);
  }
  parity_global_prefix<<<(unsigned)(((int64_t)W * R + 255) / 256), 256, 0, s>>>(
      (const uint8_t*)state, (uint32_t*)seg, R, N, nseg);
  parity_global_walk<<<dim3(rblocks, nseg), threads, 0, s>>>(
      (const int32_t*)v_idx, (const uint8_t*)tog, (const int32_t*)vq, (uint32_t*)seg,
      (uint8_t*)pb, (uint8_t*)sb, K, M, R, N, seg_len, nseg);
  return (int)cudaGetLastError();
}
