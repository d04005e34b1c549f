// K2: the diagonal precompute's flip-parity scan.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/parity_kernel.py::parity_bits. For every slot p
// and leg k it reads, for the proposal variable vq[k, p, r], the parity of
// the off-diagonal flips on that variable before slot p and its p=0 spin
// (an exclusive scan), then XORs slot p's leg toggles into the carry. A
// variable outside [0, N) is a sentinel: no toggle, and both bits read 0.
//
// Bound on the card: latency. The carry makes the slots of one replica a
// serial chain (a shared-memory read-modify-write per toggle, read again by
// later fetches); with one thread per replica only R threads would exist,
// one warp per SM, and every instruction's latency would be exposed. So the
// M slots are cut into segments of seg_len slots, scanned in two passes:
//
// 1. segment_toggles_kernel: one thread per (replica, segment) XORs its
//    segment's toggles into an N-bit word vector and stores it to the
//    scratch seg[s][w][r];
// 2. parity_bits_kernel: one thread per (replica, segment) starts from the
//    XOR of the vectors of the segments before it (exact: XOR is
//    associative) and walks its segment, fetching and toggling.
//
// XOR is associative, so the bits equal those of a single serial scan. A
// thread keeps its carry and its replica's p=0 state as 32-bit words in
// shared memory, laid out word-major and lane-minor (x[w * 32 + lane]) so
// that whatever word each lane touches, a warp hits 32 distinct banks; the
// 32 lanes of a block are 32 replicas, so slot rows are read and bits
// written coalesced along R. Slot loads do not depend on the chain, so a
// thread loads a tile of kTile slots into registers before walking them.
//
// A slot must not name one variable on two legs (no model bond does).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTile = 16;

template <int K>
__global__ void segment_toggles_kernel(const int32_t* __restrict__ v_idx,
                                       const uint8_t* __restrict__ tog,
                                       uint32_t* __restrict__ seg,
                                       int M, int R, int N, int seg_len) {
  extern __shared__ uint32_t par[];  // [W][kThreads]
  const int W = (N + 31) >> 5;
  const int t = threadIdx.x;
  const int r = blockIdx.x * kThreads + t;
  const int s = blockIdx.y;
  if (r >= R) return;  // each thread owns its column: no barrier follows
  for (int w = 0; w < W; ++w) par[w * kThreads + t] = 0u;
  const int64_t plane = (int64_t)M * R;
  const int p_end = min(M, (s + 1) * seg_len);
  for (int p0 = s * seg_len; p0 < p_end; p0 += kTile) {
    const int n = min(kTile, p_end - p0);
    int v[kTile][K];
    bool tg[kTile][K];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t i = k * plane + (int64_t)(p0 + j) * R + r;
        const bool in = j < n;
        v[j][k] = in ? v_idx[i] : -1;
        tg[j][k] = in && tog[i] != 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int vv = v[j][k];
        if (tg[j][k] && (unsigned)vv < (unsigned)N) {
          par[(vv >> 5) * kThreads + t] ^= 1u << (vv & 31);
        }
      }
    }
  }
  for (int w = 0; w < W; ++w) {
    seg[((int64_t)s * W + w) * R + r] = par[w * kThreads + t];
  }
}

template <int K>
__global__ void parity_bits_kernel(const uint8_t* __restrict__ state,
                                   const int32_t* __restrict__ v_idx,
                                   const uint8_t* __restrict__ tog,
                                   const int32_t* __restrict__ vq,
                                   const uint32_t* __restrict__ seg,
                                   uint8_t* __restrict__ pb,
                                   uint8_t* __restrict__ sb,
                                   int M, int R, int N, int seg_len) {
  extern __shared__ uint32_t smem[];
  const int W = (N + 31) >> 5;
  uint32_t* par = smem;                  // [W][kThreads] parity carry
  uint32_t* stw = smem + W * kThreads;   // [W][kThreads] packed p=0 state
  const int t = threadIdx.x;
  const int r = blockIdx.x * kThreads + t;
  const int s = blockIdx.y;
  if (r >= R) return;  // each thread owns its columns: no barrier follows
  const uint8_t* st = state + (int64_t)r * N;
  for (int w = 0; w < W; ++w) {
    uint32_t word = 0;
    const int nb = min(32, N - 32 * w);
    for (int b = 0; b < nb; ++b) word |= (uint32_t)(st[32 * w + b] != 0) << b;
    stw[w * kThreads + t] = word;
    uint32_t carry = 0;  // the toggles of every segment before this one
    for (int s2 = 0; s2 < s; ++s2) carry ^= seg[((int64_t)s2 * W + w) * R + r];
    par[w * kThreads + t] = carry;
  }
  const int64_t plane = (int64_t)M * R;
  const int p_end = min(M, (s + 1) * seg_len);
  for (int p0 = s * seg_len; p0 < p_end; p0 += kTile) {
    const int n = min(kTile, p_end - p0);
    int q[kTile][K], v[kTile][K];
    bool tg[kTile][K];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t i = k * plane + (int64_t)(p0 + j) * R + r;
        const bool in = j < n;
        q[j][k] = in ? vq[i] : -1;
        v[j][k] = in ? v_idx[i] : -1;
        tg[j][k] = in && tog[i] != 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= n) break;
      const int64_t row = (int64_t)(p0 + j) * R + r;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint8_t pbit = 0, sbit = 0;
        const int qq = q[j][k];
        if ((unsigned)qq < (unsigned)N) {
          const int a = (qq >> 5) * kThreads + t;
          pbit = (par[a] >> (qq & 31)) & 1u;
          sbit = (stw[a] >> (qq & 31)) & 1u;
        }
        pb[k * plane + row] = pbit;
        sb[k * plane + row] = sbit;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int vv = v[j][k];
        if (tg[j][k] && (unsigned)vv < (unsigned)N) {
          par[(vv >> 5) * kThreads + t] ^= 1u << (vv & 31);
        }
      }
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int K>
int launch(const void* state, const void* v_idx, const void* tog,
           const void* vq, void* seg, void* pb, void* sb, int M, int R, int N,
           int seg_len, cudaStream_t stream) {
  const int W = (N + 31) / 32;
  const size_t words = (size_t)W * kThreads * sizeof(uint32_t);
  const int nseg = (M + seg_len - 1) / seg_len;
  const int rblocks = (R + kThreads - 1) / kThreads;
  cudaError_t e = allow_smem((const void*)segment_toggles_kernel<K>, words);
  if (e == cudaSuccess) e = allow_smem((const void*)parity_bits_kernel<K>, 2 * words);
  if (e != cudaSuccess) return (int)e;
  if (nseg > 1) {  // the last segment's toggles are never needed
    segment_toggles_kernel<K><<<dim3(rblocks, nseg - 1), kThreads, words, stream>>>(
        (const int32_t*)v_idx, (const uint8_t*)tog, (uint32_t*)seg, M, R, N,
        seg_len);
  }
  parity_bits_kernel<K><<<dim3(rblocks, nseg), kThreads, 2 * words, stream>>>(
      (const uint8_t*)state, (const int32_t*)v_idx, (const uint8_t*)tog,
      (const int32_t*)vq, (const uint32_t*)seg, (uint8_t*)pb, (uint8_t*)sb, M,
      R, N, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

// seg: scratch of at least (ceil(M / seg_len) - 1) * ceil(N / 32) * R words.
extern "C" int ising_parity_bits(const void* state, const void* v_idx,
                                 const void* tog, const void* vq, void* seg,
                                 void* pb, void* sb, int K, int M, int R, int N,
                                 int seg_len, void* stream) {
  if (R == 0 || M == 0) return (int)cudaGetLastError();
  if (seg_len <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch<1>(state, v_idx, tog, vq, seg, pb, sb, M, R, N, seg_len, s);
    case 2: return launch<2>(state, v_idx, tog, vq, seg, pb, sb, M, R, N, seg_len, s);
    case 3: return launch<3>(state, v_idx, tog, vq, seg, pb, sb, M, R, N, seg_len, s);
    case 4: return launch<4>(state, v_idx, tog, vq, seg, pb, sb, M, R, N, seg_len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
