// K2: the diagonal precompute's flip-parity scan.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/parity_kernel.py::parity_bits. For every slot p
// and leg k it reads, for the proposal variable vq[k, p, r], the parity of
// the off-diagonal flips on that variable before slot p and its p=0 spin
// (an exclusive scan), then XORs slot p's leg toggles into the carry. A
// variable outside [0, N) is a sentinel: no toggle, and both bits read 0.
// Any number of legs K >= 1 (K = 1..4 unrolled in registers, more through
// a loop over the legs).
//
// Bound on the card: bytes and instruction issue, once the chain is hidden
// (at K=2, M=7000, R=256, N=1024 on an H100, about 0.012 ms each; the
// three launches take about 0.043 ms). The carry makes the
// slots of one replica a serial chain (a shared-memory read-modify-write
// per toggle, read again by later fetches), so the M slots are cut into
// nseg segments of seg_len slots and scanned in three launches:
//
// 1. parity_segments_kernel: a warp per (32 replicas, segment), lane =
//    replica, XORs its segment's toggles into an N-bit vector (W = N/32
//    words a lane, in shared memory) and stores it to seg[s][w][r];
// 2. parity_prefix_kernel: a thread per (word, replica) replaces the
//    segments' vectors by their exclusive XOR prefix, one linear pass over
//    s, and packs the replica's p=0 state word once (scratch row nseg);
// 3. parity_bits_kernel: a CTA of up to 8 warps, one replica group and 8
//    consecutive segments, loads the group's packed state into shared
//    memory once; each warp starts its carry from its segment's prefix and
//    walks the segment.
//
// XOR is associative, so the bits equal those of a single serial scan. The
// wrapper picks nseg so that about 16 warps run on each SM (the earlier
// design had one-warp CTAs, ~4 warps an SM, an XOR over every earlier
// segment in each thread and the state packed from bytes by every
// segment). Shared words are laid out word-major, lane-minor (x[w * 32 +
// lane]), so whatever word each lane touches, a warp hits 32 distinct
// banks; slot rows are read coalesced along R. A warp loads a tile of slots
// into registers before it walks them (the loads do not depend on the
// chain), and within a slot it issues every shared load (fetches and the
// words it toggles) before any store, so a slot costs one shared-memory
// latency on the chain; two legs toggling one word combine in registers.
// The walk keeps each (leg, slot)'s 32 bits as a warp ballot, and after 4
// slots every lane stores 4 bytes (slot lane / 8, replicas 4 * (lane % 8)
// .. + 3) of pb and of sb.
//
// A slot must not name one variable on two legs (no model bond does).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr unsigned kAll = 0xFFFFFFFFu;

// Slots a warp holds in registers at once: 32 loads a lane for K <= 4 legs
// (a multiple of 4, the slots of one store). KT = 0 is the loop over any K.
template <int KT>
constexpr int kTileSlots = KT == 1 ? 32 : KT == 2 ? 16 : 8;

// 4 bits -> 4 bytes of 0/1.
__device__ __forceinline__ uint32_t spread4(uint32_t m) {
  return (m & 1u) | (m & 2u) << 7 | (m & 4u) << 14 | (m & 8u) << 21;
}

// Store the 4 bytes of replicas r0 .. r0 + 3 at row offset `at` (a multiple
// of R): one 32-bit store (kWords: R % 4 == 0), else byte stores.
template <bool kWords>
__device__ __forceinline__ void store4(uint8_t* out, int64_t at, int r0, int R,
                                       uint32_t bits4) {
  if (r0 >= R) return;
  if (kWords) {
    *reinterpret_cast<uint32_t*>(out + at + r0) = spread4(bits4);
  } else {
    for (int i = 0; i < 4 && r0 + i < R; ++i) out[at + r0 + i] = (bits4 >> i) & 1u;
  }
}

// XOR one slot's KT leg toggles into the carry: every word loaded before
// any store, so the slot costs one shared-memory latency; legs that toggle
// one word store the same combined word.
template <int KT>
__device__ __forceinline__ void toggle_slot(uint32_t* par, const int* v, const bool* tg, int N,
                                            int lane) {
  uint32_t tw[KT], tm[KT];
  int at[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int vv = v[k];
    const bool ok = tg[k] && (unsigned)vv < (unsigned)N;
    at[k] = ok ? (vv >> 5) * kWarp + lane : lane;
    tw[k] = par[at[k]];
    tm[k] = ok ? 1u << (vv & 31) : 0u;
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    uint32_t nw = tw[k] ^ tm[k];
#pragma unroll
    for (int k2 = 0; k2 < KT; ++k2) {
      if (k2 != k && at[k2] == at[k]) nw ^= tm[k2];
    }
    if (tm[k]) par[at[k]] = nw;
  }
}

template <int KT>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 2) parity_segments_kernel(const int32_t* __restrict__ v_idx,
                                       const uint8_t* __restrict__ tog,
                                       uint32_t* __restrict__ seg, int K, int M, int R,
                                       int N, int seg_len, int nseg) {
  extern __shared__ uint32_t smem[];
  constexpr int T = kTileSlots<KT>;
  const int W = (N + 31) >> 5;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int s = blockIdx.y * (blockDim.x >> 5) + wid;
  const int r = blockIdx.x * kWarp + lane;
  // The last segment's toggles are never needed; no barrier follows.
  if (s >= nseg - 1) return;
  const bool active = r < R;
  uint32_t* par = smem + wid * W * kWarp;
  for (int w = 0; w < W; ++w) par[w * kWarp + lane] = 0u;
  const int64_t plane = (int64_t)M * R;
  const int p_begin = s * seg_len, p_end = min(M, p_begin + seg_len);
  if constexpr (KT == 0) {
    for (int p = p_begin; p < p_end; ++p) {
      for (int k = 0; k < K && active; ++k) {
        const int64_t i = k * plane + (int64_t)p * R + r;
        const int vv = v_idx[i];
        if (tog[i] && (unsigned)vv < (unsigned)N) par[(vv >> 5) * kWarp + lane] ^= 1u << (vv & 31);
      }
    }
  } else {
    for (int p0 = p_begin; p0 < p_end; p0 += T) {
      int v[T][KT];
      bool tg[T][KT];
#pragma unroll
      for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int64_t i = k * plane + (int64_t)(p0 + j) * R + r;
          const bool in = active && p0 + j < p_end;
          v[j][k] = in ? v_idx[i] : -1;
          tg[j][k] = in && tog[i] != 0;
        }
      }
#pragma unroll
      for (int j = 0; j < T; ++j) toggle_slot<KT>(par, v[j], tg[j], N, lane);
    }
  }
  if (!active) return;
  for (int w = 0; w < W; ++w) seg[((int64_t)s * W + w) * R + r] = par[w * kWarp + lane];
}

// seg[s] := XOR of the vectors of segments < s (in place; segment nseg - 1
// was not written), and seg[nseg] := the packed p=0 state. A thread per
// (word, replica), replicas fastest, so every row of seg is read and written
// coalesced; the loads of a batch of rows are independent of the chain.
__global__ void parity_prefix_kernel(const uint8_t* __restrict__ state,
                                     uint32_t* __restrict__ seg, int R, int N, int nseg) {
  constexpr int kBatch = 32;
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
  for (int s0 = 0; s0 < nseg; s0 += kBatch) {
    uint32_t x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) x[u] = s0 + u < nseg - 1 ? seg[(s0 + u) * row + i] : 0u;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (s0 + u < nseg) seg[(s0 + u) * row + i] = acc;
      acc ^= x[u];
    }
  }
}

template <int KT, bool kWords>
__global__ void parity_bits_kernel(const int32_t* __restrict__ v_idx,
                                   const uint8_t* __restrict__ tog,
                                   const int32_t* __restrict__ vq,
                                   const uint32_t* __restrict__ seg,
                                   uint8_t* __restrict__ pb, uint8_t* __restrict__ sb,
                                   int K, int M, int R, int N, int seg_len, int nseg) {
  extern __shared__ uint32_t smem[];
  constexpr int T = kTileSlots<KT>;
  constexpr int KB = KT == 0 ? 1 : KT;  // array extent
  const int W = (N + 31) >> 5;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int s = blockIdx.y * (blockDim.x >> 5) + wid;
  const int g0 = blockIdx.x * kWarp, r = g0 + lane;
  const bool active = r < R;
  const int64_t row = (int64_t)W * R;
  uint32_t* stw = smem;  // [W][32]: the group's packed p=0 state
  uint32_t* par = smem + (1 + wid) * W * kWarp;
  for (int i = threadIdx.x; i < W * kWarp; i += blockDim.x) {
    const int rr = g0 + (i & 31);
    stw[i] = rr < R ? seg[nseg * row + (int64_t)(i >> 5) * R + rr] : 0u;
  }
  if (s < nseg) {
    for (int w = 0; w < W; ++w) {
      par[w * kWarp + lane] = active ? seg[(int64_t)s * row + (int64_t)w * R + r] : 0u;
    }
  }
  __syncthreads();
  if (s >= nseg) return;  // whole warps; no barrier follows

  const int64_t plane = (int64_t)M * R;
  const int p_begin = s * seg_len, p_end = min(M, p_begin + seg_len);
  // The lane's share of a 4-slot store: slot lane / 8, replicas 4 * (lane % 8).
  const int jj = lane >> 3, r0 = g0 + 4 * (lane & 7), sh = 4 * (lane & 7);

  if constexpr (KT == 0) {
    for (int p = p_begin; p < p_end; ++p) {
      const int64_t at = (int64_t)p * R + r;
      for (int k = 0; k < K; ++k) {
        const int qq = active ? vq[k * plane + at] : -1;
        const bool ok = (unsigned)qq < (unsigned)N;
        const int a = ok ? (qq >> 5) * kWarp + lane : lane;
        const uint32_t pw = par[a], sw = stw[a];
        const unsigned bp = __ballot_sync(kAll, ok && (pw >> (qq & 31)) & 1u);
        const unsigned bs = __ballot_sync(kAll, ok && (sw >> (qq & 31)) & 1u);
        if (lane < 8) {  // one slot: 8 lanes of 4 replicas
          const int64_t o = k * plane + (int64_t)p * R;
          store4<kWords>(pb, o, g0 + 4 * lane, R, (bp >> (4 * lane)) & 0xFu);
          store4<kWords>(sb, o, g0 + 4 * lane, R, (bs >> (4 * lane)) & 0xFu);
        }
      }
      for (int k = 0; k < K && active; ++k) {
        const int64_t i = k * plane + at;
        const int vv = v_idx[i];
        if (tog[i] && (unsigned)vv < (unsigned)N) par[(vv >> 5) * kWarp + lane] ^= 1u << (vv & 31);
      }
    }
  } else {
    for (int p0 = p_begin; p0 < p_end; p0 += T) {
      int q[T][KB], v[T][KB];
      bool tg[T][KB];
#pragma unroll
      for (int j = 0; j < T; ++j) {
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int64_t i = k * plane + (int64_t)(p0 + j) * R + r;
          const bool in = active && p0 + j < p_end;
          q[j][k] = in ? vq[i] : -1;
          v[j][k] = in ? v_idx[i] : -1;
          tg[j][k] = in && tog[i] != 0;
        }
      }
#pragma unroll
      for (int j4 = 0; j4 < T; j4 += 4) {
        unsigned bp[4][KB], bs[4][KB];
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          const int j = j4 + jq;
          // The fetches read the carry before slot p, so before its toggles.
          uint32_t pw[KB], sw[KB];
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const int qq = q[j][k];
            const int a = (unsigned)qq < (unsigned)N ? (qq >> 5) * kWarp + lane : lane;
            pw[k] = par[a];
            sw[k] = stw[a];
          }
          toggle_slot<KT>(par, v[j], tg[j], N, lane);
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const int qq = q[j][k];
            const bool ok = (unsigned)qq < (unsigned)N;
            bp[jq][k] = __ballot_sync(kAll, ok && (pw[k] >> (qq & 31)) & 1u);
            bs[jq][k] = __ballot_sync(kAll, ok && (sw[k] >> (qq & 31)) & 1u);
          }
        }
        const int p = p0 + j4 + jj;
        if (p < p_end) {
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const unsigned mp = jj == 0 ? bp[0][k] : jj == 1 ? bp[1][k] : jj == 2 ? bp[2][k] : bp[3][k];
            const unsigned ms = jj == 0 ? bs[0][k] : jj == 1 ? bs[1][k] : jj == 2 ? bs[2][k] : bs[3][k];
            const int64_t o = k * plane + (int64_t)p * R;
            store4<kWords>(pb, o, r0, R, (mp >> sh) & 0xFu);
            store4<kWords>(sb, o, r0, R, (ms >> sh) & 0xFu);
          }
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

template <int KT>
int launch(const void* state, const void* v_idx, const void* tog, const void* vq,
           void* seg, void* pb, void* sb, int K, int M, int R, int N, int seg_len,
           cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const int W = (N + 31) / 32;
  const size_t vec = (size_t)W * kWarp * sizeof(uint32_t);  // one warp's carry
  const int wpb = (int)(max_smem / vec) - 1 < kMaxWarps ? (int)(max_smem / vec) - 1 : kMaxWarps;
  if (wpb < 1) return (int)cudaErrorInvalidValue;  // the wrapper refuses such N first
  const int nseg = (M + seg_len - 1) / seg_len;
  const int rgroups = (R + kWarp - 1) / kWarp;
  e = allow_smem((const void*)parity_segments_kernel<KT>, wpb * vec);
  // 32-bit stores of pb and sb where every row of R bytes is 4-byte aligned.
  const auto walk = R % 4 == 0 ? parity_bits_kernel<KT, true> : parity_bits_kernel<KT, false>;
  if (e == cudaSuccess) e = allow_smem((const void*)walk, (wpb + 1) * vec);
  if (e != cudaSuccess) return (int)e;
  if (nseg > 1) {
    parity_segments_kernel<KT><<<dim3(rgroups, (nseg - 1 + wpb - 1) / wpb), wpb * kWarp,
                                 wpb * vec, stream>>>(
        (const int32_t*)v_idx, (const uint8_t*)tog, (uint32_t*)seg, K, M, R, N, seg_len, nseg);
  }
  parity_prefix_kernel<<<(unsigned)(((int64_t)W * R + 255) / 256), 256, 0, stream>>>(
      (const uint8_t*)state, (uint32_t*)seg, R, N, nseg);
  walk<<<dim3(rgroups, (nseg + wpb - 1) / wpb), wpb * kWarp, (wpb + 1) * vec, stream>>>(
      (const int32_t*)v_idx, (const uint8_t*)tog, (const int32_t*)vq, (const uint32_t*)seg,
      (uint8_t*)pb, (uint8_t*)sb, K, M, R, N, seg_len, nseg);
  return (int)cudaGetLastError();
}

}  // namespace

// seg: scratch of (ceil(M / seg_len) + 1) * ceil(N / 32) * R words; seg_len
// a multiple of 4.
extern "C" int ising_parity_bits(const void* state, const void* v_idx,
                                 const void* tog, const void* vq, void* seg,
                                 void* pb, void* sb, int K, int M, int R, int N,
                                 int seg_len, void* stream) {
  if (R == 0 || M == 0) return (int)cudaGetLastError();
  if (seg_len <= 0 || seg_len % 4 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch<1>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    case 2: return launch<2>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    case 3: return launch<3>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    case 4: return launch<4>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    default: return launch<0>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
  }
}
