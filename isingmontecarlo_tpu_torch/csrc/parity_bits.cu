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
// The wide variant at the end of this file takes the N whose two vectors
// no CTA holds (past 29,056 on an H100): see its own note.
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
// A slot's toggled legs act as a set: two legs on one variable flip it once,
// as the plain version's scatter and the JAX package's XLA path (.max) do.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "parity_legs.cuh"

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
// any store, so the slot costs one shared-memory latency. A word's toggle
// mask is the OR of the bits of the slot's legs in it, so legs that toggle
// one word store the same combined word, and two legs on one variable flip
// it once.
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
    uint32_t m = tm[k];
#pragma unroll
    for (int k2 = 0; k2 < KT; ++k2) {
      if (k2 != k && at[k2] == at[k]) m |= tm[k2];
    }
    if (tm[k]) par[at[k]] = tw[k] ^ m;
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
        int w = 0;
        const uint32_t m = leg_toggle(v_idx, tog, k, plane, (int64_t)p * R + r, N, &w);
        if (m) par[w * kWarp + lane] ^= m;
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
        int w = 0;
        const uint32_t m = leg_toggle(v_idx, tog, k, plane, at, N, &w);
        if (m) par[w * kWarp + lane] ^= m;
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

// ---- The wide variant (N past what two vectors a CTA allow) -------------
//
// A CTA holds one warp's carry (4 * N bytes) and no packed state, so one
// CTA runs an SM, and nothing hides the latency of the SM's only warp: on
// an H100 such a warp gets about one memory request served each ~40 ns.
// So the wide variant keeps memory requests off the walk's chain:
//
// 1. parity_toggles_wide: a thread per (slot, replica), fully parallel,
//    XORs its slot's toggles (a set: a variable that an earlier leg names
//    is skipped) into its segment's row of the zeroed scratch with
//    atomicXor (commutative, so the rows are exact in any order);
// 2. parity_prefix_kernel, as for the shared variant;
// 3. parity_bits_wide_kernel: the walk of one segment by one warp, pb only.
//    Its carry and its tiles of slots (the current op's legs, their
//    toggles, the proposal legs) arrive by TMA into shared memory, counted
//    down on mbarriers: the carry in boxes of up to 256 rows of 32
//    replicas, the tiles a box of T slots a leg and array each, through a
//    ring of stages filled ahead of the walk. A request costs a lone warp
//    ~40 ns whatever its size (row-sized copies held the walk at ~280 ns a
//    slot), so the boxes are as large as the layout allows. Where rows are
//    not 16-byte multiples (R % 16 != 0) the lanes copy their own elements
//    instead, unpipelined.
// 4. parity_state_bits: sb, a gather of the packed p=0 state (scratch row
//    nseg, 4 * N bytes a replica group, so an SM's L1 holds a 32-replica
//    model's) at the proposal legs, fully parallel: it does not depend on
//    the scan.
//
// Bound on the card, measured: the walk's instruction issue. Its loop is
// ~90 SASS instructions a slot at K=2, and the SM's one warp issues at most
// one a clock, so a slot takes ~50-100 ns; M * ceil(R / 32) slot walks over
// the SMs, plus the prefix pass's scratch (an N-bit vector a segment and
// replica, read and written once), set the time.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also raises the bytes the barrier's phase waits for.
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box of a 2-D tensor map, at (column c0, row c1), into shared
// memory, counted down on bar as it lands (rows and columns past the tensor
// read as zeros).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The wide walk's tensor maps: v_idx, vq (int32) and tog (uint8) as [K * M,
// R] in boxes of [T, 32], and the scratch as [(nseg + 1) * W, R] int32 in
// boxes of [min(W, 256), 32]; a kernel parameter (__grid_constant__).
struct WideMaps {
  CUtensorMap v, q, t, carry;
  int carry_rows;  // rows of a carry box
};

__global__ void parity_toggles_wide(const int32_t* __restrict__ v_idx,
                                    const uint8_t* __restrict__ tog, uint32_t* __restrict__ seg,
                                    int K, int M, int R, int N, int seg_len, int nseg) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = (int64_t)M * R;
  if (i >= plane) return;
  const int p = (int)(i / R), r = (int)(i - (int64_t)p * R);
  const int s = p / seg_len;
  if (s >= nseg - 1) return;  // the last segment's toggles are never needed
  const int64_t row = (int64_t)((N + 31) >> 5) * R;
  for (int k = 0; k < K; ++k) {
    int w = 0;
    const uint32_t m = leg_toggle(v_idx, tog, k, plane, i, N, &w);
    if (m) atomicXor(seg + s * row + (int64_t)w * R + r, m);
  }
}

// packed: the p=0 state, word w of replica r at packed[w * R + r]. kQuad
// (R % 4 == 0, 16-byte aligned vq): a thread takes 4 replicas of a row,
// one 16-byte load of vq and one 4-byte store of sb; else one element.
__device__ __forceinline__ uint32_t state_bit(const uint32_t* __restrict__ packed, int q, int r,
                                              int R, int N) {
  return (unsigned)q < (unsigned)N ? (__ldg(packed + (int64_t)(q >> 5) * R + r) >> (q & 31)) & 1u
                                   : 0u;
}

template <bool kQuad>
__global__ void parity_state_bits(const uint32_t* __restrict__ packed,
                                  const int32_t* __restrict__ vq, uint8_t* __restrict__ sb,
                                  int64_t total, int R, int N) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (kQuad ? 4 : 1);
  if (i >= total) return;
  const int r = (int)(i % R);
  if constexpr (kQuad) {
    const int4 q = *reinterpret_cast<const int4*>(vq + i);
    *reinterpret_cast<uint32_t*>(sb + i) =
        state_bit(packed, q.x, r, R, N) | state_bit(packed, q.y, r + 1, R, N) << 8 |
        state_bit(packed, q.z, r + 2, R, N) << 16 | state_bit(packed, q.w, r + 3, R, N) << 24;
  } else {
    sb[i] = state_bit(packed, vq[i], r, R, N);
  }
}

// A ring stage: KT * T rows of 32 replicas each of v (the current op's leg
// variables), q (the proposal's) and t (the toggles), row k * T + j for leg
// k of slot j of the tile.
template <int KT>
struct WideStage {
  static constexpr int kRows = KT * kTileSlots<KT>;
  int32_t v[kRows][kWarp];
  int32_t q[kRows][kWarp];
  uint8_t t[kRows][kWarp];
};

// Fill stage st with the tile at p0 (n of its slots exist): with kTma, one
// box a leg and array (lane 0 arms the stage's barrier and issues them; a
// box past a leg's last slot or past R reads rows or columns the walk
// ignores); else each lane's own elements.
template <int KT, bool kTma>
__device__ __forceinline__ void fill_stage(WideStage<KT>* st, uint64_t* bar,
                                           const WideMaps* maps,
                                           const int32_t* __restrict__ v_idx,
                                           const uint8_t* __restrict__ tog,
                                           const int32_t* __restrict__ vq, int M, int R, int g0,
                                           int gw, int p0, int n, int lane) {
  constexpr int T = kTileSlots<KT>;
  if (n <= 0) return;
  if constexpr (kTma) {
    if (lane == 0) {
      bar_arrive_expect(bar, (uint32_t)sizeof(WideStage<KT>));
      for (int k = 0; k < KT; ++k) {
        tma_load_2d(st->v[k * T], &maps->v, g0, k * M + p0, bar);
        tma_load_2d(st->q[k * T], &maps->q, g0, k * M + p0, bar);
        tma_load_2d(st->t[k * T], &maps->t, g0, k * M + p0, bar);
      }
    }
  } else {
    const int64_t plane = (int64_t)M * R;
    if (lane < gw) {
      for (int e = 0; e < KT * n; ++e) {
        const int k = e / n, j = e - k * n;
        const int64_t at = k * plane + (int64_t)(p0 + j) * R + g0 + lane;
        st->v[k * T + j][lane] = v_idx[at];
        st->q[k * T + j][lane] = vq[at];
        st->t[k * T + j][lane] = tog[at];
      }
    }
    __syncwarp();
  }
}

// The walk of segment blockIdx.y of replica group blockIdx.x by one warp,
// from its prefix row: pb only. KT = 0 (K > 4) reads its legs from global
// memory, unpipelined.
template <int KT, bool kWords, bool kTma>
__global__ void __launch_bounds__(kWarp, 1)
    parity_bits_wide_kernel(const int32_t* __restrict__ v_idx, const uint8_t* __restrict__ tog,
                            const int32_t* __restrict__ vq, const uint32_t* __restrict__ seg,
                            uint8_t* __restrict__ pb, int K, int M, int R, int N, int seg_len,
                            int nseg, int stages, const __grid_constant__ WideMaps maps) {
  extern __shared__ __align__(128) uint32_t par[];  // [W][32]: the carry; then the ring
  constexpr int T = kTileSlots<KT>;
  const int W = (N + 31) >> 5;
  const int lane = threadIdx.x, s = blockIdx.y;
  const int g0 = blockIdx.x * kWarp, r = g0 + lane, gw = min(kWarp, R - g0);
  const bool active = r < R;
  const int64_t row = (int64_t)W * R, plane = (int64_t)M * R;
  const int p_begin = s * seg_len, p_end = min(M, p_begin + seg_len);
  const uint32_t* __restrict__ prefix = seg + s * row + g0;

  if constexpr (KT == 0) {
    for (int w = 0; w < W; ++w) par[w * kWarp + lane] = active ? prefix[(int64_t)w * R + lane] : 0u;
    for (int p = p_begin; p < p_end; ++p) {
      const int64_t at = (int64_t)p * R + r;
      for (int k = 0; k < K; ++k) {
        const int qq = active ? vq[k * plane + at] : -1;
        const bool ok = (unsigned)qq < (unsigned)N;
        const uint32_t pw = par[ok ? (qq >> 5) * kWarp + lane : lane];
        const unsigned bp = __ballot_sync(kAll, ok && (pw >> (qq & 31)) & 1u);
        if (lane < 8) {  // one slot: 8 lanes of 4 replicas
          store4<kWords>(pb, k * plane + (int64_t)p * R, g0 + 4 * lane, R,
                         (bp >> (4 * lane)) & 0xFu);
        }
      }
      for (int k = 0; k < K && active; ++k) {
        int w = 0;
        const uint32_t m = leg_toggle(v_idx, tog, k, plane, at, N, &w);
        if (m) par[w * kWarp + lane] ^= m;
      }
    }
  } else {
    WideStage<KT>* ring = reinterpret_cast<WideStage<KT>*>(par + W * kWarp);
    uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages);  // [stages] tiles, then the carry's
    uint64_t* carry_bar = bars + stages;
    const int ntiles = (p_end - p_begin + T - 1) / T;
    if constexpr (kTma) {
      if (lane == 0) {
        for (int i = 0; i <= stages; ++i) bar_init(bars + i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        // The carry in boxes of carry_rows rows; the last box ends at row W
        // (it may overlap the one before: the same words land twice).
        const int ch = maps.carry_rows, nbox = (W + ch - 1) / ch;
        bar_arrive_expect(carry_bar, (uint32_t)(nbox * ch * kWarp * 4));
        for (int b = 0; b < nbox; ++b) {
          const int w0 = min(b * ch, W - ch);
          tma_load_2d(par + w0 * kWarp, &maps.carry, g0, s * W + w0, carry_bar);
        }
      }
      __syncwarp();
      for (int t = 0; t < stages && t < ntiles; ++t) {
        fill_stage<KT, true>(ring + t, bars + t, &maps, v_idx, tog, vq, M, R, g0, gw,
                             p_begin + t * T, min(T, p_end - p_begin - t * T), lane);
      }
      bar_wait(carry_bar, 0);
    } else {
      for (int w = 0; w < W; ++w) par[w * kWarp + lane] = active ? prefix[(int64_t)w * R + lane] : 0u;
    }
    // The lane's share of a 4-slot store: slot lane / 8, replicas 4 * (lane % 8).
    const int jj = lane >> 3, r0 = g0 + 4 * (lane & 7), sh = 4 * (lane & 7);
    for (int t = 0; t < ntiles; ++t) {
      const int p0 = p_begin + t * T, n = min(T, p_end - p0);
      WideStage<KT>* st = ring + (kTma ? t % stages : 0);
      if constexpr (kTma) {
        bar_wait(bars + t % stages, (uint32_t)((t / stages) & 1));
      } else {
        fill_stage<KT, false>(st, nullptr, nullptr, v_idx, tog, vq, M, R, g0, gw, p0, n, lane);
      }
      // The tile into registers first: the compiler cannot move a stage's
      // loads above the carry's stores (both are shared memory), so loads
      // in the walk would lengthen each slot's chain.
      int qt[T][KT], vt[T][KT];
      uint32_t tgm = 0u;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const bool in = active && j < n;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          qt[j][k] = in ? st->q[k * T + j][lane] : -1;
          vt[j][k] = in ? st->v[k * T + j][lane] : -1;
          tgm |= (uint32_t)(in && st->t[k * T + j][lane] != 0) << (j * KT + k);
        }
      }
      __syncwarp();  // every lane has read the stage before it is filled again
      if constexpr (kTma) {
        const int tn = t + stages;
        if (tn < ntiles) {
          fill_stage<KT, true>(st, bars + t % stages, &maps, v_idx, tog, vq, M, R, g0, gw,
                               p_begin + tn * T, min(T, p_end - p_begin - tn * T), lane);
        }
      }
#pragma unroll
      for (int j4 = 0; j4 < T; j4 += 4) {
        unsigned bp[4][KT];
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          const int j = j4 + jq;
          bool tg[KT];
          uint32_t pw[KT];
          const int* qk = qt[j];
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            tg[k] = (tgm >> (j * KT + k)) & 1u;
            // The fetches read the carry before slot p, so before its toggles.
            pw[k] = par[(unsigned)qk[k] < (unsigned)N ? (qk[k] >> 5) * kWarp + lane : lane];
          }
          toggle_slot<KT>(par, vt[j], tg, N, lane);
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            bp[jq][k] = __ballot_sync(
                kAll, (unsigned)qk[k] < (unsigned)N && (pw[k] >> (qk[k] & 31)) & 1u);
          }
        }
        if (j4 + jj < n) {
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            const unsigned mp = jj == 0 ? bp[0][k] : jj == 1 ? bp[1][k] : jj == 2 ? bp[2][k] : bp[3][k];
            store4<kWords>(pb, k * plane + (int64_t)(p0 + j4 + jj) * R, r0, R, (mp >> sh) & 0xFu);
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

// The wide variant's bytes of shared memory at N with `stages` ring stages.
template <int KT>
size_t wide_smem(int N, int stages) {
  const size_t carry = (size_t)((N + 31) / 32) * kWarp * sizeof(uint32_t);
  if constexpr (KT == 0) {
    return carry;
  } else {
    return carry + stages * sizeof(WideStage<KT>) + (stages + 1) * sizeof(uint64_t);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda), or null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The descriptor of a [rows, R] tensor of elem-byte elements in boxes of
// [box_rows, 32].
bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
               int64_t rows, int R, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)R, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)R * elem};
  const cuuint32_t box[2] = {kWarp, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KT>
int launch_wide(const void* state, const void* v_idx, const void* tog, const void* vq,
                void* seg, void* pb, void* sb, int K, int M, int R, int N, int seg_len,
                cudaStream_t stream) {
  constexpr int kMaxStages = 8;
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  int stages = kMaxStages;
  while (stages > 2 && wide_smem<KT>(N, stages) > (size_t)max_smem) --stages;
  const size_t smem = wide_smem<KT>(N, stages);
  // The wrapper refuses an N whose carry and two stages do not fit first.
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const int W = (N + 31) / 32;
  const int nseg = (M + seg_len - 1) / seg_len;
  const int rgroups = (R + kWarp - 1) / kWarp;
  const auto aligned16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  // TMA takes rows of 16-byte multiples at 16-byte aligned addresses.
  const bool tma = KT > 0 && R % 16 == 0 && aligned16(v_idx) && aligned16(tog) &&
                   aligned16(vq) && aligned16(seg) && encode_tiled() != nullptr;
  WideMaps maps{};
  if (tma) {
    constexpr int T = kTileSlots<KT>;
    maps.carry_rows = W < 256 ? W : 256;
    if (!encode_2d(&maps.v, v_idx, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, (int64_t)K * M, R, T) ||
        !encode_2d(&maps.q, vq, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, (int64_t)K * M, R, T) ||
        !encode_2d(&maps.t, tog, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (int64_t)K * M, R, T) ||
        !encode_2d(&maps.carry, seg, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, (int64_t)(nseg + 1) * W,
                   R, maps.carry_rows)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const bool words = R % 4 == 0;
  const auto walk = tma ? (words ? parity_bits_wide_kernel<KT, true, true>
                                 : parity_bits_wide_kernel<KT, false, true>)
                        : (words ? parity_bits_wide_kernel<KT, true, false>
                                 : parity_bits_wide_kernel<KT, false, false>);
  e = allow_smem((const void*)walk, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t slots = (int64_t)M * R, total = (int64_t)K * M * R;
  if (nseg > 1) {
    parity_toggles_wide<<<(unsigned)((slots + 255) / 256), 256, 0, stream>>>(
        (const int32_t*)v_idx, (const uint8_t*)tog, (uint32_t*)seg, K, M, R, N, seg_len, nseg);
  }
  parity_prefix_kernel<<<(unsigned)(((int64_t)W * R + 255) / 256), 256, 0, stream>>>(
      (const uint8_t*)state, (uint32_t*)seg, R, N, nseg);
  walk<<<dim3(rgroups, nseg), kWarp, smem, stream>>>(
      (const int32_t*)v_idx, (const uint8_t*)tog, (const int32_t*)vq, (const uint32_t*)seg,
      (uint8_t*)pb, K, M, R, N, seg_len, nseg, stages, maps);
  const uint32_t* packed = (const uint32_t*)seg + (int64_t)nseg * W * R;
  if (R % 4 == 0 && aligned16(vq) && (uintptr_t)sb % 4 == 0) {
    parity_state_bits<true><<<(unsigned)((total / 4 + 255) / 256), 256, 0, stream>>>(
        packed, (const int32_t*)vq, (uint8_t*)sb, total, R, N);
  } else {
    parity_state_bits<false><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        packed, (const int32_t*)vq, (uint8_t*)sb, total, R, N);
  }
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

// The wide variant (one warp's carry a CTA and a ring of tiles): the
// arguments of ising_parity_bits, with seg's rows 0 .. nseg - 2 zeroed.
extern "C" int ising_parity_bits_wide(const void* state, const void* v_idx,
                                      const void* tog, const void* vq, void* seg,
                                      void* pb, void* sb, int K, int M, int R, int N,
                                      int seg_len, void* stream) {
  if (R == 0 || M == 0) return (int)cudaGetLastError();
  if (seg_len <= 0 || seg_len % 4 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_wide<1>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    case 2: return launch_wide<2>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    case 3: return launch_wide<3>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    case 4: return launch_wide<4>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
    default: return launch_wide<0>(state, v_idx, tog, vq, seg, pb, sb, K, M, R, N, seg_len, s);
  }
}
