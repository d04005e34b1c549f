// The design that K3 (carry_metropolis.cu) and K3-hb (carry_heatbath.cu)
// share: the op-count carry scan over M slots, fed through a ring of input
// tiles in shared memory.
//
// A CTA serves 32 replicas with four warps, one on each of the SM's
// schedulers, joined by mbarriers:
//
//   warp 0, the producer: keeps kRawStages tiles of [kTile slots x 32
//     replicas] of every input plane in flight, one 2-D copy by the tensor
//     memory accelerator (TMA) a plane and tile, whose bytes the stage's
//     `full` barrier counts down as they land.
//   warps 1-2, the prep warps: once the chain is done with a ready tile,
//     they store its decisions to device memory as 16-byte stores, then
//     fold the next raw tile's masks and n-independent products into the
//     few f32 values a slot needs (Chain::prep), written replica-major
//     (`ready`, kReadyStages deep), and release the raw stage.
//   warp 3, the chain: one thread per replica walks the slots. It waits
//     once per tile and never on device memory, so it does not see whether
//     its inputs come from L2 or cold from HBM. It reads four slots of a
//     value with one 16-byte shared load, a group ahead of its walk, and
//     writes each slot's decisions as one byte, insert + 2 * remove (no
//     store to device memory sits on the chain).
//
// A plane whose rows are not 16-byte aligned (R % 4 != 0 for the f32
// planes, R % 16 != 0 for the bool planes, or a pointer off 16 bytes),
// which TMA cannot address, is copied element by element by the producer's
// lanes instead, on a path of its own. A stage's `full` phase ends when the
// 32 producer lanes have arrived, each after its own shared stores, and the
// TMA bytes, announced by lane 0 before it issues the copies, have landed.
// TMA fills the rows past M and the replicas past R with zeros. Only TMA
// or the producer writes a raw stage, and only the prep warps read it.
//
// The chain carries mmn = float(M - n) and mmn1 = float(M - n + 1) as f32
// and steps both by d = remove - insert in {-1, 0, 1}. Every integer of
// magnitude up to 2^24 is exact in f32, so this equals __int2float_rn(M - n)
// bit for bit while |M - n| + 1 <= 2^24; the wrappers refuse M >= 2^24 and
// 0 <= n <= M holds in every op string. The chain of a slot is then the
// n-dependent test (a multiply, and the compare as a 1.0f or 0.0f) and the
// adds of d; the masks fold into the tests as NaN, in the prep warps.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace carry_ring {

constexpr int kLanes = 32;   // replicas a CTA: one chain warp
constexpr int kTile = 64;    // slots a stage
constexpr int kRow = kTile + 4;  // a replica's slots in a ready tile; the pad
                                 // keeps 16-byte accesses free of conflicts

template <int NF, int NB>
struct Raw {  // the inputs as TMA writes them
  float f[NF][kTile][kLanes];    // the f32 planes, [slot][replica]
  uint8_t b[NB][kTile][kLanes];  // the bool planes
};

template <int NV>
struct Ready {  // a tile prepared for the chain
  float v[NV][kLanes][kRow];    // [replica][slot]
  uint8_t code[kTile][kLanes];  // the decisions, insert + 2 * remove
};

template <int NF, int NB>
struct Planes {
  const float* f[NF];
  const uint8_t* b[NB];
  uint8_t* out[2];
  const int32_t* n0;
  const float* bwt;  // heat-bath only
  int M, R;
  bool f_vec, b_vec;  // TMA for the f32 / bool planes, 16-byte stores out
};

// The planes' TMA descriptors; a kernel parameter (__grid_constant__), as
// TMA requires.
template <int NF, int NB>
struct Maps {
  CUtensorMap f[NF];
  CUtensorMap b[NB];
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

// An arrival with release semantics: the caller's shared stores before it
// are visible to a thread whose wait completes on this phase.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem(bar))
               : "memory");
}

// Raise the bytes that the barrier's current phase waits for (TMA's
// complete_tx counts them down).
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box, [kTile rows x kLanes columns] at (row p0, column r0), into a
// tile, counted down on `bar` as it lands.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int r0, int p0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(r0), "r"(p0), "r"(smem(bar))
      : "memory");
}

// The element-wise path: rows p0 .. p0 + cnt - 1, replicas r0 .. r0 + nrep - 1
// of an [M, R] plane into a tile, by the producer warp's 32 lanes.
template <typename T>
__device__ __forceinline__ void copy_plane(T (*dst)[kLanes], const T* src, int p0, int cnt,
                                           int R, int r0, int nrep, int lane) {
  for (int c = lane; c < cnt * nrep; c += kLanes) {
    const int j = c / nrep, k = c - j * nrep;
    dst[j][k] = src[(int64_t)(p0 + j) * R + r0 + k];
  }
}

// The decisions of a released tile to device memory: the codes split into
// the insert and remove planes, 16 bytes at a time where rows allow.
__device__ __forceinline__ void store_codes(uint8_t* ins, uint8_t* rem,
                                            const uint8_t (*code)[kLanes], int p0, int cnt,
                                            int R, int r0, int nrep, bool vec, int tid,
                                            int nthreads) {
  if (vec) {
    const int chunks = nrep / 16;  // 2, or 1 in a last group of 16
    for (int c = tid; c < cnt * chunks; c += nthreads) {
      const int j = chunks == 2 ? c >> 1 : c, k = (c - j * chunks) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(&code[j][k]);
      const int64_t at = (int64_t)(p0 + j) * R + r0 + k;
      constexpr uint32_t lo = 0x01010101u;
      *reinterpret_cast<uint4*>(ins + at) = make_uint4(w.x & lo, w.y & lo, w.z & lo, w.w & lo);
      *reinterpret_cast<uint4*>(rem + at) =
          make_uint4(w.x >> 1 & lo, w.y >> 1 & lo, w.z >> 1 & lo, w.w >> 1 & lo);
    }
  } else {
    for (int c = tid; c < cnt * nrep; c += nthreads) {
      const int j = c / nrep, k = c - j * nrep;
      const int64_t at = (int64_t)(p0 + j) * R + r0 + k;
      ins[at] = code[j][k] & 1;
      rem[at] = code[j][k] >> 1;
    }
  }
}

// 1.0f where a < b, else 0.0f (also where either is NaN): set.lt with an
// f32 result is one instruction (FSET.BF), where a compare and a select
// would be two on the chain.
__device__ __forceinline__ float lt(float a, float b) {
  float r;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// insert + 2 * remove from the tests' 1.0f / 0.0f (1.0f is 0x3f800000).
__device__ __forceinline__ uint32_t code(float ins, float rem) {
  return __float_as_uint(ins) >> 29 | (__float_as_uint(rem) >> 28 & 2u);
}

constexpr int kRawStages = 4;    // TMA tiles in flight
constexpr int kReadyStages = 3;  // prepared tiles ahead of the chain
constexpr int kPrepWarps = 2;
constexpr int kThreads = (2 + kPrepWarps) * kLanes;

template <class Chain>
struct Shared {
  Raw<Chain::NF, Chain::NB> raw[kRawStages];
  Ready<Chain::NV> ready[kReadyStages];
  uint64_t full[kRawStages], raw_free[kRawStages];
  uint64_t ready_full[kReadyStages], ready_done[kReadyStages];
};

// Chain is a struct with NF and NB (its f32 and bool input planes) and NV
// (the values a slot holds for the chain); prep(raw, slot, replica, v),
// which folds a slot's inputs into v off the chain; a constructor from
// (Planes, replica); and step(v), which decides one slot, steps the carry
// and returns code(insert, remove).
template <class Chain>
__global__ void __launch_bounds__(kThreads)
    carry_kernel(const Planes<Chain::NF, Chain::NB> a,
                 const __grid_constant__ Maps<Chain::NF, Chain::NB> maps) {
  constexpr int NV = Chain::NV;
  extern __shared__ unsigned char smem_raw[];
  // TMA writes to 128-byte aligned shared addresses; the launch adds 128
  // bytes for this. (Pointer arithmetic on smem_raw, not on an integer,
  // keeps the accesses below shared loads and stores.)
  Shared<Chain>& sh =
      *reinterpret_cast<Shared<Chain>*>(smem_raw + ((128u - (smem(smem_raw) & 127u)) & 127u));

  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int r0 = blockIdx.x * kLanes;
  const int nrep = min(kLanes, a.R - r0);
  const int nt = (a.M + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawStages; ++s) {
      bar_init(&sh.full[s], kLanes);
      bar_init(&sh.raw_free[s], kPrepWarps * kLanes);
    }
    for (int t = 0; t < kReadyStages; ++t) {
      bar_init(&sh.ready_full[t], kPrepWarps * kLanes);
      bar_init(&sh.ready_done[t], kLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer: TMA in
    constexpr uint32_t kFBytes = kTile * kLanes * sizeof(float), kBBytes = kTile * kLanes;
    const uint32_t tx = (a.f_vec ? Chain::NF * kFBytes : 0) + (a.b_vec ? Chain::NB * kBBytes : 0);
    for (int k = 0; k < nt; ++k) {
      const int s = k % kRawStages, p0 = k * kTile, cnt = min(kTile, a.M - p0);
      if (k >= kRawStages) bar_wait(&sh.raw_free[s], (k / kRawStages - 1) & 1);
      if (lane == 0 && tx != 0) {
        bar_expect_tx(&sh.full[s], tx);
#pragma unroll
        for (int i = 0; i < Chain::NF; ++i)
          if (a.f_vec) tma_load(sh.raw[s].f[i], &maps.f[i], r0, p0, &sh.full[s]);
#pragma unroll
        for (int i = 0; i < Chain::NB; ++i)
          if (a.b_vec) tma_load(sh.raw[s].b[i], &maps.b[i], r0, p0, &sh.full[s]);
      }
#pragma unroll
      for (int i = 0; i < Chain::NF; ++i)
        if (!a.f_vec) copy_plane(sh.raw[s].f[i], a.f[i], p0, cnt, a.R, r0, nrep, lane);
#pragma unroll
      for (int i = 0; i < Chain::NB; ++i)
        if (!a.b_vec) copy_plane(sh.raw[s].b[i], a.b[i], p0, cnt, a.R, r0, nrep, lane);
      bar_arrive(&sh.full[s]);
    }
  } else if (warp <= kPrepWarps) {
    // The prep warps: once the chain is done with a ready tile, they store
    // its decisions and fill it with the next tile's values, each warp half
    // of the slots, four at a time for one replica, replica-major for the
    // chain's 16-byte loads. (The chain rewrites the codes only after both
    // warps have arrived on ready_full, so after both have stored them.)
    constexpr int kQuads = kTile / 4 / kPrepWarps;
    const int q0 = (warp - 1) * kQuads, tid = threadIdx.x - kLanes;
    for (int k = 0; k < nt + kReadyStages; ++k) {
      const int s = k % kRawStages, t = k % kReadyStages, kd = k - kReadyStages;
      if (kd >= 0) {  // the ready tile holds tile kd
        const int p0 = kd * kTile;
        bar_wait(&sh.ready_done[t], (kd / kReadyStages) & 1);
        store_codes(a.out[0], a.out[1], sh.ready[t].code, p0, min(kTile, a.M - p0), a.R, r0,
                    nrep, a.b_vec, tid, kPrepWarps * kLanes);
      }
      if (k >= nt) continue;
      bar_wait(&sh.full[s], (k / kRawStages) & 1);
#pragma unroll 4
      for (int q = q0; q < q0 + kQuads; ++q) {
        float v[4][NV];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) Chain::prep(sh.raw[s], 4 * q + jj, lane, v[jj]);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          *reinterpret_cast<float4*>(&sh.ready[t].v[i][lane][4 * q]) =
              make_float4(v[0][i], v[1][i], v[2][i], v[3][i]);
      }
      bar_arrive(&sh.raw_free[s]);
      bar_arrive(&sh.ready_full[t]);
    }
  } else {  // the chain: lanes past R walk the tile's zero-filled columns
    Chain chain(a, r0 + lane);
    for (int k = 0; k < nt; ++k) {
      const int t = k % kReadyStages, cnt = min(kTile, a.M - k * kTile);
      Ready<NV>& rd = sh.ready[t];
      bar_wait(&sh.ready_full[t], (k / kReadyStages) & 1);
      if (cnt == kTile) {
        // Two quads of slots at a time, loaded a group ahead.
        float4 cur[NV][2], nxt[NV][2];
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            cur[i][h] = *reinterpret_cast<const float4*>(&rd.v[i][lane][4 * h]);
#pragma unroll
        for (int g = 0; g < kTile / 8; ++g) {
          if (g + 1 < kTile / 8) {
#pragma unroll
            for (int i = 0; i < NV; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                nxt[i][h] = *reinterpret_cast<const float4*>(&rd.v[i][lane][8 * (g + 1) + 4 * h]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v[4][NV];
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              v[0][i] = cur[i][h].x;
              v[1][i] = cur[i][h].y;
              v[2][i] = cur[i][h].z;
              v[3][i] = cur[i][h].w;
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) rd.code[8 * g + 4 * h + jj][lane] = chain.step(v[jj]);
          }
#pragma unroll
          for (int i = 0; i < NV; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) cur[i][h] = nxt[i][h];
        }
      } else {
        for (int j = 0; j < cnt; ++j) {
          float v[NV];
#pragma unroll
          for (int i = 0; i < NV; ++i) v[i] = rd.v[i][lane][j];
          rd.code[j][lane] = chain.step(v);
        }
      }
      bar_arrive(&sh.ready_done[t]);
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// The descriptor of an [M, R] plane cut in [kTile, kLanes] boxes.
inline bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int M,
                   int R) {
  const cuuint64_t dims[2] = {(cuuint64_t)R, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)R * elem};
  const cuuint32_t box[2] = {kLanes, kTile}, unit[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Choose TMA or the element-wise path for each kind of plane, encode the
// descriptors, raise the kernel's shared-memory limit once, and launch one
// CTA for every 32 replicas; returns cudaGetLastError(), or
// cudaErrorNotSupported where the driver has no cuTensorMapEncodeTiled.
template <class Chain>
int launch(Planes<Chain::NF, Chain::NB> a, cudaStream_t stream) {
  if (a.R == 0 || a.M == 0) return (int)cudaGetLastError();
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  a.f_vec = a.R % 4 == 0;
  for (int i = 0; i < Chain::NF; ++i) a.f_vec = a.f_vec && aligned16(a.f[i]);
  a.b_vec = a.R % 16 == 0 && aligned16(a.out[0]) && aligned16(a.out[1]);
  for (int i = 0; i < Chain::NB; ++i) a.b_vec = a.b_vec && aligned16(a.b[i]);
  Maps<Chain::NF, Chain::NB> maps{};
  for (int i = 0; i < Chain::NF && a.f_vec; ++i)
    if (!encode(&maps.f[i], a.f[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.M, a.R))
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < Chain::NB && a.b_vec; ++i)
    if (!encode(&maps.b[i], a.b[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.M, a.R))
      return (int)cudaErrorInvalidValue;
  constexpr int bytes = sizeof(Shared<Chain>) + 128;
  static const cudaError_t attr = cudaFuncSetAttribute(
      carry_kernel<Chain>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  carry_kernel<Chain><<<(a.R + kLanes - 1) / kLanes, kThreads, bytes, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace carry_ring
