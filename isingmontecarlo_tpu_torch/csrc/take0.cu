// K4: per-replica gathers on label tables, and the two steps of a
// hook-and-compress round built from them.
//
// Replaces the Pallas kernel isingmontecarlo_tpu/ops/take_kernel.py::take0,
// which routes the gather through base-128 digit planes on the TPU's matrix
// unit because per-lane gathers scalarise there (exact only for C < 2^14
// rows and values < 2^24), and the XLA hook around it at
// isingmontecarlo_tpu/sse/cluster.py:561-570 (endpoint gathers, max/min,
// P.at[mx, cols].min(m), then take0(Pn, Pn) N_COMPRESS times). A GPU
// gathers natively, with none of those caps, so the entry points are:
//
//   ising_take0         out[e, r] = table[idx[e, r], r], for one or two
//                       index grids on the same table in one launch;
//   ising_hook_min      one hook: Pn[max(pu, pv), r] = min(.., min(pu, pv))
//                       with (pu, pv) = (P[u, r], P[v, r]), or (u, v) in
//                       the first round, where P is the identity; Pn enters
//                       as a copy of P and takes int32 atomicMin;
//   ising_pointer_jump  out[x, r] = Pn applied `hops` times to x (hops =
//                       2^N_COMPRESS equals N_COMPRESS jumps P <- P[P]),
//                       and *flag = tag where any out[x, r] != P_start[x, r].
//
// Bound on the card: bytes and latency, not operations. Each index grid is
// read and each output written once, coalesced along R; the table reads of
// a warp land on up to 32 rows. At the cluster update's shapes (C ~ 8000,
// R = 256, int32) a table is 8 MB and stays in the 50 MB L2, so the
// scattered reads are served from L2. Before this design a hook round was
// ten launches (two gathers, max, min, a scatter-min, two jump gathers, a
// compare and a reduction) that each wrote and re-read [E, R] or [S, R]
// through memory; now it is a copy, a hook and a jump, and the flip
// decisions gather two grids per launch.
//
// Design: a 2-D grid whose y walks rows and whose threads walk replicas, so
// no thread divides by R; where R % 4 == 0 and the grids are 16-byte
// aligned, each thread moves four replicas with 16-byte loads and stores of
// the index and output grids. Table reads go through the read-only path
// (the tables are never written by the launch that reads them: the hook
// reads P and writes only Pn, and the jump reads Pn and writes a fresh
// buffer). The hook's result does not depend on the order of its atomics:
// every candidate is computed from the round's starting P, and min is
// commutative, so it is bit-identical to scatter_reduce("amin") and XLA's
// .at[].min. It skips the atomic where pu == pv or where min(pu, pv) is not
// below P[max], both no-ops since P[x] <= x, which spares the contended
// roots of large clusters.
//
// An index outside [0, C) reads nothing: take0 writes INT32_MIN there, the
// hook skips the edge, and a jump stops at the label.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColThreads = 32;  // threads along R in a block
constexpr int kRowThreads = 8;   // rows per block
constexpr int kMaxGridY = 65535;

template <int V>
__device__ __forceinline__ void load(const int32_t* p, int32_t (&x)[V]) {
  if constexpr (V == 4) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(int32_t* p, const int32_t (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// The caller keeps every grid below 2^31 elements, so index math is 32-bit.
template <int V>
__global__ void take0_kernel(const int32_t* __restrict__ table,
                             const int32_t* __restrict__ idx,
                             int32_t* __restrict__ out,
                             const int32_t* __restrict__ idx2,
                             int32_t* __restrict__ out2,
                             int C, int E, int E2, int R) {
  const int r0 = V * (blockIdx.x * blockDim.x + threadIdx.x);
  if (r0 >= R) return;
  for (int e = blockIdx.y * blockDim.y + threadIdx.y; e < E + E2;
       e += gridDim.y * blockDim.y) {
    const bool second = e >= E;
    const int at = (second ? e - E : e) * R + r0;
    int32_t i[V], o[V];
    load<V>((second ? idx2 : idx) + at, i);
#pragma unroll
    for (int k = 0; k < V; ++k)
      o[k] = (unsigned)i[k] < (unsigned)C ? __ldg(table + i[k] * R + r0 + k) : INT32_MIN;
    store<V>((second ? out2 : out) + at, o);
  }
}

template <int V, bool kFirst>
__global__ void hook_min_kernel(const int32_t* __restrict__ P, int32_t* Pn,
                                const int32_t* __restrict__ u,
                                const int32_t* __restrict__ v,
                                int S, int E, int R) {
  const int r0 = V * (blockIdx.x * blockDim.x + threadIdx.x);
  if (r0 >= R) return;
  for (int e = blockIdx.y * blockDim.y + threadIdx.y; e < E;
       e += gridDim.y * blockDim.y) {
    int32_t a[V], b[V];
    load<V>(u + e * R + r0, a);
    load<V>(v + e * R + r0, b);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int r = r0 + k;
      if ((unsigned)a[k] >= (unsigned)S || (unsigned)b[k] >= (unsigned)S) continue;
      const int pu = kFirst ? a[k] : __ldg(P + a[k] * R + r);
      const int pv = kFirst ? b[k] : __ldg(P + b[k] * R + r);
      if (pu == pv) continue;
      const int mx = max(pu, pv), m = min(pu, pv);
      if (m < (kFirst ? mx : __ldg(P + mx * R + r))) atomicMin(Pn + mx * R + r, m);
    }
  }
}

template <int V>
__global__ void pointer_jump_kernel(const int32_t* __restrict__ Pn,
                                    const int32_t* __restrict__ P_start,
                                    int32_t* __restrict__ out, int32_t* flag,
                                    int tag, int hops, int S, int R) {
  const int r0 = V * (blockIdx.x * blockDim.x + threadIdx.x);
  bool changed = false;
  if (r0 < R) {
    for (int x = blockIdx.y * blockDim.y + threadIdx.y; x < S;
         x += gridDim.y * blockDim.y) {
      int32_t p[V], s[V];
      load<V>(Pn + x * R + r0, p);
      load<V>(P_start + x * R + r0, s);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        for (int h = 1; h < hops && (unsigned)p[k] < (unsigned)S; ++h)
          p[k] = __ldg(Pn + p[k] * R + r0 + k);
        changed |= p[k] != s[k];
      }
      store<V>(out + x * R + r0, p);
    }
  }
  // One store per block that saw a change; every such store writes tag.
  if (__syncthreads_or(changed) && threadIdx.x == 0 && threadIdx.y == 0) *flag = tag;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Four replicas a thread where R % 4 == 0 and every vector-accessed grid is
// 16-byte aligned (a null pointer is).
bool vec4(int R, const void* a, const void* b, const void* c, const void* d) {
  return R % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) && aligned16(d);
}

dim3 grid_for(int R, int V, int rows) {
  const int cols = (R / V + kColThreads - 1) / kColThreads;
  const int ys = (rows + kRowThreads - 1) / kRowThreads;
  return dim3(cols, ys < kMaxGridY ? ys : kMaxGridY);
}

const dim3 kBlock(kColThreads, kRowThreads);

}  // namespace

extern "C" int ising_take0(const void* table, const void* idx, void* out,
                           const void* idx2, void* out2, int C, int E, int E2,
                           int R, void* stream) {
  if (R == 0 || E + E2 == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto t = (const int32_t*)table;
  if (vec4(R, idx, out, idx2, out2)) {
    take0_kernel<4><<<grid_for(R, 4, E + E2), kBlock, 0, s>>>(
        t, (const int32_t*)idx, (int32_t*)out, (const int32_t*)idx2, (int32_t*)out2,
        C, E, E2, R);
  } else {
    take0_kernel<1><<<grid_for(R, 1, E + E2), kBlock, 0, s>>>(
        t, (const int32_t*)idx, (int32_t*)out, (const int32_t*)idx2, (int32_t*)out2,
        C, E, E2, R);
  }
  return (int)cudaGetLastError();
}

extern "C" int ising_hook_min(const void* P, void* Pn, const void* u, const void* v,
                              int first, int S, int E, int R, void* stream) {
  if (R == 0 || E == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto p = (const int32_t*)P;
  auto pn = (int32_t*)Pn;
  auto uu = (const int32_t*)u;
  auto vv = (const int32_t*)v;
  const bool v4 = vec4(R, u, v, nullptr, nullptr);
  const dim3 grid = grid_for(R, v4 ? 4 : 1, E);
  if (v4 && first) hook_min_kernel<4, true><<<grid, kBlock, 0, s>>>(p, pn, uu, vv, S, E, R);
  else if (v4) hook_min_kernel<4, false><<<grid, kBlock, 0, s>>>(p, pn, uu, vv, S, E, R);
  else if (first) hook_min_kernel<1, true><<<grid, kBlock, 0, s>>>(p, pn, uu, vv, S, E, R);
  else hook_min_kernel<1, false><<<grid, kBlock, 0, s>>>(p, pn, uu, vv, S, E, R);
  return (int)cudaGetLastError();
}

extern "C" int ising_pointer_jump(const void* Pn, const void* P_start, void* out,
                                  void* flag, int tag, int hops, int S, int R,
                                  void* stream) {
  if (R == 0 || S == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  auto pn = (const int32_t*)Pn;
  auto ps = (const int32_t*)P_start;
  if (vec4(R, Pn, P_start, out, nullptr)) {
    pointer_jump_kernel<4><<<grid_for(R, 4, S), kBlock, 0, s>>>(
        pn, ps, (int32_t*)out, (int32_t*)flag, tag, hops, S, R);
  } else {
    pointer_jump_kernel<1><<<grid_for(R, 1, S), kBlock, 0, s>>>(
        pn, ps, (int32_t*)out, (int32_t*)flag, tag, hops, S, R);
  }
  return (int)cudaGetLastError();
}
