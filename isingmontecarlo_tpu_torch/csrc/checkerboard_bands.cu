// K1, banded variant: nsweeps checkerboard Metropolis sweeps of periodic
// L x L fields that no thread-block cluster holds (ops/checkerboard.py::
// k1_global_plan picks it: on an H100 every even L from 682 that no cluster
// size takes, up to 5,404), in one persistent launch per wave of
// replicas.
//
// Replaces, for those fields, the Pallas kernel isingmontecarlo_tpu/ops/
// checkerboard.py::checkerboard_multi_sweep, which keeps a replica's field
// on chip for all sweeps; checkerboard_global.cu, which this design
// replaces where it fits, kept the planes in global memory and launched a
// kernel per colour half-step. Here each CTA owns a band of rows of one
// replica, both compact colour planes of it (L bytes a row) plus a halo row
// above and below each plane, in its shared memory, for the whole call: the
// field is read once (split into the planes on the way in, halo rows
// included) and written once (merged on the way out).
//
// Per half-step t (sweep t / 2, colour col = t % 2) a CTA
//   1. updates the first and last row of its band in plane col from shared
//      memory (the other plane's rows above and below the band are its halo
//      rows);
//   2. publishes them into slot t % 2 of a global halo buffer, then
//      __threadfence() and a release store of its flag (t + 1);
//   3. updates the band's other rows, while the neighbours take its edge
//      rows (the byte path updates every row in step 1);
//   4. at the start of half-step t + 1, spins on acquire loads of both
//      neighbours' flags until they reach t + 1, then copies their rows
//      (through L2, ld.global.cg) into its halo rows of plane col.
// Neighbours are never more than one half-step apart (a CTA at t + 2 has
// seen both neighbours publish t + 1, which they do after reading slot t %
// 2), so two slots suffice, and no grid-wide barrier is needed. The CTAs of
// a launch must all be resident at once: the launch is cooperative
// (cudaLaunchAttributeCooperative), and the entry point refuses, launching
// nothing, a grid larger than occupancy x SMs.
//
// Layout, draws and arithmetic are those of checkerboard.cu and of the
// plain version in ops/checkerboard.py, which it equals bit for bit: the
// draw of site i of a plane is word i % 4 of Philox4x32-10(counter = (i / 4,
// sweep, colour, replica), key = the 64-bit seed), and a site flips when
// (word >> 8) < ceil(p[s][up neighbours] * 2^24). Where H = L / 2 is a
// multiple of 4 a thread keeps one column quad and walks rows, moving four
// sites as one 32-bit word (checkerboard.cu's 16-byte path), and the field
// moves 8 sites a thread; otherwise a thread takes a 4-site group by index
// and moves bytes.
//
// Bound on the card: instruction issue, as in checkerboard.cu (a quarter of
// a Philox call an attempt): the arithmetic is that kernel's, the field
// stays on chip, and a half-step adds a handshake with two neighbours (a
// flag in L2 and 2 * H bytes of rows each way) in place of a launch. The
// handshake is a chain of L2 round trips (rows, fence, flag, poll, rows),
// which step 3 overlaps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "status.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}

__device__ __forceinline__ void store_release(unsigned* flag, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag) : "memory");
  return v;
}

// kWords (H % 4 == 0): word moves; else byte moves.
template <bool kWords>
__global__ void __launch_bounds__(kMaxThreads)
checkerboard_bands_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                          uint8_t* __restrict__ halo, unsigned* __restrict__ flags,
                          const float* __restrict__ table, uint32_t k0, uint32_t k1, int L,
                          int nsweeps, int r0, int nb, int rows_cap) {
  // planes[p][1 + ly][k] for ly in [-1, B]: this band's rows of plane p and
  // a halo row on each side.
  extern __shared__ __align__(16) uint8_t planes[];
  __shared__ uint32_t thr[10];  // ceil(p[5 * s + up neighbours] * 2^24)
  const int H = L / 2;
  const int ps = (rows_cap + 2) * H;  // plane stride
  const int blk = blockIdx.x, rl = blk / nb, b = blk - rl * nb;
  const int r = r0 + rl;
  const int y0 = (int)((int64_t)b * L / nb), B = (int)((int64_t)(b + 1) * L / nb) - y0;
  const int up = rl * nb + (b + nb - 1) % nb, down = rl * nb + (b + 1) % nb;
  const int64_t LL = (int64_t)L * L;
  const uint8_t* field = in + r * LL;
  // Halo slot s of CTA c: rows [2][H] at halo + ((s * G + c) * 2 + i) * H.
  const int64_t G = gridDim.x;

  for (int i = threadIdx.x; i < 10; i += blockDim.x) thr[i] = accept_threshold(table[i]);
  // Rows y0 - 1 .. y0 + B of the field (periodic) into both planes.
  if (kWords) {
    const int per_row = L / 8;
    for (int i = threadIdx.x; i < (B + 2) * per_row; i += blockDim.x) {
      const int lr = i / per_row, x8 = i - lr * per_row;
      const int y = (y0 + lr - 1 + L) % L;
      const uint2 w = *reinterpret_cast<const uint2*>(field + (int64_t)y * L + 8 * x8);
      const uint32_t ev = __byte_perm(w.x, w.y, 0x6420), od = __byte_perm(w.x, w.y, 0x7531);
      const bool even = (y & 1) == 0;  // even rows: plane E holds the even x
      *reinterpret_cast<uint32_t*>(planes + lr * H + 4 * x8) = even ? ev : od;
      *reinterpret_cast<uint32_t*>(planes + ps + lr * H + 4 * x8) = even ? od : ev;
    }
  } else {
    for (int i = threadIdx.x; i < (B + 2) * L; i += blockDim.x) {
      const int lr = i / L, x = i - lr * L;
      const int y = (y0 + lr - 1 + L) % L;
      planes[((x + y) & 1) * ps + lr * H + (x >> 1)] = field[(int64_t)y * L + x] != 0;
    }
  }
  __syncthreads();

  const int Q = H / 4;
  const int rows_step = kWords ? blockDim.x / Q : 0;
  const int kq = kWords ? threadIdx.x % Q : 0;
  const int row0 = kWords && threadIdx.x < rows_step * Q ? threadIdx.x / Q : B;
  const int g_begin = y0 * H / 4, g_end = ((y0 + B) * H + 3) / 4;
  const int last = 2 * nsweeps - 1;
  for (int t = 0; t <= last; ++t) {
    const int col = t & 1;
    if (t > 0) {
      // Plane 1 - col changed in half-step t - 1: its halo rows come from
      // the neighbours' slot (t - 1) % 2 once both have published t - 1.
      if (threadIdx.x == 0) {
        while (load_acquire(flags + up) < (unsigned)t) {
        }
        while (load_acquire(flags + down) < (unsigned)t) {
        }
      }
      __syncthreads();
      const int64_t slot = (int64_t)((t - 1) & 1) * G;
      const uint8_t* above = halo + ((slot + up) * 2 + 1) * H;  // its last row
      const uint8_t* below = halo + ((slot + down) * 2) * H;    // its first row
      uint8_t* dst = planes + (1 - col) * ps;
      if (kWords) {
        for (int i = threadIdx.x; i < 2 * Q; i += blockDim.x) {
          const bool lo = i >= Q;
          const int k = 4 * (lo ? i - Q : i);
          const uint32_t w = __ldcg(reinterpret_cast<const unsigned*>((lo ? below : above) + k));
          *reinterpret_cast<uint32_t*>(dst + (lo ? B + 1 : 0) * H + k) = w;
        }
      } else {
        for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) {
          const bool lo = i >= H;
          const int k = lo ? i - H : i;
          dst[(lo ? B + 1 : 0) * H + k] = __ldcg((lo ? below : above) + k);
        }
      }
      __syncthreads();
    }

    uint8_t* own = planes + col * ps + H;  // row ly at own + ly * H
    const uint8_t* oth = planes + (1 - col) * ps + H;
    const int sweep = t >> 1;
    // Sites k..k+3 of row ly (16-byte path); the side neighbours are the
    // middle word shifted by one byte (column k - 1 for plane E on even rows
    // and plane O on odd rows, else k + 1; periodic).
    const auto update_row = [&](int ly) {
      const int k = 4 * kq, kb = k == 0 ? H - 4 : k - 4, kf = k + 4 == H ? 0 : k + 4;
      const int y = y0 + ly;
      const uint4 w = philox4x32_10(make_uint4(y * Q + kq, sweep, col, r), k0, k1);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      const uint8_t* mid = oth + ly * H;
      const uint32_t m = word_at(mid, k);
      const uint32_t a = word_at(mid - H, k), bl = word_at(mid + H, k);
      const bool back = ((y & 1) == 0) == (col == 0);
      const uint32_t side = back ? __funnelshift_l(word_at(mid, kb), m, 8)
                                 : __funnelshift_r(m, word_at(mid, kf), 8);
      const uint32_t ups = a + bl + m + side;  // byte lanes of 0..4
      uint32_t* cell = reinterpret_cast<uint32_t*>(own + ly * H + k);
      const uint32_t s4 = *cell;
      uint32_t flips = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t sp = (s4 >> (8 * i)) & 1u, n = (ups >> (8 * i)) & 0xFFu;
        flips |= (uint32_t)((words[i] >> 8) < thr[5 * sp + n]) << (8 * i);
      }
      *cell = s4 ^ flips;
    };
    // The band's first and last rows, which the neighbours wait for, go
    // first and are published before the interior is updated, so that the
    // neighbours' handshake runs in the interior's shadow.
    if (kWords) {
      const int edges = B > 1 ? 2 : 1;
#pragma unroll 1
      for (int e = row0; e < edges; e += rows_step) update_row(e == 0 ? 0 : B - 1);
    } else {
      // A 4-site group that straddles a band boundary is drawn by both
      // CTAs; each uses only its own sites' words. The byte path updates
      // the whole band here.
      for (int g = g_begin + threadIdx.x; g < g_end; g += blockDim.x) {
        const uint4 w = philox4x32_10(make_uint4(g, sweep, col, r), k0, k1);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        int y = 4 * g / H, k = 4 * g - y * H;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ly = y - y0;
          if (ly >= 0 && ly < B) {
            const uint8_t* mid = oth + ly * H;
            const bool back = ((y & 1) == 0) == (col == 0);
            const int ks = back ? (k == 0 ? H - 1 : k - 1) : (k == H - 1 ? 0 : k + 1);
            const int ups = mid[k - H] + mid[k + H] + mid[k] + mid[ks];
            const int sp = own[ly * H + k];
            own[ly * H + k] = sp ^ ((words[i] >> 8) < thr[5 * sp + ups]);
          }
          if (++k == H) {
            k = 0;
            ++y;
          }
        }
      }
    }
    __syncthreads();  // the edge rows final

    if (t < last) {
      // Publish rows 0 and B - 1 of plane col into slot t % 2.
      uint8_t* mine = halo + ((int64_t)(t & 1) * G + blk) * 2 * H;
      if (kWords) {
        for (int i = threadIdx.x; i < 2 * Q; i += blockDim.x) {
          const bool lo = i >= Q;
          const int k = 4 * (lo ? i - Q : i);
          *reinterpret_cast<uint32_t*>(mine + (lo ? H : 0) + k) =
              word_at(own + (lo ? B - 1 : 0) * H, k);
        }
      } else {
        for (int i = threadIdx.x; i < 2 * H; i += blockDim.x) {
          const bool lo = i >= H;
          const int k = lo ? i - H : i;
          mine[(lo ? H : 0) + k] = own[(lo ? B - 1 : 0) * H + k];
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        store_release(flags + blk, (unsigned)(t + 1));
      }
    }
    if (kWords) {
#pragma unroll 1
      for (int ly = 1 + row0; ly < B - 1; ly += rows_step) update_row(ly);
    }
    __syncthreads();  // this colour's rows final
  }

  // Merge the band's rows back into the field; no CTA reads this one's
  // shared memory, and the halo buffer is not read after the last handshake.
  uint8_t* dst = out + r * LL + (int64_t)y0 * L;
  if (kWords) {
    const int per_row = L / 8;
    for (int i = threadIdx.x; i < B * per_row; i += blockDim.x) {
      const int ly = i / per_row, x8 = i - ly * per_row;
      const uint32_t pe = word_at(planes + (ly + 1) * H, 4 * x8);
      const uint32_t po = word_at(planes + ps + (ly + 1) * H, 4 * x8);
      const bool even = ((y0 + ly) & 1) == 0;
      const uint32_t ev = even ? pe : po, od = even ? po : pe;
      *reinterpret_cast<uint2*>(dst + (int64_t)ly * L + 8 * x8) =
          make_uint2(__byte_perm(ev, od, 0x5140), __byte_perm(ev, od, 0x7362));
    }
  } else {
    for (int i = threadIdx.x; i < B * L; i += blockDim.x) {
      const int ly = i / L, x = i - ly * L;
      dst[i] = planes[((x + y0 + ly) & 1) * ps + (ly + 1) * H + (x >> 1)];
    }
  }
}

}  // namespace

// One wave: replicas r0 .. r0 + nrep - 1, nb bands each (nb <= L), a CTA a
// band, in one cooperative launch. halo: scratch of 2 * nrep * nb * 2 * (L /
// 2) bytes; flags: nrep * nb zeroed words. Returns kStatusNotCoResident,
// launching nothing, when the card cannot hold every CTA at once.
extern "C" int ising_checkerboard_bands(const void* in, void* out, void* halo, void* flags,
                                        const void* table, unsigned k0, unsigned k1, int L,
                                        int nsweeps, int r0, int nrep, int nb, void* stream) {
  if (nrep == 0 || L == 0) return (int)cudaGetLastError();
  if (L % 2 || nb < 1 || nb > L) return (int)cudaErrorInvalidValue;
  const int H = L / 2, Q = H / 4;
  // Word moves need rows of whole 4-site groups (and 8-site field rows) and
  // an 8-byte aligned field (a tensor view may start anywhere).
  const bool words = H % 4 == 0 && (uintptr_t)in % 8 == 0 && (uintptr_t)out % 8 == 0;
  if (words && Q > kMaxThreads) return (int)cudaErrorInvalidValue;  // the planner refuses first
  const int rows_cap = (L + nb - 1) / nb;
  const size_t smem = (size_t)2 * (rows_cap + 2) * H;
  // Word path: whole rows of Q groups a pass, as many rows as kMaxThreads
  // threads take. Byte path: a thread a group, up to kMaxThreads (a band
  // touches its own groups and one straddling group at each end).
  int threads;
  if (words) {
    const int rows = kMaxThreads / Q < rows_cap ? kMaxThreads / Q : rows_cap;
    threads = rows * Q;
  } else {
    threads = (rows_cap * H / 4 + 2 + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
  }
  auto kernel = words ? checkerboard_bands_kernel<true> : checkerboard_bands_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e != cudaSuccess) return (int)e;
  const int64_t grid = (int64_t)nrep * nb;
  if (grid > (int64_t)per_sm * n_sms) return kStatusNotCoResident;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)in, (uint8_t*)out, (uint8_t*)halo,
                         (unsigned*)flags, (const float*)table, (uint32_t)k0, (uint32_t)k1, L,
                         nsweeps, r0, nb, rows_cap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
