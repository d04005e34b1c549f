// K1: nsweeps checkerboard Metropolis sweeps of a periodic L x L field.
//
// Replaces the Pallas kernel isingmontecarlo_tpu/ops/checkerboard.py::
// checkerboard_multi_sweep, which holds one replica's field in VMEM for all
// sweeps and touches HBM twice. Here a thread-block cluster of c CTAs holds
// one replica: CTA `rank` keeps rows [rank * L/c, (rank + 1) * L/c) of both
// compact colour planes (L * L / c int8 bytes) in its dynamic shared memory,
// and reads the row above and the row below its band in place from the
// neighbouring CTAs' shared memory (distributed shared memory: mapa and
// ld.shared::cluster; periodic, so rank 0's upper neighbour is rank c - 1).
// A colour half-step reads only the other plane, which no CTA writes during
// it, and a cluster barrier separates the half-steps, so the in-place remote
// reads need no copies. The field is read from global memory once, all
// nsweeps sweeps run on chip, and it is written once.
//
// Layout and arithmetic are those of ops/checkerboard.py (its plain version
// gives the same spins bit for bit at every c): plane E holds s[y, 2k +
// (y & 1)], plane O the rest; a site's neighbours are the other plane at rows
// y +- 1 and at columns k and k -+ 1 by row parity. The draw of site i of a
// plane is word i % 4 of Philox4x32-10(counter = (i / 4, sweep, colour,
// replica), key = the 64-bit seed) over the plane's row-major sites, so it
// does not depend on c: a 4-site group that straddles a band boundary is
// drawn by both CTAs, and each uses only its own sites' words. A site flips
// when u < p[s][up neighbours] with u = (word >> 8) * 2^-24 and p the 10
// acceptance probabilities that the wrapper computes once with torch.exp.
// The kernel tests the equivalent integer (word >> 8) < ceil(p * 2^24):
// u is m * 2^-24 for an integer m < 2^24 and p * 2^24 is exact (a power-of-
// two scaling), so m * 2^-24 < p exactly when m < ceil(p * 2^24).
//
// Where H = L / 2 is a multiple of 4 (the 16-byte path), no group straddles
// a row: a thread keeps one column quad and walks rows, loads its group's
// four own sites and each neighbour row's four sites as one 32-bit word
// each (the side neighbours are a funnel shift of two words), sums the four
// neighbour words byte-wise (each byte stays <= 4, so no carry crosses
// lanes) and stores the four new spins as one word. Otherwise (the byte
// path) a thread takes a group by index and reads and writes each site as a
// byte.
//
// Bound on the card: instruction issue. Each attempt costs a quarter of a
// Philox call (10 rounds of two 32x32 multiplies, hi and lo, and XORs) and a
// few operations for the neighbour sum and the test, while the bytes are
// 2 * L * L per replica per call. Before this design one 1024-thread block
// held a replica, so R = 64 filled 64 of the 132 SMs and L was capped at 482
// (L * L bytes in one block); the wrapper now picks c so that the R * c CTAs
// run in one wave over as many SMs as it can (a 1024-thread CTA's registers
// leave no room for a second on its SM), and L reaches 1360 at c = 8
// (L * L / 8 bytes a CTA); larger fields take checkerboard_global.cu. The
// instruction count matters most: the 16-byte
// path's inner loop is one Philox call and ~60 instructions more for four
// attempts, with no division (a thread keeps its column quad) and plain
// shared loads for every row but the band's two edges.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "status.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}

// The neighbouring CTAs' bands are read through 32-bit shared::cluster
// addresses (mapa), so the band's own rows stay plain shared-memory loads.
__device__ __forceinline__ uint32_t cluster_addr(const void* smem, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"((uint32_t)__cvta_generic_to_shared(smem)), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_cluster_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Between colour half-steps: a block barrier where the cluster is one CTA,
// else a cluster barrier (release/acquire at cluster scope, which costs a
// GPU-scope fence and an L1 invalidate on this card).
__device__ __forceinline__ void sync_bands(const cg::cluster_group& cluster, int c) {
  if (c == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

template <bool kWords>
__global__ void __launch_bounds__(kMaxThreads)
checkerboard_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    const float* __restrict__ table, uint32_t k0, uint32_t k1,
                    int L, int nsweeps) {
  extern __shared__ __align__(16) uint8_t planes[];  // [2][B][H], this band
  __shared__ uint32_t thr[10];  // ceil(p[5 * s + up neighbours] * 2^24)
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / c;  // the replica: one cluster each
  const int H = L / 2, B = L / c, BH = B * H, y0 = rank * B;
  const uint8_t* src = in + ((size_t)r * L + y0) * L;
  uint8_t* dst = out + ((size_t)r * L + y0) * L;
  const uint32_t up = cluster_addr(planes, (rank + c - 1) % c);
  const uint32_t down = cluster_addr(planes, (rank + 1) % c);

  // Strided: a small field's 16-byte path may launch fewer than 10 threads.
  for (int i = threadIdx.x; i < 10; i += blockDim.x) thr[i] = accept_threshold(table[i]);
  for (int i = threadIdx.x; i < B * L; i += blockDim.x) {
    const int y = i / L, x = i - y * L;
    planes[((x + y0 + y) & 1) * BH + y * H + (x >> 1)] = src[i] != 0;
  }
  sync_bands(cluster, c);  // every band and table in place before any remote read

  // 16-byte path: Q = H / 4 groups a row; a thread keeps one column quad kq
  // and walks rows (the launch gives a multiple of Q threads), so no thread
  // divides in the loop. Byte path: a thread a group, by group index.
  const int Q = H / 4;
  const int rows_step = kWords ? blockDim.x / Q : 0;
  const int kq = kWords ? threadIdx.x % Q : 0;
  const int row0 = kWords && threadIdx.x < rows_step * Q ? threadIdx.x / Q : B;
  const int g_begin = y0 * H / 4, g_end = ((y0 + B) * H + 3) / 4;
  for (int t = 0; t < nsweeps; ++t) {
    for (int col = 0; col < 2; ++col) {
      uint8_t* own = planes + col * BH;
      const int oth_off = (1 - col) * BH;
      const uint8_t* oth = planes + oth_off;
      const uint32_t above0 = up + oth_off + (B - 1) * H;  // row y0 - 1
      const uint32_t below_last = down + oth_off;          // row y0 + B
      if (kWords) {
        // Sites k..k+3 of each row; the side neighbours are the middle
        // word shifted by one byte (column k - 1 for plane E on even rows
        // and plane O on odd rows, else k + 1; periodic).
        const int k = 4 * kq, kb = k == 0 ? H - 4 : k - 4, kf = k + 4 == H ? 0 : k + 4;
#pragma unroll 1
        for (int ly = row0; ly < B; ly += rows_step) {
          const int y = y0 + ly;
          const uint4 w = philox4x32_10(make_uint4(y * Q + kq, t, col, r), k0, k1);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          const uint8_t* mid = oth + ly * H;
          const uint32_t m = word_at(mid, k);
          const uint32_t a = ly == 0 ? ld_cluster_u32(above0 + k) : word_at(mid - H, k);
          const uint32_t b = ly == B - 1 ? ld_cluster_u32(below_last + k) : word_at(mid + H, k);
          const bool back = ((y & 1) == 0) == (col == 0);
          const uint32_t side = back ? __funnelshift_l(word_at(mid, kb), m, 8)
                                     : __funnelshift_r(m, word_at(mid, kf), 8);
          const uint32_t ups = a + b + m + side;  // byte lanes of 0..4
          uint32_t* cell = reinterpret_cast<uint32_t*>(own + ly * H + k);
          const uint32_t s4 = *cell;
          uint32_t flips = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t s = (s4 >> (8 * i)) & 1u, n = (ups >> (8 * i)) & 0xFFu;
            flips |= (uint32_t)((words[i] >> 8) < thr[5 * s + n]) << (8 * i);
          }
          *cell = s4 ^ flips;
        }
      } else {
        for (int g = g_begin + threadIdx.x; g < g_end; g += blockDim.x) {
          const uint4 w = philox4x32_10(make_uint4(g, t, col, r), k0, k1);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          int y = 4 * g / H, k = 4 * g - y * H;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ly = y - y0;
            if (ly >= 0 && ly < B) {
              const uint8_t* mid = oth + ly * H;
              const bool back = ((y & 1) == 0) == (col == 0);
              const int ks = back ? (k == 0 ? H - 1 : k - 1) : (k == H - 1 ? 0 : k + 1);
              const int ups = (ly == 0 ? ld_cluster_u8(above0 + k) : mid[k - H]) +
                              (ly == B - 1 ? ld_cluster_u8(below_last + k) : mid[k + H]) +
                              mid[k] + mid[ks];
              const int s = own[ly * H + k];
              own[ly * H + k] = s ^ ((words[i] >> 8) < thr[5 * s + ups]);
            }
            if (++k == H) {
              k = 0;
              ++y;
            }
          }
        }
      }
      sync_bands(cluster, c);  // this colour's writes seen before the next half-step
    }
  }

  // No CTA reads another's shared memory after the last barrier, so each
  // may write its band and exit.
  for (int i = threadIdx.x; i < B * L; i += blockDim.x) {
    const int y = i / L, x = i - y * L;
    dst[i] = planes[((x + y0 + y) & 1) * BH + y * H + (x >> 1)];
  }
}

}  // namespace

// c CTAs per replica (a cluster each; c divides L; the wrapper checks that
// L * L / c bytes fit a CTA's shared memory). Returns
// kStatusClusterUnschedulable, launching nothing, when no cluster of that
// shape can be resident.
extern "C" int ising_checkerboard(const void* in, void* out, const void* table,
                                  unsigned k0, unsigned k1, int R, int L, int c,
                                  int nsweeps, void* stream) {
  if (R == 0 || L == 0) return (int)cudaGetLastError();
  const int H = L / 2;
  const int smem = L / c * L;
  // 16-byte path: whole rows of H / 4 groups a pass, as many rows as
  // kMaxThreads threads take. Byte path: a thread a group, up to
  // kMaxThreads (the groups that touch a band are its own plus one
  // straddling group at each end).
  const int B = L / c, Q = H / 4;
  int threads;
  if (H % 4 == 0) {
    const int rows = kMaxThreads / Q < B ? kMaxThreads / Q : B;
    threads = rows * Q;
  } else {
    threads = (B * H / 4 + 2 + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
  }
  auto kernel = H % 4 == 0 ? checkerboard_kernel<true> : checkerboard_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return kStatusClusterUnschedulable;
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)in, (uint8_t*)out,
                         (const float*)table, (uint32_t)k0, (uint32_t)k1, L, nsweeps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
