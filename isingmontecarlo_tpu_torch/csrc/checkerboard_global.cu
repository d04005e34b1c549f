// K1, global-memory variant: nsweeps checkerboard Metropolis sweeps of a
// periodic L x L field too large for the card's resident shared memory
// (ops/checkerboard.py::k1_variant picks it: on an H100 every even L above
// 5,404, where one replica's bands would need more CTAs than the SMs hold
// at once; checkerboard_bands.cu takes the fields from 682 up to there that
// no thread-block cluster holds).
//
// Replaces, for those fields, the Pallas kernel isingmontecarlo_tpu/ops/
// checkerboard.py::checkerboard_multi_sweep, as checkerboard.cu and
// checkerboard_bands.cu do for the rest. The two compact colour planes of
// every replica (L * L int8 bytes) live in a scratch buffer in global
// memory. A kernel boundary separates
// the colour half-steps: planes_kernel splits the field into the planes,
// half_step_kernel updates one colour of every replica (a thread per 4-site
// group; it reads only the other plane, which no thread writes during the
// launch, and writes only its own sites), 2 * nsweeps times, and
// planes_kernel merges the planes back into the field.
//
// Layout, draws and arithmetic are those of checkerboard.cu and of the
// plain version in ops/checkerboard.py, which it equals bit for bit: the
// draw of site i of a plane is word i % 4 of Philox4x32-10(counter = (i / 4,
// sweep, colour, replica), key = the 64-bit seed), and a site flips when
// (word >> 8) < ceil(p[s][up neighbours] * 2^24).
//
// Bound on the card: instruction issue, as in checkerboard.cu (a quarter of
// a Philox call an attempt); the field is read and written from L2 once a
// half-step, 2 * L * L bytes a replica, and each launch costs its gap on
// the stream. Where H = L / 2 is a multiple of 4, a thread keeps one column
// quad of one row and moves every row's four sites as one 32-bit word;
// otherwise a thread takes a group by index and moves bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}

// planes[r][(x + y) & 1][y][x / 2] = in[r][y][x] (plane E holds
// s[y, 2k + (y & 1)], plane O the rest), and back. kWords (L % 8 == 0): a
// thread per 8 sites of a row, one 8-byte access of the field and a 4-byte
// one of each plane, the bytes sorted by __byte_perm; else a thread a site.
template <bool kWords, bool kSplit>
__global__ void planes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int L,
                              int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t LL = (int64_t)L * L, LH = LL / 2;
  const int H = L / 2;
  if (kWords) {
    if (i * 8 >= total) return;
    const int64_t r = i * 8 / LL;
    const int rem = (int)(i * 8 - r * LL), y = rem / L, k = (rem - y * L) / 2;
    const int64_t e = r * LL + (int64_t)y * H + k, o = e + LH;  // plane words
    const bool even = (y & 1) == 0;  // even rows: plane E holds the even x
    if (kSplit) {
      const uint2 x = *reinterpret_cast<const uint2*>(src + i * 8);
      const uint32_t ev = __byte_perm(x.x, x.y, 0x6420), od = __byte_perm(x.x, x.y, 0x7531);
      *reinterpret_cast<uint32_t*>(dst + e) = even ? ev : od;
      *reinterpret_cast<uint32_t*>(dst + o) = even ? od : ev;
    } else {
      const uint32_t pe = *reinterpret_cast<const uint32_t*>(src + e);
      const uint32_t po = *reinterpret_cast<const uint32_t*>(src + o);
      const uint32_t ev = even ? pe : po, od = even ? po : pe;
      *reinterpret_cast<uint2*>(dst + i * 8) =
          make_uint2(__byte_perm(ev, od, 0x5140), __byte_perm(ev, od, 0x7362));
    }
  } else {
    if (i >= total) return;
    const int64_t r = i / LL;
    const int rem = (int)(i - r * LL), y = rem / L, x = rem - y * L;
    const int64_t at = r * LL + ((x + y) & 1) * LH + (int64_t)y * H + (x >> 1);
    if (kSplit) {
      dst[at] = src[i] != 0;
    } else {
      dst[i] = src[at];
    }
  }
}

// One colour half-step of every replica. kWords: a thread per (replica, row,
// column quad); else a thread per (replica, 4-site group of the plane).
template <bool kWords>
__global__ void __launch_bounds__(kThreads)
half_step_kernel(uint8_t* __restrict__ planes, const float* __restrict__ table, uint32_t k0,
                 uint32_t k1, int L, int R, int t, int col) {
  __shared__ uint32_t thr[10];  // ceil(p[5 * s + up neighbours] * 2^24)
  if (threadIdx.x < 10) thr[threadIdx.x] = accept_threshold(table[threadIdx.x]);
  __syncthreads();
  const int H = L / 2;
  const int64_t LL = (int64_t)L * L, LH = LL / 2;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (kWords) {
    const int Q = H / 4;
    const int64_t per_r = (int64_t)L * Q;
    if (i >= per_r * R) return;
    const int r = (int)(i / per_r);
    const int rem = (int)(i - r * per_r), y = rem / Q, kq = rem - y * Q;
    uint8_t* own = planes + r * LL + col * LH;
    const uint8_t* oth = planes + r * LL + (1 - col) * LH;
    const int k = 4 * kq, kb = k == 0 ? H - 4 : k - 4, kf = k + 4 == H ? 0 : k + 4;
    const uint4 w = philox4x32_10(make_uint4(y * Q + kq, t, col, r), k0, k1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const uint8_t* mid = oth + (int64_t)y * H;
    const uint32_t m = word_at(mid, k);
    const uint32_t a = word_at(oth + (int64_t)(y == 0 ? L - 1 : y - 1) * H, k);
    const uint32_t b = word_at(oth + (int64_t)(y == L - 1 ? 0 : y + 1) * H, k);
    // Side neighbours: column k - 1 for plane E on even rows and plane O on
    // odd rows, else k + 1 (periodic), as a funnel shift of two words.
    const bool back = ((y & 1) == 0) == (col == 0);
    const uint32_t side = back ? __funnelshift_l(word_at(mid, kb), m, 8)
                               : __funnelshift_r(m, word_at(mid, kf), 8);
    const uint32_t ups = a + b + m + side;  // byte lanes of 0..4
    uint32_t* cell = reinterpret_cast<uint32_t*>(own + (int64_t)y * H + k);
    const uint32_t s4 = *cell;
    uint32_t flips = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t s = (s4 >> (8 * q)) & 1u, n = (ups >> (8 * q)) & 0xFFu;
      flips |= (uint32_t)((words[q] >> 8) < thr[5 * s + n]) << (8 * q);
    }
    *cell = s4 ^ flips;
  } else {
    const int groups = (int)((LH + 3) / 4);
    if (i >= (int64_t)groups * R) return;
    const int r = (int)(i / groups), g = (int)(i - (int64_t)r * groups);
    uint8_t* own = planes + r * LL + col * LH;
    const uint8_t* oth = planes + r * LL + (1 - col) * LH;
    const uint4 w = philox4x32_10(make_uint4(g, t, col, r), k0, k1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    int y = 4 * g / H, k = 4 * g - y * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (y < L) {
        const uint8_t* mid = oth + (int64_t)y * H;
        const bool back = ((y & 1) == 0) == (col == 0);
        const int ks = back ? (k == 0 ? H - 1 : k - 1) : (k == H - 1 ? 0 : k + 1);
        const int ups = oth[(int64_t)(y == 0 ? L - 1 : y - 1) * H + k] +
                        oth[(int64_t)(y == L - 1 ? 0 : y + 1) * H + k] + mid[k] + mid[ks];
        const int s = own[(int64_t)y * H + k];
        own[(int64_t)y * H + k] = s ^ ((words[q] >> 8) < thr[5 * s + ups]);
      }
      if (++k == H) {
        k = 0;
        ++y;
      }
    }
  }
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// planes: scratch of R * L * L bytes. Launches 2 * nsweeps + 2 kernels on
// the stream.
extern "C" int ising_checkerboard_global(const void* in, void* out, void* planes,
                                         const void* table, unsigned k0, unsigned k1, int R,
                                         int L, int nsweeps, void* stream) {
  if (R == 0 || L == 0) return (int)cudaGetLastError();
  if (L % 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)R * L * L;
  const int H = L / 2;
  // 8-byte accesses where rows are whole 8-site groups and the field is
  // 8-byte aligned (a tensor view may start anywhere).
  const bool wide = L % 8 == 0 && (uintptr_t)in % 8 == 0 && (uintptr_t)out % 8 == 0;
  const unsigned field_blocks = blocks_for(wide ? total / 8 : total);
  if (wide) {
    planes_kernel<true, true><<<field_blocks, kThreads, 0, s>>>((const uint8_t*)in,
                                                                (uint8_t*)planes, L, total);
  } else {
    planes_kernel<false, true><<<field_blocks, kThreads, 0, s>>>((const uint8_t*)in,
                                                                 (uint8_t*)planes, L, total);
  }
  const bool words = H % 4 == 0;
  const int64_t threads =
      words ? (int64_t)R * L * (H / 4) : (int64_t)R * (((int64_t)L * H + 3) / 4);
  for (int t = 0; t < nsweeps; ++t) {
    for (int col = 0; col < 2; ++col) {
      if (words) {
        half_step_kernel<true><<<blocks_for(threads), kThreads, 0, s>>>(
            (uint8_t*)planes, (const float*)table, k0, k1, L, R, t, col);
      } else {
        half_step_kernel<false><<<blocks_for(threads), kThreads, 0, s>>>(
            (uint8_t*)planes, (const float*)table, k0, k1, L, R, t, col);
      }
    }
  }
  if (wide) {
    planes_kernel<true, false><<<field_blocks, kThreads, 0, s>>>((const uint8_t*)planes,
                                                                 (uint8_t*)out, L, total);
  } else {
    planes_kernel<false, false><<<field_blocks, kThreads, 0, s>>>((const uint8_t*)planes,
                                                                  (uint8_t*)out, L, total);
  }
  return (int)cudaGetLastError();
}
