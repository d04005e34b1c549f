// K1, tiled variant: nsweeps checkerboard Metropolis sweeps of periodic
// L x L fields too large for the card's resident shared memory
// (ops/checkerboard.py::k1_variant picks it: on an H100 every even L above
// 5,404, where one replica's bands would need more CTAs than the SMs hold
// at once), as overlapped temporal tiles: a launch runs k sweeps, and a
// call ceil(nsweeps / k) launches (ops/checkerboard.py::k1_tile_plan).
//
// Replaces, for those fields, the Pallas kernel isingmontecarlo_tpu/ops/
// checkerboard.py::checkerboard_multi_sweep, as checkerboard.cu and
// checkerboard_bands.cu do for smaller ones; checkerboard_global.cu, which
// this design replaces, kept the planes in global memory and launched a
// kernel per colour half-step and two plane passes.
//
// Each CTA owns an interior tile of ty x tx field sites of one replica. It
// reads the interleaved field directly, the tile and a halo of 2k rows above
// and below and of at least 2k columns on each side (periodic: rows and
// columns by modular indexing, so a halo may be wider than L), and splits it
// into both compact colour planes in its shared memory. A colour half-step
// s (0 .. 2 * sweeps - 1) updates the loaded rows [s + 1, rows - 1 - s)
// from shared memory alone: a site is right after half-step s where its
// four neighbours were right before it, so the right region shrinks by one
// site a half-step, and after 2k half-steps the interior is right. Sites
// outside it are computed from stale or wrapped neighbours and never
// written back. The CTA then merges the interior back into the field. Tiles
// are independent: no cooperative launch, flags or grid barrier, so any L
// and R run, and the CTAs need not all be resident at once. A tile's halo
// must read the old field, so a launch never writes its input: the wrapper
// alternates the output and one scratch between launches.
//
// Layout, draws and arithmetic are those of checkerboard.cu and of the
// plain version in ops/checkerboard.py, which it equals bit for bit: the
// draw of site i of a plane is word i % 4 of Philox4x32-10(counter = (i / 4,
// sweep, colour, replica), key = the 64-bit seed), with the call's global
// sweep index (a launch gets its first), and a site flips when (word >> 8)
// < ceil(p[s][up neighbours] * 2^24). A site recomputed in two tiles' halos
// gets the same draw. A thread keeps a column quad (four plane columns) of
// the tile and walks rows, moving four sites as one 32-bit word of shared
// memory (a plane row is padded to whole words). Where H = L / 2 is a
// multiple of 4 (the word path), tile column origins sit on 8-field-column
// boundaries and the column halo is rounded up to whole 4-site groups, so a
// quad is one 4-site group: one Philox call, and the field moves 8 sites at
// a time. Otherwise (the byte path) a plane's 4-site groups straddle rows:
// a quad draws from the one or two groups it meets (three where the tile
// wraps past column H), and the field moves by bytes.
//
// Bound on the card: instruction issue, as in checkerboard.cu (a quarter of
// a Philox call an attempt), times the redundant sites of the halos,
// (ty + 4k)(tx + 4 halo columns) / (ty tx); the field is read and written
// once a launch, about 2 R L^2 bytes per k sweeps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLoadBatch = 4;

__device__ __forceinline__ uint32_t word_at(const uint8_t* row, int k) {
  return *reinterpret_cast<const uint32_t*>(row + k);
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__device__ __forceinline__ uint32_t pick(const uint4& w, uint32_t q) {
  return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
}


// The draws of a quad of sites i_j = base + pcs[j] (the byte path): word
// i_j % 4 of the Philox call of group i_j / 4. Four consecutive sites meet
// at most two groups, unless the quad wraps past plane column H - 1.
__device__ __forceinline__ void quad_draws(uint32_t (&words)[4], uint32_t base,
                                           const int (&pcs)[4], uint32_t sweep, int col, int r,
                                           const PhiloxKeys& keys) {
  uint32_t i[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) i[j] = base + (uint32_t)pcs[j];
  const uint32_t ga = i[0] >> 2, gb = i[3] >> 2;
  const uint4 wa = philox4x32_10(make_uint4(ga, sweep, col, r), keys);
  const uint4 wb = gb == ga ? wa : philox4x32_10(make_uint4(gb, sweep, col, r), keys);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t g = i[j] >> 2;
    words[j] = pick(g == ga ? wa
                    : g == gb ? wb
                              : philox4x32_10(make_uint4(g, sweep, col, r), keys),
                    i[j] & 3);
  }
}

// One launch: `sweeps` sweeps from global sweep sweep0 of every tile of
// every replica. Block b is replica b / (ny * nx), tile row (b / nx) % ny,
// tile column b % nx. Shared memory: planes[2][rows][Ws], rows = ty + 2
// halo, W = tx / 2 + 2 hc loaded plane columns in rows of Ws = W rounded up
// to a multiple of 4 (the padding is never loaded or written back).
template <bool kWords>
__global__ void __launch_bounds__(kMaxThreads)
checkerboard_tiles_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                          const float* __restrict__ table,
                          const __grid_constant__ PhiloxKeys keys, int L, int sweep0,
                          int sweeps, int halo, int hc, int ty, int tx, int ny, int nx, int W,
                          int rows) {
  extern __shared__ __align__(16) uint8_t planes[];
  __shared__ uint32_t thr[10];  // ceil(p[5 * s + up neighbours] * 2^24)
  const int H = L / 2, Q = H / 4, Ws = (W + 3) & ~3;
  const int PS = rows * Ws;  // plane stride
  const int tiles = ny * nx;
  const int r = blockIdx.x / tiles, tile = blockIdx.x - r * tiles;
  const int tyi = tile / nx, txi = tile - tyi * nx;
  const int Y0 = tyi * ty, X0 = txi * (tx / 2);  // interior origin: field row, plane column
  const int ylo = Y0 - halo, P0 = X0 - hc;       // loaded row 0, plane column 0
  const int64_t LL = (int64_t)L * L;
  const uint8_t* field = in + r * LL;

  // Threads in whole rows of quads: a thread keeps quad kq, whose global
  // plane columns it computes once, and walks rows from row_off by
  // rows_step (modulo L: a halo wider than L makes rows_step >= L
  // possible), in the load, the half-steps and the write-back alike, so no
  // loop divides.
  const int Qt = Ws / 4;
  const int rows_step = blockDim.x / Qt;
  const int kq = threadIdx.x % Qt, row_off = threadIdx.x / Qt;
  const bool active = row_off < rows_step;
  const int step_mod = rows_step % L;
  int pcs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pcs[j] = wrap(P0 + 4 * kq + j, H);
  const auto next_row = [&](int y) {
    y += step_mod;
    return y >= L ? y - L : y;
  };

  for (int i = threadIdx.x; i < 10; i += blockDim.x) thr[i] = accept_threshold(table[i]);
  if (kWords && active) {
    // kLoadBatch rows' 8-byte loads in flight before their splits: one at a
    // time, a CTA's load waits out a memory round trip per few KB.
    const uint8_t* col_base = field + 2 * pcs[0];  // pcs[0] is a multiple of 4
    int y = wrap(ylo + row_off, L);
    for (int ly0 = row_off; ly0 < rows; ly0 += kLoadBatch * rows_step) {
      uint2 w[kLoadBatch];
#pragma unroll
      for (int b = 0; b < kLoadBatch; ++b) {
        if (ly0 + b * rows_step < rows) {
          w[b] = *reinterpret_cast<const uint2*>(col_base + (int64_t)y * L);
        }
        y = next_row(y);
      }
#pragma unroll
      for (int b = 0; b < kLoadBatch; ++b) {
        const int ly = ly0 + b * rows_step;
        if (ly < rows) {
          const bool even = ((ylo + ly) & 1) == 0;  // even rows: plane E holds the even x
          const uint32_t ev = __byte_perm(w[b].x, w[b].y, 0x6420);
          const uint32_t od = __byte_perm(w[b].x, w[b].y, 0x7531);
          *reinterpret_cast<uint32_t*>(planes + ly * Ws + 4 * kq) = even ? ev : od;
          *reinterpret_cast<uint32_t*>(planes + PS + ly * Ws + 4 * kq) = even ? od : ev;
        }
      }
    }
  } else if (active) {
    // The padding columns [W, Ws) hold down spins: every shared byte is a
    // spin, so a neighbour sum indexes the threshold table in range.
    int y = wrap(ylo + row_off, L);
    for (int ly = row_off; ly < rows; ly += rows_step) {
      const uint8_t* row = field + (int64_t)y * L;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * kq + j;
        planes[ly * Ws + c] = c < W && row[2 * pcs[j] + (y & 1)] != 0;
        planes[PS + ly * Ws + c] = c < W && row[2 * pcs[j] + 1 - (y & 1)] != 0;
      }
      y = next_row(y);
    }
  }
  __syncthreads();

  // Sites k..k+3 of each row; the side neighbours are the middle word
  // shifted by one byte, with the byte beside it from the next word (column
  // k - 1 for plane E on even rows and plane O on odd rows, else k + 1; one
  // byte permutation), wrapped inside the tile's row at its edges, where the
  // sites are outside the right region anyway. A row's parity, and so its
  // side, alternates with each step where rows_step is odd (L is even, so a
  // wrap keeps it).
  const int k = 4 * kq, kb = k == 0 ? Ws - 4 : k - 4, kf = k + 4 == Ws ? 0 : k + 4;
  const uint32_t gq = (uint32_t)pcs[0] >> 2;
  for (int s = 0; s < 2 * sweeps; ++s) {
    const int col = s & 1;
    const uint32_t sweep = (uint32_t)(sweep0 + (s >> 1));
    uint8_t* own = planes + col * PS;
    const uint8_t* oth = planes + (1 - col) * PS;
    const int lo = s + 1, hi = rows - 1 - s;
    int y = wrap(ylo + lo + row_off, L);
    bool back = ((y & 1) == 0) == (col == 0);
    const bool flip_side = rows_step & 1;
#pragma unroll 1
    for (int ly = active ? lo + row_off : hi; ly < hi; ly += rows_step) {
      uint32_t words[4];
      if (kWords) {
        const uint4 w = philox4x32_10(make_uint4((uint32_t)y * Q + gq, sweep, col, r), keys);
        words[0] = w.x, words[1] = w.y, words[2] = w.z, words[3] = w.w;
      } else {
        quad_draws(words, (uint32_t)y * H, pcs, sweep, col, r, keys);
      }
      const uint8_t* mid = oth + ly * Ws;
      const uint32_t m = word_at(mid, k);
      const uint32_t a = word_at(mid - Ws, k), b = word_at(mid + Ws, k);
      const uint32_t side = __byte_perm(word_at(mid, back ? kb : kf), m,
                                        back ? 0x6543 : 0x0765);
      // Byte lanes of 0..4 up neighbours, plus 5 where the site is up: the
      // index of the site's threshold.
      uint32_t* cell = reinterpret_cast<uint32_t*>(own + ly * Ws + k);
      const uint32_t s4 = *cell;
      const uint32_t idx = a + b + m + side + (s4 & 0x01010101u) * 5;
      uint32_t flips = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t t = thr[__byte_perm(idx, 0, 0x4440 + i)];
        flips |= (uint32_t)((words[i] >> 8) < t) << (8 * i);
      }
      *cell = s4 ^ flips;
      y = next_row(y);
      back ^= flip_side;
    }
    __syncthreads();  // this colour's sites final before the other reads them
  }

  // The interior back into the field, clipped at the field's last row and
  // column (a ragged last tile): the thread's quad where it lies in the
  // interior's plane columns [hc, hc + rx).
  const int ry = min(ty, L - Y0), rx = min(tx / 2, H - X0);  // rows, plane columns
  uint8_t* dst = out + r * LL;
  if (kWords && active && k >= hc && k < hc + rx) {
    uint8_t* col_base = dst + 2 * pcs[0];
    for (int iy = row_off; iy < ry; iy += rows_step) {
      const int y = Y0 + iy, at = (halo + iy) * Ws + k;
      const uint32_t pe = word_at(planes, at), po = word_at(planes + PS, at);
      const bool even = (y & 1) == 0;
      const uint32_t ev = even ? pe : po, od = even ? po : pe;
      *reinterpret_cast<uint2*>(col_base + (int64_t)y * L) =
          make_uint2(__byte_perm(ev, od, 0x5140), __byte_perm(ev, od, 0x7362));
    }
  } else if (!kWords && active) {
    for (int iy = row_off; iy < ry; iy += rows_step) {
      const int y = Y0 + iy;
      uint8_t* row = dst + (int64_t)y * L;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k + j;
        if (c >= hc && c < hc + rx) {
          row[2 * pcs[j] + (y & 1)] = planes[(halo + iy) * Ws + c];
          row[2 * pcs[j] + 1 - (y & 1)] = planes[PS + (halo + iy) * Ws + c];
        }
      }
    }
  }
}

}  // namespace

// One launch of the tiled variant: `sweeps` sweeps from global sweep index
// sweep0 of R replicas, in -> out (distinct buffers). k sets the halo: 2k
// field rows, and 2 hc field columns with hc = k plane columns (rounded up to
// a multiple of 4 on the word path); sweeps <= k. ty x tx (tx even; on the
// word path a multiple of 8) is the interior tile; threads, at most 1024, is
// at least the quads of a loaded plane row, ceil((tx / 2 + 2 hc) / 4), and
// is rounded down to whole rows of them.
extern "C" int ising_checkerboard_tiles(const void* in, void* out, const void* table,
                                        unsigned k0, unsigned k1, int R, int L, int sweep0,
                                        int sweeps, int k, int ty, int tx, int threads,
                                        void* stream) {
  if (R == 0 || L == 0) return (int)cudaGetLastError();
  if (L % 2 || k < 1 || sweeps < 0 || sweeps > k || ty < 1 || tx < 2 || tx % 2 ||
      threads < 1 || threads > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int H = L / 2;
  // Word moves of the field need rows of whole 4-site groups, tile origins
  // on them, and an 8-byte aligned field (a tensor view may start anywhere).
  const bool words = H % 4 == 0 && tx % 8 == 0 && (uintptr_t)in % 8 == 0 &&
                     (uintptr_t)out % 8 == 0;
  const int hc = words ? (k + 3) / 4 * 4 : k;
  const int W = tx / 2 + 2 * hc, rows = ty + 4 * k, Qt = (W + 3) / 4;
  if (threads < Qt) return (int)cudaErrorInvalidValue;
  const int ny = (L + ty - 1) / ty, nx = (L + tx - 1) / tx;
  const int64_t grid = (int64_t)R * ny * nx;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * rows * 4 * Qt;
  auto kernel = words ? checkerboard_tiles_kernel<true> : checkerboard_tiles_kernel<false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)grid, threads / Qt * Qt, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, (const float*)table, philox_keys(k0, k1), L, sweep0,
      sweeps, 2 * k, hc, ty, tx, ny, nx, W, rows);
  return (int)cudaGetLastError();
}
