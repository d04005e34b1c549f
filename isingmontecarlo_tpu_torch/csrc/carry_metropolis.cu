// K3 (Metropolis variant): the diagonal sweep's op-count carry scan.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/diag_carry.py::carry_decisions (body
// _kernel_metropolis). Each slot's insert/remove decision depends on the op
// count n entering the slot, which the decisions before it change, so the
// scan over M is sequential per replica: one thread per replica walks the M
// slots. The arithmetic is the f32 expressions of isingmontecarlo_tpu/sse/
// diagonal.py::_ins_rem, with the two strict < comparisons, evaluated with
// round-to-nearest intrinsics (and --fmad=false) so that nothing is
// contracted into an FMA:
//   mmn    = float(M - n)
//   insert = idp && u0 * mmn < num_ins
//   remove = dgp && u0 * num_rem < mmn + 1
//
// Bound on the card. Bytes: 14 in and 2 out a slot and replica, 28.7 MB at
// M = 7000, R = 256, 0.0086 ms at 3.35 TB/s. The real ceiling is the serial
// chain: M x (dependent cycles a slot) / clock, whatever R is, until the
// chain warps outnumber the card's schedulers. chip_smoke.py reads the
// cycles a slot from this kernel's SASS (cuobjdump -sass).
//
// What the design does about it (carry_ring.cuh): a producer warp streams
// the five planes by TMA through a ring of 64-slot tiles, and two prep
// warps fold the masks and the n-independent products into replica-major
// tiles, so the chain never waits on device memory and loads four slots at
// once; the chain carries mmn and mmn + 1 as exact floats stepped by +-1
// (no int-to-float conversion) and writes one code byte a slot to shared
// memory, which the prep warps store 16 bytes at a time. A slot's chain
// is FMUL (u0 * mmn), FSET (the compare, as 1.0f or 0.0f) and FADD: 3
// dependent instructions a slot in the SASS, 12 clocks at Hopper's 4-clock
// ALU latency, so 0.043 ms for M = 7000 at 1980 MHz; PERF.md holds that
// against the kernel's measured time.

#include "carry_ring.cuh"

namespace {

using carry_ring::Planes;
using carry_ring::Raw;

struct Metropolis {
  static constexpr int NF = 3;  // u0, num_ins, num_rem
  static constexpr int NB = 2;  // idp, dgp
  static constexpr int NV = 3;  // u_ins, num_ins, urem

  float mmn, mmn1;

  __device__ Metropolis(const Planes<NF, NB>& a, int r) {
    mmn = __int2float_rn(a.M - (r < a.R ? a.n0[r] : a.M));
    mmn1 = __fadd_rn(mmn, 1.0f);
  }

  // A slot's n-independent values, folded off the chain. A mask folds into
  // its test as NaN, which fails every comparison: u_ins = idp ? u0 : NaN,
  // and urem = dgp ? u0 * num_rem : NaN.
  static __device__ __forceinline__ void prep(const Raw<NF, NB>& t, int j, int r, float* v) {
    const float u = t.f[0][j][r], nan = __int_as_float(0x7fffffff);
    v[0] = t.b[0][j][r] ? u : nan;
    v[1] = t.f[1][j][r];
    v[2] = t.b[1][j][r] ? __fmul_rn(u, t.f[2][j][r]) : nan;
  }

  // The chain: FSET (remove) and FADD beside FMUL and FSET (insert), then
  // FADD; mmn1 follows mmn one add behind.
  __device__ __forceinline__ uint32_t step(const float* v) {
    const float r = carry_ring::lt(v[2], mmn1);
    const float i = carry_ring::lt(__fmul_rn(v[0], mmn), v[1]);
    mmn = __fsub_rn(__fadd_rn(mmn, r), i);
    mmn1 = __fsub_rn(__fadd_rn(mmn1, r), i);
    return carry_ring::code(i, r);
  }
};

}  // namespace

extern "C" int ising_carry_metropolis(const void* n0, const void* u0,
                                      const void* idp, const void* dgp,
                                      const void* num_ins, const void* num_rem,
                                      void* insert, void* remove, int M, int R,
                                      void* stream) {
  Planes<Metropolis::NF, Metropolis::NB> a{};
  a.f[0] = (const float*)u0;
  a.f[1] = (const float*)num_ins;
  a.f[2] = (const float*)num_rem;
  a.b[0] = (const uint8_t*)idp;
  a.b[1] = (const uint8_t*)dgp;
  a.out[0] = (uint8_t*)insert;
  a.out[1] = (uint8_t*)remove;
  a.n0 = (const int32_t*)n0;
  a.M = M;
  a.R = R;
  return carry_ring::launch<Metropolis>(a, (cudaStream_t)stream);
}
