// K3-hb (heat-bath variant): the diagonal sweep's op-count carry scan.
//
// Replaces the Pallas kernel
// isingmontecarlo_tpu/ops/diag_carry.py::carry_decisions (body
// _kernel_heatbath). The twin of carry_metropolis.cu: each slot's
// insert/remove decision depends on the op count n entering the slot, which
// the decisions before it change, so the scan over M is sequential per
// replica: one thread per replica walks the M slots, with the replica's
// bwt = beta * sum_b max_w(b) in a register. The arithmetic is the f32
// expressions of isingmontecarlo_tpu/sse/diagonal.py::_ins_rem (heat-bath
// branch), with the strict < comparisons and JAX's left-to-right
// association, evaluated with round-to-nearest intrinsics (and
// --fmad=false) so that nothing is contracted into an FMA:
//   mmn    = float(M - n)
//   insert = idp && insw && u0 * (mmn + bwt) < bwt
//   remove = dgp && u0 * ((mmn + 1) + bwt) < mmn + 1
//
// Bound on the card. Bytes: 7 in and 2 out a slot and replica, 16.1 MB at
// M = 7000, R = 256, 0.0048 ms at 3.35 TB/s. The real ceiling is the serial
// chain: M x (dependent cycles a slot) / clock, whatever R is, until the
// chain warps outnumber the card's schedulers. chip_smoke.py reads the
// cycles a slot from this kernel's SASS (cuobjdump -sass).
//
// What the design does about it (carry_ring.cuh): a producer warp streams
// the four planes by TMA through a ring of 64-slot tiles, and two prep
// warps fold the masks and the n-independent products into replica-major
// tiles, so the chain never waits on device memory and loads four slots at
// once; the chain carries mmn and mmn + 1 as exact floats stepped by +-1
// (no int-to-float conversion) and writes one code byte a slot to shared
// memory, which the prep warps store 16 bytes at a time. A slot's chain
// is FADD (mmn + bwt), FMUL, FSET (the compare, as 1.0f or 0.0f) and two
// FADDs: 5 dependent instructions a slot in the SASS, two adds longer than
// K3's, since mmn + bwt rounds and cannot be carried, and the remove test,
// on the same path, is ready no earlier than the insert test; 20 clocks at
// Hopper's 4-clock ALU latency, so 0.071 ms for M = 7000 at 1980 MHz.

#include "carry_ring.cuh"

namespace {

using carry_ring::Planes;
using carry_ring::Raw;

struct HeatBath {
  static constexpr int NF = 1;  // u0
  static constexpr int NB = 3;  // idp, dgp, insw
  static constexpr int NV = 2;  // u_ins, u_rem

  float mmn, mmn1, bw;

  __device__ HeatBath(const Planes<NF, NB>& a, int r) {
    mmn = __int2float_rn(a.M - (r < a.R ? a.n0[r] : a.M));
    mmn1 = __fadd_rn(mmn, 1.0f);
    bw = r < a.R ? a.bwt[r] : 0.0f;
  }

  // A slot's n-independent values, folded off the chain: u0 for each test,
  // NaN where its mask is off (NaN fails every comparison).
  static __device__ __forceinline__ void prep(const Raw<NF, NB>& t, int j, int r, float* v) {
    const float u = t.f[0][j][r], nan = __int_as_float(0x7fffffff);
    v[0] = t.b[0][j][r] && t.b[2][j][r] ? u : nan;
    v[1] = t.b[1][j][r] ? u : nan;
  }

  // The chain: FADD (mmn + bwt), FMUL, FSET (the compare, as 1.0f or 0.0f),
  // then two FADDs.
  __device__ __forceinline__ uint32_t step(const float* v) {
    const float i = carry_ring::lt(__fmul_rn(v[0], __fadd_rn(mmn, bw)), bw);
    const float r = carry_ring::lt(__fmul_rn(v[1], __fadd_rn(mmn1, bw)), mmn1);
    mmn = __fsub_rn(__fadd_rn(mmn, r), i);
    mmn1 = __fsub_rn(__fadd_rn(mmn1, r), i);
    return carry_ring::code(i, r);
  }
};

}  // namespace

extern "C" int ising_carry_heatbath(const void* n0, const void* u0,
                                    const void* idp, const void* dgp,
                                    const void* insw, const void* bwt,
                                    void* insert, void* remove, int M, int R,
                                    void* stream) {
  Planes<HeatBath::NF, HeatBath::NB> a{};
  a.f[0] = (const float*)u0;
  a.b[0] = (const uint8_t*)idp;
  a.b[1] = (const uint8_t*)dgp;
  a.b[2] = (const uint8_t*)insw;
  a.out[0] = (uint8_t*)insert;
  a.out[1] = (uint8_t*)remove;
  a.n0 = (const int32_t*)n0;
  a.bwt = (const float*)bwt;
  a.M = M;
  a.R = R;
  return carry_ring::launch<HeatBath>(a, (cudaStream_t)stream);
}
