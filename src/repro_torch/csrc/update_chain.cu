// d = alpha * (a_inv @ t) + mu * mom, plus one float per 64 x 64 output tile
// holding that tile's sum of d^2, in fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/update_chain.py::
// axpy_momentum, the second half of the fused fixed-lr update chain
// D = alpha (A^-1 V G^-1) + mu M (T = V G^-1 is a plain matmul launch before
// it).  The TPU kernel wrote the tile's squared norm from VMEM on its last
// K step; here the epilogue of the shared tile (gemm_tile.cuh, kAxpyNorm)
// squares the finished values while they are in registers, sums them over
// the block's valid entries (warp shuffles, then the 8 warp sums in a fixed
// order) and writes partials[by][bx], so the global-norm clip never re-reads
// D and the sum is the same on every run (no atomics).  alpha and mu are
// read from a 2-float device buffer.  Bound: 2 m n k fp32 operations against
// the 67 TFLOP/s fp32 rate.
#include "gemm_tile.cuh"

extern "C" int repro_axpy_momentum_f32(const float* a_inv, const float* t,
                                       const float* mom, float* out,
                                       float* partials, int m, int n, int k,
                                       const float* am, void* stream) {
  return repro_torch::launch_gemm_f32<repro_torch::kAxpyNorm>(
      a_inv, t, mom, out, 1, m, n, k, 0, 0, 0, 0, am, 0.f, 0.f, partials,
      stream);
}
