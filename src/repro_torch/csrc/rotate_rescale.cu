// out[b] = (a[b] @ b[b]) / (s[b] + lam) in fp32 (batch over gridDim.z).
//
// Replaces the Pallas TPU kernel repro/kernels/rotate_rescale.py::
// matmul_rescale, the middle product of the EKFAC eigenbasis apply
// Q_A [(Q_A^T V Q_G) / (s + lam)] Q_G^T: the TPU kernel divided its VMEM
// accumulator by the damped diagonal on the last K step; here the division
// is the epilogue of the shared tile (gemm_tile.cuh, kRescale), applied
// while the 64 x 64 tile is in registers, so the eigenbasis gradient is
// never written undivided and re-read.  lam comes by value or, when lam_ab
// is non-null, from a (lam, 0) device buffer (a traced damping, no host
// read).  Bound: 2 m n k fp32 operations against the 67 TFLOP/s fp32 rate;
// the division adds m n.
#include "gemm_tile.cuh"

extern "C" int repro_matmul_rescale_f32(const float* a, const float* b,
                                        const float* s, float* out, int batch,
                                        int m, int n, int k, long long sa,
                                        long long sb, long long ss,
                                        long long so, const float* lam_ab,
                                        float lam, void* stream) {
  return repro_torch::launch_gemm_f32<false, repro_torch::kRescale>(
      a, b, s, out, batch, m, n, k, k, sa, sb, ss, so, lam_ab, lam, 0.f,
      nullptr, stream);
}
