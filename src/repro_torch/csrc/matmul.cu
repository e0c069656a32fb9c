// out[b] = alpha * a[b] @ b[b] + beta * c[b] in fp32 (batch over gridDim.z).
//
// Replaces the Pallas TPU kernel repro/kernels/matmul.py::matmul, whose grid
// carried a K-sum across sequential grid steps in VMEM scratch; here K is a
// loop inside each block (gemm_tile.cuh).  On this path it carries the
// two-sided preconditioning, the Newton-Schulz iteration and three of the
// four rotations of the EKFAC apply, all fp32 products bound by the card's
// 67 TFLOP/s fp32 rate at the widths used.
#include "gemm_tile.cuh"

extern "C" int repro_matmul_f32(const float* a, const float* b,
                                const float* c, float* out, int batch, int m,
                                int n, int k, long long sa, long long sb,
                                long long sc, long long so, const float* ab,
                                float alpha, float beta, void* stream) {
  return repro_torch::launch_gemm_f32<repro_torch::kAxpby>(
      a, b, c, out, batch, m, n, k, sa, sb, sc, so, ab, alpha, beta, nullptr,
      stream);
}

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
