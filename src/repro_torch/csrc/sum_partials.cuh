// The second pass of a K split: out[i] = alpha * sum_z ws[z][i] + beta *
// c[b][.] over the `total` entries of a contiguous out, ws holding `splits`
// partial sums of `total` floats each, entry i in batch b = i / mn.  c has
// batch stride sc (0: one c for every batch) and may be null (no beta
// term); alpha and beta come from the 2-float device buffer ab when it is
// non-null.  The z-sum runs in a fixed order, so the result does not depend
// on which block finished first (no atomics).  Shared by matmul.cu,
// factor_update.cu and patch_factor.cu; each source gets its own copy of
// the kernel (an unnamed namespace), so the objects link side by side.
#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void sum_partials_kernel(const float* __restrict__ ws, int splits,
                                    long long total, long long mn,
                                    const float* __restrict__ c, long long sc,
                                    const float* __restrict__ ab, float alpha,
                                    float beta, float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * total + i];
  if (ab != nullptr) {
    alpha = ab[0];
    beta = ab[1];
  }
  out[i] = c == nullptr ? alpha * s
                        : fmaf(beta, c[(i / mn) * sc + i % mn], alpha * s);
}

// Launch on `stream`; returns cudaGetLastError() as an int.
inline int sum_partials(const float* ws, int splits, long long total,
                        long long mn, const float* c, long long sc,
                        const float* ab, float alpha, float beta, float* out,
                        cudaStream_t stream) {
  const int threads = 256;
  sum_partials_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                              threads),
                        threads, 0, stream>>>(ws, splits, total, mn, c, sc,
                                              ab, alpha, beta, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
