// The second pass of a K split: out = ab[0] * sum_z ws[z] + ab[1] * c over
// dd entries, ws holding `splits` partial sums of dd floats each.  The
// z-sum runs in a fixed order, so the result does not depend on which
// block finished first (no atomics).  Shared by factor_update.cu and
// patch_factor.cu; each source gets its own copy of the kernel (an
// unnamed namespace), so the two objects link side by side.
#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void sum_partials_kernel(const float* __restrict__ ws, int splits,
                                    long long dd, const float* __restrict__ c,
                                    const float* __restrict__ ab,
                                    float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= dd) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * dd + i];
  out[i] = fmaf(ab[1], c[i], ab[0] * s);
}

}  // namespace
