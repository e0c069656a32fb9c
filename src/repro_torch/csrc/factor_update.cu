// out[b] = ab[0] * x[b]^T x[b] + ab[1] * c[b] for x of shape ([batch,] n, d),
// c of shape ([batch,] d, d).
//
// Replaces the Pallas TPU kernel repro/kernels/factor_update.py::
// factor_update (the decayed Kronecker-factor accumulation of paper S5).
// alpha and beta are read from a 2-float device buffer: the decay
// eps = min(1 - 1/k, cap) is computed on the device every step, and reading
// it on the host would sync.  x is read as both operands; the transpose is
// folded into the A-tile load (gemm_tile.cuh, XTX = true), so no copy of x^T
// is made.  Bound: x^T x is symmetric, so only its d (d + 1) / 2 distinct
// entries are needed, n d (d + 1) fp32 operations (8.2 GFLOP at n = 8192,
// d = 1001), against the 67 TFLOP/s fp32 rate.  This kernel computes the
// whole (d, d) product, twice that; one triangle plus a mirror is later work.
//
// A d x d output has only ceil(d / 64)^2 tiles (one at d = 30, 16 at
// d = 251), far fewer than the card's 132 SMs, while K = n = 8192 is long.
// With splits > 1 the rows of x are cut into `splits` chunks, one grid
// z-slice each, whose partial sums land in `ws` (splits, d, d); a second,
// elementwise kernel adds them in a fixed order and applies the epilogue,
// so the result does not depend on scheduling.
//
// The LM's stacked layers (n_stack groups of one pattern position) send a
// batch of factors at once: grid z runs over the batch, every slice summing
// its own n rows (k_total = batch * n, so the tile's per-z row clamp keeps
// all n).  A batch fills the card with batch times the tiles, so it takes
// no split.
#include "gemm_tile.cuh"
#include "sum_partials.cuh"

extern "C" int repro_factor_update_f32(const float* x, const float* c,
                                       float* out, float* ws, int batch,
                                       int n, int d, int splits,
                                       const float* ab, void* stream) {
  const long long dd = static_cast<long long>(d) * d;
  if (batch > 1) {
    const long long nd = static_cast<long long>(n) * d;
    return repro_torch::launch_gemm_f32<true, repro_torch::kAxpby>(
        x, x, c, out, batch, d, d, n, batch * n, nd, nd, dd, dd, ab, 0.f,
        0.f, nullptr, stream);
  }
  if (splits <= 1)
    return repro_torch::launch_gemm_f32<true, repro_torch::kAxpby>(
        x, x, c, out, 1, d, d, n, n, 0, 0, 0, 0, ab, 0.f, 0.f, nullptr,
        stream);
  // chunk rows, a multiple of the K tile; the last chunk may be short
  const int per = (n + splits - 1) / splits;
  const int chunk = (per + repro_torch::kBK - 1) / repro_torch::kBK *
                    repro_torch::kBK;
  const int used = (n + chunk - 1) / chunk;
  const int status = repro_torch::launch_gemm_f32<true, repro_torch::kAxpby>(
      x, x, nullptr, ws, used, d, d, chunk, n,
      static_cast<long long>(chunk) * d, static_cast<long long>(chunk) * d, 0,
      dd, nullptr, 1.f, 0.f, nullptr, stream);
  if (status != 0) return status;
  const int threads = 256;
  const long long blocks = (dd + threads - 1) / threads;
  sum_partials_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(ws, used, dd, c,
                                                             ab, out);
  return static_cast<int>(cudaGetLastError());
}
