// out[b] = alpha * a[b] @ b[b] + beta * c[b] in fp32 (batch over grid z).
//
// Replaces the Pallas TPU kernel repro/kernels/matmul.py::matmul, whose grid
// carried a K-sum across sequential grid steps in VMEM scratch.  On this
// path it carries the two-sided preconditioning, the Newton-Schulz
// iteration (the autoencoder's 16 factors, whisper-small's stacked (12,
// 768, 768) and (12, 3072, 3072) ones) and three of the four rotations of
// the EKFAC apply.
//
// Bound: 2 m n k fp32 operations a product against the card's 67 TFLOP/s
// fp32 rate (no TF32); the operands are read once, far below the memory
// rate at these widths.  The product runs on the pipelined main loop of
// gemm_pipeline.cuh: a 3-stage cp.async ring of 16-row K slices, masked
// ragged edges by zero fill, 8 x 8 register patches on the 128 x 128 tile
// (whisper's stacked 3072-wide products, which fill the card many times
// over) or 4 x 4 on the 64 x 64 one (products with few tiles).  B's rows
// are copied 16 bytes at a time where its width, batch stride and address
// allow (the 128 tile takes no other B).  On the 64 tile A is staged as
// rows [m][k] by 16-byte copies where K % 4 == 0 and A is aligned, which
// halves the main loop's shared-memory reads of A; else, and on the 128
// tile, k-major by 4-byte copies, each to its transposed place.  Where the
// output's tiles cannot fill the card, K is split over grid z: each block
// writes its raw partial sum into `ws`, and sum_partials_kernel adds the
// partials in a fixed order and applies alpha and beta C (no atomics: two
// calls give the same bits).  The host plan (kernels/gemm_plan.py::
// dense_plan) picks the tile and the split.  alpha and beta come by value
// or, when `ab` is non-null, from a 2-float device buffer read inside the
// kernel, so values that live on the device (the damping, the chain's
// alpha and mu) need no host sync.
#include "gemm_pipeline.cuh"
#include "sum_partials.cuh"

namespace {

namespace pipe = repro_torch::pipe;

// Block (x, y, z): output tile (y, x) of batch z / splits, summing K rows
// [(z % splits) * chunk, ... + chunk) into O + ((z % splits) * batch +
// batch index) * sO.  EPI kAxpby (C present) or kScale (no C); a split's
// partial is kScale at alpha 1 into the workspace.
template <int BM, bool BVEC, bool A_ROWS, int EPI>
__global__ void __launch_bounds__(pipe::kThreads, 2)
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ C, float* __restrict__ O, int M,
              int N, int K, int chunk, int splits, long long sA, long long sB,
              long long sC, long long sO, const float* __restrict__ ab,
              float alpha, float beta) {
  extern __shared__ float4 smem4[];
  using T = pipe::Tile<BM, BM>;
  const int bz = blockIdx.z / splits, z = blockIdx.z % splits;
  const int k_begin = z * chunk, k_end = min(K, k_begin + chunk);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  const pipe::DenseLoader<BM, BM, BVEC, A_ROWS> ld{
      A + bz * sA, B + bz * sB, M, N, K, row0, col0, k_begin, k_end};
  float acc[T::kTM][T::kTN] = {};
  const int slices = max(0, k_end - k_begin + pipe::kBK - 1) / pipe::kBK;
  pipe::mainloop<BM, BM>(ld, reinterpret_cast<float*>(smem4), slices, acc);
  if (ab != nullptr) {
    alpha = ab[0];
    beta = ab[1];
  }
  const long long batch = gridDim.z / splits;
  pipe::store_tile<EPI, BM, BM>(acc, O + (z * batch + bz) * sO,
                                C == nullptr ? nullptr : C + bz * sC, N, M, N,
                                row0, col0, alpha, beta, false);
}

template <int BM, bool BVEC, bool A_ROWS, int EPI>
int launch(const float* a, const float* b, const float* c, float* o,
           int batch, int m, int n, int k, int chunk, int splits,
           long long sa, long long sb, long long sc, long long so,
           const float* ab, float alpha, float beta, cudaStream_t stream) {
  constexpr int smem = pipe::Tile<BM, BM>::kSmemBytes;
  static const int allowed =
      pipe::allow_smem(matmul_kernel<BM, BVEC, A_ROWS, EPI>, smem);
  if (allowed != 0) return allowed;
  const dim3 grid((n + BM - 1) / BM, (m + BM - 1) / BM, batch * splits);
  matmul_kernel<BM, BVEC, A_ROWS, EPI>
      <<<grid, pipe::kThreads, smem, stream>>>(a, b, c, o, m, n, k, chunk,
                                               splits, sa, sb, sc, so, ab,
                                               alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool BVEC, bool A_ROWS>
int launch_plan(const float* a, const float* b, const float* c, float* out,
                float* ws, int batch, int m, int n, int k, int chunk,
                int splits, long long sa, long long sb, long long sc,
                long long so, const float* ab, float alpha, float beta,
                cudaStream_t stream) {
  if (splits <= 1)
    return c == nullptr
               ? launch<BM, BVEC, A_ROWS, pipe::kScale>(
                     a, b, nullptr, out, batch, m, n, k, chunk, 1, sa, sb, 0,
                     so, ab, alpha, beta, stream)
               : launch<BM, BVEC, A_ROWS, pipe::kAxpby>(
                     a, b, c, out, batch, m, n, k, chunk, 1, sa, sb, sc, so,
                     ab, alpha, beta, stream);
  const long long mn = static_cast<long long>(m) * n;
  const int status = launch<BM, BVEC, A_ROWS, pipe::kScale>(
      a, b, nullptr, ws, batch, m, n, k, chunk, splits, sa, sb, 0, mn,
      nullptr, 1.f, 0.f, stream);
  if (status != 0) return status;
  return sum_partials(ws, splits, batch * mn, mn, c, sc, ab, alpha, beta, out,
                      stream);
}

}  // namespace

// c may be null (no beta term); sa, sb, sc are batch strides (0: one
// operand for every batch), so is out's (m n, or 0 without a batch).  tile
// (128 or 64), chunk (K rows a block sums, a multiple of 16) and splits (K
// chunks; > 1 sums partials in ws, (splits, batch, m, n)) come from the host
// plan.  bvec: B's rows copied 16 bytes at a time (n % 4 == 0, sb % 4 == 0,
// b 16-byte aligned), which the 128 tile requires: its 4-byte B loader
// spills at 128 registers.  arows: A staged as rows by 16-byte copies (k %
// 4 == 0, sa % 4 == 0, a 16-byte aligned), on the 64 tile only: the rows'
// reads spill at the 128 tile, which stages A k-major.  out is contiguous
// ([batch,] m, n).
extern "C" int repro_matmul_f32(const float* a, const float* b,
                                const float* c, float* out, float* ws,
                                int batch, int m, int n, int k, long long sa,
                                long long sb, long long sc, long long so,
                                const float* ab, float alpha, float beta,
                                int tile, int chunk, int splits, int bvec,
                                int arows, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if ((tile != 64 && tile != 128) || chunk <= 0 || chunk % pipe::kBK != 0 ||
      splits <= 0 || k < 0 || static_cast<long long>(chunk) * splits < k ||
      (splits > 1 && ws == nullptr) ||
      (bvec && (n % 4 != 0 || sb % 4 != 0)) ||
      (arows && (k % 4 != 0 || sa % 4 != 0)) ||
      (tile == 128 && (!bvec || arows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile == 128)
    return launch_plan<128, true, false>(a, b, c, out, ws, batch, m, n, k,
                                         chunk, splits, sa, sb, sc, so, ab,
                                         alpha, beta, st);
  if (bvec)
    return arows ? launch_plan<64, true, true>(a, b, c, out, ws, batch, m, n,
                                               k, chunk, splits, sa, sb, sc,
                                               so, ab, alpha, beta, st)
                 : launch_plan<64, true, false>(a, b, c, out, ws, batch, m,
                                                n, k, chunk, splits, sa, sb,
                                                sc, so, ab, alpha, beta, st);
  return arows ? launch_plan<64, false, true>(a, b, c, out, ws, batch, m, n,
                                              k, chunk, splits, sa, sb, sc,
                                              so, ab, alpha, beta, st)
               : launch_plan<64, false, false>(a, b, c, out, ws, batch, m, n,
                                               k, chunk, splits, sa, sb, sc,
                                               so, ab, alpha, beta, st);
}

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
