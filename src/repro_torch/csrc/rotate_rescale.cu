// out[b] = (a[b] @ b[b]) / (s[b] + lam) in fp32 (batch over gridDim.z).
//
// Replaces the Pallas TPU kernel repro/kernels/rotate_rescale.py::
// matmul_rescale, the middle product of the EKFAC eigenbasis apply
// Q_A [(Q_A^T V Q_G) / (s + lam)] Q_G^T: the TPU kernel divided its VMEM
// accumulator by the damped diagonal on the last K step.  Here the product
// runs on the pipelined main loop of gemm_pipeline.cuh (64 x 64 tiles, 4 x 4
// register patches, a cp.async ring of K slices) with its dense loader, and
// the division is the epilogue (kRescale), applied once to the full sum
// while it is in registers, so the eigenbasis gradient is never written
// undivided and re-read.  A is staged as rows by 16-byte copies where K % 4
// == 0 and A is aligned (half the main loop's shared-memory reads of A),
// else k-major by 4-byte copies.  Where the output's tiles cannot fill the
// card, the host plan (kernels/gemm_plan.py) splits K over grid z: each
// block writes its raw partial sum to `ws`, and
// rescale_partials_kernel adds the partials in a fixed order and divides
// (no atomics).  lam comes by value or, when lam_dev is non-null, as a
// device float read inside the kernel (a traced damping, no host read).
//
// Bound: 2 m n k fp32 operations against the 67 TFLOP/s fp32 rate (4.49
// GFLOP, 0.067 ms for the autoencoder's 8 layers); the division adds m n.
#include "gemm_pipeline.cuh"

namespace {

namespace pipe = repro_torch::pipe;

constexpr int kTile = 64;   // output tile edge (gemm_plan.DENSE_TILE)

// Block (x, y, z): output tile (y, x) of batch z / splits, summing K rows
// [(z % splits) * chunk, ... + chunk).  kRescale writes out[b]; kStore
// writes the raw partial to ws[z % splits][b].
template <int BM, int BN, bool VEC, bool A_ROWS, int EPI>
__global__ void __launch_bounds__(pipe::kThreads, 2)
matmul_rescale_kernel(const float* __restrict__ A,
                      const float* __restrict__ B,
                      const float* __restrict__ S, float* __restrict__ O,
                      int M, int N, int K, int chunk, int splits,
                      long long sA, long long sB, long long sS, long long sO,
                      const float* __restrict__ lam_dev, float lam) {
  extern __shared__ float4 smem4[];
  using T = pipe::Tile<BM, BN>;
  const int bz = blockIdx.z / splits, z = blockIdx.z % splits;
  const int k_begin = z * chunk, k_end = min(K, k_begin + chunk);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const pipe::DenseLoader<BM, BN, VEC, A_ROWS> ld{
      A + bz * sA, B + bz * sB, M, N, K, row0, col0, k_begin, k_end};
  float acc[T::kTM][T::kTN] = {};
  const int slices = max(0, k_end - k_begin + pipe::kBK - 1) / pipe::kBK;
  pipe::mainloop<BM, BN>(ld, reinterpret_cast<float*>(smem4), slices, acc);
  if constexpr (EPI == pipe::kRescale) {
    if (lam_dev != nullptr) lam = *lam_dev;
    pipe::store_tile<pipe::kRescale, BM, BN>(acc, O + bz * sO, S + bz * sS,
                                            N, M, N, row0, col0, lam, 0.f,
                                            false);
  } else {
    const long long batch = gridDim.z / splits;
    pipe::store_tile<pipe::kStore, BM, BN>(
        acc, O + (z * batch + bz) * static_cast<long long>(M) * N, nullptr, N,
        M, N, row0, col0, 0.f, 0.f, false);
  }
}

// out[i] = (sum_z ws[z][i]) / (S[b][.] + lam) over the batch * M * N
// entries of a contiguous out, the z-sum in a fixed order.
__global__ void rescale_partials_kernel(const float* __restrict__ ws,
                                        int splits, long long total,
                                        long long mn,
                                        const float* __restrict__ S,
                                        long long sS,
                                        const float* __restrict__ lam_dev,
                                        float lam, float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * total + i];
  if (lam_dev != nullptr) lam = *lam_dev;
  out[i] = s / (S[(i / mn) * sS + i % mn] + lam);
}

template <int BM, int BN, bool VEC, bool A_ROWS, int EPI>
int launch(const float* a, const float* b, const float* s, float* o,
           int batch, int m, int n, int k, int chunk, int splits,
           long long sa, long long sb, long long ss, long long so,
           const float* lam_dev, float lam, cudaStream_t stream) {
  constexpr int smem = pipe::Tile<BM, BN>::kSmemBytes;
  static const int allowed = pipe::allow_smem(
      matmul_rescale_kernel<BM, BN, VEC, A_ROWS, EPI>, smem);
  if (allowed != 0) return allowed;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch * splits);
  matmul_rescale_kernel<BM, BN, VEC, A_ROWS, EPI>
      <<<grid, pipe::kThreads, smem, stream>>>(
          a, b, s, o, m, n, k, chunk, splits, sa, sb, ss, so, lam_dev, lam);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool A_ROWS>
int launch_plan(const float* a, const float* b, const float* s, float* out,
                float* ws, int batch, int m, int n, int k, int chunk,
                int splits, long long sa, long long sb, long long ss,
                long long so, const float* lam_dev, float lam,
                cudaStream_t stream) {
  if (splits <= 1)
    return launch<kTile, kTile, VEC, A_ROWS, pipe::kRescale>(
        a, b, s, out, batch, m, n, k, chunk, 1, sa, sb, ss, so, lam_dev, lam,
        stream);
  const int status = launch<kTile, kTile, VEC, A_ROWS, pipe::kStore>(
      a, b, nullptr, ws, batch, m, n, k, chunk, splits, sa, sb, 0, 0,
      nullptr, 0.f, stream);
  if (status != 0) return status;
  const long long mn = static_cast<long long>(m) * n, total = batch * mn;
  const int threads = 256;
  rescale_partials_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                  threads),
                            threads, 0, stream>>>(ws, splits, total, mn, s,
                                                  ss, lam_dev, lam, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk (K rows a block sums, a multiple of 16) and splits (K chunks; > 1
// sums partials in ws, (splits, batch, m, n)) come from the host plan; vec:
// B's rows are copied 16 bytes at a time (n % 4 == 0 and b 16-byte
// aligned); arows: A staged as rows by 16-byte copies (k % 4 == 0, sa % 4
// == 0 and a 16-byte aligned).  out is contiguous ([batch,] m, n).
extern "C" int repro_matmul_rescale_f32(const float* a, const float* b,
                                        const float* s, float* out, float* ws,
                                        int batch, int m, int n, int k,
                                        long long sa, long long sb,
                                        long long ss, long long so,
                                        const float* lam_dev, float lam,
                                        int chunk, int splits, int vec,
                                        int arows, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (chunk <= 0 || chunk % pipe::kBK != 0 || splits <= 0 ||
      (splits > 1 && ws == nullptr) ||
      (arows && (k % 4 != 0 || sa % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    return arows ? launch_plan<true, true>(a, b, s, out, ws, batch, m, n, k,
                                           chunk, splits, sa, sb, ss, so,
                                           lam_dev, lam, st)
                 : launch_plan<true, false>(a, b, s, out, ws, batch, m, n, k,
                                            chunk, splits, sa, sb, ss, so,
                                            lam_dev, lam, st);
  return arows ? launch_plan<false, true>(a, b, s, out, ws, batch, m, n, k,
                                          chunk, splits, sa, sb, ss, so,
                                          lam_dev, lam, st)
               : launch_plan<false, false>(a, b, s, out, ws, batch, m, n, k,
                                           chunk, splits, sa, sb, ss, so,
                                           lam_dev, lam, st);
}
