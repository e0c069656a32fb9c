// d[b] = alpha * (a_inv[b] @ t[b]) + mu * mom[b] in fp32 (batch over grid
// z), plus one float per 64 x 64 output tile of each batch item holding
// that tile's sum of d^2.
//
// Replaces the Pallas TPU kernel repro/kernels/update_chain.py::
// axpy_momentum, the second half of the fused fixed-lr update chain
// D = alpha (A^-1 V G^-1) + mu M (T = V G^-1 is a matmul launch before it).
// The TPU kernel wrote the tile's squared norm from VMEM on its last K step.
//
// Bound: 2 m n k fp32 operations against the 67 TFLOP/s fp32 rate (4.50
// GFLOP, 0.0673 ms for the autoencoder's 8 layers, (m, k, n) = (a, a, g));
// the operands are read once, far below the memory rate.  The product runs
// on the pipelined main loop of gemm_pipeline.cuh (64 x 64 tiles, 4 x 4
// register patches, a cp.async ring of K slices, masked ragged edges by
// zero fill).  B's rows are copied 16 bytes at a time where N % 4 == 0 and
// B is aligned; A is staged as rows by 16-byte copies where K % 4 == 0 and
// A is aligned, else k-major by 4-byte copies (the autoencoder's K = a is
// ragged).  The epilogue (kAxpyNorm) forms alpha acc + mu M in registers,
// writes D and squares it there, and the block sums the squares in a fixed
// order (block_sum), so the global-norm clip never re-reads D and the sum
// is the same on every run (no atomics).  K stays whole: a split of it over
// blocks, with a second pass adding the partials before this epilogue, was
// slower at the autoencoder's 8 layers on the device and on the host clock.
// alpha and mu are read from a 2-float device buffer after the main loop
// (the chain's -lr and mu live on the device).  A batch (the LM's stacked
// layers) rides grid z as in matmul.cu: each item has its own grid of
// partials, and the wrapper sums all of them in a fixed order.
#include "gemm_pipeline.cuh"

namespace {

namespace pipe = repro_torch::pipe;

constexpr int kTile = 64;   // output tile edge (gemm_plan.DENSE_TILE)
using Tile = pipe::Tile<kTile, kTile>;

// Block (x, y, z): output tile (y, x) of batch item z over the whole of K;
// writes D and its tile's sum of D^2 to partials[z][y][x].  sA, sB, sC are
// the batch strides of a_inv, t and mom (0: one operand for every item).
template <bool VEC, bool A_ROWS>
__global__ void __launch_bounds__(pipe::kThreads, 2)
axpy_momentum_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ C, float* __restrict__ O,
                     int M, int N, int K, long long sA, long long sB,
                     long long sC, const float* __restrict__ am,
                     float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const long long bz = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const pipe::DenseLoader<kTile, kTile, VEC, A_ROWS> ld{
      A + bz * sA, B + bz * sB, M, N, K, row0, col0, 0, K};
  float acc[Tile::kTM][Tile::kTN] = {};
  pipe::mainloop<kTile, kTile>(ld, reinterpret_cast<float*>(smem4),
                               (K + pipe::kBK - 1) / pipe::kBK, acc);
  const float sq = pipe::store_tile<pipe::kAxpyNorm, kTile, kTile>(
      acc, O + bz * M * N, C + bz * sC, N, M, N, row0, col0, am[0], am[1],
      false);
  const float total = pipe::block_sum(sq);
  if (threadIdx.x == 0)
    partials[(bz * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total;
}

template <bool VEC, bool A_ROWS>
int launch(const float* a, const float* b, const float* c, float* o,
           int batch, int m, int n, int k, long long sa, long long sb,
           long long sc, const float* am, float* partials,
           cudaStream_t stream) {
  constexpr int smem = Tile::kSmemBytes;
  static const int allowed =
      pipe::allow_smem(axpy_momentum_kernel<VEC, A_ROWS>, smem);
  if (allowed != 0) return allowed;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, batch);
  axpy_momentum_kernel<VEC, A_ROWS><<<grid, pipe::kThreads, smem, stream>>>(
      a, b, c, o, m, n, k, sa, sb, sc, am, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a_inv (batch, m, k), t (batch, k, n), mom (batch, m, n), all row-major,
// with batch strides sa, sb, sc (0: one operand for every item); out is
// contiguous (batch, m, n); partials holds batch x ceil(m / 64) x
// ceil(n / 64) floats; alpha and mu are am[0], am[1] on the device.  vec:
// t's rows copied 16 bytes at a time (n % 4 == 0, sb % 4 == 0, t 16-byte
// aligned); arows: a_inv staged as rows by 16-byte copies (k % 4 == 0,
// sa % 4 == 0, a_inv 16-byte aligned).
extern "C" int repro_axpy_momentum_f32(const float* a_inv, const float* t,
                                       const float* mom, float* out,
                                       float* partials, int batch, int m,
                                       int n, int k, long long sa,
                                       long long sb, long long sc,
                                       const float* am, int vec, int arows,
                                       void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (batch > 65535 || k < 0 || partials == nullptr || am == nullptr ||
      (vec && (n % 4 != 0 || sb % 4 != 0)) ||
      (arows && (k % 4 != 0 || sa % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    return arows ? launch<true, true>(a_inv, t, mom, out, batch, m, n, k, sa,
                                      sb, sc, am, partials, st)
                 : launch<true, false>(a_inv, t, mom, out, batch, m, n, k,
                                       sa, sb, sc, am, partials, st);
  return arows ? launch<false, true>(a_inv, t, mom, out, batch, m, n, k, sa,
                                     sb, sc, am, partials, st)
               : launch<false, false>(a_inv, t, mom, out, batch, m, n, k, sa,
                                      sb, sc, am, partials, st);
}
