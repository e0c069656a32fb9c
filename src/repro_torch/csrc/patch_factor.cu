// out = ab[0] * P^T P + ab[1] * c, with P = [im2col(x); 1] of a 1-D conv,
// read from the raw input x (b, t, ch) and never materialized.
//
// Replaces the Pallas TPU kernel repro/kernels/patch_factor.py::
// patch_factor (and the jnp border splice of patch_factor_update), the KFC
// patch-factor update A <- beta A + alpha P^T P of a conv layer (Grosse &
// Martens 1602.01407).  Row (bb, tt) of P, tt < t_out, and feature
// f = k * ch + c (tap-major, the row order of the conv weight matrix) read
// x[bb, tt * stride + k - lo, c], 0 outside [0, t) (lax "SAME"/"VALID" zero
// padding, lo the low-side pad); with has_bias, feature taps * ch is the
// constant 1, so the homogeneous border of the factor comes out of the same
// tile loop instead of a separate splice.
//
// The TPU kernel walked tap pairs on its grid with a VMEM halo and needed
// ch <= 128, ch % 8 == 0 and a tiling t_out.  Here the output is cut into
// the masked 64 x 64 tiles of gemm_tile.cuh (its tile sizes, and the same
// 4 x 4 register patch per thread), each block staging its K slices (16
// rows of P) through shared memory with an im2col loader:
// a thread always fills the same feature column of both operand tiles, so
// its (tap, channel) decomposition is computed once per block, and it walks
// its 4 rows (bb, tt) incrementally, without a division in the loop.  Every
// edge is masked (any ch, any taps, stride, ragged t_out and d), so nothing
// is padded or copied.  Narrow factors split the rows of P over grid z as
// factor_update does (conv1 of whisper-small: d = 241, 16 tiles) and sum
// the partials in a fixed order (sum_partials_kernel).  alpha and beta are
// read from a 2-float device buffer.
//
// Bound: 2 n d^2 fp32 operations for n = b t_out rows and d = taps ch +
// has_bias (127.5 GFLOP for whisper-small's conv2, 1.90 ms at the 67 TFLOP/s
// fp32 rate); x is read once (74 MB, 0.022 ms at 3.35 TB/s).  P^T P is
// symmetric, so a kernel that computes one triangle and mirrors it would
// halve the operations; that is later work, as for factor_update.
#include "gemm_tile.cuh"

namespace {

using repro_torch::kBK;
using repro_torch::kBM;
using repro_torch::kBN;
using repro_torch::kThreads;
using repro_torch::kTM;
using repro_torch::kTN;

struct Geometry {
  const float* x;  // (b, t, ch) row-major
  int t, ch, taps, stride, lo, t_out, d, has_bias;
};

// What feature f of a patch row holds: x at time offset `off` from
// tt * stride and channel `c` (kind 0), the constant 1 (kind 1) or nothing
// (kind 2, f >= d).
struct Feature {
  int off, c, kind;
};

__device__ __forceinline__ Feature feature_of(const Geometry& g, int f) {
  const int core = g.taps * g.ch;
  if (f < core) return {f / g.ch - g.lo, f % g.ch, 0};
  if (g.has_bias && f == core) return {0, 0, 1};
  return {0, 0, 2};
}

__device__ __forceinline__ float fetch(const Geometry& g, const Feature& ft,
                                       int bb, int tt, bool row_ok) {
  if (!row_ok || ft.kind == 2) return 0.f;
  if (ft.kind == 1) return 1.f;
  const int src = tt * g.stride + ft.off;
  if (src < 0 || src >= g.t) return 0.f;
  return __ldg(g.x + (static_cast<long long>(bb) * g.t + src) * g.ch + ft.c);
}

// Block (bx, by, z): output tile (by, bx) summed over rows
// [z * chunk, min((z + 1) * chunk, rows)).  With ab the epilogue is
// ab[0] * acc + ab[1] * c; without, the raw partial sum goes to o[z].
__global__ void __launch_bounds__(kThreads)
patch_factor_kernel(Geometry g, int rows, int chunk,
                    const float* __restrict__ c, float* __restrict__ o,
                    const float* __restrict__ ab) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int z = blockIdx.z;
  const int r_begin = z * chunk;
  const int r_end = min(rows, r_begin + chunk);
  o += static_cast<long long>(z) * g.d * g.d;

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // the shared tile loads of gemm_tile.cuh (XTX layout): element
  // idx = tid + r * 256 of a 64 x 16 slice is (feature idx % 64, row
  // idx / 64), so this thread always fills feature column tid % 64 of both
  // tiles, at rows tid / 64 + 4 i of each slice
  const int lane = tid % kBM;
  const int k_lane = tid / kBM;
  const Feature fa = feature_of(g, row0 + lane);
  const Feature fb = feature_of(g, col0 + lane);
  constexpr int kRows = (kBM * kBK) / kThreads;  // 4
  int bb[kRows], tt[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r_begin + k_lane + (kThreads / kBM) * i;
    bb[i] = r / g.t_out;
    tt[i] = r % g.t_out;
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = r_begin; k0 < r_end; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int k = k_lane + (kThreads / kBM) * i;
      const bool ok = k0 + k < r_end;
      As[k][lane] = fetch(g, fa, bb[i], tt[i], ok);
      Bs[k][lane] = fetch(g, fb, bb[i], tt[i], ok);
      tt[i] += kBK;  // the same row of the next slice
      while (tt[i] >= g.t_out) {
        tt[i] -= g.t_out;
        ++bb[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * kTM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kTN]);
      const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float alpha = 1.f, beta = 0.f;
  if (ab != nullptr) {
    alpha = ab[0];
    beta = ab[1];
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = row0 + ty * kTM + i;
    if (gm >= g.d) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = col0 + tx * kTN + j;
      if (gn >= g.d) continue;
      const long long idx = static_cast<long long>(gm) * g.d + gn;
      float v = alpha * acc[i][j];
      if (ab != nullptr) v = fmaf(beta, c[idx], v);
      o[idx] = v;
    }
  }
}

// out = ab[0] * sum_z ws[z] + ab[1] * c over the dd entries, the z-sum in a
// fixed order, so the result does not depend on scheduling.
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

extern "C" int repro_patch_factor_f32(const float* x, const float* c,
                                      float* out, float* ws, int b, int t,
                                      int ch, int taps, int stride, int lo,
                                      int t_out, int has_bias, int splits,
                                      const float* ab, void* stream) {
  // no output positions (t < taps, VALID): no rows, and out = beta * c
  const int rows = b * t_out;
  const Geometry g{x, t, ch, taps, stride, lo, rows > 0 ? t_out : 1,
                   taps * ch + (has_bias ? 1 : 0), has_bias ? 1 : 0};
  if (g.d <= 0) return 0;
  const int tiles = (g.d + kBM - 1) / kBM;
  const auto s = static_cast<cudaStream_t>(stream);
  if (splits <= 1) {
    patch_factor_kernel<<<dim3(tiles, tiles, 1), kThreads, 0, s>>>(
        g, rows, rows, c, out, ab);
    return static_cast<int>(cudaGetLastError());
  }
  // chunk rows, a multiple of the K slice; the last chunk may be short
  const int per = (rows + splits - 1) / splits;
  const int chunk = (per + kBK - 1) / kBK * kBK;
  const int used = (rows + chunk - 1) / chunk;
  patch_factor_kernel<<<dim3(tiles, tiles, used), kThreads, 0, s>>>(
      g, rows, chunk, nullptr, ws, nullptr);
  const int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  const long long dd = static_cast<long long>(g.d) * g.d;
  const int threads = 256;
  sum_partials_kernel<<<static_cast<unsigned>((dd + threads - 1) / threads),
                        threads, 0, s>>>(ws, used, dd, c, ab, out);
  return static_cast<int>(cudaGetLastError());
}
