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
// constant 1.
//
// The TPU kernel walked tap pairs on its grid with a VMEM halo and needed
// ch <= 128, ch % 8 == 0 and a tiling t_out.  Here the product runs on the
// pipelined main loop of gemm_pipeline.cuh (128 x 128 or 64 x 64 tiles,
// 8 x 8 or 4 x 4 register patches, a cp.async ring of K slices) with an
// im2col loader: both operand tiles are k-major as they lie in x (a row of
// P is ch contiguous channels per tap), so a thread copies its row's
// features 16 bytes at a time straight from x when ch % 4 == 0 and x is
// 16-byte aligned (a 4-float chunk then never straddles a tap), else 4
// bytes at a time.  A per-block table in shared memory maps each of the
// tile's features to its (tap, channel), and each thread advances its one
// row (bb, tt) without a division.  Zero padding, stride, ragged t_out
// and d are masked copies (zero fill), so nothing is padded or copied.
//
// P^T P is symmetric: only the tiles (i, j) with i <= j are launched, and an
// off-diagonal tile writes its entries and their transposes, each with its
// own c entry (c need not be symmetric).  When the core features taps * ch
// fill whole tiles (whisper-small's conv2, 2304 = 18 * 128), the bias
// feature would be a tile one feature wide; instead the blocks of the last
// tile column also sum their staged A columns (the loader's staged hook),
// which is the bias column sum_r P[r][f], and the last diagonal block writes
// the corner, the row count.  Narrow factors (conv1, d = 241: 3 triangle
// tiles) split the rows of P over grid z; each split writes its partial
// tiles and their mirrors, and sum_partials_kernel adds them in a fixed
// order.  The host plan (kernels/gemm_plan.py) picks the tile, the split
// and the copy width.  alpha and beta are read from a 2-float device buffer.
//
// Bound: one triangle, n d (d + 1) fp32 operations for n = b t_out rows and
// d = taps ch + has_bias (63.8 GFLOP for whisper-small's conv2, 0.95 ms at
// the 67 TFLOP/s fp32 rate); x is read once (74 MB, 0.022 ms at 3.35 TB/s).
// The diagonal tiles compute both of their halves.
#include "gemm_pipeline.cuh"
#include "sum_partials.cuh"

namespace {

namespace pipe = repro_torch::pipe;

struct Geometry {
  const float* x;  // (b, t, ch) row-major
  int t, ch, taps, stride, lo, t_out, d, has_bias;
};

// feature table entries {time offset k - lo, channel}; channel kBiasFeature
// is the constant 1, kNoFeature lies beyond d
constexpr int kBiasFeature = -1;
constexpr int kNoFeature = -2;

template <int BM, bool VEC>
struct Im2colLoader {
  using T = pipe::Tile<BM, BM>;
  Geometry g;
  const int2* feat;  // [BM] features of the A tile, then [BM] of the B tile
  int r, r_end;      // this thread's row of the next slice; the chunk's end
  int rb, tt;        // that row's bb * t and tt
  bool fold;         // sum the staged A columns (the bias column)
  float bias_sum;    // thread tid < BM: sum of A column tid so far

  __device__ __forceinline__ void fill(float* dst, int2 ft, bool row_ok) {
    if (ft.y >= 0) {
      const int u = tt * g.stride + ft.x;
      const bool ok = row_ok && u >= 0 && u < g.t;
      const float* src =
          ok ? g.x + static_cast<long long>(rb + u) * g.ch + ft.y : g.x;
      if constexpr (VEC)
        pipe::cp_async16(dst, src, ok);
      else
        pipe::cp_async4(dst, src, ok);
    } else {
      const float v = ft.y == kBiasFeature && row_ok ? 1.f : 0.f;
      if constexpr (VEC)
        *reinterpret_cast<float4*>(dst) = make_float4(v, 0.f, 0.f, 0.f);
      else
        *dst = v;
    }
  }

  // kRowThreads threads fill each row of the slice, thread tid row
  // tid / kRowThreads: chunks of 4 features (VEC) or single features, every
  // kRowThreads-th of the tile's
  static constexpr int kRowThreads = pipe::kThreads / pipe::kBK;

  __device__ __forceinline__ void load(float* stage, int /*slice*/) {
    const int row = threadIdx.x / kRowThreads, q = threadIdx.x % kRowThreads;
    const bool row_ok = r < r_end;
    float* As = stage + row * T::kLdA;
    float* Bs = stage + pipe::kBK * T::kLdA + row * T::kLdB;
    constexpr int kStep = VEC ? 4 : 1;
#pragma unroll
    for (int h = 0; h < BM / (kRowThreads * kStep); ++h) {
      const int f = kStep * (q + kRowThreads * h);
      fill(As + f, feat[f], row_ok);
      fill(Bs + f, feat[BM + f], row_ok);
    }
    r += pipe::kBK;  // this thread's row of the next slice
    tt += pipe::kBK;
    while (tt >= g.t_out) {
      tt -= g.t_out;
      rb += g.t;
    }
  }

  __device__ __forceinline__ void staged(const float* As) {
    if (fold && threadIdx.x < BM) {
#pragma unroll
      for (int kk = 0; kk < pipe::kBK; ++kk)
        bias_sum += As[kk * T::kLdA + threadIdx.x];
    }
  }
};

// Block (x, 0, z): triangle tile x, (i, j) with i <= j in row-major order,
// summed over rows [z * chunk, min((z + 1) * chunk, rows)).  PARTIAL: the
// raw sums (and mirrors) go to o[z]; else o = ab[0] * acc + ab[1] * c.
template <int BM, bool VEC, bool PARTIAL>
__global__ void __launch_bounds__(pipe::kThreads, 2)
patch_factor_kernel(Geometry g, int tiles, int fold, int rows, int chunk,
                    const float* __restrict__ c, float* __restrict__ o,
                    const float* __restrict__ ab) {
  extern __shared__ float4 smem4[];
  using T = pipe::Tile<BM, BM>;
  float* smem = reinterpret_cast<float*>(smem4);
  int2* feat = reinterpret_cast<int2*>(smem + pipe::kStages *
                                                  T::kStageFloats);
  int i = 0, rem = blockIdx.x;
  while (rem >= tiles - i) {
    rem -= tiles - i;
    ++i;
  }
  const int j = i + rem;
  const int z = blockIdx.z;
  const int r_begin = z * chunk, r_end = min(rows, r_begin + chunk);
  if (PARTIAL) o += static_cast<long long>(z) * g.d * g.d;

  const int core = g.taps * g.ch;
  for (int idx = threadIdx.x; idx < 2 * BM; idx += pipe::kThreads) {
    const int f = (idx < BM ? i * BM : j * BM - BM) + idx;
    int2 v = make_int2(0, kNoFeature);
    if (f < core)
      v = make_int2(f / g.ch - g.lo, f % g.ch);
    else if (g.has_bias && f == core)
      v = make_int2(0, kBiasFeature);
    feat[idx] = v;
  }
  __syncthreads();

  const int r0 =
      r_begin + threadIdx.x / Im2colLoader<BM, VEC>::kRowThreads;
  Im2colLoader<BM, VEC> ld{g, feat, r0, r_end, (r0 / g.t_out) * g.t,
                           r0 % g.t_out, fold != 0 && j == tiles - 1, 0.f};
  float acc[T::kTM][T::kTN] = {};
  const int slices = max(0, r_end - r_begin + pipe::kBK - 1) / pipe::kBK;
  pipe::mainloop<BM, BM>(ld, smem, slices, acc);

  float alpha = 1.f, beta = 0.f;
  if (!PARTIAL) {
    alpha = ab[0];
    beta = ab[1];
  }
  pipe::store_tile<PARTIAL ? pipe::kStore : pipe::kAxpby, BM, BM>(
      acc, o, c, g.d, g.d, g.d, i * BM, j * BM, alpha, beta, i != j);
  if (ld.fold && threadIdx.x < BM) {
    // the bias column (m, d - 1), its mirror (d - 1, m) and the corner
    const long long last = g.d - 1;
    const long long m = i * BM + threadIdx.x;
    const long long e = m * g.d + last, t = last * g.d + m;
    const float n_rows = static_cast<float>(max(0, r_end - r_begin));
    o[e] = PARTIAL ? ld.bias_sum : fmaf(beta, c[e], alpha * ld.bias_sum);
    o[t] = PARTIAL ? ld.bias_sum : fmaf(beta, c[t], alpha * ld.bias_sum);
    if (i == j && threadIdx.x == 0) {
      const long long cc = last * g.d + last;
      o[cc] = PARTIAL ? n_rows : fmaf(beta, c[cc], alpha * n_rows);
    }
  }
}

template <int BM, bool VEC, bool PARTIAL>
int launch(const Geometry& g, int tiles, int fold, int rows, int chunk,
           int splits, const float* c, float* o, const float* ab,
           cudaStream_t stream) {
  constexpr int smem = pipe::Tile<BM, BM>::kSmemBytes +
                       2 * BM * static_cast<int>(sizeof(int2));
  static const int allowed =
      pipe::allow_smem(patch_factor_kernel<BM, VEC, PARTIAL>, smem);
  if (allowed != 0) return allowed;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, splits);
  patch_factor_kernel<BM, VEC, PARTIAL>
      <<<grid, pipe::kThreads, smem, stream>>>(
          g, tiles, fold, rows, chunk, c, o, ab);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool VEC>
int launch_tile(const Geometry& g, int tiles, int fold, int rows, int chunk,
                int splits, const float* c, float* out, float* ws,
                const float* ab, cudaStream_t stream) {
  if (splits <= 1)
    return launch<BM, VEC, false>(g, tiles, fold, rows, chunk, 1, c, out, ab,
                                  stream);
  const int status = launch<BM, VEC, true>(g, tiles, fold, rows, chunk,
                                           splits, nullptr, ws, nullptr,
                                           stream);
  if (status != 0) return status;
  const long long dd = static_cast<long long>(g.d) * g.d;
  return sum_partials(ws, splits, dd, dd, c, 0, ab, 0.f, 0.f, out, stream);
}

}  // namespace

// tile (128 or 64), tiles (triangle side: taps * ch / tile with fold, else
// ceil(d / tile)), fold (the bias border from the last tile column's
// staged sums), chunk (rows of P a block sums, a multiple of 16) and
// splits (row chunks; > 1 sums partials in ws, (splits, d, d)) come from
// the host plan; vec: 16-byte copies from x (ch % 4 == 0, x 16-byte
// aligned).
extern "C" int repro_patch_factor_f32(const float* x, const float* c,
                                      float* out, float* ws, int b, int t,
                                      int ch, int taps, int stride, int lo,
                                      int t_out, int has_bias, int tile,
                                      int tiles, int fold, int chunk,
                                      int splits, int vec, const float* ab,
                                      void* stream) {
  // no output positions (t < taps, VALID): no rows, and out = beta * c
  const int rows = b * t_out;
  const Geometry g{x, t, ch, taps, stride, lo, rows > 0 ? t_out : 1,
                   taps * ch + (has_bias ? 1 : 0), has_bias ? 1 : 0};
  if (g.d <= 0) return 0;
  if ((tile != 64 && tile != 128) || tiles <= 0 || chunk <= 0 ||
      chunk % pipe::kBK != 0 || splits <= 0 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile == 128)
    return vec ? launch_tile<128, true>(g, tiles, fold, rows, chunk, splits,
                                        c, out, ws, ab, s)
               : launch_tile<128, false>(g, tiles, fold, rows, chunk, splits,
                                         c, out, ws, ab, s);
  return vec ? launch_tile<64, true>(g, tiles, fold, rows, chunk, splits, c,
                                     out, ws, ab, s)
             : launch_tile<64, false>(g, tiles, fold, rows, chunk, splits, c,
                                      out, ws, ab, s);
}
