// out[b] = ab[0] * x[b]^T x[b] + ab[1] * c[b] for x of shape ([batch,] n, d),
// c of shape ([batch,] d, d).
//
// Replaces the Pallas TPU kernel repro/kernels/factor_update.py::
// factor_update (the decayed Kronecker-factor accumulation of paper S5).
// alpha and beta are read from a 2-float device buffer: the decay
// eps = min(1 - 1/k, cap) is computed on the device every step, and reading
// it on the host would sync.
//
// Bound: x^T x is symmetric, so only its d (d + 1) / 2 distinct entries are
// needed, n d (d + 1) fp32 operations (8.2 GFLOP at n = 8192, d = 1001),
// against the 67 TFLOP/s fp32 rate; x is read once.  The product runs on
// the pipelined main loop of gemm_pipeline.cuh (128 x 128 or 64 x 64 tiles,
// 8 x 8 or 4 x 4 register patches, a cp.async ring of K slices) with a
// loader that stages both operand tiles, X[k0:k0+16, i T:(i+1) T] and
// X[k0:k0+16, j T:(j+1) T], as they lie in x: both are k-major already, so
// x^T is never formed and no copy transposes.  The copies are 16 bytes wide
// when d % 4 == 0 and x is 16-byte aligned (every row, and every batch
// slice, then starts on a 16-byte boundary), else 4 bytes; ragged d and n
// are masked copies (zero fill), so nothing is padded.
//
// Only the tiles (i, j) with i <= j are launched; an off-diagonal tile
// writes its entries and their transposes, each with its own c entry (c
// need not be symmetric), and a diagonal tile computes both of its halves.
// Three launch shapes, from the host plan (kernels/gemm_plan.py::
// triangle_plan):
// - one slice, the rows whole: grid (triangle, 1, 1), the axpby epilogue;
// - one slice, the rows split (narrow factors: one 128-tile at d = 30, 10
//   at d = 501, against 132 SMs and n = 8192): grid z over row chunks, each
//   writing its raw partial tiles and their mirrors into ws (splits, d, d),
//   then sum_partials_kernel adds them in a fixed order, so the result does
//   not depend on scheduling;
// - a batch (the LM's stacked layers, whisper-small's (12, 12000, 768)):
//   grid z over the slices, strides n d and d d, no split.
#include "gemm_pipeline.cuh"
#include "sum_partials.cuh"

namespace {

namespace pipe = repro_torch::pipe;

// Both tiles of slice k0 of x (rows of d floats): A from columns [ca,
// ca + BM), B from [cb, cb + BM), each stage row k = x row k0 + k as it
// lies.  Thread tid copies unit tid % kUnits of a row (4 floats with VEC,
// else 1) in rows tid / kUnits + kRowStep e, e < kPer, of both tiles; it
// keeps its two source pointers and advances them a slice at a time.
template <int BM, bool VEC>
struct XLoader {
  using T = pipe::Tile<BM, BM>;
  static constexpr int kWidth = VEC ? 4 : 1;             // floats a copy
  static constexpr int kUnits = BM / kWidth;             // copies a row
  static constexpr int kRowStep = pipe::kThreads / kUnits;
  static constexpr int kPer = pipe::kBK / kRowStep;      // rows a thread
  static_assert(pipe::kThreads % kUnits == 0 && kPer * kRowStep == pipe::kBK,
                "a slice is whole rows of copies");

  const float* x;  // the slice's x, a valid address for masked copies
  const float* a;  // this thread's A source in its first row of the slice
  const float* b;  // ... and its B source
  long long step;  // floats between this thread's rows: kRowStep * d
  int r, r_end;    // this thread's first row of the slice; the chunk's end
  bool a_ok, b_ok;  // the columns lie inside d

  __device__ __forceinline__ static void copy(float* dst, const float* src,
                                              bool ok) {
    if constexpr (VEC)
      pipe::cp_async16(dst, src, ok);
    else
      pipe::cp_async4(dst, src, ok);
  }

  __device__ __forceinline__ void load(float* stage, int /*slice*/) {
    const int row = threadIdx.x / kUnits;
    const int col = kWidth * (threadIdx.x % kUnits);
    float* As = stage + row * T::kLdA + col;
    float* Bs = stage + pipe::kBK * T::kLdA + row * T::kLdB + col;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const bool in = r + e * kRowStep < r_end;
      const long long off = e * step;
      copy(As + e * kRowStep * T::kLdA, in && a_ok ? a + off : x,
           in && a_ok);
      copy(Bs + e * kRowStep * T::kLdB, in && b_ok ? b + off : x,
           in && b_ok);
    }
    a += pipe::kBK / kRowStep * step;  // the same row of the next slice
    b += pipe::kBK / kRowStep * step;
    r += pipe::kBK;
  }

  __device__ __forceinline__ void staged(const float*) const {}
};

// Block (t, 0, z): triangle tile t, (i, j) with i <= j in row-major order.
// PARTIAL: rows [z chunk, min((z + 1) chunk, n)) of the one slice, the raw
// sums (and mirrors) into o[z]; else slice z, all n rows, o[z] = ab[0] acc
// + ab[1] c[z].
template <int BM, bool VEC, bool PARTIAL>
__global__ void __launch_bounds__(pipe::kThreads, 2)
factor_update_kernel(const float* __restrict__ x,
                     const float* __restrict__ c, float* __restrict__ o,
                     const float* __restrict__ ab, int n, int d, int tiles,
                     int chunk) {
  extern __shared__ float4 smem4[];
  using T = pipe::Tile<BM, BM>;
  using Loader = XLoader<BM, VEC>;
  float* smem = reinterpret_cast<float*>(smem4);
  int i = 0, rem = blockIdx.x;
  while (rem >= tiles - i) {
    rem -= tiles - i;
    ++i;
  }
  const int j = i + rem;
  const long long z = blockIdx.z;
  const long long dd = static_cast<long long>(d) * d;
  int r_begin = 0, r_end = n;
  if (PARTIAL) {
    r_begin = static_cast<int>(z) * chunk;
    r_end = min(n, r_begin + chunk);
  } else {
    x += z * n * d;
    c += z * dd;
  }
  o += z * dd;

  const int r0 = r_begin + threadIdx.x / Loader::kUnits;
  const int col = Loader::kWidth * (threadIdx.x % Loader::kUnits);
  const int ca = i * BM + col, cb = j * BM + col;
  const long long base = static_cast<long long>(r0) * d;
  Loader ld{x, x + base + ca, x + base + cb,
            static_cast<long long>(Loader::kRowStep) * d, r0, r_end,
            ca < d, cb < d};
  float acc[T::kTM][T::kTN] = {};
  const int slices = max(0, r_end - r_begin + pipe::kBK - 1) / pipe::kBK;
  pipe::mainloop<BM, BM>(ld, smem, slices, acc);

  float alpha = 1.f, beta = 0.f;
  if (!PARTIAL) {
    alpha = ab[0];
    beta = ab[1];
  }
  pipe::store_tile<PARTIAL ? pipe::kStore : pipe::kAxpby, BM, BM>(
      acc, o, c, d, d, d, i * BM, j * BM, alpha, beta, i != j);
}

template <int BM, bool VEC, bool PARTIAL>
int launch(const float* x, const float* c, float* o, const float* ab, int n,
           int d, int tiles, int chunk, int z, cudaStream_t stream) {
  constexpr int smem = pipe::Tile<BM, BM>::kSmemBytes;
  static const int allowed =
      pipe::allow_smem(factor_update_kernel<BM, VEC, PARTIAL>, smem);
  if (allowed != 0) return allowed;
  const dim3 grid(tiles * (tiles + 1) / 2, 1, z);
  factor_update_kernel<BM, VEC, PARTIAL>
      <<<grid, pipe::kThreads, smem, stream>>>(x, c, o, ab, n, d, tiles,
                                               chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool VEC>
int launch_tile(const float* x, const float* c, float* out, float* ws,
                int batch, int n, int d, int tiles, int chunk, int splits,
                const float* ab, cudaStream_t stream) {
  if (splits <= 1)
    return launch<BM, VEC, false>(x, c, out, ab, n, d, tiles, chunk, batch,
                                  stream);
  const int status = launch<BM, VEC, true>(x, nullptr, ws, nullptr, n, d,
                                           tiles, chunk, splits, stream);
  if (status != 0) return status;
  const long long dd = static_cast<long long>(d) * d;
  return sum_partials(ws, splits, dd, dd, c, 0, ab, 0.f, 0.f, out, stream);
}

}  // namespace

// tile (128 or 64), tiles (ceil(d / tile) a side), chunk (rows of x a block
// sums, a multiple of 16) and splits (row chunks; > 1 only for batch 1,
// partials summed in ws, (splits, d, d)) come from the host plan; vec:
// 16-byte copies (d % 4 == 0, x 16-byte aligned).
extern "C" int repro_factor_update_f32(const float* x, const float* c,
                                       float* out, float* ws, int batch,
                                       int n, int d, int tile, int tiles,
                                       int chunk, int splits, int vec,
                                       const float* ab, void* stream) {
  if (batch <= 0 || d <= 0) return 0;
  if ((tile != 64 && tile != 128) || tiles <= 0 ||
      static_cast<long long>(tiles - 1) * tile >= d ||
      static_cast<long long>(tiles) * tile < d || chunk <= 0 ||
      chunk % pipe::kBK != 0 || splits <= 0 || n < 0 ||
      static_cast<long long>(chunk) * splits < n ||
      (splits > 1 && (batch > 1 || ws == nullptr)) || (vec && d % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile == 128)
    return vec ? launch_tile<128, true>(x, c, out, ws, batch, n, d, tiles,
                                        chunk, splits, ab, s)
               : launch_tile<128, false>(x, c, out, ws, batch, n, d, tiles,
                                         chunk, splits, ab, s);
  return vec ? launch_tile<64, true>(x, c, out, ws, batch, n, d, tiles, chunk,
                                     splits, ab, s)
             : launch_tile<64, false>(x, c, out, ws, batch, n, d, tiles,
                                      chunk, splits, ab, s);
}
