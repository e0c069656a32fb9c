// Flash attention forward in float32: the serving prefill's attention (GQA,
// causal, a sliding window, a score softcap) over aligned positions.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (line 67).  For query i (position i) of head g of KV head
// h's group (Hq = G * Hkv) and the keys j < Tk (position j):
//   valid(i, j) = (i >= j if causal) && (i - j < window if window > 0)
//   s_ij        = cap * tanh(q_i.k_j * scale / cap)   (no softcap if cap == 0)
//   out_i       = softmax_j over the valid j of s_ij, applied to v_j
// A row with no valid key (a window with Tk < Tq) weighs all Tk keys
// equally, as the reference does (its masked scores are all -1e30): the
// mean of V.
//
// Bound: operations.  4 * hd * Hq * sum_i n_i for n_i valid keys of row i,
// against q, k, v and the output moved once: about hd * n / 2 operations a
// byte at the prefill's lengths, far above the card's fp32 ridge (~20).
// The design keeps the products in shared memory and registers, and reads
// each K/V tile once per group: one block per (row b, KV head h, tile of
// queries) holds all G query heads of the group, 64 (query, head) rows in
// all (Bq = 64 / G queries), the TPU grid's h // g index map.  The block
// walks only the key tiles a query of its tile can see (up to its last
// query when causal, from its first query - window + 1 with a window); the
// TPU kernel walks every block and masks, which gives the same function.
// 256 threads as a 16 x 16 grid (ty, tx): thread (ty, tx) scores rows
// ty + 16 i (i < 4) against keys tx + 16 j of the tile (Q and K in shared
// memory, float4 along hd), keeps an online softmax (m, l) for its four
// rows (reduced over the 16 lanes of the row with shuffles), writes P to
// shared memory, and accumulates O for the same four rows over hd / 16 of
// the columns in registers.  Tiles of 64 keys (32 at hd 256) are loaded
// synchronously; shared memory is 35-145 KB a block (the dynamic-size
// attribute is set once per instantiation).  expf and tanhf are the IEEE
// versions (no fast math).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // (query, head) rows a block holds
constexpr int kRowsPerThread = 4;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // element strides of a (B, H, T, hd) view, unit along hd
  long long b, h, t;
};

template <int HD>
struct Tile {
  static constexpr int kKeys = HD >= 256 ? 32 : 64;  // keys a tile holds
  static constexpr int kKeyGroups = kKeys / 16;     // keys a thread scores
  static constexpr int kVec = HD >= 64 ? 4 : HD / 16;
  static constexpr int kCols = HD / (16 * kVec);    // column groups of O
  static constexpr int kQkLd = HD + 4;              // padded Q / K rows
  static constexpr int kPLd = kKeys + 16;           // padded P rows
  static constexpr int kFloats =
      kRows * kQkLd + kKeys * kQkLd + kKeys * HD + kRows * kPLd;
};

template <int N>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* x) { x[0] = p[0]; }
  __device__ static void store(float* p, const float* x) { p[0] = x[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* x) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* x) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One block an SM at hd 128 and 256 (shared memory), so the minimum lets
// ptxas spend up to 255 registers a thread: at hd 256 a thread holds 64
// accumulators beside its scores and the float4 operands in flight.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     Strides qs, Strides ks, Strides os, int group, int tq,
                     int tk, int causal, int window, float cap, float scale) {
  using T = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* qsm = reinterpret_cast<float*>(smem4);  // [kRows][kQkLd]
  float* ksm = qsm + kRows * T::kQkLd;           // [kKeys][kQkLd]
  float* vsm = ksm + T::kKeys * T::kQkLd;        // [kKeys][HD]
  float* psm = vsm + T::kKeys * HD;              // [kRows][kPLd]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bq = kRows / group;                  // queries a tile holds
  const int tile = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * bq;
  const int q_last = min(q0 + bq, tq) - 1;
  const float* qb = q + b * qs.b + static_cast<long long>(h) * group * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * ks.b + h * ks.h;

  // row r of the block is query q0 + r / G of head h * G + r % G
  int qrow[kRowsPerThread];
  bool rvalid[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + 16 * i;
    qrow[i] = q0 + r / group;
    rvalid[i] = r < group * bq && qrow[i] < tq;
  }

  constexpr int kQuads = HD / 4;
  for (int idx = tid; idx < kRows * kQuads; idx += kThreads) {
    const int r = idx / kQuads, d = (idx - r * kQuads) * 4;
    const int qi = q0 + r / group, g = r - (r / group) * group;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < group * bq && qi < tq) x = load4(qb + g * qs.h + qi * qs.t + d);
    *reinterpret_cast<float4*>(qsm + r * T::kQkLd + d) = x;
  }

  float acc[kRowsPerThread][T::kCols][T::kVec], m[kRowsPerThread],
      l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < T::kCols; ++c)
#pragma unroll
      for (int e = 0; e < T::kVec; ++e) acc[i][c][e] = 0.f;
  }

  // the keys some row of the tile can see
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(tk, q_last + 1) : tk;
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int k0 = lo; k0 < hi; k0 += T::kKeys) {
    for (int idx = tid; idx < T::kKeys * kQuads; idx += kThreads) {
      const int kk = idx / kQuads, d = (idx - kk * kQuads) * 4;
      const int j = k0 + kk;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
      if (j < tk) {
        a = load4(kb + j * ks.t + d);
        c = load4(vb + j * ks.t + d);
      }
      *reinterpret_cast<float4*>(ksm + kk * T::kQkLd + d) = a;
      *reinterpret_cast<float4*>(vsm + kk * HD + d) = c;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, keys tx + 16 j
    float s[kRowsPerThread][T::kKeyGroups];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < T::kKeyGroups; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRowsPerThread], kv[T::kKeyGroups];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qsm + (ty + 16 * i) * T::kQkLd + d);
#pragma unroll
      for (int j = 0; j < T::kKeyGroups; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            ksm + (tx + 16 * j) * T::kQkLd + d);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < T::kKeyGroups; ++j)
          s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    // online softmax; masked scores are -inf, so their p is exactly 0
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < T::kKeyGroups; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool ok = rvalid[i] && key < tk &&
                        (!causal || key <= qrow[i]) &&
                        (window <= 0 || qrow[i] - key < window);
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        s[i][j] = ok ? x : neg_inf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(m[i], mx);   // finite: m starts at -1e30
      const float corr = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < T::kKeyGroups; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(kFull, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < T::kCols; ++c)
#pragma unroll
        for (int e = 0; e < T::kVec; ++e) acc[i][c][e] *= corr;
#pragma unroll
      for (int j = 0; j < T::kKeyGroups; ++j)
        psm[(ty + 16 * i) * T::kPLd + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // O += P V for rows ty + 16 i, columns c * 16 * kVec + tx * kVec + e
#pragma unroll 2
    for (int kk = 0; kk < T::kKeys; kk += 4) {
      float p[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        Vec<4>::load(psm + (ty + 16 * i) * T::kPLd + kk, p[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[T::kCols][T::kVec];
#pragma unroll
        for (int c = 0; c < T::kCols; ++c)
          Vec<T::kVec>::load(
              vsm + (kk + u) * HD + c * 16 * T::kVec + tx * T::kVec, vv[c]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int c = 0; c < T::kCols; ++c)
#pragma unroll
            for (int e = 0; e < T::kVec; ++e)
              acc[i][c][e] = fmaf(p[i][u], vv[c][e], acc[i][c][e]);
      }
    }
    __syncthreads();
  }

  // every row with a valid key saw the largest of its scores, so l >= 1
  int empty = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (!rvalid[i]) continue;
    if (l[i] == 0.f) {
      empty = 1;
      continue;
    }
    const int r = ty + 16 * i;
    float* o = out + b * os.b + (static_cast<long long>(h) * group +
                                 r % group) * os.h + qrow[i] * os.t;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) {
      float y[T::kVec];
#pragma unroll
      for (int e = 0; e < T::kVec; ++e) y[e] = acc[i][c][e] * inv;
      Vec<T::kVec>::store(o + c * 16 * T::kVec + tx * T::kVec, y);
    }
  }
  // rows with no valid key: the mean of V over all Tk keys
  if (__syncthreads_or(empty)) {
    float* mean = qsm;
    for (int d = tid; d < HD; d += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < tk; ++j) sum += vb[j * ks.t + d];
      mean[d] = sum / static_cast<float>(tk);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (!rvalid[i] || l[i] != 0.f) continue;
      const int r = ty + 16 * i;
      float* o = out + b * os.b + (static_cast<long long>(h) * group +
                                   r % group) * os.h + qrow[i] * os.t;
      for (int d = tx; d < HD; d += 16) o[d] = mean[d];
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int b,
           int hq, int hkv, int tq, int tk, Strides qs, Strides ks,
           Strides os, int causal, int window, float cap, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<HD>::kFloats;
  // once per instantiation and process, outside any graph capture (the
  // first call); the attribute is the current device's, and a process of
  // the port drives one card
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int group = hq / hkv;
  const int bq = kRows / group;
  const dim3 grid((tq + bq - 1) / bq, hkv, b);
  attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, qs, ks, os, group, tq, tk, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, Tq, hd), k and v: (B, Hkv, Tk, hd) with element strides
// (unit along hd; k and v alike), out: (B, Hq, Tq, hd) with its own.
extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int b,
    int hq, int hkv, int tq, int tk, int hd, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst,
    long long osb, long long osh, long long ost, int causal, int window,
    float cap, float scale, void* stream) {
  if (b == 0 || tq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, os{osb, osh, ost};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, out, b, hq, hkv, tq, tk, qs, ks, os, causal,
                        window, cap, scale, st);
    case 32:
      return launch<32>(q, k, v, out, b, hq, hkv, tq, tk, qs, ks, os, causal,
                        window, cap, scale, st);
    case 64:
      return launch<64>(q, k, v, out, b, hq, hkv, tq, tk, qs, ks, os, causal,
                        window, cap, scale, st);
    case 128:
      return launch<128>(q, k, v, out, b, hq, hkv, tq, tk, qs, ks, os,
                         causal, window, cap, scale, st);
    case 256:
      return launch<256>(q, k, v, out, b, hq, hkv, tq, tk, qs, ks, os,
                         causal, window, cap, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
