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
// What the design does about the card:
//
// - An asynchronous K/V ring.  Tiles of 64 keys at every head dim; K and V
//   are staged apart, one buffer each, by 16-byte cp.async copies
//   (gemm_pipeline.cuh's pipe::cp_async16, zero fill for keys >= Tk from a
//   clamped address).  V of tile t is copied while S = Q K^T of tile t is
//   multiplied and its softmax taken; K of tile t + 1 is copied while
//   O += P V of tile t is.  Two barriers a tile: one when K has landed
//   (which also frees V and P of the tile before), one when V has landed
//   and P is written (which also frees K).
// - The register patch.  Each thread holds four rows of the block's 64
//   and, of each, the keys tx + 16 j (j < 4) of the tile (tx = tid % 16),
//   so a row's 64 scores lie in the 16 lanes of one half-warp: its max is
//   four shuffles, and the row sum l is kept per lane and added over the
//   lanes once, at the end.  Below hd 128, thread (ty, tx) = (tid / 16,
//   tid % 16) scores rows ty + 16 i over all dims: eight float4 shared-
//   memory reads for 64 FMAs a step of four dims (the older 32-key tile at
//   hd 256 read six for 32).  At hd 128 and 256, where one block an SM
//   leaves up to 255 registers a thread, warp w scores rows 8w..8w+7 and
//   each lane a patch of 8 rows x 8 keys over a quarter of the dims (d / 4
//   = lane / 8 mod 4): sixteen reads for 256 FMAs; the four partial sums
//   of a score then meet in two exchanges of halves by shuffles (lanes
//   ^ 16 swap rows, ^ 8 keys), in one fixed order, which leaves the lane
//   rows 8w + 2 i + lane / 16.  On an NVIDIA H100 80GB HBM3 at 700 W
//   (tools/attention_ab.py) this layout was 6.5% faster at hd 256 and, at
//   hd 64, where it needs one block an SM, 13% slower.  O is accumulated for
//   the thread's own four rows over hd / 16 of the columns, so the online
//   softmax's rescale stays in the thread.  P goes through shared memory
//   (a float4 read serves four keys of a row in O += P V; shuffling it
//   within the half-warp instead was 2-5% slower at both head dims).
// - Cheaper softmax arithmetic.  log2(e) is folded into the scale (and
//   into cap), so every exponential is exp2f; the causal / window / Tk
//   mask is applied only on the tiles that cross the diagonal, the
//   window's edge or Tk (a tile wholly inside every row's visible keys
//   skips it).  tanhf stays the IEEE version (tanh.approx's ~2^-11 would
//   not meet the 1e-5 tolerance).
// - The grid.  One dimension, the query tile slowest and longest first:
//   the causal tiles' work grows with their index, so the longest of every
//   (row, KV head) go out first and the short ones fill the tail.
//
// Shared memory a block: Q [64][hd + 4], K [64][hd + 4], V [64][hd],
// P [64][80] floats: 219,136 B at hd 256 and 120,832 B at hd 128 (one block
// an SM; 254 and 210 registers), 71,680 B at hd 64 (two blocks, registers
// capped at 128), 45,056 and 31,744 B at hd 32 and 16 (NVIDIA H100 80GB
// HBM3, 700 W, CUDA 12.8).  All arithmetic is fp32 FMA on the CUDA cores;
// no TF32, no fast math.
#include <cuda_runtime.h>

#include <climits>

#include "gemm_pipeline.cuh"

namespace {

using repro_torch::pipe::cp_async16;
using repro_torch::pipe::cp_async_commit;
using repro_torch::pipe::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kRows = 64;        // (query, head) rows a block holds
constexpr int kRowsPerThread = 4;
constexpr int kKeys = 64;        // keys a tile holds
constexpr int kKeyGroups = kKeys / 16;   // keys a thread scores
constexpr int kPLd = kKeys + 16;         // padded P rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // element strides of a (B, H, T, hd) view, unit along hd
  long long b, h, t;
};

template <int HD>
struct Tile {
  static constexpr int kVec = HD >= 64 ? 4 : HD / 16;
  static constexpr int kCols = HD / (16 * kVec);    // column groups of O
  static constexpr int kQkLd = HD + 4;              // padded Q / K rows
  static constexpr int kQuads = HD / 4;             // 16-byte pieces a row
  static constexpr int kFloats =
      kRows * kQkLd + kKeys * kQkLd + kKeys * HD + kRows * kPLd;
  // hd 128 and 256 hold one block an SM by shared memory, so ptxas may
  // spend up to 255 registers a thread (64 accumulators at hd 256); below,
  // two blocks an SM cap it at 128
  static constexpr int kMinBlocks = HD >= 128 ? 1 : 2;
  // with registers to spare, QK^T splits the dims over four lanes (below)
  static constexpr bool kSplit = HD >= 128;
};

// Block row of the thread's row i (of 4); its keys are tx + 16 j (j < 4),
// tx = tid % 16, on either layout.
template <int HD>
__device__ __forceinline__ int row_of(int i) {
  const int tid = threadIdx.x;
  if constexpr (Tile<HD>::kSplit)
    return 8 * (tid >> 5) + 2 * i + ((tid >> 4) & 1);
  else
    return (tid >> 4) + 16 * i;
}

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

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copies of keys [k0, k0 + kKeys) of a K or V row into dst ([kKeys][ld]);
// keys >= tk are zero-filled, so their P (0) never meets a stale value.
template <int HD>
__device__ __forceinline__ void copy_keys(float* dst, int ld,
                                          const float* src, long long st,
                                          int k0, int tk) {
  constexpr int kQuads = Tile<HD>::kQuads;
  for (int idx = threadIdx.x; idx < kKeys * kQuads; idx += kThreads) {
    const int kk = idx / kQuads, d = (idx - kk * kQuads) * 4;
    const int j = k0 + kk;
    cp_async16(dst + kk * ld + d, src + min(j, tk - 1) * st + d, j < tk);
  }
  cp_async_commit();
}

// in_scale, out_scale: the score is out_scale * tanh(in_scale * q.k) with a
// softcap and in_scale * q.k without, in log2 units (exp2 of it is e^s).
template <int HD>
__global__ void __launch_bounds__(kThreads, Tile<HD>::kMinBlocks)
    attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     Strides qs, Strides ks, Strides os, int hkv, int group,
                     int tq, int tk, int n_tiles, int causal, int window,
                     float cap, float in_scale, float out_scale) {
  using T = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* qsm = reinterpret_cast<float*>(smem4);  // [kRows][kQkLd]
  float* ksm = qsm + kRows * T::kQkLd;           // [kKeys][kQkLd]
  float* vsm = ksm + kKeys * T::kQkLd;           // [kKeys][HD]
  float* psm = vsm + kKeys * HD;                 // [kRows][kPLd]

  const int tid = threadIdx.x, tx = tid & 15;
  const int bq = kRows / group;                  // queries a tile holds
  // the query tile varies slowest, longest first
  const int pairs = gridDim.x / n_tiles;         // B * Hkv
  const int pair = blockIdx.x % pairs;
  const int tile = n_tiles - 1 - blockIdx.x / pairs;
  const int h = pair % hkv, b = pair / hkv;
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
    const int r = row_of<HD>(i);
    qrow[i] = q0 + r / group;
    rvalid[i] = r < group * bq && qrow[i] < tq;
  }

  // the keys some row of the tile can see
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(tk, q_last + 1) : tk;

  // the first group in flight: Q (padding rows zero-filled) and K of the
  // first tile
  for (int idx = tid; idx < kRows * T::kQuads; idx += kThreads) {
    const int r = idx / T::kQuads, d = (idx - r * T::kQuads) * 4;
    const int qi = q0 + r / group, g = r - (r / group) * group;
    const bool ok = r < group * bq && qi < tq;
    cp_async16(qsm + r * T::kQkLd + d, ok ? qb + g * qs.h + qi * qs.t + d : q,
               ok);
  }
  if (lo < hi)
    copy_keys<HD>(ksm, T::kQkLd, kb, ks.t, lo, tk);
  else
    cp_async_commit();

  float acc[kRowsPerThread][T::kCols][T::kVec], m[kRowsPerThread],
      l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;   // this lane's part of the row sum
#pragma unroll
    for (int c = 0; c < T::kCols; ++c)
#pragma unroll
      for (int e = 0; e < T::kVec; ++e) acc[i][c][e] = 0.f;
  }
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int k0 = lo; k0 < hi; k0 += kKeys) {
    cp_async_wait<0>();   // K of this tile (and Q, the first time)
    __syncthreads();      // ... for every thread; V and P are free
    copy_keys<HD>(vsm, HD, vb, ks.t, k0, tk);

    // S = Q K^T for the thread's rows row_of(i) and keys tx + 16 j
    float s[kRowsPerThread][kKeyGroups];
    if constexpr (T::kSplit) {
      // lane (kx, dg) = (lane % 8, lane / 8): rows 8w + r (r < 8) x keys
      // kx + 8 j (j < 8) over the dims d with d / 4 = dg (mod 4)
      const int lane = tid & 31, kx = lane & 7, dg = lane >> 3;
      const bool hi_row = lane & 16, hi_key = lane & 8;
      const float* qw = qsm + 8 * (tid >> 5) * T::kQkLd + 4 * dg;
      const float* kw = ksm + kx * T::kQkLd + 4 * dg;
      float sp[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) sp[r][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 16) {
        float4 qv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          qv[r] = *reinterpret_cast<const float4*>(qw + r * T::kQkLd + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kw + 8 * j * T::kQkLd + d);
#pragma unroll
          for (int r = 0; r < 8; ++r) sp[r][j] = dot4(qv[r], kv, sp[r][j]);
        }
      }
      float s1[kRowsPerThread][8];   // rows 2 i + hi_row
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float lo = sp[2 * i][j], hi = sp[2 * i + 1][j];
          s1[i][j] = (hi_row ? hi : lo) +
                     __shfl_xor_sync(kFull, hi_row ? lo : hi, 16);
        }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeyGroups; ++j) {   // keys kx + 8 (2 j + hi_key)
          const float lo = s1[i][2 * j], hi = s1[i][2 * j + 1];
          s[i][j] = (hi_key ? hi : lo) +
                    __shfl_xor_sync(kFull, hi_key ? lo : hi, 8);
        }
    } else {
      // thread (ty, tx) = (tid / 16, tid % 16): rows ty + 16 i, eight
      // float4 reads for 64 FMAs a step of four dims
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeyGroups; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[kRowsPerThread], kv[kKeyGroups];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              qsm + row_of<HD>(i) * T::kQkLd + d);
#pragma unroll
        for (int j = 0; j < kKeyGroups; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              ksm + (tx + 16 * j) * T::kQkLd + d);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kKeyGroups; ++j)
            s[i][j] = dot4(qv[i], kv[j], s[i][j]);
      }
    }

    // does some (row, key) pair of the tile fall outside the visible keys?
    const bool edge = k0 + kKeys > tk || (causal && k0 + kKeys - 1 > q0) ||
                      (window > 0 && q_last - k0 >= window);
    // online softmax in log2 units; masked scores are -inf, so their p is
    // exactly 0
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < kKeyGroups; ++j) {
        float x = cap > 0.f ? out_scale * tanhf(s[i][j] * in_scale)
                            : s[i][j] * in_scale;
        if (edge) {
          const int key = k0 + tx + 16 * j;
          const bool ok = key < tk && (!causal || key <= qrow[i]) &&
                          (window <= 0 || qrow[i] - key < window);
          x = ok ? x : neg_inf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(m[i], mx);   // finite: m starts at -1e30
      const float corr = exp2f(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyGroups; ++j) {
        s[i][j] = exp2f(s[i][j] - mn);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < T::kCols; ++c)
#pragma unroll
        for (int e = 0; e < T::kVec; ++e) acc[i][c][e] *= corr;
#pragma unroll
      for (int j = 0; j < kKeyGroups; ++j)
        psm[row_of<HD>(i) * kPLd + tx + 16 * j] = s[i][j];
    }
    cp_async_wait<0>();   // V of this tile
    __syncthreads();      // ... and P, for every thread; K is free
    if (k0 + kKeys < hi) copy_keys<HD>(ksm, T::kQkLd, kb, ks.t, k0 + kKeys, tk);

    // O += P V for rows row_of(i), columns c * 16 * kVec + tx * kVec + e
#pragma unroll 2
    for (int kk = 0; kk < kKeys; kk += 4) {
      float p[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        Vec<4>::load(psm + row_of<HD>(i) * kPLd + kk, p[i]);
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
  }
  cp_async_wait<0>();   // Q alone is in flight when no tile ran

  // the row sums over the 16 lanes of the row; every row with a valid key
  // saw the largest of its scores, so l >= 1
  int empty = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) l[i] += __shfl_xor_sync(kFull, l[i], o);
    if (!rvalid[i]) continue;
    if (l[i] == 0.f) {
      empty = 1;
      continue;
    }
    const int r = row_of<HD>(i);
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
      const int r = row_of<HD>(i);
      float* o = out + b * os.b + (static_cast<long long>(h) * group +
                                   r % group) * os.h + qrow[i] * os.t;
      for (int d = tx; d < HD; d += 16) o[d] = mean[d];
    }
  }
}

template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * Tile<HD>::kFloats;
}

// once per instantiation and process, outside any graph capture (the
// first call); the attribute is the current device's, and a process of the
// port drives one card
template <int HD>
int allow_smem() {
  static const int status = repro_torch::pipe::allow_smem(
      attention_kernel<HD>, smem_bytes<HD>());
  return status;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int b,
           int hq, int hkv, int tq, int tk, Strides qs, Strides ks,
           Strides os, int causal, int window, float cap, float scale,
           cudaStream_t stream) {
  if (const int status = allow_smem<HD>()) return status;
  const int group = hq / hkv;
  const int bq = kRows / group;
  const int n_tiles = (tq + bq - 1) / bq;
  const long long blocks = static_cast<long long>(n_tiles) * hkv * b;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const float in_scale = cap > 0.f ? scale / cap : scale * kLog2e;
  const float out_scale = cap * kLog2e;
  attention_kernel<HD><<<static_cast<unsigned>(blocks), kThreads,
                         smem_bytes<HD>(), stream>>>(
      q, k, v, out, qs, ks, os, hkv, group, tq, tk, n_tiles, causal, window,
      cap, in_scale, out_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int blocks_per_sm(int* blocks) {
  if (const int status = allow_smem<HD>()) return status;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attention_kernel<HD>, kThreads, smem_bytes<HD>()));
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

// Blocks of attention_kernel<hd> an SM holds on the current device (the
// occupancy calculator's count for its registers and shared memory).
extern "C" int repro_flash_attention_blocks_per_sm(int hd, int* blocks) {
  switch (hd) {
    case 16: return blocks_per_sm<16>(blocks);
    case 32: return blocks_per_sm<32>(blocks);
    case 64: return blocks_per_sm<64>(blocks);
    case 128: return blocks_per_sm<128>(blocks);
    case 256: return blocks_per_sm<256>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
