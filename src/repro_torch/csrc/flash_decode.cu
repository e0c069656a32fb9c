// Flash decode: one float32 query token per row against a bf16 KV cache,
// dense (through strides) or paged (through a page table read in the
// kernel).
//
// Replaces the Pallas TPU kernels repro/kernels/flash_decode.py::
// flash_decode and flash_decode_paged.  For row b and each query head g of
// KV head h's group (Hq = G * Hkv; G = 1..4 are built, the groups of the
// ported configs):
//   out = softmax_j(cap * tanh(q.k_j * scale / cap)) . v_j
// over the valid keys j in [max(0, len_b - window), len_b), clipped to the
// S positions the cache has (no window when window <= 0, no softcap when
// cap == 0).  A row with no valid key weighs every walked key equally
// (the reference's all -1e30 scores): the mean of V over all S positions.
//
// Bound: bytes.  Each call must read the K and V rows of the valid keys
// once, 2 * n * hd * 2 bytes per (row, KV head) for n valid keys, against
// 4 * n * G * hd operations: at most 2 * G operations a byte, far below the
// card's fp32 ridge.  Each K/V row is read once per group: a block holds
// all G query heads of its KV head (the TPU kernel's q-head block bh
// bought the same).
//
// Flash decoding, a split over the keys.  The grid is (n_split, Hkv, B):
// block (z, h, b) walks chunk z of row b's span [lo, hi), chunks of
// max(ceil(n / n_split), kMinChunk) keys, so a short row leaves its last
// chunks empty.  n_split comes from the host (kernels/flash_decode.py::
// decode_splits: B * Hkv against the SM count, S and the window, never the
// lengths, which stay on the device); each block finds its own bounds from
// lengths[b].  At n_split == 1 the block writes the output; otherwise it
// writes a partial (m, l, acc[hd]) per query head to a float32 workspace
// (an empty chunk writes m = -1e30, l = 0), and merge_kernel, a second
// launch on the same stream, combines the n_split partials of each (row,
// query head) in split order, so two calls give the same bits.
//
// In a block, four warps take turns over the chunk, a warp tile of up to
// 32 keys at a time.  In a warp, hd / 8 lanes share a key, each loading 16
// bytes (8 bf16) of its K and V rows, so a warp scores 256 / hd keys a
// pass, and each lane group starts the loads of up to U keys (8 for
// G <= 2, 4 for G = 3, 4) before it uses any.  The tile's scores are
// reduced across the lane group with shuffles, all U * G of them side by
// side; then one max and one rescale of (l, acc) per tile and query head,
// not one per key.  On the paged route the warp's lanes read the page-table
// entries of the tile's pages, one lane a page, and each key's page comes
// by shuffle.  Lane groups merge across the warp with shuffles, warps in
// shared memory.  bf16 is widened to float32 in registers.  The TPU
// kernels walked every block of the cache and masked; these visit only
// the valid keys, which gives the same function.  expf and tanhf are the
// IEEE versions (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 32;        // keys of a warp tile: one page a lane
// the shortest chunk a block walks: a few hundred keys outweigh a block's
// fixed cost (its q, its partial, the merge); kernels/flash_decode.py's
// MIN_CHUNK, which its split rule plans with, is this number
constexpr int kMinChunk = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Element offsets of the key rows of KV head `h` of batch row `b`.  A warp
// calls tile() once per tile [t0, t_end) and at() for each of its keys;
// every lane calls both (at() may shuffle).
struct DenseRows {  // k, v viewed as (B, Hkv, S, hd) with these strides
  long long sb, sh, ss;
  struct Tile {
    long long base;
  };
  __device__ Tile tile(int b, int h, int, int, int) const {
    return {b * sb + h * sh};
  }
  __device__ long long at(const Tile& t, int, int pos) const {
    return t.base + pos * ss;
  }
};

struct PagedRows {  // pools (num_pages, page, Hkv, hd), table (B, blocks)
  const int* table;
  int blocks, page, shift, hkv, hd;  // shift: log2(page), or -1
  struct Tile {
    int first, phys;
  };
  __device__ int block_of(int pos) const {
    return shift >= 0 ? pos >> shift : pos / page;
  }
  // lane i holds the physical page of the tile's i-th logical page: a
  // tile of <= 32 keys spans <= 32 pages, each read once (none for a
  // tile past the chunk, t_end <= t0)
  __device__ Tile tile(int b, int, int t0, int t_end, int lane) const {
    const int first = block_of(t0), blk = first + lane;
    return {first, t0 < t_end && blk <= block_of(t_end - 1)
                       ? __ldg(table + static_cast<long long>(b) * blocks +
                               blk)
                       : 0};
  }
  __device__ long long at(const Tile& t, int h, int pos) const {
    const int blk = block_of(pos);
    const int p = __shfl_sync(kFull, t.phys, blk - t.first);
    return static_cast<long long>(p) * (page * hkv * hd) +
           ((pos - blk * page) * hkv + h) * hd;
  }
};

__device__ __forceinline__ void widen(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Split z's partial for query-head row r (zr = z * rows + r): ws holds
// (n_split, rows) pairs (m, l), then acc as (n_split, rows, hd) at n_ml =
// 2 * n_split * rows.
__device__ __forceinline__ void put_partial(float* ws, long long zr,
                                            long long n_ml, int hd, int d,
                                            float m, float l, float a) {
  ws[n_ml + zr * hd + d] = a;
  if (d == 0) {
    ws[zr * 2] = m;
    ws[zr * 2 + 1] = l;
  }
}

// Three blocks an SM: G = 4 holds 4 * 8 q and 4 * 8 accumulator registers
// a lane beside four keys' K/V loads and their scores, G = 2 the same with
// eight keys; the bound lets ptxas use up to 168 registers.
template <int G, class Rows>
__global__ void __launch_bounds__(kThreads, 3)
    decode_kernel(const float* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  float* __restrict__ ws, Rows rows, int hq, int hd,
                  int s_len, int window, float cap, float scale,
                  int n_split) {
  // keys each lane group keeps in flight: their K/V loads take 8
  // registers a key beside 16 * G of q and acc
  constexpr int U = G <= 2 ? 8 : 4;
  extern __shared__ float smem[];  // [kWarps][G][hd + 2]: m, l, acc[hd]
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpk = hd >> 3;         // lanes per key
  const int kpw = 32 / lpk;        // keys per warp pass
  const int sub = lane / lpk;      // this lane group's key in the pass
  const int d0 = (lane - sub * lpk) * 8;
  const long long row0 = static_cast<long long>(b) * hq + h * G;
  const long long nrows = static_cast<long long>(gridDim.z) * hq;
  const long long n_ml = 2LL * n_split * nrows;

  const int len = lengths[b];
  int hi = min(len, s_len);
  int lo = window > 0 ? max(0, len - window) : 0;
  const bool uniform = hi <= lo;   // no valid key: equal weights
  if (uniform) {
    lo = 0;
    hi = s_len;
  }
  const int n = hi - lo;
  const int chunk = max((n + n_split - 1) / n_split, kMinChunk);
  const long long start = static_cast<long long>(z) * chunk;
  // an empty chunk's partial weighs nothing in the merge (with one split
  // the chunk holds the whole span)
  if (start >= n && n_split > 1) {
    for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
      const int g = idx / hd;
      put_partial(ws, z * nrows + row0 + g, n_ml, hd, idx - g * hd, kNegInf,
                  0.f, 0.f);
    }
    return;
  }
  const int c_lo = lo + static_cast<int>(start);
  const int c_hi = min(hi, c_lo + chunk);

  float qr[G][8], acc[G][8], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4* qp =
        reinterpret_cast<const float4*>(q + (row0 + g) * hd + d0);
    const float4 x0 = qp[0], x1 = qp[1];
    qr[g][0] = x0.x; qr[g][1] = x0.y; qr[g][2] = x0.z; qr[g][3] = x0.w;
    qr[g][4] = x1.x; qr[g][5] = x1.y; qr[g][6] = x1.z; qr[g][7] = x1.w;
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const int wt = kpw * min(U, kMaxTile / kpw);   // keys of a warp tile
  const int step = kWarps * wt;
  // t0 is warp-uniform, so every lane of the warp reaches the shuffles;
  // each tile's page lookup is made one tile ahead
  int t0 = c_lo + warp * wt;
  typename Rows::Tile tile = rows.tile(b, h, t0, min(c_hi, t0 + wt), lane);
  for (; t0 < c_hi; t0 += step) {
    const int t_end = min(c_hi, t0 + wt);
    const typename Rows::Tile next =
        rows.tile(b, h, t0 + step, min(c_hi, t0 + step + wt), lane);
    uint4 kraw[U], vraw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = t0 + u * kpw + sub;
      const long long off = rows.at(tile, h, pos) + d0;
      kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < t_end) {
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
    }
    // the tile's scores, each reduced across its lane group
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      widen(kraw[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qr[g][i], kf[i], dot);
        s[u][g] = dot;
      }
    }
    for (int o = lpk >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(kFull, s[u][g], o);
      }
    }
    // one max and one rescale per tile and query head
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = s[u][g] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (uniform) x = 0.f;
        s[u][g] = t0 + u * kpw + sub < t_end ? x : kNegInf;
        mt = fmaxf(mt, s[u][g]);
      }
      const float corr = expf(m[g] - mt);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[u][g] = t0 + u * kpw + sub < t_end ? expf(s[u][g] - mt) : 0.f;
      m[g] = mt;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      widen(vraw[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        l[g] += s[u][g];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(s[u][g], vf[i], acc[g][i]);
      }
    }
    tile = next;
  }

  // merge the warp's lane groups (lanes lpk apart hold the same dims)
  for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m2 = __shfl_xor_sync(kFull, m[g], o);
      const float l2 = __shfl_xor_sync(kFull, l[g], o);
      const float mn = fmaxf(m[g], m2);
      const float c1 = expf(m[g] - mn), c2 = expf(m2 - mn);
      l[g] = l[g] * c1 + l2 * c2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a2 = __shfl_xor_sync(kFull, acc[g][i], o);
        acc[g][i] = acc[g][i] * c1 + a2 * c2;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* row = smem + (warp * G + g) * (hd + 2);
      if (d0 == 0) {
        row[0] = m[g];
        row[1] = l[g];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) row[2 + d0 + i] = acc[g][i];
    }
  }
  __syncthreads();
  // merge the warps; a warp with no key holds (-1e30, 0, 0) and weighs
  // nothing.  The chunk holds a key, so the sum is >= 1.
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd, d = idx - g * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, smem[(w * G + g) * (hd + 2)]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = smem + (w * G + g) * (hd + 2);
      const float c = expf(row[0] - mx);
      lsum += row[1] * c;
      a += row[2 + d] * c;
    }
    if (n_split == 1)
      out[(row0 + g) * hd + d] = a / lsum;
    else
      put_partial(ws, z * nrows + row0 + g, n_ml, hd, d, mx, lsum, a);
  }
}

// out[r, d] from the n_split partials (put_partial) of row r = b * Hq +
// head, in split order.  Chunk 0 always holds a key, so the sum is >= 1.
__global__ void merge_kernel(const float* __restrict__ ws,
                             float* __restrict__ out, int rows, int hd,
                             int n_split) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * hd) return;
  const long long r = idx / hd;
  const float* ml = ws;
  const float* part = ws + 2LL * n_split * rows;
  float mx = kNegInf;
  for (int z = 0; z < n_split; ++z)
    mx = fmaxf(mx, ml[(z * static_cast<long long>(rows) + r) * 2]);
  float lsum = 0.f, a = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const long long zr = z * static_cast<long long>(rows) + r;
    const float c = expf(ml[zr * 2] - mx);
    lsum += ml[zr * 2 + 1] * c;
    a += part[zr * hd + (idx - r * hd)] * c;
  }
  out[idx] = a / lsum;
}

template <class Rows>
int launch(const float* q, const void* k, const void* v, const int* lengths,
           float* out, float* ws, Rows rows, int b, int hq, int hkv, int hd,
           int s_len, int window, float cap, float scale, int n_split,
           void* stream) {
  if (b == 0) return 0;
  if (n_split < 1 || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv;
  const dim3 grid(n_split, hkv, b);
  const size_t smem = sizeof(float) * kWarps * g * (hd + 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
#define REPRO_DECODE_CASE(G)                                                \
  case G:                                                                   \
    decode_kernel<G, Rows><<<grid, kThreads, smem, st>>>(                   \
        q, kk, vv, lengths, out, ws, rows, hq, hd, s_len, window, cap,      \
        scale, n_split);                                                    \
    break;
  switch (g) {
    REPRO_DECODE_CASE(1)
    REPRO_DECODE_CASE(2)
    REPRO_DECODE_CASE(3)
    REPRO_DECODE_CASE(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
  if (n_split > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(b) * hq * hd;
    merge_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        ws, out, b * hq, hd, n_split);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, v: (B, Hkv, S, hd) with element strides sb, sh, ss (unit along hd).
// ws: n_split * B * Hq * (hd + 2) floats, unused when n_split == 1.
extern "C" int repro_flash_decode_bf16(const float* q, const void* k,
                                       const void* v, const int* lengths,
                                       float* out, float* ws, int b, int hq,
                                       int hkv, int hd, int s_len,
                                       long long sb, long long sh,
                                       long long ss, int window, float cap,
                                       float scale, int n_split,
                                       void* stream) {
  return launch(q, k, v, lengths, out, ws, DenseRows{sb, sh, ss}, b, hq, hkv,
                hd, s_len, window, cap, scale, n_split, stream);
}

// k, v: (num_pages, page, Hkv, hd) contiguous; table: (B, blocks) int32.
extern "C" int repro_flash_decode_paged_bf16(
    const float* q, const void* k, const void* v, const int* lengths,
    const int* table, float* out, float* ws, int b, int hq, int hkv, int hd,
    int page, int blocks, int window, float cap, float scale, int n_split,
    void* stream) {
  const int shift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  return launch(q, k, v, lengths, out, ws,
                PagedRows{table, blocks, page, shift, hkv, hd}, b, hq, hkv, hd,
                blocks * page, window, cap, scale, n_split, stream);
}
