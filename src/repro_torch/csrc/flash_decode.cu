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
// card's fp32 ridge.  The design reads each K/V row once per group: one
// block per (row b, KV head h) holds all G query heads; the TPU kernel's
// q-head block bh bought the same.  Eight warps split the keys.  In a
// warp, hd / 8 lanes share a key, each loading 16 bytes (8 bf16) of its K
// and V rows, so a warp takes 256 / hd keys at a time, and each lane group
// keeps kUnroll keys' loads in flight.  bf16 is widened to float32 in
// registers.  Each lane group keeps an online softmax (m, l, acc) per
// query head; groups merge across the warp with shuffles and across warps
// in shared memory.  The TPU kernels walked every block of the cache and
// masked; these visit only the valid keys, which gives the same function.
// expf and tanhf are the IEEE versions (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys each lane group keeps in flight
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Element offset of key row `pos` of KV head `h` of batch row `b`.
struct DenseRows {  // k, v viewed as (B, Hkv, S, hd) with these strides
  long long sb, sh, ss;
  __device__ long long operator()(int b, int h, int pos) const {
    return b * sb + h * sh + pos * ss;
  }
};

struct PagedRows {  // pools (num_pages, page, Hkv, hd), table (B, blocks)
  const int* table;
  int blocks, page, hkv, hd;
  __device__ long long operator()(int b, int h, int pos) const {
    const int blk = pos / page;
    const long long phys =
        __ldg(table + static_cast<long long>(b) * blocks + blk);
    return ((phys * page + (pos - blk * page)) * hkv + h) * hd;
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

// At least one block per SM, not two: G = 4 (llama3.2-1b's group) holds
// 4 * 8 q and 4 * 8 accumulator registers a lane beside four keys' K/V
// loads, and takes 145-147 registers.  Without the minimum ptxas held it
// to 128 and spilled.  The serve path's grid is B * Hkv = 128 blocks on
// 132 SMs, one block an SM either way.
template <int G, class Rows>
__global__ void __launch_bounds__(kThreads, 1)
    decode_kernel(const float* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ lengths, float* __restrict__ out,
                  Rows rows, int hq, int hd, int s_len, int window, float cap,
                  float scale) {
  extern __shared__ float smem[];  // [kWarps][G][hd + 2]: m, l, acc[hd]
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpk = hd >> 3;         // lanes per key
  const int kpw = 32 / lpk;        // keys per warp pass
  const int sub = lane / lpk;      // this lane group's key in the pass
  const int d0 = (lane - sub * lpk) * 8;

  const int len = lengths[b];
  int hi = min(len, s_len);
  int lo = window > 0 ? max(0, len - window) : 0;
  const bool uniform = hi <= lo;   // no valid key: equal weights
  if (uniform) {
    lo = 0;
    hi = s_len;
  }

  float qr[G][8], acc[G][8], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4* qp = reinterpret_cast<const float4*>(
        q + (static_cast<long long>(b) * hq + h * G + g) * hd + d0);
    const float4 x0 = qp[0], x1 = qp[1];
    qr[g][0] = x0.x; qr[g][1] = x0.y; qr[g][2] = x0.z; qr[g][3] = x0.w;
    qr[g][4] = x1.x; qr[g][5] = x1.y; qr[g][6] = x1.z; qr[g][7] = x1.w;
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const int pass = kWarps * kpw;   // keys the block takes per pass
  const int mine = warp * kpw + sub;
  // the loop bound is block-uniform, so every lane reaches the shuffles
  for (int p0 = lo; p0 < hi; p0 += pass * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = p0 + u * pass + mine;
      kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < hi) {
        const long long off = rows(b, h, pos) + d0;
        kraw[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vraw[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = p0 + u * pass + mine < hi;
      float kf[8], vf[8];
      widen(kraw[u], kf);
      widen(vraw[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qr[g][i], kf[i], dot);
        for (int o = lpk >> 1; o > 0; o >>= 1)
          dot += __shfl_xor_sync(kFull, dot, o);
        float s = dot * scale;
        if (cap > 0.f) s = cap * tanhf(s / cap);
        if (uniform) s = 0.f;
        if (valid) {
          const float mn = fmaxf(m[g], s);
          const float corr = expf(m[g] - mn);
          const float pe = expf(s - mn);
          l[g] = l[g] * corr + pe;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = acc[g][i] * corr + pe * vf[i];
          m[g] = mn;
        }
      }
    }
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
  // merge the warps; at least one key was visited, so the sum is >= 1
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
    out[(static_cast<long long>(b) * hq + h * G + g) * hd + d] = a / lsum;
  }
}

template <class Rows>
int launch(const float* q, const void* k, const void* v, const int* lengths,
           float* out, Rows rows, int b, int hq, int hkv, int hd, int s_len,
           int window, float cap, float scale, void* stream) {
  if (b == 0) return 0;
  const int g = hq / hkv;
  const dim3 grid(b, hkv);
  const size_t smem = sizeof(float) * kWarps * g * (hd + 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
#define REPRO_DECODE_CASE(G)                                              \
  case G:                                                                 \
    decode_kernel<G, Rows><<<grid, kThreads, smem, st>>>(                 \
        q, kk, vv, lengths, out, rows, hq, hd, s_len, window, cap, scale); \
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, v: (B, Hkv, S, hd) with element strides sb, sh, ss (unit along hd).
extern "C" int repro_flash_decode_bf16(const float* q, const void* k,
                                       const void* v, const int* lengths,
                                       float* out, int b, int hq, int hkv,
                                       int hd, int s_len, long long sb,
                                       long long sh, long long ss, int window,
                                       float cap, float scale, void* stream) {
  return launch(q, k, v, lengths, out, DenseRows{sb, sh, ss}, b, hq, hkv, hd,
                s_len, window, cap, scale, stream);
}

// k, v: (num_pages, page, Hkv, hd) contiguous; table: (B, blocks) int32.
extern "C" int repro_flash_decode_paged_bf16(
    const float* q, const void* k, const void* v, const int* lengths,
    const int* table, float* out, int b, int hq, int hkv, int hd, int page,
    int blocks, int window, float cap, float scale, void* stream) {
  return launch(q, k, v, lengths, out, PagedRows{table, blocks, page, hkv, hd},
                b, hq, hkv, hd, blocks * page, window, cap, scale, stream);
}
