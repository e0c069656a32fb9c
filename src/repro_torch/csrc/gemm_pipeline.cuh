// Pipelined fp32 GEMM main loop for Hopper's CUDA cores, shared by every
// GEMM kernel of the package: matmul (matmul.cu), matmul_rescale
// (rotate_rescale.cu), axpy_momentum (update_chain.cu), patch_factor
// (patch_factor.cu) and factor_update (factor_update.cu):
//
//   acc[m][n] = sum_k A_tile[k][m] * B_tile[k][n]
//
// over one BM x BN output tile per block, K advancing in slices of kBK
// rows.  What it does about the card:
//
// - Register blocking.  The 8 warps lie 4 down and 2 across; a warp's 32
//   lanes lie 4 down and 8 across, and each thread owns a (BM/16) x (BN/16)
//   patch (8 x 8 at 128 x 128) in two halves of contiguous rows and two of
//   contiguous columns.  Per K row a thread reads 16 floats from shared
//   memory (four float4 loads, the A ones broadcast across the 8 lanes of a
//   row group) for 64 FMAs, so the inner loop is bound by the FMA units, not
//   by shared-memory bandwidth.  The 64 x 64 tile (4 x 4 patches, float2
//   loads) serves the products whose 128-tiles cannot fill the card, and
//   the dense ones whose B cannot be copied 16 bytes at a time (the 128
//   tile's 4-byte B loader does not fit 128 registers).  All arithmetic is
//   fp32 FMA: no TF32.
// - An asynchronous ring.  kStages slices live in dynamic shared memory;
//   cp.async fetches slice k + kStages - 1 while slice k is multiplied, and
//   one __syncthreads per slice orders the ring.
// - The loader is a template parameter: a struct with load(stage, slice),
//   which issues the copies of slice `slice` (called for 0, 1, 2, ... in
//   order) into stage = {A[kBK][BM + kPad], B[kBK][BN + kPad]}, both
//   k-major, and staged(A), called once per slice when that slice has
//   landed (a loader that also reduces the staged A tile does it there).
//   DenseLoader below reads row-major operands; patch_factor.cu's im2col
//   loader reads patches of a conv input; factor_update.cu's loader reads
//   both tiles of X^T X from X as it lies.  A masked element is a cp.async
//   with source size 0 (zero fill) from a clamped, valid address.
// - The epilogue is a compile-time enum (store_tile): an epilogue passed
//   as a functor cost an older tile 15% at 91 registers.  `mirror` also
//   writes entry (n, m) from acc[m][n], for symmetric products computed as
//   one triangle of tiles.  kAxpyNorm also returns the thread's sum of the
//   squares it wrote, which block_sum adds over the block in a fixed order.
//
// A split of K over blocks, with the partial sums added in a second pass
// in a fixed order (sum_partials.cuh), is the caller's: it picks the tile
// and the split on the host (kernels/gemm_plan.py) and hands each block its
// [k_begin, k_end).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace repro_torch {
namespace pipe {

constexpr int kThreads = 256;
constexpr int kBK = 16;      // K rows per slice
constexpr int kStages = 3;   // slices in the ring
constexpr int kPad = 4;      // floats after each staged row (bank spread)

template <int BM, int BN>
struct Tile {
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128),
                "tiles of 64 or 128");
  static constexpr int kLdA = BM + kPad;
  static constexpr int kLdB = BN + kPad;
  static constexpr int kStageFloats = kBK * (kLdA + kLdB);
  static constexpr int kSmemBytes =
      kStages * kStageFloats * static_cast<int>(sizeof(float));
  static constexpr int kGM = BM / 32;   // contiguous rows in each half
  static constexpr int kGN = BN / 32;   // contiguous cols in each half
  static constexpr int kTM = 2 * kGM;   // rows per thread
  static constexpr int kTN = 2 * kGN;   // cols per thread
  static constexpr int kWM = BM / 4;    // warp tile rows (4 warps down)
  static constexpr int kWN = BN / 2;    // warp tile cols (2 warps across)

  // tile row of the thread's accumulator row i, tile col of its col j
  __device__ __forceinline__ static int row(int i) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp >> 1) * kWM + (i / kGM) * (kWM / 2) + (lane >> 3) * kGM +
           i % kGM;
  }
  __device__ __forceinline__ static int col(int j) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp & 1) * kWN + (j / kGN) * (kWN / 2) + (lane & 7) * kGN +
           j % kGN;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; zero fill when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero fill when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int G>
__device__ __forceinline__ void lds(float* r, const float* p) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  }
}

template <int BM, int BN, bool VEC, bool A_ROWS>
struct DenseLoader;

// Whether a loader stages A as rows [m][kBK] (DenseLoader<..., true>)
// rather than k-major; every other loader stages it k-major.
template <class Loader>
constexpr bool kARows = false;
template <int BM, int BN, bool VEC>
constexpr bool kARows<DenseLoader<BM, BN, VEC, true>> = true;

// acc += the product of `slices` K slices of the loader's tiles.  smem: the
// block's dynamic shared memory, kStages stages of Tile::kStageFloats.
template <int BM, int BN, class Loader>
__device__ __forceinline__ void mainloop(
    Loader& ld, float* smem, int slices,
    float (&acc)[Tile<BM, BN>::kTM][Tile<BM, BN>::kTN]) {
  using T = Tile<BM, BN>;
  const int ra = T::row(0), cb = T::col(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) ld.load(smem + s * T::kStageFloats, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's)
    __syncthreads();               // ... everyone's; slice kt-1 is done
    const int next = kt + kStages - 1;
    if (next < slices) ld.load(smem + (next % kStages) * T::kStageFloats,
                               next);
    cp_async_commit();
    const float* As = smem + (kt % kStages) * T::kStageFloats;
    const float* Bs = As + kBK * T::kLdA;
    ld.staged(As);
    if constexpr (kARows<std::remove_const_t<Loader>>) {
      // A rows [m][kBK], chunk c of row m at chunk c ^ swizzle(m): a float4
      // gives 4 K steps of one row; the sums run in the same order as
      // k-major
      const int sw = (threadIdx.x & 31) >> 3;  // swizzle of all my rows
#pragma unroll
      for (int c = 0; c < kBK / 4; ++c) {
        float a[T::kTM][4];
#pragma unroll
        for (int i = 0; i < T::kTM; ++i)
          lds<4>(a[i], As + (ra + (i / T::kGM) * (T::kWM / 2) + i % T::kGM) *
                                kBK + 4 * (c ^ sw));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float b[T::kTN];
          lds<T::kGN>(b, Bs + (4 * c + q) * T::kLdB + cb);
          lds<T::kGN>(b + T::kGN, Bs + (4 * c + q) * T::kLdB + cb +
                                      T::kWN / 2);
#pragma unroll
          for (int i = 0; i < T::kTM; ++i)
#pragma unroll
            for (int j = 0; j < T::kTN; ++j)
              acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[T::kTM], b[T::kTN];
        lds<T::kGM>(a, As + kk * T::kLdA + ra);
        lds<T::kGM>(a + T::kGM, As + kk * T::kLdA + ra + T::kWM / 2);
        lds<T::kGN>(b, Bs + kk * T::kLdB + cb);
        lds<T::kGN>(b + T::kGN, Bs + kk * T::kLdB + cb + T::kWN / 2);
#pragma unroll
        for (int i = 0; i < T::kTM; ++i)
#pragma unroll
          for (int j = 0; j < T::kTN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
}

// Row-major operands: A (M, K) with A[m * K + k], B (K, N) with B[k * N + n],
// the block's tile at (row0, col0), K rows [k_begin, k_end).  A is staged
// k-major by 4-byte copies, each to its transposed place (lanes take 8 k by
// 4 m, so the stores hit 32 distinct banks at kLdA = BM + 4), or, with
// A_ROWS (K % 4 == 0 and a 16-byte aligned A: the caller checks both), as
// rows [m][kBK] by 16-byte copies, chunk c of row m at chunk c ^ ((m / kGM)
// & 3), so that the four row groups a warp reads at once lie in four bank
// quads; the main loop then reads 4 K steps of a row at once, half the
// shared-memory reads of A.  B is copied as it lies, 16 bytes at a time
// when VEC (N % 4 == 0 and a 16-byte aligned B: the caller checks both),
// else 4.
template <int BM, int BN, bool VEC, bool A_ROWS = false>
struct DenseLoader {
  using T = Tile<BM, BN>;
  static_assert(BM * kBK <= kBK * T::kLdA, "A rows fit A's stage area");
  const float* A;
  const float* B;
  int M, N, K, row0, col0, k_begin, k_end;

  __device__ __forceinline__ void load(float* stage, int slice) const {
    const int k0 = k_begin + slice * kBK;
    float* As = stage;
    float* Bs = stage + kBK * T::kLdA;
    if constexpr (A_ROWS) {
#pragma unroll
      for (int e = 0; e < BM * kBK / 4 / kThreads; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int m = idx / (kBK / 4), c = idx % (kBK / 4);
        const int gm = row0 + m, gk = k0 + 4 * c;
        const bool ok = gm < M && gk < k_end;
        cp_async16(As + m * kBK + 4 * (c ^ ((m / T::kGM) & 3)),
                   ok ? A + static_cast<long long>(gm) * K + gk : A, ok);
      }
    } else {
#pragma unroll
      for (int e = 0; e < BM * kBK / kThreads; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int m = (idx >> 3) % BM;
        const int k = (idx & 7) + 8 * ((idx >> 3) / BM);
        const int gm = row0 + m, gk = k0 + k;
        const bool ok = gm < M && gk < k_end;
        cp_async4(As + k * T::kLdA + m,
                  ok ? A + static_cast<long long>(gm) * K + gk : A, ok);
      }
    }
    if constexpr (VEC) {
#pragma unroll
      for (int e = 0; e < BN * kBK / 4 / kThreads; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int n = 4 * (idx % (BN / 4)), k = idx / (BN / 4);
        const int gn = col0 + n, gk = k0 + k;
        const bool ok = gn < N && gk < k_end;
        cp_async16(Bs + k * T::kLdB + n,
                   ok ? B + static_cast<long long>(gk) * N + gn : B, ok);
      }
    } else {
#pragma unroll
      for (int e = 0; e < BN * kBK / kThreads; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int n = idx % BN, k = idx / BN;
        const int gn = col0 + n, gk = k0 + k;
        const bool ok = gn < N && gk < k_end;
        cp_async4(Bs + k * T::kLdB + n,
                  ok ? B + static_cast<long long>(gk) * N + gn : B, ok);
      }
    }
  }

  __device__ __forceinline__ void staged(const float*) const {}
};

enum Epilogue : int {
  kStore,     // O = acc: a K split's partial sum
  kAxpby,     // O = alpha * acc + beta * C
  kScale,     // O = alpha * acc: no C
  kRescale,   // O = acc / (C + alpha): the damped eigenbasis rescale
  kAxpyNorm,  // O = alpha * acc + beta * C, and the sum of O^2 returned
};

// Writes the thread's patch of the tile at (row0, col0) into the (rows,
// cols) output O with leading dimension ld; C has O's layout.  With
// `mirror` (kStore, kAxpby, kScale), entry (n, m) also gets acc[m][n], with
// C's own (n, m) entry: a triangle of tiles of a symmetric product fills
// the other.  Returns, for kAxpyNorm, the sum of the squares of the entries
// the thread wrote, in the order it wrote them (0 for the others).
template <int EPI, int BM, int BN>
__device__ __forceinline__ float store_tile(
    const float (&acc)[Tile<BM, BN>::kTM][Tile<BM, BN>::kTN],
    float* __restrict__ O, const float* __restrict__ C, int ld, int rows,
    int cols, int row0, int col0, float alpha, float beta, bool mirror) {
  using T = Tile<BM, BN>;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int m = row0 + T::row(i);
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < T::kTN; ++j) {
      const int n = col0 + T::col(j);
      if (n >= cols) continue;
      const float v = acc[i][j];
      const long long o = static_cast<long long>(m) * ld + n;
      if constexpr (EPI == kRescale) {
        O[o] = v / (C[o] + alpha);
      } else if constexpr (EPI == kAxpby) {
        O[o] = fmaf(beta, C[o], alpha * v);
      } else if constexpr (EPI == kAxpyNorm) {
        const float d = fmaf(beta, C[o], alpha * v);
        O[o] = d;
        sq = fmaf(d, d, sq);
      } else if constexpr (EPI == kScale) {
        O[o] = alpha * v;
      } else {
        O[o] = v;
      }
      if constexpr (EPI != kRescale && EPI != kAxpyNorm) {
        if (mirror) {
          const long long t = static_cast<long long>(n) * ld + m;
          O[t] = EPI == kAxpby  ? fmaf(beta, C[t], alpha * v)
                 : EPI == kScale ? alpha * v
                                 : v;
        }
      }
    }
  }
  return sq;
}

// The sum of v over the block's kThreads threads in a fixed order: a
// warp-shuffle tree, then the warp sums in warp order.  Thread 0 gets it
// (the others get 0).  No atomics, so the sum is the same on every run.
// Every thread of the block calls it.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// Raise a kernel's dynamic shared memory limit (needed above 48 KB);
// returns the CUDA status as an int.  Callers keep it in a function-local
// static, so it runs once per kernel instantiation.
template <class Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace pipe
}  // namespace repro_torch
