// Shared-memory tiled fp32 GEMM, the body of one hand-written kernel of
// this package:
//
//   update_chain.cu    O    = alpha * A @ B + beta * C, + sum O^2  (kAxpyNorm)
//
// kAxpby, the plain form of that epilogue, is no longer launched: matmul.cu,
// factor_update.cu, patch_factor.cu and rotate_rescale.cu run the pipelined
// main loop of gemm_pipeline.cuh instead.  This file goes once
// update_chain.cu moves there too.
//
// Design (simple and correct first): a 64 x 64 output tile per block of 256
// threads, each thread owning a 4 x 4 register patch; K is a loop inside the
// block in steps of 16, both operand tiles staged through shared memory.
// Every load and store is masked, so ragged sizes (the homogeneous a_dim =
// d_in + 1 sides: 785, 1001, 501, 251, 31; d = 30 ...) run without padding.
// All arithmetic is fp32 FMA on the CUDA cores: no TF32, no tensor cores.
// wgmma/TMA pipelines are later work.
//
// The epilogue is a template parameter that only the final loop over the
// register patch reads (an epilogue passed as a functor instead gave the
// plain kAxpby product 91 registers against 70 and cost it 15%).
//
// alpha/beta come either by value or, when `ab` is non-null, from a
// 2-float device buffer read inside the kernel, so values that live on the
// device (the damping lam, the fixed-lr chain's alpha and mu) need no host
// sync.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output cols per block
constexpr int kBK = 16;        // K slice staged per iteration
constexpr int kTM = 4;         // rows per thread
constexpr int kTN = 4;         // cols per thread
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)

enum Epilogue : int {
  kAxpby,     // O = alpha * acc + beta * C (C may be null)
  kAxpyNorm,  // O = alpha * acc + beta * C, and the block's sum of O^2
              // over its valid entries into partials[z][y][x]: a
              // warp-shuffle tree, then the 8 warp sums in a fixed order,
              // no atomics, so the sum is the same on every run
};

// A is (M, K) row-major; element (m, k) = A[m * K + k].  B is (K, N)
// row-major.  Batch b = blockIdx.z offsets every operand by its batch
// stride (0 broadcasts one operand over the batch).
template <int EPI>
__global__ void __launch_bounds__(kThreads)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ O,
                int M, int N, int K,
                long long sA, long long sB, long long sC, long long sO,
                const float* __restrict__ ab, float alpha, float beta,
                float* __restrict__ partials) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // A tile, k-major
  __shared__ __align__(16) float Bs[kBK][kBN];

  const long long bz = blockIdx.z;
  A += bz * sA;
  B += bz * sB;
  O += bz * sO;
  if (C != nullptr) C += bz * sC;
  if (ab != nullptr) {
    alpha = ab[0];
    beta = ab[1];
  }

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      // neighbouring threads read neighbouring addresses
      const int m = idx / kBK;
      const int k = idx % kBK;
      const int gm = row0 + m, gk = k0 + k;
      float v = 0.f;
      if (gm < M && gk < K) v = A[(long long)gm * K + gk];
      As[k][m] = v;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int n = idx % kBN, k = idx / kBN;
      const int gn = col0 + n, gk = k0 + k;
      Bs[k][n] = (gn < N && gk < K) ? B[(long long)gk * N + gn] : 0.f;
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

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = row0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = col0 + tx * kTN + j;
      if (gn >= N) continue;
      const long long o = (long long)gm * N + gn;
      float v = alpha * acc[i][j];
      if (C != nullptr) v = fmaf(beta, C[o], v);
      O[o] = v;
      if constexpr (EPI == kAxpyNorm) sq = fmaf(v, v, sq);
    }
  }
  if constexpr (EPI == kAxpyNorm) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_down_sync(0xffffffffu, sq, off);
    __shared__ float warp_sq[kThreads / 32];
    if (tid % 32 == 0) warp_sq[tid / 32] = sq;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sq[w];
      partials[(bz * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total;
    }
  }
}

// Launch on `stream`; returns cudaGetLastError() as an int (0 = success).
template <int EPI>
inline int launch_gemm_f32(const float* A, const float* B, const float* C,
                           float* O, int batch, int M, int N, int K,
                           long long sA, long long sB, long long sC,
                           long long sO, const float* ab, float alpha,
                           float beta, float* partials, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  gemm_f32_kernel<EPI>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          A, B, C, O, M, N, K, sA, sB, sC, sO, ab, alpha, beta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch
