// Pieces shared by the backward kernels (edge_aggregate_bwd.cu: K3;
// knn_edge_bwd.cu: K6): per-CTA partial sums that a thread owns, the weight
// gradient contraction over a pass, and the fixed-order reduction of the
// partials across CTAs.
#pragma once

#include "edge_common.cuh"

namespace {

// dst = v on a CTA's first pass, dst += v after. Each such address is owned by
// one thread on every pass, so the adds land in pass order and the sum is the
// same, bit for bit, as a read-modify-write; atomicAdd with its result unused is
// a fire-and-forget reduction, so the thread does not wait for the old value.
__device__ __forceinline__ void accumulate_to(float* dst, float v, bool first) {
  if (first)
    *dst = v;
  else
    atomicAdd(dst, v);
}

// dW[K x M] (+)= A^T D over `rows` rows, A [K x lda] and D [M x lda] stored
// transposed in shared memory; `first` overwrites instead of adding. A warp owns
// a 32 (k) x 32 (m) tile; lane l takes rows k = k0 + (l >> 3) + 4i (i < 8) and
// columns m = m0 + (l & 7) + 8j (j < 4), so the 8 lanes of a quarter warp read 8
// neighbouring rows of D (lda = 4 mod 32 puts them in distinct banks) and one
// row of A (a broadcast). It walks the pair rows 4 at a time with 128-bit loads,
// not unrolled: unrolling twice spilled registers and ran slower (PERF.md).
__device__ void weight_grad(const float* __restrict__ A, const float* __restrict__ D, int lda,
                            int rows, int K, int M, float* __restrict__ dW,
                            float* __restrict__ db, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nkb = (K + kRowBlock - 1) / kRowBlock, nmb = (M + kColBlock - 1) / kColBlock;
  for (int wb = warp; wb < nkb * nmb; wb += kWarps) {
    const int k0 = (wb / nmb) * kRowBlock + (lane >> 3);
    const int m0 = (wb % nmb) * kColBlock + (lane & 7);
    int a_off[8], d_off[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a_off[i] = min(k0 + 4 * i, K - 1) * lda;
#pragma unroll
    for (int j = 0; j < 4; ++j) d_off[j] = min(m0 + 8 * j, M - 1) * lda;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int r = 0; r < rows; r += 4) {
      float4 a[8], d[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(A + a_off[i] + r);
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = *reinterpret_cast<const float4*>(D + d_off[j] + r);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, d[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, d[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, d[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, d[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + 8 * j;
        if (k < K && m < M) accumulate_to(dW + (size_t)k * M + m, acc[i][j], first);
      }
    }
  }
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const float* col = D + (size_t)m * lda;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += col[r];
    accumulate_to(db + m, s, first);
  }
}

// out[o, k] = sum_q in[o * outer_stride + q * part_stride + k] for q in [0, parts),
// summed in order q = 0, 1, ... (deterministic).
__global__ void reduce_parts(const float* __restrict__ in, float* __restrict__ out, int outer,
                             int parts, long long inner, long long part_stride,
                             long long outer_stride) {
  const long long total = (long long)outer * inner;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long o = t / inner, k = t - (t / inner) * inner;
    const float* src = in + o * outer_stride + k;
    float s = 0.f;
    for (int q = 0; q < parts; ++q) s += src[q * part_stride];
    out[t] = s;
  }
}

int launch_reduce(const float* in, float* out, int outer, int parts, long long inner,
                  long long part_stride, long long outer_stride, cudaStream_t stream) {
  const long long total = (long long)outer * inner;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  reduce_parts<<<(int)(blocks < 4096 ? blocks : 4096), threads, 0, stream>>>(
      in, out, outer, parts, inner, part_stride, outer_stride);
  return (int)cudaGetLastError();
}

}  // namespace
