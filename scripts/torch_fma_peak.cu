// What an FP32 inner loop of the backward kernels' form can reach on the card:
// a stand-alone microbenchmark (no PyTorch), one CTA of 512 or 256 threads an SM.
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -o build/fma_peak scripts/torch_fma_peak.cu
//   build/fma_peak
//
// Every thread owns a TM x TN register tile and does TM * TN FMAs a k-step, as
// product_tn of mpgan_tpu_torch/csrc/edge_bwd_common.cuh does (TM = 8 rows; TN = 3, 5, 6 columns
// at the published widths). "pure" keeps both operands in registers: the rate
// the FMA pipe gives this instruction mix. "lds" reads them from shared memory
// with the kernels' access pattern (TM floats of the transposed activations as
// 128-bit loads, 4 addresses a warp; TN floats of a packed weight row as 128-,
// 64- and 32-bit loads, 8 addresses a warp). One line a case: time, TFLOP/s,
// the SM clock from clock64() and FMAs per clock per SM (the card's peak is 128).
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kSms = 132, kSmemFloats = 16384, kSteps = 16;

template <int TM, int TN, bool kLds>
__global__ void __launch_bounds__(512, 1) fma_loop(float* out, long long* clocks, int iters,
                                                   int ldr) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  for (int i = threadIdx.x; i < kSmemFloats; i += blockDim.x) sm[i] = i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int CT = 32, n4 = TN / 4, n2 = (TN % 4) / 2;
  const int ct = (warp / 4) * 8 + (lane & 7);
  const float* ap = sm + (warp % 4) * 32 + (lane >> 3) * 8;
  const float* wp = sm + kSmemFloats / 2;
  float acc[TM][TN], a[TM], w[TN];
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < TM; ++i) a[i] = ap[i];
  for (int j = 0; j < TN; ++j) w[j] = wp[ct + CT * j];
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll 4
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kLds) {
        const float* arow = ap + kk * ldr;
        const float* wrow = wp + kk * TN * CT;
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(arow + i);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < n4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(wrow + q * 4 * CT + 4 * ct);
          w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
        }
        if (n2 > 0) {
          const float2 v = *reinterpret_cast<const float2*>(wrow + 4 * n4 * CT + 2 * ct);
          w[4 * n4] = v.x, w[4 * n4 + 1] = v.y;
        }
        if (TN % 2 == 1) w[TN - 1] = wrow[(4 * n4 + 2 * n2) * CT + ct];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < TN; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

template <int TM, int TN, bool kLds>
void run(int threads) {
  static_assert(TM % 4 == 0, "the activations are read as 128-bit loads");
  float* out;
  long long* clocks;
  cudaMalloc(&out, kSms * 512 * sizeof(float));
  cudaMalloc(&clocks, kSms * sizeof(long long));
  const int smem = kSmemFloats * sizeof(float), iters = 2000;
  cudaFuncSetAttribute(fma_loop<TM, TN, kLds>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e9f;
  for (int rep = 0; rep < 4; ++rep) {
    cudaEventRecord(e0);
    fma_loop<TM, TN, kLds><<<kSms, threads, smem>>>(out, clocks, iters, 132);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (ms < best) best = ms;
  }
  long long clk;
  cudaMemcpy(&clk, clocks, sizeof(clk), cudaMemcpyDeviceToHost);
  const double fma = (double)kSms * threads * iters * kSteps * TM * TN;
  printf("{\"mode\": \"%s\", \"tm\": %d, \"tn\": %d, \"threads\": %d, \"ms\": %.3f, "
         "\"tflops\": %.1f, \"ghz\": %.3f, \"fma_per_clk_sm\": %.1f, \"fma_per_loaded_word\": %.2f, "
         "\"status\": \"%s\"}\n",
         kLds ? "lds" : "pure", TM, TN, threads, best, 2 * fma / best / 1e9, clk / best / 1e6,
         fma / kSms / clk, (double)TM * TN / (TM + TN), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(clocks);
}

int main() {
  run<8, 2, false>(512), run<8, 3, false>(512), run<8, 5, false>(512), run<8, 6, false>(512);
  run<8, 8, false>(512);
  run<8, 2, true>(512), run<8, 3, true>(512), run<8, 4, true>(512), run<8, 5, true>(512);
  run<8, 6, true>(512), run<8, 8, true>(512), run<16, 4, true>(512);
  run<8, 8, true>(256), run<12, 8, true>(256);
  return 0;
}
