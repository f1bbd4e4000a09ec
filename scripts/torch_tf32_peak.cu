// What the split-TF32 products of the bf16 backward kernels can reach on the card:
// a stand-alone microbenchmark (no PyTorch), one CTA of 512 threads an SM.
//
//   nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -o build/tf32_peak scripts/torch_tf32_peak.cu
//   build/tf32_peak
//
// A warp does the inner step of the dW contraction of
// mpgan_tpu_torch/csrc/edge_bwd_tf32x3.cuh: a 32 x 32 tile, two m tiles by four n tiles
// of mma.sync m16n8k8 TF32, 8 rows of the contraction a step. "mma" keeps the
// operands in registers (24 mma a step, no split): the rate of mma.sync TF32 itself.
// "lds+cvt" reads the step's 16 float32 operands from shared memory in the
// kernel's pattern, splits each into hi and lo with cvt.rna.tf32.f32 (two cvt and
// a subtraction) and issues the 24 mma of the three split products; "lds+int" does
// the same rounding (to nearest, ties away) with integer adds and masks. One line a
// case: time, the TF32 mma rate in TFLOP/s, and the float32 product rate that the
// three-product split gives (a third of it).
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kSms = 132, kSmemFloats = 16384, kLdr = 132;

enum Split { kNone, kCvt, kInt };

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <Split S>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  if (S == kCvt) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
  }
}

template <Split S>
__global__ void __launch_bounds__(512, 1) tf32_loop(float* out, long long* clocks, int iters) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  for (int i = threadIdx.x; i < kSmemFloats; i += blockDim.x) sm[i] = 1.f + i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* D = sm + g * kLdr + t;
  const float* A = sm + kSmemFloats / 2 + g * kLdr + t;
  float acc[2][4][4] = {};
  unsigned dhi[2][4], dlo[2][4], ahi[4][2], alo[4][2];
  for (int mt = 0; mt < 2; ++mt)
    for (int i = 0; i < 4; ++i) dhi[mt][i] = dlo[mt][i] = __float_as_uint(D[i]);
  for (int nt = 0; nt < 4; ++nt) ahi[nt][0] = alo[nt][0] = ahi[nt][1] = alo[nt][1] = __float_as_uint(A[nt]);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const int r = (it & 7) * 8;
    if (S != kNone) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split<S>(D[16 * mt * kLdr + r], dhi[mt][0], dlo[mt][0]);
        split<S>(D[(16 * mt + 8) * kLdr + r], dhi[mt][1], dlo[mt][1]);
        split<S>(D[16 * mt * kLdr + r + 4], dhi[mt][2], dlo[mt][2]);
        split<S>(D[(16 * mt + 8) * kLdr + r + 4], dhi[mt][3], dlo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split<S>(A[8 * nt * kLdr + r], ahi[nt][0], alo[nt][0]);
        split<S>(A[8 * nt * kLdr + r + 4], ahi[nt][1], alo[nt][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(acc[mt][nt], dlo[mt], ahi[nt][0], ahi[nt][1]);
        mma_tf32(acc[mt][nt], dhi[mt], alo[nt][0], alo[nt][1]);
        mma_tf32(acc[mt][nt], dhi[mt], ahi[nt][0], ahi[nt][1]);
      }
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int i = 0; i < 4; ++i) s += acc[mt][nt][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

template <Split S>
void run(const char* name) {
  float* out;
  long long* clocks;
  cudaMalloc(&out, kSms * 512 * sizeof(float));
  cudaMalloc(&clocks, kSms * sizeof(long long));
  const int smem = kSmemFloats * sizeof(float);
  cudaFuncSetAttribute(tf32_loop<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int iters = 20000;
  tf32_loop<S><<<kSms, 512, smem>>>(out, clocks, 100);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f;
  for (int rep = 0; rep < 3; ++rep) {
    cudaEventRecord(e0);
    tf32_loop<S><<<kSms, 512, smem>>>(out, clocks, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    best = ms < best ? ms : best;
  }
  long long clk;
  cudaMemcpy(&clk, clocks, sizeof(clk), cudaMemcpyDeviceToHost);
  // 24 mma m16n8k8 (1,024 FMA each) a warp a step, 16 warps, kSms SMs
  const double flop = 2.0 * 1024 * 24 * 16 * (double)iters * kSms;
  printf("%-8s %8.3f ms  mma TF32 %6.1f TFLOP/s  split products %6.1f TFLOP/s  %5.1f mma FMA/clk/SM  err %s\n",
         name, best, flop / best / 1e9, flop / 3 / best / 1e9,
         1024.0 * 24 * 16 * iters / (double)clk, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(clocks);
}

int main() {
  run<kNone>("mma");
  run<kCvt>("lds+cvt");
  run<kInt>("lds+int");
  return 0;
}
