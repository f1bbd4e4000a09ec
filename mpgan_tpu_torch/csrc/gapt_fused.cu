// The whole GAPT generator forward in one kernel, for Hopper (sm_90a), FP32 on
// CUDA cores.
//
// Replaces K9 of mpgan_tpu/ops/gapt_pallas.py: gapt_g_fused (_kernel). For a jet's
// x [N, E] and an optional mask [N] (1 real, 0 padded), with L layers of H heads of
// width hd = E / H:
//
//   for each layer:  qkv  = x . in_w^T + in_b                               [N, 3E]
//                    s    = q_h . k_h^T / sqrt(hd) + (mask_j - 1) * 1e30    per head h
//                    attn = softmax_j(s) . v_h                              [N, E]
//                    x   += attn . out_w^T + out_b
//                    x   += leaky(x . ff_w^T + ff_b, alpha)
//   y = tanh(x . fc_w^T + fc_b)   [N, F];  with a mask, mask - 0.5 as column F
//
// exp(-1e30 - max) underflows to exactly 0, so a padded sender weighs nothing, as
// with the -inf of the plain model path; every jet holds at least one real particle.
// Padded receivers are computed like any row. Eval only: no dropout, no backward.
//
// What bounds it: 2 * N * E * 5E FLOP of projections and 4 * N^2 * E of attention a
// layer (5.9 MFLOP a jet at N = 30, E = 64, L = 4) against N * (E + F + 2) * 4 bytes of
// input and output a jet: the FP32 FMA rate, by a factor of about 30 over the bytes.
//
// The item path (gapt_item_kernel), for every size its plan admits (N <= 160 at
// E = 64: every published size):
//   - an item is G = max(1, 128 / ns) jets, ns = N rounded up to 4, their rows
//     stacked (4 jets = 128 rows at N = 30, one jet of 160 rows at N = 150); a
//     persistent grid of at most one CTA an SM walks a contiguous range of items
//     computed from the indices alone (edge_products.cuh: range_start), so there
//     is no partial wave, and a jet's arithmetic does not depend on its item:
//     reruns, and a jet in any batch, give the same bits. Rows of jets past the
//     batch and past N are zeros, computed and never stored;
//   - activations are stored transposed in shared memory, x [E x ldr] and qkv
//     [3E x ldr], ldr = rows + 4, for the whole item and all layers;
//   - the four projections are products of the edge kernels' form (8 x TN
//     register tiles of 512 threads, operands from shared memory, weight k-slabs
//     copied by cp.async into two buffers, the next slab in flight, the next
//     product's first slab started during the current one's last, across the
//     attention and into the next item). The weights are read as the wrapper
//     gets them ([in, out], rows contiguous), once an item and layer instead of
//     once a jet. edge_products.cuh's product_tn is not used itself: its
//     epilogues sum or scatter pair rows, these store qkv, add to x and take the
//     FF's LeakyReLU, and its passes have 32, 64 or 128 rows where N = 150 needs
//     160;
//   - attention: a warp takes one (jet, head, 32 query rows) problem, a lane one
//     query row. Every lane reads the same senders' k and v (a 128-bit broadcast
//     of 4 senders from the transposed qkv), keeps its 32 scores in registers and
//     runs the softmax online over chunks of 32 senders (running max and sum), so
//     no shuffle, no [N, N] buffer and a bounded register count; the output
//     overwrites the row's own q columns;
//   - expf and tanhf, no fast-math forms, no tensor cores and no TF32: the result
//     holds 1e-4 against the plain PyTorch version.
// The per-jet path (gapt_jet_kernel, the first design) runs the sizes the item plan
// refuses: E not a multiple of 4, hd > 32, or rows whose products would need
// more than 8 columns a thread (N > 160 at E = 64). A CTA owns one jet, reads the
// weights through L1/L2, and a warp takes a (row, head) pair of the attention;
// where a jet does not fit in shared memory, qkv and then x live in a per-CTA
// device scratch.
// The bf16 mode (mpgan_gapt_fused_bf16, the bf16 GAPT step's D-step generator) runs
// the same body on bf16 tensors in kernels of its own (gapt_item_kernel_bf16,
// gapt_jet_kernel_bf16): each element widened to float32 where it is read (the
// item path's weight slabs land as bf16 in a slab's last third, 8 bytes a cp.async,
// and are widened into its first two thirds once they have landed; the per-jet
// path reads 4 weights as one 8-byte load), the output rounded to bf16 at its store.
// No cast runs around the launch, and the output equals the FP32 launch's on the
// widened inputs, rounded.

#include <cfloat>
#include <type_traits>

#include "edge_products.cuh"

namespace {

constexpr int kScratchCtas = 132 * 4;  // CTAs of a launch whose jets live in device memory
constexpr float kNeg = 1e30f;

// With -DMPGAN_PHASE_CLOCKS the kernel sums clock64() per phase into a device
// array that mpgan_gapt_fused_phase_clocks reads: CTA phases (thread 0 after a
// barrier) and, inside the attention, each warp's own time in its two stages
// (lane 0), which split the attention phase. The build without the flag
// carries none of it.
enum GaptPhase {
  kGaptQkv = 0,   // the qkv projection
  kGaptOut,       // the attention's out projection (and its residual)
  kGaptFf,        // the feed-forward projection (and its residual)
  kGaptFc,        // the final FC, tanh and the stores
  kGaptAttn,      // the attention
  kGaptTail,      // loading a jet (or an item) and what no other phase holds
  kGaptWait,      // inside the projections: waiting for a weight slab
  kGaptScoreW,    // warp clocks: scores and softmax
  kGaptSumW,      // warp clocks: the weighted sum over v
  kGaptPhases
};
#ifdef MPGAN_PHASE_CLOCKS
__device__ unsigned long long g_gapt_clocks[kGaptPhases];
#define GAPT_CLOCK_START() long long gclk_ = clock64()
#define GAPT_STAMP(ph)                                                              \
  do {                                                                              \
    __syncthreads();                                                                \
    if (threadIdx.x == 0) {                                                         \
      const long long now_ = clock64();                                             \
      atomicAdd(&g_gapt_clocks[ph], (unsigned long long)(now_ - gclk_));            \
      gclk_ = now_;                                                                 \
    }                                                                               \
  } while (0)
#define GAPT_WARP_START() long long wclk_ = clock64()
#define GAPT_WARP_STAMP(ph)                                                         \
  do {                                                                              \
    const long long now_ = clock64();                                               \
    if ((threadIdx.x & 31) == 0)                                                    \
      atomicAdd(&g_gapt_clocks[ph], (unsigned long long)(now_ - wclk_));            \
    wclk_ = now_;                                                                   \
  } while (0)
#else
#define GAPT_CLOCK_START()
#define GAPT_STAMP(ph)
#define GAPT_WARP_START()
#define GAPT_WARP_STAMP(ph)
#endif

struct Weights {
  const float* in_wt;   // [L, E, 3E]
  const float* in_b;    // [L, 3E]
  const float* out_wt;  // [L, E, E]
  const float* out_b;   // [L, E]
  const float* ff_wt;   // [L, E, E]
  const float* ff_b;    // [L, E]
  const float* fc_wt;   // [E, F]
  const float* fc_b;    // [F]
};

// The bf16 mode's (mpgan_gapt_fused_bf16): the same tensors in bf16. Its kernels run
// the float32 body on their float32 values, widened where they are read: x and the
// mask as they are staged into shared memory, the projections' weights in each slab
// after its copy lands (item path) or at each 8-byte load of 4 (per-jet path), the
// biases and the FC's weights at each load; the output rounded to bf16 once, at its
// store. So its output is the FP32 kernel's on the widened inputs, rounded.
struct WeightsBf16 {
  const bf16* in_wt;
  const bf16* in_b;
  const bf16* out_wt;
  const bf16* out_b;
  const bf16* ff_wt;
  const bf16* ff_b;
  const bf16* fc_wt;
  const bf16* fc_b;
};

// Four bf16 values (8 bytes) as float32.
__device__ __forceinline__ float4 widen4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// Four neighbouring weights as float32 (16-byte aligned float, 8-byte aligned bf16).
__device__ __forceinline__ float4 ld_w4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld_w4(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

enum Mode { kStore, kAccumulate, kLeaky, kTanh };

// C: shared memory or the device scratch (float), or the output (kTanh: float or bf16).
template <int kMode, typename TC>
__device__ __forceinline__ void emit(TC* c, float v, float alpha) {
  if constexpr (kMode == kStore) st_elem(c, v);
  if constexpr (kMode == kAccumulate) *c += v;
  if constexpr (kMode == kLeaky) st_elem(c, v >= 0.f ? v : alpha * v);
  if constexpr (kMode == kTanh) st_elem(c, tanhf(v));
}

// C[i, o] (mode) A[i, :] . Wt[:, o] + bias[o] for i < n, o < m; A [n, lda], Wt [k, m]
// row-major, C [n, ldc]. A and C must not overlap. With kVec, k and m are multiples
// of 4 and lda, the pointers of A and Wt are 16-byte aligned (bf16 Wt: 8-byte).
// TW: the weights' and biases' element type.
template <int kMode, bool kVec, int kRT, int kThreads, typename TW, typename TC>
__device__ void dense(const float* __restrict__ A, int lda, int n, int k,
                      const TW* __restrict__ Wt, int m, const TW* __restrict__ bias,
                      TC* __restrict__ C, int ldc, float alpha) {
  if (kVec) {
    const int ncg = m >> 2, nrg = (n + kRT - 1) / kRT;
    for (int t = threadIdx.x; t < nrg * ncg; t += kThreads) {
      const int i0 = (t / ncg) * kRT, o = (t % ncg) * 4;
      const float* a_row[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) a_row[r] = A + (size_t)min(i0 + r, n - 1) * lda;
      float acc[kRT][4];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      const TW* w_ptr = Wt + o;
      for (int kk = 0; kk < k; kk += 4, w_ptr += 4 * (size_t)m) {
        float a[kRT][4];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(a_row[r] + kk);
          a[r][0] = v.x, a[r][1] = v.y, a[r][2] = v.z, a[r][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = ld_w4(w_ptr + (size_t)q * m);
#pragma unroll
          for (int r = 0; r < kRT; ++r) {
            acc[r][0] = fmaf(a[r][q], w.x, acc[r][0]);
            acc[r][1] = fmaf(a[r][q], w.y, acc[r][1]);
            acc[r][2] = fmaf(a[r][q], w.z, acc[r][2]);
            acc[r][3] = fmaf(a[r][q], w.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        if (i0 + r >= n) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          emit<kMode>(C + (size_t)(i0 + r) * ldc + o + c, acc[r][c] + ld_elem(bias + o + c), alpha);
      }
    }
  } else {
    for (int t = threadIdx.x; t < n * m; t += kThreads) {
      const int i = t / m, o = t - (t / m) * m;
      const float* a = A + (size_t)i * lda;
      float acc = 0.f;
      for (int kk = 0; kk < k; ++kk) acc = fmaf(a[kk], ld_elem(Wt + (size_t)kk * m + o), acc);
      emit<kMode>(C + (size_t)i * ldc + o, acc + ld_elem(bias + o), alpha);
    }
  }
}

// One head's attention for every query row: a warp per (row, head). Reads the q, k
// and v columns of qkv [n, ldq] and writes the output over the row's own q columns.
// kMaxJ * 32 >= n.
template <int kMaxJ, int kThreads, typename T>
__device__ void attention(float* qkv, int ldq, int n, int e, int heads,
                          const T* __restrict__ mask, float* pbuf, int ldp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = e / heads;
  const float inv_sqrt_hd = 1.f / sqrtf((float)hd);
  const bool vec = (hd & 3) == 0 && (e & 3) == 0;
  // the weighted sum over v: lanes = (sender part, column) when hd divides 32
  const int dl = (hd < 32 && 32 % hd == 0) ? hd : 32;
  const int parts = 32 / dl;
  constexpr int kWarps = kThreads / 32;
  float* p = pbuf + warp * ldp;
  GAPT_WARP_START();
  for (int pair = warp; pair < n * heads; pair += kWarps) {
    const int h = pair / n, i = pair - (pair / n) * n;
    const float* q = qkv + (size_t)i * ldq + h * hd;
    const float* kcol = qkv + e + h * hd;
    const float* vcol = qkv + 2 * e + h * hd;
    float s[kMaxJ];
    float mx = -FLT_MAX;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = jj * 32 + lane;
      s[jj] = -FLT_MAX;
      if (j < n) {
        const float* kr = kcol + (size_t)j * ldq;
        float acc = 0.f;
        if (vec) {
          for (int d = 0; d < hd; d += 4) {
            const float4 a = *reinterpret_cast<const float4*>(q + d);
            const float4 b = *reinterpret_cast<const float4*>(kr + d);
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
            acc = fmaf(a.z, b.z, acc);
            acc = fmaf(a.w, b.w, acc);
          }
        } else {
          for (int d = 0; d < hd; ++d) acc = fmaf(q[d], kr[d], acc);
        }
        acc *= inv_sqrt_hd;
        if (mask != nullptr) acc += (ld_elem(mask + j) - 1.f) * kNeg;
        s[jj] = acc;
        mx = fmaxf(mx, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = jj * 32 + lane;
      s[jj] = j < n ? expf(s[jj] - mx) : 0.f;
      sum += s[jj];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = jj * 32 + lane;
      if (j < n) p[j] = s[jj] / sum;
    }
    __syncwarp();
    GAPT_WARP_STAMP(kGaptScoreW);
    float* o = qkv + (size_t)i * ldq + h * hd;  // over the row's own q columns
    for (int d0 = 0; d0 < hd; d0 += dl) {
      const int d = d0 + lane % dl;
      float acc = 0.f;
      if (d < hd)
        for (int j = lane / dl; j < n; j += parts) acc = fmaf(p[j], vcol[(size_t)j * ldq + d], acc);
      for (int off = dl; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane < dl && d < hd) o[d] = acc;
    }
    __syncwarp();  // p is reused by the warp's next pair
    GAPT_WARP_STAMP(kGaptSumW);
  }
}

// The per-jet path. grid.x CTAs stride over the jets. Dynamic shared memory: x [n, ldx] and qkv
// [n, ldq] unless they live in `scratch` (x_global / qkv_global), then the warps'
// softmax rows [kThreads / 32, ldp]. T, W: float and Weights, or the bf16 mode's bf16
// and WeightsBf16.
template <int kMaxJ, int kThreads, int kRT, typename T, typename W>
__device__ __forceinline__ void gapt_jet_body(const T* __restrict__ x_in,
                                              const T* __restrict__ mask, T* __restrict__ out,
                                              W w, float* __restrict__ scratch, int batch,
                                              int n, int e, int heads, int layers, int feat,
                                              float alpha, int x_global, int qkv_global) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldx = e + 4, ldq = 3 * e + 4, ldp = (n + 31) / 32 * 32;
  float* my_scratch =
      scratch + (size_t)blockIdx.x * n * ((x_global ? ldx : 0) + (qkv_global ? ldq : 0));
  float* x = x_global ? my_scratch : smem;
  float* qkv = qkv_global ? my_scratch + (x_global ? (size_t)n * ldx : 0)
                          : smem + (x_global ? 0 : (size_t)n * ldx);
  float* pbuf = smem + (x_global ? 0 : (size_t)n * ldx) + (qkv_global ? 0 : (size_t)n * ldq);
  const bool vec = (e & 3) == 0;
  const int fdim = feat + (mask != nullptr ? 1 : 0);
  GAPT_CLOCK_START();

  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const T* xb = x_in + (size_t)b * n * e;
    const T* mb = mask != nullptr ? mask + (size_t)b * n : nullptr;
    for (int t = threadIdx.x; t < n * e; t += kThreads) {
      const int i = t / e;
      x[(size_t)i * ldx + (t - i * e)] = to_float(xb[t]);
    }
    __syncthreads();
    GAPT_STAMP(kGaptTail);
    for (int l = 0; l < layers; ++l) {
      const T* in_wt = w.in_wt + (size_t)l * e * 3 * e;
      const T* out_wt = w.out_wt + (size_t)l * e * e;
      const T* ff_wt = w.ff_wt + (size_t)l * e * e;
      const T* in_b = w.in_b + (size_t)l * 3 * e;
      const T* out_b = w.out_b + (size_t)l * e;
      const T* ff_b = w.ff_b + (size_t)l * e;
      if (vec)
        dense<kStore, true, kRT, kThreads>(x, ldx, n, e, in_wt, 3 * e, in_b, qkv, ldq, 0.f);
      else
        dense<kStore, false, kRT, kThreads>(x, ldx, n, e, in_wt, 3 * e, in_b, qkv, ldq, 0.f);
      __syncthreads();
      GAPT_STAMP(kGaptQkv);
      attention<kMaxJ, kThreads>(qkv, ldq, n, e, heads, mb, pbuf, ldp);
      __syncthreads();
      GAPT_STAMP(kGaptAttn);
      // x += attn . out_w^T + out_b; attn sits in the q columns
      if (vec)
        dense<kAccumulate, true, kRT, kThreads>(qkv, ldq, n, e, out_wt, e, out_b, x, ldx, 0.f);
      else
        dense<kAccumulate, false, kRT, kThreads>(qkv, ldq, n, e, out_wt, e, out_b, x, ldx, 0.f);
      __syncthreads();
      GAPT_STAMP(kGaptOut);
      // x += leaky(x . ff_w^T + ff_b), through the k columns
      if (vec)
        dense<kLeaky, true, kRT, kThreads>(x, ldx, n, e, ff_wt, e, ff_b, qkv + e, ldq, alpha);
      else
        dense<kLeaky, false, kRT, kThreads>(x, ldx, n, e, ff_wt, e, ff_b, qkv + e, ldq, alpha);
      __syncthreads();
      for (int t = threadIdx.x; t < n * e; t += kThreads) {
        const int i = t / e, c = t - (t / e) * e;
        x[(size_t)i * ldx + c] += qkv[(size_t)i * ldq + e + c];
      }
      __syncthreads();
      GAPT_STAMP(kGaptFf);
    }
    T* ob = out + (size_t)b * n * fdim;
    dense<kTanh, false, kRT, kThreads>(x, ldx, n, e, w.fc_wt, feat, w.fc_b, ob, fdim, 0.f);
    if (mb != nullptr)
      for (int i = threadIdx.x; i < n; i += kThreads)
        st_elem(ob + (size_t)i * fdim + feat, to_float(mb[i]) - 0.5f);
    __syncthreads();  // the next jet overwrites x
    GAPT_STAMP(kGaptFc);
  }
}

template <int kMaxJ, int kThreads, int kRT>
__global__ void __launch_bounds__(kThreads)
    gapt_jet_kernel(const float* __restrict__ x_in, const float* __restrict__ mask,
                      float* __restrict__ out, Weights w, float* __restrict__ scratch, int batch,
                      int n, int e, int heads, int layers, int feat, float alpha, int x_global,
                      int qkv_global) {
  gapt_jet_body<kMaxJ, kThreads, kRT>(x_in, mask, out, w, scratch, batch, n, e, heads, layers,
                                      feat, alpha, x_global, qkv_global);
}

template <int kMaxJ, int kThreads, int kRT>
__global__ void __launch_bounds__(kThreads)
    gapt_jet_kernel_bf16(const bf16* __restrict__ x_in, const bf16* __restrict__ mask,
                         bf16* __restrict__ out, WeightsBf16 w, float* __restrict__ scratch,
                         int batch, int n, int e, int heads, int layers, int feat, float alpha,
                         int x_global, int qkv_global) {
  gapt_jet_body<kMaxJ, kThreads, kRT>(x_in, mask, out, w, scratch, batch, n, e, heads, layers,
                                      feat, alpha, x_global, qkv_global);
}

struct Placement {
  size_t smem;     // dynamic shared memory bytes
  int x_global;    // x lives in the scratch
  int qkv_global;  // qkv lives in the scratch
};

// Threads of a CTA. Up to 32 particles a jet's buffers are small and several CTAs
// share an SM; larger jets have an SM to themselves (or nearly), so one CTA brings
// all the warps there are: 32 while the jet sits in shared memory, 16 (and twice the
// registers) where qkv goes through device memory.
int cta_threads(int n) { return n <= 32 ? 256 : n <= 160 ? 1024 : 512; }

// Keep x and qkv in shared memory if both fit, else x alone, else neither.
Placement place(int n, int e) {
  const size_t ldx = e + 4, ldq = 3 * e + 4, ldp = (n + 31) / 32 * 32;
  const size_t pbuf = (size_t)(cta_threads(n) / 32) * ldp * sizeof(float);
  const size_t xb = (size_t)n * ldx * sizeof(float), qb = (size_t)n * ldq * sizeof(float);
  if (pbuf + xb + qb <= (size_t)kMaxSmemBytes) return {pbuf + xb + qb, 0, 0};
  if (pbuf + xb <= (size_t)kMaxSmemBytes) return {pbuf + xb, 0, 1};
  return {pbuf, 1, 1};
}

template <int kMaxJ, int kThreads, int kRT, typename T, typename W>
int launch_jet(const T* x, const T* mask, T* out, const W& w, float* scratch, int batch, int n,
               int e, int heads, int layers, int feat, float alpha, const Placement& pl,
               int grid, void* stream) {
  auto* kernel = std::is_same<T, float>::value
                     ? reinterpret_cast<const void*>(gapt_jet_kernel<kMaxJ, kThreads, kRT>)
                     : reinterpret_cast<const void*>(gapt_jet_kernel_bf16<kMaxJ, kThreads, kRT>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x, &mask, &out, const_cast<W*>(&w), &scratch, &batch, &n, &e, &heads, &layers,
                  &feat, &alpha, const_cast<int*>(&pl.x_global),
                  const_cast<int*>(&pl.qkv_global)};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, pl.smem,
                         static_cast<cudaStream_t>(stream));
  return (int)err;
}


// ---------------------------------------------------------------------------
// The item path
// ---------------------------------------------------------------------------

constexpr int kMaxTn = 8;        // columns of a thread's product tile, at most
constexpr int kMaxHd = 32;       // head width the attention's registers hold, at most
constexpr int kChunk = 32;       // senders of an online-softmax chunk

// An item's layout and its products' thread grid. Offsets in floats.
struct ItemShape {
  int ns;         // a jet's row stride: n rounded up to 4
  int jets;       // jets an item
  int rows;       // the item's rows: jets * ns rounded up to 32
  int ldr;        // rows + 4
  int row_warps;  // rows / 32
  int ct;         // column threads of a product: 8 * (16 / row_warps)
  int slab;       // floats in each of the two weight slab buffers
  int off_qkv, off_mb, off_slab;
  size_t smem;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows of a product's k-slab: the slab's capacity in rows of M, evened out over the
// slabs that K takes.
__host__ __device__ __forceinline__ int slab_rows(int K, int M, int slab) {
  const int most = slab / M;
  return cdiv(K, cdiv(K, most));
}

// Fills the layout for `jets` jets of n particles in `rows` rows with slabs of
// `slab` floats; false where the item path does not run it.
bool item_shape(ItemShape& s, int n, int e, int heads, int jets, int rows, int slab) {
  s.ns = round_up(n, 4);
  s.jets = jets;
  s.rows = rows;
  if (e % 4 != 0 || e / heads > kMaxHd || jets < 1 || rows % 32 != 0 || rows > 512 ||
      jets * s.ns > rows || rows - jets * s.ns >= 32)
    return false;
  s.ldr = rows + 4;
  s.row_warps = rows / 32;
  s.ct = 8 * (kWarps / s.row_warps);
  s.slab = slab;
  if (cdiv(3 * e, s.ct) > kMaxTn || slab % 4 != 0 || slab < 12 * e) return false;
  s.off_qkv = e * s.ldr;
  s.off_mb = 4 * e * s.ldr;
  s.off_slab = s.off_mb + s.ldr;
  s.smem = (size_t)(s.off_slab + 2 * slab) * sizeof(float);
  return s.smem <= (size_t)kMaxSmemBytes;
}

enum ProductEpilogue {
  kEpiStoreT = 0,  // C[c][r] = acc + bias[c]
  kEpiAddT,        // C[c][r] += acc + bias[c]
  kEpiLeakyAddT    // C[c][r] += leaky(acc + bias[c])
};

// The next product's first slab, to start during this product's last one: its weights
// (float or bf16) and their count.
struct NextSlab {
  const void* w;
  int floats;
};

// Floats of a slab buffer that hold widened weights: all of it (float weights), or
// two thirds for bf16 weights, whose copy lands in the last third (half as many bytes)
// and is widened into the first two after it lands.
template <typename TW>
__host__ __device__ __forceinline__ int slab_room(int slab) {
  return std::is_same<TW, float>::value ? slab : 2 * slab / 3 / 8 * 8;
}

template <typename TW>
__device__ __forceinline__ NextSlab first_slab(const TW* w, int K, int M, int slab) {
  return NextSlab{w, slab_rows(K, M, slab_room<TW>(slab)) * M};
}

// Starts the copy of `n` weights (whole rows, a multiple of 4) into a slab buffer: float
// weights as they are, bf16 ones (8 bytes a thread at a time) into the buffer's last
// third, each thread's 4 values at t = 4 threadIdx.x (mod 4 kThreads).
__device__ __forceinline__ void stage_weights(float* buf, int slab, const float* src, int n) {
  stage_slab(buf, src, n);
}
__device__ __forceinline__ void stage_weights(float* buf, int slab, const bf16* src, int n) {
  bf16* dst = reinterpret_cast<bf16*>(buf + slab_room<bf16>(slab));
  for (int t = threadIdx.x * 4; t < n; t += kThreads * 4)
    __pipeline_memcpy_async(dst + t, src + t, 8);
  __pipeline_commit();
}

// The bf16 slab in `buf`'s last third widened into its first `n` floats, each thread
// its own 4 values of stage_weights: its copies have landed once it has waited for
// them, so the barrier after the wait, which the float slab needs anyway, is the only
// one. Nothing for float weights.
template <typename TW>
__device__ __forceinline__ void widen_slab(float* buf, int slab, int n) {
  if constexpr (!std::is_same<TW, float>::value) {
    const bf16* src = reinterpret_cast<const bf16*>(buf + slab_room<bf16>(slab));
    for (int t = threadIdx.x * 4; t < n; t += kThreads * 4)
      *reinterpret_cast<float4*>(buf + t) = widen4(*reinterpret_cast<const uint2*>(src + t));
  }
}

// The column of a thread's tile column j (of TN) on CT column threads: the first
// 4 * (TN / 4) as groups of 4 neighbouring columns, then a pair, then one, each
// group laid over all column threads, so that a k-step reads a thread's weights
// from a row-major slab with a 128-bit load a group of 4 and at most one 64-bit
// and one 32-bit load (edge_products.cuh packs its weights into that order; here
// the columns follow it).
template <int TN>
__device__ __forceinline__ int group_col(int j, int ct, int CT) {
  constexpr int n4 = TN / 4, n2 = (TN % 4) / 2;
  if (j < 4 * n4) return 4 * ((j / 4) * CT + ct) + j % 4;
  if (j < 4 * n4 + 2 * n2) return 4 * n4 * CT + 2 * ct + (j - 4 * n4);
  return (4 * n4 + 2 * n2) * CT + ct;
}

// acc = A [rows x K] . W [K x M] over the item's rows, then the epilogue into C;
// A and C transposed in shared memory ([K x ldr], [M x ldr]), W row-major in
// device memory, copied k-slab by k-slab into the two slab buffers. A thread
// holds 8 rows x TN columns: the warps form (rows / 32) x (16 / that) row and
// column groups, 4 row groups of 8 rows by 8 column threads a warp. `buf` holds
// (staged) or is to hold this product's first slab; `next`, if its w is not null,
// is started during the last slab. Returns the buffer of the slab after the last.
// The first slab's barrier makes the previous phase's writes visible; with
// in_place every thread's k loop ends before the epilogue, so C may be A. Ends
// without a barrier.
// TW: the weights' and bias's element type (bf16: each slab widened after it lands).
template <int TN, typename TW>
__device__ __forceinline__ int item_product_t(ItemShape sh, int a_off, int K,
                                              const TW* __restrict__ W, int M,
                                              const TW* __restrict__ bias, int c_off, int mode,
                                              float alpha, int buf, bool staged, NextSlab next,
                                              bool in_place) {
  constexpr int n4 = TN / 4, n2 = (TN % 4) / 2, n1 = TN % 2;
  const float* A = smf(a_off);
  float* C = smf(c_off);
  float* slabs = smf(sh.off_slab);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = sh.row_warps, CT = sh.ct, ldr = sh.ldr;
  const bool active = warp < rw * (kWarps / rw);
  const int r0 = (warp % rw) * 32 + (lane >> 3) * 8;
  const int ct = (warp / rw) * 8 + (lane & 7);
  const int ks = slab_rows(K, M, slab_room<TW>(sh.slab)), n_slab = cdiv(K, ks);
  // each group's offset in a slab row; a group past M reads column 0 instead (its
  // values are never stored)
  int o4[n4 > 0 ? n4 : 1], o2 = 0, o1 = 0;
#pragma unroll
  for (int q = 0; q < n4; ++q) {
    const int c = group_col<TN>(4 * q, ct, CT);
    o4[q] = c + 3 < M ? c : 0;
  }
  if (n2) {
    const int c = group_col<TN>(4 * n4, ct, CT);
    o2 = c + 1 < M ? c : 0;
  }
  if (n1) {
    const int c = group_col<TN>(TN - 1, ct, CT);
    o1 = c < M ? c : 0;
  }
  float acc[8][TN], bc[TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) bc[j] = ld_elem(bias + min(group_col<TN>(j, ct, CT), M - 1));

  if (!staged) {
    __syncthreads();  // the previous phase is done with the slab buffers
    stage_weights(slabs + buf * sh.slab, sh.slab, W, ks * M);
  }
  for (int s = 0; s < n_slab; ++s) {
    const int k0 = s * ks, ks_eff = min(ks, K - k0);
#ifdef MPGAN_PHASE_CLOCKS
    const long long t_wait = clock64();
#endif
    __pipeline_wait_prior(0);
    widen_slab<TW>(slabs + ((buf + s) & 1) * sh.slab, sh.slab, ks_eff * M);
    __syncthreads();  // slab s has landed (and is widened) for all; the other buffer is free
#ifdef MPGAN_PHASE_CLOCKS
    if (threadIdx.x == 0)
      atomicAdd(&g_gapt_clocks[kGaptWait], (unsigned long long)(clock64() - t_wait));
#endif
    float* other = slabs + ((buf + s + 1) & 1) * sh.slab;
    if (s + 1 < n_slab)
      stage_weights(other, sh.slab, W + (size_t)(k0 + ks) * M, min(ks, K - k0 - ks) * M);
    else if (next.w != nullptr)
      stage_weights(other, sh.slab, static_cast<const TW*>(next.w), next.floats);
    if (active) {
      const float* wrow = slabs + ((buf + s) & 1) * sh.slab;
      const float* ap = A + (size_t)k0 * ldr + r0;
#pragma unroll 4
      for (int kk = 0; kk < ks_eff; ++kk, ap += ldr, wrow += M) {
        const float4 a0 = *reinterpret_cast<const float4*>(ap);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float w[TN];
#pragma unroll
        for (int q = 0; q < n4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(wrow + o4[q]);
          w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
        }
        if constexpr (n2 > 0) {
          const float2 v = *reinterpret_cast<const float2*>(wrow + o2);
          w[4 * n4] = v.x, w[4 * n4 + 1] = v.y;
        }
        if constexpr (n1 > 0) w[TN - 1] = wrow[o1];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
  }
  if (in_place) __syncthreads();  // every thread is done with A, which C overwrites
  if (active) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = group_col<TN>(j, ct, CT);
      if (c >= M) continue;
#pragma unroll
      for (int i0 = 0; i0 < 8; i0 += 4) {
        float4* dst = reinterpret_cast<float4*>(C + (size_t)c * ldr + r0 + i0);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = acc[i0 + i][j] + bc[j];
        if (mode != kEpiStoreT) {
          const float4 p = *dst;
          const float old[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = old[i] + (mode == kEpiLeakyAddT ? leaky(v[i], alpha) : v[i]);
        }
        *dst = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  return (buf + n_slab) & 1;
}

template <int TN>
__device__ __noinline__ int item_product(ItemShape sh, int a_off, int K,
                                         const float* __restrict__ W, int M,
                                         const float* __restrict__ bias, int c_off, int mode,
                                         float alpha, int buf, bool staged, NextSlab next,
                                         bool in_place) {
  return item_product_t<TN>(sh, a_off, K, W, M, bias, c_off, mode, alpha, buf, staged, next,
                            in_place);
}

template <int TN>
__device__ __noinline__ int item_product_bf16(ItemShape sh, int a_off, int K,
                                              const bf16* __restrict__ W, int M,
                                              const bf16* __restrict__ bias, int c_off, int mode,
                                              float alpha, int buf, bool staged, NextSlab next,
                                              bool in_place) {
  return item_product_t<TN>(sh, a_off, K, W, M, bias, c_off, mode, alpha, buf, staged, next,
                            in_place);
}

// The product at the tile width its M needs on this item's rows (8 rows a thread;
// 4 x 4 tiles for the 64-wide projections read less of shared memory a FMA than
// 8 x 2, but ran slower on an H100, and a split-TF32 tensor-core form of the
// products was no faster: PERF.md).
template <typename TW>
__device__ int item_product_at(ItemShape sh, int a_off, int K, const TW* W, int M,
                               const TW* bias, int c_off, int mode, float alpha, int buf,
                               bool staged, NextSlab next) {
  const bool in_place = a_off == c_off;
#define MPGAN_ITEM_PRODUCT_CASE(TN)                                                            \
  case TN:                                                                                     \
    if constexpr (std::is_same<TW, float>::value)                                              \
      return item_product<TN>(sh, a_off, K, W, M, bias, c_off, mode, alpha, buf, staged, next, \
                              in_place);                                                       \
    else                                                                                       \
      return item_product_bf16<TN>(sh, a_off, K, W, M, bias, c_off, mode, alpha, buf, staged,  \
                                   next, in_place);
  switch (cdiv(M, sh.ct)) {
    MPGAN_ITEM_PRODUCT_CASE(1)
    MPGAN_ITEM_PRODUCT_CASE(2)
    MPGAN_ITEM_PRODUCT_CASE(3)
    MPGAN_ITEM_PRODUCT_CASE(4)
    MPGAN_ITEM_PRODUCT_CASE(5)
    MPGAN_ITEM_PRODUCT_CASE(6)
    MPGAN_ITEM_PRODUCT_CASE(7)
    MPGAN_ITEM_PRODUCT_CASE(8)
  }
#undef MPGAN_ITEM_PRODUCT_CASE
  return buf;
}

// One chunk of up to kChunk senders (c0 ...) for a lane's query row `ir`: its
// scores, the online softmax's running max m and sum l, and the weighted sum
// over v into acc. kExact: hd == kHd; kFull: the chunk holds kChunk senders, all
// inside the jet's rows. Fixed loop lengths let the compiler interleave the
// independent chains (a score per sender, a sum per column).
template <int kHd, bool kExact, bool kFull>
__device__ __forceinline__ void attend_chunk(const float* __restrict__ q,
                                             const float* __restrict__ kt,
                                             const float* __restrict__ vt,
                                             const float* __restrict__ mb, int ldr, int ir, int c0,
                                             int groups, int n, int hd, float scale, float& m,
                                             float& l, float (&acc)[kHd]) {
  GAPT_WARP_START();
  float sc[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) sc[j] = 0.f;
#pragma unroll
  for (int d = 0; d < kHd; ++d) {
    if (!kExact && d >= hd) break;
    const float qd = q[(size_t)d * ldr + ir];
    const float* kr = kt + (size_t)d * ldr + c0;
#pragma unroll
    for (int q4 = 0; q4 < kChunk / 4; ++q4) {
      if (!kFull && q4 >= groups) break;
      const float4 k4 = *reinterpret_cast<const float4*>(kr + 4 * q4);
      sc[4 * q4] = fmaf(qd, k4.x, sc[4 * q4]);
      sc[4 * q4 + 1] = fmaf(qd, k4.y, sc[4 * q4 + 1]);
      sc[4 * q4 + 2] = fmaf(qd, k4.z, sc[4 * q4 + 2]);
      sc[4 * q4 + 3] = fmaf(qd, k4.w, sc[4 * q4 + 3]);
    }
  }
  float cm = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (c0 + j < n) {
      sc[j] = sc[j] * scale + mb[c0 + j];
      cm = fmaxf(cm, sc[j]);
    }
  }
  const float mn = fmaxf(m, cm), corr = expf(m - mn);
  m = mn;
  l *= corr;
#pragma unroll
  for (int d = 0; d < kHd; ++d) acc[d] *= corr;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    sc[j] = c0 + j < n ? expf(sc[j] - m) : 0.f;
    l += sc[j];
  }
  GAPT_WARP_STAMP(kGaptScoreW);
#pragma unroll
  for (int q4 = 0; q4 < kChunk / 4; ++q4) {
    if (!kFull && q4 >= groups) break;
#pragma unroll
    for (int d = 0; d < kHd; ++d) {
      if (!kExact && d >= hd) break;
      const float4 v4 = *reinterpret_cast<const float4*>(vt + (size_t)d * ldr + c0 + 4 * q4);
      float a = fmaf(sc[4 * q4], v4.x, acc[d]);
      a = fmaf(sc[4 * q4 + 1], v4.y, a);
      a = fmaf(sc[4 * q4 + 2], v4.z, a);
      acc[d] = fmaf(sc[4 * q4 + 3], v4.w, a);
    }
  }
  GAPT_WARP_STAMP(kGaptSumW);
}

// Every (jet, head, 32 query rows) problem of the item: a warp a problem, a lane a
// query row. Scores of a chunk of 32 senders sit in the lane's registers, 4
// senders a 128-bit load that every lane shares; the softmax runs online over the
// chunks and the weighted sum accumulates in registers (kHd >= hd columns; kExact:
// hd == kHd). The output overwrites the row's own q columns, which no other lane
// reads.
template <int kHd, bool kExact>
__device__ __forceinline__ void item_attention_t(ItemShape sh, int n, int e, int heads) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = e / heads, ldr = sh.ldr, ns = sh.ns;
  const int qchunks = cdiv(n, 32);
  const float scale = 1.f / sqrtf((float)hd);
  for (int prob = warp; prob < sh.jets * heads * qchunks; prob += kWarps) {
    const int qc = prob % qchunks, h = (prob / qchunks) % heads, g = prob / (qchunks * heads);
    const int row0 = g * ns, i = qc * 32 + lane;
    const int ir = row0 + min(i, n - 1);
    float* q = smf(sh.off_qkv) + (size_t)h * hd * ldr;
    const float* kt = smf(sh.off_qkv) + (size_t)(e + h * hd) * ldr + row0;
    const float* vt = smf(sh.off_qkv) + (size_t)(2 * e + h * hd) * ldr + row0;
    const float* mb = smf(sh.off_mb) + row0;
    float acc[kHd];
#pragma unroll
    for (int d = 0; d < kHd; ++d) acc[d] = 0.f;
    float m = -FLT_MAX, l = 0.f;
    for (int c0 = 0; c0 < ns; c0 += kChunk) {
      const int groups = min(kChunk, ns - c0) / 4;  // of 4 senders, all inside the jet's rows
      if (groups == kChunk / 4)
        attend_chunk<kHd, kExact, true>(q, kt, vt, mb, ldr, ir, c0, groups, n, hd, scale, m, l,
                                        acc);
      else
        attend_chunk<kHd, kExact, false>(q, kt, vt, mb, ldr, ir, c0, groups, n, hd, scale, m, l,
                                         acc);
    }
    if (i < n) {
#pragma unroll
      for (int d = 0; d < kHd; ++d) {
        if (!kExact && d >= hd) break;
        q[(size_t)d * ldr + row0 + i] = acc[d] / l;
      }
    }
  }
}

// The attention as a function of its own, one for each mode's kernel (the bf16 one a
// copy, so that the FP32 kernel's code stays as it was).
template <int kHd, bool kExact>
__device__ __noinline__ void item_attention(ItemShape sh, int n, int e, int heads) {
  item_attention_t<kHd, kExact>(sh, n, e, heads);
}

template <int kHd, bool kExact>
__device__ __noinline__ void item_attention_bf16(ItemShape sh, int n, int e, int heads) {
  item_attention_t<kHd, kExact>(sh, n, e, heads);
}

template <int kHd, bool kExact, typename T>
__device__ __forceinline__ void item_attention_of(ItemShape sh, int n, int e, int heads) {
  if constexpr (std::is_same<T, float>::value)
    item_attention<kHd, kExact>(sh, n, e, heads);
  else
    item_attention_bf16<kHd, kExact>(sh, n, e, heads);
}

// The item path. grid CTAs (at most one an SM) each walk the contiguous range of
// items range_start gives. Dynamic shared memory as item_shape lays it out. T, W: float
// and Weights, or the bf16 mode's bf16 and WeightsBf16.
template <typename T, typename W>
__device__ __forceinline__ void gapt_item_body(const T* __restrict__ x_in,
                                               const T* __restrict__ mask, T* __restrict__ out,
                                               W w, ItemShape sh, int batch, int n, int e,
                                               int heads, int layers, int feat, float alpha) {
  const int ldr = sh.ldr, fdim = feat + (mask != nullptr ? 1 : 0);
  const long long items = cdiv(batch, sh.jets);
  const long long t_end = range_start(blockIdx.x + 1, items, gridDim.x);
  float* x = smf(0);
  float* mb = smf(sh.off_mb);
  const int M3 = 3 * e;
  int buf = 0;
  bool staged = false;
  GAPT_CLOCK_START();
  for (long long t = range_start(blockIdx.x, items, gridDim.x); t < t_end; ++t) {
    const long long b0 = t * sh.jets;
    // x^T and the senders' mask bias; rows past N or past the batch are zeros
    for (int q = threadIdx.x; q < sh.rows * e; q += kThreads) {
      const int r = q / e, c = q - r * e, g = r / sh.ns, i = r - g * sh.ns;
      const long long b = b0 + g;
      const bool real = g < sh.jets && i < n && b < batch;
      x[(size_t)c * ldr + r] = real ? ld_elem(x_in + ((size_t)b * n + i) * e + c) : 0.f;
    }
    for (int r = threadIdx.x; r < sh.rows; r += kThreads) {
      const int g = r / sh.ns, i = r - g * sh.ns;
      const long long b = b0 + g;
      const bool real = g < sh.jets && i < n && b < batch;
      mb[r] = real && mask != nullptr ? (ld_elem(mask + (size_t)b * n + i) - 1.f) * kNeg : 0.f;
    }
    GAPT_STAMP(kGaptTail);
    for (int l = 0; l < layers; ++l) {
      const T* in_wt = w.in_wt + (size_t)l * e * M3;
      const T* out_wt = w.out_wt + (size_t)l * e * e;
      const T* ff_wt = w.ff_wt + (size_t)l * e * e;
      // after the last layer's FF, the next item's first qkv slab, if there is one
      const bool more = l + 1 < layers || t + 1 < t_end;
      const NextSlab after_ff = more ? first_slab(l + 1 < layers ? in_wt + (size_t)e * M3 : w.in_wt,
                                                  e, M3, sh.slab)
                                     : NextSlab{nullptr, 0};
      buf = item_product_at(sh, 0, e, in_wt, M3, w.in_b + (size_t)l * M3, sh.off_qkv, kEpiStoreT,
                            0.f, buf, staged, first_slab(out_wt, e, e, sh.slab));
      GAPT_STAMP(kGaptQkv);
      __syncthreads();  // qkv is complete
      switch (e / heads) {
        case 16: item_attention_of<16, true, T>(sh, n, e, heads); break;
        case kMaxHd: item_attention_of<kMaxHd, true, T>(sh, n, e, heads); break;
        default:
          if (e / heads < 16)
            item_attention_of<16, false, T>(sh, n, e, heads);
          else
            item_attention_of<kMaxHd, false, T>(sh, n, e, heads);
      }
      GAPT_STAMP(kGaptAttn);
      // x += attn . out_w^T + out_b; attn sits in the q columns
      buf = item_product_at(sh, sh.off_qkv, e, out_wt, e, w.out_b + (size_t)l * e, 0, kEpiAddT,
                            0.f, buf, true, first_slab(ff_wt, e, e, sh.slab));
      GAPT_STAMP(kGaptOut);
      buf = item_product_at(sh, 0, e, ff_wt, e, w.ff_b + (size_t)l * e, 0, kEpiLeakyAddT, alpha,
                            buf, true, after_ff);
      GAPT_STAMP(kGaptFf);
      staged = more;
    }
    __syncthreads();  // x is final
    // y = tanh(x . fc_w^T + fc_b) and the mask column, for the real rows
    for (int q = threadIdx.x; q < sh.jets * n * fdim; q += kThreads) {
      const int g = q / (n * fdim), rem = q - g * n * fdim, i = rem / fdim, f = rem - i * fdim;
      const long long b = b0 + g;
      if (b >= batch) continue;
      const int r = g * sh.ns + i;
      float v;
      if (f < feat) {
        float a = 0.f;
        for (int k = 0; k < e; ++k)
          a = fmaf(x[(size_t)k * ldr + r], ld_elem(w.fc_wt + (size_t)k * feat + f), a);
        v = tanhf(a + ld_elem(w.fc_b + f));
      } else {
        v = ld_elem(mask + (size_t)b * n + i) - 0.5f;
      }
      st_elem(out + ((size_t)b * n + i) * fdim + f, v);
    }
    __syncthreads();  // the next item overwrites x
    GAPT_STAMP(kGaptFc);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    gapt_item_kernel(const float* __restrict__ x_in, const float* __restrict__ mask,
                     float* __restrict__ out, Weights w, ItemShape sh, int batch, int n, int e,
                     int heads, int layers, int feat, float alpha) {
  gapt_item_body(x_in, mask, out, w, sh, batch, n, e, heads, layers, feat, alpha);
}

__global__ void __launch_bounds__(kThreads, 1)
    gapt_item_kernel_bf16(const bf16* __restrict__ x_in, const bf16* __restrict__ mask,
                          bf16* __restrict__ out, WeightsBf16 w, ItemShape sh, int batch, int n,
                          int e, int heads, int layers, int feat, float alpha) {
  gapt_item_body(x_in, mask, out, w, sh, batch, n, e, heads, layers, feat, alpha);
}

template <typename T, typename W>
int launch_items(const T* x, const T* mask, T* out, const W& w, const ItemShape& sh, int batch,
                 int n, int e, int heads, int layers, int feat, float alpha, int grid,
                 void* stream) {
  const void* kernel = std::is_same<T, float>::value
                           ? reinterpret_cast<const void*>(gapt_item_kernel)
                           : reinterpret_cast<const void*>(gapt_item_kernel_bf16);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x, &mask, &out, const_cast<W*>(&w), const_cast<ItemShape*>(&sh), &batch, &n,
                  &e, &heads, &layers, &feat, &alpha};
  return (int)cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, sh.smem,
                               static_cast<cudaStream_t>(stream));
}

bool valid(int batch, int n, int e, int heads) {
  return batch >= 1 && n >= 1 && n <= 512 && e >= 1 && e <= 4096 && heads >= 1 && e % heads == 0;
}

int jet_plan(int batch, int n, int e, int* grid, long long* scratch_floats) {
  const Placement pl = place(n, e);
  *grid = pl.qkv_global ? (batch < kScratchCtas ? batch : kScratchCtas) : batch;
  *scratch_floats =
      (long long)*grid * n * ((pl.x_global ? e + 4 : 0) + (pl.qkv_global ? 3 * e + 4 : 0));
  return 0;
}

// Both modes' launch (T, W: float and Weights, or bf16 and WeightsBf16).
template <typename T, typename W>
int launch(const T* x, const T* mask, T* out, const W& w, float* scratch, int batch, int n,
           int e, int heads, int layers, int feat, float alpha, int jets, int rows,
           int grid_items, int slab_floats, void* stream) {
  if (!valid(batch, n, e, heads) || layers < 0 || feat < 1) return (int)cudaErrorInvalidValue;
  if (jets > 0) {
    ItemShape sh;
    if (!item_shape(sh, n, e, heads, jets, rows, slab_floats) || grid_items < 1 ||
        grid_items > cdiv(batch, jets))
      return (int)cudaErrorInvalidValue;
    return launch_items(x, mask, out, w, sh, batch, n, e, heads, layers, feat, alpha,
                        grid_items, stream);
  }
  const Placement pl = place(n, e);
  int grid;
  long long scratch_floats;
  jet_plan(batch, n, e, &grid, &scratch_floats);
  if (scratch_floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // scores a lane, threads (cta_threads) and rows of a thread's output tile: small
  // jets take 2 x 4 tiles, which fill the 256 threads evenly (240 tiles of the
  // out and ff products at n = 30 against 128 of 4 x 4)
  auto* fn = n <= 32 ? launch_jet<1, 256, 2, T, W>
                     : n <= 160 ? launch_jet<5, 1024, 4, T, W> : launch_jet<16, 512, 4, T, W>;
  return fn(x, mask, out, w, scratch, batch, n, e, heads, layers, feat, alpha, pl, grid, stream);
}

}  // namespace

extern "C" {

// The per-jet path: the CTAs a launch uses and the floats of device scratch it
// needs (0 when a jet's activations fit in shared memory). Returns 0, or cudaErrorInvalidValue.
int mpgan_gapt_fused_plan(int batch, int n, int e, int heads, int* grid,
                          long long* scratch_floats) {
  if (!valid(batch, n, e, heads)) return (int)cudaErrorInvalidValue;
  return jet_plan(batch, n, e, grid, scratch_floats);
}

// Shared memory (bytes) of an item-path launch for `jets` jets of n particles in
// `rows` rows with slabs of `slab_floats`, into *smem; -1 where the item path does
// not run it. Only the card tests call it, to hold gapt_kernels.gapt_plan to the
// launcher's layout.
int mpgan_gapt_item_smem(int n, int e, int heads, int jets, int rows, int slab_floats,
                         long long* smem) {
  ItemShape sh;
  if (n < 1 || n > 512 || heads < 1 || e % heads != 0 ||
      !item_shape(sh, n, e, heads, jets, rows, slab_floats))
    return -1;
  *smem = (long long)sh.smem;
  return 0;
}

// K9. x [batch, n, e]; mask [batch, n] (1 real, 0 padded) or null; out [batch, n,
// feat + (mask ? 1 : 0)]; weights transposed and stacked over layers as in Weights.
// With jets > 0 the item path runs the caller's plan (gapt_kernels.gapt_plan: jets
// an item, its rows, the grid, the slabs' floats), which is checked here; with
// jets == 0 the per-jet path, its scratch as mpgan_gapt_fused_plan sizes it (may be
// null when 0). Returns a cudaError_t code (0 on success); the launch is
// asynchronous on `stream`.
int mpgan_gapt_fused(const float* x, const float* mask, float* out, const float* in_wt,
                     const float* in_b, const float* out_wt, const float* out_b,
                     const float* ff_wt, const float* ff_b, const float* fc_wt,
                     const float* fc_b, float* scratch, int batch, int n, int e, int heads,
                     int layers, int feat, float alpha, int jets, int rows, int grid_items,
                     int slab_floats, void* stream) {
  return launch(x, mask, out, Weights{in_wt, in_b, out_wt, out_b, ff_wt, ff_b, fc_wt, fc_b},
                scratch, batch, n, e, heads, layers, feat, alpha, jets, rows, grid_items,
                slab_floats, stream);
}

// K9 in the bf16 mode: the same arguments as bf16 tensors (x, the mask, every weight
// and bias, out), the plan and the scratch as mpgan_gapt_fused's. The float32 body on
// their float32 values, the output rounded to bf16 (round to nearest even): bit for
// bit mpgan_gapt_fused on the widened inputs, its output rounded. Replaces, with the
// FP32 path, gapt_pallas.gapt_g_fused called with bf16 x (its wrapper widens the
// inputs before its pallas_call and rounds the output after).
int mpgan_gapt_fused_bf16(const bf16* x, const bf16* mask, bf16* out, const bf16* in_wt,
                          const bf16* in_b, const bf16* out_wt, const bf16* out_b,
                          const bf16* ff_wt, const bf16* ff_b, const bf16* fc_wt,
                          const bf16* fc_b, float* scratch, int batch, int n, int e, int heads,
                          int layers, int feat, float alpha, int jets, int rows, int grid_items,
                          int slab_floats, void* stream) {
  return launch(x, mask, out, WeightsBf16{in_wt, in_b, out_wt, out_b, ff_wt, ff_b, fc_wt, fc_b},
                scratch, batch, n, e, heads, layers, feat, alpha, jets, rows, grid_items,
                slab_floats, stream);
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (GaptPhase) since the last reset.
int mpgan_gapt_fused_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_gapt_clocks, sizeof(g_gapt_clocks));
  if (err == cudaSuccess && reset) {
    unsigned long long zeros[kGaptPhases] = {};
    err = cudaMemcpyToSymbol(g_gapt_clocks, zeros, sizeof(zeros));
  }
  return (int)err;
}
#endif

}  // extern "C"
