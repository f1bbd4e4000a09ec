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
// The design:
//   - the TPU kernel's jet-head packing (G = 128 / N jets in one block-diagonal
//     [G N, G N] attention, for its 128 x 128 matrix unit, and a batch divisible by
//     the block) is not carried over: a CTA owns one jet, any batch size runs, and
//     each head's attention is its own N x N problem;
//   - the jet's x [N, E] and qkv [N, 3E] stay in shared memory across all layers
//     (N * (4E + 8) * 4 bytes: 31 KB at N = 30, 155 KB at N = 150, E = 64), so several
//     jets share an SM at N = 30. The attention output overwrites the q columns of
//     its own row (only that row's warp reads them), the FF output goes through the
//     k columns. Where a jet does not fit (N > 206 at E = 64) qkv, and then x, live in
//     a per-CTA scratch in device memory (L2 resident) and the CTAs stride over the
//     jets: the same code through another pointer, so the whole gate N <= 512 runs;
//   - the weights (80 KB a layer at E = 64) do not fit beside the activations. They
//     arrive transposed ([in, out], stacked over layers) and are read through
//     L1/L2 with 16-byte loads, neighbouring threads on neighbouring columns; a
//     thread holds a 4 x 4 output tile, so 4 k-steps cost 4 weight loads and 4
//     broadcast activation loads for 64 FMAs (2 x 4 tiles up to 32 particles, where
//     4 x 4 would leave half the threads without a tile);
//   - 256 threads a CTA up to 32 particles (several CTAs an SM), 1024 where a jet
//     takes most of an SM's shared memory, 512 where qkv lives in device memory: on
//     an H100 at 700 W, N = 150 B = 512 ran in 8.6 ms with 256 threads, 5.3 with 512
//     and 4.3 with 1024; N = 30 B = 1024 in 0.84 ms with 4 x 4 tiles and 0.74 with 2 x 4;
//   - attention: a warp per (query row, head). Each lane holds the scores of its
//     senders j = lane, lane + 32, ... in registers (up to 16 at N = 512: no [N, N]
//     buffer), max and sum go through warp shuffles, the normalized weights through
//     a per-warp row of shared memory, and the weighted sum over v splits the lanes
//     into (sender part, column) so v is read along its rows;
//   - expf and tanhf, no fast-math forms, no tensor cores and no TF32: the result
//     holds 1e-4 against the plain PyTorch version.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kScratchCtas = 132 * 4;  // CTAs of a launch whose jets live in device memory
constexpr float kNeg = 1e30f;

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

enum Mode { kStore, kAccumulate, kLeaky, kTanh };

template <int kMode>
__device__ __forceinline__ void emit(float* c, float v, float alpha) {
  if (kMode == kStore) *c = v;
  if (kMode == kAccumulate) *c += v;
  if (kMode == kLeaky) *c = v >= 0.f ? v : alpha * v;
  if (kMode == kTanh) *c = tanhf(v);
}

// C[i, o] (mode) A[i, :] . Wt[:, o] + bias[o] for i < n, o < m; A [n, lda], Wt [k, m]
// row-major, C [n, ldc]. A and C must not overlap. With kVec, k and m are multiples
// of 4 and lda, the pointers of A and Wt are 16-byte aligned.
template <int kMode, bool kVec, int kRT, int kThreads>
__device__ void dense(const float* __restrict__ A, int lda, int n, int k,
                      const float* __restrict__ Wt, int m, const float* __restrict__ bias,
                      float* __restrict__ C, int ldc, float alpha) {
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
      const float* w_ptr = Wt + o;
      for (int kk = 0; kk < k; kk += 4, w_ptr += 4 * (size_t)m) {
        float a[kRT][4];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(a_row[r] + kk);
          a[r][0] = v.x, a[r][1] = v.y, a[r][2] = v.z, a[r][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(w_ptr + (size_t)q * m));
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
          emit<kMode>(C + (size_t)(i0 + r) * ldc + o + c, acc[r][c] + __ldg(bias + o + c), alpha);
      }
    }
  } else {
    for (int t = threadIdx.x; t < n * m; t += kThreads) {
      const int i = t / m, o = t - (t / m) * m;
      const float* a = A + (size_t)i * lda;
      float acc = 0.f;
      for (int kk = 0; kk < k; ++kk) acc = fmaf(a[kk], __ldg(Wt + (size_t)kk * m + o), acc);
      emit<kMode>(C + (size_t)i * ldc + o, acc + __ldg(bias + o), alpha);
    }
  }
}

// One head's attention for every query row: a warp per (row, head). Reads the q, k
// and v columns of qkv [n, ldq] and writes the output over the row's own q columns.
// kMaxJ * 32 >= n.
template <int kMaxJ, int kThreads>
__device__ void attention(float* qkv, int ldq, int n, int e, int heads,
                          const float* __restrict__ mask, float* pbuf, int ldp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = e / heads;
  const float inv_sqrt_hd = 1.f / sqrtf((float)hd);
  const bool vec = (hd & 3) == 0 && (e & 3) == 0;
  // the weighted sum over v: lanes = (sender part, column) when hd divides 32
  const int dl = (hd < 32 && 32 % hd == 0) ? hd : 32;
  const int parts = 32 / dl;
  constexpr int kWarps = kThreads / 32;
  float* p = pbuf + warp * ldp;
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
        if (mask != nullptr) acc += (__ldg(mask + j) - 1.f) * kNeg;
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
  }
}

// grid.x CTAs stride over the jets. Dynamic shared memory: x [n, ldx] and qkv
// [n, ldq] unless they live in `scratch` (x_global / qkv_global), then the warps'
// softmax rows [kThreads / 32, ldp].
template <int kMaxJ, int kThreads, int kRT>
__global__ void __launch_bounds__(kThreads)
    gapt_fused_kernel(const float* __restrict__ x_in, const float* __restrict__ mask,
                      float* __restrict__ out, Weights w, float* __restrict__ scratch, int batch,
                      int n, int e, int heads, int layers, int feat, float alpha, int x_global,
                      int qkv_global) {
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

  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const float* xb = x_in + (size_t)b * n * e;
    const float* mb = mask != nullptr ? mask + (size_t)b * n : nullptr;
    for (int t = threadIdx.x; t < n * e; t += kThreads) {
      const int i = t / e;
      x[(size_t)i * ldx + (t - i * e)] = xb[t];
    }
    __syncthreads();
    for (int l = 0; l < layers; ++l) {
      const float* in_wt = w.in_wt + (size_t)l * e * 3 * e;
      const float* out_wt = w.out_wt + (size_t)l * e * e;
      const float* ff_wt = w.ff_wt + (size_t)l * e * e;
      const float* in_b = w.in_b + (size_t)l * 3 * e;
      const float* out_b = w.out_b + (size_t)l * e;
      const float* ff_b = w.ff_b + (size_t)l * e;
      if (vec)
        dense<kStore, true, kRT, kThreads>(x, ldx, n, e, in_wt, 3 * e, in_b, qkv, ldq, 0.f);
      else
        dense<kStore, false, kRT, kThreads>(x, ldx, n, e, in_wt, 3 * e, in_b, qkv, ldq, 0.f);
      __syncthreads();
      attention<kMaxJ, kThreads>(qkv, ldq, n, e, heads, mb, pbuf, ldp);
      __syncthreads();
      // x += attn . out_w^T + out_b; attn sits in the q columns
      if (vec)
        dense<kAccumulate, true, kRT, kThreads>(qkv, ldq, n, e, out_wt, e, out_b, x, ldx, 0.f);
      else
        dense<kAccumulate, false, kRT, kThreads>(qkv, ldq, n, e, out_wt, e, out_b, x, ldx, 0.f);
      __syncthreads();
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
    }
    float* ob = out + (size_t)b * n * fdim;
    dense<kTanh, false, kRT, kThreads>(x, ldx, n, e, w.fc_wt, feat, w.fc_b, ob, fdim, 0.f);
    if (mb != nullptr)
      for (int i = threadIdx.x; i < n; i += kThreads) ob[(size_t)i * fdim + feat] = mb[i] - 0.5f;
    __syncthreads();  // the next jet overwrites x
  }
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

template <int kMaxJ, int kThreads, int kRT>
int launch(const float* x, const float* mask, float* out, const Weights& w, float* scratch,
           int batch, int n, int e, int heads, int layers, int feat, float alpha,
           const Placement& pl, int grid, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(gapt_fused_kernel<kMaxJ, kThreads, kRT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  gapt_fused_kernel<kMaxJ, kThreads, kRT>
      <<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
          x, mask, out, w, scratch, batch, n, e, heads, layers, feat, alpha, pl.x_global,
          pl.qkv_global);
  return (int)cudaGetLastError();
}

bool valid(int batch, int n, int e, int heads) {
  return batch >= 1 && n >= 1 && n <= 512 && e >= 1 && e <= 4096 && heads >= 1 && e % heads == 0;
}

}  // namespace

extern "C" {

// The CTAs a launch uses and the floats of device scratch it needs (0 when a jet's
// activations fit in shared memory). Returns 0, or cudaErrorInvalidValue.
int mpgan_gapt_fused_plan(int batch, int n, int e, int heads, int* grid,
                          long long* scratch_floats) {
  if (!valid(batch, n, e, heads)) return (int)cudaErrorInvalidValue;
  const Placement pl = place(n, e);
  *grid = pl.qkv_global ? (batch < kScratchCtas ? batch : kScratchCtas) : batch;
  *scratch_floats =
      (long long)*grid * n * ((pl.x_global ? e + 4 : 0) + (pl.qkv_global ? 3 * e + 4 : 0));
  return 0;
}

// K9. x [batch, n, e]; mask [batch, n] (1 real, 0 padded) or null; out [batch, n,
// feat + (mask ? 1 : 0)]; weights transposed and stacked over layers as in Weights;
// scratch as mpgan_gapt_fused_plan sizes it (may be null when 0). Returns a
// cudaError_t code (0 on success); the launch is asynchronous on `stream`.
int mpgan_gapt_fused(const float* x, const float* mask, float* out, const float* in_wt,
                     const float* in_b, const float* out_wt, const float* out_b,
                     const float* ff_wt, const float* ff_b, const float* fc_wt,
                     const float* fc_b, float* scratch, int batch, int n, int e, int heads,
                     int layers, int feat, float alpha, void* stream) {
  if (!valid(batch, n, e, heads) || layers < 0 || feat < 1) return (int)cudaErrorInvalidValue;
  const Placement pl = place(n, e);
  int grid;
  long long scratch_floats;
  mpgan_gapt_fused_plan(batch, n, e, heads, &grid, &scratch_floats);
  if (scratch_floats > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Weights w{in_wt, in_b, out_wt, out_b, ff_wt, ff_b, fc_wt, fc_b};
  // scores a lane, threads (cta_threads) and rows of a thread's output tile: small
  // jets take 2 x 4 tiles, which fill the 256 threads evenly (240 tiles of the
  // out and ff products at n = 30 against 128 of 4 x 4)
  auto* fn = n <= 32 ? launch<1, 256, 2> : n <= 160 ? launch<5, 1024, 4> : launch<16, 512, 4>;
  return fn(x, mask, out, w, scratch, batch, n, e, heads, layers, feat, alpha, pl, grid, stream);
}

}  // extern "C"
