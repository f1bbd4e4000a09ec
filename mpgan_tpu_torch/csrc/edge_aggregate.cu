// Dense message-passing edge aggregate for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py:
//   - K2 forward: edge_aggregate (_fwd_kernel_jets / _fwd_kernel), dropout_p = 0,
//   - K4: edge_aggregate_fn (_fwd_kernel_jets_fn / _fwd_kernel_fn / _fn_tail).
//
// For every jet b and receiver i
//   agg[b, i] = sum_j mask[b, j] * chain(leaky(u1[b, i] + u2[b, j]))    (/ n for mean)
// where `chain` is the fe MLP's hidden layers (LeakyReLU after each). The fe first
// layer arrives decomposed: u1 = x @ W1_recv and u2 = x @ W1_send + b1 are computed
// by the caller. K4 then runs the node MLP fn on [agg | x], its first layer read as
// two row segments (W1_top for agg, W1_bot for x) so the concat never leaves
// shared memory.
//
// What bounds it: the N^2 edge chain is ~166 MFLOP per 30-particle jet and
// ~4.1 GFLOP per 150-particle jet at the flagship widths, against ~1 KB of input
// per particle, so the kernel is bound by FP32 FMA issue if its operand loads keep
// up. The design:
//   - every edge activation stays in shared memory (never in device memory, like
//     the VMEM-resident TPU kernel). A CTA owns a group of up to 32 receivers of
//     one jet; it walks them in sub-blocks of `ti` and the senders in chunks of
//     `jc`, so each pass sends ti * jc pair rows through all fe layers in two
//     ping-pong buffers and reduces them into the group's aggregate in shared
//     memory. Nothing crosses CTAs: no atomics, no second pass;
//   - activations are stored transposed, act[feature][row], so a thread's 8 rows
//     at one k are two 128-bit shared loads; its 4 weight columns are one 128-bit
//     load through L1. A warp is 4 row groups x 8 column groups (a 32 x 32 tile),
//     so per k step it issues 3 load wavefronts for 32 FMAs per thread. The
//     k loop is unrolled 16 deep and a CTA runs 16 warps, so enough loads are in
//     flight to cover their latency (a sweep of warps and unroll depth on the H100
//     is in PERF.md);
//   - K4 runs fn on the whole group's rows at once;
//   - no tensor cores and no TF32, so results hold FP32 parity with the plain
//     version. There is no sender padding: the TPU's pad to 8 senders is a
//     sublane device.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowBlock = 32;      // rows of a warp tile: 4 row groups x 8 rows
constexpr int kColBlock = 32;      // columns of a warp tile: 8 column groups x 4 columns
constexpr int kMaxGroup = 32;      // receivers per CTA
constexpr int kMaxPassRows = 128;  // pair rows per pass through the chain
constexpr int kMaxSmemBytes = 227 * 1024;

struct Chain {
  const float* w[kMaxLayers];  // layer l weight, [dim[l], dim[l + 1]] row-major ([in, out])
  const float* b[kMaxLayers];  // layer l bias, [dim[l + 1]]
  int dim[kMaxLayers + 1];
  int n;                       // number of layers
  const float* w0_lo;          // layer 0 rows k >= k0_split (fn: the x rows); else unused
  int k0_split;                // layer 0 rows read from w[0]
  int act_last;                // last layer has an activation
};

struct Plan {
  int group;  // receivers per CTA
  int ti;     // receivers per pass
  int jc;     // senders per pass
  int ldr;    // row stride of the fe buffers (floats)
  int ldf;    // row stride of the fn buffers
  int buf0;   // floats in each ping-pong buffer
  int buf1;
};

__device__ __forceinline__ float leaky(float v, float alpha) { return v >= 0.f ? v : alpha * v; }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// acc[8 rows][4 cols] += A[r0:r0+8, k_begin:k_end] @ W[0:k_end-k_begin, c0:c0+4],
// with A stored transposed (A[k * lda + r]).
template <bool kVec>
__device__ __forceinline__ void accumulate(const float* __restrict__ A, int lda, int k_begin,
                                           int k_end, const float* __restrict__ W, int M, int r0,
                                           int c0, float (&acc)[8][4]) {
  const float* a_ptr = A + (size_t)k_begin * lda + r0;
  const float* w_ptr = W + c0;
#pragma unroll 16
  for (int k = k_begin; k < k_end; ++k, a_ptr += lda, w_ptr += M) {
    float w[4];
    if (kVec) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w_ptr));
      w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = (c0 + j < M) ? __ldg(w_ptr + j) : 0.f;
    }
    const float4 a0 = *reinterpret_cast<const float4*>(a_ptr);
    const float4 a1 = *reinterpret_cast<const float4*>(a_ptr + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// C = act(A @ W + bias) for `rows` rows, A [K features x lda] and C [M x ldc] stored
// transposed in shared memory. `rows` is a multiple of kRowBlock; rows k >= k_split
// of W come from W_lo.
__device__ void dense_layer(const float* __restrict__ A, int lda, float* __restrict__ C, int ldc,
                            int rows, int K, int M, const float* __restrict__ W,
                            const float* __restrict__ W_lo, int k_split,
                            const float* __restrict__ bias, bool act, float alpha) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrb = rows / kRowBlock, ncb = (M + kColBlock - 1) / kColBlock;
  const bool vec = (M & 3) == 0;
  for (int wb = warp; wb < nrb * ncb; wb += kWarps) {
    const int r0 = (wb / ncb) * kRowBlock + (lane >> 3) * 8;
    const int c0 = (wb % ncb) * kColBlock + (lane & 7) * 4;
    if (c0 >= M) continue;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (vec) {
      accumulate<true>(A, lda, 0, k_split, W, M, r0, c0, acc);
      if (k_split < K) accumulate<true>(A, lda, k_split, K, W_lo, M, r0, c0, acc);
    } else {
      accumulate<false>(A, lda, 0, k_split, W, M, r0, c0, acc);
      if (k_split < K) accumulate<false>(A, lda, k_split, K, W_lo, M, r0, c0, acc);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= M) break;
      const float bc = __ldg(bias + c);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = acc[i][j] + bc;
        if (act) v[i] = leaky(v[i], alpha);
      }
      float4* dst = reinterpret_cast<float4*>(C + (size_t)c * ldc + r0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// grid = (batch, number of receiver groups); dynamic shared memory holds the two
// ping-pong buffers and the group's aggregate [group, h_out].
template <bool kFuseFn>
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                          const float* __restrict__ mask, const float* __restrict__ x,
                          float* __restrict__ out, int n, int h1, int feat, Plan p, Chain fe,
                          Chain fn, float alpha, float fn_alpha, int sum_agg) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);
  float* buf1 = buf0 + p.buf0;
  float* agg = buf1 + p.buf1;  // [group, h_out]

  const int b = blockIdx.x;
  const int g0 = blockIdx.y * p.group;
  const int g_eff = min(p.group, n - g0);
  const int h_out = fe.dim[fe.n];
  const float* u1b = u1 + ((size_t)b * n + g0) * h1;
  const float* u2b = u2 + (size_t)b * n * h1;
  const float* mb = mask + (size_t)b * n;

  for (int t = threadIdx.x; t < g_eff * h_out; t += kThreads) agg[t] = 0.f;

  for (int ib = 0; ib < g_eff; ib += p.ti) {
    const int ti_eff = min(p.ti, g_eff - ib);
    const int rows = round_up(ti_eff * p.jc, kRowBlock);
    for (int j0 = 0; j0 < n; j0 += p.jc) {
      const int jc_eff = min(p.jc, n - j0);
      __syncthreads();  // the previous pass's reduction has finished reading the buffers
      // layer 1, decomposed; row r = (receiver ii, sender jj); h fastest for coalesced reads
      for (int t = threadIdx.x; t < rows * h1; t += kThreads) {
        const int r = t / h1, h = t - (t / h1) * h1;
        const int ii = r / p.jc, jj = r - (r / p.jc) * p.jc;
        float v = 0.f;
        if (ii < ti_eff && jj < jc_eff)
          v = leaky(u1b[(size_t)(ib + ii) * h1 + h] + u2b[(size_t)(j0 + jj) * h1 + h], alpha);
        buf0[h * p.ldr + r] = v;
      }
      float* src = buf0;
      float* dst = buf1;
      for (int l = 0; l < fe.n; ++l) {
        __syncthreads();
        const int K = fe.dim[l], M = fe.dim[l + 1];
        dense_layer(src, p.ldr, dst, p.ldr, rows, K, M, fe.w[l], nullptr, K, fe.b[l], true,
                    alpha);
        float* tmp = src;
        src = dst;
        dst = tmp;
      }
      __syncthreads();
      // masked sum over this pass's senders
      for (int t = threadIdx.x; t < ti_eff * h_out; t += kThreads) {
        const int ii = t / h_out, h = t - (t / h_out) * h_out;
        const float* col = src + h * p.ldr + ii * p.jc;
        float acc = 0.f;
        for (int jj = 0; jj < jc_eff; ++jj) acc = fmaf(__ldg(mb + j0 + jj), col[jj], acc);
        agg[(ib + ii) * h_out + h] += acc;
      }
    }
  }
  __syncthreads();
  const float denom = sum_agg ? 1.f : (float)n;  // the mean divides by the true n

  if (!kFuseFn) {
    for (int t = threadIdx.x; t < g_eff * h_out; t += kThreads) {
      const int r = t / h_out, h = t - (t / h_out) * h_out;
      out[((size_t)b * n + g0 + r) * h_out + h] = agg[t] / denom;
    }
    return;
  }

  // node MLP on the group's receivers; input row = [agg | x], stored transposed
  const int fn_rows = round_up(g_eff, kRowBlock);
  const int k_in = h_out + feat;
  for (int t = threadIdx.x; t < fn_rows * k_in; t += kThreads) {
    const int r = t / k_in, c = t - (t / k_in) * k_in;
    float v = 0.f;
    if (r < g_eff)
      v = c < h_out ? agg[r * h_out + c] / denom
                    : x[((size_t)b * n + g0 + r) * feat + (c - h_out)];
    buf0[c * p.ldf + r] = v;
  }
  float* src = buf0;
  float* dst = buf1;
  for (int l = 0; l < fn.n; ++l) {
    __syncthreads();
    const int K = fn.dim[l], M = fn.dim[l + 1];
    const bool act = l < fn.n - 1 || fn.act_last;
    dense_layer(src, p.ldf, dst, p.ldf, fn_rows, K, M, fn.w[l], l == 0 ? fn.w0_lo : nullptr,
                l == 0 ? fn.k0_split : K, fn.b[l], act, fn_alpha);
    float* tmp = src;
    src = dst;
    dst = tmp;
  }
  __syncthreads();
  const int f_out = fn.dim[fn.n];
  for (int t = threadIdx.x; t < g_eff * f_out; t += kThreads) {
    const int r = t / f_out, c = t - (t / f_out) * f_out;
    out[((size_t)b * n + g0 + r) * f_out + c] = src[c * p.ldf + r];
  }
}

bool fill_chain(Chain& c, int n_layers, const void* const* w, const void* const* b,
                const int* dims) {
  if (n_layers < 0 || n_layers > kMaxLayers) return false;
  c = Chain{};
  c.n = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return false;
    c.dim[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    c.w[l] = static_cast<const float*>(w[l]);
    c.b[l] = static_cast<const float*>(b[l]);
  }
  c.k0_split = n_layers > 0 ? dims[0] : 0;
  c.act_last = 1;
  return true;
}

// Widest layer a chain keeps in each ping-pong buffer (even and odd positions).
void chain_widths(const Chain& c, int& even, int& odd) {
  for (int l = 0; l <= c.n; ++l) {
    int& w = (l % 2 == 0) ? even : odd;
    w = c.dim[l] > w ? c.dim[l] : w;
  }
}

// Padded pair rows that one receiver group of `g` costs over `n` senders.
long long pass_rows_total(int g, int n, int ti, int jc) {
  long long rows = 0;
  for (int ib = 0; ib < g; ib += ti) {
    const int te = g - ib < ti ? g - ib : ti;
    rows += round_up(te * jc, kRowBlock);
  }
  return rows * ((n + jc - 1) / jc);
}

// Choose the receiver group, the pass shape (fewest padded rows) and the buffer
// sizes; shrink the pass until the shared memory fits. Returns the bytes, or 0.
size_t make_plan(int n, const Chain& fe, const Chain* fn, Plan& p) {
  const int n_groups = (n + kMaxGroup - 1) / kMaxGroup;
  p.group = (n + n_groups - 1) / n_groups;
  p.ldf = round_up(p.group, kRowBlock) + 4;
  const int h_out = fe.dim[fe.n];
  for (int max_rows = kMaxPassRows; max_rows >= kRowBlock; max_rows -= kRowBlock) {
    long long best = -1;
    int best_ti = 0, best_jc = 0;
    for (int jc = 1; jc <= n && jc <= max_rows; ++jc) {
      for (int ti = 1; ti <= p.group && ti * jc <= max_rows; ++ti) {
        const long long cost = pass_rows_total(p.group, n, ti, jc);
        if (best < 0 || cost < best || (cost == best && ti * jc > best_ti * best_jc)) {
          best = cost;
          best_ti = ti;
          best_jc = jc;
        }
      }
    }
    p.ti = best_ti;
    p.jc = best_jc;
    // stride = rows + 4 floats: 16-byte aligned rows, and column walks spread over banks
    p.ldr = round_up(best_ti * best_jc, kRowBlock) + 4;
    int fe_even = 0, fe_odd = 0;
    chain_widths(fe, fe_even, fe_odd);
    p.buf0 = fe_even * p.ldr;
    p.buf1 = fe_odd * p.ldr;
    if (fn != nullptr) {
      int fn_even = 0, fn_odd = 0;
      chain_widths(*fn, fn_even, fn_odd);
      p.buf0 = fn_even * p.ldf > p.buf0 ? fn_even * p.ldf : p.buf0;
      p.buf1 = fn_odd * p.ldf > p.buf1 ? fn_odd * p.ldf : p.buf1;
    }
    const size_t bytes = (size_t)(p.buf0 + p.buf1 + p.group * h_out) * sizeof(float);
    if (bytes <= (size_t)kMaxSmemBytes) return bytes;
  }
  return 0;
}

template <bool kFuseFn>
int launch(const float* u1, const float* u2, const float* mask, const float* x, float* out,
           int batch, int n, int h1, int feat, const Chain& fe, const Chain& fn, float alpha,
           float fn_alpha, int sum_agg, void* stream) {
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth) return (int)cudaErrorInvalidValue;
  Plan p;
  const size_t smem = make_plan(n, fe, kFuseFn ? &fn : nullptr, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_aggregate_kernel<kFuseFn>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (n + p.group - 1) / p.group);
  edge_aggregate_kernel<kFuseFn><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u1, u2, mask, x, out, n, h1, feat, p, fe, fn, alpha, fn_alpha, sum_agg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 forward. hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1.
// Returns a cudaError_t code (0 on success); the launch is asynchronous on `stream`.
int mpgan_edge_aggregate(const float* u1, const float* u2, const float* mask, float* out,
                         int batch, int n, int h1, int n_hidden, const void* const* hidden_w,
                         const void* const* hidden_b, const int* hidden_dims, float alpha,
                         int sum_agg, void* stream) {
  Chain fe, fn;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  fn = Chain{};
  return launch<false>(u1, u2, mask, nullptr, out, batch, n, h1, 0, fe, fn, alpha, 0.f, sum_agg,
                       stream);
}

// K4. fn_w[0] is fn's first-layer weight rows for agg ([h_out, dims[1]]), fn_w0_lo its rows
// for x ([feat, dims[1]]); fn_dims has n_fn + 1 entries, fn_dims[0] == h_out + feat.
int mpgan_edge_aggregate_fn(const float* u1, const float* u2, const float* mask, const float* x,
                            float* out, int batch, int n, int h1, int feat, int n_hidden,
                            const void* const* hidden_w, const void* const* hidden_b,
                            const int* hidden_dims, int n_fn, const void* const* fn_w,
                            const void* fn_w0_lo, const void* const* fn_b, const int* fn_dims,
                            float alpha, int sum_agg, float fn_alpha, int fn_act_last,
                            void* stream) {
  Chain fe, fn;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  if (n_fn < 1 || !fill_chain(fn, n_fn, fn_w, fn_b, fn_dims)) return (int)cudaErrorInvalidValue;
  const int h_out = fe.dim[fe.n];
  if (feat < 1 || fn.dim[0] != h_out + feat) return (int)cudaErrorInvalidValue;
  fn.w0_lo = static_cast<const float*>(fn_w0_lo);
  fn.k0_split = h_out;
  fn.act_last = fn_act_last;
  return launch<true>(u1, u2, mask, x, out, batch, n, h1, feat, fe, fn, alpha, fn_alpha, sum_agg,
                      stream);
}

const char* mpgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
