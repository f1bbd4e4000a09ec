// Dense message-passing edge aggregate for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py:
//   - K2 forward: edge_aggregate (_fwd_kernel_jets / _fwd_kernel), with K1, the
//     in-kernel dropout hash (_dropmul), in train mode,
//   - K4: edge_aggregate_fn (_fwd_kernel_jets_fn / _fwd_kernel_fn / _fn_tail).
// The backward, K3, is in edge_aggregate_bwd.cu; the shared pieces are in
// edge_common.cuh.
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
//   - train mode (kDrop) multiplies each activation by K1's multiplier after
//     layer 1's LeakyReLU (salt 0) and after hidden layer k (salt k), keyed on
//     the global pair id, so K3 replays the same masks. The eval instantiation
//     has no hash code in it;
//   - no tensor cores and no TF32, so results hold FP32 parity with the plain
//     version. There is no sender padding: the TPU's pad to 8 senders is a
//     sublane device.

#include "edge_common.cuh"

namespace {

// grid = (batch, number of receiver groups); dynamic shared memory holds the two
// ping-pong buffers and the group's aggregate [group, h_out].
template <bool kFuseFn, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                          const float* __restrict__ mask, const float* __restrict__ x,
                          float* __restrict__ out, int n, int h1, int feat, Plan p, Chain fe,
                          Chain fn, float alpha, float fn_alpha, int sum_agg, Drop drop) {
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
      if (kDrop) drop.base = (unsigned)(b * n + g0 + ib) * (unsigned)drop.ns + (unsigned)j0;
      __syncthreads();  // the previous pass's reduction has finished reading the buffers
      // layer 1, decomposed; row r = (receiver ii, sender jj); h fastest for coalesced reads
      for (int t = threadIdx.x; t < rows * h1; t += kThreads) {
        const int r = t / h1, h = t - (t / h1) * h1;
        const int ii = r / p.jc, jj = r - (r / p.jc) * p.jc;
        float v = 0.f;
        if (ii < ti_eff && jj < jc_eff) {
          v = leaky(u1b[(size_t)(ib + ii) * h1 + h] + u2b[(size_t)(j0 + jj) * h1 + h], alpha);
          if (kDrop) v *= dropmul(drop, pair_id(drop, r), (unsigned)h, 0u);
        }
        buf0[h * p.ldr + r] = v;
      }
      float* src = buf0;
      float* dst = buf1;
      for (int l = 0; l < fe.n; ++l) {
        __syncthreads();
        const int K = fe.dim[l], M = fe.dim[l + 1];
        dense_layer<kDrop>(src, p.ldr, dst, p.ldr, rows, K, M, fe.w[l], nullptr, K, fe.b[l], true,
                           alpha, drop, (unsigned)(l + 1));
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
    dense_layer<false>(src, p.ldf, dst, p.ldf, fn_rows, K, M, fn.w[l],
                       l == 0 ? fn.w0_lo : nullptr, l == 0 ? fn.k0_split : K, fn.b[l], act,
                       fn_alpha, drop, 0u);
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

// Widest layer a chain keeps in each ping-pong buffer (even and odd positions).
void chain_widths(const Chain& c, int& even, int& odd) {
  for (int l = 0; l <= c.n; ++l) {
    int& w = (l % 2 == 0) ? even : odd;
    w = c.dim[l] > w ? c.dim[l] : w;
  }
}

// Choose the receiver group, the pass shape (fewest padded rows) and the buffer
// sizes; shrink the pass until the shared memory fits. Returns the bytes, or 0.
size_t make_plan(int n, const Chain& fe, const Chain* fn, Plan& p) {
  p.group = group_size(n);
  p.ldf = round_up(p.group, kRowBlock) + 4;
  const int h_out = fe.dim[fe.n];
  for (int max_rows = kMaxPassRows; max_rows >= kRowBlock; max_rows -= kRowBlock) {
    choose_pass(n, p.group, max_rows, p.ti, p.jc);
    // stride = rows + 4 floats: 16-byte aligned rows, and column walks spread over banks
    p.ldr = round_up(p.ti * p.jc, kRowBlock) + 4;
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

template <bool kFuseFn, bool kDrop>
int launch(const float* u1, const float* u2, const float* mask, const float* x, float* out,
           int batch, int n, int h1, int feat, const Chain& fe, const Chain& fn, float alpha,
           float fn_alpha, int sum_agg, Drop drop, void* stream) {
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth) return (int)cudaErrorInvalidValue;
  Plan p;
  const size_t smem = make_plan(n, fe, kFuseFn ? &fn : nullptr, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_aggregate_kernel<kFuseFn, kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  drop.jc = p.jc;
  drop.ns = round_up(n, 8);
  const dim3 grid(batch, (n + p.group - 1) / p.group);
  edge_aggregate_kernel<kFuseFn, kDrop>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          u1, u2, mask, x, out, n, h1, feat, p, fe, fn, alpha, fn_alpha, sum_agg, drop);
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
  return launch<false, false>(u1, u2, mask, nullptr, out, batch, n, h1, 0, fe, fn, alpha, 0.f,
                              sum_agg, Drop{}, stream);
}

// K2 forward in train mode, with K1 dropout: seed in [0, 2^31), keep threshold
// `thr` and multiplier `mult` as computed on the host (see Drop).
int mpgan_edge_aggregate_train(const float* u1, const float* u2, const float* mask, float* out,
                               int batch, int n, int h1, int n_hidden,
                               const void* const* hidden_w, const void* const* hidden_b,
                               const int* hidden_dims, float alpha, int sum_agg, int seed,
                               unsigned thr, float mult, void* stream) {
  Chain fe, fn;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1 || seed < 0)
    return (int)cudaErrorInvalidValue;
  fn = Chain{};
  Drop drop{};
  drop.seed_key = (unsigned)seed * 0xC2B2AE3Du;
  drop.thr = thr;
  drop.mult = mult;
  return launch<false, true>(u1, u2, mask, nullptr, out, batch, n, h1, 0, fe, fn, alpha, 0.f,
                             sum_agg, drop, stream);
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
  return launch<true, false>(u1, u2, mask, x, out, batch, n, h1, feat, fe, fn, alpha, fn_alpha,
                             sum_agg, Drop{}, stream);
}

const char* mpgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
