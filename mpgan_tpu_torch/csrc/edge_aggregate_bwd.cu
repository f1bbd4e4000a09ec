// Backward of the dense message-passing edge aggregate for Hopper (sm_90a), FP32
// on CUDA cores.
//
// Replaces K3 of mpgan_tpu/ops/mp_pallas.py: _edge_aggregate_bwd_impl
// (_bwd_kernel_jets / _bwd_kernel), with the in-kernel dropout of K1 (_dropmul)
// replayed. Given the forward's inputs (u1, u2, mask, the hidden layers, the
// dropout seed) and g = dL/dagg, it returns
//   du1[b, i] = sum_j dz1[b, i, j],   du2[b, j] = sum_i dz1[b, i, j],
//   dmask[b, j] = sum_i sum_h g[b, i, h] * a_last[b, i, j, h],
//   dW_l = sum over pairs of a_{l-1}^T dz_l,   db_l = sum over pairs of dz_l,
// where g is divided by n for the mean, da_last = g[i] * mask[j], and per layer
// (last to first) dz = da * mult * dleaky(z), da_prev = dz W^T.
//
// What bounds it: per pair row it does three times the forward's FMAs (the
// recompute, dW and da), so like K2 it is bound by FP32 FMA issue and shared-
// memory operand loads. The design:
//   - the same CTA shape as K2: a CTA owns a group of up to 32 receivers of one
//     jet and walks it in passes of ti receivers x jc senders. A pass recomputes
//     the chain into shared memory, keeping every layer's activation a_l (after
//     dropout), then backprops through two ping-pong gradient buffers. At the
//     flagship widths a 64-row pass holds (96 + 160 + 192) activations and
//     (192 + 160) gradients per row: 218 KB of the 227 KB an SM offers. The
//     launcher sizes the pass from the shapes;
//   - the activation derivative is read off the stored activation instead of a
//     stored pre-activation: with 0 < alpha, a = leaky(z) * mult has the sign of
//     z where mult != 0, so mult * dleaky(z) = (a < 0 ? alpha : 1) * mult, and
//     mult is K1's hash, recomputed (cheap next to the matmuls). The wrapper
//     refuses alpha <= 0;
//   - sums across CTAs are deterministic: du1 rows belong to one CTA and are
//     accumulated in place; du2, dmask and the weight gradients go to per-CTA
//     partial buffers in device memory (first pass writes, later passes add,
//     each address always by the same thread, so in pass order), which a
//     second kernel reduces in a fixed order. Repeated runs are bit-identical.
//     The adds are fire-and-forget atomicAdds: waiting for the old partial
//     values cost more than the weight-gradient arithmetic (PERF.md);
//   - with need_wgrads = 0 (the G step differentiating through D) the weight
//     contractions are skipped and the caller's zero-filled gradients stay zero;
//   - da = dz W^T reads W^T ([out, in], prepared by the caller) through the same
//     register-tiled dense layer as the forward.

#include "edge_bwd_common.cuh"

namespace {

struct BwdPlan {
  int group, ti, jc, ldr;
  int d0, d1;  // widths of the two gradient buffers
};

// grid = (batch, number of receiver groups). Shared memory: the activations
// a_0..a_L ([dim_l x ldr] each), then the gradient buffers D0 [d0 x ldr] and
// D1 [d1 x ldr]. `fe_t` holds W^T for each hidden layer.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_bwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                              const float* __restrict__ mask, const float* __restrict__ g,
                              float* __restrict__ du1, float* __restrict__ du2_part,
                              float* __restrict__ dmask_part, float* __restrict__ w_part,
                              int n, int h1, BwdPlan p, Chain fe, Chain fe_t, float alpha,
                              int sum_agg, Drop drop, int need_wgrads, int w_total) {
  extern __shared__ float4 smem4[];
  float* acts[kMaxLayers + 1];
  float* cur = reinterpret_cast<float*>(smem4);
  for (int l = 0; l <= fe.n; ++l) {
    acts[l] = cur;
    cur += fe.dim[l] * p.ldr;
  }
  float* grad0 = cur;
  float* grad1 = cur + p.d0 * p.ldr;

  const int b = blockIdx.x, grp = blockIdx.y, n_grp = gridDim.y;
  const int g0 = grp * p.group;
  const int g_eff = min(p.group, n - g0);
  const int L = fe.n, h_out = fe.dim[L];
  const float* u1b = u1 + (size_t)b * n * h1;
  const float* u2b = u2 + (size_t)b * n * h1;
  const float* mb = mask + (size_t)b * n;
  const float* gb = g + (size_t)b * n * h_out;
  const float denom = sum_agg ? 1.f : (float)n;
  float* du2p = du2_part + ((size_t)b * n_grp + grp) * n * h1;
  float* dmaskp = dmask_part + ((size_t)b * n_grp + grp) * n;
  float* wp = w_part + ((size_t)b * n_grp + grp) * w_total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int ib = 0; ib < g_eff; ib += p.ti) {
    const int ti_eff = min(p.ti, g_eff - ib);
    const int rows = round_up(ti_eff * p.jc, kRowBlock);
    for (int j0 = 0; j0 < n; j0 += p.jc) {
      const int jc_eff = min(p.jc, n - j0);
      const bool first = ib == 0 && j0 == 0;
      if (kDrop) drop.base = (unsigned)(b * n + g0 + ib) * (unsigned)drop.ns + (unsigned)j0;
      __syncthreads();  // the previous pass has finished reading the buffers
      // recompute: layer 1 (decomposed), then the hidden layers, keeping every a_l
      for (int t = threadIdx.x; t < rows * h1; t += kThreads) {
        const int r = t / h1, h = t - (t / h1) * h1;
        const int ii = r / p.jc, jj = r - (r / p.jc) * p.jc;
        float v = 0.f;
        if (ii < ti_eff && jj < jc_eff) {
          v = leaky(u1b[(size_t)(g0 + ib + ii) * h1 + h] + u2b[(size_t)(j0 + jj) * h1 + h],
                    alpha);
          if (kDrop) v *= dropmul(drop, pair_id(drop, r), (unsigned)h, 0u);
        }
        acts[0][h * p.ldr + r] = v;
      }
      for (int l = 0; l < L; ++l) {
        __syncthreads();
        dense_layer<kDrop>(acts[l], p.ldr, acts[l + 1], p.ldr, rows, fe.dim[l], fe.dim[l + 1],
                           fe.w[l], nullptr, fe.dim[l], fe.b[l], true, alpha, drop,
                           (unsigned)(l + 1));
      }
      // da_L = g[i] * mask[j] / denom, zero on padded rows
      for (int t = threadIdx.x; t < rows * h_out; t += kThreads) {
        const int r = t / h_out, h = t - (t / h_out) * h_out;
        const int ii = r / p.jc, jj = r - (r / p.jc) * p.jc;
        float v = 0.f;
        if (ii < ti_eff && jj < jc_eff)
          v = gb[(size_t)(g0 + ib + ii) * h_out + h] / denom * mb[j0 + jj];
        grad0[h * p.ldr + r] = v;
      }
      __syncthreads();
      // dmask partial: one warp per sender
      for (int jj = warp; jj < jc_eff; jj += kWarps) {
        float acc = 0.f;
        for (int q = lane; q < ti_eff * h_out; q += 32) {
          const int ii = q / h_out, h = q - (q / h_out) * h_out;
          acc += gb[(size_t)(g0 + ib + ii) * h_out + h] / denom *
                 acts[L][h * p.ldr + ii * p.jc + jj];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) accumulate_to(dmaskp + j0 + jj, acc, ib == 0);
      }
      // back through the layers: dz_l = da_l * mult_l * dleaky(z_l) in place
      float* gcur = grad0;
      float* gnext = grad1;
      for (int l = L;; --l) {
        const int M = fe.dim[l];
        for (int t = threadIdx.x; t < M * rows; t += kThreads) {
          const int h = t / rows, r = t - (t / rows) * rows;
          const float a = acts[l][h * p.ldr + r];
          float f = a < 0.f ? alpha : 1.f;
          if (kDrop) f *= dropmul(drop, pair_id(drop, r), (unsigned)h, (unsigned)l);
          gcur[h * p.ldr + r] *= f;
        }
        __syncthreads();
        if (l == 0) break;
        const int K = fe.dim[l - 1];
        if (need_wgrads) {
          int off = 0;
          for (int k = 0; k < l - 1; ++k) off += fe.dim[k] * fe.dim[k + 1] + fe.dim[k + 1];
          weight_grad(acts[l - 1], gcur, p.ldr, rows, K, M, wp + off, wp + off + K * M, first);
        }
        // da_{l-1} = dz_l W^T
        dense_layer<false>(gcur, p.ldr, gnext, p.ldr, rows, M, K, fe_t.w[l - 1], nullptr, M,
                           nullptr, false, alpha, drop, 0u);
        __syncthreads();
        float* tmp = gcur;
        gcur = gnext;
        gnext = tmp;
      }
      // gcur holds dz_1 [h1 x rows]: du1 rows are this CTA's own, du2 goes to the partials
      for (int t = threadIdx.x; t < ti_eff * h1; t += kThreads) {
        const int ii = t / h1, h = t - (t / h1) * h1;
        const float* col = gcur + h * p.ldr + ii * p.jc;
        float acc = 0.f;
        for (int jj = 0; jj < jc_eff; ++jj) acc += col[jj];
        accumulate_to(du1 + ((size_t)b * n + g0 + ib + ii) * h1 + h, acc, j0 == 0);
      }
      for (int t = threadIdx.x; t < jc_eff * h1; t += kThreads) {
        const int jj = t / h1, h = t - (t / h1) * h1;
        const float* col = gcur + h * p.ldr + jj;
        float acc = 0.f;
        for (int ii = 0; ii < ti_eff; ++ii) acc += col[ii * p.jc];
        accumulate_to(du2p + (size_t)(j0 + jj) * h1 + h, acc, ib == 0);
      }
    }
  }
}

// The pass shape and buffer widths; shrinks the pass until the shared memory fits.
// Returns the bytes, or 0.
size_t make_bwd_plan(int n, const Chain& fe, BwdPlan& p) {
  p.group = group_size(n);
  int act_w = 0;
  for (int l = 0; l <= fe.n; ++l) act_w += fe.dim[l];
  // da of layer l lives in buffer (L - l) % 2
  p.d0 = p.d1 = 0;
  for (int l = 0; l <= fe.n; ++l) {
    int& w = ((fe.n - l) % 2 == 0) ? p.d0 : p.d1;
    w = fe.dim[l] > w ? fe.dim[l] : w;
  }
  for (int max_rows = kMaxPassRows; max_rows >= kRowBlock; max_rows -= kRowBlock) {
    choose_pass(n, p.group, max_rows, p.ti, p.jc);
    p.ldr = round_up(p.ti * p.jc, kRowBlock) + 4;
    const size_t bytes = (size_t)(act_w + p.d0 + p.d1) * p.ldr * sizeof(float);
    if (bytes <= (size_t)kMaxSmemBytes) return bytes;
  }
  return 0;
}

}  // namespace

extern "C" {

// Receiver groups per jet (grid.y of K2, K3 and K4): sizes the partial buffers.
int mpgan_edge_aggregate_groups(int n) { return n < 1 ? 0 : num_groups(n); }

// K3. hidden_w / hidden_wt / hidden_b: per hidden layer W [in, out], W^T [out, in], b.
// dhidden: 2 * n_hidden outputs (dW_l [in, out], db_l), left untouched without
// need_wgrads. Partials: du2_part [batch, groups, n, h1], dmask_part [batch, groups, n],
// w_part [batch * groups, sum_l (in_l * out_l + out_l)] (unused without need_wgrads).
int mpgan_edge_aggregate_bwd(const float* u1, const float* u2, const float* mask, const float* g,
                             float* du1, float* du2, float* dmask, void* const* dhidden,
                             float* du2_part, float* dmask_part, float* w_part, int batch, int n,
                             int h1, int n_hidden, const void* const* hidden_w,
                             const void* const* hidden_wt, const void* const* hidden_b,
                             const int* hidden_dims, float alpha, int sum_agg, int dropout,
                             int seed, unsigned thr, float mult, int need_wgrads, void* stream) {
  Chain fe, fe_t;
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth || !(alpha > 0.f) || seed < 0)
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  fe_t = fe;
  for (int l = 0; l < n_hidden; ++l) fe_t.w[l] = static_cast<const float*>(hidden_wt[l]);
  BwdPlan p;
  const size_t smem = make_bwd_plan(n, fe, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.seed_key = (unsigned)seed * 0xC2B2AE3Du;
  drop.thr = thr;
  drop.mult = mult;
  drop.jc = p.jc;
  drop.ns = round_up(n, 8);
  int w_total = 0;
  for (int l = 0; l < n_hidden; ++l) w_total += fe.dim[l] * fe.dim[l + 1] + fe.dim[l + 1];
  const int groups = num_groups(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch, groups);
  cudaError_t err;
  if (dropout) {
    err = cudaFuncSetAttribute(edge_aggregate_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    edge_aggregate_bwd_kernel<true><<<grid, kThreads, smem, st>>>(
        u1, u2, mask, g, du1, du2_part, dmask_part, w_part, n, h1, p, fe, fe_t, alpha, sum_agg,
        drop, need_wgrads, w_total);
  } else {
    err = cudaFuncSetAttribute(edge_aggregate_bwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    edge_aggregate_bwd_kernel<false><<<grid, kThreads, smem, st>>>(
        u1, u2, mask, g, du1, du2_part, dmask_part, w_part, n, h1, p, fe, fe_t, alpha, sum_agg,
        drop, need_wgrads, w_total);
  }
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  // second pass: the partials, summed in a fixed order
  code = launch_reduce(du2_part, du2, batch, groups, (long long)n * h1, (long long)n * h1,
                       (long long)groups * n * h1, st);
  if (code != 0) return code;
  code = launch_reduce(dmask_part, dmask, batch, groups, n, n, (long long)groups * n, st);
  if (code != 0 || !need_wgrads) return code;
  long long off = 0;
  for (int l = 0; l < n_hidden; ++l) {
    const long long km = (long long)fe.dim[l] * fe.dim[l + 1], m = fe.dim[l + 1];
    code = launch_reduce(w_part + off, static_cast<float*>(dhidden[2 * l]), 1, batch * groups,
                         km, w_total, 0, st);
    if (code != 0) return code;
    code = launch_reduce(w_part + off + km, static_cast<float*>(dhidden[2 * l + 1]), 1,
                         batch * groups, m, w_total, 0, st);
    if (code != 0) return code;
    off += km + m;
  }
  return 0;
}

}  // extern "C"
