// Backward of the fused knn message-passing edge stage for Hopper (sm_90a), FP32
// on CUDA cores.
//
// Replaces K6 of mpgan_tpu/ops/knn_pallas.py: _bwd_impl_v3 (_bwd_kernel_v3), with
// the in-kernel dropout of K1 (mp_pallas._dropmul) replayed. Given the forward's
// operands (u1, u2m = [u2 | mask], the hidden layers, w_d, the dropout seed), its
// residuals idx [B, N, k] (and dists) and g = dL/dagg, it returns
//   du1[b, i]        = sum_s dz1[b, i, s],
//   du2[b, j]        = sum over the edges (i, s) with idx[b, i, s] = j of dz1[b, i, s],
//   dmask[b, j]      = the same sum of sum_h g[b, i, h] * a_last[b, i, s, h],
//   ddists[b, i, s]  = sum_h dz1[b, i, s, h] * w_d[h],   dw_d = sum of dist * dz1,
//   dW_l = sum over edges of a_{l-1}^T dz_l,   db_l = sum over edges of dz_l,
// where g is divided by k for the mean, da_last = g[i] * mask[idx[i, s]], and per
// layer (last to first) dz = da * mult * dleaky(z), da_prev = dz W^T.
//
// What bounds it: per edge row it does three times the forward chain's FMAs (the
// recompute, dW and da), so like K3 it is bound by FP32 FMA issue and shared-
// memory operand loads. The design:
//   - the same CTA shape as K5: a CTA owns a group of up to 32 receivers of one
//     jet and walks its edges in passes of ti receivers x kc ranks. A pass gathers
//     its rows' senders from idx, recomputes the chain into shared memory keeping
//     every layer's activation, then backprops through two ping-pong gradient
//     buffers, exactly as K3 does (the derivative is read off the stored
//     activation, so the wrapper refuses alpha <= 0; layer 1's dist * w_d term is
//     rounded as the plain version rounds it, product and sum apart, because a
//     pre-activation that lands on the other side of zero takes the other slope
//     and moves that edge's whole gradient). At the published widths a
//     64-row pass holds (96 + 160 + 192) activations and (192 + 160) gradients per
//     row, 218 KB; the launcher sizes the pass from the shapes;
//   - du1 and ddists rows belong to one CTA and are written in place;
//   - the scatter into the senders is deterministic. The group's du2 [n, h1] does
//     not fit in shared memory beside the pass, so du2 and dmask go to per-CTA
//     partial slabs in device memory, zeroed by the caller. Within a CTA the
//     column h of every sender row is added by one thread (thread h), walking the
//     pass's rows in order, pass after pass; dmask by one other thread. Adds to
//     one address from one thread land in program order, so each partial is the
//     same sum, bit for bit, on every run, and the adds are fire-and-forget
//     atomicAdds that nobody waits for. A second kernel reduces the slabs over the
//     groups in a fixed order;
//   - the weight gradients (and dw_d) cross jets: per-CTA partials, first pass
//     writes and later passes add, reduced in a fixed order, as in K3. With
//     need_wgrads = 0 (the G step differentiating through D) the contractions are
//     skipped and the caller's zero-filled gradients stay zero.

#include "edge_bwd_common.cuh"

namespace {

struct KnnBwdPlan {
  int group, ti, kc, ldr;
  int d0, d1;  // widths of the two gradient buffers
};

// grid = (batch, number of receiver groups). Shared memory: the activations
// a_0..a_L ([dim_l x ldr] each), the gradient buffers D0 [d0 x ldr] and D1
// [d1 x ldr], then per pass row: the sender (-1 on padded rows), its mask, the
// edge's distance, and dsmask. `fe_t` holds W^T for each hidden layer.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    knn_edge_bwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2m,
                        const int* __restrict__ idx, const float* __restrict__ dists,
                        const float* __restrict__ w_d, const float* __restrict__ g,
                        float* __restrict__ du1, float* __restrict__ ddists,
                        float* __restrict__ du2_part, float* __restrict__ dmask_part,
                        float* __restrict__ w_part, int n, int h1, int k, KnnBwdPlan p, Chain fe,
                        Chain fe_t, float alpha, int sum_agg, Drop drop, int need_wgrads,
                        int w_total) {
  extern __shared__ float4 smem4[];
  float* acts[kMaxLayers + 1];
  float* cur = reinterpret_cast<float*>(smem4);
  for (int l = 0; l <= fe.n; ++l) {
    acts[l] = cur;
    cur += fe.dim[l] * p.ldr;
  }
  float* grad0 = cur;
  float* grad1 = cur + p.d0 * p.ldr;
  float* smask = grad1 + p.d1 * p.ldr;  // [ldr]
  float* rdist = smask + p.ldr;         // [ldr]
  float* dsm = rdist + p.ldr;           // [ldr]
  int* rowj = reinterpret_cast<int*>(dsm + p.ldr);  // [ldr]

  const int b = blockIdx.x, grp = blockIdx.y, n_grp = gridDim.y;
  const int g0 = grp * p.group;
  const int g_eff = min(p.group, n - g0);
  const int L = fe.n, h_out = fe.dim[L];
  const bool want_dists = dists != nullptr;
  const float* u1b = u1 + (size_t)b * n * h1;
  const float* u2mb = u2m + (size_t)b * n * (h1 + 1);
  const float* gb = g + (size_t)b * n * h_out;
  const float denom = sum_agg ? 1.f : (float)k;
  float* du2p = du2_part + ((size_t)b * n_grp + grp) * n * h1;
  float* dmaskp = dmask_part + ((size_t)b * n_grp + grp) * n;
  float* wp = w_part + ((size_t)b * n_grp + grp) * w_total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int ib = 0; ib < g_eff; ib += p.ti) {
    const int ti_eff = min(p.ti, g_eff - ib);
    const int rows = round_up(ti_eff * p.kc, kRowBlock);
    for (int s0 = 0; s0 < k; s0 += p.kc) {
      const int kc_eff = min(p.kc, k - s0);
      const bool first = ib == 0 && s0 == 0;
      if (kDrop) drop.base = (unsigned)(b * n + g0 + ib) * (unsigned)k + (unsigned)s0;
      __syncthreads();  // the previous pass has finished reading the buffers
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        const int ii = r / p.kc, ss = r - (r / p.kc) * p.kc;
        int j = -1;
        float m = 0.f, dist = 0.f;
        if (ii < ti_eff && ss < kc_eff) {
          const size_t e = ((size_t)b * n + g0 + ib + ii) * k + s0 + ss;
          j = idx[e];
          m = u2mb[(size_t)j * (h1 + 1) + h1];
          if (want_dists) dist = dists[e];
        }
        rowj[r] = j;
        smask[r] = m;
        rdist[r] = dist;
      }
      __syncthreads();
      // recompute: layer 1 (decomposed), then the hidden layers, keeping every a_l
      for (int t = threadIdx.x; t < rows * h1; t += kThreads) {
        const int r = t / h1, h = t - (t / h1) * h1;
        const int j = rowj[r];
        float v = 0.f;
        if (j >= 0) {
          float z = u1b[(size_t)(g0 + ib + r / p.kc) * h1 + h] + u2mb[(size_t)j * (h1 + 1) + h];
          if (want_dists) z = __fadd_rn(z, __fmul_rn(rdist[r], __ldg(w_d + h)));
          v = leaky(z, alpha);
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
      // da_L = g[i] * mask[sender] / denom, zero on padded rows
      for (int t = threadIdx.x; t < rows * h_out; t += kThreads) {
        const int r = t / h_out, h = t - (t / h_out) * h_out;
        float v = 0.f;
        if (rowj[r] >= 0) v = gb[(size_t)(g0 + ib + r / p.kc) * h_out + h] / denom * smask[r];
        grad0[h * p.ldr + r] = v;
      }
      __syncthreads();
      // dsmask of each edge: one warp per row
      for (int r = warp; r < rows; r += kWarps) {
        if (rowj[r] < 0) continue;
        const float* gi = gb + (size_t)(g0 + ib + r / p.kc) * h_out;
        float acc = 0.f;
        for (int h = lane; h < h_out; h += 32) acc += gi[h] / denom * acts[L][h * p.ldr + r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) dsm[r] = acc;
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
          for (int q = 0; q < l - 1; ++q) off += fe.dim[q] * fe.dim[q + 1] + fe.dim[q + 1];
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
      // gcur holds dz_1 [h1 x rows]. The sender scatter first (threads 0..h1), so
      // its adds are in flight while the others reduce the CTA's own rows.
      if (threadIdx.x < h1) {
        const float* col = gcur + threadIdx.x * p.ldr;
        for (int r = 0; r < rows; ++r) {
          const int j = rowj[r];
          if (j >= 0) atomicAdd(du2p + (size_t)j * h1 + threadIdx.x, col[r]);
        }
        if (need_wgrads && want_dists) {
          float s = 0.f;
          for (int r = 0; r < rows; ++r) s = fmaf(rdist[r], col[r], s);
          accumulate_to(wp + w_total - h1 + threadIdx.x, s, first);
        }
      } else if (threadIdx.x == h1) {
        for (int r = 0; r < rows; ++r) {
          const int j = rowj[r];
          if (j >= 0) atomicAdd(dmaskp + j, dsm[r]);
        }
      }
      for (int t = threadIdx.x; t < ti_eff * h1; t += kThreads) {
        const int ii = t / h1, h = t - (t / h1) * h1;
        const float* col = gcur + h * p.ldr + ii * p.kc;
        float acc = 0.f;
        for (int ss = 0; ss < kc_eff; ++ss) acc += col[ss];
        accumulate_to(du1 + ((size_t)b * n + g0 + ib + ii) * h1 + h, acc, s0 == 0);
      }
      if (want_dists) {
        for (int r = warp; r < rows; r += kWarps) {
          if (rowj[r] < 0) continue;
          float acc = 0.f;
          for (int h = lane; h < h1; h += 32) acc = fmaf(gcur[h * p.ldr + r], __ldg(w_d + h), acc);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (lane == 0) {
            const int ii = r / p.kc, ss = r - (r / p.kc) * p.kc;
            ddists[((size_t)b * n + g0 + ib + ii) * k + s0 + ss] = acc;
          }
        }
      }
    }
  }
}

// The pass shape and buffer widths; shrinks the pass until the shared memory fits.
// Returns the bytes, or 0.
size_t make_knn_bwd_plan(int n, int k, const Chain& fe, KnnBwdPlan& p) {
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
    choose_pass(k, p.group, max_rows, p.ti, p.kc);
    p.ldr = round_up(p.ti * p.kc, kRowBlock) + 4;
    const size_t bytes = (size_t)(act_w + p.d0 + p.d1 + 4) * p.ldr * sizeof(float);
    if (bytes <= (size_t)kMaxSmemBytes) return bytes;
  }
  return 0;
}

}  // namespace

extern "C" {

// K6. idx int32 [batch, n, k]; dists [batch, n, k] and w_d [h1], or both null
// (then ddists and dw_d are not touched). hidden_w / hidden_wt / hidden_b: per
// hidden layer W [in, out], W^T [out, in], b. dhidden: 2 * n_hidden outputs
// (dW_l [in, out], db_l), left untouched, like dw_d, without need_wgrads.
// Partials: du2_part [batch, groups, n, h1] and dmask_part [batch, groups, n],
// both zeroed by the caller; w_part [batch * groups, sum_l (in_l * out_l + out_l)
// (+ h1 with dists)] (unused without need_wgrads). `groups` is
// mpgan_edge_aggregate_groups(n).
int mpgan_knn_edge_aggregate_bwd(const float* u1, const float* u2m, const int* idx,
                                 const float* dists, const float* w_d, const float* g,
                                 float* du1, float* du2, float* dmask, float* ddists,
                                 float* dw_d, void* const* dhidden, float* du2_part,
                                 float* dmask_part, float* w_part, int batch, int n, int h1,
                                 int k, int n_hidden, const void* const* hidden_w,
                                 const void* const* hidden_wt, const void* const* hidden_b,
                                 const int* hidden_dims, float alpha, int sum_agg, int dropout,
                                 int seed, unsigned thr, float mult, int need_wgrads,
                                 void* stream) {
  Chain fe, fe_t;
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth || k < 1 || k > n || !(alpha > 0.f) ||
      seed < 0)
    return (int)cudaErrorInvalidValue;
  const bool want_dists = dists != nullptr;
  if (want_dists && (w_d == nullptr || ddists == nullptr || dw_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  fe_t = fe;
  for (int l = 0; l < n_hidden; ++l) fe_t.w[l] = static_cast<const float*>(hidden_wt[l]);
  KnnBwdPlan p;
  const size_t smem = make_knn_bwd_plan(n, k, fe, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.seed_key = (unsigned)seed * 0xC2B2AE3Du;
  drop.thr = thr;
  drop.mult = mult;
  drop.jc = p.kc;
  drop.ns = k;
  int w_total = want_dists ? h1 : 0;
  for (int l = 0; l < n_hidden; ++l) w_total += fe.dim[l] * fe.dim[l + 1] + fe.dim[l + 1];
  const int groups = num_groups(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch, groups);
  cudaError_t err;
  if (dropout) {
    err = cudaFuncSetAttribute(knn_edge_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_edge_bwd_kernel<true><<<grid, kThreads, smem, st>>>(
        u1, u2m, idx, dists, w_d, g, du1, ddists, du2_part, dmask_part, w_part, n, h1, k, p, fe,
        fe_t, alpha, sum_agg, drop, need_wgrads, w_total);
  } else {
    err = cudaFuncSetAttribute(knn_edge_bwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    knn_edge_bwd_kernel<false><<<grid, kThreads, smem, st>>>(
        u1, u2m, idx, dists, w_d, g, du1, ddists, du2_part, dmask_part, w_part, n, h1, k, p, fe,
        fe_t, alpha, sum_agg, drop, need_wgrads, w_total);
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
  if (want_dists) code = launch_reduce(w_part + off, dw_d, 1, batch * groups, h1, w_total, 0, st);
  return code;
}

}  // extern "C"
