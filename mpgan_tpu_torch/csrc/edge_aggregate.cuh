// The dense forward kernel (K2, K4) of the FP32 mode and its launcher
// (edge_aggregate.cu, which says what the kernel computes and how; the bf16 mode runs
// edge_fwd_bf16_tiles.cuh).
#pragma once

#include "edge_fwd_common.cuh"

namespace {

// grid = the plan's CTAs; dynamic shared memory as fwd_layout lays it out. T: the
// element type of the inputs and the output (float).
template <bool kFuseFn, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_kernel(const T* __restrict__ u1, const T* __restrict__ u2,
                          const T* __restrict__ mask, const T* __restrict__ x,
                          T* __restrict__ out, float* __restrict__ packed, int batch, int n,
                          int feat, FwdPlan p, Chain fe, Chain fn, float alpha, float fn_alpha,
                          int sum_agg, int drop_on, Drop drop,
                          const int* __restrict__ seed) {
  drop = drop_load(drop, seed, drop_on != 0);
  const int L = fe.n, h1 = fe.dim[0], h_out = fe.dim[L], ns = round_up(n, 8);
  const int n_fn = kFuseFn ? fn.n : 0;
  const LayerTab* tab = fwd_setup(packed, p, fe, fn, L + n_fn);
  const int total = batch * n;  // receivers of the launch
  const float denom = sum_agg ? 1.f : (float)n;  // the mean divides by the true n
  const RowArrays row = fwd_rows(p);
  PassInputs in{};
  in.u1 = reinterpret_cast<const float*>(u1);
  in.u2 = reinterpret_cast<const float*>(u2);
  in.w_d = nullptr;
  in.alpha = alpha;
  in.drop_on = drop_on != 0;
  in.drop = drop;
  Epilogue e = fwd_epilogue(p, row, alpha, drop_on != 0, drop);
  SlabChain chain{};
  PhaseClock clock;
  MPGAN_PHASE_START(clock);

  const long long t_end = range_start(blockIdx.x + 1, p.items, gridDim.x);
  for (long long t = range_start(blockIdx.x, p.items, gridDim.x); t < t_end; ++t) {
    // the item's first receiver in the flat list, and how many it holds
    const int q_base = (int)t * p.span, n_recv = min(p.span, total - q_base);
    for (int blk = 0; blk < n_recv; blk += p.ti) {
      const int ti_eff = min(p.ti, n_recv - blk);
      for (int j0 = 0; j0 < n; j0 += p.jc) {
        const int jc_eff = min(p.jc, n - j0);
        // dense rows: receiver q = q_base + blk + ii of the flat list x sender j0 + jj
        // of its jet
        for (int r = threadIdx.x; r < p.rows; r += kThreads) {
          const int ii = r / p.rs, jj = r - ii * p.rs;
          const bool real = ii < ti_eff && jj < jc_eff;
          const int q = q_base + blk + ii, sender = (q / n) * n + j0 + jj;
          smi(row.u1)[r] = real ? q * h1 : -1;
          smi(row.u2)[r] = real ? sender * h1 : 0;
          smu(row.id)[r] = (unsigned)q * (unsigned)ns + (unsigned)(j0 + jj);
          smf(row.m)[r] = real ? ld_elem(mask + sender) : 0.f;
        }
        const bool first = j0 == 0, last = j0 + p.jc >= n;
        // the product after the last layer's: fe's first again (this item's next
        // pass, or the next item's first), else fn's first (K4), else none
        const bool more = !last || blk + p.ti < n_recv;
        const int nxt = more || (!kFuseFn && t + 1 < t_end) ? 0 : (kFuseFn ? L : -1);
        fwd_pass<kFuseFn, T>(p, tab, L, h1, h_out, row, in, e, chain, ti_eff, jc_eff, blk,
                             first, last, nxt, denom, out + (size_t)(q_base + blk) * h_out,
                             clock);
      }
    }
    if (!kFuseFn) continue;

    // K4: fn on the item's receivers, input rows [agg / denom | x] transposed,
    // padded rows zero
    __syncthreads();
    float* f = smf(0);
    for (int q = threadIdx.x; q < h_out * p.rows; q += kThreads) {
      const int c = q / p.rows, r = q - c * p.rows;
      float* a = f + (size_t)c * p.ldr + r;
      *a = r < n_recv ? *a / denom : 0.f;
    }
    for (int q = threadIdx.x; q < p.rows * feat; q += kThreads) {
      const int r = q / feat, c = q - r * feat;
      f[(size_t)(h_out + c) * p.ldr + r] =
          r < n_recv ? ld_elem(x + (size_t)(q_base + r) * feat + c) : 0.f;
    }
    Epilogue efn{};
    efn.kind = kEpiHidden;
    efn.C = 0;
    for (int l = 0; l < n_fn; ++l) {
      // next: fn's next layer, or the next item's first fe product
      const int nxt = l + 1 < n_fn ? L + l + 1 : (t + 1 < t_end && L > 0 ? 0 : -1);
      const LayerTab a = tab[L + l], b = nxt < 0 ? LayerTab{} : tab[nxt];
      efn.bias = a.b;
      efn.alpha = (l + 1 < n_fn || fn.act_last) ? fn_alpha : 1.f;  // slope 1: linear
      product_fwd(0, a.k, a.w, a.m, p, efn, p.off_slab, chain, b.w, b.k, b.m);
    }
    __syncthreads();
    const int f_out = tab[L + n_fn - 1].m;
    for (int q = threadIdx.x; q < n_recv * f_out; q += kThreads) {
      const int r = q / f_out, c = q - r * f_out;
      st_elem(out + (size_t)(q_base + r) * f_out + c, f[(size_t)c * p.ldr + r]);
    }
    // the next item's first pass overwrites these rows after its first barrier
    MPGAN_PHASE(clock, kPhaseTail);
  }
}

// Checks the caller's plan, lays out the shared memory and launches.
template <bool kFuseFn, typename T>
int launch(const T* u1, const T* u2, const T* mask, const T* x, T* out,
           float* packed, int batch, int n, int h1, int feat, const Chain& fe, const Chain& fn,
           float alpha, float fn_alpha, int sum_agg, int drop_on, Drop drop, const int* seed,
           int ti, int jc, int rows, int span, int grid, int slab_floats, void* stream) {
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  // offsets into u1 and u2 are ints
  if ((long long)batch * n * (h1 > fe.dim[fe.n] ? h1 : fe.dim[fe.n]) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  FwdPlan p{};
  p.rows = rows;
  p.ti = ti;
  p.jc = jc;
  p.span = kFuseFn ? span : ti;
  p.row_arrays = 4;
  p.slab_floats = slab_floats;
  if (!fwd_layout(p, fe, kFuseFn ? &fn : nullptr) || jc > n) return (int)cudaErrorInvalidValue;
  if (p.span < ti || p.span > rows || p.span % ti != 0) return (int)cudaErrorInvalidValue;
  p.items = ((long long)batch * n + p.span - 1) / p.span;
  if (grid < 1 || grid > p.items) return (int)cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(edge_aggregate_kernel<kFuseFn, T>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  Chain fn_arg = fn;
  void* args[] = {&u1, &u2, &mask, &x, &out, &packed, &batch, &n, &feat, &p, const_cast<Chain*>(&fe),
                  &fn_arg, &alpha, &fn_alpha, &sum_agg, &drop_on, &drop, &seed};
  // cooperative: the CTAs meet at a grid-wide barrier after packing the weights
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // namespace
