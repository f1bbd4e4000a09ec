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
// recompute, dW and da), so it is bound by FP32 FMA issue and shared-memory
// operand loads. The recompute-and-backprop pass, its shared-memory plan, the
// products and the contractions are edge_bwd_common.cuh's (shared with K6, the
// knn backward); this file adds what is dense:
//   - an item of the persistent grid's schedule is a block of ti receivers of one
//     jet; the CTA walks the jet's senders in chunks of jc (a pass is ti x jc
//     pair rows: 4 x 30 = 120 of 128 at N = 30, 5 x 25 = 125 at N = 150);
//   - du1 rows belong to one item and are accumulated in place over its chunks;
//   - du2 and dmask sum over the receivers, so over the items of a jet: each CTA
//     that touches a jet owns one slab [n, h1 + 1] (column h1: dmask) of that
//     jet's `slots`; its first item of the jet writes the slab (every item covers
//     every sender), later items add, each address always by the same thread. A
//     second kernel sums a jet's slabs in slot order;
//   - the weight gradients go to one partial slab a CTA, reduced over the CTAs
//     in order. With need_wgrads = 0 (the G step differentiating through D) the
//     contractions are skipped and the caller's zero gradients stay zero.
// Every sum has a fixed order, so repeated launches agree bit for bit.

#include "edge_bwd_common.cuh"

namespace {

// grid = the plan's CTAs. `pk` holds the packed weights. sender_part
// [batch, slots, n, h1 + 1]; w_part [grid, ws.slab_floats].
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_bwd_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                              const float* __restrict__ mask, const float* __restrict__ g,
                              float* __restrict__ du1, float* __restrict__ sender_part,
                              float* __restrict__ w_part, int n, int h1, BwdPlan p, Chain fe,
                              Packed pk, float alpha, int sum_agg, int drop_on, Drop drop,
                              const int* __restrict__ seed,
                              int need_wgrads, WSlab ws) {
  drop = drop_load(drop, seed, drop_on != 0);
  const PassBuffers s = carve(p, fe.n);
  const int h_out = fe.dim[fe.n], ns = drop.ns;
  const long long t_begin = range_start(blockIdx.x, p.items, gridDim.x);
  const long long t_end = range_start(blockIdx.x + 1, p.items, gridDim.x);
  PassInputs in;
  in.w_d = nullptr;
  in.alpha = alpha;
  in.denom = sum_agg ? 1.f : (float)n;
  in.drop_on = drop_on != 0;
  in.drop = drop;
  in.need_wgrads = need_wgrads;
  in.wp = w_part + (size_t)blockIdx.x * ws.slab_floats;
  in.ws = &ws;
  in.first = true;
  PhaseClock clock;
  MPGAN_PHASE_START(clock);

  for (long long t = t_begin; t < t_end; ++t) {
    const int b = (int)(t / p.blocks), i0 = (int)(t - (long long)b * p.blocks) * p.ti;
    const int ti_eff = min(p.ti, n - i0);
    // the CTA's first item of this jet writes the jet's slab, later ones add
    const bool first_of_jet = t == t_begin || i0 == 0;
    const int slot = blockIdx.x - item_owner((long long)b * p.blocks, p.items, gridDim.x);
    float* sp = sender_part + ((size_t)b * p.slots + slot) * n * (h1 + 1);
    const float* mb = mask + (size_t)b * n;
    in.u1 = u1 + (size_t)b * n * h1;
    in.u2 = u2 + (size_t)b * n * h1;
    in.g = g + (size_t)b * n * h_out;
    for (int j0 = 0; j0 < n; j0 += p.jc) {
      const int jc_eff = min(p.jc, n - j0);
      __syncthreads();  // the previous pass's tail has read the row arrays
      for (int r = threadIdx.x; r < p.rows; r += kThreads) {
        const int ii = r / p.jc, jj = r - ii * p.jc;
        const bool real = ii < ti_eff && jj < jc_eff;
        smi(s.row.u1)[r] = real ? (i0 + ii) * h1 : -1;
        smi(s.row.u2)[r] = real ? (j0 + jj) * h1 : 0;
        smi(s.row.g)[r] = real ? (i0 + ii) * h_out : 0;
        smf(s.row.m)[r] = real ? mb[j0 + jj] / in.denom : 0.f;
        smu(s.row.id)[r] = (unsigned)(b * n + i0 + ii) * (unsigned)ns + (unsigned)(j0 + jj);
        smf(s.row.dist)[r] = 0.f;
      }
      const float* dz = smf(bwd_pass(s, p, fe, pk, in, clock));
      in.first = false;
      // dz_0 [h1 x rows]: du1 rows are this item's own, du2 and dmask go to the slab
      for (int q = threadIdx.x; q < ti_eff * h1; q += kThreads) {
        const int ii = q / h1, h = q - ii * h1;
        const float* col = dz + h * p.ldr + ii * p.jc;
        float acc = 0.f;
        for (int jj = 0; jj < jc_eff; ++jj) acc += col[jj];
        accumulate_to(du1 + ((size_t)b * n + i0 + ii) * h1 + h, acc, j0 == 0);
      }
      for (int q = threadIdx.x; q < jc_eff * (h1 + 1); q += kThreads) {
        const int jj = q / (h1 + 1), h = q - jj * (h1 + 1);
        const float* col = (h < h1 ? dz + h * p.ldr : smf(s.row.dsm)) + jj;
        float acc = 0.f;
        for (int ii = 0; ii < ti_eff; ++ii) acc += col[ii * p.jc];
        accumulate_to(sp + (size_t)(j0 + jj) * (h1 + 1) + h, acc, first_of_jet);
      }
      MPGAN_PHASE(clock, kPhaseTail);
    }
  }
  finish_bulk();
}

}  // namespace

extern "C" {

// Floats of the packed-weight scratch that the backward kernels (K3 and K6) need
// for a chain of these widths at passes of `rows` pair rows; -1 on bad arguments.
long long mpgan_edge_bwd_packed_floats(int n_hidden, const int* hidden_dims, int rows) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (rows != 32 && rows != 64 && rows != 128) return -1;
  PackJobs jobs;
  return plan_pack(jobs, fe, 8 * (kWarps / (rows / 32)));
}

// Floats of one CTA's weight-gradient slab (dW tile-major, db, `n_extra` more).
int mpgan_edge_bwd_wslab_floats(int n_hidden, const int* hidden_dims, int n_extra) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims) || n_extra < 0) return -1;
  return make_wslab(fe, n_extra).slab_floats;
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_bwd_common.cuh: Phase) since the last reset.
int mpgan_edge_aggregate_bwd_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K3. hidden_w / hidden_b: per hidden layer W [in, out] and b. packed: scratch for
// the packed weights (mpgan_edge_bwd_packed_floats floats).
// wgrads: the weight gradients, flat [sum_l (in_l * out_l + out_l)] in layer order
// (dW_l then db_l), left untouched without need_wgrads. The pass shape (ti x jc
// pair rows in buffers of `rows`), the grid and the slots per jet are the
// caller's plan. Partials: sender_part [batch, slots, n, h1 + 1]; w_part [grid,
// mpgan_edge_bwd_wslab_floats] (unused without need_wgrads).
int mpgan_edge_aggregate_bwd(const float* u1, const float* u2, const float* mask, const float* g,
                             float* du1, float* du2, float* dmask, float* wgrads,
                             float* sender_part, float* w_part, int batch, int n, int h1,
                             int n_hidden, const void* const* hidden_w,
                             float* packed, const void* const* hidden_b,
                             const int* hidden_dims, float alpha, int sum_agg, int dropout,
                             const int* seed, unsigned thr, float mult, int need_wgrads,
                             int ti, int jc,
                             int rows, int grid, int slots, void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth || !(alpha > 0.f) ||
      (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  BwdPlan p;
  if (!make_plan(p, fe, batch, n, n, ti, jc, rows, grid, slots, false))
    return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.thr = thr;
  drop.mult = mult;
  drop.ns = round_up(n, 8);
  const WSlab ws = make_wslab(fe, 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Packed pk;
  int code = launch_pack(fe, p.col_threads, packed, pk, st);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(edge_aggregate_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  edge_aggregate_bwd_kernel<<<grid, kThreads, p.smem, st>>>(
      u1, u2, mask, g, du1, sender_part, w_part, n, h1, p, fe, pk, alpha, sum_agg, dropout,
      drop, seed, need_wgrads, ws);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  return launch_reductions(sender_part, du2, dmask, batch, n, h1, p, grid, w_part,
                           need_wgrads ? wgrads : nullptr, ws, st);
}

}  // extern "C"
