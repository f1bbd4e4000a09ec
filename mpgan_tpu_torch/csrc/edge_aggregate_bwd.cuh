// The dense backward kernel (K3) and its launcher, for both modes: FP32
// (edge_aggregate_bwd.cu) and bf16 (edge_aggregate_bwd_bf16.cu), each instantiated
// in its own source so that the build compiles them in parallel. See
// edge_aggregate_bwd.cu for what the kernel computes and how.
#pragma once

#include "edge_bwd_common.cuh"

namespace {

// grid = the plan's CTAs. `pk` holds the packed weights. sender_part
// [batch, slots, n, h1 + 1]; w_part [grid, ws.slab_floats]. T: the element type
// of u1, u2, mask and g (float, or bf16 in the bf16 mode); du1 is float32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_bwd_kernel(const T* __restrict__ u1, const T* __restrict__ u2,
                              const T* __restrict__ mask, const T* __restrict__ g,
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
    const T* mb = mask + (size_t)b * n;
    in.u1 = reinterpret_cast<const float*>(u1 + (size_t)b * n * h1);
    in.u2 = reinterpret_cast<const float*>(u2 + (size_t)b * n * h1);
    in.g = reinterpret_cast<const float*>(g + (size_t)b * n * h_out);
    for (int j0 = 0; j0 < n; j0 += p.jc) {
      const int jc_eff = min(p.jc, n - j0);
      __syncthreads();  // the previous pass's tail has read the row arrays
      for (int r = threadIdx.x; r < p.rows; r += kThreads) {
        const int ii = r / p.jc, jj = r - ii * p.jc;
        const bool real = ii < ti_eff && jj < jc_eff;
        smi(s.row.u1)[r] = real ? (i0 + ii) * h1 : -1;
        smi(s.row.u2)[r] = real ? (j0 + jj) * h1 : 0;
        smi(s.row.g)[r] = real ? (i0 + ii) * h_out : 0;
        smf(s.row.m)[r] = real ? to_float(mb[j0 + jj]) / in.denom : 0.f;
        smu(s.row.id)[r] = (unsigned)(b * n + i0 + ii) * (unsigned)ns + (unsigned)(j0 + jj);
        smf(s.row.dist)[r] = 0.f;
      }
      const float* dz = smf(bwd_pass<T>(s, p, fe, pk, in, clock));
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

// Checks the caller's plan, packs the weights, launches the kernel and the
// reductions (see mpgan_edge_aggregate_bwd); `packed_floats` is the scratch's
// size in the bf16 mode (the FP32 one does not read it).
template <typename T>
int launch_bwd(const T* u1, const T* u2, const T* mask, const T* g, float* du1, T* du2,
               T* dmask, float* wgrads, float* sender_part, float* w_part, int batch, int n,
               int h1, int n_hidden, const void* const* hidden_w, float* packed,
               long long packed_floats, const void* const* hidden_b, const int* hidden_dims,
               float alpha, int sum_agg, int dropout, const int* seed, unsigned thr, float mult,
               int need_wgrads, int ti, int jc, int rows, int grid, int slots, void* stream) {
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
  int code;
  if constexpr (std::is_same<T, float>::value)
    code = launch_pack(fe, p.col_threads, packed, pk, st);
  else
    code = launch_pack_bf16<T>(fe, packed, packed_floats, pk, st);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(edge_aggregate_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  edge_aggregate_bwd_kernel<T><<<grid, kThreads, p.smem, st>>>(
      u1, u2, mask, g, du1, sender_part, w_part, n, h1, p, fe, pk, alpha, sum_agg, dropout,
      drop, seed, need_wgrads, ws);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  return launch_reductions(sender_part, du2, dmask, batch, n, h1, p, grid, w_part,
                           need_wgrads ? wgrads : nullptr, ws, st);
}

}  // namespace
