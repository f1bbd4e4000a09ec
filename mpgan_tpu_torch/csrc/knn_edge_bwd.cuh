// The knn backward kernel (K6) and its launcher, for both modes: FP32
// (knn_edge_bwd.cu) and bf16 (knn_edge_bwd_bf16.cu), each instantiated in its own
// source so that the build compiles them in parallel. See knn_edge_bwd.cu for
// what the kernel computes and how.
#pragma once

#include <type_traits>

#include "edge_bwd_common.cuh"

namespace {

// grid = the plan's CTAs. `pk` holds the packed weights. sender_part
// [batch, slots, n, h1 + 1]; w_part [grid, ws.slab_floats], dw_d's partial last.
// T: the element type of u1, u2m, w_d and g (float, or bf16 in the bf16 mode);
// idx, dists, du1 and ddists are int32 and float32 in both modes.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    knn_edge_bwd_kernel(const T* __restrict__ u1, const T* __restrict__ u2m,
                        const int* __restrict__ idx, const float* __restrict__ dists,
                        const T* __restrict__ w_d, const T* __restrict__ g,
                        float* __restrict__ du1, float* __restrict__ ddists,
                        float* __restrict__ sender_part, float* __restrict__ w_part, int n,
                        int h1, int k, BwdPlan p, Chain fe, Packed pk, float alpha, int sum_agg,
                        int drop_on, Drop drop, const int* __restrict__ seed, int need_wgrads,
                        WSlab ws) {
  drop = drop_load(drop, seed, drop_on != 0);
  const PassBuffers s = carve(p, fe.n);
  const int h_out = fe.dim[fe.n], hs = h1 + 1;
  const bool want_dists = dists != nullptr;
  const long long t_begin = range_start(blockIdx.x, p.items, gridDim.x);
  const long long t_end = range_start(blockIdx.x + 1, p.items, gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the scatter's owner grid: thread (my_h, my_own) adds column my_h of the rows
  // whose sender (staged: whose first row with that sender) is my_own mod n_own
  const int hr = p.sender_stride;
  const int n_own = kThreads / hr;
  const int my_own = threadIdx.x / hr, my_h = threadIdx.x - my_own * hr;
  const bool staged = p.off_stage >= 0;
  PassInputs in;
  in.w_d = want_dists ? reinterpret_cast<const float*>(w_d) : nullptr;
  in.alpha = alpha;
  in.denom = sum_agg ? 1.f : (float)k;
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
    const int slot = blockIdx.x - item_owner((long long)b * p.blocks, p.items, gridDim.x);
    float* sp = sender_part + ((size_t)b * p.slots + slot) * n * hr;
    const T* u2mb = u2m + (size_t)b * n * hs;
    in.u1 = reinterpret_cast<const float*>(u1 + (size_t)b * n * h1);
    in.u2 = reinterpret_cast<const float*>(u2mb);
    in.g = reinterpret_cast<const float*>(g + (size_t)b * n * h_out);
    if (t == t_begin || i0 == 0) {
      // the CTA's first item of this jet: its slab starts at zero. The barriers
      // of the pass order these stores before the scatter's adds
      for (int q = threadIdx.x; q < n * hr; q += kThreads) sp[q] = 0.f;
      __threadfence();
      asm volatile("fence.proxy.async;" ::: "memory");  // before bulk reductions add to it
    }
    for (int s0 = 0; s0 < k; s0 += p.jc) {
      const int kc_eff = min(p.jc, k - s0);
      bulk_wait_read();  // the previous pass's scatter has left its staging buffer
      __syncthreads();   // and its tail has read the row arrays
      for (int r = threadIdx.x; r < p.rows; r += kThreads) {
        const int ii = r / p.jc, ss = r - ii * p.jc;
        const bool real = ii < ti_eff && ss < kc_eff;
        int j = -1;
        float m = 0.f, dist = 0.f;
        if (real) {
          const size_t e = ((size_t)b * n + i0 + ii) * k + s0 + ss;
          j = min(max(idx[e], 0), n - 1);
          m = to_float(u2mb[(size_t)j * hs + h1]) / in.denom;
          if (want_dists) dist = dists[e];
        }
        smi(s.row.sender)[r] = j;
        smi(s.row.own)[r] = real ? j % n_own : -1;
        smi(s.row.first)[r] = -1;
        smi(s.row.u1)[r] = real ? (i0 + ii) * h1 : -1;
        smi(s.row.u2)[r] = real ? j * hs : 0;
        smi(s.row.g)[r] = real ? (i0 + ii) * h_out : 0;
        smf(s.row.m)[r] = m;
        smf(s.row.dist)[r] = dist;
        smu(s.row.id)[r] = (unsigned)(b * n + i0 + ii) * (unsigned)k + (unsigned)(s0 + ss);
      }
      const float* dz = smf(bwd_pass<T>(s, p, fe, pk, in, clock));
      // dz_0 [h1 x rows]. The sender scatter first, so that its adds are in
      // flight while the CTA reduces its own rows
      const float* col = my_h < h1 ? dz + my_h * p.ldr : smf(s.row.dsm);
      if (staged) {
        // rows that share a sender are summed in shared memory, in row order, into
        // the first of them; then one bulk reduction a sender adds the sum to the
        // slab. Nothing meets at one address in device memory within a pass, and
        // the passes follow each other: every thread's earlier reductions are
        // complete before the barrier that precedes the new ones
        float* stage = smf(p.off_stage);
        bulk_wait_done();
        // a warp per row: the first row with the row's sender, by ballots over the
        // rows before it
        const int chunks = p.rows / 32;
        unsigned* masks = smu(s.part);  // [n_own x chunks]: the rows of each owner
        for (int r = warp; r < p.rows; r += kWarps) {
          const int mine = smi(s.row.sender)[r];
          int f = -1;
          if (mine >= 0) {
            f = r;
            for (int q0 = 0; q0 < r; q0 += 32) {
              const int q = q0 + lane;
              const unsigned hit =
                  __ballot_sync(0xffffffffu, q < r && smi(s.row.sender)[q] == mine);
              if (hit) {
                f = q0 + __ffs(hit) - 1;
                break;
              }
            }
          }
          if (lane == 0) {
            smi(s.row.first)[r] = f;
            smi(s.row.own)[r] = f >= 0 ? f % n_own : -1;
          }
        }
        __syncthreads();
        for (int w = warp; w < n_own * chunks; w += kWarps) {
          const int q = w / chunks, c = w - q * chunks;
          const unsigned m = __ballot_sync(0xffffffffu, smi(s.row.own)[c * 32 + lane] == q);
          if (lane == 0) masks[w] = m;
        }
        __syncthreads();
        if (my_own < n_own) {
          for (int c = 0; c < chunks; ++c) {
            unsigned m = masks[my_own * chunks + c];
            while (m) {
              const int r = c * 32 + __ffs(m) - 1;
              m &= m - 1;
              const int f = smi(s.row.first)[r];
              const float v = my_h <= h1 ? col[r] : 0.f;
              float* at = stage + f * hr + my_h;
              *at = f == r ? v : *at + v;
            }
          }
        }
        fence_for_bulk();
        __syncthreads();
        for (int r = threadIdx.x; r < p.rows; r += kThreads)
          if (smi(s.row.first)[r] == r)
            bulk_to_global(sp + (size_t)smi(s.row.sender)[r] * hr, stage + r * hr,
                           hr * (int)sizeof(float), true);
      } else if (my_own < n_own && my_h <= h1) {
        // no buffer to stage in: column my_h of sender j is added by one thread,
        // walking the rows in order (fire-and-forget atomicAdds)
        for (int r = 0; r < p.rows; ++r)
          if (smi(s.row.own)[r] == my_own)
            atomicAdd(sp + (size_t)smi(s.row.sender)[r] * hr + my_h, col[r]);
      }
      for (int q = threadIdx.x; q < ti_eff * h1; q += kThreads) {
        const int ii = q / h1, h = q - ii * h1;
        const float* col = dz + h * p.ldr + ii * p.jc;
        float acc = 0.f;
        for (int ss = 0; ss < kc_eff; ++ss) acc += col[ss];
        accumulate_to(du1 + ((size_t)b * n + i0 + ii) * h1 + h, acc, s0 == 0);
      }
      if (want_dists) {
        for (int r = warp; r < p.rows; r += kWarps) {
          if (smi(s.row.sender)[r] < 0) continue;
          float acc = 0.f;
          for (int h = lane; h < h1; h += 32)
            acc = fmaf(dz[h * p.ldr + r], ld_elem(w_d + h), acc);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (lane == 0) {
            const int ii = r / p.jc, ss = r - ii * p.jc;
            ddists[((size_t)b * n + i0 + ii) * k + s0 + ss] = acc;
          }
        }
        if (need_wgrads && threadIdx.x < h1) {
          const float* col = dz + threadIdx.x * p.ldr;
          float acc = 0.f;
          for (int r = 0; r < p.rows; ++r) acc = fmaf(smf(s.row.dist)[r], col[r], acc);
          accumulate_to(in.wp + ws.extra + threadIdx.x, acc, in.first);
        }
      }
      in.first = false;
      MPGAN_PHASE(clock, kPhaseTail);
    }
  }
  finish_bulk();
}


// Checks the caller's plan, packs the weights, launches the kernel and the
// reductions (see mpgan_knn_edge_aggregate_bwd); `packed_floats` is the scratch's
// size in the bf16 mode (the FP32 one does not read it).
template <typename T>
int launch_knn_bwd(const T* u1, const T* u2m, const int* idx, const float* dists, const T* w_d,
                   const T* g, float* du1, T* du2, T* dmask, float* ddists, float* wgrads,
                   float* sender_part, float* w_part, int batch, int n, int h1, int k,
                   int n_hidden, const void* const* hidden_w, float* packed,
                   long long packed_floats, const void* const* hidden_b, const int* hidden_dims,
                   float alpha, int sum_agg, int dropout, const int* seed, unsigned thr,
                   float mult, int need_wgrads, int ti, int kc, int rows, int grid, int slots,
                   void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || h1 < 1 || h1 > kMaxWidth || k < 1 || k > n || !(alpha > 0.f) ||
      (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool want_dists = dists != nullptr;
  if (want_dists && (w_d == nullptr || ddists == nullptr)) return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  BwdPlan p;
  if (!make_plan(p, fe, batch, n, k, ti, kc, rows, grid, slots, true))
    return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.thr = thr;
  drop.mult = mult;
  const WSlab ws = make_wslab(fe, want_dists ? h1 : 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Packed pk;
  int code;
  if constexpr (std::is_same<T, float>::value)
    code = launch_pack(fe, p.col_threads, packed, pk, st);
  else
    code = launch_pack_bf16<T>(fe, packed, packed_floats, pk, st);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      knn_edge_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  knn_edge_bwd_kernel<T><<<grid, kThreads, p.smem, st>>>(
      u1, u2m, idx, dists, w_d, g, du1, ddists, sender_part, w_part, n, h1, k, p, fe, pk,
      alpha, sum_agg, dropout, drop, seed, need_wgrads, ws);
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  return launch_reductions(sender_part, du2, dmask, batch, n, h1, p, grid, w_part,
                           need_wgrads ? wgrads : nullptr, ws, st);
}

}  // namespace
