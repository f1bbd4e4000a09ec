// The bf16 mode's weight packing for the forward kernels: K4 on the bf16 stage
// (edge_aggregate_bf16.cu) and the bf16 forward pass of K2, K5 and K8
// (edge_fwd_bf16_tiles.cuh, which packs the same copy without an FP32 layer and keeps
// it in shared memory). The kernel's own CTAs pack a bf16 copy of every
// product's weights in fragment order (edge_products_bf16.cuh: bf16_elem), K4's
// fn first layer as float32 values in the FP32 stage's order, and every bias as
// float32, into the caller's scratch, then meet at a grid-wide barrier.
#pragma once

#include "edge_fwd_common.cuh"
#include "edge_products_bf16.cuh"

namespace {

// Offsets (floats) in the bf16 mode's packed scratch of a forward launch: job l's
// weights at w[l] (job f32_layer, K4's fn first layer, in the FP32 stage's order,
// the others in the bf16 fragment order), then every job's bias as float32.
struct FwdPackBf16 {
  long long w[kFwdJobs], b[kFwdJobs], total;
};

__host__ __device__ inline FwdPackBf16 fwd_pack_bf16(const Chain& fe, const Chain& fn, int jobs,
                                                     int f32_layer, int col_threads) {
  FwdPackBf16 o{};
  long long off = 0;
  for (int l = 0; l < jobs; ++l) {
    const Chain& c = l < fe.n ? fe : fn;
    const int li = l < fe.n ? l : l - fe.n, K = c.dim[li], M = c.dim[li + 1];
    o.w[l] = off;
    off += l == f32_layer ? (long long)K * round_up(M, col_threads) : bf16_packed_floats(K, M);
  }
  for (int l = 0; l < jobs; ++l) {
    const Chain& c = l < fe.n ? fe : fn;
    o.b[l] = off;
    off += round_up(c.dim[(l < fe.n ? l : l - fe.n) + 1], 4);
  }
  o.total = off;
  return o;
}

// The bf16 kernel's start: its share of the packed copy and the layer table,
// then the grid-wide barrier (cf. fwd_setup).
template <typename T>
__device__ const LayerTab* fwd_setup_bf16(float* __restrict__ packed, const FwdPlan& p,
                                          const Chain& fe, const Chain& fn, int jobs,
                                          int f32_layer) {
  const FwdPackBf16 o = fwd_pack_bf16(fe, fn, jobs, f32_layer, p.col_threads);
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  for (int l = 0; l < jobs; ++l)
    pack_layer_bf16<T>(packed + o.w[l], packed + o.b[l], l < fe.n ? fe : fn,
                       l < fe.n ? l : l - fe.n, l == f32_layer, p.col_threads, start, stride);
  LayerTab* tab = reinterpret_cast<LayerTab*>(smf(p.off_tab));
  if (threadIdx.x < jobs) {
    const int l = threadIdx.x, li = l < fe.n ? l : l - fe.n;
    const Chain& c = l < fe.n ? fe : fn;
    tab[l] = LayerTab{packed + o.w[l], packed + o.b[l], c.dim[li], c.dim[li + 1]};
  }
  cooperative_groups::this_grid().sync();  // the packed copy and the table are complete
  return tab;
}

int col_threads_of(int rows) { return 8 * (kWarps / (rows / 32)); }

}  // namespace
