// The knn message-passing edge forward for Hopper (sm_90a) in the bf16 mode: K5
// (search + gather + fe chain + masked sum) and K8 (the same from a given idx)
// with bf16 inputs, weights and outputs.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/knn_pallas.py called with bf16
// refs, as StepConfig.bf16 calls them on every knn MPGAN step:
//   - K5: _fused_impl_v4 (_fused_kernel_v4), with K1 in train mode;
//   - K8: _fwd_impl_v3 (_fwd_kernel_v3) and the older generations' forwards.
// What they compute, and where they round (the plain versions in knn_kernels.py
// hold the same):
//   - the search on the float32 values of xs and xf (knn_pallas.py:1763-1764),
//     the keys and idx as in the FP32 mode, the distances float32;
//   - z1 = f32(u1) + f32(u2m[idx, :h1]) (+ dist * f32(w_d)), a_0 = leaky(z1) times
//     K1's multiplier, in float32 (:1886-1891);
//   - each hidden layer z = bf16(a) @ W_bf16 with float32 accumulation, + f32(b),
//     LeakyReLU, K1 (_chain_ids -> mp_pallas._split_mlp_chain);
//   - the last layer's activations unrounded, times f32(mask), summed over the k
//     neighbours in float32 (/ k for the mean), rounded to bf16 once (:2004).
// idx is int32 and dists float32, as in the FP32 mode.
//
// Both run the bf16 forward pass written for this card (edge_fwd_bf16_tiles.cuh):
// the chain's bf16 weights resident in shared memory, a warp taking 16 pair rows
// (receiver x neighbour rank) through the whole chain with the activations chained
// in registers between the mma.sync products and no CTA barrier between them; K5's
// CTAs run K7's search (knn_stages.cuh, widening xs and xf as it stages them) for the
// jets of a chunk of their items before their warps take the chunk's items, K8 reads
// idx (clamped to [0, n)) and dists. The plan is knn_kernels.bf16_tile_plan's.
//
// What bounds it on this card: at the published knn-20 widths the hidden
// products are 2 x 20 x (96 x 160 + 160 x 192) = 1.8 MFLOP a receiver, 277
// MFLOP a 150-particle jet, 0.28 us of the dense bf16 tensor cores' 989 TFLOP/s;
// around them a_0's gathered element loads, K1's hash on every activation, the last
// layer's shuffles and the search's integer work (about 42 min/max a key; PERF.md:
// the phase clocks). Every sum has a fixed order: two launches on equal inputs are
// bit-identical, and K8 on K5's idx gives K5's output bit for bit.

#include "edge_fwd_bf16_tiles.cuh"

namespace {

// What K5 and K8 share of their launch: the chain, the rows' inputs, K1 and the plan.
int launch_knn_tiles(TileArgs a, const bf16* u1, const bf16* u2m, const bf16* w_d, bf16* out,
                     float* packed, long long packed_floats, int batch, int n, int h1, int k,
                     int n_hidden, const void* const* hidden_w, const void* const* hidden_b,
                     const int* hidden_dims, float alpha, int sum_agg, int dropout,
                     const int* seed, unsigned thr, float mult, int width, int warps,
                     int resident, int ti, int kc, int sspan_items, int grid, void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || n > (1 << 22) || h1 < 1 || h1 > kMaxWidth || k < 1 ||
      !fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1 ||
      (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  // offsets into u1, u2m and out are ints
  const int widest = h1 + 1 > fe.dim[fe.n] ? h1 + 1 : fe.dim[fe.n];
  if ((long long)batch * n * widest >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (fwd_pack_bf16(fe).total > packed_floats) return (int)cudaErrorInvalidValue;
  a.u1 = u1;
  a.u2 = u2m;
  a.w_d = w_d;
  a.out = out;
  a.packed = packed;
  a.seed = seed;
  a.batch = batch;
  a.n = n;
  a.h1 = h1;
  a.k = k;
  a.want_dists = w_d != nullptr;
  a.alpha = alpha;
  a.denom = sum_agg ? 1.f : (float)k;  // the mean divides by k
  a.drop_on = dropout != 0;
  a.drop.thr = thr;
  a.drop.mult = mult;
  TilePlan p{};
  p.width = width;
  p.warps = warps;
  p.resident = resident;
  p.ti = ti;
  p.jc = kc;
  p.sspan_items = sspan_items;
  return launch_tiles<true>(a, fe, p, grid, stream);
}

}  // namespace

extern "C" {

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset: K5's and K8's
// bf16 launches, which share this source's array.
int mpgan_knn_fused_layer_bf16_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K5 in the bf16 mode: bf16 xs, xf, u1, u2m, w_d (null without distances), the
// hidden weights and biases and out; idx_out and dists_out (int32, float32; null:
// not written); `packed` holds `packed_floats` floats (mp_kernels.fwd_packed_floats_bf16).
// The plan (knn_kernels.bf16_tile_plan): the width class, the warps a CTA, whether
// the weights are resident, ti receivers an item, kc ranks a chunk, sspan_items items a search covers
// at most, grid CTAs. Returns a
// cudaError_t code.
int mpgan_knn_fused_layer_bf16(const bf16* xs, const bf16* xf, const bf16* u1, const bf16* u2m,
                               const bf16* w_d, bf16* out, int* idx_out, float* dists_out,
                               float* packed, long long packed_floats, int batch, int n, int c,
                               int h1, int k, int self_loops, int want_dists, int n_hidden,
                               const void* const* hidden_w, const void* const* hidden_b,
                               const int* hidden_dims, float alpha, int sum_agg, int dropout,
                               const int* seed, unsigned thr, float mult, int width,
                               int warps, int resident, int ti, int kc, int sspan_items,
                               int grid, void* stream) {
  if (xs == nullptr || xf == nullptr || c < 1 || c > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (k + (self_loops ? 0 : 1) > n || (want_dists && w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  TileArgs a{};
  a.xs = xs;
  a.xf = xf;
  a.idx_out = idx_out;
  a.dists_out = dists_out;
  a.c = c;
  a.self_loops = self_loops != 0;
  a.key_bits = knn_key_bits(n);
  return launch_knn_tiles(a, u1, u2m, want_dists ? w_d : nullptr, out, packed, packed_floats,
                          batch, n, h1, k, n_hidden, hidden_w, hidden_b, hidden_dims, alpha,
                          sum_agg, dropout, seed, thr, mult, width, warps, resident, ti, kc,
                          sspan_items, grid, stream);
}

// K8 in the bf16 mode: bf16 u1, u2m, w_d, the hidden weights and biases and out; idx
// int32 and dists float32 (null with w_d: no distances); the plan as K5's without the
// search.
int mpgan_knn_edge_aggregate_bf16(const bf16* u1, const bf16* u2m, const int* idx,
                                  const float* dists, const bf16* w_d, bf16* out, float* packed,
                                  long long packed_floats, int batch, int n, int h1, int k,
                                  int n_hidden, const void* const* hidden_w,
                                  const void* const* hidden_b, const int* hidden_dims,
                                  float alpha, int sum_agg, int dropout, const int* seed,
                                  unsigned thr, float mult, int width, int warps, int resident,
                                  int ti, int kc, int grid, void* stream) {
  if (idx == nullptr || (dists == nullptr) != (w_d == nullptr)) return (int)cudaErrorInvalidValue;
  TileArgs a{};
  a.idx = idx;
  a.dists = dists;
  return launch_knn_tiles(a, u1, u2m, w_d, out, packed, packed_floats, batch, n, h1, k, n_hidden,
                          hidden_w, hidden_b, hidden_dims, alpha, sum_agg, dropout, seed, thr,
                          mult, width, warps, resident, ti, kc, 0, grid, stream);
}

}  // extern "C"
