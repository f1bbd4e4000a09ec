// Dense message-passing edge aggregate for Hopper (sm_90a) in the bf16 mode: K2
// (eval and train) and K4 with bf16 inputs, weights and outputs.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py called with bf16
// refs, as StepConfig.bf16 calls them on every dense MPGAN step:
//   - K2: _fwd_kernel_jets / _fwd_kernel (edge_aggregate, mp_pallas.py:319), with K1
//     in train mode;
//   - K4: _fwd_kernel_jets_fn / _fwd_kernel_fn (edge_aggregate_fn, mp_pallas.py:965).
// What they compute, and where they round (the plain versions in
// mp_kernels.py hold the same): a_0 = leaky(f32(u1) + f32(u2)) times K1's
// multiplier, in float32; each hidden layer z = bf16(a) @ W_bf16 with float32
// accumulation, + f32(b), LeakyReLU, K1; the last layer's activations unrounded,
// times f32(mask), summed over the senders in float32 (/ n for the mean); the
// output rounded to bf16 once. K4 (mp_pallas._fn_tail): fn's first layer on float32
// operands (the unrounded aggregate and f32(x)) with the bf16 weights' float32
// values, later layers on bf16-rounded inputs with float32 sums, the output rounded
// to bf16.
//
// Both run the bf16 forward pass written for this card (edge_fwd_bf16_tiles.cuh: the
// chain's bf16 weights resident in shared memory, a warp taking 16 pair rows through
// the whole chain with the activations chained between the mma.sync products, no CTA
// barrier between them), planned by mp_kernels.bf16_tile_plan. K4's launch has two
// phases: K2's pass, whose stores are the float32 aggregates (in fn's tiles of 16
// receivers, in a scratch the caller gives: B N h_out floats, 5.9 MB at B=256, so it
// stays in L2), then after a grid-wide barrier fn on 16 receivers a slot of 4 warps,
// each layer's weights copied into the CTA's shared memory in turn (fn's bf16
// weights, 256 KB at the published widths, do not fit beside fe's, and fe's are no
// longer needed): the first layer as FP32 FMA chains on CUDA cores in the FP32 pass's
// k order (agg rows, x rows, then the bias), the later ones on mma.sync as that pass
// ran them. Its output equals, bit for bit, what K4's bf16 mode gave when it ran on
// the FP32 pass (tests/data/k4_bf16_fp32_pass.npz).
//
// What bounds them on this card: at the flagship's widths the products are 85 MFLOP
// a 30-particle jet, 0.09 us of the dense bf16 tensor cores' 989 TFLOP/s, and K4's fn
// first layer 2 x 224 x 256 FLOP a receiver on the CUDA cores (0.88 GFLOP at B=256,
// 13 us at 67 TFLOP/s). The pass leaves around them a_0's element loads, K1's hash
// and the last layer's shuffles (PERF.md: its phase clocks). Every sum has a fixed
// order: two launches on equal inputs are bit-identical.

#include "edge_fwd_bf16_tiles.cuh"

extern "C" {

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset: K2's and K4's
// bf16 launches, which share this source's array.
int mpgan_edge_aggregate_bf16_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// Floats of the bf16 mode's packed scratch for a forward launch (K2 with n_fn =
// 0, else K4: fe's copy, then fn's); -1 on bad arguments. Only the card tests call
// it, to hold mp_kernels.fwd_packed_floats_bf16 to the launcher.
long long mpgan_edge_fwd_packed_floats_bf16(int n_hidden, const int* hidden_dims, int n_fn,
                                            const int* fn_dims) {
  Chain fe, fn{};
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (n_fn > 0 && !fill_chain(fn, n_fn, none, none, fn_dims)) return -1;
  const long long fe_floats = fwd_pack_bf16(fe).total;
  return n_fn > 0 ? fn_pack_bf16(fn, fe_floats).total : fe_floats;
}

// Shared memory (bytes) of the bf16 forward pass's plan (edge_fwd_bf16_tiles.cuh:
// tile_layout) for the chain `dims` (n_hidden + 1 widths) over `senders` senders
// (dense n, knn k); `search` (K5) with jets of n particles of c features;
// `warps` a CTA; `resident`: the weights in shared memory; K4 (n_fn > 0): fn's
// n_fn + 1 widths `fn_dims` and its `fn_slots`; -1 where the launcher refuses the
// plan. Only the card tests call it, to hold mp_kernels.bf16_tile_smem_bytes to
// the launcher.
long long mpgan_bf16_tile_smem(int n_hidden, const int* dims, int senders, int n, int c, int k,
                               int search, int width, int warps, int resident, int ti,
                               int jc, int sspan_items, int n_fn, const int* fn_dims,
                               int fn_slots) {
  Chain fe, fn{};
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, dims)) return -1;
  if (n_fn > 0 && !fill_chain(fn, n_fn, none, none, fn_dims)) return -1;
  TilePlan p{};
  p.width = width;
  p.warps = warps;
  p.resident = resident;
  p.ti = ti;
  p.jc = jc;
  p.sspan_items = sspan_items;
  p.fn_slots = fn_slots;
  return tile_layout(p, fe, senders, n, c, k, search != 0, n_fn > 0 ? &fn : nullptr) ? p.smem
                                                                                      : -1;
}

// K2 in the bf16 mode, eval (drop_on = 0) or train (K1 dropout: `seed` points to
// one int in device memory, keep threshold `thr`, multiplier `mult`). u1, u2, mask,
// the hidden weights and biases and out are bf16; `packed` holds `packed_floats`
// floats (mp_kernels.fwd_packed_floats_bf16). The plan (mp_kernels.bf16_tile_plan):
// the width class, the warps a CTA, whether the weights are resident, ti receivers an
// item, jc senders a chunk, grid CTAs. Returns a cudaError_t code.
int mpgan_edge_aggregate_bf16(const bf16* u1, const bf16* u2, const bf16* mask, bf16* out,
                              float* packed, long long packed_floats, int batch, int n, int h1,
                              int n_hidden, const void* const* hidden_w,
                              const void* const* hidden_b, const int* hidden_dims, float alpha,
                              int sum_agg, int drop_on, const int* seed, unsigned thr,
                              float mult, int width, int warps, int resident, int ti, int jc,
                              int grid, void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || h1 < 1 || !fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) ||
      fe.dim[0] != h1 || (drop_on && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  // offsets into u1, u2 and out are ints
  if ((long long)batch * n * (h1 > fe.dim[fe.n] ? h1 : fe.dim[fe.n]) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (fwd_pack_bf16(fe).total > packed_floats) return (int)cudaErrorInvalidValue;
  TileArgs a{};
  a.u1 = u1;
  a.u2 = u2;
  a.mask = mask;
  a.out = out;
  a.packed = packed;
  a.seed = seed;
  a.batch = batch;
  a.n = n;
  a.h1 = h1;
  a.ns = round_up(n, 8);
  a.alpha = alpha;
  a.denom = sum_agg ? 1.f : (float)n;  // the mean divides by the true n
  a.drop_on = drop_on != 0;
  a.drop.thr = thr;
  a.drop.mult = mult;
  TilePlan p{};
  p.width = width;
  p.warps = warps;
  p.resident = resident;
  p.ti = ti;
  p.jc = jc;
  return launch_tiles<false>(a, fe, p, grid, stream);
}

// K4 in the bf16 mode: u1, u2, mask, x, every weight and bias and out are bf16 (fn's
// first layer split as mpgan_edge_aggregate_fn's: its agg rows in fn_w[0], its x rows
// in fn_w0_lo); `packed` holds `packed_floats` floats (mp_kernels.fwd_packed_floats_bf16
// with fn), `aggs` ceil(B n / 16) * 16 * h_out floats. The plan
// (mp_kernels.bf16_tile_plan with fn): the width class, the warps a CTA (a multiple of
// 4), whether fe's weights are resident, ti, jc, fn's slots a CTA, grid CTAs. Returns a
// cudaError_t code.
int mpgan_edge_aggregate_fn_bf16(const bf16* u1, const bf16* u2, const bf16* mask,
                                 const bf16* x, bf16* out, float* packed,
                                 long long packed_floats, float* aggs, int batch, int n, int h1,
                                 int feat, int n_hidden, const void* const* hidden_w,
                                 const void* const* hidden_b, const int* hidden_dims, int n_fn,
                                 const void* const* fn_w, const void* fn_w0_lo,
                                 const void* const* fn_b, const int* fn_dims, float alpha,
                                 int sum_agg, float fn_alpha, int fn_act_last, int width,
                                 int warps, int resident, int ti, int jc, int fn_slots, int grid,
                                 void* stream) {
  Chain fe, fn;
  if (batch < 1 || n < 1 || h1 < 1 || !fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) ||
      fe.dim[0] != h1 || n_fn < 1 || !fill_chain(fn, n_fn, fn_w, fn_b, fn_dims) ||
      aggs == nullptr)
    return (int)cudaErrorInvalidValue;
  const int h_out = fe.dim[fe.n];
  if (feat < 1 || fn.dim[0] != h_out + feat) return (int)cudaErrorInvalidValue;
  fn.w0_lo = static_cast<const float*>(fn_w0_lo);
  fn.k0_split = h_out;
  fn.act_last = fn_act_last;
  // offsets into u1, u2, x, out and the aggregates are ints
  int widest = h1 > fe.dim[fe.n] ? h1 : fe.dim[fe.n];
  widest = widest > feat ? widest : feat;
  widest = widest > fn.dim[fn.n] ? widest : fn.dim[fn.n];
  if (((long long)batch * n + 15) / 16 * 16 * widest >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (fn_pack_bf16(fn, fwd_pack_bf16(fe).total).total > packed_floats)
    return (int)cudaErrorInvalidValue;
  TileArgs a{};
  a.u1 = u1;
  a.u2 = u2;
  a.mask = mask;
  a.x = x;
  a.aggs = aggs;
  a.feat = feat;
  a.fn_alpha = fn_alpha;
  a.out = out;
  a.packed = packed;
  a.batch = batch;
  a.n = n;
  a.h1 = h1;
  a.ns = round_up(n, 8);
  a.alpha = alpha;
  a.denom = sum_agg ? 1.f : (float)n;  // the mean divides by the true n
  TilePlan p{};
  p.width = width;
  p.warps = warps;
  p.resident = resident;
  p.ti = ti;
  p.jc = jc;
  p.fn_slots = fn_slots;
  return launch_tiles<false>(a, fe, p, grid, stream, &fn);
}

}  // extern "C"
