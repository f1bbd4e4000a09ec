// Dense message-passing edge aggregate for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces the Pallas TPU kernels of mpgan_tpu/ops/mp_pallas.py:
//   - K2 forward: edge_aggregate (_fwd_kernel_jets / _fwd_kernel), with K1, the
//     in-kernel dropout hash (_dropmul), in train mode,
//   - K4: edge_aggregate_fn (_fwd_kernel_jets_fn / _fwd_kernel_fn / _fn_tail).
// The backward, K3, is edge_aggregate_bwd.cu.
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
// per particle, so the kernel is bound by FP32 FMA issue. The design:
//   - the pass is edge_fwd_common.cuh's fwd_pass, which the knn forward (K5, K8)
//     runs too, on edge_products.cuh's products, the backward's own: this file
//     adds the dense rows (receiver x sender) and K4's node MLP. A pass is ti
//     receivers x jc senders in a buffer of 32, 64 or 128 pair rows
//     (5 x 25 = 125 at N = 150, 4 x 30 = 120 at N = 30), all 512 threads hold full
//     8 x TN register tiles of every product, and the weights come in k-slabs
//     through shared memory, 128-bit cp.async copies of a packed copy, the next
//     product's first slab in flight during the current product's last;
//   - the packed copy is made by the kernel itself: its CTAs pack the fe (and
//     K4's fn) weights into the caller's scratch, a share each, then meet at a
//     grid-wide barrier (a cooperative launch: at most one CTA an SM, all
//     resident), so no launch of its own and no cache keyed on the weights;
//   - a product writes its output over its input (the barrier before its
//     epilogue allows it), so a pass keeps one buffer as wide as the widest of
//     a_0 .. a_{L-1}; the last layer's activation is never stored: its epilogue
//     multiplies by mask[j] and sums each receiver's rows (a thread's 8 rows meet
//     at most two receivers: a receiver takes rs = max(jc, 8) rows) into partials
//     in the pass buffer it has just read, and one ordered add a (receiver,
//     column) makes the pass's share of the aggregate. No a_L buffer, no sweep
//     over it;
//   - the grid is persistent, a CTA an SM, each walking a contiguous range of
//     items. An item is `span` consecutive receivers of the batch's flat
//     receiver list (b * n + i), taken ti at a time, each over the senders of its
//     own jet in chunks of jc; a block may hold two jets' receivers, so none is
//     cut short at a jet's end. K2: span = ti. K4: span is a multiple of ti of at
//     most `rows` receivers (104 at N = 30 on 132 SMs, for the balance of the
//     grid's last round), whose aggregates are kept transposed in shared memory;
//     fn then runs on the item's [agg | x]
//     rows at once (TN = 8 for its 256-wide layers on 128 rows), each layer in
//     place (fn is row-wise, so an item needs no whole jets);
//   - train mode multiplies each activation by K1's multiplier after layer 1's
//     LeakyReLU (salt 0) and after hidden layer k (salt k), keyed on the global
//     pair id (b * n + i) * ns + j, ns = ceil(n / 8) * 8, so K3 replays the same
//     masks; a dropped element is stored as -0.0f;
//   - every sum has a fixed order (no atomics), so two launches on equal inputs
//     are bit-identical;
//   - no tensor cores and no TF32, so results hold FP32 parity with the plain
//     version.
// The pass shape, the weight slabs' size, the items and the grid are planned by
// the caller (mp_kernels.fwd_plan, CPU-tested); the launcher checks them and lays
// out the shared memory.

#include "edge_fwd_common.cuh"

namespace {

// grid = the plan's CTAs; dynamic shared memory as fwd_layout lays it out.
template <bool kFuseFn>
__global__ void __launch_bounds__(kThreads, 1)
    edge_aggregate_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                          const float* __restrict__ mask, const float* __restrict__ x,
                          float* __restrict__ out, float* __restrict__ packed, int batch, int n,
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
  in.u1 = u1;
  in.u2 = u2;
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
          smf(row.m)[r] = real ? __ldg(mask + sender) : 0.f;
        }
        const bool first = j0 == 0, last = j0 + p.jc >= n;
        // the product after the last layer's: fe's first again (this item's next
        // pass, or the next item's first), else fn's first (K4), else none
        const bool more = !last || blk + p.ti < n_recv;
        const int nxt = more || (!kFuseFn && t + 1 < t_end) ? 0 : (kFuseFn ? L : -1);
        fwd_pass<kFuseFn>(p, tab, L, h1, h_out, row, in, e, chain, ti_eff, jc_eff, blk, first,
                          last, nxt, denom, out + (size_t)(q_base + blk) * h_out, clock);
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
      f[(size_t)(h_out + c) * p.ldr + r] = r < n_recv ? __ldg(x + (size_t)(q_base + r) * feat + c)
                                                      : 0.f;
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
      out[(size_t)(q_base + r) * f_out + c] = f[(size_t)c * p.ldr + r];
    }
    // the next item's first pass overwrites these rows after its first barrier
    MPGAN_PHASE(clock, kPhaseTail);
  }
}

// Checks the caller's plan, lays out the shared memory and launches.
template <bool kFuseFn>
int launch(const float* u1, const float* u2, const float* mask, const float* x, float* out,
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
  const void* kernel = reinterpret_cast<const void*>(edge_aggregate_kernel<kFuseFn>);
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

extern "C" {

// Sizes of a forward launch (K2 with n_fn = 0, else K4) at passes of `rows` pair
// rows and `ti` receivers with weight slabs of `slab_floats`: sizes[0] the shared
// memory (bytes), sizes[1] the packed weights' scratch (floats). Returns -1 where
// the kernel does not run the shape. Only the card tests call it, to hold
// mp_kernels.fwd_smem_bytes and fwd_packed_floats to the launcher's layout.
int mpgan_edge_fwd_sizes(int n_hidden, const int* hidden_dims, int n_fn, const int* fn_dims,
                         int rows, int ti, int slab_floats, long long* sizes) {
  Chain fe, fn;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  if (n_fn > 0 && !fill_chain(fn, n_fn, none, none, fn_dims)) return -1;
  FwdPlan p{};
  p.rows = rows;
  p.ti = ti;
  p.jc = 1;
  p.row_arrays = 4;
  p.slab_floats = slab_floats;
  if (!fwd_layout(p, fe, n_fn > 0 ? &fn : nullptr)) return -1;
  sizes[0] = (long long)p.smem;
  sizes[1] = p.pk_off[fe.n + (n_fn > 0 ? fn.n : 0)];
  return 0;
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset.
int mpgan_edge_aggregate_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

// K2 forward. hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. The pass
// (ti receivers x jc senders in buffers of `rows`), the grid and the weight slabs'
// size are the caller's plan; `packed` is scratch for the packed weights
// (mp_kernels.fwd_packed_floats). Returns a
// cudaError_t code (0 on success); the launch is asynchronous on `stream`.
int mpgan_edge_aggregate(const float* u1, const float* u2, const float* mask, float* out,
                         float* packed, int batch, int n, int h1, int n_hidden,
                         const void* const* hidden_w,
                         const void* const* hidden_b, const int* hidden_dims, float alpha,
                         int sum_agg, int ti, int jc, int rows, int grid, int slab_floats,
                         void* stream) {
  Chain fe, fn{};
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims))
    return (int)cudaErrorInvalidValue;
  return launch<false>(u1, u2, mask, nullptr, out, packed, batch, n, h1, 0, fe, fn, alpha, 0.f,
                       sum_agg, 0, Drop{}, nullptr, ti, jc, rows, ti, grid, slab_floats, stream);
}

// K2 forward in train mode, with K1 dropout: `seed` points to one int in device
// memory, in [0, 2^31); keep threshold `thr` and multiplier `mult` as computed on
// the host (see Drop).
int mpgan_edge_aggregate_train(const float* u1, const float* u2, const float* mask, float* out,
                               float* packed, int batch, int n, int h1, int n_hidden,
                               const void* const* hidden_w, const void* const* hidden_b,
                               const int* hidden_dims, float alpha, int sum_agg,
                               const int* seed, unsigned thr, float mult, int ti, int jc,
                               int rows, int grid, int slab_floats, void* stream) {
  Chain fe, fn{};
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || seed == nullptr)
    return (int)cudaErrorInvalidValue;
  Drop drop{};
  drop.thr = thr;
  drop.mult = mult;
  return launch<false>(u1, u2, mask, nullptr, out, packed, batch, n, h1, 0, fe, fn, alpha, 0.f,
                       sum_agg, 1, drop, seed, ti, jc, rows, ti, grid, slab_floats, stream);
}

// K4. fn_w[0] is fn's first-layer weight rows for agg ([h_out, dims[1]]), fn_w0_lo its rows
// for x ([feat, dims[1]]); fn_dims has n_fn + 1 entries, fn_dims[0] == h_out + feat. An
// item is `span` consecutive receivers (a multiple of ti, at most rows).
int mpgan_edge_aggregate_fn(const float* u1, const float* u2, const float* mask, const float* x,
                            float* out, float* packed, int batch, int n, int h1, int feat,
                            int n_hidden,
                            const void* const* hidden_w, const void* const* hidden_b,
                            const int* hidden_dims, int n_fn, const void* const* fn_w,
                            const void* fn_w0_lo, const void* const* fn_b, const int* fn_dims,
                            float alpha, int sum_agg, float fn_alpha, int fn_act_last, int ti,
                            int jc, int rows, int span, int grid, int slab_floats,
                            void* stream) {
  Chain fe, fn;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims))
    return (int)cudaErrorInvalidValue;
  if (n_fn < 1 || !fill_chain(fn, n_fn, fn_w, fn_b, fn_dims)) return (int)cudaErrorInvalidValue;
  const int h_out = fe.dim[fe.n];
  if (feat < 1 || fn.dim[0] != h_out + feat) return (int)cudaErrorInvalidValue;
  fn.w0_lo = static_cast<const float*>(fn_w0_lo);
  fn.k0_split = h_out;
  fn.act_last = fn_act_last;
  return launch<true>(u1, u2, mask, x, out, packed, batch, n, h1, feat, fe, fn, alpha, fn_alpha,
                      sum_agg, 0, Drop{}, nullptr, ti, jc, rows, span, grid, slab_floats, stream);
}

const char* mpgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
