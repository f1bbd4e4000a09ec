// The forward pass of the edge kernels for Hopper (sm_90a), FP32 on CUDA cores:
// one pass function on edge_products.cuh's products, run by the dense forward
// (edge_aggregate.cu: K2, K4) and the knn forward (knn_stages.cuh: K5 in
// knn_fused.cu, K8 in knn_edge_aggregate.cu). The kernels differ only in where a
// pass's rows come from, which they write into the per-row arrays before the pass:
//   - dense rows: receiver i x sender j of one jet, mask[j], K1 id (b n + i) ns + j;
//   - knn rows: receiver i x neighbour rank s, sender j = sel[i, s], mask
//     u2m[b, j, h1], K1 id (b n + i) k + s, the edge's distance.
// The pass then makes a_0 = dropout(leaky(u1[i] + u2[j] (+ dist w_d))), runs the
// hidden layers, each written over its input (the barrier before a product's
// epilogue allows it), and the last layer's epilogue multiplies each row by its
// mask and sums each receiver's rows (a receiver takes rs = max(jc, 8) rows, so
// a thread's 8 rows meet at most two receivers) into head and tail partials in
// the pass buffer it has just read; one ordered add a (receiver, column) makes
// the pass's share of the aggregate. No a_L buffer, no sweep over it.
//
// The weights: the kernel's own CTAs pack them into the caller's scratch
// (packed_elem's order, a share each) and meet at a grid-wide barrier (a
// cooperative launch: at most one CTA an SM, all resident), so no launch of its
// own. Every sum has a fixed order (no atomics): two launches on equal inputs are
// bit-identical.
//
// What bounds a pass: its k loops, 8 x TN FMAs a k-step from shared-memory
// operands, at about 43 TFLOP/s on the card (scripts/torch_fma_peak.cu), against
// the 67 TFLOP/s the bound assumes; around them a_0, the epilogue barriers and
// the slab waits.
#pragma once

#include <cooperative_groups.h>

#include "edge_products.cuh"

namespace {

constexpr int kFwdJobs = 2 * kMaxLayers;  // fe layers, then fn's (K4)

// What a product needs of its layer, kept in shared memory: the loops then read
// no kernel parameter at a computed index (which would copy the chains to local
// memory).
struct LayerTab {
  const float* w;  // the packed weights
  const float* b;  // the bias
  int k, m;
};
constexpr int kTabFloats = kFwdJobs * (int)(sizeof(LayerTab) / sizeof(float));

struct FwdPlan : PassShape {
  int ti, jc;      // receivers x senders (knn: neighbour ranks) of a pass
  int rs;          // pass rows a receiver takes: jc, at least 8
  int span;        // dense: receivers an item holds (K2 ti, K4 a multiple of ti)
  long long items;
  int row_arrays;  // 4 (u1, u2, id, m), 5 with the edge's distance (knn)
  int off_act;     // the pass buffer, a_0 .. a_{L-1} each written over the last
  int off_agg;     // K2, knn: the item's aggregate [ti x h_out]; K4: agg^T [h_out x ldr]
                   // at 0, where fn then runs in place on [agg | x]^T
  int off_slab;    // the two weight slabs
  int off_part;    // the last layer's partial sums [2][rows / 8][h_out]: the pass buffer
                   // where it is large enough, else a region of their own
  int off_rows;    // the per-row arrays
  int off_tab;     // the layer table (LayerTab), fe layers then fn's
  int off_extra;   // the caller's own region (knn: the search's neighbours)
  size_t smem;
  long long pk_off[kFwdJobs + 1];  // packed weights: fe layers, then fn's (floats)
};

// The widest of a_0 .. a_{L-1}: the pass buffer's width.
int pass_width(const Chain& fe) {
  int w = fe.dim[0];
  for (int l = 1; l < fe.n; ++l) w = fe.dim[l] > w ? fe.dim[l] : w;
  return w;
}

// Lays out the shared memory of a pass shape and slab size that the caller
// planned (mp_kernels.fwd_plan, knn_kernels.knn_fwd_plan), and the packed
// weights. The region [0, off_slab) is at least `min_act` floats (knn: the search's
// scratch, which lives there between passes); `extra` floats for the caller
// follow the rest. False where the shape is not one the kernel runs or the
// memory does not fit.
bool fwd_layout(FwdPlan& p, const Chain& fe, const Chain* fn, int min_act = 0, int extra = 0) {
  const int slab = p.slab_floats;
  if (!set_shape(p, p.rows) || p.ti < 1 || p.jc < 1) return false;
  // at least the products' least slab, and 16-byte aligned for the second buffer
  if (slab < kSlabFloats || slab % 4 != 0) return false;
  p.slab_floats = slab;
  p.rs = p.jc > 8 ? p.jc : 8;
  if (p.ti * p.rs > p.rows || (p.row_arrays != 4 && p.row_arrays != 5)) return false;
  const int h_out = fe.dim[fe.n], width = pass_width(fe);
  p.pk_off[0] = 0;
  const int jobs = fe.n + (fn != nullptr ? fn->n : 0);
  for (int l = 0; l < jobs; ++l) {
    const Chain& c = l < fe.n ? fe : *fn;
    const int li = l < fe.n ? l : l - fe.n;
    p.pk_off[l + 1] = p.pk_off[l] + (long long)c.dim[li] *
                                        round_up(c.dim[li + 1], p.col_threads);
  }
  int act;
  if (fn != nullptr) {
    int fn_width = h_out + width;
    for (int l = 0; l <= fn->n; ++l) fn_width = fn->dim[l] > fn_width ? fn->dim[l] : fn_width;
    p.off_agg = 0;
    p.off_act = h_out * p.ldr;
    act = fn_width * p.ldr;
  } else {
    p.off_act = 0;
    p.off_agg = width * p.ldr;
    act = p.off_agg + round_up(p.ti * h_out, 4);
  }
  act = act > round_up(min_act, 4) ? act : round_up(min_act, 4);
  const int part = 2 * (p.rows / 8) * h_out;
  const bool own_part = part > width * p.ldr;
  const long long rest = (long long)act + p.row_arrays * p.ldr + kTabFloats +
                         (own_part ? part : 0) + extra;
  p.off_slab = act;
  p.off_rows = p.off_slab + 2 * p.slab_floats;
  p.off_tab = p.off_rows + p.row_arrays * p.ldr;  // a multiple of 4 floats
  p.off_part = own_part ? p.off_tab + kTabFloats : p.off_act;
  p.off_extra = p.off_tab + kTabFloats + (own_part ? part : 0);
  p.smem = (size_t)(rest + 2LL * p.slab_floats) * sizeof(float);
  return p.smem <= (size_t)kMaxSmemBytes;
}

// This CTA's share of the packed weights: layer l in packed_elem's order; fn's
// first layer takes its rows k >= k0_split from w0_lo. The grid's CTAs take every
// gridDim-th element.
__device__ void pack_share(float* __restrict__ packed, const FwdPlan& p, const Chain& fe,
                           const Chain& fn, int jobs) {
  int l = 0;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < p.pk_off[jobs];
       t += (long long)gridDim.x * kThreads) {
    while (t >= p.pk_off[l + 1]) ++l;
    const Chain& c = l < fe.n ? fe : fn;
    const int li = l < fe.n ? l : l - fe.n, M = c.dim[li + 1];
    const PackedElem e = packed_elem(t - p.pk_off[l], M, p.col_threads);
    const int split = li == 0 && l >= fe.n ? c.k0_split : c.dim[li];
    const float* w = e.row < split ? c.w[li] + (size_t)e.row * M
                                   : c.w0_lo + (size_t)(e.row - split) * M;
    packed[p.pk_off[l] + e.at] = e.col < M ? w[e.col] : 0.f;
  }
}

// The kernel's start: its share of the packed weights and the layer table, then
// the grid-wide barrier after which every CTA reads the whole packed copy.
__device__ __forceinline__ const LayerTab* fwd_setup(float* __restrict__ packed,
                                                     const FwdPlan& p, const Chain& fe,
                                                     const Chain& fn, int jobs) {
  pack_share(packed, p, fe, fn, jobs);
  LayerTab* tab = reinterpret_cast<LayerTab*>(smf(p.off_tab));
  if (threadIdx.x < jobs) {
    const int l = threadIdx.x, li = l < fe.n ? l : l - fe.n;
    const Chain& c = l < fe.n ? fe : fn;
    tab[l] = LayerTab{packed + p.pk_off[l], c.b[li], c.dim[li], c.dim[li + 1]};
  }
  cooperative_groups::this_grid().sync();  // the packed weights and the table are complete
  return tab;
}

// The per-row arrays at off_rows: u1, u2, id, m (and dist).
__device__ __forceinline__ RowArrays fwd_rows(const FwdPlan& p) {
  RowArrays row{};
  row.u1 = p.off_rows;
  row.u2 = p.off_rows + p.ldr;
  row.id = p.off_rows + 2 * p.ldr;
  row.m = p.off_rows + 3 * p.ldr;
  row.dist = p.row_arrays > 4 ? p.off_rows + 4 * p.ldr : 0;
  return row;
}

// The forward's products (C may be A) along the chain of weight slabs: `chain`
// holds the buffer and state of this product's first slab on entry and of the
// next one's on return; `next` (null: none) is the next product's packed weights,
// K_next x M_next.
__device__ void product_fwd(int A, int K, const float* W, int M, const PassShape& p,
                            const Epilogue& e, int slab, SlabChain& chain, const float* next,
                            int K_next, int M_next) {
  chain.next = next;
  chain.next_floats =
      next != nullptr ? first_slab_floats(K_next, M_next, p.col_threads, p.slab_floats) : 0;
  chain.buf = product_at<true>(A, K, W, M, slab, p, e, chain);
  chain.staged = next != nullptr;
}

// Adds a pass's share s of receiver ii's aggregate at column c. K2 and the knn
// kernels keep the item's aggregate in shared memory and store it, divided by
// `denom`, on the last chunk of senders (ranks), as T; K4 keeps it transposed
// for fn.
template <bool kFuseFn, typename T = float>
__device__ __forceinline__ void add_share(const FwdPlan& p, float s, int ii, int c, int h_out,
                                          int blk, bool first, bool last, float denom,
                                          T* __restrict__ out_row) {
  if (kFuseFn) {
    float* a = smf(p.off_agg) + (size_t)c * p.ldr + blk + ii;
    *a = first ? s : *a + s;
  } else {
    float* a = smf(p.off_agg) + ii * h_out + c;
    const float v = first ? s : *a + s;
    if (last)
      st_elem(out_row + c, v / denom);
    else
      *a = v;
  }
}

// a_0 [h1 x rows] from the row arrays, laid out for the transposed store: a warp
// takes 4 rows by 8 features at a time, so its 32 stores fall into 32 banks (ldr
// = 4 mod 32: row r and feature h sit in bank 4h + r) where a warp of 32 features
// of one row hit 4; its loads read 32 bytes of each of 4 rows. Twelve features of
// a lane's row are loaded together (24 loads in flight), so a pass waits for
// device memory once every 96 features. kDist (knn with distances): layer 1
// adds dist * w_d, product and sum rounded apart as the plain version rounds
// them: K6's recompute (build_a0) and the plain backward then see the same bits
// of z1, and a pre-activation within rounding of zero keeps its LeakyReLU slope.
// T: the element type of u1, u2 and w_d (the bf16 mode adds their float32 values).
template <bool kDist, typename T = float>
__device__ __noinline__ void build_a0_fwd(int dst_off, const PassShape& p, const RowArrays& row_in,
                                          const PassInputs& in_ref, int h1) {
  const PassInputs in = in_ref;  // copies: see product_tn
  const RowArrays row = row_in;
  const int ldr = p.ldr;
  float* dst = smf(dst_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = lane & 7, rl = lane >> 3;
  const T* __restrict__ u1 = rows_as<T>(in.u1);
  const T* __restrict__ u2 = rows_as<T>(in.u2);
  const T* __restrict__ w_d = rows_as<T>(in.w_d);
  constexpr int kH = 12;
  for (int rg = warp; rg < p.rows / 4; rg += kWarps) {
    const int r = 4 * rg + rl;
    const int o1 = smi(row.u1)[r], o2 = smi(row.u2)[r];
    const unsigned id = smu(row.id)[r];
    const float dist = kDist ? smf(row.dist)[r] : 0.f;
    for (int h0 = hl; h0 < h1; h0 += 8 * kH) {
      float z[kH];
#pragma unroll
      for (int k = 0; k < kH; ++k) {
        const int h = h0 + 8 * k;
        z[k] = o1 >= 0 && h < h1 ? ld_elem(u1 + o1 + h) + ld_elem(u2 + o2 + h) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kH; ++k) {
        const int h = h0 + 8 * k;
        if (h >= h1) break;
        float v = 0.f;
        if (o1 >= 0) {
          if (kDist) z[k] = __fadd_rn(z[k], __fmul_rn(dist, ld_elem(w_d + h)));
          v = leaky(z[k], in.alpha);
          if (in.drop_on) v = drop_store(v, in.drop, id, (unsigned)h, 0u);
        }
        dst[h * ldr + r] = v;
      }
    }
  }
}

// One pass of ti_eff receivers x jc_eff senders (knn: ranks) whose row arrays the
// caller has filled: a_0, the hidden products, the last product with the
// aggregate in its epilogue, and the ordered adds of the pass's share of each
// receiver's aggregate into out_blk's rows (blk: K4's offset of the pass's
// receivers in its item). `nxt` names the table entry whose first slab the last
// product starts (this CTA's next pass or fn's first layer), -1 none. Starts with
// the barrier after the row arrays' stores. It ends with its tail reading the
// partials and the aggregate: the caller's next stores into the row arrays may
// follow without a barrier, a store into the pass buffer or the aggregate not.
// T: the element type of u1, u2 (knn: u2m), w_d and out_blk (float: the bf16 modes
// run the pass of edge_fwd_bf16_tiles.cuh).
template <bool kFuseFn, typename T = float>
__device__ __forceinline__ void fwd_pass(const FwdPlan& p, const LayerTab* tab, int L, int h1,
                                         int h_out, const RowArrays& row, const PassInputs& in,
                                         Epilogue& e, SlabChain& chain, int ti_eff, int jc_eff,
                                         int blk, bool first, bool last, int nxt, float denom,
                                         T* __restrict__ out_blk, PhaseClock& clock) {
  __syncthreads();  // the row arrays are visible; the last pass is done with the buffer
  if (in.w_d != nullptr)
    build_a0_fwd<true, T>(p.off_act, p, row, in, h1);
  else
    build_a0_fwd<false, T>(p.off_act, p, row, in, h1);
  MPGAN_PHASE(clock, kPhaseRows);
  if (L == 0) {
    // no hidden layer: the masked sum of a_0 itself, in row order
    __syncthreads();
    for (int q = threadIdx.x; q < ti_eff * h_out; q += kThreads) {
      const int ii = q / h_out, c = q - ii * h_out;
      const float* col = smf(p.off_act) + (size_t)c * p.ldr + ii * p.rs;
      const float* m = smf(row.m) + ii * p.rs;
      float s = 0.f;
      for (int jj = 0; jj < jc_eff; ++jj) s = fmaf(m[jj], col[jj], s);
      add_share<kFuseFn, T>(p, s, ii, c, h_out, blk, first, last, denom,
                            out_blk + (size_t)ii * h_out);
    }
    __syncthreads();  // the next pass's row arrays overwrite the masks read here
    MPGAN_PHASE(clock, kPhaseLast);
    return;
  }
  e.kind = kEpiHidden;
  e.C = p.off_act;
  for (int l = 0; l + 1 < L; ++l) {
    const LayerTab a = tab[l], b = tab[l + 1];
    e.bias = a.b;
    e.salt = (unsigned)(l + 1);
    product_fwd(p.off_act, a.k, a.w, a.m, p, e, p.off_slab, chain, b.w, b.k, b.m);
  }
  MPGAN_PHASE(clock, kPhaseFwd);
  const LayerTab a = tab[L - 1], b = nxt < 0 ? LayerTab{} : tab[nxt];
  e.kind = kEpiAgg;
  e.bias = a.b;
  e.salt = (unsigned)L;
  product_fwd(p.off_act, a.k, a.w, a.m, p, e, p.off_slab, chain, b.w, b.k, b.m);
  __syncthreads();  // the partials are complete
  MPGAN_PHASE(clock, kPhaseLast);
  // receiver ii's rows [ii * rs, ii * rs + jc_eff) lie in the 8-row groups g0 ..
  // g1; a group that starts inside them holds ii as its head, the one before as
  // its tail
  const int groups = p.rows / 8;
  const float* part = smf(p.off_part);
  for (int q = threadIdx.x; q < ti_eff * h_out; q += kThreads) {
    const int ii = q / h_out, c = q - ii * h_out;
    const int r_begin = ii * p.rs, g1 = (r_begin + jc_eff - 1) / 8;
    float s = 0.f;
    for (int g = r_begin / 8; g <= g1; ++g)
      s += part[((8 * g >= r_begin ? 0 : groups) + g) * h_out + c];
    add_share<kFuseFn, T>(p, s, ii, c, h_out, blk, first, last, denom,
                          out_blk + (size_t)ii * h_out);
  }
  MPGAN_PHASE(clock, kPhaseTail);
}

// The epilogue fields that stay the same over a launch.
__device__ __forceinline__ Epilogue fwd_epilogue(const FwdPlan& p, const RowArrays& row,
                                                 float alpha, bool drop_on, const Drop& drop) {
  Epilogue e{};
  e.alpha = alpha;
  e.drop_on = drop_on;
  e.drop = drop;
  e.part = p.off_part;
  e.rs = p.rs;
  e.row = row;
  return e;
}

}  // namespace
