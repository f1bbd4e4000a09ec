// The bf16 mode's forward pass for Hopper (sm_90a), written for this card: the
// dense edge aggregate K2 and K4, the aggregate with the node MLP fn after it
// (edge_aggregate_bf16.cu), and the knn edge forward, K5 with its search and K8 from a
// given idx (knn_fused_bf16.cu).
//
// Replaces, with bf16 refs (StepConfig.bf16), the TPU kernels
//   - K2: mpgan_tpu/ops/mp_pallas.py:319 _edge_aggregate_fwd_impl (_fwd_kernel_jets,
//     _fwd_kernel, _split_mlp_chain);
//   - K4: mp_pallas.py:965 _edge_aggregate_fn_impl (_fwd_kernel_jets_fn, _fn_tail);
//   - K5: mpgan_tpu/ops/knn_pallas.py:2023 _fused_impl_v4 (_fused_kernel_v4);
//   - K8: knn_pallas.py:623, 1016, 1480 (_fwd_impl, _fwd_impl_v2, _fwd_impl_v3).
// What they compute, and where they round, is what the FP32 pass computed in its
// bf16 mode (edge_fwd_common.cuh with mma.sync in its k loops; the plain versions
// mp_kernels._chain_recompute, _fn_chain and knn_kernels._knn_chain are the rule):
// a_0 = leaky(f32(u1) + f32(u2) (+ dist * f32(w_d), product and sum rounded apart))
// times K1's multiplier, in float32; each hidden layer bf16(a) @ W_bf16 with float32
// accumulation, + f32(b), LeakyReLU, K1 with salt l + 1; the last layer unrounded,
// times the row's mask, summed over the senders (ranks) in float32 (/ n or / k for the
// mean) and rounded to bf16 once. K4 keeps that aggregate unrounded in float32 for fn:
// its first layer agg @ W_top + x @ W_bot + b on float32 operands (FMA chains), the
// later ones on bf16-rounded inputs with float32 sums, the output rounded once.
//
// What held that pass back: it is the FP32 pass with mma.sync in its k loops,
// one CTA of 16 warps an SM meeting at a barrier before every product, at every
// weight slab and before every epilogue, its A fragments read as scalars from float32
// activations in shared memory and every epilogue storing float32 there again (about
// 74,000 clocks a 128-row pass at K5's B=160 for 2,900 clocks of tensor-core work).
// This pass takes all of that away:
//   - the chain's bf16 weights fit in shared memory (96 x 160 + 160 x 192 bf16 = 90 KB
//     at the published widths), so each CTA copies the packed copy in once, with bulk
//     asynchronous copies (cp.async.bulk on an mbarrier) after the grid-wide barrier
//     that ends the packing, and it stays there for the launch: no slabs, no slab
//     barriers (a chain too wide for it reads the packed copy through L2 instead);
//   - a warp takes a tile of 16 pair rows from a_0 to the masked sum alone, with no
//     CTA barrier: a_0 and each hidden layer's output are written as the next
//     product's A fragments (bf16, lane (g, t) holding rows g and g + 8 at columns
//     2t, 2t + 1, 2t + 8, 2t + 9 of each 16-column step: a lane's accumulators of two
//     neighbouring n tiles are exactly its A fragment of one k step of the next
//     product) into a region of the warp's own, each lane to and from its own 16
//     bytes of a k step, so no lane waits for another; a hidden product holds its A
//     in registers, the last one reads it a k step at a time; B fragments are 64-bit
//     loads of the resident copy in fragment order (bf16_elem), 32 lanes on 256
//     contiguous bytes.
// Measured on the card (PERF.md): with the whole tile in registers this kernel ran
// slower than that pass, at 168-255 registers (12 or 8 warps) and 22,000-
// 34,000 instructions, too many for the instruction cache; with the activations in
// the warp's region, the loops over 64-column chunks not unrolled and the A registers
// sized by the hidden layers' inputs (the width class: 64, 128 or 256), it takes 128
// registers and 16 warps a CTA (12 on the 256 class). A launch without K5's search
// runs fewer warps where the shared memory holds fewer warps' regions.
//
// The same instruction on the same operands in the same k order as the FP32 pass's,
// and the same sums: the rows of an item are the FP32 pass's (a receiver takes rs =
// max(jc, 8) rows, jc the FP32 plan's sender or rank chunk; items of ti receivers
// where ti * rs is a multiple of 8, else the FP32 pass's ti, so every receiver's rows
// fall into 8-row groups as they did); the last layer's masked rows are summed over
// each 8-row group's head and tail receiver in the FP32 pass's tree (lane pairs xor 4,
// then 8, then 16) but as a reduce-scatter, 56 shuffles for 8 n tiles where its
// butterfly takes 192, and a receiver's groups are added in order, 0.f first,
// as the FP32 pass's tail adds them, then across sender chunks as add_share does. So the
// outputs equal that pass's in its bf16 mode bit for bit, two launches on equal inputs
// are bit-identical (no atomics), and K8 on K5's idx gives K5's output.
//
// K4 runs this pass with its aggregates stored unrounded into fn's tiles of 16
// receivers in device memory, then, after a second grid-wide barrier, fn (fn_phase):
// fn's bf16 weights (224 x 256 + 256 x 256 + 256 x 32 at the flagship's, 256 KB) do
// not fit beside fe's resident copy (93.6 KB) in a CTA's 227 KB, and fe's copy is no
// longer needed, so the CTA copies fn's layers into its shared memory one at a time,
// and slots of 4 warps take 16 receivers each (an m16 tile: the items' 8 receivers of
// 30 rows would leave half of it empty); fn's first layer stays on CUDA cores, FMA
// chains in the FP32 pass's k order (the aggregate's rows, then x's, then the bias),
// and its later layers take the same mma.sync operands in the same order, so K4's
// output equals the FP32 pass's bf16 mode's bit for bit.
//
// Warps meet only where they must: the grid-wide barrier and the copy at the start,
// and in K5 the neighbour search (knn_stages.cuh, K7's search), which the
// CTA runs together for the jets of a chunk of its items (at most sspan_items) into
// neighbour arrays in shared memory before its warps take the chunk's items. A warp
// takes the items of its CTA's contiguous range in turn (an item: ti receivers, all
// their sender chunks); with several chunks, the receivers' running aggregates sit in
// the warp's region.
//
// What bounds it on this card: the products are 2 x 30 x 30 x (96 x 160 + 160 x 192)
// = 85 MFLOP a 30-particle jet at the published widths, 0.09 us of the dense bf16
// tensor cores' 989 TFLOP/s (K4's fn first layer adds 2 x 30 x 224 x 256 = 3.4 MFLOP
// a jet at the CUDA cores' 67 TFLOP/s, 0.05 us). Around them a_0's element loads,
// K1's hash on every activation and the epilogues are most of a tile's instructions,
// and the warps wait on their latencies; with -DMPGAN_PHASE_CLOCKS every warp's clocks
// are summed per phase (edge_products.cuh: kPhaseTile*).
#pragma once

#include "edge_products_bf16.cuh"
#include "knn_stages.cuh"

namespace {

// Offsets (floats) of the pass's packed copy: layer l's bf16 weights in fragment order
// (bf16_elem) at w[l], then every bias as float32 at b[l]. The launch's own CTAs pack
// it into the caller's scratch (tile_setup); the resident copy is all of it.
struct FwdPackBf16 {
  long long w[kMaxLayers], b[kMaxLayers], total;
};

__host__ __device__ inline FwdPackBf16 fwd_pack_bf16(const Chain& fe) {
  FwdPackBf16 o{};
  long long off = 0;
  for (int l = 0; l < fe.n; ++l) {
    o.w[l] = off;
    off += bf16_packed_floats(fe.dim[l], fe.dim[l + 1]);
  }
  for (int l = 0; l < fe.n; ++l) {
    o.b[l] = off;
    off += round_up(fe.dim[l + 1], 4);
  }
  o.total = off;
  return o;
}

// K4's node MLP fn in the packed copy, after the fe chain's (from `base`): its first
// layer as bf16 rows [K x round_up(M, 64)] (the FP32 FMA chains of fn_first read two
// neighbouring columns a lane), the later layers in fragment order (bf16_elem), then
// its biases as float32.
struct FnPackBf16 {
  long long w[kMaxLayers], b[kMaxLayers], total;
};

__host__ __device__ inline long long fn_layer_floats(const Chain& fn, int l) {
  const int K = fn.dim[l], M = fn.dim[l + 1];
  return l == 0 ? (long long)K * round_up(M, 64) / 2 : bf16_packed_floats(K, M);
}

__host__ __device__ inline FnPackBf16 fn_pack_bf16(const Chain& fn, long long base) {
  FnPackBf16 o{};
  long long off = base;
  for (int l = 0; l < fn.n; ++l) {
    o.w[l] = off;
    off += fn_layer_floats(fn, l);
  }
  for (int l = 0; l < fn.n; ++l) {
    o.b[l] = off;
    off += round_up(fn.dim[l + 1], 4);
  }
  o.total = off;
  return o;
}

constexpr int kTileMaxRows = 256;         // rows of an item (ti * rs), at most 16 tiles
constexpr int kTileTabFloats = 4 * kMaxLayers;
constexpr unsigned kTileBulkBytes = 32768;  // bytes of one bulk copy instruction

// The width classes: the hidden layers' inputs (h1 and the hidden widths but the
// last layer's input) at most the class, whose A fragments a hidden product keeps in
// registers (class / 16 k steps of 4); the last layer reads its A a k step at a time
// from the warp's region, and outputs of any width up to kMaxWidth go 64 columns at a
// time. The most warps a CTA of each (ptxas -v: registers a thread under 65,536 / (32
// x warps)); a launch without K5's search may run fewer, where the shared memory
// holds fewer warps' regions.
__host__ __device__ constexpr int tile_warps(int width) { return width <= 128 ? 16 : 12; }
__host__ __device__ inline int tile_class(int widest) {
  return widest <= 64 ? 64 : widest <= 128 ? 128 : widest <= 256 ? 256 : 0;
}

// One launch's plan (mp_kernels.bf16_tile_plan, knn_kernels.bf16_tile_plan make it;
// tile_layout checks it and lays out the shared memory, in floats).
struct TilePlan {
  int width, warps;  // the width class and the warps a CTA (at most tile_warps(width))
  int resident;      // the weights in shared memory (else read from the packed copy:
                     // chains too wide for it, on the 256 class)
  int ti, jc, rs;    // receivers an item, senders (knn: ranks) a chunk, rows a receiver
  int chunks;        // chunks of senders (ranks) an item
  int blocks;        // knn: items a jet
  long long items;
  int sspan_items;   // K5: items a search covers at most (0: no search)
  int off_tab;       // the layer table (TileLayer), after the resident copy at 0 (if any)
  int off_bar;       // the copy's mbarrier
  int off_sel, off_seld;  // K5: neighbours and distances [sspan_items * ti, k]
  int off_work;      // the warps' tile regions (tile_item); K5: the search's scratch
                     // between chunks
  int act_floats;    // a warp's activations: the widest layer input in 16-column k steps
  int warp_floats;
  // K4's second phase (fn_phase), its shared memory from 0: the staged layer's
  // weights, its bias at fn_off_b, then fn_slots slots of fn_slot_floats (a 16-row
  // tile's input rows, then its activations as A fragments at fn_x_floats), the
  // staging's mbarrier at fn_off_bar
  int fn_slots;      // fn tiles a CTA takes at a time, 4 warps each
  int fn_off_b, fn_off_slots, fn_x_floats, fn_slot_floats, fn_off_bar;
  long long smem;    // bytes
};

// The resident copy of a layer: offsets (floats) of its packed bf16 weights and its
// float32 bias, and its shape.
struct TileLayer {
  int w, b, k, m;
};

// What a launch reads and writes. dense (K2, K4): u2 and mask; knn: u2 is u2m [B, n,
// h1 + 1], w_d (with distances, else null), K5 xs, xf and the outputs idx_out,
// dists_out, K8 idx and dists. K4: x [B, n, feat] and the receivers' float32
// aggregates `aggs`, written in fn's tiles of 16 receivers ([tile][column][16]).
struct TileArgs {
  const bf16* x;
  float* aggs;
  int feat;
  float fn_alpha;
  const bf16* u1;
  const bf16* u2;
  const bf16* mask;
  const bf16* w_d;
  const bf16* xs;
  const bf16* xf;
  const int* idx;
  const float* dists;
  int* idx_out;
  float* dists_out;
  bf16* out;
  float* packed;
  const int* seed;
  int batch, n, h1, ns, c, k, self_loops, want_dists, key_bits;
  float alpha, denom;
  int drop_on;
  Drop drop;
};

// A warp's tile region (floats from its start): the tile's activations as A
// fragments (16 rows x the widest layer input in bf16, act_floats; k step s at 128 s:
// lane l's four 32-bit registers at 4 l, so a lane reads and writes only its own 16
// bytes of each step, with no need to wait for the other lanes), then the running
// receiver sums of the last layer (lane l's two columns of its n tile of chunk cc at
// 64 cc + 2 l), then the receivers' aggregates over several chunks [ti x h_out].
constexpr int kTileRunFloats = 4 * 64;

// The widest input of the hidden layers (all but the last), or of every layer.
__host__ __device__ inline int chain_widest_input(const Chain& fe, bool hidden) {
  int w = 0;
  for (int l = 0; l < fe.n - (hidden ? 1 : 0); ++l) w = fe.dim[l] > w ? fe.dim[l] : w;
  return w;
}

// K4's second phase's shared memory (TilePlan: fn_*) for p.fn_slots slots; false where
// the kernel does not run fn or the plan's warps cannot hold the slots.
__host__ __device__ inline bool fn_layout(TilePlan& p, const Chain& fn) {
  if (fn.n < 1 || p.fn_slots < 1 || 4 * p.fn_slots > p.warps || p.warps % 4 != 0) return false;
  long long w = 0;
  int m = 0, f = 0;
  for (int l = 0; l < fn.n; ++l) {
    w = fn_layer_floats(fn, l) > w ? fn_layer_floats(fn, l) : w;
    m = fn.dim[l + 1] > m ? fn.dim[l + 1] : m;
    if (l > 0) f = (fn.dim[l] + 15) / 16 * 128 > f ? (fn.dim[l] + 15) / 16 * 128 : f;
  }
  p.fn_off_b = (int)w;
  p.fn_off_slots = p.fn_off_b + round_up(m, 4);
  p.fn_x_floats = 16 * fn.dim[0] > f ? 16 * fn.dim[0] : f;
  p.fn_slot_floats = p.fn_x_floats + f;
  p.fn_off_bar = p.fn_off_slots + p.fn_slots * p.fn_slot_floats;
  const long long smem = 4LL * (p.fn_off_bar + 4);
  p.smem = smem > p.smem ? smem : p.smem;
  return true;
}

// Checks a plan for the chain and lays out its shared memory: the resident copy (the
// packed weights, then the biases: fwd_pack_bf16; none where the plan is not
// resident), the layer table (K4: fe's layers, then fn's), the mbarrier, K5's
// neighbour arrays, the work region; K4's second phase (fn_layout) reuses all of it
// after its grid-wide barrier. A chain whose copy does not fit runs on the 256 class,
// reading its weights from the packed copy in device memory (through L2). `senders`: n
// (dense) or k (knn); `search`: K5 (n and c its jets' particles and features); `fn`:
// K4's node MLP. False where the kernel does not run the plan or it does not fit.
__host__ __device__ inline bool tile_layout(TilePlan& p, const Chain& fe, int senders, int n,
                                            int c, int k, bool search,
                                            const Chain* fn = nullptr) {
  const int cls = tile_class(chain_widest_input(fe, true));
  if (fe.n < 0 || cls == 0 || p.width != (p.resident ? cls : 256) || p.warps < 1 ||
      p.warps > tile_warps(p.width) || (search && p.warps != tile_warps(p.width)))
    return false;
  if (p.ti < 1 || p.jc < 1 || p.jc > senders || (search && p.sspan_items < 1)) return false;
  p.rs = p.jc > 8 ? p.jc : 8;
  if (p.ti * p.rs > kTileMaxRows) return false;
  p.chunks = (senders + p.jc - 1) / p.jc;
  const long long packed = fwd_pack_bf16(fe).total;
  const int h_out = fe.dim[fe.n];
  p.off_tab = p.resident ? (int)packed : 0;
  p.off_bar = p.off_tab + (fn != nullptr ? 2 : 1) * kTileTabFloats;
  const long long sel = search ? round_up(p.sspan_items * p.ti * k, 4) : 0;
  p.off_sel = p.off_bar + 4;
  p.off_seld = (int)(p.off_sel + sel);
  p.off_work = (int)(p.off_seld + sel);
  p.act_floats = (chain_widest_input(fe, false) + 15) / 16 * 128;
  p.warp_floats = p.act_floats + kTileRunFloats + (p.chunks > 1 ? round_up(p.ti * h_out, 4) : 0);
  long long work = (long long)p.warps * p.warp_floats;
  if (search && search_floats(n, c) > work) work = search_floats(n, c);
  p.smem = 4 * (p.off_work + work);
  if (fn != nullptr && !fn_layout(p, *fn)) return false;
  return p.smem <= kMaxSmemBytes;
}

#ifdef MPGAN_PHASE_CLOCKS
struct TileClock {
  long long last;
};
__device__ __forceinline__ void tile_clock_start(TileClock& c) { c.last = clock64(); }
__device__ __forceinline__ void tile_stamp(TileClock& c, int phase) {
  const long long now = clock64();
  if ((threadIdx.x & 31) == 0)
    atomicAdd(&g_phase_clocks[phase], (unsigned long long)(now - c.last));
  c.last = now;
}
#else
struct TileClock {};
__device__ __forceinline__ void tile_clock_start(TileClock&) {}
__device__ __forceinline__ void tile_stamp(TileClock&, int) {}
#endif

__device__ __forceinline__ unsigned sm_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Bulk asynchronous copies of `bytes` (a multiple of 16) from device memory at `src`
// into shared memory at `dst`, completing on the mbarrier `bar`; the calling thread
// has announced them on it (mbarrier.arrive.expect_tx).
__device__ __forceinline__ void bulk_copy(unsigned dst, const float* src, unsigned bytes,
                                          unsigned bar) {
  const unsigned long long s = reinterpret_cast<unsigned long long>(src);
  for (unsigned off = 0; off < bytes; off += kTileBulkBytes) {
    const unsigned size = bytes - off < kTileBulkBytes ? bytes - off : kTileBulkBytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(dst + off),
        "l"(s + off), "r"(size), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void init_barrier(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Every thread waits for the mbarrier's phase of parity `parity` to complete.
__device__ __forceinline__ void wait_barrier(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// K4's fn: its first layer's bf16 rows [K x round_up(M, 64)] (fn_first reads lane l's
// two columns 2l, 2l + 1 of each 64 as one 32-bit word), later layers in fragment
// order, every bias as float32; element t of every job by the thread with t = start
// (mod stride).
__device__ void pack_fn(float* __restrict__ packed, const Chain& fn, const FnPackBf16& o,
                        long long start, long long stride) {
  const int K = fn.dim[0], M = fn.dim[1], mp = round_up(M, 64);
  bf16* w0 = reinterpret_cast<bf16*>(packed + o.w[0]);
  for (long long t = start; t < (long long)K * mp; t += stride) {
    const int k = (int)(t / mp), col = (int)(t - (long long)k * mp);
    w0[t] = col < M ? bf16_row<bf16>(fn, 0, k, M)[col] : __float2bfloat16_rn(0.f);
  }
  for (long long t = start; t < M; t += stride)
    packed[o.b[0] + t] = __bfloat162float(rows_as<bf16>(fn.b[0])[t]);
  for (int l = 1; l < fn.n; ++l)
    pack_layer_bf16<bf16>(packed + o.w[l], packed + o.b[l], fn, l, start, stride);
}

// The launch's start: the CTAs pack the bf16 copy and the biases into `packed` (a
// share each; K4 fn's too, after fe's) and meet at the grid-wide barrier; then each
// CTA copies fe's copy into its shared memory at 0 with bulk asynchronous copies
// completing on an mbarrier, and every thread waits for it.
__device__ void tile_setup(float* __restrict__ packed, const Chain& fe, const TilePlan& p,
                           const Chain* fn = nullptr) {
  const FwdPackBf16 o = fwd_pack_bf16(fe);
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int l = 0; l < fe.n; ++l)
    pack_layer_bf16<bf16>(packed + o.w[l], packed + o.b[l], fe, l, start, stride);
  TileLayer* tab = reinterpret_cast<TileLayer*>(smf(p.off_tab));
  if (fn != nullptr) {
    const FnPackBf16 f = fn_pack_bf16(*fn, o.total);
    pack_fn(packed, *fn, f, start, stride);
    if (threadIdx.x < fn->n) {
      const int l = threadIdx.x;
      tab[fe.n + l] = TileLayer{(int)f.w[l], (int)f.b[l], fn->dim[l], fn->dim[l + 1]};
    }
  }
  // the packing's stores, then the async proxy's reads of them
  asm volatile("fence.proxy.async.global;" ::: "memory");
  if (threadIdx.x < fe.n) {
    const int l = threadIdx.x;
    tab[l] = TileLayer{(int)o.w[l], (int)o.b[l], fe.dim[l], fe.dim[l + 1]};
  }
  const unsigned bar = sm_addr(smf(p.off_bar));
  if (threadIdx.x == 0) init_barrier(bar);
  cooperative_groups::this_grid().sync();  // the packed copy is complete, the mbarrier set
  if (!p.resident) return;
  if (threadIdx.x == 0) {
    const unsigned bytes = (unsigned)(o.total * 4);
    asm volatile("fence.proxy.async.global;" ::: "memory");
    expect_bytes(bar, bytes);
    bulk_copy(sm_addr(smf(0)), packed, bytes, bar);
  }
  wait_barrier(bar, 0u);
}

// An item's chunk of senders (ranks): its receivers q0 .. q0 + ti_eff (flat, b n + i),
// the chunk's senders (ranks) j0 .. j0 + jc_eff, K5's neighbour slots at `sel` (ints
// from off_sel; -1: K8 reads idx).
struct TileItem {
  int q0, b, ti_eff, j0, jc_eff, sel;
  bool first, last;
};

// A pass row's inputs, as the FP32 pass's row arrays hold them (knn_stages.cuh,
// edge_aggregate.cuh): where its u1 and u2 rows start (o1 = -1 on a padded row), K1's
// id, the mask, the edge's distance.
struct TileRow {
  int o1, o2;
  unsigned id;
  float m, dist;
};

template <bool kKnn>
__device__ __forceinline__ TileRow tile_row(const TileArgs& a, const TilePlan& p,
                                            const TileItem& it, int r) {
  const int ii = r / p.rs, jj = r - ii * p.rs;
  const bool real = ii < it.ti_eff && jj < it.jc_eff;
  const int q = it.q0 + ii, s = it.j0 + jj;
  TileRow w;
  w.o1 = real ? q * a.h1 : -1;
  if (!kKnn) {
    // dense rows: receiver q x sender s of its jet
    const int sender = (q / a.n) * a.n + s;
    w.o2 = real ? sender * a.h1 : 0;
    w.id = (unsigned)q * (unsigned)a.ns + (unsigned)s;
    w.m = real ? ld_elem(a.mask + sender) : 0.f;
    w.dist = 0.f;
  } else {
    // knn rows: receiver q x neighbour rank s, the sender from K5's search or idx
    int j = 0;
    float dist = 0.f;
    if (real) {
      if (it.sel >= 0) {
        const int at = it.sel + ii * a.k + s;
        j = smi(p.off_sel)[at];
        if (a.want_dists) dist = smf(p.off_seld)[at];
      } else {
        const size_t at = (size_t)q * a.k + s;
        j = min(max(__ldg(a.idx + at), 0), a.n - 1);
        if (a.want_dists) dist = __ldg(a.dists + at);
      }
    }
    const int hs = a.h1 + 1, sender = it.b * a.n + j;
    w.o2 = sender * hs;
    w.id = (unsigned)q * (unsigned)a.k + (unsigned)s;
    w.m = real ? ld_elem(a.u2 + (size_t)sender * hs + a.h1) : 0.f;
    w.dist = dist;
  }
  return w;
}

// a_0 at column c of a row (the FP32 pass's build_a0_fwd, element for element).
__device__ __forceinline__ float a0_value(const TileArgs& a, const Drop& drop, const TileRow& w,
                                          int c) {
  if (w.o1 < 0 || c >= a.h1) return 0.f;
  float z = ld_elem(a.u1 + w.o1 + c) + ld_elem(a.u2 + w.o2 + c);
  if (a.w_d != nullptr) z = __fadd_rn(z, __fmul_rn(w.dist, ld_elem(a.w_d + c)));
  float v = leaky(z, a.alpha);
  if (a.drop_on) v = drop_store(v, drop, w.id, (unsigned)c, 0u);
  return v;
}

// Two neighbouring bf16 elements as float32: one 32-bit load where they share an
// aligned word.
__device__ __forceinline__ void ld_pair(const bf16* p, bool aligned, float& x, float& y) {
  if (aligned) {
    const unsigned v = *reinterpret_cast<const unsigned*>(p);
    x = __uint_as_float(v << 16);
    y = __uint_as_float(v & 0xffff0000u);
  } else {
    x = ld_elem(p);
    y = ld_elem(p + 1);
  }
}

// a_0 at columns c and c + 1 (c even) of a row, packed as the product's bf16 pair
// (a0_value's arithmetic, element for element). The rows' u1 start on a 4-byte
// boundary where h1 is even and u1 does; dense u2 rows too, knn u2m rows (h1 + 1
// wide) on either.
template <bool kKnn>
__device__ __forceinline__ unsigned a0_pair(const TileArgs& a, const Drop& drop,
                                            const TileRow& w, int c) {
  if (w.o1 < 0 || c >= a.h1) return 0u;
  if (c + 1 >= a.h1) return pack_bf16x2(a0_value(a, drop, w, c), 0.f);
  const bool even = (a.h1 & 1) == 0;
  const bool even1 = even && (reinterpret_cast<size_t>(a.u1) & 3) == 0;
  const bool even2 = !kKnn && even && (reinterpret_cast<size_t>(a.u2) & 3) == 0;
  float x1, y1, x2, y2;
  ld_pair(a.u1 + w.o1 + c, even1, x1, y1);
  ld_pair(a.u2 + w.o2 + c, even2, x2, y2);
  float z[2] = {x1 + x2, y1 + y2};
  float v[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if (a.w_d != nullptr) z[d] = __fadd_rn(z[d], __fmul_rn(w.dist, ld_elem(a.w_d + c + d)));
    v[d] = leaky(z[d], a.alpha);
    if (a.drop_on) v[d] = drop_store(v[d], drop, w.id, (unsigned)(c + d), 0u);
  }
  return pack_bf16x2(v[0], v[1]);
}

// Receiver q's aggregate at column c: K2's output, rounded; K4's (kFn) unrounded into
// its fn tile of 16 receivers.
template <bool kFn>
__device__ __forceinline__ void tile_store(const TileArgs& a, int q, int h_out, int c, float v) {
  if constexpr (kFn)
    a.aggs[((size_t)(q >> 4) * h_out + c) * 16 + (q & 15)] = v;
  else
    st_elem(a.out + (size_t)q * h_out + c, v);
}

// Adds receiver ii's share v of a chunk at column c, as add_share does: the warp's
// running aggregate `agg` over several chunks, the aggregate (/ denom) stored on the
// last.
template <bool kFn>
__device__ __forceinline__ void tile_emit(const TileArgs& a, const TilePlan& p,
                                          const TileItem& it, float* agg, int h_out, int ii,
                                          int c, float v) {
  if (p.chunks == 1) {
    tile_store<kFn>(a, it.q0 + ii, h_out, c, v / a.denom);
    return;
  }
  float* s = agg + ii * h_out + c;
  const float w = it.first ? v : *s + v;
  if (it.last)
    tile_store<kFn>(a, it.q0 + ii, h_out, c, w / a.denom);
  else
    *s = w;
}

// Which receivers the head and tail partials of an item's 8-row group G belong to
// (the FP32 pass's tail: a receiver adds its groups in order, a group's head partial
// where the group starts at or after the receiver's first row, else its tail).
struct TileGroup {
  int head, tail;          // the receivers
  bool add_head, new_head, end_head, add_tail, end_tail;
};
__device__ __forceinline__ TileGroup tile_group(int G, const TilePlan& p, const TileItem& it) {
  TileGroup x;
  x.head = 8 * G / p.rs;
  const int g1 = (x.head * p.rs + it.jc_eff - 1) / 8;  // the head receiver's last group
  x.add_head = x.head < it.ti_eff && G <= g1;
  x.new_head = x.head * p.rs == 8 * G;
  x.end_head = G == g1;
  x.tail = x.head + 1;
  x.add_tail = x.tail < it.ti_eff && x.tail * p.rs < 8 * G + 8;
  x.end_tail = G == (x.tail * p.rs + it.jc_eff - 1) / 8;
  return x;
}

template <bool kFn>
__device__ __forceinline__ void group_add(const TileArgs& a, const TilePlan& p,
                                          const TileItem& it, float* agg, int h_out,
                                          const TileGroup& x, int c, float head, float tail,
                                          float& run) {
  if (x.add_head) {
    run = x.new_head ? 0.f + head : run + head;
    if (x.end_head) tile_emit<kFn>(a, p, it, agg, h_out, x.head, c, run);
  }
  if (x.add_tail) {
    run = 0.f + tail;
    if (x.end_tail) tile_emit<kFn>(a, p, it, agg, h_out, x.tail, c, run);
  }
}

// A weight fragment and a bias: from the resident copy (kRes, shared-memory loads), or
// from the packed copy in device memory, which this launch wrote (so not through the
// read-only cache: ld.global.cg).
template <bool kRes>
__device__ __forceinline__ uint2 ld_frag(const float* p) {
  if constexpr (kRes)
    return *reinterpret_cast<const uint2*>(p);
  else
    return __ldcg(reinterpret_cast<const uint2*>(p));
}
template <bool kRes>
__device__ __forceinline__ float ld_bias(const float* p) {
  if constexpr (kRes)
    return *p;
  else
    return __ldcg(p);
}

// The resident copy (smf(0)) or the packed copy.
template <bool kRes>
__device__ __forceinline__ const float* weights_base(const TileArgs& a) {
  if constexpr (kRes)
    return smf(0);
  else
    return a.packed;
}

// acc (8 n tiles from n tile 8 cc) = bf16 A [16 x K] @ W, W at `w` in fragment order
// (k steps of ntiles x 64 floats), A in registers (KS k steps).
template <int KS, bool kRes>
__device__ __forceinline__ void tile_products(float (&acc)[8][4], const unsigned (&A)[KS][4],
                                              const float* w, int steps, int ntiles, int cc) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s < steps) {
      const float* ws = w + (size_t)(s * ntiles + 8 * cc) * 64;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (8 * cc + q < ntiles) mma_bf16(acc[q], A[s], ld_frag<kRes>(ws + q * 64));
    }
  }
}

// The same with A read a k step at a time from the warp's region (the last layer,
// whose epilogue leaves the region as it is).
template <bool kRes>
__device__ __forceinline__ void tile_products_act(float (&acc)[8][4], const float* act,
                                                  const float* w, int steps, int ntiles,
                                                  int cc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    const uint4 v = *reinterpret_cast<const uint4*>(act + s * 128 + 4 * lane);
    const unsigned A[4] = {v.x, v.y, v.z, v.w};
    const float* ws = w + (size_t)(s * ntiles + 8 * cc) * 64;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (8 * cc + q < ntiles) mma_bf16(acc[q], A, ld_frag<kRes>(ws + q * 64));
  }
}

// The tile's A fragments of a product with `steps` k steps, from its region.
template <int KS>
__device__ __forceinline__ void tile_load_a(unsigned (&A)[KS][4], const float* act, int steps) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < steps) v = *reinterpret_cast<const uint4*>(act + s * 128 + 4 * lane);
    A[s][0] = v.x, A[s][1] = v.y, A[s][2] = v.z, A[s][3] = v.w;
  }
}

// A hidden layer: bias, LeakyReLU and K1 (salt) on the accumulators, packed into the
// next product's A fragments in the tile's region (which the A registers have
// left); columns past M are zero, as the next product's k past K. The loop over
// chunks of 8 n tiles is not unrolled: it keeps the code small enough for the
// instruction cache.
template <int kW, bool kRes>
__device__ __forceinline__ void tile_hidden(float* act, const TileLayer ly, const TileArgs& a,
                                            const Drop& drop, unsigned id_lo, unsigned id_hi,
                                            unsigned salt, TileClock& clk) {
  constexpr int KS = kW / 16;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int steps = (ly.k + 15) / 16, ntiles = (ly.m + 7) / 8;
  const float* w = weights_base<kRes>(a) + ly.w + lane * 2;
  const float* bias = weights_base<kRes>(a) + ly.b;
  unsigned A[KS][4];
  tile_load_a<KS>(A, act, steps);
#pragma unroll 1
  for (int cc = 0; 8 * cc < ntiles; ++cc) {
    float acc[8][4];
    tile_products<KS, kRes>(acc, A, w, steps, ntiles, cc);
    tile_stamp(clk, kPhaseTileLoop);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = 8 * cc + q;
      if (j < ntiles) {
        float v[4];  // row g at columns c, c + 1, then row g + 8
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int c = 8 * j + 2 * t + d;
          float lo = 0.f, hi = 0.f;
          if (c < ly.m) {
            const float bc = ld_bias<kRes>(bias + c);
            lo = leaky(acc[q][d] + bc, a.alpha);
            hi = leaky(acc[q][2 + d] + bc, a.alpha);
            if (a.drop_on) {
              lo = drop_store(lo, drop, id_lo, (unsigned)c, salt);
              hi = drop_store(hi, drop, id_hi, (unsigned)c, salt);
            }
          }
          v[d] = lo;
          v[2 + d] = hi;
        }
        // n tile j is half j & 1 of the next product's k step j / 2
        *reinterpret_cast<uint2*>(act + (j >> 1) * 128 + 4 * lane + 2 * (j & 1)) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
      }
    }
    tile_stamp(clk, kPhaseTileEpi);
  }
  if (ntiles & 1)  // the last k step's second half: no columns
    *reinterpret_cast<uint2*>(act + (ntiles >> 1) * 128 + 4 * lane + 2) = make_uint2(0u, 0u);
}

// Lane pairs (xor `o`) exchange half of their sums: a lane whose bit is set keeps the
// second of each pair (x, y) and sends the first, and adds what its partner sends, so
// each keeps the sum of its own and its partner's value of the one it keeps.
__device__ __forceinline__ float halve(float x, float y, bool bit, int o) {
  const float keep = bit ? y : x, send = bit ? x : y;
  return keep + __shfl_xor_sync(0xffffffffu, send, o);
}

// The last layer of tile rt: each row's activation times its mask, summed over each
// 8-row group's head and tail receiver by the 8 lanes of a column, in the FP32 pass's
// tree (pairs of lanes xor 4, then 8, then 16) but as a reduce-scatter: lane g ends
// with the sums of n tile 8 cc + g alone (56 shuffles for 8 n tiles, not 192; each
// sum is the same two operands added, so the bits are the butterfly's), and adds them
// to its running receiver sums in group order.
template <bool kRes, bool kFn>
__device__ __forceinline__ void tile_last(const float* act, float* run, const TileLayer ly,
                                          const TileArgs& a, const Drop& drop,
                                          const TilePlan& p, const TileItem& it, float* agg,
                                          int rt, const TileRow& lo_row, const TileRow& hi_row,
                                          unsigned salt, TileClock& clk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool b0 = g & 1, b1 = g & 2, b2 = g & 4;
  const int steps = (ly.k + 15) / 16, ntiles = (ly.m + 7) / 8, M = ly.m;
  const float* w = weights_base<kRes>(a) + ly.w + lane * 2;
  const float* bias = weights_base<kRes>(a) + ly.b;
  const int G = 2 * rt;  // rows g and g + 8 are row g of groups G and G + 1
  const int head_lo = (8 * G / p.rs + 1) * p.rs - 8 * G;
  const int head_hi = ((8 * G + 8) / p.rs + 1) * p.rs - 8 * G - 8;
  const TileGroup x_lo = tile_group(G, p, it), x_hi = tile_group(G + 1, p, it);
#pragma unroll 1
  for (int cc = 0; 8 * cc < ntiles; ++cc) {
    float acc[8][4];
    tile_products_act<kRes>(acc, act, w, steps, ntiles, cc);
    tile_stamp(clk, kPhaseTileLoop);
    float half[2][8];  // per 4 n tiles: after two halvings, lane (b1, b0)'s n tile's sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s[4][8];  // per n tile, per column d: head lo, tail lo, head hi, tail hi
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = 4 * h + u;
        // columns past the n tiles (zero weights) stay out of the stores below
        const int cb = min(8 * (8 * cc + q) + 2 * t, M - 1);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int c = min(cb + d, M - 1);
          const float bc = ld_bias<kRes>(bias + c);
          float lo = leaky(acc[q][d] + bc, a.alpha), hi = leaky(acc[q][2 + d] + bc, a.alpha);
          if (a.drop_on) {
            lo = drop_store(lo, drop, lo_row.id, (unsigned)c, salt);
            hi = drop_store(hi, drop, hi_row.id, (unsigned)c, salt);
          }
          lo *= lo_row.m, hi *= hi_row.m;
          s[u][4 * d] = g < head_lo ? lo : 0.f;
          s[u][4 * d + 1] = g < head_lo ? 0.f : lo;
          s[u][4 * d + 2] = g < head_hi ? hi : 0.f;
          s[u][4 * d + 3] = g < head_hi ? 0.f : hi;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p0 = halve(s[0][i], s[1][i], b0, 4), p1 = halve(s[2][i], s[3][i], b0, 4);
        half[h][i] = halve(p0, p1, b1, 8);
      }
    }
    float keep[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) keep[i] = halve(half[0][i], half[1][i], b2, 16);
    tile_stamp(clk, kPhaseTileLast);
    const int j = 8 * cc + g;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int c = 8 * j + 2 * t + d;
      if (j < ntiles && c < M) {
        float& r = run[64 * cc + 2 * lane + d];
        float v = r;
        group_add<kFn>(a, p, it, agg, M, x_lo, c, keep[4 * d], keep[4 * d + 1], v);
        group_add<kFn>(a, p, it, agg, M, x_hi, c, keep[4 * d + 2], keep[4 * d + 3], v);
        r = v;
      }
    }
    tile_stamp(clk, kPhaseTileAgg);
  }
}

// A tile's a_0 into its region as the first product's A fragments: lane (g, t) makes
// rows g and g + 8 at columns 2t, 2t + 1, 2t + 8 and 2t + 9 of each 16-column step.
template <bool kKnn>
__device__ __forceinline__ void tile_a0(float* act, const TileArgs& a, const Drop& drop,
                                        const TileRow& lo, const TileRow& hi) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll 1
  for (int s = 0; s < (a.h1 + 15) / 16; ++s) {
    const int c = 16 * s + 2 * t;
    *reinterpret_cast<uint4*>(act + s * 128 + 4 * lane) =
        make_uint4(a0_pair<kKnn>(a, drop, lo, c), a0_pair<kKnn>(a, drop, hi, c),
                   a0_pair<kKnn>(a, drop, lo, c + 8), a0_pair<kKnn>(a, drop, hi, c + 8));
  }
}

// One item (ti receivers, every chunk of their senders or ranks) on one warp, in its
// region `wr` (act_floats, kTileRunFloats, then the aggregates). `sel`: K5's
// neighbour slots of the item (-1: none). kFn: K4, the aggregates into a.aggs.
template <int kW, bool kKnn, bool kRes, bool kFn = false>
__device__ __forceinline__ void tile_item(const TileArgs& a, const Drop& drop, const TilePlan& p,
                                       const TileLayer* tab, int L, int h_out, long long t,
                                       int sel, float* wr, TileClock& clk) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  float* act = wr;
  float* run = wr + p.act_floats;
  float* agg = run + kTileRunFloats;
  TileItem it;
  it.sel = sel;
  if (kKnn) {
    it.b = (int)(t / p.blocks);
    const int i0 = (int)(t - (long long)it.b * p.blocks) * p.ti;
    it.q0 = it.b * a.n + i0;
    it.ti_eff = min(p.ti, a.n - i0);
  } else {
    it.b = 0;
    it.q0 = (int)t * p.ti;
    it.ti_eff = min(p.ti, a.batch * a.n - it.q0);
  }
  const int senders = kKnn ? a.k : a.n;
  for (int j0 = 0; j0 < senders; j0 += p.jc) {
    it.j0 = j0;
    it.jc_eff = min(p.jc, senders - j0);
    it.first = j0 == 0;
    it.last = j0 + p.jc >= senders;
    if (L == 0) {
      // no hidden layer: the masked sum of a_0 itself, row by row, as the FP32 pass sums it
      for (int q = lane; q < it.ti_eff * h_out; q += 32) {
        const int ii = q / h_out, c = q - ii * h_out;
        float s = 0.f;
        for (int jj = 0; jj < it.jc_eff; ++jj) {
          const TileRow w = tile_row<kKnn>(a, p, it, ii * p.rs + jj);
          s = fmaf(w.m, a0_value(a, drop, w, c), s);
        }
        tile_emit<kFn>(a, p, it, agg, h_out, ii, c, s);
      }
      continue;
    }
    const int tiles = ((it.ti_eff - 1) * p.rs + it.jc_eff + 15) / 16;
    for (int rt = 0; rt < tiles; ++rt) {
      const TileRow lo = tile_row<kKnn>(a, p, it, 16 * rt + g);
      const TileRow hi = tile_row<kKnn>(a, p, it, 16 * rt + g + 8);
      tile_a0<kKnn>(act, a, drop, lo, hi);
      tile_stamp(clk, kPhaseTileRows);
      for (int l = 0; l + 1 < L; ++l)
        tile_hidden<kW, kRes>(act, tab[l], a, drop, lo.id, hi.id, (unsigned)(l + 1), clk);
      tile_last<kRes, kFn>(act, run, tab[L - 1], a, drop, p, it, agg, rt, lo, hi, (unsigned)L,
                           clk);
    }
  }
}

// K4's second phase: fn on every receiver, 16 receivers a tile (its rows in the
// aggregates' layout), a slot of 4 warps a tile, fn_slots tiles of a CTA at a time
// (CTA c takes tiles c, c + grid, ...). Layer by layer the CTA stages the layer's
// weights and bias into its shared memory with bulk copies (the whole CTA meets before
// each: the last layer's reads are done, the slots' writes visible), then each slot's
// warps take 64 of its output columns in turn. fn's first layer runs on CUDA cores
// (fn_first), the later ones on mma.sync (fn_mma), as the FP32 pass ran them in K4's
// bf16 mode, in the same k order: the outputs are that pass's bit for bit.

// The tile's input rows [agg | x] as float32, k-major ([K][16]: a k step reads the 16
// rows as four 128-bit broadcasts), rows past the batch zero; `gt`: the thread in the
// slot's 128.
__device__ __forceinline__ void fn_rows(float* X, const TileArgs& a, long long tile, int h_out,
                                        int n_valid, int gt) {
  const float4* src = reinterpret_cast<const float4*>(a.aggs + (size_t)tile * h_out * 16);
  float4* dst = reinterpret_cast<float4*>(X);
  for (int i = gt; i < h_out * 4; i += 128) {
    // written by other CTAs of this launch: through L2, not the read-only cache
    float4 v = __ldcg(src + i);
    const int r = (i & 3) * 4;
    if (r + 4 > n_valid) {
      v.x = r < n_valid ? v.x : 0.f;
      v.y = r + 1 < n_valid ? v.y : 0.f;
      v.z = r + 2 < n_valid ? v.z : 0.f;
      v.w = 0.f;
    }
    dst[i] = v;
  }
  for (int i = gt; i < a.feat * 16; i += 128) {
    const int f = i >> 4, r = i & 15;
    X[(h_out + f) * 16 + r] =
        r < n_valid ? ld_elem(a.x + ((size_t)tile * 16 + r) * a.feat + f) : 0.f;
  }
}

// fn's first layer on the tile: agg (float32) and x against the float32 values of the
// bf16 weights, FMA chains in k order from 0.f (the FP32 stage's product_tn), + bias,
// LeakyReLU (slope 1: linear). Each warp of the slot (part) takes 64 columns at a time,
// a lane two neighbouring columns of all 16 rows. Hidden: written as the next
// product's A fragments at y_off (columns past M zero); last: the output rows. The
// slot's regions are named by their offsets (smf), so that they are read and written
// with shared-memory instructions.
__device__ __noinline__ void fn_first(int x_off, int y_off, const TileLayer ly, bool last,
                                      float alpha, const TileArgs& a, const TilePlan& p,
                                      long long tile, int n_valid, int part) {
  const float* X = smf(x_off);
  float* Y = smf(y_off);
  const int lane = threadIdx.x & 31;
  const int K = ly.k, M = ly.m, ldw = round_up(M, 64) / 2;
  const unsigned* W = reinterpret_cast<const unsigned*>(smf(0));
  const float* bias = smf(p.fn_off_b);
  const int next_cols = (M + 15) / 16 * 16;
#pragma unroll 1
  for (int cc = part; 64 * cc < M; cc += 4) {
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    const unsigned* wp = W + 32 * cc + lane;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4* ap = reinterpret_cast<const float4*>(X + 16 * k);
      const float4 a0 = ap[0], a1 = ap[1], a2 = ap[2], a3 = ap[3];
      const float av[16] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w,
                            a2.x, a2.y, a2.z, a2.w, a3.x, a3.y, a3.z, a3.w};
      const unsigned wv = wp[(size_t)k * ldw];
      const float w0 = __uint_as_float(wv << 16), w1 = __uint_as_float(wv & 0xffff0000u);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        acc[r][0] = fmaf(av[r], w0, acc[r][0]);
        acc[r][1] = fmaf(av[r], w1, acc[r][1]);
      }
    }
    const int c = 64 * cc + 2 * lane;
    const float b0 = c < M ? bias[c] : 0.f, b1 = c + 1 < M ? bias[c + 1] : 0.f;
    if (last) {
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (r >= n_valid) break;
        bf16* o = a.out + ((size_t)tile * 16 + r) * M + c;
        if (c < M) st_elem(o, leaky(acc[r][0] + b0, alpha));
        if (c + 1 < M) st_elem(o + 1, leaky(acc[r][1] + b1, alpha));
      }
    } else if (c < next_cols) {
      // (row r, columns c, c + 1): k step c / 16, lane 4 (r % 8) + (c % 8) / 2, register
      // 2 ((c % 16) / 8) + r / 8
      unsigned* y = reinterpret_cast<unsigned*>(Y) + (c >> 4) * 128 + 4 * ((c & 7) >> 1) +
                    2 * ((c & 15) >> 3);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float v0 = c < M ? leaky(acc[r][0] + b0, alpha) : 0.f;
        const float v1 = c + 1 < M ? leaky(acc[r][1] + b1, alpha) : 0.f;
        y[16 * (r & 7) + (r >> 3)] = pack_bf16x2(v0, v1);
      }
    }
  }
}

// A later fn layer on the tile: bf16 A fragments from `in` (the last layer's output)
// times the staged fragments, float32 sums (mma.sync, k steps in order), + bias,
// LeakyReLU (slope 1: linear); each warp of the slot takes 8 n tiles at a time.
// Hidden: the next product's A fragments at out_off (columns past M zero); last: the
// output rows.
__device__ __noinline__ void fn_mma(int in_off, int out_off, const TileLayer ly, bool last,
                                    float alpha, const TileArgs& a, const TilePlan& p,
                                    long long tile, int n_valid, int part) {
  const float* in = smf(in_off);
  float* out_a = smf(out_off);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int steps = (ly.k + 15) / 16, ntiles = (ly.m + 7) / 8, M = ly.m;
  const float* w = smf(0) + lane * 2;
  const float* bias = smf(p.fn_off_b);
#pragma unroll 1
  for (int cc = part; 8 * cc < ntiles; cc += 4) {
    float acc[8][4];
    tile_products_act<true>(acc, in, w, steps, ntiles, cc);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = 8 * cc + q;
      if (j >= ntiles) break;
      float v[4];  // row g at columns c, c + 1, then row g + 8
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int c = 8 * j + 2 * t + d;
        const float bc = c < M ? bias[c] : 0.f;
        v[d] = c < M ? leaky(acc[q][d] + bc, alpha) : 0.f;
        v[2 + d] = c < M ? leaky(acc[q][2 + d] + bc, alpha) : 0.f;
      }
      if (last) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          if (r >= n_valid) continue;
          bf16* o = a.out + ((size_t)tile * 16 + r) * M;
#pragma unroll
          for (int d = 0; d < 2; ++d)
            if (8 * j + 2 * t + d < M) st_elem(o + 8 * j + 2 * t + d, v[2 * h + d]);
        }
      } else {
        // n tile j is half j & 1 of the next product's k step j / 2
        *reinterpret_cast<uint2*>(out_a + (j >> 1) * 128 + 4 * lane + 2 * (j & 1)) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
      }
    }
    if (!last && (ntiles & 1) && 8 * cc + 8 >= ntiles)  // the last k step's second half
      *reinterpret_cast<uint2*>(out_a + (ntiles >> 1) * 128 + 4 * lane + 2) = make_uint2(0u, 0u);
  }
}

// The second phase, after the grid-wide barrier that ends the first: every receiver's
// aggregate is in a.aggs. `tab`: fe's L layers, then fn's Lfn.
__device__ void fn_phase(const TileArgs& a, const TilePlan& p, const TileLayer* tab, int L,
                         int Lfn, bool act_last, int h_out, TileClock& clk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp >> 2, part = warp & 3;
  // fn's layers, lane l holding layer l, read before the shared memory is reused
  const TileLayer mine = lane < Lfn ? tab[L + lane] : TileLayer{};
  if (threadIdx.x == 0)  // the first phase's mbarrier, whose memory the second reuses
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(sm_addr(smf(p.off_bar)))
                 : "memory");
  __syncthreads();  // the first phase is done with the shared memory
  const unsigned bar = sm_addr(smf(p.fn_off_bar));
  if (threadIdx.x == 0) init_barrier(bar);
  const long long total = (long long)a.batch * a.n, tiles = (total + 15) / 16;
  const long long count = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int rounds = (int)((count + p.fn_slots - 1) / p.fn_slots);
  const int x_off = p.fn_off_slots + slot * p.fn_slot_floats, y_off = x_off + p.fn_x_floats;
  unsigned parity = 0;
  for (int round = 0; round < rounds; ++round) {
    const long long i = (long long)round * p.fn_slots + slot;
    const bool active = slot < p.fn_slots && i < count;
    const long long tile = blockIdx.x + i * gridDim.x;
    const int n_valid = active ? (int)min(16LL, total - tile * 16) : 0;
    for (int l = 0; l < Lfn; ++l) {
      const TileLayer ly{__shfl_sync(0xffffffffu, mine.w, l), __shfl_sync(0xffffffffu, mine.b, l),
                         __shfl_sync(0xffffffffu, mine.k, l), __shfl_sync(0xffffffffu, mine.m, l)};
      // every warp is done with the staged layer and the slots' last reads; the
      // generic proxy's accesses, then the copies' writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned wb = (unsigned)(4 * (l == 0 ? (long long)ly.k * round_up(ly.m, 64) / 2
                                                   : bf16_packed_floats(ly.k, ly.m)));
        const unsigned bb = (unsigned)(4 * round_up(ly.m, 4));
        expect_bytes(bar, wb + bb);
        bulk_copy(sm_addr(smf(0)), a.packed + ly.w, wb, bar);
        bulk_copy(sm_addr(smf(p.fn_off_b)), a.packed + ly.b, bb, bar);
      }
      if (l == 0) {
        if (active) fn_rows(smf(x_off), a, tile, h_out, n_valid, 32 * part + lane);
        __syncthreads();  // the slots' rows are in place
      }
      wait_barrier(bar, parity);
      parity ^= 1u;
      tile_stamp(clk, kPhaseTileFnWait);
      const bool last = l + 1 == Lfn;
      const float alpha = !last || act_last ? a.fn_alpha : 1.f;
      if (active) {
        if (l == 0)
          fn_first(x_off, y_off, ly, last, alpha, a, p, tile, n_valid, part);
        else
          fn_mma(l & 1 ? y_off : x_off, l & 1 ? x_off : y_off, ly, last, alpha, a, p, tile,
                 n_valid, part);
      }
      tile_stamp(clk, l == 0 ? kPhaseTileFnFirst : kPhaseTileFnMma);
    }
  }
}

// grid = the plan's CTAs (cooperative, at most one an SM), tile_warps(kW) warps each;
// dynamic shared memory as tile_layout lays it out. kKnn: K5 (a.xs set) or K8, else
// K2; kRes: the weights resident in shared memory.
template <int kW, bool kKnn, bool kRes>
__global__ void __launch_bounds__(tile_warps(kW) * 32, 1)
    bf16_tiles_kernel(const TileArgs a, const Chain fe, const TilePlan p) {
  constexpr int kNT = tile_warps(kW) * 32;  // K5's search runs on all of them
  // the launch's arguments stay as given (a copy that the kernel writes would sit in
  // local memory); the dropout key apart
  const Drop drop = drop_load(a.drop, a.seed, a.drop_on != 0);
  TileClock clk;
  tile_clock_start(clk);
  tile_setup(a.packed, fe, p);
  tile_stamp(clk, kPhaseTileWait);
  const TileLayer* tab = reinterpret_cast<const TileLayer*>(smf(p.off_tab));
  const int L = fe.n, h_out = fe.dim[L], warp = threadIdx.x >> 5;
  float* wr = smf(p.off_work) + warp * p.warp_floats;
  const long long t_lo = range_start(blockIdx.x, p.items, gridDim.x);
  const long long t_hi = range_start(blockIdx.x + 1, p.items, gridDim.x);
  const bool search = kKnn && a.xs != nullptr;
  // the CTA's items, for K5 a chunk of at most sspan_items at a time: the search for
  // the chunk's jets (the receivers each jet has in it), then the warps take its items
  const long long span = search ? p.sspan_items : t_hi - t_lo;
  for (long long c0 = t_lo; c0 < t_hi; c0 += span) {
    const long long c1 = min(t_hi, c0 + span);
    if (search) {
      __syncthreads();  // the last chunk's items are done with the neighbours and the work region
      tile_stamp(clk, kPhaseTileWait);
      for (long long ta = c0; ta < c1;) {
        const int b = (int)(ta / p.blocks);
        const long long tb = min(c1, (long long)(b + 1) * p.blocks);
        const int g0 = (int)(ta - (long long)b * p.blocks) * p.ti;
        const int g_end = min(a.n, (int)(tb - (long long)b * p.blocks) * p.ti);
        const int slot = (int)(ta - c0) * p.ti * a.k;
        if (ta != c0) __syncthreads();  // the last search is done with its scratch
        knn_search_stage_nt<bf16, kNT>(a.xs, a.xf, a.idx_out, a.dists_out, b, g0, g_end - g0,
                                       a.n, a.c, a.k, a.self_loops, a.want_dists, a.key_bits,
                                       p.off_work, p.off_sel + slot, p.off_seld + slot);
        ta = tb;
      }
      __syncthreads();  // the neighbours and their distances are complete
      tile_stamp(clk, kPhaseTileSearch);
    }
    for (long long t = c0 + warp; t < c1; t += p.warps)
      tile_item<kW, kKnn, kRes>(a, drop, p, tab, L, h_out, t,
                                search ? (int)(t - c0) * p.ti * a.k : -1, wr, clk);
  }
}

// K4 in the bf16 mode: the first phase is K2's launch (every receiver's aggregate,
// unrounded, into a.aggs), the second fn on them after a grid-wide barrier
// (fn_phase). Grid, warps and shared memory as bf16_tiles_kernel's.
template <int kW, bool kRes>
__global__ void __launch_bounds__(tile_warps(kW) * 32, 1)
    bf16_tiles_fn_kernel(const TileArgs a, const Chain fe, const Chain fn, const TilePlan p) {
  const Drop drop{};
  TileClock clk;
  tile_clock_start(clk);
  tile_setup(a.packed, fe, p, &fn);
  tile_stamp(clk, kPhaseTileWait);
  const TileLayer* tab = reinterpret_cast<const TileLayer*>(smf(p.off_tab));
  const int L = fe.n, h_out = fe.dim[L], warp = threadIdx.x >> 5;
  float* wr = smf(p.off_work) + warp * p.warp_floats;
  const long long t_hi = range_start(blockIdx.x + 1, p.items, gridDim.x);
  for (long long t = range_start(blockIdx.x, p.items, gridDim.x) + warp; t < t_hi; t += p.warps)
    tile_item<kW, false, kRes, true>(a, drop, p, tab, L, h_out, t, -1, wr, clk);
  tile_stamp(clk, kPhaseTileWait);
  cooperative_groups::this_grid().sync();  // every receiver's aggregate is in a.aggs
  tile_stamp(clk, kPhaseTileFnWait);
  fn_phase(a, p, tab, L, fn.n, fn.act_last != 0, h_out, clk);
}

// Checks the caller's plan (width class, resident, ti, jc, sspan_items, K4's fn_slots,
// grid), lays out the shared memory and launches the kernel of the plan's width class
// (K4: with `fn`).
template <bool kKnn>
int launch_tiles(TileArgs a, const Chain& fe, TilePlan p, int grid, void* stream,
                 const Chain* fn = nullptr) {
  const bool search = kKnn && a.xs != nullptr;
  if ((kKnn && fn != nullptr) || !tile_layout(p, fe, kKnn ? a.k : a.n, a.n, a.c, a.k, search, fn))
    return (int)cudaErrorInvalidValue;
  p.blocks = kKnn ? (a.n + p.ti - 1) / p.ti : 0;
  p.items = kKnn ? (long long)a.batch * p.blocks : ((long long)a.batch * a.n + p.ti - 1) / p.ti;
  if (grid < 1 || grid > p.items) return (int)cudaErrorInvalidValue;
  const void* kernel =
      !p.resident       ? reinterpret_cast<const void*>(bf16_tiles_kernel<256, kKnn, false>)
      : p.width == 64   ? reinterpret_cast<const void*>(bf16_tiles_kernel<64, kKnn, true>)
      : p.width == 128  ? reinterpret_cast<const void*>(bf16_tiles_kernel<128, kKnn, true>)
                        : reinterpret_cast<const void*>(bf16_tiles_kernel<256, kKnn, true>);
  if constexpr (!kKnn) {
    if (fn != nullptr)
      kernel = !p.resident      ? reinterpret_cast<const void*>(bf16_tiles_fn_kernel<256, false>)
               : p.width == 64  ? reinterpret_cast<const void*>(bf16_tiles_fn_kernel<64, true>)
               : p.width == 128 ? reinterpret_cast<const void*>(bf16_tiles_fn_kernel<128, true>)
                                : reinterpret_cast<const void*>(bf16_tiles_fn_kernel<256, true>);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  Chain fe_arg = fe, fn_arg = fn != nullptr ? *fn : Chain{};
  void* args_fn[] = {&a, &fe_arg, &fn_arg, &p};
  void* args_fe[] = {&a, &fe_arg, &p};
  void** args = fn != nullptr ? args_fn : args_fe;
  // cooperative: the CTAs meet at a grid-wide barrier after packing the weights
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(p.warps * 32), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // namespace
