// The recompute-and-backprop core shared by the backward kernels
// (edge_aggregate_bwd.cu: K3; knn_edge_bwd.cu: K6), for Hopper (sm_90a), FP32 on
// CUDA cores (the bf16 modes: see the hooks below).
//
// Both kernels walk "pair rows": (receiver, sender) pairs for K3, (receiver,
// neighbour rank) edges for K6. A pass takes up to 128 rows through the edge
// chain and back. The kernel describes a pass's rows in small per-row arrays in
// shared memory (where the row's u1, u2 and g rows start, its mask / denom, its
// dropout id, its distance); the core does the rest and leaves dz_0, the
// gradient of the decomposed first layer's pre-activation, in shared memory for
// the kernel's own reductions and scatters.
//
// The pass. Activations are stored transposed ([width x ldr], ldr = rows + 4) so
// that a thread reads 8 rows of one feature as two 128-bit loads. Only what a
// later product reads is kept:
//   - a_0 = dropout(leaky(u1[i] + u2[j] (+ dist * w_d))) is built, used by the
//     first hidden layer and dropped; it is rebuilt (it is cheap) into the
//     buffer that dz_L has left when the backward reaches layer 1;
//   - a_1 .. a_{L-1} are kept; the last layer's activation a_L is never stored:
//     its product's epilogue forms dz_L = g[i] * mask[j] / denom * f'(a_L)
//     directly, and the row's sum_h g[i, h] * a_L[h] (dmask) on the way;
//   - going back, dW_l = a_{l-1}^T dz_l reads a_{l-1} first; then the product
//     da_{l-1} = dz_l W_l^T writes dz_{l-1} = da_{l-1} * f'(a_{l-1}) over a_{l-1}
//     in its epilogue (each thread reads exactly the elements it replaces).
//   At the published widths (96 -> 160 -> 192) the live set peaks at a_1 + dz_2 =
//   352 floats a row: a 128-row pass in 186 KB, where keeping every activation
//   and two gradient buffers (800 floats a row) allowed 64 rows.
//   - the derivative is read off the stored activation, so alpha must be > 0: a
//     kept element has the sign of its pre-activation; a dropped one is stored as
//     -0.0f (a zero to every product, told apart by its bits), so K1's hash is
//     computed once per activation and never in the backward sweep.
//
// The products, a_0, the packed weights, the persistent grid's schedule and the
// phase clocks are edge_products.cuh's, shared with the forward (K2, K4). The
// bf16 mode (edge_bwd_bf16.cuh) reaches the core through four hooks: its packer,
// its recompute products (edge_products_bf16.cuh) and its two backward products,
// da and dW, on the tensor cores as split-TF32 (edge_bwd_tf32x3.cuh).
//
// The contractions (dW) keep the warp-tile form: a warp owns a 32 x 32 tile of
// dW (15 tiles for 96 x 160, 30 for 160 x 192, on 16 warps), walks the pass's
// rows with 128-bit loads of both operands and sends the tile to the CTA's
// partial slab in device memory as two bulk copies out of shared memory (the
// first pass stores, later passes add at the L2; a tile always comes from the
// same warp, which waits for its last pass's copies, so the sum is in pass
// order).
//
// The grid is persistent (edge_products.cuh: range_start): its items are
// receiver blocks of jets, and the partial slabs (one a CTA for the weights; one
// per (jet, CTA that touches it) for the senders) are reduced in a fixed order
// by the small kernels at the end of this file, so every sum has the same order
// on every run.
#pragma once

#include <type_traits>

#include "edge_products.cuh"

namespace {

// The bf16 stage's recompute products (edge_products_bf16.cuh, included by the
// bf16 kernel only).
template <typename T>
__device__ int product_recompute(int A, int K, const float* W, int M, int slab,
                                 const PassShape& p, const Epilogue& e);

// The bf16 mode's packer (edge_bwd_bf16.cuh): the recompute's weights in the bf16
// fragment order, W^T for da in the split-TF32 stage's fragment order, the
// biases as float32, to which it points fe.b.
template <typename T>
int launch_pack_bf16(Chain& fe, float* packed, long long packed_floats, Packed& pk,
                     cudaStream_t stream);

// The bf16 mode's backward products (edge_bwd_tf32x3.cuh): da_{l-1} = dz_l W_l^T
// with the kEpiBack epilogue, and dW_l = a_{l-1}^T dz_l as weight_grad takes it.
template <typename T>
__device__ void product_da_bf16(int A, int M, const float* W, int K, int slab,
                                const PassShape& p, const Epilogue& e);
template <typename T>
__device__ void weight_grad_bf16(int a_off, int d_off, int lda, int rows, int K, int M,
                                 float* tiles, float* db, int slab_off, bool first);

constexpr int kRowArrays = 10;     // per-row arrays of a pass (RowArrays)

// What the launcher decides about a launch. The pass shape, the grid and the
// slot count come from the caller (the wrappers plan them, so that the planning
// is tested where there is no card); the launcher lays out the shared memory.
struct BwdPlan : PassShape {
  int ti, jc;       // receivers x senders (knn: neighbour ranks) of a pass
  int blocks;       // receiver blocks (items) per jet
  int slots;        // sender slabs per jet
  long long items;  // batch * blocks
  int off_act[kMaxLayers];  // a_l (l < L), floats from the start of shared memory
  int off_x;        // dz_L, and a_0 when L >= 2
  int off_slab, off_part, off_rows;
  int sender_stride;  // floats a sender's row takes in the sender slabs
  int off_stage;      // knn: [rows x sender_stride] staging for the scatter, or -1
  size_t smem;
};

struct PassBuffers {
  int act[kMaxLayers];
  int x;
  int slab;
  int part;  // [col warps x ldr] partial row sums of the last layer's epilogue
  RowArrays row;
};

__device__ __forceinline__ PassBuffers carve(const BwdPlan& p, int n_layers) {
  PassBuffers s;
  for (int l = 0; l < max(n_layers, 1); ++l) s.act[l] = p.off_act[l];
  s.x = p.off_x;
  s.slab = p.off_slab;
  s.part = p.off_part;
  const int r = p.off_rows;
  s.row.u1 = r;
  s.row.u2 = r + p.ldr;
  s.row.g = r + 2 * p.ldr;
  s.row.id = r + 3 * p.ldr;
  s.row.m = r + 4 * p.ldr;
  s.row.dist = r + 5 * p.ldr;
  s.row.dsm = r + 6 * p.ldr;
  s.row.sender = r + 7 * p.ldr;
  s.row.own = r + 8 * p.ldr;
  s.row.first = r + 9 * p.ldr;
  return s;
}

// Fills the layout of `p` from its pass shape; false where the shape is not one
// the core runs or the shared memory does not fit.
bool layout_plan(BwdPlan& p, const Chain& fe) {
  if (p.rows != 32 && p.rows != 64 && p.rows != 128) return false;
  if (p.ti < 1 || p.jc < 1 || p.ti * p.jc > p.rows) return false;
  p.ldr = p.rows + 4;
  p.row_warps = p.rows / 32;
  p.col_threads = 8 * (kWarps / p.row_warps);
  p.slab_floats = kSlabFloats;
  const int L = fe.n;
  int width = 0;
  if (L >= 2) {
    p.off_x = 0;
    p.off_act[0] = 0;
    width = fe.dim[0] > fe.dim[L] ? fe.dim[0] : fe.dim[L];
    for (int l = 1; l < L; ++l) {
      p.off_act[l] = width * p.ldr;
      width += fe.dim[l];
    }
  } else {
    p.off_act[0] = 0;
    p.off_x = fe.dim[0] * p.ldr;
    width = fe.dim[0] + (L == 1 ? fe.dim[1] : 0);
  }
  p.off_slab = width * p.ldr;
  p.off_part = p.off_slab + 2 * kSlabFloats;
  p.off_rows = p.off_part + (kWarps / p.row_warps) * p.ldr;
  p.smem = (size_t)(p.off_rows + kRowArrays * p.ldr) * sizeof(float);
  return p.smem <= (size_t)kMaxSmemBytes;
}

// dst = v on a CTA's first visit, dst += v after. Each such address is owned by
// one thread on every visit, so the adds land in visit order and the sum is the
// same, bit for bit, as a read-modify-write; atomicAdd with its result unused is
// a fire-and-forget reduction, so the thread does not wait for the old value.
__device__ __forceinline__ void accumulate_to(float* dst, float v, bool first) {
  if (first)
    *dst = v;
  else
    atomicAdd(dst, v);
}

// The backward's products: W is the packed copy (pack_weights).
__device__ void product(int A, int K, const float* W, int M, int slab, const PassShape& p,
                        const Epilogue& e) {
  product_at<false>(A, K, W, M, slab, p, e, SlabChain{});
}

// Where a CTA's weight-gradient partials live in its slab, and where the sums go
// in the flat gradient buffer ([dW_0, db_0, dW_1, db_1, ..., extra]). dW_l is
// kept tile-major: a warp's 32 (k) x 32 (m) tile is two blocks of 512 floats,
// each lane's 16 values of a block together: the layout of the staging buffer
// that weight_grad copies out in bulk.
constexpr int kTileK = 32, kTileM = 32, kTileFloats = kTileK * kTileM;
constexpr int kTileParts = 2, kPartFloats = kTileFloats / kTileParts;  // 2 KB blocks

struct WSlab {
  int n;
  int K[kMaxLayers], M[kMaxLayers];
  int tiles[kMaxLayers];  // slab offset of layer l's tiles
  int db[kMaxLayers];     // slab offset of db_l
  int flat[kMaxLayers];   // flat offset of dW_l (db_l follows it)
  int extra, extra_flat, n_extra;  // knn: dw_d
  int slab_floats, flat_floats;
};

WSlab make_wslab(const Chain& fe, int n_extra) {
  WSlab ws{};
  ws.n = fe.n;
  int slab = 0, flat = 0;
  for (int l = 0; l < fe.n; ++l) {
    const int K = fe.dim[l], M = fe.dim[l + 1];
    ws.K[l] = K;
    ws.M[l] = M;
    ws.tiles[l] = slab;
    slab += ((K + kTileK - 1) / kTileK) * ((M + kTileM - 1) / kTileM) * kTileFloats;
    ws.db[l] = slab;
    slab += (M + 3) / 4 * 4;
    ws.flat[l] = flat;
    flat += K * M + M;
  }
  ws.extra = slab;
  ws.extra_flat = flat;
  ws.n_extra = n_extra;
  ws.slab_floats = slab + (n_extra + 3) / 4 * 4;
  ws.flat_floats = flat + n_extra;
  return ws;
}

// Hopper's bulk asynchronous copies between shared and device memory, here from a
// staging buffer in shared memory into the CTA's partial tiles: a plain store
// on the first pass, an element-wise float add (done at the L2) after. The copy
// engine moves the bytes; the issuing thread goes on and later waits for its
// group. `bytes` is a multiple of 16, both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_to_global(float* dst, const float* staged, int bytes,
                                               bool add) {
  const unsigned src = (unsigned)__cvta_generic_to_shared(staged);
  const size_t out = __cvta_generic_to_global(dst);
  if (add)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
                 ::"l"(out), "r"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(out), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// The thread's bulk copies have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// The thread's bulk copies are complete.
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// Orders the thread's ordinary writes to shared memory before bulk copies read them.
__device__ __forceinline__ void fence_for_bulk() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// db[M] (+)= the column sums of D [M x lda] over `rows` rows, in row order.
__device__ __forceinline__ void bias_grad(const float* D, int lda, int rows, int M,
                                          float* __restrict__ db, bool first) {
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const float4* col = reinterpret_cast<const float4*>(D + (size_t)m * lda);
    float s = 0.f;
    for (int r = 0; r < rows / 4; ++r) {
      const float4 v = col[r];
      s += v.x, s += v.y, s += v.z, s += v.w;
    }
    accumulate_to(db + m, s, first);
  }
}

// dW[K x M] (+)= A^T D over `rows` rows, A [K x lda] and D [M x lda] stored
// transposed in shared memory; `first` overwrites the CTA's partial instead of
// adding to it. A warp owns a 32 (k) x 32 (m) tile; lane l takes rows k = k0 +
// (l >> 3) + 4i (i < 8) and columns m = m0 + (l & 7) + 8j (j < 4): the 8 lanes of a
// quarter warp read 8 neighbouring rows of D (lda = 4 mod 32 puts them in
// distinct banks) and one row of A (a broadcast). It walks the pair rows 4 at a
// time with 128-bit loads (wider tiles, 32 x 48 and 32 x 64 with 64-bit loads,
// were slower: PERF.md). The tile's sums go to the CTA's partial through the
// warp's 2 KB of the (idle) weight slab buffers, half a tile at a time, as one
// bulk reduction each: 46,080 atomicAdds a pass cost as much as the
// contraction's arithmetic, the L2 adds a 2 KB block in one request. Within a
// pass the warp only waits until a block has left the buffer; it waits for its
// blocks to be complete before the next pass adds to the same tiles, so the sums
// to one tile are in pass order.
__device__ __noinline__ void weight_grad(int a_off, int d_off_, int lda, int rows, int K, int M,
                                         float* __restrict__ tiles, float* __restrict__ db,
                                         int slab_off, bool first) {
  const float* A = smf(a_off);
  const float* D = smf(d_off_);
  float* stage = smf(slab_off) + (threadIdx.x >> 5) * kPartFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nkb = (K + kTileK - 1) / kTileK, nmb = (M + kTileM - 1) / kTileM;
  // the last pass's blocks are complete, so this pass's blocks to the same tiles
  // follow them (a wait that finds them long done)
  if (lane == 0) bulk_wait_done();
  for (int wb = warp; wb < nkb * nmb; wb += kWarps) {
    const int k0 = (wb / nmb) * kTileK + (lane >> 3);
    const int m0 = (wb % nmb) * kTileM + (lane & 7);
    int a_off[8], d_off[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a_off[i] = min(k0 + 4 * i, K - 1) * lda;
#pragma unroll
    for (int j = 0; j < 4; ++j) d_off[j] = min(m0 + 8 * j, M - 1) * lda;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int r = 0; r < rows; r += 4) {
      float4 a[8], d[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(A + a_off[i] + r);
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = *reinterpret_cast<const float4*>(D + d_off[j] + r);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, d[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, d[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, d[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, d[j].w, acc[i][j]);
        }
    }
    // values beyond K or M land in the tile's padding, which nobody reads
#pragma unroll
    for (int part = 0; part < kTileParts; ++part) {
      // the block before this one has left the buffer
      if (lane == 0) bulk_wait_read();
      __syncwarp();
      float4* out = reinterpret_cast<float4*>(stage + lane * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = part * 4 + q;
        out[q] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      fence_for_bulk();
      __syncwarp();
      if (lane == 0)
        bulk_to_global(tiles + ((size_t)wb * kTileParts + part) * kPartFloats, stage,
                       kPartFloats * (int)sizeof(float), !first);
    }
  }
  // the slab buffers go back to the products
  if (lane == 0) bulk_wait_read();
  bias_grad(D, lda, rows, M, db, first);
}

// ---------------------------------------------------------------------------
// The pass
// ---------------------------------------------------------------------------

// One pass through the chain and back. The row arrays are filled (no barrier
// needed before the call). Returns the offset of dz_0 [dim[0] x ldr], complete
// and visible to every thread, with row.dsm filled. T: the element type of u1,
// u2 and g; bf16 (the bf16 mode) runs the recompute's products on the bf16 stage
// (pk.fwd its packed bf16 copy, fe.b float32 biases) and the backward's as
// split-TF32 on the tensor cores (pk.bwd W^T in that stage's fragment order).
template <typename T = float>
__device__ int bwd_pass(const PassBuffers& s, const BwdPlan& p, const Chain& fe,
                           const Packed& pk, const PassInputs& in, PhaseClock& clock) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int L = fe.n, h1 = fe.dim[0];
  Epilogue e;
  e.alpha = in.alpha;
  e.drop_on = in.drop_on;
  e.drop = in.drop;
  e.g = in.g;
  e.part = s.part;
  e.row = s.row;
  __syncthreads();  // the row arrays are visible; the previous pass is done with the buffers
  build_a0<T>(s.act[0], p, s.row, in, h1);
  MPGAN_PHASE(clock, kPhaseRows);
  if (L == 0) {
    // no hidden layer: dz_0 and dmask straight from a_0, a warp per row
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < p.rows; r += kWarps) {
      const float gm = smf(s.row.m)[r];
      const T* gi = rows_as<T>(in.g) + max(smi(s.row.g)[r], 0);
      float* a0 = smf(s.act[0]);
      float acc = 0.f;
      for (int h = lane; h < h1; h += 32) {
        const float a = a0[h * p.ldr + r];
        const float gv = ld_elem(gi + h);
        acc = fmaf(gv, a, acc);
        a0[h * p.ldr + r] = gv * gm * dact(a, in.alpha, in.drop_on, in.drop.mult);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) smf(s.row.dsm)[r] = acc / in.denom;
    }
    __syncthreads();
    MPGAN_PHASE(clock, kPhaseLast);
    return s.act[0];
  }
  for (int l = 1; l < L; ++l) {
    e.kind = kEpiHidden;
    e.C = s.act[l];
    e.bias = fe.b[l - 1];
    e.salt = (unsigned)l;
    if constexpr (kBf16)
      product_recompute<T>(s.act[l - 1], fe.dim[l - 1], pk.fwd[l - 1], fe.dim[l], s.slab, p, e);
    else
      product(s.act[l - 1], fe.dim[l - 1], pk.fwd[l - 1], fe.dim[l], s.slab, p, e);
  }
  MPGAN_PHASE(clock, kPhaseFwd);
  e.kind = kEpiLast;
  e.C = s.x;
  e.bias = fe.b[L - 1];
  e.salt = (unsigned)L;
  if constexpr (kBf16)
    product_recompute<T>(s.act[L - 1], fe.dim[L - 1], pk.fwd[L - 1], fe.dim[L], s.slab, p, e);
  else
    product(s.act[L - 1], fe.dim[L - 1], pk.fwd[L - 1], fe.dim[L], s.slab, p, e);
  __syncthreads();
  // the partial row sums, one per warp column group of the last product (the count
  // stays in the loop's condition: hoisted, it changes the FP32 kernel's spills)
  for (int r = threadIdx.x; r < p.rows; r += kThreads) {
    float acc = 0.f;
    for (int q = 0; q < (kBf16 ? kWarps / (p.rows / 16) : kWarps / p.row_warps); ++q)
      acc += smf(s.part)[q * p.ldr + r];
    smf(s.row.dsm)[r] = acc / in.denom;
  }
  MPGAN_PHASE(clock, kPhaseLast);
  int dz = s.x;
  for (int l = L; l >= 1; --l) {
    const int K = fe.dim[l - 1], M = fe.dim[l];
    if (l == 1 && L >= 2) {
      // dz_L's buffer is free: a_0 again, for dW_1 and the derivative
      __syncthreads();
      build_a0<T>(s.act[0], p, s.row, in, h1);
      MPGAN_PHASE(clock, kPhaseRebuild);
    }
    if (in.need_wgrads) {
      __syncthreads();
      if constexpr (kBf16)
        weight_grad_bf16<T>(s.act[l - 1], dz, p.ldr, p.rows, K, M, in.wp + in.ws->tiles[l - 1],
                            in.wp + in.ws->db[l - 1], s.slab, in.first);
      else
        weight_grad(s.act[l - 1], dz, p.ldr, p.rows, K, M, in.wp + in.ws->tiles[l - 1],
                    in.wp + in.ws->db[l - 1], s.slab, in.first);
      MPGAN_PHASE(clock, kPhaseWgrad);
    }
    e.kind = kEpiBack;
    e.C = s.act[l - 1];
    if constexpr (kBf16)
      product_da_bf16<T>(dz, M, pk.bwd[l - 1], K, s.slab, p, e);
    else
      product(dz, M, pk.bwd[l - 1], K, s.slab, p, e);
    dz = s.act[l - 1];
    MPGAN_PHASE(clock, kPhaseDa);
  }
  __syncthreads();
  return dz;
}

// Before a kernel ends: the thread's bulk copies have landed.
__device__ __forceinline__ void finish_bulk() { bulk_wait_done(); }

// ---------------------------------------------------------------------------
// The fixed-order reductions of the partial slabs
// ---------------------------------------------------------------------------

// The sender slabs: part [batch, slots, n, stride] (column h1: dmask; columns
// beyond it padding) summed over
// the slots that the schedule gave jet b (the CTAs from the owner of its first
// item to the owner of its last), in slot order, into du2 [batch, n, h1] and
// dmask [batch, n], as T (bf16 in the bf16 mode: rounded once, from the float32 sums).
template <typename T>
__global__ void reduce_sender_slabs(const float* __restrict__ part, T* __restrict__ du2,
                                    T* __restrict__ dmask, int batch, int n, int h1,
                                    int stride, int slots, int blocks, long long items,
                                    int grid) {
  const long long inner = (long long)n * stride, total = batch * inner;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / inner, k = t - b * inner;
    const int used = item_owner((b + 1) * blocks - 1, items, grid) -
                     item_owner(b * blocks, items, grid) + 1;
    const float* src = part + b * slots * inner + k;
    float s = 0.f;
    for (int q = 0; q < used; ++q) s += src[q * inner];
    const long long row = k / stride;
    const int c = (int)(k - row * stride);
    if (c < h1)
      st_elem(du2 + (b * n + row) * h1 + c, s);
    else if (c == h1)
      st_elem(dmask + b * n + row, s);
  }
}

int blocks_for(long long total, int threads) {
  const long long blocks = (total + threads - 1) / threads;
  return (int)(blocks < 4096 ? blocks : 4096);
}

// The weight gradients: flat[w] = sum over the CTAs' slabs, in CTA order, of the
// element that holds w (tile-major for dW_l, plain for db_l and the extra).
__global__ void reduce_wgrads(const float* __restrict__ w_part, float* __restrict__ flat, int grid,
                              WSlab ws) {
  for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < ws.flat_floats;
       w += gridDim.x * blockDim.x) {
    int at = ws.extra + (w - ws.extra_flat);
    for (int l = 0; l < ws.n; ++l) {
      const int e = w - ws.flat[l], K = ws.K[l], M = ws.M[l];
      if (e < 0 || e >= K * M + M) continue;
      if (e >= K * M) {
        at = ws.db[l] + e - K * M;
      } else {
        const int k = e / M, m = e - k * M;
        const int nmb = (M + kTileM - 1) / kTileM;
        const int tile = (k / kTileK) * nmb + m / kTileM;
        const int kk = k % kTileK, mm = m % kTileM;
        const int lane = (kk % 4) * 8 + mm % 8;
        // blocks of 512 by row group i / 4: lane's 16 values, (i % 4, j)
        const int i = kk / 4, j = mm / 8;
        at = ws.tiles[l] + (tile * kTileParts + i / 4) * kPartFloats + lane * 16 + (i % 4) * 4 + j;
      }
      break;
    }
    float s = 0.f;
    for (int q = 0; q < grid; ++q) s += w_part[(size_t)q * ws.slab_floats + at];
    flat[w] = s;
  }
}

// Both reductions after a backward kernel; `wgrads` [ws.flat_floats] may be null.
template <typename T>
int launch_reductions(const float* sender_part, T* du2, T* dmask, int batch, int n,
                      int h1, const BwdPlan& p, int grid, const float* w_part, float* wgrads,
                      const WSlab& ws, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)batch * n * p.sender_stride;
  reduce_sender_slabs<<<blocks_for(total, threads), threads, 0, stream>>>(
      sender_part, du2, dmask, batch, n, h1, p.sender_stride, p.slots, p.blocks, p.items, grid);
  int code = (int)cudaGetLastError();
  if (code != 0 || wgrads == nullptr || ws.flat_floats == 0) return code;
  reduce_wgrads<<<blocks_for(ws.flat_floats, threads), threads, 0, stream>>>(w_part, wgrads, grid,
                                                                             ws);
  return (int)cudaGetLastError();
}

// Checks what the caller planned and fills the rest of the plan.
bool make_plan(BwdPlan& p, const Chain& fe, int batch, int n_recv, int n_send, int ti, int jc,
               int rows, int grid, int slots, bool stage_scatter) {
  p = BwdPlan{};
  p.ti = ti;
  p.jc = jc;
  p.rows = rows;
  if (!layout_plan(p, fe) || ti > n_recv || jc > n_send) return false;
  // the scatter is staged in the buffer that dz_1 leaves behind, where one exists
  // and holds a sender row (padded to 16 bytes) for every pass row
  p.sender_stride = stage_scatter ? round_up(fe.dim[0] + 1, 4) : fe.dim[0] + 1;
  p.off_stage = -1;
  if (stage_scatter && fe.n >= 1 && p.rows * p.sender_stride <= fe.dim[1] * p.ldr)
    p.off_stage = fe.n >= 2 ? p.off_act[1] : p.off_x;
  p.blocks = (n_recv + ti - 1) / ti;
  p.items = (long long)batch * p.blocks;
  p.slots = slots;
  if (grid < 1 || grid > p.items) return false;
  // every jet's CTAs must find a slot
  for (long long b = 0; b < batch; ++b)
    if (item_owner((b + 1) * p.blocks - 1, p.items, grid) -
            item_owner(b * p.blocks, p.items, grid) >= slots)
      return false;
  return true;
}

}  // namespace
