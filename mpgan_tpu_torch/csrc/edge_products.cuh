// The pieces of a pass of pair rows through the fe chain that the forward and
// the backward edge kernels share, for Hopper (sm_90a), FP32 on CUDA cores: the
// forward pass (edge_fwd_common.cuh: K2 and K4 in edge_aggregate.cu, K5 and K8 on
// knn_stages.cuh) and the backward's recompute-and-backprop pass
// (edge_bwd_common.cuh: K3, K6). What bounds them all is the products' k loops,
// 8 x TN FMAs a k-step with operands from shared memory: about 43 of the 67
// TFLOP/s of FP32 the card's data sheet gives (scripts/torch_fma_peak.cu).
//
// A pass takes up to 128 "pair rows" ((receiver, sender) pairs, or (receiver,
// neighbour rank) edges) through the chain. The kernel describes the rows in
// small per-row arrays in shared memory (where a row's u1 and u2 rows start, its
// mask, its dropout id); build_a0 makes a_0 = dropout(leaky(u1[i] + u2[j]
// (+ dist * w_d))) from them. Activations are stored transposed ([width x ldr],
// ldr = rows + 4) so that a thread reads 8 rows of one feature as two 128-bit
// loads.
//
// The products. All 512 threads cover a product's whole [rows x M] output in one
// round: the 16 warps form a (rows / 32) x (512 / rows) grid, a warp holds 4 row
// groups of 8 rows by 8 column threads, and a thread owns 8 rows by TN =
// ceil(M / column threads) columns (5, 6, 5 and 3 at the published widths with
// 128 rows: every thread busy on 160 and 192 columns). Its columns are laid out
// as 128-bit, 64-bit and 32-bit groups so that a k-step costs two loads of the
// activations and at most three of the weights. The weights come through shared
// memory: k-slabs of W are copied with cp.async into two buffers, the next slab
// in flight while the current one is used, one barrier a slab. They are read from
// a copy of the weights packed once a launch in that order: by a launch of its
// own before the backward (pack_weights), by the forward kernel's own CTAs
// before its grid-wide barrier. The forward also starts the copy of the next
// product's first slab during the last slab of the current one, so a pass waits
// for no weights at a product's start.
//
// The grid is persistent: `grid` CTAs (at most one an SM) each walk a contiguous
// range of the launch's items, computed from the indices alone (range_start,
// item_owner), so the assignment and every order of summation are the same on
// every run.
//
// With -DMPGAN_PHASE_CLOCKS the kernels sum clock64() per phase of a pass
// (thread 0 of each CTA) into a device array that a C entry point reads; the
// build without the flag carries none of it.
#pragma once

#include <cuda_pipeline.h>

#include "edge_common.cuh"

namespace {

constexpr int kSlabFloats = 4096;  // floats in each of the two weight k-slab buffers, at least

enum Phase {
  kPhaseRows = 0,   // per-row arrays, a_0
  kPhaseFwd,        // hidden layers but the last
  kPhaseLast,       // last layer (backward: dz_L and dmask; forward: the aggregate) in its epilogue
  kPhaseWgrad,      // backward: dW contractions and the partial adds
  kPhaseDa,         // backward: da products with dz in their epilogue
  kPhaseRebuild,    // backward: a_0 again
  kPhaseTail,       // the kernel's own reductions and scatters (forward: the aggregate's
                    // ordered adds, K4's node MLP and the stores)
  kPhaseProdWait,   // inside the products: waiting for a slab and its barrier
  kPhaseProdLoop,   // inside the products: the k loop
  kPhaseProdEpi,    // inside the products: the epilogue
  kPhaseSearch,     // K5: the neighbour search (knn_stages.cuh); K7: the whole kernel
  kPhaseSearchStage,   // the search's staging of the senders (thread 0, after its barrier)
  kPhaseSearchKeys,    // warp clocks: the keys (and, where they are one loop, the selection)
  kPhaseSearchSelect,  // warp clocks: the selection that follows the keys
  kPhaseSearchOut,     // warp clocks: idx, dists and the neighbour arrays
  // the bf16 forward's warp tiles (edge_fwd_bf16_tiles.cuh), warp clocks (lane 0 of
  // every warp), apart from the CTA clocks above
  kPhaseTileWait,      // the weights' copy, the CTA barriers and a warp without an item
  kPhaseTileRows,      // a tile's rows and a_0 built into the first product's fragments
  kPhaseTileLoop,      // the mma.sync k loops
  kPhaseTileEpi,       // the hidden layers' epilogues into the next product's fragments
  kPhaseTileLast,      // the last layer's epilogue: mask, the 8-row group sums
  kPhaseTileAgg,       // the receivers' ordered adds and the stores
  kPhaseTileSearch,    // K5: the neighbour search
  kPhaseTileFnWait,    // K4: the grid-wide barrier after the aggregates, fn's weight copies
  kPhaseTileFnFirst,   // K4: fn's first layer (its rows, the FP32 FMA chains, the epilogue)
  kPhaseTileFnMma,     // K4: fn's later layers (mma.sync and their epilogues)
  kPhaseCount
};

#ifdef MPGAN_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[kPhaseCount];
struct PhaseClock {
  long long last;
};
__device__ __forceinline__ void phase_start(PhaseClock& c) { c.last = clock64(); }
__device__ __forceinline__ void phase_stamp(PhaseClock& c, int phase) {
  __syncthreads();  // the phase is over for every warp, not only for the one that stamps
  if (threadIdx.x == 0) {
    const long long now = clock64();
    atomicAdd(&g_phase_clocks[phase], (unsigned long long)(now - c.last));
    c.last = now;
  }
}
#define MPGAN_PHASE_START(clock) phase_start(clock)
#define MPGAN_PHASE(clock, phase) phase_stamp(clock, phase)
#define MPGAN_SUBPHASE(phase)                                                        \
  __syncthreads();                                                                   \
  if (threadIdx.x == 0) {                                                            \
    const long long now_ = clock64();                                                \
    atomicAdd(&g_phase_clocks[phase], (unsigned long long)(now_ - sub_last_));       \
    sub_last_ = now_;                                                                \
  }
#define MPGAN_SUBPHASE_START() long long sub_last_ = clock64()
int read_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (err == cudaSuccess && reset) {
    unsigned long long zeros[kPhaseCount] = {};
    err = cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros));
  }
  return (int)err;
}
#else
struct PhaseClock {};
#define MPGAN_PHASE_START(clock)
#define MPGAN_PHASE(clock, phase)
#define MPGAN_SUBPHASE(phase)
#define MPGAN_SUBPHASE_START()
#endif

// The shape of a pass, as the products and build_a0 read it.
struct PassShape {
  int rows;         // pair rows of the pass buffers: 32, 64 or 128
  int ldr;          // their row stride, rows + 4
  int row_warps;    // rows / 32
  int col_threads;  // column threads of a product: 8 * (kWarps / row_warps)
  int slab_floats;  // floats in each of the two weight slab buffers (kSlabFloats or more)
};

// Fills the shape for `rows`; false where the products do not run it.
__host__ __forceinline__ bool set_shape(PassShape& p, int rows) {
  if (rows != 32 && rows != 64 && rows != 128) return false;
  p.rows = rows;
  p.ldr = rows + 4;
  p.row_warps = rows / 32;
  p.col_threads = 8 * (kWarps / p.row_warps);
  p.slab_floats = kSlabFloats;
  return true;
}

// The pass buffers are named by their offset (in floats) from the start of the
// dynamic shared memory, and turned into pointers where they are used: a pointer
// that the compiler can trace to the shared array is read with shared-memory
// loads, one that went through a struct or a call with generic loads, which are
// slower.
__device__ __forceinline__ float* smf(int off) {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4) + off;
}
__device__ __forceinline__ int* smi(int off) { return reinterpret_cast<int*>(smf(off)); }
__device__ __forceinline__ unsigned* smu(int off) {
  return reinterpret_cast<unsigned*>(smf(off));
}

// Per-row arrays of a pass, each [ldr] (offsets; smi / smu / smf).
struct RowArrays {
  int u1;      // int: offset of the receiver's row in u1, -1 on a padded row
  int u2;      // int: offset of the sender's row in u2 (or u2m)
  int g;       // int: offset of the receiver's row in g
  int id;      // unsigned: K1's id of the row
  int m;       // float: mask[sender] / denom, 0 on a padded row
  int dist;    // float: the edge's distance (knn with distances)
  int dsm;     // float, out: sum_h g[i, h] / denom * a_L[h]
  int sender;  // int, knn: the sender, -1 on a padded row
  int own;     // int, knn: which of the scatter's owners takes the row
  int first;   // int, knn: the pass's first row with the same sender, -1 padded
};

// The static schedule: CTA c of `grid` walks items [c * items / grid,
// (c + 1) * items / grid); item t belongs to CTA ((t + 1) * grid - 1) / items.
__host__ __device__ __forceinline__ long long range_start(long long c, long long items,
                                                          long long grid) {
  return c * items / grid;
}

__host__ __device__ __forceinline__ int item_owner(long long t, long long items, long long grid) {
  return (int)(((t + 1) * grid - 1) / items);
}

// ---------------------------------------------------------------------------
// The products
// ---------------------------------------------------------------------------

// A thread's columns are ct, ct + CT, ct + 2 CT, ...: for a fixed j the 8 column
// threads of a quarter warp hold 8 neighbouring columns, so the epilogue's
// 128-bit stores of 8 rows fall into distinct banks (ldr = 4 mod 32) and its
// loads of the bias and of g are coalesced. The weights are packed to match
// (packed_pos): row k holds, for every column thread, its TN values as 128-bit
// groups first, then a 64-bit group, then single values, each group laid over
// all column threads, so that a k-step costs at most three loads of them.
__device__ __forceinline__ int tile_col(int j, int ct, int CT) { return ct + CT * j; }

// Position of (column thread ct, j) in a packed row of TN * CT floats.
__host__ __device__ __forceinline__ int packed_pos(int tn, int j, int ct, int CT) {
  const int n4 = tn / 4, n2 = (tn % 4) / 2;
  if (j < 4 * n4) return (j / 4) * 4 * CT + 4 * ct + (j % 4);
  if (j < 4 * n4 + 2 * n2) return 4 * n4 * CT + 2 * ct + (j - 4 * n4);
  return (4 * n4 + 2 * n2) * CT + ct;
}

// Element t of the packed copy of a matrix with M columns: rows of TN * CT floats
// (TN = ceil(M / CT)), each in packed_pos order. `col` >= M is padding, stored as
// zero. Both packers (pack_weights before the backward, the forward kernel's
// pack_share) place every element here.
struct PackedElem {
  int row, col;
  long long at;  // offset in the packed copy
};
__device__ __forceinline__ PackedElem packed_elem(long long t, int M, int CT) {
  const int tn = (M + CT - 1) / CT, ldw = tn * CT;
  const int row = (int)(t / ldw), q = (int)(t - (long long)row * ldw), j = q / CT;
  return PackedElem{row, q, (long long)row * ldw + packed_pos(tn, j, q - j * CT, CT)};
}

template <int TN>
__device__ __forceinline__ void load_w(const float* __restrict__ wrow, int ct, int CT,
                                       float (&w)[TN]) {
  constexpr int n4 = TN / 4, n2 = (TN % 4) / 2;
#pragma unroll
  for (int q = 0; q < n4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(wrow + q * 4 * CT + 4 * ct);
    w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
  }
  if constexpr (n2 > 0) {
    const float2 v = *reinterpret_cast<const float2*>(wrow + 4 * n4 * CT + 2 * ct);
    w[4 * n4] = v.x, w[4 * n4 + 1] = v.y;
  }
  if constexpr (TN % 2 == 1) w[TN - 1] = wrow[(4 * n4 + 2 * n2) * CT + ct];
}

// Starts the copy of `floats` packed weights (whole rows, a multiple of 4) into
// a slab buffer.
__device__ __forceinline__ void stage_slab(float* __restrict__ dst, const float* __restrict__ src,
                                           int floats) {
  for (int t = threadIdx.x * 4; t < floats; t += kThreads * 4)
    __pipeline_memcpy_async(dst + t, src + t, 16);
  __pipeline_commit();
}

enum EpilogueKind {
  kEpiHidden = 0,  // C = dropout(leaky(acc + bias))
  kEpiLast,        // C = dz_L from the last layer's activation; row sums to `part`
  kEpiBack,        // C = acc * f'(C), in place
  kEpiAgg          // forward: mask * dropout(leaky(acc + bias)) summed per receiver to `part`
};

struct Epilogue {
  int kind;
  int C;              // [M x ldr] (offset)
  const float* bias;  // kEpiHidden, kEpiLast, kEpiAgg
  float alpha;
  bool drop_on;
  Drop drop;
  unsigned salt;
  const float* g;     // kEpiLast: the jet's g rows
  int part;           // kEpiLast, kEpiAgg (offset)
  int rs;             // kEpiAgg: pass rows a receiver takes (>= 8)
  RowArrays row;
};

// The multiplier of the derivative read off a stored activation.
__device__ __forceinline__ float dact(float a, float alpha, bool drop_on, float mult) {
  if (drop_on && __float_as_uint(a) == 0x80000000u) return 0.f;
  return (a < 0.f ? alpha : 1.f) * (drop_on ? mult : 1.f);
}

// Activation after dropout as it is stored: kept -> leaky * mult (never -0.0f),
// dropped -> -0.0f.
__device__ __forceinline__ float drop_store(float v, const Drop& d, unsigned id, unsigned col,
                                            unsigned salt) {
  return dropmul(d, id, col, salt) != 0.f ? fmaf(v, d.mult, 0.f) : -0.f;
}

// The forward's chain of weight slabs from one product to the next: the buffer
// that holds (or is to hold) this product's first slab, whether its copy is in
// flight already, and the next product's first slab to start during this one's
// last (null: none).
struct SlabChain {
  int buf;
  bool staged;
  const float* next;
  int next_floats;
};

// Floats of a product's first slab: whole packed rows of TN * CT floats.
__host__ __device__ __forceinline__ int first_slab_floats(int K, int M, int CT, int slab_floats) {
  const int ldw = (M + CT - 1) / CT * CT;
  const int ks = slab_floats / ldw;
  return (K < ks ? K : ks) * ldw;
}

// One product over the pass: acc = A [rows x K] @ W [K x M], then the epilogue.
// A is transposed in shared memory (A[k * ldr + r]); W is the packed copy of the
// weights in device memory (rows of TN * CT floats). The forward (kFwd) follows
// `chain` and returns the buffer of the slab after its last, and waits for every
// thread's k loop before its epilogue, so that C may be A itself. Starts with a
// barrier (the previous phase's writes are visible, its reads of the slab
// buffers done) and ends without one.
template <int TN, bool kDrop, bool kFwd>
__device__ __noinline__ int product_tn(int a_off, int K, const float* __restrict__ W, int M,
                                       int slab_off, const PassShape& p, const Epilogue& e_in,
                                       SlabChain chain) {
  // a copy of its own: through the reference every field would be read again
  // after each store to shared memory, which it might alias
  const Epilogue e = e_in;
  const float* A = smf(a_off);
  float* slab = smf(slab_off);
  float* C = smf(e.C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int CT = p.col_threads, ldr = p.ldr;
  const int r0 = (warp % p.row_warps) * 32 + (lane >> 3) * 8;
  const int wc = warp / p.row_warps;
  const int ct = wc * 8 + (lane & 7);
  const int ldw = TN * CT;
  const int ks = min(K, p.slab_floats / ldw);
  const int n_slab = (K + ks - 1) / ks;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int b0 = kFwd ? chain.buf : 0;

  MPGAN_SUBPHASE_START();
  __syncthreads();
  if (!(kFwd && chain.staged)) stage_slab(slab + b0 * p.slab_floats, W, ks * ldw);
  for (int s = 0; s < n_slab; ++s) {
    const int k0 = s * ks, ks_eff = min(ks, K - k0);
    __pipeline_wait_prior(0);
    __syncthreads();  // slab s has landed for everyone; the other buffer is free
    float* other = slab + ((b0 + s + 1) & 1) * p.slab_floats;
    if (s + 1 < n_slab)
      stage_slab(other, W + (size_t)(k0 + ks) * ldw, min(ks, K - k0 - ks) * ldw);
    else if (kFwd && chain.next != nullptr)
      stage_slab(other, chain.next, chain.next_floats);
    MPGAN_SUBPHASE(kPhaseProdWait);
    const float* wrow = slab + ((b0 + s) & 1) * p.slab_floats;
    const float* ap = A + (size_t)k0 * ldr + r0;
#pragma unroll 4
    for (int kk = 0; kk < ks_eff; ++kk, ap += ldr, wrow += ldw) {
      const float4 a0 = *reinterpret_cast<const float4*>(ap);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[TN];
      load_w<TN>(wrow, ct, CT, w);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    MPGAN_SUBPHASE(kPhaseProdLoop);
  }
  const int after = (b0 + n_slab) & 1;
  if (kFwd) __syncthreads();  // every thread is done with A

  if (!kFwd && e.kind == kEpiBack) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tile_col(j, ct, CT);
      if (c >= M) continue;
      float4* dst = reinterpret_cast<float4*>(C + (size_t)c * ldr + r0);
      const float4 p0 = dst[0], p1 = dst[1];
      const float a[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = acc[i][j] * dact(a[i], e.alpha, kDrop, e.drop.mult);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    MPGAN_SUBPHASE(kPhaseProdEpi);
    return after;
  }

  unsigned ids[8];
  if (kDrop) {
#pragma unroll
    for (int i = 0; i < 8; ++i) ids[i] = smu(e.row.id)[r0 + i];
  }
  if (e.kind == kEpiHidden) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tile_col(j, ct, CT);
      if (c >= M) continue;
      const float bc = __ldg(e.bias + c);
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = leaky(acc[i][j] + bc, e.alpha);
        if (kDrop) v[i] = drop_store(v[i], e.drop, ids[i], (unsigned)c, e.salt);
      }
      float4* dst = reinterpret_cast<float4*>(C + (size_t)c * ldr + r0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    MPGAN_SUBPHASE(kPhaseProdEpi);
    return after;
  }

  if (kFwd) {
    // kEpiAgg. Rows are receiver-major, rs >= 8 rows a receiver, so the thread's
    // 8 rows meet at most two receivers: the head (the receiver of row r0) and
    // the tail. Each column's masked activations are summed over the head's rows
    // and over the tail's, in row order, into part[0][r0 / 8][c] and
    // part[1][r0 / 8][c]; a padded row has mask 0.
    const int head = (r0 / e.rs + 1) * e.rs - r0;  // rows i < head are the head's
    const int groups = p.rows / 8, g8 = r0 / 8;
    float m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = smf(e.row.m)[r0 + i];
    float* part = smf(e.part);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tile_col(j, ct, CT);
      if (c >= M) continue;
      const float bc = __ldg(e.bias + c);
      float sh = 0.f, st = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = leaky(acc[i][j] + bc, e.alpha);
        if (kDrop) a = drop_store(a, e.drop, ids[i], (unsigned)c, e.salt);
        if (i < head)
          sh = fmaf(m[i], a, sh);
        else
          st = fmaf(m[i], a, st);
      }
      part[g8 * M + c] = sh;
      part[(groups + g8) * M + c] = st;
    }
    MPGAN_SUBPHASE(kPhaseProdEpi);
    return after;
  }

  // kEpiLast
  float gm[8], dsum[8];
  int go[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gm[i] = smf(e.row.m)[r0 + i];
    go[i] = max(smi(e.row.g)[r0 + i], 0);
    dsum[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tile_col(j, ct, CT);
    if (c >= M) continue;
    const float bc = __ldg(e.bias + c);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float a = leaky(acc[i][j] + bc, e.alpha);
      if (kDrop) a = drop_store(a, e.drop, ids[i], (unsigned)c, e.salt);
      const float gv = __ldg(e.g + go[i] + c);
      dsum[i] = fmaf(gv, a, dsum[i]);
      v[i] = gv * gm[i] * dact(a, e.alpha, kDrop, e.drop.mult);
    }
    float4* dst = reinterpret_cast<float4*>(C + (size_t)c * ldr + r0);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], o);
  }
  if ((lane & 7) == 0) {
    float4* dst = reinterpret_cast<float4*>(smf(e.part) + wc * ldr + r0);
    dst[0] = make_float4(dsum[0], dsum[1], dsum[2], dsum[3]);
    dst[1] = make_float4(dsum[4], dsum[5], dsum[6], dsum[7]);
  }
  MPGAN_SUBPHASE(kPhaseProdEpi);
  return after;
}

// The product at the thread tile width its M needs (TN = ceil(M / CT) <= 8).
template <bool kFwd>
__device__ int product_at(int A, int K, const float* W, int M, int slab, const PassShape& p,
                          const Epilogue& e, SlabChain chain) {
  const int tn = (M + p.col_threads - 1) / p.col_threads;
#define MPGAN_PRODUCT_CASE(TN)                                                      \
  case TN:                                                                          \
    return e.drop_on ? product_tn<TN, true, kFwd>(A, K, W, M, slab, p, e, chain)    \
                     : product_tn<TN, false, kFwd>(A, K, W, M, slab, p, e, chain);
  switch (tn) {
    MPGAN_PRODUCT_CASE(1)
    MPGAN_PRODUCT_CASE(2)
    MPGAN_PRODUCT_CASE(3)
    MPGAN_PRODUCT_CASE(4)
    MPGAN_PRODUCT_CASE(5)
    MPGAN_PRODUCT_CASE(6)
    MPGAN_PRODUCT_CASE(7)
    MPGAN_PRODUCT_CASE(8)
  }
#undef MPGAN_PRODUCT_CASE
  return 0;
}

// ---------------------------------------------------------------------------
// The packed weights
// ---------------------------------------------------------------------------

// Per hidden layer l (W_l [K x M]): fwd[l] feeds a_l = a_{l-1} W_l (K rows of
// TN(M) * CT floats), bwd[l] feeds da_{l-1} = dz_l W_l^T (M rows of TN(K) * CT).
struct Packed {
  const float* fwd[kMaxLayers];
  const float* bwd[kMaxLayers];
};

struct PackJobs {
  const float* w[kMaxLayers];
  int k[kMaxLayers], m[kMaxLayers];
  long long fwd[kMaxLayers], bwd[kMaxLayers];  // offsets into the packed buffer
  int n, col_threads;
};

__host__ __device__ __forceinline__ int tile_width(int m, int col_threads) {
  return (m + col_threads - 1) / col_threads;
}

// Floats of the packed buffer, and the jobs' offsets.
long long plan_pack(PackJobs& jobs, const Chain& fe, int col_threads) {
  long long off = 0;
  jobs.n = fe.n;
  jobs.col_threads = col_threads;
  for (int l = 0; l < fe.n; ++l) {
    jobs.w[l] = fe.w[l];
    jobs.k[l] = fe.dim[l];
    jobs.m[l] = fe.dim[l + 1];
    jobs.fwd[l] = off;
    off += (long long)jobs.k[l] * tile_width(jobs.m[l], col_threads) * col_threads;
    jobs.bwd[l] = off;
    off += (long long)jobs.m[l] * tile_width(jobs.k[l], col_threads) * col_threads;
  }
  return off;
}

// W and W^T of every layer in packed_elem's order.
__global__ void pack_weights(PackJobs jobs, float* __restrict__ packed) {
  const int CT = jobs.col_threads;
  for (int job = 0; job < 2 * jobs.n; ++job) {
    const int l = job >> 1;
    const bool back = job & 1;
    const int rows = back ? jobs.m[l] : jobs.k[l], cols = back ? jobs.k[l] : jobs.m[l];
    const int ldw = tile_width(cols, CT) * CT;
    float* out = packed + (back ? jobs.bwd[l] : jobs.fwd[l]);
    const float* w = jobs.w[l];
    for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < rows * ldw;
         t += gridDim.x * blockDim.x) {
      const PackedElem e = packed_elem(t, cols, CT);
      float v = 0.f;
      if (e.col < cols)
        v = back ? w[(size_t)e.col * jobs.m[l] + e.row] : w[(size_t)e.row * jobs.m[l] + e.col];
      out[e.at] = v;
    }
  }
}

// Packs the chain's weights into `packed` (plan_pack's size) on `stream`.
int launch_pack(const Chain& fe, int col_threads, float* packed, Packed& pk,
                cudaStream_t stream) {
  PackJobs jobs;
  plan_pack(jobs, fe, col_threads);
  for (int l = 0; l < fe.n; ++l) {
    pk.fwd[l] = packed + jobs.fwd[l];
    pk.bwd[l] = packed + jobs.bwd[l];
  }
  if (fe.n == 0) return 0;
  pack_weights<<<64, 256, 0, stream>>>(jobs, packed);
  return (int)cudaGetLastError();
}

struct WSlab;  // edge_bwd_common.cuh

// ---------------------------------------------------------------------------
// The pass
// ---------------------------------------------------------------------------

// What a pass reads besides its row arrays.
struct PassInputs {
  const float* u1;   // the receiver rows the row arrays' offsets start from
  const float* u2;   // the sender rows (K6: [u2 | mask] rows)
  const float* g;    // the jet's g rows
  const float* w_d;  // knn with distances, else null
  float alpha, denom;
  bool drop_on;
  Drop drop;
  int need_wgrads;
  float* wp;         // the CTA's weight partials (laid out by `ws`)
  const WSlab* ws;
  bool first;        // the CTA's first pass
};

// a_0 [h1 x rows] from the row arrays; a padded row is zero. A warp takes a row at
// a time, its lanes the features, so the loads of u1 and u2 are coalesced. T: the
// element type of u1, u2 and w_d (the bf16 mode adds their float32 values).
template <typename T = float>
__device__ __noinline__ void build_a0(int dst_off, const PassShape& p, const RowArrays& row_in,
                                      const PassInputs& in_ref, int h1) {
  const PassInputs in = in_ref;  // copies: see product_tn
  const RowArrays row = row_in;
  const int rows = p.rows, ldr = p.ldr;
  float* dst = smf(dst_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* __restrict__ u1 = rows_as<T>(in.u1);
  const T* __restrict__ u2 = rows_as<T>(in.u2);
  // eight rows at a time (all of a warp's at 128 rows), their loads issued
  // together: a row's operands may come from device memory, and a warp that took
  // its rows one by one would wait for each in turn
  constexpr int kTogether = 8;
  for (int r0 = warp; r0 < rows; r0 += kWarps * kTogether) {
    int o1[kTogether], o2[kTogether];
    unsigned id[kTogether];
    float dist[kTogether];
#pragma unroll
    for (int q = 0; q < kTogether; ++q) {
      const int r = min(r0 + q * kWarps, rows - 1);
      o1[q] = r0 + q * kWarps < rows ? smi(row.u1)[r] : -2;
      o2[q] = smi(row.u2)[r];
      id[q] = smu(row.id)[r];
      dist[q] = smf(row.dist)[r];
    }
    for (int h = lane; h < h1; h += 32) {
      float z[kTogether];
#pragma unroll
      for (int q = 0; q < kTogether; ++q)
        z[q] = o1[q] >= 0 ? ld_elem(u1 + o1[q] + h) + ld_elem(u2 + o2[q] + h) : 0.f;
      const float wd = in.w_d != nullptr ? ld_elem(rows_as<T>(in.w_d) + h) : 0.f;
#pragma unroll
      for (int q = 0; q < kTogether; ++q) {
        if (o1[q] == -2) continue;  // beyond the pass
        float v = 0.f;
        if (o1[q] >= 0) {
          // rounded as the plain version rounds it, product and sum apart: a
          // pre-activation on the other side of zero takes the other slope
          if (in.w_d != nullptr) z[q] = __fadd_rn(z[q], __fmul_rn(dist[q], wd));
          v = leaky(z[q], in.alpha);
          if (in.drop_on) v = drop_store(v, in.drop, id[q], (unsigned)h, 0u);
        }
        dst[h * ldr + r0 + q * kWarps] = v;
      }
    }
  }
}

}  // namespace
