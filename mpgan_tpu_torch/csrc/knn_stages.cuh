// The knn message-passing edge kernels' shared source, for Hopper (sm_90a), FP32
// on CUDA cores: the neighbour search, which the fused layer (knn_fused.cu, K5)
// and the search alone (knn_search.cu, K7) run, and the knn forward kernel, which
// K5 (with the search) and the aggregate from a given idx (knn_edge_aggregate.cu,
// K8, without it) launch. One source each, so K5 and K7 build the same keys and
// pick the same neighbours, and K5 and K8 run the same chain bit for bit.
//
//   search: d[i, j]   = (-2 xs[i] | 1) . (xf[j] | |xf[j]|^2) + |xs[i]|^2      (full FP32)
//                       summed term by term in column order, every product and sum
//                       rounded on its own (__fmul_rn, __fadd_rn: no contraction into
//                       FMAs), so the keys equal the plain PyTorch version's bit for bit
//           key[i, j] = bits(max(d, 0)) & ~(2^bits - 1) | j,   bits = max(8, bitlen(n - 1))
//           idx[i, s] = sender of the s-th smallest key (the first of k + 1 dropped
//                       without self loops), from a list kept sorted in registers
//           dist[i, s] = |xf[idx[i, s]] - xs[i] + 1e-12|                  (with want_dists)
//   chain:  z1[i, s]  = u1[i] + u2m[idx[i, s], :h1] (+ dist[i, s] * w_d)
//           agg[i]    = sum_s u2m[idx[i, s], h1] * chain(leaky(z1[i, s]))   (/ k for mean)
//
// The forward kernel is the dense forward's pass (edge_fwd_common.cuh: fwd_pass,
// the one K2 and K4 run) fed with knn rows: a pass is ti receivers x kc neighbour
// ranks (6 x 20 = 120 of 128 rows at k = 20), row (ii, s) taking the sender
// sel[i0 + ii, s]. The grid is persistent, a CTA an SM, each walking a contiguous
// range of items, an item a block of ti receivers of one jet (K6's schedule). What
// bounds it is the chain's FP32 FMA issue, 2 k (sum of in * out) FLOP a receiver
// (92 KFLOP an edge at the published widths), against ~1 KB of input a particle.
//
// K5 searches once a (CTA, jet): for the receivers of the jet that its item range
// holds (at most the plan's sspan at a time), into sel and seld [sspan, k] in
// shared memory. The search's scratch (xf^T with the norms, the lists its thread
// groups hand on; the lists themselves live in registers) lives in the pass
// buffer, which holds no live pass between items; the weight slab that the last
// pass prefetched for the next one lies outside it, so the copy may stay in
// flight while the search runs. K8 reads each row's sender from
// idx (clamped to [0, n), so a wrong idx cannot read outside the jet) and its
// distance from dists.
//
// The bf16 mode instantiates the same search for bf16 xs and xf (knn_search.cu's
// bf16 entry: K7; the bf16 forward pass's K5, edge_fwd_bf16_tiles.cuh, on fewer
// threads): it widens them to float32 as it stages and reads them, so the keys,
// idx and the float32 dists are those of their float32 values, as in
// knn_pallas._fused_kernel_v4. The forward kernel below is the FP32 mode's; the
// bf16 mode's K5 and K8 run the bf16 forward pass (knn_fused_bf16.cu).
#pragma once

#include <climits>

#include "edge_fwd_common.cuh"

namespace {

constexpr int kSearchList = 21;     // keys a thread keeps sorted: k = 20 and the dropped self
constexpr int kSearchRegCols = 32;  // receiver columns held in registers; wider rows come from L1

// The row stride of the search's xf^T: n rounded up to 4 (senders are read 4 at
// a time), and to an odd number of 4-float groups, so that the staging's
// transposing stores of a warp fall into 8 banks rather than fewer.
__host__ __device__ __forceinline__ int search_ldn(int n) {
  const int ldn = round_up(n, 4);
  return (ldn / 4) % 2 == 0 ? ldn + 4 : ldn;
}

// Rows of the search's xf^T: c rounded up to 4, 8, 16 or 32, the columns past c
// zeros, so that the key loops have a fixed length (adding the zero products
// leaves every key as it was); c itself past kSearchRegCols.
__host__ __device__ __forceinline__ int search_cols(int c) {
  return c <= 4 ? 4 : c <= 8 ? 8 : c <= 16 ? 16 : c <= kSearchRegCols ? kSearchRegCols : c;
}

// The search's threads (kThreads, or the bf16 forward's warps: `threads`) form
// `parts` groups of `part_threads` (whole warps): a thread of group p takes the
// receiver of its place in the group and the p-th share of the senders, so that
// every lane of a warp reads the same senders. As many groups as fit, at most 4 (1
// where there are more receivers than threads, which then take them in turns).
__host__ __device__ __forceinline__ int search_part_threads(int receivers,
                                                            int threads = kThreads) {
  return receivers >= threads ? threads : round_up(receivers, 32);
}
__host__ __device__ __forceinline__ int search_parts(int receivers, int threads = kThreads) {
  const int p = threads / search_part_threads(receivers, threads);
  return p < 4 ? p : 4;
}

// Ints of the lists that groups 1 .. parts - 1 hand to group 0: (parts - 1) *
// part_threads is at most 3 * 128 for any number of receivers and threads up to
// kThreads.
constexpr int kSearchMergeInts = 3 * 128 * kSearchList;

// Floats of the search's scratch: xf^T and the norms, [search_cols(c) + 1,
// search_ldn(n)], then the lists of the merge.
__host__ __device__ __forceinline__ int search_floats(int n, int c) {
  return (search_cols(c) + 1) * search_ldn(n) + kSearchMergeInts;
}

// K7: receivers a CTA, the jet's receivers split evenly into groups of at most
// one a thread.
int group_size(int n) {
  const int n_groups = (n + kThreads - 1) / kThreads;
  return (n + n_groups - 1) / n_groups;
}

#ifdef MPGAN_PHASE_CLOCKS
#define SEARCH_CLOCK_START() long long sclk_ = clock64()
#define SEARCH_STAGE_STAMP()                                                        \
  if (threadIdx.x == 0)                                                             \
    atomicAdd(&g_phase_clocks[kPhaseSearchStage], (unsigned long long)(clock64() - sclk_))
#define SEARCH_WARP_STAMP(ph)                                                       \
  do {                                                                              \
    const long long now_ = clock64();                                               \
    if ((threadIdx.x & 31) == 0)                                                    \
      atomicAdd(&g_phase_clocks[ph], (unsigned long long)(now_ - sclk_));           \
    sclk_ = now_;                                                                   \
  } while (0)
#else
#define SEARCH_CLOCK_START()
#define SEARCH_STAGE_STAMP()
#define SEARCH_WARP_STAMP(ph)
#endif

int knn_key_bits(int n) {
  int bits = 8;
  while ((1 << bits) < n) ++bits;  // max(8, bitlen(n - 1))
  return bits;
}

// Inserts v into a list of kSearchList keys kept ascending (INT_MAX where
// empty), dropping the largest. Every entry's new value depends on the old ones
// only, so the 2 * kSearchList min/max have no chain between them.
__device__ __forceinline__ void list_insert(int (&list)[kSearchList], int v) {
#pragma unroll
  for (int s = kSearchList - 1; s > 0; --s) list[s] = min(list[s], max(list[s - 1], v));
  list[0] = min(list[0], v);
}

// The keys of one thread's senders (groups of 4 senders part, part + parts, ... of
// the jet's xf^T [cols + 1, ldn]) for one receiver, those above `prev` inserted
// into `list`. kC > 0: the receiver's row, pre-scaled by -2 and zero-padded to
// kC = cols columns, is xr (registers), and the loops have a fixed length;
// kC == 0: any width, the row read from L1. T: the element type of the row
// (bf16 in the bf16 mode, widened to float32 as it is read).
template <int kC, typename T>
__device__ __forceinline__ void search_keys(int (&list)[kSearchList], const float* __restrict__ xft,
                                            const float (&xr)[kC > 0 ? kC : 1],
                                            const T* __restrict__ xsi, float sq1, int n,
                                            int ldn, int cols, int low, int part, int parts,
                                            int prev) {
  const int groups = ldn / 4, q4 = ldn / 4;  // float4s a row of xf^T
  for (int g = part; g < groups; g += parts) {
    const float4* col = reinterpret_cast<const float4*>(xft) + g;
    // the plain version's order: products and sums rounded one by one, column by
    // column, then + |xf[j]|^2, then + |xs[i]|^2; four senders, four chains
    float4 x4 = col[0];
    const float a0 = kC > 0 ? xr[0] : -2.f * ld_elem(xsi);
    float d0 = __fmul_rn(a0, x4.x), d1 = __fmul_rn(a0, x4.y), d2 = __fmul_rn(a0, x4.z),
          d3 = __fmul_rn(a0, x4.w);
    if constexpr (kC > 0) {
#pragma unroll
      for (int cc = 1; cc < kC; ++cc) {
        x4 = col[cc * q4];
        d0 = __fadd_rn(d0, __fmul_rn(xr[cc], x4.x));
        d1 = __fadd_rn(d1, __fmul_rn(xr[cc], x4.y));
        d2 = __fadd_rn(d2, __fmul_rn(xr[cc], x4.z));
        d3 = __fadd_rn(d3, __fmul_rn(xr[cc], x4.w));
      }
    } else {
      for (int cc = 1; cc < cols; ++cc) {
        const float a = -2.f * ld_elem(xsi + cc);
        x4 = col[cc * q4];
        d0 = __fadd_rn(d0, __fmul_rn(a, x4.x));
        d1 = __fadd_rn(d1, __fmul_rn(a, x4.y));
        d2 = __fadd_rn(d2, __fmul_rn(a, x4.z));
        d3 = __fadd_rn(d3, __fmul_rn(a, x4.w));
      }
    }
    const float4 sq2 = col[cols * q4];
    const float dv[4] = {__fadd_rn(__fadd_rn(d0, sq2.x), sq1),
                         __fadd_rn(__fadd_rn(d1, sq2.y), sq1),
                         __fadd_rn(__fadd_rn(d2, sq2.z), sq1),
                         __fadd_rn(__fadd_rn(d3, sq2.w), sq1)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * g + q;
      const float v = dv[q] > 0.f ? dv[q] : 0.f;
      const int key = (__float_as_int(v) & ~low) | j;
      list_insert(list, j < n && key > prev ? key : INT_MAX);
    }
  }
}

// The receivers of a search after the staging (see knn_search_stage), their rows
// as search_keys<kC> reads them; `merge` holds the lists of the merge. T: the
// element type of xs and xf; kNT: the CTA's threads.
template <int kC, typename T, int kNT>
__device__ __forceinline__ void search_receivers(const T* __restrict__ xs,
                                                 const T* __restrict__ xf,
                                                 const float* __restrict__ xft, int* merge,
                                                 int* __restrict__ idx_out,
                                                 float* __restrict__ dists_out, int b, int g0,
                                                 int g_eff, int n, int c, int cols, int ldn, int k,
                                                 int start, int want_dists, int low, int sel_off,
                                                 int seld_off) {
  const int per = search_part_threads(g_eff, kNT), parts = search_parts(g_eff, kNT);
  const int part = threadIdx.x / per, place = threadIdx.x - part * per;
  SEARCH_CLOCK_START();
  for (int rb = 0; rb < g_eff; rb += per) {
    // a warp without a receiver, or past the groups, computes nothing; a thread
    // past the receivers in a warp with one recomputes the last, and writes nothing
    const bool busy = part < parts && rb + (place & ~31) < g_eff;
    const bool live = busy && rb + place < g_eff;
    const int ii = min(rb + place, g_eff - 1);
    const T* xsi = xs + ((size_t)b * n + g0 + ii) * c;
    float xr[kC > 0 ? kC : 1];
    float sq1 = 0.f;
    if (busy) {
      sq1 = __fmul_rn(ld_elem(xsi), ld_elem(xsi));
      if constexpr (kC > 0) {
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) xr[cc] = cc < c ? ld_elem(xsi + cc) : 0.f;
#pragma unroll
        for (int cc = 1; cc < kC; ++cc)
          if (cc < c) sq1 = __fadd_rn(sq1, __fmul_rn(xr[cc], xr[cc]));
#pragma unroll
        for (int cc = 0; cc < kC; ++cc) xr[cc] *= -2.f;  // exact
      } else {
        for (int cc = 1; cc < c; ++cc) {
          const float v = ld_elem(xsi + cc);
          sq1 = __fadd_rn(sq1, __fmul_rn(v, v));
        }
      }
    }
    int prev = -1;  // the last round's largest key; keys are >= 0
    for (int r0 = 0; r0 < k + start; r0 += kSearchList) {
      int list[kSearchList];
#pragma unroll
      for (int s = 0; s < kSearchList; ++s) list[s] = INT_MAX;
      if (busy) search_keys<kC>(list, xft, xr, xsi, sq1, n, ldn, cols, low, part, parts, prev);
      SEARCH_WARP_STAMP(kPhaseSearchKeys);
      if (parts > 1) {
        // groups 1 .. parts - 1 hand their lists to group 0, which merges them (with parts >
        // 1 all receivers fit in one round of the groups, so rb takes one value)
        if (busy && part > 0) {
#pragma unroll
          for (int s = 0; s < kSearchList; ++s)
            merge[((part - 1) * kSearchList + s) * per + place] = list[s];
        }
        __syncthreads();
        if (busy && part == 0) {
          for (int q = 1; q < parts; ++q) {
#pragma unroll
            for (int s = 0; s < kSearchList; ++s)
              list_insert(list, merge[((q - 1) * kSearchList + s) * per + place]);
          }
        }
      }
      if (parts > 1 && k + start > kSearchList) {
        __syncthreads();  // the lists are read; group 0 hands on the round's largest key
        if (part == 0) merge[place] = list[kSearchList - 1];
        __syncthreads();
        if (part < parts) prev = merge[place];
        __syncthreads();  // merge is free for the next round
      } else {
        prev = list[kSearchList - 1];
      }
      SEARCH_WARP_STAMP(kPhaseSearchSelect);
      if (live && part == 0) {
        // the neighbours first, then (the list no longer live) their distances
#pragma unroll
        for (int s = 0; s < kSearchList; ++s) {
          const int q = r0 + s;
          if (q < start || q >= k + start) continue;
          const int j = list[s] & low, rank = q - start;
          if (sel_off >= 0) smi(sel_off)[ii * k + rank] = j;
          if (idx_out != nullptr) idx_out[((size_t)b * n + g0 + ii) * k + rank] = j;
        }
        if (want_dists) {
          for (int q = max(r0, start); q < min(r0 + kSearchList, k + start); ++q) {
            const int rank = q - start;
            const size_t e = ((size_t)b * n + g0 + ii) * k + rank;
            const int j = sel_off >= 0 ? smi(sel_off)[ii * k + rank] : idx_out[e];
            // the exact distance of the selected edge: |xf[j] - xs[i] + 1e-12|; xf's
            // row is read from L1 (one line at c = 32), not from xf^T, where the
            // lanes' senders would meet in few banks
            const T* xfj = xf + ((size_t)b * n + j) * c;
            float sum = 0.f;
            if constexpr (kC > 0) {
#pragma unroll
              for (int cc = 0; cc < kC; ++cc) {
                if (cc < c) {
                  const float diff = ld_elem(xfj + cc) - xr[cc] * -0.5f + 1e-12f;
                  sum = fmaf(diff, diff, sum);
                }
              }
            } else {
              for (int cc = 0; cc < c; ++cc) {
                const float diff = ld_elem(xfj + cc) - ld_elem(xsi + cc) + 1e-12f;
                sum = fmaf(diff, diff, sum);
              }
            }
            const float dist = sqrtf(sum);
            if (seld_off >= 0) smf(seld_off)[ii * k + rank] = dist;
            if (dists_out != nullptr) dists_out[e] = dist;
          }
        }
      }
      SEARCH_WARP_STAMP(kPhaseSearchOut);
    }
  }
}

// The search for receivers g0 .. g0 + g_eff of jet b, its scratch at work_off, run
// by every thread of the CTA: the jet's senders are staged transposed with their
// squared norms (rows past c zeros, search_cols), then each receiver takes a
// thread in each of search_parts(g_eff) groups of whole warps, each thread
// computing the keys of its group's share of the senders (every lane of a warp reads
// the same 4 senders with one 128-bit load) and keeping the kSearchList smallest
// sorted in registers; group 0 merges the others' lists through shared memory.
// Keys are unique, so the ascending list is what k + 1 extractions give, and
// ties inside a truncation bucket break by index, as in the TPU kernels. Where
// k + 1 exceeds kSearchList, further rounds take the smallest keys above the last
// round's largest. Fills sel [g_eff, k] (sel_off >= 0) and seld with want_dists,
// and idx_out and dists_out where they are not null. The caller synchronizes the
// CTA before it reads sel or reuses the scratch. T: the element type of xs and xf
// (bf16 in the bf16 mode: the staging and the receivers' rows widen them to
// float32, so the keys and the distances are those of their float32 values).
// kNT: the CTA's threads (kThreads; the bf16 forward's warp tiles run fewer).
template <typename T, int kNT>
__device__ __forceinline__ void search_stage_body(const T* __restrict__ xs,
                                                  const T* __restrict__ xf,
                                                  int* __restrict__ idx_out,
                                                  float* __restrict__ dists_out, int b, int g0,
                                                  int g_eff, int n, int c, int k,
                                                  int self_loops, int want_dists, int key_bits,
                                                  int work_off, int sel_off, int seld_off) {
  const int ldn = search_ldn(n), cols = search_cols(c);
  const T* xfb = xf + (size_t)b * n * c;
  float* xft = smf(work_off);  // [cols + 1, ldn]
  SEARCH_CLOCK_START();
  for (int t = threadIdx.x; t < ldn * cols; t += kNT) {
    // coalesced reads of xf; the padded senders and columns are zeros
    const int j = t / cols, cc = t - j * cols;
    xft[cc * ldn + j] = j < n && cc < c ? ld_elem(xfb + (size_t)j * c + cc) : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ldn; j += kNT) {
    float s = __fmul_rn(xft[j], xft[j]);
    for (int cc = 1; cc < c; ++cc) {
      const float v = xft[cc * ldn + j];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    xft[cols * ldn + j] = s;
  }
  __syncthreads();
  SEARCH_STAGE_STAMP();
  const int low = (1 << key_bits) - 1, start = self_loops ? 0 : 1;
  int* merge = smi(work_off + (cols + 1) * ldn);
#define MPGAN_SEARCH_RECEIVERS(KC)                                                               \
  search_receivers<KC, T, kNT>(xs, xf, xft, merge, idx_out, dists_out, b, g0, g_eff, n, c, cols, \
                               ldn, k, start, want_dists, low, sel_off, seld_off)
  switch (cols) {
    case 4: MPGAN_SEARCH_RECEIVERS(4); break;
    case 8: MPGAN_SEARCH_RECEIVERS(8); break;
    case 16: MPGAN_SEARCH_RECEIVERS(16); break;
    case kSearchRegCols: MPGAN_SEARCH_RECEIVERS(kSearchRegCols); break;
    default: MPGAN_SEARCH_RECEIVERS(0);
  }
#undef MPGAN_SEARCH_RECEIVERS
}

// The search on kThreads threads (K5 and K7 in both modes).
template <typename T>
__device__ __noinline__ void knn_search_stage(const T* __restrict__ xs,
                                              const T* __restrict__ xf,
                                              int* __restrict__ idx_out,
                                              float* __restrict__ dists_out, int b, int g0,
                                              int g_eff, int n, int c, int k, int self_loops,
                                              int want_dists, int key_bits, int work_off,
                                              int sel_off, int seld_off) {
  search_stage_body<T, kThreads>(xs, xf, idx_out, dists_out, b, g0, g_eff, n, c, k, self_loops,
                                 want_dists, key_bits, work_off, sel_off, seld_off);
}

// The same search on a CTA of kNT threads (the bf16 forward's K5,
// edge_fwd_bf16_tiles.cuh).
template <typename T, int kNT>
__device__ __noinline__ void knn_search_stage_nt(const T* __restrict__ xs,
                                                 const T* __restrict__ xf,
                                                 int* __restrict__ idx_out,
                                                 float* __restrict__ dists_out, int b, int g0,
                                                 int g_eff, int n, int c, int k, int self_loops,
                                                 int want_dists, int key_bits, int work_off,
                                                 int sel_off, int seld_off) {
  search_stage_body<T, kNT>(xs, xf, idx_out, dists_out, b, g0, g_eff, n, c, k, self_loops,
                            want_dists, key_bits, work_off, sel_off, seld_off);
}

// What a knn forward launch reads and writes besides the chain. xs, xf, u1, u2m,
// w_d and out hold the kernel's element type (float32, read through rows_as); idx,
// dists and the outputs idx_out, dists_out are int32 and float32.
struct KnnArgs {
  const float* xs;  // K5: the receivers' and the senders' selection features [B, n, c]
  const float* xf;
  const int* idx;   // K8: the neighbours [B, n, k] and their distances (or null)
  const float* dists;
  const float* u1;   // [B, n, h1]
  const float* u2m;  // [B, n, h1 + 1]: [u2 | mask]
  const float* w_d;  // [h1], read with want_dists
  float* out;        // [B, n, h_out]
  int* idx_out;      // K5: idx and dists for a backward, or null
  float* dists_out;
  float* packed;     // scratch for the packed weights
  int batch, n, c, h1, k, self_loops, want_dists, key_bits, sum_agg;
  int blocks;        // items a jet: ceil(n / ti)
  int sspan;         // K5: receivers a search covers at most
  int off_sel, off_seld;  // K5: sel and seld [sspan, k]
};

// grid = the plan's CTAs, cooperative; dynamic shared memory as knn_fwd_layout lays it
// out. kSearch: K5, else K8. T: the element type (float).
template <bool kSearch, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    knn_fwd_kernel(KnnArgs a, FwdPlan p, Chain fe, float alpha, int drop_on, Drop drop,
                   const int* __restrict__ seed) {
  drop = drop_load(drop, seed, drop_on != 0);
  const int L = fe.n, h1 = a.h1, hs = a.h1 + 1, h_out = fe.dim[L], n = a.n, k = a.k;
  const LayerTab* tab = fwd_setup(a.packed, p, fe, fe, L);
  const float denom = a.sum_agg ? 1.f : (float)k;  // the mean divides by k
  const RowArrays row = fwd_rows(p);
  PassInputs in{};
  in.u1 = a.u1;
  in.u2 = a.u2m;
  in.w_d = a.want_dists ? a.w_d : nullptr;
  in.alpha = alpha;
  in.drop_on = drop_on != 0;
  in.drop = drop;
  Epilogue e = fwd_epilogue(p, row, alpha, drop_on != 0, drop);
  SlabChain chain{};
  PhaseClock clock;
  MPGAN_PHASE_START(clock);
  int seg_b = -1, seg_lo = 0, seg_hi = 0;  // K5: the jet and receivers that sel holds

  const long long t_end = range_start(blockIdx.x + 1, p.items, gridDim.x);
  for (long long t = range_start(blockIdx.x, p.items, gridDim.x); t < t_end; ++t) {
    const int b = (int)(t / a.blocks), i0 = (int)(t - (long long)b * a.blocks) * p.ti;
    const int ti_eff = min(p.ti, n - i0);
    if constexpr (kSearch) {
      if (b != seg_b || i0 >= seg_hi) {
        // the receivers of jet b that this CTA's range holds from i0 on, at most sspan
        const long long t_jet = min(t_end, (long long)(b + 1) * a.blocks);
        seg_b = b;
        seg_lo = i0;
        seg_hi = min(min(n, i0 + a.sspan), (int)(t_jet - (long long)b * a.blocks) * p.ti);
        __syncthreads();  // the last pass's tail is done with the region the search overwrites
        knn_search_stage<T>(rows_as<T>(a.xs), rows_as<T>(a.xf), a.idx_out, a.dists_out, b,
                            seg_lo, seg_hi - seg_lo, n, a.c, k, a.self_loops, a.want_dists,
                            a.key_bits, 0, a.off_sel, a.off_seld);
        __syncthreads();  // sel and seld are complete
        MPGAN_PHASE(clock, kPhaseSearch);
      }
    }
    for (int s0 = 0; s0 < k; s0 += p.jc) {
      const int kc_eff = min(p.jc, k - s0);
      // knn rows: receiver i0 + ii x neighbour rank s0 + ss
      for (int r = threadIdx.x; r < p.rows; r += kThreads) {
        const int ii = r / p.rs, ss = r - ii * p.rs;
        const bool real = ii < ti_eff && ss < kc_eff;
        const int q = b * n + i0 + ii, s = s0 + ss;
        int j = 0;
        float dist = 0.f;
        if (real) {
          if constexpr (kSearch) {
            const int at = (i0 + ii - seg_lo) * k + s;
            j = smi(a.off_sel)[at];
            if (a.want_dists) dist = smf(a.off_seld)[at];
          } else {
            const size_t at = (size_t)q * k + s;
            j = min(max(__ldg(a.idx + at), 0), n - 1);
            if (a.want_dists) dist = __ldg(a.dists + at);
          }
        }
        const int sender = b * n + j;
        smi(row.u1)[r] = real ? q * h1 : -1;
        smi(row.u2)[r] = sender * hs;
        smu(row.id)[r] = (unsigned)q * (unsigned)k + (unsigned)s;
        smf(row.m)[r] = real ? ld_elem(rows_as<T>(a.u2m) + (size_t)sender * hs + h1) : 0.f;
        smf(row.dist)[r] = dist;
      }
      const bool first = s0 == 0, last = s0 + p.jc >= k;
      // the last product starts fe's first slab of this CTA's next pass
      const int nxt = !last || t + 1 < t_end ? 0 : -1;
      T* out_blk = reinterpret_cast<T*>(a.out) + (size_t)(b * n + i0) * h_out;
      fwd_pass<false, T>(p, tab, L, h1, h_out, row, in, e, chain, ti_eff, kc_eff, 0, first,
                         last, nxt, denom, out_blk, clock);
    }
  }
}

// Checks a knn forward plan (ti receivers x kc ranks in buffers of `rows`, slabs of
// slab_floats; K5: searches of at most sspan receivers) and lays out the shared
// memory: the pass with the distance row array, for K5 the search's scratch inside
// [0, off_slab) and sel, seld [sspan, k] after the rest. False where the kernel does
// not run the plan or it does not fit.
bool knn_fwd_layout(FwdPlan& p, KnnArgs& a, const Chain& fe, bool search) {
  p.row_arrays = 5;
  p.span = p.ti;
  if (p.ti < 1 || p.ti > a.n || p.jc < 1 || p.jc > a.k) return false;
  if (search && (a.sspan < p.ti || a.sspan > a.n || (a.sspan != a.n && a.sspan % p.ti != 0)))
    return false;
  const int nk = search ? a.sspan * a.k : 0;
  if (!fwd_layout(p, fe, nullptr, search ? search_floats(a.n, a.c) : 0, 2 * nk)) return false;
  a.off_sel = p.off_extra;
  a.off_seld = p.off_extra + nk;
  a.blocks = (a.n + p.ti - 1) / p.ti;
  p.items = (long long)a.batch * a.blocks;
  return true;
}

// Checks the caller's plan, lays out the shared memory and launches K5 (kSearch)
// or K8. With `dropout`, K1 runs with the seed `seed` points to in device memory (in
// [0, 2^31)), keep threshold `thr` and multiplier `mult` as computed on the host (see
// Drop). T: the element type (see knn_fwd_kernel).
template <bool kSearch, typename T>
int launch_knn_fwd(KnnArgs a, const Chain& fe, float alpha, int dropout, const int* seed,
                   unsigned thr,
                   float mult, int ti, int kc, int rows, int grid, int slab_floats,
                   void* stream) {
  // offsets into u1, u2m and out are ints
  const int widest = a.h1 + 1 > fe.dim[fe.n] ? a.h1 + 1 : fe.dim[fe.n];
  if ((long long)a.batch * a.n * widest >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  FwdPlan p{};
  p.rows = rows;
  p.ti = ti;
  p.jc = kc;
  p.slab_floats = slab_floats;
  if (!knn_fwd_layout(p, a, fe, kSearch) || grid < 1 || grid > p.items)
    return (int)cudaErrorInvalidValue;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  Drop drop{};
  if (dropout) {
    drop.thr = thr;
    drop.mult = mult;
  }
  a.key_bits = knn_key_bits(a.n);
  const void* kernel = reinterpret_cast<const void*>(knn_fwd_kernel<kSearch, T>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int drop_on = dropout != 0;
  void* args[] = {&a, &p, const_cast<Chain*>(&fe), &alpha, &drop_on, &drop, &seed};
  // cooperative: the CTAs meet at a grid-wide barrier after packing the weights
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // namespace
