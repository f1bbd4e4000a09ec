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
//           idx[i, s] = sender of the s-th smallest key (k + 1 extractions, the first
//                       dropped, without self loops)
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
// shared memory. The search's scratch (xf^T with the norms, the warps' key rows)
// lives in the pass buffer, which holds no live pass between items; the weight
// slab that the last pass prefetched for the next one lies outside it, so the
// copy may stay in flight while the search runs. K8 reads each row's sender from
// idx (clamped to [0, n), so a wrong idx cannot read outside the jet) and its
// distance from dists.
#pragma once

#include <climits>

#include "edge_fwd_common.cuh"

namespace {

constexpr int kMaxGroup = 32;    // K7: receivers a CTA
constexpr int kSearchRecv = 2;   // receivers a warp takes through the search at once

// Floats of the search's scratch: xf^T with the norms [c + 1, ldn] and the warps'
// key rows [kWarps * kSearchRecv, ldn], ldn = n rounded up to 32.
__host__ __device__ __forceinline__ int search_floats(int n, int c) {
  return (c + 1 + kWarps * kSearchRecv) * round_up(n, 32);
}

// K7: receivers a CTA, the jet's receivers split evenly into groups of at most
// kMaxGroup.
int group_size(int n) {
  const int n_groups = (n + kMaxGroup - 1) / kMaxGroup;
  return (n + n_groups - 1) / n_groups;
}

int knn_key_bits(int n) {
  int bits = 8;
  while ((1 << bits) < n) ++bits;  // max(8, bitlen(n - 1))
  return bits;
}

// The search for receivers g0 .. g0 + g_eff of jet b, its scratch at work_off: the
// jet's senders are staged transposed with their squared norms, then a warp takes
// kSearchRecv receivers at a time: it computes their n keys into its own rows and
// extracts their minima side by side, k times (lane-strided minimum,
// __reduce_min_sync, the winner's key set to INT_MAX), so one receiver's latency
// hides the other's. Keys are unique, so a pass removes exactly one sender, and
// ties inside a truncation bucket break by index, as in the TPU kernels. Fills
// sel [g_eff, k] (and seld with want_dists) and, where the pointers are not null,
// idx_out and dists_out. The caller synchronizes the CTA before it reads sel or
// reuses the scratch.
__device__ void knn_search_stage(const float* __restrict__ xs, const float* __restrict__ xf,
                                 int* __restrict__ idx_out, float* __restrict__ dists_out, int b,
                                 int g0, int g_eff, int n, int c, int k, int self_loops,
                                 int want_dists, int key_bits, int work_off, int sel_off,
                                 int seld_off) {
  constexpr int R = kSearchRecv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldn = round_up(n, 32);
  const float* xfb = xf + (size_t)b * n * c;
  float* xft = smf(work_off);                       // [c + 1, ldn]
  int* keys = smi(work_off + (c + 1) * ldn);        // [kWarps * R, ldn]
  int* sel = smi(sel_off);
  float* seld = smf(seld_off);
  for (int t = threadIdx.x; t < n * c; t += kThreads) {
    const int j = t / c, cc = t - j * c;
    xft[cc * ldn + j] = xfb[t];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float s = __fmul_rn(xft[j], xft[j]);
    for (int cc = 1; cc < c; ++cc) {
      const float v = xft[cc * ldn + j];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    xft[c * ldn + j] = s;
  }
  __syncthreads();
  const int low = (1 << key_bits) - 1;
  const int start = self_loops ? 0 : 1;
  for (int base = warp * R; base < g_eff; base += kWarps * R) {
    const float* xsi[R];
    int* wkeys[R];
    float sq1[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      // a slot past the group recomputes the group's last receiver into its own key
      // row; nothing is extracted from it
      xsi[q] = xs + ((size_t)b * n + g0 + min(base + q, g_eff - 1)) * c;
      wkeys[q] = keys + (warp * R + q) * ldn;
      sq1[q] = __fmul_rn(__ldg(xsi[q]), __ldg(xsi[q]));
    }
    for (int cc = 1; cc < c; ++cc) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float v = __ldg(xsi[q] + cc);
        sq1[q] = __fadd_rn(sq1[q], __fmul_rn(v, v));
      }
    }
    for (int j = lane; j < n; j += 32) {
      float d[R];
#pragma unroll
      for (int q = 0; q < R; ++q) d[q] = __fmul_rn(-2.f * __ldg(xsi[q]), xft[j]);
      for (int cc = 1; cc < c; ++cc) {
        const float x = xft[cc * ldn + j];
#pragma unroll
        for (int q = 0; q < R; ++q) d[q] = __fadd_rn(d[q], __fmul_rn(-2.f * __ldg(xsi[q] + cc), x));
      }
      const float sq2 = xft[c * ldn + j];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        float v = __fadd_rn(__fadd_rn(d[q], sq2), sq1[q]);
        v = v > 0.f ? v : 0.f;
        wkeys[q][j] = (__float_as_int(v) & ~low) | j;
      }
    }
    __syncwarp();
    for (int s = 0; s < k + start; ++s) {
      int m[R];
#pragma unroll
      for (int q = 0; q < R; ++q) m[q] = INT_MAX;
      for (int j = lane; j < n; j += 32) {
#pragma unroll
        for (int q = 0; q < R; ++q) m[q] = min(m[q], wkeys[q][j]);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) m[q] = __reduce_min_sync(0xffffffffu, m[q]);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (base + q >= g_eff) continue;
          wkeys[q][m[q] & low] = INT_MAX;
          if (s >= start) sel[(base + q) * k + s - start] = m[q] & low;
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int ii = base + q;
      if (ii >= g_eff) break;
      for (int s = lane; s < k; s += 32) {
        const int j = sel[ii * k + s];
        const size_t e = ((size_t)b * n + g0 + ii) * k + s;
        if (idx_out != nullptr) idx_out[e] = j;
        if (want_dists) {
          // the exact distance of the selected edge: |xf[j] - xs[i] + 1e-12|
          float sum = 0.f;
          for (int cc = 0; cc < c; ++cc) {
            const float diff = xft[cc * ldn + j] - __ldg(xsi[q] + cc) + 1e-12f;
            sum = fmaf(diff, diff, sum);
          }
          const float dist = sqrtf(sum);
          seld[ii * k + s] = dist;
          if (dists_out != nullptr) dists_out[e] = dist;
        }
      }
    }
  }
}

// What a knn forward launch reads and writes besides the chain.
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
// out. kSearch: K5, else K8.
template <bool kSearch>
__global__ void __launch_bounds__(kThreads, 1)
    knn_fwd_kernel(KnnArgs a, FwdPlan p, Chain fe, float alpha, int drop_on, Drop drop) {
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
        knn_search_stage(a.xs, a.xf, a.idx_out, a.dists_out, b, seg_lo, seg_hi - seg_lo, n, a.c,
                         k, a.self_loops, a.want_dists, a.key_bits, 0, a.off_sel, a.off_seld);
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
        smf(row.m)[r] = real ? __ldg(a.u2m + (size_t)sender * hs + h1) : 0.f;
        smf(row.dist)[r] = dist;
      }
      const bool first = s0 == 0, last = s0 + p.jc >= k;
      // the last product starts fe's first slab of this CTA's next pass
      const int nxt = !last || t + 1 < t_end ? 0 : -1;
      fwd_pass<false>(p, tab, L, h1, h_out, row, in, e, chain, ti_eff, kc_eff, 0, first, last,
                      nxt, denom, a.out + (size_t)(b * n + i0) * h_out, clock);
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
// or K8. With `dropout`, K1 runs with seed in [0, 2^31), keep threshold `thr` and
// multiplier `mult` as computed on the host (see Drop).
template <bool kSearch>
int launch_knn_fwd(KnnArgs a, const Chain& fe, float alpha, int dropout, int seed, unsigned thr,
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
  Drop drop{};
  if (dropout) {
    drop.seed_key = (unsigned)seed * 0xC2B2AE3Du;
    drop.thr = thr;
    drop.mult = mult;
  }
  a.key_bits = knn_key_bits(a.n);
  const void* kernel = reinterpret_cast<const void*>(knn_fwd_kernel<kSearch>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  int drop_on = dropout != 0;
  void* args[] = {&a, &p, const_cast<Chain*>(&fe), &alpha, &drop_on, &drop};
  // cooperative: the CTAs meet at a grid-wide barrier after packing the weights
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, p.smem,
                                    static_cast<cudaStream_t>(stream));
  return (int)err;
}

}  // namespace
