// The two stages of the knn message-passing edge kernels, shared by the fused
// layer (knn_fused.cu, K5), the search alone (knn_search.cu, K7) and the
// aggregate from a given idx (knn_edge_aggregate.cu, K8): one source for each
// stage, so the three kernels build the same keys, pick the same neighbours and
// run the same chain bit for bit.
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
// A CTA owns a group of up to 32 receivers of one jet. The stages talk through
// the group's neighbours `sel` and distances `seld` [group, k] in shared memory.
#pragma once

#include <climits>

#include "edge_common.cuh"

namespace {

struct KnnPlan {
  int group;  // receivers per CTA
  int ti;     // receivers per pass
  int kc;     // neighbour ranks per pass
  int ldr;    // row stride of the pass buffers (floats)
  int buf0;   // floats in the first ping-pong buffer
  int ldn;    // sender stride of the search arrays
  int work;   // floats in the region the search arrays and the pass buffers share
};

// The dynamic shared memory of a knn kernel: the shared region (search: xf^T
// [c + 1, ldn] and the warps' key rows [kWarps, ldn]; chain: the two ping-pong
// buffers), then the group's aggregate [group, h_out], the pass rows' sender masks
// [ldr] (both empty without a chain), and the group's distances and neighbours
// [group, k].
struct KnnSmem {
  float* work;
  float* agg;
  float* smask;
  float* seld;
  int* sel;
};

__device__ __forceinline__ KnnSmem knn_smem(float* base, const KnnPlan& p, int h_out, int k,
                                            bool chain) {
  KnnSmem s;
  s.work = base;
  s.agg = base + p.work;
  s.smask = s.agg + (chain ? p.group * h_out : 0);
  s.seld = s.smask + (chain ? p.ldr : 0);
  s.sel = reinterpret_cast<int*>(s.seld + p.group * k);
  return s;
}

// The search for receivers g0 .. g0 + g_eff of jet b: the jet's senders are staged
// transposed in shared memory with their squared norms, then a warp per receiver
// computes the n keys into its own row of shared memory and extracts the minimum
// k times (lane-strided minimum, __reduce_min_sync, the winner's key set to
// INT_MAX). Keys are unique, so a pass removes exactly one sender, and ties inside
// a truncation bucket break by index, as in the TPU kernels. Fills sel (and seld
// with want_dists) and, where the pointers are not null, idx_out and dists_out.
// The caller synchronizes the CTA before it reads sel or reuses `work`.
__device__ void knn_search_stage(const float* __restrict__ xs, const float* __restrict__ xf,
                                 int* __restrict__ idx_out, float* __restrict__ dists_out, int b,
                                 int g0, int g_eff, int n, int c, int k, int self_loops,
                                 int want_dists, int key_bits, const KnnPlan& p, float* work,
                                 int* sel, float* seld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xfb = xf + (size_t)b * n * c;
  float* xft = work;                                         // [c + 1, ldn]
  int* keys = reinterpret_cast<int*>(work + (c + 1) * p.ldn);  // [kWarps, ldn]
  for (int t = threadIdx.x; t < n * c; t += kThreads) {
    const int j = t / c, cc = t - (t / c) * c;
    xft[cc * p.ldn + j] = xfb[t];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float s = __fmul_rn(xft[j], xft[j]);
    for (int cc = 1; cc < c; ++cc) {
      const float v = xft[cc * p.ldn + j];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    xft[c * p.ldn + j] = s;
  }
  __syncthreads();
  const int low = (1 << key_bits) - 1;
  const int start = self_loops ? 0 : 1;
  int* wkeys = keys + warp * p.ldn;
  for (int ii = warp; ii < g_eff; ii += kWarps) {
    const float* xsi = xs + ((size_t)b * n + g0 + ii) * c;
    float sq1 = __fmul_rn(__ldg(xsi), __ldg(xsi));
    for (int cc = 1; cc < c; ++cc) {
      const float v = __ldg(xsi + cc);
      sq1 = __fadd_rn(sq1, __fmul_rn(v, v));
    }
    for (int j = lane; j < n; j += 32) {
      float d = __fmul_rn(-2.f * __ldg(xsi), xft[j]);
      for (int cc = 1; cc < c; ++cc)
        d = __fadd_rn(d, __fmul_rn(-2.f * __ldg(xsi + cc), xft[cc * p.ldn + j]));
      d = __fadd_rn(__fadd_rn(d, xft[c * p.ldn + j]), sq1);
      d = d > 0.f ? d : 0.f;
      wkeys[j] = (__float_as_int(d) & ~low) | j;
    }
    __syncwarp();
    for (int s = 0; s < k + start; ++s) {
      int m = INT_MAX;
      for (int j = lane; j < n; j += 32) m = min(m, wkeys[j]);
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) {
        wkeys[m & low] = INT_MAX;
        if (s >= start) sel[ii * k + s - start] = m & low;
      }
      __syncwarp();
    }
    for (int s = lane; s < k; s += 32) {
      const int j = sel[ii * k + s];
      const size_t e = ((size_t)b * n + g0 + ii) * k + s;
      if (idx_out != nullptr) idx_out[e] = j;
      if (want_dists) {
        // the exact distance of the selected edge: |xf[j] - xs[i] + 1e-12|
        float sum = 0.f;
        for (int cc = 0; cc < c; ++cc) {
          const float diff = xft[cc * p.ldn + j] - __ldg(xsi + cc) + 1e-12f;
          sum = fmaf(diff, diff, sum);
        }
        const float dist = sqrtf(sum);
        seld[ii * k + s] = dist;
        if (dists_out != nullptr) dists_out[e] = dist;
      }
    }
  }
}

// The chain over the selected edges of receivers g0 .. g0 + g_eff of jet b, in
// passes of ti receivers x kc ranks (ti * kc <= 128 pair rows) through the
// transposed ping-pong buffers and register-tiled dense layer of the dense
// kernels, and a masked sum over each receiver's ranks into the group's aggregate
// in shared memory, written to out at the end. In train mode every activation is
// multiplied by K1's multiplier, keyed on the pair id b*n*k + i*k + s. Its first
// __syncthreads orders it after whatever filled sel and seld.
template <bool kDrop>
__device__ void knn_chain_stage(const float* __restrict__ u1, const float* __restrict__ u2m,
                                const float* __restrict__ w_d, float* __restrict__ out, int b,
                                int g0, int g_eff, int n, int h1, int k, int want_dists,
                                const KnnPlan& p, const Chain& fe, float alpha, int sum_agg,
                                Drop drop, const KnnSmem& sm) {
  const int h_out = fe.dim[fe.n];
  float* buf0 = sm.work;
  float* buf1 = sm.work + p.buf0;
  float* agg = sm.agg;
  float* smask = sm.smask;
  const float* seld = sm.seld;
  const int* sel = sm.sel;
  const float* u1b = u1 + ((size_t)b * n + g0) * h1;
  const float* u2mb = u2m + (size_t)b * n * (h1 + 1);
  for (int t = threadIdx.x; t < g_eff * h_out; t += kThreads) agg[t] = 0.f;

  for (int ib = 0; ib < g_eff; ib += p.ti) {
    const int ti_eff = min(p.ti, g_eff - ib);
    const int rows = round_up(ti_eff * p.kc, kRowBlock);
    for (int s0 = 0; s0 < k; s0 += p.kc) {
      const int kc_eff = min(p.kc, k - s0);
      if (kDrop) drop.base = (unsigned)(b * n + g0 + ib) * (unsigned)k + (unsigned)s0;
      __syncthreads();  // sel and seld are filled, or the previous pass's reduction has finished
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        const int ii = r / p.kc, ss = r - (r / p.kc) * p.kc;
        float m = 0.f;
        if (ii < ti_eff && ss < kc_eff)
          m = u2mb[(size_t)sel[(ib + ii) * k + s0 + ss] * (h1 + 1) + h1];
        smask[r] = m;
      }
      // layer 1, decomposed; row r = (receiver ii, rank ss); h fastest for coalesced reads
      for (int t = threadIdx.x; t < rows * h1; t += kThreads) {
        const int r = t / h1, h = t - (t / h1) * h1;
        const int ii = r / p.kc, ss = r - (r / p.kc) * p.kc;
        float v = 0.f;
        if (ii < ti_eff && ss < kc_eff) {
          const int e = (ib + ii) * k + s0 + ss;
          float z = u1b[(size_t)(ib + ii) * h1 + h] + u2mb[(size_t)sel[e] * (h1 + 1) + h];
          // product and sum rounded apart, as the plain version's z + dist * w_d: K6's
          // recompute and the plain backward then see the same bits (see knn_edge_bwd.cu)
          if (want_dists) z = __fadd_rn(z, __fmul_rn(seld[e], __ldg(w_d + h)));
          v = leaky(z, alpha);
          if (kDrop) v *= dropmul(drop, pair_id(drop, r), (unsigned)h, 0u);
        }
        buf0[h * p.ldr + r] = v;
      }
      float* src = buf0;
      float* dst = buf1;
      for (int l = 0; l < fe.n; ++l) {
        __syncthreads();
        const int K = fe.dim[l], M = fe.dim[l + 1];
        dense_layer<kDrop>(src, p.ldr, dst, p.ldr, rows, K, M, fe.w[l], nullptr, K, fe.b[l], true,
                           alpha, drop, (unsigned)(l + 1));
        float* tmp = src;
        src = dst;
        dst = tmp;
      }
      __syncthreads();
      // masked sum over this pass's ranks
      for (int t = threadIdx.x; t < ti_eff * h_out; t += kThreads) {
        const int ii = t / h_out, h = t - (t / h_out) * h_out;
        const float* col = src + h * p.ldr + ii * p.kc;
        const float* mk = smask + ii * p.kc;
        float acc = 0.f;
        for (int ss = 0; ss < kc_eff; ++ss) acc = fmaf(mk[ss], col[ss], acc);
        agg[(ib + ii) * h_out + h] += acc;
      }
    }
  }
  __syncthreads();
  const float denom = sum_agg ? 1.f : (float)k;
  for (int t = threadIdx.x; t < g_eff * h_out; t += kThreads) {
    const int r = t / h_out, h = t - (t / h_out) * h_out;
    out[((size_t)b * n + g0 + r) * h_out + h] = agg[t] / denom;
  }
}

// Choose the receiver group, the pass shape (fewest padded rows) and the buffer
// sizes for a kernel that runs the search, the chain or both; shrink the pass
// until the shared memory fits. Returns the bytes, or 0.
size_t make_knn_plan(int n, int c, int k, const Chain& fe, bool search, bool chain, KnnPlan& p) {
  p = KnnPlan{};
  p.group = group_size(n);
  p.ldn = round_up(n, 32);
  const long long search_floats = search ? (long long)(c + 1 + kWarps) * p.ldn : 0;
  const long long tail = 2LL * p.group * k;
  if (!chain) {
    p.work = round_up((int)search_floats, 4);
    const long long floats = p.work + tail;
    return floats * (long long)sizeof(float) <= (long long)kMaxSmemBytes
               ? (size_t)floats * sizeof(float) : 0;
  }
  const int h_out = fe.dim[fe.n];
  int even = 0, odd = 0;
  for (int l = 0; l <= fe.n; ++l) {
    int& w = (l % 2 == 0) ? even : odd;
    w = fe.dim[l] > w ? fe.dim[l] : w;
  }
  for (int max_rows = kMaxPassRows; max_rows >= kRowBlock; max_rows -= kRowBlock) {
    choose_pass(k, p.group, max_rows, p.ti, p.kc);
    // stride = rows + 4 floats: 16-byte aligned rows, and column walks spread over banks
    p.ldr = round_up(p.ti * p.kc, kRowBlock) + 4;
    p.buf0 = even * p.ldr;
    const long long chain_floats = (long long)(even + odd) * p.ldr;
    const long long work =
        round_up((int)(chain_floats > search_floats ? chain_floats : search_floats), 4);
    const long long floats = work + (long long)p.group * h_out + p.ldr + tail;
    if (floats * (long long)sizeof(float) <= (long long)kMaxSmemBytes) {
      p.work = (int)work;
      return (size_t)floats * sizeof(float);
    }
  }
  return 0;
}

int knn_key_bits(int n) {
  int bits = 8;
  while ((1 << bits) < n) ++bits;  // max(8, bitlen(n - 1))
  return bits;
}

// The K1 parameters of a knn launch; `dropout` 0 leaves them unused.
Drop knn_drop(int dropout, int seed, unsigned thr, float mult, const KnnPlan& p, int k) {
  Drop drop{};
  if (dropout) {
    drop.seed_key = (unsigned)seed * 0xC2B2AE3Du;
    drop.thr = thr;
    drop.mult = mult;
  }
  drop.jc = p.kc;
  drop.ns = k;
  return drop;
}

}  // namespace
