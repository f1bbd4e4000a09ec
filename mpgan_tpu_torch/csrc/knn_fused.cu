// Fused knn message-passing edge stage for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces K5 of mpgan_tpu/ops/knn_pallas.py: _fused_impl_v4 (_fused_kernel_v4),
// with K1, the in-kernel dropout hash (mp_pallas._dropmul), in train mode. The
// backward, K6, is in knn_edge_bwd.cu; the shared pieces are in edge_common.cuh.
//
// For every jet b and receiver i
//   d[i, j]   = (-2 xs[i] | 1) . (xf[j] | |xf[j]|^2) + |xs[i]|^2          (full FP32)
//               summed term by term in column order, every product and sum rounded
//               on its own (__fmul_rn, __fadd_rn: no contraction into FMAs), so the
//               keys equal the plain PyTorch version's bit for bit
//   key[i, j] = bits(max(d, 0)) & ~(2^bits - 1) | j,   bits = max(8, bitlen(n - 1))
//   idx[i, s] = sender of the s-th smallest key (k + 1 extractions, the first
//               dropped, without self loops)
//   z1[i, s]  = u1[i] + u2m[idx[i, s], :h1] (+ |xf[idx[i, s]] - xs[i] + 1e-12| * w_d)
//   agg[i]    = sum_s u2m[idx[i, s], h1] * chain(leaky(z1[i, s]))         (/ k for mean)
// where `chain` is the fe MLP's hidden layers (LeakyReLU after each) and u2m's
// last column is the sender mask. The fe first layer arrives decomposed, as in the
// dense kernels. In train mode every activation is multiplied by K1's multiplier,
// keyed on the pair id b*n*k + i*k + s: the extraction rank s is part of the id,
// so the neighbours are kept in ascending key order. A launch that feeds a
// backward also writes idx [B, N, k] (and the distances).
//
// What bounds it: the chain is 2 * k * (sum of in * out) FLOP per receiver (92
// KFLOP per edge at the published widths, k = 20: 277 MFLOP per 150-particle jet)
// against ~1 KB of input per particle, so like K2 the kernel is bound by FP32 FMA
// issue; the search is under 1% of that arithmetic. The design:
//   - the TPU kernel's layout devices are not carried over: its one-hot gather
//     matmul is an indexed read of u2m rows from device memory (a jet's operands
//     sit in L2), its receiver padding and neighbour-major residual columns are a
//     plain [B, N, k] idx, its tree sum a fixed-order loop;
//   - a CTA owns a group of up to 32 receivers of one jet, as in K2. First the
//     search: the jet's senders are staged transposed in shared memory with their
//     squared norms, then a warp per receiver computes the n keys into its own row
//     of shared memory and extracts the minimum k times (lane-strided minimum,
//     __reduce_min_sync, the winner's key set to INT_MAX). Keys are unique, so a
//     pass removes exactly one sender, and ties inside a truncation bucket break by
//     index, as in the TPU kernel. The search arrays share their shared memory
//     with the pass buffers, which are not live yet;
//   - then the chain in passes of ti receivers x kc ranks (ti * kc <= 128 pair
//     rows) through the same transposed ping-pong buffers and register-tiled
//     dense layer as K2, and a masked sum over each receiver's ranks into the
//     group's aggregate in shared memory. Nothing crosses CTAs;
//   - no tensor cores and no TF32: the keys need full FP32 (a reduced-precision
//     product flips neighbours), and the chain holds FP32 parity with the plain
//     version.

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

// grid = (batch, number of receiver groups). Dynamic shared memory: the shared
// region (search: xf^T [c + 1, ldn] and the warps' key rows [kWarps, ldn]; chain:
// the two ping-pong buffers), then the group's aggregate [group, h_out], the pass
// rows' sender masks [ldr], and the group's distances and neighbours [group, k].
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    knn_fused_kernel(const float* __restrict__ xs, const float* __restrict__ xf,
                     const float* __restrict__ u1, const float* __restrict__ u2m,
                     const float* __restrict__ w_d, float* __restrict__ out,
                     int* __restrict__ idx_out, float* __restrict__ dists_out, int n, int c,
                     int h1, int k, int self_loops, int want_dists, int key_bits, KnnPlan p,
                     Chain fe, float alpha, int sum_agg, Drop drop) {
  extern __shared__ float4 smem4[];
  float* work = reinterpret_cast<float*>(smem4);
  const int h_out = fe.dim[fe.n];
  float* buf0 = work;
  float* buf1 = work + p.buf0;
  float* agg = work + p.work;           // [group, h_out]
  float* smask = agg + p.group * h_out;  // [ldr]
  float* seld = smask + p.ldr;          // [group, k]
  int* sel = reinterpret_cast<int*>(seld + p.group * k);  // [group, k]

  const int b = blockIdx.x;
  const int g0 = blockIdx.y * p.group;
  const int g_eff = min(p.group, n - g0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xfb = xf + (size_t)b * n * c;
  const float* u1b = u1 + ((size_t)b * n + g0) * h1;
  const float* u2mb = u2m + (size_t)b * n * (h1 + 1);

  // ---- the search
  float* xft = work;                                         // [c + 1, ldn]
  int* keys = reinterpret_cast<int*>(work + (c + 1) * p.ldn);  // [kWarps, ldn]
  for (int t = threadIdx.x; t < n * c; t += kThreads) {
    const int j = t / c, cc = t - (t / c) * c;
    xft[cc * p.ldn + j] = xfb[t];
  }
  for (int t = threadIdx.x; t < g_eff * h_out; t += kThreads) agg[t] = 0.f;
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

  // ---- the chain over the selected edges
  for (int ib = 0; ib < g_eff; ib += p.ti) {
    const int ti_eff = min(p.ti, g_eff - ib);
    const int rows = round_up(ti_eff * p.kc, kRowBlock);
    for (int s0 = 0; s0 < k; s0 += p.kc) {
      const int kc_eff = min(p.kc, k - s0);
      if (kDrop) drop.base = (unsigned)(b * n + g0 + ib) * (unsigned)k + (unsigned)s0;
      __syncthreads();  // the search, or the previous pass's reduction, has finished
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
// sizes; shrink the pass until the shared memory fits. Returns the bytes, or 0.
size_t make_knn_plan(int n, int c, int k, const Chain& fe, KnnPlan& p) {
  p.group = group_size(n);
  p.ldn = round_up(n, 32);
  const long long search = (long long)(c + 1 + kWarps) * p.ldn;
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
    const long long chain = (long long)(even + odd) * p.ldr;
    const long long work = round_up((int)(chain > search ? chain : search), 4);
    const long long floats = work + (long long)p.group * h_out + p.ldr + 2LL * p.group * k;
    if (floats * (long long)sizeof(float) <= (long long)kMaxSmemBytes) {
      p.work = (int)work;
      return (size_t)floats * sizeof(float);
    }
  }
  return 0;
}

template <bool kDrop>
int launch(const float* xs, const float* xf, const float* u1, const float* u2m, const float* w_d,
           float* out, int* idx_out, float* dists_out, int batch, int n, int c, int h1, int k,
           int self_loops, int want_dists, const Chain& fe, float alpha, int sum_agg, Drop drop,
           void* stream) {
  KnnPlan p;
  const size_t smem = make_knn_plan(n, c, k, fe, p);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(knn_fused_kernel<kDrop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  drop.jc = p.kc;
  drop.ns = k;
  int key_bits = 8;
  while ((1 << key_bits) < n) ++key_bits;  // max(8, bitlen(n - 1))
  const dim3 grid(batch, (n + p.group - 1) / p.group);
  knn_fused_kernel<kDrop><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, xf, u1, u2m, w_d, out, idx_out, dists_out, n, c, h1, k, self_loops, want_dists,
      key_bits, p, fe, alpha, sum_agg, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. xs, xf [batch, n, c]; u1 [batch, n, h1]; u2m [batch, n, h1 + 1]; w_d [h1]
// (read with want_dists); out [batch, n, h_out]; idx_out int32 [batch, n, k] and
// dists_out [batch, n, k] may be null (dists_out is written with want_dists only).
// hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. With `dropout`, K1
// runs with seed in [0, 2^31), keep threshold `thr` and multiplier `mult` as
// computed on the host (see Drop). Returns a cudaError_t code (0 on success); the
// launch is asynchronous on `stream`.
int mpgan_knn_fused_layer(const float* xs, const float* xf, const float* u1, const float* u2m,
                          const float* w_d, float* out, int* idx_out, float* dists_out,
                          int batch, int n, int c, int h1, int k, int self_loops, int want_dists,
                          int n_hidden, const void* const* hidden_w,
                          const void* const* hidden_b, const int* hidden_dims, float alpha,
                          int sum_agg, int dropout, int seed, unsigned thr, float mult,
                          void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || n > (1 << 22) || c < 1 || c > kMaxWidth || h1 < 1 || h1 > kMaxWidth ||
      seed < 0)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k + (self_loops ? 0 : 1) > n || (want_dists && w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  if (!dropout)
    return launch<false>(xs, xf, u1, u2m, w_d, out, idx_out, dists_out, batch, n, c, h1, k,
                         self_loops, want_dists, fe, alpha, sum_agg, Drop{}, stream);
  Drop drop{};
  drop.seed_key = (unsigned)seed * 0xC2B2AE3Du;
  drop.thr = thr;
  drop.mult = mult;
  return launch<true>(xs, xf, u1, u2m, w_d, out, idx_out, dists_out, batch, n, c, h1, k,
                      self_loops, want_dists, fe, alpha, sum_agg, drop, stream);
}

}  // extern "C"
