// Fused knn message-passing edge stage for Hopper (sm_90a), FP32 on CUDA cores.
//
// Replaces K5 of mpgan_tpu/ops/knn_pallas.py: _fused_impl_v4 (_fused_kernel_v4),
// with K1, the in-kernel dropout hash (mp_pallas._dropmul), in train mode. The
// backward, K6, is in knn_edge_bwd.cu.
//
// For every jet b and receiver i
//   d[i, j]   = (-2 xs[i] | 1) . (xf[j] | |xf[j]|^2) + |xs[i]|^2          (full FP32)
//   key[i, j] = bits(max(d, 0)) & ~(2^bits - 1) | j,   bits = max(8, bitlen(n - 1))
//   idx[i, s] = sender of the s-th smallest key (the first of k + 1 dropped
//               without self loops)
//   z1[i, s]  = u1[i] + u2m[idx[i, s], :h1] (+ |xf[idx[i, s]] - xs[i] + 1e-12| * w_d)
//   agg[i]    = sum_s u2m[idx[i, s], h1] * chain(leaky(z1[i, s]))         (/ k for mean)
// where `chain` is the fe MLP's hidden layers (LeakyReLU after each) and u2m's
// last column is the sender mask. The fe first layer arrives decomposed, as in the
// dense kernels. In train mode every activation is multiplied by K1's multiplier,
// keyed on the pair id b*n*k + i*k + s: the extraction rank s is part of the id,
// so the neighbours are kept in ascending key order. A launch that feeds a
// backward also writes idx [B, N, k] (and the distances).
//
// It is knn_stages.cuh's forward kernel with the search: the search is the one K7
// launches alone (knn_search.cu), the chain the pass that K2, K4 and K8 run
// (edge_fwd_common.cuh), so on its own idx K8 gives its output bit for bit. What
// bounds it: the chain, 2 * k * (sum of in * out) FLOP a receiver (277 MFLOP a
// 150-particle jet at the published widths, k = 20) against ~1 KB of input a
// particle, so the FP32 FMA issue of the pass's products; the search is under 1%
// of that arithmetic (a receiver's threads keep its k + 1 smallest keys sorted in
// registers). The TPU kernel's layout devices are not carried over:
// its one-hot gather matmul is an indexed read of u2m rows (a jet's operands sit
// in L2), its receiver padding and neighbour-major residual columns a plain
// [B, N, k] idx, its tree sum a fixed-order loop. No tensor cores and no TF32: the
// keys need full FP32 (a reduced-precision product flips neighbours), and the
// chain holds FP32 parity with the plain version.

#include "knn_stages.cuh"

extern "C" {

// K5. xs, xf [batch, n, c]; u1 [batch, n, h1]; u2m [batch, n, h1 + 1]; w_d [h1]
// (read with want_dists); out [batch, n, h_out]; idx_out int32 [batch, n, k] and
// dists_out [batch, n, k] may be null (dists_out is written with want_dists only);
// packed: scratch for the packed weights (mp_kernels.fwd_packed_floats).
// hidden_dims has n_hidden + 1 entries, hidden_dims[0] == h1. The pass (ti
// receivers x kc ranks in buffers of `rows`), the search's span, the grid and the
// weight slabs' size are the caller's plan (knn_kernels.knn_fwd_plan). Returns a
// cudaError_t code (0 on success); the launch is asynchronous on `stream`.
int mpgan_knn_fused_layer(const float* xs, const float* xf, const float* u1, const float* u2m,
                          const float* w_d, float* out, int* idx_out, float* dists_out,
                          float* packed, int batch, int n, int c, int h1, int k, int self_loops,
                          int want_dists, int n_hidden, const void* const* hidden_w,
                          const void* const* hidden_b, const int* hidden_dims, float alpha,
                          int sum_agg, int dropout, const int* seed, unsigned thr, float mult,
                          int ti, int kc, int rows, int sspan, int grid, int slab_floats,
                          void* stream) {
  Chain fe;
  if (batch < 1 || n < 1 || n > (1 << 22) || c < 1 || c > kMaxWidth || h1 < 1 || h1 > kMaxWidth)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k + (self_loops ? 0 : 1) > n || (want_dists && w_d == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!fill_chain(fe, n_hidden, hidden_w, hidden_b, hidden_dims) || fe.dim[0] != h1)
    return (int)cudaErrorInvalidValue;
  KnnArgs a{};
  a.xs = xs;
  a.xf = xf;
  a.u1 = u1;
  a.u2m = u2m;
  a.w_d = w_d;
  a.out = out;
  a.idx_out = idx_out;
  a.dists_out = dists_out;
  a.packed = packed;
  a.batch = batch;
  a.n = n;
  a.c = c;
  a.h1 = h1;
  a.k = k;
  a.self_loops = self_loops;
  a.want_dists = want_dists;
  a.sum_agg = sum_agg;
  a.sspan = sspan;
  return launch_knn_fwd<true, float>(a, fe, alpha, dropout, seed, thr, mult, ti, kc, rows,
                                     grid, slab_floats, stream);
}

// Shared memory (bytes) of a knn forward launch (K5 with search, else K8) at the
// plan's pass, search span and slab size, into *smem; -1 where the kernel does not
// run the plan. Only the card tests call it, to hold knn_kernels.knn_fwd_plan to
// the launcher's layout.
int mpgan_knn_fwd_sizes(int n_hidden, const int* hidden_dims, int batch, int n, int c, int k,
                        int search, int rows, int ti, int kc, int sspan, int slab_floats,
                        long long* smem) {
  Chain fe;
  const void* none[kMaxLayers] = {};
  if (!fill_chain(fe, n_hidden, none, none, hidden_dims)) return -1;
  KnnArgs a{};
  a.batch = batch;
  a.n = n;
  a.c = c;
  a.k = k;
  a.sspan = sspan;
  FwdPlan p{};
  p.rows = rows;
  p.ti = ti;
  p.jc = kc;
  p.slab_floats = slab_floats;
  if (!knn_fwd_layout(p, a, fe, search != 0)) return -1;
  *smem = (long long)p.smem;
  return 0;
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset.
int mpgan_knn_fused_layer_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

}  // extern "C"
