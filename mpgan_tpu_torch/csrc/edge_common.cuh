// Pieces shared by the edge kernels (dense: edge_aggregate.cu, K2 and K4, and
// edge_aggregate_bwd.cu, K3; knn: knn_stages.cuh, K5, K7 and K8, and
// knn_edge_bwd.cu, K6): layer-chain descriptions, K1 (the dropout hash of
// mpgan_tpu/ops/mp_pallas.py::_dropmul), and for the knn forward stages the pass
// planner and the FP32 register-tiled dense layer over activations stored
// transposed in shared memory (the dense kernels run edge_products.cuh's
// products instead).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRowBlock = 32;      // rows of a warp tile: 4 row groups x 8 rows
constexpr int kColBlock = 32;      // columns of a warp tile: 8 column groups x 4 columns
constexpr int kMaxGroup = 32;      // receivers per CTA
constexpr int kMaxPassRows = 128;  // pair rows per pass through the chain
constexpr int kMaxSmemBytes = 227 * 1024;

struct Chain {
  const float* w[kMaxLayers];  // layer l weight, [dim[l], dim[l + 1]] row-major ([in, out])
  const float* b[kMaxLayers];  // layer l bias, [dim[l + 1]]
  int dim[kMaxLayers + 1];
  int n;                       // number of layers
  const float* w0_lo;          // layer 0 rows k >= k0_split (fn: the x rows); else unused
  int k0_split;                // layer 0 rows read from w[0]
  int act_last;                // last layer has an activation
};

// K1: the dropout hash of one element. A pass row r is the pair (receiver
// ii = r / jc, sender jj = r % jc) of the pass; its global id is
// base + ii * ns + jj, where base = b*n*ns + (first receiver)*ns + first sender.
// Dense kernels: ns = ceil(n / 8) * 8, the TPU kernel's padded sender count (the
// ids keep it, so masks agree bit for bit with the JAX package). knn kernels: the
// "sender" of a row is the neighbour's extraction rank s, ns = k and jc the ranks
// per pass, so the id is b*n*k + i*k + s (knn_pallas._v3_ids_at).
struct Drop {
  unsigned seed_key;  // seed * 0xC2B2AE3D
  unsigned thr;       // keep iff hash >= thr; thr = min(int(p * 2^32), 2^32 - 1)
  float mult;         // float32(1 / (1 - p))
  unsigned base;      // id of the pass's row 0
  int jc;             // senders (knn: neighbour ranks) per pass
  int ns;             // sender count the ids are laid out on
};

__device__ __forceinline__ unsigned pair_id(const Drop& d, int r) {
  const int ii = r / d.jc;
  return d.base + (unsigned)ii * (unsigned)d.ns + (unsigned)(r - ii * d.jc);
}

__device__ __forceinline__ float dropmul(const Drop& d, unsigned id, unsigned col, unsigned salt) {
  unsigned h = id * 0x9E3779B1u + d.seed_key + salt * 0x27D4EB2Fu + col * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 15;
  return h >= d.thr ? d.mult : 0.f;
}

__device__ __forceinline__ float leaky(float v, float alpha) { return v >= 0.f ? v : alpha * v; }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// acc[8 rows][4 cols] += A[r0:r0+8, k_begin:k_end] @ W[0:k_end-k_begin, c0:c0+4],
// with A stored transposed (A[k * lda + r]).
template <bool kVec>
__device__ __forceinline__ void accumulate(const float* __restrict__ A, int lda, int k_begin,
                                           int k_end, const float* __restrict__ W, int M, int r0,
                                           int c0, float (&acc)[8][4]) {
  const float* a_ptr = A + (size_t)k_begin * lda + r0;
  const float* w_ptr = W + c0;
#pragma unroll 16
  for (int k = k_begin; k < k_end; ++k, a_ptr += lda, w_ptr += M) {
    float w[4];
    if (kVec) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w_ptr));
      w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = (c0 + j < M) ? __ldg(w_ptr + j) : 0.f;
    }
    const float4 a0 = *reinterpret_cast<const float4*>(a_ptr);
    const float4 a1 = *reinterpret_cast<const float4*>(a_ptr + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// C = act(A @ W + bias) for `rows` rows, A [K features x lda] and C [M x ldc] stored
// transposed in shared memory. `rows` is a multiple of kRowBlock; rows k >= k_split
// of W come from W_lo; `bias` may be null. With kDrop, each output (row r, column c)
// is multiplied by K1's multiplier for (pair_id(r), c, salt) after the activation.
template <bool kDrop>
__device__ void dense_layer(const float* __restrict__ A, int lda, float* __restrict__ C, int ldc,
                            int rows, int K, int M, const float* __restrict__ W,
                            const float* __restrict__ W_lo, int k_split,
                            const float* __restrict__ bias, bool act, float alpha,
                            const Drop& drop, unsigned salt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrb = rows / kRowBlock, ncb = (M + kColBlock - 1) / kColBlock;
  const bool vec = (M & 3) == 0;
  for (int wb = warp; wb < nrb * ncb; wb += kWarps) {
    const int r0 = (wb / ncb) * kRowBlock + (lane >> 3) * 8;
    const int c0 = (wb % ncb) * kColBlock + (lane & 7) * 4;
    if (c0 >= M) continue;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (vec) {
      accumulate<true>(A, lda, 0, k_split, W, M, r0, c0, acc);
      if (k_split < K) accumulate<true>(A, lda, k_split, K, W_lo, M, r0, c0, acc);
    } else {
      accumulate<false>(A, lda, 0, k_split, W, M, r0, c0, acc);
      if (k_split < K) accumulate<false>(A, lda, k_split, K, W_lo, M, r0, c0, acc);
    }
    unsigned ids[8];
    if (kDrop) {
#pragma unroll
      for (int i = 0; i < 8; ++i) ids[i] = pair_id(drop, r0 + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      if (c >= M) break;
      const float bc = bias != nullptr ? __ldg(bias + c) : 0.f;
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = acc[i][j] + bc;
        if (act) v[i] = leaky(v[i], alpha);
        if (kDrop) v[i] *= dropmul(drop, ids[i], (unsigned)c, salt);
      }
      float4* dst = reinterpret_cast<float4*>(C + (size_t)c * ldc + r0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

bool fill_chain(Chain& c, int n_layers, const void* const* w, const void* const* b,
                const int* dims) {
  if (n_layers < 0 || n_layers > kMaxLayers) return false;
  c = Chain{};
  c.n = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return false;
    c.dim[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    c.w[l] = static_cast<const float*>(w[l]);
    c.b[l] = static_cast<const float*>(b[l]);
  }
  c.k0_split = n_layers > 0 ? dims[0] : 0;
  c.act_last = 1;
  return true;
}

// Padded pair rows that one receiver group of `g` costs over `n` senders.
long long pass_rows_total(int g, int n, int ti, int jc) {
  long long rows = 0;
  for (int ib = 0; ib < g; ib += ti) {
    const int te = g - ib < ti ? g - ib : ti;
    rows += round_up(te * jc, kRowBlock);
  }
  return rows * ((n + jc - 1) / jc);
}

// Receivers per CTA: the jet's receivers split evenly into groups of at most kMaxGroup.
int group_size(int n) {
  const int n_groups = (n + kMaxGroup - 1) / kMaxGroup;
  return (n + n_groups - 1) / n_groups;
}

int num_groups(int n) {
  const int g = group_size(n);
  return (n + g - 1) / g;
}

// The pass shape (ti receivers x jc senders, at most max_rows pair rows) with the
// fewest padded rows over a group; ties go to the larger pass.
void choose_pass(int n, int group, int max_rows, int& ti, int& jc) {
  long long best = -1;
  ti = jc = 0;
  for (int c = 1; c <= n && c <= max_rows; ++c) {
    for (int t = 1; t <= group && t * c <= max_rows; ++t) {
      const long long cost = pass_rows_total(group, n, t, c);
      if (best < 0 || cost < best || (cost == best && t * c > ti * jc)) {
        best = cost;
        ti = t;
        jc = c;
      }
    }
  }
}

}  // namespace
