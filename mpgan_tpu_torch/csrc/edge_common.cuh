// Pieces shared by the edge kernels (dense: edge_aggregate.cu, K2 and K4, and
// edge_aggregate_bwd.cu, K3; knn: knn_stages.cuh, K5, K7 and K8, and
// knn_edge_bwd.cu, K6): layer-chain descriptions and K1, the dropout hash of
// mpgan_tpu/ops/mp_pallas.py::_dropmul.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
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

// K1: the dropout hash of one element, keyed on the element's global pair id.
// Dense kernels: (b*n + i)*ns + j with ns = ceil(n / 8) * 8, the TPU kernel's
// padded sender count (the ids keep it, so masks agree bit for bit with the JAX
// package). knn kernels: (b*n + i)*k + s, s the neighbour's extraction rank
// (knn_pallas._v3_ids_at). The seed is read from device memory, as the TPU kernel
// reads seed_ref[0]: a kernel takes a pointer to it beside its Drop and keys the
// Drop at its start (drop_load), so a launch captured in a CUDA graph hashes, at
// each replay, the seed that the buffer holds then.
struct Drop {
  unsigned seed_key;  // seed * 0xC2B2AE3D, set by drop_load
  unsigned thr;       // keep iff hash >= thr; thr = min(int(p * 2^32), 2^32 - 1)
  float mult;         // float32(1 / (1 - p))
  int ns;             // dense: the sender count the ids are laid out on
};

// `d` keyed on the seed `seed` points to in device memory, in [0, 2^31) (checked
// by the caller), with dropout on.
__device__ __forceinline__ Drop drop_load(Drop d, const int* seed, bool on) {
  if (on) d.seed_key = (unsigned)__ldg(seed) * 0xC2B2AE3Du;
  return d;
}

__device__ __forceinline__ float dropmul(const Drop& d, unsigned id, unsigned col, unsigned salt) {
  unsigned h = id * 0x9E3779B1u + d.seed_key + salt * 0x27D4EB2Fu + col * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 15;
  return h >= d.thr ? d.mult : 0.f;
}

// Element loads and stores of the edge kernels' inputs and outputs: float32 in
// the FP32 mode, bf16 in the bf16 mode (converted to and from float32 here). A
// bf16 element is read by a plain load, not cuda_bf16's __ldg: that is inline
// assembly without side effects, which the compiler may issue ahead of the
// guard that keeps a read in bounds (w_d is null without distances; a padded
// row's offset is negative).
using bf16 = __nv_bfloat16;
__device__ __forceinline__ float ld_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_elem(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_elem(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The pass structs keep their row pointers as float*; in the bf16 mode they
// point to bf16 rows and are read through this cast, with element offsets.
template <typename T>
__device__ __forceinline__ const T* rows_as(const float* p) {
  return reinterpret_cast<const T*>(p);
}

__device__ __forceinline__ float leaky(float v, float alpha) { return v >= 0.f ? v : alpha * v; }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

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

}  // namespace
