// The bf16 mode's pieces of the backward kernels that recompute on the bf16
// stage: the dense backward (edge_aggregate_bwd_bf16.cu: K3) and the knn backward
// (knn_edge_bwd_bf16.cu: K6). A launch of its own packs, before the kernel, the
// recompute's weights as a bf16 copy in fragment order (edge_products_bf16.cuh:
// bf16_elem), W^T for the da products as the float32 values of the bf16
// weights in the split-TF32 stage's fragment order (edge_bwd_tf32x3.cuh:
// tf32_elem), and every bias as float32; the recompute's products run on the
// bf16 stage, the backward's on the split-TF32 one.
#pragma once

#include "edge_bwd_common.cuh"
#include "edge_bwd_tf32x3.cuh"
#include "edge_products_bf16.cuh"

namespace {

// Offsets (floats) of the bf16 mode's packed scratch of a backward launch: per
// layer the recompute's bf16 copy, W^T for da and the float32 bias.
struct BwdPackBf16 {
  long long fwd[kMaxLayers], bwd[kMaxLayers], b[kMaxLayers], total;
};

BwdPackBf16 bwd_pack_bf16(const Chain& fe) {
  BwdPackBf16 o{};
  long long off = 0;
  for (int l = 0; l < fe.n; ++l) {
    const int K = fe.dim[l], M = fe.dim[l + 1];
    o.fwd[l] = off;
    off += bf16_packed_floats(K, M);
    o.bwd[l] = off;
    off += tf32_packed_floats(M, K);
    o.b[l] = off;
    off += round_up(M, 4);
  }
  o.total = off;
  return o;
}

template <typename T>
__global__ void pack_weights_bf16(Chain fe, BwdPackBf16 o, float* __restrict__ packed) {
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int l = 0; l < fe.n; ++l) {
    pack_layer_bf16<T>(packed + o.fwd[l], packed + o.b[l], fe, l, start, stride);
    // W^T [M x K]: element (k, n) is W[n, k], as float32 (exact in TF32)
    const int K = fe.dim[l], M = fe.dim[l + 1];
    const T* w = rows_as<T>(fe.w[l]);
    float* out = packed + o.bwd[l];
    for (long long t = start; t < tf32_packed_floats(M, K); t += stride) {
      const Tf32Elem te = tf32_elem(t, K);
      out[t] = te.k < M && te.n < K ? __bfloat162float(w[(size_t)te.n * M + te.k]) : 0.f;
    }
  }
}

template <typename T>
int launch_pack_bf16(Chain& fe, float* packed, long long packed_floats, Packed& pk,
                     cudaStream_t stream) {
  const BwdPackBf16 o = bwd_pack_bf16(fe);
  if (o.total > packed_floats) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < fe.n; ++l) {
    pk.fwd[l] = packed + o.fwd[l];
    pk.bwd[l] = packed + o.bwd[l];
  }
  if (fe.n == 0) return 0;
  pack_weights_bf16<T><<<64, 256, 0, stream>>>(fe, o, packed);
  // the kernel reads the float32 biases (the packer has read the bf16 ones)
  for (int l = 0; l < fe.n; ++l) fe.b[l] = packed + o.b[l];
  return (int)cudaGetLastError();
}

template <typename T>
__device__ int product_recompute(int A, int K, const float* W, int M, int slab,
                                 const PassShape& p, const Epilogue& e) {
  return product_bf16_at(A, K, W, M, slab, p, e);
}

}  // namespace
