// The knn neighbour search as a kernel of its own, for Hopper (sm_90a), full FP32.
//
// Replaces K7 of mpgan_tpu/ops/knn_pallas.py: knn_select (_select_kernel), which
// returns idx, and knn_select_nm / _select_nm_impl (_select_nm_kernel), which also
// returns the exact distances of the selected edges. It is the search stage of
// the fused layer (knn_fused.cu, K5) launched alone: knn_stages.cuh holds the one
// source, so idx equals K5's and the plain PyTorch version's bit for bit.
//
//   idx[b, i, s]  = sender of the s-th smallest packed key of receiver i
//   dist[b, i, s] = |xf[idx[b, i, s]] - xs[i] + 1e-12|                (with want_dists)
//
// The neighbour-major [k, N] output of knn_select_nm is a TPU layout (it spares
// that machine a transpose before its aggregate kernel); here idx and dists stay
// [B, N, k], the layout every consumer on this card reads.
//
// What bounds it: 2 * (c + 1) FLOP per (receiver, sender) pair and k passes over a
// receiver's n keys in shared memory, against 8 bytes per selected edge written:
// at n = 150, c = 32, k = 20 about 1.5 MFLOP and 24 KB per jet. Both roofline terms
// are microseconds at any batch this model runs, so what shows is launch latency
// and the serial extraction passes of each warp, which takes two receivers side by
// side to hide them. A CTA takes a group of up to 32 receivers of a jet; the jet's
// senders are transposed in shared memory (knn_stages.cuh: knn_search_stage).

#include "knn_stages.cuh"

namespace {

// grid = (batch, receiver groups); dynamic shared memory: the search's scratch,
// then the group's neighbours and distances [group, k]. Two CTAs an SM (at most 64
// registers a thread), so that one CTA's staging and barriers overlap the other's
// extractions.
__global__ void __launch_bounds__(kThreads, 2)
    knn_search_kernel(const float* __restrict__ xs, const float* __restrict__ xf,
                      int* __restrict__ idx_out, float* __restrict__ dists_out, int n, int c,
                      int k, int self_loops, int want_dists, int key_bits, int group) {
  const int g0 = blockIdx.y * group, sel_off = round_up(search_floats(n, c), 4);
  knn_search_stage(xs, xf, idx_out, dists_out, blockIdx.x, g0, min(group, n - g0), n, c, k,
                   self_loops, want_dists, key_bits, 0, sel_off, sel_off + group * k);
}

}  // namespace

extern "C" {

// K7. xs, xf [batch, n, c]; idx_out int32 [batch, n, k]; dists_out [batch, n, k],
// written with want_dists. Returns a cudaError_t code (0 on success); the launch is
// asynchronous on `stream`.
int mpgan_knn_search(const float* xs, const float* xf, int* idx_out, float* dists_out, int batch,
                     int n, int c, int k, int self_loops, int want_dists, void* stream) {
  if (batch < 1 || n < 1 || n > (1 << 22) || c < 1 || c > kMaxWidth || idx_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k + (self_loops ? 0 : 1) > n || (want_dists && dists_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int group = group_size(n);
  const long long floats = round_up(search_floats(n, c), 4) + 2LL * group * k;
  if (floats * (long long)sizeof(float) > (long long)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_search_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (n + group - 1) / group);
  knn_search_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, xf, idx_out, dists_out, n, c, k, self_loops, want_dists, knn_key_bits(n), group);
  return (int)cudaGetLastError();
}

}  // extern "C"
