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
// What bounds it: 2 * (c + 1) FLOP per (receiver, sender) pair against 8 bytes per
// selected edge written: at n = 150, c = 32, k = 20 about 1.5 MFLOP and 24 KB per
// jet, microseconds at any batch this model runs. Its keys are not products the
// FMA units can fuse (every product and sum is rounded on its own, for equal
// keys), and keeping the k + 1 smallest takes 2 (k + 1) integer min/max a key, so
// what shows is the instruction issue of those: about 66 rounded operations and
// 42 min/max a pair. A CTA takes one jet (receivers in groups of at most one a
// thread): the jet's senders are staged once, transposed, and each receiver's
// threads keep their sorted lists in registers (knn_stages.cuh: knn_search_stage).
//
// The bf16 mode (mpgan_knn_search_bf16: knn_select / knn_select_nm called with
// bf16 x, as StepConfig.bf16 calls them on the split route) is the same kernel
// on bf16 xs and xf, which the staging and the receivers' rows widen to float32
// as they read them (knn_pallas.py:58-59): the keys, idx and the float32
// distances are those of the inputs' float32 values.

#include "knn_stages.cuh"

namespace {

// grid = (batch, receiver groups); dynamic shared memory: the search's scratch. T:
// the element type of xs and xf (float, or bf16 in the bf16 mode).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    knn_search_kernel(const T* __restrict__ xs, const T* __restrict__ xf,
                      int* __restrict__ idx_out, float* __restrict__ dists_out, int n, int c,
                      int k, int self_loops, int want_dists, int key_bits, int group) {
  const int g0 = blockIdx.y * group;
  PhaseClock clock;
  MPGAN_PHASE_START(clock);
  knn_search_stage<T>(xs, xf, idx_out, dists_out, blockIdx.x, g0, min(group, n - g0), n, c, k,
                      self_loops, want_dists, key_bits, 0, -1, -1);
  MPGAN_PHASE(clock, kPhaseSearch);
}

template <typename T>
int launch_search(const T* xs, const T* xf, int* idx_out, float* dists_out, int batch, int n,
                  int c, int k, int self_loops, int want_dists, void* stream) {
  if (batch < 1 || n < 1 || n > (1 << 22) || c < 1 || c > kMaxWidth || idx_out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k + (self_loops ? 0 : 1) > n || (want_dists && dists_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int group = group_size(n);
  const long long floats = search_floats(n, c);
  if (floats * (long long)sizeof(float) > (long long)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(knn_search_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (n + group - 1) / group);
  knn_search_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xs, xf, idx_out, dists_out, n, c, k, self_loops, want_dists, knn_key_bits(n), group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7. xs, xf [batch, n, c]; idx_out int32 [batch, n, k]; dists_out [batch, n, k],
// written with want_dists. Returns a cudaError_t code (0 on success); the launch is
// asynchronous on `stream`.
int mpgan_knn_search(const float* xs, const float* xf, int* idx_out, float* dists_out, int batch,
                     int n, int c, int k, int self_loops, int want_dists, void* stream) {
  return launch_search<float>(xs, xf, idx_out, dists_out, batch, n, c, k, self_loops, want_dists,
                              stream);
}

// K7 in the bf16 mode: xs, xf bf16 [batch, n, c]; idx_out int32 and dists_out float32
// as mpgan_knn_search's.
int mpgan_knn_search_bf16(const bf16* xs, const bf16* xf, int* idx_out, float* dists_out,
                          int batch, int n, int c, int k, int self_loops, int want_dists,
                          void* stream) {
  return launch_search<bf16>(xs, xf, idx_out, dists_out, batch, n, c, k, self_loops, want_dists,
                             stream);
}

#ifdef MPGAN_PHASE_CLOCKS
// Clocks summed per phase (edge_products.cuh: Phase) since the last reset.
int mpgan_knn_search_phase_clocks(unsigned long long* out, int reset) {
  return read_phase_clocks(out, reset);
}
#endif

}  // extern "C"
