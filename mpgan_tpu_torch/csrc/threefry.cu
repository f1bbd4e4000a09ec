// threefry_draws: every random draw of a plan in one launch -- jax.random's
// default PRNG (threefry2x32, partitionable bits) on the card.
//
// It replaces no Pallas kernel. The JAX package draws inside its jitted step
// from the state's key (noise, loss targets, the GP weight, augmentation,
// dropout key words and edge seeds; mpgan_tpu/training/train_step.py:182, :261),
// and XLA fuses those draws into the step. The port's step and sampler run as
// captured CUDA graphs; this kernel is what lets a graph draw anew at every
// replay from the key in device memory, with no work on the host.
//
// A plan (ops/prng.py: Plan) is an int32 table of rows: distribution, element
// count, output offset, the path of children from the root key (-1: the child
// the batch counter names), two parameters and the row's first block. A block
// takes up to `epb` elements of one row: its thread 0 finds the row (binary
// search on the first blocks) and walks the path once; each thread then hashes
// its elements' counters (0, e). The last block to finish (a ticket counter)
// writes the root's next key over it (child 0, `advance` times) and adds one to
// the batch counter, after every block has read both.
//
// Bound: the output bytes written once (the plan's draws are a few MB at most)
// or the integer operations of the hash (about 100 per element, 20 rounds), on
// a card that retires some 60 Tops of 32-bit integer work; for a step's plan
// (tens of thousands of elements) neither comes near the launch's own cost.
//
// Rounding: uniforms are (f - 1) * (hi - lo) + lo with one rounding, a fused
// multiply-add (__fmaf_rn, what XLA's CPU backend gives), so that they equal
// JAX's bit for bit; normals are sqrt(2) * erf_inv(u) with Giles' polynomial
// (XLA's ErfInv32) on a log1p written out (Cephes' logf), every other product
// and sum rounded apart (__fmul_rn, __fadd_rn: no contraction), so that they
// equal the plain version (ops/prng.py) bit for bit and JAX's within a few ulps.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPath = 12;
enum Dist { KEY = 0, WORDS, EDGE_SEED, UNIFORM, NORMAL, ORDER };
// a row's fields (ops/prng.py: Plan)
constexpr int R_DIST = 0, R_COUNT = 1, R_OFF = 2, R_LEN = 3, R_PATH = 4;
constexpr int R_A = R_PATH + kMaxPath, R_B = R_A + 1, R_BLOCK = R_B + 1;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) { return (v << r) | (v >> (32 - r)); }

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ void child(uint32_t& k0, uint32_t& k1, uint32_t i) {
  uint32_t y0, y1;
  threefry(k0, k1, 0u, i, y0, y1);
  k0 = y0;
  k1 = y1;
}

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, uint32_t e) {
  uint32_t y0, y1;
  threefry(k0, k1, 0u, e, y0, y1);
  return y0 ^ y1;
}

__device__ __forceinline__ float uniform_of(uint32_t bits, float lo, float hi) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;  // exact
  return fmaxf(lo, __fmaf_rn(f, __fsub_rn(hi, lo), lo));
}

// Cephes' logf of a positive normal float: the mantissa in [sqrt(1/2), sqrt(2)),
// a degree-9 polynomial in t = m - 1, the exponent times log(2) in two parts
__device__ __forceinline__ float log_cephes(float x) {
  constexpr float c[9] = {7.0376836292e-2f,  -1.1514610310e-1f, 1.1676998740e-1f,
                          -1.2420140846e-1f, 1.4249322787e-1f,  -1.6668057665e-1f,
                          2.0000714765e-1f,  -2.4999993993e-1f, 3.3333331174e-1f};
  int e;
  const float m = frexpf(x, &e);
  float t;
  if (m < 0.70710677f) {
    e -= 1;
    t = __fsub_rn(__fadd_rn(m, m), 1.0f);
  } else {
    t = __fsub_rn(m, 1.0f);
  }
  const float z = __fmul_rn(t, t);
  float y = c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) y = __fadd_rn(__fmul_rn(y, t), c[i]);
  y = __fmul_rn(__fmul_rn(y, t), z);
  const float fe = static_cast<float>(e);
  y = __fadd_rn(y, __fmul_rn(-2.12194440e-4f, fe));
  y = __fadd_rn(y, __fmul_rn(-0.5f, z));
  return __fadd_rn(__fadd_rn(t, y), __fmul_rn(0.693359375f, fe));
}

// log1p on (-1, 0]: x where 1 + x rounds to 1, else log(1 + x) * (x / ((1 + x) - 1))
__device__ __forceinline__ float log1p_of(float x) {
  const float u = __fadd_rn(1.0f, x);
  if (u == 1.0f) return x;
  return __fmul_rn(log_cephes(u), __fdiv_rn(x, __fsub_rn(u, 1.0f)));
}

__device__ __forceinline__ float erf_inv32(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                        0.00021858087f,  -0.00125372503f, -0.00417768164f, 0.246640727f,
                        1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1p_of(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? lt5[i] : ge5[i], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? copysignf(__int_as_float(0x7F800000), x) : __fmul_rn(p, x);
}

__global__ void __launch_bounds__(kThreads) threefry_draws_kernel(
    uint32_t* key, const int* __restrict__ plan, int rows, int width, int* __restrict__ out,
    int* counter, const int* __restrict__ order, int advance, int bump, unsigned int* done,
    int epb) {
  __shared__ int s_row, s_count;
  __shared__ uint32_t s_key[2];
  if (threadIdx.x == 0) {
    int lo = 0, hi = rows - 1;
    const int b = static_cast<int>(blockIdx.x);
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (plan[mid * width + R_BLOCK] <= b) lo = mid; else hi = mid - 1;
    }
    const int* r = plan + lo * width;
    const int c = counter != nullptr ? *counter : 0;
    uint32_t k0 = key[0], k1 = key[1];
    for (int i = 0; i < r[R_LEN]; ++i) {
      const int p = r[R_PATH + i];
      child(k0, k1, p == -1 ? static_cast<uint32_t>(c) : static_cast<uint32_t>(p));
    }
    s_row = lo;
    s_count = c;
    s_key[0] = k0;
    s_key[1] = k1;
  }
  __syncthreads();
  const int* r = plan + s_row * width;
  const int dist = r[R_DIST], n = r[R_COUNT], off = r[R_OFF];
  const uint32_t k0 = s_key[0], k1 = s_key[1];
  const float fa = __int_as_float(r[R_A]), fb = __int_as_float(r[R_B]);
  const int base = (static_cast<int>(blockIdx.x) - r[R_BLOCK]) * epb;
  const int end = min(base + epb, n);
  for (int e = base + static_cast<int>(threadIdx.x); e < end; e += kThreads) {
    switch (dist) {
      case KEY:
        out[off] = static_cast<int>(k0);
        out[off + 1] = static_cast<int>(k1);
        break;
      case WORDS:
        out[off] = static_cast<int>(k0 * 0xC2B2AE3Du + k1 * 0x27D4EB2Fu);
        break;
      case EDGE_SEED: {
        // randint(fold_in(k, 1), (), 0, 2**30): the low child's bits modulo the
        // span (the high child's term is multiplied by 2**32 mod 2**30 = 0)
        uint32_t a0 = k0, a1 = k1;
        child(a0, a1, 1u);
        child(a0, a1, 1u);
        const uint32_t v = bits_at(a0, a1, 0u) & ((1u << 30) - 1u);
        out[off] = __float2int_rz(__uint2float_rn(v));
        break;
      }
      case UNIFORM:
        out[off + e] = __float_as_int(uniform_of(bits_at(k0, k1, static_cast<uint32_t>(e)), fa, fb));
        break;
      case NORMAL: {
        const float u = uniform_of(bits_at(k0, k1, static_cast<uint32_t>(e)),
                                   __int_as_float(0xBF7FFFFF), 1.0f);
        out[off + e] = __float_as_int(__fmul_rn(__fmul_rn(1.41421354f, erf_inv32(u)), fa));
        break;
      }
      case ORDER:
        out[off + e] = order[static_cast<long long>(s_count) * n + e];
        break;
      default:
        break;
    }
  }
  if (advance > 0 || bump) {
    if (threadIdx.x == 0) {
      __threadfence();  // this block's reads of the key and counter come first
      const unsigned int ticket = atomicAdd(done, 1u);
      if (ticket == gridDim.x - 1) {  // every block has read them
        if (advance > 0) {
          uint32_t a0 = key[0], a1 = key[1];
          for (int i = 0; i < advance; ++i) child(a0, a1, 0u);
          key[0] = a0;
          key[1] = a1;
        }
        if (bump) *counter += 1;
        *done = 0u;  // ready for the next launch
        __threadfence();
      }
    }
  }
}

}  // namespace

extern "C" {

// Draw every row of `plan` (rows x width int32) from `key` (uint32[2]) into
// `out`; `counter` (int32[1]) and `order` (int32 [batches, B]) may be null where
// the plan reads neither. With `advance` > 0 the root's advance-th first child
// is written over `key`, with `bump` one is added to `counter`, both after
// every block has read them (`done`: an unsigned ticket, 0 between launches).
// Returns a cudaError_t code; asynchronous on `stream`.
int mpgan_threefry_draws(void* key, const void* plan, int rows, int width, void* out,
                         void* counter, const void* order, int advance, int bump, void* done,
                         int blocks, int epb, void* stream) {
  if (rows <= 0 || blocks <= 0 || width <= R_BLOCK || epb <= 0 || advance < 0 ||
      ((advance > 0 || bump) && done == nullptr) || (bump && counter == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  threefry_draws_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(key), static_cast<const int*>(plan), rows, width,
      static_cast<int*>(out), static_cast<int*>(counter), static_cast<const int*>(order), advance,
      bump, static_cast<unsigned int*>(done), epb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
