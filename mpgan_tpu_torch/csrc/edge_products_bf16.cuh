// The bf16 mode's product stage for the backward kernels' FP32 passes, for Hopper
// (sm_90a): K3's and K6's recompute (edge_aggregate_bwd_bf16.cu, knn_edge_bwd_bf16.cu)
// on tensor cores. K2, K4, K5 and K8 run the bf16 forward pass of
// edge_fwd_bf16_tiles.cuh on the same mma and fragment order (bf16_elem, pack_bf16x2,
// mma_bf16).
//
// Replaces, in mpgan_tpu/ops/mp_pallas.py, the products of _split_mlp_chain when the
// backward kernel is called with bf16 refs (StepConfig.bf16): each hidden layer's
// input is rounded to bf16 and multiplied by the bf16 weights with float32
// accumulation. Everything around a product stays float32, as in the Pallas kernel:
// the stored activations (K3's weight gradients read them unrounded), the bias,
// LeakyReLU, K1's multiplier.
//
// The stage: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. A pass of
// `rows` pair rows is cut into rows / 16 row tiles; the 16 warps form a (rows /
// 16) x (16 / (rows / 16)) grid, a warp holds one row tile and every
// col_groups-th n tile of 8 columns (NQ of them, NQ a template parameter: at
// most 16 accumulator quads). A fragments are read from the pass's float32
// activations (stored transposed, A[k * ldr + r]: lane (g, t) reads rows g and
// g + 8 at k = 2t, 2t + 1, 2t + 8, 2t + 9, 32 distinct banks since ldr = 4 mod
// 32) and rounded to bf16x2 in registers; that value is the operand the Pallas
// kernel feeds its product. B fragments come from a bf16 copy of W packed in
// fragment order (bf16_elem below: per k step of 16 and n tile of 8, each lane's
// four values together, one 64-bit load), staged in k slabs through the same two
// shared-memory buffers by cp.async as the FP32 stage's (edge_products.cuh).
// K and M are padded with zeros to multiples of 16 and 8 in the packed copy; A
// reads beyond K are zero, so no padding reaches an accumulator.
//
// The epilogue works at the fragment's (row, column): lane (g, t) of row tile
// rt holds rows rt * 16 + g and + 8, columns 8j + 2t and + 1. Hidden layers
// store dropout(leaky(acc + b)) (a dropped element as -0.0f, as the FP32 stage
// stores it: K3's backward reads the slope off it); K3's last layer forms
// dz_L = g * mask / denom * f'(a_L) and each row's sum_h g * a_L over the row's 4
// lanes, then per warp column group.
//
// What bounds it on this card: the flagship's hidden products are 2 x 30 x 30 x
// (96 x 160 + 160 x 192) = 85 MFLOP a jet, which the dense bf16 tensor cores
// would do in 0.09 us; around them the pass keeps the FP32 stage's float32
// a_0 build, K1's hash on every activation, shared-memory epilogues and slab
// barriers, which now dominate. Those are what a faster version (wgmma, bf16
// activation storage) would attack.
#pragma once

#include "edge_products.cuh"

namespace {

// Floats of one k step (16 rows of W) of the packed bf16 copy: M padded to 8,
// 16 bf16 values a column.
__host__ __device__ __forceinline__ int bf16_step_floats(int M) { return round_up(M, 8) * 8; }

// Floats of the packed bf16 copy of a [K x M] matrix.
__host__ __device__ __forceinline__ long long bf16_packed_floats(int K, int M) {
  return (long long)((K + 15) / 16) * bf16_step_floats(M);
}

// Element t (in bf16 units) of the packed bf16 copy of a [K x M] matrix: row k
// and column n of W, or padding (k >= K or n >= M, stored as zero). Per k step
// s and n tile j, lane (g, t) = (lane / 4, lane % 4) holds W[16s + 2t + {0, 1},
// 8j + g] then W[16s + 2t + {8, 9}, 8j + g]: its two B registers.
struct Bf16Elem {
  int k, n;
};
__host__ __device__ __forceinline__ Bf16Elem bf16_elem(long long t, int M) {
  const int per_step = round_up(M, 8) * 16;
  const int s = (int)(t / per_step), rem = (int)(t - (long long)s * per_step);
  const int j = rem >> 7, lane = (rem >> 2) & 31, q = rem & 3;
  return Bf16Elem{16 * s + 2 * (lane & 3) + (q & 1) + ((q >> 1) << 3), 8 * j + (lane >> 2)};
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Warp column groups of a pass: the warps of one row tile.
__host__ __device__ __forceinline__ int bf16_col_groups(int rows) { return kWarps / (rows / 16); }

// One bf16 product over the pass: acc = bf16(A) [rows x K] @ W [K x M], then the
// epilogue (kEpiHidden or kEpiLast). W is the packed bf16 copy (in floats), staged
// slab by slab from the first buffer. Returns the buffer of the slab after its last.
// Starts with a barrier and ends without one; waits for every warp's k loop before
// its epilogue, so C may be A.
template <int NQ, bool kDrop>
__device__ __noinline__ int product_bf16(int a_off, int K, const float* __restrict__ W, int M,
                                         int slab_off, const PassShape& p, const Epilogue& e_in) {
  const Epilogue e = e_in;  // a copy: see product_tn
  const float* A = smf(a_off);
  float* slab = smf(slab_off);
  float* C = smf(e.C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_tiles = p.rows / 16, cgs = kWarps / row_tiles;
  const int rt = warp % row_tiles, cg = warp / row_tiles;
  const int r_lo = rt * 16 + g, r_hi = r_lo + 8;
  const int ldr = p.ldr, ntiles = (M + 7) / 8;
  const int step = bf16_step_floats(M), steps = (K + 15) / 16;
  const int ks = min(steps, p.slab_floats / step);
  const int n_slab = (steps + ks - 1) / ks;
  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;

  MPGAN_SUBPHASE_START();
  __syncthreads();
  stage_slab(slab, W, ks * step);
  for (int s = 0; s < n_slab; ++s) {
    const int s0 = s * ks, ks_eff = min(ks, steps - s0);
    __pipeline_wait_prior(0);
    __syncthreads();
    float* other = slab + ((s + 1) & 1) * p.slab_floats;
    if (s + 1 < n_slab)
      stage_slab(other, W + (size_t)(s0 + ks) * step, min(ks, steps - s0 - ks) * step);
    MPGAN_SUBPHASE(kPhaseProdWait);
    const float* wst = slab + (s & 1) * p.slab_floats + lane * 2;
    for (int kk = 0; kk < ks_eff; ++kk, wst += step) {
      const int kb = (s0 + kk) * 16 + 2 * t;
      float v[8];  // (k, k + 1) at rows lo, hi, then (k + 8, k + 9)
      if ((s0 + kk) * 16 + 16 <= K) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* ap = A + (size_t)(kb + 8 * h) * ldr;
          v[4 * h] = ap[r_lo], v[4 * h + 1] = ap[ldr + r_lo];
          v[4 * h + 2] = ap[r_hi], v[4 * h + 3] = ap[ldr + r_hi];
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int k = kb + 8 * h + d;
            const float* ap = A + (size_t)k * ldr;
            v[4 * h + d] = k < K ? ap[r_lo] : 0.f;
            v[4 * h + 2 + d] = k < K ? ap[r_hi] : 0.f;
          }
      }
      const unsigned a[4] = {pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                             pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = cg + cgs * q;
        if (j < ntiles) {
          const uint2 b = *reinterpret_cast<const uint2*>(wst + (size_t)j * 64);
          mma_bf16(acc[q], a, b);
        }
      }
    }
    MPGAN_SUBPHASE(kPhaseProdLoop);
  }
  const int after = n_slab & 1;
  __syncthreads();  // every warp is done with A

  unsigned id_lo = 0, id_hi = 0;
  if (kDrop) id_lo = smu(e.row.id)[r_lo], id_hi = smu(e.row.id)[r_hi];
  if (e.kind == kEpiHidden) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int c = 8 * (cg + cgs * q) + 2 * t + d;
        if (c >= M) continue;
        const float bc = __ldg(e.bias + c);
        float lo = leaky(acc[q][d] + bc, e.alpha), hi = leaky(acc[q][2 + d] + bc, e.alpha);
        if (kDrop) {
          lo = drop_store(lo, e.drop, id_lo, (unsigned)c, e.salt);
          hi = drop_store(hi, e.drop, id_hi, (unsigned)c, e.salt);
        }
        C[(size_t)c * ldr + r_lo] = lo;
        C[(size_t)c * ldr + r_hi] = hi;
      }
    MPGAN_SUBPHASE(kPhaseProdEpi);
    return after;
  }

  // kEpiLast (K3's recompute): g rows are bf16
  const bf16* gp = rows_as<bf16>(e.g);
  const float gm_lo = smf(e.row.m)[r_lo], gm_hi = smf(e.row.m)[r_hi];
  const int go_lo = max(smi(e.row.g)[r_lo], 0), go_hi = max(smi(e.row.g)[r_hi], 0);
  float ds_lo = 0.f, ds_hi = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int c = 8 * (cg + cgs * q) + 2 * t + d;
      if (c >= M) continue;
      const float bc = __ldg(e.bias + c);
      float lo = leaky(acc[q][d] + bc, e.alpha), hi = leaky(acc[q][2 + d] + bc, e.alpha);
      if (kDrop) {
        lo = drop_store(lo, e.drop, id_lo, (unsigned)c, e.salt);
        hi = drop_store(hi, e.drop, id_hi, (unsigned)c, e.salt);
      }
      const float g_lo = ld_elem(gp + go_lo + c), g_hi = ld_elem(gp + go_hi + c);
      ds_lo = fmaf(g_lo, lo, ds_lo);
      ds_hi = fmaf(g_hi, hi, ds_hi);
      C[(size_t)c * ldr + r_lo] = g_lo * gm_lo * dact(lo, e.alpha, kDrop, e.drop.mult);
      C[(size_t)c * ldr + r_hi] = g_hi * gm_hi * dact(hi, e.alpha, kDrop, e.drop.mult);
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    ds_lo += __shfl_xor_sync(0xffffffffu, ds_lo, o);
    ds_hi += __shfl_xor_sync(0xffffffffu, ds_hi, o);
  }
  if (t == 0) {
    smf(e.part)[cg * ldr + r_lo] = ds_lo;
    smf(e.part)[cg * ldr + r_hi] = ds_hi;
  }
  MPGAN_SUBPHASE(kPhaseProdEpi);
  return after;
}

// The bf16 product at the n tiles a warp needs, NQ = ceil(ceil(M / 8) /
// col_groups) rounded up to one of the instantiated counts.
__device__ int product_bf16_at(int A, int K, const float* W, int M, int slab, const PassShape& p,
                               const Epilogue& e) {
  const int cgs = bf16_col_groups(p.rows);
  const int nq = ((M + 7) / 8 + cgs - 1) / cgs;
#define MPGAN_BF16_CASE(NQ)                                                            \
  if (nq <= NQ)                                                                        \
    return e.drop_on ? product_bf16<NQ, true>(A, K, W, M, slab, p, e)                  \
                     : product_bf16<NQ, false>(A, K, W, M, slab, p, e);
  MPGAN_BF16_CASE(1)
  MPGAN_BF16_CASE(2)
  MPGAN_BF16_CASE(3)
  MPGAN_BF16_CASE(4)
  MPGAN_BF16_CASE(6)
  MPGAN_BF16_CASE(8)
  MPGAN_BF16_CASE(10)
  MPGAN_BF16_CASE(12)
  MPGAN_BF16_CASE(16)
#undef MPGAN_BF16_CASE
  return 0;
}

// The bf16 weight source of a chain layer's row k (fn's first layer: rows k >=
// k0_split from w0_lo).
template <typename T>
__device__ __forceinline__ const T* bf16_row(const Chain& c, int li, int k, int M) {
  const int split = li == 0 ? c.k0_split : c.dim[li];
  return k < split ? rows_as<T>(c.w[li]) + (size_t)k * M
                   : rows_as<T>(c.w0_lo) + (size_t)(k - split) * M;
}

// One layer's share of a packed copy made from bf16 weights, in the bf16 fragment
// order (bf16_elem); its bias converted to float32 at `bias_out`. Element t of every
// job is written by the thread with t = start (mod stride).
template <typename T>
__device__ void pack_layer_bf16(float* __restrict__ out, float* __restrict__ bias_out,
                                const Chain& c, int li, long long start, long long stride) {
  const int K = c.dim[li], M = c.dim[li + 1];
  T* dst = reinterpret_cast<T*>(out);
  const long long total = 2 * bf16_packed_floats(K, M);
  for (long long t = start; t < total; t += stride) {
    const Bf16Elem be = bf16_elem(t, M);
    dst[t] = be.k < K && be.n < M ? bf16_row<T>(c, li, be.k, M)[be.n] : __float2bfloat16_rn(0.f);
  }
  if (bias_out != nullptr)
    for (long long t = start; t < M; t += stride)
      bias_out[t] = __bfloat162float(rows_as<T>(c.b[li])[t]);
}

}  // namespace
