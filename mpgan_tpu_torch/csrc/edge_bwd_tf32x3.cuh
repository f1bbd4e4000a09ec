// The bf16 mode's backward products for the backward kernels (K3:
// edge_aggregate_bwd_bf16.cu, K6: knn_edge_bwd_bf16.cu), for Hopper (sm_90a), on
// the tensor cores as split-TF32. Included by edge_bwd_bf16.cuh only.
//
// Replaces, in the bf16 mode, the FP32 stage's two backward products of a layer:
// da_{l-1} = dz_l W_l^T and dW_l = a_{l-1}^T dz_l. The Pallas kernels compute
// both in float32 (mp_pallas.py:445-460 and :611-623, knn_pallas.py:1347-1362:
// float32 dz and activations, W cast to float32, preferred_element_type float32),
// and so do the plain versions; so must this stage, to the bf16 mode's contract.
//
// Split-TF32. A float32 x is split in registers into hi = tf32(x) (rounded as
// cvt.rna rounds) and lo = tf32(x - hi); x - hi is exact, so x = hi + lo up to
// lo's rounding, 2^-22 of x. A product x y is then taken as lo_x hi_y + hi_x lo_y + hi_x hi_y, each on
// mma.sync m16n8k8 with float32 accumulation, in that order into one
// accumulator: about 2^-21 of each product against FP32's 2^-24, three orders
// below the bf16 mode's 1e-2. The order is the same on every launch, and the
// tensor cores' sums are deterministic, so two launches stay bit-identical.
//   - dW: both operands (the stored float32 activation and dz) are split, three
//     products.
//   - da: W_l holds the float32 values of bf16 weights, which TF32 represents
//     exactly (8 fraction bits of bf16 within TF32's 10): its lo is zero and
//     hi_dz lo_W vanishes. Only dz is split, two products (lo_dz W, hi_dz W),
//     bit for bit the three-product sum. The packer writes W^T once, as float32
//     in fragment order (tf32_elem), half the bytes a hi and a lo slab would take:
//     three k steps a slab buffer at 160 columns, not one.
// The activations are not split ahead into shared memory: at the published
// widths the pass holds 352 floats a row (edge_bwd_common.cuh), no room for a hi
// and a lo copy.
//
// The da product. The 16 warps form the FP32 stage's (rows / 32) x (512 / rows)
// grid: a warp holds two row tiles of 16 rows and every col_groups-th n tile of 8
// columns (NQ of them). The contraction runs in k steps of 8 over dz's columns,
// with the columns of a step permuted so that a lane reads neighbouring features
// (mma column t <- feature 2t, column t + 4 <- feature 2t + 1; the packed W^T
// follows the same order): dz is stored transposed (ldr = 4 mod 32), so lane
// (g, t) reads rows g, g + 8 of features 2t, 2t + 1 from 32 distinct banks. W^T
// comes through the FP32 stage's two slab buffers and cp.async chain, a lane's
// two values of an n tile as one 64-bit load. The epilogue writes dz_{l-1} =
// acc * f'(a_{l-1}) over a_{l-1}, each lane exactly the elements it reads.
//
// The dW contraction. A warp owns a 32 (k) x 32 (m) tile of dW, as the FP32 form
// does, held as the mma's transpose dW^T: A operand dz^T (two m tiles of 16), B
// operand a_{l-1} (four k tiles of 8), the pass's rows the contraction, 8 at a
// time; both operands are the pass's transposed buffers, rows contiguous per
// feature, so lane (g, t) reads row t (and t + 4) of feature g from 32 distinct
// banks. The 32 accumulators a lane holds land in the FP32 form's tile-major
// layout (reduce_wgrads reads it), four of them as one 128-bit store, and go out
// through the same bulk copies; the bias sums are the FP32 form's.
#pragma once

#include "edge_bwd_common.cuh"

namespace {

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's value
// (a finite x), by an integer add and mask. The conversion instruction issues at a
// lower rate: in the dW contraction's form the splits then kept mma.sync at 175
// TFLOP/s of TF32 against 215 with this (scripts/torch_tf32_peak.cu).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Floats of one k step (8 rows) of the packed W^T of a da product with N output
// columns: N padded to 8, two values a lane and n tile.
__host__ __device__ __forceinline__ int tf32_step_floats(int N) { return round_up(N, 8) * 8; }

// Floats of the packed W^T of a [Kc x N] product (Kc the contraction).
__host__ __device__ __forceinline__ long long tf32_packed_floats(int Kc, int N) {
  return (long long)((Kc + 7) / 8) * tf32_step_floats(N);
}

// Element t of the packed W^T of a [Kc x N] product: contraction row k and
// column n, or padding (k >= Kc or n >= N, stored as zero). Per k step s and n
// tile j, lane (g, t) holds W^T[8s + 2t, 8j + g] then W^T[8s + 2t + 1, 8j + g]:
// its B registers b0 and b1 under the step's column permutation.
struct Tf32Elem {
  int k, n;
};
__host__ __device__ __forceinline__ Tf32Elem tf32_elem(long long t, int N) {
  const int per_step = tf32_step_floats(N);
  const int s = (int)(t / per_step), rem = (int)(t - (long long)s * per_step);
  const int j = rem >> 6, lane = (rem >> 1) & 31, q = rem & 1;
  return Tf32Elem{8 * s + 2 * (lane & 3) + q, 8 * j + (lane >> 2)};
}

// One da product over the pass: acc = dz [rows x Kc] @ W^T [Kc x N] (W the packed
// copy, tf32_elem), then C (a_{l-1}, [N x ldr]) = acc * f'(C) in place. Starts
// with a barrier and ends without one; C is not A.
template <int NQ>
__device__ __noinline__ void product_da_tf32(int a_off, int Kc, const float* __restrict__ W,
                                             int N, int slab_off, const PassShape& p,
                                             const Epilogue& e_in) {
  const Epilogue e = e_in;  // a copy: see product_tn
  const float* A = smf(a_off);
  float* slab = smf(slab_off);
  float* C = smf(e.C);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cgs = kWarps / p.row_warps;
  const int r0 = (warp % p.row_warps) * 32 + g, cg = warp / p.row_warps;
  const int ldr = p.ldr, ntiles = (N + 7) / 8;
  const int step = tf32_step_floats(N), steps = (Kc + 7) / 8;
  const int ks = min(steps, p.slab_floats / step);
  const int n_slab = (steps + ks - 1) / ks;
  float acc[2][NQ][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][q][i] = 0.f;

  MPGAN_SUBPHASE_START();
  __syncthreads();
  stage_slab(slab, W, ks * step);
  for (int s = 0; s < n_slab; ++s) {
    const int s0 = s * ks, ks_eff = min(ks, steps - s0);
    __pipeline_wait_prior(0);
    __syncthreads();  // slab s has landed for everyone; the other buffer is free
    if (s + 1 < n_slab)
      stage_slab(slab + ((s + 1) & 1) * p.slab_floats, W + (size_t)(s0 + ks) * step,
                 min(ks, steps - s0 - ks) * step);
    MPGAN_SUBPHASE(kPhaseProdWait);
    const float* wst = slab + (s & 1) * p.slab_floats + lane * 2;
    for (int kk = 0; kk < ks_eff; ++kk, wst += step) {
      const int k = (s0 + kk) * 8 + 2 * t;
      float v[2][4];  // row tile h: (g, k), (g + 8, k), (g, k + 1), (g + 8, k + 1)
      if ((s0 + kk) * 8 + 8 <= Kc) {
        const float* ap = A + (size_t)k * ldr + r0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h][0] = ap[16 * h], v[h][1] = ap[16 * h + 8];
          v[h][2] = ap[ldr + 16 * h], v[h][3] = ap[ldr + 16 * h + 8];
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const float* ap = A + (size_t)(k + d) * ldr + r0 + 16 * h;
            v[h][2 * d] = k + d < Kc ? ap[0] : 0.f;
            v[h][2 * d + 1] = k + d < Kc ? ap[8] : 0.f;
          }
      }
      unsigned hi[2][4], lo[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[h][i], hi[h][i], lo[h][i]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = cg + cgs * q;
        if (j < ntiles) {
          const uint2 b = *reinterpret_cast<const uint2*>(wst + (size_t)j * 64);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_tf32(acc[h][q], lo[h], b.x, b.y);
            mma_tf32(acc[h][q], hi[h], b.x, b.y);
          }
        }
      }
    }
    MPGAN_SUBPHASE(kPhaseProdLoop);
  }

#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int c = 8 * (cg + cgs * q) + 2 * t + d;
      if (c >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* at = C + (size_t)c * ldr + r0 + 16 * h;  // rows g and g + 8 of row tile h
        at[0] = acc[h][q][d] * dact(at[0], e.alpha, e.drop_on, e.drop.mult);
        at[8] = acc[h][q][2 + d] * dact(at[8], e.alpha, e.drop_on, e.drop.mult);
      }
    }
  MPGAN_SUBPHASE(kPhaseProdEpi);
}

// The da product at the n tiles a warp needs, NQ = ceil(ceil(N / 8) / col
// groups) rounded up to one of the instantiated counts (N <= kMaxWidth: at most
// 8 at 128 rows).
__device__ void product_da_tf32_at(int A, int Kc, const float* W, int N, int slab,
                                   const PassShape& p, const Epilogue& e) {
  const int nq = ((N + 7) / 8 + kWarps / p.row_warps - 1) / (kWarps / p.row_warps);
#define MPGAN_TF32_CASE(NQ) \
  if (nq <= NQ) return product_da_tf32<NQ>(A, Kc, W, N, slab, p, e);
  MPGAN_TF32_CASE(1)
  MPGAN_TF32_CASE(2)
  MPGAN_TF32_CASE(3)
  MPGAN_TF32_CASE(4)
  MPGAN_TF32_CASE(5)
  MPGAN_TF32_CASE(6)
  MPGAN_TF32_CASE(8)
#undef MPGAN_TF32_CASE
}

template <typename T>
__device__ void product_da_bf16(int A, int M, const float* W, int K, int slab,
                                const PassShape& p, const Epilogue& e) {
  product_da_tf32_at(A, M, W, K, slab, p, e);
}

// dW[K x M] (+)= A^T D over `rows` rows as split-TF32 (see the head of this file),
// A [K x lda] and D [M x lda] stored transposed in shared memory; `first`
// overwrites the CTA's partial instead of adding to it. The tiles, their staging
// through the warp's 2 KB of the slab buffers, the bulk copies and their waits
// are weight_grad's (edge_bwd_common.cuh), and so are the bias sums.
__device__ __noinline__ void weight_grad_tf32(int a_off, int d_off_, int lda, int rows, int K,
                                              int M, float* __restrict__ tiles,
                                              float* __restrict__ db, int slab_off,
                                              bool first) {
  const float* A = smf(a_off);
  const float* D = smf(d_off_);
  float* stage = smf(slab_off) + (threadIdx.x >> 5) * kPartFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nkb = (K + kTileK - 1) / kTileK, nmb = (M + kTileM - 1) / kTileM;
  if (lane == 0) bulk_wait_done();  // see weight_grad
  for (int wb = warp; wb < nkb * nmb; wb += kWarps) {
    const int k0 = (wb / nmb) * kTileK + g, m0 = (wb % nmb) * kTileM + g;
    // rows beyond K or M are read clamped; their sums land in the tile's padding
    int d_off[2][2], a_off[4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) d_off[mt][h] = min(m0 + 16 * mt + 8 * h, M - 1) * lda + t;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) a_off[nt] = min(k0 + 8 * nt, K - 1) * lda + t;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
    for (int r = 0; r < rows; r += 8) {
      unsigned dhi[2][4], dlo[2][4], ahi[4][2], alo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(D[d_off[mt][0] + r], dhi[mt][0], dlo[mt][0]);
        split_tf32(D[d_off[mt][1] + r], dhi[mt][1], dlo[mt][1]);
        split_tf32(D[d_off[mt][0] + r + 4], dhi[mt][2], dlo[mt][2]);
        split_tf32(D[d_off[mt][1] + r + 4], dhi[mt][3], dlo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(A[a_off[nt] + r], ahi[nt][0], alo[nt][0]);
        split_tf32(A[a_off[nt] + r + 4], ahi[nt][1], alo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], dlo[mt], ahi[nt][0], ahi[nt][1]);
          mma_tf32(acc[mt][nt], dhi[mt], alo[nt][0], alo[nt][1]);
          mma_tf32(acc[mt][nt], dhi[mt], ahi[nt][0], ahi[nt][1]);
        }
    }
    // accumulator (mt, nt, 2h + d) is dW[k0 - g + 8 nt + 2t + d][m0 - g + 16 mt + 8h]:
    // in the tile-major layout (reduce_wgrads) block nt / 2, lane (2t + d) % 4 * 8 +
    // g, row group 2 (nt % 2) + t / 2, column group 2 mt + h
#pragma unroll
    for (int part = 0; part < kTileParts; ++part) {
      if (lane == 0) bulk_wait_read();  // the block before this one has left the buffer
      __syncwarp();
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int nt = 2 * part + n2;
          const int at = (((2 * t + d) & 3) * 8 + g) * 16 + (2 * n2 + (t >> 1)) * 4;
          *reinterpret_cast<float4*>(stage + at) = make_float4(
              acc[0][nt][d], acc[0][nt][2 + d], acc[1][nt][d], acc[1][nt][2 + d]);
        }
      fence_for_bulk();
      __syncwarp();
      if (lane == 0)
        bulk_to_global(tiles + ((size_t)wb * kTileParts + part) * kPartFloats, stage,
                       kPartFloats * (int)sizeof(float), !first);
    }
  }
  if (lane == 0) bulk_wait_read();  // the slab buffers go back to the products
  bias_grad(D, lda, rows, M, db, first);
}

template <typename T>
__device__ void weight_grad_bf16(int a_off, int d_off, int lda, int rows, int K, int M,
                                 float* tiles, float* db, int slab_off, bool first) {
  weight_grad_tf32(a_off, d_off, lda, rows, K, M, tiles, db, slab_off, first);
}

}  // namespace
