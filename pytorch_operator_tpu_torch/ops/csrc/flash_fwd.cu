// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_fwd_kernel` of
// pytorch_operator_tpu/ops/flash_attention.py (launched by `_flash_fwd_call`):
// causal and/or kv_len-masked softmax(q k^T * scale) v with an online softmax
// over K tiles, dead-tile skipping, GQA by reading K/V of kv head h / G in
// place, and lse = m + log(l) per query row.
//
// What bounds it. At the generate slice's prefill shape (B=8, S=512, H=8,
// KH=4, D=128, bf16, causal) one launch reads q, k, v once and writes o and
// lse: about 25 MB, 7.5 us at 3.35 TB/s, while the two matmuls over the
// causal half are about 4.3 GFLOP, 4.4 us at 989 TFLOP/s — so the bound is
// memory. The
// [S, S] score matrix never leaves the SM: each CTA keeps its scores in
// registers and its running max, sum and output accumulator in registers, so
// device traffic stays O(S*D) as the bound assumes.
//
// Design.
// - One CTA per (b*H + h, 64-row query tile); a loop over 64-key tiles
//   inside the CTA replaces the TPU's sequential grid axis. Tiles above the
//   causal diagonal or past kv_len are never loaded.
// - bf16: four warps, 16 query rows each, mma.sync m16n8k16 (bf16 in, f32
//   accumulate) for q k^T and p v. The score accumulator's register layout is
//   the A-operand layout of the next product, so p goes from registers to the
//   tensor core cast to bf16 (as the TPU kernel casts p to v's type) while
//   the row sum l uses the f32 p. Q is staged through shared memory once into
//   registers; K and V tiles then reuse that shared memory.
// - f32: a scalar kernel (no TF32), one warp per group of query rows, one
//   lane per key of the tile for the scores, D/32 output columns per lane.
// - Masking follows _mask_scores exactly: keep col <= row (causal) and
//   col < kv_len, masked scores are -1e30 so exp underflows to 0.
// - q, k, v, o are addressed through [B, S, heads, D] strides, so the
//   wrapper needs no transpose; lse is written as [B*H, S] f32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see ../_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, G, S, kv_len, causal;
  float scale;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 t;
  t.x = lo;
  t.y = hi;
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Number of K tiles of width bn that hold a live column for query rows
// [q0, q0 + bm): the causal diagonal and kv_len bound the walk (_live_block).
__device__ __forceinline__ int live_tiles(const Params& p, int q0, int bm, int bn) {
  int end = p.kv_len;
  if (p.causal) end = min(end, q0 + bm);
  return (end + bn - 1) / bn;
}

// ------------------------------------------------------------------ bf16

constexpr int BM = 64;  // query rows per CTA: 4 warps x 16
constexpr int BN = 64;  // keys per tile

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int LD = D + 8;  // padded smem row (elements), 16-byte multiple
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 smem[2 * BN * LD];
  __nv_bfloat16* sK = smem;
  __nv_bfloat16* sV = smem + BN * LD;
  __nv_bfloat16* sQ = smem;  // aliases sK: Q lives in registers after staging

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int c = tid; c < BM * CPR; c += blockDim.x) {
    const int r = c / CPR, cc = c % CPR;
    *reinterpret_cast<uint4*>(sQ + r * LD + cc * 8) =
        *reinterpret_cast<const uint4*>(Q + (long long)(q0 + r) * p.q_ss + cc * 8);
  }
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = sQ + kk * 16 + t * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + r0 * LD);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + r0 * LD + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int row_a = q0 + r0, row_b = row_a + 8;

  const int n_tiles = live_tiles(p, q0, BM, BN);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile (or the Q staging) is consumed
    for (int c = tid; c < BN * CPR; c += blockDim.x) {
      const int r = c / CPR, cc = c % CPR;
      *reinterpret_cast<uint4*>(sK + r * LD + cc * 8) =
          *reinterpret_cast<const uint4*>(K + (long long)(k0 + r) * p.k_ss + cc * 8);
      *reinterpret_cast<uint4*>(sV + r * LD + cc * 8) =
          *reinterpret_cast<const uint4*>(V + (long long)(k0 + r) * p.v_ss + cc * 8);
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kb = sK + (nt * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    float tmax0 = kNeg, tmax1 = kNeg;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool keep = col < p.kv_len && (!p.causal || col <= row);
        s[nt][e] = keep ? s[nt][e] * p.scale : kNeg;
      }
      tmax0 = fmaxf(tmax0, fmaxf(s[nt][0], s[nt][1]));
      tmax1 = fmaxf(tmax1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(tmax0));
    const float mn1 = fmaxf(m1, quad_max(tmax1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ls0 += s[nt][0] + s[nt][1];
      ls1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + quad_sum(ls0);
    l1 = l1 * alpha1 + quad_sum(ls1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += p v, p cast to bf16 straight from the score registers.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vb = sV + (kk * 16 + t * 2) * LD + dt * 8 + g;
        mma_bf16(acc[dt], a, pack_bf16(vb[0], vb[LD]), pack_bf16(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    *reinterpret_cast<__nv_bfloat162*>(O + (long long)row_a * p.o_ss + col) =
        __floats2bfloat162_rn(acc[dt][0] / l0, acc[dt][1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(O + (long long)row_b * p.o_ss + col) =
        __floats2bfloat162_rn(acc[dt][2] / l1, acc[dt][3] / l1);
  }
  if (t == 0) {
    p.lse[(long long)bh * p.S + row_a] = m0 + logf(l0);
    p.lse[(long long)bh * p.S + row_b] = m1 + logf(l1);
  }
}

// ------------------------------------------------------------------- f32

constexpr int FBM = 16;  // query rows per CTA: 4 warps x 4 rows
constexpr int FBN = 32;  // keys per tile: one per lane

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_f32(Params p) {
  constexpr int LD = D + 1;  // odd stride: lanes reading a column hit distinct banks
  constexpr int RPW = FBM / 4;
  constexpr int CPL = D / 32;
  __shared__ float sQ[FBM * LD];
  __shared__ float sK[FBN * LD];
  __shared__ float sV[FBN * LD];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * FBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < FBM * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    sQ[r * LD + c] = Q[(long long)(q0 + r) * p.q_ss + c];
  }

  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[rr][c] = 0.f;
  }

  const int n_tiles = live_tiles(p, q0, FBM, FBN);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FBN;
    __syncthreads();
    for (int i = tid; i < FBN * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      sK[r * LD + c] = K[(long long)(k0 + r) * p.k_ss + c];
      sV[r * LD + c] = V[(long long)(k0 + r) * p.v_ss + c];
    }
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, row = q0 + r;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += sQ[r * LD + d] * sK[lane * LD + d];
      const bool keep = col < p.kv_len && (!p.causal || col <= row);
      s = keep ? s * p.scale : kNeg;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - mn);
      const float pj = expf(s - mn);
      float ps = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = mn;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[rr][c] *= alpha;
      for (int jj = 0; jj < FBN; ++jj) {
        const float pk = __shfl_sync(0xffffffffu, pj, jj);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[rr][c] += pk * sV[jj * LD + lane + 32 * c];
      }
    }
  }

  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
#pragma unroll
    for (int c = 0; c < CPL; ++c) O[(long long)row * p.o_ss + lane + 32 * c] = acc[rr][c] / l[rr];
    if (lane == 0) p.lse[(long long)bh * p.S + row] = m[rr] + logf(l[rr]);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int tile, const Params& p, int B, cudaStream_t stream) {
  dim3 grid(p.S / tile, B * p.H);
  kernel<<<grid, 128, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D must be 64 or 128 and S a multiple of
// 64; kv_len = S means no length mask. Strides are in elements, for
// [B, S, heads, D] tensors whose last dimension is contiguous. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported shape).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         int B, int H, int G, int S, int D, int kv_len, int causal,
                         float scale, int dtype, void* stream) {
  if (S % BM != 0 || kv_len <= 0 || kv_len > S || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    lse,  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
           v_ss, v_sh, o_sb, o_ss, o_sh, H,    G,    S,    kv_len, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return (int)launch(flash_fwd_bf16<128>, BM, p, B, st);
  if (dtype == 1 && D == 64) return (int)launch(flash_fwd_bf16<64>, BM, p, B, st);
  if (dtype == 0 && D == 128) return (int)launch(flash_fwd_f32<128>, FBM, p, B, st);
  if (dtype == 0 && D == 64) return (int)launch(flash_fwd_f32<64>, FBM, p, B, st);
  return (int)cudaErrorInvalidValue;
}
