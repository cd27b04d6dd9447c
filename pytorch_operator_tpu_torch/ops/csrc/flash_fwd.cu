// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_fwd_kernel` of
// pytorch_operator_tpu/ops/flash_attention.py (launched by `_flash_fwd_call`):
// causal and/or kv_len-masked softmax(q k^T * scale) v with an online softmax
// over K tiles, dead-tile skipping, GQA by reading K/V of kv head h / G in
// place, and lse = m + log(l) per query row.
//
// What bounds it. At the training shape (B=4, S=4096, H=8, KH=4, D=128, bf16,
// causal) the two products over the 33.6 M live (row, col) pairs of each of
// the 32 heads are 137.5 GFLOP, 0.139 ms at 989 TFLOP/s, against 34 MB of
// q, k, v, o and lse (0.01 ms at 3.35 TB/s): bound by operations. At the
// generate prefill shape (B=8, S=512) the bytes bound it (7.5 us against
// 4.4 us of products). The [S, S] score matrix never leaves the SM.
//
// Design (bf16), on the Hopper main loop of flash_sm90.cuh:
// - One CTA of three warpgroups per (b*H + h, 128-row query tile), the
//   heaviest causal tiles launched first. The producer warpgroup's elected
//   thread loads the Q tile once and streams K and V tiles of BN = 128 keys
//   through a ring of 2 (D 128) or 3 (D 64) stages by TMA; the two consumer
//   warpgroups own 64 query rows each.
// - s = q k^T by wgmma m64n128k16 (Q and K from shared memory, K-major);
//   o += p v by wgmma m64nDk16 with p cast to bf16 straight from the score
//   accumulator (the accumulator layout is the register-A layout), v read
//   MN-major with the transpose bit. Products are bf16 with f32 accumulation
//   and p is rounded to bf16 before p v while l sums the f32 p, as the TPU
//   kernel rounds.
// - Online softmax in f32 on the accumulator fragments, in base 2 with
//   scale * log2(e) folded into the scores; lse is written in natural log.
// - The mask (_mask_scores: keep col <= row when causal and col < kv_len,
//   masked scores -1e30) is evaluated only on a tile that crosses the
//   diagonal or kv_len.
// - S padded to 64 by the wrapper: the last query tile may hold 64 rows past
//   S; TMA zero-fills them and the epilogue stores only rows < S.
//
// f32: a scalar kernel (no TF32), one warp per group of query rows, one lane
// per key of the tile for the scores, D/32 output columns per lane.
//
// q, k, v, o are addressed through [B, S, heads, D] strides, so the wrapper
// needs no transpose; lse is written as [B*H, S] f32.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see ../_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr float kNeg = sm90::kNeg;

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

// ------------------------------------------------------------------ bf16

constexpr int BM = 128;  // query rows per CTA: two consumer warpgroups x 64
constexpr int BN = 128;  // keys per tile

template <int D>
struct FwdSmem {
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr uint32_t kQ = BM * D * 2, kTile = BN * D * 2;
  static constexpr uint32_t kK = kQ, kV = kK + kStages * kTile, kBars = kV + kStages * kTile;
  // barriers: Q, full[kStages], empty[kStages]; 1024 bytes of alignment slack
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params p) {
  using L = FwdSmem<D>;
  constexpr int STAGES = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_bar = base + L::kBars, full = q_bar + 8, empty = full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int m_block = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = m_block * BM;
  const int n_tiles = sm90::live_tiles(p.kv_len, p.causal, q0 + BM, BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, sm90::kConsumerWarps);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_bar, L::kQ);
      sm90::load_tile<D, BM>(&tq, sQ, q_bar, h, q0, b);
      sm90::produce_kv<D, BN, STAGES>(&tk, &tv, sK, sV, full, empty, kvh, b, n_tiles);
    }
  } else {  // consumers: 64 query rows each
    sm90::setmaxnreg_inc<240>();
    const sm90::Lane ln;
    const int row0 = q0 + (wg - 1) * 64;
    const int row_a = row0 + ln.r;
    const uint32_t sQw = sQ + (wg - 1) * 64 * 128;
    const float c = p.scale * sm90::kLog2e;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

    sm90::mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % STAGES;
      const uint32_t tK = sK + stage * L::kTile, tV = sV + stage * L::kTile;
      sm90::mbar_wait(full + 8 * stage, (j / STAGES) & 1);

      // s = q k^T for this warpgroup's 64 rows and the tile's 128 keys.
      float s[BN / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(s, sm90::desc_k_major(sQw, BM, kk), sm90::desc_k_major(tK, BN, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);

      const int k0 = j * BN;
      const bool edge = sm90::edge_tile(k0, BN, row0, p.kv_len, p.causal);
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s[i] * c;
        if (edge && !sm90::keep(row_a + 8 * ((i >> 1) & 1), k0 + ln.col(i), p.kv_len, p.causal))
          x = kNeg;
        s[i] = x;
        if (i & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
      }
      const float mn_a = fmaxf(m_a, sm90::quad_max(mx_a));
      const float mn_b = fmaxf(m_b, sm90::quad_max(mx_b));
      const float alpha_a = sm90::exp2_approx(m_a - mn_a), alpha_b = sm90::exp2_approx(m_b - mn_b);
      float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float e = sm90::exp2_approx(s[i] - ((i & 2) ? mn_b : mn_a));
        s[i] = e;
        if (i & 2) ls_b += e; else ls_a += e;
      }
      l_a = l_a * alpha_a + sm90::quad_sum(ls_a);
      l_b = l_b * alpha_b + sm90::quad_sum(ls_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;

      // o += p v, p cast to bf16 straight from the score registers.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) sm90::acc_to_a(pa[kk], s, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::wgmma_rs<1>(o, pa[kk], sm90::desc_mn_major(tV, BN, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      __syncwarp();
      if (ln.lane == 0) sm90::mbar_arrive(empty + 8 * stage);
    }

    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
    const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= p.S) continue;
      const float inv = half ? inv_b : inv_a;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(O + (long long)row * p.o_ss + jj * 8 + 2 * ln.t) =
            __floats2bfloat162_rn(o[4 * jj + 2 * half] * inv, o[4 * jj + 2 * half + 1] * inv);
      if (ln.t == 0)
        p.lse[(long long)bh * p.S + row] = (half ? m_b : m_a) * sm90::kLn2 + logf(half ? l_b : l_a);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  const int KH = p.H / p.G;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_tile_map(&tq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, BM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tk, p.k, B, p.S, KH, D, p.k_sb, p.k_ss, p.k_sh, BN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tv, p.v, B, p.S, KH, D, p.v_sb, p.v_ss, p.v_sh, BN);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<D>::kBytes;
  static std::atomic<uint64_t> smem_set{0};
  err = sm90::set_smem_once(smem_set, flash_fwd_sm90<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.S + BM - 1) / BM);
  flash_fwd_sm90<D><<<grid, sm90::kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
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

  const int n_tiles = sm90::live_tiles(p.kv_len, p.causal, q0 + FBM, FBN);
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

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  flash_fwd_f32<D><<<dim3(p.S / FBM, B * p.H), 128, 0, stream>>>(p);
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
  if (S % 64 != 0 || kv_len <= 0 || kv_len > S || G <= 0 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    lse,  q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
           v_ss, v_sh, o_sb, o_ss, o_sh, H,    G,    S,    kv_len, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return (int)launch_bf16<128>(p, B, st);
  if (dtype == 1 && D == 64) return (int)launch_bf16<64>(p, B, st);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(p, B, st);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
