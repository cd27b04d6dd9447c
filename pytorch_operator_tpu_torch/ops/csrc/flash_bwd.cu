// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` of
// pytorch_operator_tpu/ops/flash_attention.py (launched by `_flash_bwd_call`).
// Both recompute p = exp(s - lse) from the forward's per-row lse instead of
// reading a saved [S, S] matrix, with s = q k^T * scale masked exactly as the
// forward masks it (_mask_scores: col <= row when causal, col < kv_len,
// masked scores -1e30), and dead tiles skipped as _live_block skips them.
//
//   flash_bwd_dq:  dq  = scale * sum_j ds_j k_j,     ds = p * (dp - delta),
//                  dp  = do v^T,                      one walk over live K tiles
//   flash_bwd_dkv: dv  = sum_i p_i^T do_i,
//                  dk  = scale * sum_i ds_i^T q_i,    one walk over live Q tiles
//
// delta = rowsum(do * o) is computed by the caller (as XLA computes it outside
// the TPU kernels) and passed in as [B*H, S] f32 beside lse.
//
// What bounds it. At the training shape (B=4, S=4096, H=8, KH=4, D=128, bf16,
// causal) the live (row, col) pairs are 268.5 M: dq does three products over
// them (q k^T, do v^T, ds k; 6*D flops a pair, about 206 GFLOP, 0.21 ms at
// the H100 SXM's published 989 TFLOP/s) and dkv four (k q^T, v do^T, p^T do,
// ds^T q; about 275 GFLOP, 0.28 ms), against 100-170 MB of q/k/v/do/lse/delta
// in and gradients out (0.03-0.05 ms at its 3.35 TB/s). So both are bound by
// operations: the design keeps every product on wgmma (the only route to
// Hopper's full tensor-core rate), feeds it by TMA so that loads overlap the
// products, evaluates the mask only on the tiles that need it, and keeps
// every [S, S] intermediate in registers.
//
// Design.
// - bf16, dq: the forward's Hopper main loop (flash_sm90.cuh). One CTA of
//   three warpgroups per (b*H + h, 128-row query tile), heaviest causal tiles
//   first: the producer's elected thread loads the Q and dO tiles once and
//   streams K and V tiles of BN = 64 keys through a 3-stage TMA ring; each
//   consumer warpgroup owns 64 rows. s = q k^T and dp = do v^T by wgmma
//   m64n64k16 from shared memory (K-major); p = exp2(s * scale * log2(e) -
//   lse * log2(e)), ds = p * (dp - delta) in the accumulator registers; dq +=
//   ds k by wgmma m64nDk16 with ds cast to bf16 from the registers and k read
//   MN-major. BN = 64 keeps a thread at 32 + 32 + D/2 f32 accumulators. The
//   mask is evaluated only on tiles that cross the diagonal or kv_len.
// - bf16, dkv: the same main loop with the roles of queries and keys
//   swapped. One CTA of three warpgroups per (b*KH + kv head, 128-key tile),
//   the lowest (under causal the heaviest) key tiles first: the producer
//   loads the K and V tiles once and streams the walk's 64-row Q and dO
//   tiles, each with its 64 lse and delta values (1-D bulk copies on the same
//   barrier), through a 3-stage TMA ring. The walk is the G query heads of
//   the kv head and, in each, the live query tiles (under causal from the one
//   that holds the tile's first key), so GQA's group sum happens in the
//   kernel: dk and dv stay in f32 registers over all G heads and are rounded
//   once, with no per-query-head [B*H, S, D] intermediate and no atomics, so
//   the result is deterministic. (The TPU writes per-query-head dk/dv in bf16
//   and sums the G heads outside; the plain version sums in f32 as here.)
//   Each consumer warpgroup owns 64 keys and works on transposed scores:
//   s^T = k q^T and dp^T = v do^T by wgmma m64n64k16 (K and V rows as A, the
//   Q and dO tiles as B, all K-major), p^T and ds^T in the accumulator
//   registers with lse and delta indexed by the column, then dv += p^T do
//   and dk += ds^T q by wgmma m64nDk16 with p^T and ds^T cast to bf16 from
//   the registers (the accumulator layout is the register-A layout) and do,
//   q read MN-major. A thread holds dk and dv (2 x D/2 f32) and s^T, dp^T
//   (2 x 32). Every wgmma is issued on every tile: where the causal diagonal
//   leaves the second warpgroup's keys wholly masked, its p^T is 0.
// - Rounding follows the TPU kernels: products in bf16 with f32 accumulation,
//   softmax math in f32, ds cast to bf16 before ds k / ds^T q, p cast to bf16
//   before p^T do.
// - S = 64 mod 128: TMA zero-fills the rows past S of the last query (dq) or
//   key (dkv) tile, and the epilogue stores only rows below S.
// - f32: scalar kernels (no TF32), the forward's f32 scheme. dq: a warp per
//   4 query rows, one lane per key of a 32-key tile. dkv: a warp per 4 keys,
//   one lane per query of a 32-row query tile; dk and dv are D/32 columns a
//   lane.
// - q, k, v, do, dq, dk, dv are addressed through [B, S, heads, D] strides;
//   lse and delta are [B*H, S] f32.
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
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int H, G, S, kv_len, causal;
  float scale;
};

__device__ __forceinline__ bool keep(const Params& p, int row, int col) {
  return col < p.kv_len && (!p.causal || col <= row);
}

// ------------------------------------------------------------------ bf16

constexpr int QM = 128;  // dq: query rows per CTA, two consumer warpgroups x 64
constexpr int KN = 64;   // dq: keys per ring tile
constexpr int KM = 128;  // dkv: keys per CTA, two consumer warpgroups x 64
constexpr int QN = 64;   // dkv: query rows per ring tile; the unit of S

template <int D>
struct DqSmem {
  static constexpr int kStages = 3;
  static constexpr uint32_t kQ = QM * D * 2, kTile = KN * D * 2;
  static constexpr uint32_t kDO = kQ, kK = 2 * kQ, kV = kK + kStages * kTile;
  static constexpr uint32_t kBars = kV + kStages * kTile;
  // barriers: Q + dO, full[kStages], empty[kStages]; 1024 bytes of alignment slack
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = DqSmem<D>;
  constexpr int STAGES = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sDO = base + L::kDO, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_bar = base + L::kBars, full = q_bar + 8, empty = full + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int m_block = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = m_block * QM;
  const int n_tiles = sm90::live_tiles(p.kv_len, p.causal, q0 + QM, KN);
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
      sm90::mbar_expect_tx(q_bar, 2 * L::kQ);
      sm90::load_tile<D, QM>(&tq, sQ, q_bar, h, q0, b);
      sm90::load_tile<D, QM>(&tdo, sDO, q_bar, h, q0, b);
      sm90::produce_kv<D, KN, STAGES>(&tk, &tv, sK, sV, full, empty, kvh, b, n_tiles);
    }
  } else {  // consumers: 64 query rows each
    sm90::setmaxnreg_inc<240>();
    const sm90::Lane ln;
    const int row0 = q0 + (wg - 1) * 64;
    const int row_a = row0 + ln.r;
    const uint32_t sQw = sQ + (wg - 1) * 64 * 128, sDOw = sDO + (wg - 1) * 64 * 128;
    const float c = p.scale * sm90::kLog2e;
    float lse2[2], dl[2];  // rows row_a and row_a + 8; rows past S carry do = 0
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      const bool in = row < p.S;
      lse2[half] = in ? p.lse[(long long)bh * p.S + row] * sm90::kLog2e : 0.f;
      dl[half] = in ? p.delta[(long long)bh * p.S + row] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    sm90::mbar_wait(q_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % STAGES;
      const uint32_t tK = sK + stage * L::kTile, tV = sV + stage * L::kTile;
      sm90::mbar_wait(full + 8 * stage, (j / STAGES) & 1);

      // s = q k^T and dp = do v^T for this warpgroup's 64 rows and 64 keys.
      float s[KN / 2], dp[KN / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(s, sm90::desc_k_major(sQw, QM, kk), sm90::desc_k_major(tK, KN, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(dp, sm90::desc_k_major(sDOw, QM, kk), sm90::desc_k_major(tV, KN, kk),
                       kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // ds = p * (dp - delta), p = exp(s * scale - lse), written over s.
      const int k0 = j * KN;
      const bool edge = sm90::edge_tile(k0, KN, row0, p.kv_len, p.causal);
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        const int half = (i >> 1) & 1;
        float pv = sm90::exp2_approx(s[i] * c - lse2[half]);
        if (edge && !sm90::keep(row_a + 8 * half, k0 + ln.col(i), p.kv_len, p.causal)) pv = 0.f;
        s[i] = pv * (dp[i] - dl[half]);
      }

      // acc += ds k, ds cast to bf16 straight from the accumulator registers.
      uint32_t da[KN / 16][4];
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) sm90::acc_to_a(da[kk], s, kk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        sm90::wgmma_rs<1>(acc, da[kk], sm90::desc_mn_major(tK, KN, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(acc);
      sm90::fence_regs(da);
      __syncwarp();
      if (ln.lane == 0) sm90::mbar_arrive(empty + 8 * stage);
    }

    __nv_bfloat16* DQ = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= p.S) continue;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(DQ + (long long)row * p.dq_ss + jj * 8 + 2 * ln.t) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * half] * p.scale,
                                  acc[4 * jj + 2 * half + 1] * p.scale);
    }
  }
}

template <int D>
cudaError_t launch_dq_bf16(const Params& p, int B, cudaStream_t stream) {
  const int KH = p.H / p.G;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_tile_map(&tq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, QM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tdo, p.dout, B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, QM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tk, p.k, B, p.S, KH, D, p.k_sb, p.k_ss, p.k_sh, KN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tv, p.v, B, p.S, KH, D, p.v_sb, p.v_ss, p.v_sh, KN);
  if (err != cudaSuccess) return err;
  const size_t smem = DqSmem<D>::kBytes;
  static std::atomic<uint64_t> smem_set{0};
  err = sm90::set_smem_once(smem_set, flash_bwd_dq_sm90<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, (p.S + QM - 1) / QM);
  flash_bwd_dq_sm90<D><<<grid, sm90::kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

template <int D>
struct DkvSmem {
  static constexpr int kStages = 3;
  static constexpr uint32_t kKV = KM * D * 2, kTile = QN * D * 2, kRow = QN * 4;
  static constexpr uint32_t kV = kKV, kQ = 2 * kKV, kDO = kQ + kStages * kTile;
  static constexpr uint32_t kLse = kDO + kStages * kTile, kDelta = kLse + kStages * kRow;
  static constexpr uint32_t kBars = kDelta + kStages * kRow;
  // barriers: K + V, full[kStages], empty[kStages]; 1024 bytes of alignment slack
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, Params p) {
  using L = DkvSmem<D>;
  constexpr int STAGES = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + L::kV, sQ = base + L::kQ, sDO = base + L::kDO;
  const uint32_t sLse = base + L::kLse, sDelta = base + L::kDelta;
  const uint32_t kv_bar = base + L::kBars, full = kv_bar + 8, empty = full + 8 * STAGES;

  const int KH = p.H / p.G;
  const int b = blockIdx.x / KH, kvh = blockIdx.x % KH;
  const int k0 = blockIdx.y * KM;  // causal: the lowest, heaviest key tiles launch first
  // The walk: query tiles i_begin .. n_q - 1 of each of the G query heads of
  // kv head kvh, one flattened sequence. Causal: a tile is live from the one
  // that holds query k0. A key tile wholly past kv_len walks nothing.
  const int n_q = p.S / QN;
  const int i_begin = p.causal ? k0 / QN : 0;
  const int n_items = k0 < p.kv_len ? p.G * (n_q - i_begin) : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
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
      sm90::mbar_expect_tx(kv_bar, 2 * L::kKV);
      sm90::load_tile<D, KM>(&tk, sK, kv_bar, kvh, k0, b);
      sm90::load_tile<D, KM>(&tv, sV, kv_bar, kvh, k0, b);
      int h = kvh * p.G, i = i_begin;
      for (int it = 0; it < n_items; ++it) {
        const int s = it % STAGES;
        const uint32_t bar = full + 8 * s;
        sm90::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // the first round passes at once
        sm90::mbar_expect_tx(bar, 2 * L::kTile + 2 * L::kRow);
        sm90::load_tile<D, QN>(&tq, sQ + s * L::kTile, bar, h, i * QN, b);
        sm90::load_tile<D, QN>(&tdo, sDO + s * L::kTile, bar, h, i * QN, b);
        const long long row = ((long long)b * p.H + h) * p.S + i * QN;
        sm90::bulk_load(sLse + s * L::kRow, p.lse + row, L::kRow, bar);
        sm90::bulk_load(sDelta + s * L::kRow, p.delta + row, L::kRow, bar);
        if (++i == n_q) {
          i = i_begin;
          ++h;
        }
      }
    }
  } else {  // consumers: 64 keys each; accumulator rows are keys, columns queries
    sm90::setmaxnreg_inc<240>();
    const sm90::Lane ln;
    const int kw0 = k0 + (wg - 1) * 64;
    const int key_a = kw0 + ln.r;  // this thread's keys: key_a and key_a + 8
    const uint32_t sKw = sK + (wg - 1) * 64 * 128, sVw = sV + (wg - 1) * 64 * 128;
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sLse - raw));
    const float* delta_s = reinterpret_cast<const float*>(smem_raw + (sDelta - raw));
    const float c = p.scale * sm90::kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    int i = i_begin;
    for (int it = 0; it < n_items; ++it) {
      const int stage = it % STAGES;
      const uint32_t tQ = sQ + stage * L::kTile, tDO = sDO + stage * L::kTile;
      sm90::mbar_wait(full + 8 * stage, (it / STAGES) & 1);

      // s^T = k q^T and dp^T = v do^T for this warpgroup's 64 keys and the
      // tile's 64 queries.
      float st[QN / 2], dpt[QN / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(st, sm90::desc_k_major(sKw, KM, kk), sm90::desc_k_major(tQ, QN, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(dpt, sm90::desc_k_major(sVw, KM, kk), sm90::desc_k_major(tDO, QN, kk),
                       kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // p^T = exp(s^T * scale - lse) over st, ds^T = p^T * (dp^T - delta)
      // over dpt; lse and delta are indexed by the column (the query).
      const int q0 = i * QN;
      const bool edge = sm90::edge_tile(kw0, 64, q0, p.kv_len, p.causal);
      const float* ls = lse_s + stage * QN;
      const float* dls = delta_s + stage * QN;
#pragma unroll
      for (int jj = 0; jj < QN / 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * ln.t);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * jj + 2 * ln.t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * jj + e;
          const float lse = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          float pv = sm90::exp2_approx(st[x] * c - lse * sm90::kLog2e);
          if (edge && !sm90::keep(q0 + ln.col(x), key_a + 8 * (e >> 1), p.kv_len, p.causal))
            pv = 0.f;
          st[x] = pv;
          dpt[x] = pv * (dpt[x] - dl);
        }
      }

      // dv += p^T do, dk += ds^T q: p^T and ds^T cast to bf16 straight from
      // the registers, do and q read MN-major (the queries are the reduction).
      uint32_t pa[QN / 16][4], da[QN / 16][4];
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) {
        sm90::acc_to_a(pa[kk], st, kk);
        sm90::acc_to_a(da[kk], dpt, kk);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        sm90::wgmma_rs<1>(dv, pa[kk], sm90::desc_mn_major(tDO, QN, kk), 1);
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        sm90::wgmma_rs<1>(dk, da[kk], sm90::desc_mn_major(tQ, QN, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
      __syncwarp();
      if (ln.lane == 0) sm90::mbar_arrive(empty + 8 * stage);
      if (++i == n_q) i = i_begin;
    }

    // Keys past S (the second warpgroup's, when S = 64 mod 128) are not stored.
    __nv_bfloat16* DK = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
    __nv_bfloat16* DV = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_a + 8 * half;
      if (key >= p.S) continue;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int x = 4 * jj + 2 * half, col = jj * 8 + 2 * ln.t;
        *reinterpret_cast<__nv_bfloat162*>(DK + (long long)key * p.dk_ss + col) =
            __floats2bfloat162_rn(dk[x] * p.scale, dk[x + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(DV + (long long)key * p.dv_ss + col) =
            __floats2bfloat162_rn(dv[x], dv[x + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& p, int B, cudaStream_t stream) {
  // lse and delta rows arrive by 1-D bulk copies: 16-byte aligned bases.
  if ((reinterpret_cast<uintptr_t>(p.lse) | reinterpret_cast<uintptr_t>(p.delta)) & 15)
    return cudaErrorInvalidValue;
  const int KH = p.H / p.G;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_tile_map(&tq, p.q, B, p.S, p.H, D, p.q_sb, p.q_ss, p.q_sh, QN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tdo, p.dout, B, p.S, p.H, D, p.do_sb, p.do_ss, p.do_sh, QN);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tk, p.k, B, p.S, KH, D, p.k_sb, p.k_ss, p.k_sh, KM);
  if (err == cudaSuccess)
    err = sm90::make_tile_map(&tv, p.v, B, p.S, KH, D, p.v_sb, p.v_ss, p.v_sh, KM);
  if (err != cudaSuccess) return err;
  const size_t smem = DkvSmem<D>::kBytes;
  static std::atomic<uint64_t> smem_set{0};
  err = sm90::set_smem_once(smem_set, flash_bwd_dkv_sm90<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KH, (p.S + KM - 1) / KM);
  flash_bwd_dkv_sm90<D><<<grid, sm90::kThreads, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------- f32

constexpr int FBM = 16;  // dq: query rows per CTA, 4 warps x 4 rows
constexpr int FBN = 32;  // dq: keys per tile, one per lane
constexpr int FKN = 16;  // dkv: keys per CTA, 4 warps x 4 keys
constexpr int FQM = 32;  // dkv: queries per tile, one per lane

__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* src,
                                               long long stride, int row0, int rows, int D) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = src[(long long)(row0 + r) * stride + c];
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 1;  // odd stride: lanes reading a column hit distinct banks
  constexpr int RPW = FBM / 4;
  constexpr int CPL = D / 32;
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sDO = sQ + FBM * LD;
  float* sK = sDO + FBM * LD;
  float* sV = sK + FBN * LD;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * FBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const float* DO = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  stage_rows_f32(sQ, LD, Q, p.q_ss, q0, FBM, D);
  stage_rows_f32(sDO, LD, DO, p.do_ss, q0, FBM, D);

  float lse[RPW], dl[RPW], acc[RPW][CPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
    lse[rr] = p.lse[(long long)bh * p.S + row];
    dl[rr] = p.delta[(long long)bh * p.S + row];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[rr][c] = 0.f;
  }

  int end = p.kv_len;
  if (p.causal) end = min(end, q0 + FBM);
  const int n_tiles = (end + FBN - 1) / FBN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FBN;
    __syncthreads();
    stage_rows_f32(sK, LD, K, p.k_ss, k0, FBN, D);
    stage_rows_f32(sV, LD, V, p.v_ss, k0, FBN, D);
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, row = q0 + r;
      const float s = dot_rows<D>(sQ + r * LD, sK + lane * LD);
      const float dp = dot_rows<D>(sDO + r * LD, sV + lane * LD);
      const float sv = keep(p, row, col) ? s * p.scale : kNeg;
      const float ds = expf(sv - lse[rr]) * (dp - dl[rr]);
      for (int jj = 0; jj < FBN; ++jj) {
        const float dsk = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[rr][c] += dsk * sK[jj * LD + lane + 32 * c];
      }
    }
  }

  float* DQ = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int row = q0 + warp * RPW + rr;
#pragma unroll
    for (int c = 0; c < CPL; ++c) DQ[(long long)row * p.dq_ss + lane + 32 * c] = acc[rr][c] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bwd_dkv_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 1;
  constexpr int KPW = FKN / 4;
  constexpr int CPL = D / 32;
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + FKN * LD;
  float* sQ = sV + FKN * LD;
  float* sDO = sQ + FQM * LD;
  float* sL = sDO + FQM * LD;
  float* sDl = sL + FQM;

  const int KH = p.H / p.G;
  const int b = blockIdx.y / KH, kvh = blockIdx.y % KH;
  const int k0 = blockIdx.x * FKN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage_rows_f32(sK, LD, K, p.k_ss, k0, FKN, D);
  stage_rows_f32(sV, LD, V, p.v_ss, k0, FKN, D);

  float dk[KPW][CPL], dv[KPW][CPL];
#pragma unroll
  for (int kr = 0; kr < KPW; ++kr) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) dk[kr][c] = dv[kr][c] = 0.f;
  }

  if (k0 < p.kv_len) {
    const int i_begin = p.causal ? k0 / FQM : 0;
    const int n_q = p.S / FQM;
    for (int hh = 0; hh < p.G; ++hh) {
      const int h = kvh * p.G + hh;
      const long long bh = (long long)b * p.H + h;
      const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
      const float* DO = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
      for (int i = i_begin; i < n_q; ++i) {
        const int q0 = i * FQM;
        __syncthreads();
        stage_rows_f32(sQ, LD, Q, p.q_ss, q0, FQM, D);
        stage_rows_f32(sDO, LD, DO, p.do_ss, q0, FQM, D);
        if (tid < FQM) {
          sL[tid] = p.lse[bh * p.S + q0 + tid];
          sDl[tid] = p.delta[bh * p.S + q0 + tid];
        }
        __syncthreads();

        const int query = q0 + lane;
#pragma unroll
        for (int kr = 0; kr < KPW; ++kr) {
          const int r = warp * KPW + kr, key = k0 + r;
          const float s = dot_rows<D>(sK + r * LD, sQ + lane * LD);
          const float dp = dot_rows<D>(sV + r * LD, sDO + lane * LD);
          const float sv = keep(p, query, key) ? s * p.scale : kNeg;
          const float pv = expf(sv - sL[lane]);
          const float ds = pv * (dp - sDl[lane]);
          for (int jj = 0; jj < FQM; ++jj) {
            const float pj = __shfl_sync(0xffffffffu, pv, jj);
            const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
            for (int c = 0; c < CPL; ++c) {
              dv[kr][c] += pj * sDO[jj * LD + lane + 32 * c];
              dk[kr][c] += dsj * sQ[jj * LD + lane + 32 * c];
            }
          }
        }
      }
    }
  }

  float* DK = static_cast<float*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  float* DV = static_cast<float*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int kr = 0; kr < KPW; ++kr) {
    const int key = k0 + warp * KPW + kr;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      DK[(long long)key * p.dk_ss + lane + 32 * c] = dk[kr][c] * p.scale;
      DV[(long long)key * p.dv_ss + lane + 32 * c] = dv[kr][c];
    }
  }
}

size_t f32_dq_smem(int D) { return (size_t)(2 * FBM + 2 * FBN) * (D + 1) * 4; }
size_t f32_dkv_smem(int D) { return (size_t)(2 * FKN + 2 * FQM) * (D + 1) * 4 + 2 * FQM * 4; }

// The f32 kernels: 128 threads; above 48 KB a block's shared memory must be
// asked for, once per device and kernel instance.
template <int D, bool DKV>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  const auto kernel = DKV ? flash_bwd_dkv_f32<D> : flash_bwd_dq_f32<D>;
  const size_t smem = DKV ? f32_dkv_smem(D) : f32_dq_smem(D);
  const dim3 grid = DKV ? dim3(p.S / FKN, B * (p.H / p.G)) : dim3(p.S / FBM, B * p.H);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = sm90::set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

bool bad_shape(int S, int G, int H, int kv_len) {
  return S % QN != 0 || kv_len <= 0 || kv_len > S || G <= 0 || H % G != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D must be 64 or 128 and S a multiple of
// 64; kv_len = S means no length mask. Strides are in elements, for
// [B, S, heads, D] tensors whose last dimension is contiguous; lse and delta
// are [B*H, S] f32 (16-byte aligned for the bf16 dkv). Each returns the
// cudaError_t of its launch (cudaErrorInvalidValue for an unsupported shape).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long do_sb, long long do_ss, long long do_sh,
                            long long dq_sb, long long dq_ss, long long dq_sh,
                            int B, int H, int G, int S, int D, int kv_len, int causal,
                            float scale, int dtype, void* stream) {
  if (bad_shape(S, G, H, kv_len)) return (int)cudaErrorInvalidValue;
  Params p{q,     k,     v,     dout,  lse,   delta, dq,    nullptr, nullptr,
           q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,    v_sh,
           do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, 0,     0,       0,
           0,     0,     0,     H,     G,     S,     kv_len, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return (int)launch_dq_bf16<128>(p, B, st);
  if (dtype == 1 && D == 64) return (int)launch_dq_bf16<64>(p, B, st);
  if (dtype == 0 && D == 128) return (int)launch_f32<128, false>(p, B, st);
  if (dtype == 0 && D == 64) return (int)launch_f32<64, false>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long do_sb, long long do_ss, long long do_sh,
                             long long dk_sb, long long dk_ss, long long dk_sh,
                             long long dv_sb, long long dv_ss, long long dv_sh,
                             int B, int H, int G, int S, int D, int kv_len, int causal,
                             float scale, int dtype, void* stream) {
  if (bad_shape(S, G, H, kv_len)) return (int)cudaErrorInvalidValue;
  Params p{q,     k,     v,     dout,  lse,   delta, nullptr, dk,    dv,
           q_sb,  q_ss,  q_sh,  k_sb,  k_ss,  k_sh,  v_sb,    v_ss,  v_sh,
           do_sb, do_ss, do_sh, 0,     0,     0,     dk_sb,   dk_ss, dk_sh,
           dv_sb, dv_ss, dv_sh, H,     G,     S,     kv_len,  causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return (int)launch_dkv_bf16<128>(p, B, st);
  if (dtype == 1 && D == 64) return (int)launch_dkv_bf16<64>(p, B, st);
  if (dtype == 0 && D == 128) return (int)launch_f32<128, true>(p, B, st);
  if (dtype == 0 && D == 64) return (int)launch_f32<64, true>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one bf16 dkv CTA at head width D (0 for another D).
extern "C" long long flash_bwd_dkv_smem(int D) {
  return D == 128 ? (long long)DkvSmem<128>::kBytes
                  : D == 64 ? (long long)DkvSmem<64>::kBytes : 0;
}
