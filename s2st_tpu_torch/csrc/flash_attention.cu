// Fused attention forward for Hopper (sm_90a): softmax(q k^T + mask) v with an
// fp32 online softmax, never writing the (B, H, Tq, Tk) scores to device memory.
//
// Replaces the TPU kernel behind s2st_tpu/nn/attention.py::attend_flash
// (:44-88), the Pallas TPU flash-attention forward that serves the encoder
// self-attention and the teacher-forced decoder's causal self-attention and
// cross-attention. It computes what s2st_tpu/nn/attention.py::attend (:91)
// computes:
//   - q arrives pre-scaled (sm_scale = 1);
//   - the causal mask is ADDED (-1e9 strictly above the diagonal);
//   - key padding REPLACES the score with -1e9 (not -inf), so a row with no
//     valid key averages all Tk values, as `attend` does;
//   - keys past Tk and queries past Tq take no part;
//   - softmax statistics and the output accumulate in fp32; the output is
//     written in the input type (fp32 or bf16).
//
// Bound on the card. q, k, v and o each cross device memory once:
// 4 * B * T * H * D * bytes. At the serving encoder's B=4, T'=250, H=4, D=128
// in bf16 that is 4 MB, about 1.2 us at 3.35 TB/s, against about 0.5 us of
// bf16 tensor-core time for the 4 * B * H * Tq * Tk * D operations: the
// function is memory-bound, and at these sizes a launch and the latency of
// the first loads cost as much as either. At the recipe's batches (B = 60
// and 100) the bytes take 18-31 us and the products 8-13 us; this design
// stays about 3x above the bytes, bound by the rate at which a warp can
// start the instructions around mma.sync (it does not use wgmma, the
// warpgroup product; PERF.md).
//
// Two designs, chosen by the input type:
//
// bf16 (the --fp16 main path): tensor cores. Each warp owns 16 query rows.
// S = Q K^T and O += P V run on mma.sync.m16n8k16 with bf16 operands and
// fp32 accumulators; operands come from shared memory through ldmatrix
// (.trans for V); P stays in registers between the two products (the
// accumulator pair of two 8-key tiles is the A operand of P V), and each
// row's max and sum are reduced over the 4 lanes that hold it, so no score
// tile goes through shared memory. K and V stream in 32-key tiles through
// a 2-stage ring filled with 16-byte cp.async, so the next tile's copy
// overlaps this tile's products (a third stage gained nothing);
// tiles stay bf16, rows padded by 16 bytes (an odd number of 16-byte units
// a row, so each ldmatrix phase hits 8 distinct bank groups). The head_dim
// is a template argument, 16 or 128 (attention_tc.cuh::ksteps_for), so the
// products unroll with no branch between an ldmatrix and its mma; a
// head_dim below it (8, 72) is zero-filled in shared memory. A tile's key
// padding is one 32-bit word in shared memory (a warp ballot), read once
// per tile; a tile with no padded key, inside Tk and not above the warp's
// diagonal skips the masks.
//
// The block shape follows the grid (attention_tc.cuh::tiles_for), which on
// the main path spans B*H = 16 (a served batch of 4 utterances) to 400 (a
// batch of the recipe's size): an SM wants 8 warps or more, two a
// scheduler, to hide each warp's chain of copies, ldmatrix, mma and
// shuffles.
//   - Up to one block of 32 queries an SM: 4 splits of 2 warps share each
//     block (149 KB of shared memory at D = 128). Split i walks the key
//     tiles i, i + 4, ... through its own ring with its own online softmax;
//     the splits' (max, sum, output) are combined in shared memory in a
//     fixed order and written as 16-byte rows.
//   - Up to two: blocks of 64 queries, 2 splits of 4 warps (88 KB).
//   - Beyond, the recipe's batches: blocks of 64 queries and 4 warps, no
//     split (53 KB). 64 queries share each K/V tile; registers (about 166
//     a thread) fit 3 blocks, 12 warps, an SM.
// Each shape was timed against the others at each batch size by
// attention_tiles.py on an H100 (PERF.md). The launcher raises the
// shared-memory limit above 48 KB. Key tiles that cannot carry weight are
// skipped only where that is exact (attention_tc.cuh::live_keys): padded
// tail tiles when the batch row has a valid key (non-causal) or key 0 is
// valid (causal), and, in the causal case with key 0 valid, tiles wholly
// above the query tile's diagonal. A row without a valid key skips
// nothing. The wrapper guarantees 16-byte aligned rows (data pointers and
// batch/time/head strides) for cp.async.
//
// fp32 (the parity paths): the scalar kernel of the first port, one block per
// (b, h, 64-query tile) with scalar fp32 FMAs on the CUDA cores. The tensor
// cores would take fp32 as TF32, with about three decimal digits, which
// cannot hold the 1e-5 agreement the fp32 checks (card against CPU, kernel
// against the plain version) ask for; fp32 sums in another order can.
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), o (B, Tq, H, D), read and
// written through their batch/time/head strides (unit stride over D), so the
// caller needs no transposes. key_padding_mask is (B, Tk) bytes, 1 at pad.
// For training the kernel also writes each row's softmax statistics, fp32
// (B, H, Tq): the running max m and log of the sum l of exp(s - m). They are
// kept apart, not as one log-sum-exp m + log l, because a row with no valid
// key has m = -1e9, where fp32 cannot hold log l beside it (its ulp is 64);
// flash_attention_bwd.cu recomputes the probabilities as exp(s - m - log l).
//
// Plain C interface for ctypes; returns the cudaError_t of the launch.
// row_max and row_logsum may both be null (inference needs no statistics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int kMaxD = 128;        // largest head_dim; head_dim % 8 == 0
constexpr float kNegInf = -1e9f;  // s2st_tpu/nn/attention.py NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const uint8_t* kpm;
  float* row_max;
  float* row_logsum;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long kpm_sb;
  int H, Tq, Tk, D;
  int causal;
};

// ---------------------------------------------------------------- fp32 ----

constexpr int kBlockM = 64;     // queries per block
constexpr int kBlockN = 64;     // keys per tile
constexpr int kThreads = 256;   // 8 warps

// Shared memory, in floats: Q tile and K/V tile with rows padded to D + 1
// (column reads across a warp hit distinct banks), the score/probability tile
// padded to kBlockN + 1, and per-row rescale factors and final sums.
__host__ __device__ inline int smem_floats(int D) {
  return 2 * kBlockM * (D + 1) + kBlockM * (kBlockN + 1) + 2 * kBlockM;
}

__global__ void __launch_bounds__(kThreads, 2) flash_fwd_fp32(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  const int lp = kBlockN + 1;
  float* Qs = smem;
  float* KVs = Qs + kBlockM * ld;
  float* Ps = KVs + kBlockN * ld;
  float* row_scale = Ps + kBlockM * lp;
  float* row_sum = row_scale + kBlockM;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;

  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = q0 + r;
    Qs[r * ld + d] = t < p.Tq ? q[t * p.q_st + d] : 0.f;
  }

  // thread tile: rows ty*4 .. ty*4+3; score columns tx + 16*j; output
  // columns tx + 16*c
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  // running max and sum of the 8 rows this warp owns (replicated over lanes)
  float m_run[8], l_run[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += kBlockN) {
    __syncthreads();  // Q is loaded; the previous tile's V is consumed
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const int t = k0 + r;
      KVs[r * ld + d] = t < p.Tk ? k[t * p.k_st + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = KVs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j];
        if (kj >= p.Tk) {
          x = -INFINITY;  // outside the sequence: no weight at all
        } else {
          if (p.causal && kj > qi) x += kNegInf;
          if (kpm && kpm[kj]) x = kNegInf;
        }
        Ps[(ty * 4 + i) * lp + tx + 16 * j] = x;
      }
    }
    __syncthreads();  // scores written; K no longer needed

    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const int t = k0 + r;
      KVs[r * ld + d] = t < p.Tk ? v[t * p.v_st + d] : 0.f;
    }
    // online softmax: warp w updates rows 8w .. 8w+7, two columns a lane
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      float* prow = Ps + r * lp;
      const float s0 = prow[lane], s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      prow[lane] = p0;
      prow[lane + 32] = p1;
      if (lane == 0) row_scale[r] = alpha;
    }
    __syncthreads();  // probabilities, rescale factors and V are in place

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_scale[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < kBlockN; ++j) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * lp + j];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? KVs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      row_sum[r] = l_run[i];
      const int t = q0 + r;
      if (p.row_max && t < p.Tq) {
        const long long at = static_cast<long long>(blockIdx.y) * p.Tq + t;
        p.row_max[at] = m_run[i];
        p.row_logsum[at] = logf(l_run[i]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = q0 + r;
    if (t >= p.Tq) continue;
    const float inv = 1.f / row_sum[r];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) o[t * p.o_st + col] = acc[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kKeys = 32;    // keys a streamed tile
constexpr int kStages = 2;   // tiles in flight in each split's ring

// Shared bytes of a block of W warps a split and S key splits at padded
// head_dim Dp: the Q tile of 16 W rows; S rings of kStages K and V tiles
// (rows of Dp + 8 bf16); S rings of padding words; each split's per-row
// max and sum; reduction scratch. The splits' partial outputs are combined
// in the K/V space after the loop (it holds them for W <= 4).
__host__ __device__ inline int fwd_smem_bytes(int W, int S, int Dp) {
  return 2 * (16 * W + S * kStages * 2 * kKeys) * (Dp + 8) +
         4 * S * kStages + 2 * 4 * S * 16 * W + 4 * 32;
}

// One block per (b, h, 16 W queries) and S splits of W warps, each warp
// owning 16 query rows: split i takes the key tiles i, i + S, i + 2S, ...
// through its 2-stage ring (the next tile's copy overlaps this tile's
// products) with its own online softmax, and the splits' (max, sum,
// output) are combined at the end in a fixed order.
template <int W, int S, int NK>
__global__ void __launch_bounds__(32 * W * S) flash_fwd_bf16(Params p) {
  using namespace attn_tc;
  using bf16 = __nv_bfloat16;
  static_assert(W <= 4, "the K/V space holds the partial outputs");
  constexpr int kRows = 16 * W;     // queries a block
  constexpr int kSplit = 32 * W;    // threads a split
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Dp = 16 * NK;       // head_dim, zero-filled from D
  constexpr int ld = Dp + 8;
  const int D = p.D;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + kRows * ld;  // [split][stage][K, V][kKeys][ld]
  uint32_t* PM = reinterpret_cast<uint32_t*>(KV + S * kStages * 2 * kKeys *
                                             ld);  // [split][stage]
  float* Ms = reinterpret_cast<float*>(PM + S * kStages);  // [split][row]
  float* Ls = Ms + S * kRows;
  int* red = reinterpret_cast<int*>(Ls + S * kRows);
  float* Cs = reinterpret_cast<float*>(KV);  // then [split][row][Dp]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sp = warp / W;     // this warp's split
  const int rg = warp % W;     // its 16-row group
  const int stid = tid % kSplit;  // thread within the split
  const int q0 = blockIdx.x * kRows;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  auto ring = [&](int st, int kv) {
    return KV + ((sp * kStages + st) * 2 + kv) * kKeys * ld;
  };
  auto load_tile = [&](int j, int st) {  // by the split's threads
    load_rows(ring(st, 0), ld, k, p.k_st, j * kKeys, p.Tk, kKeys, D, stid,
              kSplit);
    load_rows(ring(st, 1), ld, v, p.v_st, j * kKeys, p.Tk, kKeys, D, stid,
              kSplit);
  };

  // Q and each split's first tile are in flight while the block finds the
  // keys it must visit (a split whose first tile turns out to be skipped
  // has loaded it for nothing)
  zero_tail(Qs, ld, kRows + S * kStages * 2 * kKeys, D, Dp, tid,
            kSplit * S);
  load_rows(Qs, ld, q, p.q_st, q0, p.Tq, kRows, D, tid, kSplit * S);
  if (sp * kKeys < p.Tk) load_tile(sp, 0);
  cp_async_commit();
  const bool pad0 = key_padded(kpm, sp * kKeys + lane, p.Tk);
  bool causal_skip;
  int kend = live_keys(kpm, p.Tk, p.causal != 0, &causal_skip, red);
  const uint32_t bits0 = __ballot_sync(0xffffffffu, pad0);
  if (rg == 0 && lane == 0) PM[sp * kStages] = bits0;
  if (causal_skip) kend = min(kend, q0 + kRows);
  const int n_tiles = (kend + kKeys - 1) / kKeys;
  const int n_mine = sp < n_tiles ? (n_tiles - 1 - sp) / S + 1 : 0;
  cp_async_wait<0>();
  __syncthreads();  // Q, the first tiles and their padding bits are in place

  const int g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + rg * 16 + g;  // the lane's rows: row0, row0 + 8
  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    ldsm_x4(qf[kk],
            Qs + (rg * 16 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int i = 0; i < n_mine; ++i) {
    const int j = sp + i * S, st = i % kStages;
    // the next tile's padding bytes are read now and their bits stored
    // after this tile's products, so the read's latency hides behind them
    bool pad_next = false;
    if (i + 1 < n_mine) {
      load_tile(j + S, (i + 1) % kStages);
      pad_next = key_padded(kpm, (j + S) * kKeys + lane, p.Tk);
    }
    cp_async_commit();
    if (i > 0) {
      cp_async_wait<1>();  // tile i landed
      split_sync(1 + sp, kSplit);
    }
    const bf16* Kt = ring(st, 0);
    const bf16* Vt = ring(st, 1);
    const uint32_t pad = PM[sp * kStages + st];
    const int k0 = j * kKeys;

    // S = Q K^T: 4 tiles of 8 keys, (16 rows x 32 keys) a warp
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kKeys / 16; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // masks, skipped (a warp-uniform branch) for a tile of valid keys
    // inside Tk that is not above any of the warp's rows' diagonals
    const bool unmasked = pad == 0 && k0 + kKeys <= p.Tk &&
                          !(p.causal && k0 + kKeys - 1 > q0 + rg * 16);
    if (!unmasked) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tq + (e & 1);
          float x = s[n][e];
          if (k0 + col >= p.Tk) {
            x = -INFINITY;  // outside the sequence: no weight at all
          } else {
            if (p.causal && k0 + col > row0 + (e >> 1) * 8) x += kNegInf;
            if ((pad >> col) & 1u) x = kNegInf;
          }
          s[n][e] = x;
        }
    }
    // the online softmax over the 4 lanes of each row
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2((m_run[r] - mx[r]) * kLog2e);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = fast_exp2((s[n][e] - mx[e >> 1]) * kLog2e);
        s[n][e] = pr;
        l_run[e >> 1] += pr;
      }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the score registers, V through ldmatrix.trans
#pragma unroll
    for (int jj = 0; jj < kKeys / 16; ++jj) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NK; ++n2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + (jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              ld + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
    if (i + 1 < n_mine) {
      const uint32_t bits = __ballot_sync(0xffffffffu, pad_next);
      if (rg == 0 && lane == 0) PM[sp * kStages + (i + 1) % kStages] = bits;
    }
    split_sync(1 + sp, kSplit);  // this stage is consumed before refilling
  }

  // combine the splits: each writes its rows' max, sum and unnormalised
  // output; then every thread takes 8 columns of a row, adds the splits'
  // shares in split order and stores them as one 16-byte write
  __syncthreads();  // every ring is consumed: Cs may overwrite it
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = rg * 16 + g + r * 8;
    if (tq == 0) {
      Ms[sp * kRows + row] = m_run[r];
      Ls[sp * kRows + row] = l;
    }
    float* crow = Cs + (sp * kRows + row) * Dp;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      *reinterpret_cast<float2*>(crow + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * 16; idx += kSplit * S) {
    const int row = idx >> 4, c = idx & 15;
    const int t = q0 + row;
    if (c * 8 >= D || t >= p.Tq) continue;
    float m = Ms[row];
#pragma unroll
    for (int x = 1; x < S; ++x) m = fmaxf(m, Ms[x * kRows + row]);
    float scale[S], l = 0.f;
#pragma unroll
    for (int x = 0; x < S; ++x) {
      scale[x] = fast_exp2((Ms[x * kRows + row] - m) * kLog2e);
      l += Ls[x * kRows + row] * scale[x];
    }
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = 0.f;
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float* crow = Cs + (x * kRows + row) * Dp + c * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] += crow[e] * scale[x];
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] *= inv;
    store8_bf16(o + t * p.o_st + c * 8, out);
    if (c == 0 && p.row_max) {
      const long long at = static_cast<long long>(blockIdx.y) * p.Tq + t;
      p.row_max[at] = m;
      p.row_logsum[at] = logf(l);
    }
  }
}

cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + kBlockM - 1) / kBlockM, B * p.H);
  flash_fwd_fp32<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int W, int S, int NK>
cudaError_t launch_tiles(const Params& p, int B, cudaStream_t stream) {
  const int bytes = fwd_smem_bytes(W, S, 16 * NK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<W, S, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + 16 * W - 1) / (16 * W), B * p.H);
  flash_fwd_bf16<W, S, NK><<<grid, 32 * W * S, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The block shape attention_tc.cuh::tiles_for picks for this grid.
template <int NK>
cudaError_t launch_shape(const Params& p, int B, cudaStream_t stream) {
  const attn_tc::Tiles c = attn_tc::tiles_for(B * p.H, p.Tq);
  if (c.splits == 4) return launch_tiles<2, 4, NK>(p, B, stream);
  if (c.splits == 2) return launch_tiles<4, 2, NK>(p, B, stream);
  return launch_tiles<4, 1, NK>(p, B, stream);
}

cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  return attn_tc::ksteps_for(p.D) == 1 ? launch_shape<1>(p, B, stream)
                                       : launch_shape<8>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; for bf16 the
// data pointers and the batch/time/head strides must give 16-byte aligned
// rows (the wrapper checks).
extern "C" int s2st_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const void* key_padding_mask, float* row_max, float* row_logsum,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    long long kpm_sb,
    int B, int H, int Tq, int Tk, int D, int causal, int dtype,
    void* stream) {
  if (D <= 0 || D > kMaxD || D % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kpm = static_cast<const uint8_t*>(key_padding_mask);
  p.row_max = row_max;
  p.row_logsum = row_logsum;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.kpm_sb = kpm_sb;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_fp32(p, B, s);
  else if (dtype == 1)
    err = launch_bf16(p, B, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
