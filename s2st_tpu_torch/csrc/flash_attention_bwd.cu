// Fused attention backward for Hopper (sm_90a): dQ, dK and dV of
// o = softmax(q k^T + mask) v from q, k, v, o, dO and the forward's per-row
// softmax statistics, never writing the (B, H, Tq, Tk) probabilities to
// device memory.
//
// Replaces the TPU kernels behind the custom_vjp of
// s2st_tpu/nn/attention.py::attend_flash (:44-88): the backward of the Pallas
// TPU flash attention (jax.experimental.pallas.ops.tpu.flash_attention,
// _flash_attention_bwd_dkv and _flash_attention_bwd_dq), which trains the
// encoder self-attention, the causal decoder self-attention, the decoder
// cross-attention and the aux decoders' attention under
// --use-flash-attention --attention-dropout 0. It is the exact gradient of
// flash_attention.cu, whose semantics are s2st_tpu/nn/attention.py::attend's:
//   - q arrives pre-scaled (sm_scale = 1);
//   - the causal mask is ADDED (-1e9 strictly above the diagonal), so the
//     gradient flows through a causally masked score;
//   - key padding REPLACES the score with -1e9, so a padded key's score is a
//     constant and gets no gradient (dS = 0 there). A row with no valid key
//     averages every value: its dV share is dO / Tk, its dQ is 0;
//   - keys past Tk and queries past Tq take no part.
// Probabilities are recomputed as exp(s - m - log l) from the forward's row
// max m and log-sum log l, kept apart so that the -1e9 rows stay exact.
//
// Bound on the card. The function reads q, k, v, o and dO once and writes dq,
// dk and dv once: 8 * B * T * H * D * bytes. At the encoder's B=8, T'=250,
// H=4, D=128 in bf16 that is 8 tensors of 2 MB, about 16 MB, about 5 us at
// 3.35 TB/s. Its products are 2.5x the forward's 4 * B * H * Tq * Tk * D
// (about 1 GFLOP there), about 1 us on the bf16 tensor cores. So the bytes
// bound it; at these sizes the latency chain of each block (its prologue,
// a few tiles, the combine) and the two launches cost more than either.
// At the recipe's batches the products weigh more: the deterministic
// split below recomputes S and dP in both kernels, 7 products where an
// atomic dQ would need 5, all on mma.sync (not wgmma).
//
// The FlashAttention-2 split, with no atomics, so the result is deterministic
// run to run. Two designs, chosen by the input type:
//
// bf16 (the --fp16 main path): tensor cores, two launches.
//   1. attn_bwd_dq_bf16: one block per (b, h, query tile). It first takes
//      D_i = rowsum(dO * o) of its rows in fp32 (summed in a fixed order)
//      and writes it for step 2. q and dO stay in shared memory while
//      32-key tiles of K and V stream through; S = q K^T and dP = dO V^T
//      run on mma.sync.m16n8k16 (bf16 in, fp32 accumulators), dS =
//      P (dP - D) is formed in registers and, rounded to bf16, is the A
//      operand of dQ += dS K (K through ldmatrix.trans).
//   2. attn_bwd_dkdv_bf16: one block per (b, h, key tile). K and V stay
//      while 32-query tiles of q, dO and their (m, log l, D) stream
//      through; S^T = K q^T and dP^T = V dO^T on the same instruction, P^T
//      and dS^T in registers, then dV += P^T dO and dK += dS^T q (dO and q
//      through ldmatrix.trans).
//   Each warp owns 16 resident rows. Both kernels take the forward's block
//   shapes (attention_tc.cuh::tiles_for), chosen from each grid: 32-row
//   blocks of 4 splits of 2 warps while the grid fits one an SM (160 KB of
//   shared memory at D = 128), 64-row blocks of 2 splits of 4 warps while
//   it fits two (131 KB), else 64-row blocks of 4 warps and no split
//   (71 KB; registers, about 245 a thread for dK/dV, which take 128 fp32 a
//   lane at D = 128, and 168 for dQ, fit 2 and 3 blocks an SM). A split
//   has its own 2-stage cp.async ring and accumulators; the splits'
//   partial dQ, or dK and dV, are added in shared memory in split order,
//   so the result is bit-reproducible. Tiles stay bf16 in shared memory,
//   rows padded by 16 bytes so ldmatrix is free of bank conflicts; the
//   head_dim is a template argument, 16 or 128, and a smaller one (8, 72)
//   is zero-filled up to it, so the products unroll with no branch. A
//   warp whose tile has no padded key, lies inside Tk and Tq and not above
//   the diagonal skips the masks. Tiles are skipped only where the skip
//   is exact (attention_tc.cuh::live_keys): padded tail keys and, with key
//   0 valid, causal pairs above the diagonal: P = 0 and dS = 0 there in
//   fp32.
//
// fp32 (every fp32 training run through the kernels): the same split, two
// launches (attn_bwd_dq_fp32, which also writes D, then
// attn_bwd_dkdv_fp32), on the CUDA cores' fp32 FMAs from register tiles
// fed by 16-byte shared reads, a 2-stage cp.async ring, the head_dim
// compiled in and the same exact tile skipping; the note at the head of
// the fp32 section below.
//
// Layout: every (B, T, H, D) tensor through its batch/time/head strides with
// unit stride over D; key_padding_mask (B, Tk) bytes, 1 at pad; the row
// statistics and the D scratch (B, H, Tq) fp32, contiguous.
//
// Plain C interface for ctypes; returns the first non-zero cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int kMaxD = 128;        // largest head_dim; head_dim % 8 == 0
constexpr float kNegInf = -1e9f;  // s2st_tpu/nn/attention.py NEG_INF

struct Tensor4 {  // a (B, T, H, D) tensor: base and batch/time/head strides
  const void* ptr;
  long long sb, st, sh;
};

struct Params {
  Tensor4 q, k, v, o, dout, dq, dk, dv;
  const uint8_t* kpm;
  long long kpm_sb;
  const float* row_max;
  const float* row_logsum;
  float* rowdot;  // D_i, (B, H, Tq)
  int H, Tq, Tk, D;
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Tensor4& t, int b, int h) {
  return static_cast<const T*>(t.ptr) + b * t.sb + h * t.sh;
}

// ---------------------------------------------------------------- fp32 ----
//
// The fp32 design replaces the same TPU kernels where the input is fp32:
// every fp32 training run through the kernels (the train CLI without
// --fp16, with --use-flash-attention --attention-dropout 0; 27 calls a
// microbatch at the recipe's widths). Products are fp32 FMAs on the CUDA
// cores: the tensor cores would take fp32 as TF32, with about three decimal
// digits, which cannot hold the 1e-4 agreement the fp32 checks ask for.
//
// Bound: operations. The function needs 5 products of 2 H D FLOPs a
// (query, valid key) pair: S, dP, dV, dK and dQ. At phase 5's B=8,
// T'=250-100, H=4, D=128 that is 0.0278 ms at the card's 67 TFLOP/s of
// fp32 FMAs; at HuBERT's shape (B=16, T'=511, 199-499 valid keys, H=12,
// D=64) about 0.33 ms; its bytes take a tenth of that.
//
// What held the first (scalar) design back, at 2.2-3.6x SDPA's fp32
// backward and 8.2x its bound: each thread read every operand from shared
// memory as a 4-byte scalar (8 reads for 32 FMAs in S and dP); the
// head_dim was read at run time, so at D=16 most dV, dK and dQ columns
// were masked zeros; P^T and dS^T went through shared memory behind three
// barriers a tile, with loads that were not overlapped with the products;
// global loads divided an integer an element; no tile was skipped, not
// even padded tail tiles or tiles above the causal diagonal; and a third
// launch took D_i = rowsum(dO * o) alone.
//
// What this design does about each (it carries the fp32 forward's design,
// flash_attention.cu, over to the two-kernel split of the bf16 backward):
//   - Two launches, no atomics, bit-reproducible. attn_bwd_dq_fp32, one
//     block per (b, h, R queries), first takes D_i of its rows (the 8
//     threads that own a row each sum a fixed set of its columns and add
//     the 8 shares by shuffles, in a fixed order) and writes it for the
//     second kernel; attn_bwd_dkdv_fp32, one block per (b, h, R keys),
//     runs after it on the same stream. S and dP are recomputed in both: 7
//     products where the bound counts 5, the price of a dQ with no
//     atomics.
//   - Register tiles fed by 16-byte shared reads. Thread (ty, tx) = (tid /
//     8, tid % 8) of 8 G threads owns the R / G resident rows ty + G i and
//     the streamed rows tx + 8 j (j < T / 8) of each T-row tile: the
//     scores and dP of those pairs, then the R / G x Dp / 8 gradient
//     columns of its resident rows. q, dO, K and V are staged row-major
//     with rows of Dp + 4 floats, so one ld.shared.v4 gives 4 values of d:
//     S and dP take 16 reads for 128 FMAs at R / G = 4 and T = 32. P^T and
//     dS^T (dS in dq) go through shared memory in rows of T + 8 floats, so
//     the writes of a warp and the 16-byte reads of the products that
//     follow hit distinct banks.
//   - The head_dim Dp is a template argument, 16, 64 or 128; a head_dim
//     below it is zero-filled in shared memory, so no product is masked.
//   - A 2-stage cp.async ring streams the other operand's T-row tiles: K
//     and V into dq; q, dO and their (m, log l, D) into dkdv. Tile i + 1 is
//     copied while tile i's products run; a tile costs two barriers (the
//     tile has landed; P^T and dS^T are in place).
//   - Tiles are skipped only where that is exact (attention_tc.cuh::
//     live_keys): dq skips padded tail key tiles, and causal key tiles
//     wholly above the block's diagonal; a dkdv block wholly in the padded
//     tail writes dK = dV = 0 without streaming (P = 0 and dS = 0 there),
//     and causally it starts at its first key's query. A row with no valid
//     key skips nothing. A tile with no padded key, inside Tk and Tq and
//     not above any diagonal skips the masks.
//   - Global reads are 16-byte cp.async (o and dO for D_i 16-byte loads)
//     with the head_dim known at compile time; outputs 16-byte stores
//     (8-byte at Dp = 16). The wrapper guarantees 16-byte aligned rows.
// expf stays, as in the fp32 forward: ex2 of log2(e)-scaled scores would
// add the rounding of the scaled score to every probability.
//
// Block shapes (R resident rows, G row groups, 8 G threads) and the tile
// height T follow the grid (rows_for, short_tiles below), timed against
// the others at each grid by attention_tiles.py --fp32-bwd-tiles
// (PERF.md): 128 threads; 32 rows on grids of at most one such block an
// SM, else 64; T = 16 where 64-row blocks number more than one an SM (at
// D = 128 shared memory then holds two blocks an SM, not one), else 32.

namespace fp32 {

constexpr int kStages = 2;         // tiles in the ring

// Shared bytes with streamed tiles of T rows (P^T, dS^T and dS in rows of
// T + 8 floats). dq: q and dO (R rows), the K/V ring, dS. dkdv: K and V,
// the q/dO ring, P^T and dS^T, the ring of the queries' (m, log l, D).
__host__ __device__ constexpr int dq_smem_bytes(int Dp, int R, int T) {
  return 4 * ((2 * R + kStages * 2 * T) * (Dp + 4) + R * (T + 8));
}
__host__ __device__ constexpr int dkdv_smem_bytes(int Dp, int R, int T) {
  return 4 * ((2 * R + kStages * 2 * T) * (Dp + 4) + 2 * R * (T + 8) +
              kStages * 3 * T);
}

// Blocks an SM: as many as shared memory holds (232,448 bytes, 1 KB a
// block reserved), at most as many as leave a thread the registers its
// accumulators (`grads` tiles of R / G x Dp / 8), its scores and dP (R /
// G x T / 8 each) and about 56 others need, and at most 4.
__host__ __device__ constexpr int blocks_per_sm(int smem, int Dp, int R,
                                                int G, int T, int grads) {
  const int regs = grads * (R / G) * (Dp / 8) + 2 * (R / G) * (T / 8) + 56;
  int n = 232448 / (smem + 1024);
  if (n > 65536 / (8 * G * regs)) n = 65536 / (8 * G * regs);
  if (n > 4) n = 4;
  return n < 1 ? 1 : n;
}

// acc[i][.] += a[i] * the kVec-wide columns of row `row` that thread tx
// owns (columns 8 kVec c + kVec tx + x).
template <int kI, int kCols>
__device__ __forceinline__ void accumulate_row(float (&acc)[kI][kCols],
                                               const float (&a)[kI],
                                               const float* row, int tx) {
  constexpr int kVec = kCols >= 4 ? 4 : 2;
#pragma unroll
  for (int c = 0; c < kCols / kVec; ++c) {
    float vv[kVec];
    if constexpr (kVec == 4) {
      const float4 x =
          *reinterpret_cast<const float4*>(row + 8 * kVec * c + kVec * tx);
      vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
    } else {
      const float2 x =
          *reinterpret_cast<const float2*>(row + 8 * kVec * c + kVec * tx);
      vv[0] = x.x; vv[1] = x.y;
    }
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int x = 0; x < kVec; ++x)
        acc[i][c * kVec + x] = fmaf(a[i], vv[x], acc[i][c * kVec + x]);
  }
}

// Store rows t0 + ty + G i (those below n) of a thread's gradient tile,
// columns below D, as 16-byte (8-byte at Dp = 16) writes.
template <int kI, int kCols, int G>
__device__ __forceinline__ void store_rows(const float (&acc)[kI][kCols],
                                           float* dst, long long st, int t0,
                                           int n, int D, int ty, int tx) {
  constexpr int kVec = kCols >= 4 ? 4 : 2;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = t0 + ty + G * i;
    if (t >= n) continue;
    float* row = dst + t * st + kVec * tx;
#pragma unroll
    for (int c = 0; c < kCols / kVec; ++c) {
      if (8 * kVec * c + kVec * tx >= D) continue;
      const int n0 = c * kVec;
      if constexpr (kVec == 4)
        *reinterpret_cast<float4*>(row + 8 * kVec * c) = make_float4(
            acc[i][n0], acc[i][n0 + 1], acc[i][n0 + 2], acc[i][n0 + 3]);
      else
        *reinterpret_cast<float2*>(row + 8 * kVec * c) =
            make_float2(acc[i][n0], acc[i][n0 + 1]);
    }
  }
}

// S (and dP) of a thread's kI x kJ pairs: rows ty + G i of A (and A2)
// against rows tx + 8 j of B (and B2), all staged with rows of Dp + 4.
template <int Dp, int kI, int kJ, int G>
__device__ __forceinline__ void two_products(float (&s)[kI][kJ],
                                             float (&dp)[kI][kJ],
                                             const float* A, const float* A2,
                                             const float* B, const float* B2,
                                             int ty, int tx) {
  constexpr int kLd = Dp + 4;
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < Dp; d += 4) {
    float4 a[kI], a2[kI], b[kJ], b2[kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + G * i) * kLd + d);
      a2[i] = *reinterpret_cast<const float4*>(A2 + (ty + G * i) * kLd + d);
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 8 * j) * kLd + d);
      b2[j] = *reinterpret_cast<const float4*>(B2 + (tx + 8 * j) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        dp[i][j] = fmaf(a2[i].x, b2[j].x, dp[i][j]);
        dp[i][j] = fmaf(a2[i].y, b2[j].y, dp[i][j]);
        dp[i][j] = fmaf(a2[i].z, b2[j].z, dp[i][j]);
        dp[i][j] = fmaf(a2[i].w, b2[j].w, dp[i][j]);
      }
  }
}

// dQ of R queries, and D_i of them for attn_bwd_dkdv_fp32; keys stream
// in tiles of T.
template <int Dp, int R, int G, int T>
__global__ void __launch_bounds__(8 * G,
                                  blocks_per_sm(dq_smem_bytes(Dp, R, T), Dp,
                                                R, G, T, 1))
    attn_bwd_dq_fp32(Params p) {
  using namespace attn_tc;
  constexpr int kThreads = 8 * G;
  constexpr int kI = R / G;          // resident rows a thread
  constexpr int kJ = T / 8;          // streamed rows a thread
  constexpr int kLd = Dp + 4;
  constexpr int kLdP = T + 8;
  constexpr int kCols = Dp / 8;      // gradient columns a thread
  constexpr uint32_t kBits = T == 32 ? 0xffffffffu : (1u << T) - 1u;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                              // [R][kLd]
  float* Gs = Qs + R * kLd;                      // dO
  float* KV = Gs + R * kLd;                      // [stage][K, V][T][kLd]
  float* Ss = KV + kStages * 2 * T * kLd;        // dS [R][kLdP]
  int* red = reinterpret_cast<int*>(Ss);         // live_keys', before dS

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 3;  // rows ty + G i
  const int tx = tid & 7;   // keys tx + 8 j; columns 8 kVec c + kVec tx + x
  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* q = row_ptr<float>(p.q, b, h);
  const float* gout = row_ptr<float>(p.dout, b, h);
  const float* k = row_ptr<float>(p.k, b, h);
  const float* v = row_ptr<float>(p.v, b, h);
  const float* o = row_ptr<float>(p.o, b, h);
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  auto ring = [&](int st, int kv) { return KV + (st * 2 + kv) * T * kLd; };
  auto load_tile = [&](int j, int st) {
    stage_rows_fp32<Dp, T, kThreads>(ring(st, 0), k, p.k.st, j * T, p.Tk, D,
                                     tid);
    stage_rows_fp32<Dp, T, kThreads>(ring(st, 1), v, p.v.st, j * T, p.Tk, D,
                                     tid);
  };

  // q, dO and the first tile are in flight while the block takes D_i and
  // finds the keys it must visit
  zero_cols_fp32<Dp, kThreads>(Qs, 2 * R + kStages * 2 * T, D, tid);
  stage_rows_fp32<Dp, R, kThreads>(Qs, q, p.q.st, q0, p.Tq, D, tid);
  stage_rows_fp32<Dp, R, kThreads>(Gs, gout, p.dout.st, q0, p.Tq, D, tid);
  load_tile(0, 0);
  cp_async_commit();
  // D_i = sum_d dO[i, d] o[i, d]: the 8 threads of a row each sum columns
  // 4 tx + 32 c in c order, then the 8 shares are added by a butterfly,
  // which gives every lane the same bits
  float m[kI], lse[kI], di[kI];
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    const int t = q0 + ty + G * i;
    float acc = 0.f;
    if (t < p.Tq) {
#pragma unroll
      for (int c = 0; c < (Dp + 31) / 32; ++c) {
        const int col = 4 * tx + 32 * c;
        if (col >= D) continue;
        const float4 ov = *reinterpret_cast<const float4*>(o + t * p.o.st +
                                                           col);
        const float4 gv = *reinterpret_cast<const float4*>(
            gout + t * p.dout.st + col);
        acc = fmaf(ov.x, gv.x, acc);
        acc = fmaf(ov.y, gv.y, acc);
        acc = fmaf(ov.z, gv.z, acc);
        acc = fmaf(ov.w, gv.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    di[i] = acc;
    m[i] = t < p.Tq ? p.row_max[stat0 + t] : 0.f;
    lse[i] = t < p.Tq ? p.row_logsum[stat0 + t] : 0.f;
    if (tx == 0 && t < p.Tq) p.rowdot[stat0 + t] = acc;
  }
  const bool pad = key_padded(kpm, lane, p.Tk);
  bool causal_skip;
  int kend = live_keys(kpm, p.Tk, p.causal != 0, &causal_skip, red);
  if (causal_skip) kend = min(kend, q0 + R);
  const int n_tiles = (kend + T - 1) / T;
  uint32_t pm = __ballot_sync(0xffffffffu, pad) & kBits;  // bit b: k0 + b

  float acc[kI][kCols];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = it * T;
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; the last tile's dS and K reads done
    bool next = false;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, st ^ 1);
      cp_async_commit();
      next = key_padded(kpm, k0 + T + lane, p.Tk);
    }
    const float* Kt = ring(st, 0);

    // S = q K^T and dP = dO V^T
    float s[kI][kJ], dp[kI][kJ];
    two_products<Dp, kI, kJ, G>(s, dp, Qs, Gs, Kt, ring(st, 1), ty, tx);

    // dS = P (dP - D), P recomputed from the forward's statistics; the
    // masks are skipped (a block-uniform branch) for a tile of valid keys
    // inside Tk that is not above any of the block's rows' diagonals
    const bool unmasked = pm == 0 && k0 + T <= p.Tk &&
                          !(p.causal && k0 + T - 1 > q0);
    if (unmasked) {
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          s[i][j] = expf((s[i][j] - m[i]) - lse[i]) * (dp[i][j] - di[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int kj = k0 + tx + 8 * j;
          float ds = 0.f;  // 0 outside the sequence and at a padded key
          if (kj < p.Tk && !((pm >> (tx + 8 * j)) & 1u)) {
            float x = s[i][j];
            if (p.causal && kj > q0 + ty + G * i) x += kNegInf;
            ds = expf((x - m[i]) - lse[i]) * (dp[i][j] - di[i]);
          }
          s[i][j] = ds;
        }
    }
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        Ss[(ty + G * i) * kLdP + tx + 8 * j] = s[i][j];
    __syncthreads();  // dS is in place

    // dQ += dS K: 4 keys of dS a 16-byte read
#pragma unroll 2
    for (int kk = 0; kk < T; kk += 4) {
      float4 sv[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        sv[i] = *reinterpret_cast<const float4*>(Ss + (ty + G * i) * kLdP +
                                                 kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a[kI];
#pragma unroll
        for (int i = 0; i < kI; ++i)
          a[i] = e == 0 ? sv[i].x : e == 1 ? sv[i].y : e == 2 ? sv[i].z
                                                             : sv[i].w;
        accumulate_row<kI, kCols>(acc, a, Kt + (kk + e) * kLd, tx);
      }
    }
    pm = __ballot_sync(0xffffffffu, next) & kBits;
  }

  store_rows<kI, kCols, G>(acc,
                           static_cast<float*>(const_cast<void*>(p.dq.ptr)) +
                               b * p.dq.sb + h * p.dq.sh,
                           p.dq.st, q0, p.Tq, D, ty, tx);
}

// dK and dV of R keys, from the D_i that attn_bwd_dq_fp32 wrote; queries
// stream in tiles of T.
template <int Dp, int R, int G, int T>
__global__ void __launch_bounds__(8 * G,
                                  blocks_per_sm(dkdv_smem_bytes(Dp, R, T),
                                                Dp, R, G, T, 2))
    attn_bwd_dkdv_fp32(Params p) {
  using namespace attn_tc;
  constexpr int kThreads = 8 * G;
  constexpr int kI = R / G;          // resident keys a thread
  constexpr int kJ = T / 8;          // streamed queries a thread
  constexpr int kLd = Dp + 4;
  constexpr int kLdP = T + 8;
  constexpr int kCols = Dp / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                              // [R][kLd]
  float* Vs = Ks + R * kLd;
  float* QG = Vs + R * kLd;                      // [stage][q, dO][T][kLd]
  float* Pt = QG + kStages * 2 * T * kLd;        // P^T [R][kLdP]
  float* St = Pt + R * kLdP;                     // dS^T
  float* SS = St + R * kLdP;                     // [stage][m, lse, D][T]
  int* red = reinterpret_cast<int*>(Pt);         // live_keys', before P^T

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // keys ty + G i
  const int tx = tid & 7;   // queries tx + 8 j; columns 8 kVec c + kVec tx
  const int k0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int D = p.D;
  const float* q = row_ptr<float>(p.q, b, h);
  const float* gout = row_ptr<float>(p.dout, b, h);
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  auto ring = [&](int st, int qg) { return QG + (st * 2 + qg) * T * kLd; };
  auto stats = [&](int st, int a) { return SS + (st * 3 + a) * T; };

  // K and V are in flight while the block finds which queries it must
  // visit
  zero_cols_fp32<Dp, kThreads>(Ks, 2 * R + kStages * 2 * T, D, tid);
  stage_rows_fp32<Dp, R, kThreads>(Ks, row_ptr<float>(p.k, b, h), p.k.st,
                                   k0, p.Tk, D, tid);
  stage_rows_fp32<Dp, R, kThreads>(Vs, row_ptr<float>(p.v, b, h), p.v.st,
                                   k0, p.Tk, D, tid);
  cp_async_commit();
  bool kpad[kI];
  bool any_pad = false;
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    kpad[i] = key_padded(kpm, k0 + ty + G * i, p.Tk);
    any_pad |= kpad[i];
  }
  // Keys at or past kend get no gradient (P = 0 and dS = 0 there, exactly);
  // with causal_skip, queries before k0 see these keys only above their
  // diagonal (P = 0 there), so the query loop starts at k0.
  bool causal_skip;
  const int kend = live_keys(kpm, p.Tk, p.causal != 0, &causal_skip, red);
  const bool block_pad = __syncthreads_or(any_pad);
  const int q_first = causal_skip ? k0 : 0;
  const int n_tiles = k0 >= kend || q_first >= p.Tq
                          ? 0
                          : (p.Tq - q_first + T - 1) / T;
  auto load_tile = [&](int j, int st) {
    const int t0 = q_first + j * T;
    stage_rows_fp32<Dp, T, kThreads>(ring(st, 0), q, p.q.st, t0, p.Tq, D,
                                     tid);
    stage_rows_fp32<Dp, T, kThreads>(ring(st, 1), gout, p.dout.st, t0, p.Tq,
                                     D, tid);
    for (int x = tid; x < 3 * T; x += kThreads) {
      const int a = x / T, r = x % T;
      const int t = t0 + r;
      const bool ok = t < p.Tq;
      const float* stat = a == 0 ? p.row_max
                          : a == 1 ? p.row_logsum : p.rowdot;
      cp_async4(stats(st, a) + r, stat + stat0 + (ok ? t : 0), ok);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float dk[kI][kCols], dv[kI][kCols];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int q0 = q_first + it * T;
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; the last tile's P^T, dS^T reads done
    if (it + 1 < n_tiles) {
      load_tile(it + 1, st ^ 1);
      cp_async_commit();
    }
    const float* Qt = ring(st, 0);
    const float* Gt = ring(st, 1);

    // S^T = K q^T and dP^T = V dO^T
    float s[kI][kJ], dp[kI][kJ];
    two_products<Dp, kI, kJ, G>(s, dp, Ks, Vs, Qt, Gt, ty, tx);

    // P^T and dS^T = P^T (dP^T - D); the masks are skipped (a
    // block-uniform branch) for the block's valid keys inside Tk against a
    // tile of queries inside Tq, none of them above its diagonal
    float mj[kJ], lj[kJ], dj[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      mj[j] = stats(st, 0)[tx + 8 * j];
      lj[j] = stats(st, 1)[tx + 8 * j];
      dj[j] = stats(st, 2)[tx + 8 * j];
    }
    const bool unmasked = !block_pad && k0 + R <= p.Tk &&
                          q0 + T <= p.Tq &&
                          !(p.causal && k0 + R - 1 > q0);
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        float pr, ds;
        if (unmasked) {
          pr = expf((s[i][j] - mj[j]) - lj[j]);
          ds = pr * (dp[i][j] - dj[j]);
        } else {
          const int kr = k0 + ty + G * i;
          const int qc = q0 + tx + 8 * j;
          pr = ds = 0.f;
          if (kr < p.Tk && qc < p.Tq) {
            float x = s[i][j];
            if (p.causal && kr > qc) x += kNegInf;
            if (kpad[i]) x = kNegInf;
            pr = expf((x - mj[j]) - lj[j]);
            ds = kpad[i] ? 0.f : pr * (dp[i][j] - dj[j]);
          }
        }
        Pt[(ty + G * i) * kLdP + tx + 8 * j] = pr;
        St[(ty + G * i) * kLdP + tx + 8 * j] = ds;
      }
    __syncthreads();  // P^T and dS^T are in place

    // dV += P^T dO and dK += dS^T q: 4 queries of each a 16-byte read
#pragma unroll 2
    for (int qq = 0; qq < T; qq += 4) {
      float4 pv[kI], sv[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(Pt + (ty + G * i) * kLdP +
                                                 qq);
        sv[i] = *reinterpret_cast<const float4*>(St + (ty + G * i) * kLdP +
                                                 qq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a[kI], a2[kI];
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          a[i] = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z
                                                             : pv[i].w;
          a2[i] = e == 0 ? sv[i].x : e == 1 ? sv[i].y : e == 2 ? sv[i].z
                                                              : sv[i].w;
        }
        accumulate_row<kI, kCols>(dv, a, Gt + (qq + e) * kLd, tx);
        accumulate_row<kI, kCols>(dk, a2, Qt + (qq + e) * kLd, tx);
      }
    }
  }
  cp_async_wait<0>();  // K and V landed even where no tile was streamed

  store_rows<kI, kCols, G>(dk,
                           static_cast<float*>(const_cast<void*>(p.dk.ptr)) +
                               b * p.dk.sb + h * p.dk.sh,
                           p.dk.st, k0, p.Tk, D, ty, tx);
  store_rows<kI, kCols, G>(dv,
                           static_cast<float*>(const_cast<void*>(p.dv.ptr)) +
                               b * p.dv.sb + h * p.dv.sh,
                           p.dv.st, k0, p.Tk, D, ty, tx);
}

template <int Dp, int R, int G, int T>
cudaError_t launch_dq_fp32(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes(Dp, R, T);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_fp32<Dp, R, G, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_fp32<Dp, R, G, T><<<dim3((p.Tq + R - 1) / R, B * p.H), 8 * G,
                                  bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int Dp, int R, int G, int T>
cudaError_t launch_dkdv_fp32(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = dkdv_smem_bytes(Dp, R, T);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_fp32<Dp, R, G, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_fp32<Dp, R, G, T><<<dim3((p.Tk + R - 1) / R, B * p.H),
                                    8 * G, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Resident rows a block: 32 when blocks of 32 number at most one an SM (a
// served batch of 4 at D = 128: 16 heads of 8 such blocks), so that twice
// the SMs share the work; else 64, whose 4 rows a thread feed more FMAs a
// shared read.
inline int rows_for(int bh, int t) {
  return (t + 31) / 32 * bh <= attn_tc::sm_count() ? 32 : 64;
}

// Streamed tiles of 16 rows when blocks of 64 rows number more than one an
// SM, so that two blocks fit an SM's shared memory at D = 128 (dK/dV: 114
// KB, not 156); else 32, whose 4 rows a thread feed more FMAs a shared
// read (attention_tiles.py --fp32-bwd-tiles, PERF.md).
inline bool short_tiles(int bh, int t) {
  return (t + 63) / 64 * bh > attn_tc::sm_count();
}

// dq first (it writes D), then dkdv, on one stream, each in the block shape
// and tile height that this function picks for its grid.
template <int Dp>
cudaError_t launch_shapes(const Params& p, int B, cudaStream_t stream) {
  const int bh = B * p.H;
  cudaError_t err =
      rows_for(bh, p.Tq) == 32 ? launch_dq_fp32<Dp, 32, 16, 32>(p, B, stream)
      : short_tiles(bh, p.Tq)  ? launch_dq_fp32<Dp, 64, 16, 16>(p, B, stream)
                               : launch_dq_fp32<Dp, 64, 16, 32>(p, B, stream);
  if (err != cudaSuccess) return err;
  return rows_for(bh, p.Tk) == 32
             ? launch_dkdv_fp32<Dp, 32, 16, 32>(p, B, stream)
         : short_tiles(bh, p.Tk)
             ? launch_dkdv_fp32<Dp, 64, 16, 16>(p, B, stream)
             : launch_dkdv_fp32<Dp, 64, 16, 32>(p, B, stream);
}

}  // namespace fp32

cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  switch (attn_tc::fp32_width_for(p.D)) {
    case 16: return fp32::launch_shapes<16>(p, B, stream);
    case 64: return fp32::launch_shapes<64>(p, B, stream);
    default: return fp32::launch_shapes<128>(p, B, stream);
  }
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kTile = 32;   // rows of a streamed tile: dq keys, dkdv queries
constexpr int kStages = 2;  // tiles in flight in each split's ring
// Shared bytes of either bf16 kernel with W warps a split and S splits at
// padded head_dim Dp: its two resident tiles of 16 W rows (q and dO, or K
// and V); S rings of kStages pairs of streamed tiles (K and V, or q and
// dO), rows of Dp + 8 bf16; S rings of the streamed tiles' padding words
// (dq) or (m, log l, D) (dkdv); the block's D (dq) or key padding words
// (dkdv); reduction scratch. After the loop the splits' fp32 partial
// gradients, dQ (dq, from the ring) or dK and dV (dkdv, from the start),
// are combined in the same space, which is grown to hold them if need be.
__host__ __device__ inline int bwd_smem_bytes(int W, int S, int Dp) {
  const int loop = 2 * (2 * 16 * W + S * kStages * 2 * kTile) * (Dp + 8) +
                   4 * 3 * S * kStages * kTile + 4 * 16 * W + 4 * 32;
  const int combine = 2 * 4 * S * 16 * W * Dp;
  return loop > combine ? loop : combine;
}

// The combined gradient of a block's 16 W rows: the splits' fp32 partials
// in C ([split][row][Dp]) added in split order, 8 columns a thread, stored
// as bf16 through the tensor's time stride.
template <int W, int S>
__device__ __forceinline__ void store_combined(__nv_bfloat16* dst,
                                               long long st, int t0, int n,
                                               const float* C, int D,
                                               int Dp) {
  constexpr int kRows = 16 * W;
  for (int idx = threadIdx.x; idx < kRows * 16; idx += 32 * W * S) {
    const int row = idx >> 4, c = idx & 15;
    if (c * 8 >= D || t0 + row >= n) continue;
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = 0.f;
#pragma unroll
    for (int x = 0; x < S; ++x) {
      const float* crow = C + (x * kRows + row) * Dp + c * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] += crow[e];
    }
    attn_tc::store8_bf16(dst + (t0 + row) * st + c * 8, out);
  }
}

// A warp's 16 x Dp fp32 accumulator into rows r0 .. r0+15 of C (row
// stride Dp), in the mma accumulator layout.
template <int NK>
__device__ __forceinline__ void spill_acc(float* C, int r0,
                                          const float acc[2 * NK][4]) {
  constexpr int Dp = 16 * NK;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* crow = C + (r0 + g + r * 8) * Dp;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      *reinterpret_cast<float2*>(crow + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dQ of 16 W queries. First D_i = rowsum(dO * o) of its rows, written for
// attn_bwd_dkdv_bf16; then S splits of W warps, split i taking the key
// tiles i, i + S, ... of K and V through its 2-stage ring, and their
// partial dQ added in split order.
template <int W, int S, int NK>
__global__ void __launch_bounds__(32 * W * S) attn_bwd_dq_bf16(Params p) {
  using namespace attn_tc;
  using bf16 = __nv_bfloat16;
  constexpr int kRows = 16 * W;     // queries a block
  constexpr int kSplit = 32 * W;    // threads a split
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Dp = 16 * NK;       // head_dim, zero-filled from D
  constexpr int ld = Dp + 8;
  const int D = p.D;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kRows * ld;  // dO
  bf16* KV = Gs + kRows * ld;  // [split][stage][K, V][kTile][ld]
  uint32_t* PM = reinterpret_cast<uint32_t*>(KV + S * kStages * 2 * kTile *
                                             ld);  // [split][stage]
  float* Ds = reinterpret_cast<float*>(PM + 3 * S * kStages * kTile);
  int* red = reinterpret_cast<int*>(Ds + kRows);
  float* Cs = reinterpret_cast<float*>(KV);  // after the loop

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sp = warp / W, rg = warp % W, stid = tid % kSplit;
  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const bf16* q = row_ptr<bf16>(p.q, b, h);
  const bf16* gout = row_ptr<bf16>(p.dout, b, h);
  const bf16* k = row_ptr<bf16>(p.k, b, h);
  const bf16* v = row_ptr<bf16>(p.v, b, h);
  const bf16* o = row_ptr<bf16>(p.o, b, h);
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  auto ring = [&](int st, int kv) {
    return KV + ((sp * kStages + st) * 2 + kv) * kTile * ld;
  };
  auto load_tile = [&](int j, int st) {  // by the split's threads
    load_rows(ring(st, 0), ld, k, p.k.st, j * kTile, p.Tk, kTile, D, stid,
              kSplit);
    load_rows(ring(st, 1), ld, v, p.v.st, j * kTile, p.Tk, kTile, D, stid,
              kSplit);
  };

  // q, dO and each split's first tile are in flight while the block takes
  // D and finds the keys it must visit
  zero_tail(Qs, ld, 2 * kRows + S * kStages * 2 * kTile, D, Dp, tid,
            kSplit * S);
  load_rows(Qs, ld, q, p.q.st, q0, p.Tq, kRows, D, tid, kSplit * S);
  load_rows(Gs, ld, gout, p.dout.st, q0, p.Tq, kRows, D, tid, kSplit * S);
  if (sp * kTile < p.Tk) load_tile(sp, 0);
  cp_async_commit();
  // D_i = sum_d dO[i, d] * o[i, d] in fp32, a warp a row, 4 columns a lane
  // (head_dim <= 128), summed in a fixed order: bit-reproducible. All the
  // global reads of the prologue (o and dO rows, the first tile's padding
  // bytes, the key scan) are started before any is waited on.
  constexpr int kRowsPerWarp = kRows / (W * S);
  uint2 ov[kRowsPerWarp], gv[kRowsPerWarp];
#pragma unroll
  for (int x = 0; x < kRowsPerWarp; ++x) {
    const int t = q0 + warp + x * W * S;
    ov[x] = gv[x] = make_uint2(0, 0);
    if (t < p.Tq && 4 * lane < D) {
      ov[x] = *reinterpret_cast<const uint2*>(o + t * p.o.st + 4 * lane);
      gv[x] = *reinterpret_cast<const uint2*>(gout + t * p.dout.st +
                                              4 * lane);
    }
  }
  const bool pad0 = key_padded(kpm, sp * kTile + lane, p.Tk);
  bool causal_skip;
  int kend = live_keys(kpm, p.Tk, p.causal != 0, &causal_skip, red);
  const uint32_t bits0 = __ballot_sync(0xffffffffu, pad0);
  if (rg == 0 && lane == 0) PM[sp * kStages] = bits0;
#pragma unroll
  for (int x = 0; x < kRowsPerWarp; ++x) {
    const int r = warp + x * W * S;
    const float2 o01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ov[x].x));
    const float2 o23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ov[x].y));
    const float2 g01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&gv[x].x));
    const float2 g23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&gv[x].y));
    float acc = o01.x * g01.x;
    acc = fmaf(o01.y, g01.y, acc);
    acc = fmaf(o23.x, g23.x, acc);
    acc = fmaf(o23.y, g23.y, acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      Ds[r] = acc;
      if (q0 + r < p.Tq) p.rowdot[stat0 + q0 + r] = acc;
    }
  }
  if (causal_skip) kend = min(kend, q0 + kRows);
  const int n_tiles = (kend + kTile - 1) / kTile;
  const int n_mine = sp < n_tiles ? (n_tiles - 1 - sp) / S + 1 : 0;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + rg * 16 + g;  // the lane's rows: row0, row0 + 8
  float m[2], lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // read while the copies land
    const int t = row0 + r * 8;
    m[r] = t < p.Tq ? p.row_max[stat0 + t] : 0.f;
    lse[r] = t < p.Tq ? p.row_logsum[stat0 + t] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();  // q, dO, D, the first tiles and their padding bits
#pragma unroll
  for (int r = 0; r < 2; ++r) di[r] = Ds[rg * 16 + g + r * 8];
  float dq[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int j = sp + i * S, st = i % kStages;
    bool pad_next = false;
    if (i + 1 < n_mine) {
      load_tile(j + S, (i + 1) % kStages);
      pad_next = key_padded(kpm, (j + S) * kTile + lane, p.Tk);
    }
    cp_async_commit();
    if (i > 0) {
      cp_async_wait<1>();  // tile i landed
      split_sync(1 + sp, kSplit);
    }
    const bf16* Kt = ring(st, 0);
    const bf16* Vt = ring(st, 1);
    const uint32_t pad = PM[sp * kStages + st];
    const int k0 = j * kTile;

    // S = q K^T and dP = dO V^T, (16 rows x 32 keys) a warp
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4], ga[4];
      const int a_off = (rg * 16 + (lane & 15)) * ld + kk * 16 +
                        (lane >> 4) * 8;
      ldsm_x4(qa, Qs + a_off);
      ldsm_x4(ga, Gs + a_off);
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        const int b_off = (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kt + b_off);
        ldsm_x4(bv, Vt + b_off);
        mma_bf16(s[2 * n2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
        mma_bf16(dp[2 * n2], ga, bv[0], bv[1]);
        mma_bf16(dp[2 * n2 + 1], ga, bv[2], bv[3]);
      }
    }

    // dS = P * (dP - D), P recomputed from the forward's statistics; the
    // masks are skipped (a warp-uniform branch) for a tile of valid keys
    // inside Tk, rows inside Tq, not above any of the rows' diagonals
    const bool unmasked = pad == 0 && k0 + kTile <= p.Tk &&
                          q0 + rg * 16 + 16 <= p.Tq &&
                          !(p.causal && k0 + kTile - 1 > q0 + rg * 16);
    if (unmasked) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = fast_exp2(((s[n][e] - m[e >> 1]) - lse[e >> 1]) *
                              kLog2e) *
                    (dp[n][e] - di[e >> 1]);
    } else {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tq + (e & 1);
          const int r = e >> 1;
          float ds = 0.f;
          if (k0 + col < p.Tk && row0 + r * 8 < p.Tq &&
              !((pad >> col) & 1u)) {
            float x = s[n][e];
            if (p.causal && k0 + col > row0 + r * 8) x += kNegInf;
            const float pr = fast_exp2(((x - m[r]) - lse[r]) * kLog2e);
            ds = pr * (dp[n][e] - di[r]);
          }
          s[n][e] = ds;
        }
    }

    // dQ += dS K: dS (bf16) from registers, K through ldmatrix.trans
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) {
      uint32_t sa[4];
      acc_to_a(sa, s[2 * jj], s[2 * jj + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NK; ++n2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              ld + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(dq[2 * n2], sa, bk[0], bk[1]);
        mma_bf16(dq[2 * n2 + 1], sa, bk[2], bk[3]);
      }
    }
    if (i + 1 < n_mine) {
      const uint32_t bits = __ballot_sync(0xffffffffu, pad_next);
      if (rg == 0 && lane == 0) PM[sp * kStages + (i + 1) % kStages] = bits;
    }
    split_sync(1 + sp, kSplit);  // this stage is consumed before refilling
  }

  __syncthreads();  // every ring is consumed: Cs may overwrite it
  spill_acc<NK>(Cs + sp * kRows * Dp, rg * 16, dq);
  __syncthreads();
  store_combined<W, S>(static_cast<bf16*>(const_cast<void*>(p.dq.ptr)) +
                        b * p.dq.sb + h * p.dq.sh,
                    p.dq.st, q0, p.Tq, Cs, D, Dp);
}

// dK and dV of 16 W keys: S splits of W warps, split i taking the query
// tiles i, i + S, ... of q, dO and their (m, log l, D) through its 2-stage
// ring, and their partial dK and dV added in split order. Runs after
// attn_bwd_dq_bf16, which wrote D.
template <int W, int S, int NK>
__global__ void __launch_bounds__(32 * W * S) attn_bwd_dkdv_bf16(Params p) {
  using namespace attn_tc;
  using bf16 = __nv_bfloat16;
  constexpr int kRows = 16 * W;     // keys a block
  constexpr int kSplit = 32 * W;    // threads a split
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Dp = 16 * NK;       // head_dim, zero-filled from D
  constexpr int ld = Dp + 8;
  const int D = p.D;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kRows * ld;
  bf16* QG = Vs + kRows * ld;  // [split][stage][q, dO][kTile][ld]
  float* SS = reinterpret_cast<float*>(QG + S * kStages * 2 * kTile *
                                       ld);  // [split][stage][m, lse, D][row]
  uint32_t* PK = reinterpret_cast<uint32_t*>(SS + 3 * S * kStages * kTile);
  int* red = reinterpret_cast<int*>(PK + kRows);
  float* Cs = reinterpret_cast<float*>(smem_raw);  // after the loop: dK, dV

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sp = warp / W, rg = warp % W, stid = tid % kSplit;
  const int k0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const bf16* q = row_ptr<bf16>(p.q, b, h);
  const bf16* gout = row_ptr<bf16>(p.dout, b, h);
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;
  auto ring = [&](int st, int qg) {
    return QG + ((sp * kStages + st) * 2 + qg) * kTile * ld;
  };
  auto stats = [&](int st, int a) {
    return SS + ((sp * kStages + st) * 3 + a) * kTile;
  };

  zero_tail(Ks, ld, 2 * kRows + S * kStages * 2 * kTile, D, Dp, tid,
            kSplit * S);
  load_rows(Ks, ld, row_ptr<bf16>(p.k, b, h), p.k.st, k0, p.Tk, kRows, D,
            tid, kSplit * S);
  load_rows(Vs, ld, row_ptr<bf16>(p.v, b, h), p.v.st, k0, p.Tk, kRows, D,
            tid, kSplit * S);
  // Keys at or past kend get no gradient (P = 0 and dS = 0 there, exactly);
  // with causal_skip, queries before k0 see this tile only above their
  // diagonal (P = 0 there), so the query loop starts at k0.
  // warp w < 16 W / 32 takes the padding word of keys k0 + 32 w ..
  const bool pad_key = key_padded(kpm, k0 + 32 * warp + lane, p.Tk);
  bool causal_skip;
  const int kend = live_keys(kpm, p.Tk, p.causal != 0, &causal_skip, red);
  if (warp < kRows / 32) {
    const uint32_t key_bits = __ballot_sync(0xffffffffu, pad_key);
    if (lane == 0) PK[warp] = key_bits;
  }
  const int q_first = causal_skip ? k0 : 0;
  const int n_tiles = k0 >= kend || q_first >= p.Tq
                          ? 0
                          : (p.Tq - q_first + kTile - 1) / kTile;
  const int n_mine = sp < n_tiles ? (n_tiles - 1 - sp) / S + 1 : 0;
  auto load_tile = [&](int j, int st) {  // by the split's threads
    const int q0 = q_first + j * kTile;
    load_rows(ring(st, 0), ld, q, p.q.st, q0, p.Tq, kTile, D, stid, kSplit);
    load_rows(ring(st, 1), ld, gout, p.dout.st, q0, p.Tq, kTile, D, stid,
              kSplit);
    for (int x = stid; x < 3 * kTile; x += kSplit) {
      const int a = x / kTile, r = x % kTile;
      const int t = q0 + r;
      const bool ok = t < p.Tq;
      const float* stat = a == 0 ? p.row_max
                          : a == 1 ? p.row_logsum : p.rowdot;
      cp_async4(stats(st, a) + r, stat + stat0 + (ok ? t : 0), ok);
    }
  };
  if (n_mine > 0) load_tile(sp, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K, V, their padding bits and the first tiles

  const int g = lane >> 2, tq = lane & 3;
  // bits 0..15 of pad: this warp's 16 keys
  const uint32_t pad = PK[rg >> 1] >> ((rg & 1) * 16);
  float dk[2 * NK][4], dv[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    const int j = sp + i * S, st = i % kStages;
    if (i + 1 < n_mine) load_tile(j + S, (i + 1) % kStages);
    cp_async_commit();
    if (i > 0) {
      cp_async_wait<1>();  // tile i landed
      split_sync(1 + sp, kSplit);
    }
    const bf16* Qt = ring(st, 0);
    const bf16* Gt = ring(st, 1);
    const float* m = stats(st, 0);
    const float* lse = stats(st, 1);
    const float* di = stats(st, 2);
    const int q0 = q_first + j * kTile;

    // S^T = K q^T and dP^T = V dO^T, (16 keys x 32 queries) a warp
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (rg * 16 + (lane & 15)) * ld + kk * 16 +
                        (lane >> 4) * 8;
      ldsm_x4(ka, Ks + a_off);
      ldsm_x4(va, Vs + a_off);
#pragma unroll
      for (int n2 = 0; n2 < kTile / 16; ++n2) {
        const int b_off = (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bg[4];
        ldsm_x4(bq, Qt + b_off);
        ldsm_x4(bg, Gt + b_off);
        mma_bf16(s[2 * n2], ka, bq[0], bq[1]);
        mma_bf16(s[2 * n2 + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * n2], va, bg[0], bg[1]);
        mma_bf16(dp[2 * n2 + 1], va, bg[2], bg[3]);
      }
    }

    // P^T and dS^T = P^T * (dP^T - D), over (key, query) pairs; the masks
    // are skipped (a warp-uniform branch) for the warp's 16 valid keys
    // inside Tk against a tile of queries inside Tq, none of them above
    // its diagonal
    const bool unmasked = (pad & 0xffffu) == 0 &&
                          k0 + rg * 16 + 16 <= p.Tk && q0 + kTile <= p.Tq &&
                          !(p.causal && k0 + rg * 16 + 15 > q0);
    if (unmasked) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * tq + (e & 1);
          const float pr = fast_exp2(((s[n][e] - m[qc]) - lse[qc]) * kLog2e);
          s[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - di[qc]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = g + (e >> 1) * 8;  // key within the warp's 16
          const int kr = rg * 16 + kl;
          const int qc = n * 8 + 2 * tq + (e & 1);
          const bool padded = (pad >> kl) & 1u;
          float pr = 0.f, ds = 0.f;
          if (k0 + kr < p.Tk && q0 + qc < p.Tq) {
            float x = s[n][e];
            if (p.causal && k0 + kr > q0 + qc) x += kNegInf;
            if (padded) x = kNegInf;
            pr = fast_exp2(((x - m[qc]) - lse[qc]) * kLog2e);
            ds = padded ? 0.f : pr * (dp[n][e] - di[qc]);
          }
          s[n][e] = pr;
          dp[n][e] = ds;
        }
    }

    // dV += P^T dO and dK += dS^T q: A from registers (bf16), dO and q
    // through ldmatrix.trans
#pragma unroll
    for (int jj = 0; jj < kTile / 16; ++jj) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, s[2 * jj], s[2 * jj + 1]);
      acc_to_a(sa, dp[2 * jj], dp[2 * jj + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NK; ++n2) {
        const int b_off = (jj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              ld + n2 * 16 + (lane >> 4) * 8;
        uint32_t bg[4], bq[4];
        ldsm_x4_t(bg, Gt + b_off);
        ldsm_x4_t(bq, Qt + b_off);
        mma_bf16(dv[2 * n2], pa, bg[0], bg[1]);
        mma_bf16(dv[2 * n2 + 1], pa, bg[2], bg[3]);
        mma_bf16(dk[2 * n2], sa, bq[0], bq[1]);
        mma_bf16(dk[2 * n2 + 1], sa, bq[2], bq[3]);
      }
    }
    split_sync(1 + sp, kSplit);  // this stage is consumed before refilling
  }

  __syncthreads();  // K, V and every ring are consumed: Cs may overwrite
  float* Ck = Cs;
  float* Cv = Cs + S * kRows * Dp;
  spill_acc<NK>(Ck + sp * kRows * Dp, rg * 16, dk);
  spill_acc<NK>(Cv + sp * kRows * Dp, rg * 16, dv);
  __syncthreads();
  store_combined<W, S>(static_cast<bf16*>(const_cast<void*>(p.dk.ptr)) +
                           b * p.dk.sb + h * p.dk.sh,
                       p.dk.st, k0, p.Tk, Ck, D, Dp);
  store_combined<W, S>(static_cast<bf16*>(const_cast<void*>(p.dv.ptr)) +
                           b * p.dv.sb + h * p.dv.sh,
                       p.dv.st, k0, p.Tk, Cv, D, Dp);
}

template <int W, int S, int NK>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t stream) {
  const int bytes = bwd_smem_bytes(W, S, 16 * NK);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_bf16<W, S, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_bf16<W, S, NK><<<dim3((p.Tq + 16 * W - 1) / (16 * W),
                                    B * p.H),
                               32 * W * S, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int W, int S, int NK>
cudaError_t launch_dkdv(const Params& p, int B, cudaStream_t stream) {
  const int bytes = bwd_smem_bytes(W, S, 16 * NK);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_bf16<W, S, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_bf16<W, S, NK><<<dim3((p.Tk + 16 * W - 1) / (16 * W),
                                      B * p.H),
                                 32 * W * S, bytes, stream>>>(p);
  return cudaGetLastError();
}

// dq first (it writes D), then dkdv; two launches on one stream, each with
// the block shape attention_tc.cuh::tiles_for picks for its grid.
template <int NK>
cudaError_t launch_shape(const Params& p, int B, cudaStream_t stream) {
  const attn_tc::Tiles cq = attn_tc::tiles_for(B * p.H, p.Tq);
  cudaError_t err = cq.splits == 4   ? launch_dq<2, 4, NK>(p, B, stream)
                    : cq.splits == 2 ? launch_dq<4, 2, NK>(p, B, stream)
                                     : launch_dq<4, 1, NK>(p, B, stream);
  if (err != cudaSuccess) return err;
  const attn_tc::Tiles ck = attn_tc::tiles_for(B * p.H, p.Tk);
  return ck.splits == 4   ? launch_dkdv<2, 4, NK>(p, B, stream)
         : ck.splits == 2 ? launch_dkdv<4, 2, NK>(p, B, stream)
                          : launch_dkdv<4, 1, NK>(p, B, stream);
}

cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  return attn_tc::ksteps_for(p.D) == 1 ? launch_shape<1>(p, B, stream)
                                       : launch_shape<8>(p, B, stream);
}

Tensor4 tensor4(const void* ptr, const long long* strides) {
  Tensor4 t;
  t.ptr = ptr;
  t.sb = strides[0];
  t.st = strides[1];
  t.sh = strides[2];
  return t;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides holds the batch, time and head
// strides (in elements) of q, k, v, o, dout, dq, dk and dv, in that order:
// 24 values; for bf16 they and the data pointers must give 16-byte aligned
// rows (the wrapper checks). rowdot is (B, H, Tq) fp32 scratch.
extern "C" int s2st_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv,
    const void* key_padding_mask, long long kpm_sb,
    const float* row_max, const float* row_logsum, float* rowdot,
    const long long* strides, int B, int H, int Tq, int Tk, int D, int causal,
    int dtype, void* stream) {
  if (D <= 0 || D > kMaxD || D % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 ||
      Tk <= 0 || B * H > 65535 || !row_max || !row_logsum || !rowdot)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = tensor4(q, strides + 0);
  p.k = tensor4(k, strides + 3);
  p.v = tensor4(v, strides + 6);
  p.o = tensor4(o, strides + 9);
  p.dout = tensor4(dout, strides + 12);
  p.dq = tensor4(dq, strides + 15);
  p.dk = tensor4(dk, strides + 18);
  p.dv = tensor4(dv, strides + 21);
  p.kpm = static_cast<const uint8_t*>(key_padding_mask);
  p.kpm_sb = kpm_sb;
  p.row_max = row_max;
  p.row_logsum = row_logsum;
  p.rowdot = rowdot;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.D = D;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch_fp32(p, B, s));
  if (dtype == 1) return static_cast<int>(launch_bf16(p, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
