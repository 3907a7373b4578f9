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
// fp32 (the parity paths): the scalar kernels of the first port, three
// launches: attn_bwd_rowdot (D_i, a warp a row); attn_bwd_dkdv (one block
// per (b, h, 64-key tile), S^T and dP^T recomputed, P^T and dS^T in shared
// memory, dV and dK accumulated in fp32 registers); attn_bwd_dq (one block
// per (b, h, 64-query tile), dQ += dS K). Products are scalar fp32 FMAs,
// so fp32 stays exact to fp32 rounding: the tensor cores would take fp32 as
// TF32 (about three decimal digits), which cannot hold the 1e-4 agreement
// the fp32 checks ask for. No tile is skipped.
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

constexpr int kBlock = 64;        // fp32: queries or keys per tile
constexpr int kMaxD = 128;        // largest head_dim; head_dim % 8 == 0
constexpr int kThreads = 256;     // 8 warps
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

// Copy rows t0 .. t0+63 of one (b, h) slice into a shared tile with rows
// padded to ld floats; rows at or past n are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long st, int t0, int n, int D) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = t0 + r;
    dst[r * ld + d] = t < n ? src[t * st + d] : 0.f;
  }
}

// The probability and the score gradient of one (query qi, key kj) pair from
// the recomputed score s and dP; 0 outside the sequences, dS 0 at a padded key.
__device__ __forceinline__ void prob_and_dscore(
    const Params& p, const uint8_t* kpm, int qi, int kj, float s, float dp,
    float m, float logsum, float rowdot, float* prob, float* dscore) {
  if (qi >= p.Tq || kj >= p.Tk) {
    *prob = 0.f;
    *dscore = 0.f;
    return;
  }
  float x = s;
  if (p.causal && kj > qi) x += kNegInf;
  const bool padded = kpm && kpm[kj];
  if (padded) x = kNegInf;
  const float pr = expf((x - m) - logsum);
  *prob = pr;
  *dscore = padded ? 0.f : pr * (dp - rowdot);
}

__global__ void __launch_bounds__(kThreads) attn_bwd_rowdot(Params p,
                                                            int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = row % p.Tq;
  const int bh = row / p.Tq;
  const int b = bh / p.H, h = bh % p.H;
  const float* o = row_ptr<float>(p.o, b, h) + i * p.o.st;
  const float* g = row_ptr<float>(p.dout, b, h) + i * p.dout.st;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.rowdot[row] = acc;
}

// Shared floats of the dkdv and dq kernels: four (64, D + 1) tiles, one or two
// (64, 65) score tiles and the 64 rows' m, log l and D.
__host__ __device__ inline int smem_floats(int D, int score_tiles) {
  return 4 * kBlock * (D + 1) + score_tiles * kBlock * (kBlock + 1) + 3 * kBlock;
}

__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  constexpr int lp = kBlock + 1;
  float* Ks = smem;
  float* Vs = Ks + kBlock * ld;
  float* Qs = Vs + kBlock * ld;
  float* Gs = Qs + kBlock * ld;  // dO
  float* Pt = Gs + kBlock * ld;  // P^T  (key row, query column)
  float* St = Pt + kBlock * lp;  // dS^T
  float* m_s = St + kBlock * lp;
  float* l_s = m_s + kBlock;
  float* d_s = l_s + kBlock;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // key rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // query columns tx + 16j; output columns tx + 16c
  const int k0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;

  load_tile(Ks, ld, row_ptr<float>(p.k, b, h), p.k.st, k0, p.Tk, D);
  load_tile(Vs, ld, row_ptr<float>(p.v, b, h), p.v.st, k0, p.Tk, D);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += kBlock) {
    __syncthreads();  // the previous tile's P^T, dS^T, q and dO are consumed
    load_tile(Qs, ld, row_ptr<float>(p.q, b, h), p.q.st, q0, p.Tq, D);
    load_tile(Gs, ld, row_ptr<float>(p.dout, b, h), p.dout.st, q0, p.Tq, D);
    if (tid < kBlock) {
      const int t = q0 + tid;
      m_s[tid] = t < p.Tq ? p.row_max[stat0 + t] : 0.f;
      l_s[tid] = t < p.Tq ? p.row_logsum[stat0 + t] : 0.f;
      d_s[tid] = t < p.Tq ? p.rowdot[stat0 + t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * ld + d];
        vv[i] = Vs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qs[(tx + 16 * j) * ld + d];
        gv[j] = Gs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        float pr, ds;
        prob_and_dscore(p, kpm, q0 + qc, k0 + kr, s[i][j], dp[i][j], m_s[qc],
                        l_s[qc], d_s[qc], &pr, &ds);
        Pt[kr * lp + qc] = pr;
        St[kr * lp + qc] = ds;
      }
    }
    __syncthreads();  // P^T and dS^T are in place

    for (int qc = 0; qc < kBlock; ++qc) {
      float pv[4], sv[4], gv[8], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty * 4 + i) * lp + qc];
        sv[i] = St[(ty * 4 + i) * lp + qc];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        gv[c] = col < D ? Gs[qc * ld + col] : 0.f;
        qv[c] = col < D ? Qs[qc * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
        }
    }
  }

  float* dk_out = static_cast<float*>(const_cast<void*>(p.dk.ptr)) +
                   b * p.dk.sb + h * p.dk.sh;
  float* dv_out = static_cast<float*>(const_cast<void*>(p.dv.ptr)) +
                   b * p.dv.sb + h * p.dv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk_out[t * p.dk.st + col] = dk[i][c];
        dv_out[t * p.dv.st + col] = dv[i][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  constexpr int lp = kBlock + 1;
  float* Qs = smem;
  float* Gs = Qs + kBlock * ld;  // dO
  float* Ks = Gs + kBlock * ld;
  float* Vs = Ks + kBlock * ld;
  float* Ss = Vs + kBlock * ld;  // dS (query row, key column)
  float* m_s = Ss + kBlock * lp;
  float* l_s = m_s + kBlock;
  float* d_s = l_s + kBlock;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // key columns tx + 16j; output columns tx + 16c
  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  const long long stat0 = static_cast<long long>(bh) * p.Tq;

  load_tile(Qs, ld, row_ptr<float>(p.q, b, h), p.q.st, q0, p.Tq, D);
  load_tile(Gs, ld, row_ptr<float>(p.dout, b, h), p.dout.st, q0, p.Tq, D);
  if (tid < kBlock) {
    const int t = q0 + tid;
    m_s[tid] = t < p.Tq ? p.row_max[stat0 + t] : 0.f;
    l_s[tid] = t < p.Tq ? p.row_logsum[stat0 + t] : 0.f;
    d_s[tid] = t < p.Tq ? p.rowdot[stat0 + t] : 0.f;
  }

  float dq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dq[i][c] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += kBlock) {
    __syncthreads();  // q, dO and the statistics are loaded; the previous
                      // tile's K and dS are consumed
    load_tile(Ks, ld, row_ptr<float>(p.k, b, h), p.k.st, k0, p.Tk, D);
    load_tile(Vs, ld, row_ptr<float>(p.v, b, h), p.v.st, k0, p.Tk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * ld + d];
        gv[i] = Gs[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        float pr, ds;
        prob_and_dscore(p, kpm, q0 + qr, k0 + kc, s[i][j], dp[i][j], m_s[qr],
                        l_s[qr], d_s[qr], &pr, &ds);
        Ss[qr * lp + kc] = ds;
      }
    }
    __syncthreads();  // dS is in place

    for (int kc = 0; kc < kBlock; ++kc) {
      float sv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty * 4 + i) * lp + kc];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? Ks[kc * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
    }
  }

  float* dq_out = static_cast<float*>(const_cast<void*>(p.dq.ptr)) +
                   b * p.dq.sb + h * p.dq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dq_out[t * p.dq.st + col] = dq[i][c];
    }
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

cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  const int rows = B * p.H * p.Tq;
  attn_bwd_rowdot<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                    0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_bytes = sizeof(float) * smem_floats(p.D, 2);
  err = cudaFuncSetAttribute(attn_bwd_dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_bytes));
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv<<<dim3((p.Tk + kBlock - 1) / kBlock, B * p.H), kThreads,
                  dkdv_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_bytes = sizeof(float) * smem_floats(p.D, 1);
  err = cudaFuncSetAttribute(attn_bwd_dq,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  attn_bwd_dq<<<dim3((p.Tq + kBlock - 1) / kBlock, B * p.H), kThreads,
                dq_bytes, stream>>>(p);
  return cudaGetLastError();
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
