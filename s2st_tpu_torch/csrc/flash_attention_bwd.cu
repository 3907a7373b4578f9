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
// (about 1 GFLOP there), a few us on the bf16 tensor cores. So the bytes bound
// it, by a little.
//
// Design: the FlashAttention-2 split, three launches and no atomics, so the
// result is deterministic:
//   1. attn_bwd_rowdot: D_i = sum_d dO[i, d] * o[i, d] in fp32, one warp a row;
//   2. attn_bwd_dkdv: one block per (b, h, 64-key tile). K and V stay in
//      shared memory while every 64-query tile of q and dO streams through;
//      the block recomputes S^T and dP^T = V dO^T for the tile, forms P^T and
//      dS^T = P^T * (dP^T - D) in shared memory and accumulates
//      dV += P^T dO and dK += dS^T q in fp32 registers;
//   3. attn_bwd_dq: one block per (b, h, 64-query tile). q and dO stay while
//      K and V tiles stream; dQ += dS K in fp32 registers.
// No tile is skipped, so the fully masked row's rule holds everywhere (the
// cost: causal attention does the full Tq x Tk work). Like the forward, the
// products are scalar fp32 FMAs on the CUDA cores, so fp32 stays exact to fp32
// rounding, but the kernels are bound by arithmetic and not by bytes: each
// recomputes S and dP (the dkdv and dq kernels both form them, 4 of the 7
// products the split needs), and leaves the tensor cores (mma.sync / wgmma),
// TMA and a split of the query loop across blocks at small B*H on the table.
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

namespace {

constexpr int kBlock = 64;        // queries or keys per tile
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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Tensor4& t, int b, int h) {
  return static_cast<const T*>(t.ptr) + b * t.sb + h * t.sh;
}

// Copy rows t0 .. t0+63 of one (b, h) slice into a shared tile with rows
// padded to ld floats; rows at or past n are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long st, int t0, int n, int D) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = t0 + r;
    dst[r * ld + d] = t < n ? load_f(src + t * st + d) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_rowdot(Params p,
                                                            int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int i = row % p.Tq;
  const int bh = row / p.Tq;
  const int b = bh / p.H, h = bh % p.H;
  const T* o = row_ptr<T>(p.o, b, h) + i * p.o.st;
  const T* g = row_ptr<T>(p.dout, b, h) + i * p.dout.st;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(load_f(o + d), load_f(g + d), acc);
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

template <typename T>
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

  load_tile(Ks, ld, row_ptr<T>(p.k, b, h), p.k.st, k0, p.Tk, D);
  load_tile(Vs, ld, row_ptr<T>(p.v, b, h), p.v.st, k0, p.Tk, D);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < p.Tq; q0 += kBlock) {
    __syncthreads();  // the previous tile's P^T, dS^T, q and dO are consumed
    load_tile(Qs, ld, row_ptr<T>(p.q, b, h), p.q.st, q0, p.Tq, D);
    load_tile(Gs, ld, row_ptr<T>(p.dout, b, h), p.dout.st, q0, p.Tq, D);
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

  T* dk_out = static_cast<T*>(const_cast<void*>(p.dk.ptr)) + b * p.dk.sb +
              h * p.dk.sh;
  T* dv_out = static_cast<T*>(const_cast<void*>(p.dv.ptr)) + b * p.dv.sb +
              h * p.dv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        store_f(dk_out + t * p.dk.st + col, dk[i][c]);
        store_f(dv_out + t * p.dv.st + col, dv[i][c]);
      }
    }
  }
}

template <typename T>
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

  load_tile(Qs, ld, row_ptr<T>(p.q, b, h), p.q.st, q0, p.Tq, D);
  load_tile(Gs, ld, row_ptr<T>(p.dout, b, h), p.dout.st, q0, p.Tq, D);
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
    load_tile(Ks, ld, row_ptr<T>(p.k, b, h), p.k.st, k0, p.Tk, D);
    load_tile(Vs, ld, row_ptr<T>(p.v, b, h), p.v.st, k0, p.Tk, D);
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

  T* dq_out = static_cast<T*>(const_cast<void*>(p.dq.ptr)) + b * p.dq.sb +
              h * p.dq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store_f(dq_out + t * p.dq.st + col, dq[i][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int rows = B * p.H * p.Tq;
  attn_bwd_rowdot<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                       0, stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_bytes = sizeof(float) * smem_floats(p.D, 2);
  err = cudaFuncSetAttribute(attn_bwd_dkdv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_bytes));
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv<T><<<dim3((p.Tk + kBlock - 1) / kBlock, B * p.H), kThreads,
                     dkdv_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_bytes = sizeof(float) * smem_floats(p.D, 1);
  err = cudaFuncSetAttribute(attn_bwd_dq<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  attn_bwd_dq<T><<<dim3((p.Tq + kBlock - 1) / kBlock, B * p.H), kThreads,
                   dq_bytes, stream>>>(p);
  return cudaGetLastError();
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
// 24 values. rowdot is (B, H, Tq) fp32 scratch.
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
  if (dtype == 0) return static_cast<int>(launch<float>(p, B, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, B, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
