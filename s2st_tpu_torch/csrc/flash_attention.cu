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
//     valid key averages all Tk values, as `attend` does. No tile is skipped,
//     so that rule holds for every row;
//   - softmax statistics and the output accumulate in fp32; the output is
//     written in the input type (fp32 or bf16).
//
// Bound on the card. q, k, v and o each cross device memory once:
// 4 * B * T * H * D * bytes. At B=64, T'=150, H=4, D=128 in bf16 that is about
// 39 MB, about 12 us at 3.35 TB/s, against about 3 us of bf16 tensor-core time
// for the 4 * B * H * Tq * Tk * D operations: the function is memory-bound.
// At the serving path's B=4 it is a few MB and a launch costs more than either.
//
// Design, and what it does about that bound: one block per (b, h, 64-query
// tile); the query tile is read once into shared memory and stays there while
// 64-key tiles of K and then V stream through one shared buffer, so each input
// byte is read from device memory once per query tile and the scores live
// only in shared memory and registers. Each thread keeps a 4 x 8 slice of the
// output accumulator in registers; each warp owns 8 rows of the running max and
// sum. The products are scalar fp32 FMAs on the CUDA cores, which keeps the
// fp32 path exact to fp32 rounding but leaves the kernel bound by arithmetic,
// not bytes: wgmma, TMA and warp specialisation are later work.
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

namespace {

constexpr int kBlockM = 64;     // queries per block
constexpr int kBlockN = 64;     // keys per tile
constexpr int kMaxD = 128;      // largest head_dim; head_dim % 8 == 0
constexpr int kThreads = 256;   // 8 warps
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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory, in floats: Q tile and K/V tile with rows padded to D + 1
// (column reads across a warp hit distinct banks), the score/probability tile
// padded to kBlockN + 1, and per-row rescale factors and final sums.
__host__ __device__ inline int smem_floats(int D) {
  return 2 * kBlockM * (D + 1) + kBlockM * (kBlockN + 1) + 2 * kBlockM;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Params p) {
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;

  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = q0 + r;
    Qs[r * ld + d] = t < p.Tq ? load_f(q + t * p.q_st + d) : 0.f;
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
      KVs[r * ld + d] = t < p.Tk ? load_f(k + t * p.k_st + d) : 0.f;
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
      KVs[r * ld + d] = t < p.Tk ? load_f(v + t * p.v_st + d) : 0.f;
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
      if (col < D) store_f(o + t * p.o_st + col, acc[i][c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + kBlockM - 1) / kBlockM, B * p.H);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements.
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
    err = launch<float>(p, B, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(p, B, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
