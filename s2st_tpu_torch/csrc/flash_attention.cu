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
// fp32 (the HuBERT frontend and every fp32 run): fp32 FMAs on the CUDA
// cores from register tiles, K and V streamed through a cp.async ring, the
// head_dim compiled in; the note at the head of the fp32 section below.
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
//
// The fp32 design replaces the same TPU kernel (the Pallas flash forward
// behind s2st_tpu/nn/attention.py::attend_flash, :44-88) where the input is
// fp32: the HuBERT frontend's 12 self-attention layers (under --fp16 it
// computes in fp32 past its GroupNorm, as JAX's does; B=16, T'=511 keys of
// which 199-499 are valid, H=12, D=64) and every fp32 run. Products are
// fp32 FMAs on the CUDA cores: the tensor cores would take fp32 as TF32,
// with about three decimal digits, which cannot hold the 1e-5 agreement
// the fp32 checks ask for; fp32 sums in another order can.
//
// Bound at the HuBERT shape: operations. The valid keys' 4 * H * D FLOPs a
// (query, key) pair come to 8.76 GFLOP, 0.1308 ms at the card's 67 TFLOP/s
// of fp32 FMAs; its bytes (q, k, v, o, 50 MB) take 0.015 ms.
//
// What held the first (scalar) design back, at 9.65x that bound and 2.6x
// SDPA: the head_dim was read at run time, so at D=64 half of the P V
// FMAs were masked zeros; each thread read every operand from shared
// memory as a 4-byte scalar (8 reads for 16 FMAs in S = Q K^T, 12 for 32 in
// P V), so shared memory, not the FMA pipes, set the rate; K, the scores,
// the softmax (one row a warp, 10 shuffles a row) and V ran one after
// another behind four __syncthreads a tile; no key tile was skipped; and
// global loads were scalar with an integer division an element.
//
// What this design does about each:
//   - The head_dim Dp is a template argument, 16, 64 or 128 (the widths on
//     the paths: the aux decoders', HuBERT's, the encoder's); a head_dim
//     below it is zero-filled in shared memory, so the loops unroll with
//     no mask and no run-time bound.
//   - Register tiles fed by 16-byte shared reads. A block of 128 threads
//     owns 64 queries (32 on grids too small to fill the card, rows_for)
//     and streams 32-key tiles; thread (ty, tx) = (tid / 8, tid % 8) owns
//     the 4 x 4 scores (2 x 4 in a 32-query block) of rows ty + 16 i and
//     keys tx + 8 j and the 4 x Dp / 8 outputs of the same rows. Q, K and V are staged
//     row-major (a row a query or key, d along it) with rows of Dp + 4
//     floats, so one ld.shared.v4 gives 4 values of d: S takes 8 of them
//     (4 of Q, 4 of K) for 64 FMAs, and P V 12 (4 of P, 8 of V) for 128 at
//     D=64. K need not be staged transposed: 16-byte cp.async cannot
//     transpose, and K's rows read along d feed the FMAs as well. The
//     row padding puts the 8 keys that a quarter-warp reads, and the 4
//     rows that the 4 quarters read, in distinct banks; the P tile's rows
//     of 40 floats do the same for P's writes and reads.
//   - K and V stream through a 2-stage ring of 16-byte cp.async: tile
//     i + 1 is copied while tile i's products run, and a tile costs two
//     __syncthreads (the tile has landed; P is in place). Each row's
//     running max and sum stay in the registers of the 8 threads (one
//     quarter-warp) that own it: the max is reduced over those 8 lanes
//     (3 shuffles a row a tile), each thread keeps its share of the sum,
//     and the shares are added once, at the end. P goes through shared
//     memory for P V: each thread needs its rows' 32 probabilities, which
//     8 lanes hold; shuffles would take 4 a key for 32 FMAs, where shared
//     memory takes one 16-byte read for 4 keys.
//   - Tiles are skipped exactly where the bf16 design skips them
//     (attention_tc.cuh::live_keys): padded tail tiles when the batch row
//     has a valid key (non-causal) or key 0 is valid (causal), and causal
//     tiles wholly above the block's diagonal; a row with no valid key
//     skips nothing. A tile's key padding is a ballot word that every
//     warp builds from the tile's 32 mask bytes, read while the previous
//     tile's products run; a tile inside Tk with no padded key and not
//     above any row's diagonal skips the masks.
//   - Global reads are 16-byte cp.async with the head_dim known at
//     compile time (no division), outputs 16-byte stores (8-byte at
//     Dp = 16); the wrapper guarantees 16-byte aligned rows in fp32 too.
// expf stays (about 8 instructions a score, against 2 Dp FMAs): ex2 of
// log2(e)-scaled scores would save most of them but adds the rounding of
// the scaled score, |s - m| * 2^-24 relative, to every probability.
//
// Tiles of 32 keys, not 64: at Dp = 64 a 64-query block then takes 62,464
// bytes of shared memory, so three blocks (12 warps) share an SM, not two,
// and at Dp = 128 (111,616 bytes) two, not one. The extra warps hide the
// latency of the shared reads and of each block's barriers, which paid
// more than the 64-key tile's fewer reads a product (attention_tiles.py
// --fp32-tiles, PERF.md).

namespace fp32 {

constexpr int kKeys = 32;      // keys a streamed tile
constexpr int kThreads = 128;  // 16 row groups x 8 key/column groups
constexpr int kStages = 2;     // K/V tiles in the ring
constexpr int kLdP = kKeys + 8;
constexpr int kWords = kKeys / 32;  // ballot words of a tile's padding

// Queries a block: 32 when blocks of 32 number at most one an SM (a
// served batch of 4 utterances at D = 128: 16 heads of 8 such blocks), so
// that twice the SMs share the work; else 64, whose 4 rows a thread feed
// more FMAs a shared read (attention_tiles.py --fp32-tiles, PERF.md).
inline int rows_for(int bh, int Tq) {
  return (Tq + 31) / 32 * bh <= attn_tc::sm_count() ? 32 : 64;
}

__host__ __device__ constexpr int smem_bytes(int Dp, int R) {
  return 4 * ((R + kStages * 2 * kKeys) * (Dp + 4) + R * kLdP);
}

// Blocks an SM: as many as shared memory holds (232,448 bytes, 1 KB a
// block reserved), at most 3 so that a thread may keep 168 registers.
__host__ __device__ constexpr int blocks_per_sm(int Dp, int R) {
  return 232448 / (smem_bytes(Dp, R) + 1024) < 3
             ? 232448 / (smem_bytes(Dp, R) + 1024)
             : 3;
}

// R queries a block (64 or 32), rows ty + 16 i of it a thread.
template <int Dp, int R>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(Dp, R))
    flash_fwd_fp32(Params p) {
  using namespace attn_tc;
  constexpr int kI = R / 16;                   // rows a thread
  constexpr int kLd = Dp + 4;
  constexpr int kCols = Dp / 8;                // output columns a thread
  constexpr int kVec = kCols >= 4 ? 4 : 2;     // floats a read of V
  constexpr int kChunks = kCols / kVec;        // reads of V a key
  constexpr int kJ = kKeys / 8;                // scores a thread a row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KV = Qs + R * kLd;                    // [stage][K, V][kKeys][kLd]
  float* Ps = KV + kStages * 2 * kKeys * kLd;  // [R][kLdP]
  int* red = reinterpret_cast<int*>(Ps);       // live_keys', before P

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 3;  // rows ty + 16 i
  const int tx = tid & 7;   // keys tx + 8 j; columns 8 kVec c + kVec tx + x
  const int q0 = blockIdx.x * R;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int D = p.D;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* kpm = p.kpm ? p.kpm + b * p.kpm_sb : nullptr;
  auto ring = [&](int st, int kv) {
    return KV + (st * 2 + kv) * kKeys * kLd;
  };
  auto load_tile = [&](int j, int st) {
    stage_rows_fp32<Dp, kKeys, kThreads>(ring(st, 0), k, p.k_st, j * kKeys,
                                         p.Tk, D, tid);
    stage_rows_fp32<Dp, kKeys, kThreads>(ring(st, 1), v, p.v_st, j * kKeys,
                                         p.Tk, D, tid);
  };

  // Q and the first tile are in flight while the block finds the keys it
  // must visit
  zero_cols_fp32<Dp, kThreads>(Qs, R + kStages * 2 * kKeys, D, tid);
  stage_rows_fp32<Dp, R, kThreads>(Qs, q, p.q_st, q0, p.Tq, D, tid);
  load_tile(0, 0);
  cp_async_commit();
  bool pad[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    pad[w] = key_padded(kpm, 32 * w + lane, p.Tk);
  bool causal_skip;
  int kend = live_keys(kpm, p.Tk, p.causal != 0, &causal_skip, red);
  if (causal_skip) kend = min(kend, q0 + R);
  const int n_tiles = (kend + kKeys - 1) / kKeys;
  // the tile's padded keys: bit b of word w is key 32 w + b
  uint32_t pm[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) pm[w] = __ballot_sync(0xffffffffu, pad[w]);

  float acc[kI][kCols];
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  float m_run[kI], l_run[kI];  // l_run: this thread's share of the row sum
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = it * kKeys;
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; the last tile's P and ring reads done
    bool next[kWords] = {};
    if (it + 1 < n_tiles) {
      load_tile(it + 1, st ^ 1);
      cp_async_commit();
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        next[w] = key_padded(kpm, k0 + kKeys + 32 * w + lane, p.Tk);
    }
    const float* Kt = ring(st, 0);
    const float* Vt = ring(st, 1);

    // S = Q K^T, kI x kJ a thread
    float s[kI][kJ];
#pragma unroll
    for (int i = 0; i < kI; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dp; d += 4) {
      float4 qv[kI], kv[kJ];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kLd +
                                                 d);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kt + (tx + 8 * j) * kLd +
                                                 d);
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // masks, skipped (a block-uniform branch) for a tile of valid keys
    // inside Tk that is not above any of the block's rows' diagonals
    uint32_t any_pad = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) any_pad |= pm[w];
    const bool unmasked = any_pad == 0 && k0 + kKeys <= p.Tk &&
                          !(p.causal && k0 + kKeys - 1 > q0);
    if (!unmasked) {
#pragma unroll
      for (int i = 0; i < kI; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int kj = k0 + tx + 8 * j;
          float x = s[i][j];
          if (kj >= p.Tk) {
            x = -INFINITY;  // outside the sequence: no weight at all
          } else {
            if (p.causal && kj > q0 + ty + 16 * i) x += kNegInf;
            if ((pm[j / 4] >> (tx + 8 * (j & 3))) & 1u) x = kNegInf;
          }
          s[i][j] = x;
        }
    }

    // the online softmax: a row's max over the 8 lanes that own it
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kJ; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float pr = expf(s[i][j] - m_new);
        sum += pr;
        Ps[(ty + 16 * i) * kLdP + tx + 8 * j] = pr;
      }
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is in place

    // O += P V: 4 keys of P a 16-byte read
#pragma unroll 4
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pv[kI];
#pragma unroll
      for (int i = 0; i < kI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdP +
                                                 kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vt + (kk + e) * kLd + kVec * tx;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float vv[kVec];
          if constexpr (kVec == 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(vrow + 8 * kVec * c);
            vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
          } else {
            const float2 x =
                *reinterpret_cast<const float2*>(vrow + 8 * kVec * c);
            vv[0] = x.x; vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < kI; ++i) {
            const float pr = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                           : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              acc[i][c * kVec + x] = fmaf(pr, vv[x], acc[i][c * kVec + x]);
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      pm[w] = __ballot_sync(0xffffffffu, next[w]);
  }

  // each row's sum over its 8 lanes; the outputs and the statistics
#pragma unroll
  for (int i = 0; i < kI; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    const float inv = 1.f / l;
    float* orow = o + t * p.o_st + kVec * tx;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (8 * kVec * c + kVec * tx >= D) continue;
      const int n = c * kVec;
      if constexpr (kVec == 4)
        *reinterpret_cast<float4*>(orow + 8 * kVec * c) =
            make_float4(acc[i][n] * inv, acc[i][n + 1] * inv,
                        acc[i][n + 2] * inv, acc[i][n + 3] * inv);
      else
        *reinterpret_cast<float2*>(orow + 8 * kVec * c) =
            make_float2(acc[i][n] * inv, acc[i][n + 1] * inv);
    }
    if (tx == 0 && p.row_max) {
      const long long at = static_cast<long long>(blockIdx.y) * p.Tq + t;
      p.row_max[at] = m_run[i];
      p.row_logsum[at] = logf(l);
    }
  }
}

template <int Dp, int R>
cudaError_t launch_rows(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(Dp, R);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32<Dp, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + R - 1) / R, B * p.H);
  flash_fwd_fp32<Dp, R><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The block shape rows_for picks for this grid.
template <int Dp>
cudaError_t launch_width(const Params& p, int B, cudaStream_t stream) {
  return rows_for(B * p.H, p.Tq) == 32 ? launch_rows<Dp, 32>(p, B, stream)
                                       : launch_rows<Dp, 64>(p, B, stream);
}

}  // namespace fp32

cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  switch (attn_tc::fp32_width_for(p.D)) {
    case 16: return fp32::launch_width<16>(p, B, stream);
    case 64: return fp32::launch_width<64>(p, B, stream);
    default: return fp32::launch_width<128>(p, B, stream);
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
