// Device helpers shared by the attention kernels of flash_attention.cu and
// flash_attention_bwd.cu: asynchronous 16-byte copies (cp.async) and the
// staging of bf16 and fp32 tiles with them, ldmatrix loads of bf16 tiles
// from shared memory, the m16n8k16 bf16 tensor-core product with fp32
// accumulators (mma.sync), the head_dim and block shape a bf16 kernel is
// built for, and the rule that decides which keys a batch row lets a
// kernel skip without changing its result.
//
// Fragment layout of mma.sync.aligned.m16n8k16 (lane l, g = l >> 2,
// t = l & 3): the fp32 accumulator c[0..3] holds (row g, cols 2t, 2t+1) and
// (row g+8, cols 2t, 2t+1) of the 16 x 8 tile; the A operand a[0..3] holds
// (row g, cols 2t..2t+1), (row g+8, cols 2t..2t+1), (row g, cols 2t+8..+9),
// (row g+8, cols 2t+8..+9) of the 16 x 16 tile, two bf16 a register, the
// lower column in the low half; the B operand b[0..1] holds (rows 2t..2t+1,
// col g) and (rows 2t+8..+9, col g) of the 16 x 8 tile. So an accumulator
// pair of 8-column tiles, rounded to bf16, is the A operand of the next
// product with no shuffle, and a row's values sit in the 4 lanes of equal g.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_tc {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; when !valid
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i's fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (for a B operand stored with
// its k dimension along the rows).
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, bf16) * b (16 x 8, bf16), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand for keys (or queries) 16j..16j+15 from the accumulators of
// the 8-column tiles 2j and 2j+1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Eight fp32 values as eight bf16 in one 16-byte store (dst 16-byte
// aligned).
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float x[8]) {
  uint4 v;
  v.x = pack_bf16(x[0], x[1]);
  v.y = pack_bf16(x[2], x[3]);
  v.z = pack_bf16(x[4], x[5]);
  v.w = pack_bf16(x[6], x[7]);
  *reinterpret_cast<uint4*>(dst) = v;
}

// Copy rows t0 .. t0+rows-1 of a (T, D) bf16 slice with row stride st into
// a shared tile with row stride ld, 16 bytes a cp.async; rows at or past n
// are zero-filled. Columns D .. ld-1 are not written. Of nthreads threads
// (a multiple of 16), thread i copies chunk i % 16 of rows i / 16,
// i / 16 + nthreads / 16, ... (nothing when that chunk is at or past D), so
// a row's address is one multiply-add and no division is needed.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long st, int t0, int n,
                                          int rows, int D, int tid,
                                          int nthreads) {
  const int c = tid & 15;
  if (c >= (D >> 3)) return;
  for (int r = tid >> 4; r < rows; r += nthreads >> 4) {
    const int t = t0 + r;
    const bool ok = t < n;
    cp_async16(dst + r * ld + c * 8, src + (ok ? t * st : 0) + c * 8, ok);
  }
}

// Zero columns D .. Dp-1 (both multiples of 8) of `rows` rows: the
// products then run over Dp with no effect from the fill.
__device__ __forceinline__ void zero_tail(__nv_bfloat16* dst, int ld,
                                          int rows, int D, int Dp, int tid,
                                          int nthreads) {
  const int chunks = (Dp - D) >> 3;
  if (chunks == 0) return;
  for (int idx = tid; idx < rows * chunks; idx += nthreads) {
    const int r = idx / chunks, c = idx - r * chunks;
    *reinterpret_cast<uint4*>(dst + r * ld + D + c * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// The fp32 designs stage a (rows, D) slice as rows of Dp + 4 floats (Dp the
// compiled-in head_dim, 16, 64 or 128): one ld.shared.v4 then reads 4
// values of d, and the 4-float pad puts the rows that a quarter-warp reads
// in distinct banks.
//
// Copy rows t0 .. t0+Rows-1 of a (T, D) fp32 slice with row stride st into
// such a tile, 16 bytes a cp.async; rows at or past n are zero-filled,
// columns D .. Dp-1 are not written. Thread i of Threads copies chunk
// i % (Dp / 4) of rows i / (Dp / 4), ... (a compile-time power of two: no
// division).
template <int Dp, int Rows, int Threads>
__device__ __forceinline__ void stage_rows_fp32(float* dst, const float* src,
                                                long long st, int t0, int n,
                                                int D, int tid) {
  constexpr int kChunks = Dp / 4;
  for (int idx = tid; idx < Rows * kChunks; idx += Threads) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (c * 4 >= D) continue;
    const int t = t0 + r;
    const bool ok = t < n;
    cp_async16(dst + r * (Dp + 4) + c * 4, src + (ok ? t * st : 0) + c * 4,
               ok);
  }
}

// Zero columns D .. Dp-1 (multiples of 8) of `rows` staged fp32 rows.
template <int Dp, int Threads>
__device__ __forceinline__ void zero_cols_fp32(float* dst, int rows, int D,
                                               int tid) {
  const int chunks = (Dp - D) / 4;
  for (int idx = tid; idx < rows * chunks; idx += Threads) {
    const int r = idx / chunks, c = idx - r * chunks;
    *reinterpret_cast<float4*>(dst + r * (Dp + 4) + D + c * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The head_dim an fp32 kernel is built for: 16 (the aux decoders'), 64
// (HuBERT's) or 128 (the encoder's and decoder's); a head_dim below it is
// zero-filled in shared memory.
inline int fp32_width_for(int D) { return D <= 16 ? 16 : D <= 64 ? 64 : 128; }

// 2^x on the special-function unit (ex2.approx, about 2^-22 relative
// error; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether key t is padded (false past Tk: those keys are masked apart).
__device__ __forceinline__ bool key_padded(const uint8_t* kpm, int t,
                                           int Tk) {
  return kpm && t < Tk && kpm[t];
}

// Barrier over the nthreads threads of one split of a block (ids 1..15;
// id 0 is __syncthreads).
__device__ __forceinline__ void split_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// The 16-wide steps over head_dim a bf16 kernel is built for, a template
// argument so that its products unroll with no branch: 1 for head_dim 8
// and 16 (the aux decoders'), else 8 (the encoder's and decoder's 128);
// columns from head_dim up to 16 steps are zero-filled in shared memory.
inline int ksteps_for(int D) { return D <= 16 ? 1 : 8; }

// The block shape of a bf16 kernel: `warps` warps of 16 rows own its
// 16 * warps resident rows (queries, or keys for dK/dV), and `splits`
// groups of them split the streamed loop. bh is B * H, t the resident
// length. An SM wants 8 warps or more, two a scheduler, to hide the
// latency of each warp's chain of copies, ldmatrix, mma and shuffles:
//   - a grid of up to one 32-row block an SM (served batches of a few
//     utterances) gets 4 splits of 2 warps a block;
//   - up to two (the smoke's training batch): 64-row blocks, 2 splits of
//     4 warps, one block an SM;
//   - beyond (batches of the recipe's size): 64-row blocks of 4 warps, no
//     split; 64 queries (or keys) share each streamed tile, and registers
//     fit 2-3 blocks an SM.
struct Tiles {
  int warps, splits;
};
inline Tiles tiles_for(int bh, int t) {
  const int n = sm_count();
  const int blocks = (t + 31) / 32 * bh;  // blocks of 32 rows
  if (blocks <= n) return {2, 4};
  if (blocks <= 2 * n) return {4, 2};
  return {4, 1};
}

// Which keys of a batch row can carry weight. Returns kend: keys at or past
// kend are padded and skipping them is exact, because every row of the
// batch row has a valid key whose score (|s| << 1e9) sets the row max, so a
// padded key's exp(-1e9 - m) is 0 in fp32. That holds when the row has a
// valid key (non-causal) or when key 0 is valid (causal: every row sees
// key 0). Otherwise, a row with no valid key averages every key, and
// nothing is skipped (kend = Tk). *causal_skip says whether keys strictly
// above a row's diagonal may be skipped too: causal and key 0 valid, so
// every row's max is at least its key-0 score and exp(s - 1e9 - m) = 0.
// Every thread of the block must call it; red is 32 ints of shared memory.
__device__ __forceinline__ int live_keys(const uint8_t* kpm, int Tk,
                                         bool causal, bool* causal_skip,
                                         int* red) {
  if (!kpm) {
    *causal_skip = causal;
    return Tk;
  }
  int last = -1;
  for (int t = threadIdx.x; t < Tk; t += blockDim.x)
    if (!kpm[t]) last = t;
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = last;
  __syncthreads();
  last = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    last = max(last, red[w]);
  __syncthreads();  // red may be reused
  const bool key0 = !kpm[0];
  *causal_skip = causal && key0;
  const bool skip = causal ? key0 : last >= 0;
  return skip ? last + 1 : Tk;
}

}  // namespace attn_tc
