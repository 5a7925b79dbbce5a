// Hand-written Hopper (sm_90a) flash-attention forward kernel for f32
// operands, on the tensor cores in 3xTF32.
//
//   flash_fwd  replaces mpi4jax_tpu/ops/flash.py:_kernel (launched by
//              _flash_fwd_impl) for f32 operands: softmax(scale * q k^T) v
//              over key tiles with an online softmax, f32 statistics and
//              accumulator, causal masking with static offsets,
//              grouped-query heads, and optionally the per-row statistics
//              m and l.  bf16 operands go to the bf16 tensor-core kernel
//              of flash_fwd_mma.cu.
//
// Layout: q and out are row-major [B, Tq, Hq, D], k and v [B, Tk, Hkv, D],
// read with strides (no fold, no padding copy); every row must start on
// a 16-byte boundary (the wrapper checks the base pointers).  Query head
// h reads kv head h / (Hq / Hkv).  m and l are f32 [B*Hq, Tq], row
// b*Hq + h, as the Pallas kernel's folded (m, l) outputs.
//
// Semantics kept from the Pallas kernel, term by term:
//   * the scale rides q: q = f32(q) * scale, then s = q . k in f32;
//   * the running max starts at the finite _NEG = -0.7 * FLT_MAX, never
//     -inf; causally masked real keys get _NEG, keys at or past Tk get
//     -inf, so a fully masked row ends as uniform weights over the real
//     keys (the mean of V) and padding never enters l;
//   * per key tile: m_new = max(m, max_j s_j), corr = exp(m - m_new),
//     w_j = exp(s_j - m_new) (expf, f32 weights: nothing is rounded to
//     bf16), l = l * corr + sum_j w_j, acc = acc * corr + sum_j w_j v_j;
//   * out = acc / l; m and l are written separately, never fused into
//     m + log l.
// Key tiles that lie wholly above the causal diagonal are skipped only
// when every row of the query tile sees key 0: such a tile then has
// w == 0 exactly and corr == 1, so skipping it changes nothing.  A query
// tile with a fully masked row visits every tile, as the uniform-weights
// convention needs.
//
// f32 products on the tensor cores (3xTF32).  mma.sync takes TF32
// operands: 10 explicit mantissa bits, not f32's 23.  Each f32 operand x
// is split into big = tf32(x) and small = tf32(x - big), both rounded to
// nearest even at the 13th bit (tf32_round); x - big is exact, so big +
// small is x to within 2^-22 of |x|.  A product is taken as
// big*big + big*small + small*big (three mma.sync), the small*small term
// (about 2^-22 of the product) dropped: f32-class products, where one
// TF32 product alone errs by about 2^-11.  The tensor cores' own f32
// accumulation is not round-to-nearest, and its error grows with the
// number of products it runs over: carried over the 16 k-steps of a
// score at D = 128 it moved l by 9.3e-6 of itself at the training shape,
// against the 1e-5 limit (PERF.md §6).  So each k-step's three products of a score
// are summed by mma.sync into a zeroed fragment and added to the score
// on the CUDA cores, and each tile's P V likewise into the f32
// accumulator (acc * corr + part, two roundings, as the Pallas kernel).
// Statistics, corr, masks and expf stay on the CUDA cores in f32.
//
// What bounds it on the card: operations.  Causal attention at the
// training shape ([2, 8192, 16, 128]) does 5.5e11 flops on 537 MB in f32,
// far above the H100's operations-per-byte balance.  f32-class products
// run at most at 494.7 / 3 = 165 TFLOP/s on the TF32 tensor cores
// (three products each), against 67 on the CUDA cores.
//
// Design (FlashAttention-2 style, warp-level mma.sync.m16n8k8 in TF32):
//   * one block of 8 warps per (b*Hq + h, 64-row query tile), heaviest
//     query tiles first (blockIdx.y counts down the diagonal).  Each warp
//     owns 16 query rows and one 16-key half of every key tile, and keeps
//     its own online softmax (m, l, acc) over the keys of its half; at
//     the end the second half's warps hand their state through shared
//     memory to the first half's, which merge the two as corr merges
//     tiles (m = max of the two, each side rescaled by exp(m_half - m))
//     and write the rows.  The split into halves puts two warps on each
//     of the SM's four schedulers: shared memory (168,960 bytes at D =
//     128) admits one block per SM, and one warp per scheduler left the
//     tensor cores waiting (4 warps ran the training shape about 1.5x
//     slower; PERF.md §6);
//   * the Q tile is staged once through cp.async and split in place into
//     two shared-memory planes (big, small) after scaling; K and V tiles
//     of 32 keys go into a two-stage cp.async ring (16 bytes a copy,
//     zero-filled past Tk), the next tile's copy in flight during this
//     tile's math, and each arriving tile is split in place (big) and
//     into one small plane per operand, once per block rather than once
//     per warp;
//   * rows are padded by 4 floats, so the two fragment patterns read
//     with plain 32-bit loads are free of bank conflicts: an A or B
//     fragment of a row-major operand (lane reads row lane/4, column
//     lane % 4, banks 4 (lane/4) + lane % 4) and the B fragment of V in
//     P V (lane reads row 2 (lane % 4), column lane/4, banks
//     8 (lane % 4) + lane/4);
//   * S = Q K^T per tile and key half; the online softmax runs on the C
//     fragment in registers (rows lane/4 and lane/4 + 8, columns
//     2 (lane % 4) and +1; a row's max and sum reduce over the 4 lanes of
//     a quad);
//   * P V takes the weights straight from the C fragments as A
//     fragments: the C fragment holds columns 2t, 2t+1 where the A
//     fragment wants t, t+4, so the 8 keys of a k-step are taken in the
//     order 0, 2, 4, 6, 1, 3, 5, 7 on both sides (a0 = c0, a1 = c2,
//     a2 = c1, a3 = c3; V's row for fragment index t is key 2t); a sum
//     over keys does not depend on their order;
//   * masks are applied only on the tiles that need them (the diagonal
//     tiles and the padded last tile).
// Shared memory: the Q planes (2 x 64 rows), the K/V ring (2 x 2 x 32)
// and the small planes of K and V (2 x 32), rows of D + 4 floats: 168,960
// bytes at D = 128, which needs cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Built with -fmad=false (see _build.py): the CUDA-core arithmetic rounds
// every product and sum on its own, as the plain PyTorch version does.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRowGroups = 4;            // warps of 16 query rows a half
constexpr int kBlockQ = 16 * kRowGroups;  // query rows per block
constexpr int kBlockK = 32;               // keys per shared-memory tile
constexpr int kHalfK = kBlockK / 2;       // keys of a tile per key half
constexpr int kPad = 4;                   // floats of padding per row
constexpr int kThreads = 2 * 32 * kRowGroups;  // two key halves
// tensor-core products per f32 product: big*small, small*big, big*big
constexpr int kProducts = 3;
// _NEG of the JAX package: the double product rounded to float.
constexpr float kNeg = static_cast<float>(-0.7 * 3.4028234663852886e38);

// ---- PTX helpers: the kernel's only inline assembly ----

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes is 16, or 0 to
// zero-fill the destination without reading the source.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b for a 16x8 TF32 A (a0: row lane/4, column lane % 4; a1: row
// +8; a2, a3: the same at column +4), an 8x8 TF32 B (b0: row lane % 4,
// column lane/4; b1: row +4) and a 16x8 f32 accumulator (rows lane/4 and
// +8, columns 2 (lane % 4) and +1)
__device__ __forceinline__ void mma_1688(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- end of the PTX helpers ----

// x rounded to TF32 (10 explicit mantissa bits), to nearest even: the
// low 13 bits of the f32 pattern cleared after adding half of their
// weight, less one when the kept last bit is 0.  Exact mirror:
// kernels/flash.py:tf32_split.  Finite x of magnitude at most
// (2 - 2^-11) 2^127 stays finite.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0xfffu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xffffe000u);
}

// f32 operand x as its TF32 terms: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void tf32_split(float x, float& big,
                                           float& small) {
  big = tf32_round(x);
  small = tf32_round(x - big);  // x - big is exact
}

// acc += part, on the CUDA cores (round to nearest)
__device__ __forceinline__ void accumulate(float (&acc)[4],
                                           const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = acc[e] + part[e];
}

// d += a b in 3xTF32: the small products first, then big*big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  if (kProducts == 3) {
    mma_1688(d, a_big, b_small[0], b_small[1]);
    mma_1688(d, a_small, b_big[0], b_big[1]);
  }
  mma_1688(d, a_big, b_big[0], b_big[1]);
}

__device__ __forceinline__ uint32_t bits(float x) {
  return __float_as_uint(x);
}

// A 16x8 C fragment (rows lane/4, +8; columns 2 (lane % 4), +1) of f32
// values as the split A fragment of the product that sums over its 8
// columns, taken in the order 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ void split_c_as_a(const float (&c)[4],
                                             uint32_t (&big)[4],
                                             uint32_t (&small)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float hi, lo;
    tf32_split(a[i], hi, lo);
    big[i] = bits(hi);
    small[i] = bits(lo);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr int smem_bytes() {
  return (2 * kBlockQ + 6 * kBlockK) * (D + kPad) *
         static_cast<int>(sizeof(float));
}

// Stage rows [row0, row0 + rows) of a [T, D] operand (consecutive rows
// `stride` elements apart) into shared rows of D + kPad floats; rows at
// or past `limit` are zero-filled without a read.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int row0, int rows,
                                           int limit) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = row0 + r < limit;
    const float* from =
        src + static_cast<size_t>(in ? row0 + r : 0) * stride + c * 4;
    cp_async_16(dst + r * (D + kPad) + c * 4, from, in ? 16 : 0);
  }
}

// Split `rows` staged rows in place: each element x becomes
// big = tf32(x * factor) where it is and small = tf32(x * factor - big)
// at the same place in `small`.
template <int D>
__device__ __forceinline__ void split_rows(float* big, float* small, int rows,
                                           float factor) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int off = (idx / kChunks) * (D + kPad) + (idx % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(big + off);
    float4 hi, lo;
    tf32_split(x.x * factor, hi.x, lo.x);
    tf32_split(x.y * factor, hi.y, lo.y);
    tf32_split(x.z * factor, hi.z, lo.z);
    tf32_split(x.w * factor, hi.w, lo.w);
    *reinterpret_cast<float4*>(big + off) = hi;
    *reinterpret_cast<float4*>(small + off) = lo;
  }
}

// The second bound is the blocks per SM that shared memory admits: at
// D = 128 one.  Left to its default, ptxas held the kernel to 128
// registers for two blocks and spilled, and ran the training shape about
// 1.2x slower than with 240 registers (PERF.md §6).
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int Tq, int Tk, int Hq, int Hkv, int causal,
                 long long q_offset, long long k_offset, float scale) {
  constexpr int kStride = D + kPad;          // floats per shared row
  constexpr int kSteps = D / 8;              // k-steps of Q K^T
  constexpr int kKeyBlocks = kHalfK / 8;     // n-blocks of S, k-steps of P V
  constexpr int kDimBlocks = D / 8;          // n-blocks of the output
  constexpr int kTile = kBlockK * kStride;   // floats per K or V stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_big = reinterpret_cast<float*>(smem);
  float* q_small = q_big + kBlockQ * kStride;
  float* ks = q_small + kBlockQ * kStride;  // [2][kTile]: raw, then big
  float* vs = ks + 2 * kTile;               // [2][kTile]: raw, then big
  float* k_small = vs + 2 * kTile;          // [kTile]
  float* v_small = k_small + kTile;         // [kTile]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int rg = warp % kRowGroups;  // this warp's 16 rows of the block
  const int kh = warp / kRowGroups;  // and its key half of every tile
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column t (A, B), pair 2t, 2t + 1 (C)
  const int row0 = q0 + 16 * rg;  // this warp's first query row

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const float* q_rows = q + (static_cast<size_t>(b) * Tq * Hq + h) * D;
  const float* k_rows = k + (static_cast<size_t>(b) * Tk * Hkv + hk) * D;
  const float* v_rows = v + (static_cast<size_t>(b) * Tk * Hkv + hk) * D;

  // key tiles to visit: all of them, or (causal, every row of the tile
  // sees key 0) those up to the last row's diagonal
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal && q_offset + q0 >= k_offset) {
    const int last_row = min(q0 + kBlockQ, Tq) - 1;
    const long long last_key = q_offset + last_row - k_offset;
    const long long needed = last_key / kBlockK + 1;
    if (needed < n_tiles) n_tiles = static_cast<int>(needed);
  }

  stage_rows<D>(q_big, q_rows, q_stride, q0, kBlockQ, Tq);
  stage_rows<D>(ks, k_rows, kv_stride, 0, kBlockK, Tk);
  stage_rows<D>(vs, v_rows, kv_stride, 0, kBlockK, Tk);
  cp_async_commit();

  float acc[kDimBlocks][4];
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m_row[2] = {kNeg, kNeg};  // rows g and g + 8
  float l_row[2] = {0.0f, 0.0f};
  const long long qpos[2] = {q_offset + row0 + g, q_offset + row0 + g + 8};
  // this lane's A fragment offset in the Q planes, and its B fragment
  // offsets in its key half of a K tile (row-major pattern) and of a V
  // tile (P V pattern)
  const int a_off = (16 * rg + g) * kStride + t;
  const int kb_off = (kHalfK * kh + g) * kStride + t;
  const int vb_off = (kHalfK * kh + 2 * t) * kStride + g;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) * kBlockK;
      stage_rows<D>(ks + (stage ^ 1) * kTile, k_rows, kv_stride, next,
                    kBlockK, Tk);
      stage_rows<D>(vs + (stage ^ 1) * kTile, v_rows, kv_stride, next,
                    kBlockK, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V (and Q) are in shared memory
    float* kt = ks + stage * kTile;
    float* vt = vs + stage * kTile;
    if (tile == 0) split_rows<D>(q_big, q_small, kBlockQ, scale);
    split_rows<D>(kt, k_small, kBlockK, 1.0f);
    split_rows<D>(vt, v_small, kBlockK, 1.0f);
    __syncthreads();  // the split planes are complete
    const int k0 = tile * kBlockK;

    // S = Q K^T over this warp's key half: A from the Q planes (rows
    // 16 rg + g, +8; dims 8 st + t, +4), B from the K planes (key
    // 16 kh + 8 n + g; dims 8 st + t, +4)
    float s[kKeyBlocks][4];
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int ao = a_off + 8 * st;
      const uint32_t a_big[4] = {
          bits(q_big[ao]), bits(q_big[ao + 8 * kStride]),
          bits(q_big[ao + 4]), bits(q_big[ao + 8 * kStride + 4])};
      const uint32_t a_small[4] = {
          bits(q_small[ao]), bits(q_small[ao + 8 * kStride]),
          bits(q_small[ao + 4]), bits(q_small[ao + 8 * kStride + 4])};
#pragma unroll
      for (int n = 0; n < kKeyBlocks; ++n) {
        const int bo = kb_off + 8 * n * kStride + 8 * st;
        const uint32_t b_big[2] = {bits(kt[bo]), bits(kt[bo + 4])};
        const uint32_t b_small[2] = {bits(k_small[bo]),
                                     bits(k_small[bo + 4])};
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(part, a_big, a_small, b_big, b_small);
        accumulate(s[n], part);
      }
    }

    // mask; element e of n-block n is row g + 8 (e / 2), key
    // k0 + 16 kh + 8 n + 2 t + e % 2
    const bool mask_causal =
        causal && k_offset + k0 + kBlockK - 1 > q_offset + q0;
    const bool mask_pad = k0 + kBlockK > Tk;
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        const int key = k0 + kHalfK * kh + 8 * n + 2 * t + e % 2;
        if (mask_causal && qpos[e / 2] < k_offset + key) x = kNeg;
        if (mask_pad && key >= Tk) x = -INFINITY;
        s[n][e] = x;
        tile_max[e / 2] = fmaxf(tile_max[e / 2], x);
      }
    }

    float corr[2];
    float m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_row[r], quad_max(tile_max[r]));
      corr[r] = expf(m_row[r] - m_new[r]);
      m_row[r] = m_new[r];
    }
    // the f32 weights, split into the A fragments of P V: k-step j is
    // n-block j, its keys in the order 0, 2, 4, 6, 1, 3, 5, 7
    float w_sum[2] = {0.0f, 0.0f};
    uint32_t p_big[kKeyBlocks][4];
    uint32_t p_small[kKeyBlocks][4];
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = expf(s[n][e] - m_new[e / 2]);
        w_sum[e / 2] = w_sum[e / 2] + w[e];
      }
      split_c_as_a(w, p_big[n], p_small[n]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] = l_row[r] * corr[r] + quad_sum(w_sum[r]);
    }

    // acc = acc * corr + P V: V's B fragment for n-block n (dims 8 n +
    // lane/4) of k-step j holds keys 16 kh + 8 j + 2 t (b0) and + 1 (b1)
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kKeyBlocks; ++j) {
        const int bo = vb_off + 8 * j * kStride + 8 * n;
        const uint32_t b_big[2] = {bits(vt[bo]), bits(vt[bo + kStride])};
        const uint32_t b_small[2] = {bits(v_small[bo]),
                                     bits(v_small[bo + kStride])};
        mma_3xtf32(part, p_big[j], p_small[j], b_big, b_small);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = acc[n][e] * corr[e / 2] + part[e];
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // the two key halves' states of a row meet: the second half's warps
  // hand (m, l, acc) through shared memory (the Q planes, read no more)
  // to the first half's, which merge them, rescaling each by
  // exp(m_half - m) as corr rescales tiles, and write the row
  constexpr int kState = 4 + 4 * kDimBlocks;  // floats per lane
  float* xs = q_big + (32 * rg + lane);       // stride 32 kRowGroups
  constexpr int kXStride = 32 * kRowGroups;
  if (kh == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xs[r * kXStride] = m_row[r];
      xs[(2 + r) * kXStride] = l_row[r];
    }
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 + 4 * n + e) * kXStride] = acc[n][e];
    }
  }
  static_assert(kState * kXStride <= 2 * kBlockQ * (D + kPad),
                "the merge state fits the Q planes");
  __syncthreads();
  if (kh == 1) return;
  float c_own[2];
  float c_other[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_other = xs[r * kXStride];
    const float m_new = fmaxf(m_row[r], m_other);
    c_own[r] = expf(m_row[r] - m_new);
    c_other[r] = expf(m_other - m_new);
    l_row[r] = l_row[r] * c_own[r] + xs[(2 + r) * kXStride] * c_other[r];
    m_row[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = acc[n][e] * c_own[e / 2] +
                  xs[(4 + 4 * n + e) * kXStride] * c_other[e / 2];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Tq) continue;
    float* o = out + ((static_cast<size_t>(b) * Tq + row) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      *reinterpret_cast<float2*>(o + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r] / l_row[r], acc[n][2 * r + 1] / l_row[r]);
    }
    if (m_out != nullptr && t == 0) {
      const size_t stat = static_cast<size_t>(bh) * Tq + row;
      m_out[stat] = m_row[r];
      l_out[stat] = l_row[r];
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m_out, float* l_out, int B, int Tq, int Tk, int Hq,
                   int Hkv, int causal, long long q_offset,
                   long long k_offset, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Tq + kBlockQ - 1) / kBlockQ);
  const dim3 block(kThreads);
  flash_fwd_kernel<D><<<grid, block, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), m_out, l_out,
      Tq, Tk, Hq, Hkv, causal, q_offset, k_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 operands only.  m_out and l_out are both null or both f32
// [B*Hq, Tq].  The wrapper (kernels/flash.py) checks shapes, types,
// contiguity, 16-byte alignment, D in {32, 64, 128}, Hq % Hkv == 0 and
// Tk >= 1.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     float* m_out, float* l_out, int B, int Tq, int Tk,
                     int Hq, int Hkv, int D, int causal, long long q_offset,
                     long long k_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, m_out, l_out, B, Tq, Tk, Hq, Hkv,
                        causal, q_offset, k_offset, scale, stream);
    case 64:
      return launch<64>(q, k, v, out, m_out, l_out, B, Tq, Tk, Hq, Hkv,
                        causal, q_offset, k_offset, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, m_out, l_out, B, Tq, Tk, Hq, Hkv,
                         causal, q_offset, k_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
