// Hand-written Hopper (sm_90a) flash-attention backward kernels for bf16
// operands on the tensor cores.
//
//   flash_bwd_dkv_mma  replaces mpi4jax_tpu/ops/flash.py:_bwd_dkv_kernel
//                      (launched by _flash_bwd) for bf16 operands: dK and
//                      dV of one block of keys, accumulated over the query
//                      rows that see them.
//   flash_bwd_dq_mma   replaces mpi4jax_tpu/ops/flash.py:_bwd_dq_kernel
//                      for bf16 operands: dQ of one block of query rows,
//                      accumulated over the keys they see.
// f32 operands stay on the CUDA-core kernels of flash_bwd.cu.
//
// Layout: q, dO and dq are row-major [B, Tq, Hq, D], k, v, dk and dv
// [B, Tk, Hkv, D], read with strides (no fold, no padding copy); every
// row must start on a 16-byte boundary (the wrapper checks the base
// pointers).  Query head h reads kv head h / (Hq / Hkv).  m, l (the
// forward's row statistics) and delta = rowsum(f32(dO) * f32(out)) are
// f32 [B*Hq, Tq], row b*Hq + h.
//
// Semantics kept from the Pallas kernels' shared math (_bwd_block,
// mpi4jax_tpu/ops/flash.py:321-397), term by term:
//   * scores: s = (q . k) * scale, from exact bf16 x bf16 products (an
//     8-bit by 8-bit significand product fits f32's 24 bits) summed in
//     f32 by mma.sync.m16n8k16, the scale applied once to the f32 sum.
//     The Pallas kernels scale q (dkv) or k (dq) in f32 first; that
//     differs from this only by f32 rounding, as in the forward.  No
//     operand is pre-scaled in bf16 (1/sqrt(D) is not a power of two);
//   * masks: a causally masked real key scores _NEG = -0.7 * FLT_MAX
//     (kNeg), a key at or past Tk scores -inf; masks are applied only on
//     the tiles that need them (diagonal and padded), through one index
//     formula of the C fragment per kernel;
//   * weights, recomputed from the saved statistics, never from
//     m + log l: p = f32(bf16(exp(bf16(s - m)))) / l, with the forward
//     kernel's own weight() (flash_fwd_mma.cu: __expf, the hardware
//     ex2.approx), so that on the card the backward's weights are the
//     forward's, bit for bit: the Pallas kernels' fwd/bwd
//     self-consistency (l sums exactly these weights).  The plain
//     version's torch.exp is held to this by BWD_LIMITS in
//     chip_smoke.py;
//   * dP = dO . v by mma.sync (exact bf16 products, f32 sums), and
//     ds = p * (dP - delta), zeroed wherever the key is not visible (so a
//     fully masked row, p = 1/n on each real key, has ds = 0);
//   * dV += bf16(p)^T dO: the weights rounded to bf16 (round to nearest
//     even) are repacked from C fragments into A fragments, exactly the
//     Pallas kernel's p.astype(g.dtype) product with f32 accumulation;
//   * dK += ds^T q and dQ += ds k, the scale applied to the f32
//     accumulator at the end.  The Pallas kernels contract the f32 ds
//     against the f32 scaled q or k (f32 x f32), while mma.sync takes
//     bf16.  So ds enters as three bf16 A fragments, hi = bf16(ds),
//     mid = bf16(ds - hi), lo = bf16(ds - hi - mid): each step leaves a
//     remainder of at most half a bf16 step of the last, and the two
//     subtractions are exact, so hi + mid + lo == ds exactly for ds == 0
//     and every f32 ds of magnitude in [2^-110, 3.39e38] (below 2^-110 lo
//     would need bf16 subnormals finer than 2^-133; above, hi rounds to
//     infinity).  Each term times a bf16 q or
//     k is an exact product, so the three mma.syncs give the Pallas
//     kernel's f32 x f32 contraction up to the summation order.  One
//     bf16 ds (FlashAttention-2's shortcut) would move dK and dQ by up to
//     2^-9 of each term;
//   * the f32 sums over the query rows (dK, dV) and over the keys (dQ):
//     each 16-row chunk's products are summed by mma.sync into a zeroed
//     fragment, which is then added to the f32 accumulator on the CUDA
//     cores (round to nearest).  mma.sync's own f32 accumulation is not
//     a round-to-nearest add, and its error grows with the number of
//     steps: carried through all 512 chunks of an 8192-row sum it moved
//     dK by a bf16 step at its largest elements (PERF.md §6); one
//     chunk at a time it stays an f32 rounding, as the Pallas kernels'
//     f32 sums;
//   * dQ, dK, dV are written in bf16 (round to nearest even) from f32.
// A fully masked row (it sees no key: m == _NEG) adds dO/n to every real
// key's dV.  Hence dkv skips the query tiles above the diagonal only when
// every query row sees key 0 (then p is exactly 0 there); otherwise it
// visits every query tile.  dq skips every key tile above the diagonal:
// ds is 0 there, fully masked rows included.
//
// Grouped-query heads: dK, dV of a kv head are sums over the query heads
// of its group.  One dkv block loops over the whole group, so each output
// element is written once by one thread: no atomics, and the result does
// not depend on the order in which blocks run.
//
// What bounds it on the card: operations.  At the training path's shape
// ([2, 8192, 16, 128] bf16, causal) dkv needs four products per visible
// (query, key) pair (s, dP, dV, dK): 1.10e12 operations, 1.11 ms at the
// tensor cores' 989 TFLOP/s; dq three (s, dP, dQ), 8.2e11, 0.83 ms.  The
// three-term ds makes it six tensor-core products for dkv and five for
// dq; the bound counts the useful work.
//
// Design (FlashAttention-2 style, warp-level mma.sync; the forward's
// fragment helpers):
//   dq:  one block per (b*Hq + h, 64-row query tile), heaviest query
//        tiles first (blockIdx.y counts down the diagonal), 16 query rows a
//        warp, 4 warps (at D = 128 they ran faster than the forward's 8:
//        PERF.md §6).  Q and dO are staged once and held
//        in registers as A fragments; K and V tiles of 64 keys go into a
//        two-stage cp.async ring, rows padded by 16 bytes (conflict-free
//        ldmatrix).  Per 16-key chunk: S and dP as C fragments (rows
//        lane/4 and +8, columns 2 (lane % 4) and +1) with m, l and delta
//        per row in registers, then ds repacked (x3) into A fragments
//        against K through ldmatrix.trans.
//   dkv: one block per (b*Hkv + kv head, 64-key tile), earliest (heaviest)
//        key tiles first, 16 keys a warp.  K and V are staged once in
//        shared memory and re-read as A fragments per query chunk (a lane
//        holds 128 f32 accumulators of dK and dV at D = 128, no room for
//        them).  Query tiles of 64 rows (Q, dO and their m, l, delta) go
//        into a two-stage ring.  Per 16-query chunk (a loop the compiler
//        does not unroll: unrolled, it spilled at D = 128): S^T = K Q^T and
//        dP^T = V dO^T, Q and dO through ldmatrix as B fragments; the
//        per-query statistics sit along the C fragment's columns
//        2 (lane % 4) and +1; P^T and dS^T (x3) are repacked into A
//        fragments against dO and Q through ldmatrix.trans.
// Shared memory above 48 KB needs cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockK = 64;     // dq: keys per shared-memory tile
constexpr int kBlockKeys = 64;  // dkv: keys per block (4 warps)
constexpr int kQTile = 64;      // dkv: query rows per shared-memory tile
constexpr int kPad = 8;         // bf16 elements of padding per row
constexpr int kTerms = 3;       // bf16 terms of ds: hi, mid, lo
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

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and receives in r[j] row lane / 4, columns 2 (lane % 4) and +1
// of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

// the same, each matrix transposed: r[j] holds rows 2 (lane % 4) and +1,
// column lane / 4 of matrix j
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

// d += a b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column fragment b0, b1) and a 16x8 f32 accumulator
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- end of the PTX helpers ----

// acc += part, on the CUDA cores (round to nearest)
__device__ __forceinline__ void accumulate(float (&acc)[4],
                                           const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = acc[e] + part[e];
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats rounded to bf16, the first in the low half (the element of
// the lower column in an mma fragment register)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// two softmax weights as the dV product's bf16 operand (the Pallas
// kernel's p.astype(g.dtype): round to nearest even)
__device__ __forceinline__ uint32_t pack_weights(float a, float b) {
  return pack_bf16(a, b);
}

// Softmax weight of a max-subtracted score: the exponential of the
// bf16-rounded argument, rounded to bf16 (flash_fwd_mma.cu's weight()).
__device__ __forceinline__ float weight(float x) {
  const float arg = __bfloat162float(__float2bfloat16_rn(x));
  return __bfloat162float(__float2bfloat16_rn(__expf(arg)));
}

// The A fragments of a 16x16 f32 tile held as the C fragments c0
// (columns 0-7) and c1 (columns 8-15), split into bf16 terms:
// a[0] = hi, a[1] = mid, a[2] = lo, whose sum is the tile exactly.
__device__ __forceinline__ void split_fragments(const float (&c0)[4],
                                                const float (&c1)[4],
                                                uint32_t (&a)[kTerms][4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3],
                      c1[0], c1[1], c1[2], c1[3]};
  float term[3][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float hi = round_bf16(x[i]);
    const float rest = x[i] - hi;  // exact
    const float mid = round_bf16(rest);
    term[0][i] = hi;
    term[1][i] = mid;
    term[2][i] = round_bf16(rest - mid);  // rest - mid is exact, and so
                                          // is its rounding
  }
#pragma unroll
  for (int s = 0; s < kTerms; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[s][j] = pack_bf16(term[s][2 * j], term[s][2 * j + 1]);
    }
  }
}

// Stage rows [row0, row0 + rows) of a [T, D] operand (consecutive rows
// `stride` elements apart) into shared rows of D + kPad elements with
// kThreads threads; rows at or past `limit` are zero-filled without a
// read.
template <int D, int kThreads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int row0, int rows,
                                           int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = row0 + r < limit;
    const __nv_bfloat16* from =
        src + static_cast<size_t>(in ? row0 + r : 0) * stride + c * 8;
    cp_async_16(dst + r * (D + kPad) + c * 8, from, in ? 16 : 0);
  }
}

// Store a 16-row, D-column f32 tile held as C fragments (rows lane/4 and
// +8, columns 8n + 2 (lane % 4) and +1), times `factor`, in bf16 to rows
// row0.. of a [T, D] operand whose rows are `stride` elements apart;
// rows at or past `limit` are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t stride,
                                           int row0, int limit,
                                           const float (&acc)[D / 8][4],
                                           float factor) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* o = dst + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * (lane % 4)) =
          pack_bf16(acc[n][2 * r] * factor, acc[n][2 * r + 1] * factor);
    }
  }
}

// ------------------------------- dq -------------------------------------

constexpr int kDqWarps = 4;  // warps per dq block, 16 query rows each

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * 16 * kDqWarps + 4 * kBlockK) * (D + kPad) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <int D>
__global__ void __launch_bounds__(32 * kDqWarps)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ g,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int Tq, int Tk,
                        int Hq, int Hkv, int causal, long long q_offset,
                        long long k_offset, float scale) {
  constexpr int kThreads = 32 * kDqWarps;
  constexpr int kRows = 16 * kDqWarps;       // query rows per block
  constexpr int kStride = D + kPad;          // elements per shared row
  constexpr int kSteps = D / 16;             // k-steps of Q K^T, dO V^T
  constexpr int kDimBlocks = D / 8;          // n-blocks of dQ
  constexpr int kTile = kBlockK * kStride;   // elements per K or V stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = qs + kRows * kStride;
  __nv_bfloat16* ks = gs + kRows * kStride;  // [2][kBlockK][kStride]
  __nv_bfloat16* vs = ks + 2 * kTile;        // [2][kBlockK][kStride]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;   // fragment column pair 2t, 2t + 1
  const int row0 = q0 + 16 * warp;  // this warp's first query row

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t q_base = (static_cast<size_t>(b) * Tq * Hq + h) * D;
  const __nv_bfloat16* k_rows =
      k + (static_cast<size_t>(b) * Tk * Hkv + hk) * D;
  const __nv_bfloat16* v_rows =
      v + (static_cast<size_t>(b) * Tk * Hkv + hk) * D;

  // key tiles to visit: all of them, or (causal) those up to the last
  // row's diagonal; above it ds is 0 for every row
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last_row = min(q0 + kRows, Tq) - 1;
    const long long last_key = q_offset + last_row - k_offset;
    const long long needed = last_key < 0 ? 0 : last_key / kBlockK + 1;
    if (needed < n_tiles) n_tiles = static_cast<int>(needed);
  }

  stage_rows<D, kThreads>(qs, q + q_base, q_stride, q0, kRows, Tq);
  stage_rows<D, kThreads>(gs, g + q_base, q_stride, q0, kRows, Tq);
  stage_rows<D, kThreads>(ks, k_rows, kv_stride, 0, kBlockK, Tk);
  stage_rows<D, kThreads>(vs, v_rows, kv_stride, 0, kBlockK, Tk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q and dO as A fragments: lanes 0-15 address rows 0-15 at column 0 of
  // a 16x16 block, lanes 16-31 the same rows at column 8
  uint32_t qf[kSteps][4];
  uint32_t gf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int off = (16 * warp + lane % 16) * kStride + 16 * s +
                    8 * (lane / 16);
    ldmatrix_x4(qf[s], qs + off);
    ldmatrix_x4(gf[s], gs + off);
  }

  // rows gr and gr + 8: their statistics (a row past Tq gets finite
  // stand-ins; it is never written)
  float m_row[2], l_row[2], delta_row[2];
  long long qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    const bool live = row < Tq;
    const size_t stat = static_cast<size_t>(bh) * Tq + row;
    m_row[r] = live ? m[stat] : 0.0f;
    l_row[r] = live ? l[stat] : 1.0f;
    delta_row[r] = live ? delta[stat] : 0.0f;
    qpos[r] = q_offset + row;
  }

  float acc[kDimBlocks][4];
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) * kBlockK;
      stage_rows<D, kThreads>(ks + (stage ^ 1) * kTile, k_rows, kv_stride,
                              next, kBlockK, Tk);
      stage_rows<D, kThreads>(vs + (stage ^ 1) * kTile, v_rows, kv_stride,
                              next, kBlockK, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V are in shared memory
    const __nv_bfloat16* kt = ks + stage * kTile;
    const __nv_bfloat16* vt = vs + stage * kTile;
    const int k0 = tile * kBlockK;
    const bool mask_causal =
        causal && k_offset + k0 + kBlockK - 1 > q_offset + row0;
    const bool mask_pad = k0 + kBlockK > Tk;

#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      // S = Q K^T and dP = dO V^T for keys 16j..16j+15 of the tile: lanes
      // 0-7 address keys 0-7 at dims 0-7 of a 16-key, 16-dim block, lanes
      // 8-15 the same keys at dims 8-15, lanes 16-31 keys 8-15 likewise:
      // r[0], r[1] are B of keys 0-7, r[2], r[3] of keys 8-15
      float s[2][4] = {};
      float dp[2][4] = {};
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int off = (16 * j + lane % 8 + 8 * (lane / 16)) * kStride +
                        16 * st + 8 * ((lane / 8) % 2);
        uint32_t r[4];
        ldmatrix_x4(r, kt + off);
        mma_16816(s[0], qf[st], r[0], r[1]);
        mma_16816(s[1], qf[st], r[2], r[3]);
        ldmatrix_x4(r, vt + off);
        mma_16816(dp[0], gf[st], r[0], r[1]);
        mma_16816(dp[1], gf[st], r[2], r[3]);
      }

      // element e of n-block n is row gr + 8 (e / 2), key
      // k0 + 16 j + 8 n + 2 t + e % 2; dp becomes ds in place
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 16 * j + 8 * n + 2 * t + e % 2;
          float x = s[n][e] * scale;
          bool seen = true;
          if (mask_causal && qpos[e / 2] < k_offset + key) {
            x = kNeg;
            seen = false;
          }
          if (mask_pad && key >= Tk) {
            x = -INFINITY;
            seen = false;
          }
          const float p = weight(x - m_row[e / 2]) / l_row[e / 2];
          dp[n][e] = seen ? p * (dp[n][e] - delta_row[e / 2]) : 0.0f;
        }
      }

      // dQ += ds K: ds as kTerms bf16 A fragments; lanes 0-7 address keys
      // 0-7 at dims 0-7 of a 16-key, 16-dim block of K, lanes 8-15 keys
      // 8-15, lanes 16-31 the same at dims 8-15, transposed on the way
      uint32_t a[kTerms][4];
      split_fragments(dp[0], dp[1], a);
#pragma unroll
      for (int n = 0; n < kDimBlocks; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, kt + (16 * j + lane % 16) * kStride + 8 * n +
                                 8 * (lane / 16));
        float part[2][4] = {};
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          mma_16816(part[0], a[term], r[0], r[1]);
          mma_16816(part[1], a[term], r[2], r[3]);
        }
        accumulate(acc[n], part[0]);
        accumulate(acc[n + 1], part[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  store_rows<D>(dq + q_base, q_stride, row0, Tq, acc, scale);
}

// ------------------------------- dkv ------------------------------------

constexpr int kDkvWarps = kBlockKeys / 16;

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kBlockKeys + 4 * kQTile) * (D + kPad) *
             static_cast<int>(sizeof(__nv_bfloat16)) +
         2 * 3 * kQTile * static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(32 * kDkvWarps)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ g,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Tq, int Tk,
                         int Hq, int Hkv, int causal, long long q_offset,
                         long long k_offset, float scale) {
  constexpr int kThreads = 32 * kDkvWarps;
  constexpr int kStride = D + kPad;
  constexpr int kSteps = D / 16;
  constexpr int kDimBlocks = D / 8;
  constexpr int kTile = kQTile * kStride;  // elements per Q or dO stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBlockKeys * kStride;
  __nv_bfloat16* qs = vs + kBlockKeys * kStride;  // [2][kQTile][kStride]
  __nv_bfloat16* gs = qs + 2 * kTile;             // [2][kQTile][kStride]
  float* stats = reinterpret_cast<float*>(gs + 2 * kTile);  // [2][3][kQTile]

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kBlockKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row: key gr (and gr + 8)
  const int t = lane % 4;   // fragment columns: queries 2t, 2t + 1
  const int kw0 = k0 + 16 * warp;  // this warp's first key

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t kv_base = (static_cast<size_t>(b) * Tk * Hkv + hk) * D;

  // query tiles to visit: all of them, or (causal, every row sees key 0)
  // those from the first row that sees key k0 on
  const int n_tiles = (Tq + kQTile - 1) / kQTile;
  int first = 0;
  if (causal && q_offset >= k_offset) {
    const long long row0 = k_offset + k0 - q_offset;
    if (row0 > 0) {
      const long long tile = row0 / kQTile;
      first = tile < n_tiles ? static_cast<int>(tile) : n_tiles;
    }
  }
  const int n_visit = n_tiles - first;
  const int total = group * n_visit;  // (query head, query tile) items

  // stage item `it`: Q and dO rows by cp.async, m, l and delta by plain
  // loads (a row past Tq gets m = 0, l = 1, delta = 0 against zero Q and
  // dO rows: it adds exactly 0)
  auto stage_item = [&](int it, int stage) {
    const int h = hk * group + it / n_visit;
    const int q0 = (first + it % n_visit) * kQTile;
    const size_t q_base = (static_cast<size_t>(b) * Tq * Hq + h) * D;
    stage_rows<D, kThreads>(qs + stage * kTile, q + q_base, q_stride, q0,
                            kQTile, Tq);
    stage_rows<D, kThreads>(gs + stage * kTile, g + q_base, q_stride, q0,
                            kQTile, Tq);
    float* st = stats + stage * 3 * kQTile;
    const size_t stat = (static_cast<size_t>(b) * Hq + h) * Tq + q0;
    for (int i = threadIdx.x; i < kQTile; i += kThreads) {
      const bool live = q0 + i < Tq;
      st[i] = live ? m[stat + i] : 0.0f;
      st[kQTile + i] = live ? l[stat + i] : 1.0f;
      st[2 * kQTile + i] = live ? delta[stat + i] : 0.0f;
    }
  };

  stage_rows<D, kThreads>(ks, k + kv_base, kv_stride, k0, kBlockKeys, Tk);
  stage_rows<D, kThreads>(vs, v + kv_base, kv_stride, k0, kBlockKeys, Tk);
  if (total > 0) stage_item(0, 0);
  cp_async_commit();

  float dk_acc[kDimBlocks][4];
  float dv_acc[kDimBlocks][4];
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = 0.0f;
      dv_acc[n][e] = 0.0f;
    }
  }
  // rows gr, gr + 8 of the C fragments: keys kw0 + gr, kw0 + gr + 8
  const long long kpos[2] = {k_offset + kw0 + gr, k_offset + kw0 + gr + 8};
  const bool mask_pad = kw0 + 16 > Tk;

  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    if (it + 1 < total) {
      stage_item(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's Q, dO and statistics are staged
    const __nv_bfloat16* qt = qs + stage * kTile;
    const __nv_bfloat16* gt = gs + stage * kTile;
    const float* m_s = stats + stage * 3 * kQTile;
    const float* l_s = m_s + kQTile;
    const float* delta_s = l_s + kQTile;
    const int q0 = (first + it % n_visit) * kQTile;
    const bool mask_causal =
        causal && q_offset + q0 < k_offset + kw0 + 15;

#pragma unroll 1
    for (int c = 0; c < kQTile / 16; ++c) {
      // S^T = K Q^T and dP^T = V dO^T for queries 16c..16c+15 of the
      // tile: K and V as A fragments (lanes 0-15 address keys 0-15 at
      // dim 0 of a 16x16 block, lanes 16-31 at dim 8), Q and dO as B
      // fragments (lanes 0-7 address queries 0-7 at dims 0-7, lanes 8-15
      // the same at dims 8-15, lanes 16-31 queries 8-15 likewise)
      float s[2][4] = {};
      float dp[2][4] = {};
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int a_off = (16 * warp + lane % 16) * kStride + 16 * st +
                          8 * (lane / 16);
        const int b_off = (16 * c + lane % 8 + 8 * (lane / 16)) * kStride +
                          16 * st + 8 * ((lane / 8) % 2);
        uint32_t a[4];
        uint32_t r[4];
        ldmatrix_x4(a, ks + a_off);
        ldmatrix_x4(r, qt + b_off);
        mma_16816(s[0], a, r[0], r[1]);
        mma_16816(s[1], a, r[2], r[3]);
        ldmatrix_x4(a, vs + a_off);
        ldmatrix_x4(r, gt + b_off);
        mma_16816(dp[0], a, r[0], r[1]);
        mma_16816(dp[1], a, r[2], r[3]);
      }

      // element e of n-block n is key kw0 + gr + 8 (e / 2), query
      // q0 + 16 c + 8 n + 2 t + e % 2 (index i in the tile); s becomes p
      // and dp becomes ds in place
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * c + 8 * n + 2 * t + e % 2;
          float x = s[n][e] * scale;
          bool seen = true;
          if (mask_causal && q_offset + q0 + i < kpos[e / 2]) {
            x = kNeg;
            seen = false;
          }
          if (mask_pad && kw0 + gr + 8 * (e / 2) >= Tk) {
            x = -INFINITY;
            seen = false;
          }
          const float p = weight(x - m_s[i]) / l_s[i];
          s[n][e] = p;
          dp[n][e] = seen ? p * (dp[n][e] - delta_s[i]) : 0.0f;
        }
      }

      // P^T (bf16) and dS^T (kTerms bf16 terms) as A fragments of keys x
      // queries 16c..16c+15; dO and Q as B fragments of queries x dims,
      // transposed on the way (lanes 0-7 address queries 0-7 at dims 0-7
      // of a 16-query, 16-dim block, lanes 8-15 queries 8-15, lanes 16-31
      // the same at dims 8-15)
      const uint32_t pa[4] = {
          pack_weights(s[0][0], s[0][1]),
          pack_weights(s[0][2], s[0][3]),
          pack_weights(s[1][0], s[1][1]),
          pack_weights(s[1][2], s[1][3]),
      };
      uint32_t da[kTerms][4];
      split_fragments(dp[0], dp[1], da);
#pragma unroll
      for (int n = 0; n < kDimBlocks; n += 2) {
        const int off = (16 * c + lane % 16) * kStride + 8 * n +
                        8 * (lane / 16);
        uint32_t r[4];
        ldmatrix_x4_trans(r, gt + off);
        float part[2][4] = {};
        mma_16816(part[0], pa, r[0], r[1]);
        mma_16816(part[1], pa, r[2], r[3]);
        accumulate(dv_acc[n], part[0]);
        accumulate(dv_acc[n + 1], part[1]);
        ldmatrix_x4_trans(r, qt + off);
        float dk_part[2][4] = {};
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          mma_16816(dk_part[0], da[term], r[0], r[1]);
          mma_16816(dk_part[1], da[term], r[2], r[3]);
        }
        accumulate(dk_acc[n], dk_part[0]);
        accumulate(dk_acc[n + 1], dk_part[1]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  if (total == 0) cp_async_wait<0>();

  store_rows<D>(dk + kv_base, kv_stride, kw0, Tk, dk_acc, scale);
  store_rows<D>(dv + kv_base, kv_stride, kw0, Tk, dv_acc, 1.0f);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* m;
  const float* l;
  const float* delta;
  int B, Tq, Tk, Hq, Hkv, causal;
  long long q_offset, k_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.Tk + kBlockKeys - 1) / kBlockKeys);
  const dim3 block(32 * kDkvWarps);
  flash_bwd_dkv_mma_kernel<D><<<grid, block, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.g), a.m, a.l, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.Tq,
      a.Tk, a.Hq, a.Hkv, a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int rows = 16 * kDqWarps;
  const dim3 grid(a.B * a.Hq, (a.Tq + rows - 1) / rows);
  const dim3 block(32 * kDqWarps);
  flash_bwd_dq_mma_kernel<D><<<grid, block, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.g), a.m, a.l, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.Tq, a.Tk, a.Hq, a.Hkv, a.causal,
      a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16): f32 operands go to flash_bwd.cu.  m, l and
// delta are f32 [B*Hq, Tq].  The wrapper (kernels/flash_bwd.py) checks
// shapes, types, contiguity, 16-byte alignment, D in {32, 64, 128},
// Hq % Hkv == 0, Tk >= 1 and the grids' y extent.
int flash_bwd_dkv_mma_launch(const void* q, const void* k, const void* v,
                             const void* g, const float* m, const float* l,
                             const float* delta, void* dk, void* dv, int B,
                             int Tq, int Tk, int Hq, int Hkv, int D,
                             int dtype, int causal, long long q_offset,
                             long long k_offset, float scale,
                             cudaStream_t stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, g, m, l, delta, B, Tq, Tk, Hq, Hkv, causal,
               q_offset, k_offset, scale, stream};
  switch (D) {
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

int flash_bwd_dq_mma_launch(const void* q, const void* k, const void* v,
                            const void* g, const float* m, const float* l,
                            const float* delta, void* dq, int B, int Tq,
                            int Tk, int Hq, int Hkv, int D, int dtype,
                            int causal, long long q_offset,
                            long long k_offset, float scale,
                            cudaStream_t stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, g, m, l, delta, B, Tq, Tk, Hq, Hkv, causal,
               q_offset, k_offset, scale, stream};
  switch (D) {
    case 32: return launch_dq<32>(a, dq);
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_bwd_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
