// Hand-written Hopper (sm_90a) flash-attention backward kernels for f32
// operands.
//
//   flash_bwd_dkv  replaces mpi4jax_tpu/ops/flash.py:_bwd_dkv_kernel
//                  (launched by _flash_bwd) for f32 operands: dK and dV
//                  of one block of keys, accumulated over the query rows
//                  that see them; on the tensor cores in 3xTF32.
//   flash_bwd_dq   replaces mpi4jax_tpu/ops/flash.py:_bwd_dq_kernel for
//                  f32 operands: dQ of one block of query rows,
//                  accumulated over the keys they see; on the tensor
//                  cores in 3xTF32.
// bf16 operands go to the bf16 tensor-core kernels of flash_bwd_mma.cu.
//
// Layout: q, dO and dq are row-major [B, Tq, Hq, D], k, v, dk and dv
// [B, Tk, Hkv, D] (the [B, T, H, D] operands of flash_attention, read with
// strides: no fold and no padding copy); both kernels copy rows in
// 16-byte pieces, so every row must start on a 16-byte boundary (the
// wrapper checks the base pointers).  Query head h reads kv head
// h / (Hq / Hkv).  m, l (the forward's row statistics) and delta =
// rowsum(dO * out) are f32 [B*Hq, Tq], row b*Hq + h.
//
// Semantics kept from the Pallas kernels' shared math (_bwd_block), term
// by term:
//   * scores in f32, the scale on one operand: the dkv kernel scales q,
//     the dq kernel scales k (the two round apart);
//   * a causally masked real key scores _NEG = -0.7 * FLT_MAX, a key at
//     or past Tk scores -inf;
//   * weights from the saved statistics, never from m + log l:
//     p = exp(s - m) / l (expf, f32 weights);
//   * dP = dO . v, ds = p * (dP - delta), and ds = 0 wherever the key is
//     not visible;
//   * dV += p dO, dK += ds q_scaled, dQ += ds k_scaled, all in f32.
// A fully masked row (it sees no key: m == _NEG) has p = 1/n on each of
// the n real keys and ds = 0, so it adds dO/n to every key's dV.  Hence
// the dkv kernel skips the query tiles above the diagonal only when every
// query row sees key 0 (then p is exactly 0 there); otherwise it visits
// every query tile.  dq may skip every key tile above the diagonal: ds is
// 0 there, fully masked rows included.
//
// Grouped-query heads: the dK, dV of a kv head are sums over the query
// heads of its group.  One dkv block loops over the whole group, so each
// output element is written once by one thread: no atomics, and the
// result does not depend on the order in which blocks run.
//
// f32 products on the tensor cores (3xTF32), as flash_fwd.cu: each f32
// operand x is split into big = tf32(x) and small = tf32(x - big),
// rounded to nearest even at the 13th bit, and a product is taken as
// big*big + big*small + small*big, three mma.sync.m16n8k8 TF32 products
// (the small*small term, about 2^-22 of a product, dropped).  That covers
// S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q in dkv, and
// S = Q K^T, dP = dO V^T and dQ += dS K in dq; the weights p and ds stay
// f32 and are split like any operand.  The tensor cores' own f32
// accumulation is not round-to-nearest, and its error grows with the
// products it runs over: over the 16 k-steps of S^T and dP^T at D = 128
// it moved dK by 8.8e-6 of its largest element at the training shape
// (limit 1e-5, PERF.md §6).  So each k-step's three products of a score
// or of dP are summed by mma.sync into a zeroed fragment and added on the
// CUDA cores (round to nearest), and each 16-query chunk's dV and dK
// products, and each 8-key chunk's dQ products, likewise into the f32
// accumulators.  Statistics, masks and expf stay on the CUDA cores in
// f32.
//
// What bounds them on the card: operations.  dkv does four products per
// visible (query, key) pair (s, dP, dV, dK), dq three (s, dP, dQ), each
// 2·D operations: 1.10e12 and 8.2e11 at the training shape
// ([2, 8192, 16, 128] causal).  f32-class products run at most at 494.7 / 3
// = 165 TFLOP/s in 3xTF32, against 67 TFLOP/s on the CUDA cores.
//
// Design:
//   dkv: one block of 8 warps per (b*Hkv + kv head, 64-key tile), earliest
//        (heaviest) key tiles first (keys on the C fragment's rows).  Each
//        warp owns 16 keys and one 8-query half of every query tile, and
//        sums its own dK, dV over the queries of its half; at the end the
//        second half's warps hand their sums through shared memory to
//        the first half's, which add them and write the rows.  The split
//        into halves puts two warps on each of the SM's four schedulers:
//        shared memory admits one block per SM at D = 128, and one warp per
//        scheduler left the tensor cores waiting (4 warps ran the training
//        shape about 1.4x slower; PERF.md §6).  K and V are staged once
//        through cp.async and split in place into big and small planes in
//        shared memory; their A fragments are re-read per tile (a lane
//        holds 128 f32 accumulators of dK and dV at D = 128, no room for
//        them).  Query tiles of 16 rows (Q and dO, and their m, l, delta)
//        go into a two-stage cp.async ring, each arriving tile split in
//        place (Q scaled first) with one small plane per operand, once per
//        block.  Per tile: S^T and dP^T as C fragments (rows: keys lane/4
//        and +8; columns: queries 2 (lane % 4) and +1 of the warp's half,
//        whose m, l and delta are read from the staged statistics); P^T
//        and dS^T go straight from the C fragments into A fragments
//        against dO and Q, the 8 queries of the k-step taken in the order
//        0, 2, 4, 6, 1, 3, 5, 7 on both sides (a0 = c0, a1 = c2, a2 = c1,
//        a3 = c3; the B row for fragment index t is query 2t).  Rows are padded by 4 floats:
//        both fragment patterns (row lane/4, column lane % 4; and row
//        2 (lane % 4), column lane/4) read with plain 32-bit loads free of
//        bank conflicts.  Shared memory at D = 128: 4 x 64 rows of K and
//        V planes, 2 x 2 x 16 of the ring and 2 x 16 small rows, of 132
//        floats, and the statistics: 186,240 bytes, which needs
//        cudaFuncAttributeMaxDynamicSharedMemorySize.
//   dq:  the dkv design with the roles of queries and keys swapped (and
//        the forward's fragment layout, queries on the C fragment's
//        rows): one block of 8 warps per (b*Hq + h, 64-row query tile),
//        last (heaviest) tiles first.  Each warp owns 16 query rows and
//        one 8-key half of every 16-key tile, and sums its own dQ over the
//        keys of its half; at the end the second half's warps hand their
//        sums through shared memory to the first half's, which add them
//        and write the rows.  Q and dO are staged once through cp.async
//        and split in place into big and small planes (4 x 64 rows); K
//        (scaled first) and V come in a two-stage cp.async ring of 16-key
//        tiles, each arriving tile split in place with one small plane
//        per operand, once per block.  Per tile: S = Q K_s^T and
//        dP = dO V^T as C fragments (rows: queries lane/4 and +8, whose m,
//        l and delta each lane holds in registers; columns: keys
//        2 (lane % 4) and +1 of the warp's half); ds goes straight from
//        the C fragment into the A fragment of dQ += dS K_s, the 8 keys
//        taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (K_s's B row for
//        fragment index t is key 2t).  The dQ accumulator is 4 D/8 f32 a
//        lane.  Key tiles above the last row's diagonal are skipped.
//        Shared memory at D = 128: 4 x 64 rows of Q and dO planes, 2 x 2 x
//        16 of the ring and 2 x 16 small rows, of 132 floats: 185,856
//        bytes, which needs cudaFuncAttributeMaxDynamicSharedMemorySize.
//        The ring's tiles are 16 keys because 32 would not fit beside the
//        Q and dO planes at D = 128.
//
// Built with -fmad=false (see _build.py): the CUDA-core arithmetic rounds
// every product and sum on its own, as in the plain PyTorch version.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // both kernels: 8 warps in two halves
constexpr int kBlockKeys = 64;  // dkv: keys per block
constexpr int kQTile = 16;      // dkv: query rows per shared-memory tile
constexpr int kBlockQ = 64;     // dq: query rows per block
constexpr int kKTile = 16;      // dq: keys per shared-memory tile
constexpr int kPad = 4;         // floats of padding per shared row
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

// x rounded to TF32 (10 explicit mantissa bits), to nearest even, as
// flash_fwd.cu's tf32_round (mirror: kernels/flash.py:tf32_split)
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

// ------------------------------- dkv ------------------------------------

constexpr int kKeyGroups = kBlockKeys / 16;  // warps of 16 keys a half
static_assert(2 * 32 * kKeyGroups == kThreads, "dkv: two query halves");

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kBlockKeys + 6 * kQTile) * (D + kPad) *
             static_cast<int>(sizeof(float)) +
         2 * 3 * kQTile * static_cast<int>(sizeof(float));
}

// Stage rows [row0, row0 + rows) of a [T, D] operand (consecutive rows
// `stride` elements apart) into shared rows of D + kPad floats; rows at
// or past `limit` are zero-filled without a read.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int row0, int rows,
                                           int limit) {
  constexpr int kRowChunks = D / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * kRowChunks; idx += kThreads) {
    const int r = idx / kRowChunks;
    const int c = idx % kRowChunks;
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
  constexpr int kRowChunks = D / 4;
  for (int idx = threadIdx.x; idx < rows * kRowChunks; idx += kThreads) {
    const int off = (idx / kRowChunks) * (D + kPad) + (idx % kRowChunks) * 4;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv,
                     int causal, long long q_offset, long long k_offset,
                     float scale) {
  constexpr int kStride = D + kPad;        // floats per shared row
  constexpr int kSteps = D / 8;            // k-steps of K Q^T, V dO^T
  constexpr int kDimBlocks = D / 8;        // n-blocks of dK, dV
  constexpr int kPlane = kBlockKeys * kStride;  // floats per K or V plane
  constexpr int kTile = kQTile * kStride;  // floats per Q or dO stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_big = reinterpret_cast<float*>(smem);
  float* k_small = k_big + kPlane;
  float* v_big = k_small + kPlane;
  float* v_small = v_big + kPlane;
  float* qs = v_small + kPlane;   // [2][kTile]: raw, then big (scaled)
  float* gs = qs + 2 * kTile;     // [2][kTile]: raw, then big
  float* q_small = gs + 2 * kTile;  // [kTile]
  float* g_small = q_small + kTile;  // [kTile]
  float* stats = g_small + kTile;    // [2][3][kQTile]: m, l, delta

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kBlockKeys;
  const int warp = threadIdx.x / 32;
  const int kg = warp % kKeyGroups;  // this warp's 16 keys of the block
  const int qh = warp / kKeyGroups;  // and its 8 queries of every tile
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row: key gr (and gr + 8)
  const int t = lane % 4;   // fragment columns: queries 2t, 2t + 1
  const int kw0 = k0 + 16 * kg;  // this warp's first key

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
    stage_rows<D>(qs + stage * kTile, q + q_base, q_stride, q0, kQTile, Tq);
    stage_rows<D>(gs + stage * kTile, g + q_base, q_stride, q0, kQTile, Tq);
    float* st = stats + stage * 3 * kQTile;
    const size_t stat = (static_cast<size_t>(b) * Hq + h) * Tq + q0;
    for (int i = threadIdx.x; i < kQTile; i += kThreads) {
      const bool live = q0 + i < Tq;
      st[i] = live ? m[stat + i] : 0.0f;
      st[kQTile + i] = live ? l[stat + i] : 1.0f;
      st[2 * kQTile + i] = live ? delta[stat + i] : 0.0f;
    }
  };

  stage_rows<D>(k_big, k + kv_base, kv_stride, k0, kBlockKeys, Tk);
  stage_rows<D>(v_big, v + kv_base, kv_stride, k0, kBlockKeys, Tk);
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
  // this lane's A fragment offset in the K and V planes (keys 16 kg +
  // gr, +8; dims t, +4), its B fragment offset in its query half of a Q
  // or dO tile as the right operand of K Q^T (query 8 qh + gr; dims t,
  // +4) and of P^T dO (queries 8 qh + 2t, +1; dim gr)
  const int a_off = (16 * kg + gr) * kStride + t;
  const int qb_off = (8 * qh + gr) * kStride + t;
  const int gb_off = (8 * qh + 2 * t) * kStride + gr;

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
    float* qt = qs + stage * kTile;
    float* gt = gs + stage * kTile;
    if (it == 0) {
      split_rows<D>(k_big, k_small, kBlockKeys, 1.0f);
      split_rows<D>(v_big, v_small, kBlockKeys, 1.0f);
    }
    split_rows<D>(qt, q_small, kQTile, scale);
    split_rows<D>(gt, g_small, kQTile, 1.0f);
    __syncthreads();  // the split planes are complete
    const float* m_s = stats + stage * 3 * kQTile;
    const float* l_s = m_s + kQTile;
    const float* delta_s = l_s + kQTile;
    const int q0 = (first + it % n_visit) * kQTile;
    const bool mask_causal =
        causal && q_offset + q0 < k_offset + kw0 + 15;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 8 queries of the
    // tile: A from the K and V planes, B from the Q and dO tiles
    float s[4] = {};
    float dp[4] = {};
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int ao = a_off + 8 * st;
      const uint32_t ka_big[4] = {
          bits(k_big[ao]), bits(k_big[ao + 8 * kStride]),
          bits(k_big[ao + 4]), bits(k_big[ao + 8 * kStride + 4])};
      const uint32_t ka_small[4] = {
          bits(k_small[ao]), bits(k_small[ao + 8 * kStride]),
          bits(k_small[ao + 4]), bits(k_small[ao + 8 * kStride + 4])};
      const uint32_t va_big[4] = {
          bits(v_big[ao]), bits(v_big[ao + 8 * kStride]),
          bits(v_big[ao + 4]), bits(v_big[ao + 8 * kStride + 4])};
      const uint32_t va_small[4] = {
          bits(v_small[ao]), bits(v_small[ao + 8 * kStride]),
          bits(v_small[ao + 4]), bits(v_small[ao + 8 * kStride + 4])};
      const int bo = qb_off + 8 * st;
      const uint32_t qb_big[2] = {bits(qt[bo]), bits(qt[bo + 4])};
      const uint32_t qb_small[2] = {bits(q_small[bo]),
                                    bits(q_small[bo + 4])};
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(part, ka_big, ka_small, qb_big, qb_small);
      accumulate(s, part);
      const uint32_t gb_big[2] = {bits(gt[bo]), bits(gt[bo + 4])};
      const uint32_t gb_small[2] = {bits(g_small[bo]),
                                    bits(g_small[bo + 4])};
      float dp_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(dp_part, va_big, va_small, gb_big, gb_small);
      accumulate(dp, dp_part);
    }

    // element e is key kw0 + gr + 8 (e / 2), query q0 + 8 qh + 2 t + e % 2
    // (index i in the tile); s becomes p and dp becomes ds in place
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * qh + 2 * t + e % 2;
      float x = s[e];
      bool seen = true;
      if (mask_causal && q_offset + q0 + i < kpos[e / 2]) {
        x = kNeg;
        seen = false;
      }
      if (mask_pad && kw0 + gr + 8 * (e / 2) >= Tk) {
        x = -INFINITY;
        seen = false;
      }
      const float p = expf(x - m_s[i]) / l_s[i];
      s[e] = p;
      dp[e] = seen ? p * (dp[e] - delta_s[i]) : 0.0f;
    }

    // P^T and dS^T as split A fragments over this warp's 8 queries; dO
    // and Q as B fragments (queries 8 qh + 2t, +1; dims 8n + gr)
    uint32_t pa_big[4], pa_small[4], da_big[4], da_small[4];
    split_c_as_a(s, pa_big, pa_small);
    split_c_as_a(dp, da_big, da_small);
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      const int bo = gb_off + 8 * n;
      const uint32_t gb_big[2] = {bits(gt[bo]), bits(gt[bo + kStride])};
      const uint32_t gb_small[2] = {bits(g_small[bo]),
                                    bits(g_small[bo + kStride])};
      float dv_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(dv_part, pa_big, pa_small, gb_big, gb_small);
      accumulate(dv_acc[n], dv_part);
      const uint32_t qb_big[2] = {bits(qt[bo]), bits(qt[bo + kStride])};
      const uint32_t qb_small[2] = {bits(q_small[bo]),
                                    bits(q_small[bo + kStride])};
      float dk_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(dk_part, da_big, da_small, qb_big, qb_small);
      accumulate(dk_acc[n], dk_part);
    }
    __syncthreads();  // every warp is done with this stage
  }
  if (total == 0) cp_async_wait<0>();

  // the two query halves' sums of a key meet: the second half's warps
  // hand dK, dV through shared memory (the K planes, read no more) to
  // the first half's, which add them and write the rows
  constexpr int kXStride = 32 * kKeyGroups;
  float* xs = k_big + (32 * kg + lane);
  static_assert(8 * kDimBlocks * kXStride <= 2 * kPlane,
                "dK and dV of a half fit the K planes");
  __syncthreads();  // no warp reads the K planes any more
  if (qh == 1) {
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[(4 * n + e) * kXStride] = dk_acc[n][e];
        xs[(4 * (kDimBlocks + n) + e) * kXStride] = dv_acc[n][e];
      }
    }
  }
  __syncthreads();
  if (qh == 1) return;
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[n][e] = dk_acc[n][e] + xs[(4 * n + e) * kXStride];
      dv_acc[n][e] = dv_acc[n][e] + xs[(4 * (kDimBlocks + n) + e) * kXStride];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + gr + 8 * r;
    if (key >= Tk) continue;
    const size_t row = kv_base + static_cast<size_t>(key) * kv_stride;
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      *reinterpret_cast<float2*>(dk + row + 8 * n + 2 * t) =
          make_float2(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + row + 8 * n + 2 * t) =
          make_float2(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------- dq -------------------------------------

constexpr int kRowGroups = kBlockQ / 16;  // warps of 16 query rows a half
static_assert(2 * 32 * kRowGroups == kThreads, "dq: two key halves");
constexpr int kHalfK = kKTile / 2;        // keys of a tile per key half

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kBlockQ + 6 * kKTile) * (D + kPad) *
         static_cast<int>(sizeof(float));
}

// The second bound is the blocks per SM that shared memory admits: at
// D = 128 one, so ptxas may use up to 255 registers.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int Hq, int Hkv, int causal,
                    long long q_offset, long long k_offset, float scale) {
  constexpr int kStride = D + kPad;          // floats per shared row
  constexpr int kSteps = D / 8;              // k-steps of Q K^T, dO V^T
  constexpr int kDimBlocks = D / 8;          // n-blocks of dQ
  constexpr int kPlane = kBlockQ * kStride;  // floats per Q or dO plane
  constexpr int kTile = kKTile * kStride;    // floats per K or V stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_big = reinterpret_cast<float*>(smem);
  float* q_small = q_big + kPlane;
  float* g_big = q_small + kPlane;
  float* g_small = g_big + kPlane;
  float* ks = g_small + kPlane;      // [2][kTile]: raw, then big (scaled)
  float* vs = ks + 2 * kTile;        // [2][kTile]: raw, then big
  float* k_small = vs + 2 * kTile;   // [kTile]
  float* v_small = k_small + kTile;  // [kTile]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int rg = warp % kRowGroups;  // this warp's 16 rows of the block
  const int kh = warp / kRowGroups;  // and its 8 keys of every tile
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row: query gr (and gr + 8)
  const int t = lane % 4;   // fragment columns: keys 2t, 2t + 1
  const int row0 = q0 + 16 * rg;  // this warp's first query row

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const size_t q_base = (static_cast<size_t>(b) * Tq * Hq + h) * D;
  const size_t kv_base = (static_cast<size_t>(b) * Tk * Hkv + hk) * D;

  // key tiles to visit: all of them, or (causal) those up to the last
  // row's diagonal; above it ds is 0 for every row
  int n_tiles = (Tk + kKTile - 1) / kKTile;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, Tq) - 1;
    const long long last_key = q_offset + last_row - k_offset;
    const long long needed = last_key < 0 ? 0 : last_key / kKTile + 1;
    if (needed < n_tiles) n_tiles = static_cast<int>(needed);
  }

  if (n_tiles > 0) {
    stage_rows<D>(q_big, q + q_base, q_stride, q0, kBlockQ, Tq);
    stage_rows<D>(g_big, g + q_base, q_stride, q0, kBlockQ, Tq);
    stage_rows<D>(ks, k + kv_base, kv_stride, 0, kKTile, Tk);
    stage_rows<D>(vs, v + kv_base, kv_stride, 0, kKTile, Tk);
    cp_async_commit();
  }

  // rows gr, gr + 8 of the C fragments and their statistics (a row past
  // Tq gets m = 0, l = 1, delta = 0 against zero Q and dO rows: ds = 0)
  long long qpos[2];
  float m_row[2], l_row[2], delta_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    const bool live = row < Tq;
    const size_t stat = static_cast<size_t>(bh) * Tq + row;
    qpos[r] = q_offset + row;
    m_row[r] = live ? m[stat] : 0.0f;
    l_row[r] = live ? l[stat] : 1.0f;
    delta_row[r] = live ? delta[stat] : 0.0f;
  }
  float acc[kDimBlocks][4];
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  // this lane's A fragment offset in the Q and dO planes (rows 16 rg +
  // gr, +8; dims t, +4), its B fragment offset in its key half of a K or
  // V tile as the right operand of Q K^T (key 8 kh + gr; dims t, +4) and
  // of dS K (keys 8 kh + 2t, +1; dim gr)
  const int a_off = (16 * rg + gr) * kStride + t;
  const int kb_off = (kHalfK * kh + gr) * kStride + t;
  const int kd_off = (kHalfK * kh + 2 * t) * kStride + gr;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) * kKTile;
      stage_rows<D>(ks + (stage ^ 1) * kTile, k + kv_base, kv_stride, next,
                    kKTile, Tk);
      stage_rows<D>(vs + (stage ^ 1) * kTile, v + kv_base, kv_stride, next,
                    kKTile, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V (and Q, dO) are staged
    float* kt = ks + stage * kTile;
    float* vt = vs + stage * kTile;
    if (tile == 0) {
      split_rows<D>(q_big, q_small, kBlockQ, 1.0f);
      split_rows<D>(g_big, g_small, kBlockQ, 1.0f);
    }
    split_rows<D>(kt, k_small, kKTile, scale);
    split_rows<D>(vt, v_small, kKTile, 1.0f);
    __syncthreads();  // the split planes are complete
    const int k0 = tile * kKTile;

    // S = Q K_s^T and dP = dO V^T over this warp's 8 keys of the tile: A
    // from the Q and dO planes, B from the K and V tiles
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int ao = a_off + 8 * st;
      const uint32_t qa_big[4] = {
          bits(q_big[ao]), bits(q_big[ao + 8 * kStride]),
          bits(q_big[ao + 4]), bits(q_big[ao + 8 * kStride + 4])};
      const uint32_t qa_small[4] = {
          bits(q_small[ao]), bits(q_small[ao + 8 * kStride]),
          bits(q_small[ao + 4]), bits(q_small[ao + 8 * kStride + 4])};
      const int bo = kb_off + 8 * st;
      const uint32_t kb_big[2] = {bits(kt[bo]), bits(kt[bo + 4])};
      const uint32_t kb_small[2] = {bits(k_small[bo]),
                                    bits(k_small[bo + 4])};
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(part, qa_big, qa_small, kb_big, kb_small);
      accumulate(s, part);
      const uint32_t ga_big[4] = {
          bits(g_big[ao]), bits(g_big[ao + 8 * kStride]),
          bits(g_big[ao + 4]), bits(g_big[ao + 8 * kStride + 4])};
      const uint32_t ga_small[4] = {
          bits(g_small[ao]), bits(g_small[ao + 8 * kStride]),
          bits(g_small[ao + 4]), bits(g_small[ao + 8 * kStride + 4])};
      const uint32_t vb_big[2] = {bits(vt[bo]), bits(vt[bo + 4])};
      const uint32_t vb_small[2] = {bits(v_small[bo]),
                                    bits(v_small[bo + 4])};
      float dp_part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(dp_part, ga_big, ga_small, vb_big, vb_small);
      accumulate(dp, dp_part);
    }

    // element e is query row0 + gr + 8 (e / 2), key k0 + 8 kh + 2 t +
    // e % 2; dp becomes ds in place, 0 wherever the key is not visible
    const bool mask_causal =
        causal && k_offset + k0 + kKTile - 1 > q_offset + q0;
    const bool mask_pad = k0 + kKTile > Tk;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + kHalfK * kh + 2 * t + e % 2;
      bool seen = true;
      if (mask_causal && qpos[e / 2] < k_offset + key) seen = false;
      if (mask_pad && key >= Tk) seen = false;
      const float p = expf(s[e] - m_row[e / 2]) / l_row[e / 2];
      dp[e] = seen ? p * (dp[e] - delta_row[e / 2]) : 0.0f;
    }

    // dQ += dS K_s: dS as the split A fragment over this warp's 8 keys,
    // K_s as B fragments (keys 8 kh + 2t, +1; dims 8n + gr)
    uint32_t da_big[4], da_small[4];
    split_c_as_a(dp, da_big, da_small);
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      const int bo = kd_off + 8 * n;
      const uint32_t kb_big[2] = {bits(kt[bo]), bits(kt[bo + kStride])};
      const uint32_t kb_small[2] = {bits(k_small[bo]),
                                    bits(k_small[bo + kStride])};
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(part, da_big, da_small, kb_big, kb_small);
      accumulate(acc[n], part);
    }
    __syncthreads();  // every warp is done with this stage
  }

  // the two key halves' sums of a row meet: the second half's warps hand
  // dQ through shared memory (the Q planes, read no more) to the first
  // half's, which add them and write the rows
  constexpr int kXStride = 32 * kRowGroups;
  float* xs = q_big + (32 * rg + lane);
  static_assert(4 * kDimBlocks * kXStride <= kPlane,
                "dQ of a half fits the Q plane");
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * n + e) * kXStride] = acc[n][e];
    }
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] = acc[n][e] + xs[(4 * n + e) * kXStride];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gr + 8 * r;
    if (row >= Tq) continue;
    float* o = dq + q_base + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      *reinterpret_cast<float2*>(o + 8 * n + 2 * t) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
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
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.Tk + kBlockKeys - 1) / kBlockKeys);
  const dim3 block(kThreads);
  flash_bwd_dkv_kernel<D><<<grid, block, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.m,
      a.l, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.Tq,
      a.Tk, a.Hq, a.Hkv, a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  constexpr int bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hq, (a.Tq + kBlockQ - 1) / kBlockQ);
  const dim3 block(kThreads);
  flash_bwd_dq_kernel<D><<<grid, block, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.m,
      a.l, a.delta, static_cast<float*>(dq), a.Tq, a.Tk, a.Hq, a.Hkv,
      a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype must be 0 (float32): bf16 operands go to flash_bwd_mma.cu.  m, l
// and delta are f32 [B*Hq, Tq].  The wrapper (kernels/flash_bwd.py)
// checks shapes, types, contiguity, 16-byte alignment, D in {32, 64,
// 128}, Hq % Hkv == 0, Tk >= 1 and the grid's y extent.
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* g, const float* m, const float* l,
                         const float* delta, void* dk, void* dv, int B,
                         int Tq, int Tk, int Hq, int Hkv, int D, int dtype,
                         int causal, long long q_offset, long long k_offset,
                         float scale, cudaStream_t stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, g, m, l, delta, B, Tq, Tk, Hq, Hkv, causal,
               q_offset, k_offset, scale, stream};
  switch (D) {
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* g, const float* m, const float* l,
                        const float* delta, void* dq, int B, int Tq, int Tk,
                        int Hq, int Hkv, int D, int dtype, int causal,
                        long long q_offset, long long k_offset, float scale,
                        cudaStream_t stream) {
  if (dtype != 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, g, m, l, delta, B, Tq, Tk, Hq, Hkv, causal,
               q_offset, k_offset, scale, stream};
  switch (D) {
    case 32: return launch_dq<32>(a, dq);
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
