// Hand-written Hopper (sm_90a) flash-attention forward kernel for bf16
// operands on the tensor cores.
//
//   flash_fwd_mma  replaces mpi4jax_tpu/ops/flash.py:_kernel (launched by
//                  _flash_fwd_impl) for bf16 operands: softmax(scale *
//                  q k^T) v over key tiles with an online softmax, f32
//                  statistics and accumulator, causal masking with static
//                  offsets, grouped-query heads, and optionally the
//                  per-row statistics m and l.  f32 operands stay on the
//                  CUDA-core kernel of flash_fwd.cu.
//
// Layout: q and out are row-major [B, Tq, Hq, D], k and v [B, Tk, Hkv, D],
// read with strides (no fold, no padding copy); every row must start on
// a 16-byte boundary (the wrapper checks the base pointers).  Query head
// h reads kv head h / (Hq / Hkv).  m and l are f32 [B*Hq, Tq], row
// b*Hq + h, as the Pallas kernel's folded (m, l) outputs.
//
// Semantics kept from the Pallas kernel, term by term:
//   * scores: s = (q . k) * scale in f32.  A bf16 x bf16 product is exact
//     in f32 (8-bit significands give a 16-bit product), so mma.sync with
//     bf16 operands and f32 accumulation differs from the Pallas kernel's
//     (f32(q) * scale) . f32(k) only by the summation order and by where
//     the scale is applied, both f32 roundings.  q is never pre-scaled in
//     bf16: 1/sqrt(D) is not a power of two, so that would add a rounding
//     the Pallas kernel does not have;
//   * the running max starts at the finite _NEG = -0.7 * FLT_MAX, never
//     -inf; causally masked real keys get _NEG, keys at or past Tk get
//     -inf, so a fully masked row ends as uniform weights over the real
//     keys (the mean of V) and padding never enters l;
//   * per key tile: m_new = max(m, max_j s_j), corr = exp(m - m_new),
//     w_j = bf16(exp(bf16(s_j - m_new))) (__expf, the hardware ex2.approx
//     of the argument times log2(e): its few-ulp error moves a weight to
//     the other bf16 neighbour only rarely, which FLASH_LIMITS in
//     chip_smoke.py bounds; corr keeps the accurate expf),
//     l = l * corr + sum_j w_j in f32, acc = acc * corr + sum_j w_j v_j
//     with the bf16 weights against bf16 v and f32 accumulation: exactly
//     an mma.sync whose A operand is the weight fragment;
//   * out = acc / l in bf16; m and l are written separately, never fused
//     into m + log l (the backward kernels recompute the weights from
//     them).
// Key tiles that lie wholly above the causal diagonal are skipped only
// when every row of the query tile sees key 0: such a tile then has
// w == 0 exactly and corr == 1, so skipping it changes nothing.  A query
// tile with a fully masked row visits every tile, as the uniform-weights
// convention needs.
//
// What bounds it on the card: operations.  Causal attention at the
// training shape ([2, 8192, 16, 128] bf16) does 5.5e11 flops on 268 MB,
// far above the H100's operations-per-byte balance, and at the decode
// prefill's shape ([4, 8192, 8, 64]) 2.7e11 on 134 MB.  The CUDA-core
// kernel reached 8-12 TFLOP/s in f32 without FMA; the bf16 tensor cores
// peak at 989.
//
// Design (FlashAttention-2 style, warp-level mma.sync):
//   * one block per (b*Hq + h, query tile), heaviest query tiles first
//     (blockIdx.y counts down the diagonal); each warp owns 16 query rows,
//     so the softmax statistics never leave a warp.  A block has 8 warps
//     (128 rows) at D = 128, so that each K and V tile staged from L2
//     serves twice the rows, and 4 warps (64 rows) at D = 32 and 64,
//     where the tiles are smaller and more blocks hide more latency;
//   * the block's Q tile is staged once through shared memory and held
//     in registers as mma A fragments (ldmatrix): D/16 fragments of 4
//     registers a lane;
//   * K and V tiles of 64 keys go into a two-stage ring in dynamic shared
//     memory through cp.async (16 bytes a copy, zero-filled past Tk), the
//     next tile's copy in flight during this tile's math.  Rows are padded
//     by 16 bytes, so the 8 row addresses of an ldmatrix fall in 8
//     distinct 16-byte bank groups: no bank conflicts;
//   * S = Q K^T with mma.sync.m16n8k16 (bf16 in, f32 out), K fragments
//     through ldmatrix; the online softmax runs on the accumulator
//     fragment in registers: a C fragment holds rows lane/4 and lane/4 + 8
//     at columns 2 (lane % 4) and +1, so a row's max and sum reduce over
//     the 4 lanes of a quad with two shuffles;
//   * the bf16 weights are repacked from the C fragments straight into A
//     fragments for P V (V fragments through ldmatrix.trans): P never
//     goes to shared memory;
//   * masks are applied only on the tiles that need them (the diagonal
//     tiles and the padded last tile).
// At D = 128 a lane holds 64 f32 accumulators, 32 scores and 32 registers
// of Q; two stages of K and V and the Q tile take 102 KB of shared
// memory, which needs cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kPad = 8;               // bf16 elements of padding per row
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

// two floats rounded to bf16, the first in the low half (the element of
// the lower column in an mma fragment register)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// Softmax weight of a max-subtracted score: the exponential of the
// bf16-rounded argument, rounded to bf16 (the Pallas kernel's jnp.exp on
// a bf16 array).
__device__ __forceinline__ float weight(float x) {
  const float arg = __bfloat162float(__float2bfloat16_rn(x));
  return __bfloat162float(__float2bfloat16_rn(__expf(arg)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// warps per block, 16 query rows each
template <int D>
__host__ __device__ constexpr int block_warps() {
  return D == 128 ? 8 : 4;
}

template <int D>
__host__ __device__ constexpr int block_rows() {
  return 16 * block_warps<D>();
}

template <int D>
constexpr int smem_bytes() {
  return (block_rows<D>() + 4 * kBlockK) * (D + kPad) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// Stage rows [row0, row0 + rows) of a [T, D] operand (consecutive rows
// `stride` elements apart) into shared rows of D + kPad elements; rows at
// or past `limit` are zero-filled without a read.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int row0, int rows,
                                           int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kThreads = 32 * block_warps<D>();
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool in = row0 + r < limit;
    const __nv_bfloat16* from =
        src + static_cast<size_t>(in ? row0 + r : 0) * stride + c * 8;
    cp_async_16(dst + r * (D + kPad) + c * 8, from, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * block_warps<D>())
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Tq, int Tk, int Hq, int Hkv, int causal,
                     long long q_offset, long long k_offset, float scale) {
  constexpr int kBlockQ = block_rows<D>();    // query rows per block
  constexpr int kStride = D + kPad;          // elements per shared row
  constexpr int kSteps = D / 16;             // k-steps of Q K^T
  constexpr int kKeyBlocks = kBlockK / 8;    // n-blocks of the scores
  constexpr int kDimBlocks = D / 8;          // n-blocks of the output
  constexpr int kTile = kBlockK * kStride;   // elements per K or V stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBlockQ * kStride;  // [2][kBlockK][kStride]
  __nv_bfloat16* vs = ks + 2 * kTile;          // [2][kBlockK][kStride]

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair 2t, 2t + 1
  const int row0 = q0 + 16 * warp;  // this warp's first query row

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* q_rows = q + (static_cast<size_t>(b) * Tq * Hq + h) * D;
  const __nv_bfloat16* k_rows =
      k + (static_cast<size_t>(b) * Tk * Hkv + hk) * D;
  const __nv_bfloat16* v_rows =
      v + (static_cast<size_t>(b) * Tk * Hkv + hk) * D;

  // key tiles to visit: all of them, or (causal, every row of the tile
  // sees key 0) those up to the last row's diagonal
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal && q_offset + q0 >= k_offset) {
    const int last_row = min(q0 + kBlockQ, Tq) - 1;
    const long long last_key = q_offset + last_row - k_offset;
    const long long needed = last_key / kBlockK + 1;
    if (needed < n_tiles) n_tiles = static_cast<int>(needed);
  }

  stage_rows<D>(qs, q_rows, q_stride, q0, kBlockQ, Tq);
  stage_rows<D>(ks, k_rows, kv_stride, 0, kBlockK, Tk);
  stage_rows<D>(vs, v_rows, kv_stride, 0, kBlockK, Tk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q as A fragments: lanes 0-15 address rows 0-15 at column 0 of a
  // 16x16 block, lanes 16-31 the same rows at column 8
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    ldmatrix_x4(qf[s], qs + (16 * warp + lane % 16) * kStride + 16 * s +
                           8 * (lane / 16));
  }

  float acc[kDimBlocks][4];
#pragma unroll
  for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m_row[2] = {kNeg, kNeg};  // rows g and g + 8
  float l_row[2] = {0.0f, 0.0f};
  const long long qpos[2] = {q_offset + row0 + g, q_offset + row0 + g + 8};

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
    __syncthreads();  // this tile's K and V are in shared memory
    const __nv_bfloat16* kt = ks + stage * kTile;
    const __nv_bfloat16* vt = vs + stage * kTile;
    const int k0 = tile * kBlockK;

    // S = Q K^T: lanes 0-7 address keys 0-7 at dims 0-7 of a 16-key,
    // 16-dim block, lanes 8-15 the same keys at dims 8-15, lanes 16-31
    // keys 8-15 likewise: r[0], r[1] are B of keys 0-7, r[2], r[3] of
    // keys 8-15
    float s[kKeyBlocks][4];
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
#pragma unroll
      for (int n = 0; n < kKeyBlocks; n += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (8 * n + lane % 8 + 8 * (lane / 16)) * kStride +
                           16 * st + 8 * ((lane / 8) % 2));
        mma_16816(s[n], qf[st], r[0], r[1]);
        mma_16816(s[n + 1], qf[st], r[2], r[3]);
      }
    }

    // scale and mask; element e of n-block n is row g + 8 (e / 2), key
    // k0 + 8 n + 2 t + e % 2
    const bool mask_causal =
        causal && k_offset + k0 + kBlockK - 1 > q_offset + q0;
    const bool mask_pad = k0 + kBlockK > Tk;
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        const int key = k0 + 8 * n + 2 * t + e % 2;
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
    float w_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = weight(s[n][e] - m_new[e / 2]);
        w_sum[e / 2] = w_sum[e / 2] + s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] = l_row[r] * corr[r] + quad_sum(w_sum[r]);
    }
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * corr[e / 2];
    }

    // acc += P V: the C fragments of key blocks 2j, 2j + 1 are the A
    // fragment of keys 16j..16j+15; lanes 0-7 address keys 0-7 at dims
    // 0-7 of a 16-key, 16-dim block of V, lanes 8-15 keys 8-15, lanes
    // 16-31 the same at dims 8-15, transposed on the way
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]),
          pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]),
      };
#pragma unroll
      for (int n = 0; n < kDimBlocks; n += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (16 * j + lane % 16) * kStride + 8 * n +
                                 8 * (lane / 16));
        mma_16816(acc[n], a, r[0], r[1]);
        mma_16816(acc[n + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Tq) continue;
    __nv_bfloat16* o =
        out + ((static_cast<size_t>(b) * Tq + row) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < kDimBlocks; ++n) {
      *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * r] / l_row[r], acc[n][2 * r + 1] / l_row[r]);
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
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Tq + block_rows<D>() - 1) / block_rows<D>());
  const dim3 block(32 * block_warps<D>());
  flash_fwd_mma_kernel<D><<<grid, block, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      m_out, l_out, Tq, Tk, Hq, Hkv, causal, q_offset, k_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 operands only.  m_out and l_out are both null or both f32
// [B*Hq, Tq].  The wrapper (kernels/flash.py) checks shapes, types,
// contiguity, 16-byte alignment, D in {32, 64, 128}, Hq % Hkv == 0 and
// Tk >= 1.
int flash_fwd_mma_launch(const void* q, const void* k, const void* v,
                         void* out, float* m_out, float* l_out, int B, int Tq,
                         int Tk, int Hq, int Hkv, int D, int causal,
                         long long q_offset, long long k_offset, float scale,
                         cudaStream_t stream) {
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

const char* flash_fwd_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
