// Hand-written Hopper (sm_90a) flash-attention forward kernel for f32
// operands, on the CUDA cores.
//
//   flash_fwd  replaces mpi4jax_tpu/ops/flash.py:_kernel (launched by
//              _flash_fwd_impl) for f32 operands: softmax(scale * q k^T) v
//              over key tiles with an online softmax, f32 statistics and
//              accumulator, causal masking with static offsets,
//              grouped-query heads, and optionally the per-row statistics
//              m and l.  bf16 operands go to the tensor-core kernel of
//              flash_fwd_mma.cu.
//
// Layout: q and out are row-major [B, Tq, Hq, D], k and v [B, Tk, Hkv, D]
// (the [B, T, H, D] operands of flash_attention, read with strides: no
// fold into [B*H, T, D] and no padding copy).  Query head h reads kv head
// h / (Hq / Hkv).  m and l are f32 [B*Hq, Tq], row b*Hq + h, as the
// Pallas kernel's folded (m, l) outputs.  T is float.
//
// Semantics kept from the Pallas kernel, term by term:
//   * the scale rides q: q = f32(q) * scale, then s = q . k in f32;
//   * the running max starts at the finite _NEG = -0.7 * FLT_MAX, never
//     -inf; causally masked real keys get _NEG, keys at or past Tk get
//     -inf, so a fully masked row ends as uniform weights over the real
//     keys (the mean of V) and padding never enters l;
//   * per key tile: m_new = max(m, max_j s_j), corr = exp(m - m_new),
//     w_j = exp(s_j - m_new), l = l * corr + sum_j w_j,
//     acc = acc * corr + sum_j w_j v_j with f32 accumulation;
//   * out = acc / l; m and l are written separately, never
//     fused into m + log l.
// Key tiles that lie wholly above the causal diagonal are skipped, the
// effect of the Pallas triangle grid: for a query tile whose rows all see
// key 0 such a tile has w == 0 exactly and corr == 1, so skipping it
// changes nothing.  A query tile with a fully masked row visits every
// tile, as the uniform-weights convention needs.
//
// What bounds it on the card: operations.  Causal attention at the
// decode path's prefill shape ([4, 8192, 8, 64]) does 2.75e11 flops on
// 268 MB in f32, far above the H100's operations-per-byte balance.  It
// runs them on the CUDA cores in f32: the f32 path keeps exact f32
// products, which the tensor cores (TF32 at best) would not.
//
// Design: one block per (b*Hq + h, 64-row query tile), heaviest query
// tiles first (blockIdx.y counts down the diagonal).  D/32 threads share
// a query row, each owning 32 of its head dims (float4 chunks c with
// c % (D/32) == its part): q (pre-scaled), the accumulator and the tile's
// scores live in registers.  K and V tiles of 32 keys are staged through
// shared memory as f32; every thread of a warp reads the same key, so the
// float4 reads broadcast without bank conflicts.  A row's partial dot
// products are summed across its threads with a shuffle butterfly, which
// leaves the identical sum in each of them.
//
// Built with -fmad=false (see _build.py): every product and sum rounds on
// its own, as in the plain PyTorch version, so the f32 form agrees with
// it to the rounding of the summation order alone.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 32;  // keys per shared-memory tile
constexpr int kDimsPerThread = 32;
// _NEG of the JAX package: the double product rounded to float.
constexpr float kNeg = static_cast<float>(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Softmax weight of a max-subtracted score.
__device__ __forceinline__ float weight(float x, float) { return expf(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D / kDimsPerThread))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int Tq, int Tk, int Hq, int Hkv, int causal,
                 long long q_offset, long long k_offset, float scale) {
  constexpr int kParts = D / kDimsPerThread;  // threads per query row
  constexpr int kThreads = kBlockQ * kParts;
  constexpr int kChunks = kDimsPerThread / 4;  // float4 chunks per thread
  constexpr int kRowChunks = D / 4;
  __shared__ float4 ks[kBlockK][kRowChunks];
  __shared__ float4 vs[kBlockK][kRowChunks];

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int part = tid % kParts;
  const int row = q0 + tid / kParts;
  const bool live = row < Tq;
  const long long qpos = q_offset + row;

  // this thread's dims of its (scaled) query row
  float qr[kDimsPerThread];
  const size_t q_base = ((static_cast<size_t>(b) * Tq + row) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = 4 * (part + kParts * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * i + e] = live ? to_float(q[q_base + d0 + e]) * scale : 0.0f;
    }
  }

  float acc[kDimsPerThread];
#pragma unroll
  for (int d = 0; d < kDimsPerThread; ++d) acc[d] = 0.0f;
  float m = kNeg;
  float l = 0.0f;

  // key tiles to visit: all of them, or (causal, every row of the tile
  // sees key 0) those up to the last row's diagonal
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal && q_offset + q0 >= k_offset) {
    const int last_row = min(q0 + kBlockQ, Tq) - 1;
    const long long last_key = q_offset + last_row - k_offset;
    const long long needed = last_key / kBlockK + 1;
    if (needed < n_tiles) n_tiles = static_cast<int>(needed);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int key = k0 + j;
      float kx = 0.0f;
      float vx = 0.0f;
      if (key < Tk) {
        const size_t off =
            ((static_cast<size_t>(b) * Tk + key) * Hkv + hk) * D + d;
        kx = to_float(k[off]);
        vx = to_float(v[off]);
      }
      reinterpret_cast<float*>(ks[j])[d] = kx;
      reinterpret_cast<float*>(vs[j])[d] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float p = 0.0f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = ks[j][part + kParts * i];
        p = p + qr[4 * i] * kk.x;
        p = p + qr[4 * i + 1] * kk.y;
        p = p + qr[4 * i + 2] * kk.z;
        p = p + qr[4 * i + 3] * kk.w;
      }
#pragma unroll
      for (int lane = kParts / 2; lane > 0; lane /= 2) {
        p = p + __shfl_xor_sync(0xffffffffu, p, lane);
      }
      const int key = k0 + j;
      if (causal && qpos < k_offset + key) p = kNeg;
      if (key >= Tk) p = -INFINITY;
      s[j] = p;
      tile_max = fmaxf(tile_max, p);
    }

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float w_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      s[j] = weight(s[j] - m_new, T());
      w_sum = w_sum + s[j];
    }
    l = l * corr + w_sum;

    float pv[kDimsPerThread];
#pragma unroll
    for (int d = 0; d < kDimsPerThread; ++d) pv[d] = 0.0f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float w = s[j];
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = vs[j][part + kParts * i];
        pv[4 * i] = pv[4 * i] + w * vv.x;
        pv[4 * i + 1] = pv[4 * i + 1] + w * vv.y;
        pv[4 * i + 2] = pv[4 * i + 2] + w * vv.z;
        pv[4 * i + 3] = pv[4 * i + 3] + w * vv.w;
      }
    }
#pragma unroll
    for (int d = 0; d < kDimsPerThread; ++d) acc[d] = acc[d] * corr + pv[d];
    m = m_new;
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int d0 = 4 * (part + kParts * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      store(&out[q_base + d0 + e], acc[4 * i + e] / l);
    }
  }
  if (m_out != nullptr && part == 0) {
    const size_t stat = static_cast<size_t>(bh) * Tq + row;
    m_out[stat] = m;
    l_out[stat] = l;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m_out, float* l_out, int B, int Tq, int Tk, int Hq,
                   int Hkv, int causal, long long q_offset,
                   long long k_offset, float scale, cudaStream_t stream) {
  const dim3 grid(B * Hq, (Tq + kBlockQ - 1) / kBlockQ);
  const dim3 block(kBlockQ * (D / kDimsPerThread));
  flash_fwd_kernel<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m_out, l_out, Tq, Tk,
      Hq, Hkv, causal, q_offset, k_offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 operands only.  m_out and l_out are both null or both f32
// [B*Hq, Tq].  The wrapper (kernels/flash.py) checks shapes, types,
// contiguity, D in {32, 64, 128}, Hq % Hkv == 0 and Tk >= 1.
int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                     float* m_out, float* l_out, int B, int Tq, int Tk,
                     int Hq, int Hkv, int D, int causal, long long q_offset,
                     long long k_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<float, 32>(q, k, v, out, m_out, l_out, B, Tq, Tk, Hq,
                               Hkv, causal, q_offset, k_offset, scale, stream);
    case 64:
      return launch<float, 64>(q, k, v, out, m_out, l_out, B, Tq, Tk, Hq,
                               Hkv, causal, q_offset, k_offset, scale, stream);
    case 128:
      return launch<float, 128>(q, k, v, out, m_out, l_out, B, Tq, Tk, Hq,
                                Hkv, causal, q_offset, k_offset, scale,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
