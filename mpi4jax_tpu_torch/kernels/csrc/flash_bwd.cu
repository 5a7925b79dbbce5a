// Hand-written Hopper (sm_90a) flash-attention backward kernels for f32
// operands, on the CUDA cores.
//
//   flash_bwd_dkv  replaces mpi4jax_tpu/ops/flash.py:_bwd_dkv_kernel
//                  (launched by _flash_bwd) for f32 operands: dK and dV
//                  of one block of keys, accumulated over the query rows
//                  that see them.
//   flash_bwd_dq   replaces mpi4jax_tpu/ops/flash.py:_bwd_dq_kernel for
//                  f32 operands: dQ of one block of query rows,
//                  accumulated over the keys they see.
// bf16 operands go to the tensor-core kernels of flash_bwd_mma.cu.
//
// Layout: q, dO and dq are row-major [B, Tq, Hq, D], k, v, dk and dv
// [B, Tk, Hkv, D] (the [B, T, H, D] operands of flash_attention, read with
// strides: no fold and no padding copy).  Query head h reads kv head
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
//     p = exp(s - m) / l;
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
// What bounds it on the card: operations.  dkv does four products per
// visible (query, key) pair (s, dP, dV, dK), dq three (s, dP, dQ), each
// 2·D operations, against f32's 67 TFLOP/s outside the tensor cores; the
// kernels run them in f32 on the CUDA cores, as flash_fwd.cu does.
//
// Design:
//   dkv: one block per (b*Hkv + kv head, 64-key tile), earliest (heaviest)
//        key tiles first.  D/32 threads share a key, each owning 32 of its
//        head dims (float4 chunks c with c % (D/32) == its part): its k and
//        v rows and its f32 dK, dV accumulators live in registers.  Query
//        tiles of 32 rows (q pre-scaled, dO, m, l, delta) are staged in
//        shared memory as f32; every thread of a warp reads the same row,
//        so the float4 reads broadcast without bank conflicts.
//   dq:  one block per (b*Hq + h, 64-row query tile), last (heaviest) tiles
//        first, laid out as flash_fwd.cu: q, dO and the f32 dQ accumulator
//        in registers, 32-key tiles of k (pre-scaled) and v in shared
//        memory.
//   A row's partial dot products are summed across its threads with a
//   shuffle butterfly, which leaves the identical sum in each of them.
//
// Built with -fmad=false (see _build.py): every product and sum rounds on
// its own, as in the plain PyTorch version.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlockKeys = 64;  // dkv: keys per block
constexpr int kQTile = 32;      // dkv: query rows per shared-memory tile
constexpr int kBlockQ = 64;     // dq: query rows per block
constexpr int kKTile = 32;      // dq: keys per shared-memory tile
constexpr int kDimsPerThread = 32;
constexpr int kChunks = kDimsPerThread / 4;  // float4 chunks per thread
// _NEG of the JAX package: the double product rounded to float.
constexpr float kNeg = static_cast<float>(-0.7 * 3.4028234663852886e38);

// Sum over the kParts threads that share a row (a butterfly: every one of
// them ends with the identical sum).
template <int kParts>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int lane = kParts / 2; lane > 0; lane /= 2) {
    x = x + __shfl_xor_sync(0xffffffffu, x, lane);
  }
  return x;
}

template <int D>
__global__ void __launch_bounds__(kBlockKeys * (D / kDimsPerThread))
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int Hq, int Hkv,
                     int causal, long long q_offset, long long k_offset,
                     float scale) {
  constexpr int kParts = D / kDimsPerThread;  // threads per key
  constexpr int kThreads = kBlockKeys * kParts;
  constexpr int kRowChunks = D / 4;
  __shared__ float4 qs[kQTile][kRowChunks];  // scaled q rows
  __shared__ float4 gs[kQTile][kRowChunks];  // dO rows
  __shared__ float m_s[kQTile];
  __shared__ float l_s[kQTile];
  __shared__ float delta_s[kQTile];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kBlockKeys;
  const int tid = threadIdx.x;
  const int part = tid % kParts;
  const int key = k0 + tid / kParts;
  const bool live = key < Tk;
  const long long kpos = k_offset + key;

  // this thread's dims of its key's k and v rows
  float kr[kDimsPerThread];
  float vr[kDimsPerThread];
  const size_t kv_base = ((static_cast<size_t>(b) * Tk + key) * Hkv + hk) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = 4 * (part + kParts * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kr[4 * c + e] = live ? k[kv_base + d0 + e] : 0.0f;
      vr[4 * c + e] = live ? v[kv_base + d0 + e] : 0.0f;
    }
  }
  float dkr[kDimsPerThread];
  float dvr[kDimsPerThread];
#pragma unroll
  for (int d = 0; d < kDimsPerThread; ++d) {
    dkr[d] = 0.0f;
    dvr[d] = 0.0f;
  }

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

  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const size_t stat_base = (static_cast<size_t>(b) * Hq + h) * Tq;
    for (int t = first; t < n_tiles; ++t) {
      const int q0 = t * kQTile;
      const int rows = min(kQTile, Tq - q0);
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < rows * D; idx += kThreads) {
        const int i = idx / D;
        const int d = idx % D;
        const size_t off =
            ((static_cast<size_t>(b) * Tq + q0 + i) * Hq + h) * D + d;
        reinterpret_cast<float*>(qs[i])[d] = q[off] * scale;
        reinterpret_cast<float*>(gs[i])[d] = g[off];
      }
      for (int i = tid; i < rows; i += kThreads) {
        m_s[i] = m[stat_base + q0 + i];
        l_s[i] = l[stat_base + q0 + i];
        delta_s[i] = delta[stat_base + q0 + i];
      }
      __syncthreads();

      for (int i = 0; i < rows; ++i) {
        float s = 0.0f;
        float dp = 0.0f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 qq = qs[i][part + kParts * c];
          const float4 gg = gs[i][part + kParts * c];
          s = s + qq.x * kr[4 * c];
          s = s + qq.y * kr[4 * c + 1];
          s = s + qq.z * kr[4 * c + 2];
          s = s + qq.w * kr[4 * c + 3];
          dp = dp + gg.x * vr[4 * c];
          dp = dp + gg.y * vr[4 * c + 1];
          dp = dp + gg.z * vr[4 * c + 2];
          dp = dp + gg.w * vr[4 * c + 3];
        }
        s = row_sum<kParts>(s);
        dp = row_sum<kParts>(dp);
        const bool seen = !causal || q_offset + q0 + i >= kpos;
        if (!seen) s = kNeg;
        if (!live) s = -INFINITY;
        const float p = expf(s - m_s[i]) / l_s[i];
        const float ds = (seen && live) ? p * (dp - delta_s[i]) : 0.0f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 qq = qs[i][part + kParts * c];
          const float4 gg = gs[i][part + kParts * c];
          dvr[4 * c] = dvr[4 * c] + p * gg.x;
          dvr[4 * c + 1] = dvr[4 * c + 1] + p * gg.y;
          dvr[4 * c + 2] = dvr[4 * c + 2] + p * gg.z;
          dvr[4 * c + 3] = dvr[4 * c + 3] + p * gg.w;
          dkr[4 * c] = dkr[4 * c] + ds * qq.x;
          dkr[4 * c + 1] = dkr[4 * c + 1] + ds * qq.y;
          dkr[4 * c + 2] = dkr[4 * c + 2] + ds * qq.z;
          dkr[4 * c + 3] = dkr[4 * c + 3] + ds * qq.w;
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = 4 * (part + kParts * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[kv_base + d0 + e] = dkr[4 * c + e];
      dv[kv_base + d0 + e] = dvr[4 * c + e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockQ * (D / kDimsPerThread))
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int Hq, int Hkv, int causal,
                    long long q_offset, long long k_offset, float scale) {
  constexpr int kParts = D / kDimsPerThread;  // threads per query row
  constexpr int kThreads = kBlockQ * kParts;
  constexpr int kRowChunks = D / 4;
  __shared__ float4 ks[kKTile][kRowChunks];  // scaled k rows
  __shared__ float4 vs[kKTile][kRowChunks];

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

  // this thread's dims of its query row and of dO's
  float qr[kDimsPerThread];
  float gr[kDimsPerThread];
  const size_t q_base = ((static_cast<size_t>(b) * Tq + row) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = 4 * (part + kParts * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = live ? q[q_base + d0 + e] : 0.0f;
      gr[4 * c + e] = live ? g[q_base + d0 + e] : 0.0f;
    }
  }
  float acc[kDimsPerThread];
#pragma unroll
  for (int d = 0; d < kDimsPerThread; ++d) acc[d] = 0.0f;
  const size_t stat = static_cast<size_t>(bh) * Tq + row;
  const float m_row = live ? m[stat] : 0.0f;
  const float l_row = live ? l[stat] : 1.0f;
  const float delta_row = live ? delta[stat] : 0.0f;

  // key tiles to visit: all of them, or (causal) those up to the last
  // row's diagonal; above it ds is 0 for every row
  int n_tiles = (Tk + kKTile - 1) / kKTile;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, Tq) - 1;
    const long long last_key = q_offset + last_row - k_offset;
    const long long needed = last_key < 0 ? 0 : last_key / kKTile + 1;
    if (needed < n_tiles) n_tiles = static_cast<int>(needed);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kk0 = t * kKTile;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kKTile * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int key = kk0 + j;
      float kx = 0.0f;
      float vx = 0.0f;
      if (key < Tk) {
        const size_t off =
            ((static_cast<size_t>(b) * Tk + key) * Hkv + hk) * D + d;
        kx = k[off] * scale;
        vx = v[off];
      }
      reinterpret_cast<float*>(ks[j])[d] = kx;
      reinterpret_cast<float*>(vs[j])[d] = vx;
    }
    __syncthreads();

    const int n_keys = min(kKTile, Tk - kk0);  // uniform over the block
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = ks[j][part + kParts * c];
        const float4 vv = vs[j][part + kParts * c];
        s = s + qr[4 * c] * kk.x;
        s = s + qr[4 * c + 1] * kk.y;
        s = s + qr[4 * c + 2] * kk.z;
        s = s + qr[4 * c + 3] * kk.w;
        dp = dp + gr[4 * c] * vv.x;
        dp = dp + gr[4 * c + 1] * vv.y;
        dp = dp + gr[4 * c + 2] * vv.z;
        dp = dp + gr[4 * c + 3] * vv.w;
      }
      s = row_sum<kParts>(s);
      dp = row_sum<kParts>(dp);
      const bool seen = !causal || qpos >= k_offset + kk0 + j;
      if (!seen) continue;  // ds == 0: nothing to add
      const float p = expf(s - m_row) / l_row;
      const float ds = p * (dp - delta_row);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = ks[j][part + kParts * c];
        acc[4 * c] = acc[4 * c] + ds * kk.x;
        acc[4 * c + 1] = acc[4 * c + 1] + ds * kk.y;
        acc[4 * c + 2] = acc[4 * c + 2] + ds * kk.z;
        acc[4 * c + 3] = acc[4 * c + 3] + ds * kk.w;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = 4 * (part + kParts * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[q_base + d0 + e] = acc[4 * c + e];
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
  const dim3 grid(a.B * a.Hkv, (a.Tk + kBlockKeys - 1) / kBlockKeys);
  const dim3 block(kBlockKeys * (D / kDimsPerThread));
  flash_bwd_dkv_kernel<D><<<grid, block, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.m,
      a.l, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.Tq,
      a.Tk, a.Hq, a.Hkv, a.causal, a.q_offset, a.k_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const dim3 grid(a.B * a.Hq, (a.Tq + kBlockQ - 1) / kBlockQ);
  const dim3 block(kBlockQ * (D / kDimsPerThread));
  flash_bwd_dq_kernel<D><<<grid, block, 0, a.stream>>>(
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
// checks shapes, types, contiguity, D in {32, 64, 128}, Hq % Hkv == 0,
// Tk >= 1 and the grid's y extent.
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
