// Causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas).  Same function:
//   q [B, Hq, S, D], k/v [B, Hkv, T, D], contiguous, float32 or bfloat16;
//   query head h reads KV head h / (Hq / Hkv) -- K/V are never repeated;
//   causal mask aligned at the ends of the windows: key j is live for query
//   row i when j <= i + (T - S);
//   online softmax with float32 running max m, normalizer l and accumulator;
//   output in q's dtype, acc / l with l == 0 mapped to 1 as the reference does.
//
// Design.  One block of 256 threads per (64-row q tile, q head, batch).  The
// block stages its q tile once, then walks the KV axis in 64-key tiles staged
// in shared memory (the loop takes the place of the TPU's sequential grid
// axis; on Hopper nothing carries over between blocks).  KV tiles wholly past
// the causal diagonal are never loaded.  A ragged S or T is masked here, so
// every length takes the kernel.  Thread (ty, tx) = (tid / 16, tid % 16) owns
// score rows ty + 16*i and score columns tx + 16*j (i, j < 4), and output
// columns tx + 16*c (c < D / 16); the 16 threads of a row group sit in one
// half-warp, so the row max and row sum are shuffle reductions.  Shared tiles
// have padded rows (D + 4 floats) so that the float4 reads of the QK^T loop
// are free of bank conflicts.
//
// Bound.  Causal prefill at granite-8b's heads (Hq 32, Hkv 8, D 128) does
// 4*D flops per live (query, key) pair: at S = T = 1024 in float32 that is
// ~8.6 GFLOP against ~42 MB of q, k, v and o, some 200 flops a byte, far
// above the card's float32 ridge (~20), so the kernel is bound by operations.  This simple design runs
// them as float32 FMAs on the CUDA cores (exact float32, as the reference
// asks; the tensor cores would give TF32).  Left for a later change: wgmma
// for bf16 inputs, TMA loads into a multi-stage ring with a producer warp,
// and more than one block per SM at D = 128 (the tiles take 116 KiB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // floats of padding per shared row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + PAD) + 2 * BK * (D + PAD) +
                                  BQ * (BK + PAD));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int s_len, int t_len, int causal, float scale) {
  constexpr int LD = D + PAD;   // row stride of the q, k and v tiles
  constexpr int LP = BK + PAD;  // row stride of the probability tile
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [BQ][LD]
  float* ks = qs + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* ps = vs + BK * LD;     // [BQ][LP]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int offset = t_len - s_len;

  const T* qb = q + (size_t)(b * hq + h) * s_len * D;
  const T* kb = k + (size_t)(b * hkv + hk) * t_len * D;
  const T* vb = v + (size_t)(b * hkv + hk) * t_len * D;
  T* ob = o + (size_t)(b * hq + h) * s_len * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    qs[r * LD + c] =
        q0 + r < s_len ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  int n_kv = (t_len + BK - 1) / BK;
  if (causal) {
    // the last live query row of this tile sees keys up to this position
    const int last = min(q0 + BQ, s_len) - 1 + offset;
    n_kv = min(n_kv, last / BK + 1);
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < t_len;
      ks[r * LD + c] = in ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * LD + c] = in ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * jj) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qv[i].x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv[i].y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv[i].z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv[i].w, kv[jj].w, s[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const bool live = kpos < t_len && (!causal || kpos <= qpos);
        s[i][jj] = live ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no live key yet keeps p = 0 and alpha = 0 (no inf - inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_use);
        ps[row * LP + tx + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * LP + kk]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        const float v0 = vs[(kk + 0) * LD + col];
        const float v1 = vs[(kk + 1) * LD + col];
        const float v2 = vs[(kk + 2) * LD + col];
        const float v3 = vs[(kk + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s_len) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(&ob[(size_t)r * D + tx + 16 * c], acc[i][c] / safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s_len, int t_len, int causal, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s_len + BQ - 1) / BQ, hq, b);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s_len, t_len,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int b, int hq, int hkv, int s_len, int t_len, int causal,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); an unsupported dtype or head size gives
// cudaErrorInvalidValue without a launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int b,
                                     int hq, int hkv, int s_len, int t_len,
                                     int d, int causal, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                             scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, s_len, t_len,
                                     causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
