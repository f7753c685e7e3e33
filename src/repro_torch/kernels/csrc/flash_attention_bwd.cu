// Flash attention backward for Hopper, sm_90a: dQ, dK and dV of causal or
// non-causal GQA attention.  Three paths, chosen by the wrapper
// (repro_torch/kernels/flash_attention.py::flash_bwd_path) by the dtype and
// the alignment of q, k, v, o and dO: bfloat16 with all five on 16-byte
// boundaries takes the TMA and wgmma kernels (namespace fb, at the end);
// such float32 the 3xTF32 tensor-core kernels (namespace x3, below); either
// dtype off a 16-byte boundary the FMA kernels that follow this note.
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// has no backward: the JAX package's training gradient is XLA's autodiff of
// the plain attention (src/repro/kernels/ref.py::attention_ref).  On the card
// the port's forward is a CUDA kernel, so its gradient is this kernel; it
// computes the same function as that autodiff:
//   q, o, dO [B, Hq, S, D]; k, v [B, Hkv, T, D]; contiguous, float32 or
//   bfloat16, D in {32, 64, 80, 128}; query head h reads KV head
//   h / (Hq / Hkv);
//   causal mask aligned at the ends of the windows (key j is live for query
//   row i when j <= i + T - S);
//   P = softmax(scale Q K^T), dV = P^T dO, dP = dO V^T,
//   dS = P * (dP - rowsum(dO * O)), dQ = scale dS K, dK = scale dS^T Q,
//   and a KV head's dK and dV sum over the query heads of its group;
//   float32 accumulation, gradients written in the inputs' dtype.
//
// FMA path (off a 16-byte boundary): three kernels, launched one after the
// other by one C call:
//   1. the pre-pass, one block per (64-row q tile, q head, batch): the row's
//      log-sum-exp LSE = m + log l, recomputed by walking the live key tiles
//      with the forward's online max and sum (the forward kernels stay as
//      they are and write no LSE), and Delta = rowsum(dO * O); float32
//      [B, Hq, S] each, in scratch the wrapper allocates;
//   2. dK and dV, one block per (64-key tile, KV head, batch): K and V stay
//      in shared memory, dK and dV in registers, while the block walks the
//      group's q heads and, for each, the q tiles that see the key tile
//      (under the causal mask, rows i >= k0 - (T - S)); per tile P =
//      exp(scale S - LSE), dV += P^T dO, dP = dO V^T, dS = P (dP - Delta),
//      dK += dS^T Q;
//   3. dQ, one block per (64-row q tile, q head, batch): the live key tiles
//      as in the forward, dQ += dS K in registers.
// Each output element is written by one block and summed in one fixed
// order, with no atomics: the result is deterministic, run after run.
// The key tile of kernel 2 and the q tile of kernels 1 and 3 are the grid's
// slowest axis, the causal heavy tiles first.
//
// Bound.  The function needs 5 products of S x T x D over the live (query,
// key) pairs (Q K^T, dO V^T, P^T dO, dS^T Q, dS K), 2 D operations a pair
// each; every path does 8 (the LSE pass's Q K^T, and Q K^T and dO V^T once
// in each of the dK/dV and dQ kernels).  At the training shape (B 2, Hq 32,
// Hkv 8, S = T = 2048, D 128, causal) the 5 take 172 GFLOP against ~335 MB
// of q, k, v, o, dO, dq, dk and dv in float32: bound by operations, 2.56 ms
// at the 67 TFLOP/s float32 FMA peak, 1.04 ms at the 3xTF32 tensor-core
// rate (495 / 3 TFLOP/s), which keeps float32's accuracy; in bfloat16
// (~168 MB) 0.174 ms at the tensor cores' 989 TFLOP/s, and the 8 products
// 0.278 ms.
//
// FMA layout of the products.  256 threads; thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty + 16 i (i < 4) of a 64 x 64 score tile and columns
// tx + 16 j (j < 4), as in the forward's FMA kernel, so a row's max and sum
// are shuffle reductions within a half-warp.  The accumulators of kernels 2
// and 3 (dK, dV over keys; dQ over q rows) are rows ty + 16 i and columns
// tx + 16 c (c < D / 16).  P and dS go through shared memory between the
// two halves of a tile's work.  Tiles are float32 in shared memory, rows
// padded by 4 floats so that the float4 reads of the score products and
// the column reads of the accumulations are free of bank conflicts; loads
// past S or T are zero-filled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
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

// rows [r0, r0 + 64) of a row-major [n_rows, D] matrix into a float tile
// [64][D + PAD], zero past n_rows
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n_rows) {
  constexpr int LD = D + PAD;
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * LD + c] =
        r0 + r < n_rows ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two tiles
// [64][D + PAD]
template <int D>
__device__ __forceinline__ void product_abt(const float* a, const float* b,
                                            int ty, int tx,
                                            float acc[4][4]) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// sum over the 16 lanes of a half-warp (one score row's threads)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the key tiles that q rows [q0, q1) see: all, or under the causal mask up
// to the last row's diagonal
__device__ __forceinline__ int live_key_tiles(int q1, int t_len, int offset,
                                              int causal) {
  const int n = (t_len + BK - 1) / BK;
  return causal ? min(n, (q1 - 1 + offset) / BK + 1) : n;
}

// P and dS of one 64 x 64 tile: p = exp(scale s - lse) on live (row, key)
// pairs, 0 elsewhere (and on a row with no live key, lse = -inf);
// ds = p (dp - delta)
__device__ __forceinline__ void p_ds(float sc[4][4], float dp[4][4],
                                     const float lse[4], const float dlt[4],
                                     int q0, int k0, int ty, int tx,
                                     int s_len, int t_len, int offset,
                                     int causal, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool row_ok = row < s_len && lse[i] != -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live = row_ok && kpos < t_len &&
                        (!causal || kpos <= row + offset);
      const float p = live ? expf(sc[i][j] * scale - lse[i]) : 0.f;
      sc[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dlt[i]);
    }
  }
}

template <int D>
constexpr size_t prepass_smem() {
  return sizeof(float) * (size_t)(2 * 64 * (D + PAD));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_prepass(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ o, const T* __restrict__ dout,
            float* __restrict__ lse, float* __restrict__ delta, int hq,
            int hkv, int s_len, int t_len, int causal, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [BQ][LD]
  float* ks = qs + BQ * LD;     // [BK][LD]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heavy tiles first
  const int hk = h / (hq / hkv);
  const int offset = t_len - s_len;
  const size_t qrow = (size_t)(b * hq + h) * s_len;   // first row of head h
  const T* kb = k + (size_t)(b * hkv + hk) * t_len * D;

  load_tile<T, D>(qs, q + qrow * D, q0, s_len);
  const int n_kv = live_key_tiles(min(q0 + BQ, s_len), t_len, offset,
                                  causal);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous key tile is consumed
    load_tile<T, D>(ks, kb, k0, t_len);
    __syncthreads();
    float sc[4][4];
    product_abt<D>(qs, ks, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const bool live = kpos < t_len && (!causal || kpos <= qpos);
        sc[i][jj] = live ? sc[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // a row with no live key yet keeps l = 0 (no inf - inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sum += expf(sc[i][jj] - m_use);
      l[i] = expf(m[i] - m_use) * l[i] + row_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    float dot = 0.f;
    if (r < s_len) {
      const T* orow = o + (qrow + r) * D;
      const T* grow = dout + (qrow + r) * D;
      for (int c = tx; c < D; c += 16)
        dot = fmaf(to_f32(orow[c]), to_f32(grow[c]), dot);
    }
    dot = row_sum(dot);
    if (r < s_len && tx == 0) {
      lse[qrow + r] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
      delta[qrow + r] = dot;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (size_t)(4 * 64 * (D + PAD) + 2 * BQ * (BK + PAD) + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv, int s_len,
         int t_len, int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int LP = BK + PAD;
  constexpr int CPT = D / 16;   // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;             // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* qs = vs + BK * LD;     // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ps = dos + BQ * LD;    // [BQ][LP]  P of the tile, row = q row
  float* dss = ps + BQ * LP;    // [BQ][LP]  dS of the tile
  float* lse_s = dss + BQ * LP;  // [BQ]
  float* dlt_s = lse_s + BQ;     // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;   // key tile 0 sees the most rows: first
  const int group = hq / hkv;
  const int offset = t_len - s_len;
  const size_t kvrow = (size_t)(b * hkv + hk) * t_len;

  load_tile<T, D>(ks, k + kvrow * D, k0, t_len);
  load_tile<T, D>(vs, v + kvrow * D, k0, t_len);

  float acc_dk[4][CPT], acc_dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc_dk[i][c] = 0.f;
      acc_dv[i][c] = 0.f;
    }

  // under the causal mask, key k0 is live for rows i >= k0 - offset
  const int first = causal ? max(0, k0 - offset) / BQ * BQ : 0;
  for (int g = 0; g < group; ++g) {
    const size_t qrow = (size_t)(b * hq + hk * group + g) * s_len;
    for (int q0 = first; q0 < s_len; q0 += BQ) {
      __syncthreads();   // the previous q tile is consumed
      load_tile<T, D>(qs, q + qrow * D, q0, s_len);
      load_tile<T, D>(dos, dout + qrow * D, q0, s_len);
      if (tid < BQ) {
        const bool in = q0 + tid < s_len;
        lse_s[tid] = in ? lse[qrow + q0 + tid] : -INFINITY;
        dlt_s[tid] = in ? delta[qrow + q0 + tid] : 0.f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4], row_lse[4], row_dlt[4];
      product_abt<D>(qs, ks, ty, tx, sc);    // S[q row][key]
      product_abt<D>(dos, vs, ty, tx, dp);   // dP[q row][key]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        row_lse[i] = lse_s[ty + 16 * i];
        row_dlt[i] = dlt_s[ty + 16 * i];
      }
      p_ds(sc, dp, row_lse, row_dlt, q0, k0, ty, tx, s_len, t_len, offset,
           causal, scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * LP + tx + 16 * j] = sc[i][j];
          dss[(ty + 16 * i) * LP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV[key][col] += sum_r P[r][key] dO[r][col]; dK likewise from dS, Q
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * LP + ty + 16 * i];
          dsv[i] = dss[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float dov = dos[r * LD + tx + 16 * c];
          const float qv = qs[r * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_dv[i][c] = fmaf(pv[i], dov, acc_dv[i][c]);
            acc_dk[i][c] = fmaf(dsv[i], qv, acc_dk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= t_len) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const size_t at = (kvrow + key) * D + tx + 16 * c;
      store(&dk[at], acc_dk[i][c] * scale);
      store(&dv[at], acc_dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(4 * 64 * (D + PAD) + BQ * (BK + PAD));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int hq, int hkv, int s_len, int t_len, int causal,
       float scale) {
  constexpr int LD = D + PAD;
  constexpr int LP = BK + PAD;
  constexpr int CPT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ks = dos + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* dss = vs + BK * LD;    // [BQ][LP]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heavy tiles first
  const int hk = h / (hq / hkv);
  const int offset = t_len - s_len;
  const size_t qrow = (size_t)(b * hq + h) * s_len;
  const size_t kvrow = (size_t)(b * hkv + hk) * t_len;

  load_tile<T, D>(qs, q + qrow * D, q0, s_len);
  load_tile<T, D>(dos, dout + qrow * D, q0, s_len);
  float row_lse[4], row_dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < s_len ? lse[qrow + r] : -INFINITY;
    row_dlt[i] = r < s_len ? delta[qrow + r] : 0.f;
  }
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int n_kv = live_key_tiles(min(q0 + BQ, s_len), t_len, offset,
                                  causal);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();   // the previous key tile and its dS are consumed
    load_tile<T, D>(ks, k + kvrow * D, k0, t_len);
    load_tile<T, D>(vs, v + kvrow * D, k0, t_len);
    __syncthreads();
    float sc[4][4], dp[4][4];
    product_abt<D>(qs, ks, ty, tx, sc);
    product_abt<D>(dos, vs, ty, tx, dp);
    p_ds(sc, dp, row_lse, row_dlt, q0, k0, ty, tx, s_len, t_len, offset,
         causal, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        dss[(ty + 16 * i) * LP + tx + 16 * jj] = dp[i][jj];
    __syncthreads();
    // dQ[row][col] += sum_key dS[row][key] K[key][col]
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * LP + key];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = ks[key * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= s_len) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(&dq[(qrow + r) * D + tx + 16 * c], acc[i][c] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int b, int hq, int hkv, int s_len, int t_len,
           int causal, float scale, cudaStream_t stream) {
  const int n_q = (s_len + BQ - 1) / BQ;
  const int n_k = (t_len + BK - 1) / BK;
  if (n_q > 65535 || n_k > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(bwd_prepass<T, D>, prepass_smem<D>())) ||
      (err = allow_smem(bwd_dkdv<T, D>, dkdv_smem<D>())) ||
      (err = allow_smem(bwd_dq<T, D>, dq_smem<D>())))
    return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  bwd_prepass<T, D><<<dim3(hq, b, n_q), NT, prepass_smem<D>(), stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, hq, hkv, s_len,
      t_len, causal, scale);
  if ((err = cudaGetLastError())) return (int)err;
  bwd_dkdv<T, D><<<dim3(hkv, b, n_k), NT, dkdv_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hkv, s_len, t_len, causal, scale);
  if ((err = cudaGetLastError())) return (int)err;
  bwd_dq<T, D><<<dim3(hq, b, n_q), NT, dq_smem<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), hq, hkv, s_len,
      t_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk, void* dv,
               float* lse, float* delta, int b, int hq, int hkv, int s_len,
               int t_len, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq,
                           hkv, s_len, t_len, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq,
                           hkv, s_len, t_len, causal, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq,
                           hkv, s_len, t_len, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq,
                            hkv, s_len, t_len, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// -- float32 on 16-byte boundaries: 3xTF32 mma.sync ---------------------------
//
// Two kernels, launched one after the other by one C call, on the tensor
// cores in 3xTF32 (mma.sync m16n8k8; each float32 operand a TF32 pair, the
// high part the value itself, which the tensor cores truncate, the low part
// the exact remainder; a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32,
// which keeps float32's accuracy, as in the forward's tf32x3 kernel):
//   1. dQ, one block per (64-row q tile, q head, batch), 4 warps of 16 rows.
//      Q (scaled by scale log2 e: scores in base 2) and dO are stored once
//      in A-fragment order; Delta = rowsum(dO * O) is summed on that load,
//      in the lanes that hold the rows.  First pass: the live key tiles, 32
//      keys each, through a 2-stage cp.async ring, S = Q K^T and the online
//      max and sum give each row's LSE (base 2; +inf for a row past S or
//      with no live key), written with Delta to scratch [B, Hq, S_pad] (S
//      rounded up to 64).  Second pass: the same tiles, V_j loading while
//      S_j and dQ_j are computed and K_{j+1} while dP_{j+1} is: dP = dO V^T,
//      S = Q K^T, P = 2^(S - LSE), dS = P (dP - Delta) in registers, and dQ
//      accumulated transposed, dQ^T += K^T dS^T, whose B fragments are the
//      score fragments as they stand (keys 2c, 2c + 1 of a k-step taken as
//      k = c, c + 4), so dS never leaves the registers.
//   2. dK and dV, one block per (64-key tile, KV head, batch), 4 warps of
//      16 keys; K (scaled by scale log2 e) and V stored once in A-fragment
//      order.  The block walks the group's q heads and, for each, the 16-row
//      q steps that see the key tile; Q, dO and their rows' LSE and Delta
//      stream through a 2-stage cp.async ring, the next step loading while
//      this one is computed.  With the keys as the rows, S^T = K Q^T and
//      dP^T = V dO^T leave P^T and dS^T in accumulator fragments, which are
//      the B fragments of dV^T += dO^T P^T and dK^T += Q^T dS^T (q rows 2c,
//      2c + 1 of a k-step as k = c, c + 4): no P or dS in shared memory.
// Every gradient element is written by one block and summed in one fixed
// order, with no atomics: deterministic, run after run.  The q tile of
// kernel 1 and the key tile of kernel 2 are the grid's slowest axis, the
// causal heavy tiles first.
//
// Operands in shared memory.  A row-major tile has rows of D + 4 floats (4
// mod 32 banks), and every fragment is one float4 or two float2s that land
// in the registers the mma wants, with no bank conflicts: the contraction
// over D takes, in k-steps 4u .. 4u + 3, lane c's columns 32u + 8c .. + 7
// (k-step 4u + s: k = c is column 32u + 8c + 2s, k = c + 4 the next), so a
// B fragment of a score product is half of a float4 of row 8n + g, and an
// A fragment in fragment order is one float4 a (k-step, lane); the
// transposed products read float2s of rows 8n + 2c and + 1 at column
// 16 mt + 2g, the output's column order inside a 16-column block following
// (row r of the m-tile is column 16 mt + 2 (r % 8) + r / 8).  At D = 80
// the last 16 columns are a half block: its k-steps 4u and 4u + 1 take lane
// c's columns 32u + 4c .. + 3 (k-step 4u + s: k = c is 32u + 4c + 2s), one
// float4 a row (half_col; its reads meet a 2-way bank conflict on rows of
// 84 floats, the full blocks' none).
// Both kernels take 97 KiB of shared memory at D = 128: two blocks an SM.

namespace x3 {

using namespace hopper;

constexpr int NW = 4;             // warps a block
constexpr int NTH = 32 * NW;
constexpr int BQ = 16 * NW;       // dQ kernel: q rows a block, 16 a warp
constexpr int BKQ = 32;           // dQ kernel: keys a tile
constexpr int NK = BKQ / 8;       // ... its n-tiles of 8 keys
constexpr int BKV = 16 * NW;      // dK/dV kernel: keys a block, 16 a warp
constexpr int BQS = 16;           // dK/dV kernel: q rows a step
constexpr int NQ = BQS / 8;       // ... its n-tiles of 8 rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int LD = D + 4;           // row stride of a tile, floats
  static constexpr int FRAG = 16 * NW * D;   // floats of a block's operand
                                             // in fragment order
  static constexpr int DQ_SMEM = (int)sizeof(float) * (2 * FRAG +
                                                       2 * BKQ * LD);
  static constexpr int DKDV_SMEM =
      (int)sizeof(float) * (2 * FRAG + 4 * BQS * LD + 4 * BQS);
};

// d += a b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x, 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ROWS rows [r0, r0 + ROWS) of a row-major [n, D] matrix into dst (row
// stride D + 4) by 16-byte cp.async, rows at or past n zero-filled; the
// caller commits
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int n) {
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * (D / 4); i += NTH) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    const bool in = r0 + r < n;
    cp_async16(dst + r * Tile<D>::LD + col,
               in ? src + (size_t)(r0 + r) * D + col : src, in ? 16 : 0);
  }
}

// The 8 floats of row r (columns 32u + 8c .. + 7 from p) or zeros
__device__ __forceinline__ void row8(float (&x)[8], const float* p,
                                     bool in) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a = in ? ld4(p) : zero, b = in ? ld4(p + 4) : zero;
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// The column of lane c's float4 in 16-column half hh of a row: halves 2u
// and 2u + 1 of a 32-column block take 32u + 8c and 32u + 8c + 4; a last
// half block (D = 80) takes 16 hh + 4c.  k-steps 2 hh and 2 hh + 1 read
// the float4's halves.
template <int D>
__device__ __forceinline__ int half_col(int hh, int c) {
  return hh < D / 32 * 2 ? 32 * (hh / 2) + 8 * c + 4 * (hh % 2)
                         : 16 * hh + 4 * c;
}

// A warp's 16 rows r0 + g, r0 + g + 8 of a row-major [n, D] matrix (rows at
// or past n zeros), times mul, into dst in A-fragment order: k-step 4u + s
// of lane 4g + c is the float4 (row g, row g + 8) x (column 32u + 8c + 2s,
// + 1) at dst[(4u + s) * 32] (a last half block: k-step 4u + s of columns
// 32u + 4c + 2s, + 1); dst is the lane's own slot
template <int D>
__device__ __forceinline__ void load_frag(float4* dst,
                                          const float* __restrict__ src,
                                          int r0, int n, float mul) {
  const int g = threadIdx.x % 32 / 4, c = threadIdx.x % 4;
  const bool in0 = r0 + g < n, in1 = r0 + g + 8 < n;
  const float* p0 = src + (size_t)(r0 + g) * D + 8 * c;
#pragma unroll
  for (int u = 0; u < D / 32; ++u) {
    float x[8], y[8];
    row8(x, p0 + 32 * u, in0);
    row8(y, p0 + 8 * D + 32 * u, in1);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      dst[(4 * u + s) * 32] =
          make_float4(x[2 * s] * mul, y[2 * s] * mul, x[2 * s + 1] * mul,
                      y[2 * s + 1] * mul);
  }
  if constexpr (D % 32 == 16) {
    constexpr int u = D / 32;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = src + (size_t)(r0 + g) * D + half_col<D>(2 * u, c);
    const float4 x = in0 ? ld4(p) : zero, y = in1 ? ld4(p + 8 * D) : zero;
    dst[(4 * u) * 32] = make_float4(x.x * mul, y.x * mul, x.y * mul,
                                    y.y * mul);
    dst[(4 * u + 1) * 32] = make_float4(x.z * mul, y.z * mul, x.w * mul,
                                        y.w * mul);
  }
}

// s[n] = A B^T: A the warp's 16 rows in fragment order (aw, the lane's
// slot), B rows 8n + g of a row-major tile bt (row stride D + 4); s[n][i]
// is row g (i < 2) or g + 8 of A, row 8n + 2c + i % 2 of B
template <int D, int NN>
__device__ __forceinline__ void product_abt(float (&s)[NN][4],
                                            const float4* aw,
                                            const float* bt, int g, int c) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int hh = 0; hh < D / 16; ++hh) {
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const float4 x = aw[(2 * hh + st) * 32];
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ahi[st][i] = hi_tf32(e[i]);
        alo[st][i] = lo_tf32(e[i]);
      }
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(
          bt + (8 * n + g) * LD + half_col<D>(hh, c));
      const uint32_t bhi[2][2] = {{hi_tf32(x.x), hi_tf32(x.y)},
                                  {hi_tf32(x.z), hi_tf32(x.w)}};
      const uint32_t blo[2][2] = {{lo_tf32(x.x), lo_tf32(x.y)},
                                  {lo_tf32(x.z), lo_tf32(x.w)}};
      mma3(s[n], ahi[0], alo[0], bhi[0], blo[0]);
      mma3(s[n], ahi[1], alo[1], bhi[1], blo[1]);
    }
  }
}

// acc += X^T Y^T, transposed: X a row-major tile (rows 8n + 2c and + 1 of
// k-step n, read as float2s at column 16 mt + 2g), Y given by its score
// fragments y[n] (n-tile 0 from y[n][0..1], n-tile 1 from y[n][2..3]).
// acc[mt][nt][i] is column 16 mt + 2g + i / 2 of X, row 8 nt + 2c + i % 2
// of the fragments' first operand.  The tensor cores truncate each sum
// they accumulate, so over the thousands of k-steps of a gradient the
// accumulator would drift toward zero (~2e-4 of dK at the training
// shape): this call's NN k-steps are summed in registers of their own and
// added to acc with float32's rounding.
template <int D, int NN>
__device__ __forceinline__ void product_atb(float (&acc)[D / 16][2][4],
                                            const float* xt,
                                            const float (&y)[NN][4], int g,
                                            int c) {
  constexpr int LD = Tile<D>::LD;
  uint32_t bhi[NN][2][2], blo[NN][2][2];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bhi[n][i / 2][i % 2] = hi_tf32(y[n][i]);
      blo[n][i / 2][i % 2] = lo_tf32(y[n][i]);
    }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt) {
    float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float* xr = xt + (8 * n + 2 * c) * LD + 2 * g + 16 * mt;
      const float2 a = *reinterpret_cast<const float2*>(xr);
      const float2 b = *reinterpret_cast<const float2*>(xr + LD);
      const uint32_t ahi[4] = {hi_tf32(a.x), hi_tf32(a.y), hi_tf32(b.x),
                               hi_tf32(b.y)};
      const uint32_t alo[4] = {lo_tf32(a.x), lo_tf32(a.y), lo_tf32(b.x),
                               lo_tf32(b.y)};
      mma3(t[0], ahi, alo, bhi[n][0], blo[n][0]);
      mma3(t[1], ahi, alo, bhi[n][1], blo[n][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += t[nt][i];
  }
}

// row 8 nt + 2c + e of a transposed accumulator, at columns 16 mt + 2g, + 1,
// times mul
template <int D>
__device__ __forceinline__ void store_rows_t(float* out, int nt, int e,
                                             const float (&acc)[D / 16][2][4],
                                             float mul, int g) {
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
    *reinterpret_cast<float2*>(out + 16 * mt + 2 * g) =
        make_float2(acc[mt][nt][e] * mul, acc[mt][nt][2 + e] * mul);
}

template <int D>
__global__ void __launch_bounds__(NTH, 2)
    bwd_x3_dq(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, float* __restrict__ lse,
              float* __restrict__ delta, float* __restrict__ dq, int hq,
              int hkv, int s_len, int s_pad, int t_len, int causal,
              float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float4* qf = reinterpret_cast<float4*>(smem);  // [NW][D / 8][32]
  float4* df = qf + T::FRAG / 4;                  // dO, the same order
  float* ks = smem + 2 * T::FRAG;                 // [BKQ][LD]
  float* vs = ks + BKQ * T::LD;  // [BKQ][LD]; first pass: K's 2nd stage

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heavy tiles first
  const int offset = t_len - s_len;
  const size_t kv = (size_t)(b * hkv + h / (hq / hkv)) * t_len * D;
  const float* kb = k + kv;
  const float* vb = v + kv;
  const size_t qrow = (size_t)(b * hq + h) * s_len;
  int n_kv = (t_len + BKQ - 1) / BKQ;
  if (causal)  // the last live row of the tile sees keys up to here
    n_kv = min(n_kv, (min(q0 + BQ, s_len) - 1 + offset) / BKQ + 1);
  load_rows<D, BKQ>(ks, kb, 0, t_len);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int r_lo = q0 + 16 * warp + g;   // the lane's rows: r_lo, r_lo + 8
  const float4* qw = qf + warp * (D / 8) * 32 + lane;
  const float4* dw = df + warp * (D / 8) * 32 + lane;
  float dlt[2] = {0.f, 0.f};
  {
    const float sl2 = scale * LOG2E;
    load_frag<D>(qf + warp * (D / 8) * 32 + lane, q + qrow * D,
                 q0 + 16 * warp, s_len, sl2);
    // dO in fragment order, and Delta of rows r_lo, r_lo + 8 from the
    // same columns of dO and O, summed over the quad
    const bool in[2] = {r_lo < s_len, r_lo + 8 < s_len};
    float4* dst = df + warp * (D / 8) * 32 + lane;
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      float x[2][8], y[8];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t at = (qrow + r_lo + 8 * r) * D + 32 * u + 8 * c;
        row8(x[r], dout + at, in[r]);
        row8(y, o + at, in[r]);
#pragma unroll
        for (int i = 0; i < 8; ++i) dlt[r] = fmaf(x[r][i], y[i], dlt[r]);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        dst[(4 * u + s) * 32] = make_float4(x[0][2 * s], x[1][2 * s],
                                            x[0][2 * s + 1], x[1][2 * s + 1]);
    }
    if constexpr (D % 32 == 16) {   // the last half block, as load_frag's
      constexpr int u = D / 32;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 x[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t at = (qrow + r_lo + 8 * r) * D + half_col<D>(2 * u, c);
        x[r] = in[r] ? ld4(dout + at) : zero;
        const float4 y = in[r] ? ld4(o + at) : zero;
        dlt[r] = fmaf(x[r].x, y.x, dlt[r]);
        dlt[r] = fmaf(x[r].y, y.y, dlt[r]);
        dlt[r] = fmaf(x[r].z, y.z, dlt[r]);
        dlt[r] = fmaf(x[r].w, y.w, dlt[r]);
      }
      dst[(4 * u) * 32] = make_float4(x[0].x, x[1].x, x[0].y, x[1].y);
      dst[(4 * u + 1) * 32] = make_float4(x[0].z, x[1].z, x[0].w, x[1].w);
    }
    dlt[0] = quad_sum(dlt[0]);
    dlt[1] = quad_sum(dlt[1]);
  }

  // scores of rows r_lo (i < 2), r_lo + 8 at keys k0 + 8n + 2c + i % 2:
  // -inf past T and, under the causal mask, past the row's diagonal; only
  // tiles across either edge are masked
  auto mask = [&](float (&s)[NK][4], int k0) {
    if (k0 + BKQ > t_len || (causal && k0 + BKQ - 1 > q0 + offset)) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + 8 * n + 2 * c + i % 2;
          if (kp >= t_len || (causal && kp > r_lo + 8 * (i / 2) + offset))
            s[n][i] = -INFINITY;
        }
    }
  };

  // first pass: each row's log-sum-exp in base 2, K through a 2-stage ring
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<0>();   // K_j is in
    __syncthreads();      // ... for every warp, which are done with K_j-1
    if (j + 1 < n_kv) {
      load_rows<D, BKQ>(j & 1 ? ks : vs, kb, (j + 1) * BKQ, t_len);
      cp_async_commit();
    }
    float s[NK][4];
    product_abt<D, NK>(s, qw, j & 1 ? vs : ks, g, c);
    mask(s, j * BKQ);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float mn = fmaxf(m[r], quad_max(mx));
      // a row with no live key yet keeps l = 0 (no inf - inf)
      const float mu = mn == -INFINITY ? 0.f : mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        sum += exp2_approx(s[n][2 * r] - mu) +
               exp2_approx(s[n][2 * r + 1] - mu);
      l[r] = exp2_approx(m[r] - mu) * l[r] + sum;
      m[r] = mn;
    }
  }
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = r_lo + 8 * r;
    // +inf for a row past S or with no live key: its P is 0
    lse2[r] = row < s_len && lr > 0.f ? m[r] + log2f(lr) : INFINITY;
    if (c == 0) {   // rows < s_pad: the tile lies inside the scratch
      const size_t at = (size_t)(b * hq + h) * s_pad + row;
      lse[at] = lse2[r];
      delta[at] = row < s_len ? dlt[r] : 0.f;
    }
  }

  // second pass: dQ^T += K^T dS^T; V_j+1 loads while S_j and dQ_j are
  // computed, K_j+1 while dP_j+1 is
  __syncthreads();   // every warp is done with the first pass's K tiles
  load_rows<D, BKQ>(vs, vb, 0, t_len);
  cp_async_commit();
  load_rows<D, BKQ>(ks, kb, 0, t_len);
  cp_async_commit();
  float acc[D / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKQ;
    cp_async_wait<1>();   // V_j is in (K_j may still load)
    __syncthreads();
    float dp[NK][4];
    product_abt<D, NK>(dp, dw, vs, g, c);
    __syncthreads();      // every warp has read V_j
    if (j + 1 < n_kv) load_rows<D, BKQ>(vs, vb, k0 + BKQ, t_len);
    cp_async_commit();
    cp_async_wait<1>();   // K_j is in (V_j+1 may still load)
    __syncthreads();
    float s[NK][4];
    product_abt<D, NK>(s, qw, ks, g, c);
    mask(s, k0);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[n][i] = exp2_approx(s[n][i] - lse2[i / 2]) * (dp[n][i] - dlt[i / 2]);
    product_atb<D, NK>(acc, ks, s, g, c);
    __syncthreads();      // every warp has read K_j
    if (j + 1 < n_kv) load_rows<D, BKQ>(ks, kb, k0 + BKQ, t_len);
    cp_async_commit();
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + 16 * warp + 8 * nt + 2 * c + e;
      if (row < s_len)
        store_rows_t<D>(dq + (qrow + row) * D, nt, e, acc, scale, g);
    }
}

template <int D>
__global__ void __launch_bounds__(NTH, 2)
    bwd_x3_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int hq, int hkv, int s_len,
                int s_pad, int t_len, int causal, float scale) {
  using T = Tile<D>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(16) float smem[];
  float4* kf = reinterpret_cast<float4*>(smem);  // [NW][D / 8][32]
  float4* vf = kf + T::FRAG / 4;                  // V, the same order
  float* qs = smem + 2 * T::FRAG;                 // [2][BQS][LD]
  float* dos = qs + 2 * BQS * LD;                 // [2][BQS][LD]
  float* ls = dos + 2 * BQS * LD;                 // [2][BQS] LSE, base 2
  float* dls = ls + 2 * BQS;                      // [2][BQS] Delta

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;   // key tile 0 sees the most rows: first
  const int group = hq / hkv;
  const int offset = t_len - s_len;
  const size_t kvrow = (size_t)(b * hkv + hk) * t_len;
  // under the causal mask, key k0 is live for rows i >= k0 - offset
  const int first = causal ? max(0, k0 - offset) / BQS * BQS : 0;
  const int n_qt = first < s_len ? (s_len - first + BQS - 1) / BQS : 0;
  const int total = group * n_qt;   // q steps: the group's heads in turn

  // q step it into stage it % 2: Q and dO rows (zero past S) and their
  // LSE and Delta (the scratch covers s_pad >= q0 + BQS rows); one group
  auto issue = [&](int it) {
    const int st = it & 1, q0 = first + it % n_qt * BQS;
    const int head = hk * group + it / n_qt;
    const size_t qrow = (size_t)(b * hq + head) * s_len;
    load_rows<D, BQS>(qs + st * BQS * LD, q + qrow * D, q0, s_len);
    load_rows<D, BQS>(dos + st * BQS * LD, dout + qrow * D, q0, s_len);
    const int t = threadIdx.x;
    if (t < BQS / 2) {
      const size_t at =
          (size_t)(b * hq + head) * s_pad + q0 + t % (BQS / 4) * 4;
      const bool is_lse = t < BQS / 4;
      cp_async16((is_lse ? ls : dls) + st * BQS + t % (BQS / 4) * 4,
                 (is_lse ? lse : delta) + at, 16);
    }
    cp_async_commit();
  };
  if (total > 0) issue(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int kw = k0 + 16 * warp;   // the warp's keys: kw + g, kw + g + 8
  const float4* kwf = kf + warp * (D / 8) * 32 + lane;
  const float4* vwf = vf + warp * (D / 8) * 32 + lane;
  load_frag<D>(kf + warp * (D / 8) * 32 + lane, k + kvrow * D, kw, t_len,
               scale * LOG2E);
  load_frag<D>(vf + warp * (D / 8) * 32 + lane, v + kvrow * D, kw, t_len,
               1.f);

  float acc_v[D / 16][2][4], acc_k[D / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_v[mt][nt][i] = 0.f;
        acc_k[mt][nt][i] = 0.f;
      }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<0>();   // step it is in
    __syncthreads();      // ... for every warp, which are done with it - 1
    if (it + 1 < total) issue(it + 1);
    const int st = it & 1, q0 = first + it % n_qt * BQS;
    // under the causal mask a warp whose keys all lie past the step's last
    // row's diagonal adds nothing
    if (causal && kw > q0 + BQS - 1 + offset) continue;
    const float* qt = qs + st * BQS * LD;
    const float* dt = dos + st * BQS * LD;
    // S^T = K Q^T and dP^T = V dO^T: key kw + g + 8 (i / 2), q row
    // q0 + 8n + 2c + i % 2
    float sp[NQ][4], dsp[NQ][4];
    product_abt<D, NQ>(sp, kwf, qt, g, c);
    product_abt<D, NQ>(dsp, vwf, dt, g, c);
    if (causal && kw + 15 > q0 + offset) {
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kw + g + 8 * (i / 2) > q0 + 8 * n + 2 * c + i % 2 + offset)
            sp[n][i] = -INFINITY;
    }
    // P^T = 2^(S^T - LSE) (0 where masked, and on a row whose LSE is +inf)
    // and dS^T = P^T (dP^T - Delta); keys past T are never stored
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 lr = *reinterpret_cast<const float2*>(
          ls + st * BQS + 8 * n + 2 * c);
      const float2 dr = *reinterpret_cast<const float2*>(
          dls + st * BQS + 8 * n + 2 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2_approx(sp[n][i] - (i % 2 ? lr.y : lr.x));
        sp[n][i] = p;
        dsp[n][i] = p * (dsp[n][i] - (i % 2 ? dr.y : dr.x));
      }
    }
    product_atb<D, NQ>(acc_v, dt, sp, g, c);    // dV^T += dO^T P^T
    product_atb<D, NQ>(acc_k, qt, dsp, g, c);   // dK^T += Q^T dS^T
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = kw + 8 * nt + 2 * c + e;
      if (key >= t_len) continue;
      store_rows_t<D>(dv + (kvrow + key) * D, nt, e, acc_v, 1.f, g);
      store_rows_t<D>(dk + (kvrow + key) * D, nt, e, acc_k, scale, g);
    }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, float* dq, float* dk, float* dv, float* lse,
           float* delta, int b, int hq, int hkv, int s_len, int t_len,
           int causal, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  const int n_q = (s_len + BQ - 1) / BQ, n_k = (t_len + BKV - 1) / BKV;
  if (n_q > 65535 || n_k > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(bwd_x3_dq<D>, T::DQ_SMEM)) ||
      (err = allow_smem(bwd_x3_dkdv<D>, T::DKDV_SMEM)))
    return (int)err;
  const int s_pad = n_q * BQ;   // the scratch's rows a head
  bwd_x3_dq<D><<<dim3(hq, b, n_q), NTH, T::DQ_SMEM, stream>>>(
      q, k, v, o, dout, lse, delta, dq, hq, hkv, s_len, s_pad, t_len, causal,
      scale);
  if ((err = cudaGetLastError())) return (int)err;
  bwd_x3_dkdv<D><<<dim3(hkv, b, n_k), NTH, T::DKDV_SMEM, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, hq, hkv, s_len, s_pad, t_len,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace x3

// -- bfloat16 on 16-byte boundaries: TMA + wgmma ------------------------------
//
// Two kernels, launched one after the other by one C call, each a block of
// one consumer warpgroup and one producer warp, as the forward's wgmma
// kernel (flash_attention.cu, namespace fa): the producer's one thread
// TMA-loads [64 x D] bfloat16 tiles (hopper.cuh's Bf16Tile, from 3-D maps
// [B * H, S | T, D], so a box past S or T is zero-filled; the 128-byte
// swizzle, 64-byte at D = 32, and at D = 80 a 128-byte-swizzled box of 64
// columns and a 32-byte-swizzled one of 16, two maps a tensor, the P V-like
// products an n64 and an n16 wgmma a k-step) into a 2-stage ring, each
// stage guarded by a "full" mbarrier (TMA bytes) and an "empty" one (one
// arrival a consumer warp); the consumers run the products on the tensor
// cores by wgmma, bfloat16 in, float32 sums:
//   1. dQ, one block per (64-row q tile, q head, batch), the heaviest causal
//      tiles first.  Q and dO load once; Delta = rowsum(dO * O) of the
//      thread's two rows is summed from 16-byte loads of O and dO while they
//      do.  First pass, K alone through the ring: S = Q K^T over the live
//      key tiles (wgmma_m64n64k16_ss, both K-major) and the online max and
//      sum in base 2 give each row's LSE (+inf for a row past S: its P is
//      0), written with Delta to float32 scratch [B, Hq, S_pad] (S rounded
//      up to 64).  Second pass, K and V through the ring: S = Q K^T and
//      dP = dO V^T, P = 2^(scale log2 e S - LSE), dS = P (dP - Delta) in
//      registers, rounded to bfloat16 where the accumulator already has the
//      layout of wgmma's register A operand, and dQ += dS K by
//      wgmma_m64nDk16_rs with K read MN-major (the transpose bit), as the
//      forward reads V.
//   2. dK and dV, one block per (64-key tile, KV head, batch), key tile 0
//      (the most live rows) first.  K and V load once and stay; the ring
//      carries the group's q heads in turn and, for each, its 64-row q
//      tiles that see the key tile (under the causal mask, rows
//      i >= k0 - (T - S)): Q, dO and their rows' LSE and Delta (two 256-byte
//      bulk copies from the scratch).  With the keys as the rows,
//      S^T = K Q^T and dP^T = V dO^T (_ss, both K-major) leave P^T and
//      dS^T as accumulator fragments, which serve as bfloat16 A operands as
//      they stand; each thread reads the LSE and Delta of its 16 columns
//      (q rows 8 (i / 4) + 2 (l % 4) + i % 2) from shared memory.  Then
//      dV += P^T dO and dK += dS^T Q (_rs, the same Q or dO tile read
//      MN-major where the scores read it K-major).
// Every gradient element is written by one block and summed in one fixed
// order, with no atomics: deterministic, run after run.  Rounding P and dS
// to bfloat16 moves each term by at most 2^-9 of itself, inside bfloat16's
// tolerance against the float32 plain version.  Registers: dK and dV take
// D of a consumer thread's registers (128 at D = 128), S^T and dP^T 64
// more, P^T and dS^T as fragments 32, so the dK/dV kernel at D = 128 runs
// one block an SM; every other kernel two.  Two blocks of five warps put
// three warps on some of the SM's four schedulers, whose 16K registers
// then allow 168 a thread: at D = 80 (80 + 64 + 32 live) that spilled, so
// the D-80 dK/dV block has no producer warp: its consumers' first thread
// issues the loads, each ring step as its stage is released, and two
// 4-warp blocks allow 255 registers a thread (197 used, no spill); its
// ring has 3 stages (Q and dO 20 KiB a stage at D = 80).  Shared memory:
// six [64 x D] tiles (96 KiB at D = 128), eight at D = 80's dK/dV (80 KiB).

namespace fb {

using namespace hopper;
using x3::quad_max;
using x3::quad_sum;

constexpr int BQ = 64, BKV = 64;
constexpr int NTH = 160;               // a consumer warpgroup + a producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile : Bf16Tile<D> {
  static constexpr int STATS = 2 * 2 * 64 * 4;           // 2 x (LSE, Delta)
  // the dQ kernel: 6 tiles, 5 mbarriers (and room for STATS)
  static constexpr int SMEM = 1024 + 6 * Bf16Tile<D>::BYTES + STATS + 5 * 8;
  static constexpr int DKDV_BLOCKS = D == 128 ? 1 : 2;   // blocks an SM
  // the dK/dV kernel at D 80: no producer warp (its consumers' first thread
  // loads) and a 3-stage ring; at D 32, 64 and 128 a producer warp, 2 stages
  static constexpr bool DKDV_SELF_LOAD = D == 80;
  static constexpr int DKDV_THREADS = DKDV_SELF_LOAD ? 128 : NTH;
  static constexpr int DKDV_STAGES = D == 80 ? 3 : 2;
  // K, V, the ring's Q and dO, its LSE and Delta, 1 + 2 stages mbarriers
  static constexpr int DKDV_SMEM = 1024 +
                                   (2 + 2 * DKDV_STAGES) * Bf16Tile<D>::BYTES +
                                   DKDV_STAGES * 2 * 64 * 4 +
                                   (1 + 2 * DKDV_STAGES) * 8;
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int NS = 2>
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);            // the tiles loaded once
    for (int s = 0; s < NS; ++s) {
      mbar_init(&bars[1 + s], 1);      // full
      mbar_init(&bars[1 + NS + s], 4); // empty: one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
}

__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}

template <int D>
__global__ void __launch_bounds__(NTH, 2)
    bwd_wgmma_dq(const __grid_constant__ Bf16Maps<D> map_q,
                 const __grid_constant__ Bf16Maps<D> map_k,
                 const __grid_constant__ Bf16Maps<D> map_v,
                 const __grid_constant__ Bf16Maps<D> map_do,
                 const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int hq, int hkv, int s_len,
                 int s_pad, int t_len, int causal, float scale) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1k(smem_raw);
  uint8_t* dos = qs + T::BYTES;
  uint8_t* ring = dos + T::BYTES;      // stage s: K at ring + 2 s BYTES, V
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + 4 * T::BYTES + T::STATS);
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heavy tiles first
  const int offset = t_len - s_len;
  int n_kv = (t_len + BKV - 1) / BKV;
  if (causal)  // the last live row of the tile sees keys up to here
    n_kv = min(n_kv, (min(q0 + BQ, s_len) - 1 + offset) / BKV + 1);
  init_bars(bars);

  if (threadIdx.x >= 128) {            // the producer warp
    if (threadIdx.x == 128) {
      const int q_row = b * hq + h, kv_row = b * hkv + h / (hq / hkv);
      mbar_expect_tx(bars, 2 * T::BYTES);
      tma_load_tile<D>(qs, &map_q, bars, q0, q_row);
      tma_load_tile<D>(dos, &map_do, bars, q0, q_row);
      // 2 n_kv loads: the first pass's K tiles, then K and V
      for (int it = 0; it < 2 * n_kv; ++it) {
        const int s = it & 1, with_v = it >= n_kv;
        const int k0 = (with_v ? it - n_kv : it) * BKV;
        if (it >= 2) mbar_wait(&empty[s], ((it >> 1) - 1) & 1);
        uint8_t* ks = ring + 2 * s * T::BYTES;
        mbar_expect_tx(&full[s], (1 + with_v) * T::BYTES);
        tma_load_tile<D>(ks, &map_k, &full[s], k0, kv_row);
        if (with_v)
          tma_load_tile<D>(ks + T::BYTES, &map_v, &full[s], k0, kv_row);
      }
    }
    return;
  }

  // the consumer warpgroup: thread t holds rows r_lo and r_lo + 8 of the
  // tile (the accumulator layout in hopper.cuh)
  const int t = threadIdx.x, l4 = t % 4;
  const int r_lo = 16 * (t / 32) + (t % 32) / 4;
  const float sl2 = scale * LOG2E;
  const size_t qrow = (size_t)(b * hq + h) * s_len;

  // Delta of rows r_lo, r_lo + 8: the quad's 4 threads take every 4th
  // 16-byte chunk of the row of O and of dO (D / 8 chunks: 10 at D = 80)
  float dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_lo + 8 * r;
    float sum = 0.f;
    if (row < s_len) {
      const uint4* op = reinterpret_cast<const uint4*>(o + (qrow + row) * D);
      const uint4* gp =
          reinterpret_cast<const uint4*>(dout + (qrow + row) * D);
#pragma unroll
      for (int c = l4; c < D / 8; c += 4) {
        uint4 x = __ldg(op + c), y = __ldg(gp + c);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(x2[e]);
          const float2 g = __bfloat1622float2(y2[e]);
          sum = fmaf(a.x, g.x, fmaf(a.y, g.y, sum));
        }
      }
    }
    dlt[r] = quad_sum(sum);
  }

  // scores of rows r_lo + 8 ((i / 2) % 2) at keys k0 + 8 (i / 4) + 2 l4 +
  // i % 2: -inf past T and, under the causal mask, past the row's diagonal;
  // only tiles across either edge are masked
  auto mask = [&](float (&sc)[32], int k0) {
    if (k0 + BKV > t_len || (causal && k0 + BKV - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * l4 + i % 2;
        const int qp = q0 + r_lo + 8 * ((i / 2) % 2) + offset;
        if (kp >= t_len || (causal && kp > qp)) sc[i] = -INFINITY;
      }
    }
  };

  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);
  mbar_wait(bars, 0);

  // first pass: each row's log-sum-exp in base 2
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, base-2 units
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  for (int jt = 0; jt < n_kv; ++jt) {
    const int s = jt & 1;
    mbar_wait(&full[s], (jt >> 1) & 1);
    wgmma_fence();
    wgmma_tile_nt<D>(sc, q_addr, smem_u32(ring + 2 * s * T::BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    release(&empty[s]);
    mask(sc, jt * BKV);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i / 2) % 2)
        mx1 = fmaxf(mx1, sc[i]);
      else
        mx0 = fmaxf(mx0, sc[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * sl2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * sl2);
    // a row with no live key yet keeps l = 0 (no inf - inf)
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i / 2) % 2)
        ps1 += exp2f(fmaf(sc[i], sl2, -mu1));
      else
        ps0 += exp2f(fmaf(sc[i], sl2, -mu0));
    }
    l0 = exp2f(m0 - mu0) * l0 + ps0;
    l1 = exp2f(m1 - mu1) * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
  }
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(r ? l1 : l0);
    const int row = q0 + r_lo + 8 * r;
    // +inf for a row past S or with no live key: its P is 0
    lse2[r] = row < s_len && lr > 0.f ? (r ? m1 : m0) + log2f(lr) : INFINITY;
    if (l4 == 0) {   // rows < s_pad: the tile lies inside the scratch
      const size_t at = (size_t)(b * hq + h) * s_pad + row;
      lse[at] = lse2[r];
      delta[at] = dlt[r];
    }
  }

  // second pass: dQ += dS K
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int jt = 0; jt < n_kv; ++jt) {
    const int it = n_kv + jt, s = it & 1;
    mbar_wait(&full[s], (it >> 1) & 1);
    const uint32_t k_addr = smem_u32(ring + 2 * s * T::BYTES);
    wgmma_fence();
    wgmma_tile_nt<D>(sc, q_addr, k_addr);
    wgmma_tile_nt<D>(dp, do_addr, k_addr + T::BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);
    mask(sc, jt * BKV);
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j, r = j % 2;   // row r_lo + 8 r
        const float p0 = exp2f(fmaf(sc[i], sl2, -lse2[r]));
        const float p1 = exp2f(fmaf(sc[i + 1], sl2, -lse2[r]));
        ds[kk][j] = pack_bf16(p0 * (dp[i] - dlt[r]),
                              p1 * (dp[i + 1] - dlt[r]));
      }
    wgmma_fence();
    wgmma_tile_rs<D>(acc, ds, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    keep_fragments(ds);
    release(&empty[s]);
  }

  __nv_bfloat16* qb = dq + qrow * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = q0 + r_lo + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * l4;
    if (row < s_len)
      *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)row * D + col) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::DKDV_THREADS, Tile<D>::DKDV_BLOCKS)
    bwd_wgmma_dkdv(const __grid_constant__ Bf16Maps<D> map_q,
                   const __grid_constant__ Bf16Maps<D> map_k,
                   const __grid_constant__ Bf16Maps<D> map_v,
                   const __grid_constant__ Bf16Maps<D> map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                   int s_len, int s_pad, int t_len, int causal, float scale) {
  using T = Tile<D>;
  constexpr int NS = T::DKDV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align_1k(smem_raw);
  uint8_t* vs = ks + T::BYTES;
  uint8_t* ring = vs + T::BYTES;       // stage s: Q at ring + 2 s BYTES, dO
  float* stats = reinterpret_cast<float*>(ring + 2 * NS * T::BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + NS * 2 * BQ);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + NS;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;   // key tile 0 sees the most rows: first
  const int group = hq / hkv;
  const int offset = t_len - s_len;
  // under the causal mask, key k0 is live for rows i >= k0 - offset
  const int first = causal ? max(0, k0 - offset) / BQ * BQ : 0;
  const int n_qt = first < s_len ? (s_len - first + BQ - 1) / BQ : 0;
  const int total = group * n_qt;   // q tiles: the group's heads in turn
  init_bars<NS>(bars);

  if constexpr (!T::DKDV_SELF_LOAD) {
    if (threadIdx.x >= 128) {          // the producer warp
      if (threadIdx.x == 128) {
        const int kv_row = b * hkv + hk;
        mbar_expect_tx(bars, 2 * T::BYTES);
        tma_load_tile<D>(ks, &map_k, bars, k0, kv_row);
        tma_load_tile<D>(vs, &map_v, bars, k0, kv_row);
        for (int it = 0; it < total; ++it) {
          const int s = ring_stage<NS>(it), q0 = first + it % n_qt * BQ;
          const int q_row = b * hq + hk * group + it / n_qt;
          if (it >= NS) mbar_wait(&empty[s], ring_parity<NS>(it - NS));
          uint8_t* qs = ring + 2 * s * T::BYTES;
          mbar_expect_tx(&full[s], 2 * T::BYTES + 2 * BQ * 4);
          tma_load_tile<D>(qs, &map_q, &full[s], q0, q_row);
          tma_load_tile<D>(qs + T::BYTES, &map_do, &full[s], q0, q_row);
          // the rows' LSE and Delta: the scratch covers s_pad >= q0 + 64
          const size_t at = (size_t)q_row * s_pad + q0;
          bulk_load(stats + 2 * BQ * s, lse + at, BQ * 4, &full[s]);
          bulk_load(stats + 2 * BQ * s + BQ, delta + at, BQ * 4, &full[s]);
        }
      }
      return;
    }
  }
  // with no producer warp (D = 80) the consumers' first thread loads K and
  // V, the ring's first NS steps, and each later one as its stage frees
  const auto load = [&](int it) {
    const int s = ring_stage<NS>(it), q0 = first + it % n_qt * BQ;
    const int q_row = b * hq + hk * group + it / n_qt;
    if (it >= NS) mbar_wait(&empty[s], ring_parity<NS>(it - NS));
    uint8_t* qs = ring + 2 * s * T::BYTES;
    mbar_expect_tx(&full[s], 2 * T::BYTES + 2 * BQ * 4);
    tma_load_tile<D>(qs, &map_q, &full[s], q0, q_row);
    tma_load_tile<D>(qs + T::BYTES, &map_do, &full[s], q0, q_row);
    const size_t at = (size_t)q_row * s_pad + q0;
    bulk_load(stats + 2 * BQ * s, lse + at, BQ * 4, &full[s]);
    bulk_load(stats + 2 * BQ * s + BQ, delta + at, BQ * 4, &full[s]);
  };
  if (T::DKDV_SELF_LOAD && threadIdx.x == 0) {
    const int kv_row = b * hkv + hk;
    mbar_expect_tx(bars, 2 * T::BYTES);
    tma_load_tile<D>(ks, &map_k, bars, k0, kv_row);
    tma_load_tile<D>(vs, &map_v, bars, k0, kv_row);
    for (int it = 0; it < min(NS, total); ++it) load(it);
  }

  // the consumer warpgroup: thread t holds keys k0 + r_lo, k0 + r_lo + 8
  // and, of the scores, q rows q0 + 8 (i / 4) + 2 l4 + i % 2
  const int t = threadIdx.x, l4 = t % 4;
  const int r_lo = 16 * (t / 32) + (t % 32) / 4;
  const float sl2 = scale * LOG2E;
  float acc_k[D / 2], acc_v[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  mbar_wait(bars, 0);

  for (int it = 0; it < total; ++it) {
    const int s = ring_stage<NS>(it), q0 = first + it % n_qt * BQ;
    mbar_wait(&full[s], ring_parity<NS>(it));
    const uint32_t q_addr = smem_u32(ring + 2 * s * T::BYTES);
    const uint32_t do_addr = q_addr + T::BYTES;
    wgmma_fence();
    wgmma_tile_nt<D>(st, k_addr, q_addr);     // S^T = K Q^T
    wgmma_tile_nt<D>(dpt, v_addr, do_addr);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);
    if (causal && k0 + BKV - 1 > q0 + offset) {   // across the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + r_lo + 8 * ((i / 2) % 2);
        const int qp = q0 + 8 * (i / 4) + 2 * l4 + i % 2 + offset;
        if (kp > qp) st[i] = -INFINITY;
      }
    }
    // P^T = 2^(scale log2 e S^T - LSE) (0 where masked, and in a column
    // whose LSE is +inf: a row past S) and dS^T = P^T (dP^T - Delta); keys
    // past T are never stored
    const float* ls = stats + 2 * BQ * s;
    const float* dl = ls + BQ;
    uint32_t pt[4][4], dst[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const int col = 16 * kk + 8 * (j / 2) + 2 * l4;   // q rows col, + 1
        const float2 lr = *reinterpret_cast<const float2*>(ls + col);
        const float2 dr = *reinterpret_cast<const float2*>(dl + col);
        const float p0 = exp2f(fmaf(st[i], sl2, -lr.x));
        const float p1 = exp2f(fmaf(st[i + 1], sl2, -lr.y));
        pt[kk][j] = pack_bf16(p0, p1);
        dst[kk][j] = pack_bf16(p0 * (dpt[i] - dr.x), p1 * (dpt[i + 1] - dr.y));
      }
    wgmma_fence();
    wgmma_tile_rs<D>(acc_v, pt, do_addr);    // dV += P^T dO
    wgmma_tile_rs<D>(acc_k, dst, q_addr);    // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_v);
    fence_operands(acc_k);
    keep_fragments(pt);
    keep_fragments(dst);
    release(&empty[s]);
    if constexpr (T::DKDV_SELF_LOAD) {
      if (t == 0 && it + NS < total) load(it + NS);
    }
  }

  const size_t kvrow = (size_t)(b * hkv + hk) * t_len;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = k0 + r_lo + 8 * ((i / 2) % 2);
    const size_t at = (kvrow + key) * D + 8 * (i / 4) + 2 * l4;
    if (key < t_len) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(acc_k[i] * scale, acc_k[i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, int b, int hq, int hkv, int s_len, int t_len,
           int causal, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  const int n_q = (s_len + BQ - 1) / BQ, n_k = (t_len + BKV - 1) / BKV;
  if (n_q > 65535 || n_k > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  Bf16Maps<D> map_q, map_k, map_v, map_do;
  int err = bf16_tile_map<D>(&map_q, q, s_len, b * hq);
  if (!err) err = bf16_tile_map<D>(&map_do, dout, s_len, b * hq);
  if (!err) err = bf16_tile_map<D>(&map_k, k, t_len, b * hkv);
  if (!err) err = bf16_tile_map<D>(&map_v, v, t_len, b * hkv);
  if (err) return err;
  cudaError_t e;
  if ((e = allow_smem(bwd_wgmma_dq<D>, T::SMEM)) ||
      (e = allow_smem(bwd_wgmma_dkdv<D>, T::DKDV_SMEM)))
    return (int)e;
  const int s_pad = n_q * BQ;   // the scratch's rows a head
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* gb = static_cast<const __nv_bfloat16*>(dout);
  bwd_wgmma_dq<D><<<dim3(hq, b, n_q), NTH, T::SMEM, stream>>>(
      map_q, map_k, map_v, map_do, ob, gb, lse, delta,
      static_cast<__nv_bfloat16*>(dq), hq, hkv, s_len, s_pad, t_len, causal,
      scale);
  if ((e = cudaGetLastError())) return (int)e;
  bwd_wgmma_dkdv<D><<<dim3(hkv, b, n_k), T::DKDV_THREADS, T::DKDV_SMEM,
                      stream>>>(
      map_q, map_k, map_v, map_do, lse, delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), hq,
      hkv, s_len, s_pad, t_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace fb

}  // namespace

// dq, dk, dv of attention from q, k, v, its output o and the output's
// gradient dout, all contiguous and of one dtype (0 = float32,
// 1 = bfloat16); lse and delta are float32 scratch of B * Hq * S each.
// Returns cudaGetLastError() after the launches (0 on success); an
// unsupported dtype or head size, or more than 65535 batches or tiles,
// gives cudaErrorInvalidValue without a launch.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta,
                                         int dtype, int b, int hq, int hkv,
                                         int s_len, int t_len, int d,
                                         int causal, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, dout, dq, dk, dv, l, dl, b, hq,
                             hkv, s_len, t_len, causal, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, l, dl,
                                     b, hq, hkv, s_len, t_len, causal, scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}

// float32 in 3xTF32 on the tensor cores: q, k, v, o, dout, dq, dk and dv
// 16-byte aligned (the wrapper checks); lse and delta float32 scratch of
// B * Hq * S_pad each, S_pad = S rounded up to 64, 16-byte aligned.
// Returns cudaGetLastError() after the launches (0 on success); a head size
// other than 32, 64, 80 or 128, or more than 65535 batches or tiles, gives
// cudaErrorInvalidValue without a launch.
extern "C" int repro_flash_attention_bwd_tf32x3(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int b, int hq, int hkv, int s_len, int t_len, int d, int causal,
    float scale, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return x3::launch<32>(f(q), f(k), f(v), f(o), f(dout), w(dq), w(dk),
                            w(dv), w(lse), w(delta), b, hq, hkv, s_len, t_len,
                            causal, scale, st);
    case 64:
      return x3::launch<64>(f(q), f(k), f(v), f(o), f(dout), w(dq), w(dk),
                            w(dv), w(lse), w(delta), b, hq, hkv, s_len, t_len,
                            causal, scale, st);
    case 80:
      return x3::launch<80>(f(q), f(k), f(v), f(o), f(dout), w(dq), w(dk),
                            w(dv), w(lse), w(delta), b, hq, hkv, s_len, t_len,
                            causal, scale, st);
    case 128:
      return x3::launch<128>(f(q), f(k), f(v), f(o), f(dout), w(dq), w(dk),
                             w(dv), w(lse), w(delta), b, hq, hkv, s_len,
                             t_len, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bfloat16 on the tensor cores (TMA + wgmma): q, k, v, o, dout, dq, dk and
// dv 16-byte aligned (the wrapper checks); lse and delta float32 scratch of
// B * Hq * S_pad each, S_pad = S rounded up to 64, 16-byte aligned.
// Returns 0 or a CUDA error code after the launches; a head size other than
// 32, 64, 80 or 128, or more than 65535 batches or tiles, gives
// cudaErrorInvalidValue without a launch.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int b, int hq, int hkv, int s_len, int t_len, int d, int causal,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (d) {
    case 32:
      return fb::launch<32>(q, k, v, o, dout, dq, dk, dv, l, dl, b, hq, hkv,
                            s_len, t_len, causal, scale, st);
    case 64:
      return fb::launch<64>(q, k, v, o, dout, dq, dk, dv, l, dl, b, hq, hkv,
                            s_len, t_len, causal, scale, st);
    case 80:
      return fb::launch<80>(q, k, v, o, dout, dq, dk, dv, l, dl, b, hq, hkv,
                            s_len, t_len, causal, scale, st);
    case 128:
      return fb::launch<128>(q, k, v, o, dout, dq, dk, dv, l, dl, b, hq, hkv,
                             s_len, t_len, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
