// Flash attention backward for Hopper, sm_90a: dQ, dK and dV of causal or
// non-causal GQA attention, float32 FMAs on the CUDA cores.
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention_pallas
// has no backward: the JAX package's training gradient is XLA's autodiff of
// the plain attention (src/repro/kernels/ref.py::attention_ref).  On the card
// the port's forward is a CUDA kernel, so its gradient is this kernel; it
// computes the same function as that autodiff:
//   q, o, dO [B, Hq, S, D]; k, v [B, Hkv, T, D]; contiguous, float32 or
//   bfloat16, D in {32, 64, 128}; query head h reads KV head h / (Hq / Hkv);
//   causal mask aligned at the ends of the windows (key j is live for query
//   row i when j <= i + T - S);
//   P = softmax(scale Q K^T), dV = P^T dO, dP = dO V^T,
//   dS = P * (dP - rowsum(dO * O)), dQ = scale dS K, dK = scale dS^T Q,
//   and a KV head's dK and dV sum over the query heads of its group;
//   float32 accumulation, gradients written in the inputs' dtype.
//
// Three kernels, launched one after the other by one C call:
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
// each; this design does 8 (the pre-pass's Q K^T, and Q K^T and dO V^T
// again in kernel 3).  At the training shape (B 2, Hq 32, Hkv 8, S = T =
// 2048, D 128, causal) the 5 take 172 GFLOP against ~335 MB of q, k, v, o,
// dO, dq, dk and dv in float32: bound by operations, 2.56 ms at the 67
// TFLOP/s float32 FMA peak, 1.04 ms at the 3xTF32 tensor-core rate (495 / 3
// TFLOP/s), which would keep float32's accuracy.  A simple kernel that is
// right comes first; the tensor cores are later work.
//
// Layout of the products.  256 threads; thread (ty, tx) = (tid / 16,
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
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, hq,
                            hkv, s_len, t_len, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
