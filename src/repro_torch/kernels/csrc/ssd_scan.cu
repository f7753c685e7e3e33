// Mamba-2 SSD chunked scan (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (launched by ssd_scan_pallas).  Same function:
//   x [B, S, H, D], a [B, S, H] (log-decay, <= 0), b, c [B, S, N] shared
//   across the H heads; contiguous, all float32 or all bfloat16;
//   h_t = exp(a_t) h_{t-1} + x_t (x) b_t,  y_t = h_t c_t, with the state
//   h [D, N] of each (batch, head) in float32 and zero at t = 0;
//   y [B, S, H, D] in x's dtype.
// Per chunk of L tokens, with Acum the cumulative sum of a from the chunk's
// start (kept relative to the chunk, as the TPU kernel does):
//   y  = tril(exp(Acum_t - Acum_u) * (C_t . B_u)) @ x + exp(Acum_t) (C_t . h)
//   h <- exp(A_tot) h + (x * exp(A_tot - Acum))^T @ B
//
// Design.  The TPU kernel kept the whole [D, N] state in VMEM scratch and
// carried it along a sequential grid axis.  Here one block of 256 threads
// owns BD = 32 columns of x, y and h for one (batch, head), over the grid
// (ceil(D / 32), H, B), and walks the chunks itself in order: column d of y
// depends only on x[:, d] and row d of h, so the D-tiles are independent,
// and a block's 32 rows of h stay resident in shared memory (48 KiB at
// mLSTM's N = 384, where the whole state would be 576 KiB).  Each block
// recomputes the chunk's [L, L] tile C . B^T, in passes over N of NT = 64
// columns; the same pass adds C . h^T for the carry and then moves that
// column slice of h on to the chunk's end.  Above the diagonal
// exp(Acum_t - Acum_u) overflows (mLSTM's log-decay reaches -13.8 a token),
// so the triangle is selected before the exponential, never multiplied by a
// 0/1 mask.  A ragged last chunk reads x = a = b = c = 0 past S, which
// leaves every earlier output exact; any S, any D (D = 1 for the mLSTM
// normalizer) and N up to what shared memory holds take the kernel.
//
// Bound.  At zamba2's heads (H 32, D 128, N 64) and S = 1024 the function
// is ~1.35 GFLOP against ~34 MB of x, a, b, c and y: ~40 flops a byte, above
// the card's float32 ridge (~20), so bound by operations.  The products are
// float32 FMAs on the CUDA cores (exact float32, as the reference's 3e-3
// asks of float32; the tensor cores would give TF32).  The recomputed
// C . B^T costs up to twice the useful work at D = 384, and mLSTM's grids
// are small (B * 4 heads * 12 D-tiles): tensor cores, TMA and occupancy are
// left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 64;     // tokens per chunk
constexpr int BD = 32;    // columns of x, y and h per block
constexpr int NT = 64;    // state columns per pass
constexpr int NTH = 256;  // threads per block
constexpr int PAD = 4;    // floats of padding per shared row
constexpr int LDC = NT + PAD;  // row stride of the b and c tiles
constexpr int LDX = BD + PAD;  // row stride of the x tile
constexpr int LDG = L + PAD;   // row stride of the G tile
constexpr size_t kSmemLimit = 232448;  // shared memory a Hopper block may use
constexpr int kStateTooWide = -1;      // returned when h's rows do not fit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float dot4(float4 p, float4 q, float acc) {
  acc = fmaf(p.x, q.x, acc);
  acc = fmaf(p.y, q.y, acc);
  acc = fmaf(p.z, q.z, acc);
  return fmaf(p.w, q.w, acc);
}

__host__ __device__ inline int n_padded(int n) {
  return (n + NT - 1) / NT * NT;
}

inline size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)BD * (n_padded(n) + PAD) + 2 * L * LDC +
                          L * LDX + L * LDG + 2 * L + 4);
}

template <typename T>
__global__ void __launch_bounds__(NTH)
ssd_fwd(const T* __restrict__ x, const T* __restrict__ a,
        const T* __restrict__ bm, const T* __restrict__ cm,
        T* __restrict__ y, int s_len, int n_heads, int d_len, int n_len) {
  const int np = n_padded(n_len);
  const int ldh = np + PAD;     // row stride of the state rows
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;             // [BD][ldh]  this block's rows of h
  float* bs = hs + BD * ldh;    // [L][LDC]   b tile
  float* cs = bs + L * LDC;     // [L][LDC]   c tile
  float* xs = cs + L * LDC;     // [L][LDX]   x tile
  float* gs = xs + L * LDX;     // [L][LDG]   decayed, masked C . B^T
  float* acum = gs + L * LDG;   // [L]        Acum
  float* wts = acum + L;        // [L]        exp(A_tot - Acum)
  float* tot = wts + L;         // [1]        exp(A_tot)

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d0 = blockIdx.x * BD;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const size_t xrow = (size_t)n_heads * d_len;  // stride of one token in x, y
  const T* xb = x + (size_t)b * s_len * xrow + (size_t)h * d_len + d0;
  T* yb = y + (size_t)b * s_len * xrow + (size_t)h * d_len + d0;
  const T* ab = a + (size_t)b * s_len * n_heads + h;
  const T* bb = bm + (size_t)b * s_len * n_len;
  const T* cb = cm + (size_t)b * s_len * n_len;

  for (int i = tid; i < BD * ldh; i += NTH) hs[i] = 0.f;

  for (int t0 = 0; t0 < s_len; t0 += L) {
    const int len = min(L, s_len - t0);
    __syncthreads();  // the previous chunk's tiles are consumed
    if (tid < 32) {
      // inclusive scan of the chunk's log-decays, 2 tokens a lane
      const int lane = tid;
      float v0 = lane < len ? to_f32(ab[(size_t)(t0 + lane) * n_heads]) : 0.f;
      float v1 = lane + 32 < len
                     ? to_f32(ab[(size_t)(t0 + lane + 32) * n_heads])
                     : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float a_tot = __shfl_sync(0xffffffffu, v1, 31);
      acum[lane] = v0;
      acum[lane + 32] = v1;
      wts[lane] = expf(a_tot - v0);
      wts[lane + 32] = expf(a_tot - v1);
      if (lane == 0) tot[0] = expf(a_tot);
    }
    for (int i = tid; i < L * BD; i += NTH) {
      const int u = i / BD, dd = i % BD;
      xs[u * LDX + dd] = u < len && d0 + dd < d_len
                             ? to_f32(xb[(size_t)(t0 + u) * xrow + dd])
                             : 0.f;
    }

    // thread (ty, tx) owns G rows ty + 16 i, columns tx + 16 j, and y rows
    // ty + 16 i, columns tx + 16 c
    float g[4][4], yc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      yc[i][0] = yc[i][1] = 0.f;
    }

    for (int n0 = 0; n0 < np; n0 += NT) {
      __syncthreads();  // the previous b, c tiles are consumed
      for (int i = tid; i < L * NT; i += NTH) {
        const int u = i / NT, nn = i % NT;
        const bool in = u < len && n0 + nn < n_len;
        const size_t off = (size_t)(t0 + u) * n_len + n0 + nn;
        bs[u * LDC + nn] = in ? to_f32(bb[off]) : 0.f;
        cs[u * LDC + nn] = in ? to_f32(cb[off]) : 0.f;
      }
      __syncthreads();

      // G += C . B^T and carry += C . h^T over this slice of N (old h)
#pragma unroll 4
      for (int k = 0; k < NT; k += 4) {
        float4 cv[4], bv[4], hv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] =
              *reinterpret_cast<const float4*>(&cs[(ty + 16 * i) * LDC + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] =
              *reinterpret_cast<const float4*>(&bs[(tx + 16 * j) * LDC + k]);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          hv[c] = *reinterpret_cast<const float4*>(
              &hs[(tx + 16 * c) * ldh + n0 + k]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = dot4(cv[i], bv[j], g[i][j]);
#pragma unroll
          for (int c = 0; c < 2; ++c) yc[i][c] = dot4(cv[i], hv[c], yc[i][c]);
        }
      }
      __syncthreads();  // every thread has read this slice of the old h

      // h[:, slice] <- exp(A_tot) h + (x * w)^T @ B; thread (ty, tx) owns
      // rows ty + 16 i, columns n0 + tx + 16 j
      const float e_tot = tot[0];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* hrow = hs + (ty + 16 * i) * ldh + n0;
        float acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = e_tot * hrow[tx + 16 * j];
#pragma unroll 4
        for (int u = 0; u < L; ++u) {
          const float xw = xs[u * LDX + ty + 16 * i] * wts[u];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = fmaf(xw, bs[u * LDC + tx + 16 * j], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) hrow[tx + 16 * j] = acc[j];
      }
    }

    // select the causal triangle, then decay (the select comes first:
    // above the diagonal the exponential overflows)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = tx + 16 * j;
        gs[t * LDG + u] = u <= t ? g[i][j] * expf(acum[t] - acum[u]) : 0.f;
      }
    }
    __syncthreads();

    // y = G @ x + exp(Acum_t) * carry
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      const float e_t = expf(acum[t]);
      float acc0 = yc[i][0] * e_t, acc1 = yc[i][1] * e_t;
#pragma unroll 4
      for (int u = 0; u < L; u += 4) {
        const float4 gv = *reinterpret_cast<const float4*>(&gs[t * LDG + u]);
        const float* xr = xs + u * LDX + tx;
        acc0 = fmaf(gv.x, xr[0], acc0);
        acc0 = fmaf(gv.y, xr[LDX], acc0);
        acc0 = fmaf(gv.z, xr[2 * LDX], acc0);
        acc0 = fmaf(gv.w, xr[3 * LDX], acc0);
        acc1 = fmaf(gv.x, xr[16], acc1);
        acc1 = fmaf(gv.y, xr[LDX + 16], acc1);
        acc1 = fmaf(gv.z, xr[2 * LDX + 16], acc1);
        acc1 = fmaf(gv.w, xr[3 * LDX + 16], acc1);
      }
      if (t < len) {
        T* yr = yb + (size_t)(t0 + t) * xrow;
        if (d0 + tx < d_len) store(&yr[tx], acc0);
        if (d0 + tx + 16 < d_len) store(&yr[tx + 16], acc1);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, int bsz, int s_len, int n_heads, int d_len, int n_len,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(n_len);
  if (smem > kSmemLimit) return kStateTooWide;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d_len + BD - 1) / BD, n_heads, bsz);
  ssd_fwd<T><<<grid, NTH, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      s_len, n_heads, d_len, n_len);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Without a launch, an N whose state rows do not fit
// in shared memory gives -1 and an unsupported dtype cudaErrorInvalidValue.
extern "C" int repro_ssd_scan(const void* x, const void* a, const void* b,
                              const void* c, void* y, int dtype, int bsz,
                              int s_len, int n_heads, int d_len, int n_len,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, a, b, c, y, bsz, s_len, n_heads, d_len, n_len,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, c, y, bsz, s_len, n_heads, d_len,
                                 n_len, st);
  return (int)cudaErrorInvalidValue;
}
