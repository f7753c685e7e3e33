// Passes 1 to 3 of the Mamba-2 SSD chunked scan, shared by the forward
// (csrc/ssd_scan.cu) and its backward (csrc/ssd_scan_bwd.cu): C . B^T and
// Acum per chunk, the chunks' local end states (the forward's s_c, or
// under DUAL the backward's r_c), and the states passed along the chunks,
// forward (h_c) or, for the backward's dual, in reverse.
// csrc/ssd_scan.cu's head comment gives the design.  Included by one .cu
// at a time; everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int L = 64;          // tokens per chunk
constexpr int TILE = 64;       // edge of a shared tile (D, N and K tiles)
constexpr int LDS = TILE + 4;  // row stride of a shared tile, in floats
constexpr int NTH = 256;       // threads of a pass-1, pass-3 or narrow block
constexpr int NARROW_D = 16;   // D below this takes the narrow passes
constexpr int NTH_NARROW2 = 128;  // threads (state columns) of narrow pass 2
constexpr int PASS3_GROUP = 8;    // chunks whose loads pass 3 issues at once
constexpr int kGridTooLarge = -2; // returned when a grid dimension overflows

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

// A [ROWS, COLS] tile of src (row stride ld elements) into shared dst (row
// stride ldd floats): rows >= rows or columns >= cols read as zeros.  With
// ASYNC, 16-byte cp.async copies (src float, rows and cols on 16-byte
// boundaries; the caller commits and waits); else loads converted to float.
template <typename T, bool ASYNC, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ldd,
                                          const T* __restrict__ src,
                                          size_t ld, int rows, int cols) {
  if constexpr (ASYNC) {
    static_assert(sizeof(T) == 4, "cp.async tiles are float32");
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * (COLS / 4); i += blockDim.x) {
      const int r = i / (COLS / 4), q = (i % (COLS / 4)) * 4;
      const bool in = r < rows && q < cols;
      hopper::cp_async16(dst + r * ldd + q, in ? src + r * ld + q : src,
                         in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += blockDim.x) {
      const int r = i / COLS, q = i % COLS;
      dst[r * ldd + q] = r < rows && q < cols ? to_f32(src[r * ld + q]) : 0.f;
    }
  }
}

template <bool ASYNC>
__device__ __forceinline__ void commit() {
  if constexpr (ASYNC) hopper::cp_async_commit();
}

template <bool ASYNC, int N>
__device__ __forceinline__ void wait_async() {
  if constexpr (ASYNC) hopper::cp_async_wait<N>();
}

// A wide block computes a [64, DT] tile (DT = 64 or 128) with NT = 2 DT
// threads: DT / 16 warps, each owning 32 rows and 32 columns of it (warp w
// at rows 32 (w % 2), columns 32 (w / 2)) as 2 x 4 tiles of 16 x 8.
template <int DT>
struct Wide {
  static constexpr int NT = 2 * DT;        // threads a block
  static constexpr int LDX = DT + 8;       // row stride of a [*, DT] tile
  static constexpr int OUT_STAGE = L * LDS + TILE * LDX;  // pass 4's stage
};
constexpr int LDK = TILE + 8;  // row stride of a K-major [k][row] A tile

using hopper::mma_tf32;
using hopper::split_tf32;

// acc += A B over one K tile of 64 for this warp's 32 x 32 block, in
// 3xTF32: each operand split into a TF32 high and low part, and
// a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32 (the low parts'
// product is below float32's rounding), which keeps float32's accuracy.
// A's element (row r, k) is at A[r * a_rs + k * a_ks]; B's (k, column c)
// at B[k * b_ks + c * b_cs].  Bank-conflict free where a row-major
// operand (stride 1 along k for A, along c for B) has its other stride at
// 4 (A) or 8 (B) floats past a multiple of 32, and the other way round
// for a transposed one: LDS and LDK below.  Fragment layouts of m16n8k8 (lane = 4 g + q): A
// rows g, g + 8 and columns q, q + 4; B rows q, q + 4 and column g; C row
// g (c0, c1) and g + 8 (c2, c3), columns 2 q and 2 q + 1.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[2][4][4],
                                           const float* __restrict__ A,
                                           int a_rs, int a_ks,
                                           const float* __restrict__ B,
                                           int b_ks, int b_cs, int r0,
                                           int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 8) {
    uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* a = A + (r0 + 16 * mi + g) * a_rs + (k + q) * a_ks;
      split_tf32(a[0], ahi[mi][0], alo[mi][0]);
      split_tf32(a[8 * a_rs], ahi[mi][1], alo[mi][1]);
      split_tf32(a[4 * a_ks], ahi[mi][2], alo[mi][2]);
      split_tf32(a[8 * a_rs + 4 * a_ks], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* b = B + (k + q) * b_ks + (c0 + 8 * ni + g) * b_cs;
      split_tf32(b[0], bhi[ni][0], blo[ni][0]);
      split_tf32(b[4 * b_ks], bhi[ni][1], blo[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_tf32(acc[mi][ni], alo[mi], bhi[ni]);
        mma_tf32(acc[mi][ni], ahi[mi], blo[ni]);
        mma_tf32(acc[mi][ni], ahi[mi], bhi[ni]);
      }
  }
}

// -- pass 1: C . B^T per (batch, chunk), Acum per (batch, chunk, head) -----

constexpr int RH = L / 2;        // rows of C . B^T a pass-1 block
constexpr int NS1 = 3;           // pass 1's ring stages
constexpr int HG = 32;           // heads whose log-decays a block stages

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NTH)
ssd_chunk_cb(const T* __restrict__ a, const T* __restrict__ bm,
             const T* __restrict__ cm, float* __restrict__ cb,
             float* __restrict__ acum, int s_len, int n_heads, int n_len,
             int nc) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sa[L][HG + 1];           // log-decays, [t][head]
  constexpr int STAGE = (RH + L) * LDS;     // c rows, then b rows
  const int ci = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * RH;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* bb = bm + ((size_t)b * s_len + t0) * n_len;
  const T* cc = cm + ((size_t)b * s_len + t0 + r0) * n_len;
  const int c_rows = max(0, min(RH, len - r0));
  const int nk = (n_len + TILE - 1) / TILE;
  auto load = [&](int k) {
    float* st = smem + (k % NS1) * STAGE;
    const int n0 = k * TILE;
    load_tile<T, ASYNC, RH, TILE>(st, LDS, cc + n0, n_len, c_rows,
                                  n_len - n0);
    load_tile<T, ASYNC, L, TILE>(st + RH * LDS, LDS, bb + n0, n_len, len,
                                 n_len - n0);
  };
#pragma unroll
  for (int p = 0; p < NS1 - 1; ++p) {
    if (p < nk) load(p);
    commit<ASYNC>();
  }

  if (blockIdx.z == 0) {  // Acum: stage HG heads' log-decays, a warp a head
    const int lane = tid % 32;
    for (int h0 = 0; h0 < n_heads; h0 += HG) {
      const int nh = min(HG, n_heads - h0);
      const T* ah = a + ((size_t)b * s_len + t0) * n_heads + h0;
      for (int i = tid; i < L * HG; i += NTH) {
        const int t = i / HG, hh = i % HG;
        sa[t][hh] = t < len && hh < nh ? to_f32(ah[(size_t)t * n_heads + hh])
                                       : 0.f;
      }
      __syncthreads();
      for (int hh = tid / 32; hh < nh; hh += NTH / 32) {
        float v0 = sa[lane][hh], v1 = sa[lane + 32][hh];
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
        float* out = acum + (((size_t)b * nc + ci) * n_heads + h0 + hh) * L;
        out[lane] = v0;
        out[lane + 32] = v1;
      }
      __syncthreads();
    }
  }

  // thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j; the first
  // half's rows (t < 32) need only the columns u <= t < 32
  const int jn = blockIdx.z == 0 ? 2 : 4;
  float acc[2][4] = {};
  for (int k = 0; k < nk; ++k) {
    if (k + NS1 - 1 < nk) load(k + NS1 - 1);
    commit<ASYNC>();
    wait_async<ASYNC, NS1 - 1>();
    __syncthreads();
    const float* ct = smem + (k % NS1) * STAGE;
    const float* bt = ct + RH * LDS;
#pragma unroll 4
    for (int q = 0; q < TILE; q += 4) {
      float4 cv[2], bv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cv[i] = *reinterpret_cast<const float4*>(&ct[(ty + 16 * i) * LDS + q]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < jn)
          bv[j] =
              *reinterpret_cast<const float4*>(&bt[(tx + 16 * j) * LDS + q]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < jn) acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }
  float* out = cb + ((size_t)b * nc + ci) * L * L;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(r0 + ty + 16 * i) * L + tx + 16 * j] = acc[i][j];
}

// -- pass 2: each chunk's local end state, stored [N, D] -------------------

// per (batch, chunk, head, D-tile, N-tile): one K tile (the chunk's tokens).
// The forward's s_c = (x * exp(A_tot - Acum))^T B, every chunk but the
// last (no chunk reads its end state).  DUAL, the backward's dual: x is
// dy, bm is c, and r_c = (dy * exp(Acum))^T C, every chunk but the first
// (no chunk reads its carry).
template <bool DUAL>
__device__ __forceinline__ bool state_skipped(int ci, int nc) {
  return DUAL ? ci == 0 : ci == nc - 1;
}
template <bool DUAL>
__device__ __forceinline__ float state_weight(const float* ac, int u) {
  return DUAL ? expf(ac[u]) : expf(ac[L - 1] - ac[u]);
}

template <bool DUAL, typename T, bool ASYNC, int DT>
__global__ void __launch_bounds__(Wide<DT>::NT, 512 / Wide<DT>::NT)
ssd_chunk_state(const T* __restrict__ x, const T* __restrict__ bm,
                const float* __restrict__ acum, float* __restrict__ states,
                int s_len, int n_heads, int d_len, int n_len, int nc) {
  using W = Wide<DT>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [L][LDX]  x, weighted by row
  float* bs = xs + L * W::LDX;       // [L][LDK]  b tile
  float* ws = bs + L * LDK;          // [L]       the rows' weights
  const int d_tiles = (d_len + DT - 1) / DT;
  const int d0 = (blockIdx.x % d_tiles) * DT;
  const int n0 = (blockIdx.x / d_tiles) * TILE, h = blockIdx.y;
  const int b = blockIdx.z / nc, ci = blockIdx.z % nc;
  if (state_skipped<DUAL>(ci, nc)) return;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t xrow = (size_t)n_heads * d_len;
  const float* ac = acum + (((size_t)b * nc + ci) * n_heads + h) * L;

  load_tile<T, ASYNC, L, DT>(
      xs, W::LDX, x + ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len + d0,
      xrow, len, d_len - d0);
  load_tile<T, ASYNC, L, TILE>(bs, LDK,
                               bm + ((size_t)b * s_len + t0) * n_len + n0,
                               n_len, len, n_len - n0);
  commit<ASYNC>();
  if (tid < L) ws[tid] = state_weight<DUAL>(ac, tid);
  wait_async<ASYNC, 0>();
  __syncthreads();
  for (int i = tid; i < L * DT; i += W::NT)  // weight x's rows
    xs[(i / DT) * W::LDX + i % DT] *= ws[i / DT];
  __syncthreads();

  // s[n][d] = sum_u b[u][n] xw[u][d]: A = b^T, read K-major from [u][n]
  const int r0 = 32 * (warp % 2), c0 = 32 * (warp / 2);
  float acc[2][4][4] = {};
  mma_3xtf32(acc, bs, 1, LDK, xs, W::LDX, 1, r0, c0);

  const int lane = tid % 32, g = lane / 4, q = lane % 4;
  float* out = states + (((size_t)b * nc + ci) * n_heads + h) *
                            ((size_t)n_len * d_len) + d0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = n0 + r0 + 16 * mi + g + 8 * hf;
      if (n >= n_len) continue;
      float* row = out + (size_t)n * d_len;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int d = c0 + 8 * ni + 2 * q;
        const float v0 = acc[mi][ni][2 * hf], v1 = acc[mi][ni][2 * hf + 1];
        if (ASYNC) {  // D is a multiple of 4: both columns are in or out
          if (d0 + d < d_len)
            *reinterpret_cast<float2*>(&row[d]) = make_float2(v0, v1);
        } else {
          if (d0 + d < d_len) row[d] = v0;
          if (d0 + d + 1 < d_len) row[d + 1] = v1;
        }
      }
    }
}

// narrow pass 2 (D < NARROW_D): one column d of the state a block, one
// state row n a thread; DUAL as in the wide pass
template <bool DUAL, typename T>
__global__ void __launch_bounds__(NTH_NARROW2)
ssd_chunk_state_narrow(const T* __restrict__ x, const T* __restrict__ bm,
                       const float* __restrict__ acum,
                       float* __restrict__ states, int s_len, int n_heads,
                       int d_len, int n_len, int nc) {
  __shared__ float xw[L];
  const int n_tiles = (n_len + NTH_NARROW2 - 1) / NTH_NARROW2;
  const int d = blockIdx.x / n_tiles;
  const int n = (blockIdx.x % n_tiles) * NTH_NARROW2 + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z / nc, ci = blockIdx.z % nc;
  if (state_skipped<DUAL>(ci, nc)) return;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const float* ac = acum + (((size_t)b * nc + ci) * n_heads + h) * L;
  if (threadIdx.x < L) {
    const int u = threadIdx.x;
    xw[u] = u < len ? to_f32(x[(((size_t)b * s_len + t0 + u) * n_heads + h) *
                                   d_len + d]) *
                          state_weight<DUAL>(ac, u)
                    : 0.f;
  }
  __syncthreads();
  if (n >= n_len) return;
  const T* bb = bm + ((size_t)b * s_len + t0) * n_len + n;
  float acc = 0.f;
#pragma unroll 16
  for (int u = 0; u < len; ++u)
    acc = fmaf(to_f32(bb[(size_t)u * n_len]), xw[u], acc);
  states[(((size_t)b * nc + ci) * n_heads + h) * ((size_t)n_len * d_len) +
         (size_t)n * d_len + d] = acc;
}

// -- pass 3: pass the states along the chunks, in place --------------------

// Forward (REVERSE false): slot c of the states holds s_c on entry (c <
// nc - 1; the last slot's entry is never read) and h_c (the state at chunk
// c's start) on exit: h_0 = 0, h_{c+1} = exp(A_tot,c) h_c + s_c.  Reverse
// (the backward's dual): slot c holds r_c on entry (c > 0) and R_c on
// exit, R_{nc-1} = 0, R_{c-1} = exp(A_tot,c) R_c + r_c.  The i-th chunk
// walked is c = i (c = nc - 1 - i in reverse); a thread owns V floats of
// the state and issues the loads of PASS3_GROUP chunks at once.
template <bool REVERSE, int V>
__global__ void __launch_bounds__(NTH)
ssd_state_pass(const float* __restrict__ acum, float* __restrict__ states,
               int n_heads, size_t elems, int nc) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const size_t e = ((size_t)blockIdx.x * NTH + threadIdx.x) * V;
  if (e >= elems) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t step = (size_t)n_heads * elems;  // one chunk further
  float* st = states + ((size_t)b * nc * n_heads + h) * elems + e;
  const float* tot = acum + ((size_t)b * nc * n_heads + h) * L + (L - 1);
  float run[V] = {};
  for (int i0 = 0; i0 < nc; i0 += PASS3_GROUP) {
    Vec s[PASS3_GROUP];
    float f[PASS3_GROUP];
#pragma unroll
    for (int g = 0; g < PASS3_GROUP; ++g) {
      const int i = i0 + g, c = REVERSE ? nc - 1 - i : i;
      if (i < nc - 1) {  // the chunk's entry is read (its carry goes on)
        s[g] = *reinterpret_cast<const Vec*>(st + c * step);
        f[g] = expf(tot[(size_t)c * n_heads * L]);
      }
    }
#pragma unroll
    for (int g = 0; g < PASS3_GROUP; ++g) {
      const int i = i0 + g, c = REVERSE ? nc - 1 - i : i;
      if (i >= nc) break;
      Vec out;
      float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int v = 0; v < V; ++v) ov[v] = run[v];
      *reinterpret_cast<Vec*>(st + c * step) = out;
      if (i == nc - 1) break;
      const float* sv = reinterpret_cast<const float*>(&s[g]);
#pragma unroll
      for (int v = 0; v < V; ++v) run[v] = fmaf(f[g], run[v], sv[v]);
    }
  }
}

// -- launch -------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr size_t kSmemCb = sizeof(float) * NS1 * (RH + L) * LDS;

template <int DT>
constexpr size_t smem_state() {
  return sizeof(float) * ((size_t)L * Wide<DT>::LDX + L * LDK + L);
}

int sm_count() {
  int sms = 132;
  int dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// pass 3 over states of `elems` floats a (batch, chunk, head); float4s
// where elems is a multiple of 4 (every slot then starts on 16 bytes)
template <bool REVERSE>
cudaError_t pass_states(const float* acum, float* states, int bsz,
                        int n_heads, size_t elems, int nc,
                        cudaStream_t stream) {
  if (elems % 4 == 0)
    ssd_state_pass<REVERSE, 4>
        <<<dim3((unsigned)((elems / 4 + NTH - 1) / NTH), n_heads, bsz), NTH,
           0, stream>>>(acum, states, n_heads, elems, nc);
  else
    ssd_state_pass<REVERSE, 1>
        <<<dim3((unsigned)((elems + NTH - 1) / NTH), n_heads, bsz), NTH, 0,
           stream>>>(acum, states, n_heads, elems, nc);
  return cudaGetLastError();
}

// The D-tile of the wide passes 2 and 4: 128 columns where the forward's
// pass 4 then has at least two blocks for each SM (two fit at once), else
// 64; 0 for D below NARROW_D (the narrow passes).
int state_tile(int d_len, int n_heads, int bsz, int nc) {
  const long long out_blocks128 = (long long)(d_len + 127) / 128 * n_heads *
                                  bsz * nc;
  if (d_len > 64 && out_blocks128 >= 2 * sm_count()) return 128;
  return d_len >= NARROW_D ? 64 : 0;
}

// How float32 tiles load: 2 = x, b and c by cp.async (the wide passes 2
// and 4; their rows on 16-byte boundaries), 1 = b and c only (pass 1 and
// the narrow pass 4), 0 = plain loads.
int load_route(const float* x, const float* b, const float* c, int d_len,
               int n_len) {
  const bool bc = n_len % 4 == 0 && aligned16(b) && aligned16(c);
  if (bc && d_len % 4 == 0 && aligned16(x)) return 2;
  return bc ? 1 : 0;
}

// Pass 2 into states [B, nc, H, N, D] with state_tile's D-tile dt: the
// forward's local states from (x, b), or under DUAL the dual's from
// (dy, c).  ASYNC as load_route's 2 for those two inputs.
template <bool DUAL, typename T, bool ASYNC>
cudaError_t local_states(const T* x, const T* b, const float* acum,
                         float* states, int bsz, int s_len, int n_heads,
                         int d_len, int n_len, int dt, cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  cudaError_t err;
  if (dt == 128 || dt == 64) {
    const int n_tiles = (n_len + TILE - 1) / TILE;
    const dim3 grid((d_len + dt - 1) / dt * n_tiles, n_heads, bsz * nc);
    if (dt == 128) {
      if ((err = allow_smem(ssd_chunk_state<DUAL, T, ASYNC, 128>,
                            smem_state<128>())))
        return err;
      ssd_chunk_state<DUAL, T, ASYNC, 128>
          <<<grid, Wide<128>::NT, smem_state<128>(), stream>>>(
              x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
    } else {
      if ((err = allow_smem(ssd_chunk_state<DUAL, T, ASYNC, 64>,
                            smem_state<64>())))
        return err;
      ssd_chunk_state<DUAL, T, ASYNC, 64>
          <<<grid, Wide<64>::NT, smem_state<64>(), stream>>>(
              x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
    }
  } else {
    const int n_tiles = (n_len + NTH_NARROW2 - 1) / NTH_NARROW2;
    ssd_chunk_state_narrow<DUAL, T>
        <<<dim3(n_tiles * d_len, n_heads, bsz * nc), NTH_NARROW2, 0,
           stream>>>(x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
  }
  return cudaGetLastError();
}

// Passes 1 to 3 into the scratch (16-byte aligned): C . B^T [B, nc, L, L],
// Acum [B, nc, H, L], then the states [B, nc, H, N, D], h_c in slot c.
// dt: state_tile's D-tile.  ASYNC_BC and ASYNC as load_route's 1 and 2.
template <typename T, bool ASYNC_BC, bool ASYNC>
cudaError_t chunk_states(const T* x, const T* a, const T* b, const T* c,
                         float* scratch, int bsz, int s_len, int n_heads,
                         int d_len, int n_len, int dt, cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  float* cb = scratch;                                    // [B, nc, L, L]
  float* acum = cb + (size_t)bsz * nc * L * L;            // [B, nc, H, L]
  float* states = acum + (size_t)bsz * nc * n_heads * L;  // [B, nc, H, N, D]
  cudaError_t err;
  if ((err = allow_smem(ssd_chunk_cb<T, ASYNC_BC>, kSmemCb))) return err;
  ssd_chunk_cb<T, ASYNC_BC><<<dim3(nc, bsz, 2), NTH, kSmemCb, stream>>>(
      a, b, c, cb, acum, s_len, n_heads, n_len, nc);
  if ((err = cudaGetLastError()) ||
      (err = local_states<false, T, ASYNC>(x, b, acum, states, bsz, s_len,
                                           n_heads, d_len, n_len, dt,
                                           stream)))
    return err;
  return pass_states<false>(acum, states, bsz, n_heads, (size_t)n_len * d_len,
                            nc, stream);
}

}  // namespace
