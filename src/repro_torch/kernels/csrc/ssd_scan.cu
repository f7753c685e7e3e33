// Mamba-2 SSD chunked scan (forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (launched by ssd_scan_pallas).  Same function:
//   x [B, S, H, D], a [B, S, H] (log-decay, <= 0), b, c [B, S, N] shared
//   across the H heads; contiguous, all float32 or all bfloat16;
//   h_t = exp(a_t) h_{t-1} + x_t (x) b_t,  y_t = h_t c_t, with the state
//   h [D, N] of each (batch, head) in float32 and zero at t = 0;
//   y [B, S, H, D] in x's dtype.
// Per chunk c of L tokens, with Acum the cumulative sum of a from the
// chunk's start (relative to the chunk, as the TPU kernel keeps it) and h_c
// the state at the chunk's start:
//   y  = tril(exp(Acum_t - Acum_u) * (C_t . B_u)) @ x + exp(Acum_t) (C_t . h_c)
//   h_{c+1} = exp(A_tot) h_c + s_c,  s_c = (x * exp(A_tot - Acum))^T @ B
//
// Bound.  At zamba2's heads (H 32, D 128, N 64) and S = 1024 the function
// is ~1.35 GFLOP against ~34 MB of x, a, b, c and y: ~40 flops a byte.
// All but C . B^T and the decays (under 0.5% of the flops) run below on
// the tensor cores in 3xTF32, at a third of TF32's dense 495 TFLOP/s, so
// the ridge is ~49 flops a byte and zamba2 is bound by bytes (~10 us);
// mLSTM's values (D = N = 384, ~2.6 GFLOP against ~25 MB) are bound by
// the tensor cores' operations (~15 us).  The D = 1 normalizer runs on
// FMAs and is bound by reading b and c (~4 us).  The design below moves
// more: the chunk states go through device memory (16.8 MB at zamba2,
// S = 1024), written by pass 2, read and written by pass 3, read by pass
// 4, and that traffic, not the arithmetic, sets the kernel's time.
//
// Design.  The TPU kernel carried the [D, N] state in VMEM along a
// sequential grid axis, so a chunk waited for the one before.  Here the
// chunks run in parallel, split as the Mamba-2 paper splits its chunked
// algorithm (Dao & Gu, arXiv:2405.21060, section 6), in four passes that
// one C call launches in order on the caller's stream:
//   1. per (batch, chunk, half of the rows): C . B^T [L, L] once for all H
//      heads (b and c are shared; the quarter above the diagonal is zeros)
//      in float32 FMAs, and per head the chunk's Acum (the block stages the
//      chunk's log-decays in shared memory, a warp scans a head);
//   2. per (batch, chunk, head, D-tile, N-tile): the chunk's local end
//      state s_c, stored [N, D] (D contiguous) in a float32 scratch (the
//      last chunk's is never read, and not computed);
//   3. per (batch, head, element of the state): the states passed along
//      the chunks in place, so slot c ends up holding h_c; every factor
//      exp(A_tot) is <= 1, and no exp of a difference across chunks is
//      ever taken;
//   4. per (batch, chunk, head, D-tile): y from C . B^T, x and h_c.
// Only pass 3 walks the chunks, and it is elementwise over D * N with the
// loads of 8 chunks in flight, so the grids fill the card (pass 4 at
// S = 1024: 512 blocks at zamba2, 384 at mLSTM's values, 256 at its
// normalizer).  The products of passes 2 and 4 (the local states,
// C . h_c^T and G @ x) run on the tensor cores as mma.sync m16n8k8 in
// 3xTF32: each
// float32 operand split into a TF32 high and low part, and the three
// products that matter summed in float32, which keeps float32's accuracy
// (single TF32 keeps ~3 digits, and the reference's 3e-3 is for float32);
// bfloat16 inputs are converted to float32 on load.  A wide block
// computes a [64, DT] tile with DT / 16 warps of 32 x 32; DT is 128 for
// D > 64 where pass 4 then still has two blocks for each SM, else 64.
// Shared tiles are padded so that every fragment read is free of bank
// conflicts.  Pass 4's K runs over tiles of 64 through a ring of two
// shared-memory stages that ends with (C . B^T, x) as its last item, whose
// tile becomes G in place, so two blocks fit an SM at any N.  For
// float32 inputs whose rows sit on 16-byte boundaries (D and N multiples
// of 4, aligned pointers) the tiles of x, b, c and the scratch arrive by
// cp.async, the next tile loading while the block computes on the last;
// other inputs take plain loads.  D < 16 (the mLSTM normalizer's D = 1)
// takes narrow passes 2 and 4 (float32 FMAs) with one column of D a
// block, so D = 1 pays for one column, not 64; narrow
// pass 4 loads its 16 rows of c for all of N (in slices of 512) in one
// round.  Above the diagonal exp(Acum_t - Acum_u) overflows (mLSTM's
// log-decay reaches -13.8 a token), so the triangle is selected before the
// exponential, never multiplied by a 0/1 mask.  A ragged last chunk reads
// x = a = b = c = 0 past S and stores only rows before S.  The scratch
// (C . B^T, Acum, the states) is the wrapper's torch.empty: every pass
// writes all of what a later one reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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
// at B[k * ldb + c].  Fragment layouts of m16n8k8 (lane = 4 g + q): A
// rows g, g + 8 and columns q, q + 4; B rows q, q + 4 and column g; C row
// g (c0, c1) and g + 8 (c2, c3), columns 2 q and 2 q + 1.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[2][4][4],
                                           const float* __restrict__ A,
                                           int a_rs, int a_ks,
                                           const float* __restrict__ B,
                                           int ldb, int r0, int c0) {
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
      const float* b = B + (k + q) * ldb + c0 + 8 * ni + g;
      split_tf32(b[0], bhi[ni][0], blo[ni][0]);
      split_tf32(b[4 * ldb], bhi[ni][1], blo[ni][1]);
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

// -- pass 2: each chunk's local end state s_c, stored [N, D] ---------------

// per (batch, chunk, head, D-tile, N-tile): one K tile (the chunk's tokens)

template <typename T, bool ASYNC, int DT>
__global__ void __launch_bounds__(Wide<DT>::NT, 512 / Wide<DT>::NT)
ssd_chunk_state(const T* __restrict__ x, const T* __restrict__ bm,
                const float* __restrict__ acum, float* __restrict__ states,
                int s_len, int n_heads, int d_len, int n_len, int nc) {
  using W = Wide<DT>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [L][LDX]  x * exp(A_tot - Acum)
  float* bs = xs + L * W::LDX;       // [L][LDK]  b tile
  float* ws = bs + L * LDK;          // [L]       exp(A_tot - Acum)
  const int d_tiles = (d_len + DT - 1) / DT;
  const int d0 = (blockIdx.x % d_tiles) * DT;
  const int n0 = (blockIdx.x / d_tiles) * TILE, h = blockIdx.y;
  const int b = blockIdx.z / nc, ci = blockIdx.z % nc;
  if (ci == nc - 1) return;  // no chunk reads the last one's end state
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
  if (tid < L) ws[tid] = expf(ac[L - 1] - ac[tid]);
  wait_async<ASYNC, 0>();
  __syncthreads();
  for (int i = tid; i < L * DT; i += W::NT)  // weight x's rows
    xs[(i / DT) * W::LDX + i % DT] *= ws[i / DT];
  __syncthreads();

  // s[n][d] = sum_u b[u][n] xw[u][d]: A = b^T, read K-major from [u][n]
  const int r0 = 32 * (warp % 2), c0 = 32 * (warp / 2);
  float acc[2][4][4] = {};
  mma_3xtf32(acc, bs, 1, LDK, xs, W::LDX, r0, c0);

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
// state row n a thread
template <typename T>
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
  if (ci == nc - 1) return;  // no chunk reads the last one's end state
  const int t0 = ci * L, len = min(L, s_len - t0);
  const float* ac = acum + (((size_t)b * nc + ci) * n_heads + h) * L;
  if (threadIdx.x < L) {
    const int u = threadIdx.x;
    xw[u] = u < len ? to_f32(x[(((size_t)b * s_len + t0 + u) * n_heads + h) *
                                   d_len + d]) *
                          expf(ac[L - 1] - ac[u])
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

// slot c of the states holds s_c on entry (c < nc - 1; the last slot's
// entry is never read) and h_c (the state at chunk c's start) on exit:
// h_0 = 0, h_{c+1} = exp(A_tot,c) h_c + s_c
template <int V>
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
  for (int c0 = 0; c0 < nc; c0 += PASS3_GROUP) {
    Vec s[PASS3_GROUP];
    float f[PASS3_GROUP];
#pragma unroll
    for (int g = 0; g < PASS3_GROUP; ++g) {
      if (c0 + g < nc - 1) {
        s[g] = *reinterpret_cast<const Vec*>(st + (c0 + g) * step);
        f[g] = expf(tot[(size_t)(c0 + g) * n_heads * L]);
      }
    }
#pragma unroll
    for (int g = 0; g < PASS3_GROUP; ++g) {
      if (c0 + g >= nc) break;
      Vec out;
      float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int v = 0; v < V; ++v) ov[v] = run[v];
      *reinterpret_cast<Vec*>(st + (c0 + g) * step) = out;
      if (c0 + g == nc - 1) break;
      const float* sv = reinterpret_cast<const float*>(&s[g]);
#pragma unroll
      for (int v = 0; v < V; ++v) run[v] = fmaf(f[g], run[v], sv[v]);
    }
  }
}

// -- pass 4: every chunk's output ------------------------------------------

// Two ring stages, each a [L][LDS] tile and a [TILE][LDX] tile
// (Wide::OUT_STAGE floats).  Items 0 .. nk - 1 are (c, h_c) tiles over N
// for the carry C . h_c^T; item nk is (C . B^T, x), which becomes G in
// place and meets x last.
template <typename T, bool ASYNC, int DT>
__global__ void __launch_bounds__(Wide<DT>::NT, 512 / Wide<DT>::NT)
ssd_chunk_out(const T* __restrict__ x, const T* __restrict__ cm,
              const float* __restrict__ cb, const float* __restrict__ acum,
              const float* __restrict__ states, T* __restrict__ y, int s_len,
              int n_heads, int d_len, int n_len, int nc) {
  using W = Wide<DT>;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                       // [L]  Acum
  float* ring = smem + L;                 // 2 stages
  constexpr int STAGE = W::OUT_STAGE;
  const int d0 = blockIdx.x * DT, h = blockIdx.y;
  const int b = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = tid % 32, g = lane / 4, q = lane % 4;
  const int r0 = 32 * (warp % 2), c0 = 32 * (warp / 2);  // this warp's block
  const size_t xrow = (size_t)n_heads * d_len;
  const size_t off_x = ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len + d0;
  const T* cc = cm + ((size_t)b * s_len + t0) * n_len;
  const float* hc = states + (((size_t)b * nc + ci) * n_heads + h) *
                                 ((size_t)n_len * d_len) + d0;
  const int nk = (n_len + TILE - 1) / TILE;
  auto load = [&](int k) {
    float* lo = ring + (k & 1) * STAGE;   // [L][LDS]
    float* hi = lo + L * LDS;             // [TILE][LDX]
    if (k < nk) {
      const int n0 = k * TILE;
      load_tile<T, ASYNC, L, TILE>(lo, LDS, cc + n0, n_len, len, n_len - n0);
      load_tile<float, ASYNC, TILE, DT>(hi, W::LDX, hc + (size_t)n0 * d_len,
                                        d_len, n_len - n0, d_len - d0);
    } else {
      load_tile<float, ASYNC, L, TILE>(lo, LDS,
                                       cb + ((size_t)b * nc + ci) * L * L, L,
                                       L, L);
      load_tile<T, ASYNC, L, DT>(hi, W::LDX, x + off_x, xrow, len,
                                 d_len - d0);
    }
    commit<ASYNC>();
  };

  load(0);
  if (tid < L) as[tid] = acum[(((size_t)b * nc + ci) * n_heads + h) * L + tid];
  float acc[2][4][4] = {};
  for (int k = 0; k <= nk; ++k) {
    if (k < nk) {
      load(k + 1);
      wait_async<ASYNC, 1>();
    } else {
      wait_async<ASYNC, 0>();
    }
    __syncthreads();
    float* lo = ring + (k & 1) * STAGE;
    const float* hi = lo + L * LDS;
    if (k < nk) {  // carry += C . h_c^T over this N tile
      mma_3xtf32(acc, lo, LDS, 1, hi, W::LDX, r0, c0);
    } else {
      // the carry's factor exp(Acum_t); then G: select the causal
      // triangle, then decay (the select comes first: above the diagonal
      // the exponential overflows), and y = G @ x + carry
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float e_t = expf(as[r0 + 16 * mi + g + 8 * hf]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            acc[mi][ni][2 * hf] *= e_t;
            acc[mi][ni][2 * hf + 1] *= e_t;
          }
        }
      for (int i = tid; i < L * L; i += W::NT) {
        const int t = i / L, u = i % L;
        float* g = &lo[t * LDS + u];
        *g = u <= t ? *g * expf(as[t] - as[u]) : 0.f;
      }
      __syncthreads();
      mma_3xtf32(acc, lo, LDS, 1, hi, W::LDX, r0, c0);
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }

  T* yb = y + off_x;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + 16 * mi + g + 8 * hf;
      if (t >= len) continue;
      T* yr = yb + (size_t)t * xrow;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int d = c0 + 8 * ni + 2 * q;
        if (d0 + d < d_len) store(&yr[d], acc[mi][ni][2 * hf]);
        if (d0 + d + 1 < d_len) store(&yr[d + 1], acc[mi][ni][2 * hf + 1]);
      }
    }
}

// narrow pass 4 (D < NARROW_D): one column d and 16 rows of the chunk a
// block, all of N (in slices of NW) loaded in one round; thread (r, kp) =
// (tid / 16, tid % 16) sums a sixteenth of each slice for row r, and the
// sixteenths meet by shuffles
constexpr int NARROW_ROWS = 16;
constexpr int NW = 512;           // state columns a narrow block holds
constexpr int LDW = NW + 4;

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NTH)
ssd_chunk_out_narrow(const T* __restrict__ x, const T* __restrict__ cm,
                     const float* __restrict__ cb,
                     const float* __restrict__ acum,
                     const float* __restrict__ states, T* __restrict__ y,
                     int s_len, int n_heads, int d_len, int n_len, int nc) {
  __shared__ __align__(16) float cs[NARROW_ROWS * LDW];  // c rows, N slice
  __shared__ __align__(16) float hv[NW];                 // h_c[n][d]
  __shared__ float xv[L];
  __shared__ float as[L];
  const int quarters = L / NARROW_ROWS;
  const int d = blockIdx.x / quarters;
  const int r0 = (blockIdx.x % quarters) * NARROW_ROWS;
  const int h = blockIdx.y, b = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, r = tid / 16, kp = tid % 16;
  const int t = r0 + r;
  const size_t xrow = (size_t)n_heads * d_len;
  const size_t off_x = ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len + d;
  const T* cc = cm + ((size_t)b * s_len + t0 + r0) * n_len;
  const float* hc = states + (((size_t)b * nc + ci) * n_heads + h) *
                                 ((size_t)n_len * d_len) + d;
  const int c_rows = max(0, min(NARROW_ROWS, len - r0));

  if (tid < L) {
    as[tid] = acum[(((size_t)b * nc + ci) * n_heads + h) * L + tid];
    xv[tid] = tid < len ? to_f32(x[off_x + (size_t)tid * xrow]) : 0.f;
  }
  // row t of C . B^T, columns 4 kp .. 4 kp + 3
  const float4 cb4 = *reinterpret_cast<const float4*>(
      cb + (((size_t)b * nc + ci) * L + t) * L + 4 * kp);

  float carry = 0.f;
  for (int n0 = 0; n0 < n_len; n0 += NW) {
    __syncthreads();  // the last slice is consumed
    load_tile<T, ASYNC, NARROW_ROWS, NW>(cs, LDW, cc + n0, n_len, c_rows,
                                         n_len - n0);
    commit<ASYNC>();
    for (int i = tid; i < NW; i += NTH)
      hv[i] = n0 + i < n_len ? hc[(size_t)(n0 + i) * d_len] : 0.f;
    wait_async<ASYNC, 0>();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NW / 64; ++m) {
      const int k = 4 * kp + 64 * m;
      carry = dot4(*reinterpret_cast<const float4*>(&cs[r * LDW + k]),
                   *reinterpret_cast<const float4*>(&hv[k]), carry);
    }
  }
  // G row t against x over this thread's columns u <= t
  float gx = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int u = 4 * kp + q;
    if (u <= t) gx = fmaf(comp(cb4, q) * expf(as[t] - as[u]), xv[u], gx);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    carry += __shfl_xor_sync(0xffffffffu, carry, off);
    gx += __shfl_xor_sync(0xffffffffu, gx, off);
  }
  if (kp == 0 && t < len)
    store(&y[off_x + (size_t)t * xrow], gx + expf(as[t]) * carry);
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

template <int DT>
constexpr size_t smem_out() {
  return sizeof(float) * (L + 2 * (size_t)Wide<DT>::OUT_STAGE);
}

int sm_count() {
  int sms = 132;
  int dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// pass 3 over states of `elems` floats a (batch, chunk, head)
cudaError_t pass_states(const float* acum, float* states, int bsz,
                        int n_heads, size_t elems, int nc,
                        cudaStream_t stream) {
  if (elems % 4 == 0)
    ssd_state_pass<4>
        <<<dim3((unsigned)((elems / 4 + NTH - 1) / NTH), n_heads, bsz), NTH,
           0, stream>>>(acum, states, n_heads, elems, nc);
  else
    ssd_state_pass<1>
        <<<dim3((unsigned)((elems + NTH - 1) / NTH), n_heads, bsz), NTH, 0,
           stream>>>(acum, states, n_heads, elems, nc);
  return cudaGetLastError();
}

// passes 2 to 4 with D-tiles of DT columns
template <typename T, bool ASYNC, int DT>
int launch_wide(const T* x, const T* b, const T* c, const float* cb,
                const float* acum, float* states, T* y, int bsz, int s_len,
                int n_heads, int d_len, int n_len, int nc,
                cudaStream_t stream) {
  cudaError_t err;
  if ((err = allow_smem(ssd_chunk_state<T, ASYNC, DT>, smem_state<DT>())) ||
      (err = allow_smem(ssd_chunk_out<T, ASYNC, DT>, smem_out<DT>())))
    return (int)err;
  const int d_tiles = (d_len + DT - 1) / DT;
  const int n_tiles = (n_len + TILE - 1) / TILE;
  ssd_chunk_state<T, ASYNC, DT>
      <<<dim3(d_tiles * n_tiles, n_heads, bsz * nc), Wide<DT>::NT,
         smem_state<DT>(), stream>>>(x, b, acum, states, s_len, n_heads,
                                     d_len, n_len, nc);
  if ((err = cudaGetLastError()) ||
      (err = pass_states(acum, states, bsz, n_heads, (size_t)n_len * d_len,
                         nc, stream)))
    return (int)err;
  ssd_chunk_out<T, ASYNC, DT>
      <<<dim3(d_tiles, n_heads, bsz * nc), Wide<DT>::NT, smem_out<DT>(),
         stream>>>(x, c, cb, acum, states, y, s_len, n_heads, d_len, n_len,
                   nc);
  return (int)cudaGetLastError();
}

// ASYNC_BC: b and c tiles by cp.async (passes 1 and the narrow 4); ASYNC:
// x, b, c and the scratch tiles by cp.async (the wide passes 2 and 4)
template <typename T, bool ASYNC_BC, bool ASYNC>
int launch(const T* x, const T* a, const T* b, const T* c, T* y,
           float* scratch, int bsz, int s_len, int n_heads, int d_len,
           int n_len, cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  float* cb = scratch;                                  // [B, nc, L, L]
  float* acum = cb + (size_t)bsz * nc * L * L;          // [B, nc, H, L]
  float* states = acum + (size_t)bsz * nc * n_heads * L;  // [B, nc, H, N, D]
  cudaError_t err;

  if ((err = allow_smem(ssd_chunk_cb<T, ASYNC_BC>, kSmemCb))) return (int)err;
  ssd_chunk_cb<T, ASYNC_BC><<<dim3(nc, bsz, 2), NTH, kSmemCb, stream>>>(
      a, b, c, cb, acum, s_len, n_heads, n_len, nc);
  if ((err = cudaGetLastError())) return (int)err;

  // D-tiles of 128 columns where pass 4 then has at least two blocks for
  // each SM (two fit at once), else of 64: more, smaller blocks
  const long long out_blocks128 = (long long)(d_len + 127) / 128 * n_heads *
                                  bsz * nc;
  if (d_len > 64 && out_blocks128 >= 2 * sm_count())
    return launch_wide<T, ASYNC, 128>(x, b, c, cb, acum, states, y, bsz,
                                      s_len, n_heads, d_len, n_len, nc,
                                      stream);
  if (d_len >= NARROW_D)
    return launch_wide<T, ASYNC, 64>(x, b, c, cb, acum, states, y, bsz, s_len,
                                     n_heads, d_len, n_len, nc, stream);

  const int n_tiles = (n_len + NTH_NARROW2 - 1) / NTH_NARROW2;
  ssd_chunk_state_narrow<T>
      <<<dim3(n_tiles * d_len, n_heads, bsz * nc), NTH_NARROW2, 0, stream>>>(
          x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
  if ((err = cudaGetLastError()) ||
      (err = pass_states(acum, states, bsz, n_heads, (size_t)n_len * d_len,
                         nc, stream)))
    return (int)err;
  ssd_chunk_out_narrow<T, ASYNC_BC>
      <<<dim3(d_len * (L / NARROW_ROWS), n_heads, bsz * nc), NTH, 0,
         stream>>>(x, c, cb, acum, states, y, s_len, n_heads, d_len, n_len,
                   nc);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch: n_scratch floats, at least
// B * nc * (L * L + H * L + H * N * D) with nc = ceil(S / L), 16-byte
// aligned; its contents on entry are never read.  Returns
// cudaGetLastError() after the last launch (0 on success).  Without a
// launch: -2 when H or B * nc exceed a grid dimension (65535), and
// cudaErrorInvalidValue for an unsupported dtype or too small a scratch.
extern "C" int repro_ssd_scan(const void* x, const void* a, const void* b,
                              const void* c, void* y, void* scratch,
                              long long n_scratch, int dtype, int bsz,
                              int s_len, int n_heads, int d_len, int n_len,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nc = (s_len + L - 1) / L;
  if (n_heads > 65535 || (long long)bsz * nc > 65535) return kGridTooLarge;
  const long long need =
      (long long)bsz * nc *
      ((long long)L * L + (long long)n_heads * L +
       (long long)n_heads * n_len * d_len);
  if (n_scratch < need || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) {
    using F = float;
    const F *xf = static_cast<const F*>(x), *af = static_cast<const F*>(a),
            *bf = static_cast<const F*>(b), *cf = static_cast<const F*>(c);
    F* yf = static_cast<F*>(y);
    const bool bc = n_len % 4 == 0 && aligned16(b) && aligned16(c);
    if (bc && d_len % 4 == 0 && aligned16(x))
      return launch<F, true, true>(xf, af, bf, cf, yf, sc, bsz, s_len,
                                   n_heads, d_len, n_len, st);
    if (bc)
      return launch<F, true, false>(xf, af, bf, cf, yf, sc, bsz, s_len,
                                    n_heads, d_len, n_len, st);
    return launch<F, false, false>(xf, af, bf, cf, yf, sc, bsz, s_len,
                                   n_heads, d_len, n_len, st);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    return launch<B, false, false>(
        static_cast<const B*>(x), static_cast<const B*>(a),
        static_cast<const B*>(b), static_cast<const B*>(c),
        static_cast<B*>(y), sc, bsz, s_len, n_heads, d_len, n_len, st);
  }
  return (int)cudaErrorInvalidValue;
}

// D below this takes the narrow passes 2 and 4 (float32 FMAs); wider D runs
// their products on the tensor cores in 3xTF32.
extern "C" int repro_ssd_narrow_d() { return NARROW_D; }
