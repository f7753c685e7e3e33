// Passes 1 to 3 of the Mamba-2 SSD chunked scan, shared by the forward
// (csrc/ssd_scan.cu) and its backward (csrc/ssd_scan_bwd.cu): C . B^T and
// Acum per chunk, the chunks' local end states (the forward's s_c, or
// under DUAL the backward's r_c), and the states passed along the chunks,
// forward (h_c) or, for the backward's dual, in reverse; with the load
// routes, the shared tiles' loads and the tensor-core product that both
// kernels use.  csrc/ssd_scan.cu's head comment gives the design.
// Included by one .cu at a time; everything here has internal linkage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int L = 64;          // tokens per chunk
constexpr int TILE = 64;       // edge of a shared tile (D, N and K tiles)
constexpr int LDS = TILE + 4;  // row stride of a float tile read along its rows
// row stride of a float tile read down its columns, and of every bfloat16
// [*, 64] tile (72 halves: 16-byte rows, fragment reads either way free of
// bank conflicts)
constexpr int LDK = TILE + 8;
constexpr int NTH = 256;       // threads of a pass-3 or narrow block
constexpr int NARROW_D = 16;   // D below this takes the narrow passes
constexpr int NTH_NARROW2 = 128;  // threads (state columns) of narrow pass 2
constexpr int PASS3_GROUP = 8;    // chunks whose loads pass 3 issues at once
constexpr int kGridTooLarge = -2; // returned when a grid dimension overflows

// The load routes: how the input tiles reach shared memory.  The C entry
// points take one from the wrapper (kernels/ssd_scan.py's ssd_route, the
// mirror of best_route) and refuse, launching nothing, any other.  The float32 scratch (C . B^T, Acum, the states, M) always
// arrives by cp.async where its rows sit on 16 bytes (D a multiple of 4),
// whatever the route.
enum Route : int {
  kPlain = 0,     // loads converted to float32 tiles
  kF32Bc = 1,     // float32, b and c tiles by cp.async
  kF32 = 2,       // float32, x (y, dy), b and c tiles by cp.async
  kBf16 = 3,      // bfloat16 tiles of b and c (and of x, y, dy where their
                  // rows sit on 16 bytes) by cp.async, widened at the
                  // fragment read
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// an element into a shared tile of float (widened) or of its own type
__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(float& d, bf16 v) {
  d = __bfloat162float(v);
}
__device__ __forceinline__ void put(bf16& d, bf16 v) { d = v; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
// two neighbours, p on 8 bytes (float) or 4 (bfloat16); the same rounding
// as two stores
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// four neighbours of a shared tile as floats (p on 16 bytes, or 8 for
// bfloat16: a widening is a shift of the bits)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float dot4(float4 p, float4 q, float acc) {
  acc = fmaf(p.x, q.x, acc);
  acc = fmaf(p.y, q.y, acc);
  acc = fmaf(p.z, q.z, acc);
  return fmaf(p.w, q.w, acc);
}

// The element type of the shared tiles of an input of type T: T itself
// where its tiles arrive by cp.async (float32 on any route, bfloat16 on
// kBf16), else float32 (loads converted)
template <typename T, bool ASYNC>
using Smem = typename std::conditional<ASYNC, T, float>::type;

// A [ROWS, COLS] tile of src (row stride ld elements) into shared dst (row
// stride ldd elements): rows >= rows or columns >= cols read as zeros.  With
// ASYNC, 16-byte cp.async copies of the elements as they are (TS == T; src
// rows on 16-byte boundaries, cols a whole number of copies; the caller
// commits and waits); else loads, converted where TS is float.
template <typename T, typename TS, bool ASYNC, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(TS* __restrict__ dst, int ldd,
                                          const T* __restrict__ src,
                                          size_t ld, int rows, int cols) {
  if constexpr (ASYNC) {
    static_assert(std::is_same<T, TS>::value, "cp.async copies as they are");
    constexpr int V = 16 / sizeof(T);  // elements a copy
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * (COLS / V); i += blockDim.x) {
      const int r = i / (COLS / V), q = (i % (COLS / V)) * V;
      const bool in = r < rows && q < cols;
      hopper::cp_async16(dst + r * ldd + q, in ? src + r * ld + q : src,
                         in ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * COLS; i += blockDim.x) {
      const int r = i / COLS, q = i % COLS;
      put(dst[r * ldd + q], r < rows && q < cols ? src[r * ld + q] : T{});
    }
  }
}

// The same, by cp.async where `async` (a uniform choice of the block) and
// CAN allow it, else by loads.
template <typename T, typename TS, bool CAN, int ROWS, int COLS>
__device__ __forceinline__ void load_tile_if(bool async, TS* __restrict__ dst,
                                             int ldd,
                                             const T* __restrict__ src,
                                             size_t ld, int rows, int cols) {
  if constexpr (CAN) {
    if (async) {
      load_tile<T, TS, true, ROWS, COLS>(dst, ldd, src, ld, rows, cols);
      return;
    }
  }
  load_tile<T, TS, false, ROWS, COLS>(dst, ldd, src, ld, rows, cols);
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
  // row stride of a [*, DT] tile, float or bfloat16
  static constexpr int LDX = DT + 8;
  static constexpr int OUT_STAGE = L * LDS + TILE * LDX;  // pass 4's stage
};

using hopper::mma_tf32;
using hopper::split_tf32;

// v as a TF32 operand pair: a float32 split into its high and low parts; a
// bfloat16 widened, which is exact in TF32 (8 significant bits of its 11),
// so its low part is zero and never read
__device__ __forceinline__ void tf32_pair(float v, uint32_t& hi,
                                          uint32_t& lo) {
  split_tf32(v, hi, lo);
}
__device__ __forceinline__ void tf32_pair(bf16 v, uint32_t& hi, uint32_t&) {
  hi = __float_as_uint(__bfloat162float(v));
}

// acc += A B over one K tile of 64 for this warp's 32 x 32 block, in
// 3xTF32: each float32 operand split into a TF32 high and low part, and
// a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32 (the low parts'
// product is below float32's rounding), which keeps float32's accuracy.
// An operand held as bfloat16 (TA or TB) has no low part: its products
// drop, 2 mma.sync where one side is bfloat16 and 1 where both are, the
// rest in the same order (so the sums equal those of its widened copy).
// A's element (row r, k) is at A[r * a_rs + k * a_ks]; B's (k, column c)
// at B[k * b_ks + c * b_cs].  Bank-conflict free where a row-major
// float operand (stride 1 along k for A, along c for B) has its other
// stride at 4 (A) or 8 (B) floats past a multiple of 32, and the other way
// round for a transposed one (LDS and LDK), and where a bfloat16 operand's
// other stride is 8 halves past a multiple of 64 either way (LDK, and
// Wide::LDX: two lanes read each 32-bit word).  Fragment layouts of
// m16n8k8 (lane = 4 g + q): A rows g, g + 8 and columns q, q + 4; B rows
// q, q + 4 and column g; C row g (c0, c1) and g + 8 (c2, c3), columns 2 q
// and 2 q + 1.
template <typename TA, typename TB>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[2][4][4],
                                           const TA* __restrict__ A,
                                           int a_rs, int a_ks,
                                           const TB* __restrict__ B,
                                           int b_ks, int b_cs, int r0,
                                           int c0) {
  constexpr bool EXACT_A = std::is_same<TA, bf16>::value;
  constexpr bool EXACT_B = std::is_same<TB, bf16>::value;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 8) {
    uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const TA* a = A + (r0 + 16 * mi + g) * a_rs + (k + q) * a_ks;
      tf32_pair(a[0], ahi[mi][0], alo[mi][0]);
      tf32_pair(a[8 * a_rs], ahi[mi][1], alo[mi][1]);
      tf32_pair(a[4 * a_ks], ahi[mi][2], alo[mi][2]);
      tf32_pair(a[8 * a_rs + 4 * a_ks], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const TB* b = B + (k + q) * b_ks + (c0 + 8 * ni + g) * b_cs;
      tf32_pair(b[0], bhi[ni][0], blo[ni][0]);
      tf32_pair(b[4 * b_ks], bhi[ni][1], blo[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (!EXACT_A) mma_tf32(acc[mi][ni], alo[mi], bhi[ni]);
        if constexpr (!EXACT_B) mma_tf32(acc[mi][ni], ahi[mi], blo[ni]);
        mma_tf32(acc[mi][ni], ahi[mi], bhi[ni]);
      }
  }
}

// -- pass 1: C . B^T per (batch, chunk), Acum per (batch, chunk, head) -----

constexpr int NS1 = 3;           // pass 1's ring stages
constexpr int HG = 32;           // heads whose log-decays a block stages
constexpr int NT1 = 128;         // threads of a pass-1 block

// Acum of chunk ci of batch b for every head, by all NT threads of the
// block: HG heads' log-decays staged in sa at a time, a warp a head
template <typename T, int NT>
__device__ __forceinline__ void chunk_acum(float (&sa)[L][HG + 1],
                                           const T* __restrict__ a,
                                           float* __restrict__ acum, int b,
                                           int ci, int s_len, int n_heads,
                                           int nc) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int t0 = ci * L, len = min(L, s_len - t0);
  for (int h0 = 0; h0 < n_heads; h0 += HG) {
    const int nh = min(HG, n_heads - h0);
    const T* ah = a + ((size_t)b * s_len + t0) * n_heads + h0;
    for (int i = tid; i < L * HG; i += NT) {
      const int t = i / HG, hh = i % HG;
      sa[t][hh] = t < len && hh < nh ? to_f32(ah[(size_t)t * n_heads + hh])
                                     : 0.f;
    }
    __syncthreads();
    for (int hh = tid / 32; hh < nh; hh += NT / 32) {
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

// Pass 1's shared tiles: c's and b's [L, TILE] of type TS (bfloat16 on
// kBf16, else float), at a row stride whose fragment reads (c along its
// rows, b down them as B = b^T) are free of bank conflicts (mma_3xtf32).
template <typename T, bool ASYNC>
struct Pass1 {
  using TS = Smem<T, ASYNC>;
  static constexpr int LD = std::is_same<TS, float>::value ? LDS : LDK;
  static constexpr int STAGE = 2 * L * LD;  // c rows, then b rows
  static constexpr size_t SMEM = sizeof(TS) * NS1 * STAGE;
};

// per (chunk, batch): the whole [L, L] on the tensor cores in 3xTF32
// (float32's accuracy; on bfloat16 tiles every product is exact, one
// mma.sync each), a warp a 32 x 32 block (the one above the diagonal, rows
// < 32 by columns >= 32, stores zeros), the c and b tiles through NS1
// stages: by cp.async where ASYNC (kF32Bc, kF32, kBf16), else by loads
// converted to float tiles
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NT1)
ssd_chunk_cb(const T* __restrict__ a, const T* __restrict__ bm,
             const T* __restrict__ cm, float* __restrict__ cb,
             float* __restrict__ acum, int s_len, int n_heads, int n_len,
             int nc) {
  using P = Pass1<T, ASYNC>;
  using TS = typename P::TS;
  constexpr int LD = P::LD;
  extern __shared__ __align__(16) float smem[];
  __shared__ float sa[L][HG + 1];           // log-decays, [t][head]
  TS* ring = reinterpret_cast<TS*>(smem);
  const int ci = blockIdx.x, b = blockIdx.y;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int r0 = 32 * (warp % 2), c0 = 32 * (warp / 2);  // this warp's block
  const T* bb = bm + ((size_t)b * s_len + t0) * n_len;
  const T* cc = cm + ((size_t)b * s_len + t0) * n_len;
  const int nk = (n_len + TILE - 1) / TILE;
  auto load = [&](int k) {
    TS* st = ring + (k % NS1) * P::STAGE;
    const int n0 = k * TILE;
    load_tile<T, TS, ASYNC, L, TILE>(st, LD, cc + n0, n_len, len,
                                     n_len - n0);
    load_tile<T, TS, ASYNC, L, TILE>(st + L * LD, LD, bb + n0, n_len, len,
                                     n_len - n0);
  };
#pragma unroll
  for (int p = 0; p < NS1 - 1; ++p) {
    if (p < nk) load(p);
    commit<ASYNC>();
  }
  chunk_acum<T, NT1>(sa, a, acum, b, ci, s_len, n_heads, nc);

  float acc[2][4][4] = {};
  for (int k = 0; k < nk; ++k) {
    if (k + NS1 - 1 < nk) load(k + NS1 - 1);
    commit<ASYNC>();
    wait_async<ASYNC, NS1 - 1>();
    __syncthreads();
    const TS* ct = ring + (k % NS1) * P::STAGE;
    if (r0 >= c0) {  // (t, u) += c_t . b_u: A = c [t][n], B = b^T
      // a tile's 64 products from zero, then added in float32: the tensor
      // cores' own accumulation truncates, and over N = 4096 in one sum
      // that reached 8x an FMA kernel's error (y at [1,130,2,16,4096])
      float part[2][4][4] = {};
      mma_3xtf32(part, ct, LD, 1, ct + L * LD, 1, LD, r0, c0);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }
  float* out = cb + ((size_t)b * nc + ci) * L * L;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + 16 * mi + g + 8 * hf;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        store2(&out[t * L + c0 + 8 * ni + 2 * q], acc[mi][ni][2 * hf],
               acc[mi][ni][2 * hf + 1]);
    }
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

// On kBf16 (T bfloat16, ASYNC) x arrives by cp.async into a bfloat16
// staging tile xh and is weighted into the float tile from there, and b's
// tile stays bfloat16 (its products then 2 mma.sync, not 3).
template <typename T, bool ASYNC>
constexpr bool kStaged = ASYNC && std::is_same<T, bf16>::value;

template <int DT, typename T, bool ASYNC>
constexpr size_t smem_state() {
  return sizeof(float) * ((size_t)L * Wide<DT>::LDX + L) +
         sizeof(Smem<T, ASYNC>) * L * LDK +
         (kStaged<T, ASYNC> ? sizeof(T) * L * Wide<DT>::LDX : 0);
}

template <bool DUAL, typename T, bool ASYNC, int DT>
__global__ void __launch_bounds__(Wide<DT>::NT, 512 / Wide<DT>::NT)
ssd_chunk_state(const T* __restrict__ x, const T* __restrict__ bm,
                const float* __restrict__ acum, float* __restrict__ states,
                int s_len, int n_heads, int d_len, int n_len, int nc) {
  using W = Wide<DT>;
  using TS = Smem<T, ASYNC>;
  constexpr bool STAGED = kStaged<T, ASYNC>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [L][LDX] x, weighted by row
  float* ws = xs + L * W::LDX;                   // [L]      the rows' weights
  TS* bs = reinterpret_cast<TS*>(ws + L);        // [L][LDK] b tile
  T* xh = reinterpret_cast<T*>(bs + L * LDK);    // [L][LDX] x, if STAGED
  const int d_tiles = (d_len + DT - 1) / DT;
  const int d0 = (blockIdx.x % d_tiles) * DT;
  const int n0 = (blockIdx.x / d_tiles) * TILE, h = blockIdx.y;
  const int b = blockIdx.z / nc, ci = blockIdx.z % nc;
  if (state_skipped<DUAL>(ci, nc)) return;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t xrow = (size_t)n_heads * d_len;
  const float* ac = acum + (((size_t)b * nc + ci) * n_heads + h) * L;
  const T* xc = x + ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len + d0;

  if constexpr (STAGED)
    load_tile<T, T, true, L, DT>(xh, W::LDX, xc, xrow, len, d_len - d0);
  else
    load_tile<T, float, ASYNC, L, DT>(xs, W::LDX, xc, xrow, len, d_len - d0);
  load_tile<T, TS, ASYNC, L, TILE>(bs, LDK,
                                   bm + ((size_t)b * s_len + t0) * n_len + n0,
                                   n_len, len, n_len - n0);
  commit<ASYNC>();
  if (tid < L) ws[tid] = state_weight<DUAL>(ac, tid);
  wait_async<ASYNC, 0>();
  __syncthreads();
  for (int i = tid; i < L * DT; i += W::NT) {  // weight x's rows
    const int at = (i / DT) * W::LDX + i % DT;
    if constexpr (STAGED)
      xs[at] = to_f32(xh[at]) * ws[i / DT];
    else
      xs[at] *= ws[i / DT];
  }
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
          if (d0 + d < d_len) store2(&row[d], v0, v1);
        } else {
          if (d0 + d < d_len) row[d] = v0;
          if (d0 + d + 1 < d_len) row[d + 1] = v1;
        }
      }
    }
}

// narrow pass 2 (D < NARROW_D): one column d of the state a block, one
// state row n a thread; DUAL as in the wide pass.  On kBf16 (STAGED) the
// block's [L, 128] slice of b arrives by cp.async first.
template <bool DUAL, typename T, bool ASYNC>
__global__ void __launch_bounds__(NTH_NARROW2)
ssd_chunk_state_narrow(const T* __restrict__ x, const T* __restrict__ bm,
                       const float* __restrict__ acum,
                       float* __restrict__ states, int s_len, int n_heads,
                       int d_len, int n_len, int nc) {
  constexpr bool STAGED = kStaged<T, ASYNC>;
  constexpr int LDB = NTH_NARROW2 + 8;
  __shared__ float xw[L];
  __shared__ __align__(16) T bs[STAGED ? L : 1][LDB];
  const int n_tiles = (n_len + NTH_NARROW2 - 1) / NTH_NARROW2;
  const int d = blockIdx.x / n_tiles;
  const int nb = (blockIdx.x % n_tiles) * NTH_NARROW2, n = nb + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z / nc, ci = blockIdx.z % nc;
  if (state_skipped<DUAL>(ci, nc)) return;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const float* ac = acum + (((size_t)b * nc + ci) * n_heads + h) * L;
  const T* bb = bm + ((size_t)b * s_len + t0) * n_len + nb;
  if constexpr (STAGED) {
    load_tile<T, T, true, L, NTH_NARROW2>(&bs[0][0], LDB, bb, n_len, len,
                                          n_len - nb);
    hopper::cp_async_commit();
  }
  if (threadIdx.x < L) {
    const int u = threadIdx.x;
    xw[u] = u < len ? to_f32(x[(((size_t)b * s_len + t0 + u) * n_heads + h) *
                                   d_len + d]) *
                          state_weight<DUAL>(ac, u)
                    : 0.f;
  }
  if constexpr (STAGED) hopper::cp_async_wait<0>();
  __syncthreads();
  if (n >= n_len) return;
  float acc = 0.f;
  if constexpr (STAGED) {
#pragma unroll 16
    for (int u = 0; u < len; ++u)
      acc = fmaf(to_f32(bs[u][threadIdx.x]), xw[u], acc);
  } else {
#pragma unroll 16
    for (int u = 0; u < len; ++u)
      acc = fmaf(to_f32(bb[(size_t)u * n_len + threadIdx.x]), xw[u], acc);
  }
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

// Whether rows of D elements (n_rows pointers: x and y, and dy and dx in
// the backward) sit on 16 bytes: D a whole number of 16 bytes (4 floats,
// 8 halves) and every pointer aligned.
bool rows_aligned(int dtype, const void* const* rows, int n_rows,
                  int d_len) {
  bool xa = d_len % (dtype == 1 ? 8 : 4) == 0;
  for (int i = 0; i < n_rows; ++i) xa = xa && aligned16(rows[i]);
  return xa;
}

// The route of inputs of dtype 0 (float32) or 1 (bfloat16) whose rows of
// D sit on 16 bytes or not (xa, rows_aligned) and b and c of N
// (kernels/ssd_scan.py's route_of mirrors it).  kBf16 needs b's and c's
// rows on 16 bytes, and x's too unless D is below NARROW_D (the narrow
// passes read x's one column by loads; the backward's wide passes take
// its tiles by loads).
int best_route(int dtype, bool xa, const void* b, const void* c, int d_len,
               int n_len) {
  const bool bc = n_len % (dtype == 1 ? 8 : 4) == 0 && aligned16(b) &&
                  aligned16(c);
  if (dtype == 1) return bc && (xa || d_len < NARROW_D) ? kBf16 : kPlain;
  if (bc && xa) return kF32;
  return bc ? kF32Bc : kPlain;
}

// Pass 2 into states [B, nc, H, N, D] with state_tile's D-tile dt: the
// forward's local states from (x, b), or under DUAL the dual's from
// (dy, c).  ASYNC: those two inputs' tiles by cp.async (kF32, kBf16).
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
      constexpr size_t smem = smem_state<128, T, ASYNC>();
      if ((err = allow_smem(ssd_chunk_state<DUAL, T, ASYNC, 128>, smem)))
        return err;
      ssd_chunk_state<DUAL, T, ASYNC, 128>
          <<<grid, Wide<128>::NT, smem, stream>>>(
              x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
    } else {
      constexpr size_t smem = smem_state<64, T, ASYNC>();
      if ((err = allow_smem(ssd_chunk_state<DUAL, T, ASYNC, 64>, smem)))
        return err;
      ssd_chunk_state<DUAL, T, ASYNC, 64>
          <<<grid, Wide<64>::NT, smem, stream>>>(
              x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
    }
  } else {
    const int n_tiles = (n_len + NTH_NARROW2 - 1) / NTH_NARROW2;
    ssd_chunk_state_narrow<DUAL, T, ASYNC>
        <<<dim3(n_tiles * d_len, n_heads, bsz * nc), NTH_NARROW2, 0,
           stream>>>(x, b, acum, states, s_len, n_heads, d_len, n_len, nc);
  }
  return cudaGetLastError();
}

// Passes 1 to 3 into the scratch (16-byte aligned): C . B^T [B, nc, L, L],
// Acum [B, nc, H, L], then the states [B, nc, H, N, D], h_c in slot c.
// dt: state_tile's D-tile.  ASYNC_BC: b and c tiles by cp.async (kF32Bc,
// kF32, kBf16); ASYNC: x's too (kF32, kBf16).
template <typename T, bool ASYNC_BC, bool ASYNC>
cudaError_t chunk_states(const T* x, const T* a, const T* b, const T* c,
                         float* scratch, int bsz, int s_len, int n_heads,
                         int d_len, int n_len, int dt, cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  float* cb = scratch;                                    // [B, nc, L, L]
  float* acum = cb + (size_t)bsz * nc * L * L;            // [B, nc, H, L]
  float* states = acum + (size_t)bsz * nc * n_heads * L;  // [B, nc, H, N, D]
  cudaError_t err;
  constexpr size_t smem = Pass1<T, ASYNC_BC>::SMEM;
  if ((err = allow_smem(ssd_chunk_cb<T, ASYNC_BC>, smem))) return err;
  ssd_chunk_cb<T, ASYNC_BC><<<dim3(nc, bsz), NT1, smem, stream>>>(
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
