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
// All but the decays (under 0.1% of the flops) run below on the tensor
// cores in 3xTF32, at a third of TF32's dense 495 TFLOP/s, so
// the ridge is ~49 flops a byte and zamba2 is bound by bytes (~10 us);
// mLSTM's values (D = N = 384, ~2.6 GFLOP against ~25 MB) are bound by
// the tensor cores' operations (~15 us).  The D = 1 normalizer runs all
// but C . B^T on FMAs and is bound by reading b and c (~4 us).  The design below moves
// more: the chunk states go through device memory (16.8 MB at zamba2,
// S = 1024), written by pass 2, read and written by pass 3, read by pass
// 4, and that traffic, not the arithmetic, sets the kernel's time.
//
// Design.  The TPU kernel carried the [D, N] state in VMEM along a
// sequential grid axis, so a chunk waited for the one before.  Here the
// chunks run in parallel, split as the Mamba-2 paper splits its chunked
// algorithm (Dao & Gu, arXiv:2405.21060, section 6), in four passes that
// one C call launches in order on the caller's stream:
//   1. per (batch, chunk): C . B^T [L, L] once for all H heads (b and c
//      are shared; the quarter above the diagonal is zeros) on the tensor
//      cores in 3xTF32, each K tile's sum added in float32, and per head
//      the chunk's Acum (the block stages the chunk's log-decays in shared
//      memory, a warp scans a head);
//   2. per (batch, chunk, head, D-tile, N-tile): the chunk's local end
//      state s_c, stored [N, D] (D contiguous) in a float32 scratch (the
//      last chunk's is never read, and not computed);
//   3. per (batch, head, element of the state): the states passed along
//      the chunks in place, so slot c ends up holding h_c; every factor
//      exp(A_tot) is <= 1, and no exp of a difference across chunks is
//      ever taken;
//   4. per (batch, chunk, head, D-tile): y from C . B^T, x and h_c.
// Passes 1 to 3 live in csrc/ssd_chunk.cuh: the backward
// (csrc/ssd_scan_bwd.cu) reads their scratch, kept from the forward when a
// gradient is asked for, and runs its dual's local states through pass 2's
// kernel.
// Only pass 3 walks the chunks, and it is elementwise over D * N with the
// loads of 8 chunks in flight, so the grids fill the card (pass 4 at
// S = 1024: 512 blocks at zamba2, 384 at mLSTM's values, 256 at its
// normalizer).  The products of passes 2 and 4 (the local states,
// C . h_c^T and G @ x) run on the tensor cores as mma.sync m16n8k8 in
// 3xTF32: each
// float32 operand split into a TF32 high and low part, and the three
// products that matter summed in float32, which keeps float32's accuracy
// (single TF32 keeps ~3 digits, and the reference's 3e-3 is for float32).
// A wide block
// computes a [64, DT] tile with DT / 16 warps of 32 x 32; DT is 128 for
// D > 64 where pass 4 then still has two blocks for each SM, else 64.
// Shared tiles are padded so that every fragment read is free of bank
// conflicts.  Pass 4's K runs over tiles of 64 through a ring of two
// shared-memory stages that ends with (C . B^T, x) as its last item, whose
// tile becomes G in place, so two blocks fit an SM at any N; the next
// tile loads by cp.async while the block computes on the last.  How the
// input tiles arrive is the load route (csrc/ssd_chunk.cuh's Route; the
// wrapper names it and this entry point refuses any other).  float32 with x's, b's and c's rows on 16 bytes (D and N multiples
// of 4, aligned pointers): every tile by cp.async (kF32); with only b's
// and c's (kF32Bc), those.  bfloat16 with b's and c's rows on 16 bytes (N
// a multiple of 8) and x's too or D below 16 (kBf16): bfloat16 tiles by
// 16-byte cp.async, half the bytes of float ones, widened at the fragment
// read (a shift of the bits); a bfloat16 value is exact in TF32, so a
// product with one bfloat16 operand runs 2 TF32 mma.sync (C . h_c^T, b^T
// (w x), G x), with two 1 (pass 1's C . B^T), with the same sums in the
// same order as on float copies (the products dropped add exact zeros):
// the scratch and y are bit for bit those of the plain route.  Pass 2 weights x's rows in float32 from a
// bfloat16 staging tile.  Any other input (kPlain) loads converted to
// float32 tiles.  The float32 scratch tiles (C . B^T, h_c) arrive by
// cp.async on every route where D is a multiple of 4.
// D < 16 (the mLSTM normalizer's D = 1)
// takes narrow passes 2 and 4 (float32 FMAs) with one column of D a
// block, so D = 1 pays for one column, not 64; narrow
// pass 4 loads its 16 rows of c for all of N (in slices of 512) in one
// round, narrow pass 2 on the bfloat16 route its block's [L, 128] slice
// of b by cp.async.  Above the diagonal exp(Acum_t - Acum_u) overflows (mLSTM's
// log-decay reaches -13.8 a token), so the triangle is selected before the
// exponential, never multiplied by a 0/1 mask.  A ragged last chunk reads
// x = a = b = c = 0 past S and stores only rows before S.  The scratch
// (C . B^T, Acum, the states) is the wrapper's torch.empty: every pass
// writes all of what a later one reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_chunk.cuh"

namespace {

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// -- pass 4: every chunk's output ------------------------------------------

// Two ring stages, each a [L][LDS] float region and a [TILE][LDX] one
// (Wide::OUT_STAGE floats).  Items 0 .. nk - 1 are (c, h_c) tiles over N
// for the carry C . h_c^T; item nk is (C . B^T, x), which becomes G in
// place and meets x last.  c and x are tiles of TS: bfloat16 on kBf16
// (half of their regions), else float.
template <typename T, bool ASYNC, int DT>
__global__ void __launch_bounds__(Wide<DT>::NT, 512 / Wide<DT>::NT)
ssd_chunk_out(const T* __restrict__ x, const T* __restrict__ cm,
              const float* __restrict__ cb, const float* __restrict__ acum,
              const float* __restrict__ states, T* __restrict__ y, int s_len,
              int n_heads, int d_len, int n_len, int nc) {
  using W = Wide<DT>;
  using TS = Smem<T, ASYNC>;
  constexpr int LDC = std::is_same<TS, float>::value ? LDS : LDK;  // c's
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
  const bool s_async = d_len % 4 == 0;    // h_c's rows on 16 bytes
  auto load = [&](int k) {
    float* lo = ring + (k & 1) * STAGE;   // [L][LDS] floats
    float* hi = lo + L * LDS;             // [TILE][LDX] floats
    if (k < nk) {
      const int n0 = k * TILE;
      load_tile<T, TS, ASYNC, L, TILE>(reinterpret_cast<TS*>(lo), LDC,
                                       cc + n0, n_len, len, n_len - n0);
      load_tile_if<float, float, true, TILE, DT>(
          s_async, hi, W::LDX, hc + (size_t)n0 * d_len, d_len, n_len - n0,
          d_len - d0);
    } else {
      load_tile<float, float, true, L, L>(
          lo, LDS, cb + ((size_t)b * nc + ci) * L * L, L, L, L);
      load_tile<T, TS, ASYNC, L, DT>(reinterpret_cast<TS*>(hi), W::LDX,
                                     x + off_x, xrow, len, d_len - d0);
    }
    hopper::cp_async_commit();
  };

  load(0);
  if (tid < L) as[tid] = acum[(((size_t)b * nc + ci) * n_heads + h) * L + tid];
  float acc[2][4][4] = {};
  for (int k = 0; k <= nk; ++k) {
    if (k < nk) {
      load(k + 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    float* lo = ring + (k & 1) * STAGE;
    const float* hi = lo + L * LDS;
    if (k < nk) {  // carry += C . h_c^T over this N tile
      mma_3xtf32(acc, reinterpret_cast<const TS*>(lo), LDC, 1, hi, W::LDX, 1,
                 r0, c0);
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
      mma_3xtf32(acc, lo, LDS, 1, reinterpret_cast<const TS*>(hi), W::LDX, 1,
                 r0, c0);
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
        const float* v = &acc[mi][ni][2 * hf];
        if (ASYNC) {  // rows on 16 bytes: both columns in or out
          if (d0 + d < d_len) store2(&yr[d], v[0], v[1]);
        } else {
          if (d0 + d < d_len) store(&yr[d], v[0]);
          if (d0 + d + 1 < d_len) store(&yr[d + 1], v[1]);
        }
      }
    }
}

// narrow pass 4 (D < NARROW_D): one column d and 16 rows of the chunk a
// block, all of N (in slices of NW) loaded in one round; thread (r, kp) =
// (tid / 16, tid % 16) sums a sixteenth of each slice for row r, and the
// sixteenths meet by shuffles.  ASYNC: c by cp.async (kF32Bc, kF32 and,
// into a bfloat16 tile, kBf16).
constexpr int NARROW_ROWS = 16;
constexpr int NW = 512;           // state columns a narrow block holds

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NTH)
ssd_chunk_out_narrow(const T* __restrict__ x, const T* __restrict__ cm,
                     const float* __restrict__ cb,
                     const float* __restrict__ acum,
                     const float* __restrict__ states, T* __restrict__ y,
                     int s_len, int n_heads, int d_len, int n_len, int nc) {
  using TS = Smem<T, ASYNC>;
  constexpr int LDW = NW + 16 / sizeof(TS);  // c's rows, on 16 bytes
  __shared__ __align__(16) TS cs[NARROW_ROWS * LDW];     // c rows, N slice
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
    load_tile<T, TS, ASYNC, NARROW_ROWS, NW>(cs, LDW, cc + n0, n_len, c_rows,
                                             n_len - n0);
    commit<ASYNC>();
    for (int i = tid; i < NW; i += NTH)
      hv[i] = n0 + i < n_len ? hc[(size_t)(n0 + i) * d_len] : 0.f;
    wait_async<ASYNC, 0>();
    __syncthreads();
#pragma unroll
    for (int m = 0; m < NW / 64; ++m) {
      const int k = 4 * kp + 64 * m;
      carry = dot4(load4(&cs[r * LDW + k]), load4(&hv[k]), carry);
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

template <int DT>
constexpr size_t smem_out() {
  return sizeof(float) * (L + 2 * (size_t)Wide<DT>::OUT_STAGE);
}

// wide pass 4 with D-tiles of DT columns
template <typename T, bool ASYNC, int DT>
int launch_out(const T* x, const T* c, const float* cb, const float* acum,
               const float* states, T* y, int bsz, int s_len, int n_heads,
               int d_len, int n_len, int nc, cudaStream_t stream) {
  cudaError_t err;
  if ((err = allow_smem(ssd_chunk_out<T, ASYNC, DT>, smem_out<DT>())))
    return (int)err;
  ssd_chunk_out<T, ASYNC, DT>
      <<<dim3((d_len + DT - 1) / DT, n_heads, bsz * nc), Wide<DT>::NT,
         smem_out<DT>(), stream>>>(x, c, cb, acum, states, y, s_len, n_heads,
                                   d_len, n_len, nc);
  return (int)cudaGetLastError();
}

// ASYNC_BC: b and c tiles by cp.async (passes 1 and the narrow 4); ASYNC:
// x's too (the wide passes 2 and 4): kF32Bc (true, false), kF32 and kBf16
// (true, true), kPlain (false, false).  Passes 1 to 3 are
// csrc/ssd_chunk.cuh's chunk_states.
template <typename T, bool ASYNC_BC, bool ASYNC>
int launch(const T* x, const T* a, const T* b, const T* c, T* y,
           float* scratch, int bsz, int s_len, int n_heads, int d_len,
           int n_len, cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  const float* cb = scratch;                              // [B, nc, L, L]
  const float* acum = cb + (size_t)bsz * nc * L * L;      // [B, nc, H, L]
  const float* states = acum + (size_t)bsz * nc * n_heads * L;
  const int dt = state_tile(d_len, n_heads, bsz, nc);
  cudaError_t err;
  if ((err = chunk_states<T, ASYNC_BC, ASYNC>(x, a, b, c, scratch, bsz, s_len,
                                              n_heads, d_len, n_len, dt,
                                              stream)))
    return (int)err;
  if (dt == 128)
    return launch_out<T, ASYNC, 128>(x, c, cb, acum, states, y, bsz, s_len,
                                     n_heads, d_len, n_len, nc, stream);
  if (dt == 64)
    return launch_out<T, ASYNC, 64>(x, c, cb, acum, states, y, bsz, s_len,
                                    n_heads, d_len, n_len, nc, stream);
  ssd_chunk_out_narrow<T, ASYNC_BC>
      <<<dim3(d_len * (L / NARROW_ROWS), n_heads, bsz * nc), NTH, 0,
         stream>>>(x, c, cb, acum, states, y, s_len, n_heads, d_len, n_len,
                   nc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  route: the load route (Route in
// csrc/ssd_chunk.cuh; kernels/ssd_scan.py's ssd_route).  scratch: n_scratch
// floats, at least B * nc * (L * L + H * L + H * N * D) with nc = ceil(S /
// L), 16-byte aligned; its contents on entry are never read.  Returns
// cudaGetLastError() after the last launch (0 on success).  Without a
// launch: -2 when H or B * nc exceed a grid dimension (65535), and
// cudaErrorInvalidValue for an unsupported dtype, a route other than
// best_route's or too small a scratch.
extern "C" int repro_ssd_scan(const void* x, const void* a, const void* b,
                              const void* c, void* y, void* scratch,
                              long long n_scratch, int route, int dtype,
                              int bsz, int s_len, int n_heads, int d_len,
                              int n_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nc = (s_len + L - 1) / L;
  if (n_heads > 65535 || (long long)bsz * nc > 65535) return kGridTooLarge;
  const long long need =
      (long long)bsz * nc *
      ((long long)L * L + (long long)n_heads * L +
       (long long)n_heads * n_len * d_len);
  if (n_scratch < need || !aligned16(scratch) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* rows[] = {x, y};
  if (route != best_route(dtype, rows_aligned(dtype, rows, 2, d_len), b, c,
                          d_len, n_len))
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) {
    using F = float;
    const F *xf = static_cast<const F*>(x), *af = static_cast<const F*>(a),
            *bf = static_cast<const F*>(b), *cf = static_cast<const F*>(c);
    F* yf = static_cast<F*>(y);
    if (route == kF32)
      return launch<F, true, true>(xf, af, bf, cf, yf, sc, bsz, s_len,
                                   n_heads, d_len, n_len, st);
    if (route == kF32Bc)
      return launch<F, true, false>(xf, af, bf, cf, yf, sc, bsz, s_len,
                                    n_heads, d_len, n_len, st);
    return launch<F, false, false>(xf, af, bf, cf, yf, sc, bsz, s_len,
                                   n_heads, d_len, n_len, st);
  }
  using B = __nv_bfloat16;
  const B *xh = static_cast<const B*>(x), *ah = static_cast<const B*>(a),
          *bh = static_cast<const B*>(b), *ch = static_cast<const B*>(c);
  B* yh = static_cast<B*>(y);
  if (route == kBf16)
    return launch<B, true, true>(xh, ah, bh, ch, yh, sc, bsz, s_len, n_heads,
                                 d_len, n_len, st);
  return launch<B, false, false>(xh, ah, bh, ch, yh, sc, bsz, s_len, n_heads,
                                 d_len, n_len, st);
}

// D below this takes the narrow passes 2 and 4 (float32 FMAs); wider D runs
// their products on the tensor cores in 3xTF32.
extern "C" int repro_ssd_narrow_d() { return NARROW_D; }
