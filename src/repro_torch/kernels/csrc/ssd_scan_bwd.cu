// Backward of the Mamba-2 SSD chunked scan for Hopper, sm_90a.
//
// The gradient of src/repro/kernels/ssd_scan.py::ssd_scan_pallas, which has
// no Pallas backward: the JAX package's gradient is autodiff of
// src/repro/kernels/ref.py::ssd_ref.  The forward (csrc/ssd_scan.cu):
//   x [B, S, H, D], a [B, S, H] (log-decay, <= 0), b, c [B, S, N] shared
//   across the H heads; h_t = exp(a_t) h_{t-1} + x_t (x) b_t, y_t = h_t c_t.
// Given y and dy [B, S, H, D], with g_u = dL/dh_u the dual state
//   g_u = sum_{t >= u} exp(Acum_t - Acum_u) dy_t (x) c_t,
// the gradients are
//   dx_u = g_u b_u,   db_u = sum_h x_u g_u,   dc_t = sum_h dy_t h_t,
//   da_t = sum_{k >= t} sum_d (dy_k y_k - x_k dx_k)   (per head).
// Per chunk c of L tokens (Acum from the chunk's start, as the forward's;
// h_c the state at its start, R_c the dual carried in from the chunks after
// it, G = tril(exp(Acum_t - Acum_u) C_t . B_u), M = tril(exp(Acum_t - Acum_u)
// dy_t . x_u), E = exp(A_tot - Acum_u)):
//   dx = G^T dy + E (B R_c)
//   dc = M B + exp(Acum_t) (dy h_c^T)    (one head's part)
//   db = M^T C + E (x R_c^T)             (one head's part)
//   R_{c-1} = exp(A_tot,c) R_c + r_c,  r_c = (dy * exp(Acum))^T C.
//
// The forward's scratch.  C . B^T [B, nc, L, L], Acum [B, nc, H, L] and
// h_c [B, nc, H, N, D], float32 (also for bfloat16 inputs), as the
// forward's passes 1 to 3 leave them: the forward kernel's own scratch,
// which SSDScan keeps for the backward when a gradient is asked for
// (ssd_scan.py's ssd_scan_bwd runs the forward to get it when no caller
// kept one).  The backward reads it and launches none of those passes.
//
// Passes, launched in order on the caller's stream by one C call (4 to 7
// numbered after the forward's 1 to 3, whose scratch they read):
//   the dual: its local states r_c through the forward's pass-2
//      kernel under DUAL (ssd_chunk_state<true, ...>: dy and c in place of
//      x and b, rows weighted by exp(Acum_t), chunk 0 skipped; 3xTF32
//      mma.sync for D >= 16, its narrow sibling below), and R_c passed
//      backward by the forward's state pass run in reverse;
//   4. per (batch, chunk, head): M (over D-tiles, kept in registers), dx
//      and each token's dy . y - x . dx, summed over D in tile order;
//   5. per (batch, chunk, head, N-tile): one head's db and dc;
//   6. db and dc summed over the heads, in head order;
//   7. per (batch, head): da, the reverse cumulative sum of pass 4's terms
//      over S, a warp a (batch, head).
// Every sum has one fixed order and no pass uses atomics, so a result
// repeats bit for bit.  Every product of passes 4 and 5 (B R_c, G^T dy and
// M = dy x^T; dy h_c^T, x R_c^T, M B and M^T C) runs on the tensor cores
// as mma.sync m16n8k8 in 3xTF32 (ssd_chunk.cuh's mma_3xtf32: each float32
// operand split into a TF32 high and low part, three products summed in
// float32), so float32's accuracy holds where da cancels dy . y against
// x . dx; a block of 4 warps computes 64 x 64 tiles over K tiles of 64,
// each warp 32 x 32.  Where a row is scaled (E_u, exp(Acum_t)) the
// product is scaled after it, in registers, as the plain version does.
// Tiles arrive by the forward's load routes (csrc/ssd_chunk.cuh's Route,
// here with y, dy and dx's rows beside x's): cp.async in two groups a step
// so that the first product starts while the second's tiles still load;
// the L x L scratch (C . B^T, M) always so, h_c and R_c wherever D is a
// multiple of 4.
// On the bfloat16 route the input tiles are bfloat16 (by cp.async, x's, y's
// and dy's where their rows sit on 16 bytes, else by loads), widened at
// the fragment read, and the products with bfloat16 operands drop the
// TF32 low parts that are zero (B R_c, G^T dy, dy h_c^T, x R_c^T, M B and
// M^T C 2 mma.sync each, M = dy x^T 1), every sum in the same order as on
// float copies: the gradients are bit for bit the plain route's.  Pass 4
// keeps four tiles of 64 x 72 floats (G; dy; b, then x;
// R_c, then y: x and y load while G^T dy runs) and pass 5 four (dy, h_c,
// x, R_c, then M twice, b, c): 75.0 and 74.2 KB, so an SM holds 3 blocks
// of either (12 warps); a bfloat16 tile fills half of its region.  Shared
// float tiles are padded (rows of 68 floats where
// a fragment reads along a row, 72 where it reads down a column) so that
// fragment reads are free of bank conflicts, but for dy's reads as M's A
// operand (two-way); bfloat16 tiles' rows of 72 halves are free either
// way.
//
// Bound.  At zamba2's heads (H 32, D 128, N 64), B 2 x S 2048, reading
// the kept scratch the function needs ~11.9 GFLOP of products (the
// intra-chunk pairs of G^T dy, M, M B and M^T C; the dual's local states;
// the carries B R_c, dy h_c^T and x R_c^T) against ~342 MB of inputs,
// gradients and the kept scratch (69 MB): ~0.102 ms of bytes, ~0.072 ms
// of operations on 3xTF32 tensor cores.  Computing C . B^T and h_c again
// instead needs no kept bytes but two more l x D x N products a chunk:
// ~0.085 ms of operations, the smaller of the two and the bound
// chip_smoke.py reports.  The kernel takes the kept route all the same:
// what it saves is the forward's passes, not bytes at the bound.  What
// still holds the kernel back is memory traffic the
// design adds: the dual's states (written, passed in place, read by
// passes 4 and 5), M and the per-head db and dc go through device memory,
// and passes 4 and 5 both read dy, x and R_c, ~1 GB in all at zamba2's
// shape; fusing passes 4 and 5 where one N-tile covers N would drop M and
// the second reads.  Besides, each warp splits every fragment it reads
// into its TF32 pair again, and D below 64 (mLSTM's normalizer, D 1) pays
// for 64-wide tiles.
//
// Above the diagonal exp(Acum_t - Acum_u) overflows (mLSTM's log-decay
// reaches -13.8 a token), so the triangle is selected before the
// exponential, never multiplied by a 0/1 mask.  A ragged last chunk reads
// x = a = b = c = dy = y = 0 past S and stores only rows before S.  The
// scratch is the wrapper's torch.empty: every pass writes all of what a
// later one reads.
#include "ssd_chunk.cuh"

namespace {

constexpr int NTB = 128;          // threads of a pass-4 or pass-5 block
constexpr int FT = TILE * LDK;    // floats of a shared tile (rows <= LDK)

// this warp's 32 x 32 accumulator rows r0 + 16 mi + g + 8 hf scaled by w
__device__ __forceinline__ void scale_rows(float (&acc)[2][4][4],
                                           const float* __restrict__ w,
                                           int r0) {
  const int g = (threadIdx.x % 32) / 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float s = w[r0 + 16 * mi + g + 8 * hf];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        acc[mi][ni][2 * hf] *= s;
        acc[mi][ni][2 * hf + 1] *= s;
      }
    }
}

// -- pass 4: M, dx and the da terms per (batch, chunk, head) -----------------

constexpr size_t kSmemDx = sizeof(float) * (4 * (size_t)FT + 5 * L);

// The input tiles are of TS (Smem: bfloat16 on kBf16, else float; a
// bfloat16 tile fills half of its region); x_async: x, y and dy by cp.async
// (their rows on 16 bytes, TS the inputs' type).
template <typename S, bool ASYNC_BC>
__global__ void __launch_bounds__(NTB, 3)
ssd_bwd_dx(const S* __restrict__ x, const S* __restrict__ bm,
           const S* __restrict__ y, const S* __restrict__ dy,
           const float* __restrict__ cb, const float* __restrict__ acum,
           const float* __restrict__ gstates, S* __restrict__ dx,
           float* __restrict__ mout, float* __restrict__ qout, int s_len,
           int n_heads, int d_len, int n_len, int nc, int x_async) {
  using TS = Smem<S, ASYNC_BC>;
  constexpr bool XA = std::is_same<S, TS>::value;  // x may come by cp.async
  constexpr int LDB = std::is_same<TS, float>::value ? LDS : LDK;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;              // G [t][u] (LDK), read K-major
  TS* dys = reinterpret_cast<TS*>(gs + FT);      // dy [t][d] (LDK)
  TS* bxs = reinterpret_cast<TS*>(gs + 2 * FT);  // b [u][n], then x [u][d]
  float* rs = gs + 3 * FT;       // R_c [n][d] (LDK), then y [u][d] (LDK)
  TS* ys = reinterpret_cast<TS*>(rs);
  float* as = gs + 4 * FT;       // [L] Acum
  float* ew = as + L;            // [L] E = exp(A_tot - Acum)
  float* qp = ew + L;            // [2][L] the da terms of each column half
  float* q = qp + 2 * L;         // [L] dy . y - x . dx, summed over D
  const int h = blockIdx.x, b = blockIdx.y / nc, ci = blockIdx.y % nc;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int r0 = 32 * (warp % 2), c0 = 32 * (warp / 2);  // this warp's block
  const size_t base = ((size_t)b * nc + ci) * n_heads + h;
  const size_t xrow = (size_t)n_heads * d_len;
  const size_t xoff = ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len;
  const S* bb = bm + ((size_t)b * s_len + t0) * n_len;
  const float* rc = gstates + base * n_len * d_len;
  const bool s_async = d_len % 4 == 0;  // R_c's rows on 16 bytes

  load_tile<float, float, true, L, L>(gs, LDK,
                                      cb + ((size_t)b * nc + ci) * L * L, L,
                                      L, L);
  hopper::cp_async_commit();
  if (tid < L) {
    as[tid] = acum[base * L + tid];
    ew[tid] = expf(acum[base * L + L - 1] - acum[base * L + tid]);
    q[tid] = 0.f;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < L * L; i += NTB) {  // select, then decay
    const int t = i / L, u = i % L;
    float* p = &gs[t * LDK + u];
    *p = u <= t ? *p * expf(as[t] - as[u]) : 0.f;
  }

  float m[2][4][4] = {};
  for (int d0 = 0; d0 < d_len; d0 += TILE) {
    float acc[2][4][4] = {};
    for (int n0 = 0; n0 < n_len; n0 += TILE) {
      __syncthreads();  // the last tiles are consumed
      load_tile<S, TS, ASYNC_BC, L, TILE>(bxs, LDB, bb + n0, n_len, len,
                                          n_len - n0);
      load_tile_if<float, float, true, TILE, TILE>(
          s_async, rs, LDK, rc + (size_t)n0 * d_len + d0, d_len, n_len - n0,
          d_len - d0);
      hopper::cp_async_commit();
      if (n0 == 0) {  // dy goes on loading while B R_c runs
        load_tile_if<S, TS, XA, L, TILE>(x_async, dys, LDK, dy + xoff + d0,
                                         xrow, len, d_len - d0);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
      mma_3xtf32(acc, bxs, LDB, 1, rs, LDK, 1, r0, c0);  // (u, d) += B R_c
    }
    __syncthreads();  // b and R_c are consumed: x and y load in their place
    load_tile_if<S, TS, XA, L, TILE>(x_async, bxs, LDB, x + xoff + d0, xrow,
                                     len, d_len - d0);
    load_tile_if<S, TS, XA, L, TILE>(x_async, ys, LDK, y + xoff + d0, xrow,
                                     len, d_len - d0);
    hopper::cp_async_commit();
    scale_rows(acc, ew, r0);                           // E_u (B R_c)
    hopper::cp_async_wait<1>();                        // dy
    __syncthreads();
    mma_3xtf32(acc, gs, 1, LDK, dys, LDK, 1, r0, c0);  // + G^T dy
    hopper::cp_async_wait<0>();                        // x and y
    __syncthreads();
    mma_3xtf32(m, dys, LDK, 1, bxs, 1, LDB, r0, c0);   // M(t, u) += dy x^T

    // dx, and each row's dy . y - x . dx over this tile's columns: a
    // thread's 8 columns in order, its 4 lanes by shuffles, then the two
    // column halves, left first
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int u = r0 + 16 * mi + g + 8 * hf;
        float part = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int d = c0 + 8 * ni + 2 * qd;
          if (u >= len || d0 + d >= d_len) continue;
          const size_t at = xoff + (size_t)u * xrow + d0 + d;
          const float* v = &acc[mi][ni][2 * hf];
          if (x_async)  // rows on 16 bytes: both columns in
            store2(&dx[at], v[0], v[1]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (d0 + d + e >= d_len) break;
            if (!x_async) store(&dx[at + e], v[e]);
            part += to_f32(dys[u * LDK + d + e]) * to_f32(ys[u * LDK + d + e]) -
                    to_f32(bxs[u * LDB + d + e]) * v[e];
          }
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (qd == 0) qp[(warp / 2) * L + u] = part;
      }
    __syncthreads();
    if (tid < L) q[tid] += qp[tid] + qp[L + tid];
  }
  float* mo = mout + base * L * L;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + 16 * mi + g + 8 * hf;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int u = c0 + 8 * ni + 2 * qd;
        *reinterpret_cast<float2*>(&mo[t * L + u]) = make_float2(
            u <= t ? m[mi][ni][2 * hf] * expf(as[t] - as[u]) : 0.f,
            u + 1 <= t ? m[mi][ni][2 * hf + 1] * expf(as[t] - as[u + 1])
                       : 0.f);
      }
    }
  if (tid < L) qout[base * L + tid] = q[tid];
}

// -- pass 5: one head's db and dc per (batch, chunk, head, N-tile) -----------

constexpr size_t kSmemDbDc = sizeof(float) * (4 * (size_t)FT + 2 * L);

// Input tiles of TS and x_async as pass 4's.
template <typename S, bool ASYNC_BC>
__global__ void __launch_bounds__(NTB, 3)
ssd_bwd_dbdc(const S* __restrict__ x, const S* __restrict__ bm,
             const S* __restrict__ cm, const S* __restrict__ dy,
             const float* __restrict__ acum, const float* __restrict__ hstates,
             const float* __restrict__ gstates, const float* __restrict__ mm,
             float* __restrict__ dbp, float* __restrict__ dcp, int s_len,
             int n_heads, int d_len, int n_len, int nc, int x_async) {
  using TS = Smem<S, ASYNC_BC>;
  constexpr bool XA = std::is_same<S, TS>::value;  // x may come by cp.async
  constexpr int LDA = std::is_same<TS, float>::value ? LDS : LDK;
  extern __shared__ __align__(16) float smem[];
  float* t0s = smem;             // dy [t][d] (LDA), then M [t][u] (LDS)
  float* t1s = t0s + FT;         // h_c [n][d] (LDS), then M [t][u] (LDK)
  float* t2s = t1s + FT;         // x [u][d] (LDA), then b [u][n] (LDK)
  float* t3s = t2s + FT;         // R_c [n][d] (LDS), then c [t][n] (LDK)
  TS* dys = reinterpret_cast<TS*>(t0s);
  TS* xbs = reinterpret_cast<TS*>(t2s);
  TS* cs = reinterpret_cast<TS*>(t3s);
  float* et = t3s + FT;          // [L] exp(Acum)
  float* ew = et + L;            // [L] E = exp(A_tot - Acum)
  const int n0 = blockIdx.x * TILE, h = blockIdx.y;
  const int b = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int r0 = 32 * (warp % 2), c0 = 32 * (warp / 2);
  const size_t base = ((size_t)b * nc + ci) * n_heads + h;
  const size_t xrow = (size_t)n_heads * d_len;
  const size_t xoff = ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len;
  const size_t brow = ((size_t)b * s_len + t0) * n_len + n0;
  const size_t soff = base * n_len * d_len + (size_t)n0 * d_len;
  const int nn = n_len - n0;
  const bool s_async = d_len % 4 == 0;  // h_c's and R_c's rows on 16 bytes
  if (tid < L) {
    et[tid] = expf(acum[base * L + tid]);
    ew[tid] = expf(acum[base * L + L - 1] - acum[base * L + tid]);
  }
  float dc[2][4][4] = {}, db[2][4][4] = {};
  for (int d0 = 0; d0 < d_len; d0 += TILE) {
    const int dcols = d_len - d0;
    __syncthreads();  // the last tiles are consumed
    load_tile_if<S, TS, XA, L, TILE>(x_async, dys, LDA, dy + xoff + d0, xrow,
                                     len, dcols);
    load_tile_if<float, float, true, TILE, TILE>(
        s_async, t1s, LDS, hstates + soff + d0, d_len, nn, dcols);
    hopper::cp_async_commit();
    load_tile_if<S, TS, XA, L, TILE>(x_async, xbs, LDA, x + xoff + d0, xrow,
                                     len, dcols);
    load_tile_if<float, float, true, TILE, TILE>(
        s_async, t3s, LDS, gstates + soff + d0, d_len, nn, dcols);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // dy and h_c; x and R_c go on loading
    __syncthreads();
    mma_3xtf32(dc, dys, LDA, 1, t1s, 1, LDS, r0, c0);  // (t, n) += dy h_c^T
    hopper::cp_async_wait<0>();
    __syncthreads();
    mma_3xtf32(db, xbs, LDA, 1, t3s, 1, LDS, r0, c0);  // (u, n) += x R_c^T
  }
  __syncthreads();  // the D-tiles are consumed
  const float* mb = mm + base * L * L;
  load_tile<float, float, true, L, L>(t0s, LDS, mb, L, L, L);
  load_tile<S, TS, ASYNC_BC, L, TILE>(xbs, LDK, bm + brow, n_len, len, nn);
  hopper::cp_async_commit();
  load_tile<float, float, true, L, L>(t1s, LDK, mb, L, L, L);
  load_tile<S, TS, ASYNC_BC, L, TILE>(cs, LDK, cm + brow, n_len, len, nn);
  hopper::cp_async_commit();
  scale_rows(dc, et, r0);  // exp(Acum_t) (dy h_c^T)
  scale_rows(db, ew, r0);  // E_u (x R_c^T)
  hopper::cp_async_wait<1>();  // M and b
  __syncthreads();
  mma_3xtf32(dc, t0s, LDS, 1, xbs, LDK, 1, r0, c0);  // + M B
  hopper::cp_async_wait<0>();  // M again and c
  __syncthreads();
  mma_3xtf32(db, t1s, 1, LDK, cs, LDK, 1, r0, c0);   // + M^T C
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + 16 * mi + g + 8 * hf;
      if (t >= len) continue;
      const size_t row = (((size_t)b * s_len + t0 + t) * n_heads + h) * n_len;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + c0 + 8 * ni + 2 * qd;
        const float* vc = &dc[mi][ni][2 * hf];
        const float* vb = &db[mi][ni][2 * hf];
        if (ASYNC_BC) {  // N a multiple of 4: both columns in or out
          if (n < n_len) {
            store2(&dcp[row + n], vc[0], vc[1]);
            store2(&dbp[row + n], vb[0], vb[1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < n_len) {
              dcp[row + n + e] = vc[e];
              dbp[row + n + e] = vb[e];
            }
        }
      }
    }
}

// -- pass 6: db and dc summed over the heads, in head order ------------------

template <typename S>
__global__ void __launch_bounds__(NTH)
ssd_bwd_heads(const float* __restrict__ dbp, const float* __restrict__ dcp,
              S* __restrict__ db, S* __restrict__ dc, size_t rows, int n_heads,
              int n_len) {
  const size_t e = (size_t)blockIdx.x * NTH + threadIdx.x;
  if (e >= rows * n_len) return;
  const size_t r = e / n_len, n = e % n_len;
  const float* pb = dbp + r * n_heads * n_len + n;
  const float* pc = dcp + r * n_heads * n_len + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < n_heads; ++h) {
    sb += pb[(size_t)h * n_len];
    sc += pc[(size_t)h * n_len];
  }
  store(&db[e], sb);
  store(&dc[e], sc);
}

// -- pass 7: da, the reverse cumulative sum over S, a warp a (batch, head) ---

template <typename S>
__global__ void __launch_bounds__(NTH)
ssd_bwd_da(const float* __restrict__ q, S* __restrict__ da, int bsz, int s_len,
           int n_heads, int nc) {
  const int w = (blockIdx.x * NTH + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= bsz * n_heads) return;
  const int b = w / n_heads, h = w % n_heads;
  float carry = 0.f;
  for (int end = s_len; end > 0; end -= 32) {
    const int t = end - 32 + lane;
    float v = 0.f;
    if (t >= 0)
      v = q[(((size_t)b * nc + t / L) * n_heads + h) * L + t % L];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // suffix sums in the warp
      const float o = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v += o;
    }
    if (t >= 0) store(&da[((size_t)b * s_len + t) * n_heads + h], v + carry);
    carry += __shfl_sync(0xffffffffu, v, 0);
  }
}

// -- launch -------------------------------------------------------------------

// ASYNC_BC: b and c tiles by cp.async; ASYNC_X: the dual's local states
// take dy's tiles by cp.async too (kF32Bc (true, false), kF32 and kBf16
// (true, true), kPlain (false, false)); x_async: passes 4 and 5 take x's,
// y's and dy's tiles so (kF32, and kBf16 with those rows on 16 bytes).
template <typename S, bool ASYNC_BC, bool ASYNC_X>
int launch(const S* x, const S* b, const S* c, const S* y, const S* dy,
           S* dx, S* da, S* db, S* dc, const float* fwd, float* scratch,
           int bsz, int s_len, int n_heads, int d_len, int n_len,
           bool x_async, cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  const size_t chunks = (size_t)bsz * nc;
  const size_t elems = (size_t)n_len * d_len;
  // the forward's scratch: C . B^T, Acum, h_c
  const float* cb = fwd;                                 // [B, nc, L, L]
  const float* acum = cb + chunks * L * L;               // [B, nc, H, L]
  const float* hs = acum + chunks * n_heads * L;         // [B, nc, H, N, D]
  // the backward's own (each part on 16 bytes: M and q are whole chunks)
  float* mm = scratch;                                   // [B, nc, H, L, L]
  float* q = mm + chunks * n_heads * L * L;              // [B, nc, H, L]
  float* gs = q + chunks * n_heads * L;                  // [B, nc, H, N, D]
  float* dbp = gs + chunks * n_heads * elems;            // [B, S, H, N]
  float* dcp = dbp + (size_t)bsz * s_len * n_heads * n_len;  // [B, S, H, N]
  const int n_tiles = (n_len + TILE - 1) / TILE;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_dx<S, ASYNC_BC>, kSmemDx)) ||
      (err = allow_smem(ssd_bwd_dbdc<S, ASYNC_BC>, kSmemDbDc)))
    return (int)err;

  const int dt = state_tile(d_len, n_heads, bsz, nc);
  if ((err = local_states<true, S, ASYNC_X>(dy, c, acum, gs, bsz, s_len,
                                            n_heads, d_len, n_len, dt,
                                            stream)) ||
      (err = pass_states<true>(acum, gs, bsz, n_heads, elems, nc, stream)))
    return (int)err;
  ssd_bwd_dx<S, ASYNC_BC>
      <<<dim3(n_heads, (unsigned)chunks), NTB, kSmemDx, stream>>>(
          x, b, y, dy, cb, acum, gs, dx, mm, q, s_len, n_heads, d_len, n_len,
          nc, x_async ? 1 : 0);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_bwd_dbdc<S, ASYNC_BC>
      <<<dim3(n_tiles, n_heads, (unsigned)chunks), NTB, kSmemDbDc, stream>>>(
          x, b, c, dy, acum, hs, gs, mm, dbp, dcp, s_len, n_heads, d_len,
          n_len, nc, x_async ? 1 : 0);
  if ((err = cudaGetLastError())) return (int)err;
  const size_t rows = (size_t)bsz * s_len;
  ssd_bwd_heads<S><<<(unsigned)((rows * n_len + NTH - 1) / NTH), NTH, 0,
                 stream>>>(dbp, dcp, db, dc, rows, n_heads, n_len);
  if ((err = cudaGetLastError())) return (int)err;
  const long long warps = (long long)bsz * n_heads;
  ssd_bwd_da<S><<<(unsigned)((warps * 32 + NTH - 1) / NTH), NTH, 0, stream>>>(
      q, da, bsz, s_len, n_heads, nc);
  return (int)cudaGetLastError();
}

// Floats of the forward's scratch: C . B^T, Acum, h_c.
long long fwd_need(int bsz, int s_len, int n_heads, int d_len, int n_len) {
  const long long nc = (s_len + L - 1) / L, chunks = (long long)bsz * nc;
  return chunks * ((long long)L * L + (long long)n_heads * L +
                   (long long)n_heads * n_len * d_len);
}

// Floats of the backward's own scratch: M, the da terms, the dual's chunk
// states, then db's and dc's per-head parts.
long long scratch_need(int bsz, int s_len, int n_heads, int d_len,
                       int n_len) {
  const long long nc = (s_len + L - 1) / L, chunks = (long long)bsz * nc;
  return chunks * n_heads * ((long long)n_len * d_len + (long long)L * L + L) +
         2LL * bsz * s_len * n_heads * n_len;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for all of x, b, c, y, dy and the
// gradients dx, da, db, dc (contiguous, the shapes of x, a, b, c).  route:
// the load route (Route in csrc/ssd_chunk.cuh; kernels/ssd_scan.py's
// ssd_route, with y, dy and dx beside x).  fwd: n_fwd floats, at least
// fwd_need(...) (the wrapper's scratch_floats), 16-byte aligned: the
// forward kernel's scratch on these inputs, read only.  scratch: n_scratch
// floats, at least scratch_need(...) (the wrapper's bwd_scratch_floats),
// 16-byte aligned; its contents on entry are never read.  Returns
// cudaGetLastError() after the last launch (0 on success).  Without a
// launch: -2 when H or B * ceil(S / 64) exceed a grid dimension (65535),
// and cudaErrorInvalidValue for an unsupported dtype, a route other than
// best_route's or too small a buffer.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* b, const void* c,
                                  const void* y, const void* dy, void* dx,
                                  void* da, void* db, void* dc,
                                  const void* fwd, long long n_fwd,
                                  void* scratch, long long n_scratch,
                                  int route, int dtype, int bsz, int s_len,
                                  int n_heads, int d_len, int n_len,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nc = (s_len + L - 1) / L;
  if (n_heads > 65535 || (long long)bsz * nc > 65535) return kGridTooLarge;
  if (n_fwd < fwd_need(bsz, s_len, n_heads, d_len, n_len) ||
      !aligned16(fwd) ||
      n_scratch < scratch_need(bsz, s_len, n_heads, d_len, n_len) ||
      !aligned16(scratch) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const void* rows[] = {x, y, dy, dx};
  const bool xa = rows_aligned(dtype, rows, 4, d_len);
  if (route != best_route(dtype, xa, b, c, d_len, n_len))
    return (int)cudaErrorInvalidValue;
  const float* fw = static_cast<const float*>(fwd);
  float* sc = static_cast<float*>(scratch);
#define REPRO_SSD_BWD(S, BC, X, XA)                                          \
  launch<S, BC, X>(static_cast<const S*>(x), static_cast<const S*>(b),       \
                   static_cast<const S*>(c), static_cast<const S*>(y),       \
                   static_cast<const S*>(dy), static_cast<S*>(dx),           \
                   static_cast<S*>(da), static_cast<S*>(db),                 \
                   static_cast<S*>(dc), fw, sc, bsz, s_len, n_heads, d_len,  \
                   n_len, XA, st)
  if (dtype == 0) {
    if (route == kF32) return REPRO_SSD_BWD(float, true, true, true);
    if (route == kF32Bc) return REPRO_SSD_BWD(float, true, false, false);
    return REPRO_SSD_BWD(float, false, false, false);
  }
  if (route == kBf16) return REPRO_SSD_BWD(__nv_bfloat16, true, true, xa);
  return REPRO_SSD_BWD(__nv_bfloat16, false, false, false);
#undef REPRO_SSD_BWD
}
