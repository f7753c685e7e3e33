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
// Passes, launched in order on the caller's stream by one C call:
//   1-3. the forward's passes 1 to 3 (csrc/ssd_chunk.cuh, the same kernels
//      csrc/ssd_scan.cu launches): C . B^T and Acum per chunk, the local
//      end states s_c (3xTF32 mma.sync for D >= 16), and h_c passed
//      forward along the chunks; then the dual's local states r_c per
//      (batch, chunk, head, N-tile, D-tile), and R_c passed backward by
//      the same state pass run in reverse;
//   4. per (batch, chunk, head): M (over D-tiles, kept in registers), dx
//      and each token's dy . y - x . dx, summed over D in tile order;
//   5. per (batch, chunk, head, N-tile): one head's db and dc;
//   6. db and dc summed over the heads, in head order;
//   7. per (batch, head): da, the reverse cumulative sum of pass 4's terms
//      over S, a warp a (batch, head).
// Every sum has one fixed order and no pass uses atomics, so a result
// repeats bit for bit.  The backward's own products (the dual's local
// states and passes 4 and 5) are float32 FMAs through 64 x 64 shared
// tiles (a block of 256 threads, each a 4 x 4 patch; rows of 65 floats, so
// column reads are free of bank conflicts); bfloat16 inputs are converted
// on load, all sums are float32.
//
// Bound.  At zamba2's heads (H 32, D 128, N 64), B 2 x S 2048, the function
// needs ~14 GFLOP of products (the intra-chunk pairs of G^T dy, M, M B and
// M^T C; the carries; the local states it must recompute) against ~270 MB
// of inputs and gradients: on 3xTF32 tensor cores the operations and the
// bytes each take ~0.08 ms; on FMAs the operations ~0.21 ms.  This design
// is the simple one: its own products on FMAs through shared tiles, the
// two state sets, M and the per-head db and dc through device memory.
// Moving passes 4 and 5 onto 3xTF32 mma.sync, as the forward's products
// are, and fusing the recomputed forward passes, are left for later.
//
// Above the diagonal exp(Acum_t - Acum_u) overflows (mLSTM's log-decay
// reaches -13.8 a token), so the triangle is selected before the
// exponential, never multiplied by a 0/1 mask.  A ragged last chunk reads
// x = a = b = c = dy = y = 0 past S and stores only rows before S.  The
// scratch is the wrapper's torch.empty: every pass writes all of what a
// later one reads.
#include "ssd_chunk.cuh"

namespace {

// The backward's own passes run on FMAs through TILE x TILE shared tiles
// (ssd_chunk.cuh's TILE, 64), a block of NTH = 256 threads, each a 4 x 4
// patch of the output.
constexpr int LDT = TILE + 1;      // row stride of a shared tile, in floats
constexpr int FTILE = TILE * LDT;  // floats of a shared tile

// A [TILE, TILE] tile of src (row stride ld) into shared dst: rows >= rows
// and columns >= cols read as zeros; row r is multiplied by scale[r] if
// given.
template <typename S>
__device__ __forceinline__ void load_ftile(float* __restrict__ dst,
                                           const S* __restrict__ src,
                                           size_t ld, int rows, int cols,
                                           const float* scale = nullptr) {
#pragma unroll 4
  for (int i = threadIdx.x; i < TILE * TILE; i += NTH) {
    const int r = i / TILE, q = i % TILE;
    float v = r < rows && q < cols ? to_f32(src[(size_t)r * ld + q]) : 0.f;
    dst[r * LDT + q] = scale ? v * scale[r] : v;
  }
}

// acc[i][j] += sum_k A(ty + 16 i, k) B(k, tx + 16 j) over the TILE values of k,
// with A(r, k) = A[r * ars + k * aks] and B(k, c) = B[k * bks + c * bcs]:
// the strides read either operand transposed.
__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         const float* __restrict__ A, int ars,
                                         int aks, const float* __restrict__ B,
                                         int bks, int bcs) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = A[(ty + 16 * i) * ars + k * aks];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = B[k * bks + (tx + 16 * j) * bcs];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// -- the dual's local states r_c, stored [N, D] ------------------------------

// r_c[n][d] = sum_t exp(Acum_t) dy_t[d] c_t[n] per (batch, chunk, head,
// N-tile, D-tile), every chunk but the first (no chunk reads its carry)
template <typename S>
__global__ void __launch_bounds__(NTH)
ssd_bwd_dual_local(const S* __restrict__ dy, const S* __restrict__ cm,
                   const float* __restrict__ acum, float* __restrict__ states,
                   int s_len, int n_heads, int d_len, int n_len, int nc) {
  __shared__ float ks[FTILE], vs[FTILE], w[L];
  const int d_tiles = (d_len + TILE - 1) / TILE;
  const int d0 = (blockIdx.x % d_tiles) * TILE;
  const int n0 = (blockIdx.x / d_tiles) * TILE;
  const int h = blockIdx.y, b = blockIdx.z / nc, ci = blockIdx.z % nc;
  if (ci == 0) return;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t row0 = (size_t)b * s_len + t0, xrow = (size_t)n_heads * d_len;
  const float* ac = acum + (((size_t)b * nc + ci) * n_heads + h) * L;
  if (threadIdx.x < L) w[threadIdx.x] = expf(ac[threadIdx.x]);
  __syncthreads();
  load_ftile(vs, dy + row0 * xrow + (size_t)h * d_len + d0, xrow, len,
             d_len - d0, w);
  load_ftile(ks, cm + row0 * n_len + n0, n_len, len, n_len - n0);
  __syncthreads();
  float acc[4][4] = {};
  fma_tile(acc, ks, 1, LDT, vs, LDT, 1);  // (n, d) += c[t][n] w_t dy[t][d]
  float* out = states + (((size_t)b * nc + ci) * n_heads + h) *
                            ((size_t)n_len * d_len);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx + 16 * j;
      if (n < n_len && d < d_len) out[(size_t)n * d_len + d] = acc[i][j];
    }
  }
}

// -- pass 4: M, dx and the da terms per (batch, chunk, head) -----------------

constexpr size_t kSmemDx = sizeof(float) * (5 * (size_t)FTILE + 3 * L);

template <typename S>
__global__ void __launch_bounds__(NTH)
ssd_bwd_dx(const S* __restrict__ x, const S* __restrict__ bm,
           const S* __restrict__ y, const S* __restrict__ dy,
           const float* __restrict__ cb, const float* __restrict__ acum,
           const float* __restrict__ gstates, S* __restrict__ dx,
           float* __restrict__ mout, float* __restrict__ qout, int s_len,
           int n_heads, int d_len, int n_len, int nc) {
  extern __shared__ float smem[];
  float* gs = smem;              // G [t][u]
  float* dys = gs + FTILE;        // dy [t][d]
  float* xs = dys + FTILE;        // x [u][d]
  float* bs = xs + FTILE;         // E_u b [u][n]
  float* rs = bs + FTILE;         // R_c [n][d]
  float* as = rs + FTILE;         // Acum
  float* ew = as + L;            // E = exp(A_tot - Acum)
  float* q = ew + L;             // dy . y - x . dx, summed over D
  const int h = blockIdx.x, b = blockIdx.y / nc, ci = blockIdx.y % nc;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t base = ((size_t)b * nc + ci) * n_heads + h;
  const size_t xrow = (size_t)n_heads * d_len;
  const size_t xoff = ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len;
  const S* bb = bm + ((size_t)b * s_len + t0) * n_len;
  const float* rc = gstates + base * n_len * d_len;
  if (tid < L) {
    as[tid] = acum[base * L + tid];
    ew[tid] = expf(acum[base * L + L - 1] - acum[base * L + tid]);
    q[tid] = 0.f;
  }
  __syncthreads();
  const float* cbc = cb + ((size_t)b * nc + ci) * L * L;
  for (int i = tid; i < L * L; i += NTH) {  // select, then decay
    const int t = i / L, u = i % L;
    gs[t * LDT + u] = u <= t ? cbc[i] * expf(as[t] - as[u]) : 0.f;
  }

  float m[4][4] = {};
  for (int d0 = 0; d0 < d_len; d0 += TILE) {
    const int dc = d_len - d0;
    load_ftile(dys, dy + xoff + d0, xrow, len, dc);
    load_ftile(xs, x + xoff + d0, xrow, len, dc);
    __syncthreads();
    fma_tile(m, dys, LDT, 1, xs, 1, LDT);  // M(t, u) += dy[t][d] x[u][d]
    float acc[4][4] = {};
    fma_tile(acc, gs, 1, LDT, dys, LDT, 1);  // dx(u, d) += G[t][u] dy[t][d]
    for (int n0 = 0; n0 < n_len; n0 += TILE) {
      load_ftile(bs, bb + n0, n_len, len, n_len - n0, ew);
      load_ftile(rs, rc + (size_t)n0 * d_len + d0, d_len, n_len - n0, dc);
      __syncthreads();
      fma_tile(acc, bs, LDT, 1, rs, LDT, 1);  // dx(u, d) += E_u b[u][n] R[n][d]
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = ty + 16 * i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = tx + 16 * j;
        if (u < len && d < dc) {
          const size_t at = xoff + (size_t)u * xrow + d0 + d;
          store(&dx[at], acc[i][j]);
          part += dys[u * LDT + d] * to_f32(y[at]) -
                  xs[u * LDT + d] * acc[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (tx == 0) q[u] += part;  // row u belongs to this (ty, i) alone
    }
    __syncthreads();  // dy and x are consumed before the next D-tile
  }
  float* mo = mout + base * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = ty + 16 * i, u = tx + 16 * j;
      mo[t * L + u] = u <= t ? m[i][j] * expf(as[t] - as[u]) : 0.f;
    }
  if (tid < L) qout[base * L + tid] = q[tid];
}

// -- pass 5: one head's db and dc per (batch, chunk, head, N-tile) -----------

constexpr size_t kSmemDbDc = sizeof(float) * (4 * (size_t)FTILE + 2 * L);

template <typename S>
__global__ void __launch_bounds__(NTH)
ssd_bwd_dbdc(const S* __restrict__ x, const S* __restrict__ bm,
             const S* __restrict__ cm, const S* __restrict__ dy,
             const float* __restrict__ acum, const float* __restrict__ hstates,
             const float* __restrict__ gstates, const float* __restrict__ mm,
             float* __restrict__ dbp, float* __restrict__ dcp, int s_len,
             int n_heads, int d_len, int n_len, int nc) {
  extern __shared__ float smem[];
  float* t0s = smem;            // M, then exp(Acum_t) dy [t][d]
  float* t1s = t0s + FTILE;      // b [u][n], then h_c [n][d]
  float* t2s = t1s + FTILE;      // c [t][n], then E_u x [u][d]
  float* t3s = t2s + FTILE;      // R_c [n][d]
  float* et = t3s + FTILE;       // exp(Acum)
  float* ew = et + L;           // E = exp(A_tot - Acum)
  const int n0 = blockIdx.x * TILE, h = blockIdx.y;
  const int b = blockIdx.z / nc, ci = blockIdx.z % nc;
  const int t0 = ci * L, len = min(L, s_len - t0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t base = ((size_t)b * nc + ci) * n_heads + h;
  const size_t xrow = (size_t)n_heads * d_len;
  const size_t xoff = ((size_t)b * s_len + t0) * xrow + (size_t)h * d_len;
  const size_t brow = ((size_t)b * s_len + t0) * n_len + n0;
  const size_t soff = base * n_len * d_len + (size_t)n0 * d_len;
  const int nn = n_len - n0;
  if (tid < L) {
    et[tid] = expf(acum[base * L + tid]);
    ew[tid] = expf(acum[base * L + L - 1] - acum[base * L + tid]);
  }
  load_ftile(t0s, mm + base * L * L, L, L, L);
  load_ftile(t1s, bm + brow, n_len, len, nn);
  load_ftile(t2s, cm + brow, n_len, len, nn);
  __syncthreads();
  float dc[4][4] = {}, db[4][4] = {};
  fma_tile(dc, t0s, LDT, 1, t1s, LDT, 1);  // dc(t, n) += M[t][u] b[u][n]
  fma_tile(db, t0s, 1, LDT, t2s, LDT, 1);  // db(u, n) += M[t][u] c[t][n]
  for (int d0 = 0; d0 < d_len; d0 += TILE) {
    const int dcols = d_len - d0;
    __syncthreads();  // the last tiles are consumed
    load_ftile(t0s, dy + xoff + d0, xrow, len, dcols, et);
    load_ftile(t1s, hstates + soff + d0, d_len, nn, dcols);
    load_ftile(t2s, x + xoff + d0, xrow, len, dcols, ew);
    load_ftile(t3s, gstates + soff + d0, d_len, nn, dcols);
    __syncthreads();
    fma_tile(dc, t0s, LDT, 1, t1s, 1, LDT);  // dc(t, n) += e_t dy[t][d] h[n][d]
    fma_tile(db, t2s, LDT, 1, t3s, 1, LDT);  // db(u, n) += E_u x[u][d] R[n][d]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t >= len) continue;
    const size_t row = (((size_t)b * s_len + t0 + t) * n_heads + h) * n_len;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < n_len) {
        dcp[row + n] = dc[i][j];
        dbp[row + n] = db[i][j];
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

template <typename S>
int launch(const S* x, const S* a, const S* b, const S* c, const S* y,
           const S* dy, S* dx, S* da, S* db, S* dc, float* scratch, int bsz,
           int s_len, int n_heads, int d_len, int n_len,
           cudaStream_t stream) {
  const int nc = (s_len + L - 1) / L;
  const size_t chunks = (size_t)bsz * nc;
  const size_t elems = (size_t)n_len * d_len;
  // C . B^T, Acum and h_c first, as the forward's scratch lays them out
  float* cb = scratch;                                   // [B, nc, L, L]
  float* acum = cb + chunks * L * L;                     // [B, nc, H, L]
  float* hs = acum + chunks * n_heads * L;               // [B, nc, H, N, D]
  float* gs = hs + chunks * n_heads * elems;             // [B, nc, H, N, D]
  float* mm = gs + chunks * n_heads * elems;             // [B, nc, H, L, L]
  float* q = mm + chunks * n_heads * L * L;              // [B, nc, H, L]
  float* dbp = q + chunks * n_heads * L;                 // [B, S, H, N]
  float* dcp = dbp + (size_t)bsz * s_len * n_heads * n_len;  // [B, S, H, N]
  const int d_tiles = (d_len + TILE - 1) / TILE;
  const int n_tiles = (n_len + TILE - 1) / TILE;
  cudaError_t err;
  if ((err = allow_smem(ssd_bwd_dx<S>, kSmemDx)) ||
      (err = allow_smem(ssd_bwd_dbdc<S>, kSmemDbDc)))
    return (int)err;

  // passes 1 to 3: the forward's kernels (csrc/ssd_chunk.cuh)
  if ((err = chunk_states(x, a, b, c, scratch, bsz, s_len, n_heads, d_len,
                          n_len, stream)))
    return (int)err;
  ssd_bwd_dual_local<S>
      <<<dim3(d_tiles * n_tiles, n_heads, (unsigned)chunks), NTH, 0,
         stream>>>(dy, c, acum, gs, s_len, n_heads, d_len, n_len, nc);
  if ((err = cudaGetLastError()) ||
      (err = pass_states<true>(acum, gs, bsz, n_heads, elems, nc, stream)))
    return (int)err;
  ssd_bwd_dx<S><<<dim3(n_heads, (unsigned)chunks), NTH, kSmemDx, stream>>>(
      x, b, y, dy, cb, acum, gs, dx, mm, q, s_len, n_heads, d_len, n_len, nc);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_bwd_dbdc<S><<<dim3(n_tiles, n_heads, (unsigned)chunks), NTH, kSmemDbDc,
                stream>>>(x, b, c, dy, acum, hs, gs, mm, dbp, dcp, s_len,
                          n_heads, d_len, n_len, nc);
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

// Floats of scratch the passes use: C . B^T, Acum, the forward's and the
// dual's chunk states, M, the da terms, then db's and dc's per-head parts.
long long scratch_need(int bsz, int s_len, int n_heads, int d_len,
                       int n_len) {
  const long long nc = (s_len + L - 1) / L, chunks = (long long)bsz * nc;
  return chunks * ((long long)L * L + 2LL * n_heads * L +
                   2LL * n_heads * n_len * d_len + (long long)n_heads * L * L) +
         2LL * bsz * s_len * n_heads * n_len;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for all of x, a, b, c, y, dy and the
// gradients dx, da, db, dc (contiguous, the shapes of x, a, b, c).  scratch:
// n_scratch floats, at least scratch_need(...) (the wrapper's
// bwd_scratch_floats), 16-byte aligned; its contents on entry are never
// read.  Returns cudaGetLastError() after the last launch (0 on success).
// Without a launch: -2 when H or B * ceil(S / 64) exceed a grid dimension
// (65535), and cudaErrorInvalidValue for an unsupported dtype or too small
// a scratch.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* a, const void* b,
                                  const void* c, const void* y,
                                  const void* dy, void* dx, void* da,
                                  void* db, void* dc, void* scratch,
                                  long long n_scratch, int dtype, int bsz,
                                  int s_len, int n_heads, int d_len,
                                  int n_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nc = (s_len + L - 1) / L;
  if (n_heads > 65535 || (long long)bsz * nc > 65535) return kGridTooLarge;
  if (n_scratch < scratch_need(bsz, s_len, n_heads, d_len, n_len) ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
#define REPRO_SSD_BWD(S)                                                     \
  launch<S>(static_cast<const S*>(x), static_cast<const S*>(a),              \
            static_cast<const S*>(b), static_cast<const S*>(c),              \
            static_cast<const S*>(y), static_cast<const S*>(dy),             \
            static_cast<S*>(dx), static_cast<S*>(da), static_cast<S*>(db),   \
            static_cast<S*>(dc), sc, bsz, s_len, n_heads, d_len, n_len, st)
  if (dtype == 0) return REPRO_SSD_BWD(float);
  if (dtype == 1) return REPRO_SSD_BWD(__nv_bfloat16);
#undef REPRO_SSD_BWD
  return (int)cudaErrorInvalidValue;
}
