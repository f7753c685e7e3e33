// Causal GQA flash attention (forward) for Hopper, sm_90a: three kernels,
// chosen by the wrapper (repro_torch/kernels/flash_attention.py::
// flash_path).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention_pallas).  Same function:
//   q [B, Hq, S, D], k/v [B, Hkv, T, D], contiguous, float32 or bfloat16;
//   query head h reads KV head h / (Hq / Hkv) -- K/V are never repeated;
//   causal mask aligned at the ends of the windows: key j is live for query
//   row i when j <= i + (T - S);
//   online softmax with float32 running max m, normalizer l and accumulator;
//   output in q's dtype, acc / l with l == 0 mapped to 1 as the reference does.
// Every kernel: one block per (64-row q tile, q head, batch) walks the KV
// axis in 64-key tiles itself (the loop takes the place of the TPU's
// sequential grid axis; on Hopper nothing carries over between blocks), and
// KV tiles wholly past the causal diagonal are never loaded.
//
// Bound.  4 D operations per live (query, key) pair: causal prefill at
// granite-8b's heads (Hq 32, Hkv 8, D 128) and S = T = 1024 is ~8.6 GFLOP
// against ~21 MB of q, k, v and o in bfloat16 (~42 MB in float32), far
// above every ridge: bound by operations, 0.0087 ms at the 989 TFLOP/s
// bfloat16 tensor-core peak, 0.052 ms for float32 in 3xTF32 (three TF32
// products each, at 495 / 3 = 165 TFLOP/s), 0.128 ms at the 67 TFLOP/s
// float32 FMA peak.
//
// bfloat16 (flash_wgmma_bf16; q, k, v 16-byte aligned): the tensor cores.
// A block is one consumer warpgroup (the 64 query rows) and one producer
// warp.  The producer loads the q tile once and keeps a 2-stage ring of
// [64 x D] K and V tiles full (3 stages at D = 80), all by TMA (128-byte
// swizzle, 64-byte at D = 32; D = 128 as two 64-column boxes, D = 80 as a
// 64-column box and a 16-column one with the 32-byte swizzle, from a map
// of its own: hopper.cuh's Bf16Tile) from 3-D maps [B Hq, S, D] and
// [B Hkv, T, D], so a box past S or T is zero-filled, never read from the
// next head; mbarriers guard each stage (TMA bytes in, one arrival per
// consumer warp out).  S = Q K^T is wgmma m64n64k16 with both operands
// K-major in shared memory; the softmax runs on the float32 accumulator
// fragments in registers (a thread holds 2 rows x 16 scores; row max by
// two shuffles in its quad, the row sum kept per thread and reduced once
// at the end), in base 2 with the scale folded into one FMA.  P is
// rounded to bfloat16 in registers, where the accumulator layout is
// already wgmma's register-A layout, and O += P V is wgmma m64nDk16 with V
// read N-major through the transpose bit.  Only tiles that cross the
// diagonal or the end of T are masked.  Heavy q tiles (the causal rows
// that see most keys) are scheduled first.  At D = 80 the P V product is
// an m64n64k16 on the 64-column box and an m64n16k16 on the 16-column one
// a k-step, and S of the next KV tile is issued before P V of this one,
// so the tensor cores compute it while the threads run this tile's
// softmax (D 32, 64 and 128 run S, softmax, P V in turn).  The reference
// computes P V in float32 from float32 P; rounding P to bfloat16 adds at
// most 2^-9 |v| a key (relative), inside the 2e-2 (1 + |o|) of the
// bfloat16 tolerance; l sums the float32 p.
//
// float32 (flash_tf32x3; q, k, v 16-byte aligned): the tensor cores in
// 3xTF32, mma.sync m16n8k8.  Each float32 operand is a TF32 pair: the high
// part is the value itself (the tensor cores read a TF32 operand's top 19
// bits, i.e. truncate it), the low part the value minus that truncation
// (exact; truncated in turn), and a_lo b_hi + a_hi b_lo + a_hi b_hi are
// summed in float32 (the low parts' product is below float32's rounding),
// which keeps float32's accuracy (one TF32 product keeps ~3 digits; the
// reference asks 2e-4).  A block is 4 warps, each owning 16 query rows
// across the whole 64-key tile; lane 4 g + c holds rows g and g + 8.  K
// and V come through shared memory by 16-byte cp.async, zero-filled past
// T, one buffer each: V of a tile loads while S = Q K^T is computed and
// the next K while O += P V is, so a block's loads overlap its arithmetic;
// 2 (D = 128) or 3 blocks share an SM (D = 80: 5 16-column blocks of O,
// 10 k-steps of Q K^T).  Every operand fragment comes from
// shared memory as a float4 or two float2s that land in the registers the
// mma wants (the contraction orders and O's columns are free, and chosen
// so), with no register moves and no bank conflicts:
//   Q, scaled by scale log2(e) (scores in base 2, for either sign of the
//   scale), is stored once in fragment order, a quad a (k-step, lane);
//   QK^T's k-steps 2t and 2t + 1 give lane c the columns 16 t + 4 c .. + 3,
//   so K's B fragments are the halves of one float4 a row (rows padded to
//   16 floats mod 32: 80 floats at D = 80 need no padding);
//   O is accumulated transposed, O^T += V^T P^T, with key 2 c, 2 c + 1 as
//   k = c, c + 4: P^T's B fragments are then the score fragments as they
//   stand (no shuffles, no shared staging), and V^T's A fragment is V's
//   rows 2 c and 2 c + 1 at columns 2 g, 2 g + 1 of a 16-column block
//   (rows padded to 4 floats mod 16; O's column order inside the block
//   follows).
// The softmax runs on the score fragments in registers as in the wgmma
// kernel (row max by two quad shuffles, the sums per lane, only tiles
// across the diagonal or the end of T masked); O^T's rescale takes each q
// row's factor from the lanes that hold the row.  The q tile is the grid's
// slowest axis, heaviest first.
//
// bfloat16 off a 16-byte boundary, and float32 off one (flash_fwd):
// float32 FMAs on the CUDA cores.  256 threads; thread (ty, tx) = (tid / 16,
// tid % 16) owns score rows ty + 16 i and columns tx + 16 j (i, j < 4) and
// output columns tx + 16 c; the 16 threads of a row group sit in one
// half-warp, so the row max and sum are shuffle reductions.  Tiles are
// float32 in shared memory with padded rows (D + 4) so the float4 reads of
// the QK^T loop are free of bank conflicts; K/V tiles load synchronously
// between two barriers.  At D = 128 the tiles take 116 KiB: one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"


namespace {

using namespace hopper;

// -- float32, and bfloat16 off a 16-byte boundary: FMA on the CUDA cores ---

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
    case 80:
      return launch<T, 80>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


// -- float32 on 16-byte boundaries: 3xTF32 mma.sync -------------------------

namespace x3 {

constexpr int NW = 4;            // warps a block, 16 q rows each
constexpr int BQ = 16 * NW;
constexpr int BKV = 64;
constexpr int NG = BKV / 8;      // groups of 8 keys a KV tile
constexpr int NTH = 32 * NW;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  // the least row stride >= D that is 16 (mod 32) floats: K's float4s
  static constexpr int LDK = D + (48 - D % 32) % 32;
  static constexpr int LDV = D + 4;   // = 4 (mod 16): V's float2s
  static constexpr int QF = BQ * D;   // Q in fragment order
  static constexpr int SMEM = (int)sizeof(float) * (QF + BKV * (LDK + LDV));
  static constexpr int MIN_BLOCKS = D == 128 ? 2 : 3;  // registers allow
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

// [BKV x D] rows k0 .. of src (row stride D) into dst (row stride ld) by
// 16-byte cp.async, rows at or past t_len zero-filled; one commit group
template <int D>
__device__ __forceinline__ void load_kv(float* dst, int ld,
                                        const float* __restrict__ src, int k0,
                                        int t_len) {
#pragma unroll 4
  for (int i = threadIdx.x; i < BKV * (D / 4); i += NTH) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool in = k0 + r < t_len;
    cp_async16(dst + r * ld + c, in ? src + (size_t)(k0 + r) * D + c : src,
               in ? 16 : 0);
  }
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(NTH, Tile<D>::MIN_BLOCKS)
    flash_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int hkv, int s_len, int t_len, int causal, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float4* qf = reinterpret_cast<float4*>(smem);  // [NW][D / 8][32] quads
  float* ks = smem + T::QF;                       // [BKV][LDK]
  float* vs = ks + BKV * T::LDK;                  // [BKV][LDV]

  // the q tile is the slowest grid axis, heaviest first: every head's
  // longest causal rows start in the first wave, the short ones form the tail
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int offset = t_len - s_len;
  const float* kb = k + (size_t)(b * hkv + h / (hq / hkv)) * t_len * D;
  const float* vb = v + (size_t)(b * hkv + h / (hq / hkv)) * t_len * D;
  int n_kv = (t_len + BKV - 1) / BKV;
  if (causal) {
    // the last live query row of this tile sees keys up to this position
    const int last = min(q0 + BQ, s_len) - 1 + offset;
    n_kv = min(n_kv, last / BKV + 1);
  }
  load_kv<D>(ks, T::LDK, kb, 0, t_len);
  load_kv<D>(vs, T::LDV, vb, 0, t_len);

  // Lane 4 g + c of warp w holds q rows r_lo = q0 + 16 w + g and r_lo + 8.
  // QK^T contracts over d in any order: k-steps 2t and 2t + 1 give lane c
  // the columns 16 t + 4 c .. + 3 (k = c, c + 4 of step 2t, then of step
  // 2t + 1), so K's B fragments are halves of one float4 a row.  Q, scaled
  // by scale log2(e) (scores in base 2, for either sign of the scale), is
  // stored once in fragment order, (row g, row g + 8) x (k = c, c + 4) a
  // quad, each lane its own: one float4 read is a k-step's A fragment.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int r_lo = q0 + 16 * warp + g;
  float4* qw = qf + warp * (D / 8) * 32 + lane;
  {
    const float sl2 = scale * LOG2E;
    const float* qr = q + ((size_t)(b * hq + h) * s_len + r_lo) * D + 4 * c;
    const bool in0 = r_lo < s_len, in1 = r_lo + 8 < s_len;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int t = 0; t < D / 16; ++t) {
      const float4 x = in0 ? *reinterpret_cast<const float4*>(qr + 16 * t)
                           : zero;
      const float4 y =
          in1 ? *reinterpret_cast<const float4*>(qr + 8 * D + 16 * t) : zero;
      qw[(2 * t) * 32] =
          make_float4(x.x * sl2, y.x * sl2, x.y * sl2, y.y * sl2);
      qw[(2 * t + 1) * 32] =
          make_float4(x.z * sl2, y.z * sl2, x.w * sl2, y.w * sl2);
    }
  }

  // O is accumulated transposed, O^T += V^T P^T, so that P's score
  // fragments are B fragments as they stand.  m-tile mt covers 16 columns
  // of O, its row r being column 16 mt + 2 (r % 8) + r / 8 (V's A
  // fragment is then two float2s); n-tile nt covers q rows r_lo - g + 8 nt
  // ...  Lane (g, c) holds columns 16 mt + 2 g (fragments 0, 1) and
  // + 1 (2, 3) of q rows 8 nt + 2 c (0, 2) and + 1 (1, 3) of the warp's 16.
  float acc[D / 16][2][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's share of their sums

  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * BKV;
    cp_async_wait<1>();  // K of this tile is in (its V may still load)
    __syncthreads();

    // S = Q K^T: score fragment n holds keys k0 + 8 n + 2 c (+1), rows g
    // (s[n][0..1]) and g + 8 (s[n][2..3])
    float s[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll 2
    for (int t = 0; t < D / 16; ++t) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const float4 x = qw[(2 * t + st) * 32];
        const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ahi[st][i] = hi_tf32(e[i]);
          alo[st][i] = lo_tf32(e[i]);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(
            &ks[(8 * n + g) * T::LDK + 16 * t + 4 * c]);
        const uint32_t bhi[2][2] = {{hi_tf32(x.x), hi_tf32(x.y)},
                                    {hi_tf32(x.z), hi_tf32(x.w)}};
        const uint32_t blo[2][2] = {{lo_tf32(x.x), lo_tf32(x.y)},
                                    {lo_tf32(x.z), lo_tf32(x.w)}};
        mma3(s[n], ahi[0], alo[0], bhi[0], blo[0]);
        mma3(s[n], ahi[1], alo[1], bhi[1], blo[1]);
      }
    }
    __syncthreads();  // every warp has read K: load the next tile's
    if (jt + 1 < n_kv)
      load_kv<D>(ks, T::LDK, kb, k0 + BKV, t_len);
    else
      cp_async_commit();

    if (k0 + BKV > t_len || (causal && k0 + BKV - 1 > q0 + offset)) {
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + 8 * n + 2 * c + i % 2;
          const int qp = r_lo + 8 * (i / 2) + offset;
          if (kp >= t_len || (causal && kp > qp)) s[n][i] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no live key yet keeps p = 0 and alpha = 0 (no inf - inf)
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2_approx(m0 - mu0), al1 = exp2_approx(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      s[n][0] = exp2_approx(s[n][0] - mu0);
      s[n][1] = exp2_approx(s[n][1] - mu0);
      s[n][2] = exp2_approx(s[n][2] - mu1);
      s[n][3] = exp2_approx(s[n][3] - mu1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
    // O^T's columns are q rows 2 c, 2 c + 1 (+ 8): their rescales come
    // from the lanes that hold those rows (g = 2 c, 2 c + 1)
    const float ae0 = __shfl_sync(0xffffffffu, al0, 8 * c);
    const float ao0 = __shfl_sync(0xffffffffu, al0, 8 * c + 4);
    const float ae1 = __shfl_sync(0xffffffffu, al1, 8 * c);
    const float ao1 = __shfl_sync(0xffffffffu, al1, 8 * c + 4);
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      acc[mt][0][0] *= ae0;
      acc[mt][0][2] *= ae0;
      acc[mt][0][1] *= ao0;
      acc[mt][0][3] *= ao0;
      acc[mt][1][0] *= ae1;
      acc[mt][1][2] *= ae1;
      acc[mt][1][1] *= ao1;
      acc[mt][1][3] *= ao1;
    }

    cp_async_wait<1>();  // V of this tile is in (the next K may still load)
    __syncthreads();
    // O^T += V^T P^T.  k-step n contracts keys k0 + 8 n ..; taking k = c,
    // c + 4 as keys 2 c, 2 c + 1 makes P^T's B fragment of n-tile nt the
    // score pair s[n][2 nt ..] and V^T's A fragment the float2s of V's
    // rows 2 c and 2 c + 1 at column 16 mt + 2 g
#pragma unroll
    for (int n = 0; n < NG; ++n) {
      const uint32_t bhi[2][2] = {{hi_tf32(s[n][0]), hi_tf32(s[n][1])},
                                  {hi_tf32(s[n][2]), hi_tf32(s[n][3])}};
      const uint32_t blo[2][2] = {{lo_tf32(s[n][0]), lo_tf32(s[n][1])},
                                  {lo_tf32(s[n][2]), lo_tf32(s[n][3])}};
      const float* vr = vs + (8 * n + 2 * c) * T::LDV + 2 * g;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        const float2 x = *reinterpret_cast<const float2*>(vr + 16 * mt);
        const float2 y =
            *reinterpret_cast<const float2*>(vr + T::LDV + 16 * mt);
        const uint32_t ahi[4] = {hi_tf32(x.x), hi_tf32(x.y), hi_tf32(y.x),
                                 hi_tf32(y.y)};
        const uint32_t alo[4] = {lo_tf32(x.x), lo_tf32(x.y), lo_tf32(y.x),
                                 lo_tf32(y.y)};
        mma3(acc[mt][0], ahi, alo, bhi[0], blo[0]);
        mma3(acc[mt][1], ahi, alo, bhi[1], blo[1]);
      }
    }
    __syncthreads();  // every warp has read V: load the next tile's
    if (jt + 1 < n_kv)
      load_kv<D>(vs, T::LDV, vb, k0 + BKV, t_len);
    else
      cp_async_commit();
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  const float inv[2][2] = {
      {__shfl_sync(0xffffffffu, inv0, 8 * c),
       __shfl_sync(0xffffffffu, inv0, 8 * c + 4)},
      {__shfl_sync(0xffffffffu, inv1, 8 * c),
       __shfl_sync(0xffffffffu, inv1, 8 * c + 4)}};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + 16 * warp + 8 * nt + 2 * c + e;
      if (row >= s_len) continue;
      float* orow = o + ((size_t)(b * hq + h) * s_len + row) * D + 2 * g;
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt)
        *reinterpret_cast<float2*>(orow + 16 * mt) =
            make_float2(acc[mt][nt][e] * inv[nt][e],
                        acc[mt][nt][2 + e] * inv[nt][e]);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s_len, int t_len, int causal, float scale,
           cudaStream_t stream) {
  using T = Tile<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tf32x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (s_len + BQ - 1) / BQ;
  if (b > 65535 || n_q > 65535) return (int)cudaErrorInvalidValue;
  flash_tf32x3<D><<<dim3(hq, b, n_q), NTH, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, s_len,
      t_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace x3


// -- bfloat16: TMA + wgmma ----------------------------------------------------

namespace fa {

constexpr int BQ = 64, BKV = 64;
constexpr int NTH = 160;               // a consumer warpgroup + a producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile : Bf16Tile<D> {
  // D 80: a 3-stage K/V ring, and S = Q K^T of the next tile issued ahead
  // of this tile's P V, so that the tensor cores compute S while the
  // threads run the softmax.  D 32, 64 and 128: 2 stages, in turn.
  static constexpr int STAGES = D == 80 ? 3 : 2;
  static constexpr bool OVERLAP = D == 80;
  // q, STAGES x (k, v), 1 + 2 STAGES mbarriers
  static constexpr int SMEM =
      1024 + (1 + 2 * STAGES) * Bf16Tile<D>::BYTES + (1 + 2 * STAGES) * 8;
};

// The online softmax of one 64 x 64 tile of scores sc at keys k0 (masked
// past T and, under the causal mask, past each row's diagonal, where the
// tile crosses either), in place: sc becomes P, in float32; the running max
// m, the rescale factors al of acc and l, and l itself move on (the
// accumulator layout: rows r_lo + 8 ((i / 2) % 2), keys k0 + 8 (i / 4) +
// 2 l4 + i % 2).  pack() rounds P to bfloat16 A fragments.  The D-80
// overlapped loop's; the in-turn loop of D 32, 64 and 128 does the same
// arithmetic inline, packing P as it goes, and so compiles as it did:
// calling this helper there, in place or packing as it goes, moved their
// registers by 1 to 6 (PERF.md, section 6).
struct Softmax {
  int q0, r_lo, l4, t_len, offset, causal;
  float sl2;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, base-2 units
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

  __device__ __forceinline__ void tile(float (&sc)[32], int k0, float& al0,
                                       float& al1) {
    if (k0 + BKV > t_len || (causal && k0 + BKV - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * l4 + i % 2;
        const int qp = q0 + r_lo + 8 * ((i / 2) % 2) + offset;
        if (kp >= t_len || (causal && kp > qp)) sc[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i / 2) % 2)
        mx1 = fmaxf(mx1, sc[i]);
      else
        mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    // a row with no live key yet keeps p = 0 and alpha = 0 (no inf - inf)
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    al0 = exp2f(m0 - mu0);
    al1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i / 2) % 2;        // row r_lo + 8 hi
      const float mu = hi ? mu1 : mu0;
      sc[i] = exp2f(fmaf(sc[i], sl2, -mu));
      sc[i + 1] = exp2f(fmaf(sc[i + 1], sl2, -mu));
      if (hi)
        ps1 += sc[i] + sc[i + 1];
      else
        ps0 += sc[i] + sc[i + 1];
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
  }

  // acc, in the same layout, times each row's factor
  template <int N>
  static __device__ __forceinline__ void rescale(float (&acc)[N], float al0,
                                                 float al1) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= (i / 2) % 2 ? al1 : al0;
  }

  static __device__ __forceinline__ void pack(const float (&p)[32],
                                              uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        __nv_bfloat162 pr = __floats2bfloat162_rn(p[i], p[i + 1]);
        pa[kk][j] = *reinterpret_cast<uint32_t*>(&pr);
      }
  }
};

template <int D>
__global__ void __launch_bounds__(NTH)
    flash_wgmma_bf16(const __grid_constant__ Bf16Maps<D> map_q,
                     const __grid_constant__ Bf16Maps<D> map_k,
                     const __grid_constant__ Bf16Maps<D> map_v,
                     __nv_bfloat16* __restrict__ o, int hq, int hkv,
                     int s_len, int t_len, int causal, float scale) {
  using T = Tile<D>;
  constexpr int NS = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1k(smem_raw);
  uint8_t* kv = qs + T::BYTES;         // stage s: K at kv + 2 s BYTES, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + 2 * NS * T::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int offset = t_len - s_len;
  int n_kv = (t_len + BKV - 1) / BKV;
  if (causal) {
    // the last live query row of this tile sees keys up to this position
    const int last = min(q0 + BQ, s_len) - 1 + offset;
    n_kv = min(n_kv, last / BKV + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);         // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {            // the producer warp
    if (threadIdx.x == 128) {
      const int q_row = b * hq + h, kv_row = b * hkv + h / (hq / hkv);
      mbar_expect_tx(q_full, T::BYTES);
      tma_load_tile<D>(qs, &map_q, q_full, q0, q_row);
      for (int jt = 0; jt < n_kv; ++jt) {
        const int s = ring_stage<NS>(jt);
        if (jt >= NS) mbar_wait(&empty[s], ring_parity<NS>(jt - NS));
        uint8_t* ks = kv + 2 * s * T::BYTES;
        mbar_expect_tx(&full[s], 2 * T::BYTES);
        tma_load_tile<D>(ks, &map_k, &full[s], jt * BKV, kv_row);
        tma_load_tile<D>(ks + T::BYTES, &map_v, &full[s], jt * BKV, kv_row);
      }
    }
    return;
  }

  // the consumer warpgroup: thread t holds rows r_lo and r_lo + 8 of the
  // tile (the accumulator layout in hopper.cuh)
  const int t = threadIdx.x, l4 = (t % 32) % 4;
  const int r_lo = 16 * (t / 32) + (t % 32) / 4;
  const float sl2 = scale * LOG2E;
  float acc[D / 2], sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, base-2 units
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  const uint32_t q_addr = smem_u32(qs);
  mbar_wait(q_full, 0);

  // D 32, 64 and 128: S, the softmax and P V in turn
  if constexpr (!T::OVERLAP) {
    for (int jt = 0; jt < n_kv; ++jt) {
      const int s = ring_stage<NS>(jt);
      mbar_wait(&full[s], ring_parity<NS>(jt));
      const uint32_t k_addr = smem_u32(kv + 2 * s * T::BYTES);
      const uint32_t v_addr = k_addr + T::BYTES;

      wgmma_fence();
      wgmma_tile_nt<D>(sc, q_addr, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);

      const int k0 = jt * BKV;
      if (k0 + BKV > t_len || (causal && k0 + BKV - 1 > q0 + offset)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kp = k0 + 8 * (i / 4) + 2 * l4 + i % 2;
          const int qp = q0 + r_lo + 8 * ((i / 2) % 2) + offset;
          if (kp >= t_len || (causal && kp > qp)) sc[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if ((i / 2) % 2)
          mx1 = fmaxf(mx1, sc[i]);
        else
          mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
      // a row with no live key yet keeps p = 0 and alpha = 0 (no inf - inf)
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;    // rows r_lo + 8 (j % 2)
          const float mu = j % 2 ? mu1 : mu0;
          const float p0 = exp2f(fmaf(sc[i], sl2, -mu));
          const float p1 = exp2f(fmaf(sc[i + 1], sl2, -mu));
          if (j % 2)
            ps1 += p0 + p1;
          else
            ps0 += p0 + p1;
          __nv_bfloat162 pr = __floats2bfloat162_rn(p0, p1);
          pa[kk][j] = *reinterpret_cast<uint32_t*>(&pr);
        }
      l0 = al0 * l0 + ps0;
      l1 = al1 * l1 + ps1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i / 2) % 2 ? al1 : al0;

      wgmma_fence();
      wgmma_tile_rs<D>(acc, pa, v_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      keep_fragments(pa);   // the wgmma read P from these registers until now
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(&empty[s]);
    }
  } else if (n_kv > 0) {
    // S of tile jt + 1 is issued ahead of P V of tile jt, and its softmax
    // runs (in place, in float32) while P V does; once P V has landed, acc
    // is rescaled and the new P rounded into pa, which P V read until then
    // (a P written to pa while P V runs would make ptxas serialize the
    // wgmmas, C7513).  The last tile is peeled off, so that no wgmma is
    // issued under a branch.
    Softmax sm{q0, r_lo, l4, t_len, offset, causal, sl2};
    uint32_t pa[4][4];
    float al0, al1;
    mbar_wait(&full[0], 0);
    wgmma_fence();
    wgmma_tile_nt<D>(sc, q_addr, smem_u32(kv));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    sm.tile(sc, 0, al0, al1);          // acc is 0: no rescale
    Softmax::pack(sc, pa);
    for (int jt = 0; jt < n_kv - 1; ++jt) {
      const int s = ring_stage<NS>(jt), sn = ring_stage<NS>(jt + 1);
      mbar_wait(&full[sn], ring_parity<NS>(jt + 1));
      wgmma_fence();
      wgmma_tile_nt<D>(sc, q_addr, smem_u32(kv + 2 * sn * T::BYTES));
      wgmma_commit();
      wgmma_tile_rs<D>(acc, pa, smem_u32(kv + (2 * s + 1) * T::BYTES));
      wgmma_commit();
      wgmma_wait<1>();                 // S of tile jt + 1; P V runs on
      fence_operands(sc);
      sm.tile(sc, (jt + 1) * BKV, al0, al1);
      wgmma_wait<0>();
      fence_operands(acc);
      keep_fragments(pa);
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(&empty[s]);
      Softmax::rescale(acc, al0, al1);
      Softmax::pack(sc, pa);
    }
    const int s = ring_stage<NS>(n_kv - 1);
    wgmma_fence();
    wgmma_tile_rs<D>(acc, pa, smem_u32(kv + (2 * s + 1) * T::BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    keep_fragments(pa);
    l0 = sm.l0;
    l1 = sm.l1;
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 1.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 1.f;
  __nv_bfloat16* ob = o + (size_t)(b * hq + h) * s_len * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hi = (i / 2) % 2;
    const int row = q0 + r_lo + 8 * hi;
    const int col = 8 * (i / 4) + 2 * l4;
    const float inv = hi ? inv1 : inv0;
    if (row < s_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + col) =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int s_len, int t_len, int causal, float scale,
           cudaStream_t stream) {
  using T = Tile<D>;
  Bf16Maps<D> map_q, map_k, map_v;
  int err = bf16_tile_map<D>(&map_q, q, s_len, b * hq);
  if (!err) err = bf16_tile_map<D>(&map_k, k, t_len, b * hkv);
  if (!err) err = bf16_tile_map<D>(&map_v, v, t_len, b * hkv);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s_len + BQ - 1) / BQ, hq, b);
  flash_wgmma_bf16<D><<<grid, NTH, T::SMEM, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), hq, hkv, s_len,
      t_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace fa

}  // namespace

// bfloat16 on the tensor cores; q, k, v and o 16-byte aligned (the wrapper
// checks).  Returns 0 or a CUDA error code; a head size other than 32, 64,
// 80 or 128 gives cudaErrorInvalidValue without a launch.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o, int b,
                                           int hq, int hkv, int s_len,
                                           int t_len, int d, int causal,
                                           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return fa::launch<32>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, st);
    case 64:
      return fa::launch<64>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, st);
    case 80:
      return fa::launch<80>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, st);
    case 128:
      return fa::launch<128>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                             scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// float32 in 3xTF32 on the tensor cores; q, k, v and o 16-byte aligned (the
// wrapper checks).  Returns 0 or a CUDA error code; a head size other than
// 32, 64, 80 or 128, or more than 65535 batches or q tiles, gives
// cudaErrorInvalidValue without a launch.
extern "C" int repro_flash_attention_tf32x3(const void* q, const void* k,
                                            const void* v, void* o, int b,
                                            int hq, int hkv, int s_len,
                                            int t_len, int d, int causal,
                                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return x3::launch<32>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, st);
    case 64:
      return x3::launch<64>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, st);
    case 80:
      return x3::launch<80>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                            scale, st);
    case 128:
      return x3::launch<128>(q, k, v, o, b, hq, hkv, s_len, t_len, causal,
                             scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The FMA kernel, float32 or bfloat16.
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
