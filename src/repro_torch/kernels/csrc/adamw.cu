// AdamW's update and its gradient norm, one pass over each leaf, for
// Hopper, sm_90a.
//
// Replaces no TPU kernel.  The reference runs its update
// (src/repro/optim/adamw.py:62 apply_updates) inside its jitted train step
// (src/repro/train/trainer.py:56), where XLA fuses it into a few passes
// over each leaf.  The port ran the same arithmetic eagerly, about 23
// full-size kernels a leaf and ~214 bytes a parameter moved; these kernels
// are the counterpart of the fused update (kernels/adamw.py wraps them;
// optim/adamw.py calls them).
//
// Function, per leaf, with lr, scale (the clip factor), b1c and b2c the
// 0-d float32 device tensors the eager code computes and b1, 1 - b1, b2,
// 1 - b2, eps and wd Python doubles rounded once to float32, as PyTorch's
// CUDA mul and add round a wrapped scalar:
//   gs = g * scale                     (g widened to float32)
//   m  = b1 * m + (1 - b1) * gs
//   v  = b2 * v + ((1 - b2) * gs) * gs
//   w  = w - lr * ((m / b1c) / (sqrt(v / b2c) + eps) + wd * w)
//   p  = w rounded to nearest even     (a bfloat16 or separate param)
// Each product, sum, quotient and root rounded once, in that order
// (__fmul_rn and friends: nvcc would contract a*b + c into an FMA, which
// the eager ops do not), the quotients divided (PyTorch divides by a 0-d
// CUDA tensor; it multiplies by a reciprocal only for a CPU scalar) and
// the root correctly rounded: given the same scalars the update is bit
// for bit the eager one.  Within a leaf m, v and w are read and written by
// the same thread; the update has no atomics and no order.
//
// The norm: each leaf's sum of g's squares (g widened to float32, squared
// and summed in float64: a float32 square is exact in float64, so each
// term is exact and the sum keeps ~2^-53 of each; a float32 sum of 10^8
// terms would keep ~2^-24 at best), in kNormBlocks partial sums a leaf
// from a fixed grid, each block's threads adding fixed 8-element chunks in
// a fixed order and the block summing them in a fixed tree; then one block
// sums every leaf's partials in leaf order and writes the float32 root to
// a 0-d device tensor.  No atomics and no grid sized to the card, so the
// result depends on the gradients alone, and nothing syncs with the host.
//
// Bound.  Bytes: per parameter g read twice (the norm, then the update),
// m, v and the float32 weight read and written, the param written where it
// is not the weight: 30 bytes for a bfloat16 param with a float32 master
// copy, 32 for a float32 one, at 3.35 TB/s.  ~10 float32 operations a
// parameter (3 divisions and a root among them) are far below the ridge.
//
// Design.  A grid-stride loop over 8-element chunks: where every pointer
// of the leaf sits on a 16-byte boundary, a chunk moves as 16-byte vector
// loads and stores (2 for each float32 array, 1 for a bfloat16 one); a
// ragged last chunk, or a leaf with a pointer off 16 bytes, goes element
// by element in the same chunks, so the norm's sum order is the same
// either way.  Each thread keeps 4 x 8 values in flight a step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads a block, every kernel
constexpr int kVec = 8;                // elements a chunk
constexpr int kNormBlocks = 1024;      // partial sums a leaf (fixed)
constexpr int kMaxUpdateBlocks = 4096;

struct Consts {                        // the Python scalars, as float32
  float b1, c1, b2, c2, eps, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// one element of the update, in the eager ops' order and rounding
__device__ __forceinline__ void step(float g, float& m, float& v, float& w,
                                     float lr, float scale, float b1c,
                                     float b2c, const Consts& c) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.c1, gs));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.c2, gs), gs));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps);
  const float upd = __fdiv_rn(__fdiv_rn(m, b1c), den);
  w = __fsub_rn(w, __fmul_rn(lr, __fadd_rn(upd, __fmul_rn(c.wd, w))));
}

// G: the gradient's type; P: the param's, written only where WRITE_P (the
// param is not the float32 weight w itself)
template <typename G, typename P, bool WRITE_P>
__global__ void __launch_bounds__(kThreads)
    adamw_update(P* __restrict__ p, float* __restrict__ w,
                 const G* __restrict__ g, float* __restrict__ m,
                 float* __restrict__ v, long long n, bool vec,
                 const float* lr_p, const float* scale_p,
                 const float* b1c_p, const float* b2c_p, Consts c) {
  const float lr = *lr_p, scale = *scale_p, b1c = *b1c_p, b2c = *b2c_p;
  const long long chunks = (n + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
       ch < chunks; ch += stride) {
    const long long e = ch * kVec;
    if (vec && e + kVec <= n) {
      float gg[kVec], mm[kVec], vv[kVec], ww[kVec];
      load8(g + e, gg);
      load8(m + e, mm);
      load8(v + e, vv);
      load8(w + e, ww);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        step(gg[k], mm[k], vv[k], ww[k], lr, scale, b1c, b2c, c);
      store8(m + e, mm);
      store8(v + e, vv);
      store8(w + e, ww);
      if constexpr (WRITE_P) store8(p + e, ww);
    } else {
      const long long end = e + kVec < n ? e + kVec : n;
      for (long long i = e; i < end; ++i) {
        float mm = m[i], vv = v[i], ww = w[i];
        step(to_f32(g[i]), mm, vv, ww, lr, scale, b1c, b2c, c);
        m[i] = mm;
        v[i] = vv;
        w[i] = ww;
        if constexpr (WRITE_P) store1(p + i, ww);
      }
    }
  }
}

// the block's sum of one double a thread, in a fixed tree; thread 0 has it
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
  }
  __syncthreads();                      // warp_sums free for a next call
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_norm_partials(const G* __restrict__ g, long long n, bool vec,
                        double* __restrict__ partial) {
  const long long chunks = (n + kVec - 1) / kVec;
  const long long stride = (long long)kNormBlocks * kThreads;
  double acc = 0.0;
  for (long long ch = (long long)blockIdx.x * kThreads + threadIdx.x;
       ch < chunks; ch += stride) {
    const long long e = ch * kVec;
    float x[kVec];
    int len = kVec;
    if (vec && e + kVec <= n) {
      load8(g + e, x);
    } else {
      len = (int)(n - e < kVec ? n - e : kVec);
      for (int k = 0; k < len; ++k) x[k] = to_f32(g[e + k]);
    }
    for (int k = 0; k < len; ++k) {
      const double d = (double)x[k];
      acc = __fma_rn(d, d, acc);        // d * d is exact in float64
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
    adamw_norm_finalize(const double* __restrict__ partials, int n_leaves,
                        float* __restrict__ out) {
  double total = 0.0;                   // thread 0's, in leaf order
  for (int leaf = 0; leaf < n_leaves; ++leaf) {
    const double* part = partials + (long long)leaf * kNormBlocks;
    double x = 0.0;
    for (int i = threadIdx.x; i < kNormBlocks; i += kThreads) x += part[i];
    x = block_sum(x);
    if (threadIdx.x == 0) total += x;
  }
  if (threadIdx.x == 0) *out = (float)sqrt(total);
}

bool on16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename G, typename P, bool WRITE_P>
void launch_update(void* p, void* w, const void* g, void* m, void* v,
                   long long n, const void* lr, const void* scale,
                   const void* b1c, const void* b2c, const Consts& c,
                   cudaStream_t stream) {
  const bool vec = on16(w) && on16(g) && on16(m) && on16(v) &&
                   (!WRITE_P || on16(p));
  const long long chunks = (n + kVec - 1) / kVec;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > kMaxUpdateBlocks) blocks = kMaxUpdateBlocks;
  adamw_update<G, P, WRITE_P><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<float*>(w), static_cast<const G*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, vec,
      static_cast<const float*>(lr), static_cast<const float*>(scale),
      static_cast<const float*>(b1c), static_cast<const float*>(b2c), c);
}

template <typename G>
void launch_update_g(int p_dtype, void* p, void* w, const void* g, void* m,
                     void* v, long long n, const void* lr, const void* scale,
                     const void* b1c, const void* b2c, const Consts& c,
                     cudaStream_t stream) {
  if (p_dtype < 0)
    launch_update<G, float, false>(p, w, g, m, v, n, lr, scale, b1c, b2c, c,
                                   stream);
  else if (p_dtype == 0)
    launch_update<G, float, true>(p, w, g, m, v, n, lr, scale, b1c, b2c, c,
                                  stream);
  else
    launch_update<G, __nv_bfloat16, true>(p, w, g, m, v, n, lr, scale, b1c,
                                          b2c, c, stream);
}

}  // namespace

extern "C" int repro_adamw_norm_blocks(void) { return kNormBlocks; }

// g's sum of squares into partial[0 .. kNormBlocks), float64.  g_dtype: 0
// float32, 1 bfloat16.  Launches even for n == 0 (the partials are then
// zeros).  Returns cudaGetLastError() after the launch.
extern "C" int repro_adamw_norm_partials(const void* g, int g_dtype,
                                         long long n, void* partial,
                                         cudaStream_t stream) {
  const bool vec = on16(g);
  if (g_dtype == 0)
    adamw_norm_partials<float><<<kNormBlocks, kThreads, 0, stream>>>(
        static_cast<const float*>(g), n, vec, static_cast<double*>(partial));
  else
    adamw_norm_partials<__nv_bfloat16><<<kNormBlocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), n, vec,
        static_cast<double*>(partial));
  return (int)cudaGetLastError();
}

// sqrt of the sum of n_leaves x kNormBlocks partials, into *out (float32)
extern "C" int repro_adamw_norm_finalize(const void* partials, int n_leaves,
                                         void* out, cudaStream_t stream) {
  adamw_norm_finalize<<<1, kThreads, 0, stream>>>(
      static_cast<const double*>(partials), n_leaves,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// One leaf's update in place.  p_dtype: -1 when the param is w itself (a
// float32 model with no master copy), 0 float32, 1 bfloat16; g_dtype: 0
// float32, 1 bfloat16.  lr, scale, b1c, b2c: 0-d float32 device tensors.
// n > 0.  Returns cudaGetLastError() after the launch.
extern "C" int repro_adamw_update(void* p, int p_dtype, void* w,
                                  const void* g, int g_dtype, void* m,
                                  void* v, long long n, const void* lr,
                                  const void* scale, const void* b1c,
                                  const void* b2c, float b1, float c1,
                                  float b2, float c2, float eps, float wd,
                                  cudaStream_t stream) {
  const Consts c{b1, c1, b2, c2, eps, wd};
  if (g_dtype == 0)
    launch_update_g<float>(p_dtype, p, w, g, m, v, n, lr, scale, b1c, b2c, c,
                           stream);
  else
    launch_update_g<__nv_bfloat16>(p_dtype, p, w, g, m, v, n, lr, scale, b1c,
                                   b2c, c, stream);
  return (int)cudaGetLastError();
}
