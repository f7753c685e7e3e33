// The sLSTM cell's arithmetic, shared by the forward (csrc/slstm_scan.cu)
// and the backward (csrc/slstm_scan_bwd.cu), which computes the forward's
// step again from the kept carry: both reach the same float32 values by
// the same instructions.  Plain C++ on floats; no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace slstm {

constexpr int THREADS = 32;   // threads a block: one warp, units side by side
constexpr int AHEAD = 8;      // steps whose inputs sit in registers ahead

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and read back: the carry as the input dtype keeps it
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One step's values, float32, from the carry (h, c, n, m) it starts from
// and the input half of its gate pre-activations g = (i, f, z, o):
//   pre_k = g_k + r_k h,  fm = pre_f + m,  m' = max(fm, pre_i),
//   ig = exp(pre_i - m'),  fg = exp(fm - m'),  z = tanh(pre_z),
//   o = sigmoid(pre_o),  c' = fg c + ig z,  n' = fg n + ig,
//   h' = o c' / max(|n'|, 1).
struct Step {
  float pre_i, fm, m, ig, fg, z, o, c, n, den, h;
};

__device__ __forceinline__ Step cell(const float g[4], const float r[4],
                                     float h, float c, float n, float m) {
  Step s;
  s.pre_i = g[0] + r[0] * h;
  const float pre_f = g[1] + r[1] * h;
  const float pre_z = g[2] + r[2] * h;
  const float pre_o = g[3] + r[3] * h;
  s.fm = pre_f + m;
  s.m = fmaxf(s.fm, s.pre_i);
  s.ig = expf(s.pre_i - s.m);
  s.fg = expf(s.fm - s.m);
  s.z = tanhf(pre_z);
  s.o = 1.f / (1.f + expf(-pre_o));
  s.c = s.fg * c + s.ig * s.z;
  s.n = s.fg * n + s.ig;
  s.den = fmaxf(fabsf(s.n), 1.f);
  s.h = s.o * s.c / s.den;
  return s;
}

}  // namespace slstm
