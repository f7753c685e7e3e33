// The sLSTM cell's arithmetic, shared by the forward (csrc/slstm_scan.cu)
// and the backward (csrc/slstm_scan_bwd.cu), which computes the forward's
// step again from the kept carry: both reach the same float32 values by
// the same instructions.  Plain C++ on floats; no PyTorch headers.
//
// The backward's step is written as a linear map: given a step's forward
// values, the carried gradient (dh, dc, dn, dm) of its output carry maps to
// that of its input carry through fixed coefficients (Coef), which depend
// on the kept carry and gx alone, so they are computed in parallel over t
// ahead of the serial chain; the chain then runs four short dot products a
// step (chain), and the gate gradients of a step follow from its carried
// gradient and the same coefficients (dpre).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace slstm {

constexpr float LOG2E = 1.4426950408889634f;      // log2(e), rounded
constexpr float LOG2E_LO = 1.925963033500011e-08f;  // log2(e) - LOG2E
constexpr float LN2 = 0.6931471805599453f;

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

// 2^x and 1/x on the special-function unit (ex2.approx: ~2 ulp; rcp.approx:
// 1 ulp), subnormals flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// e^x for x <= 0: ex2 of the rounded product t = x log2(e), times 1 + the
// product's rounding error (x log2(e) - t, two FMAs) ln 2, so that the
// argument's rounding (~|x| ulp) is not left in the result: one MUFU and
// two dependent FMAs on the chain, where expf takes six
__device__ __forceinline__ float exp_neg(float x) {
  const float t = x * LOG2E;
  const float e = fmaf(x, LOG2E_LO, fmaf(x, LOG2E, -t));
  const float y = ex2(t);
  return fmaf(y, e * LN2, y);
}
// 1/x for 1 <= x < 2^126: rcp.approx and one Newton step
__device__ __forceinline__ float recip(float x) {
  const float r = rcp(x);
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

// One step's values, float32, from the carry (h, c, n, m) it starts from
// and the input half of its gate pre-activations g = (i, f, z, o):
//   pre_k = g_k + r_k h,  fm = pre_f + m,  m' = max(fm, pre_i),
//   ig = exp(pre_i - m'),  fg = exp(fm - m'),  z = tanh(pre_z),
//   eo = exp(-|pre_o|), wo = 1 for pre_o >= 0 else eo, so that
//   o = sigmoid(pre_o) = wo / (1 + eo) and o (1 - o) = eo / (1 + eo)^2,
//   c' = fg c + ig z,  n' = fg n + ig,  den = max(|n'|, 1),
//   h' = o c' / den = c' wo / ((1 + eo) den).
// Every exponential's argument is <= 0 (exp_neg), and ig and fg share one;
// h' takes one reciprocal for the sigmoid and the division together; tanhf
// is libm's, branch-free.
// Not tanh.approx: its relative error, 2^-10.99, is above the float32
// limit.  Each step stays within a few ulp of the plain version's float32
// step: the recurrence carries small differences on (PERF.md, row 6).
struct Step {
  float pre_i, fm, m, ig, fg, z, eo, wo, c, n, den, h;
};

__device__ __forceinline__ Step cell(const float g[4], const float r[4],
                                     float h, float c, float n, float m) {
  Step s;
  s.pre_i = fmaf(r[0], h, g[0]);
  const float pre_f = fmaf(r[1], h, g[1]);
  const float pre_z = fmaf(r[2], h, g[2]);
  const float pre_o = fmaf(r[3], h, g[3]);
  s.fm = pre_f + m;
  s.m = fmaxf(s.fm, s.pre_i);
  // one of ig, fg is exp(0) = 1, the other exp(-|fm - pre_i|): one
  // exponential, bit for bit the two's values
  const float e = exp_neg(fminf(s.fm - s.pre_i, s.pre_i - s.fm));
  const bool i_wins = s.pre_i >= s.fm;
  s.ig = i_wins ? 1.f : e;
  s.fg = i_wins ? e : 1.f;
  s.z = tanhf(pre_z);
  s.eo = exp_neg(-fabsf(pre_o));
  s.wo = pre_o >= 0.f ? 1.f : s.eo;
  s.c = fmaf(s.fg, c, s.ig * s.z);
  s.n = fmaf(s.fg, n, s.ig);
  s.den = fmaxf(fabsf(s.n), 1.f);
  s.h = (s.c * s.wo) * recip((1.f + s.eo) * s.den);
  return s;
}

// A step's backward as coefficients, float4s so that a lane reads them in
// five 16-byte loads.  With (dh, dc, dn, dm) the carried gradient of the
// step's output carry (dhs[t] not yet added) and dy = dhs[t]:
//   a:    dh's row: dh_in = a . (dh + dy, dc, dn, dm)
//   b:    dm's row, which is also pre_f's: dm_in = dpre_f = b . (...)
//   c:    (fg a1, fg a2, fg, h): dc_in = fg (dc + a1 x),
//         dn_in = fg (dn + a2 x), x = dh + dy; h the input carry's h
//   bias: the four rows' dy column times dy
//   p:    (o_x, z_x, z_c, dy): dpre_o = o_x x, dpre_z = z_x x + z_c dc
// pre_i's row is (-b.x, -b.y, -b.z, 1 - b.w): dpre_i + dpre_f = dm, as m'
// = max(fm, pre_i) moves with both and ig, fg do not.
struct Coef {
  float4 a, b, c, bias, p;
};

// From a step's values (cell) on the carry (h, c, n, m) it started from,
// r and dy = dhs[t].  The gradient through the step, written out (what
// csrc/slstm_scan_bwd.cu's note derives):
//   x = dh + dy,  q = x / den,  dc~ = dc + q o,
//   dn~ = dn - q o c' / den * w sign(n')   (w = 1, 1/2, 0 for |n'| >, =, < 1),
//   dpre_o = q c' o (1 - o),  dpre_z = dc~ ig (1 - z^2),
//   pi = ig (z dc~ + dn~),  fm = fg (c dc~ + n dn~),
//   m' = max(fm, pre_i) routes dm - pi - fm by s_f = 1, 1/2, 0 for
//   fm >, =, < pre_i (JAX's rule at the tie):
//   dpre_f = fm + s_f (dm - pi - fm) = (1 - s_f) fm - s_f pi + s_f dm,
//   dpre_i = pi + (1 - s_f) (dm - pi - fm) = s_f pi - (1 - s_f) fm
//            + (1 - s_f) dm,
//   dh_in = sum_k r_k dpre_k,  dc_in = fg dc~,  dn_in = fg dn~,
//   dm_in = dpre_f.
// Every term is linear in (x, dc, dn, dm); the rows below are its
// coefficients.  Written this way no dpre adds and subtracts a term
// that cancels (the sequential form's dm - pi - fm).
__device__ __forceinline__ Coef coef(const Step& st, const float r[4],
                                     float h, float c, float n, float dy) {
  const float q1 = recip(1.f + st.eo);
  const float o = st.wo * q1, omo = st.eo * q1 * q1;     // o, o (1 - o)
  const float iv = recip(st.den);
  const float an = fabsf(st.n);
  const float w = an > 1.f ? 1.f : (an == 1.f ? 0.5f : 0.f);
  const float sgn = st.n > 0.f ? 1.f : (st.n < 0.f ? -1.f : 0.f);
  const float a1 = iv * o;                                // dc~ = dc + a1 x
  const float a2 = -(o * st.c) * iv * iv * w * sgn;       // dn~ = dn + a2 x
  const float po = iv * st.c * omo;
  const float az = st.ig * (1.f + st.z) * (1.f - st.z);
  // pi and fm in (x, dc, dn)
  const float pi_x = st.ig * fmaf(st.z, a1, a2), pi_c = st.ig * st.z,
              pi_n = st.ig;
  const float fm_x = st.fg * fmaf(c, a1, n * a2), fm_c = st.fg * c,
              fm_n = st.fg * n;
  const float sf = st.fm > st.pre_i ? 1.f : (st.pre_i > st.fm ? 0.f : 0.5f);
  const float si = 1.f - sf;
  Coef k;
  k.b = make_float4(si * fm_x - sf * pi_x, si * fm_c - sf * pi_c,
                    si * fm_n - sf * pi_n, sf);
  k.p = make_float4(po, az * a1, az, dy);
  const float rf = r[1] - r[0];             // pre_i's row is -b's, + si dm
  k.a = make_float4(fmaf(rf, k.b.x, fmaf(r[2], k.p.y, r[3] * po)),
                    fmaf(rf, k.b.y, r[2] * az), rf * k.b.z,
                    fmaf(r[0], si, r[1] * sf));
  k.c = make_float4(st.fg * a1, st.fg * a2, st.fg, h);
  k.bias = make_float4(k.a.x * dy, k.c.x * dy, k.c.y * dy, k.b.x * dy);
  return k;
}

// One step of a running sum carried compensated: k hi + (t + k lo) as
// hi' + lo', hi' the sum rounded and lo' what the rounding dropped (Fast2Sum:
// exact where |k hi| >= |t + k lo|, as over the long stretches where the
// sum runs), so lo' is at most half an ulp of hi' and flows into the next
// step's term.  The _rn intrinsics keep the compiler from fusing the
// product into the sum, which lo' assumes it is not.
__device__ __forceinline__ void carry_sum(float k, float hi, float lo,
                                          float t, float& out_hi,
                                          float& out_lo) {
  const float p = __fmul_rn(k, hi);
  const float y = fmaf(k, lo, t);
  out_hi = __fadd_rn(p, y);
  out_lo = __fadd_rn(__fsub_rn(p, out_hi), y);
}

// The serial chain's step: the carried gradient (dh, dc, dn, dm) of a
// step's output carry -> that of its input carry.  Four dot products, at
// most four FMAs deep.  dc, dn and dm are carried by factors fg, fg and
// s_f, each exactly 1 wherever the forget gate wins (fm > pre_i, the
// common case), so over such a stretch each is a running sum of one term
// a step over thousands of steps, whose float32 rounding reached 1.5e-4 of
// dr at xlstm-125m's training shape (tools/torch_slstm_ab.py --seeds; the
// chain in float64, --variant chain64, removes it): each is summed
// compensated (carry_sum), the rounding's rest in lo.  g itself is the
// carried gradient to half an ulp, and every row reads it; dh, whose own
// factor is r-sized, is carried plainly (lo.x stays 0).
__device__ __forceinline__ float4 chain(const Coef& k, float4 g, float4& lo) {
  float4 o;
  o.x = fmaf(k.a.w, g.w, fmaf(k.a.z, g.z, fmaf(k.a.y, g.y,
                                               fmaf(k.a.x, g.x, k.bias.x))));
  carry_sum(k.c.z, g.y, lo.y, fmaf(k.c.x, g.x, k.bias.y), o.y, lo.y);
  carry_sum(k.c.z, g.z, lo.z, fmaf(k.c.y, g.x, k.bias.z), o.z, lo.z);
  carry_sum(k.b.w, g.w, lo.w,
            fmaf(k.b.z, g.z, fmaf(k.b.y, g.y, fmaf(k.b.x, g.x, k.bias.w))),
            o.w, lo.w);
  return o;
}

// The step's gate gradients (dpre_i, dpre_f, dpre_z, dpre_o) from the
// carried gradient g of its output carry and its coefficients.
__device__ __forceinline__ void dpre(const Coef& k, float4 g, float out[4]) {
  const float x = g.x + k.p.w;
  const float l = fmaf(k.b.z, g.z, fmaf(k.b.y, g.y, k.b.x * x));
  out[0] = fmaf(1.f - k.b.w, g.w, -l);
  out[1] = fmaf(k.b.w, g.w, l);
  out[2] = fmaf(k.p.z, g.y, k.p.y * x);
  out[3] = k.p.x * x;
}

}  // namespace slstm
