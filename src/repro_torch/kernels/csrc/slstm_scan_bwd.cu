// Backward of the sLSTM recurrence (csrc/slstm_scan.cu) for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package's gradient of the recurrence is
// autodiff of its jax.lax.scan (src/repro/models/xlstm.py:176).  This is
// the same reverse-mode recurrence, per (b, unit), written out.
//
// In: gx [B, S, 4, d], r [4, d], the initial carry (h, c, n, m), hs
// [B, S, d] and the kept carry [B, S, 3, d] of the forward (the carry each
// step started from: hs and kept at t - 1, the initial carry at t = 0),
// dhs [B, S, d] and the last carry's gradient (dh, dc, dn, dm).  Out: dgx
// [B, S, 4, d] and the initial carry's gradient in the input dtype, and
// dr's per-row parts [B, 4, d] in float32, which the wrapper sums over B
// (no atomics, as the repo's other backwards use none: one fixed order).
//
// Each step recomputes the forward's float32 values from the kept carry
// (slstm_cell.cuh) and runs, from the carried gradient (dh, dc, dn, dm) of
// its output carry plus dhs[t]:
//   q = dh / den,  do = q c',  dc' += q o,  dden = -q o c' / den,
//   dn' += dden * w sign(n'),   w = 1, 1/2, 0 for |n'| >, =, < 1,
//   df = dc' c + dn' n,  di = dc' z + dn',  dz = dc' ig,
//   dpre_i = di ig,  dfm = df fg,  dm' += -dpre_i - dfm,
// m' = max(fm, pre_i) then adds dm' to dfm or dpre_i, whichever side is
// larger, and dpre_f = dfm, dpre_z = dz (1 + z)(1 - z), dpre_o = do o
// (1 - o); it hands (dh, dc, dn, dm) of its input carry to the step before:
//   dc = dc' fg,  dn = dn' fg,  dm = dfm,  dh = sum_k dpre_k r_k,
// with dr_k += dpre_k h summed over t in registers.  The rounding of the
// carry to the input dtype passes the gradient through unchanged.
//
// Ties, by JAX's rule (lax.max's JVP): at max(fm, pre_i) with fm = pre_i,
// and at max(|n'|, 1) with |n'| = 1, each side takes half the gradient
// (torch.clamp would give it all to n').  With a zero initial carry n' is
// exactly 1 at the first step whenever pre_i >= pre_f (m' = pre_i, ig =
// exp(0) = 1, and fg multiplies zero carries), so the tie is common there;
// but no gradient reaches that step's inputs through n' (ig is the
// constant 1 and its pre_i part cancels through m'), only the initial
// carry's dn, where the two rules differ.  The half is what the
// reference's jax.vjp computes; a central difference agrees with it.
//
// Design.  As the forward: a thread a (b, unit), a warp on 32 neighbouring
// units, every load and store a coalesced line; a step's nine inputs (gx's
// four, the carry it started from, dhs) are loaded AHEAD steps before they
// are needed, walking t downward, since none depends on the carried
// gradient.  Only the gradient's chain (dh -> dpre_k -> dh) is serial; the
// forward's values of a step are computed again off that chain.
//
// Bound.  The gradient needs gx and dhs read once (5 B S d) and dgx
// written once (4 B S d): at training's [2, 2048, 4, 768] float32 ~113 MB,
// 34 us at 3.35 TB/s, computing the forward's carry again (from a
// checkpoint every few hundred steps, each segment's gx held on chip).
// Reading hs and the kept carry, as this kernel does, adds 4 B S d: ~164
// MB, 49 us.  The bound is the smaller (work.slstm_bwd_work).  The chain
// of S dependent steps holds the kernel instead: ~100-150 cycles a step
// of dependent FMAs and selects (the recomputed forward, ~100
// instructions a step, issues beside it), ~0.1-0.16 ms at S 2048 and
// 1.98 GHz.  Measured (chip_smoke.py on an H100 80GB HBM3 at
// 700 W): 1.19 ms, 579 ns a step, held by one warp's issue of the
// recomputed forward and the reverse step together, as the forward is.
#include "slstm_cell.cuh"

namespace {

using slstm::AHEAD;
using slstm::THREADS;

// one step's inputs: gx's four, the carry it started from, dhs
struct In {
  float g[4], h, c, n, m, dy;
};

template <typename T>
__device__ __forceinline__ void load_step(In& e, const T* g, const T* hb,
                                          const T* kb, const T* dyb,
                                          const float init[4], int t, int d) {
  const size_t du = d;
#pragma unroll
  for (int k = 0; k < 4; ++k) e.g[k] = slstm::to_f32(g[(size_t)t * 4 * du + k * du]);
  if (t > 0) {
    const T* kt = kb + (size_t)(t - 1) * 3 * du;
    e.h = slstm::to_f32(hb[(size_t)(t - 1) * du]);
    e.c = slstm::to_f32(kt[0]);
    e.n = slstm::to_f32(kt[du]);
    e.m = slstm::to_f32(kt[2 * du]);
  } else {
    e.h = init[0];
    e.c = init[1];
    e.n = init[2];
    e.m = init[3];
  }
  e.dy = slstm::to_f32(dyb[(size_t)t * du]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) slstm_scan_bwd(
    const T* __restrict__ gx, const T* __restrict__ r,
    const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ n0, const T* __restrict__ m0,
    const T* __restrict__ hs, const T* __restrict__ kept,
    const T* __restrict__ dhs, const T* __restrict__ dh_last,
    const T* __restrict__ dc_last, const T* __restrict__ dn_last,
    const T* __restrict__ dm_last, T* __restrict__ dgx,
    float* __restrict__ dr_rows, T* __restrict__ dh0, T* __restrict__ dc0,
    T* __restrict__ dn0, T* __restrict__ dm0, int s, int d) {
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= d) return;
  const size_t b = blockIdx.y, row = b * d + u;
  float rk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) rk[k] = slstm::to_f32(r[(size_t)k * d + u]);
  const float init[4] = {slstm::to_f32(h0[row]), slstm::to_f32(c0[row]),
                         slstm::to_f32(n0[row]), slstm::to_f32(m0[row])};
  const T* g = gx + b * s * 4 * d + u;
  const T* hb = hs + b * s * d + u;
  const T* kb = kept + b * s * 3 * d + u;
  const T* dyb = dhs + b * s * d + u;
  T* dg = dgx + b * s * 4 * d + u;

  float dh = slstm::to_f32(dh_last[row]), dc = slstm::to_f32(dc_last[row]);
  float dn = slstm::to_f32(dn_last[row]), dm = slstm::to_f32(dm_last[row]);
  float dr[4] = {0.f, 0.f, 0.f, 0.f};

  In ahead[AHEAD];
#pragma unroll
  for (int k = 0; k < AHEAD; ++k)
    if (s - 1 - k >= 0) load_step(ahead[k], g, hb, kb, dyb, init, s - 1 - k, d);
  for (int t0 = s - 1; t0 >= 0; t0 -= AHEAD) {
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int t = t0 - k;
      if (t >= 0) {
        const In e = ahead[k];
        if (t - AHEAD >= 0)
          load_step(ahead[k], g, hb, kb, dyb, init, t - AHEAD, d);
        const slstm::Step st = slstm::cell(e.g, rk, e.h, e.c, e.n, e.m);
        // h' = o c' / den
        const float q = (e.dy + dh) / st.den;
        const float d_o = q * st.c;
        dc += q * st.o;
        const float dden = -q * (st.o * st.c) / st.den;
        const float an = fabsf(st.n);
        const float w = an > 1.f ? 1.f : (an == 1.f ? 0.5f : 0.f);
        const float sgn = st.n > 0.f ? 1.f : (st.n < 0.f ? -1.f : 0.f);
        dn += dden * w * sgn;
        // c' = fg c + ig z, n' = fg n + ig
        const float df = dc * e.c + dn * e.n;
        const float di = dc * st.z + dn;
        const float dz = dc * st.ig;
        // ig = exp(pre_i - m'), fg = exp(fm - m'); m' = max(fm, pre_i)
        float dpre_i = di * st.ig;
        float dfm = df * st.fg;
        const float dmt = dm - dpre_i - dfm;
        if (st.fm > st.pre_i) {
          dfm += dmt;
        } else if (st.pre_i > st.fm) {
          dpre_i += dmt;
        } else {
          dfm += 0.5f * dmt;
          dpre_i += 0.5f * dmt;
        }
        const float dpre[4] = {dpre_i, dfm, dz * (1.f + st.z) * (1.f - st.z),
                               d_o * st.o * (1.f - st.o)};
        T* dgt = dg + (size_t)t * 4 * d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dgt[(size_t)j * d] = slstm::from_f32<T>(dpre[j]);
          dr[j] += dpre[j] * e.h;
        }
        dh = dpre[0] * rk[0] + dpre[1] * rk[1] + dpre[2] * rk[2] +
             dpre[3] * rk[3];
        dc *= st.fg;
        dn *= st.fg;
        dm = dfm;
      }
    }
  }
  dh0[row] = slstm::from_f32<T>(dh);
  dc0[row] = slstm::from_f32<T>(dc);
  dn0[row] = slstm::from_f32<T>(dn);
  dm0[row] = slstm::from_f32<T>(dm);
#pragma unroll
  for (int j = 0; j < 4; ++j) dr_rows[(b * 4 + j) * d + u] = dr[j];
}

template <typename T>
int launch(const void* const in[13], void* const out[5], float* dr_rows,
           int b, int s, int d, cudaStream_t stream) {
  const dim3 grid((d + THREADS - 1) / THREADS, b);
  auto c = [&](int i) { return static_cast<const T*>(in[i]); };
  auto o = [&](int i) { return static_cast<T*>(out[i]); };
  slstm_scan_bwd<T><<<grid, THREADS, 0, stream>>>(
      c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8), c(9), c(10),
      c(11), c(12), o(0), dr_rows, o(1), o(2), o(3), o(4), s, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  in: gx, r, h0, c0, n0, m0, hs, kept, dhs,
// and the last carry's gradient dh, dc, dn, dm; out: dgx, then the initial
// carry's gradient dh0, dc0, dn0, dm0; dr_rows: [B, 4, d] float32.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int repro_slstm_scan_bwd(
    const void* gx, const void* r, const void* h0, const void* c0,
    const void* n0, const void* m0, const void* hs, const void* kept,
    const void* dhs, const void* dh_last, const void* dc_last,
    const void* dn_last, const void* dm_last, void* dgx, void* dr_rows,
    void* dh0, void* dc0, void* dn0, void* dm0, int dtype, int b, int s,
    int d, cudaStream_t stream) {
  const void* in[13] = {gx, r,   h0,  c0,      n0,      m0,      hs,
                        kept, dhs, dh_last, dc_last, dn_last, dm_last};
  void* out[5] = {dgx, dh0, dc0, dn0, dm0};
  float* rows = static_cast<float*>(dr_rows);
  if (dtype == 0) return launch<float>(in, out, rows, b, s, d, stream);
  return launch<__nv_bfloat16>(in, out, rows, b, s, d, stream);
}
