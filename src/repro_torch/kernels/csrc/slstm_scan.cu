// The sLSTM recurrence (xLSTM, arXiv:2405.04517) over a whole sequence for
// Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package runs this recurrence as one
// jax.lax.scan of its _slstm_cell (src/repro/models/xlstm.py:176), which
// XLA compiles into one loop; the port ran it as a Python loop over the
// tokens, ~15 eager kernels a token and layer.  This kernel is that scan.
// Its backward is csrc/slstm_scan_bwd.cu.
//
// Function.  gx [B, S, 4, d], the input half of the gate pre-activations
// (x @ w_i, w_f, w_z, w_o, hoisted out of the recurrence by the caller),
// r [4, d] (one recurrent weight per unit and gate: the reference's
// per-head block diagonal, approximated per unit), and a carry (h, c, n, m)
// of four [B, d]; per step, for every (b, unit) (slstm_cell.cuh):
//   pre_k = gx_k + r_k h,  m' = max(pre_f + m, pre_i),
//   c' = exp(pre_f + m - m') c + exp(pre_i - m') tanh(pre_z),
//   n' = exp(pre_f + m - m') n + exp(pre_i - m'),
//   h' = sigmoid(pre_o) c' / max(|n'|, 1).
// Out: hs [B, S, d] (every step's h), the last carry, and, when the
// backward will run, the carry (c, n, m) after every step, kept as
// [B, S, 3, d].  All contiguous, float32 or bfloat16 alike.  Each step is
// computed in float32 registers and its carry rounded to the input dtype,
// as the reference keeps its carry in x's dtype; so the kept carry is
// exactly the one each step started from.
//
// Design.  Since r is per unit, every (b, unit) is an independent scalar
// recurrence over t: one thread each, a warp on 32 neighbouring units, so
// each load of gx[b, t, k, :] and each store of hs[b, t, :] is one
// coalesced 128-byte line a warp; no shared memory and no communication
// between threads.  gx does not depend on the carry, so the thread keeps
// the next AHEAD steps' four values in registers, loaded AHEAD steps
// before they are needed, and the serial chain never waits on memory.
// Blocks are one warp, so a small B x d spreads over as many SMs as it
// has warps (prefill: B 1 x d 768 is 24 warps).
//
// Bound.  The function's bytes: gx read once (4 B S d), hs written once
// (B S d) and the carries.  The prefill's [1, 1024, 4, 768] float32 moves
// 15.7 MB, 4.7 us at 3.35 TB/s; training's [2, 2048, 4, 768] ~63 MB,
// 19 us, beside which the kept carry (3 B S d, ~38 MB, 11 us), this
// kernel's choice for its backward, is no byte the function needs and
// stays out of the bound.  The kernel is held instead by its chain of S
// dependent steps: a step's critical path (the FMA into pre_f, the add of
// m, the max, two exps, the FMAs into c' and n', |n'| max 1, the
// division, the rounding) is ~150 cycles, so ~0.08 ms at S 1024 and
// ~0.16 ms at S 2048 at 1.98 GHz, whatever B x d up to the ~17k threads
// the card can run in step (132 SMs x 4 schedulers x 32).  Measured
// (chip_smoke.py on an H100 80GB HBM3 at 700 W): 0.23 ms at the prefill
// (224 ns a step) and 1.04 ms at training's shape with the carry kept
// (510 ns a step), 3-7x the estimate: a lone warp issues each step's
// ~150-200 instructions (accurate expf and tanhf, two IEEE divisions,
// the loads and stores) one at a time, so issue, not the critical path
// alone, likely sets the pace.  The chain, not bytes, is
// what a faster design would attack (several units' chains interleaved a
// thread; fewer instructions a step).
#include "slstm_cell.cuh"

namespace {

using slstm::AHEAD;
using slstm::THREADS;

template <typename T>
__device__ __forceinline__ void load_gates(float g[4], const T* p, int d) {
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = slstm::to_f32(p[(size_t)k * d]);
}

template <typename T, bool KEEP>
__global__ void __launch_bounds__(THREADS)
    slstm_scan_fwd(const T* __restrict__ gx, const T* __restrict__ r,
                   const T* __restrict__ h0, const T* __restrict__ c0,
                   const T* __restrict__ n0, const T* __restrict__ m0,
                   T* __restrict__ hs, T* __restrict__ h_out,
                   T* __restrict__ c_out, T* __restrict__ n_out,
                   T* __restrict__ m_out, T* __restrict__ kept, int s,
                   int d) {
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= d) return;
  const size_t row = (size_t)blockIdx.y * d + u;
  float rk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) rk[k] = slstm::to_f32(r[(size_t)k * d + u]);
  float h = slstm::to_f32(h0[row]), c = slstm::to_f32(c0[row]);
  float n = slstm::to_f32(n0[row]), m = slstm::to_f32(m0[row]);
  const size_t step = 4 * (size_t)d;                 // gx's stride in t
  const T* g = gx + (size_t)blockIdx.y * s * step + u;
  T* hb = hs + (size_t)blockIdx.y * s * d + u;
  T* kb = kept + (KEEP ? (size_t)blockIdx.y * s * 3 * d + u : 0);

  float ahead[AHEAD][4];
#pragma unroll
  for (int k = 0; k < AHEAD; ++k)
    if (k < s) load_gates(ahead[k], g + k * step, d);
  for (int t0 = 0; t0 < s; t0 += AHEAD) {
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      const int t = t0 + k;
      if (t < s) {
        float gt[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) gt[j] = ahead[k][j];
        if (t + AHEAD < s) load_gates(ahead[k], g + (t + AHEAD) * step, d);
        const slstm::Step st = slstm::cell(gt, rk, h, c, n, m);
        h = slstm::round_to<T>(st.h);
        c = slstm::round_to<T>(st.c);
        n = slstm::round_to<T>(st.n);
        m = slstm::round_to<T>(st.m);
        hb[(size_t)t * d] = slstm::from_f32<T>(h);
        if (KEEP) {
          T* kt = kb + (size_t)t * 3 * d;
          kt[0] = slstm::from_f32<T>(c);
          kt[d] = slstm::from_f32<T>(n);
          kt[2 * (size_t)d] = slstm::from_f32<T>(m);
        }
      }
    }
  }
  h_out[row] = slstm::from_f32<T>(h);
  c_out[row] = slstm::from_f32<T>(c);
  n_out[row] = slstm::from_f32<T>(n);
  m_out[row] = slstm::from_f32<T>(m);
}

template <typename T>
int launch(const void* gx, const void* r, const void* const carry[4],
           void* hs, void* const out[4], void* kept, int b, int s, int d,
           cudaStream_t stream) {
  const dim3 grid((d + THREADS - 1) / THREADS, b);
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto o = [](void* p) { return static_cast<T*>(p); };
  if (kept)
    slstm_scan_fwd<T, true><<<grid, THREADS, 0, stream>>>(
        in(gx), in(r), in(carry[0]), in(carry[1]), in(carry[2]),
        in(carry[3]), o(hs), o(out[0]), o(out[1]), o(out[2]), o(out[3]),
        o(kept), s, d);
  else
    slstm_scan_fwd<T, false><<<grid, THREADS, 0, stream>>>(
        in(gx), in(r), in(carry[0]), in(carry[1]), in(carry[2]),
        in(carry[3]), o(hs), o(out[0]), o(out[1]), o(out[2]), o(out[3]),
        nullptr, s, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  carry: h, c, n, m in; out: the same after
// the last step; kept: [B, S, 3, d] or null (serving keeps nothing).
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int repro_slstm_scan(const void* gx, const void* r,
                                const void* h0, const void* c0,
                                const void* n0, const void* m0, void* hs,
                                void* h_out, void* c_out, void* n_out,
                                void* m_out, void* kept, int dtype, int b,
                                int s, int d, cudaStream_t stream) {
  const void* carry[4] = {h0, c0, n0, m0};
  void* out[4] = {h_out, c_out, n_out, m_out};
  if (dtype == 0)
    return launch<float>(gx, r, carry, hs, out, kept, b, s, d, stream);
  return launch<__nv_bfloat16>(gx, r, carry, hs, out, kept, b, s, d, stream);
}
