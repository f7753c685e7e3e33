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
// [B, S, 3, d].  A padded prefill (a bucket's captured graph runs S past
// the prompt) passes lengths [B] (int32): row b's steps from lengths[b] on
// leave the carry as it was, so the last carry is the one after step
// lengths[b] - 1, and hs holds that h from there on; a null pointer is the
// unbounded kernel (training, decode at S = 1), compiled apart.  All contiguous, float32 or bfloat16 alike.  Each step is
// computed in float32 registers and its carry rounded to the input dtype,
// as the reference keeps its carry in x's dtype; so the kept carry is
// exactly the one each step started from.
//
// Design.  Since r is per unit, every (b, unit) is an independent scalar
// recurrence over t, a serial chain that no parallelism shortens.  A block
// owns 32 units of one batch row and two warps.  The chain warp, a lane a
// unit, runs the steps and nothing else: per step four shared-memory loads
// of gx, the cell (slstm::cell: five ex2/rcp on the special-function unit,
// no division) and one 16-byte shared store of (h, c, n, m).  The copy
// warp moves gx into a ring of NS chunks of TC steps by 16-byte cp.async,
// NS - 2 chunks ahead, and writes the chain's staged outputs of the chunk
// before to hs (and kept) with coalesced stores; the two meet once a chunk
// at a block barrier.  The 16-byte copies need d * sizeof(T) a multiple of
// 16 and gx on a 16-byte boundary: the wrapper pads d with zero units
// (kernels/slstm_scan.py) and copies a gx that lies off a boundary.
//
// Bound.  The function's bytes: gx read once (4 B S d), hs written once
// (B S d) and the carries.  The prefill's [1, 1024, 4, 768] float32 moves
// 15.7 MB, 4.7 us at 3.35 TB/s; training's [2, 2048, 4, 768] ~63 MB,
// 19 us, beside which the kept carry (3 B S d, ~38 MB, 11 us), this
// kernel's choice for its backward, is no byte the function needs and
// stays out of the bound.  The kernel is held instead by its chain of S
// dependent steps: pre_f's FMA, the add of m, the two differences and
// their min, the scale, ex2 and its correction, the select, the FMA into n',
// |n'| max 1, the product with 1 + eo, rcp and its Newton step, the
// product into h': ~14 dependent instructions, two on the special-function
// unit, of the 62 the chain's warp issues a step.  Measured
// (tools/torch_slstm_ab.py, an H100 80GB HBM3 at 700 W): 0.065 ms at the
// prefill and 0.127 ms at training's shape with the carry kept, 62-64 ns
// a step at every shape, in L2 or not, where the first single-warp kernel
// took 0.23 and 1.04 ms (220-510 ns a step: each step waited on its own
// prefetched loads, from L2 or from DRAM).  The chain's latency sets the
// pace.
#include "hopper.cuh"
#include "slstm_cell.cuh"

namespace {

namespace blk {
constexpr int UNITS = 32;   // units a block: a lane each
constexpr int TC = 32;      // steps a chunk
constexpr int NS = 4;       // stages of the gx ring
constexpr int THREADS = 64; // the chain warp, the copy warp

template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)NS * TC * 4 * UNITS * sizeof(T);
}
// the ring, then two chunks of staged outputs (h, c, n, m), the carry
// staged whether it is kept or not
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<T>() + 2 * (size_t)TC * UNITS * 16;
}

__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;" ::: "memory");
}
}  // namespace blk

template <typename T, bool KEEP, bool BOUND>
__global__ void __launch_bounds__(blk::THREADS, 1) slstm_scan_fwd(
    const T* __restrict__ gx, const T* __restrict__ r,
    const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ n0, const T* __restrict__ m0, T* __restrict__ hs,
    T* __restrict__ h_out, T* __restrict__ c_out, T* __restrict__ n_out,
    T* __restrict__ m_out, T* __restrict__ kept,
    const int* __restrict__ lengths, int s, int d) {
  using namespace blk;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);          // [NS][TC][4][UNITS]
  float4* outs = reinterpret_cast<float4*>(smem + ring_bytes<T>());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u0 = blockIdx.x * UNITS, u = u0 + lane;
  const bool live = u < d;
  const size_t b = blockIdx.y;
  const int nc = (s + TC - 1) / TC;   // chunk c holds t = c*TC + j, j < TC

  if (warp == 0) {
    // the chain
    float rk[4] = {0.f, 0.f, 0.f, 0.f}, h = 0.f, c = 0.f, n = 0.f, m = 0.f;
    const int len = BOUND ? lengths[b] : s;   // steps t >= len hold the carry
    if (live) {
      const size_t row = b * d + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) rk[k] = slstm::to_f32(r[(size_t)k * d + u]);
      h = slstm::to_f32(h0[row]);
      c = slstm::to_f32(c0[row]);
      n = slstm::to_f32(n0[row]);
      m = slstm::to_f32(m0[row]);
    }
    block_sync();                                 // chunk 0 is in
    for (int p = 0; p <= nc; ++p) {
      if (p < nc) {
        const T* gb = ring + (size_t)(p % NS) * TC * 4 * UNITS + lane;
        float4* ob = outs + (size_t)(p & 1) * TC * UNITS + lane;
        auto load = [&](int j, float g[4]) {
#pragma unroll
          for (int k = 0; k < 4; ++k) g[k] = slstm::to_f32(gb[(j * 4 + k) * UNITS]);
        };
        auto step = [&](int j, const float g[4]) {
          if (!BOUND || p * TC + j < len) {
            const slstm::Step st = slstm::cell(g, rk, h, c, n, m);
            h = slstm::round_to<T>(st.h);
            c = slstm::round_to<T>(st.c);
            n = slstm::round_to<T>(st.n);
            m = slstm::round_to<T>(st.m);
          }
          ob[j * UNITS] = make_float4(h, c, n, m);
        };
        const int nt = min(TC, s - p * TC);
        if (nt == TC) {
          float g[4], gn[4];
          load(0, g);
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            if (j + 1 < TC) load(j + 1, gn);
            step(j, g);
#pragma unroll
            for (int k = 0; k < 4; ++k) g[k] = gn[k];
          }
        } else {
          for (int j = 0; j < nt; ++j) {
            float g[4];
            load(j, g);
            step(j, g);
          }
        }
      }
      block_sync();
    }
    if (live) {
      const size_t row = b * d + u;
      h_out[row] = slstm::from_f32<T>(h);
      c_out[row] = slstm::from_f32<T>(c);
      n_out[row] = slstm::from_f32<T>(n);
      m_out[row] = slstm::from_f32<T>(m);
    }
    return;
  }

  // the copy warp.  Chunk c's gx into ring stage c % NS, 16 bytes a copy,
  // zeros where t or the unit is out of range; one commit group a call.
  auto issue = [&](int c) {
    if (c < nc) {
      constexpr int EPC = 16 / (int)sizeof(T), CPR = UNITS / EPC;
      constexpr int TOTAL = TC * 4 * CPR;
      T* stage = ring + (size_t)(c % NS) * TC * 4 * UNITS;
      for (int i = lane; i < TOTAL; i += 32) {
        const int q = i % CPR, row = i / CPR;             // row = 4 j + k
        const int t = c * TC + row / 4, unit = u0 + q * EPC;
        const bool ok = t < s && unit < d;
        const T* src = gx;
        if (ok) src = gx + ((b * s + t) * 4 + (row % 4)) * d + unit;
        hopper::cp_async16(stage + row * UNITS + q * EPC, src, ok ? 16 : 0);
      }
    }
    hopper::cp_async_commit();
  };
  // chunk c's staged outputs to hs (and kept), a lane a unit
  auto store = [&](int c) {
    if (!live) return;
    const float4* ob = outs + (size_t)(c & 1) * TC * UNITS + lane;
    const int nt = min(TC, s - c * TC);
    for (int j = 0; j < nt; ++j) {
      const size_t bt = b * s + (size_t)c * TC + j;
      const float4 v = ob[j * UNITS];
      hs[bt * d + u] = slstm::from_f32<T>(v.x);
      if (KEEP) {
        T* kt = kept + bt * 3 * d + u;
        kt[0] = slstm::from_f32<T>(v.y);
        kt[d] = slstm::from_f32<T>(v.z);
        kt[2 * (size_t)d] = slstm::from_f32<T>(v.w);
      }
    }
  };

  for (int c = 0; c < NS - 1; ++c) issue(c);
  hopper::cp_async_wait<NS - 2>();
  block_sync();
  for (int p = 0; p <= nc; ++p) {
    issue(p + NS - 1);              // into chunk p - 1's stage, read in p - 1
    if (p >= 1) store(p - 1);
    hopper::cp_async_wait<NS - 2>();   // chunk p + 1 is in
    block_sync();
  }
  hopper::cp_async_wait<0>();
}

template <typename T, bool KEEP, bool BOUND>
int launch_kernel(const void* gx, const void* r, const void* const carry[4],
                  void* hs, void* const out[4], void* kept,
                  const void* lengths, int b, int s, int d,
                  cudaStream_t stream) {
  if (d * sizeof(T) % 16) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = blk::smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      slstm_scan_fwd<T, KEEP, BOUND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto o = [](void* p) { return static_cast<T*>(p); };
  const dim3 grid((d + blk::UNITS - 1) / blk::UNITS, b);
  slstm_scan_fwd<T, KEEP, BOUND><<<grid, blk::THREADS, smem, stream>>>(
      in(gx), in(r), in(carry[0]), in(carry[1]), in(carry[2]), in(carry[3]),
      o(hs), o(out[0]), o(out[1]), o(out[2]), o(out[3]), o(kept),
      static_cast<const int*>(lengths), s, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* gx, const void* r, const void* const carry[4],
           void* hs, void* const out[4], void* kept, const void* lengths,
           int b, int s, int d, cudaStream_t stream) {
  if (lengths) {          // a padded prefill's: nothing kept
    if (kept) return (int)cudaErrorInvalidValue;
    return launch_kernel<T, false, true>(gx, r, carry, hs, out, nullptr,
                                         lengths, b, s, d, stream);
  }
  if (kept)
    return launch_kernel<T, true, false>(gx, r, carry, hs, out, kept,
                                         nullptr, b, s, d, stream);
  return launch_kernel<T, false, false>(gx, r, carry, hs, out, nullptr,
                                        nullptr, b, s, d, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; d * sizeof(T) a multiple of 16 (else
// cudaErrorInvalidValue) and gx on a 16-byte boundary.  carry: h, c, n, m
// in; out: the same after the last step; kept: [B, S, 3, d] or null
// (serving keeps nothing); lengths: [B] int32 or null (a padded prefill's
// real lengths; with kept, cudaErrorInvalidValue).  Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int repro_slstm_scan(const void* gx, const void* r,
                                const void* h0, const void* c0,
                                const void* n0, const void* m0, void* hs,
                                void* h_out, void* c_out, void* n_out,
                                void* m_out, void* kept, const void* lengths,
                                int dtype, int b, int s, int d,
                                cudaStream_t stream) {
  const void* carry[4] = {h0, c0, n0, m0};
  void* out[4] = {h_out, c_out, n_out, m_out};
  if (dtype == 0)
    return launch<float>(gx, r, carry, hs, out, kept, lengths, b, s, d,
                         stream);
  return launch<__nv_bfloat16>(gx, r, carry, hs, out, kept, lengths, b, s,
                               d, stream);
}
