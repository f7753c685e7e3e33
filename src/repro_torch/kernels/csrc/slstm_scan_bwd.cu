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
// The gradient through a step (slstm_cell.cuh, coef): from the carried
// gradient (dh, dc, dn, dm) of its output carry plus dhs[t],
//   q = dh / den,  do = q c',  dc' += q o,  dden = -q o c' / den,
//   dn' += dden * w sign(n'),   w = 1, 1/2, 0 for |n'| >, =, < 1,
//   df = dc' c + dn' n,  di = dc' z + dn',  dz = dc' ig,
//   dpre_i = di ig,  dfm = df fg,  dm' += -dpre_i - dfm,
// m' = max(fm, pre_i) then adds dm' to dfm or dpre_i, whichever side is
// larger, and dpre_f = dfm, dpre_z = dz (1 + z)(1 - z), dpre_o = do o
// (1 - o); it hands (dh, dc, dn, dm) of its input carry to the step before:
//   dc = dc' fg,  dn = dn' fg,  dm = dfm,  dh = sum_k dpre_k r_k,
// with dr_k += dpre_k h summed over t.  Given the step's forward values
// every one of these is linear in the carried gradient: the step is a
// fixed map (slstm::Coef) from (dh, dc, dn, dm) to the step before's and
// to dpre, computed from gx, hs and the kept carry alone.  The rounding of
// the carry to the input dtype passes the gradient through unchanged.
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
// Design.  A block owns 16 units of one batch row (96 blocks at
// training's B 2 x d 768, so that the producers' work spreads over most of
// the 132 SMs) and walks the sequence backwards in chunks of TC steps, in
// phases separated by block barriers.  Producer warps (NP of them, two
// steps of 16 units a warp instruction) copy each chunk's inputs (gx's four
// rows, hs and the kept carry at t - 1, dhs) into a ring of NS stages by
// 16-byte cp.async, NS - 2 chunks ahead; compute every step's forward
// values again (slstm::cell, the forward's own instructions) and its
// coefficients (slstm::coef), in parallel over the chunk's steps, one chunk
// ahead of the chain, into shared memory; and, one chunk behind the chain,
// read the carried gradient the chain left for each step, form dpre
// (slstm::dpre), store dgx and sum dr in registers.  The chain warp runs
// the linear map alone: per step four 16-byte shared loads, one 16-byte
// store of the carried gradient, 12 FMAs at most four deep, and dc, dn and
// dm summed compensated (slstm::carry_sum: their own factors are exactly 1
// wherever the forget gate wins, and a plain float32 running sum over
// thousands of steps put 1.5e-4 x (1 + |dr|) into dr); no division, no
// transcendental.  dr's per-thread parts are summed in one fixed order at
// the end.  The 16-byte copies need d * sizeof(T) a multiple of 16 and
// gx, hs, the kept carry and dhs on 16-byte boundaries: the wrapper pads d
// with zero units (kernels/slstm_scan.py) and copies an input that lies off
// a boundary.
//
// Bound.  The gradient needs gx and dhs read once (5 B S d) and dgx
// written once (4 B S d): at training's [2, 2048, 4, 768] float32 ~113 MB,
// 34 us at 3.35 TB/s, computing the forward's carry again (from a
// checkpoint every few hundred steps, each segment's gx held on chip).
// Reading hs and the kept carry, as this kernel does, adds 4 B S d: ~164
// MB, 49 us.  The bound is the smaller (work.slstm_bwd_work).  Measured
// (tools/torch_slstm_ab.py, an H100 80GB HBM3 at 700 W): 0.091 ms at that
// shape, 44 ns a step, with a plain float32 chain, where the first kernel
// (one warp recomputing each step beside the reverse step) took 1.19 ms,
// 579 ns a step.  The producers set that pace: alone they take 0.077 ms,
// the chain alone 0.056 (the tool's --variant skip_chain and
// skip_producers, built from patched copies of this file); 8 producer
// warps beat 4 and 16, 32-step chunks beat 16.  The compensated sums
// lengthen the chain's step: 0.0996 ms at that shape (the chain alone
// 0.060, the producers alone 0.076).
#include "hopper.cuh"
#include "slstm_cell.cuh"

namespace {

namespace blk {
constexpr int UNITS = 16;   // units a block
constexpr int SPW = 32 / UNITS;   // steps a producer warp takes at once
constexpr int TC = 32;      // steps a chunk
constexpr int NS = 4;       // stages of the input ring
constexpr int NP = 8;       // producer warps
constexpr int THREADS = 32 * (1 + NP);
constexpr int ROWS = 9;     // a step's input rows: gx's 4, h, c, n, m, dhs
constexpr int NCOEF = 5;    // float4s of a step's slstm::Coef
constexpr int SLOTS = TC / (NP * SPW);   // steps a producer thread takes a chunk
static_assert(TC % (NP * SPW) == 0, "producers split a chunk evenly");

template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)NS * TC * ROWS * UNITS * sizeof(T);
}
// the ring, two chunks of coefficients, two of carried gradients
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return ring_bytes<T>() + 2 * (size_t)TC * NCOEF * UNITS * 16 +
         2 * (size_t)TC * UNITS * 16;
}

// the whole block (barrier 0), reached from the chain's branch and the
// producers' alike; the producers alone (barrier 1)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 0;" ::: "memory");
}
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NP * 32) : "memory");
}
}  // namespace blk

template <typename T>
__global__ void __launch_bounds__(blk::THREADS, 1) slstm_scan_bwd(
    const T* __restrict__ gx, const T* __restrict__ r,
    const T* __restrict__ h0, const T* __restrict__ c0,
    const T* __restrict__ n0, const T* __restrict__ m0,
    const T* __restrict__ hs, const T* __restrict__ kept,
    const T* __restrict__ dhs, const T* __restrict__ dh_last,
    const T* __restrict__ dc_last, const T* __restrict__ dn_last,
    const T* __restrict__ dm_last, T* __restrict__ dgx,
    float* __restrict__ dr_rows, T* __restrict__ dh0, T* __restrict__ dc0,
    T* __restrict__ dn0, T* __restrict__ dm0, int s, int d) {
  using namespace blk;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ring = reinterpret_cast<T*>(smem);                   // [NS][TC][ROWS][UNITS]
  float4* coefs = reinterpret_cast<float4*>(smem + ring_bytes<T>());
  float4* grads = coefs + 2 * TC * NCOEF * UNITS;         // [2][TC][UNITS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = lane % UNITS, u0 = blockIdx.x * UNITS, u = u0 + unit;
  const bool live = u < d;
  const size_t b = blockIdx.y;
  const int nc = (s + TC - 1) / TC;   // chunk c holds t = s-1-c*TC-j, j < TC

  if (warp == 0) {
    // the chain: the carried gradient (dh, dc, dn, dm), walking t down;
    // lanes UNITS.. repeat lanes 0.. (same loads, same stores)
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 lo = g;                                // the compensated rest
    if (live) {
      const size_t row = b * d + u;
      g = make_float4(slstm::to_f32(dh_last[row]), slstm::to_f32(dc_last[row]),
                      slstm::to_f32(dn_last[row]), slstm::to_f32(dm_last[row]));
    }
    block_sync();                                 // chunk 0's coefficients
    for (int p = 0; p <= nc; ++p) {
      if (p < nc) {
        const float4* kb = coefs + (size_t)(p & 1) * TC * NCOEF * UNITS + unit;
        float4* gb = grads + (size_t)(p & 1) * TC * UNITS + unit;
        // rows a, b, c, bias of step j (Coef's order: a, b, c, bias, p)
        auto load = [&](int j, float4 k[4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i) k[i] = kb[(j * NCOEF + i) * UNITS];
        };
        auto step = [&](int j, const float4 k[4]) {
          gb[j * UNITS] = g;
          slstm::Coef co;
          co.a = k[0];
          co.b = k[1];
          co.c = k[2];
          co.bias = k[3];
          g = slstm::chain(co, g, lo);
        };
        const int nt = min(TC, s - p * TC);
        if (nt == TC) {       // coefficients loaded two steps ahead
          float4 k[4], k1[4], k2[4];
          load(0, k);
          load(1, k1);
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            if (j + 2 < TC) load(j + 2, k2);
            step(j, k);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              k[i] = k1[i];
              k1[i] = k2[i];
            }
          }
        } else {
          for (int j = 0; j < nt; ++j) {
            float4 k[4];
            load(j, k);
            step(j, k);
          }
        }
      }
      block_sync();
    }
    if (live && lane < UNITS) {
      const size_t row = b * d + u;
      dh0[row] = slstm::from_f32<T>(g.x);
      dc0[row] = slstm::from_f32<T>(g.y);
      dn0[row] = slstm::from_f32<T>(g.z);
      dm0[row] = slstm::from_f32<T>(g.w);
    }
    block_sync();                                 // dr's parts are in
    return;
  }

  // producers: thread (w, lane) takes unit lane % UNITS and steps
  // j = (w + NP i) SPW + lane / UNITS, i < SLOTS, of every chunk
  const int w = warp - 1, tp = threadIdx.x - 32, sub = lane / UNITS;
  float rk[4], init[4] = {0.f, 0.f, 0.f, 0.f}, dr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) rk[k] = live ? slstm::to_f32(r[(size_t)k * d + u]) : 0.f;
  if (live) {
    const size_t row = b * d + u;
    init[0] = slstm::to_f32(h0[row]);
    init[1] = slstm::to_f32(c0[row]);
    init[2] = slstm::to_f32(n0[row]);
    init[3] = slstm::to_f32(m0[row]);
  }

  // This thread's 16-byte copies of a chunk, the same few in every chunk:
  // piece i = tp + NP 32 k is row v of step j, elements q EPC.., at a
  // global address that falls by a fixed stride a chunk; it is read while
  // its step (t - 1 for hs and the carry) is >= 0, i.e. up to chunk cmax.
  constexpr int EPC = 16 / (int)sizeof(T), CPR = UNITS / EPC;
  constexpr int TOTAL = TC * ROWS * CPR, PER = (TOTAL + NP * 32 - 1) / (NP * 32);
  const T* src0[PER];
  long long stride[PER];
  int cmax[PER], dst[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tp + NP * 32 * k;
    const int q = i % CPR, v = (i / CPR) % ROWS, j = i / (CPR * ROWS);
    const int el = u0 + q * EPC, t0 = s - 1 - j - (v >= 4 && v < 8 ? 1 : 0);
    cmax[k] = i < TOTAL && el < d && t0 >= 0 ? t0 / TC : -1;
    dst[k] = (j * ROWS + v) * UNITS + q * EPC;
    src0[k] = gx;
    stride[k] = 0;
    if (cmax[k] >= 0) {
      const size_t bt = b * s + t0;
      if (v < 4) {
        src0[k] = gx + (bt * 4 + v) * d + el;
        stride[k] = (long long)TC * 4 * d;
      } else if (v == 4) {
        src0[k] = hs + bt * d + el;
        stride[k] = (long long)TC * d;
      } else if (v < 8) {
        src0[k] = kept + (bt * 3 + (v - 5)) * d + el;
        stride[k] = (long long)TC * 3 * d;
      } else {
        src0[k] = dhs + bt * d + el;
        stride[k] = (long long)TC * d;
      }
    }
  }
  // chunk c's inputs into ring stage c % NS, zeros where t or the unit is
  // out of range; one commit group a call, empty or not
  auto issue = [&](int c) {
    T* stage = ring + (size_t)(c % NS) * TC * ROWS * UNITS;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (c < nc && tp + NP * 32 * k < TOTAL) {
        const bool ok = c <= cmax[k];
        hopper::cp_async16(stage + dst[k], ok ? src0[k] - c * stride[k] : gx,
                           ok ? 16 : 0);
      }
    }
    hopper::cp_async_commit();
  };

  // chunk c's coefficients from its inputs in the ring
  auto compute = [&](int c) {
    const T* stage = ring + (size_t)(c % NS) * TC * ROWS * UNITS + unit;
    float4* kb = coefs + (size_t)(c & 1) * TC * NCOEF * UNITS + unit;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int j = (w + NP * i) * SPW + sub, t = s - 1 - c * TC - j;
      if (t < 0) continue;
      const T* e = stage + j * ROWS * UNITS;
      float gi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) gi[k] = slstm::to_f32(e[k * UNITS]);
      float h = init[0], cc = init[1], n = init[2], m = init[3];
      if (t > 0) {
        h = slstm::to_f32(e[4 * UNITS]);
        cc = slstm::to_f32(e[5 * UNITS]);
        n = slstm::to_f32(e[6 * UNITS]);
        m = slstm::to_f32(e[7 * UNITS]);
      }
      const float dy = slstm::to_f32(e[8 * UNITS]);
      const slstm::Step st = slstm::cell(gi, rk, h, cc, n, m);
      const slstm::Coef co = slstm::coef(st, rk, h, cc, n, dy);
      float4* kj = kb + j * NCOEF * UNITS;
      kj[0] = co.a;
      kj[UNITS] = co.b;
      kj[2 * UNITS] = co.c;
      kj[3 * UNITS] = co.bias;
      kj[4 * UNITS] = co.p;
    }
  };

  // chunk c's dpre from the carried gradients the chain left: dgx, dr
  auto finish = [&](int c) {
    const float4* kb = coefs + (size_t)(c & 1) * TC * NCOEF * UNITS + unit;
    const float4* gb = grads + (size_t)(c & 1) * TC * UNITS + unit;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int j = (w + NP * i) * SPW + sub, t = s - 1 - c * TC - j;
      if (t < 0) continue;
      const float4* kj = kb + j * NCOEF * UNITS;
      slstm::Coef co;
      co.b = kj[UNITS];
      co.c = kj[2 * UNITS];         // c.w: the h the step started from
      co.p = kj[4 * UNITS];
      float dp[4];
      slstm::dpre(co, gb[j * UNITS], dp);
      if (live) {
        T* out = dgx + ((b * s + t) * 4) * d + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          out[(size_t)k * d] = slstm::from_f32<T>(dp[k]);
          dr[k] = fmaf(dp[k], co.c.w, dr[k]);
        }
      }
    }
  };

  for (int c = 0; c < NS - 1; ++c) issue(c);
  hopper::cp_async_wait<NS - 2>();
  producers_sync();
  compute(0);
  block_sync();
  for (int p = 0; p <= nc; ++p) {
    issue(p + NS - 1);             // into chunk p - 1's stage, read in p - 2
    if (p >= 1) finish(p - 1);
    hopper::cp_async_wait<NS - 2>();  // chunk p + 1 is in
    producers_sync();
    if (p + 1 < nc) compute(p + 1);   // the buffer finish(p - 1) just read
    block_sync();
  }
  // dr's parts, one a (producer warp, step lane group), summed in that
  // order by the first producer warp
  hopper::cp_async_wait<0>();
  producers_sync();
  float* parts = reinterpret_cast<float*>(smem);  // [NP * SPW][4][UNITS]
#pragma unroll
  for (int k = 0; k < 4; ++k)
    parts[((w * SPW + sub) * 4 + k) * UNITS + unit] = dr[k];
  producers_sync();
  if (w == 0 && sub == 0 && live) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float sum = 0.f;
      for (int i = 0; i < NP * SPW; ++i) sum += parts[(i * 4 + k) * UNITS + unit];
      dr_rows[(b * 4 + k) * d + u] = sum;
    }
  }
  block_sync();
}

template <typename T>
int launch(const void* const in[13], void* const out[5], float* dr_rows,
           int b, int s, int d, cudaStream_t stream) {
  if (d * sizeof(T) % 16) return (int)cudaErrorInvalidValue;
  auto c = [&](int i) { return static_cast<const T*>(in[i]); };
  auto o = [&](int i) { return static_cast<T*>(out[i]); };
  constexpr size_t smem = blk::smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      slstm_scan_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d + blk::UNITS - 1) / blk::UNITS, b);
  slstm_scan_bwd<T><<<grid, blk::THREADS, smem, stream>>>(
      c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8), c(9), c(10),
      c(11), c(12), o(0), dr_rows, o(1), o(2), o(3), o(4), s, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; d * sizeof(T) a multiple of 16 (else
// cudaErrorInvalidValue) and gx, hs, kept, dhs on 16-byte boundaries.  in:
// gx, r, h0, c0, n0, m0, hs, kept, dhs, and the last carry's gradient dh,
// dc, dn, dm; out: dgx, then the initial carry's gradient dh0, dc0, dn0,
// dm0; dr_rows: [B, 4, d] float32.  Returns cudaGetLastError() after the
// launch (0 when it was accepted).
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
  if (dtype == 0)
    return launch<float>(in, out, rows, b, s, d, stream);
  return launch<__nv_bfloat16>(in, out, rows, b, s, d, stream);
}
