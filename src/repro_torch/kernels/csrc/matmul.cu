// Tiled matrix product C = A @ B (the paper's compute-intensive node) for
// Hopper, sm_90a: three kernels, one per kind of input, chosen by the
// wrapper (repro_torch/kernels/matmul.py::matmul_path).
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::_mm_kernel (launched
// by matmul_pallas), which kept a float32 accumulator in VMEM scratch
// across the K grid axis and flushed it on the last K step.  Same function:
//   a [M, K], b [K, N], contiguous, both float32 or both bfloat16;
//   c [M, N] = a @ b summed in float32, stored in a's dtype.
//
// Bound.  2 M N K operations against (M K + K N + M N) elements: at the
// node path's 4096^3, 137 GFLOP against 201 MB in float32, far above the
// ridge, so bound by operations: 2.05 ms at the 67 TFLOP/s float32 peak,
// 0.139 ms at the 989 TFLOP/s bfloat16 tensor-core peak.  Blocks run in
// parallel and in no order, so the TPU's sequential K axis becomes a loop
// inside each block.
//
// 1. bfloat16 with rows of a multiple of 16 bytes and 16-byte aligned
//    pointers (mm_wgmma_bf16): the tensor cores.  A block of three
//    warpgroups owns a 128 x 256 tile of C.  Warpgroup 0 is the producer:
//    it gives up registers (setmaxnreg 40) and one thread keeps a 4-stage
//    ring of [128 x 64] A and [64 x 256] B slices full with TMA loads
//    (128-byte swizzle; B as four [64 x 64] boxes), each stage guarded by
//    a "full" mbarrier (TMA bytes) and an "empty" one (one arrival per
//    consumer warp).  Warpgroups 1 and 2 take 232 registers each and own
//    64 rows of the tile: per stage, four wgmma m64n256k16 bf16 -> f32
//    from shared memory, A K-major, B read N-major through the transpose
//    bit (so B is never rearranged).  A stage is released when the wgmmas
//    of the next one are in flight (wgmma.wait_group 1).  Ragged M, N and
//    K: TMA fills out-of-bounds elements with zeros and the epilogue's
//    stores of bfloat16 pairs are masked.
// 2. float32 with rows of a multiple of 16 bytes and 16-byte aligned
//    pointers (mm_f32_pipelined): float32 FMAs on the CUDA cores (TF32
//    would miss the reference's 2e-4).  256 threads own a 128 x 256 tile;
//    K steps of 32 go through a 4-stage shared ring (200 KiB, one block
//    an SM) filled by 16-byte cp.async (no register round trip; zero fill
//    past the edges), with one barrier a step.  Each thread holds an
//    8 x 16 block of C in 128 registers: a warp covers 32 x 128, its lanes
//    4 x 8, so a quarter-warp reads one row of A (a broadcast) and 128
//    contiguous bytes of B, and the four rows a warp reads at once fall on
//    distinct banks (rows padded to 36 floats).  A stays row-major in
//    shared memory and is read as float4 along K, double-buffered in
//    registers.  Every element is summed in k order, no split-K.
// 3. Everything else (mm_kernel): a row that is not a multiple of 16
//    bytes, a pointer off a 16-byte boundary, K = 0.  The first design of
//    this kernel: 128 x 128 tiles, K in steps of 8 staged through
//    registers into shared memory, an 8 x 8 register block a thread,
//    float32 FMAs for both dtypes (bfloat16 converted as it loads: the
//    products of two bfloat16 values are exact in float32), ragged edges
//    masked in the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// -- 3. the general kernel ----------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 8;  // tile of C and step of K
constexpr int NTH = 256;                   // threads a block (16 x 16)
constexpr int HALF = 64;                   // a thread's two runs, apart

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NTH, 2)
    mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float as[BK][BM];  // A slice, k-major
  __shared__ __align__(16) float bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // what each thread loads: 4 of A's row ar, from column ak; 4 of B's row
  // bk, from column bc
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const int bk = tid >> 5, bc = (tid & 31) * 4;

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int gr = row0 + ar;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k0 + ak + q;
      ra[q] = (gr < m && gk < k) ? to_f32(a[(size_t)gr * k + gk]) : 0.f;
    }
    const int gk = k0 + bk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gc = col0 + bc + q;
      rb[q] = (gk < k && gc < n) ? to_f32(b[(size_t)gk * n + gc]) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (k > 0) load(0);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) as[ak + q][ar] = ra[q];
    *reinterpret_cast<float4*>(&bs[bk][bc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (k0 + BK < k) load(k0 + BK);  // next slices, while these multiply
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk][HALF + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][HALF + tx * 4]);
      const float fa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float fb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : HALF + ty * 4 + i - 4);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + (j < 4 ? tx * 4 + j : HALF + tx * 4 + j - 4);
      if (gc < n) store(c + (size_t)gr * n + gc, acc[i][j]);
    }
  }
}


// -- 1. bfloat16: TMA + wgmma -------------------------------------------------

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int NTH = 384;                       // producer + 2 consumers
constexpr int A_BYTES = BM * BK * 2;           // one [128 x 64] box
constexpr int B_BOX = BK * 64 * 2;             // one [64 x 64] box of B
constexpr int B_BYTES = (BN / 64) * B_BOX;
constexpr int STAGE = A_BYTES + B_BYTES;       // 48 KiB
constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;

__global__ void __launch_bounds__(wg::NTH, 1)
    mm_wgmma_bf16(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (k + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                 // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                     // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* sa = tiles + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(sa, &map_a, &full[s], kt * BK, row0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(sa + A_BYTES + j * B_BOX, &map_b, &full[s],
                      col0 + 64 * j, kt * BK);
      }
    }
  } else {                                     // consumer warpgroups
    setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;      // rows 64 cw .. of the tile
    const int t = threadIdx.x % 128;
    // no zero fill: the first product overwrites (scale-d 0), so only
    // wgmmas define the accumulator and ptxas need not serialize them
    float acc[128];
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a_base = smem_u32(tiles + s * STAGE) + cw * 64 * 128;
      const uint32_t b_base = smem_u32(tiles + s * STAGE + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16_ss_tb(acc, smem_desc(a_base + kk * 32, 16, 1024, 1),
                               smem_desc(b_base + kk * 16 * 128, B_BOX, 1024,
                                         1),
                               kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                         // the previous stage is read
      if (kt > 0 && t % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(acc);

    const int w = t / 32, l = t % 32;
    const int r_lo = row0 + cw * 64 + 16 * w + l / 4;
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int row = r_lo + 8 * ((i / 2) % 2);
      const int col = col0 + 8 * (i / 4) + 2 * (l % 4);
      if (row < m && col < n)                  // n is even: col + 1 < n too
        *reinterpret_cast<__nv_bfloat162*>(c + (size_t)row * n + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

}  // namespace wg

// -- 2. float32: cp.async ring + FMA ------------------------------------------

namespace pf {
constexpr int BM = 128, BN = 256, BK = 32, STAGES = 4, NTH = 256;
constexpr int LDA = BK + 4;                    // A's row stride in floats
constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * BN;
constexpr int STAGE = A_FLOATS + B_FLOATS;
constexpr int SMEM = STAGES * STAGE * 4;       // 200 KiB: one block an SM

// Thread (warp w, lane l) owns rows 32 (w / 2) + l / 8 + 4 i (i < 8) and
// columns 128 (w % 2) + 32 h + 4 (l % 8) + {0..3} (h < 4) of the tile.
__device__ __forceinline__ int tile_row(int w, int l, int i) {
  return 32 * (w >> 1) + (l >> 3) + 4 * i;
}
__device__ __forceinline__ int tile_col(int w, int l, int h) {
  return 128 * (w & 1) + 32 * h + 4 * (l & 7);
}

__global__ void __launch_bounds__(NTH, 1)
    mm_f32_pipelined(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int m, int n, int k) {
  extern __shared__ __align__(16) float fsmem[];
  const int tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk = (k + BK - 1) / BK;

  auto load_stage = [&](int kt) {
    float* as = fsmem + (kt % STAGES) * STAGE;
    float* bs = as + A_FLOATS;
    const int k0 = kt * BK;
#pragma unroll
    for (int q = 0; q < BM * BK / 4 / NTH; ++q) {  // A: 128 rows x 8 chunks
      const int idx = tid + q * NTH;
      const int r = idx / (BK / 4), ch = idx % (BK / 4);
      const int gr = row0 + r, gk = k0 + 4 * ch;
      const bool in = gr < m && gk < k;        // k % 4 == 0: whole chunks
      cp_async16(as + r * LDA + 4 * ch, in ? a + (size_t)gr * k + gk : a,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int q = 0; q < BK * BN / 4 / NTH; ++q) {  // B: 32 rows x 64 chunks
      const int idx = tid + q * NTH;
      const int r = idx / (BN / 4), ch = idx % (BN / 4);
      const int gk = k0 + r, gc = col0 + 4 * ch;
      const bool in = gk < k && gc < n;        // n % 4 == 0: whole chunks
      cp_async16(bs + r * BN + 4 * ch, in ? b + (size_t)gk * n + gc : b,
                 in ? 16 : 0);
    }
  };

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();               // this thread's slice of kt
    __syncthreads();                           // everyone's; kt - 1 is read
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const float* as = fsmem + (kt % STAGES) * STAGE;
    const float* bs = as + A_FLOATS;
    // A's fragments, 4 k of each of the thread's 8 rows, double-buffered:
    // the next 4 k load while these multiply
    float4 fa[2][8];
    auto load_a = [&](int kq, int buf) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        fa[buf][i] = *reinterpret_cast<const float4*>(
            as + tile_row(w, l, i) * LDA + kq);
    };
    load_a(0, 0);
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      const int cur = (kq / 4) & 1;
      if (kq + 4 < BK) load_a(kq + 4, cur ^ 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float fb[16];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (kq + kk) * BN + tile_col(w, l, h));
          fb[4 * h] = v.x;
          fb[4 * h + 1] = v.y;
          fb[4 * h + 2] = v.z;
          fb[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 f = fa[cur][i];
          const float av = kk == 0 ? f.x : kk == 1 ? f.y : kk == 2 ? f.z : f.w;
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av, fb[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + tile_row(w, l, i);
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int gc = col0 + tile_col(w, l, h);
      if (gc < n)
        *reinterpret_cast<float4*>(c + (size_t)gr * n + gc) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

}  // namespace pf

}  // namespace

// Path 1: bfloat16, K and N multiples of 8, a and b 16-byte aligned, K > 0
// (the wrapper checks).  Returns 0 or a CUDA error code.
extern "C" int repro_matmul_wgmma_bf16(const void* a, const void* b, void* c,
                                       int m, int n, int k,
                                       cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const cuuint64_t a_dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t a_strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t a_box[2] = {wg::BK, wg::BM};
  const cuuint64_t b_dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t b_strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t b_box[2] = {64, wg::BK};
  int err = bf16_map(&map_a, 2, a, a_dims, a_strides, a_box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = bf16_map(&map_b, 2, b, b_dims, b_strides, b_box,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      wg::mm_wgmma_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + wg::BN - 1) / wg::BN, (m + wg::BM - 1) / wg::BM);
  wg::mm_wgmma_bf16<<<grid, wg::NTH, wg::SMEM, stream>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), m, n, k);
  return (int)cudaGetLastError();
}

// Path 2: float32, K and N multiples of 4, a, b and c 16-byte aligned,
// K > 0 (the wrapper checks).  Returns 0 or a CUDA error code.
extern "C" int repro_matmul_f32_pipelined(const void* a, const void* b,
                                          void* c, int m, int n, int k,
                                          cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      pf::mm_f32_pipelined, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pf::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + pf::BN - 1) / pf::BN, (m + pf::BM - 1) / pf::BM);
  pf::mm_f32_pipelined<<<grid, pf::NTH, pf::SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), m, n, k);
  return (int)cudaGetLastError();
}

// Path 3, the general kernel.
// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int dtype,
                            int m, int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (dtype == 0)
    mm_kernel<float><<<grid, NTH, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), m, n, k);
  else
    mm_kernel<__nv_bfloat16><<<grid, NTH, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(c), m, n, k);
  return (int)cudaGetLastError();
}
