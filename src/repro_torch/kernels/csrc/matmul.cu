// Tiled matrix product C = A @ B (the paper's compute-intensive node) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::_mm_kernel (launched
// by matmul_pallas), which kept a float32 accumulator in VMEM scratch
// across the K grid axis and flushed it on the last K step.  Same function:
//   a [M, K], b [K, N], contiguous, both float32 or both bfloat16;
//   c [M, N] = a @ b summed in float32, stored in a's dtype.
//
// Bound.  2 M N K operations against (M K + K N + M N) elements: at the
// node path's 4096^3 that is 137 GFLOP against 201 MB in float32, ~680
// operations a byte, far above the ridge, so bound by operations: 2.05 ms
// at the 67 TFLOP/s float32 peak (0.139 ms at the 989 TFLOP/s bfloat16
// tensor-core peak).
//
// Design.  Blocks run in parallel and in no order, so the TPU's sequential
// K axis becomes a loop inside the block.  One block of 256 threads owns a
// BM x BN = 128 x 128 tile of C and walks K in steps of BK = 8: each step
// stages an [BM, BK] slice of A (stored k-major) and a [BK, BN] slice of B
// in shared memory, and every thread adds the outer products of its 8 x 8
// sub-tile into 64 float32 registers.  A thread's 8 rows (and 8 columns)
// are two runs of 4, 64 apart, so the 16-byte shared reads of a quarter
// warp fall on distinct banks.  The next step's slices are loaded into
// registers while this step's products run.  The products are float32 FMAs
// on the CUDA cores, in k order for each element: TF32 tensor cores would
// miss the reference's 2e-4.  bfloat16 inputs take the same FMA path on
// values converted to float32 as they are loaded (the products of two
// bfloat16 values are exact in float32, so this is the reference's
// arithmetic), not mma.sync or wgmma: the bfloat16 tensor-core path is a
// later change.  Ragged M, N and K are masked in the block: a load past an
// edge reads 0 and a store past it is dropped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

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
