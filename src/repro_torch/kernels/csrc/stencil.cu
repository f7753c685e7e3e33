// One 5-point Jacobi step with a zero (Dirichlet) boundary (the paper's
// cache-intensive node, the body of the Heat app) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/stencil.py::_stencil_kernel
// (launched by stencil_pallas).  Same function:
//   u [B, H, W], contiguous, float32 or bfloat16;
//   out[b, i, j] = 0.25 * (u[i-1, j] + u[i+1, j] + u[i, j-1] + u[i, j+1]),
//   a neighbour outside the domain reads 0; out in u's dtype.
// The sum is taken in float32, in the order up + down + left + right, and
// rounded to u's dtype once (the reference sums bfloat16 in bfloat16).
//
// Bound.  4 operations a point against 2 x sizeof(T) bytes: far below the
// card's ridge, so bound by bytes, the grid read once and written once at
// 3.35 TB/s.  A grid that fits in the 50 MB L2 (the node path's
// [1, 2048, 2048] float32 is 16 MiB in and 16 MiB out) runs from L2 when
// swept repeatedly, and can then beat that bound.
//
// Design.  The TPU kernel read its tile and the four clamped neighbour
// tiles (five BlockSpecs, masks at the domain edge).  Here one block of
// 64 x 4 threads owns a tile of TH = 32 rows by TW = 64 columns and loads
// it with a one-cell halo into shared memory, zero outside the domain, so
// the halo costs (34 x 66) / (32 x 64) = 1.10 reads a point, the extra
// tenth mostly from L2.  Each thread then writes 8 points of one column;
// a warp's 32 threads read 32 neighbouring shared words and write 32
// neighbouring points.  Any H and W: the edge tiles mask their loads and
// stores, with no (8, 128) gate.  Vector loads and a TMA halo are left for
// a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 64;            // columns a tile
constexpr int TH = 32;            // rows a tile
constexpr int NX = 64, NY = 4;    // threads a block
constexpr int LDS = TW + 2;       // shared row stride (halo included)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NX* NY)
    stencil_kernel(const T* __restrict__ u, T* __restrict__ out, int h,
                   int w) {
  __shared__ float s[TH + 2][LDS];
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const size_t plane = (size_t)h * w;
  const T* ub = u + blockIdx.z * plane;
  T* ob = out + blockIdx.z * plane;
  const int tid = threadIdx.y * NX + threadIdx.x;

  for (int idx = tid; idx < (TH + 2) * LDS; idx += NX * NY) {
    const int r = idx / LDS, c = idx - r * LDS;
    const int gi = i0 + r - 1, gj = j0 + c - 1;
    float v = 0.f;
    if (gi >= 0 && gi < h && gj >= 0 && gj < w)
      v = to_f32(ub[(size_t)gi * w + gj]);
    s[r][c] = v;
  }
  __syncthreads();

  const int c = threadIdx.x, gj = j0 + c;
  if (gj >= w) return;
#pragma unroll
  for (int k = 0; k < TH / NY; ++k) {
    const int r = threadIdx.y + k * NY, gi = i0 + r;
    if (gi < h) {
      const float sum =
          s[r][c + 1] + s[r + 2][c + 1] + s[r + 1][c] + s[r + 1][c + 2];
      store(ob + (size_t)gi * w + gj, 0.25f * sum);
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int repro_stencil(const void* u, void* out, int dtype, int b,
                             int h, int w, cudaStream_t stream) {
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b), block(NX, NY);
  if (dtype == 0)
    stencil_kernel<float><<<grid, block, 0, stream>>>(
        static_cast<const float*>(u), static_cast<float*>(out), h, w);
  else
    stencil_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(u),
        static_cast<__nv_bfloat16*>(out), h, w);
  return (int)cudaGetLastError();
}
