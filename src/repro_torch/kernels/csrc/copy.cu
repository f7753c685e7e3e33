// Streaming copy into a fresh buffer (the paper's memory-intensive node) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/copy.py::_copy_kernel (launched
// by copy_pallas), which moved one (512, 1024) tile per grid cell through
// VMEM.  Same function: y = x, bit for bit, for any dtype and any size; the
// wrapper allocates y (never an alias of x).
//
// Bound.  No arithmetic: the bytes read and written over the card's memory
// rate (3.35 TB/s on an H100 SXM).  At the node path's [8192, 8192] float32
// that is 512 MiB moved, 0.160 ms at the least.
//
// Design.  The copy is of bytes, so one kernel serves every dtype.  Each
// thread moves 16 bytes a load and a store (uint4), UNROLL of them in
// flight before the first store, over a grid-stride loop of a grid sized to
// fill the SMs; neighbouring threads touch neighbouring 16-byte words, so a
// warp moves 512 contiguous bytes a request.  The bytes past the last whole
// 16-byte word go one a thread.  When x does not sit on a 16-byte boundary
// (a contiguous view at an odd offset; y from the allocator always does),
// the whole copy goes one byte a thread: right, and slow, and never taken
// on the node path.  TMA bulk copies and cache hints are left for a later
// change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;    // threads per block
constexpr int UNROLL = 4;   // 16-byte words in flight per thread

__global__ void __launch_bounds__(NTH)
    copy_words(const uint4* __restrict__ x, uint4* __restrict__ y,
               long long n_words) {
  const long long stride = (long long)gridDim.x * NTH;
  long long i = (long long)blockIdx.x * NTH + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n_words; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) y[i + u * stride] = v[u];
  }
  for (; i < n_words; i += stride) y[i] = x[i];
}

__global__ void __launch_bounds__(NTH)
    copy_bytes(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
               long long n_bytes) {
  const long long stride = (long long)gridDim.x * NTH;
  for (long long i = (long long)blockIdx.x * NTH + threadIdx.x; i < n_bytes;
       i += stride)
    y[i] = x[i];
}

int grid_for(long long n_items, int per_thread) {
  int sms = 132;
  int dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (n_items + (long long)NTH * per_thread - 1) /
                   ((long long)NTH * per_thread);
  long long most = (long long)sms * 8;  // 8 blocks of 256 threads an SM
  return (int)(want < 1 ? 1 : (want < most ? want : most));
}

}  // namespace

// y[0 : n_bytes) = x[0 : n_bytes); y 16-byte aligned.  Returns
// cudaGetLastError() after the launches (0 when all were accepted).
extern "C" int repro_copy(const void* x, void* y, long long n_bytes,
                          cudaStream_t stream) {
  if (n_bytes <= 0) return 0;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  uint8_t* yb = static_cast<uint8_t*>(y);
  bool aligned = ((uintptr_t)xb % 16 == 0) && ((uintptr_t)yb % 16 == 0);
  if (!aligned) {
    copy_bytes<<<grid_for(n_bytes, 4), NTH, 0, stream>>>(xb, yb, n_bytes);
    return (int)cudaGetLastError();
  }
  long long n_words = n_bytes / 16;
  long long tail = n_bytes - n_words * 16;
  if (n_words > 0)
    copy_words<<<grid_for(n_words, UNROLL), NTH, 0, stream>>>(
        reinterpret_cast<const uint4*>(xb), reinterpret_cast<uint4*>(yb),
        n_words);
  if (tail > 0)
    copy_bytes<<<1, NTH, 0, stream>>>(xb + n_words * 16, yb + n_words * 16,
                                      tail);
  return (int)cudaGetLastError();
}
