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
// Design.  The copy is of bytes, so one kernel serves every dtype.  What
// limits a copy is how many bytes are in flight to and from memory and how
// well the reads and writes stream; a grid-stride loop of 16-byte words
// keeps only a few words a thread in flight.  So when x and y sit on
// 16-byte boundaries, the body (all whole 16-byte words) moves by 1-D bulk
// TMA through a ring of kStages shared-memory stages of kStageBytes each,
// in kBlocksPerSm persistent blocks an SM, and one elected thread a block
// issues everything.  It loads a stage with cp.async.bulk (completion on
// the stage's mbarrier), stores it with a bulk store in a bulk group, and
// reloads the stage once the group that stores it has read it
// (wait_group.read), so kStages - 1 loads and the stores stay in flight
// with no registers spent on data.  The body's stage-sized pieces are
// dealt to the blocks in turn (piece p to block p mod grid), so at any
// moment the card reads and writes one window of the buffer; one
// contiguous range a block was slower on the H100 (PERF.md section 6), and
// so was the grid-stride word kernel.  Every load and store carries an L2
// evict-first policy: nothing copied is read again.  The bytes past the
// last whole word go one a thread (copy_bytes).  When x does not sit on a
// 16-byte boundary (a contiguous view at an odd offset; y from the
// allocator always does), the whole copy goes one byte a thread: right,
// and slow, and never taken on the node path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NTH = 256;                  // threads of a copy_bytes block
constexpr int kStages = 3;                // ring stages a block
constexpr int kStageBytes = 32 * 1024;    // bytes a stage
constexpr int kBlocksPerSm = 2;           // persistent blocks an SM
static_assert(kStageBytes % 16 == 0, "bulk copies move whole 16-byte words");

// L2 evict-first, for data that is not read again
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(hopper::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;" ::"l"(dst),
      "r"(hopper::smem_u32(src)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the stores of all but the newest N bulk groups have read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// the stores of all but the newest N bulk groups are done
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// y[0 : n_bytes) = x[0 : n_bytes), n_bytes a multiple of 16, x and y on
// 16-byte boundaries, in pieces of kStageBytes: block i moves pieces i,
// i + grid, i + 2 grid, ...  One warp a block; lane 0 works.
__global__ void __launch_bounds__(32)
    copy_ring(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
              long long n_bytes) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  const long long all = (n_bytes + kStageBytes - 1) / kStageBytes;
  if (blockIdx.x >= all) return;
  const long long n_pieces = (all - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long step = (long long)gridDim.x * kStageBytes;
  const long long first = (long long)blockIdx.x * kStageBytes;
  const uint64_t policy = evict_first_policy();
  for (int s = 0; s < kStages; ++s) hopper::mbar_init(&full[s], 1);
  hopper::fence_barrier_init();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

  auto piece_bytes = [&](long long p) {
    return (uint32_t)min((long long)kStageBytes, n_bytes - first - p * step);
  };
  auto load = [&](long long p) {
    const int s = (int)(p % kStages);
    const uint32_t bytes = piece_bytes(p);
    hopper::mbar_expect_tx(&full[s], bytes);
    bulk_load(ring + (size_t)s * kStageBytes, x + first + p * step, bytes,
              &full[s], policy);
  };

  for (long long p = 0; p < kStages && p < n_pieces; ++p) load(p);
  for (long long i = 0; i < n_pieces; ++i) {
    const int s = (int)(i % kStages);
    hopper::mbar_wait(&full[s], (uint32_t)((i / kStages) & 1));
    bulk_store(y + first + i * step, ring + (size_t)s * kStageBytes,
               piece_bytes(i), policy);
    bulk_commit();
    // the store of piece i - 1 has read its stage: load it again
    if (i >= 1 && i - 1 + kStages < n_pieces) {
      bulk_wait_read<1>();
      load(i - 1 + kStages);
    }
  }
  bulk_wait<0>();
}

__global__ void __launch_bounds__(NTH)
    copy_bytes(const uint8_t* __restrict__ x, uint8_t* __restrict__ y,
               long long n_bytes) {
  const long long stride = (long long)gridDim.x * NTH;
  for (long long i = (long long)blockIdx.x * NTH + threadIdx.x; i < n_bytes;
       i += stride)
    y[i] = x[i];
}

int sm_count() {
  int sms = 132;
  int dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

int grid_for_bytes(long long n_bytes) {
  const long long want = (n_bytes + NTH * 4 - 1) / (NTH * 4);
  const long long most = (long long)sm_count() * 8;  // 8 blocks of 256 an SM
  return (int)(want < 1 ? 1 : (want < most ? want : most));
}

// The bulk ring over n_bytes (a multiple of 16), at most kBlocksPerSm
// blocks an SM.
int launch_ring(const uint8_t* x, uint8_t* y, long long n_bytes,
                cudaStream_t stream) {
  constexpr int smem = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      copy_ring, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long pieces = (n_bytes + kStageBytes - 1) / kStageBytes;
  const long long most = (long long)sm_count() * kBlocksPerSm;
  const long long grid = pieces < most ? pieces : most;
  copy_ring<<<(unsigned)grid, 32, smem, stream>>>(x, y, n_bytes);
  return (int)cudaGetLastError();
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
    copy_bytes<<<grid_for_bytes(n_bytes), NTH, 0, stream>>>(xb, yb, n_bytes);
    return (int)cudaGetLastError();
  }
  const long long body = n_bytes / 16 * 16;
  const long long tail = n_bytes - body;
  if (body > 0) {
    const int err = launch_ring(xb, yb, body, stream);
    if (err) return err;
  }
  if (tail > 0)
    copy_bytes<<<1, NTH, 0, stream>>>(xb + body, yb + body, tail);
  return (int)cudaGetLastError();
}

// Bytes a stage of the ring: the tests and chip_smoke.py place their
// sizes at its edges.
extern "C" int repro_copy_stage_bytes() { return kStageBytes; }
