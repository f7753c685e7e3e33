// Hopper building blocks shared by the hand-written sm_90a kernels: TMA
// tensor maps and loads, mbarriers, cp.async, the TF32 mma.sync product and
// the 3xTF32 splits, the wgmma instructions with their shared-memory
// descriptors, and the bfloat16 [64 x D] tiles that flash attention's wgmma
// kernels, forward and backward, load and multiply, all as raw PTX (no
// CUTLASS or CuTe: a source that includes this builds in seconds).
//
// Tensor maps are encoded on the host for every call by the driver's
// cuTensorMapEncodeTiled, found with dlsym in the libcuda.so.1 that the
// process has already loaded (PyTorch loads it), so the libraries link
// against no libcuda and need no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// -- host: tensor maps --------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bfloat16 tensor map of `rank` dimensions, innermost first: dims[i]
// elements, strides[i] bytes between steps of dimension i + 1, boxes of
// box[i] elements.  Out-of-bounds elements of a box load as zeros (and
// count toward the box's bytes).  Returns 0, or a CUDA error code.
inline int bf16_map(CUtensorMap* map, int rank, const void* ptr,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorInitializationError;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// -- device: shared memory, barriers, copies ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (128-byte swizzled tiles must
// start on one; ask for 1 KiB more dynamic shared memory than the tiles)
__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and expect `bytes` more of TMA traffic on this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// step i of a ring of NS stages: its stage, and the parity of the phase
// (of that stage's barriers) it waits for
template <int NS>
__device__ __forceinline__ int ring_stage(int i) {
  return (int)((unsigned)i % NS);
}
template <int NS>
__device__ __forceinline__ uint32_t ring_parity(int i) {
  return ((unsigned)i / NS) & 1;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// 16 bytes global -> shared without a register round trip; src_bytes 0
// fills the 16 bytes with zeros (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// -- device: TF32 tensor-core products (mma.sync) -----------------------------

// v as a TF32 pair: hi = v rounded to TF32, lo = the rest rounded to TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// v as a TF32 pair without rounding: the high part is v itself (the tensor
// cores read only a TF32 operand's top 19 bits, so they take v truncated),
// the low part v minus that truncation, exact in float32 (and truncated in
// turn); two instructions an element, where split_tf32 takes three
__device__ __forceinline__ uint32_t hi_tf32(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t lo_tf32(float v) {
  return __float_as_uint(v -
                         __uint_as_float(__float_as_uint(v) & 0xffffe000u));
}

// d += a b for one 16 x 8 x 8 TF32 tile (row-major A, column-major B).
// Fragment layouts (lane = 4 g + q): A rows g, g + 8 and columns q, q + 4
// (a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)); B rows q,
// q + 4 and column g; C row g (c0, c1) and g + 8 (c2, c3), columns 2 q and
// 2 q + 1.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// -- device: warpgroups and wgmma ---------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin the accumulator registers at this point of the program: reads after
// a wgmma_wait then cannot move above it, writes before a wgmma cannot
// move below it.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor.  layout 1: 128-byte swizzle, 2: 64-byte,
// 3: 32-byte.
// K-major operands: sbo = bytes between groups of 8 rows (lbo unused).
// MN-major operands: lbo = bytes between swizzle-wide column blocks, sbo =
// bytes between groups of 8 rows of K.  The tile must start on a 1024-byte
// boundary; steps along K inside it move the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) |
         ((uint64_t)layout << 62);
}

// Accumulator layout of every m64nN instruction: in a warpgroup, thread t
// (warp w = t / 32, lane l) holds element i of its fragment at row
// 16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) + i % 2.

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B in shared memory;
// B MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_m64n256k16_ss_tb(float (&d)[128], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory;
// B K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A in registers (the bfloat16
// fragment of the accumulator layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n16k16_rs_tb(float (&d)[8],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A in registers (the bfloat16
// fragment of the accumulator layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_rs_tb(float (&d)[16],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the bfloat16
// fragment of the accumulator layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 80] += A[64 x 16] B[16 x 80], A in registers (the bfloat16
// fragment of the accumulator layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n80k16_rs_tb(float (&d)[40],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the bfloat16
// fragment of the accumulator layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- bfloat16 [64 x D] tiles for wgmma ---------------------------------------

// A [64 x D] bfloat16 tile as the TMA lays it in shared memory, on a
// 1024-byte boundary: boxes of BOX columns x 64 rows, box j at
// j BOX_BYTES, each swizzled over SW bytes.  SW is the widest swizzle whose
// box divides D (128 bytes at D = 64 and 128, 64 at D = 32) or, at D = 80,
// 128 bytes over the first 64 columns with the last TAIL = 16 columns in a
// box of their own right after it (at TAIL_AT = 8 KiB), swizzled over 32
// bytes (2 KiB), loaded through a second map (Bf16Maps): a D-80 tile is
// two TMA loads, not five 16-column ones.  wgmma reads a tile K-major (its
// 64 rows are the product's M or N, D its K: a k-step of 16 columns lies
// inside one box, in that box's layout) or MN-major (D is N, its rows K:
// the boxes are the descriptor's column blocks, BOX_BYTES apart; at D = 80
// an m64n64k16 over the wide box and an m64n16k16 over the tail, whose
// accumulators are the registers one m64n80k16 would use for those columns).
template <int D>
struct Bf16Tile {
  static_assert(D % 16 == 0, "a bfloat16 tile is whole k-steps of 16");
  static constexpr int SW =
      D % 64 == 0 || D == 80 ? 128 : D % 32 == 0 ? 64 : 32;
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int BOX = SW / 2;                     // D columns a box
  static constexpr int BOX_BYTES = 64 * SW;              // a box of 64 rows
  static constexpr int WIDE = D / BOX * BOX;             // columns in boxes
  static constexpr int TAIL = D - WIDE;                  // 16 at D = 80
  static constexpr int TAIL_AT = WIDE / BOX * BOX_BYTES;
  static constexpr int BYTES = 64 * D * 2;               // a [64 x D] tile
  static_assert(TAIL == 0 || TAIL == 16, "a tail box is 16 columns");
};

// the two maps of a tile with a tail box: the SW boxes', the tail's
struct Bf16SplitMaps {
  CUtensorMap wide, tail;
};
template <int D>
using Bf16Maps = typename std::conditional<Bf16Tile<D>::TAIL == 0,
                                           CUtensorMap, Bf16SplitMaps>::type;

// host: the map(s) of `mats` contiguous [len x D] bfloat16 matrices at ptr,
// in Bf16Tile<D> boxes; a box past len loads zeros
template <int D>
inline int bf16_tile_map(Bf16Maps<D>* map, const void* ptr, int len,
                         int mats) {
  using T = Bf16Tile<D>;
  const cuuint64_t dims[3] = {D, (cuuint64_t)len, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {D * 2, (cuuint64_t)len * D * 2};
  const cuuint32_t box[3] = {T::BOX, 64, 1};
  const CUtensorMapSwizzle sw = T::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  if constexpr (T::TAIL == 0) {
    return bf16_map(map, 3, ptr, dims, strides, box, sw);
  } else {
    const cuuint32_t tail[3] = {T::TAIL, 64, 1};
    const int err = bf16_map(&map->wide, 3, ptr, dims, strides, box, sw);
    return err ? err
               : bf16_map(&map->tail, 3, ptr, dims, strides, tail,
                          CU_TENSOR_MAP_SWIZZLE_32B);
  }
}

// the tile at rows r0 of matrix `mat` of map into dst, on bar
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const Bf16Maps<D>* map,
                                              uint64_t* bar, int r0, int mat) {
  using T = Bf16Tile<D>;
  if constexpr (T::TAIL == 0) {
#pragma unroll
    for (int j = 0; j < D / T::BOX; ++j)
      tma_load_3d(dst + j * T::BOX_BYTES, map, bar, j * T::BOX, r0, mat);
  } else {
#pragma unroll
    for (int j = 0; j < T::WIDE / T::BOX; ++j)
      tma_load_3d(dst + j * T::BOX_BYTES, &map->wide, bar, j * T::BOX, r0,
                  mat);
    tma_load_3d(dst + T::TAIL_AT, &map->tail, bar, T::WIDE, r0, mat);
  }
}

// d[64 x 64] = A B^T: A and B the tiles at shared addresses a and b, both
// read K-major
template <int D>
__device__ __forceinline__ void wgmma_tile_nt(float (&d)[32], uint32_t a,
                                              uint32_t b) {
  using T = Bf16Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if (16 * kk < T::WIDE) {
      const uint32_t off =
          (16 * kk / T::BOX) * T::BOX_BYTES + (16 * kk % T::BOX) * 2;
      wgmma_m64n64k16_ss(d, smem_desc(a + off, 16, 8 * T::SW, T::LAYOUT),
                         smem_desc(b + off, 16, 8 * T::SW, T::LAYOUT), kk > 0);
    } else {   // the tail box's k-step, 32-byte swizzled
      wgmma_m64n64k16_ss(d, smem_desc(a + T::TAIL_AT, 16, 8 * 32, 3),
                         smem_desc(b + T::TAIL_AT, 16, 8 * 32, 3), 1);
    }
  }
}

// d[64 x D] += A B: A [64 x 64] as bfloat16 register fragments a[kk] (the
// accumulator layout, k-steps of 16), B the tile at shared address b, read
// MN-major
template <int D>
__device__ __forceinline__ void wgmma_tile_rs(float (&d)[D / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b) {
  using T = Bf16Tile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db =
        smem_desc(b + kk * 16 * T::SW, T::BOX_BYTES, 8 * T::SW, T::LAYOUT);
    static_assert(D == 32 || D == 64 || D == 80 || D == 128,
                  "no m64nDk16 wrapper for this D");
    if constexpr (D == 32) {
      wgmma_m64n32k16_rs_tb(d, a[kk], db);
    } else if constexpr (D == 64) {
      wgmma_m64n64k16_rs_tb(d, a[kk], db);
    } else if constexpr (D == 80) {   // columns 0..63, then the tail's 16
      wgmma_m64n64k16_rs_tb(*reinterpret_cast<float(*)[32]>(d), a[kk], db);
      wgmma_m64n16k16_rs_tb(
          *reinterpret_cast<float(*)[8]>(d + 32), a[kk],
          smem_desc(b + T::TAIL_AT + kk * 16 * 32, 64 * 32, 8 * 32, 3));
    } else {
      wgmma_m64n128k16_rs_tb(d, a[kk], db);
    }
  }
}

// the register A fragments were read by the wgmmas until now: keep them live
__device__ __forceinline__ void keep_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[kk][j])::"memory");
}

}  // namespace hopper
