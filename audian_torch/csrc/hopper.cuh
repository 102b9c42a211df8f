// Hopper building blocks (sm_90a) shared by the tensor-core kernels:
// TF32 and bf16 splitting, warpgroup MMAs (wgmma.mma_async, TF32 at k8 and
// bf16 at k16, A from registers and B through a shared-memory descriptor),
// mbarriers and bulk copies from device memory into shared memory.
//
// wgmma fragments (PTX's m64nNk8 .tf32 layouts), for thread x of a
// warpgroup with w = x / 32 (its warp), g = x % 32 / 4, t = x % 4:
//   A (64 x 8, registers): a0 = A[16w + g][t], a1 = A[16w + g + 8][t],
//                          a2 = A[16w + g][t + 4], a3 = A[16w + g + 8][t + 4]
//   D (64 x N, fp32):      d[4j + e] = D[16w + g + 8 (e >> 1)][8j + 2t + (e & 1)]
// and at m64nNk16 .bf16 each A register holds two bf16 along K, the lower
// column in the low half:
//   A (64 x 16):           a0 = A[16w + g][2t, 2t + 1], a1 = rows + 8,
//                          a2 = A[16w + g][2t + 8, 2t + 9], a3 = rows + 8
// B (8 x N, or 16 x N) is read from shared memory as K-major "core
// matrices" with no swizzle: eight rows along N of 16 bytes along K (four
// TF32 words or eight bf16), 128 bytes a matrix; the descriptor gives the
// byte offset between the two matrices along K (LBO) and between
// consecutive 8-row groups along N (SBO).  TF32 has no transposed form,
// and bf16 with A in registers reads B K-major here: both operands are
// K-major.
//
// A product of fp32 values a b is taken in passes over split operands:
// 3xTF32 splits a = ah + al and b = bh + bl with each part rounded to TF32
// and sums ah bl + al bh + ah bh into one fp32 accumulator, the small
// passes first; the dropped al bl and the rounding of the parts are about
// 2^-22 of |a b|, the precision of the fp32 FMA this replaces.  One TF32
// pass (ah bh) keeps about 2^-10.  The split-bf16 passes (BF16X3: ah bl +
// al bh + ah bh with bf16 parts, both rounded to nearest even; BF16X4 adds
// al bl) keep about 2^-16 of |a b|, since lo is rounded to bf16 too.
//
// Rules kept by the callers: a thread's writes to shared memory that a
// wgmma (or a bulk copy) then reads or overwrites are ordered by
// fence_async() before the barrier that publishes them; the registers of
// an A fragment are not rewritten before the wgmma group that reads them
// has retired (wait<N>); wgmma_fence() precedes each group whose
// registers were touched since the last one.

#pragma once

#include <stdint.h>

namespace hopper {

// x rounded to TF32 (cvt.rna.tf32.f32: low 13 bits zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (a, b) rounded to bf16 (to nearest even) as one register, a in the low
// half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(b), "f"(a));
  return r;
}

// the two bf16 of a register as floats: the low half, the high half
__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xFFFF0000u);
}

// (a, b) split into bf16 pairs: hi = bf16(a, b), lo = bf16(a - hi_a,
// b - hi_b), both rounded to nearest even
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_lo(hi), b - bf16_hi(hi));
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and bulk copies ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned device memory to 16-byte
// aligned shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (wgmma operand reads, bulk-copy writes)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over the first `threads` threads of the block (id 1..15)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// moves registers between warpgroups: the calling warpgroup's threads give
// theirs down to (dec) or take them up to (inc) N each
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- warpgroup MMAs ----------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of these registers across the
// asynchronous MMAs that read or write them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a no-swizzle K-major operand at shared address `addr`
// (16-byte aligned), `lbo` bytes between the two 4-word halves along K and
// `sbo` bytes between 8-row groups along N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d[4] (+)= a * B, one m64n8k8 TF32 pass: A from registers, B
// through its shared-memory descriptor; scale_d == 0 overwrites d
__device__ __forceinline__ void mma_n8(float (&d)[4],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[32] (+)= a * B, one m64n64k8 TF32 pass: A from registers, B
// through its shared-memory descriptor; scale_d == 0 overwrites d
__device__ __forceinline__ void mma_n64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[64] (+)= a * B, one m64n128k8 TF32 pass: A from registers, B
// through its shared-memory descriptor; scale_d == 0 overwrites d
__device__ __forceinline__ void mma_n128(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[68] (+)= a * B, one m64n136k8 TF32 pass: A from registers, B
// through its shared-memory descriptor; scale_d == 0 overwrites d
__device__ __forceinline__ void mma_n136(float (&d)[68],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
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
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[88] (+)= a * B, one m64n176k8 TF32 pass: A from registers, B
// through its shared-memory descriptor; scale_d == 0 overwrites d
__device__ __forceinline__ void mma_n176(float (&d)[88],
                                        const uint32_t (&a)[4],
                                        uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87}, "
      "{%88, %89, %90, %91}, %92, p, 1, 1;\n}\n"
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
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// mma_n<N>: the one of the above for N columns
template <int N>
struct Mma;
template <>
struct Mma<8> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma_n8(d, a, desc, scale_d);
  }
};
template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma_n64(d, a, desc, scale_d);
  }
};
template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma_n128(d, a, desc, scale_d);
  }
};

template <>
struct Mma<136> {
  __device__ __forceinline__ static void run(float (&d)[68],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma_n136(d, a, desc, scale_d);
  }
};
template <>
struct Mma<176> {
  __device__ __forceinline__ static void run(float (&d)[88],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma_n176(d, a, desc, scale_d);
  }
};

// d[4] (+)= a * B, one m64n8k16 bf16 pass: A from registers (bf16
// pairs), B through its shared-memory descriptor (K-major); scale_d == 0
// overwrites d
__device__ __forceinline__ void mma16_n8(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[32] (+)= a * B, one m64n64k16 bf16 pass: A from registers (bf16
// pairs), B through its shared-memory descriptor (K-major); scale_d == 0
// overwrites d
__device__ __forceinline__ void mma16_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[64] (+)= a * B, one m64n128k16 bf16 pass: A from registers (bf16
// pairs), B through its shared-memory descriptor (K-major); scale_d == 0
// overwrites d
__device__ __forceinline__ void mma16_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// mma16_n<N>: the bf16 pass of the above for N columns
template <int N>
struct Mma16;
template <>
struct Mma16<8> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma16_n8(d, a, desc, scale_d);
  }
};
template <>
struct Mma16<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma16_n64(d, a, desc, scale_d);
  }
};
template <>
struct Mma16<128> {
  __device__ __forceinline__ static void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    mma16_n128(d, a, desc, scale_d);
  }
};

}  // namespace hopper
