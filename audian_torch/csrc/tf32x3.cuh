// 3xTF32 products on Hopper's tensor cores (sm_90a, warp-level mma.sync).
//
// A float32 x is split into x = hi + lo with both parts rounded to TF32
// (10 explicit mantissa bits, round to nearest, ties away from zero), and
// a product a*b is taken as ah*bh + ah*bl + al*bh with a float32
// accumulator.  The dropped al*bl and the rounding of the remainders are
// about 2^-22 of |a*b|: the precision of the float32 FMA this replaces, at
// three TF32 passes of the tensor cores.  The small passes run first, so
// the accumulator adds them before the large one.
//
// Fragments follow PTX's m16n8k8 .tf32 layout: with g = lane / 4 and
// t = lane % 4,
//   A (16 x 8, row major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4]
//   B (8 x 8, col major):  b0 = B[t][g], b1 = B[t+4][g]
//   D (16 x 8):            d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t],
//                          d3 = D[g+8][2t+1]

#pragma once

#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (cvt.rna.tf32.f32: low 13 bits zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// d += a * b, one m16n8k8 TF32 pass with a float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// pass p of d += a * b: p = 0 hi*lo, 1 lo*hi, 2 hi*hi (the small passes
// first, so the accumulator adds them before the large one).  The passes
// into one accumulator wait on each other, so a caller with several
// independent tiles runs pass p over all of them before pass p + 1.
__device__ __forceinline__ void mma3_pass(int p, float (&d)[4],
                                          const FragA& a, const FragB& b) {
  if (p == 0) mma_tf32(d, a.hi, b.lo);
  else if (p == 1) mma_tf32(d, a.lo, b.hi);
  else mma_tf32(d, a.hi, b.hi);
}

// Four 8-row x 4-word matrices of pre-split words from shared memory in
// one instruction: lane l gives the (16-byte aligned) shared-memory
// address of row l % 8 of matrix l / 8, and r[j] receives word lane % 4
// of row lane / 4 of matrix j.  With rows along M and words along K that
// is an A fragment (matrices: rows 0-7 and 8-15 at k 0-3, then both at
// k 4-7); with rows along N, the B fragments of two 8-column tiles.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same from a generic pointer into shared memory
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  ldsm_x4(r, static_cast<uint32_t>(__cvta_generic_to_shared(p)));
}

}  // namespace tf32x3
