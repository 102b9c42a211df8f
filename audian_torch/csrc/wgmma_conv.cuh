// Convolutions as warpgroup Toeplitz products on Hopper's tensor cores
// (sm_90a, 3xTF32 wgmma, hopper.cuh), shared by chain.cu and envdet.cu.
//
// A convolution out[i] = sum_{m<T} taps[m] src[i + D - m] runs as one
// m64nNk8 product a step, with the outputs in columns of 64:
//
//   out[64 U + n] = sum_v sum_{k<8} A_v[n, k] B_v[k, U]
//   A_v[n, k] = taps[n - k + D - 8 v]       (64 x 8: a Toeplitz slice)
//   B_v[k, U] = src[64 U + 8 v + k]         (8 x N: N columns)
//
// A is gathered per step into registers from the host's split tap vectors
// (a few KB, served by L1): each thread loads its four taps of each part.
// B is read by the tensor cores from a stream in shared memory, stored
// quad-major: sample 64 R + 4 q + r of a part at word 4 (q nu + R) + r,
// sixteen planes of nu rows of one 16-byte quad.  Then every B_v is a
// no-swizzle K-major operand: the core matrices are eight consecutive
// rows of one plane (128 contiguous bytes), the two k-quads of a step
// sit nu rows apart (LBO = 16 nu bytes), 8-row groups 128 bytes apart
// (SBO), and the step moves the start by two planes, plus one row for
// each eight steps.  Each sample is stored once, split into TF32 hi and
// lo as it is written (a part each).
//
// Only the steps whose slices hold a true tap run.  Sums run in units of
// VB steps (128 taps): each unit's partial is added to the total in fp32,
// so the rounding grows with T / 128 terms and not with T.  A step is
// three wgmmas into the unit's accumulator, hi*lo, lo*hi, hi*hi, committed
// as one group; the A fragments rotate through a few register sets, so
// that the next step's taps load while the last steps' groups run.  No
// atomics: every sum is taken in a fixed order.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace wgconv {

constexpr int TPAD = 72;   // zero taps each side of a host tap vector
constexpr int VB = 16;     // 8-tap steps a unit (128 taps)
constexpr int COL = 64;    // outputs a column (the M of a wgmma)

// rows of a quad plane that hold a convolution's source for ncols output
// columns at delay D (the last step reads sample 64 ncols + D + 6), odd so
// that a warp's 16-byte stores to consecutive quads meet no bank conflict
__host__ __device__ inline int stream_rows(int ncols, int D) {
  return ((64 * ncols + D + 7 + 63) / 64) | 1;
}

// word of sample i in one part of a quad-major stream of nu rows a plane
__host__ __device__ inline int qm_word(int i, int nu) {
  return 4 * (((i >> 2) & 15) * nu + (i >> 6)) + (i & 3);
}

// the steps v_lo .. v_hi whose 64 x 8 slices meet a tap, and the units
// they form
struct Steps {
  int v_lo, v_hi, nvb;
};

__host__ __device__ inline Steps steps(int T, int D) {
  Steps s;
  const int x = D - T - 6;         // 8 v >= x: the slice reaches tap T-1
  s.v_lo = x > 0 ? (x + 7) / 8 : 0;
  s.v_hi = (D + 63) / 8;           // the last slice that reaches tap 0
  s.nvb = (s.v_hi - s.v_lo + VB) / VB;
  return s;
}

// a split stream in shared memory
struct Stream {
  uint32_t hi;     // shared address of part hi (plane 0, row 0)
  uint32_t lo;     // shared address of part lo
  int nu;          // rows a plane
};

// this thread's output (row, column) of accumulator register i
__device__ __forceinline__ int out_row(int i) {
  const int x = threadIdx.x & 127;
  return 16 * (x >> 5) + ((x >> 2) & 7) + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int out_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// one step: load A_v (parts hi and lo) into (ah, al), then the three
// passes over B_v into part, committed as one group
template <int N>
__device__ __forceinline__ void step(float (&part)[N / 2], uint32_t (&ah)[4],
                                     uint32_t (&al)[4], const float* th,
                                     int tlo, int v, uint32_t b_hi,
                                     uint32_t b_lo, int nu, int first) {
  const float* p = th - 8 * v;
  ah[0] = __float_as_uint(__ldg(p));
  ah[1] = __float_as_uint(__ldg(p + 8));
  ah[2] = __float_as_uint(__ldg(p - 4));
  ah[3] = __float_as_uint(__ldg(p + 4));
  al[0] = __float_as_uint(__ldg(p + tlo));
  al[1] = __float_as_uint(__ldg(p + tlo + 8));
  al[2] = __float_as_uint(__ldg(p + tlo - 4));
  al[3] = __float_as_uint(__ldg(p + tlo + 4));
  const uint32_t off = 16u * (2 * (v & 7) * nu + (v >> 3));
  const uint32_t lbo = 16u * nu;
  const uint64_t dh = hopper::desc(b_hi + off, lbo, 128);
  const uint64_t dl = hopper::desc(b_lo + off, lbo, 128);
  hopper::wgmma_fence();
  hopper::Mma<N>::run(part, ah, dl, !first);
  hopper::Mma<N>::run(part, al, dh, 1);
  hopper::Mma<N>::run(part, ah, dh, 1);
  hopper::wgmma_commit();
}

// total += sum over the units [u0, u1) of the convolution, for the N
// output columns from col0, by the calling warpgroup:
//
//   out[64 (col0 + U) + n] = sum_{m<T} taps[m] src[64 (col0 + U) + n + D - m]
//
// with unit u covering the steps v_lo + 16 u .. v_lo + 16 u + 15 and the
// taps at tp: [hi | lo], each T + 2 TPAD long with TPAD zeros in front.
// total[i] holds the output at (out_row(i), out_col(i)).  The A fragments
// rotate through R register sets, so R - 1 steps' groups stay in flight
// while the next step's taps load.  All four warps of the warpgroup call
// it together (wgmma is warpgroup-wide).
template <int N, int R>
__device__ void conv(const Stream& s, const float* __restrict__ tp, int T,
                     int D, const Steps& st, int col0, int u0, int u1,
                     float (&total)[N / 2]) {
  const int x = threadIdx.x & 127;
  const int w = x >> 5, g = (x >> 2) & 7, t = x & 3;
  const int tlo = T + 2 * TPAD;
  // this thread's tap of A_v[16 w + g][t] at th[-8 v]
  const float* th = tp + TPAD + D + 16 * w + g - t;
  const uint32_t b_hi = s.hi + 16u * col0, b_lo = s.lo + 16u * col0;
  float part[N / 2];
  uint32_t ah[R][4], al[R][4];
  for (int u = u0; u < u1; ++u) {
    const int vb = st.v_lo + u * VB;
    const int ve = min(vb + VB, st.v_hi + 1);
    for (int v = vb; v < ve; v += R) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (v + r < ve) {
          step<N>(part, ah[r], al[r], th, tlo, v + r, b_hi, b_lo, s.nu,
                  v + r == vb);
          hopper::wgmma_wait<R - 1>();
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[i] += part[i];
  }
}

}  // namespace wgconv
