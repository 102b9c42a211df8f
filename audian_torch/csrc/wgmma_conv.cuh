// Convolutions as warpgroup Toeplitz products on Hopper's tensor cores
// (sm_90a wgmma, hopper.cuh), shared by chain.cu and envdet.cu.
//
// A convolution out[i] = sum_{m<T} taps[m] src[i + D - m] runs as one
// m64nNkK product a step (K = 8 TF32 or 16 bf16 taps), with the outputs
// in columns of 64:
//
//   out[64 U + n] = sum_v sum_{k<K} A_v[n, k] B_v[k, U]
//   A_v[n, k] = taps[n - k + D - K v]       (64 x K: a Toeplitz slice)
//   B_v[k, U] = src[64 U + K v + k]         (K x N: N columns)
//
// A stage runs in one of four modes (Mode), chosen at run time:
//
//   TF32X3  three TF32 passes, hi*lo + lo*hi + hi*hi (fp32 precision);
//   TF32X1  one TF32 pass, hi*hi (XLA's DEFAULT on this card);
//   BF16X3  three bf16 passes over operands split into bf16 hi and lo
//           (lo = x - hi rounded to bf16): hi*lo + lo*hi + hi*hi;
//   BF16X4  the same and lo*lo, first.
//
// A is gathered per step into registers from the host's tap vectors (a
// few KB, served by L1): TF32 taps as [hi | lo] floats, each thread
// loading its four taps of each part; bf16 taps as [hi | lo] vectors of
// pairs, word m holding taps m (low half) and m - 1 (high half), so that
// each A register is one 32-bit load (and, the slice being Toeplitz, a3 is
// a0).  B is read by the tensor cores from a stream in shared memory,
// split once as it is written, a part each:
//
//   - TF32 streams are quad-major: sample 64 R + 4 q + r of a part at word
//     4 (q nu + R) + r, sixteen planes of nu rows of one 16-byte quad;
//   - bf16 streams are octet-major: sample 64 R + 8 q + r at half-word
//     8 (q nu + R) + r, eight planes of nu rows of one 16-byte octet, half
//     the bytes.
//
// Then every B_v is a no-swizzle K-major operand: the core matrices are
// eight consecutive rows of one plane (128 contiguous bytes), the two
// k-groups of a step sit nu rows apart (LBO = 16 nu bytes), 8-row groups
// 128 bytes apart (SBO), and the step moves the start by two planes, plus
// one row when the planes wrap.
//
// Only the steps whose slices hold a true tap run.  Sums run in units of
// 128 taps (VB = 128 / K steps), from the unit base v_lo - phase (the
// host's choice): each unit's partial is added to the total in fp32, so
// the rounding grows with T / 128 terms and not with T.  A unit the host
// flags light (its taps' L1 mass, summed over the light units, under a
// thousandth of the total) runs one pass, hi*hi, whatever the mode: the
// JAX kernel's demotion of its light sub-blocks.  A step's passes are
// committed as one group; the A fragments rotate through a few register
// sets, so that the next step's taps load while the last steps' groups
// run.  No atomics: every sum is taken in a fixed order.

#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace wgconv {

constexpr int TPAD = 80;   // zero taps each side of a host tap vector
constexpr int COL = 64;    // outputs a column (the M of a wgmma)
constexpr int UNIT = 128;  // taps a unit

// a stage's arithmetic (the host's core_mode), and the one-pass bf16 kind
// of a light unit on a bf16 stage
enum Mode { TF32X3 = 0, TF32X1 = 1, BF16X3 = 2, BF16X4 = 3, BF16X1 = 4 };

__host__ __device__ constexpr bool is_bf16(int mode) { return mode >= BF16X3; }

// taps a step: 8 TF32 or 16 bf16
__host__ __device__ constexpr int kwidth(int mode) {
  return is_bf16(mode) ? 16 : 8;
}

// bytes a plane row of one part, times rows: a split stream's part
__host__ __device__ constexpr int part_bytes(int mode, int nu) {
  return (is_bf16(mode) ? 128 : 256) * nu;
}

// rows of a plane that hold a convolution's source for ncols output
// columns at delay D with steps of kw taps (the last step reads sample
// 64 ncols + D + kw - 2), odd so that a warp's 16-byte stores to
// consecutive quads or octets meet no bank conflict
__host__ __device__ inline int stream_rows(int ncols, int D, int kw = 8) {
  return ((64 * ncols + D + kw - 1 + 63) / 64) | 1;
}

// word of sample i in one part of a quad-major stream of nu rows a plane
__host__ __device__ inline int qm_word(int i, int nu) {
  return 4 * (((i >> 2) & 15) * nu + (i >> 6)) + (i & 3);
}

// half-word of sample i in one part of an octet-major stream
__host__ __device__ inline int om_half(int i, int nu) {
  return 8 * (((i >> 3) & 7) * nu + (i >> 6)) + (i & 7);
}

// a split stream in shared memory
struct Stream {
  uint32_t hi;     // shared address of part hi (plane 0, row 0)
  uint32_t lo;     // shared address of part lo
  int nu;          // rows a plane
};

// samples i .. i + 3 (i a multiple of 4) split into TF32 hi and lo, into
// a quad-major stream whose part hi starts at w (part lo 64 nu words on);
// with lo false, part hi alone (a TF32X1 stage reads no other)
__device__ __forceinline__ void put_quad(uint32_t* w, int nu, int i,
                                         float4 v, bool lo) {
  uint4 h, l;
  hopper::split_tf32(v.x, h.x, l.x);
  hopper::split_tf32(v.y, h.y, l.y);
  hopper::split_tf32(v.z, h.z, l.z);
  hopper::split_tf32(v.w, h.w, l.w);
  const int wd = qm_word(i, nu);
  *reinterpret_cast<uint4*>(w + wd) = h;
  if (lo) *reinterpret_cast<uint4*>(w + 64 * nu + wd) = l;
}

// samples i .. i + 7 (i a multiple of 8, a then b) split into bf16 hi and
// lo, into an octet-major stream whose part hi starts at w (part lo 32 nu
// words on)
__device__ __forceinline__ void put_octet(uint32_t* w, int nu, int i,
                                          float4 a, float4 b) {
  uint4 h, l;
  hopper::split_bf16(a.x, a.y, h.x, l.x);
  hopper::split_bf16(a.z, a.w, h.y, l.y);
  hopper::split_bf16(b.x, b.y, h.z, l.z);
  hopper::split_bf16(b.z, b.w, h.w, l.w);
  const int wd = om_half(i, nu) >> 1;
  *reinterpret_cast<uint4*>(w + wd) = h;
  *reinterpret_cast<uint4*>(w + 32 * nu + wd) = l;
}

// the stream of a stage in mode `mode` whose part hi starts at shared
// address at
__device__ __forceinline__ Stream stream_at(uint32_t at, int mode, int nu) {
  return Stream{at, at + (uint32_t)part_bytes(mode, nu), nu};
}

// the steps v_lo .. v_hi whose 64 x kw slices meet a tap, and the units
// they form from the base v_b = v_lo - phase (0 <= phase < 128 / kw):
// unit u holds the steps of [v_b + VB u, v_b + VB (u + 1)) that lie in
// [v_lo, v_hi]
struct Steps {
  int v_lo, v_hi, v_b, nvb, kw;
};

__host__ __device__ inline Steps steps(int T, int D, int kw = 8,
                                       int phase = 0) {
  Steps s;
  const int x = D - T - (kw - 2);   // kw v >= x: the slice reaches tap T-1
  s.kw = kw;
  s.v_lo = x > 0 ? (x + kw - 1) / kw : 0;
  s.v_hi = (D + 63) / kw;           // the last slice that reaches tap 0
  s.v_b = s.v_lo - phase;
  const int vb = UNIT / kw;
  s.nvb = (s.v_hi - s.v_b + vb) / vb;
  return s;
}

// a convolution: its host tap vector (TF32 [hi | lo] floats, or bf16
// [hi | lo] pair words, each T + 2 TPAD long with TPAD zeros in front),
// its mode and units, and the light flags of its units (nullptr: none)
struct Stage {
  const void* taps;
  int T, D, mode;
  Steps st;
  const int* light;
};

// this thread's output (row, column) of accumulator register i
__device__ __forceinline__ int out_row(int i) {
  const int x = threadIdx.x & 127;
  return 16 * (x >> 5) + ((x >> 2) & 7) + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int out_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// the steps [vb, ve) of one unit in kind K into part (overwritten by the
// first step): each step loads A_v (parts hi and lo as the kind needs)
// into register set v % R, runs the kind's passes over B_v and commits
// them as one group; at most R - 1 groups stay in flight while the next
// step's taps load.  tp is this thread's tap at A_v[16 w + g][t] (TF32,
// floats) or A_v[16 w + g][2 t, 2 t + 1] (bf16, pair words) for v = 0;
// tlo the words from a part hi to its part lo
template <int N, int R, int K>
__device__ __forceinline__ void unit(float (&part)[N / 2],
                                     uint32_t (&ah)[R][4],
                                     uint32_t (&al)[R][4],
                                     const uint32_t* tp, int tlo, int vb,
                                     int ve, const Stream& s,
                                     uint32_t col_bytes) {
  constexpr bool BF = is_bf16(K);
  constexpr int KW = BF ? 16 : 8;
  constexpr bool LO = K == TF32X3 || K == BF16X3 || K == BF16X4;
  const uint32_t lbo = 16u * s.nu;
  for (int v = vb; v < ve; v += R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int vv = v + r;
      if (vv >= ve) continue;
      const uint32_t* p = tp - KW * vv;
      uint32_t* h = ah[r];
      uint32_t* l = al[r];
      if (BF) {
        h[0] = __ldg(p);
        h[1] = __ldg(p + 8);
        h[2] = __ldg(p - 8);
        h[3] = h[0];
        if (LO) {
          l[0] = __ldg(p + tlo);
          l[1] = __ldg(p + tlo + 8);
          l[2] = __ldg(p + tlo - 8);
          l[3] = l[0];
        }
      } else {
        h[0] = __ldg(p);
        h[1] = __ldg(p + 8);
        h[2] = __ldg(p - 4);
        h[3] = __ldg(p + 4);
        if (LO) {
          l[0] = __ldg(p + tlo);
          l[1] = __ldg(p + tlo + 8);
          l[2] = __ldg(p + tlo - 4);
          l[3] = __ldg(p + tlo + 4);
        }
      }
      const uint32_t off = BF
          ? 16u * (2 * (vv & 3) * s.nu + (vv >> 2))
          : 16u * (2 * (vv & 7) * s.nu + (vv >> 3));
      const uint64_t dh = hopper::desc(s.hi + col_bytes + off, lbo, 128);
      const uint64_t dl = hopper::desc(s.lo + col_bytes + off, lbo, 128);
      const int acc = vv != vb;
      hopper::wgmma_fence();
      if (K == TF32X3) {
        hopper::Mma<N>::run(part, ah[r], dl, acc);
        hopper::Mma<N>::run(part, al[r], dh, 1);
        hopper::Mma<N>::run(part, ah[r], dh, 1);
      } else if (K == TF32X1) {
        hopper::Mma<N>::run(part, ah[r], dh, acc);
      } else if (K == BF16X1) {
        hopper::Mma16<N>::run(part, ah[r], dh, acc);
      } else {
        if (K == BF16X4) {
          hopper::Mma16<N>::run(part, al[r], dl, acc);
          hopper::Mma16<N>::run(part, ah[r], dl, 1);
        } else {
          hopper::Mma16<N>::run(part, ah[r], dl, acc);
        }
        hopper::Mma16<N>::run(part, al[r], dh, 1);
        hopper::Mma16<N>::run(part, ah[r], dh, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<R - 1>();
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(part);
}

// total += sum over the units [u0, u1) of the stage's convolution, for the
// N output columns from col0, by the calling warpgroup:
//
//   out[64 (col0 + U) + n] = sum_{m<T} taps[m] src[64 (col0 + U) + n + D - m]
//
// s is the stage's split stream (quad-major for a TF32 mode, octet-major
// for a bf16 one).  total[i] holds the output at (out_row(i), out_col(i)).
// All four warps of the warpgroup call it together (wgmma is
// warpgroup-wide); the mode and the flags are uniform, so every branch on
// them is too.  (The mode as a template argument, picked once a stage,
// made ptxas spill more in the chain kernel than this branch a unit.)
template <int N, int R>
__device__ void conv(const Stream& s, const Stage& sg, int col0, int u0,
                     int u1, float (&total)[N / 2]) {
  const int x = threadIdx.x & 127;
  const int w = x >> 5, g = (x >> 2) & 7, t = x & 3;
  const bool bf = is_bf16(sg.mode);
  const int tlo = sg.T + 2 * TPAD;
  // this thread's tap of A_0[16 w + g][t] (TF32) or pair of
  // A_0[16 w + g][2 t, 2 t + 1] (bf16)
  const uint32_t* tp = static_cast<const uint32_t*>(sg.taps) + TPAD + sg.D +
                       16 * w + g - (bf ? 2 * t : t);
  const uint32_t col_bytes = 16u * col0;
  const int vbn = UNIT / sg.st.kw;
  float part[N / 2];
  uint32_t ah[R][4], al[R][4];
  for (int u = u0; u < u1; ++u) {
    const int vb = max(sg.st.v_lo, sg.st.v_b + u * vbn);
    const int ve = min(sg.st.v_b + (u + 1) * vbn, sg.st.v_hi + 1);
    int kind = sg.mode;
    if (sg.light != nullptr && sg.light[u]) kind = bf ? BF16X1 : TF32X1;
    switch (kind) {
      case TF32X3:
        unit<N, R, TF32X3>(part, ah, al, tp, tlo, vb, ve, s, col_bytes);
        break;
      case TF32X1:
        unit<N, R, TF32X1>(part, ah, al, tp, tlo, vb, ve, s, col_bytes);
        break;
      case BF16X3:
        unit<N, R, BF16X3>(part, ah, al, tp, tlo, vb, ve, s, col_bytes);
        break;
      case BF16X4:
        unit<N, R, BF16X4>(part, ah, al, tp, tlo, vb, ve, s, col_bytes);
        break;
      default:
        unit<N, R, BF16X1>(part, ah, al, tp, tlo, vb, ve, s, col_bytes);
        break;
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) total[i] += part[i];
  }
}

}  // namespace wgconv
