// Convolutions as Toeplitz-block MMAs on Hopper's tensor cores (sm_90a,
// 3xTF32 mma.sync, tf32x3.cuh), shared by chain.cu and envdet.cu.
//
// A convolution out[i] = sum_{m<T} taps[m] src[i + D - m] runs at the
// MMA's own tile size:
//
//   out[16 U + n] = sum_v sum_{k<8} A_v[n, k] src[16 U + 8 v + k]
//   A_v[n, k] = taps[n - k + D - 8 v]        (16 x 8, n < 16)
//
// so the B operand (8 x 8: k by eight 16-sample rows U) is a row-offset
// view of a stream staged in shared memory and the A operand a Toeplitz
// slice of the taps, gathered by index from the host's pre-split tap
// vectors (a few KB, served by L1): no bank is materialised.  The stream
// is split into TF32 hi and lo once, as it is written to shared memory
// (put_split), in a swizzled layout (sw_conv) that lets one ldmatrix.x4
// bring a B fragment's four registers with no bank conflict.  v runs over
// the steps whose slices hold a true tap; sums run in blocks of VB steps
// (128 taps), each block's partial added to the total in fp32, so the
// rounding grows with T/128 terms and not with T.

#pragma once

#include <stdint.h>

#include "tf32x3.cuh"

namespace toeplitz {

constexpr int TPAD = 24;    // zero taps each side of a host tap vector
constexpr int SLACK = 32;   // zeros past a staged stream
constexpr int VB = 16;      // 8-tap steps per partial sum (128 taps)

__host__ __device__ constexpr int round32(int v) { return (v + 31) & ~31; }

// word of logical index i of a split stream: an XOR of word bits 2-4 with
// bits 4-6 inside each 32-word line, so that eight rows 16 words apart (a
// B fragment) land in eight distinct 4-bank groups, whatever the base
__device__ __forceinline__ int sw_conv(int i) {
  return i ^ (((i >> 4) & 7) << 2);
}

// value v split into TF32 parts at logical index i of a split stream
// [hi | lo], each `words` long, in the sw_conv layout
__device__ __forceinline__ void put_split(uint32_t* buf, int words, int i,
                                          float v) {
  tf32x3::split_tf32(v, buf[sw_conv(i)], buf[words + sw_conv(i)]);
}

// out[i] = sum_{ph<nphase} sum_{m<T} taps_ph[m] src_ph[i + D - m] for
// i < 128 * ntiles, with src_ph = src + ph * src_phase a split stream
// ([hi | lo], each `words` long, sw_conv layout over the logical index
// ph * src_phase + j) and taps_ph at tp + ph * tap_phase: [hi | lo], each
// T + 2 TPAD long with TPAD zeros in front.  Calls epi(i, value) once per
// output, from the first group's warps.
//
// The NW warps of the block form SPLIT groups that share the work units
// (blocks of VB steps of each phase, in order); warp w of a group takes J
// consecutive tiles of 128 outputs (eight 16-sample rows each) at a time.
// With SPLIT > 1 each warp makes one pass (ntiles <= J NW / SPLIT), and
// the other groups' sums reach the first through red ((SPLIT - 1) 128
// ntiles floats), added in group order.  The host geometry keeps
// D - T >= -1, so v starts at 0 and src_ph is read on
// [0, 128 ntiles + D + 15).
template <int NW, int J, int SPLIT, class Epi>
__device__ __forceinline__ void conv_mma(const uint32_t* src, int words,
                                         const float* __restrict__ tp, int T,
                                         int D, int ntiles, float* red,
                                         Epi epi, int nphase = 1,
                                         int src_phase = 0,
                                         int tap_phase = 0) {
  using tf32x3::FragA;
  using tf32x3::FragB;
  constexpr int GW = NW / SPLIT;         // warps a group
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = warp / GW;
  const int g = lane >> 2, t = lane & 3;
  const int x = D - T - 6;               // 8 v_lo >= x: the slice meets a tap
  const int v_lo = x > 0 ? (x + 7) / 8 : 0;
  const int v_hi = (D + 15) / 8;         // the last slice that meets a tap
  const int nvb = (v_hi - v_lo + VB) / VB;   // units a phase
  const int units = nphase * nvb;
  const int per = (units + SPLIT - 1) / SPLIT;
  const int u0 = min(grp * per, units);
  const int u1 = min(u0 + per, units);
  // this lane's ldmatrix row: matrices hi b0, hi b1, lo b0, lo b1, each
  // eight rows 16 samples apart, b1 four samples after b0
  const int row = 16 * (lane & 7) + 4 * ((lane >> 3) & 1);
  const uint32_t part_src = static_cast<uint32_t>(
      __cvta_generic_to_shared(src + (lane >> 4) * words));
  for (int tile0 = (warp % GW) * J; tile0 < ntiles; tile0 += GW * J) {
    // sw_conv leaves the bits of 128 k alone: tile j's rows sit 128 words
    // (512 bytes) a tile after the swizzled row of the step
    uint32_t tile_at[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      tile_at[j] = part_src + 512 * min(tile0 + j, ntiles - 1);
    float acc[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
    for (int u = u0; u < u1; ++u) {
      const int ph = nphase == 1 ? 0 : u / nvb;
      const int vb = v_lo + (u - ph * nvb) * VB;
      const int ve = min(vb + VB, v_hi + 1);
      // this lane's tap of the slice of step v: thi[0] = A_v[g, t]
      const float* thi = tp + ph * tap_phase + TPAD + D + g - t - 8 * vb;
      const float* tlo = thi + T + 2 * TPAD;
      const int base = ph * src_phase + row;
      float part[J][4];
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[j][r] = 0.0f;
      for (int v = vb; v < ve; ++v, thi -= 8, tlo -= 8) {
        FragA a;
        a.hi[0] = __float_as_uint(__ldg(thi));
        a.hi[1] = __float_as_uint(__ldg(thi + 8));
        a.hi[2] = __float_as_uint(__ldg(thi - 4));
        a.hi[3] = __float_as_uint(__ldg(thi + 4));
        a.lo[0] = __float_as_uint(__ldg(tlo));
        a.lo[1] = __float_as_uint(__ldg(tlo + 8));
        a.lo[2] = __float_as_uint(__ldg(tlo - 4));
        a.lo[3] = __float_as_uint(__ldg(tlo + 4));
        const uint32_t at = 4 * sw_conv(base + 8 * v);
        FragB b[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          uint32_t r[4];
          tf32x3::ldsm_x4(r, tile_at[j] + at);
          b[j] = FragB{{r[0], r[1]}, {r[2], r[3]}};
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < J; ++j)
            if (tile0 + j < ntiles) tf32x3::mma3_pass(p, part[j], a, b[j]);
      }
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] += part[j][r];
    }
    if (SPLIT > 1) {
      // the other groups' sums, added to the first's in a fixed order
      const int i0 = 128 * tile0 + 32 * t + g;
      if (grp > 0) {
        float* mine = red + (grp - 1) * 128 * ntiles;
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (tile0 + j < ntiles)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              mine[i0 + 128 * j + 16 * (r & 1) + 8 * (r >> 1)] = acc[j][r];
      }
      __syncthreads();
      if (grp > 0) continue;
      for (int s = 0; s < SPLIT - 1; ++s) {
        const float* theirs = red + s * 128 * ntiles;
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (tile0 + j < ntiles)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[j][r] +=
                  theirs[i0 + 128 * j + 16 * (r & 1) + 8 * (r >> 1)];
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (tile0 + j < ntiles) {
        const int i0 = 128 * (tile0 + j) + 32 * t + g;
        epi(i0, acc[j][0]);
        epi(i0 + 16, acc[j][1]);
        epi(i0 + 8, acc[j][2]);
        epi(i0 + 24, acc[j][3]);
      }
    }
  }
}

}  // namespace toeplitz
