// Single-pass fused chain on Hopper's tensor cores (sm_90a, 3xTF32 wgmma):
// int16 or float32 PCM -> causal FIR band-pass -> pi/2-rectified symmetric
// envelope -> Hann PSD at hop 128, with per-tile chunk statistics.
//
// Replaces audian_tpu/ops/pallas/chain.py:_chain_kernel (via _chain_call).
// In chunk coordinates, with x = x_ext dequantized (k / 2^15 for int16):
//
//   y[c, j] = sum_{m<Tf} h[m] x[c, hb + j - m]            j in [-lead, n + tail)
//   e[c, j] = max(0, sum_{k<L} g[k] (pi/2)|y[c, j + delay - k]|)   j in [0, n)
//   psd[f, c, b] = |sum_{k<nfft} y[c, 128 f + k] ws[k, .]|^2        f < n / 128
//
// ws here is the host's pair-interleaved analysis matrix (ops/cuda/chain.py
// _pair_columns): column 2b holds the real part of bin b and column 2b+1 its
// imaginary part for 0 < b < nfft/2; columns 0 and 1 hold the real parts of
// bin 0 and of the Nyquist bin (whose imaginary parts are zero).
//
// What bounds it on the H100: arithmetic.  A sample of one channel costs
// Tf + L + 2 nfft true multiply-adds (about 1.8 k at the headline design)
// against about 14 bytes of device-memory traffic, and every product runs
// as three TF32 passes (3xTF32, hopper.cuh) to keep fp32 precision.  At
// the headline design the envelope's products take about half the time,
// at the core's rate with two warpgroups an SM (PERF.md, PR 11).
//
// Design.  A persistent grid, one block an SM, walks the (channel, tile)
// items, a tile being tj outputs of one channel (16384 at the headline
// design: the widest that fits, chosen by the host).  A block is two
// consumer warpgroups and a producer warpgroup, whose registers go to the
// consumers (setmaxnreg) and whose first thread issues the copies:
//
//   - the producer copies each item's input span from device memory into
//     region Y by one cp.async.bulk (its start aligned down to 16 bytes),
//     completing on an mbarrier, and streams the PSD's operand through a
//     ring of 16 KB stages in region X (below);
//   - the consumers dequantize the span and split it into TF32 hi and lo
//     once, as a quad-major stream in region X (wgmma_conv.cuh), and run
//     the filter on it as Toeplitz wgmmas (wgconv::conv), 64-column chunks
//     taken by the two warpgroups in turn; the filtered span goes to
//     region Y (fp32, the input's bytes being consumed by then) and to y;
//   - the PSD runs next, a dense wgmma product: warpgroup w takes the
//     tile's frames 64 w .. 64 w + 63 (A, gathered into registers from the
//     filtered span and split on the fly) against the host-split, K-major
//     ws (ChainKernel.ws_slices), two slices of 8 rows by 128
//     columns a stage, which the producer streams into region X, free once
//     the filter has read it; both warpgroups read each stage, so the
//     matrix crosses L2 once for every 128 frames.  |.|^2 and the per-bin
//     sums finish in registers;
//   - once both warpgroups are done with the ring, the rectified span is
//     split into region X as the envelope's stream, region Y is handed
//     back to the producer, which copies the next item's input while the
//     consumers run the envelope (128-column chunks, one a warpgroup, from
//     256 columns on).
//
// So a tile's input copy overlaps the previous tile's envelope, and its
// PSD operand the filter.  Sums run in blocks of 16 steps (128 taps), each
// block's partial added to the total in fp32, which keeps a 14511-tap
// envelope inside 1e-5.  Statistics leave as one partial per warp and
// item, summed by the caller in a fixed order: no atomics, results the same
// from run to run whatever stages are masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_conv.cuh"

namespace {

using hopper::bar_sync;
using hopper::fence_async;
using hopper::imax;
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::split_tf32;
using wgconv::COL;
using wgconv::qm_word;
using wgconv::stream_rows;

constexpr int HOP = 128;      // PSD hop the chain is built for
constexpr int NCONS = 256;    // consumer threads: two warpgroups
constexpr int NT = NCONS + 128;   // and the producer warpgroup
constexpr int NWARP = NCONS / 32;
// A-fragment register sets of a warpgroup in the convolutions
// (wgmma_conv.cuh): one, each step waiting for the last; the two
// warpgroups' products interleave on the tensor cores, and deeper rings
// cost the registers that keep ptxas from spilling or serializing
constexpr int R = 1;
constexpr int RING = 8;       // stages of the PSD operand ring
constexpr int SLICE_COLS = 128;   // pair columns of a host slice
constexpr int SLICE_WORDS = 2 * 8 * SLICE_COLS;   // 8 rows, hi and lo
constexpr int SLICE_BYTES = 4 * SLICE_WORDS;
constexpr int STAGE_BYTES = 2 * SLICE_BYTES;      // two slices a stage
constexpr int TILE_MAX = 16384;
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

// mbarriers after the two regions
enum { RAW_FULL, Y_FREE, X_FREE, FULL0, EMPTY0 = FULL0 + RING, NBAR =
       EMPTY0 + RING };

struct Geometry {
  int Tf, L, delay, lead, tail, hb, nfft;
  int tj;        // outputs a tile
  int ylen;      // filtered samples a tile: tj + lead + tail
  int xspan;     // input samples a tile: ylen + Tf - 1
  int nu;        // rows a plane of the split input and rectified streams
  int x_bytes;   // region X: either split stream, or the PSD ring
  int y_bytes;   // region Y: the filtered span (fp32) or the input copy
};

__host__ __device__ inline Geometry geometry(int Tf, int L, int delay,
                                             int lead, int tail, int hb,
                                             int nfft, int tj) {
  Geometry g;
  g.Tf = Tf;
  g.L = L;
  g.delay = delay;
  g.lead = lead;
  g.tail = tail;
  g.hb = hb;
  g.nfft = nfft;
  g.tj = tj;
  g.ylen = tj + lead + tail;
  g.xspan = g.ylen + Tf - 1;
  // a chunk reads its whole width's source even where the stage has
  // fewer columns (64, or the envelope's 128 from 256 columns on)
  const int nf = imax(g.ylen / COL, COL), ne = imax(tj / COL, COL);
  g.nu = imax(stream_rows(nf, Tf - 1), stream_rows(ne, lead + delay));
  g.x_bytes = imax(2 * 256 * g.nu, RING * STAGE_BYTES);
  g.y_bytes = imax(4 * g.ylen, (4 * g.xspan + 32 + 15) & ~15);
  return g;
}

__host__ __device__ inline long long smem_bytes(const Geometry& g) {
  return (long long)g.x_bytes + g.y_bytes + 8 * NBAR;
}

// word of filtered sample i in region Y: an XOR of word bits 2-4 with bits
// 7-9 inside each 32-word line, so that the PSD's eight frames 128 apart
// (a fragment's rows) and the stream fills meet no bank conflict
__device__ __forceinline__ int sw_psd(int i) {
  return i ^ (((i >> 7) & 7) << 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// the input copy of one item: bytes from the 16-byte aligned address at
// or below the span's first sample, to a 16-byte boundary past its last
// sample that lies in the tensor (a 16-byte block never crosses a page)
struct Span {
  const char* src;   // aligned start
  int off;           // bytes from src to the span's first sample
  uint32_t bytes;    // bytes to copy (0: no sample lies in the tensor)
};

__device__ __forceinline__ Span span_of(const void* xv, int es, long long xlen,
                                        int c, long long base, int xspan) {
  const long long cnt = min((long long)xspan, max(xlen - base, 0LL));
  const char* first = static_cast<const char*>(xv) +
                      ((long long)c * xlen + base) * es;
  Span s;
  s.src = reinterpret_cast<const char*>(
      reinterpret_cast<uintptr_t>(first) & ~(uintptr_t)15);
  s.off = (int)(first - s.src);
  s.bytes = cnt > 0 ? (uint32_t)((s.off + cnt * es + 15) & ~15LL) : 0u;
  return s;
}

// one k-step (8 rows of ws) of the PSD from the slice at b: this
// warpgroup's three passes of its frames x slice, A from the filtered span
// at yf[sw_psd(yi)] (rows +8 frames and columns +4 taps, split on the
// fly), committed as a group; then the wait for the group before it
__device__ __forceinline__ void psd_step(float (&acc)[64], uint32_t (&ah)[4],
                                         uint32_t (&al)[4], uint32_t b,
                                         const float* yf, int yi, bool v0,
                                         bool v1, int first) {
  split_tf32(v0 ? yf[sw_psd(yi)] : 0.0f, ah[0], al[0]);
  split_tf32(v1 ? yf[sw_psd(yi + 8 * HOP)] : 0.0f, ah[1], al[1]);
  split_tf32(v0 ? yf[sw_psd(yi + 4)] : 0.0f, ah[2], al[2]);
  split_tf32(v1 ? yf[sw_psd(yi + 8 * HOP + 4)] : 0.0f, ah[3], al[3]);
  const uint64_t dh = hopper::desc(b, 2048, 128);
  const uint64_t dl = hopper::desc(b + SLICE_BYTES / 2, 2048, 128);
  hopper::wgmma_fence();
  hopper::mma_n128(acc, ah, dl, !first);
  hopper::mma_n128(acc, al, dh, 1);
  hopper::mma_n128(acc, ah, dh, 1);
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
}

// the envelope's chunks of N columns for warpgroup wg: e[j0 + i] for
// i < tj; returns this thread's sum of what it wrote
// one 64-column chunk of the filter from col0, by the calling warpgroup:
// the filtered span into yf (sw_psd layout) and y[j0 + i] for i < tj,
// columns below `from` left to the chunk before; returns this thread's sum
// of squares of what it wrote to y
__device__ __forceinline__ float filter_chunk(const wgconv::Stream& xs,
                                              const float* __restrict__ h,
                                              const Geometry& geo,
                                              const wgconv::Steps& st,
                                              int col0, int from, int ncols,
                                              long long j0, long long n,
                                              int want_f, float* yf,
                                              float* __restrict__ yrow) {
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  wgconv::conv<64, R>(xs, h, geo.Tf, geo.Tf - 1, st, col0, 0, st.nvb, acc);
  float psum = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int U = col0 + wgconv::out_col(i);
    if (U < from || U >= ncols) continue;
    const int si = COL * U + wgconv::out_row(i);
    yf[sw_psd(si)] = acc[i];
    const long long jl = si - geo.lead;
    if (want_f && jl >= 0 && jl < geo.tj && j0 + jl < n) {
      yrow[j0 + jl] = acc[i];
      psum = fmaf(acc[i], acc[i], psum);
    }
  }
  return psum;
}

// the filter over the span by warpgroup wg: 64-column chunks, the two
// warpgroups in turn, the last one moved back to end at the span's last
// column
__device__ __forceinline__ float filter(const wgconv::Stream& xs,
                                        const float* __restrict__ h,
                                        const Geometry& geo,
                                        const wgconv::Steps& st, int ncols,
                                        int wg, long long j0, long long n,
                                        int want_f, float* yf,
                                        float* __restrict__ yrow) {
  float psum = 0.0f;
  for (int ch = wg; ch * COL < ncols; ch += 2)
    psum += filter_chunk(xs, h, geo, st, min(ch * COL, max(ncols - COL, 0)),
                         ch * COL, ncols, j0, n, want_f, yf, yrow);
  return psum;
}

template <int N>
__device__ __forceinline__ float envelope(const wgconv::Stream& xs,
                                          const float* __restrict__ gt,
                                          const Geometry& geo,
                                          const wgconv::Steps& st,
                                          int ncols, int wg, long long j0,
                                          long long n, int env_clamp,
                                          float* __restrict__ erow) {
  float esum = 0.0f;
  for (int ch = wg; ch * N < ncols; ch += 2) {
    const int col0 = min(ch * N, max(ncols - N, 0));
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    wgconv::conv<N, R>(xs, gt, geo.L, geo.lead + geo.delay, st, col0, 0,
                       st.nvb, acc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int U = col0 + wgconv::out_col(i);
      if (U < ch * N || U >= ncols) continue;
      const long long j = j0 + COL * U + wgconv::out_row(i);
      if (j < n) {
        const float v = env_clamp ? fmaxf(acc[i], 0.0f) : acc[i];
        erow[j] = v;
        esum += v;
      }
    }
  }
  return esum;
}

__global__ void __launch_bounds__(NT, 1)
chain_kernel(const void* __restrict__ xv, int x_i16, long long xlen,
             long long n, int C, Geometry geo,
             const float* __restrict__ h, const float* __restrict__ gt,
             const float* __restrict__ ws, int env_clamp, int want_f,
             int want_e, int want_s, float* __restrict__ y,
             float* __restrict__ e, float* __restrict__ s,
             float* __restrict__ pp, float* __restrict__ gp,
             float* __restrict__ qp) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* X = smem;
  unsigned char* Y = smem + geo.x_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Y + geo.y_bytes);
  float* yf = reinterpret_cast<float*>(Y);
  const int tid = threadIdx.x;
  const int es = x_i16 ? 2 : 4;
  const int ntiles = (int)((n + geo.tj - 1) / geo.tj);
  const long long nitems = (long long)ntiles * C;
  const int nk = geo.nfft / 8;                 // k-slices of the PSD
  const int ncg = geo.nfft / SLICE_COLS;       // column groups

  if (tid == 0) {
    mbar_init(&bar[RAW_FULL], 1);
    mbar_init(&bar[Y_FREE], 1);
    mbar_init(&bar[X_FREE], 1);
    for (int i = 0; i < RING; ++i) {
      mbar_init(&bar[FULL0 + i], 1);
      mbar_init(&bar[EMPTY0 + i], NWARP);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // -- the producer ---------------------------------------------------------
    // its registers go to the consumers (ptxas allocates each side within
    // its setmaxnreg count); one thread issues the copies
    hopper::regs_dec<24>();
    if (tid != NCONS) return;
    int sc = 0;
    int k = 0;
    for (long long item = blockIdx.x; item < nitems;
         item += gridDim.x, ++k) {
      const int c = (int)(item % C);
      const long long j0 = (item / C) * geo.tj;
      const long long base = geo.hb + j0 - geo.lead - (geo.Tf - 1);
      const Span sp = span_of(xv, es, xlen, c, base, geo.xspan);
      mbar_wait(&bar[Y_FREE], (k & 1) ^ 1);
      mbar_expect(&bar[RAW_FULL], sp.bytes);
      if (sp.bytes) hopper::bulk_load(Y, sp.src, sp.bytes, &bar[RAW_FULL]);
      if (!want_s) continue;
      mbar_wait(&bar[X_FREE], k & 1);
      for (int sl = 0; sl < ncg * nk; sl += 2, ++sc) {
        const int st = sc % RING;
        mbar_wait(&bar[EMPTY0 + st], ((sc / RING) & 1) ^ 1);
        mbar_expect(&bar[FULL0 + st], STAGE_BYTES);
        hopper::bulk_load(X + st * STAGE_BYTES,
                          ws + (long long)sl * SLICE_WORDS, STAGE_BYTES,
                          &bar[FULL0 + st]);
      }
    }
    return;
  }

  // -- the consumers ----------------------------------------------------------
  hopper::regs_inc<240>();
  const int wg = tid >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = (tid >> 2) & 7, t = tid & 3;
  const int nbins = geo.nfft / 2 + 1;
  const int half = nbins - 1;
  const long long nf = n / HOP;
  const wgconv::Stream xs{hopper::smem_u32(X),
                          hopper::smem_u32(X) + 256u * geo.nu, geo.nu};
  uint32_t* xw = reinterpret_cast<uint32_t*>(X);
  const int pw = 64 * geo.nu;                  // words a part
  const int nq = 16 * geo.nu;                  // quads a part
  const int ncols_f = geo.ylen / COL, ncols_e = geo.tj / COL;
  const wgconv::Steps st_f = wgconv::steps(geo.Tf, geo.Tf - 1);
  const wgconv::Steps st_e = wgconv::steps(geo.L, geo.lead + geo.delay);
  int sc = 0;
  int k = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x, ++k) {
    const int c = (int)(item % C);
    const int tile = (int)(item / C);
    const long long j0 = (long long)tile * geo.tj;
    const long long base = geo.hb + j0 - geo.lead - (geo.Tf - 1);
    const long long yrow = (long long)c * n;
    const long long prow = ((long long)c * ntiles + tile) * NWARP + warp;

    // 1. the input span, dequantized and split into the stream in X
    {
      const Span sp = span_of(xv, es, xlen, c, base, geo.xspan);
      mbar_wait(&bar[RAW_FULL], k & 1);
      const long long cnt = sp.bytes ? (sp.bytes - sp.off) / es : 0;
      for (int qd = tid; qd < nq; qd += NCONS) {
        float v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * qd + r;
          float val = 0.0f;
          if (i < geo.xspan && i < cnt && base + i < xlen) {
            const unsigned char* p = Y + sp.off + (long long)i * es;
            val = x_i16 ? (float)*reinterpret_cast<const int16_t*>(p) *
                              RAW16_SCALE
                        : *reinterpret_cast<const float*>(p);
          }
          v[r] = val;
        }
        uint4 hi, lo;
        split_tf32(v[0], hi.x, lo.x);
        split_tf32(v[1], hi.y, lo.y);
        split_tf32(v[2], hi.z, lo.z);
        split_tf32(v[3], hi.w, lo.w);
        const int wd = qm_word(4 * qd, geo.nu);
        *reinterpret_cast<uint4*>(xw + wd) = hi;
        *reinterpret_cast<uint4*>(xw + pw + wd) = lo;
      }
      fence_async();
      bar_sync(1, NCONS);
    }

    // 2. the filter over the span: y[j0 - lead + i] = yf[sw_psd(i)]
    float psum = filter(xs, h, geo, st_f, ncols_f, wg, j0, n, want_f, yf,
                        y + yrow);
    bar_sync(1, NCONS);
    if (tid == 0) mbar_arrive(&bar[X_FREE]);

    // 3. the PSD of the tile's frames
    if (want_s) {
      const int fr0 = 64 * wg + 16 * (warp & 3) + gq;   // frames fr0, +8
      const long long nfr = min((long long)geo.tj / HOP, nf - j0 / HOP);
      const bool active = 64 * wg < nfr;
      const bool v0 = fr0 < nfr, v1 = fr0 + 8 < nfr;
      const int y0 = geo.lead + HOP * fr0 + t;
      for (int cg = 0; cg < ncg; ++cg) {
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        // a stage holds two k-steps, one A register set each: a step's
        // fragments load while the last one's MMAs run, and a stage goes
        // back to the producer once its second step has retired
        uint32_t ah0[4], al0[4], ah1[4], al1[4];
        for (int kk = 0; kk < nk; kk += 2, ++sc) {
          const int stg = sc % RING;
          mbar_wait(&bar[FULL0 + stg], (sc / RING) & 1);
          const uint32_t b = hopper::smem_u32(X + stg * STAGE_BYTES);
          if (active) {
            psd_step(acc, ah0, al0, b, yf, y0 + 8 * kk, v0, v1, kk == 0);
            if (kk > 0 && lane == 0)
              mbar_arrive(&bar[EMPTY0 + (sc - 1) % RING]);
            psd_step(acc, ah1, al1, b + SLICE_BYTES, yf, y0 + 8 * kk + 8,
                     v0, v1, 0);
          } else if (lane == 0) {
            mbar_arrive(&bar[EMPTY0 + stg]);
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (active && lane == 0) mbar_arrive(&bar[EMPTY0 + (sc - 1) % RING]);
        // lane (g, t) holds frames fr0 and fr0 + 8 of the pairs
        // 64 cg + 4 j + t: the real part in acc[4j]/acc[4j+2], the
        // imaginary part in acc[4j+1]/acc[4j+3] (pair 0: bin 0, Nyquist)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int slot = 64 * cg + 4 * j + t;
          float qa = 0.0f, qb = 0.0f;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (!(hf ? v1 : v0)) continue;
            const float re = acc[4 * j + 2 * hf], im = acc[4 * j + 2 * hf + 1];
            const long long fr = j0 / HOP + fr0 + 8 * hf;
            float* srow = s + (fr * C + c) * nbins;
            if (slot == 0) {
              const float p0 = re * re, p1 = im * im;
              srow[0] = p0;
              srow[half] = p1;
              qa += p0;
              qb += p1;
            } else {
              const float p = re * re + im * im;
              srow[slot] = p;
              qa += p;
            }
          }
          // sum over the eight lanes of this pair (g = 0..7), fixed order;
          // the Nyquist bin's only in pair 0
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            qa += __shfl_xor_sync(0xffffffffu, qa, m);
            if (j == 0 && cg == 0)
              qb += __shfl_xor_sync(0xffffffffu, qb, m);
          }
          if (gq == 0) {
            qp[prow * nbins + slot] = qa;
            if (slot == 0) qp[prow * nbins + half] = qb;
          }
        }
      }
    }

    // 4. the rectified span, split into the envelope's stream in X, once
    // both warpgroups' MMAs have read the last ring stage there
    bar_sync(1, NCONS);
    if (want_e) {
      for (int qd = tid; qd < nq; qd += NCONS) {
        const int i = 4 * qd;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < geo.ylen) v = *reinterpret_cast<const float4*>(yf + sw_psd(i));
        uint4 hi, lo;
        split_tf32(HALF_PI * fabsf(v.x), hi.x, lo.x);
        split_tf32(HALF_PI * fabsf(v.y), hi.y, lo.y);
        split_tf32(HALF_PI * fabsf(v.z), hi.z, lo.z);
        split_tf32(HALF_PI * fabsf(v.w), hi.w, lo.w);
        const int wd = qm_word(i, geo.nu);
        *reinterpret_cast<uint4*>(xw + wd) = hi;
        *reinterpret_cast<uint4*>(xw + pw + wd) = lo;
      }
    }
    fence_async();
    bar_sync(1, NCONS);
    // Y is read: the producer copies the next item's input into it
    if (tid == 0) mbar_arrive(&bar[Y_FREE]);

    // 5. the envelope: e[j0 + i], i < tj
    float esum = 0.0f;
    if (want_e) {
      // 128-column chunks where there are two or more, one a warpgroup
      if (ncols_e >= 4 * COL)
        esum = envelope<128>(xs, gt, geo, st_e, ncols_e, wg, j0, n,
                             env_clamp, e + yrow);
      else
        esum = envelope<64>(xs, gt, geo, st_e, ncols_e, wg, j0, n,
                            env_clamp, e + yrow);
    }
    psum = warp_sum(psum);
    esum = warp_sum(esum);
    if (lane == 0) {
      pp[prow] = psum;
      gp[prow] = esum;
    }
    // the envelope's stream is read before the next item's input lands
    bar_sync(1, NCONS);
  }
}

}  // namespace

extern "C" {

const char* audian_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int chain_tile_max() { return TILE_MAX; }

int chain_tap_pad() { return wgconv::TPAD; }

int chain_warps() { return NWARP; }

long long chain_smem_bytes(int Tf, int L, int delay, int lead, int tail,
                           int nfft, int tj) {
  return smem_bytes(geometry(Tf, L, delay, lead, tail, 0, nfft, tj));
}

// h and g point at the host's split tap vectors [hi | lo], each half
// T + 2 TPAD long with TPAD zeros in front (ChainKernel.h_split /
// g_split); ws at the split, K-major slices of the pair-interleaved
// analysis matrix (ChainKernel.ws_slices).  pp and gp hold one partial per
// (channel, tile, consumer warp), qp one row of nbins per the same.
int chain_launch(const void* x, int x_i16, long long xlen, int C,
                 long long n, const float* h, int Tf, const float* g, int L,
                 int delay, int lead, int tail, int hb, const float* ws,
                 int nfft, int tj, int env_clamp, int want_f, int want_e,
                 int want_s, float* y, float* e, float* s, float* pp,
                 float* gp, float* qp, void* stream) {
  if (tj < 128 || tj > TILE_MAX || tj % 128 || nfft % SLICE_COLS)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(Tf, L, delay, lead, tail, hb, nfft, tj);
  const long long smem = smem_bytes(geo);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items = ((n + tj - 1) / tj) * (long long)C;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  chain_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      x, x_i16, xlen, n, C, geo, h, g, ws, env_clamp, want_f, want_e,
      want_s, y, e, s, pp, gp, qp);
  return (int)cudaGetLastError();
}

}  // extern "C"
