// Strided-window matrix product on Hopper's tensor cores (sm_90a, TF32
// warpgroup wgmma, hopper.cuh).
//
//   y[f, c, o] = sum_{k<K} p(x[c, f*S + k]) * w[k, o]      f < nframes
//
// x is (C, n), channels-first, zero-extended past n: float32, or int16
// PCM-16 dequantized (k / 2^15) as the windows are gathered.  p is the
// identity, the rectifier (pi/2)|v|, or the square v*v.  Output layout 0
// ("fco") writes (nframes, C, O), layout 1 ("cf") the channels-first
// stream (C, nframes*O).
//
// Replaces audian_tpu/ops/pallas/window_matmul.py:_kernel: the per-stage
// path of the fused chain (filter bank K=269, envelope bank K=1262 with
// the rectifier, Hann-DFT analysis K=nfft with O = nfft + 2), the two
// stages of the IFIR envelope, and the two stages of the song-detection
// EnvDet (band-pass bank K=638 on int16 with the dequantizer; the
// decimating envelope bank K=3436 at stride 2432 with the square).
//
// Precision.  HIGHEST (and HIGH) run each product as three TF32 passes
// (3xTF32: fp32 precision), DEFAULT as one, hi*hi, the pass XLA runs an
// f32 DEFAULT dot as on this card: a template instance of its own, whose
// ring carries only the hi part of w's split and whose A is rounded to
// TF32 alone.
//
// What bounds it on the H100: arithmetic.  An output costs K multiply-adds
// in three TF32 passes against 4 bytes written and S / O input bytes read,
// so every caller above is bound by the tensor cores' TF32 rate, except
// the short filter (K=269), where the input and output streams (8 bytes a
// sample) and the launch are not negligible beside its products.  Short
// of that rate, what holds it is the consumers' instructions a step: the
// gather, premap and split of A between wgmmas (PERF.md §6).
//
// Design.  A persistent grid, one block an SM, walks the (channel, frame
// tile) items, a tile being F = 128 frames.  A block is two consumer
// warpgroups, each owning 64 frames (the M of its wgmmas), and a producer
// warpgroup whose registers go to the consumers (setmaxnreg) and whose
// first two warps issue the copies, one w's stages, the other the inputs:
//
//   - w is split into TF32 hi and lo once per bank by split_w_kernel (the
//     host caches the result), K-major and in the core-matrix order a
//     no-swizzle B descriptor reads: for each column block of N columns
//     and 8-tap step, [hi | lo], each two k-quads of N/8 core matrices.
//     The producer streams it through a ring of stages of two steps, one
//     cp.async.bulk a stage, and both consumer warpgroups read each stage,
//     so w crosses L2 once for every 128 frames;
//   - span mode: the producer copies an item's input span, (F - 1) S + K
//     samples from its start aligned down to 16 bytes, into shared memory
//     by cp.async.bulk in chunks of 2^lsh samples, each chunk followed by
//     16 bytes of padding (the host picks lsh from S so that the eight
//     frames of a fragment fall in distinct banks); two span buffers where
//     they fit, so that the next item's copy overlaps this one's products.
//     Every sample crosses device memory once (plus the K - S overlap of
//     consecutive tiles) instead of K/S times;
//   - rows mode, where the span does not fit (the decimating envelope,
//     S = 2432): the tile's window rows of each unit's 128 taps, one bulk
//     copy a row, into two buffers;
//   - the consumers gather each step's A fragment (frames on M, taps on K)
//     from the span or the rows, zero past n and past K, premap it and
//     split it into TF32 hi and lo in registers (split_fast), then run
//     m64nNk8 wgmmas, hi*lo, lo*hi, hi*hi, into the unit's accumulator;
//     the register sets of a stage's two steps alternate, so that one
//     step's gather runs while the other's products do.  Only the last
//     step, and an item whose samples do not all lie in the tensor, mask.
//
// O is cut into column blocks of N = 128, 136 or 176 columns (the
// narrowest that covers O in the fewest blocks of at most 176): 128 -> 128,
// 258 -> 2 x 136 (14 columns of padding, 5.4 %), 514 -> 3 x 176 (14,
// 2.7 %).  An item's span serves all of its column blocks.  Sums run in
// units of 16 steps (128 taps), each unit's partial added to the total in
// fp32, which keeps the 3436-tap decimating bank inside 1e-5.  Outputs
// leave as 8-byte vectors along o (both layouts are contiguous along o).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::split_tf32;

constexpr int F = 128;            // frames an item: two warpgroups of 64
constexpr int NCONS = 256;        // consumer threads
constexpr int NT = NCONS + 128;   // and the producer warpgroup
constexpr int NWARP = NCONS / 32;
constexpr int SPS = 2;            // 8-tap steps a ring stage
constexpr int UNIT = 16;          // steps a unit (128 taps)
constexpr int RING_MAX = 8;
constexpr int ROW_TAPS = UNIT * 8;   // taps a window row of rows mode
constexpr int SMEM_MAX = 232448;
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

// premap codes (PREMAPS in ops/cuda/window_matmul.py); the dequantizer is
// the int16 load itself, so on float32 input it is the identity
enum Premap { IDENTITY = 0, RECTIFY = 1, DEQUANT = 2, SQUARE = 3 };
enum Mode { SPAN = 0, ROWS = 1 };
// mbarriers after the ring and the spans
enum { SPAN_FULL0, SPAN_EMPTY0 = 2, FULL0 = 4, EMPTY0 = FULL0 + RING_MAX,
       NBAR = EMPTY0 + RING_MAX };

struct Geometry {
  int one;            // one TF32 pass (DEFAULT) instead of three
  int K, V, Vp;       // taps; 8-tap steps; steps padded to whole stages
  int O, N, ncb;      // columns; a column block's; column blocks
  int S, es, lsh;     // stride; bytes a sample; log2 of a span chunk
  int mode, nbuf, ring;
  int b_bytes;        // a ring stage: w's SPS steps, hi and lo
  int rp;             // bytes a window row (rows mode)
  long long span_bytes;   // an A buffer: a span, or F window rows
};

__host__ __device__ inline Geometry geometry(int K, int O, int S, int es,
                                             int N, int mode, int lsh,
                                             int nbuf, int ring, int one) {
  Geometry g;
  g.one = one;
  g.K = K;
  g.V = (K + 7) / 8;
  g.Vp = (g.V + SPS - 1) / SPS * SPS;
  g.O = O;
  g.N = N;
  g.ncb = (O + N - 1) / N;
  g.S = S;
  g.es = es;
  g.lsh = lsh;
  g.mode = mode;
  g.nbuf = mode == SPAN ? nbuf : 2;
  g.ring = ring;
  g.b_bytes = SPS * (one ? 1 : 2) * 8 * N * 4;
  // a unit's taps and up to 15 bytes of alignment, rounded to 16 bytes
  g.rp = ROW_TAPS * es + 16;
  if (mode == SPAN) {
    // the samples a span may hold: its alignment, F frames, whole steps
    const long long e = 16 / es - 1 + (long long)(F - 1) * S + 8LL * g.V;
    const long long chunks = (e + (1LL << lsh) - 1) >> lsh;
    g.span_bytes = chunks * (((long long)es << lsh) + 16);
  } else {
    g.span_bytes = (long long)F * g.rp;
  }
  return g;
}

__host__ __device__ inline long long smem_bytes(const Geometry& g) {
  return (long long)g.ring * g.b_bytes + g.nbuf * g.span_bytes + 8 * NBAR;
}

// byte of span sample e (counted from the span's aligned start): chunks of
// 2^lsh samples, each followed by 16 bytes of padding
__device__ __forceinline__ int span_byte(int e, int es, int lsh) {
  return es * e + ((e >> lsh) << 4);
}

// an item's input span: from the 16-byte aligned address at or below its
// first sample to a 16-byte boundary past its last sample in the tensor
struct Span {
  const char* src;   // aligned start
  int off;           // samples from src to the span's first sample
  int lim;           // off + the samples that lie in the tensor
  uint32_t bytes;    // bytes to copy (0: none lies in the tensor)
};

__device__ __forceinline__ Span span_of(const void* x, int es, long long n,
                                        int c, long long first, long long len) {
  const long long cnt = min(len, max(n - first, 0LL));
  const char* p = static_cast<const char*>(x) + ((long long)c * n + first) * es;
  Span s;
  s.src = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                        ~(uintptr_t)15);
  s.off = (int)(p - s.src) / es;
  s.lim = s.off + (int)cnt;
  s.bytes = cnt > 0 ? (uint32_t)((s.off * es + cnt * es + 15) & ~15LL) : 0u;
  return s;
}

// a window row of rows mode: the 128 taps of unit u of one frame, from
// sample col on
struct Row {
  const char* src;
  int off;           // bytes from src to the row's first tap
  uint32_t bytes;    // 0: no tap lies in the tensor
};

__device__ __forceinline__ Row row_of(const void* x, int es, long long n,
                                      int c, long long col) {
  const long long cnt = min((long long)ROW_TAPS, max(n - col, 0LL));
  const char* p = static_cast<const char*>(x) + ((long long)c * n + col) * es;
  Row r;
  r.src = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) &
                                        ~(uintptr_t)15);
  r.off = (int)(p - r.src);
  r.bytes = cnt > 0 ? (uint32_t)((r.off + cnt * es + 15) & ~15LL) : 0u;
  return r;
}

// wt holds, for column block cb and step v, [hi | lo] at word
// ((cb Vp + v) 2 + part) 8N, each part two k-quads of N/8 core matrices:
// w[8v + 4q + kk][cb N + 8j + r] at + 4N q + 32 j + 4 r + kk, zero past K
// and O
__global__ void split_w_kernel(const float* __restrict__ w, int K, int O,
                               int N, int Vp, long long words,
                               uint32_t* __restrict__ wt) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < words; i += (long long)gridDim.x * blockDim.x) {
    const int in = (int)(i % (8 * N));
    const long long rest = i / (8 * N);
    const int part = (int)(rest & 1);
    const int v = (int)((rest >> 1) % Vp);
    const int cb = (int)((rest >> 1) / Vp);
    const int q = in / (4 * N), in2 = in % (4 * N);
    const int k = 8 * v + 4 * q + (in2 & 3);
    const int o = cb * N + 8 * (in2 / 32) + ((in2 >> 2) & 7);
    uint32_t hi = 0, lo = 0;
    if (k < K && o < O) split_tf32(w[(long long)k * O + o], hi, lo);
    wt[i] = part ? lo : hi;
  }
}

// one step's three passes into part from the stage's step at b, A from
// (ah, al), committed as one group
template <int N>
__device__ __forceinline__ void mma3(float (&part)[N / 2],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b,
                                     int first) {
  const uint64_t dh = hopper::desc(b, 16 * N, 128);
  const uint64_t dl = hopper::desc(b + 32 * N, 16 * N, 128);
  hopper::wgmma_fence();
  hopper::Mma<N>::run(part, ah, dl, !first);
  hopper::Mma<N>::run(part, al, dh, 1);
  hopper::Mma<N>::run(part, ah, dh, 1);
  hopper::wgmma_commit();
}

// one step's one pass (DEFAULT) into part from the stage's hi at b
template <int N>
__device__ __forceinline__ void mma1(float (&part)[N / 2],
                                     const uint32_t (&ah)[4], uint32_t b,
                                     int first) {
  hopper::wgmma_fence();
  hopper::Mma<N>::run(part, ah, hopper::desc(b, 16 * N, 128), !first);
  hopper::wgmma_commit();
}

// A's TF32 split: hi is cvt.rna.tf32.f32 in integer arithmetic (x + half
// a TF32 unit, the low 13 bits cleared: equal for every finite x and for
// +-inf), lo is x - hi as it is, truncated to TF32 by the tensor cores,
// which read an operand's top 19 bits (within 2^-21 |x| where a rounded
// lo is within 2^-22).  Three instructions against the conversions'
// nine.  A NaN x may round to a finite hi or to inf, but x - hi is then
// NaN, and so is lo read as TF32, so the NaN reaches the products.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float premap_of(float v, int premap) {
  if (premap == RECTIFY) return HALF_PI * fabsf(v);
  if (premap == SQUARE) return v * v;
  return v;
}

template <bool I16>
__device__ __forceinline__ float load_at(const unsigned char* p) {
  if (I16) return (float)*reinterpret_cast<const int16_t*>(p) * RAW16_SCALE;
  return *reinterpret_cast<const float*>(p);
}

// A of step v (taps 8v + t, 8v + t + 4 of rows m0, m0 + 8): premapped and
// split into (ah, al), or with ONE rounded into ah alone by cvt.rna (which
// keeps a NaN a NaN, where the integer rounding may not); a[j] is the
// value, ok[j] whether it lies in the window and the tensor
template <bool ONE>
__device__ __forceinline__ void split_a(const float (&a)[4],
                                        const bool (&ok)[4], int premap,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = premap_of(ok[j] ? a[j] : 0.0f, premap);
    if (ONE)
      ah[j] = hopper::to_tf32(v);
    else
      split_fast(v, ah[j], al[j]);
  }
}

struct Args {
  const void* x;
  long long n;
  int C, nframes, premap, layout;
  const uint32_t* wt;
  float* y;
};

template <int N, bool I16, bool ONE>
__global__ void __launch_bounds__(NT, 1) window_matmul_kernel(Args a,
                                                              Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = I16 ? 2 : 4;
  constexpr int UST = UNIT / SPS;     // ring stages a unit
  unsigned char* ring = smem;
  unsigned char* abuf = smem + (long long)geo.ring * geo.b_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(abuf +
                                              geo.nbuf * geo.span_bytes);
  const int tid = threadIdx.x;
  const int ntiles = (a.nframes + F - 1) / F;
  const long long nitems = (long long)ntiles * a.C;
  const int nst = geo.Vp / SPS;       // stages a column block
  const int nunits = (nst + UST - 1) / UST;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&bar[SPAN_FULL0 + b], 1);
      mbar_init(&bar[SPAN_EMPTY0 + b], NWARP);
    }
    for (int i = 0; i < RING_MAX; ++i) {
      mbar_init(&bar[FULL0 + i], 1);
      mbar_init(&bar[EMPTY0 + i], NWARP);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // -- the producers --------------------------------------------------------
    // the warpgroup's registers go to the consumers; its first warp streams
    // w's stages, its second the A buffers (spans, or a unit's window
    // rows), each in the order the consumers read them
    hopper::regs_dec<56>();
    const int pw = (tid - NCONS) >> 5, lane = tid & 31;
    if (pw == 0 && lane == 0) {
      int sc = 0;
      for (long long item = blockIdx.x; item < nitems; item += gridDim.x)
        for (int cb = 0; cb < geo.ncb; ++cb)
          for (int s = 0; s < nst; ++s, ++sc) {
            const int st = sc % geo.ring;
            const uint32_t* src =
                a.wt + ((long long)cb * geo.Vp + SPS * s) * 16 * N;
            mbar_wait(&bar[EMPTY0 + st], ((sc / geo.ring) & 1) ^ 1);
            mbar_expect(&bar[FULL0 + st], geo.b_bytes);
            if (ONE) {
              // the hi part of each step: 8 N words from every 16 N
              for (int j = 0; j < SPS; ++j)
                hopper::bulk_load(ring + st * geo.b_bytes + j * 32 * N,
                                  src + j * 16 * N, 32 * N,
                                  &bar[FULL0 + st]);
            } else {
              hopper::bulk_load(ring + st * geo.b_bytes, src, geo.b_bytes,
                                &bar[FULL0 + st]);
            }
          }
    } else if (pw == 1) {
      int ka = 0;
      for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
        const int c = (int)(item % a.C);
        const long long f0 = (item / a.C) * F;
        if (geo.mode == SPAN) {
          const int b = ka % geo.nbuf, use = ka / geo.nbuf;
          const long long nf = min((long long)F, a.nframes - f0);
          const Span sp = span_of(a.x, ES, a.n, c, f0 * geo.S,
                                  (nf - 1) * geo.S + 8LL * geo.V);
          mbar_wait(&bar[SPAN_EMPTY0 + b], (use & 1) ^ 1);
          if (lane == 0) mbar_expect(&bar[SPAN_FULL0 + b], sp.bytes);
          __syncwarp();
          const uint32_t chunk = (uint32_t)ES << geo.lsh;
          unsigned char* dst = abuf + b * geo.span_bytes;
          for (uint32_t j = lane; j * chunk < sp.bytes; j += 32)
            hopper::bulk_load(dst + j * (chunk + 16), sp.src + j * chunk,
                              min(chunk, sp.bytes - j * chunk),
                              &bar[SPAN_FULL0 + b]);
          ++ka;
          continue;
        }
        for (int cb = 0; cb < geo.ncb; ++cb)
          for (int u = 0; u < nunits; ++u, ++ka) {
            const int b = ka & 1, use = ka >> 1;
            mbar_wait(&bar[SPAN_EMPTY0 + b], (use & 1) ^ 1);
            uint32_t bytes = 0;
            for (int r = lane; r < F; r += 32)
              if (f0 + r < a.nframes)
                bytes += row_of(a.x, ES, a.n, c,
                                (f0 + r) * geo.S + ROW_TAPS * u).bytes;
            bytes = __reduce_add_sync(0xffffffffu, bytes);
            if (lane == 0) mbar_expect(&bar[SPAN_FULL0 + b], bytes);
            __syncwarp();
            unsigned char* dst = abuf + b * geo.span_bytes;
            for (int r = lane; r < F; r += 32) {
              if (f0 + r >= a.nframes) continue;
              const Row rw = row_of(a.x, ES, a.n, c,
                                    (f0 + r) * geo.S + ROW_TAPS * u);
              if (rw.bytes)
                hopper::bulk_load(dst + r * geo.rp, rw.src, rw.bytes,
                                  &bar[SPAN_FULL0 + b]);
            }
          }
      }
    }
    return;
  }

  // -- the consumers ----------------------------------------------------------
  hopper::regs_inc<224>();
  const int wg = tid >> 7;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = (tid >> 2) & 7, t = tid & 3;
  const int m0 = 64 * wg + 16 * (warp & 3) + g;   // rows m0 and m0 + 8
  int sc = 0, ka = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int c = (int)(item % a.C);
    const long long f0 = (item / a.C) * F;
    // span mode: this thread's samples of step 0 at e0 (row m0) and e0 +
    // 8 S (row m0 + 8), the ones below sp.lim in the tensor; rows mode:
    // its rows' first samples and alignments.  In a clean item every
    // sample a step reads lies in the tensor, so only the last step masks.
    Span sp{nullptr, 0, 0, 0u};
    const long long rcol0 = (f0 + m0) * geo.S, rcol1 = rcol0 + 8LL * geo.S;
    const int roff0 = row_of(a.x, ES, a.n, c, rcol0).off;
    const int roff1 = row_of(a.x, ES, a.n, c, rcol1).off;
    const unsigned char* buf = nullptr;
    bool clean = f0 + F <= a.nframes &&
                 (f0 + F - 1) * geo.S + 8LL * geo.V <= a.n;
    if (geo.mode == SPAN) {
      const long long nf = min((long long)F, a.nframes - f0);
      sp = span_of(a.x, ES, a.n, c, f0 * geo.S,
                   (nf - 1) * geo.S + 8LL * geo.V);
      buf = abuf + (ka % geo.nbuf) * geo.span_bytes;
      mbar_wait(&bar[SPAN_FULL0 + ka % geo.nbuf], (ka / geo.nbuf) & 1);
    }
    const int e0 = sp.off + m0 * geo.S + t;
    // the bytes from a sample to the one 8 S on, where 8 S is whole chunks
    const int row8 = (8 * geo.S) & ((1 << geo.lsh) - 1)
        ? -1 : span_byte(8 * geo.S, ES, geo.lsh);

    // A of step v into (ah, al): from the span, or from unit v / 16's
    // rows; with MASK, zero past n and past K
    auto gather = [&](auto mask, int v, uint32_t (&ah)[4],
                      uint32_t (&al)[4]) {
      constexpr bool MASK = decltype(mask)::value;
      float x4[4];
      bool ok[4] = {true, true, true, true};
      const int kt = 8 * v + t;
      if (geo.mode == SPAN) {
        const int e[4] = {e0 + 8 * v, e0 + 8 * v + 8 * geo.S,
                          e0 + 8 * v + 4, e0 + 8 * v + 8 * geo.S + 4};
        const int b00 = span_byte(e[0], ES, geo.lsh);
        const int b01 = span_byte(e[2], ES, geo.lsh);
        const unsigned char* p[4] = {
            buf + b00, buf + (row8 >= 0 ? b00 + row8
                                        : span_byte(e[1], ES, geo.lsh)),
            buf + b01, buf + (row8 >= 0 ? b01 + row8
                                        : span_byte(e[3], ES, geo.lsh))};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x4[j] = load_at<I16>(p[j]);
          if (MASK) ok[j] = e[j] < sp.lim && kt + 4 * (j >> 1) < geo.K;
        }
      } else {
        const int kk = ES * (8 * (v % UNIT) + t);
        const unsigned char* r0 = buf + m0 * geo.rp + roff0 + kk;
        const unsigned char* r1 = buf + (m0 + 8) * geo.rp + roff1 + kk;
        x4[0] = load_at<I16>(r0);
        x4[1] = load_at<I16>(r1);
        x4[2] = load_at<I16>(r0 + 4 * ES);
        x4[3] = load_at<I16>(r1 + 4 * ES);
        if (MASK) {
          ok[0] = kt < geo.K && rcol0 + kt < a.n;
          ok[1] = kt < geo.K && rcol1 + kt < a.n;
          ok[2] = kt + 4 < geo.K && rcol0 + kt + 4 < a.n;
          ok[3] = kt + 4 < geo.K && rcol1 + kt + 4 < a.n;
        }
      }
      split_a<ONE>(x4, ok, a.premap, ah, al);
    };

    for (int cb = 0; cb < geo.ncb; ++cb) {
      float total[N / 2], part[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) total[i] = part[i] = 0.0f;
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      // the ring stage (and its phase) the next stage waits on, and the
      // one before it, handed back once its last step has retired
      int st_w = sc % geo.ring, ph_w = (sc / geo.ring) & 1, st_p = 0;
      for (int u = 0; u < nunits; ++u) {
        if (geo.mode == ROWS) {
          buf = abuf + (ka & 1) * geo.span_bytes;
          mbar_wait(&bar[SPAN_FULL0 + (ka & 1)], (ka >> 1) & 1);
        }
        const int s0 = UST * u, s1 = min(nst, s0 + UST);
        for (int s = s0; s < s1; ++s) {
          mbar_wait(&bar[FULL0 + st_w], ph_w);
          const uint32_t b = hopper::smem_u32(ring + st_w * geo.b_bytes);
          const int v = SPS * s;
          if (clean && v + 1 < geo.V)
            gather(std::false_type(), v, ah0, al0);
          else
            gather(std::true_type(), v, ah0, al0);
          if (ONE)
            mma1<N>(part, ah0, b, s == s0);
          else
            mma3<N>(part, ah0, al0, b, s == s0);
          hopper::wgmma_wait<1>();
          // the previous stage's last step has retired: hand it back
          if (s > 0 && lane == 0) mbar_arrive(&bar[EMPTY0 + st_p]);
          if (v + 1 < geo.V) {
            if (clean && v + 2 < geo.V)
              gather(std::false_type(), v + 1, ah1, al1);
            else
              gather(std::true_type(), v + 1, ah1, al1);
            if (ONE)
              mma1<N>(part, ah1, b + 32 * N, 0);
            else
              mma3<N>(part, ah1, al1, b + 64 * N, 0);
            hopper::wgmma_wait<1>();
          }
          st_p = st_w;
          if (++st_w == geo.ring) {
            st_w = 0;
            ph_w ^= 1;
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(part);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) total[i] += part[i];
        if (geo.mode == ROWS) {
          if (lane == 0) mbar_arrive(&bar[SPAN_EMPTY0 + (ka & 1)]);
          ++ka;
        }
      }
      if (lane == 0) mbar_arrive(&bar[EMPTY0 + st_p]);
      sc += nst;

      // rows m0 and m0 + 8: columns cb N + 8 j + 2 t, + 1 as 8-byte vectors
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long fr = f0 + m0 + 8 * hf;
        if (fr >= a.nframes) continue;
        float* row = a.layout == 0
            ? a.y + (fr * a.C + c) * (long long)geo.O
            : a.y + ((long long)c * a.nframes + fr) * geo.O;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int o = cb * N + 8 * j + 2 * t;
          const float v0 = total[4 * j + 2 * hf];
          const float v1 = total[4 * j + 2 * hf + 1];
          if ((geo.O & 1) == 0) {
            if (o < geo.O)
              *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
          } else {
            if (o < geo.O) row[o] = v0;
            if (o + 1 < geo.O) row[o + 1] = v1;
          }
        }
      }
    }
    // the span is read: the producer may copy the item after next into it
    if (geo.mode == SPAN) {
      if (lane == 0) mbar_arrive(&bar[SPAN_EMPTY0 + ka % geo.nbuf]);
      ++ka;
    }
  }
}

template <int N, bool I16, bool ONE>
int launch(const Args& a, const Geometry& geo, cudaStream_t stream) {
  const long long smem = smem_bytes(geo);
  cudaError_t err = cudaFuncSetAttribute(
      window_matmul_kernel<N, I16, ONE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (long long)((a.nframes + F - 1) / F) * a.C;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  window_matmul_kernel<N, I16, ONE><<<grid, NT, (size_t)smem, stream>>>(a,
                                                                        geo);
  return (int)cudaGetLastError();
}

template <int N>
int launch_n(const Args& a, const Geometry& geo, int x_i16,
             cudaStream_t stream) {
  if (geo.one)
    return x_i16 ? launch<N, true, true>(a, geo, stream)
                 : launch<N, false, true>(a, geo, stream);
  return x_i16 ? launch<N, true, false>(a, geo, stream)
               : launch<N, false, false>(a, geo, stream);
}

bool valid(const Geometry& g) {
  const bool n_ok = g.N == 128 || g.N == 136 || g.N == 176;
  const bool span_ok = g.mode == ROWS ||
      ((g.nbuf == 1 || g.nbuf == 2) && ((g.es << g.lsh) % 16) == 0 &&
       g.lsh <= 12);
  return n_ok && span_ok && (g.mode == SPAN || g.mode == ROWS) &&
         g.ring >= 2 && g.ring <= RING_MAX && smem_bytes(g) <= SMEM_MAX;
}

}  // namespace

extern "C" {

long long window_matmul_smem_bytes(int K, int O, int S, int es, int N,
                                   int mode, int lsh, int nbuf, int ring,
                                   int one) {
  return smem_bytes(geometry(K, O, S, es, N, mode, lsh, nbuf, ring, one));
}

// 32-bit words of w's split for column blocks of N
long long window_matmul_split_words(int K, int O, int N) {
  const Geometry g = geometry(K, O, 1, 4, N, ROWS, 0, 0, 2, 0);
  return (long long)g.ncb * g.Vp * 16 * N;
}

int window_matmul_split_launch(const float* w, int K, int O, int N,
                               uint32_t* wt, void* stream) {
  const long long words = window_matmul_split_words(K, O, N);
  const Geometry g = geometry(K, O, 1, 4, N, ROWS, 0, 0, 2, 0);
  const long long blocks = (words + 255) / 256;
  split_w_kernel<<<(unsigned)(blocks < 2048 ? blocks : 2048), 256, 0,
                   (cudaStream_t)stream>>>(w, K, O, N, g.Vp, words, wt);
  return (int)cudaGetLastError();
}

// wt: window_matmul_split_words(K, O, N) words from
// window_matmul_split_launch; the geometry (N, mode, lsh, nbuf, ring) is
// the host's plan (ops/cuda/window_matmul.py:plan); one: one TF32 pass
// (DEFAULT) instead of three
int window_matmul_launch(const void* x, int x_i16, long long n, int C,
                         const uint32_t* wt, int K, int O, int S,
                         int nframes, int premap, int layout, float* y, int N,
                         int mode, int lsh, int nbuf, int ring, int one,
                         void* stream) {
  const Geometry geo =
      geometry(K, O, S, x_i16 ? 2 : 4, N, mode, lsh, nbuf, ring, one != 0);
  if (!valid(geo)) return (int)cudaErrorInvalidValue;
  const Args a{x, n, C, nframes, premap, layout, wt, y};
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 128: return launch_n<128>(a, geo, x_i16, s);
    case 136: return launch_n<136>(a, geo, x_i16, s);
    default: return launch_n<176>(a, geo, x_i16, s);
  }
}

}  // extern "C"
