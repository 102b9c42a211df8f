// Single-pass song-detection envelope on Hopper's tensor cores (sm_90a,
// TF32 wgmma): int16 or float32 PCM -> zero-phase band-pass -> square ->
// decimating envelope low-pass -> 2 sqrt(max(e, 0)).
//
// Replaces audian_tpu/ops/pallas/envdet.py:_envdet_kernel (via
// _envdet_call).  With x the time-first window (W, C) dequantized (k / 2^15
// for int16) and zero outside [0, W), output j of channel c sits at window
// sample p_j = hb + j * step:
//
//   y[s]      = sum_{m<lb} g_bp[m] x[s + d_bp - m, c]
//   env[c, j] = 2 sqrt(max(0, sum_{m<ll} g_lp[m] y[p_j + d_lp - m]^2))
//
// What bounds it on the H100: arithmetic.  Each decimated output costs
// step * lb multiply-adds for its share of the band-passed stream plus ll
// for the envelope (10,732 at the song detector's default design, lb 511,
// ll 1023, step 19, 90 % of them in the band-pass) against 38 bytes read.
// The band-pass runs on the tensor cores in three TF32 passes by default,
// which keeps the fp32 precision of the sums, or in one (the mode the
// host's precision picks: DEFAULT), its light units (host flags) in one
// pass either way; the least time of the true taps at three passes is then
// 3 x 3.8e10 FLOP at 495 TFLOP/s, about 0.23 ms a headline chunk, against
// 0.022 ms of device-memory traffic.  The decimating stage runs in fp32
// FMAs under every precision.
//
// Design.  A block of two warpgroups owns T consecutive outputs of one
// channel (grid: the C blocks of one tile side by side, channel fastest):
//
//   1. it reads its channel's input span, (T - 1) step + ll + lb - 1
//      samples, straight from the (W, C) window (rows 2 C or 4 C bytes
//      apart: the C blocks of a tile run together and share the 32-byte
//      sectors in L2, so no transposing copy is made), consecutive threads
//      on consecutive samples, each issuing all its loads of a batch before
//      it uses one; it dequantizes the span and splits it into TF32 hi and
//      lo once, as a quad-major stream in shared memory (wgmma_conv.cuh).
//      One channel's span is a column of 2- or 4-byte samples, which no
//      bulk copy or tensor map fetches alone; two blocks share an SM at
//      the headline tile, so one block's loads overlap the other's
//      products;
//   2. stage 1, the band-pass over ny = (T - 1) step + ll samples, runs as
//      Toeplitz wgmmas (wgconv::conv, 64-column chunks shared by the
//      warpgroups) against the host-split taps; its epilogue squares each
//      sample and writes it in polyphase layout: z_p[n] = y^2[step n + p],
//      p < step, each phase a contiguous fp32 row of zs words;
//   3. stage 2, the decimating envelope, is a sum over the phases of plain
//      correlations of q = ceil(ll / step) taps over z_p:
//        e[j] = sum_{p<step} sum_{m<q} r_p[m] z_p[j + m],
//      r_p[m] = g_lp[ll - 1 - step m - p] (zero past the taps; EnvDetKernel
//      .lp_phase), in fp32 FMAs: each thread takes eight consecutive
//      outputs of a share of the phases, its taps broadcast and a sliding
//      window of z_p in registers; the shares meet in shared memory (the
//      input's stream, free by then), added in a fixed order, and the sum
//      becomes 2 sqrt(max(e, 0)) in (C, nout).
//
// Why stage 2 is not on the tensor cores: each of its phases is a 54-tap
// correlation at the headline design, so a 64 x 8 Toeplitz slice holds a
// tap in 45 % of its entries, and the wgmma's N is the tile's 64-output
// columns: T / 64 = 5.  An m64n8k8 costs about 70 % of the SM cycles of an
// m64n64k8 (chip_smoke.py phase 1b; PERF.md, PR 11), so the 855 of a
// tile took longer than stage 1's band-pass; the same sums in FMAs take a
// fraction of that.
//
// Nothing full-rate leaves the block.  Stage 1 sums in blocks of 128 taps,
// whose partials are added to the total in fp32.  (ll - step) / (T step)
// of the stream is recomputed as halo: 16.5 % at the headline T = 320.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_conv.cuh"

namespace {

using hopper::fence_async;
using hopper::split_tf32;
using wgconv::COL;
using wgconv::qm_word;
using wgconv::stream_rows;

constexpr int NT = 256;        // threads per block: two warpgroups
constexpr int OUT = 8;         // stage-2 outputs a thread
constexpr int BATCH = 32;      // samples a thread loads before it uses one
constexpr int TILE_MIN = 64;
constexpr int TILE_MAX = 4096;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

struct Geometry {
  int lb, d_bp, ll, d_lp, step, nout, hb, T;
  int mode, phase;   // the band-pass's core mode (TF32X3 or TF32X1), units
  unsigned long long inv_step;   // ceil(2^32 / step): i / step for small i
  int q;        // taps a phase of stage 2
  int q8;       // q rounded up to 8 (the host's phase rows)
  int ny;       // band-passed samples of one tile
  int nx;       // input samples of one tile
  int ncols1;   // stage-1 output columns of 64
  int nu1;      // rows a plane of the split input stream
  int zs;       // words of one phase of y^2
  int ng;       // stage-2 output groups of OUT a pass of the threads
  int npg;      // stage-2 phase shares
};

__host__ __device__ inline Geometry geometry(int lb, int d_bp, int ll,
                                             int d_lp, int step, int nout,
                                             int hb, int T) {
  Geometry g;
  g.lb = lb;
  g.d_bp = d_bp;
  g.ll = ll;
  g.d_lp = d_lp;
  g.step = step;
  g.nout = nout;
  g.hb = hb;
  g.T = T;
  g.mode = wgconv::TF32X3;
  g.phase = 0;
  g.inv_step = ((1ULL << 32) + step - 1) / step;
  g.q = (ll + step - 1) / step;
  g.q8 = (g.q + 7) & ~7;
  g.ny = (T - 1) * step + ll;
  g.nx = g.ny + lb - 1;
  g.ncols1 = (g.ny + COL - 1) / COL;
  // a 64-column chunk reads 64 columns' source even where stage 1 has
  // fewer
  g.nu1 = stream_rows(hopper::imax(g.ncols1, COL), lb - 1);
  // stage 2 reads z_p[j + m] for j < T, m < q8 + OUT
  g.zs = T + g.q8 + OUT;
  g.ng = hopper::imin(T / OUT, NT);
  g.npg = NT / g.ng;
  return g;
}

// region X (the split input stream, then stage 2's shares) and the
// polyphase y^2
__host__ __device__ inline long long smem_bytes(const Geometry& g) {
  const long long x = 512LL * g.nu1, red = 4LL * g.npg * g.T;
  return (x > red ? x : red) + 4LL * g.step * g.zs;
}

// the block's input span, samples xbase + i of channel c for i < nx and
// inside the window (zero elsewhere), times scale, split into the stream
// xw.  Every load of a batch is issued, from an address clamped into the
// window, before any value is used: a load whose use waits behind a
// branch would wait for its own latency
template <class T>
__device__ __forceinline__ void stage_span(const T* __restrict__ x,
                                           float scale, long long W, int C,
                                           int c, long long xbase,
                                           const Geometry& g, uint32_t* xw) {
  const int ns = 64 * g.nu1;   // samples of a part
  for (int i0 = 0; i0 < ns; i0 += BATCH * NT) {
    T raw[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const long long s = xbase + i0 + b * NT + threadIdx.x;
      raw[b] = __ldcg(x + (s < W ? s : W - 1) * C + c);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * NT + threadIdx.x;
      if (i >= ns) continue;
      const float v =
          i < g.nx && xbase + i < W ? (float)raw[b] * scale : 0.0f;
      const int wd = qm_word(i, g.nu1);
      split_tf32(v, xw[wd], xw[ns + wd]);
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
envdet_kernel(const void* __restrict__ xv, int x_i16, long long W, int C,
              Geometry g, const float* __restrict__ bp,
              const int* __restrict__ light, const float* __restrict__ lp,
              float* __restrict__ env) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem);     // split input span
  float* red = reinterpret_cast<float*>(smem);          // stage-2 shares
  const long long xbytes = 512LL * g.nu1, rbytes = 4LL * g.npg * g.T;
  float* z = reinterpret_cast<float*>(smem + (xbytes > rbytes ? xbytes
                                                               : rbytes));
  const uint32_t x_at = hopper::smem_u32(xw);
  const wgconv::Stream xs = wgconv::stream_at(x_at, wgconv::TF32X3, g.nu1);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int c = blockIdx.x % C;
  const int j0 = (blockIdx.x / C) * g.T;
  const int tcount = min(g.T, g.nout - j0);

  // window sample of y^2 index 0 (the first output's sample less the
  // envelope's look-back), and of the staged x index 0 (less the
  // band-pass's); the host keeps xbase >= 0 for the first tile
  const long long s0 = (long long)g.hb + (long long)j0 * g.step + g.d_lp -
                       (g.ll - 1);
  const long long xbase = s0 + g.d_bp - (g.lb - 1);
  // zeros over the polyphase rows: stage 2 reads past each phase's last
  // sample against zero taps (stage 1 writes the samples after the
  // barrier)
  float4* z4 = reinterpret_cast<float4*>(z);
  for (int k = tid; k < g.step * g.zs / 4; k += NT)
    z4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // this block's column of the window: consecutive threads on
  // consecutive samples (a warp's loads touch 8 lines of 128 bytes at 16
  // int16 channels), each thread's samples of a batch loaded before any is
  // used; a sample's hi and lo go to its word of either part
  if (x_i16)
    stage_span(static_cast<const int16_t*>(xv), RAW16_SCALE, W, C, c, xbase,
               g, xw);
  else
    stage_span(static_cast<const float*>(xv), 1.0f, W, C, c, xbase, g, xw);
  fence_async();
  __syncthreads();

  // stage 1: y[s0 + i] = sum_m g_bp[m] x[i + lb - 1 - m], squared into
  // z_p[n] = y^2[s0 + step n + p]
  const wgconv::Stage sg{bp, g.lb, g.lb - 1, g.mode,
                         wgconv::steps(g.lb, g.lb - 1, 8, g.phase), light};
  for (int ch = wg; ch * COL < g.ncols1; ch += 2) {
    const int col0 = min(ch * COL, max(g.ncols1 - COL, 0));
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    wgconv::conv<64, 1>(xs, sg, col0, 0, sg.st.nvb, acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int U = col0 + wgconv::out_col(i);
      const int si = COL * U + wgconv::out_row(i);
      if (U < ch * COL || si >= g.ny) continue;
      // exact for si < 2^32 / step
      const int n = (int)((si * g.inv_step) >> 32);
      z[(si - n * g.step) * g.zs + n] = acc[i] * acc[i];
    }
  }
  __syncthreads();

  // stage 2: e[j] = sum_p sum_m r_p[m] z_p[j + m], output groups of OUT
  // a thread over the phase share pg
  const int pg = tid / g.ng;
  for (int og = tid % g.ng; pg < g.npg && og < g.T / OUT; og += g.ng) {
    const int jb = OUT * og;
    float acc[OUT];
#pragma unroll
    for (int r = 0; r < OUT; ++r) acc[r] = 0.0f;
    for (int p = pg; p < g.step; p += g.npg) {
      const float* zp = z + p * g.zs + jb;
      const float4* tp = reinterpret_cast<const float4*>(lp + p * g.q8);
      float w[2 * OUT];
      *reinterpret_cast<float4*>(w) = *reinterpret_cast<const float4*>(zp);
      *reinterpret_cast<float4*>(w + 4) =
          *reinterpret_cast<const float4*>(zp + 4);
      for (int m0 = 0; m0 < g.q8; m0 += OUT) {
        *reinterpret_cast<float4*>(w + 8) =
            *reinterpret_cast<const float4*>(zp + m0 + 8);
        *reinterpret_cast<float4*>(w + 12) =
            *reinterpret_cast<const float4*>(zp + m0 + 12);
        const float4 ta = __ldg(tp + m0 / 4), tb = __ldg(tp + m0 / 4 + 1);
        const float t[OUT] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w};
#pragma unroll
        for (int mm = 0; mm < OUT; ++mm)
#pragma unroll
          for (int r = 0; r < OUT; ++r) acc[r] = fmaf(t[mm], w[r + mm], acc[r]);
#pragma unroll
        for (int r = 0; r < OUT; ++r) w[r] = w[r + OUT];
      }
    }
#pragma unroll
    for (int r = 0; r < OUT; ++r) red[pg * g.T + jb + r] = acc[r];
  }
  __syncthreads();
  float* out = env + (long long)c * g.nout + j0;
  for (int j = tid; j < tcount; j += NT) {
    float e = 0.0f;
    for (int k = 0; k < g.npg; ++k) e += red[k * g.T + j];
    out[j] = 2.0f * sqrtf(fmaxf(e, 0.0f));
  }
}

}  // namespace

extern "C" {

int envdet_tile_max() { return TILE_MAX; }

int envdet_tile_min() { return TILE_MIN; }

long long envdet_smem_bytes(int lb, int ll, int step, int T) {
  return smem_bytes(geometry(lb, 0, ll, 0, step, 0, 0, T));
}

// env is (C, nout) float32; x is the (W, C) window, contiguous, int16 or
// float32.  bp points at the host's split band-pass taps [hi | lo], each
// lb + 2 TPAD long with TPAD zeros in front (EnvDetKernel.bp_split), run in
// `mode` (TF32X3 or TF32X1) with the units from `phase` flagged by light
// (EnvDetKernel.light); lp at the phase taps, step rows of q rounded up to
// 8 (EnvDetKernel.lp_phase).  T is a multiple of 64 from TILE_MIN to
// TILE_MAX.
int envdet_launch(const void* x, int x_i16, long long W, int C,
                  const float* bp, int lb, int d_bp, int mode, int phase,
                  const int* light, const float* lp, int ll, int d_lp,
                  int step, int nout, int hb, int T, float* env,
                  void* stream) {
  if (T < TILE_MIN || T > TILE_MAX || T % 64 ||
      (mode != wgconv::TF32X3 && mode != wgconv::TF32X1) || phase < 0 ||
      phase >= 16)
    return (int)cudaErrorInvalidValue;
  Geometry g = geometry(lb, d_bp, ll, d_lp, step, nout, hb, T);
  g.mode = mode;
  g.phase = phase;
  const long long smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      envdet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)C * ((nout + T - 1) / T);
  envdet_kernel<<<(unsigned)blocks, NT, (size_t)smem,
                  (cudaStream_t)stream>>>(x, x_i16, W, C, g, bp, light, lp,
                                          env);
  return (int)cudaGetLastError();
}

}  // extern "C"
