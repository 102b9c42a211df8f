// Single-pass song-detection envelope on Hopper's tensor cores (sm_90a,
// 3xTF32): int16 or float32 PCM -> zero-phase band-pass -> square ->
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
// The fp32 FMA form of this kernel loaded one shared-memory word per
// multiply-add and stopped near a third of the fp32 peak.  Here both
// stages run on the tensor cores in three TF32 passes (tf32x3.cuh), which
// keeps the fp32 precision of the sums; the least time of the true taps
// is then 3 x 3.8e10 FLOP at 495 TFLOP/s, about 0.23 ms a headline chunk,
// against 0.022 ms of device-memory traffic.  mma.sync itself runs below
// that rate, and each step of a Toeplitz product spends about as many
// issue slots on its fragment loads and addresses as on its MMAs.
//
// Design.  A block owns T consecutive outputs of one channel (grid: the C
// blocks of one tile side by side, channel fastest):
//
//   1. it reads its channel's input span, (T - 1) step + ll + lb - 1
//      samples, straight from the (W, C) window (rows 2 C or 4 C bytes
//      apart: the C blocks of a tile run together and share the 32-byte
//      sectors in L2, so no transposing copy is made), dequantizes it and
//      splits it into TF32 hi and lo once, as it writes it to shared memory
//      (toeplitz::put_split, sw_conv layout);
//   2. stage 1, the band-pass over ny = (T - 1) step + ll samples, runs as
//      Toeplitz-block MMAs (toeplitz::conv_mma) against the host-split
//      taps; its epilogue squares each sample and writes it, split, in
//      polyphase layout: z_p[n] = y^2[step n + p], p < step, each phase a
//      contiguous stream of zs words;
//   3. stage 2, the decimating envelope, is a sum over the phases of plain
//      correlations of q = ceil(ll / step) taps over z_p:
//        e[j] = sum_{p<step} sum_{i<q} g_r[step i + p] z_p[j + i]
//      (g_r the reversed taps), on the same conv_mma with the phase taps
//      split on the host.  The warps share the phases and meet in shared
//      memory (the input's buffer, free by then); the first warp finishes
//      2 sqrt(max(e, 0)) and stores (C, nout).
//
// Nothing full-rate leaves the block.  Sums run in blocks of 128 taps (a
// phase of stage 2 is one block), whose partials are added to the total in
// fp32.  What sets the speed is how many MMAs are in flight: each step of
// a Toeplitz product loads its fragments and then runs three dependent
// passes, so the SM needs many warps.  At the default design T = 256
// (chosen by the host, ops/cuda/envdet.py: the widest tile whose span fits,
// at most TILE_MAX) takes 105 KB of shared memory, so two blocks of twelve
// warps share an SM at 80 registers a thread, and 46 stage-1 tiles fill 48
// warp slots; (ll - step) / (T step) = 21 % of the stream is recomputed as
// halo.  One block of T = 512 an SM held too few warps (see PERF.md).  The
// window is read through L2 only (ld.global.cg), so the strided rows do not
// push the taps out of L1; the polyphase stream is zeroed with 16-byte
// stores before stage 1 fills it, and the epilogue divides by the step
// with a multiply.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "toeplitz_mma.cuh"

namespace {

using toeplitz::conv_mma;
using toeplitz::put_split;
using toeplitz::round32;
using toeplitz::SLACK;
using toeplitz::TPAD;

constexpr int NT = 384;        // threads per block
constexpr int NWARP = NT / 32;
constexpr int J1 = 4;          // stage-1 tiles of 128 samples a warp
constexpr int J2 = 2;          // stage-2 tiles of 128 outputs a warp
constexpr int TILE_MAX = 128 * J2;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

struct Geometry {
  int lb, d_bp, ll, d_lp, step, nout, hb, T;
  unsigned long long inv_step;   // ceil(2^32 / step): i / step for small i
  int q;        // taps a phase of stage 2
  int ny;       // band-passed samples of one tile
  int nt1;      // stage-1 tiles of 128 samples
  int nt2;      // stage-2 tiles of 128 outputs
  int xwords;   // words of each part of the split input span
  int zs;       // words of each phase of each part of the split y^2
};

Geometry geometry(int lb, int d_bp, int ll, int d_lp, int step, int nout,
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
  g.inv_step = ((1ULL << 32) + step - 1) / step;
  g.q = (ll + step - 1) / step;
  g.ny = (T - 1) * step + ll;
  g.nt1 = (g.ny + 127) / 128;
  g.nt2 = (T + 127) / 128;
  // conv_mma reads a stream on [0, 128 ntiles + D + 15)
  g.xwords = round32(128 * g.nt1 + lb - 1 + SLACK);
  g.zs = round32(128 * g.nt2 + g.q - 1 + SLACK);
  return g;
}

// words of the first region of shared memory: the split input span or,
// after stage 1, the warps' meeting point of stage 2, whichever is larger
__host__ __device__ int first_words(const Geometry& g) {
  const int red = (NWARP - 1) * 128 * g.nt2;
  return 2 * g.xwords > red ? 2 * g.xwords : red;
}

// the first region and the split polyphase y^2
long long smem_words(const Geometry& g) {
  return first_words(g) + 2LL * g.step * g.zs;
}

__global__ void __launch_bounds__(NT, 2)
envdet_kernel(const void* __restrict__ xv, int x_i16, long long W, int C,
              Geometry g, const float* __restrict__ bp,
              const float* __restrict__ lp, float* __restrict__ env) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);   // split input span
  uint32_t* zs = xs + first_words(g);                 // split y^2, polyphase
  const int zwords = g.step * g.zs;

  const int tid = threadIdx.x;
  const int c = blockIdx.x % C;
  const int j0 = (blockIdx.x / C) * g.T;
  const int tcount = min(g.T, g.nout - j0);

  // window sample of y^2 index 0 (the first output's sample less the
  // envelope's look-back), and of the staged x index 0 (less the
  // band-pass's); the host keeps xbase >= 0 for the first tile
  const long long s0 = (long long)g.hb + (long long)j0 * g.step + g.d_lp -
                       (g.ll - 1);
  const long long xbase = s0 + g.d_bp - (g.lb - 1);
  const int nx = g.ny + g.lb - 1;
  if (x_i16) {
    const int16_t* x = static_cast<const int16_t*>(xv) + c;
#pragma unroll 4
    for (int i = tid; i < g.xwords; i += NT) {
      const long long s = xbase + i;
      put_split(xs, g.xwords, i,
                i < nx && s < W ? (float)__ldcg(x + s * C) * RAW16_SCALE
                                : 0.0f);
    }
  } else {
    const float* x = static_cast<const float*>(xv) + c;
#pragma unroll 4
    for (int i = tid; i < g.xwords; i += NT) {
      const long long s = xbase + i;
      put_split(xs, g.xwords, i, i < nx && s < W ? __ldcg(x + s * C) : 0.0f);
    }
  }
  // zeros over the polyphase stream: stage 2 reads past each phase's last
  // sample against zero taps and the zero corners of its slices (stage 1
  // writes the samples after the barrier)
  uint4* z4 = reinterpret_cast<uint4*>(zs);
  for (int k = tid; k < zwords / 2; k += NT) z4[k] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // stage 1: y[s0 + i] = sum_m g_bp[m] xs[i + lb - 1 - m], squared into
  // z_p[n] = y^2[s0 + step n + p]
  conv_mma<NWARP, J1, 1>(xs, g.xwords, bp, g.lb, g.lb - 1, g.nt1, nullptr,
                         [&](int i, float v) {
                           if (i < g.ny) {
                             // exact for i < 2^32 / step
                             const int n = (int)((i * g.inv_step) >> 32);
                             const int p = i - n * g.step;
                             put_split(zs, zwords, p * g.zs + n, v * v);
                           }
                         });
  __syncthreads();

  // stage 2: e[jl] = sum_p sum_{m<q} lp_p[m] z_p[jl + q - 1 - m]
  float* out = env + (long long)c * g.nout + j0;
  conv_mma<NWARP, J2, NWARP>(zs, zwords, lp, g.q, g.q - 1, g.nt2,
                             reinterpret_cast<float*>(xs),
                             [&](int i, float v) {
                               if (i < tcount)
                                 out[i] = 2.0f * sqrtf(fmaxf(v, 0.0f));
                             },
                             g.step, g.zs, 2 * (g.q + 2 * TPAD));
}

}  // namespace

extern "C" {

int envdet_tile_max() { return TILE_MAX; }

long long envdet_smem_bytes(int lb, int ll, int step, int T) {
  return smem_words(geometry(lb, 0, ll, 0, step, 0, 0, T)) *
         (long long)sizeof(float);
}

// env is (C, nout) float32; x is the (W, C) window, contiguous, int16 or
// float32.  bp points at the host's split band-pass taps [hi | lo], each
// lb + 2 TPAD long with TPAD zeros in front (EnvDetKernel.bp_split); lp at
// the split phase taps, step blocks of 2 (q + 2 TPAD) (EnvDetKernel
// .lp_split).  T <= TILE_MAX.
int envdet_launch(const void* x, int x_i16, long long W, int C,
                  const float* bp, int lb, int d_bp, const float* lp,
                  int ll, int d_lp, int step, int nout, int hb, int T,
                  float* env, void* stream) {
  if (T < 1 || T > TILE_MAX) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(lb, d_bp, ll, d_lp, step, nout, hb, T);
  const long long smem = smem_words(g) * (long long)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        envdet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)C * ((nout + T - 1) / T);
  envdet_kernel<<<(unsigned)blocks, NT, (size_t)smem,
                  (cudaStream_t)stream>>>(x, x_i16, W, C, g, bp, lp, env);
  return (int)cudaGetLastError();
}

}  // extern "C"
