// Single-pass fused chain on Hopper's tensor cores (sm_90a, 3xTF32):
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
// ws here is the host's pair-interleaved analysis matrix (ChainKernel
// .ws_pairs): column 2b holds the real part of bin b and column 2b+1 its
// imaginary part for 0 < b < nfft/2; columns 0 and 1 hold the real parts of
// bin 0 and of the Nyquist bin (whose imaginary parts are zero).
//
// What bounds it on the H100: arithmetic.  A sample of one channel costs
// Tf + L + 2 nfft true multiply-adds (about 1.8 k at the headline design)
// against about 14 bytes of device-memory traffic.  The fp32 FMA form of
// this kernel needed one shared-memory load per multiply-add, and an SM
// loads a quarter as fast as it multiplies: it stopped near a quarter of
// the fp32 peak.  Here every product runs on the tensor cores as three
// TF32 passes (tf32x3.cuh), which keeps the fp32 precision of the sums,
// and the design keeps the instructions around each MMA few.
//
// Design.  A block owns TJ = 2048 output samples of one channel.  It
// stages its input span in shared memory, runs the filter over the span
// plus the envelope's look-back and the consumers' look-ahead, keeps the
// filtered span in shared memory, and runs the envelope and the PSD from
// it; only the requested outputs and one stat partial per tile leave the
// block.  Each convolution runs as Toeplitz-block MMAs, the TPU's _conv
// at the MMA's own tile size (toeplitz_mma.cuh: conv_mma), over a stream
// split into TF32 hi and lo once, as it is written to shared memory (the
// input span, then the rectified filtered span).  The steps cover the
// true taps, so the all-zero sub-blocks of the TPU's 128-row banks
// (ChainKernel.act_f / act_e) never run, and the zero corners of the
// slices cost 22/T of the work.  Sums run in blocks of 16 steps (128
// taps), which keeps a 14511-tap envelope inside 1e-5.  The envelope's
// steps are shared by two halves of the block, each warp taking four
// 128-sample tiles, so one tap fragment serves four MMAs; the halves'
// sums meet in shared memory.  The PSD is a plain 3xTF32 product of the
// tile's 16 frames (split once into the input's buffer, free by then)
// with ws_pairs, read from L2; each lane then holds the real and
// imaginary parts of a bin side by side, so |.|^2 and the per-bin sums
// finish in registers.  Every warp runs the three passes of its tiles'
// MMAs pass by pass (tf32x3::mma3_pass), so that consecutive MMAs do not
// wait on each other.
//
// The streams are swizzled in shared memory (XOR of word bits 2-4, within
// each 32-word line) so that the fragment loads meet no bank conflict: the
// convolution reads 8 rows 16 words apart (toeplitz::sw_conv), the PSD 8
// frames 128 apart (sw_psd).
// Tile sums are reduced in a fixed order (no atomics: deterministic
// results, whatever stages are masked), and the partials are summed by
// the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "toeplitz_mma.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;
using toeplitz::conv_mma;
using toeplitz::put_split;
using toeplitz::round32;
using toeplitz::SLACK;
using toeplitz::TPAD;
using toeplitz::VB;

constexpr int TJ = 2048;     // output samples per tile
constexpr int HOP = 128;     // PSD hop the chain is built for
constexpr int NT = 256;      // threads per block
constexpr int NWARP = NT / 32;
constexpr int J_ENV = 4;     // envelope tiles a warp (TJ / 128 over half
                             // the warps)
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;
static_assert(TJ / 128 == J_ENV * NWARP / 2, "envelope tiles a warp");
static_assert(TJ / HOP == 16, "a tile's PSD frames fill the MMA's 16 rows");

// word of logical index i of the filtered stream read by the PSD (rows
// 128 apart; the convolution streams use toeplitz::sw_conv)
__device__ __forceinline__ int sw_psd(int i) {
  return i ^ (((i >> 7) & 7) << 2);
}

struct Geometry {
  int Tf, L, delay, lead, tail, hb, nfft;
};

__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  float out = red[0];
  __syncthreads();
  return out;
}

// three blocks an SM (the headline tile takes 50 KB of shared memory):
// at most 85 registers a thread, which cost a few spilled bytes but
// measured faster than two blocks of 128
__global__ void __launch_bounds__(NT, 3)
chain_kernel(const void* __restrict__ xv, int x_i16, long long xlen,
             long long n, int C, Geometry geo,
             const float* __restrict__ h, const float* __restrict__ g,
             const float* __restrict__ ws, int env_clamp, int want_f,
             int want_e, int want_s, float* __restrict__ y,
             float* __restrict__ e, float* __restrict__ s,
             float* __restrict__ pp, float* __restrict__ gp,
             float* __restrict__ qp) {
  const int ylen = TJ + geo.lead + geo.tail;
  const int xspan = ylen + geo.Tf - 1;
  const int xwords = round32(xspan + SLACK);
  const int rwords = round32(ylen + SLACK);
  extern __shared__ __align__(16) float smem[];
  // x, then (pi/2)|y|, each split [hi | lo] (sw_conv layout)
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);
  float* ys = smem + 2 * xwords;    // y over [j0 - lead, j0 + TJ + tail)
                                    // (sw_psd layout)
  float* es = ys + ylen;            // the envelope halves' meeting point
  float* red = es + TJ;

  const int tile = blockIdx.x;
  const int ntiles = gridDim.x;
  const int c = blockIdx.y;
  const long long j0 = (long long)tile * TJ;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nbins = geo.nfft / 2 + 1;
  const int half = nbins - 1;
  const long long nf = n / HOP;

  // stage the input span (dequantized) and its zero slack; base >= 0
  // because hb >= lead + Tf - 1 (host geometry)
  const long long base = geo.hb + j0 - geo.lead - (geo.Tf - 1);
  const long long row = (long long)c * xlen;
  if (x_i16) {
    const int16_t* x = static_cast<const int16_t*>(xv) + row;
    for (int i = tid; i < xwords; i += NT) {
      const long long col = base + i;
      put_split(xs, xwords, i, i < xspan && col < xlen
                ? (float)x[col] * RAW16_SCALE : 0.0f);
    }
  } else {
    const float* x = static_cast<const float*>(xv) + row;
    for (int i = tid; i < xwords; i += NT) {
      const long long col = base + i;
      put_split(xs, xwords, i, i < xspan && col < xlen ? x[col] : 0.0f);
    }
  }
  __syncthreads();

  // stage 1: the filtered span, y[j0 - lead + i] = ys[i]
  float psum = 0.0f;
  const long long yrow = (long long)c * n;
  conv_mma<NWARP, 4, 1>(xs, xwords, h, geo.Tf, geo.Tf - 1, ylen / 128,
                        nullptr, [&](int i, float v) {
                          ys[sw_psd(i)] = v;
                          const int jl = i - geo.lead;
                          if (want_f && jl >= 0 && jl < TJ && j0 + jl < n) {
                            y[yrow + j0 + jl] = v;
                            psum = fmaf(v, v, psum);
                          }
                        });
  __syncthreads();

  // stage 2: rectified zero-phase envelope from the tile's y
  float esum = 0.0f;
  if (want_e) {
    for (int i = tid; i < rwords; i += NT)
      put_split(xs, rwords, i,
                i < ylen ? HALF_PI * fabsf(ys[sw_psd(i)]) : 0.0f);
    __syncthreads();
    conv_mma<NWARP, J_ENV, 2>(xs, rwords, g, geo.L, geo.lead + geo.delay,
                              TJ / 128, es, [&](int i, float v) {
                                if (j0 + i < n) {
                                  v = env_clamp ? fmaxf(v, 0.0f) : v;
                                  e[yrow + j0 + i] = v;
                                  esum += v;
                                }
                              });
  }

  // stage 3: the tile's 16 PSD frames times ws_pairs; warp w takes column
  // tiles 4w .. 4w+3 (bins 16w .. 16w+15) at a time
  const long long qrow = ((long long)c * ntiles + tile) * nbins;
  if (want_s) {
    // the frames' samples split into TF32 parts once, as words of ys from
    // lead: [hi | lo], each nwords long, in xs (free after stage 2)
    const int nwords = TJ + geo.nfft - HOP;
    __syncthreads();
    for (int i = tid; i < nwords; i += NT)
      tf32x3::split_tf32(ys[geo.lead + i], xs[i], xs[nwords + i]);
    __syncthreads();
    const int gq = lane >> 2, t = lane & 3;
    const int nct = geo.nfft / 8;
    // frames gq and gq + 8, taps 8 ks + t (+ 4), as words from lead:
    // sw_psd keeps the +1024 and, as the tap index has bit 2 clear, turns
    // + 4 into ^ 4 (lead, a multiple of 128, moves no bit it swizzles)
    const int yi = geo.lead + 128 * gq + t;
    for (int nt0 = warp * 4; nt0 < nct; nt0 += NWARP * 4) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
      for (int kb = 0; kb < nct; kb += VB) {
        float part[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[j][r] = 0.0f;
        for (int ks = kb; ks < kb + VB; ++ks) {
          const float* wk = ws + (long long)(8 * ks + t) * geo.nfft + gq;
          FragB fb[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = min(nt0 + j, nct - 1);
            fb[j] = tf32x3::split_b(__ldg(wk + 8 * nt),
                                    __ldg(wk + 4 * geo.nfft + 8 * nt));
          }
          const int p = sw_psd(yi + 8 * ks) - geo.lead;
          FragA fa;
          fa.hi[0] = xs[p];
          fa.hi[1] = xs[p + 1024];
          fa.hi[2] = xs[p ^ 4];
          fa.hi[3] = xs[(p ^ 4) + 1024];
          fa.lo[0] = xs[nwords + p];
          fa.lo[1] = xs[nwords + p + 1024];
          fa.lo[2] = xs[nwords + (p ^ 4)];
          fa.lo[3] = xs[nwords + (p ^ 4) + 1024];
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (nt0 + j < nct) tf32x3::mma3_pass(pass, part[j], fa, fb[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] += part[j][r];
      }
      // lane (g, t) holds frames g and g+8 of the pair 4 nt + t: real part
      // in d0/d2, imaginary part in d1/d3 (pair 0: bin 0 and Nyquist)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slot = 4 * (nt0 + j) + t;
        if (nt0 + j >= nct) continue;
        float qa = 0.0f, qb = 0.0f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float re = acc[j][2 * hf], im = acc[j][2 * hf + 1];
          const long long fr = j0 / HOP + gq + 8 * hf;
          if (fr >= nf) continue;
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
        // sum over the eight lanes of this pair (g = 0..7), fixed order
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          qa += __shfl_xor_sync(0xffffffffu, qa, m);
          qb += __shfl_xor_sync(0xffffffffu, qb, m);
        }
        if (gq == 0) {
          qp[qrow + slot] = qa;
          if (slot == 0) qp[qrow + half] = qb;
        }
      }
    }
  } else {
    for (int b = tid; b < nbins; b += NT) qp[qrow + b] = 0.0f;
  }

  psum = block_sum(psum, red);
  esum = block_sum(esum, red);
  if (tid == 0) {
    pp[(long long)c * ntiles + tile] = psum;
    gp[(long long)c * ntiles + tile] = esum;
  }
}

// the split input span (which the split rectified span, never longer,
// reuses), the filtered span, the envelope halves' meeting point and the
// reduction buffer
long long smem_bytes(int Tf, int L, int lead, int tail) {
  (void)L;
  const int ylen = TJ + lead + tail;
  return (long long)(2 * round32(ylen + Tf - 1 + SLACK) + ylen + TJ + NT) *
         (long long)sizeof(float);
}

}  // namespace

extern "C" {

const char* audian_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int chain_tile() { return TJ; }

int chain_tap_pad() { return TPAD; }

long long chain_smem_bytes(int Tf, int L, int lead, int tail) {
  return smem_bytes(Tf, L, lead, tail);
}

// h and g point at the host's split tap vectors [hi | lo], each half
// T + 2 TPAD long with TPAD zeros in front (ChainKernel.h_split / g_split);
// ws at the pair-interleaved analysis matrix (ChainKernel.ws_pairs)
int chain_launch(const void* x, int x_i16, long long xlen, int C,
                 long long n, const float* h, int Tf, const float* g, int L,
                 int delay, int lead, int tail, int hb, const float* ws,
                 int nfft, int env_clamp, int want_f, int want_e, int want_s,
                 float* y, float* e, float* s, float* pp, float* gp,
                 float* qp, void* stream) {
  const long long smem = smem_bytes(Tf, L, lead, tail);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Geometry geo{Tf, L, delay, lead, tail, hb, nfft};
  dim3 grid((unsigned)((n + TJ - 1) / TJ), C);
  chain_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      x, x_i16, xlen, n, C, geo, h, g, ws, env_clamp, want_f, want_e,
      want_s, y, e, s, pp, gp, qp);
  return (int)cudaGetLastError();
}

}  // extern "C"
