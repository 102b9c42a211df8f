// Single-pass fused chain on CUDA cores (sm_90a): int16 or float32 PCM ->
// causal FIR band-pass -> pi/2-rectified symmetric envelope -> Hann PSD
// at hop 128, with per-tile chunk statistics.
//
// Replaces audian_tpu/ops/pallas/chain.py:_chain_kernel (via _chain_call).
// In chunk coordinates, with x = x_ext dequantized (k / 2^15 for int16):
//
//   y[c, j] = sum_{m<Tf} h[m] x[c, hb + j - m]            j in [-lead, n + tail)
//   e[c, j] = max(0, sum_{k<L} g[k] (pi/2)|y[c, j + delay - k]|)   j in [0, n)
//   psd[f, c, b] = |sum_{k<nfft} y[c, 128 f + k] ws[k, .]|^2        f < n / 128
//
// ws is the lane-packed analysis matrix of the host setup (window, density
// scale and one-sided doubling folded in): columns [0, half] hold the real
// parts of bins 0..half, columns (half, nfft) the imaginary parts of bins
// 1..half-1.
//
// What bounds it on the H100: arithmetic.  A sample of one channel costs
// Tf + L + 2 nfft multiply-adds (about 1.8 k at the headline design)
// against about 14 bytes of device-memory traffic, some 255 FLOP per byte.
// So the design reads x once (plus its halo), keeps the filtered stream of
// a tile in shared memory for the envelope and the PSD, convolves with the
// true taps (not the TPU kernel's zero-padded 128-row banks), and writes
// only the requested outputs and one stat partial per tile.  Tile sums are
// reduced in a fixed order in shared memory (no atomics: the results are
// deterministic), and the partials are summed by the caller.  Plain fp32
// FMA on CUDA cores; the products run from shared memory with 8 outputs
// per thread sharing each tap load, summed in blocks of 128 taps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TJ = 2048;     // output samples per tile (16 PSD frames)
constexpr int HOP = 128;     // PSD hop the chain is built for
constexpr int FTILE = TJ / HOP;
constexpr int NT = 256;      // threads per block
constexpr int R = 8;         // outputs per thread sharing one tap load
constexpr int KB = 128;      // taps per partial sum (see dot_taps)
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

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

// acc[r] = sum_{m<T} taps[m] src[base[r] - m] for R outputs that share
// each tap load.  The sum runs in blocks of KB taps, each block's partial
// added to the total: the fp32 rounding error then grows with T/KB terms
// instead of T, which keeps long envelope kernels (thousands of taps)
// inside the 1e-5 contract.
__device__ __forceinline__ void dot_taps(const float* src, const float* taps,
                                         int T, const int (&base)[R],
                                         float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int m0 = 0; m0 < T; m0 += KB) {
    const int m1 = min(m0 + KB, T);
    float part[R];
#pragma unroll
    for (int r = 0; r < R; ++r) part[r] = 0.0f;
    for (int m = m0; m < m1; ++m) {
      const float t = taps[m];
#pragma unroll
      for (int r = 0; r < R; ++r)
        part[r] = fmaf(t, src[base[r] - m], part[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += part[r];
  }
}

// dst[i] = sum_{m<T} taps[m] src[i + off - m] for i < count; each thread
// owns the outputs i0 + r*NT, r < R.  Reads past count are clamped to a
// valid slot and never stored.
__device__ void conv_rows(const float* src, const float* taps, int T,
                          int off, int count, float* dst) {
  for (int i0 = threadIdx.x; i0 < count; i0 += R * NT) {
    float acc[R];
    int base[R];
#pragma unroll
    for (int r = 0; r < R; ++r) base[r] = min(i0 + r * NT, count - 1) + off;
    dot_taps(src, taps, T, base, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (i0 + r * NT < count) dst[i0 + r * NT] = acc[r];
  }
}

__global__ void __launch_bounds__(NT)
chain_kernel(const void* __restrict__ xv, int x_i16, long long xlen,
             long long n, int C, Geometry geo,
             const float* __restrict__ h, const float* __restrict__ g,
             const float* __restrict__ ws, int env_clamp, int want_f,
             int want_e, int want_s, float* __restrict__ y,
             float* __restrict__ e, float* __restrict__ s,
             float* __restrict__ pp, float* __restrict__ gp,
             float* __restrict__ qp) {
  const int ylen = TJ + geo.lead + geo.tail;
  const int xlen_tile = ylen + geo.Tf - 1;
  extern __shared__ float smem[];
  float* xs = smem;                 // x, then (pi/2)|y| for the envelope
  float* ys = xs + xlen_tile;       // y over [j0 - lead, j0 + TJ + tail)
  float* hs = ys + ylen;
  float* gs = hs + geo.Tf;
  float* red = gs + geo.L;

  const int tile = blockIdx.x;
  const int ntiles = gridDim.x;
  const int c = blockIdx.y;
  const long long j0 = (long long)tile * TJ;
  const int tid = threadIdx.x;
  const int nbins = geo.nfft / 2 + 1;
  const int half = nbins - 1;
  const long long nf = n / HOP;

  // stage the taps and the input span (dequantized) in shared memory;
  // base >= 0 because hb >= lead + Tf - 1 (host geometry)
  for (int m = tid; m < geo.Tf; m += NT) hs[m] = h[m];
  if (want_e)
    for (int k = tid; k < geo.L; k += NT) gs[k] = g[k];
  const long long base = geo.hb + j0 - geo.lead - (geo.Tf - 1);
  const long long row = (long long)c * xlen;
  if (x_i16) {
    const int16_t* x = static_cast<const int16_t*>(xv) + row;
    for (int i = tid; i < xlen_tile; i += NT) {
      const long long col = base + i;
      xs[i] = col < xlen ? (float)x[col] * RAW16_SCALE : 0.0f;
    }
  } else {
    const float* x = static_cast<const float*>(xv) + row;
    for (int i = tid; i < xlen_tile; i += NT) {
      const long long col = base + i;
      xs[i] = col < xlen ? x[col] : 0.0f;
    }
  }
  __syncthreads();

  // stage 1: filtered stream with the envelope's look-back and the
  // consumers' look-ahead
  conv_rows(xs, hs, geo.Tf, geo.Tf - 1, ylen, ys);
  __syncthreads();

  float psum = 0.0f;
  if (want_f) {
    for (int jl = tid; jl < TJ; jl += NT) {
      const long long j = j0 + jl;
      if (j < n) {
        const float v = ys[geo.lead + jl];
        y[(long long)c * n + j] = v;
        psum = fmaf(v, v, psum);
      }
    }
  }
  psum = block_sum(psum, red);

  // stage 2: rectified zero-phase envelope from the tile's y
  float esum = 0.0f;
  if (want_e) {
    for (int i = tid; i < ylen; i += NT) xs[i] = HALF_PI * fabsf(ys[i]);
    __syncthreads();
    for (int i0 = tid; i0 < TJ; i0 += R * NT) {
      float acc[R];
      int base[R];
#pragma unroll
      for (int r = 0; r < R; ++r) base[r] = i0 + r * NT + geo.lead + geo.delay;
      dot_taps(xs, gs, geo.L, base, acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long j = j0 + i0 + r * NT;
        if (j < n) {
          const float v = env_clamp ? fmaxf(acc[r], 0.0f) : acc[r];
          e[(long long)c * n + j] = v;
          esum += v;
        }
      }
    }
  }
  esum = block_sum(esum, red);

  // stage 3: Hann-DFT PSD frames of this tile; one thread per bin
  for (int b = tid; b < nbins; b += NT) {
    float qsum = 0.0f;
    if (want_s) {
      float re[FTILE], im[FTILE];
#pragma unroll
      for (int f = 0; f < FTILE; ++f) re[f] = im[f] = 0.0f;
      const bool has_im = b >= 1 && b < half;
      const int ci = has_im ? half + b : b;
      for (int k = 0; k < geo.nfft; ++k) {
        const float wr = __ldg(ws + (long long)k * geo.nfft + b);
        const float wi = has_im ? __ldg(ws + (long long)k * geo.nfft + ci)
                                : 0.0f;
        const float* yk = ys + geo.lead + k;
#pragma unroll
        for (int f = 0; f < FTILE; ++f) {
          const float v = yk[f * HOP];
          re[f] = fmaf(v, wr, re[f]);
          im[f] = fmaf(v, wi, im[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < FTILE; ++f) {
        const long long fr = j0 / HOP + f;
        if (fr < nf) {
          const float p = re[f] * re[f] + im[f] * im[f];
          s[(fr * C + c) * nbins + b] = p;
          qsum += p;
        }
      }
    }
    qp[((long long)c * ntiles + tile) * nbins + b] = qsum;
  }
  if (tid == 0) {
    pp[(long long)c * ntiles + tile] = psum;
    gp[(long long)c * ntiles + tile] = esum;
  }
}

long long smem_bytes(int Tf, int L, int lead, int tail) {
  const long long ylen = TJ + lead + tail;
  return (2 * ylen + Tf - 1 + Tf + L + NT) * (long long)sizeof(float);
}

}  // namespace

extern "C" {

const char* audian_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int chain_tile() { return TJ; }

long long chain_smem_bytes(int Tf, int L, int lead, int tail) {
  return smem_bytes(Tf, L, lead, tail);
}

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
