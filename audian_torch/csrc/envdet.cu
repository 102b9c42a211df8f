// Single-pass song-detection envelope on CUDA cores (sm_90a): int16 or
// float32 PCM -> zero-phase band-pass -> square -> decimating envelope
// low-pass -> 2 sqrt(max(e, 0)).
//
// Replaces audian_tpu/ops/pallas/envdet.py:_envdet_kernel (via
// _envdet_call).  With x the channels-first window dequantized (k / 2^15
// for int16) and zero outside [0, W), output j of channel c sits at window
// sample p_j = hb + j * step:
//
//   y[s]      = sum_{m<lb} g_bp[m] x[c, s + d_bp - m]
//   env[c, j] = 2 sqrt(max(0, sum_{m<ll} g_lp[m] y[p_j + d_lp - m]^2))
//
// What bounds it on the H100: arithmetic.  Each decimated output needs
// step * lb multiply-adds for its share of the band-passed stream plus ll
// for the envelope (565 a sample at the song detector's default design,
// lb 511, ll 1023, step 19) against 2 bytes read a sample, so the design
// reads x once, keeps the filtered stream out of device memory and writes
// only the decimated envelope.  One block handles T consecutive outputs of
// one channel:
//
//   1. it stages the x span those outputs need, (T-1) step + ll + lb - 1
//      samples, dequantized, and both tap vectors (reversed, so the sums
//      run forward) in shared memory;
//   2. stage 1 writes y^2 over the (T-1) step + ll samples stage 2 reads.
//      Each thread computes R1 = 9 consecutive samples and slides a window
//      of R1 inputs through registers, so every tap costs one tap load and
//      one input load for R1 multiply-adds.  Threads of a warp start R1
//      samples apart; R1 is odd, so their loads hit 32 distinct banks;
//   3. stage 2 computes each output over the ll envelope taps, R2 outputs
//      a thread sharing each tap load.  Outputs are step samples apart in
//      shared memory, conflict-free for an odd step (19 at the default).
//
// T is chosen by the host (ops/cuda/envdet.py): 512 where it fits, which
// recomputes (ll - step) / (T step) = 10 % of the stream as halo at the
// default design in 94 KB of shared memory (two blocks an SM); halved until
// the block fits for long kernels or large steps.  Sums run in blocks of
// about 128 taps whose partials are added to the total: the fp32 rounding
// error then grows with the number of blocks, not of taps.  Plain fp32 FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int R1 = 9;          // stage-1 samples per thread (odd)
constexpr int KB1 = 14 * R1;   // stage-1 taps per partial sum (126)
constexpr int R2 = 2;          // stage-2 outputs per thread sharing a tap
constexpr int KB2 = 128;       // stage-2 taps per partial sum
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

struct Geometry {
  int lb, lb_pad, d_bp, ll, d_lp, step, nout, hb, T;
  int ny;   // band-passed samples of one tile
  int nx;   // staged input samples of one tile
};

Geometry geometry(int lb, int d_bp, int ll, int d_lp, int step, int nout,
                  int hb, int T) {
  Geometry g;
  g.lb = lb;
  g.lb_pad = (lb + R1 - 1) / R1 * R1;
  g.d_bp = d_bp;
  g.ll = ll;
  g.d_lp = d_lp;
  g.step = step;
  g.nout = nout;
  g.hb = hb;
  g.T = T;
  g.ny = (T - 1) * step + ll;
  // the sliding window of the last thread reads R1 - 1 past its taps
  g.nx = g.ny + g.lb_pad + R1 - 1;
  return g;
}

long long smem_bytes(const Geometry& g) {
  return ((long long)g.nx + g.ny + g.lb_pad + g.ll) * (long long)sizeof(float);
}

// ys[u] = (sum_{k<lb_pad} gr[k] xs[u + k])^2 for u < ny
__device__ void bandpass_squared(const float* xs, const float* gr, int lb_pad,
                                 int ny, float* ys) {
  for (int u0 = threadIdx.x * R1; u0 < ny; u0 += NT * R1) {
    float acc[R1], buf[R1];
#pragma unroll
    for (int r = 0; r < R1; ++r) {
      acc[r] = 0.0f;
      buf[r] = xs[u0 + r];
    }
    // invariant: at tap k, slot q % R1 of buf holds xs[u0 + q] for
    // q in [k, k + R1)
    for (int k0 = 0; k0 < lb_pad; k0 += KB1) {
      const int k1 = min(k0 + KB1, lb_pad);
      float part[R1];
#pragma unroll
      for (int r = 0; r < R1; ++r) part[r] = 0.0f;
      for (int k = k0; k < k1; k += R1) {
#pragma unroll
        for (int s = 0; s < R1; ++s) {
          const float t = gr[k + s];
#pragma unroll
          for (int r = 0; r < R1; ++r)
            part[r] = fmaf(t, buf[(r + s) % R1], part[r]);
          buf[s] = xs[u0 + k + s + R1];
        }
      }
#pragma unroll
      for (int r = 0; r < R1; ++r) acc[r] += part[r];
    }
#pragma unroll
    for (int r = 0; r < R1; ++r)
      if (u0 + r < ny) ys[u0 + r] = acc[r] * acc[r];
  }
}

__global__ void __launch_bounds__(NT)
envdet_kernel(const void* __restrict__ xv, int x_i16, long long W, Geometry g,
              const float* __restrict__ g_bp, const float* __restrict__ g_lp,
              float* __restrict__ env) {
  extern __shared__ float smem[];
  float* xs = smem;            // x over the tile's span
  float* ys = xs + g.nx;       // y^2 over [p_j0 + d_lp - (ll-1), ...)
  float* gr = ys + g.ny;       // g_bp reversed, zero-padded to lb_pad
  float* lr = gr + g.lb_pad;   // g_lp reversed

  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const int j0 = blockIdx.x * g.T;
  const int tcount = min(g.T, g.nout - j0);

  for (int k = tid; k < g.lb_pad; k += NT)
    gr[k] = k < g.lb ? g_bp[g.lb - 1 - k] : 0.0f;
  for (int k = tid; k < g.ll; k += NT) lr[k] = g_lp[g.ll - 1 - k];
  // window sample of xs[0]: the first output's sample, less the envelope's
  // and the band-pass's look-back
  const long long x0 = (long long)g.hb + (long long)j0 * g.step + g.d_lp -
                       (g.ll - 1) + g.d_bp - (g.lb - 1);
  const long long row = (long long)c * W;
  if (x_i16) {
    const int16_t* x = static_cast<const int16_t*>(xv) + row;
    for (int i = tid; i < g.nx; i += NT) {
      const long long col = x0 + i;
      xs[i] = (col >= 0 && col < W) ? (float)x[col] * RAW16_SCALE : 0.0f;
    }
  } else {
    const float* x = static_cast<const float*>(xv) + row;
    for (int i = tid; i < g.nx; i += NT) {
      const long long col = x0 + i;
      xs[i] = (col >= 0 && col < W) ? x[col] : 0.0f;
    }
  }
  __syncthreads();

  bandpass_squared(xs, gr, g.lb_pad, g.ny, ys);
  __syncthreads();

  // stage 2: e_jl = sum_{k<ll} lr[k] ys[jl * step + k]
  for (int i0 = tid; i0 < tcount; i0 += R2 * NT) {
    int base[R2];
    float acc[R2];
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      base[r] = min(i0 + r * NT, tcount - 1) * g.step;
      acc[r] = 0.0f;
    }
    for (int k0 = 0; k0 < g.ll; k0 += KB2) {
      const int k1 = min(k0 + KB2, g.ll);
      float part[R2];
#pragma unroll
      for (int r = 0; r < R2; ++r) part[r] = 0.0f;
      for (int k = k0; k < k1; ++k) {
        const float t = lr[k];
#pragma unroll
        for (int r = 0; r < R2; ++r) part[r] = fmaf(t, ys[base[r] + k], part[r]);
      }
#pragma unroll
      for (int r = 0; r < R2; ++r) acc[r] += part[r];
    }
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      const int jl = i0 + r * NT;
      if (jl < tcount)
        env[(long long)c * g.nout + j0 + jl] = 2.0f * sqrtf(fmaxf(acc[r], 0.0f));
    }
  }
}

}  // namespace

extern "C" {

long long envdet_smem_bytes(int lb, int ll, int step, int T) {
  return smem_bytes(geometry(lb, 0, ll, 0, step, 0, 0, T));
}

// env is (C, nout) float32; x is (C, W) channels-first, int16 or float32.
int envdet_launch(const void* x, int x_i16, long long W, int C,
                  const float* g_bp, int lb, int d_bp, const float* g_lp,
                  int ll, int d_lp, int step, int nout, int hb, int T,
                  float* env, void* stream) {
  const Geometry g = geometry(lb, d_bp, ll, d_lp, step, nout, hb, T);
  const long long smem = smem_bytes(g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        envdet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((nout + T - 1) / T), C);
  envdet_kernel<<<grid, NT, (size_t)smem, (cudaStream_t)stream>>>(
      x, x_i16, W, g, g_bp, g_lp, env);
  return (int)cudaGetLastError();
}

}  // extern "C"
