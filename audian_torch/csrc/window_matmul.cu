// Strided-window matrix product on CUDA cores (sm_90a).
//
//   y[f, c, o] = sum_{k<K} p(x[c, f*S + k]) * w[k, o]      f < nframes
//
// x is (C, n), channels-first, zero-extended past n: float32, or int16
// PCM-16 dequantized (k / 2^15) while the window is staged.  p is the
// identity, the rectifier (pi/2)|v|, or the square v*v.  Output layout 0
// ("fco") writes (nframes, C, O), layout 1 ("cf") the channels-first
// stream (C, nframes*O).
//
// Replaces audian_tpu/ops/pallas/window_matmul.py:_kernel: the per-stage
// path of the fused chain (filter bank K=269, envelope bank K=1262 with
// the rectifier, Hann-DFT analysis K=nfft) and the two stages of the
// song-detection EnvDet (band-pass bank K=638 on int16 with the
// dequantizer; the decimating envelope bank K=3436 at stride 2432 with the
// square).  On the H100 it is bound by arithmetic: each output costs K
// multiply-adds against 4 bytes written, so the design keeps the input off
// device memory after one read.  A block stages the span that FT
// consecutive frames of one channel cover (the windows are built
// implicitly, never materialised) in shared memory, applying p once per
// sample.  FT is the largest of 32, 16, ..., 1 whose span fits one block's
// shared memory, chosen at launch from S and K (the decimating stage's
// span at FT = 32 would need 315 KB).  Each thread owns one column o of w
// and accumulates all FT frames in registers: per k it reads one w[k, o]
// (coalesced across the block, served by L1/L2) and FT shared-memory
// values that every thread of the block reads at the same address
// (broadcast).  Plain fp32 FMA; no tensor cores yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT_MAX = 32;   // frames per block at most (register accumulators)
constexpr int OT = 64;       // output columns per block (threads)
constexpr long long SMEM_LIMIT = 232448;   // one block's shared memory
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

// premap codes (PREMAPS in ops/cuda/window_matmul.py); the dequantizer is
// the int16 load itself, so on float32 input it is the identity
enum Premap { IDENTITY = 0, RECTIFY = 1, DEQUANT = 2, SQUARE = 3 };

long long span_bytes(int ft, int K, int S) {
  return ((long long)(ft - 1) * S + K) * (long long)sizeof(float);
}

template <int FT>
__global__ void __launch_bounds__(OT)
window_matmul_kernel(const void* __restrict__ xv, int x_i16, long long n,
                     const float* __restrict__ w, int K, int O, int S,
                     int nframes, int C, int premap, int layout,
                     float* __restrict__ y) {
  extern __shared__ float xs[];
  const int f0 = blockIdx.x * FT;
  const int o = blockIdx.y * OT + threadIdx.x;
  const int c = blockIdx.z;
  const long long start = (long long)f0 * S;
  const int span = (FT - 1) * S + K;
  const int16_t* xi = static_cast<const int16_t*>(xv) + (long long)c * n;
  const float* xf = static_cast<const float*>(xv) + (long long)c * n;
  for (int i = threadIdx.x; i < span; i += OT) {
    const long long col = start + i;
    float v = 0.0f;
    if (col < n) v = x_i16 ? (float)xi[col] * RAW16_SCALE : xf[col];
    if (premap == RECTIFY) v = HALF_PI * fabsf(v);
    else if (premap == SQUARE) v = v * v;
    xs[i] = v;
  }
  __syncthreads();
  if (o >= O) return;
  float acc[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) acc[f] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float wk = __ldg(w + (long long)k * O + o);
#pragma unroll
    for (int f = 0; f < FT; ++f) acc[f] = fmaf(xs[f * S + k], wk, acc[f]);
  }
#pragma unroll
  for (int f = 0; f < FT; ++f) {
    const int fr = f0 + f;
    if (fr >= nframes) break;
    long long idx = layout == 0
        ? ((long long)fr * C + c) * O + o
        : (long long)c * nframes * O + (long long)fr * O + o;
    y[idx] = acc[f];
  }
}

template <int FT>
int launch(const void* x, int x_i16, long long n, int C, const float* w,
           int K, int O, int S, int nframes, int premap, int layout,
           float* y, cudaStream_t stream) {
  const long long smem = span_bytes(FT, K, S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_matmul_kernel<FT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((nframes + FT - 1) / FT, (O + OT - 1) / OT, C);
  window_matmul_kernel<FT><<<grid, OT, (size_t)smem, stream>>>(
      x, x_i16, n, w, K, O, S, nframes, C, premap, layout, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Frames per block for a window of K taps at stride S: the largest power
// of two up to 32 whose span fits one block's shared memory (1 if none
// does; the wrapper then refuses the shape).
int window_matmul_frames_per_block(int K, int S) {
  int ft = FT_MAX;
  while (ft > 1 && span_bytes(ft, K, S) > SMEM_LIMIT) ft /= 2;
  return ft;
}

// Shared memory one block needs at that choice: the wrapper checks it
// against the card's limit before launching.
long long window_matmul_smem_bytes(int K, int S) {
  return span_bytes(window_matmul_frames_per_block(K, S), K, S);
}

int window_matmul_launch(const void* x, int x_i16, long long n, int C,
                         const float* w, int K, int O, int S, int nframes,
                         int premap, int layout, float* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (window_matmul_frames_per_block(K, S)) {
    case 32: return launch<32>(x, x_i16, n, C, w, K, O, S, nframes, premap, layout, y, st);
    case 16: return launch<16>(x, x_i16, n, C, w, K, O, S, nframes, premap, layout, y, st);
    case 8: return launch<8>(x, x_i16, n, C, w, K, O, S, nframes, premap, layout, y, st);
    case 4: return launch<4>(x, x_i16, n, C, w, K, O, S, nframes, premap, layout, y, st);
    case 2: return launch<2>(x, x_i16, n, C, w, K, O, S, nframes, premap, layout, y, st);
    default: return launch<1>(x, x_i16, n, C, w, K, O, S, nframes, premap, layout, y, st);
  }
}

}  // extern "C"
