// Strided-window matrix product on CUDA cores (sm_90a).
//
//   y[f, c, o] = sum_{k<K} p(x[c, f*S + k]) * w[k, o]      f < nframes
//
// x is (C, n) float32, channels-first, zero-extended past n; p is the
// identity or the rectifier (pi/2)|v|.  Output layout 0 ("fco") writes
// (nframes, C, O), layout 1 ("cf") the channels-first stream
// (C, nframes*O).
//
// Replaces audian_tpu/ops/pallas/window_matmul.py:_kernel, the per-stage
// path of the fused chain (filter bank K=269, envelope bank K=1262 with
// the rectifier, Hann-DFT analysis K=nfft).  On the H100 it is bound by
// arithmetic: each output costs K multiply-adds against 4 bytes written,
// so the design keeps the input off device memory after one read.  A block
// stages the span that FT consecutive frames of one channel cover (the
// windows are built implicitly, never materialised) in shared memory,
// applying p once per sample.  Each thread owns one column o of w and
// accumulates all FT frames in registers: per k it reads one w[k, o]
// (coalesced across the block, served by L1/L2) and FT shared-memory
// values that every thread of the block reads at the same address
// (broadcast).  Plain fp32 FMA; no tensor cores yet.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;       // frames per block (register accumulators)
constexpr int OT = 64;       // output columns per block (threads)
constexpr float HALF_PI = 1.57079632679489661923f;

__global__ void __launch_bounds__(OT)
window_matmul_kernel(const float* __restrict__ x, long long n,
                     const float* __restrict__ w, int K, int O, int S,
                     int nframes, int C, int rectify, int layout,
                     float* __restrict__ y) {
  extern __shared__ float xs[];
  const int f0 = blockIdx.x * FT;
  const int o = blockIdx.y * OT + threadIdx.x;
  const int c = blockIdx.z;
  const long long start = (long long)f0 * S;
  const int span = (FT - 1) * S + K;
  const float* xc = x + (long long)c * n;
  for (int i = threadIdx.x; i < span; i += OT) {
    long long col = start + i;
    float v = col < n ? xc[col] : 0.0f;
    xs[i] = rectify ? HALF_PI * fabsf(v) : v;
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

}  // namespace

extern "C" {

// Shared memory one block needs for a window span: the wrapper checks it
// against the card's limit before launching.
long long window_matmul_smem_bytes(int K, int S) {
  return ((long long)(FT - 1) * S + K) * (long long)sizeof(float);
}

int window_matmul_launch(const float* x, long long n, int C, const float* w,
                         int K, int O, int S, int nframes, int rectify,
                         int layout, float* y, void* stream) {
  const long long smem = window_matmul_smem_bytes(K, S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((nframes + FT - 1) / FT, (O + OT - 1) / OT, C);
  window_matmul_kernel<<<grid, OT, (size_t)smem, (cudaStream_t)stream>>>(
      x, n, w, K, O, S, nframes, C, rectify, layout, y);
  return (int)cudaGetLastError();
}

}  // extern "C"
