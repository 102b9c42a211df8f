// The causal FIR of the interactive graph on Hopper's tensor cores
// (sm_90a wgmma, wgmma_conv.cuh): y[i, c] = sum_{m<T} h[m] x[i - m, c],
// x zero before sample 0, over every channel of a time-first float32
// stream.  This is sosfilt_fir's convolution (ops/sos.py
// _conv1d_same_causal, whose plain twin _fir_valid_cf runs cuDNN).
//
// Replaces no TPU kernel: the JAX package runs this product as a banded
// Toeplitz matmul under XLA (audian_tpu/ops/sos.py), and the port ran it
// as cuDNN's fp32 direct convolution, which never reaches the tensor
// cores.  It was added because the graph's filter (1024 taps) and the
// envelope's two passes (4096 taps each) take nearly all of a scrub
// step's device time.
//
// What bounds it on the H100: arithmetic.  An output costs T
// multiply-adds (three TF32 passes each at HIGHEST and HIGH, one at
// DEFAULT) against 8 bytes of device-memory traffic, so at T = 1024 a
// sample is 6 kFLOP of tensor work for 8 bytes.  The design keeps the
// tensor cores fed and everything else off the critical path:
//
//   - a block owns TILE = 8192 consecutive outputs of one channel (grid: the C
//     blocks of a tile side by side, channel fastest, so that the
//     strided reads of one tile's rows meet in L2); it reads its span,
//     TILE + T - 1 samples, straight from the (n, C) stream (no transposing
//     copy, no zero-history pad: samples before 0 or past n are zero),
//     every load of a batch issued before any is used, and splits it into
//     TF32 hi and lo once, as a quad-major stream in shared memory;
//   - its two warpgroups each run one chunk of N = 64 output columns of
//     64 (wgconv::conv) over every step of the taps, the host-split
//     [hi | lo] tap vector gathered through L1 into A fragments, one
//     register set (each step waits for the last);
//   - two blocks share an SM (at most 128 registers a thread, and up to
//     6202 taps a stream small enough for two), so that one block's span
//     loads while the other's products run, and the four warpgroups'
//     products interleave on the tensor cores.  On the card this beat
//     one block an SM with chunks of 128 columns (with one or two
//     register sets; two spilled) and two blocks with two register sets;
//   - the sums run in units of 128 taps added in fp32 (the core's), every
//     unit at the rung's passes (no light units: the graph's FIR keeps
//     full fp32 precision);
//   - the outputs go channels-first, (C, n): a warp's stores cover whole
//     32-byte sectors of one channel's row, and the caller takes the
//     transposed view, as it took cuDNN's.
//
// The stream of a block, 512 bytes a row of 64 samples (both parts), sets
// the longest filter one launch takes (20,794 taps; the launch is refused
// beyond it).  The host runs a longer design as slices of its taps, one
// launch a slice: a slice that starts at tap `delay` reads its span that
// many samples earlier and adds its sums into y (`accumulate`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_conv.cuh"

namespace {

using wgconv::COL;
using wgconv::qm_word;

constexpr int NT = 256;        // threads a block: two warpgroups
constexpr int N = 64;          // output columns of a warpgroup's chunk
constexpr int R = 1;           // A-fragment register sets of the core
constexpr int MINB = 2;        // blocks an SM
constexpr int TILE = 2 * N * COL;   // outputs a block: one chunk a warpgroup
constexpr int BATCH = 16;      // samples a thread loads before it uses one

// rows a plane of a block's split stream for a T-tap filter
__host__ __device__ inline int fir_rows(int T) {
  return wgconv::stream_rows(TILE / COL, T - 1);
}

// shared memory of a block: both parts of the stream
__host__ __device__ inline long long fir_smem(int T) {
  return 2LL * wgconv::part_bytes(wgconv::TF32X3, fir_rows(T));
}

__global__ void __launch_bounds__(NT, MINB)
fir_kernel(const float* __restrict__ x, long long ldx, long long n, int C,
           const float* __restrict__ taps, int T, long long delay,
           int accumulate, int mode, int nu, float* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem);
  const int tid = threadIdx.x;
  const int c = blockIdx.x % C;
  const long long j0 = (long long)(blockIdx.x / C) * TILE;
  // stream sample s is x[j0 - delay - (T - 1) + s, c]
  const long long base = j0 - delay - (T - 1);
  const int ns = COL * nu;   // samples of a part
  const bool lo = mode != wgconv::TF32X1;
  for (int i0 = 0; i0 < ns; i0 += BATCH * NT) {
    float v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const long long s = base + i0 + b * NT + tid;
      const long long sc = s < 0 ? 0 : (s < n ? s : n - 1);
      v[b] = __ldcg(x + sc * ldx + c);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * NT + tid;
      if (i >= ns) continue;
      const long long s = base + i;
      const float val = s >= 0 && s < n ? v[b] : 0.0f;
      const int wd = qm_word(i, nu);
      uint32_t h, l;
      hopper::split_tf32(val, h, l);
      xw[wd] = h;
      if (lo) xw[ns + wd] = l;
    }
  }
  hopper::fence_async();
  __syncthreads();

  const wgconv::Stream xs =
      wgconv::stream_at(hopper::smem_u32(xw), wgconv::TF32X3, nu);
  const wgconv::Stage sg{taps, T, T - 1, mode, wgconv::steps(T, T - 1),
                         nullptr};
  const int wg = tid >> 7;
  const int col0 = wg * N;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  wgconv::conv<N, R>(xs, sg, col0, 0, sg.st.nvb, acc);
  float* row = y + (long long)c * n + j0;
  const long long cnt = n - j0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int si = COL * (col0 + wgconv::out_col(i)) + wgconv::out_row(i);
    if (si < cnt) row[si] = accumulate ? row[si] + acc[i] : acc[i];
  }
}

}  // namespace

extern "C" {

// y (C, n) float32, channels-first: the taps' sums over the (n, C) stream
// x, float32, row i at x + i ldx with its channels adjacent, delayed by
// `delay` samples (y[i, c] = sum_{m<T} h[m] x[i - delay - m, c]), written
// or, with `accumulate`, added to y; taps the host's split tap vector (TF32
// [hi | lo] floats, each T + 2 TPAD long with TPAD zeros on either side),
// run in `mode` (TF32X3 or TF32X1).  Refused (cudaErrorInvalidValue): a
// mode of another kind, T < 1, delay < 0, a stream that overflows a block's
// shared memory, or a grid of 2^31 blocks or more.
int fir_launch(const float* x, long long ldx, long long n, int C,
               const float* taps, int T, long long delay, int accumulate,
               int mode, float* y, void* stream) {
  if ((mode != wgconv::TF32X3 && mode != wgconv::TF32X1) || T < 1 || n < 1 ||
      C < 1 || delay < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = fir_smem(T);
  const long long blocks = (long long)C * ((n + TILE - 1) / TILE);
  if (smem >= (1LL << 31) || blocks >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fir_kernel<<<(unsigned)blocks, NT, (size_t)smem, (cudaStream_t)stream>>>(
      x, ldx, n, C, taps, T, delay, accumulate, mode, fir_rows(T), y);
  return (int)cudaGetLastError();
}

}  // extern "C"
