// The bare convolution core (wgmma_conv.cuh), for holding it against a
// plain convolution and for timing it on the card before the kernels built
// on it run: conv_probe computes a known convolution on one warpgroup at
// m64n64k8 and at m64n8k8; conv_rate repeats one on every warpgroup of a
// grid, two a block, at a chosen N, so that its time gives the core's
// rate at that width.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_conv.cuh"

namespace {

using wgconv::COL;

// src (zero past nsrc) split and written quad-major into w, nu rows a
// plane, by `threads` threads
__device__ void fill_stream(uint32_t* w, const float* __restrict__ src,
                            int nsrc, int nu, int threads) {
  for (int qd = threadIdx.x; qd < 16 * nu; qd += threads) {
    uint4 hi, lo;
    const int i = 4 * qd;
    hopper::split_tf32(i < nsrc ? src[i] : 0.0f, hi.x, lo.x);
    hopper::split_tf32(i + 1 < nsrc ? src[i + 1] : 0.0f, hi.y, lo.y);
    hopper::split_tf32(i + 2 < nsrc ? src[i + 2] : 0.0f, hi.z, lo.z);
    hopper::split_tf32(i + 3 < nsrc ? src[i + 3] : 0.0f, hi.w, lo.w);
    const int wd = wgconv::qm_word(i, nu);
    *reinterpret_cast<uint4*>(w + wd) = hi;
    *reinterpret_cast<uint4*>(w + 64 * nu + wd) = lo;
  }
  hopper::fence_async();
  __syncthreads();
}

// out[i] = sum_{m<T} taps[m] src[i + D - m] for i < 64 ncols (ncols <= 64)
// through conv<64>, and out8 the same for the first 8 columns through
// conv<8>
__global__ void __launch_bounds__(128, 1)
conv_probe_kernel(const float* __restrict__ src, int nsrc,
                  const float* __restrict__ tp, int T, int D, int ncols,
                  int nu, float* __restrict__ out,
                  float* __restrict__ out8) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  fill_stream(w, src, nsrc, nu, 128);
  const uint32_t at = hopper::smem_u32(w);
  const wgconv::Stream s{at, at + 256u * nu, nu};
  const wgconv::Steps st = wgconv::steps(T, D);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  wgconv::conv<64, 1>(s, tp, T, D, st, 0, 0, st.nvb, acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int U = wgconv::out_col(i);
    if (U < ncols) out[COL * U + wgconv::out_row(i)] = acc[i];
  }
  float acc8[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  wgconv::conv<8, 1>(s, tp, T, D, st, 0, 0, st.nvb, acc8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int U = wgconv::out_col(i);
    if (U < ncols) out8[COL * U + wgconv::out_row(i)] = acc8[i];
  }
}

// reps convolutions of N columns on each of a block's two warpgroups;
// out keeps each thread's sum so that nothing is optimized away
template <int N>
__global__ void __launch_bounds__(256, 1)
conv_rate_kernel(const float* __restrict__ src, int nsrc,
                 const float* __restrict__ tp, int T, int D, int nu,
                 int reps, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  fill_stream(w, src, nsrc, nu, 256);
  const uint32_t at = hopper::smem_u32(w);
  const wgconv::Stream s{at, at + 256u * nu, nu};
  const wgconv::Steps st = wgconv::steps(T, D);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int rep = 0; rep < reps; ++rep)
    wgconv::conv<N, 1>(s, tp, T, D, st, 0, 0, st.nvb, acc);
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) v += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = v;
}

template <int N>
int rate_launch(const float* src, int nsrc, const float* tp, int T, int D,
                int blocks, int reps, int smem, int nu, float* out,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_rate_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_rate_kernel<N><<<blocks, 256, smem, stream>>>(src, nsrc, tp, T, D, nu,
                                                     reps, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src holds nsrc samples, tp the split taps [hi | lo] (each T + 2 TPAD
// long, TPAD zeros in front); out 64 ncols floats, out8 64 min(ncols, 8)
int conv_probe_launch(const float* src, int nsrc, const float* tp, int T,
                      int D, int ncols, float* out, float* out8,
                      void* stream) {
  if (ncols < 1 || ncols > COL) return (int)cudaErrorInvalidValue;
  const int nu = wgconv::stream_rows(COL, D);
  const int smem = 512 * nu;
  cudaError_t err = cudaFuncSetAttribute(
      conv_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      src, nsrc, tp, T, D, ncols, nu, out, out8);
  return (int)cudaGetLastError();
}

// blocks x 2 warpgroups, each running reps convolutions of N (8, 64 or
// 128) columns over src (at least 64 * 128 + D + 8 samples); a block takes
// at least smem_min bytes of shared memory, which sets how many share an
// SM; out holds 256 floats a block
int conv_rate_launch(const float* src, int nsrc, const float* tp, int T,
                     int D, int blocks, int N, int reps, int smem_min,
                     float* out, void* stream) {
  const int nu = wgconv::stream_rows(128, D);
  const int smem = 512 * nu > smem_min ? 512 * nu : smem_min;
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 8:
      return rate_launch<8>(src, nsrc, tp, T, D, blocks, reps, smem, nu, out,
                            st);
    case 64:
      return rate_launch<64>(src, nsrc, tp, T, D, blocks, reps, smem, nu,
                             out, st);
    case 128:
      return rate_launch<128>(src, nsrc, tp, T, D, blocks, reps, smem, nu,
                              out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
