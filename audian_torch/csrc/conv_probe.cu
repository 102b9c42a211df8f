// The bare convolution core (wgmma_conv.cuh), for holding it against a
// plain convolution and for timing it on the card before the kernels built
// on it run: conv_probe computes a known convolution in one of the core's
// modes, with the host's light flags, on one warpgroup at N = 64 and at
// N = 8; conv_rate repeats one on every warpgroup of a grid, two a block,
// at a chosen N and mode, so that its time gives the core's rate there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma_conv.cuh"

namespace {

using wgconv::COL;

// src (zero past nsrc) split and written into the stream of a stage in
// `mode` (quad-major TF32 or octet-major bf16) at w, nu rows a plane, by
// `threads` threads
__device__ void fill_stream(uint32_t* w, const float* __restrict__ src,
                            int nsrc, int nu, int mode, int threads) {
  // quads (TF32) or octets (bf16): half a step's taps
  const int q = wgconv::kwidth(mode) / 2;
  for (int qd = threadIdx.x; qd < 64 / q * nu; qd += threads) {
    const int i = q * qd;
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      v[r] = r < q && i + r < nsrc ? src[i + r] : 0.0f;
    const float4 a = make_float4(v[0], v[1], v[2], v[3]);
    if (q == 8)
      wgconv::put_octet(w, nu, i, a, make_float4(v[4], v[5], v[6], v[7]));
    else
      wgconv::put_quad(w, nu, i, a, true);
  }
  hopper::fence_async();
  __syncthreads();
}

// out[i] = sum_{m<T} taps[m] src[i + D - m] for i < 64 ncols (ncols <= 64)
// through conv<64>, and out8 the same for the first 8 columns through
// conv<8>, in `mode` with units from phase and light flags (or none)
__global__ void __launch_bounds__(128, 1)
conv_probe_kernel(const float* __restrict__ src, int nsrc,
                  const void* __restrict__ tp, int T, int D, int ncols,
                  int mode, int phase, const int* __restrict__ light, int nu,
                  float* __restrict__ out, float* __restrict__ out8) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  fill_stream(w, src, nsrc, nu, mode, 128);
  const wgconv::Stream s =
      wgconv::stream_at(hopper::smem_u32(w), mode, nu);
  const wgconv::Stage sg{tp, T, D, mode,
                         wgconv::steps(T, D, wgconv::kwidth(mode), phase),
                         light};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  wgconv::conv<64, 1>(s, sg, 0, 0, sg.st.nvb, acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int U = wgconv::out_col(i);
    if (U < ncols) out[COL * U + wgconv::out_row(i)] = acc[i];
  }
  float acc8[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  wgconv::conv<8, 1>(s, sg, 0, 0, sg.st.nvb, acc8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int U = wgconv::out_col(i);
    if (U < ncols) out8[COL * U + wgconv::out_row(i)] = acc8[i];
  }
}

// reps convolutions of N columns on each of a block's two warpgroups, in
// `mode`; out keeps each thread's sum so that nothing is optimized away
template <int N>
__global__ void __launch_bounds__(256, 1)
conv_rate_kernel(const float* __restrict__ src, int nsrc,
                 const void* __restrict__ tp, int T, int D, int mode, int nu,
                 int reps, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  fill_stream(w, src, nsrc, nu, mode, 256);
  const wgconv::Stream s =
      wgconv::stream_at(hopper::smem_u32(w), mode, nu);
  const wgconv::Stage sg{tp, T, D, mode,
                         wgconv::steps(T, D, wgconv::kwidth(mode)), nullptr};
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int rep = 0; rep < reps; ++rep)
    wgconv::conv<N, 1>(s, sg, 0, 0, sg.st.nvb, acc);
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) v += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = v;
}

template <int N>
int rate_launch(const float* src, int nsrc, const void* tp, int T, int D,
                int mode, int blocks, int reps, int smem, int nu, float* out,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_rate_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_rate_kernel<N><<<blocks, 256, smem, stream>>>(src, nsrc, tp, T, D,
                                                     mode, nu, reps, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src holds nsrc samples; tp the stage's tap vector in `mode` (TF32
// [hi | lo] floats, or bf16 [hi | lo] pair words; each T + 2 TPAD long,
// TPAD zeros in front); light the units' flags from `phase` (or null); out
// 64 ncols floats, out8 64 min(ncols, 8)
int conv_probe_launch(const float* src, int nsrc, const void* tp, int T,
                      int D, int ncols, int mode, int phase,
                      const int* light, float* out, float* out8,
                      void* stream) {
  if (ncols < 1 || ncols > COL || mode < wgconv::TF32X3 ||
      mode > wgconv::BF16X4)
    return (int)cudaErrorInvalidValue;
  const int nu = wgconv::stream_rows(COL, D, wgconv::kwidth(mode));
  const int smem = 2 * wgconv::part_bytes(mode, nu);
  cudaError_t err = cudaFuncSetAttribute(
      conv_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      src, nsrc, tp, T, D, ncols, mode, phase, light, nu, out, out8);
  return (int)cudaGetLastError();
}

// blocks x 2 warpgroups, each running reps convolutions of N (8, 64 or
// 128) columns in `mode` over src (at least 64 * 128 + D + 16 samples); a
// block takes at least smem_min bytes of shared memory, which sets how
// many share an SM; out holds 256 floats a block
int conv_rate_launch(const float* src, int nsrc, const void* tp, int T,
                     int D, int mode, int blocks, int N, int reps,
                     int smem_min, float* out, void* stream) {
  if (mode < wgconv::TF32X3 || mode > wgconv::BF16X4)
    return (int)cudaErrorInvalidValue;
  const int nu = wgconv::stream_rows(128, D, wgconv::kwidth(mode));
  const int bytes = 2 * wgconv::part_bytes(mode, nu);
  const int smem = bytes > smem_min ? bytes : smem_min;
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 8:
      return rate_launch<8>(src, nsrc, tp, T, D, mode, blocks, reps, smem,
                            nu, out, st);
    case 64:
      return rate_launch<64>(src, nsrc, tp, T, D, mode, blocks, reps, smem,
                             nu, out, st);
    case 128:
      return rate_launch<128>(src, nsrc, tp, T, D, mode, blocks, reps, smem,
                              nu, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
