// Reference copies y = x + 1 for tools/probe_ring_trials.py: the same
// 16-byte loads and stores under three launch shapes, to tell what a
// persistent grid costs a kernel bound by device memory on the card.
//
//   kind 0  one-shot: a thread a 16-byte word, 128 threads a block, as
//           many blocks as words / 128 (the shape of torch's elementwise
//           kernels)
//   kind 1  persistent, static: 16 blocks of 128 threads an SM, each
//           thread four words in flight, the grid striding over x
//   kind 2  persistent, claimed: the same blocks claiming tiles of 512
//           words from a counter (*next, zeroed here before the kernel)

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float4 add1(float4 v) {
  return make_float4(v.x + 1.f, v.y + 1.f, v.z + 1.f, v.w + 1.f);
}

constexpr int NT = 128;
constexpr int U = 4;

__global__ void one_shot(const float4* __restrict__ x, float4* __restrict__ y,
                         long long n4) {
  const long long i = blockIdx.x * (long long)NT + threadIdx.x;
  if (i < n4) y[i] = add1(x[i]);
}

__device__ __forceinline__ void tile4(const float4* __restrict__ x,
                                      float4* __restrict__ y, long long n4,
                                      long long i0) {
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i0 + u * NT < n4) v[u] = x[i0 + u * NT];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (i0 + u * NT < n4) y[i0 + u * NT] = add1(v[u]);
}

__global__ void persistent_static(const float4* __restrict__ x,
                                  float4* __restrict__ y, long long n4) {
  const long long stride = (long long)gridDim.x * NT * U;
  for (long long i0 = blockIdx.x * (long long)NT * U + threadIdx.x; i0 < n4;
       i0 += stride)
    tile4(x, y, n4, i0);
}

__global__ void persistent_claimed(const float4* __restrict__ x,
                                   float4* __restrict__ y, long long n4,
                                   unsigned long long* next) {
  __shared__ long long tile;
  for (;;) {
    if (threadIdx.x == 0) tile = (long long)atomicAdd(next, 1ULL);
    __syncthreads();
    const long long i0 = tile * NT * U;
    __syncthreads();
    if (i0 >= n4) return;
    tile4(x, y, n4, i0 + threadIdx.x);
  }
}

}  // namespace

extern "C" int ring_copy_launch(int kind, const void* x, void* y,
                                long long n4, int sms, void* next,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* a = static_cast<const float4*>(x);
  float4* b = static_cast<float4*>(y);
  if (kind == 0) {
    one_shot<<<(unsigned)((n4 + NT - 1) / NT), NT, 0, s>>>(a, b, n4);
  } else if (kind == 1) {
    persistent_static<<<16 * sms, NT, 0, s>>>(a, b, n4);
  } else {
    cudaError_t err = cudaMemsetAsync(next, 0, 8, s);
    if (err != cudaSuccess) return (int)err;
    persistent_claimed<<<16 * sms, NT, 0, s>>>(
        a, b, n4, static_cast<unsigned long long*>(next));
  }
  return (int)cudaGetLastError();
}
