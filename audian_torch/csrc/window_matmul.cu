// Strided-window matrix product on Hopper's tensor cores (sm_90a, 3xTF32).
//
//   y[f, c, o] = sum_{k<K} p(x[c, f*S + k]) * w[k, o]      f < nframes
//
// x is (C, n), channels-first, zero-extended past n: float32, or int16
// PCM-16 dequantized (k / 2^15) while the windows are staged.  p is the
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
// multiply-adds against 4 bytes written.
//
// Design: an implicit GEMM, one (nframes x K) . (K x O) product per
// channel whose A[f, k] = p(x[c, f*S + k]) is never materialised.  A block
// owns BM = 64 frames x BN columns of one channel (BN = 128 where O fills
// it, else 64), as 32 x 32 tiles of one warp each, and walks K in slices
// of BK = 32, double-buffered in shared memory.  What costs instructions
// is kept off the MMAs' way:
//   - w is split into TF32 hi and lo once per call by a small kernel
//     (split_w_kernel) into a zero-padded, column-major scratch, so its
//     slices reach shared memory by cp.async with no register or bounds
//     check;
//   - each element of A is loaded, premapped and split once per block
//     while the warps run the previous slice;
//   - the fragments come from shared memory by ldmatrix, one instruction
//     per 16 x 8 (A) or two 8 x 8 (B) words; the row stride of BK + 4
//     words keeps them free of bank conflicts.
// Each warp runs 2 x 4 m16n8k8 fragments in three TF32 passes
// (tf32x3.cuh), pass by pass over the eight, so that consecutive MMAs do
// not wait on each other.  Sums run in blocks of 128 taps, each block's
// partial added to the total in fp32.  Staging per slice bounds the
// shared memory at 108 KB whatever K and S are.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::FragB;

constexpr int BM = 64;       // frames per block
constexpr int BK = 32;       // taps per slice
constexpr int RS = BK + 4;   // row stride of a staged slice (words)
constexpr int SLICES_PER_SUM = 128 / BK;
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float RAW16_SCALE = 1.0f / 32768.0f;

// premap codes (PREMAPS in ops/cuda/window_matmul.py); the dequantizer is
// the int16 load itself, so on float32 input it is the identity
enum Premap { IDENTITY = 0, RECTIFY = 1, DEQUANT = 2, SQUARE = 3 };

// the columns a block owns: 128 where that pads O no further than 64 do
int block_cols(int O) {
  return (O + 127) / 128 * 128 == (O + 63) / 64 * 64 ? 128 : 64;
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Args {
  const void* x;
  int x_i16, n;
  const uint32_t* wt;   // [hi | lo], each (Op, Kp), zero-padded
  int K, Kp, Op, S, nframes, C, O, premap, layout;
  float* y;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// wt[part][o][k] = (hi, lo)[part] of w[k][o], zero past K and O
__global__ void split_w_kernel(const float* __restrict__ w, int K, int O,
                               int Kp, int Op, uint32_t* __restrict__ wt) {
  const long long size = (long long)Op * Kp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < size; i += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(i / Kp), k = (int)(i % Kp);
    uint32_t hi = 0, lo = 0;
    if (k < K && o < O) tf32x3::split_tf32(w[(long long)k * O + o], hi, lo);
    wt[i] = hi;
    wt[size + i] = lo;
  }
}

template <int BN>
struct Tile {
  static constexpr int NT = 2 * BN;              // 2 x BN/32 warps
  static constexpr int A_PER_THREAD = BM * BK / NT;
  static constexpr int ROW_STEP = NT / 32;       // A rows between a
                                                 // thread's elements
  static constexpr int B_CHUNKS = 2 * BN * BK / 4 / NT;   // 16-byte copies
  static constexpr int STAGE = 2 * (BM + BN) * RS;        // words a buffer
  // blocks an SM holds: by shared memory (2 stages of 108 or 72 KB), and
  // so the registers a thread may take (128 or 170)
  static constexpr int MIN_BLOCKS = BN == 128 ? 2 : 3;
};

// slice k0 of w's hi and lo parts into a buffer, by cp.async
template <int BN>
__device__ __forceinline__ void copy_w(const Args& a, int n0, int k0,
                                       uint32_t* buf) {
  using T = Tile<BN>;
  uint32_t* bs = buf + 2 * BM * RS;
#pragma unroll
  for (int i = 0; i < T::B_CHUNKS; ++i) {
    const int q = threadIdx.x + T::NT * i;
    const int part = q / (BN * BK / 4);
    const int row = (q / (BK / 4)) % BN;
    const int c4 = 4 * (q % (BK / 4));
    cp_async16(bs + (part * BN + row) * RS + c4,
               a.wt + ((long long)part * a.Op + n0 + row) * a.Kp + k0 + c4);
  }
}

// slice k0 of this block's A into registers, premapped: thread tid holds
// A[tid / 32 + ROW_STEP i][tid % 32]
template <int BN>
__device__ __forceinline__ void load_a(const Args& a, int c, int f0, int k0,
                                       float (&ra)[Tile<BN>::A_PER_THREAD]) {
  using T = Tile<BN>;
  const int k = k0 + (threadIdx.x & 31);
  const long long row = (long long)c * a.n;
  const int16_t* xi = static_cast<const int16_t*>(a.x) + row;
  const float* xf = static_cast<const float*>(a.x) + row;
#pragma unroll
  for (int i = 0; i < T::A_PER_THREAD; ++i) {
    const int f = f0 + (threadIdx.x >> 5) + T::ROW_STEP * i;
    const int col = f * a.S + k;
    float v = 0.0f;
    if (f < a.nframes && k < a.K && col < a.n)
      v = a.x_i16 ? (float)xi[col] * RAW16_SCALE : xf[col];
    if (a.premap == RECTIFY) v = HALF_PI * fabsf(v);
    else if (a.premap == SQUARE) v = v * v;
    ra[i] = v;
  }
}

// the registers of load_a, split into TF32 hi and lo, into a buffer
template <int BN>
__device__ __forceinline__ void store_a(
    uint32_t* buf, const float (&ra)[Tile<BN>::A_PER_THREAD]) {
  using T = Tile<BN>;
#pragma unroll
  for (int i = 0; i < T::A_PER_THREAD; ++i) {
    const int idx = ((threadIdx.x >> 5) + T::ROW_STEP * i) * RS +
                    (threadIdx.x & 31);
    tf32x3::split_tf32(ra[i], buf[idx], buf[BM * RS + idx]);
  }
}

template <int BN>
__global__ void __launch_bounds__(Tile<BN>::NT, Tile<BN>::MIN_BLOCKS)
window_matmul_kernel(Args a) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int f0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int c = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  // this lane's ldmatrix rows: A rows along M, B rows along N
  const int a_off = (wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS +
                    4 * (lane >> 4);
  const int b_off = 2 * BM * RS + (wn + (lane & 7) + 8 * (lane >> 4)) * RS +
                    4 * ((lane >> 3) & 1);

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = part[mi][ni][r] = 0.0f;

  float ra[T::A_PER_THREAD];
  const int nslices = a.Kp / BK;
  copy_w<BN>(a, n0, 0, smem);
  load_a<BN>(a, c, f0, 0, ra);
  store_a<BN>(smem, ra);
  cp_async_wait_all();
  __syncthreads();
  for (int sl = 0; sl < nslices; ++sl) {
    const bool more = sl + 1 < nslices;
    uint32_t* next = smem + ((sl + 1) & 1) * T::STAGE;
    if (more) {
      copy_w<BN>(a, n0, (sl + 1) * BK, next);
      load_a<BN>(a, c, f0, (sl + 1) * BK, ra);
    }
    const uint32_t* cur = smem + (sl & 1) * T::STAGE;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      FragA fa[2];
      FragB fb[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t* p = cur + a_off + 16 * mi * RS + k8;
        tf32x3::ldsm_x4(fa[mi].hi, p);
        tf32x3::ldsm_x4(fa[mi].lo, p + BM * RS);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const uint32_t* p = cur + b_off + 16 * np * RS + k8;
        uint32_t h[4], l[4];
        tf32x3::ldsm_x4(h, p);
        tf32x3::ldsm_x4(l, p + BN * RS);
        fb[2 * np] = FragB{{h[0], h[1]}, {l[0], l[1]}};
        fb[2 * np + 1] = FragB{{h[2], h[3]}, {l[2], l[3]}};
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            tf32x3::mma3_pass(p, part[mi][ni], fa[mi], fb[ni]);
    }
    if (more) store_a<BN>(next, ra);
    if (sl % SLICES_PER_SUM == SLICES_PER_SUM - 1 || !more) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[mi][ni][r] += part[mi][ni][r];
            part[mi][ni][r] = 0.0f;
          }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int fr = f0 + wm + 16 * mi + g + 8 * hf;
      if (fr >= a.nframes) continue;
      float* row = a.layout == 0
          ? a.y + ((long long)fr * a.C + c) * a.O
          : a.y + ((long long)c * a.nframes + fr) * a.O;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = n0 + wn + 8 * ni + 2 * t;
        if (o < a.O) row[o] = acc[mi][ni][2 * hf];
        if (o + 1 < a.O) row[o + 1] = acc[mi][ni][2 * hf + 1];
      }
    }
}

template <int BN>
int launch(const Args& a, const float* w, cudaStream_t stream) {
  using T = Tile<BN>;
  const int smem = 2 * T::STAGE * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      window_matmul_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long words = (long long)a.Op * a.Kp;
  const int blocks = (int)((words + 255) / 256 < 4096 ? (words + 255) / 256
                                                       : 4096);
  split_w_kernel<<<blocks, 256, 0, stream>>>(w, a.K, a.O, a.Kp, a.Op,
                                             const_cast<uint32_t*>(a.wt));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.nframes + BM - 1) / BM, a.Op / BN, a.C);
  window_matmul_kernel<BN><<<grid, T::NT, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit words of the scratch a call needs: w's split parts, padded
long long window_matmul_scratch_words(int K, int O) {
  return 2LL * round_up(O, block_cols(O)) * round_up(K, BK);
}

// scratch: window_matmul_scratch_words(K, O) words of device memory
int window_matmul_launch(const void* x, int x_i16, int n, int C,
                         const float* w, int K, int O, int S, int nframes,
                         int premap, int layout, float* y, void* scratch,
                         void* stream) {
  const int bn = block_cols(O);
  Args a{x, x_i16, n, static_cast<const uint32_t*>(scratch), K,
         round_up(K, BK), round_up(O, bn), S, nframes, C, O, premap, layout,
         y};
  cudaStream_t s = (cudaStream_t)stream;
  return bn == 128 ? launch<128>(a, w, s) : launch<64>(a, w, s);
}

}  // extern "C"
