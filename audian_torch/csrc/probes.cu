// The benchmark probes' kernels on Hopper (sm_90a): the device-copy and
// output floors of the chain and the phase-major relayout of the IFIR
// envelope, each a hand-written counterpart of a Pallas probe.
//
//   copy_add1       y = x + 1 over (C, T), the reference's (C, N) column
//                   blocks (benchmarks/call_scaling_bench.py:copy_kernel,
//                   benchmarks/dma_floor_bench.py:copy_kernel,
//                   benchmarks/phase_restructure_bench.py:k_base)
//   copy_pm_add1    the same over program-major (nprog, C, N) blocks
//                   (benchmarks/dma_floor_bench.py:copy_pm_kernel); both
//                   run copy_flat_kernel over the tensor's words
//   outputs_floor   the chain's six output blocks with no compute
//                   (benchmarks/dma_floor_bench.py:outputs_kernel)
//   pm_forward      u (C, M Q) -> u_pm (C M, Q), u_pm[c M + m, q] =
//                   u[c, m + M q]: the IFIR envelope's relayout
//                   (audian_tpu/ops/fused.py:192; the probe's subject)
//   pm_inverse      its inverse, e_pm (C M, Q) -> e (C, M Q)
//                   (audian_tpu/ops/fused.py:197)
//   pm_roundtrip    both relayouts within each (C, N) block with + 1
//                   between, y = x + 1 by way of the relayout
//                   (benchmarks/phase_restructure_bench.py:k_reshape)
//   select_pm       the group-local phase-major relayout as 0/1 selection
//                   products on the tensor cores, + 1: within each group of
//                   1024 samples y[c, 1024 g + 128 m + k] =
//                   x[c, 1024 g + m + 8 k] + 1 (what
//                   benchmarks/phase_restructure_bench.py:k_matmul means;
//                   as written it builds one non-zero selection matrix of
//                   eight and fails to trace, so its body is not carried)
//
// What bounds them on the H100: device memory.  Every kernel but select_pm
// moves each byte once and computes nothing worth counting, so its least
// time is its bytes over 3.35 TB/s; select_pm adds 128 multiply-adds an
// output a TF32 pass (2^26 outputs at the reference's size: 1.7e10 FLOP a
// pass, 0.035 ms at 495 TFLOP/s against 0.16 ms of bytes).
//
// Design.  Both copies compute y = x + 1 over a contiguous tensor: their
// (C, N) and program-major blocks only choose the addresses the TPU's DMA
// walks, and a BlockSpec has no counterpart on this card.  So one kernel
// runs both over the tensor's words as one flat range, on a one-shot grid
// of tiles, as torch launches x + 1 (on the H100 a one-shot 16-byte copy
// ran 2-8 % faster than a persistent grid walking the same tiles,
// tools/probe_ring_trials.py): a thread issues all its COPY_U 16-byte loads
// before its stores, neighbouring threads on neighbouring addresses, with
// 64-bit indices.  The last n % 4 words take scalar loads and stores, and
// a tensor not 16-byte aligned (a view at an odd offset) the same tiles
// word by word.  The output floor keeps the reference's grid, one block a
// (C, N) block, each cut into `shares` blocks interleaved along its rows
// where the reference's grid has fewer blocks than eight an SM (the host
// picks it: 512 blocks of 256 threads at N = 8192 would keep half the
// threads an SM can hold, 64 at N = 65536 would leave half the SMs idle);
// a thread takes one column of a block's rows, two rows' vectors at a time.
// The relayouts pm_forward and pm_inverse go through shared memory, where
// a word is padded in after every 32 (the natural order) or 32 / M after
// every phase row (the phase-major order), so that both the stride-M reads
// and the contiguous writes of a warp fall in 32 distinct banks (M a power
// of two up to 32: the IFIR strides 4 and 8 among them); reads and writes
// of device memory run along the sample axis, 16 bytes a thread where the
// strides allow, and a row stride lets them read u[:, :n_u] and
// e_pm[:, :q_out] where they lie.
//
// pm_roundtrip.  A persistent grid, two blocks an SM, whose blocks claim
// the (row, block) items one at a time from a counter, so that the grid
// sweeps device memory together (a grid that walks fixed items drifts
// apart and loses a few per cent to one that claims them: the reference
// copies of tools/probe_ring_trials.py).  In each block one producer
// thread keeps bulk copies (cp.async.bulk) of the claimed items' row
// pieces in flight, in stages of up to 2048 samples, into a ring of two
// stages under mbarriers, while eight consumer warps relay the stage that
// has arrived into the item's phase-major rows pm[m][q] = x[q M + m] + 1
// and hand the stage back.  Once the item's rows are whole they read them
// back in natural order and store y with 16-byte stores; the next item's
// stages are arriving meanwhile.  (Deeper rings of larger stages keep more
// bytes in flight and run no faster on the card.)  A bulk copy lands
// unpadded, so the banks are kept apart by the phase rows alone: a thread
// reads a 16-byte word of the stage (four consecutive samples: phases
// 4 f mod M .. + 3 of one column, the whole phase group at M = 4, half of
// it at M = 8) and writes its four words to four phase rows, one column;
// the phase rows are padded to a length of 4 mod 8 words, so that at
// M = 8 the two halves of a warp (rows m and m + 4, sixteen consecutive
// columns each) fall 16 banks apart, and at M = 4 a warp writes 32
// consecutive columns of one row.  The reads back mirror the writes.  M
// is a power of two: shifts, no division.
//
// select_pm.  The selection matrices S_{b,m}[i, k] = 1 iff 128 b + i =
// m + 8 k (b the source block of 128 samples, m the phase) each hold their
// 16 ones in the columns k = 16 b + j, j < 16, and these columns are the
// same for every b: S_{b,m}[i, 16 b + j] = U[i, 16 m + j] with U[i, 16 m +
// j] = 1 iff i = m + 8 j, a 128 x 128 permutation.  So the sum over b of
// X_b S_{b,m} is a concatenation: Z_b = X_b U (64 rows of one source block
// each, m64n128k8 wgmmas over 16 steps), and Z_b[:, 16 m + j] lands at
// y[128 m + 16 b + j].  The zero blocks are skipped, 128 multiply-adds an
// output instead of 1024.  A persistent block an SM: one producer warp
// claims items (64 rows x one source block) from a counter, as the round
// trip does, and bulk-copies each (a 512-byte copy a row) into a ring of
// four stages, rows 144 words apart so that the two rows of a
// quarter-warp's 16-byte fragment loads fall 16 banks apart; two consumer
// warpgroups (registers moved to them by setmaxnreg) take alternate
// stages, each against the one U in shared memory (64 KB,
// K-major core matrices, built once a block), with its rows permuted so
// that a thread's A fragments of two steps are one 16-byte load (4 t ..
// 4 t + 3 of each 16 samples) and its columns so that a thread's
// accumulators of one phase are one 16-byte store.  The copies of the
// next items are in flight while a warpgroup multiplies and stores.  The
// 0/1 operand is exact in TF32, so HIGHEST runs two passes (x_lo U, x_hi
// U: the products with U's zero low part are left out) and DEFAULT one (x
// rounded by cvt.rna).  A NaN or an infinity in a source block makes the
// 128 outputs of its row in that block NaN (0 x inf and 0 x NaN are NaN;
// at DEFAULT, where x has no lo part, an infinity's own output, inf x 1,
// stays infinite): a product spreads what a copy would not.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;        // threads of an output-floor or relayout block
// the copies: threads of a block, 16-byte vectors a thread, words a block
constexpr int COPY_NT = 256;
constexpr int COPY_U = 4;
constexpr long long COPY_TILE = 4LL * COPY_NT * COPY_U;
constexpr int TS = 4096;       // samples of a relayout tile
constexpr long long SMEM_LIMIT = 232448;   // shared memory of a block
constexpr long long SM_SMEM = 233472;      // of an SM, 1 KB a block of it
                                           // reserved
// the round trip: consumer threads, and the producer warp beside them;
// samples of a ring stage; stages; blocks an SM (its shared memory would
// allow four)
constexpr int RT_CONS = 256;
constexpr int RT_NT = RT_CONS + 32;
constexpr int RT_CHUNK = 2048;
constexpr int RT_RING = 2;
constexpr int RT_PER_SM = 2;
// the selection products: samples of a group and of a source block; two
// consumer warpgroups and the producer's; ring stages of 64 rows at a
// pitch of 144 words (16 banks apart from one row to the next)
constexpr int GROUP = 1024;
constexpr int SBLK = 128;
constexpr int SEL_CONS = 256;
constexpr int SEL_NT = SEL_CONS + 128;
constexpr int SEL_RING = 4;
constexpr int SEL_PITCH = SBLK + 16;
constexpr int SEL_STAGE = 64 * SEL_PITCH;
constexpr int U_WORDS = 16 * 8 * SBLK;   // 16 steps of 8 x 128 TF32 words

__device__ __forceinline__ int pad32(int s) { return s + (s >> 5); }

__device__ __forceinline__ float4 add4(float4 v, float a) {
  return make_float4(v.x + a, v.y + a, v.z + a, v.w + a);
}

// n words at p (16-byte aligned where vec) set to v, this block's share
__device__ __forceinline__ void fill(float* __restrict__ p, long long n,
                                     float v, int share, int shares,
                                     bool vec) {
  const long long step = (long long)shares * NT;
  long long f = (long long)share * NT + threadIdx.x;
  if (vec) {
    const float4 v4 = make_float4(v, v, v, v);
    for (; f < n / 4; f += step) reinterpret_cast<float4*>(p)[f] = v4;
    return;
  }
  for (; f < n; f += step) p[f] = v;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// -- the copies ---------------------------------------------------------------

// y = x + 1 over n contiguous words, one-shot: block b takes tile b of
// COPY_TILE words.  vec (x and y 16-byte aligned): the tile is COPY_U x
// COPY_NT 16-byte vectors, thread t's vectors t, t + COPY_NT, ..., all its
// loads issued before any store; the last n % 4 words (in the last block's
// tile) one a thread.  Else the same tile as single words, 4 COPY_U a
// thread, loads first again.  Every word is read and written once, so the
// vectors go with the streaming hints (evict first; 1 % faster than plain
// loads and stores on the H100, tools/probe_copy_trials.py)
__device__ __forceinline__ float4 copy_load(const float4* p) {
  return __ldcs(p);
}

__device__ __forceinline__ void copy_store(float4* p, float4 v) {
  __stcs(p, v);
}

__global__ void __launch_bounds__(COPY_NT) copy_flat_kernel(
    const float* __restrict__ x, float* __restrict__ y, long long n,
    bool vec) {
  const long long w0 = (long long)blockIdx.x * COPY_TILE;
  const int t = threadIdx.x;
  if (!vec) {
    float v[4 * COPY_U];
#pragma unroll
    for (int u = 0; u < 4 * COPY_U; ++u) {
      const long long w = w0 + u * COPY_NT + t;
      if (w < n) v[u] = x[w];
    }
#pragma unroll
    for (int u = 0; u < 4 * COPY_U; ++u) {
      const long long w = w0 + u * COPY_NT + t;
      if (w < n) y[w] = v[u] + 1.0f;
    }
    return;
  }
  const long long n4 = n >> 2, i0 = w0 / 4 + t;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  float4 v[COPY_U];
#pragma unroll
  for (int u = 0; u < COPY_U; ++u)
    if (i0 + u * COPY_NT < n4) v[u] = copy_load(x4 + i0 + u * COPY_NT);
#pragma unroll
  for (int u = 0; u < COPY_U; ++u)
    if (i0 + u * COPY_NT < n4)
      copy_store(y4 + i0 + u * COPY_NT, add4(v[u], 1.0f));
  if (blockIdx.x == gridDim.x - 1 && t < (int)(n & 3))
    y[4 * n4 + t] = x[4 * n4 + t] + 1.0f;
}

// the chain's output set of program i with no compute: y = x + 1 and
// e = x + 2 over its (C, N) block (x read once), its PSD block (F, C,
// nbins) and qo block (C, nbins) filled with 0 + x[0, 0] and 0 + x[0, 2]
// (the reference adds the value to zeros), po and go its columns 0 and 1.
// vec: x, y and e in 16-byte words; vso, vqo: so and qo filled in them
struct Outputs {
  float *y, *e, *so, *po, *go, *qo;
};

__global__ void __launch_bounds__(NT) outputs_floor_kernel(
    const float* __restrict__ x, int C, long long T, int N, int nbins,
    Outputs o, bool vec, bool vso, bool vqo) {
  const int i = blockIdx.x, share = blockIdx.y, shares = gridDim.y;
  const float* xb = x + (long long)i * N;
  const int per = shares * NT, first = share * NT + threadIdx.x;
  if (vec) {
    // a thread's column of the block, two rows at a time
    const long long T4 = T / 4;
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    float4* y4 = reinterpret_cast<float4*>(o.y + (long long)i * N);
    float4* e4 = reinterpret_cast<float4*>(o.e + (long long)i * N);
    for (int k = first; k < N / 4; k += per) {
      int r = 0;
      for (; r + 2 <= C; r += 2) {
        const float4 v0 = x4[r * T4 + k], v1 = x4[(r + 1) * T4 + k];
        y4[r * T4 + k] = add4(v0, 1.0f);
        y4[(r + 1) * T4 + k] = add4(v1, 1.0f);
        e4[r * T4 + k] = add4(v0, 2.0f);
        e4[(r + 1) * T4 + k] = add4(v1, 2.0f);
      }
      if (r < C) {
        const float4 v = x4[r * T4 + k];
        y4[r * T4 + k] = add4(v, 1.0f);
        e4[r * T4 + k] = add4(v, 2.0f);
      }
    }
  } else {
    for (int r = 0; r < C; ++r)
      for (int k = first; k < N; k += per) {
        const long long off = r * T + (long long)i * N + k;
        const float v = x[off];
        o.y[off] = v + 1.0f;
        o.e[off] = v + 2.0f;
      }
  }
  const long long psd = (long long)(N / 128) * C * nbins;
  fill(o.so + i * psd, psd, __fadd_rn(0.0f, xb[0]), share, shares, vso);
  const long long q = (long long)C * nbins;
  fill(o.qo + i * q, q, __fadd_rn(0.0f, xb[2]), share, shares, vqo);
  if (share == 0)
    for (int c = threadIdx.x; c < C; c += NT) {
      o.po[(long long)i * C + c] = xb[(long long)c * T];
      o.go[(long long)i * C + c] = xb[(long long)c * T + 1];
    }
}

// -- the phase-major relayouts ------------------------------------------------

// tile (j, c): phase columns q0 = tq j .. of channel c, tq = TS / M.  The
// natural samples go to shared memory at pad32(s); the phase rows leave
// from there, four columns a thread as one 16-byte store where vout (Q a
// multiple of 4: thread f's words 33 f + const apart at M = 8, in distinct
// banks)
__global__ void __launch_bounds__(NT) pm_forward_kernel(
    const float* __restrict__ u, long long ldu, int Q, int M, int tq,
    float* __restrict__ out, bool vin, bool vout) {
  __shared__ float tile[TS + TS / 32];
  const int c = blockIdx.y;
  const int q0 = blockIdx.x * tq, nq = min(tq, Q - q0);
  const float* src = u + (long long)c * ldu + (long long)q0 * M;
  const int ns = nq * M;
  int s0 = 0;
  if (vin) {
    for (int f = threadIdx.x; f < ns / 4; f += NT) {
      const float4 v = reinterpret_cast<const float4*>(src)[f];
      tile[pad32(4 * f)] = v.x;
      tile[pad32(4 * f + 1)] = v.y;
      tile[pad32(4 * f + 2)] = v.z;
      tile[pad32(4 * f + 3)] = v.w;
    }
    s0 = ns & ~3;
  }
  for (int s = s0 + threadIdx.x; s < ns; s += NT) tile[pad32(s)] = src[s];
  __syncthreads();
  float* dst = out + (long long)c * M * Q + q0;
  if (vout) {
    const int t4 = tq / 4;
    for (int f = threadIdx.x; f < M * t4; f += NT) {
      const int m = f / t4, ql = 4 * (f % t4);
      if (ql < nq)
        *reinterpret_cast<float4*>(dst + (long long)m * Q + ql) =
            make_float4(tile[pad32(ql * M + m)],
                        tile[pad32((ql + 1) * M + m)],
                        tile[pad32((ql + 2) * M + m)],
                        tile[pad32((ql + 3) * M + m)]);
    }
    return;
  }
  for (int f = threadIdx.x; f < M * tq; f += NT) {
    const int m = f / tq, ql = f % tq;
    if (ql < nq) dst[(long long)m * Q + ql] = tile[pad32(ql * M + m)];
  }
}

// tile (j, c): the M phase rows of channel c over q0 = tq j .. into shared
// memory in natural order (four columns a thread as one 16-byte load where
// vin), then out along the samples
__global__ void __launch_bounds__(NT) pm_inverse_kernel(
    const float* __restrict__ e, long long lde, int Q, int M, int tq,
    float* __restrict__ out, bool vin, bool vout) {
  __shared__ float tile[TS + TS / 32];
  const int c = blockIdx.y;
  const int q0 = blockIdx.x * tq, nq = min(tq, Q - q0);
  const float* src = e + (long long)c * M * lde + q0;
  if (vin) {
    const int t4 = tq / 4;
    for (int f = threadIdx.x; f < M * t4; f += NT) {
      const int m = f / t4, ql = 4 * (f % t4);
      if (ql < nq) {
        const float4 v =
            *reinterpret_cast<const float4*>(src + (long long)m * lde + ql);
        tile[pad32(ql * M + m)] = v.x;
        tile[pad32((ql + 1) * M + m)] = v.y;
        tile[pad32((ql + 2) * M + m)] = v.z;
        tile[pad32((ql + 3) * M + m)] = v.w;
      }
    }
  } else {
    for (int f = threadIdx.x; f < M * tq; f += NT) {
      const int m = f / tq, ql = f % tq;
      if (ql < nq) tile[pad32(ql * M + m)] = src[(long long)m * lde + ql];
    }
  }
  __syncthreads();
  float* dst = out + (long long)c * M * Q + (long long)q0 * M;
  const int ns = nq * M;
  int s0 = 0;
  if (vout) {
    for (int f = threadIdx.x; f < ns / 4; f += NT)
      reinterpret_cast<float4*>(dst)[f] =
          make_float4(tile[pad32(4 * f)], tile[pad32(4 * f + 1)],
                      tile[pad32(4 * f + 2)], tile[pad32(4 * f + 3)]);
    s0 = ns & ~3;
  }
  for (int s = s0 + threadIdx.x; s < ns; s += NT) dst[s] = tile[pad32(s)];
}

// -- the round trip on a bulk-copy ring ---------------------------------------

// samples of a ring stage: an item's row piece in pieces of RT_CHUNK
__host__ __device__ constexpr int rt_stage_words(int N) {
  return N < RT_CHUNK ? N : RT_CHUNK;
}

// words of a phase row: Q = N / M rounded up to 4 mod 8, so that rows four
// apart lie 16 banks apart
__host__ __device__ constexpr int rt_row(int N, int M) {
  return N / M + ((4 - N / M) & 7);
}

long long roundtrip_smem(int N, int M) {
  return 4LL * RT_RING * rt_stage_words(N) + 4LL * M * rt_row(N, M) +
         24LL * RT_RING;
}

// a persistent block over the (row, block) items, item i = c T / N + j,
// claimed one at a time from the counter *next (zero at launch), so that
// the blocks sweep device memory together: one producer thread claims an
// item and copies its row piece in stages of up to RT_CHUNK samples into
// the ring, the item's index beside each stage (-1: no more items); the
// consumers relay each stage to the phase-major rows pm[m][q] = x[q M + m]
// + 1 (thread f's 16-byte word 4 f holds phases 4 f mod M .. + 3 of column
// 4 f / M), hand the stage back, and once the item's pm is whole write
// y[s] = pm[s mod M][s / M] out as 16-byte stores, four phase rows a
// vector
__global__ void __launch_bounds__(RT_NT, RT_PER_SM) pm_roundtrip_kernel(
    const float* __restrict__ x, float* __restrict__ y, int C, long long T,
    int N, int M, unsigned long long* next) {
  extern __shared__ __align__(128) float sm[];
  const int sw = rt_stage_words(N), row = rt_row(N, M);
  float* pm = sm + RT_RING * sw;
  uint64_t* bar = reinterpret_cast<uint64_t*>(pm + M * row);
  long long* slot = reinterpret_cast<long long*>(bar + 2 * RT_RING);
  const int tid = threadIdx.x;
  const long long nblk = T / N, items = (long long)C * nblk;
  const int nch = (N + sw - 1) / sw;
  if (tid == 0) {
    for (int i = 0; i < RT_RING; ++i) {
      hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init(&bar[RT_RING + i], RT_CONS / 32);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= RT_CONS) {
    // -- the producer ---------------------------------------------------------
    if (tid == RT_CONS) {
      for (int s = 0;;) {
        const long long it = (long long)atomicAdd(next, 1ULL);
        const float* src = x + (it / nblk) * T + (it % nblk) * N;
        for (int j = 0; j < nch; ++j, ++s) {
          const int st = s % RT_RING;
          hopper::mbar_wait(&bar[RT_RING + st], ((s / RT_RING) & 1) ^ 1);
          if (it >= items) {
            slot[st] = -1;
            hopper::mbar_arrive(&bar[st]);
            return;
          }
          const uint32_t bytes = 4u * min(sw, N - j * sw);
          slot[st] = it;
          hopper::mbar_expect(&bar[st], bytes);
          hopper::bulk_load(sm + st * sw, src + (long long)j * sw, bytes,
                            &bar[st]);
        }
      }
    }
    return;
  }

  // -- the consumers ----------------------------------------------------------
  const int lgm = M == 8 ? 3 : 2, lane = tid & 31;
  for (int s = 0;;) {
    long long it = 0;
    for (int j = 0; j < nch; ++j, ++s) {
      const int st = s % RT_RING;
      const int n4 = min(sw, N - j * sw) / 4, q0 = (j * sw) >> lgm;
      hopper::mbar_wait(&bar[st], (s / RT_RING) & 1);
      it = slot[st];
      if (it < 0) return;
      const float4* src = reinterpret_cast<const float4*>(sm + st * sw);
      for (int f = tid; f < n4; f += RT_CONS) {
        const float4 v = src[f];
        float* p = pm + ((4 * f) & (M - 1)) * row + q0 + ((4 * f) >> lgm);
        p[0] = v.x + 1.0f;
        p[row] = v.y + 1.0f;
        p[2 * row] = v.z + 1.0f;
        p[3 * row] = v.w + 1.0f;
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&bar[RT_RING + st]);
    }
    hopper::bar_sync(1, RT_CONS);
    float4* dst = reinterpret_cast<float4*>(y + (it / nblk) * T +
                                            (it % nblk) * N);
    for (int f = tid; f < N / 4; f += RT_CONS) {
      const float* p = pm + ((4 * f) & (M - 1)) * row + ((4 * f) >> lgm);
      dst[f] = make_float4(p[0], p[row], p[2 * row], p[3 * row]);
    }
    // pm is read: the next item may relay into it
    hopper::bar_sync(1, RT_CONS);
  }
}

// -- the selection products ---------------------------------------------------

// U, the 128 x 128 permutation of the header, as 16 k8 steps of K-major
// core matrices (hopper.cuh: element (k = 4 q + kk, n = 8 j + r) of a step
// at word 512 q + 32 j + 4 r + kk).  Row i = 16 p + 4 t + r4 of U (source
// sample i) is K index t + 4 (r4 & 1) of step 2 p + (r4 >> 1); column
// 16 m + jj (phase m, output jj of 16) is n = 16 m + 8 h + 2 t' + e with
// jj = 4 t' + 2 h + e
__device__ void build_u(uint32_t* u) {
  for (int w = threadIdx.x; w < U_WORDS; w += SEL_NT) u[w] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < SBLK; i += SEL_NT) {
    const int p = i >> 4, t = (i >> 2) & 3, r4 = i & 3;
    const int step = 2 * p + (r4 >> 1), q = r4 & 1;
    const int m = i & 7, jj = i >> 3;
    const int n = 16 * m + 8 * ((jj >> 1) & 1) + 2 * (jj >> 2) + (jj & 1);
    u[step * 8 * SBLK + 512 * q + 32 * (n >> 3) + 4 * (n & 7) + t] =
        0x3F800000u;   // 1.0f
  }
}

long long select_smem() {
  return 4LL * (U_WORDS + SEL_RING * SEL_STAGE) + 24LL * SEL_RING;
}

// item it = 8 tile + b: the source block b of the 64 rows (c, g) of a
// tile, claimed one at a time from the counter *next (zero at launch).
// The producer warp claims an item and copies it into the next ring stage,
// a row of 128 samples a 512-byte bulk copy at a pitch of SEL_PITCH words,
// the item's index beside the stage (-1: no more items, one such stage for
// each warpgroup); the consumer warpgroups take alternate stages: Z_b =
// X_b U in two halves of eight steps (the thread's four 16-byte loads of
// each of its two rows from the stage, split, then one wgmma group; the
// second half's loads are issued, and the stage handed back, while the
// first half's group runs), then Z_b + 1 to y as four 16-byte stores a row
template <bool ONE>
__global__ void __launch_bounds__(SEL_NT, 1) select_pm_kernel(
    const float* __restrict__ x, float* __restrict__ y, int C, long long T,
    unsigned long long* next) {
  extern __shared__ __align__(128) uint32_t ush[];
  float* ring = reinterpret_cast<float*>(ush + U_WORDS);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(ring + SEL_RING * SEL_STAGE);
  long long* slot = reinterpret_cast<long long*>(bar + 2 * SEL_RING);
  const int tid = threadIdx.x;
  build_u(ush);
  if (tid == 0) {
    for (int i = 0; i < SEL_RING; ++i) {
      hopper::mbar_init(&bar[i], 1);
      hopper::mbar_init(&bar[SEL_RING + i], 4);
    }
    hopper::fence_mbar_init();
  }
  hopper::fence_async();
  __syncthreads();
  const long long G = T / GROUP, R = (long long)C * G;
  const long long nitems = (R + 63) / 64 * 8;

  if (tid >= SEL_CONS) {
    // -- the producer warp (its warpgroup's registers go to the consumers) --
    hopper::regs_dec<56>();
    if (tid < SEL_CONS + 32) {
      const int lane = tid & 31;
      for (int s = 0;; ++s) {
        long long it = 0;
        if (lane == 0) it = (long long)atomicAdd(next, 1ULL);
        it = __shfl_sync(0xffffffffu, it, 0);
        const int st = s % SEL_RING;
        hopper::mbar_wait(&bar[SEL_RING + st], ((s / SEL_RING) & 1) ^ 1);
        if (it >= nitems) {
          // this stage stops one warpgroup, the next the other
          if (lane == 0) {
            slot[st] = -1;
            hopper::mbar_arrive(&bar[st]);
          }
          const int s2 = s + 1, st2 = s2 % SEL_RING;
          hopper::mbar_wait(&bar[SEL_RING + st2], ((s2 / SEL_RING) & 1) ^ 1);
          if (lane == 0) {
            slot[st2] = -1;
            hopper::mbar_arrive(&bar[st2]);
          }
          break;
        }
        const long long r0 = 64 * (it >> 3);
        const int b = (int)(it & 7);
        const int rows = (int)min(64LL, R - r0);
        if (lane == 0) {
          slot[st] = it;
          hopper::mbar_expect(&bar[st], rows * SBLK * 4);
        }
        __syncwarp();
        for (int i = lane; i < rows; i += 32) {
          const long long r = r0 + i;
          hopper::bulk_load(ring + st * SEL_STAGE + i * SEL_PITCH,
                            x + (r / G) * T + (r % G) * GROUP + SBLK * b,
                            SBLK * 4, &bar[st]);
        }
      }
    }
    return;
  }

  // -- the consumers ----------------------------------------------------------
  hopper::regs_inc<224>();
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = (tid >> 2) & 7, t = tid & 3;
  const uint32_t ubase = hopper::smem_u32(ush);
  float d[64];
  for (int s = wg;; s += 2) {
    const int st = s % SEL_RING;
    hopper::mbar_wait(&bar[st], (s / SEL_RING) & 1);
    const long long it = slot[st];
    if (it < 0) break;
    const long long r0 = 64 * (it >> 3) + 16 * w + g;
    const int b = (int)(it & 7);
    // rows r0 and r0 + 8 of the stage, the thread's 16-byte word 4 t of
    // each 16 samples
    const float* a = ring + st * SEL_STAGE + (16 * w + g) * SEL_PITCH + 4 * t;
    float4 v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        v[h][p] = *reinterpret_cast<const float4*>(a + 8 * h * SEL_PITCH +
                                                   16 * p);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // step 2 p + s: a0 = row 0's sample 4 t + 2 s, a1 row 1's, a2 and
      // a3 the next sample of each
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float q[4] = {e ? v[0][p].z : v[0][p].x,
                              e ? v[1][p].z : v[1][p].x,
                              e ? v[0][p].w : v[0][p].y,
                              e ? v[1][p].w : v[1][p].y};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ONE)
              ah[2 * p + e][j] = hopper::to_tf32(q[j]);
            else
              hopper::split_tf32(q[j], ah[2 * p + e][j], al[2 * p + e][j]);
          }
        }
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int step = 8 * half + k;
        const uint64_t desc =
            hopper::desc(ubase + step * 8 * SBLK * 4, 16 * SBLK, 128);
        const int acc = half > 0 || k > 0;
        if (!ONE) hopper::mma_n128(d, al[k], desc, acc);
        hopper::mma_n128(d, ah[k], desc, ONE ? acc : 1);
      }
      hopper::wgmma_commit();
      if (half == 0) {
        // the second half's loads while the first half's group runs; then
        // the stage is read and goes back to the producer
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int p = 0; p < 4; ++p)
            v[h][p] = *reinterpret_cast<const float4*>(
                a + 8 * h * SEL_PITCH + 16 * (4 + p));
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&bar[SEL_RING + st]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(d);
    }
    // row h's phase m: accumulators 8 m + 2 h + {0, 1, 4, 5}, outputs
    // 128 m + 16 b + 4 t .. + 3
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + 8 * h;
      if (r >= R) continue;
      float* dst = y + (r / G) * T + (r % G) * GROUP + 16 * b + 4 * t;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        *reinterpret_cast<float4*>(dst + 128 * m) = make_float4(
            d[8 * m + 2 * h] + 1.0f, d[8 * m + 2 * h + 1] + 1.0f,
            d[8 * m + 2 * h + 4] + 1.0f, d[8 * m + 2 * h + 5] + 1.0f);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 132;
  return n;
}

// blocks of the copies' one-shot grid over n words: a tile each
long long copy_grid(long long n) {
  return n < 1 ? 0 : (n + COPY_TILE - 1) / COPY_TILE;
}

// y = x + 1 over n contiguous words (x and y may lie anywhere)
int copy_launch(const float* x, float* y, long long n, void* stream) {
  const long long grid = copy_grid(n);
  if (grid < 1 || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  copy_flat_kernel<<<(unsigned)grid, COPY_NT, 0, (cudaStream_t)stream>>>(
      x, y, n, aligned16(x) && aligned16(y));
  return (int)cudaGetLastError();
}

// blocks a (C, N) block is cut into: enough that the grid holds eight
// blocks an SM (2048 threads, the most an SM keeps), no fewer than NT
// columns of `vectors` a block
int shares_for(long long nblocks, long long vectors) {
  const long long want = (8LL * sm_count() + nblocks - 1) / nblocks;
  const long long most = (vectors + NT - 1) / NT;
  return (int)std::max(1LL, std::min(want, std::max(1LL, most)));
}

}  // namespace

extern "C" {

// blocks of the copies' one-shot grid over n words
long long probe_copy_grid(long long n) { return copy_grid(n); }

// x and y (C, T) float32, contiguous; N > 0 (the reference's column block:
// the grid does not follow it)
int probe_copy_add1_launch(const float* x, float* y, int C, long long T,
                           int N, void* stream) {
  if (C < 1 || T < 1 || N < 1) return (int)cudaErrorInvalidValue;
  return copy_launch(x, y, (long long)C * T, stream);
}

// x and y (nprog, C, N) float32, contiguous
int probe_copy_pm_add1_launch(const float* x, float* y, int nprog, int C,
                              int N, void* stream) {
  if (nprog < 1 || C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  return copy_launch(x, y, (long long)nprog * C * N, stream);
}

// x (C, T) with T = nprog N; y, e (C, T); so (nprog, N / 128, C, nbins);
// po, go (nprog, 1, C); qo (nprog, C, nbins); all float32, contiguous
int probe_outputs_floor_launch(const float* x, int C, long long T, int N,
                               int nbins, float* y, float* e, float* so,
                               float* po, float* go, float* qo,
                               void* stream) {
  if (C < 1 || N < 128 || N % 128 || T % N || nbins < 1)
    return (int)cudaErrorInvalidValue;
  const long long nprog = T / N;
  const bool vec = N % 4 == 0 && T % 4 == 0 && aligned16(x) &&
                   aligned16(y) && aligned16(e);
  // a program's PSD and qo blocks start on 16-byte words where the first
  // does and the blocks are whole words
  const long long q = (long long)C * nbins;
  const bool vso = aligned16(so) && (N / 128) * q % 4 == 0;
  const bool vqo = aligned16(qo) && q % 4 == 0;
  const dim3 grid((unsigned)nprog, shares_for(nprog, N / 4));
  outputs_floor_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, C, T, N, nbins, Outputs{y, e, so, po, go, qo}, vec, vso, vqo);
  return (int)cudaGetLastError();
}

// u (C, M Q) at row stride ldu (>= M Q) -> out (C M, Q) contiguous;
// 1 <= M <= TS
int probe_pm_forward_launch(const float* u, long long ldu, int C, int Q,
                            int M, float* out, void* stream) {
  if (M < 1 || M > TS || C < 1 || C > 65535 || Q < 1 ||
      ldu < (long long)M * Q)
    return (int)cudaErrorInvalidValue;
  const int tq = TS / M;
  const bool vin = ldu % 4 == 0 && (tq * M) % 4 == 0 && aligned16(u);
  const bool vout = Q % 4 == 0 && tq % 4 == 0 && aligned16(out);
  const dim3 grid((Q + tq - 1) / tq, C);
  pm_forward_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(u, ldu, Q, M, tq,
                                                           out, vin, vout);
  return (int)cudaGetLastError();
}

// e (C M, Q) at row stride lde (>= Q) -> out (C, M Q) contiguous;
// 1 <= M <= TS
int probe_pm_inverse_launch(const float* e, long long lde, int C, int Q,
                            int M, float* out, void* stream) {
  if (M < 1 || M > TS || C < 1 || C > 65535 || Q < 1 || lde < Q)
    return (int)cudaErrorInvalidValue;
  const int tq = TS / M;
  const bool vin = lde % 4 == 0 && Q % 4 == 0 && tq % 4 == 0 && aligned16(e);
  const bool vout =
      ((long long)M * Q) % 4 == 0 && (tq * M) % 4 == 0 && aligned16(out);
  const dim3 grid((Q + tq - 1) / tq, C);
  pm_inverse_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(e, lde, Q, M, tq,
                                                           out, vin, vout);
  return (int)cudaGetLastError();
}

long long probe_pm_roundtrip_smem_bytes(int N, int M) {
  return roundtrip_smem(N, M);
}

// blocks of the round trip's persistent grid on `sms` SMs: RT_PER_SM an SM
// where their shared memory fits, no more than the items
long long probe_pm_roundtrip_grid(int C, long long T, int N, int M, int sms) {
  const long long per_sm = std::max(
      1LL, std::min((long long)RT_PER_SM,
                    SM_SMEM / (roundtrip_smem(N, M) + 1024)));
  return std::min((long long)C * (T / N), per_sm * sms);
}

// x and y (C, T) float32, contiguous, 16-byte aligned; T a multiple of N,
// N of 32, M 4 or 8; next: 8 bytes of device scratch, the item counter
// (zeroed here, on the stream, before the kernel)
int probe_pm_roundtrip_add1_launch(const float* x, float* y, int C,
                                   long long T, int N, int M, void* next,
                                   void* stream) {
  if ((M != 4 && M != 8) || C < 1 || N < 32 || N % 32 || T % N ||
      !aligned16(x) || !aligned16(y) || next == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long smem = roundtrip_smem(N, M);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pm_roundtrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(next, 0, sizeof(unsigned long long),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long grid = probe_pm_roundtrip_grid(C, T, N, M, sm_count());
  pm_roundtrip_kernel<<<(unsigned)grid, RT_NT, (size_t)smem,
                        (cudaStream_t)stream>>>(
      x, y, C, T, N, M, static_cast<unsigned long long*>(next));
  return (int)cudaGetLastError();
}

long long probe_select_pm_smem_bytes() { return select_smem(); }

// blocks of the selection's persistent grid on `sms` SMs: one an SM, no
// more than the items (8 a tile of 64 rows)
long long probe_select_pm_grid(int C, long long T, int sms) {
  const long long items = ((long long)C * (T / GROUP) + 63) / 64 * 8;
  return std::min(items, (long long)sms);
}

// x and y (C, T) float32, contiguous, 16-byte aligned, T a multiple of
// 1024; one: a single TF32 pass (DEFAULT), else two (HIGHEST, HIGH);
// next: 8 bytes of device scratch, the item counter (zeroed here)
int probe_select_pm_add1_launch(const float* x, float* y, int C,
                                long long T, int one, void* next,
                                void* stream) {
  if (C < 1 || T < GROUP || T % GROUP || !aligned16(x) || !aligned16(y) ||
      next == nullptr)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)select_smem();
  auto kernel = one ? select_pm_kernel<true> : select_pm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(next, 0, sizeof(unsigned long long),
                        (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const long long grid = probe_select_pm_grid(C, T, sm_count());
  kernel<<<(unsigned)grid, SEL_NT, smem, (cudaStream_t)stream>>>(
      x, y, C, T, static_cast<unsigned long long*>(next));
  return (int)cudaGetLastError();
}

}  // extern "C"
