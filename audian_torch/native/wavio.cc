// Native host-side runtime for audian_torch: bulk PCM decode and threaded
// min/max pyramid computation.
//
// The reference delegates its host hot loops to numpy ufuncs and a
// fork-server multiprocessing pool sharing a locked mp.Array
// (src/audian/compresseddata.py:25-53,104-122).  Here the same work is a
// small C++ library: lock-free (each thread owns a disjoint block stripe),
// SIMD-friendly inner loops, called from Python via ctypes.  The card never
// sees this code — it feeds the device and serves the overview/cache path.
//
// Built with flacdec.cc and flacenc.cc into one shared library at first use
// (audian_torch/native/__init__.py: g++ -O3 -march=native -shared -fPIC -pthread).

#ifndef _FILE_OFFSET_BITS
#define _FILE_OFFSET_BITS 64  // 64-bit fseeko on 32-bit-long platforms
#endif

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <limits>
#include <thread>
#include <vector>

namespace {

// ---- PCM decoding ----------------------------------------------------------

inline void decode_pcm16(const uint8_t* raw, int64_t n, float* out) {
    const int16_t* p = reinterpret_cast<const int16_t*>(raw);
    constexpr float s = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = p[i] * s;
}

inline void decode_pcm24(const uint8_t* raw, int64_t n, float* out) {
    constexpr float s = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* b = raw + 3 * i;
        int32_t v = int32_t(b[0]) | (int32_t(b[1]) << 8) | (int32_t(b[2]) << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        out[i] = v * s;
    }
}

inline void decode_pcm32(const uint8_t* raw, int64_t n, float* out) {
    const int32_t* p = reinterpret_cast<const int32_t*>(raw);
    constexpr double s = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < n; ++i) out[i] = float(p[i] * s);
}

inline void decode_f32(const uint8_t* raw, int64_t n, float* out) {
    std::memcpy(out, raw, size_t(n) * 4);
}

inline void decode_f64(const uint8_t* raw, int64_t n, float* out) {
    const double* p = reinterpret_cast<const double*>(raw);
    for (int64_t i = 0; i < n; ++i) out[i] = float(p[i]);
}

int decode_dispatch(const uint8_t* raw, int64_t nsamples, int tag, int bits,
                    float* out) {
    if (tag == 1 && bits == 16) decode_pcm16(raw, nsamples, out);
    else if (tag == 1 && bits == 24) decode_pcm24(raw, nsamples, out);
    else if (tag == 1 && bits == 32) decode_pcm32(raw, nsamples, out);
    else if (tag == 3 && bits == 32) decode_f32(raw, nsamples, out);
    else if (tag == 3 && bits == 64) decode_f64(raw, nsamples, out);
    else return -1;
    return 0;
}

}  // namespace

extern "C" {

// Decode nsamples raw samples (tag: 1=PCM, 3=float) to float32.
// Returns 0 on success, -1 on unsupported encoding.
int an_decode(const uint8_t* raw, int64_t nsamples, int tag, int bits,
              float* out) {
    return decode_dispatch(raw, nsamples, tag, bits, out);
}

// Read + decode [start, start+nframes) frames of interleaved audio from a
// file whose data chunk starts at byte data_off.  out must hold
// nframes*channels floats.  Returns frames read (may be short at EOF) or
// -1 on error.
int64_t an_read_frames(const char* path, int64_t data_off, int tag, int bits,
                       int channels, int64_t start, int64_t nframes,
                       float* out) {
    // Stream the file through a small bounded scratch buffer and decode
    // each piece straight into `out`.  A full-read-then-decode staging
    // vector of nframes*bpf bytes would fault in fresh pages on every
    // call, and first-touch of new anonymous memory is far slower than
    // warm memory — the bounded scratch stays warm
    // after the first call (thread_local: an_file_minmax's worker
    // threads call this concurrently).
    const int64_t bpf = int64_t(channels) * (bits / 8);
    constexpr int64_t kScratch = 4 << 20;  // bytes; multiple of any bpf*8
    thread_local std::vector<uint8_t> raw;
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // fseeko + off_t (with _FILE_OFFSET_BITS=64): plain fseek takes a
    // `long`, which truncates offsets past 2 GiB where long is 32 bits
    if (fseeko(f, off_t(data_off + start * bpf), SEEK_SET) != 0) {
        std::fclose(f);
        return -1;  // I/O error, not "zero frames": callers must fall
                    // back or surface it, never render silence
    }
    const int64_t frames_per_piece = std::max<int64_t>(kScratch / bpf, 1);
    raw.resize(size_t(std::min(nframes, frames_per_piece) * bpf));
    int64_t got = 0;
    bool bad = false;
    while (got < nframes) {
        const int64_t want = std::min(nframes - got, frames_per_piece);
        const int64_t n =
            int64_t(std::fread(raw.data(), 1, size_t(want * bpf), f)) / bpf;
        if (n > 0 &&
            decode_dispatch(raw.data(), n * channels, tag, bits,
                            out + got * channels) != 0) {
            bad = true;
            break;
        }
        got += n;
        if (n < want) break;  // EOF / short file
    }
    std::fclose(f);
    return bad ? -1 : got;
}

// Interleaved min/max decimation: x is (frames, channels) row-major float32;
// out is (2*nseg, channels) with out[2k]=min, out[2k+1]=max over segment k
// of `step` frames (ragged tail allowed) — the layout of
// src/audian/traceitem.py:55-61 and compresseddata.py:49-52.
void an_minmax(const float* x, int64_t frames, int channels, int64_t step,
               double* out) {
    const int64_t nseg = (frames + step - 1) / step;
    for (int64_t k = 0; k < nseg; ++k) {
        const int64_t i0 = k * step;
        const int64_t i1 = std::min(i0 + step, frames);
        double* mn = out + (2 * k) * channels;
        double* mx = out + (2 * k + 1) * channels;
        for (int c = 0; c < channels; ++c) {
            mn[c] = std::numeric_limits<double>::infinity();
            mx[c] = -std::numeric_limits<double>::infinity();
        }
        for (int64_t i = i0; i < i1; ++i) {
            const float* row = x + i * channels;
            for (int c = 0; c < channels; ++c) {
                const double v = row[c];
                if (v < mn[c]) mn[c] = v;
                if (v > mx[c]) mx[c] = v;
            }
        }
    }
}

// Whole-file min/max overview: stream the file in block stripes across
// nthreads threads (each thread owns disjoint segments -> no locks) and
// fill out (2*nseg, channels) float64, nseg = ceil(frames/step).
// Returns 0 on success.
int an_file_minmax(const char* path, int64_t data_off, int tag, int bits,
                   int channels, int64_t frames, int64_t step,
                   int nthreads, double* out) {
    if (nthreads < 1) nthreads = 1;
    // block size: a multiple of step close to 1M frames (same role as the
    // reference's 30 s blocks, compresseddata.py:107)
    int64_t nblock = std::max<int64_t>(step, (1 << 20) / step * step);
    const int64_t nblocks = (frames + nblock - 1) / nblock;
    nthreads = int(std::min<int64_t>(nthreads, nblocks));
    std::vector<std::thread> threads;
    std::vector<int> errs(size_t(nthreads), 0);
    for (int tdx = 0; tdx < nthreads; ++tdx) {
        threads.emplace_back([=, &errs]() {
            std::vector<float> buf;
            for (int64_t b = tdx; b < nblocks; b += nthreads) {
                const int64_t start = b * nblock;
                const int64_t n = std::min(nblock, frames - start);
                buf.resize(size_t(n * channels));
                const int64_t got = an_read_frames(path, data_off, tag, bits,
                                                   channels, start, n,
                                                   buf.data());
                if (got < 0) { errs[size_t(tdx)] = 1; return; }
                an_minmax(buf.data(), got, channels, step,
                          out + (2 * (start / step)) * channels);
            }
        });
    }
    for (auto& t : threads) t.join();
    for (int e : errs)
        if (e) return -1;
    return 0;
}

}  // extern "C"
