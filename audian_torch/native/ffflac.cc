// FFmpeg-backed FLAC codec oracle.
//
// The repo's FLAC decoder/encoder (`audian_torch/data/flac.py`,
// `native/flacdec.cc`) would otherwise only be validated against each
// other — a symmetric spec misreading would pass every test.  This shim
// binds the system libavcodec/libavformat (an independent,
// battle-tested FLAC implementation, the same codec family the
// reference gets through libsndfile/SoundFile,
// the reference's pyproject.toml:17) so the test suite can
//   * encode arbitrary PCM with FFmpeg's FLAC encoder (LPC orders,
//     stereo decorrelation, rice partitions...) and require the repo
//     decoders to bit-match, and
//   * decode the repo encoder's output through FFmpeg's parser+decoder
//     and require bit-exact PCM back,
// and so golden assets in tests/data can be (re)generated from a real
// external implementation.  Compiled on demand into libaudianffm.so;
// every caller degrades gracefully when the FFmpeg dev files are
// absent.
//
// This is test/validation infrastructure, not the production decode
// path (that is flacdec.cc; the pure-Python decoder is the oracle of
// last resort).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
}

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// keep harmless codec chatter (e.g. >2ch layout notes) out of test logs
struct QuietLog {
  QuietLog() { av_log_set_level(AV_LOG_FATAL); }
} quiet_log;

struct Decoded {
  std::vector<int32_t> samples;  // interleaved, sign-extended
  int rate = 0;
  int channels = 0;
  int bits = 0;
};

// Append one decoded frame's samples (any common FLAC sample layout:
// s16/s32, packed or planar) to out.samples as sign-extended int32.
// FFmpeg stores <=16-bit FLAC as s16 and 17..32-bit as s32 shifted up
// to the top of the 32-bit container; shift back down to raw sample
// values so the comparison with the repo decoders is in native units.
bool append_frame(const AVFrame* fr, int bits, Decoded* out) {
  const int ch = fr->ch_layout.nb_channels;
  const int n = fr->nb_samples;
  const AVSampleFormat fmt = static_cast<AVSampleFormat>(fr->format);
  const bool planar = av_sample_fmt_is_planar(fmt) != 0;
  const AVSampleFormat base = av_get_packed_sample_fmt(fmt);
  size_t at = out->samples.size();
  out->samples.resize(at + static_cast<size_t>(n) * ch);
  if (base == AV_SAMPLE_FMT_S16) {
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < ch; ++c) {
        const int16_t* src = reinterpret_cast<const int16_t*>(
            planar ? fr->extended_data[c] : fr->extended_data[0]);
        out->samples[at++] = planar ? src[i] : src[i * ch + c];
      }
    // <=16-bit streams are NOT shifted by FFmpeg's s16 path
    if (bits < 16)
      for (size_t k = out->samples.size() - size_t(n) * ch;
           k < out->samples.size(); ++k)
        out->samples[k] >>= (16 - bits);
  } else if (base == AV_SAMPLE_FMT_S32) {
    const int shift = 32 - bits;
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < ch; ++c) {
        const int32_t* src = reinterpret_cast<const int32_t*>(
            planar ? fr->extended_data[c] : fr->extended_data[0]);
        int32_t v = planar ? src[i] : src[i * ch + c];
        out->samples[at++] = v >> shift;
      }
  } else {
    return false;
  }
  return true;
}

int decode_file(const char* path, Decoded* out) {
  AVFormatContext* ic = nullptr;
  if (avformat_open_input(&ic, path, nullptr, nullptr) < 0) return -1;
  int rc = -2;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  do {
    if (avformat_find_stream_info(ic, nullptr) < 0) break;
    int si = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1,
                                 nullptr, 0);
    if (si < 0) break;
    AVStream* st = ic->streams[si];
    if (st->codecpar->codec_id != AV_CODEC_ID_FLAC) {
      rc = -3;
      break;
    }
    const AVCodec* dec = avcodec_find_decoder(AV_CODEC_ID_FLAC);
    if (!dec) break;
    cc = avcodec_alloc_context3(dec);
    if (!cc || avcodec_parameters_to_context(cc, st->codecpar) < 0)
      break;
    // fail on CRC mismatches instead of splicing silence
    cc->err_recognition |= AV_EF_CRCCHECK | AV_EF_EXPLODE;
    if (avcodec_open2(cc, dec, nullptr) < 0) break;
    out->bits = st->codecpar->bits_per_raw_sample
                    ? st->codecpar->bits_per_raw_sample
                    : cc->bits_per_raw_sample;
    if (out->bits <= 0) out->bits = 16;
    out->rate = cc->sample_rate;
    out->channels = cc->ch_layout.nb_channels;
    pkt = av_packet_alloc();
    fr = av_frame_alloc();
    if (!pkt || !fr) break;
    rc = 0;
    bool drained = false;
    while (!drained) {
      int r = av_read_frame(ic, pkt);
      if (r < 0) {
        avcodec_send_packet(cc, nullptr);  // flush
        drained = true;
      } else if (pkt->stream_index != si) {
        av_packet_unref(pkt);
        continue;
      } else {
        r = avcodec_send_packet(cc, pkt);
        av_packet_unref(pkt);
        if (r < 0) {
          rc = -4;  // corrupt packet (CRC/parse failure under EXPLODE)
          break;
        }
      }
      while (true) {
        int r2 = avcodec_receive_frame(cc, fr);
        if (r2 == AVERROR(EAGAIN) || r2 == AVERROR_EOF) break;
        if (r2 < 0) {
          rc = -4;
          drained = true;
          break;
        }
        if (!append_frame(fr, out->bits, out)) {
          rc = -5;
          drained = true;
          break;
        }
      }
    }
  } while (false);
  if (fr) av_frame_free(&fr);
  if (pkt) av_packet_free(&pkt);
  if (cc) avcodec_free_context(&cc);
  avformat_close_input(&ic);
  return rc;
}

}  // namespace

namespace {

// Generic any-container/any-codec decode to interleaved float32 — the
// fallback reader behind `data/wavio.py` for containers outside the
// in-repo WAV/FLAC decoders (OGG/Vorbis, AIFF, MP3, ...), standing in
// for the reference's always-present libsndfile
// (the reference's pyproject.toml:17) when `soundfile` is not
// installed but the FFmpeg system libraries exist.
struct DecodedF32 {
  std::vector<float> samples;  // interleaved
  int rate = 0;
  int channels = 0;
};

bool append_frame_f32(const AVFrame* fr, DecodedF32* out) {
  const int ch = fr->ch_layout.nb_channels;
  const int n = fr->nb_samples;
  const AVSampleFormat fmt = static_cast<AVSampleFormat>(fr->format);
  const bool planar = av_sample_fmt_is_planar(fmt) != 0;
  const AVSampleFormat base = av_get_packed_sample_fmt(fmt);
  size_t at = out->samples.size();
  out->samples.resize(at + static_cast<size_t>(n) * ch);
  for (int i = 0; i < n; ++i)
    for (int c = 0; c < ch; ++c) {
      const uint8_t* plane =
          planar ? fr->extended_data[c] : fr->extended_data[0];
      const int64_t k = planar ? i : (int64_t)i * ch + c;
      double v;
      switch (base) {
        case AV_SAMPLE_FMT_U8:
          v = (reinterpret_cast<const uint8_t*>(plane)[k] - 128) /
              128.0;
          break;
        case AV_SAMPLE_FMT_S16:
          v = reinterpret_cast<const int16_t*>(plane)[k] / 32768.0;
          break;
        case AV_SAMPLE_FMT_S32:
          v = reinterpret_cast<const int32_t*>(plane)[k] / 2147483648.0;
          break;
        case AV_SAMPLE_FMT_FLT:
          v = reinterpret_cast<const float*>(plane)[k];
          break;
        case AV_SAMPLE_FMT_DBL:
          v = reinterpret_cast<const double*>(plane)[k];
          break;
        default:
          return false;
      }
      out->samples[at++] = (float)v;
    }
  return true;
}

int decode_file_f32(const char* path, DecodedF32* out) {
  AVFormatContext* ic = nullptr;
  if (avformat_open_input(&ic, path, nullptr, nullptr) < 0) return -1;
  int rc = -2;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  do {
    if (avformat_find_stream_info(ic, nullptr) < 0) break;
    int si = av_find_best_stream(ic, AVMEDIA_TYPE_AUDIO, -1, -1,
                                 nullptr, 0);
    if (si < 0) break;
    AVStream* st = ic->streams[si];
    const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) {
      rc = -3;
      break;
    }
    cc = avcodec_alloc_context3(dec);
    if (!cc || avcodec_parameters_to_context(cc, st->codecpar) < 0)
      break;
    if (avcodec_open2(cc, dec, nullptr) < 0) break;
    out->rate = cc->sample_rate;
    out->channels = cc->ch_layout.nb_channels;
    pkt = av_packet_alloc();
    fr = av_frame_alloc();
    if (!pkt || !fr) break;
    rc = 0;
    bool drained = false;
    while (!drained && rc == 0) {
      int r = av_read_frame(ic, pkt);
      if (r < 0) {
        avcodec_send_packet(cc, nullptr);
        drained = true;
      } else if (pkt->stream_index != si) {
        av_packet_unref(pkt);
        continue;
      } else {
        r = avcodec_send_packet(cc, pkt);
        av_packet_unref(pkt);
        if (r < 0) {
          rc = -4;
          break;
        }
      }
      while (true) {
        int r2 = avcodec_receive_frame(cc, fr);
        if (r2 == AVERROR(EAGAIN) || r2 == AVERROR_EOF) break;
        if (r2 < 0 || !append_frame_f32(fr, out)) {
          rc = -5;
          drained = true;
          break;
        }
      }
    }
    if (rc == 0 && out->channels > 0 && out->samples.empty())
      rc = -6;  // container recognized but nothing decoded
  } while (false);
  if (fr) av_frame_free(&fr);
  if (pkt) av_packet_free(&pkt);
  if (cc) avcodec_free_context(&cc);
  avformat_close_input(&ic);
  return rc;
}

}  // namespace

extern "C" {

// Generic single-pass read: decodes the whole file ONCE (trustworthy
// lengths for VBR streams) and returns a malloc'd interleaved float32
// buffer in *data — release it with ffp_audio_release.  Returns 0 on
// success (-8: allocation failure).
int ffp_audio_read(const char* path, float** data, int* rate,
                   int* channels, long long* frames) {
  DecodedF32 d;
  int rc = decode_file_f32(path, &d);
  if (rc != 0) return rc;
  *rate = d.rate;
  *channels = d.channels;
  *frames = d.channels ? (long long)(d.samples.size() / d.channels) : 0;
  *data = static_cast<float*>(
      std::malloc(d.samples.size() * sizeof(float)));
  if (!*data && !d.samples.empty()) return -8;
  std::memcpy(*data, d.samples.data(),
              d.samples.size() * sizeof(float));
  return 0;
}

void ffp_audio_release(float* data) { std::free(data); }

// Probe: rate/channels/bits/frames of a FLAC file via FFmpeg.
// Returns 0 on success.  frames is the DECODED length (the whole file
// is decoded; FLAC headers may lie, the decode result cannot).
int ffp_flac_info(const char* path, int* rate, int* channels, int* bits,
                  long long* frames) {
  Decoded d;
  int rc = decode_file(path, &d);
  if (rc != 0) return rc;
  *rate = d.rate;
  *channels = d.channels;
  *bits = d.bits;
  *frames = d.channels ? (long long)(d.samples.size() / d.channels) : 0;
  return 0;
}

// Decode the whole file into caller-provided interleaved int32 storage
// (capacity max_frames frames).  Returns frames written, or <0 on
// error (-6: capacity too small).
long long ffp_flac_decode(const char* path, int32_t* out,
                          long long max_frames) {
  Decoded d;
  int rc = decode_file(path, &d);
  if (rc != 0) return rc;
  long long frames =
      d.channels ? (long long)(d.samples.size() / d.channels) : 0;
  if (frames > max_frames) return -6;
  std::memcpy(out, d.samples.data(), d.samples.size() * sizeof(int32_t));
  return frames;
}

// Encode interleaved int32 samples (raw values at `bits` depth) to a
// FLAC file with FFmpeg's encoder at `level` (0..12).  bits must be 16
// (s16 path) or 17..32 (s32 path; FFmpeg writes bits_per_raw_sample).
// Returns 0 on success.
int ffp_flac_encode(const char* path, const int32_t* samples,
                    long long frames, int channels, int rate, int bits,
                    int level) {
  const AVCodec* enc = avcodec_find_encoder(AV_CODEC_ID_FLAC);
  if (!enc) return -1;
  AVFormatContext* oc = nullptr;
  if (avformat_alloc_output_context2(&oc, nullptr, "flac", path) < 0 ||
      !oc)
    return -2;
  int rc = -3;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  bool io_open = false;
  do {
    cc = avcodec_alloc_context3(enc);
    if (!cc) break;
    cc->sample_rate = rate;
    av_channel_layout_default(&cc->ch_layout, channels);
    cc->sample_fmt = bits <= 16 ? AV_SAMPLE_FMT_S16 : AV_SAMPLE_FMT_S32;
    if (bits > 16) cc->bits_per_raw_sample = bits;
    cc->compression_level = level;
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(cc, enc, nullptr) < 0) break;
    AVStream* st = avformat_new_stream(oc, nullptr);
    if (!st ||
        avcodec_parameters_from_context(st->codecpar, cc) < 0)
      break;
    st->time_base = AVRational{1, rate};
    if (!(oc->oformat->flags & AVFMT_NOFILE)) {
      if (avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0) break;
      io_open = true;
    }
    if (avformat_write_header(oc, nullptr) < 0) break;
    pkt = av_packet_alloc();
    fr = av_frame_alloc();
    if (!pkt || !fr) break;
    const int block = cc->frame_size > 0 ? cc->frame_size : 4096;
    long long pos = 0;
    rc = 0;
    const int shift = bits > 16 ? 32 - bits : 0;
    while (rc == 0 && pos <= frames) {
      int n = 0;
      bool flush = pos >= frames;
      if (!flush) {
        n = (int)std::min<long long>(block, frames - pos);
        fr->nb_samples = n;
        fr->format = cc->sample_fmt;
        av_channel_layout_copy(&fr->ch_layout, &cc->ch_layout);
        if (av_frame_get_buffer(fr, 0) < 0) {
          rc = -4;
          break;
        }
        if (cc->sample_fmt == AV_SAMPLE_FMT_S16) {
          int16_t* dst = reinterpret_cast<int16_t*>(fr->data[0]);
          for (long long k = 0; k < (long long)n * channels; ++k)
            dst[k] = (int16_t)samples[pos * channels + k];
        } else {
          int32_t* dst = reinterpret_cast<int32_t*>(fr->data[0]);
          for (long long k = 0; k < (long long)n * channels; ++k)
            dst[k] = samples[pos * channels + k] << shift;
        }
        fr->pts = pos;
      }
      int r = avcodec_send_frame(cc, flush ? nullptr : fr);
      if (!flush) av_frame_unref(fr);
      if (r < 0) {
        rc = -5;
        break;
      }
      while (true) {
        int r2 = avcodec_receive_packet(cc, pkt);
        if (r2 == AVERROR(EAGAIN) || r2 == AVERROR_EOF) break;
        if (r2 < 0) {
          rc = -5;
          break;
        }
        pkt->stream_index = 0;
        if (av_interleaved_write_frame(oc, pkt) < 0) {
          rc = -5;
          break;
        }
      }
      if (flush) break;
      pos += n;
    }
    if (rc == 0 && av_write_trailer(oc) < 0) rc = -7;
  } while (false);
  if (fr) av_frame_free(&fr);
  if (pkt) av_packet_free(&pkt);
  if (cc) avcodec_free_context(&cc);
  if (io_open) avio_closep(&oc->pb);
  avformat_free_context(oc);
  return rc;
}

// Generic audio EXPORT through libavformat/libavcodec: encode float
// samples into any container/codec the system FFmpeg can mux (OGG/
// Vorbis, AIFF, MP3, ...).  This is the write-side twin of
// ffp_audio_read — the reference's save dialog offers every format
// libsndfile can write (the reference's databrowser.py:
// 1875-1880); audian_torch reaches the same breadth through the system
// FFmpeg libraries when present (`data/wavio.py:write_audio` routes
// non-WAV/FLAC formats here).  Sample-format conversion (interleaved
// float -> FLT/FLTP/S16/S16P) is done inline so no libswresample
// dependency is added.
int ffp_audio_encode(const char* path, const float* samples,
                     long long frames, int channels, int rate,
                     const char* format_name, const char* metadata_kv) {
  AVFormatContext* oc = nullptr;
  if (avformat_alloc_output_context2(
          &oc, nullptr,
          (format_name && format_name[0]) ? format_name : nullptr,
          path) < 0 ||
      !oc)
    return -2;
  enum AVCodecID cid = av_guess_codec(oc->oformat, nullptr, path,
                                      nullptr, AVMEDIA_TYPE_AUDIO);
  const AVCodec* enc = avcodec_find_encoder(cid);
  if (!enc) {
    avformat_free_context(oc);
    return -1;
  }
  // pick a sample format this encoder accepts that we can fill inline
  enum AVSampleFormat want = AV_SAMPLE_FMT_NONE;
  if (enc->sample_fmts) {
    const enum AVSampleFormat prefs[] = {
        AV_SAMPLE_FMT_FLT, AV_SAMPLE_FMT_FLTP, AV_SAMPLE_FMT_S16,
        AV_SAMPLE_FMT_S16P};
    for (int p = 0; p < 4 && want == AV_SAMPLE_FMT_NONE; ++p)
      for (const enum AVSampleFormat* f = enc->sample_fmts;
           *f != AV_SAMPLE_FMT_NONE; ++f)
        if (*f == prefs[p]) {
          want = prefs[p];
          break;
        }
  } else {
    want = AV_SAMPLE_FMT_FLT;
  }
  if (want == AV_SAMPLE_FMT_NONE) {
    avformat_free_context(oc);
    return -8;
  }
  int rc = -3;
  AVCodecContext* cc = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  bool io_open = false;
  do {
    cc = avcodec_alloc_context3(enc);
    if (!cc) break;
    cc->sample_rate = rate;
    av_channel_layout_default(&cc->ch_layout, channels);
    cc->sample_fmt = want;
    if (cid == AV_CODEC_ID_VORBIS) {
      // NOT managed-bitrate mode: libvorbis' bitrate floor scales with
      // rate x channels and rejects 64 kbps/ch outright at 96 kHz —
      // the field-recorder rate this tool lives at.  Quality mode
      // (what libsndfile uses for the reference's OGG exports) works
      // at every rate libvorbis supports; q3 ~= 112 kbps for 44.1 kHz
      // stereo and scales itself.
      cc->flags |= AV_CODEC_FLAG_QSCALE;
      cc->global_quality = (int)(3.0 * FF_QP2LAMBDA);
    } else if (!(enc->capabilities & AV_CODEC_CAP_VARIABLE_FRAME_SIZE) &&
               cid != AV_CODEC_ID_PCM_S16LE && cid != AV_CODEC_ID_PCM_S16BE)
      cc->bit_rate = 64000LL * channels;  // lossy codecs need a target
    if (oc->oformat->flags & AVFMT_GLOBALHEADER)
      cc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(cc, enc, nullptr) < 0) break;
    AVStream* st = avformat_new_stream(oc, nullptr);
    if (!st || avcodec_parameters_from_context(st->codecpar, cc) < 0)
      break;
    st->time_base = AVRational{1, rate};
    // metadata: 0x1E (record separator)-separated key=value pairs land
    // in the muxer's dictionary (vorbis comments for OGG, ID3 for MP3,
    // ...) — the formats store what they support, like libsndfile does
    // for the reference's exports.  0x1E, not '\n': multi-line values
    // are legal in BWF/INFO comments and must survive the wire format
    if (metadata_kv && metadata_kv[0]) {
      const char* p2 = metadata_kv;
      while (*p2) {
        const char* eol = strchr(p2, '\x1e');
        size_t len = eol ? (size_t)(eol - p2) : strlen(p2);
        const char* eq = (const char*)memchr(p2, '=', len);
        if (eq && eq > p2) {
          std::string key(p2, (size_t)(eq - p2));
          std::string val(eq + 1, len - (size_t)(eq - p2) - 1);
          av_dict_set(&oc->metadata, key.c_str(), val.c_str(), 0);
        }
        p2 += len + (eol ? 1 : 0);
      }
    }
    if (!(oc->oformat->flags & AVFMT_NOFILE)) {
      if (avio_open(&oc->pb, path, AVIO_FLAG_WRITE) < 0) break;
      io_open = true;
    }
    if (avformat_write_header(oc, nullptr) < 0) break;
    pkt = av_packet_alloc();
    fr = av_frame_alloc();
    if (!pkt || !fr) break;
    const int block = cc->frame_size > 0 ? cc->frame_size : 4096;
    long long pos = 0;
    rc = 0;
    while (rc == 0 && pos <= frames) {
      int n = 0;
      bool flush = pos >= frames;
      if (!flush) {
        n = (int)std::min<long long>(block, frames - pos);
        fr->nb_samples = n;
        fr->format = cc->sample_fmt;
        av_channel_layout_copy(&fr->ch_layout, &cc->ch_layout);
        if (av_frame_get_buffer(fr, 0) < 0) {
          rc = -4;
          break;
        }
        const float* src = samples + pos * channels;
        if (want == AV_SAMPLE_FMT_FLT) {
          std::memcpy(fr->data[0], src,
                      sizeof(float) * (size_t)n * channels);
        } else if (want == AV_SAMPLE_FMT_FLTP) {
          // extended_data, NOT data: data[] has only 8 slots and e.g.
          // Vorbis accepts far more planar channels (a 16-channel
          // export through data[] is an out-of-bounds write)
          for (int c = 0; c < channels; ++c) {
            float* dst = reinterpret_cast<float*>(fr->extended_data[c]);
            for (int k = 0; k < n; ++k)
              dst[k] = src[(long long)k * channels + c];
          }
        } else if (want == AV_SAMPLE_FMT_S16) {
          int16_t* dst = reinterpret_cast<int16_t*>(fr->data[0]);
          for (long long k = 0; k < (long long)n * channels; ++k) {
            float v = src[k] * 32768.0f;
            v = v < -32768.0f ? -32768.0f : (v > 32767.0f ? 32767.0f : v);
            dst[k] = (int16_t)lrintf(v);
          }
        } else {  // S16P
          for (int c = 0; c < channels; ++c) {
            int16_t* dst =
                reinterpret_cast<int16_t*>(fr->extended_data[c]);
            for (int k = 0; k < n; ++k) {
              float v = src[(long long)k * channels + c] * 32768.0f;
              v = v < -32768.0f ? -32768.0f
                                : (v > 32767.0f ? 32767.0f : v);
              dst[k] = (int16_t)lrintf(v);
            }
          }
        }
        fr->pts = pos;
      }
      int r = avcodec_send_frame(cc, flush ? nullptr : fr);
      if (!flush) av_frame_unref(fr);
      if (r < 0) {
        rc = -5;
        break;
      }
      while (true) {
        int r2 = avcodec_receive_packet(cc, pkt);
        if (r2 == AVERROR(EAGAIN) || r2 == AVERROR_EOF) break;
        if (r2 < 0) {
          rc = -5;
          break;
        }
        pkt->stream_index = 0;
        av_packet_rescale_ts(pkt, cc->time_base, st->time_base);
        if (av_interleaved_write_frame(oc, pkt) < 0) {
          rc = -5;
          break;
        }
      }
      if (flush) break;
      pos += n;
    }
    if (rc == 0 && av_write_trailer(oc) < 0) rc = -7;
  } while (false);
  if (fr) av_frame_free(&fr);
  if (pkt) av_packet_free(&pkt);
  if (cc) avcodec_free_context(&cc);
  if (io_open) avio_closep(&oc->pb);
  avformat_free_context(oc);
  return rc;
}

}  // extern "C"
