// Native FLAC encoder — the production write path behind
// audian_torch.data.flac.write_flac.
//
// The Python encoder in data/flac.py is the readable correctness
// reference (~120 ksamples/s — fine for tests, unusable for exporting
// an hour of 16-channel audio); this file implements the same design
// at C++ speed: fixed 4096-sample blocks, per-subframe best-of
// CONSTANT / FIXED(0-4) / LPC(Levinson-Durbin, 15-bit quantized
// coefficients) / VERBATIM with partitioned RICE/RICE2 residuals and
// wasted-bits packing, per-frame stereo decorrelation for 2 channels,
// and a true STREAMINFO MD5.  Output is a valid stream for ANY FLAC
// decoder — correctness is pinned by decode-equality tests against
// the repo decoders and FFmpeg/libFLAC (tests/test_flac_interop.py,
// tests/test_libflac_cli.py), not byte-equality with the Python
// encoder.
//
// Reference parity: the reference writes FLAC through libsndfile
// (the reference's databrowser.py:1860-1921).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- MD5
// Compact RFC 1321 implementation (public-domain style rewrite).
struct Md5 {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe,
           d = 0x10325476;
  uint64_t len = 0;
  uint8_t buf[64];
  int fill = 0;

  static uint32_t rol(uint32_t x, int s) {
    return (x << s) | (x >> (32 - s));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf,
        0x4787c62a, 0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af,
        0xffff5bb1, 0x895cd7be, 0x6b901122, 0xfd987193, 0xa679438e,
        0x49b40821, 0xf61e2562, 0xc040b340, 0x265e5a51, 0xe9b6c7aa,
        0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8, 0x21e1cde6,
        0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122,
        0xfde5380c, 0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70,
        0x289b7ec6, 0xeaa127fa, 0xd4ef3085, 0x04881d05, 0xd9d4d039,
        0xe6db99e5, 0x1fa27cf8, 0xc4ac5665, 0xf4292244, 0x432aff97,
        0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92, 0xffeff47d,
        0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17,
                              22, 7, 12, 17, 22, 5, 9,  14, 20, 5, 9,
                              14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 4,
                              11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              4,  11, 16, 23, 6, 10, 15, 21, 6, 10, 15,
                              21, 6,  10, 15, 21, 6, 10, 15, 21};
    uint32_t m[16];
    for (int i = 0; i < 16; i++)
      m[i] = (uint32_t)p[4 * i] | ((uint32_t)p[4 * i + 1] << 8) |
             ((uint32_t)p[4 * i + 2] << 16) |
             ((uint32_t)p[4 * i + 3] << 24);
    uint32_t A = a, B = b, C = c, D = d;
    for (int i = 0; i < 64; i++) {
      uint32_t f;
      int g;
      if (i < 16) {
        f = (B & C) | (~B & D);
        g = i;
      } else if (i < 32) {
        f = (D & B) | (~D & C);
        g = (5 * i + 1) & 15;
      } else if (i < 48) {
        f = B ^ C ^ D;
        g = (3 * i + 5) & 15;
      } else {
        f = C ^ (B | ~D);
        g = (7 * i) & 15;
      }
      uint32_t tmp = D;
      D = C;
      C = B;
      B = B + rol(A + f + K[i] + m[g], S[i]);
      A = tmp;
    }
    a += A;
    b += B;
    c += C;
    d += D;
  }

  void update(const uint8_t* p, size_t n) {
    len += n;
    while (n) {
      size_t take = 64 - fill < n ? 64 - fill : n;
      std::memcpy(buf + fill, p, take);
      fill += (int)take;
      p += take;
      n -= take;
      if (fill == 64) {
        block(buf);
        fill = 0;
      }
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (fill != 56) update(&z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (8 * i));
    len -= 9;  // update() bumped len for the padding; value unused now
    update(lb, 8);
    uint32_t h[4] = {a, b, c, d};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++)
        out[4 * i + j] = (uint8_t)(h[i] >> (8 * j));
  }
};

// ------------------------------------------------------------- CRC
struct Crc {
  uint8_t t8[256];
  uint16_t t16[256];
  Crc() {
    for (unsigned i = 0; i < 256; i++) {
      unsigned c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 0x80u) ? ((c << 1) ^ 0x07u) : (c << 1);
      t8[i] = (uint8_t)c;
      unsigned d = i << 8;
      for (int k = 0; k < 8; k++)
        d = (d & 0x8000u) ? ((d << 1) ^ 0x8005u) : (d << 1);
      t16[i] = (uint16_t)d;
    }
  }
};
const Crc kCrc;

// ------------------------------------------------------------- BitWriter
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nacc = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void write(uint64_t v, int nbits) {
    // nbits <= 57 per call keeps acc within 64 bits
    acc = (acc << nbits) | (v & (nbits == 64 ? ~0ull
                                             : ((1ull << nbits) - 1)));
    nacc += nbits;
    while (nacc >= 8) {
      nacc -= 8;
      out.push_back((uint8_t)(acc >> nacc));
    }
    acc &= (1ull << nacc) - 1;
  }

  void write_signed(int64_t v, int nbits) { write((uint64_t)v, nbits); }

  void unary(uint64_t n) {
    while (n >= 32) {
      write(0, 32);
      n -= 32;
    }
    write(1, (int)n + 1);
  }

  void align() {
    if (nacc) write(0, 8 - nacc);
  }
};

// --------------------------------------------------- rice planning
struct RicePlan {
  int method = 0;       // 0 = RICE (4-bit params), 1 = RICE2 (5-bit)
  int po = 0;           // partition order
  int params[64];       // per partition
  double cost = 0.0;    // residual bits
};

const int kMaxPartitionOrder = 6;

// Best partitioned rice for res[0..n) of a block of `blocksize`
// samples with `order` warm-up samples (same search space as the
// Python reference: methods x partition orders 0..6 x params 0..30).
void best_rice(const int64_t* res, int n, int blocksize, int order,
               RicePlan* plan) {
  int max_po = 0;
  while (max_po < kMaxPartitionOrder &&
         blocksize % (1 << (max_po + 1)) == 0 &&
         (blocksize >> (max_po + 1)) > order)
    max_po++;
  int nfine = 1 << max_po;
  // per-(param, partition) quotient sums at the finest order, built
  // from ONE pass per partition: S(0) = sum(u) and per-bit set counts
  // give the exact recurrence S(p) = (S(p-1) - cnt[p-1]) / 2
  // (u>>p == (u>>(p-1) - bit_{p-1}(u)) / 2, summed)
  static thread_local std::vector<double> psums;
  psums.assign((size_t)31 * nfine, 0.0);
  static thread_local std::vector<double> cnts;
  cnts.assign(nfine, 0.0);
  int idx = 0;
  for (int part = 0; part < nfine; part++) {
    int cnt = (blocksize >> max_po) - (part == 0 ? order : 0);
    cnts[part] = cnt;
    uint64_t bitcnt[64] = {0};
    uint64_t total = 0;
    for (int i = 0; i < cnt; i++) {
      int64_t v = res[idx + i];
      uint64_t u = v < 0 ? (uint64_t)(-v) * 2 - 1 : (uint64_t)v * 2;
      total += u;
      while (u) {  // popcount-many iterations per sample
        bitcnt[__builtin_ctzll(u)]++;
        u &= u - 1;
      }
    }
    double s = (double)total;
    for (int p = 0; p < 31; p++) {
      psums[(size_t)p * nfine + part] = s;
      s = (s - (double)bitcnt[p]) * 0.5;
    }
    idx += cnt;
  }
  bool have = false;
  static thread_local std::vector<double> sums;
  static thread_local std::vector<double> c2;
  sums = psums;
  c2 = cnts;
  int width = nfine;
  for (int po = max_po; po >= 0; po--) {
    for (int method = 0; method < 2; method++) {
      int pmax = method == 0 ? 15 : 31;
      int pbits = method == 0 ? 4 : 5;
      double total = 2 + 4 + (double)pbits * (1 << po);
      int pick[64];
      for (int part = 0; part < width; part++) {
        double best = 1e300;
        int bestp = 0;
        for (int p = 0; p < pmax; p++) {
          double cost = sums[(size_t)p * width + part] +
                        c2[part] * (p + 1.0);
          if (cost < best) {
            best = cost;
            bestp = p;
          }
        }
        pick[part] = bestp;
        total += best;
      }
      if (!have || total < plan->cost) {
        have = true;
        plan->method = method;
        plan->po = po;
        plan->cost = total;
        for (int part = 0; part < width; part++)
          plan->params[part] = pick[part];
      }
    }
    if (po) {  // fold partitions pairwise
      int half = width / 2;
      for (int p = 0; p < 31; p++)
        for (int part = 0; part < half; part++)
          sums[(size_t)p * half + part] =
              sums[(size_t)p * width + 2 * part] +
              sums[(size_t)p * width + 2 * part + 1];
      // rows above were compacted in place: strides changed from
      // `width` to `half`, safe because we walk parts ascending
      for (int part = 0; part < half; part++)
        c2[part] = c2[2 * part] + c2[2 * part + 1];
      width = half;
    }
  }
}

void write_residual(BitWriter& bw, const int64_t* res, int blocksize,
                    int order, const RicePlan& plan) {
  int pbits = plan.method == 0 ? 4 : 5;
  bw.write(plan.method, 2);
  bw.write(plan.po, 4);
  int idx = 0;
  for (int part = 0; part < (1 << plan.po); part++) {
    int cnt = (blocksize >> plan.po) - (part == 0 ? order : 0);
    int param = plan.params[part];
    bw.write(param, pbits);
    for (int i = 0; i < cnt; i++) {
      int64_t v = res[idx + i];
      uint64_t u = v < 0 ? (uint64_t)(-v) * 2 - 1 : (uint64_t)v * 2;
      uint64_t q = u >> param;
      int total = (int)q + 1 + param;
      if (total <= 57) {
        // whole rice code (q zeros, a 1, param low bits) in ONE write
        bw.write((1ull << param) |
                     (param ? (u & ((1ull << param) - 1)) : 0ull),
                 total);
      } else {
        bw.unary(q);
        if (param) bw.write(u, param);
      }
    }
    idx += cnt;
  }
}

// --------------------------------------------------- subframe planning
const int kLpcPrecision = 15;

struct SubframePlan {
  enum Kind { CONSTANT, VERBATIM, FIXED, LPC } kind = VERBATIM;
  const int64_t* x = nullptr;  // post-wasted-shift samples
  int bps = 0;
  int wasted = 0;
  int order = 0;
  int qcoefs[32];
  int shift = 0;
  std::vector<int64_t> res;
  RicePlan rice;
  double cost = 0.0;
};

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

// work buffers per plan call (single-threaded encoder)
void plan_subframe(const int64_t* x_in, int n, int bps_in,
                   int max_lpc_order, SubframePlan* plan,
                   std::vector<int64_t>& xbuf) {
  int head = 1 + 6 + 1;
  bool constant = n > 0;
  for (int i = 1; i < n && constant; i++)
    constant = x_in[i] == x_in[0];
  if (constant) {
    plan->kind = SubframePlan::CONSTANT;
    plan->x = x_in;
    plan->bps = bps_in;
    plan->wasted = 0;
    plan->cost = head + bps_in;
    return;
  }
  // wasted bits: common trailing zeros over the block
  uint64_t orred = 0;
  for (int i = 0; i < n; i++) orred |= (uint64_t)(x_in[i] < 0
                                                      ? -x_in[i]
                                                      : x_in[i]);
  int wasted = 0;
  if (orred)
    while (!((orred >> wasted) & 1)) wasted++;
  const int64_t* x = x_in;
  int bps = bps_in;
  if (wasted) {
    xbuf.resize(n);
    for (int i = 0; i < n; i++) xbuf[i] = x_in[i] >> wasted;
    x = xbuf.data();
    bps -= wasted;
    head += wasted;
  }
  plan->x = x;
  plan->bps = bps;
  plan->wasted = wasted;
  plan->kind = SubframePlan::VERBATIM;
  plan->cost = head + (double)n * bps;

  static thread_local std::vector<int64_t> res;
  res.resize(n);
  // FIXED orders 0..4: order-k residuals are k-th differences, so
  // build them by successive differencing and pick the order by the
  // libFLAC heuristic (min sum|res|); full rice planning runs ONCE,
  // on the winner (the exhaustive 5x search bought <0.2% size for
  // ~2x the encode time)
  {
    static thread_local std::vector<int64_t> diff;
    static thread_local std::vector<int64_t> fres;
    diff.assign(x, x + n);
    int best_order = 0;
    unsigned long long best_sum = ~0ull;
    for (int order = 0; order <= 4 && order < n; order++) {
      unsigned long long s = 0;
      for (int i = order; i < n; i++)
        s += (unsigned long long)(diff[i] < 0 ? -diff[i] : diff[i]);
      if (s < best_sum) {
        best_sum = s;
        best_order = order;
        // snapshot into fres, NOT the shared `res` scratch: the LPC
        // section below still writes res[0 .. n-order) and a shrunken
        // vector there would be indexed past size() (UB)
        fres.assign(diff.begin() + order, diff.end());
      }
      if (order < 4)  // next order's residual = first difference
        for (int i = n - 1; i > order; i--)
          diff[i] -= diff[i - 1];
    }
    RicePlan rp;
    best_rice(fres.data(), n - best_order, n, best_order, &rp);
    double cost = head + (double)best_order * bps + rp.cost;
    if (cost < plan->cost) {
      plan->kind = SubframePlan::FIXED;
      plan->order = best_order;
      plan->res = fres;
      plan->rice = rp;
      plan->cost = cost;
    }
  }
  // LPC via windowed autocorrelation + Levinson-Durbin
  if (max_lpc_order > 0 && n > max_lpc_order + 1) {
    static thread_local std::vector<double> window;
    static thread_local int window_n = -1;
    if (window_n != n) {  // cache the Hann window per blocksize
      window.resize(n);
      for (int i = 0; i < n; i++)
        window[i] = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (n - 1));
      window_n = n;
    }
    static thread_local std::vector<double> xw;
    xw.resize(n);
    for (int i = 0; i < n; i++) xw[i] = (double)x[i] * window[i];
    double ac[33];
    for (int lag = 0; lag <= max_lpc_order; lag++) {
      double s = 0.0;
      for (int i = lag; i < n; i++) s += xw[i] * xw[i - lag];
      ac[lag] = s;
    }
    if (ac[0] > 0.0) {
      double err = ac[0];
      double coefs[32];
      int m = 0;
      double best_score = 1e300;
      double best_coefs[32];
      int best_order = 0;
      while (m < max_lpc_order) {
        double acc = ac[m + 1];
        for (int j = 0; j < m; j++) acc -= coefs[j] * ac[m - j];
        double k = acc / err;
        for (int j = 0; j < m / 2; j++) {
          double t = coefs[j] - k * coefs[m - 1 - j];
          coefs[m - 1 - j] -= k * coefs[j];
          coefs[j] = t;
        }
        if (m & 1) coefs[m / 2] -= k * coefs[m / 2];
        coefs[m] = k;
        m++;
        err *= 1.0 - k * k;
        if (err <= 0.0) break;
        // expected total bits: rice bps estimate + header
        double bps_est = 0.5 * std::log2(err / n + 1e-30);
        if (bps_est < 0.0) bps_est = 0.0;
        double score = bps_est * (n - m) + (double)m * bps;
        if (score < best_score) {
          best_score = score;
          best_order = m;
          std::memcpy(best_coefs, coefs, sizeof(double) * m);
        }
      }
      if (best_order > 0) {
        // quantize with error feedback (same scheme as the Python
        // reference encoder)
        double cmax = 0.0;
        for (int j = 0; j < best_order; j++) {
          double a = std::fabs(best_coefs[j]);
          if (a > cmax) cmax = a;
        }
        if (cmax > 0.0) {
          int headroom = kLpcPrecision - 1 -
                         (int)std::floor(std::log2(cmax)) - 1;
          int shift = headroom < 0 ? 0 : (headroom > 15 ? 15
                                                        : headroom);
          int q[32];
          double ferr = 0.0;
          const int qmax = (1 << (kLpcPrecision - 1)) - 1;
          const int qmin = -(1 << (kLpcPrecision - 1));
          for (int j = 0; j < best_order; j++) {
            double v = best_coefs[j] * (double)(1 << shift) + ferr;
            long qi = std::lround(v);
            if (qi > qmax) qi = qmax;
            if (qi < qmin) qi = qmin;
            ferr = v - (double)qi;
            q[j] = (int)qi;
          }
          int order = best_order;
          for (int i = order; i < n; i++) {
            int64_t pred = 0;
            for (int j = 0; j < order; j++)
              pred += (int64_t)q[j] * x[i - 1 - j];
            res[i - order] = x[i] - (pred >> shift);
          }
          RicePlan rp;
          best_rice(res.data(), n - order, n, order, &rp);
          double cost = head + (double)order * bps + 4 + 5 +
                        (double)order * kLpcPrecision + rp.cost;
          if (cost < plan->cost) {
            plan->kind = SubframePlan::LPC;
            plan->order = order;
            std::memcpy(plan->qcoefs, q, sizeof(int) * order);
            plan->shift = shift;
            plan->res.assign(res.begin(),
                             res.begin() + (n - order));
            plan->rice = rp;
            plan->cost = cost;
          }
        }
      }
    }
  }
}

void write_subframe(BitWriter& bw, const SubframePlan& p,
                    int blocksize) {
  bw.write(0, 1);
  switch (p.kind) {
    case SubframePlan::CONSTANT:
      bw.write(0, 6);
      break;
    case SubframePlan::VERBATIM:
      bw.write(1, 6);
      break;
    case SubframePlan::FIXED:
      bw.write(8 + p.order, 6);
      break;
    case SubframePlan::LPC:
      bw.write(32 + p.order - 1, 6);
      break;
  }
  if (p.wasted) {
    bw.write(1, 1);
    bw.unary(p.wasted - 1);
  } else {
    bw.write(0, 1);
  }
  if (p.kind == SubframePlan::CONSTANT) {
    bw.write_signed(p.x[0], p.bps);
    return;
  }
  if (p.kind == SubframePlan::VERBATIM) {
    for (int i = 0; i < blocksize; i++) bw.write_signed(p.x[i], p.bps);
    return;
  }
  for (int i = 0; i < p.order; i++) bw.write_signed(p.x[i], p.bps);
  if (p.kind == SubframePlan::LPC) {
    bw.write(kLpcPrecision - 1, 4);
    bw.write(p.shift, 5);
    for (int j = 0; j < p.order; j++)
      bw.write_signed(p.qcoefs[j], kLpcPrecision);
  }
  write_residual(bw, p.res.data(), blocksize, p.order, p.rice);
}

void utf8_number(std::vector<uint8_t>& out, uint64_t n) {
  if (n < 0x80) {
    out.push_back((uint8_t)n);
    return;
  }
  int nbytes = 1;
  while (nbytes < 6 && n >= (1ull << ((6 - nbytes) + 6 * nbytes)))
    nbytes++;
  out.push_back((uint8_t)(((0xFF << (7 - nbytes)) & 0xFF) |
                          (n >> (6 * nbytes))));
  for (int k = nbytes - 1; k >= 0; k--)
    out.push_back((uint8_t)(0x80 | ((n >> (6 * k)) & 0x3F)));
}

const int kSsCodes[33] = {
    // index by bits; -1 where no code exists
    -1, -1, -1, -1, -1, -1, -1, -1, 1,  -1, -1, -1, 2,  -1, -1, -1, 4,
    -1, -1, -1, 5,  -1, -1, -1, 6,  -1, -1, -1, -1, -1, -1, -1, 7};

}  // namespace

extern "C" {

// Encode interleaved int32 samples (raw codes at `bits` depth) into
// `out` (capacity `cap` bytes).  Returns bytes written, or <0:
// -1 bad args, -2 capacity too small.
long long an_flac_encode(const int32_t* samples, long long frames,
                         int channels, int rate, int bits,
                         int blocksize, int max_lpc_order, uint8_t* out,
                         long long cap) {
  if (channels < 1 || channels > 8 || bits < 4 || bits > 32 ||
      kSsCodes[bits] < 0 || blocksize < 16 || blocksize > 32768)
    return -1;
  std::vector<uint8_t> buf;
  buf.reserve((size_t)(frames * channels * (bits / 8 + 1) / 2 + 4096));
  // --- stream header
  const char* magic = "fLaC";
  buf.insert(buf.end(), magic, magic + 4);
  {
    BitWriter si(buf);
    // STREAMINFO; a SEEKTABLE follows whenever there are frames
    si.write(frames > 0 ? 0x00 : 0x80, 8);
    si.write(34, 24);
    si.write(blocksize, 16);
    si.write(blocksize, 16);
    si.write(0, 24);
    si.write(0, 24);
    si.write(rate, 20);
    si.write(channels - 1, 3);
    si.write(bits - 1, 5);
    si.write((uint64_t)frames, 36);
    si.align();
  }
  // MD5 of the little-endian raw samples at ceil(bits/8) bytes
  {
    Md5 md5;
    int width = (bits + 7) / 8;
    std::vector<uint8_t> tmp((size_t)4096 * channels * width);
    long long pos = 0;
    while (pos < frames) {
      long long n = frames - pos < 4096 ? frames - pos : 4096;
      size_t k = 0;
      for (long long i = 0; i < n; i++)
        for (int c = 0; c < channels; c++) {
          int32_t v = samples[(pos + i) * channels + c];
          for (int byte = 0; byte < width; byte++)
            tmp[k++] = (uint8_t)(v >> (8 * byte));
        }
      md5.update(tmp.data(), k);
      pos += n;
    }
    uint8_t digest[16];
    md5.final(digest);
    buf.insert(buf.end(), digest, digest + 16);
  }
  // --- SEEKTABLE: one point every ~10 s snapped to the frame grid,
  // capped at 4096 points; placeholder records (sample = all-ones)
  // patched in place as frames are written
  long long span = 0, npts = 0;
  size_t st_base = 0;
  if (frames > 0) {
    span = (long long)(10.0 * rate + 0.5);
    if (span < blocksize) span = blocksize;
    span = (span + blocksize - 1) / blocksize * blocksize;
    npts = (frames + span - 1) / span;
    if (npts > 4096) {
      span = ((frames + 4095) / 4096 + blocksize - 1) / blocksize *
             (long long)blocksize;
      npts = (frames + span - 1) / span;
    }
    uint32_t stsz = (uint32_t)(18 * npts);
    buf.push_back(0x80 | 3);  // last metadata block, SEEKTABLE
    buf.push_back((uint8_t)(stsz >> 16));
    buf.push_back((uint8_t)(stsz >> 8));
    buf.push_back((uint8_t)stsz);
    st_base = buf.size();
    for (long long i = 0; i < npts; i++) {
      for (int b = 0; b < 8; b++) buf.push_back(0xFF);
      for (int b = 0; b < 10; b++) buf.push_back(0x00);
    }
  }
  const size_t audio_start = buf.size();
  // --- frames
  int ss_code = kSsCodes[bits];
  int bs_code;
  switch (blocksize) {
    case 256: bs_code = 8; break;
    case 512: bs_code = 9; break;
    case 1024: bs_code = 10; break;
    case 2048: bs_code = 11; break;
    case 4096: bs_code = 12; break;
    case 8192: bs_code = 13; break;
    case 16384: bs_code = 14; break;
    case 32768: bs_code = 15; break;
    default: bs_code = 7; break;  // 16-bit blocksize-1 at header end
  }
  std::vector<int64_t> ch0, ch1, side, mid, xbuf0, xbuf1;
  uint64_t fnum = 0;
  for (long long pos = 0; pos < frames; pos += blocksize, fnum++) {
    int bs = (int)(frames - pos < blocksize ? frames - pos : blocksize);
    bool full = bs == blocksize && bs_code != 7;
    // deinterleave
    ch0.resize(bs);
    if (channels == 2) {
      ch1.resize(bs);
      side.resize(bs);
      mid.resize(bs);
      for (int i = 0; i < bs; i++) {
        int64_t l = samples[(pos + i) * 2];
        int64_t r = samples[(pos + i) * 2 + 1];
        ch0[i] = l;
        ch1[i] = r;
        side[i] = l - r;
        mid[i] = (l + r) >> 1;
      }
    }
    // plan subframes
    SubframePlan plans[8];
    const SubframePlan* chosen[8];
    int ca;
    if (channels == 2) {
      // stereo mode from cheap estimates (libFLAC's approach): the
      // expected rice bits of each candidate channel follow from its
      // order-2 fixed-residual mean magnitude; only the winning
      // combo's TWO subframes get full planning (~2x faster than
      // planning all four, sub-0.1% size cost on the bench corpus)
      auto est_bits = [bs](const int64_t* v) {
        unsigned long long s = 0;
        for (int i = 2; i < bs; i++) {
          int64_t r = v[i] - 2 * v[i - 1] + v[i - 2];
          s += (unsigned long long)(r < 0 ? -r : r);
        }
        if (s == 0)  // constant channel: a CONSTANT subframe, ~free
          return 64.0;
        double mean = bs > 2 ? (double)s / (bs - 2) : 0.0;
        return (double)bs * (mean > 0.1 ? std::log2(mean) + 1.6 : 1.0);
      };
      double el = est_bits(ch0.data());
      double er = est_bits(ch1.data());
      double es = est_bits(side.data());
      double em = est_bits(mid.data());
      double ci = el + er, cls = el + es, csr = es + er, cms = em + es;
      const int64_t* src0;
      const int64_t* src1;
      int bps1 = bits + 1;
      if (ci <= cls && ci <= csr && ci <= cms) {
        ca = 1;
        src0 = ch0.data();
        src1 = ch1.data();
        bps1 = bits;
      } else if (cls <= csr && cls <= cms) {
        ca = 8;
        src0 = ch0.data();
        src1 = side.data();
      } else if (csr <= cms) {
        ca = 9;
        src0 = side.data();
        src1 = ch1.data();
        // side first: bps order swaps below
      } else {
        ca = 10;
        src0 = mid.data();
        src1 = side.data();
      }
      int bps0 = bits + (ca == 9 ? 1 : 0);
      if (ca == 9) bps1 = bits;
      plan_subframe(src0, bs, bps0, max_lpc_order, &plans[0], xbuf0);
      plan_subframe(src1, bs, bps1, max_lpc_order, &plans[1], xbuf1);
      chosen[0] = &plans[0];
      chosen[1] = &plans[1];
    } else {
      ca = channels - 1;
      static thread_local std::vector<int64_t> tmp;
      for (int c = 0; c < channels; c++) {
        ch0.resize(bs);
        for (int i = 0; i < bs; i++)
          ch0[i] = samples[(pos + i) * channels + c];
        plan_subframe(ch0.data(), bs, bits, max_lpc_order, &plans[c],
                      xbuf0);
        // plan keeps pointers into ch0/xbuf0 which we overwrite next
        // channel: materialize the (possibly shifted) samples now
        tmp.assign(plans[c].x, plans[c].x + bs);
        plans[c].res.shrink_to_fit();
        xbuf1.insert(xbuf1.end(), tmp.begin(), tmp.end());
        chosen[c] = &plans[c];
      }
      // re-point each plan at its materialized samples
      for (int c = 0; c < channels; c++)
        plans[c].x = xbuf1.data() + (size_t)c * bs;
    }
    if (npts && pos % span == 0 && pos / span < npts) {
      size_t k = st_base + 18 * (size_t)(pos / span);
      uint64_t sample = (uint64_t)pos;
      uint64_t off = (uint64_t)(buf.size() - audio_start);
      for (int b = 0; b < 8; b++)
        buf[k + b] = (uint8_t)(sample >> (8 * (7 - b)));
      for (int b = 0; b < 8; b++)
        buf[k + 8 + b] = (uint8_t)(off >> (8 * (7 - b)));
      buf[k + 16] = (uint8_t)(bs >> 8);
      buf[k + 17] = (uint8_t)bs;
    }
    // frame header
    size_t frame_start = buf.size();
    {
      BitWriter hw(buf);
      hw.write(0x3FFE, 14);
      hw.write(0, 1);
      hw.write(0, 1);  // fixed blocking
      hw.write(full ? bs_code : 7, 4);
      hw.write(0, 4);  // rate from STREAMINFO
      hw.write(ca, 4);
      hw.write(ss_code, 3);
      hw.write(0, 1);
      std::vector<uint8_t> nb;
      utf8_number(nb, fnum);
      for (uint8_t b : nb) hw.write(b, 8);
      if (!full) hw.write(bs - 1, 16);
      hw.align();
    }
    uint8_t crc8 = 0;
    for (size_t i = frame_start; i < buf.size(); i++)
      crc8 = kCrc.t8[crc8 ^ buf[i]];
    buf.push_back(crc8);
    {
      BitWriter bw(buf);
      for (int c = 0; c < channels; c++)
        write_subframe(bw, *chosen[c], bs);
      bw.align();
    }
    uint16_t crc16 = 0;
    for (size_t i = frame_start; i < buf.size(); i++)
      crc16 = (uint16_t)(kCrc.t16[((crc16 >> 8) ^ buf[i]) & 0xFF] ^
                         (crc16 << 8));
    buf.push_back((uint8_t)(crc16 >> 8));
    buf.push_back((uint8_t)crc16);
    if (channels != 2) xbuf1.clear();
  }
  if ((long long)buf.size() > cap) return -2;
  std::memcpy(out, buf.data(), buf.size());
  return (long long)buf.size();
}

}  // extern "C"
