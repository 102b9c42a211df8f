// Native FLAC frame decoder — the hot loop behind audian_torch.data.flac.
//
// The Python module owns stream parsing, the CRC-validated frame index,
// and the random-access logic; this file decodes ONE frame (bit-level
// Rice/LPC work, ~100x the pure-Python throughput).  The Python decoder
// remains the correctness reference and the fallback when no compiler is
// available; both implement the same subset (CONSTANT / VERBATIM /
// FIXED 0-4 / LPC 1-32 subframes, RICE + RICE2 residuals with partitions
// and escape codes, wasted bits, all stereo decorrelations).

#include <cstdint>
#include <cstring>

namespace {

// 64-bit cached MSB-first bit reader: bits are staged left-aligned in
// `cache` (bit 63 = next bit), refilled a byte at a time up to 57+
// valid bits, so read() is two shifts and read_unary() is one CLZ in
// the common case — the decoder's whole hot path goes through these.
struct BitReader {
    const uint8_t* buf;
    int64_t len;
    int64_t next;    // next byte to stage into the cache
    uint64_t cache;  // left-aligned pending bits (invalid bits are 0)
    int ncache;      // valid bit count (from the top)
    bool bad;

    BitReader(const uint8_t* b, int64_t l, int64_t p)
        : buf(b), len(l), next(p), cache(0), ncache(0), bad(false) {}

    inline void refill() {
        while (ncache <= 56 && next < len) {
            cache |= (uint64_t)buf[next++] << (56 - ncache);
            ncache += 8;
        }
    }

    // nbits in [0, 57]
    inline uint64_t read(int nbits) {
        if (nbits == 0) return 0;
        if (ncache < nbits) {
            refill();
            if (ncache < nbits) { bad = true; return 0; }
        }
        uint64_t v = cache >> (64 - nbits);
        cache <<= nbits;
        ncache -= nbits;
        return v;
    }

    inline int64_t read_signed(int nbits) {
        uint64_t v = read(nbits);
        if (nbits > 0 && (v >> (nbits - 1)))
            return (int64_t)v - ((int64_t)1 << nbits);
        return (int64_t)v;
    }

    inline int64_t read_unary() {
        int64_t n = 0;
        for (;;) {
            refill();
            if (ncache == 0) { bad = true; return 0; }
            if (cache == 0) {  // every valid bit is zero: keep going
                n += ncache;
                ncache = 0;
                continue;
            }
            int lead = __builtin_clzll(cache);
            n += lead;
            int take = lead + 1;  // take == 64 (lone lowest bit set)
            cache = take >= 64 ? 0 : cache << take;  // would be UB
            ncache -= take;
            return n;
        }
    }

    // one Rice code (unary quotient + `param` remainder bits), zigzag
    // de-mapped.  Fast path: the whole code sits in the refilled cache
    // (unary runs longer than ~50 bits are vanishingly rare and take
    // the generic path).
    inline int64_t read_rice(int param) {
        refill();
        if (cache != 0) {
            int q = __builtin_clzll(cache);
            int need = q + 1 + param;
            // need < 64 keeps every shift below well-defined
            if (need <= ncache && need < 64) {
                uint64_t rem =
                    param ? (cache << (q + 1)) >> (64 - param) : 0;
                uint64_t u = ((uint64_t)q << param) | rem;
                cache <<= need;
                ncache -= need;
                return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
            }
        }
        uint64_t q = (uint64_t)read_unary();
        uint64_t u = (q << param) | read(param);
        return (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
    }

    inline void align() {
        int d = ncache & 7;
        cache <<= d;
        ncache -= d;
    }

    inline bool aligned() const { return (ncache & 7) == 0; }

    // byte position of the read cursor; only meaningful when aligned()
    inline int64_t bytepos() const { return next - (ncache >> 3); }
};

const int kBlocksizeCodes[16] = {0,    192,  576,   1152,  2304, 4608,
                                 -8,   -16,  256,   512,   1024, 2048,
                                 4096, 8192, 16384, 32768};
const int kSizeCodes[8] = {0, 8, 12, -1, 16, 20, 24, 32};

// CRC-16 (poly 0x8005, init 0, MSB-first) over the whole frame: bit
// corruption inside a payload must fail loudly (return -1 → the caller
// surfaces a FlacError), matching the libsndfile error contract.
// Slicing-by-8: t[k][b] is the CRC of byte b followed by k zero bytes,
// so eight bytes fold in one step with a two-byte state injection.
struct Crc16Table {
    uint16_t t[8][256];
    Crc16Table() {
        for (unsigned i = 0; i < 256; i++) {
            unsigned c = i << 8;
            for (int k = 0; k < 8; k++)
                c = (c & 0x8000u) ? ((c << 1) ^ 0x8005u) : (c << 1);
            t[0][i] = (uint16_t)c;
        }
        for (int k = 1; k < 8; k++)
            for (unsigned i = 0; i < 256; i++)
                t[k][i] = (uint16_t)((t[k - 1][i] << 8) ^
                                     t[0][t[k - 1][i] >> 8]);
    }
};
const Crc16Table kCrc16;

uint16_t crc16(const uint8_t* p, int64_t n) {
    const auto& t = kCrc16.t;
    uint16_t c = 0;
    while (n >= 8) {
        c = (uint16_t)(t[7][p[0] ^ (c >> 8)] ^ t[6][p[1] ^ (c & 0xFF)] ^
                       t[5][p[2]] ^ t[4][p[3]] ^ t[3][p[4]] ^
                       t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]]);
        p += 8;
        n -= 8;
    }
    for (; n; n--, p++)
        c = (uint16_t)(t[0][((c >> 8) ^ *p) & 0xFF] ^ (c << 8));
    return c;
}

bool decode_residual(BitReader& br, int blocksize, int order,
                     int64_t* res) {
    int method = (int)br.read(2);
    if (method > 1) return false;
    int pbits = method == 0 ? 4 : 5;
    unsigned escape = (1u << pbits) - 1u;
    int po = (int)br.read(4);
    int npart = 1 << po;
    if (blocksize % npart || (blocksize >> po) < order) return false;
    int64_t idx = 0;
    for (int p = 0; p < npart; p++) {
        int n = (blocksize >> po) - (p == 0 ? order : 0);
        unsigned param = (unsigned)br.read(pbits);
        if (param == escape) {
            int raw = (int)br.read(5);
            for (int i = 0; i < n; i++)
                res[idx + i] = raw ? br.read_signed(raw) : 0;
        } else {
            for (int i = 0; i < n; i++)
                res[idx + i] = br.read_rice((int)param);
        }
        idx += n;
        if (br.bad) return false;
    }
    return true;
}

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

// LPC restore with a compile-time order: the fully unrolled inner loop
// is the decoder's hottest spot (gprof: ~60% of decode in the generic
// runtime-order loop this replaces).  Accumulation is uint64 so a
// corrupt adversarial stream that overflows before the CRC-16 gate
// rejects the frame wraps (defined) instead of signed-overflowing (UB);
// two's-complement wrap preserves the in-range results bit-for-bit.
template <int ORDER>
void lpc_restore(const int64_t* coefs, int shift, const int64_t* res,
                 int64_t* x, int blocksize) {
    for (int i = ORDER; i < blocksize; i++) {
        uint64_t acc = 0;
        for (int j = 0; j < ORDER; j++)
            acc += (uint64_t)coefs[j] * (uint64_t)x[i - 1 - j];
        x[i] = (int64_t)(((uint64_t)((int64_t)acc >> shift)) +
                         (uint64_t)res[i - ORDER]);
    }
}

void lpc_restore_generic(const int64_t* coefs, int shift, int order,
                         const int64_t* res, int64_t* x, int blocksize) {
    for (int i = order; i < blocksize; i++) {
        uint64_t acc = 0;
        for (int j = 0; j < order; j++)
            acc += (uint64_t)coefs[j] * (uint64_t)x[i - 1 - j];
        x[i] = (int64_t)(((uint64_t)((int64_t)acc >> shift)) +
                         (uint64_t)res[i - order]);
    }
}

using LpcFn = void (*)(const int64_t*, int, const int64_t*, int64_t*,
                       int);
const LpcFn kLpcFns[17] = {
    nullptr,          lpc_restore<1>,  lpc_restore<2>,  lpc_restore<3>,
    lpc_restore<4>,   lpc_restore<5>,  lpc_restore<6>,  lpc_restore<7>,
    lpc_restore<8>,   lpc_restore<9>,  lpc_restore<10>, lpc_restore<11>,
    lpc_restore<12>,  lpc_restore<13>, lpc_restore<14>, lpc_restore<15>,
    lpc_restore<16>};

bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* x,
                     int64_t* scratch) {
    if (br.read(1) != 0) return false;
    int stype = (int)br.read(6);
    int wasted = 0;
    if (br.read(1)) wasted = (int)br.read_unary() + 1;
    bps -= wasted;
    if (bps <= 0 || bps > 33) return false;
    if (stype == 0) {  // CONSTANT
        int64_t v = br.read_signed(bps);
        for (int i = 0; i < blocksize; i++) x[i] = v;
    } else if (stype == 1) {  // VERBATIM
        for (int i = 0; i < blocksize; i++) x[i] = br.read_signed(bps);
    } else if (stype >= 8 && stype <= 12) {  // FIXED
        int order = stype - 8;
        if (order > blocksize) return false;  // before any warmup write
        for (int i = 0; i < order; i++) x[i] = br.read_signed(bps);
        if (!decode_residual(br, blocksize, order, scratch)) return false;
        const int64_t* r = scratch;
        // uint64 arithmetic: corrupt pre-CRC streams wrap instead of
        // signed-overflowing (UB); wrap matches in-range results
        auto u = [](int64_t v) { return (uint64_t)v; };
        switch (order) {  // constant-coefficient recurrences, unrolled
        case 0:
            for (int i = 0; i < blocksize; i++) x[i] = r[i];
            break;
        case 1:
            for (int i = 1; i < blocksize; i++)
                x[i] = (int64_t)(u(r[i - 1]) + u(x[i - 1]));
            break;
        case 2:
            for (int i = 2; i < blocksize; i++)
                x[i] = (int64_t)(u(r[i - 2]) + 2 * u(x[i - 1]) -
                                 u(x[i - 2]));
            break;
        case 3:
            for (int i = 3; i < blocksize; i++)
                x[i] = (int64_t)(u(r[i - 3]) + 3 * u(x[i - 1]) -
                                 3 * u(x[i - 2]) + u(x[i - 3]));
            break;
        default:
            for (int i = 4; i < blocksize; i++)
                x[i] = (int64_t)(u(r[i - 4]) + 4 * u(x[i - 1]) -
                                 6 * u(x[i - 2]) + 4 * u(x[i - 3]) -
                                 u(x[i - 4]));
            break;
        }
    } else if (stype >= 32) {  // LPC
        int order = (stype & 31) + 1;
        if (order > blocksize) return false;  // before any warmup write
        for (int i = 0; i < order; i++) x[i] = br.read_signed(bps);
        int precision = (int)br.read(4);
        if (precision == 15) return false;
        precision += 1;
        int shift = (int)br.read_signed(5);
        if (shift < 0) return false;
        int64_t coefs[32];
        for (int j = 0; j < order; j++)
            coefs[j] = br.read_signed(precision);
        if (!decode_residual(br, blocksize, order, scratch)) return false;
        if (order <= 16)
            kLpcFns[order](coefs, shift, scratch, x, blocksize);
        else
            lpc_restore_generic(coefs, shift, order, scratch, x,
                                blocksize);
    } else {
        return false;
    }
    if (br.bad) return false;
    if (wasted)  // unsigned shift: negative-value << is UB pre-C++20
        for (int i = 0; i < blocksize; i++)
            x[i] = (int64_t)((uint64_t)x[i] << wasted);
    return true;
}

}  // namespace

extern "C" {

// Decode one frame whose (already CRC-validated) header starts at byte
// `pos`.  `out` receives interleaved int32 samples (blocksize*channels);
// `work` is caller-provided scratch of 3*max_blocksize int64.  When
// `meta` is non-null it receives {first-sample position, end byte
// offset past the frame CRC-16} — the lazy bisection index follows
// frame chains through these.  Returns the blocksize, or -1 on any
// parse error (caller falls back to the Python reference decoder).
int64_t an_flac_decode_frame(const uint8_t* buf, int64_t len, int64_t pos,
                             int rate, int channels, int bits,
                             int min_blocksize, int max_blocksize,
                             int32_t* out, int64_t* work, int64_t* meta) {
    BitReader br(buf, len, pos);
    if (br.read(14) != 0x3FFE || br.read(1) != 0) return -1;
    int variable = (int)br.read(1);  // blocking strategy
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int ca = (int)br.read(4);
    int ss_code = (int)br.read(3);
    if (br.read(1) != 0 || bs_code == 0 || ca > 10 || ss_code == 3)
        return -1;
    // UTF-8-style coded frame/sample number
    uint64_t num;
    unsigned first = (unsigned)br.read(8);
    if (first < 0x80u) {
        num = first;
    } else {
        int nbytes = 0;
        unsigned probe = first;
        while (probe & 0x40u) { nbytes++; probe <<= 1; }
        if (!(probe & 0x80u) || nbytes < 1 || nbytes > 6) return -1;
        num = first & (0x3Fu >> nbytes);
        for (int i = 0; i < nbytes; i++) {
            unsigned cont = (unsigned)br.read(8);
            if ((cont & 0xC0u) != 0x80u) return -1;
            num = (num << 6) | (cont & 0x3Fu);
        }
    }
    int blocksize;
    if (bs_code == 6) blocksize = (int)br.read(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
    else blocksize = kBlocksizeCodes[bs_code];
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    else if (sr_code == 15) return -1;
    int fbits = ss_code == 0 ? bits : kSizeCodes[ss_code];
    if (fbits <= 0) return -1;
    if (!br.aligned()) return -1;  // header must end byte-aligned
    br.read(8);                    // CRC-8 (validated by the indexer)
    if (blocksize <= 0 || blocksize > max_blocksize) return -1;
    // a fixed-strategy frame positions itself as num * max_blocksize,
    // which only holds when STREAMINFO says the stream IS fixed
    // blocksize (min == max); reject nonconforming streams loudly
    // instead of letting the lazy index silently mis-seek (the Python
    // _parse_frame_header applies the same rejection)
    if (!variable && min_blocksize != max_blocksize) return -1;
    int nch = ca < 8 ? ca + 1 : 2;
    if (nch != channels) return -1;

    int64_t* ch0 = work;
    int64_t* ch1 = work + max_blocksize;
    int64_t* scratch = work + 2 * (int64_t)max_blocksize;
    if (ca < 8) {  // independent channels: decode + interleave in turn
        for (int c = 0; c < nch; c++) {
            if (!decode_subframe(br, blocksize, fbits, ch0, scratch))
                return -1;
            for (int i = 0; i < blocksize; i++)
                out[(int64_t)i * channels + c] = (int32_t)ch0[i];
        }
        br.align();
        int64_t endp = br.bytepos();
        if (endp + 2 > len ||
            crc16(buf + pos, endp - pos) !=
                (((uint16_t)buf[endp] << 8) | buf[endp + 1]))
            return -1;
        if (meta) {
            meta[0] = variable ? (int64_t)num
                               : (int64_t)num * max_blocksize;
            meta[1] = endp + 2;
        }
        return blocksize;
    }
    // stereo decorrelation: side channel carries one extra bit
    int bps0 = fbits + (ca == 9 ? 1 : 0);
    int bps1 = fbits + (ca == 8 || ca == 10 ? 1 : 0);
    if (!decode_subframe(br, blocksize, bps0, ch0, scratch)) return -1;
    if (!decode_subframe(br, blocksize, bps1, ch1, scratch)) return -1;
    br.align();
    int64_t endp = br.bytepos();
    if (endp + 2 > len ||
        crc16(buf + pos, endp - pos) !=
            (((uint16_t)buf[endp] << 8) | buf[endp + 1]))
        return -1;
    for (int i = 0; i < blocksize; i++) {
        int64_t l, r;
        if (ca == 8) {        // left/side
            l = ch0[i];
            r = ch0[i] - ch1[i];
        } else if (ca == 9) { // side/right
            r = ch1[i];
            l = ch0[i] + ch1[i];
        } else {              // mid/side
            int64_t m = (int64_t)(((uint64_t)ch0[i] << 1) |
                                  ((uint64_t)ch1[i] & 1));
            l = (m + ch1[i]) >> 1;
            r = (m - ch1[i]) >> 1;
        }
        out[(int64_t)i * 2] = (int32_t)l;
        out[(int64_t)i * 2 + 1] = (int32_t)r;
    }
    if (meta) {
        meta[0] = variable ? (int64_t)num : (int64_t)num * max_blocksize;
        meta[1] = endp + 2;
    }
    return blocksize;
}

}  // extern "C"
