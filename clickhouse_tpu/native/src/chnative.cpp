// Native runtime components for clickhouse_tpu.
//
// The host-side hot loops the reference implements in C++ and we keep native
// too (the device compute path is JAX/XLA/Pallas; these are the IO/runtime
// pieces around it):
//   * LZ4 block codec        — reference: src/Compression/CompressionCodecLZ4
//                              (via contrib/lz4); self-contained spec-
//                              compliant implementation here, no third-party
//                              code.
//   * Native-format string column (varint length + bytes per row) encode/
//     decode — reference: src/DataTypes/Serializations/SerializationString
//   * splitmix64 column hasher for host-side shard routing — mirrors
//     clickhouse_tpu/ops/hash_ops.py so host and device route identically.
//
// Exposed with a C ABI for ctypes.  Build: `python -m clickhouse_tpu.native.build`.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- LZ4 block

// Decompress an LZ4 *block* (raw, no frame) into dst (exactly dst_len bytes
// expected).  Returns bytes written, or -1 on malformed input.
int chn_lz4_decompress(const uint8_t* src, int src_len,
                       uint8_t* dst, int dst_len) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_len;

    if (src_len < 0 || dst_len < 0) return -1;
    while (ip < iend) {
        const uint8_t token = *ip++;
        // literals (64-bit lengths, compared against *remaining* bytes —
        // never via `ptr + len` arithmetic, which can wrap)
        uint64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
                if (lit > static_cast<uint64_t>(dst_len)) return -1;
            } while (b == 255);
        }
        if (lit > static_cast<uint64_t>(iend - ip) ||
            lit > static_cast<uint64_t>(oend - op)) return -1;
        std::memcpy(op, ip, static_cast<size_t>(lit));
        ip += lit;
        op += lit;
        if (ip >= iend) break;          // last sequence: literals only

        // match
        if (iend - ip < 2) return -1;
        const int offset = ip[0] | (ip[1] << 8);
        ip += 2;
        if (offset == 0 || op - dst < offset) return -1;
        uint64_t mlen = (token & 15) + 4;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
                if (mlen > static_cast<uint64_t>(dst_len)) return -1;
            } while (b == 255);
        }
        if (mlen > static_cast<uint64_t>(oend - op)) return -1;
        const uint8_t* match = op - offset;
        // overlapping copy must run forward byte-wise
        for (uint64_t i = 0; i < mlen; ++i) op[i] = match[i];
        op += mlen;
    }
    return static_cast<int>(op - dst);
}

static inline uint32_t chn_read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t chn_hash4(uint32_t v) {
    return (v * 2654435761u) >> 20;   // 12-bit table
}

// Compress src into dst (LZ4 block format).  Returns compressed size, or -1
// if dst_cap is too small.  Greedy single-pass hash-chain matcher.
int chn_lz4_compress(const uint8_t* src, int src_len,
                     uint8_t* dst, int dst_cap) {
    const int HASH_SIZE = 1 << 12;
    int table[HASH_SIZE];
    for (int i = 0; i < HASH_SIZE; ++i) table[i] = -1;

    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    const uint8_t* const mflimit = iend - 12;  // LZ4 end-of-block rules
    const uint8_t* anchor = src;
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;

    auto emit = [&](const uint8_t* lit_start, int lit_len,
                    int offset, int match_len) -> bool {
        uint8_t* token = op;
        if (op + 1 > oend) return false;
        ++op;
        // literal length
        if (lit_len >= 15) {
            *token = 15 << 4;
            int rest = lit_len - 15;
            while (rest >= 255) {
                if (op >= oend) return false;
                *op++ = 255;
                rest -= 255;
            }
            if (op >= oend) return false;
            *op++ = static_cast<uint8_t>(rest);
        } else {
            *token = static_cast<uint8_t>(lit_len << 4);
        }
        if (op + lit_len > oend) return false;
        std::memcpy(op, lit_start, lit_len);
        op += lit_len;
        if (match_len == 0) return true;   // final literals
        if (op + 2 > oend) return false;
        *op++ = static_cast<uint8_t>(offset & 0xFF);
        *op++ = static_cast<uint8_t>(offset >> 8);
        int m = match_len - 4;
        if (m >= 15) {
            *token |= 15;
            m -= 15;
            while (m >= 255) {
                if (op >= oend) return false;
                *op++ = 255;
                m -= 255;
            }
            if (op >= oend) return false;
            *op++ = static_cast<uint8_t>(m);
        } else {
            *token |= static_cast<uint8_t>(m);
        }
        return true;
    };

    if (src_len >= 13) {
        while (ip < mflimit) {
            const uint32_t h = chn_hash4(chn_read32(ip));
            const int cand = table[h];
            table[h] = static_cast<int>(ip - src);
            if (cand >= 0 && ip - src - cand <= 65535 &&
                chn_read32(src + cand) == chn_read32(ip)) {
                // extend match
                const uint8_t* m = src + cand;
                const uint8_t* p = ip + 4;
                const uint8_t* q = m + 4;
                // matches must end 5 bytes before block end
                const uint8_t* const matchlimit = iend - 5;
                while (p < matchlimit && *p == *q) { ++p; ++q; }
                const int match_len = static_cast<int>(p - ip);
                const int lit_len = static_cast<int>(ip - anchor);
                if (!emit(anchor, lit_len,
                          static_cast<int>(ip - m), match_len))
                    return -1;
                ip += match_len;
                anchor = ip;
            } else {
                ++ip;
            }
        }
    }
    // trailing literals
    const int lit_len = static_cast<int>(iend - anchor);
    if (!emit(anchor, lit_len, 0, 0)) return -1;
    return static_cast<int>(op - dst);
}

// ------------------------------------------------- Native string column IO

// Encode n strings (concatenated blob + n+1 offsets) as varint-length rows.
// Returns bytes written or -1 if dst_cap too small.
long long chn_write_strcol(const uint8_t* blob, const long long* offsets,
                           long long n, uint8_t* dst, long long dst_cap) {
    uint8_t* op = dst;
    uint8_t* const oend = dst + dst_cap;
    for (long long i = 0; i < n; ++i) {
        unsigned long long len =
            static_cast<unsigned long long>(offsets[i + 1] - offsets[i]);
        unsigned long long x = len;
        do {
            if (op >= oend) return -1;
            uint8_t b = x & 0x7F;
            x >>= 7;
            *op++ = x ? (b | 0x80) : b;
        } while (x);
        if (op + len > oend) return -1;
        std::memcpy(op, blob + offsets[i], len);
        op += len;
    }
    return op - dst;
}

// Decode n varint-framed strings; fills offsets (n+1) and blob (blob_cap).
// Returns bytes consumed from src, or -1 on overflow/malformed.
long long chn_read_strcol(const uint8_t* src, long long src_len, long long n,
                          long long* offsets, uint8_t* blob,
                          long long blob_cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + src_len;
    long long pos = 0;
    offsets[0] = 0;
    for (long long i = 0; i < n; ++i) {
        unsigned long long len = 0;
        int shift = 0;
        while (true) {
            if (ip >= iend) return -1;
            uint8_t b = *ip++;
            len |= static_cast<unsigned long long>(b & 0x7F) << shift;
            if (!(b & 0x80)) break;
            shift += 7;
            if (shift > 63) return -1;
        }
        // compare against remaining bytes — `ip + len` can wrap for huge
        // varint lengths, defeating the bounds check (OOB read + SIGSEGV)
        if (len > static_cast<unsigned long long>(iend - ip) ||
            pos > blob_cap ||
            len > static_cast<unsigned long long>(blob_cap - pos))
            return -1;
        std::memcpy(blob + pos, ip, len);
        ip += len;
        pos += static_cast<long long>(len);
        offsets[i + 1] = pos;
    }
    return ip - src;
}

// ------------------------------------------------------- splitmix64 hasher

void chn_hash64(const uint64_t* src, long long n, uint64_t* dst) {
    for (long long i = 0; i < n; ++i) {
        uint64_t z = src[i] + 0x9E3779B97F4A7C15ull;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        dst[i] = z ^ (z >> 31);
    }
}


// ----------------------------------------------------------- codec family
// Self-designed engine formats covering the reference codec set
// (src/Compression/CompressionCodecDelta.cpp, ...DoubleDelta.cpp,
// ...Gorilla.cpp, ...T64.cpp).  Formats are byte-exact round-trip codecs,
// not the reference's wire formats.

// ---- Delta: out[i] = in[i] - in[i-1] over fixed-width elements ----------

void chn_delta_encode(const uint8_t* src, long long n, int width,
                      uint8_t* dst) {
    if (width == 8) {
        const uint64_t* s = (const uint64_t*)src; uint64_t* d = (uint64_t*)dst;
        uint64_t prev = 0;
        for (long long i = 0; i < n; ++i) { d[i] = s[i] - prev; prev = s[i]; }
    } else if (width == 4) {
        const uint32_t* s = (const uint32_t*)src; uint32_t* d = (uint32_t*)dst;
        uint32_t prev = 0;
        for (long long i = 0; i < n; ++i) { d[i] = s[i] - prev; prev = s[i]; }
    } else if (width == 2) {
        const uint16_t* s = (const uint16_t*)src; uint16_t* d = (uint16_t*)dst;
        uint16_t prev = 0;
        for (long long i = 0; i < n; ++i) { d[i] = (uint16_t)(s[i] - prev); prev = s[i]; }
    } else {
        uint8_t prev = 0;
        for (long long i = 0; i < n; ++i) { dst[i] = (uint8_t)(src[i] - prev); prev = src[i]; }
    }
}

void chn_delta_decode(const uint8_t* src, long long n, int width,
                      uint8_t* dst) {
    if (width == 8) {
        const uint64_t* s = (const uint64_t*)src; uint64_t* d = (uint64_t*)dst;
        uint64_t acc = 0;
        for (long long i = 0; i < n; ++i) { acc += s[i]; d[i] = acc; }
    } else if (width == 4) {
        const uint32_t* s = (const uint32_t*)src; uint32_t* d = (uint32_t*)dst;
        uint32_t acc = 0;
        for (long long i = 0; i < n; ++i) { acc += s[i]; d[i] = acc; }
    } else if (width == 2) {
        const uint16_t* s = (const uint16_t*)src; uint16_t* d = (uint16_t*)dst;
        uint16_t acc = 0;
        for (long long i = 0; i < n; ++i) { acc = (uint16_t)(acc + s[i]); d[i] = acc; }
    } else {
        uint8_t acc = 0;
        for (long long i = 0; i < n; ++i) { acc = (uint8_t)(acc + src[i]); dst[i] = acc; }
    }
}

// ---- varint/zigzag helpers ----------------------------------------------

static inline uint8_t* zz_write(uint8_t* p, long long v) {
    uint64_t u = ((uint64_t)v << 1) ^ (uint64_t)(v >> 63);
    while (u >= 0x80) { *p++ = (uint8_t)(u | 0x80); u >>= 7; }
    *p++ = (uint8_t)u;
    return p;
}

static inline const uint8_t* zz_read(const uint8_t* p, const uint8_t* end,
                                     long long* out) {
    uint64_t u = 0; int shift = 0;
    while (p < end) {
        uint8_t b = *p++;
        u |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *out = (long long)(u >> 1) ^ -(long long)(u & 1); return p; }
        shift += 7;
        if (shift > 63) return nullptr;
    }
    return nullptr;
}

// ---- DoubleDelta: first value raw, then zigzag varints of delta-of-delta

long long chn_dd_encode(const int64_t* src, long long n, uint8_t* dst) {
    uint8_t* p = dst;
    if (n == 0) return 0;
    std::memcpy(p, &src[0], 8); p += 8;
    long long prev_delta = 0;
    for (long long i = 1; i < n; ++i) {
        long long delta = (long long)((uint64_t)src[i] - (uint64_t)src[i-1]);
        p = zz_write(p, delta - prev_delta);
        prev_delta = delta;
    }
    return p - dst;
}

long long chn_dd_decode(const uint8_t* src, long long src_len, long long n,
                        int64_t* dst) {
    const uint8_t* p = src; const uint8_t* end = src + src_len;
    if (n == 0) return 0;
    if (end - p < 8) return -1;
    std::memcpy(&dst[0], p, 8); p += 8;
    long long prev_delta = 0;
    for (long long i = 1; i < n; ++i) {
        long long dod;
        p = zz_read(p, end, &dod);
        if (!p) return -1;
        prev_delta += dod;
        dst[i] = (int64_t)((uint64_t)dst[i-1] + (uint64_t)prev_delta);
    }
    return p - src;
}

// ---- Gorilla: XOR-with-previous, bit-packed leading/meaningful windows --

struct BitWriter {
    uint8_t* p; uint64_t acc; int nbits;
    explicit BitWriter(uint8_t* out) : p(out), acc(0), nbits(0) {}
    void put(uint64_t bits, int k) {            // k <= 57
        if (k < 64) bits &= (1ull << k) - 1;
        acc |= bits << nbits;
        nbits += k;
        while (nbits >= 8) { *p++ = (uint8_t)acc; acc >>= 8; nbits -= 8; }
    }
    uint8_t* flush() { if (nbits) { *p++ = (uint8_t)acc; acc = 0; nbits = 0; } return p; }
};

struct BitReader {
    const uint8_t* p; const uint8_t* end; uint64_t acc; int nbits;
    BitReader(const uint8_t* src, const uint8_t* e)
        : p(src), end(e), acc(0), nbits(0) {}
    uint64_t get(int k) {                        // k <= 57
        while (nbits < k && p < end) { acc |= (uint64_t)(*p++) << nbits; nbits += 8; }
        uint64_t v = acc & ((k == 64) ? ~0ull : ((1ull << k) - 1));
        acc >>= k; nbits -= k;
        return v;
    }
};

long long chn_gorilla_encode(const uint64_t* src, long long n, uint8_t* dst) {
    if (n == 0) return 0;
    std::memcpy(dst, &src[0], 8);
    BitWriter w(dst + 8);
    int prev_lead = -1, prev_len = 0;
    for (long long i = 1; i < n; ++i) {
        uint64_t x = src[i] ^ src[i-1];
        if (x == 0) { w.put(0, 1); continue; }
        int lead = __builtin_clzll(x), trail = __builtin_ctzll(x);
        if (lead > 31) lead = 31;
        int len = 64 - lead - trail;
        if (prev_lead >= 0 && lead >= prev_lead
            && lead + len <= prev_lead + prev_len) {
            w.put(1, 1); w.put(0, 1);            // '10': reuse window
            w.put(x >> (64 - prev_lead - prev_len), prev_len > 57 ? 57 : prev_len);
            if (prev_len > 57)
                w.put((x >> (64 - prev_lead - prev_len)) >> 57, prev_len - 57);
        } else {
            w.put(1, 1); w.put(1, 1);            // '11': new window
            w.put((uint64_t)lead, 5);
            w.put((uint64_t)(len - 1), 6);
            uint64_t bits = x >> trail;
            if (len > 57) { w.put(bits, 57); w.put(bits >> 57, len - 57); }
            else w.put(bits, len);
            prev_lead = lead; prev_len = len;
        }
    }
    return w.flush() - dst;
}

long long chn_gorilla_decode(const uint8_t* src, long long src_len,
                             long long n, uint64_t* dst) {
    if (n == 0) return 0;
    if (src_len < 8) return -1;
    std::memcpy(&dst[0], src, 8);
    BitReader r(src + 8, src + src_len);
    int lead = 0, len = 0;
    for (long long i = 1; i < n; ++i) {
        uint64_t prev = dst[i-1];
        if (r.get(1) == 0) { dst[i] = prev; continue; }
        if (r.get(1)) {                          // new window
            lead = (int)r.get(5);
            len = (int)r.get(6) + 1;
        }
        uint64_t bits;
        if (len > 57) { bits = r.get(57); bits |= r.get(len - 57) << 57; }
        else bits = r.get(len);
        int trail = 64 - lead - len;
        dst[i] = prev ^ (bits << trail);
    }
    return 1;
}

// ---- T64: 64-value blocks, min-subtracted, bit-plane transposed ---------

long long chn_t64_encode(const int64_t* src, long long n, uint8_t* dst) {
    uint8_t* p = dst;
    for (long long b = 0; b < n; b += 64) {
        long long m = (n - b < 64) ? (n - b) : 64;
        int64_t mn = src[b];
        for (long long i = 1; i < m; ++i) if (src[b+i] < mn) mn = src[b+i];
        uint64_t mx = 0;
        for (long long i = 0; i < m; ++i) {
            uint64_t v = (uint64_t)(src[b+i] - mn);
            if (v > mx) mx = v;
        }
        int w = 0; while (mx >> w) ++w;
        std::memcpy(p, &mn, 8); p += 8;
        *p++ = (uint8_t)w;
        // bit-plane transpose: plane k = one u64 with bit i = bit k of v_i
        for (int k = 0; k < w; ++k) {
            uint64_t plane = 0;
            for (long long i = 0; i < m; ++i)
                plane |= (((uint64_t)(src[b+i] - mn) >> k) & 1ull) << i;
            std::memcpy(p, &plane, 8); p += 8;
        }
    }
    return p - dst;
}

long long chn_t64_decode(const uint8_t* src, long long src_len, long long n,
                         int64_t* dst) {
    const uint8_t* p = src; const uint8_t* end = src + src_len;
    for (long long b = 0; b < n; b += 64) {
        long long m = (n - b < 64) ? (n - b) : 64;
        if (end - p < 9) return -1;
        int64_t mn; std::memcpy(&mn, p, 8); p += 8;
        int w = *p++;
        if (w > 64 || end - p < 8 * w) return -1;
        uint64_t planes[64];
        for (int k = 0; k < w; ++k) { std::memcpy(&planes[k], p, 8); p += 8; }
        for (long long i = 0; i < m; ++i) {
            uint64_t v = 0;
            for (int k = 0; k < w; ++k) v |= ((planes[k] >> i) & 1ull) << k;
            dst[b+i] = mn + (int64_t)v;
        }
    }
    return p - src;
}

// ----------------------------------------------------- CityHash128 (v1.0.2)
// The reference checksums every compressed wire frame with Google CityHash
// v1.0.2 (src/Compression/CompressedWriteBuffer.cpp:38, contrib/cityhash102),
// so true client interop requires this exact function.  Independent
// implementation of the published 2011 algorithm; verified against the
// reference build's outputs in tests/test_native_lib.py.

static inline uint64_t cty_load64(const uint8_t* p) {
    uint64_t v; std::memcpy(&v, p, 8); return v;
}
static inline uint32_t cty_load32(const uint8_t* p) {
    uint32_t v; std::memcpy(&v, p, 4); return v;
}
static inline uint64_t cty_rot(uint64_t v, int s) {
    return s == 0 ? v : (v >> s) | (v << (64 - s));
}
static inline uint64_t cty_rot1(uint64_t v, int s) {   // s in [1, 63]
    return (v >> s) | (v << (64 - s));
}
static inline uint64_t cty_mix(uint64_t v) { return v ^ (v >> 47); }

static const uint64_t CTY_K0 = 0xc3a5c85c97cb3127ULL;
static const uint64_t CTY_K1 = 0xb492b66fbe98f273ULL;
static const uint64_t CTY_K2 = 0x9ae16a3b2f90404fULL;
static const uint64_t CTY_K3 = 0xc949d7c7509e6557ULL;

static inline uint64_t cty_h16(uint64_t u, uint64_t v) {
    const uint64_t m = 0x9ddfea08eb382d69ULL;
    uint64_t a = (u ^ v) * m;
    a ^= a >> 47;
    uint64_t b = (v ^ a) * m;
    b ^= b >> 47;
    return b * m;
}

static uint64_t cty_short(const uint8_t* s, size_t n) {   // n <= 16
    if (n > 8) {
        uint64_t a = cty_load64(s), b = cty_load64(s + n - 8);
        return cty_h16(a, cty_rot1(b + n, (int)n)) ^ b;
    }
    if (n >= 4) {
        uint64_t a = cty_load32(s);
        return cty_h16(n + (a << 3), cty_load32(s + n - 4));
    }
    if (n > 0) {
        uint32_t y = (uint32_t)s[0] + ((uint32_t)s[n >> 1] << 8);
        uint32_t z = (uint32_t)n + ((uint32_t)s[n - 1] << 2);
        return cty_mix(y * CTY_K2 ^ z * CTY_K3) * CTY_K2;
    }
    return CTY_K2;
}

struct CtyPair { uint64_t lo, hi; };

static inline CtyPair cty_weak32(const uint8_t* s, uint64_t a, uint64_t b) {
    uint64_t w = cty_load64(s), x = cty_load64(s + 8);
    uint64_t y = cty_load64(s + 16), z = cty_load64(s + 24);
    a += w;
    b = cty_rot(b + a + z, 21);
    uint64_t c = a;
    a += x + y;
    b += cty_rot(a, 44);
    return {a + z, b + c};
}

static CtyPair cty_murmur(const uint8_t* s, size_t n,
                          uint64_t sa, uint64_t sb) {
    uint64_t a = sa, b = sb, c = 0, d = 0;
    if (n <= 16) {
        a = cty_mix(a * CTY_K1) * CTY_K1;
        c = b * CTY_K1 + cty_short(s, n);
        d = cty_mix(a + (n >= 8 ? cty_load64(s) : c));
    } else {
        c = cty_h16(cty_load64(s + n - 8) + CTY_K1, a);
        d = cty_h16(b + n, c + cty_load64(s + n - 16));
        a += d;
        int64_t l = (int64_t)n - 16;
        do {
            a = (a ^ (cty_mix(cty_load64(s) * CTY_K1) * CTY_K1)) * CTY_K1;
            b ^= a;
            c = (c ^ (cty_mix(cty_load64(s + 8) * CTY_K1) * CTY_K1)) * CTY_K1;
            d ^= c;
            s += 16;
            l -= 16;
        } while (l > 0);
    }
    a = cty_h16(a, c);
    b = cty_h16(d, b);
    return {a ^ b, cty_h16(b, a)};
}

static CtyPair cty_128_seed(const uint8_t* s, size_t n,
                            uint64_t sa, uint64_t sb) {
    if (n < 128)
        return cty_murmur(s, n, sa, sb);
    uint64_t x = sa, y = sb, z = n * CTY_K1;
    CtyPair v, w;
    v.lo = cty_rot(y ^ CTY_K1, 49) * CTY_K1 + cty_load64(s);
    v.hi = cty_rot(v.lo, 42) * CTY_K1 + cty_load64(s + 8);
    w.lo = cty_rot(y + z, 35) * CTY_K1 + x;
    w.hi = cty_rot(x + cty_load64(s + 88), 53) * CTY_K1;
    do {
        for (int half = 0; half < 2; ++half) {
            x = cty_rot(x + y + v.lo + cty_load64(s + 16), 37) * CTY_K1;
            y = cty_rot(y + v.hi + cty_load64(s + 48), 42) * CTY_K1;
            x ^= w.hi;
            y ^= v.lo;
            z = cty_rot(z ^ w.lo, 33);
            v = cty_weak32(s, v.hi * CTY_K1, x + w.lo);
            w = cty_weak32(s + 32, z + w.hi, y);
            uint64_t t = z; z = x; x = t;
            s += 64;
        }
        n -= 128;
    } while (n >= 128);
    y += cty_rot(w.lo, 37) * CTY_K0 + z;
    x += cty_rot(v.lo + z, 49) * CTY_K0;
    for (size_t done = 0; done < n;) {
        done += 32;
        y = cty_rot(y - x, 42) * CTY_K0 + v.hi;
        w.lo += cty_load64(s + n - done + 16);
        x = cty_rot(x, 49) * CTY_K0 + w.lo;
        w.lo += v.lo;
        v = cty_weak32(s + n - done, v.lo, v.hi);
    }
    x = cty_h16(x, v.lo);
    y = cty_h16(y, w.lo);
    return {cty_h16(x + v.hi, w.hi) + y, cty_h16(x + w.hi, y + v.hi)};
}

// CityHash128 of a byte buffer -> out[0] = low64, out[1] = high64.
void chn_cityhash128(const uint8_t* s, long long n, uint64_t* out) {
    CtyPair r;
    if (n >= 16)
        r = cty_128_seed(s + 16, (size_t)n - 16,
                         cty_load64(s) ^ CTY_K3, cty_load64(s + 8));
    else if (n >= 8)
        r = cty_128_seed(nullptr, 0,
                         cty_load64(s) ^ ((uint64_t)n * CTY_K0),
                         cty_load64(s + n - 8) ^ CTY_K1);
    else
        r = cty_128_seed(s, (size_t)n, CTY_K0, CTY_K1);
    out[0] = r.lo;
    out[1] = r.hi;
}

// CityHash128 per fixed-width byte row, trailing NULs trimmed: the
// hash-token string factorization path (high-cardinality GROUP BY builds
// codes from 128-bit hashes instead of a lexicographic unique over the
// raw strings — core/column.py factorize_strings).
void chn_cityhash128_rows(const uint8_t* data, long long width,
                          long long n, uint64_t* out) {
    for (long long i = 0; i < n; ++i) {
        const uint8_t* row = data + i * width;
        long long len = width;
        while (len > 0 && row[len - 1] == 0) --len;
        chn_cityhash128(row, len, out + 2 * i);
    }
}

}  // extern "C"
