// Native hot-loop runtime: the ingest/egress byte loops of the batch
// coordinator, run with the GIL released (ctypes drops it around every
// call). Three entry points, each dropping into an existing Python
// seam (docs/INTERNALS.md §18):
//
//   rt_classify    - single-pass tag partition over the drained ring
//                    items' class-code sidecar (the flat tagged-item
//                    layout rings.py publishes); returns in-order index
//                    lists per class for the Python routing half.
//   rt_pack_mbox   - scatter pre-flattened per-message int64 field
//                    values into the packed (NROWS, width) int32
//                    mailbox buffer (the columnwise encode of
//                    _build_mailbox without per-field Python passes).
//   rt_seal_frames - batch-serialize per-destination wire frames on
//                    the egress sender path: HMAC-SHA256(cookie) MAC +
//                    length framing for a whole batch in one call
//                    (byte-identical to TcpTransport._seal + _LEN).
//
// Python stays the policy owner and the byte-identical fallback; armed
// failpoints route around all three (ra_tpu_torch/faults.py).
//
// Build: g++ -O2 -shared -fPIC -o rt_native.so rt_native.cpp
// (no external deps; SHA-256 implemented here, FIPS 180-4).

#include <cstdint>
#include <cstring>

extern "C" {

// -- classify ---------------------------------------------------------------

// Partition item indexes by class code, order preserved within each
// class. codes[i] in [0, n_classes); out_idx must hold n entries and
// counts n_classes entries. After the call the indexes of class k
// occupy out_idx[sum(counts[0..k-1]) : +counts[k]] in arrival order.
// Returns 0, or -1 on an out-of-range code (caller falls back).
long rt_classify(
    const uint8_t* codes,
    long n,
    long n_classes,
    int32_t* out_idx,
    int32_t* counts
) {
    for (long k = 0; k < n_classes; k++) counts[k] = 0;
    for (long i = 0; i < n; i++) {
        if (codes[i] >= n_classes) return -1;
        counts[codes[i]]++;
    }
    // prefix offsets, then a stable fill
    long offs[256];
    long acc = 0;
    for (long k = 0; k < n_classes; k++) {
        offs[k] = acc;
        acc += counts[k];
    }
    for (long i = 0; i < n; i++)
        out_idx[offs[codes[i]]++] = (int32_t)i;
    return 0;
}

// -- mailbox pack -----------------------------------------------------------

// Scatter n messages x nf fields of row-major int64 values into the
// packed int32 mailbox: out[rows[f]*width + cols[k]] = vals[k*nf + f].
// Returns 0, or -1 on an out-of-range row/column (caller falls back).
long rt_pack_mbox(
    const int64_t* vals,
    const int32_t* cols,
    long n,
    const int32_t* rows,
    long nf,
    int32_t* out,
    long nrows,
    long width
) {
    for (long f = 0; f < nf; f++)
        if (rows[f] < 0 || rows[f] >= nrows) return -1;
    for (long k = 0; k < n; k++) {
        int32_t c = cols[k];
        if (c < 0 || c >= width) return -1;
        const int64_t* v = vals + k * nf;
        for (long f = 0; f < nf; f++)
            out[(long)rows[f] * width + c] = (int32_t)v[f];
    }
    return 0;
}

// -- SHA-256 / HMAC (egress frame seal) -------------------------------------

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

struct Sha256 {
    uint32_t h[8];
    uint64_t len;
    uint8_t buf[64];
    uint32_t fill;
};

static inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

static void sha256_init(Sha256* s) {
    static const uint32_t iv[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
    };
    memcpy(s->h, iv, sizeof iv);
    s->len = 0;
    s->fill = 0;
}

static void sha256_block(Sha256* s, const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16)
             | ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = s->h[0], b = s->h[1], c = s->h[2], d = s->h[3];
    uint32_t e = s->h[4], f = s->h[5], g = s->h[6], h = s->h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K256[i] + w[i];
        uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    s->h[0] += a; s->h[1] += b; s->h[2] += c; s->h[3] += d;
    s->h[4] += e; s->h[5] += f; s->h[6] += g; s->h[7] += h;
}

static void sha256_update(Sha256* s, const uint8_t* p, uint64_t n) {
    s->len += n;
    if (s->fill) {
        while (n && s->fill < 64) {
            s->buf[s->fill++] = *p++;
            n--;
        }
        if (s->fill == 64) {
            sha256_block(s, s->buf);
            s->fill = 0;
        }
    }
    while (n >= 64) {
        sha256_block(s, p);
        p += 64;
        n -= 64;
    }
    while (n--) s->buf[s->fill++] = *p++;
}

static void sha256_final(Sha256* s, uint8_t out[32]) {
    uint64_t bits = s->len * 8;
    uint8_t pad = 0x80;
    sha256_update(s, &pad, 1);
    uint8_t z = 0;
    while (s->fill != 56) sha256_update(s, &z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (56 - 8 * i));
    sha256_update(s, lb, 8);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (uint8_t)(s->h[i] >> 24);
        out[4 * i + 1] = (uint8_t)(s->h[i] >> 16);
        out[4 * i + 2] = (uint8_t)(s->h[i] >> 8);
        out[4 * i + 3] = (uint8_t)s->h[i];
    }
}

static void hmac_sha256(
    const uint8_t* key, uint64_t keylen,
    const uint8_t* msg, uint64_t msglen,
    uint8_t out[32]
) {
    uint8_t k[64];
    memset(k, 0, 64);
    if (keylen > 64) {
        Sha256 s;
        sha256_init(&s);
        sha256_update(&s, key, keylen);
        uint8_t kh[32];
        sha256_final(&s, kh);
        memcpy(k, kh, 32);
    } else {
        memcpy(k, key, keylen);
    }
    uint8_t pad[64];
    for (int i = 0; i < 64; i++) pad[i] = k[i] ^ 0x36;
    Sha256 s;
    sha256_init(&s);
    sha256_update(&s, pad, 64);
    sha256_update(&s, msg, msglen);
    uint8_t inner[32];
    sha256_final(&s, inner);
    for (int i = 0; i < 64; i++) pad[i] = k[i] ^ 0x5c;
    sha256_init(&s);
    sha256_update(&s, pad, 64);
    sha256_update(&s, inner, 32);
    sha256_final(&s, out);
}

// Seal n payloads into the TCP transport's wire framing in one call:
// per payload, u32-LE total length (mac_len + payload_len), then the
// truncated HMAC-SHA256(key, payload) MAC, then the payload — byte-
// identical to Python's _LEN.pack(len(f)) + _seal(payload) per frame.
// Returns bytes written into out, or -1 when out_cap would overflow.
long rt_seal_frames(
    const uint8_t* blob,
    const uint64_t* offs,
    const uint32_t* lens,
    long n,
    const uint8_t* key,
    long keylen,
    long mac_len,
    uint8_t* out,
    long out_cap
) {
    if (mac_len < 0 || mac_len > 32) return -1;
    long w = 0;
    for (long i = 0; i < n; i++) {
        uint32_t ln = lens[i];
        long total = 4 + mac_len + (long)ln;
        if (w + total > out_cap) return -1;
        uint32_t framed = (uint32_t)(mac_len + ln);
        out[w] = (uint8_t)framed;
        out[w + 1] = (uint8_t)(framed >> 8);
        out[w + 2] = (uint8_t)(framed >> 16);
        out[w + 3] = (uint8_t)(framed >> 24);
        uint8_t mac[32];
        hmac_sha256(key, (uint64_t)keylen, blob + offs[i], ln, mac);
        memcpy(out + w + 4, mac, (size_t)mac_len);
        memcpy(out + w + 4 + mac_len, blob + offs[i], ln);
        w += total;
    }
    return w;
}

}  // extern "C"
