// Native WAL batch framing.
//
// The shared WAL's hot loop frames every queued record (header pack +
// CRC32 over idx|term|payload) before one write+fdatasync per batch.
// This library does the framing for a whole batch in one call: Python
// hands down parallel arrays (kinds, refs, idx, term, payload offsets)
// plus one concatenated payload blob, and gets back the framed bytes.
//
// Record wire format (little-endian, must match ra_tpu_torch/log/wal.py):
//   uid-def : kind=1 | ref u16 | len u16 | uid bytes
//   entry   : kind=2 | ref u16 | idx u64 | term u64 | crc u32 | len u32
//             | payload
//   trunc   : kind=3 | ref u16 | idx u64
//   sparse  : kind=4 | layout identical to entry (no gap/truncate
//             semantics on recovery)
//
// Build: g++ -O2 -shared -fPIC -o wal_native.so wal_native.cpp
// (no external deps; CRC32 implemented here, polynomial 0xEDB88320,
// matching zlib.crc32).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <unistd.h>

static uint32_t crc_table[256];
static bool crc_ready = false;

static void crc_init() {
    for (uint32_t n = 0; n < 256; n++) {
        uint32_t c = n;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
    crc_ready = true;
}

static uint32_t crc32_update(uint32_t crc, const uint8_t* buf, uint64_t len) {
    crc = crc ^ 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; i++)
        crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

extern "C" {

// Returns the number of bytes written into `out` (caller sizes it via
// wal_frame_bound), or -1 if out_cap would be exceeded.
//
// kinds[i]: 1=uid-def, 2=entry, 3=trunc, 4=sparse entry
// refs[i]:  writer ref
// idxs[i], terms[i]: entry/trunc fields (uid-def: idx = uid byte length)
// offs[i]..offs[i]+lens[i]: payload slice in `blob` (entry payload or
//   uid bytes for uid-def; empty for trunc)
// compute_crc: 0 disables checksums (crc field written as 0)
long wal_frame_batch(
    const uint8_t* kinds,
    const uint16_t* refs,
    const uint64_t* idxs,
    const uint64_t* terms,
    const uint64_t* offs,
    const uint32_t* lens,
    long n,
    const uint8_t* blob,
    int compute_crc,
    uint8_t* out,
    long out_cap
) {
    if (!crc_ready) crc_init();
    long w = 0;
    for (long i = 0; i < n; i++) {
        uint8_t kind = kinds[i];
        if (kind == 1) {  // uid-def: B H H + uid bytes
            uint32_t ln = lens[i];
            if (w + 5 + (long)ln > out_cap) return -1;
            out[w++] = 1;
            memcpy(out + w, &refs[i], 2); w += 2;
            uint16_t l16 = (uint16_t)ln;
            memcpy(out + w, &l16, 2); w += 2;
            memcpy(out + w, blob + offs[i], ln); w += ln;
        } else if (kind == 2 || kind == 4) {  // entry / sparse entry
            uint32_t ln = lens[i];
            if (w + 27 + (long)ln > out_cap) return -1;
            out[w++] = kind;
            memcpy(out + w, &refs[i], 2); w += 2;
            memcpy(out + w, &idxs[i], 8); w += 8;
            memcpy(out + w, &terms[i], 8); w += 8;
            uint32_t crc = 0;
            if (compute_crc) {
                uint8_t hdr[16];
                memcpy(hdr, &idxs[i], 8);
                memcpy(hdr + 8, &terms[i], 8);
                crc = crc32_update(0, hdr, 16);
                // zlib-style incremental: crc32(payload, crc32(hdr))
                crc = crc ^ 0xFFFFFFFFu;
                const uint8_t* p = blob + offs[i];
                for (uint32_t b = 0; b < ln; b++)
                    crc = crc_table[(crc ^ p[b]) & 0xFF] ^ (crc >> 8);
                crc = crc ^ 0xFFFFFFFFu;
            }
            memcpy(out + w, &crc, 4); w += 4;
            memcpy(out + w, &ln, 4); w += 4;
            memcpy(out + w, blob + offs[i], ln); w += ln;
        } else if (kind == 3) {  // trunc: B H Q
            if (w + 11 > out_cap) return -1;
            out[w++] = 3;
            memcpy(out + w, &refs[i], 2); w += 2;
            memcpy(out + w, &idxs[i], 8); w += 8;
        } else {
            return -1;
        }
    }
    return w;
}

// Exact upper bound for the framed size of a batch.
long wal_frame_bound(const uint8_t* kinds, const uint32_t* lens, long n) {
    long total = 0;
    for (long i = 0; i < n; i++) {
        if (kinds[i] == 1) total += 5 + lens[i];
        else if (kinds[i] == 2 || kinds[i] == 4) total += 27 + lens[i];
        else total += 11;
    }
    return total;
}

// Frame + write + fsync a whole batch against `fd` in ONE call — the
// serialize/write/fsync hot path of the shared WAL without any
// Python-side byte assembly (and without the GIL for the duration:
// ctypes releases it around the call).
//
// sync_mode: 0 = none, 1 = fdatasync, 2 = fsync. The fsync wait in
// nanoseconds (CLOCK_MONOTONIC) is stored to *fsync_ns when syncing.
// Returns bytes written; -1 on a malformed batch (caller falls back to
// the Python framer); -(1000+errno) on an I/O failure (write short/
// failed or fsync failed — the caller must treat the file as poisoned,
// same as the Python path's fsync-failure rule).
long wal_write_batch(
    const uint8_t* kinds,
    const uint16_t* refs,
    const uint64_t* idxs,
    const uint64_t* terms,
    const uint64_t* offs,
    const uint32_t* lens,
    long n,
    const uint8_t* blob,
    int compute_crc,
    int fd,
    int sync_mode,
    long long* fsync_ns
) {
    long bound = wal_frame_bound(kinds, lens, n);
    uint8_t* buf = (uint8_t*)malloc(bound > 0 ? bound : 1);
    if (!buf) return -(1000 + ENOMEM);
    long w = wal_frame_batch(kinds, refs, idxs, terms, offs, lens, n,
                             blob, compute_crc, buf, bound);
    if (w < 0) { free(buf); return -1; }
    long off = 0;
    while (off < w) {
        ssize_t got = write(fd, buf + off, (size_t)(w - off));
        if (got < 0) {
            if (errno == EINTR) continue;
            int e = errno;
            free(buf);
            return -(1000 + e);
        }
        off += got;
    }
    free(buf);
    if (sync_mode != 0) {
        struct timespec t0, t1;
        clock_gettime(CLOCK_MONOTONIC, &t0);
        int rc = (sync_mode == 1) ? fdatasync(fd) : fsync(fd);
        clock_gettime(CLOCK_MONOTONIC, &t1);
        if (rc != 0) return -(1000 + errno);
        if (fsync_ns)
            *fsync_ns = (long long)(t1.tv_sec - t0.tv_sec) * 1000000000LL
                        + (t1.tv_nsec - t0.tv_nsec);
    } else if (fsync_ns) {
        *fsync_ns = 0;
    }
    return w;
}

uint32_t wal_crc32(const uint8_t* buf, uint64_t len) {
    if (!crc_ready) crc_init();
    return crc32_update(0, buf, len);
}

}  // extern "C"
