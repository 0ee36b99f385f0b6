// Native ROS1 bag (v2.0) record scanner — the data-loader hot path.
//
// The reference ingests bags through roscpp's C++ rosbag reader
// (vector_mapping_main.cpp:1320 LoadRosBag); our self-contained Python
// reader (io/rosbag.py) is exact but pays Python-interpreter overhead per
// record — real CoBot bags carry ~10^5-10^6 records (odometry at 20-80 Hz
// for hours). This kernel does the per-RECORD work in C: record framing
// (length-prefixed header + data) and extraction of the three hot header
// fields (op, conn, time). Everything rare — connection records, chunk
// compression dispatch, warnings — stays in Python, reusing the existing
// exact logic, so the two paths are behaviorally identical (equivalence-
// tested in tests/test_torch_native.py).
//
// Field-parsing semantics mirror io/rosbag.py::_parse_header exactly:
//   - fields are <u32 len><bytes>, split at the first '='
//   - a field without '=' is ignored
//   - duplicate keys: LAST one wins
//   - a field length overrunning the header is clamped (Python slice
//     semantics) and the loop exits at the next length check
// and _iter_records: truncated header/data stop iteration cleanly; the
// stop reason + offsets are returned so Python can emit identical
// warnings.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

struct HotFields {
    int32_t op = -1;        // first byte of last "op" value; -1 if none/empty
    int64_t conn = -1;      // last "conn" value (u32 LE); -1 if none/short
    double time = NAN;      // last "time" value secs+1e-9*nsecs; NaN if none
};

inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);   // little-endian hosts only (x86/ARM TPU hosts)
    return v;
}

HotFields parse_hot(const uint8_t* hdr, int64_t hlen) {
    HotFields out;
    int64_t off = 0;
    while (off + 4 <= hlen) {
        uint32_t flen = rd_u32(hdr + off);
        off += 4;
        // clamp to header end (Python slice semantics)
        int64_t avail = hlen - off;
        int64_t take = (int64_t)flen < avail ? (int64_t)flen : avail;
        const uint8_t* f = hdr + off;
        const uint8_t* eq =
            (const uint8_t*)std::memchr(f, '=', (size_t)take);
        if (eq != nullptr) {
            int64_t klen = eq - f;
            const uint8_t* v = eq + 1;
            int64_t vlen = take - klen - 1;
            if (klen == 2 && std::memcmp(f, "op", 2) == 0) {
                out.op = vlen >= 1 ? (int32_t)v[0] : -1;
            } else if (klen == 4 && std::memcmp(f, "conn", 4) == 0) {
                out.conn = vlen >= 4 ? (int64_t)rd_u32(v) : -1;
            } else if (klen == 4 && std::memcmp(f, "time", 4) == 0) {
                if (vlen >= 8) {
                    uint32_t secs = rd_u32(v), nsecs = rd_u32(v + 4);
                    out.time = (double)secs + 1e-9 * (double)nsecs;
                } else {
                    out.time = NAN;
                }
            }
        }
        off += flen;   // may overrun; loop condition exits, like Python
    }
    return out;
}

// stop_info: [0] status (0 clean / 1 trailing 1-3 bytes / 2 truncated
// header / 3 truncated data), [1] failing record start, [2] bytes consumed
template <bool kCount>
int64_t scan(const uint8_t* buf, int64_t n, int64_t off, int64_t max_records,
             int32_t* op, int64_t* conn, double* time,
             int64_t* header_off, int64_t* header_len,
             int64_t* data_off, int64_t* data_len, int64_t* stop_info) {
    int64_t count = 0;
    stop_info[0] = 0;
    stop_info[1] = -1;
    while (off + 4 <= n) {
        int64_t rec_start = off;
        uint32_t hlen = rd_u32(buf + off);
        off += 4;
        if (off + (int64_t)hlen + 4 > n) {
            stop_info[0] = 2;
            stop_info[1] = rec_start;
            stop_info[2] = off;
            return count;
        }
        int64_t hoff = off;
        off += hlen;
        uint32_t dlen = rd_u32(buf + off);
        off += 4;
        if (off + (int64_t)dlen > n) {
            stop_info[0] = 3;
            stop_info[1] = rec_start;
            stop_info[2] = off;
            return count;
        }
        if (!kCount) {
            if (count >= max_records) {  // caller under-allocated; bail
                stop_info[0] = 4;
                stop_info[2] = rec_start;
                return count;
            }
            HotFields h = parse_hot(buf + hoff, (int64_t)hlen);
            op[count] = h.op;
            conn[count] = h.conn;
            time[count] = h.time;
            header_off[count] = hoff;
            header_len[count] = (int64_t)hlen;
            data_off[count] = off;
            data_len[count] = (int64_t)dlen;
        }
        off += dlen;
        ++count;
    }
    if (off != n) stop_info[0] = 1;   // 1-3 trailing bytes
    stop_info[2] = off;
    return count;
}

// ---------------------------------------------------------------------------
// xxHash32 — checksum of the LZ4 frame format rosbag's roslz4 compression
// uses (spec: xxHash/doc/xxhash_spec.md; known-answer-tested in
// tests/test_rosbag.py). liblz4.so.1 in this image does not export XXH32,
// so the frame codec (io/lz4frame.py) calls this kernel for real chunk
// sizes and falls back to a pure-Python mirror.
// ---------------------------------------------------------------------------

const uint32_t kP1 = 2654435761U, kP2 = 2246822519U, kP3 = 3266489917U,
               kP4 = 668265263U, kP5 = 374761393U;

inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

inline uint32_t xxh_round(uint32_t acc, uint32_t lane) {
    return rotl32(acc + lane * kP2, 13) * kP1;
}

uint32_t xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
                 v4 = seed - kP1;
        const uint8_t* limit = end - 16;
        do {
            v1 = xxh_round(v1, rd_u32(p)); p += 4;
            v2 = xxh_round(v2, rd_u32(p)); p += 4;
            v3 = xxh_round(v3, rd_u32(p)); p += 4;
            v4 = xxh_round(v4, rd_u32(p)); p += 4;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + kP5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h += rd_u32(p) * kP3;
        h = rotl32(h, 17) * kP4;
        p += 4;
    }
    while (p < end) {
        h += (*p) * kP5;
        h = rotl32(h, 11) * kP1;
        ++p;
    }
    h ^= h >> 15;
    h *= kP2;
    h ^= h >> 13;
    h *= kP3;
    h ^= h >> 16;
    return h;
}

}  // namespace

extern "C" {

uint32_t bag_xxh32(const uint8_t* buf, int64_t n, uint32_t seed) {
    return xxh32(buf, n, seed);
}

int64_t bag_count_records(const uint8_t* buf, int64_t n, int64_t off) {
    int64_t stop[3];
    return scan<true>(buf, n, off, 0, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, stop);
}

int64_t bag_scan_records(const uint8_t* buf, int64_t n, int64_t off,
                         int64_t max_records, int32_t* op, int64_t* conn,
                         double* time, int64_t* header_off,
                         int64_t* header_len, int64_t* data_off,
                         int64_t* data_len, int64_t* stop_info) {
    return scan<false>(buf, n, off, max_records, op, conn, time, header_off,
                       header_len, data_off, data_len, stop_info);
}

}  // extern "C"
