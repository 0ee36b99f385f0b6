"""LZ4 Frame codec for rosbag chunks (roslz4 wire format).

Port of hitl_slam_tpu/io/lz4frame.py (host only).

The reference stack records bags with rosbag, whose third chunk compression
(besides none/bz2) is roslz4 (ros_comm/utilities/roslz4) — the public LZ4
Frame format (magic 0x184D2204; spec lz4/doc/lz4_Frame_format.md) written
with version 01, independent 64 KB blocks, no block checksums, and a
content checksum. Bag chunk decompression dispatches here for
compression=lz4 (io/rosbag.py::_chunk_payload).

Block (de)compression calls the system liblz4.so.1 via ctypes
(LZ4_compress_default / LZ4_decompress_safe[_usingDict]); the frame layer
is Python (one iteration per 64 KB block — cold path). xxHash32 checksums
use the native C kernel (native/bag_scanner.cpp::bag_xxh32) with a
pure-Python fallback (`_xxh32_py`, also the test cross-check).

`decompress` accepts the GENERAL format, not just what roslz4 emits:
optional content-size field, per-block checksums, stored (uncompressed)
blocks, and block-LINKED frames (each block decoded with the previous
64 KB of output as dictionary via LZ4_decompress_safe_usingDict).
Corruption raises ValueError; the bag reader downgrades that to a
warning + chunk skip, exactly like corrupt bz2. `compress` emits the
roslz4 shape (FLG 0x64, BD 0x40) so written bags match what real
rosbag/roslz4 readers expect.
"""

from __future__ import annotations

import ctypes
import struct

_MAGIC = 0x184D2204
_BLOCK_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}

_lz4 = None
_lz4_failed = False


def _lib():
    global _lz4, _lz4_failed
    if _lz4 is None and not _lz4_failed:
        try:
            lib = ctypes.CDLL("liblz4.so.1")
            lib.LZ4_compress_default.restype = ctypes.c_int
            lib.LZ4_compress_default.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.LZ4_decompress_safe.restype = ctypes.c_int
            lib.LZ4_decompress_safe.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.LZ4_decompress_safe_usingDict.restype = ctypes.c_int
            lib.LZ4_decompress_safe_usingDict.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int]
            _lz4 = lib
        except (OSError, AttributeError):
            _lz4_failed = True
    return _lz4


def available() -> bool:
    return _lib() is not None


# ---------------------------------------------------------------------------
# xxHash32 (checksums)
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393)
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _xxh32_py(data: bytes, seed: int = 0) -> int:
    """Pure-Python xxHash32 (spec: xxHash/doc/xxhash_spec.md). Slow — the
    native kernel handles real chunk sizes; this is the fallback and the
    independent implementation the tests cross-check against."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        lanes = struct.unpack_from(f"<{(n // 16) * 4}I", data)
        for j in range(0, len(lanes), 4):
            v1 = (_rotl((v1 + lanes[j] * _P2) & _M, 13) * _P1) & _M
            v2 = (_rotl((v2 + lanes[j + 1] * _P2) & _M, 13) * _P1) & _M
            v3 = (_rotl((v3 + lanes[j + 2] * _P2) & _M, 13) * _P1) & _M
            v4 = (_rotl((v4 + lanes[j + 3] * _P2) & _M, 13) * _P1) & _M
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        i = (n // 16) * 16
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while i + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, i)
        h = (_rotl((h + lane * _P3) & _M, 17) * _P4) & _M
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P5) & _M, 11) * _P1) & _M
        i += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


def xxh32(data: bytes, seed: int = 0) -> int:
    from .. import native

    v = native.xxh32(data, seed)
    return _xxh32_py(data, seed) if v is None else v


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def decompress(data: bytes) -> bytes:
    """Decode a sequence of LZ4 frames (an lz4 stream may concatenate
    frames; skippable frames are skipped per spec). Raises ValueError on
    any corruption, trailing garbage, or an unsupported feature (external
    dictionary)."""
    lib = _lib()
    if lib is None:
        raise ValueError("liblz4.so.1 unavailable; cannot read lz4 chunks")
    out = bytearray()
    off = 0
    n = len(data)
    if n == 0:
        raise ValueError("empty lz4 stream")
    while off < n:
        if off + 4 > n:
            raise ValueError("trailing garbage after lz4 frame")
        (magic,) = struct.unpack_from("<I", data, off)
        if (magic & 0xFFFFFFF0) == 0x184D2A50:     # skippable frame
            if off + 8 > n:
                raise ValueError("truncated lz4 skippable frame")
            (size,) = struct.unpack_from("<I", data, off + 4)
            off += 8 + size
            if off > n:
                raise ValueError("truncated lz4 skippable frame")
            continue
        if magic != _MAGIC:
            raise ValueError(f"bad lz4 frame magic {magic:#010x}")
        off = _decompress_frame(lib, data, off, out)
    return bytes(out)


def _decompress_frame(lib, data: bytes, start: int, out: bytearray) -> int:
    """Decode ONE frame starting at `start` (magic already verified),
    append to `out`, and return the offset one past the frame's end."""
    n = len(data)
    if start + 7 > n:
        raise ValueError("lz4 frame too short")
    flg, bd = data[start + 4], data[start + 5]
    if flg >> 6 != 1:
        raise ValueError(f"unsupported lz4 frame version {flg >> 6}")
    indep = (flg >> 5) & 1
    block_checksum = (flg >> 4) & 1
    has_csize = (flg >> 3) & 1
    content_checksum = (flg >> 2) & 1
    if flg & 1:
        raise ValueError("lz4 frames with external dictionaries unsupported")
    bmax = _BLOCK_SIZES.get((bd >> 4) & 0x7)
    if bmax is None:
        raise ValueError(f"bad lz4 block-size id {(bd >> 4) & 0x7}")
    off = start + 6 + (8 if has_csize else 0)
    if off >= n:
        raise ValueError("truncated lz4 frame header")
    if (xxh32(data[start + 4:off]) >> 8) & 0xFF != data[off]:
        raise ValueError("lz4 frame header checksum mismatch")
    off += 1

    frame = bytearray()   # frame-local: block linkage never crosses frames
    dst = ctypes.create_string_buffer(bmax)
    while True:
        if off + 4 > n:
            raise ValueError("truncated lz4 frame (no EndMark)")
        (bsize,) = struct.unpack_from("<I", data, off)
        off += 4
        if bsize == 0:
            break
        stored = bsize >> 31
        bsize &= 0x7FFFFFFF
        if bsize > bmax:
            raise ValueError("lz4 block larger than the frame's block size")
        if off + bsize > n:
            raise ValueError("truncated lz4 block")
        block = data[off:off + bsize]
        off += bsize
        if block_checksum:
            if off + 4 > n:
                raise ValueError("truncated lz4 block checksum")
            (bc,) = struct.unpack_from("<I", data, off)
            off += 4
            if xxh32(block) != bc:
                raise ValueError("lz4 block checksum mismatch")
        if stored:
            frame += block
        elif indep or not frame:
            m = lib.LZ4_decompress_safe(block, dst, bsize, bmax)
            if m < 0:
                raise ValueError("corrupt lz4 block data")
            frame += dst[:m]
        else:
            prefix = bytes(frame[-65536:])
            m = lib.LZ4_decompress_safe_usingDict(
                block, dst, bsize, bmax, prefix, len(prefix))
            if m < 0:
                raise ValueError("corrupt lz4 block data (linked)")
            frame += dst[:m]
    if content_checksum:
        if off + 4 > n:
            raise ValueError("truncated lz4 content checksum")
        (cc,) = struct.unpack_from("<I", data, off)
        off += 4
        if xxh32(bytes(frame)) != cc:
            raise ValueError("lz4 content checksum mismatch")
    out += frame
    return off


def compress(data: bytes) -> bytes:
    """Encode one LZ4 frame in the roslz4 shape: version 01, INDEPENDENT
    64 KB blocks, no block checksums, content checksum (FLG 0x64, BD 0x40).
    Incompressible blocks are stored raw (high bit of the block size)."""
    lib = _lib()
    if lib is None:
        raise ValueError("liblz4.so.1 unavailable; cannot write lz4 chunks")
    header = struct.pack("<IBB", _MAGIC, 0x64, 0x40)
    parts = [header, bytes([(xxh32(header[4:6]) >> 8) & 0xFF])]
    bmax = 1 << 16
    dst = ctypes.create_string_buffer(bmax + 256)
    for i in range(0, len(data), bmax):
        blk = data[i:i + bmax]
        m = lib.LZ4_compress_default(blk, dst, len(blk), len(dst))
        if 0 < m < len(blk):
            parts.append(struct.pack("<I", m))
            parts.append(dst[:m])
        else:
            parts.append(struct.pack("<I", len(blk) | 0x80000000))
            parts.append(blk)
    parts.append(struct.pack("<II", 0, xxh32(data)))
    return b"".join(parts)
