"""Minimal dependency-free PNG/PPM writers (stdlib zlib only).

A copy of hitl_slam_tpu/utils/image.py: the same image gives the same bytes.
The reference links CImg+libpng just to dump info_mat.png and GUI captures;
here a ~30-line encoder does it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W] (grayscale) or [H, W, 3] (RGB), uint8."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        color_type = 0
        raw = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        raw = img
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = raw.shape[:2]
    # each scanline prefixed with filter byte 0
    scan = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw.reshape(h, -1)], axis=1
    ).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(scan, 6)))
        f.write(chunk(b"IEND", b""))


def write_ppm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())
