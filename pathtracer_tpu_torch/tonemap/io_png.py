"""Minimal dependency-free PNG writer (8-bit RGB/RGBA) with gamma and
chromaticity chunks (counterpart of `tonemap/io_png.py`)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, rgb: np.ndarray, chromaticities=None, gamma: float = 1.0 / 2.2):
    """rgb: uint8 [H,W,3] or [H,W,4], or float in [0,1] (converted)."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = arr.shape[:2]
    channels = arr.shape[2] if arr.ndim == 3 else 1
    color_type = {1: 0, 3: 2, 4: 6}[channels]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    out = [b"\x89PNG\r\n\x1a\n"]
    out.append(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
    out.append(_chunk(b"gAMA", struct.pack(">I", int(round(gamma * 100000)))))
    if chromaticities is not None:
        c = chromaticities
        vals = [c["w"][0], c["w"][1], c["r"][0], c["r"][1], c["g"][0], c["g"][1], c["b"][0], c["b"][1]]
        out.append(_chunk(b"cHRM", struct.pack(">8I", *[int(round(v * 100000)) for v in vals])))
    out.append(_chunk(b"IDAT", zlib.compress(raw, 6)))
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
