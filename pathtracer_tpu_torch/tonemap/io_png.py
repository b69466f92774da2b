"""Minimal dependency-free PNG writer (8-bit RGB/RGBA) with gamma and
chromaticity chunks, and reader (8- and 16-bit grey, grey+alpha, RGB, RGBA
and palette; filters 0-4; no interlace) for texture assets (counterpart of
`tonemap/io_png.py`). Pure Python, zlib and numpy."""

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


def read_png(path: str) -> np.ndarray:
    """PNG -> [H, W, channels] uint8 (uint16 for 16-bit files; palette
    images -> RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = bitdepth = color_type = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk)
            if interlace != 0:
                raise ValueError(f"{path}: interlaced PNG is not supported")
        elif tag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bpp = max(1, nch * bitdepth // 8)
    stride = (w * nch * bitdepth + 7) // 8
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).astype(
            np.int64)
        pos += 1 + stride
        if filt == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif filt == 2:  # Up
            line = (line + prev) & 0xFF
        elif filt == 3:  # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        out[y] = line
        prev = line
    if bitdepth == 8:
        img = out[:, :w * nch].reshape(h, w, nch)
    elif bitdepth == 16:
        img = out.view(">u2")[:, :w * nch].reshape(h, w, nch).astype(np.uint16)
    else:  # sub-byte depths: unpack the bits
        bits = np.unpackbits(out, axis=1)[:, :w * nch * bitdepth]
        bits = bits.reshape(h, w * nch, bitdepth)
        img = np.zeros((h, w * nch), np.uint8)
        for b in range(bitdepth):
            img = (img << 1) | bits[:, :, b]
        img = img.reshape(h, w, nch)
    if color_type == 3:
        img = palette[img[..., 0]]
    return img
