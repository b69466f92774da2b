"""A plain PNG decoder: 8-bit grey, grey+alpha, RGB and RGBA, filters 0-4,
no interlace, no palette. zlib and numpy only."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode(path: str) -> np.ndarray:
    """PNG file -> uint8 [H, W, channels]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) "
                         f"PNGs are read (depth {depth}, type {ctype})")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = [0] * stride
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = list(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for x in range(stride):
            a = line[x - ch] if x >= ch else 0
            b = prev[x]
            c = prev[x - ch] if x >= ch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype] \
                if ftype else 0
            line[x] = (line[x] + pred) & 0xFF
        out[y] = line
        prev = line
    return out.reshape(h, w, ch)
