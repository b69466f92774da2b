"""Minimal dependency-free OpenEXR scanline writer (float32, no
compression) with a chromaticities attribute (counterpart of
`tonemap/io_exr.py`; the port writes EXR and does not read it)."""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_FLOAT = 2


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr(path: str, rgb: np.ndarray, chromaticities=None):
    """rgb: float32 [H,W,3] linear. Writes uncompressed scanline EXR."""
    arr = np.asarray(rgb, np.float32)
    h, w = arr.shape[:2]
    # channel list sorted alphabetically: B, G, R
    chans = b""
    for name in (b"B", b"G", b"R"):
        chans += name + b"\x00" + struct.pack("<iiii", _PIXELTYPE_FLOAT, 0, 1, 1)
    chans += b"\x00"
    header = b""
    header += _attr(b"channels", b"chlist", chans)
    header += _attr(b"compression", b"compression", b"\x00")  # none
    header += _attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    if chromaticities is not None:
        c = chromaticities
        vals = [*c["r"], *c["g"], *c["b"], *c["w"]]
        header += _attr(b"chromaticities", b"chromaticities", struct.pack("<8f", *vals))
    header += b"\x00"

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, scanline
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * h)
        offsets = []
        for y in range(h):
            offsets.append(f.tell())
            # scanline: y, data size, then channel-planar B,G,R
            row = arr[y]
            data = row[:, 2].tobytes() + row[:, 1].tobytes() + row[:, 0].tobytes()
            f.write(struct.pack("<i", y) + struct.pack("<i", len(data)) + data)
        f.seek(offset_table_pos)
        f.write(struct.pack("<%dQ" % h, *offsets))
