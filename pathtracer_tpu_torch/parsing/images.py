"""Image loaders for texture assets (counterpart of `parsing/images.py`):
PNG (surface textures) and Radiance HDR (HDR environments). Pure numpy; the
BMP and EXR loaders are ported with the parser (ROADMAP §1 item 13)."""

from __future__ import annotations

import numpy as np

from pathtracer_tpu_torch.tonemap.io_png import read_png


def srgb_to_linear(x):
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def load_png_rgba(path: str) -> np.ndarray:
    """PNG -> float32 [H, W, 4] in [0, 1] (sRGB-encoded values left as
    stored; grey fills R, G and B; alpha 1 where the file has none)."""
    img = read_png(path)
    img = (img / (65535.0 if img.dtype == np.uint16 else 255.0)).astype(
        np.float32)
    h, w, c = img.shape
    out = np.ones((h, w, 4), np.float32)
    out[..., :c] = img[..., :4]
    if c == 1:
        out[..., 1] = out[..., 2] = out[..., 0]
    elif c == 2:
        out[..., 1] = out[..., 2] = out[..., 0]
        out[..., 3] = img[..., 1]
    return out


def load_hdr_rgba(path: str, alpha_fill: float = 0.0) -> np.ndarray:
    """Radiance RGBE (.hdr) -> float32 [H, W, 4] linear (flat and new-style
    run-length scanlines; `-Y h +X w` orientation only)."""
    with open(path, "rb") as f:
        data = f.read()
    # the header ends at a blank line; the resolution line follows
    pos = data.index(b"\n\n") + 2
    res_end = data.index(b"\n", pos)
    res = data[pos:res_end].decode().split()
    if res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    pos = res_end + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count=count, offset=pos)
                        pos += count
                        x += count
        else:  # flat scanline
            rgbe[y] = np.frombuffer(data, np.uint8, count=w * 4,
                                    offset=pos).reshape(w, 4)
            pos += w * 4
    scale = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)  # 2^(e-128)/256
    out = np.ones((h, w, 4), np.float32)
    out[..., :3] = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[..., 3] = alpha_fill
    return out
