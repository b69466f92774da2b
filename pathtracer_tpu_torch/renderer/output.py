"""Film output: tonemap, then write EXR (linear) and PNG (display)
(counterpart of `renderer/output.py`)."""

from __future__ import annotations

import os

import numpy as np
import torch

from pathtracer_tpu_torch.core.cie import CHROMATICITIES
from pathtracer_tpu_torch.tonemap import tonemap_to_rgb, write_exr, write_png


def output_film(film_xyz, name: str, tonemapper, colorspace: str = "Rec709",
                premultiply: float = 1.0, output_dir: str = "output"):
    """Write {output_dir}/{name}.exr and .png -> (exr_path, png_path)."""
    os.makedirs(output_dir, exist_ok=True)
    film = torch.as_tensor(film_xyz, dtype=torch.float32).cpu()
    display, linear = tonemap_to_rgb(film, tonemapper, colorspace, premultiply)
    chroma = CHROMATICITIES.get(colorspace)
    exr_path = os.path.join(output_dir, f"{name}.exr")
    png_path = os.path.join(output_dir, f"{name}.png")
    write_exr(exr_path, linear.numpy().astype(np.float32),
              chromaticities=chroma)
    write_png(png_path, display.numpy(), chromaticities=chroma)
    return exr_path, png_path
