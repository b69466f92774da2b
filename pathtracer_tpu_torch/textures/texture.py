"""Spectral textures (counterpart of `textures/texture.py`), 1x1 layers only.

A texture is a stack of layers, each a weight map times one basis curve.
The port's builder accepts single-texel layers only: their weight is a
constant that the megakernel bake folds into the material table. The
uv-dependent evaluation (`eval_texture`) is still to be ported (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Textures:
    layer_start: torch.Tensor  # i32[T]
    layer_count: torch.Tensor  # i32[T]
    layer_curve: torch.Tensor  # i32[L] curve index per layer
    layer_offset: torch.Tensor  # i32[L] texel offset into atlas
    layer_w: torch.Tensor  # i32[L]
    layer_h: torch.Tensor  # i32[L]
    atlas: torch.Tensor  # f32[A] flattened row-major weight maps

    @property
    def count(self):
        return self.layer_start.shape[0]
