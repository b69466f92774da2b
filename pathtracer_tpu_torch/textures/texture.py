"""Spectral textures (counterpart of `textures/texture.py`).

A texture is a stack of layers, each a weight map times one basis curve:
eval(λ, uv) = Σ_layers weight_layer(uv) · curve_layer(λ). All weight maps
live row-major in one flat atlas; a texture is (layer_start, layer_count)
into the per-layer metadata, and a lookup clamps uv to [0, 1) and samples
the nearest texel. The megakernel bake folds 1x1 layers into its material
table; multi-texel maps are evaluated here (the HDR environment, and the
surface textures of the texture feed when their pair table is not baked).
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.core import spectral

MAX_LAYERS = 4  # layers per texture (Texture4)


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


def _layer_weight(tex: Textures, li, u, v):
    """Nearest texel of layer(s) `li` at (u, v). A NaN coordinate (the uv of
    a ray that hit nothing, which the wavefront integrators evaluate and
    then discard) reads texel 0 instead of indexing out of bounds."""
    w = tex.layer_w[li].long()
    h = tex.layer_h[li].long()
    u = torch.clamp(torch.nan_to_num(u), 0.0, 1.0 - 1e-6)
    v = torch.clamp(torch.nan_to_num(v), 0.0, 1.0 - 1e-6)
    x = torch.minimum((u * w.float()).long(), w - 1)
    y = torch.minimum((v * h.float()).long(), h - 1)
    return tex.atlas[tex.layer_offset[li].long() + y * w + x]


def eval_texture(tex: Textures, bank: spectral.CurveBank, tex_id, lam, u, v):
    """Σ_layers weight(u, v) · curve(λ) of texture `tex_id` (an int or a
    per-lane tensor) at per-lane λ and uv."""
    dev = lam.device
    tex_id = torch.as_tensor(tex_id, device=dev).long()
    tex_id, lam, u, v = torch.broadcast_tensors(tex_id, lam, u, v)
    n_layers = tex.layer_curve.shape[0]
    if n_layers == tex.layer_start.shape[0]:
        # every texture is one layer (a static shape condition)
        li = tex.layer_start[tex_id].long()
        return (_layer_weight(tex, li, u, v)
                * spectral.evaluate(bank, tex.layer_curve[li], lam))
    start = tex.layer_start[tex_id].long()
    count = tex.layer_count[tex_id].long()
    total = torch.zeros_like(lam)
    for k in range(MAX_LAYERS):
        li = torch.clamp(start + k, max=n_layers - 1)
        val = (_layer_weight(tex, li, u, v)
               * spectral.evaluate(bank, tex.layer_curve[li], lam))
        total = total + torch.where(k < count, val, 0.0)
    return total
