"""World: the flattened scene as torch tensors (counterpart of
`world/world.py`).

`world_from_numpy` is the single intake path: it takes the JAX `World`'s
leaves as numpy arrays under their JAX field names (`prims.pa`,
`mats.mtype`, `bank.values`, `env.kind`, `lights`, `n_lights`, ...) and
places them on a device; it takes Constant, Sun and HDR environments. The
port's own `SceneBuilder.build()` goes through it too. The medium table
(`mediums.*`) comes across whole.

`intersect` / `intersect_any` answer the closest-hit and shadow queries by
the dense sweep at every prim count (`geometry/soa.intersect_dense`: the
CUDA kernels of `kernels/csrc/dense_sweep.cu` on the card, walking
`sweep_tab`; the plain twins on the CPU, reading `dense_tab`). The JAX
package switches to its BVH above `DENSE_MAX_PRIMS`; the BVH and the
two-level accelerator are not part of the port yet (ROADMAP §1 items 9 and
13), so closest hits agree with the JAX package's up to ties between equal
t.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pathtracer_tpu_torch.core.spectral import CurveBank
from pathtracer_tpu_torch.geometry.soa import (
    Primitives,
    dense_table,
    intersect_any_dense,
    intersect_dense,
    sweep_table,
)
from pathtracer_tpu_torch.materials.tables import Materials
from pathtracer_tpu_torch.mediums.tables import Mediums
from pathtracer_tpu_torch.textures.texture import Textures
from pathtracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pathtracer_tpu_torch.world.environment import Environment

_GROUPS = (("prims", Primitives), ("mats", Materials), ("tex", Textures),
           ("bank", CurveBank), ("env", Environment), ("mediums", Mediums))
_TOP = ("lights", "n_lights", "env_sampling_probability", "center", "radius")
_HOST_FLOATS = ("bank.lam_lo", "bank.lam_hi")


def field_names() -> list:
    """Every World field the port keeps, under the JAX field names."""
    names = [f"{g}.{f.name}" for g, cls in _GROUPS
             for f in dataclasses.fields(cls)]
    return names + list(_TOP)


@dataclasses.dataclass
class World:
    prims: Primitives
    mats: Materials
    tex: Textures
    bank: CurveBank
    env: Environment
    mediums: Mediums
    lights: torch.Tensor  # i32[L_pad] prim indices tagged Light
    n_lights: torch.Tensor  # i32 actual count
    env_sampling_probability: torch.Tensor  # f32
    center: torch.Tensor  # f32[3] scene bound center
    radius: torch.Tensor  # f32 scene bound radius

    @functools.cached_property
    def dense_tab(self) -> torch.Tensor:
        """The packed dense table the plain twins read, packed once per
        World."""
        return dense_table(self.prims)

    @functools.cached_property
    def sweep_tab(self) -> torch.Tensor:
        """The compact sweep table the dense sweep kernels walk, packed once
        per World."""
        return sweep_table(self.prims)

    def intersect(self, o, d, t_min, t_max):
        """The closest hit of rays o, d [N, 3] in (t_min, t_max) [N] ->
        HitRecord. Raises NotImplementedError on a scene with per-prim
        transforms."""
        return intersect_dense(self.prims, o, d, t_min, t_max,
                               tab=self.dense_tab, sweep=self.sweep_tab)

    def intersect_any(self, o, d, t_min, t_max, live=None):
        """Whether anything blocks each ray within (t_min, t_max) ->
        bool[N]. With `live` (bool[N]) only the live lanes are swept; the
        others read False."""
        return intersect_any_dense(self.prims, o, d, t_min, t_max,
                                   tab=self.dense_tab, sweep=self.sweep_tab,
                                   live=live)

    def pick_random_light(self, u):
        """A uniform light pick per lane -> (prim index, pick pdf)."""
        nl = max(int(self.n_lights), 1)
        idx = torch.clamp((u * nl).to(torch.int32), max=nl - 1)
        return self.lights[idx.long()], float(np.float32(1.0) / np.float32(nl))

    def numpy_fields(self) -> dict:
        """The inverse of `world_from_numpy`."""
        out = {}
        for name in field_names():
            obj = self
            for part in name.split("."):
                obj = getattr(obj, part)
            out[name] = (obj.detach().cpu().numpy()
                         if isinstance(obj, torch.Tensor) else obj)
        return out


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.as_tensor(a.copy(), device=device)


def world_from_numpy(fields: dict, device=DEFAULT_DEVICE) -> World:
    """Build the port's `World` from numpy arrays keyed by JAX field name,
    on `device` (the card by default; raises without one)."""
    device = resolve_device(device)
    missing = [n for n in field_names() if n not in fields]
    if missing:
        raise KeyError(f"world_from_numpy: missing fields {missing}")
    groups = {}
    for g, cls in _GROUPS:
        kw = {}
        for f in dataclasses.fields(cls):
            name = f"{g}.{f.name}"
            kw[f.name] = (float(np.asarray(fields[name]))
                          if name in _HOST_FLOATS
                          else _tensor(fields[name], device))
        groups[g] = cls(**kw)
    top = {n: _tensor(fields[n], device) for n in _TOP}
    return World(**groups, **top)
