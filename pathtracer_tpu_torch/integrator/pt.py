"""Integrator settings and what the path tracers share (the `PTSettings`
and helper part of `integrator/pt.py`).

The port's path tracers are the megakernel's regen loop
(`kernels/megakernel.py`: the fused, two-program, texture-feed and split
rounds) for the scenes in its gate, and the regen integrator without kernels
(`integrator/pt_regen.py`) for every scene: `renderer/persistent.py:
render_regen` picks between them. The XLA wavefront `pt_trace` is still to
be ported (ROADMAP §1 item 8). The light tracers are `kernels/lt_mega.py`
and the wavefront `integrator/lt.py:lt_trace`, bidirectional path tracing
`integrator/bdpt.py`; both wavefronts take `camera_ray` below.
`medium_aware` turns on the tracked-medium transport.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracer_tpu_torch.core import vecmath
from pathtracer_tpu_torch.core.bounds import BOUNDED_VISIBLE_RANGE, Bounds1D


@dataclasses.dataclass(frozen=True)
class PTSettings:
    """Static per-render integrator settings."""

    max_bounces: int = 8
    min_bounces: int = 1  # russian-roulette start index
    light_samples: int = 1
    russian_roulette: bool = True
    only_direct: bool = False
    medium_aware: bool = False
    hwss: bool = False  # hero-wavelength x4
    wavelength_bounds: Bounds1D = BOUNDED_VISIBLE_RANGE


HWSS_LANES = 4
MEDIUM_STACK_K = 4  # tracked-medium stack depth


def _stack_push(stack, med_id, do):
    """Insert med_id into the first empty (0) slot of each lane's medium
    stack where `do`; a full stack drops the push."""
    empty = stack == 0
    first = torch.argmax(empty.to(torch.int32), dim=-1)
    can = empty.any(dim=-1) & do & (med_id != 0)
    onehot = ((torch.arange(stack.shape[-1], device=stack.device)[None, :]
               == first[:, None]) & can[:, None])
    return torch.where(onehot, med_id[:, None].to(stack.dtype), stack)


def _stack_remove(stack, med_id, do):
    """Remove one occurrence of med_id from each lane's stack where `do`; a
    miss changes nothing."""
    match = ((stack == med_id[:, None]) & do[:, None]
             & (med_id != 0)[:, None])
    first = torch.argmax(match.to(torch.int32), dim=-1)
    any_match = match.any(dim=-1)
    onehot = ((torch.arange(stack.shape[-1], device=stack.device)[None, :]
               == first[:, None]) & any_match[:, None])
    return torch.where(onehot, torch.zeros_like(stack), stack)


def _frame_arrays(normal):
    t, b = vecmath.orthonormal_basis(normal)
    return t, b, normal


def camera_ray(camera, film_u, film_v, u1, u2, lam_hero):
    """A camera ray -> (o, d, tau). The port has the projective thin-lens
    camera only (the lens and panorama cameras are ROADMAP §1 item 10), so
    `lam_hero` is unused."""
    return camera.get_ray(film_u, film_v, u1, u2)


def camera_ray_hwss(camera, film_u, film_v, u1, u2, lam):
    """A camera ray for λ lanes lam [N, C] -> (o, d, tau, lane weights
    [N, C], pdf ratios [N, C]); a projective camera's ray is the same at
    every λ, so both are 1."""
    o, d, tau = camera_ray(camera, film_u, film_v, u1, u2, lam[..., 0])
    ones = torch.ones(lam.shape, dtype=torch.float32, device=lam.device)
    return o, d, tau, ones, ones


def sample_hero_wavelengths(u, bounds: Bounds1D, lanes: int):
    """The hero λ from the uniforms u [N] and its equally rotated companions
    wrapping the range -> [N, lanes] (the JAX function draws u from a
    key)."""
    offs = torch.arange(lanes, dtype=torch.float32, device=u.device) / lanes
    return bounds.lower + torch.remainder(u[:, None] + offs[None, :],
                                          1.0) * bounds.span
