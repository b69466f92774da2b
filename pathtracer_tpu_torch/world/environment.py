"""Environment (counterpart of `world/environment.py`), constant kind only.

Sun and HDR environments, their importance map and the env feed are still
to be ported (ROADMAP); `world_from_numpy` refuses them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ENV_CONSTANT = 0  # the JAX package's kind code (Sun 1, HDR 2)


@dataclasses.dataclass
class Environment:
    kind: torch.Tensor  # i32
    strength: torch.Tensor  # f32
    curve_idx: torch.Tensor  # i32 — SPD of the constant environment
    rotation: torch.Tensor  # f32[3,3] world->env
    rotation_inv: torch.Tensor  # f32[3,3] env->world


def constant_env_numpy(curve_idx: int, strength: float) -> dict:
    """The numpy fields of a constant environment (`Environment` names)."""
    eye = np.eye(3, dtype=np.float32)
    return dict(kind=np.int32(ENV_CONSTANT), strength=np.float32(strength),
                curve_idx=np.int32(curve_idx), rotation=eye,
                rotation_inv=eye.copy())
