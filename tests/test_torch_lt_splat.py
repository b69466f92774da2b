"""The LT megakernel's film splat on the CPU, through the plain twins
(`kernels/lt_mega.py`): the gem light-traced by v2 at 1 and 2 camera
samples, and the HDR blob by v1 (the spawn feed). Each round's K12-LT and
K34-LT rows are recorded as `lt_trace_mega` runs. The film equals the
`index_add_` of the rounds' valid splat entries alone (those with a non-zero
pixel id or XYZ) bit for bit, and so equals the `index_add_` of every entry:
the empty rows, which add +0.0 to pixel 0, change nothing, which is what
lets the CUDA kernels skip them. With tracing on, `splat_slots` counts
(camera samples + 2) x n_pad entries a round and `splats_added` the valid
ones."""

import pytest
import torch

from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.camera import make_projective_camera
from pathtracer_tpu_torch.core import spectral
from pathtracer_tpu_torch.integrator.lt import LTSettings
from pathtracer_tpu_torch.kernels import lt_mega as lt
from pathtracer_tpu_torch.kernels import megakernel as mk
from pathtracer_tpu_torch.parsing import SceneBuilder
from pathtracer_tpu_torch.utils import profile

from lt_splat_helpers import record_rounds, splat_entries

torch.set_num_threads(2)

W, PPP = 16, 2
CASES = {"gem_v2_cs1": ("gem_cornell", "CORNELL_CAMERA", 1, "v2"),
         "gem_v2_cs2": ("gem_cornell", "CORNELL_CAMERA", 2, "v2"),
         "hdri_v1": ("hdri_blob", "SPHERE_CAMERA", 1, "v1")}


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request):
    recipe, cam, cs, route = CASES[request.param]
    world = getattr(scenes, recipe)(SceneBuilder(), spectral).build("cpu")
    camera = make_projective_camera(**getattr(scenes, cam), device="cpu")
    s = LTSettings(max_bounces=3, camera_samples=cs, stratified=True)
    unif = mk.TorchUniforms(torch.Generator().manual_seed(15))
    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        rounds = record_rounds(mp)
        with profile.tracing() as rec:
            film, _ = lt.lt_trace_mega(world, camera, s, W, W, W * W * PPP,
                                       unif, device="cpu", stats=stats)
    rec.resolve()
    assert stats["lt_round"] == route and len(rounds) == stats["rounds"]
    return cs, route == "v2", film, rounds, rec


def test_film_is_the_index_add_of_the_valid_splats(traced):
    cs, v2, film, rounds, _ = traced
    pid, xyz = splat_entries(rounds, cs, v2)
    valid = (pid != 0) | (xyz != 0).any(1)
    assert 0 < int(valid.sum()) < pid.shape[0]
    assert (xyz[~valid] == 0).all() and (pid[~valid] == 0).all()
    alone = torch.zeros_like(film).index_add_(0, pid[valid].long(),
                                              xyz[valid])
    every = torch.zeros_like(film).index_add_(0, pid.long(), xyz)
    assert torch.equal(film, alone) and torch.equal(film, every)
    assert float(film[:, 1].sum()) > 0


def test_splat_counters(traced):
    cs, v2, _, rounds, rec = traced
    n_pad = rounds[0][1].shape[1]
    assert n_pad % mk.TILE == 0
    assert rec.values("splat_slots") == [(cs + 2) * n_pad] * len(rounds)
    pid, xyz = splat_entries(rounds, cs, v2)
    assert pid.shape[0] == rec.total("splat_slots")
    valid = (pid != 0) | (xyz != 0).any(1)
    added = rec.values("splats_added")
    assert len(added) == len(rounds)
    assert rec.total("splats_added") == int(valid.sum()) > 0
