"""The port's plain dense sweep (twin of csrc/dense_sweep.cu's walks) against
the JAX package's Pallas sweep in interpret mode and its XLA
`intersect_dense`, on
5000 seeded rays through the chip scene and a random table with all four
prim types (including a triangle mesh whose neighbours share edges).
Hit and prim id must be exact and t within rtol 1e-5, atol 1e-5, as the JAX
package requires of its own kernel (tests/test_kernels_pallas.py:40-60)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer_tpu.core import spectral as jax_spectral
from pathtracer_tpu.geometry import intersect_any_dense, intersect_dense
from pathtracer_tpu.kernels import (
    pallas_intersect_any_dense,
    pallas_intersect_dense,
)
from pathtracer_tpu.parsing.builder import SceneBuilder as JaxBuilder
from pathtracer_tpu_torch import scenes
from pathtracer_tpu_torch.core import spectral as torch_spectral
from pathtracer_tpu_torch.kernels import dense
from pathtracer_tpu_torch.parsing import SceneBuilder as TorchBuilder

from torch_ref_helpers import both_worlds

torch.set_num_threads(2)

N_RAYS = 5000


def _random_worlds():
    kw = dict(seed=4, grid=6, n_each=10)
    return (scenes.random_prims(JaxBuilder(), jax_spectral, **kw).build(),
            scenes.random_prims(TorchBuilder(), torch_spectral,
                                 **kw).build("cpu"))


@pytest.fixture(scope="module", params=["chip", "random"])
def case(request):
    if request.param == "chip":
        jw, tw = both_worlds("chip")[:2]
    else:
        jw, tw = _random_worlds()
    p = tw.prims
    tab = torch.as_tensor(dense.pack_prims_np(
        p.ptype.numpy(), p.valid.numpy(), p.pa.numpy(), p.pb.numpy(),
        p.pc.numpy()))
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.2, 1.2, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(N_RAYS, 1e-6, np.float32)
    tmax = np.full(N_RAYS, 1e9, np.float32)
    tmax_any = rng.uniform(0.05, 1.5, N_RAYS).astype(np.float32)
    return jw.prims, tab, o, d, tmin, tmax, tmax_any


def _rays(o, d, tmin, tmax):
    return torch.as_tensor(np.ascontiguousarray(np.concatenate(
        [o.T, d.T, tmin[None], tmax[None]]), np.float32))


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_closest_matches_jax(case, ref):
    prims, tab, o, d, tmin, tmax, _ = case
    args = (prims, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
            jnp.asarray(tmax))
    hr = (pallas_intersect_dense(*args, interpret=True) if ref == "pallas"
          else intersect_dense(*args))
    out = dense.sweep_closest(_rays(o, d, tmin, tmax), tab).numpy()
    hit = np.asarray(hr.hit)
    np.testing.assert_array_equal(out[1] >= 0, hit)
    np.testing.assert_array_equal(out[1][hit].astype(np.int32),
                                  np.asarray(hr.prim_id)[hit])
    np.testing.assert_allclose(out[0][hit], np.asarray(hr.t)[hit],
                               rtol=1e-5, atol=1e-5)
    assert hit.mean() > 0.3
    assert np.isinf(out[0][~hit]).all()


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_any_matches_jax(case, ref):
    prims, tab, o, d, tmin, _, tmax_any = case
    args = (prims, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
            jnp.asarray(tmax_any))
    blocked = np.asarray(pallas_intersect_any_dense(*args, interpret=True)
                         if ref == "pallas" else intersect_any_dense(*args))
    out = dense.sweep_any(_rays(o, d, tmin, tmax_any), tab).numpy()
    np.testing.assert_array_equal(out[0] > 0.5, blocked)
    assert 0.05 < blocked.mean() < 0.95


def test_random_table_has_every_type(case):
    _, tab, *_ = case
    types = set(tab[:, 0][tab[:, 1] > 0.5].tolist())
    assert types <= {0.0, 1.0, 2.0, 3.0}
    if len(tab) > 32:
        assert types == {0.0, 1.0, 2.0, 3.0}


def test_wrapper_checks_and_counts():
    """CPU tensors take the plain twin (no launch counted); malformed
    inputs raise before any kernel could see them."""
    tab = torch.zeros((32, 128))
    rays = torch.zeros((8, 10))
    before = dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES
    assert dense.sweep_closest(rays, tab).shape == (2, 10)
    assert dense.sweep_any(rays, tab).shape == (1, 10)
    assert (dense.CLOSEST_LAUNCHES, dense.ANY_LAUNCHES) == before
    with pytest.raises(ValueError):
        dense.sweep_closest(torch.zeros((7, 10)), tab)
    with pytest.raises(ValueError):
        dense.sweep_closest(rays, torch.zeros((30, 128)))
    with pytest.raises(TypeError):
        dense.sweep_any(rays.double(), tab)
    with pytest.raises(ValueError):
        dense.sweep_any(torch.zeros((10, 8)).T, tab)
    # the lanes to sweep: bool [N] on the rays' device
    live = torch.arange(10) % 2 == 0
    assert dense.sweep_any(rays, tab, live=live).shape == (1, 10)
    with pytest.raises(TypeError, match="live"):
        dense.sweep_any(rays, tab, live=live.float())
    with pytest.raises(ValueError, match="live"):
        dense.sweep_any(rays, tab, live=live[:9])
