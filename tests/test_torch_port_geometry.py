"""Port geometry (prior_flow_tpu_torch.geometry) against the JAX package's
host grid builders and ERP helpers, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prior_flow_tpu.geometry import erp as jerp
from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.geometry import rotation as jrot
from prior_flow_tpu_torch.geometry import erp, grids, rotation


@pytest.mark.parametrize("H,W", [(64, 128), (128, 256), (512, 1024)])
def test_rotation_grids_match(H, W):
    """All eight grids equal the JAX bundle to 1e-6 (both are float64 numpy
    builds cast to float32)."""
    ref = jgrids.rotation_grids(H, W)
    got = grids.rotation_grids(H, W)
    assert got._fields == ref._fields
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        assert g.dtype == np.float32 and g.shape == r.shape, name
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=0, err_msg=name)


def test_identity_grid():
    np.testing.assert_array_equal(grids.identity_grid_on(8, 16, "cpu").numpy(),
                                  jgrids.identity_grid(8, 16))


def test_rotation_matrix_and_sample_grid():
    for theta in ([0.0, 0.0, -np.pi / 2], [0.3, -0.2, 0.7]):
        R = rotation.rotation_matrix(theta)
        np.testing.assert_allclose(R, jrot.rotation_matrix(theta), atol=0)
        np.testing.assert_allclose(rotation.make_sample_grid(16, 32, R),
                                   jrot.make_sample_grid(16, 32, R),
                                   atol=1e-6)


def test_rotation_grids_rejects_non_multiple_of_8():
    with pytest.raises(ValueError):
        grids.rotation_grids(60, 128)


def test_u_clip_and_flow_to_endpoint(rng):
    H, W = 8, 16
    u = rng.uniform(-40, 40, (2, H, W)).astype(np.float32)
    u[0, 0, :3] = [-W / 2, W / 2, -1e-8]
    np.testing.assert_allclose(erp.u_clip(torch.from_numpy(u), W).numpy(),
                               np.asarray(jerp.u_clip(jnp.asarray(u), W)),
                               atol=1e-5)
    start = jgrids.identity_grid(H, W)[None]
    flow = rng.uniform(-30, 30, (2, H, W, 2)).astype(np.float32)
    got = erp.flow_to_endpoint(torch.from_numpy(start), torch.from_numpy(flow),
                               H, W).numpy()
    ref = np.asarray(jerp.flow_to_endpoint(jnp.asarray(start),
                                           jnp.asarray(flow), H, W))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert got[..., 0].min() >= -0.5 and got[..., 0].max() < W - 0.5
    assert got[..., 1].min() >= -0.5 and got[..., 1].max() <= H - 0.5
