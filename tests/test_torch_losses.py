"""The port's loss chain against the JAX package's: camera geometry, the
geometric consistency loss with its ``valid`` mask, the parameter and
joint losses, as values and as gradients with respect to the depths, and
the bilinear sampler's three gradients.

All in f32 on the same numpy inputs. Loss values and depth gradients:
rtol = 1e-5 (atol 1e-6 for the gradients, whose entries reach 1e-4 of
their largest); geometry: rtol = atol = 1e-5. The sampler's arithmetic is
the JAX reference formulation's: its gradients agree to rtol = atol = 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import synthetic
from consistent_depth_tpu.ops import geometry as jax_geometry
from consistent_depth_tpu.ops import losses as jax_losses
from consistent_depth_tpu.ops import resample as jax_resample
from consistent_depth_tpu_torch.ops import geometry, losses, resample

TOL_GEO = dict(rtol=1e-5, atol=1e-5)
TOL_SAMPLER = dict(rtol=1e-6, atol=1e-6)


def _rotation(rng, angle):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _batch(seed=0, B=3, H=12, W=16):
    """A pair batch with rotated, translated cameras and depths in
    [1, 3]."""
    rng = np.random.default_rng(seed)
    extr = np.zeros((B, 2, 3, 4))
    for b in range(B):
        for k in range(2):
            extr[b, k, :, :3] = _rotation(rng, 0.05)
            extr[b, k, :, 3] = rng.normal(0, 0.1, 3)
    intr = np.stack([np.array([1.2 * W, 1.1 * W, W / 2, H / 2])
                     + rng.normal(0, 0.5, 4) for _ in range(B * 2)])
    return {
        "depths": rng.uniform(1, 3, (B, 2, H, W)).astype(np.float32),
        "intrinsics": intr.reshape(B, 2, 4).astype(np.float32),
        "extrinsics": extr.astype(np.float32),
        "flows": (rng.standard_normal((B, 2, H, W, 2)) * 2).astype(
            np.float32),
        "masks": (rng.random((B, 2, H, W)) > 0.2).astype(np.float32),
    }


ARGS = ("intrinsics", "extrinsics", "flows", "masks")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_geometry_matches_jax():
    d = _batch()
    intr, extr, depths = d["intrinsics"], d["extrinsics"], d["depths"]
    H, W = depths.shape[-2:]
    pixels = np.asarray(jax_geometry.pixel_grid((H, W)))
    pts = jax_geometry.pixels_to_points(jnp.asarray(intr), jnp.asarray(depths),
                                        jnp.asarray(pixels))
    cases = [
        (geometry.focal_length(_t(intr)), jax_geometry.focal_length(intr)),
        (geometry.principal_point(_t(intr)),
         jax_geometry.principal_point(intr)),
        (geometry.pixels_to_rays(_t(pixels), _t(intr)),
         jax_geometry.pixels_to_rays(jnp.asarray(pixels), jnp.asarray(intr))),
        (geometry.pixels_to_points(_t(intr), _t(depths), _t(pixels)), pts),
        (geometry.depth_to_points(_t(depths), _t(intr)),
         jax_geometry.depth_to_points(jnp.asarray(depths), jnp.asarray(intr))),
        (geometry.project(_t(np.asarray(pts)), _t(intr)),
         jax_geometry.project(pts, jnp.asarray(intr))),
        (geometry.reproject_points(_t(np.asarray(pts[:, 0])), _t(extr[:, 0]),
                                   _t(extr[:, 1])),
         jax_geometry.reproject_points(pts[:, 0], jnp.asarray(extr[:, 0]),
                                       jnp.asarray(extr[:, 1]))),
    ]
    for got, want in cases:
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_GEO)


def _jax_value_and_grad(fn, d, **kw):
    def f(depths):
        loss, batch = fn(depths, *(jnp.asarray(d[k]) for k in ARGS), **kw)
        return loss, batch

    (loss, batch), g = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(d["depths"]))
    return float(loss), {k: np.asarray(v) for k, v in batch.items()}, \
        np.asarray(g)


def _port_value_and_grad(fn, d, **kw):
    depths = _t(d["depths"]).requires_grad_(True)
    loss, batch = fn(depths, *(_t(d[k]) for k in ARGS), **kw)
    loss.backward()
    return float(loss), {k: v.detach().numpy() for k, v in batch.items()}, \
        depths.grad.numpy()


def _assert_same(port, jax_out):
    (l_p, b_p, g_p), (l_j, b_j, g_j) = port, jax_out
    np.testing.assert_allclose(l_p, l_j, rtol=1e-5)
    assert b_p.keys() == b_j.keys()
    for k in b_j:
        np.testing.assert_allclose(b_p[k], b_j[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_p, g_j, rtol=1e-5,
                               atol=1e-6 * np.abs(g_j).max())


@pytest.mark.parametrize("weights", [
    (0.1, 1.0), (0.0, 1.0), (1.0, 0.0)], ids=["mc", "reproj", "disp"])
@pytest.mark.parametrize("valid", [None, (1.0, 1.0, 0.0)],
                         ids=["novalid", "valid"])
def test_consistency_loss_matches_jax(weights, valid):
    d = _batch(seed=1)
    kw_j = dict(weights=jax_losses.LossWeights(*weights))
    kw_p = dict(weights=losses.LossWeights(*weights))
    if valid is not None:
        kw_j["valid"] = jnp.asarray(valid, jnp.float32)
        kw_p["valid"] = torch.tensor(valid)
    _assert_same(_port_value_and_grad(losses.consistency_loss, d, **kw_p),
                 _jax_value_and_grad(jax_losses.consistency_loss, d, **kw_j))


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"a.weight": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
            "a.bias": rng.standard_normal(4).astype(np.float32),
            "b.weight": rng.standard_normal((2, 4)).astype(np.float32)}


def test_parameter_loss_matches_jax():
    p, p0 = _params(2), _params(3)
    total, batch = losses.parameter_loss(
        {k: _t(v) for k, v in p.items()}, {k: _t(v) for k, v in p0.items()},
        0.5)
    want, want_batch = jax_losses.parameter_loss(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, p0), 0.5)
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)
    assert tuple(batch["parameter_loss"].shape) == (1, 1)
    np.testing.assert_allclose(batch["parameter_loss"].numpy(),
                               np.asarray(want_batch["parameter_loss"]),
                               rtol=1e-6)


def test_joint_loss_matches_jax():
    d = _batch(seed=4)
    p, p0 = _params(5), _params(6)
    valid = (1.0, 0.0, 1.0)
    _assert_same(
        _port_value_and_grad(
            losses.joint_loss, d, weights=losses.LossWeights(0.1, 1.0, 0.01),
            params={k: _t(v) for k, v in p.items()},
            params_init={k: _t(v) for k, v in p0.items()},
            valid=torch.tensor(valid)),
        _jax_value_and_grad(
            jax_losses.joint_loss, d,
            weights=jax_losses.LossWeights(0.1, 1.0, 0.01),
            params=jax.tree_util.tree_map(jnp.asarray, p),
            params_init=jax.tree_util.tree_map(jnp.asarray, p0),
            valid=jnp.asarray(valid, jnp.float32)))


def test_exact_depth_has_zero_loss():
    """With ground-truth depths and exact flows both loss terms are ~0,
    and a perturbed depth is clearly worse (tests/test_engine.py's check,
    on the port)."""
    scene = synthetic.make_scene(num_frames=6, H=32, W=48)
    data = synthetic.build_pair_arrays(scene, synthetic.make_pairs(6))
    args = [_t(data[k]) for k in ARGS]
    depths = _t(scene["depths"][data["pair_ids"]])
    loss, _ = losses.consistency_loss(depths, *args, losses.LossWeights())
    assert float(loss) < 1e-3, float(loss)
    loss_bad, _ = losses.consistency_loss(depths * 1.2, *args,
                                          losses.LossWeights())
    assert float(loss_bad) > 10 * max(float(loss), 1e-6)


# -- the sampler's gradients --------------------------------------------

def _sampler_inputs(seed, B=2, H=7, W=9, C=2):
    rng = np.random.default_rng(seed)
    data = rng.random((B, H, W, C), np.float32)
    x = rng.uniform(-2, W + 1, (B, 5, 6)).astype(np.float32)
    y = rng.uniform(-2, H + 1, (B, 5, 6)).astype(np.float32)
    # exactly on the last column and row, where the position gradient is 0
    x[:, 0, 0], y[:, 0, 0] = W - 1, H - 1
    x[:, 0, 1], y[:, 0, 2] = W - 1, H - 1
    ct = rng.standard_normal((B, 5, 6, C)).astype(np.float32)
    return data, x, y, ct


@pytest.mark.parametrize("jax_fn", ["fast", "reference"])
def test_sampler_gradients_match_jax(jax_fn):
    data, x, y, ct = _sampler_inputs(seed=0)
    fn = (jax_resample._bilinear_fast if jax_fn == "fast"
          else jax_resample.bilinear_sample_pixels_reference)
    jax_resample.set_splat_enabled(False)

    def loss(d, xx, yy):
        return jnp.sum(jax.vmap(fn)(d, xx, yy) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(data), jnp.asarray(x), jnp.asarray(y))
    d_t, x_t, y_t = (_t(a).requires_grad_(True) for a in (data, x, y))
    (resample.bilinear_sample_pixels(d_t, x_t, y_t) * _t(ct)).sum().backward()
    for got, w, name in zip((d_t.grad, x_t.grad, y_t.grad), want,
                            ("data", "x", "y")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   err_msg=name, **TOL_SAMPLER)
    # the size-1 edge: no position gradient
    assert float(x_t.grad[0, 0, 0]) == 0.0 and float(y_t.grad[0, 0, 0]) == 0.0
    assert float(x_t.grad[1, 0, 1]) == 0.0 and float(y_t.grad[1, 0, 2]) == 0.0
    assert float(x_t.grad.abs().max()) > 0 and float(y_t.grad.abs().max()) > 0


@pytest.mark.parametrize("fn", ["sample_uv", "sample_uv_wh"])
def test_uv_sampler_gradients_match_jax(fn):
    """Both uv normalisations, (W-1, H-1) of the loss and (W, H) of the
    masks, with gradients to the data and to the uv coordinates."""
    data, x, y, ct = _sampler_inputs(seed=1)
    uv = np.stack([x, y], -1)
    jax_resample.set_splat_enabled(False)
    want = jax.grad(
        lambda d, u: jnp.sum(getattr(jax_resample, fn)(d, u) * ct),
        argnums=(0, 1))(jnp.asarray(data), jnp.asarray(uv))
    d_t, uv_t = _t(data).requires_grad_(True), _t(uv).requires_grad_(True)
    (getattr(resample, fn)(d_t, uv_t) * _t(ct)).sum().backward()
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(want[0]),
                               **TOL_SAMPLER)
    np.testing.assert_allclose(uv_t.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
