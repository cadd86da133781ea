"""Port's forward samplers, pixel grid and bilinear resize against the JAX
package's, on the same numpy inputs.

The samplers' arithmetic is the JAX reference formulation's, so they agree
to f32 rounding: rtol = atol = 1e-6. The resize is F.interpolate against
the JAX package's interpolation matmuls: rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu.ops import geometry as jax_geometry
from consistent_depth_tpu.ops import resample as jax_resample
from consistent_depth_tpu_torch.models import layers
from consistent_depth_tpu_torch.ops import geometry, resample

TOL = dict(rtol=1e-6, atol=1e-6)


def _data(seed=0, B=2, H=7, W=9, C=3):
    rng = np.random.default_rng(seed)
    data = rng.random((B, H, W, C), np.float32)
    # coordinates past every border, and exactly on the last row/column
    x = rng.uniform(-2, W + 1, (B, 5, 6)).astype(np.float32)
    y = rng.uniform(-2, H + 1, (B, 5, 6)).astype(np.float32)
    x[:, 0, 0], y[:, 0, 0] = W - 1, H - 1
    return data, x, y


def test_bilinear_sample_pixels_matches_jax():
    data, x, y = _data()
    want = np.asarray(jax.vmap(jax_resample.bilinear_sample_pixels)(
        jnp.asarray(data), jnp.asarray(x), jnp.asarray(y)))
    got = resample.bilinear_sample_pixels(
        torch.from_numpy(data), torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 5, 6, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bilinear_sample_pixels_nan_and_thin_images():
    """NaN coordinates give NaN, as in torch's grid_sample; a one-pixel
    wide image samples its only column."""
    data, x, y = _data(H=4, W=1)
    x[0, 1, 1] = np.nan
    got = resample.bilinear_sample_pixels(
        torch.from_numpy(data), torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(jax.vmap(jax_resample.bilinear_sample_pixels_reference)(
        jnp.asarray(data), jnp.asarray(x), jnp.asarray(y)))
    assert np.isnan(got[0, 1, 1].numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TOL)


@pytest.mark.parametrize("fn", ["grid_sample", "sample_uv", "sample_uv_wh"])
def test_samplers_match_jax(fn):
    data, x, y = _data(seed=1)
    if fn == "grid_sample":
        coords = np.stack([x / 9 * 2 - 1, y / 7 * 2 - 1], -1)
    else:
        coords = np.stack([x, y], -1)
    want = np.asarray(getattr(jax_resample, fn)(jnp.asarray(data),
                                                jnp.asarray(coords)))
    got = getattr(resample, fn)(torch.from_numpy(data),
                                torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_grid_sample_is_torch_grid_sample():
    """The semantics the JAX package reproduces: F.grid_sample with border
    padding and align_corners=False."""
    data, x, y = _data(seed=2)
    grid = torch.from_numpy(np.stack([x / 9 * 2 - 1, y / 7 * 2 - 1], -1))
    want = torch.nn.functional.grid_sample(
        torch.from_numpy(data).permute(0, 3, 1, 2), grid,
        padding_mode="border", align_corners=False).permute(0, 2, 3, 1)
    got = resample.grid_sample(torch.from_numpy(data), grid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_pixel_grid_matches_jax():
    want = np.asarray(jax_geometry.pixel_grid((3, 5)))
    got = geometry.pixel_grid((3, 5)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw,align", [((24, 36), False), ((3, 5), False),
                                          ((12, 17), True)])
def test_resize_bilinear_matches_jax(out_hw, align):
    x = np.random.default_rng(3).random((2, 6, 9, 2), np.float32)
    want = np.asarray(jax_layers.resize_bilinear(
        jnp.asarray(x), out_hw, align_corners=align))
    got = layers.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 out_hw, align_corners=align)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
