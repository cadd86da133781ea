"""Port's correlation (the plain path on the CPU) against the JAX package's
jnp formulation, its Pallas kernel (interpret mode) and a naive loop.

Inputs come from a numpy seed and reach both packages as the same values.
Tolerance: f32, rtol 1e-5 and atol 1e-6 (the band of
tests/test_correlation.py); the sides differ only in the order of the
channel sum. The CUDA kernel itself runs only on the card, where
chip_smoke.py holds it against ``correlation_reference``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistent_depth_tpu.flow.correlation import (correlation as jax_corr,
                                                   correlation_pallas)
from consistent_depth_tpu_torch.flow import correlation as corr
from test_correlation import _naive

TOL = dict(rtol=1e-5, atol=1e-6)


def _features(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("max_disp", [4, 8, 20])
def test_matches_jax(max_disp):
    f1, f2 = _features((2, 9, 13, 16), seed=max_disp)
    got = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                           max_displacement=max_disp, stride=2).numpy()
    want = np.asarray(jax_corr(jnp.asarray(f1), jnp.asarray(f2),
                               max_displacement=max_disp, stride=2))
    r = max_disp // 2
    assert got.shape == (2, 9, 13, (2 * r + 1) ** 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("max_disp,block_h", [(4, 4), (8, 8)])
def test_matches_pallas_interpret(max_disp, block_h):
    f1, f2 = _features((2, 16, 12, 8), seed=1)
    got = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                           max_displacement=max_disp, stride=2).numpy()
    want = np.asarray(correlation_pallas(
        jnp.asarray(f1), jnp.asarray(f2), max_displacement=max_disp,
        stride=2, block_h=block_h, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("max_disp,stride", [(4, 2), (5, 2), (3, 1)])
def test_matches_naive(max_disp, stride):
    """Includes a max displacement that is not a multiple of the stride
    (r = 2, reach 4 of a padding of 5) and stride 1."""
    f1, f2 = _features((1, 8, 10, 4), seed=0)
    got = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                           max_displacement=max_disp, stride=stride).numpy()
    np.testing.assert_allclose(got, _naive(f1, f2, max_disp, stride), **TOL)


def test_strided_views():
    """channels_last activations pass in as NHWC views of NCHW tensors and
    give what contiguous NHWC tensors give."""
    f1, f2 = _features((2, 6, 7, 5), seed=3)
    views = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for f in (f1, f2)]
    plain = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    torch.testing.assert_close(corr.correlation(*views, 4), plain,
                               rtol=0, atol=0)
    transposed = [torch.from_numpy(f.transpose(0, 2, 1, 3).copy()).transpose(
        1, 2) for f in (f1, f2)]
    torch.testing.assert_close(corr.correlation(*transposed, 4), plain,
                               rtol=0, atol=0)


def test_cpu_takes_reference():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    f1, f2 = (torch.from_numpy(f) for f in _features((1, 5, 6, 3), seed=2))
    before = corr.launches
    torch.testing.assert_close(corr.correlation(f1, f2, 4, 2),
                               corr.correlation_reference(f1, f2, 4, 2),
                               rtol=0, atol=0)
    assert corr.launches == before


def test_rejects_bad_arguments():
    f1, f2 = (torch.from_numpy(f) for f in _features((1, 5, 6, 3), seed=2))
    with pytest.raises(ValueError):
        corr.correlation(f1, f2[:, :4])
    with pytest.raises(ValueError):
        corr.correlation(f1, f2, max_displacement=4, stride=0)
    with pytest.raises(ValueError):
        corr.correlation(f1.to("meta"), f2.to("meta"))
