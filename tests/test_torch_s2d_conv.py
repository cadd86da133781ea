"""Port's same_conv (plain path on the CPU) against the JAX package's Pallas
s2d conv (interpret mode) and its XLA conv, and SameConv2d's routing.

The cases are the hourglass's conv classes (stem, inception branches,
merged heads) at a small spatial size. Inputs come from a numpy seed and
reach both packages as the same values. Tolerance: f32, rtol = atol = 2e-5
(the band of tests/test_s2d_pallas.py); the two sides differ only in
summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu.ops.s2d_conv import s2d_conv_pallas
from consistent_depth_tpu_torch.models import hourglass, layers
from consistent_depth_tpu_torch.ops import s2d_conv

TOL = dict(rtol=2e-5, atol=2e-5)

# (k, Ci, Co): stem, _A branches, merged heads, and branches of _B, _BA,
# _BB, _BC, _D/_E, _F
CLASSES = [
    (7, 3, 128),
    (3, 64, 16), (7, 64, 16), (11, 64, 16),
    (3, 64, 2),
    (5, 32, 32), (11, 32, 16), (5, 64, 32), (11, 64, 32),
    (7, 32, 64), (11, 64, 64),
]


def _inputs(k, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 12, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(
        np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("k,ci,co", CLASSES)
def test_same_conv_matches_jax(k, ci, co, bias):
    x, w, b = _inputs(k, ci, co)
    got = s2d_conv.same_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b) if bias else None).numpy()
    pallas = np.asarray(s2d_conv_pallas(
        jnp.asarray(x), jnp.asarray(w), s=2, block_h=2))
    xla = np.asarray(jax_layers._conv_raw(
        jnp.asarray(w), jnp.asarray(x), 0, 1, (k - 1) // 2, 1))
    if bias:
        pallas, xla = pallas + b, xla + b
    assert got.shape == (2, 8, 12, co)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_same_conv_cpu_takes_reference():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing."""
    x, w, b = _inputs(3, 4, 5)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    before = s2d_conv.launches
    torch.testing.assert_close(s2d_conv.same_conv(*args),
                               s2d_conv.same_conv_reference(*args),
                               rtol=0, atol=0)
    assert s2d_conv.launches == before


def test_same_conv2d_routing():
    """Exactly the odd k >= 3 convs route to same_conv: 69 modules (stem,
    66 inception branches, two heads) of which one forward makes 68 calls
    (the heads run as one merged conv); the 1x1 convs stay on F.conv2d."""
    net = hourglass.HourglassModel()
    convs = [m for m in net.modules() if isinstance(m, layers.SameConv2d)]
    routed = [m for m in convs if m.routed]
    assert len(routed) == 69
    assert all(m.kernel_size[0] >= 3 and m.kernel_size[0] % 2 == 1
               for m in routed)
    assert all(m.kernel_size == (1, 1) for m in convs if not m.routed)
    assert len(convs) - len(routed) == 22 * 4  # four 1x1s per inception

    calls = []
    orig = s2d_conv.same_conv

    def recording(x, w, bias=None):
        calls.append(tuple(w.shape))
        return orig(x, w, bias)

    s2d_conv.same_conv = recording
    try:
        with torch.no_grad():
            net.eval()(torch.rand(1, 3, 16, 16))
    finally:
        s2d_conv.same_conv = orig
    assert len(calls) == 68
    assert calls[0] == (7, 7, 3, 128) and calls[-1] == (3, 3, 64, 2)
    assert all(shape[0] > 1 for shape in calls)


def test_same_conv2d_layouts():
    """SameConv2d on a channels_last NCHW tensor equals nn.Conv2d, for a
    routed k x k conv and a 1x1 conv."""
    g = torch.Generator().manual_seed(0)
    for k in (1, 5):
        conv = layers.SameConv2d(6, 4, k, padding=(k - 1) // 2)
        layers.init_parameters(conv, g)
        with torch.no_grad():
            conv.bias.uniform_(-1, 1, generator=g)
        plain = torch.nn.Conv2d(6, 4, k, padding=(k - 1) // 2)
        plain.load_state_dict(conv.state_dict())
        x = torch.rand(2, 6, 9, 7, generator=g).to(
            memory_format=torch.channels_last)
        with torch.no_grad():
            torch.testing.assert_close(conv(x), plain(x), rtol=2e-5,
                                       atol=2e-5)
