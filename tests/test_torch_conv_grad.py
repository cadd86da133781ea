"""The port's differentiable k x k conv: ``same_conv`` goes through one
``torch.autograd.Function`` whenever an input needs a gradient, its
grad-input is ``same_conv_grad_input`` (the plain version here on the CPU:
the same conv on the flipped, channel-swapped weight) and its grad-weight
is the library's wgrad.

Held against plain autograd of ``F.conv2d`` (f32, rtol = atol = 2e-5: only
summation orders differ), against ``torch.autograd.gradcheck`` in f64, and
against the JAX package's custom VJP ``layers._conv_pallas`` with its
Pallas kernel in interpret mode (rtol = atol = 2e-4, the band of
tests/test_s2d_pallas.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu_torch.models import hourglass, layers
from consistent_depth_tpu_torch.ops import s2d_conv

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_JAX = dict(rtol=2e-4, atol=2e-4)


def _inputs(k, ci, co, shape=(2, 9, 13), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, ci)).astype(dtype)
    w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(
        dtype)
    b = rng.standard_normal(co).astype(dtype)
    ct = rng.standard_normal((*shape, co)).astype(dtype)
    return [torch.from_numpy(a) for a in (x, w, b, ct)]


def test_same_conv_output_has_the_functions_grad_fn():
    """The repair: the conv records its own backward when an input needs
    a gradient (before, the CUDA path returned a tensor with no grad_fn),
    and records nothing under no_grad."""
    x, w, b, _ = _inputs(3, 4, 5)
    w.requires_grad_(True)
    y = s2d_conv.same_conv(x, w, b)
    assert type(y.grad_fn).__name__ == "_SameConvBackward"
    with torch.no_grad():
        assert s2d_conv.same_conv(x, w, b).grad_fn is None
    conv = layers.SameConv2d(4, 5, 3, padding=1)
    out = conv(x.permute(0, 3, 1, 2).requires_grad_(True))
    fns, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in fns:
            fns.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
    assert "_SameConvBackward" in fns


def test_gradcheck_f64():
    for k, ci, co in ((3, 3, 4), (5, 2, 3)):
        x, w, b, _ = _inputs(k, ci, co, shape=(1, 5, 6), dtype=np.float64)
        for t in (x, w, b):
            t.requires_grad_(True)
        assert torch.autograd.gradcheck(s2d_conv.same_conv, (x, w, b))


@pytest.mark.parametrize("ci,co", [(64, 16), (16, 64), (32, 32), (64, 2),
                                   (3, 128)])
@pytest.mark.parametrize("k", [3, 5, 7, 11])
def test_grads_match_plain_autograd(k, ci, co):
    """gx, gw and gb against autograd of F.conv2d. The 3 -> 128 class is
    the stem, whose input (the image) needs no gradient: no grad-input is
    computed for it."""
    x, w, b, ct = _inputs(k, ci, co)
    stem = ci == 3
    calls = []
    orig = s2d_conv.same_conv_grad_input

    def counting(ct_, w_):
        calls.append(tuple(ct_.shape))
        return orig(ct_, w_)

    xs, ws, bs = (x.clone().requires_grad_(not stem),
                  w.clone().requires_grad_(True), b.clone().requires_grad_(True))
    s2d_conv.same_conv_grad_input = counting
    try:
        (s2d_conv.same_conv(xs, ws, bs) * ct).sum().backward()
    finally:
        s2d_conv.same_conv_grad_input = orig
    xr, wr, br = (x.clone().requires_grad_(not stem),
                  w.clone().requires_grad_(True), b.clone().requires_grad_(True))
    ref = F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), br,
                   padding=(k - 1) // 2).permute(0, 2, 3, 1)
    (ref * ct).sum().backward()

    torch.testing.assert_close(ws.grad, wr.grad, **TOL)
    torch.testing.assert_close(bs.grad, br.grad, **TOL)
    if stem:
        assert xs.grad is None and calls == []
    else:
        torch.testing.assert_close(xs.grad, xr.grad, **TOL)
        assert calls == [tuple(ct.shape)]


def test_grad_input_reference_is_the_flip_formula():
    """same_conv_grad_input on the CPU is the JAX package's formula, and
    equals the transpose of the forward: <conv(x), ct> = <x, gx(ct)>."""
    x, w, _, ct = _inputs(5, 6, 7, seed=1)
    gx = s2d_conv.same_conv_grad_input(ct, w)
    assert gx.shape == x.shape
    lhs = float((s2d_conv.same_conv(x, w) * ct).double().sum())
    rhs = float((x * gx).double().sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


# (H, W, Ci, k, Co, s): tests/test_s2d_pallas.py's shapes
PALLAS_SHAPES = [
    (16, 32, 5, 7, 4, 2),
    (32, 32, 3, 7, 8, 4),
    (16, 16, 4, 11, 2, 2),
    (32, 64, 4, 5, 6, 2),
    (16, 32, 6, 7, 4, 2),
]


@pytest.mark.parametrize("H,W,Ci,k,Co,s", PALLAS_SHAPES)
def test_vjp_matches_jax_pallas(H, W, Ci, k, Co, s):
    rng = np.random.default_rng(1)
    p = (k - 1) // 2
    x = rng.standard_normal((2, H, W, Ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, Ci, Co)) * 0.1).astype(np.float32)
    ct = rng.standard_normal((2, H, W, Co)).astype(np.float32)

    jax_layers.set_pallas_s2d("force")
    try:
        gw_j, gx_j = jax.grad(
            lambda w_, x_: jnp.sum(
                jax_layers._conv_pallas((s, -1, -1, p), w_, x_) * ct),
            argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    finally:
        jax_layers.set_pallas_s2d(False)

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (s2d_conv.same_conv(xt, wt) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL_JAX)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), **TOL_JAX)


def test_merged_heads_send_gradients_to_both_heads():
    """The heads run as one conv over their concatenated weights; the
    gradient of that weight reaches pred_layer and uncertainty_layer.0 as
    two separate convs would give it."""
    g = torch.Generator().manual_seed(0)
    net = hourglass.HourglassModel()
    layers.init_parameters(net, g)
    x = torch.rand((2, 3, 16, 16), generator=g)
    ct_pred = torch.randn((2, 1, 16, 16), generator=g)
    ct_conf = torch.randn((2, 1, 16, 16), generator=g)
    pred, conf = net.train()(x)
    ((pred * ct_pred).sum() + (conf * ct_conf).sum()).backward()
    got = {n: p.grad.clone() for n, p in net.named_parameters()
           if n.startswith(("pred_layer", "uncertainty_layer"))}
    assert len(got) == 4 and all(v.abs().max() > 0 for v in got.values())

    net.zero_grad()
    feats = net.seq(x)
    unc = net.uncertainty_layer[0]
    pred = F.conv2d(feats, net.pred_layer.weight, net.pred_layer.bias,
                    padding=1)
    conf = torch.sigmoid(F.conv2d(feats, unc.weight, unc.bias, padding=1))
    ((pred * ct_pred).sum() + (conf * ct_conf).sum()).backward()
    for n, p in net.named_parameters():
        if n in got:
            torch.testing.assert_close(got[n], p.grad, **TOL)


def test_bf16_compute_with_f32_parameters():
    """A SameConv2d with f32 parameters computes a bf16 input in bf16 and
    returns f32 gradients to its parameters."""
    g = torch.Generator().manual_seed(0)
    conv = layers.SameConv2d(8, 4, 5, padding=2)
    layers.init_parameters(conv, g)
    x = torch.rand((1, 8, 6, 7), generator=g)
    y = conv(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert conv.weight.grad.dtype == torch.float32
    ref = F.conv2d(x.to(torch.bfloat16).float(),
                   conv.weight.detach().to(torch.bfloat16).float(),
                   conv.bias.detach(), padding=2)
    torch.testing.assert_close(y.float(), ref, rtol=2 ** -7, atol=2 ** -7)
