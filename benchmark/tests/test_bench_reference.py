"""The plain reference against the port on the CPU at a tiny size: the
networks with the benchmark's weights, and a whole run of each entry."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import program, runner, spec, weights
from benchmark.reference import common


def _both(name, seed=4):
    from consistent_depth_tpu_torch.models.registry import create_depth_model

    ref = spec.reference_module(name)
    config = spec.configs_of()[name]
    model = create_depth_model(config["model_type"], checkpoint="",
                               device="cpu")
    weights.make(model.net, seed, ref, config)
    net = ref.build()
    weights.make(net, seed, ref, config)
    return model, net, ref


@pytest.mark.parametrize("name,size", [("mc", (32, 48)), ("midas2", (64, 64))])
@pytest.mark.parametrize("train", [False, True])
def test_networks_agree(name, size, train):
    model, net, ref = _both(name)
    assert dict(model.net.state_dict()).keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(v, model.net.state_dict()[k].contiguous()), k
    images = torch.rand((2, 2, *size, 3), generator=torch.Generator()
                        .manual_seed(0))
    common.f32_policy()
    net.train(train)
    with torch.no_grad():
        got = model.apply(images, train=train)
        want = ref.depth(net, images)
    # summation order only (channels_last against contiguous NCHW)
    assert torch.allclose(got, want, rtol=2e-5, atol=0)


def test_rounding_moves_the_reference():
    ref = spec.reference_module("mc")
    net = ref.build()
    weights.make(net, 1, ref, spec.configs_of()["mc"])
    images = torch.rand((1, 1, 32, 48, 3))
    with torch.no_grad():
        f32 = ref.depth(common.set_rounding(net, None), images)
        tf32 = ref.depth(common.set_rounding(net, "tf32"), images)
    d_tf32 = program.log_depth_gap(tf32.numpy(), f32.numpy())
    assert 1e-4 < d_tf32 < 1


def test_rounding_moves_a_linear():
    lin = common.Linear(64, 32)
    x = torch.randn((8, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        f32 = common.set_rounding(lin, None)(x)
        assert torch.equal(f32, torch.nn.functional.linear(x, lin.weight,
                                                           lin.bias))
        tf32 = common.set_rounding(lin, "tf32")(x)
    gap = float((tf32 - f32).abs().max() / f32.abs().max())
    assert 1e-6 < gap < 1e-2
    # the backward's products take rounded operands too
    x.requires_grad_(True)
    common.set_rounding(lin, "tf32")(x).sum().backward()
    g_tf32 = x.grad.clone()
    x.grad = None
    common.set_rounding(lin, None)(x).sum().backward()
    assert not torch.equal(g_tf32, x.grad)


def test_rounding_moves_matmul_and_attention():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((2, 4, 16, 8), generator=g) for _ in range(3))
    assert torch.equal(common.matmul(q, k.transpose(-2, -1)),
                       q @ k.transpose(-2, -1))
    assert not torch.equal(common.matmul(q, k.transpose(-2, -1), "tf32"),
                           q @ k.transpose(-2, -1))
    f32 = common.attention(q, k, v)
    assert torch.equal(f32, torch.nn.functional.scaled_dot_product_attention(
        q, k, v))
    tf32 = common.attention(q, k, v, "tf32")
    assert 1e-6 < float((tf32 - f32).abs().max()) < 1e-2


CELLS = ["mc-finetune-f32", "midas2-finetune-f32", "mc-eval-f32"]


@pytest.mark.parametrize("name", CELLS)
def test_entry_against_reference(name, tiny_cell):
    """A whole run on the CPU: the window, the traced spans, and the
    check, which holds the port to the cell's own limits."""
    cell = tiny_cell(name)
    out = runner.run_cell(cell, 2 ** 31 + 11, 0.2, True, "cpu")
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
    assert out.result["correct"], out.result["checks"]
    assert out.record["units"] > 0 and out.record["flop"] > 0
