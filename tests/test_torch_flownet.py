"""Port's FlowNet family against the JAX package's, on the same weights.

Weights are random numpy values on the JAX modules' parameter shapes
(from ``jax.eval_shape``, so no JAX init runs), with non-zero biases, and
reach the port through ``torch_import.state_dict_for_module``. One JAX
FlowNet2 tree (162.5 M parameters) is built per module; the FlowNet2CSS
tree is its flownetc/flownets_1/flownets_2 subset. Inputs come from a
numpy seed. Forward tolerance of the sub-networks: f32, rtol 1e-4 and
atol 1e-5 (the band of tests/test_flownet.py's twin tests). The cascades
scale flow by div_flow = 20 at each of their stages, so their absolute
band is relative to the flow's scale: atol 1e-4 * max |flow| (measured
gaps: 6e-6 to 8e-6 of max |flow|).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistent_depth_tpu.flow import flownet as jax_flownet
from consistent_depth_tpu.models import torch_import as jax_torch_import
from consistent_depth_tpu_torch.flow import flownet
from consistent_depth_tpu_torch.flow.runner import TorchFlowBackend
from consistent_depth_tpu_torch.models import layers, torch_import

TOL = dict(rtol=1e-4, atol=1e-5)
SIZE = (64, 128)


def random_variables(module, *inputs, seed=0):
    """Numpy variables of ``module``'s shapes: kernels normal / sqrt(fan
    in), biases normal * 0.1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = math.prod(leaf.shape[:-1])
            v = rng.standard_normal(leaf.shape, np.float32) / np.sqrt(fan_in)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape, np.float32)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_jax(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def port_module(module, variables):
    sd = torch_import.state_dict_for_module(variables, module)
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval().to(memory_format=torch.channels_last)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def flownet2_variables():
    x = jnp.zeros((1, *SIZE, 3))
    return random_variables(jax_flownet.FlowNet2(), x, x, seed=7)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return (rng.random((1, *SIZE, 3), np.float32),
            rng.random((1, *SIZE, 3), np.float32))


def _assert_flows_close(t_flows, j_flows):
    assert len(t_flows) == len(j_flows)
    for t, j in zip(t_flows, j_flows):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(j), **TOL)


def test_flownets_matches_jax():
    x = np.random.default_rng(3).random((1, 64, 64, 12), np.float32)
    model = jax_flownet.FlowNetS()
    variables = random_variables(model, jnp.asarray(x), seed=1)
    net = port_module(flownet.FlowNetS(), variables)
    with torch.no_grad():
        got = net(nchw(x))
    _assert_flows_close(got, model.apply(to_jax(variables), jnp.asarray(x)))


def test_flownetc_matches_jax():
    rng = np.random.default_rng(4)
    x1, x2 = (rng.random((1, *SIZE, 3), np.float32) for _ in range(2))
    model = jax_flownet.FlowNetC(max_displacement=8, corr_stride=2)
    variables = random_variables(model, jnp.asarray(x1), jnp.asarray(x2),
                                 seed=2)
    net = port_module(flownet.FlowNetC(max_displacement=8, corr_stride=2),
                      variables)
    assert net.conv3_1[0].in_channels == 32 + 9 * 9
    with torch.no_grad():
        got = net(nchw(x1), nchw(x2))
    _assert_flows_close(got, model.apply(
        to_jax(variables), jnp.asarray(x1), jnp.asarray(x2)))


def test_flownetsd_matches_jax():
    x = np.random.default_rng(5).random((1, 64, 64, 6), np.float32)
    model = jax_flownet.FlowNetSD()
    variables = random_variables(model, jnp.asarray(x), seed=3)
    net = port_module(flownet.FlowNetSD(), variables)
    with torch.no_grad():
        got = net(nchw(x))
    _assert_flows_close(got, model.apply(to_jax(variables), jnp.asarray(x)))


def test_flownetfusion_matches_jax():
    x = np.random.default_rng(6).random((1, 32, 32, 11), np.float32)
    model = jax_flownet.FlowNetFusion()
    variables = random_variables(model, jnp.asarray(x), seed=4)
    net = port_module(flownet.FlowNetFusion(), variables)
    with torch.no_grad():
        got = net(nchw(x))
    _assert_flows_close([got], [model.apply(to_jax(variables),
                                            jnp.asarray(x))])


@pytest.mark.parametrize("full", [False, True], ids=["css", "full"])
def test_flownet2_matches_jax(flownet2_variables, images, full):
    params = flownet2_variables["params"]
    if full:
        model, net = jax_flownet.FlowNet2(), flownet.FlowNet2()
        variables = flownet2_variables
    else:
        model, net = jax_flownet.FlowNet2CSS(), flownet.FlowNet2CSS()
        variables = {"params": {k: params[k] for k in
                                ("flownetc", "flownets_1", "flownets_2")}}
    im1, im2 = images
    want = np.asarray(jax.jit(model.apply)(
        to_jax(variables), jnp.asarray(im1), jnp.asarray(im2)))
    net = port_module(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == (1, *SIZE, 2)
    assert np.abs(want).max() > 1.0      # a flow that is not trivially 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_flow_warp_semantics():
    img = torch.arange(12, dtype=torch.float32).reshape(1, 1, 3, 4)
    # shift right by 1: output[x] = img[x+1]; the rightmost reads out -> 0
    flow = torch.zeros((1, 2, 3, 4))
    flow[:, 0] = 1.0
    out = flownet.flow_warp(img, flow)[0, 0].numpy()
    expect = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_allclose(out[:, :3], expect[:, 1:])
    np.testing.assert_allclose(out[:, 3], 0.0)


def test_flow_warp_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.random((2, 9, 13, 3), np.float32)
    flow = (rng.standard_normal((2, 9, 13, 2)) * 4).astype(np.float32)
    want = np.asarray(jax_flownet.flow_warp(jnp.asarray(img),
                                            jnp.asarray(flow)))
    got = flownet.flow_warp(nchw(img), nchw(flow)).permute(0, 2, 3, 1)
    assert (want == 0).all(-1).any()     # some reads fall outside
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_channel_norm():
    x = torch.tensor([3.0, 4.0]).reshape(1, 2, 1, 1)
    assert float(flownet.channel_norm(x)) == pytest.approx(5.0)


def test_state_dict_for_module_loads_strict(flownet2_variables):
    net = flownet.FlowNet2()
    sd = torch_import.state_dict_for_module(flownet2_variables, net)
    assert sd.keys() == net.state_dict().keys()
    for key in ("flownetc.conv1.0.weight", "flownets_1.conv3_1.0.weight",
                "flownets_d.inter_conv5.0.weight",
                "flownetfusion.predict_flow0.weight",
                "flownetc.upsampled_flow6_to_5.weight"):
        assert key in sd
    # conv HWIO -> OIHW, transposed conv (kh, kw, O, I) -> (I, O, kh, kw)
    params = flownet2_variables["params"]
    np.testing.assert_array_equal(
        sd["flownets_1.conv3_1.0.weight"],
        params["flownets_1"]["conv3_1_0"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["flownetc.deconv4.0.weight"].shape == (1026, 256, 4, 4)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in sd.items()}, strict=True)
    with pytest.raises(KeyError):
        torch_import.state_dict_for_module(
            {"params": {k: v for k, v in params.items()
                        if k != "flownets_d"}}, net)


def test_both_key_spellings_load(flownet2_variables, tmp_path):
    """A released checkpoint (``flownets_1.conv3_1.0.weight``, here the
    port module's own state_dict) and a ``.pth`` the JAX package wrote
    (``flownets.1.conv3.1.0.weight``) load to the same weights, and both
    auto-select the full network; without SD/fusion keys the backend
    builds the C->S->S cascade."""
    want = torch_import.state_dict_for_module(flownet2_variables,
                                              flownet.FlowNet2())
    released = str(tmp_path / "released.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in want.items()}, released)
    jax_written = str(tmp_path / "jax.pth")
    jax_torch_import.save_torch_checkpoint(jax_written, flownet2_variables)
    assert "flownets.1.conv3.1.0.weight" in torch.load(jax_written)

    for path in (released, jax_written):
        backend = TorchFlowBackend(checkpoint=path, homography=False,
                                   device="cpu")
        assert isinstance(backend.net, flownet.FlowNet2)
        got = backend.net.state_dict()
        assert got.keys() == want.keys()
        for k in ("flownets_1.conv3_1.0.weight",
                  "flownetfusion.predict_flow0.bias",
                  "flownetc.upsampled_flow6_to_5.weight"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])

    css = str(tmp_path / "css.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in want.items()
                if not k.startswith(("flownets_d.", "flownetfusion."))}, css)
    backend = TorchFlowBackend(checkpoint=css, device="cpu")
    assert type(backend.net) is flownet.FlowNet2CSS


def test_init_parameters_leaves_no_uninitialised_weight():
    """On the meta-device build path every parameter is written by
    init_parameters, ConvTranspose2d's included, with lecun-normal spread
    (std 1/sqrt(fan in), fan in kh * kw * O for a transposed conv)."""
    with torch.device("meta"):
        net = flownet.FlowNetFusion()
    net = net.to_empty(device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(float("nan"))
    layers.init_parameters(net, torch.Generator().manual_seed(0))
    for name, p in net.named_parameters():
        assert torch.isfinite(p).all(), name
    w = net.deconv1[0].weight                          # (128, 32, 4, 4)
    assert w.shape == (128, 32, 4, 4)
    assert abs(float(w.std()) * math.sqrt(4 * 4 * 32) - 1.0) < 0.05
    assert float(net.deconv1[0].bias.abs().max()) == 0.0
    u = net.upsampled_flow1_to_0.weight                # (2, 2, 4, 4)
    bound = 2.0 / 0.87962566103423978 / math.sqrt(4 * 4 * 2)
    assert float(u.abs().max()) <= bound + 1e-6


def test_seeded_backend_is_deterministic():
    a = TorchFlowBackend(checkpoint=None, full=False, seed=1, device="cpu")
    b = TorchFlowBackend(checkpoint=None, full=False, seed=1, device="cpu")
    for (k, v), w in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(v, w), k
    assert torch.isfinite(a.net.flownetc.deconv5[0].weight).all()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TorchFlowBackend(checkpoint=str(tmp_path / "absent.pth"),
                         device="cpu")
