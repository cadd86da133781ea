"""The port's monodepth2 and MiDaS v2 backbones against the JAX package's, on
the CPU: the same seeded numpy inputs, the JAX weights carried across
(``torch_import.state_dict_from_jax_variables``; MiDaS's decoder keys
respelled by ``released_midas_keys``), BN running stats randomised so that
a fault in how eval mode uses them cannot hide behind the init values.

- the resizes at monodepth2's real shapes, bicubic 224x384 <-> 320x1024
  (rtol 1e-3, atol 2e-4, the band of tests/test_resize_fullsize.py: the
  JAX package's 1024-wide interpolation matmul sums in another order than
  torch's four taps) and the nearest 2x upsample (exact);
- ``Monodepth2Net`` at 64x96, all four scales, and a shallow MiDaS (one
  bottleneck per stage, built on the JAX side from the package's own
  ``bottleneck_layer``, ``FeatureFusionBlock`` and ``conv``, as
  tests/test_backbones.py does), eval and train-mode BN: outputs relative
  L2 <= 1e-5 and max |d| <= 1e-4 of max |ref|, BN running stats rtol =
  atol = 1e-5; ``ResNeXt101_32x8dFeatures``' four feature maps (shallow,
  eval-mode BN) against the shallow MiDaS's JAX encoder, in the same bands;
- the adapters' ``estimate_depth`` (monodepth2 at a 128x256 feed from
  48x80 frames; the shallow MiDaS at 64x96 with its output bias raised by
  5, tests/test_engine_backbones.py's taming, so that no depth is 1/0):
  depth rtol 1e-4;
- the full-depth state_dicts (ResNeXt-101 32x8d 3-4-23-3 with the 256-wide
  decoder, and the encoder alone; ResNet-18 with its decoder) on the meta
  device against the JAX package's ``eval_shape`` templates: the same
  keys, the same shapes;
- ``.pth`` crossing both ways, exact: a JAX-written file loads into the
  port and a port-written one into the JAX adapter, and monodepth2's
  released checkpoint directory (``encoder.pth`` with the feed size and
  ``use_stereo``, ``depth.pth``) into both, with its feed size.

Feeds stay at 64 rows and columns or more: below that the deepest feature
map is one pixel high and torch's reflection pad, unlike numpy's, refuses
it (the released feed is 320x1024).
"""

import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu.models import midas_v2 as jax_midas
from consistent_depth_tpu.models import monodepth2 as jax_monodepth2
from consistent_depth_tpu.models import torch_import as jax_torch_import
from consistent_depth_tpu.models.resnet import (
    ResNeXt101_32x8dFeatures as JaxResNeXt,
    bottleneck_layer as jax_bottleneck_layer)
from consistent_depth_tpu_torch.models import (
    layers, midas_v2, monodepth2, resnet, torch_import)

SHALLOW = (1, 1, 1, 1)
FEED = (128, 256)
TOL_OUT = 1e-5
TOL_MAX = 1e-4
TOL_STATS = dict(rtol=1e-5, atol=1e-5)


# -- the shallow MiDaS of both packages ----------------------------------------

class _JaxShallowEncoder(fnn.Module):
    """``MidasEncoder`` with ``blocks`` bottlenecks per stage."""

    blocks: tuple = SHALLOW

    @fnn.compact
    def __call__(self, x, train: bool):
        y = jax_layers.conv(64, 7, stride=2, padding=3, use_bias=False,
                            name="layer1_0")(x)
        y = jax_layers.TorchBatchNorm(name="layer1_1")(y, train)
        y = jax_layers.max_pool(fnn.relu(y), 3, 2, 1)
        g, wpg = 32, 8
        feats, c_in = [], 64
        for i, (prefix, c, stride) in enumerate((
                ("layer1_4", 256, 1), ("layer2", 512, 2),
                ("layer3", 1024, 2), ("layer4", 2048, 2))):
            y = jax_bottleneck_layer(y, train, g * wpg * 2 ** i, c,
                                     self.blocks[i], stride, g, prefix, c_in)
            feats.append(y)
            c_in = c
        return feats


class JaxShallowMidasNet(fnn.Module):
    """The JAX package's ``MidasNet`` on a shallow encoder."""

    @fnn.compact
    def __call__(self, x, train: bool = True):
        feats = _JaxShallowEncoder(name="pretrained")(x, train)
        rn = [jax_layers.conv(256, 3, padding=1, use_bias=False,
                              name=f"scratch_layer{i}_rn")(f)
              for i, f in enumerate(feats, 1)]
        path = jax_midas.FeatureFusionBlock(
            256, name="scratch_refinenet4")(rn[3])
        for i in (3, 2, 1):
            path = jax_midas.FeatureFusionBlock(
                256, name=f"scratch_refinenet{i}")(path, rn[i - 1])
        y = jax_layers.conv(128, 3, padding=1,
                            name="scratch_output_conv_0")(path)
        H, W = y.shape[1:3]
        y = jax_layers.resize_bilinear(y, (2 * H, 2 * W))
        y = fnn.relu(jax_layers.conv(32, 3, padding=1,
                                     name="scratch_output_conv_2")(y))
        y = jax_layers.conv(1, 1, name="scratch_output_conv_4")(y)
        return fnn.relu(y)[..., 0]


class JaxShallowMidas(jax_midas.MidasV2Model):
    def _make_module(self):
        return JaxShallowMidasNet()


class ShallowMidas(midas_v2.MidasV2Model):
    def _make_module(self):
        return midas_v2.MidasNet(blocks=SHALLOW)


# -- weights across ------------------------------------------------------------

def numpy_variables(variables):
    return jax.tree_util.tree_map(np.array, variables)


def randomize_batch_stats(variables, seed=0):
    """A copy of ``variables`` (numpy leaves) with random BN running
    stats."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else (
            rng.normal(0, 0.1, v.shape) if k == "mean"
            else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in tree.items()}

    return {**variables, "batch_stats": fill(variables["batch_stats"])}


def tame_midas(variables, by=5.0):
    """The output conv's bias raised by ``by``: a seeded MiDaS emits
    ReLU'd ~zero disparity, which depth = 1/disparity turns to inf."""
    params = dict(variables["params"])
    params["scratch_output_conv_4"] = {
        **params["scratch_output_conv_4"],
        "bias": params["scratch_output_conv_4"]["bias"] + np.float32(by)}
    return {**variables, "params": params}


def port_state_dict(variables):
    """The JAX variables (numpy leaves) as the port's state_dict, MiDaS's
    flat decoder keys respelled as released."""
    sd = torch_import.released_midas_keys(
        torch_import.state_dict_from_jax_variables(variables))
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_port(model, variables):
    model.net.load_state_dict(port_state_dict(variables), strict=True)
    return model


def jax_as_port_keys(variables):
    """The JAX package's own export of ``variables`` under the port's
    keys (numpy values)."""
    return torch_import.released_midas_keys(
        jax_torch_import.variables_to_state_dict(numpy_variables(variables)))


@pytest.fixture(scope="module")
def jax_midas_model():
    model = JaxShallowMidas(checkpoint="", seed=0)
    model.variables = randomize_batch_stats(numpy_variables(model.variables))
    return model


@pytest.fixture(scope="module")
def jax_monodepth2_model():
    model = jax_monodepth2.Monodepth2Model(checkpoint="", seed=0,
                                           feed_size=FEED)
    model.variables = randomize_batch_stats(numpy_variables(model.variables))
    return model


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= TOL_OUT and worst <= TOL_MAX, (rel, worst)


def _stats_close(net, mutated):
    want = torch_import.released_midas_keys(
        torch_import.state_dict_from_jax_variables(
            {"batch_stats": numpy_variables(mutated["batch_stats"])}))
    sd = net.state_dict()
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v, err_msg=k, **TOL_STATS)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("in_hw,out_hw", [((224, 384), (320, 1024)),
                                          ((320, 1024), (224, 384))])
def test_resize_bicubic_at_monodepth2_shapes(in_hw, out_hw):
    x = np.random.default_rng(0).random((1, *in_hw, 3), np.float32)
    want = np.asarray(jax_layers.resize_bicubic(jnp.asarray(x), out_hw))
    got = layers.resize_bicubic(torch.from_numpy(x).permute(0, 3, 1, 2),
                                out_hw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_upsample_nearest_2x_at_monodepth2_shapes():
    # the decoder's first upsample at the 320x1024 feed: 256 x 10 x 32
    x = np.random.default_rng(1).random((2, 10, 32, 256), np.float32)
    want = np.asarray(jax_layers.upsample_nearest_2x(jnp.asarray(x)))
    got = layers.upsample_nearest_2x(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# -- networks ----------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_monodepth2_net_matches_jax(jax_monodepth2_model, train):
    variables = jax_monodepth2_model.variables
    x = np.random.default_rng(2).random((2, 64, 96, 3), np.float32)
    out = jax_monodepth2_model.module.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
        train=train, mutable=["batch_stats"] if train else False)
    want, mutated = out if train else (out, None)
    model = load_port(monodepth2.Monodepth2Model(checkpoint="", device="cpu"),
                      variables)
    net = model.net.train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == [0, 1, 2, 3]
    for s in range(4):
        _close(got[s][:, 0].numpy(), np.asarray(want[s])[..., 0])
    if train:
        _stats_close(net, mutated)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shallow_midas_net_matches_jax(jax_midas_model, train):
    variables = jax_midas_model.variables
    x = np.random.default_rng(3).random((2, 64, 96, 3), np.float32)
    out = jax_midas_model.module.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
        train=train, mutable=["batch_stats"] if train else False)
    want, mutated = out if train else (out, None)
    model = load_port(ShallowMidas(checkpoint="", device="cpu"), variables)
    net = model.net.train(train)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.numpy(), np.asarray(want))
    if train:
        _stats_close(net, mutated)


def test_resnext_features_match_jax_encoder(jax_midas_model):
    """``ResNeXt101_32x8dFeatures`` (shallow) against the shallow MiDaS's
    JAX encoder with the same weights, eval-mode BN: its four feature maps
    within the nets' bands. MidasNet regroups the same modules under
    MiDaS's ``pretrained.layer{1..4}``."""
    variables = jax_midas_model.variables
    x = np.random.default_rng(5).random((2, 64, 96, 3), np.float32)
    want = _JaxShallowEncoder().apply(
        {k: jax.tree_util.tree_map(jnp.asarray, variables[k]["pretrained"])
         for k in ("params", "batch_stats")}, jnp.asarray(x), train=False)
    midas = load_port(ShallowMidas(checkpoint="", device="cpu"), variables)
    # pretrained.layer1.{0,1,4} are conv1, bn1 and layer1
    rename = {"layer1.0.": "conv1.", "layer1.1.": "bn1.",
              "layer1.4.": "layer1."}
    sd = {}
    for k, v in midas.net.pretrained.state_dict().items():
        head = next((a for a in rename if k.startswith(a)), None)
        sd[rename[head] + k[len(head):] if head else k] = v
    net = resnet.ResNeXt101_32x8dFeatures(blocks=SHALLOW).eval()
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))


@pytest.mark.parametrize("backbone", ["monodepth2", "midas2"])
def test_estimate_depth_matches_jax(jax_monodepth2_model, jax_midas_model,
                                    backbone):
    rng = np.random.default_rng(4)
    if backbone == "monodepth2":
        jmodel = jax_monodepth2_model
        variables = jmodel.variables
        port = monodepth2.Monodepth2Model(checkpoint="", device="cpu",
                                          feed_size=FEED)
        images = rng.random((1, 2, 48, 80, 3), np.float32)
    else:
        jmodel = jax_midas_model
        variables = tame_midas(jmodel.variables)
        port = ShallowMidas(checkpoint="", device="cpu")
        images = rng.random((1, 2, 64, 96, 3), np.float32)
    want, _ = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                           jnp.asarray(images), train=False)
    with torch.no_grad():
        got = load_port(port, variables).apply(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == images.shape[:4]
    want = np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("backbone", ["midas2", "monodepth2", "resnext101"])
def test_fullsize_state_dict_matches_jax(backbone):
    """The published architectures at full depth and width: every key and
    shape of the port's module against the JAX package's init template
    (``resnext101``: the encoder alone, under torchvision's names)."""
    if backbone == "midas2":
        jax_net, port_net = jax_midas.MidasNet(), midas_v2.MidasNet
    elif backbone == "resnext101":
        jax_net, port_net = JaxResNeXt(), resnet.ResNeXt101_32x8dFeatures
    else:
        jax_net, port_net = (jax_monodepth2.Monodepth2Net(),
                             monodepth2.Monodepth2Net)
    template = jax.eval_shape(lambda: jax_net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), template)
    want = {k: tuple(v.shape) for k, v in torch_import.released_midas_keys(
        torch_import.state_dict_from_jax_variables(zeros)).items()}
    with torch.device("meta"):
        net = port_net()
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want
    if backbone == "midas2":
        # ResNeXt-101 32x8d (3-4-23-3) and the 256-wide decoder
        assert len(net.pretrained.layer3) == 23
        assert got["pretrained.layer4.2.conv2.weight"] == (2048, 64, 3, 3)
        assert got["scratch.layer4_rn.weight"] == (256, 2048, 3, 3)
        assert sum(np.prod(s) for s in got.values()) > 100e6


# -- .pth crossing ------------------------------------------------------------

def _assert_same(sd, want):
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sd.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v, err_msg=k)


def test_midas_pth_crosses_both_ways(jax_midas_model, tmp_path):
    # a JAX-written .pth (flat decoder keys) into the port
    jax_file = str(tmp_path / "jax_midas.pth")
    jax_torch_import.save_torch_checkpoint(jax_file,
                                           jax_midas_model.variables)
    assert "scratch_layer1_rn.weight" in torch.load(jax_file)
    port = ShallowMidas(checkpoint=jax_file, device="cpu")
    _assert_same({k: v.numpy() for k, v in port.net.state_dict().items()},
                 jax_as_port_keys(jax_midas_model.variables))
    # a port-written .pth (released keys) of other weights into the JAX
    # adapter
    other = ShallowMidas(checkpoint="", seed=1, device="cpu")
    port_file = str(tmp_path / "port_midas.pth")
    torch_import.save_checkpoint(port_file, other.net.state_dict())
    assert "scratch.output_conv.0.weight" in torch.load(port_file)
    jmodel = JaxShallowMidas(checkpoint=port_file)
    _assert_same({k: v.numpy() for k, v in other.net.state_dict().items()},
                 jax_as_port_keys(jmodel.variables))


def test_monodepth2_pth_and_directory_cross_both_ways(jax_monodepth2_model,
                                                      tmp_path):
    variables = jax_monodepth2_model.variables
    want = jax_as_port_keys(variables)
    # a JAX-written single .pth into the port (its feed stays the default)
    jax_file = str(tmp_path / "jax_monodepth2.pth")
    jax_torch_import.save_torch_checkpoint(jax_file, variables)
    port = monodepth2.Monodepth2Model(checkpoint=jax_file, device="cpu")
    assert (port.feed_height, port.feed_width) == (320, 1024)
    _assert_same({k: v.numpy() for k, v in port.net.state_dict().items()},
                 want)
    # the released layout: a directory of encoder.pth (with the feed size)
    # and depth.pth, which both packages read
    ckpt = tmp_path / "monodepth2_mono+stereo_1024x320"
    ckpt.mkdir()
    sd = port_state_dict(variables)
    torch.save({**{k: v for k, v in sd.items() if k.startswith("encoder.")},
                "height": 96, "width": 192, "use_stereo": True},
               str(ckpt / "encoder.pth"))
    torch.save({k: v for k, v in sd.items() if k.startswith("decoder.")},
               str(ckpt / "depth.pth"))
    port = monodepth2.Monodepth2Model(checkpoint=str(ckpt), device="cpu",
                                      feed_size=FEED)
    assert (port.feed_height, port.feed_width) == (96, 192)
    _assert_same({k: v.numpy() for k, v in port.net.state_dict().items()},
                 want)
    jmodel = jax_monodepth2.Monodepth2Model(checkpoint=str(ckpt))
    assert (jmodel.feed_height, jmodel.feed_width) == (96, 192)
    _assert_same(want, jax_as_port_keys(jmodel.variables))
    # a port-written .pth of other weights into the JAX adapter
    other = monodepth2.Monodepth2Model(checkpoint="", seed=1, device="cpu")
    port_file = str(tmp_path / "port_monodepth2.pth")
    torch_import.save_checkpoint(port_file, other.net.state_dict())
    jmodel = jax_monodepth2.Monodepth2Model(checkpoint=port_file)
    _assert_same({k: v.numpy() for k, v in other.net.state_dict().items()},
                 jax_as_port_keys(jmodel.variables))


def test_monodepth2_released_directory_with_fc_loads(tmp_path):
    """monodepth2's released ``encoder.pth`` holds its whole torchvision
    ResNet-18, the classifier ``encoder.fc`` (1000, 512) included, which
    the depth network does not use: a directory that carries it loads the
    same weights as one without it (every other key strictly)."""
    sd = monodepth2.Monodepth2Model(checkpoint="", seed=0,
                                    device="cpu").net.state_dict()
    rng = np.random.default_rng(0)
    fc = {"encoder.fc.weight": torch.from_numpy(
              rng.standard_normal((1000, 512)).astype(np.float32)),
          "encoder.fc.bias": torch.from_numpy(
              rng.standard_normal(1000).astype(np.float32))}
    loaded = []
    for name, extra in (("plain", {}), ("released", fc)):
        ckpt = tmp_path / name
        ckpt.mkdir()
        torch.save({**{k: v for k, v in sd.items()
                       if k.startswith("encoder.")}, **extra,
                    "height": 64, "width": 128, "use_stereo": False},
                   str(ckpt / "encoder.pth"))
        torch.save({k: v for k, v in sd.items() if k.startswith("decoder.")},
                   str(ckpt / "depth.pth"))
        loaded.append(monodepth2.Monodepth2Model(checkpoint=str(ckpt),
                                                 device="cpu"))
    plain, released = (m.net.state_dict() for m in loaded)
    assert plain.keys() == released.keys() == sd.keys()
    for k in sd:
        assert torch.equal(released[k], plain[k]), k
        assert torch.equal(released[k], sd[k]), k
    # any other key the network lacks still fails the load
    ckpt = tmp_path / "stray"
    ckpt.mkdir()
    torch.save({**{k: v for k, v in sd.items() if k.startswith("encoder.")},
                "encoder.stray": torch.zeros(1)}, str(ckpt / "encoder.pth"))
    torch.save({k: v for k, v in sd.items() if k.startswith("decoder.")},
               str(ckpt / "depth.pth"))
    with pytest.raises(RuntimeError, match="encoder.stray"):
        monodepth2.Monodepth2Model(checkpoint=str(ckpt), device="cpu")


def test_missing_default_checkpoint_raises_before_building(tmp_path,
                                                           monkeypatch):
    """No download: a missing default checkpoint raises, naming its path
    under ``$CDTPU_CHECKPOINT_DIR``, before the network is built."""
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(tmp_path))
    built = []
    for cls, name in ((midas_v2.MidasV2Model, "midas2.pth"),
                      (monodepth2.Monodepth2Model,
                       "monodepth2_mono+stereo_1024x320")):
        monkeypatch.setattr(cls, "_make_module",
                            lambda self: built.append(self))
        with pytest.raises(FileNotFoundError,
                           match=str(tmp_path / name).replace("+", r"\+")):
            cls(device="cpu")
    assert built == []
    assert os.listdir(tmp_path) == []
