"""Port's hourglass against the JAX package's: weights carried across and
the eval-mode forward.

The JAX model is initialised once per module; its BN running means and
variances are replaced with random values first, so that a fault in how
the port uses the statistics cannot hide behind the init values 0 and 1.
Forward tolerance: f32, rtol = atol = 1e-4 (the band of
tests/test_hourglass.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consistent_depth_tpu.models import torch_import as jax_torch_import
from consistent_depth_tpu.models.hourglass import HourglassModel as JaxHourglass
from consistent_depth_tpu_torch.models import hourglass, torch_import

TOL = dict(rtol=1e-4, atol=1e-4)


def randomize_batch_stats(variables, seed=0):
    """Numpy copy of ``variables`` with random BN running stats."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                tree[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    out = jax.tree_util.tree_map(np.array, variables)  # writable copies
    fill(out["batch_stats"])
    return out


@pytest.fixture(scope="module")
def jax_model():
    model = JaxHourglass()
    variables = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), train=False)
    return model, randomize_batch_stats(variables)


def _port_net(variables):
    sd = torch_import.state_dict_from_jax_variables(variables)
    net = hourglass.HourglassModel()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    return net.eval().to(memory_format=torch.channels_last)


def test_state_dict_matches_jax_export(jax_model):
    _, variables = jax_model
    ours = torch_import.state_dict_from_jax_variables(variables)
    theirs = jax_torch_import.variables_to_state_dict(variables)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    # every tensor of the port's module is covered, except BN's
    # num_batches_tracked, which the JAX package does not carry
    net_keys = {k for k in hourglass.HourglassModel().state_dict()
                if not k.endswith("num_batches_tracked")}
    assert set(ours) == net_keys


def test_pth_written_by_jax_loads_strict(jax_model, tmp_path):
    from consistent_depth_tpu_torch.models.mannequin_challenge import (
        MannequinChallengeModel)

    _, variables = jax_model
    want = jax_torch_import.variables_to_state_dict(variables)
    path = str(tmp_path / "mc.pth")
    jax_torch_import.save_torch_checkpoint(path, variables)
    # the DataParallel layout ("module." prefix) loads as well
    wrapped = str(tmp_path / "mc_dp.pth")
    torch.save({"module." + k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in want.items()}, wrapped)
    for p in (path, wrapped):
        sd = MannequinChallengeModel(checkpoint=p, device="cpu").net.state_dict()
        for k, v in want.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_missing_checkpoint_raises(tmp_path):
    from consistent_depth_tpu_torch.models.mannequin_challenge import (
        MannequinChallengeModel)

    with pytest.raises(FileNotFoundError):
        MannequinChallengeModel(checkpoint=str(tmp_path / "absent.pth"),
                                device="cpu")


def test_eval_forward_matches_jax(jax_model):
    model, variables = jax_model
    x = np.random.default_rng(0).random((2, 32, 48, 3), dtype=np.float32)
    j_pred, j_conf = model.apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x),
        train=False)
    net = _port_net(variables)
    with torch.no_grad():
        t_pred, t_conf = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert t_pred.shape == (2, 1, 32, 48) and t_conf.shape == (2, 1, 32, 48)
    np.testing.assert_allclose(
        t_pred[:, 0].numpy(), np.asarray(j_pred)[..., 0], **TOL)
    np.testing.assert_allclose(
        t_conf[:, 0].numpy(), np.asarray(j_conf)[..., 0], **TOL)


def test_seeded_init_is_deterministic_and_lecun():
    """The seeded init is a function of the seed alone, and the conv
    kernels have flax lecun_normal's spread (std 1/sqrt(fan_in))."""
    from consistent_depth_tpu_torch.models.mannequin_challenge import (
        MannequinChallengeModel)

    a, b, c = (MannequinChallengeModel(checkpoint="", seed=seed,
                                       device="cpu").net.state_dict()
               for seed in (3, 3, 4))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["seq.0.weight"], c["seq.0.weight"])
    w = a["seq.3.list.1.0.convs.3.3.weight"]        # _A's 11x11, 64 -> 16
    std = float(w.std())
    assert abs(std * np.sqrt(11 * 11 * 64) - 1.0) < 0.05, std
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(
        11 * 11 * 64) + 1e-6


def test_registry_only_mc(tmp_path, monkeypatch):
    """The registry returns each backbone's adapter (midas2 and monodepth2
    are ported too); building one whose default weights are missing
    raises, naming the path; an unknown name raises."""
    from consistent_depth_tpu_torch.models import registry
    from consistent_depth_tpu_torch.models.mannequin_challenge import (
        MannequinChallengeModel)
    from consistent_depth_tpu_torch.models.midas_v2 import MidasV2Model
    from consistent_depth_tpu_torch.models.monodepth2 import Monodepth2Model

    assert registry.get_depth_model("mc") is MannequinChallengeModel
    monkeypatch.setenv("CDTPU_CHECKPOINT_DIR", str(tmp_path))
    for name, cls, default in (
            ("midas2", MidasV2Model, "midas2.pth"),
            ("monodepth2", Monodepth2Model,
             "monodepth2_mono+stereo_1024x320")):
        assert registry.get_depth_model(name) is cls
        with pytest.raises(FileNotFoundError) as err:
            registry.create_depth_model(name, device="cpu")
        assert str(tmp_path / default) in str(err.value)
    with pytest.raises(ValueError):
        registry.get_depth_model("dpt")


def test_default_device_is_cuda(monkeypatch):
    """DepthModel, and so create_depth_model, builds on the card unless the
    caller asks for the CPU."""
    import inspect

    from consistent_depth_tpu_torch.models import base, registry

    assert inspect.signature(
        base.DepthModel.__init__).parameters["device"].default == "cuda"
    moved = []
    monkeypatch.setattr(base.DepthModel, "to",
                        lambda self, device, dtype: moved.append(device))
    registry.create_depth_model("mc", checkpoint="")
    assert moved == ["cuda"]
