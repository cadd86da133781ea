#!/usr/bin/env python3
"""How far the step-1 loss of ``tests/test_torch_epoch.py``'s three-step
epoch spreads, on the CPU: the spread its step-1 band must clear, and the
gaps of injected faults that the band should catch.

On that test's data (``tests/synthetic.py``'s scene, 4 frames at 16x32,
pairs (0, 1), (2, 3), (4, 0); the JAX seed-0 ``mc`` weights with the
prediction head x 0.05; Adam at 4e-4; f32), runs:

- the JAX engine once on the weights as they are (the reference);
- the JAX engine on the weights times (1 + noise z), z standard normal
  from ``numpy.random.default_rng(seed)``, for each seed of ``--seeds``;
- the port's engine at each torch thread count of ``--threads``;
- the port's engine at the first thread count with one fault each:
  ``lr x 1.5``, Adam's ``eps`` at 1e-6, and Adam without its bias
  correction.

Prints one JSON line: for every run, the relative gap of its loss at each
step to the reference's, and of its final parameters (relative L2).

    JAX_PLATFORMS=cpu python tools/torch_epoch_band_probe.py \
        [--seeds 0 1 ... 9] [--noise 1e-7] [--threads 1 2 4]

Needs both packages, so it runs where the tests run.
"""

import argparse
import json
import os
import sys
from os.path import join as pjoin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, pjoin(REPO, "tests")]


def _no_bias_correction_adam(lr):
    """Adam as torch computes it, less the bias correction of both
    moments; it keeps ``fused`` in its defaults, as the engine asks, and
    ignores ``found_inf`` (this epoch skips no step)."""
    import torch

    class Adam(torch.optim.Adam):
        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                b1, b2 = group["betas"]
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    s = self.state[p]
                    if not s:
                        s["step"] = torch.zeros(())
                        s["exp_avg"] = torch.zeros_like(p)
                        s["exp_avg_sq"] = torch.zeros_like(p)
                    s["step"] += 1
                    s["exp_avg"].lerp_(p.grad, 1 - b1)
                    s["exp_avg_sq"].mul_(b2).addcmul_(p.grad, p.grad,
                                                      value=1 - b2)
                    p.addcdiv_(s["exp_avg"],
                               s["exp_avg_sq"].sqrt().add_(group["eps"]),
                               value=-group["lr"])

    return lambda params: Adam(params, lr=lr, eps=1e-8, fused=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(10)))
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import functools

    import numpy as np
    import torch

    import synthetic
    import test_torch_epoch as t
    from consistent_depth_tpu.models.mannequin_challenge import (
        MannequinChallengeModel as JaxMC)
    from consistent_depth_tpu_torch.models import torch_import
    from consistent_depth_tpu_torch.training import TrainingEngine

    scene = synthetic.make_scene(num_frames=4, H=t.H, W=t.W)
    data = synthetic.build_pair_arrays(scene, synthetic.make_pairs(4))
    variables = jax.tree_util.tree_map(
        np.asarray, JaxMC(checkpoint="", seed=0).variables)
    params = dict(variables["params"])
    params["pred_layer"] = {k: v * np.float32(0.05)
                            for k, v in params["pred_layer"].items()}
    clean = {**variables, "params": params}

    def jax_run(variables):
        eng = t._jax_engine(variables)
        state, m = eng.train_epoch(eng.init_state(), eng.put_data(data),
                                   t.IDX, t.VALID, t.CAPTURE)
        sd = torch_import.state_dict_from_jax_variables(
            {"params": jax.tree_util.tree_map(np.asarray, state.params)})
        return np.asarray(m["loss"], np.float64), sd

    def port_run(threads, optimizer=None, lr=4e-4):
        torch.set_num_threads(threads)
        eng = t._port_engine(clean, lr=lr)
        if optimizer is not None:
            eng = TrainingEngine(eng.model, optimizer, eng.weights)
        m = eng.train_epoch(eng.put_data(data), t.IDX, t.VALID, t.CAPTURE)
        sd = {k: p.detach().numpy() for k, p in eng.params.items()}
        return m["loss"].numpy().astype(np.float64), sd

    ref_loss, ref_sd = jax_run(clean)

    def gaps(run):
        loss, sd = run
        va = np.concatenate([np.ravel(sd[k]) for k in sorted(ref_sd)])
        vb = np.concatenate([np.ravel(ref_sd[k]) for k in sorted(ref_sd)])
        return {"loss_gap": (np.abs(loss - ref_loss)
                             / np.abs(ref_loss)).tolist(),
                "param_rel_l2": float(np.linalg.norm(va - vb)
                                      / np.linalg.norm(vb))}

    out = {"noise": args.noise, "seeds": args.seeds,
           "threads": args.threads, "reference_loss": ref_loss.tolist(),
           "runs": {}}
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        noisy = jax.tree_util.tree_map(
            lambda v: (v * (1 + args.noise * rng.standard_normal(v.shape))
                       ).astype(v.dtype), clean)
        out["runs"][f"jax_noise_seed{seed}"] = gaps(jax_run(noisy))
    for threads in args.threads:
        out["runs"][f"port_threads{threads}"] = gaps(port_run(threads))
    first = args.threads[0]
    out["runs"]["fault_lr_x1.5"] = gaps(port_run(first, lr=6e-4))
    out["runs"]["fault_eps_1e-6"] = gaps(port_run(first, functools.partial(
        torch.optim.Adam, lr=4e-4, eps=1e-6, fused=True)))
    out["runs"]["fault_no_bias_correction"] = gaps(
        port_run(first, _no_bias_correction_adam(4e-4)))
    step1 = {k: v["loss_gap"][1] for k, v in out["runs"].items()}
    out["step1_gap"] = step1
    out["largest_step1_gap_unfaulted"] = max(
        v for k, v in step1.items() if not k.startswith("fault_"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
