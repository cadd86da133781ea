"""The benchmark's weights: made on the device from the seed, in one draw,
and handed alike to the program's network and to the reference's.

Conv weights are N(0, 1 / fan_in) (fan-in scaling as lecun-normal, not
truncated), conv biases 0, batch norms at their reset state (scale 1,
shift 0, running mean 0 and variance 1); then the configuration's
``assumed`` taming (the reference module's ``tame``). Convs are filled in
the order of their sorted names, so any two networks with the same conv
names and shapes get the same values.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import traffic


def _convs(net: nn.Module):
    mods = {n: m for n, m in net.named_modules() if isinstance(m, nn.Conv2d)}
    return [mods[n] for n in sorted(mods)]


@torch.no_grad()
def make(net: nn.Module, seed: int, reference, config) -> None:
    """Fill every parameter and buffer of ``net`` (on its own device) from
    ``seed``, then apply ``reference.tame(state, config)``."""
    convs = _convs(net)
    device = convs[0].weight.device
    sizes = [m.weight.numel() for m in convs]
    flat = torch.randn(sum(sizes), generator=traffic.generator(
        seed, "weights", device), device=device, dtype=torch.float32)
    at = 0
    for m, n in zip(convs, sizes):
        w = m.weight
        fan_in = w[0].numel()
        w.copy_(flat[at:at + n].view(w.shape).mul_(fan_in ** -0.5))
        at += n
        if m.bias is not None:
            m.bias.zero_()
    for m in net.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    reference.tame(net.state_dict(), config)
