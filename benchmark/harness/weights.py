"""The benchmark's weights: made on the device from the seed, in two draws,
and handed alike to the program's network and to the reference's.

1. The convs (``nn.Conv2d``), in the order of their sorted module names:
   one ``randn`` under the tag ``"weights"``, each weight N(0, 1 / fan_in)
   (fan-in scaling as lecun-normal, not truncated), each bias 0. Batch
   norms go to their reset state (scale 1, shift 0, running mean 0 and
   variance 1).
2. Everything else, in the order of the sorted parameter names: one
   ``randn`` under the tag ``"weights.rest"``. ``nn.Linear`` and
   ``nn.ConvTranspose2d`` weights are N(0, 1 / fan_in), where fan_in counts
   the inputs one output sums over (``in_features``; Ci / groups x kh x kw
   / (sh x sw) for a transposed conv), their biases 0; ``LayerNorm`` and
   ``GroupNorm`` affine parameters are reset (1 and 0); every other
   parameter (a cls token, a position embedding) is N(0, 0.02^2), not
   truncated, as ViT initialises them.

A floating buffer that no rule reaches raises, naming it: a network built
on the meta device and moved by ``to_empty`` would otherwise keep whatever
memory it was given there. Then the configuration's ``assumed`` taming (the
reference module's ``tame``). Any two networks with the same names and
shapes get the same values; a network of convs and batch norms alone draws
nothing in step 2, so its weights are those of step 1 alone.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import traffic

# the standard deviation of a parameter that no layer rule reaches
FREE_STD = 0.02
_NORMS = (nn.LayerNorm, nn.GroupNorm)
_LAYERS = (nn.Conv2d, nn.Linear, nn.ConvTranspose2d,
           nn.modules.batchnorm._BatchNorm, *_NORMS)


def _convs(net: nn.Module):
    mods = {n: m for n, m in net.named_modules() if isinstance(m, nn.Conv2d)}
    return [mods[n] for n in sorted(mods)]


def _fan_in(m: nn.Module) -> float:
    if isinstance(m, nn.Linear):
        return m.in_features
    # ConvTranspose2d: weight (Ci, Co / groups, kh, kw)
    kh, kw = m.kernel_size
    sh, sw = m.stride
    return m.in_channels / m.groups * kh * kw / (sh * sw)


def _drawn(net: nn.Module):
    """{parameter name: (parameter, std of its N(0, std^2) draw)}, in
    sorted-name order: the linears' and transposed convs' weights, and
    every parameter that is not the weight or bias of a conv, a linear, a
    transposed conv or a norm."""
    out = {}
    for mn, m in net.named_modules():
        for pn, p in m.named_parameters(recurse=False):
            if isinstance(m, (nn.Linear, nn.ConvTranspose2d)) \
                    and pn == "weight":
                std = _fan_in(m) ** -0.5
            elif isinstance(m, _LAYERS) and pn in ("weight", "bias"):
                continue                    # set by its layer's rule
            else:
                std = FREE_STD
            out[f"{mn}.{pn}" if mn else pn] = (p, std)
    return {n: out[n] for n in sorted(out)}


def _check_buffers(net: nn.Module) -> None:
    """Raise on a floating buffer outside the batch norms: no rule fills
    it."""
    for mn, m in net.named_modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            continue
        for bn, b in m.named_buffers(recurse=False):
            if b.is_floating_point():
                raise ValueError(
                    f"weights.make: no rule fills the buffer "
                    f"{mn + '.' if mn else ''}{bn} of {type(m).__name__}")


@torch.no_grad()
def make(net: nn.Module, seed: int, reference, config) -> None:
    """Fill every parameter and buffer of ``net`` (on its own device) from
    ``seed``, then apply ``reference.tame(state, config)``."""
    _check_buffers(net)
    device = next(net.parameters()).device
    convs = _convs(net)
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
        if isinstance(m, (nn.modules.batchnorm._BatchNorm, *_NORMS)):
            m.reset_parameters()
        elif isinstance(m, (nn.Linear, nn.ConvTranspose2d)) \
                and m.bias is not None:
            m.bias.zero_()

    drawn = list(_drawn(net).values())
    if drawn:
        flat = torch.randn(sum(p.numel() for p, _ in drawn),
                           generator=traffic.generator(
                               seed, "weights.rest", device),
                           device=device, dtype=torch.float32)
        at = 0
        for p, std in drawn:
            p.copy_(flat[at:at + p.numel()].view(p.shape).mul_(std))
            at += p.numel()
    reference.tame(net.state_dict(), config)
