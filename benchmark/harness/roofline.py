"""The card's peaks and the work of a configuration, counted from the
benchmark's own reference network, so that the count does not change when
the program does.

A logging mode (:class:`_Log`) records, in one forward traced on the meta
device, each product the reference computes:

- ``F.conv2d``: 2 N Ho Wo Co (Ci / groups) k^2;
- ``F.conv_transpose2d``: 2 N Hin Win Ci (Co / groups) kh kw;
- ``F.linear``: 2 rows in out; ``torch.matmul``, ``torch.mm``,
  ``torch.bmm`` and the tensor methods ``@``, ``matmul``, ``mm``, ``bmm``:
  2 batch M K N;
- ``F.scaled_dot_product_attention``: 4 B h Lq Lk d, Q K^T and P V (the
  softmax not counted, no mask taken off the count; a value width other
  than d is refused);

Each product is counted once. PyTorch turns a mode off inside its own
handler, so the products of a composite such as
``F.multi_head_attention_forward`` would go unseen: the mode refuses it, as
it refuses the other products of ``torch`` (``addmm``, ``baddbmm``,
``einsum``, ...), rather than leave them out. A reference writes its
products with the calls above, attention with ``reference/common.py``'s
``attention`` and ``Linear``, which the control's rounding reaches too.

``conv_bound`` is ``chip_smoke.py::conv_bound`` with one peak per
precision in place of one per kernel route: the same conv has the same
bound whichever kernel runs it. ``linear_bound`` and ``attention_bound``
follow the same rule.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

# NVIDIA H100 SXM data sheet, dense rates. f32 is the TF32 tensor-core
# rate at three products per f32-accurate product: the fastest f32-accurate
# rate a route of the port reaches (the FMA pipes' 67 TFLOP/s would read
# over 100% on its 3xTF32 kernels).
PEAK_TFLOPS = {"bf16": 989.0, "f32": 495.0 / 3}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bf16": 2, "f32": 4}


def _bound(flop: float, elems: float, precision: str
           ) -> Tuple[float, float, str]:
    t_ops = flop / (PEAK_TFLOPS[precision] * 1e12)
    t_bytes = elems * ELEM_BYTES[precision] / HBM_BYTES_PER_S
    return flop, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def conv_bound(direction: str, N: int, H: int, W: int, k: int, Ci: int,
               Co: int, precision: str) -> Tuple[float, float, str]:
    """(FLOP, least seconds, "operations" or "bytes") of one same-padding
    stride-1 conv call: the larger of its operations over the precision's
    peak and its bytes (each input read once, each output written once)
    over the memory rate. ``direction`` is "forward" (x, w, bias in, out)
    or "grad_input" (ct, w in, dx out)."""
    flop = 2 * N * H * W * k * k * Ci * Co
    elems = N * H * W * (Ci + Co) + k * k * Ci * Co + (
        Co if direction == "forward" else 0)
    return _bound(flop, elems, precision)


def linear_bound(batch: int, M: int, K: int, N: int, precision: str,
                 a_elems: Optional[int] = None, b_elems: Optional[int] = None,
                 bias: bool = False) -> Tuple[float, float, str]:
    """(FLOP, least seconds, "operations" or "bytes") of one product
    ``batch`` x (M, K) @ (K, N). Bytes: A (``a_elems``, by default
    batch M K) and B (``b_elems``, by default K N: one weight for every
    row, as a linear's) each read once, the batch M N output written once,
    and with ``bias`` N more read; an operand broadcast over the batch is
    read once, so pass its own size. One product of a backward (grad-input
    or grad-weight) reads and writes the same three sizes, without the
    bias."""
    flop = 2 * batch * M * K * N
    a = batch * M * K if a_elems is None else a_elems
    b = K * N if b_elems is None else b_elems
    elems = a + b + batch * M * N + (N if bias else 0)
    return _bound(flop, elems, precision)


def attention_bound(direction: str, BH: int, Lq: int, Lk: int, d: int,
                    precision: str) -> Tuple[float, float, str]:
    """(FLOP, least seconds, "operations" or "bytes") of one attention over
    ``BH`` batches x heads, flash-style: the score matrix never leaves the
    chip. "forward": S = Q K^T and O = P V (4 BH Lq Lk d), reading Q, K, V
    and writing O; "backward": dV, dP, dQ and dK (twice the forward),
    reading Q, K, V, O and dO and writing dQ, dK and dV."""
    flop = 4 * BH * Lq * Lk * d
    elems = 2 * BH * d * (Lq + Lk)
    if direction == "backward":
        flop, elems = 2 * flop, 2 * elems
    return _bound(flop, elems, precision)


@dataclass(frozen=True)
class Conv:
    """One conv call of a forward: input (N, Ci, H, W), Co outputs of
    (Ho, Wo), a k x k kernel; whether its input needs a gradient."""

    N: int
    Ci: int
    H: int
    W: int
    Co: int
    Ho: int
    Wo: int
    k: int
    stride: int
    groups: int
    needs_grad_input: bool

    @property
    def flop(self) -> int:
        return 2 * self.N * self.Ho * self.Wo * self.Co * (
            self.Ci // self.groups) * self.k * self.k

    @property
    def kxk(self) -> bool:
        """The class the k x k kernels take: groups 1, stride 1, k > 1."""
        return self.groups == 1 and self.stride == 1 and self.k > 1


@dataclass(frozen=True)
class Linear:
    """One product ``batch`` x (M, K) @ (K, N) of a forward (a linear, a
    matmul), with its operands' own sizes; ``grads``: how many of its two
    operands need a gradient, each a product of the backward."""

    batch: int
    M: int
    K: int
    N: int
    a_elems: int
    b_elems: int
    bias: bool
    grads: int

    @property
    def flop(self) -> int:
        return 2 * self.batch * self.M * self.K * self.N

    def bound_s(self, precision: str, backward: bool) -> float:
        shape = (self.batch, self.M, self.K, self.N, precision,
                 self.a_elems, self.b_elems)
        t = linear_bound(*shape, bias=self.bias)[1]
        if backward:
            t += self.grads * linear_bound(*shape)[1]
        return t


@dataclass(frozen=True)
class Attention:
    """One attention of a forward over BH batches x heads; whether any of
    Q, K, V needs a gradient."""

    BH: int
    Lq: int
    Lk: int
    d: int
    needs_grad: bool

    @property
    def flop(self) -> int:
        return 4 * self.BH * self.Lq * self.Lk * self.d

    def bound_s(self, precision: str, backward: bool) -> float:
        t = attention_bound("forward", self.BH, self.Lq, self.Lk, self.d,
                            precision)[1]
        if backward and self.needs_grad:
            t += attention_bound("backward", self.BH, self.Lq, self.Lk,
                                 self.d, precision)[1]
        return t


@dataclass(frozen=True)
class ConvTranspose:
    """One transposed conv of a forward; its FLOP alone."""

    flop: int


def _arg(args, kwargs, i: int, name: str, default=None):
    return kwargs[name] if name in kwargs else (
        args[i] if len(args) > i else default)


def _grad(*ts) -> bool:
    return any(t is not None and t.requires_grad for t in ts)


class _Log(TorchFunctionMode):
    """Records every product made inside it (the module docstring)."""

    def __init__(self):
        super().__init__()
        self.convs: List[Conv] = []
        self.linears: List[Linear] = []
        self.attentions: List[Attention] = []
        self.conv_transposes: List[ConvTranspose] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _UNCOUNTED:
            raise ValueError(f"roofline: {func.__name__} is not counted; "
                             f"write the product with {_COUNTED}")
        out = func(*args, **kwargs)
        record = _RECORDERS.get(func)
        if record is not None:
            record(self, out, args, kwargs)
        return out

    def conv2d(self, out, args, kwargs):
        x, w = args[0], args[1]
        stride = _arg(args, kwargs, 3, "stride", 1)
        groups = _arg(args, kwargs, 6, "groups", 1)
        stride = stride[0] if isinstance(stride, (tuple, list)) else stride
        N, Ci, H, W = x.shape
        self.convs.append(Conv(
            N, Ci, H, W, w.shape[0], out.shape[2], out.shape[3],
            w.shape[2], int(stride), int(groups), bool(x.requires_grad)))

    def conv_transpose2d(self, out, args, kwargs):
        # x (N, Ci, Hin, Win), w (Ci, Co / groups, kh, kw): each input
        # pixel of each channel meets Co / groups x kh x kw weights
        x, w = args[0], args[1]
        self.conv_transposes.append(ConvTranspose(
            2 * x.numel() * w.shape[1] * w.shape[2] * w.shape[3]))

    def linear(self, out, args, kwargs):
        x, w = args[0], args[1]
        b = _arg(args, kwargs, 2, "bias")
        K, N = w.shape[-1], w.shape[0]
        self.linears.append(Linear(
            1, out.numel() // max(N, 1), K, N, x.numel(), w.numel(),
            b is not None, int(_grad(x)) + int(_grad(w))))

    def matmul(self, out, args, kwargs):
        a, b = args[0], args[1]
        M = a.shape[-2] if a.dim() > 1 else 1
        N = b.shape[-1] if b.dim() > 1 else 1
        self.linears.append(Linear(
            out.numel() // max(M * N, 1), M, a.shape[-1], N, a.numel(),
            b.numel(), False, int(_grad(a)) + int(_grad(b))))

    def sdpa(self, out, args, kwargs):
        q, k, v = (_arg(args, kwargs, i, n)
                   for i, n in enumerate(("query", "key", "value")))
        if v.shape[-1] != q.shape[-1]:
            raise ValueError("roofline: attention with a value width other "
                             "than the query's is not counted")
        BH = q.numel() // (q.shape[-2] * q.shape[-1])
        self.attentions.append(Attention(BH, q.shape[-2], k.shape[-2],
                                         q.shape[-1], _grad(q, k, v)))


_RECORDERS = {
    F.conv2d: _Log.conv2d, torch.conv2d: _Log.conv2d,
    F.conv_transpose2d: _Log.conv_transpose2d,
    F.linear: _Log.linear,
    torch.matmul: _Log.matmul, torch.mm: _Log.matmul, torch.bmm: _Log.matmul,
    torch.Tensor.__matmul__: _Log.matmul, torch.Tensor.matmul: _Log.matmul,
    torch.Tensor.mm: _Log.matmul, torch.Tensor.bmm: _Log.matmul,
    F.scaled_dot_product_attention: _Log.sdpa,
}
_COUNTED = ("F.conv2d, F.conv_transpose2d, F.linear, matmul, mm, bmm, @ or "
            "F.scaled_dot_product_attention")
_UNCOUNTED = frozenset((
    torch.addmm, torch.baddbmm, torch.addbmm, torch.addmv, torch.mv,
    torch.einsum, torch.tensordot, torch.chain_matmul, F.bilinear,
    torch.conv1d, torch.conv3d, F.conv_transpose1d, F.conv_transpose3d,
    torch.Tensor.__rmatmul__, torch.Tensor.addmm, torch.Tensor.baddbmm,
    F.multi_head_attention_forward))


@functools.lru_cache(maxsize=None)
def _trace(reference, N: int, H: int, W: int) -> _Log:
    """The products of one training forward of ``reference``'s network on
    N frames of H x W, traced on the meta device."""
    with torch.device("meta"):
        net = reference.build()
    net.train()
    images = torch.empty((N, 1, H, W, 3), device="meta")
    with _Log() as log:
        reference.depth(net, images)
    return log


def convs_of(reference, N: int, H: int, W: int) -> Tuple[Conv, ...]:
    """The conv calls of one training forward of ``reference``'s network
    on N frames of H x W."""
    return tuple(_trace(reference, N, H, W).convs)


def forward_flop(reference, H: int, W: int) -> int:
    """FLOP of the network's convs, transposed convs, linears, matmuls and
    attentions in one frame's forward at H x W."""
    log = _trace(reference, 1, H, W)
    return sum(p.flop for p in (*log.convs, *log.conv_transposes,
                                *log.linears, *log.attentions))


def kxk_bound_s(reference, N: int, H: int, W: int, precision: str,
                grad_input: bool) -> float:
    """Least seconds of the k x k kernels' work in one forward of N frames
    (and, with ``grad_input``, in its backward's grad-inputs, for the
    convs whose input needs one)."""
    total = 0.0
    for c in convs_of(reference, N, H, W):
        if not c.kxk:
            continue
        total += conv_bound("forward", c.N, c.H, c.W, c.k, c.Ci, c.Co,
                            precision)[1]
        if grad_input and c.needs_grad_input:
            total += conv_bound("grad_input", c.N, c.H, c.W, c.k, c.Ci,
                                c.Co, precision)[1]
    return total


def bounds_s(reference, N: int, H: int, W: int, precision: str,
             backward: bool) -> Dict[str, float]:
    """{class: least seconds} of one forward of N frames and, with
    ``backward``, of its backward: "kxk" as :func:`kxk_bound_s` (forward
    and grad-inputs; grad-weight is not the k x k kernels' work),
    "linear" every linear and matmul with each operand's gradient,
    "attention" every attention with its backward."""
    log = _trace(reference, N, H, W)
    return {
        "kxk": kxk_bound_s(reference, N, H, W, precision, backward),
        "linear": sum((p.bound_s(precision, backward) for p in log.linears),
                      0.0),
        "attention": sum((p.bound_s(precision, backward)
                          for p in log.attentions), 0.0)}
