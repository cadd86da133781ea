"""The transformer's products with their gradients: the linear and the
attention of a ViT encoder (``models/vit.py``) as autograd Functions whose
forward and backward each run in a span of ``..utils.tracing``
(``linear.forward``, ``linear.backward``, ``attention.forward``,
``attention.backward``), on every device.

The JAX package has no transformer, so no TPU kernel is ported here. A
linear is three GEMMs: the forward x w^T + b, and backward the grad-input
g w and the grad-weight g^T x. On the card in f32 all three run on the
port's kernel, ``csrc/linear_wgmma_tf32.cu``: 3xTF32 on ``wgmma`` (f32
accuracy: the policy of the engine and the server keeps the library's TF32
off), each operand split into two TF32 planes, one of them beforehand by a
small kernel (the weight for the forward, by the conv's weight split; the
weight transposed for the grad-input and, for the grad-weight, the narrower
of g and x transposed, by the same source's split), the reduction of a
grad-weight split over blocks and added in a fixed order. :func:`_plan` fixes tiles and split from the GEMM's shape.
bf16 and f64 on the card stay on the library's GEMMs (cuBLAS; bf16 is on
the tensor cores there), and a CPU or meta tensor takes the plain
``torch.mm`` version (:func:`route`). An f32 operand the kernel does not
take as it lies (inner stride 1, rows a multiple of 4 elements, a 16-byte
aligned base) is copied inside the span; one whose rows cannot be (a width
not a multiple of 4) raises. Every launch of a linear's GEMMs, the splits
and reduces included, runs inside its span.

The attention in f32 on the card runs on the port's kernel,
``csrc/attention_wgmma_tf32.cu``, in place of the library's SDPA (its
memory-efficient kernel, 3xTF32 on ``mma.sync`` at ~17% of the bound): a
flash attention forward and backward in 3xTF32 on ``wgmma`` with TMA
loads, whose scores never leave the chip. What bounds it is operations,
4 B H L^2 d FLOP forward and twice that backward at 165 TFLOP/s (the TF32
rate over three products a product); its design note says what it does
about that. It takes q, k and v as they lie (the qkv linear's output, rows
of 3 x 1024 elements), splits K into TF32 planes and V (forward) or K
(backward) into transposed planes inside the span, writes O in the (B, L,
H, d) layout, so that the caller's ``o.transpose(1, 2).reshape`` stays a
view, and keeps an f32 logsumexp (B, H, L), from which the backward
recomputes P; it sums dQ by f32 atomic adds, so two backward calls may
differ in dQ's last bits. It takes heads of 64 (every DINOv2 backbone's)
and of 32 (the small networks of the tests, on the same tiles with the
columns past 32 read as zeros, at the operations of 64); another width
raises (:func:`attention_route`). bf16 and f64 on the
card stay on the library's memory-efficient kernel
(``aten._scaled_dot_product_efficient_attention`` and its backward from
the kept logsumexp), a CPU or meta tensor takes the library's CPU flash
kernel, the plain version. Every launch, the splits, the D = rowsum(dO o
O) pass and the zeroed dQ included, runs inside the spans; the spans put
the backward's kernels, which run on autograd's thread, under a name of
their own.

A transposed conv whose kernel equals its stride (DPT's reassemble
upsamplers, ``models/depth_anything_v2.py``) is one GEMM over the input
pixels and a pixel shuffle: :func:`conv_transpose_patches` computes it
through :func:`linear`, so that the linear's span, counts and kernel cover
it too.

:data:`counts` counts the calls of each product (forward passes, with or
without a gradient), on every device; :func:`launch_counts` reads them.
:data:`linear_routes` counts the linears' GEMMs by route,
:data:`attention_routes` each attention's forward and backward by route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _cuda

# calls of :func:`linear` and :func:`attention`
counts = {"linear": 0, "attention": 0}
# the linears' GEMMs (forward, grad-input, grad-weight: one each) by route:
# the port's kernel, the library's GEMM on the card, the plain version
linear_routes = {"kernel": 0, "library": 0, "plain": 0}
# each attention's forward and backward by route, as linear_routes
attention_routes = {"kernel": 0, "library": 0, "plain": 0}
# the attention kernel's head widths (csrc/attention_wgmma_tf32.cu: the
# instances of its kernels' D): every DINOv2 backbone's, and the small
# networks' of the tests
HEAD_DIMS = (64, 32)

# the kernel's tile (csrc/linear_wgmma_tf32.cu: BM, BN, BK): output rows
# and columns, and the reduction elements of a stage of its ring
TILE_ROWS = 128
TILE_COLS = 128
STAGE_K = 32
# an H100 SXM's streaming multiprocessors, one block on each (the kernel's
# launch bounds); the reduction is split over up to MAX_SPLIT blocks until
# the units of work fill the last wave of the grid to WAVE_FILL
SMS = 132
MAX_SPLIT = 8
WAVE_FILL = 0.9


def launch_counts() -> Tuple[int, int]:
    """(linears, attentions) run since the last :func:`reset_counts`."""
    return counts["linear"], counts["attention"]


def reset_counts() -> None:
    """Zero :data:`counts`, :data:`linear_routes` and
    :data:`attention_routes`."""
    for table in (counts, linear_routes, attention_routes):
        for key in table:
            table[key] = 0


def route(dtype: torch.dtype, device_type: str) -> str:
    """Where a linear's GEMMs of this dtype on this device run: "kernel"
    (f32 on the card), "library" (any other dtype on the card), "plain"
    (every other device: ``torch.mm``)."""
    if device_type != "cuda":
        return "plain"
    return "kernel" if dtype == torch.float32 else "library"


class Plan(NamedTuple):
    """How one GEMM of R x C outputs over a reduction of Kr runs on the
    kernel: tiles of TILE_ROWS x TILE_COLS (rows, columns), k-blocks of
    STAGE_K, the reduction's split, the persistent grid's blocks and the
    f32 workspace's elements (the splits' partial sums)."""
    tiles_r: int
    tiles_c: int
    kblocks: int
    split: int
    blocks: int
    workspace: int


@functools.lru_cache(maxsize=256)
def _plan(R: int, C: int, Kr: int) -> Plan:
    """The smallest split of the reduction (at most MAX_SPLIT, at least one
    k-block each) whose units (tiles x split) fill the grid's last wave to
    WAVE_FILL, else the split that fills it best; one block per unit up to
    SMS."""
    tiles_r, tiles_c = math.ceil(R / TILE_ROWS), math.ceil(C / TILE_COLS)
    kblocks = math.ceil(Kr / STAGE_K)
    tiles = tiles_r * tiles_c
    split, best = 1, -1.0
    for s in range(1, min(MAX_SPLIT, kblocks) + 1):
        units = tiles * s
        fill = units / (math.ceil(units / SMS) * SMS)
        if fill > best:
            split, best = s, fill
        if fill >= WAVE_FILL:
            break
    units = tiles * split
    return Plan(tiles_r, tiles_c, kblocks, split, min(units, SMS),
                split * R * C if split > 1 else 0)


def _taken(t: torch.Tensor) -> bool:
    """Whether the kernel reads the 2-D f32 tensor t as it lies: inner
    stride 1, rows a whole number of 16-byte units, a 16-byte aligned
    base (TMA's rules)."""
    return (t.stride(1) == 1 and t.stride(0) % 4 == 0
            and t.stride(0) >= t.shape[1] and t.data_ptr() % 16 == 0)


def _operand(t: torch.Tensor, what: str) -> torch.Tensor:
    """t as the kernel reads it: itself, or a contiguous copy; raises for
    rows of a width the kernel cannot read (not a multiple of 4)."""
    if not _taken(t):
        t = t.clone(memory_format=torch.contiguous_format)
        if not _taken(t):
            raise ValueError(f"linear: the kernel takes no {what} of shape "
                             f"{tuple(t.shape)} (rows of a multiple of 4 "
                             f"f32 elements)")
    return t


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _weight_planes(w: torch.Tensor) -> torch.Tensor:
    """The weight w (N, K) f32 (any strides, K a multiple of 4) split into
    TF32 planes (big, small), (2, N, K): the conv's weight split
    (``csrc/same_conv_wgmma_tf32.cu``) of one tap."""
    N, K = w.shape
    planes = torch.empty((2, N, K), dtype=torch.float32, device=w.device)
    lib = _cuda.library()
    err = lib.same_conv_tf32_split_weight(
        w.data_ptr(), planes.data_ptr(), K, N, 1, 0, 0, w.stride(1),
        w.stride(0), 0, _stream())
    _cuda.check(lib, err, "same_conv_tf32_split_weight")
    return planes


def _transposed_planes(t: torch.Tensor) -> torch.Tensor:
    """The 2-D f32 tensor t (rows, cols) (any strides) transposed and split
    into TF32 planes (big, small), (2, cols, ld), ld the rows rounded up to
    4 elements."""
    rows, cols = t.shape
    ld = -(-rows // 4) * 4
    planes = torch.empty((2, cols, ld), dtype=torch.float32, device=t.device)
    lib = _cuda.library()
    err = lib.linear_tf32_split(t.data_ptr(), planes.data_ptr(), rows, cols,
                                t.stride(0), t.stride(1), ld, _stream())
    _cuda.check(lib, err, "linear_tf32_split")
    return planes


def _gemm(a: torch.Tensor, a_mn: bool, planes: torch.Tensor, out: torch.Tensor,
          out_strides: Tuple[int, int], R: int, C: int, Kr: int,
          bias: Optional[torch.Tensor] = None) -> None:
    """out[r, c] = sum_k A[r, k] B[c, k] (+ bias[c]) on the kernel: A is a
    (R, Kr), or (Kr, R) where ``a_mn``; B the planes (2, C, ld)."""
    plan = _plan(R, C, Kr)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=a.device)
          if plan.split > 1 else None)
    lib = _cuda.library()
    err = lib.linear_wgmma_tf32(
        a.data_ptr(), a.stride(0), int(a_mn), planes.data_ptr(),
        planes.stride(1), None if bias is None else bias.data_ptr(),
        out.data_ptr(), *out_strides, R, C, Kr, plan.split, plan.blocks,
        None if ws is None else ws.data_ptr(), _stream())
    _cuda.check(lib, err, "linear_wgmma_tf32")
    linear_routes["kernel"] += 1


def _forward_kernel(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor]) -> torch.Tensor:
    """x w^T + b on the kernel, in x's leading shape (an empty product is
    no GEMM: ``F.linear``)."""
    N, K = w.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if not (M and N and K):
        return F.linear(x, w, b)
    x2 = _operand(x2, "input")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    bias = None if b is None else b.contiguous()
    _gemm(x2, False, _weight_planes(w), y, (N, 1), M, N, K, bias)
    return y.view(*x.shape[:-1], N)


def _grad_input_kernel(g2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g w (M, K) of the cotangent g2 (M, N) on the kernel: B is w^T."""
    N, K = w.shape
    M = g2.shape[0]
    if not (M and N and K):
        return g2.new_zeros((M, K))
    gx = torch.empty((M, K), dtype=g2.dtype, device=g2.device)
    _gemm(_operand(g2, "cotangent"), False, _transposed_planes(w), gx,
          (K, 1), M, K, N)
    return gx


def _grad_weight_kernel(g2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """g^T x (N, K) of g2 (M, N) and x2 (M, K) on the kernel: the wider of
    the two is A as it lies (reduction-major), the narrower B, split
    transposed; with x the wider, the product is (g^T x)^T, stored
    transposed."""
    M, N = g2.shape
    K = x2.shape[1]
    if not (M and N and K):
        return g2.new_zeros((N, K))
    gw = torch.empty((N, K), dtype=g2.dtype, device=g2.device)
    wide, narrow, strides = (g2, x2, (K, 1)) if N >= K else (x2, g2, (1, K))
    _gemm(_operand(wide, "operand"), True, _transposed_planes(narrow), gw,
          strides, wide.shape[1], narrow.shape[1], M)
    return gw


class _Linear(torch.autograd.Function):
    """y = x w^T + b over the last axis of x; grad-input g w, grad-weight
    g^T x over every row, grad-bias the rows' sum in f32. Each GEMM goes
    where :func:`route` sends it."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        with tracing.span(tracing.LINEAR_FORWARD):
            where = route(x.dtype, x.device.type)
            if where == "kernel":
                with torch.cuda.device(x.device):
                    return _forward_kernel(x, w, b)
            linear_routes[where] += 1
            return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        with tracing.span(tracing.LINEAR_BACKWARD):
            where = route(g.dtype, g.device.type)
            g2 = g.reshape(-1, g.shape[-1])
            if ctx.needs_input_grad[0]:
                if where == "kernel":
                    with torch.cuda.device(g.device):
                        gx = _grad_input_kernel(g2, w)
                else:
                    gx = torch.mm(g2, w)
                    linear_routes[where] += 1
                gx = gx.view(x.shape)
            if ctx.needs_input_grad[1]:
                x2 = x.reshape(-1, x.shape[-1])
                if where == "kernel":
                    with torch.cuda.device(g.device):
                        gw = _grad_weight_kernel(g2, x2)
                else:
                    gw = torch.mm(g2.t(), x2)
                    linear_routes[where] += 1
            if ctx.has_bias and ctx.needs_input_grad[2]:
                gb = g2.sum(0, dtype=torch.float32).to(g.dtype)
        return gx, gw, gb


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, w, b)`` through :class:`_Linear` (with or without a
    gradient: under ``no_grad`` it records no graph)."""
    counts["linear"] += 1
    return _Linear.apply(x, w, b)


def attention_route(dtype: torch.dtype, device_type: str,
                    head_dim: int) -> str:
    """Where an attention of this dtype on this device with heads of
    ``head_dim`` runs: "kernel" (f32 on the card), "library" (any other
    dtype on the card), "plain" (every other device). Raises ValueError for
    f32 on the card with a head width the kernel does not take."""
    if device_type != "cuda":
        return "plain"
    if dtype != torch.float32:
        return "library"
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attention: the f32 kernel takes heads of "
                         f"{' or '.join(map(str, HEAD_DIMS))}, not "
                         f"{head_dim}")
    return "kernel"


def _attention_view(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """A (B, H, L, d) f32 tensor as the kernel reads it: itself where the
    head width is contiguous, the other strides (of dimensions longer than
    one) are whole 16-byte units and the base is 16-byte aligned (TMA's
    rules; q, k and v as views of the qkv linear's output are), else a
    contiguous copy; and its (B, H, L) element strides, a dimension of one
    given the whole tensor's size."""
    def taken(u):
        return (u.stride(3) == 1 and u.data_ptr() % 16 == 0
                and all(u.shape[i] == 1 or (u.stride(i) > 0
                                            and u.stride(i) % 4 == 0)
                        for i in range(3)))
    if not taken(t):
        t = t.clone(memory_format=torch.contiguous_format)
    size = max(4, -(-t.numel() // 4) * 4)
    return t, tuple(t.stride(i) if t.shape[i] > 1 else size
                    for i in range(3))


def _attention_planes(t: torch.Tensor, strides: Tuple[int, ...], lp: int,
                      rows: bool, cols: bool, permute: bool = False):
    """t's TF32 planes (``attention_tf32_split``): K-major (2, B H, L, d)
    where ``rows``, transposed (2, B H, d, lp) where ``cols``, its keys in
    the order the forward's accumulator gives P where ``permute``."""
    B, H, L, d = t.shape
    rp = (torch.empty((2, B * H, L, d), dtype=t.dtype, device=t.device)
          if rows else None)
    cp = (torch.empty((2, B * H, d, lp), dtype=t.dtype, device=t.device)
          if cols else None)
    lib = _cuda.library()
    err = lib.attention_tf32_split(
        t.data_ptr(), *strides, B, H, L, d,
        None if rp is None else rp.data_ptr(),
        None if cp is None else cp.data_ptr(), lp, int(permute), _stream())
    _cuda.check(lib, err, "attention_tf32_split")
    return rp, cp


def _attention_forward_kernel(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor):
    """(O, lse) of q, k, v (B, H, L, d) f32 on the kernel (d in
    HEAD_DIMS): O a (B, H, L, d) view of a (B, L, H, d) tensor, lse (B, H, L)
    f32."""
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(f"attention: the kernel takes q, k, v of one (B, "
                         f"H, L, d) shape, not {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, L, d = q.shape
    out = torch.empty((B, L, H, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    q, qs = _attention_view(q)
    k, ks = _attention_view(k)
    v, vs = _attention_view(v)
    lp = -(-L // 8) * 8
    kp, _ = _attention_planes(k, ks, lp, True, False)
    _, vt = _attention_planes(v, vs, lp, False, True, permute=True)
    lib = _cuda.library()
    err = lib.attention_wgmma_tf32_forward(
        q.data_ptr(), *qs, kp.data_ptr(), vt.data_ptr(), out.data_ptr(),
        out.stride(0), out.stride(1), out.stride(2), lse.data_ptr(), B, H, L,
        d, lp, _stream())
    _cuda.check(lib, err, "attention_wgmma_tf32_forward")
    return out, lse


def _attention_backward_kernel(g: torch.Tensor, q: torch.Tensor,
                               k: torch.Tensor, v: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor):
    """(dq, dk, dv), (B, H, L, d) f32, of the cotangent g of O on the
    kernel, from the forward's O and lse."""
    B, H, L, d = q.shape
    dq = torch.zeros((B, H, L, d), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    if dq.numel() == 0:
        return dq, dk, dv
    g, gs = _attention_view(g)
    out, os_ = _attention_view(out)
    q, qs = _attention_view(q)
    k, ks = _attention_view(k)
    v, vs = _attention_view(v)
    lp = -(-L // 8) * 8
    lib = _cuda.library()
    dsum = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    err = lib.attention_rowdot(out.data_ptr(), *os_, g.data_ptr(), *gs,
                               dsum.data_ptr(), B, H, L, d, _stream())
    _cuda.check(lib, err, "attention_rowdot")
    kp, kt = _attention_planes(k, ks, lp, True, True)
    vp, _ = _attention_planes(v, vs, lp, True, False)
    err = lib.attention_wgmma_tf32_backward(
        q.data_ptr(), *qs, g.data_ptr(), *gs, kp.data_ptr(), vp.data_ptr(),
        kt.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, L, d, lp, _stream())
    _cuda.check(lib, err, "attention_wgmma_tf32_backward")
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d)) v of q, k, v (B, heads, L, d), no mask; the
    forward keeps its output and logsumexp for its backward. Forward and
    backward each go where :func:`attention_route` sends them."""

    @staticmethod
    def forward(ctx, q, k, v):
        with tracing.span(tracing.ATTENTION_FORWARD):
            where = attention_route(q.dtype, q.device.type, q.shape[-1])
            attention_routes[where] += 1
            ctx.where = where
            if where == "kernel":
                with torch.cuda.device(q.device):
                    out, lse = _attention_forward_kernel(q, k, v)
                ctx.save_for_backward(q, k, v, out, lse)
            elif where == "library":
                out, lse, seed, offset = \
                    torch.ops.aten._scaled_dot_product_efficient_attention(
                        q, k, v, None, True)
                ctx.save_for_backward(q, k, v, out, lse, seed, offset)
            else:
                out, lse = \
                    torch.ops.aten._scaled_dot_product_flash_attention_for_cpu(
                        q, k, v)
                ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        with tracing.span(tracing.ATTENTION_BACKWARD):
            attention_routes[ctx.where] += 1
            if ctx.where == "kernel":
                with torch.cuda.device(g.device):
                    dq, dk, dv = _attention_backward_kernel(
                        g, *ctx.saved_tensors)
                return dq, dk, dv
            if g.stride(-1) != 1:
                g = g.contiguous()
            if ctx.where == "library":
                q, k, v, out, lse, seed, offset = ctx.saved_tensors
                dq, dk, dv, _ = \
                    torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                        g, q, k, v, None, out, lse, seed, offset, 0.0,
                        [True, True, True, False])
            else:
                q, k, v, out, lse = ctx.saved_tensors
                dq, dk, dv = torch.ops.aten.\
                    _scaled_dot_product_flash_attention_for_cpu_backward(
                        g, q, k, v, out, lse, 0.0, False)
        return dq, dk, dv


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention of q, k, v (B, heads, L, d), the last
    axis contiguous, through :class:`_Attention` (with or without a
    gradient)."""
    counts["attention"] += 1
    return _Attention.apply(q, k, v)


def conv_transpose_patches(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor]) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, b, stride=k)`` of x (N, Ci, H, W) with w
    (Ci, Co, k, k), whose output patches do not overlap: each input pixel's
    Ci values times w, read as a (Ci, k k Co) matrix, give its k x k patch
    of Co channels (one :func:`linear`), and the patches are laid out in
    place (one copy). The output is (N, Co, k H, k W), channels_last in
    memory."""
    N, Ci, H, W = x.shape
    Co, k = w.shape[1], w.shape[2]
    # rows (kh, kw, Co) of the product, so that a patch row is contiguous
    wt = w.permute(2, 3, 1, 0).reshape(k * k * Co, Ci)
    bias = None if b is None else b.repeat(k * k)
    y = linear(x.permute(0, 2, 3, 1), wt, bias)          # (N, H, W, k k Co)
    y = y.view(N, H, W, k, k, Co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(N, H * k, W * k, Co).permute(0, 3, 1, 2)
