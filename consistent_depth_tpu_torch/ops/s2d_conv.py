"""Stride-1, same-padding, odd-k 2-D convolution: the port of
``consistent_depth_tpu/ops/s2d_conv.py``.

The JAX package computes this conv on the TPU with a Pallas kernel that
relays the input into space-to-depth form inside VMEM, because the
hourglass's narrow convs (C_out 16/32) would otherwise fill a fraction of
the MXU's 128 lanes (``consistent_depth_tpu/models/layers.py``, the
space-to-depth section). Hopper has no 128-lane constraint, so the port's
CUDA kernels compute the conv directly, with no relayout. Its routes:

- ``"wgmma"``, ``csrc/same_conv_wgmma.cu``: bf16 on Hopper's warpgroup
  tensor-core instruction (``wgmma.mma_async``, A from registers read by
  ``ldmatrix`` from a halo tile, B from shared memory), with the weights and
  the halo tile fed by TMA through an mbarrier ring, a producer warp apart
  from the consumer warpgroups;
- ``"tc"``, ``csrc/same_conv_tc.cu``: the earlier bf16 design, an implicit
  GEMM on ``mma.sync`` fed by ``ldmatrix`` from a halo tile that
  ``cp.async`` stages in shared memory (the machinery is
  ``csrc/same_conv_tc.cuh``); it keeps the bf16 convs whose reduction is
  loaded by element (the stem's 3 input channels, the merged heads'
  2-channel cotangent), which TMA's 16-byte strides cannot take, and
  those of 16 output or reduction channels, where it ran faster on the
  card (``WGMMA_THIN``);
- ``"wgmma_tf32"``, ``csrc/same_conv_wgmma_tf32.cu``: f32 (the fine-tune's
  default precision) on ``wgmma.mma_async`` in 3xTF32 (every product split
  into three TF32 products, which keeps f32's accuracy), with the weight
  split beforehand into a big and a small TF32 plane by a kernel of its
  own, and the planes and the halo tile fed by TMA (the machinery it shares
  with ``"wgmma"`` is ``csrc/same_conv_wgmma.cuh``);
- ``"tf32"``, ``csrc/same_conv_tf32.cu``: the earlier f32 design, the
  ``"tc"`` implicit GEMM in 3xTF32; it keeps the f32 convs whose reduction
  is loaded by element (the stem, the heads' grad-input) and those of 16 or
  fewer output channels, where it ran faster on the card
  (``WGMMA_TF32_THIN``).

No kernel takes a grad-input into a channel count that is not a whole
16-byte unit, and on the card such a call raises (the one such class is
mc's stem, whose input, the images, never needs a gradient).

:func:`_plan` picks the route, the tile and the split of the reduction for
one call, from the shapes alone. Layouts are the JAX package's: x NHWC
``(N, H, W, Ci)``, w HWIO ``(k, k, Ci, Co)``, out NHWC ``(N, H, W, Co)`` in
x's dtype. Any strides are accepted, so channels_last activations and OIHW
weights pass in as permuted views without a copy; the tensor-core routes
copy a tensor whose channels are not contiguous or 16-byte aligned, and
count the copy. The forward, the grad-input and the grad-weight each run
in a span of ``..utils.tracing`` (``kxk.forward``, ``kxk.grad_input``,
``kxk.grad_weight``), on every device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _cuda

# kernel sizes the CUDA kernels are instantiated for: those of the hourglass
KERNEL_SIZES = (3, 5, 7, 11)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the tensor-core kernels' tiles: 16 output columns by 4, 8 or 16 rows,
# output-channel blocks of 16, 32 or (bf16) 64; a step of the reduction is
# 32 bytes of each pixel's channels (two 16-byte units), by dtype
TILE_W = 16
TILE_HEIGHTS = (16, 8, 4)
MAX_CO_BLOCK = {torch.bfloat16: 64, torch.float32: 32}
CHUNK = {torch.bfloat16: 16, torch.float32: 8}
# the "wgmma" kernel's output-channel blocks (wgmma's N) and reduction
# chunks (16, 32 or 64 channels, each tap of a chunk one stage of its
# ring); the 16-row tile holds two m64 tiles per consumer warpgroup, which
# the registers allow for blocks of up to 64 channels
WGMMA_CO_BLOCKS = (16, 32, 64, 128)
WGMMA_CHUNKS = (16, 32, 64)
WGMMA_TALL_MAX_CO_BLOCK = 64
# the "wgmma_tf32" kernel's: blocks of up to 64 channels (the accumulator,
# its partial and two buffers of split A fragments share the registers),
# two m64 tiles per warpgroup for blocks of up to 32; a chunk of 16 f32
# channels (64 bytes of each pixel, the 64-byte swizzle), whose two halo
# tiles leave a k=11 tap row's 11 stages room at every tile height, or of
# 32 (the 128-byte swizzle) for a k=3 reduction over more than 16 channels
# at tiles of one m64 per warpgroup (4 or 8 rows), where it ran faster on
# the card; at 16-row tiles for k >= 7 each chunk's halo is split once in
# shared memory, into a second copy (csrc/same_conv_wgmma_tf32.cu, chunk_of
# and smem_split_of)
WGMMA_TF32_CO_BLOCKS = (16, 32, 64)
WGMMA_TF32_CHUNKS = (16, 32)
WGMMA_TF32_WIDE_CHUNK_K = 3
WGMMA_TF32_TALL_MAX_CO_BLOCK = 32
WGMMA_TF32_SMEM_SPLIT_MIN_K = 7
# its shared memory: the halo tiles (two where the reduction has more
# than one chunk), a ring of weight stages (one tap each, at most 24), each
# rounded to the 1024-byte swizzle repeat, the barriers and the alignment;
# at most what one block may have (227 KB). A consumer holds a commit
# group's taps (four k16 steps: 64 / chunk taps) while it waits for the
# next group's, so the ring needs two groups
WGMMA_SMEM = 232448
WGMMA_ALIGN = 1024
WGMMA_GROUP_STEPS = 4
WGMMA_MAX_STAGES = 24
# a "wgmma_tf32" stage holds a tap's big and small weight boxes, and a
# commit group is one tap
WGMMA_TF32_PLANES = 2
WGMMA_TF32_GROUP_TAPS = 1
# bf16 classes that "tc" ran faster than "wgmma" on the card, which take
# "tc": an output-channel block of 16 (wgmma's N = 16, where each m64n16k16
# reads as many A bytes from shared memory as an m64n64k16) or a reduction
# of 16 channels (one k16 step a tap). The card's times, device time alone
# (tools/torch_conv_wgmma.py, NVIDIA H100 80GB HBM3, 700.00 W), "wgmma"
# against "tc", in us, of mc's classes at batch 8 (x, then w as k, Ci->Co):
#   forward 224x384x64, 11 64->16: 984.9 / 748.0; 7 64->16: 438.1 / 345.3;
#     3 64->16: 135.7 / 100.2; 3 64->2: 136.7 / 99.9;
#   forward 112x192x32, 11 32->16: 202.9 / 111.2; 7 32->16: 92.8 / 54.6;
#     3 32->16: 31.9 / 17.8;
#   grad-input 224x384x16, 11 64->16: 597.4 / 497.9; 7 64->16: 306.4 /
#     280.3; 3 64->16: 156.9 / 118.9;
#   grad-input 112x192x16, 11 32->16: 158.1 / 84.9; 7 32->16: 75.8 / 40.1;
#     3 32->16: 31.7 / 14.2.
# Every other class of mc, midas2 and monodepth2 ran faster on "wgmma" or
# within a few us of "tc" (PERF.md section 6).
WGMMA_THIN = 16
# f32 classes that "tf32" ran faster than "wgmma_tf32" on the card, which
# take "tf32": 16 or fewer output channels (wgmma's N = 16, where each
# m64n16k8 carries as many A fragments as an m64n64k8, three times over).
# Device time alone (tools/torch_conv_wgmma.py --dtype f32, NVIDIA H100 80GB
# HBM3, 700.00 W), "wgmma_tf32" against "tf32", in us, of mc's forward
# classes at batch 8 (x, then w as k, Ci->Co):
#   224x384x64, 11 64->16: 4223.5 / 3257.7; 7 64->16: 1800.4 / 1304.4;
#     3 64->16: 366.0 / 344.8; 3 64->2: 364.7 / 343.3;
#   112x192x32, 11 32->16: 632.4 / 488.5; 7 32->16: 269.6 / 203.5;
#     3 32->16: 65.6 / 56.6.
# Every other f32 class of mc, midas2 and monodepth2 ran faster on
# "wgmma_tf32", 0.27-0.95 of "tf32"'s time, but mc's 14x24 3x3 32->64,
# a few us either way (19.2 / 14.3 forward, 17.3 / 15.4 grad-input; PERF.md
# section 6).
WGMMA_TF32_THIN = 16
# the routes (module docstring); each dtype's wgmma route, and its
# tensor-core route for what the wgmma route does not take
ROUTES = ("tc", "tf32", "wgmma", "wgmma_tf32")
_WGMMA_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "wgmma_tf32"}
_TC_ROUTE = {torch.bfloat16: "tc", torch.float32: "tf32"}
# an H100 SXM's streaming multiprocessors; a grid below two blocks per SM
# leaves the card under-filled
SMS = 132
MIN_BLOCKS = 2 * SMS

# the CUDA kernel launches of :func:`same_conv` and of
# :func:`same_conv_grad_input` by route (ROUTES; one per call), the split-K
# reduction passes, the tensors the tensor-core routes copied to make their
# channels contiguous and aligned, and the launches of the "wgmma_tf32"
# weight split (one per call on that route, and one per :func:`split_tf32`
# on the card)
route_counts = dict.fromkeys(
    [f"{d}_{r}" for d in ("forward", "grad_input") for r in ROUTES]
    + ["split_reduce", "layout_copies", "weight_split"], 0)


def launch_counts() -> Tuple[int, int]:
    """(forward, grad-input) conv launches: :data:`route_counts` summed
    over each direction's routes."""
    return tuple(sum(route_counts[f"{d}_{r}"] for r in ROUTES)
                 for d in ("forward", "grad_input"))


def reset_counts() -> None:
    """Zero :data:`route_counts`."""
    for key in route_counts:
        route_counts[key] = 0


def co_block(channels: int, dtype: torch.dtype) -> int:
    """The tensor-core kernels' output-channel block for ``channels`` of
    ``dtype``."""
    return 16 if channels <= 16 else min(32 if channels <= 32 else 64,
                                         MAX_CO_BLOCK[dtype])


def _unit(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in one 16-byte unit of the tensor-core
    kernels' copies."""
    return 16 // dtype.itemsize


def wgmma_co_block(channels: int,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """The wgmma route's output-channel block (wgmma's N) for ``channels``
    output channels of ``dtype``."""
    blocks = (WGMMA_CO_BLOCKS if dtype == torch.bfloat16
              else WGMMA_TF32_CO_BLOCKS)
    return next((b for b in blocks[:-1] if channels <= b), blocks[-1])


def wgmma_chunk(channels: int, k: int = 1, split: int = 1,
                dtype: torch.dtype = torch.bfloat16,
                tile_h: int = 4) -> int:
    """The wgmma route's reduction channels per chunk for a reduction over
    ``channels`` of ``dtype`` with k x k taps, as its source picks it. bf16:
    the fewest of WGMMA_CHUNKS that hold the reduction, halved while a
    split over ``split`` blocks would find fewer steps (a chunk by a tap
    row); f32: 32 for k = WGMMA_TF32_WIDE_CHUNK_K over more than 16
    channels at a tile of ``tile_h`` < 16 rows where a split over ``split``
    blocks finds as many steps, else 16."""
    if dtype != torch.bfloat16:
        wide = (k == WGMMA_TF32_WIDE_CHUNK_K and channels > WGMMA_TF32_CHUNKS[0]
                and tile_h < 16
                and math.ceil(channels / WGMMA_TF32_CHUNKS[1]) * k >= split)
        return WGMMA_TF32_CHUNKS[wide]
    chunk = next((c for c in WGMMA_CHUNKS[:-1] if channels <= c),
                 WGMMA_CHUNKS[-1])
    while chunk > WGMMA_CHUNKS[0] and math.ceil(channels / chunk) * k < split:
        chunk //= 2
    return chunk


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def wgmma_fits(k: int, tile_h: int, red: int, cob: int,
               dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the wgmma route's shared memory (``csrc/same_conv_wgmma.cu``
    for bf16, ``csrc/same_conv_wgmma_tf32.cu`` for f32) holds the halo
    tiles of ``tile_h`` + k - 1 rows by TILE_W + k - 1 columns of a chunk
    of channels of a reduction over ``red`` and a ring of two commit
    groups' weight stages, and of a tap row's k (the producer fills a row
    at once), for an output-channel block ``cob``. An f32 stage holds a
    tap's big and small weight boxes, and a halo split in shared memory
    (16-row tiles, k >= WGMMA_TF32_SMEM_SPLIT_MIN_K) a second copy."""
    size = dtype.itemsize
    chunk = wgmma_chunk(red, k, dtype=dtype, tile_h=tile_h)
    halo = _round_up((tile_h + k - 1) * (TILE_W + k - 1) * chunk * size,
                     WGMMA_ALIGN)
    if dtype == torch.bfloat16:
        stage = _round_up(chunk * cob * size, WGMMA_ALIGN)
        taps_per_group = WGMMA_GROUP_STEPS // (chunk // 16)
    else:
        stage = WGMMA_TF32_PLANES * _round_up(chunk * cob * size, WGMMA_ALIGN)
        taps_per_group = WGMMA_TF32_GROUP_TAPS
    halos = 2 if red > chunk else 1
    if (dtype != torch.bfloat16 and tile_h == 16
            and k >= WGMMA_TF32_SMEM_SPLIT_MIN_K):
        halos *= 2
    fixed = WGMMA_ALIGN + halos * halo + 32 + 16 * WGMMA_MAX_STAGES
    stages = min((WGMMA_SMEM - fixed) // stage, WGMMA_MAX_STAGES)
    return stages >= max(2 * taps_per_group, k)


def _wgmma_takes(dtype: torch.dtype, red: int, out: int,
                 grad_input: bool) -> bool:
    """Whether the dtype's wgmma route takes a conv reducing over ``red``
    into ``out`` channels: the reduction a whole number of 16-byte units,
    8 bf16 or 4 f32 (TMA's strides), and a grad-input's output channels
    too (bf16: the weight's contiguous dimension there)."""
    unit = _unit(dtype)
    return (dtype in _WGMMA_ROUTE and red % unit == 0
            and (not grad_input or out % unit == 0))


def _wgmma_tall_max(dtype: torch.dtype) -> int:
    """The largest output-channel block the wgmma route of ``dtype`` runs
    at the 16-row tile (two m64 tiles per consumer warpgroup)."""
    return (WGMMA_TALL_MAX_CO_BLOCK if dtype == torch.bfloat16
            else WGMMA_TF32_TALL_MAX_CO_BLOCK)


def _wgmma_slower(dtype: torch.dtype, red: int, out: int) -> bool:
    """Whether the dtype's tensor-core route ran a class reducing over
    ``red`` into ``out`` channels faster than its wgmma route on the card:
    bf16 with 16 or fewer output or reduction channels (WGMMA_THIN), f32
    with 16 or fewer output channels (WGMMA_TF32_THIN)."""
    if dtype == torch.bfloat16:
        return min(red, out) <= WGMMA_THIN
    return out <= WGMMA_TF32_THIN


@functools.lru_cache(maxsize=4096)
def _plan(dtype: torch.dtype, N: int, H: int, W: int, Ci: int, Co: int,
          k: int, grad_input: bool = False,
          route: Optional[str] = None) -> Tuple[str, int, int]:
    """``(route, tile_h, split)`` for one conv on the card: the forward of
    x (N, H, W, Ci) with w (k, k, Ci, Co), or with ``grad_input`` its
    grad-input, a conv reducing over Co into Ci channels.

    Each dtype takes its wgmma route ("wgmma" for bf16, "wgmma_tf32" for
    f32) wherever it can (:func:`_wgmma_takes`, and a tile that
    :func:`wgmma_fits`) but where its tensor-core route ran faster on the
    card (:func:`_wgmma_slower`: bf16 with 16 or fewer output or reduction
    channels, f32 with 16 or fewer output channels), else its tensor-core
    route ("tc", "tf32"), which also loads a
    reduction of a channel count that is not a whole number of 16-byte
    units by element (the stem's 3, the merged heads' 2). A grad-input
    into a number of channels that is not a whole number of 16-byte units,
    8 bf16 or 4 f32 (the kernels copy its weight in units along them),
    raises: no kernel takes it. ``route`` names
    a route of the dtype to plan instead (the card's check times the two
    kernels of a dtype on the same inputs).

    The tile is the tallest of 16, 8, 4 rows that gives at least
    MIN_BLOCKS blocks (16 only from twice that, so that the taller tile,
    which re-reads less halo and weight per output, still leaves each SM a
    few blocks); a wgmma route takes 16 rows only for output-channel blocks
    of up to its tall maximum and a tile only where :func:`wgmma_fits`.
    Where even 4 rows give fewer blocks, the reduction's steps (a chunk of
    channels by one tap row: CHUNK[dtype] for "tc" and "tf32",
    :func:`wgmma_chunk` for the wgmma routes, where bf16 halves its chunk
    for more steps) are split over blocks, up to MIN_BLOCKS blocks."""
    red, out = (Co, Ci) if grad_input else (Ci, Co)
    wgmma = _WGMMA_ROUTE[dtype]
    if grad_input and out % _unit(dtype):
        raise ValueError(f"_plan: no kernel takes a {dtype} grad-input into "
                         f"{out} channels, not a whole number of 16-byte "
                         f"units")
    if route is None:
        route = (wgmma if _wgmma_takes(dtype, red, out, grad_input)
                 and not _wgmma_slower(dtype, red, out)
                 and wgmma_fits(k, min(TILE_HEIGHTS), red,
                                wgmma_co_block(out, dtype), dtype)
                 else _TC_ROUTE[dtype])
    elif route == wgmma and not _wgmma_takes(dtype, red, out, grad_input):
        raise ValueError(f"_plan: {wgmma} does not take {dtype} reducing "
                         f"{red} into {out} channels")
    elif route not in (wgmma, _TC_ROUTE[dtype]):
        raise ValueError(f"_plan: route {route!r} is not a tensor-core "
                         f"route of {dtype}")
    if route == wgmma:
        cob = wgmma_co_block(out, dtype)
        heights = [th for th in TILE_HEIGHTS
                   if (th < 16 or cob <= _wgmma_tall_max(dtype))
                   and wgmma_fits(k, th, red, cob, dtype)]
        if not heights:
            raise ValueError(f"_plan: no {wgmma} tile fits k={k} reducing "
                             f"{red} into {out} channels")
    else:
        cob = co_block(out, dtype)
        heights = list(TILE_HEIGHTS)
    per_row = math.ceil(W / TILE_W) * N * math.ceil(out / cob)

    def blocks(th):
        return math.ceil(H / th) * per_row

    if 16 in heights and blocks(16) >= 2 * MIN_BLOCKS:
        return route, 16, 1
    for th in (8, 4):
        if th in heights and blocks(th) >= MIN_BLOCKS:
            return route, th, 1
    want = math.ceil(MIN_BLOCKS / blocks(4))
    chunk = (wgmma_chunk(red, k, want, dtype, min(TILE_HEIGHTS))
             if route == wgmma else CHUNK[dtype])
    return route, 4, min(math.ceil(red / chunk) * k, want)


def _tc_ready(t: torch.Tensor, contiguous_dim: int, by_element: bool
              ) -> bool:
    """Whether the tensor-core kernels take ``t`` as it is:
    ``contiguous_dim`` of stride 1 and, unless the kernel loads ``t`` by
    element (a narrow reduction), the other strides whole 16-byte units (8
    bf16 or 4 f32 elements) and a 16-byte aligned base for its 16-byte
    copies."""
    unit = _unit(t.dtype)
    return t.stride(contiguous_dim) == 1 and (by_element or (
        t.data_ptr() % 16 == 0 and all(
            s % unit == 0 for d, s in enumerate(t.stride())
            if d != contiguous_dim)))


def _tc_operands(a: torch.Tensor, w: torch.Tensor, grad_input: bool):
    """The activations or cotangent a (N, H, W, C) and w (k, k, Ci, Co) as
    the tensor-core kernels take them: a with contiguous channels, w an
    HWIO view of an OIHW channels_last tensor; each copy made is counted.
    A reduction over a number of channels that is not a whole number of
    16-byte units is loaded by element (a, and the forward's w)."""
    narrow = a.shape[3] % _unit(a.dtype) != 0
    if not _tc_ready(a, 3, narrow):
        a = a.contiguous()
        route_counts["layout_copies"] += 1
    if not _tc_ready(w, 2, narrow and not grad_input):
        w = w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
        route_counts["layout_copies"] += 1
    return a, w


def _workspace(route: str, split: int, out_shape, w: torch.Tensor,
               device) -> Optional[torch.Tensor]:
    """The f32 workspace of a tensor-core route's call: the split's partial
    sums (split, *out_shape) when split > 1, after, for "wgmma_tf32", the
    weight's two TF32 planes (2 k k Ci Co); None where neither is
    needed."""
    size = split * math.prod(out_shape) if split > 1 else 0
    if route == "wgmma_tf32":
        size += WGMMA_TF32_PLANES * w.numel()
    return (torch.empty(size, dtype=torch.float32, device=device)
            if size else None)


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits) as the card's
    ``cvt.rna.tf32.f32`` does: to nearest, ties away from zero (half of the
    dropped 13 bits added to the magnitude)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_reference(w: torch.Tensor,
                         grad_input: bool = False) -> torch.Tensor:
    """Plain version of the "wgmma_tf32" weight split: the f32 weight w (k,
    k, Ci, Co) as two TF32 planes, big = tf32(w) and small = tf32(w - big),
    K-major for the direction: (2, k, k, Co, Ci) for the forward, (2, k, k,
    Ci, Co) for the grad-input (taps unflipped)."""
    v = w.float()
    if not grad_input:
        v = v.permute(0, 1, 3, 2)
    big = _tf32_rna(v)
    return torch.stack([big, _tf32_rna(v - big)])


def split_tf32(w: torch.Tensor, grad_input: bool = False) -> torch.Tensor:
    """The "wgmma_tf32" weight split (:func:`split_tf32_reference`'s
    planes): on a CUDA tensor the split kernel of
    ``csrc/same_conv_wgmma_tf32.cu``, which the conv's C entries launch
    before the conv; a CPU tensor takes the plain version."""
    if w.device.type == "cpu":
        return split_tf32_reference(w, grad_input)
    if w.device.type != "cuda" or w.dtype != torch.float32 or w.dim() != 4:
        raise ValueError(f"split_tf32: a 4-D f32 CUDA weight, not "
                         f"{w.dtype} {tuple(w.shape)} on {w.device}")
    k, k2, Ci, Co = w.shape
    shape = (2, k, k2, Ci, Co) if grad_input else (2, k, k2, Co, Ci)
    planes = torch.empty(shape, dtype=torch.float32, device=w.device)
    if planes.numel() == 0:
        return planes
    lib = _cuda.library()
    with torch.cuda.device(w.device):
        err = lib.same_conv_tf32_split_weight(
            w.data_ptr(), planes.data_ptr(), Ci, Co, k, *w.stride(),
            int(grad_input),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _cuda.check(lib, err, "split_tf32")
    route_counts["weight_split"] += 1
    return planes


def same_conv_reference(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` on permuted views."""
    k = w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                 padding=(k - 1) // 2)
    return y.permute(0, 2, 3, 1)


def same_conv_grad_input_reference(ct: torch.Tensor,
                                   w: torch.Tensor) -> torch.Tensor:
    """Plain version of the conv's grad-input, the JAX package's formula
    (``layers.py::_conv_pallas_bwd``): the same-padding conv of the
    cotangent ct (N, H, W, Co) with the flipped, channel-swapped weight
    ``w[::-1, ::-1].transpose(0, 1, 3, 2)``. Returns (N, H, W, Ci)."""
    return same_conv_reference(ct, w.flip(0, 1).permute(0, 1, 3, 2))


def _check(name: str, x: torch.Tensor, w: torch.Tensor, x_ch: int,
           others=()) -> None:
    """Raise unless x (N, H, W, x_ch) and w (k, k, ., .) can go to the
    kernel: a square k in KERNEL_SIZES, a supported dtype shared with w
    and ``others``, all on x's CUDA device."""
    k, k2 = w.shape[:2]
    if k != k2 or k not in KERNEL_SIZES:
        raise ValueError(f"{name}: kernel {tuple(w.shape[:2])} not in "
                         f"{KERNEL_SIZES} (square)")
    if x.dim() != 4 or x.shape[3] != x_ch:
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match "
                         f"weight {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    for t in (w, *others):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: tensors must share device and dtype "
                             f"(got {t.device}/{t.dtype}, input "
                             f"{x.device}/{x.dtype})")


def _launch(direction: str, a: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One checked call on a CUDA tensor in ``direction``: "forward" of x =
    ``a`` (N, H, W, Ci) with w (k, k, Ci, Co) and ``bias``, or
    "grad_input" of the cotangent ``a`` (N, H, W, Co). Launches the kernel
    of :func:`_plan`'s route on the caller's stream (a launch error
    raises) and counts it in :data:`route_counts`."""
    grad = direction == "grad_input"
    N, H, W, _ = a.shape
    k, Ci, Co = w.shape[0], w.shape[2], w.shape[3]
    shape = (N, H, W, Ci if grad else Co)
    if math.prod(shape) == 0:
        return a.new_empty(shape)
    route, tile_h, split = _plan(a.dtype, N, H, W, Ci, Co, k,
                                 grad_input=grad)
    out = a.new_empty(shape)
    a, w = _tc_operands(a, w, grad)
    ws = _workspace(route, split, shape, w, a.device)
    operands = [a.data_ptr(), w.data_ptr()]
    if not grad:
        operands.append(bias.data_ptr() if bias is not None else None)
    lib = _cuda.library()
    with torch.cuda.device(a.device):
        err = getattr(lib, f"same_conv_{route}_{direction}")(
            *operands, out.data_ptr(), _DTYPE_CODES[a.dtype], N, H, W, Ci,
            Co, k, *a.stride(), *w.stride(), tile_h, split,
            ws.data_ptr() if ws is not None else None,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _cuda.check(lib, err, "same_conv_grad_input" if grad else "same_conv")
    route_counts[f"{direction}_{route}"] += 1
    route_counts["split_reduce"] += split > 1
    route_counts["weight_split"] += route == "wgmma_tf32"
    return out


def _forward(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The conv with no autograd record: on CUDA the kernel of
    :func:`_plan`'s route, on the CPU the plain version."""
    with tracing.span(tracing.KXK_FORWARD):
        if x.device.type == "cpu":
            return same_conv_reference(x, w, bias)
        if x.device.type != "cuda":
            raise ValueError(f"same_conv: unsupported device {x.device}")
        _check("same_conv", x, w, w.shape[2],
               [bias] if bias is not None else [])
        if bias is not None:
            if bias.shape != (w.shape[3],):
                raise ValueError(f"same_conv: bias shape {tuple(bias.shape)}")
            bias = bias.contiguous()
        return _launch("forward", x, w, bias)


def same_conv_grad_input(ct: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grad-input of :func:`same_conv` for the cotangent ct (N, H, W, Co)
    and the forward's weight w (k, k, Ci, Co): (N, H, W, Ci). A CPU tensor
    takes :func:`same_conv_grad_input_reference`; a CUDA tensor launches
    the kernel of :func:`_plan`'s route on the flipped, channel-swapped
    weight (a strided view, no copy), or raises if no kernel takes the
    arguments."""
    with tracing.span(tracing.KXK_GRAD_INPUT):
        if ct.device.type == "cpu":
            return same_conv_grad_input_reference(ct, w)
        if ct.device.type != "cuda":
            raise ValueError(f"same_conv_grad_input: unsupported device "
                             f"{ct.device}")
        _check("same_conv_grad_input", ct, w, w.shape[3])
        return _launch("grad_input", ct, w)


class _SameConv(torch.autograd.Function):
    """The conv with its gradients: forward and grad-input through the
    kernels (:func:`_forward`, :func:`same_conv_grad_input`), grad-weight
    through the library's wgrad (``aten.convolution_backward``; the JAX
    package also leaves grad-weight outside its kernel), grad-bias the
    cotangent's sum in f32."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = same_conv_grad_input(ct, w)
        if ctx.needs_input_grad[1]:
            p = (w.shape[0] - 1) // 2
            with tracing.span(tracing.KXK_GRAD_WEIGHT):
                _, gw, _ = torch.ops.aten.convolution_backward(
                    ct.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                    w.permute(3, 2, 0, 1), None, [1, 1], [p, p], [1, 1],
                    False, [0, 0], 1, [False, True, False])
                gw = gw.permute(2, 3, 1, 0)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = ct.sum((0, 1, 2), dtype=torch.float32).to(ct.dtype)
        return gx, gw, gb


def same_conv(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same-padding conv of x (N, H, W, Ci) with w (k, k, Ci, Co) plus an
    optional bias (Co,). A CPU tensor takes :func:`same_conv_reference`; a
    CUDA tensor launches the kernel, or raises if the kernel does not take
    the arguments. When an input needs a gradient the call goes through
    one ``torch.autograd.Function`` on every device, whose grad-input is
    :func:`same_conv_grad_input`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _SameConv.apply(x, w, bias)
    return _forward(x, w, bias)
