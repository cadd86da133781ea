"""The linear's GEMMs (``consistent_depth_tpu_torch/ops/transformer.py``,
``_Linear``) and their kernel, ``csrc/linear_wgmma_tf32.cu``.

On the CPU, where the plain ``torch.mm`` version stands in for the kernel:

- the routing: CPU and meta tensors take the plain version, f32 on the card
  the kernel, bf16 and f64 on the card the library; the route counter
  counts each GEMM of each direction;
- a plain emulation of the kernel's 3xTF32 arithmetic (the TF32 rounding
  done on the f32 bits, as the kernel does it): big + small reproduce f32
  operands to within 2^-22 of their size, and the emulated product (three
  TF32 products a product, chained onto a partial that truncates as the
  tensor cores do, flushed every FLUSH_K8 k8 steps onto an f32 sum that
  rounds to nearest) of dav2-small's shapes lies as close to the f64
  product as f32's own ``torch.mm`` does;
- the plan: at each of dav2-large's shapes, each direction, and at ragged
  sizes, every output element is written once a split, every element of the
  reduction summed exactly once, every unit taken by one block;
- ``ops/_cuda.py``'s argtypes against the C entries' declarations.

On the card (marked ``card``; they skip without one, and import no JAX, so
that ``python -m pytest tests/test_torch_linear_wgmma.py --noconftest -m
card`` runs them on the card's machine): each direction at each of
dav2-large's shapes against an f64 product, within twice the library's f32
SGEMM's own error there; two runs bitwise equal; and a full-size
dav2-large forward and backward in f32 routes its 294 GEMMs to the kernel
and none to the library, in bf16 none to the kernel. They share their
operands and calls with ``chip_smoke.py``'s phase 17, which also times the
kernel beside the library and reads the routes of a full train step.
"""

import ctypes
import re
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from consistent_depth_tpu_torch.ops import _cuda
from consistent_depth_tpu_torch.ops import transformer as tr

SOURCE = _cuda.CSRC_DIR / "linear_wgmma_tf32.cu"
# dav2-large at 518 x 882, batch 8 frames: (M, N, K) of the four linears of
# a block over 8 x 2332 tokens, and of the two transposed convs over 8 x
# 2331 patches (chip_smoke.py's phase 17 checks and times the same)
DAV2_LARGE = {name: shape for name, (shape, _) in cs.LINEAR_SHAPES.items()}
DIRECTIONS = cs.LINEAR_DIRECTIONS
# dav2-small (ViT-S/14: width 384, MLP 1536) over 2 x 47 tokens
DAV2_SMALL = {"qkv": (94, 1152, 384), "proj": (94, 384, 384),
              "fc1": (94, 1536, 384), "fc2": (94, 384, 1536)}
RAGGED = [(1, 8, 4), (129, 130, 36), (1000, 72, 4100), (18657, 100, 3)]
# the kernel's k8 steps chained onto a partial before it is flushed
FLUSH_K8 = int(re.search(r"constexpr int FLUSH_K8 = (\d+);",
                         SOURCE.read_text()).group(1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,device,want", [
    (torch.float32, "cuda", "kernel"), (torch.bfloat16, "cuda", "library"),
    (torch.float64, "cuda", "library"), (torch.float16, "cuda", "library"),
    (torch.float32, "cpu", "plain"), (torch.bfloat16, "cpu", "plain"),
    (torch.float64, "cpu", "plain"), (torch.float32, "meta", "plain")])
def test_route(dtype, device, want):
    assert tr.route(dtype, device) == want


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("needs", [(True, True, True), (False, True, True),
                                   (True, False, False)],
                         ids=["all", "weight", "input"])
def test_route_counter_counts_each_direction(device, needs):
    """One GEMM for the forward, one for each operand's gradient; the bias's
    gradient is a sum, no GEMM. Meta tensors run the plain version's shapes
    alone."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 12), generator=g).to(device)
    w = torch.randn((8, 12), generator=g).to(device)
    b = torch.randn((8,), generator=g).to(device)
    x.requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    b.requires_grad_(needs[2])
    tr.reset_counts()
    y = tr.linear(x, w, b)
    assert y.shape == (2, 5, 8) and y.device.type == device
    assert tr.linear_routes == {"kernel": 0, "library": 0, "plain": 1}
    y.sum().backward()
    assert tr.linear_routes["plain"] == 1 + sum(needs[:2])
    assert tr.linear_routes["kernel"] == tr.linear_routes["library"] == 0
    assert tr.launch_counts() == (1, 0)
    if device == "cpu":
        xd, wd, bd = (t.detach().double().requires_grad_() for t in (x, w, b))
        F.linear(xd, wd, bd).sum().backward()
        assert torch.allclose(y.double(), F.linear(xd, wd, bd), atol=1e-5)
        for got, want in zip((x, w, b), (xd, wd, bd)):
            if got.requires_grad:
                assert torch.allclose(got.grad.double(), want.grad, atol=1e-5)
    tr.reset_counts()
    assert tr.linear_routes == {"kernel": 0, "library": 0, "plain": 0}


def test_operand_copied_or_refused():
    """An operand the kernel cannot read as it lies is copied; one whose
    rows cannot be read at all raises (no fallback)."""
    t = torch.zeros((6, 16))
    assert tr._taken(t) and tr._operand(t, "x") is t
    strided = torch.zeros((6, 32))[:, ::2]
    assert not tr._taken(strided)
    copy = tr._operand(strided, "x")
    assert copy.is_contiguous() and tr._taken(copy)
    odd_rows = torch.zeros((7, 18))[:, :16]      # rows of 18 elements
    assert not tr._taken(odd_rows) and tr._taken(tr._operand(odd_rows, "x"))
    with pytest.raises(ValueError, match="multiple of 4"):
        tr._operand(torch.zeros((6, 10)), "x")


# -- the 3xTF32 arithmetic, emulated -------------------------------------------

def tf32_round(v):
    """f32 values rounded to TF32 as the kernel's tf32_round does it: half
    of the 13 dropped bits added to the magnitude's bits (nearest, ties away
    from zero, cvt.rna), the 13 bits cleared."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_split(v):
    big = tf32_round(v)
    return big, tf32_round(np.float32(v) - big)


def round_to_zero(v64):
    """f64 values rounded to f32 toward zero."""
    v32 = v64.astype(np.float32)
    over = np.abs(v32.astype(np.float64)) > np.abs(v64)
    v32[over] = np.nextafter(v32[over], np.float32(0))
    return v32


def emulated_gemm(a, b, phase=0):
    """out = a @ b.T of f32 a (R, K) and b (C, K) as the kernel computes
    it: each k8 step's three TF32 products (big big, big small, small big),
    each added onto the partial with truncation to f32, the partial added
    onto the accumulator in f32, rounding to nearest, before each step
    whose number plus ``phase`` is a multiple of FLUSH_K8 (the second
    warpgroup's rows at half a period)."""
    R, K = a.shape
    ab, asm = tf32_split(a)
    bb, bs = tf32_split(b)
    acc = np.zeros((R, b.shape[0]), np.float32)
    part = np.zeros_like(acc)
    for step, k in enumerate(range(0, K, 8)):
        if (step + phase) % FLUSH_K8 == 0 and step:
            acc = (acc + part).astype(np.float32)
            part[:] = 0
        sl = slice(k, k + 8)
        for x, y in ((ab, bb), (ab, bs), (asm, bb)):
            prod = x[:, sl].astype(np.float64) @ y[:, sl].astype(np.float64).T
            part = round_to_zero(part.astype(np.float64) + prod)
    return (acc + part).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_split_reproduces_f32():
    g = np.random.default_rng(0)
    v = np.concatenate([
        g.standard_normal(100_000).astype(np.float32),
        (g.standard_normal(1000) * 1e-30).astype(np.float32),
        (g.standard_normal(1000) * 1e30).astype(np.float32),
        np.float32([1.0, -1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11)])])
    big, small = tf32_split(v)
    for p in (big, small):
        assert not (p.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(v.astype(np.float64) - big.astype(np.float64)
                 - small.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(v.astype(np.float64))).all()
    assert (np.abs(v - big) <= 2.0 ** -11 * np.abs(v)).all()
    # ties go away from zero, as cvt.rna
    assert tf32_round(np.float32([1 + 2 ** -11]))[0] == np.float32(
        1 + 2 ** -10)
    assert tf32_round(np.float32([-(1 + 2 ** -11)]))[0] == np.float32(
        -(1 + 2 ** -10))


@pytest.mark.parametrize("direction", ["forward", "grad_input",
                                       "grad_weight"])
@pytest.mark.parametrize("name", sorted(DAV2_SMALL))
def test_emulated_product_within_f32_error(name, direction):
    """The emulation of each direction at dav2-small's shapes against the
    f64 product: its gap within f32 ``torch.mm``'s own, with a margin of
    2x for the other rounding, as the card's test holds the kernel."""
    M, N, K = DAV2_SMALL[name]
    g = np.random.default_rng(zlib.crc32(f"{name}.{direction}".encode()))
    x = g.standard_normal((M, K)).astype(np.float32)
    w = (g.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    ct = g.standard_normal((M, N)).astype(np.float32)
    a, b = {"forward": (x, w), "grad_input": (ct, w.T),
            "grad_weight": (ct.T, x.T)}[direction]
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    f32 = (torch.from_numpy(a) @ torch.from_numpy(b).T).numpy()
    for phase in (0, FLUSH_K8 // 2):
        got = emulated_gemm(a, b, phase)
        assert _rel(got, exact) <= 2 * _rel(f32, exact), (
            phase, _rel(got, exact), _rel(f32, exact))
    # one TF32 product alone is far outside it
    one = tf32_round(a).astype(np.float64) @ tf32_round(b).astype(
        np.float64).T
    assert _rel(one, exact) > 10 * _rel(f32, exact)


# -- the plan ------------------------------------------------------------------

def _units(plan):
    """Each block's units in the order the kernel takes them (``unit_of``
    in the source): (first row, first column, split, first k-block, end
    k-block)."""
    tiles = plan.tiles_r * plan.tiles_c
    for block in range(plan.blocks):
        for u in range(block, tiles * plan.split, plan.blocks):
            tile, sp = u % tiles, u // tiles
            yield ((tile // plan.tiles_c) * tr.TILE_ROWS,
                   (tile % plan.tiles_c) * tr.TILE_COLS, sp,
                   sp * plan.kblocks // plan.split,
                   (sp + 1) * plan.kblocks // plan.split)


def _gemms(M, N, K):
    return [(d, *cs.linear_gemm(d, M, N, K)) for d in DIRECTIONS]


def _check_plan(R, C, Kr):
    plan = tr._plan(R, C, Kr)
    tiles = plan.tiles_r * plan.tiles_c
    assert 1 <= plan.split <= min(tr.MAX_SPLIT, plan.kblocks)
    assert plan.blocks == min(tiles * plan.split, tr.SMS)
    assert plan.kblocks * tr.STAGE_K >= Kr > (plan.kblocks - 1) * tr.STAGE_K
    assert plan.workspace == (plan.split * R * C if plan.split > 1 else 0)
    written = np.zeros((plan.split, R, C), np.int32)
    summed = np.zeros((plan.tiles_r, plan.tiles_c, plan.kblocks), np.int32)
    units = list(_units(plan))
    assert len(units) == len(set(units)) == tiles * plan.split
    for r0, c0, sp, kb0, kb1 in units:
        assert kb1 > kb0
        written[sp, r0:r0 + tr.TILE_ROWS, c0:c0 + tr.TILE_COLS] += 1
        summed[r0 // tr.TILE_ROWS, c0 // tr.TILE_COLS, kb0:kb1] += 1
    assert (written == 1).all()
    assert (summed == 1).all()
    return plan


@pytest.mark.parametrize("name", sorted(DAV2_LARGE))
def test_plan_covers_dav2_large(name):
    """Each direction of each linear of a dav2-large step: every output
    element written once a split, every k-block of the reduction summed
    once; the grad-weight's reduction over all 18,656 (18,648) rows split
    until the units fill the card."""
    M, N, K = DAV2_LARGE[name]
    for direction, R, C, Kr in _gemms(M, N, K):
        plan = _check_plan(R, C, Kr)
        units = plan.tiles_r * plan.tiles_c * plan.split
        assert units / (-(-units // tr.SMS) * tr.SMS) >= tr.WAVE_FILL, (
            direction, plan)
        if direction == "grad_weight":
            assert Kr == M and (R, C) == (max(N, K), min(N, K))


@pytest.mark.parametrize("M,N,K", RAGGED)
def test_plan_covers_ragged(M, N, K):
    for _, R, C, Kr in _gemms(M, N, K):
        _check_plan(R, C, Kr)


def test_plan_mirrors_the_kernel():
    """The tile and stage sizes and the unit order are the kernel's."""
    text = SOURCE.read_text()
    for name, value in (("BM", tr.TILE_ROWS), ("BN", tr.TILE_COLS),
                        ("BK", tr.STAGE_K)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
    assert "const int tile = u % p.tiles;" in text
    assert "sp = u / p.tiles;" in text
    assert "r0 = (tile / p.tiles_c) * BM;" in text


# -- the C entries -------------------------------------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64}


def _c_entry_argtypes(name):
    text = SOURCE.read_text()
    extern = text[text.index('extern "C" {'):]
    m = re.search(r"int\s+" + name + r"\s*\(([^)]*)\)", extern)
    assert m, name
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [p.rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    return [_C_TYPES[t] for t in types]


@pytest.mark.parametrize("name,want", [
    ("linear_wgmma_tf32", _cuda.LINEAR_ARGTYPES),
    ("linear_tf32_split", _cuda.LINEAR_SPLIT_ARGTYPES)])
def test_entries_match_argtypes(name, want):
    assert _c_entry_argtypes(name) == want


# -- on the card ---------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", sorted(DAV2_LARGE))
def test_kernel_against_f64_on_the_card(card, name, direction):
    torch.backends.cuda.matmul.allow_tf32 = False
    M, N, K = DAV2_LARGE[name]
    ops = cs.linear_operands(torch, M, N, K,
                             seed=len(name) * 7 + len(direction), device=card)
    want = cs.linear_library(torch, direction, *(t.double() for t in ops))
    tr.reset_counts()
    got = cs.linear_kernel(tr, direction, *ops)
    assert tr.linear_routes["kernel"] == 1
    library = cs.linear_library(torch, direction, *ops)
    assert got.shape == want.shape and got.dtype == torch.float32
    gap, lib_gap = cs.linear_gap(got, want), cs.linear_gap(library, want)
    assert gap <= 2 * lib_gap, (gap, lib_gap)


@pytest.mark.card
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("shape", [DAV2_LARGE["proj"], DAV2_LARGE["ct4"],
                                   (1000, 72, 4100), (129, 132, 36)],
                         ids=["proj", "ct4", "ragged_wide", "ragged"])
def test_kernel_bitwise_repeatable_on_the_card(card, shape, direction):
    ops = cs.linear_operands(torch, *shape, seed=5, device=card)
    first = cs.linear_kernel(tr, direction, *ops)
    second = cs.linear_kernel(tr, direction, *ops)
    assert torch.equal(first, second)
    want = cs.linear_library(torch, direction, *(t.double() for t in ops))
    assert cs.linear_gap(first, want) < 1e-5


@pytest.mark.card
def test_full_step_routes_on_the_card(card):
    """dav2-large at full size, a train step of 2 frames at 518 x 882: the
    f32 step's 98 linears run their 294 GEMMs on the kernel, the bf16
    step's on the library."""
    from consistent_depth_tpu_torch.models.depth_anything_v2 import (
        DepthAnythingV2)

    with torch.device("meta"):
        net = DepthAnythingV2()
    net = net.to_empty(device=card).to(memory_format=torch.channels_last)
    g = torch.Generator(device=card).manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=card) * 0.02)
    x = torch.rand((2, 3, 518, 882), generator=g, device=card)
    for dtype, routes in ((torch.float32, {"kernel": 294, "library": 0}),
                          (torch.bfloat16, {"kernel": 0, "library": 294})):
        net.zero_grad(set_to_none=True)
        tr.reset_counts()
        disp = net(x.to(dtype))
        disp.float().mean().backward()
        torch.cuda.synchronize()
        assert tr.launch_counts() == (98, 24)
        assert {k: tr.linear_routes[k] for k in routes} == routes
        assert tr.linear_routes["plain"] == 0
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        assert all(bool(torch.isfinite(t).all()) for t in grads)
