"""The attention's routes (``consistent_depth_tpu_torch/ops/transformer.py``,
``_Attention``) and its kernel, ``csrc/attention_wgmma_tf32.cu``.

On the CPU, where the library's CPU flash kernel is the plain version:

- the routing: CPU and meta tensors take the plain version, f32 on the card
  the kernel (heads of 64 or 32), bf16, f16 and f64 on the card the
  library; f32 on the card with another head width raises; the route
  counter counts each forward and each backward;
- the plain version's forward and backward against an f64 softmax
  reference at ragged lengths (1, 63, 65, 129 and dav2-large's 2,332 at a
  batch of one), and at heads of 32;
- a small ViT's forward and backward: one attention a block, each counted
  on its route once forward and once backward;
- the kernel's operands: q, k and v as the views of the qkv linear's output
  are read as they lie (no copy), a tensor TMA cannot read is copied;
- the kernel's key order: P and dS, read from the accumulator as the TF32
  A fragment, against the transposed planes' keys (the split's index map)
  give the product in full;
- ``ops/_cuda.py``'s argtypes against the C entries' declarations.

On the card (marked ``card``; they skip without one, and import no JAX, so
that ``python -m pytest tests/test_torch_attention_wgmma.py --noconftest -m
card`` runs them on the card's machine): O, lse, dq, dk and dv at
dav2-large's shape, at ragged lengths and at heads of 32 against an f64
result, each within twice the library's memory-efficient kernel's own
error there (or, below one key tile, 8 f32 ulps of the largest value,
where the library's is a few ulps); two
calls bitwise equal but dq (atomic sums), within a stated band; the qkv
views read without a copy, with the same result as contiguous copies; a
full-size dav2-large forward and backward routes its 24 attentions'
forwards and backwards to the kernel in f32 and to the library in bf16.
They share their operands and calls with ``chip_smoke.py``'s phase 18,
which also times the kernel beside the library.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from consistent_depth_tpu_torch.models import vit
from consistent_depth_tpu_torch.ops import _cuda
from consistent_depth_tpu_torch.ops import transformer as tr

SOURCE = _cuda.CSRC_DIR / "attention_wgmma_tf32.cu"
RAGGED = [(1, 2, 1), (1, 2, 63), (1, 2, 65), (2, 3, 129), (1, 2, 2332)]


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
def test_attention_route(dtype, device, want):
    assert tr.attention_route(dtype, device, 64) == want


def test_attention_route_takes_heads_of_32():
    """The kernel's other head width, 32 (the small networks of the
    tests), goes to it on the card in f32 as 64 does."""
    assert tr.HEAD_DIMS == (64, 32)
    assert tr.attention_route(torch.float32, "cuda", 32) == "kernel"
    assert tr.attention_route(torch.bfloat16, "cuda", 32) == "library"
    assert tr.attention_route(torch.float32, "cpu", 32) == "plain"


@pytest.mark.parametrize("head_dim", [16, 48, 80, 128])
def test_attention_route_raises_for_other_heads_on_the_card(head_dim):
    """f32 on the card with another head width raises, no fallback; the
    other routes do not read the width."""
    with pytest.raises(ValueError, match="heads of 64 or 32, not"):
        tr.attention_route(torch.float32, "cuda", head_dim)
    assert tr.attention_route(torch.bfloat16, "cuda", head_dim) == "library"
    assert tr.attention_route(torch.float32, "cpu", head_dim) == "plain"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_route_counter_counts_forward_and_backward(device):
    q, k, v, _ = (t.to(device) for t in cs.attention_operands(
        torch, 2, 3, 5, 0, device="cpu"))
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    tr.reset_counts()
    o = tr.attention(q, k, v)
    assert o.shape == (2, 3, 5, 64) and o.device.type == device
    assert tr.attention_routes == {"kernel": 0, "library": 0, "plain": 1}
    o.sum().backward()
    assert tr.attention_routes == {"kernel": 0, "library": 0, "plain": 2}
    assert tr.launch_counts() == (0, 1)
    with torch.no_grad():
        tr.attention(q, k, v)
    assert tr.attention_routes["plain"] == 3
    tr.reset_counts()
    assert tr.attention_routes == {"kernel": 0, "library": 0, "plain": 0}


# -- the plain version against f64 ---------------------------------------------

@pytest.mark.parametrize("B,H,L", RAGGED, ids=[f"L{c[2]}" for c in RAGGED])
def test_plain_against_f64(B, H, L):
    """Forward and backward of the plain version on the qkv views: O within
    2e-6 and each gradient within 1e-5 of its largest f64 value (f32 sums
    over up to 2,332 keys), dq and dk over a single key (zero in f64)
    within 1e-6."""
    q, k, v, ct = cs.attention_operands(torch, B, H, L, seed=L, device="cpu")
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    want = cs.attention_reference(torch, q.detach(), k.detach(), v.detach(),
                                  ct)
    tr.reset_counts()
    o = tr.attention(q, k, v)
    o.backward(ct)
    assert tr.attention_routes["plain"] == 2
    assert cs.attention_gap(o.detach(), want[0]) < 2e-6
    for got, w in zip((q.grad, k.grad, v.grad), want[2:]):
        assert got.shape == (B, H, L, 64)
        # over a single key, dq and dk are zero: their f32 values are
        # rounding of terms of ~1
        assert cs.attention_gap(got, w) < (1e-6 if L == 1 and w is not
                                           want[4] else 1e-5)


@pytest.mark.parametrize("B,H,L", cs.ATTENTION_NARROW,
                         ids=[f"L{c[2]}" for c in cs.ATTENTION_NARROW])
def test_plain_against_f64_at_heads_of_32(B, H, L):
    """The plain version at the kernel's other head width: O within 2e-6
    and each gradient within 1e-5 of its largest f64 value."""
    q, k, v, ct = cs.attention_operands(torch, B, H, L, seed=L, device="cpu",
                                        d=cs.ATTENTION_NARROW_HEAD)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    want = cs.attention_reference(torch, q.detach(), k.detach(), v.detach(),
                                  ct)
    o = tr.attention(q, k, v)
    o.backward(ct)
    assert o.shape == (B, H, L, 32)
    assert cs.attention_gap(o.detach(), want[0]) < 2e-6
    for got, w in zip((q.grad, k.grad, v.grad), want[2:]):
        assert got.shape == (B, H, L, 32)
        assert cs.attention_gap(got, w) < 1e-5


def test_vit_counts_forward_and_backward():
    """A small ViT: one attention a block, each counted once forward and
    once backward on its route, and its linears beside them."""
    g = torch.Generator().manual_seed(0)
    net = vit.DinoVisionTransformer(img_size=28, dim=64, depth=3, heads=2)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    x = torch.randn((2, 3, 28, 28), generator=g)
    tr.reset_counts()
    feats = net.get_intermediate_layers(x, (0, 1, 2))
    assert tr.launch_counts()[1] == 3
    assert tr.attention_routes == {"kernel": 0, "library": 0, "plain": 3}
    sum(f[0].sum() for f in feats).backward()
    assert tr.attention_routes == {"kernel": 0, "library": 0, "plain": 6}
    assert tr.launch_counts() == (12, 3)


# -- the kernel's operands and index maps --------------------------------------

def test_qkv_views_taken_without_copy():
    """q, k and v as ``models/vit.py`` makes them (views of (B, L, 3, H,
    64), rows of 3 x H x 64) and the cotangent as the reshape gives it back
    are read as they lie; strides of a length-one dimension are replaced by
    a size TMA takes."""
    q, k, v, ct = cs.attention_operands(torch, 2, 16, 37, 0, device="cpu")
    for t in (q, k, v, ct):
        got, strides = tr._attention_view(t)
        assert got is t
        assert strides == (t.stride(0), t.stride(1), t.stride(2))
    q1 = cs.attention_operands(torch, 1, 2, 9, 0, device="cpu")[0]
    got, strides = tr._attention_view(q1)
    assert got is q1 and strides[0] % 4 == 0 and strides[0] > 0
    assert strides[1:] == (q1.stride(1), q1.stride(2))


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((1, 2, 5, 128))[..., ::2],     # head width strided
    lambda: torch.zeros((1, 2, 5, 66))[..., :64],      # rows of 66 elements
    lambda: torch.zeros(1 * 2 * 5 * 64 + 1)[1:].view(1, 2, 5, 64)],  # base
    ids=["strided", "rows", "misaligned"])
def test_unreadable_operand_copied(make):
    t = make()
    got, strides = tr._attention_view(t)
    assert got is not t and got.is_contiguous()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
    assert strides == (got.stride(0), got.stride(1), got.stride(2))


def _key_of_position():
    """The forward's transposed planes' key at each of 64 positions of a
    tile, as ``split_kernel`` writes them with ``permute``: position 8G + i
    holds key 8G + (0 2 4 6 1 3 5 7)[i]."""
    text = SOURCE.read_text()
    assert ("permute ? (kp & ~7) | (q < 4 ? 2 * q : 2 * (q - 4) + 1) : kp;"
            in text)
    kp = np.arange(64)
    q = kp & 7
    return (kp & ~7) | np.where(q < 4, 2 * q, 2 * (q - 4) + 1)


def test_accumulator_as_fragment_meets_the_planes_key_order():
    """P (64 rows x 64 keys) in the accumulator's layout, handed to wgmma as
    ``FromAcc`` hands it (fragment e of k8 step kk: accumulator elements 4kk,
    4kk+2, 4kk+1, 4kk+3), against V^T's planes in the split's key order,
    gives P V exactly (integers, so that no rounding hides a wrong key)."""
    text = SOURCE.read_text()
    for e, acc in enumerate((0, 2, 1, 3)):
        assert (f"split(__float_as_uint(v[4 * kk + {acc}]), big[{e}], "
                f"small[{e}]);" if acc else
                f"split(__float_as_uint(v[4 * kk]), big[{e}], small[{e}]);"
                ) in text
    g = np.random.default_rng(0)
    P = g.integers(-4, 5, (64, 64)).astype(np.float64)
    V = g.integers(-4, 5, (64, 64)).astype(np.float64)
    planes = V[_key_of_position()].T           # (head width, position)
    got = np.zeros((64, 64))
    for warp in range(4):
        for lane in range(32):
            gr, t = lane >> 2, lane & 3
            # the accumulator: acc[4j + 2h + e] = P[16 warp + g + 8h, 8j +
            # 2t + e]
            acc = np.array([P[16 * warp + gr + 8 * ((i >> 1) & 1),
                              8 * (i >> 2) + 2 * t + (i & 1)]
                            for i in range(32)])
            for kk in range(8):
                frag = acc[[4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3]]
                # the TF32 A fragment: e = (row g + 8 (e & 1), k t + 4 (e >>
                # 1)); the product's rows 16 warp + g (+ 8)
                for e in range(4):
                    row = 16 * warp + gr + 8 * (e & 1)
                    pos = 8 * kk + t + 4 * (e >> 1)
                    got[row] += frag[e] * planes[:, pos]
    assert np.array_equal(got, P @ V)


def _mn_row(warp, g, h):
    return (warp >> 1) * 32 + 4 * (2 * (warp & 1) + h + 4 * (g >> 2)) + (g & 3)


def test_mn_major_rows_cover_the_head_width_without_bank_conflicts():
    """``mn_row``: the 64 head-width rows once each over (warp, g, h), and
    each fragment load's 32 lanes on 32 banks under the 128-byte swizzle."""
    assert "return (warp >> 1) * 32 + 4 * (2 * (warp & 1) + h + 4 * (g >> 2)) + (g & 3);" in SOURCE.read_text()
    rows = sorted(_mn_row(w, g, h) for w in range(4) for g in range(8)
                  for h in range(2))
    assert rows == list(range(64))
    for warp in range(4):
        for e in range(4):
            banks = set()
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                m, k = _mn_row(warp, g, e & 1), t + 4 * (e >> 1)
                addr = ((m >> 5) * 8192 + k * 128
                        + ((((m & 31) >> 2) ^ k) << 4) + (m & 3) * 4)
                banks.add((addr // 4) % 32)
            assert len(banks) == 32


def test_transposed_store_without_bank_conflicts():
    """``store_transposed``: every (query, key) of a 64 x 64 accumulator at
    its own address of the B operand, and each store's 32 lanes on 32
    banks."""
    seen = set()
    for warp in range(4):
        for j in range(8):
            for h in range(2):
                for e in range(2):
                    banks = set()
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        q, key = warp * 16 + g + 8 * h, 8 * j + 2 * t + e
                        addr = ((q >> 5) * 8192 + key * 128
                                + ((((q & 31) >> 2) ^ (key & 7)) << 4)
                                + (q & 3) * 4)
                        banks.add((addr // 4) % 32)
                        seen.add(addr)
                    assert len(banks) == 32
    assert len(seen) == 64 * 64


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


@pytest.mark.parametrize("name", sorted(_cuda.ATTENTION_ENTRIES))
def test_entries_match_argtypes(name):
    assert _c_entry_argtypes(name) == _cuda.ATTENTION_ENTRIES[name]


# -- on the card ---------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("B,H,L", [cs.ATTENTION_SHAPE] + RAGGED,
                         ids=["dav2"] + [f"L{c[2]}" for c in RAGGED])
def test_kernel_against_f64_on_the_card(card, monkeypatch, B, H, L):
    """O, lse, dq, dk and dv against f64, each within twice the library's
    error or, below one key tile, below TOL_ATTENTION_FLOOR (8 f32 ulps) of
    the largest value (where the f64 result is zero, dq and dk over one
    key, below TOL_ATTENTION_ZERO); two calls bitwise equal but dq, within
    TOL_ATTENTION_REPEAT_DQ."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    r = cs.check_attention(torch, tr, B, H, L, seed=L, timed=False)
    assert r["within_error"], (r["max_rel_err"], r["library_max_rel_err"])
    assert r["repeatable"], (r["bitwise_equal"], r["repeat_dq_gap"])


@pytest.mark.card
@pytest.mark.parametrize("B,H,L", cs.ATTENTION_NARROW,
                         ids=[f"L{c[2]}" for c in cs.ATTENTION_NARROW])
def test_kernel_at_heads_of_32_against_f64_on_the_card(card, monkeypatch, B,
                                                       H, L):
    """The kernel's instance for heads of 32 (the benchmark's small dav2
    network's shape, and a ragged length over three key tiles) under the
    same limits as at 64."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    r = cs.check_attention(torch, tr, B, H, L, seed=L, timed=False,
                           d=cs.ATTENTION_NARROW_HEAD)
    assert r["shape"] == [B, H, L, 32]
    assert r["within_error"], (r["max_rel_err"], r["library_max_rel_err"])
    assert r["repeatable"], (r["bitwise_equal"], r["repeat_dq_gap"])


@pytest.mark.card
def test_qkv_views_read_as_they_lie_on_the_card(card):
    """The qkv views go to the kernel as they are, and give what contiguous
    copies of them give (bitwise, but dq's atomic sums)."""
    q, k, v, ct = cs.attention_operands(torch, 2, 16, 300, seed=3)
    for t in (q, k, v, ct):
        assert tr._attention_view(t)[0] is t
    views = cs.attention_kernel(tr, q, k, v, ct)
    copies = cs.attention_kernel(tr, *(t.contiguous() for t in (q, k, v, ct)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dk", "dv"), views[:2] + views[3:],
                          copies[:2] + copies[3:]):
        assert torch.equal(a, b), name
    assert cs.attention_gap(views[2], copies[2].double()) <= \
        cs.TOL_ATTENTION_REPEAT_DQ


@pytest.mark.card
def test_full_step_routes_on_the_card(card):
    """dav2-large at full size, a forward and backward of 2 frames at 518 x
    882: the f32 network's 24 attentions run forward and backward on the
    kernel (48), the bf16 network's on the library."""
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
    for dtype, routes in ((torch.float32, {"kernel": 48, "library": 0}),
                          (torch.bfloat16, {"kernel": 0, "library": 48})):
        net.zero_grad(set_to_none=True)
        tr.reset_counts()
        disp = net(x.to(dtype))
        disp.float().mean().backward()
        torch.cuda.synchronize()
        assert tr.launch_counts() == (98, 24)
        assert {k: tr.attention_routes[k] for k in routes} == routes
        assert tr.attention_routes["plain"] == 0
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        assert all(bool(torch.isfinite(t).all()) for t in grads)
