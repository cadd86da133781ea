"""Port's correlation (the plain path on the CPU) against the JAX package's
jnp formulation, its Pallas kernel (interpret mode) and a naive loop.

Inputs come from a numpy seed and reach both packages as the same values.
Tolerance: f32, rtol 1e-5 and atol 1e-6 (the band of
tests/test_correlation.py); the sides differ only in the order of the
channel sum. The CUDA kernel itself runs only on the card, where
chip_smoke.py holds it against ``correlation_reference``; here the route
plan and a numpy emulation of the banded kernel's index map are tested.
"""

import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistent_depth_tpu.flow.correlation import (correlation as jax_corr,
                                                   correlation_pallas)
from consistent_depth_tpu_torch.flow import correlation as corr
from consistent_depth_tpu_torch.ops import _cuda
from test_correlation import _naive
from test_torch_s2d_conv import _c_entry_argtypes

TOL = dict(rtol=1e-5, atol=1e-6)


def _features(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("max_disp", [4, 8, 20])
def test_matches_jax(max_disp):
    f1, f2 = _features((2, 9, 13, 16), seed=max_disp)
    got = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                           max_displacement=max_disp, stride=2).numpy()
    want = np.asarray(jax_corr(jnp.asarray(f1), jnp.asarray(f2),
                               max_displacement=max_disp, stride=2))
    r = max_disp // 2
    assert got.shape == (2, 9, 13, (2 * r + 1) ** 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("max_disp,block_h", [(4, 4), (8, 8)])
def test_matches_pallas_interpret(max_disp, block_h):
    f1, f2 = _features((2, 16, 12, 8), seed=1)
    got = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                           max_displacement=max_disp, stride=2).numpy()
    want = np.asarray(correlation_pallas(
        jnp.asarray(f1), jnp.asarray(f2), max_displacement=max_disp,
        stride=2, block_h=block_h, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("max_disp,stride", [(4, 2), (5, 2), (3, 1)])
def test_matches_naive(max_disp, stride):
    """Includes a max displacement that is not a multiple of the stride
    (r = 2, reach 4 of a padding of 5) and stride 1."""
    f1, f2 = _features((1, 8, 10, 4), seed=0)
    got = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                           max_displacement=max_disp, stride=stride).numpy()
    np.testing.assert_allclose(got, _naive(f1, f2, max_disp, stride), **TOL)


def test_strided_views():
    """channels_last activations pass in as NHWC views of NCHW tensors and
    give what contiguous NHWC tensors give."""
    f1, f2 = _features((2, 6, 7, 5), seed=3)
    views = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for f in (f1, f2)]
    plain = corr.correlation(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    torch.testing.assert_close(corr.correlation(*views, 4), plain,
                               rtol=0, atol=0)
    transposed = [torch.from_numpy(f.transpose(0, 2, 1, 3).copy()).transpose(
        1, 2) for f in (f1, f2)]
    torch.testing.assert_close(corr.correlation(*transposed, 4), plain,
                               rtol=0, atol=0)


def test_cpu_takes_reference():
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    f1, f2 = (torch.from_numpy(f) for f in _features((1, 5, 6, 3), seed=2))
    before = corr.launch_count(), dict(corr.route_counts)
    torch.testing.assert_close(corr.correlation(f1, f2, 4, 2),
                               corr.correlation_reference(f1, f2, 4, 2),
                               rtol=0, atol=0)
    assert (corr.launch_count(), corr.route_counts) == before


def test_counts_reset():
    corr.route_counts["banded"] += 2
    corr.route_counts["layout_copies"] += 1
    assert corr.launch_count() >= 2
    corr.reset_counts()
    assert corr.launch_count() == 0
    assert set(corr.route_counts.values()) == {0}


def test_rejects_bad_arguments():
    f1, f2 = (torch.from_numpy(f) for f in _features((1, 5, 6, 3), seed=2))
    with pytest.raises(ValueError):
        corr.correlation(f1, f2[:, :4])
    with pytest.raises(ValueError):
        corr.correlation(f1, f2, max_displacement=4, stride=0)
    with pytest.raises(ValueError):
        corr.correlation(f1.to("meta"), f2.to("meta"))


# -- the banded kernel's route plan and index map ----------------------------

def _nhwc_view(shape, layout="channels_last"):
    """An NHWC view of (B, H, W, C) as FlowNetC passes its activations (an
    NCHW tensor channels_last in memory), or laid out as the kernel does
    not read it: ``"nchw"``, a view whose channel stride is not 1;
    ``"offset"``, a contiguous tensor whose base is 4 bytes past a 16-byte
    boundary."""
    B, H, W, C = shape
    if layout == "offset":
        return torch.zeros(B * H * W * C + 1)[1:].view(shape)
    t = torch.zeros((B, C, H, W))
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape,max_disp,stride,layout,want", [
    ((1, 56, 128, 256), 20, 2, "channels_last", "banded"),  # FlowNet2's
    ((2, 72, 128, 256), 20, 2, "channels_last", "banded"),
    ((1, 56, 128, 256), 4, 2, "channels_last", "banded"),   # r = 2
    ((1, 28, 64, 64), 4, 1, "channels_last", "raises"),     # stride 1
    ((1, 28, 64, 64), 6, 2, "channels_last", "raises"),     # r = 3
    ((1, 8, 16, 6), 20, 2, "channels_last", "raises"),      # C = 6
    ((1, 8, 16, 64), 20, 2, "nchw", "copy"),                # channel stride
    ((1, 8, 16, 64), 20, 2, "offset", "copy"),              # unaligned base
])
def test_plan_routes(shape, max_disp, stride, layout, want):
    """The kernel takes stride 2, r in BANDED_RADII and C % 4 == 0, and
    raises on anything else; it reads channels_last views as they lie and
    takes a copy of an input laid out otherwise."""
    r = max_disp // stride
    if want == "raises":
        with pytest.raises(ValueError, match="the kernel takes"):
            corr._plan(shape, r, stride)
        return
    assert corr._plan(shape, r, stride).smem == corr.banded_smem(r)
    assert corr._aligned(_nhwc_view(shape, layout)) == (want == "banded")


@pytest.mark.parametrize("W", [13, 128, 130])
@pytest.mark.parametrize("D", [5, 21])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_plan_grid_covers_each_row_once(B, D, W):
    """Blocks (x-tile, y, b * dy-group) with G = BANDED_GROUP warps, warp w
    taking dyi = group * G + w as the kernel does, cover every (x-tile, y,
    b, dy) exactly once, the batch folded into the grid's z; warps past D
    do nothing."""
    G, H, r = corr.BANDED_GROUP, 3, (D - 1) // 2
    gx, gy, gz = corr._plan((B, H, W, 16), r, 2).grid
    ngroups = math.ceil(D / G)
    assert gz == B * ngroups and gy == H
    seen = [(bx, y, bz // ngroups, (bz % ngroups) * G + w)
            for bx in range(gx) for y in range(gy) for bz in range(gz)
            for w in range(G)]
    seen = [s for s in seen if s[3] < D]
    want = [(bx, y, b, d) for bx in range(math.ceil(W / 128))
            for y in range(H) for b in range(B) for d in range(D)]
    assert sorted(seen) == want


@pytest.mark.parametrize("r", corr.BANDED_RADII)
def test_banded_shared_bytes_fit(r):
    """Every banded instantiation fits the 227 KB a block may have; at
    r = 10 the size of the kernel's note."""
    size = corr.banded_smem(r)
    assert size <= 227 * 1024
    if r == 10:
        assert size == 166912


def _emulate_banded(f1, f2, r):
    """numpy emulation of csrc/correlation.cu's banded kernel: the grid of
    ``_plan``, the cp.async copy maps with zero-fill into the s1/s2 layouts
    (sigma, tau) of its note, chunks of 16 channels, the lanes' column and
    slot formulas, and the epilogue; sums in float64. Checks that the copies
    fill each shared unit once and the epilogue writes each output once.

    It tests the design's formulas as written here, not the compiled
    kernel: only chip_smoke.py runs that. The tile, chunk and plane sizes
    come from flow/correlation.py, and
    test_banded_source_matches_emulation holds them, the instantiations and
    the index expressions mirrored here against the .cu's text."""
    B, H, W, C = f1.shape
    D, TW, CK = 2 * r + 1, corr.BANDED_TILE_W, corr.BANDED_CHUNK
    G = corr.BANDED_GROUP
    NQ = CK // 4
    NQCOL = TW // 2 + 2 * r
    QQ = (NQCOL + 3) // 4
    PLANE = 4 * QQ
    assert corr.banded_smem(r) == 2 * CK * 4 * (TW + G * 2 * PLANE)
    gx, gy, gz = corr._plan(f1.shape, r, 2).grid
    ngroups = gz // B
    # s1: idx -> quad u and m = (gh, k, p, gl), g = 8 gh + gl
    idx = np.arange(NQ * TW)
    u1, m = idx & 3, idx >> 2
    p1, k1 = (m >> 3) & 1, (m >> 4) & 3
    g1 = ((m >> 6) << 3) | (m & 7)
    col1 = p1 + 2 * (4 * g1 + k1)
    dst1 = (u1 * 2 + p1) * 64 + k1 * 16 + g1
    assert sorted(dst1) == list(range(NQ * 2 * 64))
    # s2: idx -> quad u and m = p * PLANE + tau, q = 4 (tau % QQ) + tau / QQ
    idx = np.arange(NQ * 2 * PLANE)
    u2, m = idx & 3, idx >> 2
    p2 = m // PLANE
    tau = m - p2 * PLANE
    q = 4 * (tau % QQ) + tau // QQ
    col2 = -2 * r + p2 + 2 * q
    dst2 = (u2 * 2 + p2) * PLANE + tau
    assert sorted(dst2) == list(range(NQ * 2 * PLANE))
    # the lanes and their loads
    lane = np.arange(32)
    p, g = lane >> 4, lane & 15
    ks = np.arange(4)
    a_idx = p[:, None] * 64 + g[:, None] + 16 * ks[None]          # (32, 4)
    t = np.arange(D + 3)
    b_idx = (p[:, None] * PLANE + g[:, None]
             + ((t & 3) * QQ + (t >> 2))[None])                    # (32, D+3)
    kj = ks[:, None] + np.arange(D)[None]                          # t = k + j
    quad = np.arange(4)

    def stage(f, b, y, x, c, ok, n):
        s = np.zeros((n, 4))
        s[ok] = f[b, y, x[ok][:, None], c[ok][:, None] + quad[None]]
        return s

    out = np.zeros((B, H, W, D * D))
    writes = np.zeros((B, H, W, D * D), dtype=int)
    for bx in range(gx):
        x0 = bx * TW
        for y in range(gy):
            for bz in range(gz):
                b = bz // ngroups
                dyis = [(bz % ngroups) * G + w for w in range(G)]
                acc = np.zeros((G, 32, 4, D))
                for c0 in range(0, C, CK):
                    x, c = x0 + col1, c0 + 4 * u1
                    s1 = stage(f1, b, y, x, c, (x < W) & (c < C), len(dst1))
                    s1 = s1[np.argsort(dst1)]
                    for w, dyi in enumerate(dyis):
                        y2 = y + 2 * (dyi - r)
                        if dyi >= D or not 0 <= y2 < H:
                            continue
                        x, c = x0 + col2, c0 + 4 * u2
                        ok = (q < NQCOL) & (x >= 0) & (x < W) & (c < C)
                        s2 = stage(f2, b, y2, x, c, ok, len(dst2))
                        s2 = s2[np.argsort(dst2)]
                        for u in range(NQ):
                            a = s1[u * 128 + a_idx]                # (32, 4, 4)
                            v = s2[u * 2 * PLANE + b_idx]          # (32, D+3, 4)
                            acc[w] += np.einsum("lkc,lkjc->lkj", a, v[:, kj])
                for w, dyi in enumerate(dyis):
                    if dyi >= D:
                        continue
                    for k in range(4):
                        x = x0 + p + 2 * (4 * g + k)
                        ok = x < W
                        out[b, y, x[ok], dyi * D:(dyi + 1) * D] = (
                            acc[w, ok, k] / C)
                        writes[b, y, x[ok], dyi * D:(dyi + 1) * D] += 1
    assert (writes == 1).all()
    return out


# the banded kernel's index expressions that _emulate_banded mirrors, as the
# .cu spells them (whitespace aside)
_BANDED_EXPRESSIONS = (
    "const int dyi = (blockIdx.z % ngroups) * G + warp;",
    "const int y2 = y + STEP * (dyi - R);",
    "const int pp = (m >> 3) & 1;",
    "const int k = (m >> 4) & 3;",
    "const int gg = ((m >> 6) << 3) | (m & 7);",
    "const int x = x0 + pp + 2 * (4 * gg + k);",
    "(u * 2 + pp) * 64 + k * 16 + gg",
    "const int q = 4 * (tau % P::QQ) + tau / P::QQ;",
    "const int x = x0 - STEP * R + pp + 2 * q;",
    "q < P::NQCOL && x >= 0 && x < W && c < C",
    "(u * 2 + pp) * P::S2_PLANE + tau",
    "s1 + (ch & 1) * P::S1_UNITS + p * 64 + g;",
    "s2 + (ch & 1) * P::S2_UNITS + p * P::S2_PLANE + g;",
    "a[k] = a_base[u * 2 * 64 + 16 * k];",
    "bu[(t & 3) * P::QQ + (t >> 2)]",
    "const int j = t - k;",
    "const int x = x0 + p + 2 * (4 * g + k);",
    "o[j] = acc[k][j] / rc;",
)


def test_banded_source_matches_emulation():
    """csrc/correlation.cu has the sizes flow/correlation.py plans with,
    one instantiation of each of BANDED_RADII at BANDED_GROUP, every index
    expression the emulation above mirrors, and the parameters of
    ops/_cuda.py's argtypes; a change to one of them fails here."""
    src = (_cuda.CSRC_DIR / "correlation.cu").read_text()
    flat = " ".join(src.split())

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TW") == corr.BANDED_TILE_W
    assert const("CK") == corr.BANDED_CHUNK
    assert const("STEP") == corr.BANDED_STRIDE
    assert f"NQCOL = {corr.BANDED_TILE_W // 2} + 2 * R;" in flat
    assert "QQ = (NQCOL + 3) / 4;" in flat
    assert "S2_PLANE = 4 * QQ;" in flat
    inst = {tuple(map(int, m)) for m in re.findall(
        r"CDTT_BANDED\((\d+), (\d+)\)", src)}
    assert inst == {(r, corr.BANDED_GROUP) for r in corr.BANDED_RADII}
    missing = [e for e in _BANDED_EXPRESSIONS if e not in flat]
    assert not missing
    assert _c_entry_argtypes("correlation.cu",
                             "correlation_banded_forward") == (
        _cuda.CORRELATION_BANDED_ARGTYPES)


@pytest.mark.parametrize("shape,max_disp,stride", [
    ((1, 56, 128, 4), 20, 2),     # FlowNet2's rows and columns
    ((2, 7, 13, 8), 20, 2),       # displacements past the image
    ((1, 9, 20, 4), 4, 1),
])
def test_chip_smoke_bound_counts_in_image_products(shape, max_disp, stride):
    """chip_smoke.py's correlation bound counts 2 C FLOPs for exactly the
    outputs whose f2 pixel lies in the image: those where the plain
    version on all-ones inputs is not zero."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    B, H, W, C = shape
    ones = torch.ones(shape)
    inside = int(torch.count_nonzero(
        corr.correlation_reference(ones, ones, max_disp, stride)))
    gflop, bound_ms, bound_by = cs.correlation_bound(
        B, H, W, C, max_disp // stride, stride)
    assert math.isclose(gflop * 1e9, 2 * C * inside, rel_tol=1e-12)
    assert bound_by in ("operations", "bytes") and bound_ms > 0


@pytest.mark.parametrize("shape,r", [
    ((1, 7, 13, 32), 10),         # rows whose f2 row is out of the image
    ((1, 6, 130, 16), 2),         # ragged W over two tiles, warps past D
    ((2, 5, 20, 48), 10),         # B = 2, three chunks
    ((2, 5, 130, 20), 10),        # a chunk tail of one quad
    ((1, 9, 21, 20), 2),
])
def test_banded_index_map_emulation(shape, r):
    f1, f2 = _features(shape, seed=shape[2] + r)
    got = _emulate_banded(f1, f2, r)
    ref = corr.correlation_reference(torch.from_numpy(f1),
                                     torch.from_numpy(f2), 2 * r, 2).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    want = np.asarray(jax_corr(jnp.asarray(f1), jnp.asarray(f2),
                               max_displacement=2 * r, stride=2))
    np.testing.assert_allclose(got, want, **TOL)
