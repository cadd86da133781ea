"""Port's same_conv (plain path on the CPU) against the JAX package's Pallas
s2d conv (interpret mode) and its XLA conv, and SameConv2d's routing.

The cases are the hourglass's conv classes (stem, inception branches,
merged heads) at a small spatial size. Inputs come from a numpy seed and
reach both packages as the same values. Tolerance: f32, rtol = atol = 2e-5
(the band of tests/test_s2d_pallas.py); the two sides differ only in
summation order.
"""

import ctypes
import math
import re
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu.ops.s2d_conv import s2d_conv_pallas
from consistent_depth_tpu_torch.models import hourglass, layers
from consistent_depth_tpu_torch.models.registry import get_depth_model
from consistent_depth_tpu_torch.ops import _cuda, s2d_conv

TOL = dict(rtol=2e-5, atol=2e-5)

# (k, Ci, Co): stem, _A branches, merged heads, and branches of _B, _BA,
# _BB, _BC, _D/_E, _F
CLASSES = [
    (7, 3, 128),
    (3, 64, 16), (7, 64, 16), (11, 64, 16),
    (3, 64, 2),
    (5, 32, 32), (11, 32, 16), (5, 64, 32), (11, 64, 32),
    (7, 32, 64), (11, 64, 64),
]


def _inputs(k, ci, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 12, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(
        np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("k,ci,co", CLASSES)
def test_same_conv_matches_jax(k, ci, co, bias):
    x, w, b = _inputs(k, ci, co)
    got = s2d_conv.same_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b) if bias else None).numpy()
    pallas = np.asarray(s2d_conv_pallas(
        jnp.asarray(x), jnp.asarray(w), s=2, block_h=2))
    xla = np.asarray(jax_layers._conv_raw(
        jnp.asarray(w), jnp.asarray(x), 0, 1, (k - 1) // 2, 1))
    if bias:
        pallas, xla = pallas + b, xla + b
    assert got.shape == (2, 8, 12, co)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)


def test_same_conv_cpu_takes_reference():
    """On a CPU tensor the wrapper is the plain version and launches
    nothing."""
    x, w, b = _inputs(3, 4, 5)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    before = s2d_conv.launch_counts()
    torch.testing.assert_close(s2d_conv.same_conv(*args),
                               s2d_conv.same_conv_reference(*args),
                               rtol=0, atol=0)
    assert s2d_conv.launch_counts() == before


def test_same_conv2d_routing():
    """Exactly the odd k >= 3 convs route to same_conv: 69 modules (stem,
    66 inception branches, two heads) of which one forward makes 68 calls
    (the heads run as one merged conv); the 1x1 convs stay on F.conv2d."""
    net = hourglass.HourglassModel()
    convs = [m for m in net.modules() if isinstance(m, layers.SameConv2d)]
    routed = [m for m in convs if m.routed]
    assert len(routed) == 69
    assert all(m.kernel_size[0] >= 3 and m.kernel_size[0] % 2 == 1
               for m in routed)
    assert all(m.kernel_size == (1, 1) for m in convs if not m.routed)
    assert len(convs) - len(routed) == 22 * 4  # four 1x1s per inception

    calls = []
    orig = s2d_conv.same_conv

    def recording(x, w, bias=None):
        calls.append(tuple(w.shape))
        return orig(x, w, bias)

    s2d_conv.same_conv = recording
    try:
        with torch.no_grad():
            net.eval()(torch.rand(1, 3, 16, 16))
    finally:
        s2d_conv.same_conv = orig
    assert len(calls) == 68
    assert calls[0] == (7, 7, 3, 128) and calls[-1] == (3, 3, 64, 2)
    assert all(shape[0] > 1 for shape in calls)


def test_same_conv2d_layouts():
    """SameConv2d on a channels_last NCHW tensor equals nn.Conv2d, for a
    routed k x k conv and a 1x1 conv."""
    g = torch.Generator().manual_seed(0)
    for k in (1, 5):
        conv = layers.SameConv2d(6, 4, k, padding=(k - 1) // 2)
        layers.init_parameters(conv, g)
        with torch.no_grad():
            conv.bias.uniform_(-1, 1, generator=g)
        plain = torch.nn.Conv2d(6, 4, k, padding=(k - 1) // 2)
        plain.load_state_dict(conv.state_dict())
        x = torch.rand(2, 6, 9, 7, generator=g).to(
            memory_format=torch.channels_last)
        with torch.no_grad():
            torch.testing.assert_close(conv(x), plain(x), rtol=2e-5,
                                       atol=2e-5)


def _hourglass_calls(batch=8, size=(224, 384)):
    """The (x shape, w shape) of every same_conv call of one forward of the
    hourglass, traced on the meta device (shapes only)."""
    with torch.device("meta"):
        net = hourglass.HourglassModel().eval()
    calls = []
    orig = s2d_conv.same_conv

    def recording(x, w, bias=None):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return x.new_empty((*x.shape[:3], w.shape[3]))

    s2d_conv.same_conv = recording
    try:
        with torch.no_grad():
            net(torch.empty((batch, 3, *size), device="meta").to(
                memory_format=torch.channels_last))
    finally:
        s2d_conv.same_conv = orig
    return calls


def _split_ranges(steps, split):
    """The reduction steps of each split, as the kernel cuts them."""
    return [range(s * steps // split, (s + 1) * steps // split)
            for s in range(split)]


# each dtype's tensor-core route and reduction channels per step (32 bytes)
# for the reductions that "wgmma" does not take
TC_ROUTES = {torch.bfloat16: ("tc", 16), torch.float32: ("tf32", 8)}


def _check_plan(plan, dtype, N, H, W, Ci, Co, k, grad):
    """A plan's tiles cover the output, its output-channel blocks the
    output channels, and a split's ranges every reduction step once, with
    at least MIN_BLOCKS blocks; "wgmma" and "wgmma_tf32" tiles fit their
    shared memory and take 16 rows only for blocks of up to 64 and 32
    channels."""
    route, th, split = plan
    assert th in s2d_conv.TILE_HEIGHTS
    red, out = (Co, Ci) if grad else (Ci, Co)
    rows, cols = math.ceil(H / th), math.ceil(W / s2d_conv.TILE_W)
    assert (rows - 1) * th < H <= rows * th
    assert (cols - 1) * s2d_conv.TILE_W < W <= cols * s2d_conv.TILE_W
    if route == "wgmma":
        cob = s2d_conv.wgmma_co_block(out)
        chunk = s2d_conv.wgmma_chunk(red, k, split)
        assert cob in s2d_conv.WGMMA_CO_BLOCKS
        assert th < 16 or cob <= s2d_conv.WGMMA_TALL_MAX_CO_BLOCK
        assert s2d_conv.wgmma_fits(k, th, red, cob)
        assert chunk * 2 in (32, 64, 128)   # the swizzle widths TMA has
    elif route == "wgmma_tf32":
        cob = s2d_conv.wgmma_co_block(out, dtype)
        chunk = s2d_conv.wgmma_chunk(red, k, split, dtype, th)
        assert cob in s2d_conv.WGMMA_TF32_CO_BLOCKS
        assert th < 16 or cob <= s2d_conv.WGMMA_TF32_TALL_MAX_CO_BLOCK
        assert s2d_conv.wgmma_fits(k, th, red, cob, dtype)
        assert chunk * 4 in (64, 128)
    else:
        cob = s2d_conv.co_block(out, dtype)
        assert cob <= s2d_conv.MAX_CO_BLOCK[dtype]
        chunk = s2d_conv.CHUNK[dtype]
    co_blocks = math.ceil(out / cob)
    assert (co_blocks - 1) * cob < out <= co_blocks * cob
    steps = math.ceil(red / chunk) * k
    assert 1 <= split <= steps
    ranges = _split_ranges(steps, split)
    assert [s for r in ranges for s in r] == list(range(steps))
    assert all(len(r) for r in ranges)
    assert rows * cols * N * co_blocks * split >= s2d_conv.MIN_BLOCKS
    if split > 1:
        assert th == min(s2d_conv.TILE_HEIGHTS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("direction", ["forward", "grad_input"])
def test_plan_routes_hourglass_classes(direction, dtype):
    """For every conv class of one batch-8 forward at 224x384 (68 calls)
    and of its backward (67 grad-inputs: the stem's input needs none), bf16
    takes "wgmma" but where its reduction is loaded by element (the stem's
    3 input channels, the merged heads' 2-channel cotangent) or it has 16
    output or reduction channels (WGMMA_THIN: "tc" ran faster there on the
    card): "tc", with steps of 16 channels; f32 takes "wgmma_tf32" but
    where its reduction is loaded by element or it has 16 or fewer output
    channels (WGMMA_TF32_THIN): "tf32", with steps of 8 channels. A plan's
    tiles cover the output, and a split's ranges cover every reduction
    step once, with at least MIN_BLOCKS blocks."""
    calls = _hourglass_calls()
    assert len(calls) == 68
    grad = direction == "grad_input"
    if grad:
        calls = calls[1:]
    tc_route, chunk = TC_ROUTES[dtype]
    assert s2d_conv.CHUNK[dtype] == chunk
    routes = []
    for (N, H, W, Ci), (k, _, _, Co) in calls:
        plan = s2d_conv._plan(dtype, N, H, W, Ci, Co, k, grad_input=grad)
        red, out = (Co, Ci) if grad else (Ci, Co)
        narrow = red % (16 // dtype.itemsize) != 0
        if dtype == torch.bfloat16:
            thin = min(red, out) <= s2d_conv.WGMMA_THIN
            want = "wgmma" if not narrow and not thin else tc_route
        else:
            thin = out <= s2d_conv.WGMMA_TF32_THIN
            want = "wgmma_tf32" if not narrow and not thin else tc_route
        assert plan[0] == want
        routes.append(plan[0])
        _check_plan(plan, dtype, N, H, W, Ci, Co, k, grad)
    if dtype == torch.bfloat16:
        # forward: the stem and the seven classes into 16 or 2 channels;
        # grad-input: the heads' and the six of a 16-channel cotangent
        assert routes.count("tc") == (8 if not grad else 7)
        assert routes.count("wgmma") == 60
    else:
        # forward: the stem and the seven classes into 16 or 2 channels;
        # grad-input: the heads' 2-channel cotangent
        assert routes.count("tf32") == (8 if not grad else 1)
        assert routes.count("wgmma_tf32") == (60 if not grad else 66)


def test_plan_narrow_and_ragged_cases():
    """Narrow reductions take the tensor cores in both dtypes; a grad-input
    into a number of channels that is not a whole number of 16-byte units
    (8 bf16, 4 f32) raises, in the plan and so in the launch helper before
    it launches or counts anything; a one-image ragged case splits up to
    its steps."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert s2d_conv._plan(bf16, 8, 224, 384, 3, 128, 7)[0] == "tc"
    assert s2d_conv._plan(bf16, 8, 224, 384, 64, 2, 3,
                          grad_input=True)[0] == "tc"
    with pytest.raises(ValueError, match="no kernel takes"):
        s2d_conv._plan(bf16, 8, 224, 384, 3, 128, 7, grad_input=True)
    # the heads' forward reduces 64 channels into 2: "tc" ran it faster
    # (WGMMA_THIN)
    assert s2d_conv._plan(bf16, 8, 224, 384, 64, 2, 3)[0] == "tc"
    assert s2d_conv._plan(f32, 8, 224, 384, 3, 128, 7)[0] == "tf32"
    assert s2d_conv._plan(f32, 8, 224, 384, 64, 2, 3,
                          grad_input=True)[0] == "tf32"
    with pytest.raises(ValueError, match="no kernel takes"):
        s2d_conv._plan(f32, 8, 224, 384, 3, 128, 7, grad_input=True)
    assert s2d_conv._plan(f32, 8, 224, 384, 64, 2, 3)[0] == "tf32"
    # a grad-input into 4 channels is a whole 16-byte unit in f32 only
    assert s2d_conv._plan(f32, 2, 64, 96, 4, 16, 3,
                          grad_input=True)[0] == "tf32"
    with pytest.raises(ValueError, match="no kernel takes"):
        s2d_conv._plan(bf16, 2, 64, 96, 4, 16, 3, grad_input=True)
    # nor may a route named by measurement take it
    with pytest.raises(ValueError, match="no kernel takes"):
        s2d_conv._plan(f32, 8, 224, 384, 3, 128, 7, grad_input=True,
                       route="tf32")
    w = torch.from_numpy(_inputs(7, 3, 16)[1])
    ct = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 12, 16)).astype(np.float32))
    before = dict(s2d_conv.route_counts)
    with pytest.raises(ValueError, match="no kernel takes"):
        s2d_conv._launch("grad_input", ct, w)
    assert s2d_conv.route_counts == before
    # 1x7x13, k=11, 64 -> 16: two 4x16 tiles, split up to the steps of
    # the reduction: 44 forward in bf16 (16 channels each) and 11 in the
    # grad-input (the cotangent's 16 channels), 88 in f32 (8 channels
    # each); 16 output channels take "tc" in bf16 (WGMMA_THIN) and "tf32"
    # in f32 (WGMMA_TF32_THIN), and "wgmma", when asked, halves its chunk
    # of 64 for as many steps; f32's grad-input into 64 channels takes
    # "wgmma_tf32", one chunk of 16 a tap row
    assert s2d_conv._plan(bf16, 1, 7, 13, 64, 16, 11) == ("tc", 4, 44)
    assert s2d_conv._plan(bf16, 1, 7, 13, 64, 16, 11, grad_input=True) == (
        "tc", 4, 11)
    assert s2d_conv._plan(bf16, 1, 7, 13, 64, 16, 11, route="wgmma") == (
        "wgmma", 4, 44)
    assert s2d_conv._plan(bf16, 1, 7, 13, 64, 16, 11, grad_input=True,
                          route="wgmma") == ("wgmma", 4, 11)
    assert s2d_conv._plan(f32, 1, 7, 13, 64, 16, 11) == ("tf32", 4, 88)
    assert s2d_conv._plan(f32, 1, 7, 13, 64, 16, 11, grad_input=True) == (
        "wgmma_tf32", 4, 11)
    assert s2d_conv._plan(f32, 1, 7, 13, 64, 16, 11, grad_input=True,
                          route="tf32") == ("tf32", 4, 22)
    assert s2d_conv._plan(f32, 1, 7, 13, 64, 16, 11,
                          route="wgmma_tf32") == ("wgmma_tf32", 4, 44)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_tc_ready_by_dtype(dtype):
    """The tensor-core kernels copy 16-byte units: strides of 8 bf16 or 4
    f32 elements and a 16-byte aligned base, unless the tensor is loaded
    by element; the contiguous dimension always needs stride 1."""
    f32 = dtype == torch.float32
    a = torch.zeros((2, 3, 5, 12), dtype=dtype)   # strides (180, 60, 12, 1)
    assert s2d_conv._tc_ready(a, 3, False) == f32
    assert s2d_conv._tc_ready(a, 3, True)
    flat = torch.zeros(4 + 2 * 3 * 5 * 16, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    aligned = flat[:-4].view(2, 3, 5, 16)
    assert s2d_conv._tc_ready(aligned, 3, False)
    # 4 elements in: 16 bytes in f32, 8 in bf16
    assert s2d_conv._tc_ready(flat[4:].view(2, 3, 5, 16), 3, False) == f32
    assert not s2d_conv._tc_ready(aligned.permute(0, 1, 3, 2), 3, True)


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32 (10 mantissa bits) as the card's
    ``cvt.rna.tf32.f32`` does: to nearest, ties away from zero, on the
    int32 view (adding half of the dropped 13 bits to the magnitude)."""
    bits = a.astype(np.float32).view(np.int32)
    return ((bits + 0x1000) & ~np.int32(0x1FFF)).view(np.float32)


def test_tf32_products_need_three_terms():
    """Why the f32 route splits each product into three TF32 products
    (csrc/same_conv_tf32.cu): on a k=11 64->64 class, with f64 sums, one
    TF32 product per product lands outside the f32 band of the card's
    checks (max |d| / max |ref| <= 1e-4), and small*big + big*small +
    big*big of big = tf32(v), small = tf32(v - big) stays below 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 12, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((11, 11, 64, 64)) / np.sqrt(11 * 11 * 64)
         ).astype(np.float32)

    def conv(a, b):
        return s2d_conv.same_conv_reference(
            torch.from_numpy(a.astype(np.float64)),
            torch.from_numpy(b.astype(np.float64))).numpy()

    ref = conv(x, w)
    xb, wb = _tf32(x), _tf32(w)
    xs, ws = _tf32(x - xb), _tf32(w - wb)
    assert np.all(xs.view(np.int32) & 0x1FFF == 0)
    three = conv(xs, wb) + conv(xb, ws) + conv(xb, wb)
    one = conv(xb, wb)
    scale = np.abs(ref).max()
    assert np.abs(three - ref).max() / scale < 1e-6
    assert np.abs(one - ref).max() / scale > 1e-4


def _model_calls(name, batch=8, size=(224, 384)):
    """The (x shape, w shape) of every same_conv call of one forward of the
    adapter ``name`` at ``size`` (monodepth2 resizes to its 320x1024 feed),
    traced on the meta device (shapes only)."""
    model = object.__new__(get_depth_model(name))
    with torch.device("meta"):
        model.net = model._make_module()
    model.to("meta", torch.bfloat16)
    calls = []
    orig = s2d_conv.same_conv

    def recording(x, w, bias=None):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return x.new_empty((*x.shape[:3], w.shape[3]))

    s2d_conv.same_conv = recording
    try:
        with torch.no_grad():
            model.apply(torch.empty((batch, 1, *size, 3), device="meta"))
    finally:
        s2d_conv.same_conv = orig
    return calls


# routed convs per forward: the hourglass's stem, 66 branches and merged
# heads; midas2's transition, residual-unit and output convs; monodepth2's
# 13 stride-1 3x3 convs of ResNet-18
MODEL_CALLS = {"mc": 68, "midas2": 20, "monodepth2": 13}


@pytest.mark.parametrize("direction", ["forward", "grad_input"])
@pytest.mark.parametrize("name", sorted(MODEL_CALLS))
def test_plan_routes_backbone_classes_bf16(name, direction):
    """Every bf16 conv class of the three backbones at 224x384, batch 8:
    "wgmma" for each but a reduction loaded by element ("tc": mc's stem
    forward, its heads' grad-input), 16 output or reduction channels ("tc":
    mc's classes that it ran faster on the card, WGMMA_THIN); a grad-input
    into 3 channels (mc's stem, which training never needs) raises; a
    "wgmma" tile covers the output in blocks that fit its shared
    memory, a split's ranges cover every reduction step once, and the
    blocks reach MIN_BLOCKS."""
    calls = _model_calls(name)
    assert len(calls) == MODEL_CALLS[name]
    grad = direction == "grad_input"
    routes = []
    for (N, H, W, Ci), (k, _, _, Co) in calls:
        if grad and Ci % 8:
            with pytest.raises(ValueError, match="no kernel takes"):
                s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                               grad_input=grad)
            routes.append("raises")
            continue
        plan = s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                              grad_input=grad)
        routes.append(plan[0])
        if plan[0] == "tc":
            red, out = (Co, Ci) if grad else (Ci, Co)
            assert red % 8 or min(red, out) <= s2d_conv.WGMMA_THIN
        _check_plan(plan, torch.bfloat16, N, H, W, Ci, Co, k, grad)
    if name != "mc":
        assert routes == ["wgmma"] * MODEL_CALLS[name]
    else:
        counts = Counter(routes)
        assert counts == ({"tc": 8, "wgmma": 60} if not grad
                          else {"raises": 1, "tc": 7, "wgmma": 60})


# the f32 routes per forward and per backward of each backbone at 224x384,
# batch 8: mc keeps on "tf32" its stem (3 input channels, loaded by
# element) and the seven classes into 16 or 2 channels (WGMMA_TF32_THIN)
# forward, its heads' 2-channel cotangent backward, and its stem's
# grad-input into 3 channels raises; midas2 and monodepth2 run
# "wgmma_tf32" throughout
F32_ROUTES = {
    ("mc", "forward"): {"tf32": 8, "wgmma_tf32": 60},
    ("mc", "grad_input"): {"raises": 1, "tf32": 1, "wgmma_tf32": 66},
    ("midas2", "forward"): {"wgmma_tf32": 20},
    ("midas2", "grad_input"): {"wgmma_tf32": 20},
    ("monodepth2", "forward"): {"wgmma_tf32": 13},
    ("monodepth2", "grad_input"): {"wgmma_tf32": 13},
}


@pytest.mark.parametrize("direction", ["forward", "grad_input"])
@pytest.mark.parametrize("name", sorted(MODEL_CALLS))
def test_plan_routes_backbone_classes_f32(name, direction):
    """Every f32 conv class of the three backbones at 224x384, batch 8:
    "wgmma_tf32" for each but a reduction loaded by element ("tf32": mc's
    stem forward, its heads' grad-input), 16 or fewer output channels
    ("tf32": mc's classes that it ran faster on the card,
    WGMMA_TF32_THIN); a grad-input into 3 channels (mc's stem) raises;
    a "wgmma_tf32" tile covers the output in blocks that fit its shared
    memory (16 rows only for blocks of up to 32 channels, a chunk of 32
    channels only at k=3 below 16 rows), a split's ranges cover every
    reduction step once, and the blocks reach MIN_BLOCKS."""
    f32 = torch.float32
    calls = _model_calls(name)
    assert len(calls) == MODEL_CALLS[name]
    grad = direction == "grad_input"
    routes = []
    for (N, H, W, Ci), (k, _, _, Co) in calls:
        if grad and Ci % 4:
            with pytest.raises(ValueError, match="no kernel takes"):
                s2d_conv._plan(f32, N, H, W, Ci, Co, k, grad_input=grad)
            routes.append("raises")
            continue
        plan = s2d_conv._plan(f32, N, H, W, Ci, Co, k, grad_input=grad)
        routes.append(plan[0])
        red, out = (Co, Ci) if grad else (Ci, Co)
        if plan[0] == "tf32":
            assert red % 4 or out <= s2d_conv.WGMMA_TF32_THIN
        else:
            chunk = s2d_conv.wgmma_chunk(red, k, plan[2], f32, plan[1])
            assert (chunk == 32) == (k == 3 and red > 16 and plan[1] < 16
                                     and math.ceil(red / 32) * k
                                     >= plan[2])
        _check_plan(plan, f32, N, H, W, Ci, Co, k, grad)
    assert Counter(routes) == F32_ROUTES[(name, direction)]


# mc's f32 forward classes that "tf32" ran faster than "wgmma_tf32" on the
# card (ops/s2d_conv.py gives both times beside WGMMA_TF32_THIN): (x shape,
# w shape)
THIN_CLASSES_F32 = [
    ((8, 224, 384, 64), (11, 11, 64, 16)),
    ((8, 224, 384, 64), (7, 7, 64, 16)),
    ((8, 224, 384, 64), (3, 3, 64, 16)),
    ((8, 224, 384, 64), (3, 3, 64, 2)),
    ((8, 112, 192, 32), (11, 11, 32, 16)),
    ((8, 112, 192, 32), (7, 7, 32, 16)),
    ((8, 112, 192, 32), (3, 3, 32, 16)),
]


@pytest.mark.parametrize("xshape,wshape", THIN_CLASSES_F32)
def test_plan_thin_classes_take_tf32(xshape, wshape):
    """The f32 classes of 16 or fewer output channels, which "tf32" ran
    faster on the card, take "tf32"; "wgmma_tf32" still takes them when
    asked by name (the card's check times both)."""
    N, H, W, _ = xshape
    k, _, Ci, Co = wshape
    f32 = torch.float32
    plan = s2d_conv._plan(f32, N, H, W, Ci, Co, k)
    assert plan == s2d_conv._plan(f32, N, H, W, Ci, Co, k, route="tf32")
    assert plan[0] == "tf32"
    wg = s2d_conv._plan(f32, N, H, W, Ci, Co, k, route="wgmma_tf32")
    assert wg[0] == "wgmma_tf32"
    _check_plan(wg, f32, N, H, W, Ci, Co, k, False)


# mc's bf16 classes that "tc" ran faster than "wgmma" on the card (the
# comment above ops/s2d_conv.py's WGMMA_THIN gives both times): (direction,
# x or ct shape, w shape)
THIN_CLASSES = [
    ("forward", (8, 224, 384, 64), (11, 11, 64, 16)),
    ("forward", (8, 224, 384, 64), (7, 7, 64, 16)),
    ("forward", (8, 224, 384, 64), (3, 3, 64, 16)),
    ("forward", (8, 224, 384, 64), (3, 3, 64, 2)),
    ("forward", (8, 112, 192, 32), (11, 11, 32, 16)),
    ("forward", (8, 112, 192, 32), (7, 7, 32, 16)),
    ("forward", (8, 112, 192, 32), (3, 3, 32, 16)),
    ("grad_input", (8, 224, 384, 16), (11, 11, 64, 16)),
    ("grad_input", (8, 224, 384, 16), (7, 7, 64, 16)),
    ("grad_input", (8, 224, 384, 16), (3, 3, 64, 16)),
    ("grad_input", (8, 112, 192, 16), (11, 11, 32, 16)),
    ("grad_input", (8, 112, 192, 16), (7, 7, 32, 16)),
    ("grad_input", (8, 112, 192, 16), (3, 3, 32, 16)),
]


@pytest.mark.parametrize("direction,ashape,wshape", THIN_CLASSES)
def test_plan_thin_classes_take_tc(direction, ashape, wshape):
    """The classes of 16 output or reduction channels, which "tc" ran
    faster on the card, take "tc" in bf16; "wgmma" still takes them when
    asked by name (the card's check of every instantiation)."""
    N, H, W, _ = ashape
    k, _, Ci, Co = wshape
    grad = direction == "grad_input"
    plan = s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                          grad_input=grad)
    assert plan[0] == "tc"
    assert plan == s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                                  grad_input=grad, route="tc")
    assert s2d_conv._plan(torch.bfloat16, N, H, W, Ci, Co, k,
                          grad_input=grad, route="wgmma")[0] == "wgmma"


def test_plan_explicit_route():
    """``route`` plans a named tensor-core route of the dtype (the card's
    check times "tc" beside "wgmma" on the same inputs) and refuses one the
    arguments cannot take."""
    bf16 = torch.bfloat16
    args = (bf16, 8, 112, 192, 64, 32, 7)
    assert s2d_conv._plan(*args)[0] == "wgmma"
    assert s2d_conv._plan(*args, route="tc") == ("tc", 16, 1)
    assert s2d_conv._plan(*args, route="wgmma") == s2d_conv._plan(*args)
    with pytest.raises(ValueError):
        s2d_conv._plan(bf16, 8, 224, 384, 3, 128, 7, route="wgmma")
    with pytest.raises(ValueError):
        s2d_conv._plan(*args, route="tf32")
    with pytest.raises(ValueError):
        s2d_conv._plan(torch.float32, *args[1:], route="wgmma")
    with pytest.raises(ValueError):
        s2d_conv._plan(bf16, *args[1:], route="wgmma_tf32")
    f32 = (torch.float32, *args[1:])
    assert s2d_conv._plan(*f32)[0] == "wgmma_tf32"
    assert s2d_conv._plan(*f32, route="tf32") == ("tf32", 16, 1)
    with pytest.raises(ValueError):
        s2d_conv._plan(torch.float32, 8, 224, 384, 3, 128, 7,
                       route="wgmma_tf32")


@pytest.mark.parametrize("k,tile_h,red,cob,fits", [
    (11, 16, 64, 16, True),    # mc's 224x384 forward: one chunk, one halo
    (11, 16, 64, 32, True),
    (3, 8, 256, 128, True),    # midas2's 56x96 convs: two halo buffers
    (11, 8, 16, 64, True),     # mc's 224x384 grad-input
    (11, 16, 256, 32, True),   # two halos of 26x26x64 leave 13 stages
    (11, 16, 4096, 512, False),  # 64 KB stages: none beside the halos
])
def test_wgmma_fits(k, tile_h, red, cob, fits):
    """The shared memory of the "wgmma" kernel as its source sizes it: the
    halo tiles (two where the reduction has more than one chunk) and a
    ring of two commit groups' weight stages within 227 KB."""
    assert s2d_conv.wgmma_fits(k, tile_h, red, cob) == fits


@pytest.mark.parametrize("k,tile_h,red,cob,fits", [
    # k=11, a 4-row tile, a block of 64: two halos of 14x26x64 B (23.3 KB)
    # and 8 KB stages (a tap's big and small boxes) leave 22 stages
    (11, 4, 64, 64, True),
    # the 16-row tile's halos are split in shared memory at k >= 7: four
    # of 26x26x64 B (44 KB) leave 11 stages of 4 KB, a tap row
    (11, 16, 64, 32, True),
    (11, 16, 64, 16, True),
    # one chunk (a 16-channel reduction): one halo and its small copy
    (11, 16, 16, 32, True),
    (11, 8, 16, 64, True),
    # k=3 below 16 rows takes a chunk of 32: 128-byte halo rows, 16 KB
    # stages
    (3, 8, 256, 64, True),
    # a block of 64 at 16 rows: the four halos leave 6 stages of 8 KB,
    # fewer than a tap row (the plan's register rule keeps it below 16 rows
    # anyway)
    (11, 16, 64, 64, False),
    # 64 KB stages: none beside the halos
    (11, 16, 4096, 512, False),
])
def test_wgmma_fits_f32(k, tile_h, red, cob, fits):
    """The shared memory of the "wgmma_tf32" kernel as its source sizes it:
    the halo tiles (two where the reduction has more than one chunk, and a
    small copy of each where the 16-row tile at k >= 7 splits the halo in
    shared memory) and a ring of stages of a tap's two TF32 weight boxes,
    a tap row at least, within 227 KB."""
    assert s2d_conv.wgmma_fits(k, tile_h, red, cob, torch.float32) == fits


def test_wgmma_tf32_stage_count():
    """The ring's depth at the k=11 cases of the design: 22 stages beside
    two 4-row halos of 16 channels at a 64-channel block; with a chunk of 32
    channels the halos and stages double and 8 stages remain, fewer than a
    k=11 tap row, so k=11 keeps the chunk of 16."""
    def stages(k, th, chunk, cob, halos):
        halo = s2d_conv._round_up((th + k - 1) * (16 + k - 1) * chunk * 4,
                                  s2d_conv.WGMMA_ALIGN)
        stage = 2 * s2d_conv._round_up(chunk * cob * 4, s2d_conv.WGMMA_ALIGN)
        fixed = (s2d_conv.WGMMA_ALIGN + halos * halo + 32
                 + 16 * s2d_conv.WGMMA_MAX_STAGES)
        return (s2d_conv.WGMMA_SMEM - fixed) // stage

    assert stages(11, 4, 16, 64, 2) == 22
    assert stages(11, 4, 32, 64, 2) == 8
    assert s2d_conv.wgmma_chunk(64, 11, 1, torch.float32, 4) == 16
    assert s2d_conv.wgmma_chunk(64, 3, 1, torch.float32, 4) == 32
    assert s2d_conv.wgmma_chunk(64, 3, 1, torch.float32, 16) == 16
    assert s2d_conv.wgmma_chunk(16, 3, 1, torch.float32, 4) == 16
    # a split over more blocks than the wide chunk's steps halves it
    assert s2d_conv.wgmma_chunk(64, 3, 7, torch.float32, 4) == 16


def test_split_tf32_reference():
    """The "wgmma_tf32" weight split on the CPU: big is w rounded to TF32
    (its low 13 bits zero) and big + small is within 2^-22 of |w|, K-major
    for each direction: (2, k, k, Co, Ci) for the forward; (2, k, k, Ci,
    Co) for the grad-input, which, read at the flipped tap (k-1-r, k-1-c)
    as the kernel's tensor map reads it, is the JAX package's flipped,
    channel-swapped weight ``w[::-1, ::-1].transpose(0, 1, 3, 2)``
    (``layers.py::_conv_pallas_bwd``) as [tap][n][k]. split_tf32 on a CPU
    tensor is the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((11, 11, 64, 16)) / 30).astype(np.float32)
    wf = np.asarray(jnp.asarray(w)[::-1, ::-1].transpose(0, 1, 3, 2))
    wt = torch.from_numpy(w)
    before = s2d_conv.route_counts["weight_split"]
    for grad, want in ((False, w.transpose(0, 1, 3, 2)),
                       (True, wf[::-1, ::-1].transpose(0, 1, 3, 2))):
        planes = s2d_conv.split_tf32_reference(wt, grad).numpy()
        assert planes.shape == (2, *want.shape)
        big, small = planes.astype(np.float64)
        assert np.all(planes.view(np.int32) & 0x1FFF == 0)
        np.testing.assert_array_equal(planes[0], _tf32(want))
        assert np.all(np.abs(big + small - want) <= 2.0 ** -22 * np.abs(want))
        torch.testing.assert_close(s2d_conv.split_tf32(wt, grad),
                                   torch.from_numpy(planes), rtol=0, atol=0)
    assert s2d_conv.route_counts["weight_split"] == before


def test_tf32_wgmma_design_three_terms():
    """The "wgmma_tf32" kernel's arithmetic on a k=11 64->64 class, with f64
    sums: A split per fragment word (big = tf32(x), small = tf32(x - big))
    and B from the pre-split planes, small*big + big*small + big*big, stays
    within 1e-6 of max |ref| of the f64 conv; big*big alone does not."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 12, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((11, 11, 64, 64)) / np.sqrt(11 * 11 * 64)
         ).astype(np.float32)
    planes = s2d_conv.split_tf32_reference(torch.from_numpy(w)).numpy()
    # the planes are [r][c][o][i]: back to HWIO
    wb, ws = (q.transpose(0, 1, 3, 2) for q in planes)
    xb = s2d_conv._tf32_rna(torch.from_numpy(x)).numpy()
    xs = s2d_conv._tf32_rna(torch.from_numpy(x - xb)).numpy()
    np.testing.assert_array_equal(xb, _tf32(x))

    def conv(a, b):
        return s2d_conv.same_conv_reference(
            torch.from_numpy(a.astype(np.float64)),
            torch.from_numpy(b.astype(np.float64))).numpy()

    ref = conv(x, w)
    scale = np.abs(ref).max()
    three = conv(xb, wb) + conv(xb, ws) + conv(xs, wb)
    assert np.abs(three - ref).max() / scale < 1e-6
    assert np.abs(conv(xb, wb) - ref).max() / scale > 1e-4


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64}


def _c_entry_argtypes(source, name):
    """The ctypes of the parameters of the ``extern "C"`` function ``name``
    in ``csrc/<source>``, read from its declaration."""
    text = (_cuda.CSRC_DIR / source).read_text()
    extern = text[text.index('extern "C" {'):]
    m = re.search(r"int\s+" + name + r"\s*\(([^)]*)\)", extern)
    assert m, f"{name} not declared in {source}"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [p.rsplit(" ", 1)[0].replace(" *", "*") for p in params]
    return [_C_TYPES[t] for t in types]


@pytest.mark.parametrize("route,source", [
    ("wgmma", "same_conv_wgmma.cu"), ("tc", "same_conv_tc.cu"),
    ("tf32", "same_conv_tf32.cu"),
    ("wgmma_tf32", "same_conv_wgmma_tf32.cu")])
@pytest.mark.parametrize("direction", ["forward", "grad_input"])
def test_routed_entries_match_argtypes(route, source, direction):
    """ops/_cuda.py's argtypes for each routed conv entry are the
    ``extern "C"`` declaration's parameters, in order: a pointer crosses as
    c_void_p, an int as c_int, an int64_t as c_int64."""
    assert route in _cuda.ROUTED_CONV_ROUTES
    want = (_cuda.ROUTED_FORWARD_ARGTYPES if direction == "forward"
            else _cuda.ROUTED_GRAD_INPUT_ARGTYPES)
    assert _c_entry_argtypes(
        source, f"same_conv_{route}_{direction}") == want


def test_split_weight_entry_matches_argtypes():
    """ops/_cuda.py's argtypes for the weight-split entry of the
    "wgmma_tf32" source are its ``extern "C"`` declaration's parameters."""
    assert _c_entry_argtypes("same_conv_wgmma_tf32.cu",
                             "same_conv_tf32_split_weight") == (
        _cuda.SPLIT_WEIGHT_ARGTYPES)


def test_same_conv_bf16_cpu_takes_reference():
    """A bf16 tensor on the CPU takes the plain version in both directions
    and launches nothing, whatever route the card would take."""
    x, w, b = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(3, 32, 24))
    ct = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 12, 24)).astype(np.float32)).to(torch.bfloat16)
    assert s2d_conv._plan(torch.bfloat16, 2, 8, 12, 32, 24, 3)[0] == "wgmma"
    assert s2d_conv._plan(torch.bfloat16, 2, 8, 12, 32, 24, 3,
                          grad_input=True)[0] == "wgmma"
    before = s2d_conv.launch_counts()
    torch.testing.assert_close(s2d_conv.same_conv(x, w, b),
                               s2d_conv.same_conv_reference(x, w, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        s2d_conv.same_conv_grad_input(ct, w),
        s2d_conv.same_conv_grad_input_reference(ct, w), rtol=0, atol=0)
    assert s2d_conv.launch_counts() == before


def test_cuda_counts_reset():
    s2d_conv.route_counts["forward_tc"] += 3
    s2d_conv.route_counts["grad_input_wgmma"] += 2
    assert s2d_conv.launch_counts() >= (3, 2)
    s2d_conv.reset_counts()
    assert s2d_conv.launch_counts() == (0, 0)
    assert set(s2d_conv.route_counts.values()) == {0}
