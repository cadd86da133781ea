"""Port's same_conv (plain path on the CPU) against the JAX package's Pallas
s2d conv (interpret mode) and its XLA conv, and SameConv2d's routing.

The cases are the hourglass's conv classes (stem, inception branches,
merged heads) at a small spatial size. Inputs come from a numpy seed and
reach both packages as the same values. Tolerance: f32, rtol = atol = 2e-5
(the band of tests/test_s2d_pallas.py); the two sides differ only in
summation order.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consistent_depth_tpu.models import layers as jax_layers
from consistent_depth_tpu.ops.s2d_conv import s2d_conv_pallas
from consistent_depth_tpu_torch.models import hourglass, layers
from consistent_depth_tpu_torch.ops import s2d_conv

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
    before = s2d_conv.launches
    torch.testing.assert_close(s2d_conv.same_conv(*args),
                               s2d_conv.same_conv_reference(*args),
                               rtol=0, atol=0)
    assert s2d_conv.launches == before


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
TC_ROUTES = {torch.bfloat16: ("tc", 16), torch.float32: ("tf32", 8)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("direction", ["forward", "grad_input"])
def test_plan_routes_hourglass_classes(direction, dtype):
    """For every conv class of one batch-8 forward at 224x384 (68 calls)
    and of its backward (67 grad-inputs: the stem's input needs none), each
    dtype takes its tensor-core route, bf16 "tc" and f32 "tf32" (the stem's
    3 input channels and the merged heads' 2-channel cotangent too), with
    steps of 16 bf16 or 8 f32 reduction channels. A plan's tiles cover the
    output, and a split's ranges cover every reduction step once, with at
    least MIN_BLOCKS blocks."""
    calls = _hourglass_calls()
    assert len(calls) == 68
    grad = direction == "grad_input"
    if grad:
        calls = calls[1:]
    want_route, chunk = TC_ROUTES[dtype]
    assert s2d_conv.CHUNK[dtype] == chunk
    for (N, H, W, Ci), (k, _, _, Co) in calls:
        route, th, split = s2d_conv._plan(dtype, N, H, W, Ci, Co, k,
                                          grad_input=grad)
        assert route == want_route and th in s2d_conv.TILE_HEIGHTS
        red, out = (Co, Ci) if grad else (Ci, Co)
        rows, cols = math.ceil(H / th), math.ceil(W / s2d_conv.TILE_W)
        assert (rows - 1) * th < H <= rows * th
        assert (cols - 1) * s2d_conv.TILE_W < W <= cols * s2d_conv.TILE_W
        cob = s2d_conv.co_block(out, dtype)
        assert cob <= s2d_conv.MAX_CO_BLOCK[dtype]
        co_blocks = math.ceil(out / cob)
        assert co_blocks * cob >= out
        steps = math.ceil(red / chunk) * k
        assert 1 <= split <= steps
        ranges = _split_ranges(steps, split)
        assert [s for r in ranges for s in r] == list(range(steps))
        assert all(len(r) for r in ranges)
        assert rows * cols * N * co_blocks * split >= s2d_conv.MIN_BLOCKS
        if split > 1:
            assert th == min(s2d_conv.TILE_HEIGHTS)


def test_plan_narrow_and_ragged_cases():
    """Narrow reductions take the tensor cores in both dtypes; a grad-input
    into a number of channels that is not a whole number of 16-byte units
    (8 bf16, 4 f32) takes the FMA template; a one-image ragged case splits
    up to its steps."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert s2d_conv._plan(bf16, 8, 224, 384, 3, 128, 7)[0] == "tc"
    assert s2d_conv._plan(bf16, 8, 224, 384, 64, 2, 3,
                          grad_input=True)[0] == "tc"
    assert s2d_conv._plan(bf16, 8, 224, 384, 3, 128, 7,
                          grad_input=True)[0] == "fma"
    assert s2d_conv._plan(bf16, 8, 224, 384, 64, 2, 3)[0] == "tc"
    assert s2d_conv._plan(f32, 8, 224, 384, 3, 128, 7)[0] == "tf32"
    assert s2d_conv._plan(f32, 8, 224, 384, 64, 2, 3,
                          grad_input=True)[0] == "tf32"
    assert s2d_conv._plan(f32, 8, 224, 384, 3, 128, 7,
                          grad_input=True) == ("fma", 0, 1)
    assert s2d_conv._plan(f32, 8, 224, 384, 64, 2, 3)[0] == "tf32"
    # a grad-input into 4 channels is a whole 16-byte unit in f32 only
    assert s2d_conv._plan(f32, 2, 64, 96, 4, 16, 3,
                          grad_input=True)[0] == "tf32"
    assert s2d_conv._plan(bf16, 2, 64, 96, 4, 16, 3,
                          grad_input=True)[0] == "fma"
    # 1x7x13, k=11, 64 -> 16: two 4x16 tiles, 44 steps of the reduction
    # in bf16 (16 channels each), 88 in f32 (8 channels each)
    assert s2d_conv._plan(bf16, 1, 7, 13, 64, 16, 11) == ("tc", 4, 44)
    assert s2d_conv._plan(bf16, 1, 7, 13, 64, 16, 11, grad_input=True) == (
        "tc", 4, 11)
    assert s2d_conv._plan(f32, 1, 7, 13, 64, 16, 11) == ("tf32", 4, 88)
    assert s2d_conv._plan(f32, 1, 7, 13, 64, 16, 11, grad_input=True) == (
        "tf32", 4, 22)


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


def test_cuda_counts_reset():
    s2d_conv.route_counts["forward_tc"] += 3
    s2d_conv.launches += 1
    s2d_conv.reset_counts()
    assert s2d_conv.launches == s2d_conv.grad_input_launches == 0
    assert set(s2d_conv.route_counts.values()) == {0}
