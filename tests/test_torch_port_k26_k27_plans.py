"""The plans of K26 ``batched_head_logits`` on whole staged slabs
(``batched_plan``: the block of each (image, head) pair walks its keys in
chunks, each key once, no chunk past 64 KB or without keys) and of K27
``resident_elementwise`` on the plan kernel (``resident_plan``: lanes,
values a lane and pieces a block, a piece a row for softmax and ln; every
element once, at least 132 blocks at the tool's shapes, every layout one
the source compiles), the variants both launchers take, what the launchers
hand the kernels, and the clamp of the A&S erf that makes a GELU pass cost
the same on overflowed values. Nothing
here asks for the card: a build or a bind fails these tests, except where a
test records the arguments a launcher binds in place of the library.

Tolerances: K26 int8 exact (integer products and sums); fp32 within 1e-5 of
the largest |output| (exact products, fp32 sums in another order). K27
within 1e-5 of the largest |output|, as the card's tests hold it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import head_logits_kernels as hk
from acai_omr_tpu_torch.ops import vpu_probe_kernels as vk
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS
from acai_omr_tpu_torch.tools import mosaic_batched_attn_probe as mbp
from acai_omr_tpu_torch.tools import vpu_probe as vpp

from _torch_port_threads import torch_one_thread  # noqa: F401

K26 = hk.batched_head_logits
K27 = vk.resident_elementwise
DTYPES = (torch.float32, torch.int8)
# K26's (BT, T, H): the tool's, the card tests', one key, ragged T, T past
# one block's slab in fp32
K26_SHAPES = [(mbp.BT, mbp.T, mbp.H), (2, 1024, 16), (3, 77, 4), (1, 1, 1),
              (4, 1000, 2), (2, 512, 16), (1, 257, 16)]
# K27's (rows, cols): the tool's eleven and small blocks of every width
K27_SHAPES = sorted({s for shapes in vpp.SHAPES.values() for s in shapes}
                    | {(4, 256), (8, 768), (16, 1024), (3, 3072), (1, 4096)})


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


@pytest.fixture
def bound(monkeypatch):
    """Records (library, function, arguments) of every launch in place of
    the kernel; the CUDA checks on the tensors pass for CPU tensors."""
    calls = []

    def bind(name, fn, argtypes):
        def launch(*args):
            assert len(args) == len(argtypes)
            calls.append((name, fn, args))
            return 0
        return launch
    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    return calls


# ---------------------------------------------------------------------------
# K26: the chunks of a pair's keys, the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bt,t,h", K26_SHAPES)
def test_batched_plan_covers_every_key_once(bt, t, h, dtype):
    """Chunk c of a pair takes keys [c R, c R + R) clipped at T: every key
    once, no chunk without keys, none past 64 KB of keys, and the fewest
    chunks that fit."""
    chunks, rows = hk.batched_plan(bt, t, h, dtype)
    cover = torch.zeros(t, dtype=torch.int32)
    for c in range(chunks):
        lo, hi = c * rows, min((c + 1) * rows, t)
        assert hi > lo
        cover[lo:hi] += 1
    assert torch.equal(cover, torch.ones_like(cover))
    row_bytes = hk.slab_row_bytes(dtype)
    assert rows * row_bytes <= hk.SLAB_BYTES
    assert (chunks - 1) * hk.SLAB_BYTES < t * row_bytes


def test_batched_plan_at_the_tools_shape():
    """BT 8, T 128, H 16: one chunk (32 KB fp32 / 8 KB int8); fp32 T =
    1,024 walks four chunks of 256 keys, int8 takes 1,024 keys in one; fp32
    T = 257 two chunks of 129 and 128."""
    assert hk.batched_plan(8, 128, 16, torch.float32) == (1, 128)
    assert hk.batched_plan(8, 128, 16, torch.int8) == (1, 128)
    assert hk.batched_plan(2, 1024, 16, torch.float32) == (4, 256)
    assert hk.batched_plan(2, 1024, 16, torch.int8) == (1, 1024)
    assert hk.batched_plan(2, 512, 16, torch.float32) == (2, 256)
    assert hk.batched_plan(1, 257, 16, torch.float32) == (2, 129)
    assert hk.slab_row_bytes(torch.float32) == 256
    assert hk.slab_row_bytes(torch.int8) == 64


@pytest.mark.parametrize("shape,kdtype,qshape,match", [
    ((1, 1025, 64), torch.float32, (1, 64), "T must lie"),
    ((2, 8, 64), torch.int8, (1, 64), "q must be"),
    ((1, 8, 64), torch.bfloat16, (1, 64), "k must be"),
    ((1, 8, 100), torch.float32, (1, 100), "heads of")])
def test_batched_refuses_what_the_kernel_does_not_take(shape, kdtype,
                                                       qshape, match):
    """Past 1,024 keys, a q of another shape, a k of another dtype, a width
    that is not whole heads of 64: refused before anything runs, by either
    variant."""
    k, q = torch.zeros(shape, dtype=kdtype), torch.zeros(qshape)
    for variant in hk.BATCHED_VARIANTS:
        with pytest.raises(ValueError, match=match):
            K26(k, q, 1, variant=variant)


def _k26_inputs(bt, t, h, int8, seed=26):
    g = torch.Generator().manual_seed(seed)
    e = h * hk.DH
    if int8:
        k = torch.randint(-127, 128, (bt, t, e), generator=g,
                          dtype=torch.int8)
        q = torch.randint(-127, 128, (bt, e), generator=g).float()
    else:
        k, q = torch.randn(bt, t, e, generator=g), torch.randn(bt, e,
                                                               generator=g)
    return k, q


@pytest.mark.parametrize("int8", [False, True])
def test_batched_variants_run_the_twin_on_the_cpu(int8):
    """Every variant runs the twin on CPU tensors, nothing built (int8
    exact, the transpose equal to the column sums); an unknown variant is
    refused before it runs."""
    k, q = _k26_inputs(3, 100, 4, int8)
    want = hk.batched_head_logits_plain(k, q, 4)
    for variant in hk.BATCHED_VARIANTS:
        got = K26(k, q, 4, variant=variant)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(got[2].t(), got[1])
    for bad in ("wmma", "split1", "split2", "grid"):
        with pytest.raises(ValueError, match="unknown variant"):
            K26(k, q, 4, variant=bad)


@pytest.mark.parametrize("variant", hk.BATCHED_VARIANTS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bt,t", [(8, 128), (2, 1024), (1, 257)])
def test_batched_launcher_hands_the_kernel_its_plan(bound, bt, t, int8,
                                                    variant):
    """The slab kernel gets (BT, T, H, int8) and the plan's keys a chunk,
    one launch counted as "<dtype> slab"; the replaced kernel the same
    arguments without the chunk, counted "<dtype> shuffle"; one device
    kernel a call."""
    h = 16
    k, q = _k26_inputs(bt, t, h, int8)
    op = K26
    before = (op.launches, op.device_launches, dict(op.variants))
    compact, colsum, col = hk._launch_batched(op, k, q, h, variant)
    assert compact.shape == (t, bt * h) and colsum.shape == (1, bt * h)
    assert col.shape == (bt * h, 1)
    ((lib, fn, a),) = bound
    assert lib == "head_logits"
    assert a[5:9] == (bt, t, h, int(int8))
    dtype = "int8" if int8 else "fp32"
    if variant == "shuffle":
        assert fn == "acai_batched_head_logits" and len(a) == 10
        key = f"{dtype} shuffle"
    else:
        _, chunk = hk.batched_plan(bt, t, h, k.dtype)
        assert fn == "acai_batched_head_logits_slab" and a[9] == chunk
        key = f"{dtype} slab"
    assert op.launches - before[0] == op.device_launches - before[1] == 1
    assert op.variants[key] == before[2].get(key, 0) + 1


# ---------------------------------------------------------------------------
# K27: the plan kernel's layout, the variants, the erf clamp
# ---------------------------------------------------------------------------

def _blocks(rows, cols, work):
    """The plan kernel's grid: the pieces over pieces a block (as
    ``acai_resident_elementwise_plan`` computes it)."""
    lanes, values, per_block, _ = vk.resident_plan(rows, cols, work)
    return rows * cols // (lanes * values * per_block)


@pytest.mark.parametrize("work", vk.WORKS)
@pytest.mark.parametrize("rows,cols", K27_SHAPES)
def test_resident_plan_covers_every_element_once(rows, cols, work):
    """Block b, thread j, value i of the plan kernel holds element (b P + j
    // L) L V + j % L + i L of the flat block, P pieces of L lanes x V
    values a block: every element once; a piece is a whole row for softmax
    and ln; whole warps, at most 128 threads, at most 32 values a lane."""
    lanes, values, per_block, smem = vk.resident_plan(rows, cols, work)
    threads = lanes * per_block
    assert values <= 32 and cols % (lanes * values) == 0
    assert threads % 32 == 0 and threads <= 128 and lanes in (32, 64, 128)
    if work in ("softmax", "ln"):
        assert lanes * values == cols and per_block == 1
    blocks = _blocks(rows, cols, work)
    assert blocks * per_block * lanes * values == rows * cols
    b = torch.arange(blocks).view(-1, 1, 1)
    j = torch.arange(threads).view(1, -1, 1)
    i = torch.arange(values).view(1, 1, -1)
    flat = (b * per_block + j // lanes) * lanes * values + j % lanes \
        + i * lanes
    cover = torch.bincount(flat.flatten(), minlength=rows * cols)
    assert torch.equal(cover, torch.ones_like(cover))
    assert smem == (work == "ln" and lanes == 32 and rows <= 2 * N_SMS)
    assert vk.plan_variant(rows, cols, work) == \
        f"{work} {cols} {lanes}x{values}" + (" smem" if smem else "")


@pytest.mark.parametrize("work,rows,cols", [
    (w, r, c) for w, shapes in vpp.SHAPES.items() for r, c in shapes])
def test_resident_plan_fills_the_card_at_the_tools_shapes(work, rows, cols):
    """Each of the tool's eleven shapes launches at least 132 blocks and a
    warp an SM (the kernel it replaced: 64 blocks at softmax 256 x 256);
    the GELU works at least 8 warps an SM."""
    _, values, _, _ = vk.resident_plan(rows, cols, work)
    assert _blocks(rows, cols, work) >= N_SMS
    warps = rows * cols // (values * 32)
    assert warps >= (8 if work.startswith("gelu") else 1) * N_SMS


def test_resident_plan_at_the_tools_shapes():
    """softmax rows of 1,024 on 128 lanes only where they are few; ln and
    the other softmax rows on 32 lanes, ln's sums through shared memory
    where the rows are few; the GELU works 32 x 8 pieces."""
    assert vk.resident_plan(256, 1024, "softmax") == (128, 8, 1, False)
    assert vk.resident_plan(1024, 1024, "softmax") == (32, 32, 1, False)
    assert vk.resident_plan(256, 256, "softmax") == (32, 8, 1, False)
    assert vk.resident_plan(256, 1024, "ln") == (32, 32, 1, True)
    assert vk.resident_plan(1024, 768, "ln") == (32, 24, 1, False)
    assert vk.resident_plan(1024, 3072, "gelu") == (32, 8, 4, False)
    assert _blocks(256, 4096, "gelu_erff") == 1024


def test_resident_plan_refuses_what_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="no plan"):
        vk.resident_plan(8, 512, "ln")
    with pytest.raises(ValueError, match="no plan"):
        vk.resident_plan(8, 256, "tanh")


@pytest.mark.parametrize("variant", [*vk.VARIANTS, "32x8 smem"])
def test_resident_variants_run_the_twin_on_the_cpu(variant):
    """Both kernels' variants and a forced layout run the twin on CPU
    tensors, nothing built; an unknown variant is refused before it runs,
    as are the shapes the replaced kernel does not take."""
    x = vpp.make_block(8, 256, "cpu")
    for work in vk.WORKS:
        want = vk.resident_elementwise_plain(x, work, 3)
        assert torch.equal(K27(x, work, 3, variant=variant), want)
    for bad in ("wmma", "plan", "lanes64", "32x8 shared", "x8"):
        with pytest.raises(ValueError, match="unknown variant"):
            K27(x, "ln", 1, variant=bad)
    with pytest.raises(ValueError, match="multiple of 4"):
        K27(torch.zeros(6, 256), "ln", 1, variant=variant)


@pytest.mark.parametrize("variant", vk.VARIANTS)
@pytest.mark.parametrize("rows,cols", [(256, 256), (1024, 3072), (4, 768)])
def test_resident_launcher_hands_the_kernel_its_plan(bound, rows, cols,
                                                     variant):
    """The plan kernel gets (rows, cols, work, iters) and the plan's lanes,
    values and pieces a block, counted "<work> <cols> <L>x<V>"; the replaced
    kernel the same without the plan, counted "<work> <cols> fixed"."""
    x = torch.zeros(rows, cols)
    op = K27
    before = (op.launches, dict(op.variants))
    out = vk._launch(op, x, "softmax", 5, variant)
    assert out.shape == x.shape
    ((lib, fn, a),) = bound
    assert lib == "resident_elementwise" and a[2:6] == (rows, cols, 0, 5)
    if variant == "fixed":
        assert fn == "acai_resident_elementwise" and len(a) == 7
        key = f"softmax {cols} fixed"
    else:
        assert fn == "acai_resident_elementwise_plan"
        lanes, values, per_block, smem = vk.resident_plan(rows, cols,
                                                          "softmax")
        assert a[6:10] == (lanes, values, per_block, int(smem))
        key = vk.plan_variant(rows, cols, "softmax")
    assert op.launches - before[0] == 1
    assert op.variants[key] == before[1].get(key, 0) + 1


def _compiled_layouts():
    """(work, cols, lanes, values, shared sums) of every plan kernel the
    source compiles: the lines of its K27_PLANS list."""
    src = (Path(vk.__file__).parent.parent / "csrc"
           / "resident_elementwise.cu").read_text()
    body = src[src.index("#define K27_PLANS(X)"):]
    body = body[:body.index("\n\n")]
    found = re.findall(r'X\(\w+, "(\w+)", (\d+), (\d+), (\d+), ([01])\)',
                       body)
    return {(w, int(c), int(l), int(v), s == "1") for w, c, l, v, s in found}


# rows on either side of resident_plan's threshold, and the tools'
PLAN_ROWS = (1, 2 * N_SMS, 2 * N_SMS + 1, 1024, 8192)


@pytest.mark.parametrize("work", vk.WORKS)
@pytest.mark.parametrize("cols", vk.COLS)
def test_resident_plan_takes_only_compiled_layouts(work, cols):
    """Every layout the plan takes at any row count is one the source
    compiles, so no plan reaches the card as an invalid value."""
    compiled = _compiled_layouts()
    for rows in PLAN_ROWS:
        lanes, values, _, smem = vk.resident_plan(rows, cols, work)
        assert (work, cols, lanes, values, smem) in compiled, (rows, cols)


def test_every_compiled_layout_is_a_plan():
    """No kernel is compiled that the plan never takes."""
    taken = {(w, c, *vk.resident_plan(r, c, w)[:2],
              vk.resident_plan(r, c, w)[3])
             for w in vk.WORKS for c in vk.COLS for r in PLAN_ROWS}
    assert _compiled_layouts() == taken


@pytest.mark.parametrize("work,rows,cols", [
    (w, r, c) for w in ("softmax", "ln") for r, c in vpp.SHAPES[w]])
def test_resident_launcher_forces_a_layout(bound, work, rows, cols):
    """A layout variant (what chip_smoke.py --k27-plan compares) hands the
    plan kernel that layout and is counted under it: here the layout the
    plan takes on the other side of its row threshold."""
    other = 2 * N_SMS + 1 if rows <= 2 * N_SMS else 2 * N_SMS
    lanes, values, per_block, smem = vk.resident_plan(other, cols, work)
    variant = f"{lanes}x{values}" + (" smem" if smem else "")
    op = K27
    before = dict(op.variants)
    vk._launch(op, torch.zeros(rows, cols), work, 3, variant)
    ((_, fn, a),) = bound
    assert fn == "acai_resident_elementwise_plan"
    assert a[6:10] == (lanes, values, per_block, int(smem))
    key = f"{work} {cols} {variant}"
    assert key == vk.plan_variant(other, cols, work)
    assert op.variants[key] == before.get(key, 0) + 1


def test_erf_clamp_changes_no_bit():
    """The A&S erf of |z| clamped at ERF_ONE equals the unclamped one bit
    for bit, finite or infinite: from |z| = 4 on, poly exp(-z^2) is below
    half an ulp of 1, so both round to +-1."""
    z = np.concatenate([np.linspace(-60.0, 60.0, 400_001, dtype=np.float32),
                        np.float32([np.inf, -np.inf, 3.4e38, -3.4e38, 1e20,
                                    vk.ERF_ONE, np.nextafter(
                                        np.float32(vk.ERF_ONE), np.inf)])])
    z = torch.from_numpy(z)
    plain = vk.erf_rational(z)
    clamped = vk.erf_rational(z.clamp(-vk.ERF_ONE, vk.ERF_ONE))
    assert torch.equal(plain, clamped)
    assert torch.equal(plain[z.abs() >= 4.0].abs(),
                       torch.ones_like(plain[z.abs() >= 4.0]))


@pytest.mark.parametrize("work", ["gelu", "gelu_poly", "gelu_erff"])
def test_resident_twin_keeps_infs_on_an_overflowed_block(work):
    """The GELU feedback y ~ 1.5 x overflows (as on the TPU): after 320
    passes a small block holds infs, and 8 more passes keep each inf an inf
    and every other value finite, with no NaN: the block the card's tests
    hold both kernels to."""
    x = vpp.make_block(4, 256, "cpu")
    ovf = vk.resident_elementwise_plain(x, work, 320)
    assert torch.isinf(ovf).any() and not torch.isnan(ovf).any()
    out = vk.resident_elementwise_plain(ovf, work, 8)
    assert not torch.isnan(out).any()
    assert torch.isinf(out)[torch.isinf(ovf)].all()
