"""The plans of K23 ``clamped_chunk_sum`` as a chunk walk (``chunk_walk``:
the copies a tile issues, ``chunk_tiles``: the tiles and the ring) and of K20
``int4_delivery_gemm`` on whole-K column strips (``strip_plan``: the strips
and where a cluster splits the contraction, ``strip_column``: the columns a
strip's tensor-core tiles hold), the variants both launchers take, and what
the launchers hand the kernels. Nothing here asks for the card: a build or a
bind fails these tests, except where a test records the arguments a
launcher binds in place of the library.

The twins run on the CPU: K20 exact (integer products), K23 within 1e-5 of
the largest |output| (fp32 sums in another order) of the column sums.
"""

import ctypes

import pytest
import torch

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import int4_probe_kernels as ik
from acai_omr_tpu_torch.ops import stream_probe_kernels as sk
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS
from acai_omr_tpu_torch.tools import int4_probe

from _torch_port_threads import torch_one_thread  # noqa: F401

K20 = ik.int4_delivery_gemm
K23 = sk.clamped_chunk_sum
# the shapes the card's tests hold K20 to, and the tool's two
K20_SHAPES = [(8, 256, 512), (8, 1024, 4096), (3, 512, 1024),
              (32, 1024, 512), (16, 4096, 1024)]
# K23's chunk shapes: the tool's, the small ones of the CPU and card tests,
# chunk rows that are no whole number of tiles, and one strip of many rows
K23_SHAPES = [(4096, 1024), (64, 128), (16, 128), (100, 256), (1, 384),
              (4099, 1024), (4096, 128), (64, 4096)]


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
# K23: the walk and the tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sk.MODES)
@pytest.mark.parametrize("n", [8, 64])
def test_chunk_walk_copies_each_live_chunk_once(mode, n):
    """At s = -1, 0, 1, n - 2, n - 1, n + 3: the copies are chunks 0 ..
    min(s, n - 1), each once and in order; no step copies an index that did
    not change; the kernel adds exactly where it copies, which is where the
    TPU kernel adds (k <= s); clamped walks all n steps, skip ends at
    min(s, n - 1)."""
    for s in (-1, 0, 1, n - 2, n - 1, n + 3):
        walk = sk.chunk_walk(n, s, mode)
        last = min(s, n - 1)
        assert len(walk) == (n if mode == "clamped" else max(0, last + 1))
        assert [k for k, *_ in walk] == list(range(len(walk)))
        copies = [c for _, c, copy, _ in walk if copy]
        assert copies == list(range(last + 1)), (s, copies)
        prev = -1  # the Pallas pipeline's rule, with its carried index
        for k, c, copy, add in walk:
            assert c == min(k, s)
            assert copy == (k <= s and c != prev), (s, k)
            if c == prev:
                assert not copy, (s, k)
            assert copy == add == (k <= s), (s, k)
            prev = c


def test_chunk_walk_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        sk.chunk_walk(8, 1, "fetch")


@pytest.mark.parametrize("ch,e", K23_SHAPES)
def test_chunk_tiles_cover_every_element_once(ch, e):
    """The tiles (row slice, strip) cover every (row, column) of a chunk
    once, rows past the chunk only in its last slice; the grid stays
    within two blocks an SM unless the tiles are at their 128 rows; the
    ring holds 2..4 tiles in at most 96 KB (two slots whatever)."""
    rows, slices, strips, slots = sk.chunk_tiles(ch, e)
    assert rows in (16, 32, 64, 128) and strips * sk.STRIP == e
    assert (slices - 1) * rows < ch <= slices * rows
    cover = torch.zeros(ch, e, dtype=torch.int32)
    for sl in range(slices):
        for st in range(strips):
            cover[sl * rows:(sl + 1) * rows,
                  st * sk.STRIP:(st + 1) * sk.STRIP] += 1
    assert torch.equal(cover, torch.ones_like(cover))
    assert slices * strips <= 2 * N_SMS or rows == 128
    if rows > 16:  # a tile half as tall would put more than two on an SM
        assert -(-ch // (rows // 2)) * strips > 2 * N_SMS
    tile = rows * sk.STRIP * 2
    assert 2 <= slots <= 4 and (slots * tile <= 96 * 1024 or slots == 2)


def test_chunk_tiles_at_the_tools_shape():
    """x (64, 4096, 1024): 32 row slices x 8 strips of 128 x 128 tiles, 256
    blocks, three 32 KB slots a block: two blocks an SM."""
    assert sk.chunk_tiles(4096, 1024) == (128, 32, 8, 3)


@pytest.mark.parametrize("variant", sk.CHUNK_VARIANTS)
@pytest.mark.parametrize("mode", sk.MODES)
def test_chunk_launcher_hands_the_kernel_its_plan(bound, mode, variant):
    """The walk gets chunk_tiles' rows, slices and slots and the scratch of
    its shape, the same tensors on every call; the grid form its row
    slices; one launch counted a call under the mode (grid: a second
    device kernel)."""
    x = torch.randn(4, 100, 256).to(torch.bfloat16)
    s = torch.tensor([2], dtype=torch.int32)
    op = K23
    before = (op.launches, op.device_launches)
    for _ in range(2):
        out = sk._launch_chunks(op, x, s, mode, variant)
        assert out.shape == (1, 256) and out.dtype == torch.float32
    if variant is None:
        rows, slices, _, slots = sk.chunk_tiles(100, 256)
        (lib, fn, a), (_, _, b) = bound
        assert (lib, fn) == ("stream_probe", "acai_clamped_chunk_walk")
        assert a[5:] == (4, 100, 256, rows, slices, slots,
                         int(mode == "skip"), 0)
        assert a[2:4] == b[2:4]  # partial rows and tickets: allocated once
        partial, tickets = sk._walk_scratch(x.device, slices, 256)
        assert a[2:4] == (partial.data_ptr(), tickets.data_ptr())
        assert partial.shape == (slices, 256)
        assert torch.equal(tickets, torch.zeros(2, dtype=torch.int32))
        assert op.device_launches - before[1] == 2
    else:
        (lib, fn, a), _ = bound
        assert (lib, fn) == ("stream_probe", "acai_clamped_chunk_sum")
        assert a[4:] == (4, 100, 256, 5, int(mode == "skip"), 0)  # 100 = 5 x 20
        assert op.device_launches - before[1] == 4
    assert op.launches - before[0] == 2


@pytest.mark.parametrize("variant", sk.CHUNK_VARIANTS)
def test_chunk_variants_run_the_twin_on_the_cpu(variant):
    """Both forms run the twin on CPU tensors, nothing built; an unknown
    variant is refused before it runs."""
    g = torch.Generator().manual_seed(23)
    x = torch.randn(6, 40, 256, generator=g).to(torch.bfloat16)
    for mode in sk.MODES:
        for s in (-1, 0, 2, 5, 9):
            s_t = torch.tensor([s], dtype=torch.int32)
            got = K23(x, s_t, mode, variant=variant)
            last = min(s, 5)
            want = x[:last + 1].float().sum((0, 1))[None]
            tol = 1e-5 * max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() <= tol
    for bad in ("walk", "atomic", "split2"):
        with pytest.raises(ValueError, match="unknown variant"):
            K23(x, torch.tensor([1], dtype=torch.int32), variant=bad)


# ---------------------------------------------------------------------------
# K20: the strips, the cluster split, the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ik.GEMM_SCHEMES)
@pytest.mark.parametrize("bt,cin,cout", K20_SHAPES)
def test_strips_cover_every_column_once(scheme, bt, cin, cout):
    """cout / 32 strips of 32 columns, and the strip's four 8-column tiles'
    n-slots hold its 32 columns once each (4 g + j for the byte layouts);
    each block of a split takes a whole number of 64-k units."""
    strips, split = ik.strip_plan(bt, cin, cout, scheme)
    assert strips * ik.STRIP_COLS == cout
    cover = torch.zeros(cout, dtype=torch.int32)
    for y in range(strips):
        for j in range(4):
            for g in range(8):
                cover[y * ik.STRIP_COLS + ik.strip_column(scheme, j, g)] += 1
    assert torch.equal(cover, torch.ones_like(cover))
    assert split in (1, 2, 4, 8) and cin % (ik.UNIT * split) == 0


@pytest.mark.parametrize("scheme", ik.GEMM_SCHEMES)
@pytest.mark.parametrize("bt,cin,cout", K20_SHAPES + [(8, 64, 512),
                                                      (1, 16384, 512)])
def test_cluster_split_only_where_the_strips_cannot_fill_the_card(
        scheme, bt, cin, cout):
    """A split > 1 only where the strips are fewer than half the SMs and a
    strip holds more than 32 KB of weights; then the least power of two
    that reaches half the SMs, at most 8, each block a whole number of 64-k
    units."""
    strips, split = ik.strip_plan(bt, cin, cout, scheme)
    short = strips < ik.STRIP_FILL
    deep = ik.strip_bytes(scheme, cin) > ik.SPLIT_MIN_BYTES
    assert (split > 1) == (short and deep), (strips, split)
    if split > 1:
        assert strips * split >= ik.STRIP_FILL or split == ik.MAX_SPLIT \
            or cin % (ik.UNIT * 2 * split)
        assert strips * split // 2 < ik.STRIP_FILL


def test_strip_plan_at_the_tools_and_tests_shapes():
    """The tool's (8, 1024, 4096): 128 strips, no split, in every scheme;
    (16, 4096, 1024): 32 strips of 64 / 128 KB, split 4; (32, 1024, 512):
    16 strips of 16 / 32 KB, no split; a forced split is taken as it is."""
    for scheme in ik.GEMM_SCHEMES:
        assert ik.strip_plan(*int4_probe.TIMING_SHAPE, scheme) == (128, 1)
        assert ik.strip_plan(16, 4096, 1024, scheme) == (32, 4)
        assert ik.strip_plan(32, 1024, 512, scheme) == (16, 1)
        assert ik.strip_plan(8, 1024, 4096, scheme, "split8") == (128, 8)
    assert ik.strip_rows(1) == ik.strip_rows(8) == 8
    assert ik.strip_rows(9) == ik.strip_rows(16) == 16
    assert ik.strip_rows(17) == ik.strip_rows(32) == 32


def _k20_inputs(bt, cin, cout, scheme, seed=20):
    g = torch.Generator().manual_seed(seed)
    lo, hi = (torch.randint(-8, 8, (cin // 2, cout), generator=g,
                            dtype=torch.int8) for _ in range(2))
    x = torch.randint(-127, 128, (bt, cin), generator=g, dtype=torch.int8)
    return x, ik.scheme_weights(lo, hi, scheme), lo, hi


@pytest.mark.parametrize("scheme", ik.GEMM_SCHEMES)
def test_k20_variants_run_the_twin_on_the_cpu(scheme):
    """None, "atomic" and the splits that divide the contraction run the
    exact twin on CPU tensors, nothing built; an unknown variant, a split
    past 8 or one that does not divide cin / 64 is refused before it runs,
    as are the shapes the kernels do not take."""
    x, w, lo, hi = _k20_inputs(3, 256, 512, scheme)
    want = (x.double() @ torch.cat([lo, hi]).double()).to(torch.int32)
    for variant in (None, "atomic", "split1", "split2", "split4"):
        assert torch.equal(K20(x, w, scheme, variant=variant), want)
    for bad in ("grid", "split3", "split16", "split8", "wmma"):
        with pytest.raises(ValueError, match="unknown variant"):
            K20(x, w, scheme, variant=bad)
    with pytest.raises(ValueError, match="bt must be"):
        K20(torch.zeros(33, 256, dtype=torch.int8), w, scheme)


@pytest.mark.parametrize("variant", [None, "atomic", "split2"])
@pytest.mark.parametrize("scheme", ik.GEMM_SCHEMES)
def test_k20_launcher_hands_the_kernel_its_plan(bound, scheme, variant):
    """The strip kernel gets the plan's split and writes the whole output
    (nothing zeroed, one device kernel); the atomic form its splits over a
    zeroed output (two device kernels where it splits)."""
    bt, cin, cout = 16, 4096, 1024
    x, w, _, _ = _k20_inputs(bt, cin, cout, scheme)
    op = K20
    before = (op.launches, op.device_launches, dict(op.variants))
    ik._launch_gemm(op, x, w, scheme, variant)
    ((lib, fn, a),) = bound
    assert lib == "int4_probe" and a[3:8] == (
        ik.GEMM_SCHEMES.index(scheme), bt, cin, cout, a[7])
    if variant == "atomic":
        assert fn == "acai_int4_delivery_gemm"
        assert a[7] == ik.atomic_splits(bt, cin, cout, scheme) == 64
        assert op.device_launches - before[1] == 2
        key = f"{scheme} atomic"
    else:
        assert fn == "acai_int4_delivery_gemm_strip"
        split = 2 if variant else 4
        assert a[7] == split
        assert op.device_launches - before[1] == 1
        key = f"{scheme} split{split}"
    assert op.launches - before[0] == 1
    assert op.variants[key] == before[2].get(key, 0) + 1
