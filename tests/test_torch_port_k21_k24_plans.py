"""The plans of K24 ``lane_stream_sum`` in one launch (``stream_plan``: the
persistent grid, ``stream_walk``: the float4s each thread loads) and of K21
``int4_unpack`` on whole words (``unpack_plan``: the grid, ``unpack_walk``:
the pieces each thread loads), the variants both launchers take, what the
launchers hand the kernels, and numpy models of the kernels' arithmetic: K24's
lane tree and last-block sum, each K21 scheme's word arithmetic (the nibble
sign spread, the i16 halves, the i8div byte lanes, the f32 ``prmt`` byte
order) and eyedot's ``mma.sync`` fragments. Nothing here asks for the card: a
build or a bind fails these tests, except where a test records the arguments
a launcher binds in place of the library.

The twins run on the CPU: K21 exact, K24 within 1e-5 of the largest |output|
(fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import int4_probe_kernels as ik
from acai_omr_tpu_torch.ops import stream_probe_kernels as sk
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS
from acai_omr_tpu_torch.tools import narrow_lane_dma_probe as nlp
from acai_omr_tpu_torch.tools import unpack_probe

from _torch_port_threads import torch_one_thread  # noqa: F401

K21 = ik.int4_unpack
K24 = sk.lane_stream_sum
# x (blocks, T, lanes) of K24: the tool's two widths and its equal-bytes
# 16-lane call, the card test's edge shapes, and a few between
K24_SHAPES = [(nlp.N_BLOCKS, nlp.T, 16), (nlp.N_BLOCKS, nlp.T, 128),
              (8 * nlp.N_BLOCKS, nlp.T, 16), (3, 1024, 4), (5, 8, 256),
              (7, 128, 32), (1, 16, 64), (600, 256, 8)]
# packed (half, cols) of K21: the tool's, the smallest, ragged eyedot tiles
# (cols not a multiple of 128), and one past a single round of the grid
K21_SHAPES = [(unpack_probe.HALF, unpack_probe.OUT), (16, 16), (16, 144),
              (48, 272), (32, 4096), (4096, 4096)]


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
# K24: the persistent grid, the walk, the sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", K24_SHAPES)
def test_stream_plan_covers_every_float_once(shape):
    """The walk's loads cover every float4 of the stream once (so every
    float once); at most one block an SM, 16 loads a thread a step; the
    stride between a thread's loads, 4 x the grid's threads floats, is a
    multiple of lanes, so each of its four accumulators holds one lane."""
    x, c = torch.zeros(shape), torch.zeros(1, shape[2])
    lanes, blocks, vec = sk.stream_plan(x, c)
    n4 = x.numel() // 4
    assert lanes == shape[2] and vec == sk.STREAM_VEC == 16
    assert 1 <= blocks <= sk.STREAM_BLOCKS_PER_SM * N_SMS
    walk = sk.stream_walk(n4, blocks, vec)
    got = walk[walk >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(n4))
    threads = blocks * sk.STREAM_THREADS
    assert 4 * threads % lanes == 0
    # each thread's loads: lanes 4 (g mod lanes / 4) .. + 3 at every step
    first = (4 * torch.arange(threads)) % lanes
    lane_of = torch.where(walk >= 0, (4 * walk) % lanes, first)
    assert torch.equal(lane_of, first.expand_as(lane_of))
    if blocks < sk.STREAM_BLOCKS_PER_SM * N_SMS:  # one step, no block idle
        assert walk.shape[0] == 1
        assert (blocks - 1) * sk.STREAM_THREADS * vec < n4


def test_stream_plan_at_the_tools_shapes():
    """16 lanes (8 MiB): 128 blocks, one step of 16 loads a thread; 128
    lanes and the equal-bytes 16-lane call (64 MiB): one block an SM, 8
    steps."""
    for shape, want in (((256, 512, 16), (16, 128, 16)),
                        ((256, 512, 128), (128, N_SMS, 16)),
                        ((2048, 512, 16), (16, N_SMS, 16)),
                        ((3, 1024, 4), (4, 1, 16))):
        assert sk.stream_plan(torch.zeros(shape),
                              torch.zeros(1, shape[2])) == want
    assert sk.two_pass_plan(256 * 512 * 16) == (512, 1024)


def _lane_tree(v, q):
    """``csrc/stream_probe.cu`` ``lane_tree`` on a block's (256, 4) float32
    values: a butterfly inside each warp over the strides 16 .. q, then
    column t adds the warps that hold it in warp order."""
    v = v.reshape(sk.STREAM_THREADS // 32, 32, 4).copy()
    s = 16
    while s >= q:
        v = v + v[:, np.arange(32) ^ s]
        s //= 2
    per = q // 32 if q > 32 else 1
    cols = []
    for t in range(q):
        acc = v[t // 32, t % 32]
        for w in range(t // 32 + per, v.shape[0], per):
            acc = acc + v[w, t % 32]
        cols.append(acc)
    return np.stack(cols).reshape(-1)


def _kernel_model(x, c):
    """K24's sums in the kernel's order, in float32: each thread's float4
    accumulator over its walk, each block's lane tree into a partial row,
    the last block's strided sums of the rows, the tree, then c."""
    flat = x.reshape(-1, 4).astype(np.float32)
    lanes = x.shape[2]
    q = lanes // 4
    _, blocks, vec = sk.stream_plan(torch.from_numpy(x),
                                    torch.from_numpy(c))
    walk = sk.stream_walk(flat.shape[0], blocks, vec).numpy()
    threads = blocks * sk.STREAM_THREADS
    acc = np.zeros((threads, 4), np.float32)
    for step in range(walk.shape[0]):
        for j in range(vec):
            idx = walk[step, j]
            acc += np.where((idx >= 0)[:, None], flat[np.maximum(idx, 0)],
                            np.float32(0))
    n = sk.STREAM_THREADS
    rows = np.stack([_lane_tree(acc[b * n:(b + 1) * n], q)
                     for b in range(blocks)]).reshape(blocks, q, 4)
    stride = sk.STREAM_THREADS // q
    last = np.zeros((sk.STREAM_THREADS, 4), np.float32)
    for t in range(sk.STREAM_THREADS):
        for r in range(t // q, blocks, stride):
            last[t] += rows[r, t % q]
    return _lane_tree(last, q) + c.reshape(-1)


@pytest.mark.parametrize("shape", [(3, 1024, 4), (5, 8, 256), (7, 128, 32),
                                   (600, 256, 8), (64, 512, 16)])
def test_stream_kernel_order_sums_each_lane(shape):
    """The kernel's order of sums (walk, tree, last block) adds each lane's
    values once: within 1e-5 of the largest |output| of the twin."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal(shape).astype(np.float32)
    c = rng.standard_normal((1, shape[2])).astype(np.float32)
    want = K24.plain(torch.from_numpy(x), torch.from_numpy(c)).numpy()[0]
    got = _kernel_model(x, c)
    tol = 1e-5 * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("variant", sk.STREAM_VARIANTS)
def test_stream_launcher_hands_the_kernel_its_plan(bound, variant):
    """The one-launch kernel gets the float4 count, stream_plan's blocks and
    the scratch of its shape (the same tensors on every call, the ticket
    zero), one device kernel a call counted "lanes=16"; the two-pass form
    its plan, two device kernels counted "lanes=16 two_pass"."""
    x, c = torch.randn(8, 256, 16), torch.randn(1, 16)
    op = K24
    before = (op.launches, op.device_launches, dict(op.variants))
    for _ in range(2):
        out = sk._launch_stream(op, x, c, variant)
        assert out.shape == (1, 16) and out.dtype == torch.float32
    (lib, fn, a), (_, _, b) = bound
    if variant is None:
        _, blocks, _ = sk.stream_plan(x, c)
        assert (lib, fn) == ("stream_probe", "acai_lane_stream_sum")
        assert a[5:] == (x.numel() // 4, blocks, 16, 0)
        partial, ticket = sk._stream_scratch(x.device, blocks, 16)
        assert a[2:4] == b[2:4] == (partial.data_ptr(), ticket.data_ptr())
        assert partial.shape == (blocks, 16)
        assert torch.equal(ticket, torch.zeros(1, dtype=torch.int32))
        assert op.device_launches - before[1] == 2
        key = "lanes=16"
    else:
        assert (lib, fn) == ("stream_probe", "acai_lane_stream_sum_two_pass")
        assert a[4:] == (*sk.two_pass_plan(x.numel()), 16, 0)
        assert op.device_launches - before[1] == 4
        key = "lanes=16 two_pass"
    assert op.launches - before[0] == 2
    assert op.variants[key] == before[2].get(key, 0) + 2


@pytest.mark.parametrize("variant", sk.STREAM_VARIANTS)
def test_stream_variants_run_the_twin_on_the_cpu(variant):
    """Both forms run the twin on CPU tensors, nothing built; an unknown
    variant is refused before it runs."""
    g = torch.Generator().manual_seed(24)
    x, c = torch.randn(5, 8, 256, generator=g), torch.randn(1, 256,
                                                            generator=g)
    want = c + x.sum((0, 1))[None]
    assert torch.allclose(K24(x, c, variant=variant), want, rtol=0,
                          atol=1e-5 * max(1.0, want.abs().max().item()))
    for bad in ("grid", "one_pass", "bytewise"):
        with pytest.raises(ValueError, match="unknown variant"):
            K24(x, c, variant=bad)


# ---------------------------------------------------------------------------
# K21: the grid, the walk, the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["i32", "eyedot"])
@pytest.mark.parametrize("half,cols", K21_SHAPES)
def test_unpack_plan_covers_every_piece_once(scheme, half, cols):
    """The word kernels' threads (eyedot's lanes) read every 16-byte piece
    of the packed block once, four pieces (64 bytes) a thread a round; at
    most four blocks an SM, and one round wherever the grid is not full."""
    blocks, pieces = ik.unpack_plan(half, cols, scheme)
    assert pieces % 4 == 0 and pieces >= 4
    assert 1 <= blocks <= ik.UNPACK_BLOCKS_PER_SM * N_SMS
    if blocks < ik.UNPACK_BLOCKS_PER_SM * N_SMS:
        assert pieces == 4
    walk = ik.unpack_walk(half, cols, scheme)
    assert walk.shape == (blocks * ik.UNPACK_THREADS, pieces)
    got = walk[walk >= 0]
    assert torch.equal(torch.sort(got).values,
                       torch.arange(half * cols // 16))


def test_unpack_plan_at_the_tools_shape():
    """(512, 4096): 131,072 pieces, 256 blocks of 128 threads with 64 bytes
    each, one round; eyedot 1,024 tiles, a warp each."""
    for scheme in ik.UNPACK_SCHEMES:
        assert ik.unpack_plan(512, 4096, scheme) == (256, 4)


@pytest.mark.parametrize("variant", ik.UNPACK_VARIANTS)
@pytest.mark.parametrize("scheme", ik.UNPACK_SCHEMES)
def test_unpack_launcher_hands_the_kernel_its_plan(bound, scheme, variant):
    """The word-wide kernels get unpack_plan's blocks and rounds, counted
    under the scheme; the bytewise form its old arguments, counted
    "{scheme} bytewise"; one device kernel either way."""
    packed = torch.zeros(48, 272, dtype=torch.int8)
    op = K21
    before = (op.launches, op.device_launches, dict(op.variants))
    out = ik._launch_unpack(op, packed, scheme, 3, variant)
    assert out.shape == (96, 272) and out.dtype == torch.int8
    ((lib, fn, a),) = bound
    assert lib == "int4_probe" and a[2:5] == (
        ik.UNPACK_SCHEMES.index(scheme), 48, 272)
    if variant is None:
        blocks, pieces = ik.unpack_plan(48, 272, scheme)
        assert fn == "acai_int4_unpack"
        assert a[5:] == (blocks, pieces // 4, 3, 0)
        key = scheme
    else:
        assert fn == "acai_int4_unpack_bytewise" and a[5:] == (3, 0)
        key = f"{scheme} bytewise"
    assert op.launches - before[0] == 1
    assert op.device_launches - before[1] == 1
    assert op.variants[key] == before[2].get(key, 0) + 1


@pytest.mark.parametrize("variant", ik.UNPACK_VARIANTS)
def test_unpack_variants_run_the_twin_on_the_cpu(variant):
    """Both forms run the exact twin on CPU tensors, nothing built; an
    unknown variant is refused before it runs."""
    packed = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    want = torch.cat(ik.unpack_bytes(packed), 0)
    for scheme in ik.UNPACK_SCHEMES:
        assert torch.equal(K21(packed, scheme, 2, variant=variant), want)
    for bad in ("wide", "two_pass", "atomic"):
        with pytest.raises(ValueError, match="unknown variant"):
            K21(packed, "i32", variant=bad)


# ---------------------------------------------------------------------------
# K21: numpy models of the word arithmetic (csrc/int4_probe.cu unpack_wide,
# unpack_eyedot_mma_kernel)
# ---------------------------------------------------------------------------

U32 = np.uint32


def _prmt(a, b, sel):
    """PTX ``prmt.b32`` (default mode) on uint32 arrays: result byte k is
    byte (sel nibble k) & 7 of {b, a}, replaced by its sign bit replicated
    where the nibble's top bit is set."""
    a, b = np.asarray(a, U32), np.asarray(b, U32)
    src = [(a >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
          [(b >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, U32)
    for k in range(4):
        nib = (sel >> (4 * k)) & 0xF
        byte = src[nib & 7]
        if nib & 8:
            byte = np.where(byte & U32(0x80), U32(0xFF), U32(0))
        out |= byte.astype(U32) << U32(8 * k)
    return out


def _gather_low_bytes(r0, r1, r2, r3):
    return _prmt(_prmt(r0, r1, 0x0040), _prmt(r2, r3, 0x0040), 0x5410)


MAGIC = np.float32(12582912.0)


def _floor_unpack(i):
    """fp32 floor unpack of int32 values i (b): lo / hi in the low byte of
    a word, as ``floor_unpack(f32_minus8(i))``."""
    v8 = (np.asarray(i, np.int32) + np.int32(0x4B400000)).view(np.float32) \
        - np.float32(12582920.0)
    fh = np.floor(v8 * np.float32(0.0625) + np.float32(0.5))
    fl = np.float32(-16.0) * fh + v8
    return (fl + MAGIC).view(U32), (fh + MAGIC).view(U32)


def _vsub4(a, b):
    out = np.zeros_like(a)
    for k in range(4):
        d = ((a >> U32(8 * k)) - (b >> U32(8 * k))) & U32(0xFF)
        out |= d << U32(8 * k)
    return out


def _i16_half(h, lo):
    h = h.astype(np.uint32)
    if lo:
        return (((h & 0x0F0F) + 0x7878) & 0xFFFF) ^ 0x8080
    return ((((h >> 4) & 0x0F0F) + 0x7878) & 0xFFFF) ^ 0x7878


def _unpack_wide(b, scheme):
    """(lo, hi) words of packed words b by ``unpack_wide<S>``."""
    b = np.asarray(b, U32)
    if scheme == "i32":
        nl = (b & U32(0x0F0F0F0F)) ^ U32(0x08080808)
        nh = (b >> U32(4)) & U32(0x0F0F0F0F)
        return (nl + (nl & U32(0x08080808)) * U32(0x1E),
                nh + (nh & U32(0x08080808)) * U32(0x1E))
    if scheme == "i16":
        h0, h1 = b & U32(0xFFFF), b >> U32(16)
        return tuple((_i16_half(h1, lo) << U32(16)) | _i16_half(h0, lo)
                     for lo in (True, False))
    if scheme == "i8div":
        neg = (b >> U32(7)) & U32(0x01010101)
        hi = ((b >> U32(4)) & U32(0x0F0F0F0F)) + neg * U32(0xF0)
        return _vsub4(b, ((hi << U32(4)) & U32(0xF0F0F0F0))
                      | U32(0x08080808)), hi
    assert scheme == "f32"
    parts = [_floor_unpack(_prmt(b, 0, 0x8880 | 0x1111 * j).view(np.int32))
             for j in range(4)]
    return (_gather_low_bytes(*[p[0] for p in parts]),
            _gather_low_bytes(*[p[1] for p in parts]))


def _bytes_of(words):
    return np.asarray(words, U32).view(np.int8).reshape(-1)


@pytest.mark.parametrize("scheme", ["f32", "i32", "i16", "i8div"])
def test_word_arithmetic_equals_unpack_bytes(scheme):
    """Every byte value in every byte position of a word, the other three
    bytes drawn: the scheme's lo and hi words hold unpack_bytes' values."""
    rng = np.random.default_rng(21)
    words = rng.integers(0, 2 ** 32, (4, 256), dtype=np.uint64).astype(U32)
    for pos in range(4):
        words[pos] &= U32(~(0xFF << (8 * pos)) & 0xFFFFFFFF)
        words[pos] |= np.arange(256, dtype=U32) << U32(8 * pos)
    lo, hi = _unpack_wide(words.reshape(-1), scheme)
    want_lo, want_hi = ik.unpack_bytes(torch.from_numpy(_bytes_of(words)))
    assert np.array_equal(_bytes_of(lo), want_lo.numpy())
    assert np.array_equal(_bytes_of(hi), want_hi.numpy())


def _transpose4x4(a):
    t0, t1 = _prmt(a[0], a[1], 0x5140), _prmt(a[0], a[1], 0x7362)
    t2, t3 = _prmt(a[2], a[3], 0x5140), _prmt(a[2], a[3], 0x7362)
    return [_prmt(t0, t2, 0x5410), _prmt(t0, t2, 0x7632),
            _prmt(t1, t3, 0x5410), _prmt(t1, t3, 0x7632)]


def _signed_bytes(w, i):
    return ((np.asarray(w, U32) >> U32(8 * i)) & U32(0xFF)).astype(
        np.uint8).view(np.int8).astype(np.int32)


def _mma_m16n8k16(a0, a1, b):
    """``mma.sync`` m16n8k16 s8 x s8 -> s32 from the 32 lanes' registers by
    PTX's fragment layouts (lane = 4 groupID + threadID_in_group): A row g
    (a0) and g + 8 (a1), columns 4t + i; B rows 4t + i, column g; D rows g
    (d0, d1) and g + 8 (d2, d3), columns 2t, 2t + 1."""
    A = np.zeros((16, 16), np.int32)
    B = np.zeros((16, 8), np.int32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(4):
            A[g, 4 * t + i] = _signed_bytes(a0[lane], i)
            A[g + 8, 4 * t + i] = _signed_bytes(a1[lane], i)
            B[4 * t + i, g] = _signed_bytes(b[lane], i)
    D = A @ B
    return np.array([[D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                      D[g + 8, 2 * t + 1]]
                     for g, t in (divmod(lane, 4) for lane in range(32))])


def _eyedot_tile(tile):
    """One warp's unpack of a packed (16, 16 groups) tile by
    ``unpack_eyedot_mma_kernel``: every lane's loads, transpose, identity
    products, floor unpack and stores; returns the (32, 16 groups) output
    rows it writes (lo then hi) and how often each byte was written."""
    groups = tile.shape[1] // 16
    words = np.zeros((32, 4, 4), U32)  # lane, row i, word v
    a0, a1 = np.zeros(32, U32), np.zeros(32, U32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(4):
            a0[lane] |= U32(int(g == 4 * t + i) << (8 * i))
            a1[lane] |= U32(int(g + 8 == 4 * t + i) << (8 * i))
            gg = 4 * (g % 2) + g // 2  # the column group lane (g, t) loads
            if gg < groups:
                row = tile[4 * t + i, 16 * gg:16 * gg + 16]
                words[lane, i] = row.view(U32)
    b = np.stack([np.stack(_transpose4x4([words[:, i, v] for i in range(4)]),
                           1) for v in range(4)], 1)  # lane, v, j
    out = np.zeros((32, tile.shape[1]), np.int8)
    seen = np.zeros((32, tile.shape[1]), np.int32)
    lo = np.zeros((32, 4, 4), U32)  # lane, k, v
    hi = np.zeros((32, 4, 4), U32)
    for v in range(4):
        parts = [_floor_unpack(_mma_m16n8k16(a0, a1, b[:, v, j]))
                 for j in range(4)]  # j: (l, h), each (32, 4 k)
        for k in range(4):
            lo[:, k, v] = _gather_low_bytes(*[p[0][:, k] for p in parts])
            hi[:, k, v] = _gather_low_bytes(*[p[1][:, k] for p in parts])
    for lane in range(32):
        g, t = divmod(lane, 4)
        for k in range(4):
            if t + 4 * (k % 2) >= groups:
                continue
            row, col = g + 8 * (k // 2), 16 * t + 64 * (k % 2)
            for half, w in ((0, lo), (16, hi)):
                out[half + row, col:col + 16] = w[lane, k].view(np.int8)
                seen[half + row, col:col + 16] += 1
    return out, seen


@pytest.mark.parametrize("groups", [8, 3, 1])
def test_eyedot_fragments_equal_unpack_bytes(groups):
    """A warp's tile through the transposed B registers, the identity A
    fragment and the accumulators' layout: every output byte written once
    and equal to unpack_bytes, lo rows then hi rows, every byte value, at a
    full tile and at ragged right edges of 3 and 1 groups of 16."""
    rng = np.random.default_rng(groups)
    tile = rng.integers(-128, 128, (16, 16 * groups)).astype(np.int8)
    tile.reshape(-1)[:256] = np.arange(-128, 128, dtype=np.int8)[
        rng.permutation(256)][:min(256, tile.size)]
    out, seen = _eyedot_tile(tile)
    lo, hi = ik.unpack_bytes(torch.from_numpy(tile))
    assert np.array_equal(seen, np.ones_like(seen))
    assert np.array_equal(out, torch.cat([lo, hi], 0).numpy())
