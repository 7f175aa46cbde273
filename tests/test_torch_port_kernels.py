"""The port's hand-written CUDA kernels against their plain PyTorch twins.

These need an NVIDIA GPU with ``nvcc`` (they build ``csrc/`` at first use) and
skip elsewhere: run them on the card with

    python -m pytest tests/test_torch_port_kernels.py -m cuda -q

Small shapes, bf16 on the card; tolerance about one bf16 ulp of the output's
largest magnitude (the kernels sum in another order than the twins). The int8
kernels' integer parts are exact on both sides: the rows and scales they
append must equal the twin's bit for bit, their outputs agree within two bf16
ulps of the largest output.
"""

import math

import pytest
import torch

from acai_omr_tpu_torch.ops.decode_hd_kernel import (
    decode_attention_hd, decode_attention_hd_int8, self_attention_append_int8)
from acai_omr_tpu_torch.ops.decode_kernel import (decode_attention,
                                                  decode_attention_int8,
                                                  quantize_rows)
from acai_omr_tpu_torch.ops.encoder_stack_kernel import (encoder_attention,
                                                         encoder_stack_fused)
from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS, linear_bias_act
from acai_omr_tpu_torch.ops.quant_linear_kernel import (
    pack_k4, pack_k8_int4, quant4_linear_bias_act, quant_linear_bias_act)

from _torch_port_threads import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, *shape, dev, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _close(a, b, rel=1e-2):
    tol = rel * max(1.0, b.float().abs().max().item())
    assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("m,k,n,act", [(5, 64, 128, "none"),
                                       (32, 256, 1024, "gelu_rounded"),
                                       (300, 512, 192, "gelu")])
def test_linear_bias_act(dev, m, k, n, act):
    g = torch.Generator(device=dev).manual_seed(0)
    x = _randn(g, m, k, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(k)) \
        .to(torch.bfloat16)
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    _close(linear_bias_act(x, w, b, act), linear_bias_act.plain(x, w, b, act))


@pytest.mark.parametrize("pos", [0, 7, 63])
def test_decode_attention_self_appends(dev, pos):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn(g, 4, 3 * 256, dev=dev)
    kc, vc = _randn(g, 4, 64, 256, dev=dev), _randn(g, 4, 64, 256, dev=dev)
    kp, vp = kc.clone(), vc.clone()
    _close(decode_attention(qkv, kc, vc, 4, pos=pos),
           decode_attention.plain(qkv, kp, vp, 4, pos=pos))
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


def test_decode_attention_cross(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    q = _randn(g, 3, 256, dev=dev)
    mk, mv = _randn(g, 3, 48, 256, dev=dev), _randn(g, 3, 48, 256, dev=dev)
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 5, 30], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    _close(decode_attention(q, mk, mv, 4, bias=bias),
           decode_attention.plain(q, mk, mv, 4, bias=bias))


def test_decode_attention_cross_grouped(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    q = _randn(g, 6, 256, dev=dev)
    mk, mv = _randn(g, 2, 48, 256, dev=dev), _randn(g, 2, 48, 256, dev=dev)
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 17], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    out = decode_attention(q, mk, mv, 4, bias=bias, mem_group=3)
    _close(out, decode_attention.plain(q, mk, mv, 4, bias=bias, mem_group=3))
    rep = torch.arange(2, device=dev).repeat_interleave(3)
    assert torch.equal(out, decode_attention(
        q, mk[rep].contiguous(), mv[rep].contiguous(), 4,
        bias=bias[rep].contiguous()))


def _k2_case(dev, mode, dh, heads=4, t=300, pos=200, seed=6):
    """Inputs of one K2 call: self mode (appends at pos), cross over ragged
    memory, or grouped memory (G rows a memory row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    e = heads * dh
    if mode == "self":
        b, grp = 3, 1
        q = _randn(g, b, 3 * e, dev=dev)
        kw = {"pos": pos}
    else:
        grp = {"cross": 1, "grouped3": 3, "grouped8": 8}[mode]
        b = 2 * grp if grp > 1 else 3
        q = _randn(g, b, e, dev=dev)
        lens = torch.tensor([t, t // 3, 17][: b // grp], device=dev)
        valid = torch.arange(t, device=dev)[None] < lens[:, None]
        kw = {"bias": torch.where(valid, 0.0, -1e9).float().contiguous(),
              "mem_group": grp}
    kc, vc = (_randn(g, b // grp, t, e, dev=dev) for _ in range(2))
    return q, kc, vc, heads, kw


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["self", "cross", "grouped3", "grouped8"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_decode_attention_cluster_splits(dev, split, mode, dh):
    """The cluster kernel at splits 1, 2, 4, 8 against the twin (the
    appended k / v equal to the twin's), two runs bit-equal, one launch
    counted as split{s}; the simt kernel still agrees."""
    q, kc, vc, heads, kw = _k2_case(dev, mode, dh)
    kp, vp = kc.clone(), vc.clone()
    decode_attention.launches, decode_attention.variants = 0, {}
    out = decode_attention(q, kc, vc, heads, variant=f"split{split}", **kw)
    ref = decode_attention.plain(q, kp, vp, heads, **kw)
    _close(out, ref)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    assert torch.equal(out, decode_attention(q, kc, vc, heads,
                                             variant=f"split{split}", **kw))
    assert decode_attention.variants == {f"split{split}": 2}
    _close(decode_attention(q, kc, vc, heads, variant="simt", **kw), ref)
    _close(decode_attention(q, kc, vc, heads, **kw), ref)


@pytest.mark.parametrize("pos", [0, 1, 64, 255])
def test_decode_attention_cluster_ignores_keys_past_pos(dev, pos):
    """Keys at and past pos (stale or never written: here NaN) change no
    bit of the output, at every split."""
    q, kc, vc, heads, _ = _k2_case(dev, "self", 64, t=256, pos=pos)
    for split in (1, 4, 8):
        kf, vf, kn, vn = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        kn[:, pos:], vn[:, pos:] = float("nan"), float("nan")
        v = f"split{split}"
        out = decode_attention(q, kf, vf, heads, pos=pos, variant=v)
        assert torch.equal(decode_attention(q, kn, vn, heads, pos=pos,
                                            variant=v), out)
        assert torch.equal(kn[:, pos], kf[:, pos])
        _close(out, decode_attention.plain(q, kc.clone(), vc.clone(), heads,
                                           pos=pos))


def test_decode_attention_cluster_long_and_wide_groups(dev):
    """A range longer than the ring (2,048 keys a block: tiles streamed
    through it) and a group of 12 rows (two clusters of 8 queries)."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = _randn(g, 2, 3 * 256, dev=dev)
    kc, vc = (_randn(g, 2, 4096, 256, dev=dev) for _ in range(2))
    _close(decode_attention(q, kc.clone(), vc.clone(), 4, pos=4000,
                            variant="split2"),
           decode_attention.plain(q, kc.clone(), vc.clone(), 4, pos=4000))
    q = _randn(g, 24, 256, dev=dev)
    mk, mv = (_randn(g, 2, 96, 256, dev=dev) for _ in range(2))
    bias = torch.zeros(2, 96, device=dev)
    bias[1, 40:] = -1e9
    _close(decode_attention(q, mk, mv, 4, bias=bias, mem_group=12),
           decode_attention.plain(q, mk, mv, 4, bias=bias, mem_group=12))


@pytest.mark.parametrize("m,k,n,act", [(5, 128, 128, "none"),
                                       (32, 256, 1024, "gelu_rounded"),
                                       (70, 1024, 256, "none")])
def test_quant_linear_bias_act(dev, m, k, n, act):
    g = torch.Generator(device=dev).manual_seed(6)
    x = _randn(g, m, k, dev=dev) * 3
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3) \
        .to(torch.bfloat16).float()
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    w4 = pack_k4(w8)
    _close(quant_linear_bias_act(x, w4, s, b, act),
           quant_linear_bias_act.plain(x, w4, s, b, act), rel=2 * 2.0 ** -7)


@pytest.mark.parametrize("m,k,n,act", [(32, 1024, 3072, "none"),
                                       (32, 1024, 4096, "gelu_rounded"),
                                       (32, 4096, 1024, "none"),
                                       (1, 1024, 3072, "none"),
                                       (128, 4096, 1024, "none"),
                                       (128, 1024, 4096, "gelu_rounded")])
def test_quant4_linear_bias_act_equals_twin(dev, m, k, n, act):
    """K14 at the decode shapes (B = 32), one row and 128 rows (32 images x
    4 beams): equal to its plain twin bit for bit (exact integer product,
    the same divisions and roundings, no fused multiply-adds)."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = _randn(g, m, k, dev=dev) * 3
    q = torch.randint(-7, 8, (k, n), generator=g, device=dev)
    s = (torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3) \
        .to(torch.bfloat16).float()
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    wp = pack_k8_int4(q)
    out = quant4_linear_bias_act(x, wp, s, b, act)
    assert torch.equal(out, quant4_linear_bias_act.plain(x, wp, s, b, act))


def test_int8_caches_with_compute_dtype_weights_step(dev):
    """ACAI_W8A8_DECODE=0: one int8-cache step through K1 products and K6
    attention against the same step through the plain twins; the appended
    rows and scales equal bit for bit."""
    from acai_omr_tpu_torch.ops import decode_kernel
    g = torch.Generator(device=dev).manual_seed(17)
    l, b, t, m_len, e, h, f = 2, 4, 64, 48, 256, 4, 512
    f32 = lambda *sh: torch.randn(*sh, generator=g, device=dev) * 0.05
    blocks = {
        "self_attn": {"in_kernel": f32(l, e, 3 * e), "in_bias": f32(l, 3 * e),
                      "out": {"kernel": f32(l, e, e), "bias": f32(l, e)}},
        "cross_attn": {"in_kernel": f32(l, e, 3 * e),
                       "in_bias": f32(l, 3 * e),
                       "out": {"kernel": f32(l, e, e), "bias": f32(l, e)}},
        "linear1": {"kernel": f32(l, e, f), "bias": f32(l, f)},
        "linear2": {"kernel": f32(l, f, e), "bias": f32(l, e)},
        **{f"norm{i}": {"scale": 1 + f32(l, e), "bias": f32(l, e)}
           for i in (1, 2, 3)}}
    mono = decode_kernel.prepack({"blocks": blocks}, torch.bfloat16)
    assert "s_qkv" not in mono
    x = _randn(g, b, e, dev=dev)
    caches = []
    for length in (t, t, m_len, m_len):
        c, sc = _int8_cache(g, l * b, length, e, h, dev)
        caches += [c.view(l, b, length, e), sc.view(l, b, length, h)]
    kc, ks, vc, vs, mk, mks, mv, mvs = caches
    bias = torch.zeros((b, m_len), device=dev)
    bias[1, 30:] = -1e9
    twin = [a.clone() for a in (kc, vc, ks, vs)]
    run = lambda cs, plain: decode_kernel.decode_layers(
        mono, x, 9, cs[0], cs[1], mk, mv, bias, h, plain=plain,
        k_scale=cs[2], v_scale=cs[3], mem_k_scale=mks, mem_v_scale=mvs)
    before = decode_kernel.linear_bias_act.launches
    out = run((kc, vc, ks, vs), False)
    assert decode_kernel.linear_bias_act.launches - before == 6 * l
    _close(out, run(twin, True), rel=3e-2)
    for got, want in zip((kc, vc, ks, vs), twin):
        assert torch.equal(got, want)


def _int8_cache(g, rows, t, e, h, dev):
    c = torch.randint(-127, 128, (rows, t, e), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand(rows, t, h, generator=g, device=dev) * 3e-2 + 2e-3) \
        .to(torch.bfloat16)
    return c, s


@pytest.mark.parametrize("heads", [2, 4, 8])  # head dims 128, 64, 32
@pytest.mark.parametrize("pos", [0, 7, 63])
def test_decode_attention_int8_self_appends(dev, pos, heads):
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = _randn(g, 4, 3 * 256, dev=dev)
    (kc, ks), (vc, vs) = (_int8_cache(g, 4, 64, 256, heads, dev)
                          for _ in range(2))
    twin = [a.clone() for a in (kc, vc, ks, vs)]
    out = decode_attention_int8(qkv, kc, vc, ks, vs, heads, pos=pos)
    ref = decode_attention_int8.plain(qkv, *twin, heads, pos=pos)
    _close(out, ref, rel=2 * 2.0 ** -7)
    for got, want in zip((kc, vc, ks, vs), twin):
        assert torch.equal(got, want)
    kq, s = quantize_rows(qkv[:, 256:512].view(4, heads, -1), torch.bfloat16)
    assert torch.equal(kc[:, pos], kq.view(4, 256))
    assert torch.equal(ks[:, pos].float(), s)


@pytest.mark.parametrize("group", [1, 3])
def test_decode_attention_int8_cross(dev, group):
    g = torch.Generator(device=dev).manual_seed(8)
    q = _randn(g, 2 * group, 256, dev=dev)
    (mk, mks), (mv, mvs) = (_int8_cache(g, 2, 48, 256, 4, dev)
                            for _ in range(2))
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 5], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    out = decode_attention_int8(q, mk, mv, mks, mvs, 4, bias=bias,
                                mem_group=group)
    _close(out, decode_attention_int8.plain(q, mk, mv, mks, mvs, 4, bias=bias,
                                            mem_group=group),
           rel=2 * 2.0 ** -7)
    rep = torch.arange(2, device=dev).repeat_interleave(group)
    assert torch.equal(out, decode_attention_int8(
        q, *(a[rep].contiguous() for a in (mk, mv, mks, mvs)), 4,
        bias=bias[rep].contiguous()))


def _k6_case(dev, mode, dh, heads=4, t=300, pos=200, seed=9):
    """Inputs of one K6 call: self mode (appends at pos), cross over ragged
    memory, or grouped memory (G rows a memory row)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    e = heads * dh
    if mode == "self":
        b, grp = 3, 1
        q = _randn(g, b, 3 * e, dev=dev) * 2
        kw = {"pos": pos}
    else:
        grp = {"cross": 1, "grouped3": 3, "grouped8": 8}[mode]
        b = 2 * grp if grp > 1 else 3
        q = _randn(g, b, e, dev=dev) * 2
        lens = torch.tensor([t, t // 3, 17][: b // grp], device=dev)
        valid = torch.arange(t, device=dev)[None] < lens[:, None]
        kw = {"bias": torch.where(valid, 0.0, -1e9).float().contiguous(),
              "mem_group": grp}
    (kc, ks), (vc, vs) = (_int8_cache(g, b // grp, t, e, heads, dev)
                          for _ in range(2))
    return q, (kc, vc, ks, vs), heads, kw


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["self", "cross", "grouped3", "grouped8"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_decode_attention_int8_cluster_splits(dev, split, mode, dh):
    """K6's cluster kernel at splits 1, 2, 4, 8 against the twin: the
    appended rows and scales equal bit for bit, the output within two bf16
    ulps, two runs bit-equal, one launch counted as split{s}; the simt
    kernel still agrees."""
    q, caches, heads, kw = _k6_case(dev, mode, dh)
    twin = [a.clone() for a in caches]
    decode_attention_int8.launches, decode_attention_int8.variants = 0, {}
    out = decode_attention_int8(q, *caches, heads, variant=f"split{split}",
                                **kw)
    ref = decode_attention_int8.plain(q, *twin, heads, **kw)
    _close(out, ref, rel=2 * 2.0 ** -7)
    for got, want in zip(caches, twin):
        assert torch.equal(got, want)
    assert torch.equal(out, decode_attention_int8(
        q, *caches, heads, variant=f"split{split}", **kw))
    assert decode_attention_int8.variants == {f"split{split}": 2}
    assert decode_attention_int8.device_launches == 2
    _close(decode_attention_int8(q, *caches, heads, variant="simt", **kw),
           ref, rel=2 * 2.0 ** -7)
    _close(decode_attention_int8(q, *caches, heads, **kw), ref,
           rel=2 * 2.0 ** -7)


@pytest.mark.parametrize("pos", [0, 1, 64, 255])
def test_decode_attention_int8_cluster_ignores_keys_past_pos(dev, pos):
    """Keys at and past pos (stale or never written: here other int8 rows
    and NaN scales) change no bit of the output, at every split."""
    q, caches, heads, _ = _k6_case(dev, "self", 64, t=256, pos=pos)
    kc, vc, ks, vs = caches
    for split in (1, 4, 8):
        v = f"split{split}"
        clean = [a.clone() for a in caches]
        out = decode_attention_int8(q, *clean, heads, pos=pos, variant=v)
        dirty = [a.clone() for a in caches]
        dirty[0][:, pos:], dirty[1][:, pos:] = 127, -127
        dirty[2][:, pos:], dirty[3][:, pos:] = float("nan"), float("nan")
        assert torch.equal(decode_attention_int8(q, *dirty, heads, pos=pos,
                                                 variant=v), out)
        for a, b in zip(dirty, clean):
            assert torch.equal(a[:, pos], b[:, pos])


def test_decode_attention_int8_at_the_key_limit(dev):
    """The step's limit (MAX_INT8_KEYS keys): self mode at the last slot and
    grouped memory of that length, as the plan splits them."""
    from acai_omr_tpu_torch.ops.decode_kernel import MAX_INT8_KEYS
    t = MAX_INT8_KEYS
    for mode, pos in (("self", t - 1), ("grouped8", None)):
        q, caches, heads, kw = _k6_case(dev, mode, 64, t=t,
                                        pos=t - 1 if pos else 0)
        twin = [a.clone() for a in caches]
        out = decode_attention_int8(q, *caches, heads, **kw)
        _close(out, decode_attention_int8.plain(q, *twin, heads, **kw),
               rel=2 * 2.0 ** -7)
        for got, want in zip(caches, twin):
            assert torch.equal(got, want)


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n,act", [(32, 1024, 3072, "none"),
                                       (8, 1024, 4096, "gelu_rounded"),
                                       (32, 4096, 1024, "gelu"),
                                       (40, 2048, 256, "none"),
                                       (3, 1024, 1024, "partial")])
def test_quant4_linear_bias_act_cluster_splits(dev, split, m, k, n, act):
    """K14's cluster kernel at splits 1, 2, 4, 8 (where a block's range fits
    its shared memory), every act and a second row group (40 rows): equal to
    the twin bit for bit, one device kernel a call counted as split{s}; the
    simt form it replaced equal too, in three device kernels or two."""
    g = torch.Generator(device=dev).manual_seed(26)
    x = _randn(g, m, k, dev=dev) * 3
    q = torch.randint(-7, 8, (k, n), generator=g, device=dev)
    s = (torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3) \
        .to(torch.bfloat16).float()
    b = None if act == "partial" else _randn(g, n, dev=dev,
                                             dtype=torch.float32)
    wp = pack_k8_int4(q)
    want = quant4_linear_bias_act.plain(x, wp, s, b, act)
    if -(-k // (128 * split)) * 128 > 1024:
        with pytest.raises(ValueError, match="more than 1024"):
            quant4_linear_bias_act(x, wp, s, b, act, variant=f"split{split}")
        return
    quant4_linear_bias_act.launches = 0
    quant4_linear_bias_act.extra_launches = 0
    quant4_linear_bias_act.variants = {}
    out = quant4_linear_bias_act(x, wp, s, b, act, variant=f"split{split}")
    assert torch.equal(out, want)
    assert torch.equal(out, quant4_linear_bias_act(x, wp, s, b, act,
                                                   variant=f"split{split}"))
    used = min(split, k // 128)
    assert quant4_linear_bias_act.variants == {f"split{used}": 2}
    assert quant4_linear_bias_act.device_launches == 2
    assert torch.equal(quant4_linear_bias_act(x, wp, s, b, act,
                                              variant="simt"), want)
    assert quant4_linear_bias_act.extra_launches >= 1


@pytest.mark.parametrize("amax", [127.0, 63.5])
def test_quant4_linear_bias_act_rounds_halves_to_even(dev, amax):
    """Rows whose quotients x / scale are exact half-integers (the row max
    127 or 63.5: scale 1 or 0.5): K14's cluster kernel rounds them half to
    even, as the twin's division does (its quantizer takes the division
    wherever the reciprocal's product lies near a half)."""
    g = torch.Generator(device=dev).manual_seed(27)
    m, k, n = 8, 1024, 256
    rs = amax / 127.0
    halves = (torch.randint(-127, 127, (m, k), generator=g, device=dev)
              + 0.5) * rs
    halves[:, 0] = amax
    x = halves.to(torch.bfloat16)
    assert torch.equal(x.float(), halves)  # bf16 holds every value exactly
    q = torch.randint(-7, 8, (k, n), generator=g, device=dev)
    s = (torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3) \
        .to(torch.bfloat16).float()
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    wp = pack_k8_int4(q)
    for split in (1, 8):
        assert torch.equal(
            quant4_linear_bias_act(x, wp, s, b, variant=f"split{split}"),
            quant4_linear_bias_act.plain(x, wp, s, b))



def _k5_inputs(dev, m, k, n, act, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, m, k, dev=dev) * 3
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4) \
        .to(torch.bfloat16).float()
    b = None if act == "partial" else _randn(g, n, dev=dev,
                                             dtype=torch.float32)
    return x, pack_k4(w8), s, b


@pytest.mark.parametrize("act", ["none", "gelu", "gelu_rounded", "partial"])
@pytest.mark.parametrize("m", [4, 8, 16, 32, 70])
def test_quant_linear_bias_act_cluster_bits(dev, m, act):
    """K5's cluster kernel at every split of K = 1,024 at 64 and 128 columns
    a block, every act, rows of one row group and of three (70): equal to
    the twin bit for bit, one device kernel a call counted as split{s}
    (partials apart, as partial_split{s}), two runs bit-equal; the plan's
    launch and the three-launch form it replaced equal too."""
    x, w4, s, b = _k5_inputs(dev, m, 1024, 256, act, 36 + m)
    op = quant_linear_bias_act
    want = op.plain(x, w4, s, b, act)
    key = "partial_" if act == "partial" else ""
    for bn in (64, 128):
        for split in range(1, 9):
            v = f"bn{bn}_split{split}"
            op.launches, op.extra_launches, op.variants = 0, 0, {}
            out = op(x, w4, s, b, act, variant=v)
            assert torch.equal(out, want), v
            assert torch.equal(op(x, w4, s, b, act, variant=v), out), v
            used = -(-8 // -(-8 // split))  # whole ranges of 1,024 / 128
            assert op.variants == {f"{key}split{used}": 2}, v
            assert op.device_launches == 2, v
    assert torch.equal(op(x, w4, s, b, act), want)
    op.extra_launches = 0
    assert torch.equal(op(x, w4, s, b, act, variant="simt"), want)
    assert op.extra_launches >= 1


@pytest.mark.parametrize("m,k,n,act", [(32, 1024, 3072, "none"),
                                       (32, 1024, 4096, "gelu_rounded"),
                                       (32, 4096, 1024, "none"),
                                       (4, 1024, 1024, "none"),
                                       (16, 1024, 3072, "none"),
                                       (8, 1024, 1536, "none"),
                                       (8, 512, 1024, "partial"),
                                       (8, 2048, 1024, "partial"),
                                       (128, 4096, 1024, "gelu"),
                                       (8, 8192, 1024, "none")])
def test_quant_linear_bias_act_cluster_at_the_paths_shapes(dev, m, k, n, act):
    """K5 at the shapes of the W8A8 paths (B = 32; 4, 8 and 16 rows; the
    tp = 2 shards' partials), 128 rows and K at the cluster's limit, on the
    plan and at the other width: bit-equal to the twin, one device kernel a
    call."""
    x, w4, s, b = _k5_inputs(dev, m, k, n, act, 46)
    op = quant_linear_bias_act
    want = op.plain(x, w4, s, b, act)
    for v in (None, "bn64", "bn128"):
        op.launches, op.extra_launches, op.variants = 0, 0, {}
        assert torch.equal(op(x, w4, s, b, act, variant=v), want), v
        assert op.device_launches == op.launches == 1, v


@pytest.mark.parametrize("amax", [127.0, 63.5])
def test_quant_linear_bias_act_rounds_halves_to_even(dev, amax):
    """Rows whose quotients x / scale are exact half-integers: K5's cluster
    kernel rounds them half to even, as the twin's division does."""
    g = torch.Generator(device=dev).manual_seed(37)
    m, k, n = 8, 1024, 256
    rs = amax / 127.0
    halves = (torch.randint(-127, 127, (m, k), generator=g, device=dev)
              + 0.5) * rs
    halves[:, 0] = amax
    x = halves.to(torch.bfloat16)
    assert torch.equal(x.float(), halves)  # bf16 holds every value exactly
    w4 = pack_k4(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                               dtype=torch.int8))
    s = (torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4) \
        .to(torch.bfloat16).float()
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    for v in ("bn64_split1", "bn128_split8"):
        assert torch.equal(quant_linear_bias_act(x, w4, s, b, variant=v),
                           quant_linear_bias_act.plain(x, w4, s, b))


@pytest.mark.parametrize("m,k,n,act", [(8, 1024, 3072, "none"),
                                       (8, 1024, 1024, "none"),
                                       (8, 4096, 1024, "gelu_rounded"),
                                       (70, 2048, 256, "partial")])
def test_quant4_linear_bias_act_after_the_shared_template(dev, m, k, n, act):
    """K14, its kernel now one instantiation of the body it shares with
    K5: bit-equal to the twin at the paths' 8 rows and at three row groups,
    one device kernel a call counted as split{s}."""
    g = torch.Generator(device=dev).manual_seed(38)
    x = _randn(g, m, k, dev=dev) * 3
    q = torch.randint(-7, 8, (k, n), generator=g, device=dev)
    s = (torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3) \
        .to(torch.bfloat16).float()
    b = None if act == "partial" else _randn(g, n, dev=dev,
                                             dtype=torch.float32)
    wp = pack_k8_int4(q)
    op = quant4_linear_bias_act
    op.launches, op.extra_launches, op.variants = 0, 0, {}
    assert torch.equal(op(x, wp, s, b, act), op.plain(x, wp, s, b, act))
    assert op.device_launches == 1 and list(op.variants)[0].startswith(
        "split")

def test_encoder_attention_and_stack(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    b, t, e, h = 2, 128, 256, 4
    valid = torch.arange(t, device=dev)[None] < torch.tensor(
        [t, 37], device=dev)[:, None]
    qkv = _randn(g, b * t, 3 * e, dev=dev)
    _close(encoder_attention(qkv, valid, h),
           encoder_attention.plain(qkv, valid, h))
    f32 = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.05
    stacked = {
        "self_attn": {"in_kernel": f32(2, e, 3 * e), "in_bias": f32(2, 3 * e),
                      "out": {"kernel": f32(2, e, e), "bias": f32(2, e)}},
        "norm1": {"scale": 1 + f32(2, e), "bias": f32(2, e)},
        "linear1": {"kernel": f32(2, e, 512), "bias": f32(2, 512)},
        "linear2": {"kernel": f32(2, 512, e), "bias": f32(2, e)},
        "norm2": {"scale": 1 + f32(2, e), "bias": f32(2, e)},
    }
    x = _randn(g, b, t, e, dev=dev)
    out = encoder_stack_fused(stacked, x, valid, h)
    ref = encoder_stack_fused(stacked, x, valid, h, plain=True)
    assert torch.isfinite(out.float()).all()
    _close(out[valid], ref[valid], rel=3e-2)


def test_add_layernorm(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x, r = _randn(g, 37, 768, dev=dev), _randn(g, 37, 768, dev=dev)
    gamma = 1 + 0.1 * _randn(g, 768, dev=dev, dtype=torch.float32)
    beta = 0.1 * _randn(g, 768, dev=dev, dtype=torch.float32)
    _close(add_layernorm(x, r, gamma, beta, 1e-5),
           add_layernorm.plain(x, r, gamma, beta, 1e-5))


@pytest.mark.parametrize("rows", [1, 4, 32, 33, 16384])
@pytest.mark.parametrize("e", [512, 768, 1024, 320])
@pytest.mark.parametrize("variant", [None, "warps1", "warps4"])
def test_add_layernorm_vector_kernel(dev, rows, e, variant):
    """The vector kernel (the plan's warps a row, or each forced) in its
    three modes -- residual sum, residual sum writing z, LayerNorm alone --
    against the twin and against the scalar kernel it replaced, at the decode
    step's rows, a ragged block of rows, the encoder's rows, and a width
    whose last chunk is masked (E = 320); z equal to the twin's bit for
    bit. Launches counted under the variant taken."""
    from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm_plan
    g = torch.Generator(device=dev).manual_seed(rows + e)
    x, r = _randn(g, rows, e, dev=dev), _randn(g, rows, e, dev=dev)
    gamma = 1 + 0.1 * _randn(g, e, dev=dev, dtype=torch.float32)
    beta = 0.1 * _randn(g, e, dev=dev, dtype=torch.float32)
    taken = variant or add_layernorm_plan(rows, e)
    for second, save in ((r, False), (r, True), (None, False)):
        before = add_layernorm.variants.get(taken, 0)
        got = add_layernorm(x, second, gamma, beta, 1e-5, save,
                            variant=variant)
        assert add_layernorm.variants[taken] - before == 1
        want = add_layernorm.plain(x, second, gamma, beta, 1e-5, save)
        old = add_layernorm(x, second, gamma, beta, 1e-5, save,
                            variant="scalar")
        if save:
            assert torch.equal(got[1], want[1]) and torch.equal(old[1], want[1])
            got, want, old = got[0], want[0], old[0]
        _close(got, want)
        _close(got, old)


def test_add_layernorm_rejects_what_it_does_not_take(dev):
    x = torch.zeros(4, 1032, device=dev, dtype=torch.bfloat16)
    gamma, beta = torch.ones(1032, device=dev), torch.zeros(1032, device=dev)
    with pytest.raises(ValueError, match="E <= 1024"):
        add_layernorm(x, x, gamma, beta, 1e-5)
    with pytest.raises(ValueError, match="E % 8"):
        add_layernorm(x[:, :1020].contiguous(), None, gamma[:1020],
                      beta[:1020], 1e-5)
    with pytest.raises(ValueError, match="E % 32"):
        add_layernorm(x[:, :40].contiguous(), None, gamma[:40], beta[:40],
                      1e-5, variant="scalar")
    shifted = torch.zeros(4 * 496 + 1, device=dev,
                          dtype=torch.bfloat16)[1:].view(4, 496)
    with pytest.raises(ValueError, match="16-byte aligned"):
        add_layernorm(shifted, None, gamma[:496], beta[:496], 1e-5)
    with pytest.raises(ValueError, match="unknown variant"):
        add_layernorm(x[:, :512].contiguous(), None, gamma[:512], beta[:512],
                      1e-5, variant="warps3")


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 48, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(48, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="K % 32"):
        linear_bias_act(x, w, b, variant="wmma")
    with pytest.raises(ValueError, match="K % 8"):  # TMA's 16-byte rows
        linear_bias_act(x[:, :44].contiguous(), w[:44].contiguous(), b)
    with pytest.raises(ValueError, match="bfloat16"):
        linear_bias_act(x.float(), w, b)
    w4 = torch.zeros(12, 64, 4, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="K % 128"):
        quant_linear_bias_act(x, w4, b, b)
    wp = torch.zeros(6, 64, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="K % 128"):
        quant4_linear_bias_act(x, wp, b, b)
    with pytest.raises(ValueError, match="int32"):
        quant4_linear_bias_act(x, wp.to(torch.int8), b, b)
    kc = torch.zeros(2, 16, 192, device=dev, dtype=torch.int8)
    ks = torch.ones(2, 16, 2, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):  # head dim 96
        decode_attention_int8(torch.zeros(2, 576, device=dev,
                                          dtype=torch.bfloat16),
                              kc, kc.clone(), ks, ks.clone(), 2, pos=0)


# ---------------------------------------------------------------------------
# the training kernels: K7-K10 and the training modes of K1, K3, K4
# ---------------------------------------------------------------------------

def _drop(rate=0.25, t=64, stream=11):
    from acai_omr_tpu_torch.ops.dropout_kernel import DropSpec
    return DropSpec(rate, 0x1234, 0xBEEF, stream, t)


def test_dropout_kernel_equals_twin_bit_for_bit(dev):
    from acai_omr_tpu_torch.ops.dropout_kernel import dropout_apply
    g = torch.Generator(device=dev).manual_seed(10)
    x = _randn(g, 4 * 64, 512, dev=dev)
    d = _drop()
    out = dropout_apply(x, d)
    assert torch.equal(out, dropout_apply.plain(x, d))
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01


@pytest.mark.parametrize("act,save", [("none", False), ("gelu", False),
                                      ("gelu", True)])
def test_linear_bias_act_training_epilogues(dev, act, save):
    g = torch.Generator(device=dev).manual_seed(11)
    m, k, n = 256, 256, 512
    x = _randn(g, m, k, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(k)) \
        .to(torch.bfloat16)
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    d = _drop()
    out = linear_bias_act(x, w, b, act, d, save)
    ref = linear_bias_act.plain(x, w, b, act, d, save)
    if save:
        _close(out[1], ref[1])
        out, ref = out[0], ref[0]
    # the same elements are dropped; the kept ones agree to a bf16 ulp
    keep = ref != 0
    assert ((out != 0) ^ keep).float().mean().item() < 1e-3
    _close(torch.where(keep, out, 0), torch.where(out != 0, ref, 0))


def test_add_layernorm_training_modes(dev):
    g = torch.Generator(device=dev).manual_seed(12)
    x, r = _randn(g, 70, 256, dev=dev), _randn(g, 70, 256, dev=dev)
    gamma = 1 + 0.1 * _randn(g, 256, dev=dev, dtype=torch.float32)
    beta = 0.1 * _randn(g, 256, dev=dev, dtype=torch.float32)
    out, z = add_layernorm(x, r, gamma, beta, 1e-5, True)
    ref, z_ref = add_layernorm.plain(x, r, gamma, beta, 1e-5, True)
    assert torch.equal(z, z_ref)
    _close(out, ref)
    _close(add_layernorm(z, None, gamma, beta, 1e-5),
           add_layernorm.plain(z, None, gamma, beta, 1e-5))


def _attention_case(g, dev, cross, lens):
    b, tq, e = len(lens), 128, 256
    tk = 192 if cross else tq
    valid = torch.arange(tk, device=dev)[None] < torch.tensor(
        lens, device=dev)[:, None]
    if cross:
        q = _randn(g, b * tq, e, dev=dev)
        kv = _randn(g, b, tk, 2 * e, dev=dev)
    else:
        q, kv = _randn(g, b * tq, 3 * e, dev=dev), None
    return q, kv, valid, b, tq, tk, e


@pytest.mark.parametrize("cross,causal", [(False, True), (False, False),
                                          (True, False)])
def test_encoder_attention_causal_and_cross(dev, cross, causal, heads=4):
    g = torch.Generator(device=dev).manual_seed(13)
    # a full image, a ragged one, and one with no valid key at all
    q, kv, valid, *_ = _attention_case(g, dev, cross, [128, 37, 0])
    out = encoder_attention(q, valid, heads, causal, kv)
    assert torch.isfinite(out.float()).all()
    _close(out, encoder_attention.plain(q, valid, heads, causal, kv))


@pytest.mark.parametrize("cross,causal", [(False, True), (False, False),
                                          (True, False)])
def test_encoder_attention_head_dim_32(dev, cross, causal):
    """E = 256 over 8 heads: the MAE decoder's head dim."""
    test_encoder_attention_causal_and_cross(dev, cross, causal, heads=8)


@pytest.mark.parametrize("cross,causal", [(False, True), (False, False),
                                          (True, False)])
def test_attention_bwd(dev, cross, causal, heads=4):
    from acai_omr_tpu_torch.ops.attention_bwd_kernel import attention_bwd
    from acai_omr_tpu_torch.ops.encoder_stack_kernel import split_qkv
    g = torch.Generator(device=dev).manual_seed(14)
    q, kv, valid, b, tq, tk, e = _attention_case(g, dev, cross, [128, 37, 0])
    d_o = _randn(g, b, tq, e, dev=dev)
    q3, k3, v3 = split_qkv(q, kv, b)
    got = attention_bwd(q3, k3, v3, d_o, valid, heads, causal)
    again = attention_bwd(q3, k3, v3, d_o, valid, heads, causal)
    want = attention_bwd.plain(q3, k3, v3, d_o, valid, heads, causal)
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)  # fixed-order sums: equal bits
        _close(a, w, rel=2e-2)
    # strided destinations: one dqkv buffer (self) / a mem_kv-shaped one
    if not cross:
        dqkv = torch.empty_like(q).view(b, tq, 3 * e)
        attention_bwd(q3, k3, v3, d_o, valid, heads, causal,
                      *dqkv.split(e, dim=-1))
        assert torch.equal(dqkv, torch.cat(got, dim=-1))


@pytest.mark.parametrize("cross,causal", [(False, True), (False, False),
                                          (True, False)])
def test_attention_bwd_head_dim_32(dev, cross, causal):
    test_attention_bwd(dev, cross, causal, heads=8)


@pytest.mark.parametrize("heads", [4, 8])  # head dims 64, 32
@pytest.mark.parametrize("cross,causal", [(False, True), (False, False),
                                          (True, False)])
def test_attention_bwd_sm90_beside_wmma(dev, cross, causal, heads):
    """The Hopper kernels at 192 queries (a block of 128 rows and a half
    one) and 320 cross keys, under validity that is no prefix: scattered
    keys, key 0 masked (a causal row before the first valid key attends
    uniformly: nothing is skipped), no valid key, one valid key past the
    first tile; both designs against the twin, each launch counted under
    its variant, two runs of the new one bit-equal."""
    from acai_omr_tpu_torch.ops.attention_bwd_kernel import attention_bwd
    from acai_omr_tpu_torch.ops.encoder_stack_kernel import split_qkv
    g = torch.Generator(device=dev).manual_seed(21)
    b, tq, e = 4, 192, 256
    tk = 320 if cross else tq
    valid = torch.rand(b, tk, generator=g, device=dev) < 0.6
    valid[0, 0], valid[1, 0], valid[2] = True, False, False
    valid[3], valid[3, 70] = False, True
    q = _randn(g, b * tq, e if cross else 3 * e, dev=dev)
    kv = _randn(g, b, tk, 2 * e, dev=dev) if cross else None
    d_o = _randn(g, b, tq, e, dev=dev)
    q3, k3, v3 = split_qkv(q, kv, b)
    want = attention_bwd.plain(q3, k3, v3, d_o, valid, heads, causal)
    dh = e // heads
    for variant in ("sm90", "wmma"):
        key = f"{variant}_dh{dh}"
        before = attention_bwd.variants.get(key, 0)
        got = attention_bwd(q3, k3, v3, d_o, valid, heads, causal,
                            variant=variant)
        assert attention_bwd.variants[key] == before + 1
        for a, w in zip(got, want):
            assert torch.isfinite(a.float()).all()
            _close(a, w, rel=2e-2)
        if variant == "sm90":
            again = attention_bwd(q3, k3, v3, d_o, valid, heads, causal)
            assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("heads", [4, 8])  # head dims 64, 32
@pytest.mark.parametrize("cross,causal", [(False, True), (False, False),
                                          (True, False)])
def test_encoder_attention_sm90_beside_wmma(dev, cross, causal, heads):
    """K3's Hopper kernel at 192 queries (a block of 128 rows and a half
    one) and 320 cross keys, under validity that is no prefix: scattered
    keys, key 0 masked (a causal row before the first valid key attends
    uniformly: nothing is skipped), no valid key, one valid key past the
    first tile; both designs against the twin (1e-2), each launch counted
    under its variant, two runs of the new one bit-equal."""
    g = torch.Generator(device=dev).manual_seed(22)
    b, tq, e = 4, 192, 256
    tk = 320 if cross else tq
    valid = torch.rand(b, tk, generator=g, device=dev) < 0.6
    valid[0, 0], valid[1, 0], valid[2] = True, False, False
    valid[3], valid[3, 70] = False, True
    q = _randn(g, b * tq, e if cross else 3 * e, dev=dev)
    kv = _randn(g, b, tk, 2 * e, dev=dev) if cross else None
    want = encoder_attention.plain(q, valid, heads, causal, kv)
    dh = e // heads
    for variant in ("sm90", "wmma"):
        key = f"{variant}_dh{dh}"
        before = encoder_attention.variants.get(key, 0)
        got = encoder_attention(q, valid, heads, causal, kv, variant=variant)
        assert encoder_attention.variants[key] == before + 1
        assert torch.isfinite(got.float()).all()
        _close(got, want)
        if variant == "sm90":
            again = encoder_attention(q, valid, heads, causal, kv)
            assert torch.equal(got, again)


@pytest.mark.parametrize("dropping", [False, True])
@pytest.mark.parametrize("rows,e", [(640, 256)] + [
    (r, e) for e in (512, 768, 1024) for r in (1, 255, 257, 2048, 8192)])
def test_layernorm_bwd(dev, rows, e, dropping):
    """K8's one-pass kernel: dz within the bf16 tolerance of the twin, the
    dropped dz equal to K10's mask applied to it (bit for bit), dgamma /
    dbeta within 1e-3 of their largest value; two runs bit-equal; one device
    kernel a call, counted ``one_pass``; the three-launch form it replaced
    (``variant="three_pass"``) held to the twin too."""
    from acai_omr_tpu_torch.ops.dropout_kernel import dropout_plain
    from acai_omr_tpu_torch.ops.layernorm_bwd_kernel import layernorm_bwd
    g = torch.Generator(device=dev).manual_seed(15)
    gr, z = _randn(g, rows, e, dev=dev), _randn(g, rows, e, dev=dev)
    gamma = 1 + 0.1 * _randn(g, e, dev=dev, dtype=torch.float32)
    d = _drop() if dropping else None
    layernorm_bwd.launches, layernorm_bwd.extra_launches = 0, 0
    layernorm_bwd.variants = {}
    got = layernorm_bwd(gr, z, gamma, 1e-5, d)
    assert layernorm_bwd.device_launches == 1
    assert layernorm_bwd.variants == {"one_pass": 1}
    want = layernorm_bwd.plain(gr, z, gamma, 1e-5, d)
    _close(got[0], want[0])
    if dropping:
        assert torch.equal(got[1], dropout_plain(got[0], d))
        assert torch.equal(got[1] != 0, dropout_plain_keep(got[0], d))
    else:
        assert got[1] is got[0]
    _close(got[2], want[2], rel=1e-3)
    _close(got[3], want[3], rel=1e-3)
    again = layernorm_bwd(gr, z, gamma, 1e-5, d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    old = layernorm_bwd(gr, z, gamma, 1e-5, d, variant="three_pass")
    _close(old[0], want[0])
    _close(old[2], want[2], rel=1e-3)
    _close(old[3], want[3], rel=1e-3)


def dropout_plain_keep(dz, d):
    from acai_omr_tpu_torch.ops.dropout_kernel import keep_mask
    return keep_mask(d, dz.shape[0], dz.shape[1], dz.device) & (dz != 0)


@pytest.mark.parametrize("epilogue", ["none", "drop_mul", "add"])
def test_linear_dgrad(dev, epilogue):
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import linear_dgrad
    g = torch.Generator(device=dev).manual_seed(16)
    m, n, k = 256, 512, 256
    dy = _randn(g, m, n, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(n)) \
        .to(torch.bfloat16)
    other = _randn(g, m, k, dev=dev)
    kw = {"none": {}, "drop_mul": {"drop": _drop(), "mul": other},
          "add": {"add": other}}[epilogue]
    out, ref = linear_dgrad(dy, w, **kw), linear_dgrad.plain(dy, w, **kw)
    if epilogue == "drop_mul":
        assert ((out != 0) ^ (ref != 0)).float().mean().item() < 1e-3
        out = torch.where(ref != 0, out, 0)
        ref = torch.where(out != 0, ref, 0)
    _close(out, ref)


@pytest.mark.parametrize("epilogue", ["none", "drop", "mul", "drop_mul",
                                      "add"])
@pytest.mark.parametrize("m,n,k", [(200, 520, 776), (2049, 512, 768)])
def test_linear_dgrad_sm90(dev, m, n, k, epilogue):
    """dX on the Hopper core at ragged row counts and at K_out, N that are
    no multiples of 64 (TMA's zero fill), each epilogue; two runs bit-equal;
    K10's mask drops the same elements as the twin's and, where the wmma
    kernel takes the shape, as its: each output is 0 exactly where the mask
    drops or where the same call without dropout is 0."""
    from acai_omr_tpu_torch.ops.dropout_kernel import keep_mask
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import (dgrad_plan,
                                                          linear_dgrad)
    g = torch.Generator(device=dev).manual_seed(m + k)
    dy = _randn(g, m, n, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(n)) \
        .to(torch.bfloat16)
    other = _randn(g, m, k, dev=dev)
    d = _drop(t=100)
    kw = {"none": {}, "drop": {"drop": d}, "mul": {"mul": other},
          "drop_mul": {"drop": d, "mul": other},
          "add": {"add": other}}[epilogue]
    assert dgrad_plan(m, k, n)[0] == "sm90"
    before = linear_dgrad.variants.get("sm90", 0)
    out = linear_dgrad(dy, w, **kw)
    assert linear_dgrad.variants["sm90"] == before + 1
    assert torch.equal(out, linear_dgrad(dy, w, **kw))
    ref = linear_dgrad.plain(dy, w, **kw)
    if "drop" in kw:
        dropped = ~keep_mask(d, m, k, dev)
        bare = {k_: v for k_, v in kw.items() if k_ != "drop"}
        pairs = [(out, linear_dgrad(dy, w, **bare)),
                 (ref, linear_dgrad.plain(dy, w, **bare))]
        if n % 32 == 0 and k % 64 == 0:
            pairs.append((linear_dgrad(dy, w, **kw, variant="wmma"),
                          linear_dgrad(dy, w, **bare, variant="wmma")))
        for o, o_bare in pairs:
            assert torch.equal(o == 0, dropped | (o_bare == 0))
    _close(out, ref)


_SM90_ACTS = [("none", False, False), ("gelu", False, False),
              ("gelu", True, True), ("gelu_rounded", False, False),
              ("none", False, True), ("partial", False, False)]


@pytest.mark.parametrize("act,save,drop", _SM90_ACTS,
                         ids=["none", "gelu", "gelu_saves_drop",
                              "gelu_rounded", "drop", "partial"])
@pytest.mark.parametrize("m,k", [(1000, 768), (1000, 3072), (4000, 768)])
def test_linear_bias_act_sm90(dev, m, k, act, save, drop):
    """The Hopper core (TMA + wgmma) at a ragged M against the twin, each
    epilogue; BN = 128 at M = 1000, 256 at M = 4000 (gemm_plan); dropout's
    mask the same elements as the wmma kernel's, bit for bit."""
    from acai_omr_tpu_torch.ops.linear_kernel import gemm_plan
    n = 768
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = _randn(g, m, k, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(k)) \
        .to(torch.bfloat16)
    b = None if act == "partial" else _randn(g, n, dev=dev,
                                             dtype=torch.float32)
    d = _drop(t=100) if drop else None
    assert gemm_plan(m, n, k) == ("sm90", 128 if m == 1000 else 256)
    before = dict(linear_bias_act.variants)
    out = linear_bias_act(x, w, b, act, d, save)
    assert linear_bias_act.variants.get("sm90", 0) \
        == before.get("sm90", 0) + 1
    ref = linear_bias_act.plain(x, w, b, act, d, save)
    old = linear_bias_act(x, w, b, act, d, save, variant="wmma")
    if save:
        _close(out[1], ref[1])
        out, ref, old = out[0], ref[0], old[0]
    if drop:
        assert torch.equal(out == 0, old == 0)
        keep = ref != 0
        assert ((out != 0) ^ keep).float().mean().item() < 1e-3
        out, ref = torch.where(keep, out, 0), torch.where(out != 0, ref, 0)
    _close(out, ref, rel=1e-3 if act == "partial" else 1e-2)


_SKINNY_ACTS = [("none", False, False), ("gelu", False, False),
                ("gelu", True, True), ("gelu_rounded", False, False),
                ("none", False, True), ("partial", False, False)]


@pytest.mark.parametrize("act,save,drop", _SKINNY_ACTS,
                         ids=["none", "gelu", "gelu_saves_drop",
                              "gelu_rounded", "drop", "partial"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (8, 1024, 1536),
                                   (32, 4096, 1024), (128, 1024, 4096),
                                   (100, 256, 1024), (8, 1024, 256),
                                   (8, 72, 40), (100, 8192, 256)])
def test_linear_bias_act_skinny(dev, m, k, n, act, save, drop):
    """The decode rows' kernel (one launch, K split across a cluster) at
    1 / 8 / 32 / 100 / 128 rows (one and two consumer warpgroups), the
    decode and meshed widths (splits of 1-8, a ring that wraps) and a ragged
    shape, every epilogue: against the twin and the wmma kernel it replaces;
    dropout's mask the same elements as the wmma kernel's; two runs
    bit-equal; one device kernel a call."""
    from acai_omr_tpu_torch.ops.linear_kernel import gemm_plan
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = _randn(g, m, k, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(k)) \
        .to(torch.bfloat16)
    b = None if act == "partial" else _randn(g, n, dev=dev,
                                             dtype=torch.float32)
    d = _drop(t=4) if drop else None
    assert gemm_plan(m, n, k)[0] == "skinny"
    key = "skinny_partial" if act == "partial" else "skinny"
    before = linear_bias_act.variants.get(key, 0)
    dev_before = linear_bias_act.device_launches
    out = linear_bias_act(x, w, b, act, d, save)
    assert linear_bias_act.variants[key] == before + 1
    assert linear_bias_act.device_launches == dev_before + 1
    again = linear_bias_act(x, w, b, act, d, save)
    ref = linear_bias_act.plain(x, w, b, act, d, save)
    old = None
    if k % 32 == 0 and n % 64 == 0:  # the wmma kernel's shape rule
        old = linear_bias_act(x, w, b, act, d, save, variant="wmma")
    if save:
        assert all(torch.equal(a, c) for a, c in zip(out, again))
        _close(out[1], ref[1])
        out, ref = out[0], ref[0]
        old = None if old is None else old[0]
    else:
        assert torch.equal(out, again)
    rel = 1e-3 if act == "partial" else 1e-2
    if old is not None:
        if drop:
            assert torch.equal(out == 0, old == 0)
        _close(old, ref, rel=rel)
    if drop:
        keep = ref != 0
        assert ((out != 0) ^ keep).float().mean().item() < 1e-3
        out, ref = torch.where(keep, out, 0), torch.where(out != 0, ref, 0)
    _close(out, ref, rel=rel)


@pytest.mark.parametrize("plan", [(1, 128), (1, 256), (3, 128), (4, 256),
                                  None, "wmma"])
def test_linear_wgrad_sm90_plans(dev, plan):
    """dW on the core at a ragged row count, unsplit and split, BN 128 and
    256, written into a slice of a stacked gradient; two runs bit-equal. The
    wmma kernel (the yardstick) takes rows in multiples of 32."""
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import linear_wgrad
    r, k, n = 1024 if plan == "wmma" else 1000, 256, 768
    g = torch.Generator(device=dev).manual_seed(19)
    x, dy = _randn(g, r, k, dev=dev), _randn(g, r, n, dev=dev)
    stacked = torch.zeros(3, k, n, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(3, n, device=dev)
    dw, db = linear_wgrad(x, dy, stacked[1], bias[1], variant=plan)
    dw2, db2 = linear_wgrad(x, dy, variant=plan)
    want_w, want_b = linear_wgrad.plain(x, dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(stacked[1], dw)
    assert not stacked[0].any() and not stacked[2].any()
    _close(dw, want_w)
    _close(db, want_b, rel=1e-3)


@pytest.mark.parametrize("r,k,n", [(256, 128, 128), (2048, 256, 512)])
def test_linear_wgrad(dev, r, k, n):
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import linear_wgrad
    g = torch.Generator(device=dev).manual_seed(17)
    x, dy = _randn(g, r, k, dev=dev), _randn(g, r, n, dev=dev)
    stacked = torch.zeros(2, k, n, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(2, n, device=dev)
    dw, db = linear_wgrad(x, dy, stacked[1], bias[1])
    dw2, db2 = linear_wgrad(x, dy)
    want_w, want_b = linear_wgrad.plain(x, dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    assert torch.equal(stacked[1], dw) and not stacked[0].any()
    _close(dw, want_w)
    _close(db, want_b, rel=1e-3)


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_training_stacks_forward_and_backward(dev, stack, h=4):
    """The hand-written path against autograd through the plain twins, bf16,
    dropout on, one image with no valid token."""
    from acai_omr_tpu_torch.ops import train_layer_kernel as tlk
    from acai_omr_tpu_torch.ops import transformer
    gen = torch.Generator().manual_seed(18)
    n_l, b, t, m, e, f = 2, 3, 64, 128, 256, 512
    init = transformer.encoder_layer_init if stack == "encoder" \
        else transformer.decoder_layer_init
    stacked = transformer.stack_init(init, gen, n_l, e, f, device=dev)

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])

    x = torch.randn(b, t, e, generator=gen).to(dev, torch.bfloat16)
    mem = (0.5 * torch.randn(n_l, b, m, 2 * e, generator=gen)).to(
        dev, torch.bfloat16)
    sv = torch.arange(t, device=dev)[None] < torch.tensor(
        [t, 40, 0], device=dev)[:, None]
    mv = torch.arange(m, device=dev)[None] < torch.tensor(
        [m, 100, 70], device=dev)[:, None]
    weight = torch.linspace(-1, 1, e, device=dev)
    results = []
    for plain in (False, True, False):
        ins = [x.clone().requires_grad_(True),
               mem.clone().requires_grad_(True)]
        for v in leaves(stacked):
            v.grad = None
            v.requires_grad_(True)
        if stack == "encoder":
            out = tlk.encoder_stack_fused(stacked, ins[0], sv, h, 0.1, (3, 4),
                                          False, plain=plain)
        else:
            out = tlk.decoder_stack_fused(stacked, ins[0], ins[1], sv, mv, h,
                                          0.1, (3, 4), False, plain=plain)
        (out.float() * weight).sum().backward()
        grads = [ins[0].grad] + ([ins[1].grad] if stack == "decoder" else []) \
            + [v.grad.clone() for v in leaves(stacked)]
        results.append((out.detach(), grads))
    (out_k, g_k), (out_p, g_p), (out_k2, g_k2) = results
    assert torch.isfinite(out_k.float()).all()
    rel = lambda a, c: ((a.float() - c.float()).norm()
                        / c.float().norm().clamp_min(1e-6)).item()
    assert rel(out_k, out_p) < 2e-2
    for a, c, a2 in zip(g_k, g_p, g_k2):
        assert torch.equal(a, a2)
        assert torch.isfinite(a.float()).all()
        assert rel(a, c) < 5e-2


def test_training_stack_head_dim_32(dev):
    """An encoder stack of 8 heads over E = 256 (head dim 32, as the MAE
    decoder's blocks): K3 and K7 at that head dim inside the stack."""
    test_training_stacks_forward_and_backward(dev, "encoder", h=8)


def _hd_bias(rows, t, dev, lengths):
    valid = torch.arange(t, device=dev)[None] < torch.tensor(
        lengths, device=dev)[:, None]
    return torch.where(valid, 0.0, -1e9).float().contiguous()


@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("t,n_keys", [(40, None), (300, 123), (1536, 1536)])
def test_decode_attention_hd(dev, dh, t, n_keys):
    g = torch.Generator(device=dev).manual_seed(21)
    q = _randn(g, 3, 4, dh, dev=dev)
    kT, vT = _randn(g, 3, 4, dh, t, dev=dev), _randn(g, 3, 4, dh, t, dev=dev)
    bias = _hd_bias(3, t, dev, [t, t // 3, 7])
    for b in (None, bias):
        _close(decode_attention_hd(q, kT, vT, b, n_keys=n_keys),
               decode_attention_hd.plain(q, kT, vT, b, n_keys=n_keys))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [300, 512])
def test_decode_attention_hd_cluster_splits(dev, split, dh, t):
    """K11's cluster kernel at splits 1, 2, 4, 8, with and without the bias,
    tiles by TMA (T = 512) and copied by the block (T = 300: rows not
    16-byte aligned): against the twin, two runs bit-equal, split{s}
    counted, the simt kernel still agreeing; keys past n_keys (NaN) change
    no bit."""
    g = torch.Generator(device=dev).manual_seed(25)
    q = _randn(g, 3, 4, dh, dev=dev)
    kT, vT = _randn(g, 3, 4, dh, t, dev=dev), _randn(g, 3, 4, dh, t, dev=dev)
    v = f"split{split}"
    for b, n in ((None, 257), (_hd_bias(3, t, dev, [t, t // 3, 7]), None)):
        decode_attention_hd.launches, decode_attention_hd.variants = 0, {}
        out = decode_attention_hd(q, kT, vT, b, n_keys=n, variant=v)
        ref = decode_attention_hd.plain(q, kT, vT, b, n_keys=n)
        _close(out, ref)
        assert torch.equal(out, decode_attention_hd(q, kT, vT, b, n_keys=n,
                                                    variant=v))
        assert decode_attention_hd.variants == {v: 2}
        _close(decode_attention_hd(q, kT, vT, b, n_keys=n, variant="simt"),
               ref)
    kn, vn = kT.clone(), vT.clone()
    kn[..., 257:], vn[..., 257:] = float("nan"), float("nan")
    assert torch.equal(decode_attention_hd(q, kn, vn, None, n_keys=257,
                                           variant=v),
                       decode_attention_hd(q, kT, vT, None, n_keys=257,
                                           variant=v))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dh", [16, 64])
def test_decode_attention_hd_int8(dev, stacked, dh):
    g = torch.Generator(device=dev).manual_seed(22)
    lead = (3,) if stacked else ()
    q = _randn(g, 2, 4, dh, dev=dev)
    kT, vT = (torch.randint(-127, 128, lead + (2, 4, dh, 200), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(lead + (2, 4, 200), generator=g, device=dev) * 3e-2
              + 2e-3 for _ in range(2))
    kw = dict(layer=1) if stacked else {}
    for b in (None, _hd_bias(2, 200, dev, [200, 31])):
        _close(decode_attention_hd_int8(q, kT, vT, ks, vs, b, **kw),
               decode_attention_hd_int8.plain(q, kT, vT, ks, vs, b, **kw),
               rel=2 * 2.0 ** -7)



@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_decode_attention_hd_int8_cluster(dev, dh, t, stacked):
    """K12's cluster kernel at each head dim it is compiled for, per layer
    and over layer 1 of a stacked cache, T a multiple of 16 (TMA) and not
    (the tiles copied), ragged n_keys and bias, at splits 1, 2, 4, 8 and the
    plan: within two bf16 ulps of the twin, two runs bit-equal, counted as
    layer_split{s} / stacked_split{s}; the simt kernel agreeing too; keys
    past n_keys (other int8 values, NaN scales) change no bit."""
    g = torch.Generator(device=dev).manual_seed(28 + dh)
    lead = (3,) if stacked else ()
    q = _randn(g, 3, 4, dh, dev=dev)
    kT, vT = (torch.randint(-127, 128, lead + (3, 4, dh, t), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(lead + (3, 4, t), generator=g, device=dev) * 3e-2
              + 2e-3 for _ in range(2))
    kw = dict(layer=1) if stacked else {}
    op = decode_attention_hd_int8
    form = "stacked" if stacked else "layer"
    for b, n in ((None, 157), (_hd_bias(3, t, dev, [t, t // 3, 7]), None)):
        ref = op.plain(q, kT, vT, ks, vs, b, n_keys=n, **kw)
        for v in ("split1", "split2", "split4", "split8", None):
            op.launches, op.variants = 0, {}
            out = op(q, kT, vT, ks, vs, b, n_keys=n, variant=v, **kw)
            _close(out, ref, rel=2 * 2.0 ** -7)
            assert torch.equal(out, op(q, kT, vT, ks, vs, b, n_keys=n,
                                       variant=v, **kw)), v
            (key, count), = op.variants.items()
            assert key.startswith(f"{form}_split") and count == 2, v
        _close(op(q, kT, vT, ks, vs, b, n_keys=n, variant="simt", **kw), ref,
               rel=2 * 2.0 ** -7)
    kn, vn, ksn, vsn = (a.clone() for a in (kT, vT, ks, vs))
    kn[..., 157:], vn[..., 157:] = 127, -127
    ksn[..., 157:], vsn[..., 157:] = float("nan"), float("nan")
    for v in ("split1", "split8"):
        assert torch.equal(op(q, kn, vn, ksn, vsn, None, n_keys=157,
                              variant=v, **kw),
                           op(q, kT, vT, ks, vs, None, n_keys=157, variant=v,
                              **kw))


def test_decode_attention_hd_int8_refuses_head_dims_past_its_kernels(dev):
    """The cluster kernel is compiled for head dims 16-128 (powers of two):
    a launch at 48 is refused before anything runs (the per-op step asks
    ``hd_takes`` first and takes its plain path); the simt kernel takes it."""
    g = torch.Generator(device=dev).manual_seed(29)
    q = _randn(g, 2, 4, 48, dev=dev)
    k8 = torch.randint(-127, 128, (2, 4, 48, 64), generator=g, device=dev,
                       dtype=torch.int8)
    s = torch.rand(2, 4, 64, generator=g, device=dev) * 3e-2 + 2e-3
    with pytest.raises(ValueError, match="head dims"):
        decode_attention_hd_int8(q, k8, k8, s, s, None)
    _close(decode_attention_hd_int8(q, k8, k8, s, s, None, variant="simt"),
           decode_attention_hd_int8.plain(q, k8, k8, s, s, None),
           rel=2 * 2.0 ** -7)

@pytest.mark.parametrize("b", [1, 4, 32])
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("t,pos", [(300, 0), (300, 1), (300, 15), (300, 16),
                                   (300, 37), (300, 127), (300, 128),
                                   (300, 299), (512, 300), (512, 511)])
def test_self_attention_append_int8(dev, dh, t, pos, b):
    """K13's cluster kernel (T = 300: the tiles copied by the block; T = 512:
    by TMA) at every forced split and the plan's, and the simt kernel it
    replaced: output within two bf16 ulps of the twin, two runs bit-equal;
    the written column and its scales equal the twin's bit for bit, every
    other entry untouched; launches counted ``split{s}`` (pos 0: split1) or
    ``simt``. Other values in column pos and past it (NaN scales) change no
    bit of the output: no block reads them as keys."""
    g = torch.Generator(device=dev).manual_seed(23)
    q, kn, vn = (_randn(g, b, 4, dh, dev=dev) * 2 for _ in range(3))
    kc, vc = (torch.randint(-127, 128, (2, b, 4, dh, t), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(2, b, 4, t, generator=g, device=dev) * 3e-2 + 2e-3
              for _ in range(2))
    before = (kc, vc, ks, vs)
    twin = [a.clone() for a in before]
    op = self_attention_append_int8
    ref = op.plain(q, kn, vn, *twin, 1, pos)
    outs = {}
    for v in ("split1", "split2", "split4", "split8", None, "simt"):
        op.launches, op.variants = 0, {}
        runs = []
        for _ in range(2):
            caches = [a.clone() for a in before]
            runs.append(op(q, kn, vn, *caches, 1, pos, variant=v))
            for got, want, old in zip(caches, twin, before):
                assert torch.equal(got, want), v
                changed = (got != old).nonzero()
                assert bool((changed[:, 0] == 1).all()
                            and (changed[:, -1] == pos).all()), v
        _close(runs[0], ref, rel=2 * 2.0 ** -7)
        assert torch.equal(runs[0], runs[1]), v
        outs[v] = runs[0]
        (key, count), = op.variants.items()
        want_key = "simt" if v == "simt" else \
            "split1" if pos == 0 or v == "split1" else key
        assert count == 2 and key == want_key and (
            v == "simt" or key.startswith("split")), (v, key)
    kq, s = quantize_rows(kn)
    assert torch.equal(twin[0][1, ..., pos], kq)
    assert torch.equal(twin[2][1, ..., pos], s)
    dirty = [a.clone() for a in before]
    dirty[0][..., pos:], dirty[1][..., pos:] = 127, -127
    dirty[2][..., pos:], dirty[3][..., pos:] = float("nan"), float("nan")
    assert torch.equal(op(q, kn, vn, *dirty, 1, pos), outs[None])


def test_self_attention_append_int8_refuses_head_dims_past_its_kernels(dev):
    """K13's cluster kernel is compiled for head dims 16-128 (powers of
    two): a launch at 48 is refused before anything runs (the per-op step
    asks ``hd_takes`` first and takes its plain path); the simt kernel
    takes it."""
    g = torch.Generator(device=dev).manual_seed(30)
    q = _randn(g, 2, 4, 48, dev=dev)
    k8 = torch.randint(-127, 128, (1, 2, 4, 48, 64), generator=g, device=dev,
                       dtype=torch.int8)
    s = torch.rand(1, 2, 4, 64, generator=g, device=dev) * 3e-2 + 2e-3
    with pytest.raises(ValueError, match="head dims"):
        self_attention_append_int8(q, q, q, k8.clone(), k8.clone(), s.clone(),
                                   s.clone(), 0, 9)
    twin = [a.clone() for a in (k8, k8, s, s)]
    _close(self_attention_append_int8(q, q, q, k8.clone(), k8.clone(),
                                      s.clone(), s.clone(), 0, 9,
                                      variant="simt"),
           self_attention_append_int8.plain(q, q, q, *twin, 0, 9),
           rel=2 * 2.0 ** -7)


def test_hd_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(24)
    q = _randn(g, 2, 4, 16, dev=dev)
    kT = _randn(g, 2, 4, 16, 32, dev=dev)
    with pytest.raises(ValueError):
        decode_attention_hd(q, kT, kT.float(), None)
    with pytest.raises(ValueError):
        decode_attention_hd(q, kT, kT, None, n_keys=33)
    with pytest.raises(ValueError):
        decode_attention_hd(q, kT[..., :16], kT[..., :16].contiguous(), None)
    k8 = torch.zeros((2, 2, 4, 16, 32), dtype=torch.int8, device=dev)
    s = torch.ones((2, 2, 4, 32), device=dev)
    with pytest.raises(ValueError):
        self_attention_append_int8(q, q, q, k8, k8, s, s, 0, 32)
    with pytest.raises(ValueError):
        decode_attention_hd_int8(q, k8, k8, s, s, None, layer=2)


# ---------------------------------------------------------------------------
# K15 tp_allreduce and the partial products of the tensor-parallel step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("b", [3, 32, 128])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_tp_allreduce_equals_twin_bit_for_bit(dev, tp, b, out_dtype):
    """Every rank on one card: the one-card form (one ordinary launch,
    counted ``"local"``) and the exchange forced on the card (one
    cooperative launch, ``"coop"``) give the same bits as the twin on every
    rank, with the bias (fp32 partials, the monolith's mode, each rank its
    own bias) and without it (bf16 partials rounded each round, the per-op
    mode), over several calls through the same buffers."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    g = torch.Generator(device=dev).manual_seed(tp * b)
    group = TPGroup([dev] * tp)
    for call in range(3):
        parts = [_randn(g, b, 1024, dev=dev, dtype=torch.float32)
                 for _ in range(tp)]
        bias = [_randn(g, 1024, dev=dev, dtype=torch.float32)
                for _ in range(tp)]
        p16 = [p.to(torch.bfloat16) for p in parts]
        for form in ("local", "coop"):
            before = tp_allreduce.variants.get(form, 0)
            got = tp_allreduce(parts, group, bias, out_dtype,
                               variant=None if form == "local" else form)
            assert tp_allreduce.variants[form] - before == 1
            want = tp_allreduce.plain(parts, group, bias, out_dtype)
            for o, w in zip(got, want):
                assert o.dtype == out_dtype and torch.equal(o, w), \
                    (call, form)
            for o, w in zip(tp_allreduce(p16, group, variant=form),
                            tp_allreduce.plain(p16, group)):
                assert torch.equal(o, w), (call, form)


@pytest.mark.parametrize("tp,cards", [(2, 2), (4, 2), (4, 4)])
def test_tp_allreduce_across_cards(dev, tp, cards):
    """The multi-card form: the ranks spread over ``cards`` cards (the ranks
    of a card consecutive), one cooperative launch per card, the peers'
    slots and flags read through peer-mapped pointers at system scope. The
    same bits as the twin on every rank, in both modes, over 200 calls
    queued back to back with fresh inputs. Needs that many cards."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    devs = [torch.device("cuda", r * cards // tp) for r in range(tp)]
    group = TPGroup(devs)
    g = torch.Generator().manual_seed(tp * cards)
    calls = []
    for i in range(200):
        dt = torch.bfloat16 if i % 3 == 0 else torch.float32
        b = (4, 8, 32, 128)[i % 4]
        parts = [torch.randn(b, 1024, generator=g).to(dt).to(d) for d in devs]
        bias = torch.randn(1024, generator=g)  # replicated, as the step's
        bias = None if dt == torch.bfloat16 else [bias.to(d) for d in devs]
        calls.append((parts, bias, tp_allreduce(parts, group, bias,
                                                torch.bfloat16)))
    for d in range(cards):
        torch.cuda.synchronize(d)
    for i, (parts, bias, got) in enumerate(calls):
        want = tp_allreduce.plain(parts, group, bias, torch.bfloat16)
        for r, (o, w) in enumerate(zip(got, want)):
            assert o.device == devs[r] and torch.equal(o, w), (i, r)


def test_tp_allreduce_rejects_what_it_does_not_take(dev):
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    parts = [torch.zeros(4, 64, device=dev)] * 2
    with pytest.raises(ValueError, match="2 or 4 ranks"):
        tp_allreduce(parts * 4, TPGroup([dev] * 8))
    with pytest.raises(ValueError, match="must be"):
        tp_allreduce([parts[0], torch.zeros(4, 32, device=dev)],
                     TPGroup([dev] * 2))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tp_allreduce([p.half() for p in parts], TPGroup([dev] * 2))
    with pytest.raises(ValueError, match="E % 8"):
        tp_allreduce([torch.zeros(4, 36, device=dev)] * 2, TPGroup([dev] * 2))
    with pytest.raises(ValueError, match="unknown variant"):
        tp_allreduce(parts, TPGroup([dev] * 2), variant="ring")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("n", [8, 8 * 1000 + 8, 1024 * 2048 + 40,
                               3 * 10 ** 6 + 16])
def test_tp_allreduce_flat_gradient_buffers(dev, d, n):
    """K15 ``"local"`` on the data-parallel step's flat fp32 buffers, one
    ``(1, N)`` row a data shard, N a multiple of 8 but not of a block's
    elements (2,048 or 1,024 a block): one launch, every rank's row
    bit-equal to the twin, over fresh buffers each call; and in the step's
    form (``root_only``): rank 0's row alone, summed into rank 0's buffer
    in place, the other buffers untouched."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    g = torch.Generator(device=dev).manual_seed(d + n)
    group = TPGroup([dev] * d)
    for _ in range(2):
        bufs = [torch.randn(n, generator=g, device=dev).view(1, n)
                for _ in range(d)]
        before = tp_allreduce.variants.get("local", 0)
        got = tp_allreduce(bufs, group)
        assert tp_allreduce.variants["local"] - before == 1
        want = tp_allreduce.plain(bufs, group)
        for o, w in zip(got, want):
            assert o.shape == (1, n) and torch.equal(o, w)
        others = [b.clone() for b in bufs[1:]]
        got = tp_allreduce(bufs, group, root_only=True)
        assert tp_allreduce.variants["local"] - before == 2
        assert len(got) == 1 and got[0].data_ptr() == bufs[0].data_ptr()
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(bufs[1:], others))


def test_data_parallel_gradients_are_views_of_one_k15_sum(dev):
    """The sharded grad fn on a (2, 1) mesh on this card: one K15 launch,
    every gradient leaf a view into shard 0's buffer, which it summed into
    in place, and the loss and gradients those of one device on the same
    rows."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import tp_allreduce
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    from acai_omr_tpu_torch.parallel import trainer
    g = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn(64, 24, generator=g, device=dev),
              "b": {"c": torch.randn(24, generator=g, device=dev)}}
    x = torch.randn(8, 64, generator=g, device=dev)
    wt = torch.rand(8, generator=g, device=dev)

    def sum_fn(p, batch, seed):
        per_row = ((batch["x"] @ p["w"] + p["b"]["c"]) ** 2).sum(-1)
        return (per_row * batch["wt"]).sum(), batch["wt"].sum()

    mesh = mesh_lib.make_mesh(2, 1, [dev] * 2)
    before = tp_allreduce.variants.get("local", 0)
    loss, grads = trainer.make_sharded_grad_fn(sum_fn, mesh)(
        params, {"x": x, "wt": wt}, 0)
    assert tp_allreduce.variants["local"] - before == 1
    leaves = list(trainer.tree_flatten(grads).values())
    base = leaves[0].untyped_storage()
    assert all(v.untyped_storage().data_ptr() == base.data_ptr()
               for v in leaves)
    # shard 0's own buffer, summed in place: no (tp, N) output buffer
    assert base.nbytes() == 4 * -(-(64 * 24 + 24 + 2) // 8) * 8
    one = trainer.make_grad_fn(lambda p, b, s: (sum_fn(p, b, s)[0]
                                                / b["wt"].sum(), {}))
    want_loss, want = one(params, {"x": x, "wt": wt}, 0)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-6)
    for k, v in trainer.tree_flatten(want).items():
        torch.testing.assert_close(trainer.tree_flatten(grads)[k], v,
                                   rtol=1e-4, atol=1e-5)


def test_training_meshes_across_cards(dev):
    """Data-parallel and pipelined training over meshes whose shards lie on
    four distinct cards (K15's exchange, each shard's parameters copied to
    its card, the stages' hops card to card) against the same meshes with
    every shard on one card (K15's one-card form): losses and every
    gradient leaf within 1e-4 of the largest entry, and the gradients on
    the first card. Needs four cards."""
    from acai_omr_tpu_torch.models import omr_decoder, vitomr
    from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    from acai_omr_tpu_torch.parallel import pipeline, trainer
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    cards = [torch.device("cuda", i) for i in range(4)]
    one = [torch.device("cuda", 0)] * 4
    cfg = DecoderConfig(max_lmx_seq_len=64, vocab_size=33, num_layers=4,
                        hidden_dim=256, num_heads=4, mlp_dim=512, eos_idx=2,
                        dropout=0.0)
    params = omr_decoder.init_decoder_params(
        torch.Generator().manual_seed(0), cfg, device=cards[0])
    g = torch.Generator(device=cards[0]).manual_seed(1)
    b, t, m = 8, 64, 128
    seqs_in = torch.randint(3, 33, (b, t), generator=g, device=cards[0])
    lmx_valid = torch.arange(t, device=cards[0])[None] < torch.randint(
        t // 2, t + 1, (b, 1), generator=g, device=cards[0])
    seqs_tgt = torch.where(lmx_valid, torch.randint(
        3, 33, (b, t), generator=g, device=cards[0]), cfg.pad_idx)
    latent = torch.randn(b, m, 256, generator=g, device=cards[0])
    latent_valid = torch.arange(m, device=cards[0])[None] < torch.randint(
        m // 2, m + 1, (b, 1), generator=g, device=cards[0])

    def sum_fn(p, batch, seed):
        logits = omr_decoder.forward(
            p, cfg, batch["seqs_in"], batch["latent"], batch["lmx_valid"],
            batch["latent_valid"], compute_dtype=torch.bfloat16)
        return vitomr.omr_ce_loss(logits, batch["seqs_tgt"], cfg.pad_idx,
                                  reduction="sum")

    def close(got, want):
        (l1, g1), (l2, g2) = got, want
        torch.testing.assert_close(l1.to(l2.device), l2, rtol=1e-4, atol=0)
        f1, f2 = trainer.tree_flatten(g1), trainer.tree_flatten(g2)
        for k, v in f2.items():
            assert f1[k].device == cards[0], k
            scale = v.abs().max().clamp_min(1e-12)
            assert ((f1[k] - v).abs().max() / scale).item() <= 1e-4, k

    batch = {"seqs_in": seqs_in, "seqs_tgt": seqs_tgt,
             "lmx_valid": lmx_valid, "latent": latent,
             "latent_valid": latent_valid}
    for n in (2, 4):
        runs = [trainer.make_sharded_grad_fn(
            sum_fn, mesh_lib.make_mesh(n, 1, devs[:n]))(params, batch, 0)
            for devs in (cards, one)]
        close(*runs)
    pp_batch = (seqs_in, seqs_tgt, lmx_valid, latent, latent_valid)
    runs = []
    for devs in (cards, one):
        mesh = mesh_lib.make_mesh(2, 2, devs)
        pp = pipeline.stage_params(params, cfg, mesh, "model")
        kw = dict(stage_axis="model", data_axis="data", n_micro=2,
                  compute_dtype=torch.bfloat16)
        loss, grads = pipeline.make_pp_grad_fn(cfg, mesh, **kw)(pp, pp_batch)
        value = pipeline.make_pp_loss_fn(cfg, mesh, **kw)(pp, *pp_batch)
        torch.testing.assert_close(value.to(loss.device), loss, rtol=1e-5,
                                   atol=0)
        runs.append((loss, pipeline.unstage_params(grads)))
    close(*runs)


@pytest.mark.parametrize("n_model", [1, 2])
def test_meshed_decode_across_cards(dev, n_model):
    """Greedy meshed decode over 2 data shards x ``n_model`` model ranks
    with every shard on its own card: the tokens of the same mesh with
    every shard on cuda:0 (the rollouts of GRPO's mesh rule on a node of
    several cards). Needs four cards."""
    from acai_omr_tpu_torch.models import decode
    from acai_omr_tpu_torch.models.omr_decoder import (DecoderConfig,
                                                       init_decoder_params)
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    cfg = DecoderConfig(max_lmx_seq_len=64, vocab_size=33, num_layers=2,
                        hidden_dim=512, num_heads=8, mlp_dim=1024, eos_idx=2)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    latent = torch.randn(8, 48, 512, generator=g, device=dev)
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 20, 33, 48, 9, 48, 40, 12], device=dev)[:, None]
    seqs = [decode.sharded_generate(
        params, cfg, latent, valid, mesh_lib.make_mesh(2, n_model, devs),
        max_len=32, model_axis="model" if n_model > 1 else None)[0].cpu()
        for devs in ([f"cuda:{i}" for i in range(4)], ["cuda:0"] * 4)]
    assert seqs[0].shape == (8, 32) and torch.equal(seqs[0], seqs[1])


@pytest.mark.parametrize("m,k,n", [(8, 512, 1024), (32, 256, 1024)])
def test_partial_products(dev, m, k, n):
    """K1 and K5 ``partial``: the bare fp32 product (K5 dequantized), no
    bias, as a rank's share of a row-parallel product."""
    g = torch.Generator(device=dev).manual_seed(m + k)
    x = _randn(g, m, k, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(k)) \
        .to(torch.bfloat16)
    out = linear_bias_act(x, w, None, "partial")
    assert out.dtype == torch.float32
    _close(out, linear_bias_act.plain(x, w, None, "partial"), rel=1e-3)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4) \
        .to(torch.bfloat16).float()
    w4 = pack_k4(w8)
    q = quant_linear_bias_act(x, w4, s, None, "partial")
    assert q.dtype == torch.float32
    assert torch.equal(q, quant_linear_bias_act.plain(x, w4, s, None,
                                                      "partial"))


@pytest.mark.parametrize("tp,cache", [(2, "bf16"), (4, "bf16"), (2, "int8")])
def test_tensor_parallel_step_equals_twins(dev, tp, cache):
    """One step of ``decode_layers(tp_group=)`` (K1 partials, K2 or K6 per
    rank, K15, K4) against the same step through the twins, 3 K15 launches
    a layer. int8: layer 0's appended rows within one step of the twin's
    (K1's bf16 qkv may round an entry the other way) and its scales within
    one bf16 ulp."""
    from acai_omr_tpu_torch.models import decode
    from acai_omr_tpu_torch.models.omr_decoder import (DecoderConfig,
                                                       init_decoder_params)
    from acai_omr_tpu_torch.ops import decode_kernel
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    cfg = DecoderConfig(max_lmx_seq_len=64, vocab_size=33, num_layers=2,
                        hidden_dim=512, num_heads=8, mlp_dim=1024, eos_idx=2)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    b, m_len, t = 8, 48, 64
    latent = torch.randn(b, m_len, 512, generator=g, device=dev)
    valid = torch.arange(m_len, device=dev)[None] < torch.tensor(
        [48, 20, 33, 48, 9, 48, 40, 12], device=dev)[:, None]
    dt = torch.int8 if cache == "int8" else torch.bfloat16
    mesh = mesh_lib.make_mesh(1, tp, [dev] * tp)
    split = decode.prepare_tp_decode_params(params, cfg, mesh)[0]
    mem = decode.precompute_memory_kv(params, cfg, latent, valid,
                                      torch.bfloat16, dt)
    mems = [decode._shard_memory(mem, slice(None), r, tp, dev, "te")
            for r in range(tp)]
    monos = [decode._prepack_for(p, torch.bfloat16, dt, True) for p in split]
    states = [decode.init_decode_state(cfg, b, t, t, dt, dev,
                                       tp_devices=[dev] * tp)
              for _ in range(2)]
    for st in states:
        st.t = 5
    group = TPGroup([dev] * tp)
    before = tp_allreduce.launches
    out = decode.step_logits(split, cfg, monos, states[0], mems,
                             torch.bfloat16, tp_group=group)
    assert tp_allreduce.launches - before == 3 * cfg.num_layers
    ref = decode.step_logits(split, cfg, monos, states[1], mems,
                             torch.bfloat16, plain=True, tp_group=group)
    _close(out, ref, rel=3e-2)
    if cache == "int8":
        for r in range(tp):
            for a, w in ((states[0].k_cache[r], states[1].k_cache[r]),
                         (states[0].v_cache[r], states[1].v_cache[r])):
                assert (a[0].int() - w[0].int()).abs().max().item() <= 1
            for a, w in ((states[0].k_scale[r], states[1].k_scale[r]),
                         (states[0].v_scale[r], states[1].v_scale[r])):
                a, w = a[0].float(), w[0].float()
                assert ((a - w).abs() <= 2.0 ** -7 * w.abs()).all()


# ---------------------------------------------------------------------------
# the probes' kernels: K16 tile_gemm, K17 / K18 decode attention, K19
# smem_probe
# ---------------------------------------------------------------------------

from acai_omr_tpu_torch.ops import probe_kernels as pk  # noqa: E402


@pytest.mark.parametrize("tile", pk.SWEEP_TILES)
def test_tile_gemm_sweep_tiles(dev, tile):
    """The persistent kernel at a shape of few tiles and at one with more
    tiles than resident blocks (every block walks several), and the wmma
    kernel it replaced, within 1e-2 of the largest output (one bf16 ulp is
    0.4-0.8 % of it); two runs of the persistent kernel bit-equal (a block
    that wrote its staging before its last store had read it would differ
    only sometimes)."""
    g = torch.Generator(device=dev).manual_seed(30)
    for m, k, n in ((256, 384, 512), (4096, 384, 2048)):
        a, b = _randn(g, m, k, dev=dev), _randn(g, k, n, dev=dev)
        ref = pk.tile_gemm.plain(a, b, tile)
        out = pk.tile_gemm(a, b, tile)
        if (m, n) != (256, 512):
            assert pk.tile_gemm_blocks(m, n, tile) < (m // tile[0]) * (
                n // tile[1])
        _close(out, ref)
        _close(pk.tile_gemm(a, b, tile, variant="wmma"), ref)
        assert torch.equal(out, pk.tile_gemm(a, b, tile))
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", pk.LAYOUTS)
@pytest.mark.parametrize("tile", pk.FORM_TILES)
def test_tile_gemm_forms_fp32(dev, layout, tile):
    """fp32 out within 1e-5 of the largest output: the sums differ in order
    only. The persistent kernel at a few tiles and at more tiles than
    resident blocks, the wmma kernel beside it, two runs bit-equal."""
    g = torch.Generator(device=dev).manual_seed(31)
    for m, k, n in ((256, 512, 384), (2048, 512, 2048)):
        a = _randn(g, *((k, m) if layout == "tn" else (m, k)), dev=dev)
        b = _randn(g, *((n, k) if layout == "nt" else (k, n)), dev=dev)
        ref = pk.tile_gemm.plain(a, b, tile, layout, torch.float32)
        out = pk.tile_gemm(a, b, tile, layout, torch.float32)
        assert out.dtype == torch.float32 and out.shape == (m, n)
        _close(out, ref, 1e-5)
        _close(pk.tile_gemm(a, b, tile, layout, torch.float32,
                            variant="wmma"), ref, 1e-5)
        assert torch.equal(out, pk.tile_gemm(a, b, tile, layout,
                                             torch.float32))
    torch.cuda.synchronize()


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("b,t,dh", [(1, 128, 32), (4, 512, 64), (8, 256, 32),
                                    (32, 512, 64), (32, 1024, 64)])
def test_blockdiag_decode_attention(dev, cache, b, t, dh):
    """The cluster kernel at the plan's split and at every forced split, and
    the wmma kernel it replaced, within 4e-3 of the twin (outputs below 0.5
    where many keys are averaged; a weight rounded on the other side of a
    tie moves an output by one bf16 ulp), with a fifth of the keys masked at
    -1e9, row 0 attending only keys of the plan's last range and row 1 one
    key of it (there within one bf16 ulp of the row's largest output); two
    runs of each split bit-equal."""
    g = torch.Generator(device=dev).manual_seed(32)
    h = 16
    q = _randn(g, b, h, dh, dev=dev)
    bias = torch.where(torch.rand(b, t, generator=g, device=dev) < 0.2,
                       -1e9, 0.0).float()
    bias[:, 0] = 0.0
    lo, hi = pk.blockdiag_ranges(t, pk.blockdiag_plan(
        b, t, dh, cache == "int8")[1])[-1]
    bias[0] = -1e9
    bias[0, lo + 3:hi:5] = 0.0
    if b > 1:
        bias[1] = -1e9
        bias[1, hi - 1] = 0.0
    if cache == "int8":
        kT = torch.randint(-127, 128, (b, h, dh, t), generator=g, device=dev,
                           dtype=torch.int8)
        vT = torch.randint(-127, 128, (b, h, dh, t), generator=g, device=dev,
                           dtype=torch.int8)
        ks, vs = (torch.rand(b, h, t, generator=g, device=dev) * 2e-2 + 1e-3
                  for _ in range(2))
        args = (q, kT, vT, bias, ks, vs)
    else:
        args = (q, _randn(g, b, h, dh, t, dev=dev),
                _randn(g, b, h, dh, t, dev=dev), bias)
    ref = pk.blockdiag_decode_attention.plain(*args, bt=1).float()
    few = min(b, 2)  # the rows of few keys
    tol_few = 2.0 ** -7 * max(1.0, ref[:few].abs().max().item())
    for variant in [None, "wmma"] + [f"split{s}" for s in range(1, 9)]:
        bt = 4 if b % 4 == 0 else 1
        out = pk.blockdiag_decode_attention(*args, bt=bt, variant=variant)
        err = (out.float() - ref).abs().amax(dim=(1, 2))
        assert err[:few].max().item() <= max(4e-3, tol_few), variant
        if b > few:
            assert err[few:].max().item() <= 4e-3, variant
        if variant != "wmma":
            assert torch.equal(out, pk.blockdiag_decode_attention(
                *args, bt=bt, variant=variant)), variant
    torch.cuda.synchronize()


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("b,t", [(b, t) for b in (1, 8, 32)
                                 for t in (96, 100, 512, 1024)]
                         + [(1, 2056), (1, 3001)])
def test_batched_decode_attention(dev, b, t, dh):
    """One block per (row, head), 16-byte loads or one load a key (T = 100,
    3,001), and the warp kernel it replaced, within 4e-3 of the twin
    (outputs below 0.5 where tens of keys are averaged), a third of the keys
    masked at -1e9 (key 0 never), with and without the bias; the masked
    keys' values set to 7 change no bit; two runs bit-equal."""
    g = torch.Generator(device=dev).manual_seed(33)
    h = 16
    q, kT, vT = (_randn(g, *s, dev=dev) for s in ((b, h, dh), (b, h, dh, t),
                                                   (b, h, dh, t)))
    masked = torch.rand(b, t, generator=g, device=dev) < 1 / 3
    masked[:, 0] = False
    bias = torch.where(masked, -1e9, 0.0).float()
    bt = 4 if b % 4 == 0 else 1
    for bias_ in (bias, None):
        ref = pk.batched_decode_attention.plain(q, kT, vT, bias_, bt=bt)
        for variant in (None, "warp"):
            out = pk.batched_decode_attention(q, kT, vT, bias_, bt=bt,
                                              variant=variant)
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= 4e-3, (variant, err)
            if variant is None:
                assert torch.equal(out, pk.batched_decode_attention(
                    q, kT, vT, bias_, bt=bt))
    k7, v7 = (x.masked_fill(masked[:, None, None, :], 7.0) for x in (kT, vT))
    assert torch.equal(pk.batched_decode_attention(q, k7, v7, bias, bt=bt),
                       pk.batched_decode_attention(q, kT, vT, bias, bt=bt))
    route = pk.batched_route(t)
    assert any(v.endswith(route)
               for v in pk.batched_decode_attention.variants)
    torch.cuda.synchronize()


def test_smem_probe_up_to_the_card_limit(dev):
    """Row 0 bit for bit at 2 KB and at the card's limit; one KB past it the
    launch is refused with its CUDA error, and the next launch still runs."""
    optin = pk.smem_optin_bytes()
    x = torch.randn(8, 128, device=dev).to(torch.bfloat16)
    for n in (2048, optin // 256 * 256):
        assert torch.equal(pk.smem_probe(x, n)[0], x[0] * 2)
    with pytest.raises(pk.SmemRefused):
        pk.smem_probe(x, (optin // 1024 + 1) * 1024)
    assert torch.equal(pk.smem_probe(x, 4096)[0], x[0] * 2)
    torch.cuda.synchronize()


def test_smem_probe_warp_kernel_beside_simple(dev):
    """The warp kernel (a programmatic launch) and the kernel it replaced: row 0 bit for bit against the twin at sizes rising and falling
    (the attribute cache), a refusal past the limit leaves the next launch
    running, launches counted by form, a CUDA graph of programmatic launches
    keeps its programmatic edges, no local memory."""
    optin = pk.smem_optin_bytes()
    top = optin // 256 * 256
    x = torch.randn(8, 128, device=dev).to(torch.bfloat16)
    want = pk.smem_probe.plain(x, 2048)[0]
    pk.smem_probe.variants.clear()
    for n in (2048, top, 4096, top):
        for kw in ({}, {"variant": "simple"}):
            assert torch.equal(pk.smem_probe(x, n, **kw)[0], want), (n, kw)
        with pytest.raises(pk.SmemRefused):
            pk.smem_probe(x, top + 1024)
        with pytest.raises(pk.SmemRefused):
            pk.smem_probe(x, top + 1024, variant="simple")
    torch.cuda.synchronize()
    assert pk.smem_probe.variants[f"{top // 1024} KB"] == 2
    assert pk.smem_probe.variants[f"{top // 1024} KB simple"] == 2
    assert pk._SMEM_SET[x.get_device()] == top
    edges, prog = pk.smem_graph_edges(x, top, n=8)
    assert edges == 7 and prog in (0, 7)
    rows = pk.smem_probe.resources()
    assert {r["variant"] for r in rows} == {"", "simple"}
    assert all(r["local_bytes"] == 0 and r["blocks_per_sm"] == 1
               for r in rows), rows
    assert torch.equal(pk.smem_probe(x, top)[0], want)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the int4 and memory-stream probes' kernels: K20 int4_delivery_gemm, K21
# int4_unpack, K22 bulk_copy_ring, K23 clamped_chunk_sum, K24
# lane_stream_sum. K20-K22 exact; K23 / K24 fp32 sums within 1e-5 of the
# largest output (another order of the same sums), two runs bit-equal
# ---------------------------------------------------------------------------

from acai_omr_tpu_torch.ops import int4_probe_kernels as ik  # noqa: E402
from acai_omr_tpu_torch.ops import stream_probe_kernels as sk  # noqa: E402


def _int4(g, shape, dev, low=-8, high=8):
    return torch.randint(low, high, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("scheme", ik.GEMM_SCHEMES)
@pytest.mark.parametrize("bt,cin,cout", [(8, 256, 512), (8, 1024, 4096),
                                         (3, 512, 1024), (32, 1024, 512),
                                         (16, 4096, 1024)])
def test_int4_delivery_gemm(dev, scheme, bt, cin, cout):
    """The strip kernel at its plan's split, one device kernel a call, and
    at every split of the contraction across a cluster, exact; the atomic
    kernel it replaced exact too."""
    g = torch.Generator(device=dev).manual_seed(40 + bt)
    lo, hi = _int4(g, (cin // 2, cout), dev), _int4(g, (cin // 2, cout), dev)
    x = _int4(g, (bt, cin), dev, -127, 128)
    w = ik.scheme_weights(lo, hi, scheme)
    want = ik.int4_delivery_gemm.plain(x, w, scheme)
    op = ik.int4_delivery_gemm
    before = op.device_launches
    out = op(x, w, scheme)
    assert op.device_launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (bt, cout)
    assert torch.equal(out, want)
    for split in (1, 2, 4, 8):
        if cin % (64 * split) == 0:
            assert torch.equal(op(x, w, scheme, variant=f"split{split}"),
                               want), split
    assert torch.equal(op(x, w, scheme, variant="atomic"), want)


@pytest.mark.parametrize("scheme", ik.GEMM_SCHEMES)
def test_int4_delivery_gemm_extremes(dev, scheme):
    """-8 on both sides of the packing, rows of +-127: the largest sums;
    the strip kernel, split across a cluster of 2, and the atomic kernel."""
    lo = torch.full((128, 512), -8, dtype=torch.int8, device=dev)
    hi = torch.full((128, 512), 7, dtype=torch.int8, device=dev)
    hi[::2] = -8
    x = torch.full((8, 256), 127, dtype=torch.int8, device=dev)
    x[1::2] = -127
    w = ik.scheme_weights(lo, hi, scheme)
    want = ik.int4_delivery_gemm.plain(x, w, scheme)
    for variant in (None, "split2", "atomic"):
        assert torch.equal(ik.int4_delivery_gemm(x, w, scheme,
                                                 variant=variant), want)


@pytest.mark.parametrize("scheme", ik.UNPACK_SCHEMES)
def test_int4_unpack_every_byte(dev, scheme):
    """The word-wide kernel and the bytewise kernel it replaced, bit for bit
    at reps 1 and 3, every byte value."""
    g = torch.Generator(device=dev).manual_seed(41)
    packed = _int4(g, (512, 4096), dev, -128, 128)
    packed[0, :256] = torch.arange(-128, 128, device=dev).to(torch.int8)
    want = ik.int4_unpack.plain(packed, scheme)
    for reps in (1, 3):
        for variant in (None, "bytewise"):
            assert torch.equal(ik.int4_unpack(packed, scheme, reps,
                                              variant=variant), want), \
                (reps, variant)


@pytest.mark.parametrize("scheme", ik.UNPACK_SCHEMES)
@pytest.mark.parametrize("half,cols", [(16, 16), (16, 144), (48, 272),
                                       (4096, 4096)])
def test_int4_unpack_word_kernels_at_every_tail(dev, scheme, half, cols):
    """The word-wide kernels where a thread's four pieces pass the end,
    eyedot's tiles are ragged (cols % 128) and the grid takes more than one
    round (4096 x 4096), bit for bit, one device kernel a call."""
    g = torch.Generator(device=dev).manual_seed(half + cols)
    packed = _int4(g, (half, cols), dev, -128, 128)
    op = ik.int4_unpack
    before = op.device_launches
    out = op(packed, scheme, 2)
    assert op.device_launches == before + 1
    assert torch.equal(out, op.plain(packed, scheme))


def test_int4_unpack_reps_are_not_folded(dev):
    """The reps loop runs every rep: twice the reps take over 1.5x the
    time, for every scheme."""
    from acai_omr_tpu_torch.tools._probe import time_ms
    packed = _int4(torch.Generator(device=dev).manual_seed(42), (512, 4096),
                   dev, -128, 128)
    for scheme in ik.UNPACK_SCHEMES:
        t_n = time_ms(lambda: ik.int4_unpack(packed, scheme, 50), dev, 5)
        t_2n = time_ms(lambda: ik.int4_unpack(packed, scheme, 100), dev, 5)
        assert t_2n > 1.5 * t_n, (scheme, t_n, t_2n)


@pytest.mark.parametrize("frags", [1, 2, 4, 8, 16])
def test_bulk_copy_ring(dev, frags):
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(43)
    src = _randn(g, 48, 32 * blocks, sk.LANES, dev=dev)
    out = sk.bulk_copy_ring(src, 3, frags, blocks)
    torch.cuda.synchronize()
    assert torch.equal(out, sk.bulk_copy_ring.plain(src, 3, frags, blocks))


@pytest.mark.parametrize("steps,slots,rows", [(1, 2, 8), (2, 6, 16),
                                              (7, 4, 24)])
def test_bulk_copy_ring_short_streams(dev, steps, slots, rows):
    g = torch.Generator(device=dev).manual_seed(44)
    src = _randn(g, steps, rows * 5, sk.LANES, dev=dev)
    out = sk.bulk_copy_ring(src, slots, 2, 5)
    assert torch.equal(out, src[-1, :8, :128])


def test_stream_wrappers_refuse_what_the_kernels_do_not_take(dev):
    src = torch.zeros(2, 64, sk.LANES, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        sk.bulk_copy_ring(src, 8, 1, 1)  # 8 x 128 KB
    with pytest.raises(ValueError, match="16 bytes"):
        sk.bulk_copy_ring(src, 2, 3, 2)
    with pytest.raises(ValueError, match="slots"):
        sk.bulk_copy_ring(src, 9, 1, 8)
    x = torch.zeros(4, 64, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="int32"):
        sk.clamped_chunk_sum(x, torch.zeros(1, device=dev))
    with pytest.raises(ValueError, match="lanes"):
        sk.lane_stream_sum(torch.zeros(4, 64, 24, device=dev),
                           torch.zeros(1, 24, device=dev))


@pytest.fixture(scope="module")
def chunks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(45)
    return torch.randn(64, 4096, 1024, generator=g,
                       device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize("mode", sk.MODES)
@pytest.mark.parametrize("s", [-1, 0, 1, 31, 63, 70])
def test_clamped_chunk_sum(dev, chunks, mode, s):
    """The walk, one device kernel a call, two runs bit-equal; the grid
    kernel it replaced within the same tolerance."""
    s_dev = torch.tensor([s], dtype=torch.int32, device=dev)
    op = sk.clamped_chunk_sum
    before = op.device_launches
    out = op(chunks, s_dev, mode)
    assert op.device_launches == before + 1
    again = op(chunks, s_dev, mode)
    assert torch.equal(out, again)
    want = op.plain(chunks, s_dev, mode)
    _close(out, want, 1e-5)
    _close(op(chunks, s_dev, mode, variant="grid"), want, 1e-5)


@pytest.mark.parametrize("n,ch,e", [(4, 64, 128), (3, 100, 256),
                                    (5, 1, 384), (2, 4096, 128)])
def test_clamped_chunk_sum_ragged_tiles(dev, n, ch, e):
    """Chunk rows that are no whole number of tiles (TMA's zeros past them),
    a strip or a few, every s from -1 to n + 1, in both modes."""
    g = torch.Generator(device=dev).manual_seed(47)
    x = torch.randn(n, ch, e, generator=g, device=dev).to(torch.bfloat16)
    for mode in sk.MODES:
        for s in range(-1, n + 2):
            s_dev = torch.tensor([s], dtype=torch.int32, device=dev)
            want = sk.clamped_chunk_sum.plain(x, s_dev, mode)
            out = sk.clamped_chunk_sum(x, s_dev, mode)
            assert torch.equal(out, sk.clamped_chunk_sum(x, s_dev, mode))
            _close(out, want, 1e-5)


@pytest.mark.parametrize("lanes,blocks,t", [(16, 256, 512), (128, 256, 512),
                                            (4, 3, 1024), (256, 5, 8)])
def test_lane_stream_sum(dev, lanes, blocks, t):
    """One device kernel a call, two runs bit-equal, within 1e-5 of the
    twin; the two-pass form it replaced within the same tolerance."""
    g = torch.Generator(device=dev).manual_seed(46)
    x = torch.randn(blocks, t, lanes, generator=g, device=dev)
    c = torch.randn(1, lanes, generator=g, device=dev)
    op = sk.lane_stream_sum
    before = op.device_launches
    out = op(x, c)
    assert op.device_launches == before + 1
    assert torch.equal(out, op(x, c))
    want = op.plain(x, c)
    _close(out, want, 1e-5)
    _close(op(x, c, variant="two_pass"), want, 1e-5)


# ---------------------------------------------------------------------------
# the last probes' kernels: K25 head_logits, K26 batched_head_logits, K27
# resident_elementwise; the resource report (csrc/func_attrs.cuh)
# ---------------------------------------------------------------------------

import re  # noqa: E402
import subprocess  # noqa: E402

from acai_omr_tpu_torch.ops import _build  # noqa: E402
from acai_omr_tpu_torch.ops import head_logits_kernels as hk  # noqa: E402
from acai_omr_tpu_torch.ops import vpu_probe_kernels as vk  # noqa: E402
from acai_omr_tpu_torch.tools import mosaic_batched_attn_probe as mbp  # noqa: E402
from acai_omr_tpu_torch.tools import mosaic_head_access_probe as mhp  # noqa: E402
from acai_omr_tpu_torch.tools import vpu_probe as vpp  # noqa: E402


@pytest.mark.parametrize("form", hk.FORMS)
@pytest.mark.parametrize("t", [64, 320, 1024])
@pytest.mark.parametrize("h", [1, 12, 16])
def test_head_logits(dev, form, t, h):
    """The persistent kernel (T = 64 and 320: a 64-key edge tile) and the
    wmma kernel it replaced, fp32 out within 1e-5 of the largest output:
    exact products, sums in another order; two runs bit-equal."""
    q, k = mhp.make_inputs(t, h * hk.DH, dev)
    if form == "preshaped":
        q, k = (hk.as_heads(a, h).contiguous() for a in (q, k))
    ref = hk.head_logits.plain(q, k, form, h)
    out = hk.head_logits(q, k, form, h)
    _close(out, ref, 1e-5)
    assert torch.equal(out, hk.head_logits(q, k, form, h))
    _close(hk.head_logits(q, k, form, h, variant="wmma"), ref, 1e-5)
    torch.cuda.synchronize()


@pytest.mark.parametrize("int8", [False, True])
def test_batched_head_logits(dev, int8):
    """int8 bit for bit; fp32 within 1e-5 of the largest output; the
    transpose equal to the column sums bit for bit."""
    k, q = (torch.from_numpy(a).to(dev) for a in mbp.make_inputs(int8))
    got = hk.batched_head_logits(k, q, mbp.H)
    want = hk.batched_head_logits.plain(k, q, mbp.H)
    for g, w in zip(got, want):
        if int8:
            assert torch.equal(g, w)
        else:
            _close(g, w, 1e-5)
    assert torch.equal(got[2].t(), got[1])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bt,t,h", [(8, 128, 16), (2, 1024, 16), (3, 77, 4),
                                    (1, 1, 1), (4, 1000, 2), (1, 257, 16)])
def test_batched_head_logits_slab_chunks(dev, int8, bt, t, h):
    """The slab kernel in the plan's chunks (one at the tool's shape, up to
    four in fp32 at T = 1,024) and the kernel it replaced (``"shuffle"``):
    int8 bit for bit, fp32 within 1e-5 of the largest output; the transpose
    equal to the column sums bit for bit; two runs of the slab kernel
    bit-equal; one device kernel a call."""
    g = torch.Generator().manual_seed(bt * 1000 + t)
    e = h * hk.DH
    if int8:
        k = torch.randint(-127, 128, (bt, t, e), generator=g,
                          dtype=torch.int8)
        q = torch.randint(-127, 128, (bt, e), generator=g).float()
    else:
        k, q = torch.randn(bt, t, e, generator=g), torch.randn(bt, e,
                                                               generator=g)
    k, q = k.to(dev), q.to(dev)
    want = hk.batched_head_logits.plain(k, q, h)
    op = hk.batched_head_logits
    for variant in hk.BATCHED_VARIANTS:
        before = op.device_launches
        got = op(k, q, h, variant=variant)
        assert op.device_launches == before + 1
        for a, b in zip(got, want):
            if int8:
                assert torch.equal(a, b), variant
            else:
                _close(a, b, 1e-5)
        assert torch.equal(got[2].t(), got[1])
        if variant != "shuffle":
            again = op(k, q, h, variant=variant)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.cuda.synchronize()


@pytest.mark.parametrize("work,rows,cols", [
    (w, r, c) for w, shapes in vpp.SHAPES.items() for r, c in shapes])
def test_resident_elementwise(dev, work, rows, cols):
    """0, 1 and 8 passes against the twin, within 1e-5 of the largest
    output (fp32 in another order and, for exp, erf and rsqrt, CUDA's
    roundings)."""
    x = vpp.make_block(rows, cols, dev)
    for iters in (0, 1, 8):
        _close(vk.resident_elementwise(x, work, iters),
               vk.resident_elementwise.plain(x, work, iters), 1e-5)


@pytest.mark.parametrize("work,rows,cols", [
    (w, r, c) for w, shapes in vpp.SHAPES.items() for r, c in shapes])
def test_resident_elementwise_fixed(dev, work, rows, cols):
    """The kernel the plan kernel replaced (``variant="fixed"``): 0, 1 and
    8 passes against the twin, within 1e-5 of the largest output."""
    x = vpp.make_block(rows, cols, dev)
    for iters in (0, 1, 8):
        _close(vk.resident_elementwise(x, work, iters, variant="fixed"),
               vk.resident_elementwise.plain(x, work, iters), 1e-5)


@pytest.mark.parametrize("work,rows,cols", [
    (w, r, c) for w in ("softmax", "ln") for r, c in vpp.SHAPES[w]])
def test_resident_elementwise_layouts(dev, work, rows, cols):
    """The plan kernel at every layout its plan takes for this width on
    either side of its row threshold (forced as ``chip_smoke.py
    --k27-plan`` forces them): 8 passes against the twin, within 1e-5 of
    the largest output."""
    x = vpp.make_block(rows, cols, dev)
    want = vk.resident_elementwise.plain(x, work, 8)
    for r in (2 * N_SMS, 2 * N_SMS + 1):
        lanes, values, _, smem = vk.resident_plan(r, cols, work)
        variant = f"{lanes}x{values}" + (" smem" if smem else "")
        _close(vk.resident_elementwise(x, work, 8, variant=variant), want,
               1e-5)


@pytest.mark.parametrize("work", ["gelu", "gelu_poly", "gelu_erff"])
@pytest.mark.parametrize("rows,cols", [(256, 4096), (1024, 3072)])
def test_resident_elementwise_overflowed(dev, work, rows, cols):
    """A block after 320 passes holds infs (the feedback y ~ 1.5 x
    overflows); 8 more passes of either kernel keep the twin's infs, make
    no NaN and hold the finite values within 1e-5 of the largest."""
    x = vpp.make_block(rows, cols, dev)
    xo = vk.resident_elementwise(x, work, 320)
    assert torch.isinf(xo).any()
    want = vk.resident_elementwise.plain(xo, work, 8)
    fin = torch.isfinite(want)
    for variant in vk.VARIANTS:
        got = vk.resident_elementwise(xo, work, 8, variant=variant)
        assert torch.equal(torch.isinf(got), torch.isinf(want)), variant
        assert not torch.isnan(got).any(), variant
        _close(got[fin], want[fin], 1e-5)


@pytest.mark.parametrize("work", ["gelu", "gelu_poly", "gelu_erff"])
def test_resident_gelu_plan_bits_equal_the_fixed_kernel(dev, work):
    """One pass of the plan kernel (the A&S erf's argument clamped, its
    reciprocal's fast path inline) equals the fixed kernel's bit for bit on
    every fp32 x with |x| <= 16, and on +-inf and +-3.4e38."""
    lim = 0x41800000  # the bits of 16.0
    chunk = 1 << 26
    for sign in (0, 1):
        for lo in range(0, lim + 1, chunk):
            bits = torch.arange(lo, lo + chunk, device=dev,
                                dtype=torch.int64).clamp_(max=lim)
            x = (bits | (sign << 31)).to(torch.int32).view(
                torch.float32).view(-1, 4096)
            a = vk.resident_elementwise(x, work, 1)
            b = vk.resident_elementwise(x, work, 1, variant="fixed")
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), lo
    x = torch.tensor([math.inf, -math.inf, 3.4e38, -3.4e38] * 1024,
                     device=dev).view(1, 4096)
    a = vk.resident_elementwise(x, work, 1)
    b = vk.resident_elementwise(x, work, 1, variant="fixed")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ptxas_report(name: str, out_dir) -> dict:
    """{mangled kernel: (registers, stack frame bytes, spill store bytes)} as
    ``nvcc -Xptxas -v`` prints them for csrc/<name>.cu."""
    run = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / f"{name}.so"), str(_build.CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=True, timeout=600)
    report, current = {}, None
    for line in (run.stdout + run.stderr).splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            current = m.group(1)
            report[current] = [None, None, None]
        elif current and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)):
            report[current][1:] = [int(m.group(1)), int(m.group(2))]
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            report[current][0] = int(m.group(1))
    return report


def test_resources_match_ptxas(dev, tmp_path):
    """The runtime's registers and local bytes of each of add_layernorm's
    kernels (the scalar kernel, the vector kernel at 1 and 4 warps a row)
    equal what ptxas printed when it compiled it; the vector kernels use no
    local memory."""
    report = _ptxas_report("add_layernorm", tmp_path)
    rows = _build.resources("add_layernorm")
    assert sorted(r["variant"] for r in rows) == ["scalar", "warps1",
                                                  "warps4"]
    for row in rows:
        base, _, arg = row["kernel"].partition("<")
        name = f"{len(base)}{base}"  # as the mangled name spells it
        tmpl = f"ILi{arg.rstrip('>')}E" if arg else ""
        (regs, stack, _), = [v for k, v in report.items()
                             if name in k and tmpl in k]
        assert (row["registers"], row["local_bytes"]) == (regs, stack), row
        assert row["op"] == "add_layernorm" and row["blocks_per_sm"] >= 1
        if row["variant"] != "scalar":
            assert row["local_bytes"] == 0, row


def test_tp_allreduce_one_card_kernels_report_no_spill(dev):
    """K15's one-card kernels (tp = 2 and 4) use no local memory; the
    exchange's kernels are listed beside them."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import tp_allreduce
    rows = tp_allreduce.resources("local")
    assert len(rows) == 2
    for r in rows:
        assert r["local_bytes"] == 0 and r["blocks_per_sm"] >= 1, r
    assert len(tp_allreduce.resources("coop")) == 2


def test_every_backward_kernel_reports_its_resources(dev):
    from acai_omr_tpu_torch.ops.attention_bwd_kernel import attention_bwd
    from acai_omr_tpu_torch.ops.layernorm_bwd_kernel import layernorm_bwd
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import (linear_dgrad,
                                                          linear_wgrad)
    for op in (linear_bias_act, encoder_attention, add_layernorm,
               attention_bwd, layernorm_bwd, linear_dgrad, linear_wgrad,
               hk.head_logits, hk.batched_head_logits):
        rows = op.resources()
        assert rows and all(r["op"] == op.name for r in rows), op.name
        for r in rows:
            assert r["registers"] > 0 and r["blocks_per_sm"] >= 1, r
    # K7's wmma dQ / dK dV kernels (the yardstick) ask for dynamic shared
    # memory past 48 KB
    assert all(r["dynamic_smem"] > 48 * 1024
               for r in attention_bwd.resources("wmma_dh64"))
    assert len(attention_bwd.resources("wmma_dh64")) == 2
    # the Hopper kernels of K7 and dgrad: warp-specialised blocks of 384
    # threads, one an SM, no local memory (no spill)
    for op, variant, n in ((attention_bwd, "sm90_dh64", 2),
                           (attention_bwd, "sm90_dh32", 2),
                           (linear_dgrad, "sm90", 2)):
        rows = op.resources(variant)
        assert len(rows) == n, (op.name, variant)
        for r in rows:
            assert r["local_bytes"] == 0 and r["threads"] == 384, r
            assert r["dynamic_smem"] > 48 * 1024 and r["blocks_per_sm"] == 1, r
    assert len(linear_dgrad.resources("wmma")) == 1
    # K3's Hopper kernels: the same warp-specialised blocks, no local memory
    for variant in ("sm90_dh64", "sm90_dh32"):
        (row,) = encoder_attention.resources(variant)
        assert row["local_bytes"] == 0 and row["threads"] == 384, row
        assert row["blocks_per_sm"] == 1, row
    # K3's pre-Hopper kernels (the yardstick): one a head dim, 128 threads
    for variant in ("wmma_dh64", "wmma_dh32"):
        (row,) = encoder_attention.resources(variant)
        assert row["threads"] == 128, row
    # K1's skinny kernel: one and two consumer warpgroups, a producer warp
    # beside them, no local memory
    rows = linear_bias_act.resources("skinny")
    assert sorted(r["threads"] for r in rows) == [160, 288]
    for r in rows:
        assert r["local_bytes"] == 0, r


def test_decode_attention_cluster_kernels_report_no_spill(dev):
    """K2's cluster kernels (three head dims x four query groups) and K11's
    (four head dims, TMA or copied tiles): 128 threads, no local memory, at
    least one block an SM at their largest shared memory; each simt kernel
    listed beside them."""
    for op, n in ((decode_attention, 12), (decode_attention_hd, 8)):
        rows = op.resources("split")
        assert len(rows) == n, op.name
        for r in rows:
            assert r["threads"] == 128 and r["local_bytes"] == 0, r
            assert r["blocks_per_sm"] >= 1, r
        assert len(op.resources("simt")) == 1


def test_int8_cluster_kernels_report_no_spill(dev):
    """K6's cluster kernels (three head dims x four query groups, 128
    threads) and K14's (256 threads): no local memory, at least one block an
    SM at their largest shared memory; the simt kernel or form each replaced
    listed beside."""
    for op, n, threads in ((decode_attention_int8, 12, 128),
                           (quant4_linear_bias_act, 1, 256)):
        rows = op.resources("split")
        assert len([r for r in rows if r["variant"] == "split"]) == n
        for r in rows:
            if r["variant"] == "split":
                assert r["threads"] == threads and r["local_bytes"] == 0, r
                assert r["blocks_per_sm"] >= 1, r
        assert any(r["variant"] == "simt" for r in op.resources("simt"))


def test_k5_k12_cluster_kernels_report_no_spill(dev):
    """K5's cluster kernels (64 and 128 columns, 256 threads) and K12's
    (four head dims, TMA or copied tiles, 128 threads): no local memory, at
    least one block an SM at their largest shared memory; the kernels of
    the forms each replaced listed beside."""
    for op, n, threads in ((quant_linear_bias_act, 2, 256),
                           (decode_attention_hd_int8, 8, 128)):
        rows = [r for r in op.resources("split") if r["variant"] == "split"]
        assert len(rows) == n, op.name
        for r in rows:
            assert r["threads"] == threads and r["local_bytes"] == 0, r
            assert r["blocks_per_sm"] >= 1, r
        assert any(r["variant"] == "simt" for r in op.resources("simt"))

def test_k13_k8_kernels_report_no_spill(dev):
    """K13's cluster kernels (four head dims, TMA or copied tiles, 128
    threads) and K8's one-pass kernel (eight widths, 256 threads): no local
    memory, at least one block an SM (K8: as many as its plan counts on);
    the kernels of the forms each replaced listed beside."""
    from acai_omr_tpu_torch.ops.layernorm_bwd_kernel import (LNB_WIDE_E,
                                                             layernorm_bwd)
    rows = [r for r in self_attention_append_int8.resources("split")
            if r["variant"] == "split"]
    assert len(rows) == 8
    for r in rows:
        assert r["threads"] == 128 and r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] >= 1, r
    assert any(r["variant"] == "simt"
               for r in self_attention_append_int8.resources("simt"))
    rows = layernorm_bwd.resources("one_pass")
    one = [r for r in rows if r["variant"] == "one_pass"]
    assert len(one) == 8
    for r in one:
        e = int(r["kernel"].split("<")[1].rstrip(">"))
        assert r["threads"] == 256 and r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] >= (2 if e <= LNB_WIDE_E else 1), r
    assert len(layernorm_bwd.resources("three_pass")) == 3

def test_resident_elementwise_keeps_its_rows_in_registers(dev):
    """No local memory (spill) in any K27 variant the probe runs: the plan
    kernel each of its shapes takes, and the kernel it replaced."""
    for work, shapes in vpp.SHAPES.items():
        for rows, cols in shapes:
            for variant in (vk.plan_variant(rows, cols, work),
                            f"{work} {cols} fixed"):
                (row,) = vk.resident_elementwise.resources(variant)
                assert row["local_bytes"] == 0, row


def test_unpack_and_stream_sum_report_no_spill(dev):
    """K21's word-wide kernels (every scheme) and K24's one-launch kernel:
    no local memory, the tool's grid resident at once; the kernels they
    replaced listed beside."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for scheme in ik.UNPACK_SCHEMES:
        (r,) = [r for r in ik.int4_unpack.resources(scheme)
                if r["variant"] == scheme]
        assert r["threads"] == ik.UNPACK_THREADS and r["local_bytes"] == 0, r
        blocks, _ = ik.unpack_plan(512, 4096, scheme)
        assert r["blocks_per_sm"] * sms >= blocks, r
        assert len(ik.int4_unpack.resources(f"{scheme} bytewise")) == 1
    (r,) = [r for r in sk.lane_stream_sum.resources() if r["variant"] == ""]
    assert r["threads"] == sk.STREAM_THREADS and r["local_bytes"] == 0, r
    assert r["blocks_per_sm"] >= sk.STREAM_BLOCKS_PER_SM, r
    assert len(sk.lane_stream_sum.resources("two_pass")) == 3


def test_batched_head_logits_slab_reports_no_spill(dev):
    """K26's slab kernels (fp32 / int8): 256 threads, no local memory, at
    least one block an SM at 64 KB of slab; the kernel they replaced listed
    beside."""
    for dtype in ("fp32", "int8"):
        (r,) = hk.batched_head_logits.resources(f"{dtype} slab")
        assert r["threads"] == 256 and r["local_bytes"] == 0, r
        assert r["blocks_per_sm"] >= 1, r
        assert len(hk.batched_head_logits.resources(f"{dtype} shuffle")) == 1
