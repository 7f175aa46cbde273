"""The plan of K2 ``decode_attention`` and K11 ``decode_attention_hd``
(``decode_kernel.decode_attention_plan``: the keys of a (row, head) split
across a thread-block cluster) and the wrappers' checks, which run on CPU
tensors too, before anything is built. Pure Python: nothing here asks for the
card; a build or a bind during these tests fails them.
"""

import pytest
import torch

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import decode_kernel as dk
from acai_omr_tpu_torch.ops.decode_hd_kernel import decode_attention_hd

KEYS = [1, 2, 31, 63, 64, 65, 127, 128, 129, 191, 255, 256, 300, 301, 383,
        511, 512, 513, 767, 1000, 1023, 1024, 1025, 1536, 2047, 2048, 3000,
        4095, 4096, 5000, 6143, 8191, 8192]
ROWS = [1, 2, 4, 8, 16, 24, 32, 64, 128]
HEADS = [4, 8, 12, 16]
U = dk.ATTN_UNIT


def _ranges(split, n_keys):
    """The kernels' ranges: block r owns units [r u / split, (r + 1) u /
    split) of the u = ceil(n_keys / U) units, cut at n_keys."""
    u = -(-n_keys // U)
    return [(min(n_keys, r * u // split * U),
             min(n_keys, (r + 1) * u // split * U)) for r in range(split)]


def _partitions(keys, split, n_keys):
    """In order, none empty, together [0, n_keys); ``keys`` (what sizes a
    block's logits) whole units and at least the largest range."""
    ranges = _ranges(split, n_keys)
    return (keys % U == 0 and 1 <= split <= dk.ATTN_MAX_SPLIT
            and all(lo < hi for lo, hi in ranges)
            and ranges[0][0] == 0 and ranges[-1][1] == n_keys
            and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            and keys >= max(hi - lo for lo, hi in ranges))


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_plan_partitions_the_keys(group):
    for n_keys in KEYS:
        for rows in ROWS:
            if rows % group:
                continue
            for heads in HEADS:
                keys, split = dk.decode_attention_plan(rows, heads, n_keys,
                                                       group)
                assert _partitions(keys, split, n_keys), \
                    (rows, heads, n_keys, group, keys, split)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_plan_reaches_the_sms(group):
    """clusters x split >= 132 wherever the units and a cluster of 8 allow,
    and no split larger than needed: one less would leave fewer than two
    blocks an SM or a block with more than ATTN_BLOCK_UNITS units."""
    for n_keys in KEYS:
        for rows in ROWS:
            if rows % group:
                continue
            for heads in HEADS:
                keys, split = dk.decode_attention_plan(rows, heads, n_keys,
                                                       group)
                gq = dk.query_group(group)
                clusters = rows // group * -(-group // gq) * heads
                units = -(-n_keys // U)
                reach = clusters * min(dk.ATTN_MAX_SPLIT, units)
                assert clusters * split >= min(dk.N_SMS, reach)
                if split > 1:
                    assert (clusters * (split - 1)
                            < dk.ATTN_BLOCKS_PER_SM * dk.N_SMS
                            or units > (split - 1) * dk.ATTN_BLOCK_UNITS)


@pytest.mark.parametrize("rows,heads,n_keys,group,want", [
    (4, 16, 511, 1, (128, 4)),     # bf16 self at 4 rows, the last step
    (4, 16, 300, 1, (80, 4)),      # self at pos 300, 4 rows
    (4, 16, 1024, 1, (256, 4)),    # cross over M = 1,024 at 4 rows
    (8, 16, 1024, 1, (512, 2)),    # cross at 8 rows
    (8, 16, 100, 1, (64, 2)),
    (32, 16, 300, 1, (304, 1)),    # B = 32: two blocks an SM already
    (32, 16, 1024, 1, (512, 2)),   # at most 512 keys a block
    (1, 16, 300, 1, (48, 8)),      # streamed: B = 1
    (1, 16, 1024, 1, (128, 8)),
    (128, 16, 1024, 8, (512, 2)),  # GRPO's rollouts, G = 8
    (16, 16, 1024, 4, (256, 4)),   # beams, G = 4
    (16, 8, 1024, 4, (128, 8)),    # beams on a tp = 2 rank
])
def test_plan_at_the_decode_shapes(rows, heads, n_keys, group, want):
    assert dk.decode_attention_plan(rows, heads, n_keys, group) == want


def test_plan_of_no_keys_and_of_too_many():
    """Self mode at pos 0 attends to the fresh token alone: one block of no
    keys. Past eight blocks' shared memory the plan refuses."""
    assert dk.decode_attention_plan(4, 16, 0) == (U, 1)
    most = dk.ATTN_LOGIT_BYTES // 4 * dk.ATTN_MAX_SPLIT
    assert dk.decode_attention_plan(1, 16, most)[1] == dk.ATTN_MAX_SPLIT
    with pytest.raises(ValueError, match="do not fit"):
        dk.decode_attention_plan(1, 16, most + 1)
    with pytest.raises(ValueError, match="do not fit"):
        dk.decode_attention_plan(8, 16, most // 8 + 1, 8)


@pytest.mark.parametrize("group", [1, 8])
def test_forced_splits_partition_the_keys(group):
    for n_keys in KEYS:
        for s in range(1, dk.ATTN_MAX_SPLIT + 1):
            try:
                keys, split = dk.attention_split(f"split{s}", 8, 16, n_keys,
                                                 group)
            except ValueError:  # one block cannot hold its range's logits
                assert -(-n_keys // (s * U)) * U * 4 * group \
                    > dk.ATTN_LOGIT_BYTES
                continue
            assert split == min(s, -(-n_keys // U))
            assert _partitions(keys, split, n_keys)
    assert dk.attention_split("simt", 4, 16, 300) is None


def test_query_groups():
    assert [dk.query_group(g) for g in (1, 2, 3, 4, 5, 8, 12)] \
        == [1, 2, 4, 4, 8, 8, 8]


def _k2_inputs(b=4, t=48, e=256):
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(b, 3 * e, generator=g)
    kc, vc = torch.randn(b, t, e, generator=g), torch.randn(b, t, e,
                                                            generator=g)
    q = torch.randn(b, e, generator=g)
    bias = torch.zeros(b, t)
    return qkv, kc, vc, q, bias


@pytest.mark.parametrize("variant", ["split", "split0", "split9", "wmma",
                                     "sm90", "SIMT"])
def test_wrappers_refuse_an_unknown_variant(variant):
    qkv, kc, vc, q, bias = _k2_inputs()
    with pytest.raises(ValueError, match="unknown variant"):
        dk.decode_attention(qkv, kc, vc, 4, pos=5, variant=variant)
    with pytest.raises(ValueError, match="unknown variant"):
        dk.decode_attention(q, kc, vc, 4, bias=bias, variant=variant)
    kT = torch.randn(4, 4, 64, 48)
    with pytest.raises(ValueError, match="unknown variant"):
        decode_attention_hd(kT[..., 0], kT, kT, None, variant=variant)


def test_k2_wrapper_refuses_bad_shapes():
    qkv, kc, vc, q, bias = _k2_inputs()
    bad = [
        lambda: dk.decode_attention(qkv, kc, vc[:, :40], 4, pos=5),
        lambda: dk.decode_attention(qkv, kc, vc, 3, pos=5),      # E % H
        lambda: dk.decode_attention(qkv, kc, vc, 4, pos=48),     # pos >= T
        lambda: dk.decode_attention(qkv[:, :256], kc, vc, 4, pos=5),
        lambda: dk.decode_attention(qkv, kc, vc, 4, pos=5, bias=bias),
        lambda: dk.decode_attention(q, kc, vc, 4),               # no bias
        lambda: dk.decode_attention(q, kc, vc, 4, bias=bias[:, :40]),
        lambda: dk.decode_attention(q, kc[:2], vc[:2], 4, bias=bias[:2],
                                    mem_group=3),                # 2 x 3 != 4
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_k11_wrapper_refuses_bad_shapes():
    kT = torch.randn(2, 4, 16, 40)
    q = kT[..., 0].contiguous()
    bad = [
        lambda: decode_attention_hd(q, kT, kT[..., :32], None),
        lambda: decode_attention_hd(q[:, :3], kT, kT, None),
        lambda: decode_attention_hd(q, kT, kT, torch.zeros(2, 39)),
        lambda: decode_attention_hd(q, kT, kT, None, n_keys=41),
        lambda: decode_attention_hd(q, kT, kT, None, n_keys=0),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("variant", [None, "simt", "split1", "split4"])
def test_plain_twin_is_one_for_every_variant(variant):
    """On CPU tensors every variant is the plain twin (one function)."""
    qkv, kc, vc, q, bias = _k2_inputs()
    bias[1, 30:] = -1e9
    kp, vp = kc.clone(), vc.clone()
    got = dk.decode_attention(qkv, kc, vc, 4, pos=7, variant=variant)
    assert torch.equal(got, dk.decode_attention.plain(qkv, kp, vp, 4, pos=7))
    assert torch.equal(kc, kp) and torch.equal(vc, vp)
    assert torch.equal(dk.decode_attention(q, kc, vc, 4, bias=bias,
                                           variant=variant),
                       dk.decode_attention.plain(q, kc, vc, 4, bias=bias))
    kT = torch.randn(2, 4, 16, 40)
    got = decode_attention_hd(kT[..., 0].contiguous(), kT, kT, None,
                              n_keys=30, variant=variant)
    assert torch.equal(got, decode_attention_hd.plain(
        kT[..., 0].contiguous(), kT, kT, None, n_keys=30))
