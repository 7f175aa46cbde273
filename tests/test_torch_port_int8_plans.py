"""The plans of the two kernels of the W4A8 int8 decode step: K6
``decode_attention_int8`` (``decode_kernel.decode_attention_int8_plan``: the
keys of a (row, head) split across a thread-block cluster) and K14
``quant4_linear_bias_act`` (``quant_linear_kernel.quant4_plan``: K split
across a cluster), and K6's check, which runs on CPU tensors too, before
anything is built. Pure Python: nothing here asks for the card; a build or
a bind during these tests fails them.
"""

import pytest
import torch

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import decode_kernel as dk
from acai_omr_tpu_torch.ops import quant_linear_kernel as qk

KEYS = [1, 2, 15, 16, 17, 63, 64, 65, 127, 128, 129, 255, 256, 299, 300, 301,
        511, 512, 513, 1000, 1023, 1024, 1025, 1536, 2047, 2048, 3000, 4095,
        4096, 5000, 6143, 8191, 8192]
ROWS = [1, 2, 4, 8, 16, 32, 64, 128]
HEADS = [4, 8, 16]
U = dk.ATTN_UNIT
# the W4A8 products of the decode step (qkv, self / cross out, cross q, ff1,
# ff2) at the flagship's widths, a tp = 2 rank's and a small model's
PRODUCTS = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
            (512, 1024), (2048, 1024), (1024, 1536), (256, 768), (128, 128),
            (8192, 1024)]


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


def _ranges(split, n_keys):
    u = -(-n_keys // U)
    return [(min(n_keys, r * u // split * U),
             min(n_keys, (r + 1) * u // split * U)) for r in range(split)]


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_int8_plan_partitions_the_keys_within_shared_memory(group):
    """K6's ranges: whole units, in order, none empty, together
    [0, n_keys); a cluster of at most 8; each block's keys within its
    shared memory (5 G + 4 bytes a key)."""
    gq = dk.query_group(group)
    for n_keys in KEYS:
        for rows in ROWS:
            if rows % group:
                continue
            for heads in HEADS:
                keys, split = dk.decode_attention_int8_plan(rows, heads,
                                                            n_keys, group)
                ranges = _ranges(split, n_keys)
                assert keys % U == 0 and 1 <= split <= dk.ATTN_MAX_SPLIT
                assert all(lo < hi for lo, hi in ranges)
                assert ranges[0][0] == 0 and ranges[-1][1] == n_keys
                assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
                assert keys >= max(hi - lo for lo, hi in ranges)
                assert keys * (5 * gq + 4) <= dk.ATTN_INT8_KEY_BYTES


@pytest.mark.parametrize("group", [1, 4, 8])
def test_int8_plan_reaches_the_sms(group):
    """clusters x split >= 132 wherever the units and a cluster of 8 allow;
    no split larger than needed (about ATTN_INT8_BLOCKS_PER_SM blocks an SM,
    at most ATTN_BLOCK_UNITS units a block)."""
    for n_keys in KEYS:
        for rows in ROWS:
            if rows % group:
                continue
            for heads in HEADS:
                _, split = dk.decode_attention_int8_plan(rows, heads, n_keys,
                                                         group)
                gq = dk.query_group(group)
                clusters = rows // group * -(-group // gq) * heads
                units = -(-n_keys // U)
                assert clusters * split >= min(
                    dk.N_SMS, clusters * min(dk.ATTN_MAX_SPLIT, units))
                if split > 1:
                    assert (clusters * (split - 1)
                            < dk.ATTN_INT8_BLOCKS_PER_SM * dk.N_SMS
                            or units > (split - 1) * dk.ATTN_BLOCK_UNITS)


@pytest.mark.parametrize("rows,heads,n_keys,group,want", [
    (32, 16, 300, 1, (304, 1)),    # self B=32 pos=300
    (4, 16, 300, 1, (48, 8)),      # self at the 4 rows after compaction
    (8, 16, 300, 1, (80, 4)),
    (32, 16, 512, 1, (512, 1)),    # cross B=32 M=512
    (4, 16, 1024, 1, (128, 8)),    # cross over M = 1,024 at 4 / 8 rows
    (8, 16, 1024, 1, (256, 4)),
    (32, 16, 512, 4, (128, 4)),    # grouped G=4 over M=512
    (16, 16, 1024, 4, (128, 8)),   # beams B=16 G=4 M=1024
    (128, 16, 1024, 8, (512, 2)),  # GRPO's rollouts on int8 caches
])
def test_int8_plan_at_the_decode_shapes(rows, heads, n_keys, group, want):
    assert dk.decode_attention_int8_plan(rows, heads, n_keys, group) == want


def test_int8_plan_holds_the_step_limit_and_refuses_past_a_cluster():
    """Every cache or memory of up to MAX_INT8_KEYS keys fits at every group
    (``attention_fits``, which the step's shape gate asks); past eight
    blocks' shared memory the plan refuses."""
    for group in (1, 2, 4, 8):
        assert dk.attention_fits(dk.MAX_INT8_KEYS, group, int8=True)
        dk.decode_attention_int8_plan(8, 16, dk.MAX_INT8_KEYS, group)
    most = dk._units_a_block(8, True) * U * dk.ATTN_MAX_SPLIT
    assert dk.decode_attention_int8_plan(8, 16, most, 8)[1] \
        == dk.ATTN_MAX_SPLIT
    assert not dk.attention_fits(most + 1, 8, int8=True)
    with pytest.raises(ValueError, match="do not fit"):
        dk.decode_attention_int8_plan(8, 16, most + 1, 8)
    assert dk.decode_attention_int8_plan(4, 16, 0) == (U, 1)


@pytest.mark.parametrize("group", [1, 8])
def test_int8_forced_splits_partition_the_keys(group):
    for n_keys in KEYS:
        for s in range(1, dk.ATTN_MAX_SPLIT + 1):
            try:
                keys, split = dk.attention_split(f"split{s}", 8, 16, n_keys,
                                                 group, int8=True)
            except ValueError:  # one block cannot hold its range's keys
                assert -(-n_keys // (s * U)) * U * (5 * group + 4) \
                    > dk.ATTN_INT8_KEY_BYTES
                continue
            assert split == min(s, -(-n_keys // U))
            ranges = _ranges(split, n_keys)
            assert all(lo < hi for lo, hi in ranges)
            assert keys >= max(hi - lo for lo, hi in ranges)
    assert dk.attention_split("simt", 4, 16, 300, 1, True) is None


def _k6_inputs(b=4, t=48, e=256, h=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, 3 * e, generator=g)
    c = lambda: torch.randint(-127, 128, (b, t, e), generator=g,
                              dtype=torch.int8)
    sc = lambda: (torch.rand(b, t, h, generator=g) * 3e-2 + 2e-3).to(
        torch.bfloat16)
    return qkv, c(), c(), sc(), sc(), torch.randn(b, e, generator=g), \
        torch.zeros(b, t)


@pytest.mark.parametrize("variant", [None, "simt", "split1", "split4"])
def test_k6_plain_twin_is_one_for_every_variant(variant):
    """On CPU tensors every variant of K6 is the plain twin."""
    qkv, kc, vc, ks, vs, q, bias = _k6_inputs()
    bias[1, 30:] = -1e9
    twin = [a.clone() for a in (kc, vc, ks, vs)]
    got = dk.decode_attention_int8(qkv, kc, vc, ks, vs, 4, pos=7,
                                   variant=variant)
    assert torch.equal(got, dk.decode_attention_int8.plain(qkv, *twin, 4,
                                                           pos=7))
    assert all(torch.equal(a, b) for a, b in zip((kc, vc, ks, vs), twin))
    assert torch.equal(
        dk.decode_attention_int8(q, kc, vc, ks, vs, 4, bias=bias,
                                 variant=variant),
        dk.decode_attention_int8.plain(q, kc, vc, ks, vs, 4, bias=bias))


@pytest.mark.parametrize("variant", ["split", "split0", "split9", "wmma"])
def test_k6_refuses_an_unknown_variant(variant):
    qkv, kc, vc, ks, vs, q, bias = _k6_inputs()
    with pytest.raises(ValueError, match="unknown variant"):
        dk.decode_attention_int8(qkv, kc, vc, ks, vs, 4, pos=5,
                                 variant=variant)


def test_k6_refuses_bad_shapes_on_the_cpu():
    qkv, kc, vc, ks, vs, q, bias = _k6_inputs()
    bad = [
        lambda: dk.decode_attention_int8(qkv, kc, vc[:, :40], ks, vs, 4,
                                         pos=5),
        lambda: dk.decode_attention_int8(qkv, kc, vc, ks[..., :2], vs, 4,
                                         pos=5),                  # scales
        lambda: dk.decode_attention_int8(qkv, kc, vc, ks, vs, 3, pos=5),
        lambda: dk.decode_attention_int8(qkv, kc, vc, ks, vs, 4, pos=48),
        lambda: dk.decode_attention_int8(qkv, kc, vc, ks, vs, 4, pos=5,
                                         bias=bias),
        lambda: dk.decode_attention_int8(q, kc, vc, ks, vs, 4),  # no bias
        lambda: dk.decode_attention_int8(q, kc[:2], vc[:2], ks[:2], vs[:2],
                                         4, bias=bias[:2], mem_group=3),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("k,n", PRODUCTS)
@pytest.mark.parametrize("m", [1, 4, 8, 16, 32, 128])
def test_quant4_plan_splits_k_in_order_over_one_cluster(m, k, n):
    """K14's ranges: multiples of 128, at most 1,024 k a block, in order,
    none empty, covering K; a cluster of at most 8; the grid at least one
    block an SM where the tiles and a cluster of 8 reach the SMs, and no
    wider than about Q4_BLOCKS_PER_SM blocks an SM needs; each block's
    k-steps within the ring."""
    k_chunk, split = qk.quant4_plan(m, n, k)
    steps = k // qk.Q4_KSTEP
    assert k_chunk % qk.Q4_KSTEP == 0 and 0 < k_chunk <= qk.Q4_MAX_CHUNK
    assert 1 <= split <= qk.Q4_MAX_SPLIT
    assert k_chunk * (split - 1) < k <= k_chunk * split
    tiles = n // qk.Q4_BN * -(-m // qk.Q4_ROWS)
    assert tiles * split >= min(qk.N_SMS, tiles * min(qk.Q4_MAX_SPLIT, steps))
    assert split <= max(-(-qk.Q4_BLOCKS_PER_SM * qk.N_SMS // tiles),
                        -(-steps // qk.Q4_STAGES))
    assert k_chunk // qk.Q4_KSTEP <= qk.Q4_STAGES


@pytest.mark.parametrize("m,k,n,want", [
    (32, 1024, 3072, (256, 4)),  # qkv at B = 32: 48 tiles x 4
    (32, 1024, 4096, (256, 4)),  # ff1
    (32, 4096, 1024, (512, 8)),  # ff2: 16 tiles x 8
    (8, 1024, 1024, (128, 8)),   # self / cross out at 8 rows
    (128, 4096, 1024, (896, 5)),
    (8, 256, 768, (128, 2)),
])
def test_quant4_plan_at_the_decode_shapes(m, k, n, want):
    assert qk.quant4_plan(m, n, k) == want


def test_quant4_plan_refuses_what_the_kernel_does_not_take():
    for k, n in ((1024, 64), (1000, 1024), (16384, 1024)):
        assert not qk.quant4_takes(k, n)
        with pytest.raises(ValueError, match="quant4_linear_bias_act takes"):
            qk.quant4_plan(8, n, k)
    assert qk.quant4_takes(8192, 1024) and qk.quant_takes(16384, 1024)


@pytest.mark.parametrize("variant", [None, "simt", "split2"])
def test_quant4_plain_twin_is_one_for_every_variant(variant):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 256, generator=g)
    q = torch.randint(-7, 8, (256, 128), generator=g)
    s = torch.rand(128, generator=g) * 1e-2 + 1e-3
    b = torch.randn(128, generator=g)
    wp = qk.pack_k8_int4(q)
    assert torch.equal(
        qk.quant4_linear_bias_act(x, wp, s, b, "gelu_rounded",
                                  variant=variant),
        qk.quant4_linear_bias_act.plain(x, wp, s, b, "gelu_rounded"))
