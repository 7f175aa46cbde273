"""The plans that route the port's products: K1's variant (``gemm_plan``:
the Hopper core for the large-M products, the skinny kernel for the decode
rows) and the skinny kernel's split (``skinny_plan``), K9
``linear_wgrad``'s row split (``row_split_plan``) and K9 ``linear_dgrad``'s
tile (``dgrad_plan``), at every shape of the port's paths (PERF.md section
6); and the premise of K7's and K3's skipped tiles. Pure Python: nothing
here asks for the card. The plain twins answer the same for every variant
on CPU tensors (exactly: they are one function).
"""

import pytest
import torch

from acai_omr_tpu_torch.ops import attention_bwd_kernel as ab
from acai_omr_tpu_torch.ops import encoder_stack_kernel as es
from acai_omr_tpu_torch.ops import linear_bwd_kernel as lb
from acai_omr_tpu_torch.ops import linear_kernel as lk

from _torch_port_threads import torch_one_thread  # noqa: F401

# (M, K, N): the decode step (B = 32), beams (4 x 4), GRPO's rollouts
# (16 images x 8), the meshed decode's shards (column-parallel qkv and ff1
# at tp = 2 and 4, and the row-parallel fp32 partials)
DECODE = [(32, 1024, 3072), (32, 1024, 4096), (32, 4096, 1024),
          (16, 1024, 3072), (128, 1024, 3072), (128, 4096, 1024),
          (8, 1024, 1536), (8, 1024, 2048), (8, 512, 1024), (8, 2048, 1024),
          (8, 256, 1024), (8, 1024, 1024), (4, 512, 1024), (16, 2048, 1024),
          (8, 1024, 768)]
# the meshed cross-query shards (E -> E / tp at tp = 2 and 4)
NARROW = [(8, 1024, 512), (8, 1024, 256), (4, 1024, 512), (16, 1024, 256)]
# the inference encoder at B = 16, stage 2's decoder (8 x 256 rows) and
# encoder (8 x 1024), the MAE's decoder (64 x 512) and encoder (64 x 128 kept
# rows)
LARGE = [(16384, 768, 2304), (16384, 768, 3072), (16384, 3072, 768),
         (16384, 768, 768), (2048, 1024, 3072), (2048, 1024, 1024),
         (2048, 1024, 4096), (2048, 4096, 1024), (8192, 768, 2304),
         (8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768),
         (32768, 512, 1536), (32768, 512, 512), (32768, 512, 3072),
         (32768, 3072, 512)]
# (R, K, N) of every wgrad: stage 2's decoder and encoder layers, the MAE's
# decoder; the MAE's encoder has stage 2's encoder shapes
WGRAD = [(2048, 1024, 3072), (2048, 1024, 1024), (2048, 1024, 4096),
         (2048, 4096, 1024), (8192, 768, 2304), (8192, 768, 768),
         (8192, 768, 3072), (8192, 3072, 768), (32768, 512, 1536),
         (32768, 512, 512), (32768, 512, 3072), (32768, 3072, 512)]


# (M, N, K) of every dgrad dX (M, K) = dY (M, N) W^T: per stack du (E -> F),
# dx2 (F -> E, + residual), the bare E -> E products and dx (3E -> E, +
# residual) of stage 2's decoder (8 x 256 rows) and encoder (8 x 1024), the
# MAE's decoder (64 x 512; its encoder has stage 2's encoder shapes) and
# GRPO's update chunks (8 rollouts x 128 positions, E 1024)
DGRAD = [(rows, n, k) for rows, e, f in ((2048, 1024, 4096),
                                         (8192, 768, 3072),
                                         (32768, 512, 3072),
                                         (1024, 1024, 4096))
         for n, k in ((e, f), (f, e), (e, e), (3 * e, e))]


@pytest.mark.parametrize("m,k,n", DECODE + NARROW)
def test_decode_rows_stay_on_wmma(m, k, n):
    """The decode rows left the wmma kernel for the skinny kernel (one
    launch); ``variant="wmma"`` still reaches the old kernel, whose plan
    splits K as before."""
    assert lk.gemm_plan(m, n, k) == ("skinny", lk.SKINNY_BN)
    assert lk.split_plan(m, n, k)[1] >= 1


@pytest.mark.parametrize("m,k,n", DECODE + NARROW)
def test_skinny_plan_covers_the_sms(m, k, n):
    """Every decode shape of the paths covers the 132 SMs wherever its
    64-column tiles times a portable cluster's split of 8 reach them, else
    as many as they do (128 at N = 1,024); each block takes at most a
    ring's depth of k-steps where the split allows; the K ranges of one
    column tile partition K in order, none empty, so the kernel's rank-order
    sum is a fixed order."""
    k_chunk, split = lk.skinny_plan(m, n, k)
    tiles, steps = -(-n // lk.SKINNY_BN), -(-k // lk.SKINNY_BK)
    assert 1 <= split <= lk.SKINNY_MAX_SPLIT and k_chunk % lk.SKINNY_BK == 0
    assert tiles * split >= min(lk.N_SMS,
                                tiles * min(lk.SKINNY_MAX_SPLIT, steps))
    if split < lk.SKINNY_MAX_SPLIT:
        assert k_chunk // lk.SKINNY_BK <= lk.SKINNY_STAGES
    ranges = [(z * k_chunk, min(k, (z + 1) * k_chunk)) for z in range(split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(split - 1))


@pytest.mark.parametrize("k", [64, 72, 960, 1000, 4096, 8192, 16384])
def test_skinny_plan_never_leaves_a_range_empty(k):
    for n in (40, 256, 1024, 3072):
        k_chunk, split = lk.skinny_plan(8, n, k)
        assert 1 <= split <= lk.SKINNY_MAX_SPLIT
        assert (split - 1) * k_chunk < k <= split * k_chunk


def test_skinny_plan_ignores_the_rows():
    # the rows set the consumer warpgroups (one per 64), not the split
    for m in (1, 8, 32, 64, 65, 100, 128):
        assert lk.skinny_plan(m, 3072, 1024) == (256, 4)
        assert lk.skinny_plan(m, 1024, 4096) == (512, 8)


@pytest.mark.parametrize("m,k,n", LARGE)
def test_encoder_and_training_rows_take_the_core(m, k, n):
    variant, bn = lk.gemm_plan(m, n, k)
    assert variant == "sm90" and bn in lk.SM90_BNS
    m_tiles, steps = -(-m // lk.SM90_BM), -(-k // 64)
    blocks = m_tiles * -(-n // bn)
    # the bound sm90_tile_n states at these shapes
    assert lk.wave_waste(blocks) < 0.30, (bn, blocks)
    # BN is the one the core's time model finds faster
    for other in lk.SM90_BNS:
        assert lk.core_s(blocks, steps, bn) \
            <= lk.core_s(m_tiles * -(-n // other), steps, other)


def test_threshold_and_the_shape_rule():
    # one image's encode (1,024 patches) is large-M too, at under one wave
    assert lk.gemm_plan(1024, 2304, 768) == ("sm90", 256)
    assert lk.gemm_plan(lk.SKINNY_M, 1024, 1024)[0] == "skinny"
    assert lk.gemm_plan(lk.SKINNY_M + 1, 1024, 1024)[0] == "sm90"
    # a decode-sized product the wmma kernel cannot take goes to the skinny
    # kernel too: its rule is TMA's (K and N multiples of 8), as the core's
    assert lk.gemm_plan(8, 72, 40)[0] == "skinny"
    assert lk.skinny_plan(8, 72, 40) == (64, 1)  # one k-step, unsplit


def _wgrad_model(r, k, n, splits, bn):
    chunk, splits = lb.row_chunks(r, splits)
    blocks = -(-k // lk.SM90_BM) * -(-n // bn) * splits
    return lk.core_s(blocks, chunk // 64, bn) \
        + (2 * splits * k * n * 4 / 3.35e12 if splits > 1 else 0.0), blocks


@pytest.mark.parametrize("r,k,n", WGRAD)
def test_wgrad_plan_covers_every_row_once(r, k, n):
    r_chunk, splits, bn = lb.row_split_plan(r, k, n)
    assert bn in lk.SM90_BNS and 1 <= splits <= 32
    assert r_chunk % 64 == 0
    # the model's fastest plan, and the waste bound row_split_plan states
    t, blocks = _wgrad_model(r, k, n, splits, bn)
    assert lk.wave_waste(blocks) < 0.55
    for other_bn in lk.SM90_BNS:
        for other in range(1, 33):
            assert t <= _wgrad_model(r, k, n, other, other_bn)[0] + 1e-12
    ranges = [(z * r_chunk, min(r, (z + 1) * r_chunk)) for z in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == r
    assert all(a < b for a, b in ranges)  # no empty split
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))


@pytest.mark.parametrize("r", [1, 63, 64, 65, 1000, 2048, 32767, 32768])
@pytest.mark.parametrize("want", [1, 2, 3, 5, 8, 32])
def test_row_chunks_partition_the_rows(r, want):
    chunk, splits = lb.row_chunks(r, want)
    assert chunk % 64 == 0 and 1 <= splits <= want
    covered = [min(r, (z + 1) * chunk) - z * chunk for z in range(splits)]
    assert all(c > 0 for c in covered) and sum(covered) == r


def test_old_wgrad_plan_is_kept_for_the_yardstick():
    # the wmma kernel's plan: the MAE's dWo split 4x, its dWqkv unsplit
    assert lb.wmma_row_chunks(32768, 512, 512) == (8192, 4)
    assert lb.wmma_row_chunks(32768, 512, 1536) == (32768, 1)


@pytest.mark.parametrize("m,n,k", DGRAD)
def test_dgrad_plan_takes_the_core(m, n, k):
    variant, bn = lb.dgrad_plan(m, k, n)
    # the core, at the tile the core's time model picks for this product
    assert (variant, bn) == ("sm90", lk.sm90_tile_n(m, k, n))
    lb.check_dgrad_shape(variant, k, n)
    # unsplit: at least 64 tiles of dX, the bound dgrad_plan states
    assert -(-m // lk.SM90_BM) * -(-k // bn) >= 64
    # the yardstick takes every one of these shapes too
    lb.check_dgrad_shape("wmma", k, n)


def test_dgrad_shape_rule():
    # the core's rule is TMA's: 16-byte rows
    lb.check_dgrad_shape("sm90", 776, 520)
    for k, n in ((774, 520), (776, 516)):
        with pytest.raises(ValueError, match="K % 8 == 0 and N % 8 == 0"):
            lb.check_dgrad_shape("sm90", k, n)
    # the wmma kernel keeps its tiles' rule
    with pytest.raises(ValueError, match="N % 32 == 0 and K % 64 == 0"):
        lb.check_dgrad_shape("wmma", 776, 512)
    with pytest.raises(ValueError, match="N % 32 == 0 and K % 64 == 0"):
        lb.check_dgrad_shape("wmma", 768, 520)
    # a ragged row count takes the core too
    assert lb.dgrad_plan(2049, 768, 512)[0] == "sm90"


@pytest.mark.parametrize("causal", [False, True])
def test_k7_skipped_keys_carry_no_probability(causal):
    """What K7's Hopper kernels skip carries exactly zero probability in the
    twin: with a key the row may attend (bidirectional: a valid key; causal:
    key 0 valid), a masked key's probability is 0.0, so the tiles past the
    last valid key (and, causal, past the diagonal) add nothing; a row with
    none spreads its probability over masked keys, so nothing is skipped."""
    g = torch.Generator().manual_seed(3)
    b, t, e, heads = 4, 192, 128, 2
    valid = torch.rand(b, t, generator=g) < 0.5
    valid[0, 0], valid[0, 150:] = True, False  # skips past key 149
    valid[1, 0] = False                        # causal rows before its first
    valid[2] = False                           # valid key; no valid key
    q, k, v = (torch.randn(b, t, e, generator=g) * 2 for _ in range(3))
    p, *_ = es.attention_probs(q, k, v, valid, heads, causal)
    keys = torch.arange(t)
    for i in range(b):
        rows_ok = bool(valid[i, 0]) if causal else bool(valid[i].any())
        masked = ~valid[i][None, :].expand(t, t)
        if causal:
            masked = masked | (keys[None, :] > keys[:, None])
        zero = p[i][:, masked] == 0.0
        assert bool(zero.all()) == rows_ok, i
    last = int(valid[0].nonzero().max())
    assert not p[0][..., last + 1:].any()


@pytest.mark.parametrize("act,save", [("none", False), ("gelu", True),
                                      ("gelu_rounded", False),
                                      ("partial", False)])
def test_plain_twin_is_one_for_every_variant(act, save):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(130, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 128, generator=g).to(torch.bfloat16)
    b = None if act == "partial" else torch.randn(128, generator=g)
    want = lk.linear_bias_act.plain(x, w, b, act, None, save)
    for variant in ("sm90", "skinny", "wmma"):
        got = lk.linear_bias_act(x, w, b, act, None, save, variant=variant)
        if save:
            assert all(torch.equal(a, c) for a, c in zip(got, want))
        else:
            assert torch.equal(got, want)
    dy = torch.randn(130, 128, generator=g).to(torch.bfloat16)
    want_w, want_b = lb.linear_wgrad.plain(x, dy)
    for variant in ((3, 128), (1, 256), "wmma", None):
        dw, db = lb.linear_wgrad(x, dy, variant=variant)
        assert torch.equal(dw, want_w) and torch.equal(db, want_b)
    mul = torch.randn(130, 64, generator=g).to(torch.bfloat16)
    want_x = lb.linear_dgrad.plain(dy, w, mul=mul)
    for variant in ("sm90", "wmma", None):
        assert torch.equal(lb.linear_dgrad(dy, w, mul=mul, variant=variant),
                           want_x)
    qkv = torch.randn(2, 64, 3 * 64, generator=g).to(torch.bfloat16)
    q, k, v = qkv.split(64, dim=-1)
    d_o = torch.randn(2, 64, 64, generator=g).to(torch.bfloat16)
    valid = torch.ones(2, 64, dtype=torch.bool)
    want_a = ab.attention_bwd.plain(q, k, v, d_o, valid, 2, True)
    for variant in ab.VARIANTS:
        got = ab.attention_bwd(q, k, v, d_o, valid, 2, True, variant=variant)
        assert all(torch.equal(a, c) for a, c in zip(got, want_a))
    want_o = es.encoder_attention.plain(qkv.view(128, 192), valid, 2, True)
    for variant in es.VARIANTS:
        assert torch.equal(es.encoder_attention(qkv.view(128, 192), valid, 2,
                                                True, variant=variant), want_o)
    for op in (lk.linear_bias_act, lb.linear_dgrad, ab.attention_bwd,
               es.encoder_attention):
        assert op.launches == 0  # the twins launch nothing


def _k3_visited(valid_b, tq, tk, causal):
    """(Tq, Tk): the keys K3's Hopper kernel visits for each query row of an
    image, by its skip rule: blocks of 128 query rows (two warpgroups of 64,
    the last block of a Tq that is no multiple of 128 one), key tiles of 64;
    with the premise (bidirectional: a valid key; causal: key 0 valid) the
    tiles past the last valid key and, causal, past each warpgroup's
    diagonal are skipped."""
    on = bool(valid_b[0]) if causal else bool(valid_b.any())
    visit = torch.ones(tq, tk, dtype=torch.bool)
    if not on:
        return visit
    last = int(valid_b.nonzero().max())
    for q0 in range(0, tq, 128):
        n_wg = min(2, (tq - q0) // 64)
        n_kt = last // 64 + 1
        if causal:
            n_kt = min(n_kt, (q0 + n_wg * 64 - 1) // 64 + 1)
        for c in range(n_wg):
            r0 = q0 + 64 * c
            for kt in range(tk // 64):
                skip = kt >= n_kt or (causal and kt * 64 > r0 + 63)
                visit[r0:r0 + 64, kt * 64:(kt + 1) * 64] = not skip
    return visit


@pytest.mark.parametrize("causal,tk", [(False, 192), (True, 192),
                                       (False, 320)])
def test_k3_skipped_keys_carry_no_probability(causal, tk):
    """What K3's Hopper kernel skips (at its 128-row blocks, Tq = 192: one
    whole block and a half one) carries exactly zero probability in the
    twin, so the skips leave its output as it was; where the premise fails
    (key 0 masked under causal, no valid key) it skips nothing, and the
    twin's rows there spread their probability over masked keys."""
    g = torch.Generator().manual_seed(5)
    b, tq, e, heads = 5, 192, 128, 2
    valid = torch.rand(b, tk, generator=g) < 0.5
    valid[0, 0], valid[0, 100:] = True, False  # the last two tiles skipped
    valid[1, 0], valid[1, 63], valid[1, 64:] = False, True, False
    valid[2] = False                           # no valid key
    valid[3, 0] = True                         # scattered validity
    valid[4, :] = False
    valid[4, 0], valid[4, 130] = True, True    # one key past the first tiles
    q = torch.randn(b, tq, e, generator=g) * 2
    k, v = (torch.randn(b, tk, e, generator=g) * 2 for _ in range(2))
    p, *_ = es.attention_probs(q, k, v, valid, heads, causal)
    skipped_any = False
    for i in range(b):
        visit = _k3_visited(valid[i], tq, tk, causal)
        skipped_any |= bool((~visit).any())
        assert not p[i][:, ~visit].any(), i
        premise = bool(valid[i, 0]) if causal else bool(valid[i].any())
        if not premise:
            assert bool(visit.all())
            # the rows before the first valid key (causal) or all rows (no
            # valid key) spread their probability over masked keys
            first = int(valid[i].nonzero().min()) if valid[i].any() else tk
            for r in range(min(first, tq)) if causal else range(tq):
                assert bool((p[i][:, r, :r + 1 if causal else tk] > 0).all())
    assert skipped_any
