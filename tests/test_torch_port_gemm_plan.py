"""The plans that route the port's products: K1's variant (``gemm_plan``:
the Hopper core for the large-M products, the wmma kernel for the decode
rows), K9 ``linear_wgrad``'s row split (``row_split_plan``) and K9
``linear_dgrad``'s tile (``dgrad_plan``), at every shape of the port's paths
(PERF.md section 6); and the premise of K7's skipped tiles. Pure Python:
nothing here asks for the card. The plain twins answer the same for every
variant on CPU tensors (exactly: they are one function).
"""

import pytest
import torch

from acai_omr_tpu_torch.ops import attention_bwd_kernel as ab
from acai_omr_tpu_torch.ops import encoder_stack_kernel as es
from acai_omr_tpu_torch.ops import linear_bwd_kernel as lb
from acai_omr_tpu_torch.ops import linear_kernel as lk

# (M, K, N): the decode step (B = 32), beams (4 x 4), GRPO's rollouts
# (16 images x 8), the meshed decode's shards (column-parallel and the
# row-parallel fp32 partials)
DECODE = [(32, 1024, 3072), (32, 1024, 4096), (32, 4096, 1024),
          (16, 1024, 3072), (128, 1024, 3072), (128, 4096, 1024),
          (8, 1024, 1536), (8, 1024, 2048), (8, 512, 1024), (8, 2048, 1024),
          (8, 256, 1024), (8, 1024, 1024), (4, 512, 1024), (16, 2048, 1024)]
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


@pytest.mark.parametrize("m,k,n", DECODE)
def test_decode_rows_stay_on_wmma(m, k, n):
    assert lk.gemm_plan(m, n, k) == ("wmma", 64)


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
    assert lk.gemm_plan(lk.SKINNY_M, 1024, 1024)[0] == "wmma"
    assert lk.gemm_plan(lk.SKINNY_M + 1, 1024, 1024)[0] == "sm90"
    # a decode-sized product the wmma kernel cannot take goes to the core,
    # whose rule is TMA's (K and N multiples of 8)
    assert lk.gemm_plan(8, 72, 40)[0] == "sm90"


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
    for variant in ("sm90", "wmma"):
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
    for op in (lk.linear_bias_act, lb.linear_dgrad, ab.attention_bwd):
        assert op.launches == 0  # the twins launch nothing
