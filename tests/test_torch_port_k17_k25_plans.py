"""The plans and shape rules of K17 ``blockdiag_decode_attention`` on one
thread-block cluster a row (``blockdiag_plan``: the row's keys split across
the cluster in whole 16-key units, in order, none empty) and of K25
``head_logits`` on persistent blocks (``head_logits_schedule``: every tile of
every head once, ``lane_slice`` walking the heads innermost), the variants
both launchers take, and both twins against the JAX tools: K17's against
``tools/attn_microbench.blockdiag_attn`` in the Pallas interpreter with keys
masked by the bias, K25's against the JAX tool's own reference einsum.
Nothing here asks for the card: a build or a bind fails these tests.

Tolerances: K17's bf16 outputs within 2e-3 absolute of JAX's where they lie
below 0.5 (a weight rounded to bf16 on the other side of a tie moves an
output by under one bf16 ulp), and within 1e-2 of the row's largest output
in the two rows that attend a few keys (outputs up to about 4, whose bf16
ulp is 0.4-0.8 % of them: one rounding apart); K25's fp32 logits within
1e-5 of the largest |logit| (exact products, fp32 sums in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import head_logits_kernels as hk
from acai_omr_tpu_torch.ops import probe_kernels as pk
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS
from tools import attn_microbench as jax_attn

from _torch_port_threads import torch_one_thread  # noqa: F401

K17 = pk.blockdiag_decode_attention
K25 = hk.head_logits


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


def _k17_shapes(b, t, dh=64, int8=False):
    """K17's arguments at these shapes, as views of one element (the rules
    read shapes only)."""
    q = torch.zeros(1, dtype=torch.bfloat16).expand(b, 16, dh)
    cache = torch.zeros(1, dtype=torch.int8 if int8 else torch.bfloat16) \
        .expand(b, 16, dh, t)
    bias = torch.zeros(1).expand(b, t)
    scale = torch.zeros(1).expand(b, 16, t) if int8 else None
    return q, cache, cache, bias, scale, scale


# ---------------------------------------------------------------------------
# K17: the plan, the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [128, 256, 512, 1024])
@pytest.mark.parametrize("b", [1, 4, 32])
def test_blockdiag_plan_ranges(b, t, int8):
    """The plan's ranges are whole 16-key units, in order, none empty, and
    the largest is the plan's chunk; the split fits a portable cluster."""
    chunk, split = pk.blockdiag_plan(b, t, 64, int8)
    assert 1 <= split <= pk.BLOCKDIAG_MAX_SPLIT
    ranges = pk.blockdiag_ranges(t, split)
    assert ranges[0][0] == 0 and ranges[-1][1] == t
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(ranges, ranges[1:]))
    assert all(hi > lo and (hi - lo) % pk.BLOCKDIAG_UNIT == 0
               for lo, hi in ranges)
    assert max(hi - lo for lo, hi in ranges) == chunk


def test_blockdiag_plan_fills_the_card_and_weighs_the_cluster_launch():
    """At the microbench's B = 32, T = 512 the grid is 32 clusters of 8
    (256 blocks, where bt gave 4-16); once the rows alone fill the SMs the
    cluster launch's cost is not worth paying and split 1, an ordinary
    launch, is chosen; every range is whole 64-key boxes where T allows."""
    assert pk.blockdiag_plan(32, 512, 64) == (64, 8)
    assert pk.blockdiag_plan(32, 512, 64, True) == (64, 8)
    assert pk.blockdiag_plan(2 * N_SMS, 512, 64) == (512, 1)
    for b in (1, 4, 32):
        for t in (128, 256, 512, 1024):
            chunk, split = pk.blockdiag_plan(b, t, 64)
            assert all((hi - lo) % pk.BLOCKDIAG_BOX == 0
                       for lo, hi in pk.blockdiag_ranges(t, split))


def test_blockdiag_variants_on_the_cpu():
    """"wmma" and "split1" .. "split8" are taken (forced splits past T's
    units take fewer blocks), anything else refused before the twin runs;
    the twin's output does not depend on bt."""
    g = torch.Generator().manual_seed(17)
    b, t = 8, 128
    q = torch.randn(b, 16, 32, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, 16, 32, t, generator=g).to(torch.bfloat16)
            for _ in range(2))
    bias = torch.zeros(b, t)
    want = K17(q, k, v, bias, bt=1)
    for bt in (2, 4, 8):
        assert torch.equal(K17(q, k, v, bias, bt=bt), want)
    for variant in ("wmma", "split1", "split3", "split8"):
        assert torch.equal(K17(q, k, v, bias, bt=4, variant=variant), want)
    assert pk.blockdiag_split("split8", b, t, 32) == (16, 8)
    assert pk.blockdiag_split("split8", b, 1024, 32) == (128, 8)
    assert pk.blockdiag_split("wmma", b, t, 32) is None
    for bad in ("simt", "split0", "split9", "splitx", "bn64"):
        with pytest.raises(ValueError, match="unknown variant"):
            K17(q, k, v, bias, bt=4, variant=bad)
    with pytest.raises(ValueError, match="bt"):
        K17(q, k, v, bias, bt=3, variant="split2")


def test_blockdiag_refuses_what_a_block_cannot_hold():
    """A head dim whose logits, weights, q and partials leave no room for
    two stages of the ring at split 1 is refused; T outside BLOCKDIAG_KEYS
    as before."""
    with pytest.raises(ValueError, match="shared memory"):
        K17(*_k17_shapes(4, 1024, dh=624), variant="split1")
    assert pk.blockdiag_split("split1", 4, 1024, 608) == (1024, 1)
    with pytest.raises(ValueError, match="T in"):
        K17(*_k17_shapes(4, 96), bt=4)


# ---------------------------------------------------------------------------
# K17's twin against JAX's blockdiag_attn, keys masked by the bias
# ---------------------------------------------------------------------------

def _masked_bias() -> np.ndarray:
    """(B, T) fp32 at the JAX script's shapes: a fifth of the keys masked at
    -1e9 (key 0 never); rows 0 and 1 keep only keys in the last range of the
    plan's split, row 1 only one."""
    rng = np.random.default_rng(19)
    bias = np.where(rng.random((jax_attn.B, jax_attn.T)) < 0.2, -1e9, 0.0)
    bias[:, 0] = 0.0
    _, split = pk.blockdiag_plan(jax_attn.B, jax_attn.T, jax_attn.DH)
    lo, hi = pk.blockdiag_ranges(jax_attn.T, split)[-1]
    assert lo > 0
    bias[0] = -1e9
    bias[0, lo + 3:hi:5] = 0.0
    bias[1] = -1e9
    bias[1, hi - 1] = 0.0
    return bias.astype(np.float32)


@pytest.fixture(scope="module")
def masked_jax():
    """JAX's blockdiag_attn in the interpreter, bf16 at bt 8 and int8 at bt
    4, on the script's inputs with the masked bias; and those inputs."""
    bias = jnp.asarray(_masked_bias())
    interp = functools.partial(pl.pallas_call, interpret=True)
    orig, pl.pallas_call = pl.pallas_call, interp
    try:
        out = {}
        for cache, bt in (("bf16", 8), ("int8", 4)):
            args = list(jax_attn.make_inputs(
                jnp.bfloat16 if cache == "bf16" else jnp.int8))
            args[3] = bias
            out[cache] = (args, bt, jax_attn.blockdiag_attn(*args, bt=bt))
    finally:
        pl.pallas_call = orig
    return out


def _torch(x):
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))) \
            .to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_blockdiag_twin_matches_jax_with_masked_keys(masked_jax, cache):
    args, bt, want = masked_jax[cache]
    got = K17(*[_torch(a) for a in args], bt=bt).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(want).all()
    err = np.abs(got - want).max(axis=(1, 2))
    assert err[2:].max() <= 2e-3, err
    assert (err[:2] <= 1e-2 * np.abs(want[:2]).max(axis=(1, 2))).all(), err
    # row 1 attends one key: its output is that key's values (int8: times
    # the weight's bf16 value scale), rounded once
    v1 = _torch(args[2])[1, :, :, -1].float()
    if cache == "int8":
        v1 = v1 * _torch(args[5])[1, :, -1:].to(torch.bfloat16).float()
    assert np.array_equal(got[1], v1.to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# K25: the persistent blocks' tiles, the variants, the twin against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [1, 12, 16])
@pytest.mark.parametrize("t", [64, 320, 1024])
def test_head_logits_schedule_covers_every_tile_once(t, h):
    nq, nk = t // hk.TILE_Q, -(-t // hk.TILE_K)
    every = sorted((hh, qt * hk.TILE_Q, kt * hk.TILE_K) for hh in range(h)
                   for qt in range(nq) for kt in range(nk))
    blocks = hk.head_logits_blocks(t, h)
    assert blocks == min(len(every), hk.BLOCKS_PER_SM * N_SMS)
    for form in hk.FORMS:
        sched = hk.head_logits_schedule(t, h, form)
        assert len(sched) == blocks and all(sched)
        flat = [tile for block in sched for tile in block]
        assert sorted(flat) == every
        # the order: lane_slice steps the head first, the others last
        for i, (hh, q0, k0) in enumerate(flat):
            if form == "lane_slice":
                assert (hh, k0 // hk.TILE_K, q0 // hk.TILE_Q) == (
                    i % h, i // h % nk, i // h // nk)
            else:
                assert (k0 // hk.TILE_K, q0 // hk.TILE_Q, hh) == (
                    i % nk, i // nk % nq, i // nk // nq)


def test_head_logits_lane_slice_blocks_cover_heads_of_one_tile():
    """With more tiles than blocks, a lane_slice block's consecutive tiles
    are the heads of the same query and key rows (k1 loops over heads);
    a reshape block's, the key tiles of one head."""
    t, h = 1024, 12
    for block in hk.head_logits_schedule(t, h, "lane_slice")[:8]:
        assert len(block) > 1
        for (h0, q0, k0), (h1, q1, k1) in zip(block, block[1:]):
            assert h1 == h0 + 1 or (h1 == 0 and h0 == h - 1)
            if h1 == h0 + 1:
                assert (q1, k1) == (q0, k0)
    for block in hk.head_logits_schedule(t, h, "reshape")[:8]:
        assert len({hh for hh, _, _ in block}) <= 2


def test_head_logits_variants_on_the_cpu():
    q = torch.randn(64, 128).to(torch.bfloat16)
    want = K25(q, q, "reshape", 2)
    assert torch.equal(K25(q, q, "reshape", 2, variant="wmma"), want)
    with pytest.raises(ValueError, match="unknown variant"):
        K25(q, q, "reshape", 2, variant="split2")


def test_head_logits_twin_matches_the_jax_reference():
    """At T = 320 (five query tiles, a masked 64-key edge tile) and H = 12:
    the JAX tool's reference, jnp.einsum("htd,hsd->hts") on the (H, T, 64)
    views, against the twin in every form."""
    t, h, dh = 320, 12, hk.DH
    rng = np.random.default_rng(25)
    q = jnp.asarray(rng.standard_normal((t, h * dh)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((t, h * dh)), jnp.bfloat16)
    qh = np.asarray(q, np.float32).reshape(t, h, dh).transpose(1, 0, 2)
    kh = np.asarray(k, np.float32).reshape(t, h, dh).transpose(1, 0, 2)
    want = np.asarray(jnp.einsum("htd,hsd->hts", jnp.asarray(qh),
                                 jnp.asarray(kh)))
    tq, tk = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
              for a in (q, k))
    tol = 1e-5 * np.abs(want).max()
    for form in hk.FORMS:
        a, b = (hk.as_heads(tq, h).contiguous(), hk.as_heads(tk, h)
                .contiguous()) if form == "preshaped" else (tq, tk)
        got = K25(a, b, form, h)
        assert got.dtype == torch.float32 and got.shape == (h, t, t)
        assert np.abs(got.numpy() - want).max() <= tol
