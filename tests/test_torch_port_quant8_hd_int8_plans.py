"""The plans and shape rules of K5 ``quant_linear_bias_act`` on its cluster
kernel (``quant_linear_kernel.quant8_plan``: K split across a thread-block
cluster, 64 or 128 columns a block) and of K12 ``decode_attention_hd_int8``
on its cluster kernel (the keys of a (row, head) split as
``decode_kernel.decode_attention_int8_plan`` says), the variants both
launchers take, the monolith step's gate reading K5's rule, and the per-op
step asking ``hd_takes`` before K12. Pure Python apart from one JAX
reference decode: nothing here asks for the card, and a build or a bind
fails these tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_monolith

from acai_omr_tpu_torch.models import decode
from acai_omr_tpu_torch.models.omr_decoder import (DecoderConfig,
                                                   init_decoder_params)
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
from acai_omr_tpu_torch.ops import decode_kernel as dk
from acai_omr_tpu_torch.ops import quant_linear_kernel as qk

from _torch_port_threads import torch_one_thread  # noqa: F401

K12 = hd.decode_attention_hd_int8

CUDA = torch.device("cuda")
BF16, I8 = torch.bfloat16, torch.int8
# the W8A8 products of the decode step at the flagship's widths (qkv, self /
# cross out and cross q, ff1, ff2), a tp = 2 rank's (column-parallel qkv /
# ff1, the partials' K of 512 / 2,048) and a tp = 4 rank's, a small model's
PRODUCTS = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
            (1024, 1536), (1024, 2048), (512, 1024), (2048, 1024),
            (256, 1024), (128, 128), (8192, 1024)]
# the rows the W8A8 paths run: 4 (int8 after compaction), 8 (int8, the
# tp2_int8_w8a8 shards), 16 (beam_int8: 4 images x 4 beams), 32 (B = 32)
ROWS = [1, 4, 8, 16, 32, 70, 128]


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


@pytest.mark.parametrize("k,n", PRODUCTS)
@pytest.mark.parametrize("m", ROWS)
def test_quant8_plan_splits_k_in_order_over_one_cluster(m, k, n):
    """K5's ranges: multiples of 128, at most 1,024 k a block, in order,
    none empty, covering K; a cluster of at most 8; 128 columns a block;
    at least half the SMs with a block where the tiles and a cluster of 8
    reach them (whole ranges of k-steps), and no wider than about
    Q8_BLOCKS_PER_SM blocks an SM needs."""
    k_chunk, split, bn = qk.quant8_plan(m, n, k)
    steps = k // qk.Q4_KSTEP
    assert bn == qk.Q8_BN and n % bn == 0
    assert k_chunk % qk.Q4_KSTEP == 0 and 0 < k_chunk <= qk.Q4_MAX_CHUNK
    assert 1 <= split <= qk.Q4_MAX_SPLIT
    assert k_chunk * (split - 1) < k <= k_chunk * split
    tiles = n // bn * -(-m // qk.Q4_ROWS)
    assert 2 * tiles * split >= min(qk.N_SMS,
                                    tiles * min(qk.Q4_MAX_SPLIT, steps))
    assert split <= max(-(-qk.Q8_BLOCKS_PER_SM * qk.N_SMS // tiles),
                        -(-steps // qk.Q4_STAGES))


@pytest.mark.parametrize("m,k,n,want", [
    (32, 1024, 3072, (256, 4, 128)),  # qkv at B = 32: 24 tiles x 4
    (32, 1024, 4096, (256, 4, 128)),  # ff1
    (32, 4096, 1024, (512, 8, 128)),  # ff2: 8 tiles x 8
    (32, 1024, 1024, (128, 8, 128)),  # self / cross out, cross q
    (4, 1024, 3072, (256, 4, 128)),   # int8 after compaction
    (4, 1024, 1024, (128, 8, 128)),
    (4, 4096, 1024, (512, 8, 128)),
    (8, 1024, 1536, (128, 8, 128)),   # a tp = 2 rank's qkv / ff1
    (8, 1024, 2048, (128, 8, 128)),
    (8, 512, 1024, (128, 4, 128)),    # its partials
    (8, 2048, 1024, (256, 8, 128)),
    (16, 1024, 3072, (256, 4, 128)),  # beams: 4 images x 4 beams
    (128, 4096, 1024, (896, 5, 128)),
])
def test_quant8_plan_at_the_paths_shapes(m, k, n, want):
    assert qk.quant8_plan(m, n, k) == want


def test_quant8_takes_k_within_one_cluster():
    """K5's cluster kernel takes K <= 8 x 1,024 (its rows in shared
    memory); the plan refuses past it, where the three-launch form (any K)
    still runs; K and N multiples of 128 on every form."""
    for k, n in ((1024, 64), (1000, 1024), (16384, 1024), (8320, 1024)):
        assert not qk.quant8_takes(k, n)
        with pytest.raises(ValueError, match="quant_linear_bias_act takes"):
            qk.quant8_plan(8, n, k)
    assert qk.quant8_takes(8192, 1024) and qk.quant_takes(16384, 1024)
    assert qk.quant8_split("simt", 8, 1024, 16384) is None
    assert qk.quant8_plan(8, 1024, 8192) == (1024, 8, 128)


@pytest.mark.parametrize("variant,want", [
    (None, (256, 4, 128)), ("split1", (1024, 1, 128)),
    ("split3", (384, 3, 128)), ("split8", (128, 8, 128)),
    ("bn64", (384, 3, 64)), ("bn128", (256, 4, 128)),
    ("bn64_split2", (512, 2, 64)), ("bn128_split4", (256, 4, 128)),
])
def test_quant8_variants(variant, want):
    """``variant`` forces the split, the columns a block, or both."""
    assert qk.quant8_split(variant, 32, 3072, 1024) == want


@pytest.mark.parametrize("variant", ["split", "split0", "split9", "bn96",
                                     "bn", "bn64_", "bn64_wide", "wmma",
                                     "partial"])
def test_quant8_refuses_an_unknown_variant(variant):
    with pytest.raises(ValueError, match="unknown variant"):
        qk.quant8_split(variant, 32, 3072, 1024)


def test_forced_splits_keep_a_block_within_its_shared_memory():
    """A forced split that leaves a block more than 1,024 k is refused, on
    both launchers; a split past the k-steps takes fewer blocks."""
    for split_of in (lambda v: qk.quant8_split(v, 8, 1024, 4096),
                     lambda v: qk.quant4_split(v, 8, 1024, 4096)):
        with pytest.raises(ValueError, match="more than 1024"):
            split_of("split2")
        assert split_of("split4")[:2] == (1024, 4)
    assert qk.quant8_split("bn128_split8", 8, 1024, 256)[:2] == (128, 2)
    assert qk.quant4_split("split8", 8, 1024, 256) == (128, 2)


@pytest.mark.parametrize("variant,want", [
    (None, (256, 4)), ("split2", (512, 2)), ("simt", None)])
def test_quant4_variants(variant, want):
    assert qk.quant4_split(variant, 32, 3072, 1024) == want


@pytest.mark.parametrize("variant", ["split0", "bn64", "split9", "wmma"])
def test_quant4_refuses_an_unknown_variant(variant):
    with pytest.raises(ValueError, match="unknown variant"):
        qk.quant4_split(variant, 32, 3072, 1024)


@pytest.mark.parametrize("act", ["none", "gelu", "gelu_rounded", "partial"])
@pytest.mark.parametrize("variant", [None, "simt", "split2", "bn128"])
def test_k5_plain_twin_is_one_for_every_variant(act, variant):
    """On CPU tensors every variant of K5 is the plain twin."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(5, 256, generator=g)
    w8 = torch.randint(-127, 128, (256, 128), generator=g, dtype=torch.int8)
    s = torch.rand(128, generator=g) * 1e-3 + 1e-4
    b = None if act == "partial" else torch.randn(128, generator=g)
    w4 = qk.pack_k4(w8)
    assert torch.equal(
        qk.quant_linear_bias_act(x, w4, s, b, act, variant=variant),
        qk.quant_linear_bias_act.plain(x, w4, s, b, act))


# the monolith step's gate under W8A8 (int8 caches, ACAI_W8A8_DECODE on)
@pytest.mark.parametrize("args,want", [
    # the flagship decoder: greedy over a memory of 1,024, beams
    ((1024, 16, 4096, I8, BF16, 1536, 1024, CUDA), True),
    ((1024, 16, 4096, I8, BF16, 512, 1024, CUDA, 4), True),
    # tp = 2 shards under ACAI_TP_W8A8: K 512 / 2,048 partials
    ((1024, 16, 4096, I8, BF16, 512, 1024, CUDA, 1, 2), True),
    # ff2's K = F past 8 x 1,024: K5's cluster kernel refuses it
    ((1024, 16, 16384, I8, BF16, 512, 1024, CUDA), False),
    ((1024, 16, 10240, I8, BF16, 512, 1024, CUDA), False),
])
def test_monolith_takes_reads_k5_rule(args, want, monkeypatch):
    prev = (dk._W8A8, dk._W4A8, dk._TP_W8A8)
    seen = []
    rule = qk.quant8_takes
    monkeypatch.setattr(dk, "quant8_takes",
                        lambda k, n: seen.append((k, n)) or rule(k, n))
    try:
        dk.set_w8a8(True)
        dk.set_w4a8(False)
        dk.set_tp_w8a8(True)
        assert dk.weight_quant_mode(I8, len(args) > 9 and args[9] > 1) \
            == "int8"
        assert dk.monolith_takes(*args) is want
        assert seen  # the gate asked K5's rule
    finally:
        dk.set_w8a8(prev[0])
        dk.set_w4a8(prev[1])
        dk.set_tp_w8a8(prev[2])


# ---------------------------------------------------------------- K12

def _planes(b=3, h=4, dh=16, t=200, layers=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    lead = () if layers is None else (layers,)
    q = torch.randn(b, h, dh, generator=g)
    kT, vT = (torch.randint(-127, 128, lead + (b, h, dh, t), generator=g,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(lead + (b, h, t), generator=g) * 3e-2 + 2e-3
              for _ in range(2))
    bias = torch.zeros(b, t)
    bias[1, t // 3:] = -1e9
    return q, kT, vT, ks, vs, bias


@pytest.mark.parametrize("rows,heads,n_keys,want", [
    (4, 16, 1024, (128, 8)),    # the per-op step's 4 rows over M = 1,024
    (8, 16, 1024, (256, 4)),
    (32, 16, 1024, (512, 2)),   # B = 32
    (32, 16, 300, (304, 1)),
])
def test_k12_takes_k6s_plan(rows, heads, n_keys, want):
    """K12 splits the keys as K6's plan does (int8 planes: about
    ATTN_INT8_BLOCKS_PER_SM blocks an SM)."""
    q = torch.zeros(rows, heads, 64)
    kT = torch.zeros(rows, heads, 64, n_keys, dtype=torch.int8)
    ks = torch.zeros(rows, heads, n_keys)
    assert hd._check_hd_int8(q, kT, kT, ks, ks) == want \
        == dk.decode_attention_int8_plan(rows, heads, n_keys)


def test_k12_variants_and_key_limits():
    """``split{s}`` forced (fewer blocks where the keys are fewer units),
    ``simt`` None; an unknown variant refused. The cluster kernel's limit is
    the plan's (keys past what eight blocks hold are refused), the simt
    kernel keeps every logit of a row in one block (MAX_KEYS)."""
    q, kT, vT, ks, vs, bias = _planes(b=2, h=2, t=40)
    assert hd._check_hd_int8(q, kT, vT, ks, vs, bias, variant="split8") \
        == (16, 3)
    assert hd._check_hd_int8(q, kT, vT, ks, vs, variant="split2") == (32, 2)
    assert hd._check_hd_int8(q, kT, vT, ks, vs, variant="simt") is None
    for v in ("split0", "split9", "wmma", "layer_split2"):
        with pytest.raises(ValueError, match="unknown variant"):
            hd._check_hd_int8(q, kT, vT, ks, vs, variant=v)
    most = dk._units_a_block(1, True) * dk.ATTN_UNIT * dk.ATTN_MAX_SPLIT
    big = lambda t: (torch.zeros(1, 1, 16), torch.zeros(1, 1, 16, t,
                                                        dtype=torch.int8),
                     torch.zeros(1, 1, t))
    qb, kb, sb = big(most + 16)
    assert hd._check_hd_int8(qb, kb, kb, sb, sb, n_keys=most) == (
        most // dk.ATTN_MAX_SPLIT, dk.ATTN_MAX_SPLIT)
    with pytest.raises(ValueError, match="do not fit"):
        hd._check_hd_int8(qb, kb, kb, sb, sb)
    with pytest.raises(ValueError, match="shared memory"):
        hd._check_hd_int8(qb, kb, kb, sb, sb, variant="simt")
    assert most > hd.MAX_KEYS  # the cluster holds more than one block


def test_k12_refuses_bad_shapes_on_the_cpu():
    q, kT, vT, ks, vs, bias = _planes(layers=3)
    bad = [
        lambda: hd.decode_attention_hd_int8(q, kT, vT, ks, vs, bias,
                                            layer=3),
        lambda: hd.decode_attention_hd_int8(q, kT, vT[:2], ks, vs, bias,
                                            layer=0),
        lambda: hd.decode_attention_hd_int8(q, kT, vT, ks[..., :9], vs,
                                            bias, layer=0),
        lambda: hd.decode_attention_hd_int8(q, kT[0], vT[0], ks[0], vs[0],
                                            bias[:, :9]),
        lambda: hd.decode_attention_hd_int8(q, kT[0], vT[0], ks[0], vs[0],
                                            n_keys=201),
        lambda: hd.decode_attention_hd_int8(q, kT, vT, ks, vs, bias),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("variant", [None, "simt", "split1", "split4"])
@pytest.mark.parametrize("stacked", [False, True])
def test_k12_plain_twin_is_one_for_every_variant(variant, stacked):
    q, kT, vT, ks, vs, bias = _planes(layers=3 if stacked else None)
    kw = {"layer": 2} if stacked else {}
    assert torch.equal(
        hd.decode_attention_hd_int8(q, kT, vT, ks, vs, bias, variant=variant,
                                    **kw),
        hd.decode_attention_hd_int8.plain(q, kT, vT, ks, vs, bias, **kw))


def _as_on_the_card(monkeypatch):
    """``hd_takes`` answering as on a CUDA device, and K12's wrapper
    recording its calls (the twin computes them)."""
    rule = hd.hd_takes
    monkeypatch.setattr(hd, "hd_takes", lambda dh, device: rule(dh, CUDA))
    calls = []

    def record(*args, **kwargs):
        calls.append(kwargs.get("layer"))
        return K12(*args, **kwargs)
    monkeypatch.setattr(hd, "decode_attention_hd_int8", record)
    return calls


@pytest.mark.parametrize("dh,kernel", [(48, False), (64, True), (16, True)])
def test_decode_attention_asks_hd_takes_for_int8_planes(dh, kernel,
                                                        monkeypatch):
    """``decode_attention`` over int8 planes: on a CUDA device a head dim
    outside HD_DHS takes the plain path, decided before any launch; inside
    it, K12. Either way the result is the plain path's within the rounding
    of its weights (fp32 here: none)."""
    assert hd.hd_takes(dh, CUDA) is kernel and hd.hd_takes(dh, "cpu")
    calls = _as_on_the_card(monkeypatch)
    prev = hd._ENABLED_INT8
    hd.set_enabled_int8(True)
    try:
        q, kT, vT, ks, vs, bias = _planes(dh=dh)
        got = decode.decode_attention(q, kT, vT, bias, torch.float32, ks, vs)
    finally:
        hd.set_enabled_int8(prev)
    assert calls == ([None] if kernel else [])
    want = K12.plain(q, kT, vT, ks, vs, bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


B, M, STEPS = 2, 8, 10
WIDTHS = dict(hidden_dim=768, num_heads=16, mlp_dim=256)  # head dim 48


def _cfg():
    return dict(max_lmx_seq_len=32, vocab_size=33, num_layers=1, eos_idx=2,
                **WIDTHS)


def test_per_op_int8_generate_at_dh48_takes_the_plain_cross_path(
        monkeypatch):
    """The per-op int8 step at head dim 48 with ``hd_takes`` answering as
    on the card: the stacked cross-attention never reaches K12 (the plain
    path instead, as JAX's ``use_pallas`` falls back), and ``generate``
    returns JAX's tokens (its CPU decode takes its per-op step's plain
    path). Tokens exact; log-probs 1e-3 (int8 caches, as
    tests/test_torch_port_f6_gate.py)."""
    pcfg = DecoderConfig(**_cfg())
    pparams = init_decoder_params(torch.Generator().manual_seed(0), pcfg)
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((B, M, WIDTHS["hidden_dim"])) \
        .astype(np.float32)
    valid = np.arange(M)[None, :] < np.array([M, 5])[:, None]
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    try:
        jparams = _unflatten({k: jnp.asarray(v.numpy())
                              for k, v in _flatten(pparams).items()})
        js, jl, jm = (np.asarray(a) for a in jax_decode.generate(
            jparams, JaxDecoderConfig(**_cfg()), jnp.asarray(latent),
            jnp.asarray(valid), max_len=STEPS, initial_segment=STEPS,
            compute_dtype=jnp.float32, cache_dtype=jnp.int8))
    finally:
        pallas_monolith.set_test_mode(*prev)
    calls = _as_on_the_card(monkeypatch)
    before = (dk._ENABLED, hd._ENABLED_INT8)
    dk.set_enabled(False)
    hd.set_enabled_int8(True)
    try:
        ps, pl, pm = (a.numpy() for a in decode.generate(
            pparams, pcfg, torch.from_numpy(latent), torch.from_numpy(valid),
            max_len=STEPS, initial_segment=STEPS, compute_dtype=torch.float32,
            cache_dtype=torch.int8))
    finally:
        dk.set_enabled(before[0])
        hd.set_enabled_int8(before[1])
    assert calls == []
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-3)


def test_per_op_int8_step_reaches_k12_stacked_where_it_takes_the_head_dim(
        monkeypatch):
    """The same step at head dim 16 (inside HD_DHS): the stacked
    cross-attention is K12, once a layer and step, reading layer i."""
    cfg = DecoderConfig(max_lmx_seq_len=32, vocab_size=33, num_layers=2,
                        hidden_dim=64, num_heads=4, mlp_dim=128, eos_idx=2)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    latent = torch.from_numpy(rng.standard_normal((B, M, 64))
                              .astype(np.float32))
    valid = torch.from_numpy(np.arange(M)[None, :]
                             < np.array([M, 5])[:, None])
    calls = _as_on_the_card(monkeypatch)
    before = (dk._ENABLED, hd._ENABLED_INT8)
    dk.set_enabled(False)
    hd.set_enabled_int8(True)
    try:
        seqs = decode.generate(params, cfg, latent, valid, max_len=4,
                               initial_segment=4, compute_dtype=torch.float32,
                               cache_dtype=torch.int8)[0]
    finally:
        dk.set_enabled(before[0])
        hd.set_enabled_int8(before[1])
    assert seqs.shape[0] == B
    assert calls and set(calls) == {0, 1} and len(calls) % 2 == 0
