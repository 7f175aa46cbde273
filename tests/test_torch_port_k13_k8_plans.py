"""The plans and shape rules of K13 ``self_attention_append_int8`` on K12's
cluster kernel (the ``pos`` cached keys of a (row, head) split as
``decode_kernel.decode_attention_int8_plan`` splits K12's) and of K8
``layernorm_bwd`` in one launch (``layernorm_bwd_plan``: the blocks, their
rows, the groups whose partials are summed behind integer tickets), the
variants both launchers take, the per-op int8 step asking ``hd_takes``
before K13, and K8's twin against JAX's ``_ln_bwd``. Nothing here asks for
the card: a build or a bind fails these tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.ops import pallas_train_layer as ptl

from acai_omr_tpu_torch.models import decode
from acai_omr_tpu_torch.models.omr_decoder import (DecoderConfig,
                                                   init_decoder_params)
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
from acai_omr_tpu_torch.ops import decode_kernel as dk
from acai_omr_tpu_torch.ops import dropout_kernel as drop_k
from acai_omr_tpu_torch.ops import layernorm_bwd_kernel as lk
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS

K13 = hd.self_attention_append_int8
K8 = lk.layernorm_bwd
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


def _append_shapes(rows, pos, heads=16, dh=64, t=512, layers=1):
    """K13's arguments at these shapes, as views of one element (the rules
    read shapes only)."""
    q = torch.zeros(1).expand(rows, heads, dh)
    cache = torch.zeros(1, dtype=torch.int8).expand(layers, rows, heads, dh,
                                                    t)
    scale = torch.zeros(1).expand(layers, rows, heads, t)
    return q, q, q, cache, cache, scale, scale, 0, pos


def _ranges(n_keys, chunk, split):
    """The key ranges of a cluster's blocks, as the cluster kernel forms
    them (csrc/hd_int8_cluster.cuh): whole 16-key units, block r owning
    units [r U / split, (r + 1) U / split)."""
    units = -(-n_keys // dk.ATTN_UNIT)
    out = []
    for r in range(split):
        lo = min(n_keys, r * units // split * dk.ATTN_UNIT)
        hi = min(n_keys, (r + 1) * units // split * dk.ATTN_UNIT)
        out.append((lo, hi))
    return out


@pytest.mark.parametrize("pos", [0, 1, 15, 16, 300, 511])
@pytest.mark.parametrize("rows", [4, 8, 32])
def test_k13_splits_its_keys_as_k12(rows, pos):
    """The per-op step's 4 and 8 rows (after compaction) and B = 32, 16
    heads, at the first, unit-edge and late positions of a 512-slot cache:
    the pos cached keys split as K12's plan splits them, in order, none
    empty, within the plan's keys a block; pos 0 one block of no key."""
    chunk, split = hd._check_append(*_append_shapes(rows, pos))
    if pos == 0:
        assert (chunk, split) == (dk.ATTN_UNIT, 1)
        return
    assert (chunk, split) == dk.decode_attention_int8_plan(rows, 16, pos)
    ranges = _ranges(pos, chunk, split)
    assert ranges[0][0] == 0 and ranges[-1][1] == pos
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:] + [(pos, None)]):
        assert lo < hi == lo2 and hi - lo <= chunk


@pytest.mark.parametrize("variant", ["simt", "split1", "split2", "split4",
                                     "split8", None])
def test_k13_takes_its_variants_on_the_cpu(variant):
    """Every variant runs the one twin on CPU tensors, and writes the same
    column."""
    g = torch.Generator().manual_seed(0)
    q, kn, vn = (torch.randn(2, 4, 16, generator=g) for _ in range(3))
    kc = torch.randint(-127, 128, (2, 2, 4, 16, 40), generator=g,
                       dtype=torch.int8)
    ks = torch.rand(2, 2, 4, 40, generator=g) + 0.01
    caches = [kc, kc.clone(), ks, ks.clone()]
    twin = [a.clone() for a in caches]
    got = K13(q, kn, vn, *caches, 1, 33, variant=variant)
    assert torch.equal(got, K13.plain(q, kn, vn, *twin, 1, 33))
    assert all(torch.equal(a, b) for a, b in zip(caches, twin))


@pytest.mark.parametrize("variant", ["split9", "split0", "warps4", "cluster"])
def test_k13_refuses_unknown_variants_on_the_cpu(variant):
    with pytest.raises(ValueError, match="unknown variant"):
        K13(*_append_shapes(2, 7, heads=4, dh=16, t=40), variant=variant)


def test_k13_refuses_bad_shapes_on_the_cpu():
    q, kn, vn, kc, vc, ks, vs, layer, _ = _append_shapes(2, 0, heads=4,
                                                         dh=16, t=40,
                                                         layers=2)
    bad = [(q, kn, vn, kc, vc, ks, vs, 2, 5),   # no layer 2
           (q, kn, vn, kc, vc, ks, vs, 0, 40),  # pos past the cache
           (q, kn[:1], vn, kc, vc, ks, vs, 0, 5),
           (q, kn, vn, kc, vc, ks[..., :39], vs, 0, 5)]
    for args in bad:
        with pytest.raises(ValueError, match="shape mismatch"):
            K13(*args)


# --------------------------------------------------------------------------
# the per-op int8 step asks hd_takes before K13
# --------------------------------------------------------------------------

B, M, STEPS = 2, 8, 10
WIDE = dict(max_lmx_seq_len=32, vocab_size=33, num_layers=1, eos_idx=2,
            hidden_dim=768, num_heads=16, mlp_dim=256)  # head dim 48


@pytest.fixture(scope="module")
def dh48_decode():
    """JAX's int8 decode at head dim 48 on the CPU (its per-op step's
    plain path), and the port's parameters and memory for it."""
    params = init_decoder_params(torch.Generator().manual_seed(0),
                                 DecoderConfig(**WIDE))
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((B, M, WIDE["hidden_dim"])) \
        .astype(np.float32)
    valid = np.arange(M)[None, :] < np.array([M, 5])[:, None]
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    try:
        jparams = _unflatten({k: jnp.asarray(v.numpy())
                              for k, v in _flatten(params).items()})
        want = [np.asarray(a) for a in jax_decode.generate(
            jparams, JaxDecoderConfig(**WIDE), jnp.asarray(latent),
            jnp.asarray(valid), max_len=STEPS, initial_segment=STEPS,
            compute_dtype=jnp.float32, cache_dtype=jnp.int8)]
    finally:
        pallas_monolith.set_test_mode(*prev)
    return params, latent, valid, want


def _on_the_card(monkeypatch):
    """``hd_takes`` answering as on a CUDA device, K13's calls recorded
    (the twin computes them) and the steps counted."""
    rule = hd.hd_takes
    monkeypatch.setattr(hd, "hd_takes", lambda dh, device: rule(dh, CUDA))
    box = {"k13": [], "steps": 0}

    def record(*args, **kwargs):
        box["k13"].append(args[7])  # the layer
        return K13(*args, **kwargs)
    monkeypatch.setattr(hd, "self_attention_append_int8", record)
    inner = decode.step_logits

    def step(*args, **kwargs):
        box["steps"] += 1
        return inner(*args, **kwargs)
    monkeypatch.setattr(decode, "step_logits", step)
    return box


def _generate_int8(params, cfg, latent, valid, steps):
    before = (dk._ENABLED, hd._ENABLED_INT8)
    dk.set_enabled(False)  # the per-op step
    hd.set_enabled_int8(True)
    try:
        return [a.numpy() for a in decode.generate(
            params, cfg, torch.from_numpy(latent), torch.from_numpy(valid),
            max_len=steps, initial_segment=steps,
            compute_dtype=torch.float32, cache_dtype=torch.int8)]
    finally:
        dk.set_enabled(before[0])
        hd.set_enabled_int8(before[1])


def test_per_op_int8_generate_at_dh48_never_calls_k13(dh48_decode,
                                                      monkeypatch):
    """Head dim 48 with ``hd_takes`` answering as on the card: the
    self-attention takes the plain path (quantize, write, attend), as JAX's
    ``use_pallas`` falls back, and ``generate`` returns JAX's tokens. Tokens
    and mask exact; log-probs 1e-3 (int8 caches, as
    tests/test_torch_port_f6_gate.py)."""
    params, latent, valid, (js, jl, jm) = dh48_decode
    box = _on_the_card(monkeypatch)
    ps, pl, pm = _generate_int8(params, DecoderConfig(**WIDE), latent, valid,
                                STEPS)
    assert box["k13"] == [] and box["steps"] > 0
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-3)


def test_per_op_int8_step_calls_k13_once_a_layer_and_step_at_dh16(
        monkeypatch):
    """Head dim 16 (inside HD_DHS): the self-attention is K13, once a layer
    and a step, reading and writing layer i."""
    cfg = DecoderConfig(max_lmx_seq_len=32, vocab_size=33, num_layers=2,
                        hidden_dim=64, num_heads=4, mlp_dim=128, eos_idx=2)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    latent = rng.standard_normal((B, M, 64)).astype(np.float32)
    valid = np.arange(M)[None, :] < np.array([M, 5])[:, None]
    box = _on_the_card(monkeypatch)
    seqs = _generate_int8(params, cfg, latent, valid, 4)[0]
    assert seqs.shape[0] == B and box["steps"] > 0
    assert box["k13"] == [0, 1] * box["steps"]


# --------------------------------------------------------------------------
# K8: the one-pass plan, its variants, its twin against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,e", [(2048, 1024), (8192, 768), (32768, 512),
                                    (8192, 512), (1, 512), (37, 768),
                                    (300, 1024), (257, 128), (640, 256)])
def test_k8_plan_covers_every_row_once_in_one_wave(rows, e):
    """The stage-2 decoder's and encoder's rows, the MAE's, and ragged row
    counts: at least one row a block and LNB_WARPS rows a block where the
    rows allow, no more blocks than the SMs hold at once (two an SM up to
    LNB_WIDE_E columns, one past it), each block's contiguous rows as the
    kernel forms them covering every row once; groups of about
    sqrt(blocks), within the kernel's tickets."""
    blocks, group = lk.layernorm_bwd_plan(rows, e)
    most = (2 if e <= lk.LNB_WIDE_E else 1) * N_SMS
    assert 1 <= blocks <= min(rows, most)
    assert blocks == min(-(-rows // lk.LNB_WARPS), most)
    bounds = [k * rows // blocks for k in range(blocks + 1)]
    assert bounds[0] == 0 and bounds[-1] == rows
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    groups = -(-blocks // group)
    assert group * group >= blocks and (group - 1) ** 2 < blocks
    assert 1 + groups <= lk.LNB_TICKETS


def test_k8_refuses_no_rows():
    with pytest.raises(ValueError, match="at least one row"):
        lk.layernorm_bwd_plan(0, 512)


def _ln_inputs(rows, e, seed):
    rng = np.random.default_rng(seed)
    g, z = (rng.standard_normal((rows, e), dtype=np.float32)
            for _ in range(2))
    gamma = 1 + 0.1 * rng.standard_normal(e, dtype=np.float32)
    return g, z, gamma


@pytest.mark.parametrize("variant", [None, "three_pass"])
def test_k8_takes_its_variants_on_the_cpu(variant):
    g, z, gamma = (torch.from_numpy(a) for a in _ln_inputs(24, 16, 0))
    spec = drop_k.DropSpec(0.25, 3, 5, 7, 8)
    got = K8(g, z, gamma, 1e-5, spec, variant=variant)
    for a, b in zip(got, K8.plain(g, z, gamma, 1e-5, spec)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["one_pass", "two_pass", "simt"])
def test_k8_refuses_unknown_variants_on_the_cpu(variant):
    g, z, gamma = (torch.from_numpy(a) for a in _ln_inputs(4, 16, 0))
    with pytest.raises(ValueError, match="unknown variant"):
        K8(g, z, gamma, 1e-5, variant=variant)


@pytest.fixture(scope="module")
def jax_ln_bwd():
    """JAX's ``_ln_bwd`` at each (rows, E) of the cases below, once (one
    compiled program a shape: quicker than its ops one by one)."""
    ln_bwd = jax.jit(ptl._ln_bwd)
    out = {}
    for rows in (1, 37, 300):
        for e in (512, 768, 1024):
            g, z, gamma = _ln_inputs(rows, e, rows + e)
            out[rows, e] = [np.asarray(a) for a in ln_bwd(
                jnp.asarray(g), jnp.asarray(z), jnp.asarray(gamma)[None])]
    return out


@pytest.mark.parametrize("e", [512, 768, 1024])
@pytest.mark.parametrize("rows", [1, 37, 300])
def test_k8_twin_matches_jax_ln_bwd(jax_ln_bwd, rows, e):
    """The twin the one-pass kernel is held to, at the training widths and
    at row counts that fill no whole block of rows (1, 37, 300 against 8
    rows a block): dz (2e-5 on O(1) values), dgamma / dbeta (1e-4 relative,
    column sums over the rows in another order) against JAX's ``_ln_bwd``;
    dz_drop equal to K10's twin applied to dz."""
    g, z, gamma = _ln_inputs(rows, e, rows + e)
    dz_j, ds_j, db_j = jax_ln_bwd[rows, e]
    spec = drop_k.DropSpec(0.1, 11, 13, 2, max(rows // 2, 1))
    dz, dz_drop, ds, db = K8(torch.from_numpy(g), torch.from_numpy(z),
                             torch.from_numpy(gamma), 1e-5, spec)
    np.testing.assert_allclose(dz.numpy(), dz_j, atol=2e-5)
    np.testing.assert_allclose(ds.numpy(), ds_j[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), db_j[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(dz_drop, drop_k.dropout_plain(dz, spec))
