"""The port's meshed decode (data- and tensor-parallel ``sharded_generate`` /
``sharded_beam_generate``, K15 ``tp_allreduce``) and fault F3 (fp32 compute
over bf16 caches) against the JAX package at fp32, on the CPU.

A mesh on the CPU is ``make_mesh(n_data, n_model, ["cpu"] * n)``: every shard
on the one CPU device, K15's plain twin summing the ranks. The JAX package's
own meshed paths are slow on the CPU, so each runs once here: its tensor-
parallel monolith in the Pallas interpreter (forced, tp = 2, 16 steps) and
its per-op tensor-parallel ``sharded_generate``. JAX's tests already hold
its meshed paths token-identical to its unsharded ``generate`` /
``beam_generate`` (tests/test_tp_monolith.py, tests/test_sharded_decode.py),
so every other case is held against those, which are quick.

Setup: the tiny config of tests/test_tp_monolith.py (E = 256, 4 heads,
F = 1024, 2 layers, B = 4, M = 32), the port's seeded weights handed to JAX
as arrays, inputs from ``np.random.default_rng``. Tolerances (JAX's own):
tokens exact everywhere but the opt-in W8A8 case; log-probs within 1e-5
against JAX's meshed paths (the same sum order) and within 1e-4 against its
unsharded ones (the split sums change the fp32 order,
tests/test_tp_monolith.py:53-69); int8 caches within 2e-3
(tests/test_tp_monolith.py:110-132); per-shard W8A8 tokens on more than 85 %
of positions (tests/test_tp_monolith.py:170-195).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.parallel import mesh as jax_mesh
from acai_omr_tpu.parallel import sharding as jax_sharding

from acai_omr_tpu_torch.models import decode
from acai_omr_tpu_torch.models.omr_decoder import (DecoderConfig,
                                                   init_decoder_params)
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
from acai_omr_tpu_torch.ops import decode_kernel, tp_allreduce_kernel
from acai_omr_tpu_torch.ops.quant_linear_kernel import (quant_linear_bias_act,
                                                        unpack_k4)
from acai_omr_tpu_torch.ops.tp_allreduce_kernel import TPGroup, tp_allreduce
from acai_omr_tpu_torch.parallel import mesh as mesh_lib
from acai_omr_tpu_torch.parallel import sharding

DEC = dict(max_lmx_seq_len=32, vocab_size=33, num_layers=2, hidden_dim=256,
           num_heads=4, mlp_dim=1024, eos_idx=2)
JCFG = JaxDecoderConfig(**DEC)
PCFG = DecoderConfig(**DEC)
B, M, E, H = 4, 32, 256, 4
LENS = [M, M - 5, 17, M]
FP32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
JFP32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
RUN = dict(max_len=16, initial_segment=16)


def _set_w8a8(w8a8: bool, tp_w8a8: bool = False):
    """Both packages' weight switches; JAX reads them while it traces, so
    its compiled functions are dropped with them."""
    pallas_monolith._W8A8, pallas_monolith._TP_W8A8 = w8a8, tp_w8a8
    jax.clear_caches()
    decode_kernel.set_w8a8(w8a8)
    decode_kernel.set_tp_w8a8(tp_w8a8)


@pytest.fixture(autouse=True)
def _switches():
    """JAX unforced (its per-op step on the CPU), the port on its monolith
    step with the plain per-op attention, no W4A8; all restored after."""
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET,
            pallas_monolith._W8A8, pallas_monolith._W4A8,
            pallas_monolith._TP_W8A8, decode_kernel._ENABLED,
            decode_kernel._W8A8, decode_kernel._W4A8, decode_kernel._TP_W8A8,
            hd._ENABLED, hd._ENABLED_INT8)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    pallas_monolith._W4A8 = False
    decode_kernel.set_enabled(True)
    decode_kernel.set_w4a8(False)
    hd.set_enabled(False)
    yield
    pallas_monolith.set_test_mode(*prev[:2])
    (pallas_monolith._W8A8, pallas_monolith._W4A8,
     pallas_monolith._TP_W8A8) = prev[2:5]
    decode_kernel.set_enabled(prev[5])
    decode_kernel.set_w8a8(prev[6])
    decode_kernel.set_w4a8(prev[7])
    decode_kernel.set_tp_w8a8(prev[8])
    hd.set_enabled(prev[9])
    hd.set_enabled_int8(prev[10])
    jax.clear_caches()


@pytest.fixture(scope="module")
def setup():
    """The port's seeded weights, handed to JAX as arrays; seeded inputs."""
    pparams = init_decoder_params(torch.Generator().manual_seed(0), PCFG)
    jparams = _unflatten({k: jnp.asarray(v.numpy())
                          for k, v in _flatten(pparams).items()})
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((B, M, E)).astype(np.float32)
    valid = np.arange(M)[None, :] < np.array(LENS)[:, None]
    return jparams, pparams, latent, valid


@pytest.fixture(scope="module")
def jax_unsharded(setup):
    """JAX's unsharded fp32 decodes, made once each on first use:
    ``(kind, max_len) -> (seqs, log_probs, mask)``."""
    jparams, _, latent, valid = setup
    made = {}

    def get(kind="greedy", max_len=16):
        if (kind, max_len) not in made:
            pallas_monolith.set_test_mode(force=False, interpret=False)
            lat, val = jnp.asarray(latent), jnp.asarray(valid)
            if kind == "greedy":
                out = jax_decode.generate(jparams, JCFG, lat, val,
                                          max_len=max_len, initial_segment=16,
                                          compact=False, **JFP32)
            elif kind == "grouped":
                out = jax_decode.generate(jparams, JCFG, lat[:1], val[:1],
                                          mem_group=4, compact=False, **RUN,
                                          **JFP32)
            else:
                out = jax_decode.beam_generate(jparams, JCFG, lat[:2],
                                               val[:2], beam_size=4, **RUN,
                                               **JFP32)
            made[kind, max_len] = tuple(np.asarray(a) for a in out)
        return made[kind, max_len]

    return get


@pytest.fixture(scope="module")
def jax_tp_monolith(setup):
    """JAX's tensor-parallel monolith (in-kernel all-reduce) in the Pallas
    interpreter over a 1 x 2 mesh of host devices: the one run of it."""
    jparams, _, latent, valid = setup
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET)
    pallas_monolith.set_test_mode(force=True, interpret=True)
    try:
        out = jax_decode.sharded_generate(
            jparams, JCFG, jnp.asarray(latent), jnp.asarray(valid),
            jax_mesh.make_mesh(1, 2), axis=jax_mesh.DATA_AXIS,
            model_axis=jax_mesh.MODEL_AXIS, **RUN, **JFP32)
    finally:
        pallas_monolith.set_test_mode(*prev)
    return tuple(np.asarray(a) for a in out)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(n_data, n_model):
    return mesh_lib.make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))


def _meshed(setup, n_data, n_model, rows=slice(None), **kw):
    _, pparams, latent, valid = setup
    args = dict(RUN, **FP32)
    args.update(kw)
    return decode.sharded_generate(
        pparams, PCFG, _t(latent[rows]), _t(valid[rows]),
        _cpu_mesh(n_data, n_model), model_axis=mesh_lib.MODEL_AXIS, **args)


def _assert_same(out, ref, atol):
    seqs, lps = (np.asarray(a) for a in out[:2])
    n = min(seqs.shape[1], ref[0].shape[1])
    np.testing.assert_array_equal(seqs[:, :n], ref[0][:, :n])
    np.testing.assert_allclose(lps[:, :n], ref[1][:, :n], atol=atol, rtol=0)
    return n


# ---------------------------------------------------------------------------
# the mesh, the split, K15's twin
# ---------------------------------------------------------------------------

def test_make_mesh_and_its_groups(monkeypatch):
    """(data, model) rows of devices, repeats allowed; each data coordinate's
    model ranks form a TP group, kept; each rank's peers of every round are
    JAX's ``_tp_peers`` over a 2 x 4 host mesh (model coordinate XOR 1 << r,
    row-major ids)."""
    mesh = _cpu_mesh(2, 4)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.tp_group(1) is mesh.tp_group(1)
    assert mesh.tp_group(1).devices == [torch.device("cpu")] * 4
    jm = jax_mesh.make_mesh(2, 4)
    want = np.asarray(jax.jit(shard_map(
        lambda: jax_decode._tp_peers(jm, jax_mesh.MODEL_AXIS, 4)[None, None],
        mesh=jm, in_specs=(), out_specs=PartitionSpec("data", "model")))())
    for d in range(2):
        for m in range(4):
            got = [d * 4 + p for p in mesh.tp_group(d).peers(m)]
            assert got == want[d, m].tolist()
    assert want[1, 2].tolist() == [7, 4]
    one = mesh_lib.single_device_mesh("cpu")
    assert one.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 6 devices"):
        mesh_lib.make_mesh(3, 2, ["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_mesh(1, 2)


def _jax_shards(jparams, tp):
    """JAX's ``tp_shuffle_decoder_params`` cut by ``tp_decode_param_specs``:
    (flat leaves of each rank, the flat specs)."""
    shuffled = jax_sharding.tp_shuffle_decoder_params(jparams, H, E // H, tp)
    specs = _flatten(jax_sharding.tp_decode_param_specs(shuffled, "model"))
    full = _flatten(jax.tree.map(np.asarray, shuffled))
    ranks = []
    for r in range(tp):
        rank = {}
        for path, leaf in full.items():
            spec = tuple(specs[path])
            if "model" in spec:
                ax = spec.index("model")
                w = leaf.shape[ax] // tp
                leaf = np.take(leaf, range(r * w, (r + 1) * w), axis=ax)
            rank[path] = leaf
        ranks.append(rank)
    return ranks, specs


@pytest.mark.parametrize("tp", [2, 4])
def test_shuffled_split_params_equal_jax(setup, tp):
    """Each rank's params equal JAX's ``tp_shuffle_decoder_params`` cut by
    ``tp_decode_param_specs``, leaf for leaf and bit for bit; replicated
    leaves are shared, not copied."""
    jparams, pparams, _, _ = setup
    want, specs = _jax_shards(jparams, tp)
    ranks = sharding.tp_split_decoder_params(
        sharding.tp_shuffle_decoder_params(pparams, H, E // H, tp), tp)
    flat_params = _flatten(pparams)
    for r, rank in enumerate(ranks):
        got = _flatten(rank)
        assert got.keys() == want[r].keys()
        for path, leaf in want[r].items():
            if "model" not in tuple(specs[path]):
                assert got[path] is flat_params[path], path
            np.testing.assert_array_equal(got[path].numpy(), leaf,
                                          err_msg=path)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["partial", "compute"])
def test_allreduce_twin_sums_in_tree_order(tp, mode):
    """K15's twin: recursive doubling, p0 + p1 and (p0 + p1) + (p2 + p3),
    the same bits on every rank. The monolith's mode: fp32 partials, the
    fp32 bias once after the sum, rounded to bf16. The per-op mode: bf16
    partials, the running sum rounded to bf16 after every round, no bias."""
    rng = np.random.default_rng(tp)
    group = TPGroup(["cpu"] * tp)
    dt = torch.float32 if mode == "partial" else torch.bfloat16
    parts = [torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32)
                              * 3).to(dt) for _ in range(tp)]
    bias = [torch.from_numpy(rng.standard_normal(16).astype(np.float32))] * tp
    f = [p.float() for p in parts]
    if mode == "partial":
        s = f[0] + f[1] if tp == 2 else (f[0] + f[1]) + (f[2] + f[3])
        want = (s + bias[0]).to(torch.bfloat16)
        outs = tp_allreduce(parts, group, bias, torch.bfloat16)
    else:
        rnd = lambda a: a.to(torch.bfloat16).float()
        s = rnd(f[0] + f[1]) if tp == 2 else \
            rnd(rnd(f[0] + f[1]) + rnd(f[2] + f[3]))
        want = s.to(torch.bfloat16)
        outs = tp_allreduce(parts, group)
    assert len(outs) == tp
    for o in outs:
        assert o.dtype == torch.bfloat16 and torch.equal(o, want)
    assert group.peers(2) == ([3] if tp == 2 else [3, 0])[: tp.bit_length()
                                                          - 1]


# ---------------------------------------------------------------------------
# the meshed greedy decode
# ---------------------------------------------------------------------------

def test_tp2_matches_jax_tp_monolith(setup, jax_tp_monolith):
    """tp = 2 on the port's monolith step (K1 partials, K15) against JAX's
    tensor-parallel monolith: the same sum order, tokens equal, log-probs
    within 1e-5."""
    _assert_same(_meshed(setup, 1, 2), jax_tp_monolith, 1e-5)


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (1, 4), (2, 2), (4, 1)])
def test_meshed_decode_matches_unsharded_jax(setup, jax_unsharded, n_data,
                                             n_model):
    """tp = 2, tp = 4, DP x TP 2 x 2 and pure DP against JAX's unsharded
    ``generate``: tokens equal, log-probs within 1e-4."""
    _assert_same(_meshed(setup, n_data, n_model), jax_unsharded(), 1e-4)


def test_tp2_segment_growth(setup, jax_unsharded):
    """A 16-slot first segment that grows to 24 for every shard at once."""
    out = _meshed(setup, 2, 2, max_len=24, initial_segment=16)
    assert _assert_same(out, jax_unsharded("greedy", 24), 1e-4) > 17


def test_grouped_memory_tp2(setup, jax_unsharded):
    """mem_group = 4 (the rollout layout: four rows over one memory row) on
    the tp = 2 monolith step against JAX's unsharded grouped decode."""
    out = _meshed(setup, 1, 2, rows=slice(0, 1), mem_group=4)
    assert out[0].shape[0] == 4
    _assert_same(out, jax_unsharded("grouped"), 1e-4)


def test_per_op_tp_step_matches_jax(setup):
    """``ACAI_MONOLITH_DECODE`` off: the per-op tensor-parallel step (sums
    in the compute dtype through K15, bias after) against JAX's per-op
    ``sharded_generate(model_axis=)`` over a 1 x 2 host mesh: tokens equal,
    log-probs within 1e-5. K15 runs at the two row-parallel sites and ff2:
    three times a layer and step."""
    jparams, _, latent, valid = setup
    ref = jax_decode.sharded_generate(
        jparams, JCFG, jnp.asarray(latent), jnp.asarray(valid),
        jax_mesh.make_mesh(1, 2), axis=jax_mesh.DATA_AXIS,
        model_axis=jax_mesh.MODEL_AXIS, **RUN, **JFP32)
    decode_kernel.set_enabled(False)
    calls = []
    real = tp_allreduce.plain
    tp_allreduce.plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        out = _meshed(setup, 1, 2)
    finally:
        tp_allreduce.plain = real
    _assert_same(out, tuple(np.asarray(a) for a in ref), 1e-5)
    assert len(calls) == 3 * PCFG.num_layers * (RUN["max_len"] - 1)


def test_sampled_shards_draw_their_own_streams(setup):
    """With sampling, data shard d draws from a generator seeded
    ``seed + d``: its rows are what the unsharded sampled decode of those
    rows gives with that generator, and a second run repeats the first."""
    _, pparams, latent, valid = setup
    sampling = decode.SamplingConfig(top_k=5, temperature=1.3)
    out = _meshed(setup, 2, 1, sampling=sampling, seed=7)
    again = _meshed(setup, 2, 1, sampling=sampling, seed=7)
    assert torch.equal(out[0], again[0])
    for d in range(2):
        rows = slice(2 * d, 2 * d + 2)
        ref = decode.generate(pparams, PCFG, _t(latent[rows]),
                              _t(valid[rows]), sampling=sampling,
                              generator=torch.Generator().manual_seed(7 + d),
                              compact=False, **RUN, **FP32)
        n = min(ref[0].shape[1], out[0].shape[1])
        assert torch.equal(out[0][rows, :n], ref[0][:, :n])


def test_meshed_progress_streams_consistent_snapshots(setup):
    """``progress_cb`` after every segment: merged rows in input order, ``t``
    the largest position over the shards and never going back, finished
    rows only growing, each snapshot a prefix of the final sequences."""
    events = []
    out = _meshed(setup, 2, 2, max_len=24, segment_steps=5,
                  progress_cb=lambda s, t, fin: events.append(
                      (s.copy(), t, fin.copy())))
    assert len(events) >= 3
    final = out[0].numpy()
    prev_t, prev_fin = 0, np.zeros(B, bool)
    for seqs, t, fin in events:
        assert seqs.shape == (B, 24) and fin.shape == (B,)
        assert t >= prev_t and (fin >= prev_fin).all()
        n = min(t, final.shape[1])
        live = seqs[:, :n] != PCFG.pad_idx
        assert (seqs[:, :n][live] == final[:, :n][live]).all()
        prev_t, prev_fin = t, fin


def test_meshed_decode_rejects_what_jax_rejects(setup):
    """Heads that the model axis does not divide, and unique rows that the
    data axis does not divide, raise as in JAX; so does, before any step, a
    model axis other than 2 or 4 over CUDA devices (K15's sizes), which the
    CPU's per-op step takes. Over CUDA devices tp = 4 rides the monolith
    step where its kernels take the shapes (bf16), and takes the per-op
    step where they do not (an fp32 compute dtype), as JAX's
    ``use_monolith``."""
    _, pparams, latent, valid = setup
    with pytest.raises(ValueError, match="num_heads"):
        _meshed(setup, 1, 8)
    cfg8 = DecoderConfig(**dict(DEC, num_heads=8))
    plan = lambda devs, dt=torch.float32: decode._mesh_plan(
        cfg8, mesh_lib.Mesh([devs]), "data", "model", dt, dt, "decode",
        max_len=16, mem_len=M)
    assert plan(["cpu"] * 8) == (1, 8, False)
    with pytest.raises(ValueError, match="model axis of 2 or 4"):
        plan(["cuda:0"] * 8)
    assert plan(["cuda:0"] * 4, torch.bfloat16) == (1, 4, True)
    assert plan(["cuda:0"] * 4) == (1, 4, False)
    with pytest.raises(ValueError, match="does not shard"):
        _meshed(setup, 2, 1, rows=slice(0, 3))
    with pytest.raises(ValueError, match="num_heads"):
        decode.sharded_beam_generate(pparams, PCFG, _t(latent), _t(valid),
                                     _cpu_mesh(1, 8), model_axis="model",
                                     **RUN, **FP32)
    with pytest.raises(ValueError, match="does not shard"):
        decode.sharded_beam_generate(pparams, PCFG, _t(latent[:3]),
                                     _t(valid[:3]), _cpu_mesh(2, 1),
                                     model_axis="model", **RUN, **FP32)


# ---------------------------------------------------------------------------
# int8 caches and the W8A8 opt-in under tensor parallelism
# ---------------------------------------------------------------------------

def test_int8_tp2_matches_single_device_int8(setup):
    """int8 caches on the tp = 2 monolith step, W8A8 off on both sides,
    against JAX's single-device int8 monolith (forced, interpreted): tokens
    equal, log-probs within 2e-3. Quantization is per (row, head) and every
    head lies whole in one shard, so the first step's cache scales of each
    shard equal the head slice of the single-device ones in every layer, and
    so do layer 0's int8 rows; a later layer's input carries the split sum's
    fp32 order, which may move an int8 entry by one."""
    jparams, pparams, latent, valid = setup
    _set_w8a8(False)
    pallas_monolith.set_test_mode(force=True, interpret=True)
    ref = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                              jnp.asarray(valid), compute_dtype=jnp.float32,
                              cache_dtype=jnp.int8, compact=False, **RUN)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    out = _meshed(setup, 1, 2, compute_dtype=torch.float32,
                  cache_dtype=torch.int8)
    _assert_same(out, tuple(np.asarray(a) for a in ref), 2e-3)

    mem = decode.precompute_memory_kv(pparams, PCFG, _t(latent), _t(valid),
                                      torch.float32, torch.int8)
    one = decode.init_decode_state(PCFG, B, 16, 32, torch.int8)
    decode.step_logits(pparams, PCFG, decode._prepack_for(
        pparams, torch.float32, torch.int8), one, mem, torch.float32)
    devs = [torch.device("cpu")] * 2
    split = decode.prepare_tp_decode_params(pparams, PCFG, _cpu_mesh(1, 2))
    tp = decode.init_decode_state(PCFG, B, 16, 32, torch.int8,
                                  tp_devices=devs)
    mems = [decode._shard_memory(mem, slice(None), r, 2, "cpu", "te")
            for r in range(2)]
    decode.step_logits(split[0], PCFG, [decode._prepack_for(
        p, torch.float32, torch.int8, True) for p in split[0]], tp, mems,
        torch.float32, tp_group=TPGroup(devs))
    for r in range(2):
        heads, cols = slice(2 * r, 2 * r + 2), slice(128 * r, 128 * r + 128)
        for full, part in ((one.k_scale, tp.k_scale),
                           (one.v_scale, tp.v_scale)):
            assert torch.equal(part[r][:, :, 0], full[:, :, 0, heads])
        for full, part in ((one.k_cache, tp.k_cache),
                           (one.v_cache, tp.v_cache)):
            assert torch.equal(part[r][0, :, 0], full[0, :, 0, cols])
            step = (part[r][1:, :, 0].int() - full[1:, :, 0, cols].int()).abs()
            assert int(step.max()) <= 1


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_w8a8_shard_products_match_jax(setup, tp):
    """``ACAI_TP_W8A8=1``: each shard's int8 weights and column scales, the
    operands the tensor-parallel step packs, equal JAX's ``prepack`` of that
    shard (``quantize_weights="int8"``, the shard's attention width) in
    every bit; and each of the shard's six W8A8 products (K5's twin,
    ``act="partial"``: rows quantized over the shard's slice of the
    contraction axis, no bias) equals JAX's ``_qdot`` on the same slice of x
    and w within 1e-6 of its largest value."""
    jparams, pparams, _, _ = setup
    _set_w8a8(True, tp_w8a8=True)
    split = decode.prepare_tp_decode_params(pparams, PCFG, _cpu_mesh(1, tp))
    rng = np.random.default_rng(tp)
    qdot = jax.jit(pallas_monolith._qdot)
    pack = jax.jit(lambda p: pallas_monolith.prepack(
        p, JCFG, jnp.float32, quantize_weights="int8", e_attn=E // tp))
    for r, jflat in enumerate(_jax_shards(jparams, tp)[0]):
        jmono = pack(_unflatten({k: jnp.asarray(v) for k, v in jflat.items()}))
        pmono = decode._prepack_for(split[0][r], torch.float32, torch.int8,
                                    True)
        for j, name in enumerate(decode_kernel._MATS):
            for i in range(PCFG.num_layers):
                w8 = np.asarray(jmono[name][i])
                s = np.asarray(jmono["wscale"][i, j, :w8.shape[1]])
                np.testing.assert_array_equal(
                    unpack_k4(pmono[name][i]).numpy(), w8, err_msg=name)
                np.testing.assert_array_equal(
                    pmono["s_" + name[2:]][i].numpy(), s, err_msg=name)
                x = rng.standard_normal((B, w8.shape[0])).astype(np.float32)
                want = np.asarray(qdot(jnp.asarray(x), jnp.asarray(w8),
                                       jnp.asarray(s)[None]))
                got = quant_linear_bias_act(_t(x), pmono[name][i],
                                            pmono["s_" + name[2:]][i], None,
                                            "partial").numpy()
                assert got.dtype == np.float32
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                    err_msg=name)


def test_tp_w8a8_opt_in(setup):
    """``ACAI_TP_W8A8=1`` (on top of W8A8) on the tp = 2 int8 decode: the
    tokens agree with the bf16-weight tp = 2 int8 decode on more than 85 %
    of positions (another quantization, JAX's bar). Off, W4A8 on: the shards
    still keep compute-dtype weights (W4A8 never runs under TP)."""
    _set_w8a8(True, tp_w8a8=True)
    w8 = _meshed(setup, 1, 2, compute_dtype=torch.float32,
                 cache_dtype=torch.int8)
    _set_w8a8(True, tp_w8a8=False)
    decode_kernel.set_w4a8(True)
    assert decode_kernel.weight_quant_mode(torch.int8, tp_mono=True) is False
    bf = _meshed(setup, 1, 2, compute_dtype=torch.float32,
                 cache_dtype=torch.int8)
    n = min(w8[0].shape[1], bf[0].shape[1])
    assert (w8[0][:, :n] == bf[0][:, :n]).float().mean().item() > 0.85


# ---------------------------------------------------------------------------
# beams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_meshed_beams_match_unsharded_jax(setup, jax_unsharded, n_data,
                                          n_model):
    """``sharded_beam_generate`` (4 beams over each image's memory, the
    tp = 2 monolith step) against JAX's unsharded ``beam_generate``."""
    _, pparams, latent, valid = setup
    out = decode.sharded_beam_generate(
        pparams, PCFG, _t(latent[:2]), _t(valid[:2]),
        _cpu_mesh(n_data, n_model), model_axis="model", beam_size=4, **RUN,
        **FP32)
    _assert_same(out, jax_unsharded("beam"), 1e-4)


# ---------------------------------------------------------------------------
# F3: fp32 compute over bf16 caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_fp32_compute_bf16_caches_match_jax(setup, kind):
    """F3: fp32 compute with bf16 caches, JAX's default cache dtype,
    decodes on the per-op step with the caches stored in bf16, as JAX does:
    the same tokens as JAX's ``generate`` / ``beam_generate``, log-probs
    within 1e-5."""
    jparams, pparams, latent, valid = setup
    kw = dict(max_len=20, initial_segment=16)
    if kind == "greedy":
        ref = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                                  jnp.asarray(valid),
                                  compute_dtype=jnp.float32,
                                  cache_dtype=jnp.bfloat16, **kw)
        out = decode.generate(pparams, PCFG, _t(latent), _t(valid),
                              compute_dtype=torch.float32,
                              cache_dtype=torch.bfloat16, **kw)
    else:
        ref = jax_decode.beam_generate(jparams, JCFG, jnp.asarray(latent[:2]),
                                       jnp.asarray(valid[:2]), beam_size=3,
                                       compute_dtype=jnp.float32,
                                       cache_dtype=jnp.bfloat16, **kw)
        out = decode.beam_generate(pparams, PCFG, _t(latent[:2]),
                                   _t(valid[:2]), beam_size=3,
                                   compute_dtype=torch.float32,
                                   cache_dtype=torch.bfloat16, **kw)
    _assert_same(out, tuple(np.asarray(a) for a in ref), 1e-5)


def test_streamed_fp32_compute_bf16_caches(setup):
    """``streamed_generate(cache_dtype=bf16)`` under fp32 compute: its
    chunks and its finish equal the greedy ``generate`` of the same image
    over bf16 caches."""
    _, pparams, latent, valid = setup
    kw = dict(compute_dtype=torch.float32, cache_dtype=torch.bfloat16)
    ref = decode.generate(pparams, PCFG, _t(latent[:1]), _t(valid[:1]),
                          max_len=20, **kw)
    events = list(decode.streamed_generate(
        pparams, PCFG, _t(latent[:1]), _t(valid[:1]), max_len=20,
        flush_interval=6, **kw))
    assert [e[0] for e in events][-1] == "finish"
    fin = events[-1][1]
    assert torch.equal(fin[0], ref[0]) and torch.equal(fin[1], ref[1])
    chunks = np.concatenate([e[1] for e in events[:-1]], axis=1)
    np.testing.assert_array_equal(chunks[0], ref[0][0, 1:1 + chunks.shape[1]])
    with pytest.raises(ValueError, match="float caches"):
        next(decode.streamed_generate(pparams, PCFG, _t(latent[:1]),
                                      _t(valid[:1]), cache_dtype=torch.int8))


def test_allreduce_kernel_takes_only_cuda_or_cpu_parts():
    """The wrapper runs the twin for CPU parts and launches for CUDA parts;
    a mix of devices raises, with no fallback."""
    cpu = [torch.zeros(2, 8)] * 2
    assert torch.equal(tp_allreduce(cpu, TPGroup(["cpu"] * 2))[0], cpu[0])
    assert tp_allreduce_kernel.tp_allreduce.launches == 0
    meta = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="parts on"):
        tp_allreduce([cpu[0], meta], TPGroup(["cpu"] * 2))
