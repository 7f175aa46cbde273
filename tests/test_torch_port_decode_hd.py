"""The port's per-op decode step (lane-major caches, K11-K13), its sampled
and grouped decode, against the JAX package at fp32.

The kernels' plain twins are held against the JAX package's own Pallas
kernels (``ops/pallas_decode.py``) run in the Pallas interpreter. The step and
``generate`` are held against the JAX package's unforced CPU decode, which
takes its per-op step there (``pallas_monolith.set_test_mode(force=False)``);
the port takes its per-op step with ``ACAI_MONOLITH_DECODE`` off
(``decode_kernel.set_enabled(False)``). Same weights, inputs from
``np.random.default_rng``. Tolerances: kernel twins 1e-5 absolute (fp32, other
summation orders); step logits 2e-4 absolute (as tests/test_monolith.py);
tokens exact; log-probs 2e-4 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_decode, pallas_monolith

from acai_omr_tpu_torch.models import decode
from acai_omr_tpu_torch.models.omr_decoder import (DecoderConfig,
                                                   init_decoder_params)
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
from acai_omr_tpu_torch.ops import decode_kernel

from _torch_port_threads import torch_one_thread  # noqa: F401

DEC = dict(max_lmx_seq_len=320, vocab_size=33, num_layers=2, hidden_dim=64,
           num_heads=4, mlp_dim=128, eos_idx=2)
JCFG = JaxDecoderConfig(**DEC)
PCFG = DecoderConfig(**DEC)
B, M, E = 8, 24, 64
LENS = [M, M - 5, 17, M, 9, 22, M, 13]
KB, KH, KD, KT, KL = 4, 8, 16, 128, 3  # kernel-twin shapes


@pytest.fixture(autouse=True)
def _per_op_steps():
    """Both packages on their per-op steps; every switch restored after."""
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET,
            decode_kernel._ENABLED, hd._ENABLED, hd._ENABLED_INT8)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    decode_kernel.set_enabled(False)
    yield
    pallas_monolith.set_test_mode(*prev[:2])
    decode_kernel.set_enabled(prev[2])
    hd.set_enabled(prev[3])
    hd.set_enabled_int8(prev[4])


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX Pallas kernels in the Pallas interpreter. The kernel
    tests use shapes (KB, KH, KD, KT) that no other test traces, so no trace
    made meanwhile is reused outside them."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def setup():
    """The port's seeded initialisation, handed to JAX as arrays (tracing the
    JAX initializer costs more than the tests that use it). With these
    weights greedy rows 1, 2, 3, 5 and 7 emit <eos> within 9 steps and rows
    0, 4 and 6 run on past 257: the generate tests see finished-row
    compaction and cache growth."""
    pparams = init_decoder_params(torch.Generator().manual_seed(0), PCFG)
    jparams = _unflatten({k: jnp.asarray(v.numpy())
                          for k, v in _flatten(pparams).items()})
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((B, M, E)).astype(np.float32)
    valid = np.arange(M)[None, :] < np.array(LENS)[:, None]
    return jparams, pparams, latent, valid


def _t(a):
    return torch.from_numpy(np.array(a))


def _kernel_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)
    sc = lambda *s: (rng.random(s) * 3e-2 + 2e-3).astype(np.float32)
    bias = np.where(np.arange(KT)[None] < np.array([KT, 90, 33, 128])[:, None],
                    0.0, -1e9).astype(np.float32)
    return dict(q=f(KB, KH, KD), k=f(KB, KH, KD, KT), v=f(KB, KH, KD, KT),
                k8=i8(KL, KB, KH, KD, KT), v8=i8(KL, KB, KH, KD, KT),
                ks=sc(KL, KB, KH, KT), vs=sc(KL, KB, KH, KT), bias=bias,
                kn=f(KB, KH, KD) * 3, vn=f(KB, KH, KD))


@pytest.mark.parametrize("with_bias", [False, True])
def test_k11_twin_equals_pallas_kernel(interpret, with_bias):
    x = _kernel_inputs()
    bias = x["bias"] if with_bias else None
    j = pallas_decode.decode_attention(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        None if bias is None else jnp.asarray(bias), jnp.float32)
    p = hd.decode_attention_hd(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                               None if bias is None else _t(bias))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    # reading only the positions that carry weight changes nothing
    n = 40
    p_n = hd.decode_attention_hd(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                 _t(np.where(np.arange(KT) < n, 0.0, -1e9)
                                    .astype(np.float32)[None].repeat(KB, 0)))
    np.testing.assert_allclose(
        hd.decode_attention_hd(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                               n_keys=n).numpy(), p_n.numpy(), atol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
def test_k12_twin_equals_pallas_kernels(interpret, stacked):
    """Per layer (`_kernel_int8`) and reading layer 1 of a stacked cache
    (`_kernel_int8_stacked`), with the bias."""
    x = _kernel_inputs(1)
    jq = jnp.asarray(x["q"])
    if stacked:
        j = pallas_decode.decode_attention_stacked(
            jq, jnp.asarray(x["k8"]), jnp.asarray(x["v8"]), 1,
            jnp.asarray(x["bias"]), jnp.float32, jnp.asarray(x["ks"]),
            jnp.asarray(x["vs"]))
        p = hd.decode_attention_hd_int8(_t(x["q"]), _t(x["k8"]), _t(x["v8"]),
                                        _t(x["ks"]), _t(x["vs"]),
                                        _t(x["bias"]), layer=1)
    else:
        j = pallas_decode.decode_attention(
            jq, jnp.asarray(x["k8"][1]), jnp.asarray(x["v8"][1]),
            jnp.asarray(x["bias"]), jnp.float32, jnp.asarray(x["ks"][1]),
            jnp.asarray(x["vs"][1]))
        p = hd.decode_attention_hd_int8(_t(x["q"]), _t(x["k8"][1]),
                                        _t(x["v8"][1]), _t(x["ks"][1]),
                                        _t(x["vs"][1]), _t(x["bias"]))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5, rtol=0)


@pytest.mark.parametrize("pos", [0, 37])
def test_k13_twin_equals_pallas_kernel(interpret, pos):
    """Output, and the caches and scales after the append."""
    x = _kernel_inputs(2)
    jo, jk, jv, jks, jvs = pallas_decode.self_attention_append_int8(
        jnp.asarray(x["q"]), jnp.asarray(x["kn"]), jnp.asarray(x["vn"]),
        jnp.asarray(x["k8"]), jnp.asarray(x["v8"]), jnp.asarray(x["ks"]),
        jnp.asarray(x["vs"]), 2, pos, jnp.float32)
    pk, pv, pks, pvs = (_t(x[n]) for n in ("k8", "v8", "ks", "vs"))
    po = hd.self_attention_append_int8(_t(x["q"]), _t(x["kn"]), _t(x["vn"]),
                                       pk, pv, pks, pvs, 2, pos)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    for p_arr, j_arr in ((pk, jk), (pv, jv)):
        np.testing.assert_array_equal(p_arr.numpy(), np.asarray(j_arr))
    # XLA on the CPU folds the scale's division by 127 into a product with
    # the reciprocal: one ulp apart at most
    for p_arr, j_arr in ((pks, jks), (pvs, jvs)):
        np.testing.assert_allclose(p_arr.numpy(), np.asarray(j_arr),
                                   rtol=2.4e-7, atol=0)
    assert not np.array_equal(pk[2, ..., pos].numpy(), x["k8"][2, ..., pos])


def test_memory_kv_hd_layout_matches_jax(setup):
    jparams, pparams, latent, valid = setup
    for cache in ("f32", "int8"):
        jd, pdt = ((jnp.float32, torch.float32) if cache == "f32"
                   else (jnp.int8, torch.int8))
        jm = jax_decode.precompute_memory_kv(
            jparams, JCFG, jnp.asarray(latent), jnp.asarray(valid),
            jnp.float32, jd, layout="hd")
        pm = decode.precompute_memory_kv(pparams, PCFG, _t(latent), _t(valid),
                                         torch.float32, pdt, layout="hd")
        assert pm.k.shape == (2, B, 4, 16, M)
        if cache == "int8":
            np.testing.assert_array_equal(pm.k.numpy(), np.asarray(jm.k))
            np.testing.assert_allclose(pm.k_scale.numpy(),
                                       np.asarray(jm.k_scale), rtol=1e-6)
            assert pm.k_scale.dtype == torch.float32
        else:
            np.testing.assert_allclose(pm.v.numpy(), np.asarray(jm.v),
                                       atol=2e-5)


@pytest.mark.parametrize("cache,int8_kernels", [("f32", True), ("int8", True),
                                                ("int8", False)])
def test_step_matches_jax_per_op_step(setup, cache, int8_kernels):
    """One step at pos 5 over half-filled caches: logits and the caches
    after the append (the int8 path through K13 / K12's twins or through
    the plain quantize-write-attend path)."""
    jparams, pparams, latent, valid = setup
    hd.set_enabled_int8(int8_kernels)
    quant = cache == "int8"
    jd, pdt = (jnp.int8, torch.int8) if quant else (jnp.float32, torch.float32)
    rng = np.random.default_rng(3)
    t_cache, t = 16, 6
    shape = (2, B, 4, 16, t_cache)
    if quant:
        kc = rng.integers(-127, 128, shape).astype(np.int8)
        vc = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kc, vc = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2))
    ks = (rng.random(shape[:3] + (t_cache,)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random(shape[:3] + (t_cache,)) * 0.05 + 0.01).astype(np.float32)
    x = rng.standard_normal((B, E)).astype(np.float32)
    jm = jax_decode.precompute_memory_kv(jparams, JCFG, jnp.asarray(latent),
                                         jnp.asarray(valid), jnp.float32, jd,
                                         layout="hd")
    pm = decode.precompute_memory_kv(pparams, PCFG, _t(latent), _t(valid),
                                     torch.float32, pdt, layout="hd")
    jc = {"k": jnp.asarray(kc), "v": jnp.asarray(vc)}
    pc = {"k": _t(kc), "v": _t(vc)}
    if quant:
        jc.update(ks=jnp.asarray(ks), vs=jnp.asarray(vs))
        pc.update(ks=_t(ks), vs=_t(vs))
    jl, jc = jax_decode._decode_step_logits(jparams, JCFG, jnp.asarray(x), t,
                                            jc, jm, jnp.float32)
    pl = decode._decode_step_logits(pparams, PCFG, _t(x), t, pc, pm,
                                    torch.float32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    for name in pc:
        if quant and name in ("k", "v"):
            np.testing.assert_array_equal(pc[name].numpy(),
                                          np.asarray(jc[name]))
        else:
            np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]),
                                       atol=1e-6, rtol=1e-6)


def _generate_both(setup, **kw):
    jparams, pparams, latent, valid = setup
    jcache = kw.pop("jcache", jnp.float32)
    pcache = kw.pop("pcache", torch.float32)
    j = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                            jnp.asarray(valid), compute_dtype=jnp.float32,
                            cache_dtype=jcache, **kw)
    p = decode.generate(pparams, PCFG, _t(latent), _t(valid),
                        compute_dtype=torch.float32, cache_dtype=pcache, **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


def _assert_same(j, p, lp_atol=2e-4):
    (js, jl, jm), (ps, pl, pm) = j, p
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, atol=lp_atol, rtol=0)


@pytest.mark.parametrize("pe_offset,cache,k11", [(0, "f32", False),
                                                 (0, "f32", True),
                                                 (1, "int8", False)])
def test_generate_token_identical_to_jax_per_op(setup, pe_offset, cache, k11):
    """Greedy decode. fp32 caches: 256 slots, then past 256 to max_len 264,
    compacted 8 -> 4 rows at the boundary. int8: one segment of 16 slots
    (its growth and compaction are the fp32 path's, with the scales moved
    alike: test_per_op_caches_grow_on_the_last_axis_without_rounding and the
    grouped int8 case of test_grouped_generate_equals_repeated). The port
    through K11's twin (``k11``) or the plain path; int8 through K13 / K12's
    twins (the JAX CPU decode runs its plain path throughout)."""
    hd.set_enabled(k11)
    kw = dict(max_len=264, initial_segment=256, pe_offset=pe_offset)
    if cache == "int8":
        kw.update(max_len=16, initial_segment=16, jcache=jnp.int8,
                  pcache=torch.int8)
    j, p = _generate_both(setup, **kw)
    # int8: the JAX CPU scales sit one ulp off (XLA's reciprocal for /127),
    # which can move a quantized entry by one step: log-probs within 1e-3
    _assert_same(j, p, 2e-4 if cache == "f32" else 1e-3)
    lengths = p[2].sum(axis=1)
    if cache == "f32":
        assert 1 <= int((lengths > 257).sum()) <= B // 2, lengths
        assert int((lengths < 17).sum()) >= B // 2, lengths
    else:
        assert (lengths < 16).any() and (lengths == 16).any(), lengths


def test_top_k_one_sampling_is_greedy_with_zero_log_probs(setup):
    _, pparams, latent, valid = setup
    greedy = decode.generate(pparams, PCFG, _t(latent), _t(valid), max_len=40,
                             initial_segment=16, compute_dtype=torch.float32,
                             cache_dtype=torch.float32)
    sampled = decode.generate(
        pparams, PCFG, _t(latent), _t(valid), max_len=40, initial_segment=16,
        compute_dtype=torch.float32, cache_dtype=torch.float32,
        sampling=decode.SamplingConfig(top_k=1, temperature=1.1),
        generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(sampled[0].numpy(), greedy[0].numpy())
    np.testing.assert_array_equal(sampled[1].numpy(), 0.0)


def test_sampler_equals_jax_categorical_on_the_same_noise():
    """jax.random.categorical(key, x) is argmax(x + gumbel(key)): the port's
    sampler handed that Gumbel draw picks the same token, and its log-prob is
    the untempered top-k log_softmax (not the full vocabulary's)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((16, 33)).astype(np.float32) * 3
    logits[3, 5] = logits[3, 9] = logits[3].max() + 1.0  # a tie: lower first
    sc = decode.SamplingConfig(top_k=7, temperature=1.1)
    topk, idx = jax.lax.top_k(jnp.asarray(logits), 7)
    key = jax.random.PRNGKey(11)
    choice = jax.random.categorical(key, topk / sc.temperature, axis=-1)
    noise = jax.random.gumbel(key, topk.shape, topk.dtype)
    j_tok = np.take_along_axis(np.asarray(idx), np.asarray(choice)[:, None],
                               1)[:, 0]
    j_lp = np.take_along_axis(np.asarray(jax.nn.log_softmax(topk, -1)),
                              np.asarray(choice)[:, None], 1)[:, 0]
    tok, lp = decode.sample_top_k(_t(logits), sc, _t(noise))
    np.testing.assert_array_equal(tok.numpy(), j_tok)
    np.testing.assert_allclose(lp.numpy(), j_lp, atol=1e-6)
    full = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits, -1)),
                              j_tok[:, None], 1)[:, 0]
    assert (lp.numpy() > full + 1e-3).all()


@pytest.mark.parametrize("step,cache", [("per_op", torch.float32),
                                        ("per_op", torch.int8),
                                        ("monolith", torch.float32),
                                        ("monolith", torch.int8)])
def test_grouped_generate_equals_repeated(setup, step, cache):
    """G = 3 rows per memory row decode as the repeat-expanded latent does,
    greedy, with the grouped compaction; both steps, int8 on the monolith
    step through K6's grouped memory and on the per-op step by repeating the
    latent (the JAX package's rule)."""
    _, pparams, latent, valid = setup
    decode_kernel.set_enabled(step == "monolith")
    g, bu = 3, 4
    lat, val = _t(latent[:bu]), _t(valid[:bu])
    kw = dict(max_len=40, initial_segment=16, compute_dtype=torch.float32,
              cache_dtype=cache)
    grouped = decode.generate(pparams, PCFG, lat, val, mem_group=g, **kw)
    rep = decode.generate(pparams, PCFG, lat.repeat_interleave(g, 0),
                          val.repeat_interleave(g, 0), **kw)
    np.testing.assert_array_equal(grouped[0].numpy(), rep[0].numpy())
    np.testing.assert_array_equal(grouped[2].numpy(), rep[2].numpy())
    # the grouped cross-attention of the per-op step sums in another order
    np.testing.assert_allclose(grouped[1].numpy(), rep[1].numpy(), atol=1e-6)
    lengths = grouped[2].sum(axis=1).reshape(bu, g)
    # groups finished within the first segment, the rest compacted
    assert (lengths < 17).all(1).sum() >= bu // 2 and (lengths > 17).any()


def test_grouped_generate_equals_jax_grouped_compaction(setup):
    j, p = _generate_both(setup, max_len=40, initial_segment=16, mem_group=2)
    _assert_same(j, p)
    assert p[0].shape[0] == 2 * B


def test_beams_on_the_per_op_step_equal_the_monolith_steps(setup):
    """beam_generate takes the per-op step with the switch off; at fp32 its
    beams are the monolith step's (both held against JAX elsewhere)."""
    _, pparams, latent, valid = setup
    kw = dict(beam_size=3, max_len=24, initial_segment=16,
              compute_dtype=torch.float32, cache_dtype=torch.float32,
              return_all_beams=True)
    per_op = decode.beam_generate(pparams, PCFG, _t(latent[:3]),
                                  _t(valid[:3]), **kw)
    decode_kernel.set_enabled(True)
    mono = decode.beam_generate(pparams, PCFG, _t(latent[:3]), _t(valid[:3]),
                                **kw)
    for a, b in zip(per_op[:2] + per_op[3:], mono[:2] + mono[3:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=0)


def test_streamed_per_op_equals_generate(setup):
    _, pparams, latent, valid = setup
    events = list(decode.streamed_generate(
        pparams, PCFG, _t(latent[:1]), _t(valid[:1]), max_len=60,
        flush_interval=7, compute_dtype=torch.float32))
    seqs = decode.generate(pparams, PCFG, _t(latent[:1]), _t(valid[:1]),
                           max_len=60, compute_dtype=torch.float32,
                           cache_dtype=torch.float32)[0]
    np.testing.assert_array_equal(events[-1][1][0].numpy(), seqs.numpy())
    streamed = np.concatenate([e[1] for e in events[:-1]] or [np.zeros((1, 0))],
                              axis=1)
    np.testing.assert_array_equal(streamed[0],
                                  seqs.numpy()[0, 1:1 + streamed.shape[1]])


def test_per_op_caches_grow_on_the_last_axis_without_rounding():
    st = decode.init_decode_state(PCFG, 2, 64, 13, torch.int8, monolith=False)
    assert st.k_cache.shape == (2, 2, 4, 16, 13)
    assert st.k_scale.shape == (2, 2, 4, 13)
    assert st.k_scale.dtype == torch.float32
    grown = decode.grow_cache(st, 29)
    assert grown.k_cache.shape[-1] == 29 and decode.cache_len_of(
        grown.k_cache) == 29
    assert bool((grown.k_scale[..., 13:] == 1.0).all())
    assert bool((grown.k_cache[..., 13:] == 0).all())
