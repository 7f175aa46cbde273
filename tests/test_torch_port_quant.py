"""The port's quantized decode (int8 KV caches, W8A8 weights, grouped memory)
against the JAX package's monolith kernel at fp32 compute.

The JAX side runs ``pallas_monolith.decode_layers`` forced, in the Pallas
interpreter (as tests/test_monolith.py runs it); the port runs the plain twins
of its K5/K6 kernels (what its wrappers do for CPU tensors). Same weights via
``params_from_jax``-style conversion, same inputs from
``np.random.default_rng``. The JAX scale planes are lane-packed and are
unpacked with ``unpack_scales`` before comparing. Each tolerance is stated
where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.omr_decoder import init_decoder_params
from acai_omr_tpu.ops import pallas_monolith

from acai_omr_tpu_torch.models import decode
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import decode_kernel
from acai_omr_tpu_torch.ops.quant_linear_kernel import (
    pack_k4, quant_linear_bias_act, unpack_k4)

from _torch_port_threads import torch_one_thread  # noqa: F401

DEC = dict(max_lmx_seq_len=64, vocab_size=33, num_layers=2, hidden_dim=256,
           num_heads=4, mlp_dim=1024, eos_idx=2)
JCFG = JaxDecoderConfig(**DEC)
PCFG = DecoderConfig(**DEC)
L, E, H, F = 2, 256, 4, 1024
B, M, T_CACHE = 8, 32, 64
# raises <eos>'s logit so some rows finish inside the first 32-slot segment
# and the rest see a compaction and a cache growth
EOS_BIAS = 0.3
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values, upper bound 2**-7


@pytest.fixture(autouse=True)
def _monolith():
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET)
    pallas_monolith.set_test_mode(force=True, interpret=True)
    yield
    pallas_monolith.set_test_mode(*prev)


def to_port(tree):
    """JAX decoder tree -> port tensors (CPU, fp32)."""
    return _unflatten({k: torch.from_numpy(np.array(v)) for k, v in
                       _flatten(jax.tree.map(np.asarray, tree)).items()})


def bf16_round(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.fixture(scope="module")
def setup():
    params = init_decoder_params(jax.random.PRNGKey(0), JCFG)
    params["unembed"]["bias"] = params["unembed"]["bias"].at[2].add(EOS_BIAS)
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((B, M, E)).astype(np.float32)
    valid = np.arange(M)[None, :] < np.array([M, M - 5, 17, M, 9, 30, M, 21]
                                             )[:, None]
    return params, to_port(params), latent, valid


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 4, 32), (2, 128)])
def test_quantize_rows_equals_jax(shape):
    """int8 values and bf16-rounded scales: equal, entry for entry."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * rng.uniform(1e-3, 30, shape[:-1] + (1,))
         ).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = jax_decode._quantize_rows(jnp.asarray(x), jnp.bfloat16)
    pq, ps = decode_kernel.quantize_rows(torch.from_numpy(x), torch.bfloat16)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # the unrounded-scale form (the per-op path) carries over too
    jq, js = jax_decode._quantize_rows(jnp.asarray(x))
    pq, ps = decode_kernel.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_prepack_int8_equals_jax(setup):
    """The same JAX parameters give equal int8 weights and column scales."""
    jparams, pparams, _, _ = setup
    jm = pallas_monolith.prepack(jparams, JCFG, jnp.float32,
                                 quantize_weights=True)
    pm = decode_kernel.prepack(pparams, torch.float32, quantize_weights="int8")
    for row, name in enumerate(decode_kernel._MATS):
        w8 = unpack_k4(pm[name]).numpy()
        np.testing.assert_array_equal(w8, np.asarray(jm[name]))
        width = w8.shape[-1]
        np.testing.assert_array_equal(
            pm["s_" + name[2:]].numpy(),
            np.asarray(jm["wscale"])[:, row, :width])
    # the unquantized operands are untouched by the new argument
    pf = decode_kernel.prepack(pparams, torch.float32)
    assert pf["w_qkv"].dtype == torch.float32 and "s_qkv" not in pf
    np.testing.assert_array_equal(pf["b_ff1"].numpy(), pm["b_ff1"].numpy())
    # int4 (W4A8) packs eight rows a word (held against JAX in
    # tests/test_torch_port_w4a8.py); other modes are refused
    p4 = decode_kernel.prepack(pparams, torch.float32, quantize_weights="int4")
    assert p4["w_qkv"].dtype == torch.int32 and "s_qkv" in p4
    np.testing.assert_array_equal(p4["b_ff1"].numpy(), pm["b_ff1"].numpy())
    with pytest.raises(ValueError, match="weight mode"):
        decode_kernel.prepack(pparams, torch.float32, quantize_weights="int2")


def test_pack_k4_round_trip():
    w = torch.arange(-60, 60, dtype=torch.int8).reshape(2, 12, 5)
    p = pack_k4(w)
    assert p.shape == (2, 3, 5, 4) and p.is_contiguous()
    assert torch.equal(p[1, 2, 3], w[1, 8:12, 3])
    assert torch.equal(unpack_k4(p), w)


@pytest.mark.parametrize("m,k,n", [(8, 256, 768), (3, 1024, 256)])
def test_quant_linear_twin_matches_qdot(m, k, n):
    """K5's twin vs ``pallas_monolith._qdot`` on the same x, w8 and column
    scales: the integer product is exact on both sides and the dequantization
    multiplies in the same order, so rtol 1e-6 (one fp32 ulp)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w8 = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = bf16_round(rng.uniform(1e-3, 2e-2, (1, n)).astype(np.float32))
    ref = np.asarray(pallas_monolith._qdot(jnp.asarray(x), jnp.asarray(w8),
                                           jnp.asarray(s)))
    out = quant_linear_bias_act(
        torch.from_numpy(x), pack_k4(torch.from_numpy(w8)),
        torch.from_numpy(s[0]), torch.zeros(n)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_quant_linear_twin_epilogues():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    w4 = pack_k4(torch.from_numpy(rng.integers(-127, 128, (128, 128))
                                  .astype(np.int8)))
    s = torch.full((128,), 2.0 ** -9)
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    u = quant_linear_bias_act(x, w4, s, b)
    g = quant_linear_bias_act(x, w4, s, b, "gelu_rounded")
    ref = 0.5 * u * (1.0 + torch.erf(u / np.sqrt(2.0)))
    np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        quant_linear_bias_act(x, w4, s, b, "relu")


def _random_int8_state(rng, rows, t_len, pos):
    """Caches with ``pos`` random int8 rows and bf16-valued scales; zeros and
    ones beyond (what an earlier decode leaves)."""
    def one():
        c = np.zeros((L, rows, t_len, E), np.int8)
        s = np.ones((L, rows, t_len, H), np.float32)
        c[:, :, :pos] = rng.integers(-127, 128, (L, rows, pos, E))
        s[:, :, :pos] = bf16_round(
            rng.uniform(2e-3, 3e-2, (L, rows, pos, H)).astype(np.float32))
        return c, s
    (kc, ks), (vc, vs) = one(), one()
    return kc, vc, ks, vs


def _jax_int8_step(jparams, w8a8, x, pos, kc, vc, ks, vs, jmem, mem_group=1):
    mono = pallas_monolith.prepack(jparams, JCFG, jnp.float32,
                                   quantize_weights=w8a8)
    rows, t_len = kc.shape[1], kc.shape[2]
    g = pallas_monolith.scale_pack_group(rows, t_len, M, E, H,
                                         mem_group=mem_group, w8a8=w8a8)
    pack = lambda s: pallas_monolith.pack_scales(
        jnp.asarray(s).astype(jnp.bfloat16), g)
    mks, mvs = jmem.k_scale, jmem.v_scale
    if mem_group == 1:
        mks, mvs = pack(mks), pack(mvs)
    else:
        mks, mvs = mks.astype(jnp.bfloat16), mvs.astype(jnp.bfloat16)
    bias_col = jmem.bias.reshape(-1, M, 1).astype(jnp.float32)
    out = pallas_monolith.decode_layers(
        mono, jnp.asarray(x), pos, jnp.asarray(kc), jnp.asarray(vc), jmem.k,
        jmem.v, bias_col, num_heads=H, k_scale=pack(ks), v_scale=pack(vs),
        mem_k_scale=mks, mem_v_scale=mvs, mem_group=mem_group)
    unpack = lambda s: np.asarray(pallas_monolith.unpack_scales(
        s.astype(jnp.float32), g))
    return (np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2]),
            unpack(out[3]), unpack(out[4]))


def _port_int8_step(pparams, w8a8, x, pos, kc, vc, ks, vs, pmem, mem_group=1):
    mono = decode_kernel.prepack(pparams, torch.float32,
                                 quantize_weights="int8" if w8a8 else False)
    t = lambda a, dt=None: torch.from_numpy(a.copy()).to(dt) if dt \
        else torch.from_numpy(a.copy())
    kc_t, vc_t = t(kc), t(vc)
    ks_t, vs_t = t(ks, torch.bfloat16), t(vs, torch.bfloat16)
    out = decode_kernel.decode_layers(
        mono, t(x), pos, kc_t, vc_t, pmem.k, pmem.v, pmem.bias, H,
        k_scale=ks_t, v_scale=vs_t, mem_k_scale=pmem.k_scale,
        mem_v_scale=pmem.v_scale, mem_group=mem_group)
    return (out.numpy(), kc_t.numpy(), vc_t.numpy(), ks_t.float().numpy(),
            vs_t.float().numpy())


def _mems(setup, rows=slice(None)):
    jparams, pparams, latent, valid = setup
    jm = jax_decode.precompute_memory_kv(
        jparams, JCFG, jnp.asarray(latent[rows]), jnp.asarray(valid[rows]),
        jnp.float32, jnp.int8, layout="te")
    pm = decode.precompute_memory_kv(
        pparams, PCFG, torch.from_numpy(latent[rows]),
        torch.from_numpy(valid[rows]), torch.float32, torch.int8)
    return jm, pm


def _assert_rows_close(got, ref, what):
    """Quantized rows: equal on at least 99.5 % of entries and never off by
    more than 1 (a value that lands on the other side of .5 because XLA
    contracted a multiply-add that PyTorch did not). Returns the count."""
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, what
    n = int((diff != 0).sum())
    assert n <= 0.005 * diff.size, (what, n, diff.size)
    return n


def test_memory_kv_int8_matches_jax(setup):
    """int8 memory K/V and their bf16-rounded scales. The projections differ
    by fp32 summation order between XLA and PyTorch, so a value may land on
    the other side of a rounding boundary: rows as in the step test, scales
    within one bf16 ulp."""
    jm, pm = _mems(setup)
    assert pm.k.dtype == torch.int8 and pm.k_scale.dtype == torch.bfloat16
    assert pm.k_scale.shape == (L, B, M, H)
    for got, ref in ((pm.k, jm.k), (pm.v, jm.v)):
        _assert_rows_close(got.numpy(), np.asarray(ref), "memory rows")
    for got, ref in ((pm.k_scale, jm.k_scale), (pm.v_scale, jm.v_scale)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref),
                                   rtol=2 * BF16_ULP, atol=0)
    np.testing.assert_array_equal(pm.bias.numpy(), np.asarray(jm.bias))


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("pos", [0, 37])
def test_int8_step_matches_monolith(setup, w8a8, pos):
    """One int8 step through both layers, with and without W8A8, at pos 0
    (no cached key) and mid-cache. The port is fed the JAX package's int8
    memory, so only the step itself is compared.

    Hidden state atol 2e-3 (fp32 summation order, plus any rounding that
    lands on the other side of .5 in a later layer's input). Appended rows:
    see _assert_rows_close. Scales within one bf16 ulp. On these four seeded
    cases no appended entry of the 4096 per cache differs, the scales are
    equal and the hidden states agree within 1.1e-6; the allowances are for
    other seeds and other BLAS builds."""
    jparams, pparams, _, _ = setup
    jm, pm = _mems(setup)
    pm = decode.MemoryKV(*(torch.from_numpy(np.array(a)) for a in
                           (jm.k, jm.v, jm.bias)),
                         *(torch.from_numpy(np.array(a)).to(torch.bfloat16)
                           for a in (jm.k_scale, jm.v_scale)))
    rng = np.random.default_rng(10 + pos)
    x = rng.standard_normal((B, E)).astype(np.float32)
    state = _random_int8_state(rng, B, T_CACHE, pos)
    j = _jax_int8_step(jparams, w8a8, x, pos, *state, jm)
    p = _port_int8_step(pparams, w8a8, x, pos, *state, pm)
    np.testing.assert_allclose(p[0], j[0], atol=2e-3, rtol=0)
    for i in (1, 2):
        n = _assert_rows_close(p[i][:, :, pos], j[i][:, :, pos], "appended")
        assert n <= 3, n
        # rows other than pos are untouched
        np.testing.assert_array_equal(np.delete(p[i], pos, axis=2),
                                      np.delete(state[i - 1], pos, axis=2))
    for i in (3, 4):
        np.testing.assert_allclose(p[i][:, :, pos], j[i][:, :, pos],
                                   rtol=2 * BF16_ULP, atol=0)
        np.testing.assert_array_equal(np.delete(p[i], pos, axis=2),
                                      np.delete(state[i - 1], pos, axis=2))


def test_int8_attention_at_pos0_is_the_fresh_value():
    """No cached key: m = lc, every quantized weight is 0, and the result is
    the dequantized fresh v."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((3, 3 * E)).astype(np.float32))
    kc = torch.zeros((3, 32, E), dtype=torch.int8)
    vc = torch.zeros_like(kc)
    ks = torch.ones((3, 32, H), dtype=torch.bfloat16)
    vs = torch.ones_like(ks)
    out = decode_kernel.decode_attention_int8(qkv, kc, vc, ks, vs, H, pos=0)
    vq, s = decode_kernel.quantize_rows(qkv[:, 2 * E:].view(3, H, -1),
                                        torch.bfloat16)
    np.testing.assert_array_equal(
        out.numpy(), (vq.float() * s[..., None]).reshape(3, E).numpy())
    assert torch.equal(vc[:, 0], vq.reshape(3, E))
    assert torch.equal(vs[:, 0].float(), s)
    assert not kc[:, 1:].any() and bool((ks[:, 1:] == 1).all())


@pytest.mark.parametrize("quantized", [False, True])
def test_grouped_memory_equals_replicated(setup, quantized):
    """mem_group=G over B/G memory rows == the same step over the memory
    replicated G times: equal, bit for bit, in both cache modes."""
    _, pparams, latent, valid = setup
    g, bu = 4, 2
    rng = np.random.default_rng(7)
    cache_dtype = torch.int8 if quantized else torch.float32
    mem = decode.precompute_memory_kv(
        pparams, PCFG, torch.from_numpy(latent[:bu]),
        torch.from_numpy(valid[:bu]), torch.float32, cache_dtype)
    rep = torch.arange(bu).repeat_interleave(g)
    mem_rep = mem.rows(rep)
    x = torch.from_numpy(rng.standard_normal((bu * g, E)).astype(np.float32))
    mono = decode_kernel.prepack(pparams, torch.float32,
                                 quantize_weights="int8" if quantized
                                 else False)
    outs = []
    for m, group in ((mem, g), (mem_rep, 1)):
        st = decode.init_decode_state(PCFG, bu * g, 8, 32, cache_dtype)
        outs.append((decode_kernel.decode_layers(
            mono, x, 0, st.k_cache, st.v_cache, m.k, m.v, m.bias, H,
            k_scale=st.k_scale, v_scale=st.v_scale, mem_k_scale=m.k_scale,
            mem_v_scale=m.v_scale, mem_group=group), st))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].k_cache, outs[1][1].k_cache)
    with pytest.raises(ValueError, match="mem rows"):
        decode_kernel.decode_layers(
            mono, x, 0, st.k_cache, st.v_cache, mem.k, mem.v, mem.bias, H,
            k_scale=st.k_scale, v_scale=st.v_scale,
            mem_k_scale=mem.k_scale, mem_v_scale=mem.v_scale, mem_group=3)


def test_grouped_int8_step_matches_monolith(setup):
    """The grouped int8 step (beams' layout) against the JAX monolith with
    ``mem_group``: hidden state atol 2e-3, as the ungrouped step."""
    jparams, pparams, _, _ = setup
    g, bu, pos = 4, 2, 5
    jm, _ = _mems(setup, slice(0, bu))
    pm = decode.MemoryKV(*(torch.from_numpy(np.array(a)) for a in
                           (jm.k, jm.v, jm.bias)),
                         *(torch.from_numpy(np.array(a)).to(torch.bfloat16)
                           for a in (jm.k_scale, jm.v_scale)))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((bu * g, E)).astype(np.float32)
    state = _random_int8_state(rng, bu * g, T_CACHE, pos)
    j = _jax_int8_step(jparams, True, x, pos, *state, jm, mem_group=g)
    p = _port_int8_step(pparams, True, x, pos, *state, pm, mem_group=g)
    np.testing.assert_allclose(p[0], j[0], atol=2e-3, rtol=0)
    _assert_rows_close(p[1][:, :, pos], j[1][:, :, pos], "appended k")


def test_decode_layers_rejects_what_the_int8_kernel_cannot_take(setup):
    _, pparams, _, _ = setup
    mono = decode_kernel.prepack(pparams, torch.float32)
    x = torch.zeros((2, E))
    z8 = lambda *s: torch.zeros(s, dtype=torch.int8)
    ones = lambda *s: torch.ones(s, dtype=torch.bfloat16)
    bias = torch.zeros((2, M))

    def run(heads, t_len, m_len=M):
        return decode_kernel.decode_layers(
            mono, x, 0, z8(L, 2, t_len, E), z8(L, 2, t_len, E),
            z8(L, 2, m_len, E), z8(L, 2, m_len, E), bias[:, :1].expand(2, m_len),
            heads, k_scale=ones(L, 2, t_len, heads),
            v_scale=ones(L, 2, t_len, heads),
            mem_k_scale=ones(L, 2, m_len, heads),
            mem_v_scale=ones(L, 2, m_len, heads))

    with pytest.raises(ValueError, match="power-of-two head dim"):
        run(heads=3, t_len=32)          # 256 / 3 is no head dim at all
    with pytest.raises(ValueError, match="power-of-two head dim"):
        decode_kernel.decode_layers(    # E = 192, 2 heads: dh = 96
            mono, torch.zeros((2, 192)), 0, z8(L, 2, 32, 192),
            z8(L, 2, 32, 192), z8(L, 2, M, 192), z8(L, 2, M, 192), bias, 2,
            k_scale=ones(L, 2, 32, 2), v_scale=ones(L, 2, 32, 2),
            mem_k_scale=ones(L, 2, M, 2), mem_v_scale=ones(L, 2, M, 2))
    too_long = decode_kernel.MAX_INT8_KEYS + 32
    with pytest.raises(ValueError, match="keys in shared memory"):
        run(heads=H, t_len=too_long)
    with pytest.raises(ValueError, match="keys in shared memory"):
        run(heads=H, t_len=32, m_len=too_long)
    assert run(heads=H, t_len=32).shape == (2, E)


def test_int8_caches_grow_with_unit_scales_on_the_int8_time_tile():
    """The bf16-rounded-scale hazard's neighbours: int8 segments round up to
    the JAX int8 time tile (32, not 16) and grown scales are padded with 1."""
    assert decode.time_tile(torch.int8) == pallas_monolith.time_tile(jnp.int8)
    assert decode.time_tile(torch.float32) == \
        pallas_monolith.time_tile(jnp.float32)
    st = decode.init_decode_state(PCFG, 2, 8, 32, torch.int8)
    assert st.k_scale.shape == (L, 2, 32, H) and bool((st.k_scale == 1).all())
    st.k_scale[:, :, :3] = 0.5
    st.k_cache[:, :, :3] = 7
    grown = decode.grow_cache(st, 64)
    assert grown.k_cache.shape == (L, 2, 64, E)
    assert not grown.k_cache[:, :, 32:].any()
    assert bool((grown.k_scale[:, :, 32:] == 1).all())
    assert bool((grown.k_scale[:, :, :3] == 0.5).all())
    assert decode.grow_cache(grown, 48) is grown
    plain = decode.init_decode_state(PCFG, 2, 8, 16, torch.float32)
    assert plain.k_scale is None
    assert decode.grow_cache(plain, 32).k_scale is None


def _generate_int8(setup, **kw):
    jparams, pparams, latent, valid = setup
    kwargs = dict(max_len=48, initial_segment=16, **kw)
    j = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                            jnp.asarray(valid), compute_dtype=jnp.float32,
                            cache_dtype=jnp.int8, **kwargs)
    p = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), compute_dtype=torch.float32,
                        cache_dtype=torch.int8, **kwargs)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


def test_int8_generate_matches_jax(setup):
    """int8 greedy generate through a cache growth and a compaction: the same
    tokens as the JAX package on the seeded case; log-probs atol 5e-3
    (quantization flips of single entries move a log-prob by about 1e-3)."""
    (js, jl, jm), (ps, pl, pm) = _generate_int8(setup)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, atol=5e-3, rtol=0)
    # the first segment is 32 slots (the int8 time tile), not 16: some rows
    # finished inside it, the rest were compacted and the cache grew
    lengths = pm.sum(axis=1)
    assert 1 <= int((lengths > 33).sum()) <= B // 2, lengths


def test_int8_generate_is_near_fp32_generate(setup):
    """Near, not identical: on the seeded case most tokens agree with the
    fp32-cache decode over the common prefix."""
    _, pparams, latent, valid = setup
    kw = dict(max_len=48, initial_segment=16, compute_dtype=torch.float32)
    q = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), cache_dtype=torch.int8, **kw)
    f = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), cache_dtype=torch.float32,
                        **kw)
    assert q[0][:, :8].eq(f[0][:, :8]).float().mean() > 0.9
    # another float cache dtype decodes on the per-op step (F3); only a
    # cache dtype that is neither float nor int8 is refused
    h = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), cache_dtype=torch.float16,
                        **kw)
    assert h[0][:, :8].eq(f[0][:, :8]).float().mean() > 0.9
    with pytest.raises(ValueError, match="float dtype or in int8"):
        decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), cache_dtype=torch.int16,
                        **kw)
