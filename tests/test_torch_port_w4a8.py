"""W4A8 decode (K14), the weight switches (ACAI_W8A8_DECODE /
ACAI_W4A8_DECODE) and the split-schedule backward of the port against the JAX
package at fp32 on the CPU.

The JAX side runs ``pallas_monolith`` forced, in the Pallas interpreter (as
tests/test_monolith.py runs it), and the training stack's
``_bwd_split_kernel`` through ``jax.grad`` of ``decoder_stack_fused`` in
interpret mode; the port runs the plain twins of its kernels (what its
wrappers do for CPU tensors). Same weights and inputs, made with
``np.random.default_rng``. Every switch is set on both sides for a test and
restored after it. Each tolerance is stated where it is used.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.omr_decoder import init_decoder_params
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.ops import transformer as jax_tf

from acai_omr_tpu_torch.models import decode
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import decode_kernel
from acai_omr_tpu_torch.ops import train_layer_kernel as tlk
from acai_omr_tpu_torch.ops.quant_linear_kernel import (
    pack_k8_int4, quant4_linear_bias_act, unpack_k8_int4)

from _torch_port_threads import torch_one_thread  # noqa: F401

DEC = dict(max_lmx_seq_len=64, vocab_size=33, num_layers=2, hidden_dim=256,
           num_heads=4, mlp_dim=1024, eos_idx=2)
JCFG = JaxDecoderConfig(**DEC)
PCFG = DecoderConfig(**DEC)
L, E, H, F = 2, 256, 4, 1024
B, M, T_CACHE = 8, 32, 64
EOS_BIAS = 0.3  # some rows finish inside the first segment


@pytest.fixture(autouse=True)
def _switches():
    """The JAX monolith forced in interpret mode; every weight switch of
    both packages restored after each test."""
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET,
            pallas_monolith._W8A8, pallas_monolith._W4A8,
            decode_kernel._W8A8, decode_kernel._W4A8)
    pallas_monolith.set_test_mode(force=True, interpret=True)
    yield
    pallas_monolith.set_test_mode(*prev[:2])
    pallas_monolith._W8A8, pallas_monolith._W4A8 = prev[2:4]
    jax.clear_caches()
    decode_kernel.set_w8a8(prev[4])
    decode_kernel.set_w4a8(prev[5])


def _set_modes(w8a8: bool, w4a8: bool):
    """Both packages' weight switches. JAX reads its switches while it
    traces, so its compiled functions are dropped with them."""
    pallas_monolith._W8A8, pallas_monolith._W4A8 = w8a8, w4a8
    jax.clear_caches()
    decode_kernel.set_w8a8(w8a8)
    decode_kernel.set_w4a8(w4a8)


def to_port(tree):
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


def _jax_unpacked(mono4, name, cin, cout):
    """JAX's int4 pack of one matrix -> its (L, IN, OUT) int values, the two
    ``unpack_int4`` halves joined along ``int4_pack_axis``."""
    lo, hi = pallas_monolith.unpack_int4(
        jnp.asarray(mono4[name], jnp.float32))
    axis = 1 if pallas_monolith.int4_pack_axis(cin, cout) == 0 else 2
    return np.concatenate([np.asarray(lo), np.asarray(hi)], axis=axis)


_SHAPES = {"w_qkv": (E, 3 * E), "w_self_out": (E, E), "w_cross_q": (E, E),
           "w_cross_out": (E, E), "w_ff1": (E, F), "w_ff2": (F, E)}


def test_prepack_int4_equals_jax(setup):
    """(a) The port's int4 values, unpacked from its own layout, equal JAX's
    ``unpack_int4`` of its ``prepack("int4")``, and the column scales equal
    ``wscale4``: exact."""
    jparams, pparams, _, _ = setup
    jm = pallas_monolith.prepack(jparams, JCFG, jnp.float32,
                                 quantize_weights="int4")
    pm = decode_kernel.prepack(pparams, torch.float32, quantize_weights="int4")
    for row, name in enumerate(decode_kernel._MATS):
        cin, cout = _SHAPES[name]
        assert pm[name].dtype == torch.int32
        assert pm[name].shape == (L, cin // 8, cout)
        got = unpack_k8_int4(pm[name]).numpy()
        np.testing.assert_array_equal(got, _jax_unpacked(jm, name, cin, cout))
        np.testing.assert_array_equal(
            pm["s_" + name[2:]].numpy(), np.asarray(jm["wscale4"])[:, row, :cout])
    assert unpack_k8_int4(pm["w_ff1"]).abs().max() == 7


def test_pack_k8_int4_round_trip_and_layout():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-7, 8, (2, 24, 5)))
    w = pack_k8_int4(q)
    assert w.shape == (2, 3, 5) and w.dtype == torch.int32
    assert torch.equal(unpack_k8_int4(w), q.to(torch.int8))
    word = int(w[1, 2, 3]) & 0xFFFFFFFF
    for j in range(4):  # byte j: rows 16 + j (low nibble), 20 + j (high)
        byte = (word >> (8 * j)) & 0xFF
        assert (byte & 0xF) - 8 == int(q[1, 16 + j, 3])
        assert (byte >> 4) - 8 == int(q[1, 20 + j, 3])
    with pytest.raises(ValueError, match="IN % 8"):
        pack_k8_int4(q[:, :12])


@pytest.mark.parametrize("m,k,n,act", [(8, 256, 768, "none"),
                                       (3, 1024, 256, "none"),
                                       (5, 256, 1024, "gelu_rounded")])
def test_quant4_twin_matches_qdot(setup, m, k, n, act):
    """(b) K14's twin against ``_qdot`` on JAX's unpacked weights and the
    same column scales: the integer product is exact on both sides and the
    dequantization multiplies in the same order, so rtol 1e-6 (one fp32
    ulp); the GELU case against ``_qdot`` followed by JAX's exact GELU, with
    atol 1e-6 beside it (the two erf implementations differ by an ulp where
    GELU is near 0)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    q = rng.integers(-7, 8, (k, n)).astype(np.int8)
    s = bf16_round(rng.uniform(1e-3, 2e-2, (1, n)).astype(np.float32))
    ref = np.asarray(pallas_monolith._qdot(jnp.asarray(x), jnp.asarray(q),
                                           jnp.asarray(s)))
    if act == "gelu_rounded":
        r = jnp.asarray(ref).astype(jnp.float32)
        ref = np.asarray(jax.nn.gelu(r, approximate=False))
    out = quant4_linear_bias_act(
        torch.from_numpy(x), pack_k8_int4(torch.from_numpy(q)),
        torch.from_numpy(s[0]), torch.zeros(n), act).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6,
                               atol=1e-6 if act != "none" else 0)


@pytest.mark.parametrize("w8a8,w4a8", list(itertools.product([False, True],
                                                             repeat=2)))
def test_weight_quant_mode_equals_jax(w8a8, w4a8):
    """(f) The four switch combinations, under int8 and under compute-dtype
    caches, resolve as JAX's single-device ``weight_quant_mode``."""
    _set_modes(w8a8, w4a8)
    assert decode_kernel.weight_quant_mode(torch.int8) == \
        pallas_monolith.weight_quant_mode(jnp.int8)
    assert decode_kernel.weight_quant_mode(torch.bfloat16) is False
    assert pallas_monolith.weight_quant_mode(jnp.bfloat16) is False


def _random_int8_state(rng, rows, t_len, pos):
    def one():
        c = np.zeros((L, rows, t_len, E), np.int8)
        s = np.ones((L, rows, t_len, H), np.float32)
        c[:, :, :pos] = rng.integers(-127, 128, (L, rows, pos, E))
        s[:, :, :pos] = bf16_round(
            rng.uniform(2e-3, 3e-2, (L, rows, pos, H)).astype(np.float32))
        return c, s
    (kc, ks), (vc, vs) = one(), one()
    return kc, vc, ks, vs


def _mems(setup):
    jparams, _, latent, valid = setup
    jm = jax_decode.precompute_memory_kv(
        jparams, JCFG, jnp.asarray(latent), jnp.asarray(valid), jnp.float32,
        jnp.int8, layout="te")
    pm = decode.MemoryKV(*(torch.from_numpy(np.array(a)) for a in
                           (jm.k, jm.v, jm.bias)),
                         *(torch.from_numpy(np.array(a)).to(torch.bfloat16)
                           for a in (jm.k_scale, jm.v_scale)))
    return jm, pm


def _jax_step(jparams, x, pos, kc, vc, ks, vs, jmem):
    """JAX's int8 step with the weights of its ``weight_quant_mode``."""
    mode = pallas_monolith.weight_quant_mode(jnp.int8)
    mono = pallas_monolith.prepack(jparams, JCFG, jnp.float32,
                                   quantize_weights=mode)
    g = pallas_monolith.scale_pack_group(B, kc.shape[2], M, E, H,
                                         w8a8=mode == "int8",
                                         w4a8=mode == "int4")
    pack = lambda s: pallas_monolith.pack_scales(
        jnp.asarray(s).astype(jnp.bfloat16), g)
    out = pallas_monolith.decode_layers(
        mono, jnp.asarray(x), pos, jnp.asarray(kc), jnp.asarray(vc), jmem.k,
        jmem.v, jmem.bias.reshape(-1, M, 1).astype(jnp.float32), num_heads=H,
        k_scale=pack(ks), v_scale=pack(vs), mem_k_scale=pack(jmem.k_scale),
        mem_v_scale=pack(jmem.v_scale))
    return np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[2])


def _port_step(pparams, x, pos, kc, vc, ks, vs, pmem):
    """The port's int8 step with the operands of ``_prepack_for``."""
    mono = decode._prepack_for(pparams, torch.float32, torch.int8)
    t = lambda a: torch.from_numpy(a.copy())
    kc_t, vc_t = t(kc), t(vc)
    out = decode_kernel.decode_layers(
        mono, t(x), pos, kc_t, vc_t, pmem.k, pmem.v, pmem.bias, H,
        k_scale=t(ks).to(torch.bfloat16), v_scale=t(vs).to(torch.bfloat16),
        mem_k_scale=pmem.k_scale, mem_v_scale=pmem.v_scale)
    return out.numpy(), kc_t.numpy(), vc_t.numpy(), mono


@pytest.mark.parametrize("mode", ["int4", "off"])
@pytest.mark.parametrize("pos", [0, 37])
def test_int8_step_matches_monolith(setup, mode, pos):
    """(c) W4A8 and (e) ``ACAI_W8A8_DECODE=0``: one int8-cache step through
    both layers against JAX's ``decode_layers`` with the same switches, at
    pos 0 and mid-cache, the port's operands from ``_prepack_for``. Hidden
    state atol 2e-3 (fp32 summation order, plus any activation that lands on
    the other side of a rounding boundary in a later layer), the appended
    int8 rows equal on all but 0.5 % of entries and never off by more than
    1, as tests/test_torch_port_quant.py's W8A8 step."""
    _set_modes(w8a8=True, w4a8=mode == "int4") if mode == "int4" \
        else _set_modes(w8a8=False, w4a8=False)
    jparams, pparams, _, _ = setup
    jm, pm = _mems(setup)
    rng = np.random.default_rng(20 + pos)
    x = rng.standard_normal((B, E)).astype(np.float32)
    state = _random_int8_state(rng, B, T_CACHE, pos)
    j = _jax_step(jparams, x, pos, *state, jm)
    p = _port_step(pparams, x, pos, *state, pm)
    mono = p[3]
    if mode == "int4":
        assert mono["w_qkv"].dtype == torch.int32 and "s_qkv" in mono
    else:
        assert mono["w_qkv"].dtype == torch.float32 and "s_qkv" not in mono
    np.testing.assert_allclose(p[0], j[0], atol=2e-3, rtol=0)
    for i in (1, 2):
        diff = np.abs(p[i][:, :, pos].astype(np.int32)
                      - j[i][:, :, pos].astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() <= 0.005


def test_w4a8_weights_need_int8_caches(setup):
    _, pparams, _, _ = setup
    mono = decode_kernel.prepack(pparams, torch.float32,
                                 quantize_weights="int4")
    st = decode.init_decode_state(PCFG, 2, 8, 16, torch.float32)
    mem = decode.precompute_memory_kv(pparams, PCFG, torch.zeros(2, M, E),
                                      None, torch.float32, torch.float32)
    with pytest.raises(ValueError, match="need int8 caches"):
        decode_kernel.decode_layers(mono, torch.zeros(2, E), 0, st.k_cache,
                                    st.v_cache, mem.k, mem.v, mem.bias, H)


def _assert_same_operands(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_prepack_for_reuses_operands_until_params_change(setup):
    """``_prepack_for`` hands back the operands it made while the same
    params, unchanged, decode with the same dtype and weight mode; another
    weight mode, other tensors or an in-place update pack anew, equal to a
    fresh ``prepack``."""
    _set_modes(w8a8=True, w4a8=True)
    pparams = setup[1]
    first = decode._prepack_for(pparams, torch.float32, torch.int8)
    assert decode._prepack_for(pparams, torch.float32, torch.int8) is first
    _set_modes(w8a8=True, w4a8=False)
    w8 = decode._prepack_for(pparams, torch.float32, torch.int8)
    _assert_same_operands(w8, decode_kernel.prepack(
        pparams, torch.float32, quantize_weights="int8"))
    params = _unflatten({k: v.clone() for k, v in _flatten(pparams).items()})
    again = decode._prepack_for(params, torch.float32, torch.int8)
    assert again is not w8
    _assert_same_operands(again, w8)
    params["blocks"]["linear1"]["kernel"].mul_(2.0)
    moved = decode._prepack_for(params, torch.float32, torch.int8)
    _assert_same_operands(moved, decode_kernel.prepack(
        params, torch.float32, quantize_weights="int8"))
    assert torch.equal(moved["s_ff1"], 2 * w8["s_ff1"])
    assert decode._prepack_for(pparams, torch.bfloat16, torch.bfloat16)[
        "w_qkv"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["int4", "off"])
def test_int8_generate_matches_jax(setup, mode):
    """(d) W4A8 ``generate`` and (e) int8 ``generate`` with W8A8 off,
    through a cache growth and a compaction: the same tokens as JAX's with
    the same switches; log-probs atol 5e-3 (a quantization flip of a single
    entry moves a log-prob by about 1e-3)."""
    _set_modes(w8a8=mode == "int4", w4a8=mode == "int4")
    jparams, pparams, latent, valid = setup
    kw = dict(max_len=48, initial_segment=16)
    j = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                            jnp.asarray(valid), compute_dtype=jnp.float32,
                            cache_dtype=jnp.int8, **kw)
    p = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), compute_dtype=torch.float32,
                        cache_dtype=torch.int8, **kw)
    (js, jl, jmask), (ps, pl, pmask) = ([np.asarray(a) for a in j],
                                        [a.numpy() for a in p])
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_allclose(pl, jl, atol=5e-3, rtol=0)
    lengths = pmask.sum(axis=1)
    assert lengths.min() < 33 < lengths.max(), lengths


def test_w4a8_beam_generate_matches_jax(setup):
    """(d) W4A8 beams (grouped memory, parent reorder of the int8 caches):
    the best beam's tokens equal JAX's; log-probs atol 5e-3."""
    _set_modes(w8a8=True, w4a8=True)
    jparams, pparams, latent, valid = setup
    kw = dict(beam_size=3, max_len=24, initial_segment=16)
    j = jax_decode.beam_generate(jparams, JCFG, jnp.asarray(latent[:2]),
                                 jnp.asarray(valid[:2]),
                                 compute_dtype=jnp.float32,
                                 cache_dtype=jnp.int8, **kw)
    p = decode.beam_generate(pparams, PCFG, torch.from_numpy(latent[:2]),
                             torch.from_numpy(valid[:2]),
                             compute_dtype=torch.float32,
                             cache_dtype=torch.int8, **kw)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(p[1].numpy(), np.asarray(j[1]), atol=5e-3,
                               rtol=0)


# ---------------------------------------------------------------------------
# the split backward switch
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_split_backward_matches_jax_split_kernel(monkeypatch):
    """(g) The port's backward, always the split schedule, against
    ``jax.grad`` of ``decoder_stack_fused`` with ``_bwd_split_kernel``
    chosen by ``ACAI_BWD_SPLIT`` (interpret mode). Every gradient within
    1e-5 of the largest magnitude of its leaf (fp32 sums in another
    order)."""
    sl, sb, st, sm, se, sh, sf = 2, 2, 16, 32, 128, 2, 256
    stacked = jax_tf.stack_init(jax_tf.decoder_layer_init,
                                jax.random.PRNGKey(0), sl, se, sf)
    rng = np.random.default_rng(3)
    stacked = jax.tree.map(
        lambda v: np.asarray(v) + 0.05 * rng.standard_normal(
            v.shape).astype(np.float32), stacked)
    x = rng.standard_normal((sb, st, se)).astype(np.float32)
    mem = rng.standard_normal((sl, sb, sm, 2 * se)).astype(np.float32)
    w = rng.standard_normal((sb, st, se)).astype(np.float32)
    sv = np.arange(st)[None] < np.array([st, 11])[:, None]
    mv = np.arange(sm)[None] < np.array([sm, 20])[:, None]

    monkeypatch.setattr(ptl, "_BWD_SPLIT", True)
    assert ptl.bwd_split_fits(sb, st, se, sf, sm, 4)
    prev = (ptl._FORCE, ptl._INTERPRET)
    ptl.set_test_mode(force=True, interpret=True)
    try:
        run = lambda s, x_, m_: ptl.decoder_stack_fused(
            s, x_, m_, jnp.asarray(sv), jnp.asarray(mv), sh)
        grads_j = jax.grad(lambda *a: jnp.sum(run(*a) * w),
                           argnums=(0, 1, 2))(
            jax.tree.map(jnp.asarray, stacked), jnp.asarray(x),
            jnp.asarray(mem))
    finally:
        ptl.set_test_mode(*prev)

    tree = to_port_tree(stacked)
    for _, v in _leaves(tree):
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    out = tlk.decoder_stack_fused(tree, xt, mt, torch.from_numpy(sv),
                                  torch.from_numpy(mv), sh)
    (out * torch.from_numpy(w)).sum().backward()
    got = {n: v.grad for n, v in _leaves(tree)}
    want = dict(_leaves(jax.tree.map(np.asarray, grads_j[0])))
    assert want.keys() == got.keys()
    pairs = [(n, got[n], want[n]) for n in want] \
        + [("x", xt.grad, np.asarray(grads_j[1])),
           ("mem_kv", mt.grad, np.asarray(grads_j[2]))]
    for name, g, ref in pairs:
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def to_port_tree(tree):
    return {k: to_port_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}
