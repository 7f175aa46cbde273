"""The port's decode step and greedy generate against the JAX package at fp32.

The JAX side runs its monolithic Pallas decode-step kernel
(``pallas_monolith.decode_layers``, forced, in the Pallas interpreter, as
tests/test_monolith.py runs it); the port runs the plain twins of its
K1/K2/K4 kernels (what its wrappers do for CPU tensors). Same weights via
``params_from_jax``, same inputs from ``np.random.default_rng``.
Tolerances: logits 2e-4 absolute (as tests/test_monolith.py); tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.omr_decoder import init_decoder_params
from acai_omr_tpu.ops import nn as jax_nn
from acai_omr_tpu.ops import pallas_monolith

from acai_omr_tpu_torch.models import decode, omr_decoder
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import _flatten, _unflatten
from acai_omr_tpu_torch.ops import decode_kernel, nn

from _torch_port_threads import torch_one_thread  # noqa: F401

DEC = dict(max_lmx_seq_len=64, vocab_size=33, num_layers=2, hidden_dim=256,
           num_heads=4, mlp_dim=1024, eos_idx=2)
JCFG = JaxDecoderConfig(**DEC)
PCFG = DecoderConfig(**DEC)
B, M, T_CACHE = 8, 32, 32
# raises <eos>'s logit so rows finish at different steps and the generate
# tests see both finished-row compaction and cache growth
EOS_BIAS = 0.5


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


@pytest.fixture(scope="module")
def setup():
    params = init_decoder_params(jax.random.PRNGKey(0), JCFG)
    params["unembed"]["bias"] = params["unembed"]["bias"].at[2].add(EOS_BIAS)
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((B, M, 256)).astype(np.float32)
    valid = np.arange(M)[None, :] < np.array([M, M - 5, 17, M, 9, 30, M, 21]
                                             )[:, None]
    return params, to_port(params), latent, valid


def test_memory_kv_matches_jax(setup):
    jparams, pparams, latent, valid = setup
    jm = jax_decode.precompute_memory_kv(jparams, JCFG, jnp.asarray(latent),
                                         jnp.asarray(valid), jnp.float32,
                                         jnp.float32, layout="te")
    pm = decode.precompute_memory_kv(pparams, PCFG, torch.from_numpy(latent),
                                     torch.from_numpy(valid), torch.float32,
                                     torch.float32)
    np.testing.assert_allclose(pm.k.numpy(), np.asarray(jm.k), atol=2e-5)
    np.testing.assert_allclose(pm.v.numpy(), np.asarray(jm.v), atol=2e-5)
    np.testing.assert_array_equal(pm.bias.numpy(), np.asarray(jm.bias))


def test_step_matches_monolith(setup):
    """One decode step: logits and the appended cache rows."""
    jparams, pparams, latent, valid = setup
    rng = np.random.default_rng(1)
    pos = 5
    kc = rng.standard_normal((2, B, T_CACHE, 256)).astype(np.float32)
    vc = rng.standard_normal((2, B, T_CACHE, 256)).astype(np.float32)
    x = rng.standard_normal((B, 256)).astype(np.float32)
    mem = decode.precompute_memory_kv(pparams, PCFG, torch.from_numpy(latent),
                                      torch.from_numpy(valid), torch.float32,
                                      torch.float32)

    mono = pallas_monolith.prepack(jparams, JCFG, jnp.float32)
    bias_col = jnp.asarray(mem.bias.numpy()).reshape(B, M, 1)
    j_out, j_k, j_v = pallas_monolith.decode_layers(
        mono, jnp.asarray(x), pos, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(mem.k.numpy()), jnp.asarray(mem.v.numpy()), bias_col,
        num_heads=4)
    j_out = jax_nn.layernorm(jparams["final_norm"], j_out, eps=1e-6)
    j_logits = np.asarray(jax_nn.dense(jparams["unembed"], j_out))

    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    p_out = decode_kernel.decode_layers(
        decode_kernel.prepack(pparams, torch.float32), torch.from_numpy(x),
        pos, k_t, v_t, mem.k, mem.v, mem.bias, 4)
    p_out = nn.layernorm(pparams["final_norm"], p_out, eps=1e-6)
    p_logits = nn.dense(pparams["unembed"], p_out).numpy()

    np.testing.assert_allclose(p_logits, j_logits, atol=2e-4, rtol=0)
    np.testing.assert_allclose(k_t[:, :, :pos + 1].numpy(),
                               np.asarray(j_k)[:, :, :pos + 1], atol=2e-5)
    np.testing.assert_allclose(v_t[:, :, :pos + 1].numpy(),
                               np.asarray(j_v)[:, :, :pos + 1], atol=2e-5)
    # rows past pos are untouched
    np.testing.assert_array_equal(k_t[:, :, pos + 1:].numpy(),
                                  kc[:, :, pos + 1:])


def _generate_both(setup, pe_offset):
    jparams, pparams, latent, valid = setup
    kwargs = dict(max_len=48, initial_segment=16, pe_offset=pe_offset)
    j = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                            jnp.asarray(valid), compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32, **kwargs)
    p = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), compute_dtype=torch.float32,
                        cache_dtype=torch.float32, **kwargs)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


@pytest.mark.parametrize("pe_offset", [0, 1])
def test_generate_token_identical(setup, pe_offset):
    (js, jl, jm), (ps, pl, pm) = _generate_both(setup, pe_offset)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, atol=2e-4, rtol=0)
    # the first 16-slot segment ended with some rows finished and 1..4 live:
    # the live rows were compacted to a power of two and the cache grew
    lengths = pm.sum(axis=1)
    live = int((lengths > 17).sum())
    assert 1 <= live <= B // 2, lengths
    assert lengths.max() > 17


def test_generate_matches_teacher_forced_rescoring(setup):
    """Cached greedy decode == the dense teacher-forced forward run on the
    generated tokens (pe_offset 0 is the training forward's PE indexing)."""
    _, pparams, latent, valid = setup
    seqs, lps, mask = decode.generate(
        pparams, PCFG, torch.from_numpy(latent), torch.from_numpy(valid),
        max_len=48, initial_segment=16, compute_dtype=torch.float32,
        cache_dtype=torch.float32)
    logits = omr_decoder.forward(pparams, PCFG, seqs[:, :-1],
                                 torch.from_numpy(latent), None,
                                 torch.from_numpy(valid))
    chosen = mask[:, 1:].numpy()
    np.testing.assert_array_equal(logits.argmax(-1).numpy()[chosen],
                                  seqs[:, 1:].numpy()[chosen])
    lp = torch.log_softmax(logits, -1).gather(-1, seqs[:, 1:, None])[..., 0]
    np.testing.assert_allclose(lp.numpy()[chosen], lps[:, 1:].numpy()[chosen],
                               atol=2e-4, rtol=0)
