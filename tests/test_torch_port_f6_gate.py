"""The monolith step's shape gate (``decode_kernel.monolith_takes``, asked by
``models.decode._monolith_for``): a decode takes the monolith step only
where every kernel of it takes the decoder's shapes on the device, and the
per-op step otherwise, as the JAX package's ``use_monolith`` falls back.

Two decoders whose shapes a kernel of the step refuses on the CPU too:
E = 1280 over 20 heads (K4 takes E <= 1024) with fp32 caches, and E = 768
over 16 heads (head dim 48, not a power of two) with int8 caches. On both
the port's ``generate`` must return the JAX package's tokens: JAX's CPU
decode runs its per-op step (``pallas_monolith.set_test_mode(force=False)``)
and so must the port's, with its monolith switch on. Weights from the
port's seeded initialisation, inputs from ``np.random.default_rng``; one
layer, a narrow MLP and vocabulary (the widths that trigger the gate kept).
Tolerances: tokens exact; log-probs 2e-4 (fp32 caches) and 1e-3 (int8
caches, as tests/test_torch_port_decode_hd.py: the JAX CPU scales may sit an
ulp off).
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
from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
from acai_omr_tpu_torch.ops import decode_kernel as dk
from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm

B, M, STEPS = 2, 8, 10
# (decoder widths, cache dtype name): the two inputs of the fault
INPUTS = {"e1280_fp32": (dict(hidden_dim=1280, num_heads=20, mlp_dim=256),
                         "fp32"),
          "dh48_int8": (dict(hidden_dim=768, num_heads=16, mlp_dim=256),
                        "int8")}
CACHE = {"fp32": (torch.float32, jnp.float32), "int8": (torch.int8, jnp.int8)}


def _cfg(widths):
    return dict(max_lmx_seq_len=32, vocab_size=33, num_layers=1, eos_idx=2,
                **widths)


@pytest.fixture(autouse=True)
def _switches():
    """The port's monolith switch on (the default), JAX on its unforced CPU
    decode; both restored after."""
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET, dk._ENABLED,
            hd._ENABLED, hd._ENABLED_INT8)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    dk.set_enabled(True)
    yield
    pallas_monolith.set_test_mode(*prev[:2])
    dk.set_enabled(prev[2])
    hd.set_enabled(prev[3])
    hd.set_enabled_int8(prev[4])


@pytest.fixture(scope="module")
def decoded():
    """Per input: the port's params and inputs, and JAX's greedy tokens,
    log-probs and mask for them (the JAX reference, traced once)."""
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    out = {}
    try:
        for name, (widths, cache) in INPUTS.items():
            pcfg = DecoderConfig(**_cfg(widths))
            pparams = init_decoder_params(torch.Generator().manual_seed(0),
                                          pcfg)
            jparams = _unflatten({k: jnp.asarray(v.numpy())
                                  for k, v in _flatten(pparams).items()})
            rng = np.random.default_rng(1)
            latent = rng.standard_normal((B, M, widths["hidden_dim"])) \
                .astype(np.float32)
            valid = np.arange(M)[None, :] < np.array([M, 5])[:, None]
            j = jax_decode.generate(
                jparams, JaxDecoderConfig(**_cfg(widths)), jnp.asarray(latent),
                jnp.asarray(valid), max_len=STEPS, initial_segment=STEPS,
                compute_dtype=jnp.float32, cache_dtype=CACHE[cache][1])
            out[name] = (pcfg, pparams, latent, valid,
                         [np.asarray(a) for a in j])
    finally:
        pallas_monolith.set_test_mode(*prev)
    return out


@pytest.mark.parametrize("name", list(INPUTS))
def test_generate_takes_the_per_op_step_and_returns_jax_tokens(
        decoded, name, monkeypatch):
    """The monolith switch is on, yet the gate sends the decode to the
    per-op step (the monolith's ``decode_layers`` is never called) and the
    tokens are JAX's."""
    pcfg, pparams, latent, valid, (js, jl, jm) = decoded[name]
    cache = CACHE[INPUTS[name][1]][0]

    def refuse(*args, **kwargs):
        raise AssertionError("the monolith step ran")
    monkeypatch.setattr(decode, "decode_layers", refuse)
    ps, pl, pm = (a.numpy() for a in decode.generate(
        pparams, pcfg, torch.from_numpy(latent), torch.from_numpy(valid),
        max_len=STEPS, initial_segment=STEPS, compute_dtype=torch.float32,
        cache_dtype=cache))
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, rtol=0,
                               atol=1e-3 if cache == torch.int8 else 2e-4)


@pytest.mark.parametrize("name", list(INPUTS))
def test_beams_and_streaming_take_the_per_op_step(decoded, name,
                                                  monkeypatch):
    """``beam_generate`` and (fp32 caches) ``streamed_generate`` ask the same
    gate: no monolith step, and one beam / the streamed tokens equal the
    greedy decode's."""
    pcfg, pparams, latent, valid, (js, _, _) = decoded[name]
    cache = CACHE[INPUTS[name][1]][0]
    monkeypatch.setattr(decode, "decode_layers", None)  # a call would fail
    lat, val = torch.from_numpy(latent[:1]), torch.from_numpy(valid[:1])
    seqs = decode.beam_generate(pparams, pcfg, lat, val, beam_size=1,
                                max_len=STEPS, initial_segment=STEPS,
                                compute_dtype=torch.float32,
                                cache_dtype=cache)[0]
    greedy = decode.generate(pparams, pcfg, lat, val, max_len=STEPS,
                             initial_segment=STEPS,
                             compute_dtype=torch.float32,
                             cache_dtype=cache)[0]
    np.testing.assert_array_equal(seqs.numpy(), greedy.numpy())
    if cache == torch.float32:
        *steps, (_, (fin, _, _)) = decode.streamed_generate(
            pparams, pcfg, lat, val, max_len=STEPS, flush_interval=4,
            compute_dtype=torch.float32)
        np.testing.assert_array_equal(fin.numpy(), greedy.numpy())


def test_the_kernels_checks_stay_strict():
    """The gate is decided before a decode; the ops still refuse what they
    do not take, on CPU tensors too."""
    x = torch.zeros(2, 1280)
    with pytest.raises(ValueError, match="E <= 1024"):
        add_layernorm(x, x, torch.ones(1280), torch.zeros(1280), 1e-5)
    mono = {"s_qkv": None}
    with pytest.raises(ValueError, match="power-of-two head dim"):
        dk._step_ops(mono, torch.zeros(2, 768),
                     torch.zeros(1, 2, 16, 768, dtype=torch.int8),
                     torch.zeros(1, 2, 8, 768, dtype=torch.int8), 16, True, 1,
                     False)


CUDA = torch.device("cuda")
BF16, I8, F32 = torch.bfloat16, torch.int8, torch.float32


@pytest.mark.parametrize("args,want", [
    # the flagship decoder (E 1024, 16 heads, F 4096): bf16 / int8 caches,
    # beams over a memory of 1,024, max_len 1,536; tp = 2 shards
    ((1024, 16, 4096, BF16, BF16, 1536, 1024, CUDA), True),
    ((1024, 16, 4096, I8, BF16, 1536, 1024, CUDA, 4), True),
    ((1024, 16, 4096, BF16, BF16, 1536, 1024, CUDA, 8, 2), True),
    ((1024, 16, 4096, I8, BF16, 1536, 1024, CUDA, 1, 4), True),
    # head dim 48: K2's kernels are compiled for 32 / 64 / 128, the int8
    # step needs a power of two
    ((768, 16, 3072, BF16, BF16, 512, 1024, CUDA), False),
    ((768, 16, 3072, I8, BF16, 512, 1024, CUDA), False),
    ((768, 16, 3072, I8, F32, 512, 24, "cpu"), False),
    ((768, 16, 3072, F32, F32, 512, 24, "cpu"), True),
    # E 1280: K4 takes E <= 1024, on either device
    ((1280, 20, 5120, BF16, BF16, 512, 1024, CUDA), False),
    ((1280, 20, 2560, F32, F32, 16, 24, "cpu"), False),
    # the CPU tests' tiny decoders (head dim 8, 16) keep the monolith twins
    ((32, 4, 64, F32, F32, 264, 24, "cpu"), True),
    ((64, 4, 128, I8, F32, 264, 24, "cpu", 4), True),
    ((64, 4, 128, F32, F32, 264, 24, CUDA), False),  # fp32, head dim 16
    # int8 caches past MAX_INT8_KEYS on either device
    ((1024, 16, 4096, I8, BF16, 8224, 1024, CUDA), False),
    ((64, 4, 128, I8, F32, 8224, 24, "cpu"), False),
    # bf16 keys past what eight blocks of K2 hold at groups of 8
    ((1024, 16, 4096, BF16, BF16, 1536, 30000, CUDA, 8), False),
])
def test_monolith_takes(args, want):
    assert dk.monolith_takes(*args) is want


def test_the_gate_reads_the_weight_mode():
    """K5 and K14 take K, N multiples of 128: a decoder of E = 512, 8 heads
    and F = 1088 runs K1's products but not the quantized ones."""
    prev = (dk._W8A8, dk._W4A8)
    try:
        shape = (512, 8, 1088, I8, BF16, 512, 1024, CUDA)
        dk.set_w8a8(False)
        dk.set_w4a8(False)
        assert dk.monolith_takes(*shape)
        dk.set_w8a8(True)
        assert not dk.monolith_takes(*shape)
        dk.set_w4a8(True)
        assert not dk.monolith_takes(*shape)
        assert dk.monolith_takes(512, 8, 1024, I8, BF16, 512, 1024, CUDA)
    finally:
        dk.set_w8a8(prev[0])
        dk.set_w4a8(prev[1])


def test_monolith_for_asks_the_gate_from_max_len(monkeypatch):
    """``_monolith_for`` reads the longest cache the decode can reach:
    ``max_len`` rounded up to the time tile."""
    cfg = DecoderConfig(max_lmx_seq_len=9000, vocab_size=33, num_layers=1,
                        hidden_dim=64, num_heads=4, mlp_dim=128)
    seen = []
    monkeypatch.setattr(decode, "monolith_takes",
                        lambda *a: seen.append(a) or True)
    assert decode._monolith_for(cfg, F32, I8, 8190, 24, "cpu", 4)
    assert seen[-1] == (64, 4, 128, I8, F32, 8192, 24, "cpu", 4, 1)
    assert not decode._monolith_for(cfg, F32, BF16, 100, 24, "cpu")
    assert len(seen) == 1  # a float cache dtype other than the compute's
    dk.set_enabled(False)
    assert not decode._monolith_for(cfg, F32, F32, 100, 24, "cpu")


def test_per_op_attention_takes_k11_only_for_its_head_dims():
    """K11's cluster kernel is compiled for head dims 16-128 (powers of
    two): on the card a head dim of 48 takes the plain path; on the CPU its
    twin takes any head dim."""
    assert hd.hd_takes(64, CUDA) and hd.hd_takes(16, "cuda:0")
    assert not hd.hd_takes(48, CUDA)
    assert hd.hd_takes(48, "cpu")
    hd.set_enabled(True)
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 3, 48, generator=g)
    kT, vT = torch.randn(2, 3, 48, 20, generator=g), \
        torch.randn(2, 3, 48, 20, generator=g)
    got = decode.decode_attention(q, kT, vT, None, torch.float32)
    assert torch.equal(got, hd.decode_attention_hd.plain(q, kT, vT, None))
