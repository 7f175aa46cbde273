"""The port's ViTOMR generation entry points against the JAX package's, at
fp32 on the CPU: ``generate_next_token_distr`` on one image of a padded
batchify latent, with and without its ``latent_valid`` (within 1e-5: fp32
sums in another order), ``cached_greedy_generate`` / ``cached_beam_generate``
(tokens identical, log-probs within 2e-4 as tests/test_monolith.py) and
``expand_img_latent_for_rollout`` (exact).

Tiny configuration of ``tools/reference_identity.make_cfg(tiny=True)``, JAX's
seeded weights carried over by ``params_from_jax``, images from
``np.random.default_rng``. Both packages decode on their per-op steps (the
JAX package's unforced CPU decode; the port with ``ACAI_MONOLITH_DECODE``
off), as tests/test_torch_port_decode_hd.py holds them; every switch is
restored after.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.ops import pallas_monolith
from tools.reference_identity import make_cfg

from acai_omr_tpu_torch.models import vitomr, weights
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.ops import decode_kernel

JCFG = make_cfg(tiny=True)
PCFG = vitomr.ViTOMRConfig(
    EncoderConfig(**dataclasses.asdict(JCFG.encoder)),
    DecoderConfig(**dataclasses.asdict(JCFG.decoder)),
    transition_head_dim=JCFG.transition_head_dim)
MAX_LEN = 24


@pytest.fixture(autouse=True)
def _per_op_steps():
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET,
            decode_kernel._ENABLED)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    decode_kernel.set_enabled(False)
    yield
    pallas_monolith.set_test_mode(*prev[:2])
    decode_kernel.set_enabled(prev[2])


@pytest.fixture(scope="module")
def setup():
    """JAX's seeded weights on both sides and the latent of two images of
    different sizes, batchified (image 1's rows past its length are the
    bucket's padding), encoded by JAX at fp32."""
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(0), JCFG)
    pparams = weights.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    rng = np.random.default_rng(0)
    imgs = [rng.random((1, 64, 128), dtype=np.float32),
            rng.random((1, 48, 80), dtype=np.float32)]
    pb = jax_enc.batchify(imgs, JCFG.encoder, bucket_multiple=16)
    latent, valid = jax_vitomr.encode_image(
        jparams, JCFG, *(jnp.asarray(a) for a in
                         (pb.patches, pb.pe_idx, pb.pe_w, pb.valid)),
        compute_dtype=jnp.float32)
    latent, valid = np.array(latent), np.array(valid)
    assert not valid[1].all() and valid[0].all()
    return jparams, pparams, latent, valid


@pytest.fixture(scope="module")
def prefixes():
    """Four prefixes of 6 tokens, <bos> first."""
    rng = np.random.default_rng(1)
    seqs = rng.integers(3, JCFG.decoder.vocab_size, (4, 6)).astype(np.int32)
    seqs[:, 0] = JCFG.decoder.bos_idx
    return seqs


@pytest.mark.parametrize("masked", [True, False])
def test_next_token_distr_matches_jax(setup, prefixes, masked):
    jparams, pparams, latent, valid = setup
    lv = valid[1:2] if masked else None
    want = np.asarray(jax_vitomr.generate_next_token_distr(
        jparams, JCFG, jnp.asarray(latent[1:2]), jnp.asarray(prefixes),
        compute_dtype=jnp.float32,
        latent_valid=None if lv is None else jnp.asarray(lv)))
    got = vitomr.generate_next_token_distr(
        pparams, PCFG, torch.from_numpy(latent[1:2]),
        torch.from_numpy(prefixes), compute_dtype=torch.float32,
        latent_valid=None if lv is None else torch.from_numpy(lv))
    assert got.shape == (4, JCFG.decoder.vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_latent_valid_keeps_the_padding_out(setup, prefixes):
    """With the mask, the padded image's distribution equals the one of its
    latent cut to its valid rows; without it, the padding changes it."""
    _, pparams, latent, valid = setup
    n = int(valid[1].sum())
    dist = lambda lat, lv=None: vitomr.generate_next_token_distr(
        pparams, PCFG, torch.from_numpy(lat), torch.from_numpy(prefixes),
        latent_valid=None if lv is None else torch.from_numpy(lv))
    cut = dist(np.ascontiguousarray(latent[1:2, :n]))
    np.testing.assert_allclose(dist(latent[1:2], valid[1:2]).numpy(),
                               cut.numpy(), atol=1e-5, rtol=0)
    assert (dist(latent[1:2]) - cut).abs().max() > 1e-3


def _both_decodes(setup, jfn, pfn, **kw):
    jparams, pparams, latent, valid = setup
    j = jfn(jparams, JCFG, jnp.asarray(latent), jnp.asarray(valid),
            max_len=MAX_LEN, compute_dtype=jnp.float32,
            cache_dtype=jnp.float32, **kw)
    p = pfn(pparams, PCFG, torch.from_numpy(latent), torch.from_numpy(valid),
            max_len=MAX_LEN, compute_dtype=torch.float32,
            cache_dtype=torch.float32, **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


@pytest.mark.parametrize("which", ["greedy", "beam"])
def test_cached_generate_matches_jax(setup, which):
    if which == "greedy":
        j, p = _both_decodes(setup, jax_vitomr.cached_greedy_generate,
                             vitomr.cached_greedy_generate)
    else:
        j, p = _both_decodes(setup, jax_vitomr.cached_beam_generate,
                             vitomr.cached_beam_generate, beam_size=3)
    (js, jl, jm), (ps, pl, pm) = j, p
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_allclose(pl, jl, atol=2e-4, rtol=0)
    assert ps.shape[0] == 2 and ps.shape[1] > 2


def test_expand_img_latent_for_rollout_matches_jax(setup):
    _, _, latent, valid = setup
    jl, jv = jax_vitomr.expand_img_latent_for_rollout(
        jnp.asarray(latent), jnp.asarray(valid), 3)
    pl, pv = vitomr.expand_img_latent_for_rollout(
        torch.from_numpy(latent), torch.from_numpy(valid), 3)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pl.shape[0] == 6 and torch.equal(pl[3], pl[5])


def test_entry_points_take_their_latents_device(setup, prefixes, monkeypatch):
    """They run where the latent lies: without a GPU a CPU latent still
    decodes, and nothing falls back to another device."""
    _, pparams, latent, valid = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = vitomr.generate_next_token_distr(
        pparams, PCFG, torch.from_numpy(latent[:1]),
        torch.from_numpy(prefixes), latent_valid=torch.from_numpy(valid[:1]))
    assert out.device.type == "cpu"
