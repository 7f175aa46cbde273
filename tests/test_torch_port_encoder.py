"""The port's encoder path against the JAX package at fp32 on the CPU.

The JAX side runs its fused Pallas encoder stack (``encoder_stack_fused``,
forced, in the Pallas interpreter, as tests/test_fused_train_layer.py runs
it); the port runs the plain twins of its K1/K3/K4 kernels, which is what its
kernel wrappers do for CPU tensors. Same weights (carried over with
``params_from_jax``), same inputs from ``np.random.default_rng``.
Tolerance: 1e-4 absolute at fp32 (sums in a different order, exact vs
rational erf in the GELU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.ops import transformer as jax_tf

from acai_omr_tpu_torch.models import vit_encoder, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import params_from_jax
from acai_omr_tpu_torch.ops import encoder_stack_kernel, transformer

from _torch_port_threads import torch_one_thread  # noqa: F401

ENC = dict(pe_max_height=8, pe_max_width=8, num_layers=2, hidden_dim=256,
           num_heads=4, mlp_dim=512)
DEC = dict(vocab_size=40, num_layers=1, hidden_dim=256, num_heads=4,
           mlp_dim=1024, max_lmx_seq_len=32)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _fused_encoder():
    prev = (ptl._FORCE, ptl._INTERPRET)
    ptl.set_test_mode(force=True, interpret=True)
    yield
    ptl.set_test_mode(*prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_vitomr.ViTOMRConfig(jax_enc.EncoderConfig(**ENC),
                                   JaxDecoderConfig(**DEC),
                                   transition_head_dim=512)
    pcfg = vitomr.ViTOMRConfig(vit_encoder.EncoderConfig(**ENC),
                               DecoderConfig(**DEC), transition_head_dim=512)
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(3), jcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    # patch grids 4x6 and 6x8 slice the 8x8 PE grid; 10x5 is beyond it
    # (bilinear PE path)
    imgs = [rng.random((1, 16 * hp, 16 * wp), dtype=np.float32)
            for hp, wp in [(4, 6), (10, 5), (6, 8)]]
    return jcfg, pcfg, jparams, pparams, imgs


def test_batchify_matches_jax(setup):
    jcfg, pcfg, _, _, imgs = setup
    jb = jax_enc.batchify(imgs, jcfg.encoder, 16)
    pb = vit_encoder.batchify(imgs, pcfg.encoder, 16)
    for name in ("patches", "pe_idx", "pe_w", "valid", "lengths"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    assert pb.dims == jb.dims and (10, 5) in pb.dims


def test_encode_image_matches_fused_jax(setup, monkeypatch):
    jcfg, pcfg, jparams, pparams, imgs = setup
    calls = []
    real = ptl.encoder_stack_fused
    monkeypatch.setattr(ptl, "encoder_stack_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jb = jax_enc.batchify(imgs, jcfg.encoder, 16)
    j_lat, j_valid = jax_vitomr.encode_image(
        jparams, jcfg, jnp.asarray(jb.patches), jnp.asarray(jb.pe_idx),
        jnp.asarray(jb.pe_w), jnp.asarray(jb.valid))
    assert calls, "the JAX reference did not take its fused Pallas stack"
    p_lat, p_valid = vitomr.encode_image(
        pparams, pcfg, *vit_encoder.batchify(imgs, pcfg.encoder, 16).to("cpu"))
    np.testing.assert_array_equal(p_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(p_lat.numpy(), np.asarray(j_lat), atol=ATOL,
                               rtol=0)


def test_kernel_stack_matches_plain_layers(setup):
    """The kernel-composed stack (its plain twins on CPU) equals the loop of
    plain post-norm encoder layers, and the fused JAX stack."""
    _, pcfg, jparams, pparams, _ = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64, 256)).astype(np.float32)
    valid = np.arange(64)[None, :] < np.array([64, 17, 40])[:, None]
    blocks = pparams["encoder"]["blocks"]
    fused = encoder_stack_kernel.encoder_stack_fused(
        blocks, torch.from_numpy(x), torch.from_numpy(valid), 4)
    layers = transformer.encoder_stack_layers(
        blocks, torch.from_numpy(x), torch.from_numpy(valid), 4)
    np.testing.assert_allclose(fused.numpy(), layers.numpy(), atol=ATOL,
                               rtol=0)
    ref = ptl.encoder_stack_fused(jparams["encoder"]["blocks"],
                                  jnp.asarray(x), jnp.asarray(valid), 4)
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert jax_tf.num_stacked_layers(jparams["encoder"]["blocks"]) == 2
