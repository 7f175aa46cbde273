"""The port's greedy inference slice end to end against the JAX package.

``batch_inference`` of both packages at fp32 on the CPU, on five ragged
synthetic images passed through the same transform, with a configuration
that passes both JAX kernel gates, so the JAX reference runs its fused Pallas
encoder stack and its monolith decode step (forced, in the Pallas
interpreter). ``decode_batch=4`` makes the 3-image bucket pad to 4 rows.
The port must give the same LMX strings; its ``OmrModel.transcribe_batch``
must end in the delinearizer's output for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.data import transforms as jax_tf
from acai_omr_tpu.data.tokenizer import LmxTokenizer as JaxTokenizer
from acai_omr_tpu.inference import batch_inference as jax_bi
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.ops import pallas_train_layer as ptl

from acai_omr_tpu_torch.api import OmrModel
from acai_omr_tpu_torch.data import transforms as tf
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.inference.batch_inference import batch_inference
from acai_omr_tpu_torch.lmx.delinearizer import (DelinearizationError,
                                                 delinearize)
from acai_omr_tpu_torch.models import vit_encoder, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import params_from_jax

from _torch_port_threads import torch_one_thread  # noqa: F401

ENC = dict(num_layers=2, hidden_dim=256, num_heads=4, mlp_dim=512)
DEC = dict(num_layers=2, hidden_dim=256, num_heads=4, mlp_dim=1024,
           max_lmx_seq_len=64)
SIZES = [(120, 700), (300, 300), (100, 1300), (500, 240), (160, 390)]
KW = dict(max_inference_len=32, decode_batch=4, bucket_multiple=64)


@pytest.fixture(autouse=True)
def _jax_kernels():
    prev = ((ptl._FORCE, ptl._INTERPRET),
            (pallas_monolith._FORCE, pallas_monolith._INTERPRET))
    ptl.set_test_mode(force=True, interpret=True)
    pallas_monolith.set_test_mode(force=True, interpret=True)
    yield
    ptl.set_test_mode(*prev[0])
    pallas_monolith.set_test_mode(*prev[1])


def _transform(module):
    return module.Compose([module.to_float_chw,
                           module.DynamicResize(16, 200, 60, 200, False)])


@pytest.fixture(scope="module")
def setup():
    jtok, ptok = JaxTokenizer(), LmxTokenizer()
    jcfg = jax_vitomr.ViTOMRConfig(
        jax_enc.EncoderConfig(**ENC),
        JaxDecoderConfig.from_tokenizer(jtok, **DEC), transition_head_dim=512)
    pcfg = vitomr.ViTOMRConfig(
        vit_encoder.EncoderConfig(**ENC),
        DecoderConfig.from_tokenizer(ptok, **DEC), transition_head_dim=512)
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(5), jcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    raw = [(rng.random(hw) * 255).astype(np.uint8) for hw in SIZES]
    return jtok, ptok, jcfg, pcfg, jparams, pparams, raw


def test_transform_matches_jax(setup):
    *_, raw = setup
    for img in raw:
        np.testing.assert_array_equal(_transform(tf)(img),
                                      _transform(jax_tf)(img))


def test_batch_inference_same_lmx(setup, monkeypatch):
    jtok, ptok, jcfg, pcfg, jparams, pparams, raw = setup
    calls = {"enc": 0, "dec": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    # JAX calls the spied names only while it traces: drop what an earlier
    # module in this process compiled at these shapes, so this call traces
    jax.clear_caches()
    spy(ptl, "encoder_stack_fused", "enc")
    spy(pallas_monolith, "decode_layers", "dec")
    imgs = [_transform(tf)(img) for img in raw]
    ref = jax_bi.batch_inference(jparams, jcfg, imgs, jtok,
                                 compute_dtype=jnp.float32,
                                 cache_dtype=jnp.float32, **KW)
    assert calls["enc"] and calls["dec"], calls
    out = batch_inference(pparams, pcfg, imgs, ptok,
                          compute_dtype=torch.float32,
                          cache_dtype=torch.float32, device="cpu", **KW)
    assert out.lmx == ref.lmx
    np.testing.assert_allclose(out.avg_log_probs, ref.avg_log_probs,
                               atol=2e-4)
    for a, b in zip(out.seqs, ref.seqs):
        np.testing.assert_array_equal(a, b)


def test_transcribe_batch_ends_in_delinearizer(setup):
    _, ptok, _, pcfg, _, pparams, raw = setup
    model = OmrModel(pcfg, pparams, ptok, _transform(tf), torch.device("cpu"),
                     torch.float32)
    got = model.transcribe_batch(raw, max_len=32)
    imgs = [_transform(tf)(img) for img in raw]
    res = batch_inference(pparams, pcfg, imgs, ptok,
                          compute_dtype=torch.float32,
                          cache_dtype=torch.float32, device="cpu", **KW)
    assert [t.lmx for t in got] == res.lmx
    for t in got:
        try:
            xml, problems = delinearize(t.lmx)
        except DelinearizationError as e:
            xml, problems = None, [str(e)]
        assert (t.musicxml, t.problems) == (xml, problems)
        assert 0.0 < t.confidence <= 1.0
