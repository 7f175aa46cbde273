"""The port's beam search, streamed decode, progress hook and the serving
entry points around them against the JAX package at fp32 compute.

The JAX side runs its monolith decode-step kernel forced, in the Pallas
interpreter (as tests/test_monolith.py runs it); the port runs the plain
twins of its kernels (what its wrappers do for CPU tensors). Same weights,
same inputs from ``np.random.default_rng``. Tolerances are stated where they
are used: fp32 caches 2e-4 on log-probs (as tests/test_monolith.py), int8
caches 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from acai_omr_tpu.data.tokenizer import LmxTokenizer as JaxTokenizer
from acai_omr_tpu.inference import batch_inference as jax_bi
from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.omr_decoder import init_decoder_params
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.ops import pallas_train_layer as ptl

from acai_omr_tpu_torch import InferenceEvent
from acai_omr_tpu_torch.api import OmrModel, Transcription
from acai_omr_tpu_torch.data import transforms as tf
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.inference import vitomr_inference as vi
from acai_omr_tpu_torch.inference.batch_inference import batch_inference
from acai_omr_tpu_torch.models import decode, vit_encoder, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import (_flatten, _unflatten,
                                               params_from_jax)

from _torch_port_threads import torch_one_thread  # noqa: F401

DEC = dict(max_lmx_seq_len=64, vocab_size=33, num_layers=2, hidden_dim=256,
           num_heads=4, mlp_dim=1024, eos_idx=2)
JCFG = JaxDecoderConfig(**DEC)
PCFG = DecoderConfig(**DEC)
B, M = 4, 32
# raises <eos>'s logit so rows and beams finish at different steps
EOS_BIAS = 0.3

# the whole slice: a configuration that passes both JAX kernel gates
ENC = dict(num_layers=2, hidden_dim=256, num_heads=4, mlp_dim=512)
SDEC = dict(num_layers=2, hidden_dim=256, num_heads=4, mlp_dim=1024,
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
    valid = np.arange(M)[None, :] < np.array([M, M - 5, 17, 9])[:, None]
    return params, to_port(params), latent, valid


def _both(setup, fn, rows=slice(None), **kw):
    jparams, pparams, latent, valid = setup
    cache = kw.pop("cache", "float32")
    j = getattr(jax_decode, fn)(
        jparams, JCFG, jnp.asarray(latent[rows]), jnp.asarray(valid[rows]),
        compute_dtype=jnp.float32, cache_dtype=getattr(jnp, cache), **kw)
    p = getattr(decode, fn)(
        pparams, PCFG, torch.from_numpy(latent[rows]),
        torch.from_numpy(valid[rows]), compute_dtype=torch.float32,
        cache_dtype=getattr(torch, cache), **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


@pytest.mark.parametrize("beam_size,length_penalty", [(3, 0.6), (2, 0.0)])
def test_beam_generate_matches_jax(setup, beam_size, length_penalty):
    """fp32 caches: tokens identical, log-probs atol 2e-4, through a cache
    growth (16 -> 48 slots); all beams and their final scores too."""
    j, p = _both(setup, "beam_generate", beam_size=beam_size, max_len=40,
                 length_penalty=length_penalty, initial_segment=16,
                 return_all_beams=True)
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_array_equal(p[2], j[2])
    np.testing.assert_allclose(p[1], j[1], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(p[3], j[3])
    np.testing.assert_allclose(p[4], j[4], atol=2e-4, rtol=0)
    assert p[2].sum(axis=1).max() > 17  # some best beam outlived segment one


def test_int8_beam_generate_matches_jax(setup):
    """int8 caches and W8A8 weights under beams (grouped int8 memory): the
    same tokens as the JAX package on the seeded case, log-probs atol 5e-3."""
    j, p = _both(setup, "beam_generate", rows=slice(0, 2), cache="int8",
                 beam_size=4, max_len=40, initial_segment=16)
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_allclose(p[1], j[1], atol=5e-3, rtol=0)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_beam_size_one_equals_greedy(setup, cache):
    _, pparams, latent, valid = setup
    kw = dict(max_len=48, initial_segment=16, compute_dtype=torch.float32,
              cache_dtype=getattr(torch, cache))
    lat, val = torch.from_numpy(latent), torch.from_numpy(valid)
    g = decode.generate(pparams, PCFG, lat, val, compact=False, **kw)
    b = decode.beam_generate(pparams, PCFG, lat, val, beam_size=1,
                             length_penalty=0.0, **kw)
    assert torch.equal(b[0], g[0]) and torch.equal(b[2], g[2])
    # a beam's token log-prob is a difference of cumulative scores
    np.testing.assert_allclose(b[1].numpy(), g[1].numpy(), atol=2e-4, rtol=0)


def test_int8_beams_do_not_depend_on_cache_growth(setup):
    """int8 beams through two cache growths and 8-step segments == the same
    run in a cache that never grows: the parent reorder and the growth move
    the scales with their rows."""
    _, pparams, latent, valid = setup
    lat, val = torch.from_numpy(latent[:2]), torch.from_numpy(valid[:2])
    kw = dict(beam_size=4, compute_dtype=torch.float32,
              cache_dtype=torch.int8, max_len=48)
    one = decode.beam_generate(pparams, PCFG, lat, val, initial_segment=64,
                               **kw)
    seg = decode.beam_generate(pparams, PCFG, lat, val, initial_segment=16,
                               segment_steps=8, **kw)
    assert torch.equal(seg[0], one[0])
    assert torch.equal(seg[1], one[1])
    assert bool(seg[2][:, 0].all())
    assert float(torch.where(seg[2], seg[1], -1.0).max()) <= 1e-6


def test_beam_segment_ends_once_every_beam_has_finished(setup, monkeypatch):
    """A strong <eos> finishes every beam within a few tokens: the segment
    then ends at its next look for the all-finished exit (every
    FINISH_CHECK_STEPS steps), not at the end of the cache."""
    _, pparams, latent, valid = setup
    eager = dict(pparams, unembed=dict(pparams["unembed"]))
    eager["unembed"]["bias"] = pparams["unembed"]["bias"].clone()
    eager["unembed"]["bias"][PCFG.eos_idx] += 3.0
    calls = []
    real = decode.step_logits
    monkeypatch.setattr(decode, "step_logits",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = decode.beam_generate(
        eager, PCFG, torch.from_numpy(latent), torch.from_numpy(valid),
        beam_size=3, max_len=48, initial_segment=64,
        compute_dtype=torch.float32, cache_dtype=torch.float32)
    longest = int(out[2].sum(dim=1).max())
    assert longest < decode.FINISH_CHECK_STEPS
    assert len(calls) == decode.FINISH_CHECK_STEPS


def test_top_k_ties_take_the_lower_index():
    """The beam step's candidate order on ties is ``jax.lax.top_k``'s."""
    cand = np.array([[1.0, 3.0, 3.0, -1e9, 3.0, 2.0, -1e9, 1.0]], np.float32)
    ref = np.asarray(jax.lax.top_k(jnp.asarray(cand), 4)[1])
    got = torch.sort(torch.from_numpy(cand), dim=-1, descending=True,
                     stable=True).indices[:, :4].numpy()
    np.testing.assert_array_equal(got, ref)


def test_select_best_beam_matches_jax():
    rng = np.random.default_rng(2)
    seqs = rng.integers(3, 30, (3, 4, 12))
    seqs[:, :, 0] = 1
    for (i, k), at in {(0, 0): 5, (0, 2): 9, (1, 1): 3, (2, 3): 11}.items():
        seqs[i, k, at] = 2
    lps = -rng.random((3, 4, 12)).astype(np.float32)
    scores = -rng.random((3, 4)).astype(np.float32) * 8
    (js, jl, jm), jf = jax_decode._select_best_beam(
        jnp.asarray(seqs, jnp.int32), jnp.asarray(lps), jnp.asarray(scores),
        JCFG, 0.6)
    (ps, pl, pm), pf = decode._select_best_beam(
        torch.from_numpy(seqs), torch.from_numpy(lps),
        torch.from_numpy(scores), PCFG, 0.6)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-7)
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=1e-6)


def test_streamed_generate_chunks_are_generates_tokens(setup):
    """Chunks arrive every ``flush_interval`` steps, as from the JAX
    generator, and concatenate to a prefix of ``generate``'s tokens; the
    finish event carries the same sequence as ``generate``."""
    jparams, pparams, latent, valid = setup
    row = slice(1, 2)  # a row that decodes 40 tokens without an <eos>
    kw = dict(max_len=40, flush_interval=7)
    jev = list(jax_decode.streamed_generate(
        jparams, JCFG, jnp.asarray(latent[row]), jnp.asarray(valid[row]),
        compute_dtype=jnp.float32, **kw))
    pev = list(decode.streamed_generate(
        pparams, PCFG, torch.from_numpy(latent[row]),
        torch.from_numpy(valid[row]), compute_dtype=torch.float32, **kw))
    assert [k for k, _ in pev] == [k for k, _ in jev]
    assert pev[-1][0] == "finish" and len(pev) > 3
    for (_, a), (_, b) in zip(pev[:-1], jev[:-1]):
        np.testing.assert_array_equal(a, np.asarray(b))
    ref = decode.generate(pparams, PCFG, torch.from_numpy(latent[row]),
                          torch.from_numpy(valid[row]), max_len=40,
                          compute_dtype=torch.float32,
                          cache_dtype=torch.float32)
    fin = pev[-1][1]
    assert torch.equal(fin[0], ref[0]) and torch.equal(fin[2], ref[2])
    chunks = np.concatenate([c for _, c in pev[:-1]], axis=1)
    assert chunks.shape[0] == 1 and chunks.shape[1] >= 28
    np.testing.assert_array_equal(chunks[0],
                                  ref[0][0, 1:1 + chunks.shape[1]].numpy())
    with pytest.raises(ValueError, match="single image"):
        next(decode.streamed_generate(pparams, PCFG, torch.from_numpy(latent),
                                      None))


def test_progress_cb_follows_the_jax_hook(setup):
    """``progress_cb(seqs, t, finished)`` at every ``segment_steps`` boundary:
    the master buffer in input order, ``t`` rising, finished rows staying
    finished (compacted-away rows count as finished). Calls, masks and
    buffers equal the JAX package's, except that the port looks for the
    all-finished exit every FINISH_CHECK_STEPS steps, so its last ``t`` may
    be later."""
    calls = {"jax": [], "port": []}

    def hook(key):
        return lambda seqs, t, fin: calls[key].append(
            (np.array(seqs), int(t), np.array(fin)))

    jparams, pparams, latent, valid = setup
    kw = dict(max_len=48, initial_segment=16, segment_steps=5)
    j = jax_decode.generate(jparams, JCFG, jnp.asarray(latent),
                            jnp.asarray(valid), compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32,
                            progress_cb=hook("jax"), **kw)
    p = decode.generate(pparams, PCFG, torch.from_numpy(latent),
                        torch.from_numpy(valid), compute_dtype=torch.float32,
                        cache_dtype=torch.float32, progress_cb=hook("port"),
                        **kw)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    assert len(calls["port"]) == len(calls["jax"]) >= 4
    ts = [t for _, t, _ in calls["port"]]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    assert ts[:-1] == [t for _, t, _ in calls["jax"]][:-1]
    for i, ((ps, pt, pf), (js, _, jf)) in enumerate(
            zip(calls["port"], calls["jax"])):
        assert ps.shape == (B, 48) and pf.shape == (B,) and pf.dtype == bool
        np.testing.assert_array_equal(pf, jf)
        if i < len(ts) - 1:
            np.testing.assert_array_equal(ps, js)
        if i:
            assert not (calls["port"][i - 1][2] & ~pf).any()
        np.testing.assert_array_equal(ps[:, 0], PCFG.bos_idx)
        np.testing.assert_array_equal(ps[:, pt:], PCFG.pad_idx)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _transform():
    return tf.Compose([tf.to_float_chw, tf.DynamicResize(16, 200, 60, 200,
                                                         False)])


@pytest.fixture(scope="module")
def slice_setup():
    jtok, ptok = JaxTokenizer(), LmxTokenizer()
    jcfg = jax_vitomr.ViTOMRConfig(
        jax_enc.EncoderConfig(**ENC),
        JaxDecoderConfig.from_tokenizer(jtok, **SDEC), transition_head_dim=512)
    pcfg = vitomr.ViTOMRConfig(
        vit_encoder.EncoderConfig(**ENC),
        DecoderConfig.from_tokenizer(ptok, **SDEC), transition_head_dim=512)
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(5), jcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    raw = [(rng.random(hw) * 255).astype(np.uint8) for hw in SIZES]
    imgs = [_transform()(img) for img in raw]
    return jtok, ptok, jcfg, pcfg, jparams, pparams, raw, imgs


@pytest.mark.parametrize("mode", [
    dict(cache="int8"), dict(beam_size=2), dict(beam_size=2, cache="int8")],
    ids=["int8", "beam2", "beam2-int8"])
def test_batch_inference_same_lmx(slice_setup, mode):
    """``batch_inference`` of both packages on five ragged images: the same
    LMX strings; mean log-probs atol 2e-4 at fp32 caches, 5e-3 at int8."""
    jtok, ptok, jcfg, pcfg, jparams, pparams, _, imgs = slice_setup
    mode = dict(mode)
    cache = mode.pop("cache", "float32")
    ref = jax_bi.batch_inference(jparams, jcfg, imgs, jtok,
                                 compute_dtype=jnp.float32,
                                 cache_dtype=getattr(jnp, cache), **mode, **KW)
    out = batch_inference(pparams, pcfg, imgs, ptok,
                          compute_dtype=torch.float32,
                          cache_dtype=getattr(torch, cache), device="cpu",
                          **mode, **KW)
    assert out.lmx == ref.lmx
    np.testing.assert_allclose(out.avg_log_probs, ref.avg_log_probs,
                               atol=5e-3 if cache == "int8" else 2e-4)
    for a, b in zip(out.seqs, ref.seqs):
        np.testing.assert_array_equal(a, b)
    assert out.n_tokens == sum(len(s) - 1 for s in out.seqs)


def test_batch_inference_progress_never_shows_pad_rows(slice_setup):
    _, ptok, _, pcfg, _, pparams, _, imgs = slice_setup
    calls = []
    out = batch_inference(
        pparams, pcfg, imgs, ptok, compute_dtype=torch.float32,
        cache_dtype=torch.int8, device="cpu", progress_interval=8,
        progress_cb=lambda idx, seqs, t, fin: calls.append(
            (list(idx), seqs.copy(), t, fin.copy())), **KW)
    assert calls
    seen = set()
    last_t = {}
    for idx, seqs, t, fin in calls:
        # a 3-image bucket pads to 4 rows: the hook sees 3
        assert seqs.shape == (len(idx), 32) and fin.shape == (len(idx),)
        assert len(set(idx)) == len(idx) and set(idx) <= set(range(len(imgs)))
        key = tuple(idx)
        assert t > last_t.get(key, 0)
        last_t[key] = t
        seen |= set(idx)
        for row, g in enumerate(idx):  # what was streamed is what came out
            n = min(t, len(out.seqs[g]))
            np.testing.assert_array_equal(seqs[row, :n], out.seqs[g][:n])
    assert seen == set(range(len(imgs)))
    # beams do not surface mid-decode state
    batch_inference(pparams, pcfg, imgs[:2], ptok, beam_size=2,
                    compute_dtype=torch.float32, cache_dtype=torch.float32,
                    device="cpu", progress_cb=lambda *a: 1 / 0, **KW)


def test_transcribe_batch_beam_int8_on_cpu_and_raises_without_gpu(slice_setup):
    _, ptok, _, pcfg, _, pparams, raw, imgs = slice_setup
    model = OmrModel(pcfg, pparams, ptok, _transform(), torch.device("cpu"),
                     torch.float32)
    got = model.transcribe_batch(raw, max_len=32, beam_size=2,
                                 quantized_kv=True)
    res = batch_inference(pparams, pcfg, imgs, ptok, beam_size=2,
                          compute_dtype=torch.float32, cache_dtype=torch.int8,
                          device="cpu", max_inference_len=32)
    assert all(isinstance(t, Transcription) for t in got)
    assert [t.lmx for t in got] == res.lmx
    assert all(0.0 < t.confidence <= 1.0 for t in got)
    one = model.transcribe(raw[1], max_len=32, beam_size=2, quantized_kv=True)
    assert one.lmx == got[1].lmx
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            batch_inference(pparams, pcfg, imgs, ptok, beam_size=2,
                            cache_dtype=torch.int8, max_inference_len=32)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            OmrModel.load()


def test_inference_entry_points(slice_setup):
    """``inference`` (greedy, beams, int8) agrees with ``batch_inference`` on
    one bucket; ``streamed_inference`` yields the events in order and its
    finish payload is the greedy sequence."""
    _, ptok, _, pcfg, _, pparams, _, imgs = slice_setup
    pair = [imgs[1], imgs[4]]
    kw = dict(max_inference_len=32, compute_dtype=torch.float32, device="cpu")
    for mode in (dict(cache_dtype=torch.float32),
                 dict(cache_dtype=torch.int8, beam_size=2)):
        seqs, lps, mask = vi.inference(pparams, pcfg, pair, **kw, **mode)
        ref = batch_inference(pparams, pcfg, pair, ptok, bucket_multiple=64,
                              **kw, **mode)
        assert seqs.dtype == np.int64 and mask.dtype == bool
        assert [ptok.decode(s[m]) for s, m in zip(seqs, mask)] == ref.lmx
    events = list(vi.streamed_inference(pparams, pcfg, imgs[1],
                                        flush_interval=6, **kw))
    kinds = [e["type"] for e in events]
    n_steps = kinds.count(InferenceEvent.STEP.value)
    assert kinds == ([InferenceEvent.ENCODING_START.value,
                      InferenceEvent.ENCODING_FINISH.value]
                     + [InferenceEvent.STEP.value] * n_steps
                     + [InferenceEvent.INFERENCE_FINISH.value])
    fin = events[-1]["payload"]
    seqs, _, mask = vi.inference(pparams, pcfg, imgs[1],
                                 cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(fin["sequence"], seqs)
    np.testing.assert_array_equal(fin["mask"], mask)
    if n_steps:
        toks = np.concatenate([e["payload"]["tokens"]
                               for e in events[2:2 + n_steps]], axis=1)
        np.testing.assert_array_equal(toks[0], seqs[0, 1:1 + toks.shape[1]])


def test_delinearize_writes_files_and_cli_runs(slice_setup, tmp_path,
                                               monkeypatch):
    _, ptok, _, pcfg, _, pparams, raw, _ = slice_setup
    lmx = "measure key:fifths:0 time beats:4 beat-type:4 clef:G2 C4 quarter"
    resp = vi.delinearize(lmx, str(tmp_path / "a.lmx"),
                          str(tmp_path / "a.musicxml"))
    assert (tmp_path / "a.lmx").read_text() == lmx
    if resp["ok"]:
        assert (tmp_path / "a.musicxml").read_text().lstrip().startswith("<")
        assert resp["xml_file_path"] == str(tmp_path / "a.musicxml")
    else:
        assert resp["error"]
    assert vi.convert_back_to_img(str(tmp_path / "none.musicxml"),
                                  str(tmp_path / "none.png")) is None

    # the command line, on the small model instead of the flagship
    monkeypatch.setattr(
        vi, "set_up_omr_inference",
        lambda weights, dtype, device: (pcfg, pparams, ptok, _transform()))
    monkeypatch.setattr(decode, "generate", _capped(decode.generate))
    monkeypatch.setattr(decode, "beam_generate", _capped(decode.beam_generate))
    Image.fromarray(raw[1]).save(tmp_path / "score.png")
    prefix = str(tmp_path / "out")
    vi.main([str(tmp_path / "score.png"), "-o", prefix, "--beam-size", "2",
             "--int8-kv", "--device", "cpu"])
    assert (tmp_path / "out.lmx").read_text().split()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            vi.main([str(tmp_path / "score.png"), "-o", prefix])


def _capped(fn):
    """``fn`` with max_len cut to 32: the small model has 64 positions."""
    def wrapped(*a, **k):
        k["max_len"] = min(k.get("max_len", 32), 32)
        return fn(*a, **k)
    return wrapped
