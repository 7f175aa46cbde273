"""The port's data helpers and utilities of the JAX package's public names,
against the JAX package on the CPU: ``unpatchify`` / ``batched_patchify``
on numpy arrays and on tensors (exact), ``resize_patchify`` and
``PatchDivisibleResize`` (within 1e-6: the same native or PIL resize),
``pack_mae_batch``'s ``MaePackedBatch`` and ``pack_omr_batch``'s
``include_musicxml`` pad rows (exact), ``StepTimer``, ``profile_trace``
(off for None, a ``torch.profiler`` trace under a directory), and
``load_pytree(like=)`` on the port's ``.npz`` and on an orbax directory the
JAX package wrote (a match is read, a mismatch names its leaf).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from acai_omr_tpu.data import loader as jax_loader
from acai_omr_tpu.data import native_imgproc as jax_native
from acai_omr_tpu.data import transforms as jax_tf
from acai_omr_tpu.data.tokenizer import LmxTokenizer as JaxTokenizer
from acai_omr_tpu.models.vit_encoder import EncoderConfig as JaxEncoderConfig
from acai_omr_tpu.ops import patchify as jax_patchify
from acai_omr_tpu.utils import checkpoint as jax_ckpt

from acai_omr_tpu_torch.data import loader, native_imgproc, transforms
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.ops import patchify
from acai_omr_tpu_torch.utils import checkpoint, metrics

ENC = dict(patch_size=16, pe_max_height=12, pe_max_width=24, num_layers=1,
           hidden_dim=32, num_heads=4, mlp_dim=64)
LMX = "measure key:fifths:0 time beats:4 beat-type:4 G4 quarter"


def test_unpatchify_and_batched_patchify_match_jax():
    rng = np.random.default_rng(0)
    patches = rng.random((3 * 5, 2 * 16 * 16), dtype=np.float32)
    want = np.asarray(jax_patchify.unpatchify(jnp.asarray(patches), 3, 5, 16,
                                              2))
    np.testing.assert_array_equal(
        patchify.unpatchify(patches, 3, 5, 16, 2), want)
    got = patchify.unpatchify(torch.from_numpy(patches), 3, 5, 16, 2)
    assert torch.is_tensor(got)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(patchify.patchify(want, 16), patches)

    imgs = rng.random((2, 1, 48, 80), dtype=np.float32)
    want = np.asarray(jax_patchify.batched_patchify(jnp.asarray(imgs), 16))
    np.testing.assert_array_equal(patchify.batched_patchify(imgs, 16), want)
    np.testing.assert_array_equal(
        patchify.batched_patchify(torch.from_numpy(imgs), 16).numpy(), want)
    np.testing.assert_array_equal(want[1], patchify.patchify(imgs[1], 16))


def test_resize_patchify_matches_jax():
    if not (native_imgproc.available() and jax_native.available()):
        pytest.skip("native/libimgproc.so did not build here")
    img = np.random.default_rng(1).random((70, 133), dtype=np.float32)
    want = jax_native.resize_patchify(img, 48, 96, 16)
    got = native_imgproc.resize_patchify(img, 48, 96, 16)
    assert got.shape == (3 * 6, 256)
    np.testing.assert_array_equal(got, want)
    # the fused call is the resize, clamped, then patchified
    ref = patchify.patchify(
        np.clip(native_imgproc.resize_bicubic(img, 48, 96), 0, 1), 16)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(70, 133), (64, 96), (10, 40)])
def test_patch_divisible_resize_matches_jax(hw):
    arr = (np.random.default_rng(2).random(hw) * 255).astype(np.uint8)
    img = Image.fromarray(arr, mode="L")
    want = jax_tf.PatchDivisibleResize(16)(img)
    got = transforms.PatchDivisibleResize(16)(img)
    assert got.shape == want.shape
    assert got.shape[1] % 16 == 0 and got.shape[2] % 16 == 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _examples(n, musicxml=False):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        img = rng.random((1, 32 + 16 * i, 64), dtype=np.float32)
        ex = (img, LMX)
        out.append(ex + (f"<score-partwise id='{i}'/>",) if musicxml else ex)
    return out


def test_pack_mae_batch_is_a_mae_packed_batch():
    ex = [(img, img) for img, _ in _examples(3)]
    got = loader.pack_mae_batch(ex, EncoderConfig(**ENC), pad_to_batch=4)
    want = jax_loader.pack_mae_batch(ex, JaxEncoderConfig(**ENC),
                                     pad_to_batch=4)
    assert isinstance(got, loader.MaePackedBatch) and isinstance(got, dict)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_omr_batch_include_musicxml_pads_with_none():
    ex = _examples(3, musicxml=True)
    kw = dict(max_lmx_seq_len=64, include_musicxml=True, pad_to_batch=5)
    got = loader.pack_omr_batch(ex, EncoderConfig(**ENC), LmxTokenizer(), **kw)
    want = jax_loader.pack_omr_batch(ex, JaxEncoderConfig(**ENC),
                                     JaxTokenizer(), **kw)
    assert got.keys() == want.keys()
    assert got["musicxml"] == want["musicxml"]
    assert got["musicxml"][3:] == [None, None]
    assert len(got["lmx_seqs"]) == got["patches"].shape[0] == 5
    for g, w in zip(got["lmx_seqs"], want["lmx_seqs"]):
        assert (g is None and w is None) or np.array_equal(g, w)
    for k in ("patches", "valid", "inputs", "targets", "lmx_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the host lists stay on the host
    assert set(loader.to_device(got, "cpu")) == {
        k for k, v in got.items() if isinstance(v, np.ndarray)}
    plain = loader.pack_omr_batch(ex, EncoderConfig(**ENC), LmxTokenizer(),
                                  max_lmx_seq_len=64)
    assert "musicxml" not in plain and "lmx_seqs" not in plain


def test_step_timer():
    timer = metrics.StepTimer()
    a, b = timer.tick(), timer.tick()
    assert a >= 0 and b >= 0 and timer.count == 2


def test_profile_trace(tmp_path):
    with metrics.profile_trace(None) as prof:
        assert prof is None
    out = tmp_path / "trace"
    with metrics.profile_trace(str(out)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = out.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert not list(tmp_path.glob("trace_*.json"))


def _tree():
    return {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": np.ones(3, np.float32)},
            "step": np.asarray(7, np.int32)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_pytree_like(tmp_path, writer):
    tree = _tree()
    if writer == "port":
        path = checkpoint.save_pytree(tmp_path / "ck", tree)
    else:
        path = tmp_path / "ck"
        jax_ckpt.save_pytree(path, tree)
    like = {"params": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
            "step": np.asarray(0, np.int32)}
    got = checkpoint.load_pytree(path, like=like)
    np.testing.assert_array_equal(got["params"]["w"], tree["params"]["w"])
    for bad, leaf in [
            ({"w": torch.zeros(3, 2), "b": torch.zeros(3)}, "params/w"),
            ({"w": torch.zeros(2, 3),
              "b": torch.zeros(3, dtype=torch.float64)}, "params/b"),
            ({"w": torch.zeros(2, 3)}, "params/b"),
            ({"w": torch.zeros(2, 3), "b": torch.zeros(3),
              "c": torch.zeros(1)}, "params/c")]:
        with pytest.raises(ValueError, match=leaf):
            checkpoint.load_pytree(path, like={"params": bad,
                                               "step": like["step"]})
    with pytest.raises(ValueError, match="step"):
        checkpoint.load_pytree(path, like={"params": like["params"],
                                           "step": np.asarray(0, np.int64)})
