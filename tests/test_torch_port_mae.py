"""Stage-1 MAE pretraining of the port against the JAX package, at fp32 on
the CPU: the mask, the gather of kept rows, a stack with 32-wide heads
forward and backward, the model, the loss and its gradients, the optimizer,
the data pipeline, the loop with resume, and the hand-off of the encoder to
stage 2.

Weights and inputs are made with numpy seeds and go into both sides; the mask
noise is one array handed to both (``mask_noise=``), since ``torch.Generator``
and ``jax.random`` draw different streams. The JAX side runs its fused Pallas
stacks forced in interpret mode, so its MAE decoder (4 heads over E = 128,
head dim 32) goes through the grouped-heads branch of ``_fwd_kernel`` /
``_bwd_kernel``. Tolerances: stack forward atol 3e-5 / rtol 1e-4 and
gradients atol 3e-4 * max(scale, 1) / rtol 2e-3, as
tests/test_fused_train_layer.py; ``pred`` on valid rows atol 1e-4 (two
2-layer stacks of fp32 sums in another order); losses rtol 1e-5; two AdamW
updates: both steps' gradients through the optimizer's moments within 1e-5 of
each leaf's largest, the parameters rtol 1e-5 / atol 1e-6 where the gradient
is above fp32 noise and within AdamW's bound where it is not (the JAX side is
``optax.adamw`` through the JAX package's ``trainer.adamw``).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from acai_omr_tpu.data import datasets as jax_ds
from acai_omr_tpu.data import loader as jax_loader
from acai_omr_tpu.models import mae as jax_mae
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.ops import transformer as jax_tf
from acai_omr_tpu.parallel import trainer as jax_trainer
from acai_omr_tpu.train import pre_train as jax_pt

from acai_omr_tpu_torch.data import datasets as ds_lib
from acai_omr_tpu_torch.data import loader
from acai_omr_tpu_torch.models import mae, vit_encoder, vitomr, weights
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.ops import train_layer_kernel as tlk
from acai_omr_tpu_torch.ops import transformer
from acai_omr_tpu_torch.parallel import trainer
from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train
from acai_omr_tpu_torch.train import pre_train as pt
from acai_omr_tpu_torch.utils import checkpoint as ckpt_lib

from _torch_port_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# encoder heads 64 wide, decoder heads 32 wide, widths multiples of 128: the
# shapes the JAX package's fused stacks take (`enabled_for_enc`)
ENC = dict(pe_max_height=16, pe_max_width=16, num_layers=2, hidden_dim=128,
           num_heads=2, mlp_dim=256)
MAE = dict(decoder_num_layers=2, decoder_hidden_dim=128, decoder_num_heads=4,
           decoder_mlp_dim=256)


@pytest.fixture(autouse=True)
def _fused_jax_stacks():
    prev = (ptl._FORCE, ptl._INTERPRET)
    ptl.set_test_mode(force=True, interpret=True)
    yield
    ptl.set_test_mode(*prev)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in want:
        w = np.asarray(want[name])
        scale = float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(
            np.asarray(got[name]), w, atol=3e-4 * max(scale, 1.0), rtol=2e-3,
            err_msg=f"grad mismatch at {name}")


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    """Tiny MAE on both sides with the same weights, and one packed batch of
    L = 256 (K = 128): a full image, two ragged ones, and one with fewer
    valid patches than the keep bucket."""
    jcfg = jax_mae.MaeConfig(encoder=jax_enc.EncoderConfig(**ENC), **MAE)
    pcfg = mae.MaeConfig(encoder=vit_encoder.EncoderConfig(**ENC), **MAE)
    jparams = jax_mae.init_mae_params(jax.random.PRNGKey(3), jcfg)
    # biases and LayerNorm vectors away from their zero / one init
    keys = iter(jax.random.split(jax.random.PRNGKey(4), 128))
    jparams = jax.tree.map(
        lambda v: v + 0.02 * jax.random.normal(next(keys), v.shape, v.dtype),
        jparams)
    pparams = weights.mae_params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    rng = np.random.default_rng(0)
    examples = []
    for hp, wp in [(16, 16), (12, 15), (9, 14), (5, 6)]:
        img = rng.random((1, 16 * hp, 16 * wp), dtype=np.float32)
        examples.append((img + 0.1 * rng.random(img.shape, dtype=np.float32),
                         img))
    batch = loader.pack_mae_batch(examples, pcfg.encoder)
    noise = rng.random(batch["valid"].shape, dtype=np.float32)
    return jcfg, pcfg, jparams, pparams, examples, batch, noise


# ---------------------------------------------------------------------------
# mask and gather
# ---------------------------------------------------------------------------

def _masks(valid, lengths, ratio, kb, noise):
    want = jax_enc.mae_mask(None, jnp.asarray(valid), jnp.asarray(lengths),
                            ratio, kb, noise=jnp.asarray(noise))
    got = vit_encoder.mae_mask(torch.from_numpy(valid),
                               torch.from_numpy(lengths), ratio, kb,
                               noise=torch.from_numpy(noise))
    return got, want


@pytest.mark.parametrize("l,ratio,lens", [
    (256, 0.75, [256, 180, 126, 30]),   # 30 valid patches < the 128 kept slots
    (1000, 0.9, [1000, 999, 10, 0]),    # the keep table: 99 of 1,000, not 100
    (128, 0.75, [128, 77, 1, 64]),      # kb = min(L, 128) = L
    (256, 0.0, [256, 100, 3, 0]),       # nothing masked
])
def test_mae_mask_equals_jax_in_every_index(l, ratio, lens):
    rng = np.random.default_rng(l)
    lengths = np.asarray(lens, np.int32)
    valid = np.arange(l)[None, :] < lengths[:, None]
    noise = rng.random((len(lens), l), dtype=np.float32)
    noise[1, :8] = noise[1, 8]  # ties among real patches too
    kb = min(l, mae.keep_bucket_len(l, ratio))
    assert kb == min(l, jax_mae.keep_bucket_len(l, ratio))
    got, want = _masks(valid, lengths, ratio, kb, noise)
    for field in ("ids_keep", "kept_valid", "ids_restore", "seq_mask",
                  "keep_lengths"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.ids_keep.shape == (len(lens), kb)


def test_keep_length_comes_from_the_float64_host_table():
    assert int(vit_encoder.mae_keep_len(1000, 0.9)) == 99
    assert int(np.floor(np.float32(1000) * (np.float32(1) - np.float32(0.9)))) \
        == 100  # what an fp32 floor on the device would keep
    np.testing.assert_array_equal(
        vit_encoder.mae_keep_len(np.arange(1025), 0.9),
        jax_enc.mae_keep_len(np.arange(1025), 0.9))
    assert mae.keep_bucket_len(128, 0.75) == 128
    assert [mae.keep_bucket_len(l, 0.75) for l in (256, 512, 640, 1024)] == \
        [jax_mae.keep_bucket_len(l, 0.75) for l in (256, 512, 640, 1024)]


def test_mae_mask_draws_from_its_generator():
    valid = torch.ones(3, 64, dtype=torch.bool)
    lengths = torch.full((3,), 64)
    draw = lambda seed: vit_encoder.mae_mask(
        valid, lengths, 0.75, 64,
        generator=torch.Generator().manual_seed(seed)).ids_keep
    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5), draw(6))
    with pytest.raises(ValueError, match="generator"):
        vit_encoder.mae_mask(valid, lengths, 0.75, 64)


def test_gather_kept_matches_jax(setup):
    *_, batch, noise = setup
    got_m, want_m = _masks(batch["valid"], batch["lengths"], 0.75, 128, noise)
    x = np.random.default_rng(2).standard_normal((4, 256, 24),
                                                 dtype=np.float32)
    got = vit_encoder.gather_kept(torch.from_numpy(x), got_m)
    want = jax_enc.gather_kept(jnp.asarray(x), want_m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[3, 7:].any()  # 30 valid patches keep int(30 * 0.25) = 7


# ---------------------------------------------------------------------------
# a stack whose heads are 32 wide
# ---------------------------------------------------------------------------

DH32 = dict(n_l=2, b=4, t=32, e=128, h=4, f=256)


@pytest.fixture(scope="module")
def dh32_reference():
    """Inputs, weights, and JAX's fused encoder stack over them (forward and
    gradients, interpret mode): computed once for both backward paths."""
    n_l, b, t, e, h, f = DH32.values()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, e), dtype=np.float32)
    w = rng.standard_normal((b, t, e), dtype=np.float32)
    valid = np.arange(t)[None, :] < np.asarray([t, t - 7, 9, 0])[:, None]
    stacked = jax_tf.stack_init(jax_tf.encoder_layer_init,
                                jax.random.PRNGKey(0), n_l, e, f)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    stacked = jax.tree.map(
        lambda v: v + 0.05 * jax.random.normal(next(keys), v.shape, v.dtype),
        stacked)
    prev = (ptl._FORCE, ptl._INTERPRET)
    ptl.set_test_mode(force=True, interpret=True)
    try:
        assert ptl.enabled_for_enc(b, t, e, h) \
            and ptl._group_spec(e // h)[0] == 2
        run = lambda s, x_: ptl.encoder_stack_fused(s, x_, jnp.asarray(valid),
                                                    h)
        out_j = run(stacked, jnp.asarray(x))
        gw_j, gx_j = jax.grad(lambda s, x_: jnp.sum(run(s, x_) * w),
                              argnums=(0, 1))(stacked, jnp.asarray(x))
    finally:
        ptl.set_test_mode(*prev)
    return x, w, valid, stacked, out_j, gw_j, gx_j


@pytest.mark.parametrize("plain", [False, True],
                         ids=["hand_written_backward", "autograd_of_twins"])
def test_head_dim_32_stack_matches_fused_jax(dh32_reference, plain):
    h = DH32["h"]
    x, w, valid, stacked, out_j, gw_j, gx_j = dh32_reference
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in _flat(jax.tree.map(np.asarray, stacked)).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tlk.encoder_stack_fused(trainer.tree_unflatten(leaves), xt,
                                  torch.from_numpy(valid), h, plain=plain)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=3e-5, rtol=1e-4)
    got = {k.replace("/", "."): v.grad.numpy() for k, v in leaves.items()}
    want = {k.replace("/", "."): v for k, v in _flat(gw_j).items()}
    _assert_grads_close({**got, "x": xt.grad.numpy()}, {**want, "x": gx_j})


# ---------------------------------------------------------------------------
# model, loss, gradients
# ---------------------------------------------------------------------------

def _jax_forward(jcfg, jparams, batch, noise):
    b = _jb(batch)
    return jax_mae.forward(jparams, jcfg, None, b["patches"], b["pe_idx"],
                           b["pe_w"], b["valid"], b["lengths"],
                           b["target_patches"], mask_noise=jnp.asarray(noise))


def _port_forward(pcfg, pparams, batch, noise):
    b = loader.to_device(batch, "cpu")
    return mae.forward(pparams, pcfg, b["patches"], b["pe_idx"], b["pe_w"],
                       b["valid"], b["lengths"], b["target_patches"],
                       mask_noise=torch.from_numpy(noise))


def test_forward_matches_jax_on_valid_rows(setup):
    jcfg, pcfg, jparams, pparams, _, batch, noise = setup
    pred_j, mask_j, tgt_j = _jax_forward(jcfg, jparams, batch, noise)
    pred, mask, tgt = _port_forward(pcfg, pparams, batch, noise)
    assert pred.dtype == torch.float32 and pred.shape == (4, 256, 256)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(tgt_j))
    valid = batch["valid"]
    np.testing.assert_allclose(pred.numpy()[valid], np.asarray(pred_j)[valid],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        float(mae.mae_loss(pred, mask, tgt)),
        float(jax_mae.mae_loss(pred_j, mask_j, tgt_j)), rtol=1e-5)


def test_mae_loss_matches_jax_in_both_reductions():
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((3, 9, 16), dtype=np.float32)
    target = rng.random((3, 9, 16), dtype=np.float32)
    target[0, 0] = 0.5  # a constant patch: the 1e-6 under the root matters
    mask = rng.random((3, 9)) < 0.6
    args_p = [torch.from_numpy(a) for a in (pred, mask, target)]
    args_j = [jnp.asarray(a) for a in (pred, mask, target)]
    np.testing.assert_allclose(float(mae.mae_loss(*args_p)),
                               float(jax_mae.mae_loss(*args_j)), rtol=1e-5)
    s, n = mae.mae_loss(*args_p, reduction="sum")
    s_j, n_j = jax_mae.mae_loss(*args_j, reduction="sum")
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-5)
    assert float(n) == float(n_j) == float(mask.sum())
    # the normaliser is sqrt(var + 1e-6) with the unbiased variance
    t = target[1, 2]
    want = (t - t.mean()) / np.sqrt(t.var(ddof=1) + 1e-6)
    one = torch.zeros(3, 9, dtype=torch.bool)
    one[1, 2] = True
    np.testing.assert_allclose(
        float(mae.mae_loss(args_p[0], one, args_p[2])),
        float(np.mean((pred[1, 2] - want) ** 2)), rtol=1e-5)
    # a batch with no masked patch gives 0, not NaN
    none = np.zeros((3, 9), bool)
    assert float(mae.mae_loss(args_p[0], torch.from_numpy(none),
                              args_p[2])) == 0.0
    assert float(jax_mae.mae_loss(args_j[0], jnp.asarray(none),
                                  args_j[2])) == 0.0


def _share_noise(monkeypatch, noise):
    """The port's loss functions draw their mask from this noise, not from
    their generator (the JAX side is patched the same way)."""
    orig = mae.forward
    monkeypatch.setattr(mae, "forward", lambda *a, **kw: orig(
        *a, **{**kw, "generator": None,
               "mask_noise": torch.from_numpy(noise)}))


@pytest.fixture(scope="module")
def jax_grads(setup):
    jcfg, _, jparams, _, _, batch, noise = setup
    ptl.set_test_mode(force=True, interpret=True)
    try:
        loss_fn = jax_pt.make_loss_fn(jcfg, jnp.float32)
        b = _jb(batch)
        orig = jax_mae.forward
        jax_mae.forward = lambda *a, **kw: orig(
            *a, **kw, mask_noise=jnp.asarray(noise))
        try:
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                jparams, b, None)
        finally:
            jax_mae.forward = orig
    finally:
        ptl.set_test_mode(force=False, interpret=False)
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("backward", ["autograd_of_twins", "hand_written"])
def test_loss_gradients_match_jax_for_every_leaf(setup, jax_grads, backward,
                                                 monkeypatch):
    """The CPU path (autograd through the plain twins), and the sweep the
    card runs (``plain=False``: the hand-written backward, each op its twin)."""
    _, pcfg, _, pparams, _, batch, noise = setup
    if backward == "hand_written":
        monkeypatch.setattr(
            transformer, "encoder_stack",
            lambda stacked, x, valid, heads: tlk.encoder_stack_fused(
                stacked, x, valid, heads, plain=False))
    _share_noise(monkeypatch, noise)
    loss, grads = trainer.make_grad_fn(pt.make_loss_fn(pcfg, torch.float32))(
        pparams, loader.to_device(batch, "cpu"), None)
    want_loss, want = jax_grads
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_grads_close({k: v.numpy() for k, v in
                         trainer.tree_flatten(grads).items()},
                        {k.replace(".", "/"): v for k, v in want.items()})
    assert all(float(np.abs(v).max()) > 0 for v in want.values())


# A gradient that is exactly zero in exact arithmetic comes out of both sides
# as fp32 sum-order noise, 1e-12 to 1e-9 of its leaf's largest: the key part
# of each attention's in-projection bias (softmax ignores a shift shared by a
# query's logits). AdamW divides m by sqrt(v) + eps, so such an element moves
# by up to lr * |g| / eps per step with the noise's sign on each side (F4).
# Elements whose RMS gradient over the two steps is at most NOISE_REL of their
# leaf's largest are held to that bound instead; every other element to
# rtol 1e-5 / atol 1e-6.
NOISE_REL = 1e-6


def _adam_moments(opt_state) -> tuple[dict, dict]:
    """mu and nu of optax's ``scale_by_adam`` state, flattened as ``_flat``."""
    st = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if hasattr(s, "nu"))
    return tuple(_flat(jax.tree.map(np.asarray, t)) for t in (st.mu, st.nu))


def test_two_train_steps_match_optax_adamw(setup, monkeypatch):
    jcfg, pcfg, jparams, pparams, _, batch, noise = setup
    # learning rates around pre_train's BASE_LR of 1.5e-4
    sched = lambda step: 1e-4 * (1 + step)
    jtx = jax_trainer.adamw(lambda s: 1e-4 * (1 + s), betas=pt.ADAMW_BETAS,
                            weight_decay=pt.ADAMW_WEIGHT_DECAY)
    assert (pt.ADAMW_BETAS, pt.ADAMW_WEIGHT_DECAY) == \
        (jax_pt.ADAMW_BETAS, jax_pt.ADAMW_WEIGHT_DECAY) == ((0.9, 0.95), 0.05)
    orig = jax_mae.forward
    jax_mae.forward = lambda *a, **kw: orig(*a, **kw,
                                            mask_noise=jnp.asarray(noise))
    try:
        jstep = jax_trainer.make_train_step(
            jax_pt.make_loss_fn(jcfg, jnp.float32), jtx, donate=False)
        jstate = jax_trainer.create_train_state(jparams, jtx)
        jmetrics = []
        for _ in range(2):
            jstate, m = jstep(jstate, _jb(batch), None)
            jmetrics.append(m)
    finally:
        jax_mae.forward = orig

    tx = trainer.adamw(sched, betas=pt.ADAMW_BETAS,
                       weight_decay=pt.ADAMW_WEIGHT_DECAY)
    step = trainer.make_train_step(pt.make_loss_fn(pcfg, torch.float32), tx)
    state = trainer.create_train_state(pparams, tx)
    _share_noise(monkeypatch, noise)
    b = loader.to_device(batch, "cpu")
    for want in jmetrics:
        state, m = step(state, b, None)
        np.testing.assert_allclose(float(m["loss"]), float(want["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(want["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 2
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    jmu, jnu = _adam_moments(jstate.opt_state)
    mu, nu = (trainer.tree_flatten(state.opt_state[k]) for k in ("mu", "nu"))
    lr_sum, c2 = sched(0) + sched(1), 1.0 - pt.ADAMW_BETAS[1] ** 2
    for k, v in trainer.tree_flatten(state.params).items():
        # both steps' gradients, through the moments (mu linear, nu
        # quadratic in them), within 1e-5 of the leaf's largest
        for got, exp in ((mu[k], jmu[k]), (nu[k], jnu[k])):
            np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                       atol=1e-5 * np.abs(exp).max(),
                                       err_msg=k)
        g_rms = np.sqrt(np.maximum(nu[k].numpy(), jnu[k]) / c2)
        floor = g_rms <= NOISE_REL * g_rms.max()
        v = v.numpy()
        np.testing.assert_allclose(v[~floor], want[k][~floor], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        # |m / (sqrt(v) + eps)| <= min(1, max_t |g_t| / eps) per step, and
        # max_t |g_t| <= 1.5 * g_rms at b2 = 0.95; the sides' signs differ
        bound = 1e-6 + 1e-5 * np.abs(want[k]) \
            + 2 * lr_sum * np.minimum(1.0, 1.5 * g_rms / tx.eps)
        assert (np.abs(v - want[k]) <= bound)[floor].all(), k


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_mae_params_from_jax_is_strict_and_round_trips(setup, tmp_path):
    jcfg, pcfg, jparams, pparams, *_ = setup
    tree = jax.tree.map(np.asarray, jparams)
    flat = weights._flatten(pparams)
    assert flat.keys() == weights._paths(weights.MAE_TEMPLATE)
    for k, v in weights._flatten(tree).items():
        np.testing.assert_array_equal(flat[k].numpy(), v)
    mine = weights._flatten(mae.init_mae_params(pcfg, 0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    missing = {k: v for k, v in tree.items() if k != "mask_token"}
    with pytest.raises(KeyError, match="missing"):
        weights.mae_params_from_jax(missing, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        weights.mae_params_from_jax({**tree, "cls_token": np.zeros(3)},
                                    device="cpu")
    with pytest.raises(KeyError):  # a ViTOMR loader refuses an MAE tree
        weights.params_from_jax(tree, device="cpu")
    ckpt_lib.save_pytree(tmp_path / "m", pparams)
    back = weights._flatten(weights.load_mae_npz(tmp_path / "m.npz",
                                                 device="cpu"))
    assert all(torch.equal(back[k], flat[k]) for k in flat)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mae.init_mae_params(pcfg, 0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("identity", [True, False])
def test_pack_mae_batch_matches_jax(setup, identity):
    jcfg, pcfg, _, _, examples, *_ = setup
    if identity:
        examples = [(inp, inp) for inp, _ in examples]
    got = loader.pack_mae_batch(examples, pcfg.encoder)
    want = jax_loader.pack_mae_batch(examples, jcfg.encoder)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["target_patches"] is got["patches"]) == identity
    assert got["patches"].shape == (4, 256, 256)
    dev = loader.to_device(got, "cpu")
    assert (dev["target_patches"] is dev["patches"]) == identity
    padded = loader.pack_mae_batch(examples, pcfg.encoder, pad_to_batch=6)
    want = jax_loader.pack_mae_batch(examples, jcfg.encoder, pad_to_batch=6)
    for k in want:
        np.testing.assert_array_equal(padded[k], want[k])


class _Base:
    """A base dataset of arrays shaped like one of the three kinds."""

    def __init__(self, kind):
        self.kind = kind

    def __len__(self):
        return 5

    def __getitem__(self, idx):
        img = np.full((1, 2, 2), float(idx), np.float32)
        return {"plain": img, "olimpic": (img, "lmx"),
                "grandstaff": (img, img + 100, "lmx")}[self.kind]


@pytest.mark.parametrize("kind,name", [
    ("plain", "PreTrainWrapper"), ("olimpic", "OlimpicPreTrainWrapper"),
    ("grandstaff", "GrandStaffPreTrainWrapper")])
def test_pretrain_wrappers_match_jax(kind, name):
    double = lambda a: a * 2
    for kw in ({}, {"transform": double}):
        if kind == "grandstaff" and kw:
            kw = {"augment_p": 0.5, **kw}
        mk = lambda mod: getattr(mod, name)(
            _Base(kind), rng=np.random.default_rng(9), **kw)
        got, want = mk(ds_lib), mk(jax_ds)
        assert len(got) == len(want) == 5
        for i in list(range(5)) * 3:
            (gi, gt), (wi, wt) = got[i], want[i]
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
            assert (gi is gt) == (wi is wt)
        if not kw:
            assert all(a is b for a, b in (got[i] for i in range(5)))
    if kind == "grandstaff":
        with pytest.raises(ValueError, match="transform"):
            ds_lib.GrandStaffPreTrainWrapper(_Base(kind), augment_p=0.3)
    a, b = ds_lib.DebugDataset(n=3, kind="mae", seed=4), \
        jax_ds.DebugDataset(n=3, kind="mae", seed=4)
    for i in range(3):
        (x, y), (u, v) = a[i], b[i]
        np.testing.assert_array_equal(x, u)
        assert x is y and u is v


def _write_datasets(root: Path):
    """The four on-disk layouts at a tiny size; returns their roots."""
    rng = np.random.default_rng(0)

    def save(path, h, w):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(path)

    gs, ol = root / "gs", root / "olimpic"
    for split, ids in (("train", ["a/1", "a/2", "b/3"]), ("dev", ["a/4"])):
        (gs / "a").mkdir(parents=True, exist_ok=True)
        (gs / "b").mkdir(exist_ok=True)
        (gs / f"samples.{split}.txt").write_text("\n".join(ids) + "\n")
        for i in ids:
            save(gs / "grandstaff" / f"{i}.jpg", 70, 210)
            save(gs / "grandstaff" / f"{i}_distorted.jpg", 80, 190)
            (gs / f"{i}.lmx").write_text("measure")
    for split, ids in (("train", ["s1", "s2"]), ("dev", ["s3", "s4"])):
        (ol / f"samples.{split}.txt").parent.mkdir(parents=True, exist_ok=True)
        (ol / f"samples.{split}.txt").write_text("\n".join(ids) + "\n")
        for i in ids:
            save(ol / f"{i}.png", 300, 900)
            (ol / f"{i}.lmx").write_text("measure")
    prepared = []
    for name, n in (("primus", 3), ("doremi", 2)):
        d = root / name
        ids = [f"{name}{i}" for i in range(n)]
        for i in ids:
            save(d / "images" / f"{i}.png", 64, 640)
        (d / "ids.csv").write_text("id\n" + "\n".join(ids) + "\n")
        prepared.append(d)
    return gs, ol, prepared[0], prepared[1]


def _spec(t):
    """A transform pipeline as nested (class name, constants)."""
    if not hasattr(t, "__dict__"):
        return getattr(t, "__name__", repr(t))
    const = {k: v for k, v in vars(t).items() if k not in ("rng", "transforms")}
    return (type(t).__name__, const,
            [_spec(c) for c in getattr(t, "transforms", [])])


def test_build_datasets_on_a_tiny_directory(tmp_path, monkeypatch):
    gs, ol, primus, doremi = _write_datasets(tmp_path)
    for mod in (pt, jax_pt):
        monkeypatch.setattr(mod, "GRAND_STAFF_ROOT_DIR", str(gs))
        monkeypatch.setattr(mod, "OLIMPIC_SYNTHETIC_ROOT_DIR", str(ol))
        monkeypatch.setattr(mod, "PRIMUS_PREPARED_ROOT_DIR", str(primus))
        monkeypatch.setattr(mod, "DOREMI_PREPARED_ROOT_DIR", str(doremi))
    train, val = pt.build_datasets()
    jtrain, jval = jax_pt.build_datasets()
    assert (len(train), len(val)) == (len(jtrain), len(jval)) == (10, 3)
    # validation has no random augmentation: equal arrays, target is input
    for i in range(len(val)):
        (x, y), (u, v) = val[i], jval[i]
        np.testing.assert_array_equal(x, u)
        assert x is y and x.dtype == np.float32 and x.ndim == 3
        assert x.shape[-1] % 16 == 0 and x.shape[-2] % 16 == 0
        assert (x.shape[-1] // 16) * (x.shape[-2] // 16) <= 512
    # the same wrappers over the same mix, the pretraining camera stack's
    # constants included
    for mine, theirs in zip(train.datasets, jtrain.datasets):
        assert type(mine).__name__ == type(theirs).__name__
        assert _spec(mine.transform) == _spec(theirs.transform)
        assert getattr(mine, "augment_p", None) == \
            getattr(theirs, "augment_p", None)
        assert _spec(mine.base_dataset.img_transform
                     if hasattr(mine.base_dataset, "img_transform")
                     else mine.base_dataset.transform) == \
            _spec(theirs.base_dataset.img_transform
                  if hasattr(theirs.base_dataset, "img_transform")
                  else theirs.base_dataset.transform)
    for i in range(len(train)):
        inp, tgt = train[i]
        assert inp.shape == tgt.shape and inp.dtype == np.float32
    prepared = ds_lib.PreparedDataset(primus)
    assert len(prepared) == 3 and prepared[1].size == (640, 64)
    batch = loader.pack_mae_batch([val[i] for i in range(len(val))],
                                  pt.set_up_mae().encoder)
    assert batch["patches"].shape[1] % 128 == 0


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_constants_and_set_up_mae_match_jax():
    import dataclasses
    for name in ("MASK_RATIO", "AUGMENTATION_P", "EPOCHS", "CHECKPOINT_FREQ",
                 "BASE_LR", "MIN_LR", "ADAMW_BETAS", "ADAMW_WEIGHT_DECAY",
                 "WARMUP_EPOCHS", "BATCH_SIZE", "NUM_WORKERS"):
        assert getattr(pt, name) == getattr(jax_pt, name), name
    cfg = pt.set_up_mae()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_pt.set_up_mae())
    assert cfg.decoder_hidden_dim // cfg.decoder_num_heads == 32
    assert cfg.encoder.hidden_dim // cfg.encoder.num_heads == 64


def test_pre_train_imports_without_pandas():
    code = ("import sys; sys.modules['pandas'] = None\n"
            "import acai_omr_tpu_torch.train.pre_train as pt\n"
            "print(pt.set_up_mae().decoder_num_heads, 'jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["16", "False"]


def test_tiny_pre_train_resume_and_hand_off(tmp_path, monkeypatch):
    cfg = mae.MaeConfig(encoder=vit_encoder.EncoderConfig(**ENC), **MAE)
    mk = lambda n, seed: ds_lib.DebugDataset(
        n=n, sizes=((64, 96), (48, 64)), kind="mae", seed=seed)
    kw = dict(batch_size=4, warmup_epochs=1, checkpoint_freq=1, num_workers=2,
              compute_dtype=torch.float32, device="cpu",
              model_dir=tmp_path / "mae")
    seen = []
    params, stats = pt.pre_train(
        cfg, mk(6, 0), mk(4, 1), epochs=2,
        step_hook=lambda kind, info: seen.append(kind), **kw)
    assert len(stats["train_losses"]) == len(stats["val_losses"]) == 2
    assert all(np.isfinite(v) and v > 0 for v in
               stats["train_losses"] + stats["val_losses"])
    # two buckets of sizes -> 2 train batches and 1 validation batch per epoch
    assert seen == ["step", "step", "val"] * 2
    for f in ("stats.csv", "pretrained_mae.npz", "checkpoints/epoch_1.npz",
              "checkpoints/epoch_2.npz"):
        assert (tmp_path / "mae" / f).exists(), f
    start = mae.init_mae_params(cfg, 0, device="cpu")
    moved = [k for k, v in trainer.tree_flatten(params).items()
             if not torch.equal(v, trainer.tree_flatten(start)[k])]
    assert len(moved) == len(trainer.tree_flatten(start))

    # resume from the first epoch's checkpoint: one more epoch from step 2
    with pytest.raises(FileExistsError):
        pt.pre_train(cfg, mk(6, 0), mk(4, 1), epochs=2, **kw)
    resumed, rstats = pt.pre_train(
        cfg, mk(6, 0), mk(4, 1), epochs=2,
        resume_from=tmp_path / "mae" / "checkpoints" / "epoch_1", **kw)
    assert len(rstats["train_losses"]) == 1
    state = ckpt_lib.load_pytree(tmp_path / "mae" / "checkpoints" / "epoch_2")
    assert int(state["step"]) == 4

    # a crash leaves a resumable state behind and the error propagates
    def boom(kind, info):
        raise RuntimeError("stop here")
    with pytest.raises(RuntimeError, match="stop here"):
        pt.pre_train(cfg, mk(6, 0), mk(4, 1), epochs=1, step_hook=boom,
                     **{**kw, "model_dir": tmp_path / "crash"})
    assert int(ckpt_lib.load_pytree(
        tmp_path / "crash" / "checkpoints" / "emergency")["step"]) == 1

    # the hand-off: the file loads as an MAE tree, and stage 2 starts from
    # exactly its encoder
    npz = tmp_path / "mae" / "pretrained_mae.npz"
    loaded = weights.load_mae_npz(npz, device="cpu")
    want = trainer.tree_flatten(resumed)
    assert all(torch.equal(v, want[k])
               for k, v in trainer.tree_flatten(loaded).items())
    tiny = vitomr.ViTOMRConfig(
        vit_encoder.EncoderConfig(**ENC, fine_tune_depth=1),
        DecoderConfig(vocab_size=227, num_layers=1, hidden_dim=128,
                      num_heads=2, mlp_dim=256, max_lmx_seq_len=128),
        transition_head_dim=64)
    monkeypatch.setattr(tf_train, "set_up_vitomr", lambda tok: tiny)
    _, stage2, _, _ = tf_train.set_up_omr_teacher_force_train(str(npz),
                                                              device="cpu")
    enc = trainer.tree_flatten(stage2["encoder"])
    assert enc.keys() == {k[len("encoder/"):] for k in want
                          if k.startswith("encoder/")}
    assert all(torch.equal(v, want[f"encoder/{k}"]) for k, v in enc.items())
    fresh = vitomr.init_vitomr_params(tiny, 0, device="cpu")
    swapped = vitomr.vitomr_params_from_mae(fresh, ckpt_lib.load_params(npz))
    assert swapped["decoder"] is fresh["decoder"]
    assert torch.equal(swapped["encoder"]["final_norm"]["scale"],
                       want["encoder/final_norm/scale"])
    broken = ckpt_lib.load_params(npz)
    del broken["encoder"]["final_norm"]
    with pytest.raises(KeyError, match="missing"):
        vitomr.vitomr_params_from_mae(fresh, broken)
