"""Stage-2 training of the port against the JAX package, at fp32 on the CPU:
the teacher-forced and scheduled-sampling losses and their gradients, the
optimizer, the schedules, the data pipeline, checkpoints and the loop.

Weights and inputs are made with numpy seeds and go into both sides; the JAX
side runs its fused Pallas stacks forced in interpret mode. Random draws are
shared by handing both sides the same arrays (the JAX functions are called
as they are, with ``jax.random.gumbel`` / ``uniform`` patched to return
them). Tolerances: logits and losses 1e-4 absolute (two 2-layer stacks of
fp32 sums in another order); gradients 3e-4 * max(scale, 1) absolute and 2e-3
relative, as tests/test_fused_train_layer.py; three optimizer steps 1e-6
absolute on parameters of O(1) (the JAX side is ``optax.adamw`` through the
JAX package's ``trainer.adamw``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.data import bucketing as jax_bucketing
from acai_omr_tpu.data import loader as jax_loader
from acai_omr_tpu.data.datasets import DebugDataset as JaxDebugDataset
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.parallel import trainer as jax_trainer
from acai_omr_tpu.train import schedules as jax_schedules

from acai_omr_tpu_torch.data import bucketing, loader
from acai_omr_tpu_torch.data.datasets import DebugDataset
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.models import vit_encoder, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import load_npz, params_from_jax
from acai_omr_tpu_torch.parallel import trainer
from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train
from acai_omr_tpu_torch.train import schedules
from acai_omr_tpu_torch.utils import checkpoint as ckpt_lib

from _torch_port_threads import torch_one_thread  # noqa: F401

# head dim 64 and widths that are multiples of 128: the JAX package's fused
# stacks take these shapes (its `enabled_for` gates)
ENC = dict(pe_max_height=8, pe_max_width=8, num_layers=2, hidden_dim=128,
           num_heads=2, mlp_dim=256, fine_tune_depth=1)
DEC = dict(vocab_size=40, num_layers=2, hidden_dim=128, num_heads=2,
           mlp_dim=256, max_lmx_seq_len=128, dropout=0.1)
PAD = 1


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
            got[name].numpy(), w, atol=3e-4 * max(scale, 1.0), rtol=2e-3,
            err_msg=f"grad mismatch at {name}")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_vitomr.ViTOMRConfig(jax_enc.EncoderConfig(**ENC),
                                   JaxDecoderConfig(**DEC),
                                   transition_head_dim=256)
    pcfg = vitomr.ViTOMRConfig(vit_encoder.EncoderConfig(**ENC),
                               DecoderConfig(**DEC), transition_head_dim=256)
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(3), jcfg)
    # pos embeddings are trunc-normal 0.1, embeddings N(0, 1): keep, and move
    # biases and LayerNorm vectors off their zero / one init
    keys = iter(jax.random.split(jax.random.PRNGKey(4), 128))
    jparams = jax.tree.map(
        lambda v: v + 0.02 * jax.random.normal(next(keys), v.shape, v.dtype),
        jparams)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    examples = [(rng.random((1, 16 * hp, 16 * wp), dtype=np.float32),
                 np.concatenate([[0], rng.integers(3, 40, n), [2]])
                 .astype(np.int32))
                for hp, wp, n in [(4, 6, 10), (6, 8, 17), (3, 5, 5)]]

    class Tok:
        pad_idx = PAD

    batch = loader.pack_omr_batch(examples, pcfg.encoder, Tok(),
                                  max_lmx_seq_len=128)
    return jcfg, pcfg, jparams, pparams, examples, batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return loader.to_device(batch, "cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_pack_omr_batch_matches_jax(setup):
    jcfg, pcfg, _, _, examples, batch = setup

    class Tok:
        pad_idx = PAD

    want = jax_loader.pack_omr_batch(examples, jcfg.encoder, Tok(),
                                     max_lmx_seq_len=128)
    assert batch.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
    assert batch["patches"].shape[1] == 128 and batch["inputs"].shape[1] == 128
    padded = loader.pack_omr_batch(examples, pcfg.encoder, Tok(),
                                   max_lmx_seq_len=128, pad_to_batch=4)
    want = jax_loader.pack_omr_batch(examples, jcfg.encoder, Tok(),
                                     max_lmx_seq_len=128, pad_to_batch=4)
    for k in want:
        np.testing.assert_array_equal(padded[k], want[k])
    assert not padded["valid"][3].any() and (padded["targets"][3] == PAD).all()


@pytest.mark.parametrize("shuffle", [True, False])
def test_bucket_sampler_matches_jax(shuffle):
    sizes = ((64, 96), (48, 64), (200, 300), (64, 400))
    bounds = [(64, 96), (64, 512)]
    mk = lambda cls: cls(n=23, sizes=sizes, seq_len=4, vocab=9, kind="omr",
                         seed=5)
    want = jax_bucketing.BucketBatchSampler(
        JaxDebugDataset(n=23, sizes=sizes, seq_len=4, vocab=9, kind="omr",
                        seed=5), bounds, 4, shuffle=shuffle, seed=7)
    got = bucketing.BucketBatchSampler(mk(DebugDataset), bounds, 4,
                                       shuffle=shuffle, seed=7)
    assert len(got) == len(want)
    for _ in range(2):  # two epochs: the generator's state carries over
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert bucketing.default_bucket_boundaries() == \
        jax_bucketing.default_bucket_boundaries()


def test_debug_dataset_and_prefetch_loader_match_jax():
    a = DebugDataset(n=5, seq_len=6, vocab=12, kind="omr", seed=3)
    b = JaxDebugDataset(n=5, seq_len=6, vocab=12, kind="omr", seed=3)
    for i in range(5):
        (ia, sa), (ib, sb) = a[i], b[i]
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(sa, sb)
    ds = DebugDataset(n=7, sizes=((32, 32),), seq_len=3, vocab=9, kind="omr")
    sampler = bucketing.BucketBatchSampler(ds, [(32, 32)], 3, shuffle=False)
    got = list(loader.PrefetchLoader(ds, sampler, lambda ex: len(ex), 2))
    assert got == [3, 3, 1]
    boom = loader.PrefetchLoader(ds, sampler, lambda ex: 1 / 0, 2)
    with pytest.raises(ZeroDivisionError):
        list(boom)


def test_debug_dataset_default_kind_is_jax_s():
    """``DebugDataset()`` with no ``kind`` yields the (image, image) MAE pairs
    of the JAX package's, equal array for array."""
    a, b = DebugDataset(n=3, seed=2), JaxDebugDataset(n=3, seed=2)
    assert a.kind == b.kind == "mae"
    for i in range(3):
        (ia, ta), (ib, tb) = a[i], b[i]
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ta, tb)
        assert ta is ia


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_omr_ce_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 9, 40), dtype=np.float32) * 3
    targets = rng.integers(0, 40, (3, 9)).astype(np.int32)
    targets[1, 4:] = PAD
    args_j = (jnp.asarray(logits), jnp.asarray(targets), PAD, smoothing)
    args_p = (torch.from_numpy(logits), torch.from_numpy(targets), PAD,
              smoothing)
    np.testing.assert_allclose(float(vitomr.omr_ce_loss(*args_p, "mean")),
                               float(jax_vitomr.omr_ce_loss(*args_j, "mean")),
                               rtol=1e-5)
    got_sum, got_n = vitomr.omr_ce_loss(*args_p, "sum")
    want_sum, want_n = jax_vitomr.omr_ce_loss(*args_j, "sum")
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=1e-5)
    assert float(got_n) == float(want_n) == 22.0
    all_pad = np.full((2, 3), PAD, np.int32)
    assert float(vitomr.omr_ce_loss(torch.from_numpy(logits[:2, :3]),
                                    torch.from_numpy(all_pad), PAD)) == 0.0


def test_teacher_forced_logits_loss_and_gradients_match_jax(setup):
    jcfg, pcfg, jparams, pparams, _, batch = setup
    jb, tb = _jb(batch), _tb(batch)

    def jax_loss(p):
        logits = jax_vitomr.forward_teacher_forced(
            p, jcfg, jb["patches"], jb["pe_idx"], jb["pe_w"], jb["valid"],
            jb["inputs"], jb["lmx_valid"], frozen_stop_gradient=True)
        return jax_vitomr.omr_ce_loss(logits, jb["targets"], PAD, 0.1), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        jax_loss, has_aux=True)(jparams)

    got_logits = {}

    def loss_fn(p, b, seed):
        logits = vitomr.forward_teacher_forced(
            p, pcfg, b["patches"], b["pe_idx"], b["pe_w"], b["valid"],
            b["inputs"], b["lmx_valid"], frozen_stop_gradient=True)
        got_logits["v"] = logits.detach()
        return vitomr.omr_ce_loss(logits, b["targets"], PAD, 0.1), {}

    loss, grads = trainer.make_grad_fn(loss_fn)(pparams, tb, 0)
    np.testing.assert_allclose(got_logits["v"].numpy(), np.asarray(want_logits),
                               atol=1e-4)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4)
    got = _flat(grads)
    _assert_grads_close(got, _flat(jax.tree.map(np.asarray, want_grads)))
    # the frozen prefix (layer 0 of 2) and what feeds it get no gradient
    assert not got["encoder/blocks/linear1/kernel"][0].any()
    assert got["encoder/blocks/linear1/kernel"][1].any()
    assert not got["encoder/projection/kernel"].any()
    assert not got["encoder/pos_embedding"].any()


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_and_mixing_match_jax_on_a_shared_draw(setup, hard,
                                                              monkeypatch):
    _, _, jparams, pparams, _, batch = setup
    rng = np.random.default_rng(2)
    b, t = batch["inputs"].shape
    logits = rng.standard_normal((b, t, 40), dtype=np.float32) * 2
    u = rng.random((b, t), dtype=np.float32)
    noise = rng.gumbel(size=(b, t, 40)).astype(np.float32)
    w = rng.standard_normal((b, t, 128), dtype=np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u))

    want_y = jax_vitomr.gumbel_softmax(None, jnp.asarray(logits), 0.7, hard)
    got_y = vitomr.gumbel_softmax(torch.from_numpy(logits), 0.7, hard,
                                  torch.from_numpy(noise))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)

    def jax_mixed(lg):
        return jnp.sum(jax_vitomr.sample_and_mix_seqs(
            jparams, jax.random.PRNGKey(0), jnp.asarray(batch["inputs"]), lg,
            0.4, 0.7, hard) * w)

    want_grad = jax.grad(jax_mixed)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    mixed = vitomr.sample_and_mix_seqs(
        pparams, torch.from_numpy(batch["inputs"]), lg, 0.4, 0.7, hard,
        sample_mask=torch.from_numpy(u < 0.6), noise=torch.from_numpy(noise))
    want = jax_vitomr.sample_and_mix_seqs(
        jparams, jax.random.PRNGKey(0), jnp.asarray(batch["inputs"]),
        jnp.asarray(logits), 0.4, 0.7, hard)
    np.testing.assert_allclose(mixed.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    (mixed * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad),
                               atol=1e-5, rtol=1e-4)
    # <bos> stem first, predictions right-shifted
    gold = pparams["decoder"]["vocab_embedding"]["table"][
        torch.from_numpy(batch["inputs"]).long()]
    torch.testing.assert_close(mixed[:, 0].detach(), gold[:, 0])


@pytest.mark.parametrize("hard", [False, True])
def test_scheduled_sampling_loss_and_gradients_match_jax(setup, hard,
                                                         monkeypatch):
    """The slice as a whole: both decoder passes over one mem_kv, the mix,
    the loss, and the gradient of every leaf (dropout off: the two packages'
    dropout streams differ by design)."""
    jcfg, pcfg, jparams, pparams, _, batch = setup
    jb, tb = _jb(batch), _tb(batch)
    rng = np.random.default_rng(5)
    b, t = batch["inputs"].shape
    u = rng.random((b, t), dtype=np.float32)
    noise = rng.gumbel(size=(b, t, 40)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u))
    monkeypatch.setattr(vitomr, "sample_and_mix_seqs", functools.partial(
        vitomr.sample_and_mix_seqs, sample_mask=torch.from_numpy(u < 0.5),
        noise=torch.from_numpy(noise)))

    def jax_loss(p):
        logits = jax_vitomr.forward_scheduled_sampling(
            p, jcfg, jb["patches"], jb["pe_idx"], jb["pe_w"], jb["valid"],
            jb["inputs"], jb["lmx_valid"], 0.5, 2.0, hard,
            jax.random.PRNGKey(0), deterministic=True)
        return jax_vitomr.omr_ce_loss(logits, jb["targets"], PAD)

    want_loss, want_grads = jax.value_and_grad(jax_loss)(jparams)

    def loss_fn(p, bt, seed):
        logits = vitomr.forward_scheduled_sampling(
            p, pcfg, bt["patches"], bt["pe_idx"], bt["pe_w"], bt["valid"],
            bt["inputs"], bt["lmx_valid"], 0.5, 2.0, hard, seed,
            deterministic=True)
        return vitomr.omr_ce_loss(logits, bt["targets"], PAD), {}

    loss, grads = trainer.make_grad_fn(loss_fn)(pparams, tb, 3)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4)
    _assert_grads_close(_flat(grads),
                        _flat(jax.tree.map(np.asarray, want_grads)))


def test_training_forward_draws_from_its_seed_only(setup):
    """Dropout on: the same seed gives the same draws (loss and gradients
    agree to rounding), another seed other ones, and no global generator is
    touched."""
    _, pcfg, _, pparams, _, batch = setup
    tb = _tb(batch)
    tb.update(tf_prob=0.5, tau=2.0)
    grad_fn = trainer.make_grad_fn(
        tf_train.make_loss_fn(pcfg, {"use_hard_sampling": False},
                              torch.float32))
    state = torch.get_rng_state()
    l1, g1 = grad_fn(pparams, tb, 11)
    l2, g2 = grad_fn(pparams, tb, 11)
    l3, _ = grad_fn(pparams, tb, 12)
    assert torch.equal(state, torch.get_rng_state())
    # the CPU's threaded sums may differ in the last bits between two runs;
    # another dropout or sampling draw moves the loss in the second decimal
    assert abs(float(l1) - float(l2)) < 1e-5 < 1e-3 < abs(float(l1) - float(l3))
    for a, b in zip(_flat(g1).values(), _flat(g2).values()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    det, _ = trainer.make_grad_fn(lambda p, b, s: (vitomr.omr_ce_loss(
        vitomr.forward_scheduled_sampling(
            p, pcfg, b["patches"], b["pe_idx"], b["pe_w"], b["valid"],
            b["inputs"], b["lmx_valid"], 0.5, 2.0, False, s,
            deterministic=True), b["targets"], PAD), {}))(pparams, tb, 11)
    assert abs(float(det) - float(l1)) > 1e-4  # dropout really acted


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_schedules_match_jax_on_a_grid():
    want = jax_schedules.cosine_anneal_with_warmup(1e-4, 6, 40, 1e-6)
    got = schedules.cosine_anneal_with_warmup(1e-4, 6, 40, 1e-6)
    for step in list(range(0, 45)) + [100]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-6)
    a = jax_schedules.TFSchedule(1.0, 0.0, 5.0, 0.1, soft_steps=7,
                                 anneal_steps=20)
    b = schedules.TFSchedule(1.0, 0.0, 5.0, 0.1, soft_steps=7, anneal_steps=20)
    for step in range(0, 30):
        assert b.at(step) == a.at(step)
    degenerate = schedules.cosine_anneal_with_warmup(1e-3, 0, 0, 1e-5)
    np.testing.assert_allclose(
        degenerate(0), float(jax_schedules.cosine_anneal_with_warmup(
            1e-3, 0, 0, 1e-5)(0)), rtol=2e-6)


def test_llrd_scales_match_jax(setup):
    jcfg, pcfg, jparams, pparams, _, _ = setup
    for depth in (0, 1, 2):
        jc = jax_vitomr.ViTOMRConfig(
            jax_enc.EncoderConfig(**{**ENC, "fine_tune_depth": depth}),
            jcfg.decoder, transition_head_dim=256)
        pc = vitomr.ViTOMRConfig(
            vit_encoder.EncoderConfig(**{**ENC, "fine_tune_depth": depth}),
            pcfg.decoder, transition_head_dim=256)
        want = _flat(jax_trainer.encoder_llrd_scales(jparams, jc, 0.1, 0.9))
        got = _flat(trainer.encoder_llrd_scales(pparams, pc, 0.1, 0.9))
        assert got.keys() == want.keys()
        for k in want:
            g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
            np.testing.assert_allclose(g, np.asarray(want[k]), rtol=1e-6)
            assert np.shape(g) == np.shape(want[k])


def test_three_optimizer_steps_match_optax(setup):
    jcfg, pcfg, jparams, pparams, _, _ = setup
    sched_j = jax_schedules.cosine_anneal_with_warmup(1e-2, 2, 10, 1e-4)
    sched_p = schedules.cosine_anneal_with_warmup(1e-2, 2, 10, 1e-4)
    tx_j = jax_trainer.adamw(
        sched_j, betas=(0.9, 0.95), weight_decay=0.01,
        scale_tree_fn=lambda p: jax_trainer.encoder_llrd_scales(p, jcfg, 0.1,
                                                                0.9))
    tx_p = trainer.adamw(
        sched_p, betas=(0.9, 0.95), weight_decay=0.01,
        scale_tree_fn=lambda p: trainer.encoder_llrd_scales(p, pcfg, 0.1, 0.9))
    state_j = jax_trainer.create_train_state(jparams, tx_j)
    state_p = trainer.create_train_state(pparams, tx_p)
    apply_j = jax_trainer.make_apply_fn(tx_j, donate=False)
    apply_p = trainer.make_apply_fn(tx_p)
    rng = np.random.default_rng(9)
    flat_names = list(_flat(pparams))
    for step in range(3):
        grads = {n: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                 * 10.0 ** rng.integers(-3, 1)
                 for n, v in _flat(pparams).items()}
        unflat = lambda conv: trainer.tree_unflatten(
            {n: conv(grads[n]) for n in flat_names})
        state_j = apply_j(state_j, unflat(jnp.asarray), jnp.float32(1.0))
        state_p = apply_p(state_p, unflat(torch.from_numpy), 1.0)
    assert state_p.step == int(state_j.step) == 3
    want = _flat(jax.tree.map(np.asarray, state_j.params))
    got = _flat(state_p.params)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    # frozen: encoder layer 0, bit-unchanged; the caller's tree untouched
    start = _flat(pparams)
    for name in start:
        if name.startswith("encoder/blocks/"):
            assert torch.equal(got[name][0], start[name][0]), name
            assert not torch.equal(got[name][1], start[name][1]), name


def test_gradient_accumulation_adds_in_place(setup):
    _, pcfg, _, pparams, _, batch = setup
    tb = _tb(batch)

    def loss_fn(p, b, seed):
        return (p["decoder"]["final_norm"]["scale"] * seed).sum() \
            + 0 * p["decoder"]["unembed"]["bias"].sum(), {}

    loss, acc = trainer.make_grad_fn(loss_fn)(pparams, tb, 2.0)
    before = acc["decoder"]["final_norm"]["scale"]
    _, acc2 = trainer.make_grad_acc_fn(loss_fn)(pparams, tb, 3.0, acc)
    assert acc2 is acc and acc["decoder"]["final_norm"]["scale"] is before
    torch.testing.assert_close(before, torch.full_like(before, 5.0))
    # a leaf the loss does not reach gets zeros, not None
    assert not acc["encoder"]["pos_embedding"].any()


# ---------------------------------------------------------------------------
# checkpoints and the loop
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(setup, tmp_path):
    _, pcfg, _, pparams, _, _ = setup
    tx = trainer.adamw(1e-3, scale_tree_fn=lambda p: trainer.encoder_llrd_scales(
        p, pcfg, 0.1, 0.9))
    state = trainer.create_train_state(pparams, tx)
    grads = trainer.tree_map(torch.ones_like, state.params)
    state = trainer.make_apply_fn(tx)(state, grads)
    path = ckpt_lib.save_train_state(tmp_path / "ckpt" / "epoch_1", state)
    assert path.name == "epoch_1.npz"
    fresh = trainer.create_train_state(pparams, tx)
    restored = ckpt_lib.load_train_state(tmp_path / "ckpt" / "epoch_1", fresh)
    assert restored.step == 1
    for key in ("mu", "nu"):
        for a, b in zip(_flat(restored.opt_state[key]).values(),
                        _flat(state.opt_state[key]).values()):
            assert torch.equal(a, b)
    loaded = ckpt_lib.load_params(tmp_path / "ckpt" / "epoch_1")
    for a, b in zip(_flat(loaded).values(), _flat(state.params).values()):
        np.testing.assert_array_equal(a, b.numpy())
    # a bare parameter file is what inference loads
    ckpt_lib.save_pytree(tmp_path / "vitomr", state.params)
    served = load_npz(str(tmp_path / "vitomr.npz"), device="cpu")
    for a, b in zip(_flat(served).values(), _flat(state.params).values()):
        assert torch.equal(a, b)


def test_teacher_force_loop_runs(tmp_path):
    """The loop as the JAX package's tests/test_train_loops.py runs it: tiny
    model, DebugDataset, two epochs on the CPU."""
    tokenizer = LmxTokenizer()
    enc = vit_encoder.EncoderConfig(patch_size=16, pe_max_height=6,
                                    pe_max_width=8, num_layers=2,
                                    hidden_dim=16, num_heads=2, mlp_dim=24,
                                    fine_tune_depth=1, dropout=0.05)
    cfg = vitomr.ViTOMRConfig(
        encoder=enc,
        decoder=DecoderConfig.from_tokenizer(tokenizer, max_lmx_seq_len=64,
                                             num_layers=2, hidden_dim=16,
                                             num_heads=2, mlp_dim=24,
                                             dropout=0.1),
        transition_head_dim=24, transition_head_dropout=0.05)
    params = vitomr.init_vitomr_params(cfg, seed=0, device="cpu")
    train_ds = DebugDataset(n=6, sizes=((64, 96), (48, 64)), seq_len=10,
                            vocab=tokenizer.vocab_size, kind="omr")
    val_ds = DebugDataset(n=2, sizes=((64, 96),), seq_len=10,
                          vocab=tokenizer.vocab_size, kind="omr", seed=1)
    events = []
    new_params, stats = tf_train.omr_teacher_force_train(
        cfg, params, train_ds, val_ds, tokenizer, epochs=2, batch_size=3,
        grad_accumulation_steps=2, warmup_epochs=1, checkpoint_freq=2,
        model_dir=tmp_path / "tf", num_workers=2, tf_anneal_epochs=1,
        soft_epochs=1, bucket_boundaries=[(64, 96)],
        compute_dtype=torch.float32, device="cpu",
        step_hook=lambda kind, info: events.append(kind))
    assert len(stats["train_losses"]) == 2
    assert all(np.isfinite(stats["train_losses"] + stats["val_losses"]))
    assert events == ["micro", "micro", "update", "val"] * 2
    assert (tmp_path / "tf" / "vitomr.npz").exists()
    assert (tmp_path / "tf" / "checkpoints" / "epoch_2.npz").exists()
    rows = (tmp_path / "tf" / "stats.csv").read_text().splitlines()
    assert rows[0] == "step,tag,value" and len(rows) == 1 + 2 * 3 + 2 * 2

    # frozen encoder prefix must not have moved (fine_tune_depth=1 of 2)
    old = params["encoder"]["blocks"]["self_attn"]["in_kernel"]
    new = new_params["encoder"]["blocks"]["self_attn"]["in_kernel"]
    assert torch.equal(new[0], old[0])
    assert (new[1] - old[1]).abs().max() > 0
    assert torch.equal(new_params["encoder"]["pos_embedding"],
                       params["encoder"]["pos_embedding"]) is False
    with pytest.raises(FileExistsError):
        tf_train.omr_teacher_force_train(
            cfg, params, train_ds, val_ds, tokenizer, epochs=1,
            model_dir=tmp_path / "tf", device="cpu")


def test_training_entry_points_refuse_a_missing_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf_train.omr_teacher_force_train(None, {}, [], [], None,
                                         model_dir=tmp_path / "x")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf_train.set_up_omr_teacher_force_train("missing")
