"""The port reads the checkpoints the JAX package writes (orbax directories).

JAX's ``utils/checkpoint.save_pytree`` / ``save_train_state`` write seeded
tiny ViTOMR and MAE trees, with bf16 and fp32 leaves, into ``tmp_path``; the
port's ``utils/checkpoint`` and ``models/weights`` readers (tensorstore, no
JAX) must hand back the same leaves bit for bit, the loaded decoder must
decode JAX's greedy tokens at fp32, a JAX train state must resume in the
port's ``load_train_state`` (its Adam moments bit for bit, in each of the
three forms of the optax chain that the JAX package's ``trainer.adamw``
builds: stage 1, stage 2 with its LLRD scales, GRPO with clipping and frozen
scales; one further port step against JAX's), a malformed chain must raise
``ValueError``, the port's ``pre_train`` must resume from a JAX directory,
and the port's own ``.npz`` must still round-trip. Tolerances: leaves exact;
tokens exact; log-probs 2e-4 absolute (as tests/test_torch_port_decode_hd.py);
the step after resume as tests/test_torch_port_mae.py's
``test_two_train_steps_match_optax_adamw``: parameters rtol 1e-5 / atol
1e-6, moments 1e-5 of each leaf's largest entry.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acai_omr_tpu.models import decode as jax_decode
from acai_omr_tpu.models import mae as jax_mae
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.parallel import trainer as jax_trainer
from acai_omr_tpu.train import omr_grpo_train as jax_grpo
from acai_omr_tpu.utils import checkpoint as jax_ckpt

from acai_omr_tpu_torch.data import datasets as ds_lib
from acai_omr_tpu_torch.models import decode, mae, vit_encoder, vitomr
from acai_omr_tpu_torch.models import weights
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.ops import decode_kernel
from acai_omr_tpu_torch.parallel import trainer
from acai_omr_tpu_torch.train import omr_grpo_train as grpo
from acai_omr_tpu_torch.train import pre_train as pt
from acai_omr_tpu_torch.utils import checkpoint as ckpt
from acai_omr_tpu_torch.utils import orbax_tree

from _torch_port_threads import torch_one_thread  # noqa: F401

ENC = dict(pe_max_height=4, pe_max_width=6, num_layers=1, hidden_dim=32,
           num_heads=2, mlp_dim=64)
DEC = dict(max_lmx_seq_len=64, vocab_size=33, num_layers=2, hidden_dim=64,
           num_heads=4, mlp_dim=128, eos_idx=2)
MAE = dict(decoder_num_layers=1, decoder_hidden_dim=32, decoder_num_heads=2,
           decoder_mlp_dim=64)
B, M = 4, 12


def _mixed(tree):
    """numpy leaves: every dense kernel in bf16, everything else fp32."""
    flat = weights._flatten(jax.tree.map(np.asarray, tree))
    return weights._unflatten({
        k: v.astype(jnp.bfloat16) if k.endswith("kernel") else v
        for k, v in flat.items()})


def _same(got: dict, want: dict):
    """Two tensor trees with the same keys, dtypes and bits."""
    got, want = weights._flatten(got), weights._flatten(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_ckpt")
    cfg = jax_vitomr.ViTOMRConfig(jax_enc.EncoderConfig(**ENC),
                                  JaxDecoderConfig(**DEC),
                                  transition_head_dim=48)
    params = _mixed(jax_vitomr.init_vitomr_params(jax.random.PRNGKey(0), cfg))
    mcfg = jax_mae.MaeConfig(encoder=jax_enc.EncoderConfig(**ENC), **MAE)
    mae_params = _mixed(jax_mae.init_mae_params(jax.random.PRNGKey(1), mcfg))
    jax_ckpt.save_pytree(root / "params", params)
    jax_ckpt.save_pytree(root / "mae", mae_params)
    f32 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), params)
    # optax's adamw state after seven updates: count 7, seeded moments
    rng = np.random.default_rng(2)
    opt = optax.adamw(1e-3).init(f32)
    moments = [jax.tree.map(lambda v: jnp.asarray(
        rng.standard_normal(v.shape).astype(np.float32)), f32)
        for _ in range(2)]
    opt = (opt[0]._replace(count=jnp.asarray(7, jnp.int32), mu=moments[0],
                           nu=jax.tree.map(jnp.abs, moments[1])),) + opt[1:]
    state = jax_trainer.TrainState(step=jnp.asarray(7, jnp.int32),
                                   params=params, opt_state=opt)
    jax_ckpt.save_train_state(root / "state", state)
    return root, params, mae_params, (opt[0].mu, opt[0].nu)


def test_jax_checkpoint_is_detected(ckpts, tmp_path):
    root, *_ = ckpts
    assert orbax_tree.is_orbax_dir(root / "params")
    assert not orbax_tree.is_orbax_dir(tmp_path)
    assert not orbax_tree.is_orbax_dir(root / "params" / "_METADATA")


def test_load_params_bit_equal_to_params_from_jax(ckpts):
    root, params, *_ = ckpts
    got = weights.params_from_jax(ckpt.load_params(root / "params"),
                                  device="cpu")
    _same(got, weights.params_from_jax(params, device="cpu"))
    assert got["encoder"]["projection"]["kernel"].dtype == torch.bfloat16
    assert got["encoder"]["projection"]["bias"].dtype == torch.float32


def _port_state(tree: dict, tx=None):
    """The port's fresh train state over ``tree``'s keys and shapes (fp32
    masters, zero moments)."""
    params = weights._unflatten({
        k: weights.leaf_tensor(v).float()
        for k, v in weights._flatten(jax.tree.map(np.asarray, tree)).items()})
    return trainer.create_train_state(params, tx or trainer.adamw(1e-3))


def test_train_state_gives_params_and_refuses_resume(ckpts):
    """JAX's train state gives its parameters and resumes in the port: step
    7, the moments bit for bit; it refuses to resume into a state of other
    parameters."""
    root, params, _, (jmu, jnu) = ckpts
    tree = ckpt.load_pytree(root / "state")
    assert tree["step"].shape == () and int(tree["step"]) == 7
    assert set(tree["opt_state"]) == {"0", "1", "2"}  # optax's chain tuple
    _same(weights.params_from_jax(ckpt.load_params(root / "state"),
                                  device="cpu"),
          weights.params_from_jax(params, device="cpu"))
    state = ckpt.load_train_state(root / "state", _port_state(params))
    assert state.step == 7
    _same(state.params, weights.params_from_jax(params, device="cpu",
                                                dtype=torch.float32))
    for got, want in ((state.opt_state["mu"], jmu),
                      (state.opt_state["nu"], jnu)):
        _same(got, weights.params_from_jax(jax.tree.map(np.asarray, want),
                                           device="cpu"))
    assert state.opt_state["scale"] is None
    other = dict(params, decoder={k: v for k, v in params["decoder"].items()
                                  if k != "final_norm"})
    with pytest.raises(ValueError, match="do not match the parameters"):
        ckpt.load_train_state(root / "state", trainer.create_train_state(
            weights._unflatten({k: torch.zeros(np.shape(v)) for k, v in
                                weights._flatten(other).items()}),
            trainer.adamw(1e-3)))


# the three forms of the JAX package's trainer.adamw chain
CHAINS = ("stage1", "stage2", "grpo")


def _chain_txs(form: str, jcfg, pcfg):
    """(JAX's optax chain, the port's AdamW) of one form, same constants."""
    sched = lambda s: 1e-3 * (1 + s)
    kw = dict(betas=(0.9, 0.95))
    if form == "stage1":
        return (jax_trainer.adamw(sched, weight_decay=0.05, **kw),
                trainer.adamw(sched, weight_decay=0.05, **kw))
    if form == "stage2":
        return (jax_trainer.adamw(
            sched, weight_decay=0.01, scale_tree_fn=lambda p:
            jax_trainer.encoder_llrd_scales(p, jcfg, 0.1, 0.9), **kw),
            trainer.adamw(sched, weight_decay=0.01, scale_tree_fn=lambda p:
                          trainer.encoder_llrd_scales(p, pcfg, 0.1, 0.9),
                          **kw))
    return (jax_trainer.adamw(sched, weight_decay=0.1, max_grad_norm=1.0,
                              scale_tree_fn=jax_grpo.grpo_frozen_scales, **kw),
            trainer.adamw(sched, weight_decay=0.1, max_grad_norm=1.0,
                          scale_tree_fn=grpo.grpo_frozen_scales, **kw))


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if hasattr(s, "nu"))


# a tree of the ViTOMR's top-level groups, small enough that optax's first
# eager update compiles fast: a stacked encoder leaf (2 layers, the deeper
# one tuned), its final norm and projection, the head and the decoder
CHAIN_TREE = {"encoder": {"blocks": {"kernel": (2, 6, 8), "bias": (2, 8)},
                          "final_norm": {"scale": (8,)},
                          "projection": {"kernel": (5, 8)}},
              "transition_head": {"kernel": (8, 4)},
              "decoder": {"kernel": (4, 3), "bias": (3,)}}
CHAIN_CFG = types.SimpleNamespace(
    encoder=types.SimpleNamespace(num_layers=2, fine_tune_depth=1))


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """For each chain form: JAX takes two steps on seeded gradients and
    saves its train state, then takes its third; the directory, the third
    step's gradients and JAX's state after it."""
    root = tmp_path_factory.mktemp("jax_chains")
    rng = np.random.default_rng(3)
    draw = lambda: jax.tree.map(lambda shape: jnp.asarray(
        rng.standard_normal(shape).astype(np.float32)), CHAIN_TREE,
        is_leaf=lambda v: isinstance(v, tuple))
    f32, grads = draw(), [draw() for _ in range(3)]
    out = {}
    for form in CHAINS:
        jtx, ptx = _chain_txs(form, CHAIN_CFG, CHAIN_CFG)
        p, opt = f32, jtx.init(f32)
        for i, g in enumerate(grads):
            if i == 2:
                jax_ckpt.save_train_state(root / form, jax_trainer.TrainState(
                    step=jnp.asarray(2, jnp.int32), params=p, opt_state=opt))
                saved = (p, _adam(opt))
            upd, opt = jtx.update(g, opt, p)
            p = optax.apply_updates(p, upd)
        out[form] = dict(dir=root / form, ptx=ptx, grads=grads[2],
                         saved=saved, start=f32, params=p, adam=_adam(opt))
    return out


def _np_flat(tree):
    return {k: np.asarray(v) for k, v in weights._flatten(
        jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("form", CHAINS)
def test_jax_chain_resumes_and_steps_like_jax(chains, form):
    c = chains[form]
    state = ckpt.load_train_state(c["dir"], _port_state(c["start"], c["ptx"]))
    assert state.step == 2
    saved_p, saved = c["saved"]
    for got, want in ((state.params, saved_p), (state.opt_state["mu"],
                                                saved.mu),
                      (state.opt_state["nu"], saved.nu)):
        want = _np_flat(want)
        for k, v in weights._flatten(got).items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    grads = weights._unflatten({k: torch.from_numpy(v.copy()) for k, v in
                                _np_flat(c["grads"]).items()})
    state = trainer.make_apply_fn(c["ptx"])(state, grads)
    assert state.step == 3 == int(c["adam"].count)
    want = _np_flat(c["params"])
    for k, v in weights._flatten(state.params).items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for key, jt in (("mu", c["adam"].mu), ("nu", c["adam"].nu)):
        want = _np_flat(jt)
        for k, v in weights._flatten(state.opt_state[key]).items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0,
                                       atol=1e-5 * np.abs(want[k]).max(),
                                       err_msg=f"{key} {k}")
    frozen = {"grpo": ("encoder/", "transition_head/"),
              "stage2": ("encoder/blocks/",)}.get(form, ())
    start = _np_flat(saved_p)
    for k, v in weights._flatten(state.params).items():
        if k.startswith(frozen):  # GRPO's encoder and head, layer 0 of LLRD
            rows = slice(0, 1) if form == "stage2" else slice(None)
            assert np.array_equal(v.numpy()[rows], start[k][rows]), k


def _malformed(kind: str, f32):
    """A JAX train state (step, params, opt_state) that no rule maps onto
    the port's moments. A fresh Adam count is 0: the step is 0 where the
    fault under test is not the step, 2 where it is (or where no Adam state
    holds a count)."""
    step = 2 if kind in ("no_adam", "count_off_step") else 0
    if kind == "no_adam":
        opt = optax.chain(optax.scale_by_schedule(lambda s: 1e-3)).init(f32)
    elif kind == "two_adam":
        opt = optax.chain(optax.adamw(1e-3), optax.adamw(1e-4)).init(f32)
    elif kind == "moments_off_params":
        opt = optax.adamw(1e-3).init({k: v for k, v in f32.items()
                                      if k != "decoder"})
    else:  # "count_off_step"
        opt = optax.adamw(1e-3).init(f32)
    return jax_trainer.TrainState(step=jnp.asarray(step, jnp.int32),
                                  params=f32, opt_state=opt)


@pytest.mark.parametrize("kind,match", [
    ("no_adam", r"one Adam state.*found 0"),
    ("two_adam", r"one Adam state.*found 2"),
    ("moments_off_params", r"mu do not match the parameters"),
    ("count_off_step", r"step 2 differs from the Adam count 0")])
def test_malformed_jax_chain_raises(ckpts, tmp_path, kind, match):
    _, params, *_ = ckpts
    f32 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32), params)
    jax_ckpt.save_train_state(tmp_path / kind, _malformed(kind, f32))
    with pytest.raises(ValueError, match=match):
        ckpt.load_train_state(tmp_path / kind, _port_state(params))


def test_pre_train_resumes_from_a_jax_directory(tmp_path):
    """The port's stage-1 loop carries on a JAX train state: two JAX updates
    (step 2 of 2 a epoch), then the port's second epoch from there."""
    jcfg = jax_mae.MaeConfig(encoder=jax_enc.EncoderConfig(**ENC), **MAE)
    cfg = mae.MaeConfig(encoder=vit_encoder.EncoderConfig(**ENC), **MAE)
    f32 = jax_mae.init_mae_params(jax.random.PRNGKey(1), jcfg)
    jtx = jax_trainer.adamw(lambda s: 1e-4, betas=pt.ADAMW_BETAS,
                            weight_decay=pt.ADAMW_WEIGHT_DECAY)
    opt, p = jtx.init(f32), f32
    rng = np.random.default_rng(4)
    for _ in range(2):
        g = jax.tree.map(lambda v: jnp.asarray(
            rng.standard_normal(v.shape).astype(np.float32)), f32)
        upd, opt = jtx.update(g, opt, p)
        p = optax.apply_updates(p, upd)
    jax_ckpt.save_train_state(tmp_path / "jax_state", jax_trainer.TrainState(
        step=jnp.asarray(2, jnp.int32), params=p, opt_state=opt))
    mk = lambda n, seed: ds_lib.DebugDataset(
        n=n, sizes=((64, 96), (48, 64)), kind="mae", seed=seed)
    resumed, stats = pt.pre_train(
        cfg, mk(6, 0), mk(4, 1), epochs=2, batch_size=4, warmup_epochs=1,
        checkpoint_freq=1, num_workers=2, compute_dtype=torch.float32,
        device="cpu", model_dir=tmp_path / "mae",
        resume_from=tmp_path / "jax_state")
    assert len(stats["train_losses"]) == 1
    assert all(np.isfinite(v) for v in stats["train_losses"]
               + stats["val_losses"])
    after = ckpt.load_pytree(tmp_path / "mae" / "checkpoints" / "epoch_2")
    assert int(after["step"]) == 4
    start = _np_flat(p)
    moved = [k for k, v in weights._flatten(resumed).items()
             if not np.array_equal(v.numpy(), start[k])]
    assert len(moved) == len(start)


@pytest.mark.parametrize("which", ["params", "state"])
def test_load_npz_reads_a_jax_directory(ckpts, which):
    root, params, *_ = ckpts
    got = weights.load_npz(root / which, device="cpu", dtype=torch.float32)
    _same(got, weights.params_from_jax(params, device="cpu",
                                       dtype=torch.float32))


def test_load_mae_npz_reads_a_jax_directory(ckpts):
    root, _, mae_params, _ = ckpts
    _same(weights.load_mae_npz(root / "mae", device="cpu"),
          weights.mae_params_from_jax(mae_params, device="cpu"))


@pytest.fixture
def _per_op_steps():
    """Both packages on their per-op steps; every switch restored after."""
    prev = (pallas_monolith._FORCE, pallas_monolith._INTERPRET,
            decode_kernel._ENABLED)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    decode_kernel.set_enabled(False)
    yield
    pallas_monolith.set_test_mode(*prev[:2])
    decode_kernel.set_enabled(prev[2])


def test_loaded_model_decodes_jax_tokens(ckpts, _per_op_steps):
    root, params, *_ = ckpts
    port = weights.load_npz(root / "params", device="cpu",
                            dtype=torch.float32)
    jdec = jax.tree.map(lambda v: jnp.asarray(v, jnp.float32),
                        params["decoder"])
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((B, M, DEC["hidden_dim"])).astype(np.float32)
    valid = np.arange(M)[None, :] < np.array([M, 7, M, 3])[:, None]
    kw = dict(max_len=24, initial_segment=16)
    js, jl, jm = jax_decode.generate(
        jdec, JaxDecoderConfig(**DEC), jnp.asarray(latent), jnp.asarray(valid),
        compute_dtype=jnp.float32, cache_dtype=jnp.float32, **kw)
    ps, pl, pm = decode.generate(
        port["decoder"], DecoderConfig(**DEC), torch.from_numpy(latent),
        torch.from_numpy(valid), compute_dtype=torch.float32,
        cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-4, rtol=0)


def test_port_npz_still_round_trips(tmp_path):
    tree = {"step": 3, "params": {"a": {"kernel": torch.arange(6.0)
                                        .reshape(2, 3)},
                                  "b": np.ones(4, np.int32)}}
    path = ckpt.save_pytree(tmp_path / "ck", tree)
    assert path.suffix == ".npz"
    back = ckpt.load_pytree(tmp_path / "ck")
    assert int(back["step"]) == 3
    np.testing.assert_array_equal(back["params"]["a"]["kernel"],
                                  np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(ckpt.load_params(tmp_path / "ck")["b"],
                                  np.ones(4, np.int32))


def test_missing_tensorstore_is_named(ckpts, monkeypatch):
    root, *_ = ckpts
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.load_params(root / "params")
    with pytest.raises(ImportError, match="tensorstore"):
        weights.load_npz(root / "params", device="cpu")
