"""The scheduled-sampling loss builders take JAX's ``tf_state`` mapping, and
the port carries the JAX package's public names.

``make_loss_fn`` / ``make_sum_loss_fn`` of both packages, on a tiny ViTOMR
at fp32 with ``{"use_hard_sampling": False}`` and ``True``: both sides are
handed one Gumbel draw and one sample mask (as
tests/test_torch_port_train_model.py's scheduled-sampling test does), and
the losses and every leaf's gradient must agree (loss 1e-5 relative;
gradients atol 3e-4 x the leaf's largest entry, rtol 2e-3, that test's
tolerance). A bare bool, a mapping without the key and JAX's positional
``label_smoothing`` / ``remat`` raise. The constants are read from the JAX
package's sources with ``ast``: each name, value and ``ACAI_*`` variable
must be the port's. Last, the ``ast`` diff of public top-level names and
arguments over both packages finds nothing outside the list of what the
port leaves out on purpose (ROADMAP, Queue 1).
"""

import ast
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.vit_encoder import EncoderConfig as JaxEncoderConfig
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.parallel import trainer as jax_trainer
from acai_omr_tpu.train import omr_teacher_force_train as jax_tf

from acai_omr_tpu_torch import config
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.models import decode, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.ops import quant_linear_kernel
from acai_omr_tpu_torch.parallel import trainer
from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train

from _torch_port_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOK = LmxTokenizer()
ENC = dict(patch_size=16, pe_max_height=6, pe_max_width=8, num_layers=2,
           hidden_dim=16, num_heads=2, mlp_dim=24, dropout=0.0)
DEC = dict(max_lmx_seq_len=32, num_layers=2, hidden_dim=16, num_heads=2,
           mlp_dim=24, dropout=0.0)
B, L_IMG, T = 4, 12, 10
TF_PROB, TAU = 0.5, 2.0


@pytest.fixture(autouse=True)
def _plain_jax_stacks():
    """JAX's stacks on their plain XLA path; restored after."""
    prev = (ptl._FORCE, ptl._INTERPRET)
    ptl.set_test_mode(force=False, interpret=False)
    yield
    ptl.set_test_mode(*prev)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_vitomr.ViTOMRConfig(
        encoder=JaxEncoderConfig(**ENC),
        decoder=JaxDecoderConfig.from_tokenizer(TOK, **DEC),
        transition_head_dim=24, transition_head_dropout=0.0)
    pcfg = vitomr.ViTOMRConfig(
        encoder=EncoderConfig(**ENC),
        decoder=DecoderConfig.from_tokenizer(TOK, **DEC),
        transition_head_dim=24, transition_head_dropout=0.0)
    params = vitomr.init_vitomr_params(pcfg, seed=0, device="cpu")
    jparams = trainer.tree_unflatten({
        k: jnp.asarray(v.numpy())
        for k, v in trainer.tree_flatten(params).items()})
    rng = np.random.default_rng(0)
    lmx_valid = np.arange(T)[None, :] < rng.integers(4, T, size=(B, 1))
    targets = rng.integers(3, TOK.vocab_size, size=(B, T)).astype(np.int32)
    targets[~lmx_valid] = TOK.pad_idx
    arrays = dict(
        patches=rng.random((B, L_IMG, 256), np.float32),
        pe_idx=rng.integers(0, 48, size=(B, L_IMG, 4)).astype(np.int32),
        pe_w=rng.random((B, L_IMG, 4), np.float32),
        valid=np.ones((B, L_IMG), bool),
        inputs=rng.integers(3, TOK.vocab_size, size=(B, T)).astype(np.int32),
        targets=targets, lmx_valid=lmx_valid)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jb.update(tf_prob=jnp.float32(TF_PROB), tau=jnp.float32(TAU))
    pb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    pb.update(tf_prob=TF_PROB, tau=TAU)
    u = rng.random((B, T), dtype=np.float32)
    noise = rng.gumbel(size=(B, T, TOK.vocab_size)).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, jparams=jparams, jb=jb,
                pb=pb, u=u, noise=noise)


def _one_draw(tiny, monkeypatch):
    """Both packages' scheduled sampling on one Gumbel draw and one mask."""
    u, noise = tiny["u"], tiny["noise"]
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u))
    monkeypatch.setattr(vitomr, "sample_and_mix_seqs", functools.partial(
        vitomr.sample_and_mix_seqs, sample_mask=torch.from_numpy(u < TF_PROB),
        noise=torch.from_numpy(noise)))


def _grads_close(got: dict, want: dict):
    got = trainer.tree_flatten(got)
    want = {k: np.asarray(v) for k, v in trainer.tree_flatten(
        jax.tree.map(np.asarray, want)).items()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(got[k].numpy(), w,
                                   atol=3e-4 * max(scale, 1.0), rtol=2e-3,
                                   err_msg=k)


def _losses(tiny, monkeypatch, hard: bool, form: str):
    """(JAX's loss and gradients, the port's) of one builder."""
    _one_draw(tiny, monkeypatch)
    state = {"use_hard_sampling": hard}
    if form == "mean":
        jloss, jgrads = jax_trainer.make_grad_fn(jax_tf.make_loss_fn(
            tiny["jcfg"], state, jnp.float32))(tiny["jparams"], tiny["jb"],
                                               jax.random.PRNGKey(3))
        loss, grads = trainer.make_grad_fn(tf_train.make_loss_fn(
            tiny["pcfg"], state, torch.float32))(tiny["params"], tiny["pb"], 3)
        return (float(jloss), jgrads), (float(loss), grads)
    jfn = jax_tf.make_sum_loss_fn(tiny["jcfg"], state, jnp.float32)
    (jsum, jcount), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jfn(p, tiny["jb"], jax.random.PRNGKey(3)),
        has_aux=True))(tiny["jparams"])
    fn = tf_train.make_sum_loss_fn(tiny["pcfg"], state, torch.float32)
    loss, grads = trainer.make_grad_fn(fn)(tiny["params"], tiny["pb"], 3)
    assert int(fn(tiny["params"], tiny["pb"], 3)[1]) == int(jcount)
    return (float(jsum), jgrads), (float(loss), grads)


@pytest.mark.parametrize("form", ["mean", "sum"])
@pytest.mark.parametrize("hard", [False, True])
def test_loss_reads_tf_state_like_jax(tiny, monkeypatch, hard, form):
    (jloss, jgrads), (loss, grads) = _losses(tiny, monkeypatch, hard, form)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _grads_close(grads, jgrads)


def test_soft_and_hard_sampling_differ(tiny, monkeypatch):
    """The switch acts: the two settings give other losses on one draw (so
    the comparisons above would see a mapping read the wrong way)."""
    _one_draw(tiny, monkeypatch)
    losses = [float(tf_train.make_loss_fn(
        tiny["pcfg"], {"use_hard_sampling": h}, torch.float32)(
            tiny["params"], tiny["pb"], 3)[0]) for h in (False, True)]
    assert abs(losses[0] - losses[1]) > 1e-4, losses


@pytest.mark.parametrize("tf_state", [False, True, {}, {"hard": True}, None])
def test_tf_state_that_is_not_the_mapping_raises(tiny, tf_state):
    for build in (tf_train.make_loss_fn, tf_train.make_sum_loss_fn):
        with pytest.raises(TypeError, match="use_hard_sampling"):
            build(tiny["pcfg"], tf_state, torch.float32)


def test_jax_positional_arguments_raise(tiny):
    """JAX's order is (cfg, tf_state, compute_dtype, label_smoothing, remat,
    reduction); the port's arguments after compute_dtype are keyword-only,
    so a JAX-positional call raises instead of giving another loss."""
    cfg, state = tiny["pcfg"], {"use_hard_sampling": False}
    with pytest.raises(TypeError):
        tf_train.make_loss_fn(cfg, state, torch.float32, 0.0, "dots")
    with pytest.raises(TypeError):
        tf_train.make_loss_fn(cfg, state, torch.float32, 0.1)
    with pytest.raises(TypeError):
        tf_train.make_sum_loss_fn(cfg, state, torch.float32, 0.0, "dots")
    fn = tf_train.make_loss_fn(cfg, state, torch.float32, label_smoothing=0.1,
                               reduction="sum")
    assert callable(fn)


# ---------------------------------------------------------------------------
# the public constants
# ---------------------------------------------------------------------------

def _jax_assignments(rel: str) -> dict:
    """name -> (ACAI_* variable or None, value) of a JAX module's top-level
    assignments, read from its source."""
    tree = ast.parse((REPO / "acai_omr_tpu" / rel).read_text())
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        v = node.value
        env = isinstance(v, ast.Call) and getattr(v.func, "id", "") == \
            "_env_path"
        try:  # a default computed at import (a path under the root) is left
            out[node.targets[0].id] = (
                (ast.literal_eval(v.args[0]), ast.literal_eval(v.args[1]))
                if env else (None, ast.literal_eval(v)))
        except ValueError:
            pass
    return out


ITEM6_CONFIG = ("PRETRAINED_MAE_PATH", "INFERENCE_VITOMR_PATH",
                "DEBUG_PRETRAINED_MAE_PATH", "DEBUG_TEACHER_FORCED_PATH",
                "NUM_CHANNELS", "SEQ_BUCKET_MULTIPLE")


def _fresh_config(monkeypatch, env: dict):
    """The port's config module loaded anew under ``env`` (the imported one
    is left as it is)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "_fresh_port_config", REPO / "acai_omr_tpu_torch" / "config.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ITEM6_CONFIG)
def test_config_name_value_and_variable_match_jax(name, monkeypatch):
    want = _jax_assignments("config.py")[name]
    var, value = want
    for k in ("ACAI_PRETRAINED_MAE", "ACAI_INFERENCE_VITOMR",
              "ACAI_DEBUG_MAE", "ACAI_DEBUG_VITOMR"):
        monkeypatch.delenv(k, raising=False)
    assert getattr(_fresh_config(monkeypatch, {}), name) == value
    if var is None:
        assert getattr(config, name) == value
        return
    assert var.startswith("ACAI_")
    moved = _fresh_config(monkeypatch, {var: "/elsewhere/" + name.lower()})
    assert getattr(moved, name) == "/elsewhere/" + name.lower()


def test_stage2_and_decode_constants_match_jax():
    jax_tf_names = _jax_assignments("train/omr_teacher_force_train.py")
    for name in ("ENCODER_FINE_TUNE_DEPTH", "NUM_DECODER_LAYERS"):
        assert getattr(tf_train, name) == jax_tf_names[name][1] == 12
    assert tf_train.PRETRAINED_MAE_PATH is config.PRETRAINED_MAE_PATH
    assert tf_train.PRETRAINED_MAE_PATH == jax_tf_names["PRETRAINED_MAE_PATH"][1]
    jax_qmax = _jax_assignments("models/decode.py")["INT8_QMAX"][1]
    assert decode.INT8_QMAX == jax_qmax == 127.0
    assert decode.INT8_QMAX is quant_linear_kernel.INT8_QMAX


def test_stage2_cli_mae_default_reads_the_environment(tmp_path):
    """``ACAI_PRETRAINED_MAE`` reaches the stage-2 module's
    ``PRETRAINED_MAE_PATH``, which is its CLI's ``--mae`` default."""
    src = Path(tf_train.__file__).read_text()
    assert 'ap.add_argument("--mae", default=PRETRAINED_MAE_PATH,' in src
    env = {"ACAI_PRETRAINED_MAE": str(tmp_path / "mae_here"),
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    probe = subprocess.run(
        [sys.executable, "-c", "from acai_omr_tpu_torch.train import "
         "omr_teacher_force_train as m; print(m.PRETRAINED_MAE_PATH)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert probe.stdout.strip() == str(tmp_path / "mae_here"), probe.stderr


# ---------------------------------------------------------------------------
# the ast diff of public names and arguments
# ---------------------------------------------------------------------------

# what the port leaves out on purpose (ROADMAP, Queue 1, "Not ported, on
# purpose"): arguments by name anywhere, then names and arguments by module
ANY_ARGS = {"rng", "key", "remat", "donate"}
LEFT_OUT = {
    "models/decode.py": {"init_decode_state(scale_group)",
                         "init_beam_state(scale_group)",
                         "decode_segment(tp_axis)", "decode_segment(tp_peer)",
                         "beam_decode_segment(tp_axis)",
                         "beam_decode_segment(tp_peer)",
                         "beam_decode_segment(mem_group)"},
    "models/mae.py": {"forward(deterministic)", "forward(dropout_rng)"},
    "models/vitomr.py": {"encode_image_jit"},
    "ops/nn.py": {"masked_softmax", "MaskSpec", "combine_bias", "dropout",
                  "activation_sharding", "shard_activations",
                  "gspmd_activation_constraint_active"},
    # the plain layers are deterministic (dropout lives in the fused stacks,
    # seeded), and the stacks take validity masks and mem_kv, not biases
    "ops/transformer.py": {"stack_concat", "encoder_layer(dropout_rate)",
                           "encoder_layer(deterministic)",
                           "decoder_layer(dropout_rate)",
                           "decoder_layer(deterministic)",
                           "encoder_stack(bias)", "decoder_stack(memory)",
                           "decoder_stack(self_bias)",
                           "decoder_stack(cross_bias)"},
    "parallel/sharding.py": {"tp_decode_param_specs", "sequence_parallel"},
    "parallel/trainer.py": {"layerwise_lr_scale", "freeze_mask_zeros",
                            "key_path_names"},
    "serving/scheduler.py": {"bucketed_runner"},
    # JAX's is a thin (*args, **kwargs) wrapper around its loop
    "train/omr_teacher_force_train.py": {"omr_teacher_force_train(args)",
                                         "omr_teacher_force_train(kwargs)"},
}
LEFT_OUT_MODULES = {"ops/pallas_decode.py", "ops/pallas_monolith.py",
                    "ops/pallas_train_layer.py", "utils/fast_prng.py"}


def _public(path: Path, imports: bool = False) -> dict:
    """name -> argument names (None for a class or a constant) of a module's
    public top-level definitions; with ``imports``, the names it imports
    from other modules too (a re-export)."""
    out = {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = n.args
            out[n.name] = [x.arg for x in a.posonlyargs + a.args
                           + a.kwonlyargs] \
                + [x.arg for x in (a.vararg, a.kwarg) if x is not None]
        elif isinstance(n, ast.ClassDef):
            out[n.name] = None
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                if isinstance(t, ast.Name):
                    out[t.id] = None
        elif imports and isinstance(n, ast.ImportFrom):
            for a in n.names:
                out.setdefault(a.asname or a.name, None)
    return out


def test_public_names_diff_is_the_allow_list():
    missing = []
    for jf in sorted((REPO / "acai_omr_tpu").rglob("*.py")):
        rel = jf.relative_to(REPO / "acai_omr_tpu").as_posix()
        want = {k: v for k, v in _public(jf).items() if not k.startswith("_")}
        pf = REPO / "acai_omr_tpu_torch" / rel
        if not pf.exists():
            if rel not in LEFT_OUT_MODULES and any(
                    v is not None or k.isupper() for k, v in want.items()):
                missing.append(rel)
            continue
        got = _public(pf, imports=True)
        allowed = LEFT_OUT.get(rel, set())
        for name, args in want.items():
            if name not in got:
                if name not in allowed:
                    missing.append(f"{rel}: {name}")
                continue
            if args is None or got[name] is None:
                continue
            missing += [f"{rel}: {name}({a})" for a in args
                        if a not in got[name] and a not in ANY_ARGS
                        and a not in ("self", "cls")
                        and f"{name}({a})" not in allowed]
    assert not missing, missing
