"""The port reads the checkpoints the JAX package writes (orbax directories).

JAX's ``utils/checkpoint.save_pytree`` / ``save_train_state`` write seeded
tiny ViTOMR and MAE trees, with bf16 and fp32 leaves, into ``tmp_path``; the
port's ``utils/checkpoint`` and ``models/weights`` readers (tensorstore, no
JAX) must hand back the same leaves bit for bit, the loaded decoder must
decode JAX's greedy tokens at fp32, a JAX train state must be refused by
``load_train_state`` with a stated error, and the port's own ``.npz`` must
still round-trip. Tolerances: leaves exact; tokens exact; log-probs 2e-4
absolute (as tests/test_torch_port_decode_hd.py).
"""

import sys

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
from acai_omr_tpu.utils import checkpoint as jax_ckpt

from acai_omr_tpu_torch.models import decode, weights
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.ops import decode_kernel
from acai_omr_tpu_torch.utils import checkpoint as ckpt
from acai_omr_tpu_torch.utils import orbax_tree

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
    state = jax_trainer.TrainState(step=jnp.asarray(7, jnp.int32),
                                   params=params,
                                   opt_state=optax.adamw(1e-3).init(f32))
    jax_ckpt.save_train_state(root / "state", state)
    return root, params, mae_params


def test_jax_checkpoint_is_detected(ckpts, tmp_path):
    root, _, _ = ckpts
    assert orbax_tree.is_orbax_dir(root / "params")
    assert not orbax_tree.is_orbax_dir(tmp_path)
    assert not orbax_tree.is_orbax_dir(root / "params" / "_METADATA")


def test_load_params_bit_equal_to_params_from_jax(ckpts):
    root, params, _ = ckpts
    got = weights.params_from_jax(ckpt.load_params(root / "params"),
                                  device="cpu")
    _same(got, weights.params_from_jax(params, device="cpu"))
    assert got["encoder"]["projection"]["kernel"].dtype == torch.bfloat16
    assert got["encoder"]["projection"]["bias"].dtype == torch.float32


def test_train_state_gives_params_and_refuses_resume(ckpts):
    root, params, _ = ckpts
    tree = ckpt.load_pytree(root / "state")
    assert tree["step"].shape == () and int(tree["step"]) == 7
    assert set(tree["opt_state"]) == {"0", "1", "2"}  # optax's chain tuple
    _same(weights.params_from_jax(ckpt.load_params(root / "state"),
                                  device="cpu"),
          weights.params_from_jax(params, device="cpu"))
    with pytest.raises(ValueError, match=r"optax chain.*load_params"):
        ckpt.load_train_state(root / "state", like_state=None)


@pytest.mark.parametrize("which", ["params", "state"])
def test_load_npz_reads_a_jax_directory(ckpts, which):
    root, params, _ = ckpts
    got = weights.load_npz(root / which, device="cpu", dtype=torch.float32)
    _same(got, weights.params_from_jax(params, device="cpu",
                                       dtype=torch.float32))


def test_load_mae_npz_reads_a_jax_directory(ckpts):
    root, _, mae_params = ckpts
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
    root, params, _ = ckpts
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
    root, _, _ = ckpts
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.load_params(root / "params")
    with pytest.raises(ImportError, match="tensorstore"):
        weights.load_npz(root / "params", device="cpu")
