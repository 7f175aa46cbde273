"""The port's ``models/torch_compat`` against the JAX package's, on the CPU.

The state dicts the JAX writers make from seeded tiny ViTOMR (both encoder
layouts: plain ``encoder_blocks`` and FineTuneOMREncoder's
``frozen_blocks`` / ``fine_tune_blocks``) and MAE trees, read by the port's
readers, must equal ``weights.params_from_jax`` of the same trees exactly;
the port's writers must give JAX's state dicts key for key, bit for bit;
round trips through the port's writers and readers are exact, for torch
tensors and numpy arrays, fp32 and bf16 (``ml_dtypes``) leaves. Tiny
configurations of ``tools/reference_identity.make_cfg(tiny=True)``; every
comparison is exact (no arithmetic happens, only transposes, stacks and
copies).
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from acai_omr_tpu.models import mae as jax_mae
from acai_omr_tpu.models import torch_compat as jax_compat
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.mae import MaeConfig
from tools.reference_identity import make_cfg

from acai_omr_tpu_torch.models import torch_compat, weights
from acai_omr_tpu_torch.models.weights import _flatten

from _torch_port_threads import torch_one_thread  # noqa: F401

DEPTHS = [None, 1, 2]  # plain layout; FineTune with 1 of 2 / both layers


@pytest.fixture(scope="module")
def trees():
    """Seeded JAX ViTOMR and MAE trees as numpy arrays (fp32)."""
    cfg = make_cfg(tiny=True)
    vit = jax.tree.map(np.asarray, jax_vitomr.init_vitomr_params(
        jax.random.PRNGKey(0), cfg))
    mcfg = MaeConfig(encoder=cfg.encoder, mask_ratio=0.75,
                     decoder_num_layers=2, decoder_hidden_dim=32,
                     decoder_num_heads=4, decoder_mlp_dim=64)
    mae = jax.tree.map(np.asarray, jax_mae.init_mae_params(
        jax.random.PRNGKey(1), mcfg))
    return vit, mae


def _assert_trees_equal(got: dict, want: dict):
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


def _assert_sd_equal(got: dict, want: dict):
    """A port state dict (tensors) against JAX's (numpy), bit for bit."""
    assert list(got) == list(want)
    for k, v in want.items():
        g = got[k]
        assert torch.is_tensor(g) and g.is_contiguous(), k
        assert g.dtype == torch.float32 and tuple(g.shape) == v.shape, k
        np.testing.assert_array_equal(g.numpy(), v, err_msg=k)


@pytest.mark.parametrize("depth", DEPTHS)
def test_vitomr_reader_of_jax_state_dict_equals_params_from_jax(trees, depth):
    vit, _ = trees
    sd = jax_compat.vitomr_state_dict_from_params(vit, fine_tune_depth=depth)
    got = torch_compat.vitomr_params_from_torch(sd, device="cpu")
    _assert_trees_equal(got, weights.params_from_jax(vit, device="cpu"))
    # the same state dict as torch tensors, as torch.load gives it
    got_t = torch_compat.vitomr_params_from_torch(
        {k: torch.tensor(v) for k, v in sd.items()}, device="cpu")
    _assert_trees_equal(got_t, weights.params_from_jax(vit, device="cpu"))


def test_mae_reader_of_jax_state_dict_equals_params_from_jax(trees):
    _, mae = trees
    sd = jax_compat.mae_state_dict_from_params(mae)
    got = torch_compat.mae_params_from_torch(sd, device="cpu")
    _assert_trees_equal(got, weights.mae_params_from_jax(mae, device="cpu"))


def test_part_readers_equal_jax(trees):
    vit, _ = trees
    enc_sd = jax_compat.encoder_state_dict_from_params(vit["encoder"], "e.", 1)
    want = jax.tree.map(np.asarray,
                        jax_compat.encoder_params_from_torch(enc_sd, "e."))
    _assert_trees_equal(
        torch_compat.encoder_params_from_torch(enc_sd, "e.", device="cpu"),
        weights.params_from_jax(want, "cpu",
                                template=weights.TEMPLATE["encoder"]))
    dec_sd = jax_compat.omr_decoder_state_dict_from_params(vit["decoder"])
    want = jax.tree.map(np.asarray,
                        jax_compat.omr_decoder_params_from_torch(dec_sd))
    _assert_trees_equal(
        torch_compat.omr_decoder_params_from_torch(dec_sd, device="cpu"),
        weights.params_from_jax(want, "cpu",
                                template=weights.TEMPLATE["decoder"]))


@pytest.mark.parametrize("depth", DEPTHS)
def test_vitomr_writer_equals_jax(trees, depth):
    vit, _ = trees
    port = weights.params_from_jax(vit, device="cpu")
    _assert_sd_equal(
        torch_compat.vitomr_state_dict_from_params(port, fine_tune_depth=depth),
        jax_compat.vitomr_state_dict_from_params(vit, fine_tune_depth=depth))
    # numpy leaves in, the same state dict out
    _assert_sd_equal(
        torch_compat.vitomr_state_dict_from_params(vit, fine_tune_depth=depth),
        jax_compat.vitomr_state_dict_from_params(vit, fine_tune_depth=depth))


def test_mae_and_part_writers_equal_jax(trees):
    vit, mae = trees
    _assert_sd_equal(torch_compat.mae_state_dict_from_params(
        weights.mae_params_from_jax(mae, device="cpu")),
        jax_compat.mae_state_dict_from_params(mae))
    _assert_sd_equal(
        torch_compat.encoder_state_dict_from_params(vit["encoder"], "x.", 2),
        jax_compat.encoder_state_dict_from_params(vit["encoder"], "x.", 2))
    _assert_sd_equal(
        torch_compat.omr_decoder_state_dict_from_params(vit["decoder"], "d."),
        jax_compat.omr_decoder_state_dict_from_params(vit["decoder"], "d."))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", DEPTHS)
def test_round_trip_is_exact(trees, dtype, depth):
    """Writer then reader gives every leaf back, dtype and bits; the state
    dict's tensors own their storage (no view of a stacked leaf)."""
    vit, mae = trees
    port = weights.params_from_jax(vit, device="cpu", dtype=dtype)
    sd = torch_compat.vitomr_state_dict_from_params(port, depth)
    assert all(v.dtype == dtype for v in sd.values())
    assert len({v.untyped_storage().data_ptr() for v in sd.values()}) \
        == len(sd)
    _assert_trees_equal(
        torch_compat.vitomr_params_from_torch(sd, device="cpu"), port)
    mport = weights.mae_params_from_jax(mae, device="cpu", dtype=dtype)
    _assert_trees_equal(torch_compat.mae_params_from_torch(
        torch_compat.mae_state_dict_from_params(mport), device="cpu"), mport)


def test_bf16_numpy_state_dict_carries_over_bit_for_bit(trees):
    """A state dict of ml_dtypes bf16 arrays reads as bf16 tensors of the
    same 16-bit patterns."""
    vit, _ = trees
    sd = {k: v.astype(ml_dtypes.bfloat16) for k, v in
          jax_compat.vitomr_state_dict_from_params(vit).items()}
    got = _flatten(torch_compat.vitomr_params_from_torch(sd, device="cpu"))
    want = _flatten(weights.params_from_jax(
        jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), vit),
        device="cpu"))
    for k, v in want.items():
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), v.view(torch.int16)), k


def test_readers_are_strict_and_default_to_cuda(trees, monkeypatch):
    vit, _ = trees
    sd = jax_compat.vitomr_state_dict_from_params(vit)
    with pytest.raises(KeyError, match="decoder.unembed.bias"):
        torch_compat.vitomr_params_from_torch(
            {k: v for k, v in sd.items() if k != "decoder.unembed.bias"},
            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_compat.vitomr_params_from_torch(sd)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_compat.mae_params_from_torch(
            jax_compat.mae_state_dict_from_params(trees[1]))
