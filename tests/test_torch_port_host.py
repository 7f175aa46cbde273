"""The port's host-side copies, its weight bridge and its isolation from JAX.

* The tokenizer, delinearizer and transform copies agree with the JAX
  package's on the repo's LMX fixtures and on seeded synthetic images.
* ``params_from_jax`` covers every leaf of the JAX tree; a missing or an
  extra key raises.
* Importing every module of ``acai_omr_tpu_torch`` leaves ``jax`` and
  ``acai_omr_tpu`` out of ``sys.modules``; no file of the package or
  ``chip_smoke.py`` imports them.
* Entry points raise without a GPU unless the caller asks for the CPU.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from acai_omr_tpu.data import transforms as jax_tf
from acai_omr_tpu.data.tokenizer import LmxTokenizer as JaxTokenizer
from acai_omr_tpu.lmx import delinearizer as jax_delin
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.ops import pe as jax_pe

from acai_omr_tpu_torch import resolve_device
from acai_omr_tpu_torch.data import transforms as tf
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.lmx import delinearizer as delin
from acai_omr_tpu_torch.models import vitomr, weights
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.ops import pe

from _torch_port_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "acai_omr_tpu_torch"
FIXTURES = sorted((REPO / "tests" / "data").glob("sample_lmx_*.txt")) \
    + sorted((REPO / "tests" / "data" / "lmx_corpus").glob("*.txt"))

TINY_ENC = dict(pe_max_height=4, pe_max_width=6, num_layers=1, hidden_dim=32,
                num_heads=2, mlp_dim=64)
TINY_DEC = dict(vocab_size=20, num_layers=1, hidden_dim=32, num_heads=2,
                mlp_dim=64, max_lmx_seq_len=16)


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_tokenizer_and_delinearizer_match_jax(path):
    lmx = path.read_text().strip()
    jtok, ptok = JaxTokenizer(), LmxTokenizer()
    known = " ".join(t for t in lmx.split() if t in ptok.tokens_to_idxs)
    ids = ptok.encode(known)
    np.testing.assert_array_equal(ids, jtok.encode(known))
    assert ptok.decode(ids) == jtok.decode(ids) == known
    try:
        want = jax_delin.delinearize(lmx)
    except jax_delin.DelinearizationError as e:
        with pytest.raises(delin.DelinearizationError, match=str(e)[:40]):
            delin.delinearize(lmx)
        return
    assert delin.delinearize(lmx) == want


@pytest.mark.parametrize("hw", [(90, 1200), (640, 480), (1700, 1000),
                                (150, 300)])
def test_transform_matches_jax(hw):
    rng = np.random.default_rng(hw[0])
    img = (rng.random(hw) * 255).astype(np.uint8)
    for crop in (False, True):
        args = (16, 1024, 60, 200, crop)
        np.testing.assert_array_equal(
            tf.DynamicResize(*args)(img), jax_tf.DynamicResize(*args)(img))


@pytest.mark.parametrize("hw", [(3, 5), (9, 4), (60, 200), (70, 210)])
def test_pe_indices_and_gather_match_jax(hw):
    idx, w = pe.pe_indices(*hw, 60, 200)
    jidx, jw = jax_pe.pe_indices(*hw, 60, 200)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w, jw)
    grid = np.random.default_rng(0).standard_normal((60, 200, 8)) \
        .astype(np.float32)
    got = pe.gather_pe(torch.from_numpy(grid), torch.from_numpy(idx),
                       torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_pe.gather_pe(grid, idx, w)), atol=1e-6)


def _jax_tree():
    cfg = jax_vitomr.ViTOMRConfig(jax_enc.EncoderConfig(**TINY_ENC),
                                  JaxDecoderConfig(**TINY_DEC),
                                  transition_head_dim=48)
    return jax.tree.map(np.asarray, jax_vitomr.init_vitomr_params(
        jax.random.PRNGKey(0), cfg))


def test_params_from_jax_covers_every_leaf():
    tree = _jax_tree()
    port = weights.params_from_jax(tree, device="cpu")
    flat_j, flat_p = weights._flatten(tree), weights._flatten(port)
    assert flat_j.keys() == flat_p.keys() == weights._paths(weights.TEMPLATE)
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_p[k].numpy(), v)
    # the port's own init builds the same tree, shapes included
    pcfg = vitomr.ViTOMRConfig(EncoderConfig(**TINY_ENC),
                               DecoderConfig(**TINY_DEC),
                               transition_head_dim=48)
    mine = weights._flatten(vitomr.init_vitomr_params(pcfg, 0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in flat_j.items()}


@pytest.mark.parametrize("edit", ["missing", "extra"])
def test_params_from_jax_is_strict(edit):
    tree = _jax_tree()
    if edit == "missing":
        del tree["decoder"]["blocks"]["norm3"]["scale"]
    else:
        tree["encoder"]["blocks"]["cls_token"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match=edit):
        weights.params_from_jax(tree, device="cpu")


def test_npz_round_trip(tmp_path):
    tree = _jax_tree()
    weights.save_npz(tmp_path / "w.npz", tree)
    back = weights._flatten(weights.load_npz(tmp_path / "w.npz", device="cpu"))
    for k, v in weights._flatten(tree).items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_package_imports_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import acai_omr_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'acai_omr_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps([len(mods), sorted(k for k in sys.modules "
        "if k == 'jax' or k.startswith(('jax.', 'acai_omr_tpu.')) "
        "or k == 'acai_omr_tpu')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    n_mods, leaked = json.loads(out.stdout.strip().splitlines()[-1])
    assert n_mods >= 20
    assert leaked == []


def test_no_source_mentions_jax_package():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) \
        + [REPO / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert "from jax" not in text, f
        assert "acai_omr_tpu." not in text, f


def test_flagship_config_matches_jax():
    import dataclasses
    from acai_omr_tpu.train.omr_teacher_force_train import set_up_vitomr
    from acai_omr_tpu_torch.inference.vitomr_inference import flagship_config
    want = dataclasses.asdict(set_up_vitomr(JaxTokenizer()))
    assert dataclasses.asdict(flagship_config(LmxTokenizer())) == want


def test_entry_points_raise_without_gpu(monkeypatch):
    from acai_omr_tpu_torch.api import OmrModel
    from acai_omr_tpu_torch.inference import batch_inference as bi
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = vitomr.ViTOMRConfig(EncoderConfig(**TINY_ENC),
                               DecoderConfig(**TINY_DEC),
                               transition_head_dim=48)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OmrModel.load()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vitomr.init_vitomr_params(pcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        weights.params_from_jax(_jax_tree())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bi.batch_inference({}, pcfg, [], LmxTokenizer())
    assert resolve_device("cpu") == torch.device("cpu")
