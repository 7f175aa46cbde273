"""The port's evaluation CLI (``eval_model``), its reference-loss tool
(``tools/verify_reference_losses``) and the sample dumps and plots, against
the JAX package on a fabricated GrandStaff + OLiMPiC test layout (the
reference's on-disk layouts, as tests/test_eval_harness.py writes them).

* The per-batch eval functions at fp32: ViTOMR's teacher-forced loss and
  MAE's masked-pixel loss with one mask draw handed to both sides (JAX's
  noise for its key, given to the port's ``mae_mask``) within 1e-5 of JAX's
  (fp32 sums in another order).
* The CLI at the trainers' bf16: the port's ``eval_vitomr`` on JAX's orbax
  checkpoint within 1e-2 relative of JAX's ``eval_vitomr`` on it (bf16
  keeps 8 bits: the two packages round at other places; the losses here
  are about 5.29 and read 2.3e-4 relative apart on a CPU).
* ``_eval_with_params`` on weights read from a ``.pth`` (written through
  ``vitomr_state_dict_from_params`` and ``torch.save``) equals the ``.npz``
  route bit for bit, and ``eval_vitomr``'s loss.
* ``eval_mae`` runs; ``visualize`` and ``plots`` write their files; the
  CLI's ``--help``; without a GPU every entry point raises unless given
  ``device="cpu"``.

Tiny configurations (2 layers, width 32) as tests/test_eval_harness.py.
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

from acai_omr_tpu import eval_model as jax_eval
from acai_omr_tpu.data import loader as jax_loader
from acai_omr_tpu.data.tokenizer import LmxTokenizer as JaxTokenizer
from acai_omr_tpu.models import mae as jax_mae
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.mae import MaeConfig as JaxMaeConfig
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.vit_encoder import EncoderConfig as JaxEncoderConfig
from acai_omr_tpu.models.vitomr import ViTOMRConfig as JaxViTOMRConfig
from acai_omr_tpu.train import omr_teacher_force_train as jax_tf_train
from acai_omr_tpu.train import pre_train as jax_pt
from acai_omr_tpu.utils import checkpoint as jax_ckpt

from acai_omr_tpu_torch import eval_model
from acai_omr_tpu_torch.data import loader
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.models import torch_compat, vit_encoder, weights
from acai_omr_tpu_torch.models.mae import MaeConfig
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.models.vitomr import ViTOMRConfig
from acai_omr_tpu_torch.tools import verify_reference_losses as vrl
from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train
from acai_omr_tpu_torch.train import pre_train as pt
from acai_omr_tpu_torch.utils import checkpoint as ckpt_lib

from _torch_port_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"
SAMPLE_LMX = " ".join((DATA / "sample_lmx_0.txt").read_text()
                      .replace("<eos>", "").split()[:14])
ENC = dict(patch_size=16, pe_max_height=60, pe_max_width=200, num_layers=2,
           hidden_dim=32, num_heads=4, mlp_dim=64, dropout=0.0)
DEC = dict(max_lmx_seq_len=64, num_layers=2, hidden_dim=32, num_heads=4,
           mlp_dim=64, dropout=0.0)
MAE_DEC = dict(mask_ratio=0.75, decoder_num_layers=2, decoder_hidden_dim=32,
               decoder_num_heads=4, decoder_mlp_dim=64)
ROOTS = ("GRAND_STAFF_ROOT_DIR", "OLIMPIC_SYNTHETIC_ROOT_DIR",
         "OLIMPIC_SCANNED_ROOT_DIR")


def _write_img(path: Path, rng, h=64, w=96):
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = (rng.random((h, w)) * 255).astype(np.uint8)
    Image.fromarray(arr, mode="L").save(path)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The test splits of GrandStaff (4 pieces) and synthetic / scanned
    OLiMPiC (3 scores each), every root constant of both eval modules
    pointed at them."""
    tmp = tmp_path_factory.mktemp("eval_roots")
    rng = np.random.default_rng(0)
    gs = tmp / "grandstaff-lmx"
    ids = [f"piece{i}" for i in range(4)]
    (gs / "grandstaff").mkdir(parents=True)
    (gs / "samples.test.txt").write_text("\n".join(ids) + "\n")
    for ex in ids:
        _write_img(gs / "grandstaff" / f"{ex}.jpg", rng)
        _write_img(gs / "grandstaff" / f"{ex}_distorted.jpg", rng)
        (gs / f"{ex}.lmx").write_text(SAMPLE_LMX + "\n")
    paths = {"GRAND_STAFF_ROOT_DIR": gs}
    for name in ROOTS[1:]:
        root = tmp / name.lower()
        root.mkdir()
        oids = [f"score{i}" for i in range(3)]
        (root / "samples.test.txt").write_text("\n".join(oids) + "\n")
        for ex in oids:
            _write_img(root / f"{ex}.png", rng, h=48, w=80)
            (root / f"{ex}.lmx").write_text(SAMPLE_LMX + "\n")
        paths[name] = root
    with pytest.MonkeyPatch.context() as mp:
        for name, root in paths.items():
            mp.setattr(eval_model, name, str(root))
            mp.setattr(jax_eval, name, str(root))
        yield tmp


@pytest.fixture(scope="module")
def vit(roots):
    """Tiny ViTOMR: JAX's seeded weights as an orbax checkpoint, as the
    port's .npz and as a reference .pth the port wrote."""
    jtok = JaxTokenizer()
    jcfg = JaxViTOMRConfig(JaxEncoderConfig(**ENC),
                           JaxDecoderConfig.from_tokenizer(jtok, **DEC),
                           transition_head_dim=48)
    pcfg = ViTOMRConfig(EncoderConfig(**ENC),
                        DecoderConfig.from_tokenizer(LmxTokenizer(), **DEC),
                        transition_head_dim=48)
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(0), jcfg)
    orbax = roots / "vit_orbax"
    jax_ckpt.save_pytree(orbax, jparams)
    pparams = weights.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    npz = ckpt_lib.save_pytree(roots / "vit", pparams)
    pth = roots / "vit.pth"
    torch.save({"vitomr_state_dict":
                torch_compat.vitomr_state_dict_from_params(pparams, 1)}, pth)
    return jcfg, pcfg, jparams, pparams, orbax, npz, pth


@pytest.fixture(scope="module")
def mae_setup(roots):
    jcfg = JaxMaeConfig(encoder=JaxEncoderConfig(**ENC), **MAE_DEC)
    pcfg = MaeConfig(encoder=EncoderConfig(**ENC), **MAE_DEC)
    jparams = jax_mae.init_mae_params(jax.random.PRNGKey(1), jcfg)
    pparams = weights.mae_params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    npz = ckpt_lib.save_pytree(roots / "mae", pparams)
    return jcfg, pcfg, jparams, pparams, npz


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def test_vitomr_eval_fn_matches_jax_at_fp32(vit):
    jcfg, pcfg, jparams, pparams, *_ = vit
    ds = eval_model.build_vitomr_test_sets(LmxTokenizer())
    ex = [ds[i] for i in range(len(ds))]
    batch = loader.pack_omr_batch(ex, pcfg.encoder, LmxTokenizer(),
                                  max_lmx_seq_len=64)
    jbatch = jax_loader.pack_omr_batch(ex, jcfg.encoder, JaxTokenizer(),
                                       max_lmx_seq_len=64)
    want = float(jax_tf_train.make_eval_fn(jcfg, jnp.float32)(
        jparams, _jax_batch(jbatch)))
    got = float(tf_train.make_eval_fn(pcfg, torch.float32)(
        pparams, loader.to_device(batch, "cpu")))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_mae_eval_fn_matches_jax_at_fp32(mae_setup, roots, monkeypatch):
    jcfg, pcfg, jparams, pparams, _ = mae_setup
    ds = eval_model.build_mae_test_sets()
    ex = [ds[i] for i in range(len(ds))]
    batch = loader.pack_mae_batch(ex, pcfg.encoder)
    rng = jax.random.PRNGKey(3)
    want = float(jax_pt.make_eval_fn(jcfg, jnp.float32)(
        jparams, _jax_batch(batch), rng))
    noise = torch.from_numpy(np.array(
        jax.random.uniform(rng, batch["valid"].shape)))
    inner = vit_encoder.mae_mask
    monkeypatch.setattr(vit_encoder, "mae_mask",
                        lambda *a, **kw: inner(*a, **{**kw, "noise": noise}))
    got = float(pt.make_eval_fn(pcfg, torch.float32)(
        pparams, loader.to_device(batch, "cpu"), None))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_eval_vitomr_cli_matches_jax_on_its_checkpoint(vit):
    jcfg, pcfg, *_, orbax, _, _ = vit
    want = jax_eval.eval_vitomr(str(orbax), batch_size=4, num_workers=2,
                                cfg=jcfg)
    got = eval_model.eval_vitomr(str(orbax), batch_size=4, num_workers=2,
                                 cfg=pcfg, device="cpu")
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=0)


def test_pth_route_equals_npz_route(vit):
    _, pcfg, _, _, _, npz, pth = vit
    from_pth = vrl.load_params("vitomr", str(pth), None, device="cpu")
    from_npz = vrl.load_params("vitomr", None, str(npz), device="cpu")
    for k, v in weights._flatten(from_npz).items():
        assert torch.equal(weights._flatten(from_pth)[k], v), k
    run = lambda p: vrl._eval_with_params(eval_model, "vitomr", p, 4,
                                          cfg=pcfg, num_workers=2,
                                          device="cpu")
    loss = run(from_pth)
    assert loss == run(from_npz)
    assert loss == eval_model.eval_vitomr(str(npz), batch_size=4,
                                          num_workers=2, cfg=pcfg,
                                          device="cpu")


def test_eval_mae_runs(mae_setup):
    _, pcfg, _, pparams, npz = mae_setup
    loss = eval_model.eval_mae(str(npz), batch_size=4, num_workers=2,
                               cfg=pcfg, device="cpu")
    assert np.isfinite(loss) and loss > 0
    got = vrl._eval_with_params(eval_model, "mae", pparams, 4, cfg=pcfg,
                                num_workers=2, device="cpu")
    assert np.isfinite(got) and got > 0


def test_visualize_and_plots_write_their_files(vit, mae_setup, tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    from acai_omr_tpu_torch.utils import metrics, plots, visualize
    _, pcfg, _, pparams, *_ = vit
    ds = eval_model.build_vitomr_test_sets(LmxTokenizer())
    img, lmx = ds[0][:2]
    tok = LmxTokenizer()
    loss = visualize.show_vitomr_prediction(pparams, pcfg, tok, img,
                                            tok.encode(lmx), tmp_path / "v",
                                            device="cpu")
    assert np.isfinite(loss)
    assert {p.name for p in (tmp_path / "v").iterdir()} == {
        "input_image.png", "pred.txt", "target_seq.txt"}
    _, mcfg, _, mparams, _ = mae_setup
    inp, tgt = eval_model.build_mae_test_sets()[0]
    loss = visualize.show_mae_prediction(mparams, mcfg, inp, tgt,
                                         str(tmp_path / "mae.png"),
                                         device="cpu")
    assert np.isfinite(loss) and (tmp_path / "mae.png").stat().st_size > 0

    writer = metrics.MetricsWriter(str(tmp_path / "stats.csv"))
    for step in range(3):
        writer.scalars("epoch", {"train_loss": 1.0 / (step + 1),
                                 "val_loss": 2.0 / (step + 1)}, step)
    writer.flush()
    written = plots.plot_stats_csv(tmp_path / "stats.csv", tmp_path / "plots")
    assert sorted(p.name for p in written) == ["epoch_train_loss.png",
                                               "epoch_val_loss.png"]
    plots.plot_losses(tmp_path / "stats.csv", tmp_path / "losses.png")
    plots.plot_lr_schedule(lambda s: 1e-4 * (s + 1), 10, tmp_path / "lr.png")
    assert (tmp_path / "losses.png").exists() and (tmp_path / "lr.png").exists()


def test_eval_cli_help_on_a_cpu_box():
    for mod in ("acai_omr_tpu_torch.eval_model",
                "acai_omr_tpu_torch.tools.verify_reference_losses"):
        out = subprocess.run([sys.executable, "-m", mod, "--help"], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "--device" in out.stdout


def test_entry_points_raise_without_gpu(vit, mae_setup, monkeypatch):
    _, pcfg, _, pparams, _, npz, pth = vit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: eval_model.eval_vitomr(str(npz), cfg=pcfg),
        lambda: eval_model.eval_mae(str(mae_setup[4]), cfg=mae_setup[1]),
        lambda: eval_model.dump_samples("vitomr", str(npz), "unused", 1),
        lambda: vrl.load_params("vitomr", str(pth), None),
        lambda: vrl._eval_with_params(eval_model, "vitomr", pparams, 4,
                                      cfg=pcfg),
        lambda: vrl.main(["vitomr", "--weights", str(npz)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
