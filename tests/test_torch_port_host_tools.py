"""The port's host tools against the JAX package's, on the CPU.

The linearizer and its CLI, the vocabulary writer, the dataset statistics,
the dataset preparation, the device ingest (``ops/preprocess``) and the
parity gate. Inputs: ``tests/data`` (LMX sequences, delinearized to MusicXML
by the JAX delinearizer), MusicXML written here, tiny image directories the
tests write with PIL, seeded numpy images. Tolerances: the linearizer's
strings, the vocabulary file, the statistics, the prepared images and id
files and the interpolation weights exact; the device resize within 1e-5 of
JAX's fused ingest and 2e-5 of the host pipeline (the bound of
``tests/test_preprocess_device.py``).
"""

import json
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acai_omr_tpu.lmx import delinearizer as jax_delin
from acai_omr_tpu.lmx import linearizer as jax_lin
from acai_omr_tpu.ops import preprocess as jax_pre
from acai_omr_tpu.utils import calc_dataset_stats as jax_stats
from acai_omr_tpu.utils import create_lmx_vocab_file as jax_vocab
from acai_omr_tpu.utils import prepare_data as jax_prep

from acai_omr_tpu_torch.data import transforms
from acai_omr_tpu_torch.lmx import __main__ as lmx_cli
from acai_omr_tpu_torch.lmx import delinearizer, linearizer
from acai_omr_tpu_torch.ops import patchify as patchify_lib
from acai_omr_tpu_torch.ops import preprocess
from acai_omr_tpu_torch.tools import parity_gate, reference_identity
from acai_omr_tpu_torch.utils import (calc_dataset_stats,
                                      create_lmx_vocab_file, prepare_data)

from _torch_port_threads import torch_one_thread  # noqa: F401

DATA = Path(__file__).parent / "data"
REPO = Path(__file__).resolve().parents[1]
LMX_FILES = sorted([*DATA.glob("sample_lmx_*.txt"),
                    *(DATA / "lmx_corpus").glob("*.txt")])
LMX_FILES = [p for p in LMX_FILES if p.name != "README.md"]


def _lmx(path: Path) -> str:
    return path.read_text().replace("<eos>", "").strip()


# MusicXML the corpus does not reach: out-of-vocabulary clefs and compound
# time, senza-misura, tie order, tremolo values, print-object, backups
EDGE_XML = {
    "oov_clef_compound_time": """<score-partwise><part id="P1">
      <measure number="1"><attributes><divisions>2</divisions>
        <time><beats>3+2</beats><beat-type>8</beat-type></time>
        <clef number="1"><sign>percussion</sign></clef>
        <clef number="2"><sign>F</sign><line>4</line></clef></attributes>
      <note><unpitched><display-step>C</display-step></unpitched>
        <duration>1</duration><type>eighth</type></note>
      <note><pitch><step>D</step><octave>3</octave></pitch><duration>1</duration>
        <voice>5</voice><type>eighth</type><staff>2</staff></note>
    </measure></part></score-partwise>""",
    "senza_misura_and_ties": """<score-partwise><part id="P1">
      <measure number="1"><attributes><divisions>4</divisions>
        <time><senza-misura/></time><clef><sign>G</sign></clef></attributes>
      <note print-object="no"><pitch><step>E</step><octave>5</octave></pitch>
        <duration>6</duration><tie type="stop"/><tie type="start"/>
        <voice>1</voice><type>quarter</type><dot/><accidental>sharp</accidental>
        <stem>up</stem><notations><tied type="stop"/><tied type="start"/>
        <slur type="start"/><slur type="continue"/></notations></note>
      <backup><duration>7</duration></backup>
      <note><rest measure="yes"/><duration>8</duration><voice>2</voice></note>
    </measure></part></score-partwise>""",
    "tremolo_tuplets_ornaments": """<score-partwise><part id="P1">
      <measure number="1"><attributes><divisions>3</divisions>
        <key><fifths>-3</fifths></key>
        <time><beats>2</beats><beat-type>4</beat-type></time></attributes>
      <note><grace slash="yes"/><pitch><step>B</step><octave>4</octave></pitch>
        <voice>1</voice><type>16th</type></note>
      <note><chord/><pitch><step>G</step><octave>4</octave></pitch>
        <duration>1</duration><voice>1</voice><type>eighth</type>
        <time-modification><actual-notes>3</actual-notes>
        <normal-notes>2</normal-notes></time-modification>
        <beam number="1">begin</beam><beam number="2">forward hook</beam>
        <notations><tuplet type="start"/><fermata/><arpeggiate/>
        <articulations><staccato/><tenuto/><breath-mark/></articulations>
        <ornaments><trill-mark/><tremolo type="single">3</tremolo>
        </ornaments></notations></note>
      <forward><duration>5</duration></forward>
    </measure></part></score-partwise>""",
}


@pytest.mark.parametrize("path", LMX_FILES, ids=lambda p: p.name)
def test_linearizer_matches_jax_on_tests_data(path):
    """Each sequence of tests/data, delinearized by JAX, linearizes to the
    same string in both packages."""
    root, _ = jax_delin.delinearize_to_element(_lmx(path))
    xml = ET.tostring(root, encoding="unicode")
    assert linearizer.linearize(xml) == jax_lin.linearize(xml)


@pytest.mark.parametrize("name", sorted(EDGE_XML))
def test_linearizer_matches_jax_on_edge_cases(name):
    out = linearizer.linearize(EDGE_XML[name])
    assert out == jax_lin.linearize(EDGE_XML[name])
    assert out  # something was emitted


@pytest.mark.parametrize("i", [0, 1])
def test_round_trip_through_the_port(i):
    """The port's delinearizer then its linearizer give the tokens back."""
    lmx = _lmx(DATA / f"sample_lmx_{i}.txt")
    root, errors = delinearizer.delinearize_to_element(lmx)
    assert errors == []
    assert linearizer.linearize(
        ET.tostring(root, encoding="unicode")).split() == lmx.split()


def test_cli_main(tmp_path, capsys):
    """``python -m acai_omr_tpu_torch.lmx`` through ``main(argv)``: both
    directions, files equal to JAX's linearizer, the usage exit, and the
    catastrophic exit."""
    lmx = _lmx(DATA / "sample_lmx_0.txt")
    (tmp_path / "a.lmx").write_text(lmx)
    lmx_cli.main(["delinearize", str(tmp_path / "a.lmx"),
                  str(tmp_path / "a.musicxml")])
    xml = (tmp_path / "a.musicxml").read_text()
    lmx_cli.main(["linearize", str(tmp_path / "a.musicxml"),
                  str(tmp_path / "b.lmx")])
    back = (tmp_path / "b.lmx").read_text()
    assert back == jax_lin.linearize(xml) + "\n"
    assert back.split() == lmx.split()
    with pytest.raises(SystemExit) as e:
        lmx_cli.main(["convert", "x", "y"])
    assert e.value.code == 2
    (tmp_path / "bad.lmx").write_text("")
    with pytest.raises(SystemExit) as e:
        lmx_cli.main(["delinearize", str(tmp_path / "bad.lmx"),
                      str(tmp_path / "bad.musicxml")])
    assert e.value.code == 1
    assert "delinearization failed" in capsys.readouterr().err


def test_vocab_file_equals_jax_and_the_repository_file(tmp_path):
    assert create_lmx_vocab_file.vocabulary() == jax_vocab.vocabulary()
    create_lmx_vocab_file.main(str(tmp_path / "port.txt"))
    jax_vocab.main(str(tmp_path / "jax.txt"))
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "jax.txt").read_bytes()
    assert port == (REPO / "lmx_vocab.txt").read_bytes()


def _image_dir(root: Path, seed: int = 0) -> Path:
    """A few greyscale images of ragged sizes in nested directories, one
    file that is not an image and one that only claims to be."""
    rng = np.random.default_rng(seed)
    sizes = [(64, 200), (48, 33), (130, 90), (16, 16), (77, 300)]
    for i, (h, w) in enumerate(sizes):
        d = root / f"piece{i % 2}" / ("sub" if i % 3 == 0 else "")
        d.mkdir(parents=True, exist_ok=True)
        ext = ".png" if i != 2 else ".jpg"
        Image.fromarray(rng.integers(0, 255, (h, w), dtype=np.uint8)).save(
            d / f"img{i}{ext}")
    (root / "notes.txt").write_text("not an image")
    (root / "broken.png").write_bytes(b"not a png")
    return root


def test_calc_dataset_stats_matches_jax(tmp_path, capsys):
    root = _image_dir(tmp_path / "imgs")
    for limit in (None, 3):
        ours = calc_dataset_stats.collect_stats([root], 16, limit)
        ref = jax_stats.collect_stats([root], 16, limit)
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
        assert calc_dataset_stats.summarize(ours) == jax_stats.summarize(ref)
        for nb in (2, 4):
            assert calc_dataset_stats.suggest_buckets(ours, nb, 16) \
                == jax_stats.suggest_buckets(ref, nb, 16)
    assert calc_dataset_stats.suggest_buckets(
        calc_dataset_stats.collect_stats([tmp_path / "none"]), 4) == []
    calc_dataset_stats.main([str(root), "--patch-size", "16"])
    out = capsys.readouterr().out
    summary = json.loads(out[:out.rindex("}") + 1])
    assert summary == jax_stats.summarize(jax_stats.collect_stats([root], 16))
    assert "suggested bucket boundaries:" in out


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_prepare_data_matches_jax(tmp_path, capsys):
    """PrIMuS (one system a directory, one without its png) and DoReMi
    (pages in nested directories, names that collide once joined): the
    same images, names and id files as JAX's."""
    rng = np.random.default_rng(1)
    primus = tmp_path / "primus"
    for name in ("b-002", "a-001", "c-003"):
        (primus / name).mkdir(parents=True)
        if name != "c-003":
            Image.fromarray(rng.integers(0, 255, (20, 60), dtype=np.uint8)
                            ).convert("RGB").save(primus / name / f"{name}.png")
    doremi = tmp_path / "doremi"
    for rel in ("p1/page.png", "p2/page.png", "a_b/c.png", "a/b_c.png",
                "a_b_c-1.png"):
        (doremi / rel).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (50, 40), dtype=np.uint8)
                        ).save(doremi / rel)
    for corpus, src in (("primus", primus), ("doremi", doremi)):
        fn = getattr(prepare_data, f"prepare_{corpus}")
        jfn = getattr(jax_prep, f"prepare_{corpus}")
        n = fn(src, tmp_path / f"port_{corpus}")
        assert n == jfn(src, tmp_path / f"jax_{corpus}")
        assert _tree_bytes(tmp_path / f"port_{corpus}") \
            == _tree_bytes(tmp_path / f"jax_{corpus}")
    assert (tmp_path / "port_doremi" / "ids.csv").read_text().count("\n") == 6
    prepare_data.main(["primus", str(primus), str(tmp_path / "cli")])
    assert "Prepared 2 images" in capsys.readouterr().out
    assert _tree_bytes(tmp_path / "cli") == _tree_bytes(tmp_path / "jax_primus")


PREPROCESS_SHAPES = [((64, 96), (32, 48)), ((40, 60), (64, 96)),
                     ((64, 96), (64, 96)), ((100, 37), (48, 80))]


@pytest.mark.parametrize("in_hw,out_hw", PREPROCESS_SHAPES)
def test_bicubic_axis_weights_bit_equal_to_jax(in_hw, out_hw):
    for i, o in zip(in_hw, out_hw):
        ours = preprocess.bicubic_axis_weights(i, o)
        ref = jax_pre.bicubic_axis_weights(i, o)
        assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("in_hw,out_hw", PREPROCESS_SHAPES)
def test_resize_normalize_patchify_matches_jax_and_host(in_hw, out_hw):
    rng = np.random.default_rng(sum(in_hw))
    img = rng.random((1, *in_hw), dtype=np.float32)
    p = 16
    ours = preprocess.resize_normalize_patchify(img, *out_hw, p, device="cpu")
    ref = np.asarray(jax_pre.resize_normalize_patchify(img, *out_hw, p))
    assert ours.shape == ref.shape and ours.dtype.is_floating_point
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    host = patchify_lib.patchify(
        np.clip(transforms._resize_chw(img, out_hw), 0.0, 1.0), p)
    np.testing.assert_allclose(ours.numpy(), host, atol=2e-5, rtol=0)


def test_dynamic_resize_patchify_matches_jax():
    rng = np.random.default_rng(3)
    for shape in ((1, 333, 517), (1, 517, 333), (1, 64, 64)):
        img = rng.random(shape, dtype=np.float32)
        ours, grid = preprocess.dynamic_resize_patchify(img, 16, 256, 40, 60,
                                                        device="cpu")
        ref, ref_grid = jax_pre.dynamic_resize_patchify(img, 16, 256, 40, 60)
        assert grid == ref_grid and ours.shape == ref.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)


def test_preprocess_runs_on_cuda_by_default(monkeypatch):
    """Without a card and without ``device="cpu"`` the ingest raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((1, 32, 32), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess.resize_normalize_patchify(img, 16, 16, 16)


def test_parity_gate_reports_every_check_skipped(tmp_path, monkeypatch,
                                                 capsys):
    """Nothing mounted: one JSON line with JAX's keys, every check
    ``skipped: ...``, ``ok`` null, exit 0."""
    for var, name in (("ACAI_REF_MAE_PTH", "pretrained_mae.pth"),
                      ("ACAI_REF_VITOMR_PTH", "vitomr.pth"),
                      ("ACAI_REF_DOCS_DIR", "docs")):
        monkeypatch.setenv(var, str(tmp_path / name))
    monkeypatch.setattr(reference_identity, "REF_ROOT", tmp_path / "ref")
    assert parity_gate.main(["--fast", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert list(out) == ["mae_mse", "vitomr_ce", "decode",
                         "code_level_identity", "ok"]
    assert out["ok"] is None
    assert out["mae_mse"]["status"] == \
        f"skipped: {tmp_path / 'pretrained_mae.pth'} not mounted"
    assert out["code_level_identity"]["status"] == \
        f"skipped: {tmp_path / 'ref'} not mounted"
    assert all(v["status"].startswith("skipped: ")
               for k, v in out.items() if k != "ok")
    assert reference_identity.main([]) == 1  # not mounted: not "ok"


def test_reference_root_comes_only_from_the_environment(tmp_path,
                                                        monkeypatch):
    """Without ``ACAI_REFERENCE_ROOT`` no reference is looked for (not even
    beside the checkout): the identity and the decode report why."""
    monkeypatch.delenv("ACAI_REFERENCE_ROOT", raising=False)
    assert reference_identity._ref_root() is None
    monkeypatch.setattr(reference_identity, "REF_ROOT", None)
    assert not reference_identity.available()
    assert reference_identity.run_all(tiny=True) == {
        "status": "skipped: ACAI_REFERENCE_ROOT not set"}
    pth = tmp_path / "vitomr.pth"
    pth.write_bytes(b"")
    assert parity_gate.check_decode(pth, None, None, 8, "cpu") == {
        "status": "skipped: neither ACAI_REF_DOCS_DIR nor ACAI_REFERENCE_ROOT "
                  "set"}
    monkeypatch.setenv("ACAI_REFERENCE_ROOT", str(tmp_path / "ref"))
    assert reference_identity._ref_root() == tmp_path / "ref"
