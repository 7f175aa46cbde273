"""One-command reference-parity gate of the port (the twin of the JAX
package's ``tools/parity_gate.py``).

The claims that only the reference's trained artifacts can prove:

1. MAE masked-pixel MSE 0.159 on the held-out test mix,
2. teacher-forced CE 0.056,
3. token-identical greedy decode of the docs example images
   (``ballade.png``, ``liebesleid_scan.png``, ``bethena_phone.jpg``),

plus the code-level identity of :mod:`.reference_identity`. Neither the
datasets nor ``pretrained_mae.pth`` / ``vitomr.pth`` nor the reference's
sources are in the repository, so every check that misses an artifact
reports ``"skipped: <what is missing>"``; the gate exits 0 unless a check
ran and mismatched. It prints ONE JSON line with the keys ``mae_mse``,
``vitomr_ce``, ``decode``, ``code_level_identity`` and ``ok``.

Artifacts (all overridable):
    ACAI_REF_MAE_PTH     reference pretrained_mae.pth   (default ./pretrained_mae.pth)
    ACAI_REF_VITOMR_PTH  reference vitomr.pth           (default ./vitomr.pth)
    ACAI_REF_DOCS_DIR    docs example images            (default $ACAI_REFERENCE_ROOT/docs/docs_images)
    ACAI_REF_LMX_DIR     the reference's LMX decodes of those images
                         (<image-stem>.lmx) to diff against
    dataset roots        the environment variables of ``config.py``

The losses and the decode run on ``cuda`` unless ``--device cpu``; the
code-level identity is an fp32 oracle on the CPU.

Usage: ``python -m acai_omr_tpu_torch.tools.parity_gate [--fast] [--device cpu]``
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from pathlib import Path

DOCS_IMAGES = ("ballade.png", "liebesleid_scan.png", "bethena_phone.jpg")


def _dataset_roots_missing() -> list[str]:
    from .. import config

    return [name for name in ("GRAND_STAFF_ROOT_DIR",
                              "OLIMPIC_SYNTHETIC_ROOT_DIR",
                              "OLIMPIC_SCANNED_ROOT_DIR")
            if not Path(getattr(config, name)).is_dir()]


def check_loss(model: str, pth: Path, batch_size: int, device=None) -> dict:
    from .. import eval_model
    from . import verify_reference_losses as vrl

    if not pth.is_file():
        return {"status": f"skipped: {pth} not mounted"}
    missing = _dataset_roots_missing()
    if missing:
        return {"status": f"skipped: dataset roots missing "
                          f"({', '.join(missing)})"}
    params = vrl.load_params(model, str(pth), None, device)
    loss = vrl._eval_with_params(eval_model, model, params, batch_size,
                                 device=device)
    expected = vrl.EXPECTED[model]
    ok = abs(loss - expected) <= 0.005
    return {"status": "ok" if ok else "MISMATCH",
            "loss": round(loss, 6), "expected": round(expected, 6)}


def check_decode(vitomr_pth: Path, docs_dir: Path | None,
                 lmx_dir: Path | None, max_len: int, device=None) -> dict:
    """Greedy-decode the docs examples with the reference weights through
    the port; token-diff against the reference's own decodes when given."""
    if not vitomr_pth.is_file():
        return {"status": f"skipped: {vitomr_pth} not mounted"}
    if docs_dir is None:
        return {"status": "skipped: neither ACAI_REF_DOCS_DIR nor "
                          "ACAI_REFERENCE_ROOT set"}
    imgs = [docs_dir / n for n in DOCS_IMAGES if (docs_dir / n).is_file()]
    if not imgs:
        return {"status": f"skipped: no docs images under {docs_dir}"}

    from PIL import Image

    from .. import config
    from ..data import transforms as tf_lib
    from ..data.tokenizer import LmxTokenizer
    from ..inference.vitomr_inference import inference
    from ..train.omr_teacher_force_train import set_up_vitomr
    from . import verify_reference_losses as vrl

    tok = LmxTokenizer()
    cfg = set_up_vitomr(tok)
    params = vrl.load_params("vitomr", str(vitomr_pth), None, device)
    transform = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(config.PATCH_SIZE, config.OMR_MAX_IMG_SEQ_LEN,
                             config.PE_MAX_HEIGHT, config.PE_MAX_WIDTH,
                             crop_imgs=True)])
    per_image, identical = {}, []
    for path in imgs:
        img = transform(Image.open(path).convert("L"))
        seqs, _, mask = inference(params, cfg, img, max_len, device=device)
        lmx = tok.decode(seqs[0][mask[0]])
        entry = {"tokens": len(lmx.split()),
                 "sha1": hashlib.sha1(lmx.encode()).hexdigest()[:12]}
        ref = (lmx_dir / f"{path.stem}.lmx") if lmx_dir else None
        if ref and ref.is_file():
            ref_lmx, ours = ref.read_text().split(), lmx.split()
            entry["token_identical"] = ours == ref_lmx
            identical.append(entry["token_identical"])
            if not entry["token_identical"]:
                entry["first_divergence"] = next(
                    (i for i, (a, b) in enumerate(zip(ours, ref_lmx))
                     if a != b), min(len(ours), len(ref_lmx)))
        per_image[path.stem] = entry
    if not identical:
        status = ("decoded (no reference LMX mounted to diff against: set "
                  "ACAI_REF_LMX_DIR)")
    else:
        status = "ok" if all(identical) else "MISMATCH"
    return {"status": status, "images": per_image}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="reference-parity gate")
    ap.add_argument("--fast", action="store_true",
                    help="smaller eval batches / shorter decode budget")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from . import reference_identity

    batch = 16 if args.fast else 64
    max_len = 512 if args.fast else 1536
    mae_pth = Path(os.environ.get("ACAI_REF_MAE_PTH", "pretrained_mae.pth"))
    vit_pth = Path(os.environ.get("ACAI_REF_VITOMR_PTH", "vitomr.pth"))
    docs = os.environ.get("ACAI_REF_DOCS_DIR")
    if docs is None and reference_identity.REF_ROOT is not None:
        docs = reference_identity.REF_ROOT / "docs" / "docs_images"
    docs = Path(docs) if docs else None
    lmx_dir = os.environ.get("ACAI_REF_LMX_DIR")
    lmx_dir = Path(lmx_dir) if lmx_dir else None

    result = {
        "mae_mse": check_loss("mae", mae_pth, batch, args.device),
        "vitomr_ce": check_loss("vitomr", vit_pth, batch, args.device),
        "decode": check_decode(vit_pth, docs, lmx_dir, max_len, args.device),
        "code_level_identity": reference_identity.run_all(tiny=args.fast),
    }
    statuses = [v["status"] for v in result.values()]
    ran = [s for s in statuses if not s.startswith("skipped")]
    result["ok"] = (None if not ran
                    else all("MISMATCH" not in s for s in statuses))
    print(json.dumps(result))
    return 1 if result["ok"] is False else 0


if __name__ == "__main__":
    raise SystemExit(main())
