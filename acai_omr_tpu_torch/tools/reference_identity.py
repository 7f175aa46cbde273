"""Code-level identity of the port against the reference implementation.

The twin of the JAX package's ``tools/reference_identity.py``: the port's
flagship-configuration parameters (or a structurally identical tiny one) go
into the reference's own torch modules through the port's
:mod:`..models.torch_compat` (``strict=True``), both run end to end, and

1. greedy decode: the reference's ``ViTOMR.cached_greedy_generate`` against
   the port's ``decode.generate(pe_offset=1)`` on a ragged synthetic batch:
   identical tokens and masks, average log-probs within 1e-3;
2. teacher-forced CE (plain and label-smoothed 0.1): the reference's
   ``ViTOMR.forward`` + ``OMRCELoss`` against the port's
   ``forward_teacher_forced`` + ``omr_ce_loss``, within 1e-4;
3. MAE loss: ``MAE.forward`` + ``MAELoss`` against the port's ``mae.forward``
   + ``mae_loss``, both driven by one shuffle noise (the reference's
   ``torch.rand`` replays it), within 1e-4;
4. the state-dict round trip params -> state dict -> params, exact.

Both sides run at fp32 on the CPU (the oracle setting of the JAX tool). The
reference's sources are read from ``ACAI_REFERENCE_ROOT`` alone (nothing
outside the checkout is looked for otherwise); without it, or without the
sources there, every check reports ``skipped``.

Usage: ``python -m acai_omr_tpu_torch.tools.reference_identity [--tiny]``
(one JSON line).
"""

from __future__ import annotations

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import torch


def _ref_root() -> Path | None:
    """The reference checkout named by ``ACAI_REFERENCE_ROOT``, else None."""
    root = os.environ.get("ACAI_REFERENCE_ROOT")
    return Path(root) if root else None


REF_ROOT = _ref_root()
CPU = torch.device("cpu")


def available() -> bool:
    return REF_ROOT is not None and \
        (REF_ROOT / "acai_omr" / "models" / "models.py").is_file()


def missing() -> str:
    """Why :func:`available` is false."""
    if REF_ROOT is None:
        return "ACAI_REFERENCE_ROOT not set"
    return f"{REF_ROOT} not mounted"


_ref_cache = {}


def import_reference():
    """The reference's model module (flask, which its package imports for
    the web app, stubbed when absent)."""
    if "models" in _ref_cache:
        return _ref_cache["models"]
    if "flask" not in sys.modules:
        flask_stub = types.ModuleType("flask")
        flask_stub.Flask = object
        sys.modules["flask"] = flask_stub
    if str(REF_ROOT) not in sys.path:
        sys.path.insert(0, str(REF_ROOT))
    import acai_omr.models.models as ref_models
    _ref_cache["models"] = ref_models
    return ref_models


def make_cfg(tiny: bool):
    """The flagship ViTOMR configuration, or a tiny one of the same
    structure."""
    from ..models.omr_decoder import DecoderConfig
    from ..models.vit_encoder import EncoderConfig
    from ..models.vitomr import ViTOMRConfig
    from ..train.omr_teacher_force_train import set_up_vitomr

    if not tiny:
        return set_up_vitomr()
    return ViTOMRConfig(
        encoder=EncoderConfig(patch_size=16, pe_max_height=12, pe_max_width=24,
                              num_layers=2, hidden_dim=32, num_heads=4,
                              mlp_dim=64, dropout=0.0, fine_tune_depth=2),
        decoder=DecoderConfig(max_lmx_seq_len=64, num_layers=2, hidden_dim=32,
                              num_heads=4, mlp_dim=64, dropout=0.0),
        transition_head_dim=48)


def build_reference_vitomr(cfg, max_batch_size: int, use_caching: bool = True):
    """The reference's ``TeacherForcedViTOMR`` at ``cfg``'s dimensions."""
    from ..config import LMX_VOCAB_PATH

    ref = import_reference()
    ec, dc = cfg.encoder, cfg.decoder
    encoder = ref.FineTuneOMREncoder(
        ec.patch_size, ec.pe_max_height, ec.pe_max_width,
        fine_tune_depth=ec.fine_tune_depth or ec.num_layers,
        num_layers=ec.num_layers, hidden_dim=ec.hidden_dim,
        num_heads=ec.num_heads, mlp_dim=ec.mlp_dim, transformer_dropout=0.0)
    decoder = ref.OMRDecoder(
        dc.max_lmx_seq_len, str(LMX_VOCAB_PATH), num_layers=dc.num_layers,
        hidden_dim=dc.hidden_dim, num_heads=dc.num_heads, mlp_dim=dc.mlp_dim,
        transformer_dropout=0.0, use_caching=use_caching,
        max_batch_size=max_batch_size,
        cache_dtype=torch.float32 if use_caching else None)
    return ref.TeacherForcedViTOMR(
        encoder, None, decoder, transition_head_dim=cfg.transition_head_dim,
        transition_head_dropout=0.0)


def load_params_into_reference(model, params, cfg):
    from ..models import torch_compat

    ec = cfg.encoder
    sd = torch_compat.vitomr_state_dict_from_params(
        params, ec.fine_tune_depth or ec.num_layers)
    model.load_state_dict(sd, strict=True)
    model.eval()


def _synthetic_images(cfg, seed: int, tiny: bool):
    rng = np.random.default_rng(seed)
    p = cfg.encoder.patch_size
    shapes = ([(2 * p, 5 * p), (1 * p, 3 * p), (3 * p, 2 * p)] if tiny
              else [(4 * p, 7 * p), (3 * p, 4 * p), (2 * p, 6 * p)])
    return [rng.random((1, h, w), dtype=np.float32) for (h, w) in shapes]


def check_greedy_identity(tiny: bool = False, seed: int = 0,
                          max_len: int = 32) -> dict:
    from ..models import decode as decode_lib
    from ..models import vit_encoder, vitomr

    cfg = make_cfg(tiny)
    params = vitomr.init_vitomr_params(cfg, seed=seed, device=CPU)
    imgs = _synthetic_images(cfg, seed + 1, tiny)
    b = len(imgs)
    with torch.no_grad():
        pb = vit_encoder.batchify(imgs, cfg.encoder, bucket_multiple=8)
        latent, latent_valid = vitomr.encode_image(
            params, cfg, *pb.to(CPU), compute_dtype=torch.float32)
        seqs, lps, mask = decode_lib.generate(
            params["decoder"], cfg.decoder, latent, latent_valid,
            max_len=max_len, initial_segment=max_len,
            compute_dtype=torch.float32, cache_dtype=torch.float32,
            pe_offset=1)
        model = build_reference_vitomr(cfg, max_batch_size=b)
        load_params_into_reference(model, params, cfg)
        t_lat, t_pad = model.encoder([torch.from_numpy(i) for i in imgs])
        t_lat = model.transition_head(t_lat)
        r_seqs, r_lps, r_mask = model.cached_greedy_generate(
            t_lat, t_pad, max_len=max_len)
    seqs, lps, mask = (a.numpy() for a in (seqs, lps, mask))
    r_seqs, r_lps, r_mask = (a.numpy() for a in (r_seqs, r_lps, r_mask))

    rows, identical, max_lp_diff = [], True, 0.0
    for i in range(b):
        n_ref, n_ours = int(r_mask[i].sum()), int(mask[i].sum())
        toks_ref = r_seqs[i][r_mask[i]].tolist()
        toks_ours = seqs[i][mask[i]].tolist()
        same = toks_ref == toks_ours
        identical &= same and n_ref == n_ours
        alp_ref = float(r_lps[i][r_mask[i]].sum() / max(n_ref - 1, 1))
        alp_ours = float(lps[i][mask[i]].sum() / max(n_ours - 1, 1))
        max_lp_diff = max(max_lp_diff, abs(alp_ref - alp_ours))
        row = {"len": n_ref, "identical": same}
        if not same:
            row["first_divergence"] = next(
                (j for j, (a, c) in enumerate(zip(toks_ref, toks_ours))
                 if a != c), min(n_ref, n_ours))
        rows.append(row)
    return {"status": "ok" if identical and max_lp_diff < 1e-3
            else "MISMATCH", "identical_tokens": identical,
            "max_avg_log_prob_diff": round(max_lp_diff, 8), "rows": rows}


def check_ce_loss(tiny: bool = False, seed: int = 0,
                  label_smoothing: float = 0.0) -> dict:
    from ..models import vit_encoder, vitomr

    cfg = make_cfg(tiny)
    params = vitomr.init_vitomr_params(cfg, seed=seed, device=CPU)
    imgs = _synthetic_images(cfg, seed + 2, tiny)
    b, dc = len(imgs), cfg.decoder
    rng = np.random.default_rng(seed + 3)
    seqs = [np.concatenate([[dc.bos_idx],
                            rng.integers(3, dc.vocab_size, size=n),
                            [dc.eos_idx]]).astype(np.int64)
            for n in (9, 6, 4)]
    ref = import_reference()
    model = build_reference_vitomr(cfg, max_batch_size=b, use_caching=False)
    load_params_into_reference(model, params, cfg)
    t_max = max(len(s) for s in seqs)
    padded = np.full((b, t_max), dc.pad_idx, dtype=np.int64)
    for i, s in enumerate(seqs):
        padded[i, :len(s)] = s
    inputs, targets = padded[:, :-1], padded[:, 1:]
    with torch.no_grad():
        pred, target = model([(torch.from_numpy(i), torch.from_numpy(s))
                              for i, s in zip(imgs, seqs)])
        ref_loss = float(ref.OMRCELoss(dc.pad_idx, label_smoothing)(pred,
                                                                    target))
        pb = vit_encoder.batchify(imgs, cfg.encoder, bucket_multiple=8)
        logits = vitomr.forward_teacher_forced(
            params, cfg, *pb.to(CPU), torch.from_numpy(inputs),
            torch.from_numpy(inputs != dc.pad_idx),
            compute_dtype=torch.float32)
        our_loss = float(vitomr.omr_ce_loss(logits, torch.from_numpy(targets),
                                            dc.pad_idx, label_smoothing))
    diff = abs(ref_loss - our_loss)
    return {"status": "ok" if diff < 1e-4 else "MISMATCH",
            "ref_loss": round(ref_loss, 8), "our_loss": round(our_loss, 8),
            "abs_diff": round(diff, 9)}


def check_mae_loss(tiny: bool = False, seed: int = 0) -> dict:
    from ..models import mae as mae_lib
    from ..models import torch_compat, vit_encoder
    from ..models.mae import MaeConfig
    from ..models.vit_encoder import EncoderConfig

    if tiny:
        cfg = MaeConfig(
            encoder=EncoderConfig(patch_size=16, pe_max_height=12,
                                  pe_max_width=24, num_layers=2, hidden_dim=32,
                                  num_heads=4, mlp_dim=64),
            mask_ratio=0.75, decoder_num_layers=2, decoder_hidden_dim=24,
            decoder_num_heads=4, decoder_mlp_dim=48)
    else:
        from ..train.pre_train import set_up_mae
        cfg = set_up_mae()
    params = mae_lib.init_mae_params(cfg, seed=seed, device=CPU)
    ec, p = cfg.encoder, cfg.encoder.patch_size
    rng = np.random.default_rng(seed + 4)
    shapes = ([(2 * p, 5 * p), (3 * p, 3 * p)] if tiny
              else [(4 * p, 6 * p), (3 * p, 5 * p)])
    imgs = [rng.random((1, h, w), dtype=np.float32) for (h, w) in shapes]
    pb = vit_encoder.batchify(imgs, ec, bucket_multiple=8)
    noise = rng.random((len(imgs), pb.patches.shape[1]), dtype=np.float32)
    with torch.no_grad():
        patches = torch.from_numpy(pb.patches)
        pred, loss_mask, target = mae_lib.forward(
            params, cfg, patches, *(torch.from_numpy(a) for a in
                                    (pb.pe_idx, pb.pe_w, pb.valid,
                                     pb.lengths)),
            patches, mask_noise=torch.from_numpy(noise),
            compute_dtype=torch.float32)
        our_loss = float(mae_lib.mae_loss(pred, loss_mask, target))

    ref = import_reference()
    model = ref.MAE(cfg.mask_ratio, p, ec.pe_max_height, ec.pe_max_width,
                    encoder_hidden_dim=ec.hidden_dim,
                    decoder_hidden_dim=cfg.decoder_hidden_dim,
                    encoder_kwargs={"num_layers": ec.num_layers,
                                    "num_heads": ec.num_heads,
                                    "mlp_dim": ec.mlp_dim},
                    decoder_kwargs={"num_layers": cfg.decoder_num_layers,
                                    "num_heads": cfg.decoder_num_heads,
                                    "mlp_dim": cfg.decoder_mlp_dim})
    model.load_state_dict(torch_compat.mae_state_dict_from_params(params),
                          strict=True)
    model.eval()
    # the reference draws one torch.rand row per image (mask_sequence):
    # replay the noise the port's mask used
    rows = [torch.from_numpy(noise[i, :int(pb.lengths[i])].copy())
            for i in range(len(imgs))]
    real_rand, drawn = torch.rand, []

    def replay(*size, **kwargs):
        n = size[0] if size else kwargs.get("size")
        row = rows[len(drawn)]
        assert n == row.shape[0], (n, row.shape)
        drawn.append(n)
        return row.clone()

    torch.rand = replay
    try:
        with torch.no_grad():
            batch = [(torch.from_numpy(i), torch.from_numpy(i)) for i in imgs]
            r_pred, r_mask, r_target = model(batch)
            ref_loss = float(ref.MAELoss()(r_pred, r_mask, r_target))
    finally:
        torch.rand = real_rand
    assert len(drawn) == len(imgs)
    diff = abs(ref_loss - our_loss)
    return {"status": "ok" if diff < 1e-4 else "MISMATCH",
            "ref_loss": round(ref_loss, 8), "our_loss": round(our_loss, 8),
            "abs_diff": round(diff, 9)}


def check_roundtrip(tiny: bool = True, seed: int = 0) -> dict:
    from ..models import torch_compat, vitomr
    from ..parallel.trainer import tree_flatten

    cfg = make_cfg(tiny)
    params = vitomr.init_vitomr_params(cfg, seed=seed, device=CPU)
    sd = torch_compat.vitomr_state_dict_from_params(
        params, cfg.encoder.fine_tune_depth)
    back = tree_flatten(torch_compat.vitomr_params_from_torch(sd, CPU))
    max_diff = 0.0
    for path, leaf in tree_flatten(params).items():
        other = back[path]
        assert leaf.shape == other.shape, path
        max_diff = max(max_diff, float((leaf.double() - other.double()
                                        ).abs().max()))
    return {"status": "ok" if max_diff == 0.0 else "MISMATCH",
            "max_abs_diff": max_diff, "num_keys": len(sd)}


def run_all(tiny: bool = False) -> dict:
    if not available():
        return {"status": f"skipped: {missing()}"}
    result = {
        "greedy_token_identity": check_greedy_identity(tiny),
        "teacher_forced_ce": check_ce_loss(tiny),
        "teacher_forced_ce_smoothed": check_ce_loss(tiny, label_smoothing=0.1),
        "mae_loss": check_mae_loss(tiny),
        "state_dict_roundtrip": check_roundtrip(tiny),
    }
    result["status"] = ("ok" if all(v["status"] == "ok"
                                    for v in result.values()) else "MISMATCH")
    result["config"] = "tiny" if tiny else "flagship"
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="code-level identity against "
                                             "the reference")
    ap.add_argument("--tiny", action="store_true")
    out = run_all(tiny=ap.parse_args(argv).tiny)
    print(json.dumps(out))
    return 0 if out["status"] == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
