"""Evaluation CLI: test-set loss and sample prediction dumps.

    python -m acai_omr_tpu_torch.eval_model {mae|vitomr} WEIGHTS [-b N]
        [-d DIR -p N] [--device cuda|cpu]

The twin of the JAX package's ``eval_model.py`` (reference:
acai_omr/models/eval_model.py:18-166): the average test loss over the
held-out mix (MAE: the normalised masked-pixel MSE; ViTOMR: the
teacher-forced cross entropy), through both trainers' ``make_eval_fn``,
the bucket sampler and the prefetch loader, and optional sample dumps.
``WEIGHTS`` is a parameter tree or train state the port wrote (``.npz``) or
a checkpoint directory the JAX package wrote (orbax). Runs on ``cuda``
unless ``--device cpu`` / ``device="cpu"`` is given. The dataset roots are
this module's constants (``config.py``, overridable by environment
variables).
"""

from __future__ import annotations

import argparse

import torch

from . import resolve_device
from .config import (GRAND_STAFF_ROOT_DIR, MAE_MAX_SEQ_LEN,
                     OLIMPIC_SCANNED_ROOT_DIR, OLIMPIC_SYNTHETIC_ROOT_DIR,
                     OMR_MAX_IMG_SEQ_LEN, PATCH_SIZE, PE_MAX_HEIGHT,
                     PE_MAX_WIDTH)
from .data import datasets as ds_lib
from .data import transforms as tf_lib
from .data.bucketing import BucketBatchSampler, default_bucket_boundaries
from .data.loader import PrefetchLoader, pack_mae_batch, pack_omr_batch
from .data.tokenizer import LmxTokenizer
from .models import weights as weights_lib


def build_mae_test_sets():
    base = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(PATCH_SIZE, MAE_MAX_SEQ_LEN, PE_MAX_HEIGHT,
                             PE_MAX_WIDTH, crop_imgs=True)])
    sets = [
        ds_lib.GrandStaffPreTrainWrapper(ds_lib.GrandStaffLMXDataset(
            GRAND_STAFF_ROOT_DIR, "samples.test.txt", img_transform=base)),
        ds_lib.OlimpicPreTrainWrapper(ds_lib.OlimpicDataset(
            OLIMPIC_SYNTHETIC_ROOT_DIR, "samples.test.txt",
            img_transform=base)),
        ds_lib.OlimpicPreTrainWrapper(ds_lib.OlimpicDataset(
            OLIMPIC_SCANNED_ROOT_DIR, "samples.test.txt",
            img_transform=base)),
    ]
    return ds_lib.ConcatDataset(sets)


def build_vitomr_test_sets(tokenizer):
    base = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(PATCH_SIZE, OMR_MAX_IMG_SEQ_LEN, PE_MAX_HEIGHT,
                             PE_MAX_WIDTH, crop_imgs=False)])
    sets = [
        ds_lib.GrandStaffOMRTrainWrapper(ds_lib.GrandStaffLMXDataset(
            GRAND_STAFF_ROOT_DIR, "samples.test.txt", img_transform=base)),
        ds_lib.OlimpicDataset(OLIMPIC_SYNTHETIC_ROOT_DIR, "samples.test.txt",
                              img_transform=base),
        ds_lib.OlimpicDataset(OLIMPIC_SCANNED_ROOT_DIR, "samples.test.txt",
                              img_transform=base),
    ]
    return ds_lib.ConcatDataset(sets)


def mean_loss(loader, run) -> float:
    """The mean of ``run(batch)`` over the loader's batches (0 for none),
    summed on the device and read once."""
    total, n = None, 0
    for batch in loader:
        v = run(batch)
        total = v if total is None else total + v
        n += 1
    return float(total) / n if n else 0.0


def test_loss(model: str, params: dict, batch_size: int = 64,
              num_workers: int = 16, cfg=None, device=None,
              reseed_masks: bool = False) -> float:
    """The average test loss of ``model`` ("mae" or "vitomr") with
    ``params`` already on ``device``: the test mix through the bucket
    sampler, the prefetch loader and the trainer's ``make_eval_fn``. ``cfg``
    overrides the flagship configuration (tiny configurations in tests).
    The MAE's masks come from one ``torch.Generator`` seeded 0 on the
    device, its draws running on from batch to batch, or reseeded 0 for
    every batch with ``reseed_masks`` (as the reference-loss tool does)."""
    from .data.loader import to_device

    device = resolve_device(device)
    if model == "mae":
        from .train.pre_train import make_eval_fn, set_up_mae
        cfg = cfg or set_up_mae()
        ds = build_mae_test_sets()
        pack = lambda ex: pack_mae_batch(ex, cfg.encoder)
        eval_fn = make_eval_fn(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        run = lambda b: eval_fn(params, to_device(b, device),
                                gen.manual_seed(0) if reseed_masks else gen)
    else:
        from .train.omr_teacher_force_train import make_eval_fn, set_up_vitomr
        tokenizer = LmxTokenizer()
        cfg = cfg or set_up_vitomr(tokenizer)
        ds = build_vitomr_test_sets(tokenizer)
        pack = lambda ex: pack_omr_batch(
            ex, cfg.encoder, tokenizer,
            max_lmx_seq_len=cfg.decoder.max_lmx_seq_len)
        eval_fn = make_eval_fn(cfg)
        run = lambda b: eval_fn(params, to_device(b, device))
    sampler = BucketBatchSampler(ds, default_bucket_boundaries(), batch_size,
                                 shuffle=False)
    return mean_loss(PrefetchLoader(ds, sampler, pack, num_workers), run)


def eval_mae(weights: str, batch_size: int = 64, num_workers: int = 16,
             cfg=None, device=None) -> float:
    """Average MAE test loss of the weights at ``weights``. ``cfg``
    overrides ``set_up_mae()`` (tiny configurations in tests)."""
    device = resolve_device(device)
    loss = test_loss("mae", weights_lib.load_mae_npz(weights, device),
                     batch_size, num_workers, cfg, device)
    print(f"Average MAE test loss: {loss}")
    return loss


def eval_vitomr(weights: str, batch_size: int = 64, num_workers: int = 16,
                cfg=None, device=None) -> float:
    """Average ViTOMR teacher-forced test loss of the weights at
    ``weights``. ``cfg`` overrides ``set_up_vitomr`` (tiny configurations in
    tests)."""
    device = resolve_device(device)
    loss = test_loss("vitomr", weights_lib.load_npz(weights, device),
                     batch_size, num_workers, cfg, device)
    print(f"Average ViTOMR test loss: {loss}")
    return loss


def dump_samples(model: str, weights: str, out_dir: str, num: int,
                 device=None) -> None:
    """Sample dumps (reference: eval_model.py -d / -p,
    show_{mae,vitomr}_prediction); needs matplotlib."""
    from pathlib import Path

    from .utils import visualize

    device = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if model == "mae":
        from .train.pre_train import set_up_mae
        cfg = set_up_mae()
        params = weights_lib.load_mae_npz(weights, device)
        ds = build_mae_test_sets()
        for i in range(min(num, len(ds))):
            inp, tgt = ds[i]
            visualize.show_mae_prediction(params, cfg, inp, tgt,
                                          str(out / f"sample_{i}.png"),
                                          device=device)
    else:
        from .train.omr_teacher_force_train import set_up_vitomr
        tokenizer = LmxTokenizer()
        cfg = set_up_vitomr(tokenizer)
        params = weights_lib.load_npz(weights, device)
        ds = build_vitomr_test_sets(tokenizer)
        for i in range(min(num, len(ds))):
            img, lmx = ds[i][:2]  # one __getitem__: each call re-decodes
            ids = tokenizer.encode(lmx) if isinstance(lmx, str) else lmx
            visualize.show_vitomr_prediction(params, cfg, tokenizer, img, ids,
                                             str(out / f"sample_{i}"),
                                             device=device)
    print(f"Wrote {min(num, len(ds))} sample dumps to {out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Evaluate MAE or ViTOMR weights on the test mix")
    ap.add_argument("model", choices=["mae", "vitomr"])
    ap.add_argument("weights", help="a .npz the port wrote, or a checkpoint "
                                    "directory the JAX package wrote")
    ap.add_argument("-c", "--from-checkpoint", action="store_true",
                    help="accepted for the reference CLI's sake; a train "
                         "state and bare parameters are told apart by the "
                         "file either way")
    ap.add_argument("-b", "--batch-size", type=int, default=64)
    ap.add_argument("-d", "--sample-dir", default=None,
                    help="also dump sample predictions to this directory")
    ap.add_argument("-p", "--num-samples", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.model == "mae":
        eval_mae(args.weights, args.batch_size, device=args.device)
    else:
        eval_vitomr(args.weights, args.batch_size, device=args.device)
    if args.sample_dir:
        dump_samples(args.model, args.weights, args.sample_dir,
                     args.num_samples, device=args.device)


if __name__ == "__main__":
    main()
