"""MAE pretraining loop (stage 1 of 3).

The twin of the JAX package's ``train/pre_train.py``: ViT-B/16
encoder under a 0.75 random mask, the 8-layer 512-wide 16-head decoder, the
per-patch-normalised pixel loss, AdamW (betas 0.9 / 0.95, weight decay 0.05,
no layer-wise decay), one update per batch, a cosine schedule with warm-up
evaluated per epoch, bf16 compute over fp32 master weights, a validation pass
per epoch, ``stats.csv``, periodic and emergency checkpoints, ``resume_from``,
and at the end ``pretrained_mae.npz``: the file whose encoder stage 2
(:func:`.omr_teacher_force_train.set_up_omr_teacher_force_train`) starts
from. Where :func:`..parallel.mesh.train_mesh` finds 4 or 2 of the devices
that :func:`..parallel.mesh.train_devices` lists, and the batch divides by
their count, each update is data-parallel: each
device computes its rows' loss sum and gradients, K15 sums them
(``parallel/trainer.make_sharded_train_step``), batches are padded to the
full batch size.

On a CUDA device both stacks run the hand-written kernels forward and
backward (:mod:`..ops.train_layer_kernel`; the decoder's heads are 32 wide);
with ``device="cpu"`` their plain twins run under autograd. Run as

    python -m acai_omr_tpu_torch.train.pre_train [--device cpu]

once the GrandStaff-LMX, PrIMuS, DoReMi and OLiMPiC datasets are present
(none is in the repository).
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from ..config import (DOREMI_PREPARED_ROOT_DIR, GRAND_STAFF_ROOT_DIR,
                      MAE_MAX_SEQ_LEN, OLIMPIC_SYNTHETIC_ROOT_DIR, PATCH_SIZE,
                      PE_MAX_HEIGHT, PE_MAX_WIDTH, PRIMUS_PREPARED_ROOT_DIR)
from ..data import datasets as ds_lib
from ..data import transforms as tf_lib
from ..data.bucketing import BucketBatchSampler, default_bucket_boundaries
from ..data.loader import PrefetchLoader, pack_mae_batch, to_device
from ..models import mae as mae_lib
from ..models.mae import MaeConfig
from ..models.vit_encoder import EncoderConfig
from ..ops import dropout_kernel as dk
from ..parallel import mesh as mesh_lib
from ..parallel import trainer
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics import MetricsWriter
from .schedules import cosine_anneal_with_warmup

MODEL_DIR_PATH = Path("mae_pre_train")

MASK_RATIO = 0.75
AUGMENTATION_P = 0.2
EPOCHS = 500
CHECKPOINT_FREQ = 50
BASE_LR = 1.5e-4
MIN_LR = 1e-6
ADAMW_BETAS = (0.9, 0.95)
ADAMW_WEIGHT_DECAY = 0.05
WARMUP_EPOCHS = 50
BATCH_SIZE = 64
NUM_WORKERS = 24


def set_up_mae() -> MaeConfig:
    """ViT-B/16 MAE, 60 x 200 PE grid, mask ratio 0.75."""
    return MaeConfig(
        encoder=EncoderConfig(patch_size=PATCH_SIZE,
                              pe_max_height=PE_MAX_HEIGHT,
                              pe_max_width=PE_MAX_WIDTH),
        mask_ratio=MASK_RATIO)


def _forward(cfg: MaeConfig, params, batch, generator, compute_dtype):
    return mae_lib.forward(
        params, cfg, batch["patches"], batch["pe_idx"], batch["pe_w"],
        batch["valid"], batch["lengths"], batch["target_patches"],
        generator=generator, compute_dtype=compute_dtype)


def make_loss_fn(cfg: MaeConfig, compute_dtype=torch.bfloat16,
                 reduction="mean"):
    """``loss_fn(params, batch, generator)``: ``"mean"`` returns (loss, {});
    ``"sum"`` returns (loss_sum, patch_count). The mask's noise comes from
    ``generator``."""
    def loss_fn(params, batch, generator):
        out = mae_lib.mae_loss(
            *_forward(cfg, params, batch, generator, compute_dtype),
            reduction=reduction)
        return (out, {}) if reduction == "mean" else out
    return loss_fn


def make_sum_loss_fn(cfg: MaeConfig, compute_dtype=torch.bfloat16):
    """The (loss_sum, patch_count) variant of :func:`make_loss_fn`, for the
    exact data-parallel reduction (``trainer.make_sharded_train_step``)."""
    return make_loss_fn(cfg, compute_dtype, reduction="sum")


def make_eval_fn(cfg: MaeConfig, compute_dtype=torch.bfloat16, mesh=None):
    """``eval_fn(params, batch, generator) -> mean loss`` over the batch's
    masked patches (no gradient, so the stacks keep no saves); with
    ``mesh`` the batch is cut over its data shards (shard d's masks from
    the generator's seed + d) and their sums added."""
    def eval_sum(params, batch, generator):
        return mae_lib.mae_loss(
            *_forward(cfg, params, batch, generator, compute_dtype),
            reduction="sum")

    if mesh is not None:
        return trainer.make_sharded_eval_fn(eval_sum, mesh)

    @torch.no_grad()
    def eval_fn(params, batch, generator):
        s, n = eval_sum(params, batch, generator)
        return s / n.clamp_min(1.0)
    return eval_fn


def pre_train(mae_cfg: MaeConfig, train_dataset, validation_dataset, *,
              params=None, epochs: int = EPOCHS, batch_size: int = BATCH_SIZE,
              warmup_epochs: int = WARMUP_EPOCHS, base_lr: float = BASE_LR,
              min_lr: float = MIN_LR, checkpoint_freq: int = CHECKPOINT_FREQ,
              model_dir: Path = MODEL_DIR_PATH, num_workers: int = NUM_WORKERS,
              bucket_boundaries=None, seed: int = 0,
              compute_dtype=torch.bfloat16, resume_from: str | None = None,
              device=None, step_hook=None):
    """Full pretraining loop; returns (params, stats).

    Runs on ``cuda`` unless ``device="cpu"``, data-parallel over
    ``train_mesh(train_devices(device), batch_size)`` where that is a mesh.
    ``params`` (any device; drawn from ``seed`` when None)
    are copied into fp32 masters on the first device.
    ``resume_from``: a train-state checkpoint to continue from; the resumed
    epochs draw masks from a stream of their own. ``step_hook(kind, info)``,
    when given, is called after every update (``"step"``) and validation
    batch (``"val"``) with the state and the values of that step: the place
    measurements hang their clocks on.
    """
    devices = mesh_lib.train_devices(device)
    mesh = mesh_lib.train_mesh(devices, batch_size)
    use_dp = mesh is not None
    device = devices[0]
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=resume_from is not None)
    (model_dir / "checkpoints").mkdir(exist_ok=resume_from is not None)

    if params is None:
        params = mae_lib.init_mae_params(mae_cfg, seed=seed, device=device)
    n_params = sum(v.numel() for v in trainer.tree_flatten(params).values())
    print(f"Trainable parameters count: {n_params}")

    boundaries = bucket_boundaries or default_bucket_boundaries(
        mae_cfg.patch_size)
    train_sampler = BucketBatchSampler(train_dataset, list(boundaries),
                                       batch_size, seed=seed)
    val_sampler = BucketBatchSampler(validation_dataset, list(boundaries),
                                     batch_size, shuffle=False, seed=seed)
    pack = lambda ex: pack_mae_batch(
        ex, mae_cfg.encoder, pad_to_batch=batch_size if use_dp else None)
    train_loader = PrefetchLoader(train_dataset, train_sampler, pack,
                                  num_workers)
    val_loader = PrefetchLoader(validation_dataset, val_sampler, pack,
                                num_workers)

    # the per-epoch curve, read at every optimizer step
    steps_per_epoch = max(len(train_sampler), 1)
    epoch_schedule = cosine_anneal_with_warmup(base_lr, warmup_epochs, epochs,
                                               min_lr)
    tx = trainer.adamw(lambda step: epoch_schedule(step // steps_per_epoch),
                       betas=ADAMW_BETAS, weight_decay=ADAMW_WEIGHT_DECAY)
    state = trainer.create_train_state(
        trainer.tree_map(lambda v: torch.as_tensor(v).to(device), params), tx)
    start_epoch = 0
    if resume_from:
        state = ckpt_lib.load_train_state(resume_from, state)
        start_epoch = state.step // steps_per_epoch
        print(f"Resumed from {resume_from} at step {state.step} "
              f"(epoch {start_epoch})")
    if use_dp:
        # each device runs the single-device step (the fused kernels) on its
        # rows; K15 sums the shards: exact global masked means
        step_fn = trainer.make_sharded_train_step(
            make_sum_loss_fn(mae_cfg, compute_dtype), tx, mesh)
    else:
        step_fn = trainer.make_train_step(
            make_loss_fn(mae_cfg, compute_dtype), tx)
    eval_fn = make_eval_fn(mae_cfg, compute_dtype, mesh=mesh)

    writer = MetricsWriter(str(model_dir / "stats.csv"))
    stats = {"train_losses": [], "val_losses": []}
    hook = step_hook or (lambda kind, info: None)
    generator = torch.Generator(device=device)
    draws = 0

    def next_generator():
        """The mask stream: draw ``i`` of a run is seeded from (seed + 1, the
        epoch the run started at, i), so a resumed run does not replay the
        masks of the first run's early epochs."""
        nonlocal draws
        s0, s1 = dk.fold_seed(seed + 1, start_epoch, draws)
        draws += 1
        return generator.manual_seed((s1 << 32 | s0) & (2 ** 63 - 1))

    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        loss_acc, n_batches = None, 0
        try:
            for batch in train_loader:
                state, metrics = step_fn(state, to_device(batch, device),
                                         next_generator())
                # summed on the device: one pull to the host per epoch
                loss_acc = metrics["loss"] if loss_acc is None \
                    else loss_acc + metrics["loss"]
                n_batches += 1
                hook("step", {"state": state, "metrics": metrics})
        except BaseException:
            # crash-resilient save; the original error is what propagates
            try:
                ckpt_lib.save_train_state(
                    model_dir / "checkpoints" / "emergency", state)
                print(f"Saved emergency checkpoint to "
                      f"{model_dir}/checkpoints/emergency")
            except Exception as save_error:
                print(f"emergency checkpoint failed: {save_error!r}")
            raise
        train_loss = float(loss_acc) / n_batches if n_batches else 0.0

        val_acc, n_val = None, 0
        for batch in val_loader:
            v = eval_fn(state.params, to_device(batch, device),
                        next_generator())
            val_acc = v if val_acc is None else val_acc + v
            n_val += 1
            hook("val", {"state": state})
        val_loss = float(val_acc) / n_val if n_val else 0.0

        dt = time.perf_counter() - t0
        print(f"Epoch {epoch + 1}: train {train_loss:.5f} val {val_loss:.5f} "
              f"({dt:.1f}s, {n_batches} batches)")
        writer.scalars("epoch", {"train_loss": train_loss,
                                 "val_loss": val_loss, "seconds": dt}, epoch)
        writer.flush()
        stats["train_losses"].append(train_loss)
        stats["val_losses"].append(val_loss)

        if (epoch + 1) % checkpoint_freq == 0:
            ckpt_lib.save_train_state(
                model_dir / "checkpoints" / f"epoch_{epoch + 1}", state)

    ckpt_lib.save_pytree(model_dir / "pretrained_mae", state.params)
    return state.params, stats


def build_datasets():
    """The four-dataset pretraining mix: GrandStaff, PrIMuS, DoReMi and
    synthetic OLiMPiC for training; the dev splits of GrandStaff and OLiMPiC
    for validation."""
    base = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(PATCH_SIZE, MAE_MAX_SEQ_LEN, PE_MAX_HEIGHT,
                             PE_MAX_WIDTH, crop_imgs=True),
    ])
    # the pretraining camera stack, weaker than stage 2's: fixed sigma-1
    # blur, +/- 1 degree, perspective 0.06, brightness 0.2
    camera = tf_lib.RandomApply([
        tf_lib.GaussianBlur(15, (1.0, 1.0)),
        tf_lib.GaussianNoise(0.03),
        tf_lib.RandomRotation((-1, 1)),
        tf_lib.RandomPerspective(0.06, 1.0),
        tf_lib.ColorJitter(0.2, 0.2, 0.2, 0),
    ], p=AUGMENTATION_P)
    # GrandStaff ships partially augmented variants already, so only
    # perspective and jitter, always applied to the distorted branch (the
    # wrapper holds the augment_p gate)
    grandstaff_camera = tf_lib.Compose([
        tf_lib.RandomPerspective(0.08, 1.0),
        tf_lib.ColorJitter(0.2, 0.2, 0.2, 0),
    ])

    grand_staff = ds_lib.GrandStaffLMXDataset(
        GRAND_STAFF_ROOT_DIR, "samples.train.txt", img_transform=base)
    primus = ds_lib.PreparedDataset(PRIMUS_PREPARED_ROOT_DIR, transform=base)
    doremi = ds_lib.PreparedDataset(DOREMI_PREPARED_ROOT_DIR, transform=base)
    olimpic = ds_lib.OlimpicDataset(
        OLIMPIC_SYNTHETIC_ROOT_DIR, "samples.train.txt", img_transform=base)
    train = ds_lib.ConcatDataset([
        ds_lib.GrandStaffPreTrainWrapper(grand_staff, AUGMENTATION_P,
                                         grandstaff_camera),
        ds_lib.PreTrainWrapper(primus, transform=camera),
        ds_lib.PreTrainWrapper(doremi, transform=camera),
        ds_lib.OlimpicPreTrainWrapper(olimpic, transform=camera),
    ])

    gs_val = ds_lib.GrandStaffLMXDataset(
        GRAND_STAFF_ROOT_DIR, "samples.dev.txt", img_transform=base)
    ol_val = ds_lib.OlimpicDataset(
        OLIMPIC_SYNTHETIC_ROOT_DIR, "samples.dev.txt", img_transform=base)
    val = ds_lib.ConcatDataset([
        ds_lib.GrandStaffPreTrainWrapper(gs_val),
        ds_lib.OlimpicPreTrainWrapper(ol_val),
    ])
    return train, val


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--resume-from", default=None,
                    help="train-state checkpoint (.npz) to continue from")
    args = ap.parse_args()
    train_ds, val_ds = build_datasets()
    pre_train(set_up_mae(), train_ds, val_ds, device=args.device,
              resume_from=args.resume_from)
