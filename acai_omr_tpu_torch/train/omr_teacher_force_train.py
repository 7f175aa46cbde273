"""Teacher-forced / scheduled-sampling seq2seq training (stage 2 of 3).

The twin of the JAX package's ``train/omr_teacher_force_train.py``: the
MAE-initialised encoder with its last ``fine_tune_depth`` layers tunable, the
12-layer LMX decoder, scheduled sampling with an annealed teacher-forcing
probability and Gumbel temperature and a switch to hard sampling, the LLRD
AdamW (base 1e-4 / fine-tune 1e-5, decay 0.9), gradient accumulation with
one update per window on the raw SUM of the window's gradients, bf16 compute
over fp32 master weights, a per-optimizer-step cosine schedule, a
teacher-forced validation pass per epoch, checkpoints and ``stats.csv``.

On a CUDA device both stacks run the hand-written kernels forward and
backward (:mod:`..ops.train_layer_kernel`); with ``device="cpu"`` their plain
twins run under autograd. Where :func:`..parallel.mesh.train_mesh` finds 4
or 2 of the devices that :func:`..parallel.mesh.train_devices` lists, and
the batch divides by their count, the loop is data-parallel: each device computes its rows' loss sum and gradients, K15
sums them (``parallel/trainer.make_sharded_grad_fn``), batches are padded to
the full batch size. Run as

    python -m acai_omr_tpu_torch.train.omr_teacher_force_train [--device cpu]

once the GrandStaff-LMX and OLiMPiC datasets and a pretrained MAE checkpoint
are present (none is in the repository).
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from .. import resolve_device
from ..config import (ENCODER_FINE_TUNE_DEPTH, GRAND_STAFF_ROOT_DIR,
                      LMX_VOCAB_PATH, MAX_LMX_SEQ_LEN, NUM_DECODER_LAYERS,
                      OLIMPIC_SCANNED_ROOT_DIR, OLIMPIC_SYNTHETIC_ROOT_DIR,
                      OMR_MAX_IMG_SEQ_LEN, PATCH_SIZE, PE_MAX_HEIGHT,
                      PE_MAX_WIDTH)
from ..data import datasets as ds_lib
from ..data import transforms as tf_lib
from ..data.bucketing import BucketBatchSampler, default_bucket_boundaries
from ..data.loader import PrefetchLoader, pack_omr_batch, to_device
from ..data.tokenizer import LmxTokenizer
from ..models import vitomr as vitomr_lib
from ..models.omr_decoder import DecoderConfig
from ..models.vit_encoder import EncoderConfig
from ..models.vitomr import ViTOMRConfig
from ..ops import dropout_kernel as dk
from ..parallel import mesh as mesh_lib
from ..parallel import trainer
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics import MetricsWriter
from .schedules import TFSchedule, cosine_anneal_with_warmup

MODEL_DIR_PATH = Path("tf_omr_train")
PRETRAINED_MAE_PATH = "mae_pre_train/pretrained_mae"

EPOCHS = 40
CHECKPOINT_FREQ = 10
FINE_TUNE_BASE_LR = 1e-5
FINE_TUNE_DECAY_FACTOR = 0.9
BASE_LR = 1e-4
MIN_LR = 1e-6
ADAMW_BETAS = (0.9, 0.95)
ADAMW_WEIGHT_DECAY = 0.01
WARMUP_EPOCHS = 2
BATCH_SIZE = 8
GRAD_ACCUMULATION_STEPS = 8
NUM_WORKERS = 26
AUGMENTATION_P = 0.5
ENCODER_DROPOUT = 0.05
TRANSITION_HEAD_DROPOUT = 0.05
DECODER_DROPOUT = 0.1
LABEL_SMOOTHING = 0.0
INITIAL_TEACHER_FORCING_PROB = 1.0
MIN_TEACHER_FORCING_PROB = 0.0
INITIAL_TAU = 5.0
MIN_TAU = 0.1
TF_ANNEAL_EPOCHS = 35
SOFT_EPOCHS = EPOCHS // 2


def set_up_vitomr(tokenizer: LmxTokenizer | None = None,
                  fine_tune_depth: int = ENCODER_FINE_TUNE_DEPTH) -> ViTOMRConfig:
    tokenizer = tokenizer or LmxTokenizer(LMX_VOCAB_PATH)
    return ViTOMRConfig(
        encoder=EncoderConfig(patch_size=PATCH_SIZE, pe_max_height=PE_MAX_HEIGHT,
                              pe_max_width=PE_MAX_WIDTH,
                              dropout=ENCODER_DROPOUT,
                              fine_tune_depth=fine_tune_depth),
        decoder=DecoderConfig.from_tokenizer(
            tokenizer, max_lmx_seq_len=MAX_LMX_SEQ_LEN,
            num_layers=NUM_DECODER_LAYERS, dropout=DECODER_DROPOUT),
        transition_head_dropout=TRANSITION_HEAD_DROPOUT)


def make_loss_fn(cfg: ViTOMRConfig, use_hard_sampling: bool,
                 compute_dtype=torch.bfloat16, label_smoothing=LABEL_SMOOTHING,
                 reduction="mean"):
    """Scheduled-sampling loss ``loss_fn(params, batch, seed)``; the batch
    carries the curriculum values ``tf_prob`` and ``tau``. ``"mean"`` returns
    (loss, {}); ``"sum"`` returns (nll_sum, token_count)."""
    def loss_fn(params, batch, seed):
        logits = vitomr_lib.forward_scheduled_sampling(
            params, cfg, batch["patches"], batch["pe_idx"], batch["pe_w"],
            batch["valid"], batch["inputs"], batch["lmx_valid"],
            teacher_forcing_prob=batch["tf_prob"], sample_tau=batch["tau"],
            use_hard_sampling=use_hard_sampling, seed=seed,
            compute_dtype=compute_dtype, deterministic=False,
            frozen_stop_gradient=True)
        out = vitomr_lib.omr_ce_loss(logits, batch["targets"],
                                     cfg.decoder.pad_idx, label_smoothing,
                                     reduction=reduction)
        return (out, {}) if reduction == "mean" else out
    return loss_fn


def make_sum_loss_fn(cfg: ViTOMRConfig, use_hard_sampling: bool,
                     compute_dtype=torch.bfloat16,
                     label_smoothing=LABEL_SMOOTHING):
    """The (nll_sum, token_count) variant of :func:`make_loss_fn`, for the
    exact data-parallel reduction (``trainer.make_sharded_grad_fn``)."""
    return make_loss_fn(cfg, use_hard_sampling, compute_dtype,
                        label_smoothing, reduction="sum")


def make_eval_fn(cfg: ViTOMRConfig, compute_dtype=torch.bfloat16,
                 label_smoothing=LABEL_SMOOTHING, mesh=None):
    """``eval_fn(params, batch) -> mean loss`` of the deterministic
    teacher-forced forward (no gradient, so the stacks keep no saves); with
    ``mesh`` the batch is cut over its data shards and their sums added."""
    def eval_sum(params, batch, rng=None):
        logits = vitomr_lib.forward_teacher_forced(
            params, cfg, batch["patches"], batch["pe_idx"], batch["pe_w"],
            batch["valid"], batch["inputs"], batch["lmx_valid"],
            compute_dtype=compute_dtype, deterministic=True)
        return vitomr_lib.omr_ce_loss(logits, batch["targets"],
                                      cfg.decoder.pad_idx, label_smoothing,
                                      reduction="sum")

    if mesh is not None:
        sharded = trainer.make_sharded_eval_fn(eval_sum, mesh)
        return lambda params, batch: sharded(params, batch)

    @torch.no_grad()
    def eval_fn(params, batch):
        s, n = eval_sum(params, batch)
        return s / n.clamp_min(1.0)
    return eval_fn


def omr_teacher_force_train(cfg: ViTOMRConfig, params, train_dataset,
                            validation_dataset, tokenizer: LmxTokenizer, *,
                            epochs: int = EPOCHS, batch_size: int = BATCH_SIZE,
                            grad_accumulation_steps: int = GRAD_ACCUMULATION_STEPS,
                            base_lr: float = BASE_LR,
                            fine_tune_base_lr: float = FINE_TUNE_BASE_LR,
                            fine_tune_decay: float = FINE_TUNE_DECAY_FACTOR,
                            warmup_epochs: int = WARMUP_EPOCHS,
                            min_lr: float = MIN_LR,
                            checkpoint_freq: int = CHECKPOINT_FREQ,
                            model_dir: Path = MODEL_DIR_PATH,
                            num_workers: int = NUM_WORKERS,
                            tf_anneal_epochs: int = TF_ANNEAL_EPOCHS,
                            soft_epochs: int = SOFT_EPOCHS,
                            bucket_boundaries=None, seed: int = 0,
                            compute_dtype=torch.bfloat16, device=None,
                            step_hook=None):
    """Full stage-2 loop; returns (params, stats).

    Runs on ``cuda`` unless ``device="cpu"``, data-parallel over
    ``train_mesh(train_devices(device), batch_size)`` where that is a mesh.
    ``params`` (any device) are copied into fp32 masters on the first
    device. ``step_hook(kind, info)``, when
    given, is called after every microbatch (``"micro"``), optimizer update
    (``"update"``) and validation batch (``"val"``) with the state and the
    values of that step: the place measurements hang their clocks on.
    """
    # data-parallel over the training devices when the batch shards evenly
    devices = mesh_lib.train_devices(device)
    mesh = mesh_lib.train_mesh(devices, batch_size)
    use_dp = mesh is not None
    device = devices[0]
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=False)
    (model_dir / "checkpoints").mkdir()

    boundaries = bucket_boundaries or default_bucket_boundaries(
        cfg.encoder.patch_size)
    sampler = BucketBatchSampler(train_dataset, list(boundaries), batch_size,
                                 seed=seed)
    val_sampler = BucketBatchSampler(validation_dataset, list(boundaries),
                                     batch_size, shuffle=False, seed=seed)
    pack = lambda ex: pack_omr_batch(
        ex, cfg.encoder, tokenizer,
        max_lmx_seq_len=cfg.decoder.max_lmx_seq_len,
        pad_to_batch=batch_size if use_dp else None)
    train_loader = PrefetchLoader(train_dataset, sampler, pack, num_workers)
    val_loader = PrefetchLoader(validation_dataset, val_sampler, pack,
                                num_workers)

    accum = max(grad_accumulation_steps, 1)
    opt_steps_per_epoch = max(-(len(sampler) // -accum), 1)
    schedule = cosine_anneal_with_warmup(
        base_lr, warmup_epochs * opt_steps_per_epoch,
        epochs * opt_steps_per_epoch, min_lr)
    tx = trainer.adamw(
        schedule, betas=ADAMW_BETAS, weight_decay=ADAMW_WEIGHT_DECAY,
        scale_tree_fn=lambda p: trainer.encoder_llrd_scales(
            p, cfg, fine_tune_base_lr / base_lr, fine_tune_decay))
    state = trainer.create_train_state(
        trainer.tree_map(lambda v: torch.as_tensor(v).to(device), params), tx)

    tf_schedule = TFSchedule(INITIAL_TEACHER_FORCING_PROB,
                             MIN_TEACHER_FORCING_PROB, INITIAL_TAU, MIN_TAU,
                             soft_steps=soft_epochs * opt_steps_per_epoch,
                             anneal_steps=tf_anneal_epochs * opt_steps_per_epoch)
    if use_dp:
        # each device runs the single-device step (the fused kernels) on its
        # rows; K15 sums the shards: exact global masked means
        sum_fns = {hard: make_sum_loss_fn(cfg, hard, compute_dtype)
                   for hard in (False, True)}
        grad_fns = {h: trainer.make_sharded_grad_fn(f, mesh)
                    for h, f in sum_fns.items()}
        grad_acc_fns = {h: trainer.make_sharded_grad_acc_fn(f, mesh)
                        for h, f in sum_fns.items()}
    else:
        loss_fns = {hard: make_loss_fn(cfg, hard, compute_dtype)
                    for hard in (False, True)}
        grad_fns = {h: trainer.make_grad_fn(f) for h, f in loss_fns.items()}
        grad_acc_fns = {h: trainer.make_grad_acc_fn(f)
                        for h, f in loss_fns.items()}
    apply_fn = trainer.make_apply_fn(tx)
    eval_fn = make_eval_fn(cfg, compute_dtype, mesh=mesh)

    writer = MetricsWriter(str(model_dir / "stats.csv"))
    stats = {"train_losses": [], "val_losses": [], "window_losses": []}
    hook = step_hook or (lambda kind, info: None)
    opt_step = micro_step = 0

    def update(grads_acc, window_losses, tf_prob, tau):
        """One optimizer step on the SUM of the window's gradients (no
        1/accum rescale); the losses are pulled to the host once, here."""
        nonlocal state, opt_step
        state = apply_fn(state, grads_acc, 1.0)
        window_mean = float(sum(window_losses)) / len(window_losses)
        writer.scalar("train/loss", window_mean, opt_step)
        writer.scalar("train/hyperparams/tf_prob", tf_prob, opt_step)
        writer.scalar("train/hyperparams/tau", tau, opt_step)
        stats["window_losses"].append(window_mean)
        hook("update", {"state": state, "opt_step": opt_step,
                        "loss": window_mean, "grads": grads_acc})
        opt_step += 1
        return window_mean * len(window_losses)

    for epoch in range(epochs):
        t0 = time.perf_counter()
        epoch_loss, n_micro = 0.0, 0
        grads_acc, window_losses = None, []
        try:
            for batch in train_loader:
                tf_prob, tau, use_hard = tf_schedule.at(opt_step)
                db = to_device(batch, device)
                db.update(tf_prob=tf_prob, tau=tau)
                step_seed = dk.fold_seed(seed + 1, micro_step)[0]
                if grads_acc is None:
                    loss_dev, grads_acc = grad_fns[use_hard](
                        state.params, db, step_seed)
                else:
                    loss_dev, grads_acc = grad_acc_fns[use_hard](
                        state.params, db, step_seed, grads_acc)
                window_losses.append(loss_dev)
                n_micro += 1
                micro_step += 1
                hook("micro", {"state": state, "micro_step": micro_step,
                               "batch": db})
                if len(window_losses) >= accum:
                    epoch_loss += update(grads_acc, window_losses, tf_prob,
                                         tau)
                    grads_acc, window_losses = None, []
            if window_losses:  # epoch-final partial window
                epoch_loss += update(grads_acc, window_losses, tf_prob, tau)
                grads_acc, window_losses = None, []
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

        train_loss = epoch_loss / max(n_micro, 1)
        val_losses = []
        for batch in val_loader:
            val_losses.append(eval_fn(state.params, to_device(batch, device)))
            hook("val", {"state": state})
        val_loss = float(sum(val_losses)) / max(len(val_losses), 1)

        dt = time.perf_counter() - t0
        print(f"Epoch {epoch + 1}: train {train_loss:.5f} val {val_loss:.5f} "
              f"({dt:.1f}s)")
        writer.scalars("epoch", {"train_loss": train_loss,
                                 "val_loss": val_loss}, epoch)
        writer.flush()
        stats["train_losses"].append(train_loss)
        stats["val_losses"].append(val_loss)

        if (epoch + 1) % checkpoint_freq == 0:
            ckpt_lib.save_train_state(
                model_dir / "checkpoints" / f"epoch_{epoch + 1}", state)

    ckpt_lib.save_pytree(model_dir / "vitomr", state.params)
    return state.params, stats


def set_up_omr_teacher_force_train(pretrained_mae_path: str = PRETRAINED_MAE_PATH,
                                   device=None, seed: int = 0):
    """Model + MAE-weight transfer + base transforms: (cfg, params, tokenizer,
    base_img_transform). The encoder subtree of the MAE checkpoint replaces
    the freshly drawn one."""
    device = resolve_device(device)
    tokenizer = LmxTokenizer(LMX_VOCAB_PATH)
    cfg = set_up_vitomr(tokenizer)
    params = vitomr_lib.init_vitomr_params(cfg, seed=seed, device=device)
    params = vitomr_lib.vitomr_params_from_mae(
        params, ckpt_lib.load_params(pretrained_mae_path))
    base_img_transform = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(PATCH_SIZE, OMR_MAX_IMG_SEQ_LEN, PE_MAX_HEIGHT,
                             PE_MAX_WIDTH, crop_imgs=False),
    ])
    return cfg, params, tokenizer, base_img_transform


def build_datasets(base_img_transform):
    """The stage-2 dataset mix: GrandStaff (camera-augmented distorted
    variants with probability 0.5) + synthetic OLiMPiC for training, their
    dev splits plus scanned OLiMPiC for validation."""
    camera = tf_lib.default_camera_augment(1.0)
    grandstaff_camera = tf_lib.Compose([
        tf_lib.RandomPerspective(0.2, 1.0),
        tf_lib.ColorJitter(0.15, 0.2, 0.2, 0),
    ])
    olimpic_tf = tf_lib.Compose([base_img_transform,
                                 tf_lib.RandomApply([camera], p=AUGMENTATION_P)])
    grand_staff = ds_lib.GrandStaffLMXDataset(
        GRAND_STAFF_ROOT_DIR, "samples.train.txt",
        img_transform=base_img_transform)
    train = ds_lib.ConcatDataset([
        ds_lib.GrandStaffOMRTrainWrapper(grand_staff, AUGMENTATION_P,
                                         transform=grandstaff_camera),
        ds_lib.OlimpicDataset(OLIMPIC_SYNTHETIC_ROOT_DIR, "samples.train.txt",
                              img_transform=olimpic_tf),
    ])
    val = ds_lib.ConcatDataset([
        ds_lib.GrandStaffOMRTrainWrapper(ds_lib.GrandStaffLMXDataset(
            GRAND_STAFF_ROOT_DIR, "samples.dev.txt",
            img_transform=base_img_transform)),
        ds_lib.OlimpicDataset(OLIMPIC_SYNTHETIC_ROOT_DIR, "samples.dev.txt",
                              img_transform=base_img_transform),
        ds_lib.OlimpicDataset(OLIMPIC_SCANNED_ROOT_DIR, "samples.dev.txt",
                              img_transform=base_img_transform),
    ])
    return train, val


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mae", default=PRETRAINED_MAE_PATH,
                    help="pretrained MAE checkpoint (.npz)")
    args = ap.parse_args()
    cfg, params, tokenizer, base_img_transform = \
        set_up_omr_teacher_force_train(args.mae, device=args.device)
    train_ds, val_ds = build_datasets(base_img_transform)
    omr_teacher_force_train(cfg, params, train_ds, val_ds, tokenizer,
                            device=args.device)
