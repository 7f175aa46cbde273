"""Sample prediction dumps: MAE reconstructions, ViTOMR transcriptions.

The twin of the JAX package's ``utils/visualize.py`` (reference:
acai_omr/utils/utils.py:387-455 show_mae_prediction /
show_vitomr_prediction): input, reconstruction and target side by side, or
the predicted and target LMX of one example. matplotlib is imported inside
the functions and is needed only here (the GPU machine does not carry it:
there a call raises ImportError naming it). Runs on ``cuda`` unless
``device="cpu"``; ``params`` must live there.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import resolve_device


def pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError naming the
    package where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the sample dumps and plots need matplotlib, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def show_mae_prediction(params, cfg, input_img, target_img, save_path: str,
                        generator: torch.Generator | None = None,
                        device=None) -> float:
    """Run one example through the MAE and save an input / reconstruction /
    target figure. input_img / target_img: (C, H, W) float arrays. The mask
    comes from ``generator`` (seed 0 on the device when None). Returns the
    masked loss."""
    plt = pyplot()
    from ..models import mae as mae_lib
    from ..models import vit_encoder
    from ..ops import patchify as patch_ops

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    pb = vit_encoder.batchify([input_img], cfg.encoder)
    tgt = np.zeros_like(pb.patches)
    tp = patch_ops.patchify(np.asarray(target_img, np.float32),
                            cfg.patch_size)
    tgt[0, :tp.shape[0]] = tp
    t = lambda a: torch.from_numpy(a).to(device)
    with torch.no_grad():
        pred, loss_mask, target = mae_lib.forward(
            params, cfg, *pb.to(device), t(pb.lengths), t(tgt),
            generator=generator)
        loss = float(mae_lib.mae_loss(pred, loss_mask, target))

    hp, wp = pb.dims[0]
    recon = patch_ops.unpatchify(pred[0, :hp * wp].cpu().numpy(), hp, wp,
                                 cfg.patch_size)
    fig, axs = plt.subplots(1, 3, figsize=(16, 4))
    fig.suptitle(f"Loss: {loss}")
    for ax, img, title in zip(
            axs, [input_img, recon, target_img],
            ["Input image", "MAE reconstruction prediction", "Target image"]):
        ax.imshow(np.asarray(img)[0], cmap="gray")
        ax.set_title(title)
    fig.savefig(save_path)
    plt.close(fig)
    return loss


def show_vitomr_prediction(params, cfg, tokenizer, img, lmx_ids,
                           sample_save_dir: str, device=None) -> float:
    """Teacher-forced prediction dump: ``input_image.png``, ``pred.txt`` and
    ``target_seq.txt`` under ``sample_save_dir`` (reference:
    utils.py:415-455). Returns the cross entropy."""
    plt = pyplot()
    from ..models import omr_decoder, vit_encoder
    from ..models import vitomr as vitomr_lib

    device = resolve_device(device)
    out = Path(sample_save_dir)
    out.mkdir(parents=True, exist_ok=True)
    pb = vit_encoder.batchify([img], cfg.encoder)
    inputs, targets, lmx_valid = omr_decoder.batchify_and_split_lmx_seqs(
        [np.asarray(lmx_ids, np.int32)], cfg.decoder.pad_idx,
        max_len=cfg.decoder.max_lmx_seq_len)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    with torch.no_grad():
        logits = vitomr_lib.forward_teacher_forced(
            params, cfg, *pb.to(device), t(inputs), t(lmx_valid))
        loss = float(vitomr_lib.omr_ce_loss(logits, t(targets),
                                            cfg.decoder.pad_idx))
    pred_ids = logits.argmax(dim=-1)[0].cpu().numpy()
    pred = " ".join(tokenizer.idxs_to_tokens[int(i)] for i in pred_ids)
    target = " ".join(tokenizer.idxs_to_tokens[int(i)] for i in targets[0])

    fig, ax = plt.subplots(figsize=(12, 8))
    fig.suptitle(f"Sequences cross entropy loss: {loss}")
    ax.imshow(np.asarray(img)[0], cmap="gray")
    ax.set_title("Input image")
    fig.savefig(out / "input_image.png")
    plt.close(fig)
    (out / "pred.txt").write_text(pred)
    (out / "target_seq.txt").write_text(target)
    return loss
