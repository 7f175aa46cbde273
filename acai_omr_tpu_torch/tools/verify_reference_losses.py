"""Check the reference's test losses when its datasets and weights exist.

    python -m acai_omr_tpu_torch.tools.verify_reference_losses mae \
        --torch-weights pretrained_mae.pth      # the reference .pth
    python -m acai_omr_tpu_torch.tools.verify_reference_losses vitomr \
        --torch-weights vitomr.pth [--device cpu]

The twin of the JAX package's ``tools/verify_reference_losses.py``: the
reference reports 0.159 normalised masked-pixel MSE (MAE) and 0.056
teacher-forced cross entropy (ViTOMR) on the held-out test mix
(``EXPECTED``). Neither its datasets nor its trained weights are in this
repository, so the check runs on a machine that has them, with the
reference's ``data/`` layout (``config.py`` paths, overridable by
environment variables). ``--torch-weights`` reads the reference's PyTorch
state dict (``torch.load(weights_only=True)``) through
:mod:`..models.torch_compat`; ``--weights`` reads a ``.npz`` the port wrote or
a checkpoint directory the JAX package wrote. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from .. import resolve_device

EXPECTED = {"mae": 0.1589139682982496, "vitomr": 0.05576839766459551}


def load_params(model: str, torch_weights: str | None, weights: str | None,
                device=None) -> dict:
    """The port's parameter tree of ``model`` ("mae" or "vitomr") on
    ``device``: from a reference ``.pth`` (a state dict, or a dict holding
    it under ``vitomr_state_dict`` / ``mae_state_dict``), else from
    ``weights``."""
    from ..models import torch_compat
    from ..models import weights as weights_lib

    device = resolve_device(device)
    if torch_weights:
        sd = torch.load(torch_weights, map_location="cpu", weights_only=True)
        for key in ("vitomr_state_dict", "mae_state_dict"):
            if isinstance(sd, dict) and key in sd:
                sd = sd[key]
        conv = (torch_compat.mae_params_from_torch if model == "mae"
                else torch_compat.vitomr_params_from_torch)
        return conv(sd, device)
    load = weights_lib.load_mae_npz if model == "mae" else weights_lib.load_npz
    return load(weights, device)


def _eval_with_params(eval_model, model: str, params: dict, batch_size: int,
                      cfg=None, num_workers: int = 16, device=None) -> float:
    """The eval loop of ``eval_model`` (its ``test_loss``) on parameters
    already loaded (no checkpoint read). ``cfg`` overrides the flagship
    configuration (tiny configurations in tests). Every MAE batch draws its
    mask from a generator seeded 0."""
    return eval_model.test_loss(model, params, batch_size, num_workers, cfg,
                                device, reseed_masks=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Check the reference's test losses")
    ap.add_argument("model", choices=["mae", "vitomr"])
    ap.add_argument("--torch-weights", default=None,
                    help="the reference's .pth state dict (converted)")
    ap.add_argument("--weights", default=None,
                    help="a .npz the port wrote, or a JAX checkpoint directory")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--tolerance", type=float, default=0.005)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.torch_weights or args.weights):
        ap.error("one of --torch-weights / --weights required")

    from .. import eval_model

    params = load_params(args.model, args.torch_weights, args.weights,
                         args.device)
    loss = _eval_with_params(eval_model, args.model, params, args.batch_size,
                             device=args.device)
    expected = EXPECTED[args.model]
    delta = abs(loss - expected)
    ok = delta <= args.tolerance
    print(f"{args.model}: loss={loss:.6f} expected={expected:.6f} "
          f"delta={delta:.6f} -> {'PARITY OK' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
