"""Functional training on one device: optimizer, train state, gradient and
apply steps over the parameter dict.

The single-device half of the JAX package's ``parallel/trainer.py``. The
optimizer is written as a function over the dict because layer-wise LR decay
acts on the *layer axis* of stacked block leaves (a ``(num_layers, 1, ...)``
scale per leaf), which ``torch.optim.AdamW`` parameter groups cannot express.
The update is ``optax.adamw`` followed by the per-leaf scale: Adam moments
with bias correction (eps 1e-8 outside the root), decoupled weight decay on
every leaf, the step's learning rate, then the scale, which multiplies the
whole update, decay included, so a scale of 0 freezes a layer bit for bit.
With ``max_grad_norm`` the gradients are first clipped to that global L2
norm, as ``optax.clip_by_global_norm`` does (the norm counts every leaf,
frozen ones with their zero gradients included).

Parameters and optimizer state are updated in place (the train state owns
its buffers: :func:`create_train_state` clones the caller's parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.weights import _flatten as tree_flatten  # {"a/b/c": leaf}
from ..models.weights import _unflatten as tree_unflatten

Params = dict


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    flats = [tree_flatten(t) for t in (tree, *rest)]
    return tree_unflatten({p: fn(*(f[p] for f in flats)) for p in flats[0]})


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optimizer's constants; ``learning_rate`` is a float or a
    ``step -> float`` schedule read at the count of updates done so far."""
    learning_rate: object
    betas: tuple = (0.9, 0.95)
    weight_decay: float = 0.05
    eps: float = 1e-8
    scale_tree_fn: Callable | None = None
    max_grad_norm: float | None = None

    def lr(self, step: int) -> float:
        return float(self.learning_rate(step)) if callable(self.learning_rate) \
            else float(self.learning_rate)


def adamw(learning_rate, betas=(0.9, 0.95), weight_decay: float = 0.05,
          max_grad_norm: float | None = None,
          scale_tree_fn: Callable | None = None) -> AdamW:
    return AdamW(learning_rate, tuple(betas), weight_decay,
                 scale_tree_fn=scale_tree_fn, max_grad_norm=max_grad_norm)


def global_norm(grads: Params) -> torch.Tensor:
    """The L2 norm of all leaves together, fp32, left on the device."""
    leaves = [g.float() for g in tree_flatten(grads).values()]
    return torch.stack(torch._foreach_norm(leaves)).norm()


def encoder_llrd_scales(params: Params, cfg, fine_tune_lr_ratio: float,
                        decay_factor: float) -> Params:
    """Scale tree of the fine-tune parameter groups on stacked leaves.

    Decoder and transition head: 1. Encoder layer i (deepest =
    num_layers - 1): ``fine_tune_lr_ratio * decay^(num_layers - 1 - i)``, the
    frozen prefix 0, as a ``(num_layers, 1, ...)`` tensor per block leaf. PE
    grid and projection: the smallest layer scale; the encoder's final norm:
    ``fine_tune_lr_ratio``. ``fine_tune_depth=0`` freezes the whole encoder.
    """
    enc = cfg.encoder
    n, depth = enc.num_layers, enc.fine_tune_depth
    layer_scale = [0.0] * n
    for i in range(n - depth, n):
        layer_scale[i] = fine_tune_lr_ratio * decay_factor ** (n - 1 - i)
    min_scale = float(fine_tune_lr_ratio * decay_factor ** (depth - 1)) \
        if depth else 0.0

    def scale_for(name, leaf):
        path = name.split("/")
        if path[0] != "encoder":
            return 1.0
        if "blocks" in path:
            return torch.tensor(layer_scale, dtype=torch.float32,
                                device=leaf.device).reshape(
                (n,) + (1,) * (leaf.dim() - 1))
        if path[1] == "final_norm":
            return fine_tune_lr_ratio if depth else 0.0
        return min_scale

    return tree_unflatten({p: scale_for(p, v)
                           for p, v in tree_flatten(params).items()})


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: dict  # {"mu": tree, "nu": tree, "scale": tree or None}


def create_train_state(params: Params, tx: AdamW) -> TrainState:
    """fp32 master parameters (cloned: the state owns and overwrites its
    buffers) with zeroed Adam moments."""
    params = tree_map(lambda v: v.detach().clone().float(), params)
    zeros = lambda: tree_map(torch.zeros_like, params)
    scale = tx.scale_tree_fn(params) if tx.scale_tree_fn else None
    return TrainState(0, params, {"mu": zeros(), "nu": zeros(),
                                  "scale": scale})


def make_grad_fn(loss_fn: Callable):
    """``grad_fn(params, batch, seed) -> (loss, grads)``: the loss (a detached
    scalar tensor, left on the device) and its gradient tree (zeros for a
    leaf the loss does not reach). ``loss_fn(params, batch, seed)`` returns
    ``(loss, aux)``."""

    def grad_fn(params, batch, seed):
        flat = tree_flatten(params)
        leaves = {p: v.detach().requires_grad_(True) for p, v in flat.items()}
        loss, _aux = loss_fn(tree_unflatten(leaves), batch, seed)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        # autograd may hand back expanded views (stride 0): the first
        # microbatch's gradients become the window's accumulator, so each
        # must own its memory
        grads = {p: torch.zeros_like(v) if g is None else g.contiguous()
                 for (p, v), g in zip(flat.items(), grads)}
        return loss.detach(), tree_unflatten(grads)

    return grad_fn


def make_grad_acc_fn(loss_fn: Callable):
    """``grad_acc_fn(params, batch, seed, acc) -> (loss, acc)`` with the
    microbatch's gradients added into ``acc`` in place (same fp32 adds, same
    order, as summing the trees)."""
    grad_fn = make_grad_fn(loss_fn)

    def grad_acc_fn(params, batch, seed, acc):
        loss, grads = grad_fn(params, batch, seed)
        torch._foreach_add_(list(tree_flatten(acc).values()),
                            list(tree_flatten(grads).values()))
        return loss, acc

    return grad_acc_fn


def make_apply_fn(tx: AdamW):
    """``apply_fn(state, grads, scale=1.0) -> state``: one optimizer update
    from accumulated gradients, in place. ``scale`` rescales the summed window
    gradients first; stage 2 steps on the raw sum (scale 1)."""

    @torch.no_grad()
    def apply_fn(state: TrainState, grads: Params, scale: float = 1.0):
        b1, b2 = tx.betas
        count = state.step + 1
        lr = tx.lr(state.step)
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        mu, nu = (tree_flatten(state.opt_state[k]) for k in ("mu", "nu"))
        scales = tree_flatten(state.opt_state["scale"]) \
            if state.opt_state["scale"] is not None else None
        flat_g = tree_flatten(grads)
        g_norm = None
        if tx.max_grad_norm is not None:
            g_norm = global_norm(grads) * abs(scale)
            clip = g_norm >= tx.max_grad_norm
        for path, p in tree_flatten(state.params).items():
            g = flat_g[path].float()
            if scale != 1.0:
                g = g * scale
            if g_norm is not None:
                g = torch.where(clip, (g / g_norm) * tx.max_grad_norm, g)
            m, v = mu[path], nu[path]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            update = (m / c1) / ((v / c2).sqrt() + tx.eps) \
                + tx.weight_decay * p
            update = update * (-lr)
            if scales is not None:
                update = update * scales[path]
            p.add_(update)
        state.step = count
        return state

    return apply_fn


def make_train_step(loss_fn: Callable, tx: AdamW):
    """``step(state, batch, seed) -> (state, metrics)``: one loss, one
    backward and one optimizer update with no accumulation window (MAE
    pretraining). ``metrics`` holds the loss and the global L2 norm of the
    gradients, ``grad_norm``, as scalar tensors left on the device.
    ``loss_fn(params, batch, seed)`` returns ``(loss, aux)``."""
    grad_fn = make_grad_fn(loss_fn)
    apply_fn = make_apply_fn(tx)

    def step(state: TrainState, batch, seed):
        loss, grads = grad_fn(state.params, batch, seed)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return apply_fn(state, grads), metrics

    return step
