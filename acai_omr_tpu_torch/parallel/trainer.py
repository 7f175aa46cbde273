"""Functional training: optimizer, train state, gradient and apply steps
over the parameter dict, on one device or data-parallel over a mesh.

The twin of the JAX package's ``parallel/trainer.py``. The
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


# ---------------------------------------------------------------------------
# accumulation windows
# ---------------------------------------------------------------------------

def accumulate_grads(acc, grads):
    """The tree sum ``acc + grads`` (``acc`` None starts the window)."""
    if acc is None:
        return grads
    return tree_map(torch.add, acc, grads)


def stack_microbatches(batches: list) -> dict:
    """Same-shaped microbatch dicts stacked on a new leading axis (the
    ``batches`` of :func:`make_window_step_fn`); a leaf that is not a
    tensor (a float such as ``tf_prob``) must agree and is kept as it is."""
    out = {}
    for k, v in batches[0].items():
        if torch.is_tensor(v):
            out[k] = torch.stack([b[k] for b in batches])
        elif any(b[k] != v for b in batches):
            raise ValueError(f"microbatches disagree on {k!r}")
        else:
            out[k] = v
    return out


def _window_grads(grad_fn, params: Params, batches: dict, seed: int, n: int):
    """The gradients of ``n`` stacked microbatches added in order into a
    zeroed accumulator (microbatch i with the i-th of ``n`` seeds folded
    from ``seed``, JAX's ``random.split``), and their losses."""
    from ..ops.dropout_kernel import fold_seed
    acc = tree_map(torch.zeros_like, params)
    accs = list(tree_flatten(acc).values())
    losses = []
    for i in range(n):
        mb = {k: v[i] if torch.is_tensor(v) else v
              for k, v in batches.items()}
        loss, grads = grad_fn(params, mb, fold_seed(seed, 30, i)[0])
        torch._foreach_add_(accs, list(tree_flatten(grads).values()))
        losses.append(loss)
    return acc, torch.stack(losses)


def make_window_step_fn(loss_fn: Callable, tx: AdamW, accum: int):
    """One optimizer window over ``accum`` same-shaped microbatches:
    ``step(state, batches, seed, scale=1.0) -> (state, losses)``, where
    ``batches`` carries the microbatches on a leading ``(accum,)`` axis
    (:func:`stack_microbatches`): their gradients summed from zero in
    order, then one update on the sum times ``scale`` (the adds and the
    update of the host-driven window)."""
    grad_fn = make_grad_fn(loss_fn)
    apply_fn = make_apply_fn(tx)

    def step(state: TrainState, batches: dict, seed: int, scale=1.0):
        acc, losses = _window_grads(grad_fn, state.params, batches, seed,
                                    accum)
        return apply_fn(state, acc, float(scale)), losses

    return step


def make_accum_train_step(loss_fn: Callable, tx: AdamW,
                          num_microbatches: int):
    """``step(state, batch, seed) -> (state, metrics)`` over a batch whose
    leaves carry a leading ``(num_microbatches, ...)`` axis: the
    microbatches' gradients summed from zero in order, divided by their
    count, one update; ``metrics``: the mean loss and ``grad_norm`` of the
    mean gradients."""
    grad_fn = make_grad_fn(loss_fn)
    apply_fn = make_apply_fn(tx)

    def step(state: TrainState, batch: dict, seed: int):
        acc, losses = _window_grads(grad_fn, state.params, batch, seed,
                                    num_microbatches)
        torch._foreach_div_(list(tree_flatten(acc).values()),
                            float(num_microbatches))
        metrics = {"loss": losses.sum() / num_microbatches,
                   "grad_norm": global_norm(acc)}
        return apply_fn(state, acc), metrics

    return step


# ---------------------------------------------------------------------------
# data parallelism: one controller, K15 sums the data shards
# ---------------------------------------------------------------------------
#
# Each data shard runs the single-device step (the fused stacks' kernels and
# their hand-written backward included) on its rows and differentiates its
# local SUM. Its gradients land in one flat fp32 buffer: every leaf's .grad
# is a view into it, so autograd adds each leaf's gradient in place as it is
# produced, and the loss sum and weight follow the leaves, padded to a
# multiple of 8. One K15 launch (tp_allreduce, its one-card "local" form
# where the shards share a card) sums the shards' buffers into shard 0's in
# place; the gradients, views into it, are divided by max(weight, 1): the exact global
# masked mean of JAX's psum reduction, whatever the spread of valid tokens
# over the shards (an all-padding batch gives zero gradients, not NaN).

def shard_rng(rng, d: int, device):
    """Data shard ``d``'s randomness: ``seed + d`` for an integer seed (the
    dropout masks and Gumbel draws), a generator on ``device`` seeded from
    ``rng``'s seed + d for a ``torch.Generator`` (the MAE's masks), None
    for None."""
    if rng is None:
        return None
    if isinstance(rng, torch.Generator):
        return torch.Generator(device=device).manual_seed(
            (rng.initial_seed() + d) % (2 ** 63))
    return rng + d


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


class FlatGrads:
    """One shard's flat fp32 buffer: ``regions`` runs of the leaves at
    ``paths`` (the gradients, and GRPO's CE-anchor gradients), then
    ``n_extra`` scalars, padded to a multiple of 8. ``bind(params, r)``
    gives leaf copies (``detach``) whose ``.grad`` are views into run r, so
    a backward with ``inputs=`` adds into the buffer in place."""

    def __init__(self, params: Params, paths, n_extra: int, device,
                 regions: int = 1):
        flat = tree_flatten(params)
        self.paths = list(paths)
        self.shapes = [flat[p].shape for p in self.paths]
        self.sizes = [flat[p].numel() for p in self.paths]
        self.n = sum(self.sizes)
        self.regions = regions
        self.buf = torch.zeros(_pad8(regions * self.n + n_extra),
                               dtype=torch.float32, device=device)

    def views(self, buf: torch.Tensor | None = None, region: int = 0) -> dict:
        buf = self.buf if buf is None else buf
        out, off = {}, region * self.n
        for p, shape, size in zip(self.paths, self.shapes, self.sizes):
            out[p] = buf[off:off + size].view(shape)
            off += size
        return out

    def bind(self, params: Params, region: int = 0) -> dict:
        flat = tree_flatten(params)
        leaves = {}
        for p, view in self.views(region=region).items():
            leaf = flat[p].detach()
            if leaf.dtype != torch.float32:
                raise ValueError(f"{p}: the data-parallel step takes fp32 "
                                 f"parameters, got {leaf.dtype}")
            leaf.requires_grad_(True)
            leaf.grad = view
            leaves[p] = leaf
        return leaves

    def extra(self, i: int) -> int:
        """The buffer index of scalar ``i``."""
        return self.regions * self.n + i

    def set_extra(self, i: int, value) -> None:
        self.buf[self.extra(i)] = value.detach().to(self.buf.device) \
            if torch.is_tensor(value) else float(value)


def data_axis_size(mesh, axis: str = "data") -> int:
    """The data shards of ``mesh``: ``axis`` must be its data axis, of 1, 2
    or 4 shards (the sizes K15 takes for the sum, raised otherwise)."""
    from .mesh import DATA_AXIS
    if axis != DATA_AXIS:
        raise ValueError(f"the data-parallel steps shard over "
                         f"{DATA_AXIS!r}, not {axis!r}")
    n = mesh.shape[axis]
    if n > 1:
        mesh.dp_group()
    return n


def dp_sum(mesh, bufs: list) -> torch.Tensor:
    """The sum over the data shards of one flat fp32 buffer each, into the
    first buffer in place: one K15 launch over the data group (the buffers
    as ``(1, N)`` rows, rank 0's output alone written); a single buffer is
    its own sum. Returns ``bufs[0]``."""
    from ..ops.tp_allreduce_kernel import tp_allreduce
    if len(bufs) > 1:
        tp_allreduce([b.view(1, -1) for b in bufs], mesh.dp_group(),
                     root_only=True)
    return bufs[0]


def dp_mean(mesh, pairs: list) -> torch.Tensor:
    """``sum / max(weight, 1)`` over the data shards' (sum, weight) pairs,
    the pairs summed as one padded buffer a shard."""
    bufs = []
    for d, (s, w) in enumerate(pairs):
        dev = mesh.devices[d][0]
        buf = torch.zeros(8, dtype=torch.float32, device=dev)
        buf[:2] = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                               .to(dev) for v in (s, w)])
        bufs.append(buf)
    total = dp_sum(mesh, bufs)
    return total[0] / total[1].clamp_min(1.0)


def flat_mean_grads(mesh, shard_params: list, sum_fn: Callable):
    """The global mean and its gradients over the data shards:
    ``sum_fn(d, params) -> (sum, weight)`` of shard d is differentiated
    into its flat buffer (``shard_params[d]``, on its device, bound to it),
    one K15 launch sums the buffers, one divide by max(weight, 1). Returns
    (mean, gradient tree of views into the sum)."""
    from .mesh import on_device
    paths = list(tree_flatten(shard_params[0]))
    flats = []
    for d, params in enumerate(shard_params):
        dev = mesh.devices[d][0]
        fg = FlatGrads(params, paths, 2, dev)
        leaves = fg.bind(params)
        with on_device(dev):
            s, w = sum_fn(d, tree_unflatten(leaves))
        torch.autograd.backward(s, inputs=list(leaves.values()))
        fg.set_extra(0, s)
        fg.set_extra(1, w)
        flats.append(fg)
    total = dp_sum(mesh, [fg.buf for fg in flats])
    fg = flats[0]
    w = total[fg.extra(1)].clamp_min(1.0)
    total[:fg.n].div_(w)
    return total[fg.extra(0)] / w, tree_unflatten(fg.views(total))


def make_sharded_grad_fn(sum_loss_fn: Callable, mesh, axis: str = "data"):
    """The data-parallel :func:`make_grad_fn`: ``sum_loss_fn(params, batch,
    rng) -> (loss_sum, weight)``; ``grad_fn(params, batch, rng) -> (global
    mean loss, its gradients)``, :func:`flat_mean_grads` of the shards'
    sums, the gradients views into one flat buffer. Every batch tensor with
    a leading dim is cut over the data shards (it must divide), the
    parameters are shared (copied once per distinct device), shard d draws
    from ``rng + d``."""
    from .mesh import data_sharding, replicated
    data_axis_size(mesh, axis)  # the data-axis rule, before any work

    def grad_fn(params: Params, batch: dict, rng):
        shards = data_sharding(mesh, batch)
        return flat_mean_grads(
            mesh, replicated(mesh, params),
            lambda d, p: sum_loss_fn(p, shards[d], shard_rng(
                rng, d, mesh.devices[d][0])))

    return grad_fn


def make_sharded_grad_acc_fn(sum_loss_fn: Callable, mesh, axis: str = "data"):
    """The data-parallel :func:`make_grad_acc_fn`: ``grad_acc_fn(params,
    batch, rng, acc) -> (loss, acc)`` with the global mean's gradients added
    into ``acc`` in place."""
    run = make_sharded_grad_fn(sum_loss_fn, mesh, axis=axis)

    def grad_acc_fn(params, batch, rng, acc):
        loss, grads = run(params, batch, rng)
        torch._foreach_add_(list(tree_flatten(acc).values()),
                            list(tree_flatten(grads).values()))
        return loss, acc

    return grad_acc_fn


def make_sharded_train_step(sum_loss_fn: Callable, tx: AdamW, mesh,
                            axis: str = "data"):
    """The data-parallel :func:`make_train_step`: ``step(state, batch,
    rng) -> (state, metrics)``, the sharded gradients then one update of
    the shared parameters."""
    run = make_sharded_grad_fn(sum_loss_fn, mesh, axis=axis)
    apply_fn = make_apply_fn(tx)

    def step(state: TrainState, batch, rng):
        loss, grads = run(state.params, batch, rng)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return apply_fn(state, grads), metrics

    return step


def make_sharded_eval_fn(sum_eval_fn: Callable, mesh, axis: str = "data"):
    """Data-parallel evaluation: ``sum_eval_fn(params, batch, rng) -> (sum,
    weight)`` per shard, no gradient; ``eval_fn(params, batch, rng=None) ->
    sum / max(weight, 1)`` over all shards (one K15 sum of the pairs)."""
    from .mesh import data_sharding, on_device, replicated
    data_axis_size(mesh, axis)

    def shard_sums(params, batch, d, rng):
        dev = mesh.devices[d][0]
        with on_device(dev):
            return sum_eval_fn(params, batch, shard_rng(rng, d, dev))

    @torch.no_grad()
    def eval_fn(params, batch, rng=None):
        shards = data_sharding(mesh, batch)
        copies = replicated(mesh, params)
        return dp_mean(mesh, [shard_sums(copies[d], shards[d], d, rng)
                              for d in range(len(shards))])

    return eval_fn
