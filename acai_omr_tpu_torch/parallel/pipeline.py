"""Pipeline-parallel decoder training over a mesh axis (the twin of the JAX
package's ``parallel/pipeline.py``).

The decoder's stacked layer axis is cut into S contiguous stages, S the size
of the stage axis, and a GPipe schedule runs the microbatches through them:
at tick t stage s runs microbatch t - s through its L / S layers (the port's
decoder stack: the fused kernels on the card), and its output hops to stage
s + 1's device. The bubble ticks, where t - s is no microbatch, are skipped
(JAX computes them on clipped indices and discards them: the values are the
same). Autograd runs the backward through the schedule in reverse.

The loss is the exact global teacher-forced CE, ``sum / max(count, 1)``
over every data shard's rows. With a data axis each data coordinate
pipelines its own rows on its own stage devices, and its gradients and
(sum, count) go into one flat buffer that a single K15 launch sums across
the data shards (``parallel/trainer``'s data-parallel reduction). There is
no dropout on this path, as in JAX.

The staged parameters keep the JAX layout, blocks ``(S, L / S, ...)``; they
live on the mesh's first device. Each data coordinate takes a copy on its
first stage's device (``mesh.replicated``: none where the devices are one),
and its gradients land there; a stage's slice, and the final norm and
unembedding for the last stage, run on their stage's device (the same
tensor where every shard shares one card, a copy per use across cards,
whose backward carries the gradient home).
"""

from __future__ import annotations

import torch

from .mesh import MODEL_AXIS, on_device, replicated
from .trainer import (AdamW, TrainState, data_axis_size, dp_mean,
                      flat_mean_grads, global_norm, make_apply_fn, tree_map)

Params = dict


def split_stages(stacked: Params, n_stages: int) -> Params:
    """(L, ...) stacked layer leaves -> (S, L / S, ...) stage-major views."""
    def f(leaf):
        l = leaf.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} stages")
        return leaf.reshape(n_stages, l // n_stages, *leaf.shape[1:])
    return tree_map(f, stacked)


def merge_stages(stacked: Params) -> Params:
    """The inverse of :func:`split_stages`."""
    return tree_map(lambda x: x.reshape(x.shape[0] * x.shape[1],
                                        *x.shape[2:]), stacked)


def pp_param_specs(params: Params, stage_axis: str) -> Params:
    """The decoder's specs: blocks split on their leading (stage) axis,
    everything else (embeddings, final norm, unembed) replicated."""
    specs = tree_map(lambda _: (), params)
    specs["blocks"] = tree_map(lambda _: (stage_axis,), params["blocks"])
    return specs


def stage_params(params: Params, cfg, mesh, stage_axis: str) -> Params:
    """The decoder with its blocks cut into ``mesh.shape[stage_axis]``
    stages, every leaf an owned copy on the mesh's first device."""
    del cfg
    dev = mesh.devices[0][0]
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = split_stages(params["blocks"], mesh.shape[stage_axis])
    return tree_map(lambda v: v.detach().to(dev).clone(), out)


def unstage_params(params: Params) -> Params:
    """Back to the (L, ...) stacked layout (checkpoints, the unpipelined
    forward)."""
    out = dict(params)
    out["blocks"] = merge_stages(params["blocks"])
    return out


def _check_axes(mesh, stage_axis: str, data_axis: str | None):
    """The stages run over the mesh's ``model`` axis, the data shards over
    its ``data`` axis (the layout of JAX's pipeline tests), of 1, 2 or 4
    shards."""
    if stage_axis != MODEL_AXIS:
        raise ValueError(f"the stages run over {MODEL_AXIS!r}, not "
                         f"{stage_axis!r}")
    if data_axis is not None:
        data_axis_size(mesh, data_axis)


def _local_sums(cfg, params_pp: Params, batch, devs: list, n_micro: int,
                label_smoothing: float, compute_dtype):
    """One data coordinate's pipelined (nll_sum, token_count) over its rows,
    differentiable."""
    from ..models import omr_decoder, vitomr
    from ..ops import nn, transformer

    seqs_in, seqs_tgt, lmx_valid, latent, latent_valid = batch
    s_n = len(devs)
    b = seqs_in.shape[0]
    if b % n_micro:
        raise ValueError(f"local batch {b} does not divide into {n_micro} "
                         f"microbatches")
    chunks = lambda x: None if x is None else x.chunk(n_micro)
    with on_device(devs[0]):
        x = omr_decoder.embed_tokens(params_pp, seqs_in.to(devs[0]),
                                     compute_dtype)
    xm, lv, mem, mv = (chunks(a) for a in (x, lmx_valid, latent,
                                            latent_valid))
    stages = [tree_map(lambda v, s=s: v[s].to(devs[s]), params_pp["blocks"])
              for s in range(s_n)]
    hop, outs = [None] * s_n, [None] * n_micro
    for tick in range(n_micro + s_n - 1):
        # the last stage first: stage s reads the hop stage s - 1 wrote on
        # the previous tick before this tick's overwrites it
        for s in reversed(range(s_n)):
            m = tick - s
            if not 0 <= m < n_micro:
                continue  # a bubble tick
            dev = devs[s]
            x_in = xm[m] if s == 0 else hop[s]
            mem_m = mem[m].to(dev, compute_dtype)
            ones = lambda *shape: torch.ones(shape, dtype=torch.bool,
                                             device=dev)
            with on_device(dev):
                y = transformer.decoder_stack(
                    stages[s], x_in,
                    transformer.precompute_memory_kv(stages[s], mem_m),
                    lv[m].to(dev) if lv is not None
                    else ones(*x_in.shape[:2]),
                    mv[m].to(dev) if mv is not None
                    else ones(*mem_m.shape[:2]),
                    cfg.num_heads)
            if s + 1 < s_n:
                hop[s + 1] = y.to(devs[s + 1])
            else:
                outs[m] = y
    ys = torch.stack(outs)                     # (n_micro, mb, T, E)
    last = tree_map(lambda v: v.to(devs[-1]), {
        k: params_pp[k] for k in ("final_norm", "unembed")})
    tgt = seqs_tgt.to(devs[-1]).reshape(n_micro, b // n_micro,
                                        *seqs_tgt.shape[1:])
    with on_device(devs[-1]):
        h = nn.layernorm(last["final_norm"], ys, eps=1e-6)
        logits = nn.dense(last["unembed"], h).float()
        return vitomr.omr_ce_loss(logits, tgt, cfg.pad_idx, label_smoothing,
                                  reduction="sum")


def _data_shards(mesh, batch, data_axis: str | None):
    """(rows, stage devices) of each data coordinate: the batch cut over
    the data axis, or whole on data coordinate 0 without one."""
    if data_axis is None:
        return [(batch, list(mesh.devices[0]))]
    n = mesh.shape[data_axis]
    for a in batch:
        if a is not None and a.shape[0] % n:
            raise ValueError(f"a batch of {a.shape[0]} rows does not split "
                             f"over {n} data shards")
    cut = [a.chunk(n) if a is not None else [None] * n for a in batch]
    return [(tuple(c[d] for c in cut), list(mesh.devices[d]))
            for d in range(n)]


def make_pp_loss_fn(cfg, mesh, *, stage_axis: str,
                    data_axis: str | None = None, n_micro: int = 4,
                    label_smoothing: float = 0.0,
                    compute_dtype=torch.float32):
    """``loss_fn(params_pp, seqs_in, seqs_tgt, lmx_valid, latent,
    latent_valid) -> mean CE``, the pipelined teacher-forced decoder loss
    (``params_pp`` from :func:`stage_params`; each data shard's rows must
    divide by ``n_micro``). Without a data axis it is differentiable; with
    one it is the value (the data shards' sums through K15), and
    :func:`make_pp_grad_fn` gives the gradients."""
    _check_axes(mesh, stage_axis, data_axis)

    def loss_fn(params_pp, seqs_in, seqs_tgt, lmx_valid, latent,
                latent_valid):
        batch = (seqs_in, seqs_tgt, lmx_valid, latent, latent_valid)
        shards = _data_shards(mesh, batch, data_axis)
        if len(shards) == 1:
            nll, cnt = _local_sums(cfg, params_pp, *shards[0], n_micro,
                                   label_smoothing, compute_dtype)
            return nll / cnt.clamp_min(1.0)
        copies = replicated(mesh, params_pp)
        with torch.no_grad():
            return dp_mean(mesh, [
                _local_sums(cfg, copies[d], rows, devs, n_micro,
                            label_smoothing, compute_dtype)
                for d, (rows, devs) in enumerate(shards)])

    return loss_fn


def make_pp_grad_fn(cfg, mesh, *, stage_axis: str,
                    data_axis: str | None = None, n_micro: int = 4,
                    label_smoothing: float = 0.0,
                    compute_dtype=torch.float32):
    """``grad_fn(params_pp, batch) -> (mean loss, grads_pp)``, ``batch =
    (seqs_in, seqs_tgt, lmx_valid, latent, latent_valid)``; the gradients
    keep the staged layout (views into one flat buffer). Each data shard
    differentiates its pipelined CE sum into its buffer; one K15 launch
    sums the buffers over the data axis; one divide by max(count, 1)."""
    _check_axes(mesh, stage_axis, data_axis)

    def grad_fn(params_pp, batch):
        shards = _data_shards(mesh, batch, data_axis)
        copies = [params_pp] if data_axis is None \
            else replicated(mesh, params_pp)
        return flat_mean_grads(
            mesh, copies,
            lambda d, p: _local_sums(cfg, p, *shards[d], n_micro,
                                     label_smoothing, compute_dtype))

    return grad_fn


def make_pp_train_step(cfg, tx: AdamW, mesh, *, stage_axis: str,
                       data_axis: str | None = None, n_micro: int = 4,
                       label_smoothing: float = 0.0,
                       compute_dtype=torch.float32):
    """``step(state, batch) -> (state, metrics)``: the pipelined gradients
    and one update of the staged parameters (``state`` from
    ``create_train_state(stage_params(...), tx)``; AdamW is elementwise, so
    the staged layout stays); ``metrics``: the exact global mean CE and
    ``grad_norm``."""
    grad_fn = make_pp_grad_fn(cfg, mesh, stage_axis=stage_axis,
                              data_axis=data_axis, n_micro=n_micro,
                              label_smoothing=label_smoothing,
                              compute_dtype=compute_dtype)
    apply_fn = make_apply_fn(tx)

    def step(state: TrainState, batch):
        loss, grads = grad_fn(state.params, batch)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return apply_fn(state, grads), metrics

    return step
