"""The two training stacks, forward with saves and hand-written backward.

Port of the JAX package's ``ops/pallas_train_layer.py``: ``encoder_stack_fused``
and ``decoder_stack_fused`` there run a whole post-norm stack as one Pallas
grid per pass (``_fwd_kernel``, ``_bwd_kernel``) under a ``custom_vjp``. Here a
stack is a ``torch.autograd.Function`` whose forward and backward are
sequences of launches of the hand-written kernels, layer by layer:

    forward, per layer (decoder; the encoder has no cross stage)
      qkv = K1(x, Wqkv)                         a_s = K3(qkv, causal)
      x1, z1 = K4(x, K1(a_s, Wo, drop 0))
      qc = K1(x1, Wqc)                          a_c = K3(qc, mem_kv[l])
      x2, z2 = K4(x1, K1(a_c, Woc, drop 1))
      h1, gelu' = K1(x2, W1, gelu, drop 2)
      out, z3 = K4(x2, K1(h1, W2, drop 3))
    saved per layer: x, z1, z2, z3, h1, gelu', qkv

    backward, per layer in reverse (K7 attention_bwd, K8 layernorm_bwd,
    K9 linear_dgrad / linear_wgrad; x1, x2, qc and the two attention outputs
    are recomputed with K4, K1 and K3, which gives the forward's bits)

Dropout (K10's mask, see :mod:`.dropout_kernel`) sits in the epilogue of the
K1 launch that produces ``sa``, ``ca``, ``h1`` and ``ff`` in the forward, and
in the epilogues of K8 and K9 in the backward; no mask is stored. Site ``s``
of layer ``l`` draws from stream ``l * 8 + s``, keyed on the image's index in
the batch and the element's row and column.

Which stacks take this path: the JAX package gates its fused stacks with
``enabled_for`` (decoder) and ``enabled_for_enc`` (encoder; it also admits
head dims below 64, which is how the MAE decoder's 16 heads of 32 reach the
fused kernel there). Here the gate is what the wrappers check and raise on:
head dim 64 or 32 (K3, K7), row counts and widths that are multiples of the
kernels' tiles (K1 / K9: 64; K4: E % 32; K8: E % 128, both E <= 1024),
sequence lengths that are multiples of 64. Both of the MAE's stacks and both
of the flagship's pass; nothing falls back to another path on the card.

Every op is a :class:`._build.KernelOp`: CUDA tensors launch the kernels, CPU
tensors run the plain twins, so the hand-written backward can be checked on
the CPU against autograd. ``plain=True`` runs the forward through the plain
twins on any device and leaves the gradient to autograd: the yardstick the
kernel path is held against on the card, and the path CPU callers take.

The weight gradients are summed in fp32 over all rows and rounded once (the
TPU kernel adds one rounded partial per batch tile into a compute-dtype
accumulator); they return in the compute dtype and autograd casts them to
the fp32 masters.

The JAX package chooses between two schedules of the same gradients,
``_bwd_kernel`` and ``_bwd_split_kernel``, with ``ACAI_BWD_SPLIT``. The sweep
here is always the split schedule (:func:`_backward`), so that switch has no
counterpart, and neither has its VMEM gate (``bwd_split_fits``).

:func:`set_ablate` stubs stages of the hand-written backward, as the JAX
package's ``set_ablate`` stubs those of ``_bwd_kernel`` for
``tools/bwd_vmem_probe.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import dropout_kernel as dk
from .attention_bwd_kernel import attention_bwd
from .encoder_stack_kernel import encoder_attention, split_qkv
from .layernorm_bwd_kernel import layernorm_bwd
from .layernorm_kernel import add_layernorm
from .linear_bwd_kernel import linear_dgrad, linear_wgrad
from .linear_kernel import linear_bias_act

Params = dict
LN_EPS = 1e-5
# dropout sites of a layer (the stream is layer * 8 + site)
SITE_SA, SITE_CA, SITE_H1, SITE_FF = 0, 1, 2, 3

# stages of the backward that set_ablate may stub; "attnonly" is accepted
# and stubs nothing, as no branch of the JAX kernel reads it
ABLATE_MODES = ("full", "nocross", "noself", "noffn", "attnonly")
_ABLATE = "full"


def set_ablate(mode: str) -> None:
    """Stub one stage of the hand-written backward (``tools/bwd_vmem_probe``):
    ``noffn`` skips the FFN's launches (the x2 recompute, K9 products) and
    passes dx2 = dz3 on, with zero FFN weight and bias gradients; ``nocross``
    skips the cross-attention's (the x1 / qc recompute, K3, K7, its K9
    products): zero d(mem_kv), d(w_qc), d(b_qc), d(w_oc), dx1 = dz2, while
    d(b_oc) stays the sum of dca; ``noself`` the self-attention's: zero
    d(w_qkv), d(b_qkv), d(w_out), dx = dz1, while d(b_out) stays the sum of
    dsa. Those are the values ``pallas_train_layer._bwd_kernel``'s branches
    leave. ``full`` (the default) and ``attnonly`` stub nothing. Callers set
    it back to ``full`` in a ``finally``."""
    global _ABLATE
    if mode not in ABLATE_MODES:
        raise ValueError(f"ablate mode must be one of {ABLATE_MODES}, got "
                         f"{mode!r}")
    _ABLATE = mode


@dataclasses.dataclass(frozen=True)
class _Ops:
    lin: object
    attn: object
    ln: object
    ln_bwd: object
    dgrad: object
    wgrad: object
    attn_bwd: object


KERNEL_OPS = _Ops(linear_bias_act, encoder_attention, add_layernorm,
                  layernorm_bwd, linear_dgrad, linear_wgrad, attention_bwd)
PLAIN_OPS = _Ops(*(getattr(KERNEL_OPS, f.name).plain
                   for f in dataclasses.fields(_Ops)))

_ENC_KEYS = ("w_qkv", "b_qkv", "w_out", "b_out", "w_ff1", "b_ff1", "w_ff2",
             "b_ff2", "ln_sa_g", "ln_sa_b", "ln_ff_g", "ln_ff_b")
_DEC_KEYS = _ENC_KEYS + ("w_qc", "b_qc", "w_oc", "b_oc", "ln_ca_g", "ln_ca_b")


def _common(stacked: Params, dtype, ff_norm: str) -> Params:
    sa = stacked["self_attn"]
    w = lambda a: a.to(dtype).contiguous()
    f32 = lambda a: a.float().contiguous()
    return {
        "w_qkv": w(sa["in_kernel"]), "b_qkv": f32(sa["in_bias"]),
        "w_out": w(sa["out"]["kernel"]), "b_out": f32(sa["out"]["bias"]),
        "w_ff1": w(stacked["linear1"]["kernel"]),
        "b_ff1": f32(stacked["linear1"]["bias"]),
        "w_ff2": w(stacked["linear2"]["kernel"]),
        "b_ff2": f32(stacked["linear2"]["bias"]),
        "ln_sa_g": f32(stacked["norm1"]["scale"]),
        "ln_sa_b": f32(stacked["norm1"]["bias"]),
        "ln_ff_g": f32(stacked[ff_norm]["scale"]),
        "ln_ff_b": f32(stacked[ff_norm]["bias"]),
    }


def pack_weights_enc(stacked: Params, dtype) -> Params:
    """Stacked encoder-layer params -> the kernels' operands: weights in the
    compute dtype, biases and LayerNorm vectors in fp32 (as the JAX kernel's
    fp32 ``vecs`` plane). Differentiable: gradients flow back to the
    masters through the casts."""
    return _common(stacked, dtype, "norm2")


def pack_weights(stacked: Params, dtype) -> Params:
    """The decoder's operands. The cross-attention in-projection contributes
    only its q columns; its k/v columns act through the precomputed
    ``mem_kv`` (:func:`.transformer.precompute_memory_kv`)."""
    ca = stacked["cross_attn"]
    e = ca["out"]["kernel"].shape[1]
    p = _common(stacked, dtype, "norm3")
    p.update({
        "w_qc": ca["in_kernel"][:, :, :e].to(dtype).contiguous(),
        "b_qc": ca["in_bias"][:, :e].float().contiguous(),
        "w_oc": ca["out"]["kernel"].to(dtype).contiguous(),
        "b_oc": ca["out"]["bias"].float().contiguous(),
        "ln_ca_g": stacked["norm2"]["scale"].float().contiguous(),
        "ln_ca_b": stacked["norm2"]["bias"].float().contiguous(),
    })
    return p


@dataclasses.dataclass(frozen=True)
class _Meta:
    """What a pass needs beside its tensors."""
    ops: _Ops
    keys: tuple
    b: int
    t: int
    num_heads: int
    causal: bool
    self_valid: torch.Tensor
    mem_valid: torch.Tensor | None
    drop: dk.DropSpec | None  # stream is set per site

    @property
    def cross(self) -> bool:
        return self.mem_valid is not None

    def site(self, layer: int, site: int):
        return None if self.drop is None else self.drop.at(layer * 8 + site)


def _forward(m: _Meta, w: Params, x: torch.Tensor, mem_kv, save: bool):
    """x (B*T, E) -> (out (B*T, E), per-layer saves or None)."""
    ops, h = m.ops, m.num_heads
    saves = [] if save else None

    def ln(a, r, gamma, beta):  # -> (LN(a + r), the sum when it is saved)
        out = ops.ln(a, r, gamma, beta, LN_EPS, save)
        return out if save else (out, None)

    for l in range(w["w_qkv"].shape[0]):
        qkv = ops.lin(x, w["w_qkv"][l], w["b_qkv"][l])
        a_s = ops.attn(qkv, m.self_valid, h, m.causal)
        sa = ops.lin(a_s, w["w_out"][l], w["b_out"][l], "none",
                     m.site(l, SITE_SA))
        x1, z1 = ln(x, sa, w["ln_sa_g"][l], w["ln_sa_b"][l])
        z2 = None
        x2 = x1
        if m.cross:
            qc = ops.lin(x1, w["w_qc"][l], w["b_qc"][l])
            a_c = ops.attn(qc, m.mem_valid, h, False, mem_kv[l])
            ca = ops.lin(a_c, w["w_oc"][l], w["b_oc"][l], "none",
                         m.site(l, SITE_CA))
            x2, z2 = ln(x1, ca, w["ln_ca_g"][l], w["ln_ca_b"][l])
        h1 = ops.lin(x2, w["w_ff1"][l], w["b_ff1"][l], "gelu",
                     m.site(l, SITE_H1), save)
        gp = None
        if save:
            h1, gp = h1
        ff = ops.lin(h1, w["w_ff2"][l], w["b_ff2"][l], "none",
                     m.site(l, SITE_FF))
        out, z3 = ln(x2, ff, w["ln_ff_g"][l], w["ln_ff_b"][l])
        if save:
            saves.append((x, z1, z2, z3, h1, gp, qkv))
        x = out
    return x, saves


def _backward(m: _Meta, w: Params, mem_kv, saves, g: torch.Tensor,
              need_dx: bool):
    """The reverse sweep -> (dx or None, d(mem_kv) or None, {key: grad}).

    Layer by layer in reverse, phase 0 (the FFN backward over all rows) and
    then phase 1 (the cross- and the self-attention backward): the schedule
    of the JAX package's ``_bwd_split_kernel``, always: the port has no
    ``ACAI_BWD_SPLIT``. ``_bwd_kernel`` computes the same gradients tile by
    tile; the phases here are whole launches of K7-K10, so nothing is held back
    between them."""
    ops, h, b, t = m.ops, m.num_heads, m.b, m.t
    e = g.shape[1]
    d = {k: torch.empty_like(v) for k, v in w.items()}
    d_mem = torch.empty_like(mem_kv) if m.cross else None
    as3 = lambda a: a.view(b, t, a.shape[1])
    for l in reversed(range(len(saves))):
        x, z1, z2, z3, h1, gp, qkv = saves[l]
        # LN(ff residual) + FFN
        dz3, dff, d["ln_ff_g"][l], d["ln_ff_b"][l] = ops.ln_bwd(
            g, z3, w["ln_ff_g"][l], LN_EPS, m.site(l, SITE_FF))
        if _ABLATE == "noffn":
            for k in ("w_ff2", "b_ff2", "w_ff1", "b_ff1"):
                d[k][l].zero_()
            dx2 = dz3
        else:
            if m.cross:
                x2 = ops.ln(z2, None, w["ln_ca_g"][l], w["ln_ca_b"][l],
                            LN_EPS)
            else:
                x2 = ops.ln(z1, None, w["ln_sa_g"][l], w["ln_sa_b"][l],
                            LN_EPS)
            ops.wgrad(h1, dff, d["w_ff2"][l], d["b_ff2"][l])
            du = ops.dgrad(dff, w["w_ff2"][l], m.site(l, SITE_H1), gp)
            ops.wgrad(x2, du, d["w_ff1"][l], d["b_ff1"][l])
            dx2 = ops.dgrad(du, w["w_ff1"][l], None, None, dz3)
        # LN(cross residual) + cross-attention
        if m.cross:
            dz2, dca, d["ln_ca_g"][l], d["ln_ca_b"][l] = ops.ln_bwd(
                dx2, z2, w["ln_ca_g"][l], LN_EPS, m.site(l, SITE_CA))
        if m.cross and _ABLATE == "nocross":
            for k in ("w_oc", "w_qc", "b_qc"):
                d[k][l].zero_()
            d["b_oc"][l] = dca.float().sum(0)
            d_mem[l].zero_()
            dx1 = dz2
        elif m.cross:
            x1 = ops.ln(z1, None, w["ln_sa_g"][l], w["ln_sa_b"][l], LN_EPS)
            qc = ops.lin(x1, w["w_qc"][l], w["b_qc"][l])
            a_c = ops.attn(qc, m.mem_valid, h, False, mem_kv[l])
            da_c = ops.dgrad(dca, w["w_oc"][l])
            dqc = torch.empty_like(qc)
            q3, k3, v3 = split_qkv(qc, mem_kv[l], b)
            ops.attn_bwd(q3, k3, v3, as3(da_c), m.mem_valid, h, False,
                         as3(dqc), *d_mem[l].split(e, dim=-1))
            ops.wgrad(a_c, dca, d["w_oc"][l], d["b_oc"][l])
            ops.wgrad(x1, dqc, d["w_qc"][l], d["b_qc"][l])
            dx1 = ops.dgrad(dqc, w["w_qc"][l], None, None, dz2)
        else:
            dx1 = dx2
        # LN(self residual) + self-attention
        dz1, dsa, d["ln_sa_g"][l], d["ln_sa_b"][l] = ops.ln_bwd(
            dx1, z1, w["ln_sa_g"][l], LN_EPS, m.site(l, SITE_SA))
        if _ABLATE == "noself":
            for k in ("w_out", "w_qkv", "b_qkv"):
                d[k][l].zero_()
            d["b_out"][l] = dsa.float().sum(0)
            if l == 0 and not need_dx:
                return None, d_mem, d
            g = dz1
            continue
        a_s = ops.attn(qkv, m.self_valid, h, m.causal)
        da_s = ops.dgrad(dsa, w["w_out"][l])
        dqkv = torch.empty_like(qkv)
        ops.attn_bwd(*split_qkv(qkv, None, b), as3(da_s), m.self_valid, h,
                     m.causal, *as3(dqkv).split(e, dim=-1))
        ops.wgrad(a_s, dsa, d["w_out"][l], d["b_out"][l])
        ops.wgrad(x, dqkv, d["w_qkv"][l], d["b_qkv"][l])
        if l == 0 and not need_dx:
            return None, d_mem, d
        g = ops.dgrad(dqkv, w["w_qkv"][l], None, None, dz1)
    return g, d_mem, d


class _FusedStack(torch.autograd.Function):
    """forward(meta, x, mem_kv or None, *weights in meta.keys order)."""

    @staticmethod
    def forward(ctx, m: _Meta, x, mem_kv, *weights):
        w = dict(zip(m.keys, weights))
        out, saves = _forward(m, w, x, mem_kv, save=True)
        flat = [a for layer in saves for a in layer if a is not None]
        ctx.meta = m
        ctx.per_layer = 7 if m.cross else 6
        ctx.save_for_backward(*weights, *([mem_kv] if m.cross else []), *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        m = ctx.meta
        saved = list(ctx.saved_tensors)
        n = len(m.keys)
        w = dict(zip(m.keys, saved[:n]))
        mem_kv = saved[n] if m.cross else None
        flat = saved[n + m.cross:]
        saves = []
        for i in range(0, len(flat), ctx.per_layer):
            layer = flat[i:i + ctx.per_layer]
            if not m.cross:
                layer.insert(2, None)  # no z2
            saves.append(tuple(layer))
        dx, d_mem, d = _backward(m, w, mem_kv, saves, g.contiguous(),
                                 ctx.needs_input_grad[1])
        return (None, dx, d_mem, *(d[k] for k in m.keys))


def _drop_spec(rate: float, seeds, deterministic: bool, t: int):
    if deterministic or rate <= 0.0:
        return None
    if seeds is None:
        raise ValueError("dropout is on: pass seeds=(seed0, seed1)")
    return dk.DropSpec(float(rate), int(seeds[0]), int(seeds[1]), 0, t)


def _run(m: _Meta, w: Params, x: torch.Tensor, mem_kv, plain: bool):
    b, t, e = x.shape
    x2d = x.reshape(b * t, e).contiguous()
    if plain:
        out, _ = _forward(m, w, x2d, mem_kv, save=False)
    elif torch.is_grad_enabled() and any(
            a.requires_grad for a in (x2d, mem_kv, *w.values())
            if a is not None):
        out = _FusedStack.apply(m, x2d, mem_kv, *(w[k] for k in m.keys))
    else:
        out, _ = _forward(m, w, x2d, mem_kv, save=False)
    return out.reshape(b, t, e)


def encoder_stack_fused(stacked: Params, x: torch.Tensor, valid: torch.Tensor,
                        num_heads: int, dropout_rate: float = 0.0, seeds=None,
                        deterministic: bool = True,
                        plain: bool = False) -> torch.Tensor:
    """The encoder stack: x (B, T, E), valid (B, T) bool -> (B, T, E).

    Differentiable through the hand-written backward. When no input needs a
    gradient (validation, inference, the frozen prefix) the forward keeps no
    saves. ``seeds``: (seed0, seed1) of the dropout masks when
    ``deterministic`` is False and ``dropout_rate`` > 0. ``plain=True``: the
    plain twins on any device, gradients by autograd.
    """
    b, t, _ = x.shape
    m = _Meta(PLAIN_OPS if plain else KERNEL_OPS, _ENC_KEYS, b, t, num_heads,
              False, valid, None,
              _drop_spec(dropout_rate, seeds, deterministic, t))
    return _run(m, pack_weights_enc(stacked, x.dtype), x, None, plain)


def decoder_stack_fused(stacked: Params, x: torch.Tensor, mem_kv: torch.Tensor,
                        self_valid: torch.Tensor, mem_valid: torch.Tensor,
                        num_heads: int, dropout_rate: float = 0.0, seeds=None,
                        deterministic: bool = True,
                        plain: bool = False) -> torch.Tensor:
    """The decoder stack (causal self-attention, cross-attention over the
    precomputed ``mem_kv``): x (B, T, E), mem_kv (L, B, M, 2E), self_valid
    (B, T), mem_valid (B, M) -> (B, T, E). Gradients reach x, mem_kv and
    every stacked leaf. Other arguments as :func:`encoder_stack_fused`."""
    b, t, _ = x.shape
    m = _Meta(PLAIN_OPS if plain else KERNEL_OPS, _DEC_KEYS, b, t, num_heads,
              True, self_valid, mem_valid,
              _drop_spec(dropout_rate, seeds, deterministic, t))
    return _run(m, pack_weights(stacked, x.dtype), x,
                mem_kv.to(x.dtype).contiguous(), plain)
