"""Reference PyTorch state dicts <-> the port's parameter tree.

The twin of the JAX package's ``models/torch_compat.py``, for users of the
reference PyTorch implementation: the readers convert its ``MAE`` /
``ViTOMR`` state dicts (reference layouts: acai_omr/models/models.py:197-213,
381-428, 649-660) into the port's parameter tree (the JAX tree's names and
layouts: stacked ``(L, ...)`` layer leaves, dense kernels ``(in, out)``,
fused qkv ``in_kernel`` ``(L, E, 3E)``), including the ``frozen_blocks`` /
``fine_tune_blocks`` split of ``FineTuneOMREncoder`` (models.py:334-360),
which maps back onto one stacked layer array. The writers are their exact
inverses: state dicts that load with ``strict=True`` into the reference's
modules.

A reader takes torch tensors (on any device) or numpy arrays, bf16 included
(``ml_dtypes.bfloat16`` arrays go through their 16-bit pattern, as
:func:`.weights.leaf_tensor` does), and keeps each leaf's dtype: a value is
carried over bit for bit. Its tree goes through
:func:`.weights.params_from_jax`, so a missing key raises and the tensors
land on ``device`` (``cuda`` unless the caller passes ``device="cpu"``). A
writer takes the port's tree (tensors, or numpy arrays) and gives
contiguous tensors of their own, in each leaf's dtype, on the leaves'
device.
"""

from __future__ import annotations

import re

import torch

from .weights import MAE_TEMPLATE, TEMPLATE, leaf_tensor, params_from_jax


def _t(leaf) -> torch.Tensor:
    return leaf_tensor(leaf).detach()


def _dense(sd, prefix):
    return {"kernel": _t(sd[prefix + ".weight"]).T.contiguous(),
            "bias": _t(sd[prefix + ".bias"])}


def _norm(sd, prefix):
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"])}


def _mha(sd, prefix):
    return {
        "in_kernel": _t(sd[prefix + ".in_proj_weight"]).T.contiguous(),
        "in_bias": _t(sd[prefix + ".in_proj_bias"]),
        "out": _dense(sd, prefix + ".out_proj"),
    }


def _stack(layers: list) -> dict:
    """Layer trees -> one tree of ``(L, ...)`` leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return torch.stack(layers)


def encoder_layer_from_torch(sd, prefix: str) -> dict:
    return {
        "self_attn": _mha(sd, prefix + ".self_attn"),
        "norm1": _norm(sd, prefix + ".norm1"),
        "linear1": _dense(sd, prefix + ".linear1"),
        "linear2": _dense(sd, prefix + ".linear2"),
        "norm2": _norm(sd, prefix + ".norm2"),
    }


def decoder_layer_from_torch(sd, prefix: str) -> dict:
    return {
        "self_attn": _mha(sd, prefix + ".self_attn"),
        "norm1": _norm(sd, prefix + ".norm1"),
        "cross_attn": _mha(sd, prefix + ".multihead_attn"),
        "norm2": _norm(sd, prefix + ".norm2"),
        "linear1": _dense(sd, prefix + ".linear1"),
        "linear2": _dense(sd, prefix + ".linear2"),
        "norm3": _norm(sd, prefix + ".norm3"),
    }


def _layer_indices(sd, pattern: str) -> list[int]:
    rx = re.compile(re.escape(pattern) + r"\.(\d+)\.")
    return sorted({int(m.group(1)) for k in sd for m in [rx.search(k)] if m})


def _encoder_tree(sd, prefix: str) -> dict:
    p = prefix
    tree = {"pos_embedding": _t(sd[p + "pos_embedding"]),
            "projection": _dense(sd, p + "projection")}
    if any(k.startswith(p + "encoder_blocks.layers.") for k in sd):
        layers = [encoder_layer_from_torch(sd, f"{p}encoder_blocks.layers.{i}")
                  for i in _layer_indices(sd, p + "encoder_blocks.layers")]
        tree["final_norm"] = _norm(sd, p + "encoder_blocks.norm")
    else:
        layers = []
        for block in ("frozen_blocks", "fine_tune_blocks"):
            key = f"{p}{block}.layers"
            layers += [encoder_layer_from_torch(sd, f"{key}.{i}")
                       for i in _layer_indices(sd, key)]
        tree["final_norm"] = _norm(sd, p + "fine_tune_blocks.norm")
    tree["blocks"] = _stack(layers)
    return tree


def _decoder_tree(sd, prefix: str) -> dict:
    p = prefix
    layers = [decoder_layer_from_torch(sd, f"{p}decoder_blocks.layers.{i}")
              for i in _layer_indices(sd, p + "decoder_blocks.layers")]
    return {
        "vocab_embedding": {"table": _t(sd[p + "vocab_embedding.weight"])},
        "pos_embedding": _t(sd[p + "pos_embedding"]),
        "blocks": _stack(layers),
        "final_norm": _norm(sd, p + "decoder_blocks.norm"),
        "unembed": _dense(sd, p + "unembed"),
    }


def encoder_params_from_torch(sd, prefix: str = "", device=None) -> dict:
    """Encoder / OMREncoder / MAEEncoder state dict -> the encoder tree.

    Takes the plain ``encoder_blocks`` layout and the ``frozen_blocks`` +
    ``fine_tune_blocks`` layout of FineTuneOMREncoder (concatenated in depth
    order; the final norm lives on the last sub-stack)."""
    return params_from_jax(_encoder_tree(sd, prefix), device,
                           template=TEMPLATE["encoder"])


def mae_params_from_torch(sd, device=None) -> dict:
    """The reference ``MAE`` module's state dict -> the port's MAE tree."""
    dec_layers = [
        encoder_layer_from_torch(sd, f"decoder.decoder_blocks.layers.{i}")
        for i in _layer_indices(sd, "decoder.decoder_blocks.layers")]
    tree = {
        "encoder": _encoder_tree(sd, "encoder."),
        "decoder_embed": _dense(sd, "decoder_embed"),
        "decoder_blocks": _stack(dec_layers),
        "decoder_norm": _norm(sd, "decoder.decoder_blocks.norm"),
        "decoder_unembed": _dense(sd, "decoder_unembed"),
        "mask_token": _t(sd["mask_token"]).reshape(-1),
        "decoder_pos_embedding": _t(sd["decoder_pos_embedding"]),
    }
    return params_from_jax(tree, device, template=MAE_TEMPLATE)


def omr_decoder_params_from_torch(sd, prefix: str = "",
                                  device=None) -> dict:
    """OMRDecoder state dict -> the decoder tree."""
    return params_from_jax(_decoder_tree(sd, prefix), device,
                           template=TEMPLATE["decoder"])


def vitomr_params_from_torch(sd, device=None) -> dict:
    """A ViTOMR state dict (TeacherForced / ScheduledSampling / GRPO, plain
    or FineTune encoder) -> the port's ViTOMR tree. The nn.Sequential
    transition head's indices (0 = linear1, 3 = linear2; reference
    models.py:655-660) map onto named leaves."""
    tree = {
        "encoder": _encoder_tree(sd, "encoder."),
        "transition_head": {
            "linear1": _dense(sd, "transition_head.0"),
            "linear2": _dense(sd, "transition_head.3"),
        },
        "decoder": _decoder_tree(sd, "decoder."),
    }
    return params_from_jax(tree, device)


# ---------------------------------------------------------------------------
# the writers: parameter tree -> reference state dict
# ---------------------------------------------------------------------------
# Exact inverses of the readers, producing state dicts that load with
# ``strict=True`` into the reference's module layouts (reference:
# acai_omr/models/models.py:14-36 Encoder, 197-213 MAE, 378-428 OMRDecoder,
# 649-660 TeacherForcedViTOMR incl. the FineTuneOMREncoder frozen /
# fine-tune split, models.py:334-360).

def _own(leaf) -> torch.Tensor:
    """A leaf as a contiguous tensor of its own (no view of a stacked
    leaf's storage)."""
    return _t(leaf).clone(memory_format=torch.contiguous_format)


def _unstack(stacked: dict, i: int) -> dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else _t(v)[i]
            for k, v in stacked.items()}


def _dense_sd(out, p, prefix):
    out[prefix + ".weight"] = _own(_t(p["kernel"]).T)
    out[prefix + ".bias"] = _own(p["bias"])


def _norm_sd(out, p, prefix):
    out[prefix + ".weight"] = _own(p["scale"])
    out[prefix + ".bias"] = _own(p["bias"])


def _mha_sd(out, p, prefix):
    out[prefix + ".in_proj_weight"] = _own(_t(p["in_kernel"]).T)
    out[prefix + ".in_proj_bias"] = _own(p["in_bias"])
    _dense_sd(out, p["out"], prefix + ".out_proj")


def _encoder_layer_sd(out, layer, prefix):
    _mha_sd(out, layer["self_attn"], prefix + ".self_attn")
    _dense_sd(out, layer["linear1"], prefix + ".linear1")
    _dense_sd(out, layer["linear2"], prefix + ".linear2")
    _norm_sd(out, layer["norm1"], prefix + ".norm1")
    _norm_sd(out, layer["norm2"], prefix + ".norm2")


def _decoder_layer_sd(out, layer, prefix):
    _mha_sd(out, layer["self_attn"], prefix + ".self_attn")
    _mha_sd(out, layer["cross_attn"], prefix + ".multihead_attn")
    _dense_sd(out, layer["linear1"], prefix + ".linear1")
    _dense_sd(out, layer["linear2"], prefix + ".linear2")
    _norm_sd(out, layer["norm1"], prefix + ".norm1")
    _norm_sd(out, layer["norm2"], prefix + ".norm2")
    _norm_sd(out, layer["norm3"], prefix + ".norm3")


def _depth(blocks: dict) -> int:
    return _t(blocks["norm1"]["scale"]).shape[0]


def encoder_state_dict_from_params(params: dict, prefix: str = "",
                                   fine_tune_depth: int | None = None
                                   ) -> dict:
    """Encoder tree -> reference Encoder / OMREncoder / FineTuneOMREncoder
    state dict. ``fine_tune_depth=None`` gives the plain ``encoder_blocks``
    layout; an int splits the stacked layers into ``frozen_blocks`` (the
    first ``num_layers - fine_tune_depth``) and ``fine_tune_blocks``, as the
    reference constructor does (models.py:334-360; the final norm lives on
    ``fine_tune_blocks``)."""
    out = {prefix + "pos_embedding": _own(params["pos_embedding"])}
    _dense_sd(out, params["projection"], prefix + "projection")
    num_layers = _depth(params["blocks"])
    if fine_tune_depth is None:
        names = [f"{prefix}encoder_blocks.layers.{i}"
                 for i in range(num_layers)]
        norm = prefix + "encoder_blocks.norm"
    else:
        num_frozen = num_layers - fine_tune_depth
        names = [f"{prefix}frozen_blocks.layers.{i}"
                 for i in range(num_frozen)]
        names += [f"{prefix}fine_tune_blocks.layers.{j}"
                  for j in range(fine_tune_depth)]
        norm = prefix + "fine_tune_blocks.norm"
    for i, name in enumerate(names):
        _encoder_layer_sd(out, _unstack(params["blocks"], i), name)
    _norm_sd(out, params["final_norm"], norm)
    return out


def mae_state_dict_from_params(params: dict) -> dict:
    """MAE tree -> reference ``MAE`` state dict (models.py:197-213)."""
    out = encoder_state_dict_from_params(params["encoder"], "encoder.")
    _dense_sd(out, params["decoder_embed"], "decoder_embed")
    for i in range(_depth(params["decoder_blocks"])):
        _encoder_layer_sd(out, _unstack(params["decoder_blocks"], i),
                          f"decoder.decoder_blocks.layers.{i}")
    _norm_sd(out, params["decoder_norm"], "decoder.decoder_blocks.norm")
    _dense_sd(out, params["decoder_unembed"], "decoder_unembed")
    out["mask_token"] = _own(params["mask_token"]).reshape(1, 1, -1)
    out["decoder_pos_embedding"] = _own(params["decoder_pos_embedding"])
    return out


def omr_decoder_state_dict_from_params(params: dict,
                                       prefix: str = "") -> dict:
    """Decoder tree -> reference OMRDecoder state dict."""
    out = {prefix + "vocab_embedding.weight":
               _own(params["vocab_embedding"]["table"]),
           prefix + "pos_embedding": _own(params["pos_embedding"])}
    for i in range(_depth(params["blocks"])):
        _decoder_layer_sd(out, _unstack(params["blocks"], i),
                          f"{prefix}decoder_blocks.layers.{i}")
    _norm_sd(out, params["final_norm"], prefix + "decoder_blocks.norm")
    _dense_sd(out, params["unembed"], prefix + "unembed")
    return out


def vitomr_state_dict_from_params(params: dict,
                                  fine_tune_depth: int | None = None) -> dict:
    """ViTOMR tree -> reference TeacherForced / GRPO ViTOMR state dict
    (models.py:649-660). ``fine_tune_depth`` selects the FineTuneOMREncoder
    key layout; None gives the plain OMREncoder keys."""
    out = encoder_state_dict_from_params(params["encoder"], "encoder.",
                                         fine_tune_depth)
    _dense_sd(out, params["transition_head"]["linear1"], "transition_head.0")
    _dense_sd(out, params["transition_head"]["linear2"], "transition_head.3")
    out.update(omr_decoder_state_dict_from_params(params["decoder"],
                                                  "decoder."))
    return out
