"""The port's two training stacks against the JAX package's fused Pallas
stacks, forward and backward, at fp32 on the CPU.

The JAX side runs ``pallas_train_layer.decoder_stack_fused`` /
``encoder_stack_fused`` forced and in the Pallas interpreter (as
tests/test_fused_train_layer.py runs them), forward and ``jax.grad`` through
the hand-written ``_bwd_kernel``. The port runs the same weights (numpy
arrays into both) two ways: its ``torch.autograd.Function`` whose backward is
the hand-written sweep (each op running its plain twin, as the wrappers do for
CPU tensors), and the plain twins under autograd (what ``transformer.*_stack``
dispatches to on the CPU). Shapes as the JAX tests: L=2, B=4, T=32, M=128,
E=256, H=4, F=512. Tolerances are the JAX tests' own: forward atol 3e-5 /
rtol 1e-4; gradients atol 3e-4 * max(scale, 1) / rtol 2e-3.

Dropout (the JAX tests skip it on the CPU) is held against autograd through a
forward that multiplies by the same masks explicitly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.ops import transformer as jax_tf

from acai_omr_tpu_torch.ops import dropout_kernel as dk
from acai_omr_tpu_torch.ops import nn, transformer
from acai_omr_tpu_torch.ops import train_layer_kernel as tlk

from _torch_port_threads import torch_one_thread  # noqa: F401

L, B, T, M, E, H, F = 2, 4, 32, 128, 256, 4, 512


@pytest.fixture(autouse=True)
def _test_mode():
    prev = (ptl._FORCE, ptl._INTERPRET)
    ptl.set_test_mode(force=True, interpret=True)
    yield
    ptl.set_test_mode(*prev)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return {
        "x": f32(B, T, E), "mem_kv": f32(L, B, M, 2 * E), "w": f32(B, T, E),
        "self_valid": np.arange(T)[None, :] < np.asarray([T, T - 7, 9, T])[:, None],
        "mem_valid": np.arange(M)[None, :] < np.asarray([M, 40, M - 1, 33])[:, None],
    }


def _jax_stack(kind):
    init = jax_tf.decoder_layer_init if kind == "decoder" \
        else jax_tf.encoder_layer_init
    stacked = jax_tf.stack_init(init, jax.random.PRNGKey(0), L, E, F)
    # biases and LayerNorm vectors away from their zero / one init
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    return jax.tree.map(
        lambda v: v + 0.05 * jax.random.normal(next(keys), v.shape, v.dtype),
        stacked)


@pytest.fixture(scope="module", params=["decoder", "encoder"])
def reference(request, data):
    """(kind, stacked weights, JAX forward, JAX gradients) of the fused JAX
    stack in interpret mode."""
    kind = request.param
    stacked = _jax_stack(kind)
    x, w = jnp.asarray(data["x"]), jnp.asarray(data["w"])
    sv, mv = jnp.asarray(data["self_valid"]), jnp.asarray(data["mem_valid"])
    ptl.set_test_mode(force=True, interpret=True)
    try:
        if kind == "decoder":
            run = lambda s, x_, m_: ptl.decoder_stack_fused(s, x_, m_, sv, mv, H)
            args = (stacked, x, jnp.asarray(data["mem_kv"]))
        else:
            run = lambda s, x_: ptl.encoder_stack_fused(s, x_, sv, H)
            args = (stacked, x)
        out = run(*args)
        grads = jax.grad(lambda *a: jnp.sum(run(*a) * w),
                         argnums=tuple(range(len(args))))(*args)
    finally:
        ptl.set_test_mode(force=False, interpret=False)
    return kind, jax.tree.map(np.asarray, stacked), np.asarray(out), \
        jax.tree.map(np.asarray, grads)


def _port_run(kind, stacked, data, plain, **kw):
    stacked = _to_torch(stacked)
    for _, v in _leaves(stacked):
        v.requires_grad_(True)
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    sv = torch.from_numpy(data["self_valid"])
    if kind == "decoder":
        mem = torch.from_numpy(data["mem_kv"]).requires_grad_(True)
        out = tlk.decoder_stack_fused(stacked, x, mem, sv,
                                      torch.from_numpy(data["mem_valid"]), H,
                                      plain=plain, **kw)
        ins = (x, mem)
    else:
        out = tlk.encoder_stack_fused(stacked, x, sv, H, plain=plain, **kw)
        ins = (x,)
    (out * torch.from_numpy(data["w"])).sum().backward()
    return out.detach(), stacked, ins


@pytest.mark.parametrize("plain", [False, True],
                         ids=["hand_written_backward", "autograd_of_twins"])
def test_stack_forward_and_gradients_match_fused_jax(reference, data, plain):
    kind, stacked, out_j, grads_j = reference
    out, stacked_t, ins = _port_run(kind, stacked, data, plain)
    np.testing.assert_allclose(out.numpy(), out_j, atol=3e-5, rtol=1e-4)

    def close(got, want, what):
        scale = float(np.abs(want).max()) + 1e-6
        np.testing.assert_allclose(got, want, atol=3e-4 * max(scale, 1.0),
                                   rtol=2e-3, err_msg=f"grad mismatch at {what}")

    want_w = dict(_leaves(grads_j[0]))
    got_w = dict(_leaves(stacked_t))
    assert want_w.keys() == got_w.keys()
    for name, leaf in got_w.items():
        close(leaf.grad.numpy(), want_w[name], name)
    close(ins[0].grad.numpy(), grads_j[1], "x")
    if kind == "decoder":
        close(ins[1].grad.numpy(), grads_j[2], "mem_kv")


def test_dispatch_runs_save_less_when_nothing_needs_a_gradient(reference, data,
                                                               monkeypatch):
    """Validation and the frozen prefix: no gradient wanted, so the
    autograd.Function (and its saves) is not used at all."""
    kind, stacked, out_j, _ = reference
    monkeypatch.setattr(tlk._FusedStack, "apply",
                        lambda *a: pytest.fail("saves were kept"))
    stacked = _to_torch(stacked)
    x, sv = torch.from_numpy(data["x"]), torch.from_numpy(data["self_valid"])
    if kind == "decoder":
        out = tlk.decoder_stack_fused(stacked, x,
                                      torch.from_numpy(data["mem_kv"]), sv,
                                      torch.from_numpy(data["mem_valid"]), H)
    else:
        out = tlk.encoder_stack_fused(stacked, x, sv, H)
    np.testing.assert_allclose(out.numpy(), out_j, atol=3e-5, rtol=1e-4)
    x.requires_grad_(True)
    with torch.no_grad():
        tlk.encoder_stack_fused(_to_torch(_jax_stack_np("encoder")), x, sv, H)


def _jax_stack_np(kind):
    return jax.tree.map(np.asarray, _jax_stack(kind))


def test_per_layer_reference_loops_agree_with_the_stacks(data):
    """The independent per-layer loops of ops/transformer.py (nn.mha,
    nn.layernorm, no kernels' twins) give the stacks' outputs."""
    sv, mv = (torch.from_numpy(data[k]) for k in ("self_valid", "mem_valid"))
    x, mem_kv = torch.from_numpy(data["x"]), torch.from_numpy(data["mem_kv"])
    dec = _to_torch(_jax_stack_np("decoder"))
    want = transformer.decoder_stack_layers(
        dec, x, None, nn.causal_bias(T) + nn.valid_to_bias(sv),
        nn.valid_to_bias(mv), H, mem_kv=mem_kv)
    got = transformer.decoder_stack(dec, x, mem_kv, sv, mv, H)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
    enc = _to_torch(_jax_stack_np("encoder"))
    torch.testing.assert_close(
        transformer.encoder_stack(enc, x, sv, H),
        transformer.encoder_stack_layers(enc, x, sv, H), atol=3e-5, rtol=1e-4)


def test_precompute_memory_kv_matches_jax():
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((B, 16, E), dtype=np.float32)
    stacked = _jax_stack_np("decoder")
    want = jax_tf.precompute_memory_kv(jax.tree.map(jnp.asarray, stacked),
                                       jnp.asarray(memory))
    got = transformer.precompute_memory_kv(_to_torch(stacked),
                                           torch.from_numpy(memory))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# dropout inside the stacks (port only)
# ---------------------------------------------------------------------------

def _explicit_mask_decoder(stacked, x, mem_kv, sv, mv, seeds, rate):
    """A decoder stack written with plain nn ops that multiplies by the K10
    masks explicitly: the oracle for forward and gradient with dropout on."""
    b, t, e = x.shape
    spec = dk.DropSpec(rate, seeds[0], seeds[1], 0, t)
    scale = np.float32(1.0 / (1.0 - rate))

    def drop(v, layer, site):
        keep = dk.keep_mask(spec.at(layer * 8 + site), b * t, v.shape[-1],
                            "cpu").view(b, t, -1)
        return torch.where(keep, v * scale, 0.0)

    self_bias = nn.causal_bias(t) + nn.valid_to_bias(sv)
    cross_bias = nn.valid_to_bias(mv)
    for l in range(L):
        p = transformer.layer_slice(stacked, l)
        sa = drop(nn.mha(p["self_attn"], x, x, H, self_bias), l, tlk.SITE_SA)
        x = nn.layernorm(p["norm1"], x + sa)
        ca = drop(nn.mha(p["cross_attn"], x, None, H, cross_bias,
                         precomputed_kv=mem_kv[l]), l, tlk.SITE_CA)
        x = nn.layernorm(p["norm2"], x + ca)
        h = drop(nn.gelu(nn.dense(p["linear1"], x)), l, tlk.SITE_H1)
        ff = drop(nn.dense(p["linear2"], h), l, tlk.SITE_FF)
        x = nn.layernorm(p["norm3"], x + ff)
    return x


@pytest.mark.parametrize("plain", [False, True],
                         ids=["hand_written_backward", "autograd_of_twins"])
def test_dropout_gradient_equals_autograd_through_explicit_masks(data, plain):
    seeds, rate = (11, 22), 0.2
    stacked = _jax_stack_np("decoder")
    out, stacked_t, (x, mem) = _port_run(
        "decoder", stacked, data, plain, dropout_rate=rate, seeds=seeds,
        deterministic=False)

    ref_w = _to_torch(stacked)
    for _, v in _leaves(ref_w):
        v.requires_grad_(True)
    rx = torch.from_numpy(data["x"]).requires_grad_(True)
    rmem = torch.from_numpy(data["mem_kv"]).requires_grad_(True)
    ref = _explicit_mask_decoder(ref_w, rx, rmem,
                                 torch.from_numpy(data["self_valid"]),
                                 torch.from_numpy(data["mem_valid"]), seeds,
                                 rate)
    (ref * torch.from_numpy(data["w"])).sum().backward()
    torch.testing.assert_close(out, ref.detach(), atol=3e-5, rtol=1e-4)
    # dropout really happened, and a different seed drops other elements
    base, _, _ = _port_run("decoder", stacked, data, True)
    assert (out - base).abs().max() > 1e-2
    other, _, _ = _port_run("decoder", stacked, data, True, dropout_rate=rate,
                            seeds=(11, 23), deterministic=False)
    assert (out - other).abs().max() > 1e-2
    pairs = [(x.grad, rx.grad, "x"), (mem.grad, rmem.grad, "mem_kv")] + [
        (a.grad, b_.grad, n) for (n, a), (_, b_) in zip(_leaves(stacked_t),
                                                        _leaves(ref_w))]
    for got, want, name in pairs:
        scale = float(want.abs().max()) + 1e-6
        torch.testing.assert_close(got, want, atol=3e-4 * max(scale, 1.0),
                                   rtol=2e-3, msg=lambda m: f"{name}: {m}")


def test_an_image_keeps_its_mask_at_another_batch_size(data):
    """Images 0 and 1 alone get the outputs they get inside the batch of
    four: the mask is keyed on the image's index, not on the batch."""
    stacked = _to_torch(_jax_stack_np("encoder"))
    x, sv = torch.from_numpy(data["x"]), torch.from_numpy(data["self_valid"])
    kw = dict(dropout_rate=0.3, seeds=(5, 6), deterministic=False)
    full = transformer.encoder_stack(stacked, x, sv, H, **kw)
    half = transformer.encoder_stack(stacked, x[:2], sv[:2], H, **kw)
    torch.testing.assert_close(half, full[:2], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="seeds"):
        transformer.encoder_stack(stacked, x, sv, H, 0.3, None, False)
