"""The plain twins of the port's training kernels against the JAX package's
in-kernel helpers, at fp32 on the CPU, and the port's dropout on its own.

Each twin (what the kernel wrappers run for CPU tensors, and what the CUDA
kernels are held against on the card) gets the same numpy-seeded inputs as
its counterpart in ``acai_omr_tpu/ops/pallas_train_layer.py``: ``_ln_bwd``,
``_attend`` / ``_attend_bwd``, ``_gelu_grad``, ``_dot_bt`` / ``_dot_tb``.
Tolerances: 2e-5 absolute on O(1) values (sums in another order; exact vs
rational erf, whose stated error is 1.5e-7), 1e-4 relative on column sums
over hundreds of rows.

The JAX tests skip dropout on the CPU (it needs the TPU's generator); the
port's mask is a counter-based function, so it is tested here in full: a
pure function of its key, the keep share, independence from batch size and
tiling, and the gradient against explicit masks.
"""

import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.ops import pallas_train_layer as ptl

import acai_omr_tpu_torch
from acai_omr_tpu_torch.ops import dropout_kernel as dk
from acai_omr_tpu_torch.ops.attention_bwd_kernel import attention_bwd
from acai_omr_tpu_torch.ops.encoder_stack_kernel import (attention_bias,
                                                         encoder_attention)
from acai_omr_tpu_torch.ops.layernorm_bwd_kernel import layernorm_bwd
from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm
from acai_omr_tpu_torch.ops.linear_bwd_kernel import (linear_dgrad,
                                                      linear_wgrad)
from acai_omr_tpu_torch.ops.linear_kernel import (gelu_grad32,
                                                  linear_bias_act)

from _torch_port_threads import torch_one_thread  # noqa: F401

ATOL = 2e-5
T = torch.from_numpy


def test_layernorm_bwd_matches_jax():
    rng = np.random.default_rng(0)
    g, z = (rng.standard_normal((96, 64), dtype=np.float32) for _ in range(2))
    gamma = 1 + 0.1 * rng.standard_normal(64, dtype=np.float32)
    dz_j, ds_j, db_j = ptl._ln_bwd(jnp.asarray(g), jnp.asarray(z),
                                   jnp.asarray(gamma)[None])
    dz, dz_drop, ds, db = layernorm_bwd(T(g), T(z), T(gamma), 1e-5)
    assert dz_drop is dz  # no dropout: one tensor
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), atol=ATOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_j)[0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j)[0], rtol=1e-4,
                               atol=1e-4)


def test_layernorm_recompute_matches_jax_ln_fwd():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((40, 64), dtype=np.float32)
    gamma, beta = (rng.standard_normal(64, dtype=np.float32) for _ in range(2))
    want, _, _ = ptl._ln_fwd(jnp.asarray(z), jnp.asarray(gamma)[None],
                             jnp.asarray(beta)[None])
    got = add_layernorm(T(z), None, T(gamma), T(beta), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    x, r = z[:, ::-1].copy(), z
    out, zsum = add_layernorm(T(x), T(r), T(gamma), T(beta), 1e-5, True)
    np.testing.assert_array_equal(zsum.numpy(), x + r)
    want, _, _ = ptl._ln_fwd(jnp.asarray(x + r), jnp.asarray(gamma)[None],
                             jnp.asarray(beta)[None])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


def test_gelu_and_its_derivative_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 32), dtype=np.float32)
    w = rng.standard_normal((32, 64), dtype=np.float32) * 0.3
    b = rng.standard_normal(64, dtype=np.float32)
    u = jnp.asarray(x) @ jnp.asarray(w) + jnp.asarray(b)
    h1, gp = linear_bias_act(T(x), T(w), T(b), "gelu", None, True)
    np.testing.assert_allclose(h1.numpy(), np.asarray(ptl._gelu_fwd(u)),
                               atol=ATOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(ptl._gelu_grad(u)),
                               atol=ATOL)
    grid = np.linspace(-6, 6, 241, dtype=np.float32)
    np.testing.assert_allclose(gelu_grad32(T(grid)).numpy(),
                               np.asarray(ptl._gelu_grad(jnp.asarray(grid))),
                               atol=ATOL)


def _attention_inputs(seed, b, tq, tk, e):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return mk(b, tq, e), mk(b, tk, e), mk(b, tk, e), mk(b, tq, e)


@pytest.mark.parametrize("causal,cross", [(True, False), (False, False),
                                          (False, True)])
def test_attention_forward_and_backward_match_jax(causal, cross):
    """Per (image, head) against ``_attend`` / ``_attend_bwd``: ragged key
    validity, and one image with no valid key at all (uniform attention, not
    NaN, forward and backward)."""
    b, tq, e, h = 3, 16, 32, 2
    tk = 24 if cross else tq
    dh = e // h
    q, k, v, d_o = _attention_inputs(3, b, tq, tk, e)
    lens = [tk, 5, 0]
    valid = np.arange(tk)[None, :] < np.asarray(lens)[:, None]
    bias = attention_bias(T(valid), tq, causal).numpy()  # (B, 1, tq|1, tk)
    bias = np.broadcast_to(bias, (b, 1, tq, tk))

    if cross:
        qkv, kv = T(q).reshape(b * tq, e), T(np.concatenate([k, v], -1))
    else:
        qkv, kv = T(np.concatenate([q, k, v], -1)).reshape(b * tq, 3 * e), None
    out = encoder_attention(qkv, T(valid), h, causal, kv).reshape(b, tq, e)
    dq, dk_, dv = attention_bwd(T(q), T(k), T(v), T(d_o), T(valid), h, causal)
    assert all(torch.isfinite(a).all() for a in (out, dq, dk_, dv))

    for i in range(b):
        for hh in range(h):
            sl = slice(hh * dh, (hh + 1) * dh)
            j = lambda a: jnp.asarray(a[i, :, sl])
            o_j, p_j = ptl._attend(j(q), j(k), j(v), jnp.asarray(bias[i, 0]),
                                   jnp.float32)
            dq_j, dk_j, dv_j = ptl._attend_bwd(j(d_o), j(q), j(k), j(v), p_j,
                                               jnp.float32)
            for got, want in ((out, o_j), (dq, dq_j), (dk_, dk_j), (dv, dv_j)):
                np.testing.assert_allclose(got[i, :, sl].numpy(),
                                           np.asarray(want), atol=ATOL)
    if not causal:  # the all-invalid image attends uniformly
        np.testing.assert_allclose(out[2].numpy(),
                                   np.broadcast_to(v[2].mean(0), (tq, e)),
                                   atol=ATOL)


def test_attention_bwd_writes_through_strided_destinations():
    b, t, e, h = 2, 8, 16, 2
    q, k, v, d_o = (T(a) for a in _attention_inputs(4, b, t, t, e))
    valid = torch.ones(b, t, dtype=torch.bool)
    want = attention_bwd(q, k, v, d_o, valid, h, True)
    dqkv = torch.zeros(b, t, 3 * e)
    attention_bwd(q, k, v, d_o, valid, h, True, *dqkv.split(e, dim=-1))
    torch.testing.assert_close(dqkv, torch.cat(want, dim=-1), rtol=0, atol=0)


def test_dgrad_and_wgrad_match_jax_dots():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 24), dtype=np.float32)
    w = rng.standard_normal((24, 40), dtype=np.float32)
    dy = rng.standard_normal((64, 40), dtype=np.float32)
    other = rng.standard_normal((64, 24), dtype=np.float32)
    want = np.asarray(ptl._dot_bt(jnp.asarray(dy), jnp.asarray(w)))
    np.testing.assert_allclose(linear_dgrad(T(dy), T(w)).numpy(), want,
                               atol=ATOL, rtol=1e-5)
    # the epilogues: du = dh1 * gelu', dx = residual + .
    np.testing.assert_allclose(
        linear_dgrad(T(dy), T(w), None, T(other)).numpy(), want * other,
        atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(
        linear_dgrad(T(dy), T(w), None, None, T(other)).numpy(), other + want,
        atol=ATOL, rtol=1e-5)
    dw, db = linear_wgrad(T(x), T(dy))
    np.testing.assert_allclose(
        dw.numpy(), np.asarray(ptl._dot_tb(jnp.asarray(x), jnp.asarray(dy))),
        atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), dy.sum(0), atol=1e-4, rtol=1e-5)
    # destinations: a layer's slice of the stacked gradient
    stacked, bias = torch.zeros(2, 24, 40), torch.zeros(2, 40)
    linear_wgrad(T(x), T(dy), stacked[1], bias[1])
    assert torch.equal(stacked[1], dw) and torch.equal(bias[1], db)
    assert not stacked[0].any()


# ---------------------------------------------------------------------------
# dropout (port only)
# ---------------------------------------------------------------------------

SPEC = dk.DropSpec(0.3, 0xABCDEF01, 0x1234, 9, 16)


def test_philox_matches_the_published_test_vectors():
    """Random123's known-answer tests for philox4x32_10."""
    one = lambda v: torch.tensor([v], dtype=torch.int64)
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = dk.philox4x32_10(*(one(c) for c in ctr), *key)
        assert tuple(int(g) for g in got) == want


def test_mask_is_a_pure_function_of_its_key():
    a = dk.drop_bits(SPEC, 64, 32, "cpu")
    assert torch.equal(a, dk.drop_bits(SPEC, 64, 32, "cpu"))
    assert a.min() >= 0 and a.max() < 2 ** 32
    for other in (dk.DropSpec(0.3, 0xABCDEF02, 0x1234, 9, 16),
                  dk.DropSpec(0.3, 0xABCDEF01, 0x1235, 9, 16), SPEC.at(10)):
        assert not torch.equal(a, dk.drop_bits(other, 64, 32, "cpu"))
    # the rate moves the threshold, not the bits
    assert torch.equal(a, dk.drop_bits(dk.DropSpec(0.5, 0xABCDEF01, 0x1234, 9,
                                                   16), 64, 32, "cpu"))


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.5])
def test_keep_share_within_a_binomial_bound(rate):
    n = 512 * 256
    keep = dk.keep_mask(dk.DropSpec(rate, 7, 8, 1, 64), 512, 256, "cpu")
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 5 * sigma
    # no row and no column is special
    assert (keep.float().mean(0) - (1 - rate)).abs().max() < 0.12
    assert (keep.float().mean(1) - (1 - rate)).abs().max() < 0.12


def test_mask_ignores_batch_size_tiling_and_column_chunking():
    """An image's mask depends on its index in the batch and on each
    element's own row and column: not on how many images follow, not on
    where a tile of rows starts, not on how the columns are chunked."""
    t, w = SPEC.t, 64
    full = dk.drop_bits(SPEC, 4 * t, w, "cpu")
    assert torch.equal(full[:2 * t], dk.drop_bits(SPEC, 2 * t, w, "cpu"))
    tile = dk.drop_bits(SPEC, t + 5, w, "cpu", row_offset=2 * t - 3)
    assert torch.equal(tile, full[2 * t - 3:3 * t + 2])
    assert torch.equal(dk.drop_bits(SPEC, 4 * t, w // 2, "cpu"),
                       full[:, :w // 2])
    # images differ from one another
    assert not torch.equal(full[:t], full[t:2 * t])


def test_dropout_forward_scales_survivors_and_backward_reuses_the_mask():
    x = torch.randn(3 * SPEC.t, 32, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    keep = dk.keep_mask(SPEC, x.shape[0], 32, "cpu")
    out = dk.dropout(x.view(3, SPEC.t, 32), SPEC).view_as(x)
    scale = np.float32(1.0 / (1.0 - SPEC.rate))
    torch.testing.assert_close(out, torch.where(keep, x * scale, 0.0),
                               rtol=0, atol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(g)
    torch.testing.assert_close(x.grad, torch.where(keep, g * scale, 0.0),
                               rtol=0, atol=0)
    assert dk.dropout(x, None) is x
    assert dk.dropout(x, dk.DropSpec(0.0, 1, 2, 3, 4)) is x


def test_kernel_epilogues_drop_what_the_standalone_twin_drops():
    """K1's, K8's and K9's dropout epilogues are the standalone mask applied
    to their rounded output."""
    rng = np.random.default_rng(6)
    x = T(rng.standard_normal((32, 16), dtype=np.float32))
    w = T(rng.standard_normal((16, 24), dtype=np.float32))
    b = T(rng.standard_normal(24, dtype=np.float32))
    torch.testing.assert_close(
        linear_bias_act(x, w, b, "none", SPEC),
        dk.dropout_apply(linear_bias_act(x, w, b), SPEC), rtol=0, atol=0)
    g = T(rng.standard_normal((32, 24), dtype=np.float32))
    z = T(rng.standard_normal((32, 24), dtype=np.float32))
    dz, dz_drop, _, _ = layernorm_bwd(g, z, b, 1e-5, SPEC)
    torch.testing.assert_close(dz_drop, dk.dropout_apply(dz, SPEC), rtol=0,
                               atol=0)
    other = T(rng.standard_normal((32, 16), dtype=np.float32))
    torch.testing.assert_close(
        linear_dgrad(g, w, SPEC, other),
        dk.dropout_apply(linear_dgrad(g, w), SPEC) * other, rtol=0, atol=0)


def test_dropout_twin_is_the_only_dropout_and_draws_no_global_state():
    """The port has one dropout definition, the counter-based twin: a pure
    function of its key that leaves torch's global generator alone."""
    from acai_omr_tpu_torch.ops import nn
    assert not hasattr(nn, "dropout")
    x = torch.ones(64, 256)
    spec = dk.DropSpec(0.25, 4, 5, 0, 64)
    state = torch.get_rng_state()
    a, b = dk.dropout_plain(x, spec), dk.dropout_plain(x, spec)
    assert torch.equal(a, b) and torch.equal(state, torch.get_rng_state())
    assert set(a.unique().tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.75))}
    assert abs((a != 0).float().mean().item() - 0.75) < 0.02
    other = dk.dropout_plain(x, dk.DropSpec(0.25, 4, 6, 0, 64))
    assert not torch.equal(a, other)
    assert dk.dropout_plain(x, None) is x


def test_fold_seed_is_deterministic_and_spreads():
    seen = {dk.fold_seed(s, p) for s in range(8) for p in range(8)}
    assert len(seen) == 64
    assert dk.fold_seed(3, 1, 2) == dk.fold_seed(3, 1, 2)
    assert dk.fold_seed(3, 1, 2) != dk.fold_seed(3, 2, 1)
    assert all(0 <= v < 2 ** 32 for pair in seen for v in pair)


# ---------------------------------------------------------------------------
# the port imports torch, never jax / optax / orbax / the JAX package
# ---------------------------------------------------------------------------

_IMPORT_EVERYTHING = """
import importlib, pkgutil, sys
blocked = ("jax", "jaxlib", "optax", "orbax", "flax", "acai_omr_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError(name + " is blocked in this test")
        return None

sys.meta_path.insert(0, Blocker())
pkg = importlib.import_module("acai_omr_tpu_torch")
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               "acai_omr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(n.split(".")[0] in blocked for n in sys.modules)
print("\\n".join(names))
"""


def test_port_imports_nothing_of_jax():
    """Every module of the port imports, in a fresh interpreter, with
    ``jax``, ``optax``, ``orbax`` and ``acai_omr_tpu`` blocked."""
    root = Path(acai_omr_tpu_torch.__file__).resolve().parent.parent
    run = subprocess.run([sys.executable, "-c", _IMPORT_EVERYTHING],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    names = run.stdout.split()
    assert "acai_omr_tpu_torch.train.omr_teacher_force_train" in names
    assert "acai_omr_tpu_torch.ops.train_layer_kernel" in names
    assert "acai_omr_tpu_torch.api" in names
