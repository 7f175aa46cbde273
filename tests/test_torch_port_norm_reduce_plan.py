"""The plans and checks of K4 ``add_layernorm`` and K15 ``tp_allreduce``:
``layernorm_kernel.add_layernorm_plan`` (the vector kernel's warps a row),
``tp_allreduce_kernel.local_plan`` (the one-card form's grid) and
``allreduce_form`` (which form a group's call takes), and the wrappers'
refusals, which run on CPU tensors too, before anything is built. The CPU
calls run the twins. Pure Python apart from one comparison of K4's twin with
the JAX kernel's ``_ln`` at a masked width: nothing here asks for the card;
a build or a bind during these tests fails them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.ops import pallas_monolith as pm
from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import layernorm_kernel as lk
from acai_omr_tpu_torch.ops import tp_allreduce_kernel as tk

from _torch_port_threads import torch_one_thread  # noqa: F401

E = 1024
# the rows K15 runs at on the meshed paths (dp2_tp2's 4-row shards, tp2 /
# tp4's 8, tp2_beam's 16, beams of 4 x 32) and around them
B_ROWS = [1, 2, 3, 4, 5, 8, 16, 31, 32, 64, 128]


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


def _group(*cards):
    return tk.TPGroup([torch.device("cuda", c) for c in cards])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_local_plan_gives_every_element_a_thread(tp, dt):
    """Every element of a rank in exactly one thread's 8: blocks x threads
    x 8 covers n and one block less would not; blocks of 128 or 256; every
    shape of the decode step (B <= 128 at E = 1024) in one wave of at most
    one block an SM."""
    for e in (8, 16, 320, 512, 768, E):
        for b in B_ROWS + [1000, 4096]:
            n = b * e
            blocks, threads = tk.local_plan(n, tp, dt)
            assert threads in (128, 256)
            per_block = threads * tk.LOCAL_ELEMS
            assert blocks * per_block >= n > (blocks - 1) * per_block
            if e == E and b <= 128:
                assert threads == 128 and blocks <= 132, (b, blocks)


def test_local_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="E % 8"):
        tk.local_plan(4 * 1020 + 4, 2, torch.float32)
    with pytest.raises(ValueError, match="2 or 4 ranks"):
        tk.local_plan(8 * E, 8, torch.float32)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tk.local_plan(8 * E, 2, torch.float16)


def test_allreduce_form_follows_the_topology():
    """"local" where every rank lies on one card, "coop" where the group
    spans cards or the caller forces it; no other form, and no one-card
    form for a group over several cards. No card is needed: the groups are
    built from device objects."""
    for tp in (2, 4):
        one = _group(*[0] * tp)
        assert tk.allreduce_form(one) == "local"
        assert tk.allreduce_form(one, "local") == "local"
        assert tk.allreduce_form(one, "coop") == "coop"
        assert tk.allreduce_form(_group(*[3] * tp)) == "local"
    for cards in ((0, 1), (0, 0, 1, 1), (0, 1, 2, 3)):
        many = _group(*cards)
        assert tk.allreduce_form(many) == "coop"
        assert tk.allreduce_form(many, "coop") == "coop"
        with pytest.raises(ValueError, match="one card"):
            tk.allreduce_form(many, "local")
    with pytest.raises(ValueError, match="unknown variant"):
        tk.allreduce_form(_group(0, 0), "ring")
    assert tk.allreduce_form(tk.TPGroup(["cpu"] * 2)) == "local"


def test_allreduce_wrapper_refusals_on_the_cpu():
    """The CPU call checks what the kernels take before the twin runs, and
    runs the twin whatever form ``variant`` names."""
    group = tk.TPGroup(["cpu"] * 2)
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.standard_normal((4, 16), dtype=np.float32))
             for _ in range(2)]
    bias = [torch.from_numpy(rng.standard_normal(16, dtype=np.float32))] * 2
    want = tk.tp_allreduce.plain(parts, group, bias, torch.bfloat16)
    for variant in (None, "local", "coop"):
        got = tk.tp_allreduce(parts, group, bias, torch.bfloat16,
                              variant=variant)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="E % 8"):
        tk.tp_allreduce([p[:, :12].contiguous() for p in parts], group)
    with pytest.raises(ValueError, match="bias must be"):
        tk.tp_allreduce(parts, group, [b[:8] for b in bias])
    with pytest.raises(ValueError, match="parts for a group"):
        tk.tp_allreduce(parts, tk.TPGroup(["cpu"] * 4))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tk.tp_allreduce([p.half() for p in parts], group)
    with pytest.raises(ValueError, match="unknown variant"):
        tk.tp_allreduce(parts, group, variant="ring")
    assert tk.tp_allreduce.launches == 0


def test_add_layernorm_plan_takes_a_vector_kernel():
    """The plan names one of the vector kernel's variants at every width the
    port uses and at the rows of every path."""
    for e in (256, 320, 512, 768, E):
        for rows in (1, 4, 8, 16, 32, 33, 64, 128, 2048, 8192, 16384, 32768):
            v = lk.add_layernorm_plan(rows, e)
            assert v in lk.VARIANTS and v != "scalar", (rows, e, v)
    # the decode step's rows (beams, GRPO's rollouts) four warps a row; the
    # encoder's and the training stacks' rows one
    for rows in (1, 4, 8, 16, 32, 128, lk.PLAN_SPLIT_ROWS):
        assert lk.add_layernorm_plan(rows, E) == "warps4"
    for rows, e in ((lk.PLAN_SPLIT_ROWS + 1, E), (2048, E), (8192, 768),
                    (16384, 768), (32768, 512)):
        assert lk.add_layernorm_plan(rows, e) == "warps1"


def test_add_layernorm_refusals_on_the_cpu():
    """E % 8 != 0 and E > 1024 are refused on the CPU too (the scalar
    kernel: E % 32), before the twin runs; every variant's CPU call is the
    twin."""
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
    x, r, g, b = mk(3, 40), mk(3, 40), mk(40), mk(40)
    want = lk.add_layernorm_plain(x, r, g, b, 1e-5)
    for variant in (None, "warps1", "warps4"):
        assert torch.equal(lk.add_layernorm(x, r, g, b, 1e-5,
                                            variant=variant), want)
    with pytest.raises(ValueError, match="E % 32"):
        lk.add_layernorm(x, r, g, b, 1e-5, variant="scalar")
    with pytest.raises(ValueError, match="E % 8"):
        lk.add_layernorm(mk(3, 36), None, mk(36), mk(36), 1e-5)
    with pytest.raises(ValueError, match="E <= 1024"):
        lk.add_layernorm(mk(2, 1032), None, mk(1032), mk(1032), 1e-5)
    with pytest.raises(ValueError, match="shape mismatch"):
        lk.add_layernorm(x, r, mk(32), b, 1e-5)
    with pytest.raises(ValueError, match="return_sum"):
        lk.add_layernorm(x, None, g, b, 1e-5, True)
    with pytest.raises(ValueError, match="unknown variant"):
        lk.add_layernorm(x, r, g, b, 1e-5, variant="warps2")
    assert lk.add_layernorm.launches == 0


def test_add_layernorm_twin_matches_jax_ln_at_a_masked_width():
    """K4's twin against the monolith's ``_ln`` on the bf16 residual sum at
    E = 320, a width whose last chunk the vector kernel masks: the same
    bf16 outputs, give or take one bf16 ulp of the output (the sums run in
    another order)."""
    rng = np.random.default_rng(2)
    x, r = (rng.standard_normal((33, 320), dtype=np.float32) for _ in range(2))
    g = 1 + 0.1 * rng.standard_normal(320, dtype=np.float32)
    b = 0.1 * rng.standard_normal(320, dtype=np.float32)
    xb, rb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, r))
    got = lk.add_layernorm(xb, rb, torch.from_numpy(g), torch.from_numpy(b),
                           1e-5)
    z = (jnp.asarray(xb.float().numpy(), jnp.bfloat16)
         + jnp.asarray(rb.float().numpy(), jnp.bfloat16))
    want = np.asarray(pm._ln(z, jnp.asarray(g)[None], jnp.asarray(b)[None],
                             1e-5).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2 ** -7 * np.abs(want).max())
