"""The port's last four probes against the JAX package's, on the CPU: K25
``head_logits`` against the kernels ``k1``, ``k2`` and ``k3`` captured from
``tools/mosaic_head_access_probe.main`` at the tool's shape; K26
``batched_head_logits`` against ``kern`` captured from
``tools/mosaic_batched_attn_probe.run``, fp32 and int8, all three outputs;
K27 ``resident_elementwise`` against ``tools/vpu_probe._kernel`` for the
four JAX works; the port's copies of the two erf forms and their
coefficients; ``train_layer_kernel.set_ablate`` against
``pallas_train_layer.set_ablate`` through the gradients of the fused decoder
stack; each new tool's ``main(device="cpu")`` at small sizes. The JAX kernels
run in the Pallas interpreter; the port's wrappers get CPU tensors and so run
their plain twins. About 30 s on one core.

Tolerances: K25 within 1e-5 of the largest |output| (exact bf16 products,
fp32 sums in another order). K26 int8 exact (integer sums below 2^24), fp32
within 1e-5 relative, the transpose bit-equal to the column sums. K27 within
1e-5 of the largest |output| after 8 passes. The erf forms within 2e-7
absolute. The ablated gradients with the tolerances of
``tests/test_torch_port_train_stacks.py``.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from acai_omr_tpu.ops import pallas_monolith as jax_mono
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.ops import transformer as jax_tf
from acai_omr_tpu_torch.ops import head_logits_kernels as hk
from acai_omr_tpu_torch.ops import train_layer_kernel as tlk
from acai_omr_tpu_torch.ops import vpu_probe_kernels as vk
from acai_omr_tpu_torch.tools import (bwd_vmem_probe, mosaic_batched_attn_probe,
                                      mosaic_head_access_probe, vpu_probe)
from tools import mosaic_batched_attn_probe as jax_batched
from tools import mosaic_head_access_probe as jax_heads
from tools import vpu_probe as jax_vpu

from _torch_port_threads import torch_one_thread  # noqa: F401

REL_TOL = 1e-5


@contextlib.contextmanager
def _captured_calls():
    """Every ``pl.pallas_call`` inside the block runs in the interpreter and
    is recorded as (kernel, inputs, outputs), numpy arrays."""
    calls = []
    orig = pl.pallas_call

    def recording(kernel, **kw):
        call = orig(kernel, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            outs = out if isinstance(out, (list, tuple)) else [out]
            calls.append((kernel, [np.array(a) for a in args],
                          [np.array(o) for o in outs]))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        yield calls


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# K25: the three head-access forms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def head_access_calls():
    buf = io.StringIO()
    with _captured_calls() as calls, contextlib.redirect_stdout(buf):
        jax_heads.main()
    lines = buf.getvalue().splitlines()
    assert len(calls) == 3 and all(": OK" in line for line in lines), lines
    return calls


@pytest.mark.parametrize("n,form", list(enumerate(hk.FORMS)))
def test_head_logits_matches_jax_forms(head_access_calls, n, form):
    kernel, (q, k), (want,) = head_access_calls[n]
    assert kernel.__name__ == f"k{n + 1}"
    assert want.shape == (jax_heads.H, jax_heads.T, jax_heads.T)
    got = hk.head_logits(_bf16(q), _bf16(k), form, jax_heads.H)
    assert got.dtype == torch.float32
    _close(got, want)


def test_head_access_inputs_are_the_jax_tools():
    q, k = mosaic_head_access_probe.make_inputs(jax_heads.T, jax_heads.E,
                                                "cpu")
    rng = np.random.default_rng(0)
    for got in (q, k):
        want = np.asarray(jnp.asarray(rng.standard_normal(got.shape),
                                      jnp.bfloat16), np.float32)
        assert np.array_equal(got.float().numpy(), want)


def test_head_logits_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(64, 256, dtype=torch.bfloat16)
    for args, match in (((q, q, "diagonal", 4), "form"),
                        ((q, q, "reshape", 8), "heads of 64"),
                        ((q[:32], q[:32], "reshape", 4), "multiple of 64"),
                        ((q, q, "preshaped", 4), "3-d")):
        with pytest.raises(ValueError, match=match):
            hk.head_logits(*args)


# ---------------------------------------------------------------------------
# K26: batched single-query logits, fp32 and int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batched_calls():
    out = {}
    for name, dtype in (("fp32", jnp.float32), ("int8", jnp.int8)):
        with _captured_calls() as calls, \
                contextlib.redirect_stdout(io.StringIO()):
            jax_batched.run(dtype)
        (call,) = calls
        out[name] = call
    return out


@pytest.mark.parametrize("name", ["fp32", "int8"])
def test_batched_head_logits_matches_jax(batched_calls, name):
    _, (k, q), (out, outc, col) = batched_calls[name]
    got = hk.batched_head_logits(torch.from_numpy(k), torch.from_numpy(q),
                                 jax_batched.H)
    assert [tuple(g.shape) for g in got] == [out.shape, outc.shape, col.shape]
    g_out, g_sum, g_col = (g.numpy() for g in got)
    if name == "int8":
        assert np.array_equal(g_out, out) and np.array_equal(g_sum, outc)
        assert np.array_equal(g_col, col)
    else:
        for g, w in ((g_out, out), (g_sum, outc), (g_col, col)):
            assert np.abs(g - w).max() <= REL_TOL * np.abs(w).max()
    assert np.array_equal(g_col[:, 0], g_sum[0])  # bit-equal transpose


def test_batched_inputs_are_the_jax_tools():
    for int8 in (False, True):
        k, q = mosaic_batched_attn_probe.make_inputs(int8)
        rng = np.random.default_rng(0)
        if int8:
            want_k = rng.integers(-127, 128, k.shape).astype(np.int8)
            want_q = rng.integers(-127, 128, q.shape).astype(np.float32)
        else:
            want_k = rng.standard_normal(k.shape).astype(np.float32)
            want_q = rng.standard_normal(q.shape).astype(np.float32)
        assert np.array_equal(k, want_k) and np.array_equal(q, want_q)


def test_batched_int8_rounds_half_to_even():
    k = torch.ones(1, 1, 64, dtype=torch.int8)
    q = torch.zeros(1, 64)
    q[0, :4] = torch.tensor([0.5, 1.5, -2.5, 2.4])
    out, colsum, col = hk.batched_head_logits(k, q, 1)
    assert out.item() == 0 + 2 - 2 + 2
    assert torch.equal(col.t(), colsum)


# ---------------------------------------------------------------------------
# K27: the resident elementwise loop and the erf forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("work", ["softmax", "ln", "gelu", "gelu_poly"])
def test_resident_elementwise_matches_jax(work):
    x = vpu_probe.make_block(16, 256, "cpu")
    want = pl.pallas_call(
        functools.partial(jax_vpu._kernel, iters=8, work=work),
        out_shape=jax.ShapeDtypeStruct((16, 256), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))
    _close(vk.resident_elementwise(x, work, 8), np.asarray(want))


def test_vpu_block_is_the_jax_tools():
    rng = np.random.default_rng(0)
    want = np.asarray(jnp.asarray(rng.standard_normal((16, 256)) * 0.1,
                                  jnp.float32))
    assert np.array_equal(vpu_probe.make_block(16, 256, "cpu").numpy(), want)


def test_erf_forms_match_jax():
    assert vk.ERF_P_INNER == jax_mono._ERF_P_INNER
    assert vk.ERF_Q_OUTER == jax_mono._ERF_Q_OUTER
    z = np.linspace(-6.0, 6.0, 100_000, dtype=np.float32)
    for ours, theirs in ((vk.erf_rational, jax_mono._erf_rational),
                         (vk.erf_poly, jax_mono._erf_poly)):
        got = ours(torch.from_numpy(z)).numpy()
        assert np.abs(got - np.asarray(theirs(jnp.asarray(z)))).max() <= 2e-7
    # and the GELU of gelu_erff is PyTorch's exact-form GELU (within 4 ulps
    # of |x| <= 6: the two round in other places)
    u = torch.from_numpy(z)
    torch.testing.assert_close(vk.WORK_FN["gelu_erff"](u),
                               torch.nn.functional.gelu(u), atol=2e-6,
                               rtol=1e-6)


def test_resident_elementwise_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(8, 256)
    for args, match in (((x, "tanh", 1), "work"),
                        ((torch.zeros(8, 512), "ln", 1), "cols"),
                        ((torch.zeros(6, 256), "ln", 1), "multiple of 4"),
                        ((x, "ln", -1), "iters")):
        with pytest.raises(ValueError, match=match):
            vk.resident_elementwise(*args)
    assert vk.check_block(torch.zeros(3, 3072), "gelu", 0) is None


# ---------------------------------------------------------------------------
# set_ablate: the stubbed backward against the JAX kernel's branches
# ---------------------------------------------------------------------------

L, B, T, M, E, H, F = 1, 4, 32, 128, 256, 4, 512
ABLATED = ("noffn", "nocross", "noself")
# leaves each mode leaves at exactly zero, and one it leaves nonzero
ZEROED = {"noffn": ["linear1/kernel", "linear1/bias", "linear2/kernel",
                    "linear2/bias"],
          "nocross": ["cross_attn/out/kernel", "cross_attn/in_kernel",
                      "cross_attn/in_bias", "mem_kv"],
          "noself": ["self_attn/out/kernel", "self_attn/in_kernel",
                     "self_attn/in_bias"]}
KEPT = {"noffn": "norm3/scale", "nocross": "cross_attn/out/bias",
        "noself": "self_attn/out/bias"}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def ablation_data():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    stacked = jax.tree.map(
        lambda v: v + 0.05 * jax.random.normal(next(keys), v.shape, v.dtype),
        jax_tf.stack_init(jax_tf.decoder_layer_init, jax.random.PRNGKey(0), L,
                          E, F))
    return {"stacked": jax.tree.map(np.asarray, stacked),
            "x": f32(B, T, E), "mem_kv": f32(L, B, M, 2 * E), "w": f32(B, T, E),
            "self_valid": np.arange(T)[None] < np.asarray([T, T - 7, 9, T])[:, None],
            "mem_valid": np.arange(M)[None] < np.asarray([M, 40, M - 1, 33])[:, None]}


@pytest.fixture(scope="module")
def jax_ablated(ablation_data):
    """{mode: {leaf name, "x", "mem_kv": gradient}} of JAX's fused decoder
    stack in interpret mode under ``ptl.set_ablate(mode)``. One forward: the
    custom VJP's backward kernel is traced, and so reads the mode, only when
    the pullback runs."""
    d = ablation_data
    sv, mv = jnp.asarray(d["self_valid"]), jnp.asarray(d["mem_valid"])
    w = jnp.asarray(d["w"])
    run = lambda s, x, m: ptl.decoder_stack_fused(s, x, m, sv, mv, H)
    args = (jax.tree.map(jnp.asarray, d["stacked"]), jnp.asarray(d["x"]),
            jnp.asarray(d["mem_kv"]))
    prev = (ptl._FORCE, ptl._INTERPRET, ptl._ABLATE)
    out = {}
    try:
        ptl.set_test_mode(force=True, interpret=True)
        loss, pullback = jax.vjp(lambda *a: jnp.sum(run(*a) * w), *args)
        for mode in ABLATED:
            ptl.set_ablate(mode)
            gs, gx, gm = pullback(jnp.ones_like(loss))
            out[mode] = {**{n: np.asarray(v) for n, v in _leaves(gs)},
                         "x": np.asarray(gx), "mem_kv": np.asarray(gm)}
    finally:
        ptl.set_test_mode(*prev[:2])
        ptl.set_ablate(prev[2])
    return out


@pytest.fixture
def port_ablate():
    yield tlk.set_ablate
    tlk.set_ablate("full")


def _leaf_tensors(tree):
    return {k: _leaf_tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in tree.items()}


def _port_grads(d, mode) -> dict:
    tlk.set_ablate(mode)
    try:
        stacked = _leaf_tensors(d["stacked"])
        x = torch.from_numpy(d["x"]).requires_grad_(True)
        mem = torch.from_numpy(d["mem_kv"]).requires_grad_(True)
        out = tlk.decoder_stack_fused(stacked, x, mem,
                                      torch.from_numpy(d["self_valid"]),
                                      torch.from_numpy(d["mem_valid"]), H)
        (out * torch.from_numpy(d["w"])).sum().backward()
    finally:
        tlk.set_ablate("full")
    return {**{n: v.grad.numpy() for n, v in _leaves(stacked)},
            "x": x.grad.numpy(), "mem_kv": mem.grad.numpy()}


@pytest.mark.parametrize("mode", ABLATED)
def test_set_ablate_gradients_match_jax(ablation_data, jax_ablated,
                                        port_ablate, mode):
    want = jax_ablated[mode]
    got = _port_grads(ablation_data, mode)
    assert got.keys() == want.keys()
    for name, g in got.items():
        scale = float(np.abs(want[name]).max()) + 1e-6
        np.testing.assert_allclose(g, want[name], atol=3e-4 * max(scale, 1.0),
                                   rtol=2e-3, err_msg=f"{mode}: {name}")
    for name in ZEROED[mode]:
        assert not want[name].any() and not got[name].any(), name
    assert np.abs(want[KEPT[mode]]).max() > 1e-3


def test_set_ablate_attnonly_is_full_and_others_raise(ablation_data,
                                                      port_ablate):
    full = _port_grads(ablation_data, "full")
    attnonly = _port_grads(ablation_data, "attnonly")
    for name, g in full.items():
        assert np.array_equal(g, attnonly[name]), name
    with pytest.raises(ValueError, match="ablate mode"):
        port_ablate("nothing")
    assert tlk._ABLATE == "full"


# ---------------------------------------------------------------------------
# the tools on the CPU
# ---------------------------------------------------------------------------

def test_tools_run_the_twins_on_the_cpu_at_small_sizes(monkeypatch, capsys):
    res = mosaic_head_access_probe.main(["--iters", "1"], device="cpu",
                                        shapes=[(64, 128, 2)])
    assert res["ok"] and len(res["shapes"][0]["forms"]) == 3
    res = mosaic_batched_attn_probe.main(["--iters", "1"], device="cpu",
                                         shape=(2, 64, 128, 2))
    assert res["int8"]["compact_rel_err"] == 0.0
    assert res["f32"]["transpose_abs_err"] == 0.0
    res = vpu_probe.main(["--iters", "2"], device="cpu",
                         shapes={"softmax": [(8, 256)], "ln": [(4, 768)],
                                 "gelu_erff": [(1, 3072)]})
    assert res["ok"] and res["sm_clock_hz"] is None
    assert "bound_ns_per_iter" not in res["ln_4x768"]
    for var, v in zip("PB PT PM PE PH PF PL".split(),
                      (2, 64, 64, 128, 2, 256, 1)):
        monkeypatch.setenv(var, str(v))
    for mode in ("noffn", "noself"):
        res = bwd_vmem_probe.main([mode], device="cpu")
        assert res["ok"] and res["finite"], res
    assert tlk._ABLATE == "full"
    lines = capsys.readouterr().out.splitlines()
    assert "all constructs OK  [cpu: plain twins, host clock]" in lines
    assert "noffn: OK  [cpu: plain twins, host clock]" in lines
    assert not any("cuda" in line for line in lines)


def test_bwd_vmem_probe_launch_arithmetic():
    full = bwd_vmem_probe.expected_launches("full", 12)
    assert full == bwd_vmem_probe.expected_launches("attnonly", 12)
    assert sum(full.values()) == 12 * 22
    assert bwd_vmem_probe.expected_launches("noself", 1)["attention_bwd"] == 1
    with pytest.raises(SystemExit, match="mode"):
        bwd_vmem_probe.main(["nothing"], device="cpu")


@pytest.mark.parametrize("tool", [mosaic_head_access_probe,
                                  mosaic_batched_attn_probe, vpu_probe,
                                  bwd_vmem_probe])
def test_tools_raise_without_a_gpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
