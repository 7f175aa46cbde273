"""The port's probe kernels and tools against the JAX package's probes, on the
CPU: K16 ``tile_gemm`` against ``tools/pallas_gemm_probe.make_mm`` and the
four ``dot_general`` forms of ``tools/mosaic_dot_forms_probe``; K17 / K18
against ``tools/attn_microbench.blockdiag_attn`` / ``batcheddot_attn`` at
the microbench's full shapes and inputs; K19 against
``tools/vmem_probe.probe``. The JAX kernels run in the Pallas interpreter
(``pl.pallas_call`` patched with ``interpret=True``); the port's wrappers get
CPU tensors and so run their plain twins.

Tolerances: bf16 out within 1e-2 of the largest output (one bf16 ulp is
0.4-0.8% of it; the sums differ in order only); fp32 out within 1e-5 of the
largest output (fp32 sums in another order over depths up to 1,024); the
attention outputs within 2e-3 absolute (outputs below 0.5, so under one bf16
ulp of them, where a weight rounded to bf16 on the other side of a tie moves
the output by one ulp); row 0 of K19's output bit for bit.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from acai_omr_tpu_torch.ops import probe_kernels as pk
from acai_omr_tpu_torch.tools import (attn_microbench, gemm_probe,
                                      mosaic_dot_forms_probe,
                                      pallas_gemm_probe, vmem_probe)
from tools import attn_microbench as jax_attn
from tools import mosaic_dot_forms_probe as jax_forms
from tools import pallas_gemm_probe as jax_gemm
from tools import vmem_probe as jax_vmem

from _torch_port_threads import torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _t(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same values and dtype."""
    a = np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if x.dtype == jnp.bfloat16 else np.asarray(x)
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _close(got: torch.Tensor, want, rel: float):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# K16: the tiled GEMM and the dot forms
# ---------------------------------------------------------------------------

# the port compiles bk 32 / 64 (Hopper's shared memory); its twin does not
# depend on the tile, the JAX kernel runs at the tiles it names
@pytest.mark.parametrize("jax_tile,port_tile", [
    ((128, 128, 64), (128, 128, 64)), ((128, 256, 128), (128, 256, 64))])
def test_make_mm_matches_tile_gemm(interpret, jax_tile, port_tile):
    m, k, n = 256, 128, 256
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    want = jax_gemm.make_mm(m, k, n, *jax_tile)(x, w)
    assert want.dtype == jnp.bfloat16 and want.shape == (m, n)
    got = pallas_gemm_probe.make_mm(m, k, n, *port_tile)(_t(x), _t(w))
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


@pytest.mark.parametrize("form,layout,a_shape,b_shape",
                         mosaic_dot_forms_probe.FORMS)
def test_dot_forms_match_jax(interpret, form, layout, a_shape, b_shape):
    dims = {"nn": ((1,), (0,)), "nt": ((1,), (1,)), "tn": ((0,), (0,))}[layout]
    a = jnp.asarray(np.random.default_rng(0).standard_normal(a_shape),
                    jnp.bfloat16)
    b = jnp.asarray(np.random.default_rng(1).standard_normal(b_shape),
                    jnp.bfloat16)
    m, _, n = pk.gemm_dims(_t(a), _t(b), layout)
    want = pl.pallas_call(jax_forms.make_kernel(dims),
                          out_shape=jax.ShapeDtypeStruct((m, n),
                                                         jnp.float32))(a, b)
    pa, pb = mosaic_dot_forms_probe.operands(a_shape, b_shape, "cpu")
    assert torch.equal(pa, _t(a)) and torch.equal(pb, _t(b))
    got = pk.tile_gemm(pa, pb, mosaic_dot_forms_probe.CHECK_TILE, layout,
                       torch.float32)
    assert got.dtype == torch.float32
    _close(got, want, mosaic_dot_forms_probe.REL_TOL)
    res = mosaic_dot_forms_probe.run(form, layout, a_shape, b_shape, "cpu")
    assert res["ok"]


def test_tile_gemm_refuses_what_the_kernel_does_not_take():
    a = torch.zeros(256, 128, dtype=torch.bfloat16)
    b = torch.zeros(128, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="variant"):
        pk.tile_gemm(a, b, (256, 256, 32))
    with pytest.raises(ValueError, match="variant"):
        pk.tile_gemm(a, b.t().contiguous(), (128, 256, 64), "nt",
                     torch.float32)
    with pytest.raises(ValueError, match="divide"):
        pk.tile_gemm(a[:200], b, (128, 128, 32))
    with pytest.raises(ValueError, match="contracted"):
        pk.tile_gemm(a, b, (64, 64, 32), "nt", torch.float32)
    with pytest.raises(ValueError, match="layout"):
        pk.tile_gemm(a, b, (64, 64, 32), "tt", torch.float32)
    with pytest.raises(ValueError, match="divide"):
        pallas_gemm_probe.make_mm(200, 128, 256, 128, 128, 32)


# ---------------------------------------------------------------------------
# K17 / K18: the attention microbench at its full shapes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_inputs():
    bf = jax_attn.make_inputs(jnp.bfloat16)
    i8 = jax_attn.make_inputs(jnp.int8)
    return bf, i8


def _port(args):
    return [None if a is None else _t(a) for a in args]


@pytest.mark.parametrize("cache,bt", [("bf16", 2), ("bf16", 4), ("bf16", 8),
                                      ("int8", 4), ("int8", 8)])
def test_blockdiag_attn_matches_jax(interpret, attn_inputs, cache, bt):
    args = attn_inputs[0 if cache == "bf16" else 1]
    want = jax_attn.blockdiag_attn(*args, bt=bt)
    q, k, v, bias, ks, vs = _port(args)
    got = pk.blockdiag_decode_attention(q, k, v, bias, ks, vs, bt=bt)
    assert got.dtype == torch.bfloat16 and got.shape == (32, 16, 64)
    err = np.abs(got.float().numpy()
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err <= 2e-3, err


def test_batcheddot_attn_matches_jax(interpret, attn_inputs):
    want = jax_attn.batcheddot_attn(*attn_inputs[0], bt=4)
    q, k, v, bias, _, _ = _port(attn_inputs[0])
    got = pk.batched_decode_attention(q, k, v, bias, bt=4)
    err = np.abs(got.float().numpy()
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err <= 2e-3, err


@pytest.mark.parametrize("cache", [jnp.bfloat16, jnp.int8])
def test_microbench_inputs_and_reference_match_jax(attn_inputs, cache):
    """make_inputs gives the JAX script's arrays; torch_attn is xla_attn."""
    want = attn_inputs[0 if cache == jnp.bfloat16 else 1]
    got = attn_microbench.make_inputs(
        torch.int8 if cache == jnp.int8 else torch.bfloat16, "cpu")
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, _t(w))
    ref = jax_attn.xla_attn(*want)
    err = np.abs(attn_microbench.torch_attn(*got).float().numpy()
                 - np.asarray(ref.astype(jnp.float32))).max()
    assert err <= 2e-3, err


def test_attention_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(4, 16, 64, dtype=torch.bfloat16)
    k = torch.zeros(4, 16, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bt"):
        pk.blockdiag_decode_attention(q, k, k, None, bt=3)
    with pytest.raises(ValueError, match="T in"):
        pk.blockdiag_decode_attention(q, k[..., :96], k[..., :96], None)
    with pytest.raises(ValueError, match="int8"):
        pk.blockdiag_decode_attention(q, k.to(torch.int8), k.to(torch.int8))
    with pytest.raises(ValueError, match="differ"):
        pk.batched_decode_attention(q, k, k[:, :8], None)


# ---------------------------------------------------------------------------
# K19: the scratch probe
# ---------------------------------------------------------------------------

def test_vmem_probe_matches_jax(monkeypatch):
    """JAX's probe compiles and runs in the interpreter; the kernel it built,
    run again on a random x, gives row 0 equal to the port's twin's."""
    seen = {}
    orig = pl.pallas_call

    def recording(kernel, **kw):
        seen.update(kernel=kernel, **kw)
        return orig(kernel, interpret=True, **kw)

    monkeypatch.setattr(pl, "pallas_call", recording)
    assert jax_vmem.probe(1)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 128)),
                    jnp.bfloat16)
    want = orig(seen.pop("kernel"), interpret=True, **seen)(x)
    got = pk.smem_probe(_t(x), 1024 * 1024)
    assert torch.equal(got[0], _t(want)[0])
    assert torch.equal(got[0], _t(x)[0] * 2)


def test_smem_probe_twin_and_refusals():
    x = torch.randn(8, 128).to(torch.bfloat16)
    out = pk.smem_probe(x, 2048)
    assert torch.equal(out[0], x[0] * 2) and not out[1:].any()
    with pytest.raises(ValueError, match="rows"):
        pk.smem_probe(x, 1024)
    with pytest.raises(ValueError, match="rows"):
        pk.smem_probe(x, 4000)
    with pytest.raises(ValueError, match="8, 128"):
        pk.smem_probe(x[:4], 4096)


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def test_tools_run_the_twins_on_the_cpu_at_small_shapes(capsys):
    gemm_probe.bench(256, 128, 256, device="cpu", reps=1)
    rows = pallas_gemm_probe.main(device="cpu", shapes=[(256, 128, 256)],
                                  tiles=[(128, 128, 64), (64, 64, 32)], reps=1)
    assert [r["max_abs_err"] for r in rows] == [0.0, 0.0]
    assert mosaic_dot_forms_probe.main(device="cpu",
                                       time_shape=(256, 128, 256)) == 0
    rows = attn_microbench.main(device="cpu", shape=(8, 16, 16, 128), reps=1)
    # the kernels of the same roundings as the reference agree with it; the
    # per-op kernel (weights unrounded) and the int8 caches only roughly
    errs = {r["name"]: r["max_abs_err"] for r in rows}
    assert len(rows) == 11
    assert all(e <= (2e-3 if n.startswith(("blockdiag bf16", "batcheddot"))
                     else 2e-2) for n, e in errs.items() if e is not None)
    res = vmem_probe.main(device="cpu", limit_kb=256)
    assert res == {"largest_kb": 256, "refused_kb": None, "optin_bytes": None,
                   "assumed_holds": None}
    out = capsys.readouterr().out
    assert "device: cpu" in out and "device: cuda" not in out
    assert "A^T@B ((0,),(0,)): OK" in out


@pytest.mark.parametrize("tool", [gemm_probe, pallas_gemm_probe,
                                  mosaic_dot_forms_probe, attn_microbench,
                                  vmem_probe])
def test_tools_raise_without_a_gpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()


def test_tools_import_no_jax():
    code = ("import sys\n"
            "from acai_omr_tpu_torch.tools import attn_microbench, "
            "gemm_probe, mosaic_dot_forms_probe, pallas_gemm_probe, "
            "vmem_probe, int4_probe, unpack_probe, dma_issue_probe, "
            "dma_skip_probe, narrow_lane_dma_probe, mosaic_head_access_probe, "
            "mosaic_batched_attn_probe, vpu_probe, bwd_vmem_probe\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'acai_omr_tpu', 'tools'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
