"""The port's int4 and memory-stream probe kernels and tools against the JAX
package's probes, on the CPU: K20 ``int4_delivery_gemm`` against the five
kernels of ``tools/int4_probe`` (``_k_i8ref``, ``_k_s4dot``, ``_k_s4conv``,
``_k_i8shift``, ``_k_f32unpack``); K21 ``int4_unpack`` against
``tools/unpack_probe.KERNELS`` at the tool's (512, 4096) with every byte
value present; K22 ``bulk_copy_ring`` against ``tools/dma_issue_probe.build``;
K23 ``clamped_chunk_sum`` against ``tools/dma_skip_probe.kernel`` under the
grid spec of its ``run``; K24 ``lane_stream_sum`` against the kernel of
``tools/narrow_lane_dma_probe.stream_sum``. The JAX kernels run in the
Pallas interpreter (``pl.pallas_call`` patched with ``interpret=True``, or a
recorder that captures the call a JAX function builds and calls it again on
seeded inputs); the port's wrappers get CPU tensors and so run their plain
twins.

Tolerances: K20-K22 exact (integer products, byte unpacks, a copied tile).
K23 and K24 within 1e-5 of the largest |output| (fp32 sums in another
order); K23's inputs are small integers, so JAX's bf16 chunk sums are exact
and both sides agree bit for bit in practice.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from acai_omr_tpu_torch.ops import int4_probe_kernels as ik
from acai_omr_tpu_torch.ops import stream_probe_kernels as sk
from acai_omr_tpu_torch.ops.quant_linear_kernel import (
    pack_k8_int4, quant4_linear_bias_act, quant_linear_bias_act, pack_k4,
    unpack_k8_int4)
from acai_omr_tpu_torch.tools import (_probe, dma_issue_probe, dma_skip_probe,
                                      int4_probe, narrow_lane_dma_probe,
                                      unpack_probe)
from tools import dma_issue_probe as jax_issue
from tools import dma_skip_probe as jax_skip
from tools import int4_probe as jax_int4
from tools import narrow_lane_dma_probe as jax_lane
from tools import unpack_probe as jax_unpack

from _torch_port_threads import torch_one_thread  # noqa: F401

REL_TOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture
def recorder(monkeypatch):
    """Captures the kernel and keywords of the next ``pl.pallas_call`` (run in
    the interpreter)."""
    seen = {}
    orig = pl.pallas_call

    def recording(kernel, **kw):
        seen.update(kernel=kernel, **kw)
        return orig(kernel, interpret=True, **kw)

    monkeypatch.setattr(pl, "pallas_call", recording)
    return lambda: functools.partial(orig, interpret=True)(
        seen.pop("kernel"), **seen)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# K20: the int4 delivery schemes
# ---------------------------------------------------------------------------

_JAX_KERNELS = {"i8ref": jax_int4._k_i8ref, "s4dot": jax_int4._k_s4dot,
                "s4conv": jax_int4._k_s4conv, "i8shift": jax_int4._k_i8shift,
                "f32unpack": jax_int4._k_f32unpack}


def _jax_product(scheme, lo, hi, x):
    w_full = np.concatenate([lo, hi], 0)
    if scheme in ("s4dot", "s4conv"):
        w_in = jnp.asarray(w_full, jnp.int4)
    elif scheme == "i8ref":
        w_in = jnp.asarray(w_full, jnp.int8)
    else:
        w_in = jnp.asarray(jax_int4.pack_bytes(lo, hi))
    return np.asarray(pl.pallas_call(
        _JAX_KERNELS[scheme],
        out_shape=jax.ShapeDtypeStruct((x.shape[0], lo.shape[1]), jnp.int32),
        interpret=True)(jnp.asarray(x, jnp.int8), w_in))


@pytest.mark.parametrize("scheme,shape", [
    *((s, int4_probe.LEGALITY_SHAPE) for s in ik.GEMM_SCHEMES),
    ("i8shift", int4_probe.TIMING_SHAPE)])
def test_int4_delivery_gemm_matches_jax(scheme, shape):
    lo, hi, x = int4_probe.make_inputs(*shape)
    want = _jax_product(scheme, lo.numpy(), hi.numpy(), x.numpy())
    got = ik.int4_delivery_gemm(x, ik.scheme_weights(lo, hi, scheme), scheme)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    exact = x.double() @ torch.cat([lo, hi], 0).double()
    assert torch.equal(got.double(), exact)


def test_int4_inputs_and_packing_match_jax():
    """make_inputs draws the JAX tool's values; pack_bytes is its packing;
    -8 survives both packings (the TPU bytes and K14's words)."""
    bt, cin, cout = int4_probe.LEGALITY_SHAPE
    rng = np.random.default_rng(0)
    lo = rng.integers(-8, 8, (cin // 2, cout), np.int32)
    hi = rng.integers(-8, 8, (cin // 2, cout), np.int32)
    x = rng.integers(-127, 128, (bt, cin), np.int32)
    for got, want in zip(int4_probe.make_inputs(bt, cin, cout), (lo, hi, x)):
        assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        ik.pack_bytes(torch.from_numpy(lo), torch.from_numpy(hi)).numpy(),
        jax_int4.pack_bytes(lo, hi))
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(4).reshape(64, 1) \
        .expand(64, 16).contiguous()
    assert torch.equal(unpack_k8_int4(pack_k8_int4(q)), q)
    lo8, hi8 = ik.unpack_bytes(ik.pack_bytes(q, q.flip(0)))
    assert torch.equal(lo8, q) and torch.equal(hi8, q.flip(0))


def test_k14_twin_takes_minus_eight():
    """K14's twin on weights holding -8 equals K5's twin on the same int8
    values: the widened packer keeps the kernel's arithmetic."""
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-8, 8, (128, 64), generator=g, dtype=torch.int8)
    q[0] = -8
    x = torch.randn(4, 128, generator=g)
    s = torch.rand(64, generator=g) + 0.5
    b = torch.randn(64, generator=g)
    assert torch.equal(quant4_linear_bias_act(x, pack_k8_int4(q), s, b),
                       quant_linear_bias_act(x, pack_k4(q), s, b))


def test_int4_wrappers_refuse_what_the_kernels_do_not_take():
    lo = torch.zeros(128, 512, dtype=torch.int8)
    x = torch.zeros(8, 256, dtype=torch.int8)
    w = ik.scheme_weights(lo, lo, "i8shift")
    with pytest.raises(ValueError, match="bt must be"):
        ik.int4_delivery_gemm(torch.zeros(33, 256, dtype=torch.int8), w,
                              "i8shift")
    with pytest.raises(ValueError, match="cin"):
        ik.int4_delivery_gemm(x[:, :96], w[:48], "i8shift")
    with pytest.raises(ValueError, match="cout"):
        ik.int4_delivery_gemm(x, w[:, :256], "i8shift")
    with pytest.raises(ValueError, match="weights must be"):
        ik.int4_delivery_gemm(x, w, "s4dot")
    with pytest.raises(ValueError, match="scheme"):
        ik.int4_delivery_gemm(x, w, "s8dot")
    with pytest.raises(ValueError, match="multiples of 16"):
        ik.int4_unpack(torch.zeros(24, 64, dtype=torch.int8), "i32")
    with pytest.raises(ValueError, match="reps"):
        ik.int4_unpack(torch.zeros(16, 64, dtype=torch.int8), "i32", 0)
    with pytest.raises(ValueError, match="scheme"):
        ik.int4_unpack(torch.zeros(16, 64, dtype=torch.int8), "u8")


# ---------------------------------------------------------------------------
# K21: the unpack schemes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed_block():
    wp, want = unpack_probe.make_block()
    wp[0, :256] = torch.arange(-128, 128).to(torch.int8)
    assert torch.unique(wp).numel() == 256
    return wp


@pytest.mark.parametrize("scheme", ik.UNPACK_SCHEMES)
def test_int4_unpack_matches_jax(packed_block, scheme):
    half, out = packed_block.shape
    args = [jnp.asarray(packed_block.numpy())]
    if scheme == "eyedot":
        args.append(jnp.asarray(np.eye(half, dtype=np.int8)))
    want = pl.pallas_call(
        functools.partial(jax_unpack.KERNELS[scheme], reps=1),
        out_shape=jax.ShapeDtypeStruct((2 * half, out), jnp.int8),
        interpret=True)(*args)
    got = ik.int4_unpack(packed_block, scheme, 2)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_unpack_block_matches_jax_tool():
    wp, want = unpack_probe.make_block()
    rng = np.random.default_rng(0)
    lo = rng.integers(-8, 8, (jax_unpack.HALF, jax_unpack.OUT), np.int32)
    hi = rng.integers(-8, 8, (jax_unpack.HALF, jax_unpack.OUT), np.int32)
    assert np.array_equal(wp.numpy(), jax_unpack.pack(lo, hi))
    assert np.array_equal(want.numpy(), np.concatenate([lo, hi], 0))


# ---------------------------------------------------------------------------
# K22: the bulk-copy ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frags,steps,slots", [(1, 3, 2), (2, 4, 3),
                                               (4, 2, 3)])
def test_bulk_copy_ring_matches_jax(interpret, frags, steps, slots):
    fn, src, nbytes = jax_issue.build(frags, steps, slots, 0.0625)
    rng = np.random.default_rng(frags)
    data = rng.standard_normal(src.shape).astype(np.float32)
    want = fn(jnp.asarray(data, jnp.bfloat16))
    t = torch.from_numpy(data).to(torch.bfloat16)
    got = sk.bulk_copy_ring(t, slots, frags, t.shape[1] // 8)
    assert torch.equal(got.float(), torch.from_numpy(
        np.array(want.astype(jnp.float32))))
    assert nbytes == t.numel() * 2


def test_ring_refuses_what_the_kernel_does_not_take():
    src = torch.zeros(2, 64, sk.LANES, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        sk.bulk_copy_ring(src, 2, 1, 1)  # 2 x 128 KB
    with pytest.raises(ValueError, match="16 bytes"):
        sk.bulk_copy_ring(src, 2, 3, 2)
    with pytest.raises(ValueError, match="slots"):
        sk.bulk_copy_ring(src, 9, 1, 8)
    with pytest.raises(ValueError, match="8 rows"):
        sk.bulk_copy_ring(src, 2, 1, 16)
    with pytest.raises(ValueError, match="expect_tx"):
        sk.ring_plan(torch.zeros(1, 512, sk.LANES, dtype=torch.bfloat16),
                     2, 1, 1, smem_limit=2 ** 22)


# ---------------------------------------------------------------------------
# K23: clamped chunk sums
# ---------------------------------------------------------------------------

@pytest.fixture
def small_skip(monkeypatch, recorder):
    """JAX's dma_skip_probe at (8, 64, 128): its pallas_call, captured."""
    monkeypatch.setattr(jax_skip, "N_CHUNKS", 8)
    monkeypatch.setattr(jax_skip, "CH", 64)
    monkeypatch.setattr(jax_skip, "E", 128)
    jax_skip.run(0)
    return recorder()


@pytest.mark.parametrize("mode", sk.MODES)
def test_clamped_chunk_sum_matches_jax(small_skip, mode):
    rng = np.random.default_rng(1)
    data = rng.integers(-2, 3, (8, 64, 128)).astype(np.float32)
    x = jnp.asarray(data, jnp.bfloat16)
    t = torch.from_numpy(data).to(torch.bfloat16)
    for s in (0, 3, 7):
        want = small_skip(jnp.asarray([s], jnp.int32), x)
        got = sk.clamped_chunk_sum(t, torch.tensor([s], dtype=torch.int32),
                                   mode)
        assert got.shape == (1, 128) and got.dtype == torch.float32
        _close(got, want)


def test_chunk_and_lane_wrappers_refuse():
    x = torch.zeros(4, 64, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        sk.clamped_chunk_sum(torch.zeros(4, 64, 128, dtype=torch.bfloat16),
                             torch.zeros(1))
    with pytest.raises(ValueError, match="mode"):
        sk.clamped_chunk_sum(x, torch.zeros(1, dtype=torch.int32), "fetch")
    with pytest.raises(ValueError, match="multiple of 128"):
        sk.clamped_chunk_sum(x, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="lanes"):
        sk.lane_stream_sum(torch.zeros(4, 64, 24), torch.zeros(1, 24))
    with pytest.raises(ValueError, match="c must be"):
        sk.lane_stream_sum(torch.zeros(4, 64, 16), torch.zeros(16))
    with pytest.raises(ValueError, match="1024"):
        sk.lane_stream_sum(torch.zeros(1, 3, 16), torch.zeros(1, 16))


def test_clamped_chunk_sum_edges():
    x = torch.randn(4, 16, 128).to(torch.bfloat16)
    for s, last in ((-3, -1), (-1, -1), (9, 3)):
        got = sk.clamped_chunk_sum(x, torch.tensor([s], dtype=torch.int32))
        assert torch.equal(got, x[: last + 1].float().sum((0, 1))[None])


# ---------------------------------------------------------------------------
# K24: lane sums of a flat stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [16, 128])
def test_lane_stream_sum_matches_jax(monkeypatch, recorder, lanes):
    monkeypatch.setattr(jax_lane, "N_BLOCKS", 8)
    monkeypatch.setattr(jax_lane, "T", 64)
    jax_lane.stream_sum(lanes, iters=1)
    call = recorder()
    rng = np.random.default_rng(lanes)
    x = rng.standard_normal((8, 64, lanes)).astype(np.float32)
    c = rng.standard_normal((1, lanes)).astype(np.float32)
    want = call(jnp.asarray(x), jnp.asarray(c))
    got = sk.lane_stream_sum(torch.from_numpy(x), torch.from_numpy(c))
    assert got.shape == (1, lanes)
    _close(got, want)


# ---------------------------------------------------------------------------
# the timer's rotation and the tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes", [1, 2 * 2 ** 20, 8 * 2 ** 20,
                                    64 * 2 ** 20, 99 * 2 ** 20,
                                    100 * 2 ** 20, 512 * 2 ** 20])
def test_cold_copies_stream_twice_the_l2(nbytes):
    l2 = _probe.H100_L2_BYTES
    n = _probe.cold_copies(nbytes, l2)
    assert n * nbytes >= 2 * l2 and n & (n - 1) == 0
    assert n == 1 or (n // 2) * nbytes < 2 * l2


def test_time_ms_rotates_over_the_copies():
    seen = []
    _probe.time_ms(lambda i: seen.append(i), torch.device("cpu"), reps=6,
                   copies=3)
    assert seen == [0, 0, 1, 2, 0, 1, 2]
    calls = []
    _probe.time_ms(lambda: calls.append(1), torch.device("cpu"), reps=2)
    assert len(calls) == 3
    with pytest.raises(ValueError, match="copies"):
        _probe.time_ms(lambda i: None, torch.device("cpu"), copies=0)
    assert _probe.residency(torch.device("cpu"), 16, 8 * 2 ** 20) == "cpu"


def test_tools_run_the_twins_on_the_cpu_at_small_shapes(capsys):
    res = int4_probe.main(["--reps", "1"], device="cpu",
                          timing_shape=(8, 256, 512))
    assert all(res["legality"].values()) and len(res["timing"]) == 5
    res = unpack_probe.main(["--reps", "1"], device="cpu", shape=(32, 64))
    assert all(r["exact"] for r in res.values()) and len(res) == 5
    res = dma_issue_probe.main(["--steps", "3", "--slot-kb", "16",
                                "--blocks", "2", "--reps", "1"],
                               device="cpu")
    assert res["tile_ok"] and len(res["rows"]) == 7
    res = dma_skip_probe.main(["--reps", "1"], device="cpu",
                              shape=(8, 64, 128))
    assert res["ok"] and set(res["ratio"]) == set(sk.MODES)
    assert len(res["rows"]) == 6
    res = narrow_lane_dma_probe.main(["--iters", "1"], device="cpu",
                                     n_blocks=8, t=64)
    assert res["ok"] and set(res["rows"]) == {16, 128, "16 at 128's bytes"}
    l2 = _probe.H100_L2_BYTES
    for row in res["rows"].values():
        assert row["copies"] == _probe.cold_copies(
            row["blocks"] * 64 * row["lanes"] * 4, l2)
    # at the tool's size: the 8 MiB array over 16 copies, 64 MiB over 2
    assert _probe.cold_copies(256 * 512 * 16 * 4, l2) == 16
    assert _probe.cold_copies(256 * 512 * 128 * 4, l2) == 2
    out = capsys.readouterr().out
    assert "device: cpu" in out and "device: cuda" not in out
    assert "[legality] s4conv    : EXACT" in out
    assert "narrow/full efficiency" in out and "from HBM" not in out


@pytest.mark.parametrize("tool", [int4_probe, unpack_probe, dma_issue_probe,
                                  dma_skip_probe, narrow_lane_dma_probe])
def test_tools_raise_without_a_gpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()
