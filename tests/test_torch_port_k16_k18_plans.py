"""The plans and shape rules of K16 ``tile_gemm`` on persistent blocks
(``tile_gemm_schedule``: every tile once, grouped along M, ``tile_gemm_blocks``
the grid) and of K18 ``batched_decode_attention`` on one block per (row, head)
(``batched_route``: how its kernel loads), the variants both
launchers take, and K18's twin against the JAX tool's
``tools/attn_microbench.batcheddot_attn`` in the Pallas interpreter with a
third of the keys masked through the bias. Nothing here asks for the card: a
build or a bind fails these tests.

Tolerance: K18's bf16 outputs within 4e-3 absolute of JAX's, the limit the
card's checks hold the kernel to (outputs below 0.5 where tens of keys are
averaged; a weight rounded to bf16 on the other side of a tie moves an output
by one bf16 ulp, 2e-3 at 0.5).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import probe_kernels as pk
from acai_omr_tpu_torch.ops.linear_kernel import N_SMS
from acai_omr_tpu_torch.tools import mosaic_dot_forms_probe as forms
from acai_omr_tpu_torch.tools import pallas_gemm_probe as pgp
from tools import attn_microbench as jax_attn

from _torch_port_threads import torch_one_thread  # noqa: F401

K16 = pk.tile_gemm
K18 = pk.batched_decode_attention


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


# ---------------------------------------------------------------------------
# K16: the persistent blocks' tiles, the grid, the variants
# ---------------------------------------------------------------------------

# every compiled (tile, out dtype): the sweep's bf16 tiles and the forms'
VARIANTS = [(t, torch.bfloat16) for t in pk.SWEEP_TILES] \
    + [(t, torch.float32) for t in pk.FORM_TILES]
# the sweep's shapes, the dot forms' (M, N), and a small multi-wave shape
GEMM_MN = [(m, n) for m, _, n in pgp.SHAPES] + [
    (forms.TIME_SHAPE[0], forms.TIME_SHAPE[2]), (256, 512), (256, 256),
    (2048, 1536)]


@pytest.mark.parametrize("tile,out_dtype", VARIANTS,
                         ids=[f"{'x'.join(map(str, t))}-{str(d)[6:]}"
                              for t, d in VARIANTS])
def test_tile_gemm_schedule_covers_every_tile_once(tile, out_dtype):
    """At every shape the tile divides: the grid is the rule's, every
    block has work, the blocks' tile counts differ by at most one, and the
    tiles together are the (M / BM) x (N / BN) grid, each once."""
    bm, bn, _ = tile
    for m, n in GEMM_MN:
        if m % bm or n % bn:
            continue
        every = sorted((i * bm, j * bn) for i in range(m // bm)
                       for j in range(n // bn))
        blocks = pk.tile_gemm_blocks(m, n, tile, out_dtype)
        sched = pk.tile_gemm_schedule(m, n, bm, bn, blocks)
        assert len(sched) == blocks and all(sched)
        sizes = {len(b) for b in sched}
        assert max(sizes) - min(sizes) <= 1
        assert sorted(t for b in sched for t in b) == every


def test_tile_gemm_schedule_multi_wave_order():
    """More tiles than blocks: block b takes tiles b, b + G, ...; the order
    walks GEMM_GROUP_M tile rows down before the next column, so the first
    wave of G = 20 blocks spans 8 tile rows and 3 columns; the last group
    of a grid whose rows are not a multiple of 8 is narrower."""
    m, n, bm, bn = 640, 512, 64, 64  # 10 x 8 tiles
    sched = pk.tile_gemm_schedule(m, n, bm, bn, 20)
    order = [pk.tile_gemm_tile(i, m, n, bm, bn) for i in range(80)]
    for b, block in enumerate(sched):
        assert block == order[b::20]
    wave = order[:20]
    assert {r for r, _ in wave} == {i * bm for i in range(8)}
    assert {c for _, c in wave} == {0, bn, 2 * bn}
    # the first group: rows 0..7 of column 0, then of column 1, ...
    assert order[:9] == [(i * bm, 0) for i in range(8)] + [(0, bn)]
    # the last group holds tile rows 8 and 9 only
    assert order[64:68] == [(8 * bm, 0), (9 * bm, 0), (8 * bm, bn),
                            (9 * bm, bn)]
    for bad in (0, 81):
        with pytest.raises(ValueError, match="blocks"):
            pk.tile_gemm_schedule(m, n, bm, bn, bad)


def test_tile_gemm_grid_size_rule():
    """The ring: the blocks an SM holds at six stages beside the output
    staging (one where six do not fit a block), then as many stages as
    those blocks leave room for, up to eight, at least two, inside a block's
    227 KB (three 48 KB stages at 128x256x64 beside the 64 KB bf16
    staging); the grid: those blocks an SM times the SMs, no more than the
    tiles."""
    for tile, out_dtype in VARIANTS:
        stages, smem = pk.tile_gemm_smem(tile, out_dtype)
        bm, bn, bk = tile
        out = bm * bn * (4 if out_dtype == torch.float32 else 2)
        assert 2 <= stages <= pk.GEMM_MAX_STAGES
        assert smem == stages * (bm * bk + bk * bn) * 2 + out + 1024
        assert smem + pk.GEMM_STATIC <= pk.GEMM_SMEM_LIMIT
        per_sm = pk.tile_gemm_blocks_per_sm(tile, out_dtype)
        assert per_sm * (smem + pk.GEMM_STATIC + 1024) <= pk.GEMM_SM_SMEM
        # one more stage would cost a block an SM, or pass a limit
        more = smem + (bm * bk + bk * bn) * 2
        assert stages == pk.GEMM_MAX_STAGES \
            or more + pk.GEMM_STATIC > pk.GEMM_SMEM_LIMIT \
            or per_sm * (more + pk.GEMM_STATIC + 1024) > pk.GEMM_SM_SMEM
    assert pk.tile_gemm_smem((128, 256, 64)) == (3, 214016)
    assert pk.tile_gemm_smem((128, 128, 64)) == (6, 230400)
    assert pk.tile_gemm_smem((64, 64, 32)) == (8, 74752)
    assert pk.tile_gemm_smem((128, 64, 32)) == (7, 103424)
    assert pk.tile_gemm_smem((128, 128, 32), torch.float32) == (8, 197632)
    assert pk.tile_gemm_blocks_per_sm((64, 64, 32)) == 3
    assert pk.tile_gemm_blocks_per_sm((64, 64, 64)) == 2
    assert pk.tile_gemm_blocks_per_sm((128, 128, 32), torch.float32) == 1
    assert pk.tile_gemm_blocks(8192, 3072, (128, 128, 32)) == N_SMS
    assert pk.tile_gemm_blocks(8192, 3072, (64, 64, 32)) == 3 * N_SMS
    assert pk.tile_gemm_blocks(256, 256, (128, 128, 32)) == 4
    assert pk.tile_gemm_blocks(256, 64, (64, 64, 32), torch.float32) == 4


def test_tile_gemm_variants_on_the_cpu():
    """None and "wmma" run the twin; anything else is refused before it
    runs, as are the tiles the kernel does not take."""
    g = torch.Generator().manual_seed(16)
    a = torch.randn(128, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, 128, generator=g).to(torch.bfloat16)
    want = K16.plain(a, b, (64, 64, 32))
    for variant in (None, "wmma"):
        assert torch.equal(K16(a, b, (64, 64, 32), variant=variant), want)
        assert torch.equal(K16(a, b.t().contiguous(), (64, 64, 32), "nt",
                               torch.float32, variant=variant),
                           K16.plain(a, b.t().contiguous(), (64, 64, 32),
                                     "nt", torch.float32))
    for bad in ("warp", "split2", "persistent"):
        with pytest.raises(ValueError, match="unknown variant"):
            K16(a, b, (64, 64, 32), variant=bad)
    with pytest.raises(ValueError, match="divide"):
        K16(a[:96], b, (64, 64, 32), variant="wmma")


# ---------------------------------------------------------------------------
# K18: the route, the variants
# ---------------------------------------------------------------------------

def test_batched_route():
    """16-byte loads wherever T is whole groups of 8 keys and the planes are
    16-byte aligned, whatever T's length; else one load a key."""
    for t in (8, 96, 512, 1024, 2056, 4096):
        assert pk.batched_route(t) == "vector"
    for t in (1, 100, 3001):
        assert pk.batched_route(t) == "scalar"
    assert pk.batched_route(512, aligned=False) == "scalar"


def test_batched_variants_on_the_cpu():
    """None and "warp" run the twin whatever bt is; anything else is
    refused, as are a bt that does not divide B and H other than 16."""
    g = torch.Generator().manual_seed(18)
    b, t = 8, 96
    q = torch.randn(b, 16, 32, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, 16, 32, t, generator=g).to(torch.bfloat16)
            for _ in range(2))
    want = K18.plain(q, k, v, None, bt=1)
    for bt in (1, 2, 4, 8):
        for variant in (None, "warp"):
            assert torch.equal(K18(q, k, v, None, bt=bt, variant=variant),
                               want)
    for bad in ("wmma", "split2", "vector"):
        with pytest.raises(ValueError, match="unknown variant"):
            K18(q, k, v, None, bt=4, variant=bad)
    with pytest.raises(ValueError, match="bt"):
        K18(q, k, v, None, bt=3)
    with pytest.raises(ValueError, match="H = 16"):
        K18(q[:, :8], k[:, :8], v[:, :8], None, bt=4)


# ---------------------------------------------------------------------------
# K18's twin against JAX's batcheddot_attn, a third of the keys masked
# ---------------------------------------------------------------------------

JAX_B, JAX_BT = 8, 4


def _masked_inputs(t: int):
    """The script's q / kT / vT at B = 8 and T keys (numpy seed 0, as
    make_inputs draws them), and a (B, T) bias masking a third of the keys
    at -1e9 (key 0 never)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((JAX_B, jax_attn.H, jax_attn.DH))
    k = rng.standard_normal((JAX_B, jax_attn.H, jax_attn.DH, t))
    v = rng.standard_normal((JAX_B, jax_attn.H, jax_attn.DH, t))
    mask = np.random.default_rng(t).random((JAX_B, t)) < 1 / 3
    mask[:, 0] = False
    bias = np.where(mask, -1e9, 0.0).astype(np.float32)
    return q, k, v, bias


@pytest.fixture(scope="module")
def masked_jax():
    """JAX's batcheddot_attn in the interpreter at T = 96 and 320 (its
    module's B and T set for the call), bf16 caches, bt 4."""
    interp = functools.partial(pl.pallas_call, interpret=True)
    saved = (pl.pallas_call, jax_attn.B, jax_attn.T)
    out = {}
    try:
        pl.pallas_call = interp
        for t in (96, 320):
            jax_attn.B, jax_attn.T = JAX_B, t
            q, k, v, bias = _masked_inputs(t)
            args = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                    jnp.asarray(v, jnp.bfloat16), jnp.asarray(bias))
            want = jax_attn.batcheddot_attn(*args, None, None, bt=JAX_BT)
            out[t] = (args, np.asarray(want.astype(jnp.float32)))
    finally:
        pl.pallas_call, jax_attn.B, jax_attn.T = saved
    return out


def _torch(x) -> torch.Tensor:
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))) \
            .to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("t", [96, 320])
def test_batched_twin_matches_jax_with_masked_keys(masked_jax, t):
    args, want = masked_jax[t]
    assert want.shape == (JAX_B, 16, 64) and np.isfinite(want).all()
    got = K18(*[_torch(a) for a in args], bt=JAX_BT)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 4e-3, err
    # a masked key changes nothing: its values replaced, the same output
    q, k, v, bias = (_torch(a) for a in args)
    masked = bias < -1.0
    k2, v2 = k.clone(), v.clone()
    k2.masked_fill_(masked[:, None, None, :], 7.0)
    v2.masked_fill_(masked[:, None, None, :], -7.0)
    assert torch.equal(K18(q, k2, v2, bias, bt=JAX_BT), got)
