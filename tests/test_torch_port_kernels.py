"""The port's hand-written CUDA kernels against their plain PyTorch twins.

These need an NVIDIA GPU with ``nvcc`` (they build ``csrc/`` at first use) and
skip elsewhere: run them on the card with

    python -m pytest tests/test_torch_port_kernels.py -m cuda -q

Small shapes, bf16 on the card; tolerance about one bf16 ulp of the output's
largest magnitude (the kernels sum in another order than the twins). The int8
kernels' integer parts are exact on both sides: the rows and scales they
append must equal the twin's bit for bit, their outputs agree within two bf16
ulps of the largest output.
"""

import math

import pytest
import torch

from acai_omr_tpu_torch.ops.decode_kernel import (decode_attention,
                                                  decode_attention_int8,
                                                  quantize_rows)
from acai_omr_tpu_torch.ops.encoder_stack_kernel import (encoder_attention,
                                                         encoder_stack_fused)
from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm
from acai_omr_tpu_torch.ops.linear_kernel import linear_bias_act
from acai_omr_tpu_torch.ops.quant_linear_kernel import (pack_k4,
                                                        quant_linear_bias_act)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, *shape, dev, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


def _close(a, b, rel=1e-2):
    tol = rel * max(1.0, b.float().abs().max().item())
    assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("m,k,n,act", [(5, 64, 128, "none"),
                                       (32, 256, 1024, "gelu_rounded"),
                                       (300, 512, 192, "gelu")])
def test_linear_bias_act(dev, m, k, n, act):
    g = torch.Generator(device=dev).manual_seed(0)
    x = _randn(g, m, k, dev=dev)
    w = (_randn(g, k, n, dev=dev, dtype=torch.float32) / math.sqrt(k)) \
        .to(torch.bfloat16)
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    _close(linear_bias_act(x, w, b, act), linear_bias_act.plain(x, w, b, act))


@pytest.mark.parametrize("pos", [0, 7, 63])
def test_decode_attention_self_appends(dev, pos):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = _randn(g, 4, 3 * 256, dev=dev)
    kc, vc = _randn(g, 4, 64, 256, dev=dev), _randn(g, 4, 64, 256, dev=dev)
    kp, vp = kc.clone(), vc.clone()
    _close(decode_attention(qkv, kc, vc, 4, pos=pos),
           decode_attention.plain(qkv, kp, vp, 4, pos=pos))
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


def test_decode_attention_cross(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    q = _randn(g, 3, 256, dev=dev)
    mk, mv = _randn(g, 3, 48, 256, dev=dev), _randn(g, 3, 48, 256, dev=dev)
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 5, 30], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    _close(decode_attention(q, mk, mv, 4, bias=bias),
           decode_attention.plain(q, mk, mv, 4, bias=bias))


def test_decode_attention_cross_grouped(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    q = _randn(g, 6, 256, dev=dev)
    mk, mv = _randn(g, 2, 48, 256, dev=dev), _randn(g, 2, 48, 256, dev=dev)
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 17], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    out = decode_attention(q, mk, mv, 4, bias=bias, mem_group=3)
    _close(out, decode_attention.plain(q, mk, mv, 4, bias=bias, mem_group=3))
    rep = torch.arange(2, device=dev).repeat_interleave(3)
    assert torch.equal(out, decode_attention(
        q, mk[rep].contiguous(), mv[rep].contiguous(), 4,
        bias=bias[rep].contiguous()))


@pytest.mark.parametrize("m,k,n,act", [(5, 128, 128, "none"),
                                       (32, 256, 1024, "gelu_rounded"),
                                       (70, 1024, 256, "none")])
def test_quant_linear_bias_act(dev, m, k, n, act):
    g = torch.Generator(device=dev).manual_seed(6)
    x = _randn(g, m, k, dev=dev) * 3
    w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    s = (torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3) \
        .to(torch.bfloat16).float()
    b = _randn(g, n, dev=dev, dtype=torch.float32)
    w4 = pack_k4(w8)
    _close(quant_linear_bias_act(x, w4, s, b, act),
           quant_linear_bias_act.plain(x, w4, s, b, act), rel=2 * 2.0 ** -7)


def _int8_cache(g, rows, t, e, h, dev):
    c = torch.randint(-127, 128, (rows, t, e), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand(rows, t, h, generator=g, device=dev) * 3e-2 + 2e-3) \
        .to(torch.bfloat16)
    return c, s


@pytest.mark.parametrize("heads", [2, 4, 8])  # head dims 128, 64, 32
@pytest.mark.parametrize("pos", [0, 7, 63])
def test_decode_attention_int8_self_appends(dev, pos, heads):
    g = torch.Generator(device=dev).manual_seed(7)
    qkv = _randn(g, 4, 3 * 256, dev=dev)
    (kc, ks), (vc, vs) = (_int8_cache(g, 4, 64, 256, heads, dev)
                          for _ in range(2))
    twin = [a.clone() for a in (kc, vc, ks, vs)]
    out = decode_attention_int8(qkv, kc, vc, ks, vs, heads, pos=pos)
    ref = decode_attention_int8.plain(qkv, *twin, heads, pos=pos)
    _close(out, ref, rel=2 * 2.0 ** -7)
    for got, want in zip((kc, vc, ks, vs), twin):
        assert torch.equal(got, want)
    kq, s = quantize_rows(qkv[:, 256:512].view(4, heads, -1), torch.bfloat16)
    assert torch.equal(kc[:, pos], kq.view(4, 256))
    assert torch.equal(ks[:, pos].float(), s)


@pytest.mark.parametrize("group", [1, 3])
def test_decode_attention_int8_cross(dev, group):
    g = torch.Generator(device=dev).manual_seed(8)
    q = _randn(g, 2 * group, 256, dev=dev)
    (mk, mks), (mv, mvs) = (_int8_cache(g, 2, 48, 256, 4, dev)
                            for _ in range(2))
    valid = torch.arange(48, device=dev)[None] < torch.tensor(
        [48, 5], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9).float().contiguous()
    out = decode_attention_int8(q, mk, mv, mks, mvs, 4, bias=bias,
                                mem_group=group)
    _close(out, decode_attention_int8.plain(q, mk, mv, mks, mvs, 4, bias=bias,
                                            mem_group=group),
           rel=2 * 2.0 ** -7)
    rep = torch.arange(2, device=dev).repeat_interleave(group)
    assert torch.equal(out, decode_attention_int8(
        q, *(a[rep].contiguous() for a in (mk, mv, mks, mvs)), 4,
        bias=bias[rep].contiguous()))


def test_encoder_attention_and_stack(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    b, t, e, h = 2, 128, 256, 4
    valid = torch.arange(t, device=dev)[None] < torch.tensor(
        [t, 37], device=dev)[:, None]
    qkv = _randn(g, b * t, 3 * e, dev=dev)
    _close(encoder_attention(qkv, valid, h),
           encoder_attention.plain(qkv, valid, h))
    f32 = lambda *s: torch.randn(*s, generator=g, device=dev) * 0.05
    stacked = {
        "self_attn": {"in_kernel": f32(2, e, 3 * e), "in_bias": f32(2, 3 * e),
                      "out": {"kernel": f32(2, e, e), "bias": f32(2, e)}},
        "norm1": {"scale": 1 + f32(2, e), "bias": f32(2, e)},
        "linear1": {"kernel": f32(2, e, 512), "bias": f32(2, 512)},
        "linear2": {"kernel": f32(2, 512, e), "bias": f32(2, e)},
        "norm2": {"scale": 1 + f32(2, e), "bias": f32(2, e)},
    }
    x = _randn(g, b, t, e, dev=dev)
    out = encoder_stack_fused(stacked, x, valid, h)
    ref = encoder_stack_fused(stacked, x, valid, h, plain=True)
    assert torch.isfinite(out.float()).all()
    _close(out[valid], ref[valid], rel=3e-2)


def test_add_layernorm(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    x, r = _randn(g, 37, 768, dev=dev), _randn(g, 37, 768, dev=dev)
    gamma = 1 + 0.1 * _randn(g, 768, dev=dev, dtype=torch.float32)
    beta = 0.1 * _randn(g, 768, dev=dev, dtype=torch.float32)
    _close(add_layernorm(x, r, gamma, beta, 1e-5),
           add_layernorm.plain(x, r, gamma, beta, 1e-5))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 48, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(48, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="K % 32"):
        linear_bias_act(x, w, b)
    with pytest.raises(ValueError, match="bfloat16"):
        linear_bias_act(x.float(), w, b)
    w4 = torch.zeros(12, 64, 4, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="K % 128"):
        quant_linear_bias_act(x, w4, b, b)
    kc = torch.zeros(2, 16, 192, device=dev, dtype=torch.int8)
    ks = torch.ones(2, 16, 2, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):  # head dim 96
        decode_attention_int8(torch.zeros(2, 576, device=dev,
                                          dtype=torch.bfloat16),
                              kc, kc.clone(), ks, ks.clone(), 2, pos=0)
