"""K19 ``smem_probe``'s host logic with the CUDA launch stubbed: the
shared-memory attribute set only for a size past the largest set on the
device (once per larger size, never after a refusal, the refusal raised as
``SmemRefused`` with its CUDA error), the launch form each variant binds and
the arguments it hands the kernel, the launch labels, and the argument
checks on either device. Nothing here builds or binds a kernel: a fixture
records what the launcher binds in its place.
"""

import pytest
import torch

from acai_omr_tpu_torch.ops import _build
from acai_omr_tpu_torch.ops import probe_kernels as pk

from _torch_port_threads import torch_one_thread  # noqa: F401

K19 = pk.smem_probe
KB = 1024
REFUSED = 1  # cudaErrorInvalidValue, what the card answers past its limit


@pytest.fixture(autouse=True)
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was built or bound")
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)
    monkeypatch.setattr(pk, "_SMEM_SET", {})


@pytest.fixture
def card(monkeypatch):
    """A stand-in card with a 227 KB limit: records every bound call; the
    attribute call refuses a size past the limit, the launch a size past the
    attribute set, as the runtime does."""
    state = {"calls": [], "attr": {0: 48 * KB, 1: 48 * KB}}

    def set_max(n_bytes, simple):
        state["calls"].append(("set_max", n_bytes, simple))
        if n_bytes > 227 * KB:
            return REFUSED
        state["attr"][simple] = n_bytes
        return 0

    def launch(x, out, n_bytes, stream):
        state["calls"].append(("launch", n_bytes))
        return 0 if n_bytes <= state["attr"][0] else REFUSED

    def launch_simple(x, out, n_bytes, stream):
        state["calls"].append(("simple", n_bytes))
        rc = set_max(n_bytes, 1)
        return rc if rc else 0

    fns = {"acai_smem_set_max": set_max, "acai_smem_probe": launch,
           "acai_smem_probe_simple": launch_simple}

    def bind(name, fn, argtypes):
        assert name == "smem_probe"

        def call(*args):
            assert len(args) == len(argtypes), fn
            return fns[fn](*args)
        return call

    class Lib:
        @staticmethod
        def acai_cuda_error_string(code):
            return b"invalid argument"

    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(pk, "_smem_lib", lambda: Lib)
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(K19, "variants", {})
    monkeypatch.setattr(K19, "launches", 0)
    return state


def _launch(x, n_bytes, **kw):
    return pk._launch_smem(K19, x, n_bytes, **kw)


def _x():
    return torch.randn(8, 128).to(torch.bfloat16)


def test_attribute_set_once_per_larger_size(card):
    x = _x()
    for n in (2 * KB, 64 * KB, 16 * KB, 64 * KB, 227 * KB, 100 * KB,
              227 * KB):
        _launch(x, n)
    sets = [c for c in card["calls"] if c[0] == "set_max"]
    assert sets == [("set_max", 2 * KB, 0), ("set_max", 64 * KB, 0),
                    ("set_max", 227 * KB, 0)]
    assert [c for c in card["calls"] if c[0] == "launch"] == [
        ("launch", n) for n in (2 * KB, 64 * KB, 16 * KB, 64 * KB,
                                   227 * KB, 100 * KB, 227 * KB)]
    assert pk._SMEM_SET == {-1: 227 * KB}


def test_a_refused_size_raises_and_leaves_the_cache(card):
    x = _x()
    _launch(x, 200 * KB)
    for _ in range(2):  # asked again, the attribute is asked again
        with pytest.raises(pk.SmemRefused, match="invalid argument") as e:
            _launch(x, 228 * KB)
        assert e.value.code == REFUSED and e.value.n_bytes == 228 * KB
    assert pk._SMEM_SET == {-1: 200 * KB}
    assert [c[0] for c in card["calls"]] == ["set_max", "launch", "set_max",
                                             "set_max"]
    # nothing launched for the refused size; the next launch runs
    _launch(x, 100 * KB)
    assert card["calls"][-1] == ("launch", 100 * KB)
    assert K19.variants == {"200 KB": 1, "100 KB": 1}


def test_each_device_has_its_own_cache(card):
    pk.smem_set_max(0, 100 * KB)
    pk.smem_set_max(1, 100 * KB)
    pk.smem_set_max(0, 50 * KB)
    assert pk._SMEM_SET == {0: 100 * KB, 1: 100 * KB}
    assert card["calls"] == [("set_max", 100 * KB, 0)] * 2


def test_a_failed_launch_is_refused(card):
    """A launch the runtime refuses (here: past the attribute, as if the
    cache were stale) raises, and is not counted."""
    x = _x()
    pk._SMEM_SET[-1] = 227 * KB  # the attribute is still 48 KB
    with pytest.raises(pk.SmemRefused):
        _launch(x, 100 * KB)
    assert K19.variants == {}


def test_launch_forms_and_labels(card):
    x = _x()
    _launch(x, 227 * KB)
    _launch(x, 227 * KB)
    _launch(x, 227 * KB, variant="simple")
    _launch(x, 227 * KB, variant="simple")
    assert card["calls"] == [
        ("set_max", 227 * KB, 0), ("launch", 227 * KB),
        ("launch", 227 * KB),
        ("simple", 227 * KB), ("set_max", 227 * KB, 1),
        ("simple", 227 * KB), ("set_max", 227 * KB, 1)]
    assert K19.variants == {"227 KB": 2, "227 KB simple": 2}
    assert K19.launches == 4
    with pytest.raises(pk.SmemRefused):
        _launch(x, 228 * KB, variant="simple")


def test_the_warp_kernel_needs_8_byte_aligned_rows(card):
    x = torch.randn(8 * 128 + 1).to(torch.bfloat16)[1:].view(8, 128)
    assert x.data_ptr() % 8
    with pytest.raises(ValueError, match="aligned"):
        _launch(x, 4 * KB)
    _launch(x, 4 * KB, variant="simple")  # the 2-byte kernel takes it
    assert card["calls"][0][0] == "simple"


@pytest.mark.parametrize("kw", [{}, {"n_bytes": 227 * KB},
                                {"variant": "simple"}])
def test_twin_row_zero_on_cpu(kw):
    x = _x()
    out = K19(x, **{"n_bytes": 2 * KB, **kw})
    assert torch.equal(out[0], x[0] * 2) and not out[1:].any()


@pytest.mark.parametrize("args,kw,match", [
    ((_x(), 2 * KB), {"variant": "bytewise"}, "unknown variant"),
    ((_x(), 1 * KB), {}, "rows"),
    ((_x(), 2 * KB + 100), {}, "rows"),
    ((_x()[:4], 4 * KB), {}, "8, 128"),
    ((_x().float(), 4 * KB), {}, "8, 128"),
])
def test_checks_on_either_device(card, args, kw, match):
    with pytest.raises(ValueError, match=match):
        K19(*args, **kw)
    with pytest.raises(ValueError, match=match):
        _launch(*args, **kw)
    assert card["calls"] == []
