"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``<KERNEL_BUILD_DIR>/<name>-<hash>.so`` at first use, then loaded with
ctypes (no PyTorch headers, so a build takes seconds). The hash covers the
source, the ``csrc/*.cuh`` headers it includes and the flags, so an edited
source or header never loads a stale library.
:func:`build_all` starts one ``nvcc`` per source, all at once.

:class:`KernelOp` is the wrapper every kernel of the port goes through: it
launches the kernel for CUDA tensors, runs the plain PyTorch twin for CPU
tensors (and only then), and counts its launches. :func:`resources` reads a
source's resource table (``csrc/func_attrs.cuh``): registers, local (spill)
bytes, shared memory and resident blocks per SM of every compiled variant.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..config import KERNEL_BUILD_DIR

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _with_headers(path: Path, seen: set) -> bytes:
    """The source's bytes followed by those of every local header it
    includes, directly or through another header, each once."""
    data = path.read_bytes()
    for inc in _INCLUDE.findall(data):
        header = (path.parent / inc.decode()).resolve()
        if header not in seen and header.is_file():
            seen.add(header)
            data += _with_headers(header, seen)
    return data


def _target(name: str) -> Path:
    src = _with_headers(CSRC / f"{name}.cu", set())
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return Path(KERNEL_BUILD_DIR) / f"{name}-{digest}.so"


def _start(name: str, verbose: bool):
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel source that is not built yet, one nvcc each, all
    started together. Returns {name: compiler output}."""
    with _LOCK:
        jobs = {n: _start(n, verbose) for n in sources()}
        return {n: _finish(n, j) for n, j in jobs.items() if j is not None}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            job = _start(name, False)
            if job is not None:
                _finish(name, job)
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib


def bind(name: str, fn: str, argtypes: list):
    """C function ``fn`` of library ``name`` with its argument types set
    (c_void_p for every pointer and the stream, so none is cut to 32 bits)."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[(name, fn)] = f
    return f


RESOURCE_FIELDS = ("registers", "local_bytes", "static_smem",
                   "max_dynamic_smem", "blocks_per_sm", "threads",
                   "dynamic_smem")


def resources(name: str) -> list[dict]:
    """The resource table of ``csrc/<name>.cu``: one dict per compiled kernel
    variant it lists, with ``op``, ``variant`` (the key of
    ``KernelOp.variants`` it belongs to, "" for every launch of the op),
    ``kernel`` and :data:`RESOURCE_FIELDS` as the CUDA runtime reports them
    on the current device."""
    lib = library(name)
    count = lib.acai_resource_count
    count.argtypes, count.restype = [], ctypes.c_int
    label = lib.acai_resource_name
    label.argtypes, label.restype = [ctypes.c_int], ctypes.c_char_p
    query = bind(name, "acai_resources", [ctypes.c_int, ctypes.c_void_p])
    rows = []
    for i in range(count()):
        out = (ctypes.c_int * len(RESOURCE_FIELDS))()
        check(query(i, ctypes.addressof(out)), f"csrc/{name}.cu resources")
        op, variant, kernel = label(i).decode().split("|")
        rows.append({"op": op, "variant": variant, "kernel": kernel,
                     **dict(zip(RESOURCE_FIELDS, out))})
    return rows


def stream_ptr() -> int:
    """The handle of the current device's current CUDA stream, which every
    kernel launches on: ``torch.cuda.current_stream().cuda_stream`` without
    building a ``Stream`` object (that costs about 5 us a call on the
    card's host, a quarter of a K19 wrapper call)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() reported by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {rc}")


def require(t: torch.Tensor, what: str, dtype, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


class KernelOp:
    """One hand-written kernel: its launch function, its plain PyTorch twin,
    and the count of its launches.

    Calling the op launches the kernel when the first tensor argument lies on
    a CUDA device and runs ``plain`` when it lies on the CPU; there is no
    fallback from one to the other. ``launches`` is raised by one where the
    kernel is launched and nowhere else. ``extra_launches`` counts the device
    kernels a launch starts beyond its first (K1's split-K reduce), so
    ``device_launches`` is what the device ran. ``variants`` splits
    ``launches`` by the compiled variant or plan a launch took, where a
    kernel has several (the head dim of K3 / K7, the row splits of
    ``linear_wgrad``): :meth:`launched` is called where the kernel is
    launched, in place of the bare increment. ``check``, where given, takes
    the call's arguments and raises ValueError on shapes or options the op
    does not take: on CPU tensors before the twin runs (the launcher runs
    the same checks for CUDA tensors), so nothing is built for a call the
    kernel would refuse.
    """

    def __init__(self, name: str, source: str, replaces: str, launch, plain,
                 check=None):
        self.name = name
        self.route = "cuda"
        self.source = source
        self.replaces = replaces
        self._launch = launch
        self.plain = plain
        self.check = check
        self.launches = 0
        self.extra_launches = 0
        self.variants: dict[str, int] = {}
        REGISTRY[name] = self

    def launched(self, variant: str) -> None:
        self.launches += 1
        self.variants[variant] = self.variants.get(variant, 0) + 1

    @property
    def device_launches(self) -> int:
        return self.launches + self.extra_launches

    def resources(self, variant: str | None = None) -> list[dict]:
        """The resource rows (:func:`resources`) of this op's device kernels;
        with ``variant``, only those its launches of that variant run. Needs
        the card: the query builds and loads the source."""
        lib = self.source.rsplit("/", 1)[-1].removesuffix(".cu")
        return [r for r in resources(lib) if r["op"] == self.name
                and (variant is None or r["variant"] in ("", variant))]

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        if x.device.type == "cpu":
            if self.check is not None:
                self.check(x, *args, **kwargs)
            # a launcher's private ``variant=`` picks a compiled kernel; the
            # twin is one function for all of them
            kwargs.pop("variant", None)
            return self.plain(x, *args, **kwargs)
        if x.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        return self._launch(self, x, *args, **kwargs)


REGISTRY: dict[str, KernelOp] = {}


def reset_launch_counts() -> None:
    for op in REGISTRY.values():
        op.launches = 0
        op.extra_launches = 0
        op.variants = {}
