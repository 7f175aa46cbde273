"""TEDn: normalized tree edit distance between MusicXML documents.

The port's own copy of the JAX package's ``lmx/tedn.py``: the reward of
stage-3 training scores a predicted LMX string against the target MusicXML
with ``TEDn_lmx_xml(predicted_lmx, target_musicxml, flavor="lmx", ...)``. The
O(n^2 m^2) Zhang-Shasha dynamic program runs in ``native/libtedn.so``
(``native/tedn.cpp``), bound here with ctypes and built with
``make -C native libtedn.so`` at first use; without a C++ toolchain the
pure-Python :func:`_py_ted` gives the same results, slowly. Scoring runs
in-process on a thread pool (ctypes releases the GIL).

Returns (edit_cost, catastrophic_error, minor_error_count) exactly as consumed
by ``calc_edit_costs``.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import threading
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from .delinearizer import DelinearizationError, delinearize_to_element

_LIB = None
_LIB_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load_native():
    """The native kernel, built on first use; None where it cannot be built
    or loaded (then the pure-Python program runs)."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    # the reward's thread pool calls this from many threads at once: one
    # build, one load
    with _LOAD_LOCK:
        if _LIB_TRIED:
            return _LIB
        so = Path(__file__).resolve().parents[2] / "native" / "libtedn.so"
        try:
            if not so.exists() and (so.parent / "Makefile").exists():
                subprocess.run(["make", "-C", str(so.parent), "libtedn.so"],
                               capture_output=True, check=False)
            if so.exists():
                lib = ctypes.CDLL(str(so))
                i32p = ctypes.POINTER(ctypes.c_int32)
                lib.tree_edit_distance.restype = ctypes.c_int64
                lib.tree_edit_distance.argtypes = [
                    ctypes.c_int32, i32p, i32p, ctypes.c_int32, i32p, i32p]
                _LIB = lib
        except (OSError, FileNotFoundError):
            _LIB = None
        _LIB_TRIED = True
    return _LIB


# ---------------------------------------------------------------------------
# MusicXML -> labeled postorder tree
# ---------------------------------------------------------------------------

def _node_label(el: ET.Element) -> str:
    label = el.tag
    for k in sorted(el.attrib):
        label += f"@{k}={el.attrib[k]}"
    text = (el.text or "").strip()
    if text and len(el) == 0:
        label += f"={text}"
    return label


def element_to_postorder(root: ET.Element, intern: dict):
    """Element tree -> (labels int32 array, leftmost-leaf int32 array)."""
    labels: list[int] = []
    lml: list[int] = []

    def visit(el) -> int:
        first_leaf = None
        for child in el:
            leaf = visit(child)
            if first_leaf is None:
                first_leaf = leaf
        idx = len(labels)
        if first_leaf is None:
            first_leaf = idx
        lab = _node_label(el)
        labels.append(intern.setdefault(lab, len(intern)))
        lml.append(first_leaf)
        return first_leaf

    visit(root)
    return (np.asarray(labels, dtype=np.int32), np.asarray(lml, dtype=np.int32))


def _score_tree(xml_root: ET.Element) -> ET.Element:
    """Strip to the musical content: compare <part> subtrees.

    Predictions are always a single bare <part> (the model decodes one
    system); a target's <part-list>/<part-name>/metadata must never be
    charged. With multiple <part> elements, the parts are regrafted under
    a bare <part> root so the comparison stays part-vs-parts without the
    unmatchable header nodes (comparing the whole <score-partwise> would
    charge a constant asymmetric cost; the corpus itself is single-part
    pianoform, the scope of OLiMPiC's TEDn)."""
    if xml_root.tag == "part":
        return xml_root
    parts = xml_root.findall("part")
    if len(parts) == 1:
        return parts[0]
    if parts:
        merged = ET.Element("part")
        for p in parts:
            merged.extend(list(p))
        return merged
    return xml_root


def tree_edit_distance(a: ET.Element, b: ET.Element) -> int:
    intern: dict = {}
    la, lla = element_to_postorder(a, intern)
    lb, llb = element_to_postorder(b, intern)
    lib = _load_native()
    if lib is not None:
        return int(lib.tree_edit_distance(
            len(la), la.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lla.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(lb), lb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            llb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
    return _py_ted(la, lla, lb, llb)


def _py_ted(labels1, lml1, labels2, llb) -> int:
    """Pure-Python Zhang-Shasha (fallback; identical results to the kernel)."""
    n1, n2 = len(labels1), len(labels2)
    if n1 == 0:
        return n2
    if n2 == 0:
        return n1

    def keyroots(n, lml):
        seen, kr = set(), []
        for i in range(n - 1, -1, -1):
            if lml[i] not in seen:
                kr.append(i)
                seen.add(lml[i])
        return sorted(kr)

    td = np.zeros((n1, n2), dtype=np.int64)
    for k1 in keyroots(n1, lml1):
        l1 = lml1[k1]
        for k2 in keyroots(n2, llb):
            l2 = llb[k2]
            m, n = k1 - l1 + 1, k2 - l2 + 1
            fd = np.zeros((m + 1, n + 1), dtype=np.int64)
            fd[:, 0] = np.arange(m + 1)
            fd[0, :] = np.arange(n + 1)
            for di in range(1, m + 1):
                i = l1 + di - 1
                for dj in range(1, n + 1):
                    j = l2 + dj - 1
                    if lml1[i] == l1 and llb[j] == l2:
                        ren = fd[di - 1, dj - 1] + (0 if labels1[i] == labels2[j] else 1)
                        fd[di, dj] = min(fd[di - 1, dj] + 1, fd[di, dj - 1] + 1, ren)
                        td[i, j] = fd[di, dj]
                    else:
                        sub = fd[lml1[i] - l1, llb[j] - l2] + td[i, j]
                        fd[di, dj] = min(fd[di - 1, dj] + 1, fd[di, dj - 1] + 1, sub)
    return int(td[n1 - 1, n2 - 1])


def tree_size(root: ET.Element) -> int:
    return 1 + sum(tree_size(c) for c in root)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _target_tree_cached(target_musicxml: str):
    """Parsed+postordered target tree, cached by the XML string.

    GRPO scores one image's target against group_size (typically 8)
    rollouts: the target is parsed once, not once per rollout. 256 entries
    cover several batches of unique targets at a few MB."""
    try:
        target_root = ET.fromstring(target_musicxml)
    except ET.ParseError as e:
        raise ValueError(f"target musicxml unparseable: {e}")
    return _score_tree(target_root)


def TEDn_lmx_xml(predicted_lmx: str, target_musicxml: str, flavor: str = "lmx",
                 debug: bool = False, canonicalize: bool = False):
    """(edit_cost, catastrophic_error, minor_error_count).

    ``flavor="lmx"``: predicted input is an LMX token string, delinearized
    before comparison. ``flavor="xml"``: already MusicXML.
    """
    target_tree = _target_tree_cached(target_musicxml)

    minor_errors = 0
    try:
        if flavor == "lmx":
            pred_root, errors = delinearize_to_element(predicted_lmx)
            minor_errors = len(errors)
        else:
            pred_root = ET.fromstring(predicted_lmx)
    except (DelinearizationError, ET.ParseError):
        # catastrophic: maximal cost = rebuilding the gold tree from nothing
        return float(tree_size(target_tree)), True, 0

    cost = tree_edit_distance(_score_tree(pred_root), target_tree)
    return float(cost), False, minor_errors


class TEDnResult:
    """Full result including gold_cost for normalization (olimpic-style)."""

    def __init__(self, edit_cost, gold_cost, catastrophic, minor_errors):
        self.edit_cost = edit_cost
        self.gold_cost = gold_cost
        self.catastrophic = catastrophic
        self.minor_errors = minor_errors

    @property
    def normalized(self) -> float:
        return self.edit_cost / max(self.gold_cost, 1)


def tedn_full(predicted_lmx: str, target_musicxml: str) -> TEDnResult:
    gold = tree_size(_target_tree_cached(target_musicxml))
    cost, catastrophic, minor = TEDn_lmx_xml(predicted_lmx, target_musicxml)
    return TEDnResult(cost, gold, catastrophic, minor)
