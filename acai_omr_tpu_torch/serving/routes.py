"""HTTP routes: upload -> annotate systems -> stream inference -> postprocess.

The twin of the JAX package's ``serving/routes.py`` over the port's
inference: per-session temp dirs, bbox-cropped system images with EXIF
transposition, SSE token streaming, LMX concatenation + delinearization +
optional musescore rendering, exp(avg log prob) confidence.

The model loads lazily on first use (:func:`_get_model`), from
``ACAI_WEIGHTS`` (a ``.npz`` of the JAX parameter tree, or a checkpoint
directory the JAX package wrote, which needs the optional ``tensorstore``) or
seeded weights, on ``cuda``. ``_MODEL["device"]`` is the device of its parameters, and every
call into the decode passes it, so a model injected on another device (a
small CPU model in the tests) runs there.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import queue as queue_lib
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import InferenceEvent

logger = logging.getLogger(__name__)

try:
    from flask import (Blueprint, Response, jsonify, render_template, request,
                       send_file)
    main = Blueprint("main", __name__)
    _FLASK = True
except Exception:  # flask optional at import time
    main = None
    _FLASK = False

MAX_INFERENCE_LEN = 1536
# SSE STEP flush cadence in decode steps (the reference's flush interval).
# Under dynamic batching each flush is one device -> host copy of the
# sequences at a segment boundary (ACAI_FLUSH_INTERVAL).
FLUSH_INTERVAL = int(os.environ.get("ACAI_FLUSH_INTERVAL", "25"))

_MODEL = {}
_BATCHER = {"b": None}


def _event(kind: InferenceEvent, data: dict) -> str:
    return f"event: {kind.value}\ndata: {json.dumps(data)}\n\n"


def enable_dynamic_batching(max_batch: int = 32, max_wait_ms: float = 25.0,
                            **inference_kwargs):
    """Opt into cross-request dynamic batching for ``/inference/stream``.

    With batching on, each request's system crops are submitted to a
    process-global :class:`.scheduler.DynamicBatcher` over
    :func:`..inference.batch_inference.batch_inference`, so concurrent
    clients share decode batches on the card. Mid-decode STEP token events
    stream per decode segment (``FLUSH_INTERVAL`` steps): batch_inference's
    ``progress_cb`` surfaces each segment's new tokens and the batcher routes
    them to the submitting request's progress queue. ``inference_kwargs``
    go to ``batch_inference`` (``cache_dtype=torch.int8`` for the quantized
    decode, whose weights follow ``ACAI_W8A8_DECODE`` / ``ACAI_W4A8_DECODE``).
    Also honoured through ``ACAI_DYNAMIC_BATCHING=1`` at app creation.
    """
    from ..inference.batch_inference import batch_inference
    from .scheduler import DynamicBatcher

    disable_dynamic_batching()
    m = _get_model()
    tok = m["tokenizer"]
    specials = {tok.pad_idx, tok.bos_idx, tok.eos_idx}

    def run(items, emit=None):
        emitted = [0] * len(items)

        def cb(img_indices, seqs, t, finished):
            if emit is None:
                return
            for row, it in enumerate(img_indices):
                ids = []
                for x in seqs[row, 1:t]:
                    if int(x) == tok.eos_idx:  # what follows is not kept
                        break
                    if int(x) not in specials:
                        ids.append(int(x))
                if len(ids) > emitted[it]:
                    emit(it, {"tokens": ids[emitted[it]:]})
                    emitted[it] = len(ids)

        res = batch_inference(m["params"], m["cfg"], items, tok,
                              max_inference_len=MAX_INFERENCE_LEN,
                              decode_batch=max_batch, progress_cb=cb,
                              progress_interval=FLUSH_INTERVAL,
                              device=m["device"], **inference_kwargs)
        return list(zip(res.lmx, res.avg_log_probs))

    # batches run at the size they were formed: nothing is compiled per
    # shape here, so a pad row would only be decoded and thrown away
    # (ragged encoder shapes are bucketed inside batch_inference)
    _BATCHER["b"] = DynamicBatcher(run, max_batch=max_batch,
                                   max_wait_ms=max_wait_ms)
    return _BATCHER["b"]


def disable_dynamic_batching() -> None:
    if _BATCHER["b"] is not None:
        _BATCHER["b"].close()
        _BATCHER["b"] = None


def _get_model():
    if not _MODEL:
        from ..inference.vitomr_inference import set_up_omr_inference
        weights = os.environ.get("ACAI_WEIGHTS") or None
        cfg, params, tokenizer, transform = set_up_omr_inference(weights)
        _MODEL.update(cfg=cfg, params=params, tokenizer=tokenizer,
                      transform=transform)
    if "device" not in _MODEL:
        leaf = _MODEL["params"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        _MODEL["device"] = leaf.device
    return _MODEL


def _tmpdir(request) -> Path:
    from .wsgi_app import _validate_tmpdir
    d = request.headers.get("X-Tmpdir") or request.args.get("tmpdir")
    return _validate_tmpdir(d)


def crop_systems(d: Path, bboxes) -> int:
    """Crop ``d/upload.png`` into ``system_<i>.png``, one per bbox (the whole
    image when there is none), after dropping the last setup's files."""
    from PIL import Image
    img = Image.open(d / "upload.png").convert("L")
    if not bboxes:
        bboxes = [[0, 0, img.width, img.height]]
    clear_system_files(d)
    for i, (x0, y0, x1, y1) in enumerate(bboxes):
        img.crop((int(x0), int(y0), int(x1), int(y1))).save(
            d / f"system_{i}.png")
    return len(bboxes)


def save_upload(stream, d: Path) -> Path:
    """The uploaded image, EXIF-transposed (phone photos), as grayscale
    ``d/upload.png``."""
    from PIL import Image, ImageOps
    img = ImageOps.exif_transpose(Image.open(stream))
    img.convert("L").save(d / "upload.png")
    return d / "upload.png"


if _FLASK:

    @main.route("/")
    def index():
        return render_template("index.html")

    @main.route("/tmpdir/create", methods=["POST"])
    def tmpdir_create():
        return jsonify({"tmpdir": tempfile.mkdtemp(prefix="acai_omr_")})

    @main.route("/upload", methods=["POST"])
    def upload():
        d = _tmpdir(request)
        path = save_upload(request.files["image"].stream, d)
        return jsonify({"ok": True, "path": str(path)})

    @main.route("/inference/setup", methods=["POST"])
    def inference_setup():
        """Crop annotated systems: body {bboxes: [[x0,y0,x1,y1], ...]}."""
        d = _tmpdir(request)
        n = crop_systems(d, request.get_json(force=True).get("bboxes", []))
        return jsonify({"ok": True, "num_systems": n})

    @main.route("/inference/stream")
    def inference_stream():
        d = _tmpdir(request)
        return Response(_sse_stream(d), mimetype="text/event-stream",
                        headers={"Cache-Control": "no-cache",
                                 "X-Accel-Buffering": "no"})

    @main.route("/inference/postprocess", methods=["POST"])
    def inference_postprocess():
        d = _tmpdir(request)
        return jsonify(postprocess_systems(d))

    @main.route("/download")
    def download():
        d = _tmpdir(request)
        return send_file(d / "result.musicxml", as_attachment=True,
                         download_name="result.musicxml")

    @main.route("/clear", methods=["POST"])
    def clear():
        d = _tmpdir(request)
        for p in d.iterdir():
            p.unlink()
        d.rmdir()
        return jsonify({"ok": True})


def clear_system_files(d: Path) -> None:
    """Drop stale per-system artifacts before a (re-)setup: a re-run with
    FEWER boxes must not stream or score the previous run's leftovers."""
    for pat in ("system_*.png", "system_*.lmx", "system_*.meta.json"):
        for p in d.glob(pat):
            p.unlink()


def _system_paths(d: Path):
    return sorted(d.glob("system_*.png"),
                  key=lambda p: int(p.stem.split("_")[1]))  # numeric order


def _write_result(d: Path, sys_idx: int, lmx: str, avg_lp: float) -> str:
    (d / f"system_{sys_idx}.lmx").write_text(lmx)
    (d / f"system_{sys_idx}.meta.json").write_text(
        json.dumps({"avg_log_prob": avg_lp}))
    return _event(InferenceEvent.INFERENCE_FINISH,
                  {"system": sys_idx, "lmx": lmx, "avg_log_prob": avg_lp})


def _sse_stream(d: Path):
    """SSE generator over every annotated system, in numeric order.

    The contract, batched or not: a system's ENCODING_FINISH comes before its
    first STEP, no STEP follows its INFERENCE_FINISH, and INFERENCE_FINISH
    events come in system order. With dynamic batching on, all of this
    request's systems are submitted to the shared batcher up front and
    concurrent requests' systems ride the same decode batches."""
    from PIL import Image
    m = _get_model()
    if _BATCHER["b"] is not None:
        yield from _sse_batched(d, m, _BATCHER["b"])
        return
    from ..inference.vitomr_inference import streamed_inference
    tok = m["tokenizer"]
    for sys_idx, path in enumerate(_system_paths(d)):
        img = m["transform"](Image.open(path).convert("L"))
        for event in streamed_inference(m["params"], m["cfg"], img,
                                        MAX_INFERENCE_LEN, FLUSH_INTERVAL,
                                        device=m["device"]):
            payload = event["payload"]
            kind = InferenceEvent(event["type"])
            if kind is InferenceEvent.STEP:
                tokens = [tok.idxs_to_tokens[int(t)]
                          for t in payload["tokens"].reshape(-1)]
                yield _event(kind, {"system": sys_idx, "tokens": tokens})
            elif kind is InferenceEvent.INFERENCE_FINISH:
                seq = payload["sequence"][0][payload["mask"][0]]
                lps = payload["log_probs"][0][payload["mask"][0]]
                yield _write_result(d, sys_idx, tok.decode(seq),
                                    float(lps.sum() / max(len(lps), 1)))
            else:
                yield _event(kind, {"system": sys_idx})
    yield _event(InferenceEvent.ALL_INFERENCE_FINISH, {})


def _sse_batched(d: Path, m: dict, b):
    from PIL import Image
    tok = m["tokenizer"]
    # one progress queue for this request's systems: the batcher routes each
    # submit's mid-decode token events here
    progress_q = queue_lib.Queue()
    handles = [b.submit(m["transform"](Image.open(p).convert("L")),
                        progress_queue=progress_q)
               for p in _system_paths(d)]
    idx_of = {id(h): i for i, h in enumerate(handles)}
    for sys_idx in range(len(handles)):
        yield _event(InferenceEvent.ENCODING_START, {"system": sys_idx})
    encoding_done = set()

    def encoding_finish(sys_idx):
        # a decode token (or the result) proves the encoding finished
        if sys_idx not in encoding_done:
            encoding_done.add(sys_idx)
            yield _event(InferenceEvent.ENCODING_FINISH, {"system": sys_idx})

    def step_events(req, payload):
        sys_idx = idx_of.get(id(req))
        if sys_idx is None or not payload.get("tokens"):
            return
        yield from encoding_finish(sys_idx)
        tokens = [tok.idxs_to_tokens[int(t)] for t in payload["tokens"]]
        yield _event(InferenceEvent.STEP,
                     {"system": sys_idx, "tokens": tokens})

    def drain_steps():
        while True:
            try:
                req, payload = progress_q.get_nowait()
            except queue_lib.Empty:
                return
            yield from step_events(req, payload)

    # progress-based deadline, refreshed whenever a system completes, so each
    # system gets 600 s
    deadline = time.monotonic() + 600.0
    next_finish = 0  # INFERENCE_FINISH events stay in system order
    while next_finish < len(handles):
        if time.monotonic() > deadline:
            raise TimeoutError("batched inference did not complete")
        try:
            req, payload = progress_q.get(timeout=0.25)
            yield from step_events(req, payload)
            continue
        except queue_lib.Empty:
            pass
        while next_finish < len(handles) \
                and handles[next_finish].event.is_set():
            # the batcher queues every STEP emit BEFORE setting result
            # events, so a full drain here leaves no STEP of this system to
            # trail its INFERENCE_FINISH
            yield from drain_steps()
            sys_idx = next_finish
            lmx, avg_lp = b.result(handles[sys_idx], timeout=600.0)
            yield from encoding_finish(sys_idx)
            yield _write_result(d, sys_idx, lmx, float(avg_lp))
            next_finish += 1
            deadline = time.monotonic() + 600.0
    yield from drain_steps()  # safety net; normally empty here
    yield _event(InferenceEvent.ALL_INFERENCE_FINISH, {})


def postprocess_systems(d: Path) -> dict:
    """Join per-system LMX -> delinearize -> optional render -> confidence."""
    from ..inference.vitomr_inference import convert_back_to_img, delinearize
    lmx_parts = [p.read_text() for p in
                 sorted(d.glob("system_*.lmx"),
                        key=lambda p: int(p.stem.split("_")[1]))]
    full_lmx = " ".join(lmx_parts)
    resp = delinearize(full_lmx, str(d / "result.lmx"),
                       str(d / "result.musicxml"))
    if not resp["ok"]:
        return {"ok": False,
                "error": resp.get("error", "delinearization failed")}
    imgs_b64 = []
    rendered = convert_back_to_img(str(d / "result.musicxml"),
                                   str(d / "render.png"))
    if rendered:
        imgs_b64.append(base64.b64encode(Path(rendered).read_bytes()).decode())
    # confidence = exp(mean of per-system avg log probs)
    avg_lps = [json.loads(p.read_text())["avg_log_prob"]
               for p in d.glob("system_*.meta.json")]
    confidence = float(np.exp(np.mean(avg_lps))) if avg_lps else None
    return {"ok": True, "musicxml": (d / "result.musicxml").read_text(),
            "rendered_images": imgs_b64, "confidence": confidence,
            "delinearize_problems": resp.get("delinearize_problems", [])}
