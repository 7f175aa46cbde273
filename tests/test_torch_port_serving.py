"""The port's serving layer (``acai_omr_tpu_torch.serving``) against the JAX
package's, on the CPU.

The cases of tests/test_serving.py and tests/test_flask_app.py run on the
port's WSGI application and Flask factory with a tiny model whose weights
are the JAX model's (``params_from_jax``); the multi-device (meshed) cases
are not ported, the port serves one card. Beside them: the batched route at
fp32 on both sides gives the same LMX, the same order of event types and the
same STEP tokens per system as the JAX app; the unbatched route, which
decodes in bf16, keeps the event order and the SSE contract; concurrent
batched requests keep the contract (a system's ``encoding_finish`` before
its first STEP, no STEP after its ``inference_finish``, the decode position
of the progress callback never going back); the frontend's
``inference_events.json`` equals the JAX package's and lands in the port's
own ``static/``.
"""

import io
import json
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acai_omr_tpu
from acai_omr_tpu.data import transforms as jax_transforms
from acai_omr_tpu.data.tokenizer import LmxTokenizer as JaxTokenizer
from acai_omr_tpu.inference.batch_inference import \
    batch_inference as jax_batch_inference
from acai_omr_tpu.models import vit_encoder as jax_enc
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.serving import routes as jax_routes
from acai_omr_tpu.serving import wsgi_app as jax_wsgi

from acai_omr_tpu_torch.data import transforms
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.inference import batch_inference as bi
from acai_omr_tpu_torch.models import vit_encoder, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.weights import params_from_jax
from acai_omr_tpu_torch.serving import routes, scheduler, wsgi_app

from _torch_port_threads import torch_one_thread  # noqa: F401

ENC = dict(patch_size=16, pe_max_height=6, pe_max_width=8, num_layers=2,
           hidden_dim=16, num_heads=2, mlp_dim=24, dropout=0.0)
DEC = dict(max_lmx_seq_len=32, num_layers=2, hidden_dim=16, num_heads=2,
           mlp_dim=24, dropout=0.0)
MAX_LEN = 16  # tests/test_serving.py's MAX_INFERENCE_LEN
FLUSH = 4
# fp32 decode on both sides: the port keeps its caches in the compute dtype
# (or int8), so the caches are fp32 on both sides too
JAX_FP32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
PORT_FP32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)


def _transform(module):
    return module.Compose([module.to_float_chw,
                           module.DynamicResize(16, 48, 6, 8, crop_imgs=True)])


@pytest.fixture(scope="module")
def models():
    """The tiny model of tests/test_serving.py in both packages' routes,
    the port's on the CPU with the JAX weights; both restored after."""
    jtok, ptok = JaxTokenizer(), LmxTokenizer()
    jcfg = jax_vitomr.ViTOMRConfig(
        encoder=jax_enc.EncoderConfig(**ENC),
        decoder=JaxDecoderConfig.from_tokenizer(jtok, **DEC),
        transition_head_dim=24, transition_head_dropout=0.0)
    pcfg = vitomr.ViTOMRConfig(
        encoder=vit_encoder.EncoderConfig(**ENC),
        decoder=DecoderConfig.from_tokenizer(ptok, **DEC),
        transition_head_dim=24, transition_head_dropout=0.0)
    jparams = jax_vitomr.init_vitomr_params(jax.random.PRNGKey(0), jcfg)
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    saved = [(m, dict(m._MODEL), m.MAX_INFERENCE_LEN, m.FLUSH_INTERVAL)
             for m in (jax_routes, routes)]
    jax_routes._MODEL.clear()
    jax_routes._MODEL.update(cfg=jcfg, params=jparams, tokenizer=jtok,
                             transform=_transform(jax_transforms))
    routes._MODEL.clear()
    routes._MODEL.update(cfg=pcfg, params=pparams, tokenizer=ptok,
                         transform=_transform(transforms))
    for m in (jax_routes, routes):
        m.MAX_INFERENCE_LEN = MAX_LEN
    yield
    for m, model, max_len, flush in saved:
        m.disable_dynamic_batching()
        m._MODEL.clear()
        m._MODEL.update(model)
        m.MAX_INFERENCE_LEN, m.FLUSH_INTERVAL = max_len, flush


class WsgiClient:
    """Calls a WSGI application in-process (tests/test_serving.py's)."""

    def __init__(self, app=wsgi_app.application):
        self.app = app

    def request(self, method, path, body=b"", headers=None, ctype=None):
        q = ""
        if "?" in path:
            path, q = path.split("?", 1)
        environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
                   "QUERY_STRING": q, "CONTENT_LENGTH": str(len(body)),
                   "wsgi.input": io.BytesIO(body)}
        if ctype:
            environ["CONTENT_TYPE"] = ctype
        for k, v in (headers or {}).items():
            environ["HTTP_" + k.upper().replace("-", "_")] = v
        captured = {}

        def start_response(status, resp_headers):
            captured["status"] = status
            captured["headers"] = dict(resp_headers)

        body = b"".join(self.app(environ, start_response))
        return captured["status"], captured["headers"], body

    def get_json(self, *a, **kw):
        status, _, body = self.request(*a, **kw)
        return status, json.loads(body)

    def session(self, png, bboxes):
        """/tmpdir/create -> /upload -> /inference/setup; the headers."""
        _, data = self.get_json("POST", "/tmpdir/create")
        hdr = {"X-Tmpdir": data["tmpdir"]}
        mp_body, mp_ctype = _multipart(png)
        status, data = self.get_json("POST", "/upload", body=mp_body,
                                     headers=hdr, ctype=mp_ctype)
        assert status == "200 OK" and data["ok"]
        _, data = self.get_json("POST", "/inference/setup",
                                body=json.dumps({"bboxes": bboxes}).encode(),
                                headers=hdr, ctype="application/json")
        assert data["num_systems"] == max(len(bboxes), 1)
        return hdr

    def stream(self, hdr):
        status, headers, body = self.request(
            "GET", f"/inference/stream?tmpdir={hdr['X-Tmpdir']}")
        assert status == "200 OK"
        assert headers["Content-Type"] == "text/event-stream"
        return parse_sse(body.decode())


def _png_bytes(rng, hw=(64, 96)):
    from PIL import Image
    arr = (rng.random(hw) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode="L").save(buf, format="PNG")
    return buf.getvalue()


def _multipart(file_bytes, name="image", filename="t.png"):
    boundary = "testboundary42"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="{name}"; filename="{filename}"\r\n'
            f"Content-Type: image/png\r\n\r\n").encode()
    body += file_bytes + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def parse_sse(text):
    """SSE body -> [(event, payload)]."""
    out = []
    for block in text.strip().split("\n\n"):
        lines = block.split("\n")
        out.append((lines[0].removeprefix("event: "),
                    json.loads(lines[1].removeprefix("data: "))))
    return out


def check_contract(events, n_systems):
    """The SSE contract of the port's routes; -> per system (its STEP
    tokens joined, its inference_finish payload)."""
    assert events[-1] == ("all_inference_finish", {})
    assert [p["system"] for e, p in events if e == "inference_finish"] \
        == list(range(n_systems))
    out = {}
    for s in range(n_systems):
        kinds = [e for e, p in events if p.get("system") == s]
        assert kinds[0] == "encoding_start" and kinds[-1] == "inference_finish"
        assert kinds.count("encoding_finish") == 1
        first_step = kinds.index("step") if "step" in kinds else len(kinds) - 1
        assert kinds.index("encoding_finish") < first_step
        assert "step" not in kinds[kinds.index("inference_finish"):]
        tokens = [t for e, p in events if e == "step" and p["system"] == s
                  for t in p["tokens"]]
        finish = next(p for e, p in events
                      if e == "inference_finish" and p["system"] == s)
        out[s] = (tokens, finish)
    return out


def collapsed(events):
    """Event types with runs of STEP events taken as one: how the tokens
    are grouped into STEP events is not part of the contract."""
    kinds = []
    for e, _ in events:
        if not (e == "step" and kinds and kinds[-1] == "step"):
            kinds.append(e)
    return kinds


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port's WSGI application
# ---------------------------------------------------------------------------

def test_full_serving_flow(models, rng):
    c = WsgiClient()
    status, _, body = c.request("GET", "/")
    assert status == "200 OK" and b"Acai OMR" in body
    status, _, body = c.request("GET", "/static/inference.js")
    assert status == "200 OK" and body
    hdr = c.session(_png_bytes(rng), [])
    events = c.stream(hdr)
    assert collapsed(events)[:2] == ["encoding_start", "encoding_finish"]
    check_contract(events, 1)

    _, data = c.get_json("POST", "/inference/postprocess", headers=hdr)
    assert "ok" in data
    if data["ok"]:
        assert "musicxml" in data and data["confidence"] is not None
        status, headers, _ = c.request("GET", "/download", headers=hdr)
        assert status == "200 OK" and "attachment" in \
            headers["Content-Disposition"]
    _, data = c.get_json("POST", "/clear", headers=hdr)
    assert data["ok"] and not Path(hdr["X-Tmpdir"]).exists()


def test_multi_system_sse_ordering_and_confidence(models, rng):
    """11 systems stream in numeric order (system_10 after system_2), and
    the postprocess confidence is exp(mean per-system avg log prob)."""
    c = WsgiClient()
    n = 11
    hdr = c.session(_png_bytes(rng), [[0, 0, 32 + i, 32] for i in range(n)])
    check_contract(c.stream(hdr), n)
    _, data = c.get_json("POST", "/inference/postprocess", headers=hdr)
    if data["ok"]:
        lps = [json.loads(p.read_text())["avg_log_prob"]
               for p in Path(hdr["X-Tmpdir"]).glob("system_*.meta.json")]
        assert len(lps) == n
        assert data["confidence"] == pytest.approx(float(np.exp(np.mean(lps))))
    c.get_json("POST", "/clear", headers=hdr)


def test_setup_after_box_edit_drops_stale_systems(models, rng):
    """A second setup with fewer, reordered boxes replaces the first's
    crops entirely."""
    from PIL import Image
    c = WsgiClient()
    first = [[0, 0, 32, 32], [0, 0, 40, 32], [0, 0, 48, 32]]
    hdr = c.session(_png_bytes(rng), first)
    _, data = c.get_json("POST", "/inference/setup",
                         body=json.dumps({"bboxes": [first[2], first[1]]})
                         .encode(), headers=hdr, ctype="application/json")
    assert data["num_systems"] == 2
    d = Path(hdr["X-Tmpdir"])
    assert sorted(p.name for p in d.glob("system_*.png")) \
        == ["system_0.png", "system_1.png"]
    assert Image.open(d / "system_0.png").width == 48
    assert Image.open(d / "system_1.png").width == 40
    check_contract(c.stream(hdr), 2)
    c.get_json("POST", "/clear", headers=hdr)


def test_tmpdir_validation(models):
    import tempfile
    c = WsgiClient()
    status, data = c.get_json("POST", "/upload", headers={"X-Tmpdir": "/etc"})
    assert status.startswith("400") and not data["ok"]
    td = tempfile.gettempdir()
    for evil in (f"{td}/../etc", f"{td}/..", td, f"{td}x"):
        status, data = c.get_json("POST", "/clear",
                                  headers={"X-Tmpdir": evil})
        assert status.startswith("400") and not data["ok"], evil
    assert c.request("GET", "/nonexistent")[0].startswith("404")
    assert c.request("GET", "/static/../routes.py")[0].startswith("404")


def _imgs(rng, shapes):
    return [rng.random((1, *hw), dtype=np.float32) for hw in shapes]


@pytest.mark.parametrize("beam_size", [1, 3])
def test_batch_inference_ragged_matches_jax(models, rng, beam_size):
    """Ragged images over several shape buckets, greedy and with beams, at
    fp32: the port's LMX equals the JAX package's, in input order; mean
    log-probs within 1e-4."""
    imgs = _imgs(rng, [(32, 48), (64, 96), (32, 48)])
    kw = dict(max_inference_len=12, decode_batch=2, bucket_multiple=8,
              beam_size=beam_size)
    jm, pm = jax_routes._MODEL, routes._MODEL
    ref = jax_batch_inference(jm["params"], jm["cfg"], imgs, jm["tokenizer"],
                              **JAX_FP32, **kw)
    res = bi.batch_inference(pm["params"], pm["cfg"], imgs, pm["tokenizer"],
                             **PORT_FP32, device="cpu", **kw)
    assert res.lmx == ref.lmx and len(res.lmx) == 3
    assert all(lp <= 0.0 for lp in res.avg_log_probs)
    np.testing.assert_allclose(res.avg_log_probs, ref.avg_log_probs,
                               atol=1e-4)


def test_batch_inference_quantized_kv(models, rng):
    """int8 caches route through the quantized decode and give LMX."""
    pm = routes._MODEL
    res = bi.batch_inference(pm["params"], pm["cfg"], _imgs(rng, [(32, 48)]),
                             pm["tokenizer"], max_inference_len=12,
                             bucket_multiple=8, compute_dtype=torch.float32,
                             cache_dtype=torch.int8, device="cpu")
    assert len(res.lmx) == 1 and isinstance(res.lmx[0], str)


# ---------------------------------------------------------------------------
# dynamic request batching (serving/scheduler.py)
# ---------------------------------------------------------------------------

def test_dynamic_batcher_batches_and_orders():
    calls = []

    def run_batch(items):
        calls.append(list(items))
        time.sleep(0.01)  # let the queue build up behind the running batch
        return [x * 10 for x in items]

    b = scheduler.DynamicBatcher(run_batch, max_batch=4, max_wait_ms=15.0)
    try:
        results = [None] * 12

        def client(i):
            results[i] = b(i, timeout=10.0)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == [i * 10 for i in range(12)]
        assert len(calls) < 12 and 1 < max(len(c) for c in calls) <= 4
        s = b.stats.summary()
        assert s["completed"] == 12 and s["failed"] == 0
    finally:
        b.close()


def test_dynamic_batcher_max_wait_flush():
    b = scheduler.DynamicBatcher(lambda xs: xs, max_batch=64, max_wait_ms=30.0)
    try:
        t0 = time.perf_counter()
        assert b("only", timeout=5.0) == "only"
        assert time.perf_counter() - t0 < 2.0
    finally:
        b.close()


def test_dynamic_batcher_error_propagation():
    def boom(items):
        raise ValueError("bad batch")

    b = scheduler.DynamicBatcher(boom, max_batch=2, max_wait_ms=5.0)
    try:
        with pytest.raises(ValueError, match="bad batch"):
            b(1, timeout=5.0)
        assert b.stats.failed == 1
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(2)


def test_batched_route_runs_batches_unpadded(models, rng, monkeypatch):
    """The batched route hands ``batch_inference`` the batch as it was
    formed: three requests under ``max_batch=4`` decode three rows (the
    JAX package pads to a power of two so that XLA compiles few shapes;
    nothing is compiled per shape here), and each gets its own result."""
    from PIL import Image
    sizes = []
    real = bi.batch_inference

    def spy(params, cfg, images, *a, **kw):
        sizes.append(len(images))
        return real(params, cfg, images, *a, **kw)

    monkeypatch.setattr(bi, "batch_inference", spy)
    m = routes._MODEL
    imgs = [m["transform"](Image.fromarray(
        (rng.random((64, 96)) * 255).astype(np.uint8)).convert("L"))
        for _ in range(3)]
    b = routes.enable_dynamic_batching(max_batch=4, max_wait_ms=200.0,
                                       bucket_multiple=8, **PORT_FP32)
    try:
        handles = [b.submit(x) for x in imgs]
        out = [b.result(h, timeout=120.0) for h in handles]
    finally:
        routes.disable_dynamic_batching()
    assert sizes == [3]
    ref = real(m["params"], m["cfg"], imgs, m["tokenizer"],
               max_inference_len=routes.MAX_INFERENCE_LEN, decode_batch=4,
               bucket_multiple=8, device="cpu", **PORT_FP32)
    assert [o[0] for o in out] == list(ref.lmx)


def test_dynamic_batcher_over_tiny_model(models, rng):
    """Concurrent single-image requests ride batched calls and each gets its
    own image's transcription (a direct batch_inference run's)."""
    pm = routes._MODEL
    imgs = _imgs(rng, [(32, 48)] * 6)
    kw = dict(max_inference_len=12, bucket_multiple=8, device="cpu",
              **PORT_FP32)
    ref = bi.batch_inference(pm["params"], pm["cfg"], imgs, pm["tokenizer"],
                             **kw)

    def run(items):
        res = bi.batch_inference(pm["params"], pm["cfg"], items,
                                 pm["tokenizer"], **kw)
        return list(zip(res.lmx, res.avg_log_probs))

    b = scheduler.DynamicBatcher(run, max_batch=6, max_wait_ms=50.0)
    try:
        out = [None] * len(imgs)
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, b(imgs[i], timeout=120.0)))
            for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [o[0] for o in out] == ref.lmx
        assert b.stats.batches < len(imgs)
    finally:
        b.close()


def test_omr_batcher_over_the_api(models, rng):
    """``omr_batcher`` over ``OmrModel.transcribe_batch``: concurrent
    single-image submissions get the transcriptions of one direct call."""
    from acai_omr_tpu_torch.api import OmrModel
    pm = routes._MODEL
    model = OmrModel(pm["cfg"], pm["params"], pm["tokenizer"],
                     pm["transform"], torch.device("cpu"), torch.float32)
    imgs = [(rng.random((64, 96)) * 255).astype(np.uint8) for _ in range(3)]
    ref = model.transcribe_batch(imgs, max_len=12)
    b = scheduler.omr_batcher(model, max_batch=4, max_wait_ms=50.0,
                              max_len=12)
    try:
        out = [None] * len(imgs)
        threads = [threading.Thread(
            target=lambda i=i: out.__setitem__(i, b(imgs[i], timeout=120.0)))
            for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [o.lmx for o in out] == [r.lmx for r in ref]
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the routes against the JAX package's
# ---------------------------------------------------------------------------

def _both_streams(rng, bboxes, batched, monkeypatch):
    """The same upload and boxes through the JAX app and the port's app;
    -> (JAX events, port events)."""
    png = _png_bytes(rng, (64, 160))
    for m in (jax_routes, routes):
        monkeypatch.setattr(m, "FLUSH_INTERVAL", FLUSH)
    if batched:
        jax_routes.enable_dynamic_batching(
            max_batch=4, max_wait_ms=10.0, bucket_multiple=8, **JAX_FP32)
        routes.enable_dynamic_batching(
            max_batch=4, max_wait_ms=10.0, bucket_multiple=8, **PORT_FP32)
    try:
        out = []
        for app in (jax_wsgi.application, wsgi_app.application):
            c = WsgiClient(app)
            hdr = c.session(png, bboxes)
            out.append(c.stream(hdr))
            c.get_json("POST", "/clear", headers=hdr)
        return out
    finally:
        jax_routes.disable_dynamic_batching()
        routes.disable_dynamic_batching()


BOXES = [[0, 0, 64, 64], [32, 0, 160, 64], [0, 0, 96, 48]]


def test_batched_route_matches_jax(models, rng, monkeypatch):
    """Dynamic batching on both sides at fp32: the same LMX and avg
    log-prob (1e-4) per system, the same event types in the same order
    (runs of STEP events as one), and the same STEP tokens per system, a
    prefix of its LMX (how they are grouped may differ: the port's decode
    reports its progress up to 15 steps later)."""
    jev, pev = _both_streams(rng, BOXES, True, monkeypatch)
    assert collapsed(pev) == collapsed(jev)
    jsys, psys = check_contract(jev, 3), check_contract(pev, 3)
    for s in range(3):
        (jt, jf), (pt, pf) = jsys[s], psys[s]
        assert pf["lmx"] == jf["lmx"]
        assert pf["avg_log_prob"] == pytest.approx(jf["avg_log_prob"],
                                                   abs=1e-4)
        words = pf["lmx"].split()
        assert pt == words[: len(pt)] and jt == words[: len(jt)]
        assert pt == jt


def test_unbatched_route_matches_jax(models, rng, monkeypatch):
    """The unbatched route (``streamed_inference``, bf16 decode on both
    sides): the same event types in the same order and the contract; the
    LMX of each system equal to JAX's on at least 75 % of its token
    positions (bf16 roundings in another order can flip a near tie, after
    which the two decodes go their own ways)."""
    jev, pev = _both_streams(rng, BOXES, False, monkeypatch)
    assert collapsed(pev) == collapsed(jev)
    jsys, psys = check_contract(jev, 3), check_contract(pev, 3)
    for s in range(3):
        (jt, jf), (pt, pf) = jsys[s], psys[s]
        assert pt == pf["lmx"].split()[: len(pt)]
        a, b = pf["lmx"].split(), jf["lmx"].split()
        same = sum(x == y for x, y in zip(a, b)) / max(len(a), len(b), 1)
        assert same >= 0.75, (a, b)


def test_sse_contract_under_concurrent_batched_requests(models, rng,
                                                        monkeypatch):
    """Four clients at once, two or three systems each, on one batcher: all
    complete with the contract intact, every system's STEP tokens are a
    prefix of its LMX, batches were shared, and the decode position the
    progress callback reports never goes back within a decode."""
    positions = {}  # (batch, bucket group) -> the positions reported
    real = bi.batch_inference

    def spy(*a, progress_cb=None, **kw):
        batch = len(positions)

        def cb(gi, seqs, t, fin):
            positions.setdefault((batch, tuple(gi)), []).append(t)
            progress_cb(gi, seqs, t, fin)
        return real(*a, progress_cb=cb, **kw)

    monkeypatch.setattr(bi, "batch_inference", spy)
    monkeypatch.setattr(routes, "FLUSH_INTERVAL", FLUSH)
    b = routes.enable_dynamic_batching(max_batch=8, max_wait_ms=50.0,
                                       bucket_multiple=8, **PORT_FP32)
    pngs = [_png_bytes(rng) for _ in range(4)]
    boxes = [BOXES[:2], BOXES, BOXES[1:], BOXES[:1] + BOXES[2:]]
    results, errors = [None] * 4, []

    def client(i):
        try:
            c = WsgiClient()
            hdr = c.session(pngs[i], boxes[i])
            results[i] = c.stream(hdr)
            _, data = c.get_json("POST", "/inference/postprocess",
                                 headers=hdr)
            assert "ok" in data
            c.get_json("POST", "/clear", headers=hdr)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors, errors
        for events, bx in zip(results, boxes):
            for tokens, finish in check_contract(events, len(bx)).values():
                assert tokens == finish["lmx"].split()[: len(tokens)]
        s = b.stats.summary()
        assert s["completed"] == sum(map(len, boxes)) and s["failed"] == 0
        assert s["batches"] < s["completed"]
        assert positions and all(t == sorted(t) for t in positions.values())
    finally:
        routes.disable_dynamic_batching()


def test_inference_events_json_in_the_port_only(models):
    """The frontend's event names equal the JAX package's, and exporting
    them writes the port's ``static/``, no file of the JAX package."""
    jax_root = Path(acai_omr_tpu.__file__).parent
    before = {p: p.stat().st_mtime_ns for p in jax_root.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    out = wsgi_app._STATIC_DIR / "inference_events.json"
    out.unlink(missing_ok=True)
    wsgi_app._export_inference_events()
    assert wsgi_app._STATIC_DIR.resolve().parent \
        == Path(routes.__file__).resolve().parent
    assert json.loads(out.read_text()) == json.loads(
        (jax_root / "serving" / "static" / "inference_events.json")
        .read_text())
    after = {p: p.stat().st_mtime_ns for p in jax_root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_model_device_follows_the_injected_params(models):
    assert routes._get_model()["device"] == torch.device("cpu")


# ---------------------------------------------------------------------------
# tests/test_flask_app.py on the port's Flask factory
# ---------------------------------------------------------------------------

@pytest.fixture()
def flask_client(models):
    pytest.importorskip("flask")
    from acai_omr_tpu_torch.serving.app import create_app
    app = create_app()
    app.config["TESTING"] = True
    with app.test_client() as c:
        yield c


def test_blueprint_route_surface(flask_client):
    rules = {r.rule for r in flask_client.application.url_map.iter_rules()}
    assert {"/", "/tmpdir/create", "/upload", "/inference/setup",
            "/inference/stream", "/inference/postprocess", "/download",
            "/clear"} <= rules


def test_flask_full_flow_multi_system(flask_client, rng):
    c = flask_client
    tmpdir = c.post("/tmpdir/create").get_json()["tmpdir"]
    hdr = {"X-Tmpdir": tmpdir}
    r = c.post("/upload", headers=hdr,
               data={"image": (io.BytesIO(_png_bytes(rng)), "t.png")})
    assert r.status_code == 200 and r.get_json()["ok"]
    n = 11
    r = c.post("/inference/setup", headers=hdr,
               json={"bboxes": [[0, 0, 32 + i, 32] for i in range(n)]})
    assert r.get_json()["num_systems"] == n
    r = c.get(f"/inference/stream?tmpdir={tmpdir}")
    assert r.content_type.startswith("text/event-stream")
    check_contract(parse_sse(r.get_data(as_text=True)), n)
    data = c.post("/inference/postprocess", headers=hdr).get_json()
    if data["ok"]:
        lps = [json.loads(p.read_text())["avg_log_prob"]
               for p in Path(tmpdir).glob("system_*.meta.json")]
        assert data["confidence"] == pytest.approx(float(np.exp(np.mean(lps))))
    assert c.post("/clear", headers=hdr).get_json()["ok"]


def test_flask_tmpdir_validation(flask_client):
    r = flask_client.post("/upload", headers={"X-Tmpdir": "/etc"})
    assert r.status_code == 400 and not r.get_json()["ok"]
