"""Dependency-free WSGI application for the OMR service.

The twin of the JAX package's ``serving/wsgi_app.py``: the route surface of
the Flask blueprint (:mod:`.routes`) on the WSGI protocol directly, so the
service runs without Flask and deploys under any WSGI server. SSE streaming
is a plain generator response.

    python3 -m acai_omr_tpu_torch.serving.wsgi_app [--host H] [--port P]

serves it with the threaded stdlib server on the card (weights from
``ACAI_WEIGHTS`` or a seed); ``ACAI_DYNAMIC_BATCHING=1`` and the other
switches of :mod:`.app` apply.
"""

from __future__ import annotations

import io
import json
import tempfile
from pathlib import Path
from urllib.parse import parse_qs

from .. import InferenceEvent
from . import routes as impl

_HTML_DIR = Path(__file__).parent / "templates"
_STATIC_DIR = Path(__file__).parent / "static"


def _export_inference_events():
    """Write the InferenceEvent enum for the frontend into this package's
    ``static/`` (also when a WSGI server imports ``application`` directly
    without going through :func:`serve`)."""
    try:
        _STATIC_DIR.mkdir(exist_ok=True)
        (_STATIC_DIR / "inference_events.json").write_text(
            json.dumps({e.name: e.value for e in InferenceEvent}, indent=2))
    except OSError:
        pass


_export_inference_events()


def _response(start, status: str, body: bytes, ctype="application/json",
              extra=()):
    headers = [("Content-Type", ctype), ("Content-Length", str(len(body)))]
    headers += list(extra)
    start(status, headers)
    return [body]


def _json(start, obj, status="200 OK"):
    return _response(start, status, json.dumps(obj).encode())


def _validate_tmpdir(d: str) -> Path:
    """Resolve-and-contain check: the client-supplied working dir must be a
    real directory strictly inside the system temp dir (no ``..``
    traversal, no prefix collision such as ``/tmpfoo``)."""
    if not d:
        raise ValueError("invalid or missing tmpdir")
    p = Path(d).resolve()
    root = Path(tempfile.gettempdir()).resolve()
    if not p.is_dir() or p == root or root not in p.parents:
        raise ValueError("invalid or missing tmpdir")
    return p


def _tmpdir_from(environ) -> Path:
    d = environ.get("HTTP_X_TMPDIR")
    if not d:
        qs = parse_qs(environ.get("QUERY_STRING", ""))
        d = (qs.get("tmpdir") or [None])[0]
    return _validate_tmpdir(d)


def _read_body(environ) -> bytes:
    length = int(environ.get("CONTENT_LENGTH") or 0)
    return environ["wsgi.input"].read(length)


def _parse_multipart_image(environ) -> bytes:
    """Extract the first file part from a multipart/form-data body."""
    ctype = environ.get("CONTENT_TYPE", "")
    boundary = None
    for part in ctype.split(";"):
        part = part.strip()
        if part.startswith("boundary="):
            boundary = part[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("not multipart")
    body = _read_body(environ)
    delim = b"--" + boundary.encode()
    for chunk in body.split(delim):
        if b"\r\n\r\n" not in chunk:
            continue
        headers, _, payload = chunk.partition(b"\r\n\r\n")
        if b"filename=" in headers:
            # the part body ends with exactly one CRLF before the next
            # delimiter; strip only that
            if payload.endswith(b"\r\n"):
                payload = payload[:-2]
            return payload
    raise ValueError("no file part found")


def application(environ, start_response):
    method = environ["REQUEST_METHOD"]
    path = environ.get("PATH_INFO", "/")

    try:
        if path == "/" and method == "GET":
            body = (_HTML_DIR / "index.html").read_text()
            # resolve url_for-style template refs for the stdlib server
            for name in ("main.css", "inference.js"):
                body = body.replace(
                    "{{ url_for('static', filename='%s') }}" % name,
                    f"/static/{name}")
            return _response(start_response, "200 OK", body.encode(),
                             "text/html; charset=utf-8")

        if path.startswith("/static/") and method == "GET":
            f = _STATIC_DIR / path[len("/static/"):]
            # containment compares resolved against resolved (the package
            # may sit behind a symlink)
            if not f.is_file() \
                    or _STATIC_DIR.resolve() not in f.resolve().parents:
                return _response(start_response, "404 Not Found",
                                 b"not found", "text/plain")
            ctype = {"css": "text/css", "js": "application/javascript",
                     "json": "application/json"}.get(
                         f.suffix[1:], "application/octet-stream")
            return _response(start_response, "200 OK", f.read_bytes(), ctype)

        if path == "/tmpdir/create" and method == "POST":
            return _json(start_response,
                         {"tmpdir": tempfile.mkdtemp(prefix="acai_omr_")})

        if path == "/upload" and method == "POST":
            d = _tmpdir_from(environ)
            saved = impl.save_upload(
                io.BytesIO(_parse_multipart_image(environ)), d)
            return _json(start_response, {"ok": True, "path": str(saved)})

        if path == "/inference/setup" and method == "POST":
            d = _tmpdir_from(environ)
            payload = json.loads(_read_body(environ) or b"{}")
            n = impl.crop_systems(d, payload.get("bboxes", []))
            return _json(start_response, {"ok": True, "num_systems": n})

        if path == "/inference/stream" and method == "GET":
            d = _tmpdir_from(environ)
            start_response("200 OK", [
                ("Content-Type", "text/event-stream"),
                ("Cache-Control", "no-cache"),
                ("X-Accel-Buffering", "no"),
            ])
            return (chunk.encode() for chunk in impl._sse_stream(d))

        if path == "/inference/postprocess" and method == "POST":
            d = _tmpdir_from(environ)
            return _json(start_response, impl.postprocess_systems(d))

        if path == "/download" and method == "GET":
            d = _tmpdir_from(environ)
            body = (d / "result.musicxml").read_bytes()
            return _response(
                start_response, "200 OK", body, "application/xml",
                [("Content-Disposition",
                  "attachment; filename=result.musicxml")])

        if path == "/clear" and method == "POST":
            d = _tmpdir_from(environ)
            for p in d.iterdir():
                p.unlink()
            d.rmdir()
            return _json(start_response, {"ok": True})

        return _response(start_response, "404 Not Found", b"not found",
                         "text/plain")

    except ValueError as e:
        return _json(start_response, {"ok": False, "error": str(e)},
                     "400 Bad Request")
    except FileNotFoundError as e:
        return _json(start_response, {"ok": False, "error": str(e)},
                     "404 Not Found")


def serve(host: str = "127.0.0.1", port: int = 8000):
    """Threaded stdlib server (development use; production runs a WSGI
    server on ``acai_omr_tpu_torch.wsgi:app``). Honours the switches of
    :func:`.app.batching_from_env`."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    from .app import batching_from_env

    class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    _export_inference_events()
    batching_from_env()
    httpd = make_server(host, port, application,
                        server_class=ThreadingWSGIServer)
    print(f"Serving Acai OMR on http://{host}:{port}")
    httpd.serve_forever()


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args()
    serve(args.host, args.port)
