"""Flask app factory for the OMR web service.

The twin of the JAX package's ``serving/app.py``: the blueprint of
:mod:`.routes` (tmpdir lifecycle, upload, bbox system cropping, SSE
streaming inference, postprocess to MusicXML + rendered image + confidence,
download, clear) over the port's inference on the card, with the
InferenceEvent enum exported to JSON for the frontend.

Switches, read when the app is created (:func:`batching_from_env`):
``ACAI_DYNAMIC_BATCHING=1`` turns on cross-request batching with
``ACAI_BATCH_MAX`` (32) and ``ACAI_BATCH_WAIT_MS`` (25); ``ACAI_BATCH_INT8=1``
decodes those batches with int8 caches (``torch.int8``); the STEP cadence is
``ACAI_FLUSH_INTERVAL`` (25 decode steps, :mod:`.routes`).
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import torch


def batching_from_env():
    """Turn on dynamic batching when ``ACAI_DYNAMIC_BATCHING=1``, with the
    batch size, wait and cache dtype of the other switches; returns the
    batcher or None."""
    if os.environ.get("ACAI_DYNAMIC_BATCHING") != "1":
        return None
    from .routes import enable_dynamic_batching
    return enable_dynamic_batching(
        max_batch=int(os.environ.get("ACAI_BATCH_MAX", "32")),
        max_wait_ms=float(os.environ.get("ACAI_BATCH_WAIT_MS", "25")),
        cache_dtype=(torch.int8 if os.environ.get("ACAI_BATCH_INT8") == "1"
                     else torch.bfloat16))


def create_app():
    from flask import Flask

    from .wsgi_app import _STATIC_DIR, _export_inference_events

    _export_inference_events()
    logger = logging.getLogger()
    logger.setLevel(logging.DEBUG)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(
        "%(module)s - %(levelname)s: %(message)s"))
    logger.addHandler(handler)

    app = Flask(__name__,
                template_folder=str(Path(__file__).parent / "templates"),
                static_folder=str(_STATIC_DIR))

    from .routes import main
    app.register_blueprint(main)
    batching_from_env()

    @app.errorhandler(ValueError)
    def bad_request(e):  # the tmpdir validation of wsgi_app.application
        from flask import jsonify
        return jsonify({"ok": False, "error": str(e)}), 400

    return app
