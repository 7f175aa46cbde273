"""The port's meshed serving (``batch_inference(mesh=, model_axis=)`` and
``serving.routes.enable_dynamic_batching(mesh=...)``) against the JAX
package, on the CPU.

The cases of tests/test_serving.py that run a mesh (``batch_inference``
greedy and with beams over a 2 x 2 mesh, and the batched, meshed, streamed
serving flow), on the port with a mesh of CPU shards
(``make_mesh(2, 2, ["cpu"] * 4)``: K15's twin sums the model ranks) and the
tiny model of tests/test_torch_port_serving.py, whose weights are the JAX
model's. JAX's tests hold its meshed serving equal to its unmeshed serving
(tests/test_serving.py:267-305, 574-600), so the port's meshed results are
held against the JAX package's unmeshed ones, which are quick: the same LMX
per image and mean log-probs within 1e-4 (the split sums change the fp32
order). Caches fp32 (the tensor-parallel monolith step) and bf16 under fp32
compute (JAX's default, fault F3's case: the per-op tensor-parallel step).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acai_omr_tpu.inference.batch_inference import \
    batch_inference as jax_batch_inference
from acai_omr_tpu.serving import routes as jax_routes
from acai_omr_tpu.serving import wsgi_app as jax_wsgi

from acai_omr_tpu_torch.inference import batch_inference as bi
from acai_omr_tpu_torch.parallel import mesh as mesh_lib
from acai_omr_tpu_torch.serving import routes, wsgi_app

from test_torch_port_serving import (BOXES, FLUSH, WsgiClient, _imgs,  # noqa
                                     _png_bytes, check_contract, collapsed,
                                     models)

from _torch_port_threads import torch_one_thread  # noqa: F401

KW = dict(max_inference_len=12, decode_batch=2, bucket_multiple=8)
CACHES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(32, 48), (64, 96), (32, 48)]


def _mesh():
    return mesh_lib.make_mesh(2, 2, ["cpu"] * 4)


@pytest.mark.parametrize("caches", ["fp32", "bf16"])
def test_batch_inference_meshed_matches_jax(models, rng, caches):
    """Greedy over a 2 x 2 mesh: groups of 2 and 1 (the 1 padded to the data
    axis), the decoder's shards prepared once for both; the LMX of JAX's
    unmeshed decode in input order, mean log-probs within 1e-4. The
    streaming hook surfaces original indices only, no pad row, and every
    image."""
    imgs = _imgs(rng, SHAPES)
    jdt, pdt = CACHES[caches]
    jm, pm = jax_routes._MODEL, routes._MODEL
    ref = jax_batch_inference(jm["params"], jm["cfg"], imgs, jm["tokenizer"],
                              compute_dtype=jnp.float32, cache_dtype=jdt,
                              **KW)
    events = []
    res = bi.batch_inference(
        pm["params"], pm["cfg"], imgs, pm["tokenizer"],
        compute_dtype=torch.float32, cache_dtype=pdt, mesh=_mesh(),
        model_axis=mesh_lib.MODEL_AXIS, progress_interval=4,
        progress_cb=lambda gi, s, t, fin: events.append(
            (list(gi), s.copy(), t, fin.copy())), **KW)
    assert res.lmx == ref.lmx
    np.testing.assert_allclose(res.avg_log_probs, ref.avg_log_probs,
                               atol=1e-4)
    assert events, "the meshed decode surfaced no progress events"
    seen = set()
    for gi, s, t, fin in events:
        assert set(gi) <= {0, 1, 2}
        assert s.shape[0] == len(gi) == fin.shape[0]
        seen |= set(gi)
    assert seen == {0, 1, 2}


def test_batch_inference_meshed_beams_match_jax(models, rng):
    """Beams (2 per image) over a 2 x 2 mesh against JAX's unmeshed beam
    decode at fp32: the same LMX, mean log-probs within 1e-4."""
    imgs = _imgs(rng, SHAPES)
    jm, pm = jax_routes._MODEL, routes._MODEL
    ref = jax_batch_inference(jm["params"], jm["cfg"], imgs, jm["tokenizer"],
                              compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32, beam_size=2, **KW)
    res = bi.batch_inference(pm["params"], pm["cfg"], imgs, pm["tokenizer"],
                             compute_dtype=torch.float32,
                             cache_dtype=torch.float32, beam_size=2,
                             mesh=_mesh(), model_axis=mesh_lib.MODEL_AXIS,
                             **KW)
    assert res.lmx == ref.lmx
    np.testing.assert_allclose(res.avg_log_probs, ref.avg_log_probs,
                               atol=1e-4)


def test_serving_flow_batched_meshed_streams(models, rng, monkeypatch):
    """Dynamic batching + a 2 x 2 mesh + streaming compose: the mesh goes
    through ``enable_dynamic_batching``'s keyword arguments, the batcher's
    decode rides ``sharded_generate`` per bucket group, STEP events flow
    and keep the SSE contract, each system's STEP tokens are a prefix of its
    LMX, and the LMX equals the JAX app's unmeshed batched route at fp32
    system for system."""
    png = _png_bytes(rng, (64, 160))
    for m in (jax_routes, routes):
        monkeypatch.setattr(m, "FLUSH_INTERVAL", FLUSH)
    jax_routes.enable_dynamic_batching(
        max_batch=4, max_wait_ms=10.0, bucket_multiple=8,
        compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    batcher = routes.enable_dynamic_batching(
        max_batch=4, max_wait_ms=10.0, bucket_multiple=8,
        compute_dtype=torch.float32, cache_dtype=torch.float32, mesh=_mesh(),
        model_axis=mesh_lib.MODEL_AXIS)
    try:
        streams = []
        for app in (jax_wsgi.application, wsgi_app.application):
            c = WsgiClient(app)
            hdr = c.session(png, BOXES)
            streams.append(c.stream(hdr))
            c.get_json("POST", "/clear", headers=hdr)
        assert batcher.stats.completed >= 1
    finally:
        jax_routes.disable_dynamic_batching()
        routes.disable_dynamic_batching()
    jev, pev = streams
    assert collapsed(pev) == collapsed(jev)
    assert any(e == "step" for e, _ in pev), "no STEP events when meshed"
    jsys, psys = check_contract(jev, 3), check_contract(pev, 3)
    for s in range(3):
        (_, jf), (pt, pf) = jsys[s], psys[s]
        assert pf["lmx"] == jf["lmx"]
        assert pt and pf["lmx"].split()[: len(pt)] == pt
        assert pf["avg_log_prob"] == pytest.approx(jf["avg_log_prob"],
                                                   abs=1e-4)
