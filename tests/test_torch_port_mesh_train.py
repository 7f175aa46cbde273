"""Training over the mesh: the port against the JAX package on the CPU.

The data-parallel builders of ``parallel/trainer`` (their K15 sum is its
plain twin on CPU tensors), the accumulation windows, the training specs of
``parallel/sharding``, the GPipe pipeline of ``parallel/pipeline``, GRPO's
sharded update, ``forward_rollout_policy(mesh=)`` and the trainers' ``use_dp``
branches through ``parallel.mesh.train_devices`` patched to two CPU shards.
JAX's side runs on its 8 virtual CPU devices (``tests/conftest.py``), its
training stacks on the plain XLA path. Weights are the port's seeded
initialisation handed to JAX as arrays; inputs come from
``np.random.default_rng``. Tolerances: the sharded gradients atol 1e-6 and
rtol 1e-5 (JAX's own DP test), losses rtol 1e-6; the pipeline atol 1e-5;
GRPO's decoder leaves 1e-4 of each leaf's largest entry and its metrics rtol
1e-5 (``test_torch_port_grpo.py``'s bounds); the specs exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acai_omr_tpu.models import omr_decoder as jax_decoder
from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.vit_encoder import EncoderConfig as JaxEncoderConfig
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.parallel import mesh as jax_mesh
from acai_omr_tpu.parallel import pipeline as jax_pipeline
from acai_omr_tpu.parallel import sharding as jax_sharding
from acai_omr_tpu.parallel import trainer as jax_trainer
from acai_omr_tpu.train import omr_grpo_train as jax_grpo
from acai_omr_tpu.train import omr_teacher_force_train as jax_tf

from acai_omr_tpu_torch.data.datasets import DebugDataset
from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.lmx.delinearizer import delinearize
from acai_omr_tpu_torch.models import decode, mae, omr_decoder, vit_encoder
from acai_omr_tpu_torch.models import vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.parallel import mesh as mesh_lib
from acai_omr_tpu_torch.parallel import pipeline, sharding, trainer
from acai_omr_tpu_torch.train import grpo_rewards
from acai_omr_tpu_torch.train import omr_grpo_train as grpo
from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train
from acai_omr_tpu_torch.train import pre_train as pt

from _torch_port_threads import torch_one_thread  # noqa: F401

TOK = LmxTokenizer()
CPU = torch.device("cpu")
SOFT = {"use_hard_sampling": False}
# the ragged tiny ViTOMR of tests/test_parallel.py's sharded-gradient test
ENC = dict(patch_size=16, pe_max_height=6, pe_max_width=8, num_layers=2,
           hidden_dim=16, num_heads=2, mlp_dim=24, dropout=0.0)
DEC = dict(max_lmx_seq_len=32, num_layers=2, hidden_dim=16, num_heads=2,
           mlp_dim=24, dropout=0.0)
# the tiny decoder of its pipeline tests
PP_DEC = dict(max_lmx_seq_len=32, vocab_size=31, num_layers=4, hidden_dim=32,
              num_heads=4, mlp_dim=48, dropout=0.0, pad_idx=1, bos_idx=0,
              eos_idx=2)


@pytest.fixture(autouse=True)
def _plain_jax_paths():
    """JAX's stacks and decode on their plain XLA paths; restored after."""
    prev = ((ptl._FORCE, ptl._INTERPRET),
            (pallas_monolith._FORCE, pallas_monolith._INTERPRET))
    ptl.set_test_mode(force=False, interpret=False)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    yield
    ptl.set_test_mode(*prev[0])
    pallas_monolith.set_test_mode(*prev[1])


def _to_jax(tree):
    flat = trainer.tree_flatten(tree)
    return trainer.tree_unflatten({k: jnp.asarray(v.detach().numpy())
                                   for k, v in flat.items()})


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in trainer.tree_flatten(
        jax.tree.map(np.asarray, tree)).items()}


def _vitomr_cfgs():
    jcfg = jax_vitomr.ViTOMRConfig(
        encoder=JaxEncoderConfig(**ENC),
        decoder=JaxDecoderConfig.from_tokenizer(TOK, **DEC),
        transition_head_dim=24, transition_head_dropout=0.0)
    pcfg = vitomr.ViTOMRConfig(
        encoder=EncoderConfig(**ENC),
        decoder=DecoderConfig.from_tokenizer(TOK, **DEC),
        transition_head_dim=24, transition_head_dropout=0.0)
    return jcfg, pcfg


def _tf_batch(seed=0, b=8, l_img=12, t=10, all_padding=False):
    """Ragged valid-token counts, so that per-shard means would not average
    to the global mean; tf_prob = 1 makes the step independent of the
    randomness (the shards draw from other seeds)."""
    rng = np.random.default_rng(seed)
    lmx_valid = np.arange(t)[None, :] < rng.integers(3, t, size=(b, 1))
    inputs = rng.integers(3, TOK.vocab_size, size=(b, t)).astype(np.int32)
    targets = rng.integers(3, TOK.vocab_size, size=(b, t)).astype(np.int32)
    targets[~lmx_valid] = TOK.pad_idx
    if all_padding:
        inputs[:] = targets[:] = TOK.pad_idx
        lmx_valid[:] = False
    arrays = dict(
        patches=rng.random((b, l_img, 256), np.float32),
        pe_idx=rng.integers(0, 48, size=(b, l_img, 4)).astype(np.int32),
        pe_w=rng.random((b, l_img, 4), np.float32),
        valid=np.ones((b, l_img), bool), inputs=inputs, targets=targets,
        lmx_valid=lmx_valid)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jb.update(tf_prob=jnp.float32(1.0), tau=jnp.float32(1.0))
    pb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    pb.update(tf_prob=1.0, tau=1.0)
    return jb, pb


@pytest.fixture(scope="module")
def tiny():
    """The tiny ViTOMR, its batch, and JAX's gradients: one device, and the
    sharded grad fn at D = 2 and 4."""
    jcfg, pcfg = _vitomr_cfgs()
    params = vitomr.init_vitomr_params(pcfg, seed=0, device=CPU)
    jparams = _to_jax(params)
    jb, pb = _tf_batch(0)
    key = jax.random.PRNGKey(5)
    ref = jax_trainer.make_grad_fn(jax_tf.make_loss_fn(
        jcfg, SOFT, jnp.float32))(jparams, jb, key)
    sharded = {}
    for d in (2, 4):
        fn = jax_trainer.make_sharded_grad_fn(jax_tf.make_sum_loss_fn(
            jcfg, SOFT, jnp.float32),
            jax_mesh.make_mesh(d, 1))
        sharded[d] = fn(jparams, jb, key)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, jparams=jparams, jb=jb,
                pb=pb, ref=ref, sharded=sharded)


def _close(grads, jgrads, atol=1e-6, rtol=1e-5):
    want = _flat_np(jgrads)
    got = trainer.tree_flatten(grads)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_grad_fn_matches_jax(tiny, d):
    """D shards on the CPU: the exact global mean and its gradients, against
    JAX's sharded grad fn and its one-device grad fn; the gradients are
    views into one flat buffer."""
    mesh = mesh_lib.make_mesh(d, 1, ["cpu"] * d)
    fn = trainer.make_sharded_grad_fn(tf_train.make_sum_loss_fn(
        tiny["pcfg"], SOFT, torch.float32), mesh)
    loss, grads = fn(tiny["params"], tiny["pb"], 5)
    jloss, jgrads = tiny["sharded"][d]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(tiny["ref"][0]), rtol=1e-6)
    _close(grads, jgrads)
    _close(grads, tiny["ref"][1])
    leaves = list(trainer.tree_flatten(grads).values())
    base = leaves[0].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in leaves)


def test_all_padding_batch_gives_zero_gradients(tiny):
    mesh = mesh_lib.make_mesh(2, 1, ["cpu"] * 2)
    _, pb = _tf_batch(2, all_padding=True)
    loss, grads = trainer.make_sharded_grad_fn(tf_train.make_sum_loss_fn(
        tiny["pcfg"], SOFT, torch.float32), mesh)(tiny["params"], pb, 3)
    assert float(loss) == 0.0
    for v in trainer.tree_flatten(grads).values():
        assert torch.isfinite(v).all() and not v.any()


def test_grad_acc_train_step_and_eval_fn(tiny):
    """The sharded accumulator adds the sharded gradients in place; two
    sharded train steps equal two one-device steps on the mean loss; the
    sharded eval equals JAX's sharded eval."""
    pcfg, params = tiny["pcfg"], tiny["params"]
    mesh = mesh_lib.make_mesh(2, 1, ["cpu"] * 2)
    sum_fn = tf_train.make_sum_loss_fn(pcfg, SOFT, torch.float32)
    grad_fn = trainer.make_sharded_grad_fn(sum_fn, mesh)
    _, pb2 = _tf_batch(1)
    _, g1 = grad_fn(params, tiny["pb"], 0)
    _, g2 = grad_fn(params, pb2, 0)
    want = trainer.accumulate_grads(trainer.tree_map(torch.clone, g1), g2)
    _, acc = grad_fn(params, tiny["pb"], 0)
    acc = trainer.tree_map(torch.clone, acc)
    _, out = trainer.make_sharded_grad_acc_fn(sum_fn, mesh)(params, pb2, 0,
                                                             acc)
    assert out is acc
    for k, v in trainer.tree_flatten(acc).items():
        assert torch.equal(v, trainer.tree_flatten(want)[k]), k

    tx = trainer.adamw(1e-2, weight_decay=0.01)
    s_dp = trainer.create_train_state(params, tx)
    s_one = trainer.create_train_state(params, tx)
    step_dp = trainer.make_sharded_train_step(sum_fn, tx, mesh)
    step_one = trainer.make_train_step(tf_train.make_loss_fn(
        pcfg, SOFT, torch.float32), tx)
    for pb in (tiny["pb"], pb2):
        s_dp, m_dp = step_dp(s_dp, pb, 0)
        s_one, m_one = step_one(s_one, pb, 0)
        np.testing.assert_allclose(float(m_dp["loss"]), float(m_one["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m_dp["grad_norm"]),
                                   float(m_one["grad_norm"]), rtol=1e-5)
    assert s_dp.step == 2
    # AdamW divides each entry by its own root mean square, so a gradient
    # entry that is zero up to fp32 noise (the key biases) takes either
    # sign of the step: 2 * lr a step (test_torch_port_grpo.py's bound)
    for k, v in trainer.tree_flatten(s_dp.params).items():
        np.testing.assert_allclose(v.numpy(), trainer.tree_flatten(
            s_one.params)[k].numpy(), atol=2 * 2 * 1e-2, rtol=0, err_msg=k)

    jeval = jax_tf.make_eval_fn(tiny["jcfg"], jnp.float32,
                                mesh=jax_mesh.make_mesh(2, 1))
    peval = tf_train.make_eval_fn(pcfg, torch.float32, mesh=mesh)
    np.testing.assert_allclose(float(peval(params, tiny["pb"])),
                               float(jeval(tiny["jparams"], tiny["jb"])),
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(peval(params, tiny["pb"])),
        float(tf_train.make_eval_fn(pcfg, torch.float32)(params, tiny["pb"])),
        rtol=1e-6)


def test_data_axis_sizes_k15_does_not_take_raise(tiny):
    sum_fn = tf_train.make_sum_loss_fn(tiny["pcfg"], SOFT, torch.float32)
    for d in (3, 8):
        mesh = mesh_lib.make_mesh(d, 1, ["cpu"] * d)
        for build in (trainer.make_sharded_grad_fn,
                      trainer.make_sharded_eval_fn):
            with pytest.raises(ValueError, match="2 or 4"):
                build(sum_fn, mesh)
        with pytest.raises(ValueError, match="2 or 4"):
            pipeline.make_pp_grad_fn(DecoderConfig(**PP_DEC),
                                     mesh_lib.make_mesh(d, 1, ["cpu"] * d),
                                     stage_axis="model", data_axis="data")


def test_k15_takes_the_flat_gradient_buffer_within_its_int_index():
    """K15's one-card form indexes a rank's elements with a 32-bit int: the
    flagship's flat buffer (305,414,632 fp32) is planned, and a buffer past
    the last index whose block's idle threads stay below 2**31 is refused
    before any launch."""
    from acai_omr_tpu_torch.ops import tp_allreduce_kernel as k15
    blocks, threads = k15.local_plan(305_414_632, 2, torch.float32)
    assert blocks * threads * k15.LOCAL_ELEMS >= 305_414_632
    n = k15.MAX_LOCAL_ELEMS
    blocks, threads = k15.local_plan(n, 4, torch.float32)
    assert (blocks * threads - 1) * k15.LOCAL_ELEMS <= 2 ** 31 - 1
    with pytest.raises(ValueError, match="32-bit"):
        k15.local_plan(n + k15.LOCAL_ELEMS, 2, torch.float32)


@pytest.mark.parametrize("d", [2, 4])
def test_dp_sum_writes_the_first_buffer_in_place(d):
    """K15 ``root_only`` (its twin on the CPU): rank 0's output alone, into
    rank 0's part, equal to the twin's rank 0 output; the other parts left
    as they were; in and out types must agree. ``dp_sum`` returns the first
    buffer, holding the sum."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    rng = np.random.default_rng(d)
    bufs = [torch.from_numpy(rng.standard_normal(40).astype(np.float32))
            for _ in range(d)]
    group = TPGroup(["cpu"] * d)
    want = tp_allreduce.plain([b.view(1, -1) for b in bufs], group)[0]
    others = [b.clone() for b in bufs[1:]]
    first = bufs[0]
    got = tp_allreduce([b.view(1, -1) for b in bufs], group, root_only=True)
    assert len(got) == 1 and got[0].data_ptr() == first.data_ptr()
    assert torch.equal(first.view(1, -1), want)
    assert all(torch.equal(a, b) for a, b in zip(bufs[1:], others))
    with pytest.raises(ValueError, match="in place"):
        tp_allreduce([b.view(1, -1) for b in bufs], group,
                     out_dtype=torch.bfloat16, root_only=True)
    mesh = mesh_lib.make_mesh(d, 1, ["cpu"] * d)
    bufs[0] = others[0].clone()
    want = sum(bufs[1:], bufs[0].clone()) if d == 2 else \
        (bufs[0] + bufs[1]) + (bufs[2] + bufs[3])
    out = trainer.dp_sum(mesh, bufs)
    assert out is bufs[0] and torch.equal(out, want)


def _linear_loss(p, batch, seed):
    return (torch.mean(torch.sum(p["w"] * batch["x"], -1))
            + torch.sum(p["b"] ** 2)), {}


def _jax_linear_loss(p, batch, rng):
    return (jnp.mean(jnp.sum(p["w"] * batch["x"], -1))
            + jnp.sum(p["b"] ** 2)), {}


def test_accumulate_and_window_steps_match_jax():
    """``accumulate_grads``, ``stack_microbatches``, the window step and the
    accumulation step against JAX's on a loss that needs no randomness."""
    rng = np.random.default_rng(4)
    w0, b0 = rng.standard_normal(4).astype(np.float32), \
        rng.standard_normal(3).astype(np.float32)
    mbs = [rng.standard_normal((2, 4)).astype(np.float32) for _ in range(3)]
    pparams = {"w": torch.from_numpy(w0), "b": torch.from_numpy(b0)}
    jparams = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    ptx = trainer.adamw(1e-1, weight_decay=0.0)
    jtx = jax_trainer.adamw(1e-1, weight_decay=0.0)

    pg = trainer.make_grad_fn(_linear_loss)
    jg = jax_trainer.make_grad_fn(_jax_linear_loss)
    acc = jacc = None
    for x in mbs:
        acc = trainer.accumulate_grads(acc, pg(pparams, {"x": torch.from_numpy(
            x)}, 0)[1])
        jacc = jax_trainer.accumulate_grads(
            jacc, jg(jparams, {"x": jnp.asarray(x)}, jax.random.PRNGKey(0))[1])
    _close(acc, jacc, atol=1e-6, rtol=1e-6)

    stacked = trainer.stack_microbatches([{"x": torch.from_numpy(x), "s": 1.0}
                                          for x in mbs])
    assert stacked["x"].shape == (3, 2, 4) and stacked["s"] == 1.0
    with pytest.raises(ValueError, match="disagree"):
        trainer.stack_microbatches([{"s": 1.0}, {"s": 2.0}])

    ps, losses = trainer.make_window_step_fn(_linear_loss, ptx, 3)(
        trainer.create_train_state(pparams, ptx), stacked, 7, 0.5)
    js, jlosses = jax_trainer.make_window_step_fn(_jax_linear_loss, jtx, 3)(
        jax_trainer.create_train_state(jax.tree.map(jnp.array, jparams), jtx),
        jax_trainer.stack_microbatches([{"x": jnp.asarray(x)} for x in mbs]),
        jax.random.PRNGKey(7), jnp.float32(0.5))
    assert ps.step == int(js.step) == 1
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-6)
    _close(ps.params, js.params, atol=1e-6, rtol=1e-6)

    batch = {"x": stacked["x"]}
    ps, pm = trainer.make_accum_train_step(_linear_loss, ptx, 3)(
        trainer.create_train_state(pparams, ptx), batch, 0)
    js, jm = jax_trainer.make_accum_train_step(_jax_linear_loss, jtx, 3,
                                               donate=False)(
        jax_trainer.create_train_state(jparams, jtx),
        {"x": jnp.asarray(batch["x"].numpy())}, jax.random.PRNGKey(0))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6)
    _close(ps.params, js.params, atol=1e-6, rtol=1e-6)


def test_param_specs_and_shard_params_match_jax():
    """Every leaf's spec equals JAX's; on a (4, 2) mesh the fallback to
    replication where a dim does not divide equals JAX's shardings; each
    shard holds its contiguous piece."""
    jcfg, pcfg = _vitomr_cfgs()
    params = vitomr.init_vitomr_params(pcfg, seed=0, device=CPU)
    jparams = _to_jax(params)
    want = trainer.tree_flatten(jax.tree.map(
        tuple, jax_sharding.param_specs(jparams),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    got = trainer.tree_flatten(sharding.param_specs(params))
    assert got == want
    assert any("model" in s for s in got.values())
    jshard = trainer.tree_flatten(jax.tree.map(
        lambda s: tuple(s.spec), jax_sharding.param_shardings(
            jax_mesh.make_mesh(4, 2), jparams)))
    mesh = mesh_lib.make_mesh(4, 2, ["cpu"] * 8)
    placed = trainer.tree_flatten(sharding.param_shardings(mesh, params))
    assert placed == jshard
    assert placed["decoder/unembed/kernel"] == ()  # 227 does not split in 2
    shards = sharding.shard_params(mesh, params)
    flat = trainer.tree_flatten(params)
    for d in range(4):
        for m in range(2):
            for k, v in trainer.tree_flatten(shards[d][m]).items():
                spec = placed[k]
                want_v = flat[k] if "model" not in spec else torch.chunk(
                    flat[k], 2, dim=spec.index("model"))[m]
                assert torch.equal(v, want_v), k


@pytest.fixture(scope="module")
def pp_case():
    """The tiny decoder, its batch, and JAX's unpipelined and pipelined
    (D = 2 x S = 4, n_micro = 2) losses and gradients."""
    jcfg = JaxDecoderConfig(**PP_DEC)
    pcfg = DecoderConfig(**PP_DEC)
    params = omr_decoder.init_decoder_params(torch.Generator().manual_seed(0),
                                             pcfg)
    jparams = _to_jax(params)
    rng = np.random.default_rng(5)
    b, t, m = 8, 12, 10
    lens = np.array([t, t - 2, t, t - 4, t, t, t - 1, t])
    arrays = (rng.integers(0, 31, (b, t)).astype(np.int32),
              rng.integers(0, 31, (b, t)).astype(np.int32),
              np.arange(t)[None] < lens[:, None],
              rng.standard_normal((b, m, 32)).astype(np.float32),
              np.ones((b, m), bool))
    jbatch = tuple(jnp.asarray(a) for a in arrays)

    def ref_loss(p):
        logits = jax_decoder.forward(p, jcfg, jbatch[0], jbatch[3], jbatch[2],
                                     jbatch[4], compute_dtype=jnp.float32)
        s, n = jax_vitomr.omr_ce_loss(logits, jbatch[1], jcfg.pad_idx, 0.0,
                                      "sum")
        return s / jnp.maximum(n, 1.0)

    ref = jax.value_and_grad(ref_loss)(jparams)
    jm = jax_mesh.make_mesh(2, 4)
    pp = jax_pipeline.stage_params(jparams, jcfg, jm, jax_mesh.MODEL_AXIS)
    piped = jax_pipeline.make_pp_grad_fn(
        jcfg, jm, stage_axis=jax_mesh.MODEL_AXIS,
        data_axis=jax_mesh.DATA_AXIS, n_micro=2)(pp, jbatch)
    return dict(pcfg=pcfg, params=params, ref=ref, piped=piped,
                batch=tuple(torch.from_numpy(a) for a in arrays))


def test_pipeline_matches_jax(pp_case):
    mesh = mesh_lib.make_mesh(2, 4, ["cpu"] * 8)
    pcfg = pp_case["pcfg"]
    pp = pipeline.stage_params(pp_case["params"], pcfg, mesh, "model")
    assert pp["blocks"]["linear1"]["kernel"].shape[:2] == (4, 1)
    specs = pipeline.pp_param_specs(pp, "model")
    assert specs["blocks"]["linear1"]["kernel"] == ("model",)
    assert specs["unembed"]["kernel"] == ()
    loss, grads = pipeline.make_pp_grad_fn(
        pcfg, mesh, stage_axis="model", data_axis="data", n_micro=2)(
        pp, pp_case["batch"])
    for want_loss, want_grads in (pp_case["ref"], pp_case["piped"]):
        np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5)
    _close(pipeline.unstage_params(grads), pp_case["ref"][1], atol=1e-5,
           rtol=0)
    _close(grads, pp_case["piped"][1], atol=1e-5, rtol=0)
    value = pipeline.make_pp_loss_fn(pcfg, mesh, stage_axis="model",
                                     data_axis="data", n_micro=2)(
        pp, *pp_case["batch"])
    np.testing.assert_allclose(float(value), float(pp_case["ref"][0]),
                               atol=1e-5)
    # without a data axis: one pipeline over the whole batch, differentiable
    loss_fn = pipeline.make_pp_loss_fn(pcfg, mesh, stage_axis="model",
                                       n_micro=4)
    leaf = pp["unembed"]["bias"].clone().requires_grad_(True)
    whole = loss_fn({**pp, "unembed": {**pp["unembed"], "bias": leaf}},
                    *pp_case["batch"])
    whole.backward()
    np.testing.assert_allclose(whole.item(), float(pp_case["ref"][0]),
                               atol=1e-5)
    np.testing.assert_allclose(
        leaf.grad.numpy(), np.asarray(pp_case["ref"][1]["unembed"]["bias"]),
        atol=1e-5)
    assert merge_round_trip(pp, pp_case["params"])


def merge_round_trip(pp, params) -> bool:
    back = trainer.tree_flatten(pipeline.unstage_params(pp))
    return all(torch.equal(v, back[k])
               for k, v in trainer.tree_flatten(params).items())


def test_pipeline_train_step_lowers_the_loss(pp_case):
    mesh = mesh_lib.make_mesh(2, 4, ["cpu"] * 8)
    pp = pipeline.stage_params(pp_case["params"], pp_case["pcfg"], mesh,
                               "model")
    tx = trainer.adamw(1e-3, weight_decay=0.0)
    state = trainer.create_train_state(pp, tx)
    step = pipeline.make_pp_train_step(pp_case["pcfg"], tx, mesh,
                                       stage_axis="model", data_axis="data",
                                       n_micro=2)
    losses = []
    for _ in range(4):
        state, metrics = step(state, pp_case["batch"])
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[0], float(pp_case["ref"][0]), atol=1e-5)
    assert losses[-1] < losses[0]
    assert state.params["blocks"]["linear1"]["kernel"].shape[0] == 4


R_GROUPS, G, T_ROLL, M_LAT = 2, 3, 14, 10
GRPO_DEC = dict(max_lmx_seq_len=64, num_layers=2, hidden_dim=64, num_heads=2,
                mlp_dim=128, dropout=0.0)
GRPO_ENC = dict(ENC, hidden_dim=64, mlp_dim=128)
LMX = "measure time beats:4 beat-type:4 clef:G2 C4 voice:1 quarter rest quarter"


def _grpo_cfgs():
    jcfg = jax_vitomr.ViTOMRConfig(
        encoder=JaxEncoderConfig(**GRPO_ENC),
        decoder=JaxDecoderConfig.from_tokenizer(TOK, **GRPO_DEC),
        transition_head_dim=96, transition_head_dropout=0.0)
    pcfg = vitomr.ViTOMRConfig(
        encoder=EncoderConfig(**GRPO_ENC),
        decoder=DecoderConfig.from_tokenizer(TOK, **GRPO_DEC),
        transition_head_dim=96, transition_head_dropout=0.0)
    return jcfg, pcfg


def _grpo_batch(seed=1):
    """2 images x 3 rollouts of ragged lengths, their sampler log-probs,
    advantages and the CE anchor's gold rows (test_torch_port_grpo.py's)."""
    rng = np.random.default_rng(seed)
    r, pad = R_GROUPS * G, TOK.pad_idx
    lens = np.array([14, 5, 9, 2, 11, 7])
    rollouts = rng.integers(3, TOK.vocab_size, (r, T_ROLL)).astype(np.int32)
    rollouts[:, 0] = TOK.bos_idx
    for i, n in enumerate(lens):
        rollouts[i, n - 1] = TOK.eos_idx if n < T_ROLL else rollouts[i, n - 1]
        rollouts[i, n:] = pad
    mask = np.arange(T_ROLL)[None] < lens[:, None]
    inputs, valid = jax_grpo.prepare_rollouts_for_policy_theta(rollouts, mask,
                                                               pad)
    old_lp = np.where(mask, -rng.uniform(0.1, 3.0, (r, T_ROLL)), 0.0)
    old_lp[:, 0] = 0.0
    latent = rng.standard_normal((R_GROUPS, M_LAT, 64)).astype(np.float32)
    lat_valid = np.arange(M_LAT)[None] < np.array([M_LAT, 6])[:, None]
    gold = [TOK.encode(LMX), TOK.encode("measure clef:G2 C4 voice:1 quarter")]
    g_in, g_tg, g_valid = omr_decoder.batchify_and_split_lmx_seqs(
        gold, pad, max_len=GRPO_DEC["max_lmx_seq_len"])
    arrays = dict(
        rollouts=rollouts, rollout_inputs=inputs, rollout_input_valid=valid,
        old_log_probs=old_lp.astype(np.float32),
        advantages=rng.standard_normal(r).astype(np.float32),
        img_latent=latent, latent_valid=lat_valid, gold_inputs=g_in,
        gold_targets=g_tg, gold_input_valid=g_valid,
        unexpanded_img_latent=latent, unexpanded_latent_valid=lat_valid)
    scalars = dict(entropy_beta=0.05, lambda_ce=0.1)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatch.update({k: jnp.float32(v) for k, v in scalars.items()})
    pbatch = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
    for k in ("rollouts", "rollout_inputs", "gold_inputs", "gold_targets"):
        pbatch[k] = pbatch[k].long()
    pbatch.update(scalars)
    return jbatch, pbatch


def _recorder():
    """An optax transformation that passes the gradients on and keeps them
    as its state: JAX's gradients, read back."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def test_grpo_sharded_update_matches_jax():
    """GRPO's update at D = 2 (one image and its 3 rollouts a shard): every
    decoder leaf's gradient and the metrics against JAX's sharded update,
    and the sharded step against the port's mesh-less step."""
    jcfg, pcfg = _grpo_cfgs()
    params = vitomr.init_vitomr_params(pcfg, seed=0, device=CPU)
    jbatch, pbatch = _grpo_batch()
    lr = 1e-3
    jtx = optax.chain(_recorder(), jax_trainer.adamw(
        lr, betas=grpo.ADAMW_BETAS, weight_decay=0.01, max_grad_norm=0.1,
        scale_tree_fn=jax_grpo.grpo_frozen_scales))
    jstep = jax_grpo.make_grpo_update_step(
        jcfg, jtx, R_GROUPS, 0.2, jnp.float32, rollout_microbatches=3,
        mesh=jax_mesh.make_mesh(2, 1))
    jparams = _to_jax(params)
    jstate, jm = jstep(jax_trainer.create_train_state(jparams, jtx), jbatch,
                       jax.random.PRNGKey(0))
    jg = _flat_np(jstate.opt_state[0])

    mesh = mesh_lib.make_mesh(2, 1, ["cpu"] * 2)
    grads, sums = grpo.make_sharded_grpo_grads_fn(
        pcfg, R_GROUPS, 0.2, mesh, compute_dtype=torch.float32,
        rollout_microbatches=3)(params, pbatch)
    for k, g in trainer.tree_flatten(grads).items():
        if not k.startswith("decoder/"):
            assert not g.any() and not jg[k].any(), k
            continue
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        assert float(np.abs(g.numpy() - jg[k]).max()) / scale <= 1e-4, k
    ptx = trainer.adamw(lr, betas=grpo.ADAMW_BETAS, weight_decay=0.01,
                        max_grad_norm=0.1,
                        scale_tree_fn=grpo.grpo_frozen_scales)
    pm = {}
    for name, m in (("dp", mesh), ("one", None)):
        step = grpo.make_grpo_update_step(pcfg, ptx, R_GROUPS, 0.2,
                                          torch.float32,
                                          rollout_microbatches=3, mesh=m)
        _, pm[name] = step(trainer.create_train_state(params, ptx), pbatch)
    for k in ("loss", "grpo_objective", "entropy_bonus", "ce_loss",
              "grad_norm"):
        np.testing.assert_allclose(float(pm["dp"][k]), float(jm[k]),
                                   rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(pm["dp"][k]), float(pm["one"][k]),
                                   rtol=1e-5, err_msg=k)


def test_forward_rollout_policy_on_a_mesh():
    """Two data shards on the CPU: the seed drawn from the generator, then
    ``decode.sharded_generate``'s rollouts."""
    _, pcfg = _grpo_cfgs()
    params = vitomr.init_vitomr_params(pcfg, seed=0, device=CPU)
    rng = np.random.default_rng(6)
    latent = torch.from_numpy(rng.standard_normal((2, M_LAT, 64)).astype(
        np.float32))
    valid = torch.from_numpy(np.arange(M_LAT)[None] < np.array([M_LAT, 6])[
        :, None])
    mesh = mesh_lib.make_mesh(2, 1, ["cpu"] * 2)
    kw = dict(max_actions=12, top_k=5, temperature=1.1, group_size=3,
              compute_dtype=torch.float32, cache_dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    seqs, lps, mask = vitomr.forward_rollout_policy(params, pcfg, latent,
                                                    valid, gen, mesh=mesh,
                                                    **kw)
    seed = int(torch.randint(2 ** 31 - 1, (),
                             generator=torch.Generator().manual_seed(9)))
    want = decode.sharded_generate(
        params["decoder"], pcfg.decoder, latent, valid, mesh, max_len=12,
        sampling=decode.SamplingConfig(top_k=5, temperature=1.1), seed=seed,
        mem_group=3, compute_dtype=torch.float32, cache_dtype=torch.float32)
    assert seqs.shape[0] == 6 and torch.isfinite(lps[mask]).all()
    for a, b in zip((seqs, lps, mask), want):
        assert torch.equal(a, b)


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    lmx = [LMX, "measure clef:G2 C4 voice:1 quarter",
           "measure time beats:3 beat-type:4 clef:F4 E3 voice:1 half"]
    return [(rng.random((1, 48, 64 + 16 * (i % 2)), dtype=np.float32),
             TOK.encode(lmx[i % 3]), delinearize(lmx[i % 3])[0])
            for i in range(n)]


def _cpu_shards(monkeypatch, n):
    """The trainers' device seam listing ``n`` CPU devices, and a record of
    the sharded builders they call (name, mesh)."""
    monkeypatch.setattr(mesh_lib, "train_devices",
                        lambda device=None: [CPU] * n)
    built = []
    for name in ("make_sharded_grad_fn", "make_sharded_grad_acc_fn",
                 "make_sharded_train_step", "make_sharded_eval_fn"):
        inner = getattr(trainer, name)

        def wrap(*args, _inner=inner, _name=name, **kwargs):
            built.append((_name, args[-1] if _name != "make_sharded_train_step"
                          else args[2]))
            return _inner(*args, **kwargs)
        monkeypatch.setattr(trainer, name, wrap)
    return built


@pytest.fixture
def two_cpu_shards(monkeypatch):
    return _cpu_shards(monkeypatch, 2)


def test_trainers_take_the_data_parallel_branch(tmp_path, two_cpu_shards):
    """Stage 2, stage 1 and GRPO through ``train_devices`` patched to two
    CPU shards: each builds its sharded steps on a 2 x 1 mesh and trains to
    finite losses; a batch that does not divide stays on one device."""
    enc = EncoderConfig(**{**ENC, "dropout": 0.05}, fine_tune_depth=1)
    cfg = vitomr.ViTOMRConfig(
        encoder=enc, decoder=DecoderConfig.from_tokenizer(
            TOK, **{**DEC, "max_lmx_seq_len": 64, "dropout": 0.1}),
        transition_head_dim=24, transition_head_dropout=0.05)
    params = vitomr.init_vitomr_params(cfg, seed=0, device=CPU)
    ds = lambda n, seed: DebugDataset(n=n, sizes=((64, 96), (48, 64)),
                                      seq_len=10, vocab=TOK.vocab_size,
                                      kind="omr", seed=seed)
    _, stats = tf_train.omr_teacher_force_train(
        cfg, params, ds(4, 0), ds(2, 1), TOK, epochs=1, batch_size=2,
        grad_accumulation_steps=2, warmup_epochs=1, model_dir=tmp_path / "tf",
        num_workers=2, bucket_boundaries=[(64, 96)],
        compute_dtype=torch.float32, device="cpu")
    assert all(np.isfinite(stats["train_losses"] + stats["val_losses"]))
    kinds = [k for k, _ in two_cpu_shards]
    # hard and soft sampling: a grad fn and an accumulating one each (which
    # builds its grad fn)
    assert kinds.count("make_sharded_grad_fn") == 4
    assert kinds.count("make_sharded_grad_acc_fn") == 2
    assert kinds.count("make_sharded_eval_fn") == 1
    assert all(m.shape == {"data": 2, "model": 1} for _, m in two_cpu_shards)

    two_cpu_shards.clear()
    mcfg = mae.MaeConfig(encoder=EncoderConfig(
        patch_size=16, pe_max_height=16, pe_max_width=16, num_layers=1,
        hidden_dim=32, num_heads=2, mlp_dim=64), mask_ratio=0.75,
        decoder_num_layers=1, decoder_hidden_dim=32, decoder_num_heads=2,
        decoder_mlp_dim=64)
    mds = lambda n, seed: DebugDataset(n=n, sizes=((64, 96), (48, 64)),
                                       kind="mae", seed=seed)
    _, mstats = pt.pre_train(mcfg, mds(4, 0), mds(2, 1), epochs=1,
                             batch_size=2, warmup_epochs=1, num_workers=2,
                             compute_dtype=torch.float32, device="cpu",
                             model_dir=tmp_path / "mae")
    assert all(np.isfinite(mstats["train_losses"] + mstats["val_losses"]))
    assert [k for k, _ in two_cpu_shards] == ["make_sharded_train_step",
                                              "make_sharded_grad_fn",
                                              "make_sharded_eval_fn"]

    two_cpu_shards.clear()
    pt.pre_train(mcfg, mds(1, 0), mds(1, 1), epochs=1, batch_size=3,
                 warmup_epochs=1, num_workers=1, compute_dtype=torch.float32,
                 device="cpu", model_dir=tmp_path / "mae3")
    assert two_cpu_shards == []  # 3 rows do not split over 2 devices

    _, gcfg = _grpo_cfgs()
    gcfg, gparams = grpo.set_up_grpo(gcfg, vitomr.init_vitomr_params(
        gcfg, seed=0, device=CPU))
    tiny_grpo = grpo_rewards.GRPOConfig(
        rollout_config=grpo_rewards.RolloutConfig(group_size=2, max_actions=16,
                                                  top_k=5, temperature=1.1),
        reward_config=copy.deepcopy(grpo.INITIAL_REWARD_CONFIG),
        loss_config=copy.deepcopy(grpo.INITIAL_LOSS_CONFIG),
        update_config=grpo_rewards.UpdateConfig(epsilon=0.2, update_epochs=1,
                                                max_grad_norm=1.0),
        mini_validation_freq=10, checkpoint_freq=10)
    built = []
    real = grpo.make_sharded_grpo_grads_fn

    def spy(*args, **kwargs):
        built.append(args[3])
        return real(*args, **kwargs)
    grpo.make_sharded_grpo_grads_fn = spy
    try:
        _, gstats = grpo.grpo_train(
            gcfg, gparams, _examples(2), TOK, grpo_config=tiny_grpo,
            batch_size=2, lr=1e-4, model_dir=tmp_path / "grpo",
            compute_dtype=torch.float32, reward_workers=2,
            exploration_steps=1, device="cpu")
    finally:
        grpo.make_sharded_grpo_grads_fn = real
    assert len(gstats) == 1 and all(np.isfinite(s["loss"]) for s in gstats)
    assert len(built) == 1 and built[0].shape == {"data": 2, "model": 1}


@pytest.mark.parametrize("n_dev,batch,want", [
    (1, 8, None), (2, 8, 2), (3, 8, 2), (3, 3, None), (4, 8, 4), (4, 6, 2),
    (5, 8, 4), (6, 6, 2), (7, 4, 4), (8, 8, 4), (8, 6, 2), (8, 3, None)])
def test_train_mesh_takes_what_k15_sums(n_dev, batch, want):
    """The trainers' mesh: the first 4, else the first 2, of the devices
    where the batch divides by that count, else none (one device)."""
    devices = [torch.device("cpu")] * n_dev
    mesh = mesh_lib.train_mesh(devices, batch)
    if want is None:
        assert mesh is None
    else:
        assert mesh.shape == {"data": want, "model": 1}
        mesh.dp_group()  # a size K15 takes


def test_trainers_on_eight_devices(tmp_path, monkeypatch):
    """Eight devices (the usual node): stage 1 and stage 2 set up and train
    data-parallel over the first 4 or 2 that divide the batch, and on one
    device where neither does."""
    built = _cpu_shards(monkeypatch, 8)
    mcfg = mae.MaeConfig(encoder=EncoderConfig(
        patch_size=16, pe_max_height=16, pe_max_width=16, num_layers=1,
        hidden_dim=32, num_heads=2, mlp_dim=64), mask_ratio=0.75,
        decoder_num_layers=1, decoder_hidden_dim=32, decoder_num_heads=2,
        decoder_mlp_dim=64)
    mds = lambda n, seed: DebugDataset(n=n, sizes=((64, 96), (48, 64)),
                                       kind="mae", seed=seed)
    for batch, shards in ((4, 4), (6, 2), (3, None)):
        built.clear()
        _, st = pt.pre_train(mcfg, mds(batch, 0), mds(batch, 1), epochs=1,
                             batch_size=batch, warmup_epochs=1,
                             num_workers=1, compute_dtype=torch.float32,
                             device="cpu", model_dir=tmp_path / f"mae{batch}")
        assert all(np.isfinite(st["train_losses"] + st["val_losses"]))
        assert [m.shape["data"] for _, m in built] == \
            ([] if shards is None else [shards] * 3)

    built.clear()
    cfg = vitomr.ViTOMRConfig(
        encoder=EncoderConfig(**ENC, fine_tune_depth=1),
        decoder=DecoderConfig.from_tokenizer(TOK, **{**DEC,
                                                     "max_lmx_seq_len": 64}),
        transition_head_dim=24)
    ds = lambda n, seed: DebugDataset(n=n, sizes=((64, 96),), seq_len=10,
                                      vocab=TOK.vocab_size, kind="omr",
                                      seed=seed)
    _, stats = tf_train.omr_teacher_force_train(
        cfg, vitomr.init_vitomr_params(cfg, seed=0, device=CPU), ds(4, 0),
        ds(4, 1), TOK, epochs=1, batch_size=4, warmup_epochs=1,
        model_dir=tmp_path / "tf", num_workers=1,
        bucket_boundaries=[(64, 96)], compute_dtype=torch.float32,
        device="cpu")
    assert all(np.isfinite(stats["train_losses"] + stats["val_losses"]))
    assert built and all(m.shape == {"data": 4, "model": 1}
                         for _, m in built)
