"""Stage-3 GRPO of the port against the JAX package, at fp32 on the CPU: the
rewards, the objective and entropy, the optimizer with global-norm clipping
and frozen leaves, one update step, and the loop.

Weights come from the JAX initializer (``params_from_jax``), inputs from
``np.random.default_rng``. The JAX update step runs its plain XLA decoder
stack (``pallas_train_layer`` not forced), which folds a rollout group into
the cross-attention's query axis; the port's stack repeats the projected
memory rows instead. Tolerances: objective, entropy, loss and metrics 1e-5
relative; every decoder leaf's gradient 1e-4 of that leaf's largest entry
(two 2-layer stacks summed in another order); parameters after one AdamW
step 2 * lr absolute (near-zero gradients take either sign of the step);
rewards 1e-6 (numpy on both sides, the same native TEDn).
"""

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acai_omr_tpu.models import vitomr as jax_vitomr
from acai_omr_tpu.models.omr_decoder import DecoderConfig as JaxDecoderConfig
from acai_omr_tpu.models.vit_encoder import EncoderConfig as JaxEncoderConfig
from acai_omr_tpu.ops import pallas_monolith
from acai_omr_tpu.ops import pallas_train_layer as ptl
from acai_omr_tpu.parallel import trainer as jax_trainer
from acai_omr_tpu.train import grpo_rewards as jax_rewards
from acai_omr_tpu.train import omr_grpo_train as jax_grpo

from acai_omr_tpu_torch.data.tokenizer import LmxTokenizer
from acai_omr_tpu_torch.lmx.delinearizer import delinearize
from acai_omr_tpu_torch.models import omr_decoder, vitomr
from acai_omr_tpu_torch.models.omr_decoder import DecoderConfig
from acai_omr_tpu_torch.models.vit_encoder import EncoderConfig
from acai_omr_tpu_torch.models.weights import params_from_jax
from acai_omr_tpu_torch.ops import decode_kernel, transformer
from acai_omr_tpu_torch.parallel import trainer
from acai_omr_tpu_torch.train import grpo_rewards, schedules
from acai_omr_tpu_torch.train import omr_grpo_train as grpo

from _torch_port_threads import torch_one_thread  # noqa: F401

TOK = LmxTokenizer()
ENC = dict(patch_size=16, pe_max_height=6, pe_max_width=8, num_layers=2,
           hidden_dim=64, num_heads=2, mlp_dim=128, dropout=0.0)
DEC = dict(max_lmx_seq_len=64, num_layers=2, hidden_dim=64, num_heads=2,
           mlp_dim=128, dropout=0.0)
PAD = TOK.pad_idx
LMX = "measure time beats:4 beat-type:4 clef:G2 C4 voice:1 quarter rest quarter"
R_GROUPS, G, T_ROLL, M_LAT = 2, 3, 14, 10


def _cfgs():
    jcfg = jax_vitomr.ViTOMRConfig(
        encoder=JaxEncoderConfig(**ENC),
        decoder=JaxDecoderConfig.from_tokenizer(TOK, **DEC),
        transition_head_dim=96, transition_head_dropout=0.0)
    pcfg = vitomr.ViTOMRConfig(
        encoder=EncoderConfig(**ENC),
        decoder=DecoderConfig.from_tokenizer(TOK, **DEC),
        transition_head_dim=96, transition_head_dropout=0.0)
    return jcfg, pcfg


@pytest.fixture(autouse=True)
def _plain_jax_paths():
    """The JAX update on its XLA stack and its decode on its per-op CPU step;
    switches restored after."""
    prev = ((ptl._FORCE, ptl._INTERPRET),
            (pallas_monolith._FORCE, pallas_monolith._INTERPRET))
    ptl.set_test_mode(force=False, interpret=False)
    pallas_monolith.set_test_mode(force=False, interpret=False)
    yield
    ptl.set_test_mode(*prev[0])
    pallas_monolith.set_test_mode(*prev[1])


@pytest.fixture(scope="module")
def model():
    """The port's seeded initialisation, handed to JAX as arrays (tracing the
    JAX initializer costs more than the tests that use it); the port holds
    it to the JAX tree's names through ``params_from_jax``."""
    jcfg, pcfg = _cfgs()
    flat = trainer.tree_flatten(vitomr.init_vitomr_params(pcfg, seed=0,
                                                          device="cpu"))
    jparams = trainer.tree_unflatten({k: jnp.asarray(v.numpy())
                                      for k, v in flat.items()})
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, pcfg, jparams, pparams


def _update_batch(seed=0):
    """A GRPO update's inputs: 2 images x 3 rollouts of ragged lengths, their
    sampler log-probs, advantages and the gold sequences of the CE anchor."""
    rng = np.random.default_rng(seed)
    r = R_GROUPS * G
    lens = np.array([14, 5, 9, 2, 11, 7])
    rollouts = rng.integers(3, TOK.vocab_size, (r, T_ROLL)).astype(np.int32)
    rollouts[:, 0] = TOK.bos_idx
    for i, n in enumerate(lens):
        rollouts[i, n - 1] = TOK.eos_idx if n < T_ROLL else rollouts[i, n - 1]
        rollouts[i, n:] = PAD
    mask = np.arange(T_ROLL)[None] < lens[:, None]
    inputs, valid = jax_grpo.prepare_rollouts_for_policy_theta(rollouts, mask,
                                                               PAD)
    old_lp = np.where(mask, -rng.uniform(0.1, 3.0, (r, T_ROLL)), 0.0)
    old_lp[:, 0] = 0.0
    latent = rng.standard_normal((R_GROUPS, M_LAT, 64)).astype(np.float32)
    lat_valid = np.arange(M_LAT)[None] < np.array([M_LAT, 6])[:, None]
    gold = [TOK.encode(LMX), TOK.encode("measure clef:G2 C4 voice:1 quarter")]
    g_in, g_tg, g_valid = omr_decoder.batchify_and_split_lmx_seqs(
        gold, PAD, max_len=DEC["max_lmx_seq_len"])
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
    """An optax transformation that passes the gradients on unchanged and
    keeps them as its state: the JAX step's gradients, read back."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like,
                                                               p),
                                        lambda g, s, p=None: (g, g))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in trainer.tree_flatten(
        jax.tree.map(np.asarray, tree)).items()}


def test_update_step_matches_jax(model):
    """One full update with the AdamW of stage 3 (global-norm clipping, here
    at 0.1 so that it acts; frozen encoder and transition head; weight
    decay), the objective chunked with the memory projected per chunk, plus
    the CE anchor: every decoder leaf's gradient, the metrics and the
    parameters after the step against JAX's."""
    jcfg, pcfg, jparams, pparams = model
    jbatch, pbatch = _update_batch(1)
    lr = 1e-3
    jtx = optax.chain(_recorder(), jax_trainer.adamw(
        lr, betas=grpo.ADAMW_BETAS, weight_decay=0.01, max_grad_norm=0.1,
        scale_tree_fn=jax_grpo.grpo_frozen_scales))
    ptx = trainer.adamw(lr, betas=grpo.ADAMW_BETAS, weight_decay=0.01,
                        max_grad_norm=0.1,
                        scale_tree_fn=grpo.grpo_frozen_scales)
    jstep = jax_grpo.make_grpo_update_step(jcfg, jtx, R_GROUPS, 0.2,
                                           jnp.float32, rollout_microbatches=3)
    jstate, jm = jstep(jax_trainer.create_train_state(jparams, jtx), jbatch,
                       jax.random.PRNGKey(0))

    jg = _flat_np(jstate.opt_state[0])
    grads, sums = grpo.make_grpo_grads_fn(pcfg, R_GROUPS, 0.2, torch.float32,
                                          rollout_microbatches=3)(pparams,
                                                                  pbatch)
    pg = trainer.tree_flatten(grads)
    assert pg.keys() == jg.keys()
    for k, g in pg.items():
        if not k.startswith("decoder/"):
            assert not g.any() and not jg[k].any(), k
            continue
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        err = float(np.abs(g.numpy() - jg[k]).max()) / scale
        assert err <= 1e-4, (k, err)

    pstep = grpo.make_grpo_update_step(pcfg, ptx, R_GROUPS, 0.2,
                                       torch.float32, rollout_microbatches=3)
    pstate, pm = pstep(trainer.create_train_state(pparams, ptx), pbatch)
    for k in ("loss", "grpo_objective", "entropy_bonus", "ce_loss",
              "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
    assert float(pm["grad_norm"]) > 0.1  # the clip was taken
    before = trainer.tree_flatten(pparams)
    after_j = _flat_np(jstate.params)
    for k, v in trainer.tree_flatten(pstate.params).items():
        np.testing.assert_allclose(v.numpy(), after_j[k], atol=2 * lr, rtol=0)
        if not k.startswith("decoder/"):
            assert torch.equal(v, before[k]), k
    moved = (pstate.params["decoder"]["unembed"]["kernel"]
             - before["decoder/unembed/kernel"]).abs().max()
    assert float(moved) > 0.5 * lr


def test_cross_group_stack_equals_folded_and_expanded(model):
    """The stack's repeat of the projected rows = the per-layer reference's
    fold of the group into the query axis = the forward over repeated
    latents; the gradient of mem_kv is summed back per group."""
    _, pcfg, _, pparams = model
    _, pbatch = _update_batch(2)
    dec = pparams["decoder"]
    lat = pbatch["img_latent"].clone().requires_grad_(True)
    mem_kv = transformer.precompute_memory_kv(dec["blocks"], lat)
    x = omr_decoder.embed_tokens(dec, pbatch["rollout_inputs"])
    valid = pbatch["rollout_input_valid"]
    out = transformer.decoder_stack(dec["blocks"], x, mem_kv, valid,
                                    pbatch["latent_valid"], 2, cross_group=G)
    causal = torch.tril(torch.ones(x.shape[1], x.shape[1], dtype=torch.bool))
    self_bias = torch.where(valid[:, None, None, :] & causal, 0.0, -1e9)
    ref = transformer.decoder_stack_layers(
        dec["blocks"], x, None, self_bias,
        torch.where(pbatch["latent_valid"], 0.0, -1e9)[:, None, None, :], 2,
        mem_kv, cross_group=G)
    rep = transformer.decoder_stack(
        dec["blocks"], x, mem_kv.repeat_interleave(G, 1), valid,
        pbatch["latent_valid"].repeat_interleave(G, 0), 2)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), rep.detach().numpy(),
                               atol=1e-6)
    g_out, = torch.autograd.grad(out.square().sum(), lat)
    lat2 = pbatch["img_latent"].repeat_interleave(G, 0).requires_grad_(True)
    out2 = transformer.decoder_stack(
        dec["blocks"], x, transformer.precompute_memory_kv(dec["blocks"], lat2),
        valid, pbatch["latent_valid"].repeat_interleave(G, 0), 2)
    g2, = torch.autograd.grad(out2.square().sum(), lat2)
    np.testing.assert_allclose(
        g_out.numpy(), g2.view(R_GROUPS, G, M_LAT, -1).sum(1).numpy(),
        atol=1e-5)


def test_objective_and_entropy_sums_match_jax():
    rng = np.random.default_rng(5)
    r, t, v = 6, 9, 23
    logits = rng.standard_normal((r, t, v)).astype(np.float32) * 2
    rollouts = rng.integers(0, v, (r, t + 1))
    valid = np.arange(t)[None] < np.array([9, 3, 0, 7, 1, 5])[:, None]
    old = -rng.uniform(0.1, 3, (r, t + 1)).astype(np.float32)
    adv = rng.standard_normal(r).astype(np.float32)
    j = [jnp.asarray(a) for a in (logits, rollouts, valid, old, adv)]
    p = [torch.from_numpy(np.array(a)) for a in (logits, rollouts, valid, old,
                                                 adv)]
    pairs = [
        (jax_grpo.calc_grpo_objective(*j, 0.2, 2),
         grpo.calc_grpo_objective(*p, 0.2, 2)),
        (jax_grpo.calc_grpo_objective_sum(*j, 0.2),
         grpo.calc_grpo_objective_sum(*p, 0.2)),
        (jax_grpo.calc_entropy_sum(j[0], j[2]),
         grpo.calc_entropy_sum(p[0], p[2])),
        (jax_grpo.calc_entropy_bonus(j[0], j[2], v),
         grpo.calc_entropy_bonus(p[0], p[2], v))]
    for jv, pv in pairs:
        np.testing.assert_allclose(float(pv), float(jv), rtol=1e-5)


def test_entropy_is_normalised_by_log_vocab():
    """Hazard: uniform logits give an entropy bonus of exactly 1, and the
    summed form divided by rollouts and log(vocab) is the bonus."""
    v = 227
    logits = torch.zeros((3, 5, v))
    valid = torch.ones((3, 5), dtype=torch.bool)
    assert abs(float(grpo.calc_entropy_bonus(logits, valid, v)) - 1.0) < 1e-5
    logits = torch.randn((3, 5, v), generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        float(grpo.calc_entropy_sum(logits, valid) / 3 / np.log(v)),
        float(grpo.calc_entropy_bonus(logits, valid, v)), rtol=1e-6)


def test_group_advantages_bessel_and_single_rollout_groups():
    """Hazard: the Bessel std, and zeros (not NaN) for groups of one."""
    rewards = np.array([[1.0, 2.0, 3.0, 6.0], [0.5, 0.5, 0.5, 0.5]])
    adv = grpo_rewards.group_advantages(rewards)
    np.testing.assert_allclose(adv, jax_rewards.group_advantages(rewards))
    np.testing.assert_allclose(adv[:4], (rewards[0] - 3.0)
                               / (rewards[0].std(ddof=1) + 1e-8))
    single = grpo_rewards.group_advantages(np.array([[3.0], [1.0]]))
    np.testing.assert_array_equal(single, [0.0, 0.0])


def test_rollout_ratio_is_below_one_at_the_first_epoch(model):
    """Hazard: the rollouts' log-probs are the sampler's top-k ones, the
    policy's are over the full vocabulary, so exp(theta - old) <= 1 on
    every sampled token before any update."""
    _, pcfg, _, pparams = model
    rng = np.random.default_rng(6)
    latent = torch.from_numpy(rng.standard_normal((2, M_LAT, 64))
                              .astype(np.float32))
    valid = torch.ones((2, M_LAT), dtype=torch.bool)
    seqs, old_lp, mask = vitomr.forward_rollout_policy(
        pparams, pcfg, latent, valid, torch.Generator().manual_seed(1),
        max_actions=12, top_k=5, temperature=1.1, group_size=2,
        compute_dtype=torch.float32, cache_dtype=torch.float32)
    inputs, in_valid = grpo.prepare_rollouts_for_policy_theta(
        seqs.numpy(), mask.numpy(), PAD)
    logits = omr_decoder.forward(
        pparams["decoder"], pcfg.decoder, torch.from_numpy(inputs).long(),
        latent.repeat_interleave(2, 0), torch.from_numpy(in_valid),
        valid.repeat_interleave(2, 0))
    theta = torch.log_softmax(logits, -1).gather(-1, seqs[:, 1:, None])[..., 0]
    ratio = torch.exp(theta - old_lp[:, 1:])[torch.from_numpy(in_valid)]
    assert float(ratio.max()) <= 1.0 + 1e-4
    assert float(ratio.mean()) < 0.99


@pytest.mark.parametrize("monolith", [True, False])
def test_int8_rollouts_match_jax_at_top_k_one(model, monolith):
    """``RolloutConfig.cache_dtype="int8"``: G = 3 rollouts of 2 images over
    int8 caches, top-k 1 (the sampled token is the argmax, so no random
    stream has to match). JAX's CPU decode takes its per-op step, which
    repeats the latent; the port's takes the monolith step (grouped K6's
    twin, the card's rollout path) or the per-op step. Tokens and masks
    equal, old log-probs within 1e-3 (the int8 tolerance of
    tests/test_torch_port_decode_hd.py)."""
    jcfg, pcfg, jparams, pparams = model
    rng = np.random.default_rng(9)
    latent = rng.standard_normal((R_GROUPS, M_LAT, 64)).astype(np.float32)
    valid = np.arange(M_LAT)[None] < np.array([M_LAT, 6])[:, None]
    rc = grpo_rewards.RolloutConfig(group_size=G, max_actions=24, top_k=1,
                                    temperature=1.1, cache_dtype="int8")
    js, jl, jm = jax_vitomr.forward_rollout_policy(
        jparams, jcfg, jnp.asarray(latent), jnp.asarray(valid),
        jax.random.PRNGKey(0), max_actions=rc.max_actions, top_k=rc.top_k,
        temperature=rc.temperature, group_size=G, compute_dtype=jnp.float32,
        cache_dtype=jnp.int8)
    prev = decode_kernel._ENABLED
    decode_kernel.set_enabled(monolith)
    try:
        ps, pl, pm = vitomr.forward_rollout_policy(
            pparams, pcfg, torch.from_numpy(latent), torch.from_numpy(valid),
            torch.Generator().manual_seed(0), max_actions=rc.max_actions,
            top_k=rc.top_k, temperature=rc.temperature, group_size=G,
            compute_dtype=torch.float32,
            cache_dtype=grpo._rollout_cache_dtype(rc, torch.float32))
    finally:
        decode_kernel.set_enabled(prev)
    assert ps.shape[0] == R_GROUPS * G
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-3, rtol=0)
    # rows of one image are one greedy rollout G times
    np.testing.assert_array_equal(ps.numpy()[0], ps.numpy()[G - 1])


def test_clipping_sees_frozen_zero_gradients_and_scale_zero_stops_decay():
    """Hazard: the global norm counts the frozen leaves' zero gradients, and
    their scale of 0 suppresses weight decay: two steps against optax."""
    rng = np.random.default_rng(7)
    tree = {"encoder": {"w": rng.standard_normal((4, 3))},
            "transition_head": {"w": rng.standard_normal(5)},
            "decoder": {"a": rng.standard_normal((3, 2)),
                        "b": rng.standard_normal(6)}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3)
                          .astype(np.float32), tree) for _ in range(2)]
    for g in grads:
        g["encoder"]["w"][:] = 0.0
        g["transition_head"]["w"][:] = 0.0
    sched = schedules.linear_schedule(1e-2, 1e-3, 4)
    jtx = jax_trainer.adamw(optax.linear_schedule(1e-2, 1e-3, 4),
                            weight_decay=0.1, max_grad_norm=1.0,
                            scale_tree_fn=jax_grpo.grpo_frozen_scales)
    ptx = trainer.adamw(sched, weight_decay=0.1, max_grad_norm=1.0,
                        scale_tree_fn=grpo.grpo_frozen_scales)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jtx.init(jp)
    update = jax.jit(jtx.update)
    state = trainer.create_train_state(
        trainer.tree_map(torch.from_numpy, tree), ptx)
    apply_fn = trainer.make_apply_fn(ptx)
    for g in grads:
        upd, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        state = apply_fn(state, trainer.tree_map(torch.from_numpy, g))
    for k, v in trainer.tree_flatten(state.params).items():
        np.testing.assert_allclose(v.numpy(), _flat_np(jp)[k], atol=1e-6)
    assert torch.equal(state.params["encoder"]["w"],
                       torch.from_numpy(tree["encoder"]["w"]))
    for step in range(6):
        assert abs(sched(step) - float(optax.linear_schedule(
            1e-2, 1e-3, 4)(step))) < 1e-9


def test_reward_components_match_jax():
    """Rewards and every component of ``reward_rollouts`` on rollouts that
    delinearize, fail to, repeat and stop early, scored with TEDn."""
    lines = open("tests/data/lmx_corpus/target_3.txt").read().split()
    target = " ".join(lines[:60])
    xml, _ = delinearize(target)
    ids = TOK.encode(target)
    junk = np.array([TOK.bos_idx] + [TOK.tokens_to_idxs["quarter"]] * 20
                    + [TOK.eos_idx])
    rows = [ids, ids[:30], junk, np.concatenate([ids[:10], ids[1:10],
                                                 [TOK.eos_idx]])]
    t = max(len(r) for r in rows)
    rollouts = np.full((4, t), PAD, np.int32)
    for i, r in enumerate(rows):
        rollouts[i, :len(r)] = r
    mask = rollouts != PAD
    cfg = copy.deepcopy(grpo.INITIAL_REWARD_CONFIG)
    targets = grpo.expand_target_lmx_seqs([ids, ids], 2, PAD)
    np.testing.assert_array_equal(
        targets, jax_grpo.expand_target_lmx_seqs([ids, ids], 2, PAD))
    jr, jc = jax_rewards.reward_rollouts(cfg, rollouts, mask, targets,
                                         [xml, xml], 2, 2,
                                         TOK.idxs_to_tokens, PAD, 2)
    pr, pc = grpo_rewards.reward_rollouts(cfg, rollouts, mask, targets,
                                          [xml, xml], 2, 2,
                                          TOK.idxs_to_tokens, PAD, 2)
    np.testing.assert_allclose(pr, jr, atol=1e-6)
    for k, v in pc.to_dict().items():
        np.testing.assert_allclose(v, jc.to_dict()[k], atol=1e-6)
    assert pc.tedn_scores[0] == 1.0 and len(set(pr.reshape(-1))) == 4


def test_curriculum_and_host_glue_match_jax():
    jcfg = jax_rewards.GRPOConfig(
        copy.deepcopy(jax_grpo.INITIAL_ROLLOUT_CONFIG),
        copy.deepcopy(jax_grpo.INITIAL_REWARD_CONFIG),
        copy.deepcopy(jax_grpo.INITIAL_LOSS_CONFIG),
        copy.deepcopy(jax_grpo.INITIAL_UPDATE_CONFIG), 100, 100)
    pcfg = grpo.default_grpo_config()
    js = jax_grpo.CurriculumScheduler(jcfg, 3, 20)
    ps = grpo.CurriculumScheduler(pcfg, 3, 20)
    for _ in range(25):
        js.step()
        ps.step()
        assert dataclasses_equal(jcfg.rollout_config, pcfg.rollout_config)
        assert dataclasses_equal(jcfg.loss_config, pcfg.loss_config)
    rollouts = np.array([[0, 5, 6, 2, PAD], [0, 7, 2, PAD, PAD]])
    mask = rollouts != PAD
    for a, b in zip(grpo.prepare_rollouts_for_policy_theta(rollouts, mask, PAD),
                    jax_grpo.prepare_rollouts_for_policy_theta(rollouts, mask,
                                                               PAD)):
        np.testing.assert_array_equal(a, b)


def dataclasses_equal(a, b) -> bool:
    return vars(a) == vars(b)


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    lmx = [LMX, "measure clef:G2 C4 voice:1 quarter",
           "measure time beats:3 beat-type:4 clef:F4 E3 voice:1 half"]
    out = []
    for i in range(n):
        s = lmx[i % 3]
        out.append((rng.random((1, 48, 64 + 16 * (i % 2)), dtype=np.float32),
                    TOK.encode(s), delinearize(s)[0]))
    return out


def _tiny_grpo_config():
    return grpo_rewards.GRPOConfig(
        rollout_config=grpo_rewards.RolloutConfig(group_size=2, max_actions=16,
                                                  top_k=5, temperature=1.1),
        reward_config=copy.deepcopy(grpo.INITIAL_REWARD_CONFIG),
        loss_config=copy.deepcopy(grpo.INITIAL_LOSS_CONFIG),
        update_config=grpo_rewards.UpdateConfig(epsilon=0.2, update_epochs=2,
                                                max_grad_norm=1.0),
        mini_validation_freq=2, checkpoint_freq=1)


def test_grpo_update_encode_ahead_is_exact(model):
    _, pcfg, _, pparams = model
    cfg, params = grpo.set_up_grpo(pcfg, pparams)
    assert cfg.encoder.fine_tune_depth == 0 and cfg.decoder.dropout == 0.0
    ex = _examples(4)
    tx = trainer.adamw(1e-4, weight_decay=0.0, max_grad_norm=1.0,
                       scale_tree_fn=grpo.grpo_frozen_scales)
    step = grpo.make_grpo_update_step(cfg, tx, 2, 0.2, torch.float32)
    runs = []
    for pre in (False, True):
        state = trainer.create_train_state(params, tx)
        preencoded = None
        if pre:
            preencoded = grpo._encode_examples(state.params, cfg, ex[:2],
                                               torch.float32, "cpu")
        state, m = grpo.grpo_update(
            state.params, state, step, cfg, _tiny_grpo_config(), ex[:2], TOK,
            torch.Generator().manual_seed(3), compute_dtype=torch.float32,
            reward_workers=2, next_examples=ex[2:], preencoded=preencoded,
            device="cpu")
        runs.append((state, m))
        lat, val = m["preencoded_next"]
        fresh = grpo._encode_examples(params, cfg, ex[2:], torch.float32,
                                      "cpu")
        assert torch.equal(lat, fresh[0]) and torch.equal(val, fresh[1])
    (s0, m0), (s1, m1) = runs
    assert m0["loss"] == m1["loss"] and m0["reward"] == m1["reward"]
    for k, v in trainer.tree_flatten(s0.params).items():
        assert torch.equal(v, trainer.tree_flatten(s1.params)[k]), k
    assert set(m0["phase_times"]) == {"rollout", "reward", "host_glue",
                                      "update"}
    assert np.isfinite(m0["loss"]) and np.isfinite(m0["reward"])


class _FailingAfter:
    """A dataset whose items raise after ``n`` reads."""

    def __init__(self, items, n):
        self.items, self.n, self.reads = items, n, 0

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        self.reads += 1
        if self.reads > self.n:
            raise RuntimeError("unreadable example")
        return self.items[i]


def test_grpo_train_on_cpu_writes_checkpoints_and_stats(model, tmp_path):
    _, pcfg, _, pparams = model
    cfg, params = grpo.set_up_grpo(pcfg, pparams)
    hooks = []
    out, stats = grpo.grpo_train(
        cfg, params, _examples(4), TOK, grpo_config=_tiny_grpo_config(),
        batch_size=2, lr=1e-4, model_dir=tmp_path / "grpo", seed=0,
        compute_dtype=torch.float32, reward_workers=2, exploration_steps=1,
        val_dataset=_examples(2, seed=1), mini_validation_size=2,
        device="cpu", step_hook=lambda kind, info: hooks.append(kind))
    assert hooks == ["step", "step", "val"] and len(stats) == 2
    assert "mini_val" in stats[1] and np.isfinite(stats[1]["mini_val"]["reward"])
    files = sorted(str(f.relative_to(tmp_path))
                   for f in tmp_path.rglob("*") if f.is_file())
    assert files == ["grpo/checkpoints/step_1.npz",
                     "grpo/checkpoints/step_2.npz", "grpo/grpo_vitomr.npz",
                     "grpo/stats.csv"]
    tags = {row["tag"] for row in csv.DictReader(open(tmp_path / "grpo"
                                                      / "stats.csv"))}
    assert {"train/loss", "train/reward", "mini_val/reward"} <= tags
    assert torch.equal(out["encoder"]["projection"]["kernel"],
                       params["encoder"]["projection"]["kernel"])
    assert not torch.equal(out["decoder"]["unembed"]["kernel"],
                           params["decoder"]["unembed"]["kernel"])

    with pytest.raises(RuntimeError, match="unreadable"):
        grpo.grpo_train(cfg, params, _FailingAfter(_examples(6), 4), TOK,
                        grpo_config=_tiny_grpo_config(), batch_size=2,
                        model_dir=tmp_path / "crash",
                        compute_dtype=torch.float32, reward_workers=2,
                        device="cpu")
    assert (tmp_path / "crash" / "checkpoints" / "emergency.npz").exists()


def test_batch_policy_inference_runs_one_rollout_per_image(model):
    _, pcfg, _, pparams = model
    imgs = [e[0] for e in _examples(3)]
    seqs, lps, mask = vitomr.batch_policy_inference(
        pparams, pcfg, imgs, torch.Generator().manual_seed(0), max_actions=10,
        top_k=4, compute_dtype=torch.float32, device="cpu")
    assert seqs.shape[0] == 3 and bool((seqs[:, 0] == TOK.bos_idx).all())
    assert bool((lps[mask[:, :] & (torch.arange(seqs.shape[1]) > 0)] <= 0).all())
