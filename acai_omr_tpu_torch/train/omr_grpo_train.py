"""GRPO fine-tuning (stage 3 of 3).

The twin of the JAX package's ``train/omr_grpo_train.py`` on one card:
group-relative policy optimization over KV-cached sampled rollouts with the
composite LMX reward (:mod:`.grpo_rewards`), a PPO-style clipped objective,
an entropy bonus and a teacher-forced CE anchor, a curriculum over the
rollout and loss hyperparameters, the encoder and transition head frozen.

* The "old policy" is the parameters as they stand when a batch's rollouts
  are drawn; the updates that follow change them in place.
* Rollouts run the decode loop of :mod:`..models.decode` with G rollouts per
  image over the unexpanded memory (``mem_group``); rewards run on the host
  (native TEDn on a thread pool). The next batch's encoder pass is enqueued
  right after this batch's rollouts land, so the card encodes batch N+1
  while the host scores batch N (exact: the encoder is frozen).
* The update sums the objective's gradients over ``rollout_microbatches``
  chunks of rollouts; each chunk projects its images' cross K/V once inside
  the differentiated loss, and the decoder stack repeats the projected rows
  per rollout (``cross_group``). Then the CE anchor's gradient on the
  unexpanded latents, then one AdamW step with global-norm clipping.

On a CUDA device the decoder stack runs the hand-written kernels forward and
backward; with ``device="cpu"`` their plain twins run under autograd. Run as

    python -m acai_omr_tpu_torch.train.omr_grpo_train [--device cpu]

once the GrandStaff-LMX and OLiMPiC datasets (with their MusicXML) and a
stage-2 checkpoint are present (none is in the repository).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.tokenizer import LmxTokenizer
from ..models import omr_decoder, vit_encoder
from ..models import vitomr as vitomr_lib
from ..models.vitomr import ViTOMRConfig
from ..ops import transformer
from ..parallel import trainer
from ..utils import checkpoint as ckpt_lib
from ..utils.metrics import MetricsWriter
from .grpo_rewards import (GRPOConfig, LossConfig, RewardConfig,
                           RolloutConfig, UpdateConfig, group_advantages,
                           reward_rollouts)
from .schedules import linear_schedule

MODEL_DIR_PATH = Path("grpo_omr_train")
TF_CHECKPOINT_PATH = "tf_omr_train/vitomr"

TRAIN_BATCH_SIZE = 16
MINI_VALIDATION_SIZE = 1000
LR = 1e-6
ADAMW_BETAS = (0.9, 0.95)
ADAMW_WEIGHT_DECAY = 0.0
EPOCHS = 1
LR_END_FACTOR = 0.1
EXPLORATION_STEPS = 30
MAX_MAX_ACTIONS = 1536
MIN_TOP_K = 10
MIN_TEMPERATURE = 0.6
MIN_ENTROPY_BETA = 0.0
MIN_LAMBDA_CE = 0.01

INITIAL_ROLLOUT_CONFIG = RolloutConfig(group_size=8, max_actions=768,
                                       top_k=50, temperature=1.1)
INITIAL_REWARD_CONFIG = RewardConfig(
    lambda_tedn=7, lambda_well_formed=1.5, lambda_f1=2.5, lambda_repeat=2,
    lambda_len=2, alpha_tedn=0.01, alpha_well_formed=0.25, gamma=3, delta=5,
    tau=50)
INITIAL_LOSS_CONFIG = LossConfig(entropy_beta=0.05, lambda_ce=0.1)
INITIAL_UPDATE_CONFIG = UpdateConfig(epsilon=0.2, update_epochs=2,
                                     max_grad_norm=1.0)


def default_grpo_config() -> GRPOConfig:
    """A fresh copy of the initial configuration (the curriculum edits it)."""
    return GRPOConfig(
        rollout_config=copy.deepcopy(INITIAL_ROLLOUT_CONFIG),
        reward_config=copy.deepcopy(INITIAL_REWARD_CONFIG),
        loss_config=copy.deepcopy(INITIAL_LOSS_CONFIG),
        update_config=copy.deepcopy(INITIAL_UPDATE_CONFIG),
        mini_validation_freq=100, checkpoint_freq=100)


class CurriculumScheduler:
    """Anneals the rollout length up and top-k / temperature / entropy / CE
    down after an exploration phase. max_actions, top_k and temperature move
    in STATIC_LEVELS discrete levels, as in the JAX package (where each value
    is a compiled shape); entropy_beta and lambda_ce anneal continuously.
    Steps past the horizon hold the final values."""

    STATIC_LEVELS = 8

    def __init__(self, grpo_config: GRPOConfig, exploration_steps: int,
                 total_steps: int, max_max_actions=MAX_MAX_ACTIONS,
                 min_top_k=MIN_TOP_K, min_temperature=MIN_TEMPERATURE,
                 min_beta=MIN_ENTROPY_BETA, min_lambda_ce=MIN_LAMBDA_CE):
        self.cfg = grpo_config
        self.step_count = 0
        self.exploration_steps = exploration_steps
        self.anneal_steps = max(total_steps - exploration_steps, 1)
        rc, lc = grpo_config.rollout_config, grpo_config.loss_config
        self.init = (rc.max_actions, rc.top_k, rc.temperature,
                     lc.entropy_beta, lc.lambda_ce)
        self.bounds = (max_max_actions, min_top_k, min_temperature, min_beta,
                       min_lambda_ce)

    def step(self):
        if self.step_count < self.exploration_steps:
            self.step_count += 1
            return
        p = min((self.step_count - self.exploration_steps) / self.anneal_steps,
                1.0)
        pq = min(int(p * self.STATIC_LEVELS),
                 self.STATIC_LEVELS) / self.STATIC_LEVELS
        i, b = self.init, self.bounds
        rc, lc = self.cfg.rollout_config, self.cfg.loss_config
        rc.max_actions = int(i[0] + pq * (b[0] - i[0]))
        rc.top_k = int(i[1] - pq * (i[1] - b[1]))
        rc.temperature = i[2] - pq * (i[2] - b[2])
        lc.entropy_beta = i[3] - p * (i[3] - b[3])
        lc.lambda_ce = i[4] - p * (i[4] - b[4])
        self.step_count += 1


def expand_target_lmx_seqs(target_lmx_seqs, group_size, pad_idx):
    """Ragged target id sequences -> (B * G, T) padded array, each target
    repeated for its group."""
    tmax = max(len(s) for s in target_lmx_seqs)
    out = np.full((len(target_lmx_seqs), tmax), pad_idx, dtype=np.int32)
    for i, s in enumerate(target_lmx_seqs):
        out[i, :len(s)] = s
    return np.repeat(out, group_size, axis=0)


def prepare_rollouts_for_policy_theta(rollouts: np.ndarray,
                                      rollout_mask: np.ndarray, pad_idx: int):
    """Right-shift rollouts and their validity for the teacher-forced pass.
    Returns (inputs, input_valid)."""
    shifted_lens = rollout_mask.sum(-1, keepdims=True) - 1
    input_valid = np.arange(rollouts.shape[1] - 1)[None, :] < shifted_lens
    inputs = rollouts[:, :-1].copy()
    inputs[~input_valid] = pad_idx
    return inputs, input_valid


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def _clipped_per_rollout(theta_logits, rollouts, input_valid, old_log_probs,
                         advantages, epsilon):
    """Per-rollout mean over the predicted positions of the clipped PPO
    term. ``theta`` log-probs are over the full vocabulary; the rollouts'
    ``old_log_probs`` are the sampler's top-k ones, so the ratio sits below
    1 at the first update epoch."""
    theta_lp = torch.log_softmax(theta_logits.float(), dim=-1)
    theta_lp = theta_lp.gather(-1, rollouts[:, 1:, None].long())[..., 0]
    ratios = torch.exp(theta_lp - old_log_probs[:, 1:])
    adv = advantages[:, None]
    obj = torch.minimum(ratios * adv,
                        ratios.clamp(1 - epsilon, 1 + epsilon) * adv)
    obj = torch.where(input_valid, obj, 0.0)
    lens = input_valid.sum(-1).clamp_min(1)
    return obj.sum(-1) / lens


def calc_grpo_objective(theta_logits, rollouts, input_valid, old_log_probs,
                        advantages, epsilon, num_groups):
    """Clipped objective summed over rollouts and divided by the number of
    groups. ``input_valid`` is True where a prediction is made."""
    return _clipped_per_rollout(theta_logits, rollouts, input_valid,
                                old_log_probs, advantages,
                                epsilon).sum() / num_groups


def calc_grpo_objective_sum(theta_logits, rollouts, input_valid,
                            old_log_probs, advantages, epsilon):
    """The sum over rollouts of the per-rollout objective (the caller divides
    by the number of groups): the form that splits over rollout chunks."""
    return _clipped_per_rollout(theta_logits, rollouts, input_valid,
                                old_log_probs, advantages, epsilon).sum()


def _entropy_per_rollout(theta_logits, input_valid):
    lp = torch.log_softmax(theta_logits.float(), dim=-1)
    ent = torch.where(input_valid, -(lp.exp() * lp).sum(-1), 0.0)
    return ent.sum(-1) / input_valid.sum(-1).clamp_min(1)


def calc_entropy_bonus(theta_logits, input_valid, vocab_size):
    """Mean per-rollout policy entropy normalised by log(vocab) to [0, 1]."""
    return _entropy_per_rollout(theta_logits, input_valid).mean() \
        / math.log(vocab_size)


def calc_entropy_sum(theta_logits, input_valid):
    """Sum over rollouts of the per-rollout mean entropy (not normalised)."""
    return _entropy_per_rollout(theta_logits, input_valid).sum()


ROLLOUT_KEYS = ("rollouts", "rollout_inputs", "rollout_input_valid",
                "old_log_probs", "advantages", "img_latent", "latent_valid")


def make_grpo_grads_fn(cfg: ViTOMRConfig, num_groups: int, epsilon: float,
                       compute_dtype=torch.bfloat16,
                       rollout_microbatches: int = 16):
    """``grads_fn(params, batch) -> (grads, sums)``: the gradient tree of one
    GRPO update (before clipping) and the scalar tensors ``grpo_objective``,
    ``entropy_bonus`` and ``ce_loss`` (:func:`make_grpo_update_step`)."""
    vocab_size = cfg.decoder.vocab_size
    cd = compute_dtype

    def rollout_loss(params, mb, total_rollouts, entropy_beta):
        cg = mb["rollout_inputs"].shape[0] // mb["img_latent"].shape[0]
        mem_kv = transformer.precompute_memory_kv(
            params["decoder"]["blocks"], mb["img_latent"].to(cd))
        theta_logits = omr_decoder.forward(
            params["decoder"], cfg.decoder, mb["rollout_inputs"],
            mb["img_latent"], mb["rollout_input_valid"], mb["latent_valid"],
            compute_dtype=cd, deterministic=True, mem_kv=mem_kv,
            cross_group=cg)
        obj = calc_grpo_objective_sum(
            theta_logits, mb["rollouts"], mb["rollout_input_valid"],
            mb["old_log_probs"], mb["advantages"], epsilon) / num_groups
        ent = calc_entropy_sum(theta_logits, mb["rollout_input_valid"]) \
            / total_rollouts / math.log(vocab_size)
        return -(obj + entropy_beta * ent), obj, ent

    def ce_loss_sum(params, batch):
        latent = batch["unexpanded_img_latent"]
        mem_kv = transformer.precompute_memory_kv(
            params["decoder"]["blocks"], latent.to(cd))
        gold_logits = omr_decoder.forward(
            params["decoder"], cfg.decoder, batch["gold_inputs"], latent,
            batch["gold_input_valid"], batch["unexpanded_latent_valid"],
            compute_dtype=cd, deterministic=True, mem_kv=mem_kv)
        return vitomr_lib.omr_ce_loss(gold_logits, batch["gold_targets"],
                                      cfg.decoder.pad_idx, reduction="sum")

    def grad_of(loss, leaves):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return [torch.zeros_like(v) if g is None else g
                for v, g in zip(leaves.values(), grads)]

    def grads_fn(params: dict, batch: dict):
        flat = trainer.tree_flatten(params)
        leaves = {p: v.detach().requires_grad_(True) for p, v in flat.items()
                  if p.split("/")[0] == "decoder"}
        params = trainer.tree_unflatten({**flat, **leaves})
        r = batch["rollouts"].shape[0]
        b_mem = batch["img_latent"].shape[0]
        if r % b_mem:
            raise ValueError(f"rollout rows {r} not a multiple of memory rows "
                             f"{b_mem}")
        m = max(rollout_microbatches, 1)
        while m > 1 and (r % m or b_mem % m):
            m -= 1
        acc = [torch.zeros_like(v, dtype=torch.float32)
               for v in leaves.values()]
        obj = ent = torch.zeros((), device=batch["rollouts"].device)
        for j in range(m):
            mb = {k: batch[k].chunk(m)[j] for k in ROLLOUT_KEYS}
            loss, o, e = rollout_loss(params, mb, float(r),
                                      batch["entropy_beta"])
            torch._foreach_add_(acc, grad_of(loss, leaves))
            obj, ent = obj + o.detach(), ent + e.detach()
        ce = torch.zeros_like(obj)
        if "gold_inputs" in batch:
            ce_s, ce_n = ce_loss_sum(params, batch)
            n = ce_n.clamp_min(1.0)
            torch._foreach_add_(acc, [g * batch["lambda_ce"] / n
                                      for g in grad_of(ce_s, leaves)])
            ce = ce_s.detach() / n
        grads = {p: torch.zeros_like(v, dtype=torch.float32)
                 for p, v in flat.items()}
        grads.update(zip(leaves, acc))
        return trainer.tree_unflatten(grads), {
            "grpo_objective": obj, "entropy_bonus": ent, "ce_loss": ce}

    return grads_fn


def make_grpo_update_step(cfg: ViTOMRConfig, tx: trainer.AdamW,
                          num_groups: int, epsilon: float,
                          compute_dtype=torch.bfloat16,
                          rollout_microbatches: int = 16):
    """``step(state, batch) -> (state, metrics)``: one GRPO update.

    The objective's gradients are summed over ``m`` chunks of rollouts, ``m``
    the largest count <= ``rollout_microbatches`` that divides both the
    rollout rows and the memory rows. ``batch["img_latent"]`` /
    ``latent_valid`` hold the unexpanded latents (the G rollouts of one image
    contiguous, G = rollout rows / memory rows): each chunk projects its
    images' cross K/V inside the differentiated loss, so the cross K/V
    weights train under the objective, and the decoder stack repeats the
    projected rows per rollout. Then the CE anchor on the unexpanded latents
    (``gold_*`` keys) adds ``lambda_ce * grad(CE sum) / tokens``, and one
    optimizer step runs. Only the decoder's leaves are differentiated (the
    latents are inputs: every other gradient is zero). ``metrics``: loss,
    objective, entropy bonus, CE and the gradient norm before clipping, as
    scalar tensors left on the device."""
    grads_fn = make_grpo_grads_fn(cfg, num_groups, epsilon, compute_dtype,
                                  rollout_microbatches)
    apply_fn = trainer.make_apply_fn(tx)

    def step(state: trainer.TrainState, batch: dict):
        grads, sums = grads_fn(state.params, batch)
        obj, ent, ce = (sums[k] for k in ("grpo_objective", "entropy_bonus",
                                          "ce_loss"))
        metrics = {"loss": -(obj + batch["entropy_beta"] * ent
                             - batch["lambda_ce"] * ce),
                   **sums, "grad_norm": trainer.global_norm(grads)}
        return apply_fn(state, grads), metrics

    return step


# ---------------------------------------------------------------------------
# outer update per minibatch
# ---------------------------------------------------------------------------

@torch.no_grad()
def _encode_examples(params, cfg: ViTOMRConfig, batch_examples, compute_dtype,
                     device):
    """Batchify and enqueue the (frozen) encoder for a batch of examples;
    the card runs it while the host goes on."""
    pb = vit_encoder.batchify([ex[0] for ex in batch_examples], cfg.encoder)
    return vitomr_lib.encode_image(params, cfg, *pb.to(device),
                                   compute_dtype=compute_dtype)


def _rollout_cache_dtype(rc: RolloutConfig, compute_dtype):
    return torch.int8 if rc.cache_dtype == "int8" else compute_dtype


def grpo_update(old_params, state, update_step, cfg: ViTOMRConfig,
                grpo_config: GRPOConfig, batch_examples, tokenizer,
                generator: torch.Generator, writer: MetricsWriter | None = None,
                step_idx: int = 0, compute_dtype=torch.bfloat16,
                reward_workers: int = 16, next_examples=None,
                preencoded=None, device=None):
    """One outer GRPO step on a list of (img, lmx ids, musicxml) examples.
    Returns (state, metrics).

    Rollouts are drawn with ``old_params`` (the parameters before this
    step's updates; the updates then change ``state.params`` in place) and
    Gumbel noise from ``generator``. ``next_examples``: the next batch,
    whose encoder pass is enqueued right after the rollouts land, so that it
    overlaps the reward scoring on the host (exact: the encoder is frozen).
    It comes back as ``metrics["preencoded_next"]``; pass it to the next call
    as ``preencoded``. ``metrics["phase_times"]``: seconds of rollout,
    reward, host glue and update, split where the host already waits for the
    card."""
    device = resolve_device(device)
    rc, rwc, lc, uc = grpo_config.get_configs()
    pad_idx = cfg.decoder.pad_idx
    target_seqs = [np.asarray(ex[1], np.int32) for ex in batch_examples]
    target_xml = [ex[2] for ex in batch_examples]
    num_groups = len(batch_examples)
    g = rc.group_size
    t_start = time.perf_counter()

    if preencoded is not None:
        unexp_latent, unexp_valid = preencoded
    else:
        unexp_latent, unexp_valid = _encode_examples(
            old_params, cfg, batch_examples, compute_dtype, device)
    with torch.no_grad():
        rollouts, old_lp, rollout_mask = vitomr_lib.forward_rollout_policy(
            old_params, cfg, unexp_latent, unexp_valid, generator,
            max_actions=rc.max_actions, top_k=rc.top_k,
            temperature=rc.temperature, group_size=g,
            compute_dtype=compute_dtype,
            cache_dtype=_rollout_cache_dtype(rc, compute_dtype))
    rollouts, old_lp, rollout_mask = (a.cpu().numpy() for a in
                                      (rollouts, old_lp, rollout_mask))
    t_rollout = time.perf_counter()  # the copies to the host waited

    preencoded_next = None
    if next_examples is not None:
        preencoded_next = _encode_examples(old_params, cfg, next_examples,
                                           compute_dtype, device)

    target_lmx = expand_target_lmx_seqs(target_seqs, g, pad_idx)
    raw_rewards, components = reward_rollouts(
        rwc, rollouts, rollout_mask, target_lmx, target_xml, num_groups, g,
        tokenizer.idxs_to_tokens, pad_idx, reward_workers)
    advantages = group_advantages(raw_rewards)
    if uc.shuffle_advantages:
        advantages = np.random.default_rng(12345).permutation(advantages)
    t_reward = time.perf_counter()

    rollout_inputs, input_valid = prepare_rollouts_for_policy_theta(
        rollouts, rollout_mask, pad_idx)
    # the update's width: a multiple of 128 (few distinct shapes), at most
    # max_actions rounded up and the decoder's budget; padding positions are
    # not valid and add nothing to the objective
    tb = min(-(-rollout_inputs.shape[1] // 128) * 128,
             -(-rc.max_actions // 128) * 128, cfg.decoder.max_lmx_seq_len - 1)
    if tb > rollout_inputs.shape[1]:
        dt = tb - rollout_inputs.shape[1]
        rollout_inputs = np.pad(rollout_inputs, ((0, 0), (0, dt)),
                                constant_values=pad_idx)
        input_valid = np.pad(input_valid, ((0, 0), (0, dt)))
        rollouts = np.pad(rollouts, ((0, 0), (0, tb + 1 - rollouts.shape[1])),
                          constant_values=pad_idx)
        old_lp = np.pad(old_lp, ((0, 0), (0, tb + 1 - old_lp.shape[1])))

    on = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype).to(device)
    batch = {
        "rollouts": on(rollouts, torch.long),
        "rollout_inputs": on(rollout_inputs, torch.long),
        "rollout_input_valid": on(input_valid),
        "old_log_probs": on(old_lp, torch.float32),
        "advantages": on(advantages, torch.float32),
        "img_latent": unexp_latent, "latent_valid": unexp_valid,
        "entropy_beta": float(lc.entropy_beta),
        "lambda_ce": float(lc.lambda_ce),
    }
    if lc.lambda_ce:
        gold_inputs, gold_targets, gold_valid = \
            omr_decoder.batchify_and_split_lmx_seqs(
                target_seqs, pad_idx, max_len=cfg.decoder.max_lmx_seq_len)
        batch.update(gold_inputs=on(gold_inputs, torch.long),
                     gold_targets=on(gold_targets, torch.long),
                     gold_input_valid=on(gold_valid),
                     unexpanded_img_latent=unexp_latent,
                     unexpanded_latent_valid=unexp_valid)

    t_glue = time.perf_counter()
    loss_acc = ce_acc = 0.0
    for _ in range(uc.update_epochs):
        state, metrics = update_step(state, batch)
        loss_acc = loss_acc + metrics["loss"]
        ce_acc = ce_acc + metrics["ce_loss"]
    total_loss, total_ce = (float(v) for v in
                            torch.stack([loss_acc, ce_acc]).cpu())
    t_update = time.perf_counter()
    avg_reward = float(raw_rewards.mean())
    out = {
        "loss": total_loss / uc.update_epochs,
        "ce_loss": total_ce / uc.update_epochs,
        "reward": avg_reward,
        "reward_components": components.avg_over_rollouts(),
        "rollout_tokens": int(rollout_mask.sum()) - len(rollout_mask),
        "update_width": int(rollout_inputs.shape[1]),
        "phase_times": {"rollout": t_rollout - t_start,
                        "reward": t_reward - t_rollout,
                        "host_glue": t_glue - t_reward,
                        "update": t_update - t_glue},
        "preencoded_next": preencoded_next,
    }
    if writer is not None:
        writer.scalar("train/loss", out["loss"], step_idx)
        writer.scalar("train/reward", avg_reward, step_idx)
        writer.scalars("train/reward/components",
                       out["reward_components"].to_dict(), step_idx)
    return state, out


def set_up_grpo(cfg_tf: ViTOMRConfig, tf_params) -> tuple[ViTOMRConfig, dict]:
    """Stage-2 -> stage-3 hand-off: the same parameters; the encoder's
    fine-tune split dissolved (the whole encoder frozen) and every dropout
    zeroed."""
    enc = dataclasses.replace(cfg_tf.encoder, dropout=0.0, fine_tune_depth=0)
    dec = dataclasses.replace(cfg_tf.decoder, dropout=0.0)
    return ViTOMRConfig(encoder=enc, decoder=dec,
                        transition_head_dim=cfg_tf.transition_head_dim,
                        transition_head_dropout=0.0), tf_params


def grpo_frozen_scales(params) -> dict:
    """Scale tree: the decoder trains (1), the encoder and the transition
    head are frozen (0: no update, no weight decay)."""
    return trainer.tree_unflatten({
        p: 1.0 if p.split("/")[0] == "decoder" else 0.0
        for p in trainer.tree_flatten(params)})


@torch.no_grad()
def mini_validate(state_params, cfg: ViTOMRConfig, grpo_config: GRPOConfig,
                  dataset, tokenizer, generator: torch.Generator,
                  batch_size: int = 32, max_examples: int = 128,
                  compute_dtype=torch.bfloat16, reward_workers: int = 16,
                  device=None):
    """Mean raw reward and teacher-forced CE over the first
    ``max_examples`` of ``dataset``: one rollout per example, examples
    weighted alike."""
    device = resolve_device(device)
    rc, rwc, _, _ = grpo_config.get_configs()
    pad_idx = cfg.decoder.pad_idx
    total_reward = total_ce = 0.0
    n = 0
    comp_sum = None
    stop = min(len(dataset), max_examples)
    for i in range(0, stop, batch_size):
        batch = [dataset[j] for j in range(i, min(i + batch_size, stop))]
        seqs = [np.asarray(ex[1], np.int32) for ex in batch]
        latent, valid = _encode_examples(state_params, cfg, batch,
                                         compute_dtype, device)
        rollouts, _, mask = vitomr_lib.forward_rollout_policy(
            state_params, cfg, latent, valid, generator,
            max_actions=rc.max_actions, top_k=rc.top_k,
            temperature=rc.temperature, compute_dtype=compute_dtype,
            cache_dtype=_rollout_cache_dtype(rc, compute_dtype))
        rewards, comps = reward_rollouts(
            rwc, rollouts.cpu().numpy(), mask.cpu().numpy(),
            expand_target_lmx_seqs(seqs, 1, pad_idx), [ex[2] for ex in batch],
            len(batch), 1, tokenizer.idxs_to_tokens, pad_idx, reward_workers)
        gold_inputs, gold_targets, gold_valid = \
            omr_decoder.batchify_and_split_lmx_seqs(
                seqs, pad_idx, max_len=cfg.decoder.max_lmx_seq_len)
        on = lambda a: torch.as_tensor(a).to(device)
        logits = omr_decoder.forward(
            state_params["decoder"], cfg.decoder, on(gold_inputs).long(),
            latent, on(gold_valid), valid, compute_dtype=compute_dtype)
        ce = float(vitomr_lib.omr_ce_loss(logits, on(gold_targets), pad_idx))
        total_reward += float(rewards.mean()) * len(batch)
        total_ce += ce * len(batch)
        n += len(batch)
        avg = comps.avg_over_rollouts() * len(batch)
        comp_sum = avg if comp_sum is None else comp_sum + avg
    return {"reward": total_reward / max(n, 1), "ce_loss": total_ce / max(n, 1),
            "components": None if comp_sum is None else comp_sum / max(n, 1)}


def build_datasets():
    """The stage-3 dataset mix, items carrying their MusicXML for TEDn:
    GrandStaff (camera-augmented distorted variants with probability 0.3) and
    synthetic OLiMPiC for training, OLiMPiC's dev split for validation.
    Returns (tokenizer, train, val)."""
    from ..config import (GRAND_STAFF_ROOT_DIR, LMX_VOCAB_PATH,
                          OLIMPIC_SYNTHETIC_ROOT_DIR, OMR_MAX_IMG_SEQ_LEN,
                          PATCH_SIZE, PE_MAX_HEIGHT, PE_MAX_WIDTH)
    from ..data import datasets as ds_lib
    from ..data import transforms as tf_lib

    tokenizer = LmxTokenizer(LMX_VOCAB_PATH)
    base = tf_lib.Compose([
        tf_lib.to_float_chw,
        tf_lib.DynamicResize(PATCH_SIZE, OMR_MAX_IMG_SEQ_LEN, PE_MAX_HEIGHT,
                             PE_MAX_WIDTH, crop_imgs=False)])
    olimpic = lambda split: ds_lib.OlimpicDataset(
        OLIMPIC_SYNTHETIC_ROOT_DIR, split, img_transform=base,
        lmx_transform=tokenizer.encode, include_musicxml=True)
    grand_staff = ds_lib.GrandStaffLMXDataset(
        GRAND_STAFF_ROOT_DIR, "samples.train.txt", img_transform=base,
        lmx_transform=tokenizer.encode, include_musicxml=True)
    train = ds_lib.ConcatDataset([
        ds_lib.GrandStaffOMRTrainWrapper(
            grand_staff, 0.3, transform=tf_lib.default_camera_augment(1.0)),
        olimpic("samples.train.txt")])
    return tokenizer, train, olimpic("samples.dev.txt")


def grpo_train(cfg: ViTOMRConfig, params, dataset, tokenizer: LmxTokenizer, *,
               grpo_config: GRPOConfig | None = None, epochs: int = EPOCHS,
               batch_size: int = TRAIN_BATCH_SIZE, lr: float = LR,
               model_dir: Path = MODEL_DIR_PATH, seed: int = 0,
               compute_dtype=torch.bfloat16, reward_workers: int = 16,
               exploration_steps: int = EXPLORATION_STEPS, val_dataset=None,
               mini_validation_size: int = MINI_VALIDATION_SIZE,
               rollout_microbatches: int = 16, device=None, step_hook=None):
    """The outer GRPO loop; returns (params, stats).

    Dataset items: (img (C, H, W) float array, lmx token ids, musicxml str).
    Per batch: rollouts with the parameters as they stand, rewards,
    ``update_epochs`` updates (:func:`grpo_update`), the curriculum step,
    checkpoints every ``checkpoint_freq`` steps and a mini-validation every
    ``mini_validation_freq`` (with ``val_dataset``); ``stats.csv`` in
    ``model_dir``; an emergency checkpoint if the loop fails. Runs on
    ``cuda`` unless ``device="cpu"``. ``step_hook(kind, info)`` is called
    after every outer step (``"step"``) and mini-validation (``"val"``).
    """
    device = resolve_device(device)
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=False)
    (model_dir / "checkpoints").mkdir()
    grpo_config = grpo_config or default_grpo_config()
    uc = grpo_config.update_config

    n = len(dataset)
    total_steps = epochs * max(n // batch_size, 1)
    tx = trainer.adamw(
        linear_schedule(lr, lr * LR_END_FACTOR, total_steps * uc.update_epochs),
        betas=ADAMW_BETAS, weight_decay=ADAMW_WEIGHT_DECAY,
        max_grad_norm=uc.max_grad_norm, scale_tree_fn=grpo_frozen_scales)
    state = trainer.create_train_state(
        trainer.tree_map(lambda v: torch.as_tensor(v).to(device), params), tx)
    update_step = make_grpo_update_step(cfg, tx, batch_size, uc.epsilon,
                                        compute_dtype, rollout_microbatches)

    # rollouts wider than the decoder's budget could not be scored
    rc0 = grpo_config.rollout_config
    budget = cfg.decoder.max_lmx_seq_len - 1
    if rc0.max_actions > budget:
        print(f"[grpo] clamping rollout max_actions {rc0.max_actions} -> "
              f"{budget} (decoder budget)")
        rc0.max_actions = budget
    curriculum = CurriculumScheduler(
        grpo_config, exploration_steps, total_steps,
        max_max_actions=min(MAX_MAX_ACTIONS, budget))
    writer = MetricsWriter(str(model_dir / "stats.csv"))
    generator = torch.Generator(device=device).manual_seed(seed)
    val_generator = torch.Generator(device=device).manual_seed(seed + 1)
    np_rng = np.random.default_rng(seed)
    hook = step_hook or (lambda kind, info: None)

    step_idx = 0
    stats = []
    for _ in range(epochs):
        order = np_rng.permutation(n)
        starts = list(range(0, n - batch_size + 1, batch_size))

        def load_batch(si):  # lazily, one batch ahead
            if si >= len(starts):
                return None
            return [dataset[int(j)]
                    for j in order[starts[si]:starts[si] + batch_size]]

        batch_examples, next_examples = load_batch(0), load_batch(1)
        preencoded = None
        try:
            for bi in range(len(starts)):
                t0 = time.perf_counter()
                state, metrics = grpo_update(
                    state.params, state, update_step, cfg, grpo_config,
                    batch_examples, tokenizer, generator, writer, step_idx,
                    compute_dtype, reward_workers, next_examples=next_examples,
                    preencoded=preencoded, device=device)
                batch_examples = next_examples
                next_examples = load_batch(bi + 2)
                preencoded = metrics.pop("preencoded_next")
                metrics["seconds"] = time.perf_counter() - t0
                stats.append(metrics)
                curriculum.step()
                step_idx += 1
                hook("step", {"state": state, "step": step_idx,
                              "metrics": metrics})
                if step_idx % grpo_config.checkpoint_freq == 0:
                    ckpt_lib.save_train_state(
                        model_dir / "checkpoints" / f"step_{step_idx}", state)
                if (val_dataset is not None
                        and step_idx % grpo_config.mini_validation_freq == 0):
                    val = mini_validate(
                        state.params, cfg, grpo_config, val_dataset, tokenizer,
                        val_generator, max_examples=mini_validation_size,
                        compute_dtype=compute_dtype,
                        reward_workers=reward_workers, device=device)
                    writer.scalar("mini_val/reward", val["reward"], step_idx)
                    writer.scalar("mini_val/ce_loss", val["ce_loss"], step_idx)
                    comps = val["components"]
                    if comps is not None:
                        writer.scalars("mini_val/reward/components",
                                       comps.to_dict(), step_idx)
                    metrics["mini_val"] = {
                        "step": step_idx, "reward": val["reward"],
                        "ce_loss": val["ce_loss"],
                        "components": comps.to_dict() if comps else None}
                    hook("val", {"state": state, "step": step_idx,
                                 "metrics": metrics["mini_val"]})
                writer.flush()
        except BaseException:
            # crash-resilient save; the original error is what propagates
            try:
                ckpt_lib.save_train_state(
                    model_dir / "checkpoints" / "emergency", state)
                print(f"Saved emergency checkpoint to "
                      f"{model_dir}/checkpoints/emergency")
            except Exception as save_error:
                print(f"emergency checkpoint failed: {save_error!r}")
            raise
        writer.flush()

    ckpt_lib.save_pytree(model_dir / "grpo_vitomr", state.params)
    return state.params, stats


if __name__ == "__main__":
    import argparse

    from .omr_teacher_force_train import set_up_vitomr

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default=TF_CHECKPOINT_PATH,
                    help="stage-2 parameters (.npz)")
    args = ap.parse_args()
    tokenizer, train_ds, val_ds = build_datasets()
    cfg, params = set_up_grpo(set_up_vitomr(tokenizer),
                              ckpt_lib.load_params(args.checkpoint))
    grpo_train(cfg, params, train_ds, tokenizer, val_dataset=val_ds,
               device=args.device)
