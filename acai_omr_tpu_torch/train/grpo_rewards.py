"""GRPO reward components for LMX rollouts (the port's own copy of the JAX
package's ``train/grpo_rewards.py``; numpy on the host).

reward = λ_tedn·exp(−α_t·TEDn) + λ_wf·wellformedness + λ_f1·tokenF1
       − λ_rep·n-gram-repeat − λ_len·length-penalty,
group-normalized into advantages. TEDn scoring runs on the native
Zhang-Shasha kernel (:mod:`..lmx.tedn`) across a thread pool (ctypes releases
the GIL).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..lmx.tedn import TEDn_lmx_xml


# --- configs ----------------------------------------------------------------

@dataclasses.dataclass
class RolloutConfig:
    group_size: int
    max_actions: int
    top_k: int
    temperature: float
    # "int8" runs the rollout decode on int8 KV caches; the old-policy
    # log-probs the PPO ratio anchors on come from the same quantized
    # decode, so the objective stays self-consistent.
    cache_dtype: str = "bf16"


@dataclasses.dataclass
class RewardConfig:
    lambda_tedn: float
    lambda_well_formed: float
    lambda_f1: float
    lambda_repeat: float
    lambda_len: float
    alpha_tedn: float
    alpha_well_formed: float
    gamma: float
    delta: int
    tau: int


@dataclasses.dataclass
class LossConfig:
    entropy_beta: float
    lambda_ce: float


@dataclasses.dataclass
class UpdateConfig:
    epsilon: float
    update_epochs: int
    max_grad_norm: float
    # control arm: randomly permute the flat advantage vector across the
    # batch before the update, destroying the rollout <-> advantage credit
    # assignment while keeping the update's magnitude, the lr schedule and
    # the data flow identical (the null hypothesis of a GRPO lift).
    shuffle_advantages: bool = False


@dataclasses.dataclass
class GRPOConfig:
    rollout_config: RolloutConfig
    reward_config: RewardConfig
    loss_config: LossConfig
    update_config: UpdateConfig
    mini_validation_freq: int
    checkpoint_freq: int

    def get_configs(self):
        return (self.rollout_config, self.reward_config, self.loss_config,
                self.update_config)


@dataclasses.dataclass
class RewardComponents:
    tedn_scores: np.ndarray | float
    wellformedness_scores: np.ndarray | float
    f1_scores: np.ndarray | float
    repeat_penalty: np.ndarray | float
    len_penalty: np.ndarray | float

    def __add__(self, other):
        return RewardComponents(*(getattr(self, f.name) + getattr(other, f.name)
                                  for f in dataclasses.fields(self)))

    def __truediv__(self, d):
        return RewardComponents(*(getattr(self, f.name) / d
                                  for f in dataclasses.fields(self)))

    def __mul__(self, m):
        return RewardComponents(*(getattr(self, f.name) * m
                                  for f in dataclasses.fields(self)))

    def avg_over_rollouts(self):
        return RewardComponents(*(float(np.mean(getattr(self, f.name)))
                                  for f in dataclasses.fields(self)))

    def to_dict(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


# --- components (all return (R,) arrays) -----------------------------------

def calc_edit_costs(rollouts: np.ndarray, pad_idx: int, num_groups: int,
                    group_size: int, target_musicxml_strs, idxs_to_tokens,
                    num_workers: int = 16):
    """TEDn per rollout via the native kernel on a thread pool."""
    jobs = []
    rollout_groups = rollouts.reshape(num_groups, group_size, -1)
    for g, group in enumerate(rollout_groups):
        target = target_musicxml_strs[g]
        for rollout in group:
            ids = rollout[rollout != pad_idx]
            toks = [idxs_to_tokens[int(i)] for i in ids]
            if toks and toks[-1] == "<eos>":
                toks.pop()
            lmx = " ".join(toks[1:])  # strip <bos>
            jobs.append((lmx, target))

    def score(job):
        return TEDn_lmx_xml(job[0], job[1], "lmx", False, False)

    with ThreadPoolExecutor(num_workers) as pool:
        results = list(pool.map(score, jobs))
    edit_costs, catastrophic, minor = zip(*results)
    return (np.asarray(edit_costs, dtype=np.float32),
            np.asarray(catastrophic, dtype=bool),
            np.asarray(minor, dtype=np.float32))


def calc_tedn_scores(edit_costs, alpha_t=0.01):
    return np.exp(-alpha_t * edit_costs)


def calc_wellformedness(catastrophic_errors, minor_errors, gamma=3.0, alpha_w=0.2):
    scores = np.exp(-alpha_w * minor_errors)
    return np.where(catastrophic_errors, -gamma, scores)


def calc_token_f1(rollouts, target_lmx_seqs, pad_idx):
    num_predictions = (rollouts != pad_idx).sum(-1)
    num_targets = (target_lmx_seqs != pad_idx).sum(-1)
    t = min(rollouts.shape[-1], target_lmx_seqs.shape[-1])
    preds, targets = rollouts[:, :t], target_lmx_seqs[:, :t]
    tp = ((preds == targets) & (targets != pad_idx)).sum(-1)
    precision = tp / (num_predictions + 1e-8)
    recall = tp / (num_targets + 1e-8)
    return 2 * precision * recall / (precision + recall + 1e-8)


def _n_gram_penalty(rollouts, n, pad_idx):
    r, t = rollouts.shape
    num_grams = t // n
    if num_grams < 2:
        return np.zeros(r, dtype=np.float32)
    grams = rollouts[:, : num_grams * n].reshape(r, num_grams, n)
    prev, nxt = grams[:, :-1], grams[:, 1:]
    pad_mask = (nxt == pad_idx).any(-1)
    repeats = ((prev == nxt).all(-1) & ~pad_mask).sum(-1)
    opportunities = (~pad_mask).sum(-1)
    return repeats / (opportunities + 1e-8)


def calc_repeat_penalty(rollouts, pad_idx, n_values=(1, 2, 3, 4)):
    total = sum(_n_gram_penalty(rollouts, n, pad_idx) for n in n_values)
    return total / len(n_values)


def calc_len_penalty(rollout_mask, target_lmx_seqs, pad_idx, delta=10, tau=100):
    rollout_lens = rollout_mask.sum(-1)
    target_lens = (target_lmx_seqs != pad_idx).sum(-1)
    diffs = np.abs(rollout_lens - target_lens).astype(np.float32)
    diffs = np.where(diffs < delta, 0.0, diffs)
    penalty = np.exp((np.log(2.0) / tau) * diffs) - 1.0
    return np.clip(penalty, None, 1.0)


def calc_group_rewards(rc: RewardConfig, comp: RewardComponents, num_groups,
                       group_size):
    rewards = (rc.lambda_tedn * comp.tedn_scores
               + rc.lambda_well_formed * comp.wellformedness_scores
               + rc.lambda_f1 * comp.f1_scores
               - rc.lambda_repeat * comp.repeat_penalty
               - rc.lambda_len * comp.len_penalty)
    return rewards.reshape(num_groups, group_size)


def reward_rollouts(rc: RewardConfig, rollouts, rollout_mask, target_lmx_seqs,
                    target_musicxml_strs, num_groups, group_size,
                    idxs_to_tokens, pad_idx, num_workers: int = 16):
    edit_costs, catastrophic, minor = calc_edit_costs(
        rollouts, pad_idx, num_groups, group_size, target_musicxml_strs,
        idxs_to_tokens, num_workers)
    comp = RewardComponents(
        tedn_scores=calc_tedn_scores(edit_costs, rc.alpha_tedn),
        wellformedness_scores=calc_wellformedness(catastrophic, minor,
                                                  rc.gamma, rc.alpha_well_formed),
        f1_scores=calc_token_f1(rollouts, target_lmx_seqs, pad_idx),
        repeat_penalty=calc_repeat_penalty(rollouts, pad_idx),
        len_penalty=calc_len_penalty(rollout_mask, target_lmx_seqs, pad_idx,
                                     rc.delta, rc.tau),
    )
    return calc_group_rewards(rc, comp, num_groups, group_size), comp


def group_advantages(raw_group_rewards: np.ndarray) -> np.ndarray:
    """(G, group_size) rewards -> flat (R,) group-normalized advantages
    (Bessel-corrected std, as torch's ``.std``)."""
    mean = raw_group_rewards.mean(-1, keepdims=True)
    if raw_group_rewards.shape[-1] < 2:
        # the Bessel-corrected std of one sample is NaN and would silently
        # poison the update; a single-rollout group has no relative
        # signal: zero advantages
        return np.zeros_like(raw_group_rewards).reshape(-1)
    std = raw_group_rewards.std(-1, keepdims=True, ddof=1)
    return ((raw_group_rewards - mean) / (std + 1e-8)).reshape(-1)
