#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, all in one process; any failure exits non-zero:

1. print the card (``nvidia-smi`` name and power limit), build every kernel
   of ``acai_omr_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel (K1 linear_bias_act, K2 decode_attention with and
   without grouped memory, K3 encoder_attention, K4 add_layernorm, K5
   quant_linear_bias_act (its cluster kernel, bit for bit, at 32 rows, at
   the 4, 8 and 16 rows of int8 and beam_int8 and at the tp = 2 shards and
   partials of tp2_int8_w8a8, in turns with the three-launch form it
   replaced, ``variant="simt"``, warm and from HBM, the host us a call of
   both), K14 quant4_linear_bias_act (the same cluster kernel on int4
   weights, bit for bit, at 32 and 8 rows, in turns with its three-launch
   form, warm and from HBM), K6
   decode_attention_int8 (its cluster kernel) in self, cross and grouped
   cross mode at B = 32 and at the rows the int8 paths run (4 and 8 rows,
   beams B = 16 G = 4, GRPO's 128 rows G = 8 as a kernel row), in turns
   with the simt kernel it replaced, warm and from HBM, two runs
   bit-equal; the per-op step's K11 decode_attention_hd self and cross, K12
   decode_attention_hd_int8 (its cluster kernel) per layer and stacked at
   B = 32 and stacked at the path's 4 rows, in turns with the simt kernel it
   replaced, warm and from HBM, two runs bit-equal, K13
   self_attention_append_int8 (its cluster kernel, K12's with the fresh
   token) at B = 32 pos 300 and 0 and at the path's 4 and 8 rows, in turns
   with the simt kernel it replaced, warm and from HBM, two runs bit-equal,
   the written column bit for bit; K15 tp_allreduce at tp = 2
   and 4, B = 4-128, E = 1024, bf16 and fp32 out, bit for bit, its one-card
   form timed in turns with the exchange it replaced on one card
   (``variant="coop"``), the host time of a call of each, then for each
   form 1,000 back-to-back calls with fresh inputs, every one bit-equal to
   its twin; K4 add_layernorm at 4, 32 and 16,384 rows, its vector kernel
   timed in turns with the scalar kernel it replaced (``variant="scalar"``),
   the decode rows also from HBM; K2 also at 4 rows and B = 1 (self), 4
   and 8 rows over M = 1,024 (cross) and GRPO's 128 rows at G = 8, K11
   also at 4 rows, each K2 / K11 case timed in turns with the simt kernel
   it replaced and from HBM beside SDPA from HBM, two runs bit-equal,
   split 1 within the tolerance, keys past n_keys set to NaN changing no
   bit) against its plain PyTorch twin at the flagship shapes the paths
   give it, and time kernel, twin, a PyTorch library call computing the
   same function where there is one, the card's bound, and the host time
   of one wrapper call (the decode step is bound by it). The int8
   kernels' appended rows and scales must equal the twin's bit for bit.
   The training kernels (K7 attention_bwd, K8 layernorm_bwd, K9 linear_dgrad /
   linear_wgrad, K10 dropout, and the training modes of K1, K3, K4) are held
   the same way at the flagship's training shapes (decoder rows 8 x 256 at
   E = 1024, F = 4096, M = 1024; encoder rows 8 x 1024 at E = 768,
   F = 3072); K10 must equal its twin bit for bit; K8 (its one-pass
   kernel) in turns with the three-launch form it replaced, warm and from
   HBM, one device kernel a call, two runs bit-equal, its dropped dz K10's
   mask on dz bit for bit. The MAE's shapes follow:
   K3 and K7 at 16 heads of 32 (B = 64, T = 512, E = 512) and at the
   encoder's 128 kept rows (12 heads of 64), K1, K4, K8 and K9 at
   32,768 x 512, ``linear_wgrad`` with its rows split as its plan says.
   K1's large-M products and every ``linear_wgrad`` and ``linear_dgrad``
   (the Hopper GEMM core, csrc/sm90_gemm.cuh), K1's decode rows (its
   skinny kernel: one launch, K split across a thread-block cluster), and
   every K3 and K7 site (their TMA + wgmma kernels) are timed in turns with
   the wmma kernels they replaced, forced through the wrappers'
   ``variant=`` (``old_ms``), which must agree with the twins too, K10's
   mask the same elements in all three, two runs of the new K1 decode
   rows, K3 and K7 bit-equal; from HBM (``cold_ms``) where the operands fit
   L2, the decode rows' library call too (``library_cold_ms``); K7's
   outputs at its five sites equal, bit for bit, to those recorded in
   ``K7_BITS``; then the resource rows of K1's, K3's, K9's, K7's, K4's and
   K15's kernels, none of the Hopper dgrad, K3 and K7 kernels, none of K1's
   skinny kernels, K4's vector kernels or K15's one-card kernels with local
   memory;
   then the probes phase: K16 tile_gemm (persistent blocks, TMA + wgmma,
   TMA-stored tiles) at every tile of the GEMM sweep (bf16 out) at
   (8192, 768, 3072), (32768, 512, 1536) and (32768, 512, 3072), and in its
   three operand layouts (fp32 out) at the dot-forms probe's shapes and at
   (8192, 768, 3072); K17 blockdiag_decode_attention (bf16 at bt 2 / 4 / 8,
   int8 at bt 4 / 8, on one thread-block cluster a row, the split its plan
   gives) and K18 batched_decode_attention (one block per (row, head), bt
   4) at B = 32, H = 16, Dh = 64, T = 512, K18 also at B = 1 beside K11 there,
   with K11 decode_attention_hd on the same inputs (the microbench's
   per-head line) beside them; K19 smem_probe at 227 KB (row 0 bit for bit),
   228 KB refused, its warp kernel with and without its programmatic launch
   in turns with the kernel it replaced (``variant="simple"``); K20-K24 (the int4 and memory-stream probes' kernels,
   ``int4_stream_cases``: K20 int4_delivery_gemm on whole-K column strips,
   K21 int4_unpack on whole words, K23 clamped_chunk_sum as a chunk walk and
   K24 lane_stream_sum in one launch, each in turns with the kernel it
   replaced, ``variant="atomic"`` / ``"bytewise"`` / ``"grid"`` /
   ``"two_pass"``, warm and from HBM, K21's us per unpack of both forms,
   K23's ``torch.sum`` on the same rotation); K25 head_logits (persistent blocks, TMA-stored
   tiles) in its three access forms at (T, E, H) = (256, 1024, 16) and
   (1024, 768, 12), K26 batched_head_logits in fp32 and int8 (exact), K27
   resident_elementwise in its five works at 8 passes; each against its
   twin, timed beside its bound and the library call (K25: ``torch.bmm``
   with fp32 out, the same function, and ``torch.matmul`` with bf16 out);
   K16, K17 and K25 timed in turns with the wmma kernels they replaced
   (``variant="wmma"``) and K18 with its warp kernel (``variant="warp"``),
   each held to the twin too, warm and from HBM, two runs bit-equal; the
   resource rows (registers, local bytes, shared memory, blocks per SM) of
   K16-K18 and K20-K27, none of the redesigned kernels with local memory.
   Then
   the probes' main path, the launch counts reset before it and read after:
   ``main`` of the fourteen tools of ``acai_omr_tpu_torch/tools`` (gemm_probe,
   pallas_gemm_probe, mosaic_dot_forms_probe, attn_microbench, vmem_probe,
   int4_probe, unpack_probe, dma_issue_probe, dma_skip_probe,
   narrow_lane_dma_probe, mosaic_head_access_probe, mosaic_batched_attn_probe,
   vpu_probe, and bwd_vmem_probe once per mode: full, nocross, noself,
   noffn, which prints the resource rows of every kernel the decoder
   backward launches), their lines printed; every dot form right, the
   largest scratch that launches equal to
   cudaDevAttrMaxSharedMemoryPerBlockOptin and at least the 227 KB
   ops/decode_hd_kernel.py assumes, every head-access form and K27 work
   right, every backward mode OK with the launches of its layer arithmetic,
   no launch of K16's, K17's or K25's wmma kernel, K18's warp kernel, K19's
   simple kernel, K20's atomic kernel, K21's bytewise kernels, K23's grid
   kernel, K24's two-pass form, K26's shuffle kernel or K27's fixed kernel
   on the path;
3. the paths: the flagship ViTOMR (~305M parameters, weights from a seed,
   bf16) goes through ``OmrModel.transcribe_batch`` on 8 ragged synthetic
   images greedily with bf16 caches and with ``quantized_kv`` (max_len 512),
   on 4 of them with 4 beams, bf16 and int8 (max_len 256), and through
   ``streamed_inference`` on one; with int8 caches and W4A8 weights
   (``w4a8``: K14, no K5) and with W8A8 off (``int8_bf16w``: K1 products,
   no K5); ``serve_wsgi``: 8 concurrent clients of the WSGI app
   (``serving.wsgi_app.application``: create, upload a PNG, one box,
   stream the SSE body, postprocess) on dynamic batching with int8 caches
   and W4A8 weights, then one request with batching off, the SSE contract
   checked on every stream; then on the per-op step
   (``ACAI_MONOLITH_DECODE`` off) greedily with K11 and with int8 caches (K13,
   K12 stacked), and its bf16 step with K11 off and on in turns; the launch
   counts are reset just before each path and read just after, and their
   split by variant must show every encoder product of K1 on the core
   ("sm90", 4 per encoder K3 launch), every decode product on the skinny
   kernel ("skinny", "skinny_partial"), every K3 on its Hopper kernel
   ("sm90_dh{Dh}") and every K4 on its vector kernel ("warps{W}"); the
   training paths below run every K1, every ``linear_dgrad`` and every
   ``linear_wgrad`` on the core ("sm90",
   "sm90_splits{s}") and every K3 and K7 on its Hopper kernels
   ("sm90_dh{Dh}"), GRPO its rollouts' K1 on the skinny kernel. Then the
   kernel path is held against the
   plain path on the card: encoder output, and 64 greedy decode steps at B=8
   with bf16 caches, int8 caches and int8 caches with W4A8 weights (the
   plain path is fed the kernel path's tokens, so the logits stay
   comparable step by step); then the meshed decode through
   ``batch_inference(mesh=make_mesh(n_data, n_model, ["cuda:0"] * n),
   model_axis="model")``, every shard on this card and K15 summing the
   model ranks in its one-card form (every launch "local", none "coop"):
   ``tp2_bf16`` and ``tp4_bf16`` (8 images, max_len 256), ``tp2_int8``
   (int8 caches, K5 may not launch) and ``tp2_int8_w8a8``
   (``ACAI_TP_W8A8``: K5 partials), ``tp2_beam`` (4 images, 4 beams, 256),
   ``dp2_tp2`` (a 2 x 2 mesh with ``progress_cb`` events) and ``tp2_per_op``
   (``ACAI_MONOLITH_DECODE`` off, K11 on, max_len 128); per path ms per step, wrapper
   calls and device kernels per step held against the layer arithmetic,
   K15 launches, the share of tokens equal to the unsharded path of the
   same mode and the first step's largest |logit difference| against the
   unsharded step; then ``vitomr_api``: the flagship's bf16 weights
   through the reference's state-dict layouts and back on the card
   (``vitomr_state_dict_from_params`` plain and at fine-tune depth 4,
   ``vitomr_params_from_torch``; every leaf bit-equal), and on the weights
   read back ``models/vitomr``'s entry points: ``cached_greedy_generate``
   (8 images, max_len 512) and ``cached_beam_generate`` (4 images, 4 beams,
   256) bit-equal to ``decode.generate`` / ``decode.beam_generate`` on the
   same latent, ``generate_next_token_distr`` for one padded image with its
   ``latent_valid`` over 16 prefixes of its greedy output (each call through
   K3) against the plain twins (log-probs < 0.25) and the greedy next token
   (>= 90 %);
4. the path ``train_tf``: ``omr_teacher_force_train`` on the card with the
   flagship configuration, bf16 over fp32 masters, dropout on, a seeded
   synthetic dataset (images of 512-1,024 patches, token sequences that pad
   to T = 256), batch 8, accumulation 2, one epoch of three optimizer steps
   and its validation pass; then one flagship microbatch twice through the
   hand-written path (equal bits demanded) and, at half the batch, against
   autograd through the plain twins on the card (loss and every leaf's
   gradient, stacked leaves layer by layer; limits fixed beforehand and a
   band of three times the errors read), forward and backward timed apart;
5. the path ``train_grpo``: ``grpo_train`` on the card on the flagship's
   stage-3 hand-off (``set_up_grpo``), 32 synthetic images with LMX targets
   from tests/data in batches of 16 (two outer steps of 8 rollouts per
   image, at most 768 actions, top-k 50, temperature 1.1, two update epochs
   of 16 rollout chunks), one mini-validation on 8; phase times per step,
   frozen leaves bit-unchanged, every decoder leaf moved;
   then training over the mesh, every shard on this card, K15 ``"local"``
   summing the data shards' flat gradient buffers exactly once a gradient
   step (``k15_per_step``): ``train_dp`` (a (2, 1) mesh; stage 2: one
   ``make_sharded_grad_fn`` call on the flagship at batch 8, dropout 0 and
   tf_prob 1, then DP_UPDATES ``make_sharded_train_step`` updates with
   dropout on; stage 1: ``set_up_mae()`` at batch 64, one sharded gradient
   on one mask noise, one update; afterwards, uncounted, each sharded
   gradient against ``make_grad_fn`` on the same rows within the limits of
   phase 4, and the device ms of the DP step, the one-card step and one
   shard's rows), ``train_pp`` (the flagship decoder over PP_STAGES stages
   x 2 data shards, PP_MICRO microbatches a shard, batch 8, T = 256, memory
   1,024: one ``make_pp_grad_fn`` call and PP_UPDATES ``make_pp_train_step``
   updates; afterwards the loss and gradients against the unpipelined
   decoder's, the bubble share, the device ms of both) and ``grpo_dp`` (one
   outer step of ``train_grpo``'s configuration through
   ``grpo_update(mesh=)``: the rollouts by ``forward_rollout_policy(mesh=)``
   on 2 data shards, one sharded update; afterwards its batch's sharded
   gradients against the mesh-less step's);
6. the path ``pretrain_mae``: ``pre_train`` on the card at the full width of
   ``set_up_mae()`` (ViT-B/16 encoder over the kept quarter, 8 x 512 x 16-head
   decoder), bf16 over fp32 masters, batch 64, seeded noise images of
   256-512 patches, one epoch of three updates and its validation batch; the
   launch counts of every update are held against the layer arithmetic,
   K3 / K7 by head dim, ``linear_dgrad`` on the core and ``linear_wgrad``
   by row splits;
   ``pretrained_mae.npz`` must load as an MAE tree and stage 2's set-up must
   hold exactly its encoder. Then one batch of 64 twice through the
   hand-written path (equal bits demanded; forward, backward, optimizer and
   a validation forward timed apart) and, at 8 images, against autograd
   through the plain twins (the limits of phase 4);
7. the path ``eval_cli``: a 48-image GrandStaff + OLiMPiC test layout
   written to a temporary directory (``eval_layout``), ``eval_model``'s
   root constants pointed at it; the flagship (seed 0, fp32) written by
   ``save_pytree`` and evaluated by ``eval_vitomr``, the same weights
   written as a reference ``.pth`` and evaluated by
   ``verify_reference_losses._eval_with_params`` (the loss bit-equal), then
   ``set_up_mae()``'s MAE by ``eval_mae``; finite losses, every eval batch
   through K1 / K3 / K4 (K3 at head dims 64 and 32 for the MAE); both
   losses again through the stacks' plain twins, within CMP_LOSS_REL, and
   K1 against its twin at every shape the two evaluations gave it; then
   ``host_tools``: the LMX CLI's round trip of tests/data's samples, the
   vocabulary writer against ``lmx_vocab.txt``, ``calc_dataset_stats`` over
   the layout's images, ``ops/preprocess`` on the card against the host
   pipeline (within PREPROCESS_TOL) and the port's parity gate (exit 0,
   every check skipped); then K15 at the data-parallel step's flat buffer
   (the flagship's gradients and two scalars, D = 2 and 4) in the step's
   form (summed into the first buffer in place) against its twin, bit for
   bit, beside ``torch.stack(parts).sum(0)``;
8. print the ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Options: ``--profile`` adds a torch.profiler window over 32 kernel-path
decode steps of each cache mode and of the per-op bf16 step with K11 on and
int8 step (K2's, K4's, K5's, K6's, K11's, K12's, K13's and K14's device ms a
step among them; the W8A8 step and the per-op int8 step again with K5 / K12
/ K13 forced to the forms they replaced, in turns), over two training
microbatches and over two MAE updates, each again with K8 forced to its
three-launch form (device time by kernel, device busy share, K8's device ms
a step); ``--report PATH``
writes every number of the run as JSON to PATH; ``--k7-bits`` prints only
the hashes of K7's outputs at its training sites (``k7_bits``, what
``K7_BITS`` records) and exits; ``--skinny-splits`` times only the skinny
kernel at every split of K at the decode shapes (``skinny_splits``) and
exits; ``--attn-splits`` times only K2's and K11's cluster kernels at every
split of the keys at the decode shapes (``attn_splits``) and exits;
``--k4-plan`` times only K4's vector kernel at 1 and 4 warps a row and
the scalar kernel at the paths' rows (``k4_plan``) and exits;
``--k19`` runs only K19's checks and turns (``k19_case``: the warp kernel
on its programmatic launch and the kernel it replaced, warm, from HBM, host
us a call and its parts, a captured graph's programmatic edges) and exits;
``--mesh-train`` runs only the mesh-training paths, ``host_tools`` and
K15's flat-buffer rows (``mesh_train_alone``) and exits;
``--stream-lookup`` times only the greedy bf16 decode with the wrappers'
stream lookup as it is and as it was, in turns (``stream_lookup``), and
exits; ``--k27-plan`` times only K27's plan kernel at the tool's softmax and ln
shapes at each layout its plan takes on either side of its row threshold
(``k27_plan``) and exits; ``--int8-splits`` times only K5's, K6's, K12's and K14's cluster kernels
at every split (K5 also at 64 and 128 columns a block) at the int8 paths'
shapes, from HBM, beside their plans' choices (``int8_splits``) and exits.
Phase 3 also holds the monolith int8 step against the per-op int8 step on
one batch (``int8_vs_per_op``: the first step's largest |logit
difference|, the top-1 margins of rows whose tokens differ, 24 free-running
steps of each), and checks that K14 is one device kernel a call on
``w4a8`` and ``serve_wsgi``, K5 on ``int8``, ``beam_int8`` and
``tp2_int8_w8a8``, and that a W4A8 and a W8A8 step are 11 device kernels a
layer; phases 4 and 6 check that K8 is one device kernel a call.

Exits non-zero without printing a result when no CUDA device is present or
when the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_INT8_OP_PER_S = 1979e12
PEAK_FP32_FLOP_PER_S = 67e12  # outside the tensor cores

SEED = 0
N_IMAGES = 8
MAX_LEN = 512
BEAM_IMAGES, BEAM_SIZE, BEAM_MAX_LEN = 4, 4, 256
CMP_STEPS = 64
# the kernel path against the plain path (compare_paths, and each meshed
# path's step): the largest |logit difference| and the greedy token
# agreement; the meshed step's first logits against the unsharded step's
CMP_LOGIT_TOL, CMP_AGREEMENT = 0.25, 0.9
# vitomr_api: prefixes of one image's greedy output whose next-token
# distribution is held against the plain twins and the greedy token (the
# share CMP_AGREEMENT of them allows one near-tie)
NEXT_PREFIXES = 16
# eval_cli: examples a test split (GrandStaff, OLiMPiC synthetic, scanned)
# and the eval batch
EVAL_SPLIT, EVAL_BATCH = 16, 16
TP_CMP_STEPS = 16
_ENC = ["linear_bias_act", "encoder_attention", "add_layernorm"]
# the kernels each main path must have launched
EXPECTED_KERNELS = {
    "greedy_bf16": _ENC + ["decode_attention"],
    "int8": _ENC + ["quant_linear_bias_act", "decode_attention_int8"],
    "beam_bf16": _ENC + ["decode_attention"],
    "beam_int8": _ENC + ["quant_linear_bias_act", "decode_attention_int8"],
    "streamed": _ENC + ["decode_attention"],
    "train_tf": _ENC + ["attention_bwd", "layernorm_bwd", "linear_dgrad",
                        "linear_wgrad", "dropout"],
    "pretrain_mae": _ENC + ["attention_bwd", "layernorm_bwd", "linear_dgrad",
                            "linear_wgrad"],
    "decode_hd_bf16": _ENC + ["decode_attention_hd"],
    "decode_hd_int8": _ENC + ["decode_attention_hd_int8",
                              "self_attention_append_int8"],
    "train_grpo": _ENC + ["decode_attention", "attention_bwd",
                          "layernorm_bwd", "linear_dgrad", "linear_wgrad"],
    "w4a8": _ENC + ["quant4_linear_bias_act", "decode_attention_int8"],
    "int8_bf16w": _ENC + ["decode_attention_int8"],
    # the batched requests (W4A8) and the unbatched one (bf16 caches)
    "serve_wsgi": _ENC + ["quant4_linear_bias_act", "decode_attention_int8",
                          "decode_attention"],
    # the meshed decode: every shard on cuda:0, K15 between the model ranks
    "tp2_bf16": _ENC + ["decode_attention", "tp_allreduce"],
    "tp4_bf16": _ENC + ["decode_attention", "tp_allreduce"],
    "tp2_int8": _ENC + ["decode_attention_int8", "tp_allreduce"],
    "tp2_int8_w8a8": _ENC + ["quant_linear_bias_act", "decode_attention_int8",
                             "tp_allreduce"],
    "tp2_beam": _ENC + ["decode_attention", "tp_allreduce"],
    "dp2_tp2": _ENC + ["decode_attention", "tp_allreduce"],
    "tp2_per_op": _ENC + ["decode_attention_hd", "tp_allreduce"],
    # training over a (2, 1) mesh on this card, K15 summing the shards; the
    # pipelined decoder (its stack only); GRPO's meshed rollouts and update
    "train_dp": _ENC + ["attention_bwd", "layernorm_bwd", "linear_dgrad",
                        "linear_wgrad", "dropout", "tp_allreduce"],
    "train_pp": _ENC + ["attention_bwd", "layernorm_bwd", "linear_dgrad",
                        "linear_wgrad", "tp_allreduce"],
    "grpo_dp": _ENC + ["decode_attention", "attention_bwd", "layernorm_bwd",
                       "linear_dgrad", "linear_wgrad", "tp_allreduce"],
    # models/vitomr's entry points on round-tripped weights; the eval CLI
    "vitomr_api": _ENC + ["decode_attention"],
    "eval_cli": _ENC,
    # the probe tools, each run through its main
    "probes": ["tile_gemm", "blockdiag_decode_attention",
               "batched_decode_attention", "smem_probe", "int4_delivery_gemm",
               "int4_unpack", "bulk_copy_ring", "clamped_chunk_sum",
               "lane_stream_sum", "head_logits", "batched_head_logits",
               "resident_elementwise"],
}
# the probe kernels redesigned for Hopper, each kept beside the kernel it
# replaced (a "wmma", "warp", "atomic", "grid", "shuffle", "fixed",
# "two_pass", "bytewise" or "simple" variant) as the yardstick timed in turns
REDESIGNED_PROBES = ("tile_gemm", "blockdiag_decode_attention",
                     "batched_decode_attention", "head_logits",
                     "int4_delivery_gemm", "clamped_chunk_sum",
                     "batched_head_logits", "resident_elementwise",
                     "lane_stream_sum", "int4_unpack", "smem_probe")


def replaced_form(variant: str) -> bool:
    """Whether a launch variant (``KernelOp.variants`` key, or the variant
    of a resource row) is the kernel a redesigned probe replaced: K16's,
    K17's and K25's ``wmma``, K18's ``warp``, K20's ``atomic``, K23's
    ``grid``, K26's ``shuffle``, K27's ``fixed``, K24's ``two_pass``, K21's
    ``bytewise``, K19's ``simple``."""
    return "wmma" in variant or any(
        variant == w or variant.endswith(" " + w)
        for w in ("warp", "atomic", "grid", "shuffle", "fixed", "two_pass",
                  "bytewise", "simple"))
# the stages bwd_vmem_probe stubs in the probes path, one run each
BWD_PROBE_MODES = ("full", "nocross", "noself", "noffn")
# the meshed paths: (data, model) mesh, images, max_len, batch_inference
# keywords, the unsharded path their tokens are held against
# the meshed paths' max_len, cut from MAX_LEN (512) to keep the run within
# its time: a meshed step makes 300-564 wrapper calls, the per-op one takes
# about 41 ms
TP_MAX_LEN, TP_PER_OP_MAX_LEN = 256, 128
TP_PATHS = {
    "tp2_bf16": ((1, 2), N_IMAGES, TP_MAX_LEN, {}, "greedy_bf16"),
    "tp4_bf16": ((1, 4), N_IMAGES, TP_MAX_LEN, {}, "greedy_bf16"),
    "tp2_int8": ((1, 2), N_IMAGES, TP_MAX_LEN, {"cache_dtype": "int8"},
                 "int8_bf16w"),
    "tp2_int8_w8a8": ((1, 2), N_IMAGES, TP_MAX_LEN, {"cache_dtype": "int8"},
                      "int8"),
    "tp2_beam": ((1, 2), BEAM_IMAGES, BEAM_MAX_LEN,
                 {"beam_size": BEAM_SIZE}, "beam_bf16"),
    "dp2_tp2": ((2, 2), N_IMAGES, TP_MAX_LEN, {}, "greedy_bf16"),
    "tp2_per_op": ((1, 2), N_IMAGES, TP_PER_OP_MAX_LEN, {}, "decode_hd_bf16"),
}
# K15 against its twin: 1,000 calls with fresh inputs, every one bit-equal
RACE_CALLS = 1000
# kernels of the monolith step, which the per-op paths must not launch
MONOLITH_STEP = ["decode_attention", "decode_attention_int8",
                 "quant_linear_bias_act", "quant4_linear_bias_act"]
SERVING_PATHS = ["greedy_bf16", "int8", "beam_bf16", "beam_int8", "streamed",
                 "w4a8", "int8_bf16w", "serve_wsgi"]
# the path serve_wsgi: concurrent clients of the WSGI app, dynamic batching
# with int8 caches and W4A8 weights; MAX_LEN (512) stands for the app's
# MAX_INFERENCE_LEN of 1,536
SERVE_CLIENTS, SERVE_MAX_BATCH, SERVE_WAIT_MS = 8, 8, 25.0
# the training path: flagship width, batch 8, accumulation 2, 3 updates
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_UPDATES = 8, 2, 3
TRAIN_SIZES = ((256, 1024), (256, 768), (192, 1024), (256, 512))
TRAIN_SEQ_LEN = 200
# the MAE pretraining path: the width of set_up_mae(), batch 64 as
# pre_train.BATCH_SIZE, 3 updates and one validation batch; seeded noise
# images of 256, 384 and 512 patches, so every batch pads to L = 512 and
# keeps K = 128
MAE_BATCH, MAE_UPDATES = 64, 3
MAE_SIZES = ((256, 512), (192, 512), (128, 512), (256, 384))
MAE_ROWS, MAE_KEPT = 512, 128  # L and K of every batch
MAE_CMP_BATCH = 8  # the plain twins' fp32 autograd saves at L = 512
# the GRPO path: flagship width, 32 examples in batches of 16 (2 outer
# steps), 8 rollouts per image of at most 768 actions, top-k 50, temperature
# 1.1, 2 update epochs of 16 rollout chunks, one mini-validation on 8
GRPO_EXAMPLES, GRPO_BATCH, GRPO_VAL = 32, 16, 8
# training over the mesh, every shard on this card: the stage-2 / stage-1
# data-parallel updates after the comparison; the pipelined decoder's stages,
# microbatches a data shard, T, memory length and updates
DP_UPDATES = 2
PP_STAGES, PP_MICRO, PP_T, PP_M, PP_UPDATES = 4, 2, 256, 1024, 2
MESH_TRAIN_PATHS = ("train_dp", "train_pp", "grpo_dp")
# the device ingest against the host pipeline (tests/test_preprocess_device.py)
PREPROCESS_TOL = 2e-5
# limits of the hand-written backward against autograd of the plain twins
# (fixed before the first run, PERF.md section 6): loss, every leaf (stacked
# leaves layer by layer), all leaves together
CMP_LOSS_REL, CMP_LEAF_REL, CMP_GLOBAL_REL = 1e-2, 0.2, 0.05
# a second, tighter band: three times what this comparison read on an
# NVIDIA H100 80GB HBM3 (loss 4.3e-5, worst slice 0.0128, together 0.0096)
CMP_LOSS_BAND, CMP_LEAF_BAND, CMP_GLOBAL_BAND = 1.3e-4, 0.039, 0.03
# two bf16 ulps of the largest output: what the int8 kernels may differ by
TWO_BF16_ULPS = 2 * 2.0 ** -7


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_BF16_FLOP_PER_S) -> tuple[float, str]:
    t_b = n_bytes / PEAK_BYTES_PER_S
    t_f = n_ops / peak_ops
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def time_ms(torch, fn, iters: int = 20, reps: int = 3,
            copies: int | None = None) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events (the graph keeps the host's
    launch cost out of the kernel's time); the probe tools' timer. With
    ``copies``, ``fn(i)`` rotates over that many input sets."""
    from acai_omr_tpu_torch.tools._probe import time_ms as graph_ms
    return graph_ms(fn, torch.device("cuda"), iters, reps, copies)


def cold_ms(torch, fn, tensors) -> float:
    """Device time of ``fn(*tensors)`` from HBM: the calls rotate over enough
    copies of ``tensors`` (the weights) that each copy is out of L2 when it
    is used again, as the decode step streams twelve layers' weights."""
    from acai_omr_tpu_torch.tools._probe import cold_copies, l2_bytes
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = cold_copies(nbytes, l2_bytes(torch.device("cuda")))
    sets = [tensors] + [[t.clone() for t in tensors]
                        for _ in range(copies - 1)]
    return time_ms(torch, lambda i: fn(*sets[i]), copies=copies)


def turns_ms(torch, new, old, timer: bool = True) -> tuple[float, float]:
    """Device ms of a redesigned kernel and of the kernel it replaces on the
    same inputs, timed in turns (new, old, old, new) inside this call; each
    the lesser of its two readings. ``timer=False``: ``new`` and ``old``
    are measurements themselves (``cold_ms`` of each), run in the same
    turns."""
    run = (lambda fn: time_ms(torch, fn)) if timer else (lambda fn: fn())
    a, b, c, d = (run(fn) for fn in (new, old, old, new))
    return min(a, d), min(b, c)


def one_kernel(op, call) -> bool:
    """Whether one call of ``op`` runs one device kernel."""
    before = op.device_launches
    call()
    return op.device_launches == before + 1


def time_ms_eager(torch, fn, iters: int = 20) -> float:
    """Time of one call from CUDA events around ``iters`` eager calls: for
    calls that run the autograd engine, which a graph capture does not take.
    Includes the host's launch cost where the device work is shorter."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one wrapper call: ``calls`` calls enqueued back to back
    on an idle stream, the clock read before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


@contextlib.contextmanager
def counted_steps(decode_lib):
    """Counts the decode steps taken inside the block: every step of either
    decode step is one call of ``decode.step_logits`` (one data shard's step
    on a mesh); ``rows`` lists each step's rows."""
    box = {"n": 0, "rows": []}
    inner = decode_lib.step_logits

    def step(*args, **kwargs):
        box["n"] += 1
        seqs = args[3].seqs
        box["rows"].append(seqs.reshape(-1, seqs.shape[-1]).shape[0])
        return inner(*args, **kwargs)

    decode_lib.step_logits = step
    try:
        yield box
    finally:
        decode_lib.step_logits = inner


def token_share(res_a, res_b) -> list:
    """Per image, the share of positions where two decodes of it agree."""
    return [round(int((a[: min(len(a), len(b))]
                       == b[: min(len(a), len(b))]).sum())
                  / max(len(a), len(b)), 3)
            for a, b in zip(res_a.seqs, res_b.seqs)]


def variant_failures(name: str, r: dict) -> list:
    """Which kernel each product and attention of a path ran, from its
    launches by variant: every K1 of an encoder or a training stack on the
    Hopper core ("sm90"; on the serving paths 4 per encoder K3 launch),
    every decode K1 (M <= 128) on the skinny kernel ("skinny", or
    "skinny_partial" on the meshed paths), GRPO both, never the wmma kernel
    ("wmma", "partial"); every K3 encoder_attention on its Hopper kernel
    ("sm90_dh{Dh}"); every linear_wgrad on the core ("sm90_splits{s}"),
    every linear_dgrad on the core ("sm90") and every K7 attention_bwd on
    its Hopper kernels ("sm90_dh{Dh}"); every K2 decode_attention, K6
    decode_attention_int8, K11 decode_attention_hd, K13
    self_attention_append_int8 and K14 quant4_linear_bias_act on its
    cluster kernel ("split{s}"), K5 quant_linear_bias_act on its
    ("split{s}", "partial_split{s}") and K12 decode_attention_hd_int8 on
    its ("layer_split{s}", "stacked_split{s}"), never the simt kernel or
    form it replaced; every K4 add_layernorm on its vector kernel
    ("warps{W}"), never the scalar kernel; every K8 layernorm_bwd on its
    one-pass kernel ("one_pass"), never the three-launch form; every K15
    tp_allreduce (all ranks on this card) in its one-card form ("local"),
    never the exchange ("coop")."""
    k1 = r["variants"].get("linear_bias_act", {})
    k3 = r["variants"].get("encoder_attention", {})
    wgrad = r["variants"].get("linear_wgrad", {})
    dgrad = r["variants"].get("linear_dgrad", {})
    k7 = r["variants"].get("attention_bwd", {})
    out = []
    if set(k1) - {"sm90", "skinny", "skinny_partial"}:
        out.append(f"{name}: K1 launches off the core and the skinny kernel "
                   f"{k1}")
    if any(not v.startswith("sm90_dh") for v in k3):
        out.append(f"{name}: encoder_attention off its Hopper kernel {k3}")
    if any(not v.startswith("sm90_splits") for v in wgrad):
        out.append(f"{name}: linear_wgrad off the core {wgrad}")
    if set(dgrad) - {"sm90"}:
        out.append(f"{name}: linear_dgrad off the core {dgrad}")
    if any(not v.startswith("sm90_dh") for v in k7):
        out.append(f"{name}: attention_bwd off its Hopper kernels {k7}")
    for op, forms in (("decode_attention", ("",)),
                      ("decode_attention_int8", ("",)),
                      ("decode_attention_hd", ("",)),
                      ("self_attention_append_int8", ("",)),
                      ("quant4_linear_bias_act", ("",)),
                      ("quant_linear_bias_act", ("", "partial_")),
                      ("decode_attention_hd_int8", ("layer_", "stacked_"))):
        by = r["variants"].get(op, {})
        cluster = lambda v: any(v.startswith(f + "split")
                                and v[len(f) + 5:].isdigit() for f in forms)
        if any(not cluster(v) for v in by) \
                or sum(by.values()) != r["launches"].get(op, 0):
            out.append(f"{name}: {op} off its cluster kernel {by}")
    k4 = r["variants"].get("add_layernorm", {})
    if any(not v.startswith("warps") for v in k4) \
            or sum(k4.values()) != r["launches"].get("add_layernorm", 0):
        out.append(f"{name}: add_layernorm off its vector kernel {k4}")
    k8 = r["variants"].get("layernorm_bwd", {})
    if set(k8) - {"one_pass"} \
            or sum(k8.values()) != r["launches"].get("layernorm_bwd", 0):
        out.append(f"{name}: layernorm_bwd off its one-pass kernel {k8}")
    k15 = r["variants"].get("tp_allreduce", {})
    if set(k15) - {"local"} \
            or sum(k15.values()) != r["launches"].get("tp_allreduce", 0):
        out.append(f"{name}: tp_allreduce off its one-card form {k15}")
    if name in ("train_tf", "pretrain_mae", "train_dp", "train_pp"):
        if set(k1) != {"sm90"}:
            out.append(f"{name}: K1 off the core {k1}")
    elif name in ("train_grpo", "vitomr_api", "grpo_dp"):
        if not (k1.get("sm90") and k1.get("skinny")):
            out.append(f"{name}: K1 by variant {k1}: the encoder and the "
                       f"stacks on the core, the decode rows on skinny")
    elif name == "eval_cli":  # a small bucket's rows (M <= 128) on skinny
        if not k1.get("sm90") or "skinny_partial" in k1:
            out.append(f"{name}: K1 by variant {k1}")
    elif k1.get("sm90", 0) != 4 * r["launches"]["encoder_attention"]:
        out.append(f"{name}: K1 by variant {k1}: the encoder's 4 a K3 launch "
                   f"on the core, the decode rows on skinny")
    return out


def k8_one_kernel_failures(name: str, r: dict) -> list:
    """K8 is one device kernel a call on a training path (the three-launch
    form it replaced ran three)."""
    calls = r["launches"]["layernorm_bwd"]
    device = r["device_launches"]["layernorm_bwd"]
    print(f"[path {name}] layernorm_bwd: {calls} calls, {device} device "
          f"kernels", flush=True)
    return [] if device == calls else [
        f"{name}: layernorm_bwd ran {device} device kernels in {calls} calls"]


def variant_line(name: str, r: dict) -> str:
    """The launches by variant of a path's products and attentions."""
    keys = ("linear_bias_act", "encoder_attention", "linear_wgrad",
            "linear_dgrad", "attention_bwd", "decode_attention",
            "decode_attention_int8", "decode_attention_hd",
            "decode_attention_hd_int8", "self_attention_append_int8",
            "quant_linear_bias_act", "quant4_linear_bias_act",
            "add_layernorm", "layernorm_bwd", "tp_allreduce")
    return f"[path {name}] by variant " + json.dumps(
        {k: r["variants"].get(k, {}) for k in keys})


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_kernels(torch, F, dev):
    """Phase 2: every kernel against its plain twin, timed."""
    from acai_omr_tpu_torch.ops.decode_kernel import (decode_attention,
                                                      decode_attention_int8)
    from acai_omr_tpu_torch.ops.encoder_stack_kernel import encoder_attention
    from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm
    from acai_omr_tpu_torch.ops.linear_kernel import gemm_plan, linear_bias_act
    from acai_omr_tpu_torch.ops.quant_linear_kernel import (
        pack_k4, pack_k8_int4, quant4_linear_bias_act, quant_linear_bias_act,
        quantize_activation_rows)

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16
    randn = lambda *s, dtype=bf: torch.randn(*s, generator=g, device=dev,
                                             dtype=torch.float32).to(dtype)
    cases = []
    kernel_times = lambda fn: (time_ms(torch, fn), host_us(torch, fn))

    def record(op, case, out_k, out_p, tol, t_k, t_p, t_lib, nbytes, nops,
               peak=PEAK_BF16_FLOP_PER_S, paths=None, exact=None,
               variant=None, cold=None, old_ms=None, lib_cold=None,
               extra=None):
        """``paths``: the main paths whose launches count for this case (the
        serving paths when None). ``variant``: the compiled variant or plan
        of the kernel this case launches (``KernelOp.variants``), where only
        that variant's launches count for it. ``exact``: for the int8 cases, whether the caches and
        scales after the kernel equal the twin's bit for bit (for K10, K14
        and K15: the whole output, every rank's for K15; for K8 and K9 wgrad: the fp32 column sums within
        1e-3 of their largest value; for K7: dq, dk and dv each within 2e-2
        of its own largest value). ``cold``: the device ms from HBM (the
        weights or inputs rotated out of L2), where it was measured.
        ``old_ms``: for a redesigned kernel, the device ms of the kernel it
        replaces (forced through the wrapper's ``variant=``), timed in turns
        with it (``turns_ms``). ``lib_cold``: the library call's device ms
        from HBM, on the same rotating copies as ``cold``. ``extra``: more
        numbers of the case (K4's ``old_cold_ms``, K15's ``old_host_us``),
        printed and reported under their keys."""
        t_k, t_host = t_k  # device ms and host us of one wrapper call
        err = (out_k.float() - out_p.float()).abs().max().item()
        b_ms, b_by = bound_ms(nbytes, nops, peak)
        ok = math.isfinite(err) and err <= tol and exact is not False
        paths = SERVING_PATHS if paths is None else paths
        cases.append({"op": op, "case": case, "max_abs_err": err, "tol": tol,
                      "ms": t_k, "host_us": t_host, "plain_ms": t_p,
                      "library_ms": t_lib,
                      "bound_ms": b_ms, "bound_by": b_by, "ok": ok,
                      "paths": paths, "variant": variant, "cold_ms": cold,
                      "old_ms": old_ms, "library_cold_ms": lib_cold,
                      "extra": extra or {}})
        lib = "none" if t_lib is None else f"{t_lib:.4f}"
        print(f"[kernel] {op.name}[{case}] max_abs_err={err:.3e} tol={tol:.1e} "
              f"kernel_ms={t_k:.4f} "
              + ("" if cold is None else f"cold_ms={cold:.4f} ")
              + ("" if old_ms is None else f"old_ms={old_ms:.4f} ")
              + f"host_us={t_host:.1f} plain_ms={t_p:.4f} "
              f"library_ms={lib} "
              + ("" if lib_cold is None else f"library_cold_ms={lib_cold:.4f} ")
              + f"bound_ms={b_ms:.4f} ({b_by}) "
              + "".join(f"{k}={v:.4f} " for k, v in (extra or {}).items())
              + ("" if exact is None else f"exact={exact} ")
              + ("ok" if ok else "FAIL"), flush=True)

    # K1: decode qkv, decode ff1 (+GELU), decode ff2 and GRPO's 128 rollout
    # rows (the skinny kernel); the encoder's four products at B = 16: qkv,
    # out, ff1 (+GELU on the fp32 sum), ff2 (the Hopper core). Each timed in
    # turns with the wmma kernel it replaces, which must agree with the twin
    # too; the decode rows also from HBM (kernel and library call on the same
    # rotating weight copies), two runs of the skinny kernel bit-equal
    for m, k, n, act in [(32, 1024, 3072, "none"),
                         (32, 1024, 4096, "gelu_rounded"),
                         (32, 4096, 1024, "none"), (128, 1024, 3072, "none"),
                         (16384, 768, 2304, "none"),
                         (16384, 768, 768, "none"), (16384, 768, 3072, "gelu"),
                         (16384, 3072, 768, "none")]:
        x = randn(m, k)
        w = (randn(k, n, dtype=torch.float32) / math.sqrt(k)).to(bf)
        b = randn(n, dtype=torch.float32) * 0.1
        b16 = b.to(bf)
        variant = gemm_plan(m, n, k)[0]
        call = lambda v=None: linear_bias_act(x, w, b, act, variant=v)
        out_k = call()
        out_p = linear_bias_act.plain(x, w, b, act)
        lib_of = lambda w_: (torch.addmm(b16, x, w_) if act == "none"
                             else F.gelu(torch.addmm(b16, x, w_)))
        # one bf16 ulp of the largest output is 0.4-0.8% of it
        tol = 1e-2 * max(1.0, out_p.float().abs().max().item())
        skinny = variant == "skinny"
        cold = cold_ms(torch, lambda w_: linear_bias_act(x, w_, b, act),
                       [w]) if skinny else None
        lib_cold = cold_ms(torch, lib_of, [w]) if skinny else None
        t_new, old = turns_ms(torch, call, lambda: call("wmma"))
        exact = (call("wmma").float() - out_p.float()).abs().max() \
            .item() <= tol
        if skinny:
            exact &= torch.equal(out_k, call())
        record(linear_bias_act, f"{m}x{k}->{n},{act} ({variant})", out_k,
               out_p, tol, (t_new, host_us(torch, call)),
               time_ms(torch, lambda: linear_bias_act.plain(x, w, b, act)),
               time_ms(torch, lambda: lib_of(w)),
               2 * (m * k + k * n + m * n) + 4 * n,
               2 * m * n * k, cold=cold, variant=variant, old_ms=old,
               exact=exact, lib_cold=lib_cold,
               paths=["train_grpo"] if m == 128 else None)

    # K1 at the meshed decode's shard shapes: the column-parallel qkv and ff1
    # of a tp = 2 rank, and the row-parallel partials (fp32, no bias) of the
    # self / cross out (K = E / tp) and ff2 (K = F / tp) products at the rows
    # the meshed paths give them: 8 (tp = 2 / 4), 4 (a dp2_tp2 shard), 16
    # (tp2_beam); the cross-query shards (E -> E / tp). A partial is held to
    # 1e-3 of its largest value, far below a bf16 ulp: a bias added, a row or
    # column missed would show. Library call: torch.mm, bf16 out. Only
    # partial launches count for those cases. Timed in turns with the wmma
    # kernel (held to the twin too), two runs of the skinny kernel bit-equal
    for m, k, n, act in [(8, 1024, 1536, "none"),
                         (8, 1024, 2048, "gelu_rounded"),
                         (8, 1024, 512, "none"), (8, 1024, 256, "none"),
                         (8, 512, 1024, "partial"), (8, 2048, 1024, "partial"),
                         (8, 256, 1024, "partial"), (8, 1024, 1024, "partial"),
                         (4, 512, 1024, "partial"), (16, 2048, 1024, "partial")]:
        x = randn(m, k)
        w = (randn(k, n, dtype=torch.float32) / math.sqrt(k)).to(bf)
        partial = act == "partial"
        b = None if partial else randn(n, dtype=torch.float32) * 0.1
        call = lambda v=None: linear_bias_act(x, w, b, act, variant=v)
        out_k = call()
        out_p = linear_bias_act.plain(x, w, b, act)
        if partial:
            assert out_k.dtype == torch.float32, "K1 partial is fp32"
            lib = lambda: torch.mm(x, w)
        else:
            b16 = b.to(bf)
            lib = (lambda: torch.addmm(b16, x, w)) if act == "none" else \
                (lambda: F.gelu(torch.addmm(b16, x, w)))
        tol = (1e-3 if partial else 1e-2) \
            * max(1.0, out_p.float().abs().max().item())
        t_new, old = turns_ms(torch, call, lambda: call("wmma"))
        exact = torch.equal(out_k, call()) and (
            call("wmma").float() - out_p.float()).abs().max().item() <= tol
        record(linear_bias_act, f"{m}x{k}->{n},{act} (shard)", out_k, out_p,
               tol, (t_new, host_us(torch, call)),
               time_ms(torch, lambda: linear_bias_act.plain(x, w, b, act)),
               time_ms(torch, lib),
               2 * (m * k + k * n) + (4 if partial else 2) * m * n
               + (0 if partial else 4 * n), 2 * m * n * k,
               paths=list(TP_PATHS), exact=exact, old_ms=old,
               variant="skinny_partial" if partial else "skinny")

    # K2 (the cluster kernel: keys split across a thread-block cluster) at
    # the rows the paths give it: self at pos 300 of T = 512 at B = 32, at
    # the 4 rows greedy_bf16 runs after compaction and at B = 1 (streamed);
    # cross over ragged memory at B = 32 (M = 512) and at 4 and 8 rows
    # (M = 1,024); grouped at B = 32, G = 4 (beams) and at GRPO's 128 rows,
    # G = 8. Each against its twin; timed in turns with the simt kernel it
    # replaced (held to the twin too); from HBM beside SDPA from HBM; two
    # runs bit-equal; split 1 within the tolerance of the plan's split. Bound:
    # the cache rows read once (once per group), only attended keys.
    bsz, t, pos, e, h = 32, 512, 300, 1024, 16
    dh = e // h
    nan_failures = []

    def k2_case(case, q_in, caches, kw, lib, lib_args, nbytes, nops,
                paths=None):
        twin = [a.clone() for a in caches]
        call = lambda v=None: decode_attention(q_in, *caches, h, variant=v,
                                               **kw)
        out_k = call()
        out_p = decode_attention.plain(q_in, *twin, h, **kw)
        tol = 1e-2 * max(1.0, out_p.float().abs().max().item())
        near = lambda a, b_: (a.float() - b_.float()).abs().max().item() \
            <= tol
        exact = (all(torch.equal(a, b_) for a, b_ in zip(caches, twin))
                 and torch.equal(out_k, call()) and near(call("simt"), out_p)
                 and near(call("split1"), out_k))
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        q_l, *kv_l = lib_args
        record(decode_attention, case, out_k, out_p, tol,
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: decode_attention.plain(q_in, *twin, h,
                                                             **kw)),
               time_ms(torch, lambda: lib(q_l, *kv_l)), nbytes, nops,
               paths=paths, exact=exact, old_ms=old,
               cold=cold_ms(torch, lambda *c: decode_attention(
                   q_in, *c, h, **kw), list(caches)),
               lib_cold=cold_ms(torch, lambda *c: lib(q_l, *c), kv_l))
        return out_k

    heads = lambda a, n: a.view(a.shape[0], n, h, dh).transpose(1, 2)
    sdpa = F.scaled_dot_product_attention

    def self_case(qkv_, kc_, vc_, paths=None):
        b_ = qkv_.shape[0]
        lib_args = (heads(qkv_[:, :e].contiguous(), 1),
                    *(heads(a[:, : pos + 1].contiguous(), pos + 1)
                      for a in (kc_, vc_)))
        return k2_case(f"self B={b_} T={t} pos={pos} E={e} H={h}", qkv_,
                       (kc_, vc_), {"pos": pos}, sdpa, lib_args,
                       2 * (b_ * 3 * e + 2 * b_ * pos * e + 2 * b_ * e
                            + b_ * e), 4 * b_ * e * (pos + 1), paths)

    def cross_case(qc_, mk_, mv_, valid_, grp_=1, paths=None):
        b_, m_ = qc_.shape[0], mk_.shape[1]
        bu_ = b_ // grp_
        bias_ = torch.where(valid_, 0.0, -1e9).float().contiguous()
        n_val = int(valid_.sum())  # padded memory rows add nothing
        mask = valid_[:, None, None, :]
        q_l = qc_.view(bu_, grp_, h, dh).transpose(1, 2)
        lib = lambda q_, k_, v_: sdpa(q_, k_, v_, attn_mask=mask)
        name = "cross" if grp_ == 1 else f"cross grouped G={grp_}"
        return k2_case(f"{name} B={b_} M={m_} E={e} H={h}", qc_, (mk_, mv_),
                       {"bias": bias_, "mem_group": grp_}, lib,
                       (q_l, heads(mk_, m_), heads(mv_, m_)),
                       2 * (2 * b_ * e + 2 * n_val * e) + 4 * bu_ * m_,
                       4 * e * n_val * grp_, paths)

    qkv = randn(bsz, 3 * e)
    kc, vc = randn(bsz, t, e), randn(bsz, t, e)
    self_case(qkv, kc, vc)
    m_len = 512
    qc = randn(bsz, e)
    mk, mv = randn(bsz, m_len, e), randn(bsz, m_len, e)
    lens = torch.randint(64, m_len + 1, (bsz,), generator=g, device=dev)
    valid = torch.arange(m_len, device=dev)[None, :] < lens[:, None]
    mbias = torch.where(valid, 0.0, -1e9).float().contiguous()
    n_valid = int(valid.sum())
    cross_case(qc, mk, mv, valid)
    # grouped: 8 memories shared by G = 4 consecutive rows each
    grp = 4
    bu = bsz // grp
    mbias_g = mbias[:bu].contiguous()
    n_valid_g = int(valid[:bu].sum())
    cross_case(qc, mk[:bu].contiguous(), mv[:bu].contiguous(), valid[:bu],
               grp, ["beam_bf16"])

    # the rows the paths run most (their own generator: the cases above and
    # K6's below keep their inputs)
    g2 = torch.Generator(device=dev).manual_seed(SEED + 5)
    randn2 = lambda *s_: torch.randn(*s_, generator=g2, device=dev).to(bf)
    for rows, paths in ((4, ["greedy_bf16"]), (1, ["streamed"])):
        qkv_r = randn2(rows, 3 * e)
        kc_r, vc_r = randn2(rows, t, e), randn2(rows, t, e)
        out_r = self_case(qkv_r, kc_r, vc_r, paths)
        if rows == 4:  # the keys at and past pos carry NaN: nothing changes
            kc_n, vc_n = kc_r.clone(), vc_r.clone()
            kc_n[:, pos:], vc_n[:, pos:] = float("nan"), float("nan")
            nan_ok = torch.equal(decode_attention(qkv_r, kc_n, vc_n, h,
                                                  pos=pos), out_r)
            print(f"[kernel] decode_attention[self B=4 NaN past pos] equal "
                  f"to the finite case: {nan_ok}", flush=True)
            nan_failures.extend([] if nan_ok else ["decode_attention NaN"])
    m_big = 1024
    mk_r, mv_r = randn2(8, m_big, e), randn2(8, m_big, e)
    lens_r = torch.randint(128, m_big + 1, (8,), generator=g2, device=dev)
    valid_r = torch.arange(m_big, device=dev)[None, :] < lens_r[:, None]
    qc_r = randn2(8, e)
    for rows in (4, 8):
        cross_case(qc_r[:rows].contiguous(), mk_r[:rows].contiguous(),
                   mv_r[:rows].contiguous(), valid_r[:rows], 1,
                   ["greedy_bf16"])
    # GRPO's rollouts: 16 images x 8 rollouts over their memories
    lens_g = torch.randint(128, m_big + 1, (16,), generator=g2, device=dev)
    valid_gr = torch.arange(m_big, device=dev)[None, :] < lens_g[:, None]
    cross_case(randn2(128, e), randn2(16, m_big, e), randn2(16, m_big, e),
               valid_gr, 8, ["train_grpo"])

    # K5 (the cluster kernel: one launch, K split across a thread-block
    # cluster, 64 or 128 columns a block as quant8_plan says, the rows
    # quantized in the kernel): the W8A8 decode products at B = 32 (qkv,
    # ff1 + GELU, ff2), at the rows the paths run (4 and 8 rows on int8, 16
    # on beam_int8) and at the tp = 2 shards of tp2_int8_w8a8 (ACAI_TP_W8A8:
    # the column-parallel qkv / ff1 and the row-parallel partials, fp32 and
    # no bias, rows quantized over the rank's half of the contraction axis).
    # Each equal to the twin bit for bit, two runs bit-equal; timed in turns
    # with the three-launch form it replaced (``variant="simt"``, within two
    # bf16 ulps of the twin, 1e-5 of the largest value for a partial), warm
    # and from HBM, the host us a call of both. A case counts the launches
    # of its kind on its paths: "split{s}", or the partials'
    # "partial_split{s}". Bound: the int8 weight bytes with the rows,
    # scales, bias and output. library_ms: torch._int_mm on pre-quantized
    # rows, the bare int8 product only (it takes more than 16 rows)
    step4 = [(1024, 3072, "none"), (1024, 1024, "none"),
             (1024, 4096, "gelu_rounded"), (4096, 1024, "none")]
    k5_cases = (
        [(32, k_, n_, a_, ["int8", "beam_int8"]) for k_, n_, a_ in
         ((1024, 3072, "none"), (1024, 4096, "gelu_rounded"),
          (4096, 1024, "none"))]
        + [(r_, k_, n_, a_, ["int8"]) for r_ in (4, 8)
           for k_, n_, a_ in step4]
        + [(16, k_, n_, a_, ["beam_int8"]) for k_, n_, a_ in
           ((1024, 3072, "none"), (4096, 1024, "none"))]
        + [(8, k_, n_, a_, ["tp2_int8_w8a8"]) for k_, n_, a_ in
           ((1024, 1536, "none"), (1024, 2048, "gelu_rounded"),
            (512, 1024, "partial"), (2048, 1024, "partial"))])
    for m, k, n, act, k5_paths in k5_cases:
        partial = act == "partial"
        x = randn(m, k)
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        s_col = (torch.rand(n, generator=g, device=dev) * 4e-4 + 1e-4) \
            .to(bf).float()
        b = None if partial else randn(n, dtype=torch.float32) * 0.1
        w4 = pack_k4(w8)
        call = lambda v=None, w_=w4: quant_linear_bias_act(x, w_, s_col, b,
                                                           act, variant=v)
        out_k = call()
        out_p = quant_linear_bias_act.plain(x, w4, s_col, b, act)
        tol_old = (1e-5 if partial else TWO_BF16_ULPS) \
            * max(1.0, out_p.float().abs().max().item())
        exact = torch.equal(out_k, out_p) and torch.equal(out_k, call()) \
            and (call("simt").float() - out_p.float()).abs().max().item() \
            <= tol_old
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        x8 = quantize_activation_rows(x)[0].to(torch.int8)
        shard = k5_paths == ["tp2_int8_w8a8"]
        record(quant_linear_bias_act,
               f"{m}x{k}->{n},{act}" + (" (shard)" if shard else "")
               + (" (library: _int_mm, bare product)" if m > 16 else ""),
               out_k, out_p, 0.0, (t_new, host_us(torch, call)),
               time_ms(torch, lambda: quant_linear_bias_act.plain(
                   x, w4, s_col, b, act)),
               time_ms(torch, lambda: torch._int_mm(x8, w8)) if m > 16
               else None,
               k * n + 2 * m * k + (4 if partial else 2) * m * n
               + (4 if partial else 8) * n, 2 * m * n * k,
               peak=PEAK_INT8_OP_PER_S, paths=k5_paths, exact=exact,
               old_ms=old, variant="partial_split" if partial else "split",
               cold=cold_ms(torch, lambda w_: call(None, w_), [w4]),
               extra={"old_cold_ms": cold_ms(torch,
                                             lambda w_: call("simt", w_),
                                             [w4]),
                      "old_host_us": host_us(torch, lambda: call("simt"))})

    # K14 (the cluster kernel: one launch, K split across a thread-block
    # cluster, rows quantized in the kernel): the W4A8 decode products at
    # B = 32 and at the 8 rows w4a8 and serve_wsgi run, equal to the twin
    # bit for bit; timed in turns with the three-launch form it replaced
    # (``variant="simt"``, equal to the twin too), warm and from HBM, the
    # host us a call of both. Bound: the packed int4 weight bytes (half of
    # K5's) with the rows, scales and output. library_ms: torch._int_mm on
    # the unpacked int8 weights and pre-quantized rows, the bare product
    # only (it takes more than 16 rows)
    for m, k, n, act in [(32, 1024, 3072, "none"),
                         (32, 1024, 4096, "gelu_rounded"),
                         (32, 4096, 1024, "none"), (8, 1024, 3072, "none"),
                         (8, 1024, 1024, "none"),
                         (8, 1024, 4096, "gelu_rounded"),
                         (8, 4096, 1024, "none")]:
        x = randn(m, k)
        q = torch.randint(-7, 8, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        s_col = (torch.rand(n, generator=g, device=dev) * 4e-3 + 1e-3) \
            .to(bf).float()
        b = randn(n, dtype=torch.float32) * 0.1
        wp = pack_k8_int4(q)
        call = lambda v=None, w_=wp: quant4_linear_bias_act(x, w_, s_col, b,
                                                            act, variant=v)
        out_k = call()
        out_p = quant4_linear_bias_act.plain(x, wp, s_col, b, act)
        x8 = quantize_activation_rows(x)[0].to(torch.int8)
        exact = torch.equal(out_k, out_p) and torch.equal(out_k, call()) \
            and torch.equal(call("simt"), out_p)
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        record(quant4_linear_bias_act,
               f"{m}x{k}->{n},{act} (library: _int_mm on the unpacked int8 "
               f"weights, bare product)", out_k, out_p, 0.0,
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: quant4_linear_bias_act.plain(
                   x, wp, s_col, b, act)),
               time_ms(torch, lambda: torch._int_mm(x8, q)) if m > 16
               else None,
               k * n // 2 + 2 * m * k + 2 * m * n + 8 * n, 2 * m * n * k,
               peak=PEAK_INT8_OP_PER_S, paths=["w4a8", "serve_wsgi"],
               exact=exact, old_ms=old,
               cold=cold_ms(torch, lambda w_: call(None, w_), [wp]),
               extra={"old_cold_ms": cold_ms(torch,
                                             lambda w_: call("simt", w_),
                                             [wp]),
                      "old_host_us": host_us(torch, lambda: call("simt"))})

    # K6 (the cluster kernel: keys split across a thread-block cluster, a
    # cluster per up to 8 queries of a grouped memory): int8 caches with
    # bf16 scales, self at pos 300 / 0 and cross / grouped at B = 32, then
    # the rows the paths run (self at 4 rows; cross at 4 and 8 rows over
    # M = 1,024; beams B = 16, G = 4; GRPO's 128 rollouts over int8 caches,
    # G = 8, a kernel row). Each against its twin (appends bit-equal, output
    # within two bf16 ulps), two runs bit-equal, split 1 and the simt kernel
    # it replaced within the tolerance; timed in turns with the simt kernel,
    # warm and from HBM. Bound: the int8 K/V bytes plus the scale bytes of
    # the keys attended to (once per group). No library call computes this
    def int8_cache(rows, length, gen=g):
        c = torch.randint(-127, 128, (rows, length, e), generator=gen,
                          device=dev, dtype=torch.int8)
        sc = (torch.rand(rows, length, h, generator=gen, device=dev) * 3e-2
              + 2e-3).to(bf)
        return c, sc

    def int8_case(case, q_in, caches, paths, nbytes, nops, **kw):
        twin = [a.clone() for a in caches]
        call = lambda v=None, *cs: decode_attention_int8(
            q_in, *(cs or caches), h, variant=v, **kw)
        out_k = call()
        out_p = decode_attention_int8.plain(q_in, *twin, h, **kw)
        tol = TWO_BF16_ULPS * max(1.0, out_p.float().abs().max().item())
        near = lambda a: (a.float() - out_p.float()).abs().max().item() <= tol
        exact = (all(torch.equal(a, b) for a, b in zip(caches, twin))
                 and torch.equal(out_k, call()) and near(call("simt"))
                 and near(call("split1")))
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        record(decode_attention_int8, case, out_k, out_p, tol,
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: decode_attention_int8.plain(
                   q_in, *twin, h, **kw)),
               None, nbytes, nops, peak=PEAK_INT8_OP_PER_S, paths=paths,
               exact=exact, old_ms=old,
               cold=cold_ms(torch, lambda *c: call(None, *c), list(caches)),
               extra={"old_cold_ms": cold_ms(
                   torch, lambda *c: call("simt", *c), list(caches))})

    def int8_self(qkv_, p_at, paths, gen=g):
        b_ = qkv_.shape[0]
        (kc8, ks8), (vc8, vs8) = int8_cache(b_, t, gen), int8_cache(b_, t, gen)
        int8_case(f"self B={b_} T={t} pos={p_at} E={e} H={h}", qkv_,
                  (kc8, vc8, ks8, vs8), paths,
                  2 * b_ * p_at * (e + 2 * h) + 2 * b_ * (3 * e + e)
                  + 2 * b_ * (e + 2 * h), 4 * b_ * e * (p_at + 1), pos=p_at)

    def int8_cross(qc_, mk8, mv8, mks8, mvs8, valid_, grp_, paths):
        b_, bu_, m_ = qc_.shape[0], mk8.shape[0], mk8.shape[1]
        n_val = int(valid_.sum())  # padded memory rows add nothing
        name = "cross" if grp_ == 1 else f"cross grouped G={grp_}"
        int8_case(f"{name} B={b_} M={m_} E={e} H={h}", qc_,
                  (mk8, mv8, mks8, mvs8), paths,
                  2 * n_val * (e + 2 * h) + 2 * 2 * b_ * e + 4 * bu_ * m_,
                  4 * e * n_val * grp_,
                  bias=torch.where(valid_, 0.0, -1e9).float().contiguous(),
                  mem_group=grp_)

    for p_at in (300, 0):
        int8_self(qkv, p_at, None)
    (mk8, mks8), (mv8, mvs8) = int8_cache(bsz, m_len), int8_cache(bsz, m_len)
    int8_cross(qc, mk8, mv8, mks8, mvs8, valid, 1, ["int8"])
    int8_cross(qc, *(a[:bu].contiguous() for a in (mk8, mv8, mks8, mvs8)),
               valid[:bu], grp, ["beam_int8"])
    # the rows the paths run (their own generator: the cases above keep
    # their inputs)
    g3 = torch.Generator(device=dev).manual_seed(SEED + 6)
    randn3 = lambda *s_: torch.randn(*s_, generator=g3, device=dev).to(bf)
    int8_self(randn3(4, 3 * e), pos, ["int8", "w4a8", "int8_bf16w"], g3)
    (mk8, mks8), (mv8, mvs8) = int8_cache(16, m_big, g3), \
        int8_cache(16, m_big, g3)
    qc3 = randn3(128, e)
    for rows in (4, 8):
        int8_cross(qc3[:rows].contiguous(),
                   *(a[:rows].contiguous() for a in (mk8, mv8, mks8, mvs8)),
                   valid_gr[:rows], 1, ["int8", "w4a8", "int8_bf16w"])
    int8_cross(qc3[:16].contiguous(),
               *(a[:4].contiguous() for a in (mk8, mv8, mks8, mvs8)),
               valid_gr[:4], 4, ["beam_int8"])
    # GRPO's 16 images x 8 rollouts over int8 caches (no path runs it: the
    # GRPO path decodes with bf16 caches); its launches are beam_int8's,
    # the grouped mode's path
    int8_cross(qc3, mk8, mv8, mks8, mvs8, valid_gr, 8, ["beam_int8"])

    # K3: B=16, T=1024, E=768, H=12, ragged validity; the Hopper kernel
    # timed in turns with the wmma kernel it replaces (held to the twin too),
    # two runs of the new one bit-equal
    bsz, t, e, h = 16, 1024, 768, 12
    dh = e // h
    qkv = randn(bsz * t, 3 * e)
    lens = torch.randint(128, t + 1, (bsz,), generator=g, device=dev)
    valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    call = lambda v="sm90": encoder_attention(qkv, valid, h, variant=v)
    out_k = call()
    out_p = encoder_attention.plain(qkv, valid, h)
    exact = torch.equal(out_k, call()) and (
        call("wmma").float() - out_p.float()).abs().max().item() <= 1e-2
    q5 = qkv.view(bsz, t, 3, h, dh).permute(2, 0, 3, 1, 4)
    q_l, k_l, v_l = (q5[i].contiguous() for i in range(3))
    mask4 = valid[:, None, None, :]
    n_valid = int(valid.sum())  # padded keys add nothing to the output
    t_new, old = turns_ms(torch, call, lambda: call("wmma"))
    record(encoder_attention, f"B={bsz} T={t} E={e} H={h}", out_k, out_p,
           1e-2, (t_new, host_us(torch, call)),
           time_ms(torch, lambda: encoder_attention.plain(qkv, valid, h),
                   iters=5),
           time_ms(torch, lambda: F.scaled_dot_product_attention(
               q_l, k_l, v_l, attn_mask=mask4)),
           2 * (bsz * t * 3 * e + bsz * t * e) + bsz * t,
           4 * e * t * n_valid, exact=exact, variant=f"sm90_dh{dh}",
           old_ms=old)

    # K4: the decode step's rows (4 x 1024 after compaction, 32 x 1024) and
    # encoder rows (16384 x 768), each timed in turns with the scalar kernel
    # it replaced (which must agree with the twin too); the decode rows also
    # from HBM (x, r, gamma and beta rotated out of L2; the kernel, the
    # scalar kernel and F.layer_norm on the same copies)
    for rows, e in [(4, 1024), (32, 1024), (16384, 768)]:
        x, r = randn(rows, e), randn(rows, e)
        gamma = 1.0 + 0.1 * randn(e, dtype=torch.float32)
        beta = 0.1 * randn(e, dtype=torch.float32)
        z = x + r
        g16, b16 = gamma.to(bf), beta.to(bf)
        call = lambda v=None, *a: add_layernorm(*(a or (x, r, gamma, beta)),
                                                1e-5, variant=v)
        out_k = call()
        out_p = add_layernorm.plain(x, r, gamma, beta, 1e-5)
        tol = 1e-2 * max(1.0, out_p.float().abs().max().item())
        scalar_ok = (call("scalar").float()
                     - out_p.float()).abs().max().item() <= tol
        t_new, old = turns_ms(torch, call, lambda: call("scalar"))
        cold = old_cold = lib_cold = None
        if rows <= 32:
            cold = cold_ms(torch, lambda *a: call(None, *a),
                           [x, r, gamma, beta])
            old_cold = cold_ms(torch, lambda *a: call("scalar", *a),
                               [x, r, gamma, beta])
            lib_cold = cold_ms(torch, lambda z_, g_, b_: F.layer_norm(
                z_, (e,), g_, b_, 1e-5), [z, g16, b16])
        record(add_layernorm, f"{rows}x{e}", out_k, out_p, tol,
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: add_layernorm.plain(x, r, gamma, beta,
                                                          1e-5)),
               time_ms(torch, lambda: F.layer_norm(z, (e,), g16, b16, 1e-5)),
               2 * 3 * rows * e + 8 * e, 8 * rows * e,
               exact=None if scalar_ok else False, old_ms=old, cold=cold,
               lib_cold=lib_cold,
               extra=None if old_cold is None else {"old_cold_ms": old_cold})
    nan_failures += decode_hd_cases(torch, F, randn, record, kernel_times,
                                    dev)
    training_cases(torch, F, randn, record, kernel_times, dev)
    # the resource rows of the products', the attentions', K4's, K8's and
    # K15's kernels: the Hopper kernels (sm90, skinny, the cluster kernels
    # of K2, K5, K6, K11-K14, K4's vector kernels, K8's one-pass kernel,
    # K15's one-card form) beside the wmma / simt / scalar / three-launch /
    # exchange kernels they replace; none of those Hopper kernels may use
    # local memory (a spill)
    from acai_omr_tpu_torch.ops import _build
    spills = []
    for name in ("linear_bias_act", "encoder_attention", "linear_bwd",
                 "attention_bwd", "decode_attention", "decode_attention_int8",
                 "decode_attention_hd", "decode_attention_hd_int8",
                 "self_attention_append_int8", "quant_linear",
                 "add_layernorm", "layernorm_bwd", "tp_allreduce"):
        for r in _build.resources(name):
            print(f"[resources] {r['op']} {r['variant'] or '-'} {r['kernel']} "
                  f"regs={r['registers']} local={r['local_bytes']} "
                  f"static_smem={r['static_smem']} "
                  f"dynamic_smem={r['dynamic_smem']} "
                  f"blocks_per_sm={r['blocks_per_sm']}", flush=True)
            hopper = (r["op"] in ("linear_dgrad", "encoder_attention",
                                  "attention_bwd")
                      and r["variant"].startswith("sm90")) \
                or r["variant"] in ("skinny", "split", "local",
                                    "one_pass") \
                or r["variant"].startswith("warps")
            if hopper and r["local_bytes"]:
                spills.append(f"{r['op']} {r['kernel']}")
    k7_bad = k7_bit_failures(torch)
    race_bad = tp_allreduce_cases(torch, randn, record, kernel_times, dev)
    spills += probe_cases(torch, F, record, kernel_times, dev)
    return cases, race_bad, spills, k7_bad + nan_failures


# K7's sites at the training shapes, (name, B, Tq, Tk, E, H, causal,
# cross), and the bits of its sm90 kernels' (dq, dk, dv) there on seeded
# inputs (k7_bits): recorded on an NVIDIA H100 80GB HBM3 from the tree
# before the Hopper attention helpers moved into csrc/attention_sm90.cuh
# (python3 chip_smoke.py --k7-bits), held by every run since
K7_SITES = (("dec self causal", 8, 256, 256, 1024, 16, True, False),
            ("dec cross", 8, 256, 1024, 1024, 16, False, True),
            ("enc self", 8, 1024, 1024, 768, 12, False, False),
            ("mae_dec self", 64, 512, 512, 512, 16, False, False),
            ("mae_enc self", 64, 128, 128, 768, 12, False, False))
K7_BITS = {"dec self causal": "15285ea4ea57886c", "dec cross": "a159b40715b0eb54",
           "enc self": "35384ec4c3db4919", "mae_dec self": "221aba0829d2aa0e",
           "mae_enc self": "e4b9a678e01ea67c"}


def k7_bits(torch) -> dict:
    """sha256 (first 16 hex digits) of the bytes of K7's (dq, dk, dv) at
    each of K7_SITES, inputs from numpy's generator (seed SEED): q, k, v,
    dO standard normal in bf16, each image's valid keys a prefix of half to
    all of them. K7 sums in a fixed order (no atomics), so equal code gives
    equal bits on any H100."""
    import hashlib
    import numpy as np
    from acai_omr_tpu_torch.ops.attention_bwd_kernel import attention_bwd
    from acai_omr_tpu_torch.ops.encoder_stack_kernel import split_qkv
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    bf = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev).to(torch.bfloat16)
    out = {}
    for name, b, tq, tk, e, h, causal, cross in K7_SITES:
        lens = torch.from_numpy(rng.integers(tk // 2, tk + 1, b)).to(dev)
        valid = torch.arange(tk, device=dev)[None, :] < lens[:, None]
        q = bf(b * tq, e if cross else 3 * e)
        kv = bf(b, tk, 2 * e) if cross else None
        q3, k3, v3 = split_qkv(q, kv, b)
        grads = attention_bwd(q3, k3, v3, bf(b, tq, e), valid, h, causal)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for a in grads:
            digest.update(a.contiguous().view(torch.int16).cpu().numpy()
                          .tobytes())
        out[name] = digest.hexdigest()[:16]
    return out


def skinny_splits(torch) -> list:
    """The skinny kernel (K1's decode rows) at every split its plan could
    take (1-8, ranges evened out) at the decode shapes, each from HBM
    (rotating weight copies), beside the plan's own split and the library
    call from HBM: how far ``skinny_plan`` is from the fastest split."""
    import ctypes
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.ops import dropout_kernel as dk
    from acai_omr_tpu_torch.ops import linear_kernel as lk
    dev = torch.device("cuda")
    fn = _build.bind("linear_bias_act", "acai_linear_bias_act_skinny",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + dk.C_ARGTYPES + [ctypes.c_void_p])
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for m, k, n in ((32, 1024, 3072), (32, 1024, 4096), (32, 4096, 1024),
                    (128, 1024, 3072), (128, 4096, 1024), (8, 1024, 1536),
                    (8, 1024, 2048), (8, 2048, 1024), (8, 512, 1024),
                    (8, 256, 1024), (8, 1024, 1024), (8, 1024, 768),
                    (8, 1024, 512), (8, 1024, 256)):
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        b = torch.randn(n, generator=g, device=dev)
        out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
        steps, times = -(-k // lk.SKINNY_BK), {}
        for want in range(1, min(lk.SKINNY_MAX_SPLIT, steps) + 1):
            chunk = -(-steps // want)
            split = -(-steps // chunk)
            if split in times:
                continue
            times[split] = cold_ms(torch, lambda w_, c=chunk, s=split: fn(
                x.data_ptr(), w_.data_ptr(), b.data_ptr(), out.data_ptr(),
                None, m, n, k, c * lk.SKINNY_BK, s, 0,
                *dk.c_args(None), _build.stream_ptr()), [w])
        plan = lk.skinny_plan(m, n, k)[1]
        lib = cold_ms(torch, lambda w_: torch.addmm(b.to(torch.bfloat16), x,
                                                    w_), [w])
        best = min(times, key=times.get)
        rows.append({"shape": [m, k, n], "plan_split": plan,
                     "plan_ms": times[plan], "best_split": best,
                     "best_ms": times[best], "library_cold_ms": lib,
                     "ms_by_split": times})
        print(f"[skinny splits] {m}x{k}->{n} plan split {plan} "
              f"{times[plan]:.4f} ms, best split {best} {times[best]:.4f} ms, "
              f"library {lib:.4f} ms (all from HBM); by split "
              + json.dumps({s_: round(t, 4) for s_, t in times.items()}),
              flush=True)
    return rows


def attn_splits(torch) -> list:
    """K2's and K11's cluster kernels at every split (1-8, forced through
    ``variant="split{s}"``) at the decode shapes the paths run (1-32 rows,
    beams, GRPO's rollouts), each from HBM (rotating copies of the caches /
    memory; two readings, the lesser kept), beside the plan's split: how far
    ``decode_attention_plan`` is from the fastest split."""
    from acai_omr_tpu_torch.ops import decode_kernel as dk
    from acai_omr_tpu_torch.ops.decode_hd_kernel import decode_attention_hd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(
        torch.bfloat16)
    e, h, t, pos = 1024, 16, 512, 300
    dh = e // h

    def ragged(rows, m):
        lens = torch.randint(m // 4, m + 1, (rows,), generator=g, device=dev)
        return torch.where(torch.arange(m, device=dev)[None] < lens[:, None],
                           0.0, -1e9).float().contiguous()

    def k2(q, kw):
        return lambda k_, v_, v: dk.decode_attention(q, k_, v_, h, variant=v,
                                                     **kw)

    def k11(q, bias, kw):
        return lambda k_, v_, v: decode_attention_hd(q, k_, v_, bias,
                                                     variant=v, **kw)

    cases = []  # (name, rows, keys, group, call(k, v, variant), [k, v])
    for p_at, rows in ((300, 1), (300, 2), (300, 4), (300, 8), (300, 16),
                       (300, 32), (100, 4), (100, 8), (500, 4)):  # K2 self
        cases.append((f"decode_attention self B={rows} pos={p_at}", rows,
                      p_at, 1, k2(randn(rows, 3 * e), {"pos": p_at}),
                      [randn(rows, t, e), randn(rows, t, e)]))
    for rows, m, grp in ((1, 1024, 1), (4, 1024, 1), (8, 1024, 1),
                         (16, 1024, 1), (8, 512, 1), (32, 512, 1),
                         (16, 512, 4), (64, 1024, 8),
                         (128, 1024, 8)):  # K2 cross and grouped
        bu = rows // grp
        cases.append((f"decode_attention cross B={rows} G={grp} M={m}", rows,
                      m, grp, k2(randn(rows, e), {"bias": ragged(bu, m),
                                                  "mem_group": grp}),
                      [randn(bu, m, e), randn(bu, m, e)]))
    for rows in (4, 8, 32):  # K11 self and cross
        cases.append((f"decode_attention_hd self B={rows} pos={pos}", rows,
                      pos + 1, 1, k11(randn(rows, h, dh), None,
                                      {"n_keys": pos + 1}),
                      [randn(rows, h, dh, t), randn(rows, h, dh, t)]))
        cases.append((f"decode_attention_hd cross B={rows} M=1024", rows,
                      1024, 1, k11(randn(rows, h, dh), ragged(rows, 1024), {}),
                      [randn(rows, h, dh, 1024), randn(rows, h, dh, 1024)]))
    out = []
    for name, rows, n_keys, grp, fn, kv in cases:
        # each split twice, in rising then falling order; the lesser reading
        times = {}
        order = list(range(1, dk.ATTN_MAX_SPLIT + 1))
        for s_ in order + order[::-1]:
            ms = cold_ms(torch, lambda k_, v_, v=f"split{s_}": fn(k_, v_, v),
                         kv)
            times[s_] = min(times.get(s_, ms), ms)
        plan = dk.decode_attention_plan(rows, h, n_keys, grp)[1]
        best = min(times, key=times.get)
        out.append({"case": name, "plan_split": plan,
                    "plan_ms": times[plan], "best_split": best,
                    "best_ms": times[best], "ms_by_split": times})
        print(f"[attn splits] {name} plan split {plan} {times[plan]:.4f} ms, "
              f"best split {best} {times[best]:.4f} ms (from HBM); by split "
              + json.dumps({s_: round(t_, 4) for s_, t_ in times.items()}),
              flush=True)
    return out


def int8_splits(torch) -> list:
    """K6's, K12's, K14's and K5's cluster kernels at every split (1-8,
    forced through ``variant="split{s}"``; K5 also at 64 and 128 columns a
    block, ``"bn{B}_split{s}"``) at the shapes the int8 paths run (K6: self
    at 1-32 rows, cross at 4-32 rows, beams, GRPO's rollouts over int8
    caches; K12: the per-op step's stacked cross-attention at 4 and 32 rows;
    K14: the W4A8 products at 8 and 32 rows; K5: the W8A8 products at 4, 8,
    16 and 32 rows and the tp = 2 shards' partials), each from HBM
    (rotating copies of the caches / weights; two readings, the lesser
    kept), beside the plan's choice: how far ``decode_attention_int8_plan``,
    ``quant4_plan`` and ``quant8_plan`` are from the fastest."""
    from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
    from acai_omr_tpu_torch.ops import decode_kernel as dk
    from acai_omr_tpu_torch.ops import quant_linear_kernel as qk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(
        torch.bfloat16)
    e, h, t, pos = 1024, 16, 512, 300
    splits = [f"split{s_}" for s_ in range(1, 9)]

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def sc(*shape):
        return (torch.rand(*shape, generator=g, device=dev) * 3e-2
                + 2e-3).to(torch.bfloat16)

    def ragged(rows, m):
        lens = torch.randint(m // 4, m + 1, (rows,), generator=g, device=dev)
        return torch.where(torch.arange(m, device=dev)[None] < lens[:, None],
                           0.0, -1e9).float().contiguous()

    def k6(q, kw):
        return lambda v, *c: dk.decode_attention_int8(q, *c, h, variant=v,
                                                      **kw)

    # (name, the plan's variant, the variants timed, call(variant,
    # *operands), operands)
    cases = []
    for rows in (1, 4, 8, 32):
        cases.append((f"decode_attention_int8 self B={rows} pos={pos}",
                      f"split{dk.decode_attention_int8_plan(rows, h, pos)[1]}",
                      splits, k6(randn(rows, 3 * e), {"pos": pos}),
                      [i8(rows, t, e), i8(rows, t, e), sc(rows, t, h),
                       sc(rows, t, h)]))
    for rows, m, grp in ((4, 1024, 1), (8, 1024, 1), (32, 512, 1),
                         (32, 512, 4), (16, 1024, 4), (128, 1024, 8)):
        bu = rows // grp
        cases.append((f"decode_attention_int8 cross B={rows} G={grp} M={m}",
                      "split"
                      f"{dk.decode_attention_int8_plan(rows, h, m, grp)[1]}",
                      splits, k6(randn(rows, e), {"bias": ragged(bu, m),
                                                  "mem_group": grp}),
                      [i8(bu, m, e), i8(bu, m, e), sc(bu, m, h),
                       sc(bu, m, h)]))
    for rows in (4, 32):  # one layer's planes, a one-layer stack
        dh, m = e // h, 1024
        q = randn(rows, h, dh)
        bias = ragged(rows, m)
        cases.append((f"decode_attention_hd_int8 stacked B={rows} M={m}",
                      f"split{dk.decode_attention_int8_plan(rows, h, m)[1]}",
                      splits,
                      lambda v, *c, q=q, bias=bias: hd.decode_attention_hd_int8(
                          q, *c, bias, layer=0, variant=v),
                      [i8(1, rows, h, dh, m), i8(1, rows, h, dh, m),
                       torch.rand(1, rows, h, m, generator=g, device=dev)
                       * 3e-2 + 2e-3,
                       torch.rand(1, rows, h, m, generator=g, device=dev)
                       * 3e-2 + 2e-3]))
    for m, k, n, act in ((32, 1024, 3072, "none"),
                         (32, 1024, 4096, "gelu_rounded"),
                         (32, 4096, 1024, "none"), (8, 1024, 3072, "none"),
                         (8, 1024, 1024, "none"), (8, 4096, 1024, "none")):
        x = randn(m, k)
        s_col = torch.rand(n, generator=g, device=dev) * 4e-3 + 1e-3
        b = torch.randn(n, generator=g, device=dev)
        wp = qk.pack_k8_int4(torch.randint(-7, 8, (k, n), generator=g,
                                           device=dev))
        cases.append((f"quant4_linear_bias_act {m}x{k}->{n},{act}",
                      f"split{qk.quant4_plan(m, n, k)[1]}", splits,
                      lambda v, w_, x=x, s_col=s_col, b=b, act=act:
                      qk.quant4_linear_bias_act(x, w_, s_col, b, act,
                                                variant=v), [wp]))
    for m, k, n, act in ((32, 1024, 3072, "none"),
                         (32, 1024, 4096, "gelu_rounded"),
                         (32, 4096, 1024, "none"), (4, 1024, 3072, "none"),
                         (4, 1024, 1024, "none"), (4, 4096, 1024, "none"),
                         (8, 1024, 3072, "none"), (8, 1024, 1024, "none"),
                         (8, 4096, 1024, "none"), (16, 1024, 3072, "none"),
                         (16, 4096, 1024, "none"), (8, 512, 1024, "partial"),
                         (8, 2048, 1024, "partial")):
        x = randn(m, k)
        s_col = torch.rand(n, generator=g, device=dev) * 4e-4 + 1e-4
        b = None if act == "partial" else torch.randn(n, generator=g,
                                                      device=dev)
        _, split, bn = qk.quant8_plan(m, n, k)
        cases.append((f"quant_linear_bias_act {m}x{k}->{n},{act}",
                      f"bn{bn}_split{split}",
                      [f"bn{bn_}_{v}" for bn_ in qk.Q8_BNS for v in splits],
                      lambda v, w_, x=x, s_col=s_col, b=b, act=act:
                      qk.quant_linear_bias_act(x, w_, s_col, b, act,
                                               variant=v),
                      [qk.pack_k4(i8(k, n))]))
    out = []
    for name, plan, keys, fn, ops in cases:
        times = {}
        for v_ in keys + keys[::-1]:
            try:
                ms = cold_ms(torch, lambda *c, v=v_: fn(v, *c), ops)
            except ValueError:  # K5 / K14: a block's range past its
                continue        # shared memory
            times[v_] = min(times.get(v_, ms), ms)
        best = min(times, key=times.get)
        out.append({"case": name, "plan": plan, "plan_ms": times[plan],
                    "best": best, "best_ms": times[best],
                    "ms_by_variant": times})
        print(f"[int8 splits] {name} plan {plan} {times[plan]:.4f} ms, "
              f"best {best} {times[best]:.4f} ms (from HBM); by variant "
              + json.dumps({v_: round(t_, 4) for v_, t_ in times.items()}),
              flush=True)
    return out


def k4_plan(torch) -> list:
    """K4's vector kernel at 1 and 4 warps a row (forced through
    ``variant="warps{W}"``) and the scalar kernel it replaced, at the rows
    the paths run (the decode step's 1-32 rows of E = 1024, beams and GRPO's
    rollouts up to 128, the encoder's and the training stacks' rows), each
    in turns (rising, then falling order; the lesser of two readings), warm
    and, up to 128 rows, from HBM (x, r, gamma and beta rotated out of L2),
    beside the plan's choice: how far ``add_layernorm_plan`` is from the
    fastest variant."""
    from acai_omr_tpu_torch.ops.layernorm_kernel import (add_layernorm,
                                                         add_layernorm_plan)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    variants = ["warps1", "warps4", "scalar"]
    for rows, e in ((1, 1024), (4, 1024), (8, 1024), (16, 1024), (32, 1024),
                    (64, 1024), (128, 1024), (512, 1024), (1024, 1024),
                    (2048, 1024), (16384, 768),
                    (8192, 768), (32768, 512)):
        ops = [torch.randn(rows, e, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2)]
        ops += [1 + 0.1 * torch.randn(e, generator=g, device=dev),
                0.1 * torch.randn(e, generator=g, device=dev)]
        fn = lambda v, *a: add_layernorm(*a, 1e-5, variant=v)
        row = {"rows": rows, "e": e, "plan": add_layernorm_plan(rows, e)}
        for kind in ("warm", "cold") if rows <= 128 else ("warm",):
            times = {}
            for v in variants + variants[::-1]:
                ms = time_ms(torch, lambda v=v: fn(v, *ops)) \
                    if kind == "warm" else \
                    cold_ms(torch, lambda *a, v=v: fn(v, *a), ops)
                times[v] = min(times.get(v, ms), ms)
            best = min(times, key=times.get)
            row[kind] = times
            print(f"[k4 plan] {rows}x{e} {kind}: plan {row['plan']} "
                  f"{times[row['plan']]:.4f} ms, best {best} "
                  f"{times[best]:.4f} ms; "
                  + json.dumps({v: round(t_, 4) for v, t_ in times.items()}),
                  flush=True)
        out.append(row)
    return out


def k27_plan(torch) -> list:
    """K27's plan kernel at the tool's softmax and ln shapes, at the layout
    ``resident_plan`` takes for these rows and at the layout it takes on the
    other side of its row threshold (forced through ``variant="<L>x<V>[
    smem]"``), in turns (rising, then falling order; the lesser of two
    readings): ns a pass from the 200- and 400-pass launches, where the
    launch's fixed cost cancels. Where both sides take one layout there is
    nothing to compare."""
    from acai_omr_tpu_torch.ops import vpu_probe_kernels as vk
    from acai_omr_tpu_torch.ops.linear_kernel import N_SMS
    from acai_omr_tpu_torch.tools import vpu_probe as vpp
    dev = torch.device("cuda")

    def layout(rows, cols, work):
        lanes, values, _, smem = vk.resident_plan(rows, cols, work)
        return f"{lanes}x{values}" + (" smem" if smem else "")
    out = []
    for work in ("softmax", "ln"):
        for rows, cols in vpp.SHAPES[work]:
            plan = layout(rows, cols, work)
            layouts = list(dict.fromkeys(
                [plan] + [layout(r, cols, work)
                          for r in (2 * N_SMS, 2 * N_SMS + 1)]))
            x = vpp.make_block(rows, cols, dev)
            times = {}
            for v in layouts + layouts[::-1]:
                t1, t2 = (time_ms(torch, lambda n=n, v=v:
                                  vk.resident_elementwise(x, work, n,
                                                          variant=v))
                          for n in (200, 400))
                ns = (t2 - t1) / 200 * 1e6
                times[v] = min(times.get(v, ns), ns)
            best = min(times, key=times.get)
            out.append({"work": work, "rows": rows, "cols": cols,
                        "plan": plan, "ns_per_pass": times})
            print(f"[k27 plan] {work} {rows}x{cols}: plan {plan} "
                  f"{times[plan]:.1f} ns a pass, best {best} "
                  f"{times[best]:.1f}; "
                  + json.dumps({v: round(t_, 1) for v, t_ in times.items()}),
                  flush=True)
    return out


def k7_bit_failures(torch) -> list:
    """K7's bits at its training sites against the recorded K7_BITS."""
    got = k7_bits(torch)
    print(f"[k7 bits] {json.dumps(got)} recorded {json.dumps(K7_BITS)}",
          flush=True)
    return [f"attention_bwd[{n}] bits differ from the recorded ones"
            for n in got if got[n] != K7_BITS.get(n)]


def tp_allreduce_cases(torch, randn, record, kernel_times, dev):
    """K15 against its twin at the meshed decode's shapes, E = 1024, every
    rank of the group on this card: the monolith step's mode (fp32 partials,
    the fp32 bias after the sum) at tp = 2 and 4 with B = 32 and 128 (greedy
    and beams of 4 x 32 rows), out bf16 and fp32, and at the rows the meshed
    paths give it, out bf16: B = 8 (tp2 / tp4), 4 (a dp2_tp2 shard), 16
    (tp2_beam); the per-op step's mode (bf16 partials, the running sum
    rounded after every round, no bias) at B = 8, tp = 2 and 4. Every case
    runs the one-card form ("local") and is timed in turns with the exchange
    it replaced on one card (``variant="coop"``, ``old_ms``), with the host
    time of a call of each (``host_us``, ``old_host_us``); both equal to the
    twin in every bit on every rank. Then, for each form, RACE_CALLS
    back-to-back calls with fresh inputs (tp = 2 and 4 in turns, both
    modes), every one bit-equal to the twin: a stale slot or flag, or a
    store landing in another call's output, would show here. Bound: the
    partials read once, the outputs written once, the bias read once per
    rank. Library call: ``torch.stack(parts).sum(0)``, one rank's sum
    without the bias. Returns the race checks' calls that differ."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    f32, bf, e = torch.float32, torch.bfloat16, 1024
    groups = {tp: TPGroup([dev] * tp) for tp in (2, 4)}
    shapes = [(tp, b, f32, out) for tp in (2, 4) for b in (32, 128)
              for out in (bf, f32)]
    shapes += [(2, 8, f32, bf), (4, 8, f32, bf), (2, 4, f32, bf),
               (2, 16, f32, bf), (2, 8, bf, bf), (4, 8, bf, bf)]
    same = lambda got, want: all(torch.equal(g, w) for g, w in zip(got, want))
    for tp, b, in_dtype, out_dtype in shapes:
        parts = [randn(b, e, dtype=in_dtype) for _ in range(tp)]
        bias = [randn(e, dtype=f32) * 0.1] * tp if in_dtype == f32 else None
        call = lambda v=None: tp_allreduce(parts, groups[tp], bias, out_dtype,
                                           variant=v)
        coop = lambda: call("coop")
        twin = lambda: tp_allreduce.plain(parts, groups[tp], bias, out_dtype)
        got, want = call(), twin()
        exact = same(got, want) and same(coop(), want)
        t_new, old = turns_ms(torch, call, coop)
        name = lambda d: str(d).split(".")[-1]
        record(tp_allreduce, f"tp={tp} B={b} E={e} {name(in_dtype)}->"
               f"{name(out_dtype)}", torch.cat(got), torch.cat(want), 0.0,
               (t_new, host_us(torch, call)), time_ms(torch, twin),
               time_ms(torch, lambda: torch.stack(parts).sum(0)),
               tp * b * e * (in_dtype.itemsize + out_dtype.itemsize)
               + (tp * e * 4 if bias else 0),
               tp * tp.bit_length() * b * e,  # rounds' adds + bias
               peak=PEAK_FP32_FLOP_PER_S, paths=list(TP_PATHS), exact=exact,
               variant="local", old_ms=old,
               extra={"old_host_us": host_us(torch, coop)})
    # the race checks: many calls queued at once, compared after
    bad = 0
    for form in ("local", "coop"):
        calls = []
        for i in range(RACE_CALLS):
            tp = 2 if i % 2 else 4
            dt = torch.bfloat16 if i % 3 == 0 else f32
            parts = [randn((4, 8, 16, 32, 128)[i % 5], e, dtype=dt)
                     for _ in range(tp)]
            bias = None if dt == torch.bfloat16 else \
                [randn(e, dtype=f32) * 0.1] * tp
            calls.append((parts, tp, bias, tp_allreduce(
                parts, groups[tp], bias, torch.bfloat16, variant=form)))
        torch.cuda.synchronize()
        n_bad = sum(not same(got, tp_allreduce.plain(parts, groups[tp], bias,
                                                     torch.bfloat16))
                    for parts, tp, bias, got in calls)
        print(f"[kernel] tp_allreduce race check ({form}): {RACE_CALLS} "
              f"back-to-back calls, {n_bad} differ from the twin "
              + ("ok" if n_bad == 0 else "FAIL"), flush=True)
        bad += n_bad
    return bad


def probe_cases(torch, F, record, kernel_times, dev):
    """The probes phase, its kernels against their twins at the shapes the
    probe tools give them. K16 ``tile_gemm``: every tile of the sweep (bf16
    out, within 1e-2 of the largest output: one bf16 ulp is 0.4-0.8% of it)
    at (8192, 768, 3072), (32768, 512, 1536) and (32768, 512, 3072), and the
    dot forms (fp32 out, within 1e-5 of the largest output: fp32 sums in
    another order) at the JAX script's shapes (tile 64x64x32) and at
    (8192, 768, 3072) (tile 128x128x32); library call ``torch.matmul`` of the
    same form, bf16 out, also from HBM; bound 2mkn at the bf16 peak; the
    persistent kernel in turns with the wmma kernel it replaced (held to the
    twin too), warm and from HBM (``old_cold_ms``), two runs bit-equal. K17
    at bt 2 / 4 / 8 (bf16) and 4 / 8 (int8), K18 at bt 4, at the
    microbench's inputs, within 4e-3 absolute (outputs below 0.5: a weight
    rounded to bf16 on the other side of a tie moves an output by one bf16
    ulp); bound: K and V (and the scales) read once; library call SDPA with
    one query (bf16). K17 on its cluster kernel at the plan's split, K18 on
    one block per (row, head), each in turns with the kernel it replaced
    (``"wmma"``, ``"warp"``), warm and from HBM (``old_cold_ms``), two runs
    bit-equal (the replaced kernel within 4e-3 too); K11 on the same inputs
    beside them; K18 also at B = 1 (16 blocks), K11 (its keys split across
    a cluster) beside it (``k11_ms``). K19 at 227 KB: row 0 bit for bit;
    228 KB must be refused. Returns the redesigned kernels' resource rows
    that use local memory."""
    from acai_omr_tpu_torch.ops import probe_kernels as pk
    from acai_omr_tpu_torch.tools import attn_microbench as ab
    from acai_omr_tpu_torch.tools import mosaic_dot_forms_probe as forms
    from acai_omr_tpu_torch.tools import pallas_gemm_probe as pgp

    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    print("[probes] K16-K19 against their twins", flush=True)
    t0 = time.perf_counter()

    def gemm_case(a, b, tile, layout, out_dtype, case):
        # the persistent kernel, timed in turns with the wmma kernel it
        # replaced (held to the twin too), warm and from HBM (the operands
        # rotated out of L2), two runs bit-equal
        m, k, n = pk.gemm_dims(a, b, layout)
        call = lambda v=None: pk.tile_gemm(a, b, tile, layout, out_dtype,
                                           variant=v)
        twin = lambda: pk.tile_gemm.plain(a, b, tile, layout, out_dtype)
        cold_of = lambda v: cold_ms(torch, lambda a_, b_: pk.tile_gemm(
            a_, b_, tile, layout, out_dtype, variant=v), [a, b])
        ref = twin()
        key = (m, k, n, layout, out_dtype)
        if key not in plain_lib:
            plain_lib[key] = (
                time_ms(torch, twin, iters=5),
                time_ms(torch, forms.library_call(a, b, layout)),
                cold_ms(torch, lambda a_, b_: forms.library_call(
                    a_, b_, layout)(), [a, b]))
        t_plain, lib, lib_cold = plain_lib[key]
        rel = 1e-2 if out_dtype == bf else forms.REL_TOL
        tol = rel * max(1.0, ref.float().abs().max().item())
        out_k = call()
        exact = torch.equal(out_k, call()) and (
            call("wmma").float() - ref.float()).abs().max().item() <= tol
        t_new, old = turns_ms(torch, call, lambda: call("wmma"))
        c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                lambda: cold_of("wmma"), timer=False)
        record(pk.tile_gemm, case, out_k, ref, tol,
               (t_new, host_us(torch, call)), t_plain, lib,
               2 * (m * k + k * n) + out_dtype.itemsize * m * n,
               2 * m * k * n, paths=["probes"],
               variant=f"{layout} {'x'.join(map(str, tile))} "
                       f"{str(out_dtype).split('.')[-1]}",
               exact=exact, old_ms=old, cold=c_new, lib_cold=lib_cold,
               extra={"old_cold_ms": c_old})

    plain_lib = {}
    for m, k, n in pgp.SHAPES:
        x = torch.randn(m, k, generator=g, device=dev).to(bf)
        w = torch.randn(k, n, generator=g, device=dev).to(bf)
        for tile in pk.SWEEP_TILES:
            gemm_case(x, w, tile, "nn", bf,
                      f"({m},{k},{n}) tile {'x'.join(map(str, tile))}")
        del x, w
    for form, layout, a_shape, b_shape in forms.FORMS:
        a, b = forms.operands(a_shape, b_shape, dev)
        gemm_case(a, b, forms.CHECK_TILE, layout, f32, f"{form} {a_shape}x"
                  f"{b_shape} tile 64x64x32 fp32")
    m, k, n = forms.TIME_SHAPE
    for form, layout, *_ in forms.FORMS[:3]:
        a = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=g,
                        device=dev).to(bf)
        b = torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=g,
                        device=dev).to(bf)
        gemm_case(a, b, forms.TIME_TILE, layout, f32,
                  f"{form} ({m},{k},{n}) tile 128x128x32 fp32")
    torch.cuda.empty_cache()

    qb, kb, vb, bias, _, _ = ab.make_inputs(bf, dev)
    qi, ki, vi, bias_i, ks, vs = ab.make_inputs(torch.int8, dev)
    bsz, h, dh, t = kb.shape
    ql = qb[:, :, None, :]
    kl, vl = (a.transpose(-1, -2).contiguous() for a in (kb, vb))
    sdpa_of_q = lambda q_, k_, v_: F.scaled_dot_product_attention(q_, k_, v_)
    sdpa_of = lambda k_, v_: sdpa_of_q(ql, k_, v_)
    sdpa = time_ms(torch, lambda: sdpa_of(kl, vl))
    sdpa_cold = cold_ms(torch, sdpa_of, [kl, vl])
    # flops: the block-diagonal product in full (H x H*Dh x T, twice)
    full_ops = 2 * 2 * bsz * h * (h * dh) * t
    for cache, bts, args in (("bf16", (2, 4, 8), (qb, kb, vb, bias)),
                             ("int8", (4, 8), (qi, ki, vi, bias_i, ks, vs))):
        nbytes = 2 * args[1].numel() * args[1].element_size() \
            + (2 * ks.numel() * 4 if cache == "int8" else 0) \
            + 2 * 2 * bsz * h * dh + 4 * bsz * t
        split = pk.blockdiag_plan(bsz, t, dh, cache == "int8")[1]
        for bt in bts:
            # the cluster kernel at the plan's split, timed in turns with
            # the wmma kernel it replaced (held to the twin too), warm and
            # from HBM (K and V rotated out of L2), two runs bit-equal
            call = lambda v=None: pk.blockdiag_decode_attention(
                *args, bt=bt, variant=v)
            twin = lambda: pk.blockdiag_decode_attention.plain(*args, bt=bt)
            cold_of = lambda v: cold_ms(
                torch, lambda k_, v_: pk.blockdiag_decode_attention(
                    args[0], k_, v_, *args[3:], bt=bt, variant=v),
                [args[1], args[2]])
            out_k, out_p = call(), twin()
            exact = torch.equal(out_k, call()) and (
                call("wmma").float() - out_p.float()).abs().max().item() \
                <= 4e-3
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                    lambda: cold_of("wmma"), timer=False)
            record(pk.blockdiag_decode_attention,
                   f"{cache} bt={bt} split{split} B={bsz} H={h} Dh={dh} T={t}",
                   out_k, out_p, 4e-3, (t_new, host_us(torch, call)),
                   time_ms(torch, twin), sdpa if cache == "bf16" else None,
                   nbytes, full_ops, paths=["probes"],
                   variant=f"{cache} bt={bt} split{split}", exact=exact,
                   old_ms=old, cold=c_new,
                   lib_cold=sdpa_cold if cache == "bf16" else None,
                   extra={"old_cold_ms": c_old})
    # K11 on the same inputs: the microbench's per-head line, the other
    # answer to K17's question (within 1e-2 of the largest output, as
    # decode_hd_cases holds it)
    from acai_omr_tpu_torch.ops.decode_hd_kernel import decode_attention_hd
    from acai_omr_tpu_torch.ops.decode_kernel import attention_split
    call = lambda: decode_attention_hd(qb, kb, vb, bias)
    twin = lambda: decode_attention_hd.plain(qb, kb, vb, bias)
    out_k, out_p = call(), twin()
    split = attention_split(None, bsz, h, t)[1]
    record(decode_attention_hd, f"perhead split{split} B={bsz} H={h} "
           f"Dh={dh} T={t} (attn_microbench's line)", out_k, out_p,
           1e-2 * max(1.0, out_p.float().abs().max().item()),
           kernel_times(call), time_ms(torch, twin), sdpa,
           2 * kb.numel() * 2 + 2 * 2 * bsz * h * dh + 4 * bsz * t,
           4 * bsz * h * dh * t, paths=["probes"], variant=f"split{split}",
           exact=torch.equal(out_k, call()),
           cold=cold_ms(torch, lambda k_, v_: decode_attention_hd(
               qb, k_, v_, bias), [kb, vb]), lib_cold=sdpa_cold)
    # K18 on one block per (row, head), timed in turns with the warp kernel
    # it replaced (held to the twin too), warm and from HBM, two runs
    # bit-equal; at the microbench's B = 32 and at B = 1 (16 blocks, K11's
    # keys split across a cluster beside it: whether a split would pay)
    for rows in (bsz, 1):
        bt = 4 if rows % 4 == 0 else 1
        args = [a[:rows] for a in (qb, kb, vb, bias)]
        call = lambda v=None: pk.batched_decode_attention(*args, bt=bt,
                                                          variant=v)
        twin = lambda: pk.batched_decode_attention.plain(*args, bt=bt)
        cold_of = lambda v: cold_ms(
            torch, lambda k_, v_: pk.batched_decode_attention(
                args[0], k_, v_, args[3], bt=bt, variant=v), args[1:3])
        out_k, out_p = call(), twin()
        exact = torch.equal(out_k, call()) and (
            call("warp").float() - out_p.float()).abs().max().item() <= 4e-3
        t_new, old = turns_ms(torch, call, lambda: call("warp"))
        c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                lambda: cold_of("warp"), timer=False)
        extra = {"old_cold_ms": c_old}
        if rows == bsz:
            lib, lib_cold = sdpa, sdpa_cold
        else:
            ql1, kl1, vl1 = ql[:rows], kl[:rows], vl[:rows]
            lib = time_ms(torch, lambda: sdpa_of_q(ql1, kl1, vl1))
            lib_cold = cold_ms(torch, lambda k_, v_: sdpa_of_q(ql1, k_, v_),
                               [kl1, vl1])
            k11 = lambda k_, v_: decode_attention_hd(args[0], k_, v_, args[3])
            extra.update(k11_ms=time_ms(torch, lambda: k11(*args[1:3])),
                         k11_cold_ms=cold_ms(torch, k11, args[1:3]))
        route = pk.batched_route(t)
        record(pk.batched_decode_attention, f"bf16 bt={bt} {route} B={rows} "
               f"H={h} Dh={dh} T={t}", out_k, out_p, 4e-3,
               (t_new, host_us(torch, call)), time_ms(torch, twin), lib,
               2 * args[1].numel() * 2 + 2 * 2 * rows * h * dh + 4 * rows * t,
               4 * rows * h * dh * t, paths=["probes"],
               variant=f"bt={bt} {route}" if rows == bsz else None,
               exact=exact, old_ms=old, cold=c_new, lib_cold=lib_cold,
               extra=extra)

    k19_case(torch, record, g, dev)
    int4_stream_cases(torch, record, kernel_times, dev)
    spills = access_vpu_cases(torch, record, kernel_times, dev)
    print(f"[probes] checked in {time.perf_counter() - t0:.1f} s", flush=True)
    return spills


def k19_case(torch, record, g, dev):
    """K19 at 227 KB: row 0 bit for bit against the twin, 228 KB refused as
    ``SmemRefused`` by the warp kernel and by the kernel it replaced; the
    warp kernel (a programmatic launch, ``pdl``) and the replaced kernel
    (``variant="simple"``, an ordinary launch) timed in turns (pdl, simple,
    simple, pdl; each the lesser of its two readings), warm in a graph of
    100 calls and with the host us a call of each, and once each from HBM
    (a 2 KB input is out of L2 only after 65,536 copies: about 3 s a
    reading); the edges of a graph captured from 20 programmatic launches
    (``graph_programmatic_edges``: whether the graph kept the overlap)."""
    from acai_omr_tpu_torch.ops import probe_kernels as pk
    x = torch.randn(8, 128, generator=g, device=dev).to(torch.bfloat16)
    n_bytes = 227 * 1024
    forms = {"pdl": lambda x_=x: pk.smem_probe(x_, n_bytes),
             "simple": lambda x_=x: pk.smem_probe(x_, n_bytes,
                                                  variant="simple")}
    out_p = pk.smem_probe.plain(x, n_bytes)
    exact = all(torch.equal(f()[0], out_p[0]) for f in forms.values())
    for variant in (None, "simple"):
        try:  # the one launch that must fail: past the card's limit
            pk.smem_probe(x, 228 * 1024, variant=variant)
            exact = False
        except pk.SmemRefused as e:
            print(f"[probes] smem_probe ({variant or 'warp'}) at 228 KB "
                  f"refused as expected: {e}", flush=True)
    torch.cuda.synchronize()
    order = ("pdl", "simple", "simple", "pdl")
    warm, cold, host = ({k: [] for k in forms} for _ in range(3))
    for k in order:
        warm[k].append(time_ms(torch, forms[k], iters=100))
    for k in order[:2]:
        cold[k].append(cold_ms(torch, forms[k], [x]))
    for k in order:
        host[k].append(host_us(torch, forms[k]))
    warm, cold, host = ({k: min(v) for k, v in d.items()}
                        for d in (warm, cold, host))
    # where a call's host time goes: the bare C launch (the ctypes call with
    # its arguments ready), the output's allocation, the stream's lookup
    # (the wrappers' ``stream_ptr``, and ``torch.cuda.current_stream()``
    # that it replaced), the checks
    from acai_omr_tpu_torch.ops import _build
    out = torch.empty_like(x)
    launch = _build.bind("smem_probe", "acai_smem_probe",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p])
    args = (x.data_ptr(), out.data_ptr(), n_bytes, _build.stream_ptr())
    parts = {"launch_only": lambda: launch(*args),
             "empty_like": lambda: torch.empty_like(x),
             "stream_ptr": _build.stream_ptr,
             "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
             "checks": lambda: (_build.require(x, "x", torch.bfloat16, 2),
                                pk.smem_probe.check(x, n_bytes))}
    host_parts = {k: host_us(torch, f) for k, f in parts.items()}
    torch.cuda.synchronize()
    n_edges, n_prog = pk.smem_graph_edges(x, n_bytes)
    edges = {"graph_edges": n_edges, "graph_programmatic_edges": n_prog}
    regs = {r["variant"] or "warp": (r["registers"], r["local_bytes"])
            for r in pk.smem_probe.resources()}
    print(f"[probes] K19 at 227 KB: warm ms {json.dumps(warm)}, from HBM "
          f"{json.dumps(cold)}, host us {json.dumps(host)} (parts "
          f"{json.dumps(host_parts)}), {json.dumps(edges)}"
          f", (registers, local bytes) {json.dumps(regs)}", flush=True)
    record(pk.smem_probe, "227 KB, row 0", forms["pdl"]()[:1], out_p[:1], 0.0,
           (warm["pdl"], host["pdl"]),
           time_ms(torch, lambda: pk.smem_probe.plain(x, n_bytes)), None,
           2 * x.numel() * 2, x.numel(), peak=PEAK_FP32_FLOP_PER_S,
           paths=["probes"], exact=exact and regs["warp"][1] == 0,
           old_ms=warm["simple"], cold=cold["pdl"],
           extra={"old_cold_ms": cold["simple"],
                  "old_host_us": host["simple"],
                  **{f"host_us_{k}": v for k, v in host_parts.items()},
                  **edges,
                  "registers": regs["warp"][0],
                  "old_registers": regs["simple"][0]})


def stream_lookup(torch) -> dict:
    """``--stream-lookup``: what the wrappers' stream lookup costs a
    host-bound path. The greedy bf16 decode of the N_IMAGES images
    (max_len MAX_LEN, 132 wrapper calls a step) with ``_build.stream_ptr``
    as it is (``raw``: the current stream's raw handle) and as it was
    (``object``: ``torch.cuda.current_stream().cuda_stream``), in turns
    raw, object, object, raw; ms a decode step of each (the lesser of its
    two readings) and whether the tokens agree."""
    import numpy as np

    from acai_omr_tpu_torch.api import OmrModel
    from acai_omr_tpu_torch.models import decode as decode_lib
    from acai_omr_tpu_torch.ops import _build
    model = OmrModel.load(device="cuda", seed=SEED)
    imgs = synthetic_images(np, N_IMAGES, SEED)
    model.transcribe_batch(imgs[:2], max_len=8)  # warm-up
    raw = _build.stream_ptr
    forms = {"raw": raw,
             "object": lambda: torch.cuda.current_stream().cuda_stream}
    ms, lmx = {k: [] for k in forms}, {}
    try:
        for k in ("raw", "object", "object", "raw"):
            _build.stream_ptr = forms[k]
            with counted_steps(decode_lib) as box:
                out = model.transcribe_batch(imgs, max_len=MAX_LEN)
                torch.cuda.synchronize()
            ms[k].append(1e3 * model.last_result.decode_seconds / box["n"])
            lmx.setdefault(k, [t.lmx for t in out])
    finally:
        _build.stream_ptr = raw
    r = {"ms_per_step": {k: min(v) for k, v in ms.items()},
         "readings": ms, "same_tokens": lmx["raw"] == lmx["object"]}
    print(f"[stream lookup] {json.dumps(r)}", flush=True)
    return r


def k19_alone(torch) -> int:
    """``--k19``: :func:`k19_case` alone, its row printed as JSON; 1 when
    row 0 differs from the twin or a check fails."""
    rows = []

    def record(op, case, out_k, out_p, tol, t_k, t_p, t_lib, nbytes, nops,
               peak=PEAK_BF16_FLOP_PER_S, exact=None, old_ms=None, cold=None,
               extra=None, **_):
        err = (out_k.float() - out_p.float()).abs().max().item()
        b_ms, b_by = bound_ms(nbytes, nops, peak)
        rows.append({"name": f"{op.name}[{case}]", "max_abs_err": err,
                     "ok": err <= tol and exact is not False, "ms": t_k[0],
                     "host_us": t_k[1], "plain_ms": t_p, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t_lib, "old_ms": old_ms,
                     "cold_ms": cold, **(extra or {})})

    dev = torch.device("cuda")
    k19_case(torch, record, torch.Generator(device=dev).manual_seed(SEED),
             dev)
    print(json.dumps(rows))
    return 0 if all(r["ok"] for r in rows) else 1


def int4_stream_cases(torch, record, kernel_times, dev):
    """K20-K24 against their twins at the tools' shapes. K20: the five
    schemes at (8, 256, 512) and (8, 1024, 4096), exact, one device kernel
    a call; the strip kernel in turns with the atomic kernel it replaced
    (``variant="atomic"``, exact too), warm and from HBM (the weights
    rotated out of L2, ``old_cold_ms``); library none (``torch._int_mm``
    takes more than 16 rows); bound the weight, row and output bytes. K21:
    the five schemes at (512, 4096), one unpack, bit for bit, one device
    kernel a call; the word-wide kernel in turns with the bytewise kernel
    it replaced (``variant="bytewise"``, bit for bit too), warm and from HBM
    (the packed block rotated out of L2), and the tool's us per unpack of
    both in turns (``us_per_unpack``, ``old_us_per_unpack``) beside the us
    of ``fill_`` writing 4 MiB resident in L2 (``fill_4mib_us``: what an
    unpack's stores alone cost); library none (no one call unpacks
    nibbles); bound 2 MiB in, 4 MiB out. K22: F =
    1..16 at the tool's defaults, the tile bit for bit; library none (the
    output is one tile, the stream is the probe); bound the stream. K23:
    both modes at s = 1 / 31 / 63, within 1e-5 of the largest |output|, two
    runs bit-equal, one device kernel a call; the walk in turns with the
    grid kernel it replaced (``variant="grid"``, within the tolerance
    too), warm and from HBM; library ``torch.sum`` of chunks 0..s in fp32
    (s known on the host), warm on the same tensor and from HBM on the same
    rotating views as the kernel's cold time (``library_cold_ms``); bound
    (s + 1) chunks; the twin reads s on the host, so it is timed with
    events around eager calls. K24: lanes 16 / 128, the same tolerance, two
    runs bit-equal, one device kernel a call; the one-launch kernel in turns
    with the two-pass form it replaced (``variant="two_pass"``, within the
    tolerance too), warm and from HBM; library ``x.sum((0, 1))`` (without
    the carry), warm and from HBM; bound x. ``cold`` rotates the inputs out
    of L2 where they fit it."""
    from acai_omr_tpu_torch.ops import int4_probe_kernels as ik
    from acai_omr_tpu_torch.ops import stream_probe_kernels as sk
    from acai_omr_tpu_torch.tools import dma_issue_probe as dip
    from acai_omr_tpu_torch.tools import int4_probe as i4p
    from acai_omr_tpu_torch.tools import narrow_lane_dma_probe as nlp
    from acai_omr_tpu_torch.tools import unpack_probe as upp
    from acai_omr_tpu_torch.tools._probe import cold_copies, l2_bytes

    print("[probes] K20-K24 against their twins", flush=True)
    op20 = ik.int4_delivery_gemm
    for shape in (i4p.LEGALITY_SHAPE, i4p.TIMING_SHAPE):
        bt, cin, cout = shape
        lo, hi, x = i4p.make_inputs(bt, cin, cout, dev)
        for scheme in ik.GEMM_SCHEMES:
            w = ik.scheme_weights(lo, hi, scheme)
            call = lambda v=None: op20(x, w, scheme, variant=v)
            cold_of = lambda v: cold_ms(torch, lambda w_: op20(
                x, w_, scheme, variant=v), [w])
            out_k, out_p = call(), op20.plain(x, w, scheme)
            exact = (torch.equal(out_k, out_p) and torch.equal(call(), out_k)
                     and torch.equal(call("atomic"), out_p)
                     and one_kernel(op20, call))
            t_new, old = turns_ms(torch, call, lambda: call("atomic"))
            c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                    lambda: cold_of("atomic"), timer=False)
            _, split = ik.strip_plan(bt, cin, cout, scheme)
            record(op20, f"{scheme} bt={bt} {cin}->{cout} split{split} "
                   f"(library: none, _int_mm takes more than 16 rows)",
                   out_k, out_p, 0.0, (t_new, host_us(torch, call)),
                   time_ms(torch, lambda: op20.plain(x, w, scheme)), None,
                   w.numel() * w.element_size() + bt * cin + 4 * bt * cout,
                   2 * bt * cin * cout, peak=PEAK_INT8_OP_PER_S,
                   paths=["probes"], exact=exact,
                   variant=scheme if split == 1 else f"{scheme} split{split}",
                   old_ms=old, cold=c_new, extra={"old_cold_ms": c_old})

    wp, want = upp.make_block(device=dev)
    # the rate of L2 writes the unpack's stores meet: torch's fill_ of 4 MiB
    # resident in L2, from fills of 16 and 32 MiB (one launch each)
    fills = {}
    for mib in (16, 32):
        buf = torch.empty(mib * 2 ** 20, dtype=torch.uint8, device=dev)
        fills[mib] = time_ms(torch, lambda: buf.fill_(1))
    del buf
    fill_4mib_us = (fills[32] - fills[16]) / 4 * 1e3
    for scheme in ik.UNPACK_SCHEMES:
        # the word-wide kernel in turns with the bytewise kernel it replaced
        # (bit for bit too), one call warm and from HBM (the packed block
        # rotated out of L2), and the tool's us per unpack (reps 50 / 100
        # inside one launch, the output in L2) of both in turns
        call = lambda v=None: ik.int4_unpack(wp, scheme, 1, variant=v)
        cold_of = lambda v: cold_ms(torch, lambda p_: ik.int4_unpack(
            p_, scheme, 1, variant=v), [wp])
        out_k = call()
        exact = torch.equal(out_k, want) and torch.equal(
            call("bytewise"), want) and one_kernel(ik.int4_unpack, call)
        t_new, old = turns_ms(torch, call, lambda: call("bytewise"))
        c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                lambda: cold_of("bytewise"), timer=False)
        per_new, per_old = turns_ms(
            torch, lambda: upp.run(scheme, 50, dev)["ms"],
            lambda: upp.run(scheme, 50, dev, variant="bytewise")["ms"],
            timer=False)
        record(ik.int4_unpack, f"{scheme} ({upp.HALF},{upp.OUT}) packed, one "
               f"unpack", out_k, want, 0.0, (t_new, host_us(torch, call)),
               time_ms(torch, lambda: ik.int4_unpack.plain(wp, scheme)), None,
               3 * wp.numel(),
               2 * 16 * wp.numel() if scheme == "eyedot" else 0,
               peak=PEAK_INT8_OP_PER_S, paths=["probes"], exact=exact,
               variant=scheme, old_ms=old, cold=c_new,
               extra={"old_cold_ms": c_old, "us_per_unpack": per_new * 1e3,
                      "old_us_per_unpack": per_old * 1e3,
                      "fill_4mib_us": fill_4mib_us})

    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    src = dip.make_src(48, 64, blocks, dev)
    for frags in (1, 2, 4, 8, 16):
        call = lambda: sk.bulk_copy_ring(src, 3, frags, blocks)
        out_k, out_p = call(), sk.bulk_copy_ring.plain(src, 3, frags, blocks)
        record(sk.bulk_copy_ring, f"F={frags} 48 steps x {blocks} blocks x 3 "
               f"slots of 64 KB (library: none)", out_k, out_p, 0.0,
               kernel_times(call), time_ms(torch, lambda: sk.bulk_copy_ring
                                           .plain(src, 3, frags, blocks)),
               None, src.numel() * 2 + out_k.numel() * 2, 0,
               paths=["probes"], exact=torch.equal(out_k, out_p),
               variant=f"F={frags}")
    del src

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn(64, 4096, 1024, generator=g, device=dev).to(torch.bfloat16)
    chunk = x[0].numel() * 2
    op23 = sk.clamped_chunk_sum
    for mode in sk.MODES:
        for s in (1, 31, 63):
            s_dev = torch.tensor([s], dtype=torch.int32, device=dev)
            call = lambda v=None: op23(x, s_dev, mode, variant=v)
            out_k, again = call(), call()
            out_p = op23.plain(x, s_dev, mode)
            tol = 1e-5 * max(1.0, out_p.abs().max().item())
            exact = (torch.equal(out_k, again) and one_kernel(op23, call)
                     and (call("grid") - out_p).abs().max().item() <= tol)
            # copies start (s + 1) chunks apart in one tensor; an own tensor
            # per copy would hold 512 MiB each
            copies = cold_copies((s + 1) * chunk, l2_bytes(dev))
            x_all = torch.cat([x] + [x[:s + 1]] * (copies - 1)) \
                if copies > 1 else x
            views = [x_all[j * (s + 1): j * (s + 1) + 64]
                     for j in range(copies)]
            cold_of = lambda v: time_ms(torch, lambda i: op23(
                views[i], s_dev, mode, variant=v), copies=copies)
            lib_of = lambda x_: torch.sum(x_[:s + 1], dim=(0, 1),
                                          dtype=torch.float32)
            t_new, old = turns_ms(torch, call, lambda: call("grid"))
            c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                    lambda: cold_of("grid"), timer=False)
            record(op23, f"{mode} s={s} x (64,4096,1024) "
                   f"(library: torch.sum of chunks 0..s)", out_k, out_p, tol,
                   (t_new, host_us(torch, call)),
                   time_ms_eager(torch, lambda: op23.plain(
                       x, s_dev, mode), iters=5),
                   time_ms(torch, lambda: lib_of(x)),
                   (s + 1) * chunk + 4 + 4 * 1024, (s + 1) * chunk // 2,
                   peak=PEAK_FP32_FLOP_PER_S, paths=["probes"],
                   exact=exact, variant=mode, old_ms=old, cold=c_new,
                   lib_cold=time_ms(torch, lambda i: lib_of(views[i]),
                                    copies=copies),
                   extra={"old_cold_ms": c_old})
            del x_all, views
    del x
    torch.cuda.empty_cache()

    op24 = sk.lane_stream_sum
    for lanes in (16, 128):
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(nlp.N_BLOCKS, nlp.T, lanes, generator=g, device=dev)
        c = torch.randn(1, lanes, generator=g, device=dev)
        # the one-launch kernel in turns with the two-pass form it replaced
        # (within the tolerance too), warm and from HBM; two runs bit-equal,
        # one device kernel a call
        call = lambda v=None: op24(x, c, variant=v)
        cold_of = lambda v: cold_ms(torch, lambda x_: op24(x_, c, variant=v),
                                    [x])
        out_k, out_p = call(), op24.plain(x, c)
        tol = 1e-5 * max(1.0, out_p.abs().max().item())
        exact = (torch.equal(out_k, call()) and one_kernel(op24, call)
                 and (call("two_pass") - out_p).abs().max().item() <= tol)
        t_new, old = turns_ms(torch, call, lambda: call("two_pass"))
        c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                lambda: cold_of("two_pass"), timer=False)
        record(op24, f"lanes={lanes} x ({nlp.N_BLOCKS},{nlp.T},{lanes}) "
               f"(library: x.sum((0, 1)), no carry)", out_k, out_p, tol,
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: op24.plain(x, c)),
               time_ms(torch, lambda: x.sum(dim=(0, 1))),
               x.numel() * 4 + 8 * lanes, x.numel(),
               peak=PEAK_FP32_FLOP_PER_S, paths=["probes"],
               variant=f"lanes={lanes}", exact=exact, old_ms=old, cold=c_new,
               lib_cold=cold_ms(torch, lambda x_: x_.sum(dim=(0, 1)), [x]),
               extra={"old_cold_ms": c_old})


def access_vpu_cases(torch, record, kernel_times, dev):
    """K25-K27 against their twins at the tools' shapes. K25: the three forms
    at (T, E, H) = (256, 1024, 16) and (1024, 768, 12), fp32 out within 1e-5
    of the largest |logit|; bound q and k read once, the logits written once
    (the 2 H T^2 64 flops at the bf16 peak are smaller); library
    ``torch.bmm`` on the (H, T, 64) views with fp32 out (the same function;
    ``torch.matmul``, bf16 out, beside it as ``library_bf16_ms``); the
    persistent kernel in turns with the wmma kernel it replaced, warm and
    from HBM (``old_cold_ms``), two runs bit-equal. K26: fp32 and int8 at
    BT = 8, T = 128, E = 1024, H = 16; int8 exact, fp32 within 1e-5 of the
    largest output; the transpose equal to the column sums bit for bit, two
    runs bit-equal, one device kernel a call (``exact``); the slab kernel in
    turns with the kernel it replaced (``variant="shuffle"``, held to the
    twin too), warm and from HBM; bound k read once; library
    ``torch.einsum`` (fp32), warm and from HBM on the kernel's rotation of k
    (``library_cold_ms``), none for int8. K27: the five works at 8 passes,
    one shape each, within 1e-5 of the largest output; the plan kernel in
    turns with the kernel it replaced (``variant="fixed"``, held to the
    twin too), warm and from HBM, and ``ns_per_pass`` on finite values from
    the 8- and 16-pass launches of both; the GELU works also from a block
    that has overflowed (320 passes): both kernels keep the twin's infs,
    make no NaN and hold the finite values within 1e-5 of the largest, and
    the 8-pass launch on it in turns (``overflowed_ms``); bound: the larger
    of the 8 bytes an element moves and the work's fp32 instructions (128 a
    SM a clock) or MUFU operations (16) at the card's highest SM clock;
    library none (no one call runs the chained passes). Then the resource
    rows of K16-K18 and K25-K27; returns those of the redesigned kernels
    (``REDESIGNED_PROBES``, not the kernels they replaced) that use local
    memory."""
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.ops import head_logits_kernels as hk
    from acai_omr_tpu_torch.ops import vpu_probe_kernels as vk
    from acai_omr_tpu_torch.tools import mosaic_batched_attn_probe as mbp
    from acai_omr_tpu_torch.tools import mosaic_head_access_probe as mhp
    from acai_omr_tpu_torch.tools import vpu_probe as vpp
    from acai_omr_tpu_torch.tools._probe import (FP32_LANES_PER_SM,
                                                 MUFU_PER_SM, sm_clock_hz,
                                                 sm_count)

    print("[probes] K25-K27 against their twins", flush=True)
    for t, e, h in mhp.SHAPES:
        q, k = mhp.make_inputs(t, e, dev)
        qh, kh = (hk.as_heads(a, h).contiguous() for a in (q, k))
        lib = time_ms(torch, lambda: torch.matmul(
            hk.as_heads(q, h), hk.as_heads(k, h).transpose(-1, -2)))
        try:  # the same function: fp32 out
            lib32 = time_ms(torch, mhp.library_fp32(q, k, h))
            lib32_cold = cold_ms(torch, lambda q_, k_: mhp.library_fp32(
                q_, k_, h)(), [q, k])
        except (RuntimeError, TypeError, NotImplementedError) as exc:
            lib32 = lib32_cold = None
            print(f"[probes] torch.bmm(out_dtype=torch.float32) refused: "
                  f"{str(exc).splitlines()[0][:120]}", flush=True)
        for form in hk.FORMS:
            a, b = (qh, kh) if form == "preshaped" else (q, k)
            # the persistent kernel, timed in turns with the wmma kernel it
            # replaced (held to the twin too), warm and from HBM (q, k
            # rotated out of L2), two runs bit-equal
            call = lambda v=None: hk.head_logits(a, b, form, h, variant=v)
            cold_of = lambda v: cold_ms(torch, lambda a_, b_: hk.head_logits(
                a_, b_, form, h, variant=v), [a, b])
            out_k, out_p = call(), hk.head_logits.plain(a, b, form, h)
            tol = 1e-5 * max(1.0, out_p.abs().max().item())
            exact = torch.equal(out_k, call()) and (
                call("wmma") - out_p).abs().max().item() <= tol
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                    lambda: cold_of("wmma"), timer=False)
            record(hk.head_logits, f"{form} T={t} E={e} H={h}" + (
                   "" if lib32 is not None else " (library: torch.matmul, "
                   "bf16 out, half the bytes: this build refuses the fp32-out "
                   "bmm)"), out_k, out_p, tol, (t_new, host_us(torch, call)),
                   time_ms(torch, lambda: hk.head_logits.plain(a, b, form, h)),
                   lib if lib32 is None else lib32,
                   2 * 2 * t * e + 4 * h * t * t, 2 * h * t * t * hk.DH,
                   paths=["probes"], variant=form, exact=exact, old_ms=old,
                   cold=c_new, lib_cold=lib32_cold,
                   extra={"old_cold_ms": c_old, "library_bf16_ms": lib})
        del q, k, qh, kh

    for int8 in (False, True):
        k, q = (torch.from_numpy(a).to(dev) for a in mbp.make_inputs(int8))
        dtype = "int8" if int8 else "fp32"
        # the slab kernel, timed in turns with the kernel it replaced (held
        # to the twin too), warm and from HBM (k rotated out of L2); two
        # runs bit-equal, one device kernel a call
        call = lambda v=None: hk.batched_head_logits(k, q, mbp.H, variant=v)
        cold_of = lambda v: cold_ms(torch, lambda k_: hk.batched_head_logits(
            k_, q, mbp.H, variant=v), [k])
        (c_k, s_k, t_k), (c_p, s_p, _) = call(), \
            hk.batched_head_logits.plain(k, q, mbp.H)
        tol = 0.0 if int8 else 1e-5 * max(1.0, c_p.abs().max().item())
        sums_ok = torch.equal(s_k, s_p) if int8 else \
            (s_k - s_p).abs().max().item() <= 1e-5 * s_p.abs().max().item()
        c_o, _, t_o = call("shuffle")
        exact = (sums_ok and torch.equal(t_k.t(), s_k)
                 and all(torch.equal(a, b) for a, b in zip(
                     (c_k, s_k, t_k), call()))
                 and (c_o - c_p).abs().max().item() <= tol
                 and one_kernel(hk.batched_head_logits, call))
        t_new, old = turns_ms(torch, call, lambda: call("shuffle"))
        c_new, c_old = turns_ms(torch, lambda: cold_of(None),
                                lambda: cold_of("shuffle"), timer=False)
        lib_of = lambda k_: torch.einsum(
            "bthd,bhd->tbh", k_.view(mbp.BT, mbp.T, mbp.H, hk.DH),
            q.view(mbp.BT, mbp.H, hk.DH))
        lib = None if int8 else time_ms(torch, lambda: lib_of(k))
        # the library call from HBM on the kernel's rotation (k's copies)
        lib_cold = None if int8 else cold_ms(torch, lib_of, [k])
        chunks, _ = hk.batched_plan(mbp.BT, mbp.T, mbp.H, k.dtype)
        nl = mbp.BT * mbp.H
        record(hk.batched_head_logits, f"{dtype} BT={mbp.BT} T={mbp.T} "
               f"E={mbp.E} H={mbp.H} chunks={chunks}"
               + (" (library: none, no int8 einsum)" if int8 else ""),
               c_k, c_p, tol, (t_new, host_us(torch, call)),
               time_ms(torch, lambda: hk.batched_head_logits.plain(
                   k, q, mbp.H)), lib,
               k.numel() * k.element_size() + q.numel() * 4
               + 4 * (mbp.T + 2) * nl, 2 * k.numel(),
               peak=PEAK_INT8_OP_PER_S if int8 else PEAK_FP32_FLOP_PER_S,
               paths=["probes"], variant=f"{dtype} slab",
               exact=exact, old_ms=old, cold=c_new, lib_cold=lib_cold,
               extra={"old_cold_ms": c_old})
        del k, q

    clock = sm_clock_hz(dev)
    print(f"[probes] SM clock (clocks.max.sm) {clock / 1e6:.0f} MHz",
          flush=True)
    for work in vk.WORKS:
        rows, cols = vpp.SHAPES[work][-1]
        x = vpp.make_block(rows, cols, dev)
        # the plan kernel in turns with the kernel it replaced (held to the
        # twin too), warm and from HBM; ns a pass on finite values from the
        # 8- and 16-pass launches of both
        call = lambda v=None, n=8, x_=x: vk.resident_elementwise(
            x_, work, n, variant=v)
        out_k, out_p = call(), vk.resident_elementwise.plain(x, work, 8)
        tol = 1e-5 * max(1.0, out_p.abs().max().item())
        exact = (call("fixed") - out_p).abs().max().item() <= tol
        t_new, old = turns_ms(torch, call, lambda: call("fixed"))
        t16, old16 = turns_ms(torch, lambda: call(n=16),
                              lambda: call("fixed", 16))
        c_new, c_old = turns_ms(
            torch, lambda: cold_ms(torch, lambda x_: call(x_=x_), [x]),
            lambda: cold_ms(torch, lambda x_: call("fixed", x_=x_), [x]),
            timer=False)
        ops_s = vk.bound_s(work, x.numel(), 8, clock, sm_count(dev),
                           FP32_LANES_PER_SM, MUFU_PER_SM)
        extra = {"old_cold_ms": c_old,
                 "ns_per_pass": (t16 - t_new) / 8 * 1e6,
                 "old_ns_per_pass": (old16 - old) / 8 * 1e6,
                 "bound_ns_per_pass": ops_s / 8 * 1e9}
        if work.startswith("gelu"):
            # an overflowed block (320 passes: about a third of the values
            # are inf): each kernel's 8 passes keep the twin's infs, no NaN,
            # the finite values within the tolerance; the 8-pass launch
            # timed on it in turns
            xo = call(n=320)
            want = vk.resident_elementwise.plain(xo, work, 8)
            fin = torch.isfinite(want)
            ftol = 1e-5 * max(1.0, want[fin].abs().max().item())
            for v in (None, "fixed"):
                got = call(v, x_=xo)
                exact = exact and bool(torch.isinf(xo).any()) and torch.equal(
                    torch.isinf(got), torch.isinf(want)) and not bool(
                    torch.isnan(got).any()) and (
                    got[fin] - want[fin]).abs().max().item() <= ftol
            o_new, o_old = turns_ms(torch, lambda: call(x_=xo),
                                    lambda: call("fixed", x_=xo))
            extra.update(overflowed_ms=o_new, old_overflowed_ms=o_old)
        record(vk.resident_elementwise, f"{work} ({rows},{cols}) 8 passes "
               f"{vk.plan_variant(rows, cols, work).split(' ', 2)[-1]} "
               f"(library: "
               f"none, no one call runs the chained passes)",
               out_k, out_p, tol, (t_new, host_us(torch, call)),
               time_ms(torch, lambda: vk.resident_elementwise.plain(
                   x, work, 8)), None, 8 * x.numel(),
               ops_s * PEAK_FP32_FLOP_PER_S, peak=PEAK_FP32_FLOP_PER_S,
               paths=["probes"], variant=vk.plan_variant(rows, cols, work),
               exact=exact and one_kernel(vk.resident_elementwise, call),
               old_ms=old, cold=c_new, extra=extra)
    spills = []
    for name in ("tile_gemm", "probe_decode_attention", "head_logits",
                 "resident_elementwise", "int4_probe", "stream_probe",
                 "smem_probe"):
        for r in _build.resources(name):
            print(f"[resources] {r['op']} {r['variant'] or '-'} {r['kernel']} "
                  f"regs={r['registers']} local={r['local_bytes']} "
                  f"static_smem={r['static_smem']} "
                  f"dynamic_smem={r['dynamic_smem']} "
                  f"blocks_per_sm={r['blocks_per_sm']}", flush=True)
            # the redesigned probe kernels (K16-K21, K23-K27) use no local
            # memory
            if r["local_bytes"] and r["op"] in REDESIGNED_PROBES \
                    and not replaced_form(r["variant"]):
                spills.append(f"{r['op']} {r['variant']} {r['kernel']}")
    return spills


def probes_path(torch):
    """The probes' main path: each tool's ``main`` on the card, as a user
    runs ``python -m acai_omr_tpu_torch.tools.<name>``, the launch counts
    reset just before and read just after; the tools' lines kept."""
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.tools import (attn_microbench, bwd_vmem_probe,
                                          dma_issue_probe, dma_skip_probe,
                                          gemm_probe, int4_probe,
                                          mosaic_batched_attn_probe,
                                          mosaic_dot_forms_probe,
                                          mosaic_head_access_probe,
                                          narrow_lane_dma_probe,
                                          pallas_gemm_probe, unpack_probe,
                                          vmem_probe, vpu_probe)
    lines, res = {}, {}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for name, tool, argv in [
            ("gemm_probe", gemm_probe, []),
            ("pallas_gemm_probe", pallas_gemm_probe, []),
            ("mosaic_dot_forms_probe", mosaic_dot_forms_probe, []),
            ("attn_microbench", attn_microbench, []),
            ("vmem_probe", vmem_probe, []),
            ("int4_probe", int4_probe, []),
            ("unpack_probe", unpack_probe, []),
            ("dma_issue_probe", dma_issue_probe, []),
            ("dma_skip_probe", dma_skip_probe, []),
            ("narrow_lane_dma_probe", narrow_lane_dma_probe, []),
            ("mosaic_head_access_probe", mosaic_head_access_probe, []),
            ("mosaic_batched_attn_probe", mosaic_batched_attn_probe, []),
            ("vpu_probe", vpu_probe, []),
            *((f"bwd_vmem_probe {m}", bwd_vmem_probe, [m])
              for m in BWD_PROBE_MODES)]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            res[name] = tool.main(argv)
        lines[name] = buf.getvalue().splitlines()
        for line in lines[name]:
            print(f"[probe {name}] {line}", flush=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "lines": lines, "results": res,
            "launches": {n: op.launches for n, op in _build.REGISTRY.items()},
            "device_launches": {n: op.device_launches
                                for n, op in _build.REGISTRY.items()},
            "variants": {n: dict(op.variants)
                         for n, op in _build.REGISTRY.items()}}


def decode_hd_cases(torch, F, randn, record, kernel_times, dev):
    """K11-K13, the attention kernels of the per-op decode step, at the
    flagship's decode shapes: 32 rows, 16 heads of 64; self-attention at
    pos 300 of a 512-slot lane-major cache (K11 reads pos + 1 keys), the
    cross-attention over 1,024 memory rows with ragged padding; K12 per layer
    and over layer 7 of a 12-layer stacked memory; K13 appending at pos 300
    and at pos 0 of layer 7, its written column and scales held bit for bit.
    Bounds count the keys that carry weight only."""
    from acai_omr_tpu_torch.ops.decode_hd_kernel import (
        decode_attention_hd, decode_attention_hd_int8,
        self_attention_append_int8)

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    bsz, h, dh, t, pos, m_len, nl, layer = 32, 16, 64, 512, 300, 1024, 12, 7
    e = h * dh
    sdpa = F.scaled_dot_product_attention
    failures = []

    def hd_case(case, q_, k_, v_, bias_, n_, lib, nbytes, nops):
        """K11's cluster kernel against its twin, timed in turns with the
        simt kernel (held to the twin too), from HBM beside SDPA from HBM
        (on copies of the time-major K / V it reads), two runs bit-equal,
        split 1 within the tolerance of the plan's split."""
        call = lambda v=None: decode_attention_hd(q_, k_, v_, bias_,
                                                  n_keys=n_, variant=v)
        out_k = call()
        out_p = decode_attention_hd.plain(q_, k_, v_, bias_, n_keys=n_)
        tol = 1e-2 * max(1.0, out_p.float().abs().max().item())
        near = lambda a, b_: (a.float() - b_.float()).abs().max().item() \
            <= tol
        exact = (torch.equal(out_k, call()) and near(call("simt"), out_p)
                 and near(call("split1"), out_k))
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        kl, vl = (a[..., :n_].transpose(-1, -2).contiguous()
                  for a in (k_, v_))
        record(decode_attention_hd, case, out_k, out_p, tol,
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: decode_attention_hd.plain(
                   q_, k_, v_, bias_, n_keys=n_)),
               time_ms(torch, lambda: lib(kl, vl)), nbytes, nops,
               paths=["decode_hd_bf16"], exact=exact, old_ms=old,
               cold=cold_ms(torch, lambda k2, v2: decode_attention_hd(
                   q_, k2, v2, bias_, n_keys=n_), [k_, v_]),
               lib_cold=cold_ms(torch, lib, [kl, vl]))
        return out_k

    def self_hd(q_, k_, v_):
        b_ = q_.shape[0]
        ql_ = q_[:, :, None, :]
        out = hd_case(f"self B={b_} H={h} Dh={dh} T={t} pos={pos}", q_, k_,
                      v_, None, pos + 1, lambda k2, v2: sdpa(ql_, k2, v2),
                      2 * (2 * b_ * e + 2 * b_ * e * (pos + 1)),
                      4 * b_ * e * (pos + 1))
        if b_ == 4:  # the keys past n_keys carry NaN: nothing changes
            k_n, v_n = k_.clone(), v_.clone()
            k_n[..., pos + 1:], v_n[..., pos + 1:] = (float("nan"),
                                                      float("nan"))
            ok = torch.equal(decode_attention_hd(q_, k_n, v_n, None,
                                                 n_keys=pos + 1), out)
            print(f"[kernel] decode_attention_hd[self B=4 NaN past n_keys] "
                  f"equal to the finite case: {ok}", flush=True)
            failures.extend([] if ok else ["decode_attention_hd NaN"])

    def cross_hd(q_, mk_, mv_, valid_):
        b_ = q_.shape[0]
        bias_ = torch.where(valid_, 0.0, -1e9).float().contiguous()
        n_val = int(valid_.sum())
        ql_, mask4 = q_[:, :, None, :], valid_[:, None, None, :]
        hd_case(f"cross B={b_} H={h} Dh={dh} M={m_len}", q_, mk_, mv_, bias_,
                None, lambda k2, v2: sdpa(ql_, k2, v2, attn_mask=mask4),
                2 * (2 * b_ * e + 2 * n_val * e) + 4 * b_ * m_len,
                4 * e * n_val)
        return bias_, n_val

    q = randn(bsz, h, dh)
    self_hd(q, randn(bsz, h, dh, t), randn(bsz, h, dh, t))
    mk, mv = randn(bsz, h, dh, m_len), randn(bsz, h, dh, m_len)
    lens = torch.randint(128, m_len + 1, (bsz,), generator=g, device=dev)
    valid = torch.arange(m_len, device=dev)[None, :] < lens[:, None]
    mbias, n_valid = cross_hd(q, mk, mv, valid)
    # the 4 rows the per-op step runs after compaction (own generator: the
    # cases around keep their inputs)
    g2 = torch.Generator(device=dev).manual_seed(SEED + 6)
    randn2 = lambda *s_: torch.randn(*s_, generator=g2, device=dev).to(
        torch.bfloat16)
    self_hd(randn2(4, h, dh), randn2(4, h, dh, t), randn2(4, h, dh, t))
    cross_hd(randn2(4, h, dh), randn2(4, h, dh, m_len),
             randn2(4, h, dh, m_len), valid[:4])

    def int8_planes(*lead_shape):
        c = torch.randint(-127, 128, lead_shape, generator=g, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(lead_shape[:-2] + lead_shape[-1:], generator=g,
                        device=dev) * 3e-2 + 2e-3
        return c, sc

    # K12 (the cluster kernel: the keys of a (row, head) split across a
    # thread-block cluster as decode_attention_int8_plan says, int8 planes
    # and fp32 scales by TMA): per layer and over layer 7 of the stacked
    # memory at B = 32, then stacked at the 4 rows the per-op step runs
    # after compaction. Each within two bf16 ulps of its twin, two runs
    # bit-equal; timed in turns with the simt kernel it replaced (held to
    # the twin too), warm and from HBM (the from-HBM calls rotate copies of
    # one layer's planes and scales: a one-layer stack read at layer 0
    # for the stacked cases). No library call computes it. Bound: the int8
    # K/V bytes and fp32 scales of the valid keys, q in, the output out
    tol8 = lambda ref: TWO_BF16_ULPS * max(1.0, ref.float().abs().max().item())

    def k12_case(case, q_, planes, bias_, n_val, kw, variant):
        call = lambda v=None, *ps: decode_attention_hd_int8(
            q_, *(ps or planes), bias_, variant=v, **kw)
        ref = decode_attention_hd_int8.plain(q_, *planes, bias_, **kw)
        out_k = call()
        exact = torch.equal(out_k, call()) and (
            call("simt").float() - ref.float()).abs().max().item() \
            <= tol8(ref)
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        layer_of = kw.get("layer")
        one = [a[layer_of][None] if layer_of is not None else a
               for a in planes]
        kw1 = {"layer": 0} if layer_of is not None else {}
        cold_of = lambda v: cold_ms(torch, lambda *ps: decode_attention_hd_int8(
            q_, *ps, bias_, variant=v, **kw1), one)
        b_, h_, dh_ = q_.shape
        m_ = planes[0].shape[-1]
        record(decode_attention_hd_int8, case, out_k, ref, tol8(ref),
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: decode_attention_hd_int8.plain(
                   q_, *planes, bias_, **kw)),
               None, 2 * n_val * h_ * (dh_ + 4) + 2 * 2 * b_ * h_ * dh_
               + 4 * b_ * m_, 4 * h_ * dh_ * n_val, peak=PEAK_INT8_OP_PER_S,
               paths=["decode_hd_int8"], exact=exact, old_ms=old,
               variant=variant, cold=cold_of(None),
               extra={"old_cold_ms": cold_of("simt")})

    (k8, ks8), (v8, vs8) = (int8_planes(nl, bsz, h, dh, m_len)
                            for _ in range(2))
    stacked = (k8, v8, ks8, vs8)
    k12_case(f"cross per layer B={bsz} H={h} Dh={dh} M={m_len}", q,
             tuple(a[layer] for a in stacked), mbias, n_valid, {}, None)
    k12_case(f"cross stacked L={nl} layer={layer} B={bsz} H={h} Dh={dh} "
             f"M={m_len}", q, stacked, mbias, n_valid, {"layer": layer},
             "stacked_split")
    del k8, v8, ks8, vs8, stacked
    g4 = torch.Generator(device=dev).manual_seed(SEED + 7)
    planes4 = tuple(
        torch.randint(-127, 128, (nl, 4, h, dh, m_len), generator=g4,
                      device=dev, dtype=torch.int8) if i < 2 else
        torch.rand(nl, 4, h, m_len, generator=g4, device=dev) * 3e-2 + 2e-3
        for i in range(4))
    q4 = torch.randn(4, h, dh, generator=g4, device=dev).to(torch.bfloat16)
    k12_case(f"cross stacked L={nl} layer={layer} B=4 H={h} Dh={dh} "
             f"M={m_len}", q4, planes4, mbias[:4].contiguous(),
             int(valid[:4].sum()), {"layer": layer}, "stacked_split")
    del planes4

    # K13 (K12's cluster kernel with the fresh token: the pos cached keys
    # split as decode_attention_int8_plan says, pos 0 one block a (row,
    # head) without a cluster) at B = 32, pos 300 and pos 0, and at the 4
    # and 8 rows the per-op step runs after compaction, pos 300; layer 7 of
    # a 12-layer cache. The written column and scales equal to the twin's
    # bit for bit, the output within two bf16 ulps, two runs bit-equal, the
    # simt kernel it replaced held to the twin too; timed in turns with it,
    # warm and from HBM (the from-HBM calls rotate copies of one layer's
    # planes and scales, a one-layer cache written at layer 0). No library
    # call computes it. Bound: the int8 K/V and fp32 scales of positions
    # < pos, q / k / v in, the output and the column out
    def k13_case(b_, p_at, seed):
        gk = torch.Generator(device=dev).manual_seed(seed)
        q_, kn_, vn_ = (torch.randn(b_, h, dh, generator=gk, device=dev)
                        .to(torch.bfloat16) * f for f in (1, 2, 1))
        planes = [torch.randint(-127, 128, (nl, b_, h, dh, t), generator=gk,
                                device=dev, dtype=torch.int8)
                  for _ in range(2)] + [
            torch.rand(nl, b_, h, t, generator=gk, device=dev) * 3e-2 + 2e-3
            for _ in range(2)]
        twin = [a.clone() for a in planes]
        out_p = self_attention_append_int8.plain(q_, kn_, vn_, *twin, layer,
                                                 p_at)
        call = lambda v=None, *ps: self_attention_append_int8(
            q_, kn_, vn_, *(ps or planes), layer if not ps else 0, p_at,
            variant=v)
        out_k = call()
        exact = all(torch.equal(a, b2) for a, b2 in zip(planes, twin)) \
            and torch.equal(out_k, call()) and (
                call("simt").float() - out_p.float()).abs().max().item() \
            <= tol8(out_p)
        t_new, old = turns_ms(torch, call, lambda: call("simt"))
        one = [a[layer][None].clone() for a in planes]
        cold_of = lambda v: cold_ms(torch, lambda *ps: call(v, *ps), one)
        e_ = h * dh
        record(self_attention_append_int8,
               f"self L={nl} layer={layer} B={b_} H={h} Dh={dh} T={t} "
               f"pos={p_at}", out_k, out_p, tol8(out_p),
               (t_new, host_us(torch, call)),
               time_ms(torch, lambda: self_attention_append_int8.plain(
                   q_, kn_, vn_, *twin, layer, p_at)),
               None, 2 * b_ * p_at * (e_ + 4 * h) + 2 * 4 * b_ * e_
               + 2 * b_ * (e_ + 4 * h), 4 * b_ * e_ * (p_at + 1),
               peak=PEAK_INT8_OP_PER_S, paths=["decode_hd_int8"],
               exact=exact, old_ms=old, variant="split",
               cold=cold_of(None), extra={"old_cold_ms": cold_of("simt")})

    for b_, p_at, seed in ((bsz, pos, SEED + 8), (bsz, 0, SEED + 9),
                           (4, pos, SEED + 10), (8, pos, SEED + 11)):
        k13_case(b_, p_at, seed)
    return failures


def training_cases(torch, F, randn, record, kernel_times, dev):
    """The kernels of the training stacks at the flagship's shapes: decoder
    rows 8 x 256 (E 1024, H 16, F 4096, memory 1024), encoder rows 8 x 1024
    (E 768, H 12, F 3072), dropout at the flagship's rates; and at the MAE's:
    decoder rows 64 x 512 (E 512, 16 heads of 32, F 3072), encoder rows
    64 x 128 kept patches (E 768, H 12), no dropout."""
    from acai_omr_tpu_torch.ops.attention_bwd_kernel import attention_bwd
    from acai_omr_tpu_torch.ops.dropout_kernel import (DropSpec, dropout_apply,
                                                       keep_mask)
    from acai_omr_tpu_torch.ops.encoder_stack_kernel import (encoder_attention,
                                                             split_qkv)
    from acai_omr_tpu_torch.ops.layernorm_bwd_kernel import layernorm_bwd
    from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import (linear_dgrad,
                                                          linear_wgrad,
                                                          row_split_plan)
    from acai_omr_tpu_torch.ops.linear_kernel import linear_bias_act

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    plain_ms = lambda fn: time_ms(torch, fn, iters=5)
    rel_tol = lambda ref, r=1e-2: r * max(1.0, ref.float().abs().max().item())
    stacks = [("dec", 8, 256, 1024, 16, 4096, 0.1),
              ("enc", 8, 1024, 768, 12, 3072, 0.05),
              ("mae_dec", MAE_BATCH, 512, 512, 16, 3072, 0.0),
              ("mae_enc", MAE_BATCH, 128, 768, 12, 3072, 0.0)]
    tr = ["train_tf"]

    # K10 standalone: the transition head's hidden rows, equal bits. The
    # library call is F.dropout: the same function (Bernoulli keep, 1/(1-p)
    # scale, same bytes) from PyTorch's own stream
    x = randn(8 * 1024, 4096)
    spec = DropSpec(0.05, 17, 29, 3, 1024)
    out_k, out_p = dropout_apply(x, spec), dropout_apply.plain(x, spec)
    record(dropout_apply, "8192x4096 rate=0.05", out_k, out_p, 0.0,
           kernel_times(lambda: dropout_apply(x, spec)),
           plain_ms(lambda: dropout_apply.plain(x, spec)),
           time_ms(torch, lambda: F.dropout(x, 0.05, training=True)),
           2 * 2 * x.numel(), 0, paths=tr, exact=torch.equal(out_k, out_p))

    def attention_sites(name, b, t, e, h, tr):
        """K3 / K7 at a stack's attention sites, ragged key validity."""
        rows = b * t
        sites = [("self causal", t, True), ("cross", 1024, False)] \
            if name == "dec" else [("self", t, False)]
        for site, tk, causal in sites:
            cross = site == "cross"
            lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen,
                                 device=dev)
            valid = torch.arange(tk, device=dev)[None, :] < lens[:, None]
            if cross:
                q, kv = randn(rows, e), randn(b, tk, 2 * e)
            else:
                q, kv = randn(rows, 3 * e), None
            q3, k3, v3 = split_qkv(q, kv, b)
            d_o = randn(b, t, e)
            dh = e // h
            hd = lambda a: a.reshape(b, a.shape[1], h, dh).transpose(1, 2) \
                .contiguous()
            ql, kl, vl, dol = hd(q3), hd(k3), hd(v3), hd(d_o)
            mask4 = valid[:, None, None, :]
            if causal:
                mask4 = mask4 & torch.tril(torch.ones(
                    t, tk, dtype=torch.bool, device=dev))[None, None]
            n_pairs = int(mask4.expand(b, 1, t, tk).sum())  # attended (q, k)
            # K3's Hopper kernel, timed in turns with the wmma kernel it
            # replaces; both held to the twin, two runs of the new one
            # bit-equal (the backward's recompute relies on the bits)
            call = lambda v="sm90": encoder_attention(q, valid, h, causal, kv,
                                                      variant=v)
            out_k = call()
            out_p = encoder_attention.plain(q, valid, h, causal, kv)
            exact = torch.equal(out_k, call()) and (
                call("wmma").float() - out_p.float()).abs().max().item() \
                <= 1e-2
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            record(encoder_attention, f"{name} {site} B={b} Tq={t} Tk={tk} "
                   f"E={e} H={h}", out_k, out_p, 1e-2,
                   (t_new, host_us(torch, call)),
                   plain_ms(lambda: encoder_attention.plain(q, valid, h,
                                                            causal, kv)),
                   time_ms(torch, lambda: F.scaled_dot_product_attention(
                       ql, kl, vl, attn_mask=mask4)),
                   2 * (2 * rows * e + 2 * b * tk * e) + b * tk,
                   4 * e * n_pairs, paths=tr, variant=f"sm90_dh{dh}",
                   exact=exact, old_ms=old)

            # the Hopper kernels, timed in turns with the wmma kernels they
            # replace; both held to the twin (dq, dk and dv each within 2e-2
            # of its own largest value), two runs of the new one bit-equal
            call = lambda v="sm90": attention_bwd(q3, k3, v3, d_o, valid, h,
                                                  causal, variant=v)
            out_k = call()
            out_p = attention_bwd.plain(q3, k3, v3, d_o, valid, h, causal)
            out_o = call("wmma")
            again = all(torch.equal(a, c) for a, c in zip(out_k, call()))
            lq, lk, lv = (a.clone().requires_grad_(True) for a in (ql, kl, vl))
            lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask4)
            rel = lambda outs: [((a.float() - c.float()).abs().max()
                                 / c.float().abs().max()).item()
                                for a, c in zip(outs, out_p)]
            rels, rels_o = rel(out_k), rel(out_o)
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            record(attention_bwd, f"{name} {site} B={b} Tq={t} Tk={tk} E={e} "
                   f"H={h} (dq, dk, dv err / max|ref| "
                   + ", ".join(f"{r:.1e}" for r in rels) + "; wmma "
                   + ", ".join(f"{r:.1e}" for r in rels_o) + ")",
                   torch.cat([a.flatten() for a in out_k]),
                   torch.cat([a.flatten() for a in out_p]),
                   2e-2 * max(a.float().abs().max().item() for a in out_p),
                   (t_new, host_us(torch, call)),
                   plain_ms(lambda: attention_bwd.plain(q3, k3, v3, d_o, valid,
                                                        h, causal)),
                   time_ms_eager(torch, lambda: torch.autograd.grad(
                       lo, (lq, lk, lv), dol, retain_graph=True)),
                   2 * (3 * rows * e + 4 * b * tk * e) + b * tk,
                   10 * e * n_pairs, paths=tr,
                   exact=again and all(r <= 2e-2 for r in rels + rels_o),
                   variant=f"sm90_dh{dh}", old_ms=old)

    for name, b, t, e, h, f, rate in stacks:
        rows = b * t
        drop = DropSpec(rate, 17, 29, 5, t) if rate else None
        w_of = lambda k, n: (randn(k, n, dtype=torch.float32)
                             / math.sqrt(k)).to(bf)
        tr = ["pretrain_mae"] if name.startswith("mae") else ["train_tf"]
        if name == "mae_enc":
            # its 8,192 rows of E = 768 are the shapes of "enc" above: only
            # the attention sites (128 kept rows per image) are new
            attention_sites(name, b, t, e, h, tr)
            continue

        # K1 as the stacks call it: qkv and the E -> E projection without
        # dropout (qc; every site of the save-less forward), then the
        # training epilogues: sa / ca with dropout, ff1 (GELU, dropout,
        # saves GELU') and ff2 with dropout
        # All on the Hopper core, each timed in turns with the wmma kernel it
        # replaces (which must agree with the twin too); with dropout, the
        # dropped elements of the core, the wmma kernel and the twin (K10's
        # mask) must be the same, bit for bit; cold times where the operands
        # fit the 50 MB L2
        for k, n, act, save, dr in [(e, 3 * e, "none", False, None),
                                    (e, e, "none", False, None)] \
                + ([(e, e, "none", False, drop)] if drop else []) \
                + [(e, f, "gelu", True, drop), (f, e, "none", False, drop)]:
            x, w = randn(rows, k), w_of(k, n)
            bias = randn(n, dtype=torch.float32) * 0.1
            call = lambda v=None, x=x, w=w: linear_bias_act(
                x, w, bias, act, dr, save, variant=v)
            both = lambda o: torch.cat(o, 1) if save else o  # h1 and GELU'
            out_k = both(call())
            out_p = both(linear_bias_act.plain(x, w, bias, act, dr, save))
            out_o = both(call("wmma"))
            tol = rel_tol(out_p)
            exact = (out_o.float() - out_p.float()).abs().max().item() <= tol
            if dr is not None:
                dropped = out_k[:, :n] == 0
                exact &= torch.equal(dropped, out_p[:, :n] == 0) \
                    and torch.equal(dropped, out_o[:, :n] == 0)
            b16 = bias.to(bf)
            lib = (lambda: F.gelu(torch.addmm(b16, x, w))) if save else \
                (lambda: torch.addmm(b16, x, w))
            nbytes = 2 * (rows * k + k * n + (2 if save else 1) * rows * n)
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            record(linear_bias_act,
                   f"{name} {rows}x{k}->{n},{act}" + (",drop" if dr is not None else "")
                   + (",saves gelu'" if save else "") + " (sm90)", out_k,
                   out_p, tol, (t_new, host_us(torch, call)),
                   plain_ms(lambda: linear_bias_act.plain(x, w, bias, act,
                                                          dr, save)),
                   time_ms(torch, lib), nbytes + 4 * n, 2 * rows * n * k,
                   paths=tr, variant="sm90", exact=exact, old_ms=old,
                   cold=cold_ms(torch, lambda x_, w_: call(x=x_, w=w_),
                                [x, w]) if nbytes < 50e6 else None)

        # K4: emitting the pre-norm sum; LayerNorm alone (the recompute);
        # each timed in turns with the scalar kernel it replaced
        x, r = randn(rows, e), randn(rows, e)
        gamma = 1.0 + 0.1 * randn(e, dtype=torch.float32)
        beta = 0.1 * randn(e, dtype=torch.float32)
        g16, b16 = gamma.to(bf), beta.to(bf)
        for mode, second, n_out in [("writes z", r, 2), ("no residual", None, 1)]:
            call = lambda v=None: add_layernorm(x, second, gamma, beta, 1e-5,
                                                second is not None, variant=v)
            cat = lambda o: torch.cat(o, 1) if second is not None else o
            out_k = cat(call())
            out_p = cat(add_layernorm.plain(x, second, gamma, beta, 1e-5,
                                            second is not None))
            scalar_ok = (cat(call("scalar")).float()
                         - out_p.float()).abs().max().item() <= rel_tol(out_p)
            t_new, old = turns_ms(torch, call, lambda: call("scalar"))
            z = x if second is None else x + r
            record(add_layernorm, f"{name} {rows}x{e} {mode}", out_k, out_p,
                   rel_tol(out_p), (t_new, host_us(torch, call)),
                   plain_ms(lambda: add_layernorm.plain(
                       x, second, gamma, beta, 1e-5, second is not None)),
                   time_ms(torch, lambda: F.layer_norm(z, (e,), g16, b16, 1e-5)),
                   2 * (n_out + (2 if second is not None else 1)) * rows * e
                   + 8 * e, 8 * rows * e, paths=tr,
                   exact=None if scalar_ok else False, old_ms=old)

        # K8: g and z in, dz and dropped dz out, two column sums. The
        # one-pass kernel timed in turns with the three-launch form it
        # replaced (held to the twin too), warm and from HBM; two runs
        # bit-equal, one device kernel a call, the dropped dz equal to K10's
        # mask on dz bit for bit; beside layer_norm's backward (autograd)
        from acai_omr_tpu_torch.ops.dropout_kernel import dropout_plain
        g_in, z = randn(rows, e), randn(rows, e)
        call = lambda v=None, g_=g_in, z_=z: layernorm_bwd(g_, z_, gamma,
                                                          1e-5, drop,
                                                          variant=v)
        n0 = layernorm_bwd.device_launches
        out_k = call()
        one_launch = layernorm_bwd.device_launches - n0 == 1
        out_p = layernorm_bwd.plain(g_in, z, gamma, 1e-5, drop)
        col_err = max(((a - c).abs().max() / c.abs().max()).item()
                      for a, c in zip(out_k[2:], out_p[2:]))
        old_out = call("three_pass")
        old_ok = max(((a.float() - c.float()).abs().max()
                      / c.float().abs().max()).item()
                     for a, c in zip(old_out, out_p)) < 1e-2
        mask_ok = torch.equal(out_k[1], dropout_plain(out_k[0], drop))
        bits_ok = all(torch.equal(a, b) for a, b in zip(out_k, call()))
        t_new, old = turns_ms(torch, call, lambda: call("three_pass"))
        cold_of = lambda v: cold_ms(torch, lambda g_, z_: call(v, g_, z_),
                                    [g_in, z])
        z_req = z.clone().requires_grad_(True)
        g_req = gamma.to(bf).requires_grad_(True)
        b_req = beta.to(bf).requires_grad_(True)
        y = F.layer_norm(z_req, (e,), g_req, b_req, 1e-5)
        record(layernorm_bwd, f"{name} {rows}x{e}" + (",drop" if drop else "")
               + " (column sums rel err "
               f"{col_err:.1e})", torch.cat(out_k[:2], 1),
               torch.cat(out_p[:2], 1), rel_tol(out_p[0]),
               (t_new, host_us(torch, call)),
               plain_ms(lambda: layernorm_bwd.plain(g_in, z, gamma, 1e-5,
                                                    drop)),
               time_ms_eager(torch, lambda: torch.autograd.grad(
                   y, (z_req, g_req, b_req), g_in, retain_graph=True)),
               2 * (3 + (drop is not None)) * rows * e + 3 * 4 * e,
               12 * rows * e, paths=tr,
               exact=col_err < 1e-3 and old_ok and mask_ok and bits_ok
               and one_launch, variant="one_pass", old_ms=old,
               cold=cold_of(None), extra={"old_cold_ms": cold_of("three_pass")})

        # K9 dgrad on the Hopper core: du = round(drop(round(dff W2^T)) *
        # gelu'), dx2 = dz3 + ., and bare (da_s = dsa Wo^T, da_c = dca Woc^T);
        # timed in turns with the wmma kernel it replaces (held to the twin
        # too); with dropout, the dropped elements of the core, the wmma
        # kernel and the twin (K10's mask) the same, bit for bit
        for n, k, kw_name in [(e, f, "drop,mul" if drop else "mul"),
                              (f, e, "add"), (e, e, "bare")] \
                + ([(3 * e, e, "add")] if name == "mae_dec" else []):
            dy, w, other = randn(rows, n), w_of(k, n), randn(rows, k)
            kw = {"drop": drop, "mul": other} if kw_name.endswith("mul") \
                else {"add": other} if kw_name == "add" else {}
            call = lambda v=None, dy=dy, w=w, kw=kw: linear_dgrad(
                dy, w, **kw, variant=v)
            out_k, out_p = call(), linear_dgrad.plain(dy, w, **kw)
            out_o = call("wmma")
            tol = rel_tol(out_p)
            exact = (out_o.float() - out_p.float()).abs().max().item() <= tol
            if kw.get("drop") is not None:
                # K10's mask bit for bit: each output is 0 exactly where the
                # mask drops or where the same call without dropout is 0 (a
                # sum can cancel to 0.0 in one order and not in another)
                dropped = ~keep_mask(drop, rows, k, dev)
                bare = lambda v: linear_dgrad(dy, w, mul=other, variant=v)
                exact &= all(torch.equal(o == 0, dropped | (o_bare == 0))
                             for o, o_bare in (
                                 (out_k, bare(None)), (out_o, bare("wmma")),
                                 (out_p, linear_dgrad.plain(dy, w,
                                                            mul=other))))
            wt = w.t()
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            record(linear_dgrad, f"{name} {rows}x{n}->{k},{kw_name} (sm90)",
                   out_k, out_p, tol, (t_new, host_us(torch, call)),
                   plain_ms(lambda: linear_dgrad.plain(dy, w, **kw)),
                   time_ms(torch, lambda: torch.matmul(dy, wt)),
                   2 * (rows * n + k * n + (2 if kw else 1) * rows * k),
                   2 * rows * n * k, paths=tr, variant="sm90", exact=exact,
                   old_ms=old)

        # K9 wgrad on the Hopper core: dWqkv = x^T dqkv, dWo, dW1 = x2^T du,
        # dW2 = h1^T dff, each with its bias sum, the rows split as
        # row_split_plan says; timed in turns with the wmma kernel it
        # replaces (held to the twin too), cold where the operands fit L2
        for k, n in [(e, 3 * e), (e, e), (e, f), (f, e)]:
            x, dy = randn(rows, k), randn(rows, n)
            call = lambda v=None, x=x, dy=dy: linear_wgrad(x, dy, variant=v)
            (dw_k, db_k), (dw_p, db_p) = call(), linear_wgrad.plain(x, dy)
            db_err = ((db_k - db_p).abs().max() / db_p.abs().max()).item()
            tol = rel_tol(dw_p)
            old_err = (call("wmma")[0].float() - dw_p.float()).abs().max()
            xt = x.t()
            splits = row_split_plan(rows, k, n)[1]
            t_new, old = turns_ms(torch, call, lambda: call("wmma"))
            nbytes = 2 * (rows * k + rows * n + k * n)
            record(linear_wgrad, f"{name} {rows}x{k}^T {rows}x{n}"
                   + (f", rows split {splits}x" if splits > 1 else "")
                   + f" (bias sum rel err {db_err:.1e})", dw_k, dw_p, tol,
                   (t_new, host_us(torch, call)),
                   plain_ms(lambda: linear_wgrad.plain(x, dy)),
                   time_ms(torch, lambda: torch.matmul(xt, dy)),
                   nbytes + 4 * n, 2 * rows * n * k, paths=tr,
                   exact=db_err < 1e-3 and old_err.item() <= tol,
                   variant=f"sm90_splits{splits}", old_ms=old,
                   cold=cold_ms(torch, lambda x_, d_: call(x=x_, dy=d_),
                                [x, dy]) if nbytes < 50e6 else None)
        attention_sites(name, b, t, e, h, tr)


def synthetic_images(np, n: int, seed: int) -> list:
    """Ragged grayscale 'scores': staff-like dark lines on light noise, sizes
    within 150x300 to 1000x1700 px over several aspect ratios."""
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(n):
        h = int(rng.integers(150, 1001))
        w = int(rng.integers(300, 1701))
        img = 235 + 20 * rng.random((h, w))
        for top in range(int(rng.integers(10, 40)), h - 40,
                         int(rng.integers(60, 140))):
            for line in range(5):
                img[top + 6 * line, :] = 30
        imgs.append(img.astype(np.uint8))
    return imgs


class WsgiClient:
    """In-process client of a WSGI application: one call per request, the
    response body read to its end (the whole SSE stream)."""

    def __init__(self, app):
        self.app = app

    def request(self, method, path, body=b"", headers=None, ctype=None):
        path, _, query = path.partition("?")
        environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
                   "QUERY_STRING": query, "CONTENT_LENGTH": str(len(body)),
                   "wsgi.input": io.BytesIO(body)}
        if ctype:
            environ["CONTENT_TYPE"] = ctype
        for k, v in (headers or {}).items():
            environ["HTTP_" + k.upper().replace("-", "_")] = v
        got = {}

        def start_response(status, resp_headers):
            got["status"] = status

        out = b"".join(self.app(environ, start_response))
        if not got["status"].startswith("200"):
            raise RuntimeError(f"{method} {path}: {got['status']} {out[:200]}")
        return out

    def request_json(self, *a, **kw):
        return json.loads(self.request(*a, **kw))

    def transcribe(self, png: bytes, box, before_stream=None) -> dict:
        """/tmpdir/create -> /upload -> /inference/setup (one box) ->
        /inference/stream -> /inference/postprocess -> /clear; the SSE
        events and the stream's latency."""
        call = self.request_json
        hdr = {"X-Tmpdir": call("POST", "/tmpdir/create")["tmpdir"]}
        boundary = "chipsmoke"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="image"; filename="s.png"\r\n'
                f"Content-Type: image/png\r\n\r\n").encode() \
            + png + f"\r\n--{boundary}--\r\n".encode()
        call("POST", "/upload", body, hdr,
             f"multipart/form-data; boundary={boundary}")
        n = call("POST", "/inference/setup",
                 json.dumps({"bboxes": [box]}).encode(), hdr,
                 "application/json")["num_systems"]
        if before_stream is not None:
            before_stream()
        t0 = time.perf_counter()
        text = self.request("GET", "/inference/stream", headers=hdr).decode()
        t1 = time.perf_counter()
        post = call("POST", "/inference/postprocess", headers=hdr)
        call("POST", "/clear", headers=hdr)
        events = [(blk.split("\n")[0].removeprefix("event: "),
                   json.loads(blk.split("\n")[1].removeprefix("data: ")))
                  for blk in text.strip().split("\n\n")]
        return {"events": events, "n_systems": n, "t_stream": t0,
                "t_done": t1, "stream_s": t1 - t0,
                "postprocess_ok": "ok" in post}


def sse_contract(events, n_systems) -> list:
    """Breaches of the SSE contract: per system, encoding_start first, one
    encoding_finish before its first STEP, no STEP after its
    inference_finish, its STEP tokens a prefix of its LMX; inference_finish
    events in system order; all_inference_finish last."""
    bad = []
    if not events or events[-1][0] != "all_inference_finish":
        bad.append("all_inference_finish is not last")
    if [p.get("system") for e, p in events if e == "inference_finish"] \
            != list(range(n_systems)):
        bad.append("inference_finish events out of order or missing")
        return bad
    for s in range(n_systems):
        kinds = [e for e, p in events if p.get("system") == s]
        fin = kinds.index("inference_finish")
        steps = [i for i, k in enumerate(kinds) if k == "step"]
        if kinds[0] != "encoding_start" or kinds.count("encoding_finish") != 1:
            bad.append(f"system {s}: encoding events")
        elif steps and kinds.index("encoding_finish") > steps[0]:
            bad.append(f"system {s}: STEP before encoding_finish")
        if steps and steps[-1] > fin:
            bad.append(f"system {s}: STEP after inference_finish")
        tokens = [t for e, p in events if e == "step" and p["system"] == s
                  for t in p["tokens"]]
        lmx = next(p["lmx"] for e, p in events
                   if e == "inference_finish" and p["system"] == s).split()
        if tokens != lmx[: len(tokens)]:
            bad.append(f"system {s}: STEP tokens not a prefix of the LMX")
    return bad


def serve_path(torch, np, model, imgs) -> dict:
    """The path ``serve_wsgi``: the flagship behind the port's WSGI
    application (``serving.wsgi_app.application``), dynamic batching with
    int8 caches and W4A8 weights (``ACAI_W4A8_DECODE``). SERVE_CLIENTS
    client threads each send one synthetic image as PNG with one box over
    it, wait for each other, then stream and postprocess; then one request
    with batching off (the ``streamed_inference`` branch, bf16 caches). The
    launch counts are set to 0 before the first request and read after the
    last; only the batcher's thread, then the main thread, launch."""
    from PIL import Image

    from acai_omr_tpu_torch.ops import _build, decode_kernel
    from acai_omr_tpu_torch.serving import routes, wsgi_app

    def png(img):
        buf = io.BytesIO()
        Image.fromarray(img, mode="L").save(buf, format="PNG")
        return buf.getvalue()

    pngs = [png(i) for i in imgs[:SERVE_CLIENTS]]
    box = lambda i: [0, 0, imgs[i].shape[1], imgs[i].shape[0]]
    client = WsgiClient(wsgi_app.application)
    saved = (dict(routes._MODEL), routes.MAX_INFERENCE_LEN,
             decode_kernel._W4A8)
    routes._MODEL.clear()
    routes._MODEL.update(cfg=model.cfg, params=model.params,
                         tokenizer=model.tokenizer, transform=model.transform)
    routes.MAX_INFERENCE_LEN = MAX_LEN
    results, errors = [None] * len(pngs), []
    barrier = threading.Barrier(len(pngs))

    def run(i):
        try:
            results[i] = client.transcribe(pngs[i], box(i),
                                           lambda: barrier.wait(120))
        except Exception as e:  # noqa: BLE001 (a failure of the path)
            errors.append(f"client {i}: {e!r}")
            barrier.abort()

    try:
        decode_kernel.set_w4a8(True)
        batcher = routes.enable_dynamic_batching(
            max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS,
            cache_dtype=torch.int8)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(pngs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if any(t.is_alive() for t in threads):
            errors.append("a client did not finish in 600 s")
        stats = batcher.stats.summary()
        routes.disable_dynamic_batching()
        batched = {n: op.launches for n, op in _build.REGISTRY.items()}
        try:
            single = client.transcribe(pngs[0], box(0))
        except Exception as e:  # noqa: BLE001 (a failure of the path)
            errors.append(f"unbatched request: {e!r}")
            single = None
        torch.cuda.synchronize()
    finally:
        routes.disable_dynamic_batching()
        decode_kernel.set_w4a8(saved[2])
        routes._MODEL.clear()
        routes._MODEL.update(saved[0])
        routes.MAX_INFERENCE_LEN = saved[1]
    launches = {n: op.launches for n, op in _build.REGISTRY.items()}
    device = {n: op.device_launches for n, op in _build.REGISTRY.items()}
    done = [r for r in results if r is not None]
    for i, r in enumerate(done + ([single] if single else [])):
        errors += [f"request {i}: {b}"
                   for b in sse_contract(r["events"], r["n_systems"])]
        if not r["postprocess_ok"]:
            errors.append(f"request {i}: postprocess")
    lat = [r["stream_s"] for r in done]
    span = (max(r["t_done"] for r in done)
            - min(r["t_stream"] for r in done)) if done else 0.0
    return {"clients": len(pngs), "completed": len(done),
            "systems_per_s": len(done) / span if span else 0.0,
            "batched_span_s": span,
            "latency_p50_s": float(np.percentile(lat, 50)) if lat else None,
            "latency_p95_s": float(np.percentile(lat, 95)) if lat else None,
            "step_events": [sum(e == "step" for e, _ in r["events"])
                            for r in done],
            "batcher": stats, "unbatched_s": single and single["stream_s"],
            "launches_batched": batched, "launches": launches,
            "device_launches": device, "errors": errors,
            "variants": {n: dict(op.variants)
                         for n, op in _build.REGISTRY.items()}}


def per_op_paths(torch, model, imgs, greedy, quant, transcribe_path,
                 decode_lib, paths, failures):
    """The paths of the per-op step (``ACAI_MONOLITH_DECODE`` off):
    ``decode_hd_bf16`` with K11 on (``ACAI_PALLAS_DECODE=1``) and
    ``decode_hd_int8`` with int8 caches and the defaults (K13, K12 stacked);
    neither may launch a kernel of the monolith step. Then the bf16 step
    without K11 against the step with it, in turns (off, on, on, off), for
    the switch's default on this card. The switches are restored after."""
    from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
    from acai_omr_tpu_torch.ops import decode_kernel

    before = (decode_kernel.use_monolith(), hd._ENABLED, hd._ENABLED_INT8)
    decode_kernel.set_enabled(False)
    turns = []
    try:
        hd.set_enabled(True)
        res = hd_bf16 = transcribe_path("decode_hd_bf16", imgs,
                                        count_steps=True, max_len=MAX_LEN)
        paths["decode_hd_bf16"]["token_share"] = token_share(res, greedy)
        print(f"[path decode_hd_bf16] share of each image's tokens equal to "
              f"greedy_bf16's {paths['decode_hd_bf16']['token_share']}",
              flush=True)
        hd.set_enabled(before[1])
        res = transcribe_path("decode_hd_int8", imgs, count_steps=True,
                              max_len=MAX_LEN, quantized_kv=True)
        paths["decode_hd_int8"]["token_share"] = token_share(res, quant)
        print(f"[path decode_hd_int8] share of each image's tokens equal to "
              f"int8's {paths['decode_hd_int8']['token_share']}; K12 "
              f"launches by form {hd.decode_attention_hd_int8.variants}, "
              f"K13 {hd.self_attention_append_int8.variants}", flush=True)
        for name in ("decode_hd_bf16", "decode_hd_int8"):
            for k in MONOLITH_STEP:
                if paths[name]["launches"][k]:
                    failures.append(f"{name}: launched {k}")
        if any(not v.startswith("stacked_split")
               for v in hd.decode_attention_hd_int8.variants):
            failures.append("decode_hd_int8: K12 ran per layer or its simt "
                            "kernel, not stacked on its cluster kernel")
        for flag in (False, True, True, False):
            hd.set_enabled(flag)
            with counted_steps(decode_lib) as box:
                model.transcribe_batch(imgs, max_len=MAX_LEN)
            r = model.last_result
            turns.append({"k11": flag, "steps": box["n"],
                          "tokens": r.n_tokens,
                          "ms_per_step": 1e3 * r.decode_seconds / box["n"]})
    finally:
        decode_kernel.set_enabled(before[0])
        hd.set_enabled(before[1])
        hd.set_enabled_int8(before[2])
    print(f"[per-op bf16 step, K11 off / on in turns] {json.dumps(turns)}",
          flush=True)
    return turns, hd_bf16


def expected_tp_step(dcfg, tp: int, per_op: bool) -> tuple:
    """(wrapper calls, device kernels) of one data shard's decode step over
    ``tp`` model ranks, from the layer arithmetic. The monolith step (K1
    products, or K5 under ACAI_TP_W8A8): per layer and rank six products
    (three of them fp32 partials), two attentions, three K4; per layer three
    K15 launches (one per row-parallel site, every rank of this card in it).
    Each is one device kernel (the skinny kernel and K5's cluster kernel sum
    their split K inside their launch). The per-op step: K15 three times a
    layer, K11 twice a layer and rank where it is on; the rest is
    PyTorch."""
    from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
    l = dcfg.num_layers
    n = l * (3 + (2 * tp if hd._ENABLED else 0)) if per_op \
        else l * (tp * 11 + 3)
    return n, n


def mesh_step_checks(torch, model, imgs, mesh, cache_dtype, monolith: bool,
                     beam_size: int = 1) -> dict:
    """The meshed decode step against two references on one encoder output
    (rows x ``beam_size`` decode rows over ``beam_size``-row memory groups):
    the first step's largest |logit difference| against the unsharded step
    of the same mode (weights as ``weight_quant_mode(cache, tp_mono=True)``
    says), and, on the monolith step, TP_CMP_STEPS steps of every data shard
    with the kernels against the same steps with ``plain=True`` (the twins
    of K1 / K5 partials, K15 and the rest, on the same shard operands), the
    kernel path's greedy token fed to both: the largest |logit difference|
    and the token agreement."""
    from acai_omr_tpu_torch.models import decode as dl
    from acai_omr_tpu_torch.models import vit_encoder, vitomr
    from acai_omr_tpu_torch.ops import decode_kernel

    cfg, dt = model.cfg, model.compute_dtype
    pb = vit_encoder.batchify([model._load_image(i) for i in imgs],
                              cfg.encoder)
    lat, valid = vitomr.encode_image(model.params, cfg, *pb.to(model.device),
                                     compute_dtype=dt)
    dec, dcfg = model.params["decoder"], cfg.decoder
    layout = "te" if monolith else "hd"
    tt = dl.time_tile(cache_dtype) if monolith else 1
    k, steps = beam_size, TP_CMP_STEPS
    mem = dl.precompute_memory_kv(dec, dcfg, lat, valid, dt, cache_dtype,
                                  layout=layout)

    def state(rows, devs=None):
        return dl.init_decode_state(dcfg, rows * k, steps + 1,
                                    -(-(steps + 1) // tt) * tt, cache_dtype,
                                    model.device, monolith, devs)

    mono = dl.prepack(dec, dt, quantize_weights=decode_kernel
                      .weight_quant_mode(cache_dtype, True)) \
        if monolith else None
    b = lat.shape[0]
    ref = dl.step_logits(dec, dcfg, mono, state(b), mem, dt, mem_group=k)
    nd, tp = mesh.shape["data"], mesh.shape["model"]
    split = dl.prepare_tp_decode_params(dec, dcfg, mesh)
    rows = b // nd
    first = err = 0.0
    agree = n = 0
    for d in range(nd):
        devs = mesh.devices[d]
        sl = slice(d * rows, (d + 1) * rows)
        mems = [dl._shard_memory(mem, sl, r, tp, devs[r], layout)
                for r in range(tp)]
        monos = [dl._prepack_for(p, dt, cache_dtype, True)
                 for p in split[d]] if monolith else None

        def run(s, plain):
            return dl.step_logits(split[d], dcfg, monos, s, mems, dt,
                                  plain=plain, mem_group=k,
                                  tp_group=mesh.tp_group(d))

        sk, sp = state(rows, devs), state(rows, devs)
        lk = run(sk, False)
        first = max(first, (lk.float() - ref[d * rows * k:(d + 1) * rows * k]
                            .float()).abs().max().item())
        for i in range(steps if monolith else 0):
            if i:
                lk = run(sk, False)
            lp = run(sp, True)
            tok = lk.argmax(-1)
            agree += int((lp.argmax(-1) == tok).sum())
            n += tok.numel()
            err = max(err, (lk - lp).abs().max().item())
            for s in (sk, sp):
                s.seqs[:, s.t] = tok
                s.t += 1
    out = {"first_step_logit_max_abs_diff": first,
           "logit_max_abs": ref.abs().max().item()}
    if monolith:
        out.update(kernel_vs_plain_steps=steps,
                   kernel_vs_plain_logit_max_abs_err=err,
                   kernel_vs_plain_token_agreement=agree / n)
    return out


def mesh_paths(torch, model, imgs, decode_lib, paths, failures, finish_path,
               refs):
    """The meshed decode (TP_PATHS) through ``batch_inference(mesh=,
    model_axis="model")`` at the flagship width and depth, every shard on
    cuda:0: tp = 2 and 4 (bf16 caches), tp = 2 with int8 caches and W8A8 off
    (K5 may not launch), again with ``ACAI_TP_W8A8`` (K5 partials), tp = 2
    beams, a 2 x 2 mesh with ``progress_cb`` events, and the per-op step
    (``ACAI_MONOLITH_DECODE`` off, K11 on). Per path: ms per step (a step is
    one data shard's step), wrapper calls and device kernels per step held
    against :func:`expected_tp_step`, K15 launches, the share of tokens
    equal to the unsharded path ``refs[...]`` of the same mode (reported,
    not held: seeded near-ties split any two bf16 paths here), and
    :func:`mesh_step_checks`, held: the first step's logits against the
    unsharded step, and on the monolith step TP_CMP_STEPS steps of the
    kernels against their twins, to compare_paths' limits."""
    from acai_omr_tpu_torch.inference.batch_inference import batch_inference
    from acai_omr_tpu_torch.ops import _build, decode_kernel
    from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
    from acai_omr_tpu_torch.parallel.mesh import make_mesh

    arrays = [model._load_image(i) for i in imgs]
    saved = (decode_kernel._ENABLED, decode_kernel._TP_W8A8, hd._ENABLED)
    dcfg = model.cfg.decoder
    try:
        for name, ((nd, nm), n_img, max_len, kw, ref) in TP_PATHS.items():
            per_op = name == "tp2_per_op"
            decode_kernel.set_enabled(not per_op)
            hd.set_enabled(per_op or saved[2])
            decode_kernel.set_tp_w8a8(name == "tp2_int8_w8a8")
            kw = dict(kw)
            cache = torch.int8 if kw.pop("cache_dtype", None) == "int8" \
                else model.compute_dtype
            mesh = make_mesh(nd, nm, ["cuda:0"] * (nd * nm))
            events = []
            cb = (lambda gi, s, t, fin: events.append((tuple(gi), t))) \
                if name == "dp2_tp2" else None
            _build.reset_launch_counts()
            with counted_steps(decode_lib) as box:
                t0 = time.perf_counter()
                res = batch_inference(
                    model.params, model.cfg, arrays[:n_img], model.tokenizer,
                    max_inference_len=max_len,
                    compute_dtype=model.compute_dtype, cache_dtype=cache,
                    device=model.device, mesh=mesh, model_axis="model",
                    progress_cb=cb, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if not (len(res.lmx) == n_img and all(res.lmx)
                    and all(math.isfinite(v) for v in res.avg_log_probs)):
                failures.append(f"{name}: output")
            want = [expected_tp_step(dcfg, nm, per_op)] * len(box["rows"])
            steps = max(box["n"], 1)
            finish_path(name, res.n_tokens, res.decode_seconds, {
                "mesh": [nd, nm], "wall_s": wall,
                "encode_s": res.encode_seconds,
                "expected_wrapper_calls_per_step":
                    sum(w for w, _ in want) / steps,
                "expected_device_kernels_per_step":
                    sum(d for _, d in want) / steps,
                f"token_share_vs_{ref}": token_share(res, refs[ref])},
                steps=box["n"])
            r = paths[name]
            r["tp_allreduce_per_step"] = r["launches"]["tp_allreduce"] / steps
            for got, exp in (("wrapper_calls_per_step",
                              "expected_wrapper_calls_per_step"),
                             ("device_kernels_per_step",
                              "expected_device_kernels_per_step")):
                if abs(r[got] - r[exp]) > 1e-9:
                    failures.append(f"{name}: {got} {r[got]} differ from the "
                                    f"layer arithmetic {r[exp]}")
            if name == "tp2_int8" and r["launches"]["quant_linear_bias_act"]:
                failures.append("tp2_int8: launched quant_linear_bias_act "
                                "with ACAI_TP_W8A8 off")
            if per_op:
                for k in MONOLITH_STEP:
                    if r["launches"][k]:
                        failures.append(f"{name}: launched {k}")
            if cb is not None:
                by_group = {}
                for gi, t in events:
                    by_group.setdefault(gi, []).append(t)
                r["progress_events"] = len(events)
                if not events or any(i not in range(n_img)
                                     for gi in by_group for i in gi) \
                        or any(ts != sorted(ts) for ts in by_group.values()):
                    failures.append(f"{name}: progress events")
            chk = mesh_step_checks(torch, model, imgs[:n_img], mesh, cache,
                                   not per_op, kw.get("beam_size", 1))
            r.update(chk)
            if not chk["first_step_logit_max_abs_diff"] < CMP_LOGIT_TOL:
                failures.append(f"{name}: first-step logits vs the unsharded "
                                f"step")
            if not per_op and not (
                    chk["kernel_vs_plain_logit_max_abs_err"] < CMP_LOGIT_TOL
                    and chk["kernel_vs_plain_token_agreement"]
                    >= CMP_AGREEMENT):
                failures.append(f"{name}: kernel path vs plain path")
            print(f"[path {name}] tp_allreduce per step "
                  f"{r['tp_allreduce_per_step']:.1f}; {json.dumps(chk)}; "
                  f"token share vs {ref} {r[f'token_share_vs_{ref}']}",
                  flush=True)
    finally:
        decode_kernel.set_enabled(saved[0])
        decode_kernel.set_tp_w8a8(saved[1])
        hd.set_enabled(saved[2])


def weight_paths(model, imgs, quant, transcribe_path, paths, failures,
                 n_layers):
    """The weight switches under int8 caches: ``w4a8`` (``ACAI_W4A8_DECODE``
    on: K14 products, no K5) and ``int8_bf16w`` (``ACAI_W8A8_DECODE`` off:
    K1 products at decode shapes, no K5 or K14), each against the ``int8``
    path (W8A8) just driven. The switches are restored after. Also the
    time of the int4 prepack of the decoder's weights, once packed anew and
    once returned from ``_prepack_for``'s cache (what each later batch
    pays)."""
    import torch
    from acai_omr_tpu_torch.models import decode as decode_lib
    from acai_omr_tpu_torch.ops import decode_kernel

    before = (decode_kernel._W8A8, decode_kernel._W4A8)
    try:
        decode_kernel.set_w4a8(True)
        prepack_ms = []
        for fresh in (True, False):
            if fresh:
                decode_lib._PREPACKED.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_lib._prepack_for(model.params["decoder"],
                                    model.compute_dtype, torch.int8)
            torch.cuda.synchronize()
            prepack_ms.append(1e3 * (time.perf_counter() - t0))
        decode_lib._PREPACKED.clear()
        w4 = transcribe_path("w4a8", imgs, max_len=MAX_LEN, quantized_kv=True)
        paths["w4a8"].update(prepack_int4_ms=prepack_ms[0],
                             prepack_cached_ms=prepack_ms[1])
        print(f"[path w4a8] int4 prepack {prepack_ms[0]:.3f} ms, from the "
              f"cache {prepack_ms[1]:.4f} ms", flush=True)
        decode_kernel.set_w4a8(False)
        decode_kernel.set_w8a8(False)
        bw = transcribe_path("int8_bf16w", imgs, max_len=MAX_LEN,
                             quantized_kv=True)
    finally:
        decode_kernel.set_w8a8(before[0])
        decode_kernel.set_w4a8(before[1])
    for name, res in (("w4a8", w4), ("int8_bf16w", bw)):
        r = paths[name]
        r["token_share_vs_int8"] = token_share(res, quant)
        r["ms_per_step_over_int8"] = r["ms_per_step"] \
            / paths["int8"]["ms_per_step"]
        print(f"[path {name}] share of each image's tokens equal to int8's "
              f"{r['token_share_vs_int8']}; ms per step over int8's "
              f"{r['ms_per_step_over_int8']:.4f}", flush=True)
    lw, lb = paths["w4a8"]["launches"], paths["int8_bf16w"]["launches"]
    if lw["quant_linear_bias_act"]:
        failures.append("w4a8: launched quant_linear_bias_act")
    if lb["quant_linear_bias_act"] or lb["quant4_linear_bias_act"]:
        failures.append("int8_bf16w: launched a quantized product")
    # K1 at decode shapes: what the encoder's 4 K1 per K3 launch leave
    decode_k1 = lb["linear_bias_act"] - 4 * lb["encoder_attention"]
    paths["int8_bf16w"]["decode_linear_bias_act"] = decode_k1
    if decode_k1 < 6 * n_layers * paths["int8_bf16w"]["steps"]:
        failures.append("int8_bf16w: too few K1 launches at decode shapes")
    return bw


def compare_paths(torch, np, model, imgs, profile=False):
    """Kernel path vs plain path on the card: encoder stack output and
    CMP_STEPS greedy decode steps at B = len(imgs), with caches in the
    compute dtype, in int8 (with W8A8 weights) and in int8 with W4A8 weights.
    ``profile`` adds a torch.profiler window over kernel-path decode steps
    of each mode."""
    from acai_omr_tpu_torch.models import decode as decode_lib
    from acai_omr_tpu_torch.ops import decode_kernel
    from acai_omr_tpu_torch.models import vit_encoder
    from acai_omr_tpu_torch.ops.encoder_stack_kernel import encoder_stack_fused

    cfg, params, dt = model.cfg, model.params, model.compute_dtype
    arrays = [model._load_image(i) for i in imgs]
    pb = vit_encoder.batchify(arrays, cfg.encoder)
    patches, pe_idx, pe_w, valid = pb.to(model.device)
    enc = params["encoder"]
    x = vit_encoder.embed_patches(enc, patches, pe_idx, pe_w, valid, dt)
    hk = encoder_stack_fused(enc["blocks"], x, valid, cfg.encoder.num_heads)
    hp = encoder_stack_fused(enc["blocks"], x, valid, cfg.encoder.num_heads,
                             plain=True)
    diff = (hk.float() - hp.float()).abs()[valid]
    enc_err = diff.max().item()
    enc_rel = (diff.norm() / hp.float()[valid].norm()).item()

    from acai_omr_tpu_torch.models import vitomr
    from acai_omr_tpu_torch.ops import _build, nn
    lat = vitomr.transition_head(
        params["transition_head"],
        nn.layernorm(enc["final_norm"], hk, eps=1e-6))
    dec, dcfg = params["decoder"], cfg.decoder
    b = lat.shape[0]
    out = {"encoder_max_abs_err": enc_err, "encoder_rel_err": enc_rel,
           "decode_steps": CMP_STEPS, "rows": b}
    w4a8 = decode_kernel._W4A8
    for key, cache_dtype in (("bf16", dt), ("int8", torch.int8),
                             ("w4a8", torch.int8)):
        mem = decode_lib.precompute_memory_kv(dec, dcfg, lat, valid, dt,
                                              cache_dtype)
        decode_kernel.set_w4a8(key == "w4a8")
        try:
            mono = decode_lib._prepack_for(dec, dt, cache_dtype)
        finally:
            decode_kernel.set_w4a8(w4a8)
        sk, sp = (decode_lib.init_decode_state(
            dcfg, b, CMP_STEPS + 1, CMP_STEPS, cache_dtype, model.device)
            for _ in range(2))
        step_err, agree = [], 0
        _build.reset_launch_counts()
        for _ in range(CMP_STEPS):
            lk = decode_lib.step_logits(dec, dcfg, mono, sk, mem, dt)
            lp = decode_lib.step_logits(dec, dcfg, mono, sp, mem, dt,
                                        plain=True)
            tok = lk.argmax(-1)
            agree += int((lp.argmax(-1) == tok).sum())
            step_err.append((lk - lp).abs().max().item())
            for s in (sk, sp):
                s.seqs[:, s.t] = tok
                s.t += 1
        out[key] = {
            "token_agreement": agree / (CMP_STEPS * b),
            "logit_max_abs_err": max(step_err),
            "logit_max_abs_err_first8": step_err[:8],
            "logits_finite": all(math.isfinite(v) for v in step_err),
            # the plain path launches no kernel: these are the kernel path's
            "wrapper_calls_per_step": sum(
                op.launches for op in _build.REGISTRY.values()) / CMP_STEPS,
            "device_kernels_per_step": sum(
                op.device_launches
                for op in _build.REGISTRY.values()) / CMP_STEPS}
        if profile:
            # the W8A8 step also with K5 forced to the three-launch form it
            # replaced, in turns
            from acai_omr_tpu_torch.ops.quant_linear_kernel import \
                quant_linear_bias_act
            for form in ("", "_simt") if key == "int8" else ("",):
                state = decode_lib.init_decode_state(
                    dcfg, b, CMP_STEPS + 1, CMP_STEPS, cache_dtype,
                    model.device)
                with forced_variant(quant_linear_bias_act,
                                    "simt" if form else None):
                    out[key]["profile" + form] = profile_steps(
                        torch, lambda: _greedy_step(decode_lib, dec, dcfg,
                                                    mono, state, mem, dt),
                        warmup=8, steps=32)
    out["int8_vs_per_op"] = int8_vs_per_op(torch, decode_lib, decode_kernel,
                                           dec, dcfg, lat, valid, dt,
                                           model.device)
    if profile:
        # K2's device ms a bf16 step; K11's a per-op bf16 step (K11 on, the
        # lane-major caches and memory of decode_hd_bf16); K12's and K13's a
        # per-op int8 step (the defaults of decode_hd_int8); K6's a step of
        # each int8 mode, K5's of the int8 step, K14's of the W4A8 step (the
        # cluster kernels, and the kernels of the forms they replaced, which
        # no step may run)
        from acai_omr_tpu_torch.ops import decode_hd_kernel as hd
        out["bf16"]["k2_device_ms_per_step"] = kernel_ms(
            out["bf16"]["profile"], "attend_cluster", "decode_attention_kernel")
        out["bf16"]["k4_device_ms_per_step"] = kernel_ms(
            out["bf16"]["profile"], "add_layernorm")
        for key in ("int8", "w4a8"):
            out[key]["k6_device_ms_per_step"] = kernel_ms(
                out[key]["profile"], "attend_int8_cluster",
                "decode_attention_int8_kernel")
        for form in ("", "_simt"):
            out["int8"][f"k5{form}_device_ms_per_step"] = kernel_ms(
                out["int8"]["profile" + form], "quant8_cluster",
                "quant_linear_kernel<false>", "quantize_rows_kernel",
                "reduce_kernel")
        out["w4a8"]["k14_device_ms_per_step"] = kernel_ms(
            out["w4a8"]["profile"], "quant4_cluster",
            "quant_linear_kernel<true>", "quantize_rows_kernel",
            "reduce_kernel")
        before = hd._ENABLED
        hd.set_enabled(True)
        try:
            mem = decode_lib.precompute_memory_kv(dec, dcfg, lat, valid, dt,
                                                  dt, layout="hd")
            state = decode_lib.init_decode_state(
                dcfg, b, CMP_STEPS + 1, CMP_STEPS, dt, model.device,
                monolith=False)
            prof = profile_steps(
                torch, lambda: _greedy_step(decode_lib, dec, dcfg, None,
                                            state, mem, dt), warmup=8,
                steps=32)
        finally:
            hd.set_enabled(before)
        out["per_op_bf16"] = {"profile": prof, "k11_device_ms_per_step":
                              kernel_ms(prof, "attend_hd_cluster",
                                        "decode_attention_hd_kernel")}
        # the per-op int8 step, then with K13 and with K12 forced to the
        # simt kernels they replaced, in turns
        mem = decode_lib.precompute_memory_kv(dec, dcfg, lat, valid, dt,
                                              torch.int8, layout="hd")
        out["per_op_int8"] = {}
        for form, op_ in (("", None),
                          ("_k13simt", hd.self_attention_append_int8),
                          ("_simt", hd.decode_attention_hd_int8)):
            state = decode_lib.init_decode_state(
                dcfg, b, CMP_STEPS + 1, CMP_STEPS, torch.int8, model.device,
                monolith=False)
            with forced_variant(op_ or hd.decode_attention_hd_int8,
                                "simt" if op_ else None):
                prof = profile_steps(
                    torch, lambda: _greedy_step(decode_lib, dec, dcfg, None,
                                                state, mem, dt), warmup=8,
                    steps=32)
            out["per_op_int8"].update({
                "profile" + form: prof,
                f"k12{form}_device_ms_per_step": kernel_ms(
                    prof, "attend_hd_int8_cluster",
                    "decode_attention_hd_int8_kernel"),
                f"k13{form}_device_ms_per_step": kernel_ms(
                    prof, "append_hd_int8_cluster",
                    "self_attention_append_int8_kernel")})
    return out


def int8_vs_per_op(torch, decode_lib, decode_kernel, dec, dcfg, lat, valid,
                   dt, device, steps: int = 24) -> dict:
    """The monolith int8 step (K6; W8A8 weights, then compute-dtype weights)
    against the per-op int8 step (K13 / K12, compute-dtype weights) on one
    batch: the first step's largest |logit difference|, each row whose
    greedy token differs with its top-1 margin (top-1 minus top-2 logit) on
    both sides, then ``steps`` free-running greedy steps of each: the share
    of equal tokens and the step at which each row first emits <eos>."""
    b = lat.shape[0]
    w8a8 = decode_kernel._W8A8

    def run(mono, mem, monolith):
        state = decode_lib.init_decode_state(dcfg, b, steps + 1, 32,
                                             torch.int8, device, monolith)
        first, toks = None, []
        for _ in range(steps):
            lg = decode_lib.step_logits(dec, dcfg, mono, state, mem, dt)
            first = lg if first is None else first
            tok = lg.argmax(-1)
            toks.append(tok)
            state.seqs[:, state.t] = tok
            state.t += 1
        return first, torch.stack(toks, 1)

    def eos_at(toks):
        hit = toks == dcfg.eos_idx
        return [int(r.nonzero()[0]) + 1 if r.any() else None for r in hit]

    margin = lambda lg: (lambda v: (v[:, 0] - v[:, 1]))(lg.topk(2, -1).values)
    mem_hd = decode_lib.precompute_memory_kv(dec, dcfg, lat, valid, dt,
                                             torch.int8, layout="hd")
    per_op, per_op_toks = run(None, mem_hd, False)
    out = {"per_op_eos_step": eos_at(per_op_toks)}
    mem = decode_lib.precompute_memory_kv(dec, dcfg, lat, valid, dt,
                                          torch.int8)
    try:
        for key, flag in (("w8a8", True), ("bf16w", False)):
            decode_kernel.set_w8a8(flag)
            mono = decode_lib._prepack_for(dec, dt, torch.int8)
            first, toks = run(mono, mem, True)
            diff = (first - per_op).abs()
            rows = (first.argmax(-1) != per_op.argmax(-1)).nonzero()[:, 0]
            out[key] = {
                "first_logit_max_abs_diff": diff.max().item(),
                "differing_rows": [
                    {"row": int(r), "margin_monolith": margin(first)[r].item(),
                     "margin_per_op": margin(per_op)[r].item()}
                    for r in rows],
                "token_share": (toks == per_op_toks).float().mean().item(),
                "eos_step": eos_at(toks)}
    finally:
        decode_kernel.set_w8a8(w8a8)
    print(f"[int8 monolith vs per-op] {json.dumps(out)}", flush=True)
    return out


@contextlib.contextmanager
def forced_variant(op, variant):
    """Every launch of ``op`` inside the block takes ``variant`` (a
    redesigned kernel's replaced form, for a profile window of the step in
    turns with it); None leaves the op as it is."""
    launch = op._launch
    if variant is not None:
        op._launch = lambda op_, *a, **kw: launch(op_, *a,
                                                   **{**kw, "variant": variant})
    try:
        yield
    finally:
        op._launch = launch


def kernel_ms(prof: dict, *names) -> float:
    """Device ms a step of the kernels whose names contain one of
    ``names``, from a ``profile_steps`` window."""
    return sum(r["ms_per_step"] for r in prof["all"]
               if any(n in r["kernel"] for n in names))


def _greedy_step(decode_lib, dec, dcfg, mono, state, mem, dt):
    tok = decode_lib.step_logits(dec, dcfg, mono, state, mem, dt).argmax(-1)
    state.seqs[:, state.t] = tok
    state.t += 1


def profile_steps(torch, step, warmup: int, steps: int) -> dict:
    """Device busy share and device time by kernel over ``steps`` steps
    (decode steps or training microbatches; torch.profiler, CUDA activity),
    against their host wall time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):  # kernels only, not host ops
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    every = [{"kernel": k[:80], "ms_per_step": us / steps / 1e3,
              "calls_per_step": c / steps} for us, k, c in rows]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy / steps / 1e3,
            "device_busy_share": busy / wall_us, "top": every[:12],
            "all": every}


def training_set(tokenizer, n: int, seed: int):
    """Seeded synthetic stage-2 examples: images of 512-1,024 patches, token
    sequences that pad to T = 256."""
    from acai_omr_tpu_torch.data.datasets import DebugDataset
    return DebugDataset(n=n, sizes=TRAIN_SIZES, seq_len=TRAIN_SEQ_LEN,
                        vocab=tokenizer.vocab_size, kind="omr", seed=seed)


def train_path(torch, model, tmp_dir):
    """The path ``train_tf``: a few optimizer steps of stage-2 training
    through ``omr_teacher_force_train`` at the flagship's full width. The
    launch counts are set to 0 just before and read just after; the hook
    reads them in between without resetting them."""
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train

    tok = model.tokenizer
    n_train = TRAIN_BATCH * TRAIN_ACCUM * TRAIN_UPDATES
    train_ds = training_set(tok, n_train, SEED)
    val_ds = training_set(tok, TRAIN_BATCH, SEED + 1)
    start = trainer.tree_map(lambda v: v.float().clone(), model.params)
    counts = lambda: {n: op.launches for n, op in _build.REGISTRY.items()}
    log = {"micro_ms": [], "update_ms": [], "val_ms": [], "micro_launches": [],
           "val_launches": [], "shapes": [], "grads_finite": True}
    last = {"t": None, "counts": None}

    def tick():
        torch.cuda.synchronize()
        now, c = time.perf_counter(), counts()
        dt = 1e3 * (now - last["t"])
        delta = {k: c[k] - last["counts"].get(k, 0) for k in c
                 if c[k] != last["counts"].get(k, 0)}
        last.update(t=now, counts=c)
        return dt, delta

    def hook(kind, info):
        dt, delta = tick()
        if kind == "micro":
            log["micro_ms"].append(dt)
            log["micro_launches"].append(delta)
            log["shapes"].append([tuple(info["batch"]["patches"].shape[:2]),
                                  tuple(info["batch"]["inputs"].shape)])
        elif kind == "update":
            log["update_ms"].append(dt)
            log["grads_finite"] &= all(
                bool(torch.isfinite(g).all())
                for g in trainer.tree_flatten(info["grads"]).values())
            last["t"] = time.perf_counter()  # the check is not a step's time
        else:
            log["val_ms"].append(dt)
            log["val_launches"].append(delta)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    last.update(t=time.perf_counter(), counts=counts())
    t0 = time.perf_counter()
    params, stats = tf_train.omr_teacher_force_train(
        model.cfg, model.params, train_ds, val_ds, tok, epochs=1,
        batch_size=TRAIN_BATCH, grad_accumulation_steps=TRAIN_ACCUM,
        warmup_epochs=1, checkpoint_freq=1, model_dir=Path(tmp_dir) / "tf",
        num_workers=4, tf_anneal_epochs=1, soft_epochs=1, seed=SEED,
        bucket_boundaries=[max(TRAIN_SIZES)],  # one bucket: no ragged tails
        compute_dtype=model.compute_dtype, device=model.device,
        step_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    device = {n: op.device_launches for n, op in _build.REGISTRY.items()}

    # every leaf the optimizer scales by something other than 0 must have
    # moved, every other must be bit-unchanged
    scales = trainer.tree_flatten(trainer.encoder_llrd_scales(
        params, model.cfg, tf_train.FINE_TUNE_BASE_LR / tf_train.BASE_LR,
        tf_train.FINE_TUNE_DECAY_FACTOR))
    before, after = trainer.tree_flatten(start), trainer.tree_flatten(params)
    unmoved, moved_frozen = [], []
    for path, sc in scales.items():
        tuned = (torch.as_tensor(sc, device=after[path].device) != 0) \
            .expand_as(after[path])
        changed = after[path] != before[path]
        if bool(tuned.any()) and not bool((changed & tuned).any()):
            unmoved.append(path)
        if bool((changed & ~tuned).any()):
            moved_frozen.append(path)
    files = sorted(str(f.relative_to(tmp_dir))
                   for f in Path(tmp_dir).rglob("*") if f.is_file())
    return {"window_losses": stats["window_losses"],
            "val_losses": stats["val_losses"], "wall_s": wall,
            "micro_ms": log["micro_ms"], "update_ms": log["update_ms"],
            "val_ms": log["val_ms"], "shapes": log["shapes"],
            "launches_per_microbatch": log["micro_launches"],
            "launches_per_val_batch": log["val_launches"],
            "grads_finite": log["grads_finite"], "unmoved": unmoved,
            "moved_frozen": moved_frozen, "files": files,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "device_launches": device,
            "variants": {n: dict(op.variants)
                         for n, op in _build.REGISTRY.items()}}


def path_counts(torch) -> dict:
    """The launch counts read just after a path's run (launches, device
    launches, by variant)."""
    from acai_omr_tpu_torch.ops import _build
    torch.cuda.synchronize()
    return {"launches": {n: op.launches for n, op in _build.REGISTRY.items()},
            "device_launches": {n: op.device_launches
                                for n, op in _build.REGISTRY.items()},
            "variants": {n: dict(op.variants)
                         for n, op in _build.REGISTRY.items()}}


def vitomr_api_path(torch, np, model, imgs) -> dict:
    """The path ``vitomr_api``: the flagship's seeded bf16 weights through
    the reference's state-dict layouts and back on the card (the plain
    ``encoder_blocks`` layout and FineTuneOMREncoder's at fine-tune depth 4;
    every leaf bit-equal, dtype too), then, on the weights read back, the
    entry points of ``models/vitomr``: ``encode_image`` of the 8 images,
    ``cached_greedy_generate`` (max_len 512) and ``cached_beam_generate``
    (4 images, 4 beams, max_len 256), each held bit for bit against
    ``decode.generate`` / ``decode.beam_generate`` on the same latent (run
    first, outside the counted window), and ``generate_next_token_distr``
    for one padded image with its ``latent_valid`` over NEXT_PREFIXES
    prefixes of its greedy output, each call launching K3 (kernel path);
    afterwards, uncounted, each distribution against the plain twins'
    (``transformer.plain_twins``) and its argmax against the greedy next
    token."""
    from acai_omr_tpu_torch.models import decode, torch_compat, vit_encoder
    from acai_omr_tpu_torch.models import vitomr
    from acai_omr_tpu_torch.models.weights import _flatten
    from acai_omr_tpu_torch.ops import _build, transformer

    cfg, params, dt, dev = (model.cfg, model.params, model.compute_dtype,
                            model.device)
    t0 = time.perf_counter()
    flat = _flatten(params)
    round_trip = {}
    for depth in (None, 4):
        back = _flatten(torch_compat.vitomr_params_from_torch(
            torch_compat.vitomr_state_dict_from_params(params, depth),
            device=dev))
        round_trip[f"depth_{depth}"] = back.keys() == flat.keys() and all(
            back[k].dtype == v.dtype and torch.equal(back[k], v)
            for k, v in flat.items())
    api = torch_compat.vitomr_params_from_torch(
        torch_compat.vitomr_state_dict_from_params(params, 4), device=dev)
    round_trip_s = time.perf_counter() - t0
    pb = vit_encoder.batchify([model._load_image(i) for i in imgs],
                              cfg.encoder)
    kw = dict(compute_dtype=dt, cache_dtype=dt)
    with torch.no_grad():
        lat, lv = vitomr.encode_image(params, cfg, *pb.to(dev),
                                      compute_dtype=dt)
        want_g = decode.generate(params["decoder"], cfg.decoder, lat, lv,
                                 max_len=MAX_LEN, **kw)
        want_b = decode.beam_generate(
            params["decoder"], cfg.decoder, lat[:BEAM_IMAGES],
            lv[:BEAM_IMAGES], beam_size=BEAM_SIZE, max_len=BEAM_MAX_LEN, **kw)

    _build.reset_launch_counts()
    t1 = time.perf_counter()
    k3 = _build.REGISTRY["encoder_attention"]
    with torch.no_grad():
        lat2, lv2 = vitomr.encode_image(api, cfg, *pb.to(dev),
                                        compute_dtype=dt)
        got_g = vitomr.cached_greedy_generate(api, cfg, lat2, lv2,
                                              max_len=MAX_LEN, **kw)
        got_b = vitomr.cached_beam_generate(
            api, cfg, lat2[:BEAM_IMAGES], lv2[:BEAM_IMAGES],
            beam_size=BEAM_SIZE, max_len=BEAM_MAX_LEN, **kw)
        row = next(i for i in range(len(imgs)) if not bool(lv2[i].all()))
        n_seq = int(got_g[2][row].sum())
        prefixes = sorted({int(t) for t in np.linspace(
            1, n_seq - 1, NEXT_PREFIXES)})
        one = lambda t: vitomr.generate_next_token_distr(
            api, cfg, lat2[row:row + 1], got_g[0][row:row + 1, :t],
            compute_dtype=dt, latent_valid=lv2[row:row + 1])
        dists, through_kernels = [], True
        for t in prefixes:
            before = k3.launches
            dists.append(one(t))
            through_kernels &= k3.launches > before
    counts = path_counts(torch)
    wall = time.perf_counter() - t1
    with torch.no_grad(), transformer.plain_twins():
        plain = [one(t) for t in prefixes]
    err = max((d.float() - p.float()).abs().max().item()
              for d, p in zip(dists, plain))
    agree = float(np.mean([int(d.argmax(-1)) == int(got_g[0][row, t])
                           for d, t in zip(dists, prefixes)]))
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    return {"round_trip": round_trip, "round_trip_s": round_trip_s,
            "greedy_equal": same(got_g, want_g),
            "beam_equal": same(got_b, want_b),
            "greedy_tokens": int(got_g[2].sum()) - len(imgs),
            "next_token_row": row, "next_token_prefixes": prefixes,
            "next_token_through_kernels": bool(through_kernels),
            "next_token_logprob_max_abs_err": err,
            "next_token_argmax_agreement": agree,
            "next_token_finite": all(bool(torch.isfinite(d).all())
                                     for d in dists),
            "wall_s": wall, **counts}


def eval_layout(np, root, n: int) -> None:
    """A GrandStaff + OLiMPiC test layout under ``root``, ``n`` examples a
    split (as tests/test_eval_harness.py writes it): seeded synthetic score
    images (GrandStaff's original and distorted JPEGs, OLiMPiC's PNGs), LMX
    from tests/data's sample files."""
    from PIL import Image
    lmx = [" ".join(f.read_text().replace("<eos>", "").split()) for f in
           sorted((ROOT / "tests" / "data").glob("sample_lmx_*.txt"))]
    imgs = iter(synthetic_images(np, 4 * n, SEED + 7))
    gs = root / "grandstaff"
    (gs / "grandstaff").mkdir(parents=True)
    ids = [f"piece{i}" for i in range(n)]
    (gs / "samples.test.txt").write_text("\n".join(ids) + "\n")
    for i, ex in enumerate(ids):
        Image.fromarray(next(imgs)).save(gs / "grandstaff" / f"{ex}.jpg")
        Image.fromarray(next(imgs)).save(
            gs / "grandstaff" / f"{ex}_distorted.jpg")
        (gs / f"{ex}.lmx").write_text(lmx[i % len(lmx)] + "\n")
    for split in ("synthetic", "scanned"):
        d = root / split
        d.mkdir()
        oids = [f"score{i}" for i in range(n)]
        (d / "samples.test.txt").write_text("\n".join(oids) + "\n")
        for i, ex in enumerate(oids):
            Image.fromarray(next(imgs)).save(d / f"{ex}.png")
            (d / f"{ex}.lmx").write_text(lmx[i % len(lmx)] + "\n")


@contextlib.contextmanager
def k1_shapes(shapes: set):
    """Adds the (M, K, N, act) of every K1 launch inside the block to
    ``shapes``; the launch itself is unchanged."""
    from acai_omr_tpu_torch.ops.linear_kernel import linear_bias_act as op
    launch = op._launch

    def seen(op_, x, w, b, *a, **kw):
        shapes.add((x.shape[0], x.shape[1], w.shape[1],
                    kw.get("act", a[0] if a else "none")))
        return launch(op_, x, w, b, *a, **kw)
    op._launch = seen
    try:
        yield shapes
    finally:
        op._launch = launch


def hold_k1_shapes(torch, shapes) -> list:
    """K1 against its plain twin at each (M, K, N, act) of ``shapes`` (the
    shapes a path gave it), on seeded inputs: a bias and x of unit scale, w
    scaled by 1 / sqrt(K); held to 1e-2 of the largest output (one bf16 ulp
    is 0.4-0.8 % of it), a fp32 partial to 1e-3, as the kernel checks
    hold K1's fixed cases."""
    from acai_omr_tpu_torch.ops.linear_kernel import gemm_plan, linear_bias_act
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for m, k, n, act in sorted(shapes):
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device="cuda") / math.sqrt(k)
             ).to(torch.bfloat16)
        b = (None if act == "partial" else
             torch.randn(n, generator=g, device="cuda") * 0.1)
        want = linear_bias_act.plain(x, w, b, act).float()
        err = (linear_bias_act(x, w, b, act).float() - want).abs().max().item()
        tol = (1e-3 if act == "partial" else 1e-2) * max(
            1.0, want.abs().max().item())
        rows.append({"shape": [m, k, n, act], "plan": gemm_plan(m, n, k)[0],
                     "max_abs_err": err, "ok": err <= tol})
    return rows


def eval_cli_path(torch, np, tmp_dir) -> dict:
    """The path ``eval_cli``: the evaluation CLI on an EVAL_SPLIT-example
    GrandStaff + OLiMPiC test layout (``eval_layout``; the root constants of
    ``eval_model`` pointed at it). The flagship (seed 0, fp32 weights)
    written by ``save_pytree`` and read by ``eval_vitomr``, then the same
    weights written as a reference ``.pth`` (``vitomr_state_dict_from_params``
    at fine-tune depth 4, ``torch.save``), read by
    ``verify_reference_losses.load_params`` and evaluated by its
    ``_eval_with_params``: the two losses bit-equal. Then set_up_mae()'s MAE
    (seed 0) through ``save_pytree`` and ``eval_mae``. The counts are read
    for the two eval forwards (the loss evaluations). Afterwards, uncounted:
    both evaluations again on the same files with the stacks' plain twins
    (``transformer.plain_twins``; the MAE's masks are the same draws), each
    loss within CMP_LOSS_REL of the kernel path's, and K1 held against its
    twin at every (M, K, N) the two kernel-path evaluations gave it
    (``hold_k1_shapes``: the small buckets' rows take the skinny kernel)."""
    from acai_omr_tpu_torch import eval_model
    from acai_omr_tpu_torch.models import mae as mae_lib
    from acai_omr_tpu_torch.models import torch_compat, vitomr
    from acai_omr_tpu_torch.ops import _build, transformer
    from acai_omr_tpu_torch.tools import verify_reference_losses as vrl
    from acai_omr_tpu_torch.train.omr_teacher_force_train import set_up_vitomr
    from acai_omr_tpu_torch.train.pre_train import set_up_mae
    from acai_omr_tpu_torch.utils import checkpoint as ckpt_lib

    root = Path(tmp_dir)
    eval_layout(np, root / "data", EVAL_SPLIT)
    for name, sub in (("GRAND_STAFF_ROOT_DIR", "grandstaff"),
                      ("OLIMPIC_SYNTHETIC_ROOT_DIR", "synthetic"),
                      ("OLIMPIC_SCANNED_ROOT_DIR", "scanned")):
        setattr(eval_model, name, str(root / "data" / sub))
    dev = torch.device("cuda")
    cfg = set_up_vitomr()
    params = vitomr.init_vitomr_params(cfg, seed=SEED, device=dev)
    t0 = time.perf_counter()
    npz = ckpt_lib.save_pytree(root / "vitomr", params)
    pth = root / "vitomr.pth"
    torch.save({"vitomr_state_dict":
                torch_compat.vitomr_state_dict_from_params(params, 4)}, pth)
    del params
    write_s = time.perf_counter() - t0
    kw = dict(batch_size=EVAL_BATCH, num_workers=8)
    shapes = set()
    _build.reset_launch_counts()
    t1 = time.perf_counter()
    with k1_shapes(shapes):
        loss_npz = eval_model.eval_vitomr(str(npz), device=dev, **kw)
    vit_counts = path_counts(torch)
    vit_s = time.perf_counter() - t1
    from_pth = vrl.load_params("vitomr", str(pth), None, device=dev)
    loss_pth = vrl._eval_with_params(eval_model, "vitomr", from_pth,
                                     EVAL_BATCH, num_workers=8, device=dev)
    del from_pth
    torch.cuda.empty_cache()
    mae_npz = ckpt_lib.save_pytree(
        root / "mae", mae_lib.init_mae_params(set_up_mae(), seed=SEED,
                                              device=dev))
    _build.reset_launch_counts()
    t2 = time.perf_counter()
    with k1_shapes(shapes):
        loss_mae = eval_model.eval_mae(str(mae_npz), device=dev, **kw)
    mae_counts = path_counts(torch)
    mae_s = time.perf_counter() - t2
    with transformer.plain_twins():
        plain_vit = eval_model.eval_vitomr(str(npz), device=dev, **kw)
        plain_mae = eval_model.eval_mae(str(mae_npz), device=dev, **kw)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
    k1 = hold_k1_shapes(torch, shapes)
    return {"examples": 3 * EVAL_SPLIT, "write_s": write_s,
            "vitomr_loss_npz": loss_npz, "vitomr_loss_pth": loss_pth,
            "pth_equals_npz": loss_pth == loss_npz, "mae_loss": loss_mae,
            "vitomr_loss_plain": plain_vit, "mae_loss_plain": plain_mae,
            "vitomr_loss_rel_err": rel(loss_npz, plain_vit),
            "mae_loss_rel_err": rel(loss_mae, plain_mae),
            "k1_shapes": k1, "vitomr_eval_s": vit_s, "mae_eval_s": mae_s,
            "mae_variants": mae_counts["variants"], **vit_counts,
            "mae_launches": mae_counts["launches"]}


def grpo_examples(np, model, n: int, seed: int) -> list:
    """Stage-3 examples (image (C, H, W), token ids, MusicXML): seeded
    synthetic score images of realistic sizes through the model's transform;
    targets cycling over the LMX files of tests/data, delinearised by the
    port (files that do not delinearise are skipped)."""
    from acai_omr_tpu_torch.lmx.delinearizer import (DelinearizationError,
                                                     delinearize)
    data = ROOT / "tests" / "data"
    targets = []
    for f in sorted(data.glob("sample_lmx_*.txt")) \
            + sorted((data / "lmx_corpus").glob("*.txt")):
        lmx = " ".join(f.read_text().split())
        try:
            targets.append((model.tokenizer.encode(lmx), delinearize(lmx)[0]))
        except (DelinearizationError, KeyError):
            continue
    return [(model._load_image(img), *targets[i % len(targets)])
            for i, img in enumerate(synthetic_images(np, n, seed))]


def grpo_path(torch, np, model, tmp_dir):
    """The path ``train_grpo``: ``grpo_train`` at the flagship's width on
    the stage-2 model's hand-off (``set_up_grpo``), GRPO_EXAMPLES examples in
    batches of GRPO_BATCH (two outer steps: rollouts of 8 per image on the
    monolith step with grouped memory, rewards, two update epochs), then one
    mini-validation on GRPO_VAL examples. The launch counts are set to 0 just
    before and read just after; the hook reads them in between."""
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import omr_grpo_train as grpo

    cfg, params = grpo.set_up_grpo(model.cfg, model.params)
    per_step = 2 * cfg.decoder.num_layers  # K2 launches of one decode step
    gcfg = grpo.default_grpo_config()
    gcfg.mini_validation_freq = GRPO_EXAMPLES // GRPO_BATCH
    train = grpo_examples(np, model, GRPO_EXAMPLES, SEED + 5)
    val = grpo_examples(np, model, GRPO_VAL, SEED + 6)
    counts = lambda: {n: op.launches for n, op in _build.REGISTRY.items()}
    log = {"step": [], "val": []}
    last = {}

    def hook(kind, info):
        torch.cuda.synchronize()
        now, c = time.perf_counter(), counts()
        entry = {"ms": 1e3 * (now - last["t"]),
                 "launches": {k: c[k] - last["counts"][k] for k in c
                              if c[k] != last["counts"][k]}}
        m = info["metrics"]
        entry["decode_steps"] = entry["launches"].get("decode_attention",
                                                      0) // per_step
        if kind == "step":
            entry.update({k: m[k] for k in ("loss", "ce_loss", "reward",
                                             "rollout_tokens",
                                             "update_width", "phase_times")})
        else:
            entry.update(reward=m["reward"], ce_loss=m["ce_loss"])
        log[kind].append(entry)
        last.update(t=time.perf_counter(), counts=c)

    before = {p: v.clone() for p, v in trainer.tree_flatten(params).items()}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    last.update(t=time.perf_counter(), counts=counts())
    t0 = time.perf_counter()
    out, stats = grpo.grpo_train(
        cfg, params, train, model.tokenizer, grpo_config=gcfg,
        batch_size=GRPO_BATCH, model_dir=Path(tmp_dir) / "grpo", seed=SEED,
        compute_dtype=model.compute_dtype, reward_workers=8, val_dataset=val,
        mini_validation_size=GRPO_VAL, device="cuda", step_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = trainer.tree_flatten(out)
    moved = lambda p: not torch.equal(after[p], before[p].float())
    files = sorted(str(f.relative_to(tmp_dir))
                   for f in Path(tmp_dir).rglob("*") if f.is_file())
    return {"wall_s": wall, "steps": log["step"], "val": log["val"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "frozen_moved": [p for p in after
                             if not p.startswith("decoder/") and moved(p)],
            "decoder_unmoved": [p for p in after
                                if p.startswith("decoder/") and not moved(p)],
            "files": files, "launches": counts(),
            "device_launches": {n: op.device_launches
                                for n, op in _build.REGISTRY.items()},
            "variants": {n: dict(op.variants)
                         for n, op in _build.REGISTRY.items()}}


def mae_set(n: int, seed: int):
    """Seeded synthetic MAE pairs: noise images of 256-512 patches."""
    from acai_omr_tpu_torch.data.datasets import DebugDataset
    return DebugDataset(n=n, sizes=MAE_SIZES, kind="mae", seed=seed)


def expected_mae_launches(cfg) -> tuple[dict, dict, dict]:
    """Launches of one MAE update and of one validation batch by the layer
    arithmetic, and the update's launches by variant. Both stacks are
    encoder-type: per layer 4 K1, 1 K3, 2 K4 forward and 1 K3, 1 K4, 1 K7,
    2 K8, 4 dgrad, 4 wgrad backward (the gradient flows on into the patch
    projection and the PE grids, so the first layer's dgrad runs too). The
    encoder's heads are 64 wide, the decoder's 32, every K3 and K7 on its
    Hopper kernels ("sm90_dh{Dh}"); every K1 and every dgrad runs on the Hopper
    core ("sm90"), every wgrad too, its rows split as
    ``row_split_plan`` says for the layer's shape (the encoder over the
    batch's kept rows, the decoder over all of them), every K4 on the vector
    kernel as ``add_layernorm_plan`` says for those rows, every K8 on its
    one-pass kernel."""
    from acai_omr_tpu_torch.ops.layernorm_kernel import add_layernorm_plan
    from acai_omr_tpu_torch.ops.linear_bwd_kernel import row_split_plan
    le, ld = cfg.encoder.num_layers, cfg.decoder_num_layers
    n = le + ld
    step = {"linear_bias_act": 4 * n, "encoder_attention": 2 * n,
            "add_layernorm": 3 * n, "attention_bwd": n,
            "layernorm_bwd": 2 * n, "linear_dgrad": 4 * n,
            "linear_wgrad": 4 * n}
    val = {"linear_bias_act": 4 * n, "encoder_attention": n,
           "add_layernorm": 2 * n}
    dh_e = cfg.encoder.hidden_dim // cfg.encoder.num_heads
    dh_d = cfg.decoder_hidden_dim // cfg.decoder_num_heads
    wgrad, k4 = {}, {}
    for rows, e, f, layers in ((MAE_BATCH * MAE_KEPT, cfg.encoder.hidden_dim,
                                cfg.encoder.mlp_dim, le),
                               (MAE_BATCH * MAE_ROWS, cfg.decoder_hidden_dim,
                                cfg.decoder_mlp_dim, ld)):
        key = add_layernorm_plan(rows, e)
        k4[key] = k4.get(key, 0) + 3 * layers
        for k, cols in ((e, 3 * e), (e, e), (e, f), (f, e)):
            key = f"sm90_splits{row_split_plan(rows, k, cols)[1]}"
            wgrad[key] = wgrad.get(key, 0) + layers
    variants = {"linear_bias_act": {"sm90": 4 * n},
                "encoder_attention": {f"sm90_dh{dh_e}": 2 * le,
                                      f"sm90_dh{dh_d}": 2 * ld},
                "attention_bwd": {f"sm90_dh{dh_e}": le, f"sm90_dh{dh_d}": ld},
                "linear_dgrad": {"sm90": 4 * n}, "linear_wgrad": wgrad,
                "add_layernorm": k4, "layernorm_bwd": {"one_pass": 2 * n}}
    return step, val, variants


def pretrain_path(torch, tmp_dir):
    """The path ``pretrain_mae``: ``pre_train`` at the full width of
    ``set_up_mae()`` for MAE_UPDATES updates of MAE_BATCH images and one
    validation batch, then the hand-off: ``pretrained_mae.npz`` loads as an
    MAE tree and stage 2's set-up holds exactly its encoder. The launch
    counts are set to 0 just before ``pre_train`` and read just after."""
    from acai_omr_tpu_torch.models import mae as mae_lib
    from acai_omr_tpu_torch.models.weights import load_mae_npz
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train
    from acai_omr_tpu_torch.train import pre_train as pt

    cfg = pt.set_up_mae()
    start = mae_lib.init_mae_params(cfg, seed=SEED, device="cuda")
    train_ds = mae_set(MAE_BATCH * MAE_UPDATES, SEED)
    val_ds = mae_set(MAE_BATCH, SEED + 1)
    counts = lambda: {n: op.launches for n, op in _build.REGISTRY.items()}
    log = {"step_ms": [], "val_ms": [], "step_launches": [],
           "val_launches": [], "step_variants": [], "grad_norms": []}
    last = {}

    def hook(kind, info):
        torch.cuda.synchronize()
        now, c = time.perf_counter(), counts()
        delta = {k: c[k] - last["counts"][k] for k in c
                 if c[k] != last["counts"][k]}
        log[f"{kind}_ms"].append(1e3 * (now - last["t"]))
        log[f"{kind}_launches"].append(delta)
        if kind == "step":
            log["grad_norms"].append(float(info["metrics"]["grad_norm"]))
            log["step_variants"].append(
                {n: dict(op.variants) for n, op in _build.REGISTRY.items()
                 if op.variants})
        last.update(t=time.perf_counter(), counts=c)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    last.update(t=time.perf_counter(), counts=counts())
    t0 = time.perf_counter()
    params, stats = pt.pre_train(
        cfg, train_ds, val_ds, params=start, epochs=1, batch_size=MAE_BATCH,
        warmup_epochs=1, checkpoint_freq=1, model_dir=Path(tmp_dir) / "mae",
        num_workers=4, bucket_boundaries=[max(MAE_SIZES)], seed=SEED,
        device="cuda", step_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    device = {n: op.device_launches for n, op in _build.REGISTRY.items()}
    variants = {n: dict(op.variants) for n, op in _build.REGISTRY.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    before, after = trainer.tree_flatten(start), trainer.tree_flatten(params)
    unmoved = [p for p in after if torch.equal(after[p], before[p])]
    files = sorted(str(f.relative_to(tmp_dir))
                   for f in Path(tmp_dir).rglob("*") if f.is_file())

    # the hand-off to stage 2
    npz = Path(tmp_dir) / "mae" / "pretrained_mae.npz"
    loaded = trainer.tree_flatten(load_mae_npz(npz, device="cuda"))
    npz_equal = loaded.keys() == after.keys() and all(
        torch.equal(loaded[p], after[p]) for p in after)
    _, stage2, _, _ = tf_train.set_up_omr_teacher_force_train(
        str(npz), device="cuda", seed=SEED)
    enc2 = trainer.tree_flatten(stage2["encoder"])
    enc1 = trainer.tree_flatten(params["encoder"])
    handoff = enc2.keys() == enc1.keys() and all(
        torch.equal(enc2[p], enc1[p]) for p in enc1)
    return {"cfg": cfg, "params": params,
            "train_losses": stats["train_losses"],
            "val_losses": stats["val_losses"], "wall_s": wall,
            "step_ms": log["step_ms"], "val_ms": log["val_ms"],
            "grad_norms": log["grad_norms"],
            "launches_per_step": log["step_launches"],
            "launches_per_val_batch": log["val_launches"],
            "variants_after_each_step": log["step_variants"],
            "unmoved": unmoved, "files": files, "npz_equal": npz_equal,
            "stage2_holds_encoder": handoff, "peak_memory_gb": peak_gb,
            "launches": launches, "device_launches": device,
            "variants": variants}


def compare_pretrain(torch, cfg, params, profile=False):
    """One MAE batch of MAE_BATCH images twice through the hand-written path
    (equal bits demanded; forward, backward and the optimizer update timed
    apart, a validation forward too). Then, at MAE_CMP_BATCH images so that
    the plain path's fp32 autograd saves fit with room, loss and every
    leaf's gradient against autograd through the plain twins. Every run
    draws its mask from a generator seeded alike."""
    from acai_omr_tpu_torch.data.loader import pack_mae_batch, to_device
    from acai_omr_tpu_torch.ops import transformer
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import pre_train as pt

    dev = torch.device("cuda")
    ds = mae_set(MAE_BATCH, SEED + 2)
    loss_fn = pt.make_loss_fn(cfg, torch.bfloat16)
    grad_fn = trainer.make_grad_fn(loss_fn)
    eval_fn = pt.make_eval_fn(cfg, torch.bfloat16)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    batch_of = lambda n: to_device(
        pack_mae_batch([ds[i] for i in range(n)], cfg.encoder), dev)

    full = batch_of(MAE_BATCH)
    runs = []
    for _ in range(2):
        loss, grads = grad_fn(params, full, gen())
        torch.cuda.synchronize()
        runs.append((loss, trainer.tree_flatten(grads)))
    equal_bits = bool(torch.equal(runs[0][0], runs[1][0])) and all(
        torch.equal(runs[0][1][p], runs[1][1][p]) for p in runs[0][1])
    grads = trainer.tree_unflatten(runs[1][1])
    del runs

    def clock(fn):  # host clock around synchronised work
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    leaves = {p: v.detach().requires_grad_(True)
              for p, v in trainer.tree_flatten(params).items()}
    (loss, _), fwd_ms = clock(
        lambda: loss_fn(trainer.tree_unflatten(leaves), full, gen()))
    _, bwd_ms = clock(lambda: torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True))
    tx = trainer.adamw(1e-4, betas=pt.ADAMW_BETAS,
                       weight_decay=pt.ADAMW_WEIGHT_DECAY)
    state = trainer.create_train_state(params, tx)
    apply_fn = trainer.make_apply_fn(tx)
    apply_fn(state, grads)
    _, opt_ms = clock(lambda: apply_fn(state, grads))
    _, val_ms = clock(lambda: eval_fn(params, full, gen()))
    del leaves, loss
    prof = None
    if profile:
        step_fn = trainer.make_train_step(loss_fn, tx)
        prof = k8_profiles(torch, lambda: step_fn(state, full, gen()))
    del state

    small = batch_of(MAE_CMP_BATCH)
    loss_k, grads_k = grad_fn(params, small, gen())
    with transformer.plain_twins():
        loss_p, grads_p = grad_fn(params, small, gen())
    return {"equal_bits_two_runs": equal_bits, "batch": MAE_BATCH,
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "optimizer_ms": opt_ms, "validation_forward_ms": val_ms,
            "compared_batch": MAE_CMP_BATCH,
            **gradient_errors(torch, loss_k, grads_k, loss_p, grads_p),
            **(prof or {})}


def gradient_errors(torch, loss_k, grads_k, loss_p, grads_p) -> dict:
    """Loss and gradient trees of the kernel path against the plain path's:
    relative L2 error of every leaf (a stacked leaf layer by layer: one
    layer's wrong gradient must not hide among the others') and of all
    leaves together."""
    from acai_omr_tpu_torch.parallel import trainer
    gk, gp = trainer.tree_flatten(grads_k), trainer.tree_flatten(grads_p)
    for tree in (gk, gp):
        for p in [p for p in tree if "blocks/" in p]:
            for layer, g in enumerate(tree.pop(p)):
                tree[f"{p}[{layer}]"] = g
    rel = {p: ((gk[p] - gp[p]).norm()
               / gp[p].norm().clamp_min(1e-12)).item() for p in gp}
    num = math.sqrt(sum(float((gk[p] - gp[p]).norm()) ** 2 for p in gp))
    den = math.sqrt(sum(float(gp[p].norm()) ** 2 for p in gp))
    worst = max(rel, key=rel.get)
    return {"loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
            "loss_rel_err": abs(loss_k.item() - loss_p.item())
            / abs(loss_p.item()),
            "grad_global_rel_err": num / den, "grad_worst_leaf": worst,
            "grad_worst_leaf_rel_err": rel[worst],
            "grad_leaf_rel_err_median": sorted(rel.values())[len(rel) // 2],
            "grads_finite": all(bool(torch.isfinite(g).all())
                                for g in gk.values()),
            "leaf_rel_err": rel}


def expected_micro_launches(cfg) -> dict:
    """Launches of one scheduled-sampling microbatch by the layer arithmetic
    (every encoder layer tuned): per encoder layer 4 K1, 1 K3, 2 K4 forward
    and 1 K3, 1 K4, 1 K7, 2 K8, 4 dgrad, 4 wgrad backward; per decoder layer
    and pass 6 K1, 2 K3, 3 K4 forward and 1 K1, 2 K3, 2 K4, 2 K7, 3 K8, 6
    dgrad, 6 wgrad backward; two decoder passes; the transition head's
    dropout once each way."""
    le, ld = cfg.encoder.num_layers, 2 * cfg.decoder.num_layers
    return {"linear_bias_act": 4 * le + 7 * ld,
            "encoder_attention": 2 * le + 4 * ld,
            "add_layernorm": 3 * le + 5 * ld,
            "attention_bwd": le + 2 * ld, "layernorm_bwd": 2 * le + 3 * ld,
            "linear_dgrad": 4 * le + 6 * ld, "linear_wgrad": 4 * le + 6 * ld,
            "dropout": 2}


def compare_training(torch, model, profile=False):
    """One flagship microbatch (B = 8) twice through the hand-written path:
    equal bits demanded, forward and backward timed apart. Then, at B = 4 so
    that the plain path's fp32 autograd saves fit the card with room, loss
    and every leaf's gradient against autograd through the plain twins."""
    from acai_omr_tpu_torch.data.loader import pack_omr_batch, to_device
    from acai_omr_tpu_torch.ops import _build, transformer
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train

    cfg, tok, dt = model.cfg, model.tokenizer, model.compute_dtype
    ds = training_set(tok, TRAIN_BATCH, SEED + 2)
    params = trainer.tree_map(lambda v: v.float(), model.params)
    loss_fn = tf_train.make_loss_fn(cfg, False, dt)
    grad_fn = trainer.make_grad_fn(loss_fn)

    def batch_of(n):
        b = pack_omr_batch([ds[i] for i in range(n)], cfg.encoder, tok,
                           max_lmx_seq_len=cfg.decoder.max_lmx_seq_len)
        b = to_device(b, model.device)
        b.update(tf_prob=0.5, tau=2.0)
        return b

    full = batch_of(TRAIN_BATCH)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        loss, grads = grad_fn(params, full, 7)
        torch.cuda.synchronize()
        runs.append((loss, trainer.tree_flatten(grads)))
    equal_bits = bool(torch.equal(runs[0][0], runs[1][0])) and all(
        torch.equal(runs[0][1][p], runs[1][1][p]) for p in runs[0][1])
    micro_launches = {n: op.launches for n, op in _build.REGISTRY.items()
                      if op.launches}

    # forward and backward apart (host clock around synchronised work)
    leaves = {p: v.detach().requires_grad_(True)
              for p, v in trainer.tree_flatten(params).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = loss_fn(trainer.tree_unflatten(leaves), full, 7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del leaves, loss, runs
    prof = k8_profiles(torch, lambda: grad_fn(params, full, 7)) \
        if profile else None

    half = batch_of(TRAIN_BATCH // 2)
    loss_k, grads_k = grad_fn(params, half, 7)
    with transformer.plain_twins():
        loss_p, grads_p = grad_fn(params, half, 7)
    return {"equal_bits_two_runs": equal_bits,
            "forward_ms": 1e3 * (t1 - t0), "backward_ms": 1e3 * (t2 - t1),
            "launches_per_microbatch": micro_launches,
            **gradient_errors(torch, loss_k, grads_k, loss_p, grads_p),
            **(prof or {})}


def k8_profile_line(what: str, c: dict) -> str:
    return (f"[profile] K8 device ms {what} "
            f"{c['k8_device_ms_per_step']:.4f} of "
            f"{c['profile']['device_ms_per_step']:.4f}; in turns with its "
            f"three-launch form "
            f"{c['k8_three_pass_device_ms_per_step']:.4f} of "
            f"{c['profile_three_pass']['device_ms_per_step']:.4f}")


def k8_profiles(torch, step) -> dict:
    """Profile windows of two training steps (microbatches or MAE updates),
    then again with K8 forced to the three-launch form it replaced, in
    turns; K8's device ms a step in each."""
    from acai_omr_tpu_torch.ops.layernorm_bwd_kernel import layernorm_bwd
    out = {}
    for form in ("", "_three_pass"):
        with forced_variant(layernorm_bwd, "three_pass" if form else None):
            prof = profile_steps(torch, step, warmup=1, steps=2)
        out["profile" + form] = prof
        out[f"k8{form}_device_ms_per_step"] = kernel_ms(prof, "ln_bwd_")
    return out


# ---------------------------------------------------------------------------
# the host tools and training over the mesh
# ---------------------------------------------------------------------------

def host_tools_path(torch, np, data_root) -> dict:
    """The path ``host_tools``: the LMX CLI's linearize -> delinearize round
    trip of tests/data's sample files, the vocabulary writer against
    ``lmx_vocab.txt``, ``calc_dataset_stats`` over the eval_cli layout's
    images at ``data_root``, the device ingest (``ops/preprocess``) on the
    card against the host pipeline (within PREPROCESS_TOL, timed against it)
    and the port's parity gate (exit 0, every check skipped: no weights,
    dataset or reference checkout in the repository)."""
    import contextlib as ctx
    import io
    import tempfile
    from acai_omr_tpu_torch.data import transforms
    from acai_omr_tpu_torch.lmx import __main__ as lmx_cli
    from acai_omr_tpu_torch.ops import patchify as patchify_lib
    from acai_omr_tpu_torch.ops import preprocess
    from acai_omr_tpu_torch.tools import parity_gate
    from acai_omr_tpu_torch.utils import (calc_dataset_stats,
                                          create_lmx_vocab_file)

    out = {"round_trip": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for f in sorted((ROOT / "tests" / "data").glob("sample_lmx_*.txt")):
            lmx = f.read_text().replace("<eos>", "").split()
            (tmp / "a.lmx").write_text(" ".join(lmx))
            with ctx.redirect_stderr(io.StringIO()) as problems:
                lmx_cli.main(["delinearize", str(tmp / "a.lmx"),
                              str(tmp / "a.musicxml")])
            lmx_cli.main(["linearize", str(tmp / "a.musicxml"),
                          str(tmp / "b.lmx")])
            out["round_trip"][f.name] = (
                (tmp / "b.lmx").read_text().split() == lmx
                and not problems.getvalue())
        with ctx.redirect_stdout(io.StringIO()):
            create_lmx_vocab_file.main(str(tmp / "vocab.txt"))
        out["vocab_equal"] = ((tmp / "vocab.txt").read_bytes()
                              == (ROOT / "lmx_vocab.txt").read_bytes())
    stats = calc_dataset_stats.collect_stats([data_root], 16)
    out["stats_images"] = int(len(stats["widths"]))
    out["stats_summary"] = calc_dataset_stats.summarize(stats)
    out["suggested_buckets"] = calc_dataset_stats.suggest_buckets(stats)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 11)
    errs, dev_ms, host_ms = [], [], []
    for shape, target in (((1, 100, 150), (48, 80)),
                          ((1, 333, 517), None), ((1, 900, 1500), None)):
        img = rng.random(shape, dtype=np.float32)
        if target is None:
            run = lambda: preprocess.dynamic_resize_patchify(
                img, 16, 1024, 60, 200, device=dev)[0]
            host = lambda: patchify_lib.patchify(transforms.DynamicResize(
                16, 1024, 60, 200, crop_imgs=False)(img), 16)
        else:
            run = lambda: preprocess.resize_normalize_patchify(
                img, *target, 16, device=dev)
            host = lambda: patchify_lib.patchify(np.clip(
                transforms._resize_chw(img, target), 0.0, 1.0), 16)
        got = run().cpu().numpy()
        want = host()
        errs.append(float(np.abs(got - want).max()) if got.shape
                    == want.shape else float("inf"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        dev_ms.append(1e3 * (time.perf_counter() - t0) / 5)
        t0 = time.perf_counter()
        for _ in range(5):
            host()
        host_ms.append(1e3 * (time.perf_counter() - t0) / 5)
    out.update(preprocess_max_abs_err=max(errs),
               preprocess_card_ms=dev_ms, preprocess_host_ms=host_ms)

    buf = io.StringIO()
    with ctx.redirect_stdout(buf):
        rc = parity_gate.main(["--fast"])
    gate = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["parity_gate_rc"] = rc
    out["parity_gate"] = {k: v if k == "ok" else v["status"]
                          for k, v in gate.items()}
    out["ok"] = (all(out["round_trip"].values()) and len(out["round_trip"])
                 and out["vocab_equal"] and out["stats_images"] > 0
                 and out["preprocess_max_abs_err"] <= PREPROCESS_TOL
                 and rc == 0 and gate["ok"] is None
                 and list(gate) == ["mae_mse", "vitomr_ce", "decode",
                                    "code_level_identity", "ok"]
                 and all(gate[k]["status"].startswith("skipped: ")
                         for k in list(gate)[:-1]))
    return out


def k15_launches_of(torch, fn):
    """Runs ``fn()`` and returns (its result, the K15 launches it made by
    variant)."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import tp_allreduce
    before = dict(tp_allreduce.variants)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before.get(k, 0)
                 for k, v in tp_allreduce.variants.items()
                 if v != before.get(k, 0)}


def device_ms(torch, fn) -> float:
    """Device ms of one call of ``fn`` (torch.profiler: the kernels' time,
    the host's gaps left out)."""
    return profile_steps(torch, fn, 0, 1)["device_ms_per_step"]


def _no_dropout(cfg):
    import dataclasses
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0),
        transition_head_dropout=0.0)


def train_dp_path(torch, model) -> dict:
    """The path ``train_dp``: data-parallel training over a (2, 1) mesh with
    both shards on this card. Stage 2 (the flagship, batch TRAIN_BATCH, 4
    rows a shard): one ``make_sharded_grad_fn`` call against ``make_grad_fn``
    on the same rows with dropout 0 and tf_prob 1 (loss and every leaf
    within the limits of the single-card comparison), then DP_UPDATES
    updates through ``make_sharded_train_step`` with the flagship's dropout
    and tf_prob 0.5. Stage 1 (``set_up_mae()``, batch MAE_BATCH): the same
    comparison on one shared mask noise, then one update. Every gradient
    step must be exactly one K15 ``"local"`` launch. The device ms of the
    DP step, of the one-card step on all rows and of one shard's rows."""
    import dataclasses
    from acai_omr_tpu_torch.data.loader import (pack_mae_batch,
                                                pack_omr_batch, to_device)
    from acai_omr_tpu_torch.models import mae as mae_lib
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import omr_teacher_force_train as tf_train
    from acai_omr_tpu_torch.train import pre_train as pt

    dev = torch.device("cuda")
    mesh = mesh_lib.make_mesh(2, 1, [dev] * 2)
    cfg, tok, dt = model.cfg, model.tokenizer, model.compute_dtype
    cfg0 = _no_dropout(cfg)
    params = trainer.tree_map(lambda v: v.float(), model.params)
    ds = training_set(tok, TRAIN_BATCH, SEED + 8)

    def batch_of(rows, tf_prob, tau):
        b = to_device(pack_omr_batch(
            [ds[i] for i in rows], cfg.encoder, tok,
            max_lmx_seq_len=cfg.decoder.max_lmx_seq_len), dev)
        b.update(tf_prob=tf_prob, tau=tau)
        return b

    out, k15 = {}, []
    full = batch_of(range(TRAIN_BATCH), 1.0, 1.0)
    dp_fn = trainer.make_sharded_grad_fn(
        tf_train.make_sum_loss_fn(cfg0, False, dt), mesh)
    tx = trainer.adamw(1e-5, betas=tf_train.ADAMW_BETAS,
                       weight_decay=tf_train.ADAMW_WEIGHT_DECAY)
    step = trainer.make_sharded_train_step(
        tf_train.make_sum_loss_fn(cfg, False, dt), tx, mesh)
    mcfg = pt.set_up_mae()
    mparams = mae_lib.init_mae_params(mcfg, seed=SEED, device=dev)
    mds = mae_set(MAE_BATCH, SEED + 9)
    mb = to_device(pack_mae_batch([mds[i] for i in range(MAE_BATCH)],
                                  mcfg.encoder), dev)
    # one mask noise for the sharded and the one-card gradients: the noise
    # rides in the batch, so each shard takes its rows' noise
    mb_noise = {**mb, "noise": torch.rand(
        mb["valid"].shape, device=dev,
        generator=torch.Generator(device=dev).manual_seed(3))}

    def mae_sum(p, b, gen):
        return mae_lib.mae_loss(*mae_lib.forward(
            p, mcfg, b["patches"], b["pe_idx"], b["pe_w"], b["valid"],
            b["lengths"], b["target_patches"], mask_noise=b["noise"],
            compute_dtype=dt), reduction="sum")

    def mae_mean(p, b, gen):
        s, c = mae_sum(p, b, gen)
        return s / c.clamp_min(1.0), {}

    mdp = trainer.make_sharded_grad_fn(mae_sum, mesh)
    mtx = trainer.adamw(1e-4, betas=pt.ADAMW_BETAS,
                        weight_decay=pt.ADAMW_WEIGHT_DECAY)
    mstep = trainer.make_sharded_train_step(pt.make_sum_loss_fn(mcfg, dt),
                                            mtx, mesh)

    # the path: every count from here to path_counts is the DP runs'
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    (loss_dp, grads_dp), n = k15_launches_of(
        torch, lambda: dp_fn(params, full, 7))
    k15.append(n)
    state = trainer.create_train_state(params, tx)
    losses = []
    for i in range(DP_UPDATES):
        (state, m), n = k15_launches_of(torch, lambda: step(
            state, batch_of(range(TRAIN_BATCH), 0.5, 2.0), 100 + i))
        k15.append(n)
        losses.append(float(m["loss"]))
    (mloss_dp, mgrads_dp), n = k15_launches_of(
        torch, lambda: mdp(mparams, mb_noise, None))
    k15.append(n)
    mstate = trainer.create_train_state(mparams, mtx)
    (mstate, mm), n = k15_launches_of(torch, lambda: mstep(
        mstate, mb, torch.Generator(device=dev).manual_seed(5)))
    k15.append(n)
    counts = path_counts(torch)
    wall = time.perf_counter() - t0

    flat0 = trainer.tree_flatten(params)
    after = trainer.tree_flatten(state.params)
    out.update(stage2_losses=losses, stage2_leaves=len(flat0),
               stage2_moved=sum(not torch.equal(after[p], flat0[p])
                                for p in flat0))
    del state, after
    mflat0 = trainer.tree_flatten(mparams)
    out.update(stage1_loss=float(mm["loss"]), stage1_leaves=len(mflat0),
               stage1_moved=sum(not torch.equal(v, mflat0[p]) for p, v in
                                trainer.tree_flatten(mstate.params).items()))
    del mstate
    one_fn = trainer.make_grad_fn(tf_train.make_loss_fn(cfg0, False, dt))
    loss_one, grads_one = one_fn(params, full, 7)
    out["stage2"] = gradient_errors(torch, loss_dp, grads_dp, loss_one,
                                    grads_one)
    del grads_dp, grads_one
    mloss_one, mgrads_one = trainer.make_grad_fn(mae_mean)(mparams, mb_noise,
                                                           None)
    out["stage1"] = gradient_errors(torch, mloss_dp, mgrads_dp, mloss_one,
                                    mgrads_one)
    del mgrads_dp, mgrads_one, mparams
    half = batch_of(range(TRAIN_BATCH // 2), 1.0, 1.0)
    out["stage2_device_ms"] = {
        "dp_step": device_ms(torch, lambda: dp_fn(params, full, 7)),
        "one_card": device_ms(torch, lambda: one_fn(params, full, 7)),
        "one_shard_rows": device_ms(torch, lambda: one_fn(params, half, 7))}
    out.update(wall_s=wall, k15_per_step=k15,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               flat_elements=sum(v.numel() for v in flat0.values()))
    del params, flat0
    torch.cuda.empty_cache()
    return {**out, **counts}


def train_pp_path(torch, model) -> dict:
    """The path ``train_pp``: the flagship decoder (12 layers) pipelined
    over PP_STAGES stages x 2 data shards, every shard on this card,
    PP_MICRO microbatches a data shard, batch TRAIN_BATCH, T = PP_T, memory
    PP_M. One ``make_pp_grad_fn`` call (one K15 launch) against autograd of
    the unpipelined decoder forward on the same batch (the limits of the
    single-card comparison), then PP_UPDATES ``make_pp_train_step`` updates
    (finite losses, every leaf moved). The schedule's bubble share and the
    device ms of the pipelined and unpipelined gradients."""
    from acai_omr_tpu_torch.models import omr_decoder, vitomr
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    from acai_omr_tpu_torch.parallel import pipeline, trainer

    dev = torch.device("cuda")
    dcfg, dt = model.cfg.decoder, model.compute_dtype
    params = trainer.tree_map(lambda v: v.float(), model.params["decoder"])
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    b = TRAIN_BATCH
    lens = torch.randint(PP_T // 2, PP_T + 1, (b,), generator=g, device=dev)
    mlens = torch.randint(PP_M // 2, PP_M + 1, (b,), generator=g, device=dev)
    seqs_in = torch.randint(3, dcfg.vocab_size, (b, PP_T), generator=g,
                            device=dev)
    lmx_valid = torch.arange(PP_T, device=dev)[None] < lens[:, None]
    seqs_tgt = torch.where(lmx_valid, torch.randint(
        3, dcfg.vocab_size, (b, PP_T), generator=g, device=dev), dcfg.pad_idx)
    latent = torch.randn(b, PP_M, dcfg.hidden_dim, generator=g, device=dev)
    latent_valid = torch.arange(PP_M, device=dev)[None] < mlens[:, None]
    batch = (seqs_in, seqs_tgt, lmx_valid, latent, latent_valid)
    mesh = mesh_lib.make_mesh(2, PP_STAGES, [dev] * (2 * PP_STAGES))
    pp = pipeline.stage_params(params, dcfg, mesh, "model")
    kw = dict(stage_axis="model", data_axis="data", n_micro=PP_MICRO,
              compute_dtype=dt)
    grad_fn = pipeline.make_pp_grad_fn(dcfg, mesh, **kw)

    def one_card():
        flat = trainer.tree_flatten(params)
        leaves = {p: v.detach().requires_grad_(True) for p, v in flat.items()}
        logits = omr_decoder.forward(trainer.tree_unflatten(leaves), dcfg,
                                     seqs_in, latent, lmx_valid, latent_valid,
                                     compute_dtype=dt)
        s, n = vitomr.omr_ce_loss(logits, seqs_tgt, dcfg.pad_idx,
                                  reduction="sum")
        loss = s / n.clamp_min(1.0)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), trainer.tree_unflatten(dict(zip(leaves, grads)))

    tx = trainer.adamw(1e-4, weight_decay=0.0)
    step = pipeline.make_pp_train_step(dcfg, tx, mesh, **kw)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    (loss_pp, grads_pp), n = k15_launches_of(torch,
                                             lambda: grad_fn(pp, batch))
    k15 = [n]
    state = trainer.create_train_state(pp, tx)
    losses = []
    for _ in range(PP_UPDATES):
        (state, m), n = k15_launches_of(torch, lambda: step(state, batch))
        k15.append(n)
        losses.append(float(m["loss"]))
    counts = path_counts(torch)
    wall = time.perf_counter() - t0
    before = trainer.tree_flatten(pp)
    after = trainer.tree_flatten(state.params)
    unmoved = [p for p in before if torch.equal(after[p], before[p])]
    del state, after
    loss_one, grads_one = one_card()
    out = {"cmp": gradient_errors(
        torch, loss_pp, pipeline.unstage_params(grads_pp), loss_one,
        grads_one)}
    del grads_pp, grads_one
    out["device_ms"] = {"pipelined": device_ms(torch,
                                               lambda: grad_fn(pp, batch)),
                        "unpipelined": device_ms(torch, one_card)}
    ticks = PP_MICRO + PP_STAGES - 1
    out.update(losses=losses, k15_per_step=k15, unmoved=unmoved,
               leaves=len(before),
               ticks=ticks, bubble_share=1 - PP_MICRO / ticks, wall_s=wall,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del pp, params, before
    torch.cuda.empty_cache()
    return {**out, **counts}


def grpo_dp_path(torch, np, model) -> dict:
    """The path ``grpo_dp``: one outer GRPO step of ``train_grpo``'s
    configuration (GRPO_BATCH images, 8 rollouts each, one update epoch of
    16 chunks) through ``grpo_update(mesh=)`` on a (2, 1) mesh on this
    card: ``forward_rollout_policy(mesh=)`` decodes the rollouts on 2 data
    shards in lock step, then ``make_grpo_update_step(mesh=)`` updates (one
    K15 launch). Then, on the batch that update took, the sharded gradients
    against the mesh-less step's (the limits of the single-card
    comparison)."""
    from acai_omr_tpu_torch.ops import _build
    from acai_omr_tpu_torch.parallel import mesh as mesh_lib
    from acai_omr_tpu_torch.parallel import trainer
    from acai_omr_tpu_torch.train import omr_grpo_train as grpo

    dev = torch.device("cuda")
    cfg, params = grpo.set_up_grpo(model.cfg, model.params)
    gcfg = grpo.default_grpo_config()
    gcfg.update_config.update_epochs = 1
    uc = gcfg.update_config
    mesh = mesh_lib.make_mesh(2, 1, [dev] * 2)
    tx = trainer.adamw(grpo.LR, betas=grpo.ADAMW_BETAS,
                       weight_decay=grpo.ADAMW_WEIGHT_DECAY,
                       max_grad_norm=uc.max_grad_norm,
                       scale_tree_fn=grpo.grpo_frozen_scales)
    state = trainer.create_train_state(params, tx)
    dt = model.compute_dtype
    dp_step = grpo.make_grpo_update_step(cfg, tx, GRPO_BATCH, uc.epsilon, dt,
                                         mesh=mesh)
    seen, k15 = [], []

    def step(st, batch):
        seen.append(batch)
        out, n = k15_launches_of(torch, lambda: dp_step(st, batch))
        k15.append(n)
        return out

    examples = grpo_examples(np, model, GRPO_BATCH, SEED + 5)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, m = grpo.grpo_update(
        state.params, state, step, cfg, gcfg, examples, model.tokenizer,
        torch.Generator(device=dev).manual_seed(SEED), None, 0, dt, 8,
        mesh=mesh, device=dev)
    wall = time.perf_counter() - t0
    counts = path_counts(torch)
    batch = seen[0]
    grads_dp, sums_dp = grpo.make_sharded_grpo_grads_fn(
        cfg, GRPO_BATCH, uc.epsilon, mesh, compute_dtype=dt)(state.params,
                                                             batch)
    grads_one, sums_one = grpo.make_grpo_grads_fn(
        cfg, GRPO_BATCH, uc.epsilon, dt)(state.params, batch)
    loss = lambda s: -(s["grpo_objective"] + batch["entropy_beta"]
                       * s["entropy_bonus"] - batch["lambda_ce"]
                       * s["ce_loss"])
    cmp = gradient_errors(torch, loss(sums_dp),
                          {"decoder": grads_dp["decoder"]}, loss(sums_one),
                          {"decoder": grads_one["decoder"]})
    del grads_dp, grads_one, state
    torch.cuda.empty_cache()
    return {"cmp": cmp, "wall_s": wall, "k15_per_step": k15,
            "loss": m["loss"], "reward": m["reward"],
            "rollout_tokens": m["rollout_tokens"],
            "phase_times": m["phase_times"],
            "rollout_rows": int(batch["rollouts"].shape[0]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            **counts}


def k15_flat_case(torch, n: int, d: int) -> dict:
    """K15 ``"local"`` at the data-parallel step's shape and in its form: d
    flat fp32 buffers of n elements as ``(1, n)`` rows summed into the first
    in place (``root_only``, rank 0's output alone written), bit-equal to
    the twin's rank 0 row; times from CUDA events around eager calls (a call
    moves GBs, so the host's launch cost is nothing beside it; the calls go
    on summing into the first buffer, which changes no time); bound: every
    buffer read once and rank 0's output written once, d - 1 adds an
    element; library call ``torch.stack(parts).sum(0)``."""
    from acai_omr_tpu_torch.ops.tp_allreduce_kernel import (TPGroup,
                                                            tp_allreduce)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d)
    group = TPGroup([dev] * d)
    parts = [torch.randn(1, n, generator=g, device=dev) for _ in range(d)]
    call = lambda: tp_allreduce(parts, group, root_only=True)
    want = tp_allreduce.plain(parts, group)[0]
    others = [p.clone() for p in parts[1:]]
    got = call()[0]
    exact = got.data_ptr() == parts[0].data_ptr() and torch.equal(got, want) \
        and all(torch.equal(a, b) for a, b in zip(parts[1:], others))
    err = (got - want).abs().max().item()
    del want, others
    t_k = time_ms_eager(torch, call, iters=5)
    t_p = time_ms_eager(torch, lambda: tp_allreduce.plain(
        parts, group, root_only=True), iters=3)
    t_lib = time_ms_eager(torch, lambda: torch.stack(parts).sum(0), iters=3)
    b_ms, b_by = bound_ms((d + 1) * n * 4, (d - 1) * n, PEAK_FP32_FLOP_PER_S)
    del parts
    torch.cuda.empty_cache()
    return {"op": tp_allreduce, "case": f"flat D={d} N={n} fp32 root_only",
            "max_abs_err": err, "tol": 0.0, "ms": t_k, "host_us": None,
            "plain_ms": t_p, "library_ms": t_lib, "bound_ms": b_ms,
            "bound_by": b_by, "ok": exact and err == 0.0,
            "paths": list(MESH_TRAIN_PATHS), "variant": "local",
            "cold_ms": None, "old_ms": None, "library_cold_ms": None,
            "extra": {}}


def mesh_run_failures(runs: dict) -> list:
    """Prints the mesh-training paths' results and returns what failed:
    the kernels each must launch and their variants, one K15 ``"local"``
    launch a gradient step, every comparison with one card within the
    limits of phase 4, finite losses and moved leaves."""
    failures = []
    finite = lambda vs: len(vs) > 0 and all(math.isfinite(v) for v in vs)
    within = lambda c: (c["grads_finite"] and c["loss_rel_err"] <= CMP_LOSS_REL
                        and c["grad_worst_leaf_rel_err"] <= CMP_LEAF_REL
                        and c["grad_global_rel_err"] <= CMP_GLOBAL_REL)
    for name, r in runs.items():
        cmps = [k for k in ("stage2", "stage1", "cmp") if k in r]
        for k in cmps:
            r[k].pop("leaf_rel_err")
        print(f"[path {name}] " + json.dumps(
            {k: v for k, v in r.items()
             if k not in ("launches", "device_launches", "variants")}),
            flush=True)
        print(f"[path {name}] launches {json.dumps(r['launches'])}",
              flush=True)
        print(variant_line(name, r), flush=True)
        failures.extend(variant_failures(name, r))
        failures.extend(k8_one_kernel_failures(name, r))
        for k in EXPECTED_KERNELS[name]:
            if r["launches"][k] <= 0:
                failures.append(f"{name}: launches[{k}]=0")
        if any(n != {"local": 1} for n in r["k15_per_step"]):
            failures.append(f"{name}: K15 launches by gradient step "
                            f"{r['k15_per_step']}, not one 'local' each")
        for k in cmps:
            if not within(r[k]):
                failures.append(f"{name}: {k} against one card outside the "
                                f"limits")
    dp_r, pp_r, gd_r = (runs[k] for k in MESH_TRAIN_PATHS)
    if not (finite(dp_r["stage2_losses"])
            and len(dp_r["stage2_losses"]) == DP_UPDATES
            and math.isfinite(dp_r["stage1_loss"])
            and dp_r["stage2_moved"] >= 0.9 * dp_r["stage2_leaves"]
            and dp_r["stage1_moved"] >= 0.9 * dp_r["stage1_leaves"]):
        failures.append("train_dp: updates: a loss not finite or leaves "
                        "unmoved")
    if not (finite(pp_r["losses"]) and len(pp_r["losses"]) == PP_UPDATES
            and len(pp_r["unmoved"]) <= 0.1 * pp_r["leaves"]):
        failures.append(f"train_pp: updates: losses {pp_r['losses']}, "
                        f"unmoved {pp_r['unmoved']}")
    if not (math.isfinite(gd_r["loss"]) and math.isfinite(gd_r["reward"])
            and len(gd_r["k15_per_step"]) == 1):
        failures.append("grpo_dp: a non-finite loss or reward, or not one "
                        "update")
    return failures


def mesh_train_alone(torch) -> int:
    """``--mesh-train``: the kernels built, then only the mesh-training
    paths, ``host_tools`` (on a freshly written eval layout) and K15 at the
    data-parallel step's flat buffer, checked as in the full run."""
    import tempfile

    import numpy as np

    from acai_omr_tpu_torch.api import OmrModel
    from acai_omr_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(verbose=False)
    model = OmrModel.load(device="cuda", seed=SEED)
    n_params = sum(v.numel() for v in _leaves(model.params))
    runs, t = {}, {}
    for name, fn in (("train_dp", lambda: train_dp_path(torch, model)),
                     ("train_pp", lambda: train_pp_path(torch, model)),
                     ("grpo_dp", lambda: grpo_dp_path(torch, np, model))):
        t0 = time.perf_counter()
        runs[name] = fn()
        t[name] = time.perf_counter() - t0
    failures = mesh_run_failures(runs)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        eval_layout(np, Path(tmp), EVAL_SPLIT)
        t0 = time.perf_counter()
        ht = host_tools_path(torch, np, Path(tmp))
        t["host_tools"] = time.perf_counter() - t0
    print(f"[path host_tools] {json.dumps(ht)}", flush=True)
    if not ht["ok"]:
        failures.append("host_tools")
    n_flat = -(-(n_params + 2) // 8) * 8
    rows = []
    for d in (2, 4):
        c = k15_flat_case(torch, n_flat, d)
        rows.append({k: v for k, v in c.items() if k not in ("op", "paths")})
        if not c["ok"]:
            failures.append(f"tp_allreduce[{c['case']}]")
    print(json.dumps({"k15_flat": rows, "seconds": t}), flush=True)
    if failures:
        print(f"[fail] {failures}", file=sys.stderr)
    return 1 if failures else 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "acai_omr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the acai_omr_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if "--k7-bits" in sys.argv[1:]:  # K7's bits alone, for K7_BITS
        print(json.dumps(k7_bits(torch)))
        return 0
    if "--skinny-splits" in sys.argv[1:]:  # the skinny kernel's splits alone
        print(card_line())
        skinny_splits(torch)
        return 0
    if "--attn-splits" in sys.argv[1:]:  # K2's and K11's splits alone
        print(card_line())
        attn_splits(torch)
        return 0
    if "--int8-splits" in sys.argv[1:]:  # K5's, K6's, K12's, K14's splits
        print(card_line())
        int8_splits(torch)
        return 0
    if "--k4-plan" in sys.argv[1:]:  # K4's warps a row alone
        print(card_line())
        k4_plan(torch)
        return 0
    if "--k27-plan" in sys.argv[1:]:  # K27's layouts against the plan's
        print(card_line())
        k27_plan(torch)
        return 0
    if "--k19" in sys.argv[1:]:  # K19's checks and turns alone
        print(card_line())
        return k19_alone(torch)
    if "--mesh-train" in sys.argv[1:]:  # the mesh-training paths alone
        print(card_line())
        return mesh_train_alone(torch)
    if "--stream-lookup" in sys.argv[1:]:  # the stream lookup's cost alone
        print(card_line())
        return 0 if stream_lookup(torch)["same_tokens"] else 1
    import numpy as np
    import torch.nn.functional as F

    from acai_omr_tpu_torch.api import OmrModel
    from acai_omr_tpu_torch.models import decode as decode_lib
    from acai_omr_tpu_torch.ops import _build

    # full-fp32 products for the plain twins' fp32 math (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"allow_tf32=False", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    phase_s, last = {"build": build_s}, [time.perf_counter()]

    def mark(phase):
        """The wall seconds since the last mark, under ``phase``."""
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now
        print(f"[time] {phase} {phase_s[phase]:.1f} s", flush=True)
    print(f"[build] {len(_build.sources())} kernel sources in {build_s:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    cases, race_bad, spills, k7_bad = check_kernels(torch, F, dev)
    mark("kernel_checks")
    # the probes phase's main path: the fourteen probe tools
    probe_run = probes_path(torch)
    mark("probes")

    # phase 3: the slice at the flagship width
    model = OmrModel.load(device="cuda", seed=SEED)
    n_params = sum(v.numel() for v in _leaves(model.params))
    print(f"[slice] flagship ViTOMR {n_params / 1e6:.1f}M params, "
          f"{model.compute_dtype}, seed {SEED}", flush=True)
    imgs = synthetic_images(np, N_IMAGES, SEED)
    print(f"[slice] images {[i.shape for i in imgs]}", flush=True)
    model.transcribe_batch(imgs[:2], max_len=8)  # warm-up: libraries, caches
    torch.cuda.synchronize()
    n_layers = model.cfg.decoder.num_layers
    failures = []
    paths = {"probes": probe_run}
    print(f"[path probes] wall_s={probe_run['wall_s']:.2f} launches "
          f"{json.dumps(probe_run['launches'])}", flush=True)
    for k in EXPECTED_KERNELS["probes"]:
        if probe_run["launches"][k] <= 0:
            failures.append(f"probes: launches[{k}]=0")
    # the redesigned probes (REDESIGNED_PROBES) on the path only in their
    # new forms: the kernels they replaced (replaced_form) run in the kernel
    # checks' turns alone
    old_forms = {n: [v for v in probe_run["variants"].get(n, {})
                     if replaced_form(v)]
                 for n in REDESIGNED_PROBES}
    print(f"[path probes] by variant " + json.dumps(
        {n: probe_run["variants"].get(n, {}) for n in old_forms}), flush=True)
    if any(old_forms.values()):
        failures.append(f"probes: the replaced forms launched {old_forms}")
    res = probe_run["results"]
    if res["mosaic_dot_forms_probe"] != 0:
        failures.append("probes: a dot form differs from the plain product")
    vm = res["vmem_probe"]
    if not (vm["assumed_holds"] and vm["refused_kb"] == vm["largest_kb"] + 1
            and vm["largest_kb"] * 1024 <= vm["optin_bytes"]
            < vm["refused_kb"] * 1024):
        failures.append(f"probes: shared memory per block {vm}")
    if not all(r["max_abs_err"] <= 1e-2 * max(1.0, r["ref_max"])
               for r in res["pallas_gemm_probe"]):
        failures.append("probes: pallas_gemm_probe's spot check")
    i4 = res["int4_probe"]
    if not (all(i4["legality"].values()) and len(i4["legality"]) == 5
            and len(i4["timing"]) == 5):
        failures.append(f"probes: int4_probe schemes {i4['legality']}")
    up = res["unpack_probe"]
    if not all(r["exact"] for r in up.values()):
        failures.append("probes: an unpack scheme is not exact")
    # a folded reps loop would take no longer for 2n reps than for n
    folded = [n for n, r in up.items()
              if r["exact"] and not r["t_2n_ms"] > 1.5 * r["t_n_ms"]]
    if folded:
        failures.append(f"probes: unpack reps folded for {folded}")
    di = res["dma_issue_probe"]
    if not di["tile_ok"] or not di["ns_per_issue"] >= 0:
        failures.append(f"probes: dma_issue_probe tile {di['tile_ok']}, "
                        f"{di['ns_per_issue']:.2f} ns per issue")
    if not res["dma_skip_probe"]["ok"]:
        failures.append("probes: dma_skip_probe sums or runs differ")
    if not res["narrow_lane_dma_probe"]["ok"]:
        failures.append("probes: narrow_lane_dma_probe sums")
    if not res["mosaic_head_access_probe"]["ok"]:
        failures.append("probes: a mosaic_head_access_probe form")
    if not res["vpu_probe"]["ok"]:
        failures.append("probes: vpu_probe against its twin")
    for m in BWD_PROBE_MODES:
        if not res[f"bwd_vmem_probe {m}"]["ok"]:
            failures.append(f"probes: bwd_vmem_probe {m}")

    def finish_path(name, n_tokens, decode_s, extra, steps=None):
        """Read the launch counts of the path just driven; check and print.
        ``steps``: the decode steps counted, else derived from the monolith
        step's attention launches (two per layer and step)."""
        torch.cuda.synchronize()
        launches = {n: op.launches for n, op in _build.REGISTRY.items()}
        device = {n: op.device_launches for n, op in _build.REGISTRY.items()}
        if steps is None:
            steps = (launches["decode_attention"]
                     + launches["decode_attention_int8"]) // (2 * n_layers)
        # an encode is 7 launches per layer: 4 K1, 1 K3, 2 K4, none split
        enc = 7 * launches["encoder_attention"]
        r = {"tokens": n_tokens, "decode_s": decode_s, "steps": steps,
             "tokens_per_s": n_tokens / decode_s if decode_s else 0.0,
             "ms_per_step": 1e3 * decode_s / max(steps, 1),
             "wrapper_calls_per_step":
                 (sum(launches.values()) - enc) / max(steps, 1),
             "device_kernels_per_step":
                 (sum(device.values()) - enc) / max(steps, 1),
             "launches": launches, "device_launches": device,
             "variants": {n: dict(op.variants)
                          for n, op in _build.REGISTRY.items()}, **extra}
        paths[name] = r
        print(f"[path {name}] tokens={n_tokens} steps={steps} "
              f"decode_s={decode_s:.3f} tokens_per_s={r['tokens_per_s']:.1f} "
              f"ms_per_step={r['ms_per_step']:.3f} wrapper_calls_per_step="
              f"{r['wrapper_calls_per_step']:.1f} device_kernels_per_step="
              f"{r['device_kernels_per_step']:.1f} {json.dumps(extra)}",
              flush=True)
        print(f"[path {name}] launches {json.dumps(launches)}", flush=True)
        print(variant_line(name, r), flush=True)
        for k in EXPECTED_KERNELS[name]:
            if launches[k] <= 0:
                failures.append(f"{name}: launches[{k}]=0")
        failures.extend(variant_failures(name, r))

    def transcribe_path(name, batch, count_steps=False, **kw):
        _build.reset_launch_counts()
        with counted_steps(decode_lib) as box:
            t0 = time.perf_counter()
            out = model.transcribe_batch(batch, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res = model.last_result
        ok = len(out) == len(batch) and all(
            isinstance(t.lmx, str) and t.lmx for t in out) and all(
            math.isfinite(lp) for lp in res.avg_log_probs)
        if not ok:
            failures.append(f"{name}: output")
        finish_path(name, res.n_tokens, res.decode_seconds, {
            "encode_s": res.encode_seconds, "wall_s": wall,
            "lmx_lengths": [len(t.lmx.split()) for t in out],
            "confidence": [round(t.confidence, 4) for t in out]},
            steps=box["n"] if count_steps else None)
        return res

    greedy = transcribe_path("greedy_bf16", imgs, max_len=MAX_LEN)
    quant = transcribe_path("int8", imgs, max_len=MAX_LEN, quantized_kv=True)
    print(f"[path int8] share of each image's tokens equal to the bf16 "
          f"decode's {token_share(quant, greedy)}", flush=True)
    bf16_weights = weight_paths(model, imgs, quant, transcribe_path, paths,
                                failures, n_layers)
    beam_imgs = imgs[:BEAM_IMAGES]
    beam = transcribe_path("beam_bf16", beam_imgs, max_len=BEAM_MAX_LEN,
                           beam_size=BEAM_SIZE)
    transcribe_path("beam_int8", beam_imgs, max_len=BEAM_MAX_LEN,
                    beam_size=BEAM_SIZE, quantized_kv=True)

    # one streamed transcription (an image whose seeded greedy decode runs
    # long): events in order, chunks a prefix of the finished sequence
    from acai_omr_tpu_torch import InferenceEvent
    from acai_omr_tpu_torch.inference.vitomr_inference import streamed_inference
    _build.reset_launch_counts()
    kinds, chunks, t_dec = [], [], None
    for ev in streamed_inference(model.params, model.cfg,
                                 model._load_image(imgs[1]),
                                 max_inference_len=MAX_LEN,
                                 compute_dtype=model.compute_dtype,
                                 device=model.device):
        kinds.append(ev["type"])
        if ev["type"] == InferenceEvent.ENCODING_FINISH.value:
            torch.cuda.synchronize()
            t_dec = time.perf_counter()
        elif ev["type"] == InferenceEvent.STEP.value:
            chunks.append(ev["payload"]["tokens"])
        elif ev["type"] == InferenceEvent.INFERENCE_FINISH.value:
            fin = ev["payload"]
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t_dec
    n_stream = int(fin["mask"].sum()) - 1
    streamed = np.concatenate(chunks, axis=1)[0] if chunks else np.zeros(0, int)
    if kinds != (["encoding_start", "encoding_finish"]
                 + ["step"] * len(chunks) + ["inference_finish"]) \
            or not np.array_equal(streamed,
                                  fin["sequence"][0, 1:1 + len(streamed)]):
        failures.append("streamed: events")
    finish_path("streamed", n_stream, stream_s, {"step_events": len(chunks)})

    sv = serve_path(torch, np, model, imgs)
    paths["serve_wsgi"] = sv
    shown = {k: v for k, v in sv.items()
             if k not in ("launches", "launches_batched", "device_launches",
                          "variants")}
    print(f"[path serve_wsgi] {json.dumps(shown)}", flush=True)
    print(f"[path serve_wsgi] launches {json.dumps(sv['launches'])}",
          flush=True)
    failures += [f"serve_wsgi: {e}" for e in sv["errors"]]
    if sv["completed"] != SERVE_CLIENTS \
            or sv["batcher"]["completed"] != SERVE_CLIENTS \
            or sv["batcher"]["failed"]:
        failures.append("serve_wsgi: not every request completed")
    if sv["launches"]["quant_linear_bias_act"]:
        failures.append("serve_wsgi: launched quant_linear_bias_act")
    for k in EXPECTED_KERNELS["serve_wsgi"]:
        if sv["launches"][k] <= 0:
            failures.append(f"serve_wsgi: launches[{k}]=0")
    print(variant_line("serve_wsgi", sv), flush=True)
    failures.extend(variant_failures("serve_wsgi", sv))
    # K14 is one device kernel a call on the W4A8 paths
    for name in ("w4a8", "serve_wsgi"):
        r = paths[name]
        if r["device_launches"]["quant4_linear_bias_act"] \
                != r["launches"]["quant4_linear_bias_act"]:
            failures.append(f"{name}: K14 ran more than one device kernel a "
                            f"call")

    hd_k11, hd_bf16 = per_op_paths(torch, model, imgs, greedy, quant,
                                   transcribe_path, decode_lib, paths,
                                   failures)

    # the meshed decode: data- and tensor-parallel shards on this card
    mesh_paths(torch, model, imgs, decode_lib, paths, failures, finish_path,
               {"greedy_bf16": greedy, "int8": quant,
                "int8_bf16w": bf16_weights, "beam_bf16": beam,
                "decode_hd_bf16": hd_bf16})
    # K5 is one device kernel a call on the W8A8 paths
    for name in ("int8", "beam_int8", "tp2_int8_w8a8"):
        r = paths[name]
        if r["device_launches"]["quant_linear_bias_act"] \
                != r["launches"]["quant_linear_bias_act"]:
            failures.append(f"{name}: K5 ran more than one device kernel a "
                            f"call")

    cmp = compare_paths(torch, np, model, imgs,
                        profile="--profile" in sys.argv[1:])
    print(f"[compare] {json.dumps(cmp)}", flush=True)
    if "--profile" in sys.argv[1:]:
        print(f"[profile] K2 device ms a bf16 step "
              f"{cmp['bf16']['k2_device_ms_per_step']:.4f}, K4 "
              f"{cmp['bf16']['k4_device_ms_per_step']:.4f}, of "
              f"{cmp['bf16']['profile']['device_ms_per_step']:.4f}; K11 "
              f"device ms a per-op bf16 step "
              f"{cmp['per_op_bf16']['k11_device_ms_per_step']:.4f} of "
              f"{cmp['per_op_bf16']['profile']['device_ms_per_step']:.4f}",
              flush=True)
    if "--profile" in sys.argv[1:]:
        print(f"[profile] K6 device ms an int8 (W8A8) step "
              f"{cmp['int8']['k6_device_ms_per_step']:.4f}, K5 "
              f"{cmp['int8']['k5_device_ms_per_step']:.4f}, of "
              f"{cmp['int8']['profile']['device_ms_per_step']:.4f} "
              f"({cmp['int8']['device_kernels_per_step']:.0f} device kernels "
              f"a step); K6 a W4A8 "
              f"step {cmp['w4a8']['k6_device_ms_per_step']:.4f}, K14 "
              f"{cmp['w4a8']['k14_device_ms_per_step']:.4f}, of "
              f"{cmp['w4a8']['profile']['device_ms_per_step']:.4f}; K12 "
              f"device ms a per-op int8 step "
              f"{cmp['per_op_int8']['k12_device_ms_per_step']:.4f}, K13 "
              f"{cmp['per_op_int8']['k13_device_ms_per_step']:.4f}, of "
              f"{cmp['per_op_int8']['profile']['device_ms_per_step']:.4f}",
              flush=True)
        print(f"[profile] in turns with the replaced forms: K5 simt "
              f"{cmp['int8']['k5_simt_device_ms_per_step']:.4f} of a W8A8 "
              f"step's "
              f"{cmp['int8']['profile_simt']['device_ms_per_step']:.4f}; "
              f"K12 simt "
              f"{cmp['per_op_int8']['k12_simt_device_ms_per_step']:.4f} of a "
              f"per-op int8 step's "
              f"{cmp['per_op_int8']['profile_simt']['device_ms_per_step']:.4f}"
              f"; K13 simt "
              f"{cmp['per_op_int8']['k13_k13simt_device_ms_per_step']:.4f} "
              f"of a per-op int8 step's "
              f"{cmp['per_op_int8']['profile_k13simt']['device_ms_per_step']:.4f}",
              flush=True)
    # one device kernel a wrapper call: 11 a layer (six K1, K5 or K14, two
    # K2 or K6, three K4)
    for key in ("bf16", "int8", "w4a8"):
        if cmp[key]["device_kernels_per_step"] != 11 * n_layers:
            failures.append(f"{key} step: "
                            f"{cmp[key]['device_kernels_per_step']} device "
                            f"kernels, not {11 * n_layers}")

    mark("serving_paths")
    # models/vitomr's entry points on weights through the reference's
    # state-dict layouts and back
    api = vitomr_api_path(torch, np, model, imgs)
    mark("vitomr_api")
    paths["vitomr_api"] = api
    print(f"[path vitomr_api] " + json.dumps(
        {k: v for k, v in api.items()
         if k not in ("launches", "device_launches", "variants")}),
        flush=True)
    print(f"[path vitomr_api] launches {json.dumps(api['launches'])}",
          flush=True)
    print(variant_line("vitomr_api", api), flush=True)
    failures.extend(variant_failures("vitomr_api", api))
    if not (all(api["round_trip"].values()) and api["greedy_equal"]
            and api["beam_equal"] and api["next_token_through_kernels"]
            and api["next_token_finite"]
            and api["next_token_logprob_max_abs_err"] < CMP_LOGIT_TOL
            and api["next_token_argmax_agreement"] >= CMP_AGREEMENT):
        failures.append("vitomr_api: round trip, tokens or next-token "
                        "distributions")
    for k in EXPECTED_KERNELS["vitomr_api"]:
        if api["launches"][k] <= 0:
            failures.append(f"vitomr_api: launches[{k}]=0")

    # the training path and its comparison with the plain twins
    import tempfile
    with tempfile.TemporaryDirectory() as tmp_dir:
        tr = train_path(torch, model, tmp_dir)
    paths["train_tf"] = tr
    want = expected_micro_launches(model.cfg)
    print(f"[path train_tf] window_losses={tr['window_losses']} "
          f"val_losses={tr['val_losses']} wall_s={tr['wall_s']:.2f} "
          f"peak_memory_gb={tr['peak_memory_gb']:.2f} "
          f"ms_per_microbatch={[round(v, 1) for v in tr['micro_ms']]} "
          f"optimizer_ms={[round(v, 1) for v in tr['update_ms']]} "
          f"val_ms={[round(v, 1) for v in tr['val_ms']]} "
          f"shapes={tr['shapes']} files={tr['files']}", flush=True)
    print(f"[path train_tf] launches per microbatch "
          f"{json.dumps(tr['launches_per_microbatch'][-1])} expected "
          f"{json.dumps(want)}; per validation batch "
          f"{json.dumps(tr['launches_per_val_batch'][-1])}", flush=True)
    print(f"[path train_tf] launches {json.dumps(tr['launches'])}", flush=True)
    print(variant_line("train_tf", tr), flush=True)
    failures.extend(variant_failures("train_tf", tr))
    finite = lambda vs: len(vs) > 0 and all(math.isfinite(v) for v in vs)
    if not (finite(tr["window_losses"]) and finite(tr["val_losses"])
            and len(tr["window_losses"]) == TRAIN_UPDATES
            and tr["grads_finite"]):
        failures.append("train_tf: non-finite loss or gradient")
    if tr["unmoved"] or tr["moved_frozen"]:
        failures.append(f"train_tf: unmoved {tr['unmoved']} moved frozen "
                        f"{tr['moved_frozen']}")
    if any(m != want for m in tr["launches_per_microbatch"]):
        failures.append("train_tf: launches per microbatch differ from the "
                        "layer arithmetic")
    if "tf/vitomr.npz" not in tr["files"] or "tf/stats.csv" not in tr["files"]:
        failures.append("train_tf: checkpoint or stats.csv missing")
    for k in EXPECTED_KERNELS["train_tf"]:
        if tr["launches"][k] <= 0:
            failures.append(f"train_tf: launches[{k}]=0")
    failures.extend(k8_one_kernel_failures("train_tf", tr))

    tcmp = compare_training(torch, model,
                            profile="--profile" in sys.argv[1:])
    leaf_errs = tcmp.pop("leaf_rel_err")
    print(f"[compare train kernel-vs-plain] {json.dumps(tcmp)}", flush=True)
    if "--profile" in sys.argv[1:]:
        print(k8_profile_line("a stage-2 microbatch", tcmp), flush=True)
    if not tcmp["equal_bits_two_runs"]:
        failures.append("train: two runs of one microbatch differ in bits")
    if not (tcmp["grads_finite"] and tcmp["loss_rel_err"] <= CMP_LOSS_REL
            and tcmp["grad_worst_leaf_rel_err"] <= CMP_LEAF_REL
            and tcmp["grad_global_rel_err"] <= CMP_GLOBAL_REL):
        failures.append("train kernel path vs plain path")
    if not (tcmp["loss_rel_err"] <= CMP_LOSS_BAND
            and tcmp["grad_worst_leaf_rel_err"] <= CMP_LEAF_BAND
            and tcmp["grad_global_rel_err"] <= CMP_GLOBAL_BAND):
        failures.append("train kernel path vs plain path: outside three "
                        "times the errors measured before")
    tcmp["leaf_rel_err"] = leaf_errs

    # the GRPO path (stage 3) on the stage-2 model's hand-off
    with tempfile.TemporaryDirectory() as tmp_dir:
        gr = grpo_path(torch, np, model, tmp_dir)
    paths["train_grpo"] = gr
    for i, st in enumerate(gr["steps"]):
        print(f"[path train_grpo] step {i + 1}: ms={st['ms']:.1f} phase_s="
              f"{json.dumps({k: round(v, 3) for k, v in st['phase_times'].items()})} "
              f"loss={st['loss']:.5f} ce={st['ce_loss']:.4f} "
              f"reward={st['reward']:.4f} rollout_tokens={st['rollout_tokens']} "
              f"decode_steps={st['decode_steps']} "
              f"update_width={st['update_width']} launches="
              f"{json.dumps(st['launches'])}", flush=True)
    print(f"[path train_grpo] mini-validation {json.dumps(gr['val'])} "
          f"wall_s={gr['wall_s']:.2f} peak_memory_gb="
          f"{gr['peak_memory_gb']:.2f} files={gr['files']}", flush=True)
    print(f"[path train_grpo] launches {json.dumps(gr['launches'])}",
          flush=True)
    print(variant_line("train_grpo", gr), flush=True)
    failures.extend(variant_failures("train_grpo", gr))
    if not (len(gr["steps"]) == GRPO_EXAMPLES // GRPO_BATCH
            and len(gr["val"]) == 1
            and finite([v for st in gr["steps"]
                        for v in (st["loss"], st["reward"], st["ce_loss"])])
            and finite([gr["val"][0]["reward"], gr["val"][0]["ce_loss"]])):
        failures.append("train_grpo: steps, mini-validation, or a non-finite "
                        "loss or reward")
    if gr["frozen_moved"] or gr["decoder_unmoved"]:
        failures.append(f"train_grpo: frozen leaves moved "
                        f"{gr['frozen_moved']}, decoder leaves unmoved "
                        f"{gr['decoder_unmoved']}")
    if "grpo/stats.csv" not in gr["files"] \
            or "grpo/grpo_vitomr.npz" not in gr["files"]:
        failures.append("train_grpo: stats.csv or grpo_vitomr.npz missing")
    for k in EXPECTED_KERNELS["train_grpo"]:
        if gr["launches"][k] <= 0:
            failures.append(f"train_grpo: launches[{k}]=0")

    mark("train_tf_grpo")
    # training over the mesh, every shard on this card: data-parallel steps
    # (stage 2 and stage 1), the pipelined decoder, GRPO's meshed step; K15
    # sums the data shards once a gradient step
    mesh_runs = {"train_dp": train_dp_path(torch, model),
                 "train_pp": train_pp_path(torch, model),
                 "grpo_dp": grpo_dp_path(torch, np, model)}
    mark("mesh_training")
    for name, r in mesh_runs.items():
        paths[name] = r
    failures.extend(mesh_run_failures(mesh_runs))

    # the MAE pretraining path, its hand-off to stage 2 and its comparison
    # with the plain twins
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp_dir:
        mae = pretrain_path(torch, tmp_dir)
    mae_cfg, mae_params = mae.pop("cfg"), mae.pop("params")
    paths["pretrain_mae"] = mae
    want_step, want_val, want_variants = expected_mae_launches(mae_cfg)
    print(f"[path pretrain_mae] batch={MAE_BATCH} train_losses="
          f"{mae['train_losses']} val_losses={mae['val_losses']} "
          f"grad_norms={[round(v, 4) for v in mae['grad_norms']]} "
          f"wall_s={mae['wall_s']:.2f} "
          f"peak_memory_gb={mae['peak_memory_gb']:.2f} "
          f"ms_per_step={[round(v, 1) for v in mae['step_ms']]} "
          f"val_ms={[round(v, 1) for v in mae['val_ms']]} "
          f"files={mae['files']}", flush=True)
    print(f"[path pretrain_mae] launches per step "
          f"{json.dumps(mae['launches_per_step'][-1])} expected "
          f"{json.dumps(want_step)}; per validation batch "
          f"{json.dumps(mae['launches_per_val_batch'][-1])}; by variant after "
          f"the first step {json.dumps(mae['variants_after_each_step'][0])} "
          f"expected {json.dumps(want_variants)}", flush=True)
    print(f"[path pretrain_mae] launches {json.dumps(mae['launches'])}",
          flush=True)
    print(variant_line("pretrain_mae", mae), flush=True)
    failures.extend(variant_failures("pretrain_mae", mae))
    if not (finite(mae["train_losses"]) and finite(mae["val_losses"])
            and finite(mae["grad_norms"])
            and len(mae["step_ms"]) == MAE_UPDATES
            and len(mae["val_ms"]) == 1):
        failures.append("pretrain_mae: non-finite loss or gradient norm, or "
                        "another number of steps than planned")
    if mae["unmoved"]:
        failures.append(f"pretrain_mae: unmoved {mae['unmoved']}")
    if any(m != want_step for m in mae["launches_per_step"]) \
            or any(m != want_val for m in mae["launches_per_val_batch"]) \
            or mae["variants_after_each_step"][0] != want_variants:
        failures.append("pretrain_mae: launches differ from the layer "
                        "arithmetic")
    if not (mae["npz_equal"] and mae["stage2_holds_encoder"]
            and "mae/stats.csv" in mae["files"]):
        failures.append("pretrain_mae: pretrained_mae.npz, its hand-off to "
                        "stage 2, or stats.csv")
    for k in EXPECTED_KERNELS["pretrain_mae"]:
        if mae["launches"][k] <= 0:
            failures.append(f"pretrain_mae: launches[{k}]=0")
    failures.extend(k8_one_kernel_failures("pretrain_mae", mae))

    mcmp = compare_pretrain(torch, mae_cfg, mae_params,
                            profile="--profile" in sys.argv[1:])
    leaf_errs = mcmp.pop("leaf_rel_err")
    print(f"[compare pretrain kernel-vs-plain] {json.dumps(mcmp)}", flush=True)
    if "--profile" in sys.argv[1:]:
        print(k8_profile_line("an MAE update", mcmp), flush=True)
    if not mcmp["equal_bits_two_runs"]:
        failures.append("pretrain: two runs of one batch differ in bits")
    if not (mcmp["grads_finite"] and mcmp["loss_rel_err"] <= CMP_LOSS_REL
            and mcmp["grad_worst_leaf_rel_err"] <= CMP_LEAF_REL
            and mcmp["grad_global_rel_err"] <= CMP_GLOBAL_REL):
        failures.append("pretrain kernel path vs plain path")
    mcmp["leaf_rel_err"] = leaf_errs

    mark("training_paths")
    # the evaluation CLI and the reference-loss tool on a written test layout
    with tempfile.TemporaryDirectory() as tmp_dir:
        ev = eval_cli_path(torch, np, tmp_dir)
        mark("eval_cli")
        # the host tools, their statistics over the eval layout's images
        ht = host_tools_path(torch, np, Path(tmp_dir) / "data")
        mark("host_tools")
    paths["eval_cli"] = ev
    print(f"[path eval_cli] " + json.dumps(
        {k: v for k, v in ev.items()
         if k not in ("launches", "device_launches", "variants",
                      "mae_launches")}), flush=True)
    print(f"[path eval_cli] launches {json.dumps(ev['launches'])}; MAE "
          f"{json.dumps(ev['mae_launches'])}", flush=True)
    print(variant_line("eval_cli", ev), flush=True)
    failures.extend(variant_failures("eval_cli", ev))
    failures.extend(variant_failures(
        "eval_cli", {"launches": ev["mae_launches"],
                     "variants": ev["mae_variants"]}))
    mae_k3 = ev["mae_variants"].get("encoder_attention", {})
    if not (finite([ev["vitomr_loss_npz"], ev["mae_loss"]])
            and ev["pth_equals_npz"]
            # every eval batch through the kernels: 12 encoder and 2 x 12
            # decoder attentions a ViTOMR batch; 12 of head dim 64 and 8 of
            # 32 an MAE batch
            and ev["launches"]["encoder_attention"] % 36 == 0
            and mae_k3.get("sm90_dh64", 0) * 8
            == mae_k3.get("sm90_dh32", -1) * 12 > 0):
        failures.append(f"eval_cli: losses, the .pth route or the launches "
                        f"{ev['launches']['encoder_attention']} {mae_k3}")
    if not (ev["vitomr_loss_rel_err"] <= CMP_LOSS_REL
            and ev["mae_loss_rel_err"] <= CMP_LOSS_REL):
        failures.append("eval_cli: a loss off the plain twins' by more than "
                        "CMP_LOSS_REL")
    off = [r["shape"] for r in ev["k1_shapes"] if not r["ok"]]
    if off:
        failures.append(f"eval_cli: K1 off its twin at the path's shapes {off}")
    for k in EXPECTED_KERNELS["eval_cli"]:
        if ev["launches"][k] <= 0 or ev["mae_launches"][k] <= 0:
            failures.append(f"eval_cli: launches[{k}]=0")
    paths["host_tools"] = ht
    print(f"[path host_tools] {json.dumps(ht)}", flush=True)
    if not ht["ok"]:
        failures.append("host_tools: round trip, vocabulary, statistics, "
                        "device ingest or parity gate")
    # K15 at the data-parallel step's shape: the flagship's gradients and
    # the two scalars, padded to a multiple of 8, at D = 2 and 4
    n_flat = -(-(n_params + 2) // 8) * 8
    for d in (2, 4):
        c = k15_flat_case(torch, n_flat, d)
        cases.append(c)
        print(f"[kernel] tp_allreduce[{c['case']}] max_abs_err="
              f"{c['max_abs_err']:.3e} tol=0.0e+00 kernel_ms={c['ms']:.4f} "
              f"plain_ms={c['plain_ms']:.4f} library_ms="
              f"{c['library_ms']:.4f} bound_ms={c['bound_ms']:.4f} "
              f"({c['bound_by']}) " + ("ok" if c["ok"] else "FAIL"),
              flush=True)
    mark("k15_flat")
    print(f"[time] total {sum(phase_s.values()):.1f} s", flush=True)

    failures += [f"{c['op'].name}[{c['case']}]" for c in cases if not c["ok"]]
    if race_bad:
        failures.append(f"tp_allreduce race checks: {race_bad} of "
                        f"{2 * RACE_CALLS} calls differ from the twin")
    if spills:
        failures.append(f"local memory (a spill) in the Hopper kernels "
                        f"{spills}")
    failures += k7_bad
    if cmp["encoder_rel_err"] >= 0.02:
        failures.append("encoder kernel path vs plain path")
    for key in ("bf16", "int8", "w4a8"):
        c = cmp[key]
        if not (c["logits_finite"] and c["token_agreement"] >= CMP_AGREEMENT
                and c["logit_max_abs_err"] < CMP_LOGIT_TOL):
            failures.append(f"{key} kernel path vs plain path")

    def of_variant(key, v):
        """Whether launches counted under ``key`` are the case's variant
        ``v``: ``v`` itself, or where ``v`` ends in "split" any of its
        "split{s}" keys (K5's "split" / "partial_split", K12's
        "stacked_split")."""
        return key == v or (v.endswith("split") and key.startswith(v)
                            and key[len(v):].isdigit())

    def path_sum(counts, c):
        """The case's launches on its paths: its variant's where it has one
        (``device_launches`` are not split by variant)."""
        if c["variant"] and counts == "launches":
            return sum(n_ for n in c["paths"] for key, n_ in
                       paths[n]["variants"][c["op"].name].items()
                       if of_variant(key, c["variant"]))
        return sum(paths[n][counts][c["op"].name] for n in c["paths"])

    kernels = [{"name": f"{c['op'].name}[{c['case']}]", "route": c["op"].route,
                "source": c["op"].source, "replaces": c["op"].replaces,
                "launches": path_sum("launches", c),
                "device_launches": path_sum("device_launches", c),
                "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                "host_us": c["host_us"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                **({} if c["cold_ms"] is None else {"cold_ms": c["cold_ms"]}),
                **({} if c["old_ms"] is None else {"old_ms": c["old_ms"]}),
                **({} if c["library_cold_ms"] is None
                   else {"library_cold_ms": c["library_cold_ms"]}),
                **c["extra"]}
               for c in cases]
    failures += [f"launches[{k['name']}]=0" for k in kernels
                 if k["launches"] <= 0]
    report = {"card": card, "build_s": build_s, "phase_s": phase_s,
              "n_params": n_params,
              "kernels": kernels, "paths": paths, "compare": cmp,
              "per_op_bf16_k11_turns": hd_k11,
              "compare_training": tcmp, "compare_pretrain": mcmp,
              "failures": failures}
    if "--report" in sys.argv[1:]:
        path = Path(sys.argv[sys.argv.index("--report") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1))

    if failures:
        print(f"[fail] {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
