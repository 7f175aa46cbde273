"""Central constants of the port (the twin of ``acai_omr_tpu/config.py``).

Paths are relative to the repo root by default and overridable through the
same environment variables as the JAX package.
"""

import os
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent


def _env_path(name: str, default: str) -> str:
    return os.environ.get(name, default)


# Special LMX tokens
LMX_BOS_TOKEN = "<bos>"
LMX_EOS_TOKEN = "<eos>"
LMX_PAD_TOKEN = "<pad>"

# Vocabulary file: 227 LMX tokens, one per line, specials first.
LMX_VOCAB_PATH = _env_path("ACAI_LMX_VOCAB", str(REPO_ROOT / "lmx_vocab.txt"))

# Checkpoint landing spots: the port's readers take the ``.npz`` of that
# name or the JAX package's orbax directory there.
PRETRAINED_MAE_PATH = _env_path("ACAI_PRETRAINED_MAE",
                                "mae_pre_train/pretrained_mae")
INFERENCE_VITOMR_PATH = _env_path("ACAI_INFERENCE_VITOMR",
                                  "tf_omr_train/vitomr")
DEBUG_PRETRAINED_MAE_PATH = _env_path("ACAI_DEBUG_MAE", "debug_pretrained_mae")
DEBUG_TEACHER_FORCED_PATH = _env_path(
    "ACAI_DEBUG_VITOMR", "debug_teacher_forced_omr_train/debug_vitomr")

# Model shape constants shared by training + inference.
PATCH_SIZE = 16
PE_MAX_HEIGHT = 60
PE_MAX_WIDTH = 200
MAE_MAX_SEQ_LEN = 512       # encoder patch budget during MAE pretraining
OMR_MAX_IMG_SEQ_LEN = 1024  # encoder patch budget during seq2seq training/inference
MAX_LMX_SEQ_LEN = 1536      # decoder token budget
NUM_CHANNELS = 1            # sheet-music images are grayscale

# The JAX package's static shape-bucket granularity (a padded length's
# multiple); kept as a public name, read by no module of either package.
SEQ_BUCKET_MULTIPLE = 128

# Flagship architecture (the JAX package's train/omr_teacher_force_train
# ``set_up_vitomr``): ViT-B encoder, 12-layer 1024-wide decoder.
ENCODER_FINE_TUNE_DEPTH = 12
NUM_DECODER_LAYERS = 12

# Where the CUDA kernels of ``csrc/`` are built at first use (gitignored).
KERNEL_BUILD_DIR = _env_path("ACAI_TORCH_KERNEL_DIR",
                             str(REPO_ROOT / "build" / "torch_kernels"))

# Dataset roots of stage-1 and stage-2 training (not in the repository).
PRIMUS_PREPARED_ROOT_DIR = _env_path("ACAI_PRIMUS_ROOT", "data/primusPrepared")
DOREMI_PREPARED_ROOT_DIR = _env_path("ACAI_DOREMI_ROOT", "data/doReMiPrepared")
GRAND_STAFF_ROOT_DIR = _env_path(
    "ACAI_GRAND_STAFF_ROOT", "data/grandstaff-lmx.2024-02-12/grandstaff-lmx")
OLIMPIC_SYNTHETIC_ROOT_DIR = _env_path(
    "ACAI_OLIMPIC_SYNTH_ROOT",
    "data/olimpic-1.0-synthetic.2024-02-12/olimpic-1.0-synthetic")
OLIMPIC_SCANNED_ROOT_DIR = _env_path(
    "ACAI_OLIMPIC_SCAN_ROOT",
    "data/olimpic-1.0-scanned.2024-02-12/olimpic-1.0-scanned")
