"""The port's probe tools: the GEMM and decode-attention probes and the
scratch probe of the JAX package's ``tools/``, run on the card as
``python -m acai_omr_tpu_torch.tools.<name>``.

Each runs on ``cuda`` and raises without a GPU, unless the caller passes
``device="cpu"``: then its kernels' plain twins run, and every time it
prints is a CPU time, named so.
"""
