"""The port's probe tools: the GEMM and decode-attention probes, the scratch
probe, the int4 delivery and unpack probes, the memory-stream probes, the
head-access and batched-logit probes, the elementwise-rate probe and the
backward's resource probe of the JAX package's ``tools/``, run on the card as
``python -m acai_omr_tpu_torch.tools.<name>``.

Each runs on ``cuda`` and raises without a GPU, unless the caller passes
``device="cpu"``: then its kernels' plain twins run, and every time it
prints is a CPU time, named so. The int4 and stream probes time from HBM
where a call's inputs would fit the L2 (``_probe.time_ms(copies=)``) and
say beside each time whether it was ``from HBM`` or ``warm``.
"""
