"""Threaded prefetching batch loader: host packing overlapped with device
steps (the twin of the JAX package's ``data/loader.py``).

Workers load, transform and *pack* examples into static-shape numpy arrays
(the expensive host work is PIL decode/resize and numpy patchify, which
release the GIL in C); a bounded queue keeps a few packed batches ready.
:func:`to_device` moves a packed batch through pinned host buffers with
``non_blocking`` copies, so the transfer overlaps the previous step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import omr_decoder, vit_encoder
from ..ops import patchify as patch_ops
from ..models.vit_encoder import EncoderConfig


def _pad_batch_dim(arrays: dict, pad_to: int | None,
                   fills: dict | None = None) -> dict:
    """Pad every array's batch dim to ``pad_to`` (padding rows have
    valid=False / length 0 / pad-token targets, so they add nothing to a
    loss; their attention rows see no valid key and spread uniformly)."""
    if pad_to is None:
        return arrays
    b = next(iter(arrays.values())).shape[0]
    if b >= pad_to:
        return arrays
    fills = fills or {}
    out = {}
    for k, v in arrays.items():
        pad = [(0, pad_to - b)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad, constant_values=fills.get(k, 0))
    return out


def pack_mae_batch(examples, enc_cfg: EncoderConfig, bucket_multiple=128,
                   pad_to_batch: int | None = None) -> dict:
    """[(input_img, target_img)] -> packed arrays for an MAE step: patches,
    pe_idx, pe_w, valid, lengths, target_patches. Targets share their
    input's shape and are patchified into the same bucket; when every target
    IS its input object (the un-augmented wrappers pass it straight through)
    the input's patches are reused instead of patchifying twice."""
    inputs = [ex[0] for ex in examples]
    targets = [ex[1] for ex in examples]
    pb = vit_encoder.batchify(inputs, enc_cfg, bucket_multiple)
    if all(t is i for t, i in zip(targets, inputs)):
        tgt = pb.patches
    else:
        tgt = np.zeros_like(pb.patches)
        for i, t in enumerate(targets):
            t = np.asarray(t, dtype=np.float32)
            if t.ndim == 2:
                t = t[None]
            tp = patch_ops.patchify(t, enc_cfg.patch_size)
            tgt[i, :tp.shape[0]] = tp
    arrays = dict(patches=pb.patches, pe_idx=pb.pe_idx, pe_w=pb.pe_w,
                  valid=pb.valid, lengths=pb.lengths, target_patches=tgt)
    return _pad_batch_dim(arrays, pad_to_batch)


def pack_omr_batch(examples, enc_cfg: EncoderConfig, tokenizer,
                   bucket_multiple=128, lmx_bucket_multiple=128,
                   max_lmx_seq_len: int | None = None,
                   pad_to_batch: int | None = None) -> dict:
    """[(img, lmx)] -> packed arrays for a seq2seq step: patches, pe_idx,
    pe_w, valid, lengths, inputs, targets, lmx_valid. Patch and token lengths
    are padded to multiples of 128."""
    imgs = [ex[0] for ex in examples]
    lmx = [ex[1] for ex in examples]
    pb = vit_encoder.batchify(imgs, enc_cfg, bucket_multiple)
    seqs = [tokenizer.encode(s) if isinstance(s, str)
            else np.asarray(s, np.int32) for s in lmx]
    inputs, targets, lmx_valid = omr_decoder.batchify_and_split_lmx_seqs(
        seqs, tokenizer.pad_idx, lmx_bucket_multiple, max_len=max_lmx_seq_len)
    arrays = dict(patches=pb.patches, pe_idx=pb.pe_idx, pe_w=pb.pe_w,
                  valid=pb.valid, lengths=pb.lengths, inputs=inputs,
                  targets=targets, lmx_valid=lmx_valid)
    return _pad_batch_dim(arrays, pad_to_batch,
                          fills={"inputs": tokenizer.pad_idx,
                                 "targets": tokenizer.pad_idx})


def to_device(batch: dict, device) -> dict:
    """The numpy arrays of a packed batch as tensors on ``device``. For a CUDA
    device each goes through a pinned host buffer and a ``non_blocking``
    copy."""
    device = torch.device(device)
    out, moved = {}, {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        if id(v) not in moved:  # an MAE batch may name one array twice
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            moved[id(v)] = t
        out[k] = moved[id(v)]
    return out


class PrefetchLoader:
    """Iterate ``pack_fn(dataset[batch_indices])`` with worker threads.

    The sampler yields index arrays. Up to ``prefetch`` packed batches wait in
    a queue; example loading fans out over ``num_workers`` threads.
    """

    def __init__(self, dataset, sampler, pack_fn, num_workers: int = 8,
                 prefetch: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.pack_fn = pack_fn
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that notices an abandoned consumer
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in self.sampler:
                        examples = list(pool.map(self.dataset.__getitem__,
                                                 idxs))
                        if not put(self.pack_fn(examples)):
                            return
            except BaseException as e:  # surface worker errors to consumer
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
