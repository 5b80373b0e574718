"""Deterministic sharded data pipeline (numpy, host side).

A copy of the JAX package's ``data/pipeline.py``, which is numpy but
imports JAX: the port keeps its own.  The stream is stateless in the
step index: batch(step) is a pure function of (seed, step, host), so a
restart replays exactly (``train.fault_tolerance.RetryableStep``) and no
data state needs checkpointing beyond the step counter.  The generators
are seeded with the same ``np.random.SeedSequence`` entries as the JAX
package's, so both give the same batches bit for bit.

Synthetic tokens follow a Zipf-ish distribution over the vocab with
document structure (BOS every ~doc_len).  ``TokenFile`` memory-maps a
flat uint32 token array with the same indexing discipline.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticTokens", "TokenFile", "make_batch_specs",
           "host_batch_iterator"]


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    doc_len: int = 512
    n_hosts: int = 1
    host_id: int = 0

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step`` (this host's slice only)."""
        B = self.global_batch // self.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        z = rng.zipf(1.3, size=(B, self.seq_len + 1)) % self.vocab
        toks = z.astype(np.int32)
        bos = rng.integers(0, self.doc_len, size=(B, 1))
        pos = np.arange(self.seq_len + 1)[None, :]
        toks = np.where((pos + bos) % self.doc_len == 0, 1, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class TokenFile:
    """Memory-mapped flat token file with the same stateless indexing."""

    path: str
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.uint32, mode="r")

    def batch_at(self, step: int) -> dict:
        B = self.global_batch // self.n_hosts
        n = self._data.shape[0] - (self.seq_len + 1)
        rng = np.random.default_rng(
            np.random.SeedSequence([step, self.host_id]))
        offs = rng.integers(0, n, size=B)
        rows = np.stack([self._data[o:o + self.seq_len + 1] for o in offs])
        rows = (rows % self.vocab).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_batch_specs(cfg, shape, dtype=np.int32):
    """Host-side shapes of one global batch of a shape config
    (``global_batch``, ``seq_len``)."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": (B, S), "labels": (B, S)}
    if cfg.family == "vlm":
        specs["patches"] = (B, cfg.n_patches, cfg.patch_dim)
    if cfg.encoder_decoder:
        specs["frames"] = (B, S, cfg.patch_dim)
    return specs


def host_batch_iterator(source, cfg, start_step: int = 0,
                        extras_seed: int = 7):
    """Wrap a token source into model-ready numpy batches (adds random
    patches for the VLM and frames for the encoder–decoder), resuming at
    ``start_step``."""
    step = start_step
    while True:
        batch = source.batch_at(step)
        B, S = batch["tokens"].shape
        rng = np.random.default_rng(
            np.random.SeedSequence([extras_seed, step]))
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.patch_dim), dtype=np.float32)
        if cfg.encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (B, S, cfg.patch_dim), dtype=np.float32)
        yield batch
        step += 1
