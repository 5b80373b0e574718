"""Batched serving engine: prefill + decode loop with sampling.

``make_serve_step`` and ``make_prefill`` bind the model's single-token
decode and its prefill; ``ServeEngine`` drives them over batched requests
with greedy or temperature sampling.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import decode_step, prefill

__all__ = ["make_serve_step", "make_prefill", "ServeEngine"]


def make_serve_step(model):
    """serve_step(tokens (B, 1), state) → (logits, state)."""

    def step(tokens, state):
        return decode_step(model, tokens, state)

    return step


def make_prefill(model, max_len: int):
    """prefill(batch) → (logits, state), caches of ``max_len`` positions in
    the default bf16."""

    def run(batch):
        return prefill(model, batch, max_len=max_len)

    return run


@dataclasses.dataclass
class ServeEngine:
    """Serves ``model`` (a ``models.Transformer``) with caches of
    ``max_len`` positions.  ``temperature`` 0 decodes greedily; above 0 it
    samples from softmax(logits / temperature) with a ``torch.Generator``
    seeded from ``seed`` at each ``generate`` call, every draw taken from
    fresh generator state."""

    model: object
    max_len: int
    temperature: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._prefill = make_prefill(self.model, self.max_len)
        self._step = make_serve_step(self.model)

    def _sample(self, logits, generator):
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.inference_mode()
    def generate(self, batch: dict, n_tokens: int) -> np.ndarray:
        """Prefill on batch['tokens'] (B, S), with the VLM's
        batch['patches'] or the encoder–decoder's batch['frames'] where
        given, then decode: n_tokens in all, the first from the prefill's
        logits.  Returns (B, n_tokens) int32."""
        logits, state = self._prefill(batch)
        B = logits.shape[0]
        gen = torch.Generator(device=logits.device).manual_seed(self.seed)
        tok = self._sample(logits, gen).reshape(B, 1)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, state = self._step(tok, state)
            tok = self._sample(logits, gen).reshape(B, 1)
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
