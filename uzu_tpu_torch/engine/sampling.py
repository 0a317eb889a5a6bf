"""Sampling on the device: temperature -> top-k -> top-p -> min-p ->
gumbel/argmax, with repetition penalty over a recent-token ring.

Counterpart of `uzu_tpu/engine/sampling.py` (`sample`, `push_ring` and
the masks). The gumbel noise comes from a `torch.Generator` on the
logits' device, so sampled tokens differ from the JAX package's (its keys
are threefry); greedy decoding and the masks are the same function.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Static sampling configuration."""

    temperature: float | None = None  # None or 0 => greedy
    top_k: int | None = None
    top_p: float | None = None
    min_p: float | None = None
    repetition_penalty: float | None = None
    suffix_repetition_length: int = 64
    banned_tokens: tuple = ()

    @property
    def is_greedy(self) -> bool:
        return self.temperature is None or self.temperature <= 0.0

    @classmethod
    def from_generation_config(cls, g) -> "SamplingParams":
        banned = g.banned_tokens if isinstance(g.banned_tokens, (list, tuple)) else ()
        return cls(
            temperature=g.temperature,
            top_k=g.top_k,
            top_p=g.top_p,
            min_p=g.min_p,
            repetition_penalty=g.repetition_penalty,
            suffix_repetition_length=g.suffix_repetition_length or 64,
            banned_tokens=tuple(int(t) for t in banned),
        )


def apply_repetition_penalty(logits: torch.Tensor, ring: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Divide positive / multiply negative logits of recently seen tokens."""
    v = logits.shape[-1]
    seen = torch.zeros((v,), dtype=torch.bool, device=logits.device)
    seen.index_put_((ring.clamp(0, v - 1).long(),), ring >= 0, accumulate=True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k).values[..., -1]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always >= 1 token)
    keep = cum - probs < p
    cutoff = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))).min()
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def _mask_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    cutoff = probs.max() * min_p
    return torch.where(probs < cutoff, torch.full_like(logits, NEG_INF), logits)


def sample(
    logits: torch.Tensor,  # [V] f32
    params: SamplingParams,
    generator: torch.Generator | None = None,
    ring: torch.Tensor | None = None,  # [R] int32, -1 = empty
    bitmask: torch.Tensor | None = None,  # [V] bool, True = allowed
) -> torch.Tensor:
    """-> 0-d int64 token on the logits' device (no host sync)."""
    logits = logits.float()
    if params.banned_tokens:
        banned = torch.as_tensor(params.banned_tokens, dtype=torch.long, device=logits.device)
        logits = logits.index_fill(0, banned, NEG_INF)
    if bitmask is not None:
        logits = torch.where(bitmask, logits, torch.full_like(logits, NEG_INF))
    if params.repetition_penalty is not None and ring is not None:
        logits = apply_repetition_penalty(logits, ring, params.repetition_penalty)
    if params.is_greedy:
        return torch.argmax(logits)
    logits = logits / params.temperature
    if params.top_k is not None and params.top_k < logits.shape[-1]:
        logits = _mask_top_k(logits, params.top_k)
    if params.top_p is not None:
        logits = _mask_top_p(logits, params.top_p)
    if params.min_p is not None:
        logits = _mask_min_p(logits, params.min_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return torch.argmax(logits + gumbel)


def push_ring(ring: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Append a token to the recent-token ring (shift-left semantics)."""
    return torch.cat([ring[1:], token.reshape(1).to(ring.dtype)])
