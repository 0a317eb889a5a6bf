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


# -- dynamic (per-row) sampling parameters -------------------------------------
#
# Counterpart of the JAX package's `pack_dynamic`, `apply_count_penalties`
# and `sample_dynamic`, written out over a batch of rows [B, V]: each row
# carries its own temperature / top-k / top-p / min-p (a batched server
# takes them per request), and the masks reproduce `sample`'s for any
# values. The gumbel noise is a counter-based hash of two 32-bit key words
# per row and the vocabulary index, drawn on the device for all rows at
# once: a request's noise is a pure function of its own key, whatever its
# slot or its neighbours in the batch.

DYNAMIC_OFF = (0.0, 0, 1.0, 0.0, 0.0, 0.0)
# temperature, top_k, top_p, min_p, presence_penalty, frequency_penalty


def pack_dynamic(params: SamplingParams):
    """SamplingParams -> the 6 sentinel-encoded scalars (f32-storable).
    Presence/frequency penalties ride the same row; they are not
    SamplingParams fields, so engines overwrite columns 4-5 per request."""
    return (
        float(params.temperature or 0.0),
        int(params.top_k or 0),
        float(params.top_p if params.top_p is not None else 1.0),
        float(params.min_p or 0.0),
        0.0,
        0.0,
    )


def apply_count_penalties(logits: torch.Tensor, counts: torch.Tensor,
                          presence: torch.Tensor, frequency: torch.Tensor) -> torch.Tensor:
    """OpenAI presence/frequency penalties over generated-token counts:
    logits - presence * (count > 0) - frequency * count."""
    c = counts.float()
    return logits - presence * (c > 0) - frequency * c


_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 values in [0, 2^32); each
    multiplier is below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def gumbel_noise(key0: torch.Tensor, key1: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise [B, V] f32 from per-row key words key0, key1 [B]
    (integers, taken mod 2^32): a pure function of (key0, key1, index)."""
    row = _mix32(_mix32(key0.long() & _M32) ^ (key1.long() & _M32))
    idx = torch.arange(vocab, device=key0.device, dtype=torch.int64)
    x = _mix32(_mix32(row[:, None] ^ ((idx * 0x61C88647) & _M32)))
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_dynamic(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32; <= 0 => greedy
    top_k: torch.Tensor,  # [B] int; <= 0 => off
    top_p: torch.Tensor,  # [B] f32; >= 1 => off
    min_p: torch.Tensor,  # [B] f32; <= 0 => off
    gumbel: torch.Tensor | None,  # [B, V] noise; None when every row is greedy
    bitmask: torch.Tensor | None = None,  # [B, V] bool, True = allowed
    banned_tokens: tuple = (),
) -> torch.Tensor:
    """-> tokens [B] int64 on the logits' device (no host sync)."""
    logits = logits.float()
    if banned_tokens:
        banned = torch.as_tensor(banned_tokens, dtype=torch.long, device=logits.device)
        logits = logits.index_fill(-1, banned, NEG_INF)
    if bitmask is not None:
        logits = torch.where(bitmask, logits, torch.full_like(logits, NEG_INF))
    greedy_tok = torch.argmax(logits, dim=-1)
    if gumbel is None:
        return greedy_tok
    v = logits.shape[-1]
    t = temperature.float()[:, None]
    greedy = t <= 0.0
    l = logits / torch.where(greedy, torch.ones_like(t), t)

    # one descending sort serves top-k (the k-th largest value, so ties are
    # kept as the static top-k mask keeps them) and top-p (softmax and
    # cumsum over the same sorted order the static mask uses)
    sl = torch.sort(l, dim=-1, descending=True).values
    k = top_k.long()[:, None]
    k_on = k > 0
    k_eff = torch.clamp(torch.where(k_on, k, torch.full_like(k, v)), 1, v)
    kth = sl.gather(-1, k_eff - 1)
    neg = torch.full_like(l, NEG_INF)
    l = torch.where(k_on & (l < kth), neg, l)
    slk = torch.where(k_on & (sl < kth), neg, sl)

    p = top_p.float()[:, None]
    probs = torch.softmax(slk, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < p
    cutoff_p = torch.where(keep, slk, torch.full_like(slk, float("inf"))).amin(-1, keepdim=True)
    l = torch.where((p < 1.0) & (l < cutoff_p), neg, l)

    # min-p on the unsorted masked logits, as the static mask does
    mp = min_p.float()[:, None]
    probs_u = torch.softmax(l, dim=-1)
    cutoff_m = probs_u.amax(-1, keepdim=True) * mp
    l = torch.where((mp > 0.0) & (probs_u < cutoff_m), neg, l)

    sampled = torch.argmax(l + gumbel, dim=-1)
    return torch.where(greedy[:, 0], greedy_tok, sampled)
