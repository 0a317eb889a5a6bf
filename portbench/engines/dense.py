"""The dense `BatchEngine` (`engine/batch.py`), the hybrids' only batched
path: one whole-context state per slot; a prompt is prefilled through
`LanguageModel._forward` into a fresh state, then inserted; decode
attention is the plain batched einsum (no hand kernel)."""

from __future__ import annotations

from uzu_tpu_torch.engine.batch import BatchEngine

PREFILL = None  # the model's own `_forward`, wrapped on the instance
DECODE_ATTENTION_GROUP = None


def build(lm, cfg: dict):
    return BatchEngine(lm, batch_size=cfg["batch_size"], decode_chunk=cfg["decode_chunk"],
                       stop_token_ids=[])


def prefill_call(engine, args):
    """lm._forward(tokens, state, true_length, ctx_bucket); the position of
    row 0 is the admission's progress, kept by the engine."""
    return int(engine._admitting[2]), int(args[2]), int(args[0].shape[0])
