"""`PagedBatchEngine` (`engine/paged_batch.py`): slots over shared page
pools; one paged prefill chunk per call, decode attention through K5."""

from __future__ import annotations

from uzu_tpu_torch.engine import paged_batch
from uzu_tpu_torch.engine.paged_batch import PagedBatchEngine

# (module, attribute): the function each prefill chunk goes through
PREFILL = (paged_batch, "paged_prefill_chunk")
DECODE_ATTENTION_GROUP = "attention"


def build(lm, cfg: dict):
    return PagedBatchEngine(lm, batch_size=cfg["batch_size"], decode_chunk=cfg["decode_chunk"],
                            num_pages=cfg["num_pages"], page_size=cfg["page_size"],
                            stop_token_ids=[])


def prefill_call(engine, args):
    """paged_prefill_chunk(cfg, params, pools, tokens, table, pos0,
    true_length, ctx_pages)"""
    return int(args[5]), int(args[6]), int(args[3].shape[0])
