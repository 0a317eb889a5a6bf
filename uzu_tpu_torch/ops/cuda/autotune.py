"""Launch-plan autotuner for K1/K2's fused dequant matmul on the card.

Counterpart of `uzu_tpu/ops/pallas/autotune.py` (in the role of the
reference's fleet-tuned GEMV tile tables: measure every candidate for a
shape set on the current device, write a JSON table keyed by the device's
name, and let the launch plan consult it before its heuristics). Mosaic's
(block_n, block_k) grid and VMEM budget do not carry over; the candidates
here are K1's own plan (`quant_matmul.qmm_plan`), bucketed by its routes:

- "small" (M <= GEMV_MAX_M, bf16 x): `qmm_small`'s kw in {1, 2, 4, 8}
  warps over K per 16-row tile. The entry is keyed by (bits, N, K, bucket)
  and never by M, so every M of the route still sums in one order (the
  row-bitwise property the batched engines rely on).
- "bm128" (M <= 128) and "bm256" (larger M): `qmm_tile`'s (bm, splits),
  bm in {128, 256}, splits a power of two that leaves each split at least
  TILE_MIN_CHUNKS chunks of K.

`lookup` returns a plan only where the entry can serve the shape (a valid
kw, bm and split count for its N and K); otherwise the heuristics run.
Tables live in `tile_tables/<device name>.json` beside this file, or at
UZU_TPU_TILE_TABLE. No table ships (git ignores `tile_tables/`): a table
is promoted only after `validate_e2e` shows it winning the decode loop on
that card. Since a table changes K1's plans, and with them the order of
its sums, reading one is logged to stderr and `table_in_use` names it;
`UZU_TPU_TILE_TABLE=/dev/null` holds the heuristics alone.

Timing: `autotune_shapes` launches each candidate over many distinct
inputs between two CUDA events (launch and host overhead amortized, as
the reference folds its reps into one dispatch) and keeps the best of
three runs. It raises without a card.
"""

from __future__ import annotations

import json
import os
import sys
from functools import lru_cache

import torch

from .quant_matmul import GEMV_MAX_M, TILE_K, TILE_MIN_CHUNKS, QmmPlan, small_chunk

TABLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tile_tables")

# M buckets: K1's routes (the small route, then the tile at bm 128 and 256)
M_BUCKETS = ((GEMV_MAX_M, "small"), (128, "bm128"), (None, "bm256"))
SMALL_KWS = (1, 2, 4, 8)
TILE_BMS = (128, 256)


def m_bucket(m: int) -> str:
    """The bucket of an M: the route and tile height its plan takes."""
    for bound, name in M_BUCKETS:
        if bound is None or m <= bound:
            return name
    return M_BUCKETS[-1][1]


def _device_key() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().lower().replace(" ", "_")


def _table_path() -> str:
    return (os.environ.get("UZU_TPU_TILE_TABLE")
            or os.path.join(TABLE_DIR, f"{_device_key()}.json"))


@lru_cache(maxsize=None)
def _load_table() -> dict:
    """The table K1's plans read. A table that is read is never silent: its
    path and size go to stderr once per read, and `table_in_use` names it."""
    path = _table_path()
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if table:
        print(f"uzu_tpu_torch: K1 launch plans read the tile table {path} "
              f"({len(table)} entries)", file=sys.stderr)
    return table


def table_in_use() -> str | None:
    """The path of the tile table K1's plans read, or None (heuristics
    alone). Runs that report times report it beside them."""
    return _table_path() if _load_table() else None


def _key(bits: int, n: int, kdim: int, bucket: str) -> str:
    return f"{bits}:{n}:{kdim}:{bucket}"


def tile_splits(kdim: int) -> tuple:
    """The split counts a tile candidate may take at K: powers of two that
    leave every split TILE_MIN_CHUNKS chunks or more."""
    chunks = -(-kdim // TILE_K)
    out, s = [1], 2
    while s <= chunks // TILE_MIN_CHUNKS:
        out.append(s)
        s *= 2
    return tuple(out)


def entry_plan(entry, kdim: int, bucket: str, bits: int = 4) -> QmmPlan | None:
    """The plan of a table entry at K in its bucket, or None where the entry
    cannot serve it (wrong route for the bucket, a kw or bm the kernel does
    not take, a split count past K's chunks)."""
    if not isinstance(entry, dict):
        return None
    if bucket == "small":
        kw = entry.get("kw")
        if entry.get("route") != "small" or kw not in SMALL_KWS:
            return None
        chunks = -(-kdim // small_chunk(bits))
        if kw > 1 and -(-chunks // kw) < 2:
            return None  # a warp would walk fewer than 2 chunks
        return QmmPlan("small", kw=kw)
    bm, splits = entry.get("bm"), entry.get("splits")
    if entry.get("route") != "tile" or bm not in TILE_BMS or not isinstance(splits, int):
        return None
    chunks = -(-kdim // TILE_K)
    if splits < 1 or (splits > 1 and splits > chunks // TILE_MIN_CHUNKS):
        return None
    cps = -(-chunks // splits)
    return QmmPlan("tile", bm=bm, splits=-(-chunks // cps), chunks_per_split=cps)


def lookup(bits: int, n: int, kdim: int, m: int, x_bf16: bool = True) -> QmmPlan | None:
    """The measured plan of an [m, kdim] x [n, kdim]^T product, or None (no
    entry, or one that cannot serve the shape). f32 x at small M takes the
    f32 GEMV, which has nothing to tune."""
    if m <= GEMV_MAX_M and not x_bf16:
        return None
    table = _load_table()
    if not table:
        return None
    bucket = m_bucket(m)
    entry = table.get(_key(bits, n, kdim, bucket))
    return None if entry is None else entry_plan(entry, kdim, bucket, bits)


def _candidates(m: int, kdim: int) -> list[dict]:
    """The entries measured at M (the heuristic plan joins them if absent)."""
    if m_bucket(m) == "small":
        return [{"route": "small", "kw": kw} for kw in SMALL_KWS]
    return [{"route": "tile", "bm": bm, "splits": s} for bm in TILE_BMS
            for s in tile_splits(kdim)]


def _random_weight(n: int, kdim: int, bits: int, group_size: int, gen, device):
    """Random symmetric codes with bf16 scales: the flagship's layout."""
    from ...quant.format import QuantizedTensor

    kp = kdim * bits // 8
    codes = torch.randint(0, 256, (n, kp), dtype=torch.uint8, generator=gen).to(device)
    scales = (torch.rand((n, kdim // group_size), generator=gen) * 0.01).to(
        device=device, dtype=torch.bfloat16)
    return QuantizedTensor(codes=codes, scales=scales, qbias=None, bits=bits,
                           group_size=group_size, qbias_coeff=-float(1 << (bits - 1)))


def _time_plan(w, xs, plan: QmmPlan) -> float:
    """ms per launch of `plan` over the distinct inputs xs [reps, M, K]:
    the best of three runs of len(xs) launches between two events."""
    from .quant_matmul import quant_matmul

    quant_matmul(w, xs[0], plan=plan)  # settle
    best = None
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in xs:
            quant_matmul(w, x, plan=plan)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / len(xs)
        best = dt if best is None else min(best, dt)
    return best


def autotune_shapes(shapes, *, bits: int = 4, group_size: int = 32, m_list=(1, 8, 256),
                    reps: int = 32, seed: int = 0, verbose: bool = True,
                    timings: dict | None = None) -> dict:
    """Measure every candidate for `shapes` = [(n, k), ...] at each M of
    `m_list` on the card; returns {key: entry}, each bucket's candidate of
    the least time summed over its M (a small entry serves every M of the
    route). With `timings`, every candidate's ms per launch at each M lands
    there under "<key>:m<M>"."""
    from ...runtime import resolve_device
    from .flash_attention import num_sms
    from .quant_matmul import heuristic_plan

    device = resolve_device(None)  # no card raises
    gen = torch.Generator().manual_seed(seed)
    table = {}
    for n, kdim in shapes:
        w = _random_weight(n, kdim, bits, group_size, gen, device)
        for bucket in dict.fromkeys(m_bucket(m) for m in m_list):
            ms_in = [m for m in m_list if m_bucket(m) == bucket]
            key = _key(bits, n, kdim, bucket)
            xs, heuristic = {}, {}
            for m in ms_in:
                count = max(reps, 256) if m <= 16 else reps  # small M: more launches per event
                xs[m] = torch.randn((count, m, kdim), generator=gen).to(
                    device=device, dtype=torch.bfloat16)
                heuristic[m] = heuristic_plan(m, n, kdim, bits, num_sms(device))
            entries = _candidates(ms_in[0], kdim)
            for plan in heuristic.values():
                if plan.route == "tile" and all(
                        entry_plan(e, kdim, bucket, bits) != plan for e in entries):
                    entries.append({"route": "tile", "bm": plan.bm, "splits": plan.splits})
            totals = []
            for entry in entries:
                plan = entry_plan(entry, kdim, bucket, bits)
                if plan is None:
                    continue
                per_m = {m: _time_plan(w, xs[m], plan) for m in ms_in}
                totals.append((sum(per_m.values()), entry))
                for m, ms in per_m.items():
                    if timings is not None:
                        timings.setdefault(f"{key}:m{m}", []).append(
                            dict(entry, ms=ms, heuristic=plan == heuristic[m]))
                    if verbose:
                        print(f"  N={n} K={kdim} M={m} {entry}: {ms:.4f} ms"
                              + (" (heuristic)" if plan == heuristic[m] else ""))
            total, entry = min(totals, key=lambda r: r[0])
            table[key] = entry  # the least time summed over the bucket's M
            if verbose:
                print(f"{key} -> {entry} ({total:.4f} ms over M = {ms_in})")
            del xs
    return table


def model_linear_shapes(decoder_config) -> list:
    """The distinct quantized-linear (N, K) shapes of a model (qkv/out/
    up/down per layer + readout)."""
    from ...config.model import AttentionConfig, DenseMLPConfig

    shapes = set()
    cfg = decoder_config
    tcfg = cfg.transformer_config
    d = tcfg.model_dim
    for lc in tcfg.layer_configs:
        m = lc.mixer_config
        if isinstance(m, AttentionConfig):
            q_dim = m.num_heads * m.head_dim
            kv = m.num_groups * m.head_dim
            shapes.add((q_dim + 2 * kv, d))
            shapes.add((d, q_dim))
        if isinstance(lc.mlp_config, DenseMLPConfig):
            hid = lc.hidden_dim or tcfg.hidden_dim
            shapes.add((2 * hid, d))
            shapes.add((d, hid))
    shapes.add((cfg.vocab_size, d))
    return sorted(shapes)


def validate_e2e(model_dir: str, *, max_context: int = 1024, steps: int = 96,
                 rounds: int = 5, verbose: bool = True, lm=None) -> dict:
    """A/B the measured table against the built-in heuristics on the decode
    loop, in interleaved rounds on one model (the plan reads the table at
    each launch, so switching the table switches every launch after it):
    the median of each policy's ms/token and of the per-round differences.
    Does not modify the table. `lm` reuses a loaded model."""
    import time

    import numpy as np

    from ...engine.engine import LanguageModel

    if lm is None:
        lm = LanguageModel.from_dir(model_dir, max_context=max_context,
                                    prefill_buckets=(64,))
    prompt = (np.arange(48, dtype=np.int32) * 13) % 128
    prior = os.environ.get("UZU_TPU_TILE_TABLE")

    def policy(table_off: bool) -> None:
        if table_off:
            os.environ["UZU_TPU_TILE_TABLE"] = os.devnull
        elif prior is not None:
            os.environ["UZU_TPU_TILE_TABLE"] = prior
        else:
            os.environ.pop("UZU_TPU_TILE_TABLE", None)
        _load_table.cache_clear()

    times: dict = {"heuristic": [], "table": []}
    try:
        for name in times:  # warm each policy with the timed shape
            policy(name == "heuristic")
            lm.generate_list(prompt, steps, stop_token_ids=[])
        for _ in range(rounds):
            for name in times:
                policy(name == "heuristic")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lm.generate_list(prompt, steps, stop_token_ids=[])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / steps * 1e3)
    finally:
        policy(False)
    diffs = [h - t for h, t in zip(times["heuristic"], times["table"])]
    out = {
        "heuristic_ms": float(np.median(times["heuristic"])),
        "table_ms": float(np.median(times["table"])),
        "median_diff_ms": float(np.median(diffs)),
        "winner": "table" if float(np.median(diffs)) > 0 else "heuristic",
        "device": torch.cuda.get_device_name(),
    }
    if verbose:
        print(f"heuristic: {out['heuristic_ms']:.3f} ms/tok  "
              f"table: {out['table_ms']:.3f} ms/tok  "
              f"diff: {out['median_diff_ms']:+.3f} -> {out['winner']}")
    return out


def save_table(table: dict, path: str | None = None) -> str:
    """Merge `table` into the table file (default: this card's under
    TABLE_DIR) and drop the cached read."""
    if path is None:
        os.makedirs(TABLE_DIR, exist_ok=True)
        path = os.path.join(TABLE_DIR, f"{_device_key()}.json")
    existing = {}
    try:
        with open(path) as f:
            existing = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    existing.update(table)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    _load_table.cache_clear()
    return path
