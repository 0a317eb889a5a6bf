"""Per-kernel micro baselines.

Counterpart of `uzu_tpu/tools/microbench.py`: the kernel groups that the
decode-step, prefill-chunk and GEMV probes do not cover (decode attention
reads, paged attention, the MoE block in decode and in a prefill chunk,
the sampling pipeline), each as ms per call at the JAX package's shapes,
so that a regression in any one of them shows between runs.

Timing rule (`scan_diff_ms`): a probe runs its call in a Python loop at
two loop lengths and divides the difference of the two times by the
difference of the lengths, so that what each run pays once (the first
launch, the final synchronization) cancels. On a card each loop is timed
with CUDA events, on the CPU with `time.perf_counter` (the CPU runs each
op to its end before the next). The port runs eagerly, so a call's time
is the larger of its host dispatch and its device time; at decode widths
that is usually the host. A probe that fails raises, and so does one
whose differential is not positive (it sits below the timer's noise):
no number is reported rather than a wrong one.

    python -m uzu_tpu_torch.tools.microbench MODEL_DIR [--device cpu]
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def _loop(fn, args, xs):
    acc = None
    for x in xs:
        y = fn(args, x)
        acc = y if acc is None else acc + y
    return acc


def _elapsed_ms(device: torch.device, run) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    run()
    return (time.perf_counter() - t0) * 1e3


def scan_diff_ms(fn, args, make_xs, k_small: int = 16, k_big: int = 80,
                 pairs: int = 5) -> float:
    """ms per fn(args, x) call, differential between a loop over
    make_xs(k_big) and one over make_xs(k_small) (the median of `pairs`
    interleaved pairs). `fn` returns a tensor, summed across the loop; its
    device picks the clock."""
    xs_s, xs_b = make_xs(k_small), make_xs(k_big)
    device = _loop(fn, args, xs_s).device  # warm both lengths
    _loop(fn, args, xs_b)
    if device.type == "cuda":
        torch.cuda.synchronize()
    diffs = [
        _elapsed_ms(device, lambda: _loop(fn, args, xs_b))
        - _elapsed_ms(device, lambda: _loop(fn, args, xs_s))
        for _ in range(pairs)
    ]
    ms = statistics.median(diffs) / (k_big - k_small)
    if not ms > 0:
        raise RuntimeError(f"differential time {ms:.3e} ms per call is not positive: "
                           f"the probe is below the timer's noise at {k_big} calls")
    return ms


def _attention_geometry(lm):
    from ..config.model import AttentionConfig

    mc = next(lc.mixer_config
              for lc in lm.decoder_config.transformer_config.layer_configs
              if isinstance(lc.mixer_config, AttentionConfig))
    return mc.num_heads, mc.num_groups, mc.head_dim


def attention_micro(lm, ctx: int = 512) -> float:
    """Single-stream decode attention read at context `ctx` on the model's
    head geometry, through the port's `attention_reference` as the decode
    step calls it (one query row)."""
    from ..ops.attention import attention_reference

    h, g, dh = _attention_geometry(lm)
    dev = lm.device
    rng = np.random.default_rng(0)
    k_cache = torch.from_numpy(rng.standard_normal((ctx, g, dh))).to(dev, torch.bfloat16)
    v_cache = torch.from_numpy(rng.standard_normal((ctx, g, dh))).to(dev, torch.bfloat16)
    pos = torch.tensor([ctx - 1], dtype=torch.int32, device=dev)

    def one(args, q):
        kc, vc = args
        out = attention_reference(q, kc, vc, pos, scale=dh ** -0.5)
        return out.float().sum()

    def make_xs(k):
        return torch.from_numpy(rng.standard_normal((k, 1, h, dh))).to(dev, torch.bfloat16)

    # one read of a 512-slot cache is a few microseconds on the card: 4096
    # extra calls lift the differential well above the timer's noise
    return scan_diff_ms(one, (k_cache, v_cache), make_xs, k_small=64, k_big=4160, pairs=7)


def paged_attention_micro(lm, *, bsz: int = 8, pages: int = 128,
                          page: int = 64, ctx: int = 512) -> float:
    """Paged decode attention at B=`bsz`, C=`ctx`: K5 on the card, its
    plain version on the CPU."""
    from ..ops.cuda.paged_attention import paged_decode_attention

    h, g, dh = _attention_geometry(lm)
    dev = lm.device
    rng = np.random.default_rng(1)
    k_pool = torch.from_numpy(rng.standard_normal((g, pages, page, dh))).to(dev, torch.bfloat16)
    v_pool = torch.from_numpy(rng.standard_normal((g, pages, page, dh))).to(dev, torch.bfloat16)
    per = ctx // page
    table = torch.from_numpy((np.arange(bsz * per) % pages).reshape(bsz, per)).to(
        dev, torch.int32)
    lengths = torch.full((bsz,), ctx, dtype=torch.int32, device=dev)

    def one(args, q):
        kp, vp, tb, ln = args
        return paged_decode_attention(q, kp, vp, tb, ln, scale=dh ** -0.5).sum()

    def make_xs(k):
        return torch.from_numpy(rng.standard_normal((k, bsz, h, dh))).to(dev, torch.bfloat16)

    return scan_diff_ms(one, (k_pool, v_pool, table, lengths), make_xs)


def _moe_probe_setup(d=1024, dff=1408, e=16, k_active=4, vocabless_seed=2, device=None):
    """A gpt-oss-small-shaped MoE block (the JAX probe's): D 1024, dff 1408,
    16 experts of which 4 are active, dense bf16 expert stacks (~140 MB,
    the stream that dominates MoE serving)."""
    from ..config.model import (
        DenseMLPConfig,
        LinearConfig,
        MixtureOfExpertsConfig,
        SiLU,
        SoftmaxRouting,
    )

    cfg = MixtureOfExpertsConfig(
        expert_config=DenseMLPConfig(
            linear_config=LinearConfig(), activation=SiLU(alpha=1.0),
            has_up_biases=False, has_down_biases=False,
            gate_clipping=None, up_clipping=None),
        router_config=LinearConfig(),
        routing_function=SoftmaxRouting(),
        num_routed_experts=e, num_active_routed_experts=k_active,
        router_has_biases=False, num_shared_experts=0,
        expert_hidden_dim=dff, gate_config=None)
    rng = np.random.default_rng(vocabless_seed)
    scale = 0.02

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(device, dtype)

    params = {
        "router": {"w": t((e, d), torch.float32)},
        "up": {"w": t((e, 2 * dff, d), torch.bfloat16)},
        "down": {"w": t((e, d, dff), torch.bfloat16)},
    }
    return cfg, params, d


def moe_micro(s: int, device=None) -> float:
    """The MoE block at S=`s` rows. The probe's dense bf16 stacks take the
    port's routing table as the JAX package's do: S=1 the gather path, S=256
    the masked loop, both plain ops (no expert kernel serves a dense stack
    below GROUPED_PATH_MIN_TOKENS)."""
    from ..models.moe import moe_forward
    from ..runtime import resolve_device

    dev = resolve_device(device)
    cfg, params, d = _moe_probe_setup(device=dev)
    rng = np.random.default_rng(3)

    def one(args, x):
        return moe_forward(cfg, args, x).float().sum()

    def make_xs(k):
        return torch.from_numpy(rng.standard_normal((k, s, d))).to(dev, torch.bfloat16)

    # prefill probes move k x s x D inputs; keep the loop shorter
    kk = (16, 80) if s == 1 else (4, 20)
    return scan_diff_ms(one, params, make_xs, k_small=kk[0], k_big=kk[1])


def sampling_micro(vocab: int = 128256, device=None) -> float:
    """The full sampling pipeline (temperature, top-k, top-p) on one [V]
    logits row."""
    from ..engine.sampling import SamplingParams, sample
    from ..runtime import resolve_device

    dev = resolve_device(device)
    params = SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((rng.standard_normal(vocab) * 3).astype(np.float32)).to(dev)

    def one(args, gen):
        return sample(args, params, generator=gen).float()

    def make_xs(k):
        return [torch.Generator(device=dev).manual_seed(7 + i) for i in range(k)]

    return scan_diff_ms(one, logits, make_xs)


def kernel_micros(lm) -> dict:
    """Every per-kernel baseline, as a flat {name: ms} dict, on the
    model's device. A probe that fails raises."""
    dev = lm.device
    probes = {
        "attention_c512_ms": lambda: attention_micro(lm),
        "paged_attn_b8_c512_ms": lambda: paged_attention_micro(lm),
        "moe_decode_ms": lambda: moe_micro(1, dev),
        "moe_prefill256_ms": lambda: moe_micro(256, dev),
        "sample_topk_ms": lambda: sampling_micro(device=dev),
    }
    return {name: probe() for name, probe in probes.items()}


def main(argv=None) -> dict:
    import argparse
    import json

    from ..engine.engine import LanguageModel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model_dir")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    lm = LanguageModel.from_dir(args.model_dir, device=args.device, max_context=1024,
                                prefill_buckets=(32,))
    out = kernel_micros(lm)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
