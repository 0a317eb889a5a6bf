"""Deterministic structured synthetic corpus (byte-level tokens).

Counterpart of `uzu_tpu/tools/corpus.py`, a numpy copy: for the same seed
it gives the same text and tokens, so a quality measurement of the two
packages reads the same sequence. The corpus has real statistical
structure, where random weights and random tokens have none:

  - JSON records with Zipfian key-value pools (predictable structural
    bytes),
  - English-like template sentences over a Zipfian vocabulary with
    paragraph-level topic words (long-range reuse),
  - code-like assignment/call lines with variable reuse.

Byte-level tokenization (vocab 256) keeps the pipeline self-contained: no
tokenizer artifact, and perplexity is directly bits-per-byte comparable.
All text is ASCII. Generation is deterministic per seed.
`write_byte_tokenizer` writes the same files as the JAX module's (HF
`tokenizers`, as there).
"""

from __future__ import annotations

import json
import os

import numpy as np

_NOUNS = (
    "time year people way day man thing woman life child world school "
    "state family student group country problem hand part place case week "
    "company system program question work government number night point "
    "home water room mother area money story fact month lot right study "
    "book eye job word business issue side kind head house service friend "
    "father power hour game line end member law car city community name "
    "president team minute idea body information back parent face others "
    "level office door health person art war history party result change "
    "morning reason research girl guy moment air teacher force education"
).split()
_VERBS = (
    "makes takes sees gets finds gives tells asks works seems feels "
    "leaves calls moves plays runs holds brings writes sits stands loses "
    "pays meets includes continues sets learns changes leads understands "
    "watches follows stops creates speaks reads spends grows opens walks "
    "wins offers remembers loves considers appears buys waits serves sends"
).split()
_ADJS = (
    "new first last long great little own other old right big high "
    "different small large next early young important few public bad same "
    "able free sure better true whole clear recent strong certain quiet "
    "late warm cold deep dark bright heavy light narrow broad calm"
).split()
_NAMES = (
    "alice bob carol dave erin frank grace heidi ivan judy kevin laura "
    "mallory nina oscar peggy quentin rachel steve trent ursula victor "
    "wendy xavier yvonne zach amber brian chloe derek elena felix gina "
    "harold iris jack kara liam mona noah opal paulo quinn rosa sam tara"
).split()
_CITIES = (
    "springfield rivertown lakeside hillview oakdale maplewood cedarburg "
    "brookfield fairview greenfield kingston ashland milton dover bristol "
    "clayton harmony florence aurora geneva"
).split()
_TAGS = (
    "alpha beta gamma delta prod staging test legacy core edge fast slow "
    "hot cold active archived public private draft final"
).split()
_TEMPLATES = (
    "the {a} {n} {v} the {n} near {c}. ",
    "a {a} {n} {v} a {a} {n}. ",
    "in {c} the {n} {v} the {a} {n}. ",
    "every {n} {v} the {n} because the {a} {n} {v} it. ",
    "the {n} of {p} {v} a {a} {n} in {c}. ",
)


def _zipf_weights(n: int, a: float = 1.25) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


class _Pools:
    def __init__(self):
        self.pools = {
            "n": (_NOUNS, _zipf_weights(len(_NOUNS))),
            "v": (_VERBS, _zipf_weights(len(_VERBS))),
            "a": (_ADJS, _zipf_weights(len(_ADJS))),
            "p": (_NAMES, _zipf_weights(len(_NAMES))),
            "c": (_CITIES, _zipf_weights(len(_CITIES))),
            "t": (_TAGS, _zipf_weights(len(_TAGS))),
        }

    def pick(self, rng, key):
        pool, w = self.pools[key]
        return pool[rng.choice(len(pool), p=w)]


_POOLS = _Pools()


def _paragraph(rng) -> str:
    # topic words drawn once per paragraph and reused: long-range structure
    topic_n = _POOLS.pick(rng, "n")
    topic_c = _POOLS.pick(rng, "c")
    out = []
    for _ in range(int(rng.integers(3, 7))):
        t = _TEMPLATES[int(rng.integers(0, len(_TEMPLATES)))]
        fills = {
            "a": _POOLS.pick(rng, "a"),
            "v": _POOLS.pick(rng, "v"),
            "p": _POOLS.pick(rng, "p"),
            # topic reuse ~60% of noun/city slots
            "n": topic_n if rng.random() < 0.6 else _POOLS.pick(rng, "n"),
            "c": topic_c if rng.random() < 0.6 else _POOLS.pick(rng, "c"),
        }
        out.append(t.format(**fills))
    return "".join(out) + "\n"


def _json_record(rng) -> str:
    rec = {
        "name": _POOLS.pick(rng, "p"),
        "age": int(rng.integers(18, 80)),
        "city": _POOLS.pick(rng, "c"),
        "active": bool(rng.random() < 0.7),
        "tags": [_POOLS.pick(rng, "t")
                 for _ in range(int(rng.integers(1, 4)))],
        "score": round(float(rng.random()) * 10, 1),
    }
    return json.dumps(rec) + "\n"


def _code_block(rng) -> str:
    env = []
    lines = []
    fns = ("foo", "bar", "baz", "norm", "scale", "merge")
    fw = _zipf_weights(len(fns))
    for i in range(int(rng.integers(3, 8))):
        var = f"x{len(env)}"
        if env and rng.random() < 0.7:
            a = env[int(rng.integers(0, len(env)))]
            b = (env[int(rng.integers(0, len(env)))]
                 if rng.random() < 0.5 else str(int(rng.integers(0, 100))))
            fn = fns[rng.choice(len(fns), p=fw)]
            lines.append(f"{var} = {fn}({a}, {b})\n")
        else:
            lines.append(f"{var} = {int(rng.integers(0, 1000))}\n")
        env.append(var)
    if env:
        lines.append(f"return {env[-1]}\n")
    return "".join(lines) + "\n"


def generate_text(n_bytes: int, seed: int = 0) -> str:
    """Deterministic corpus of at least `n_bytes` ASCII bytes."""
    rng = np.random.default_rng(seed)
    out: list[str] = []
    size = 0
    while size < n_bytes:
        r = rng.random()
        block = (_json_record(rng) if r < 0.4
                 else _paragraph(rng) if r < 0.8
                 else _code_block(rng))
        out.append(block)
        size += len(block)
    return "".join(out)[:n_bytes]


# bump when generate_text's rules change: the disk cache key includes it,
# so a stale corpus can never outlive its generator
_GEN_VERSION = 1


def generate_tokens(n_tokens: int, seed: int = 0) -> np.ndarray:
    """Byte-level token ids [n_tokens] int32.

    Corpora of a million tokens or more are cached under .bench_cache in
    the checkout (the JAX package's file names and contents): generation
    is pure Python and slow at that size."""
    cache = None
    if n_tokens >= 1_000_000:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cache = os.path.join(root, ".bench_cache",
                             f"corpus_v{_GEN_VERSION}_{n_tokens}_{seed}.npy")
        if os.path.exists(cache):
            toks = np.load(cache)
            if len(toks) == n_tokens:
                return toks.astype(np.int32)
    text = generate_text(n_tokens, seed)
    toks = np.frombuffer(text.encode("ascii"), np.uint8).astype(np.int32)
    if cache is not None:
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = cache + f".tmp{os.getpid()}.npy"
            np.save(tmp, toks)
            os.replace(tmp, cache)
        except OSError:
            pass
    return toks


def heldout_prompts(k: int = 8, length: int = 64, seed: int = 9999) -> list:
    """Prompt token lists from a held-out seed (never used in training)."""
    toks = generate_tokens(k * (length + 1) + 64, seed)
    return [toks[i * length:(i + 1) * length].tolist() for i in range(k)]


def record_schema() -> dict:
    """JSON schema of the corpus's record blocks (_json_record), for a
    grammar that constrains a byte-trained model to its own records."""
    return {
        "type": "object",
        "properties": {
            "name": {"enum": list(_NAMES)},
            "age": {"type": "integer", "minimum": 18, "maximum": 79},
            "city": {"enum": list(_CITIES)},
            "active": {"type": "boolean"},
            "tags": {"type": "array", "items": {"enum": list(_TAGS)},
                     "maxItems": 3},
            "score": {"type": "number", "minimum": 0, "maximum": 10},
        },
        "required": ["name", "age", "city", "active", "tags", "score"],
    }


def write_byte_tokenizer(out_dir: str) -> str:
    """Identity byte-level tokenizer artifact (token id i == byte i) for
    byte-trained models: gives the sessions/grammar layers a Tokenizer
    over the model's native vocabulary. Uses the ByteLevel byte<->unicode
    convention so encode/decode round-trip exactly."""
    import json
    import os

    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers import decoders, models, pre_tokenizers

    # the GPT-2 bytes-to-unicode table (what ByteLevel pre/decoders use)
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte2char = {b: chr(c) for b, c in zip(bs, cs)}
    vocab = {byte2char[i]: i for i in range(256)}
    tok = HFTokenizer(models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    os.makedirs(out_dir, exist_ok=True)
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({}, f)
    return out_dir
