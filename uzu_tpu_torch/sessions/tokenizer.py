"""Tokenizer loading (HF tokenizer.json via the `tokenizers` crate bindings).

Role parity: crates/nagare/src/chat/token.rs:81-88 (load_tokenizer) and
crates/hanashi/src/util/tokenizer.rs. Special tokens come from
tokenizer_config.json (HF convention) with fallbacks from config.json's
generation stop ids.

The port's copy of `uzu_tpu/sessions/tokenizer.py` (HF `tokenizers`, as there).
"""

from __future__ import annotations

import json
import os
from functools import cached_property


class Tokenizer:
    def __init__(self, model_dir: str):
        from tokenizers import Tokenizer as HFTokenizer

        self.model_dir = model_dir
        self._tok = HFTokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        self.config = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                self.config = json.load(f)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> int | None:
        return self._tok.token_to_id(token)

    def id_to_token(self, token_id: int) -> str | None:
        return self._tok.id_to_token(token_id)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @cached_property
    def special_token_strings(self) -> set[str]:
        out = set()
        for tok in self.config.get("added_tokens_decoder", {}).values():
            if isinstance(tok, dict) and tok.get("special"):
                out.add(tok["content"])
        for key in ("bos_token", "eos_token", "pad_token", "unk_token"):
            v = self.config.get(key)
            if isinstance(v, dict):
                v = v.get("content")
            if v:
                out.add(v)
        return out

    def _named(self, key: str) -> str | None:
        v = self.config.get(key)
        if isinstance(v, dict):
            v = v.get("content")
        return v

    @cached_property
    def eos_token_ids(self) -> list[int]:
        out = []
        eos = self._named("eos_token")
        if eos is not None:
            i = self.token_to_id(eos)
            if i is not None:
                out.append(i)
        for extra in self.config.get("extra_eos_tokens", []):
            i = self.token_to_id(extra)
            if i is not None:
                out.append(i)
        return out

    @cached_property
    def chat_template(self) -> str | None:
        ct = self.config.get("chat_template")
        if ct is None:
            path = os.path.join(self.model_dir, "chat_template.jinja")
            if os.path.exists(path):
                with open(path) as f:
                    return f.read()
        if isinstance(ct, list):  # HF multi-template form
            for item in ct:
                if item.get("name") == "default":
                    return item.get("template")
            return ct[0].get("template") if ct else None
        return ct


class StreamDecoder:
    """Incremental detokenizer: feeds ids, emits text deltas only when the
    byte sequence is complete (no dangling UTF-8 / byte-level artifacts)."""

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self.tokenizer = tokenizer
        self.skip_special = skip_special_tokens
        self.ids: list[int] = []
        self.emitted = ""

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tokenizer.decode(self.ids, skip_special_tokens=self.skip_special)
        if text.endswith("�"):  # incomplete utf-8 sequence
            return ""
        delta = text[len(self.emitted) :]
        self.emitted = text
        return delta
