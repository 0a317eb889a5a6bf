"""ChatSession: template rendering + prefix-cached generation + tool loop.

Role parity: crates/nagare/src/chat/mod.rs (ChatSession, tool-turn loop with
DEFAULT_TOOL_TURN_LIMIT=10 at mod.rs:39) and chat/token.rs (token::Session
with longest-prefix KV reuse, token.rs:158-176; ChatReplyStats rate math,
token.rs:377-436).

The session keeps the decoding state plus the token log it covers; a new
turn re-renders the whole conversation and prefills only the suffix that
extends the log (KV/recurrent state for the shared prefix is reused). A
render that does not extend the log resets the state (same policy as the
reference).

The port's copy of `uzu_tpu/sessions/chat.py`, over the port's engine
(`generate_resumable`, the speculative decoders, `grammar/decode.py`).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np

from ..engine.engine import LanguageModel, StreamMetrics
from ..engine.sampling import SamplingParams
from .parser import Event, SectionConfig, StreamParser, ToolCall
from .template import ChatTemplate, ToolSpec
from .tokenizer import StreamDecoder, Tokenizer

DEFAULT_TOOL_TURN_LIMIT = 10


@dataclasses.dataclass
class ChatReplyStats:
    """Parity with nagare ChatReplyStats (token.rs:377-436)."""

    time_to_first_token: float = 0.0
    prefill_tokens_per_second: float = 0.0
    generate_tokens_per_second: float = 0.0
    tokens_count_input: int = 0
    tokens_count_output: int = 0
    # speculation effectiveness (TokenStreamMetrics proposed/accepted)
    tokens_proposed: int = 0
    tokens_accepted: int = 0


@dataclasses.dataclass
class ChatReply:
    text: str
    reasoning: str
    tool_calls: list[ToolCall]
    finish_reason: str  # "stop" | "length" | "tool_calls"
    stats: ChatReplyStats
    # per-token (logprob, [(alt_id, alt_logprob), ...]) when requested
    logprob_content: list = dataclasses.field(default_factory=list)
    # raw generated token ids (aligned with logprob_content entries)
    tokens: list = dataclasses.field(default_factory=list)


class ChatSession:
    def __init__(
        self,
        model: LanguageModel,
        tokenizer: Tokenizer,
        *,
        template: str | None = None,
        sections: list[SectionConfig] | None = None,
        tools: list[ToolSpec] | None = None,
        tool_turn_limit: int = DEFAULT_TOOL_TURN_LIMIT,
        encoding: str = "auto",
        speculator=None,
    ):
        """`speculator`: a proposer (object with .propose(history), e.g.
        NgramSpeculator / DraftModelSpeculator — wrapped in a chain
        SpeculativeDecoder per sampling config), a ready decoder (object
        with .generate, e.g. DFlashSpeculativeDecoder), or one of the
        zero-artifact strings:

        - "self": per-round self-speculation (layer-truncated self-draft);
        - "fused-self": fused multi-round self-speculation
          (engine/fused_spec.py — R rounds per dispatch, the single-stream
          config that amortizes the dispatch tax);
        - "fused-ngram": fused multi-round prompt-lookup (the device
          n-gram matcher proposes continuations of the history in-scan —
          zero draft compute, best on repetitive/structured output).

        The reference engages a model's bundled speculator in every stream
        the same way (stream.rs:553-578). Grammar-constrained turns need
        host-side masks, so string speculators downgrade there to a
        per-round self-draft proposer (lookahead masks still ride the
        chain drafts)."""
        self.model = model
        self.tokenizer = tokenizer
        if encoding == "auto" and sections is None:
            # per-model stream-parsing config shipped IN the model dir (the
            # reference resolves a bundled per-family parsing config the
            # same way — hanashi/configs/parsing/*.json); new families need
            # a JSON file, not code
            from .parser import load_parser_config

            pcfg = load_parser_config(getattr(tokenizer, "model_dir", ""))
            if pcfg is not None:
                if pcfg.get("preset") == "harmony":
                    encoding = "harmony"
                else:
                    from .parser import sections_from_config

                    sections = sections_from_config(pcfg.get("sections", []))
                    transform = None
                    tcfg = pcfg.get("transformation")
                    if tcfg:
                        from .transform import TransformSchema

                        transform = (TransformSchema.from_json(tcfg["schema"]),
                                     tcfg["pipeline"])
                    self._cfg_transform = transform
        if encoding == "harmony":
            from .harmony import HarmonyEncoding, HarmonyParser

            self.template = HarmonyEncoding()
            self._parser_factory = HarmonyParser
        else:
            self.template = ChatTemplate(
                template if template is not None else tokenizer.chat_template
            )
            self._parser_factory = lambda: StreamParser(
                self.sections, transform=getattr(self, "_cfg_transform", None))
        self.sections = sections
        self.tools = {t.name: t for t in (tools or [])}
        self.tool_turn_limit = tool_turn_limit
        self.messages: list[dict] = []
        self._state = None
        self._state_tokens: list[int] = []
        if isinstance(speculator, str):
            if speculator not in ("self", "fused-self", "fused-ngram"):
                raise ValueError(
                    f"unknown speculator {speculator!r} "
                    "(use 'self'/'fused-self'/'fused-ngram')")
            from ..engine.speculation import speculation_supported

            # fail at construction, not mid-reply inside the stream
            if not speculation_supported(model.decoder_config):
                raise ValueError(
                    "chain speculation unsupported for this model "
                    "(KV-shared attention)")
        self.speculator = speculator
        self._spec_decoders: dict = {}
        self._str_proposer = None  # grammar-turn proposer for string modes

    # -- state / prefix cache ---------------------------------------------

    def reset(self) -> None:
        self._state = None
        self._state_tokens = []
        self.messages = []

    def _stop_ids(self) -> list[int]:
        ids = list(self.model.config.generation_config.stop_token_ids)
        for i in self.tokenizer.eos_token_ids:
            if i not in ids:
                ids.append(i)
        # harmony turns end at <|return|> (final) or <|call|> (tool call),
        # not the model's eos (hanashi harmony mod.rs stop set)
        from .harmony import HARMONY_STOP_TOKENS, HarmonyEncoding

        if isinstance(self.template, HarmonyEncoding):
            for tok_text in HARMONY_STOP_TOKENS:
                i = self.tokenizer.token_to_id(tok_text)
                if i is not None and i not in ids:
                    ids.append(i)
        return ids

    def _render_tokens(self, messages: list[dict],
                       extra_tools: list[dict] | None = None) -> list[int]:
        """extra_tools: per-turn OpenAI tool-spec dicts (request-level tools,
        reference chat_completions.rs:203) rendered alongside the session's
        own bound tools."""
        tools = [t.spec() for t in self.tools.values()] + list(extra_tools or [])
        text = self.template.render(messages, tools=tools or None)
        return self.tokenizer.encode(text)

    # -- generation ----------------------------------------------------------

    def stream(
        self,
        message: str | dict | list[dict],
        *,
        sampling: SamplingParams | None = None,
        max_new_tokens: int = 512,
        seed: int = 0,
        grammar=None,
        tools: list[dict] | None = None,
        stop_strings: list[str] | None = None,
        logprobs: int = 0,
        _internal_messages: list[dict] | None = None,
    ) -> Iterator[Event]:
        """Yields parse events; final ChatReply available as .last_reply.

        `grammar`: a grammar.GrammarSession constraining this turn's output
        (the reference applies its xgrammar bitmask inside session streams
        the same way, stream.rs:632-675). Constrained turns run through the
        grammar loop — with the session speculator's chain drafts when it
        is a proposer — and re-prefill the full prompt (the grammar loop
        does not hand its state back for prefix caching).

        `stop_strings` (OpenAI ``stop``): generation halts at the first
        occurrence of any sequence in the RAW decoded text, truncated
        exactly before it (char-level, via a holdback scanner); the reply
        finishes with reason "stop". Stop-string turns skip prefix caching
        (generation breaks mid-stream, so the final state is unknown)."""
        if _internal_messages is None:
            if isinstance(message, str):
                self.messages.append({"role": "user", "content": message})
            elif isinstance(message, dict):
                self.messages.append(message)
            else:
                self.messages.extend(message)
        tokens = self._render_tokens(self.messages, tools)

        # longest-prefix reuse (token.rs:158-176): reuse iff the new render
        # extends the tokens already inside the state
        n_covered = len(self._state_tokens)
        if self._state is not None and tokens[:n_covered] == self._state_tokens:
            suffix = tokens[n_covered:]
        else:
            self._state = None
            self._state_tokens = []
            suffix = tokens
        if not suffix:
            # renders can be idempotent across turns; always feed >=1 token
            suffix = tokens[-1:]
            self._state_tokens = tokens[:-1]

        metrics = StreamMetrics()
        decoder = StreamDecoder(self.tokenizer)
        parser = self._parser_factory()
        stop_ids = self._stop_ids()
        generated: list[int] = []
        sampling = sampling or SamplingParams.from_generation_config(
            self.model.config.generation_config
        )
        mon = None
        if stop_strings:
            from .parser import StopStrings

            mon = StopStrings(stop_strings)
        stopped_on_string = False
        if logprobs and (grammar is not None or self.speculator is not None):
            raise ValueError(
                "logprobs is unsupported with grammar or speculative "
                "decoding in the single-stream session")

        spec_metrics = None
        if grammar is not None:
            import time as _time

            from ..engine.speculation import speculation_supported
            from ..grammar.decode import constrained_generate

            spec = self.speculator
            if isinstance(spec, str) and speculation_supported(
                    self.model.decoder_config):
                # grammar masks are host-side: downgrade string modes to a
                # host PROPOSER so lookahead masks still ride the chain
                # drafts (the measured grammar-speculation win, BASELINE
                # grammar_spec_real): the ngram mode keeps its zero-draft-
                # compute character via the host NgramSpeculator; the self
                # modes use a half-stack self-draft (needing >= 2 layers —
                # a 1-layer "draft" would be the full model)
                if self._str_proposer is None:
                    from ..engine.speculation import (
                        DraftModelSpeculator,
                        NgramSpeculator,
                        self_draft_model,
                    )

                    n = len(self.model.decoder_config
                            .transformer_config.layer_configs)
                    if self.speculator == "fused-ngram" or n < 2:
                        self._str_proposer = NgramSpeculator(
                            max_ngram=3, k=8)
                    else:
                        self._str_proposer = DraftModelSpeculator(
                            self_draft_model(self.model, n // 2), k=4)
                spec = self._str_proposer
            if not (hasattr(spec, "propose")
                    and speculation_supported(self.model.decoder_config)):
                spec = None  # ready decoders (DFlash) have no mask hook
            if spec is not None:
                from ..engine.speculation import SpeculationMetrics

                spec_metrics = SpeculationMetrics()
            gen = constrained_generate(
                self.model, np.asarray(tokens, np.int32), max_new_tokens,
                grammar, sampling=sampling, stop_token_ids=stop_ids,
                seed=seed, speculator=spec, metrics=spec_metrics,
            )
            t0 = _time.perf_counter()
            stopped_on_string = yield from self._drain_tokens(
                gen, decoder, parser, generated, mon)
            metrics.decode_seconds = _time.perf_counter() - t0
            yield from parser.finish()
            self._state = None
            self._state_tokens = []
            metrics.num_tokens_generated = len(generated)
        elif self.speculator is not None:
            import time as _time

            from ..engine.speculation import SpeculationMetrics

            spec_metrics = SpeculationMetrics()
            gen = self._spec_generate(
                tokens, suffix, max_new_tokens, sampling, stop_ids, seed,
                spec_metrics,
            )
            t0 = _time.perf_counter()
            stopped_on_string = yield from self._drain_tokens(
                gen, decoder, parser, generated, mon)
            decode_s = _time.perf_counter() - t0
            yield from parser.finish()
            final_state = None if stopped_on_string else getattr(gen, "state", None)
            if final_state is not None:
                self._state = final_state
                self._state_tokens = list(tokens) + generated[:-1]
            else:
                self._state = None
                self._state_tokens = []
            metrics.num_tokens_generated = len(generated)
            metrics.decode_seconds = decode_s
        else:
            gen = self.model.generate_resumable(
                state=self._state,
                prompt_tokens=np.asarray(suffix, np.int32),
                max_new_tokens=max_new_tokens,
                sampling=sampling,
                stop_token_ids=stop_ids,
                seed=seed,
                metrics=metrics,
                logprobs=logprobs,
            )
            stopped_on_string = yield from self._drain_tokens(
                gen, decoder, parser, generated, mon)
            yield from parser.finish()
            if stopped_on_string:
                self._state = None
                self._state_tokens = []
            else:
                self._state = gen.state
                self._state_tokens = list(tokens) + generated[:-1]

        finish = "stop" if generated and generated[-1] in stop_ids else "length"
        if stopped_on_string:
            finish = "stop"
        if parser.tool_calls:
            finish = "tool_calls"
        stats = ChatReplyStats(
            time_to_first_token=metrics.prefill_seconds,
            prefill_tokens_per_second=metrics.prefill_tokens_per_second,
            generate_tokens_per_second=metrics.decode_tokens_per_second,
            tokens_count_input=len(tokens),
            tokens_count_output=len(generated),
            tokens_proposed=spec_metrics.num_tokens_proposed if spec_metrics else 0,
            tokens_accepted=spec_metrics.num_tokens_accepted if spec_metrics else 0,
        )
        self.last_reply = ChatReply(
            text=parser.text,
            reasoning=parser.reasoning,
            tool_calls=parser.tool_calls,
            finish_reason=finish,
            stats=stats,
            logprob_content=list(getattr(gen, "logprob_content", ())),
            tokens=list(generated),
        )

    @staticmethod
    def _drain_tokens(gen, decoder, parser, generated, mon):
        """Token -> text -> parse-event pipeline shared by the generation
        branches; returns True when a stop string halted the stream (the
        StopStrings holdback guarantees nothing past the match was pushed)."""
        for tok in gen:
            generated.append(tok)
            delta = decoder.push(tok)
            if not delta:
                continue
            if mon is None:
                yield from parser.push(delta)
                continue
            release, hit = mon.push(delta)
            if release:
                yield from parser.push(release)
            if hit:
                return True
        if mon is not None:
            tail = mon.finish()
            if tail:
                yield from parser.push(tail)
        return False

    def _spec_generate(self, tokens, suffix, max_new_tokens, sampling,
                       stop_ids, seed, spec_metrics):
        if isinstance(self.speculator, str):
            if sampling not in self._spec_decoders:
                from ..engine.fused_spec import fused_self_speculative_decoder
                from ..engine.speculation import self_speculative_decoder

                if self.speculator == "fused-ngram":
                    from ..engine.fused_spec import FusedSpeculativeDecoder

                    self._spec_decoders[sampling] = FusedSpeculativeDecoder(
                        self.model, ngram=True, k=8, sampling=sampling)
                else:
                    maker = {"self": self_speculative_decoder,
                             "fused-self": fused_self_speculative_decoder}
                    self._spec_decoders[sampling] = maker[self.speculator](
                        self.model, sampling=sampling)
            return self._spec_decoders[sampling].generate(
                np.asarray(suffix, np.int32), max_new_tokens,
                stop_token_ids=stop_ids, seed=seed, metrics=spec_metrics,
                state=self._state, history_tokens=tokens,
            )
        if hasattr(self.speculator, "generate"):
            # ready decoder (DFlash): full-prompt generation, no prefix cache
            return self.speculator.generate(
                np.asarray(tokens, np.int32), max_new_tokens,
                stop_token_ids=stop_ids, seed=seed, metrics=spec_metrics,
            )
        from ..engine.speculation import SpeculativeDecoder

        if sampling not in self._spec_decoders:
            self._spec_decoders[sampling] = SpeculativeDecoder(
                self.model, self.speculator, sampling=sampling
            )
        return self._spec_decoders[sampling].generate(
            np.asarray(suffix, np.int32), max_new_tokens,
            stop_token_ids=stop_ids, seed=seed, metrics=spec_metrics,
            state=self._state, history_tokens=tokens,
        )

    def reply(
        self,
        message: str | dict | list[dict],
        *,
        sampling: SamplingParams | None = None,
        max_new_tokens: int = 512,
        seed: int = 0,
        grammar=None,
        tools: list[dict] | None = None,
        stop_strings: list[str] | None = None,
        logprobs: int = 0,
    ) -> ChatReply:
        """Full reply with the tool-call agent loop (nagare mod.rs:347-400).
        A grammar constrains the model's direct output, which in practice
        precludes tool-call markup — the loop simply never engages. `tools`
        are per-turn request-level declarations (no bound callables): calls
        to them come back in the reply rather than running the loop."""
        for _ in self.stream(
            message, sampling=sampling, max_new_tokens=max_new_tokens,
            seed=seed, grammar=grammar, tools=tools, stop_strings=stop_strings,
            logprobs=logprobs,
        ):
            pass
        reply = self.last_reply
        turns = 0
        while reply.finish_reason == "tool_calls" and self.tools and turns < self.tool_turn_limit:
            turns += 1
            calls = [
                tc.as_openai(f"call_{turns}_{i}") for i, tc in enumerate(reply.tool_calls)
            ]
            self.messages.append(
                {"role": "assistant", "content": reply.text or None, "tool_calls": calls}
            )
            for call, tc in zip(calls, reply.tool_calls):
                result = self._run_tool(tc)
                self.messages.append(
                    {
                        "role": "tool",
                        "tool_call_id": call["id"],
                        "content": result,
                    }
                )
            for _ in self.stream(
                None, sampling=sampling, max_new_tokens=max_new_tokens, seed=seed,
                _internal_messages=self.messages,
            ):
                pass
            reply = self.last_reply
        if reply.finish_reason != "tool_calls":
            self.messages.append({"role": "assistant", "content": reply.text})
        return reply

    def _run_tool(self, tc: ToolCall) -> str:
        tool = self.tools.get(tc.name)
        if tool is None or tool.fn is None:
            return json.dumps({"error": f"unknown tool {tc.name!r}"})
        try:
            result = tool.fn(**tc.arguments)
            return result if isinstance(result, str) else json.dumps(result)
        except Exception as e:
            return json.dumps({"error": str(e)})
