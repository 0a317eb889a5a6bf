"""The port's front door on the CPU: the engine facade and its registries,
downloads over file:// URLs, the CLI's subcommands with `--device cpu`,
the writers of tokenizers, chat models and classifiers (byte-identical to
the JAX package's), the speculator fallback (a malformed directory falls
back to plain decoding, any other error raises), and a fresh interpreter
that imports every front-end module and loads no JAX module."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from uzu_tpu.cli import main as jax_main
from uzu_tpu.tools import corpus as jcorpus
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch import Engine, LanguageModel, LocalRegistry, ModelInfo
from uzu_tpu_torch.cli import main
from uzu_tpu_torch.engine import dflash
from uzu_tpu_torch.engine.downloads import (
    Action,
    DirLock,
    LockError,
    download_file,
    download_model,
    file_crc32,
    manifest_for_dir,
    plan,
)
from uzu_tpu_torch.engine.registry import (
    CachedRegistry,
    FixedRegistry,
    MergedRegistry,
    RegistryError,
    Settings,
)
from uzu_tpu_torch.engine.speculation import DFlashSpeculativeDecoder
from uzu_tpu_torch.tools import corpus as pcorpus
from uzu_tpu_torch.tools import synth as psynth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "uzu_tpu")
TINY = dict(num_layers=2, model_dim=64, hidden_dim=160, num_heads=4, num_groups=2, head_dim=16)
FRONT_MODULES = (
    "uzu_tpu_torch", "uzu_tpu_torch.cli", "uzu_tpu_torch.server", "uzu_tpu_torch.server.common",
    "uzu_tpu_torch.server.openai", "uzu_tpu_torch.server.batched", "uzu_tpu_torch.sessions",
    "uzu_tpu_torch.sessions.chat", "uzu_tpu_torch.sessions.harmony",
    "uzu_tpu_torch.sessions.parser", "uzu_tpu_torch.sessions.template",
    "uzu_tpu_torch.sessions.tokenizer", "uzu_tpu_torch.sessions.transform",
    "uzu_tpu_torch.sessions.tts", "uzu_tpu_torch.models.classifier",
    "uzu_tpu_torch.engine.facade", "uzu_tpu_torch.engine.registry",
    "uzu_tpu_torch.engine.downloads", "uzu_tpu_torch.engine.remote",
    "uzu_tpu_torch.tools.synth", "uzu_tpu_torch.tools.corpus",
)


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("front_models")
    psynth.synth_chat_model(str(root / "chatty"), **TINY)
    psynth.synthesize(psynth.llama_config(num_layers=1, model_dim=32, hidden_dim=64,
                                          num_heads=2, num_groups=1, head_dim=16,
                                          vocab_size=128), str(root / "bare"), seed=2)
    psynth.synthesize_classifier(psynth.classifier_config(labels=["a", "b", "c"]),
                                 str(root / "clf"), seed=3)
    (root / "not_a_model").mkdir()
    return str(root)


def _same_files(a, b, names):
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


# -- writers --------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [300, 512])
def test_chat_model_and_tokenizer_files_are_byte_identical(tmp_path, vocab):
    want = jsynth.synth_chat_model(str(tmp_path / "j"), seed=4, vocab_size=vocab, **TINY)
    got = psynth.synth_chat_model(str(tmp_path / "p"), seed=4, vocab_size=vocab, **TINY)
    _same_files(want, got, ("config.json", "model.safetensors", "tokenizer.json",
                            "tokenizer_config.json"))
    assert psynth.SPECIAL_TOKENS == jsynth.SPECIAL_TOKENS
    assert psynth.SYNTH_CHAT_TEMPLATE == jsynth.SYNTH_CHAT_TEMPLATE


def test_byte_tokenizer_files_are_byte_identical(tmp_path):
    want = jcorpus.write_byte_tokenizer(str(tmp_path / "j"))
    got = pcorpus.write_byte_tokenizer(str(tmp_path / "p"))
    _same_files(want, got, ("tokenizer.json", "tokenizer_config.json"))
    from uzu_tpu_torch.sessions import Tokenizer

    tok = Tokenizer(got)
    text = pcorpus.generate_text(300, seed=1)
    assert tok.vocab_size == 256
    assert tok.encode(text) == list(text.encode())
    assert tok.decode(tok.encode(text)) == text


# -- facade and registries ------------------------------------------------------------


def test_engine_lists_and_loads_models_on_the_device_it_was_given(models_root):
    eng = Engine(models_root, device="cpu")
    models = {m.id: m for m in eng.models()}
    assert set(models) == {"chatty", "bare", "clf"}
    assert models["chatty"].chat_ready and not models["bare"].chat_ready
    assert models["clf"].kind == "classifier" and all(m.size_bytes > 0 for m in models.values())
    session = eng.chat("chatty", max_context=128)
    assert session.model.device == torch.device("cpu")
    assert session.reply("hello", max_new_tokens=6).stats.tokens_count_output > 0
    assert eng.language_model("bare", max_context=64) is eng.language_model("bare",
                                                                            max_context=64)
    out = eng.classification("clf").classify([1, 2, 3])
    assert set(out["probabilities"]) == {"a", "b", "c"}
    with pytest.raises(ValueError):
        eng.classification("chatty")
    with pytest.raises(ValueError):
        eng.language_model("clf")
    with pytest.raises(KeyError):
        eng.model("nonexistent")


def test_engine_defaults_to_the_card(models_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(models_root)


def test_download_needs_huggingface_hub(models_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub not available"):
        Engine(models_root, device="cpu").download("org/model")


def _info(name):
    return ModelInfo(id=name, path="/nowhere/" + name, kind="language", size_bytes=1,
                     has_tokenizer=False)


def test_registries_compose_cache_and_skip_failures(models_root, capsys):
    local = LocalRegistry(models_root)
    merged = MergedRegistry([local, FixedRegistry("fixture", [_info("remote-z")])])
    assert {m.id for m in merged.models()} == {"chatty", "bare", "clf", "remote-z"}
    with pytest.raises(RegistryError):
        merged.add(FixedRegistry("fixture", []))

    class Broken:
        identifier = "broken"

        def models(self):
            raise OSError("catalog unreachable")

    merged.add(Broken())
    assert "remote-z" in {m.id for m in merged.models()}
    assert "skipping 'broken'" in capsys.readouterr().err
    calls = []

    class Counting(FixedRegistry):
        def models(self):
            calls.append(1)
            return super().models()

    cached = CachedRegistry(Counting("c", [_info("x")]))
    assert cached.models() == cached.models() and len(calls) == 1
    cached.clear()
    cached.models()
    assert len(calls) == 2


def test_settings_roundtrip_and_secret_mode(tmp_path):
    s = Settings("uzu-test", config_dir=str(tmp_path))
    s.save("config", "theme", "dark")
    s.save("secret", "api_key", "sk-123")
    s2 = Settings("uzu-test", config_dir=str(tmp_path))
    assert (s2.load("config", "theme"), s2.load("secret", "api_key")) == ("dark", "sk-123")
    mode = os.stat(tmp_path / "uzu-test" / "secrets.json").st_mode
    assert mode & 0o077 == 0
    s2.save("secret", "api_key", None)
    assert s2.load("secret", "api_key") is None
    with pytest.raises(ValueError):
        s2.save("nope", "k", "v")


# -- downloads over file:// -----------------------------------------------------------


def test_file_url_download_resume_restart_and_lock(models_root, tmp_path):
    src = os.path.join(models_root, "chatty")
    files = manifest_for_dir(src)
    assert all(f.url.startswith("file://") for f in files)
    dest = str(tmp_path / "dest")
    os.makedirs(dest)
    [big] = [f for f in files if f.name == "model.safetensors"]
    with open(os.path.join(src, big.name), "rb") as f:
        prefix = f.read(big.size // 3)
    with open(os.path.join(dest, big.name + ".part"), "wb") as f:
        f.write(prefix)
    assert plan(big, dest) == Action("resume", offset=len(prefix))
    assert file_crc32(download_file(big, dest)) == big.crc32
    [cfg] = [f for f in files if f.name == "config.json"]
    with open(os.path.join(dest, cfg.name), "w") as f:
        f.write("stale")
    assert plan(cfg, dest).kind == "restart"
    paths = download_model(files, dest)
    assert [file_crc32(p) for p in paths] == [f.crc32 for f in files]
    assert all(plan(f, dest).kind == "done" for f in files)
    with DirLock(dest):
        with pytest.raises(LockError):
            with DirLock(dest):
                pass
    # the downloaded directory serves
    lm = LanguageModel.from_dir(dest, device="cpu", max_context=64)
    assert len(lm.generate_list(np.arange(5), 3, stop_token_ids=[])) == 3


# -- the CLI ----------------------------------------------------------------------


def test_cli_bench_writes_the_bench_result(models_root, tmp_path, capsys):
    task = {"identifier": "t", "repo_id": "local", "number_of_runs": 2, "tokens_limit": 8,
            "greedy": True, "messages": [{"role": "user", "content": "hello"}]}
    (tmp_path / "task.json").write_text(json.dumps(task))
    out = tmp_path / "out.json"
    chat = os.path.join(models_root, "chatty")
    assert main(["bench", chat, str(tmp_path / "task.json"), str(out), "--max-context", "128",
                 "--device", "cpu"]) == 0
    result = json.loads(out.read_text())
    want_keys = {"task", "device", "engine_version", "timestamp", "data_type", "memory_used",
                 "peak_rss_bytes", "cpu_utilization", "tokens_count_input",
                 "tokens_count_output", "time_to_first_token", "prompt_tokens_per_second",
                 "generate_tokens_per_second", "text"}
    assert set(result) == want_keys
    assert result["device"]["cpu_name"] == "cpu"
    assert result["tokens_count_output"] > 0
    assert "decode_tok_s" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the JAX CLI writes the same keys for the same task
    jout = tmp_path / "jout.json"
    assert jax_main(["bench", chat, str(tmp_path / "task.json"), str(jout),
                     "--max-context", "128"]) == 0
    assert set(json.loads(jout.read_text())) == want_keys


def test_cli_synth_storage_and_classify(models_root, tmp_path, capsys):
    out = str(tmp_path / "m" / "chat")
    assert main(["synth", "chat", out, "--seed", "1"]) == 0
    assert os.path.exists(os.path.join(out, "tokenizer.json"))
    assert main(["synth", "nope", out]) == 1
    capsys.readouterr()
    assert main(["storage", str(tmp_path / "m")]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["id"] for r in rows] == ["chat"] and rows[0]["size_bytes"] > 0
    assert main(["storage", str(tmp_path / "m"), "--delete", "chat"]) == 0
    assert main(["storage", str(tmp_path / "m"), "--delete", "chat"]) == 1
    capsys.readouterr()
    clf = os.path.join(models_root, "clf")
    from uzu_tpu_torch.tools.corpus import write_byte_tokenizer

    write_byte_tokenizer(str(tmp_path / "clf_tok"))
    for name in ("config.json", "model.safetensors"):
        os.symlink(os.path.join(clf, name), tmp_path / "clf_tok" / name)
    assert main(["classify", str(tmp_path / "clf_tok"), "a", "b", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out["probabilities"]) == {"a", "b", "c"} and len(out["logits"]) == 3


def test_cli_ppl_matches_the_jax_cli(models_root, tmp_path, capsys):
    text = tmp_path / "corpus.txt"
    text.write_text("the quick brown fox jumps over the lazy dog " * 4)
    chat = os.path.join(models_root, "chatty")
    assert main(["ppl", chat, str(text), "--max-context", "128", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(["ppl", chat, str(text), "--max-context", "128"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["count"] == want["count"] > 10
    assert got["nll"] == pytest.approx(want["nll"], rel=2e-2)  # bf16 weights and activations


def test_cli_refuses_mesh_flags_and_defaults_to_the_card(models_root, monkeypatch):
    """`autotune` is not registered; the mesh flags parse (`parallel/`),
    and with them as without them the default device is the card: no
    card raises before any rank is started."""
    chat = os.path.join(models_root, "chatty")
    with pytest.raises(SystemExit):
        main(["autotune", chat])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["ppl", chat, "x.txt", "--tp", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["classify", os.path.join(models_root, "clf"), "hi"])


def test_cli_chat_constrained_turn(models_root, tmp_path, capsys, monkeypatch):
    schema = {"type": "object", "properties": {"city": {"enum": ["Paris"]}},
              "required": ["city"]}
    (tmp_path / "schema.json").write_text(json.dumps(schema))
    lines = iter(["hello", ""])
    monkeypatch.setattr("builtins.input", lambda *_: next(lines))
    assert main(["chat", os.path.join(models_root, "chatty"), "--max-tokens", "32",
                 "--max-context", "128", "--device", "cpu",
                 "--json-compact", "--json-schema", str(tmp_path / "schema.json")]) == 0
    body = capsys.readouterr().out.split("exit)")[1].split("[")[0].strip()
    from uzu_tpu_torch.grammar import JsonMatcher

    assert body and JsonMatcher(schema).feed_text(body), body


# -- the speculator fallback -------------------------------------------------------------


@pytest.fixture()
def spec_root(tmp_path, models_root):
    """A copy of the chat model with a bundled DFlash speculator dir."""
    import shutil

    root = tmp_path / "spec_models"
    shutil.copytree(os.path.join(models_root, "chatty"), root / "chatty")
    cfg = psynth.llama_config(vocab_size=512, **TINY)
    psynth.synth_dflash_speculator(str(root / "chatty" / "speculator"), cfg, block_size=4,
                                   target_layer_ids=(0, 1), seed=1)
    return root


def test_a_bundled_speculator_engages(spec_root):
    eng = Engine(str(spec_root), device="cpu")
    kw = dict(max_context=128, prefill_buckets=(16, 64))
    session = eng.chat("chatty", **kw)
    assert isinstance(session.speculator, DFlashSpeculativeDecoder)
    plain = eng.chat("chatty", speculate=False, **kw)
    assert plain.speculator is None
    want = plain.reply("hello", max_new_tokens=12)
    assert session.reply("hello", max_new_tokens=12).tokens == want.tokens


@pytest.mark.parametrize("fault", ["missing_weights", "bad_json", "bad_config", "bad_shape"])
def test_a_malformed_speculator_dir_falls_back_to_plain(spec_root, fault):
    spec = spec_root / "chatty" / "speculator"
    if fault == "missing_weights":
        os.remove(spec / "model.safetensors")
    elif fault == "bad_json":
        (spec / "config.json").write_text("{not json")
    elif fault == "bad_config":
        (spec / "config.json").write_text(json.dumps({"type": "SpeculatorModelConfig"}))
    else:  # the config of this width over the weights of a narrower draft
        config = (spec / "config.json").read_text()
        psynth.synth_dflash_speculator(str(spec), psynth.llama_config(
            vocab_size=512, **dict(TINY, model_dim=32)), block_size=4,
            target_layer_ids=(0, 1), seed=1)
        (spec / "config.json").write_text(config)
    assert Engine(str(spec_root), device="cpu").chat("chatty", max_context=128).speculator \
        is None
    from uzu_tpu_torch.cli import _load_chat

    assert _load_chat(str(spec_root / "chatty"), 128, "cpu").speculator is None


def test_any_other_speculator_error_raises(spec_root, monkeypatch):
    def launch_failure(*a, **kw):
        raise RuntimeError("paged_attention: CUDA launch failed with error 719")

    monkeypatch.setattr(dflash.DFlashDraft, "from_dir", launch_failure)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        Engine(str(spec_root), device="cpu").chat("chatty", max_context=128)
    from uzu_tpu_torch.cli import _load_chat

    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _load_chat(str(spec_root / "chatty"), 128, "cpu")


# -- imports ----------------------------------------------------------------------------


def test_front_end_modules_load_no_jax_module():
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {FRONT_MODULES!r}]; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
