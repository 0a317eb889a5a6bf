"""The port's encoder classifier (`uzu_tpu_torch/models/classifier.py`)
against the JAX package's, on the CPU: the same f32 directory, the same
token ids, logits within 1e-4 relative L2; the power-of-two padding
changes nothing; empty input is refused."""

import numpy as np
import pytest
import torch

from uzu_tpu.models.classifier import ClassifierModel as JaxClassifier
from uzu_tpu.tools import synth as jsynth
from uzu_tpu_torch.models.classifier import ClassifierModel
from uzu_tpu_torch.tools import synth as psynth

torch.set_num_threads(1)

TOL = 1e-4  # relative L2 of the f32 logits
SHAPES = {"small": dict(), "gqa": dict(num_layers=3, model_dim=96, hidden_dim=192,
                                       num_heads=6, num_groups=2, head_dim=16, vocab_size=300)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def pair(request, tmp_path_factory):
    cfg = jsynth.classifier_config(labels=["pos", "neg", "neutral"], **SHAPES[request.param])
    d = jsynth.synthesize_classifier(cfg, str(tmp_path_factory.mktemp("clf")), seed=4,
                                     dtype=np.float32)
    return ClassifierModel.from_dir(d, device="cpu"), JaxClassifier.from_dir(d)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n", [1, 5, 8, 13, 40])
def test_logits_match_jax(pair, n):
    clf, jclf = pair
    ids = ((np.arange(n) * 37 + 11) % clf.config.vocab_size).tolist()
    got, want = clf.classify(ids), jclf.classify(ids)
    assert _rel(got["logits"], want["logits"]) <= TOL
    assert set(got["probabilities"]) == {"pos", "neg", "neutral"}
    for label, p in want["probabilities"].items():
        assert got["probabilities"][label] == pytest.approx(p, abs=1e-5)


def test_padding_invariance_across_buckets(pair):
    clf, _ = pair
    ids = torch.tensor([1, 2, 3, 4, 5])
    logits = [clf.forward(torch.cat([ids, torch.zeros(s - 5, dtype=torch.long)]), 5)
              for s in (8, 16, 64)]
    for other in logits[1:]:
        assert _rel(other, logits[0]) <= TOL


def test_order_matters_and_empty_input_is_refused(pair):
    clf, _ = pair
    assert not np.allclose(clf.classify([1, 2, 3, 4])["logits"],
                           clf.classify([4, 3, 2, 1])["logits"])
    with pytest.raises(ValueError, match="empty"):
        clf.classify([])


def test_synthesized_classifier_files_are_byte_identical(tmp_path):
    cfg_kw = dict(num_layers=2, labels=["a", "b"], num_labels=2)
    for dtype in (np.float32, jsynth.BF16):
        want = jsynth.synthesize_classifier(jsynth.classifier_config(**cfg_kw),
                                            str(tmp_path / f"j{dtype}"), seed=3, dtype=dtype)
        pdtype = np.float32 if dtype is np.float32 else psynth.BF16
        got = psynth.synthesize_classifier(psynth.classifier_config(**cfg_kw),
                                           str(tmp_path / f"p{dtype}"), seed=3, dtype=pdtype)
        for name in ("config.json", "model.safetensors"):
            with open(f"{want}/{name}", "rb") as a, open(f"{got}/{name}", "rb") as b:
                assert a.read() == b.read(), name


def test_bf16_classifier_runs_bf16(tmp_path):
    d = psynth.synthesize_classifier(psynth.classifier_config(), str(tmp_path / "bf16"), seed=1)
    clf = ClassifierModel.from_dir(d, device="cpu")
    out = clf.classify([7, 8, 9])
    assert clf.params["layers"][0]["mlp"]["down"]["w"].dtype == torch.bfloat16
    assert np.isfinite(out["logits"]).all() and len(out["logits"]) == 3
