"""The plain reference against the port's CPU path at a tiny size of both
configurations (f32 weights: the same math to rounding; the served bf16
path: the whole run's check), and the reference's independence."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, model, weights
from portbench.reference import model as reference
from portbench.spec import model_spec
from portbench.tests import tiny


@pytest.mark.parametrize("config", [tiny.QWEN, tiny.LFM2], ids=["qwen3", "lfm2"])
def test_reference_equals_port_forward_in_f32(config):
    from uzu_tpu_torch.models.decoder import decoder_forward
    from uzu_tpu_torch.models.state import init_state

    spec = model_spec(config)
    raw = weights.make_raw(spec, 2 ** 31 + 99, "cpu")
    raw32 = {k: (v.float() if k.endswith(".scales") else v) for k, v in raw.items()}
    lm = model.language_model(spec, raw32, config["engine"], "cpu")
    toks = np.random.default_rng(0).integers(0, spec.vocab, 90)
    state = init_state(lm.decoder_config, 256, torch.float32)  # f32 KV too
    logits, _ = decoder_forward(lm.decoder_config, lm.params, torch.as_tensor(toks), state,
                                last_only=False)
    ref = reference.logits(spec, raw32, [toks.tolist()], [list(range(90))])[0]
    err = (logits - ref).norm() / ref.norm()
    assert err < 2e-5, float(err)
    assert ref.std() > 1.0  # logits spread as the weights' scales intend


@pytest.mark.parametrize("config", [tiny.QWEN, tiny.LFM2], ids=["qwen3", "lfm2"])
def test_served_run_is_correct(config):
    out = harness.run_cell(tiny.loaded(config), seed=2 ** 33 + 1, seconds=1.0, trace=False,
                           device="cpu", t_process=0.0, log=lambda **kw: None)
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"output_tok_s", "ttft_p90_ms", "tpot_p90_ms", "setup_s"}
    assert list(res)[-1] == "checks"


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import portbench.reference.model, portbench.reference.conv, "
            "portbench.reference.full_attention; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'uzu_tpu', 'uzu_tpu_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True)
    assert out.stdout.strip() == "[]"
