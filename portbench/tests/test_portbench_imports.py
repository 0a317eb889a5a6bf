"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: `uzu_tpu_torch` is not `uzu_tpu`), and a measurement run
without a card exits non-zero, prints no result and never falls back to
the CPU."""

import glob
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "uzu_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True)
    return set(out.stdout.split())


def test_benchmark_modules_load_no_jax():
    names = ["portbench.harness", "portbench.model", "portbench.check", "portbench.trace",
             "portbench.work", "portbench.engines.paged", "portbench.engines.dense"]
    names += ["portbench.families." + os.path.basename(p)[:-3]
              for p in glob.glob(os.path.join(HERE, "families", "[a-z]*.py"))]
    names += ["portbench.kinds." + os.path.basename(p)[:-3]
              for p in glob.glob(os.path.join(HERE, "kinds", "[a-z]*.py"))]
    loaded = _modules("import " + ", ".join(names) +
                      "\nfrom uzu_tpu_torch.ops.cuda import autotune, build")
    assert "uzu_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_whole_run_loads_no_jax():
    """A whole (tiny, CPU) run in a fresh process, checked as the harness
    checks after the window."""
    code = ("import torch; torch.set_num_threads(2)\n"
            "from portbench import harness\nfrom portbench.tests import tiny\n"
            "out = harness.run_cell(tiny.loaded(tiny.LFM2), seed=5, seconds=0.5, trace=True,"
            " device='cpu', t_process=0.0, log=lambda **k: None)\n"
            "assert out['result'] is not None and harness.forbidden_modules() == []")
    assert not _modules(code) & FORBIDDEN


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("uzu_tpu_torchlike", sys)
    try:
        assert "uzu_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["uzu_tpu_torchlike"]


def test_run_without_card_fails_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen3-4b.long-prompt", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_measurement_on_cuda_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the path without one")
    from portbench.tests import tiny

    with pytest.raises(RuntimeError):
        harness.run_cell(tiny.loaded(tiny.QWEN), seed=1, seconds=0.1, trace=False,
                         device="cuda", t_process=0.0, log=lambda **k: None)
