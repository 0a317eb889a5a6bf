"""Multi-host launch of the port, as `tests/test_multihost.py` runs the JAX
package's: a global (dp=2 across "hosts", tp=2 within one) mesh, here 4
gloo ranks on the CPU (`make_hybrid_mesh`), each holding only its slice.
Each dp replica prefills its own sequence and its logits are held to the
JAX package's single-process prefill of that sequence; the streamed
sharded load (`from_dir_sharded`) keeps each rank's host peak under half
the file and leaves the attention projection split.
"""

import numpy as np
import pytest

from torch_parallel_pool import RankPool
from uzu_tpu import LanguageModel as JaxLM
from uzu_tpu.tools import synth as jsynth


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield p
    p.close()


def _jax_prefill(d, toks):
    lm = JaxLM.from_dir(d, max_context=64, prefill_buckets=(16,))
    logits, _ = lm.prefill(lm.new_state(), toks)
    return np.asarray(logits)


def test_two_host_dp_over_hosts(pool, tmp_path):
    """test_two_process_dp_over_dcn: one sequence per dp replica."""
    cfg = jsynth.llama_config(num_layers=2, model_dim=64, hidden_dim=128, num_heads=4,
                              num_groups=2, head_dim=16, vocab_size=256)
    d = jsynth.synthesize(cfg, str(tmp_path / "mh_model"), seed=4, dtype=np.float32)
    toks = np.stack([(np.arange(16) * 5) % 256, (np.arange(16) * 11) % 256])
    got = pool.run("multihost_dp", d, toks, 12, False)
    assert sorted(rep for rep, *_ in got) == [0, 0, 1, 1]
    for rep, logits, _, _ in got:
        np.testing.assert_allclose(logits, _jax_prefill(d, toks[rep][:12]), rtol=2e-3,
                                   atol=2e-3)


def test_two_host_sharded_load(pool, tmp_path):
    """test_two_process_sharded_load: streamed group by group, each rank's
    host peak stays under half the file, qkv is split, logits match."""
    cfg = jsynth.llama_config(num_layers=4, model_dim=64, hidden_dim=128, num_heads=4,
                              num_groups=2, head_dim=16, vocab_size=256)
    d = jsynth.synthesize(cfg, str(tmp_path / "mh_sharded"), seed=9, dtype=np.float32)
    toks = ((np.arange(16) * 7) % 256)
    want = _jax_prefill(d, toks[:12])
    for _, logits, stats, (mine, whole) in pool.run("multihost_dp", d, np.stack([toks, toks]),
                                                     12, True):
        assert stats["peak_group_host_bytes"] < 0.5 * stats["total_file_bytes"], stats
        assert stats["addressable_param_bytes"] < stats["total_file_bytes"], stats
        assert mine != whole and mine[0] * 2 == whole[0], (mine, whole)
        np.testing.assert_allclose(logits, want, rtol=2e-3, atol=2e-3)
