"""The port's long-term memory with two buckets and usage-ranked eviction,
through the port and cutie_tpu's InferenceCore side by side on the CPU.

Split from tests/test_torch_lt.py because the stream is long (the clip
looped three times through both engines): a module of its own lets
`--dist loadfile` give it a worker of its own.

Bars: those of tests/test_torch_stream.py; long-term counts and per-object
validity exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_lt import SETTINGS  # noqa: E402
from tests.test_torch_stream import _assert_stream_close, _port_core  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """Run cutie_tpu's computations synchronously, as
    tests/test_torch_read.py does: with JAX's asynchronous CPU dispatch a
    PyTorch computation right after a JAX one came out perturbed now and
    then."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def test_multibucket_eviction_stream_matches_cutie_tpu():
    """tests/test_consolidation.py:test_multibucket_lt_eviction_stream
    through the port and cutie_tpu side by side: a second object added
    mid-video (two buckets), tiny long-term budgets so that consolidation
    and usage-ranked eviction both run, the clip looped three times."""
    from tests.test_inference_stream import _build_core

    rec = dict(np.load(require_golden("stream_small_adddel.npz")))
    frames, mask0, mask2 = rec["frames"], rec["mask0"], rec["mask2"]
    extra = {"mem_every": 1,
             "long_term": {"count_usage": True, "max_mem_frames": 3,
                           "min_mem_frames": 1, "num_prototypes": 8,
                           "max_num_tokens": 64, "buffer_tokens": 16}}
    jcore = _build_core(use_long_term=True, cfg_extra=extra)
    settings = dict(SETTINGS)
    settings.update(extra)
    core = _port_core("small", settings)

    t = frames.shape[0]
    ours, theirs, evictions = [], [], 0
    for rep in range(3):
        for ti in range(t):
            i = rep * t + ti
            args = ((frames[ti], np.where(mask0 == 1, 1, 0)), {"objects": [1]}) \
                if i == 0 else ((frames[ti], mask2), {"objects": [2]}) \
                if i == 4 else ((frames[ti],), {})
            lt_before = core.state.lt_count if core.state is not None else 0
            ours.append(core.step(*args[0], **args[1]).numpy())
            theirs.append(np.asarray(jcore.step(*args[0], **args[1])))
            assert core.state.lt_count == jcore._lt_count, i
            n = core.state.lt_count
            np.testing.assert_array_equal(
                core.state.lt_obj_valid[:, :n].numpy(),
                np.asarray(jcore.state.lt_obj_valid)[:2, :n], err_msg=str(i))
            evictions += core.state.lt_count < lt_before
    assert evictions > 0, "eviction never ran"
    _assert_stream_close(ours, theirs)
    n = core.state.lt_count
    ov = core.state.lt_obj_valid[:, :n].numpy()
    assert ov[0].any() and ov[1].any()
