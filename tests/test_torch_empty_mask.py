"""An empty index mask (step(frame, mask, objects=[])) through the port's
InferenceCore and cutie_tpu's side by side, on the CPU.

The reference warns, frees the frame's features and returns zeros
(1, H, W): it merges nothing and memorizes nothing
(cutie_tpu/inference/inference_core.py, empty_result). The eval harness
passes objects=[] for every annotation PNG that holds only background.

Bars: the stream bars of tests/test_torch_stream.py on every frame that
has an output; the memory counters (permanent tokens, working-memory
frames, engaged) equal after every frame.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import (SETTINGS, _assert_stream_close,  # noqa: E402,F401
                                     _port_core, one_intra_op_thread)

# Two torch threads, not one: in the mid_stream case the reference's last
# frame holds a tie, pixels (42, 0) and (42, 1) with their two largest
# probabilities one fp32 ulp apart (1.19e-7), and the port lands within
# 3e-7 of them, on cutie_tpu's side with 2 or 8 threads and on the other
# with 1 or 4, which the exact object-id map comparison at the end of the
# test sees.
INTRA_OP_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """Run cutie_tpu's computations synchronously, as
    tests/test_torch_read.py does."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def _counters(core, jcore):
    st = core.state
    ours = ((st.perm_n, st.work_count) if st is not None else (0, 0)) \
        + (core.engaged,)
    return ours, (jcore._perm_n, jcore._work_count, jcore.engaged)


@pytest.mark.parametrize("empty_at", [0, 2], ids=["first_frame", "mid_stream"])
def test_empty_index_mask_matches_cutie_tpu(empty_at):
    """Six 64x64 frames, a memory frame every 2. With the empty mask on the
    first frame, the objects' mask comes on frame 2; mid-stream, it comes
    on frame 0 and the empty one on frame 2."""
    from tests.test_inference_stream import _build_core

    rec = dict(np.load(require_golden("stream_small_work.npz")))
    frames = np.ascontiguousarray(rec["frames"][:6, :, 16:80, 32:96])
    mask0 = np.ascontiguousarray(rec["mask0"][16:80, 32:96])
    empty = np.zeros_like(mask0)
    mask_at = 2 if empty_at == 0 else 0
    jcore = _build_core(use_long_term=False, cfg_extra={"mem_every": 2})
    core = _port_core("small", dict(SETTINGS, mem_every=2))

    ours, theirs = [], []
    for ti, frame in enumerate(frames):
        if ti == empty_at:
            args, kw = (frame, empty), {"objects": []}
        elif ti == mask_at:
            args, kw = (frame, mask0), {"objects": [1, 2]}
        else:
            args, kw = (frame,), {}
        out = core.step(*args, **kw)
        ref = np.asarray(jcore.step(*args, **kw))
        assert out.shape == ref.shape, ti
        assert out.device == core.device
        if ti == empty_at or (empty_at == 0 and ti < mask_at):
            # the empty mask, and a frame with no memory yet after it
            assert out.shape == (1,) + frame.shape[-2:]
            assert not out.any() and not ref.any()
        else:
            ours.append(out.numpy())
            theirs.append(ref)
        port_counts, ref_counts = _counters(core, jcore)
        assert port_counts == ref_counts, (ti, port_counts, ref_counts)
    if empty_at == 0:
        assert _counters(core, jcore)[0][0] > 0  # the later mask committed
    _assert_stream_close(ours, theirs)
    np.testing.assert_array_equal(
        core.output_prob_to_mask(torch.from_numpy(ours[-1])),
        jcore.output_prob_to_mask(theirs[-1]))
