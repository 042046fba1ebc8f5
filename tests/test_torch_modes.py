"""The port's eval modes max_internal_size, flip_aug and save_aux
(cutie_tpu_torch.inference) against cutie_tpu and the reference's recorded
streams, on the CPU.

Tolerances:
- resizes: the port's device resize (F.interpolate, bilinear, no
  antialias) within 1e-5 absolute of cutie_tpu's bilinear_resize_np, and
  the index-mask resize equal to cutie_tpu's nearest_exact_resize_np;
- streams: the bars of tests/test_inference_stream.py:81-84 (argmax
  agreement > 0.97 per frame, > 0.995 where the reference's top-2 margin
  exceeds 0.01, median max-abs probability error < 0.05);
- save_aux: on frame 1, where both cores read the same memory, every aux
  tensor within 1e-3 of its largest magnitude of cutie_tpu's, after moving
  cutie_tpu's channels-last axes to the port's channels-first layout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import (SETTINGS, _assert_stream_close,  # noqa: E402,F401
                                     _port_core, one_intra_op_thread)

from cutie_tpu.ops.resize import bilinear_resize_np, nearest_exact_resize_np  # noqa: E402
from cutie_tpu_torch.ops import resize as tresize  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.mark.parametrize("shape_in,shape_out", [
    ((3, 97, 131), (48, 65)),      # down, ratios not integers
    ((3, 192, 256), (96, 128)),    # down by exactly 2
    ((2, 24, 40), (97, 131)),      # up
], ids=["down", "down_2x", "up"])
def test_resize_matches_cutie_tpu_host_resize(shape_in, shape_out):
    rng = np.random.default_rng(sum(shape_in))
    x = rng.uniform(size=shape_in).astype(np.float32)
    ours = tresize.bilinear_resize(torch.from_numpy(x), *shape_out).numpy()
    np.testing.assert_allclose(ours, bilinear_resize_np(x, *shape_out),
                               rtol=0, atol=1e-5)
    mask = rng.integers(0, 4, size=shape_in[1:])
    np.testing.assert_array_equal(
        tresize.nearest_exact_resize_np(mask, *shape_out),
        nearest_exact_resize_np(mask, *shape_out))


@pytest.mark.parametrize("tag,settings", [
    ("resize", {"max_internal_size": 96}),
    ("flip", {"flip_aug": True}),
])
def test_mode_stream_matches_reference(tag, settings):
    """The reference's recorded small streams: 192x256 frames segmented at
    96x128 and upsampled back, and flip_aug at 96x128."""
    rec = dict(np.load(require_golden(f"stream_small_{tag}.npz")))
    core = _port_core("small", dict(SETTINGS, **settings))
    probs = []
    for ti, frame in enumerate(rec["frames"]):
        prob = (core.step(frame, rec["mask0"], objects=[1, 2]) if ti == 0
                else core.step(frame))
        probs.append(prob.numpy())
    _assert_stream_close(probs, rec["probs"])
    if tag == "flip":
        assert core.state.sensory.shape[0] == 2


def test_resize_empty_result_at_input_size():
    """A frame with no memory to read returns zeros at the caller's size, not
    the internal one, and frees its cached features
    (tests/test_consolidation.py:184-204)."""
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    core = _port_core("small", dict(SETTINGS, max_internal_size=32))
    out = core.step(rec["frames"][0])
    assert tuple(out.shape) == (1,) + rec["frames"].shape[2:]
    assert float(out.abs().max()) == 0.0
    assert len(core.image_feature_store) == 0


def test_flip_save_aux_matches_cutie_tpu_core():
    """flip_aug and save_aux together, the port against a live cutie_tpu
    core on 5 frames of a 64x64 crop, a memory frame every 2."""
    from tests.test_inference_stream import _build_core

    rec = dict(np.load(require_golden("stream_small_work.npz")))
    frames = np.ascontiguousarray(rec["frames"][:5, :, 16:80, 32:96])
    mask0 = np.ascontiguousarray(rec["mask0"][16:80, 32:96])
    extra = {"mem_every": 2, "save_aux": True}
    jcore = _build_core(use_long_term=False, flip_aug=True, cfg_extra=extra)
    core = _port_core("small", dict(SETTINGS, flip_aug=True, **extra))
    ours, theirs = [], []
    for ti, frame in enumerate(frames):
        args = (frame, mask0) if ti == 0 else (frame,)
        kw = {"objects": [1, 2]} if ti == 0 else {}
        ours.append(core.step(*args, **kw).numpy())
        theirs.append(np.asarray(jcore.step(*args, **kw)))
        if ti == 1:
            assert set(core.aux) == set(jcore.aux)
            for key, value in core.aux.items():
                want = np.asarray(jcore.aux[key]).astype(np.float32)
                if key in ("pixel_readout", "sensory"):
                    want = np.moveaxis(want, -1, 2)      # channels first
                got = value.float().numpy()
                assert got.shape == want.shape, (key, got.shape, want.shape)
                err = np.abs(got - want).max()
                assert err <= 1e-3 * np.abs(want).max(), (key, err)
    _assert_stream_close(ours, theirs)
