"""The port's amp mode (build_model with amp=True: bf16 conv and
transformer stacks under torch.autocast, fp32 islands) against cutie_tpu's
amp model on the CPU.

- Every model stage's outputs have the dtypes of cutie_tpu's under amp,
  and those of chip_smoke.AMP_STAGE_DTYPES, the table the card's run
  holds the port's stages to.
- On frame 1 after a mask frame, where both cores read the same memory,
  the port's amp prediction agrees with cutie_tpu's amp core on at least
  0.90 of the pixels (argmax) and with the port's own fp32 core on at least
  0.85, the bar of tests/test_inference_stream.py:103-136; and on every
  pixel where cutie_tpu's top-2 margin exceeds 0.01. The random test
  weights leave most pixels near a tie (the largest probability averages
  0.49), so the plain agreement measures bf16 noise: cutie_tpu's own amp
  core agrees with its fp32 core on 0.884 of frame 1.
- The value stores hold bf16 under amp: cutie_tpu's fp32 value store holds
  only bf16 numbers there, so bf16 storage loses nothing; the port's
  stored values are within 2e-2 of cutie_tpu's largest (five bf16 units of
  roundoff, 2^-8, of it; the two bf16 encoders measured 1.1e-2 apart).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import SETTINGS, one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

STAGES = tuple(chip_smoke.AMP_STAGE_DTYPES)


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def _port_model(amp: bool):
    cfg = eval_config("small")
    cfg.merge(dict(SETTINGS, amp=amp))
    return cfg, build_model(cfg, str(require_golden("state_dict_small.npz")),
                            device="cpu")


@pytest.fixture(scope="module")
def video():
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    return rec["frames"], rec["mask0"]


@pytest.fixture(scope="module")
def jax_amp_core():
    from tests.test_inference_stream import _build_core

    core = _build_core(use_long_term=False, cfg_extra={"amp": True})
    assert core.model.dtype == jnp.bfloat16
    return core


def _dtypes(outputs):
    return [str(x.dtype) for x in outputs]


@pytest.fixture(scope="module")
def stage_dtypes(jax_amp_core, video):
    """{stage: output dtypes} of both packages' amp models on one 64x64
    frame, two objects."""
    frame = video[0][0][:, :64, :64]
    n = 2
    cfg, model = _port_model(amp=True)
    mc = cfg.model
    ours = chip_smoke.amp_stage_dtypes(model, frame, n)

    def apply(*args, method, **kwargs):
        # cutie_tpu's output dtypes, traced without running the stage
        return jax.eval_shape(functools.partial(
            jax_amp_core.model.apply, jax_amp_core.variables, method=method,
            **kwargs), *args)

    x = jnp.transpose(jnp.asarray(frame), (1, 2, 0))[None]
    (f16, f8, f4), pix = apply(x, method="encode_image")
    sens = jnp.zeros((1, n, 4, 4, mc.sensory_dim), jnp.float32)
    masks = jnp.zeros((1, n, 64, 64), jnp.float32)
    mv, new_sens, summ, _ = apply(x, pix, sens, masks, method="encode_mask")
    fused = apply(pix, jnp.zeros((1, n, 4, 4, mc.value_dim), jnp.float32),
                  sens, masks, method="pixel_fusion")
    r, aux = apply(fused, jnp.zeros(summ.shape[:2] + (1,) + summ.shape[2:]),
                   selector=jnp.ones((1, n)), method="readout_query")
    theirs = {
        "encode_image": _dtypes([f16, f8, f4, pix]),
        "transform_key": _dtypes(apply(f16, method="transform_key")),
        "encode_mask": _dtypes([mv, new_sens, summ]),
        "pixel_fusion": _dtypes([fused]),
        "readout_query": _dtypes([r, aux["logits"], aux["attn_mask"]]),
        "segment": _dtypes(apply((f16, f8, f4), r, sens,
                                 selector=jnp.ones((1, n)), method="segment")),
    }
    return ours, theirs


@pytest.mark.parametrize("stage", STAGES)
def test_stage_dtypes_match_cutie_tpu(stage, stage_dtypes):
    ours, theirs = stage_dtypes
    assert ours[stage] == theirs[stage] == chip_smoke.AMP_STAGE_DTYPES[stage], (
        stage, ours[stage], theirs[stage])


def test_amp_frame1_matches_cutie_tpu_amp(jax_amp_core, video):
    frames, mask0 = video
    cfg, amp_model = _port_model(amp=True)
    cfg32, fp32_model = _port_model(amp=False)
    amp, fp32 = InferenceCore(amp_model, cfg), InferenceCore(fp32_model, cfg32)
    probs = {}
    for name, core in (("amp", amp), ("fp32", fp32), ("jax", jax_amp_core)):
        core.step(frames[0], mask0, objects=[1, 2])
        probs[name] = np.asarray(core.step(frames[1]), np.float32)
    p = probs["amp"]
    assert np.isfinite(p).all() and p.min() >= 0 and p.max() <= 1
    assert amp.state.perm_value.dtype == torch.bfloat16
    same = p.argmax(0) == probs["jax"].argmax(0)
    agree_jax = same.mean()
    agree_fp32 = (p.argmax(0) == probs["fp32"].argmax(0)).mean()
    assert agree_jax >= 0.90, agree_jax
    assert agree_fp32 >= 0.85, agree_fp32
    top2 = np.sort(probs["jax"], axis=0)[-2:]
    assert same[top2[1] - top2[0] > 0.01].all()

    # the mask frame's stored values
    ours = amp.state.perm_value.float().numpy()[:, :, :amp.state.perm_n]
    theirs = np.asarray(jax_amp_core.state.perm_value)[:, :, :ours.shape[2]]
    bf16_exact = np.asarray(jnp.asarray(theirs).astype(jnp.bfloat16)
                            .astype(jnp.float32))
    np.testing.assert_array_equal(theirs, bf16_exact)
    assert np.abs(ours - theirs).max() <= 2e-2 * np.abs(theirs).max()
