"""The port's model stages (cutie_tpu_torch/models) against the reference's
recorded activations and against cutie_tpu's flax model, on the CPU.

Tolerances are those of tests/test_parity_model.py: rtol 2e-3 and atol
2e-4 x the golden's scale (max(1, max|golden|)); the base (R50) stack's
activations reach O(100), where fp32 accumulation order alone moves the
last digits. Stages with longer fp32 chains keep that file's larger atol.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import require_golden  # noqa: E402
from tests.test_parity_model import assert_close  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import (build_model,  # noqa: E402
                                                     from_jax_variables,
                                                     load_torch_npz)


@pytest.fixture(scope="module", params=["small", "base"])
def setup(request):
    variant = request.param
    model = build_model(eval_config(variant),
                        str(require_golden(f"state_dict_{variant}.npz")),
                        device="cpu")
    rec = {k: torch.from_numpy(v)
           for k, v in np.load(require_golden(f"stages_{variant}.npz")).items()}
    return model, rec


def _stage(model, rec, name):
    """Run one stage on the recorded inputs: [(output, golden key, atol)]."""
    if name == "encode_image":
        (f16, f8, f4), pix_feat = model.encode_image(rec["image"])
        return [(f16, "f16", 2e-4), (f8, "f8", 2e-4), (f4, "f4", 2e-4),
                (pix_feat, "pix_feat", 2e-4)]
    if name == "transform_key":
        key, shrinkage, selection = model.transform_key(rec["f16"])
        return [(key, "key", 2e-4), (shrinkage, "shrinkage", 1e-3),
                (selection, "selection", 2e-4)]
    if name == "encode_mask":
        value, sensory, summaries, _ = model.encode_mask(
            rec["image"], rec["pix_feat"], rec["sensory"], rec["masks"])
        return [(value, "msk_value", 2e-4), (sensory, "new_sensory", 1e-3),
                (summaries, "obj_summaries", 2e-3)]
    if name == "pixel_fusion":
        fused = model.pixel_fusion(rec["pix_feat"], rec["pixel_readout_in"],
                                   rec["sensory"], rec["masks"])
        return [(fused, "fused", 2e-4)]
    if name == "readout_query":
        out, aux = model.readout_query(rec["fused"],
                                       rec["obj_summaries"][:, :, None])
        return [(out, "mem_readout", 2e-3), (aux["logits"], "qt_logits", 2e-3)]
    if name == "segment":
        sensory, logits, prob = model.segment(
            (rec["f16"], rec["f8"], rec["f4"]), rec["mem_readout"],
            rec["sensory"])
        return [(sensory, "seg_sensory", 2e-3), (logits, "seg_logits", 5e-3),
                (prob, "seg_prob", 1e-3)]
    if name == "read_memory":
        out, _ = model.read_memory(
            rec["key"], rec["selection"], rec["mem_key_t"], rec["mem_shr_t"],
            rec["mem_val_t"], rec["obj_memory_t"], rec["pix_feat"],
            rec["sensory"], rec["masks"], torch.ones(rec["masks"].shape[:2]))
        return [(out, "readout_t", 2e-3)]
    raise KeyError(name)


STAGES = ["encode_image", "transform_key", "encode_mask", "pixel_fusion",
          "readout_query", "segment", "read_memory"]


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_reference(setup, stage):
    model, rec = setup
    with torch.no_grad():
        for out, key, atol in _stage(model, rec, stage):
            assert_close(out.numpy(), rec[key].numpy(), atol=atol)


def test_from_jax_variables_matches_flax_model():
    """cutie_tpu's flax variables, mapped by from_jax_variables, load into
    the port strictly, equal the reference npz exactly, and the two models
    agree on the same inputs (NHWC on the flax side)."""
    import jax

    from cutie_tpu.config import eval_config as jax_eval_config
    from cutie_tpu.models import CUTIE as JaxCUTIE
    from cutie_tpu.utils.weight_import import convert_torch_state_dict

    sd_path = str(require_golden("state_dict_small.npz"))
    sd = {k: v.astype(np.float32) for k, v in load_torch_npz(sd_path).items()}
    rec = dict(np.load(require_golden("stages_small.npz")))
    jmodel = JaxCUTIE(jax_eval_config("small"))
    nhwc = lambda x: np.transpose(x, (0, 2, 3, 1))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            nhwc(rec["image"]), rec["masks"])
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    variables = convert_torch_state_dict(sd, zeros, strict=True)

    port_sd = from_jax_variables(variables)
    model = build_model(eval_config("small"), device="cpu", state_dict=port_sd)
    direct = build_model(eval_config("small"), sd_path, device="cpu")
    for k, v in direct.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    image = rec["image"]
    (f16_j, f8_j, f4_j), pix_j = jax.jit(
        lambda v, x: jmodel.apply(v, x, method="encode_image"))(
            variables, nhwc(image))
    sens_j, logits_j, prob_j = jax.jit(
        lambda v, f, r, s: jmodel.apply(v, f, r, s, method="segment"))(
            variables, (f16_j, f8_j, f4_j),
            np.transpose(rec["mem_readout"], (0, 1, 3, 4, 2)),
            np.transpose(rec["sensory"], (0, 1, 3, 4, 2)))
    with torch.no_grad():
        (f16, f8, f4), pix = model.encode_image(torch.from_numpy(image))
        sens, logits, prob = model.segment(
            (f16, f8, f4), torch.from_numpy(rec["mem_readout"]),
            torch.from_numpy(rec["sensory"]))
    assert_close(nhwc(f16.numpy()), np.asarray(f16_j))
    assert_close(nhwc(pix.numpy()), np.asarray(pix_j))
    assert_close(np.transpose(sens.numpy(), (0, 1, 3, 4, 2)),
                 np.asarray(sens_j), atol=2e-3)
    assert_close(logits.numpy(), np.asarray(logits_j), atol=5e-3)
    assert_close(prob.numpy(), np.asarray(prob_j), atol=1e-3)


def test_tensor_ops_match_cutie_tpu():
    """ops/tensor_utils.py and ops/resize.py against cutie_tpu's (NHWC on
    the JAX side): padding, aggregation, area downsample, 2x/4x bilinear
    upsample and nearest-exact, at fp32 rounding (rtol 1e-5, atol 1e-6)."""
    import jax.numpy as jnp

    from cutie_tpu.ops import resize as jresize
    from cutie_tpu.ops import tensor_utils as jtu
    from cutie_tpu_torch.ops import resize, tensor_utils

    rng = np.random.default_rng(11)
    x = rng.uniform(size=(2, 3, 4, 20, 36)).astype(np.float32)  # [B,N,C,H,W]
    nhwc = np.transpose(x, (0, 1, 3, 4, 2))
    tol = dict(rtol=1e-5, atol=1e-6)
    t = torch.from_numpy

    assert tensor_utils.compute_pad(470, 850, 16) == jtu.compute_pad(470, 850, 16)
    padded, pad = tensor_utils.pad_divide_by(t(x), 16)
    padded_j, pad_j = jtu.pad_divide_by(jnp.asarray(nhwc), 16)
    assert pad == pad_j
    np.testing.assert_array_equal(padded.numpy(),
                                  np.transpose(np.asarray(padded_j), (0, 1, 4, 2, 3)))
    np.testing.assert_array_equal(tensor_utils.unpad(padded, pad).numpy(), x)

    prob = x[:, :, 0]                                            # [B, N, H, W]
    np.testing.assert_allclose(tensor_utils.aggregate(t(prob), dim=1).numpy(),
                               np.asarray(jtu.aggregate(jnp.asarray(prob), axis=1)),
                               **tol)
    np.testing.assert_allclose(
        tensor_utils.aggregate_wbg_np(prob[0], keep_bg=True),
        jtu.aggregate_wbg_np(prob[0], keep_bg=True), **tol)

    def back(y):  # NHWC group -> NCHW group
        return np.transpose(np.asarray(y), (0, 1, 4, 2, 3))

    np.testing.assert_allclose(resize.area_downsample(t(x), 4).numpy(),
                               back(jresize.area_downsample(jnp.asarray(nhwc), 4)),
                               **tol)
    for ours, theirs in ((resize.upsample_2x, jresize.upsample_2x),
                         (resize.upsample_4x, jresize.upsample_4x)):
        np.testing.assert_allclose(ours(t(x)).numpy(),
                                   back(theirs(jnp.asarray(nhwc))), **tol)
    idx = rng.integers(0, 4, size=(37, 53))
    np.testing.assert_array_equal(resize.nearest_exact_resize_np(idx, 80, 21),
                                  jresize.nearest_exact_resize_np(idx, 80, 21))
