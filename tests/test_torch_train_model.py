"""The port's training-side model (single- and multi-object stages, the aux
heads, the training memory read) against cutie_tpu's flax model on the
state_dict_small.npz weights, on the CPU; and the three repairs of the
training slice:

- FrozenBatchNorm's affine weight and bias are trainable parameters, as in
  cutie_tpu (they were buffers);
- the aux-head weights are carried from every weights file (they were
  dropped);
- the training read uses the expanded similarity, which saves O(1)
  [B, P, N] tensors for the backward (the direct form saved two a key
  channel).

Tolerances are tests/test_parity_model.py's: rtol 2e-3 and atol 2e-4 x the
reference's scale (max(1, max|ref|)); the object-transformer stages keep
that file's 2e-3.
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_parity_model import assert_close  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.ops.memory import get_similarity, get_similarity_expanded  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import (build_model,  # noqa: E402
                                                     from_jax_variables,
                                                     load_torch_npz)


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def small_sd():
    return {k: v.astype(np.float32)
            for k, v in load_torch_npz(str(require_golden("state_dict_small.npz"))).items()}


def jax_small(single_object=False, cfg=None):
    """cutie_tpu's small CUTIE and its variables on state_dict_small.npz
    (cut to one object by cutie_tpu's own surgery when single_object),
    imported strictly."""
    from cutie_tpu.config import eval_config as jax_eval_config
    from cutie_tpu.models import CUTIE as JaxCUTIE
    from cutie_tpu.utils.weight_import import (apply_object_surgery,
                                               convert_torch_state_dict)

    cfg = cfg or jax_eval_config("small")
    model = JaxCUTIE(cfg, single_object=single_object)
    sd = apply_object_surgery(small_sd(), single_object, cfg.model.sensory_dim,
                              cfg.model.value_dim)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32),
                            np.zeros((1, 2, 64, 64), np.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return model, convert_torch_state_dict(sd, zeros, strict=True)


def port_small(single_object=False, cfg=None):
    return build_model(cfg or eval_config("small"),
                       str(require_golden("state_dict_small.npz")), device="cpu",
                       single_object=single_object)


def nhwc(x):
    """[..., C, H, W] -> [..., H, W, C] (numpy)."""
    x = np.asarray(x)
    return np.moveaxis(x, -3, -1)


def nchw(x):
    return np.moveaxis(np.asarray(x), -1, -3)


def apply(model, variables, method, *args, **kwargs):
    return model.apply(variables, *args, method=method, **kwargs)


def _stage_inputs(seed, n=2, t=2):
    """Random stage inputs at the small model's widths, 64x64 frames
    (4x4 tokens), the port's layouts."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    masks = rng.uniform(size=(1, n, 64, 64)).astype(np.float32)
    return {
        "image": rng.uniform(size=(1, 3, 64, 64)).astype(np.float32),
        "pix_feat": f(1, 256, 4, 4), "sensory": f(1, n, 256, 4, 4),
        "masks": masks, "pixel": f(1, n, 256, 4, 4),
        "key": f(1, 64, 4, 4), "selection": rng.uniform(size=(1, 64, 4, 4)).astype(np.float32),
        "mem_key": f(1, 64, t, 4, 4),
        "mem_shr": 1 + rng.uniform(size=(1, 1, t, 4, 4)).astype(np.float32),
        "mem_val": f(1, n, 256, t, 4, 4), "obj_mem": f(1, n, t, 16, 257),
        "f16": f(1, 256, 4, 4), "f8": f(1, 128, 8, 8), "f4": f(1, 64, 16, 16),
        "readout": f(1, n, 256, 4, 4),
        "selector": np.array([[1.0] * (n - 1) + [0.0]], np.float32),
    }


def _run_stage(stage, single_object, x, port, jmodel, jvars):
    """[(port output, cutie_tpu output in the port's layout, atol)]"""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    sel = t["selector"]
    with torch.no_grad():
        if stage == "encode_mask":
            v, s, summ, _ = port.encode_mask(t["image"], t["pix_feat"], t["sensory"],
                                             t["masks"])
            jv, js, jsumm, _ = apply(jmodel, jvars, "encode_mask", nhwc(x["image"]),
                                     nhwc(x["pix_feat"]), nhwc(x["sensory"]),
                                     x["masks"], deep_update=True)
            return [(v, nchw(jv), 2e-4), (s, nchw(js), 1e-3), (summ, jsumm, 2e-3)]
        if stage == "pixel_fusion":
            out = port.pixel_fusion(t["pix_feat"], t["pixel"], t["sensory"], t["masks"])
            jout = apply(jmodel, jvars, "pixel_fusion", nhwc(x["pix_feat"]),
                         nhwc(x["pixel"]), nhwc(x["sensory"]), x["masks"])
            return [(out, nchw(jout), 2e-4)]
        if stage == "read_memory_and_aux":
            out, aux_in = port.read_memory(
                t["key"], t["selection"], t["mem_key"], t["mem_shr"], t["mem_val"],
                t["obj_mem"], t["pix_feat"], t["sensory"], t["masks"], sel)
            aux = port.compute_aux(t["pix_feat"], aux_in, sel)
            jout, jaux_in = apply(
                jmodel, jvars, "read_memory", nhwc(x["key"]), nhwc(x["selection"]),
                np.moveaxis(x["mem_key"], 1, -1), np.moveaxis(x["mem_shr"], 1, -1),
                np.moveaxis(x["mem_val"], 2, -1), x["obj_mem"], nhwc(x["pix_feat"]),
                nhwc(x["sensory"]), x["masks"], x["selector"])
            jaux = apply(jmodel, jvars, "compute_aux", nhwc(x["pix_feat"]), jaux_in,
                         x["selector"])
            assert set(aux) == set(jaux) == {"attn_mask", "sensory_logits", "q_logits"}
            np.testing.assert_array_equal(aux["attn_mask"].numpy(),
                                          np.asarray(jaux["attn_mask"]))
            return [(out, nchw(jout), 2e-3), (aux_in["q_logits"], jaux_in["q_logits"], 2e-3),
                    (aux["sensory_logits"], jaux["sensory_logits"], 2e-3),
                    (aux["q_logits"], jaux["q_logits"], 2e-3)]
        if stage == "segment_low_logits":
            outs = port.segment((t["f16"], t["f8"], t["f4"]), t["readout"],
                                t["sensory"], selector=sel, return_low_logits=True)
            jouts = apply(jmodel, jvars, "segment",
                          (nhwc(x["f16"]), nhwc(x["f8"]), nhwc(x["f4"])),
                          nhwc(x["readout"]), nhwc(x["sensory"]), selector=x["selector"],
                          return_low_logits=True)
            return [(outs[0], nchw(jouts[0]), 2e-3), (outs[1], jouts[1], 5e-3),
                    (outs[2], jouts[2], 1e-3), (outs[3], jouts[3], 5e-3)]
    raise KeyError(stage)


@pytest.fixture(scope="module", params=[False, True], ids=["multi", "single"])
def models(request):
    single = request.param
    return single, port_small(single), *jax_small(single)


@pytest.mark.parametrize("stage", ["encode_mask", "pixel_fusion",
                                   "read_memory_and_aux", "segment_low_logits"])
def test_stage_matches_cutie_tpu(models, stage):
    """Each stage the training step runs, single- and multi-object, against
    cutie_tpu's on the same random inputs (the last object slot padded out
    by the selector where a stage takes one)."""
    single, port, jmodel, jvars = models
    x = _stage_inputs(3, n=1 if single else 2)
    if single:
        x["selector"] = np.ones((1, 1), np.float32)
    for ours, theirs, atol in _run_stage(stage, single, x, port, jmodel, jvars):
        assert_close(ours.numpy(), np.asarray(theirs), atol=atol)


def test_single_object_shapes():
    """A single-object model's mask encoder takes [image, mask] and its
    sensory compression sensory_dim + 1 channels, as the surgery gives."""
    port = port_small(single_object=True)
    assert port.mask_encoder.conv1.weight.shape[1] == 4
    assert port.pixel_fuser.sensory_compress.conv.weight.shape[1] == 257
    assert port._get_others(torch.zeros(1, 1, 4, 4)) is None


def test_read_memory_and_aux_match_reference_golden():
    """read_memory and compute_aux on the reference's recorded activations
    (tests/test_parity_model.py:test_read_memory_train_path): the readout,
    and the sensory and query aux logits, which need the carried aux-head
    weights."""
    port = port_small()
    rec = {k: torch.from_numpy(v)
           for k, v in np.load(require_golden("stages_small.npz")).items()}
    selector = torch.ones(rec["masks"].shape[:2])
    with torch.no_grad():
        out, aux_in = port.read_memory(
            rec["key"], rec["selection"], rec["mem_key_t"], rec["mem_shr_t"],
            rec["mem_val_t"], rec["obj_memory_t"], rec["pix_feat"], rec["sensory"],
            rec["masks"], selector)
        aux = port.compute_aux(rec["pix_feat"], aux_in, selector)
    assert_close(out.numpy(), rec["readout_t"].numpy(), atol=2e-3)
    assert_close(aux["sensory_logits"].numpy(), rec["aux_sensory_logits"].numpy(),
                 atol=2e-3)
    assert_close(aux["q_logits"].numpy(), rec["aux_q_logits"].numpy(), atol=2e-3)


def test_similarity_expanded_matches_cutie_tpu():
    """get_similarity_expanded against cutie_tpu's get_similarity (the
    expanded form, HIGHEST precision) with and without selection and
    shrinkage, at fp32 rounding of the terms (rtol 1e-5, atol 1e-5 x the
    largest term), and against the port's direct form at the expanded
    form's cancellation (atol 1e-4 x the largest term) on unit-scale keys."""
    from cutie_tpu.ops.memory import get_similarity as jax_get_similarity

    rng = np.random.default_rng(5)
    mk = rng.normal(size=(2, 300, 64)).astype(np.float32)
    qk = rng.normal(size=(2, 70, 64)).astype(np.float32)
    qe = rng.uniform(size=(2, 70, 64)).astype(np.float32)
    ms = (1 + rng.uniform(size=(2, 300))).astype(np.float32)
    for args in ((mk, ms, qk, qe), (mk, None, qk, None)):
        ours = get_similarity_expanded(*[None if a is None else torch.from_numpy(a)
                                         for a in args]).numpy()
        theirs = np.asarray(jax_get_similarity(*args))
        scale = np.abs(theirs).max()
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5 * scale)
    direct = get_similarity(*[torch.from_numpy(a) for a in (mk, ms, qk, qe)]).numpy()
    ours = get_similarity_expanded(*[torch.from_numpy(a) for a in (mk, ms, qk, qe)]).numpy()
    np.testing.assert_allclose(ours, direct, rtol=0, atol=1e-4 * np.abs(direct).max())


def test_training_read_saves_o1_similarity_tensors():
    """Fault F5: the training read kept the direct form's channel loop,
    which saves two [B, P, N] temporaries a key channel for the backward
    (about 2.5 GB a read at B=2, P=900, N=2,700, Ck=64). With the expanded
    form the read saves at most 8 tensors of [B, P, N]: here Ck = 64, B=1,
    P=16, N=32."""
    port = port_small()
    x = _stage_inputs(4, t=2)
    t = {k: torch.from_numpy(v).requires_grad_(v.dtype == np.float32)
         for k, v in x.items()}
    big = []

    def pack(tensor):
        if tuple(tensor.shape) == (1, 16, 32):
            big.append(tensor)
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out, _ = port.read_memory(
            t["key"], t["selection"], t["mem_key"], t["mem_shr"], t["mem_val"],
            t["obj_mem"], t["pix_feat"], t["sensory"], t["masks"], t["selector"])
    assert 0 < len(big) <= 8, len(big)
    out.sum().backward()
    assert t["mem_key"].grad is not None and t["key"].grad is not None


def test_frozen_bn_affine_is_trainable():
    """Fault F3: FrozenBatchNorm's weight and bias are parameters (with
    gradients) and its statistics buffers, under the same state-dict keys;
    in cutie_tpu the affines are params and the statistics batch_stats."""
    port = port_small()
    params = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    for prefix in ("pixel_encoder.bn1", "mask_encoder.layer1.0.bn1"):
        assert f"{prefix}.weight" in params and f"{prefix}.bias" in params
        assert f"{prefix}.running_mean" in buffers
        assert f"{prefix}.running_mean" not in params
    # every cutie_tpu param is a parameter of the port, and every
    # batch_stats entry a buffer
    _, jvars = jax_small()
    mapped = from_jax_variables({"params": jvars["params"]})
    assert set(mapped) == set(params)
    stats = from_jax_variables({"batch_stats": jvars["batch_stats"]})
    assert set(stats) <= set(buffers)
    (f16, _, _), _ = port.encode_image(torch.rand(1, 3, 64, 64))
    f16.square().sum().backward()
    assert params["pixel_encoder.layer3.0.bn2.weight"].grad.abs().sum() > 0


def test_aux_weights_are_carried(tmp_path, caplog):
    """Fault F4: build_model keeps the aux-head weights of a reference npz
    (old and new GConv2d names) and of cutie_tpu's flax variables; a file
    without them loads strictly with the heads at their initialisation and
    one log line."""
    sd = small_sd()
    port = port_small()
    w = port.aux_computer.sensory_aux.projection.conv.weight.detach().numpy()
    np.testing.assert_array_equal(w, sd["aux_computer.sensory_aux.projection.weight"])
    _, jvars = jax_small()
    mapped = from_jax_variables(jvars)
    np.testing.assert_array_equal(
        mapped["aux_computer.sensory_aux.projection.conv.weight"], w)
    no_aux = {k: v for k, v in sd.items() if not k.startswith("aux_computer.")}
    with caplog.at_level(logging.INFO):
        model = build_model(eval_config("small"), device="cpu", state_dict=no_aux)
    assert sum("aux-head" in r.message for r in caplog.records) == 1
    assert model.aux_computer.sensory_aux.projection.conv.weight.shape == w.shape
