"""The port's training step (cutie_tpu_torch/training, train.py and the
training utils) against cutie_tpu's, on the CPU, on the small model with
state_dict_small.npz weights.

Tolerances:
- train_forward's outputs: atol 2e-4 x the reference's scale (rtol 2e-3),
  tests/test_parity_model.py's bar for a chain of fp32 stages;
- the gradient of a fixed random linear functional of the outputs, for
  every parameter: the norm of the difference within 3e-2 of the norm of
  cutie_tpu's gradient (or of 1e-3, for the key projection's bias, whose
  gradient is zero but for rounding: a shift of every key cancels). It
  measured at most 9.5e-3, in the mask encoder's trunk; the stage alone
  agrees to 1.5e-6 (tests/test_torch_train_model.py). The random test
  weights give similarities of order 1,000, a one-hot softmax, where the
  expanded form's fp32 rounding (about 6e-4 absolute, another in each
  package) moves the read's gradient;
- AdamW after three steps with the gradient clip active: within 1e-6 of
  cutie_tpu's optax parameters, a hundredth of the 1e-4 a step moves a
  parameter (measured at most 3.0e-7, 2.5 fp32 units of roundoff at a
  BatchNorm weight of 1): the two libraries round the decay and the
  update in another order, and torch divides the clip by the norm + 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from tests.conftest import require_golden  # noqa: E402
from tests.test_parity_model import assert_close  # noqa: E402
from tests.test_torch_point_features import _model_cfgs, stage_cfgs  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401
from tests.test_torch_train_model import (_synchronous_jax_dispatch,  # noqa: E402,F401
                                          jax_small, port_small)

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.training.train_forward import train_forward  # noqa: E402
from cutie_tpu_torch.training.trainer import (Trainer, make_optimizer,  # noqa: E402
                                              param_label)
from cutie_tpu_torch.utils.get_default_model import (apply_object_surgery,  # noqa: E402
                                                     build_model,
                                                     from_jax_variables)

OUT_KEYS = ("logits", "logits_low", "sensory_logits", "q_logits")


def tiny_data(b=1, t=3, hw=64, o=2, seed=0):
    """A batch in cutie_tpu's layout (frames [B, T, H, W, 3]) and in the
    port's ([B, T, 3, H, W])."""
    rng = np.random.default_rng(seed)
    cls_gt = rng.integers(0, o + 1, size=(b, t, hw, hw))
    first_gt = np.moveaxis(np.eye(o + 1, dtype=np.float32)[cls_gt[:, 0]], -1, 1)[:, 1:]
    jdata = {"frames": rng.uniform(size=(b, t, hw, hw, 3)).astype(np.float32),
             "first_frame_gt": first_gt,
             "selector": np.ones((b, o), np.float32),
             "cls_gt": cls_gt.astype(np.uint8)}
    data = dict(jdata, frames=np.ascontiguousarray(np.moveaxis(jdata["frames"], -1, 2)))
    return jdata, data


def _functional(seed, outs):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(outs[k])).astype(np.float32) for k in OUT_KEYS}


@pytest.fixture(scope="module")
def jax_run():
    """cutie_tpu's train_forward at T=3, num_ref_frames 2: its outputs at
    deep_update_prob 0 and 1, and at 1 the gradient of a fixed random linear
    functional of the outputs for every parameter."""
    from cutie_tpu.training.train_forward import train_forward as jax_train_forward

    jmodel, jvars = jax_small()
    jdata, _ = tiny_data()
    res = {}
    for dup in (0.0, 1.0):
        jstage, _ = stage_cfgs(seq_length=3, num_ref_frames=2, deep_update_prob=dup,
                               remat=False)

        def forward(params):
            return jax_train_forward(
                jmodel, {"params": params, "batch_stats": jvars["batch_stats"]},
                jdata, jax.random.PRNGKey(0), jstage)

        if dup == 0.0:
            res[dup] = {k: np.asarray(v) for k, v in jax.jit(forward)(jvars["params"]).items()}
            continue
        weights = _functional(1, jax.eval_shape(forward, jvars["params"]))

        def functional(params):
            out = forward(params)
            return sum(jnp.sum(out[k] * weights[k]) for k in OUT_KEYS), out

        grads, out = jax.jit(jax.grad(functional, has_aux=True))(jvars["params"])
        res[dup] = {k: np.asarray(v) for k, v in out.items()}
        res["grads"] = from_jax_variables({"params": grads})
        res["weights"] = weights
    return res


def _port_forward(dup, remat=False):
    _, stage = stage_cfgs(seq_length=3, num_ref_frames=2, deep_update_prob=dup,
                          remat=remat)
    _, data = tiny_data()
    model = port_small()
    out = train_forward(model, {k: torch.from_numpy(v) for k, v in data.items()},
                        torch.Generator().manual_seed(0), stage)
    return model, out


@pytest.mark.parametrize("dup", [0.0, 1.0])
def test_train_forward_matches_cutie_tpu(jax_run, dup):
    _, out = _port_forward(dup)
    assert set(out) == set(OUT_KEYS) == set(jax_run[dup])
    for k in OUT_KEYS:
        assert_close(out[k].detach().numpy(), jax_run[dup][k])


def test_train_forward_gradients_match_cutie_tpu(jax_run):
    """Every parameter's gradient against jax.grad, the port's stages under
    torch.utils.checkpoint (stage_cfg.remat)."""
    model, out = _port_forward(1.0, remat=True)
    sum((out[k] * torch.from_numpy(jax_run["weights"][k])).sum()
        for k in OUT_KEYS).backward()
    grads = jax_run["grads"]
    names = dict(model.named_parameters())
    assert set(names) == set(grads)
    for name, p in names.items():
        ref = grads[name]
        err = np.linalg.norm(p.grad.numpy() - ref)
        assert err < 3e-2 * max(np.linalg.norm(ref), 1e-3), (name, err)


def _jax_labels(jvars):
    """cutie_tpu's param_label of each parameter, carried to torch names
    through from_jax_variables (each leaf filled with its label's code)."""
    from cutie_tpu.training.trainer import param_label as jax_param_label

    codes = {"backbone": 0.0, "embed": 1.0, "other": 2.0}
    coded = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, codes[jax_param_label(
            tuple(getattr(k, "key", str(k)) for k in path))], np.float32),
        jvars["params"])
    names = {v: k for k, v in codes.items()}
    return {name: names[float(v.flat[0])]
            for name, v in from_jax_variables({"params": coded}).items()}


def test_param_groups_match_cutie_tpu():
    """The three groups hold the parameters cutie_tpu's param_label gives,
    the BatchNorm affines of the pixel encoder in the backbone group."""
    _, jvars = jax_small()
    labels = _jax_labels(jvars)
    model = port_small()
    ours = {name: param_label(name) for name, _ in model.named_parameters()}
    assert ours == labels
    assert ours["pixel_encoder.bn1.weight"] == "backbone"
    assert ours["object_transformer.query_init.weight"] == "embed"
    assert ours["mask_encoder.bn1.weight"] == "other"
    _, stage = stage_cfgs(amp=False)
    opt = make_optimizer(model, stage)
    by_id = {id(p): name for name, p in model.named_parameters()}
    for group in opt.param_groups:
        assert {labels[by_id[id(p)]] for p in group["params"]} == {group["name"]}
    assert sum(len(g["params"]) for g in opt.param_groups) == len(by_id)


@pytest.mark.parametrize("schedule", [{"lr_schedule": "constant"},
                                      {"lr_schedule": "step",
                                       "lr_schedule_steps": [1, 2],
                                       "lr_schedule_gamma": 0.1}],
                         ids=["constant", "step"])
def test_optimizer_steps_match_optax(schedule):
    """Three AdamW steps on the same gradients (global norm about 300, so
    the clip to 3.0 is active), the step schedule across both of its
    boundaries, against cutie_tpu's make_optimizer."""
    import optax

    from cutie_tpu.training.trainer import make_optimizer as jax_make_optimizer

    jstage, stage = stage_cfgs(amp=False, **schedule)
    jcfg, cfg = _model_cfgs()
    _, jvars = jax_small()
    params = jvars["params"]
    tx = jax_make_optimizer(jstage)
    state = tx.init(params)
    trainer = Trainer(cfg, stage, port_small())
    named = dict(trainer.model.named_parameters())
    rng = np.random.default_rng(9)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.1,
                             params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, g in from_jax_variables({"params": grads}).items():
            named[name].grad = torch.from_numpy(np.ascontiguousarray(g))
        trainer.apply_gradients()
    assert trainer.updates == 3
    for name, ref in from_jax_variables({"params": params}).items():
        np.testing.assert_allclose(named[name].detach().numpy(), ref, rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("schedule", [
    {"lr_schedule": "constant"},
    {"lr_schedule": "poly", "num_iterations": 100},
    {"lr_schedule": "step", "lr_schedule_steps": [3, 7], "lr_schedule_gamma": 0.1}],
    ids=["constant", "poly", "step"])
def test_lr_schedules_match_cutie_tpu(schedule):
    """make_lr_schedule at counts 0..11 against cutie_tpu's (fp32 rounding
    of its schedule: rtol 1e-6)."""
    from cutie_tpu.training.trainer import make_lr_schedule as jax_make_lr_schedule
    from cutie_tpu_torch.training.trainer import make_lr_schedule

    jstage, stage = stage_cfgs(**schedule)
    ours, theirs = make_lr_schedule(stage), jax_make_lr_schedule(jstage)
    for count in range(12):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_do_pass_descends(amp):
    """Six steps on one batch lower the loss, the parameters stay fp32; amp
    runs the stages in bf16 (cutie_tpu's tests/test_training.py:152-172)."""
    cfg = eval_config("small")
    cfg.amp = amp
    _, stage = stage_cfgs(amp=amp, seq_length=3, train_num_points=64, num_objects=2,
                          lr_schedule="constant")
    model = build_model(cfg, str(require_golden("state_dict_small.npz")),
                        device="cpu")
    trainer = Trainer(cfg, stage, model)
    _, data = tiny_data(b=2)
    first = trainer.do_pass(data, 0, torch.Generator().manual_seed(0))
    assert np.isfinite(first["total_loss"].item())
    for i in range(1, 6):
        last = trainer.do_pass(data, i, torch.Generator().manual_seed(i))
    assert last["total_loss"].item() < first["total_loss"].item()
    assert {"aux_sensory_ce", "aux_query_dice_l3"} <= set(last)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert trainer.it == 6 and trainer.last_logits.shape == (2, 2, 3, 64, 64)
    if amp:
        # the stage dtypes of cutie_tpu's amp model, as chip_smoke.py holds
        # them on the card, with autograd recording as in training
        frame = np.random.default_rng(0).uniform(size=(3, 64, 64)).astype(np.float32)
        assert (chip_smoke.amp_stage_dtypes(model, frame, grad=True)
                == chip_smoke.AMP_STAGE_DTYPES)


def test_trainer_rejects_mismatched_amp():
    _, stage = stage_cfgs(amp=True)
    with pytest.raises(ValueError):
        Trainer(eval_config("small"), stage, port_small())


def test_checkpoint_roundtrip(tmp_path):
    """A resumed trainer has the model, the optimizer state and it == 1
    after one step, and its next step equals the uninterrupted run's."""
    cfg = eval_config("small")
    _, stage = stage_cfgs(amp=False, seq_length=3, train_num_points=32, num_objects=2)
    _, data = tiny_data()
    trainer = Trainer(cfg, stage, port_small())
    trainer.do_pass(data, 0, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt.pt")
    trainer.save_checkpoint(ckpt)
    resumed = Trainer(cfg, stage, port_small())
    assert resumed.load_checkpoint(ckpt) == 1 and resumed.updates == 1
    for t in (trainer, resumed):
        t.do_pass(data, 1, torch.Generator().manual_seed(1))
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_save_weights_loads_strictly(tmp_path):
    """save_weights writes a torch-named npz that build_model loads
    strictly, single-object weights into a multi-object model through the
    object surgery."""
    cfg = eval_config("small")
    _, stage = stage_cfgs(amp=False)
    trainer = Trainer(cfg, stage, port_small(single_object=True))
    path = str(tmp_path / "w.npz")
    trainer.save_weights(path)
    single = build_model(cfg, path, device="cpu", single_object=True)
    for (name, a), b in zip(single.state_dict().items(),
                            trainer.model.state_dict().values()):
        assert torch.equal(a, b), name
    multi = build_model(cfg, path, device="cpu")
    assert multi.mask_encoder.conv1.weight.shape[1] == 5


def test_cutie_tpu_trainer_npz_carries_aux_head(tmp_path):
    """cutie_tpu's Trainer.save_weights npz (flax paths) loads into the
    port strictly, the aux head included."""
    from cutie_tpu.models import CUTIE as JaxCUTIE
    from cutie_tpu.training.trainer import Trainer as JaxTrainer

    jcfg, cfg = _model_cfgs()
    jstage, _ = stage_cfgs()
    _, jvars = jax_small()
    path = str(tmp_path / "jax_weights.npz")
    JaxTrainer(cfg=jcfg, stage_cfg=jstage, model=JaxCUTIE(jcfg),
               variables=jvars).save_weights(path)
    model = build_model(cfg, path, device="cpu")
    expected = from_jax_variables(jvars)
    assert "aux_computer.sensory_aux.projection.conv.weight" in expected
    for name, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), expected[name], err_msg=name)


def test_single_to_multi_handoff_matches_cutie_tpu():
    """apply_object_surgery on a single-object state dict gives what
    cutie_tpu's adapt_variables_single_to_multi gives (the same seeded
    orthogonal pads), and the result loads strictly into a multi-object
    model."""
    from cutie_tpu.utils.weight_import import adapt_variables_single_to_multi

    _, jvars = jax_small(single_object=True)
    jmulti = from_jax_variables(adapt_variables_single_to_multi(jvars, 256, 256))
    single = {k: v.detach().numpy()
              for k, v in port_small(single_object=True).state_dict().items()}
    ours = apply_object_surgery(single, False, 256, 256)
    assert set(ours) == set(jmulti)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, jmulti[k], err_msg=k)
    build_model(eval_config("small"), device="cpu", state_dict=ours)


def test_train_config_matches_cutie_tpu():
    """train_config, DATA_PRESETS and apply_data_preset equal cutie_tpu's,
    the subset files being the port's copies of the same lists."""
    import os

    from cutie_tpu import train as jtrain
    from cutie_tpu_torch import train

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()}
        if isinstance(d, str) and d.endswith(".txt"):
            assert os.path.exists(d), d
            with open(d) as f:
                return (os.path.basename(d), f.read())
        return d

    assert train.DATA_PRESETS == jtrain.DATA_PRESETS
    for preset in (None, "mega"):
        cfg, jcfg = train.train_config(), jtrain.train_config()
        if preset:
            train.apply_data_preset(cfg, preset)
            jtrain.apply_data_preset(jcfg, preset)
        assert strip(cfg.to_dict()) == strip(jcfg.to_dict())


def test_training_utils_match_cutie_tpu(monkeypatch, tmp_path):
    """Integrator (averages, hooks), TimeEstimator on a fixed clock and
    vis_sequence (the port's frames channels first) against cutie_tpu's."""
    import time

    from cutie_tpu.utils import image_saver as jimage_saver
    from cutie_tpu.utils import time_estimator as jtime_estimator
    from cutie_tpu_torch.utils import image_saver, time_estimator
    from cutie_tpu_torch.utils.log_integrator import Integrator
    from cutie_tpu_torch.utils.logger import TensorboardLogger

    logged = []

    class Sink:
        def log_metrics(self, prefix, metrics, it):
            logged.append((prefix, metrics, it))

    integ = Integrator(Sink())
    integ.add_hook(lambda v: ("sum", v["a"] + v["b"]))
    integ.add_dict({"a": torch.tensor(1.0), "b": 2.0})
    integ.add_dict({"a": torch.tensor(3.0), "b": np.float32(4.0)})
    integ.finalize("train", 7)
    assert logged == [("train", {"a": 2.0, "b": 3.0, "sum": 10.0}, 7)]
    # the cross-rank average, in a one-process gloo group over a file store
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        integ.finalize("train", 8)
    finally:
        dist.destroy_process_group()
    assert logged[-1] == ("train", {"a": 2.0, "b": 3.0, "sum": 10.0}, 8)

    clock = iter(np.arange(0.0, 100.0, 1.5) ** 1.2)
    now = [0.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    ests = [time_estimator.TimeEstimator(1000, 10),
            jtime_estimator.TimeEstimator(1000, 10)]
    for _ in range(5):
        now[0] = float(next(clock))
        for e in ests:
            e.update()
        assert ests[0].get_est_remaining(50) == ests[1].get_est_remaining(50)
    assert ests[0].get_and_reset_avg_time() == ests[1].get_and_reset_avg_time()

    jdata, data = tiny_data(b=2, t=3, hw=16, o=2)
    logits = np.random.default_rng(0).normal(size=(2, 2, 3, 16, 16))
    np.testing.assert_array_equal(image_saver.vis_sequence(data, logits, bi=1),
                                  jimage_saver.vis_sequence(jdata, logits, bi=1))
    logger = TensorboardLogger(None)
    logger.log_metrics("train", {"a": 1.0}, 3)
