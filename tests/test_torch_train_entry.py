"""The port's two-stage training entry (cutie_tpu_torch/train.py: run_stage,
main) on the CPU with model_small, on the committed fixtures
(tests/torch_fixtures/): pre-training on the static images, the
single- to multi-object hand-off, main training on the VOS videos with the
max_skip curriculum rebuilding the loader, weights, checkpoints and image
grids; and a resumed run's iteration, epoch and curriculum position
against cutie_tpu's run_stage for the same checkpoint iteration.
main() from the command line: tests/test_torch_train_cli.py.

cutie_tpu's side of the resume comparison runs its own run_stage with its
Trainer replaced by a stand-in that records each step (no JAX training):
what is compared is the stream's control flow, which the stand-in leaves
as it is. Bars: the sequences of (it, epoch, max_skip) are equal; every
loss finite.
"""
import math
from os import path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from tests.test_torch_jpeg import FIXTURES  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch import train as port_train  # noqa: E402
from cutie_tpu_torch.config import model_small  # noqa: E402
from cutie_tpu_torch.utils.logger import TensorboardLogger  # noqa: E402

SIZE = 48


def small_cfg(train_config, subset=None):
    """A train_config (either package's) with model_small, the fixture
    datasets (the VOS videos listed in the file `subset`, or all), and
    stages cut to T=3, 48x48, batch 2, 32 points."""
    from cutie_tpu.config import model_small as ref_model_small

    cfg = train_config()
    cfg.model = model_small() if train_config is port_train.train_config else \
        ref_model_small()
    cfg.merge({
        "num_workers": 2, "log_text_interval": 2, "log_image_interval": 2,
        "save_weights_interval": 1000, "save_checkpoint_interval": 1000,
        "data": {
            "image_datasets": {"base": str(FIXTURES),
                               "FIXTURE": {"directory": "static", "data_structure": 1,
                                           "multiplier": 1}},
            "vos_datasets": {"base": str(FIXTURES / "vos"),
                             "FIXTURE": {"image_directory": "JPEGImages",
                                         "mask_directory": "Annotations",
                                         "multiplier": 1, "frame_interval": 1,
                                         "subset": subset, "empty_masks": None}},
            "pre_training": {"datasets": ["FIXTURE"]},
            "main_training": {"datasets": ["FIXTURE"]},
        },
    })
    stage = {"batch_size": 2, "seq_length": 3, "crop_size": [SIZE, SIZE],
             "train_num_points": 32}
    cfg.pre_training.merge({**stage, "num_iterations": 2, "num_objects": 1})
    cfg.main_training.merge({**stage, "num_iterations": 4, "num_objects": 2,
                             "num_ref_frames": 2, "lr_schedule_steps": [3],
                             "max_skip_schedule": [2, 3],
                             "max_skip_schedule_fraction": [0.0, 0.5]})
    return cfg


def test_two_stage_run_stage_handoff_curriculum_and_files(tmp_path):
    from cutie_tpu_torch.utils.get_default_model import apply_object_surgery

    cfg = small_cfg(port_train.train_config)
    run_path = str(tmp_path / "run")
    logger = TensorboardLogger(None, enabled=False)
    images = []
    logger.log_image = lambda tag, img, it: images.append((tag, img.shape, img.dtype))

    pre_trace = []
    sd = port_train.run_stage(cfg, cfg.pre_training, None, run_path, logger,
                              device="cpu", trace=pre_trace)
    assert path.exists(path.join(run_path, "weights_pre_training_final.npz"))
    assert [r["it"] for r in pre_trace] == [0, 1]
    assert sd["mask_encoder.conv1.weight"].shape[1] == 4   # single object
    handed = apply_object_surgery(sd, False, cfg.model.sensory_dim, cfg.model.value_dim)
    assert handed["mask_encoder.conv1.weight"].shape[1] == 5

    trace = []
    sd2 = port_train.run_stage(cfg, cfg.main_training, handed, run_path, logger,
                               device="cpu", trace=trace)
    # the curriculum: max_skip 2 until it = 0.5 * 4, then the loader is
    # rebuilt at max_skip 3 and a new epoch starts
    assert [(r["it"], r["epoch"], r["max_skip"]) for r in trace] == \
        [(0, 0, 2), (1, 0, 2), (2, 1, 3), (3, 1, 3)]
    assert all(math.isfinite(v) for r in pre_trace + trace for v in r["losses"].values())
    assert {"loss_ce", "loss_dice", "total_loss"} <= set(trace[0]["losses"])
    for name in ("weights_main_training_final.npz", "checkpoint_final.pt"):
        assert path.exists(path.join(run_path, name)), name
    ckpt = torch.load(path.join(run_path, "checkpoint_final.pt"), weights_only=True)
    assert ckpt["it"] == 4
    assert any(not np.array_equal(sd2[k], handed[k]) for k in handed)
    # image grids every log_image_interval (reference trainer.py:113-118)
    assert [t for t, _, _ in images] == ["train/pre_training", "train/main_training",
                                         "train/main_training"]
    assert all(dt == np.uint8 and shape[-1] == 3 for _, shape, dt in images)


class _RecordingTrainer:
    """Stands in for cutie_tpu's Trainer: resumes at a given iteration and
    records every step's iteration with the (max_skip, epoch) of the epoch
    being served."""
    resume_it = 0
    steps = []
    serving = {}

    def __init__(self, **kwargs):
        self.it = 0
        self.last_logits = None

    def load_checkpoint(self, p):
        self.it = self.resume_it

    def upload_batch(self, data):
        return data

    def do_pass(self, data, it, rng):
        self.steps.append((it,) + self.serving["epoch"])
        return {"total_loss": 0.0}

    def save_weights(self, p):
        pass

    def save_checkpoint(self, p):
        pass

    def get_variables(self):
        return None


def _recording_setup(module, calls, serving):
    """Wrap module.setup_main_training_datasets so that every loader built
    records (max_skip, epoch) for each epoch it starts, in `calls` and as
    serving['epoch']."""
    original = module.setup_main_training_datasets

    def setup(cfg, stage_cfg, max_skip, seed=0):
        dataset, loader = original(cfg, stage_cfg, max_skip, seed=seed)
        epoch = loader.epoch

        def recorded(e):
            calls.append((max_skip, e))
            serving["epoch"] = (max_skip, e)
            return epoch(e)

        loader.epoch = recorded
        return dataset, loader

    return setup


@pytest.mark.parametrize("resume_it,total", [(7, 9), (2, 6)])
def test_resume_matches_cutie_tpu(tmp_path, monkeypatch, resume_it, total):
    """A main-training run resumed from a checkpoint at `resume_it`, on one
    fixture video (12 frames: 6 batches an epoch): the port takes the steps
    cutie_tpu's run_stage takes, at the same epoch and max_skip."""
    import cutie_tpu.data.setup_training_data as ref_setup
    import cutie_tpu.training.trainer as ref_trainer
    from cutie_tpu import train as ref_train
    from cutie_tpu.utils.logger import TensorboardLogger as RefLogger

    import cutie_tpu_torch.data.setup_training_data as port_setup
    from cutie_tpu_torch.training.trainer import Trainer
    from cutie_tpu_torch.utils.get_default_model import build_model

    def configure(cfg):
        cfg.main_training.merge({"num_iterations": total,
                                 "max_skip_schedule_fraction": [0.0, 0.5]})
        cfg.log_image_interval = 1000
        return cfg

    subset = tmp_path / "subset.txt"
    subset.write_text("synth_a\n")
    # cutie_tpu, with the recording stand-in
    ref_calls = []
    _RecordingTrainer.resume_it, _RecordingTrainer.steps = resume_it, []
    monkeypatch.setattr(ref_trainer, "Trainer", _RecordingTrainer)
    monkeypatch.setattr(ref_setup, "setup_main_training_datasets",
                        _recording_setup(ref_setup, ref_calls, _RecordingTrainer.serving))
    rcfg = configure(small_cfg(ref_train.train_config, subset=str(subset)))
    rcfg.checkpoint = "resume"
    ref_train.run_stage(rcfg, rcfg.main_training, None, str(tmp_path / "ref"),
                        RefLogger(None, enabled=False))
    assert rcfg.checkpoint is None

    # the port, training for real from a checkpoint at resume_it
    cfg = configure(small_cfg(port_train.train_config, subset=str(subset)))
    mcfg = cfg.copy()
    mcfg.amp = cfg.main_training.amp
    model = build_model(mcfg, device="cpu")
    trainer = Trainer(mcfg, cfg.main_training, model)
    trainer.it = trainer.updates = resume_it
    ckpt = str(tmp_path / "resume.pt")
    trainer.save_checkpoint(ckpt)
    cfg.checkpoint = ckpt
    port_calls, trace = [], []
    monkeypatch.setattr(port_setup, "setup_main_training_datasets",
                        _recording_setup(port_setup, port_calls, {}))
    port_train.run_stage(cfg, cfg.main_training, model.state_dict(), str(tmp_path / "port"),
                         TensorboardLogger(None, enabled=False), device="cpu", trace=trace)
    assert cfg.checkpoint is None

    assert [(r["it"], r["max_skip"], r["epoch"]) for r in trace] == _RecordingTrainer.steps
    assert [r["it"] for r in trace] == list(range(resume_it, total))
    assert port_calls == ref_calls
    assert all(math.isfinite(r["losses"]["total_loss"]) for r in trace)
