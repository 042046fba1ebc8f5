"""python -m cutie_tpu_torch.train on the CPU (the port's train.py:main):
both stages on the committed fixtures (tests/torch_fixtures/) through the
command-line overrides, with model_small, one step each. In a module of its
own so that the slow tests of the entry spread over two workers."""
import os

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_jpeg import FIXTURES  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401
from tests.test_torch_train_entry import SIZE  # noqa: E402

from cutie_tpu_torch import train as port_train  # noqa: E402


def test_main_trains_both_stages_from_the_command_line(tmp_path, monkeypatch):
    """python -m cutie_tpu_torch.train ... device=cpu: one step of each
    stage, the hand-off between them, files under output/<exp_id>; without
    device=cpu and without a card it raises."""
    monkeypatch.chdir(tmp_path)
    argv = [
        "exp_id=cli", "model=small", "num_workers=2",
        f"data.image_datasets.base={FIXTURES}",
        "data.image_datasets.FSS.directory=static",
        "data.image_datasets.FSS.data_structure=1",
        'data.pre_training.datasets=["FSS"]',
        f"data.vos_datasets.base={FIXTURES / 'vos'}",
        "data.vos_datasets.DAVIS.image_directory=JPEGImages",
        "data.vos_datasets.DAVIS.mask_directory=Annotations",
        "data.vos_datasets.DAVIS.subset=null",
        "data.vos_datasets.DAVIS.empty_masks=null",
        "data.vos_datasets.DAVIS.frame_interval=1",
        'data.main_training.datasets=["DAVIS"]',
    ]
    for stage in ("pre_training", "main_training"):
        argv += [f"{stage}.num_iterations=1", f"{stage}.batch_size=2",
                 f"{stage}.seq_length=3", f"{stage}.crop_size=[{SIZE},{SIZE}]",
                 f"{stage}.train_num_points=32"]
    argv += ["main_training.num_objects=2", "main_training.num_ref_frames=2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            port_train.main(argv)
    sd = port_train.main(argv + ["device=cpu"])
    assert sd["mask_encoder.conv1.weight"].shape[1] == 5
    run = tmp_path / "output" / "cli"
    for name in ("weights_pre_training_final.npz", "weights_main_training_final.npz",
                 "checkpoint_final.pt", "train_rank0.log"):
        assert (run / name).exists(), name
    assert os.path.getsize(run / "train_rank0.log") > 0
