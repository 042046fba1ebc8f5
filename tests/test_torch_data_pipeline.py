"""The port's training data pipeline (cutie_tpu_torch/data/) against
cutie_tpu/data/ on the committed fixtures (tests/torch_fixtures/): both
datasets' get(idx, rng) and ShardedLoader's batches on the same roots and
seeds, the two-process shard split, and the dataset registry.

Bar: equal. Every op of the pipeline is bit-equal to cutie_tpu's cv2 and
Pillow calls (tests/test_torch_augment.py, tests/test_torch_jpeg.py), so
frames (the port's [T, 3, H, W] against cutie_tpu's [T, H, W, 3]), masks,
class maps, first-frame masks, selectors and sample info are all equal.
"""
import os
from os import path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from tests.test_torch_jpeg import FIXTURES  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.data import loader as port_loader  # noqa: E402
from cutie_tpu_torch.data.static_dataset import SyntheticVideoDataset  # noqa: E402
from cutie_tpu_torch.data.vos_dataset import VOSMergeTrainDataset  # noqa: E402

MASK_KEYS = ("first_frame_gt", "cls_gt", "selector")


def vos_configs():
    root = FIXTURES / "vos"
    return {"fixture": {"im_root": str(root / "JPEGImages"),
                        "gt_root": str(root / "Annotations"), "max_skip": 3,
                        "subset": None, "empty_masks": None, "multiplier": 1}}


def static_params():
    return [(str(FIXTURES / "static"), 1, 1)]


def assert_frames_equal(port_frames, ref_frames):
    """port [..., T, 3, H, W] against cutie_tpu's [..., T, H, W, 3]."""
    ref = np.moveaxis(np.asarray(ref_frames), -1, -3)
    assert port_frames.dtype == np.float32
    np.testing.assert_array_equal(port_frames, ref)


def assert_sample_equal(port, ref):
    assert_frames_equal(port["rgb"], ref["rgb"])
    for k in MASK_KEYS:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert port["info"] == ref["info"]


@pytest.mark.parametrize("merge", [0.0, 1.0])
def test_vos_dataset_matches_cutie_tpu(merge):
    """VOSMergeTrainDataset.get on the fixture videos at T=4, 3 objects,
    a 64x64 crop, with and without the blurred two-sequence merge."""
    from cutie_tpu.data.vos_dataset import VOSMergeTrainDataset as Ref

    kw = dict(seq_length=4, max_num_obj=3, size=64, merge_probability=merge)
    port, ref = VOSMergeTrainDataset(vos_configs(), **kw), Ref(vos_configs(), **kw)
    assert len(port) == len(ref) == 36
    assert port.video_frames == ref.video_frames
    for idx in (0, 17, 35):
        for seed in (0, 1):
            a = port.get(idx, np.random.default_rng(seed))
            b = ref.get(idx, np.random.default_rng(seed))
            assert a["rgb"].shape == (4, 3, 64, 64)
            assert_sample_equal(a, b)


def test_static_dataset_matches_cutie_tpu():
    """SyntheticVideoDataset.get on the fixture images (about 384x512) at
    T=3, up to 2 objects, a 96x96 crop."""
    from cutie_tpu.data.static_dataset import SyntheticVideoDataset as Ref

    kw = dict(size=96, seq_length=3, max_num_obj=2)
    port, ref = SyntheticVideoDataset(static_params(), **kw), Ref(static_params(), **kw)
    assert port.im_list == ref.im_list and len(port) == 16
    for idx, seed in ((0, 0), (5, 1), (11, 2), (15, 3)):
        a = port.get(idx, np.random.default_rng(seed))
        b = ref.get(idx, np.random.default_rng(seed))
        assert a["rgb"].shape == (3, 3, 96, 96)
        assert_sample_equal(a, b)


def test_sharded_loader_matches_cutie_tpu_and_splits_by_process():
    """ShardedLoader batches of both datasets equal cutie_tpu's (frames
    channels first, cls_gt uint8 [B, T, H, W]); two processes' halves
    make up the global batch; the stream repeats for the same seed and
    epoch."""
    from cutie_tpu.data.loader import ShardedLoader as RefLoader
    from cutie_tpu.data.static_dataset import SyntheticVideoDataset as RefStatic
    from cutie_tpu.data.vos_dataset import VOSMergeTrainDataset as RefVOS

    pairs = [
        (VOSMergeTrainDataset(vos_configs(), seq_length=3, size=48, merge_probability=0.5),
         RefVOS(vos_configs(), seq_length=3, size=48, merge_probability=0.5)),
        (SyntheticVideoDataset(static_params(), size=48, seq_length=3, max_num_obj=2),
         RefStatic(static_params(), size=48, seq_length=3, max_num_obj=2)),
    ]
    for port_ds, ref_ds in pairs:
        port = port_loader.ShardedLoader(port_ds, 4, seed=7, num_workers=3)
        ref = RefLoader(ref_ds, 4, seed=7, num_workers=3)
        assert port.batches_per_epoch() == ref.batches_per_epoch()
        it_p, it_r = iter(port.epoch(1)), iter(ref.epoch(1))
        first = None
        for _ in range(2):
            a, b = next(it_p), next(it_r)
            first = first or a
            assert a["cls_gt"].dtype == np.uint8 and a["cls_gt"].shape == b["cls_gt"].shape
            assert_frames_equal(a["frames"], b["frames"])
            for k in MASK_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["info"] == b["info"]
        it_p.close()
        it_r.close()
        again = next(iter(port.epoch(1)))
        np.testing.assert_array_equal(again["frames"], first["frames"])
        halves = [next(iter(port_loader.ShardedLoader(
            port_ds, 4, seed=7, num_workers=2, process_index=r, process_count=2).epoch(1)))
            for r in (0, 1)]
        for k in ("frames",) + MASK_KEYS:
            np.testing.assert_array_equal(
                np.concatenate([h[k] for h in halves]), first[k], err_msg=k)
    with pytest.raises(ValueError, match="divide"):
        port_loader.ShardedLoader(pairs[0][0], 3, process_count=2)


def test_process_rank_comes_from_torch_distributed(tmp_path, monkeypatch):
    """The loaders shard by torch.distributed's rank and world size when a
    process group is initialised (here gloo, one process, reporting rank 1
    of 2), else as the only process."""
    import torch.distributed as dist

    from cutie_tpu_torch.data import setup_training_data as setup
    from cutie_tpu_torch.train import train_config

    cfg = train_config()
    cfg.data.image_datasets.base = str(FIXTURES)
    cfg.data.image_datasets.FSS.merge({"directory": "static", "data_structure": 1})
    cfg.data.pre_training.datasets = ["FSS"]
    cfg.pre_training.batch_size = 4
    loader = setup.setup_pre_training_datasets(cfg, cfg.pre_training)[1]
    assert (loader.process_index, loader.process_count, loader.local_batch) == (0, 1, 4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    try:
        assert setup.process_rank() == (0, 1)
        monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
        monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
        loader = setup.setup_pre_training_datasets(cfg, cfg.pre_training)[1]
        assert (loader.process_index, loader.process_count, loader.local_batch) == (1, 2, 2)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


def test_training_data_registry_ships_complete(tmp_path):
    """The port's counterpart of tests/test_data_pipeline.py::
    test_training_data_registry_ships_complete: every subset and
    empty-mask index of train_config() resolves to a file shipped with the
    port, the presets overlay the reference's mixes and schedules, and
    data.preset=mega builds the five-dataset sampler on a tiny tree."""
    from cutie_tpu_torch.data.setup_training_data import (load_empty_masks, load_subset,
                                                          setup_main_training_datasets)
    from cutie_tpu_torch.train import DATA_PRESETS, apply_data_preset, train_config
    from cutie_tpu_torch.utils.image_io import write_png

    cfg = train_config()
    registry = cfg.data.vos_datasets
    for name in ["DAVIS", "YouTubeVOS", "MOSE", "BURST", "OVIS"]:
        d = registry[name]
        assert d.empty_masks.startswith(path.dirname(path.dirname(
            path.abspath(port_loader.__file__)))), d.empty_masks
        if d.get("subset"):
            assert len(load_subset(d.subset)) > 10, name
        em = load_empty_masks(d.empty_masks)
        assert isinstance(em, dict) and len(em) > 0, name
    assert "bear" in load_subset(registry.DAVIS.subset)
    assert len(load_subset(registry.YouTubeVOS.subset)) > 3000

    apply_data_preset(cfg, "with-mose")
    assert cfg.data.main_training.datasets == ["DAVIS", "YouTubeVOS", "MOSE"]
    apply_data_preset(cfg, "mega")
    assert cfg.data.main_training.datasets == ["DAVIS", "YouTubeVOS", "MOSE",
                                               "BURST", "OVIS"]
    assert cfg.main_training.num_iterations == 175000
    assert cfg.main_training.lr_schedule_steps == [140000, 160000]
    assert set(DATA_PRESETS) == {"base", "with-mose", "mega"}

    rng = np.random.default_rng(0)
    names = {"DAVIS": "bear", "YouTubeVOS": "003234408d", "MOSE": "vid_m",
             "BURST": "vid_b", "OVIS": "vid_o"}
    for name, vid in names.items():
        d = registry[name]
        d.image_directory, d.mask_directory = f"{name}/JPEGImages", f"{name}/Annotations"
        os.makedirs(tmp_path / name / "JPEGImages" / vid)
        os.makedirs(tmp_path / name / "Annotations" / vid)
        for ti in range(4):
            img = rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8)
            mask = np.zeros((60, 80), np.uint8)
            mask[10:40, 20:60] = 1
            Image.fromarray(img).save(tmp_path / name / "JPEGImages" / vid / f"{ti:05d}.jpg")
            write_png(str(tmp_path / name / "Annotations" / vid / f"{ti:05d}.png"), mask,
                      palette=[0, 0, 0, 128, 0, 0])
    cfg.data.vos_datasets.base = str(tmp_path)
    cfg.main_training.merge({"seq_length": 3, "num_objects": 2, "crop_size": [48, 48],
                             "batch_size": 2, "merge_probability": 0.5})
    cfg.num_workers = 0
    dataset, loader = setup_main_training_datasets(cfg, cfg.main_training, max_skip=5,
                                                   seed=0)
    assert set(dataset.videos) == set(names)
    for name, vid in names.items():
        assert dataset.videos[name] == [vid], name
    batch = next(iter(loader.epoch(0)))
    assert batch["frames"].shape == (2, 3, 3, 48, 48)


def test_convert_burst_to_vos_train_matches_cutie_tpu(tmp_path):
    """The port's BURST-to-VOS converter and scripts/convert_burst_to_vos_train.py
    on a tiny BURST JSON (two sequences, two objects, every frame copied
    too): the same files; masks with the same pixels, mode and palette as
    Pillow reads them; frames byte-equal."""
    import json
    import subprocess
    import sys

    from cutie_tpu_torch.scripts.convert_burst_to_vos_train import main
    from cutie_tpu_torch.utils import rle

    rng = np.random.default_rng(0)
    h, w = 24, 32
    sequences = []
    for dataset, seq in (("LaSOT", "cat-1"), ("YFCC100M", "v_00ab")):
        names = [f"frame{t:04d}.jpg" for t in range(4)]
        os.makedirs(tmp_path / "frames" / dataset / seq)
        for name in names:
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
                tmp_path / "frames" / dataset / seq / name)
        segmentations = []
        for t in range(3):
            seg = {}
            for obj in (1, 7):
                m = np.zeros((h, w), np.uint8)
                m[2 + t + obj:12 + obj, 3 * obj % w:3 * obj % w + 9] = 1
                seg[str(obj)] = {"rle": rle.encode(m)["counts"]}
            segmentations.append(seg)
        sequences.append({"dataset": dataset, "seq_name": seq, "width": w, "height": h,
                          "segmentations": segmentations,
                          "annotated_image_paths": names[:3], "all_image_paths": names})
    json_path = tmp_path / "train.json"
    json_path.write_text(json.dumps({"sequences": sequences}))

    def args(out):
        return ["--json_path", str(json_path), "--frames_path", str(tmp_path / "frames"),
                "--output_path", str(out), "--save_all_image", "--num_proc", "2"]

    repo = path.dirname(path.dirname(path.abspath(__file__)))
    subprocess.run([sys.executable, path.join(repo, "scripts", "convert_burst_to_vos_train.py"),
                    *args(tmp_path / "ref")], check=True, cwd=repo, timeout=300)
    main(args(tmp_path / "port"))

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    assert files(tmp_path / "port") == files(tmp_path / "ref")
    assert len(files(tmp_path / "ref")) == 2 * (3 + 3 + 4)
    for rel in files(tmp_path / "ref"):
        a, b = tmp_path / "port" / rel, tmp_path / "ref" / rel
        if rel.endswith(".png"):
            with Image.open(a) as pa, Image.open(b) as pb:
                assert pa.mode == pb.mode == "P"
                np.testing.assert_array_equal(np.array(pa), np.array(pb))
                assert pa.getpalette() == pb.getpalette()
            assert set(np.unique(np.array(Image.open(a)))) == {0, 1, 7}
        else:
            assert a.read_bytes() == b.read_bytes(), rel
