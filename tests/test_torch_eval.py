"""The port's eval harness and scripting API on the CPU, at the small width
(state_dict_small.npz): eval_vos against the port's own InferenceCore and
the recorded masks (tests/test_eval_harness.py's tiny DAVIS directory),
the reader's resize, score dumps and merge_multi_scale, the BURST layout
against cutie_tpu's harness, the weights routes and the object surgery
against cutie_tpu's arrays, process_video and both demos."""
import json
import os
import shutil
import subprocess
import sys
from os import path

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cutie_tpu_torch import eval_vos as port_eval  # noqa: E402
from cutie_tpu_torch import scripting_demo, scripting_demo_add_del_objects  # noqa: E402
from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.ops.resize import bilinear_resize  # noqa: E402
from cutie_tpu_torch.scripts import process_video  # noqa: E402
from cutie_tpu_torch.utils import rle  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import (  # noqa: E402
    apply_object_surgery, build_model, get_default_model, load_torch_npz,
    load_weights)
from cutie_tpu_torch.utils.image_io import read_png, resize_shorter  # noqa: E402
from cutie_tpu_torch.utils.palette import davis_palette  # noqa: E402
from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

REPO = path.dirname(path.dirname(path.abspath(__file__)))
SETTINGS = {"mem_every": 3, "max_mem_frames": 3}
TINY = {"size": -1, "save_all": True, "use_all_masks": False,
        "use_long_term": False, "mem_every": 3}


@pytest.fixture(autouse=True, scope="module")
def synchronous_jax_dispatch():
    """See tests/test_torch_amp.py: a torch read right after a JAX one came
    out perturbed with JAX's asynchronous CPU dispatch."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def _weights():
    return str(require_golden("state_dict_small.npz"))


def _frames_u8(frames):
    """The frames as tests/test_eval_harness.py writes them."""
    return [(np.transpose(f, (1, 2, 0)) * 255).astype(np.uint8) for f in frames]


def _write_davis(root, frames, masks, palette=davis_palette, video="video1"):
    """Pillow-written PNG frames and palette masks {frame index: mask}."""
    img_dir, mask_dir = root / "JPEGImages" / video, root / "Annotations" / video
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    for ti, arr in enumerate(_frames_u8(frames)):
        Image.fromarray(arr).save(img_dir / f"{ti:05d}.png")
    for ti, m in masks.items():
        im = Image.fromarray(m.astype(np.uint8), mode="P")
        im.putpalette(palette)
        im.save(mask_dir / f"{ti:05d}.png")


def _port_cfg(out_dir, dataset_block, dataset="tiny", **extra):
    cfg = eval_config("small")
    cfg.merge(dict(SETTINGS, dataset=dataset, output_dir=str(out_dir),
                   weights=_weights(), **extra))
    cfg.datasets[dataset] = dataset_block
    return cfg


def _core_masks(frames, steps, size=None):
    """The port's InferenceCore at the harness's settings over uint8 frames:
    steps {ti: (mask, objects)}; each output resized to `size` as the saver
    does, then its object-id map."""
    cfg = eval_config("small")
    cfg.merge(dict(SETTINGS, use_long_term=False))
    core = InferenceCore(build_model(cfg, _weights(), device="cpu"), cfg)
    out = []
    for ti, frame in enumerate(frames):
        mask, objects = steps.get(ti, (None, None))
        prob = core.step(frame, mask, objects, end=ti == len(frames) - 1)
        if size is not None:
            prob = bilinear_resize(prob, *size)
        out.append(core.output_prob_to_mask(prob))
    return out


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """tests/test_eval_harness.py's tiny DAVIS directory through the port's
    eval_vos on the CPU at size -1, with score dumps and visualizations."""
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    root = tmp_path_factory.mktemp("tiny")
    _write_davis(root, rec["frames"], {0: rec["mask0"]})
    out = root / "run"
    cfg = _port_cfg(out, dict(TINY, image_directory=str(root / "JPEGImages"),
                              mask_directory=str(root / "Annotations")),
                    save_scores=True, visualize=True)
    stats = port_eval.eval_vos(cfg, device="cpu")
    return root, out, rec, stats


def test_eval_vos_equals_inference_core(tiny_run):
    """At size -1 the harness adds no numerics: its saved masks equal the
    port's own InferenceCore run over the same frames, and they track the
    recorded masks at tests/test_eval_harness.py's bar."""
    root, out, rec, stats = tiny_run
    t = rec["frames"].shape[0]
    assert stats["total_frames"] == t
    want = _core_masks(_frames_u8(rec["frames"]), {0: (rec["mask0"], [1, 2])})
    agree = []
    for ti in range(t):
        saved, mode, palette = read_png(str(out / "Annotations" / "video1" / f"{ti:05d}.png"))
        assert mode == "P" and palette == list(davis_palette)
        np.testing.assert_array_equal(saved, want[ti])
        agree.append((saved == rec["probs"][ti].argmax(0)).mean())
    assert min(agree) > 0.97, agree
    assert path.exists(out / "Visualizations" / "video1" / "00000.jpg")


def test_eval_vos_resizes_like_the_reader(tmp_path):
    """size=64 makes the reader resize the 96x128 frames (Pillow's
    BILINEAR) and the first mask (NEAREST); the saver resizes the output
    back to 96x128. Equal to the same steps done by hand, and the score
    dumps are at the original size."""
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    _write_davis(tmp_path, rec["frames"][:6], {0: rec["mask0"]})
    cfg = _port_cfg(tmp_path / "run", dict(
        TINY, size=64, image_directory=str(tmp_path / "JPEGImages"),
        mask_directory=str(tmp_path / "Annotations")), save_scores=True)
    port_eval.eval_vos(cfg, device="cpu")
    frames = [resize_shorter(f, 64, bilinear=True) for f in _frames_u8(rec["frames"][:6])]
    assert frames[0].shape == (64, 85, 3)
    mask0 = resize_shorter(rec["mask0"].astype(np.uint8), 64, bilinear=False)
    want = _core_masks(frames, {0: (mask0.astype(np.int64), [1, 2])}, size=(96, 128))
    for ti in range(6):
        saved = read_png(str(tmp_path / "run" / "Annotations" / "video1" / f"{ti:05d}.png"))[0]
        np.testing.assert_array_equal(saved, want[ti])
        dump = np.load(tmp_path / "run" / "Scores" / "video1" / f"{ti:05d}.npz")["prob"]
        assert dump.shape == (3, 96, 128) and dump.dtype == np.uint8


def test_merge_multi_scale_of_the_score_dump(tiny_run, tmp_path):
    """tests/test_eval_harness.py's merge check on the port's dumps: the
    native dump merged with a copy of itself, through the port's script
    (two spawned workers), gives the argmax of the summed uint8 dumps
    mapped back to object ids."""
    _, out, rec, _ = tiny_run
    scale2 = tmp_path / "scale2"
    shutil.copytree(out / "Scores", scale2)
    merged = tmp_path / "merged"
    subprocess.run([sys.executable, "-m", "cutie_tpu_torch.scripts.merge_multi_scale",
                    "--dataset", "D", "--list", str(out / "Scores"), str(scale2),
                    "--output", str(merged), "--num_proc", "2"],
                   check=True, cwd=REPO, timeout=300)
    sc = out / "Scores" / "video1"
    backward = {int(k): int(v) for k, v in dict(np.load(sc / "backward.npz")).items()}
    assert backward == {1: 1, 2: 2}
    for ti in range(rec["frames"].shape[0]):
        prob = np.load(sc / f"{ti:05d}.npz")["prob"].astype(np.float32)
        winner = np.argmax(prob + prob, axis=0)
        expect = np.zeros_like(winner, dtype=np.uint8)
        for obj_id, tmp_idx in backward.items():
            expect[winner == tmp_idx] = obj_id
        got, _, palette = read_png(str(merged / "video1" / f"{ti:05d}.png"))
        np.testing.assert_array_equal(got, expect)
        assert palette == list(davis_palette)
    assert path.exists(str(merged) + ".zip")


def _burst_layout(root, frames, mask0):
    """tests/test_eval_formats.py:38-80's mini BURST layout."""
    seq_dir = root / "frames" / "ds" / "seq1"
    os.makedirs(seq_dir)
    names = []
    for ti, arr in enumerate(_frames_u8(frames[:6])):
        names.append(f"{ti:05d}.png")
        Image.fromarray(arr).save(seq_dir / names[-1])
    segms = [{"1": {"rle": rle.encode((mask0 == 1).astype(np.uint8))["counts"]},
              "2": {"rle": rle.encode((mask0 == 2).astype(np.uint8))["counts"]}}]
    segms += [{} for _ in range(5)]
    h, w = mask0.shape
    burst_json = {"sequences": [{
        "dataset": "ds", "seq_name": "seq1", "width": w, "height": h,
        "all_image_paths": names, "annotated_image_paths": names,
        "segmentations": segms}], "split": "val"}
    json_path = root / "first_frame_annotations.json"
    json_path.write_text(json.dumps(burst_json))
    return {"image_directory": str(root / "frames"), "json_directory": str(json_path),
            "size": -1, "save_all": False, "use_long_term": False,
            "mem_every": 3, "skip_frames": -1}


def test_burst_matches_cutie_tpu(tmp_path, monkeypatch):
    """The BURST layout through both harnesses: the same sequences, frames
    and object ids; frame 0's input RLE copied verbatim; the port's
    predicted RLE decoding to exactly its own InferenceCore run's masks,
    and agreeing with cutie_tpu's at tests/test_eval_formats.py's bar."""
    import cutie_tpu.eval_vos as jax_eval
    from cutie_tpu.config import eval_config as jax_eval_config
    from tests.test_eval_formats import _patch_build_model

    rec = dict(np.load(require_golden("stream_small_work.npz")))
    block = _burst_layout(tmp_path, rec["frames"], rec["mask0"])
    cfg = _port_cfg(tmp_path / "port", block, dataset="burst-tiny")
    assert port_eval.eval_vos(cfg, device="cpu")["total_frames"] == 6
    jcfg = jax_eval_config("small")
    jcfg.merge({"dataset": "burst-tiny", "output_dir": str(tmp_path / "jax"),
                "weights": None, **SETTINGS})
    jcfg.datasets["burst-tiny"] = block
    _patch_build_model(monkeypatch, jcfg)
    assert jax_eval.eval_vos(jcfg)["total_frames"] == 6

    ours, theirs = (json.loads((tmp_path / run / "predictions.json").read_text())
                    for run in ("port", "jax"))
    assert ours.keys() == theirs.keys() and ours["split"] == "val"
    seq, jseq = ours["sequences"][0], theirs["sequences"][0]
    assert {k: v for k, v in seq.items() if k != "segmentations"} == \
        {k: v for k, v in jseq.items() if k != "segmentations"}
    assert len(seq["segmentations"]) == len(jseq["segmentations"]) == 6
    assert seq["segmentations"][0] == jseq["segmentations"][0] == \
        json.loads(json.dumps(_burst_frame0(rec["mask0"])))
    want = _core_masks(_frames_u8(rec["frames"][:6]), {0: (rec["mask0"], [1, 2])})
    h, w = rec["mask0"].shape
    for ti in range(1, 6):
        segs, jsegs = seq["segmentations"][ti], jseq["segmentations"][ti]
        assert sorted(segs) == sorted(jsegs) == ["1", "2"], (ti, segs.keys(), jsegs.keys())
        for obj in segs:
            m = rle.decode({"size": [h, w], "counts": segs[obj]["rle"]})
            jm = rle.decode({"size": [h, w], "counts": jsegs[obj]["rle"]})
            np.testing.assert_array_equal(m, want[ti] == int(obj))
            assert (m == jm).mean() > 0.97, (ti, obj)


def _burst_frame0(mask0):
    return {str(i): {"rle": rle.encode((mask0 == i).astype(np.uint8))["counts"]}
            for i in (1, 2)}


def test_weight_routes_match_cutie_tpu(tmp_path):
    """build_model takes a reference .pth (a training checkpoint's
    'network'), the torch-named npz and cutie_tpu's trainer npz (flax
    paths), and all three give the same model; the state dict read from
    the .pth equals cutie_tpu's importer's, and the object surgery's pads
    equal cutie_tpu's."""
    import jax.numpy as jnp
    from cutie_tpu.config import eval_config as jax_eval_config
    from cutie_tpu.models import CUTIE as JaxCUTIE
    from cutie_tpu.training.trainer import _flatten
    from cutie_tpu.utils import weight_import

    cfg = eval_config("small")
    sd = {k: v.astype(np.float32) if v.dtype == np.float64 else v
          for k, v in load_torch_npz(_weights()).items()}
    pth = tmp_path / "ckpt.pth"
    torch.save({"network": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    ours = load_weights(str(pth), cfg)
    theirs = weight_import.apply_object_surgery(
        weight_import.load_torch_checkpoint(str(pth)), False, 256, 256)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    jmodel = JaxCUTIE(jax_eval_config("small"))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2, 64, 64)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    flax_npz = tmp_path / "trainer.npz"
    np.savez(flax_npz, **_flatten(weight_import.convert_torch_state_dict(
        sd, zeros, strict=True)))
    direct = build_model(cfg, _weights(), device="cpu").state_dict()
    for route in (pth, flax_npz):
        got = build_model(cfg, str(route), device="cpu").state_dict()
        for k, v in direct.items():
            assert torch.equal(got[k], v), (route.name, k)

    single = dict(sd)
    single["mask_encoder.conv1.weight"] = sd["mask_encoder.conv1.weight"][:, :4]
    single["pixel_fuser.sensory_compress.weight"] = \
        sd["pixel_fuser.sensory_compress.weight"][:, :257]
    for single_object, source in ((False, single), (True, sd)):
        ours = apply_object_surgery(source, single_object, 256, 256)
        theirs = weight_import.apply_object_surgery(source, single_object, 256, 256)
        for k in ("mask_encoder.conv1.weight", "pixel_fuser.sensory_compress.weight"):
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
            assert ours[k].shape[1] == sd[k].shape[1] - single_object, k


def test_get_default_model_takes_local_weights():
    model, cfg = get_default_model(_weights_base(), device="cpu")
    assert cfg.mem_every == 5 and cfg.use_long_term is False and cfg.size == 480
    assert next(model.parameters()).device.type == "cpu"


def _weights_base():
    return str(require_golden("state_dict_base.npz"))


def test_process_video_images(tmp_path):
    """scripts/process_video.py --images on the CPU: a palette mask for
    every frame, with the given mask's palette."""
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    _write_davis(tmp_path, rec["frames"][:5], {0: rec["mask0"]})
    out = tmp_path / "out"
    process_video.main(["--images", str(tmp_path / "JPEGImages" / "video1"),
                        "--masks", str(tmp_path / "Annotations" / "video1"),
                        "--output", str(out), "--weights", _weights(),
                        "--model", "small", "--device", "cpu"])
    assert sorted(os.listdir(out)) == [f"{ti:05d}.png" for ti in range(5)]
    for ti in range(5):
        mask, mode, palette = read_png(str(out / f"{ti:05d}.png"))
        assert mode == "P" and palette == list(davis_palette)
        assert mask.shape == (96, 128) and set(np.unique(mask)) <= {0, 1, 2}


def test_scripting_demos(tmp_path, capsys):
    """Both demos on the CPU with the small weights: a mask for every
    frame, and the add/delete demo's objects [1] -> [1, 2] -> [2] across
    t = 4 and t = 10."""
    scripting_demo.main(["--weights", _weights(), "--model", "small",
                         "--device", "cpu", "--output", str(tmp_path / "demo")])
    assert sorted(os.listdir(tmp_path / "demo")) == [f"{t:05d}.png" for t in range(8)]
    capsys.readouterr()
    scripting_demo_add_del_objects.main(
        ["--weights", _weights(), "--device", "cpu", "--output", str(tmp_path / "ad")])
    lines = capsys.readouterr().out.strip().splitlines()
    objects = [json.loads(line.split("objects ")[1]) for line in lines]
    assert objects == [[1]] * 4 + [[1, 2]] * 6 + [[2]] * 4, lines
    assert sorted(os.listdir(tmp_path / "ad")) == [f"{t:05d}.png" for t in range(14)]


@pytest.mark.parametrize("entry", ["eval_vos", "scripting_demo",
                                   "scripting_demo_add_del_objects",
                                   "process_video"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without a device argument every entry point asks for the card, and
    raises where there is none; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only case")
    out = str(tmp_path / "out")
    run = {
        "eval_vos": lambda: port_eval.main([f"output_dir={out}", "model=small",
                                            "weights=null", "dataset=generic",
                                            f"image_directory={tmp_path}"]),
        "scripting_demo": lambda: scripting_demo.main(["--output", out]),
        "scripting_demo_add_del_objects":
            lambda: scripting_demo_add_del_objects.main(["--output", out]),
        "process_video": lambda: process_video.main(
            ["--images", str(tmp_path), "--masks", str(tmp_path), "--output", out]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA device"):
        run()
