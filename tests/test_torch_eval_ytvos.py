"""A YouTubeVOS-style run through the port's eval harness and cutie_tpu's,
live (tests/test_eval_formats.py:107-160): object 1 annotated at frame 0,
object 2 first at frame 4 (use_all_masks), meta.json's required frames,
and background-only annotations at frames 2 and 6, which reach the
empty-mask guard. In a module of its own, so that --dist loadfile gives it
a worker."""
import json
import os

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cutie_tpu_torch import eval_vos as port_eval  # noqa: E402
from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.utils.image_io import read_png  # noqa: E402
from cutie_tpu_torch.utils.palette import davis_palette  # noqa: E402
from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def synchronous_jax_dispatch():
    """See tests/test_torch_amp.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def test_ytvos_style_run_matches_cutie_tpu(tmp_path, monkeypatch):
    """The same saved files and, frame by frame, the same object ids in
    both harnesses' masks, agreeing at tests/test_eval_formats.py's bar
    (> 0.97); the background-only frames saved as background. (The
    background-only frames skip a segmentation, so the stream is not the
    one stream_small_adddel.npz recorded.)"""
    import cutie_tpu.eval_vos as jax_eval
    from cutie_tpu.config import eval_config as jax_eval_config
    from tests.test_eval_formats import _patch_build_model

    rec = dict(np.load(require_golden("stream_small_adddel.npz")))
    frames, mask0, mask2 = rec["frames"], rec["mask0"], rec["mask2"]
    img_dir = tmp_path / "JPEGImages" / "vid"
    mask_dir = tmp_path / "Annotations" / "vid"
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    names = []
    for ti in range(8):
        arr = (np.transpose(frames[ti], (1, 2, 0)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"{ti:05d}.png")
        names.append(f"{ti:05d}")
    background = np.zeros_like(mask0)
    for ti, m in {0: np.where(mask0 == 1, 1, 0), 2: background, 4: mask2,
                  6: background}.items():
        pm = Image.fromarray(m.astype(np.uint8), mode="P")
        pm.putpalette(davis_palette)
        pm.save(mask_dir / f"{ti:05d}.png")
    meta = {"videos": {"vid": {"objects": {"1": {"frames": names},
                                           "2": {"frames": names[4:]}}}}}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    block = {"image_directory": str(tmp_path / "JPEGImages"),
             "mask_directory": str(tmp_path / "Annotations"),
             "json_directory": str(tmp_path / "meta.json"),
             "size": -1, "save_all": False, "use_all_masks": True,
             "use_long_term": False, "mem_every": 3}
    settings = {"dataset": "y-tiny", "mem_every": 3, "max_mem_frames": 4}

    cfg = eval_config("small")
    cfg.merge(dict(settings, output_dir=str(tmp_path / "port"),
                   weights=str(require_golden("state_dict_small.npz"))))
    cfg.datasets["y-tiny"] = block
    assert port_eval.eval_vos(cfg, device="cpu")["total_frames"] == 8
    jcfg = jax_eval_config("small")
    jcfg.merge(dict(settings, output_dir=str(tmp_path / "jax"), weights=None))
    jcfg.datasets["y-tiny"] = block
    _patch_build_model(monkeypatch, jcfg)
    assert jax_eval.eval_vos(jcfg)["total_frames"] == 8

    port_dir, jax_dir = (tmp_path / run / "Annotations" / "vid" for run in ("port", "jax"))
    saved = sorted(os.listdir(port_dir))
    assert saved == sorted(os.listdir(jax_dir)) == [f"{n}.png" for n in names]
    for name in saved:
        ours, mode, palette = read_png(str(port_dir / name))
        theirs = np.array(Image.open(jax_dir / name))
        assert mode == "P" and palette == Image.open(jax_dir / name).getpalette()
        assert np.unique(ours).tolist() == np.unique(theirs).tolist(), name
        assert (ours == theirs).mean() > 0.97, name
    for ti in (2, 6):
        assert not read_png(str(port_dir / f"{ti:05d}.png"))[0].any()
