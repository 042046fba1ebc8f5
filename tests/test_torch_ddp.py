"""Data-parallel training and the torchrun entries of the port on ranks
spawned under gloo on the CPU (tests/torch_parallel_ranks.py, no JAX in
them), small model, state_dict_small.npz.

- The gradient: each rank's rows of tiny_data(b=2), the Trainer's
  coalesced all-reduce, against jax.grad of the same functional (the mean
  over the batch rows of a fixed random linear functional of the outputs)
  over the global batch sharded on cutie_tpu's 2-device data mesh, every
  parameter within tests/test_torch_training.py's bar: the norm of the
  difference within 3e-2 of the reference's norm (or of 1e-3).
- Trainer.do_pass at world 2 against world 1 on the global batch: the
  ranks' parameters bit-equal after every step, and within rtol 1e-5 and
  atol 1e-6 of the one process's, a hundredth of the 1e-4 a step moves a
  parameter (tests/test_torch_training.py's AdamW bar): Adam divides a
  gradient near 0 by its own size, so the gradient's summation order,
  the only difference (both draw the same reference subsets, deep
  updates and loss points), moves such a parameter by more than its
  rtol.
- train.main and eval_vos.main started as torchrun starts them, device=cpu
  (faults F8 and F9): each joins the group, each rank takes its rows or
  videos, rank 0 alone writes the checkpoint.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_jpeg import FIXTURES  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401
from tests.test_torch_train_entry import SIZE  # noqa: E402
from tests.test_torch_train_model import (_synchronous_jax_dispatch,  # noqa: E402,F401
                                          jax_small)

from cutie_tpu_torch import eval_vos as port_eval  # noqa: E402
from cutie_tpu_torch.config import eval_config, get_dataset_cfg  # noqa: E402
from cutie_tpu_torch.data.setup_training_data import setup_pre_training_datasets  # noqa: E402
from cutie_tpu_torch.parallel import launch  # noqa: E402
from cutie_tpu_torch.parallel.launch import spawn_ranks  # noqa: E402
from cutie_tpu_torch.parallel.mesh import rank_device  # noqa: E402
from cutie_tpu_torch.train import train_config  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import from_jax_variables  # noqa: E402
from cutie_tpu_torch.utils.image_io import read_png, write_png  # noqa: E402
from cutie_tpu_torch.utils.palette import davis_palette  # noqa: E402


def test_all_reduced_gradient_matches_cutie_tpu_data_mesh():
    from cutie_tpu.parallel.mesh import make_mesh, shard_batch
    from cutie_tpu.train import train_config as jax_train_config
    from cutie_tpu.training.train_forward import train_forward as jax_train_forward

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    jmodel, jvars = jax_small()
    batch = ranks.tiny_batch()
    jdata = dict(batch, frames=np.ascontiguousarray(np.moveaxis(batch["frames"], 2, -1)))
    jstage = jax_train_config().main_training.merge(dict(
        seq_length=3, num_ref_frames=2, deep_update_prob=1.0, remat=False))

    def forward(params, data):
        return jax_train_forward(
            jmodel, {"params": params, "batch_stats": jvars["batch_stats"]}, data,
            jax.random.PRNGKey(0), jstage)

    shapes = {k: v.shape for k, v in
              jax.eval_shape(forward, jvars["params"], jdata).items()}
    weights = ranks.functional_weights(1, shapes)

    def functional(params, data):
        out = forward(params, data)
        return sum(jnp.sum(out[k] * weights[k]) for k in ranks.OUT_KEYS) / len(batch["frames"])

    mesh = make_mesh(2)
    grads = jax.jit(jax.grad(functional))(jvars["params"], shard_batch(mesh, jdata))
    ref = from_jax_variables({"params": grads})

    res = spawn_ranks(ranks.rank_functional_grads, 2, args=(weights,), threads=1,
                      timeout=300)
    assert [r["rank"] for r in res] == [(0, 2), (1, 2)]
    assert res[0]["digest"] == res[1]["digest"]   # every rank steps alike
    ours = res[0]["grads"]
    assert set(ours) == set(ref)
    for name, g in ours.items():
        err = np.linalg.norm(g - np.asarray(ref[name]))
        assert err < 3e-2 * max(np.linalg.norm(ref[name]), 1e-3), (name, err)


def test_two_rank_do_pass_matches_one_process():
    steps = 2
    res = spawn_ranks(ranks.rank_do_pass, 2, args=(steps,), threads=1, timeout=300)
    one = ranks.do_pass_steps(steps, world=1)
    assert res[0]["digests"] == res[1]["digests"]
    assert len(set(res[0]["digests"])) == steps   # the parameters moved
    # each rank's loss is the mean over its row
    np.testing.assert_allclose(np.mean([r["losses"] for r in res], axis=0),
                               one["losses"], rtol=1e-5)
    for name, p in res[0]["params"].items():
        np.testing.assert_allclose(p, one["params"][name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _train_argv():
    """tests/test_torch_train_cli.py's run: one step of each stage at
    batch 2, one row a rank."""
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
    return argv + ["main_training.num_objects=2", "main_training.num_ref_frames=2"]


def test_train_main_under_torchrun(tmp_path):
    """Fault F8: train.main under torchrun's environment formed no group,
    so every rank loaded the whole batch and trained alone. Now each rank
    joins, says (r, 2), takes its row of the global batch (the rows of one
    process's loader, in rank order), the replicas end equal, and rank 0
    alone writes weights and checkpoints."""
    argv = _train_argv() + ["device=cpu", f"dist_init=file://{tmp_path}/pg"]
    res = spawn_ranks(ranks.rank_train_main, 2, args=(str(tmp_path), argv),
                      threads=1, timeout=300, join=False)
    for r, out in enumerate(res):
        assert len(out["steps"]) == 2   # one a stage
        assert all(s["rank"] == (r, 2) and s["rows"] == 1 and s["mesh"] == 2
                   for s in out["steps"]), out["steps"]
        assert not out["grouped_after"]
    assert res[0]["weights"] == res[1]["weights"]

    cfg = train_config().apply_overrides(_train_argv())
    cfg.model = eval_config("small").model
    loader = setup_pre_training_datasets(cfg, cfg.pre_training, seed=cfg.seed)[1]
    epoch = loader.epoch(0)
    frames = next(epoch)["frames"]
    epoch.close()
    for r in range(2):
        assert res[r]["steps"][0]["frames"] == ranks.digest(
            [torch.from_numpy(frames[r:r + 1])])

    saved = ("weights_pre_training_final.npz", "weights_main_training_final.npz",
             "checkpoint_final.pt")
    run0, run1 = (tmp_path / f"rank{r}" / "output" / "cli" for r in range(2))
    assert all((run0 / name).exists() for name in saved)
    assert sorted(os.listdir(run1)) == ["train_rank1.log"]


def _write_video(root, name, frames, mask0):
    for sub in ("JPEGImages", "Annotations"):
        os.makedirs(root / sub / name)
    for ti, f in enumerate(frames):
        write_png(str(root / "JPEGImages" / name / f"{ti:05d}.png"),
                  (np.transpose(f, (1, 2, 0)) * 255).astype(np.uint8))
    write_png(str(root / "Annotations" / name / "00000.png"), mask0.astype(np.uint8),
              palette=davis_palette)


@pytest.fixture(scope="module")
def two_videos(tmp_path_factory):
    """A DAVIS-style directory of two videos of 12 and 6 frames (the small
    stream's frames)."""
    rec = np.load(require_golden("stream_small_work.npz"))
    root = tmp_path_factory.mktemp("two_videos")
    _write_video(root, "video1", rec["frames"], rec["mask0"])
    _write_video(root, "video2", rec["frames"][:6], rec["mask0"])
    return root


def _eval_argv(root, out, *extra):
    return ["dataset=generic", "model=small",
            f"weights={require_golden('state_dict_small.npz')}",
            f"image_directory={root / 'JPEGImages'}",
            f"mask_directory={root / 'Annotations'}", "size=-1",
            "use_long_term=false", "mem_every=3", "max_mem_frames=3",
            f"output_dir={out}", "device=cpu", *extra]


def _saved_masks(out):
    return {f"{v}/{f}": read_png(str(out / "Annotations" / v / f))[0]
            for v in sorted(os.listdir(out / "Annotations"))
            for f in sorted(os.listdir(out / "Annotations" / v))}


def test_eval_main_under_torchrun(two_videos, tmp_path):
    """Fault F9: eval_vos.main under torchrun formed no group, so every rank
    segmented every video (on cuda:0). Now each rank joins and takes every
    other video; with mem_mesh_devices=2 both ranks read each video's
    memory together and rank 0 saves it. The masks equal one process's."""
    one = tmp_path / "one"
    cfg = eval_config("small").apply_overrides(_eval_argv(two_videos, one)[:-1])
    get_dataset_cfg(cfg)
    cfg.model = eval_config("small").model
    assert port_eval.eval_vos(cfg, "cpu")["total_frames"] == 18
    expected = _saved_masks(one)
    assert len(expected) == 18

    for mesh, totals in ((0, [12, 6]), (2, [18, 18])):
        out = tmp_path / f"mesh{mesh}"
        argv = _eval_argv(two_videos, out, f"mem_mesh_devices={mesh}",
                          f"dist_init=file://{tmp_path}/pg{mesh}")
        res = spawn_ranks(ranks.rank_eval_main, 2, args=(argv,), threads=1,
                          timeout=300, join=False)
        assert [r["total_frames"] for r in res] == totals
        assert all(s == (r, 2) for r, out_r in enumerate(res)
                   for s in out_r["ranks_seen"])
        got = _saved_masks(out)
        assert got.keys() == expected.keys()
        for k, m in got.items():
            if mesh:   # another summation order: near-tie pixels may flip
                assert (m == expected[k]).mean() > 0.995, k
            else:
                np.testing.assert_array_equal(m, expected[k], err_msg=k)


def test_rank_device_and_eval_entry_device(monkeypatch):
    """Each rank runs on its own card: LOCAL_RANK picks the card for
    device 'cuda', a named card or the CPU stays as asked; eval_vos.main
    hands eval_vos the rank's device (fault F9: cuda:0 on every rank)."""
    assert rank_device("cuda", 1) == torch.device("cuda", 1)
    assert rank_device(None, 3) == torch.device("cuda", 3)
    assert rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert rank_device("cpu", 1) == torch.device("cpu")

    seen = {}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(launch, "init_distributed",
                        lambda device, init_method=None: rank_device(device, 1))
    monkeypatch.setattr(port_eval, "eval_vos",
                        lambda cfg, device: seen.setdefault("device", device))
    monkeypatch.setattr(port_eval.dist, "destroy_process_group", lambda: None)
    port_eval.main(["model=small"])
    assert seen["device"] == torch.device("cuda", 1)
