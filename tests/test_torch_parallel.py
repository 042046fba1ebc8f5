"""The port's token-sharded memory read (cutie_tpu_torch/parallel/) on
ranks spawned under gloo on the CPU, against cutie_tpu's sharded read on
the conftest's virtual CPU devices and against the port's single-device
read, and the streaming engine with mem_mesh_devices = 2 against the
recorded streams and its world-1 run.

The ranks run tests/torch_parallel_ranks.py (no JAX in them); each group
of ranks is spawned once a module and runs every case.

Tolerances:
- the reads: those of tests/test_torch_read.py, rtol / atol 1e-5 for the
  readout and the usage in fp32. Against cutie_tpu on bf16 values 2e-2:
  cutie_tpu rounds the weights to bf16 before the product, the port keeps
  them fp32 (ROADMAP D4); against the port's own single-device read they
  are the same fp32 operations, so 1e-5 still;
- the streams: argmax agreement with the recorded stream above 0.995 on
  every frame (tests/test_sharded_memory.py's bar), probabilities within
  1e-4 of the port's world-1 run (the sharded read selects the same
  tokens, the direct-form similarity being elementwise, and sums the
  readout in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.ops.memory import (get_similarity, readout,  # noqa: E402
                                        topk_softmax_radix)
from cutie_tpu_torch.parallel import Mesh, make_mesh, shard_memory  # noqa: E402
from cutie_tpu_torch.parallel.launch import spawn_ranks  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_VS_CUTIE_TPU = dict(rtol=2e-2, atol=2e-2)
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """See tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def sharded_reads():
    """{world: every rank's rank_reads()}."""
    return {d: spawn_ranks(ranks.rank_reads, d, threads=1, timeout=300)
            for d in WORLDS}


def _port_single_device(mk, ms, qk, qe, vals, valid, k):
    """The single-device read's math (read_kernel.radix_topk_readout_plain,
    which takes no None), on numpy inputs: (readout, usage)."""
    t = ranks._t
    sim = get_similarity(t(mk), t(ms), t(qk), t(qe), t(valid))
    aff, usage = topk_softmax_radix(sim, k, return_usage=True)
    return readout(aff, t(vals)).numpy(), usage.numpy()


def _cutie_tpu_read(d, mk, ms, qk, qe, vals, valid, k, bf16):
    from cutie_tpu.parallel.sharded_memory import (make_mem_mesh, shard_memory,
                                                   sharded_topk_readout)

    mesh = make_mem_mesh(d)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    vdt = jnp.bfloat16 if bf16 else jnp.float32
    mk_d, ms_d, v_d, valid_d = shard_memory(
        mesh, j(mk), j(ms) if ms is not None else jnp.ones(mk.shape[:2]),
        j(vals).astype(vdt), j(valid) if valid is not None else jnp.ones(mk.shape[:2], bool))
    rd, us = sharded_topk_readout(
        mk_d, ms_d if ms is not None else None, j(qk), j(qe), v_d,
        valid_d if valid is not None else None, k, mesh, return_usage=True,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    return np.asarray(rd), np.asarray(us)


def _gathered(results, name):
    """(rank 0's readout, the usage of every rank's tokens in order)."""
    return (results[0][name][0],
            np.concatenate([r[name][1] for r in results], axis=1))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(ranks.TOPK_CASES))
def test_sharded_read_matches_port_single_device(sharded_reads, world, case):
    """Every rank reads the same readout, and it and the usage equal the
    single-device read's, every tie at the threshold kept (case 'tie')."""
    res = sharded_reads[world]
    rd, us = _gathered(res, case)
    for r in res[1:]:
        np.testing.assert_array_equal(r[case][0], rd)
    rd1, us1 = _port_single_device(*ranks.topk_case(case))
    np.testing.assert_allclose(rd, rd1, **TOL)
    np.testing.assert_allclose(us, us1, **TOL)
    if case == "all_invalid":
        np.testing.assert_array_equal(rd, 0.0)
        np.testing.assert_array_equal(us, 0.0)
    if case == "tie":
        mk, ms, qk, qe, _, _, k = ranks.topk_case(case)
        sim = get_similarity(*(torch.from_numpy(x) for x in (mk, ms, qk, qe)))[0, 0]
        tau = torch.topk(sim, k).values[-1]
        tied = (sim == tau).nonzero()[:, 0].numpy()
        assert len(tied) == 2 and (tied < 128).sum() == 1, tied
        assert (us[0, tied] > 0).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c in ranks.TOPK_CASES if c != "tie"])
def test_sharded_read_matches_cutie_tpu(sharded_reads, world, case):
    """Against cutie_tpu's sharded_topk_readout on a `world`-device mesh
    (tests/test_sharded_memory.py's cases; ties are left out, where
    cutie_tpu's normalisation counts only k of the tied weights)."""
    if len(jax.devices()) < world:
        pytest.skip(f"needs {world} virtual devices")
    rd, us = _gathered(sharded_reads[world], case)
    mk, ms, qk, qe, vals, valid, k = ranks.topk_case(case)
    rd_j, us_j = _cutie_tpu_read(world, mk, ms, qk, qe, vals, valid, k,
                                 case == "bf16_values")
    tol = BF16_VS_CUTIE_TPU if case == "bf16_values" else TOL
    np.testing.assert_allclose(rd, rd_j, **tol)
    np.testing.assert_allclose(us, us_j, **tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("lt_sharded", [True, False], ids=["lt_sharded", "lt_replicated"])
def test_composite_read(sharded_reads, world, lt_sharded):
    """sharded_composite_readout over [perm | lt | work] (perm and work of
    sizes that do not divide by the mesh) against cutie_tpu's and against
    the single-device read of the concatenated sections."""
    from cutie_tpu.parallel.sharded_memory import (make_mem_mesh,
                                                   sharded_composite_readout)

    if len(jax.devices()) < world:
        pytest.skip(f"needs {world} virtual devices")
    key = "composite_" + ("lt_sharded" if lt_sharded else "replicated")
    res = sharded_reads[world]
    rd = res[0][key][0]
    lt_us = (np.concatenate([r[key][1] for r in res], axis=1) if lt_sharded
             else res[0][key][1])
    work_us = res[0][key][2]
    for r in res[1:]:
        np.testing.assert_array_equal(r[key][0], rd)
        np.testing.assert_array_equal(r[key][2], work_us)   # the ring's replicas agree
        if not lt_sharded:
            np.testing.assert_array_equal(r[key][1], lt_us)
    sections, qk, qe = ranks.composite_case()
    np_, nl, _ = ranks.COMPOSITE_SIZES
    cat = [np.concatenate([s[i] for s in sections], axis=2 if i == 2 else 1)
           for i in range(4)]
    rd1, us1 = _port_single_device(cat[0], cat[1], qk, qe, cat[2], cat[3], 30)
    np.testing.assert_allclose(rd, rd1, **TOL)
    np.testing.assert_allclose(lt_us, us1[:, np_:np_ + nl], **TOL)
    np.testing.assert_allclose(work_us, us1[:, np_ + nl:], **TOL)

    j = [tuple(jnp.asarray(x) for x in s) for s in sections]
    rd_j, lt_j, work_j = sharded_composite_readout(
        *j, jnp.asarray(qk), jnp.asarray(qe), 30, make_mem_mesh(world),
        lt_sharded=lt_sharded, return_usage=True)
    np.testing.assert_allclose(rd, np.asarray(rd_j), **TOL)
    np.testing.assert_allclose(lt_us, np.asarray(lt_j), **TOL)
    np.testing.assert_allclose(work_us, np.asarray(work_j), **TOL)


def test_indivisible_token_axis_raises():
    """shard_memory, as cutie_tpu's (sharded_memory.py:56-60)."""
    mesh = Mesh(None, 8, 0)
    with pytest.raises(ValueError, match="not divisible"):
        shard_memory(mesh, torch.zeros(1, 100, 8), None, torch.zeros(1, 1, 100, 4),
                     None)


def test_no_silent_single_device_read():
    """mem_mesh_devices above the world's ranks raises where the parent
    tree read on one device without a word (fault F10), and so does a mesh
    of more ranks than the world has; 0 and 1 read on one device."""
    with pytest.raises(ValueError, match="2-rank mesh"):
        make_mesh(2)
    cfg = eval_config("small")
    cfg.merge(dict(ranks.STREAM_SETTINGS, use_long_term=True, mem_mesh_devices=2))
    model = build_model(cfg, str(require_golden("state_dict_small.npz")), device="cpu")
    with pytest.raises(ValueError, match="2-rank mesh"):
        InferenceCore(model, cfg)
    for d in (0, 1):
        cfg.mem_mesh_devices = d
        assert InferenceCore(model, cfg).steps.mem_mesh is None


@pytest.fixture(scope="module")
def sharded_streams():
    """Both ranks' rank_streams() (mem_mesh_devices = 2)."""
    return spawn_ranks(ranks.rank_streams, 2, threads=1, timeout=300)


@pytest.mark.parametrize("golden,long_term", [("stream_small_work.npz", False),
                                              ("stream_small_lt.npz", True)],
                         ids=["work", "long_term"])
def test_two_rank_stream(sharded_streams, golden, long_term):
    rec = np.load(require_golden(golden))
    one = ranks.run_stream(golden, long_term, 0)
    for rank, res in enumerate(r[golden] for r in sharded_streams):
        agree = [(p.argmax(0) == q.argmax(0)).mean()
                 for p, q in zip(res["probs"], rec["probs"])]
        assert min(agree) > 0.995, (rank, agree)
        np.testing.assert_allclose(res["probs"], one["probs"], rtol=0, atol=1e-4)
        assert res["consolidations"] == one["consolidations"]
        assert res["lt_capacity"] == one["lt_capacity"]
        assert res["lt_slots"] == one["lt_capacity"] // 2
        if long_term:
            assert res["consolidations"] == 3 and res["lt_count"] == 96
