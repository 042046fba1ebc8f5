"""The port's live budget changes (InferenceCore.update_config,
inference/state.py:resize_work_ring and resize_lt_capacity) against
cutie_tpu's on the CPU, on the scenarios of
tests/test_inference_stream.py:223-249, :275-308 and :310-350 and of
tests/test_consolidation.py:132-159 and :161-182.

After each update_config both cores must hold the same budgets and
counters (ring size, frames in the ring, long-term capacity and tokens),
the same ring frames in FIFO order (object validity exactly; keys and
values within RING_TOL of their largest magnitude: the two encoders round
in another order, and measured ~1.2e-6 apart), and their outputs must meet
the stream bars of tests/test_torch_stream.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_torch_lt import SETTINGS as LT_SETTINGS  # noqa: E402
from tests.test_torch_stream import (SETTINGS, _assert_stream_close,  # noqa: E402,F401
                                     one_intra_op_thread)

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.inference.state import (init_state,  # noqa: E402
                                             resize_work_ring)
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

RING_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """cutie_tpu's computations synchronous, as in tests/test_torch_lt.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture(scope="module")
def make_cores():
    """make(use_long_term) -> a fresh (cutie_tpu core, port core) pair; each
    package's model is built once for the module (cutie_tpu's compiled
    step functions are shared by its cores on one model)."""
    from cutie_tpu.inference import InferenceCore as JaxCore
    from cutie_tpu.utils.get_default_model import ModelBundle
    from tests.test_inference_stream import _build_core

    templates = {}
    cfg = eval_config("small")
    model = build_model(cfg, str(require_golden("state_dict_small.npz")),
                        device="cpu")

    def make(use_long_term):
        if use_long_term not in templates:
            templates[use_long_term] = _build_core(use_long_term)
        jt = templates[use_long_term]
        jcfg = jt.cfg.copy()
        jcore = JaxCore(ModelBundle(model=jt.model, variables=jt.variables,
                                    cfg=jcfg), jcfg)
        pcfg = eval_config("small")
        pcfg.merge(LT_SETTINGS if use_long_term else SETTINGS)
        return jcore, InferenceCore(model, pcfg)

    return make


@pytest.fixture(scope="module")
def video():
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    return rec["frames"], rec["mask0"]


def _step(cores, frames, ti, mask0=None):
    """One frame through both cores; returns (port prob, cutie_tpu prob)."""
    jcore, core = cores
    frame = frames[ti % frames.shape[0]]
    if mask0 is not None:
        return (core.step(frame, mask0, objects=[1, 2]).numpy(),
                np.asarray(jcore.step(frame, mask0, objects=[1, 2])))
    return core.step(frame).numpy(), np.asarray(jcore.step(frame))


def _fifo(state):
    """The ring's live frames, oldest first: (keys of batch row 0
    [count, HW, Ck], object validity [O, count], values of batch row 0
    [O, count, HW, Cv])."""
    f = state.work_key.shape[1]
    start, count = int(state.work_start), int(state.work_count)
    idx = [(start + i) % f for i in range(count)]
    return (np.asarray(state.work_key, np.float32)[0, idx],
            np.asarray(state.work_obj_valid)[:, idx],
            np.asarray(state.work_value, np.float32)[0][:, idx])


def _assert_same_memory(jcore, core):
    """Budgets, counters and ring contents of the two cores agree."""
    st, js = core.state, jcore.state
    assert core.ring_frames == jcore.ring_frames
    assert core.max_mem_frames == jcore.max_mem_frames
    assert st.work_key.shape[1] == js.work_key.shape[1] == core.ring_frames
    assert st.work_count == int(js.work_count) == jcore._work_count
    key, valid, value = _fifo(st)
    jkey, jvalid, jvalue = _fifo(js)
    np.testing.assert_array_equal(valid, jvalid)
    if st.work_count:
        assert np.abs(key - jkey).max() <= RING_TOL * np.abs(jkey).max()
        assert np.abs(value - jvalue).max() <= RING_TOL * np.abs(jvalue).max()
    if core.use_long_term:
        assert core.lt_capacity == jcore.lt_capacity
        assert st.lt_key.shape[1] == js.lt_key.shape[1] == core.lt_capacity
        assert st.lt_obj_valid.shape[1] == core.lt_capacity
        assert st.lt_count == int(js.lt_count) == jcore._lt_count


def _new_cfg(core, **changes):
    cfg = core.cfg.copy()
    for key, value in changes.items():
        if key.startswith("lt_"):
            cfg["long_term"][key[3:]] = value
        else:
            cfg[key] = value
    return cfg


def test_update_config_runtime(make_cores, video):
    """mem_every, top_k and max_mem_frames take effect live;
    use_long_term cannot change (tests/test_inference_stream.py:223-249)."""
    frames, mask0 = video
    jcore, core = cores = make_cores(False)
    ours, theirs = map(list, zip(_step(cores, frames, 0, mask0)))
    update = {"mem_every": 2, "top_k": 10, "use_long_term": False,
              "max_mem_frames": 4,
              "long_term": {"max_mem_frames": 4, "min_mem_frames": 2,
                            "max_num_tokens": 256, "buffer_tokens": 64}}
    for c in cores:
        c.update_config(update)
    assert core.mem_every == jcore.mem_every == 2
    assert core.steps.top_k == jcore.steps.top_k == 10
    _assert_same_memory(jcore, core)
    for ti in range(1, 4):
        o, t = _step(cores, frames, ti)
        ours.append(o)
        theirs.append(t)
    _assert_same_memory(jcore, core)
    _assert_stream_close(ours, theirs)
    for c in cores:
        with pytest.raises(AssertionError):
            c.update_config(dict(update, use_long_term=True))


def test_resize_work_ring_fifo_order():
    """Growing and shrinking a wrapped ring keeps FIFO order, as cutie_tpu's
    resize_work_ring does (tests/test_inference_stream.py:275-308)."""
    import jax.numpy as jnp

    from cutie_tpu.inference.state import init_state as jax_init_state
    from cutie_tpu.inference.state import resize_work_ring as jax_resize

    dims = dict(batch=1, max_objects=2, h=2, w=2, sensory_dim=4, key_dim=3,
                value_dim=4, num_queries=2, embed_dim=4, perm_frames=1,
                work_frames=3, lt_capacity=8)
    rng = np.random.default_rng(3)
    # frames written in order 10, 11, 12, 13 into 3 slots: the slots hold
    # [13, 11, 12], the oldest (11) in slot 1
    key = np.zeros((1, 3, 4, 3), np.float32)
    key[0, 0], key[0, 1], key[0, 2] = 13, 11, 12
    ring = dict(work_key=key,
                work_value=rng.normal(size=(1, 2, 3, 4, 4)).astype(np.float32),
                work_use=rng.uniform(size=(1, 3, 4)).astype(np.float32),
                work_obj_valid=np.array([[True, True, True],
                                         [False, True, True]]))
    st = init_state(**dims, device="cpu")
    st.work_start, st.work_count = 1, 3
    js = jax_init_state(**dims).replace(work_start=jnp.asarray(1, jnp.int32),
                                        work_count=jnp.asarray(3, jnp.int32))
    for name, x in ring.items():
        setattr(st, name, torch.from_numpy(x.copy()))
        js = js.replace(**{name: jnp.asarray(x)})

    for frames, oldest_first in ((5, [11, 12, 13, 0, 0]), (2, [12, 13])):
        ours, theirs = resize_work_ring(st, frames), jax_resize(js, frames)
        assert list(ours.work_key[0, :, 0, 0]) == oldest_first
        assert (ours.work_start, ours.work_count) == (
            int(theirs.work_start), int(theirs.work_count))
        for name in ("work_key", "work_shrink", "work_sel", "work_value",
                     "work_obj_valid", "work_use", "work_life"):
            np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                          np.asarray(getattr(theirs, name)),
                                          err_msg=name)


def test_update_config_grows_and_shrinks_working_memory(make_cores, video):
    """A raised max_mem_frames raises the ring's capacity and the ring fills
    past the old one; a lowered one keeps the newest frames
    (tests/test_inference_stream.py:310-350)."""
    frames, mask0 = video
    jcore, core = cores = make_cores(False)
    ours, theirs = map(list, zip(_step(cores, frames, 0, mask0)))

    def run(first, last):
        for ti in range(first, last):
            o, t = _step(cores, frames, ti)
            ours.append(o)
            theirs.append(t)

    run(1, 7)
    assert core.ring_frames == 2 and core.state.work_count == 2
    _assert_same_memory(jcore, core)
    for c in cores:
        c.update_config(_new_cfg(core, mem_every=1, max_mem_frames=6))
    assert core.ring_frames == 5
    _assert_same_memory(jcore, core)
    run(7, 11)
    assert core.state.work_count == 5
    _assert_same_memory(jcore, core)
    for c in cores:
        c.update_config(_new_cfg(core, mem_every=1, max_mem_frames=3))
    assert core.ring_frames == 2 and core.state.work_count == 2
    _assert_same_memory(jcore, core)
    run(11, 13)
    _assert_same_memory(jcore, core)
    _assert_stream_close(ours, theirs)


def test_update_config_grows_long_term_capacity(make_cores, video):
    """A raised long_term.max_num_tokens reallocates the long-term buffers
    (tests/test_consolidation.py:132-159)."""
    frames, mask0 = video
    jcore, core = cores = make_cores(True)
    ours, theirs = map(list, zip(_step(cores, frames, 0, mask0)))
    for ti in range(1, 10):
        o, t = _step(cores, frames, ti)
        ours.append(o)
        theirs.append(t)
    old_cap = core.state.lt_key.shape[1]
    assert core.state.lt_count > 0
    for c in cores:
        c.update_config(_new_cfg(core, lt_max_num_tokens=512))
    assert core.lt_capacity == 512 + core.num_prototypes > old_cap
    _assert_same_memory(jcore, core)
    for ti in range(10, 14):
        o, t = _step(cores, frames, ti)
        ours.append(o)
        theirs.append(t)
    _assert_same_memory(jcore, core)
    _assert_stream_close(ours, theirs)


def test_ring_shrink_consolidates_before_wrap(make_cores, video):
    """Shrinking the long-term mode's ring keeps every frame it holds
    (tests/test_consolidation.py:161-182); shrinking it to its live count
    consolidates inside update_config, with the old ring intact, so that the
    next memory frame overwrites no unconsolidated frame."""
    frames, mask0 = video
    jcore, core = cores = make_cores(True)
    ours, theirs = map(list, zip(_step(cores, frames, 0, mask0)))

    def run(first, last):
        for ti in range(first, last):
            o, t = _step(cores, frames, ti)
            ours.append(o)
            theirs.append(t)

    run(1, 8)
    assert core.state.work_count == 2
    before, lt_before = core.consolidations, core.state.lt_count
    # max_mem_frames 4 -> 3: the ring of 4 slots becomes 3, both frames stay
    for c in cores:
        c.update_config(_new_cfg(core, lt_max_mem_frames=3))
    assert core.state.work_count == 2 < core.ring_frames == 3
    assert core.consolidations == before
    _assert_same_memory(jcore, core)
    # 3 -> 2: a ring of 2 slots holding 2 frames is drained at once
    for c in cores:
        c.update_config(_new_cfg(core, lt_max_mem_frames=2))
    done = core.consolidations - before
    assert done >= 1
    assert core.state.work_count < core.ring_frames == 2
    assert core.state.lt_count == lt_before + done * core.num_prototypes
    _assert_same_memory(jcore, core)
    run(8, 12)
    _assert_same_memory(jcore, core)
    _assert_stream_close(ours, theirs)
