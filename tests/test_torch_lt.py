"""The port's long-term memory (cutie_tpu_torch: state buffers, the
three-segment read with usage counters, consolidate, InferenceCore's
budgets) against the reference's recorded long-term streams and against
cutie_tpu on the CPU.

Tolerances:
- streams: the bars of tests/test_torch_stream.py (argmax agreement > 0.97
  per frame, > 0.995 where the reference's top-2 margin exceeds 0.01,
  median max-abs probability error < 0.05).
- consolidate: prototype indices, copied keys, counters, validity and the
  usage counters exactly. The potentiated shrinkage and values within a
  bound derived from the inputs (_potentiation_bound): the port's
  similarity is the direct form, cutie_tpu's the expanded form, and both
  round in fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests.conftest import require_golden  # noqa: E402
from tests.test_consolidation import _make_steps_and_state  # noqa: E402
from tests.test_torch_stream import _assert_stream_close, _port_core  # noqa: E402

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference.state import MemoryState  # noqa: E402
from cutie_tpu_torch.inference.steps import StepFunctions  # noqa: E402

LT = {"count_usage": True, "max_mem_frames": 4, "min_mem_frames": 2,
      "num_prototypes": 32, "max_num_tokens": 256, "buffer_tokens": 64}
# tests/test_inference_stream.py:_build_core, the settings the long-term
# goldens were recorded with
SETTINGS = {"mem_every": 3, "top_k": 30, "stagger_updates": 5,
            "max_mem_frames": 3, "use_long_term": True, "long_term": LT}
U = float(np.finfo(np.float32).eps) / 2   # fp32 unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """Run cutie_tpu's computations synchronously, as
    tests/test_torch_read.py does: with JAX's asynchronous CPU dispatch a
    PyTorch computation right after a JAX one came out perturbed now and
    then."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


@pytest.fixture
def one_thread():
    """One intra-op thread, so that the summation order, and with it the
    result, is the same on every machine. The random-weight base stream
    holds a near-tie: at frame 8 one pixel of the object transformer's
    fg/bg mask has its two largest aggregated probabilities 1.49e-6 apart,
    and which side the port lands on moves with the thread count (with 4
    or 8 threads the frames after it agree at 0.99479 where the reference
    is confident, with 1 or 2 at 0.99740 and 0.99862)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("variant", ["small", "base"])
def test_lt_stream_matches_reference(variant, one_thread):
    rec = dict(np.load(require_golden(f"stream_{variant}_lt.npz")))
    core = _port_core(variant, SETTINGS)
    probs = []
    for ti, frame in enumerate(rec["frames"]):
        prob = (core.step(frame, rec["mask0"], objects=[1, 2]) if ti == 0
                else core.step(frame))
        probs.append(prob.numpy())
    _assert_stream_close(probs, rec["probs"])
    # 24 frames, a memory frame every 3: consolidation ran three times, the
    # read had three segments, and the ring never held more than 3 frames
    assert core.consolidations == 3
    assert core.state.lt_count == 3 * LT["num_prototypes"]
    assert core.state.lt_key.shape[1] == LT["max_num_tokens"] + LT["num_prototypes"]
    assert core.state.work_key.shape[1] == LT["max_mem_frames"]


# ------------------------------------------------------------- consolidate

def _to_port_state(js) -> MemoryState:
    """cutie_tpu's MemoryState as the port's (sensory channels-first)."""
    fields = {}
    for name in MemoryState.__dataclass_fields__:
        x = np.asarray(getattr(js, name))
        if name == "sensory":
            x = np.ascontiguousarray(np.moveaxis(x, -1, 2))
        fields[name] = int(x) if x.ndim == 0 else torch.from_numpy(x.copy())
    return MemoryState(**fields)


def _crafted(case):
    """The crafted state of tests/test_consolidation.py:_make_steps_and_state
    (small variant, HW = 4, ring of 4, L = 16, two objects), with six
    long-term tokens whose usage ranking and object validity differ token
    by token, a late object (valid from the ring's third frame on, zero
    value rows before it) and a ring that wraps (oldest frame in slot 3)."""
    import jax.numpy as jnp

    steps, js, cfg = _make_steps_and_state()
    lcap = js.lt_key.shape[1]
    rng = np.random.default_rng(1)
    n_lt = 6
    lt_use = np.zeros((1, lcap), np.float32)
    lt_use[0, :n_lt] = [5.0, 1.0, 4.0, 2.0, 6.0, 3.0]
    ov = np.zeros((2, lcap), bool)
    ov[0, :n_lt] = [True, False, True, False, True, False]
    ov[1, :n_lt] = [False, True, False, True, False, True]
    # chronological ring order 3, 0, 1, 2; the late object from slot 1 on
    wov = np.array([[True] * 4, [False, True, True, False]])
    wv = np.array(js.work_value)
    wv[:, 1, [3, 0]] = 0.0
    work_use = np.array(js.work_use)
    if case == "usage_ties":
        # every candidate of the two oldest frames but one has usage 0: the
        # second prototype is decided by the tie rule (lower index first)
        work_use[:, [3, 0]] = 0.0
        work_use[0, 0, 2] = 1.0
    js = js.replace(
        lt_key=jnp.asarray(rng.normal(size=js.lt_key.shape), jnp.float32),
        lt_shrink=jnp.asarray(rng.uniform(1, 2, size=js.lt_shrink.shape),
                              jnp.float32),
        lt_value=jnp.asarray(rng.normal(size=js.lt_value.shape), jnp.float32),
        lt_use=jnp.asarray(lt_use),
        lt_life=jnp.asarray(rng.uniform(1, 3, size=(1, lcap)), jnp.float32),
        lt_obj_valid=jnp.asarray(ov),
        lt_count=jnp.asarray(n_lt, jnp.int32),
        work_obj_valid=jnp.asarray(wov),
        work_value=jnp.asarray(wv),
        work_use=jnp.asarray(work_use),
        work_start=jnp.asarray(3, jnp.int32),
        work_count=jnp.asarray(4, jnp.int32),
    )
    return steps, js, cfg


def _potentiation_bound(cand_key, cand_shr, proto_key, proto_sel, nc, ck):
    """Bound on |port - cutie_tpu| of the potentiated shrinkage and values,
    relative to the largest magnitude averaged.

    Both similarities round in fp32: the direct form's error is at most
    (Ck + 7) u |s| and the expanded form's (Ck + 3) u T over the magnitudes
    T = (sum qe mk^2 + 2 sum |qe qk mk| + sum qe qk^2) ms / sqrt(Ck) of its
    terms, plus the final product; since |s| <= T, the two differ by at
    most delta = (2 Ck + 12) u max T. A shift of at most delta in every
    similarity moves each softmax weight by a factor within exp(+-2 delta);
    the softmax and the weighted sum over Nc candidates round in fp32 (at
    most (Nc + 4) u and Nc u relative each, on both sides). So the averages
    differ by at most (2 (exp(2 delta) - 1) + 2 (2 Nc + 4) u) times the
    largest magnitude averaged."""
    mk, ms = cand_key.astype(np.float64), cand_shr.astype(np.float64)
    qk, qe = proto_key.astype(np.float64), proto_sel.astype(np.float64)
    t = (np.einsum("pc,nc->pn", qe, mk * mk)
         + 2 * np.einsum("pc,nc->pn", np.abs(qe * qk), np.abs(mk))
         + (qe * qk * qk).sum(-1, keepdims=True)) * ms[None] / np.sqrt(ck)
    delta = (2 * ck + 12) * U * t.max()
    return 2 * np.expm1(2 * delta) + 2 * (2 * nc + 4) * U


@pytest.mark.parametrize("case", ["no_eviction", "eviction", "usage_ties"])
def test_consolidate_matches_cutie_tpu(case):
    jsteps, js, cfg = _crafted(case)
    lt_keep = 3 if case == "eviction" else None
    n_cand = 2
    state = _to_port_state(js)
    before = _to_port_state(js)
    port_cfg = eval_config("small").merge({
        "use_long_term": True,
        "long_term": {"num_prototypes": cfg.long_term.num_prototypes}})
    steps = StepFunctions(None, port_cfg)  # consolidate uses no weights
    steps.consolidate(state, n_cand, lt_keep)
    ref = _to_port_state(jsteps.consolidate(None, js, n_candidate_frames=n_cand,
                                            lt_keep=lt_keep))

    # counters, keys, validity and usage counters: copies, so exact
    for name in ("lt_count", "work_start", "work_count"):
        assert getattr(state, name) == getattr(ref, name), name
    n_lt = ref.lt_count
    assert n_lt == (3 if lt_keep else 6) + steps.num_prototypes
    for name in ("lt_key", "lt_obj_valid", "lt_use", "lt_life"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      getattr(ref, name).numpy(), err_msg=name)

    # the prototype indices, exactly: each appended key is a candidate's
    hw = before.work_key.shape[2]
    frames = [(before.work_start + i) % before.work_key.shape[1]
              for i in range(n_cand)]
    cand_key = before.work_key[0, frames].reshape(n_cand * hw, -1).numpy()
    protos = slice(n_lt - steps.num_prototypes, n_lt)

    def indices(s):
        keys = s.lt_key[0, protos].numpy()
        return [int(np.flatnonzero((cand_key == k).all(-1))[0]) for k in keys]

    idx = indices(state)
    assert idx == indices(ref)
    use = (before.work_use / before.work_life)[0, frames].reshape(-1).numpy()
    expected = sorted(range(len(use)), key=lambda i: (-use[i], i))[:len(idx)]
    assert idx == expected, (idx, expected)

    # the potentiated shrinkage and values, within the derived bound
    ck = cand_key.shape[-1]
    sel = before.work_sel[0, frames].reshape(n_cand * hw, -1).numpy()
    shr = before.work_shrink[0, frames].reshape(-1).numpy()
    bound = _potentiation_bound(cand_key, shr, cand_key[idx], sel[idx],
                                n_cand * hw, ck)
    vals = before.work_value[0][:, frames].reshape(2, n_cand * hw, -1).numpy()
    np.testing.assert_allclose(state.lt_shrink[0, protos].numpy(),
                               ref.lt_shrink[0, protos].numpy(), rtol=0,
                               atol=bound * np.abs(shr).max())
    np.testing.assert_allclose(state.lt_value[0, :, protos].numpy(),
                               ref.lt_value[0, :, protos].numpy(), rtol=0,
                               atol=bound * np.abs(vals).max())
    # the kept tokens, moved by the eviction, are copies
    np.testing.assert_array_equal(state.lt_shrink[:, :protos.start].numpy(),
                                  ref.lt_shrink[:, :protos.start].numpy())
    np.testing.assert_array_equal(state.lt_value[:, :, :protos.start].numpy(),
                                  ref.lt_value[:, :, :protos.start].numpy())
    # the late object has no valid candidate: zero prototypes, invalid
    assert not state.lt_obj_valid[1, protos].any()
    assert float(state.lt_value[0, 1, protos].abs().max()) == 0.0


@pytest.mark.parametrize("which", ["non_permanent", "sensory"])
def test_clear_memory_matches_cutie_tpu(which, one_thread):
    """clear_non_permanent_memory / clear_sensory_memory in long-term mode,
    mid-stream, through the port and cutie_tpu's core side by side: eleven
    frames (one consolidation at frame 9), the clear, then six more frames
    from the kept memory."""
    from tests.test_inference_stream import _build_core

    rec = dict(np.load(require_golden("stream_small_lt.npz")))
    frames, mask0 = rec["frames"], rec["mask0"]
    jcore = _build_core(use_long_term=True)
    core = _port_core("small", SETTINGS)
    ours, theirs = [], []
    for ti in range(17):
        if ti == 11:
            assert core.consolidations == 1 and core.state.lt_count > 0
            getattr(core, f"clear_{which}_memory")()
            getattr(jcore, f"clear_{which}_memory")()
            if which == "non_permanent":
                st = core.state
                assert (st.work_count, st.lt_count, st.perm_n) == (0, 0, 48)
                assert not st.lt_obj_valid.any() and not st.work_use.any()
            else:
                assert not core.state.sensory.any()
            assert core.curr_ti == -1 and core.engaged
        args = (frames[ti], mask0) if ti == 0 else (frames[ti],)
        kw = {"objects": [1, 2]} if ti == 0 else {}
        ours.append(core.step(*args, **kw).numpy())
        theirs.append(np.asarray(jcore.step(*args, **kw)))
    _assert_stream_close(ours, theirs)
