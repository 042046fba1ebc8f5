"""The port's streaming engine (cutie_tpu_torch.inference.InferenceCore)
against the reference's recorded streams and against cutie_tpu's
InferenceCore, on the CPU.

Bars are those of tests/test_inference_stream.py:81-84: per-frame argmax
agreement > 0.97, agreement > 0.995 where the reference's top-2 margin
exceeds 0.01 (random-weight boundaries hold exact-tie pixels whose argmax
flips on fp noise), and median max-abs probability error < 0.05.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import require_golden  # noqa: E402

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.inference import InferenceCore  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

SETTINGS = {"mem_every": 3, "top_k": 30, "stagger_updates": 5,
            "max_mem_frames": 3, "use_long_term": False}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread(request):
    """One torch intra-op thread for the module (or the module's
    INTRA_OP_THREADS), restored afterwards. The suite runs in several
    worker processes at once, each beside JAX's own threads, and torch's
    default of one thread a core oversubscribes the CPU; a fixed count also
    fixes torch's summation order. Every tests/test_torch_*.py module
    imports this fixture."""
    old = torch.get_num_threads()
    torch.set_num_threads(getattr(request.module, "INTRA_OP_THREADS", 1))
    yield
    torch.set_num_threads(old)


def _port_core(variant, settings):
    cfg = eval_config(variant)
    cfg.merge(settings)
    model = build_model(cfg, str(require_golden(f"state_dict_{variant}.npz")),
                        device="cpu")
    return InferenceCore(model, cfg)


def _assert_stream_close(probs, refs):
    agree, conf_agree, prob_err = [], [], []
    for prob, ref in zip(probs, refs):
        assert prob.shape == ref.shape
        ours, theirs = prob.argmax(0), ref.argmax(0)
        srt = np.sort(ref, axis=0)
        confident = (srt[-1] - srt[-2]) > 0.01
        agree.append((ours == theirs).mean())
        conf_agree.append(((ours == theirs) | ~confident).mean())
        prob_err.append(np.abs(prob - ref).max())
    assert min(agree) > 0.97, (agree, prob_err)
    assert min(conf_agree) > 0.995, (conf_agree, prob_err)
    assert np.median(prob_err) < 0.05, prob_err


@pytest.mark.parametrize("variant", ["small", "base"])
def test_stream_matches_reference(variant):
    rec = dict(np.load(require_golden(f"stream_{variant}_work.npz")))
    core = _port_core(variant, SETTINGS)
    probs = []
    for ti, frame in enumerate(rec["frames"]):
        prob = (core.step(frame, rec["mask0"], objects=[1, 2]) if ti == 0
                else core.step(frame))
        probs.append(prob.numpy())
    _assert_stream_close(probs, rec["probs"])
    mask = core.output_prob_to_mask(torch.from_numpy(probs[-1]))
    assert set(np.unique(mask)) <= {0, 1, 2}


def test_stream_matches_cutie_tpu_core():
    """6 frames at 64x64, a memory frame every 2: the port and cutie_tpu's
    InferenceCore on the same weights and frames (cutie_tpu reads with its
    sort-based top-k on the CPU, the port with the tie-keeping threshold)."""
    from tests.test_inference_stream import _build_core

    rec = dict(np.load(require_golden("stream_small_work.npz")))
    frames = np.ascontiguousarray(rec["frames"][:6, :, 16:80, 32:96])
    mask0 = np.ascontiguousarray(rec["mask0"][16:80, 32:96])
    assert set(np.unique(mask0)) == {0, 1, 2}
    settings = dict(SETTINGS, mem_every=2)
    jcore = _build_core(use_long_term=False, cfg_extra={"mem_every": 2})
    core = _port_core("small", settings)
    ours, theirs = [], []
    for ti, frame in enumerate(frames):
        if ti == 0:
            ours.append(core.step(frame, mask0, objects=[1, 2]).numpy())
            theirs.append(np.asarray(jcore.step(frame, mask0, objects=[1, 2])))
        else:
            ours.append(core.step(frame).numpy())
            theirs.append(np.asarray(jcore.step(frame)))
    _assert_stream_close(ours, theirs)
    np.testing.assert_array_equal(core.output_prob_to_mask(torch.from_numpy(ours[-1])),
                                  jcore.output_prob_to_mask(theirs[-1]))


def test_delete_objects_keeps_the_rest():
    """Deleting an object compacts the object axis of memory; the remaining
    object is still tracked under its own id."""
    rec = dict(np.load(require_golden("stream_small_work.npz")))
    core = _port_core("small", SETTINGS)
    for ti in range(4):
        prob = (core.step(rec["frames"][ti], rec["mask0"], objects=[1, 2])
                if ti == 0 else core.step(rec["frames"][ti]))
    core.delete_objects([1])
    assert core.object_manager.all_obj_ids == [2]
    prob = core.step(rec["frames"][4])
    assert prob.shape == (2,) + rec["frames"].shape[2:]
    mask = core.output_prob_to_mask(prob)
    assert set(np.unique(mask)) <= {0, 2}
    assert (mask == 2).any()
