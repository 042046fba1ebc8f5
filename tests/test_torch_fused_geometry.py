"""Host logic of the port's streaming read kernel
(cutie_tpu_torch/ops/read_kernel.py:fused_topk_readout): the geometry of
its two stages, whose state must not grow with N, and the wrapper's
launches, with a stand-in library and device. The kernel itself runs only
on the card, where chip_smoke.py holds it to the plain version and to
kernel #1."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.ops import read_kernel as rk  # noqa: E402

D17 = dict(n=8_100, p=1_620)       # the d17 stream's read
LVOS600 = dict(n=38_134, p=2_546)  # lvos-val 600p


def test_state_does_not_grow_with_n():
    small = rk.fused_topk_readout_geometry(8_100, 1_620, 30)
    huge = rk.fused_topk_readout_geometry(rk.MAX_TOKENS, 1_620, 30)
    assert small == huge == (64, 10, 1_620 * 10 * (176 * 8 + 4))


@pytest.mark.parametrize("n,p,top_k", [
    (8_100, 1_620, 30), (38_134, 2_546, 30), (8_100, 1_620, 256),
    (8_100, 256, 4_096), (128, 64, 30), (129, 64, 30), (3_000, 200, 30),
    (rk.MAX_TOKENS, 5_000, 30), (rk.MAX_TOKENS, 5_000, 4_096)])
def test_every_split_holds_a_key_tile(n, p, top_k):
    tile, splits, state = rk.fused_topk_readout_geometry(n, p, top_k)
    assert tile == rk.QUERY_TILE
    assert 1 <= splits <= -(-n // rk.KEY_TILE)
    assert state == splits * p * (8 * rk.fused_state_ld(top_k) + 4)
    assert state <= max(rk.FUSED_STATE_BYTES, p * (8 * rk.fused_state_ld(top_k) + 4))


@pytest.mark.parametrize("shape", [D17, LVOS600], ids=["d17", "lvos600"])
def test_grid_is_one_round_of_resident_blocks(shape):
    """As many blocks as the card holds at once (two an SM), and not one
    query tile more: a second round would take as long as the first."""
    _, splits, state = rk.fused_topk_readout_geometry(**shape, top_k=30)
    q_tiles = -(-shape["p"] // rk.QUERY_TILE)
    slots = rk.FUSED_BLOCKS_PER_SM * rk.H100_SMS
    assert q_tiles * splits <= slots < q_tiles * (splits + 1)
    assert q_tiles * splits >= 0.9 * slots
    assert state < 40 << 20  # inside the 50 MB L2


def test_small_reads():
    # fewer queries than a tile, fewer keys than top_k: one block
    assert rk.fused_topk_readout_geometry(5, 3, 30) == (64, 1, 3 * (176 * 8 + 4))
    # one key tile, many query tiles: the split count stops at the tiles
    assert rk.fused_topk_readout_geometry(100, 10_000, 30)[1] == 1


def test_top_k_range():
    _, splits, state = rk.fused_topk_readout_geometry(8_100, 256, 4_096)
    assert rk.fused_state_ld(4_096) == 4_096 + rk.FUSED_STEP
    assert splits >= 1 and state <= rk.FUSED_STATE_BYTES
    for bad in (0, rk.FUSED_MAX_TOP_K + 1):
        with pytest.raises(ValueError, match="top_k"):
            rk.fused_topk_readout_geometry(8_100, 256, bad)


class _FakeFusedLibrary:
    """Records the stage launches (stage, n, p, top_k, splits, ld and the
    state's pointers); returns fail_with."""

    def __init__(self, fail_with=0):
        self.calls, self.fail_with = [], fail_with

    def fused_topk_readout_partial_launch(self, *args):
        self.calls.append(("partial", args[5], args[7], args[8], args[9],
                           args[10], args[11:14]))
        return self.fail_with

    def fused_topk_readout_merge_launch(self, *args):
        self.calls.append(("merge", args[6], args[8], args[11], args[12],
                           args[13], args[14:17]))
        return 0


def _inputs(n, p, o=2, ck=64, cv=16):
    rng = np.random.default_rng(0)
    t = lambda x: torch.from_numpy(x.astype(np.float32))
    return (t(rng.normal(size=(n, ck))), t(1 + rng.uniform(size=(n,))),
            torch.ones((n,), dtype=torch.bool), t(rng.normal(size=(p, ck))),
            t(rng.uniform(size=(p, ck))), t(rng.normal(size=(o, n, cv))))


@pytest.mark.parametrize("top_k", [30, 4_096])
def test_wrapper_launches_both_stages_on_one_state(monkeypatch, top_k):
    """The partial stage then the merge stage, with the geometry's split
    count and the same state, counted as one launch; a failed launch
    raises and counts nothing."""
    lib = _FakeFusedLibrary()
    monkeypatch.setattr(rk, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(rk, "_library", lambda source: lib)
    monkeypatch.setattr(rk, "_on_device", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(rk, "_sm_count", lambda dev: rk.H100_SMS)
    n, p = 1_000, 150
    args = _inputs(n, p)
    before = rk.fused_topk_readout.launches
    out, usage, tau = rk.fused_topk_readout_cuda(*args, top_k)
    assert rk.fused_topk_readout.launches == before + 1
    _, splits, _ = rk.fused_topk_readout_geometry(n, p, top_k)
    ld = rk.fused_state_ld(top_k)
    (part, merge) = lib.calls
    assert part[:6] == ("partial", n, p, top_k, splits, ld)
    assert merge[:6] == ("merge", n, p, top_k, splits, ld)
    assert part[6] == merge[6]  # one state
    assert out.shape == (2, p, 16) and usage.shape == (n,) and tau.shape == (p,)

    # the stages alone, at another split count, count no launch
    partial, merge = rk.fused_topk_readout_stages(*args, top_k, splits=3)
    partial()
    merge()
    assert [c[4] for c in lib.calls[2:]] == [3, 3]
    assert rk.fused_topk_readout.launches == before + 1

    monkeypatch.setattr(rk, "_library", lambda source: _FakeFusedLibrary(700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        rk.fused_topk_readout_cuda(*args, top_k)
    assert rk.fused_topk_readout.launches == before + 1


def test_cuda_wrapper_raises_without_a_card():
    """The CUDA entry point refuses CPU tensors rather than run the plain
    version."""
    before = rk.fused_topk_readout.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        rk.fused_topk_readout_cuda(*_inputs(64, 8), 30)
    assert rk.fused_topk_readout.launches == before
