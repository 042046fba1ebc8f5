"""The port's memory read (cutie_tpu_torch/ops/memory.py and
ops/read_kernel.py) against cutie_tpu's on the CPU: the TPU kernel
pallas_kernels.radix_topk_readout in interpret mode, the XLA radix chain
ops/memory.py, and the radix select itself.

On the CPU the port's read wrapper runs its plain PyTorch version; the CUDA
kernel is held to that plain version on the card by chip_smoke.py.

Tolerances:
- tau: the exact k-th largest value, bit for bit equal on the same
  similarity array (both are exact selections).
- similarity: the port's direct form within (Ck + 8) fp32 ulps of the
  same similarity in fp64 (its error bound is (Ck + 7) units of roundoff),
  and bit for bit equal to the kernel's order of fp32 operations.
- fp32 readout vs the TPU kernel: rtol 1e-4, atol 1e-5. The TPU kernel's
  fp32 readout is a three-pass bf16 split product, good to ~3e-5 relative
  (tests/test_pallas_kernel.py uses the same bound).
- fp32 readout vs the XLA chain and similarity: rtol 1e-5, atol 1e-5; only
  the summation order differs.
- usage: rtol 1e-5, atol 1e-5 (fp32 sums over the same selected tokens).
- bf16 values: rtol 2e-2, atol 2e-2. The TPU kernel rounds the weights to
  bf16 before its product; the port widens bf16 values to fp32 and keeps
  fp32 weights.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu.ops import memory as jmem  # noqa: E402
from cutie_tpu.ops.pallas_kernels import radix_topk_readout as jax_read  # noqa: E402
from cutie_tpu_torch.ops import memory as tmem  # noqa: E402
from cutie_tpu_torch.ops.read_kernel import (radix_topk_readout,  # noqa: E402
                                             radix_topk_readout_plain)

K = 30


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """Run cutie_tpu's computations synchronously in this module. With the
    CPU backend's asynchronous dispatch, the first PyTorch read after a JAX
    read now and then came out perturbed by ~5e-5 (about one process in
    fifteen, never with JAX idle): some JAX work outlives the results it
    returns, and the port's exact comparisons must not run beside it."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def _inputs(seed, n, p, o, ck=64, cv=64, n_valid=None):
    rng = np.random.default_rng(seed)
    mk = rng.normal(size=(n, ck)).astype(np.float32)
    ms = rng.uniform(1, 3, size=(n,)).astype(np.float32)
    valid = np.ones((n,), bool)
    if n_valid is not None:
        valid[n_valid:] = False
    qk = rng.normal(size=(p, ck)).astype(np.float32)
    qe = rng.uniform(size=(p, ck)).astype(np.float32)
    vals = rng.normal(size=(o, n, cv)).astype(np.float32)
    return mk, ms, valid, qk, qe, vals


def _multi_segment(seed, caps, bn, p, o, ck=64, cv=64):
    """The TPU kernel's padded segment layout: segment s's keys sit in a
    block_n-aligned region, its pad tail invalid."""
    rng = np.random.default_rng(seed)
    pads = [-(-c // bn) * bn for c in caps]
    n = sum(pads)
    mk = np.zeros((n, ck), np.float32)
    ms = np.ones((n,), np.float32)
    valid = np.zeros((n,), bool)
    segs, off = [], 0
    for c, pd in zip(caps, pads):
        mk[off:off + c] = rng.normal(size=(c, ck))
        ms[off:off + c] = rng.uniform(1, 3, size=(c,))
        valid[off:off + c] = True
        segs.append(rng.normal(size=(o, c, cv)).astype(np.float32))
        off += pd
    valid[10:40] = False  # a hole inside the first segment
    qk = rng.normal(size=(p, ck)).astype(np.float32)
    qe = rng.uniform(size=(p, ck)).astype(np.float32)
    return mk, ms, valid, qk, qe, tuple(segs)


def _offsets(caps, bn=256):
    """First key index of each segment in the TPU kernel's layout."""
    return [sum(-(-c // bn) * bn for c in caps[:i]) for i in range(len(caps))]


CASES = {
    "single_segment": dict(args=lambda: _inputs(2, 1024, 128, 3, n_valid=700)),
    "multi_segment": dict(args=lambda: _multi_segment(5, (296, 424, 560), 256,
                                                      128, 2)),
    "fewer_valid_than_k": dict(args=lambda: _inputs(1, 256, 128, 1, n_valid=5)),
    "padded_queries": dict(args=lambda: _inputs(3, 512, 96, 2), pad=32),
    "bf16_values": dict(args=lambda: _inputs(4, 1024, 128, 3, n_valid=900),
                        bf16=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_read_matches_tpu_kernel(name):
    case = CASES[name]
    mk, ms, valid, qk, qe, vals = case["args"]()
    p = qk.shape[0]
    if case.get("pad"):
        ck = qk.shape[1]
        qk = np.concatenate([qk, np.full((case["pad"], ck), 1e6, np.float32)])
        qe = np.concatenate([qe, np.ones((case["pad"], ck), np.float32)])
    segs = vals if isinstance(vals, tuple) else (vals,)
    multi = isinstance(vals, tuple)
    bf16 = case.get("bf16", False)
    p_pad = -(-qk.shape[0] // 128) * 128
    qk_j = np.concatenate([qk, np.full((p_pad - qk.shape[0], qk.shape[1]), 1e6,
                                       np.float32)])
    qe_j = np.concatenate([qe, np.ones((p_pad - qe.shape[0], qe.shape[1]),
                                       np.float32)])
    rd_j, us_j = jax_read(
        jnp.asarray(mk), jnp.asarray(ms), jnp.asarray(valid), jnp.asarray(qk_j),
        jnp.asarray(qe_j), tuple(jnp.asarray(s) for s in segs), K,
        block_p=128, block_n=256, interpret=True,
        value_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    rd_j, us_j = np.asarray(rd_j)[:, :qk.shape[0]], np.asarray(us_j)

    t = torch.from_numpy
    # the TPU kernel's padded segment layout reaches the port as one
    # zero-padded value store over the same keys (its pad keys are invalid)
    v_pad = np.zeros((segs[0].shape[0], mk.shape[0], segs[0].shape[2]),
                     np.float32)
    for off, s in zip(_offsets([s.shape[1] for s in segs]), segs):
        v_pad[:, off:off + s.shape[1]] = s
    v_pad = t(v_pad).to(torch.bfloat16) if bf16 else t(v_pad)
    launches = radix_topk_readout.launches
    rd, us = radix_topk_readout(t(mk), t(ms), t(valid), t(qk), t(qe), v_pad, K)
    assert radix_topk_readout.launches == launches  # CPU: the plain version
    assert rd.shape == (segs[0].shape[0], qk.shape[0], segs[0].shape[2])
    assert us.shape == (mk.shape[0],)
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rd.numpy(), rd_j, **tol)
    np.testing.assert_allclose(us.numpy(), us_j, rtol=1e-5, atol=1e-5)
    if multi:
        # the port's own layout: the segments unpadded, values in place
        rows = np.concatenate([np.arange(off, off + s.shape[1]) for off, s in
                               zip(_offsets([s.shape[1] for s in segs]), segs)])
        rd_u, us_u = radix_topk_readout(
            t(mk[rows]), t(ms[rows]), t(valid[rows]), t(qk), t(qe),
            tuple(t(s) for s in segs), K)
        np.testing.assert_allclose(rd_u.numpy(), rd.numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(us_u.numpy(), us.numpy()[rows], rtol=1e-6,
                                   atol=1e-7)
    if case.get("pad"):
        assert np.abs(rd.numpy()[:, p:]).max() == 0.0
    if name == "fewer_valid_than_k":
        np.testing.assert_allclose(us.numpy().sum(), p, rtol=1e-4)
        assert np.abs(us.numpy()[5:]).max() == 0.0


def test_read_matches_xla_radix_chain():
    """Plain read vs get_similarity -> topk_softmax_radix -> readout."""
    mk, ms, valid, qk, qe, vals = _inputs(6, 768, 200, 2, n_valid=600)
    sim = jmem.get_similarity(mk[None], ms[None], qk[None], qe[None],
                              valid=jnp.asarray(valid)[None])
    aff, use = jmem.topk_softmax_radix(sim, K, return_usage=True)
    rd_j = np.asarray(jmem.readout(aff, jnp.asarray(vals)[None]))[0]
    t = torch.from_numpy
    rd, us = radix_topk_readout_plain(t(mk), t(ms), t(valid), t(qk), t(qe),
                                      t(vals), K)
    np.testing.assert_allclose(rd.numpy(), rd_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(us.numpy(), np.asarray(use)[0], rtol=1e-5,
                               atol=1e-5)

    # the port's XLA-chain counterparts, on the same inputs
    sim_t = tmem.get_similarity(t(mk)[None], t(ms)[None], t(qk)[None],
                                t(qe)[None], valid=t(valid)[None])
    np.testing.assert_allclose(sim_t.numpy(), np.asarray(sim), rtol=1e-5,
                               atol=1e-4)
    aff_t, use_t = tmem.topk_softmax_radix(torch.from_numpy(np.array(sim)),
                                           K, return_usage=True)
    np.testing.assert_allclose(aff_t.numpy(), np.asarray(aff), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(use_t.numpy(), np.asarray(use), rtol=1e-5,
                               atol=1e-6)
    rd_t = tmem.readout(aff_t, t(vals)[None])
    np.testing.assert_allclose(rd_t.numpy(), rd_j[None], rtol=1e-5, atol=1e-5)


def test_threshold_and_order_key_exact():
    """tau and the order key are bit for bit cutie_tpu's, ties included."""
    rng = np.random.default_rng(7)
    sim = rng.normal(size=(4, 64, 500)).astype(np.float32) * 30
    sim[:, :, 100:110] = sim[:, :, 50:51]          # ties at many ranks
    sim[:, :, 400:] = -1e30                        # masked tokens
    sim[:, 3, :] = sim[:, 3, :1]                   # a row that is all one value
    tau_j = np.asarray(jmem.topk_threshold_radix(jnp.asarray(sim), K))
    tau_t = tmem.topk_threshold(torch.from_numpy(sim), K).numpy()
    np.testing.assert_array_equal(tau_t.view(np.uint32), tau_j.view(np.uint32))

    key_j = np.asarray(jmem._float_order_key(jnp.asarray(sim)))
    key_t = tmem._float_order_key(torch.from_numpy(sim)).numpy()
    np.testing.assert_array_equal(key_t.astype(np.uint32), key_j)
    # keys count the floats: the next float up is one key further
    x = np.array([-1e30, -3.5, -1e-30, 0.0, 2.0], np.float32)
    up = np.nextafter(x, np.float32(np.inf))
    step = (tmem._float_order_key(torch.from_numpy(up))
            - tmem._float_order_key(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(step, 1)

    # every tie at the k-th value is kept, as in cutie_tpu's radix read
    aff_j, _ = jmem.topk_softmax_radix(jnp.asarray(sim), K)
    aff_t, _ = tmem.topk_softmax_radix(torch.from_numpy(sim), K)
    np.testing.assert_array_equal(aff_t.numpy() > 0, np.asarray(aff_j) > 0)


@pytest.mark.parametrize("trained_like", [False, True])
def test_similarity_direct_form_exact(trained_like):
    """get_similarity is the kernel's order of fp32 operations, bit for bit,
    and within (Ck + 8) ulps of the same similarity in fp64. The trained-like
    keys (norms near 17, shrinkage near 16, queries near their keys) are
    where the expanded form cancels by three digits."""
    rng = np.random.default_rng(11)
    ck, n, p = 64, 700, 96
    if trained_like:
        mk = (2.0 + 0.3 * rng.normal(size=(n, ck))).astype(np.float32)
        qk = (mk[rng.integers(0, n, p)]
              + 0.05 * rng.normal(size=(p, ck))).astype(np.float32)
        ms = rng.uniform(12, 20, size=(n,)).astype(np.float32)
    else:
        mk = rng.normal(size=(n, ck)).astype(np.float32)
        qk = rng.normal(size=(p, ck)).astype(np.float32)
        ms = rng.uniform(1, 3, size=(n,)).astype(np.float32)
    qe = rng.uniform(size=(p, ck)).astype(np.float32)
    t = torch.from_numpy
    sim = tmem.get_similarity(t(mk)[None], t(ms)[None], t(qk)[None],
                              t(qe)[None])[0]

    # csrc/radix_topk_readout.cu, step 1, in numpy fp32
    s = np.zeros((p, n), np.float32)
    for c in range(ck):
        d = mk[None, :, c] - qk[:, None, c]
        s = s + (qe[:, None, c] * d) * d
    ref = (s * ms[None]) * np.float32(-1.0 / np.sqrt(ck))
    np.testing.assert_array_equal(sim.numpy().view(np.uint32),
                                  ref.view(np.uint32))

    m64, q64, e64 = mk.astype(np.float64), qk.astype(np.float64), qe.astype(np.float64)
    sim64 = -(e64[:, None] * (m64[None] - q64[:, None]) ** 2).sum(-1) \
        * ms.astype(np.float64)[None] / np.sqrt(ck)
    dist = (tmem._float_order_key(sim)
            - tmem._float_order_key(t(sim64.astype(np.float32)))).abs()
    assert int(dist.max()) <= ck + 8


def test_read_wrapper_rejects_other_devices():
    mk, ms, valid, qk, qe, vals = (torch.from_numpy(x).to("meta")
                                   for x in _inputs(0, 64, 8, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        radix_topk_readout(mk, ms, valid, qk, qe, vals, K)


# ------------------------------------------- the CUDA wrapper's host logic

@pytest.mark.parametrize("n,p,budget", [
    (8_100, 1_620, None),        # d17: one wave
    (38_134, 2_546, None),       # lvos600: two waves
    (1_000, 150, 4 * 1_000 * 64),  # P that the wave does not divide
    (1_001, 150, 4 * 1_004 * 64 - 1),  # a budget under one tile: one tile
])
def test_read_waves_fit_the_workspace(n, p, budget):
    from cutie_tpu_torch.ops import read_kernel as rk

    budget = budget or rk.WORKSPACE_BYTES
    waves = rk.radix_topk_readout_waves(n, p, budget)
    assert rk.workspace_ld(n) % 4 == 0 and n <= rk.workspace_ld(n) < n + 4
    assert [w[0] for w in waves] == list(range(0, p, waves[0][1]))
    assert sum(w[1] for w in waves) == p
    assert all(w[1] % rk.QUERY_TILE == 0 for w in waves[:-1])
    assert 0 < waves[-1][1] <= waves[0][1]
    row = 4 * rk.workspace_ld(n)
    if waves[0][1] > rk.QUERY_TILE:
        assert waves[0][1] * row <= budget
    else:
        assert waves[0][1] == min(p, rk.QUERY_TILE)
    if len(waves) > 1:  # no larger multiple of the tile fits
        assert (waves[0][1] + rk.QUERY_TILE) * row > budget
    expect = {(8_100, 1_620): 1, (38_134, 2_546): 2, (1_000, 150): 3,
              (1_001, 150): 3}[(n, p)]
    assert len(waves) == expect


class _FakeReadLibrary:
    """Records the stage launches the wrapper makes (stage, first query,
    queries, workspace row length); returns fail_with."""

    def __init__(self, fail_with=0):
        self.calls, self.fail_with = [], fail_with

    def radix_topk_readout_similarity_launch(self, *args):
        self.calls.append(("similarity", args[7], args[8], args[9]))
        return self.fail_with

    def radix_topk_readout_select_launch(self, *args):
        self.calls.append(("select", args[14], args[15], args[1]))
        return 0


def test_read_wrapper_counts_one_launch_per_read(monkeypatch):
    """Stage launches go wave by wave, similarity then select, and the read
    counts once however many waves it takes; a failed launch raises and
    counts nothing. The library and the device are stand-ins: the host
    logic is what runs here."""
    from cutie_tpu_torch.ops import read_kernel as rk

    mk, ms, valid, qk, qe, vals = (torch.from_numpy(x)
                                   for x in _inputs(0, 300, 150, 2))
    lib = _FakeReadLibrary()
    monkeypatch.setattr(rk, "KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(rk, "_library", lambda source: lib)
    monkeypatch.setattr(rk, "_on_device", lambda dev: contextlib.nullcontext(0))
    monkeypatch.setattr(rk, "WORKSPACE_BYTES", 4 * 300 * 64)
    before = rk.radix_topk_readout.launches
    out, usage, tau = rk.radix_topk_readout_cuda(mk, ms, valid, qk, qe, vals, K)
    assert rk.radix_topk_readout.launches == before + 1
    assert lib.calls == [(stage, p0, count, 300)  # rows of 300 keys
                         for p0, count in ((0, 64), (64, 64), (128, 22))
                         for stage in ("similarity", "select")]
    assert out.shape == (2, 150, 64) and usage.shape == (300,) and tau.shape == (150,)

    monkeypatch.setattr(rk, "_library", lambda source: _FakeReadLibrary(700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        rk.radix_topk_readout_cuda(mk, ms, valid, qk, qe, vals, K)
    assert rk.radix_topk_readout.launches == before + 1


def test_read_cuda_wrapper_raises_without_a_card():
    """The CUDA entry point refuses CPU tensors rather than run the plain
    version: the plain version runs only through radix_topk_readout."""
    from cutie_tpu_torch.ops import read_kernel as rk

    args = (torch.from_numpy(x) for x in _inputs(0, 64, 8, 1))
    before = rk.radix_topk_readout.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        rk.radix_topk_readout_cuda(*args, K)
    assert rk.radix_topk_readout.launches == before
