"""The function of the port's streaming read kernel
(cutie_tpu_torch/ops/read_kernel.py:fused_topk_readout) against cutie_tpu's
TPU kernel pallas_kernels.fused_topk_readout in interpret mode, on the CPU.

On the CPU the port's wrapper runs the plain version, which is the same
function as the radix read's (radix_topk_readout_plain); the CUDA kernel
csrc/fused_topk_readout.cu is held to it, and to the radix kernel, on the
card by chip_smoke.py.

Tolerances (those of tests/test_torch_read.py against the TPU kernels): the
readout rtol 1e-4, atol 1e-5, usage rtol 1e-5, atol 1e-5. The TPU kernel
evaluates the similarity in the expanded form and the port in the direct
form; both keep the same tokens here and differ in the weights by fp32
rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cutie_tpu.ops.pallas_kernels import fused_topk_readout as jax_fused  # noqa: E402
from cutie_tpu_torch.ops.read_kernel import (fused_topk_readout,  # noqa: E402
                                             radix_topk_readout_plain)

K = 30


@pytest.fixture(autouse=True, scope="module")
def _synchronous_jax_dispatch():
    """Synchronous JAX dispatch, as in tests/test_torch_read.py."""
    old = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", old)


def _case(seed, n, p, o, cv, n_valid, ms_uniform=True, tied=0):
    """tests/test_pallas_kernel.py's inputs; `tied` > 0 makes memory
    tokens 0..tied-1 one repeated key and points the first 16 queries at
    it, so that their k-th largest similarity is a tie of `tied` tokens."""
    rng = np.random.default_rng(seed)
    ck = 64
    mk = rng.normal(size=(n, ck)).astype(np.float32)
    ms = (rng.uniform(1, 3, size=(n,)) if ms_uniform
          else np.ones((n,))).astype(np.float32)
    valid = np.zeros((n,), bool)
    valid[:n_valid] = True
    qk = rng.normal(size=(p, ck)).astype(np.float32)
    qe = rng.uniform(size=(p, ck)).astype(np.float32)
    vals = rng.normal(size=(o, n, cv)).astype(np.float32)
    if tied:
        mk[:tied] = mk[0]
        ms[:tied] = ms[0]
        qk[:16] = mk[0] + 0.01 * rng.normal(size=(16, ck)).astype(np.float32)
    return mk, ms, valid, qk, qe, vals


CASES = {
    # tests/test_pallas_kernel.py:6-37 and :40-61
    "700_of_1024_valid": dict(seed=0, n=1024, p=256, o=3, cv=128, n_valid=700),
    "fewer_valid_than_k": dict(seed=1, n=256, p=128, o=1, cv=128, n_valid=5,
                               ms_uniform=False),
    "ties_at_kth_value": dict(seed=2, n=512, p=128, o=2, cv=128, n_valid=480,
                              tied=60),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_read_matches_tpu_kernel(name):
    mk, ms, valid, qk, qe, vals = _case(**CASES[name])
    rd_j, us_j = jax_fused(jnp.asarray(mk), jnp.asarray(ms), jnp.asarray(valid),
                           jnp.asarray(qk), jnp.asarray(qe), jnp.asarray(vals), K,
                           block_p=128, block_n=256, interpret=True)
    rd_j, us_j = np.asarray(rd_j), np.asarray(us_j)

    t = torch.from_numpy
    launches = fused_topk_readout.launches
    rd, us = fused_topk_readout(t(mk), t(ms), t(valid), t(qk), t(qe), t(vals), K)
    assert fused_topk_readout.launches == launches  # CPU: the plain version
    assert rd.shape == vals.shape[:1] + qk.shape[:1] + vals.shape[2:]
    np.testing.assert_allclose(rd.numpy(), rd_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(us.numpy(), us_j, rtol=1e-5, atol=1e-5)
    # one plain version for both kernels
    rd_r, us_r = radix_topk_readout_plain(t(mk), t(ms), t(valid), t(qk), t(qe),
                                          t(vals), K)
    assert torch.equal(rd, rd_r) and torch.equal(us, us_r)

    p = qk.shape[0]
    if name == "fewer_valid_than_k":
        np.testing.assert_allclose(us.numpy().sum(), p, rtol=1e-4)
        assert np.abs(us.numpy()[5:]).max() == 0.0
    if name == "ties_at_kth_value":
        # every copy of the repeated key is kept by the queries aimed at it,
        # by both kernels: 60 tokens share their 30th largest similarity
        assert (us.numpy()[:60] > 0).all() and (us_j[:60] > 0).all()
        np.testing.assert_allclose(us.numpy()[:60], us.numpy()[0], rtol=1e-6)


def test_fused_read_wrapper_rejects_other_devices():
    mk, ms, valid, qk, qe, vals = (torch.from_numpy(x).to("meta") for x in
                                   _case(0, 64, 8, 1, 8, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_topk_readout(mk, ms, valid, qk, qe, vals, K)
