"""The port's point sampling (cutie_tpu_torch/ops/point_features.py) and
losses (cutie_tpu_torch/training/losses.py) against cutie_tpu's, on the CPU.

Both packages get the same random coordinates: the port's losses take the
candidates and random points as inputs (draw_point_candidates is apart from
pick_uncertain_points), and these tests draw them from the jax.random keys
cutie_tpu's loss splits, in its order.

Tolerances: fp32 rounding of a bilinear blend and its gradient (rtol and
atol 1e-5; the same points picked, coordinates bit-equal); losses rtol 1e-5;
the gradients of the losses with respect to the logits atol 1e-6 x their
largest value (a point sample's weights are summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cutie_tpu.ops.point_features as jpf  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401
from tests.test_torch_train_model import _synchronous_jax_dispatch  # noqa: E402,F401

from cutie_tpu_torch.ops import point_features as pf  # noqa: E402
from cutie_tpu_torch.training.losses import LossComputer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _grad_of(fn, x):
    """d sum(sin(fn(x))) / dx, through autograd."""
    x = torch.from_numpy(x).requires_grad_(True)
    torch.sin(fn(x)).sum().backward()
    return x.grad.numpy()


@pytest.mark.parametrize("small_map_pixels", [4096, 0])
def test_point_sample_and_grad_match_cutie_tpu(small_map_pixels, monkeypatch):
    """Both of cutie_tpu's forward paths (separable matmul for small maps,
    4-corner gather above _SMALL_MAP_PIXELS), its custom backward with
    respect to the map, and points outside the map (zero padding)."""
    monkeypatch.setattr(jpf, "_SMALL_MAP_PIXELS", small_map_pixels)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4, 17, 23)).astype(np.float32)
    coords = rng.uniform(-0.05, 1.05, size=(3, 57, 2)).astype(np.float32)
    c = torch.from_numpy(coords)
    np.testing.assert_allclose(pf.point_sample(torch.from_numpy(x), c).numpy(),
                               np.asarray(jpf.point_sample(x, coords)), **TOL)
    g = jax.grad(lambda m: jnp.sum(jnp.sin(jpf.point_sample(m, coords))))(x)
    np.testing.assert_allclose(_grad_of(lambda m: pf.point_sample(m, c), x),
                               np.asarray(g), **TOL)


@pytest.mark.parametrize("factor", [4, 2, 1])
def test_point_sample_upsampled_and_grad_match_cutie_tpu(factor):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 9, 13)).astype(np.float32)
    coords = rng.uniform(-0.05, 1.05, size=(2, 64, 2)).astype(np.float32)
    c = torch.from_numpy(coords)
    ours = pf.point_sample_upsampled(torch.from_numpy(x), c, factor).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jpf.point_sample_upsampled(x, coords, factor)), **TOL)
    g = jax.grad(lambda m: jnp.sum(jnp.sin(
        jpf.point_sample_upsampled(m, coords, factor))))(x)
    np.testing.assert_allclose(
        _grad_of(lambda m: pf.point_sample_upsampled(m, c, factor), x),
        np.asarray(g), **TOL)


@pytest.mark.parametrize("num_classes", [3, 5])
def test_point_sample_cls_onehot_matches_cutie_tpu(num_classes):
    """Out-of-range corners must read as zero, not as class 0."""
    rng = np.random.default_rng(4)
    cls = rng.integers(0, num_classes, size=(2, 21, 17))
    coords = rng.uniform(-0.05, 1.05, size=(2, 133, 2)).astype(np.float32)
    ours = pf.point_sample_cls_onehot(torch.from_numpy(cls.astype(np.uint8)),
                                      torch.from_numpy(coords), num_classes)
    theirs = jpf.point_sample_cls_onehot(jnp.asarray(cls), coords, num_classes)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("num_classes", [2, 5])
def test_calculate_uncertainty_matches_cutie_tpu(num_classes):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, num_classes, 211)).astype(np.float32)
    logits[0, :, :5] = 1.0   # ties at the top give a margin of 0
    np.testing.assert_array_equal(
        pf.calculate_uncertainty(torch.from_numpy(logits)).numpy(),
        np.asarray(jpf.calculate_uncertainty(logits)))


def _jax_draw(key, n, num_points, oversample, importance):
    """The coordinates cutie_tpu's get_uncertain_point_coords_with_randomness
    draws from `key`: (candidates, random points)."""
    k1, k2 = jax.random.split(key)
    num_random = num_points - int(importance * num_points)
    return (np.array(jax.random.uniform(k1, (n, int(num_points * oversample), 2))),
            np.array(jax.random.uniform(k2, (n, num_random, 2))))


@pytest.mark.parametrize("factor", [4, 1])
def test_uncertain_points_match_cutie_tpu(factor):
    """The same candidates give the same points, in the same order."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 4, 9, 11)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    sample = ((lambda m, c: jpf.point_sample_upsampled(m, c, factor)) if factor > 1
              else jpf.point_sample)
    theirs = jpf.get_uncertain_point_coords_with_randomness(
        key, logits, jpf.calculate_uncertainty, 100, 3.0, 0.75, sample_fn=sample)
    cand, rand = _jax_draw(key, 2, 100, 3.0, 0.75)
    ours = pf.pick_uncertain_points(
        torch.from_numpy(logits), torch.from_numpy(cand), torch.from_numpy(rand), 75,
        pf.calculate_uncertainty,
        lambda m, c: pf.point_sample_upsampled(m, c, factor))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_uncertain_point_coords_draw_then_pick():
    """get_uncertain_point_coords_with_randomness is draw_point_candidates
    then pick_uncertain_points on the same generator's draws."""
    logits = torch.from_numpy(
        np.random.default_rng(7).normal(size=(3, 4, 9, 11)).astype(np.float32))
    coords = pf.get_uncertain_point_coords_with_randomness(
        torch.Generator().manual_seed(4), logits, pf.calculate_uncertainty, 50,
        3.0, 0.75)
    cand, rand = pf.draw_point_candidates(torch.Generator().manual_seed(4), 3, 50,
                                          3.0, 0.75, logits.device)
    assert cand.shape == (3, 150, 2) and rand.shape == (3, 13, 2)
    assert torch.equal(coords, pf.pick_uncertain_points(logits, cand, rand, 37))


def stage_cfgs(**overrides):
    """(cutie_tpu's, the port's) main_training stage config, with overrides."""
    from cutie_tpu.train import train_config as jax_train_config
    from cutie_tpu_torch.train import train_config

    return (jax_train_config().main_training.merge(dict(overrides)),
            train_config().main_training.merge(dict(overrides)))


def _model_cfgs():
    from cutie_tpu.config import eval_config as jax_eval_config
    from cutie_tpu_torch.config import eval_config

    return jax_eval_config("small"), eval_config("small")


def _loss_inputs(seed, b=2, t=2, c=3, levels=4):
    rng = np.random.default_rng(seed)
    return {
        "logits_low": rng.normal(size=(b, t, c, 8, 8)).astype(np.float32),
        "sensory_logits": rng.normal(size=(b, t, c, 2, 2)).astype(np.float32),
        "q_logits": rng.normal(size=(b, t, c, levels, 2, 2)).astype(np.float32),
        "cls_gt": rng.integers(0, c, size=(b, t, 32, 32)).astype(np.uint8),
    }, np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)[:b]


@pytest.mark.parametrize("up_factor", [4, 1])
def test_mask_loss_matches_cutie_tpu(up_factor):
    jstage, stage = stage_cfgs(train_num_points=64)
    jcfg, cfg = _model_cfgs()
    data, selector = _loss_inputs(7)
    logits = data["logits_low"][0] if up_factor > 1 else data["sensory_logits"][0]
    key = jax.random.PRNGKey(11)
    from cutie_tpu.training.losses import LossComputer as JaxLossComputer

    jce, jdice = JaxLossComputer(jcfg, jstage).mask_loss(
        key, logits, data["cls_gt"][0], selector[0], up_factor=up_factor)
    points = [torch.from_numpy(p)
              for p in _jax_draw(key, logits.shape[0], 64, 3.0, 0.75)]
    ce, dice = LossComputer(cfg, stage).mask_loss(
        torch.from_numpy(logits), torch.from_numpy(data["cls_gt"][0]),
        torch.from_numpy(selector[0]), points, up_factor=up_factor)
    np.testing.assert_allclose(ce.item(), float(jce), rtol=1e-5)
    np.testing.assert_allclose(dice.item(), float(jdice), rtol=1e-5)


def test_loss_compute_and_grads_match_cutie_tpu():
    """LossComputer.compute over a batch of two (the second with a padded
    object), every loss key, and the gradient of total_loss with respect to
    each logits input."""
    from cutie_tpu.training.losses import LossComputer as JaxLossComputer

    jstage, stage = stage_cfgs(train_num_points=48)
    jcfg, cfg = _model_cfgs()
    data, selector = _loss_inputs(8)
    key = jax.random.PRNGKey(5)
    inputs = ("logits_low", "sensory_logits", "q_logits")

    def jloss(logits):
        losses = JaxLossComputer(jcfg, jstage).compute(
            key, dict(logits, cls_gt=data["cls_gt"]), selector)
        return losses["total_loss"], losses

    jgrads, jlosses = jax.grad(jloss, has_aux=True)({k: data[k] for k in inputs})

    draws = []
    for seq_key in jax.random.split(key, 2):
        heads = jax.random.split(seq_key, 8)
        for head in range(2 + data["q_logits"].shape[3]):
            draws.append(_jax_draw(heads[head], 2, 48, 3.0, 0.75))
    draws.reverse()

    def draw(n, device):
        return tuple(torch.from_numpy(p) for p in draws.pop())

    t = {k: torch.from_numpy(data[k]).requires_grad_(True) for k in inputs}
    losses = LossComputer(cfg, stage).compute(
        dict(t, cls_gt=torch.from_numpy(data["cls_gt"])), torch.from_numpy(selector),
        draw)
    assert not draws
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]), rtol=1e-5, err_msg=k)
    losses["total_loss"].backward()
    for k in inputs:
        g = np.asarray(jgrads[k])
        np.testing.assert_allclose(t[k].grad.numpy(), g, rtol=0,
                                   atol=1e-6 * np.abs(g).max(), err_msg=k)
