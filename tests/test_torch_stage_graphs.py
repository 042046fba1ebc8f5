"""The CUDA graphs of the network's stages (cutie_tpu_torch/models/cutie.py:
StageGraphs) and the stage bodies they capture, on the CPU:

- a stage call's key separates shapes, dtypes, strides, flags, a selector
  given or not, and the compute (autocast) dtype, and joins calls that
  differ only in their values;
- a stage runs eagerly on the CPU and with grad enabled, counted in
  _stage.eager, and keeps no key and no graph;
- clip's bounds are host scalars (no upload), with the values and the half
  gradient at a tie of the clip it replaced;
- positional_encoding returns numpy's table, the same tensor object on
  every call of a shape and device.

The replays themselves run on the card: tests/test_torch_stage_graphs_card.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.config import eval_config  # noqa: E402
from cutie_tpu_torch.models import cutie as cutie_module  # noqa: E402
from cutie_tpu_torch.models.cutie import stage_key  # noqa: E402
from cutie_tpu_torch.models.positional_encoding import (  # noqa: E402
    _pos_enc_np, positional_encoding)
from cutie_tpu_torch.ops.tensor_utils import _host_scalar, clip  # noqa: E402
from cutie_tpu_torch.utils.get_default_model import build_model  # noqa: E402

H, W = 32, 48


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    fp32 = build_model(eval_config("small"), device="cpu")
    cfg = eval_config("small")
    cfg.amp = True
    return fp32, build_model(cfg, device="cpu")


def _segment_args(b=1, o=2, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    h, w = H // 16, W // 16

    def r(*shape):
        return torch.rand(shape, generator=g).to(dtype)

    ms = (r(b, 256, h, w), r(b, 128, 2 * h, 2 * w), r(b, 64, 4 * h, 4 * w))
    return (ms, r(b, o, 256, h, w), r(b, o, 256, h, w)), {
        "selector": r(b, o), "update_sensory": True}


def _key(net, args, kwargs, name="segment"):
    return stage_key(net, name, args, kwargs)[0]


def test_stage_key_separates_what_the_capture_depends_on(nets):
    fp32, amp = nets
    args, kwargs = _segment_args()
    key = _key(fp32, args, kwargs)
    # other values, the same key
    assert _key(fp32, *_segment_args(seed=1)) == key
    ms, readout, sensory = args
    differ = {
        "name": _key(fp32, args, kwargs, name="encode_mask"),
        "objects": _key(fp32, *_segment_args(o=3)),
        "batch": _key(fp32, *_segment_args(b=2)),
        "dtype": _key(fp32, *_segment_args(dtype=torch.float64)),
        "stride": _key(fp32, (ms, readout.transpose(-1, -2).contiguous()
                              .transpose(-1, -2), sensory), kwargs),
        "update_sensory": _key(fp32, args, dict(kwargs, update_sensory=False)),
        "no selector": _key(fp32, args, dict(kwargs, selector=None)),
        "return_low_logits": _key(fp32, args, dict(kwargs, return_low_logits=True)),
        "autocast dtype": _key(amp, args, kwargs),
    }
    for what, other in differ.items():
        assert other != key, what
    assert len(set(differ.values())) == len(differ)
    # the key is hashable, as the cache's dictionaries need
    assert len({key, *differ.values()}) == len(differ) + 1


def test_stage_key_separates_the_global_modes(nets):
    fp32, _ = nets
    args, kwargs = _segment_args()
    key = _key(fp32, args, kwargs)
    before = torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.benchmark = not before
        assert _key(fp32, args, kwargs) != key
    finally:
        torch.backends.cudnn.benchmark = before
    with torch.inference_mode():
        assert _key(fp32, args, kwargs) != key
    fp32.train()
    try:
        assert _key(fp32, args, kwargs) != key
    finally:
        fp32.eval()
    assert _key(fp32, args, kwargs) == key


@pytest.mark.parametrize("grad", [False, True])
def test_stage_runs_eagerly_on_the_cpu_and_with_grad(nets, grad):
    fp32, _ = nets
    image = torch.rand(1, 3, H, W)
    before = (cutie_module._stage.eager, cutie_module._stage.captures,
              cutie_module._stage.replays)
    with torch.set_grad_enabled(grad):
        outs = [fp32.encode_image(image) for _ in range(3)]
        key = fp32.transform_key(outs[0][0][0])
    assert cutie_module._stage.eager == before[0] + 4
    assert (cutie_module._stage.captures, cutie_module._stage.replays) == before[1:]
    assert not fp32.stage_graphs.seen and not fp32.stage_graphs.graphs
    for (ms, pix), (ms0, pix0) in zip(outs, outs[:1] * 3):
        assert all(torch.equal(a, b) for a, b in zip(ms, ms0))
        assert torch.equal(pix, pix0)
    assert len(key) == 3 and key[0].requires_grad == grad


def test_moving_the_network_drops_its_graphs(nets):
    fp32, _ = nets
    fp32.stage_graphs.seen["k"] = 1
    fp32.stage_graphs.graphs["k"] = None
    fp32.to("cpu")
    assert not fp32.stage_graphs.seen and not fp32.stage_graphs.graphs


def _old_clip(x, lo, hi):
    """clip as it was: bounds uploaded with x.new_tensor on every call."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_clip_values_and_half_gradient_at_a_tie(dtype):
    lo, hi = 1e-7, 1 - 1e-7
    x = torch.tensor([-1.0, 0.0, lo, 0.3, hi, 1.0, 2.0], dtype=dtype)
    x = torch.cat([x, torch.tensor([lo, hi], dtype=dtype)])
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ours, theirs = clip(xs[0], lo, hi), _old_clip(xs[1], lo, hi)
    assert ours.dtype == theirs.dtype == dtype
    assert torch.equal(ours, theirs)
    weights = torch.arange(1, x.numel() + 1, dtype=dtype)
    (ours * weights).sum().backward()
    (theirs * weights).sum().backward()
    assert torch.equal(xs[0].grad, xs[1].grad)
    # half the gradient where x equals a bound as x's dtype rounds it
    at_bound = (x == torch.tensor(lo, dtype=dtype)) | (x == torch.tensor(hi, dtype=dtype))
    assert at_bound.any()
    np.testing.assert_array_equal(xs[0].grad[at_bound].float().numpy(),
                                  0.5 * weights[at_bound].float().numpy())
    # the bounds are 0-dim CPU tensors, made once a value and dtype
    bound = _host_scalar(lo, dtype)
    assert bound.dim() == 0 and bound.device.type == "cpu" and bound.dtype == dtype
    assert _host_scalar(lo, dtype) is bound


def test_positional_encoding_is_uploaded_once():
    table = positional_encoding(5, 7, 16, device=torch.device("cpu"))
    np.testing.assert_array_equal(table.numpy(),
                                  _pos_enc_np(5, 7, 16, 2 * np.pi, 10000.0))
    assert table.dtype == torch.float32 and table.shape == (16, 5, 7)
    assert positional_encoding(5, 7, 16, device=torch.device("cpu")) is table
    assert positional_encoding(5, 7, 16) is table
    other = positional_encoding(5, 8, 16)
    assert other is not table and other.shape == (16, 5, 8)
