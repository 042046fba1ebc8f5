"""The network's stages replayed from CUDA graphs (cutie_tpu_torch/models/
cutie.py:StageGraphs), on the card; each test skips without one.

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_stage_graphs_card.py

(--noconftest: tests/conftest.py imports JAX; this file imports neither
JAX nor the cutie_tpu package, so it runs where only the port is installed.)

For each of the six stages of cutie-base (random weights), at 480p and
720p, 1 and 3 objects, the decoder with and without its sensory update,
flip_aug's batch of 2 and the amp model: a key's first call runs eagerly,
its second captures, its later calls replay, and the counters read one
capture and n - 2 replays for n calls. Every output (the capture's, and
two replays' on other inputs) is bit-equal to the eager call's on the
same inputs, under cuDNN's timing as in InferenceCore.step; and the
outputs of a replay that the caller holds (a frame's features, the new
sensory memory) are unchanged by the next replay of the same graph.
"""
import pytest
import torch
from torch.utils import _pytree as pytree

from cutie_tpu_torch.config import eval_config
from cutie_tpu_torch.inference.inference_core import cudnn_timing
from cutie_tpu_torch.models import cutie as cutie_module
from cutie_tpu_torch.ops.tensor_utils import clip
from cutie_tpu_torch.utils.get_default_model import build_model

pytestmark = pytest.mark.card

# name: (padded height, width, objects, batch, amp)
CASES = {
    "480p-1": (480, 864, 1, 1, False),
    "480p-3": (480, 864, 3, 1, False),
    "720p-1": (720, 1280, 1, 1, False),
    "720p-3": (720, 1280, 3, 1, False),
    "480p-3-flip": (480, 864, 3, 2, False),
    "480p-3-amp": (480, 864, 3, 1, True),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def nets(card):
    out = {}
    for amp in (False, True):
        cfg = eval_config("base")
        cfg.amp = amp
        torch.manual_seed(0)
        out[amp] = build_model(cfg, device=str(card))
    return out


def _inputs(net, h, w, o, b, seed):
    """Random arguments of every stage at padded size h x w."""
    mc = net.model_cfg
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    h16, w16 = h // 16, w // 16
    ms = tuple(r(b, c, h16 * s, w16 * s)
               for c, s in zip(mc.pixel_encoder.ms_dims, (1, 2, 4)))
    e = mc.object_transformer.embed_dim
    return dict(
        image=r(b, 3, h, w), ms=ms, pix_feat=r(b, mc.pixel_dim, h16, w16),
        readout=r(b, o, mc.value_dim, h16, w16),
        sensory=r(b, o, mc.sensory_dim, h16, w16), masks=r(b, o, h, w),
        fused=r(b, o, e, h16, w16),
        obj_mem=r(b, o, 1, mc.object_transformer.num_queries, e + 1),
        mem_readout=r(b, o, mc.embed_dim, h16, w16),
        selector=torch.ones(b, o, device="cuda"))


CALLS = {
    "encode_image": lambda n, x: n.encode_image(x["image"]),
    "transform_key": lambda n, x: n.transform_key(x["ms"][0]),
    "pixel_fusion": lambda n, x: n.pixel_fusion(x["pix_feat"], x["readout"],
                                                x["sensory"], x["masks"]),
    "readout_query": lambda n, x: n.readout_query(x["fused"], x["obj_mem"],
                                                  selector=x["selector"]),
    "segment": lambda n, x: n.segment(x["ms"], x["mem_readout"], x["sensory"],
                                      selector=x["selector"], update_sensory=True),
    "segment_no_update": lambda n, x: n.segment(
        x["ms"], x["mem_readout"], x["sensory"], selector=x["selector"],
        update_sensory=False),
    "encode_mask": lambda n, x: n.encode_mask(x["image"], x["pix_feat"],
                                              x["sensory"], x["masks"]),
}


def _counters():
    s = cutie_module._stage
    return s.eager, s.captures, s.replays


def _bit_equal(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y), float((x.float() - y.float()).abs().max())
        else:
            assert x == y


def _detached(out):
    return pytree.tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, out)


# the frame's stages see no objects: one case a frame shape
FRAME_STAGES = ("encode_image", "transform_key")
PAIRS = [(case, stage) for case in CASES for stage in CALLS
         if not (stage in FRAME_STAGES and CASES[case][2] == 1)]


@pytest.mark.parametrize("case,stage", PAIRS)
def test_replay_is_bit_equal_to_the_eager_stage(nets, card, case, stage):
    h, w, o, b, amp = CASES[case]
    net, call = nets[amp], CALLS[stage]
    xs = [_inputs(net, h, w, o, b, seed) for seed in (1, 2, 3)]
    with torch.no_grad(), cudnn_timing(card):
        before = _counters()
        first = call(net, xs[0])        # eager: cuDNN times its plans
        captured = call(net, xs[0])     # captured, then replayed once
        replayed = call(net, xs[1])
        held = pytree.tree_map(lambda x: x.clone() if torch.is_tensor(x) else x,
                               replayed)
        later = call(net, xs[2])
        after = _counters()
        # grad on: the eager path
        with torch.enable_grad():
            eager = [_detached(call(net, x)) for x in xs[1:]]
    torch.cuda.synchronize()
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (1, 1, 2)
    _bit_equal(captured, first)
    _bit_equal(replayed, eager[0])
    _bit_equal(later, eager[1])
    # what the caller held from one replay is its own
    _bit_equal(replayed, held)


def test_clip_on_the_card_keeps_the_half_gradient(card):
    lo, hi = 1e-7, 1 - 1e-7
    x = torch.tensor([-1.0, lo, 0.5, hi, 2.0], device=card, requires_grad=True)
    y = clip(x, lo, hi)
    assert y.device == x.device
    (y * torch.arange(1.0, 6.0, device=card)).sum().backward()
    assert x.grad.tolist() == [0.0, 1.0, 3.0, 2.0, 0.0]
    assert torch.equal(y.detach().cpu(), clip(x.detach().cpu(), lo, hi))
