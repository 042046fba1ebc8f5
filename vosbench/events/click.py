"""click: an annotator's clicks on objects of the frame, through the port's
RITM click model, committed into the stream.

    {"at": 15, "kind": "click", "objects": [1], "clicks": 3}

What cutie_tpu_torch.gui.MainController.click does, for each named object
in turn: a ClickInteraction over the port's ClickController (the
configuration's `click` block: RITM HRNet-18 + OCR under f-BRS-B with the
device L-BFGS drive, fp32) from the frame's image and the GUI's
probabilities, `clicks` push_point calls, and predict(). The clicks follow
RITM's NoC protocol (ritm.inference.Clicker with the video's mask of the
object): each falls inside the largest error region of the object's
current mask, positive or negative by the error's sign. The first
object's GUI probabilities are the port's prediction for the frame before
(the last mask InferenceCore holds, at the frame's size, the background
one minus the objects' sum: the step's output, which the GUI holds as
curr_prob); each later object's, the interaction's output before it. The
step is then given the argmax index mask of the last output, for every
object it holds (frame.give): a new object becomes a bucket of its own,
as with `add`, and a known one is memorized. Everything above counts in
the frame's time.

Two departures from MainController.on_commit: it steps the soft
probabilities with force_permanent=True, where the step here takes the
index mask (Frame and the reference stream take index masks only) and
memorizes the frame as any frame with a mask (permanent for new objects,
working memory for known ones); and the first object's probabilities are
the frame before's prediction, where the GUI would hold this frame's
after propagating to it.

The check (numbers): for each sampled frame with clicks, the plain
reference (vosbench/reference/ritm) follows each object's clicks from
what the program held before each one (its clicks, the previous mask, the
L-BFGS start and end point; the zoom-in's crop it computes itself from
the program's previous probabilities, as upstream's ZoomIn does):
  click_prob_gap  the largest |p - p_ref| of the frame's clicks, the
                  reference at the program's own clicks, previous mask
                  and final scale and bias; the median over the frames
  brs_loss_gap    for each optimised click (the second on), the
                  program's final f-BRS objective less the best that the
                  reference's own L-BFGS-B reaches from the program's
                  start, both evaluated by the reference, summed over the
                  sampled frames' optimised clicks, as a share of what
                  that search gains from the start, summed likewise: 0
                  where the program's search does as well, 1 where it
                  stays at its start (skipped); 0 where the reference's
                  search gains no more than GAIN_FLOOR in all. The
                  program's drive (L-BFGS with a zoom line search,
                  ritm/lbfgs.py) and scipy's L-BFGS-B take different
                  paths, so a click reads either side of 0; most gains
                  are tiny, and the sums weigh the clicks by theirs
  brs_stops_unconfirmed
                  the share of those optimised clicks whose search
                  stopped where the reference does not confirm its exit:
                  the budget (maxfun evaluations spent), satisfied clicks
                  (at the search's end point), or a settled mask (the
                  last iteration's two points' masks within IoU
                  STOP_IOU_SLACK x min_iou_diff). The two searches part
                  by their paths, so brs_loss_gap cannot tell a search
                  cut short by a few evaluations from a sound one; this
                  can (a skipped search reads 1 on both)
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from vosbench import ritm_trace
from vosbench.reference.ritm import lbfgs_b
from vosbench.video import SEED_MASK, rng_for
from vosbench.weights import _affine, load_weights

# ScaleLayer's |scale| (init 0.05, maps_transform's last layer): U(0.04, 0.06)
SCALE_AFFINE = (0.02, 0.04)
# the click model's weights in units of 1/sqrt(fan_in): PyTorch's default
# scale, at which its probabilities sit near 0.5, as those of the GUI's
# HRNet built without a checkpoint do (at vosbench/weights.py's 1.5 its
# logits saturate on some draws, and every f-BRS search there ends at its
# first evaluation)
GAIN = 1.0
# The click network is drawn from the configuration's click.network_seed,
# the same in every run; the frames, the clicks and the Cutie network come
# from --seed. The GUI runs one released checkpoint in every session, so the
# click network belongs to the deployment, as a checkpoint would, and not
# to the traffic (PERF.md section 6 gives how that seed was chosen).
# brs_loss_gap is 0 where the reference's searches lower the objective
# from the program's starts by no more than this in all (the objective is
# about 0.5, at float32's 6e-8 resolution)
GAIN_FLOOR = 1e-6
# a stop is confirmed within this much of the drive's own exit tests: the
# reference's masks and click probabilities at the program's points part
# from the program's by a few pixels and ulps
STOP_IOU_SLACK = 2.0
STOP_PROB_SLACK = 1e-3
# the last setup's state: the harness calls numbers(samples, reference_out)
# with no handle on it, so the module keeps it (one run a process at a time)
_LAST: List[Optional[SimpleNamespace]] = [None]


def _click_affine(name: str, shape, shapes):
    """vosbench/weights.py's (scale, offset) of a tensor, with the weights
    at GAIN and ScaleLayer's scale about its init."""
    if name.endswith(".scale"):
        return SCALE_AFFINE
    if name.endswith("weight") and len(shape) >= 2:
        bound = GAIN / math.sqrt(math.prod(shape[1:]))
        return 2 * bound, -bound
    return _affine(name, shape, shapes)


def click_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Random weights for every floating tensor of the click model's state
    dict, drawn on `device` from the seed (vosbench/weights.py's rules
    at GAIN, with ScaleLayer's scale about its init), from a stream of the
    seed apart from the Cutie network's."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if v.is_floating_point()}
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    aff = torch.tensor([_click_affine(k, shapes[k], shapes) for k in names],
                       dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng_for(seed, 6).integers(1 << 62)) & SEED_MASK)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    n = flat.numel()
    flat = (flat * aff[:, 0].repeat_interleave(counts, output_size=n)
            + aff[:, 1].repeat_interleave(counts, output_size=n))
    return {k: t.view(shapes[k]) for k, t in zip(names, torch.split(flat, sizes))}


def predictor_params(block: dict) -> dict:
    """The `click` block's predictor in InteractiveController's form."""
    p = block["predictor"]
    return {"brs_mode": p["brs_mode"], "prob_thresh": p["prob_thresh"],
            "net_clicks_limit": p["net_clicks_limit"], "max_size": p["max_size"],
            "with_flip": p["with_flip"], "zoom_in_params": dict(p["zoom_in"]),
            "brs_opt_func_params": {"min_iou_diff": p["min_iou_diff"]},
            "lbfgs_params": {"maxfun": p["maxfun"]},
            "predictor_params": {"host_lbfgs": p["host_lbfgs"]}}


def setup(config_file, seed, device):
    """The port's ClickController on `device`, its model rebuilt by
    load_is_model from the block's HRNet keys in fp32, the block's
    predictor, and the weights of the block's network_seed."""
    from cutie_tpu_torch.ritm.utils import ClickController, load_is_model

    block = config_file["click"]
    p = block["predictor"]
    cc = ClickController(None, max_size=p["max_size"], brs_mode=p["brs_mode"],
                         amp=False, device=device, host_lbfgs=p["host_lbfgs"])
    cc.model = cc.controller.model = load_is_model(None, device, amp=False,
                                                   **block["model"])
    cc.controller.reset_predictor(predictor_params(block))
    load_weights(cc.model, click_weights(cc.model, block["network_seed"], device))
    ritm_trace.install()
    st = SimpleNamespace(controller=cc, block=block, device=device, records={},
                         committed={})
    _LAST[0] = st
    return st


def _gui_prob(core, h: int, w: int, channels: int) -> np.ndarray:
    """[channels, h, w] host probabilities, channel k object k, from the
    last mask the InferenceCore holds (zeros before its first step)."""
    prob = np.zeros((channels, h, w), np.float32)
    st = core.state
    ids = core.object_manager.all_obj_ids if st is not None else []
    if ids:
        from cutie_tpu_torch.ops.resize import bilinear_resize

        lw, uw, lh, uh = core.pad
        hp, wp = st.last_mask.shape[-2:]
        last = st.last_mask[0, :len(ids), lh:hp - uh, lw:wp - uw].float()
        if tuple(last.shape[-2:]) != (h, w):
            last = bilinear_resize(last, h, w)
        prob[ids] = last.cpu().numpy()
    prob[0] = 1.0 - prob[1:].sum(0)
    return prob


def program(core, event, frame):
    from cutie_tpu_torch.gui.interaction import ClickInteraction
    from cutie_tpu_torch.ritm.inference import Clicker

    st = frame.setup["click"]
    cc = st.controller
    h, w = frame.image.shape[:2]
    prob = _gui_prob(core, h, w, frame.video.num_objects + 1)
    image = np.transpose(frame.image.astype(np.float32) / 255.0, (2, 0, 1))
    truth = frame.video.mask(frame.i)
    objects = []
    for obj in event["objects"]:
        cc.unanchor()
        inter = ClickInteraction(image, prob, (h, w), cc, obj)
        clicker = Clicker(gt_mask=(truth == obj).astype(np.int8))
        current = prob[obj] > 0.5
        steps = []
        for _ in range(int(event.get("clicks", 3))):
            clicker.make_next_click(current)
            c = clicker.get_clicks()[-1]
            x0 = cc.controller.predictor.opt_data if cc.anchored else None
            inter.push_point(c.coords[1], c.coords[0], not c.is_positive)
            pred, f = cc.controller.predictor, cc.controller.predictor.opt_functor
            x = pred.opt_data
            if len(steps) + 1 > pred.optimize_after_n_clicks:
                # the point of the evaluation whose logits the click returns
                x = getattr(f, "best_x", None)
                if x is None:
                    raise RuntimeError("the program's f-BRS search does not "
                                       "report its best point (best_x)")
            info = f.drive_info or {}
            steps.append(dict(click=(c.coords[0], c.coords[1], c.is_positive),
                              x0=x0, x=x, out=inter.obj_mask, evals=f.n_evals,
                              exit=info.get("exit"), reads=info.get("host_reads"),
                              last_step=info.get("last_step")))
            current = inter.obj_mask > 0.5
        objects.append(dict(obj=obj, prev=prob[obj], steps=steps))
        prob = inter.predict()
    mask = prob.argmax(0).astype(np.uint8)
    given = sorted(set(core.object_manager.all_obj_ids) | set(event["objects"]))
    st.records[frame.i] = dict(image=frame.image, objects=objects)
    st.committed[frame.i] = (mask, given)
    frame.give(mask, given)


def reference(stream, event, frame):
    """The mask the program committed at this frame; a reference stream
    stepped with no program run (frame.setup without this kind) gets the
    video's masks of the clicked objects instead, the clicks' target."""
    st = frame.setup.get("click")
    if st is None:
        frame.give(frame.objects_mask(event["objects"]), event["objects"])
        return
    mask, given = st.committed[frame.i]
    frame.give(mask, given)


def schedule(memory, event):
    memory.mask(event["objects"])


def reference_params(block: dict):
    from vosbench.reference.ritm import Params

    p = block["predictor"]
    z = p["zoom_in"]
    return Params(prob_thresh=p["prob_thresh"], net_clicks_limit=p["net_clicks_limit"],
                  max_size=p["max_size"], with_flip=p["with_flip"],
                  skip_clicks=z["skip_clicks"], target_size=z["target_size"],
                  expansion_ratio=z["expansion_ratio"],
                  min_iou_diff=p["min_iou_diff"], maxfun=p["maxfun"])


def reference_net(block: dict, seed: int, device):
    """The plain reference network at the block's widths with the seed's
    weights, in float32 on `device`."""
    from vosbench.reference.ritm import HRNetISModel

    with torch.device(device):
        net = HRNetISModel(**block["model"])
    net = net.to(device).eval()
    load_weights(net, click_weights(net, seed, device))
    return net


def _replay(net, record: dict, params, device):
    """For each click of a frame's record, in order: (the program's step,
    the clicks so far, the reference's f-BRS objective x -> (loss, logits,
    f_max_pos, f_max_neg), and x -> the reference's probabilities [H, W]),
    from what the program held before the click."""
    from vosbench.reference.ritm import Click, Interaction

    image = torch.from_numpy(np.transpose(record["image"].astype(np.float32) / 255.0,
                                          (2, 0, 1))).to(device)
    for o in record["objects"]:
        ref = Interaction(net, image, params)
        clicks: List[Click] = []
        for k, s in enumerate(o["steps"]):
            clicks.append(Click(*s["click"]))
            prev_probs = None if k == 0 else o["steps"][k - 1]["out"]
            prev = torch.from_numpy(o["prev"] if k == 0 else prev_probs).to(device)
            ci = ref.transform(clicks, prev, prev_probs)
            with torch.no_grad():
                fn = ref.objective(ci, ref.features(ci))

            def probs_at(x, ref=ref, ci=ci, fn=fn):
                with torch.no_grad():
                    return ref.probabilities(ci, fn(x)[1])
            yield s, len(clicks), fn, probs_at


def _x(v, n: int, device) -> torch.Tensor:
    """A scale-and-bias vector on `device` (zeros for None)."""
    return (torch.zeros(n, device=device) if v is None
            else torch.as_tensor(v).float().to(device))


def _stop_confirmed(fn, step: dict, x0: torch.Tensor, params) -> bool:
    """Whether the reference confirms the exit of the program's search
    (module docstring, brs_stops_unconfirmed), fn its objective."""
    exit_reason, last = step["exit"], step["last_step"]
    if exit_reason == "maxfun":
        return step["evals"] >= params.maxfun
    with torch.no_grad():
        if exit_reason == "clicks":
            _, _, fmp, fmn = fn(x0 if last is None else last[1].float())
            return (float(fmp) < 1 - params.prob_thresh + STOP_PROB_SLACK
                    and float(fmn) < params.prob_thresh + STOP_PROB_SLACK)
        if exit_reason == "iou" and last is not None:
            a, b = (fn(x.float())[1] > 0 for x in last)
            union = float((a | b).sum())
            return union > 0 and float((a & b).sum()) / union > (
                1 - STOP_IOU_SLACK * params.min_iou_diff)
    return False


def _frame_gaps(net, record: dict, params, device, control=None) -> tuple:
    """(the largest |p - p_ref| over a frame's clicks, [f(start), f(the
    program's point), the best of the reference's search, whether the
    reference confirms the search's exit (None for a control)] of each of
    its optimised clicks). control: per click, (the probabilities, the
    L-BFGS-B end point) that stand in the program's place."""
    prob_gap, brs_gaps = 0.0, []
    for j, (s, n, fn, probs_at) in enumerate(_replay(net, record, params, device)):
        x = _x(s["x"], 2 * params_channels(net), device)
        p_ref = probs_at(x)
        p_prog = (torch.from_numpy(np.ascontiguousarray(s["out"])).to(device)
                  if control is None else control[j][0])
        prob_gap = max(prob_gap, float((p_prog - p_ref).abs().max()))
        if n > 1:
            x0 = _x(s["x0"], x.numel(), device)
            best, _, _ = lbfgs_b(fn, x0.cpu().numpy(), params, device)
            end = x if control is None else torch.from_numpy(control[j][1]).to(device)
            stop = None if control is not None else _stop_confirmed(fn, s, x0, params)
            with torch.no_grad():
                brs_gaps.append([float(fn(x0)[0]), float(fn(end)[0]), best, stop])
    return prob_gap, brs_gaps


def _control_pass(net, record: dict, params, device) -> list:
    """The control in the program's place: per click, its probabilities at
    the program's final scale and bias, and its own L-BFGS-B end point from
    the program's start."""
    out = []
    for s, n, fn, probs_at in _replay(net, record, params, device):
        x = _x(s["x"], 2 * params_channels(net), device)
        end = None
        if n > 1:
            end = lbfgs_b(fn, _x(s["x0"], x.numel(), device).cpu().numpy(),
                          params, device)[1]
        out.append((probs_at(x), end))
    return out


def params_channels(net) -> int:
    """f-BRS's channels at insertion point A: HRNet's four widths."""
    return net.feature_extractor.aux_head[0].in_channels


def _medians(per_frame: List[tuple]) -> dict:
    """The three numbers from _frame_gaps' readings (module docstring)."""
    probs = [g for g, _ in per_frame]
    clicks = [c for _, cs in per_frame for c in cs]
    gain = sum(start - best for start, _, best, _ in clicks)
    missed = sum(end - best for _, end, best, _ in clicks)
    stops = [ok for *_, ok in clicks if ok is not None]
    return {"click_prob_gap": float(np.median(probs)) if probs else None,
            # no gain the search could make: nothing was missed
            "brs_loss_gap": missed / gain if gain > GAIN_FLOOR else 0.0,
            # none for a control, which stands in for the end points only
            "brs_stops_unconfirmed": (sum(not ok for ok in stops) / len(stops)
                                      if stops else None if clicks else 0.0)}


def _sampled(st, samples: List[dict]) -> List[dict]:
    return [st.records[s["i"]] for s in samples if s["i"] in st.records]


def numbers(samples, reference_out):
    """click_prob_gap, brs_loss_gap and brs_stops_unconfirmed over the
    sampled frames with clicks, the reference in float32 with TF32 off
    (module docstring)."""
    from vosbench.check import precision

    st = _LAST[0]
    st.controller = None        # the program's click model goes first
    net = reference_net(st.block, st.block["network_seed"], st.device)
    params = reference_params(st.block)
    with precision(net, "fp32"):
        st.brs_clicks = [_frame_gaps(net, r, params, st.device)
                         for r in _sampled(st, samples)]
    return _medians(st.brs_clicks)


def control_numbers(samples) -> dict:
    """click_prob_gap and brs_loss_gap with the reference at TF32
    (vosbench.check's control) in the program's place: its probabilities
    at the program's clicks and final scale and bias, and its own L-BFGS-B
    end point, evaluated by the reference at float32
    (vosbench/calibrate_click.py); brs_stops_unconfirmed has no control
    reading (None)."""
    from vosbench.check import precision

    st = _LAST[0]
    if torch.device(st.device).type != "cuda":
        # check.precision emulates TF32 on a CPU by rounding the inputs of
        # each convolution, which cuts the search's gradient
        raise ValueError("the click control needs a CUDA device")
    params = reference_params(st.block)
    ctl = reference_net(st.block, st.block["network_seed"], st.device)
    net = reference_net(st.block, st.block["network_seed"], st.device)
    gaps = []
    for r in _sampled(st, samples):
        with precision(ctl, "tf32"):
            control = _control_pass(ctl, r, params, st.device)
        with precision(net, "fp32"):
            gaps.append(_frame_gaps(net, r, params, st.device, control))
    st.control_brs_clicks = gaps
    return _medians(gaps)
