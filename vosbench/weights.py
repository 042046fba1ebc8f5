"""Random CUTIE weights made on the device from the seed.

One torch.rand call on a seeded generator of the target device fills a flat
buffer for every floating tensor of the state dict; a per-tensor scale and
offset, spread over the buffer by repeat_interleave, give each tensor its
distribution:

  - conv, linear and projection weights: U(-GAIN/sqrt(fan_in),
    GAIN/sqrt(fan_in)). PyTorch's default, GAIN 1, shrinks each layer's
    output and leaves every pixel's probabilities within a few thousandths
    of a tie; LeCun's, GAIN sqrt(3), makes the network chaotic: TF32's
    rounding moves a frame's probabilities by 0.02-0.2 where a float32-sized
    change of the weights moves them by 1e-6. At GAIN 1.5 both scale
    smoothly (about 1e-7 and 2e-4, cutie-base at 128x224 on a CPU) and the
    median top-two margin of a pixel's probabilities is about 0.03;
  - biases: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) of their layer;
  - norm weights and running variances: 1 + U(-0.1, 0.1) and 1 + U(0, 0.1);
  - running means: U(-0.1, 0.1); learned embeddings: U(-1, 1).

The program's model and the reference's frozen copy take the same names, so
one dict loads into either. A frame's work depends on the shapes and the
memory schedule, not on these values.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from vosbench.video import SEED_MASK

# the weights' bound in units of 1/sqrt(fan_in) (see the module docstring)
GAIN = 1.5


def _affine(name: str, shape: Tuple[int, ...],
            shapes: Mapping[str, Tuple[int, ...]]) -> Tuple[float, float]:
    """(scale, offset) mapping U[0, 1) to the tensor's distribution."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 0.1, 1.0
    if leaf == "running_mean":
        return 0.2, -0.1
    if name.endswith(("query_init.weight", "query_emb.weight")):
        return 2.0, -1.0
    if leaf.endswith("weight") and len(shape) >= 2:
        bound = GAIN / math.sqrt(math.prod(shape[1:]))
        return 2 * bound, -bound
    if leaf == "weight":            # a norm's scale
        return 0.2, 0.9
    if leaf.endswith("bias"):
        prefix = name[:-len("bias")]
        w = shapes.get(prefix + "weight")
        if w is not None and len(w) >= 2:
            bound = 1.0 / math.sqrt(math.prod(w[1:]))
            return 2 * bound, -bound
        return 0.2, -0.1            # a norm's shift
    raise ValueError(f"no initialisation rule for {name} {shape}")


def make_weights(model: torch.nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every floating tensor of model.state_dict(),
    views into one buffer on `device`, drawn from `seed`."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if v.is_floating_point()}
    names = sorted(shapes)          # one layout whatever the module order
    sizes = [math.prod(shapes[k]) for k in names]
    aff = torch.tensor([_affine(k, shapes[k], shapes) for k in names],
                       dtype=torch.float32)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    aff = aff.to(device)
    flat = (flat * aff[:, 0].repeat_interleave(counts, output_size=flat.numel())
            + aff[:, 1].repeat_interleave(counts, output_size=flat.numel()))
    return {k: t.view(shapes[k])
            for k, t in zip(names, torch.split(flat, sizes))}


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Mapping[str, torch.Tensor]
                 ) -> None:
    """Copy weights into every floating tensor of the model's state dict;
    raises if a name is missing on either side."""
    own = {k: v for k, v in model.state_dict().items() if v.is_floating_point()}
    if set(own) != set(weights):
        raise KeyError(f"weights and model differ: "
                       f"{sorted(set(own) ^ set(weights))[:5]}")
    for k, v in own.items():
        v.copy_(weights[k])
