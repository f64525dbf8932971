"""The benchmark's weights: drawn from ``--seed`` on the device, in the
program's parameter layout, in one call per dtype.

The layout (each leaf's path, shape and dtype) is the program's; the
values are the benchmark's own: every leaf is a view of one flat buffer
of its dtype, filled by one ``randn`` from a generator seeded with the
run's seed, then scaled. Norm gains are ones; the embedding has unit
variance (the first norm sees unit-scale rows); every other matrix
``[..., fan_in, fan_out]`` has standard deviation 1 / sqrt(fan_in), the
unembedding [vocab, hidden] 1 / sqrt(hidden), so the logits have unit
scale. A configuration's ``weight_scale`` (leaf name -> factor) scales a
leaf's standard deviation further. The same seed gives the same
weights, so the reference redraws them after the program has run
instead of keeping a copy.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]
CHUNK = 1 << 30          # elements drawn per call


def std_of(path: str, shape: Tuple[int, ...],
           scale: Optional[Dict[str, float]] = None) -> float:
    """The standard deviation of a leaf's draw; 0 marks a norm gain (ones)."""
    name = path.rsplit("/", 1)[-1]
    if name.startswith("ln") or name.endswith("norm"):
        return 0.0
    if name == "embed":
        std = 1.0
    elif name == "unembed":
        std = 1.0 / math.sqrt(shape[-1])
    else:
        std = 1.0 / math.sqrt(shape[-2])
    return std * (scale or {}).get(name, 1.0)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one stream of a run's draws (0: the weights; the
    mixes number their own)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) % (1 << 63))


def draw(layout: Iterable[Leaf], seed: int, device,
         scale: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """path -> tensor, every leaf a view of its dtype's one buffer
    (``scale``: a configuration's ``weight_scale``)."""
    layout = list(layout)
    gen = generator(seed, device)
    out = {}
    for dtype in sorted({dt for _, _, dt in layout}, key=str):
        mine = [(p, s) for p, s, dt in layout if dt == dtype]
        total = sum(math.prod(s) for _, s in mine)
        flat = torch.empty(total, dtype=dtype, device=device)
        for c in range(0, total, CHUNK):
            flat[c:c + CHUNK].normal_(generator=gen)
        at = 0
        for path, shape in mine:
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            std = std_of(path, shape, scale)
            if std:
                leaf.mul_(std)
            else:
                leaf.fill_(1.0)
            out[path] = leaf
            at += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """"a/b/c" -> tensor into nested dicts."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree
