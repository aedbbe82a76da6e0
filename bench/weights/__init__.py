"""Random weights for a configuration, made on the device from the seed.

The names, shapes and dtypes of the leaves are the program's (what its
``param_shapes`` returns, bf16 for the leaves it serves as matrices); the
values are this generator's. The same tensors go to the engine and to the
reference. All bf16 values come from one ``normal_`` call over one flat
buffer (each leaf a view of it, then scaled), the fp32 leaves from a few
calls more: set-up stays short and nothing is drawn on the host.

Scales (a configuration's ``init`` section sets the numbers):

* a matrix (..., in, out): normal with std ``1 / sqrt(in)`` (unit gain,
  so every block moves the residual stream); ``q`` at ``q_gain`` times
  that, so attention is sharp and which keys are visible matters;
* ``embed``: std ``embed_std``; ``unembed`` (V, d): std ``1 / sqrt(d)``;
* ``conv_w`` (..., W, C): std ``1 / sqrt(W)``;
* norms and ``D``: ones; biases: zeros;
* ``dt_bias``: the inverse softplus of dt, log-uniform in [dt_min,
  dt_max]; ``A_log``: log of a uniform draw in [a_min, a_max] (Mamba2's
  published initialisation);
* ``init["std"]``: a fixed std for a leaf name, where the rules above do
  not fit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

_SEED_MASK = (1 << 63) - 1


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterable:
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (name,))
        else:
            yield prefix + (name,), tuple(v)


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _std(name: str, shape: Tuple[int, ...], init: Dict) -> float:
    if name in init.get("std", {}):
        return float(init["std"][name])
    if name == "embed":
        return float(init.get("embed_std", 1.0))
    if name == "unembed":
        return 1.0 / math.sqrt(shape[-1])
    if name == "conv_w":
        return 1.0 / math.sqrt(shape[-2])
    if len(shape) < 2:
        raise ValueError(f"no scale rule for leaf {name!r} {shape}")
    gain = float(init.get("q_gain", 1.0)) if name == "q" else 1.0
    return gain / math.sqrt(shape[-2])


def make(shapes: Dict, matrices: Iterable[str], init: Dict, seed: int,
         device) -> Dict:
    """Weights of ``shapes`` (a nested dict of leaf shapes) on ``device``
    from ``seed``: bf16 for the leaf names in ``matrices``, fp32
    otherwise."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & _SEED_MASK)
    matrices = frozenset(matrices)
    leaves = list(_leaves(shapes))
    out: Dict = {}

    drawn: List = [(p, s) for p, s in leaves
                   if p[-1] in matrices or p[-1] == "conv_w"]
    for dtype in (torch.bfloat16, torch.float32):
        group = [(p, s) for p, s in drawn
                 if (p[-1] in matrices) == (dtype == torch.bfloat16)]
        if not group:
            continue
        flat = torch.empty(sum(math.prod(s) for _, s in group), dtype=dtype,
                           device=device)
        flat.normal_(generator=gen)
        off = 0
        for path, shape in group:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            leaf.mul_(_std(path[-1], shape, init))
            _set(out, path, leaf)
            off += n

    for path, shape in leaves:
        name = path[-1]
        if name in matrices or name == "conv_w":
            continue
        if name.endswith("norm") or name == "D":
            leaf = torch.ones(shape, dtype=torch.float32, device=device)
        elif name.endswith("bias") and name != "dt_bias":
            leaf = torch.zeros(shape, dtype=torch.float32, device=device)
        elif name == "dt_bias":
            u = torch.rand(shape, generator=gen, device=device)
            lo, hi = math.log(init["dt_min"]), math.log(init["dt_max"])
            dt = torch.exp(lo + u * (hi - lo))
            leaf = dt + torch.log(-torch.expm1(-dt))
        elif name == "A_log":
            u = torch.rand(shape, generator=gen, device=device)
            leaf = torch.log(init["a_min"] + u * (init["a_max"] -
                                                  init["a_min"]))
        elif name in init.get("std", {}):
            leaf = torch.randn(shape, generator=gen, device=device) * \
                float(init["std"][name])
        else:
            raise ValueError(f"no rule for fp32 leaf {'/'.join(path)}")
        _set(out, path, leaf)
    return out
