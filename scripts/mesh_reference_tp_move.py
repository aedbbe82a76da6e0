#!/usr/bin/env python3
"""How far the JAX reference's own training numerics move with its tensor-
parallel size, on one function: reduced granite-3-2b's ``model.init(0)``
drawn at tp 2 and at tp 4, merged into the one-device layout (granite's
reduced heads split over 2 or 4 without padding; at tp 4 the two K/V
replicas are equal copies), and ``jax.value_and_grad(model.train_loss)``
of the same batch at tp and at 1 x 1. Prints the loss difference and each
leaf's relative L2 gradient difference (the tp run's replicated K/V
gradients summed over their replicas).

These are the reference's own differences between two programs of one
function: ``tests/test_torch_mesh_train.py`` holds the port at tp > 1 to
bars as wide as them (``TOLS``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mesh_reference_tp_move.py
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.models.tp import Dist, make_mesh_auto  # noqa: E402


def model(tp):
    mesh = make_mesh_auto((1, tp), ("data", "model"),
                          devices=jax.devices()[:tp])
    return build_model(reduced(ARCHS["granite-3-2b"]), Dist(mesh=mesh))


def merge(tree, tp, repl, summed=False):
    """The expanded tp layout -> the one-device layout (K/V: replica 0,
    or the sum over replicas with ``summed``)."""
    def cat(a, axis, idx):
        return np.concatenate([a[:, i] for i in idx], axis)[:, None]

    out = {"layers": {}}
    for k, v in tree.items():
        if k == "layers":
            for n, a in v.items():
                a = np.asarray(a)
                if n in ("q", "gate", "up"):
                    out[k][n] = cat(a, -1, range(tp))
                elif n in ("o", "down"):
                    out[k][n] = cat(a, -2, range(tp))
                elif n in ("k", "v"):
                    out[k][n] = sum(cat(a, -1, range(r, tp, repl))
                                    for r in range(repl if summed else 1))
                else:
                    out[k][n] = a
        elif k == "embed":
            out[k] = np.asarray(v).reshape(1, -1, v.shape[-1])
        else:
            out[k] = np.asarray(v)
    return out


def main():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 256, (4, 32)).astype(np.int32)
    tgt = rng.integers(0, 256, (4, 32)).astype(np.int32)
    one = model(1)
    for tp, repl in ((2, 1), (4, 2)):
        m = model(tp)
        params = m.init(0)
        loss, grads = jax.jit(jax.value_and_grad(m.train_loss))(
            params, tok, tgt)
        loss1, grads1 = jax.jit(jax.value_and_grad(one.train_loss))(
            merge(params, tp, repl), tok, tgt)
        g = merge(jax.tree.map(np.asarray, grads), tp, repl, summed=True)
        rel = {}
        for name in ("embed", "final_norm"):
            rel[name] = g[name], np.asarray(grads1[name])
        for name in grads1["layers"]:
            rel[f"layers.{name}"] = (g["layers"][name],
                                     np.asarray(grads1["layers"][name]))
        rel = {k: float(np.linalg.norm(a - b) / np.linalg.norm(b))
               for k, (a, b) in rel.items()}
        print(f"tp {tp} against 1 x 1: loss {float(loss) - float(loss1):+.3e}"
              f"; largest gradient difference {max(rel.values()):.3e} "
              f"({max(rel, key=rel.get)})")
        for k in sorted(rel):
            print(f"  {k}: {rel[k]:.3e}")


if __name__ == "__main__":
    main()
