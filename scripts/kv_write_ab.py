"""Time the K/V write path's variants against each other in one process, on
one card: the unit-offset ``index_copy_`` the port uses
(``attention.write_kv_rows``), the row ``index_copy_`` it replaced (which
needs a page stride that is a multiple of a (KVL*D)-unit slot) and a
two-index ``index_put_`` on the strided layer view.

    python3 scripts/kv_write_ab.py [--rounds 10] [--engine-pairs 10]

Part 1 writes one step's K/V (granite-3-2b's 40 layers, its pages of
655,360 units in a 2 GiB pool) at 512 and at 8 tokens, and prints for each
variant and round the host time to issue the step's writes, its wall time
(issue and a sync) and its device time (CUDA events), in turns. Every
variant must leave the buffer byte for byte as the port's does. Part 2
drains full-width granite-3-2b (``chip_smoke``'s phase 3 prompts, 32 new
tokens, packed and padded at depth 1) with the write path swapped between
the port's and the row version, in alternating pairs, and prints each
drain's mean step ms; outputs must be equal. Compare variants only within
one call: host-bound serving moves by tens of percent between calls.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def row_kv_rows(view_shape, eids, slots):
    """The row version's ``kv_rows``: rows of KVL*D units."""
    import torch
    from repro_torch.models import attention as A
    vp, nl, _, tpp, kvl, d = view_shape
    eid = torch.where(eids < 0, vp - 1, eids).reshape(-1).long()
    return A.view_offset(view_shape, eid, 0, 0,
                         slots.reshape(-1).long()) // (kvl * d)


def row_write(buf, view_shape, layer, rows, k_new, v_new):
    """The row version's ``write_kv_rows``: the flat buffer as (N, KVL*D)
    rows (the page stride must be a multiple of a slot)."""
    vp, nl, _, tpp, kvl, d = view_shape
    flat = buf.view(-1, kvl * d)
    for sel, data in ((0, k_new), (1, v_new)):
        data = data.reshape(-1, kvl * d)
        if data.dtype != buf.dtype:
            data = data.to(buf.dtype)
        flat.index_copy_(0, rows + (layer * 2 + sel) * tpp, data)
    return buf


def put_kv_rows(view_shape, eids, slots):
    """The ``index_put_`` version's ``kv_rows``: (page, slot) vectors."""
    import torch
    vp = view_shape[0]
    page = torch.where(eids < 0, vp - 1, eids).reshape(-1).long()
    return page, slots.reshape(-1).long()


def put_write(buf, view_shape, layer, rows, k_new, v_new):
    """The ``index_put_`` version: whole (KVL, D) slots at (page, slot) of
    the strided layer view."""
    from repro_torch.core.layout import page_view
    *_, kvl, d = view_shape
    lview = page_view(buf, view_shape)[:, layer]
    for sel, data in ((0, k_new), (1, v_new)):
        data = data.reshape(-1, kvl, d)
        if data.dtype != buf.dtype:
            data = data.to(buf.dtype)
        lview[:, sel].index_put_(rows, data)
    return buf


def variants():
    from repro_torch.models import attention as A
    return {"unit_copy": (A.kv_rows, A.write_kv_rows),
            "row_copy": (row_kv_rows, row_write),
            "put": (put_kv_rows, put_write)}


def part1(rounds: int, steps: int = 50) -> None:
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.core.layout import PageView
    from repro_torch.core.spec import BYTES_PER_UNIT
    cfg = ARCHS["granite-3-2b"]
    nl, tpp, kvl, d = cfg.num_layers, cfg.tokens_per_page, \
        cfg.num_kv_heads, cfg.head_dim
    page = nl * 2 * tpp * kvl * d
    vp = (2 << 30) // BYTES_PER_UNIT // page + 1
    shape = PageView((vp, nl, 2, tpp, kvl, d), page)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    bufs = {}
    for n in (512, 8):
        # distinct (page, slot) places, every 7th write dropped (to the
        # scratch page, which the comparison leaves out)
        ids = torch.randperm((vp - 1) * tpp, device=dev, generator=gen)[:n]
        eids, slots = ids // tpp, ids % tpp
        eids[::7] = -1
        kv = [(torch.randn(n, kvl, d, device=dev, generator=gen),
               torch.randn(n, kvl, d, device=dev, generator=gen))
              for _ in range(nl)]
        for name, (rows_fn, write_fn) in variants().items():
            buf = torch.zeros(vp * page, dtype=torch.bfloat16, device=dev)
            rows = rows_fn(shape, eids, slots)
            for layer in range(nl):
                write_fn(buf, shape, layer, rows, *kv[layer])
            bufs[name] = buf[:(vp - 1) * page]
        for name in bufs:
            if not torch.equal(bufs[name].view(torch.int16),
                               bufs["unit_copy"].view(torch.int16)):
                raise AssertionError(f"{name} writes other bytes")
        bufs.clear()
        buf = torch.zeros(vp * page, dtype=torch.bfloat16, device=dev)
        order = list(variants().items())
        for r in range(rounds):
            for name, (rows_fn, write_fn) in (order if r % 2 == 0
                                              else order[::-1]):
                torch.cuda.synchronize()
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                host = 0.0
                t0 = time.perf_counter()
                e0.record()
                for _ in range(steps):
                    h0 = time.perf_counter()
                    rows = rows_fn(shape, eids, slots)
                    for layer in range(nl):
                        write_fn(buf, shape, layer, rows, *kv[layer])
                    host += time.perf_counter() - h0
                e1.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                print(f"[write] tokens={n} round={r} variant={name}: a "
                      f"step's {nl} layers issue_ms={host / steps * 1e3:.4f} "
                      f"wall_ms={wall / steps * 1e3:.4f} device_ms="
                      f"{e0.elapsed_time(e1) / steps:.4f}", flush=True)


def part2(pairs: int) -> None:
    import gc

    import torch
    import chip_smoke as cs
    from repro_torch.configs import ARCHS
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    cfg = ARCHS["granite-3-2b"]
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    base = dict(kv_pool_bytes=2 << 30, max_num_batched_tokens=512,
                chunk_size=256, max_running=8, async_scheduling=False)
    prompts = cs._prompts(8, cfg.vocab_size)
    cs._warm(model, params, base, prompts)
    table = variants()
    outs = {}
    for p in range(pairs):
        names = ("unit_copy", "row_copy") if p % 2 == 0 else \
            ("row_copy", "unit_copy")
        for name in names:
            A.kv_rows, A.write_kv_rows = table[name]
            for mode in ("packed", "padded"):
                eng, wall, _ = cs._drain(model, params,
                                         dict(base, batching_mode=mode),
                                         prompts, 32, "cuda")
                got = {r.rid: list(r.output) for r in eng.finished}
                if outs.setdefault(mode, got) != got:
                    raise AssertionError(f"{mode} {name}: outputs differ")
                print(f"[engine] pair={p} variant={name} mode={mode} "
                      f"steps={eng.step_count} mean_step_ms="
                      f"{wall / eng.step_count * 1e3:.2f}", flush=True)
                del eng
                gc.collect()
    A.kv_rows, A.write_kv_rows = table["unit_copy"]
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--engine-pairs", type=int, default=10)
    args = ap.parse_args(argv)
    import chip_smoke as cs
    cs.phase_env()
    part1(args.rounds)
    if args.engine_pairs:
        part2(args.engine_pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
