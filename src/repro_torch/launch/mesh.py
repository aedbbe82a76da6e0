"""Meshes: the ``(data, model)`` process groups of a training run, a
helper that runs a function on every rank of one, and what one card takes
of the reference's production mesh.

Training across cards. ``make_dist`` turns an initialised
``torch.distributed`` world into this rank's ``models.tp.Dist`` on a
``(data, model)`` mesh, with one process group per axis; ``run_mesh``
starts one process per rank (rank ``r`` on ``cuda:r``, or on the CPU when
asked) and returns their results. NCCL is the backend on the cards,
``gloo`` in the CPU tests.

The fit planner. The reference runs every (arch x shape) cell on a
16 x 16 TPU mesh of axes ("data", "model") (``repro/launch/mesh.py``), or
with ``multi_pod`` on a 2 x 16 x 16 one of axes ("pod", "data", "model").
``card_share`` gives what ONE card of a port run takes of a cell: one data
shard of the production mesh, with the 16 tensor-parallel shards folded
onto it (tp = 1, or the run's own tp on a mesh of cards). So it holds
``global_batch / 16`` of the cell's sequences, each at its full length.

A decode cell with ``global_batch < 32`` is sequence-parallel in the
reference (``sp``): its few sequences are split over the 16 data shards.
One card has no shard to split with, so ``sp`` cells follow a rule of their
own: the card holds every sequence of the cell, whole. On a mesh of cards
(``card_share(shape, dp)``) an ``sp`` cell's sequences split over the mesh's
``dp`` data ranks, as the reference splits them over its data shards.

Serving across cards. ``make_dist(..., sp=, repl=)`` adds what a serve
step needs: the ``sp`` flag and one process group per K/V replica set of
the model axis (``models.attention.replica_groups``; ``repl`` ranks each,
the model's ``replica_info(...)["repl"]``).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
import warnings
from typing import Any, Callable, List, Sequence, Tuple

PRODUCTION_MESH = {"data": 16, "model": 16}


@dataclasses.dataclass(frozen=True)
class CardShare:
    rows: int          # sequences on the card
    tokens: int        # tokens of each sequence on the card
    sp: bool           # the reference runs the cell sequence-parallel
    cards: int         # cards that split the cell's global work (1 for sp)


def is_sp(shape) -> bool:
    """The reference's sequence-parallel rule (``launch/dryrun.py``)."""
    return shape.kind == "decode" and shape.global_batch < 32


def card_share(shape, dp: int = 1, pods: int = 1) -> CardShare:
    """One card's share of ``shape``; with ``dp`` data ranks of a mesh of
    cards, an ``sp`` cell's sequences split over them (each rank holds
    ceil(seq_len / dp) tokens of every sequence). ``pods`` 2: the
    reference's multi-pod mesh, 2 x 16 x 16 ("pod", "data", "model"),
    whose batch rows split over pod x data (``--multi-pod``); an ``sp``
    cell splits its sequences over "data" alone there too."""
    if is_sp(shape):
        return CardShare(shape.global_batch, -(-shape.seq_len // dp), True,
                         1)
    dp = PRODUCTION_MESH["data"] * pods
    if shape.global_batch % dp:
        raise ValueError(f"{shape.name}: global batch {shape.global_batch} "
                         f"does not split over {dp} data shards")
    return CardShare(shape.global_batch // dp, shape.seq_len, False, dp)


# ------------------------------------------------------------ training mesh
def mesh_label(shape) -> str:
    return " x ".join(str(n) for n in shape)


def make_dist(shape, *, fsdp: bool = False, backend: str = None,
              timeout: float = 60.0, sp: bool = False, repl: int = 1):
    """This rank's ``Dist`` on a ``(data, model)`` mesh of ``shape``, or a
    ``(pod, data, model)`` one of a 3-tuple, over the initialised default
    process group (global rank ``r`` sits at ``divmod(r, model)``, or
    ``((pod * data) + data_rank) * model + model_rank``: the reference's
    device order). Every rank creates every group, in the same order, on
    ``backend`` (the world's by default), with ``timeout`` seconds for
    each of its collectives. ``sp`` and ``repl`` (serving):
    sequence-parallel decode, and the model's K/V replicas, whose sets of
    ``repl`` model ranks (``replica_groups``) each get a group. A 2-tuple
    creates the groups it always did, in the same order."""
    import torch.distributed as td

    from ..models.tp import Dist
    pod, dp, tp = (1,) * (3 - len(shape)) + tuple(shape)
    world, rank = td.get_world_size(), td.get_rank()
    if pod * dp * tp != world:
        raise ValueError(f"a {mesh_label(shape)} mesh needs "
                         f"{pod * dp * tp} ranks, the world has {world}")
    wait = datetime.timedelta(seconds=timeout)
    row_rank, model_rank = divmod(rank, tp)
    pod_rank, data_rank = divmod(row_rank, dp)

    def group(ranks):
        return td.new_group(ranks, timeout=wait, backend=backend)

    def at(p, d, m):
        return (p * dp + d) * tp + m

    dp_groups = [[group([at(p, d, m) for d in range(dp)]) for m in range(tp)]
                 for p in range(pod)]
    tp_groups = [[group([at(p, d, m) for m in range(tp)]) for d in range(dp)]
                 for p in range(pod)]
    if tp % repl:
        raise ValueError(f"{repl} K/V replicas do not split {tp} model ranks")
    kv_group = None
    if repl > 1:
        from ..models.attention import replica_groups
        sets = replica_groups(tp // repl, repl)
        kv_groups = [[[group([at(p, d, m) for m in ms]) for ms in sets]
                      for d in range(dp)] for p in range(pod)]
        kv_group = kv_groups[pod_rank][data_rank][model_rank // repl]
    pod_group = rows_group = None
    if pod > 1:
        pod_groups = [[group([at(p, d, m) for p in range(pod)])
                       for m in range(tp)] for d in range(dp)]
        rows_groups = [group([at(p, d, m) for p in range(pod)
                              for d in range(dp)]) for m in range(tp)]
        pod_group = pod_groups[data_rank][model_rank]
        rows_group = rows_groups[model_rank]
    return Dist(dp=dp, tp=tp, data_rank=data_rank, model_rank=model_rank,
                fsdp=fsdp, dp_group=dp_groups[pod_rank][model_rank],
                tp_group=tp_groups[pod_rank][data_rank],
                group=td.group.WORLD, sp=sp, repl=repl, kv_group=kv_group,
                pod=pod, pod_rank=pod_rank, pod_group=pod_group,
                rows_group=rows_group)


def _rank_main(fn, shape, rank, store, backend, device, fsdp, timeout,
               args, results, dist_kw):
    """One rank of ``run_mesh``: join the world, build the Dist, run
    ``fn`` and report its result or its traceback."""
    import torch
    import torch.distributed as td
    try:
        torch.set_num_threads(1)
        warnings.filterwarnings("ignore", category=FutureWarning,
                                module="torch.distributed")
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank)
            dev = torch.device("cuda", rank)
        td.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=math.prod(shape),
            timeout=datetime.timedelta(seconds=timeout))
        try:
            dist = make_dist(shape, fsdp=fsdp, timeout=timeout, **dist_kw)
            results.put((rank, True, fn(dist, dev, *args)))
        finally:
            td.destroy_process_group()
    except BaseException:       # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_mesh(fn: Callable, shape: Tuple[int, ...], *, args: Sequence = (),
             fsdp: bool = False, backend: str = "nccl", device: str = "cuda",
             timeout: float = 60.0, deadline: float = 600.0,
             sp: bool = False, repl: int = 1) -> List[Any]:
    """Run ``fn(dist, device, *args)`` on every rank of a ``shape``
    ``(data, model)`` or ``(pod, data, model)`` mesh (``make_dist``), one
    spawned process per rank, and return the
    results in rank order. ``fn`` and ``args`` are pickled (``fn`` by its
    import path) and the results must be picklable: return numpy arrays,
    not tensors. ``device`` "cuda" puts rank ``r`` on ``cuda:r``; "cpu"
    runs every rank on the CPU (with ``backend="gloo"``). ``sp`` and
    ``repl`` go to ``make_dist`` (serving meshes).

    The ranks meet through a file store in a fresh temporary directory
    (no port to collide with another run); every collective of theirs
    times out after ``timeout`` seconds. When a rank raises or dies, or
    when ``deadline`` seconds pass, the other ranks are killed and the
    call raises with the rank's traceback."""
    import torch
    n = math.prod(shape)
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a {mesh_label(shape)} mesh needs {n} cards, "
                           f"{torch.cuda.device_count()} are visible")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mesh_")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, shape, r, os.path.join(tmp, "store"), backend, device, fsdp,
        timeout, tuple(args), results, dict(sp=sp, repl=repl)))
        for r in range(n)]
    out: List[Any] = [None] * n
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        done = 0
        while done < n:
            try:
                rank, ok, val = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"mesh rank {dead[0]} died with exit "
                                       f"code {procs[dead[0]].exitcode}")
                if time.monotonic() > end:
                    raise TimeoutError(f"a {mesh_label(shape)} mesh run "
                                       f"passed its {deadline} s deadline")
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} failed:\n{val}")
            out[rank] = val
            done += 1
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out
