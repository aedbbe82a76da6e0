"""The one-card fit planner (the port's ``repro/launch/dryrun.py``).

The reference compiles each (arch x shape) cell for a 16 x 16 TPU mesh and
reads XLA's memory and cost analyses. Torch has no such analysis, so the
port predicts one card's peak bytes from the model's own parameter shapes
and the card's share of the cell (``mesh.card_share``), term by term:

* **weights**: every leaf of ``model.param_shapes()`` at the dtype its
  ``init`` gives it (serving: bf16 matrices, fp32 norms, biases and
  vectors; training: fp32 masters, their gradients and two AdamW moments,
  16 bytes a parameter);
* **pool**: the unified buffer, ``input_specs.buffer_units_for`` of the
  card's rows and tokens plus the scratch page (serving only);
* **activations**, as the port computes them:
  - serving: the fp32 copy of the vocabulary table the head multiplies
    with (``models.tp.logits_local``), one layer's transient working set
    at the step's tokens (``_layer_bytes``), the K/V of the step's
    context gathered for one cycle of layers, the logits rows, and for
    enc-dec the encoder's layer and the padded cross attention's scores;
  - training, the larger of two moments of a micro-batch's backward:
    (a) at the head: the checkpointed input of every cycle, three
    (tokens, vocab) fp32 logits-sized tensors and the table's fp32 copy
    and gradient; (b) at the last layer's backward: every per-layer
    gradient of the stacked leaves (held by their ``unbind`` until the
    first layer's gradient exists), plus the larger of one stacked leaf's
    gradient being stacked and one cycle's recomputation (its bf16 weight
    copies and working set). Activations are recomputed a cycle of the
    layer pattern at a time (``torch.utils.checkpoint``; ``period``) and
    the batch is split into micro-batches
    (``input_specs.default_micro_batches``, at most one row each).

On a ``(data, model)`` mesh of cards (``--mesh DxM``, training cells of
every family), or a ``(pod, data, model)`` one (``--mesh PxDxM``: FSDP
and experts over "data" alone, ZeRO-1 moments over "pod" too), each data
rank takes one data shard of the production mesh, as one card does, and
the terms are one rank's: its fp32 params (every tensor-parallel leaf / tp; a MoE's experts
/ dp and their ffe / tp; under ``--fsdp`` the decoder's stacked layer
leaves / dp too), their fp32 gradients and the two fp32 moments (ZeRO-1
slices / dp; the experts, split over the data axis already, stay whole),
exactly the tensors the rank holds (``mesh_train_bytes``); the
activations take the rank's heads (Mamba2 heads too), ``d_ff`` or expert
ffe columns and vocabulary rows, a MoE layer's expert-parallel exchange
buffers, and under FSDP the recomputed cycle holds its layers' bf16
weights gathered whole. ``--cards N`` lists, for every training cell of
those families, the meshes of N cards whose per-card peak fits.

Serving cells take the same meshes (``--mesh DxM`` with a prefill or
decode shape): one rank's bf16 weights (its heads, ``d_ff`` columns,
vocabulary rows and experts), its pool (``input_specs.serve_cell`` of the
rank's model: its rows, under ``sp`` 1 / dp of every sequence, and 1 /
repl of a K/V group's attention pages) and the activations of its step at
its heads; ``--cards N`` lists the serving meshes beside the training
ones.

``--multi-pod`` plans one card's share of the reference's 2 x 16 x 16
cells (``launch.mesh.card_share(..., pods=2)``): ``global_batch / 32``
rows of a non-``sp`` cell.

A cell fits when its peak is at most ``CARD_BYTES - RESERVE`` (a rank of a
mesh of cards: less ``MESH_RESERVE`` too, ``fit_bytes``). Its largest
fitting depth is the deepest cut, in whole cycles of the model's layer
pattern, that fits. Each record also carries the cell's analytic roofline
terms (``roofline.analytic_terms`` on the H100's constants). ``--measure``
runs a cell on the card at the smaller of
its full and its largest fitting depth: a prefill cell as one packed
dispatch of the card's tokens (the varlen kernel), a decode cell as one
padded T == 1 dispatch (the paged kernel), a train cell as one ``Trainer``
step, with ``torch.cuda.max_memory_allocated`` and the CUDA-event time
beside the prediction.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh 2x2 --fsdp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cards 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b \\
      --shape train_4k --mesh 2x2x1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape decode_32k --measure          # on the card
  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Dict, Iterator, Tuple

from ..configs import ARCHS, SHAPES_BY_NAME, shapes_for
from ..core.spec import BYTES_PER_UNIT, lcm, make_geometry
from ..models.params import MATRICES
from .input_specs import (default_micro_batches, serve_cell, train_cell)
from .mesh import card_share
from .roofline import HBM_BW, PEAK_FLOPS, analytic_terms

# The card: one NVIDIA H100 80GB HBM3 reports 79.18 GiB to torch
# (``torch.cuda.mem_get_info``); the reserve covers the CUDA context,
# cuBLAS workspaces and the caching allocator's rounding.
CARD_BYTES = int(79.18 * 2 ** 30)
RESERVE = 2 << 30
FIT_BYTES = CARD_BYTES - RESERVE
# A rank of a mesh of cards holds more outside its tensors: NCCL's
# communicator buffers and more of the allocator's fragmentation. A 4 x 1
# qwen3-moe rank that failed to allocate 3.75 GiB at 72.60 GiB allocated
# had 1.80 GiB held free by the allocator and 2.77 GiB more in use outside
# it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 5c).
MESH_RESERVE = 3 << 30
RWKV_CHUNK = 64     # models.blocks_seq.RWKV_CHUNK


# --------------------------------------------------------------- weights
def _leaves(tree, stacked=False) -> Iterator[Tuple[str, tuple, bool]]:
    """(name, shape, stacked) of every leaf; a leaf under a subtree other
    than ``shared_attn`` is a per-layer stack (``models.lm.unstack``)."""
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, name != "shared_attn")
        else:
            yield name, tuple(v), stacked


def weight_bytes(model, master: bool = False) -> int:
    """The bytes of ``model.init(..., master=master)``."""
    return sum(math.prod(s) * (4 if master or n not in MATRICES else 2)
               for n, s, _ in _leaves(model.param_shapes()))


def mesh_train_bytes(model, zero1: bool = True) -> Dict[str, int]:
    """One rank's training state in bytes: its fp32 params (its slices of
    the expanded layout, ``model.param_shapes()``), their fp32 gradients,
    and the two fp32 AdamW moments (its ZeRO-1 slices when ``zero1``):
    the sizes of the tensors ``Trainer.init_state`` gives it."""
    from ..training.optimizer import zero1_shards
    local = [math.prod(s) for _, s, _ in _leaves(model.param_shapes())]
    dist = model.dist
    shards = model.shards()
    state = zero1_shards(shards, model.global_shapes(), dist.dp, dist.pod) \
        if zero1 else shards
    moments = 0
    for n, ps, ss in zip(local, _flat(shards), _flat(state)):
        n //= dist.dp if ss.data_dim != ps.data_dim else 1
        n //= dist.pod if ss.pod_dim is not None else 1
        moments += 8 * n
    return dict(params=4 * sum(local), grads=4 * sum(local), moments=moments)


def _flat(tree):
    """Leaves of a nested dict in ``_leaves``'s order."""
    for v in tree.values():
        yield from _flat(v) if isinstance(v, dict) else (v,)


def _gathered_layer_params(model) -> int:
    """Parameters of one layer as its products use them: this rank's
    tensor-parallel slices, FSDP shards gathered whole."""
    dist = model.dist
    shapes = model.param_shapes()
    if not model.fsdp:
        return sum(math.prod(s[1:]) for _, s, st in _leaves(shapes)
                   if st) // max(1, model.cfg.num_layers)
    shards = model.shards()["layers"]
    return sum(math.prod(s[1:]) * (dist.dp if shards[n].fsdp_dim is not
                                   None else 1)
               for n, s in shapes["layers"].items())


def param_counts(model) -> Dict[str, int]:
    """Parameters in all, in per-layer stacks, and in the largest stack."""
    shapes = list(_leaves(model.param_shapes()))
    stacks = [math.prod(s) for _, s, st in shapes if st]
    return dict(total=sum(math.prod(s) for _, s, _ in shapes),
                stacked=sum(stacks), largest_stack=max(stacks, default=0))


def pool_bytes(model, kv_pool_bytes: int, geometry_mode: str = "lcm",
               specs=None) -> int:
    """The unified buffer an ``Engine`` of ``geometry_mode`` allocates for
    ``kv_pool_bytes``: the geometry's whole large pages plus the scratch
    page, one large page (``specs``: the pool's types, by default the
    model's; a spec-decoding pool holds the target's and the draft's)."""
    geo = make_geometry(specs or model.kv_specs(),
                        total_memory_bytes=kv_pool_bytes, mode=geometry_mode)
    return (geo.num_large_pages + 1) * geo.large_page_units * BYTES_PER_UNIT


# ----------------------------------------------------------- activations
def _layer_bytes(model, n: int, train: bool = False) -> int:
    """One layer's transient working set over ``n`` tokens (the largest
    of its norm, attention and MLP or mixer phases, beside the residual
    stream), as the port's blocks compute it: activations bf16, norms and
    the MLP's SiLU product in fp32 (``blocks_attn.mlp_block``). Training:
    one checkpointed cycle of layers (``period``) recomputed in the
    backward, each with its bf16 weight copies (``common.dense`` rounds
    the fp32 masters in every call) and twice its working set (the saved
    activations and their gradients). The hybrid's cycle is
    ``attn_every`` Mamba2 layers and one pass of the shared attention and
    MLP block."""
    cfg = model.cfg
    d = cfg.d_model
    ri = model.ri                        # a mesh rank's heads
    dp, tp = model.dist.dp, model.dist.tp
    qd = ri.get("q_local", cfg.num_heads) * cfg.head_dim
    kvd = ri["kv_local"] * cfg.head_dim
    norm = 12 * n * d
    attn = 4 * n * (qd + kvd)
    layer = _gathered_layer_params(model)
    if cfg.family == "ssm":
        # RWKV6: r, k, v, g, w fp32 and the wkv output; the chunk's decay
        # tensors (B, 64, 64, H, hs) fp32: three of one chunk serving,
        # two of every chunk kept for the backward when training; a
        # mesh rank's heads and d_ff columns
        da = model.rd["d_att_local"]
        mix = 4 * n * d + 20 * n * da + 10 * n * cfg.d_ff // tp
        dec = RWKV_CHUNK * da * 4 * (2 * n if train else 3 * RWKV_CHUNK)
        work = max(norm, mix) + dec
    elif cfg.family == "hybrid":
        # Mamba2: in_proj (z, x, B, C, dt) bf16, the conv and the scan's
        # inputs and output fp32 (``mamba2_dims``), at the rank's heads;
        # the shared block: its attention and SwiGLU MLP
        di = cfg.mamba_expand * d // tp
        width = 2 * di + 2 * cfg.mamba_d_state + di // cfg.mamba_headdim
        mamba = max(norm, n * (2 * width + 4 * (di + 2 * cfg.mamba_d_state)
                               + 12 * di)) + 4 * n * d
        shared = max(norm, attn, 16 * n * cfg.d_ff // tp) + 4 * n * d
        if not train:
            return max(mamba, shared)
        block = sum(math.prod(s) for _, s, st in
                    _leaves(model.param_shapes()) if not st and len(s) > 1
                    and s[0] != model.v_pad)
        return cfg.attn_every * (2 * layer + 2 * mamba) + \
            2 * block + 2 * shared
    elif cfg.num_experts:
        # MoE: router logits fp32, the capacity slots' inputs bf16, g and
        # u fp32 products at the rank's ffe, their SiLU product, outputs
        # fp32; on a mesh the rank's experts take (E / dp) x (dp x cap)
        # rows, E x cap in all, and the (E, cap, d) bf16 exchange adds the
        # received dispatch and the returned rows, and expert-TP the fp32
        # down product and its all-reduced copy
        e, k = cfg.num_experts, cfg.experts_per_token
        cap = int(max(1, round(n * k / e * cfg.capacity_factor)))
        moe = 4 * n * e + e * cap * (16 * cfg.moe_d_ff // tp + 8 * d) \
            + 8 * n * k * d
        if dp > 1:
            moe += 4 * e * cap * d
        if tp > 1:
            moe += 8 * e * cap * d
        work = max(norm, attn, moe)
    else:
        # dense and VLM decoder layers: SwiGLU's g and u and their fp32
        # product; enc-dec: the GELU MLP's bf16 h, its fp32 copy and the
        # fp32 GELU beside it
        per = 10 if cfg.family == "encdec" else 16
        work = max(norm, attn, per * n * cfg.d_ff // tp)
    work += 4 * n * d
    if not train:
        return work
    return period(cfg) * (2 * layer + 2 * work)


def serve_terms(model, pool: int, step_tokens: int, rows: int,
                ctx_tokens: int = 0, enc_rows: int = 0) -> Dict[str, int]:
    """Predicted peak bytes of a serving run: bf16 weights, the buffer
    (``pool``: ``pool_bytes``), and the activations of its largest step
    (``step_tokens`` tokens, ``rows`` logits rows, ``ctx_tokens`` slots of
    K/V gathered per layer of a cycle, ``enc_rows`` encoder rows)."""
    cfg = model.cfg
    v, d = getattr(model, "v_local", model.v_pad), cfg.d_model
    kvd = getattr(model, "kv_local", cfg.num_kv_heads) * cfg.head_dim
    # a decoder gathers a cycle's pages before any is written
    gathers = len(cfg.attn_pattern) if cfg.family in ("dense", "moe",
                                                      "vlm") else 1
    act = {
        "head": 4 * v * d + 12 * rows * v,
        "layer": _layer_bytes(model, step_tokens),
        "context": 4 * kvd * (ctx_tokens + step_tokens) * gathers,
    }
    if cfg.family == "encdec":
        # cross attention: every row's encoder slots gathered (the bf16
        # pages, then K and V copied out of them) and, padded, read in
        # fp32 by plain torch beside the step's scores over them, fp32,
        # four of them at once
        enc = -(-cfg.encoder_seq // cfg.tokens_per_page) * cfg.tokens_per_page
        act["cross"] = 16 * step_tokens * model.ri["q_local"] * enc + \
            12 * rows * enc * kvd
        if enc_rows:
            act["encoder"] = _layer_bytes(model, enc_rows * cfg.encoder_seq)
    return dict(weights=weight_bytes(model), pool=pool,
                activations=sum(act.values()), detail=act)


def train_terms(model, rows: int, seq: int, micro: int,
                zero1: bool = True) -> Dict[str, int]:
    """Predicted peak bytes of a ``Trainer`` step of ``rows`` x ``seq``
    tokens in ``micro`` micro-batches on one card, or on one rank of the
    model's mesh with ``rows`` rows of its own (see the module
    docstring)."""
    cfg = model.cfg
    n = rows // micro * seq
    v, d = getattr(model, "v_local", model.v_pad), cfg.d_model
    pc = param_counts(model)
    ckpt = 2 * n * d * -(-cfg.num_layers // period(cfg))
    if cfg.family == "encdec":
        ckpt += 2 * (rows // micro) * cfg.encoder_seq * d * \
            cfg.encoder_layers
    head = 12 * n * v + 8 * v * d + ckpt
    backward = 4 * pc["stacked"] + max(4 * pc["largest_stack"],
                                       _layer_bytes(model, n, train=True))
    act = {"head": head, "last_layer": backward}
    state = mesh_train_bytes(model, zero1)
    return dict(weights=sum(state.values()), pool=0,
                activations=max(act.values()), detail=dict(act, **state))


def peak(terms) -> int:
    return terms["weights"] + terms["pool"] + terms["activations"]


def fit_bytes(mesh=(1, 1)) -> int:
    """The most a peak may be on one card (of a mesh of several)."""
    return FIT_BYTES - (MESH_RESERVE if math.prod(mesh) > 1 else 0)


# ------------------------------------------------------------ the cells
def period(cfg) -> int:
    """Layers in one cycle of the model's layer pattern."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.family in ("dense", "moe", "vlm"):
        return len(cfg.attn_pattern)
    return 1


def at_depth(cfg, layers: int):
    return dataclasses.replace(cfg, num_layers=layers)


def pod_data_model(mesh) -> Tuple[int, int, int]:
    """(pod, data, model) of a ``(data, model)`` or ``(pod, data, model)``
    mesh."""
    return (1,) * (3 - len(mesh)) + tuple(mesh)


def mesh_model(cfg, mesh=(1, 1), fsdp: bool = False, sp: bool = False):
    """``cfg``'s model on one card, or one rank's of a ``(data, model)``
    or ``(pod, data, model)`` ``mesh`` (a ``Dist`` without process groups:
    shapes only; ``sp`` and the model's K/V replicas for serving). FSDP on
    the hybrid, RWKV6 and enc-dec raises ``NotImplementedError``."""
    from ..models import build_model
    if math.prod(mesh) == 1:
        return build_model(cfg)
    from ..models.tp import Dist, replica_info
    pod, dp, tp = pod_data_model(mesh)
    repl = replica_info(cfg.num_heads, cfg.num_kv_heads, tp)["repl"] \
        if cfg.family != "ssm" else 1
    return build_model(cfg, Dist(dp=dp, tp=tp, pod=pod, fsdp=fsdp, sp=sp,
                                 repl=repl))


def cell_terms(cfg, shape, mesh=(1, 1), fsdp: bool = False, pods: int = 1):
    """(terms, cell) of one card's share of ``shape`` for ``cfg``, on one
    card or on one rank of a ``mesh`` (an ``sp`` serving cell's
    sequences split over its data ranks); ``pods`` 2: a share of the
    reference's multi-pod mesh (``mesh.card_share``). A pod mesh of cards
    trains only (the port serves on a ``(data, model)`` mesh)."""
    pod, dp, _ = pod_data_model(mesh)
    if pod > 1 and shape.kind != "train":
        raise NotImplementedError("serving on a pod mesh")
    sp = card_share(shape).sp and shape.kind != "train" and dp > 1
    model = mesh_model(cfg, mesh, fsdp, sp)
    share = card_share(shape, dp if sp else 1, pods)
    if shape.kind == "train":
        micro = min(default_micro_batches(cfg), share.rows)
        cell = train_cell(cfg, shape, micro, pods)
        terms = train_terms(model, share.rows, share.tokens, micro)
    else:
        cell = serve_cell(model, cfg, shape, pods)
        step = share.rows * (share.tokens if shape.kind == "prefill" else 1)
        terms = serve_terms(model, cell.pool_bytes, step, share.rows,
                            enc_rows=share.rows)
    terms["batch"] = cell.batch_bytes
    return terms, cell


def largest_depth(cfg, fits) -> int:
    """The deepest whole-cycle cut of ``cfg`` (its full depth included)
    for which ``fits(cut_cfg)``; 0 when not even one cycle fits."""
    step = period(cfg)
    depths = sorted({*range(step, cfg.num_layers + 1, step),
                     cfg.num_layers})
    lo, hi = 0, len(depths) - 1
    best = 0
    while lo <= hi:                 # the peak grows with depth
        mid = (lo + hi) // 2
        if fits(at_depth(cfg, depths[mid])):
            best, lo = depths[mid], mid + 1
        else:
            hi = mid - 1
    return best


def plan(arch: str, shape_name: str, mesh=(1, 1),
         fsdp: bool = False, pods: int = 1) -> dict:
    """One record of the planner: predicted terms at full depth, whether
    the cell fits one card (one card of ``mesh``), its largest fitting
    depth and its share (of the multi-pod mesh with ``pods`` 2)."""
    cfg, shape = ARCHS[arch], SHAPES_BY_NAME[shape_name]
    terms, cell = cell_terms(cfg, shape, mesh, fsdp, pods)
    total = peak(terms) + terms["batch"]
    bound = fit_bytes(mesh)
    depth = largest_depth(cfg, lambda c: _cell_peak(c, shape, mesh, fsdp,
                                                    pods) <= bound)
    flops, nbytes = analytic_terms(cfg, shape)
    return dict(arch=arch, shape=shape_name, kind=shape.kind,
                mesh=list(mesh), fsdp=fsdp,
                full_depth=cfg.num_layers, max_depth=depth, pods=pods,
                fits=total <= bound,
                peak_bytes=total, fit_bytes=bound, terms=terms,
                rows=cell.notes["rows"], tokens=cell.notes["tokens"],
                sp=card_share(shape).sp,
                kv_repl_split=cell.notes.get("kv_repl_split", 1),
                micro_batches=cell.notes.get("micro_batches"),
                buffer_units=cell.buffer_units,
                batch={k: [list(s), dt] for k, (s, dt) in cell.arrays.items()},
                roofline=dict(flops=flops, bytes=nbytes,
                              t_compute_s=flops / PEAK_FLOPS,
                              t_memory_s=nbytes / HBM_BW))


# ---------------------------------------------------------- on the card
def _timed(device, fn):
    """(fn(), the CUDA-event ms of its work on the card; None elsewhere)."""
    import torch
    if torch.device(device).type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def run_cell(cfg, kind: str, rows: int, tokens: int, micro: int, pool: int,
             device) -> dict:
    """Run one cell once with seeded random weights on ``device``: a
    prefill as one packed dispatch of ``rows`` x ``tokens`` tokens, a
    decode as one padded T == 1 dispatch of ``rows`` rows over ``tokens``
    of context (their pages left as the zeroed buffer gives them), a train
    cell as one ``Trainer`` step of ``rows`` x ``tokens`` tokens in
    ``micro`` micro-batches. ``pool``: the unified buffer's units (serve
    cells). Returns whether the outputs are finite, the loss or the
    logits' shape, and on the card the CUDA-event ms of the dispatch or
    step (``ms``; the weights are drawn before it)."""
    import numpy as np

    from ..models import build_model
    model = build_model(cfg)
    if kind == "train":
        from ..training import (AdamWConfig, SyntheticLM, Trainer,
                                TrainerConfig)
        with tempfile.TemporaryDirectory() as ckpt:    # never written
            tr = Trainer(model, AdamWConfig(), TrainerConfig(
                micro_batches=micro, ckpt_every=1 << 30, ckpt_dir=ckpt))
            params, state = tr.init_state(0, device=device)
            data = SyntheticLM(cfg.vocab_size, seq_len=tokens,
                               global_batch=rows, mode="markov")
            (_, _, hist), ms = _timed(device, lambda: tr.run(
                params, state, data, num_steps=1))
        return dict(loss=hist[0], finite=bool(np.isfinite(hist).all()),
                    ms=ms)
    from ..core.request import SequenceState
    from ..serving import Engine, EngineConfig, Request
    params = model.init(seed=0, device=device)
    big = lcm([s.page_units for s in model.kv_specs()])
    eng = Engine(model, EngineConfig(
        kv_pool_bytes=(pool - big) * BYTES_PER_UNIT, max_running=rows),
        params=params, device=device)
    prefill = kind == "prefill"
    rng = np.random.default_rng(0)
    items = []
    for i in range(rows):
        prompt = rng.integers(0, cfg.vocab_size, tokens).tolist()
        req = Request(rid=f"r{i}", prompt=prompt)
        req.seq = SequenceState(rid=req.rid, tokens=list(prompt))
        if not (eng.mgr.begin_request(req.seq)[0] and
                eng.mgr.allocate_for_tokens(req.seq, tokens)):
            raise RuntimeError("the cell's pool does not hold its rows")
        if not prefill:
            eng.mgr.advance(req.seq, tokens - 1)
        items.append((req, tokens if prefill else 1))
    logits, ms = _timed(device, lambda: eng.runner.run_plan(
        params, items, packed=prefill))
    return dict(logits_shape=list(logits.shape), ms=ms,
                finite=bool(np.isfinite(logits[:, :cfg.vocab_size]).all()))


def measure(rec: dict, device: str = "cuda") -> dict:
    """``run_cell`` of ``rec`` on the card at its largest fitting depth
    (its full depth when it fits), with
    its peak allocated bytes (weights, pool and the run) and the
    prediction at that depth."""
    import torch

    from .. import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("--measure runs on the card: no CUDA device")
    if rec["max_depth"] == 0:
        raise ValueError(f"{rec['arch']} {rec['shape']}: no depth fits")
    cfg = at_depth(ARCHS[rec["arch"]], rec["max_depth"])
    terms, cell = cell_terms(cfg, SHAPES_BY_NAME[rec["shape"]])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = run_cell(cfg, rec["kind"], rec["rows"], rec["tokens"],
                   rec["micro_batches"], cell.buffer_units, dev)
    out.update(peak_bytes=torch.cuda.max_memory_allocated(),
               predicted_bytes=peak(terms) + terms["batch"],
               device=torch.cuda.get_device_name(0))
    return out


# ------------------------------------------------------------------ main
def _mesh_arg(text: str):
    """DxM, or PxDxM (a pod mesh)."""
    dims = tuple(int(x) for x in text.lower().split("x"))
    if len(dims) not in (2, 3):
        raise argparse.ArgumentTypeError(f"a mesh is DxM or PxDxM: {text}")
    return dims


def meshes_of(cards: int):
    """Every (data, model) mesh of ``cards`` cards, with and without
    FSDP (which needs more than one data rank), and every (pod, data,
    model) mesh of 2 pods (the reference's multi-pod count)."""
    out = []
    for pod in (1, 2):
        if cards % pod:
            continue
        n = cards // pod
        for tp in range(1, n + 1):
            if n % tp == 0:
                dp = n // tp
                mesh = (dp, tp) if pod == 1 else (pod, dp, tp)
                out += [(mesh, False)] + ([(mesh, True)] if dp > 1 else [])
    return out


MESH_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")


def fit_cards(cards: int) -> list:
    """For every training and serving cell of the families that run on a
    mesh: each mesh of ``cards`` cards (FSDP only for training), its
    per-card peak at full depth, whether it fits, and its largest fitting
    depth."""
    rows = []
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        if cfg.family not in MESH_FAMILIES:
            continue
        for shape in shapes_for(cfg):
            for mesh, fsdp in meshes_of(cards):
                if fsdp and shape.kind != "train":
                    continue
                try:
                    terms, _ = cell_terms(cfg, shape, mesh, fsdp)
                except (ValueError, NotImplementedError):
                    continue    # heads or experts do not split; no FSDP;
                    # a pod mesh serving
                total = peak(terms) + terms["batch"]
                bound = fit_bytes(mesh)
                depth = cfg.num_layers if total <= bound else \
                    largest_depth(cfg, lambda c: _cell_peak(
                        c, shape, mesh, fsdp) <= bound)
                rows.append(dict(arch=arch, shape=shape.name,
                                 kind=shape.kind, mesh=list(mesh), fsdp=fsdp,
                                 peak_bytes=total,
                                 fits=total <= bound, max_depth=depth))
    return rows


def _cell_peak(cfg, shape, mesh, fsdp, pods=1) -> int:
    terms, _ = cell_terms(cfg, shape, mesh, fsdp, pods)
    return peak(terms) + terms["batch"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="also run each cell once on the card")
    ap.add_argument("--mesh", type=_mesh_arg, default=(1, 1),
                    help="DxM: one card of a (data, model) mesh; PxDxM: "
                         "of a (pod, data, model) one (training)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="one card's share of the reference's 2x16x16 "
                         "(pod, data, model) cells: global_batch / 32 rows")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --mesh: shard layer weights over data")
    ap.add_argument("--cards", type=int,
                    help="list the meshes of N cards each training and "
                         "serving cell of the mesh families fits, and at "
                         "which depth")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.cards:
        rows = fit_cards(args.cards)
        with open(os.path.join(args.out, f"fit_{args.cards}_cards.json"),
                  "w") as fh:
            json.dump(rows, fh, indent=1)
        for r in rows:
            print(f"[fit {args.cards} cards] {r['arch']} {r['shape']} "
                  f"({r['kind']}) mesh "
                  f"{'x'.join(map(str, r['mesh']))}"
                  f"{' fsdp' if r['fsdp'] else ''}: per-card peak "
                  f"{r['peak_bytes'] / 1e9:.2f} GB, fits={r['fits']}, "
                  f"largest depth {r['max_depth']} of "
                  f"{ARCHS[r['arch']].num_layers}", flush=True)
        return 0
    mesh = tuple(args.mesh)
    pods = 2 if args.multi_pod else 1
    one = math.prod(mesh) == 1
    if args.all:
        cells = [(a, s.name) for a in sorted(ARCHS)
                 for s in shapes_for(ARCHS[a])
                 if one or (ARCHS[a].family in MESH_FAMILIES
                            and not (s.kind != "train" and len(mesh) == 3)
                            and not (args.fsdp and (
                                s.kind != "train" or ARCHS[a].family in
                                ("hybrid", "ssm", "encdec"))))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --all, --cards, or --arch and --shape")
    if args.measure and not one:
        ap.error("--measure runs one card (chip_smoke.py measures a mesh)")
    tag = ("" if one else
           f"__{'x'.join(map(str, mesh))}{'_fsdp' if args.fsdp else ''}") + \
        ("__2x16x16" if pods > 1 else "")
    for arch, shape in cells:
        t0 = time.perf_counter()
        rec = plan(arch, shape, mesh, args.fsdp, pods)
        if args.measure:
            rec["measured"] = measure(rec)
        with open(os.path.join(args.out, f"{arch}__{shape}{tag}.json"),
                  "w") as fh:
            json.dump(rec, fh, indent=1)
        state = rec["terms"]["detail"]
        extra = "" if one or "params" not in state else (
            f" per card: params {state['params'] / 1e9:.3f} GB, grads "
            f"{state['grads'] / 1e9:.3f} GB, moments "
            f"{state['moments'] / 1e9:.3f} GB;")
        print(f"[plan] {arch} {shape}{tag}:{extra} peak "
              f"{rec['peak_bytes'] / 1e9:.2f} "
              f"GB at {rec['full_depth']} layers, fits={rec['fits']}, "
              f"largest depth {rec['max_depth']} "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
