"""Decoder-only LM: the training loss and the packed and padded serve
steps of the dense, MoE and VLM-backbone families (``repro/models/lm.py``).

All three train on a ``(data, model)`` mesh (``models.tp.Dist``): each
rank holds its slice of the reference's expanded parameters (a MoE's
experts split over the data axis and their ffe over the model axis),
FSDP gathers a layer's shards inside its checkpointed cycle, and the loss
(and a MoE's aux loss) is summed over the data axis. All three serve on
such a mesh too (the reference's ``shard_map``'d ``serve_step``): each
rank takes its batch (``launch.input_specs.split_batch``), its heads, its
vocabulary rows and its experts, and returns its (rows, V_local) logits
(``tp.gather_logits`` assembles the global ones)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.layout import PageView, check_stride
from ..core.spec import KVCacheSpec, attention_spec
from ..kernels.paged_attention import paged_decode_plan
from . import attention as A
from . import blocks_attn as BA
from .common import rms_norm, set_matmul_precision
from .params import MATRICES, leaf_shard, local_part
from .rotary import mrope_tables, rope_tables
from .tp import (Dist, embed_lookup, gather_data, logits_local,
                 mask_pad_vocab, psum_dp, replica_info, replicated_loss,
                 sharded_softmax_xent)

# values a weight leaf is drawn in at a time (``DecoderLM.init``): 1 GiB
# of fp32
DRAW_CHUNK = 1 << 28


@dataclasses.dataclass
class DecodeBatch:
    """One serving step's device inputs. PACKED layout: ALL sequences
    flattened into one (1, TT) token stream with per-token segment ids;
    per-type page tables flattened into one page stream with per-page
    owning segments. PADDED layout (``seg_ids`` None): one (B, T) row per
    sequence, per-row tables, ``last_idx`` per row. Field names and shapes
    follow the reference's ``DecodeBatch`` (shapes: packed / padded; fields
    of other layouts and families stay None)."""
    tokens: Any            # (1, TT) / (B, T) i32
    positions: Any         # like tokens: absolute positions of the new tokens
    seq_lens: Any          # (N_seg,) / (B,) i32 total kv length after this step
    tables: Dict[str, Any]       # type -> (1, 1, 1, P) / (1, 1, B, P) i32
    page_pos: Dict[str, Any]     # type -> like tables
    write_eids: Dict[str, Any]   # type -> (1, 1, 1, TT) / (1, 1, B, T) (<0 drop)
    state_eids: Dict[str, Any]   # type -> (1, N_seg) / (1, B) i32
    mm_embeds: Any = None
    mm_mask: Any = None
    mrope_pos: Any = None
    last_idx: Any = None         # (B,) i32 padded: each row's last real token
    enc_embeds: Any = None
    enc_write_eids: Any = None
    enc_lens: Any = None
    seg_ids: Any = None          # (1, TT) i32 segment id per token (-1 pad)
    chunk_start: Any = None      # (1, TT) i32 chunk-start position per token
    seg_start_tok: Any = None    # (1, TT) i32 stream idx of segment's first tok
    seg_last_tok: Any = None     # (N_seg,) i32 stream idx of segment's last tok
    page_seg: Any = None         # type -> (1, 1, 1, P) i32 owning segment
    page_strides: Any = None     # type -> units between its pages (host
    #                              ints; None: each page's own units, the
    #                              LCM geometry's stride)


def draw_normal(shape, scale: float, dtype, gen) -> torch.Tensor:
    """A ``dtype`` tensor of normal draws times ``scale`` from ``gen``, on
    its device, drawn in fp32 in slices of its first axis (or of its
    second, when one slice of the first is larger) of at most DRAW_CHUNK
    values, so the fp32 draw of a bf16 leaf never needs the whole leaf in
    fp32."""
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = w if math.prod(shape[1:]) <= DRAW_CHUNK else \
        w.view(-1, *shape[2:])
    rows = max(1, DRAW_CHUNK // math.prod(flat.shape[1:]))
    for i in range(0, flat.shape[0], rows):
        part = torch.randn((min(rows, flat.shape[0] - i), *flat.shape[1:]),
                           generator=gen, dtype=torch.float32,
                           device=gen.device)
        flat[i:i + rows] = part.mul_(scale)
    return w


def unstack(tree: Dict[str, torch.Tensor]):
    """Per-layer views of a dict of (L, ...) stacked parameters."""
    names = list(tree)
    return [dict(zip(names, ws))
            for ws in zip(*(tree[n].unbind(0) for n in names))]


class DecoderLM:
    """Decoder: dense, MoE (``moe_block`` in place of the MLP) and the VLM
    backbone (precomputed image embeddings spliced in, M-RoPE).
    Parameters are a plain dict mirroring the reference tree, each leaf
    this rank's slice of the expanded layout (``models.params``; on one
    device the tp dim is dropped and nothing is split).

    ``dist``: the rank's place on a ``(data, model)`` mesh (one device by
    default), on which every member trains and serves.

    ``moe_drops``: set it to a list to have every MoE serve step append
    its count of dropped (token, k) copies, summed over the layers, as a
    device tensor."""

    moe_drops = None

    def __init__(self, cfg: ModelConfig, dist: Optional[Dist] = None):
        cfg.validate()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"family {cfg.family!r}: DecoderLM serves the dense, moe and "
                "vlm families")
        dist = dist or Dist()
        if cfg.num_experts and (cfg.num_experts % dist.dp
                                or cfg.moe_d_ff % dist.tp):
            raise ValueError(
                f"{cfg.num_experts} experts of ffe {cfg.moe_d_ff} do not "
                f"split over a {dist.dp} x {dist.tp} mesh")
        set_matmul_precision()
        self.is_moe = cfg.num_experts > 0
        self.cfg = cfg
        self.dist = dist
        self.ri = replica_info(cfg.num_heads, cfg.num_kv_heads, dist.tp)
        self.kv_local = self.ri["kv_local"]
        self.v_local = -(-cfg.vocab_size // dist.tp)
        self.v_pad = self.v_local * dist.tp
        # FSDP: stacked layer weights sharded over "data" (the reference
        # shards only when the data axis has more than one rank)
        self.fsdp = dist.fsdp and dist.dp > 1
        self.period = len(cfg.attn_pattern)
        assert cfg.num_layers % self.period == 0, (cfg.num_layers, self.period)
        self.cycles = cfg.num_layers // self.period
        self.period_kinds = cfg.attn_kind_per_layer[: self.period]
        self.cnt = {"full": self.period_kinds.count("full"),
                    "swa": self.period_kinds.count("swa")}
        self.rank_in_period = []
        seen = {"full": 0, "swa": 0}
        for k in self.period_kinds:
            self.rank_in_period.append(seen[k])
            seen[k] += 1
        self._layer_shards = self.shards()["layers"]

    # ----------------------------------------------------------- kv specs
    kv_prefix = ""

    def kv_type_of_kind(self, kind: str) -> str:
        return self.kv_prefix + ("full_attn" if kind == "full" else "swa")

    def kv_specs(self) -> Tuple[KVCacheSpec, ...]:
        cfg = self.cfg
        out = []
        n_full = self.cnt["full"] * self.cycles
        n_swa = self.cnt["swa"] * self.cycles
        if n_full:
            out.append(attention_spec(
                self.kv_prefix + "full_attn", num_layers=n_full,
                kv_heads=self.kv_local, head_dim=cfg.head_dim,
                tokens_per_page=cfg.tokens_per_page))
        if n_swa:
            out.append(attention_spec(
                self.kv_prefix + "swa", num_layers=n_swa,
                kv_heads=self.kv_local, head_dim=cfg.head_dim,
                tokens_per_page=cfg.tokens_per_page,
                kind="swa", sliding_window=cfg.sliding_window))
        return tuple(out)

    def page_shapes(self) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        shp = (2, cfg.tokens_per_page, self.kv_local, cfg.head_dim)
        out = {}
        if self.cnt["full"]:
            out[self.kv_prefix + "full_attn"] = shp
        if self.cnt["swa"]:
            out[self.kv_prefix + "swa"] = shp
        return out

    # --------------------------------------------------------------- init
    def global_shapes(self) -> Dict[str, Any]:
        """Shapes of the reference template at the mesh's tp: each
        tensor-parallel leaf with its tp axis (``tp``, ...) or (L, ``tp``,
        ...), the q heads padded per ``gqa_tp_layout``, the vocabulary
        padded to ``v_pad`` rows. Keys in the order ``init`` draws them."""
        cfg, tp, ri = self.cfg, self.dist.tp, self.ri
        d, hd, L = cfg.d_model, cfg.head_dim, cfg.num_layers
        qd, kvd = ri["q_local"] * hd, ri["kv_local"] * hd
        layers = {"attn_norm": (L, d), "q": (L, tp, d, qd),
                  "k": (L, tp, d, kvd), "v": (L, tp, d, kvd),
                  "o": (L, tp, qd, d), "mlp_norm": (L, d)}
        if self.is_moe:
            e, ffe = cfg.num_experts, cfg.moe_d_ff
            layers.update(router=(L, d, e), moe_gate=(L, e, d, ffe),
                          moe_up=(L, e, d, ffe), moe_down=(L, e, ffe, d))
        else:
            ffl = cfg.d_ff // tp
            layers.update(gate=(L, tp, d, ffl), up=(L, tp, d, ffl),
                          down=(L, tp, ffl, d))
        if cfg.qkv_bias:
            layers.update(q_bias=(L, tp, qd), k_bias=(L, tp, kvd),
                          v_bias=(L, tp, kvd))
        tree = {"embed": (tp, self.v_local, d), "final_norm": (d,),
                "layers": layers}
        if not cfg.tie_embeddings:
            tree["unembed"] = (tp, self.v_local, d)
        return tree

    def shards(self) -> Dict[str, Any]:
        """Each leaf's ``Shard``: its tp axis, and its FSDP data dim."""
        fam = self.cfg.family

        def go(tree, parent):
            return {n: go(v, n) if isinstance(v, dict) else
                    leaf_shard(fam, parent, n, v, self.dist)
                    for n, v in tree.items()}
        return go(self.global_shapes(), "")

    def param_shapes(self) -> Dict[str, Any]:
        """Shapes of this rank's leaves: the global shapes with the tp
        axis dropped, the FSDP dim or the experts split over the data axis
        and the experts' ffe over the model axis."""
        dp, tp = self.dist.dp, self.dist.tp

        def local(shape, shard):
            shape = list(shape)
            if shard.tp_axis is not None:
                del shape[shard.tp_axis]
            if shard.data_dim is not None:
                shape[shard.data_dim] //= dp
            if shard.model_dim is not None:
                shape[shard.model_dim] //= tp
            return tuple(shape)

        def go(tree, shards):
            return {n: go(v, shards[n]) if isinstance(v, dict) else
                    local(v, shards[n]) for n, v in tree.items()}
        return go(self.global_shapes(), self.shards())

    def init(self, seed: int = 0, device="cuda", master: bool = False,
             local: bool = False) -> Dict[str, Any]:
        """Random weights from ``seed`` with the reference template's
        shapes and scales (normal 0.02; o/down/moe_down 0.02/sqrt(2L);
        norms ones; biases zeros), drawn by a ``torch.Generator`` on
        ``device``. Matrices are bf16 (serving) or, with ``master``, fp32
        like every other leaf (training's masters, the reference's
        ``PARAM_DTYPE``); norms, biases and the MoE router are fp32. The
        draws differ from the reference's ``jax.random`` ones: tests that
        compare the two packages convert the reference's params
        (``params_from_numpy``). A leaf is drawn in
        slices of its first axis (a layer, or a block of vocab rows) of at
        most DRAW_CHUNK values, so the fp32 draw of a bf16 leaf never
        needs the whole leaf in fp32: qwen2.5-32b's 65.5 GB of bf16
        weights are drawn on one 80 GB card. An expert leaf, whose layer
        is larger than that (qwen3-moe: 0.8 G values), is drawn in
        slices of experts.

        On a mesh every rank draws the one-device model's leaves from
        ``seed`` one at a time and keeps its slice of each in the
        expanded layout (``_expand``; its experts and their ffe columns),
        so the model computes the same function on every mesh (a MoE's up
        to the capacity and aux loss taken per data rank, as the
        reference takes them). With ``local`` each rank draws its own
        leaves directly from ``seed * 1000 + rank``, at the same scales: a
        model of the same shapes but of other values on every mesh, for a
        model whose one-device leaves do not fit one card (dbrx-132b's
        stacked experts are 84 GB at 40 layers)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1000 + self.dist.rank if local else seed)
        out_scale = 0.02 / (2 * self.cfg.num_layers) ** 0.5

        def leaf(name, shape):
            if name.endswith("norm"):
                return torch.ones(shape, dtype=torch.float32, device=dev)
            if name.endswith("bias"):
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            scale = out_scale if name in ("o", "down", "moe_down") else 0.02
            bf16 = not master and name in MATRICES
            return draw_normal(shape, scale, torch.bfloat16 if bf16 else
                               torch.float32, gen)

        def mine(name, shape, shard):
            if self.dist.size == 1 or local:
                return leaf(name, shape)
            whole = self._expand(name, leaf(name, shape))
            # a copy: a contiguous slice would keep the whole one-device
            # leaf alive (a vocabulary table, tp times this rank's part)
            return local_part(whole, shard, self.dist).clone(
                memory_format=torch.contiguous_format)

        # the one-device model's leaves, in the order they are drawn
        shapes = (self if local else DecoderLM(self.cfg)).param_shapes()
        shards = self.shards()
        params = {n: mine(n, s, shards[n]) for n, s in shapes.items()
                  if n != "layers"}
        params["layers"] = {n: mine(n, s, shards["layers"][n])
                            for n, s in shapes["layers"].items()}
        return params

    def _expand(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The one-device leaf ``w`` in the expanded layout at the mesh's
        tp, computing the same function: the vocabulary padded with zero
        rows, each rank's q heads (a K/V group's heads padded with zero
        heads to a multiple of its replicas) and their o rows, its K/V
        heads (copied to every replica), its ``d_ff`` columns and down
        rows. Leaves without a tp axis (the experts among them) are
        returned as they are."""
        ri, tp = self.ri, self.dist.tp
        hd, kv = self.cfg.head_dim, self.cfg.num_kv_heads
        repl, kv_tp, kvl = ri["repl"], ri["kv_tp"], ri["kv_local"]
        group = self.cfg.num_heads // kv
        gpad = ri["q_pad"] // kv

        def heads(a, grouped):
            # (..., H*hd or KV*hd) -> (..., tp, the rank's heads * hd)
            lead = a.shape[:-1]
            if grouped:
                a = a.reshape(*lead, kv, group, hd)
                if gpad > group:
                    a = torch.cat([a, a.new_zeros(*lead, kv, gpad - group,
                                                  hd)], dim=-2)
                a = a.reshape(*lead, kv_tp, kvl, repl, gpad // repl, hd)
                a = a.movedim(-3, -4)     # (.., kv_tp, repl, kvl, gpp, hd)
            else:
                a = a.reshape(*lead, kv_tp, 1, kvl, hd)
                a = a.expand(*lead, kv_tp, repl, kvl, hd)
            return a.reshape(*lead, tp, -1)

        if name in ("embed", "unembed"):
            pad = self.v_pad - w.shape[0]
            if pad:
                w = torch.cat([w, w.new_zeros(pad, w.shape[1])])
            return w.reshape(tp, self.v_local, w.shape[1])
        if name == "o":                 # (L, H*hd, d) -> (L, tp, .., d)
            return heads(w.movedim(1, -1), True).movedim(-2, 1).movedim(
                -1, 2)
        if name in ("q", "q_bias", "k", "v", "k_bias", "v_bias"):
            return heads(w, name.startswith("q")).movedim(-2, 1)
        if name in ("gate", "up", "down"):
            axis = 1 if name == "down" else 2
            shape = list(w.shape)
            shape[axis:axis + 1] = [tp, shape[axis] // tp]
            return w.reshape(shape).movedim(axis, 1)
        return w

    def _unembed(self, params):
        return params.get("unembed", params["embed"])

    # --------------------------------------------------------------- train
    def train_loss(self, params, tokens: torch.Tensor, targets: torch.Tensor,
                   *, mm_embeds=None, mm_mask=None, mrope_pos=None):
        """Mean next-token cross-entropy of (B, T) int ``tokens`` against
        ``targets`` (the reference's ``train_loss``): a scalar fp32 tensor
        to call ``backward`` on. Each cycle of the attention pattern is
        recomputed in the backward (``torch.utils.checkpoint``), as the
        reference checkpoints each cycle of its scan, so the forward runs
        twice per layer and the backward once.

        MoE: each layer's Switch load-balance loss is summed over the
        layers, divided by the number of cycles and added. VLM: the
        multimodal batch (``mm_embeds`` (B, T, d), ``mm_mask`` (B, T),
        ``mrope_pos`` (3, B, T)) splices the image embeddings in where
        ``mm_mask`` is set and rotates by M-RoPE at ``mrope_pos``; without
        it a VLM trains on text with RoPE at ``arange(T)``, as the
        reference does.

        On a mesh, ``tokens`` and ``targets`` (and the multimodal batch)
        are this data rank's rows and the loss is the mean over every data
        rank's (the reference's ``psum_dp(loss) / dp``), the same on every
        rank. So is a MoE's aux loss (``psum_dp(aux / cycles) / dp``): each
        data rank routes, caps and balances its own tokens. On a pod mesh
        the rows and the mean run over pod x data ranks."""
        mm = (mm_embeds, mm_mask, mrope_pos)
        if any(v is not None for v in mm):
            if self.cfg.family != "vlm":
                raise ValueError(f"family {self.cfg.family!r} takes no "
                                 "multimodal inputs")
            if any(v is None for v in mm):
                raise ValueError("mm_embeds, mm_mask and mrope_pos go "
                                 "together")
        return self._train_body(params, tokens, targets, *mm)

    def _train_body(self, params, tokens, targets, mm_embeds=None,
                    mm_mask=None, mrope_pos=None):
        cfg = self.cfg
        t = tokens.shape[1]
        x = embed_lookup(tokens, params["embed"], self.dist)
        if mm_embeds is not None:
            x = torch.where(mm_mask[..., None], mm_embeds.to(x.dtype), x)
            rope = mrope_tables(mrope_pos, cfg.head_dim, cfg.rope_theta)
        else:
            rope = rope_tables(torch.arange(t, dtype=torch.int32,
                                            device=tokens.device),
                               cfg.head_dim, cfg.rope_theta)
        layers = self._layer_params(params)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device) \
            if self.is_moe else None
        for cycle in range(self.cycles):
            pjs = layers[cycle * self.period:(cycle + 1) * self.period]
            x, aux = checkpoint(self._train_cycle, x, rope, pjs, aux,
                                use_reentrant=False)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_local(x, self._unembed(params))
        dist = self.dist
        loss = sharded_softmax_xent(logits, targets, dist=dist)
        if dist.rows > 1:
            loss = psum_dp(loss, dist) / dist.rows
        if aux is not None:
            aux = aux / max(1, self.cycles)
            if dist.rows > 1:
                aux = psum_dp(aux, dist) / dist.rows
            loss = loss + aux
        return replicated_loss(loss, dist)

    def _fsdp_gather(self, pj):
        """FSDP: one layer's weight shards gathered whole over "data",
        each cast to bf16 first as the reference does (the products round
        weights to bf16 anyway), so the transpose reduce-scatters bf16
        gradients. Expert leaves stay split: their data dim is expert
        parallelism's."""
        if not self.fsdp:
            return pj
        out = dict(pj)
        for name, w in pj.items():
            dim = self._layer_shards[name].fsdp_dim
            if dim is not None:
                out[name] = gather_data(w.to(torch.bfloat16), dim - 1,
                                        self.dist)
        return out

    def _train_cycle(self, x, rope, pjs, aux=None):
        """One cycle of the pattern: each layer's attention (its kind's
        window) and MLP, or MoE with its aux loss added to ``aux`` (None
        for a dense model). Returns (x, aux). Under FSDP each layer's
        shards are gathered here, inside the checkpointed cycle, so the
        backward's recomputation gathers them again (as ``jax.checkpoint``
        recomputes the reference's gather)."""
        cfg = self.cfg
        for pj, kind in zip(pjs, self.period_kinds):
            pj = self._fsdp_gather(pj)
            x = BA.attn_train(
                pj, x, kv_local=self.kv_local, head_dim=cfg.head_dim,
                rope=rope, window=cfg.sliding_window if kind == "swa" else 0,
                norm_eps=cfg.norm_eps, dist=self.dist)
            if self.is_moe:
                x, a = BA.moe_block(
                    pj, x, num_experts=cfg.num_experts,
                    top_k=cfg.experts_per_token,
                    capacity_factor=cfg.capacity_factor,
                    norm_eps=cfg.norm_eps, aux_weight=cfg.router_aux_weight,
                    dist=self.dist)
                aux = aux + a
            else:
                x = BA.mlp_block(pj, x, cfg.norm_eps, dist=self.dist)
        return x, aux

    # --------------------------------------------------------------- serve
    def _layer_views(self, buffer_flat: torch.Tensor, strides=None):
        """Per-type ``PageView``s of the unified buffer (paper Fig. 7c):
        type t sees (VP_t, num_layers_t, *page_shape) with its pages
        ``strides[t]`` units apart (the runner's layout, with the step's
        batch; None: each page's own units, the LCM geometry's contiguous
        view) and VP_t = total_units // stride."""
        shapes = self.page_shapes()
        total = buffer_flat.shape[-1]
        views = {}
        for s in self.kv_specs():
            stride = s.page_units if strides is None else strides[s.name]
            check_stride(s, stride, total)
            views[s.name] = PageView(
                (total // stride, s.num_layers) + shapes[s.name], stride)
        return views

    @staticmethod
    def _layer_params(params):
        """Per-layer views of the stacked layer parameters."""
        return unstack(params["layers"])

    def serve_step(self, params, buffer: torch.Tensor, batch: DecodeBatch,
                   prefill: Optional[bool] = None) -> torch.Tensor:
        """One serving step. Writes this step's K/V into ``buffer`` IN PLACE
        (the flat bf16 unified buffer) and returns fp32 logits with
        pad-vocab columns at -1e30: one row per segment in plan order
        (packed, (N_seg, V_pad)) or per batch row (padded, (B, V_pad)).

        PACKED (``batch.seg_ids`` set): every scheduled sequence's tokens in
        one (1, TT) stream through the varlen kernel. PADDED: see
        ``_serve_padded``; ``prefill`` (default ``T > 1``) picks its route.

        Per cycle of the attention pattern, all pages are read before any
        is written, as the reference does. What is the same for every layer
        of the step — rope tables, page indices, slot positions, the varlen
        call's metadata, write rows, per-layer parameter views — is computed
        once per step: the port runs eagerly, and each op costs a launch.

        On a ``(data, model)`` mesh (``dist``) the arguments are this
        rank's: its parameters, its flat buffer and its batch
        (``input_specs.split_batch``: its rows, and its share of every
        page table); the logits are its (rows, V_local) vocabulary
        columns. Where a sequence's pages are split over ranks (K/V
        replicas, ``sp``) the attention's partials combine over them
        (``blocks_attn``); the o-projection, MLP and head sum over the
        model axis. At a 1 x 1 mesh it is the single-device step."""
        self._check_mesh()
        if batch.seg_ids is None:
            return self._serve_padded(params, buffer, batch, prefill)
        cfg = self.cfg
        x = self._embed(params, batch)
        views = self._layer_views(buffer, batch.page_strides)
        rope, step = self._packed_invariants(batch, views)
        layers = self._layer_params(params)
        drops = self._drops()
        for cycle in range(self.cycles):
            gathered = []
            for j, kind in enumerate(self.period_kinds):
                tname = self.kv_type_of_kind(kind)
                lit = cycle * self.cnt[kind] + self.rank_in_period[j]
                st = step[tname]
                gathered.append(BA.attn_gather(
                    buffer, views[tname], st["tables"], lit, st["index"]))
            writes = []
            for j, kind in enumerate(self.period_kinds):
                pj = layers[cycle * self.period + j]
                tname = self.kv_type_of_kind(kind)
                lit = cycle * self.cnt[kind] + self.rank_in_period[j]
                x, k, v = BA.attn_compute(
                    pj, x, *gathered[j], meta=step[tname]["meta"], rope=rope,
                    kv_local=self.kv_local, head_dim=cfg.head_dim,
                    window=cfg.sliding_window if kind == "swa" else 0,
                    norm_eps=cfg.norm_eps, dist=self.dist)
                writes.append((tname, lit, k, v))
                x = self._mlp(pj, x, drops)
            for tname, lit, k, v in writes:
                A.write_kv_rows(buffer, views[tname], lit,
                                step[tname]["rows"], k, v)
        self._record_drops(drops)
        return self._head(params, x, batch)

    def _split_pages(self) -> bool:
        """Whether a sequence's pages are split over this rank's combine
        group."""
        return bool(self.dist.combine_axes)

    def _check_mesh(self):
        """A serve step on a mesh needs the mesh's K/V replica groups to
        be this model's (``launch.mesh.make_dist(..., repl=)``)."""
        dist = self.dist
        if dist.tp > 1 and dist.repl != self.ri["repl"]:
            raise ValueError(
                f"the mesh's K/V replica sets hold {dist.repl} ranks; this "
                f"model's {self.cfg.num_kv_heads} K/V heads at tp {dist.tp} "
                f"need {self.ri['repl']}")

    def _embed(self, params, batch: DecodeBatch) -> torch.Tensor:
        """Token embeddings (summed over the model axis of a mesh), with
        the step's precomputed image embeddings (fp32, rounded to bf16)
        spliced in where ``mm_mask`` is set."""
        x = embed_lookup(batch.tokens, params["embed"], self.dist)
        if batch.mm_embeds is not None:
            x = torch.where(batch.mm_mask[..., None],
                            batch.mm_embeds.to(x.dtype), x)
        return x

    def _rope(self, batch: DecodeBatch):
        """The step's rotary tables: M-RoPE over ``mrope_pos`` when the
        batch carries it, else RoPE over ``positions``."""
        cfg = self.cfg
        if batch.mrope_pos is not None:
            return mrope_tables(batch.mrope_pos, cfg.head_dim, cfg.rope_theta)
        return rope_tables(batch.positions, cfg.head_dim, cfg.rope_theta)

    def _drops(self):
        """A list for this step's ``moe_block`` calls to count their
        dropped copies in, when ``moe_drops`` asks for them."""
        return [] if self.is_moe and self.moe_drops is not None else None

    def _record_drops(self, drops):
        if drops:
            self.moe_drops.append(torch.stack(drops).sum())

    def _mlp(self, pj, x, drops=None):
        """A layer's MLP: SwiGLU, or the capacity MoE."""
        cfg = self.cfg
        if self.is_moe:
            return BA.moe_block(
                pj, x, num_experts=cfg.num_experts,
                top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor, norm_eps=cfg.norm_eps,
                drops=drops, dist=self.dist)
        return BA.mlp_block(pj, x, cfg.norm_eps, dist=self.dist)

    def _attn_views(self, views):
        """The attention types' entries of ``_layer_views``."""
        kinds = {s.name: s.kind for s in self.kv_specs()}
        return {n: v for n, v in views.items()
                if kinds[n] in ("full_attn", "swa")}

    def _packed_invariants(self, batch: DecodeBatch, views):
        """What every layer of a packed step shares: the rope tables and,
        per attention type, the page index, the varlen call's metadata and
        the K/V write rows (on a combine group the split calls' metadata,
        ``packed_attention_meta(..., split=True)``). Returns (rope,
        {type: dict})."""
        positions = batch.positions
        rope = self._rope(batch)
        split = self._split_pages()
        step = {}
        for tname, view in self._attn_views(views).items():
            sq = {f: getattr(batch, f)[tname].reshape(1, -1)
                  for f in ("tables", "page_pos", "page_seg", "write_eids")}
            slot_pos, slot_seg = BA.page_slots(sq["page_pos"],
                                               sq["page_seg"], view[3])
            step[tname] = dict(
                index=A.page_index(sq["tables"]), tables=sq["tables"],
                meta=BA.packed_attention_meta(slot_pos, slot_seg, positions,
                                              batch.seg_ids,
                                              batch.chunk_start, split),
                rows=A.kv_rows(view, sq["write_eids"], positions % view[3]))
        return rope, step

    def _padded_invariants(self, batch: DecodeBatch, views, prefill: bool):
        """What every layer of a padded step shares: the rope tables and,
        per attention type, its tables, page starts, window and K/V write
        rows, plus (T > 1) the page index and masks or (T == 1) the paged
        decode kernel's positions and plan (on a combine group the strict
        old part's, ``blocks_attn.strict_old``). Returns (rope, {type:
        dict})."""
        cfg = self.cfg
        positions = batch.positions
        b, t = positions.shape
        rope = self._rope(batch)
        split = self._split_pages()
        step = {}
        for tname, view in self._attn_views(views).items():
            tables = batch.tables[tname].reshape(b, -1)
            page_pos = batch.page_pos[tname].reshape(b, -1)
            window = cfg.sliding_window \
                if tname == self.kv_type_of_kind("swa") else 0
            st = dict(tables=tables, page_pos=page_pos, window=window,
                      rows=A.kv_rows(view,
                                     batch.write_eids[tname].reshape(b, t),
                                     positions % view[3]))
            if prefill:
                ar = torch.arange(view[3], dtype=page_pos.dtype,
                                  device=page_pos.device)
                slot_pos = (page_pos[:, :, None] + ar).reshape(b, -1)
                st.update(index=A.page_index(tables),
                          meta=BA.padded_prefill_meta(slot_pos, positions,
                                                      window=window))
            else:
                qpos, win = positions[:, 0].contiguous(), window
                if split:
                    qpos, win = BA.strict_old(qpos, window)
                st.update(qpos=qpos, plan=paged_decode_plan(
                    tables, page_pos, qpos, view[3], win))
            step[tname] = st
        return rope, step

    def _head(self, params, x, batch: DecodeBatch) -> torch.Tensor:
        """Final norm and fp32 logits with pad-vocab columns at -1e30: one
        row per segment (packed: its last token in the stream) or per
        batch row (padded: its last real token, or its last slot when the
        batch has no ``last_idx``)."""
        x = self._final_norm(params, x)
        if batch.seg_ids is not None:
            x = x[0].index_select(0, batch.seg_last_tok.long())
        elif batch.last_idx is not None:
            x = x[torch.arange(x.shape[0], device=x.device),
                  batch.last_idx.long()]
        else:
            x = x[:, -1]
        logits = logits_local(x, self._unembed(params))
        return mask_pad_vocab(logits, self.cfg.vocab_size, self.dist)

    def _final_norm(self, params, x):
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def _serve_padded(self, params, buffer: torch.Tensor, batch: DecodeBatch,
                      prefill: Optional[bool]) -> torch.Tensor:
        """One padded serving step (the reference's non-packed
        ``_serve_body``): one (B, T) row per sequence with per-row tables,
        page positions and write targets; SENTINEL positions on pad slots,
        -1 tables and write targets on pad and killed rows.

        ``prefill`` (T > 1): per cycle, every layer's old pages are
        gathered, attention runs in plain torch (``attn_compute_padded``),
        and the cycle's K/V writes come last. Otherwise (T == 1) each layer
        writes its token's K/V and reads its pages in place through the
        paged decode kernel (``attn_decode``): no gather at all. Returns
        (B, V_pad) fp32 logits, row b taken at ``last_idx[b]``."""
        cfg = self.cfg
        positions = batch.positions
        if prefill is None:
            prefill = positions.shape[1] > 1
        x = self._embed(params, batch)
        views = self._layer_views(buffer, batch.page_strides)
        rope, step = self._padded_invariants(batch, views, prefill)
        layers = self._layer_params(params)
        drops = self._drops()
        for cycle in range(self.cycles):
            gathered = []
            if prefill:
                for j, kind in enumerate(self.period_kinds):
                    tname = self.kv_type_of_kind(kind)
                    lit = cycle * self.cnt[kind] + self.rank_in_period[j]
                    st = step[tname]
                    gathered.append(BA.attn_gather(
                        buffer, views[tname], st["tables"], lit, st["index"]))
            writes = []
            for j, kind in enumerate(self.period_kinds):
                pj = layers[cycle * self.period + j]
                tname = self.kv_type_of_kind(kind)
                lit = cycle * self.cnt[kind] + self.rank_in_period[j]
                st = step[tname]
                kw = dict(rope=rope, kv_local=self.kv_local,
                          head_dim=cfg.head_dim, window=st["window"],
                          norm_eps=cfg.norm_eps, dist=self.dist)
                if prefill:
                    x, k, v = BA.attn_compute_padded(
                        pj, x, *gathered[j], meta=st["meta"], **kw)
                    writes.append((tname, lit, k, v))
                else:
                    x = BA.attn_decode(
                        pj, x, buffer, views[tname], lit, rows=st["rows"],
                        tables=st["tables"], page_pos=st["page_pos"],
                        qpos=st["qpos"], plan=st["plan"], **kw)
                x = self._mlp(pj, x, drops)
            for tname, lit, k, v in writes:
                A.write_kv_rows(buffer, views[tname], lit,
                                step[tname]["rows"], k, v)
        self._record_drops(drops)
        return self._head(params, x, batch)
