"""RWKV6 ("Finch") language model (``repro/models/rwkv_lm.py``):
attention-free, with a data-dependent decay. One KV type, a single "rwkv"
state spec (the wkv matrix state and the two token-shift states of every
layer): no token pages at all, the paper's state-space extreme.

Plain torch throughout (the reference has no TPU kernel here). Serving:
packed steps run ``blocks_seq.rwkv6_packed``, padded T > 1 steps
``rwkv6_chunked`` and padded T == 1 steps ``rwkv6_step``. Each layer reads
its state from the unified buffer and writes it back (fp32 as bf16 pairs);
prefix checkpoints and restores are copies of whole state pages made by
the runner's ``apply_copies``. Training (``train_loss``): ``rwkv6_chunked``
from a zero state, with autograd.

On a ``(data, model)`` mesh (``dist``) each rank runs its heads
(``rwkv6_dims(d, hs, tp)``) and its ``d_ff`` and channel-mix output
columns, and its state page holds its heads' wkv state beside the whole
token-shift states. Three reference behaviours make tp > 1 another
function than one device (ROADMAP queue 3): ``ln_x`` normalises over the
rank's heads only; the channel mix's ``cm_wv`` maps a rank's ``d_ff``
columns to its output columns alone (the one-device matrix's diagonal
blocks); and ``w_lora_a`` is one draw stored with a tp axis, whose copies
each receive only their own heads' gradient and drift apart.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.layout import page_view
from ..core.spec import KVCacheSpec, rwkv_spec
from . import attention as A
from . import blocks_seq as BS
from .common import rms_norm, set_matmul_precision
from .lm import DecodeBatch, DecoderLM, draw_normal, unstack
from .params import MATRICES, local_part
from .tp import (Dist, embed_lookup, logits_local, psum_dp, replicated_loss,
                 sharded_softmax_xent)

LORA_RANK = 32
W_BASE = 0.6


class RWKVLM(DecoderLM):
    """The ssm family. Parameters mirror the reference tree, each leaf this
    rank's slice of the expanded layout (on one device the tp dim is
    dropped and nothing is split): ``embed``, ``final_norm``, ``layers``
    ((L, ...) stacks) and ``unembed`` (untied configs).

    ``dist``: the rank's place on a ``(data, model)`` mesh (one device by
    default), on which the family trains and serves."""

    def __init__(self, cfg: ModelConfig, dist: Optional[Dist] = None):
        cfg.validate()
        if cfg.family != "ssm":
            raise ValueError(f"family {cfg.family!r} is not ssm")
        dist = dist or Dist()
        if dist.fsdp:
            raise NotImplementedError(
                "the ssm family has no FSDP: the reference shards only "
                "DecoderLM's layer stacks over the data axis")
        tp = dist.tp
        if cfg.d_ff % tp or cfg.d_model % tp:
            raise ValueError(f"d_ff {cfg.d_ff} and d_model {cfg.d_model} do "
                             f"not split over tp {tp}")
        set_matmul_precision()
        self.cfg = cfg
        self.dist = dist
        self.fsdp = False
        self.is_moe = False
        self.ri = {"kv_local": 1, "repl": 1}   # no attention heads
        self.v_local = -(-cfg.vocab_size // tp)
        self.v_pad = self.v_local * tp
        self.rd = BS.rwkv6_dims(cfg.d_model, cfg.rwkv_head_size, tp)

    # ----------------------------------------------------------- kv specs
    def kv_specs(self) -> Tuple[KVCacheSpec, ...]:
        rd = self.rd
        # fp32 state stored as bf16 pairs -> x2 units
        return (rwkv_spec("rwkv", num_layers=self.cfg.num_layers,
                          att_state_units=2 * rd["wkv_units"],
                          shift_state_units=2 * rd["shift_units"]),)

    def page_shapes(self) -> Dict[str, Tuple[int, ...]]:
        rd = self.rd
        return {"rwkv": (2 * (rd["wkv_units"] + rd["shift_units"]),)}

    # --------------------------------------------------------------- init
    def global_shapes(self) -> Dict[str, Any]:
        """Shapes of the reference template at the mesh's tp (each
        tensor-parallel leaf with its tp axis), keys in the order ``init``
        draws them."""
        cfg, rd, tp = self.cfg, self.rd, self.dist.tp
        d, L = cfg.d_model, cfg.num_layers
        dal, ffl, dl = rd["d_att_local"], cfg.d_ff // tp, d // tp
        layers = {"ln1": (L, d), "ln2": (L, d), "ln_x": (L, tp, dal)}
        for n in ("r", "k", "v", "g", "w"):
            layers["mu_" + n] = (L, d)
        for n in ("r", "k", "v", "g"):
            layers["w_" + n] = (L, tp, d, dal)
        layers.update(
            w_o=(L, tp, dal, d), w_lora_a=(L, tp, d, LORA_RANK),
            w_lora_b=(L, tp, LORA_RANK, dal), w_base=(L, tp, dal),
            u=(L, tp, rd["h_local"], cfg.rwkv_head_size), cm_mu_k=(L, d),
            cm_mu_r=(L, d), cm_wk=(L, tp, d, ffl), cm_wv=(L, tp, ffl, dl),
            cm_wr=(L, tp, d, dl))
        tree = {"embed": (tp, self.v_local, d), "final_norm": (d,),
                "layers": layers}
        if not cfg.tie_embeddings:
            tree["unembed"] = (tp, self.v_local, d)
        return tree

    def init(self, seed: int = 0, device="cuda",
             master: bool = False) -> Dict[str, Any]:
        """Random weights from ``seed`` with the reference template's
        shapes and scales (normal 0.02; the token-shift ``mu_*``, ``u``
        0.5; ``w_lora_b`` 0.01; ``w_o`` and ``cm_wv`` 0.02/sqrt(2L);
        norms ones; ``w_base`` 0.6), drawn by a ``torch.Generator`` on
        ``device`` a slice of at most DRAW_CHUNK values at a time.
        Matrices are bf16 (serving) or, with ``master``, fp32 like every
        other leaf (training's masters). The draws differ from the
        reference's ``jax.random`` ones. On a mesh every rank draws the
        one-device model's leaves and keeps its slice of each in the
        expanded layout (``_expand``): at tp 1 the one-device function; at
        tp > 1 the same but for ``ln_x`` over a rank's heads and
        ``cm_wv``'s off-diagonal blocks (the class docstring)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out_scale = 0.02 / (2 * self.cfg.num_layers) ** 0.5

        def leaf(name, shape):
            if name in ("final_norm", "ln1", "ln2", "ln_x"):
                return torch.ones(shape, dtype=torch.float32, device=dev)
            if name == "w_base":
                return torch.full(shape, W_BASE, dtype=torch.float32,
                                  device=dev)
            scale = {"w_o": out_scale, "cm_wv": out_scale, "u": 0.5,
                     "w_lora_b": 0.01}.get(
                name, 0.5 if "mu_" in name else 0.02)
            bf16 = not master and name in MATRICES
            return draw_normal(shape, scale, torch.bfloat16 if bf16 else
                               torch.float32, gen)

        def mine(name, shape, shard):
            w = leaf(name, shape)
            if self.dist.size == 1:
                return w
            # a copy: a contiguous slice would keep the whole leaf alive
            return local_part(self._expand(name, w), shard, self.dist).clone(
                memory_format=torch.contiguous_format)

        shapes = RWKVLM(self.cfg).param_shapes()
        shards = self.shards()
        params = {n: mine(n, s, shards[n]) for n, s in shapes.items()
                  if n != "layers"}
        params["layers"] = {n: mine(n, s, shards["layers"][n])
                            for n, s in shapes["layers"].items()}
        return params

    def _expand(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The one-device leaf ``w`` in the expanded layout at the mesh's
        tp: head-indexed leaves split by head, ``cm_wk`` by its ``d_ff``
        columns and ``cm_wr`` by its output columns, ``cm_wv`` cut to its
        diagonal blocks (rank m's ``d_ff`` columns to its output columns),
        ``w_lora_a`` copied to every rank (the reference's one broadcast
        draw), the vocabulary padded with zero rows and split."""
        tp = self.dist.tp
        if name in ("embed", "unembed"):
            pad = self.v_pad - w.shape[0]
            if pad:
                w = torch.cat([w, w.new_zeros(pad, w.shape[1])])
            return w.reshape(tp, self.v_local, w.shape[1])
        if self.rd["heads_pad"] != self.rd["heads"]:
            raise NotImplementedError(
                f"{self.rd['heads']} heads do not split over tp {tp}: the "
                "reference pads them with heads of their own draw")
        n = w.shape[0]
        if name == "w_lora_a":
            return w[:, None].expand(n, tp, *w.shape[1:])
        if name == "u":                             # (L, H, hs)
            return w.reshape(n, tp, -1, w.shape[-1])
        if name == "w_o":                           # (L, H*hs, d)
            return w.reshape(n, tp, -1, w.shape[-1])
        if name == "cm_wv":                         # (L, ff, d)
            ffl, dl = w.shape[1] // tp, w.shape[2] // tp
            return torch.stack([w[:, m * ffl:(m + 1) * ffl,
                                  m * dl:(m + 1) * dl] for m in range(tp)], 1)
        if name in ("ln_x", "w_r", "w_k", "w_v", "w_g", "w_lora_b", "w_base",
                    "cm_wk", "cm_wr"):              # split the last dim
            return w.reshape(*w.shape[:-1], tp, -1).movedim(-2, 1)
        return w

    # --------------------------------------------------------------- train
    def train_loss(self, params, tokens, targets):
        """Mean next-token cross-entropy of (B, T) ``tokens`` against
        ``targets`` in the reference ``_train_body``'s order: the
        embedding, each layer's time and channel mix (``rwkv6_chunked``
        from a zero state) recomputed in the backward
        (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
        of its scan body), the final RMSNorm, the head and the
        cross-entropy. On a mesh the batch is this data rank's rows and
        the loss is the mean over every data rank's."""
        cfg, dist = self.cfg, self.dist
        x = embed_lookup(tokens, params["embed"], dist)
        for pj in unstack(params["layers"]):
            x = checkpoint(self._train_layer, x, pj, use_reentrant=False)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_local(x, self._unembed(params))
        loss = sharded_softmax_xent(logits, targets, dist=dist)
        if dist.rows > 1:
            loss = psum_dp(loss, dist) / dist.rows
        return replicated_loss(loss, dist)

    def _train_layer(self, x, pj):
        cfg = self.cfg
        x, _ = BS.rwkv6_chunked(pj, x, self.rd, head_size=cfg.rwkv_head_size,
                                norm_eps=cfg.norm_eps, dist=self.dist)
        return x

    # --------------------------------------------------------------- serve
    def serve_step(self, params, buffer: torch.Tensor, batch: DecodeBatch,
                   prefill: Optional[bool] = None) -> torch.Tensor:
        """One serving step in the reference ``_serve_body``'s order: each
        layer reads its state, runs the time and channel mix, and writes
        its state back IN PLACE in ``buffer``. Returns fp32 logits, one row
        per segment (packed) or per batch row (padded). Routes: packed
        (``rwkv6_packed``), padded prefill (``rwkv6_chunked``, pad tokens
        masked by ``last_idx``) and padded T == 1 (``rwkv6_step``). On a
        ``(data, model)`` mesh the arguments and the logits are this
        rank's, as ``DecoderLM.serve_step``'s: its rows (and their state
        ids), its heads' states."""
        cfg = self.cfg
        packed = batch.seg_ids is not None
        t = batch.tokens.shape[1]
        if prefill is None:
            prefill = packed or t > 1
        x = embed_lookup(batch.tokens, params["embed"], self.dist)
        view = self._layer_views(buffer, batch.page_strides)["rwkv"]
        eids = batch.state_eids["rwkv"].reshape(-1)
        kw = dict(head_size=cfg.rwkv_head_size, norm_eps=cfg.norm_eps,
                  dist=self.dist)
        if packed:
            kw.update(seg_ids=batch.seg_ids[0],
                      seg_start=batch.seg_start_tok[0],
                      seg_last=batch.seg_last_tok)
        elif prefill:
            lidx = batch.last_idx
            kw.update(last_idx=lidx, length_mask=None if lidx is None else
                      torch.arange(t, device=x.device)[None]
                      <= lidx[:, None])
        for layer, pj in enumerate(unstack(params["layers"])):
            s0 = A.read_state(page_view(buffer, view), layer, eids)
            if packed:
                x, s1 = BS.rwkv6_packed(pj, x, self.rd, init_state=s0, **kw)
            elif prefill:
                x, s1 = BS.rwkv6_chunked(pj, x, self.rd, init_state=s0,
                                         **kw)
            else:
                x, s1 = BS.rwkv6_step(pj, x, s0, self.rd, **kw)
            A.write_state(buffer, view, layer, eids, s1)
        return self._head(params, x, batch)
