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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.spec import KVCacheSpec, rwkv_spec
from . import attention as A
from . import blocks_seq as BS
from .common import rms_norm, set_matmul_precision
from .lm import DecodeBatch, DecoderLM, draw_normal, unstack
from .params import MATRICES
from .tp import embed_lookup, logits_local, sharded_softmax_xent

LORA_RANK = 32
W_BASE = 0.6


class RWKVLM(DecoderLM):
    """The ssm family on one device. Parameters mirror the reference tree
    with the tp dim dropped: ``embed``, ``final_norm``, ``layers`` ((L,
    ...) stacks) and ``unembed`` (untied configs)."""

    def __init__(self, cfg: ModelConfig):
        cfg.validate()
        if cfg.family != "ssm":
            raise ValueError(f"family {cfg.family!r} is not ssm")
        set_matmul_precision()
        self.cfg = cfg
        self.is_moe = False
        self.v_pad = cfg.vocab_size
        self.rd = BS.rwkv6_dims(cfg.d_model, cfg.rwkv_head_size)

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
    def param_shapes(self) -> Dict[str, Any]:
        """Shapes of the reference template with the tp dim dropped."""
        cfg, rd = self.cfg, self.rd
        d, L, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
        dal = rd["d_att_local"]
        layers = {"ln1": (L, d), "ln2": (L, d), "ln_x": (L, dal)}
        for n in ("r", "k", "v", "g", "w"):
            layers["mu_" + n] = (L, d)
        for n in ("r", "k", "v", "g"):
            layers["w_" + n] = (L, d, dal)
        layers.update(
            w_o=(L, dal, d), w_lora_a=(L, d, LORA_RANK),
            w_lora_b=(L, LORA_RANK, dal), w_base=(L, dal),
            u=(L, rd["h_local"], cfg.rwkv_head_size), cm_mu_k=(L, d),
            cm_mu_r=(L, d), cm_wk=(L, d, ff), cm_wv=(L, ff, d),
            cm_wr=(L, d, d))
        tree = {"embed": (self.v_pad, d), "final_norm": (d,),
                "layers": layers}
        if not cfg.tie_embeddings:
            tree["unembed"] = (self.v_pad, d)
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
        reference's ``jax.random`` ones."""
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

        shapes = self.param_shapes()
        params = {n: leaf(n, s) for n, s in shapes.items() if n != "layers"}
        params["layers"] = {n: leaf(n, s)
                            for n, s in shapes["layers"].items()}
        return params

    # --------------------------------------------------------------- train
    def train_loss(self, params, tokens, targets):
        """Mean next-token cross-entropy of (B, T) ``tokens`` against
        ``targets`` in the reference ``_train_body``'s order: the
        embedding, each layer's time and channel mix (``rwkv6_chunked``
        from a zero state) recomputed in the backward
        (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
        of its scan body), the final RMSNorm, the head and the
        cross-entropy."""
        cfg = self.cfg
        x = embed_lookup(tokens, params["embed"])
        for pj in unstack(params["layers"]):
            x = checkpoint(self._train_layer, x, pj, use_reentrant=False)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_local(x, self._unembed(params))
        return sharded_softmax_xent(logits, targets)

    def _train_layer(self, x, pj):
        cfg = self.cfg
        x, _ = BS.rwkv6_chunked(pj, x, self.rd, head_size=cfg.rwkv_head_size,
                                norm_eps=cfg.norm_eps)
        return x

    # --------------------------------------------------------------- serve
    def serve_step(self, params, buffer: torch.Tensor, batch: DecodeBatch,
                   prefill: Optional[bool] = None) -> torch.Tensor:
        """One serving step in the reference ``_serve_body``'s order: each
        layer reads its state, runs the time and channel mix, and writes
        its state back IN PLACE in ``buffer``. Returns fp32 logits, one row
        per segment (packed) or per batch row (padded). Routes: packed
        (``rwkv6_packed``), padded prefill (``rwkv6_chunked``, pad tokens
        masked by ``last_idx``) and padded T == 1 (``rwkv6_step``)."""
        cfg = self.cfg
        packed = batch.seg_ids is not None
        t = batch.tokens.shape[1]
        if prefill is None:
            prefill = packed or t > 1
        x = embed_lookup(batch.tokens, params["embed"])
        view = self._layer_views(buffer)["rwkv"]
        eids = batch.state_eids["rwkv"].reshape(-1)
        kw = dict(head_size=cfg.rwkv_head_size, norm_eps=cfg.norm_eps)
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
            s0 = A.read_state(buffer.view(view), layer, eids)
            if packed:
                x, s1 = BS.rwkv6_packed(pj, x, self.rd, init_state=s0, **kw)
            elif prefill:
                x, s1 = BS.rwkv6_chunked(pj, x, self.rd, init_state=s0,
                                         **kw)
            else:
                x, s1 = BS.rwkv6_step(pj, x, s0, self.rd, **kw)
            A.write_state(buffer, view, layer, eids, s1)
        return self._head(params, x, batch)
