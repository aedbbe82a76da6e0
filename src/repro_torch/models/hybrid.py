"""Zamba2-style hybrid (``repro/models/hybrid.py``): a Mamba2 backbone with
one *shared* attention block (and its MLP) applied after every
``attn_every`` Mamba2 blocks. KV types: one Mamba state spec covering all
Mamba2 layers, and one full-attention spec with a cache layer per
shared-block invocation.

Serving: packed steps run the Mamba2 scans through the chunk-scan kernel
(``blocks_seq.mamba2_packed``) and the shared attention through the varlen
kernel; padded T > 1 steps through the chunk-scan kernel
(``mamba2_chunked``) and plain-torch attention; padded T == 1 steps through
``mamba2_step`` (plain torch) and the paged decode kernel. Training
(``train_loss``): the scans through the chunk-scan kernel and its backward
kernel, the shared attention through the dense flash kernels, on one
device or on a ``(data, model)`` mesh at each rank's heads. Serving on
such a mesh runs the same blocks at the rank's Mamba2 heads (the gated
norm over them, the out-projection summed over the model axis) and the
shared attention as ``DecoderLM.serve_step`` does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.layout import page_view
from ..core.spec import KVCacheSpec, attention_spec, mamba_spec
from . import attention as A
from . import blocks_attn as BA
from . import blocks_seq as BS
from .common import rms_norm, set_matmul_precision
from .lm import DecodeBatch, DecoderLM, unstack
from .params import MATRICES, local_part
from .rotary import rope_tables
from .tp import (Dist, embed_lookup, logits_local, psum_dp, replica_info,
                 replicated_loss, sharded_softmax_xent)


class HybridLM(DecoderLM):
    """Hybrid family. Parameters mirror the reference tree, each leaf this
    rank's slice of the expanded layout (on one device the tp dim is
    dropped and nothing is split): ``embed``, ``final_norm``,
    ``mamba_main`` ((n_super * attn_every, ...) stacks), ``mamba_tail``
    (when ``num_layers % attn_every``), ``shared_attn`` (unstacked) and
    ``unembed`` (untied configs).

    ``dist``: the rank's place on a ``(data, model)`` mesh (one device by
    default), on which the family trains: each rank runs its
    ``heads / tp`` Mamba2 heads (``w_z``, ``w_x``, ``w_dt``, ``dt_bias``,
    ``A_log``, ``D``, ``out_norm``, ``w_out`` and the x columns of
    ``conv_w`` split by head; ``w_B``, ``w_C`` and the B / C columns of
    ``conv_w`` a copy each, which the reference stores with a tp axis so
    that each rank's copy gets only its own heads' gradient) and its share
    of the shared attention and MLP, like the dense family's. The
    reference shards no hybrid leaf over the data axis (its FSDP rule is
    ``DecoderLM.template``'s), so ``fsdp`` is refused. It serves on the
    same mesh (``serve_step``)."""

    def __init__(self, cfg: ModelConfig, dist: Optional[Dist] = None):
        cfg.validate()
        if cfg.family != "hybrid":
            raise ValueError(f"family {cfg.family!r} is not hybrid")
        assert cfg.attn_every > 0
        dist = dist or Dist()
        if dist.fsdp:
            raise NotImplementedError(
                "the hybrid family has no FSDP: the reference shards only "
                "DecoderLM's layer stacks over the data axis")
        set_matmul_precision()
        self.cfg = cfg
        self.dist = dist
        self.fsdp = False
        self.is_moe = False
        self.ri = replica_info(cfg.num_heads, cfg.num_kv_heads, dist.tp)
        self.kv_local = self.ri["kv_local"]
        self.v_local = -(-cfg.vocab_size // dist.tp)
        self.v_pad = self.v_local * dist.tp
        self.n_super = cfg.num_layers // cfg.attn_every
        self.n_tail = cfg.num_layers % cfg.attn_every
        self.md = BS.mamba2_dims(cfg.d_model, cfg.mamba_expand,
                                 cfg.mamba_headdim, cfg.mamba_d_state,
                                 cfg.mamba_conv_width, dist.tp)

    # ----------------------------------------------------------- kv specs
    def kv_specs(self) -> Tuple[KVCacheSpec, ...]:
        cfg, md = self.cfg, self.md
        return (
            attention_spec(
                "full_attn", num_layers=self.n_super,
                kv_heads=self.kv_local, head_dim=cfg.head_dim,
                tokens_per_page=cfg.tokens_per_page),
            # fp32 state stored as bf16 pairs -> x2 units
            mamba_spec("mamba", num_layers=cfg.num_layers,
                       conv_units=2 * md["conv_units"],
                       ssm_units=2 * md["ssm_units"]),
        )

    def page_shapes(self) -> Dict[str, Tuple[int, ...]]:
        cfg, md = self.cfg, self.md
        return {
            "full_attn": (2, cfg.tokens_per_page, self.kv_local,
                          cfg.head_dim),
            "mamba": (2 * (md["ssm_units"] + md["conv_units"]),),
        }

    # --------------------------------------------------------------- init
    def _mamba_shapes(self, n: int) -> Dict[str, Tuple[int, ...]]:
        cfg, md, tp = self.cfg, self.md, self.dist.tp
        d, dil, hl = cfg.d_model, md["d_in_local"], md["h_local"]
        ns, w = cfg.mamba_d_state, cfg.mamba_conv_width
        return {"norm": (n, d), "w_z": (n, tp, d, dil),
                "w_x": (n, tp, d, dil), "w_B": (n, tp, d, ns),
                "w_C": (n, tp, d, ns), "w_dt": (n, tp, d, hl),
                "dt_bias": (n, tp, hl), "A_log": (n, tp, hl),
                "D": (n, tp, hl), "conv_w": (n, tp, w, dil + 2 * ns),
                "out_norm": (n, tp, dil), "w_out": (n, tp, dil, d)}

    def global_shapes(self) -> Dict[str, Any]:
        """Shapes of the reference template at the mesh's tp (each
        tensor-parallel leaf with its tp axis), keys in the order ``init``
        draws them."""
        cfg, tp, ri = self.cfg, self.dist.tp, self.ri
        d, hd = cfg.d_model, cfg.head_dim
        qd, kvd = ri["q_local"] * hd, ri["kv_local"] * hd
        ffl = cfg.d_ff // tp
        tree = {
            "embed": (tp, self.v_local, d), "final_norm": (d,),
            "mamba_main": self._mamba_shapes(self.n_super * cfg.attn_every),
            "shared_attn": {"attn_norm": (d,), "q": (tp, d, qd),
                            "k": (tp, d, kvd), "v": (tp, d, kvd),
                            "o": (tp, qd, d), "mlp_norm": (d,),
                            "gate": (tp, d, ffl), "up": (tp, d, ffl),
                            "down": (tp, ffl, d)},
        }
        if self.n_tail:
            tree["mamba_tail"] = self._mamba_shapes(self.n_tail)
        if not cfg.tie_embeddings:
            tree["unembed"] = (tp, self.v_local, d)
        return tree

    def init(self, seed: int = 0, device="cuda",
             master: bool = False) -> Dict[str, Any]:
        """Random weights from ``seed`` with the reference template's
        shapes and scales (normal 0.02; ``conv_w`` 0.2; ``w_out``
        0.02/sqrt(2L); norms and ``D`` ones; ``dt_bias`` and ``A_log``
        zeros), drawn by a ``torch.Generator`` on ``device``. Matrices are
        bf16 (serving) or, with ``master``, fp32 like every other leaf
        (training's masters, the reference's ``PARAM_DTYPE``); ``conv_w``
        and the vectors are fp32. The draws differ from the reference's
        ``jax.random`` ones. On a mesh every rank draws the one-device
        model's leaves and keeps its slice of each in the expanded layout
        (``_expand_leaf``): at tp 1 the one-device function; at tp > 1 the
        same but for the per-rank ``out_norm``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out_scale = 0.02 / (2 * self.cfg.num_layers) ** 0.5
        shards = self.shards()

        def leaf(name, shape):
            if name.endswith("norm") or name == "D":
                return torch.ones(shape, dtype=torch.float32, device=dev)
            if name in ("dt_bias", "A_log"):
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            scale = {"conv_w": 0.2, "w_out": out_scale}.get(name, 0.02)
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale
            return w.to(torch.bfloat16) if name in MATRICES and \
                not master else w

        def mine(name, parent, shape, shard):
            w = leaf(name, shape)
            if self.dist.size == 1:
                return w
            w = self._expand_leaf(name, parent, w)
            # a copy: a contiguous slice would keep the whole one-device
            # leaf alive (a vocabulary table, tp times this rank's part)
            return local_part(w, shard, self.dist).clone(
                memory_format=torch.contiguous_format)

        return {name: ({n: mine(n, name, s, shards[name][n])
                        for n, s in shape.items()}
                       if isinstance(shape, dict)
                       else mine(name, "", shape, shards[name]))
                for name, shape in HybridLM(self.cfg).param_shapes().items()}

    def _expand_leaf(self, name: str, parent: str,
                     w: torch.Tensor) -> torch.Tensor:
        """The one-device leaf ``w`` under ``parent`` in the expanded
        layout at the mesh's tp: a Mamba2 stack's head-indexed leaves
        split by head (conv_w's x columns too), ``w_B``, ``w_C`` and
        conv_w's B / C columns copied to every rank; the shared block's
        and the vocabulary's leaves as ``DecoderLM._expand`` lays out the
        dense family's."""
        tp = self.dist.tp
        if parent == "shared_attn":
            return w if w.dim() == 1 else self._expand(name, w[None])[0]
        if parent not in ("mamba_main", "mamba_tail"):
            return self._expand(name, w)
        n = w.shape[0]
        if name == "norm":
            return w
        if name in ("w_B", "w_C"):
            return w[:, None].expand(n, tp, *w.shape[1:])
        if name == "conv_w":
            dil_all = self.md["d_in_local"] * tp
            xs = w[..., :dil_all].reshape(n, w.shape[1], tp, -1)
            bc = w[:, None, :, dil_all:].expand(n, tp, *w.shape[1:2], -1)
            return torch.cat([xs.movedim(2, 1), bc], dim=-1)
        if name == "w_out":                        # (n, H*P, d)
            return w.reshape(n, tp, -1, w.shape[-1])
        # w_z, w_x, w_dt (n, d, heads...) and the (n, heads...) vectors
        return w.reshape(*w.shape[:-1], tp, -1).movedim(-2, 1)

    # --------------------------------------------------------------- train
    def train_loss(self, params, tokens, targets, *, mm_embeds=None,
                   mm_mask=None, mrope_pos=None):
        """Mean next-token cross-entropy of (B, T) ``tokens`` against
        ``targets`` (the reference's ``_train_body``): per super-block,
        ``attn_every`` Mamba2 layers (``mamba2_chunked(..., train=True)``)
        and then the shared attention block (``attn_train``: the dense
        flash kernels) and its MLP, each super-block recomputed in the
        backward (``torch.utils.checkpoint``), as the reference
        checkpoints its scan body; then the tail Mamba2 layers, each
        recomputed on its own. The hybrid takes no multimodal inputs.
        On a mesh, ``tokens`` and ``targets`` are this data rank's rows
        and the loss is the mean over every data rank's."""
        if mm_embeds is not None or mm_mask is not None or \
                mrope_pos is not None:
            raise ValueError("the hybrid family takes no multimodal inputs")
        cfg, dist = self.cfg, self.dist
        t = tokens.shape[1]
        x = embed_lookup(tokens, params["embed"], dist)
        rope = rope_tables(torch.arange(t, dtype=torch.int32,
                                        device=tokens.device),
                           cfg.head_dim, cfg.rope_theta)
        main = unstack(params["mamba_main"])
        ae = cfg.attn_every
        for cyc in range(self.n_super):
            x = checkpoint(self._train_super, x, rope,
                           main[cyc * ae:(cyc + 1) * ae],
                           params["shared_attn"], use_reentrant=False)
        if self.n_tail:
            for pj in unstack(params["mamba_tail"]):
                x = checkpoint(self._train_mamba, x, pj, use_reentrant=False)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = logits_local(x, self._unembed(params))
        loss = sharded_softmax_xent(logits, targets, dist=dist)
        if dist.rows > 1:
            loss = psum_dp(loss, dist) / dist.rows
        return replicated_loss(loss, dist)

    def _train_mamba(self, x, pj):
        cfg = self.cfg
        x, _ = BS.mamba2_chunked(
            pj, x, self.md, d_state=cfg.mamba_d_state,
            headdim=cfg.mamba_headdim, conv_width=cfg.mamba_conv_width,
            norm_eps=cfg.norm_eps, train=True, dist=self.dist)
        return x

    def _train_super(self, x, rope, pjs, shared):
        """One super-block: its Mamba2 layers, then the shared attention
        block and MLP."""
        cfg = self.cfg
        for pj in pjs:
            x = self._train_mamba(x, pj)
        x = BA.attn_train(shared, x, kv_local=self.kv_local,
                          head_dim=cfg.head_dim, rope=rope,
                          norm_eps=cfg.norm_eps, dist=self.dist)
        return BA.mlp_block(shared, x, cfg.norm_eps, dist=self.dist)

    # --------------------------------------------------------------- serve
    def serve_step(self, params, buffer: torch.Tensor, batch: DecodeBatch,
                   prefill: Optional[bool] = None) -> torch.Tensor:
        """One serving step in the reference ``_serve_body``'s order: per
        super-block, the shared attention's pages are gathered first, then
        ``attn_every`` Mamba2 layers each read their state and write it
        back, then the shared attention block and MLP, then its K/V write;
        the tail Mamba2 layers come last. Writes K/V and state into
        ``buffer`` IN PLACE and returns fp32 logits, one row per segment
        (packed) or per batch row (padded).

        On a ``(data, model)`` mesh the arguments and the logits are this
        rank's, as ``DecoderLM.serve_step``'s: each Mamba2 layer runs on
        the rank's heads and their state (its ``state_eids`` rows), the
        shared attention on its heads and pages."""
        self._check_mesh()
        dist = self.dist
        cfg = self.cfg
        packed = batch.seg_ids is not None
        positions = batch.positions
        if prefill is None:
            prefill = packed or positions.shape[1] > 1
        x = embed_lookup(batch.tokens, params["embed"], dist)
        views = self._layer_views(buffer, batch.page_strides)
        aview, mview = views["full_attn"], views["mamba"]
        if packed:
            rope, step = self._packed_invariants(batch, views)
            seg = dict(seg_ids=batch.seg_ids[0],
                       seg_start=batch.seg_start_tok[0],
                       seg_last=batch.seg_last_tok)
            seg["meta"] = BS.packed_meta(**seg,
                                         conv_width=cfg.mamba_conv_width)
        else:
            rope, step = self._padded_invariants(batch, views, prefill)
            lidx = batch.last_idx
            lmask = None if lidx is None else torch.arange(
                positions.shape[1], device=lidx.device)[None] <= lidx[:, None]
        st = step["full_attn"]
        eids = batch.state_eids["mamba"].reshape(-1)
        mkw = dict(d_state=cfg.mamba_d_state, headdim=cfg.mamba_headdim,
                   conv_width=cfg.mamba_conv_width, norm_eps=cfg.norm_eps,
                   dist=dist)
        akw = dict(rope=rope, kv_local=self.kv_local, head_dim=cfg.head_dim,
                   norm_eps=cfg.norm_eps, dist=dist)

        def run_mamba(pj, x, layer):
            s0 = A.read_state(page_view(buffer, mview), layer, eids)
            if packed:
                x, s1 = BS.mamba2_packed(pj, x, self.md, init_state=s0,
                                         **seg, **mkw)
            elif prefill:
                x, s1 = BS.mamba2_chunked(pj, x, self.md, init_state=s0,
                                          length_mask=lmask, last_idx=lidx,
                                          **mkw)
            else:
                x, s1 = BS.mamba2_step(pj, x, s0, self.md, **mkw)
            A.write_state(buffer, mview, layer, eids, s1)
            return x

        main = unstack(params["mamba_main"])
        shared = params["shared_attn"]
        ae = cfg.attn_every
        for cyc in range(self.n_super):
            if prefill:
                gathered = BA.attn_gather(buffer, aview, st["tables"], cyc,
                                          st["index"])
            for j in range(ae):
                x = run_mamba(main[cyc * ae + j], x, cyc * ae + j)
            k = None
            if packed:
                x, k, v = BA.attn_compute(shared, x, *gathered,
                                          meta=st["meta"], **akw)
            elif prefill:
                x, k, v = BA.attn_compute_padded(shared, x, *gathered,
                                                 meta=st["meta"], **akw)
            else:
                x = BA.attn_decode(shared, x, buffer, aview, cyc,
                                   rows=st["rows"], tables=st["tables"],
                                   page_pos=st["page_pos"], qpos=st["qpos"],
                                   plan=st["plan"], **akw)
            x = BA.mlp_block(shared, x, cfg.norm_eps, dist=dist)
            if k is not None:
                A.write_kv_rows(buffer, aview, cyc, st["rows"], k, v)
        if self.n_tail:
            base = self.n_super * ae
            for i, pj in enumerate(unstack(params["mamba_tail"])):
                x = run_mamba(pj, x, base + i)
        return self._head(params, x, batch)
