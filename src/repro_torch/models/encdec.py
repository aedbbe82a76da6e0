"""Whisper-style encoder-decoder backbone (``repro/models/encdec.py``), the
audio family, on one device or on a ``(data, model)`` mesh.

The conv frontend is a stub, as in the reference: the runner supplies
precomputed frame embeddings (rows, encoder_seq, d). The transformer is
real: LayerNorm, GELU (tanh) MLP and MHA, sinusoidal encoder positions,
learned decoder positions (no RoPE), causal decoder self-attention over
"full_attn" pages and cross attention over "cross_attn" pages, which the
encoder writes once at a request's first chunk and every later step only
reads (the Llama-3.2-Vision pattern of Jenga §3.2).

Kernels: the encoder's self attention runs through the dense flash forward
kernel (non-causal over every frame; the reference attends zero-filled
frames too, and zero pad keys up to a multiple of 512, ``ENC_KV_BLOCK``;
``enc_lens`` masks only the cross attention). Training (``train_loss``)
runs all three attentions through the dense flash kernels, forward and
backward: the encoder's and the cross attention (non-causal, K/V
zero-padded as above, the pads weighed as the reference weighs them)
and the decoder's causal self attention (S = T). Packed steps run
both decoder attentions through the varlen kernel (self: old pages ++ the
fresh chunk; cross: the cross slots with ``q_pos := enc_lens - 1``).
Padded T == 1 self attention reads its pages in place through the paged
decode kernel, padded T > 1 self attention and padded cross attention run
in plain torch (the reference's jnp routes; no TPU kernel stands behind
padded cross attention).

On a mesh (``dist``) each rank holds its slice of the reference's
expanded parameters (``models.params``: the heads of ``replica_info``,
padded per ``gqa_tp_layout``, its ``d_ff`` columns and vocabulary rows);
the o-projection and the MLP's down product are summed over the model
axis and their biases added after the sum, as the reference adds them.
Training takes the rank's rows of the batch (the loss's mean over the
data axis); the reference has no FSDP here. Serving: the encoder runs on
every rank with its heads; the decoder's self attention over a sequence's
pages split over a K/V replica set (``repl`` > 1) combines its members'
partials over that set and merges the fresh chunk after, as
``blocks_attn`` does for the decoder family; cross attention never
combines: every rank holds its rows' cross pages whole (the reference's
``cross_attn`` tables are unsplit) and every member of a replica set
writes the same cross K/V. Under ``sp`` the reference's enc-dec combines
over the replica set only, not over "data" (``EncDecLM._serve_body``), so
each data rank attends only the self pages it holds: the port copies
that (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core.spec import KVCacheSpec, attention_spec, cross_attention_spec
from ..kernels.flash_attention import dense_flash_attention, dense_flash_fwd
from . import attention as A
from . import blocks_attn as BA
from .common import dense, layer_norm, set_matmul_precision
from .lm import DecodeBatch, DecoderLM, draw_normal, unstack
from .params import MATRICES, local_part
from .rotary import sinusoidal_positions
from .tp import (Dist, embed_lookup, logits_local, psum_dp, psum_tp,
                 replica_info, replicated_loss, sharded_softmax_xent)

MAX_DEC_POS = 32768 + 8
# The reference's encoder attention (``flash_attention_partials``, block
# 512) pads K/V with zeros to a multiple of its block and, non-causal with
# no ``kv_len``, leaves those slots unmasked: each softmax row also weighs
# -t % 512 zero keys (score 0, value 0). The port gives the kernel the
# same zero-padded K/V, so it computes the same function.
ENC_KV_BLOCK = 512


def _mlp(p, x, eps, dist=None):
    """LayerNorm, the GELU MLP (``jax.nn.gelu``'s tanh form, in fp32) and
    the residual, the down product summed over the model axis of
    ``dist`` and the bias added in bf16 after it as the reference does."""
    xn = layer_norm(x, p["ln_w"], p["ln_b"], eps)
    h = dense(xn, p["w1"], p["b1"])
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = psum_tp(dense(h, p["w2"]), dist)
    return x + y + p["b2"].to(y.dtype)


def _heads(a, hd):
    """(B, T, heads*hd) -> the dense kernel's (B*heads, T, hd), contiguous."""
    b, t, _ = a.shape
    return a.view(b, t, -1, hd).transpose(1, 2).contiguous().view(-1, t, hd)


class EncDecLM(DecoderLM):
    """The encdec family. Parameters mirror the reference tree, each leaf
    this rank's slice of the expanded layout (on one device the tp dim is
    dropped and nothing is split): ``embed`` (tied), ``dec_pos``, ``enc``
    ({``attn``, ``mlp``} stacks of ``encoder_layers``),
    ``enc_ln_post_w/_b``, ``dec_self``, ``dec_cross``, ``dec_mlp``
    (stacks of ``num_layers``) and ``final_ln_w/_b``.

    ``dist``: the rank's place on a ``(data, model)`` mesh (one device by
    default), on which the family trains and serves."""

    def __init__(self, cfg: ModelConfig, dist: Optional[Dist] = None):
        cfg.validate()
        if cfg.family != "encdec":
            raise ValueError(f"family {cfg.family!r} is not encdec")
        dist = dist or Dist()
        if dist.fsdp:
            raise NotImplementedError(
                "the enc-dec family has no FSDP: the reference shards only "
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
        self.max_dec_pos = MAX_DEC_POS
        # the self attention's partials combine over the K/V replica set
        # only: the reference's enc-dec never combines over "data"
        self._attn_dist = dataclasses.replace(dist, sp=False)

    # ----------------------------------------------------------- kv specs
    def kv_specs(self) -> Tuple[KVCacheSpec, ...]:
        cfg = self.cfg
        kw = dict(num_layers=cfg.num_layers, kv_heads=self.kv_local,
                  head_dim=cfg.head_dim, tokens_per_page=cfg.tokens_per_page)
        return (attention_spec("full_attn", **kw),
                cross_attention_spec("cross_attn", **kw))

    def page_shapes(self) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        shp = (2, cfg.tokens_per_page, self.kv_local, cfg.head_dim)
        return {"full_attn": shp, "cross_attn": shp}

    # --------------------------------------------------------------- init
    def _attn_shapes(self, n):
        cfg, tp, ri = self.cfg, self.dist.tp, self.ri
        d = cfg.d_model
        qd, kvd = ri["q_local"] * cfg.head_dim, ri["kv_local"] * cfg.head_dim
        return {"ln_w": (n, d), "ln_b": (n, d), "q": (n, tp, d, qd),
                "q_bias": (n, tp, qd), "o": (n, tp, qd, d), "o_bias": (n, d),
                "k": (n, tp, d, kvd), "v": (n, tp, d, kvd),
                "v_bias": (n, tp, kvd)}

    def _mlp_shapes(self, n):
        d, tp = self.cfg.d_model, self.dist.tp
        ffl = self.cfg.d_ff // tp
        return {"ln_w": (n, d), "ln_b": (n, d), "w1": (n, tp, d, ffl),
                "b1": (n, tp, ffl), "w2": (n, tp, ffl, d), "b2": (n, d)}

    def global_shapes(self) -> Dict[str, Any]:
        """Shapes of the reference template at the mesh's tp (each
        tensor-parallel leaf with its tp axis), keys in the order ``init``
        draws them."""
        cfg = self.cfg
        d, le, ld = cfg.d_model, cfg.encoder_layers, cfg.num_layers
        return {
            "embed": (self.dist.tp, self.v_local, d),
            "dec_pos": (self.max_dec_pos, d),
            "enc": {"attn": self._attn_shapes(le),
                    "mlp": self._mlp_shapes(le)},
            "enc_ln_post_w": (d,), "enc_ln_post_b": (d,),
            "dec_self": self._attn_shapes(ld),
            "dec_cross": self._attn_shapes(ld),
            "dec_mlp": self._mlp_shapes(ld),
            "final_ln_w": (d,), "final_ln_b": (d,),
        }

    def init(self, seed: int = 0, device="cuda",
             master: bool = False) -> Dict[str, Any]:
        """Random weights from ``seed`` with the reference template's
        shapes and scales (normal 0.02; ``dec_pos`` 0.01; ``w2``
        0.02/sqrt(2L); layer-norm weights ones, biases zeros), drawn by a
        ``torch.Generator`` on ``device``. Matrices (and ``dec_pos``) are
        bf16 (serving) or, with ``master``, fp32 like every other leaf
        (training's masters). The draws differ from the reference's
        ``jax.random`` ones. On a mesh every rank draws the one-device
        model's leaves and keeps its slice of each in the expanded layout
        (``_expand``): the one-device function at any tp, but where K/V
        replicas combine (the reference's replica combine, ROADMAP queue
        3)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out_scale = 0.02 / (2 * self.cfg.num_layers) ** 0.5

        def leaf(name, shape):
            if name.endswith("_w") and "ln" in name:
                return torch.ones(shape, dtype=torch.float32, device=dev)
            if name.endswith(("_b", "bias")) or name in ("b1", "b2"):
                return torch.zeros(shape, dtype=torch.float32, device=dev)
            scale = {"w2": out_scale, "dec_pos": 0.01}.get(name, 0.02)
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

        def tree(shapes, shards):
            return {n: (tree(s, shards[n]) if isinstance(s, dict)
                        else mine(n, s, shards[n]))
                    for n, s in shapes.items()}

        return tree(EncDecLM(self.cfg).param_shapes(), self.shards())

    def _expand(self, name: str, w: torch.Tensor) -> torch.Tensor:
        """The one-device leaf ``w`` in the expanded layout at the mesh's
        tp: the attention's heads and the vocabulary as
        ``DecoderLM._expand`` lays out the decoder's, the MLP's ``d_ff``
        columns (``w1``, ``b1``) and ``w2`` rows split over the ranks."""
        if name in ("w1", "w2"):
            return super()._expand("up" if name == "w1" else "down", w)
        if name == "b1":
            return w.reshape(w.shape[0], self.dist.tp, -1)
        return super()._expand(name, w)

    # --------------------------------------------------------------- train
    def train_loss(self, params, tokens, targets, *, enc_embeds=None):
        """Mean next-token cross-entropy of (B, T) decoder ``tokens``
        against ``targets`` over (B, S, d) stub frame embeddings
        ``enc_embeds`` (the reference's ``_train_body_ed``): the encoder,
        each layer recomputed in the backward (``torch.utils.checkpoint``,
        the reference's ``jax.checkpoint`` of its scan body); the decoder's
        embedding plus ``dec_pos[:T]`` rounded to bf16; each decoder layer
        (causal self attention, cross attention over the encoder output,
        the MLP) recomputed as one; the final LayerNorm and the tied head.
        The cross attention weighs the encoder's zero pad keys as the
        reference does (serving masks them through ``enc_lens``). On a
        mesh the batch is this data rank's rows and the loss is the mean
        over every data rank's, the same on every rank."""
        if enc_embeds is None:
            raise ValueError("enc-dec training needs enc_embeds")
        eps = self.cfg.norm_eps
        enc_out = self._encode(params, enc_embeds, train=True)
        dist = self.dist
        t = tokens.shape[1]
        x = embed_lookup(tokens, params["embed"], dist)
        x = x + params["dec_pos"][:t].to(x.dtype)[None]
        for pj in zip(unstack(params["dec_self"]),
                      unstack(params["dec_cross"]),
                      unstack(params["dec_mlp"])):
            x = checkpoint(self._dec_layer, x, enc_out, *pj,
                           use_reentrant=False)
        x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], eps)
        logits = logits_local(x, params["embed"])
        loss = sharded_softmax_xent(logits, targets, dist=dist)
        if dist.rows > 1:
            loss = psum_dp(loss, dist) / dist.rows
        return replicated_loss(loss, dist)

    def _dec_layer(self, x, enc_out, ps, pc, pm):
        x = self._mha(ps, x, causal=True, train=True)
        x = self._mha(pc, x, enc_out, train=True)
        return _mlp(pm, x, self.cfg.norm_eps, self.dist)

    # ------------------------------------------------------------- encoder
    def _mha(self, p, x, kv_src=None, *, causal=False, train=False):
        """The reference's plain MHA (``EncDecLM._mha``): LayerNorm, biased
        q and v (k has no bias) with k and v from ``kv_src`` (or the
        normed ``x``), one dense flash call, the o projection and its
        bias, the residual. Non-causal calls zero-pad K/V to a multiple
        of ENC_KV_BLOCK and attend the pads, as the reference does;
        causal ones run at S = T (causality masks the pads). Serving runs
        the forward kernel alone, ``train`` the autograd route (forward
        and backward kernels). On a mesh: the rank's heads, the o
        projection summed over the model axis before its bias."""
        hd = self.cfg.head_dim
        b, t, _ = x.shape
        xn = layer_norm(x, p["ln_w"], p["ln_b"], self.cfg.norm_eps)
        kv_n = xn if kv_src is None else kv_src
        q = _heads(dense(xn, p["q"], p["q_bias"]), hd)
        k = _heads(dense(kv_n, p["k"]), hd)
        v = _heads(dense(kv_n, p["v"], p["v_bias"]), hd)
        pad = 0 if causal else -k.shape[1] % ENC_KV_BLOCK
        if pad:
            k, v = (F.pad(a, (0, 0, 0, pad)) for a in (k, v))
        if train:
            out = dense_flash_attention(q, k, v, causal=causal)
        else:
            out, _ = dense_flash_fwd(q, k, v, causal=causal)
        out = out.view(b, -1, t, hd).transpose(1, 2).reshape(b, t, -1)
        y = psum_tp(dense(out, p["o"]), self.dist)
        return x + y + p["o_bias"].to(y.dtype)

    def _enc_layer(self, x, pa, pm, train):
        return _mlp(pm, self._mha(pa, x, train=train), self.cfg.norm_eps,
                    self.dist)

    def _encode(self, params, enc_embeds, train=False):
        """Stub frame embeddings (rows, S, d) -> encoder output (rows, S, d)
        bf16: sinusoidal positions, the encoder layers (``train``: each
        recomputed in the backward), the post LayerNorm."""
        eps = self.cfg.norm_eps
        x = enc_embeds.to(torch.bfloat16)
        s, d = x.shape[1:]
        x = x + sinusoidal_positions(s, d, x.device).to(x.dtype)[None]
        enc = params["enc"]
        for pa, pm in zip(unstack(enc["attn"]), unstack(enc["mlp"])):
            if train:
                x = checkpoint(self._enc_layer, x, pa, pm, True,
                               use_reentrant=False)
            else:
                x = self._enc_layer(x, pa, pm, False)
        return layer_norm(x, params["enc_ln_post_w"],
                          params["enc_ln_post_b"], eps)

    def _write_cross(self, params, buffer, cview, batch):
        """Run the encoder and write every decoder layer's cross K/V (k
        unbiased, v with ``v_bias``) to slot ``j % tpp`` of the page of
        encoder position j; eids < 0 go to the scratch page."""
        hd = self.cfg.head_dim
        enc_out = self._encode(params, batch.enc_embeds)
        b, s, _ = enc_out.shape
        slots = (torch.arange(s, device=enc_out.device) % cview[3]).expand(
            b, s)
        rows = A.kv_rows(cview, batch.enc_write_eids.reshape(b, s), slots)
        for layer, pc in enumerate(unstack(params["dec_cross"])):
            k = dense(enc_out, pc["k"]).view(b, s, self.kv_local, hd)
            v = dense(enc_out, pc["v"], pc["v_bias"]).view(
                b, s, self.kv_local, hd)
            A.write_kv_rows(buffer, cview, layer, rows, k, v)

    # --------------------------------------------------------------- serve
    def _rope(self, batch: DecodeBatch):
        return None                     # learned positions, no RoPE

    def _final_norm(self, params, x):
        return layer_norm(x, params["final_ln_w"], params["final_ln_b"],
                          self.cfg.norm_eps)

    def _cross_invariants(self, batch: DecodeBatch, cview):
        """What every layer shares of the cross attention: the tables and
        their page index and, packed, the varlen call's metadata over the
        cross slots (``packed_cross_meta``) or, padded, the mask ``slot <
        enc_lens`` of each row."""
        packed = batch.seg_ids is not None
        b = 1 if packed else batch.tokens.shape[0]
        tables = batch.tables["cross_attn"].reshape(b, -1)
        st = dict(tables=tables, index=A.page_index(tables))
        if packed:
            slot_pos, slot_seg = BA.page_slots(
                batch.page_pos["cross_attn"].reshape(1, -1),
                batch.page_seg["cross_attn"].reshape(1, -1), cview[3])
            st["meta"] = BA.packed_cross_meta(slot_pos, slot_seg,
                                              batch.seg_ids, batch.enc_lens)
        else:
            sc = tables.shape[1] * cview[3]
            st["mask"] = (torch.arange(sc, device=tables.device)[None]
                          < batch.enc_lens[:, None])[:, None, :]
        return st

    def _qkv(self, p, xn, with_kv=True):
        cfg = self.cfg
        b, t, _ = xn.shape
        hd = cfg.head_dim
        q = A.group_q(dense(xn, p["q"], p["q_bias"]).view(b, t, -1, hd),
                      self.kv_local)
        if not with_kv:
            return q
        k = dense(xn, p["k"]).view(b, t, self.kv_local, hd)
        v = dense(xn, p["v"], p["v_bias"]).view(b, t, self.kv_local, hd)
        return q, k, v

    def serve_step(self, params, buffer: torch.Tensor, batch: DecodeBatch,
                   prefill: Optional[bool] = None) -> torch.Tensor:
        """One serving step in the reference ``_serve_body``'s order: at a
        prefill step that carries frame embeddings, the encoder runs and
        every layer's cross K/V is written; then per decoder layer, its
        self and cross pages are read before any write, causal self
        attention, cross attention, the MLP, and last the layer's self K/V
        write (padded T == 1: written first and read in place by the paged
        decode kernel, which only this layer's read sees). Writes into
        ``buffer`` IN PLACE and returns fp32 logits, one row per segment
        (packed) or per batch row (padded).

        On a ``(data, model)`` mesh the arguments and the logits are this
        rank's, as ``DecoderLM.serve_step``'s. Where a sequence's self
        pages are split over ranks (K/V replicas, ``sp``), the self
        attention runs the split routes of ``blocks_attn`` (the kernels'
        log-sum-exp output over this rank's pages, the partials combined
        over the K/V replica set alone, the fresh chunk merged after);
        cross attention attends the rank's cross pages whole."""
        self._check_mesh()
        cfg, dist = self.cfg, self.dist
        eps = cfg.norm_eps
        packed = batch.seg_ids is not None
        positions = batch.positions
        if prefill is None:
            prefill = packed or positions.shape[1] > 1
        views = self._layer_views(buffer, batch.page_strides)
        sview, cview = views["full_attn"], views["cross_attn"]
        if prefill and batch.enc_embeds is not None:
            self._write_cross(params, buffer, cview, batch)
        b, t = positions.shape
        x = embed_lookup(batch.tokens, params["embed"], dist)
        pos = positions.clamp(0, self.max_dec_pos - 1).long()
        x = x + params["dec_pos"][pos].to(x.dtype)
        if packed:
            _, step = self._packed_invariants(batch, views)
        else:
            _, step = self._padded_invariants(batch, views, prefill)
        st = step["full_attn"]
        ct = self._cross_invariants(batch, cview)
        split, adist = self._split_pages(), self._attn_dist
        layers = zip(unstack(params["dec_self"]),
                     unstack(params["dec_cross"]),
                     unstack(params["dec_mlp"]))
        for layer, (ps, pc, pm) in enumerate(layers):
            if prefill:
                k_old, v_old = BA.attn_gather(buffer, sview, st["tables"],
                                              layer, st["index"])
            kc, vc = BA.attn_gather(buffer, cview, ct["tables"], layer,
                                    ct["index"])
            xn = layer_norm(x, ps["ln_w"], ps["ln_b"], eps)
            q, k, v = self._qkv(ps, xn)
            if packed:
                attend = BA.packed_split_attention if split else \
                    BA.packed_kernel_attention
                out = attend(q, k_old, v_old, k, v, st["meta"],
                             *((adist,) if split else ()))
                out = out.reshape(b, t, -1)
            elif prefill:
                out = BA.padded_prefill_attention(q, k, v, k_old, v_old,
                                                  st["meta"], dist=adist)
            else:
                attend = BA.split_decode_attention if split else \
                    BA.decode_attention
                out = attend(q, k, v, buffer, sview, layer, rows=st["rows"],
                             tables=st["tables"], page_pos=st["page_pos"],
                             qpos=st["qpos"], plan=st["plan"], dist=adist)
            y = psum_tp(dense(out, ps["o"]), dist)
            x = x + y + ps["o_bias"].to(y.dtype)
            xn = layer_norm(x, pc["ln_w"], pc["ln_b"], eps)
            qc = self._qkv(pc, xn, with_kv=False)
            if packed:
                out = BA.packed_cross_attention(qc, kc, vc, ct["meta"])
                out = out.reshape(b, t, -1)
            else:
                # the reference's padded route has no zero guard: a row
                # with enc_lens 0 averages every slot it gathered
                o, _, l = A.attend_tokens(qc, kc, vc, ct["mask"])
                out = A.finalize_softmax(o, l).reshape(b, t, -1).to(x.dtype)
            y = psum_tp(dense(out, pc["o"]), dist)
            x = x + y + pc["o_bias"].to(y.dtype)
            x = _mlp(pm, x, eps, dist)
            if prefill:
                A.write_kv_rows(buffer, sview, layer, st["rows"], k, v)
        return self._head(params, x, batch)
