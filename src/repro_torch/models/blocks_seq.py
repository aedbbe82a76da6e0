"""Recurrent sequence mixers (``repro/models/blocks_seq.py``): Mamba2 and
RWKV6; Mamba2 trains on a ``(data, model)`` mesh at each rank's heads.

The SSD scan of ``mamba2_chunked`` (padded rows) and ``mamba2_packed``
(segments of a packed stream) runs through the Mamba2 chunk-scan kernel,
``kernels.mamba_scan.mamba_chunk_scan_varlen``: both are a scan over
independent token runs, each with its own initial state. Training
(``mamba2_chunked(..., train=True)``) runs it through
``mamba_chunk_scan_train``, whose backward is the scan's backward kernel.
Everything around it stays plain torch with the reference's rounding
points: projections,
causal conv (bf16 inputs times fp32 ``conv_w``, summed in fp32), SiLU, the
D residual, the gated RMSNorm and the out-projection. ``mamba2_step``
(T == 1, padded only) is plain torch, as in the reference.

RWKV6 has no TPU kernel: the reference computes its chunked recurrence in
``jnp``, and the port in plain torch with the reference's order of fp32
operations (``rwkv6_chunked`` for padded rows, ``rwkv6_packed`` for the
segments of a packed stream, ``rwkv6_step`` for T == 1). On a mesh
(``dist``) each rank runs its heads (``rwkv6_dims(d, hs, tp)``): the
output projection is summed over the model axis, and the channel mix
computes the rank's output columns from its ``d_ff`` columns alone and
gathers them over the model axis, as the reference does.

State layout per layer, fp32, stored in the unified buffer as bf16 pairs
(``attention.read_state``):
  Mamba2: [ssm_state (H*P*N) | conv_state ((W-1)*(d_in+2N))]
  RWKV6:  [wkv_state (H*hs*hs) | att_shift (d) | cm_shift (d)]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import (mamba_chunk_scan_train,
                                  mamba_chunk_scan_varlen)
from .common import dense, rms_norm
from .tp import gather_tp, psum_tp


def mamba2_dims(d_model: int, expand: int, headdim: int, d_state: int,
                conv_width: int, tp: int = 1):
    d_inner = expand * d_model
    heads = d_inner // headdim
    assert heads % tp == 0, (heads, tp)
    h_local = heads // tp
    d_in_local = h_local * headdim
    ssm_units = h_local * headdim * d_state
    conv_units = (conv_width - 1) * (d_in_local + 2 * d_state)
    return dict(d_inner=d_inner, heads=heads, h_local=h_local,
                d_in_local=d_in_local, ssm_units=ssm_units,
                conv_units=conv_units)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as the reference computes it (logaddexp(x, 0)),
    not torch's thresholded form."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x, w, x_init=None):
    """Depthwise causal conv: x (B,T,C) bf16, w (W,C) fp32, x_init
    (B,W-1,C) carry. Returns (fp32 out, xp), xp the carry-prefixed input:
    the conv state after token j is ``xp[:, j+1 : j+W]``."""
    width = w.shape[0]
    if x_init is None:
        x_init = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                             dtype=x.dtype, device=x.device)
    xp = torch.cat([x_init, x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i]
    return out, xp


def _conv_state_at(xp, width: int, last_idx=None):
    """Conv carry after the last valid token of each row: the ``W-1`` xp
    rows ending at that token (pad slots past ``last_idx`` excluded)."""
    if width <= 1:
        return xp[:, :0]
    if last_idx is None:
        return xp[:, -(width - 1):]
    idx = last_idx.long()[:, None] + 1 + torch.arange(
        width - 1, device=xp.device)[None]                    # (B, W-1)
    return xp.gather(1, idx[..., None].expand(-1, -1, xp.shape[2]))


def packed_meta(seg_ids, seg_start, seg_last, conv_width: int):
    """What every Mamba2 layer of a packed step shares: the valid-token
    mask, the conv's per-tap source indices, and the scan's rows (one per
    segment: ``row_start = seg_start[seg_last]``, ``row_len = seg_last -
    row_start + 1``; a segment that owns no token — a pad segment, or one
    killed in flight — gets length 0 and passes its state through).
    seg_ids/seg_start: (TT,) int; seg_last: (S,) int."""
    tt = seg_ids.shape[0]
    dev = seg_ids.device
    idx = torch.arange(tt, device=dev)
    off = idx - seg_start                            # in-segment offset
    taps = []
    for k in range(1, conv_width):
        ci = torch.clamp(conv_width - 1 + off - k, 0, conv_width - 2)
        taps.append(((idx - k).clamp(min=0), ci.long(),
                     (idx - k >= seg_start)[:, None]))
    last = seg_last.long()
    row_start = seg_start[last]
    own = seg_ids[last] == torch.arange(last.shape[0], device=dev)
    row_len = torch.where(own, last - row_start + 1, 0)
    return dict(valid=seg_ids >= 0, segc=seg_ids.clamp(min=0).long(),
                taps=taps, row_start=row_start.int().contiguous(),
                row_len=row_len.int().contiguous())


def _packed_causal_conv(xf, w, conv0, meta):
    """Depthwise causal conv over a PACKED stream. xf: (TT, C) bf16;
    w: (W, C) fp32; conv0: (S, W-1, C) per-segment carry. Predecessors
    before a segment's first stream slot come from its carry. fp32 out."""
    width = w.shape[0]
    out = xf * w[width - 1]
    for k, (src, ci, inside) in enumerate(meta["taps"], start=1):
        carry = conv0[meta["segc"], ci]
        out = out + w[width - 1 - k] * torch.where(inside, xf[src], carry)
    return out


def _packed_conv_state(xf, conv0, seg_start, seg_last, width):
    """Per-segment conv carry after each segment's last token: its last
    ``W-1`` stream inputs, topped up from the incoming carry when the
    segment is shorter than the window. xf: (TT, C); conv0: (S, W-1, C)."""
    if width <= 1:
        return conv0[:, :0]
    tt = xf.shape[0]
    last = seg_last.long().clamp(0, tt - 1)
    start_seg = seg_start[last].long()
    o_last = last - start_seg
    offs = o_last[:, None] - (width - 2) + torch.arange(
        width - 1, device=xf.device)[None]                    # (S, W-1)
    gidx = torch.clamp(start_seg[:, None] + offs, 0, tt - 1)
    from_x = xf[gidx].to(conv0.dtype)
    ci = torch.clamp(width - 1 + offs, 0, width - 2)
    from_0 = conv0.gather(1, ci[..., None].expand(-1, -1, conv0.shape[2]))
    return torch.where((offs >= 0)[..., None], from_x, from_0)


def _mamba_project(p, x):
    """Shared projections for all modes. Returns z, xr, Bm, Cm (bf16) and
    dt (fp32, after softplus)."""
    z = dense(x, p["w_z"])
    xr = dense(x, p["w_x"])
    bm = dense(x, p["w_B"])
    cm = dense(x, p["w_C"])
    dt = dense(x, p["w_dt"]).float()
    dt = softplus(dt + p["dt_bias"].float())
    return z, xr, bm, cm, dt


def _gated_out(p, x, y, xr, z, norm_eps, dist=None):
    """y (fp32 scan output, (..., H, P)) plus the D residual, the gated
    RMSNorm and the out-projection, summed over the model axis of
    ``dist`` and added to the residual stream x. On a mesh the norm runs
    over this rank's heads only, as the reference's does."""
    y = y + xr.reshape(y.shape).float() * p["D"].float()[:, None]
    y = y.reshape(*x.shape[:-1], -1).to(x.dtype)
    y = rms_norm(y, p["out_norm"], norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return x + psum_tp(dense(y, p["w_out"]), dist)


def _split_xbc(xbc, dil, d_state):
    return (xbc[..., :dil], xbc[..., dil:dil + d_state],
            xbc[..., dil + d_state:])


def mamba2_chunked(p, x, md: dict, *, d_state: int, headdim: int,
                   conv_width: int, norm_eps=1e-5, init_state=None,
                   length_mask=None, last_idx=None, train=False, dist=None):
    """Mamba2 over (B, T) rows (padded serving T > 1, and training).
    Returns (x + out, final state (B, U) fp32). ``length_mask`` (B, T)
    marks valid tokens and ``last_idx`` (B,) the last valid slot per row:
    padded tokens get dt = 0 and lie outside the scan's rows, so the final
    state is the state after each row's last real token; the conv carry is
    gathered at ``last_idx``. Outputs at padded slots are garbage.

    ``train``: the training route (the reference's ``train_loss`` calls):
    rows of equal length T from zero states, the scan through
    ``mamba_chunk_scan_train`` (differentiable: its backward is the scan's
    backward kernel on the card), no in-place write on the autograd graph,
    and no final state (returned as None). On a ``(data, model)`` mesh
    (``dist``, training and serving) ``p`` holds this rank's
    ``md["h_local"]`` heads, the scan runs over them, the gated norm
    normalises over them and the out-projection is summed over the model
    axis."""
    b, t, _ = x.shape
    hl, dil = md["h_local"], md["d_in_local"]
    if train and (init_state is not None or length_mask is not None or
                  last_idx is not None):
        raise ValueError("mamba2_chunked(train=True) takes equal rows from "
                         "zero states")
    xn = rms_norm(x, p["norm"], norm_eps)
    z, xr, bm, cm, dt = _mamba_project(p, xn)
    if train:
        xbc, _ = _causal_conv(torch.cat([xr, bm, cm], dim=-1), p["conv_w"])
        xbc = F.silu(xbc.float()).to(x.dtype)
        xr, bm, cm = _split_xbc(xbc.view(b * t, -1), dil, d_state)
        dev = x.device
        y = mamba_chunk_scan_train(
            xr.view(b * t, hl, headdim), bm, cm, dt.reshape(b * t, hl),
            p["A_log"], torch.arange(b, dtype=torch.int32, device=dev) * t,
            torch.full((b,), t, dtype=torch.int32, device=dev))
        return _gated_out(p, x, y.view(b, t, hl, headdim), xr, z,
                          norm_eps, dist), None
    if length_mask is not None:
        dt = dt * length_mask[..., None].to(dt.dtype)
    if init_state is not None:
        ssm0, conv0 = split_mamba_state(init_state, md, d_state, headdim,
                                        conv_width)
    else:
        ssm0 = torch.zeros((b, hl, headdim, d_state), dtype=torch.float32,
                           device=x.device)
        conv0 = None
    xbc = torch.cat([xr, bm, cm], dim=-1)
    xbc, xp = _causal_conv(xbc, p["conv_w"], conv0)
    conv_state = _conv_state_at(xp, conv_width, last_idx)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xr, bm, cm = _split_xbc(xbc.view(b * t, -1), dil, d_state)
    dev = x.device
    row_start = torch.arange(b, dtype=torch.int32, device=dev) * t
    row_len = (last_idx.int() + 1 if last_idx is not None else
               torch.full((b,), t, dtype=torch.int32, device=dev))
    y, s_fin = mamba_chunk_scan_varlen(
        xr.view(b * t, hl, headdim), bm, cm, dt.reshape(b * t, hl),
        p["A_log"], row_start, row_len.contiguous(), ssm0)
    out = _gated_out(p, x, y.view(b, t, hl, headdim), xr, z, norm_eps, dist)
    return out, flatten_mamba_state(s_fin, conv_state)


def mamba2_packed(p, x, md: dict, *, d_state: int, headdim: int,
                  conv_width: int, seg_ids, seg_start, seg_last, init_state,
                  meta=None, norm_eps=1e-5, dist=None):
    """Mamba2 over a PACKED stream: x (1, TT, d) holds S segments back to
    back; seg_ids (TT,) (-1 pad), seg_start (TT,) (stream index of the
    token's segment's first token), seg_last (S,), init_state (S, U).
    ``meta`` is ``packed_meta(...)`` when the caller has it (it is the same
    for every layer of a step). Pad tokens are masked first (dt = 0, xbc =
    0), as in the reference; the scan then runs one row per segment, so
    ``states[i]`` is the state after segment i's last token and a segment
    with no token passes its state through. Returns (x + out, final
    states (S, U) fp32). On a mesh (``dist``) the rank's heads, as
    ``mamba2_chunked``'s."""
    hl, dil = md["h_local"], md["d_in_local"]
    tt = x.shape[1]
    if meta is None:
        meta = packed_meta(seg_ids, seg_start, seg_last, conv_width)
    xn = rms_norm(x, p["norm"], norm_eps)
    z, xr, bm, cm, dt = _mamba_project(p, xn)
    valid = meta["valid"]
    dt = dt[0] * valid[:, None].to(dt.dtype)
    ssm0, conv0 = split_mamba_state(init_state, md, d_state, headdim,
                                    conv_width)
    raw = torch.cat([xr, bm, cm], dim=-1)[0]                  # (TT, C)
    conv_out = _packed_causal_conv(raw, p["conv_w"], conv0, meta)
    conv_state = _packed_conv_state(raw, conv0, seg_start, seg_last,
                                    conv_width)
    xbc = F.silu(conv_out.float()).to(x.dtype)
    xbc = xbc * valid[:, None].to(xbc.dtype)
    xr, bm, cm = _split_xbc(xbc, dil, d_state)
    y, s_fin = mamba_chunk_scan_varlen(
        xr.view(tt, hl, headdim), bm, cm, dt, p["A_log"],
        meta["row_start"], meta["row_len"], ssm0)
    out = _gated_out(p, x, y[None], xr, z, norm_eps, dist)
    return out, flatten_mamba_state(s_fin, conv_state)


def mamba2_step(p, x, state_flat, md: dict, *, d_state: int, headdim: int,
                conv_width: int, norm_eps=1e-5, dist=None):
    """Single-token decode (padded T == 1), plain torch. x: (B, 1, d).
    Returns (x + out, new state (B, U) fp32). On a mesh (``dist``) the
    rank's heads, as ``mamba2_chunked``'s."""
    b = x.shape[0]
    hl, dil = md["h_local"], md["d_in_local"]
    ssm, conv = split_mamba_state(state_flat, md, d_state, headdim,
                                  conv_width)
    xn = rms_norm(x, p["norm"], norm_eps)
    z, xr, bm, cm, dt = _mamba_project(p, xn)
    xbc = torch.cat([xr, bm, cm], dim=-1)                    # (B,1,C)
    xbc, xp = _causal_conv(xbc, p["conv_w"], conv)
    conv = _conv_state_at(xp, conv_width)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xr, bm, cm = _split_xbc(xbc[:, 0], dil, d_state)
    dt = dt[:, 0]                                             # (B,H)
    decay = torch.exp(dt * -torch.exp(p["A_log"].float()))
    xh = xr.reshape(b, hl, headdim).float()
    ssm = ssm * decay[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, bm.float())
    y = torch.einsum("bn,bhpn->bhp", cm.float(), ssm)
    out = _gated_out(p, x, y[:, None], xr, z, norm_eps, dist)
    return out, flatten_mamba_state(ssm, conv)


def flatten_mamba_state(ssm, conv):
    """(B, H, P, N) fp32 SSM state and (B, W-1, C) conv carry -> (B, U)
    fp32."""
    b = ssm.shape[0]
    return torch.cat([ssm.float().reshape(b, -1),
                      conv.float().reshape(b, -1)], dim=-1)


def split_mamba_state(flat, md, d_state, headdim, conv_width):
    """(B, U) fp32 -> (ssm (B, H, P, N) fp32 view, conv (B, W-1, C) bf16)."""
    b = flat.shape[0]
    hl, dil = md["h_local"], md["d_in_local"]
    n_ssm = md["ssm_units"]
    ssm = flat[:, :n_ssm].view(b, hl, headdim, d_state)
    conv = flat[:, n_ssm:].reshape(b, conv_width - 1, dil + 2 * d_state)
    return ssm, conv.to(torch.bfloat16)


# ====================================================================== RWKV6
RWKV_CHUNK = 64


def rwkv6_dims(d_model: int, head_size: int, tp: int = 1):
    heads = d_model // head_size
    heads_pad = -(-heads // tp) * tp
    h_local = heads_pad // tp
    d_att_local = h_local * head_size
    wkv_units = h_local * head_size * head_size
    shift_units = 2 * d_model   # att shift + channel-mix shift
    return dict(heads=heads, heads_pad=heads_pad, h_local=h_local,
                d_att_local=d_att_local, wkv_units=wkv_units,
                shift_units=shift_units)


def _rwkv_mix(x, x_prev, mu):
    """Token-shift lerp in bf16. x, x_prev: (B, T, d); mu: (d,)."""
    return x + (x_prev - x) * mu.to(x.dtype)


def _rwkv_proj(p, x, x_prev, rd, head_size: int):
    """Time-mix projections: r, k, v, g (B, T, H, hs) bf16 and the
    data-dependent log decay logw = -exp(ww) (B, T, H, hs) fp32 <= 0, ww
    from the LoRA (tanh of the bf16 down-projection, an fp32 product with
    ``w_lora_b``, plus ``w_base``)."""
    b, t, _ = x.shape
    hl = rd["h_local"]

    def proj(name):
        return dense(_rwkv_mix(x, x_prev, p["mu_" + name]),
                     p["w_" + name]).reshape(b, t, hl, head_size)

    r, k, v, g = proj("r"), proj("k"), proj("v"), proj("g")
    xw = _rwkv_mix(x, x_prev, p["mu_w"])
    ww = torch.tanh(dense(xw, p["w_lora_a"]).float())
    ww = torch.matmul(ww, p["w_lora_b"].float())
    ww = ww + p["w_base"].float()
    logw = -torch.exp(ww).reshape(b, t, hl, head_size)
    return r, k, v, g, logw


def _packed_shift(xf, shift0, seg_ids, seg_start):
    """Token shift over a packed stream: x_prev[t] = x[t-1] inside the
    token's segment, the segment's carried shift state at its first token.
    xf: (TT, d); shift0: (S, 1, d). Returns (1, TT, d)."""
    tt = xf.shape[0]
    idx = torch.arange(tt, device=xf.device)
    prev = xf[(idx - 1).clamp(min=0)]
    carry = shift0[seg_ids.clamp(min=0).long(), 0].to(xf.dtype)
    return torch.where((idx - 1 >= seg_start)[:, None], prev, carry)[None]


def _decay(Lprev, L, mask):
    """exp(min(Lprev_t - L_s, 0)) where ``mask`` (t, s) holds, else 0:
    (..., t, s, H, hs) from (..., L, H, hs) cumulative log decays."""
    diff = Lprev.unsqueeze(-3) - L.unsqueeze(-4)
    diff = torch.where(mask[..., None, None], diff,
                       torch.full((), float("-inf"), device=diff.device))
    return torch.exp(torch.clamp(diff, max=0.0))


def _pad_chunks(a, chunk, dim):
    """``a`` zero-padded along ``dim`` to a multiple of ``chunk``."""
    pad = -a.shape[dim] % chunk
    if not pad:
        return a
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, a.new_zeros(shape)], dim)


def rwkv6_chunked(p, x, rd: dict, *, head_size: int, chunk: int = RWKV_CHUNK,
                  norm_eps=1e-5, init_state=None, length_mask=None,
                  last_idx=None, dist=None):
    """RWKV6 time mix + channel mix over (B, T) rows (padded serving).
    Returns (x + out, final state (B, U) fp32). Pad tokens (``length_mask``
    False) get k = 0 and logw = 0, so the wkv state is the state after each
    row's last real token; the shift carries are taken at ``last_idx``.
    Outputs at pad slots are garbage."""
    b, t, d = x.shape
    hl = rd["h_local"]
    if init_state is not None:
        s0, att_shift, cm_shift = split_rwkv_state(init_state, rd,
                                                   head_size, d)
    else:
        s0 = x.new_zeros((b, hl, head_size, head_size), dtype=torch.float32)
        att_shift = cm_shift = x.new_zeros((b, 1, d))

    xn = rms_norm(x, p["ln1"], norm_eps)
    x_prev = torch.cat([att_shift, xn[:, :-1]], 1)
    r, k, v, g, logw = _rwkv_proj(p, xn, x_prev, rd, head_size)
    if length_mask is not None:
        valid = length_mask[:, :, None, None]
        k = torch.where(valid, k, torch.zeros((), dtype=k.dtype,
                                              device=k.device))
        logw = torch.where(valid, logw, torch.zeros((), device=x.device))
    u = p["u"].float()                                         # (H, hs)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device), diagonal=-1)
    parts = [_pad_chunks(a.float(), chunk, 1).split(chunk, 1)
             for a in (r, k, v, logw)]
    S, ys = s0, []
    for rk, kk, vk, lw in zip(*parts):                         # (B,L,H,hs)
        L = torch.cumsum(lw, 1)
        Lprev = L - lw
        dec = _decay(Lprev, L, tri)                            # (B,t,s,H,hs)
        score = torch.einsum("bthc,btshc,bshc->bhts", rk, dec, kk)
        diag = torch.einsum("bthc,hc,bthc->bth", rk, u, kk)
        y = torch.einsum("bhts,bshc->bthc", score, vk)
        y = y + diag[..., None] * vk
        rdec = rk * torch.exp(Lprev)
        y = y + torch.einsum("bthk,bhkv->bthv", rdec, S)
        kdec = kk * torch.exp(L[:, -1][:, None] - L)
        S = S * torch.exp(L[:, -1])[..., None] + \
            torch.einsum("bshk,bshv->bhkv", kdec, vk)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :t]
    x = x + _rwkv_out(p, y, g, b, t, norm_eps, dist)

    xc = rms_norm(x, p["ln2"], norm_eps)
    xc_prev = torch.cat([cm_shift, xc[:, :-1]], 1)
    x = x + _channel_mix(p, xc, xc_prev, dist)
    if last_idx is None:
        att_out, cm_out = xn[:, -1:], xc[:, -1:]
    else:
        rows = torch.arange(b, device=x.device)
        li = last_idx.long()
        att_out, cm_out = xn[rows, li][:, None], xc[rows, li][:, None]
    return x, flatten_rwkv_state(S, att_out, cm_out)


def rwkv6_packed(p, x, rd: dict, *, head_size: int, seg_ids, seg_start,
                 seg_last, init_state, chunk: int = RWKV_CHUNK,
                 norm_eps=1e-5, dist=None):
    """RWKV6 over a PACKED stream (the layout of ``mamba2_packed``): the
    chunked wkv scan carries one state per SEGMENT, with segment-equality
    masks on the intra-chunk scores and each token's state read decayed
    from its segment's first in-chunk token (``base``); token shifts read
    each segment's carried shift at its first stream slot. Returns
    (x + out (1, TT, d), final states (S, U) fp32). One departure from the
    reference: the state update's decay exponent is clamped at 0, which
    keeps pads that follow more than 88 nats of in-chunk decay from
    turning the states to NaN (see the note in the loop)."""
    _, t, d = x.shape
    nseg = init_state.shape[0]
    hl = rd["h_local"]
    dev = x.device
    s0, att_shift, cm_shift = split_rwkv_state(init_state, rd, head_size, d)
    valid = seg_ids >= 0

    xn = rms_norm(x, p["ln1"], norm_eps)
    x_prev = _packed_shift(xn[0], att_shift, seg_ids, seg_start)
    r, k, v, g, logw = _rwkv_proj(p, xn, x_prev, rd, head_size)
    vmask = valid[None, :, None, None]
    k = torch.where(vmask, k, torch.zeros((), dtype=k.dtype, device=dev))
    logw = torch.where(vmask, logw, torch.zeros((), device=dev))
    u = p["u"].float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev), diagonal=-1)
    parts = [_pad_chunks(a[0].float(), chunk, 0).split(chunk, 0)
             for a in (r, k, v, logw)]
    segs = torch.cat([seg_ids, seg_ids.new_full((-t % chunk,), -1)]).split(
        chunk)
    ar = torch.arange(nseg, device=dev)
    inf = torch.full((), float("inf"), device=dev)
    S_seg, ys = s0, []
    for rk, kk, vk, lw, sk in zip(*parts, segs):               # (L,H,hs)
        oneh = (sk[:, None] == ar[None]).float()               # (L,S)
        on = (oneh > 0)[..., None, None]
        skc = sk.clamp(min=0).long()
        L = torch.cumsum(lw, 0)
        Lprev = L - lw
        same = (sk[:, None] == sk[None, :]) & (sk >= 0)[:, None]
        dec = _decay(Lprev, L, tri & same)                     # (t,s,H,hs)
        score = torch.einsum("thc,tshc,shc->hts", rk, dec, kk)
        diag = torch.einsum("thc,hc,thc->th", rk, u, kk)
        y = torch.einsum("hts,shc->thc", score, vk)
        y = y + diag[..., None] * vk
        base = torch.where(on, Lprev[:, None], -inf).amax(0)   # (S,H,hs)
        base = torch.where(torch.isfinite(base), base, 0.0)
        rdec = rk * torch.exp(Lprev - base[skc])
        y = y + torch.einsum("thk,thkv->thv", rdec, S_seg[skc])
        seg_sum = torch.einsum("ls,lhc->shc", oneh, lw)
        segend = torch.where(on, L[:, None], inf).amin(0)
        segend = torch.where(torch.isfinite(segend), segend, 0.0)
        # segend[s] <= L at every token of segment s, so the clamp changes
        # no real token's factor; a pad (k = 0) reads segend of segment 0
        # (or 0 when segment 0 is not in the chunk), and past 88 nats of
        # in-chunk decay the reference's exp overflows there and 0 * inf
        # turns every segment's state to NaN
        kdec = kk * torch.exp(torch.clamp(segend[skc] - L, max=0.0))
        S_add = torch.einsum("ls,lhk,lhv->shkv", oneh, kdec, vk)
        S_seg = S_seg * torch.exp(seg_sum)[..., None] + S_add
        ys.append(y)
    y = torch.cat(ys, 0)[:t][None]
    x = x + _rwkv_out(p, y, g, 1, t, norm_eps, dist)

    xc = rms_norm(x, p["ln2"], norm_eps)
    xc_prev = _packed_shift(xc[0], cm_shift, seg_ids, seg_start)
    x = x + _channel_mix(p, xc, xc_prev, dist)
    last = seg_last.long().clamp(0, t - 1)
    return x, flatten_rwkv_state(S_seg, xn[0][last][:, None],
                                 xc[0][last][:, None])


def rwkv6_step(p, x, state_flat, rd: dict, *, head_size: int,
               norm_eps=1e-5, dist=None):
    """Single-token decode (padded T == 1). x: (B, 1, d). Returns
    (x + out, new state (B, U) fp32)."""
    b, _, d = x.shape
    hl = rd["h_local"]
    S, att_shift, cm_shift = split_rwkv_state(state_flat, rd, head_size, d)
    xn = rms_norm(x, p["ln1"], norm_eps)
    r, k, v, g, logw = _rwkv_proj(p, xn, att_shift, rd, head_size)
    rk, kk, vk = (a[:, 0].float() for a in (r, k, v))
    w = torch.exp(logw[:, 0])                                  # (B,H,hs)
    u = p["u"].float()
    kv = torch.einsum("bhk,bhv->bhkv", kk, vk)
    wkv = S + u[None, :, :, None] * kv
    y = torch.einsum("bhk,bhkv->bhv", rk, wkv)[:, None]
    S = S * w[..., None] + kv
    x = x + _rwkv_out(p, y.reshape(b, 1, hl, head_size), g, b, 1, norm_eps,
                      dist)
    xc = rms_norm(x, p["ln2"], norm_eps)
    x = x + _channel_mix(p, xc, cm_shift, dist)
    return x, flatten_rwkv_state(S, xn[:, -1:], xc[:, -1:])


def _rwkv_out(p, y, g, b, t, norm_eps, dist=None):
    """The wkv output (fp32 (B, T, H, hs)) rounded to bf16, its per-layer
    RMSNorm, the SiLU(g) gate and the output projection, summed over the
    model axis of ``dist``. On a mesh the norm runs over this rank's
    heads only, as the reference's does."""
    y = y.reshape(b, t, -1).to(torch.bfloat16)
    y = rms_norm(y, p["ln_x"], norm_eps)
    y = y * F.silu(g.reshape(b, t, -1).float()).to(y.dtype)
    return psum_tp(dense(y, p["w_o"]), dist)


def _channel_mix(p, xc, xc_prev, dist=None):
    """RWKV channel mix: relu(k)^2 through ``cm_wv``, gated by
    sigmoid(r) in fp32. On a mesh the rank holds ``d_ff / tp`` columns
    of ``cm_wk`` and ``d / tp`` output columns of ``cm_wv`` (from its own
    ``d_ff`` columns alone: no sum over the model axis) and ``cm_wr``,
    and the output columns are gathered over the model axis (the
    reference's tiled ``all_gather``; the identity on one device)."""
    xk = _rwkv_mix(xc, xc_prev, p["cm_mu_k"])
    xr = _rwkv_mix(xc, xc_prev, p["cm_mu_r"])
    k = dense(xk, p["cm_wk"])
    k = torch.square(F.relu(k.float())).to(xc.dtype)
    vloc = dense(k, p["cm_wv"])
    rloc = torch.sigmoid(dense(xr, p["cm_wr"]).float())
    return gather_tp((vloc.float() * rloc).to(xc.dtype), -1, dist)


def flatten_rwkv_state(S, att_shift, cm_shift):
    """(B, H, hs, hs) fp32 wkv state and (B, 1, d) shifts -> (B, U) fp32."""
    b = S.shape[0]
    return torch.cat([S.float().reshape(b, -1),
                      att_shift.float().reshape(b, -1),
                      cm_shift.float().reshape(b, -1)], dim=-1)


def split_rwkv_state(flat, rd, head_size, d):
    """(B, U) fp32 -> (wkv (B, H, hs, hs) fp32, att shift (B, 1, d) bf16,
    cm shift (B, 1, d) bf16)."""
    b = flat.shape[0]
    n = rd["wkv_units"]
    S = flat[:, :n].reshape(b, rd["h_local"], head_size, head_size)
    att = flat[:, n:n + d].reshape(b, 1, d).to(torch.bfloat16)
    cm = flat[:, n + d:n + 2 * d].reshape(b, 1, d).to(torch.bfloat16)
    return S.float(), att, cm
