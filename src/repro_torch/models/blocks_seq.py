"""Recurrent sequence mixers (``repro/models/blocks_seq.py``): the Mamba2
half, on one device. RWKV6 is a later slice.

The SSD scan of ``mamba2_chunked`` (padded rows) and ``mamba2_packed``
(segments of a packed stream) runs through the Mamba2 chunk-scan kernel,
``kernels.mamba_scan.mamba_chunk_scan_varlen``: both are a scan over
independent token runs, each with its own initial state. Everything around
it stays plain torch with the reference's rounding points: projections,
causal conv (bf16 inputs times fp32 ``conv_w``, summed in fp32), SiLU, the
D residual, the gated RMSNorm and the out-projection. ``mamba2_step``
(T == 1, padded only) is plain torch, as in the reference.

State layout per layer: [ssm_state (H*P*N) | conv_state ((W-1)*(d_in+2N))],
fp32, stored in the unified buffer as bf16 pairs (``attention.read_state``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import mamba_chunk_scan_varlen
from .common import dense, rms_norm


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


def _gated_out(p, x, y, xr, z, norm_eps):
    """y (fp32 scan output, (..., H, P)) plus the D residual, the gated
    RMSNorm and the out-projection, added to the residual stream x."""
    y = y + xr.reshape(y.shape).float() * p["D"].float()[:, None]
    y = y.reshape(*x.shape[:-1], -1).to(x.dtype)
    y = rms_norm(y, p["out_norm"], norm_eps)
    y = y * F.silu(z.float()).to(x.dtype)
    return x + dense(y, p["w_out"])


def _split_xbc(xbc, dil, d_state):
    return (xbc[..., :dil], xbc[..., dil:dil + d_state],
            xbc[..., dil + d_state:])


def mamba2_chunked(p, x, md: dict, *, d_state: int, headdim: int,
                   conv_width: int, norm_eps=1e-5, init_state=None,
                   length_mask=None, last_idx=None):
    """Mamba2 over (B, T) rows (padded serving T > 1). Returns (x + out,
    final state (B, U) fp32). ``length_mask`` (B, T) marks valid tokens
    and ``last_idx`` (B,) the last valid slot per row: padded tokens get
    dt = 0 and lie outside the scan's rows, so the final state is the
    state after each row's last real token; the conv carry is gathered at
    ``last_idx``. Outputs at padded slots are garbage."""
    b, t, _ = x.shape
    hl, dil = md["h_local"], md["d_in_local"]
    xn = rms_norm(x, p["norm"], norm_eps)
    z, xr, bm, cm, dt = _mamba_project(p, xn)
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
    out = _gated_out(p, x, y.view(b, t, hl, headdim), xr, z, norm_eps)
    return out, flatten_mamba_state(s_fin, conv_state)


def mamba2_packed(p, x, md: dict, *, d_state: int, headdim: int,
                  conv_width: int, seg_ids, seg_start, seg_last, init_state,
                  meta=None, norm_eps=1e-5):
    """Mamba2 over a PACKED stream: x (1, TT, d) holds S segments back to
    back; seg_ids (TT,) (-1 pad), seg_start (TT,) (stream index of the
    token's segment's first token), seg_last (S,), init_state (S, U).
    ``meta`` is ``packed_meta(...)`` when the caller has it (it is the same
    for every layer of a step). Pad tokens are masked first (dt = 0, xbc =
    0), as in the reference; the scan then runs one row per segment, so
    ``states[i]`` is the state after segment i's last token and a segment
    with no token passes its state through. Returns (x + out, final
    states (S, U) fp32)."""
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
    out = _gated_out(p, x, y[None], xr, z, norm_eps)
    return out, flatten_mamba_state(s_fin, conv_state)


def mamba2_step(p, x, state_flat, md: dict, *, d_state: int, headdim: int,
                conv_width: int, norm_eps=1e-5):
    """Single-token decode (padded T == 1), plain torch. x: (B, 1, d).
    Returns (x + out, new state (B, U) fp32)."""
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
    out = _gated_out(p, x, y[:, None], xr, z, norm_eps)
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
