"""Dense flash attention, forward and backward: the CUDA kernels' wrappers,
their ``torch.autograd.Function`` and the plain PyTorch version.

The kernels (``csrc/dense_flash.cu``: wgmma tensor-core products fed by
TMA copies) replace the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_tpu`` with one
change of contract, as the varlen kernel made: k/v carry ``BH / G`` heads
and q head ``h`` reads kv head ``h // G``. Row i sits at position i and
column j at j; ``causal`` and ``window`` mask as in the TPU kernel, and any
T and S are accepted; D is 16, 32, 64, 120 (the D 128 instances with
the true head dim at run time) or 128. The kernels multiply bf16 x bf16 into fp32 and round
P and dS to bf16 before their products; the plain version keeps fp32
throughout and is the contract they are held to.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 120, 128)
MAX_HEADS = 65535          # the kernels' contract since their first version


def dense_mask(t, s, causal, window, device):
    """(T, S) bool: row i sees column j (``causal``: j <= i; ``window``:
    j > i - window)."""
    qp = torch.arange(t, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def _plain_logits(q, k, causal, window):
    """fp32 masked scores (BH, T, S) with K repeated to the q heads."""
    g = q.shape[0] // k.shape[0]
    k = k.repeat_interleave(g, dim=0)
    d = q.shape[-1]
    logit = torch.einsum("btd,bsd->bts", q.float(), k.float()) / (d ** 0.5)
    mask = dense_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return torch.where(mask[None], logit,
                       torch.full((), NEG_INF, device=logit.device))


def flash_attention_plain(q, k, v, *, causal=True, window=0):
    """The reference's ``flash_attention_ref`` (masked softmax, fp32
    throughout) with GQA: q (BH, T, D); k/v (BH/G, S, D). Masked scores are
    -1e30 with no zero-row guard, so a row that sees nothing gets mean(V).
    Returns (BH, T, D) in q.dtype; its backward is autograd through it (the
    max shift is detached: it cancels in the softmax)."""
    g = q.shape[0] // k.shape[0]
    logit = _plain_logits(q, k, causal, window)
    p = torch.exp(logit - logit.amax(-1, keepdim=True).detach())
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    v = v.repeat_interleave(g, dim=0)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


def flash_lse_plain(q, k, *, causal=True, window=0):
    """The forward kernel's second output: log-sum-exp of each row's masked
    fp32 scores, (BH, T)."""
    return torch.logsumexp(_plain_logits(q, k, causal, window), dim=-1)


def check_inputs(q, k, v, *, window=0):
    """Validate the kernels' inputs (on any device) and return their sizes
    (bh, t, s, d, g): q (BH, T, D), k/v (BH/G, S, D), all bf16, contiguous
    and 16-byte aligned (the kernels read rows with 16-byte vector loads),
    on one device; D in ``HEAD_DIMS``; window >= 0."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: "
                         "expected (heads, tokens, D)")
    bh, t, d = q.shape
    kvh, s = k.shape[0], k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if kvh < 1 or bh % kvh or bh > MAX_HEADS or t < 1 or s < 1:
        raise ValueError(f"q heads {bh} and kv heads {kvh} (tokens {t}, "
                         f"{s}): need kv heads | q heads <= {MAX_HEADS}")
    if int(window) < 0:
        raise ValueError(f"window {window} < 0")
    for name, a, shape in (("q", q, (bh, t, d)), ("k", k, (kvh, s, d)),
                           ("v", v, (kvh, s, d))):
        _check(name, a, shape, q.device)
    return bh, t, s, d, bh // kvh


def _check(name, a, shape, device):
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {a.dtype}, expected torch.bfloat16")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {shape}")
    if a.device != device:
        raise ValueError(f"{name}: on {a.device}, expected {device}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (strides {a.stride()})")
    if a.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load("dense_flash")
    lib.dense_flash_fwd_bf16.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.dense_flash_fwd_bf16.restype = ctypes.c_int
    lib.dense_flash_bwd_bf16.argtypes = [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.dense_flash_bwd_bf16.restype = ctypes.c_int
    lib.dense_flash_error_string.argtypes = [ctypes.c_int]
    lib.dense_flash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.dense_flash_error_string(rc).decode()
        raise RuntimeError(f"dense_flash {what} launch failed: {msg} ({rc})")


def dense_flash_fwd(q, k, v, *, causal=True, window=0, out=None):
    """Forward: (out (BH, T, D) bf16, lse (BH, T) fp32). CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream
    (writing ``out`` when given) or raise. ``dense_flash_fwd.launches``
    counts kernel launches."""
    bh, t, s, d, g = check_inputs(q, k, v, window=window)
    if q.device.type == "cpu":
        return (flash_attention_plain(q, k, v, causal=causal, window=window),
                flash_lse_plain(q, k, causal=causal, window=window))
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = _bind()
    if out is None:
        out = torch.empty_like(q)
    _check("out", out, (bh, t, d), q.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.dense_flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, s, d, g, int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, "forward")
    dense_flash_fwd.launches += 1
    return out, lse


def dense_flash_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                    grads=None):
    """Backward: (dq, dk, dv) in bf16, shaped like q, k, v, from the
    forward's ``out`` and ``lse``. CPU tensors take autograd through the
    plain version; CUDA tensors launch the kernels (delta pre-pass, dK/dV,
    dQ) on the current stream (writing ``grads``, a (dq, dk, dv) triple,
    when given) or raise. ``dense_flash_bwd.launches`` counts backward
    calls (one per call, three kernels each)."""
    bh, t, s, d, g = check_inputs(q, k, v, window=window)
    _check("out", out, (bh, t, d), q.device)
    _check("dout", dout, (bh, t, d), q.device)
    if lse.dtype != torch.float32 or tuple(lse.shape) != (bh, t) or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse: {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}, expected contiguous float32 "
                         f"{(bh, t)}")
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
            o = flash_attention_plain(*leaves, causal=causal, window=window)
            return torch.autograd.grad(o, leaves, dout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = _bind()
    dq, dk, dv = grads or (torch.empty_like(a) for a in (q, k, v))
    for name, a, ref in (("dq", dq, q), ("dk", dk, k), ("dv", dv, v)):
        _check(name, a, tuple(ref.shape), q.device)
    delta = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.dense_flash_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, s, d, g,
            int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, rc, "backward")
    dense_flash_bwd.launches += 1
    return dq, dk, dv


dense_flash_fwd.launches = 0
dense_flash_bwd.launches = 0


class _DenseFlash(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = dense_flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = dense_flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                     causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def dense_flash_attention(q, k, v, *, causal=True, window=0):
    """Dense flash attention with gradients: q (BH, T, D), k/v (BH/G, S, D),
    bf16, contiguous. Returns (BH, T, D) bf16. Inputs are checked on every
    device; CPU tensors then take the plain version (autograd through it),
    CUDA tensors the kernels, forward and backward."""
    check_inputs(q, k, v, window=window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _DenseFlash.apply(q, k, v, bool(causal), int(window))
