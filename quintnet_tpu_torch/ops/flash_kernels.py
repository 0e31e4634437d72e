"""Flash attention's three kernels, their plain versions and the autograd
wiring.

Port of ``quintnet_tpu/ops/pallas_attention.py``. On ``[B, H, S, D]``
tensors with ``scale = 1/sqrt(D)``:

- :func:`flash_fwd` (K1, ``_fwd_kernel``) -> ``(o, lse)``: the attention
  output and the row logsumexp ``lse`` [B, H, S] f32 that the backward
  recomputes the probabilities from;
- :func:`flash_bwd_dkv` (K2, ``_bwd_dkv_kernel``) -> ``(dk, dv)``;
- :func:`flash_bwd_dq` (K3, ``_bwd_dq_kernel``) -> ``dq``;

with ``delta = rowsum(dO * O)`` computed between them in torch, as the
JAX package does (:352). ``segment_ids`` [B, S] (shared by all heads)
masks pairs from different packed documents; ``causal`` masks the
future.

For CUDA tensors each wrapper launches its hand-written kernel from
``csrc/flash_attention.cu`` (launch count in ``<wrapper>.launches``) or
raises; it never falls back to the plain version. For CPU tensors it
runs the plain version (``*_ref``). :class:`FlashAttentionFunction`
ties them together as a ``torch.autograd.Function``, so the CPU tests
exercise the same autograd wiring the card runs.

Only float32 is ported: bf16/fp16 inputs raise ``NotImplementedError``
(ROADMAP.md §2, K1-K3 speed work).
"""

from __future__ import annotations

import ctypes
import math

import torch

from quintnet_tpu_torch.ops import build

_KERNEL = "flash_attention"
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------

def visible_pairs(S, causal, segment_ids, device, cols=None):
    """[B or 1, 1, S, cols] bool: which (query, key) pairs may attend;
    ``cols`` (key positions) defaults to all S."""
    r = torch.arange(S, device=device)
    c = r if cols is None else cols
    vis = torch.ones((r.numel(), c.numel()), dtype=torch.bool, device=device)
    if causal:
        vis = c[None, :] <= r[:, None]
    vis = vis[None, None]
    if segment_ids is not None:
        seg = segment_ids.long()
        vis = vis & (seg[:, r][:, None, :, None] == seg[:, c][:, None, None, :])
    return vis


def flash_fwd_ref(q, k, v, segment_ids=None, *, causal: bool,
                  block_k: int = 64):
    """The forward recurrence in plain torch: an online softmax over key
    tiles of ``block_k`` (running max ``m``, running sum ``l``, the
    output accumulator), masked entries at ``NEG_INF`` and their
    probabilities zeroed. Returns ``(o [B, H, S, D] in q's dtype,
    lse [B, H, S] f32)``."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, block_k):
        cols = torch.arange(k0, min(k0 + block_k, S), device=q.device)
        s = torch.einsum("bhsd,bhtd->bhst", qf, k[:, :, k0:k0 + block_k]
                         .float()) * scale
        vis = visible_pairs(S, causal, segment_ids, q.device, cols=cols)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vis, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p, v[:, :, k0:k0 + block_k].float())
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def _probs_and_dscores(q, k, v, do, lse, delta, segment_ids, causal):
    """``_bwd_block``'s math over the whole [S, S] tile: p = exp(s - lse)
    and ds = p * (dO v^T - delta) * scale, both 0 where masked."""
    S, D = q.shape[-2:]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    vis = visible_pairs(S, causal, segment_ids, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bhsd,bhtd->bhst", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, segment_ids=None, *,
                      causal: bool):
    """dv = p^T dO and dk = ds^T q (plain torch)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, segment_ids, causal)
    dv = torch.einsum("bhst,bhsd->bhtd", p, do.float())
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, segment_ids=None, *,
                     causal: bool):
    """dq = ds k (plain torch)."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, segment_ids, causal)
    return torch.einsum("bhst,bhtd->bhsd", ds, k.float()).to(q.dtype)


# ---------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------

def _lib():
    lib = build.load(_KERNEL)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_f32.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.flash_bwd_dkv_f32.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        lib.flash_bwd_dq_f32.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        for fn in (lib.flash_fwd_f32, lib.flash_bwd_dkv_f32,
                   lib.flash_bwd_dq_f32):
            fn.restype = ci
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda_args(q, tensors, rows, segment_ids):
    """Everything the kernels assume, checked before launch: ``tensors``
    are [B, H, S, D] like q, ``rows`` [B, H, S] f32 (lse, delta)."""
    if q.dim() != 4:
        raise ValueError(f"expected q [B, H, S, D]; got {tuple(q.shape)}")
    B, H, S, D = q.shape
    named = [("q", q), *tensors]
    for name, t in named + list(rows):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype in (torch.bfloat16, torch.float16):
            raise NotImplementedError(
                f"the flash-attention kernels take float32; {name} is "
                f"{t.dtype} (narrow tiles are ROADMAP.md §2, K1-K3 speed "
                f"work)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in tensors:
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
    for name, t in rows:
        if tuple(t.shape) != (B, H, S):
            raise ValueError(f"{name} must be [B, H, S] = {(B, H, S)}; got "
                             f"{tuple(t.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's y limit "
                         f"65535 (one block row per (batch, head))")
    if segment_ids is not None:
        if segment_ids.device != q.device:
            raise ValueError(f"segment_ids is on {segment_ids.device}, q on "
                             f"{q.device}")
        if segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous():
            raise TypeError("segment_ids must be contiguous int32")
        if tuple(segment_ids.shape) != (B, S):
            raise ValueError(f"segment_ids must be [B, S] = {(B, S)}; got "
                             f"{tuple(segment_ids.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, what):
    if err:
        msg = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cuda error {err} "
                           f"({msg})")


def _on_cpu(q, name):
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return False


def flash_fwd(q, k, v, segment_ids=None, *, causal: bool):
    """K1: ``(o, lse)`` for q, k, v [B, H, S, D]; ``segment_ids`` [B, S]
    int32 or None."""
    if _on_cpu(q, "flash_fwd"):
        return flash_fwd_ref(q, k, v, segment_ids, causal=causal)
    _check_cuda_args(q, [("k", k), ("v", v)], [], segment_ids)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(segment_ids),
            o.data_ptr(), lse.data_ptr(), B, H, S, D, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, segment_ids=None, *,
                  causal: bool):
    """K2: ``(dk, dv)``."""
    if _on_cpu(q, "flash_bwd_dkv"):
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, segment_ids,
                                 causal=causal)
    _check_cuda_args(q, [("k", k), ("v", v), ("do", do)],
                     [("lse", lse), ("delta", delta)], segment_ids)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _lib().flash_bwd_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids),
            dk.data_ptr(), dv.data_ptr(), B, H, S, D, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, segment_ids=None, *,
                 causal: bool):
    """K3: ``dq``."""
    if _on_cpu(q, "flash_bwd_dq"):
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, segment_ids,
                                causal=causal)
    _check_cuda_args(q, [("k", k), ("v", v), ("do", do)],
                     [("lse", lse), ("delta", delta)], segment_ids)
    dq = torch.empty_like(q)
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        err = _lib().flash_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(segment_ids),
            dq.data_ptr(), B, H, S, D, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def flash_delta(o, do):
    """``rowsum(dO * O)`` [B, H, S] f32, between the forward and the two
    backward kernels."""
    return (do.float() * o.float()).sum(dim=-1)


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, segment_ids, causal) -> o`` with the flash
    backward: saves q, k, v, o, lse (and the segment ids, which get no
    gradient), then runs K2 and K3 (the JAX package's custom VJP,
    ``_pallas_flash`` :439-459)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal):
        o, lse = flash_fwd(q, k, v, segment_ids, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, segment_ids,
                               causal=ctx.causal)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, segment_ids,
                          causal=ctx.causal)
        return dq, dk, dv, None, None
