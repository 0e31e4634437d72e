"""Block-table-walking attention over the paged KV pool.

Port of ``quintnet_tpu/ops/paged_attention.py``. One function serves
the decode shape (S rows x P = 1 query) and the prefill shape (S = 1
row x P tail queries at a start offset): each row's queries sit at
absolute positions ``starts[s] + arange(P)`` and attend causally to
every pool position ``t <= starts[s] + i`` of that row's block table.

:func:`paged_attention` launches the hand-written CUDA kernel
``csrc/paged_attention.cu`` for CUDA tensors (launch count in
``paged_attention.launches``) and runs :func:`paged_attention_ref`,
the gathered-view math, for CPU tensors. For a CUDA tensor it launches
or raises; it never falls back to the plain version.

Only the passthrough variant is ported (no ``kv_scales`` /
``fresh_kv``): the scaled variant (int8 dequant on load plus the
fresh-K/V override) and ``paged_quant_window_update`` are listed in
ROADMAP.md as still to port.
"""

from __future__ import annotations

import ctypes
import math

import torch

from quintnet_tpu_torch.ops import build

_KERNEL = "paged_attention"


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, T, Dh] -> [B, Hkv*n_rep, T, Dh], groups contiguous
    (nn/attention.repeat_kv's layout)."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep,
                                                            t, d)


def paged_gather(cache, block_tables, *, block_size: int):
    """[N_blocks*bs, H, Dh] pool + [B, M] tables -> the position-ordered
    per-row view [B, H, M*bs, Dh]."""
    nb = cache.shape[0] // block_size
    pages = cache.reshape(nb, block_size,
                          *cache.shape[1:])[block_tables.long()]
    b, m, bs, h, dh = pages.shape
    return pages.permute(0, 3, 1, 2, 4).reshape(b, h, m * bs, dh)


def _gather_kv(k_cache, v_cache, block_tables, *, block_size: int):
    """The paired gathered-view read of both pools (passthrough
    layouts; the JAX twin also dequantizes scaled ones)."""
    return (paged_gather(k_cache, block_tables, block_size=block_size),
            paged_gather(v_cache, block_tables, block_size=block_size))


def paged_attention_ref(q, k_pool, v_pool, block_tables, starts, *,
                        block_size: int):
    """The plain PyTorch version: gather each row's blocks into the
    position-ordered [S, Hkv, M*bs, D] view, then scores / sqrt(D),
    mask to ``finfo.min``, softmax, probs @ V — the gathered-view math
    of ``nn/attention.mha_decode`` (JAX ``nn/attention.py:945-978``).
    Returns [S, Hq, P, D] in q's dtype."""
    S, Hq, P, D = q.shape
    rep = Hq // k_pool.shape[1]
    k_all, v_all = (repeat_kv(t, rep) for t in _gather_kv(
        k_pool, v_pool, block_tables, block_size=block_size))
    T = k_all.shape[2]
    pos = (starts.reshape(S, 1).long()
           + torch.arange(P, device=q.device)[None, :])         # [S, P]
    valid = (torch.arange(T, device=q.device)[None, None, :]
             <= pos[:, :, None])                                 # [S, P, T]
    scores = torch.einsum("shpd,shtd->shpt", q,
                          k_all.to(q.dtype)).float() / math.sqrt(D)
    scores = scores.masked_fill(~valid[:, None],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("shpt,shtd->shpd", probs, v_all.to(q.dtype))


def _lib():
    lib = build.load(_KERNEL)
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_f32.argtypes = [vp] * 6 + [ci] * 7 + [vp]
        lib.paged_attention_f32.restype = ci
        lib.paged_attention_error_string.argtypes = [ci]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib.paged_attention_max_head_dim.argtypes = []
        lib.paged_attention_max_head_dim.restype = ci
        lib._typed = True
    return lib


def _check_cuda_args(q, k_pool, v_pool, block_tables, starts,
                     block_size: int):
    """Everything the kernel assumes, checked before launch."""
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("starts", starts)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"the paged-attention kernel takes float32 {name}; got "
                f"{t.dtype} (narrow pools are not ported yet)")
    for name, t in (("block_tables", block_tables), ("starts", starts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("starts", starts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 4 or k_pool.dim() != 3 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"expected q [S, Hq, P, D] and equal pools [N, Hkv, D]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}")
    S, Hq, P, D = q.shape
    N, Hkv, Dk = k_pool.shape
    if Dk != D:
        raise ValueError(f"pool head dim {Dk} != query head dim {D}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads "
                         f"{Hkv}")
    max_d = _lib().paged_attention_max_head_dim()
    if D % 4 or not 4 <= D <= max_d:
        raise ValueError(f"head dim {D} must be a multiple of 4 in "
                         f"[4, {max_d}]")
    if block_size < 1 or N % block_size:
        raise ValueError(f"pool slots {N} not a multiple of block_size "
                         f"{block_size}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables must be [S={S}, M]; got "
                         f"{tuple(block_tables.shape)}")
    if tuple(starts.shape) != (S,):
        raise ValueError(f"starts must be [S={S}]; got "
                         f"{tuple(starts.shape)}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 "
                             f"loads)")


def paged_attention(q, k_pool, v_pool, block_tables, starts, *,
                    block_size: int):
    """Block-table-walking fused attention over the paged KV pool.

    ``q``: [S, Hq, P, D]; ``k_pool``/``v_pool``: [N_slots, Hkv, D] flat
    pool views (``Hq`` a multiple of ``Hkv`` — GQA groups contiguous);
    ``block_tables``: [S, M] int32; ``starts``: [S] int32. Row s's
    queries sit at ``starts[s] + arange(P)``. Returns o [S, Hq, P, D]
    in q's dtype. Passthrough callers write the pool first; the kernel
    reads the fresh run back like any other slot. Table slots past a
    row's last live block are never read. ``starts`` must be >= 0 and
    every live table entry a valid pool block (the engine's block
    tables are; the kernel does not re-check them on the device)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables,
                                   starts, block_size=block_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check_cuda_args(q, k_pool, v_pool, block_tables, starts, block_size)
    S, Hq, P, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().paged_attention_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), starts.data_ptr(), out.data_ptr(),
            S, Hq, k_pool.shape[1], P, D, block_tables.shape[1],
            block_size, stream)
    if err:
        msg = _lib().paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cuda error {err} ({msg})")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
