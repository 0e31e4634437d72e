"""Block-table-walking attention over the paged KV pool.

Port of ``quintnet_tpu/ops/paged_attention.py``. One function serves
the decode shape (S rows x P = 1 query), the verify shape (S rows x P
queries) and the prefill shape (S = 1 row x P tail queries at a start
offset): each row's queries sit at absolute positions ``starts[s] +
arange(P)`` and attend causally to every pool position ``t <=
starts[s] + i`` of that row's block table.

The pools are in the layout policy's store dtype (f32, bf16,
float8_e4m3fn or int8; ``serve/kv_quant.py``). Under a scaled policy
(int8, fake_quant) each block's per-head scale multiplies the stored
value on load, and the caller passes the run's exact f32 K/V as
``fresh_kv``: the kernel scores those for positions ``[start, start +
P)`` instead of the pool, which still holds the pre-write bytes, and
:func:`paged_quant_window_update` writes the pool afterwards.

:func:`paged_attention` launches the hand-written CUDA kernels of
``csrc/paged_attention.cu`` for CUDA tensors and runs
:func:`paged_attention_ref`, the gathered-view math, for CPU tensors.
For a CUDA tensor it launches or raises; it never falls back to the
plain version. The CUDA source has two paths, picked on the host from
the query rows each kv head serves, ``P * Hq / Hkv``: a split-KV
decode kernel for at most 4 (decode, GQA decode, the verify shape)
and the tiled kernel for wider calls (prefill). Each call counts one
launch in ``paged_attention.launches``, one under its variant in
``paged_attention.launches_by_variant`` and one under its path
(``"decode"`` / ``"prefill"``, :func:`kernel_path`) in
``paged_attention.launches_by_path`` and one under the launching
thread's name in ``paged_attention.launches_by_thread`` (the serving
fleet launches from one worker thread a replica). The counts change
under ``paged_attention.count_lock``; read or clear them under it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import threading

import torch

from quintnet_tpu_torch.ops import build

_KERNEL = "paged_attention"

# store dtype -> (kernel type code, name, row alignment in bytes of the
# kernels' 4-value loads; the decode path loads 16 bytes where the pools
# are 16-byte aligned)
_STORE = {
    torch.float32: (0, "f32", 16),
    torch.bfloat16: (1, "bf16", 8),
    torch.float8_e4m3fn: (2, "fp8", 4),
    torch.int8: (3, "int8", 4),
}


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, Hkv, T, Dh] -> [B, Hkv*n_rep, T, Dh], groups contiguous
    (nn/attention.repeat_kv's layout)."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep,
                                                            t, d)


def _bytes_view(t: torch.Tensor) -> torch.Tensor:
    """float8 tensors as uint8 for indexing (gather / scatter move bytes
    only, and not every backend indexes float8 directly)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def gather_rows(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cache[idx]`` along dim 0, for any store dtype."""
    return _bytes_view(cache)[idx.long()].view(cache.dtype)


def store_rows(cache: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> None:
    """``cache[idx] = vals`` along dim 0, in place, for any store dtype
    (``vals`` already in the cache's dtype). Duplicate indices (the null
    block) keep one of their values: pass ``vals`` through
    :func:`last_null_rows` first so that all of them are the same."""
    _bytes_view(cache)[idx.long()] = _bytes_view(vals.contiguous())


def last_null_rows(idx: torch.Tensor, *vals: torch.Tensor):
    """``vals`` (each [n, ...], one row per entry of ``idx`` [n]) with
    every row whose index is 0 replaced by the last such row. Rows that
    take no part in a step (dead slots, pad columns) all write to row 0,
    the null block, and a dead row or a pad column reads it back. CUDA's
    ``index_put_`` keeps an arbitrary one of duplicate rows, so without
    this the null block, and through MoE routing under a capacity cut
    live tokens too, would differ from run to run and from rank to rank
    of a mesh. With every duplicate the
    same bits, any scatter order leaves what a sequential scatter (the
    CPU's, the JAX package's) leaves: the last writer's row."""
    null = idx == 0
    last = torch.where(null, torch.arange(idx.shape[0], device=idx.device),
                       0).amax().reshape(1)
    return tuple(torch.where(null.view(-1, *(1,) * (v.dim() - 1)),
                             v.index_select(0, last), v) for v in vals)


def paged_gather(cache, block_tables, *, block_size: int):
    """[N_blocks*bs, H, Dh] pool + [B, M] tables -> the position-ordered
    per-row view [B, H, M*bs, Dh], in the pool's dtype."""
    nb = cache.shape[0] // block_size
    pages = gather_rows(cache.reshape(nb, block_size, *cache.shape[1:]),
                        block_tables)
    b, m, bs, h, dh = pages.shape
    return pages.permute(0, 3, 1, 2, 4).reshape(b, h, m * bs, dh)


def paged_gather_scales(scales, block_tables, *, block_size: int):
    """Per-block-per-head scales [num_blocks, H] + tables [B, M] -> the
    position-ordered broadcast view [B, H, M*bs, 1] matching
    :func:`paged_gather`: every slot of a block shares its block's
    per-head scale."""
    sc = scales[block_tables.long()]                # [B, M, H]
    b, m, h = sc.shape
    sc = sc.permute(0, 2, 1)[:, :, :, None].expand(b, h, m, block_size)
    return sc.reshape(b, h, m * block_size)[..., None]


def paged_gather_dequant(cache, scales, block_tables, *, block_size: int):
    """Gather a row's blocks into the position-ordered view and
    dequantize with their block scales as ``stored * scale`` (what every
    scaled policy of the ladder does): [B, H, M*bs, Dh] f32. With
    ``scales=None`` (passthrough policies) it is :func:`paged_gather`,
    float8 upcast to f32 and f32/bf16 left as stored."""
    view = paged_gather(cache, block_tables, block_size=block_size)
    if scales is None:
        return view.float() if view.dtype == torch.float8_e4m3fn else view
    return view.float() * paged_gather_scales(scales, block_tables,
                                              block_size=block_size)


def _gather_kv(k_cache, v_cache, kv_scales, block_tables, *,
               block_size: int):
    """The paired gathered-view read of both pools, dequantized under a
    scaled policy (``kv_scales = (k_scale, v_scale)``, each [nb, H])."""
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    return (paged_gather_dequant(k_cache, ks, block_tables,
                                 block_size=block_size),
            paged_gather_dequant(v_cache, vs, block_tables,
                                 block_size=block_size))


def insert_runs(view, runs, starts):
    """Write each row's run ``runs[s]`` [H, P, D] into ``view`` [S, H, T,
    D] at positions ``starts[s] + arange(P)``; returns a new tensor.
    The view is padded by P slots first, so a run whose pad tail passes
    the end is cut there instead of shifting onto real positions (the
    reference's padded ``dynamic_update_slice``; a start past T is
    clamped to T, as that slice clamps it)."""
    S, H, T, D = view.shape
    P = runs.shape[2]
    padded = torch.cat([view.permute(0, 2, 1, 3),
                        view.new_zeros((S, P, H, D))], dim=1)
    pos = (starts.long().clamp(0, T)[:, None]
           + torch.arange(P, device=view.device)[None, :])          # [S, P]
    rows = torch.arange(S, device=view.device)[:, None]
    padded[rows, pos] = runs.permute(0, 2, 1, 3).to(view.dtype)
    return padded[:, :T].permute(0, 2, 1, 3)


def paged_attention_ref(q, k_pool, v_pool, block_tables, starts, *,
                        block_size: int, kv_scales=None, fresh_kv=None):
    """The plain PyTorch version: gather each row's blocks into the
    position-ordered [S, Hkv, M*bs, D] view (dequantized under
    ``kv_scales``), write ``fresh_kv``'s run over positions ``[start,
    start + P)``, then scores / sqrt(D), mask to ``finfo.min``, softmax,
    probs @ V — the gathered-view math of ``nn/attention.mha_decode``
    (JAX ``nn/attention.py:945-978``). Returns [S, Hq, P, D] in q's
    dtype."""
    S, Hq, P, D = q.shape
    rep = Hq // k_pool.shape[1]
    k_all, v_all = (t.to(q.dtype) for t in _gather_kv(
        k_pool, v_pool, kv_scales, block_tables, block_size=block_size))
    if fresh_kv is not None:
        k_all = insert_runs(k_all, fresh_kv[0], starts)
        v_all = insert_runs(v_all, fresh_kv[1], starts)
    k_all, v_all = repeat_kv(k_all, rep), repeat_kv(v_all, rep)
    T = k_all.shape[2]
    pos = (starts.reshape(S, 1).long()
           + torch.arange(P, device=q.device)[None, :])         # [S, P]
    valid = (torch.arange(T, device=q.device)[None, None, :]
             <= pos[:, :, None])                                 # [S, P, T]
    scores = torch.einsum("shpd,shtd->shpt", q, k_all).float() / math.sqrt(D)
    scores = scores.masked_fill(~valid[:, None],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("shpt,shtd->shpd", probs, v_all)


def _signatures(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_run.argtypes = [ci] + [vp] * 10 + [ci] * 7 + [vp]
    lib.paged_attention_run.restype = ci
    lib.paged_attention_error_string.argtypes = [ci]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    lib.paged_attention_max_head_dim.argtypes = []
    lib.paged_attention_max_head_dim.restype = ci
    lib.paged_attention_decode_path.argtypes = [ci] * 3
    lib.paged_attention_decode_path.restype = ci


def _lib():
    return build.typed(build.load(_KERNEL), _signatures)


def _check_cuda_args(q, k_pool, v_pool, block_tables, starts,
                     block_size: int, kv_scales, fresh_kv):
    """Everything the kernel assumes, checked before launch."""
    dev = q.device
    scales = list(zip(("k_scale", "v_scale"), kv_scales or ()))
    fresh = list(zip(("fresh_k", "fresh_v"), fresh_kv or ()))
    for name, t in [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("starts", starts),
                    *scales, *fresh]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.float32:
        raise TypeError(f"the paged-attention kernel takes float32 q; got "
                        f"{q.dtype}")
    if k_pool.dtype not in _STORE or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"the paged-attention kernel takes pools of one dtype among "
            f"{[str(d) for d in _STORE]}; got {k_pool.dtype} and "
            f"{v_pool.dtype}")
    for name, t in scales + fresh:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("block_tables", block_tables), ("starts", starts)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
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
    if N >= 2**31:
        raise ValueError(f"pool slots {N} must be < 2**31 (the kernels "
                         f"index them as int)")
    if block_size < 1 or N % block_size:
        raise ValueError(f"pool slots {N} not a multiple of block_size "
                         f"{block_size}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables must be [S={S}, M]; got "
                         f"{tuple(block_tables.shape)}")
    if tuple(starts.shape) != (S,):
        raise ValueError(f"starts must be [S={S}]; got "
                         f"{tuple(starts.shape)}")
    for name, t in scales:
        if tuple(t.shape) != (N // block_size, Hkv):
            raise ValueError(f"{name} must be [num_blocks="
                             f"{N // block_size}, Hkv={Hkv}]; got "
                             f"{tuple(t.shape)}")
    for name, t in fresh:
        if tuple(t.shape) != (S, Hkv, P, D):
            raise ValueError(f"{name} must be [S, Hkv, P, D] = "
                             f"{(S, Hkv, P, D)}; got {tuple(t.shape)}")
    align = _STORE[k_pool.dtype][2]
    for name, t, a in (("q", q, 16), ("k_pool", k_pool, align),
                       ("v_pool", v_pool, align),
                       *((n, t, 16) for n, t in fresh)):
        if t.data_ptr() % a:
            raise ValueError(f"{name} must be {a}-byte aligned (the "
                             f"kernel loads 4 values at a time)")


def kernel_variant(k_pool, kv_scales=None) -> str:
    """The variant name a launch counts under: the store dtype, then
    ``_scaled`` under a scaled policy (dequantize on load + the fresh
    override)."""
    return _STORE[k_pool.dtype][1] + ("" if kv_scales is None
                                      else "_scaled")


@functools.lru_cache(maxsize=None)
def _path(Hq: int, Hkv: int, P: int) -> str:
    return ("decode" if _lib().paged_attention_decode_path(Hq, Hkv, P)
            else "prefill")


def kernel_path(q, k_pool) -> str:
    """The CUDA path a call with these shapes takes, by the kernel
    library's own rule (asked once per shape): ``"decode"`` (split-KV)
    when the query rows each kv head serves, ``P * Hq / Hkv``, are few,
    else ``"prefill"``."""
    _, Hq, P, _ = q.shape
    return _path(Hq, k_pool.shape[1], P)


def paged_attention(q, k_pool, v_pool, block_tables, starts, *,
                    block_size: int, kv_scales=None, fresh_kv=None):
    """Block-table-walking fused attention over the paged KV pool.

    ``q``: [S, Hq, P, D] f32; ``k_pool``/``v_pool``: [N_slots, Hkv, D]
    flat pool views in the store dtype (``Hq`` a multiple of ``Hkv`` —
    GQA groups contiguous); ``block_tables``: [S, M] int32; ``starts``:
    [S] int32. Row s's queries sit at ``starts[s] + arange(P)``.

    ``kv_scales``: (k_scale, v_scale), each [N_slots / bs, Hkv] f32, of a
    scaled policy: the stored value times its block's scale is what the
    kernel reads. Scaled callers must pass ``fresh_kv`` = (k, v), each
    [S, Hkv, P, D] f32, the run's exact projections, read instead of
    the pool at positions ``[start, start + P)``; the pool write is
    :func:`paged_quant_window_update`'s, after this call. Passthrough
    callers write the pool first and the kernel reads the run back
    like any other slot.

    Returns o [S, Hq, P, D] in q's dtype. Table slots past a row's last
    live block are never read. ``starts`` must be >= 0 and every live
    table entry a valid pool block (the engine's block tables are; the
    kernel does not re-check them on the device)."""
    if (kv_scales is None) != (fresh_kv is None):
        raise ValueError(
            "kv_scales and fresh_kv go together: under a scaled policy the "
            "kernel scores the run's exact f32 K/V (fresh_kv); the pool "
            "write is paged_quant_window_update's")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables,
                                   starts, block_size=block_size,
                                   kv_scales=kv_scales, fresh_kv=fresh_kv)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check_cuda_args(q, k_pool, v_pool, block_tables, starts, block_size,
                     kv_scales, fresh_kv)
    S, Hq, P, D = q.shape
    path = _path(Hq, k_pool.shape[1], P)
    out = torch.empty_like(q)
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    fk, fv = fresh_kv if fresh_kv is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().paged_attention_run(
            _STORE[k_pool.dtype][0], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), ptr(ks), ptr(vs), ptr(fk), ptr(fv),
            block_tables.data_ptr(), starts.data_ptr(), out.data_ptr(),
            S, Hq, k_pool.shape[1], P, D, block_tables.shape[1],
            block_size, stream)
    if err:
        msg = _lib().paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cuda error {err} ({msg})")
    with paged_attention.count_lock:
        paged_attention.launches += 1
        paged_attention.launches_by_variant[kernel_variant(
            k_pool, kv_scales)] += 1
        paged_attention.launches_by_path[path] += 1
        paged_attention.launches_by_thread[
            threading.current_thread().name] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_variant = collections.Counter()
paged_attention.launches_by_path = collections.Counter()
paged_attention.launches_by_thread = collections.Counter()
paged_attention.count_lock = threading.Lock()


def paged_quant_window_update(policy, cache, scales, vals, positions,
                              lens, *, block_tables, block_size: int,
                              max_blocks: int):
    """The scaled-policy pool write: requantize exactly the blocks each
    row's run touches, IN PLACE on ``cache`` [N_slots, H, D] and
    ``scales`` [nb, H] (per-layer views of the pool).

    Per row, the ``max_blocks`` window of blocks the contiguous run
    ``positions[s, 0] .. positions[s, 0] + lens[s] - 1`` can touch is
    gathered, dequantized under its old scales, the exact f32 run
    inserted at its window offset, slots past the row's last written
    position zeroed (a recycled block's stale bytes must not inflate the
    new absmax), fresh per-block-per-head scales computed, and the
    requantized blocks and scales scattered back. Untouched window slots
    target the null block, every one of them zeros with the zeros'
    scale, so any scatter order leaves the same bytes there (a dead row's
    ``lens`` is 0). Byte-identical to the reference on every real
    block.

    ``vals``: [S, H, P, D]; ``positions``: [S, P] contiguous; ``lens``:
    [S]. Returns (cache, scales), the same tensors."""
    S, H, P, D = vals.shape
    bs, K = block_size, max_blocks
    M = block_tables.shape[1]
    nb = cache.shape[0] // bs
    dev = cache.device
    start = positions[:, 0].long()
    first = torch.div(start, bs, rounding_mode="floor")
    last_pos = start + lens.long() - 1                  # < first*bs if len 0
    j = first[:, None] + torch.arange(K, device=dev)[None, :]       # [S, K]
    touched = ((j <= torch.div(last_pos, bs, rounding_mode="floor")[:, None])
               & (j < M))
    j_c = j.clamp(0, M - 1)
    tgt = torch.where(touched, block_tables.long().gather(1, j_c),
                      torch.zeros_like(j_c))

    pool4 = cache.view(nb, bs, H, D)
    win = policy.dequant(gather_rows(pool4, tgt),
                         scales[tgt][:, :, None, :, None])  # [S, K, bs, H, D]
    win = win.permute(0, 3, 1, 2, 4).reshape(S, H, K * bs, D)
    win = insert_runs(win, vals.float(), start - first * bs)
    winb = win.reshape(S, H, K, bs, D)
    live = (j_c[:, :, None] * bs + torch.arange(bs, device=dev)[None, None, :]
            <= last_pos[:, None, None])                         # [S, K, bs]
    winb = torch.where(live[:, None, :, :, None], winb,
                       torch.zeros((), dtype=winb.dtype, device=dev))
    sc = policy.compute_scale(winb, axes=(3, 4))                # [S, H, K]
    qn = policy.quant(winb, sc[..., None, None])
    flat = tgt.reshape(-1)
    store_rows(pool4, flat, qn.permute(0, 2, 3, 1, 4).reshape(S * K, bs, H, D))
    scales[flat] = sc.permute(0, 2, 1).reshape(S * K, H)
    return cache, scales
