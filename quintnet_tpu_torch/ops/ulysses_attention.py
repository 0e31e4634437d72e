"""Ulysses attention: an all-to-all head scatter over a sequence axis.

Port of ``quintnet_tpu/ops/ulysses_attention.py``. Where ring attention
keeps the queries and rotates K/V chunks for sp steps, Ulysses pays two
all-to-alls: one trades the head dim for the sequence dim (each rank then
holds H_local / sp heads over the WHOLE sequence), one trades them back
after attention. In between, attention is an ordinary local call, so it
runs the flash kernels (K1-K3 on the card) with ``use_flash``. The
all-to-all's backward is the reverse all-to-all
(``core/collectives.all_to_all``).
"""

from __future__ import annotations

import torch

from quintnet_tpu_torch.core import collectives as cc
from quintnet_tpu_torch.nn.attention import sdpa
from quintnet_tpu_torch.ops.flash_attention import flash_attention


def ulysses_attention(q, k, v, *, axis, causal: bool = False,
                      use_flash: bool = False, pdrop: float = 0.0,
                      generator=None, segment_ids=None, mesh=None):
    """[B, H_local, S_local, D] sequence-sharded over ``axis`` (a
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`, or a name with
    ``mesh``) -> the same, equal to attention over the gathered sequence.
    ``H_local`` must divide by the axis size (else ``ValueError``, as in
    JAX: use ring attention there). q, k and v ride ONE all-to-all
    (stacked on a leading dim) and the output one more. ``segment_ids``
    [B, S_local]: this rank's slice of the GLOBAL ids, reassembled by one
    [B, S] all-gather for the full-sequence inner attention. The inner
    call is ``ops.flash_attention`` with ``use_flash``, else the plain
    ``sdpa``; dropout (``pdrop`` with the rank's ``generator``) is the
    inner call's, each rank holding its own heads."""
    ax = cc.resolve_axis(axis, mesh)
    sp = ax.size
    h_local = q.shape[1]
    if h_local % sp != 0:
        raise ValueError(
            f"ulysses attention needs local heads ({h_local}) divisible by "
            f"sp axis size ({sp}); use ring attention (sp_mode='ring') for "
            "sp larger than the head count")
    # scatter heads, gather the sequence: [3, B, H/sp, S_full, D]; source
    # order is sequence-chunk order, so the concatenation is the sequence
    qkv = cc.all_to_all(torch.stack([q, k, v]), ax, split_dim=2,
                        concat_dim=3)
    seg_full = None
    if segment_ids is not None:
        seg_full = cc.all_gather(segment_ids.to(torch.int32), ax,
                                 gather_dim=1)          # [B, S_full]
    attend = flash_attention if use_flash else sdpa
    of = attend(qkv[0], qkv[1], qkv[2], causal=causal, pdrop=pdrop,
                generator=generator, segment_ids=seg_full)
    # gather the heads back, scatter the sequence: [B, H_local, S_local, D]
    return cc.all_to_all(of, ax, split_dim=2, concat_dim=1)
