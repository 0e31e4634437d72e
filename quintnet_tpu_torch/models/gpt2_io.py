"""GPT-2 checkpoints in the Hugging Face layout: HF safetensors <-> the
port's parameter trees.

Port of ``quintnet_tpu/models/gpt2_io.py``, on the port's own
safetensors reader and writer (``utils/safetensors_io.py``), so a file
written by either package loads in the other and in transformers'
``GPT2LMHeadModel``.

The HF key schema: an optional ``transformer.`` prefix, ``h.{i}.``
blocks, the attention mask buffers (``attn.bias``, ``attn.masked_bias``)
skipped, and ``lm_head.weight`` skipped (it is tied to ``wte``). HF's
Conv1D weights are ``[in, out]``, the port's own layout, so nothing is
transposed; the per-layer blocks are stacked into the ``[L, ...]``
leaves the port's GPT-2 holds.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.core.pytree import tree_map, tree_stack
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.utils import safetensors_io as st


def _norm_key(k: str) -> str:
    return k[len("transformer."):] if k.startswith("transformer.") else k


def _skip(k: str) -> bool:
    # the causal-mask buffers ("...attn.bias"/"...attn.masked_bias", not
    # "c_attn.bias") and the tied lm_head
    tail = k.split(".")[-2:]
    return (tail in (["attn", "bias"], ["attn", "masked_bias"])
            or _norm_key(k) == "lm_head.weight")


def load_hf_gpt2(path: str, cfg: Optional[GPT2Config] = None, *,
                 device="cuda", dtype=torch.float32):
    """An HF GPT-2 safetensors file -> ``(params, GPT2Config)``, the
    params on ``device`` (the card unless the caller asks for the CPU)
    in ``dtype``. Without ``cfg`` the sizes are read from the file (the
    head count from the width, as the HF presets pair them). The fused
    QKV comes back in the standard [q|k|v] layout; a tp strategy's
    ``shard_params`` permutes it."""
    dev = resolve_device(device)
    with st.SafeTensorFile(path) as f:
        t = {_norm_key(k): f.tensor(k) for k in f.keys() if not _skip(k)}

    wte, wpe = t["wte.weight"], t["wpe.weight"]
    n_layer = 1 + max(int(k.split(".")[1]) for k in t if k.startswith("h."))
    if cfg is None:
        width = wte.shape[1]
        cfg = GPT2Config.from_dict({
            "vocab_size": wte.shape[0], "n_positions": wpe.shape[0],
            "n_embd": width, "n_layer": n_layer,
            "n_head": {768: 12, 1024: 16, 1280: 20}.get(width, 25)})

    def block(i):
        p = f"h.{i}."
        return {
            "ln1": {"scale": t[p + "ln_1.weight"],
                    "bias": t[p + "ln_1.bias"]},
            "attn": {
                "qkv": {"w": t[p + "attn.c_attn.weight"],
                        "b": t[p + "attn.c_attn.bias"]},
                "proj": {"w": t[p + "attn.c_proj.weight"],
                         "b": t[p + "attn.c_proj.bias"]},
            },
            "ln2": {"scale": t[p + "ln_2.weight"],
                    "bias": t[p + "ln_2.bias"]},
            "mlp": {
                "fc": {"w": t[p + "mlp.c_fc.weight"],
                       "b": t[p + "mlp.c_fc.bias"]},
                "proj": {"w": t[p + "mlp.c_proj.weight"],
                         "b": t[p + "mlp.c_proj.bias"]},
            },
        }

    params = {
        "embedding": {"wte": wte, "wpe": wpe},
        "blocks": tree_stack([block(i) for i in range(cfg.n_layer)]),
        "head": {"ln_f": {"scale": t["ln_f.weight"],
                          "bias": t["ln_f.bias"]}},
    }
    return tree_map(lambda x: x.to(dev, dtype), params), cfg


def save_hf_gpt2(params, cfg: GPT2Config, path: str, *, prefix: str = "",
                 tp_layout: int = 1) -> None:
    """A parameter tree -> one HF-layout safetensors file (f32) that
    transformers' ``GPT2LMHeadModel`` loads. ``tp_layout``: the tp size
    of a tree whose fused QKV is in the tp-blocked layout, put back in
    the standard [q|k|v] order."""
    from quintnet_tpu_torch.parallel.tp import qkv_standard_from_blocked

    def n(x):
        return x.detach().to("cpu", torch.float32).contiguous()

    out: Dict[str, torch.Tensor] = {
        prefix + "wte.weight": n(params["embedding"]["wte"]),
        prefix + "wpe.weight": n(params["embedding"]["wpe"]),
        prefix + "ln_f.weight": n(params["head"]["ln_f"]["scale"]),
        prefix + "ln_f.bias": n(params["head"]["ln_f"]["bias"]),
    }
    blocks = tree_map(n, params["blocks"])   # one copy to the host
    for i in range(cfg.n_layer):
        p = f"{prefix}h.{i}."
        blk = tree_map(lambda x: x[i], blocks)
        qkv_w, qkv_b = blk["attn"]["qkv"]["w"], blk["attn"]["qkv"]["b"]
        if tp_layout > 1:
            qkv_w = qkv_standard_from_blocked(qkv_w, cfg.n_head, tp_layout)
            qkv_b = qkv_standard_from_blocked(qkv_b, cfg.n_head, tp_layout)
        out[p + "ln_1.weight"] = n(blk["ln1"]["scale"])
        out[p + "ln_1.bias"] = n(blk["ln1"]["bias"])
        out[p + "attn.c_attn.weight"] = n(qkv_w)
        out[p + "attn.c_attn.bias"] = n(qkv_b)
        out[p + "attn.c_proj.weight"] = n(blk["attn"]["proj"]["w"])
        out[p + "attn.c_proj.bias"] = n(blk["attn"]["proj"]["b"])
        out[p + "ln_2.weight"] = n(blk["ln2"]["scale"])
        out[p + "ln_2.bias"] = n(blk["ln2"]["bias"])
        out[p + "mlp.c_fc.weight"] = n(blk["mlp"]["fc"]["w"])
        out[p + "mlp.c_fc.bias"] = n(blk["mlp"]["fc"]["b"])
        out[p + "mlp.c_proj.weight"] = n(blk["mlp"]["proj"]["w"])
        out[p + "mlp.c_proj.bias"] = n(blk["mlp"]["proj"]["b"])
    st.save_file(out, path, metadata={"format": "pt"})
