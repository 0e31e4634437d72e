"""Versioned wire serialization and length-prefixed framing for the
cross-process fleet.

Port of ``quintnet_tpu/fleet/wire.py``. Everything that crosses a
process boundary in ``fleet/proc.py`` goes through here:

- **payloads**: ``progress_to_wire``/``progress_from_wire`` for
  :class:`~quintnet_tpu_torch.serve.scheduler.RequestProgress` (the
  migration contract: prompt, committed tokens, the sampling seed, the
  adapter binding, the remaining deadline), ``request_to_wire``/
  ``request_from_wire`` for submit payloads, and ``error_to_wire``/
  ``error_from_wire`` for the typed rejections
  (:class:`~quintnet_tpu_torch.fleet.admission.Overloaded`,
  :class:`~quintnet_tpu_torch.serve.scheduler.DeadlineExceeded`, plain
  ``ValueError``/``KeyError``). Every payload carries ``{"kind": ...,
  "v": N}``; a version this build does not speak is refused with an
  actionable :class:`WireVersionError`, never a KeyError three fields
  deep. The port's progress and request frames carry ``seed`` where
  JAX's carry ``key_data``: the port's chain has no evolving state, so
  ``(seed, len(generated))`` is the whole resume state. Each package's
  reader refuses the other's progress frame with a typed
  :class:`WireError` (the missing field named), never a misparse.
- **KV-chain frames**: ``kv_chain_to_wire``/``kv_chain_from_wire``, the
  disaggregated fleet's prefill-to-decode handoff: a published prefix
  chain exported from one replica's pool (int8 blocks and per-block
  scales under a scaled layout) framed with a CRC32, so a corrupted or
  truncated transfer is a typed :class:`WireError` at the importer,
  never wrong KV cached. The frames are byte-equal to JAX's: each array
  rides as its raw bytes (read through a ``uint8`` view of the CPU
  tensor), base64, with its dtype spelled as numpy/ml_dtypes spell it
  (``float32``, ``int8``, ``bfloat16``, ``float8_e4m3fn``): the CRC
  hashes that spelling, so a letter of difference would break the
  checksum across the packages. No ``ml_dtypes`` is needed: the narrow
  types decode straight into torch tensors.
- **framing**: ``send_frame``/``recv_frame``, a 4-byte big-endian
  length prefix and UTF-8 JSON over a stream socket. JSON, not pickle:
  a replica can never make the dispatcher execute code. ``peer=`` names
  the counterparty in every framing error.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# Bump when a payload's schema changes shape. Readers accept exactly
# the versions they know how to decode.
WIRE_VERSION = 1

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 64 * 1024 * 1024  # a corrupt length prefix must not
#                                     allocate gigabytes

# the dtypes of a KV chain's blocks and scales in every pool layout,
# spelled as numpy / ml_dtypes spell them (JAX's frames write
# ``str(np_array.dtype)``)
_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8,
}


class WireError(ValueError):
    """Malformed wire payload (bad kind, missing field, bad frame)."""


class WireVersionError(WireError):
    """Payload version this build does not speak."""


class ConnectionClosed(ConnectionError):
    """The peer closed the stream mid-protocol (or before a frame)."""


# ---------------------------------------------------------------------------
# primitives


def _raw(a) -> Tuple[Dict, bytes]:
    """(``{"dtype", "shape"}``, raw bytes) of a numpy array or a torch
    tensor, the tensor read on the host through a ``uint8`` view."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        meta = {"dtype": str(t.dtype).replace("torch.", ""),
                "shape": list(t.shape)}
        return meta, t.reshape(-1).view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape)}, a.tobytes()


def _enc(a) -> Tuple[Optional[Dict], Optional[bytes]]:
    """(encoded dict, raw bytes), the bytes kept so a checksum hashes
    them directly instead of base64-decoding what was just encoded."""
    if a is None:
        return None, None
    meta, raw = _raw(a)
    return dict(meta, b64=base64.b64encode(raw).decode("ascii")), raw


def _enc_array(a) -> Optional[Dict]:
    return _enc(a)[0]


def _dec_array(d: Optional[Dict]) -> Optional[np.ndarray]:
    if d is None:
        return None
    try:
        raw = base64.b64decode(d["b64"])
        a = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
        return a.reshape(d["shape"]).copy()
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed array payload {d!r}: {e}") from e


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of ``dtype`` (numpy's spelling) over a copy of
    ``raw``."""
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"unknown array dtype {dtype!r}")
    buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8) if raw \
        else torch.empty(0, dtype=torch.uint8)
    return buf.view(_TORCH_DTYPES[dtype]).reshape(shape)


def _check_header(payload: Dict, kind: str,
                  known_versions: Tuple[int, ...] = (WIRE_VERSION,)):
    if not isinstance(payload, dict):
        raise WireError(
            f"expected a {kind!r} payload dict, got {type(payload).__name__}")
    got_kind = payload.get("kind")
    if got_kind != kind:
        raise WireError(
            f"expected payload kind {kind!r}, got {got_kind!r} — the "
            f"frame was routed to the wrong decoder")
    v = payload.get("v")
    if v not in known_versions:
        raise WireVersionError(
            f"{kind} payload version {v!r} is not supported by this "
            f"build (speaks {list(known_versions)}); upgrade the older "
            f"side of the connection — dispatcher and replicas must "
            f"deserialize each other's payloads")


def _require(payload: Dict, kind: str, *fields: str):
    missing = [f for f in fields if f not in payload]
    if missing:
        raise WireError(
            f"{kind} payload (v{payload.get('v')}) is missing required "
            f"field(s) {missing}: {sorted(payload)} present")


# ---------------------------------------------------------------------------
# RequestProgress — the migration contract


def progress_to_wire(p) -> Dict:
    """Serialize a :class:`RequestProgress` (committed tokens only)."""
    return {
        "kind": "request_progress",
        "v": WIRE_VERSION,
        "rid": int(p.rid),
        "prompt": _enc_array(np.asarray(p.prompt, np.int32)),
        "generated": [int(t) for t in p.generated],
        "seed": int(p.seed),
        "max_new_tokens": int(p.max_new_tokens),
        "priority": int(p.priority),
        "preemptions": int(p.preemptions),
        "adapter_id": p.adapter_id,
        "deadline_s": (None if p.deadline_s is None
                       else float(p.deadline_s)),
        "prefilled": int(p.prefilled),
        # observability identity (obs/): optional and inert
        "trace_id": p.trace_id,
    }


def progress_from_wire(payload: Dict):
    from quintnet_tpu_torch.serve.scheduler import RequestProgress

    _check_header(payload, "request_progress")
    _require(payload, "request_progress", "rid", "prompt", "generated",
             "seed", "max_new_tokens")
    try:
        seed = int(payload["seed"])
    except (TypeError, ValueError) as e:
        raise WireError(
            f"request_progress field 'seed' is malformed ({e})") from e
    return RequestProgress(
        rid=int(payload["rid"]),
        prompt=_dec_array(payload["prompt"]),
        generated=[int(t) for t in payload["generated"]],
        seed=seed,
        max_new_tokens=int(payload["max_new_tokens"]),
        priority=int(payload.get("priority", 0)),
        preemptions=int(payload.get("preemptions", 0)),
        adapter_id=payload.get("adapter_id"),
        deadline_s=payload.get("deadline_s"),
        prefilled=int(payload.get("prefilled", 0)),
        trace_id=payload.get("trace_id"))


# ---------------------------------------------------------------------------
# Request — the submit payload


def request_to_wire(req, *, deadline_s: Optional[float] = None) -> Dict:
    """Serialize a :class:`~quintnet_tpu_torch.serve.scheduler.Request`
    submit payload (the callback and engine-runtime fields stay local;
    ``deadline_s`` is the REMAINING budget: clock readings do not
    survive a process boundary)."""
    return {
        "kind": "request",
        "v": WIRE_VERSION,
        "rid": int(req.rid),
        "prompt": _enc_array(np.asarray(req.prompt, np.int32)),
        "max_new_tokens": int(req.max_new_tokens),
        "priority": int(req.priority),
        "seed": int(req.seed),
        "generated": [int(t) for t in req.generated],
        "adapter_id": req.adapter_id,
        "deadline_s": None if deadline_s is None else float(deadline_s),
    }


def request_from_wire(payload: Dict):
    from quintnet_tpu_torch.serve.scheduler import Request

    _check_header(payload, "request")
    _require(payload, "request", "rid", "prompt", "max_new_tokens")
    req = Request(
        rid=int(payload["rid"]),
        prompt=_dec_array(payload["prompt"]),
        max_new_tokens=int(payload["max_new_tokens"]),
        priority=int(payload.get("priority", 0)),
        seed=int(payload.get("seed", payload["rid"])),
        adapter_id=payload.get("adapter_id"))
    req.generated = [int(t) for t in payload.get("generated", [])]
    return req, payload.get("deadline_s")


# ---------------------------------------------------------------------------
# KV-block chain — the disaggregated prefill-to-decode handoff payload


# geometry a KV frame must agree on with the importing pool — a mismatch
# is a deployment error, a typed error at import, never a shape crash
KV_GEOMETRY_FIELDS = ("policy", "block_size", "n_layers", "n_kv_heads",
                      "head_dim")


def kv_chain_checksum(payload: Dict,
                      _decoded: Optional[List] = None,
                      _raw: Optional[List[Dict]] = None) -> int:
    """CRC32 over the frame's header (canonical JSON, minus the checksum
    and the block list) chained with every block's fill, array
    descriptors and RAW bytes, not their base64 spelling: O(chain bytes)
    with no re-serialization. ``_decoded`` (:func:`kv_chain_from_wire`)
    collects each block's tensors as they are decoded for hashing, and
    ``_raw`` (:func:`kv_chain_to_wire`) supplies the bytes the encoder
    just serialized, so each side makes one pass over the chain."""
    head = {k: v for k, v in payload.items()
            if k not in ("crc32", "blocks")}
    crc = zlib.crc32(json.dumps(head, sort_keys=True,
                                separators=(",", ":")).encode("utf-8"))
    for i, b in enumerate(payload.get("blocks", ())):
        if not isinstance(b, dict):
            raise WireError(
                f"kv_chain block entry is {type(b).__name__}, "
                f"expected a dict — cannot checksum the frame")
        try:
            fill = int(b.get("fill", -1))
        except (TypeError, ValueError) as e:
            # a null or non-numeric fill from a buggy peer: typed, never
            # a TypeError that reads as a replica death
            raise WireError(
                f"kv_chain block field 'fill' is malformed ({e}) — "
                f"cannot checksum the frame") from e
        crc = zlib.crc32(str(fill).encode("ascii"), crc)
        rec = {"fill": fill} if _decoded is not None else None
        raws = _raw[i] if _raw is not None else None
        for key in ("k", "v", "k_scale", "v_scale"):
            d = b.get(key)
            if d is None:
                crc = zlib.crc32(b"\x00none", crc)
                if rec is not None:
                    rec[key] = None
                continue
            try:
                meta = json.dumps({"dtype": d["dtype"],
                                   "shape": d["shape"]},
                                  sort_keys=True,
                                  separators=(",", ":"))
                raw = (raws[key] if raws is not None
                       else base64.b64decode(d["b64"]))
                if rec is not None:
                    rec[key] = _tensor(raw, d["dtype"], d["shape"])
            except (KeyError, TypeError, ValueError, RuntimeError) as e:
                raise WireError(
                    f"kv_chain block field {key!r} is malformed "
                    f"({e}) — cannot checksum the frame") from e
            crc = zlib.crc32(meta.encode("utf-8"), crc)
            crc = zlib.crc32(raw, crc)
        if rec is not None:
            _decoded.append(rec)
    return crc & 0xFFFFFFFF


def kv_chain_wire_size(payload: Dict) -> int:
    """Conservative OVER-estimate of a KV-chain frame's byte size,
    without serializing it (the base64 strings dominate)."""
    size = 4096
    tokens = payload.get("tokens")
    if isinstance(tokens, dict):
        size += len(tokens.get("b64", "")) + 256
    for b in payload.get("blocks", ()):
        size += 512
        for key in ("k", "v", "k_scale", "v_scale"):
            d = b.get(key)
            if isinstance(d, dict):
                size += len(d.get("b64", "")) + 256
    return size


def kv_chain_fits(payload: Dict) -> bool:
    """Would this frame fit under :data:`MAX_FRAME_BYTES`? The EXPORTER
    checks before shipping: an oversized frame would trip the receiver's
    length guard and read as a dead connection. Declining instead lets
    the handoff take its fallback (local re-prefill: slower, never
    wrong)."""
    return kv_chain_wire_size(payload) <= MAX_FRAME_BYTES


def kv_chain_to_wire(chain: Dict, *,
                     namespace: Optional[str] = None) -> Dict:
    """Serialize one exported chain (:meth:`KVPool.export_chain`): the
    covered token prefix, the pool geometry, each block's slot data (and
    its scale rows under a scaled layout) as raw bytes — int8 blocks
    ship as int8 — and a CRC32 the importer verifies."""
    blocks, raw_blocks = [], []
    for b in chain["blocks"]:
        rec, raws = {"fill": int(b["fill"])}, {}
        for key in ("k", "v", "k_scale", "v_scale"):
            # k/v are mandatory; scales exist under scaled layouts only
            a = b[key] if key in ("k", "v") else b.get(key)
            rec[key], raws[key] = _enc(a)
        blocks.append(rec)
        raw_blocks.append(raws)
    payload = {
        "kind": "kv_chain",
        "v": WIRE_VERSION,
        "namespace": namespace,
        "n_tokens": int(chain["n_tokens"]),
        "tokens": _enc_array(np.asarray(chain["tokens"], np.int32)),
        "policy": str(chain["policy"]),
        "block_size": int(chain["block_size"]),
        "n_layers": int(chain["n_layers"]),
        "n_kv_heads": int(chain["n_kv_heads"]),
        "head_dim": int(chain["head_dim"]),
        "blocks": blocks,
    }
    payload["crc32"] = kv_chain_checksum(payload, _raw=raw_blocks)
    return payload


def kv_chain_from_wire(payload: Dict) -> Tuple[Dict, Optional[str]]:
    """Decode and VERIFY one KV-chain frame; returns ``(chain,
    namespace)`` in :meth:`KVPool.import_chain` shape, each record's
    arrays CPU tensors. A checksum mismatch is a typed
    :class:`WireError`: the importer discards the frame and the handoff
    retries or re-prefills locally (the chain is cache)."""
    _check_header(payload, "kv_chain")
    _require(payload, "kv_chain", "crc32", "tokens", "n_tokens",
             "blocks", *KV_GEOMETRY_FIELDS)
    if not isinstance(payload["blocks"], list) or not payload["blocks"]:
        raise WireError("kv_chain payload carries no blocks")
    for b in payload["blocks"]:
        if not isinstance(b, dict):
            raise WireError(
                f"kv_chain block entry is {type(b).__name__}, "
                f"expected a dict")
        _require(b, "kv_chain block", "fill", "k", "v")
    want = payload["crc32"]
    blocks: List = []
    got = kv_chain_checksum(payload, _decoded=blocks)
    if got != want:
        raise WireError(
            f"kv_chain checksum mismatch (frame says {want:#010x}, "
            f"payload hashes to {got:#010x}) — the KV transfer was "
            f"corrupted in flight; discarding the frame (the handoff "
            f"retries or the decode replica re-prefills locally)")
    try:
        chain = {
            "n_tokens": int(payload["n_tokens"]),
            "tokens": _dec_array(payload["tokens"]),
            "policy": payload["policy"],
            "block_size": int(payload["block_size"]),
            "n_layers": int(payload["n_layers"]),
            "n_kv_heads": int(payload["n_kv_heads"]),
            "head_dim": int(payload["head_dim"]),
            "blocks": blocks,
        }
    except WireError:
        raise
    except (TypeError, ValueError) as e:
        # null geometry from a buggy peer checksums consistently (the
        # peer hashed the same nulls), so it reaches here: typed
        raise WireError(
            f"kv_chain geometry field is malformed ({e}); "
            f"discarding the frame") from e
    return chain, payload.get("namespace")


# ---------------------------------------------------------------------------
# typed errors (shed / deadline / request-scoped rejections)


def error_to_wire(e: BaseException) -> Dict:
    from quintnet_tpu_torch.fleet.admission import Overloaded
    from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded

    out = {"kind": "error", "v": WIRE_VERSION, "message": str(e)}
    if isinstance(e, Overloaded):
        out["type"] = "overloaded"
        out["reason"] = e.reason
    elif isinstance(e, DeadlineExceeded):
        out["type"] = "deadline_exceeded"
        out["rid"] = getattr(e, "rid", None)
        out["generated"] = getattr(e, "generated", 0)
    elif isinstance(e, WireError):
        # a damaged frame is TRANSIENT (the handoff re-exports); a plain
        # ValueError (geometry mismatch, evicted chain) is permanent
        out["type"] = "wire_error"
    elif isinstance(e, KeyError):
        out["type"] = "key_error"
    else:
        # ValueError and anything else request-scoped: the receiver
        # re-raises a ValueError with the original message
        out["type"] = "value_error"
    return out


def error_from_wire(payload: Dict) -> BaseException:
    from quintnet_tpu_torch.fleet.admission import Overloaded
    from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded

    _check_header(payload, "error")
    _require(payload, "error", "type", "message")
    t, msg = payload["type"], payload["message"]
    if t == "overloaded":
        return Overloaded(payload.get("reason", "shutdown"), msg)
    if t == "deadline_exceeded":
        return DeadlineExceeded(msg, rid=payload.get("rid"),
                                generated=int(payload.get("generated", 0)))
    if t == "wire_error":
        return WireError(msg)
    if t == "key_error":
        return KeyError(msg)
    return ValueError(msg)


# ---------------------------------------------------------------------------
# framing


def send_frame(sock, obj: Dict) -> None:
    """One length-prefixed JSON frame. The caller serializes access:
    two threads interleaving sendall() would corrupt the stream."""
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


def _peer_name(peer: Optional[str]) -> str:
    return repr(peer) if peer else "peer"


def _recv_exact(sock, n: int, *, peer: Optional[str] = None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionClosed(
                f"{_peer_name(peer)} closed the connection mid-frame "
                f"({len(buf)}/{n} bytes received)")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock, *, peer: Optional[str] = None) -> Dict:
    """Blocking read of one frame; :class:`ConnectionClosed` on EOF (a
    SIGKILLed peer looks like EOF after the kernel flushes what it had
    buffered: the dispatcher drains those frames first, which keeps the
    token journal complete). A truncated frame, a corrupt length prefix
    or non-JSON bytes are typed errors naming ``peer``."""
    head = sock.recv(_LEN.size)
    if not head:
        raise ConnectionClosed(
            f"{_peer_name(peer)} closed the connection")
    if len(head) < _LEN.size:
        head += _recv_exact(sock, _LEN.size - len(head), peer=peer)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise WireError(
            f"frame length {n} from {_peer_name(peer)} exceeds "
            f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES}) — corrupt length "
            f"prefix or a desynchronized stream")
    try:
        return json.loads(_recv_exact(sock, n, peer=peer)
                          .decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise WireError(
            f"frame from {_peer_name(peer)} is not valid JSON "
            f"(flipped bits or a desynchronized stream): {e}") from e
