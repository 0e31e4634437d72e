"""The port's wire protocol (``quintnet_tpu_torch/fleet/wire.py``)
against the JAX package's (``quintnet_tpu/fleet/wire.py``).

THE contract, JAX's (``tests/test_fleet_wire.py``): everything a
cross-process migration needs round-trips through versioned JSON
payloads exactly — prompt and committed tokens, the sampling seed (the
port's whole chain state, where JAX's frames carry the evolved key), the
adapter binding, the remaining deadline — and a payload of another
version, kind or shape is refused typed, naming what is wrong. Beside
it, across the packages: KV-chain frames byte-equal to JAX's as JSON in
every pool layout (f32, fake_quant, int8, bf16, fp8), a JAX frame
decoded by the port and imported into a port pool exporting the same
records and frame again, error frames equal, and JAX's reader refusing
a port progress frame with a typed error instead of misparsing it.
"""

import json
import re
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.fleet import Overloaded as JaxOverloaded
from quintnet_tpu.fleet import wire as jwire
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import DeadlineExceeded as JaxDeadlineExceeded
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve.kv_pool import KVPool as JaxKVPool
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.fleet import Overloaded
from quintnet_tpu_torch.fleet import wire
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.serve import ServeEngine, SpecConfig, gpt2_family
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.scheduler import (DeadlineExceeded, Request,
                                                RequestProgress)

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
LAYOUTS = ("f32", "fake_quant", "int8", "bf16", "fp8")


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _progress(**over):
    base = dict(
        rid=7, prompt=np.asarray([3, 1, 4, 1, 5], np.int32),
        generated=[9, 2, 6], seed=11, max_new_tokens=12, priority=2,
        preemptions=1, adapter_id="tenant-a", deadline_s=3.25)
    base.update(over)
    return RequestProgress(**base)


# ---------------------------------------------------------------------
# RequestProgress
# ---------------------------------------------------------------------

def test_progress_all_fields_survive_json():
    p = _progress(prefilled=4, trace_id="f7")
    q = wire.progress_from_wire(
        json.loads(json.dumps(wire.progress_to_wire(p))))
    assert q.rid == 7 and q.max_new_tokens == 12
    assert q.priority == 2 and q.preemptions == 1
    assert q.adapter_id == "tenant-a" and q.trace_id == "f7"
    assert q.deadline_s == pytest.approx(3.25) and q.prefilled == 4
    assert q.generated == [9, 2, 6] and q.seed == 11
    np.testing.assert_array_equal(q.prompt, p.prompt)
    assert q.prompt.dtype == np.int32


def test_progress_optional_fields_none():
    q = wire.progress_from_wire(wire.progress_to_wire(
        _progress(adapter_id=None, deadline_s=None)))
    assert q.adapter_id is None and q.deadline_s is None


def _jax_progress():
    from quintnet_tpu.serve.scheduler import \
        RequestProgress as JaxRequestProgress

    return JaxRequestProgress(
        rid=7, prompt=np.asarray([3, 1, 4, 1, 5], np.int32),
        generated=[9, 2, 6],
        key_data=np.asarray(jax.random.key_data(jax.random.key(11))),
        max_new_tokens=12, priority=2, preemptions=1,
        adapter_id="tenant-a", deadline_s=3.25)


@pytest.mark.parametrize("case", ["unknown_version", "missing_version",
                                  "wrong_kind", "missing_field",
                                  "malformed_array"])
def test_progress_refusals_typed_and_equal_to_jax(case):
    """Each malformed progress payload is refused typed, with JAX's
    message: a version this build does not speak names both versions, a
    missing field is named (the port's ``seed`` where JAX names
    ``key_data``), a bad array is a WireError, never a KeyError."""
    def damage(payload):
        if case == "unknown_version":
            payload["v"] = 99
        elif case == "missing_version":
            del payload["v"]
        elif case == "wrong_kind":
            payload["kind"] = "request"
        elif case == "missing_field":
            del payload["seed" if "seed" in payload else "key_data"]
        else:
            payload["prompt"] = {"dtype": "int32", "b64": "!!!"}
        return payload

    jp = _jax_progress()
    with pytest.raises(wire.WireError) as ei:
        wire.progress_from_wire(damage(wire.progress_to_wire(_progress())))
    with pytest.raises(jwire.WireError) as ej:
        jwire.progress_from_wire(damage(jwire.progress_to_wire(jp)))
    assert type(ei.value).__name__ == type(ej.value).__name__
    want = {"unknown_version": "version 99.*not supported.*upgrade",
            "missing_version": "None", "wrong_kind": "wrong decoder",
            "missing_field": "missing required field.*seed",
            "malformed_array": "malformed array"}[case]
    assert re.search(want, str(ei.value))
    if case == "missing_field":
        assert "key_data" in str(ej.value)
    else:
        assert str(ei.value) == str(ej.value)


def test_jax_reader_refuses_a_port_progress_frame_typed():
    """The two packages' resume states differ (seed against evolved key):
    each reader refuses the other's progress frame with a typed
    WireError naming the missing field, never a misparse."""
    port_frame = json.loads(json.dumps(wire.progress_to_wire(_progress())))
    with pytest.raises(jwire.WireError, match=r"missing.*key_data"):
        jwire.progress_from_wire(port_frame)
    jax_frame = json.loads(json.dumps(
        jwire.progress_to_wire(_jax_progress())))
    with pytest.raises(wire.WireError, match=r"missing.*seed"):
        wire.progress_from_wire(jax_frame)
    # every other field is spelled as JAX spells it
    assert set(port_frame) - {"seed"} == set(jax_frame) - {"key_data"}
    assert {k: port_frame[k] for k in port_frame if k != "seed"} == \
        {k: jax_frame[k] for k in jax_frame if k != "key_data"}


# ---------------------------------------------------------------------
# Request
# ---------------------------------------------------------------------

def test_request_submit_payload_survives():
    req = Request(rid=4, prompt=np.asarray([5, 6, 7], np.int32),
                  max_new_tokens=9, priority=1, seed=3,
                  adapter_id="tenant-b")
    req.generated = [11, 12]
    out, deadline_s = wire.request_from_wire(json.loads(
        json.dumps(wire.request_to_wire(req, deadline_s=1.5))))
    assert out.rid == 4 and out.max_new_tokens == 9
    assert out.priority == 1 and out.adapter_id == "tenant-b"
    assert out.generated == [11, 12] and out.seed == 3
    assert deadline_s == pytest.approx(1.5)
    np.testing.assert_array_equal(out.prompt, req.prompt)


def test_request_version_gate():
    req = Request(rid=0, prompt=np.asarray([1], np.int32),
                  max_new_tokens=1)
    payload = wire.request_to_wire(req)
    payload["v"] = 2
    with pytest.raises(wire.WireVersionError):
        wire.request_from_wire(payload)


# ---------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------

def _error_pairs():
    return [
        (Overloaded("queue_full", "nope"),
         JaxOverloaded("queue_full", "nope")),
        (Overloaded("deadline", "late"), JaxOverloaded("deadline", "late")),
        (Overloaded("shutdown", "bye"), JaxOverloaded("shutdown", "bye")),
        (DeadlineExceeded("late", rid=5, generated=7),
         JaxDeadlineExceeded("late", rid=5, generated=7)),
        (wire.WireError("checksum mismatch"),
         jwire.WireError("checksum mismatch")),
        (ValueError("bad prompt"), ValueError("bad prompt")),
        (KeyError("tenant-z"), KeyError("tenant-z")),
    ]


@pytest.mark.parametrize("i", range(7))
def test_error_frames_round_trip_and_equal_jax(i):
    """Each typed error crosses as JAX's frame (the same JSON text), and
    comes back with its type and fields: Overloaded keeps its reason,
    DeadlineExceeded its token count, a WireError stays a WireError (the
    handoff retries a damaged frame and not a plain ValueError)."""
    e, je = _error_pairs()[i]
    frame = json.dumps(wire.error_to_wire(e))
    assert frame == json.dumps(jwire.error_to_wire(je))
    back = wire.error_from_wire(json.loads(frame))
    assert type(back) is type(e)
    assert str(e).strip("'") in str(back)
    if isinstance(e, Overloaded):
        assert back.reason == e.reason
    if isinstance(e, DeadlineExceeded):
        assert back.generated == 7


# ---------------------------------------------------------------------
# KV-chain frames
# ---------------------------------------------------------------------

def _chain(policy="int8"):
    pool = KVPool(n_layers=2, n_kv_heads=2, head_dim=4, block_size=4,
                  num_blocks=8, policy=policy, device="cpu")
    toks = np.arange(10, dtype=np.int32)
    blocks = pool.acquire(3)
    for i, b in enumerate(blocks):
        pool.k[:, b * 4:(b + 1) * 4] = i + 1
        if pool.policy.scaled:
            pool.k_scale[:, b] = 0.25 * (i + 1)
    pool.publish(toks, blocks, 10)
    pool.release(blocks)
    return pool, pool.export_chain(toks), toks


def test_kv_round_trip_through_json_bit_exact():
    _pool, chain, toks = _chain("int8")
    payload = json.loads(json.dumps(
        wire.kv_chain_to_wire(chain, namespace="tenant-a")))
    got, ns = wire.kv_chain_from_wire(payload)
    assert ns == "tenant-a"
    assert got["n_tokens"] == 10 and got["policy"] == "int8"
    np.testing.assert_array_equal(got["tokens"], toks)
    for a, b in zip(chain["blocks"], got["blocks"]):
        assert a["fill"] == b["fill"]
        assert torch.equal(a["k"], b["k"]) and b["k"].dtype == torch.int8
        assert torch.equal(a["k_scale"], b["k_scale"])
    dst = KVPool(n_layers=2, n_kv_heads=2, head_dim=4, block_size=4,
                 num_blocks=8, policy="int8", device="cpu")
    assert dst.import_chain(got, namespace=ns) == 10
    assert dst.lookup(toks, max_tokens=8,
                      namespace=ns).cached_tokens == 8


@pytest.mark.parametrize("damage", ["payload_bit", "geometry"])
def test_kv_flipped_bits_fail_checksum_typed(damage):
    _pool, chain, _toks = _chain()
    payload = wire.kv_chain_to_wire(chain)
    if damage == "payload_bit":
        b64 = payload["blocks"][1]["v"]["b64"]
        payload["blocks"][1]["v"]["b64"] = \
            ("A" if b64[0] != "A" else "B") + b64[1:]
    else:
        payload["n_kv_heads"] = 7
    with pytest.raises(wire.WireError, match="checksum mismatch"):
        wire.kv_chain_from_wire(payload)


def test_kv_missing_field_named_not_keyerror():
    _pool, chain, _toks = _chain()
    payload = wire.kv_chain_to_wire(chain)
    del payload["n_tokens"]
    with pytest.raises(wire.WireError, match="n_tokens"):
        wire.kv_chain_from_wire(payload)


def test_kv_null_fill_is_typed_not_typeerror():
    _pool, chain, _toks = _chain()
    payload = wire.kv_chain_to_wire(chain)
    payload["blocks"][0]["fill"] = None
    with pytest.raises(wire.WireError, match="fill"):
        wire.kv_chain_from_wire(payload)
    payload["blocks"][0]["fill"] = "x"
    with pytest.raises(wire.WireError, match="fill"):
        wire.kv_chain_from_wire(payload)


def test_kv_null_geometry_is_typed_not_typeerror():
    _pool, chain, _toks = _chain()
    payload = wire.kv_chain_to_wire(chain)
    payload["n_tokens"] = None
    payload["crc32"] = wire.kv_chain_checksum(payload)
    with pytest.raises(wire.WireError, match="geometry"):
        wire.kv_chain_from_wire(payload)


def test_kv_wire_size_estimate_is_conservative():
    _pool, chain, _toks = _chain("int8")
    payload = wire.kv_chain_to_wire(chain, namespace="tenant-a")
    actual = len(json.dumps(payload, separators=(",", ":")).encode())
    assert wire.kv_chain_wire_size(payload) >= actual
    assert wire.kv_chain_fits(payload)
    big = dict(payload, blocks=payload["blocks"] * 40000)
    assert not wire.kv_chain_fits(big)


def test_kv_geometry_mismatch_rejected_at_import():
    _pool, chain, _toks = _chain("f32")
    dst = KVPool(n_layers=2, n_kv_heads=2, head_dim=4, block_size=4,
                 num_blocks=8, policy="int8", device="cpu")
    with pytest.raises(ValueError, match="does not match this pool"):
        dst.import_chain(chain)


def _same_chain_both_pools(policy, seed=0):
    """The same values published under the same tokens in the port's
    pool and JAX's (distinct payloads a block, distinct scales)."""
    geo = dict(n_layers=2, n_kv_heads=2, head_dim=4, block_size=4,
               num_blocks=8, policy=policy)
    tpool, jpool = KVPool(**geo, device="cpu"), JaxKVPool(**geo)
    toks = np.arange(10, dtype=np.int32)
    blocks = tpool.acquire(3)
    assert jpool.acquire(3) == blocks
    rng = np.random.default_rng(seed)
    jk, jv, jks, jvs = jpool.k, jpool.v, jpool.k_scale, jpool.v_scale
    shape = (2, 4, 2, 4)
    for b in blocks:
        sl = slice(b * 4, (b + 1) * 4)
        k = rng.integers(-60, 60, shape).astype(np.float32) / 8
        v = rng.integers(-60, 60, shape).astype(np.float32) / 8
        tpool.k[:, sl] = torch.tensor(k).to(tpool.k.dtype)
        tpool.v[:, sl] = torch.tensor(v).to(tpool.v.dtype)
        jk = jk.at[:, sl].set(k.astype(jk.dtype))
        jv = jv.at[:, sl].set(v.astype(jv.dtype))
        if tpool.policy.scaled:
            s = rng.uniform(0.5, 2.0, (2, 2, 2)).astype(np.float32)
            tpool.k_scale[:, b] = torch.tensor(s[0])
            tpool.v_scale[:, b] = torch.tensor(s[1])
            jks, jvs = jks.at[:, b].set(s[0]), jvs.at[:, b].set(s[1])
    jpool.update(jk, jv, *((jks, jvs) if jpool.policy.scaled else ()))
    for pool in (tpool, jpool):
        pool.publish(toks, blocks, 10, namespace="t")
        pool.release(blocks)
    return tpool, jpool, toks


@pytest.mark.parametrize("policy", LAYOUTS)
def test_kv_frames_byte_equal_to_jax_in_every_layout(policy):
    """The same chain in both packages' pools frames to the same JSON
    text, CRC included: the dtype spellings (``bfloat16``,
    ``float8_e4m3fn``, ...), the raw bytes and the key order agree."""
    tpool, jpool, toks = _same_chain_both_pools(policy)
    tf = json.dumps(wire.kv_chain_to_wire(
        tpool.export_chain(toks, namespace="t"), namespace="t"))
    jf = json.dumps(jwire.kv_chain_to_wire(
        jpool.export_chain(toks, namespace="t"), namespace="t"))
    assert tf == jf
    # and each package verifies the other's frame
    chain, ns = jwire.kv_chain_from_wire(json.loads(tf))
    assert ns == "t" and chain["n_tokens"] == 10


@pytest.mark.parametrize("kv", LAYOUTS)
def test_jax_engine_frame_imports_into_the_port_and_frames_back(params,
                                                                kv):
    """A JAX engine's exported chain (the tiny GPT-2 on bridged weights),
    framed by JAX, decoded by the port and imported into a port engine's
    pool: the port's own export gives the same records and frames them
    to JAX's JSON text; the port engine then serves the prompt warm
    (the imported positions are prefix hits), greedy equal to JAX's."""
    jp, tp = params
    prompt = np.arange(3, 13, dtype=np.int32)
    kw = dict(max_slots=2, block_size=4, num_blocks=24, max_seq_len=40,
              kv_dtype=kv)
    je = JaxServeEngine(jax_gpt2_family(JCFG), jp, **kw)
    jr = je.submit(prompt, 4)
    je.run()
    jframe = json.dumps(jwire.kv_chain_to_wire(je.export_kv_chain(prompt)))
    chain, ns = wire.kv_chain_from_wire(json.loads(jframe))
    te = ServeEngine(gpt2_family(CFG), tp, device="cpu", **kw)
    assert chain["n_tokens"] == 8       # the prompt's two whole blocks
    assert te.import_kv_chain(chain, namespace=ns) == 8
    back = te.export_kv_chain(prompt)
    for a, b in zip(chain["blocks"], back["blocks"]):
        assert a["fill"] == b["fill"]
        for f in ("k", "v", "k_scale", "v_scale"):
            assert (a[f] is None) == (b.get(f) is None)
            if a[f] is not None:
                assert torch.equal(a[f].view(torch.uint8),
                                   b[f].view(torch.uint8))
    assert json.dumps(wire.kv_chain_to_wire(back)) == jframe
    tr = te.submit(prompt, 4)
    te.run()
    assert te.metrics.prefix_hit_tokens == 8
    if kv in ("f32", "fake_quant"):
        np.testing.assert_array_equal(te.result(tr), je.result(jr))


# ---------------------------------------------------------------------
# framing faults: typed, naming the peer; a replica's death, not the
# fleet's
# ---------------------------------------------------------------------

def test_truncated_frame_mid_body_names_peer():
    a, b = socket.socketpair()
    try:
        data = json.dumps({"t": "hb"}).encode()
        a.sendall(len(data).to_bytes(4, "big") + data[:3])
        a.close()
        with pytest.raises(wire.ConnectionClosed,
                           match=r"'decode0'.*mid-frame"):
            wire.recv_frame(b, peer="decode0")
    finally:
        b.close()


@pytest.mark.parametrize("peer", ["prefill0", None])
def test_oversized_length_prefix_rejected(peer):
    a, b = socket.socketpair()
    try:
        a.sendall((wire.MAX_FRAME_BYTES + 1).to_bytes(4, "big"))
        with pytest.raises(wire.WireError,
                           match=(r"'prefill0'.*MAX_FRAME_BYTES" if peer
                                  else "length")):
            wire.recv_frame(b, peer=peer)
    finally:
        a.close()
        b.close()


def test_flipped_bits_in_body_are_typed_not_decode_crash():
    a, b = socket.socketpair()
    try:
        garbage = b"\xff\xfe{not json"
        a.sendall(len(garbage).to_bytes(4, "big") + garbage)
        with pytest.raises(wire.WireError, match=r"'p1'.*not valid JSON"):
            wire.recv_frame(b, peer="p1")
    finally:
        a.close()
        b.close()


def test_reader_thread_turns_wire_fault_into_replica_death():
    """The real ``ProcReplica._read_loop`` over a socketpair fed one good
    frame and then garbage: the good frame is handled, the fault becomes
    that replica's death, pending RPCs are woken, the thread ends."""
    from quintnet_tpu_torch.fleet.proc import ProcReplica

    class FakeFleet:
        def __init__(self):
            self.dead, self.frames = [], []

        def _on_frame(self, rep, frame):
            self.frames.append(frame)

        def _on_conn_lost(self, rep):
            self.dead.append(rep.name)

    a, b = socket.socketpair()
    rep = ProcReplica.__new__(ProcReplica)       # no spawn
    rep.name = "decode1"
    rep.fleet = FakeFleet()
    rep.sock = b
    rep._pending = {}
    rep._send_lock = threading.Lock()
    ev = threading.Event()
    rep._pending[1] = (ev, {})
    try:
        t = threading.Thread(target=rep._read_loop, daemon=True)
        t.start()
        wire.send_frame(a, {"t": "hb", "steps": 1})
        garbage = b"\x00garbage\xff"
        a.sendall(len(garbage).to_bytes(4, "big") + garbage)
        t.join(timeout=10.0)
        assert not t.is_alive(), "reader wedged on a wire fault"
        assert rep.fleet.frames == [{"t": "hb", "steps": 1}]
        assert rep.fleet.dead == ["decode1"]
        assert ev.is_set() and rep._pending == {}
    finally:
        a.close()
        b.close()


def test_frames_round_trip_over_a_socket():
    a, b = socket.socketpair()
    try:
        frames = [{"t": "hb", "steps": 3},
                  {"t": "submit",
                   "progress": wire.progress_to_wire(_progress())}]

        def sender():
            for f in frames:
                wire.send_frame(a, f)
            a.close()

        t = threading.Thread(target=sender)
        t.start()
        got = [wire.recv_frame(b), wire.recv_frame(b)]
        assert got[0] == {"t": "hb", "steps": 3}
        assert wire.progress_from_wire(got[1]["progress"]).adapter_id == \
            "tenant-a"
        with pytest.raises(wire.ConnectionClosed):
            wire.recv_frame(b)
        t.join(timeout=10)
    finally:
        b.close()


# ---------------------------------------------------------------------
# the payload does its job across engines
# ---------------------------------------------------------------------

def test_export_json_restore_token_identical(params, rng):
    """Progress exported from a speculating sampled engine, pushed
    through JSON text and restored on a FRESH engine, continues token
    for token the port's ``gpt2_generate`` at each request's seed; the
    deadline is re-anchored on the restorer's clock."""
    _jp, tp = params

    def make(spec=None):
        return ServeEngine(gpt2_family(CFG), tp, device="cpu",
                           max_slots=2, block_size=4, num_blocks=32,
                           max_seq_len=40, temperature=0.8, top_k=5,
                           spec=spec)

    src = make(spec=SpecConfig())
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
               for n in (5, 7)]
    seeds = [40, 41]
    rids = [src.submit(p, 16, seed=s, deadline_s=120.0)
            for p, s in zip(prompts, seeds)]
    for _ in range(5):
        src.step()
    payloads = [json.loads(json.dumps(wire.progress_to_wire(p)))
                for p in src.export_progress()]
    assert payloads, "exporter finished too fast to export"
    dst = make()
    out = {}
    for payload in payloads:
        prog = wire.progress_from_wire(payload)
        assert len(prog.generated) < prog.max_new_tokens
        assert 0 < prog.deadline_s <= 120.0
        out[prog.rid] = dst.restore_progress(prog)
    dst.run(max_steps=500)
    for rid, p, s in zip(rids, prompts, seeds):
        oracle = gpt2_generate(tp, p[None], CFG, max_new_tokens=16,
                               temperature=0.8, top_k=5, seed=s)[0]
        got = dst.result(out[rid]) if rid in out else src.result(rid)
        np.testing.assert_array_equal(got, np.asarray(oracle))
