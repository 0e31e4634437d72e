"""Every ROADMAP.md place the port's ``NotImplementedError`` messages name
exists.

The port refuses what it has not ported yet with a message that names
where ROADMAP.md queues it: ``§N`` (a ``### N.`` heading of its open
items), ``§1, item M`` (a numbered item of §1), ``§1, item Mx`` (a
lettered part ``- **Mx. title**`` of item M), ``§2, K1-K3 still owed,
item M`` (the K1-K3 kernels' "Still owed" list in §2) or a quoted item
or part title. The messages are read from the sources (the string
constants inside each ``NotImplementedError(...)`` call, with the
module-level string constants they name); ROADMAP.md's headings,
numbered items and their lettered parts are parsed, and each named
place must be there. The engine's table of item 8's options is gone
with item 8a: those options are served, and the fleet's two item-9
refusals name their place.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "quintnet_tpu_torch"
PLACE = re.compile(r"§\s*(\d+)(?:,?\s*(?:K1-K3 still owed,\s*)?item\s+"
                   r"(\d+)([a-z]?))?|'([^']+)'")


def _roadmap():
    """(sections {N: text}, §1 item titles {M: title} and lettered part
    titles {"Mx": title}, the K1-K3 still owed items {M: title}) of
    ROADMAP.md's open items."""
    text = (ROOT / "ROADMAP.md").read_text()
    parts = re.split(r"^### (\d+)\. .*$", text, flags=re.M)
    sections = {int(n): body for n, body in zip(parts[1::2], parts[2::2])}
    items = {int(m): t for m, t in re.findall(
        r"^(\d+)\. \*\*(.+?)\*\*", sections.get(1, ""), flags=re.M)}
    items.update({m + x: t for m, x, t in re.findall(
        r"^\s+- \*\*(\d+)([a-z])\. (.+?)\*\*", sections.get(1, ""),
        flags=re.M)})
    k13 = sections.get(2, "").split("- **K4")[0]
    owed = k13.split("Still owed")[-1] if "Still owed" in k13 else ""
    still = {int(m): t for m, t in re.findall(
        r"^\s+(\d+)\. \*\*(.+?)\*\*", owed, flags=re.M)}
    return sections, items, still


def _strings(node, consts):
    """Every string in ``node``'s subtree, module-level string constants
    it names included."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n.value)
        elif isinstance(n, ast.Name) and n.id in consts:
            out.append(consts[n.id])
    return " ".join(out)


def _messages():
    """(file, message) of every NotImplementedError the port builds
    whose text names ROADMAP.md, and the entries of the engine's table
    of items."""
    out = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        consts = {t.id: n.value.value for n in tree.body
                  if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant)
                  and isinstance(n.value.value, str)
                  for t in n.targets if isinstance(t, ast.Name)}
        for n in ast.walk(tree):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id == "NotImplementedError"):
                msg = " ".join(_strings(n, consts).split())
                dynamic = any(isinstance(f, ast.FormattedValue)
                              for f in ast.walk(n))
                # a place filled in at run time comes from a table
                # checked below
                if "ROADMAP" in msg and (_places(msg) or not dynamic):
                    out.append((str(path.relative_to(ROOT)), msg))
    return out


def _places(msg):
    """The places one message names: ("§", N), ("item", N, M) (M an
    int, or "Mx" for a lettered part) and ("title", text)."""
    tail = msg.split("ROADMAP.md", 1)[1]
    tail = tail.split(")")[0] if "(" not in tail.split(")")[0] else tail
    found = []
    for sec, item, part, title in PLACE.findall(tail):
        if title:
            found.append(("title", title))
        elif item:
            owed = "still owed" in tail
            found.append(("owed" if owed else "item", int(sec),
                          item + part if part else int(item)))
        else:
            found.append(("§", int(sec)))
    return found


def test_messages_are_found():
    msgs = _messages()
    files = {f for f, _ in msgs}
    # models/llama.py's HF refusals are served since item 9's HF
    # entries; the fleet's item-9 refusals stand
    for want in ("quintnet_tpu_torch/nn/transformer.py",
                 "quintnet_tpu_torch/ops/flash_kernels.py",
                 "quintnet_tpu_torch/fleet/fleet.py"):
        assert want in files, sorted(files)
    assert all(_places(m) for _, m in msgs), [
        m for _, m in msgs if not _places(m)]


@pytest.mark.parametrize("where,msg", _messages())
def test_every_named_roadmap_place_exists(where, msg):
    sections, items, still = _roadmap()
    titles = list(items.values()) + list(still.values())
    for place in _places(msg):
        if place[0] == "title":
            assert any(t.startswith(place[1]) for t in titles), (
                where, msg, place)
            continue
        assert place[1] in sections, (where, msg, place)
        if place[0] == "item":
            assert place[1] == 1 and place[2] in items, (where, msg, place)
        if place[0] == "owed":
            assert place[1] == 2 and place[2] in still, (where, msg, place)


def test_remat_dots_points_at_the_k1_k3_item():
    """``remat="dots"`` is queued as the K1-K3 kernels' still-owed item
    about it (the message once named a section that no longer exists)."""
    from quintnet_tpu_torch.nn.transformer import REMAT_DOTS_ITEM

    _, _, still = _roadmap()
    (place,) = _places(REMAT_DOTS_ITEM)
    assert place[0] == "owed" and "remat" in still[place[2]]


def test_generation_refusals_name_items_6_and_7():
    """The generation slice's refusals are all served now: vocab-parallel
    decoding (item 6's part 6b), and with the serving meshes (item 7)
    paged Llama decoding, tp paged decoding, MoE GPT-2 serving and the
    engine's ``mesh``/``tp_axis``/``sp_axis``/``ep_axis``, with the rest
    of item 7 the host tier, the weight layouts and the adapters, and
    with item 8a the logger, clock, tracer and recorder. No message
    names them, the engine has no table of options it refuses, and each
    of item 8a's five options is accepted on and off; items 6, 7 and 8
    are still listed in ROADMAP.md."""
    import time

    import torch

    import quintnet_tpu_torch.serve.engine as engine
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    _, items, _ = _roadmap()
    by_file = {}
    for where, msg in _messages():
        by_file.setdefault(where, []).append(msg)
    for where, needle in (
            ("quintnet_tpu_torch/models/llama.py", "llama_block_decode"),
            ("quintnet_tpu_torch/models/llama.py", "Llama serving"),
            ("quintnet_tpu_torch/nn/attention.py", "tp mesh"),
            ("quintnet_tpu_torch/serve/families.py", "MoE GPT-2"),
            ("quintnet_tpu_torch/serve/engine.py", "item 8")):
        assert not [m for m in by_file.get(where, []) if needle in m], (
            where, needle)
    assert not hasattr(engine, "_NOT_PORTED")
    assert not hasattr(engine, "_not_ported")
    cfg = GPT2Config.tiny(n_layer=1)
    p = gpt2_init(torch.Generator().manual_seed(0), cfg)
    for option, value in (("logger", print), ("log_every", 5),
                          ("clock", time.monotonic), ("tracer", object()),
                          ("recorder", object())):
        eng = ServeEngine(gpt2_family(cfg), p, device="cpu",
                          max_seq_len=16, **{option: value})
        assert getattr(eng, option) is value
    assert 6 in items and 7 in items and 8 in items
    assert {"8a", "8b", "8c"} <= set(items)


def test_fleet_refusals_name_item_9():
    """``ServeFleet(lock_audit=True)`` and ``assert_compile_count`` rest on
    the static checks (item 9): each raises ``NotImplementedError``
    naming item 9, which ROADMAP.md lists; so do the process fleet's two
    (``ProcessFleet(lock_audit=True)`` before it spawns anything)."""
    import numpy as np
    import torch

    from quintnet_tpu_torch.fleet import ServeFleet
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    _, items, _ = _roadmap()
    cfg = GPT2Config.tiny(n_layer=1)
    p = gpt2_init(torch.Generator().manual_seed(0), cfg)

    def make():
        return ServeEngine(gpt2_family(cfg), p, device="cpu", max_slots=1,
                           block_size=4, num_blocks=8, max_seq_len=16)

    with pytest.raises(NotImplementedError, match="item 9") as ei:
        ServeFleet(make, n_replicas=1, lock_audit=True)
    assert "lock_audit" in str(ei.value)
    fleet = ServeFleet(make, n_replicas=1)
    try:
        with pytest.raises(NotImplementedError, match="item 9"):
            fleet.assert_compile_count()
        out = fleet.generate([np.arange(3, dtype=np.int32)],
                             max_new_tokens=2, timeout=120)
        assert len(out[0]) == 5
    finally:
        fleet.drain(timeout=60)
    from quintnet_tpu_torch.fleet import ProcessFleet

    with pytest.raises(NotImplementedError, match="item 9") as ei:
        ProcessFleet({"file": "unused.py", "func": "f"}, device="cpu",
                     lock_audit=True)
    assert "lock_audit" in str(ei.value)
    with pytest.raises(NotImplementedError, match="item 9"):
        ProcessFleet.assert_compile_count(ProcessFleet.__new__(ProcessFleet))
    assert 9 in items
    msgs = [m for w, m in _messages()
            if w == "quintnet_tpu_torch/fleet/fleet.py"]
    assert len(msgs) == 2 and all(("item", 1, 9) in _places(m)
                                  for m in msgs)
