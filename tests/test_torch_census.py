"""The port's collective census against JAX's expected-census specs.

Every collective of the port passes through ``core/collectives.
communicate``, which counts ``{axis: {op: n}}`` while a census is open
(``analysis/step_audit.collective_census``), backward collectives
included. One spawned gloo world per mesh shape runs several programs
each (``tests/_torch_census_cases.py``): the train steps of dp, ZeRO-1,
ZeRO-2, dp x tp and 3D 1F1B, JAX's tp layer goldens, and the serving
programs under tp (f32, int8 KV, int8 weights), ep, ep x tp and sp.

Each census equals JAX's ``quintnet_tpu.analysis.specs.expected_*`` with
the same arguments — the parameter-leaf counts read from the port's own
param specs and held equal to JAX's on the same config — and the port's
own ``analysis/specs.py``. Where the port puts a different count on the
wire (the 3D step's tp sums over the rank's own stage, the sp ring's
shifts), the port's formula derives that term and the test holds it,
with every other term still JAX's. With the counter off the losses are
bit-equal to a counted run.
"""

import jax
import numpy as np
import pytest

from _torch_census_cases import census_world_case
from _torch_dist import run_world
from quintnet_tpu.analysis import specs as jax_specs
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_model_spec as jax_vit_spec
from quintnet_tpu.parallel.strategy import get_strategy as jax_get_strategy
from quintnet_tpu_torch.analysis import specs
from quintnet_tpu_torch.serve import SpecConfig

VIT = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
           depth=4, num_heads=2, num_classes=10)
DENSE = dict(n_layer=2)
MOE = dict(n_layer=2, n_experts=4, expert_top_k=2)
ENGINE = dict(max_slots=3, block_size=4, num_blocks=24, max_seq_len=32)
ADAMW = {"optimizer": "adamw"}
ONE_F_ONE_B = {"optimizer": "adamw", "gradient_accumulation_steps": 2,
               "schedule": "1f1b"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (16, 16)).astype(np.int64)
    return {
        "ids": ids,
        "vit": _np_tree(jax_vit_init(jax.random.key(0),
                                     JaxViTConfig(**VIT))),
        "dense": _np_tree(jax_gpt2_init(jax.random.key(0),
                                        JaxGPT2Config.tiny(**DENSE))),
        "moe": _np_tree(jax_gpt2_init(jax.random.key(0),
                                      JaxGPT2Config.tiny(**MOE))),
        "x": rng.standard_normal((8, 14, 14, 1)).astype(np.float32),
        "y": rng.integers(0, 10, (8,)).astype(np.int64),
    }


def _train(trees, sizes, training):
    return ("train", sizes, ("vit", VIT, trees["vit"], trees["x"],
                             trees["y"], training))


def _gpt2_train(trees, sizes, training):
    return ("train", sizes, ("gpt2", DENSE, trees["dense"], trees["ids"],
                             trees["ids"], training))


# chip_smoke.py's mesh runs of the census, at a tiny width: GPT-2 on
# dp x tp with 2 micro-batches, dp x pp 1F1B-stored with ZeRO-2 and
# dp x tp x pp 1F1B with ZeRO-1, 4 micro-batches
DPTP_MICRO2 = {"optimizer": "adamw", "gradient_accumulation_steps": 2}
DPPP_ZERO2 = {"optimizer": "zero2_adamw", "gradient_accumulation_steps": 4,
              "schedule": "1f1b_stored"}
THREED_ZERO1 = {"optimizer": "zero1_adamw",
                "gradient_accumulation_steps": 4, "schedule": "1f1b"}


def _serve(tree, cfg_kw, sizes, **engine):
    return ("serve", sizes, ("gpt2", cfg_kw, tree, dict(ENGINE, **engine)))


@pytest.fixture(scope="module")
def world2(trees, tmp_path_factory):
    jobs = {
        "dp": _train(trees, {"dp": 2}, ADAMW),
        "zero1": _train(trees, {"dp": 2}, {"optimizer": "zero1_adamw"}),
        "zero2": _train(trees, {"dp": 2}, {"optimizer": "zero2_adamw"}),
        "tp_layer": ("tp_layer", {"tp": 2}, ()),
        "serve_tp": _serve(trees["dense"], DENSE, {"tp": 2}, tp_axis="tp",
                           spec=SpecConfig()),
        "serve_tp_int8_kv": _serve(trees["dense"], DENSE, {"tp": 2},
                                   tp_axis="tp", kv_dtype="int8",
                                   spec=SpecConfig()),
        "serve_tp_int8_w": _serve(trees["dense"], DENSE, {"tp": 2},
                                  tp_axis="tp", weights_dtype="int8"),
        "serve_ep": _serve(trees["moe"], MOE, {"ep": 2}, ep_axis="ep",
                           spec=SpecConfig()),
        "serve_sp": _serve(trees["dense"], DENSE, {"sp": 2}, sp_axis="sp"),
    }
    return run_world(census_world_case, 2, tmp_path_factory.mktemp("c2"),
                     jobs, timeout=300)


@pytest.fixture(scope="module")
def world4(trees, tmp_path_factory):
    jobs = {
        "dp_tp": _train(trees, {"dp": 2, "tp": 2}, ADAMW),
        "serve_ep_tp": _serve(trees["moe"], MOE, {"ep": 2, "tp": 2},
                              ep_axis="ep", tp_axis="tp"),
        "serve_sp4": _serve(trees["dense"], DENSE, {"sp": 4}, sp_axis="sp"),
        "gpt2_dp2tp2": _gpt2_train(trees, {"dp": 2, "tp": 2}, DPTP_MICRO2),
        "gpt2_dp2pp2_zero2": _gpt2_train(trees, {"dp": 2, "pp": 2},
                                         DPPP_ZERO2),
    }
    return run_world(census_world_case, 4, tmp_path_factory.mktemp("c4"),
                     jobs, timeout=300)


@pytest.fixture(scope="module")
def world8(trees, tmp_path_factory):
    jobs = {"3d": _train(trees, {"dp": 2, "tp": 2, "pp": 2}, ONE_F_ONE_B),
            "gpt2_3d_zero1": _gpt2_train(trees, {"dp": 2, "tp": 2, "pp": 2},
                                         THREED_ZERO1)}
    return run_world(census_world_case, 8, tmp_path_factory.mktemp("c8"),
                     jobs, timeout=300)


def _jax_leaf_counts(sizes, training, axis):
    """JAX's (total, replicated, sharded) leaf counts over ``axis`` of
    the same ViT on the same mesh."""
    cfg = JaxConfig.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": {"batch_size": 8, **training}})
    strat = jax_get_strategy("auto", cfg)
    return jax_specs.spec_leaf_counts(
        strat.param_specs(jax_vit_spec(JaxViTConfig(**VIT))), axis)


def _one(ranks, tag):
    """Rank 0's result of job ``tag``, after checking every rank's census
    is the same (each rank runs the same program)."""
    first = ranks[0][tag]
    key = "census" if "census" in first else None
    for r in ranks[1:]:
        if key:
            assert r[tag][key] == first[key], (tag, r[tag][key])
        else:
            assert r[tag] == first, (tag, r[tag])
    return first


def _n_leaves(trees):
    return len(jax.tree.leaves(trees["vit"]))


# ---------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------

def test_dp_exact_counts(world2, trees):
    r = _one(world2, "dp")
    assert r["strategy"] == "dp"
    n = _n_leaves(trees)
    assert r["leaves"]["dp"][0] == n
    expect = jax_specs.expected_dp_train_step(n)
    assert expect == specs.expected_dp_train_step(n)
    assert r["census"] == expect
    assert r["dynamic"] == 0


def test_zero1_exact_counts(world2, trees):
    r = _one(world2, "zero1")
    expect = jax_specs.expected_zero1_train_step(_n_leaves(trees))
    assert expect == specs.expected_zero1_train_step(_n_leaves(trees))
    assert r["census"] == expect


def test_zero2_exact_counts(world2):
    r = _one(world2, "zero2")
    expect = jax_specs.expected_zero2_train_step()
    assert expect == specs.expected_zero2_train_step()
    assert r["census"] == expect


def test_dp_tp_2axis_exact_counts(world4, trees):
    r = _one(world4, "dp_tp")
    assert r["strategy"] == "dp_tp"
    n, n_repl, n_shard = r["leaves"]["tp"]
    assert (n, n_repl, n_shard) == _jax_leaf_counts(
        {"dp": 2, "tp": 2}, ADAMW, "tp")
    expect = jax_specs.expected_dp_tp_train_step(n, VIT["depth"], n_repl,
                                                 n_shard)
    assert expect == specs.expected_dp_tp_train_step(n, VIT["depth"],
                                                     n_repl, n_shard)
    assert r["census"] == expect


def test_3d_1f1b_exact_counts(world8, trees):
    """dp x tp x pp, 1F1B: dp and pp exactly JAX's census (leaf means,
    stage-partial grads, the schedule's boundary shifts); tp the port's
    derived count — the rank's own stage, per micro-batch — with JAX's
    replicated-grad and clip terms."""
    r = _one(world8, "3d")
    assert r["strategy"] == "3d"
    n = _n_leaves(trees)
    _, tp_repl, tp_shard = r["leaves"]["tp"]
    _, pp_repl, pp_shard = r["leaves"]["pp"]
    sizes = {"dp": 2, "tp": 2, "pp": 2}
    assert r["leaves"]["tp"] == _jax_leaf_counts(sizes, ONE_F_ONE_B, "tp")
    assert r["leaves"]["pp"] == _jax_leaf_counts(sizes, ONE_F_ONE_B, "pp")
    args = (n, VIT["depth"], tp_repl, tp_shard, pp_repl, pp_shard)
    jexp = jax_specs.expected_3d_train_step(*args, n_micro=2, pp_size=2)
    pexp = specs.expected_3d_train_step(*args, n_micro=2, pp_size=2)
    assert r["census"] == pexp
    assert pexp["dp"] == jexp["dp"] and pexp["pp"] == jexp["pp"]
    # the one derived term: JAX counts the whole depth per micro-batch
    # on every stage, a port rank its own depth / pp blocks
    fwd_bwd_recompute = 2 * 3 * 2
    assert (jexp["tp"]["all_reduce"] - pexp["tp"]["all_reduce"]
            == fwd_bwd_recompute * VIT["depth"] // 2)
    assert r["dynamic"] == 0


def test_chip_mesh_runs_census(world4, world8, trees):
    """The formulas chip_smoke.py holds its GPT-2 mesh runs to, at a
    tiny width: dp x tp over 2 micro-batches (JAX's formula at n_micro
    = 1, each micro-batch its own forward and backward), dp x pp
    1F1B-stored under ZeRO-2 (the one chunk-space clip sum over the
    whole mesh) and 3D 1F1B under ZeRO-1; dp parts JAX's ZeRO formulas,
    pp shifts JAX's."""
    n = len(jax.tree.leaves(trees["dense"]))
    depth = DENSE["n_layer"]
    r = _one(world4, "gpt2_dp2tp2")
    _, repl, shard = r["leaves"]["tp"]
    assert r["census"] == specs.expected_dp_tp_train_step(
        n, depth, repl, shard, n_micro=2)
    assert specs.expected_dp_tp_train_step(n, depth, repl, shard) == \
        jax_specs.expected_dp_tp_train_step(n, depth, repl, shard)
    r = _one(world4, "gpt2_dp2pp2_zero2")
    _, pp_repl, pp_shard = r["leaves"]["pp"]
    want = specs.expected_3d_train_step(
        n, depth, 0, 0, pp_repl, pp_shard, n_micro=4, pp_size=2,
        tp_axis=None, zero_stage=2, store_activations=True)
    assert r["census"] == want
    assert want["dp"] == jax_specs.expected_zero2_train_step()["dp"]
    r = _one(world8, "gpt2_3d_zero1")
    _, repl, shard = r["leaves"]["tp"]
    _, pp_repl, pp_shard = r["leaves"]["pp"]
    want = specs.expected_3d_train_step(
        n, depth, repl, shard, pp_repl, pp_shard, n_micro=4, pp_size=2,
        zero_stage=1)
    assert r["census"] == want
    assert want["dp"] == jax_specs.expected_zero1_train_step(n)["dp"]
    assert want["pp"]["ppermute"] == jax_specs.expected_3d_train_step(
        n, depth, repl, shard, pp_repl, pp_shard, n_micro=4,
        pp_size=2)["pp"]["ppermute"]


@pytest.mark.parametrize("world,tag", [("world2", "dp"),
                                       ("world2", "zero2"),
                                       ("world4", "dp_tp"),
                                       ("world8", "3d")])
def test_counter_off_losses_bit_equal(world, tag, request):
    """Counting changes nothing: the same step with the counter off
    gives the bit-equal loss on every rank."""
    for rank in request.getfixturevalue(world):
        assert rank[tag]["loss_on"].tobytes() == \
            rank[tag]["loss_off"].tobytes()


# ---------------------------------------------------------------------
# tp layers (JAX's TestTpLayerCensus)
# ---------------------------------------------------------------------

def test_column_row_forward_exactly_one_psum(world2):
    assert _one(world2, "tp_layer")["forward"] == {"tp": {"all_reduce": 1}}


def test_column_row_grad_adds_exactly_one_psum(world2):
    assert _one(world2, "tp_layer")["grad"] == {"tp": {"all_reduce": 2}}


def test_gather_output_costs_one_all_gather_and_its_transpose(world2):
    assert _one(world2, "tp_layer")["gathered_grad"] == {
        "tp": {"all_gather": 1, "reduce_scatter": 1}}


# ---------------------------------------------------------------------
# serving programs
# ---------------------------------------------------------------------

def _programs(r):
    return {k: v for k, v in r.items()
            if k not in ("axes", "decode_in_place")}


@pytest.mark.parametrize("tag", ["serve_tp", "serve_tp_int8_kv",
                                 "serve_tp_int8_w"])
def test_tp_census_two_psums_per_layer_every_program(world2, tag):
    """Head-sharded serving: 2 row-parallel sums per block in every
    prefill bucket, the decode step and every verify bucket, and nothing
    else — whatever the KV or weight layout (the scales shard with the
    heads and columns)."""
    r = _one(world2, tag)
    assert r["axes"] == ("tp", None, None)
    n = DENSE["n_layer"]
    for kind, spec_fn in (("prefill", "expected_serve_prefill"),
                          ("decode", "expected_serve_decode"),
                          ("verify", "expected_serve_verify")):
        expect = getattr(jax_specs, spec_fn)(n, tp_axis="tp")
        assert expect == getattr(specs, spec_fn)(n, tp_axis="tp")
        progs = {k: c for k, c in _programs(r).items()
                 if k.split("[")[0] == kind}
        assert progs or kind == "verify", (tag, kind)
        for name, census in progs.items():
            assert census == expect, (tag, name, census)
    assert len([k for k in r if k.startswith("prefill[")]) >= 2


def test_ep_census_two_all_to_alls_per_moe_layer(world2):
    r = _one(world2, "serve_ep")
    assert r["axes"] == (None, None, "ep")
    n = MOE["n_layer"]
    expect = jax_specs.expected_serve_moe(n, ep_axis="ep")
    assert expect == specs.expected_serve_moe(n, ep_axis="ep")
    assert any(k.startswith("verify[") for k in r)
    for name, census in _programs(r).items():
        assert census == expect, (name, census)


def test_ep_donation_no_aliasable_misses(world2):
    """The widened MoE return (the trailing routing stats) costs no
    in-place update: on every ep rank the decode program keeps its pool
    shard in place and leaves nothing aliasable in new storage."""
    for r in world2:
        assert r["serve_ep"]["decode_in_place"] == {
            "pool": True, "undonated_aliasable": []}


def test_ep_times_tp_census_composes(world4):
    r = _one(world4, "serve_ep_tp")
    n = MOE["n_layer"]
    expect = jax_specs.expected_serve_moe(n, ep_axis="ep", tp_axis="tp")
    assert expect == specs.expected_serve_moe(n, ep_axis="ep",
                                              tp_axis="tp")
    for name, census in _programs(r).items():
        assert census == expect, (name, census)


@pytest.mark.parametrize("world,tag,sp", [("world2", "serve_sp", 2),
                                          ("world4", "serve_sp4", 4)])
def test_sp_prefill_census_shifts_are_f_of_sp(world, tag, sp, request):
    """The ring sp prefill: per layer ``sp - 1`` shifts of the stacked
    chunk K/V (JAX: ``2 * sp``, a scan that also shifts the positions and
    makes a last, discarded rotation — the derived term), one all_gather
    and one call-wide all_reduce, as JAX's, every bucket; the decode
    step on the same mesh is collective-free (it runs replicated)."""
    r = _one(request.getfixturevalue(world), tag)
    n = DENSE["n_layer"]
    pexp = specs.expected_serve_sp_prefill(n, sp)
    jexp = jax_specs.expected_serve_sp_prefill(n, sp)
    for op in ("all_gather", "all_reduce"):
        assert pexp["sp"][op] == jexp["sp"][op]
    assert pexp["sp"]["ppermute"] == (sp - 1) * n
    assert jexp["sp"]["ppermute"] == 2 * sp * n
    prefills = {k: c for k, c in r.items() if k.startswith("prefill[")}
    assert len(prefills) >= 2
    for name, census in prefills.items():
        assert census == pexp, (name, census)
    assert r["decode"] == {}
