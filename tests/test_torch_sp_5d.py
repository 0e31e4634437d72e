"""The port's 5D and 4D goldens: sequence parallelism composed with every
other axis, on gloo worlds of 32 and 16 CPU ranks, against JAX's
single-device step. Marked ``slow``, as JAX's own ``tests/test_5d.py``
is (it sits in ``conftest.SLOW_FILES``): outside the tier-1 run.

- ``5d``: tiny GPT-2-MoE (2 layers, 4 heads, 4 mlp experts, top-2,
  dropless, no aux term) on dp x tp x pp x sp x ep = 2 x 2 x 2 x 2 x 2
  with ``1f1b`` over 2 micro-batches and ring attention: two SGD steps
  from the weights ``bridge.py`` carries over, against JAX's two
  single-device steps with ``tests/_worker_5d.py``'s bounds (losses
  ``rtol=1e-4``, every parameter ``rtol=5e-4, atol=1e-5``);
- ``4d``: tiny GPT-2 (4 layers, 4 heads) on dp x tp x pp x sp = 2 x 2 x
  2 x 2 with ``1f1b`` over 2 micro-batches and zigzag attention, the
  same way.
"""

import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_mesh_checks import jax_single_steps, tp_blocked
from _torch_sp_cases import sp_world_case

MOE_5D = dict(vocab_size=128, n_positions=32, n_layer=2, n_head=4,
              n_experts=4, expert_top_k=2, expert_capacity=4096,
              aux_loss_weight=0.0)
SGD = {"optimizer": "sgd", "learning_rate": 0.05, "grad_clip_norm": None}
CASES = {
    "5d": (MOE_5D, {"dp": 2, "tp": 2, "pp": 2, "sp": 2, "ep": 2}, "ring",
           (8, 16)),
    "4d": ({}, {"dp": 2, "tp": 2, "pp": 2, "sp": 2}, "zigzag", (8, 32)),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(CASES))
def test_gpt2_4d_and_5d_steps_match_single_device(tmp_path, name):
    from quintnet_tpu_torch import bridge
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    kw, sizes, sp_mode, shape = CASES[name]
    params = bridge.gpt2_params_to_numpy(gpt2_init(
        torch.Generator().manual_seed(0), GPT2Config.tiny(**kw)))
    ids = np.random.default_rng(1).integers(0, 128, shape, dtype=np.int32)
    losses, want = jax_single_steps("gpt2", kw, params, ids, SGD, steps=2)
    want = tp_blocked(kw, want, sizes["tp"])
    job = ("steps", ("gpt2", kw, params, ids, ids, sizes),
           {"training": dict(SGD, schedule="1f1b",
                             gradient_accumulation_steps=2),
            "steps": 2, "sp_mode": sp_mode})
    ranks = [r[name] for r in run_world(
        sp_world_case, int(np.prod(list(sizes.values()))), tmp_path,
        {name: job}, timeout=1500)]
    for r in ranks:
        assert r["strategy"] == name
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        assert set(r["params"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(r["params"][k], w, rtol=5e-4,
                                       atol=1e-5, err_msg=f"{name} {k}")
