"""Long-context walkthrough: sequence-parallel training, and chunked
prefill serving.

Port of ``quintnet_tpu/examples/long_context.py``.
Every activation's SEQUENCE dim is sharded over the ``sp`` mesh axis
(``--nproc`` ranks) and attention runs exactly across the shards:

    ring    — K/V chunks rotate around the ranks; online softmax, exact
    zigzag  — the load-balanced causal ring
    ulysses — an all-to-all head scatter; the flash kernels (K1-K3 on
              the card) attend each rank's heads over the whole sequence

Activation memory a rank scales 1/sp. The model is the JAX example's
tiny GPT-2 (2 layers). Run (CPU: 8 gloo ranks, 2,048 positions, 256 a
rank; the card: 2 ranks sharing it over gloo)::

    python -m quintnet_tpu_torch.examples.long_context --device cpu
    python -m quintnet_tpu_torch.examples.long_context --device cpu \\
        --seq 4096 --sp-mode zigzag
    python -m quintnet_tpu_torch.examples.long_context --device cuda:0 \\
        --backend gloo --nproc 2 --seq 1024 --sp-mode ulysses

The tiny model's head dim (8) is outside the K1-K3 kernels' domain, so
on the card its Ulysses attention runs blockwise (counted in
``flash_attention.routed``); GPT-2 124M at its 1,024 positions on sp = 2
through K1-K3 is ``chip_smoke.py``'s ``sp2_ulysses`` run.

``--serve`` is the serving half: one document-length prompt (384 tokens
by default), longer than the engine's whole prefill window (64), served
by the chunked-prefill engine (``serve/longctx.py``: admitted whole, fed
through bucket-sized chunks at most 64 tokens a step) and checked token
for token against an engine whose window was widened to hold it::

    python -m quintnet_tpu_torch.examples.long_context --serve --device cpu
    python -m quintnet_tpu_torch.examples.long_context --serve   # the card

With ``--serve --simulate N`` the chunks also run sequence-parallel:
N ranks (gloo) each serve the same request on an ``sp`` mesh of N, every
chunk split over them and attended by the ring over the paged pool
(``nn/attention.ring_paged_prefill``)::

    python -m quintnet_tpu_torch.examples.long_context --serve --device cpu \
        --simulate 2
    python -m quintnet_tpu_torch.examples.long_context --serve \
        --device cuda:0 --backend gloo --simulate 2      # the card
"""

from __future__ import annotations

import argparse
import time

from quintnet_tpu_torch.examples.common import add_launch_args, launch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=8,
                    help="ranks, all on the sp axis (default 8)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--sp-mode", default="ring",
                    choices=["ring", "zigzag", "ulysses"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--serve", action="store_true",
                    help="serving: one document-length prompt through the "
                         "chunked-prefill engine instead of training")
    ap.add_argument("--serve-prompt", type=int, default=384,
                    help="--serve prompt length (tokens)")
    ap.add_argument("--serve-new", type=int, default=8,
                    help="--serve generated tokens")
    ap.add_argument("--simulate", type=int, default=None,
                    help="--serve: ranks the chunks' attention is "
                         "sequence-parallel over (an sp mesh of N)")
    add_launch_args(ap)
    args = ap.parse_args(argv)
    if args.serve:
        return launch(serve_demo, args, args.simulate or 1)

    from quintnet_tpu_torch.core.config import Config

    cfg = Config.from_dict({
        "mesh_dim": [args.nproc], "mesh_name": ["sp"],
        "training": {"batch_size": args.batch, "sp_mode": args.sp_mode,
                     "optimizer": "adamw", "learning_rate": 1e-3,
                     "grad_clip_norm": 1.0}})
    return launch(_train, args, cfg.mesh.world_size, cfg)


def serve_demo(args):
    """One long prompt through the chunked engine (on every rank of an
    sp mesh of ``--simulate`` ranks when that is above 1), then through
    an engine whose prefill window holds it whole: the same tokens.
    Returns the generated tokens."""
    import numpy as np
    import torch

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.serve import ServeEngine, generate, gpt2_family

    print_ = print if runtime.is_main_process() else (lambda *a: None)
    sp = args.simulate or 1
    device = runtime.device() if runtime.is_multiprocess() else args.device
    cfg = GPT2Config.tiny(n_layer=2, n_positions=1024)
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt2_init(gen, cfg)
    family = gpt2_family(cfg)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.serve_prompt,)).astype(np.int32)
    window = budget = 64
    kw = dict(device=device, max_slots=4, block_size=16,
              num_blocks=128, max_seq_len=cfg.n_positions)
    mesh_kw = ({"mesh": mesh_from_sizes(sp=sp), "sp_axis": "sp"}
               if sp > 1 else {})
    chunked = ServeEngine(family, params, prefill_len=window,
                          chunked_prefill=True, prefill_chunk_budget=budget,
                          **kw, **mesh_kw)
    print_(f"prompt {len(prompt)} tokens vs prefill window {window} (top "
           f"bucket {chunked.prefill_buckets[-1]}), chunk budget "
           f"{budget}/step, sp={sp}, device {chunked.device}")
    t0 = time.perf_counter()
    out = generate(chunked, [prompt], max_new_tokens=args.serve_new,
                   seeds=[1], max_steps=2000)[0]
    dt = time.perf_counter() - t0
    m = chunked.metrics
    print_(f"served in {m.steps} engine steps / {dt:.2f}s: "
           f"{m.prefill_chunks} chunks, {m.chunk_tokens_per_step:.1f} "
           f"chunk tokens/step (<= {budget} by construction)")
    want = generate(ServeEngine(family, params, **kw), [prompt],
                    max_new_tokens=args.serve_new, seeds=[1])[0]
    same = bool(np.array_equal(out, want))
    print_(f"identical to the widened single-shot engine: {same}")
    print_("generated:", out[len(prompt):].tolist())
    if not same:
        raise SystemExit("chunked output diverged from single-shot")
    return out[len(prompt):]


def _model_config(args):
    """Tiny GPT-2 with positions for the whole sequence; under Ulysses at
    least one head a rank."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    sp = args.nproc
    # ulysses scatters HEADS over sp: the tiny model gets enough
    n_head = max(4, sp) if args.sp_mode == "ulysses" else 4
    if args.sp_mode == "ulysses" and n_head % sp:
        raise SystemExit(f"--sp-mode ulysses needs n_head ({n_head}) "
                         f"divisible by the sp size ({sp})")
    return GPT2Config.tiny(n_layer=2, n_head=n_head, n_positions=args.seq)


def _train(args, cfg):
    import numpy as np
    import torch

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.models.gpt2 import gpt2_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import make_optimizer

    say = print if runtime.is_main_process() else (lambda *a: None)
    sp = cfg.mesh.world_size
    gcfg = _model_config(args)
    model = gpt2_model_spec(gcfg, sp_mode=args.sp_mode, use_flash=True)
    strat = get_strategy("sp" if sp > 1 else "single", cfg)
    device = runtime.device() if runtime.is_multiprocess() else args.device
    say(f"mesh sp={sp}, seq {args.seq} -> {args.seq // sp}/rank, "
        f"sp_mode={args.sp_mode}, {gcfg.n_layer} layers, device {device}")

    gen = torch.Generator(device=device).manual_seed(0)
    params = tree_map(lambda t: t.requires_grad_(True),
                      strat.shard_params(model, model.init(gen)))
    opt = make_optimizer(cfg)
    opt_state = strat.init_opt_state(model, opt, params)
    ids = np.random.default_rng(0).integers(
        0, gcfg.vocab_size, (args.batch, args.seq), dtype=np.int64)
    t = torch.tensor(ids, device=device)
    batch = strat.shard_batch((t, t), model)
    step = strat.make_train_step(model, opt)
    sync = (torch.cuda.synchronize if str(device).startswith("cuda")
            else (lambda: None))
    losses = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        loss_v = float(loss)        # the step's one device->host read
        sync()
        dt = time.perf_counter() - t0
        losses.append(loss_v)
        say(f"step {i}: loss {loss_v:.4f}  {dt:.2f}s")
    say(f"done: every attention ran sequence-parallel over {sp} ranks; "
        "the [S, S] scores never existed on any one of them")
    return losses


if __name__ == "__main__":
    main()
