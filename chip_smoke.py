#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py            # all phases, one CUDA card

Phases (any failure raises and exits non-zero; nothing is caught):

1. **kernels** — build every CUDA source of the path with ``nvcc``
   (one process per source, started together) and check the SASS
   (``cuobjdump``): every instantiation of K1, K2, K3 and of K4's
   prefill kernel holds tensor-core instructions (HMMA: their products
   run in 3xTF32) and no atomics; every bf16 instantiation of K1, K2
   and K3 holds wgmma (``HGMMA.*.F32.BF16``) and no atomics and no
   local-memory spill (LDL, STL); and no instantiation of K4's decode
   kernel holds atomics. Then hold each kernel to its plain PyTorch
   version at the main paths' shapes (GPT-2 base heads, D = 64). Paged
   attention (K4, block size 16; the decode path for at most 4 query
   rows a kv head, else the prefill path): decode rows with mixed
   context lengths and a dead row, one row of 1,024 positions, prefill
   tails at every serve bucket (P = 32-512) and 16 and 1,024 at start 0,
   in f32 and int8, and at the offset 37 that is not block-aligned,
   GQA decode at groups 2 and 4 and GQA prefill at group 4. Flash
   attention (K1 forward, K2 dK/dV, K3 dQ): (B, H, S) = (32, 12, 512)
   causal (the train phase's micro-batch and an fsdp_dp2 rank's),
   (32, 6, 512) and (4, 6, 512) causal (the mesh phase's tp2 and dp2 x
   tp2 and fsdp_dp2tp2 ranks), (4, 12, 512), (2, 12, 512) and (2, 6,
   512) causal (its pp2, dp2 x pp2 and dp2 x tp2 x pp2 ranks'
   micro-batches, the last in bf16 the 3d_bf16 run's), (8, 12, 1024)
   causal, (4, 12, 512) causal with packed-segment ids, (2, 12, 300)
   causal with a ragged last tile, (8, 12, 256) non-causal and
   (1, 12, 4096) causal, and Llama-3.2-1B's (4, 32, 1024) causal, the
   same packed and a tp2 rank's (4, 16, 1024) (also a llama_sp2_ulysses
   rank's), and an sp2_ulysses rank's (4, 6, 1024) causal: half of
   GPT-2's heads over all its positions, each in f32 and again in
   bf16 (the same values
   rounded to bf16; the bf16 kernels against their bf16 plain versions
   within 2^-7 of the largest magnitude, lse within 1e-5, and against
   the f32 plain versions on the same bf16 values within 2^-5). Prints
   one JSON line per case with the error,
   the times of the kernel and of a PyTorch library call (20 calls
   captured in a CUDA graph and replayed: device time, no host time
   between launches; the library call is
   ``F.scaled_dot_product_attention``, over a view gathered beforehand
   for K4, forward, and forward+backward minus forward, for K1-K3 — a
   yardstick only, never used by the port), the plain version's time
   (20 calls, CUDA events), each kernel call's
   wall time through its Python entry point beside (``call_ms``, CUDA
   events; a small kernel's wrapper can take longer on the host than the
   kernel on the device), plus the least
   time the card could take (``bound_ms``: bytes at the HBM rate, or
   operations at the 3xTF32 rate of 165 TFLOP/s, in bf16 at the bf16
   tensor-core rate of 989 TFLOP/s, whichever is longer; the SDPA
   yardstick runs in the kernel's dtype).
   At the train shape also K2 + K3 as one backward beside SDPA's whole
   backward, its bound counting the 5 products a fused backward needs.
   K4 again with quantized and narrow pools at the decode shape (int8,
   bf16, fp8, fake_quant: dequantize on load and, for the scaled int8
   and fake_quant, the fresh-K/V override), a P = 128 prefill tail per
   other layout, the verify shape (8 rows x 4 queries, f32 and int8)
   and int8 GQA; since slice 18 Llama-3.2-1B's GQA (32 query heads on
   8 kv heads: decode in f32 and int8, prefill P = 128 in f32 and int8,
   verify P = 3 on the prefill path) and a tp2 GPT-2 rank's 6 heads
   (decode, prefill P = 128), each a kernels-line entry of its own
   (``line``); then two exact checks: on each K4 path (the decode
   case, the P = 128 prefill at start 37) fake_quant equals f32 bit for
   bit, and ``paged_quant_window_update`` on the card equals the same
   call on the CPU byte for byte.
2. **serve** — GPT-2 124M (random weights from seed 0) served by the
   port's ``ServeEngine`` on the card from an f32 pool: warmup, 8
   greedy requests with prompts of 32-400 tokens (one continues
   another's conversation, so the prefix cache hits and copies on
   write), run to completion. The kernel launch counts are zeroed just
   before and read just after (decode steps on K4's decode path,
   prefills on its prefill path); each request's tokens are checked
   against greedy decoding by the dense ``gpt2_apply`` on the card (a
   mismatch where the dense top-2 logit gap is below 1e-3 is reported
   as a near-tie, any other fails). Prints decode tokens/s, TTFT p50
   and, over steady decode steps, the step's wall time (no profiler
   running) against the device's busy time and the kernel's time
   (``torch.profiler``, next steps; K4's device kernels found by symbol,
   ``PAGED_SYMBOLS``, n_layer decode kernels a step or the run fails).
2b. **serve_sampled** — the same script through a sampled engine
   (temperature 0.8, top-k 50, top-p 0.95, f32 pool; each request at
   its rid's seed, the engine's default), counts zeroed just before and
   read just after: K4 as the serve phase counts it; a fresh engine
   gives the same streams bit for bit, and so does one whose pool (48
   blocks) is too small for the script's working set (it must preempt);
   each stream equals the port's ``gpt2_generate`` of its prompt at its
   seed on the card up to the first position where the two best
   perturbed scores (filtered logits / T + the chain's noise, from the
   dense forward) lie within ``F32_GAP`` (reported; anywhere else
   fails); the chain's integers for one [8, 50,257] draw equal the
   CPU's bit for bit. Prints the steady sampled decode step beside the
   greedy one (``_kernel_share``).
2c. **generate** — the dense decoders (plain attention, as JAX's: no
   kernel launches): greedy ``gpt2_generate`` on 2 prompts of 64 (32
   new tokens) against the greedy engine's streams under the serve
   phase's near-tie rule; ``gpt2_beam_search`` at beams 1 equal to
   greedy and at beams 4 scoring at least greedy's teacher-forced
   log-probability; Llama-3.2-1B uncut (seed 0): ``llama_prefill``'s
   last logits within 1e-4 of ``llama_apply``'s on 4 x 128 prompts, and
   ``llama_generate`` greedy for 16 new tokens.
3. **serve_kv** — the same script once per KV layout policy
   (fake_quant, int8, bf16, fp8), each run's counts zeroed just before
   it: every launch is the policy's kernel variant, n_layer x (decode
   steps + prefills) of them; fake_quant's token streams equal the f32
   run's; int8, bf16 and fp8 agree with the dense greedy on at least
   90% of the tokens, and differ only where the dense top-2 gap is
   below 0.05 (each mismatch printed with its gap). For int8 also the
   decode step's device time split between the kernel,
   ``paged_quant_window_update`` and the rest. Then teacher-forced NLL
   through each pool at the verify shape (``paged_eval_nll``, 4 rows x
   256 tokens, and the second half scored against the first written
   earlier): fake_quant within 1e-6 of f32, the others within 2e-3.
3b. **serve_llama** — Llama-3.2-1B uncut (16 layers, vocab 128,256,
   random weights from seed 0) served by ``llama_family``: the pool
   holds the 8 UNrepeated kv heads and K4 takes the group of 4. 8
   requests of 16-200 tokens, 32 new each, counts zeroed just before
   and read just after every run: greedy (f32 pool) against the dense
   ``llama_apply`` teacher-forced under the near-tie rule, with the
   steady decode step profiled (16 decode-path kernels a step); sampled
   against ``llama_generate`` at each request's seed (perturbed
   near-ties); an int8 pool under the narrow-layout rule (>= 90%, a flip
   only at a gap < 0.05); speculation on 4 tiled prompts against
   spec-off (its verifies on the prefill path); since slice 19 int8
   weights (``weights_dtype="int8"``, f32 pool) under the narrow-layout
   rule against the f32 dense greedy and the serve rule against the
   dense forward of its own dequantized weights, its decode step and
   weight bytes beside f32's. K4 == 16 x (decode steps + prefills [+
   verifies]) by path in every run.
3c. **serve_wq** (slice 19) — GPT-2 124M on the serve script with its
   block matmuls' weights packed (``weights_dtype``: fake_quant, bf16,
   int8, fp8; f32 pool), counts zeroed just before each run and read
   just after: fake_quant's streams equal the f32 run's bit for bit;
   bf16, int8 and fp8 equal to the dense forward of their own
   dequantized weights up to near-ties, and >= 90% equal to the f32
   dense greedy (bf16 and int8 flipping only at a gap < 0.05;
   ``WQ_GAP``); teacher-forced NLL through an f32 pool with the packed
   weights (fake_quant equal to f32, int8 and fp8 within 0.05: JAX's
   gate); the targeted weights' bytes f32 / int8 >= 3.5. Prints each
   run's decode step and tokens/s.
3d. **serve_tier** (slice 19) — GPT-2 124M with the prefix cache and a
   1 GiB host tier on a pool of 40 blocks: three 256-token prefixes,
   each request (prefix + 32-token tail, 16 new) alone, three rounds.
   Demotions, promotions and host hits > 0 and no demotion inside a
   decode dispatch; the streams equal bit for bit those of a pool that
   never evicts, and, up to near-ties, the dense greedy and the same
   pool with the tier off; a chain demoted and promoted back byte for
   byte from an f32 and an int8 pool (the scale rows too); K4 == 12 x
   (decode steps + prefills). Prints the host hits' TTFT against the
   re-prefills' and the demotion and promotion ms a block.
3e. **serve_lora** (slice 19) — GPT-2 124M serving three LoRA tenants
   (ranks 4, 8, 16 from ``lora_init``, their b moved off zero) and the
   base model in one batch of 8 staggered requests, greedy and sampled:
   every stream equal to a dedicated engine serving its tenant's merged
   weights up to near-ties (the merged model's dense top-2 gap, or its
   perturbed gap, < 1e-3); every decode call at the smallest rank
   bucket covering the adapters bound then (buckets 16, 8 and 4 all
   used); every pin released; K4 == 12 x (decode steps + prefills) in
   every run. Reported: the same greedy batch with int8 weights under
   the adapters.
3f. **serve_fleet** (slice 20) — GPT-2 124M (12 layers, the serve
   phases' weights) served by a ``ServeFleet`` of 3 replicas (4 slots,
   f32 pools, obs on, a crash directory), 16 requests of 32-256 tokens,
   32 new each, all submitted at once, replica r1 killed after its 8th
   step (``ChaosMonkey``, mode raise); greedy, then sampled
   (``SAMPLED``) at each fid's seed. Counts zeroed just before each run
   and read just after. Gates: greedy streams equal the dense greedy up
   to near-ties (the serve rule), sampled ones the port's single engine
   at the same seeds up to perturbed near-ties; at least one migration;
   exactly one death in the event log, the armed ``ChaosKilled``; a
   crash dump that ``load_crash_dump`` reads, holding the dead replica's
   step ring; the fleet's exposition parses; K4 launched from all 3
   replica threads and no other (``launches_by_thread``), n_layer x
   (decode steps + prefills) over every engine, the dead one included.
   Then on one engine: tracing on vs off, streams byte-equal and the
   same host ops, device operations and device-to-host copies a step
   (``torch.profiler``); a clock advancing 10 ms a read retires a
   running request with ``DeadlineExceeded``, its blocks returned (none
   held after, its chain hit on resubmission). Prints the fleet's wall
   s, TTFT / ITL percentiles, each replica's step p50 (recorder rings),
   migrations, sheds, peak memory and what stays allocated after
   ``close()``, beside the card's name and power limit.
3g. **serve_proc_fleet** (slice 21) — the same model and traffic served
   by a ``ProcessFleet``: each replica a spawned PROCESS (its own CUDA
   context on the card) building GPT-2 124M from this file
   (``build_proc_engine``, the serve phases' seeded generator), K4 built
   in the parent first so the children only load it. Colocated greedy:
   3 replicas, p1 SIGKILLed by a real signal once the parent's token
   journal holds 8 of its tokens, its work rebuilt from the journal and
   the fids' seeds on the survivors, p1 restarted through the breaker
   and then probed alone; one request through the HTTP/SSE
   ``FrontDoor`` (tokens equal ``result()``, /healthz 200, /metrics
   parses). Colocated sampled with the same kill. Disaggregated greedy
   (1 prefill + 2 decode replicas): the KV chain crosses processes as a
   checksummed wire frame. Gates: greedy streams equal the dense greedy,
   sampled ones one engine in the parent at the fids' seeds, the
   disaggregated ones the colocated greedy run's, each up to near-ties;
   exactly one death (the kill), a migration, ``is_last`` once a
   request, a crash dump holding the heartbeat-mirrored ring; a handoff
   and a transfer for every request, no fallback; every replica
   incarnation that answers ``stats``: K4 == n_layer x (its decode
   steps + prefills), all f32, and launched at all; the parent launches
   none. Prints a replica's step p50 (mirrored ring), wall, TTFT and
   ITL, spawn-to-hello and restart s, the largest heartbeat age, KV
   bytes shipped and handoff ms, the card's free memory before and
   after.
4. **train** — GPT-2 124M (f32, random weights from seed 0, every
   dropout rate 0) trained by the port's ``Trainer`` with AdamW (lr
   5e-5, decay 0.01, clip 1.0) on ``SummarizationDataset.synthetic``
   rows of 512 byte tokens, global batch 64 in 2 micro-batches of 32:
   the first batch's loss and every gradient leaf with flash attention
   (the K1-K3 kernels) against plain attention from the same weights,
   then 4 optimizer steps through ``Trainer.fit`` each way, the losses
   compared step by step. The flash run is the main path: the launch
   counts are zeroed just before it and read just after (12 layers x 2
   micro-batches x 4 steps of each kernel), and the dispatcher must
   have routed no call to the blockwise attention
   (``flash_attention.routed == 0``). Prints the step's wall
   time (no profiler running), tokens/s and peak memory, and over the
   next steps under ``torch.profiler`` the device's busy time and the
   three kernels' share of the step (each kernel's profiled launches a
   step must be n_layer x micro-batches).
4a. **lora_train** — LoRA (rank 8, alpha 16, targets qkv/proj/fc) over
   frozen GPT-2 124M f32 weights (seed 0) on the train phase's data
   (64 rows of 512 in 2 micro-batches), attention through the flash
   dispatcher: the first batch's adapter gradients through K1-K3 against
   plain attention (every adapter made non-trivial first), each leaf
   within 1e-5 of its largest magnitude; then the main path, 2 Adam
   steps of ``make_lora_train_step`` from zero-init ``b`` (counts zeroed
   just before, read just after: each of K1-K3 12 x 2 x 2, none
   routed); every base parameter unchanged bit for bit; the step time,
   the adapters' Adam state beside a full finetune's, ``save_lora`` /
   ``load_lora`` bit for bit, and the merged model generating.
4b. **train_bf16** — the same model, data, optimizer and shapes with
   ``training.dtype: bfloat16`` (the f32 master weights cast to bf16 at
   use) and ``adam_mu_dtype: bfloat16``: the first batch's loss and
   every gradient leaf (all f32) flash against plain attention in bf16
   (loss <= 1e-2 relative, each leaf <= 5e-2 of its largest magnitude),
   the first loss within 2e-2 relative of the f32 phase's, then 4 steps
   each way with the losses compared (<= 1e-2 relative each). The flash
   run is the main path: counts zeroed just before it and read just
   after, each bf16 kernel 12 x 2 x 4 launches and no f32 launch, 0
   routed, ``mu`` bf16 and ``nu`` and the parameters f32. Prints the
   step's wall time, tokens/s, peak memory and, under ``torch.profiler``,
   the GEMM time, the bf16 kernels' time and the idle share.

4c. **llama_train** — Llama-3.2-1B (``LlamaConfig.llama32_1b()``
   uncut: vocab 128,256, width 2,048, 16 layers, 32 query and 8 kv
   heads, FFN 8,192, tied, llama3 rope scaling; 1.24 B f32 parameters
   from seed 0) on 8 rows of 1,024 token ids over the whole vocab in 2
   micro-batches, AdamW (lr 3e-4, decay 0.1, cosine after 2 warmup
   steps, clip 1.0): the train phase's f32 gates on the first batch's
   loss and every gradient leaf, flash against plain attention, then 4
   steps each way. The flash run is the main path: each of K1-K3
   launches 16 x 2 x 4 times (counts zeroed just before, read just
   after), every call through the kernels (0 routed), and 16 x 2 a step
   by name in the profiler. Prints the step's wall time, input
   positions/s, peak memory and the idle share.
4d. **llama_train_bf16** — the same in bf16 (``training.dtype`` and
   ``adam_mu_dtype``): the train_bf16 gates, the first loss within 2e-2
   of llama_train's, only the bf16 K1-K3.
4e. **llama_packed** — one flash-vs-plain first batch of the same model
   with ``segment_eos_id`` on packed rows (documents of 64-400 tokens,
   each ended by that id): the kernels' packed-segment path at (4, 32,
   1024), the f32 gates, K1-K3 each 16 x 2 launches.
5. **vit** — the reference ViT at full width (``examples/config.yaml``'s
   model block: image 28, patch 7, 1 channel, hidden 64, depth 8, 4
   heads, 10 classes; its training block on one device: global batch 32
   in 2 micro-batches, Adam lr 3e-4, clip 1.0; random weights from seed
   0): the first batch's logits, loss and every gradient leaf on the
   card against the same computation on the CPU from the same weights
   (logits and loss ``atol=1e-5``, gradients ``atol=1e-5, rtol=1e-4``),
   then one epoch of ``synthetic_mnist(8192)`` through ``Trainer.fit``
   with a checkpoint directory, evaluated on ``synthetic_mnist(2048,
   seed=1)`` (a learnable stand-in, not MNIST): the mean loss of the
   last 20 steps must be below that of the first 20, the val accuracy
   above chance (0.1), and ``tools/verify_vit`` reloading the saved
   checkpoint on the card must give exactly the trainer's accuracy. ViT
   attention is plain dense attention, as in the reference: the run
   must launch none of the kernels (every count 0). Prints the step's
   wall time (no profiler running), samples/s, peak memory and, over
   further steps under ``torch.profiler``, the device's idle share.
6. **resume** — GPT-2 124M on the train phase's shapes and optimizer
   through K1-K3, with ``torch.use_deterministic_algorithms(True)``
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set before torch loads): 4
   steps uncut; then a trainer with a checkpoint directory saving every
   2 steps, cut by an exception from its data after step 2; then a fresh
   trainer restoring the step-2 checkpoint and continuing through
   ``fit(cursor=)``. Every parameter, both Adam moments, the step count,
   the 4 step losses and the epoch loss must equal the uncut run's bit
   for bit; each of K1, K2, K3 must have launched 12 layers x 2
   micro-batches x the 8 steps run, with no call routed away from them.
   Prints the save and restore wall times and the checkpoint's bytes.
   Then fault tolerance (since slice 22), in this order: the same 4
   steps through ``fit(ft=FTContext(...))`` with a ``PreemptionHandler``
   entered in this main thread, a ``ChaosMonkey`` that sends this
   process a real SIGTERM after step 2 and a ``GoodputMeter`` (no
   cadence saves): the run must raise ``TrainingPreempted`` at global
   step 2 with only its emergency step on disk; a fresh trainer and
   handler resume it, and the final parameters, both moments and the
   epoch loss must equal the uncut run's bit for bit, K1-K3 launched 12
   x 2 x the 4 steps of the two attempts, 0 routed (prints both goodput
   reports and their ``aggregate``). ``tools/export_gpt2``'s ``main``
   writes the run's newest step as an HF file and ``load_hf_gpt2`` reads
   it onto the card: every leaf bit-equal to the trainer's final
   parameters (prints the file's bytes and seconds). ``tools/eval_ppl``
   scores that file over this repo's README.md (byte tokenizer, windows
   of 1,024, batches of 8): K1 launched 12 times a batch and nothing
   else, and the loss within 1e-4 relative of the same evaluation
   through the plain attention (prints the perplexity and seconds).
   The run's newest step corrupted, ``resume_state`` must fall back to
   step 2 with the chaos hook called once an attempt, and again with
   one restore failure injected (``ChaosMonkey(fail_restores=1)``).
   Last, ``python -m quintnet_tpu_torch.tools.ft_run --device cuda``
   at the JAX tool's smoke size (one SIGTERM kill after step 3) must
   exit 0 having survived one fault. The walls line splits the phase's
   seconds by part. Every file lives in a temporary directory, deleted
   at the end.
7. **mesh** — GPT-2 124M (f32, seed 0, dropout 0, the train phase's
   AdamW) trained on meshes of ranks that are processes sharing
   ``cuda:0`` over gloo (``torch.multiprocessing`` spawn, a FileStore;
   NCCL refuses two ranks of one communicator on one device, and gloo
   stages each collective through host memory). First the single-rank
   references in deterministic mode (global 64 rows in 2 micro-batches,
   16 rows in 4 and in 8, the last also in bf16: each run is held to the
   reference whose micro-batches are its dp ranks' micro-batches
   together), written to temporary files; then a 2-rank probe of which
   collectives gloo runs on CUDA tensors (all_reduce, all_gather,
   reduce_scatter, the pipeline's shift and a ``ppermute`` with an idle
   sender, each an ``all_to_all_single`` with uneven splits, the
   all_to_all at the sp2_ulysses run's q/k/v shape (timed), and
   all_reduce in bf16 must); then, 2 steps each
   through ``Trainer.fit`` on every rank, the runs of one world size in
   turn in one world (a rank's process, torch's import and the card's
   context paid once a size, not once a run): dp2 (one micro-batch of 32 a
   rank: every step loss, parameter and both Adam moments equal to the
   reference bit for bit), tp2 (2 micro-batches of 32, 6 heads a rank;
   since slice 14 dp2, tp2 and fsdp_dp2 are cut to 6 layers, and since
   slice 15 dp2 x tp2, fsdp_dp2tp2, pp2 and dp2 x pp2 too, for the
   script's time limit),
   dp2 x tp2 (16 rows, 4 a rank and micro-batch), fsdp_dp2 and
   fsdp_dp2tp2 (the same two meshes with ``training.fsdp``: the blocks
   stored half on each dp rank and gathered layer by layer; every rank
   holds half of its blocks; on dp alone the dp2 gate, bit for bit; with
   tp the tp gates and both moments, gathered whole, within 1e-3 of the
   reference's), and the pipelines on 16 rows in 4 micro-batches a
   rank: pp2 with AFAB (3 layers a rank), dp2 x pp2 with
   ``1f1b_stored`` and ``zero2_adamw``, dp2 x tp2 x pp2 (the finetune
   config's mesh; its three runs cut to 6 layers, 3 a stage, since
   slice 14) with ``1f1b`` and ``zero1_adamw`` (tp, pp and fsdp: the
   first loss,
   through the run's own schedule, within 1e-5 relative, every gradient
   leaf gathered whole over tp, pp and dp and taken back through
   ``gpt2_from_tp_layout`` within 1e-3 of its largest magnitude, the
   step losses within 1e-4; under ZeRO each rank's Adam moment chunks
   within 1e-3 of the same chunk of the reference's moments). The 3D
   run checkpoints every step (``Trainer(checkpoint_dir=)``: every rank
   writes its part) and records its parameters gathered after step 1;
   3d_ckpt_resume cuts its directory after step 1, and a fresh world of
   8 ranks resumes from it and takes step 2: every rank's step-2 loss,
   History, parameters and both moment chunks equal the uncut run's bit
   for bit, and step 1 restored in this process with no mesh equals the
   uncut run's parameters after step 1 bit for bit (the tp-blocked
   layout). 3d_bf16 is the 3D run in bf16 (``training.dtype`` and
   ``adam_mu_dtype`` bfloat16) against the single-rank bf16 run at the
   train_bf16 phase's gates (first loss 1e-2, gradients 5e-2, step
   losses 1e-2, moment chunks 5e-2). The slice-14 runs (``MESH_MODELS``;
   each run prints its cut): Llama-3.2-1B's widths cut to 4 layers on
   rows of 1,024 (llama_tp2: 16 query and 4 kv heads a rank;
   llama_fsdp_dp2; llama_dp2pp2_1f1b_zero1: the tied table on both
   stages), Llama-MoE (2 layers, 8 SwiGLU experts, top-2, from
   ``llama_init``) on ep = 2 and GPT-2 124M with 8 mlp experts (top-2)
   on ep x tp = 2 x 2, the experts' capacity a micro-batch's tokens (no
   drop), each at the f32 gates against the single-rank run with the
   same micro-batches (ep is a batch axis), the losses with the aux
   term, and every first-batch routing decision as the reference's
   (a flip only within ``ROUTE_TIE`` of its router probabilities; the
   agreement and the drops reported). The slice-16 runs, sequence
   parallel on sp = 2 in the 2-rank world: GPT-2 124M uncut (12 layers)
   on 8 rows of its whole 1,024 positions, 512 a rank, 2 micro-batches,
   in each ``sp_mode`` (sp2_ring, sp2_zigzag: plain attention per chunk
   pair, no flash launch; sp2_ulysses: K1-K3 on 6 of the 12 heads over
   all 1,024 positions), and Llama-3.2-1B's widths at 4 layers by
   Ulysses (llama_sp2_ulysses, llama_tp2's reference), each at the f32
   gates against one rank on the same rows (all three GPT-2 runs one
   reference, whose step is also timed beside theirs). On every rank
   the counts are zeroed
   just before ``fit`` and read just after: K2 and K3 each the stage's
   layers x micro-batches x steps, K1 the same (twice under ``1f1b``,
   whose backward sub-step reruns the forward; none in ring and zigzag),
   all of the run's dtype, none routed; then one step timed (wall ms, peak memory, the optimizer
   state's bytes beside the replicated state's) and one under
   ``torch.profiler`` with each collective entered on a drained device
   (the flash kernels of the run's dtype by name a step, and the share
   of that step inside the ``collective:*`` ranges). The save and
   restore seconds and the step's bytes are printed. Since slice 18 the
   serving mesh runs join the 2-rank world (``SERVE_MESH_RUNS``; their
   one-device references made first, by the same code): the engine on
   both ranks of tp = 2 (GPT-2 124M; Llama-3.2-1B widths at 4 layers),
   sp = 2 (GPT-2 124M: serve_chunked's document through chunks of 256,
   128 positions a rank, while 3 streams decode) and ep = 2 (GPT-2 124M
   widths at 6 layers with 8 experts, top-2: dropless, and at the
   default capacity factor 1.25, which drops), greedy and sampled, with
   deterministic mode OFF on the ranks: the ranks' streams and routing
   summaries equal bit for bit, each rank's streams equal to one
   device's up to near-ties (the routing summary equal too under ep;
   with drops one device's engine is reported beside, and the traffic
   must drop), the document's last logits within 1e-4, K4 == layers x
   decode calls (+ prefills off sp) a rank; a steady decode window timed
   and profiled (the ``collective:*`` share). Since slice
   18 gpt2_moe_ep2tp2 is cut to 6 layers. Since slice 19, for the
   script's time limit, every GPT-2 training run cut to 6 layers is cut
   to 4, the sp and vp GPT-2 runs and the GPT-2 serving mesh runs to 6,
   and the Llama training runs to 2 layers; since slice 21, to make room
   for the process fleet's phase, the GPT-2 training runs (and
   gpt2_moe_ep2tp2) to 2 layers, the sp and vp GPT-2 runs and the GPT-2
   serving mesh runs to 4. A rank that raises or dies fails the phase.

Then one JSON line of each phase's wall seconds (the mesh phase's
single-rank references also on a line of their own), one of
per-kernel numbers (K4 once per variant the
serve phases launched and path, the f32 pool's with the serve and
serve_sampled runs' launches (and since slice 19 serve_wq's, serve_tier's
and serve_lora's f32-pool runs', since slice 20 serve_fleet's prefills
and since slice 21 serve_proc_fleet's; their decode launches on a line
of the replicas' 4-slot shape); K1-K3 in
f32 with the train, lora_train,
resume, llama_train and llama_packed phases' launches and every f32 mesh
rank's
together, in bf16 with the train_bf16 and llama_train_bf16 phases' and
the 3d_bf16 ranks'; since slice 18 K4 also at Llama's GQA shapes with
serve_llama's launches and at a tp2 rank's shapes, GPT-2's 6 heads and
Llama's 16 on 4, with serve_tp2's and serve_tp2_llama's ranks'; the
other serving mesh ranks' count on GPT-2's f32 lines), the card's name
and power
limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is not available or the package is missing.

Float32 matmuls run in full f32 (TF32 off for matmul and cuDNN) so the
oracle and the kernel are compared at f32 accuracy; bf16 matmuls (the
train_bf16 phase's GEMMs) run on cuBLAS's bf16 tensor-core path.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import subprocess
import sys
import time
import weakref

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# cuBLAS's deterministic mode (the resume phase) needs a fixed workspace,
# read when cuBLAS first starts: set before torch loads (H100's default
# size)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
# f32-accurate products on the tensor cores: 3xTF32 (three TF32 products
# per f32 product) at the H100 SXM's dense TF32 rate, 495 / 3 TFLOP/s
TF32X3_FLOPS_PER_S = 495e12 / 3
OPS_BASIS = "operations (3xTF32, 165 TFLOP/s)"
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
OPS_BASIS_BF16 = "operations (bf16 tensor cores, 989 TFLOP/s)"
KERNEL_TOL = 1e-4
# bf16 kernels: x max |ref|. Against their plain versions (which round p,
# ds and the outputs where the kernels do): one bf16 ulp of the largest
# value. Against the f32 plain versions on the same bf16 values: four.
BF16_TOL = 2.0 ** -7
BF16_VS_F32_TOL = 2.0 ** -5
LSE_TOL_BF16 = 1e-5              # absolute: lse is f32 in both
TIMED_ITERS = 20
DEVICE = "cuda"
TRAIN_CASE = "causal_B32_S512_train"
LLAMA_CASE = "llama_B4_H32_S1024"
ULYSSES_CASE = "sp2_ulysses_B4_H6_S1024"
FLASH_KERNELS = {                # wrapper -> the TPU kernel it replaces
    "flash_fwd": "quintnet_tpu/ops/pallas_attention.py:97",
    "flash_bwd_dkv": "quintnet_tpu/ops/pallas_attention.py:259",
    "flash_bwd_dq": "quintnet_tpu/ops/pallas_attention.py:304",
}
FLASH_SYMBOLS = {                # wrapper -> its CUDA kernel's name
    "flash_fwd": "flash_fwd_3xtf32_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_3xtf32_kernel",
    "flash_bwd_dq": "flash_bwd_dq_3xtf32_kernel",
}
FLASH_SYMBOLS_BF16 = {           # the bf16 instantiations
    "flash_fwd": "flash_fwd_bf16_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_bf16_kernel",
    "flash_bwd_dq": "flash_bwd_dq_bf16_kernel",
}
HGMMA_BF16 = "HGMMA.F32.BF16"       # wgmma m64nNk16, bf16 in, f32 out
# device kernels counted as GEMMs in a step's breakdown: CUTLASS's and
# cuBLAS's classic names, and cuBLAS's nvjet kernels (the bf16 GEMMs of
# the llama_train_bf16 step)
GEMM_NAMES = ("gemm", "nvjet")
PAGED_SYMBOLS = {                # K4 path -> its CUDA kernel's name
    "decode": "paged_decode_split_kernel",
    "prefill": "paged_prefill_3xtf32_kernel",
}
# head dims the K4 prefill kernel is built for (D rounded up to one of them)
PREFILL_WIDTHS = (8, 16, 32, 64, 128)
PAGED_STORE_TYPES = 4            # f32, bf16, fp8, int8
# K4 prefill buckets timed at start 0, f32 and int8: the serve phase's
# prefills reach 32-512 (prompts of 32-400 tokens), plus 1,024
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024)
# K4 verify widths: a draft bucket (2, 4, 8) + the row's last token
VERIFY_WIDTHS = (3, 5, 9)


def _wrappers():
    """Every kernel wrapper of the port's main paths, by name."""
    from quintnet_tpu_torch.ops import flash_kernels
    from quintnet_tpu_torch.ops.paged_attention import paged_attention

    out = {name: getattr(flash_kernels, name) for name in FLASH_KERNELS}
    out["paged_attention"] = paged_attention
    return out


def _zero_counts() -> None:
    """Every wrapper's counts to 0, each under the wrapper's lock (the
    serving fleet launches from several threads)."""
    from quintnet_tpu_torch.ops.flash_attention import flash_attention

    for fn in _wrappers().values():
        with fn.count_lock:
            fn.launches = 0
            for by in ("launches_by_variant", "launches_by_path",
                       "launches_by_dtype", "launches_by_thread"):
                if hasattr(fn, by):
                    getattr(fn, by).clear()
    flash_attention.routed = 0


def _counts() -> dict:
    out = {}
    for name, fn in _wrappers().items():
        with fn.count_lock:
            out[name] = fn.launches
    return out


def _timed_ms(fn) -> float:
    """Mean of ``TIMED_ITERS`` launches after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(TIMED_ITERS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIMED_ITERS


def _graph_ms(fn) -> float:
    """Mean time of ``fn`` over ``TIMED_ITERS`` calls captured in one CUDA
    graph and replayed after a warm-up replay (CUDA events around the
    replay): the device's time for the launches, with none of the host's
    time between them, which a small kernel's Python wrapper can
    exceed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIMED_ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIMED_ITERS


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------

def _variant(pool):
    """The K4 variant a pool's policy launches."""
    from quintnet_tpu_torch.ops.paged_attention import kernel_variant

    return kernel_variant(pool.k, pool.caches()[2:] or None)


def _paged_case(gen, *, name, S, Hq, Hkv, P, starts, dead=(), D=64, bs=16,
                M=64, layout="f32"):
    """Random q and pool in ``layout``'s store dtype, a disjoint random
    block table per live row covering its live blocks; dead rows keep an
    all-zero table and start 0 (they read the null block only). Scaled
    layouts (int8, fake_quant) also get per-block scales (random for
    int8, ones for fake_quant) and a fresh f32 run."""
    from quintnet_tpu_torch.serve.kv_quant import make_policy

    dev = DEVICE
    policy = make_policy(layout)
    live_blocks = [min((st + P - 1) // bs, M - 1) + 1 for st in starts]
    n_blocks = 1 + sum(n for s, n in enumerate(live_blocks)
                       if s not in dead)
    perm = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
            + 1).to(torch.int32)
    tables = torch.zeros((S, M), dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(live_blocks):
        if s in dead:
            continue
        tables[s, :n] = perm[used:used + n]
        used += n
    k, v = (torch.randn((n_blocks * bs, Hkv, D), generator=gen, device=dev)
            for _ in range(2))
    if layout == "int8":
        k, v = ((t * 40).round().clamp(-127, 127).to(torch.int8)
                for t in (k, v))
    else:
        k, v = k.to(policy.store_dtype), v.to(policy.store_dtype)
    case = {"name": name, "layout": layout,
            "q": torch.randn((S, Hq, P, D), generator=gen, device=dev),
            "k": k, "v": v, "tables": tables,
            "starts": torch.tensor(starts, dtype=torch.int32, device=dev),
            "bs": bs, "kw": {}}
    scaled = policy.scaled
    if scaled:
        case["kw"] = {
            "kv_scales": tuple(
                torch.rand((n_blocks, Hkv), generator=gen, device=dev)
                * 0.05 + 0.01 if layout == "int8" else
                torch.ones((n_blocks, Hkv), device=dev) for _ in range(2)),
            "fresh_kv": tuple(torch.randn((S, Hkv, P, D), generator=gen,
                                          device=dev) for _ in range(2))}
    # the least work these inputs need: a row sees positions t <= start +
    # P - 1 of its table (dead rows: position 0 of the null block). Each
    # such position is read once per kv head, from the fresh f32 run if
    # it lies in [start, start + P) under a scaled layout, else from the
    # pool at the store dtype's width with its block's two scales; q read
    # and o written once, plus the index arrays; 4*D flops per causally
    # visible (query, position) pair
    item = k.element_size()
    seen = [min(st + P, M * bs) for st in starts]
    fresh = [min(P, max(0, M * bs - st)) if scaled else 0 for st in starts]
    pooled = [n - f for n, f in zip(seen, fresh)]
    kv_bytes = sum(pooled) * Hkv * D * item * 2
    scale_bytes = (sum(-(-n // bs) for n in pooled) * Hkv * 4 * 2
                   if scaled else 0)
    fresh_bytes = sum(fresh) * Hkv * D * 4 * 2
    io_bytes = 2 * S * Hq * P * D * 4 + tables.numel() * 4 + S * 4
    visible = sum(min(st + i + 1, M * bs) for st in starts
                  for i in range(P))
    case["bytes"] = kv_bytes + scale_bytes + fresh_bytes + io_bytes
    case["flops"] = 4 * D * Hq * visible
    return case


def _library_fn(c):
    """F.scaled_dot_product_attention over a view gathered, dequantized
    and with the fresh run inserted beforehand (none of that is timed):
    a yardstick only."""
    from quintnet_tpu_torch.ops.paged_attention import (_gather_kv,
                                                        insert_runs,
                                                        repeat_kv)

    q = c["q"]
    S, Hq, P, D = q.shape
    rep = Hq // c["k"].shape[1]
    k_all, v_all = (t.float() for t in _gather_kv(
        c["k"], c["v"], c["kw"].get("kv_scales"), c["tables"],
        block_size=c["bs"]))
    if "fresh_kv" in c["kw"]:
        k_all, v_all = (insert_runs(t, f, c["starts"]) for t, f in
                        zip((k_all, v_all), c["kw"]["fresh_kv"]))
    k_all, v_all = repeat_kv(k_all, rep), repeat_kv(v_all, rep)
    T = k_all.shape[2]
    pos = c["starts"].long()[:, None] + torch.arange(P, device=DEVICE)
    mask = (torch.arange(T, device=DEVICE)[None, None, :]
            <= pos[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k_all, v_all, attn_mask=mask)


def _bound(flops, nbytes, bf16=False):
    """The least time for ``flops`` and ``nbytes``: operations at the
    3xTF32 rate (f32-accurate products) or, with ``bf16``, at the bf16
    tensor-core rate; bytes at the HBM rate; whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate, basis = ((BF16_FLOPS_PER_S, OPS_BASIS_BF16) if bf16
                   else (TF32X3_FLOPS_PER_S, OPS_BASIS))
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else basis,
            "bytes": nbytes, "flops": flops}


DECODE_STARTS = [1023, 700, 511, 300, 129, 64, 17, 0]


def _prefill_shapes():
    """(P, start) of the K4 prefill cases: every bucket at start 0, and P
    = 16, 128, 1,024 at the unaligned start 37 (P = 1,024 at 37 runs its
    pad queries past the table)."""
    return ([(P, 0) for P in (16,) + PREFILL_BUCKETS]
            + [(P, 37) for P in (16, 128, 1024)])


def _paged_cases():
    from quintnet_tpu_torch.ops.paged_attention import (kernel_path,
                                                        kernel_variant,
                                                        paged_attention,
                                                        paged_attention_ref)

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    H, bs = 12, 16
    # "main": the case whose times stand for (variant, path) in the
    # kernels line -- the decode shape, and prefill P = 128 at start 0
    cases = [_paged_case(gen, name="decode", S=8, Hq=H, Hkv=H, P=1,
                         starts=DECODE_STARTS, dead=(7,))]
    cases[0]["main"] = "decode"
    for layout in ("f32", "int8"):
        tag = "" if layout == "f32" else f"{layout}_"
        for P, st in _prefill_shapes():
            cases.append(_paged_case(gen, name=f"prefill_{tag}P{P}_start{st}",
                                     S=1, Hq=H, Hkv=H, P=P, starts=[st],
                                     layout=layout))
            if (P, st) == (128, 0):
                cases[-1]["main"] = "prefill"
    # GQA prefill: 12 query heads on 3 kv heads, one staged K/V tile a group
    cases.append(_paged_case(gen, name="prefill_gqa4_P128_start37", S=1,
                             Hq=H, Hkv=H // 4, P=128, starts=[37]))
    cases.append(_paged_case(gen, name="decode_gqa", S=8, Hq=H, Hkv=H // 2,
                             P=1, starts=[900, 450, 31, 16, 15, 200, 5, 0],
                             dead=(7,)))
    # one long row, where splitting the context matters most, and GQA at
    # group 4 (12 query heads on 3 kv heads)
    cases.append(_paged_case(gen, name="decode_long_row", S=1, Hq=H, Hkv=H,
                             P=1, starts=[1023]))
    cases.append(_paged_case(gen, name="decode_gqa4", S=8, Hq=H, Hkv=H // 4,
                             P=1, starts=[900, 450, 31, 16, 15, 200, 5, 0],
                             dead=(7,)))
    # the quantized and narrow pools: the decode shape per layout, int8
    # prefill tails, a prefill tail per other layout, the verify shape (3
    # drafts + 1) and int8 GQA
    for layout in ("int8", "bf16", "fp8", "fake_quant"):
        cases.append(_paged_case(gen, name=f"decode_{layout}", S=8, Hq=H,
                                 Hkv=H, P=1, starts=DECODE_STARTS, dead=(7,),
                                 layout=layout))
        cases[-1]["main"] = "decode"
    for layout in ("bf16", "fp8", "fake_quant"):
        cases.append(_paged_case(gen, name=f"prefill_{layout}_P128_start0",
                                 S=1, Hq=H, Hkv=H, P=128, starts=[0],
                                 layout=layout))
        cases[-1]["main"] = "prefill"
    for layout in ("f32", "int8"):
        cases.append(_paged_case(
            gen, name=f"verify_{layout}_S8_P4", S=8, Hq=H, Hkv=H, P=4,
            starts=[1019, 700, 511, 300, 129, 64, 17, 0], dead=(7,),
            layout=layout))
    # speculative decoding's verify step (serve_spec): drafts of 2, 4 and
    # 8 behind each row's last token on 8 rows at their own starts, P = 3
    # on the decode path, 5 and 9 on the prefill path
    for layout in ("f32", "int8"):
        for P in VERIFY_WIDTHS:
            cases.append(_paged_case(
                gen, name=f"verify_{layout}_S8_P{P}", S=8, Hq=H, Hkv=H, P=P,
                starts=[1019 - P, 700, 511, 300, 129, 64, 17, 0], dead=(7,),
                layout=layout))
    # chunked prefill (serve_chunked): a 1,000-token prompt's later
    # chunks, bucket 256 at offsets 256 and 768
    for st in (256, 768):
        cases.append(_paged_case(gen, name=f"prefill_chunk_P256_start{st}",
                                 S=1, Hq=H, Hkv=H, P=256, starts=[st]))
    cases.append(_paged_case(gen, name="decode_gqa_int8", S=8, Hq=H,
                             Hkv=H // 2, P=1,
                             starts=[900, 450, 31, 16, 15, 200, 5, 0],
                             dead=(7,), layout="int8"))
    # the serving slice's shapes: Llama-3.2-1B (32 query heads on 8 kv
    # heads, group 4 = the decode path's row limit) decode in f32 and
    # int8, prefill P = 128 in f32 and int8 and verify P = 3 (12 rows a
    # group: the prefill path); a tp2 GPT-2 rank's 6 heads and a tp2
    # Llama rank's 16 query heads on 4 kv heads, decode and prefill.
    # "line": the kernels-line entry each stands for, "main" the path it
    # must take (the first of a line's cases on a path times it)
    LQ, LKV = 32, 8

    def line(tag, path):
        cases[-1].update(line=tag, main=path)

    for layout in ("f32", "int8"):
        cases.append(_paged_case(gen, name=f"llama_decode_{layout}", S=8,
                                 Hq=LQ, Hkv=LKV, P=1, starts=DECODE_STARTS,
                                 dead=(7,), layout=layout))
        line("llama_gqa4", "decode")
        cases.append(_paged_case(gen, name=f"llama_prefill_{layout}_P128",
                                 S=1, Hq=LQ, Hkv=LKV, P=128, starts=[0],
                                 layout=layout))
        line("llama_gqa4", "prefill")
    cases.append(_paged_case(gen, name="llama_verify_f32_S8_P3", S=8, Hq=LQ,
                             Hkv=LKV, P=3,
                             starts=[1016, 700, 511, 300, 129, 64, 17, 0],
                             dead=(7,)))
    line("llama_gqa4", "prefill")
    for tag, hq, hkv in SERVE_MESH_LINES.values():
        cases.append(_paged_case(gen, name=f"{tag}_decode", S=8, Hq=hq,
                                 Hkv=hkv, P=1, starts=DECODE_STARTS,
                                 dead=(7,)))
        line(tag, "decode")
        cases.append(_paged_case(gen, name=f"{tag}_prefill_P128", S=1,
                                 Hq=hq, Hkv=hkv, P=128, starts=[0]))
        line(tag, "prefill")
    # the serving fleets' decode shape (serve_fleet, serve_proc_fleet): a
    # replica's 4 slots at the contexts of its prompts of 32-256 tokens,
    # 32 new
    cases.append(_paged_case(gen, name="fleet_decode_S4", S=FLEET_SLOTS,
                             Hq=H, Hkv=H, P=1, starts=[287, 200, 96, 40]))
    line("fleet_s4", "decode")
    results, outs = [], {}
    for c in cases:
        args = (c["q"], c["k"], c["v"], c["tables"], c["starts"])
        kw = dict(block_size=c["bs"], **c["kw"])
        out = paged_attention(*args, **kw)
        ref = paged_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{c['name']}: kernel output not finite")
        err = float((out - ref).abs().max())
        if err > KERNEL_TOL:
            raise AssertionError(f"{c['name']}: max_abs_err {err} > "
                                 f"{KERNEL_TOL}")
        outs[c["name"]] = out
        path = kernel_path(c["q"], c["k"])
        call = lambda: paged_attention(*args, **kw)  # noqa: E731
        plain = lambda: paged_attention_ref(*args, **kw)  # noqa: E731
        library = _library_fn(c)
        res = {"kernel": "paged_attention", "case": c["name"],
               "variant": kernel_variant(c["k"],
                                         c["kw"].get("kv_scales")),
               "path": path,
               "main": c.get("main"), "line": c.get("line"),
               "pool_dtype": str(c["k"].dtype).replace("torch.", ""),
               "shape_q": list(c["q"].shape),
               "kv_heads": c["k"].shape[1], "starts": c["starts"].tolist(),
               "max_abs_err": err,
               "kernel_ms": _graph_ms(call),
               "call_ms": _timed_ms(call),
               "plain_ms": _timed_ms(plain),
               "library_ms": _graph_ms(library),
               "library": "F.scaled_dot_product_attention on a view "
                          "gathered and dequantized beforehand, the run "
                          "inserted (yardstick)"}
        res.update(_bound(c["flops"], c["bytes"]))
        if res["main"] not in (None, res["path"]):
            raise AssertionError(f"{c['name']} took the {res['path']} path")
        _emit(res)
        results.append(res)
    for name in ("decode", "prefill_P128_start37"):
        _fake_quant_is_f32(next(c for c in cases if c["name"] == name),
                           outs[name])
    _window_update_card_equals_cpu(gen)
    return results


def _fake_quant_is_f32(c, want):
    """An f32 case again as fake_quant: the same pool with the run's
    slots (positions ``[start, start + P)`` inside the table) overwritten
    by other values, all-one scales, and the run's true K/V as the fresh
    run. The kernel's output must equal the passthrough one bit for bit
    (a scale of 1.0 and the override are exact), on the path the case
    takes."""
    from quintnet_tpu_torch.ops.paged_attention import (kernel_path,
                                                        paged_attention)

    bs, tables = c["bs"], c["tables"].long()
    S, _, P, _ = c["q"].shape
    width = tables.shape[1] * bs
    pos = c["starts"].long()[:, None] + torch.arange(P, device=DEVICE)
    live = pos < width
    pos = pos.clamp(max=width - 1)
    slot = tables.gather(1, pos // bs) * bs + pos % bs            # [S, P]
    k, v = c["k"].clone(), c["v"].clone()
    fresh = tuple((t[slot] * live[..., None, None]).permute(0, 2, 1, 3)
                  .contiguous() for t in (k, v))                  # [S, Hkv, P, D]
    for t in (k, v):
        t[slot[live]] = torch.randn_like(t[slot[live]])
    ones = torch.ones((k.shape[0] // bs, k.shape[1]), device=DEVICE)
    got = paged_attention(c["q"], k, v, c["tables"], c["starts"],
                          block_size=bs, kv_scales=(ones, ones),
                          fresh_kv=fresh)
    torch.cuda.synchronize()
    path = kernel_path(c["q"], c["k"])
    if not torch.equal(got, want):
        raise AssertionError(
            f"{c['name']} as fake_quant differs from the f32 passthrough "
            f"case ({path} path): max |diff| "
            f"{float((got - want).abs().max())}")
    _emit({"check": f"{c['name']} fake_quant == f32 bit for bit ({path} "
                    f"path)", "ok": True})


def _window_update_card_equals_cpu(gen):
    """paged_quant_window_update at the main path's shapes (12 kv heads,
    D = 64, bs = 16; a decode step of 8 rows with a dead row, and a
    128-token prefill tail at start 37), int8 and fake_quant, on the
    card and on the CPU: pools and scales byte-identical on every real
    block. Times the card's call beside."""
    from quintnet_tpu_torch.ops.paged_attention import \
        paged_quant_window_update
    from quintnet_tpu_torch.serve.kv_quant import make_policy

    H, D, bs, M = 12, 64, 16, 64
    for layout in ("int8", "fake_quant"):
        pol = make_policy(layout)
        for name, S, P, starts, lens in (
                ("decode", 8, 1, DECODE_STARTS, [1] * 7 + [1]),
                ("prefill_P128_start37", 1, 128, [37], [100])):
            nb = 1 + S * M
            perm = (torch.randperm(nb - 1, generator=gen, device=DEVICE)
                    + 1).to(torch.int32)
            tables = perm[:S * M].reshape(S, M).clone()
            if S > 1:
                tables[-1] = 0                        # a dead row
            x = torch.randn((nb * bs, H, D), generator=gen, device=DEVICE)
            cache = (pol.quant(x, torch.tensor(0.02, device=DEVICE))
                     if layout == "int8" else x)
            scales = (torch.rand((nb, H), generator=gen, device=DEVICE)
                      * 0.05 + 0.01 if layout == "int8"
                      else torch.ones((nb, H), device=DEVICE))
            vals = torch.randn((S, H, P, D), generator=gen, device=DEVICE)
            st = torch.tensor(starts, dtype=torch.int32, device=DEVICE)
            positions = st[:, None] + torch.arange(P, dtype=torch.int32,
                                                   device=DEVICE)[None, :]
            span = min(-(-P // bs) + 1, M)
            args = dict(block_tables=tables, block_size=bs, max_blocks=span)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            got = {}
            for dev in (DEVICE, "cpu"):
                c, sc = cache.clone().to(dev), scales.clone().to(dev)
                paged_quant_window_update(
                    pol, c, sc, vals.to(dev), positions.to(dev),
                    lens_t.to(dev), **{k: (v.to(dev) if torch.is_tensor(v)
                                           else v) for k, v in args.items()})
                got[dev] = (c.cpu(), sc.cpu())
            if not (torch.equal(got[DEVICE][0][bs:], got["cpu"][0][bs:])
                    and torch.equal(got[DEVICE][1][1:], got["cpu"][1][1:])):
                raise AssertionError(f"window update {layout} {name}: card "
                                     f"and CPU differ on real blocks")
            c, sc = cache.clone(), scales.clone()
            _emit({"check": f"paged_quant_window_update {layout} {name}: "
                            f"card == CPU byte for byte", "ok": True,
                   "card_ms_per_call": _timed_ms(
                       lambda: paged_quant_window_update(
                           pol, c, sc, vals, positions, lens_t, **args))})


def _packed_segments(rng, B, S, n_docs=4):
    """[B, S] int32 ids of ``n_docs`` packed documents per row, cut at
    random positions (the monotone layout PackedLMDataset produces)."""
    cuts = np.sort(rng.integers(1, S, (B, n_docs - 1)), axis=1)
    return (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(
        np.int32)


def _visible_pairs(B, S, causal, seg):
    """The (query, key) pairs these inputs attend over, summed over the
    batch (per head): the work the kernels' loops need, not their
    tiles'."""
    if seg is None:
        return B * (S * (S + 1) // 2 if causal else S * S)
    total = 0
    for row in seg:
        for n in np.bincount(row):
            total += n * (n + 1) // 2 if causal else n * n
    return int(total)


def _flash_errors(name, got, want, tols):
    """max |got - want| / max |want| for each output (lse: absolute where
    ``tols`` gives it as ("abs", tol)); raises past its tolerance."""
    errs = {}
    for key, g in got.items():
        w = want[key]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: kernel {key} not finite")
        kind, tol = tols[key]
        d = float((g.float() - w.float()).abs().max())
        errs[key] = d if kind == "abs" else d / float(
            w.float().abs().max().clamp_min(1e-30))
        if errs[key] > tol:
            raise AssertionError(f"{name}: {key} error {errs[key]} > {tol} "
                                 f"({kind})")
    return errs


def _flash_cases():
    """K1-K3 against their plain versions on the same inputs, in f32 and
    in bf16 (the same random values rounded to bf16): the backward
    kernels take the plain forward's lse and delta. The bf16 kernels are
    also held to the f32 plain versions on their bf16 inputs."""
    from quintnet_tpu_torch.ops.flash_kernels import (flash_bwd_dkv,
                                                      flash_bwd_dkv_ref,
                                                      flash_bwd_dq,
                                                      flash_bwd_dq_ref,
                                                      flash_delta, flash_fwd,
                                                      flash_fwd_ref,
                                                      visible_pairs)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    rng = np.random.default_rng(4321)
    D = 64
    # (name, B, H, S, causal, segments): the first row is the train
    # phase's shape, micro-batch 32 of 512, and an fsdp_dp2 rank's (32
    # rows, all 12 heads); the next five the mesh phase's on a tp2 rank
    # (micro-batch 32, 6 local heads), a dp2 x tp2 and fsdp_dp2tp2 rank
    # (micro-batch 4, 6 local heads), and the pipeline runs' ranks: pp2
    # (micro-batch 4), dp2 x pp2 (2) and dp2 x tp2 x pp2 (2, 6 local
    # heads; in bf16 the 3d_bf16 run's); then Llama-3.2-1B's: a
    # micro-batch of 4 rows of 1,024 with all 32 heads (the llama_train
    # phases; the 16 kv heads repeated to 32 before the call), the same
    # with packed-document segment ids (llama_packed) and a tp = 2 rank's
    # 16 heads (the llama_tp2 mesh run, and llama_sp2_ulysses: its 32
    # repeated heads over sp = 2); then an sp2_ulysses rank's: a
    # micro-batch of 4 rows, 6 of the 12 heads over all 1,024 positions;
    # last the vocab-parallel runs' ranks: vp_tp2 (micro-batch 8, 6 local
    # heads) and vp_tp2_sp2 (micro-batch 4, 3 heads over all 512
    # positions after Ulysses' exchange); llama_vp_tp2's is llama_tp2's
    shapes = [(TRAIN_CASE, 32, 12, 512, True, False),
              ("mesh_tp2_B32_H6_S512", 32, 6, 512, True, False),
              ("mesh_dp2tp2_B4_H6_S512", 4, 6, 512, True, False),
              ("mesh_pp2_B4_H12_S512", 4, 12, 512, True, False),
              ("mesh_dp2pp2_B2_H12_S512", 2, 12, 512, True, False),
              ("mesh_3d_B2_H6_S512", 2, 6, 512, True, False),
              ("causal_B8_S1024", 8, 12, 1024, True, False),
              ("causal_segments_B4_S512", 4, 12, 512, True, True),
              ("causal_ragged_B2_S300", 2, 12, 300, True, False),
              ("noncausal_B8_S256", 8, 12, 256, False, False),
              ("causal_B1_S4096", 1, 12, 4096, True, False),
              (LLAMA_CASE, 4, 32, 1024, True, False),
              ("llama_packed_B4_H32_S1024", 4, 32, 1024, True, True),
              ("llama_tp2_B4_H16_S1024", 4, 16, 1024, True, False),
              (ULYSSES_CASE, 4, 6, 1024, True, False),
              ("vp_tp2_B8_H6_S512", 8, 6, 512, True, False),
              ("vp_tp2_sp2_B4_H3_S512", 4, 3, 512, True, False)]
    f32_tols = {key: ("rel", KERNEL_TOL)
                for key in ("o", "lse", "dq", "dk", "dv")}
    bf16_tols = {"o": ("rel", BF16_TOL), "lse": ("abs", LSE_TOL_BF16),
                 "dq": ("rel", BF16_TOL), "dk": ("rel", BF16_TOL),
                 "dv": ("rel", BF16_TOL)}
    vs_f32_tols = {**{key: ("rel", BF16_VS_F32_TOL)
                      for key in ("o", "dq", "dk", "dv")},
                   "lse": ("abs", LSE_TOL_BF16)}
    results = []
    for name, B, H, S, causal, use_seg in shapes:
        q32, k32, v32, do32 = (torch.randn((B, H, S, D), generator=gen,
                                           device=DEVICE) for _ in range(4))
        seg_np = _packed_segments(rng, B, S) if use_seg else None
        seg = None if seg_np is None else torch.from_numpy(seg_np).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tag = "[bf16]" if bf16 else ""
            q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
            o, lse = flash_fwd(q, k, v, seg, causal=causal)
            o_r, lse_r = flash_fwd_ref(q, k, v, seg, causal=causal)
            delta = flash_delta(o_r, do)
            bwd_in = (q, k, v, do, lse_r, delta, seg)
            dk, dv = flash_bwd_dkv(*bwd_in, causal=causal)
            dk_r, dv_r = flash_bwd_dkv_ref(*bwd_in, causal=causal)
            dq = flash_bwd_dq(*bwd_in, causal=causal)
            dq_r = flash_bwd_dq_ref(*bwd_in, causal=causal)
            torch.cuda.synchronize()
            got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
            errs = _flash_errors(name + tag, got, {
                "o": o_r, "lse": lse_r, "dq": dq_r, "dk": dk_r, "dv": dv_r},
                bf16_tols if bf16 else f32_tols)
            errs_vs_f32 = None
            if bf16:
                # the f32 plain versions on the same bf16 values
                qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
                o_f, lse_f = flash_fwd_ref(qf, kf, vf, seg, causal=causal)
                f_in = (qf, kf, vf, dof, lse_f, flash_delta(o_f, dof), seg)
                dk_f, dv_f = flash_bwd_dkv_ref(*f_in, causal=causal)
                dq_f = flash_bwd_dq_ref(*f_in, causal=causal)
                errs_vs_f32 = _flash_errors(name + tag + " vs f32", got, {
                    "o": o_f, "lse": lse_f, "dq": dq_f, "dk": dk_f,
                    "dv": dv_f}, vs_f32_tols)
                del qf, kf, vf, dof, o_f, dk_f, dv_f, dq_f, f_in

            # SDPA yardstick: the same function in the same dtype, forward
            # and forward+backward
            mask = (None if seg is None else
                    visible_pairs(S, causal, seg, q.device).expand(B, 1, S, S))
            sdpa_kw = (dict(attn_mask=mask) if mask is not None
                       else dict(is_causal=causal))
            lib_fwd = _graph_ms(lambda: sdpa(q, k, v, **sdpa_kw))
            qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
            lib_fwd_bwd = _graph_ms(lambda: torch.autograd.grad(
                sdpa(qg, kg, vg, **sdpa_kw), (qg, kg, vg), do))
            calls = {
                "flash_fwd": (
                    lambda: flash_fwd(q, k, v, seg, causal=causal),
                    lambda: flash_fwd_ref(q, k, v, seg, causal=causal)),
                "flash_bwd_dkv": (
                    lambda: flash_bwd_dkv(*bwd_in, causal=causal),
                    lambda: flash_bwd_dkv_ref(*bwd_in, causal=causal)),
                "flash_bwd_dq": (
                    lambda: flash_bwd_dq(*bwd_in, causal=causal),
                    lambda: flash_bwd_dq_ref(*bwd_in, causal=causal)),
            }
            # (kernel, plain version, kernel call through its wrapper)
            times = {kern: (_graph_ms(kfn), _timed_ms(pfn), _timed_ms(kfn))
                     for kern, (kfn, pfn) in calls.items()}
            # each input read once, each output written once; 2 * D flops
            # per multiply-add over the visible pairs, 2 / 4 / 3 matmuls
            pairs = _visible_pairs(B, S, causal, seg_np) * H
            tile = B * H * S * D * q.element_size()
            row = B * H * S * 4
            seg_bytes = 0 if seg is None else B * S * 4
            work = {"flash_fwd": (2, 3 * tile + seg_bytes, tile + row),
                    "flash_bwd_dkv": (4, 4 * tile + 2 * row + seg_bytes,
                                      2 * tile),
                    "flash_bwd_dq": (3, 4 * tile + 2 * row + seg_bytes, tile)}
            for kern, (kernel_ms, plain_ms, call_ms) in times.items():
                n_mm, read, written = work[kern]
                err_keys = {"flash_fwd": ("o", "lse"),
                            "flash_bwd_dkv": ("dk", "dv"),
                            "flash_bwd_dq": ("dq",)}[kern]
                res = {"kernel": kern + tag, "case": name, "dtype": str(dtype),
                       "B": B, "H": H, "S": S, "D": D, "causal": causal,
                       "segments": use_seg,
                       "max_abs_err": max(errs[e] for e in err_keys),
                       "errors": errs,
                       "err_relative_to": "largest magnitude in the "
                                          "reference (bf16 lse: absolute)",
                       "kernel_ms": kernel_ms, "call_ms": call_ms,
                       "plain_ms": plain_ms,
                       "library_ms": (lib_fwd if kern == "flash_fwd"
                                      else lib_fwd_bwd - lib_fwd),
                       "library": (f"F.scaled_dot_product_attention forward, "
                                   f"{dtype} (yardstick)"
                                   if kern == "flash_fwd" else
                                   f"F.scaled_dot_product_attention forward+"
                                   f"backward minus forward, {dtype}: the "
                                   f"whole backward, dq, dk and dv "
                                   f"(yardstick)")}
                if errs_vs_f32 is not None:
                    res["errors_vs_f32_plain"] = errs_vs_f32
                res.update(_bound(2 * D * pairs * n_mm, read + written,
                                  bf16=bf16))
                _emit(res)
                results.append(res)
            if name == TRAIN_CASE:
                results.append(_backward_pair(
                    name, times, lib_fwd_bwd - lib_fwd,
                    max(errs["dq"], errs["dk"], errs["dv"]),
                    lambda: (flash_bwd_dkv(*bwd_in, causal=causal),
                             flash_bwd_dq(*bwd_in, causal=causal)),
                    2 * D * pairs * 5,
                    4 * tile + 2 * row + seg_bytes + 3 * tile, bf16=bf16))
            del q, k, v, do, o, o_r, dk, dv, dq, dk_r, dv_r, dq_r, qg, kg, vg
            del got, bwd_in
        del q32, k32, v32, do32
    return results


def _backward_pair(case, times, library_ms, err, launch_both, flops,
                   nbytes, bf16=False):
    """K2 and K3 as one backward beside SDPA's whole backward (the only
    fair pairing: SDPA's yardstick computes dq, dk and dv together). The
    bound counts the 5 products one fused backward needs, so the split's
    recomputation of s and dp (7 products) shows as lost time."""
    res = {"kernel": "backward (K2 + K3)" + (" [bf16]" if bf16 else ""),
           "case": case,
           "kernel_ms": times["flash_bwd_dkv"][0] + times["flash_bwd_dq"][0],
           "kernel_ms_measured_together": _graph_ms(launch_both),
           "plain_ms": times["flash_bwd_dkv"][1] + times["flash_bwd_dq"][1],
           "max_abs_err": err,
           "library_ms": library_ms,
           "library": "F.scaled_dot_product_attention forward+backward minus "
                      "forward (yardstick)"}
    res.update(_bound(flops, nbytes, bf16=bf16))
    res["share_of_bound"] = res["bound_ms"] / res["kernel_ms"]
    res["vs_library"] = res["kernel_ms"] / library_ms
    _emit(res)
    return res


def _sass_census(path):
    """Per kernel of a built library: its tensor-core (HMMA; wgmma's HGMMA
    with bf16 in and f32 out, ``HGMMA_BF16``), atomic (ATOM, RED),
    local-memory (LDL, STL: register spills) and f32 FMA (FFMA)
    instructions, from ``cuobjdump -sass``."""
    from quintnet_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    census, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            census[fn] = {"HMMA": 0, "ATOM": 0, "RED": 0, "FFMA": 0,
                          "LDL": 0, "STL": 0, HGMMA_BF16: 0}
        elif fn is not None and "/*" in ln:
            op = ln.split("*/", 1)[1].split()
            op = [w for w in op if not w.startswith("@")][:1]
            if op:
                head = op[0].split(".")[0]
                if head.startswith("ATOM"):
                    head = "ATOM"
                elif head in ("REDG", "REDAS"):
                    head = "RED"
                if head in census[fn]:
                    census[fn][head] += 1
                if head == "HGMMA" and ".F32.BF16" in op[0]:
                    census[fn][HGMMA_BF16] += 1
    return census


def _check_sass(paths):
    """The flash kernels and K4's prefill path run on the tensor cores and
    no K1-K4 kernel uses atomics (each output element has one writer):
    every instantiation of K1, K2, K3 and of the K4 prefill kernel holds
    HMMA instructions and no ATOM or RED; every bf16 instantiation of K1,
    K2 and K3 holds wgmma (``HGMMA.*.F32.BF16``: bf16 operands, f32 sums)
    and no ATOM, RED or local-memory spill (LDL, STL); and no
    instantiation of the K4 decode kernel holds ATOM or RED."""
    census = _sass_census(paths["flash_attention"])
    out = {}
    for wrapper, sym in FLASH_SYMBOLS_BF16.items():
        fns = {f: c for f, c in census.items() if sym in f}
        if len(fns) != 3:
            raise AssertionError(f"{wrapper}: {len(fns)} instantiations of "
                                 f"{sym} in the SASS (want 3: D = 32, 64, "
                                 f"128)")
        for f, c in fns.items():
            if (c[HGMMA_BF16] == 0 or c["ATOM"] or c["RED"] or c["LDL"]
                    or c["STL"]):
                raise AssertionError(
                    f"{f}: SASS census {c}: want {HGMMA_BF16} > 0 and no "
                    f"ATOM / RED / LDL / STL")
        out[wrapper + "[bf16]"] = sorted(fns.values(),
                                         key=lambda c: c[HGMMA_BF16])
    for wrapper, sym in FLASH_SYMBOLS.items():
        fns = {f: c for f, c in census.items() if sym in f}
        if len(fns) != 3:
            raise AssertionError(f"{wrapper}: {len(fns)} instantiations of "
                                 f"{sym} in the SASS (want 3: D = 32, 64, "
                                 f"128)")
        for f, c in fns.items():
            if c["HMMA"] == 0 or c["ATOM"] or c["RED"]:
                raise AssertionError(f"{f}: SASS census {c}: want HMMA > 0 "
                                     f"and no ATOM / RED")
        out[wrapper] = sorted(fns.values(), key=lambda c: c["HMMA"])
    census = _sass_census(paths["paged_attention"])
    decode = {f: c for f, c in census.items() if PAGED_SYMBOLS["decode"] in f}
    prefill = {f: c for f, c in census.items()
               if PAGED_SYMBOLS["prefill"] in f}
    if not decode:
        raise AssertionError(f"no {PAGED_SYMBOLS['decode']} in the SASS")
    want = len(PREFILL_WIDTHS) * PAGED_STORE_TYPES
    if len(prefill) != want:
        raise AssertionError(f"{len(prefill)} instantiations of "
                             f"{PAGED_SYMBOLS['prefill']} in the SASS (want "
                             f"{want}: D in {PREFILL_WIDTHS} x 4 store types)")
    for f, c in list(decode.items()) + list(prefill.items()):
        if c["ATOM"] or c["RED"] or (f in prefill and c["HMMA"] == 0):
            raise AssertionError(f"{f}: SASS census {c}: want no ATOM / RED"
                                 f" (and HMMA > 0 on the prefill path)")
    out["paged_attention_decode"] = {"instantiations": len(decode),
                                     "atomics": 0}
    out["paged_attention_prefill"] = {
        "instantiations": len(prefill), "atomics": 0,
        "hmma_min_max": [min(c["HMMA"] for c in prefill.values()),
                         max(c["HMMA"] for c in prefill.values())]}
    _emit({"check": "K1, K2, K3 (f32 and bf16) and K4 prefill SASS: tensor "
                    "cores (HMMA; in bf16 HGMMA.*.F32.BF16 for K1, K2 and "
                    "K3, with no local-memory spill), no atomics; K4 decode "
                    "SASS: no atomics",
           "ok": True,
           "census": out})


def phase_kernels():
    from quintnet_tpu_torch.ops import build

    t0 = time.perf_counter()
    paths = build.build(["paged_attention", "flash_attention"])
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
                       if log.exists() else ["(library was already built)"])
    _emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
           "libraries": {k: str(v.name) for k, v in paths.items()},
           "ptxas": ptxas})
    _check_sass(paths)
    return _paged_cases(), _flash_cases()


# ---------------------------------------------------------------------
# phase 2: GPT-2 124M served on the card
# ---------------------------------------------------------------------

def _dense_logits(params, ids, cfg):
    """The model's dense eval forward, [B, T] ids -> [B, T, V] logits:
    GPT-2's or Llama's, by the config's family."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_apply
    from quintnet_tpu_torch.models.llama import llama_apply

    return (gpt2_apply if isinstance(cfg, GPT2Config) else llama_apply)(
        params, ids, cfg)


def _dense_generate(params, ids, cfg, **kw):
    """The family's dense KV-cache decoder (``gpt2_generate`` or
    ``llama_generate``)."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
    from quintnet_tpu_torch.models.llama_generate import llama_generate

    fn = gpt2_generate if isinstance(cfg, GPT2Config) else llama_generate
    return fn(params, ids, cfg, **kw)


def _check_against_dense(params, cfg, eng, rids, prompts, gap_limit):
    """Teacher-forced greedy oracle: one dense forward per request over
    prompt + generated[:-1]; the argmax at each prompt-end-or-later
    position must be the engine's next token. A mismatch fails unless
    the dense top-2 gap there is below ``gap_limit``; those are returned
    with their gaps. Returns (tokens checked, mismatches)."""
    from quintnet_tpu_torch.models.gpt2 import gpt2_apply

    mismatches, checked = [], 0
    for rid, prompt in zip(rids, prompts):
        out = eng.result(rid)
        gen = out[len(prompt):]
        seq = torch.from_numpy(out[:-1].astype(np.int64)).to(DEVICE)[None]
        with torch.no_grad():
            logits = _dense_logits(params, seq, cfg)[0]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"request {rid}: dense logits not finite")
        rows = logits[len(prompt) - 1:]
        top2 = torch.topk(rows, 2, dim=-1)
        want = top2.indices[:, 0].cpu().numpy()
        gaps = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        for i, (w, g) in enumerate(zip(want, gen)):
            checked += 1
            if int(w) == int(g):
                continue
            gap = float(gaps[i])
            if gap >= gap_limit:
                raise AssertionError(
                    f"request {rid} step {i}: engine token {int(g)} != "
                    f"dense greedy {int(w)} with top-2 gap {gap}")
            mismatches.append({"rid": rid, "step": i, "engine": int(g),
                               "dense": int(w), "top2_gap": gap})
    return checked, mismatches


def _device_ops(prof, spans=()):
    """name -> (device us, count) over the profiler's device events
    (kernels, copies); one stream, so their sum is the busy time. The
    device-side marks of the ``record_function`` ranges named in
    ``spans`` (which cover the idle gaps between their kernels) are left
    out."""
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in spans):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.self_device_time_total, n + 1)
    return by_name


def _span_device(prof, name):
    """(device us, kernels) launched inside the ``record_function``
    ranges called ``name``, children included."""
    us, n = 0.0, 0

    def kernels(e):
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)

    for e in prof.events():
        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
            us += e.device_time_total
            n += kernels(e)
    return us, n


# a window whose gated kernels came short by lost records is profiled
# again, at most twice
PROFILED_WINDOWS = 3


def _lost_records(prof):
    """The kernel-launch runtime records (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cuLaunchKernelEx``, ...) of a profiled window
    whose correlation id no device record carries: kernels that ran but
    whose records the profiler dropped, so the window undercounts them.
    Returns the name of the op that made each such launch -> count;
    empty when the window holds no device record at all (no device time
    measured)."""
    launches, device_ids = [], set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_ids.add(e.id)
        elif "LaunchKernel" in e.name:
            launches.append(e)
    if not device_ids:
        return {}
    return dict(collections.Counter(
        getattr(e.cpu_parent, "name", "(no op)") for e in launches
        if e.id not in device_ids))


def _profiled(run, spans=(), expect=None, agree=None):
    """(profile, device ops by name) of a window of ``run()`` under
    ``torch.profiler``. The profiler drops a kernel record now and then
    (``_lost_records``); a window that lost records is reported on a line
    of its own: how many, the ops that launched them, and which
    ``expect``ed kernels (symbol -> launches the window makes) came short
    of their launches. Only a shortfall beside lost records is profiled
    again, ``PROFILED_WINDOWS`` windows at most, since the records lost
    may be the expected kernels'. The caller's gate stays exact: it
    fails on a shortfall that no lost record explains, on a count above
    the launches, and on a shortfall still there in the last window.

    ``agree``: where ``run()`` makes collectives, every rank must run it
    as often as the others; ``agree(again)`` turns this rank's wish to
    profile again into the world's (``_any_rank``)."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, PROFILED_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            _sync()
        by_name = _device_ops(prof, spans)
        lost = _lost_records(prof)
        short = {}
        for sym, n in (expect or {}).items():
            seen = sum(k for name, (_, k) in by_name.items() if sym in name)
            if seen < n:
                short[sym] = {"records": seen, "launched": n}
        again = bool(short and lost) and window < PROFILED_WINDOWS
        if agree is not None:
            again = agree(again)
        if lost:
            _emit({"check": "profiled window lost kernel records",
                   "window": window, "lost_records": sum(lost.values()),
                   "launched_by": lost, "short_kernels": short,
                   "profiled_again": again})
        if not again:
            return prof, by_name


def _any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank of the world
    (``core/runtime.any_rank``)."""
    from quintnet_tpu_torch.core import runtime

    return runtime.any_rank(flag)


def _kernel_share(eng, cfg, rng, *, window_update=False) -> dict:
    """Over steady decode steps (8 rows, ~300-token contexts): the
    steps' wall time from a window run WITHOUT the profiler (it slows
    the host), then the kernel's device time, the device's busy time
    and the heaviest device ops from the next window of as many steps
    under ``torch.profiler`` (device durations do not depend on the
    host's pace). ``window_update``: also the device time and launches
    of ``paged_quant_window_update`` (a scaled policy's pool write),
    each call wrapped in a ``record_function`` range for the profiled
    window only."""
    from torch.profiler import record_function

    from quintnet_tpu_torch.nn import attention

    steps = 6
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, cfg.vocab_size, 300),
                   (1 + PROFILED_WINDOWS) * steps + 8)
    eng.step()                       # admissions + first decode
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()                   # ends in a device->host token copy
    wall = time.perf_counter() - t0
    update = attention.paged_quant_window_update
    if window_update:
        def spanned(*a, **k):
            with record_function("paged_quant_window_update"):
                return update(*a, **k)
        attention.paged_quant_window_update = spanned
    # one device kernel a decode-path call (its splits combine inside the
    # cluster launch): every steady step is a decode step, so n_layer
    # decode-path kernels a step and no prefill
    want = {"decode": _depth(cfg) * steps, "prefill": 0}
    try:
        prof, by_name = _profiled(
            lambda: [eng.step() for _ in range(steps)],
            spans=("paged_quant_window_update",),
            expect={PAGED_SYMBOLS[p]: n for p, n in want.items()})
    finally:
        attention.paged_quant_window_update = update
    eng.run()

    busy_us = sum(us for us, _ in by_name.values())
    # K4's device kernels by CUDA symbol
    kern_us, per_path = 0.0, {}
    for path, sym in PAGED_SYMBOLS.items():
        n = 0
        for name, (us, k) in by_name.items():
            if sym in name:
                kern_us, n = kern_us + us, n + k
        per_path[path] = n
    if busy_us > 0 and per_path != want:
        raise AssertionError(
            f"profiler: K4 device kernels over {steps} decode steps "
            f"{per_path}; expected {want} (n_layer x steps, by symbol "
            f"{PAGED_SYMBOLS})")
    launches = sum(per_path.values())
    out = {"decode_steps_profiled": steps,
           "decode_step_ms": wall / steps * 1e3,
           "kernel_launches_profiled": launches,
           "device_launches_per_step": sum(n for _, n in by_name.values())
           / steps}
    if busy_us > 0:
        out["kernel_ms_per_step"] = kern_us / 1e3 / steps
        out["kernel_share_of_decode_step"] = kern_us / 1e6 / wall
        out["device_busy_ms_per_step"] = busy_us / 1e3 / steps
        out["device_idle_share"] = 1.0 - busy_us / 1e6 / wall
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        out["top_device_ops_ms_per_step"] = {
            name[:80]: us / 1e3 / steps for name, (us, _) in top}
        if window_update:
            wu_us, wu_n = _span_device(prof, "paged_quant_window_update")
            out["window_update_ms_per_step"] = wu_us / 1e3 / steps
            out["window_update_share_of_decode_step"] = wu_us / 1e6 / wall
            out["window_update_share_of_device_busy"] = wu_us / busy_us
            out["window_update_launches_per_step"] = wu_n / steps
            out["other_device_ms_per_step"] = (busy_us - kern_us
                                               - wu_us) / 1e3 / steps
    else:
        out["kernel_share_of_decode_step"] = "not measured (profiler " \
                                             "reported no device time)"
    return out


SERVE_LENS = [32, 400, 120, 57, 250, 333, 75]
# a greedy token may differ from the dense oracle's only where the dense
# top-2 logit gap is below this: the f32 pool sums in another order
# than the dense path; a narrow pool also changes K/V values (fp8's
# flips read gaps of 0.0087-0.0173 at GPT-2 124M, seed 0)
F32_GAP, NARROW_GAP = 1e-3, 0.05
SERVE_MAX_NEW = 32


def _serve_script(eng, cfg):
    """The serve phases' 8 requests: 7 at once (prompts of 32-400
    tokens), then request 7, which continues request 2's conversation
    (its whole published chain, a partial last block, plus 60 tokens:
    a prefix hit with copy-on-write). Returns (request ids, prompts,
    per-step (wall s, admissions, decode tokens), the rng)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_LENS]
    steps = []

    def timed_step():
        a0, d0 = eng.metrics.admitted, eng.metrics.decode_tokens
        t = time.perf_counter()
        eng.step()                  # ends in a device->host token copy
        steps.append((time.perf_counter() - t, eng.metrics.admitted - a0,
                      eng.metrics.decode_tokens - d0))

    rids = [eng.submit(p, SERVE_MAX_NEW) for p in prompts]
    while eng.request(rids[2]).state != "finished":
        timed_step()
    prev = eng.result(rids[2])
    follow = np.concatenate([prev[:-1], rng.integers(
        0, cfg.vocab_size, 60).astype(np.int32)])
    prompts.append(follow)
    rids.append(eng.submit(follow, SERVE_MAX_NEW))
    while eng.has_work:
        timed_step()
    return rids, prompts, steps, rng


def _check_serve_run(eng, cfg, rids, launches):
    """Every layer of every prefill and every decode step went through
    the policy's kernel variant, and nothing else launched the kernel;
    the prefix cache hit; every request finished."""
    m = eng.metrics
    variant = _variant(eng.pool)
    L = _depth(cfg)
    expected = L * (m.decode_steps + m.admitted)
    by_path = {"decode": L * m.decode_steps, "prefill": L * m.admitted}
    # the CPU (the rehearsals in tests/test_torch_chip_smoke.py) runs the
    # kernel's plain version, which launches nothing
    if torch.device(DEVICE).type == "cuda" and (
            launches["total"] != expected
            or launches["by_variant"] != {variant: expected}
            or launches["by_path"] != by_path):
        raise AssertionError(
            f"paged_attention launched {launches}; expected n_layer x "
            f"(decode steps + prefills) = {expected}, all {variant}, "
            f"{by_path} by path")
    if m.prefix_hit_tokens < 64:
        raise AssertionError(f"prefix cache hit only "
                             f"{m.prefix_hit_tokens} tokens (< 64)")
    if m.finished != len(rids):
        raise AssertionError(f"{m.finished} of {len(rids)} finished")


def _serve_numbers(eng, rids, prompts, steps):
    m = eng.metrics
    decode_only = [(w, d) for w, a, d in steps if a == 0]
    return {"requests": len(rids), "prompt_lens": [len(p) for p in prompts],
            "max_new_tokens": SERVE_MAX_NEW, "steps": m.steps,
            "decode_steps": m.decode_steps, "admitted": m.admitted,
            "decode_tokens": m.decode_tokens,
            "prefill_tokens": m.prefill_tokens,
            "prefix_hit_tokens": m.prefix_hit_tokens,
            "kv_bytes_per_token": eng.pool.bytes_per_token,
            "kv_pool_bytes": eng.pool.pool_bytes,
            "decode_only_steps": len(decode_only),
            "decode_tokens_per_s": (sum(d for _, d in decode_only)
                                    / sum(w for w, _ in decode_only)),
            "decode_step_ms_p50": float(np.median(
                [w for w, _ in decode_only]) * 1e3),
            "ttft_p50_s": m.summary()["ttft_s"]["p50"]}


def _launches():
    from quintnet_tpu_torch.ops.paged_attention import paged_attention

    with paged_attention.count_lock:
        return {"total": paged_attention.launches,
                "by_variant": dict(paged_attention.launches_by_variant),
                "by_path": dict(paged_attention.launches_by_path),
                "by_thread": dict(paged_attention.launches_by_thread)}


def _serve_engine(params, cfg, kv_dtype="f32", **kw):
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    eng = ServeEngine(gpt2_family(cfg), params, device=DEVICE, max_slots=8,
                      block_size=16, num_blocks=320, kv_dtype=kv_dtype, **kw)
    t0 = time.perf_counter()
    eng.warmup()
    _sync()
    return eng, time.perf_counter() - t0


def phase_serve():
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    cfg = GPT2Config.base()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = gpt2_init(gen, cfg)
    eng, warmup_s = _serve_engine(params, cfg)

    # main path: counts zeroed just before, read just after
    _zero_counts()
    rids, prompts, steps, rng = _serve_script(eng, cfg)
    counts = _counts()
    launches = _launches()
    _check_serve_run(eng, cfg, rids, launches)
    checked, near_ties = _check_against_dense(params, cfg, eng, rids,
                                              prompts, F32_GAP)
    res = {"phase": "serve", "model": "gpt2-124M (random init, seed 0)",
           "kv_dtype": "f32", "warmup_s": warmup_s, "launches": counts,
           "launches_by_variant": launches["by_variant"],
           "launches_by_path": launches["by_path"],
           "tokens_checked_vs_dense": checked, "near_ties": near_ties}
    res.update(_serve_numbers(eng, rids, prompts, steps))
    res.update(_kernel_share(eng, cfg, rng))
    _emit(res)
    streams = [eng.result(r) for r in rids]
    return res, counts, (params, cfg, streams)


# ---------------------------------------------------------------------
# phase 2b: sampled serving through K4
# ---------------------------------------------------------------------

SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
# the preemption run's pool: 47 usable blocks of 16 hold any one request
# of the script (27 blocks at most) but not its working set (~95)
PREEMPT_BLOCKS = 48


def _sampled_engine(params, cfg, num_blocks=320):
    return _engine_on_card(params, cfg, num_blocks=num_blocks, **SAMPLED)


def _perturbed_gap(params, cfg, seq, t0, i, seed):
    """The gap between the two best perturbed scores (filtered logits /
    T + the chain's noise) the dense forward gives request token ``i``:
    teacher-forced over ``seq[:t0 + i]``, drawn at (``seed``, ``i``)."""
    from quintnet_tpu_torch.models.gpt2_generate import (chain_gumbel,
                                                         filter_logits)

    ids = torch.from_numpy(seq[:t0 + i].astype(np.int64)).to(DEVICE)[None]
    with torch.no_grad():
        logits = _dense_logits(params, ids, cfg)[:, -1]
    scores = filter_logits(logits, **SAMPLED) + chain_gumbel(
        [seed], [i], logits.shape[-1], logits.device)
    top2 = torch.topk(scores[0], 2).values
    return float(top2[0] - top2[1])


def _check_sampled_vs_dense(params, cfg, eng, rids, prompts):
    """Each request's sampled stream against the port's dense decoder
    (``gpt2_generate`` or ``llama_generate``) of its prompt at its seed on
    the card: equal up to the first position where the two best perturbed
    scores lie within the serve phase's near-tie gap (``F32_GAP``); a
    divergence anywhere else fails. Returns (tokens agreeing, tokens
    compared, divergences)."""
    agree, compared, diverged = 0, 0, []
    for rid, prompt in zip(rids, prompts):
        out = eng.result(rid)
        gen = out[len(prompt):]
        seed = eng.request(rid).seed
        dense = _dense_generate(params, prompt[None], cfg,
                                max_new_tokens=len(gen), seed=seed,
                                **SAMPLED)[0, len(prompt):]
        diff = np.nonzero(gen != dense)[0]
        n = len(gen) if diff.size == 0 else int(diff[0])
        agree += n
        compared += len(gen)
        if diff.size:
            gap = _perturbed_gap(params, cfg, out, len(prompt), n, seed)
            diverged.append({"rid": rid, "step": n, "engine": int(gen[n]),
                             "dense": int(dense[n]),
                             "perturbed_top2_gap": gap})
            if gap >= F32_GAP:
                raise AssertionError(
                    f"request {rid} step {n}: sampled engine token "
                    f"{int(gen[n])} != dense decoder {int(dense[n])} with "
                    f"perturbed top-2 gap {gap} (>= {F32_GAP})")
    return agree, compared, diverged


def _first_divergence(a, b):
    """(request index, position) of the first token two runs' streams
    differ at, or None."""
    for r, (x, y) in enumerate(zip(a, b)):
        if not np.array_equal(x, y):
            n = min(len(x), len(y))
            d = np.nonzero(x[:n] != y[:n])[0]
            return r, int(d[0]) if d.size else n
    return None


def _chain_card_equals_cpu():
    """One step's [8, 50,257] draw of the chain's integers on the card and
    on the CPU, bit for bit."""
    from quintnet_tpu_torch.models.gpt2_generate import chain_bits

    seeds, ctr = list(range(8)), [0, 1, 5, 31, 32, 100, 999, 7]
    card = chain_bits(seeds, ctr, 50257, DEVICE).cpu()
    cpu = chain_bits(seeds, ctr, 50257, "cpu")
    if not torch.equal(card, cpu):
        raise AssertionError(
            f"the chain's integers differ card vs CPU at "
            f"{int((card != cpu).sum())} of {cpu.numel()}")
    return cpu.numel()


def phase_serve_sampled(params, cfg, greedy):
    """``_serve_script`` through a sampled engine (``SAMPLED``, f32 pool,
    each request at its rid's seed): K4 launches as the serve phase
    counts them, the streams reproduced by a fresh engine bit for bit
    and by one whose pool is too small (preemptions) bit for bit, held
    to the dense decoder up to near-ties, the chain's integers card ==
    CPU, and the steady sampled decode step beside the greedy one
    (``greedy``: the serve phase's result)."""
    eng = _sampled_engine(params, cfg)
    _zero_counts()
    rids, prompts, steps, rng = _serve_script(eng, cfg)
    counts = _counts()
    launches = _launches()
    _check_serve_run(eng, cfg, rids, launches)
    streams = [eng.result(r) for r in rids]

    again = _sampled_engine(params, cfg)
    rids2, _, _, _ = _serve_script(again, cfg)
    div = _first_divergence(streams, [again.result(r) for r in rids2])
    if div is not None:
        raise AssertionError(f"sampled streams not reproduced by a fresh "
                             f"engine: request {div[0]}, token {div[1]}")
    del again
    small = _sampled_engine(params, cfg, num_blocks=PREEMPT_BLOCKS)
    rids3, _, _, _ = _serve_script(small, cfg)
    preempted = small.metrics.preempted
    if preempted < 1:
        raise AssertionError(f"the {PREEMPT_BLOCKS}-block pool preempted "
                             f"nothing")
    div = _first_divergence(streams, [small.result(r) for r in rids3])
    if div is not None:
        raise AssertionError(
            f"preempted run differs from the uninterrupted one: request "
            f"{div[0]}, token {div[1]} ({preempted} preemptions)")
    del small

    agree, compared, diverged = _check_sampled_vs_dense(params, cfg, eng,
                                                        rids, prompts)
    noise = _chain_card_equals_cpu()
    res = {"phase": "serve_sampled",
           "model": "gpt2-124M (random init, seed 0)", "kv_dtype": "f32",
           "sampling": SAMPLED, "seeds": "each request's rid",
           "launches": counts, "launches_by_variant":
           launches["by_variant"], "launches_by_path": launches["by_path"],
           "reproduced_by_fresh_engine": True,
           "preemption_run": {"num_blocks": PREEMPT_BLOCKS,
                              "preemptions": preempted, "streams_equal":
                              True},
           "tokens_agreeing_with_dense": agree,
           "tokens_compared_with_dense": compared,
           "divergences_at_near_ties": diverged,
           "chain_integers_card_equal_cpu": noise}
    res.update(_serve_numbers(eng, rids, prompts, steps))
    share = _kernel_share(eng, cfg, rng)
    res.update(share)
    res["decode_step_ms_sampled_vs_greedy"] = [share["decode_step_ms"],
                                               greedy["decode_step_ms"]]
    _emit(res)
    return res


# ---------------------------------------------------------------------
# phase 2b': speculative decoding and chunked prefill through K4
# ---------------------------------------------------------------------

SPEC_REQUESTS = 8
SPEC_SEEDS = tuple(range(100, 100 + SPEC_REQUESTS))
# serve_chunked: one document of 1,000 tokens (+16 new) through prefill
# buckets up to 256, at most 256 chunk tokens a step, while three
# streams decode; the widened engine's window holds it whole (1,024)
CHUNK_PROMPT, CHUNK_NEW, CHUNK_WINDOW, CHUNK_BUDGET = 1000, 16, 256, 256
CHUNK_STREAMS, CHUNK_STREAM_NEW = (40, 75, 120), 48


def _spec_traffic(cfg, rng):
    """serve_spec's requests: even ones tile a random 5-16-token pattern
    (to 48-160 tokens), odd ones are random (32-200 tokens); 32-64 new
    tokens each."""
    prompts = []
    for i in range(SPEC_REQUESTS):
        if i % 2 == 0:
            pat = rng.integers(0, cfg.vocab_size, int(rng.integers(5, 17)))
            prompts.append(np.tile(pat, 10)[:int(rng.integers(48, 161))])
        else:
            prompts.append(rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(32, 201))))
    return ([p.astype(np.int32) for p in prompts],
            [int(n) for n in rng.integers(32, 65, SPEC_REQUESTS)])


def _engine_on_card(params, cfg, **kw):
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    kw = {"max_slots": 8, "block_size": 16, "num_blocks": 320,
          "kv_dtype": "f32", **kw}
    eng = ServeEngine(gpt2_family(cfg), params, device=DEVICE, **kw)
    eng.warmup()
    _sync()
    return eng


class _Calls:
    """Counts an engine's decode calls and records the run width of each
    of its verify calls (its bound methods wrapped)."""

    def __init__(self, eng):
        self.decode, self.verify, self.committed = 0, [], 0
        decode, verify, step = eng._decode, eng._verify, eng._verify_step

        def counted_decode(*a, **k):
            self.decode += 1
            return decode(*a, **k)

        def recorded_verify(ids, *a, **k):
            self.verify.append(int(ids.shape[1]))
            return verify(ids, *a, **k)

        def verify_step(*a, **k):
            out = step(*a, **k)
            self.committed += out[0]
            return out

        eng._decode, eng._verify = counted_decode, recorded_verify
        eng._verify_step = verify_step


def _sync() -> None:
    """Wait for the card (no-op where there is none: the CPU rehearsals
    of the serving mesh runs in ``tests/test_torch_chip_smoke.py``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _run_requests(eng, prompts, max_new, seeds):
    """Submit every request, step to the end: (streams, wall s)."""
    _sync()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n, seed=s) for p, n, s in zip(prompts, max_new,
                                                        seeds)]
    eng.run()
    _sync()
    return [eng.result(r) for r in rids], time.perf_counter() - t0


def _near_tie_compare(params, cfg, got, want, prompts, seeds=None):
    """Streams ``got`` against ``want`` (one device, two paths through
    K4): equal up to each request's first differing token, which must be
    a near-tie: the dense top-2 logit gap there (with ``seeds``, the gap
    of the two best perturbed scores at the request's seed) below
    ``F32_GAP``. Returns (tokens agreeing, compared, divergences)."""
    agree = compared = 0
    div = []
    for r, (g, w, p) in enumerate(zip(got, want, prompts)):
        a, b = g[len(p):], w[len(p):]
        if len(a) != len(b):
            raise AssertionError(f"request {r}: {len(a)} tokens vs "
                                 f"{len(b)}")
        d = np.nonzero(a != b)[0]
        agree += len(a) if d.size == 0 else int(d[0])
        compared += len(a)
        if d.size == 0:
            continue
        i = int(d[0])
        gap = (_perturbed_gap(params, cfg, g, len(p), i, seeds[r])
               if seeds is not None
               else _greedy_gap_check(params, cfg, g, len(p), i))
        div.append({"request": r, "step": i, "got": int(a[i]),
                    "want": int(b[i]), "top2_gap": gap})
        if gap >= F32_GAP:
            raise AssertionError(
                f"request {r} step {i}: token {int(a[i])} != {int(b[i])} "
                f"with top-2 gap {gap} (>= {F32_GAP})")
    return agree, compared, div


def _check_launches(launches, variant, want):
    """K4's launches of one run: ``want`` by path, all of ``variant``."""
    total = sum(want.values())
    if (launches["total"] != total
            or launches["by_variant"] != ({variant: total} if total else {})
            or {k: launches["by_path"].get(k, 0) for k in want} != want):
        raise AssertionError(f"paged_attention launched {launches}; "
                             f"expected {want} by path, all {variant}")


def phase_serve_spec(params, cfg):
    """Speculative decoding on GPT-2 124M (f32 pool, 8 slots): 8 requests,
    half tiling a short pattern, greedy and sampled (``SAMPLED``), each
    run spec-off and spec-on. Gates: spec-on streams == spec-off up to
    reported near-ties; K4 == n_layer x (decode calls + prefills) and
    n_layer x verify calls, each verify on the path of its width (P = 3:
    decode; 5, 9: prefill), all f32 passthrough; fake_quant with spec ==
    f32 with spec bit for bit. Reported: acceptance, tokens a verify
    step, engine steps and wall time on and off (random weights: the
    acceptance is random-weight dynamics, not a model's)."""
    from quintnet_tpu_torch.ops.paged_attention import _path

    prompts, max_new = _spec_traffic(cfg, np.random.default_rng(17))
    L = cfg.n_layer
    res = {"phase": "serve_spec", "model": "gpt2-124M (random init, seed "
           "0)", "kv_dtype": "f32", "slots": 8, "spec": "SpecConfig() "
           "(n-gram drafts, max 8, verify buckets 2/4/8)",
           "prompt_lens": [len(p) for p in prompts], "max_new": max_new,
           "seeds": list(SPEC_SEEDS), "runs": {},
           "launches_by_path": {"decode": 0, "prefill": 0}}
    greedy_on = None
    for mode, kw in (("greedy", {}), ("sampled", SAMPLED)):
        off = _engine_on_card(params, cfg, **kw)
        s_off, wall_off = _run_requests(off, prompts, max_new, SPEC_SEEDS)
        steps_off = off.metrics.steps
        del off
        on = _engine_on_card(params, cfg, spec=True, **kw)
        calls = _Calls(on)
        _zero_counts()                  # the main path: spec-on
        s_on, wall_on = _run_requests(on, prompts, max_new, SPEC_SEEDS)
        launches = _launches()
        m = on.metrics
        if m.spec_steps < 1 or len(calls.verify) != m.spec_steps:
            raise AssertionError(f"{mode}: {m.spec_steps} verify steps, "
                                 f"{len(calls.verify)} verify calls")
        want = {"decode": L * calls.decode, "prefill": L * m.admitted}
        for P in calls.verify:
            want[_path(cfg.n_head, cfg.n_head, P)] += L
        _check_launches(launches, _variant(on.pool), want)
        for k in want:
            res["launches_by_path"][k] += want[k]
        agree, compared, div = _near_tie_compare(
            params, cfg, s_on, s_off, prompts,
            SPEC_SEEDS if mode == "sampled" else None)
        s = m.summary()
        res["runs"][mode] = {
            "launches_by_path": want,
            "verify_calls_by_width": dict(collections.Counter(
                calls.verify)),
            "tokens_agreeing_spec_on_vs_off": agree,
            "tokens_compared": compared, "divergences_at_near_ties": div,
            "draft_tokens": s["draft_tokens"],
            "accepted_draft_tokens": s["accepted_draft_tokens"],
            "draft_acceptance_rate": s["draft_acceptance_rate"],
            "verify_steps": m.spec_steps, "decode_calls": calls.decode,
            "tokens_per_verify_step": calls.committed / m.spec_steps,
            "tokens_per_decode_step": s["tokens_per_decode_step"],
            "engine_steps_on_off": [m.steps, steps_off],
            "wall_s_on_off": [wall_on, wall_off]}
        if mode == "greedy":
            greedy_on = s_on
        del on
        torch.cuda.empty_cache()
    fq = _engine_on_card(params, cfg, spec=True, kv_dtype="fake_quant")
    s_fq, _ = _run_requests(fq, prompts, max_new, SPEC_SEEDS)
    d = _first_divergence(greedy_on, s_fq)
    if d is not None:
        raise AssertionError(f"fake_quant with spec differs from f32 with "
                             f"spec: request {d[0]}, token {d[1]}")
    res["fake_quant_with_spec_equals_f32"] = True
    res["card"] = _smi()
    _emit(res)
    return res


def _chunk_script(eng, cfg, rng):
    """serve_chunked's traffic: three short streams admitted and decoding,
    then the 1,000-token document. Returns (streams, prompts, per-step
    records of the document's prefill: wall s, decode tokens, chunk
    tokens; the wall s of the steps after it, decoding only)."""
    short = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in CHUNK_STREAMS]
    doc = rng.integers(0, cfg.vocab_size, CHUNK_PROMPT).astype(np.int32)
    rids = [eng.submit(p, CHUNK_STREAM_NEW) for p in short]
    eng.step()
    rid = eng.submit(doc, CHUNK_NEW)
    during, after = [], []
    m = eng.metrics
    while eng.request(rid).state != "finished":
        _sync()
        d0, c0, t = m.decode_tokens, m.chunk_tokens, time.perf_counter()
        first = eng.request(rid).first_token_time is None
        eng.step()
        _sync()
        rec = (time.perf_counter() - t, m.decode_tokens - d0,
               m.chunk_tokens - c0)
        (during if first else after).append(rec)
    eng.run()
    return ([eng.result(r) for r in rids + [rid]], short + [doc], during,
            after)


def phase_serve_chunked(params, cfg):
    """Chunked prefill on GPT-2 124M (f32 pool): the 1,000-token document
    through buckets up to 256, 256 chunk tokens a step, while three
    streams decode; the same traffic through an engine whose window holds
    the document whole (prefill_len 1,024: one P = 1,024 prefill). Gates:
    tokens equal the widened engine's up to reported near-ties, the
    document's last-position logits within 1e-4; every stream in flight
    gets a token every step of the document's prefill; chunk tokens a
    step <= the budget; K4 prefill == n_layer x chunks (the widened
    engine: n_layer x prefills), decode == n_layer x decode calls.
    Reported: the decode step's ms while chunking against the step that
    prefills the whole document."""
    L = cfg.n_layer
    runs, logits = {}, {}
    for name, kw in (("widened", {"prefill_len": 1024}),
                     ("chunked", {"prefill_len": CHUNK_WINDOW,
                                  "chunked_prefill": True,
                                  "prefill_chunk_budget": CHUNK_BUDGET})):
        eng = _engine_on_card(params, cfg, max_slots=4, max_seq_len=1024,
                              **kw)
        calls = _Calls(eng)
        prefill = eng._prefill

        def recorded(ids, start, t0, *a, _name=name, _pf=prefill):
            out = _pf(ids, start, t0, *a)
            if t0 == CHUNK_PROMPT:
                logits[_name] = out.detach().cpu()
            return out

        eng._prefill = recorded
        _zero_counts()
        streams, prompts, during, after = _chunk_script(
            eng, cfg, np.random.default_rng(23))
        launches = _launches()
        m = eng.metrics
        n_prefills = m.prefill_chunks if eng.chunked_prefill else m.admitted
        want = {"decode": L * calls.decode, "prefill": L * n_prefills}
        _check_launches(launches, _variant(eng.pool), want)
        runs[name] = {"streams": streams, "prompts": prompts,
                      "launches_by_path": want,
                      "engine_steps": m.steps,
                      "prefill_chunks": m.prefill_chunks,
                      "document_prefill_steps": len(during),
                      "document_prefill_step_ms": [
                          w * 1e3 for w, _, _ in during],
                      "decode_tokens_in_those_steps": [
                          d for _, d, _ in during],
                      "chunk_tokens_a_step": [c for _, _, c in during],
                      "steady_decode_step_ms": float(np.median(
                          [w for w, _, _ in after])) * 1e3}
        del eng
        torch.cuda.empty_cache()
    ch = runs["chunked"]
    if max(ch["chunk_tokens_a_step"]) > CHUNK_BUDGET:
        raise AssertionError(f"chunk tokens a step {ch['chunk_tokens_a_step']}"
                             f" over the budget {CHUNK_BUDGET}")
    if min(ch["decode_tokens_in_those_steps"]) < len(CHUNK_STREAMS):
        raise AssertionError(
            f"a stream starved while the document prefilled: decode tokens"
            f" a step {ch['decode_tokens_in_those_steps']} (< "
            f"{len(CHUNK_STREAMS)} streams)")
    if ch["prefill_chunks"] < -(-CHUNK_PROMPT // CHUNK_BUDGET):
        raise AssertionError(f"{ch['prefill_chunks']} chunks")
    logit_err = float((logits["chunked"] - logits["widened"]).abs().max())
    if not logit_err <= 1e-4:
        raise AssertionError(f"the document's last logits differ by "
                             f"{logit_err} chunked vs widened (> 1e-4)")
    agree, compared, div = _near_tie_compare(
        params, cfg, ch.pop("streams"), runs["widened"].pop("streams"),
        ch["prompts"])
    wide = runs["widened"]
    for r in runs.values():
        del r["prompts"]
    res = {"phase": "serve_chunked",
           "model": "gpt2-124M (random init, seed 0)", "kv_dtype": "f32",
           "document_tokens": CHUNK_PROMPT, "document_new": CHUNK_NEW,
           "streams": list(CHUNK_STREAMS), "stream_new": CHUNK_STREAM_NEW,
           "chunked": {"prefill_len": CHUNK_WINDOW,
                       "prefill_chunk_budget": CHUNK_BUDGET},
           "widened": {"prefill_len": 1024},
           "tokens_agreeing_chunked_vs_widened": agree,
           "tokens_compared": compared, "divergences_at_near_ties": div,
           "document_last_logits_max_abs_err": logit_err,
           "decode_step_ms_while_chunking": float(np.median(
               ch["document_prefill_step_ms"])),
           "monolithic_prefill_step_ms": wide["document_prefill_step_ms"],
           "runs": runs, "card": _smi()}
    _emit(res)
    return res


# ---------------------------------------------------------------------
# phase 2c: the dense decoders (greedy, beam search; Llama-3.2-1B)
# ---------------------------------------------------------------------

GEN_PROMPTS, GEN_PROMPT_LEN, GEN_NEW = 2, 64, 32
LLAMA_GEN_ROWS, LLAMA_GEN_PROMPT, LLAMA_GEN_NEW = 4, 128, 16


def _greedy_gap_check(params, cfg, seq, t0, i, device=DEVICE):
    """The dense top-2 logit gap at request token ``i`` (teacher-forced
    over ``seq[:t0 + i]``)."""
    ids = torch.from_numpy(seq[:t0 + i].astype(np.int64)).to(device)[None]
    with torch.no_grad():
        top2 = torch.topk(_dense_logits(params, ids, cfg)[0, -1], 2).values
    return float(top2[0] - top2[1])


def _seq_logprob(params, cfg, rows, t0):
    """Teacher-forced log-probability of each row's tokens after ``t0``."""
    from quintnet_tpu_torch.models.gpt2 import gpt2_apply

    full = torch.from_numpy(rows.astype(np.int64)).to(DEVICE)
    with torch.no_grad():
        logp = torch.log_softmax(gpt2_apply(params, full, cfg), dim=-1)
    tok = logp[:, :-1].gather(2, full[:, 1:, None])[:, :, 0]
    return tok[:, t0 - 1:].sum(dim=1).cpu().numpy()


def phase_generate(params, cfg):
    """GPT-2 124M's dense decoders on the card: greedy ``gpt2_generate``
    (2 prompts of 64, 32 new tokens) against the greedy engine's streams
    (equal up to a near-tie, as the serve phase's rule), beam search at 4
    beams (beams 1 == greedy; the beam's log-probability >= greedy's),
    then Llama-3.2-1B uncut (seed 0): ``llama_generate`` greedy on 4 x
    128 prompts, 16 new tokens, its prefill's last logits within 1e-4 of
    the full forward's."""
    from quintnet_tpu_torch.models.gpt2_generate import (gpt2_beam_search,
                                                         gpt2_generate)
    from quintnet_tpu_torch.serve import ServeEngine, generate, gpt2_family

    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size, (GEN_PROMPTS, GEN_PROMPT_LEN)
                       ).astype(np.int32)
    # the dense decoders run plain attention, as JAX's: no kernel
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = gpt2_generate(params, ids, cfg, max_new_tokens=GEN_NEW)
    dense_s = time.perf_counter() - t0
    beam1 = gpt2_beam_search(params, ids, cfg, beams=1,
                             max_new_tokens=GEN_NEW)
    t0 = time.perf_counter()
    beam4 = gpt2_beam_search(params, ids, cfg, beams=4,
                             max_new_tokens=GEN_NEW)
    beam_s = time.perf_counter() - t0
    if any(_counts().values()):
        raise AssertionError(f"the dense decoders launched {_counts()}")
    eng = ServeEngine(gpt2_family(cfg), params, device=DEVICE, max_slots=8,
                      block_size=16, num_blocks=64)
    served = generate(eng, list(ids), max_new_tokens=GEN_NEW)
    near = []
    for r, (d, e) in enumerate(zip(dense, served)):
        diff = np.nonzero(d != e)[0]
        if diff.size:
            i = int(diff[0]) - GEN_PROMPT_LEN
            gap = _greedy_gap_check(params, cfg, d, GEN_PROMPT_LEN, i)
            near.append({"row": r, "step": i, "dense": int(d[diff[0]]),
                         "engine": int(e[diff[0]]), "top2_gap": gap})
            if gap >= F32_GAP:
                raise AssertionError(f"greedy gpt2_generate row {r} step "
                                     f"{i} != engine with top-2 gap {gap}")
    del eng
    if not np.array_equal(beam1, dense):
        raise AssertionError("gpt2_beam_search(beams=1) != greedy "
                             "gpt2_generate")
    lp_g = _seq_logprob(params, cfg, dense, GEN_PROMPT_LEN)
    lp_b = _seq_logprob(params, cfg, beam4, GEN_PROMPT_LEN)
    if not (lp_b >= lp_g - 1e-4).all():
        raise AssertionError(f"beam-4 log-probability {lp_b} below greedy "
                             f"{lp_g}")
    res = {"phase": "generate", "model": "gpt2-124M (random init, seed 0)",
           "prompts": [GEN_PROMPTS, GEN_PROMPT_LEN], "new_tokens": GEN_NEW,
           "greedy_vs_engine_near_ties": near,
           "greedy_tokens_equal_engine": int(sum(
               (d == e).sum() for d, e in zip(dense, served))
               - GEN_PROMPTS * GEN_PROMPT_LEN),
           "beam1_equals_greedy": True,
           "logprob_greedy": lp_g.tolist(), "logprob_beam4": lp_b.tolist(),
           "dense_generate_s": dense_s, "beam4_s": beam_s,
           "dense_decoder_launches": 0}
    res.update(_llama_generate_check())
    _emit(res)
    return res


def _llama_generate_check():
    from quintnet_tpu_torch.models.llama import (LlamaConfig, llama_apply,
                                                 llama_init)
    from quintnet_tpu_torch.models.llama_generate import (llama_generate,
                                                          llama_prefill)

    cfg = LlamaConfig.llama32_1b()
    params = llama_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    ids = _llama_ids(cfg, LLAMA_GEN_ROWS, LLAMA_GEN_PROMPT, 3)
    t = torch.from_numpy(ids.astype(np.int64)).to(DEVICE)
    with torch.no_grad():
        pre, _ = llama_prefill(params, t, cfg,
                               cache_len=LLAMA_GEN_PROMPT + LLAMA_GEN_NEW)
        full = llama_apply(params, t, cfg)[:, -1]
    err = float((pre - full).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"llama_prefill's last logits differ from the "
                             f"full forward's by {err} (> 1e-4)")
    del pre, full
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llama_generate(params, ids, cfg, max_new_tokens=LLAMA_GEN_NEW)
    wall = time.perf_counter() - t0
    new = out[:, LLAMA_GEN_PROMPT:]
    if out.shape != (LLAMA_GEN_ROWS, LLAMA_GEN_PROMPT + LLAMA_GEN_NEW) or (
            new < 0).any() or (new >= cfg.vocab_size).any():
        raise AssertionError(f"llama_generate gave {out.shape} / ids out "
                             f"of the vocab")
    del params
    torch.cuda.empty_cache()
    return {"llama": "Llama-3.2-1B uncut (random init, seed 0)",
            "llama_prompts": [LLAMA_GEN_ROWS, LLAMA_GEN_PROMPT],
            "llama_new_tokens": LLAMA_GEN_NEW,
            "llama_prefill_vs_full_forward_max_abs": err,
            "llama_generate_s": wall}


# ---------------------------------------------------------------------
# phase 3: GPT-2 124M served from quantized and narrow KV pools
# ---------------------------------------------------------------------

KV_POLICIES = ("fake_quant", "int8", "bf16", "fp8")
NLL_ROWS, NLL_LEN = 4, 256
# |NLL - f32 NLL| limits: fake_quant is the identity; the narrow pools'
# deltas read at most 4.0e-4 (fp8) at GPT-2 124M, seed 0, so 2e-3 leaves
# room above them and stays far inside the reference's 0.05 gate
NLL_EXACT, NLL_LIMIT = 1e-6, 2e-3


def _split_nll(family, params, pool, rows):
    """Mean NLL of the second half of each row, scored by a verify call
    against the first half already written into the pool by an earlier
    verify call: unlike ``paged_eval_nll`` (every scored position is in
    the fresh run, which a scaled policy reads exactly), this reads the
    first half back as the pool stores it."""
    from quintnet_tpu_torch.serve.kv_quant import acquire_rows

    S, P = rows.shape
    h = P // 2
    tables, held = acquire_rows(pool, S, P)
    tables = torch.from_numpy(tables).to(DEVICE)
    ids = torch.from_numpy(rows).to(DEVICE)
    with torch.no_grad():
        for lo, hi in ((0, h), (h, P)):
            caches = pool.caches()
            out = family.verify(
                params, caches[0], caches[1], ids[:, lo:hi],
                torch.full((S,), lo, dtype=torch.int32, device=DEVICE),
                torch.full((S,), hi - lo, dtype=torch.int32, device=DEVICE),
                tables, pool.block_size,
                kv_scales=caches[2:] if pool.policy.scaled else None,
                policy=pool.policy)
            pool.update(*out[1:])
    for b in held:
        pool.release(b)
    logp = torch.log_softmax(out[0][:, :-1].float(), dim=-1)
    tgt = ids[:, h + 1:].long()
    return float(-logp.gather(-1, tgt[..., None]).mean())


def phase_serve_kv(params, cfg, f32_streams):
    """GPT-2 124M served from each quantized or narrow KV pool with the
    serve phase's script; then teacher-forced NLL through the pool at
    the verify shape."""
    from quintnet_tpu_torch.ops.paged_attention import paged_attention
    from quintnet_tpu_torch.serve import KVPool, gpt2_family
    from quintnet_tpu_torch.serve.kv_quant import paged_eval_nll

    out, runs = {}, {}
    for name in KV_POLICIES:
        eng, warmup_s = _serve_engine(params, cfg, kv_dtype=name)
        # this policy's main path: counts zeroed just before, read after
        _zero_counts()
        rids, prompts, steps, rng = _serve_script(eng, cfg)
        launches = _launches()
        _check_serve_run(eng, cfg, rids, launches)
        res = {"phase": "serve_kv", "kv_dtype": name,
               "model": "gpt2-124M (random init, seed 0)",
               "warmup_s": warmup_s, "launches": launches}
        if name == "fake_quant":
            same = all(np.array_equal(eng.result(r), w)
                       for r, w in zip(rids, f32_streams))
            if not same:
                raise AssertionError("fake_quant token streams differ from "
                                     "the f32 run's")
            res["streams_identical_to_f32"] = True
        else:
            checked, mism = _check_against_dense(params, cfg, eng, rids,
                                                 prompts, NARROW_GAP)
            agree = 1.0 - len(mism) / checked
            res.update({"tokens_checked_vs_dense": checked,
                        "agree_with_dense": agree, "mismatches": mism})
            if agree < 0.9:
                raise AssertionError(f"{name}: {agree:.3f} of tokens agree "
                                     f"with the dense greedy (< 0.9)")
        res.update(_serve_numbers(eng, rids, prompts, steps))
        if name == "int8":
            res.update(_kernel_share(eng, cfg, rng, window_update=True))
        _emit(res)
        runs[name] = launches
        out[name] = res
        del eng
        torch.cuda.empty_cache()

    # teacher-forced NLL through the pool: family.verify, so the kernel
    # at the verify shape (4 rows x 256 tokens), once per layout
    fam = gpt2_family(cfg)
    rows = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (NLL_ROWS, NLL_LEN)).astype(np.int32)
    nll, split = {}, {}
    for name in ("f32",) + KV_POLICIES:
        def pool():
            return KVPool(n_layers=cfg.n_layer, n_kv_heads=cfg.n_head,
                          head_dim=cfg.n_embd // cfg.n_head, block_size=16,
                          num_blocks=1 + NLL_ROWS * NLL_LEN // 16,
                          policy=name, device=DEVICE)
        p = pool()
        _zero_counts()
        nll[name] = paged_eval_nll(fam, params, p, rows)
        launched = dict(paged_attention.launches_by_variant)
        if launched != {_variant(p): cfg.n_layer}:
            raise AssertionError(f"paged_eval_nll {name}: launches "
                                 f"{launched}")
        split[name] = _split_nll(fam, params, pool(), rows)
    for name in KV_POLICIES:
        for what, d in (("paged_eval_nll", nll), ("second-half nll", split)):
            delta = abs(d[name] - d["f32"])
            limit = NLL_EXACT if name == "fake_quant" else NLL_LIMIT
            if not delta <= limit:
                raise AssertionError(f"{what} {name} {d[name]} vs f32 "
                                     f"{d['f32']}: |delta| {delta} > {limit}")
    _emit({"phase": "serve_kv_nll", "rows": NLL_ROWS, "tokens": NLL_LEN,
           "paged_eval_nll": nll, "second_half_nll": split,
           "gate": {"fake_quant": NLL_EXACT, "others": NLL_LIMIT}})
    return out, runs


# ---------------------------------------------------------------------
# phase 3c: packed serving weights (serve/weight_quant.py)
# ---------------------------------------------------------------------

WQ_POLICIES = ("fake_quant", "bf16", "int8", "fp8")
# the narrow-layout rule's top-2 gap limit against the f32 dense greedy,
# by policy: fp8 weights' rounding (e4m3: up to 2^-4 of each weight)
# flipped a token at a gap of 0.079 on GPT-2 124M on an H100 (PERF.md
# §6), above the limit set for narrow KV pools; fp8 is held instead by the
# >= 90% agreement, JAX's NLL gate and the dense forward of its own
# dequantized weights (every flip printed with its gap)
WQ_GAP = {"bf16": NARROW_GAP, "int8": NARROW_GAP, "fp8": float("inf")}
# |NLL - f32 NLL| of packed weights: JAX's gate (tests/test_weight_quant.py)
WQ_NLL_LIMIT = 0.05
# f32 / int8 bytes of the targeted block weights: JAX's gate
WQ_BYTES_RATIO = 3.5


def _packed(params, cfg, name):
    """GPT-2's params with its ``weight_targets`` packed by policy
    ``name`` (what the engine builds from ``weights_dtype=name``)."""
    from quintnet_tpu_torch.serve import gpt2_family
    from quintnet_tpu_torch.serve.weight_quant import (make_weight_policy,
                                                       present_targets,
                                                       quantize_params)

    targets = present_targets(params, gpt2_family(cfg).weight_targets)
    return quantize_params(params, targets, make_weight_policy(name))


def _dequantized(params, family, name):
    """``params`` with each of the family's targeted weights replaced by
    its packed form dequantized to f32 (``w_q * w_scale``): the dense
    model a ``weights_dtype=name`` engine serves."""
    from quintnet_tpu_torch.serve.weight_quant import (make_weight_policy,
                                                       present_targets,
                                                       quantize_params)

    targets = present_targets(params, family.weight_targets)
    q = quantize_params(params, targets, make_weight_policy(name))
    blocks = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params["blocks"].items()}
    for part, leaf in targets:
        node = q["blocks"][part][leaf]
        w = node["w"].float()
        if "w_scale" in node:
            w = w * node["w_scale"].unsqueeze(-2)
        blocks[part][leaf] = {**params["blocks"][part][leaf], "w": w}
    return {**params, "blocks": blocks}


def _check_own_dense(params, family, cfg, eng, rids, prompts, name):
    """The packed engine's greedy streams against the dense forward of
    its own dequantized weights, under the serve rule (a flip only at a
    top-2 gap < ``F32_GAP``): the packed path serves its model."""
    own = _dequantized(params, family, name)
    checked, near = _check_against_dense(own, cfg, eng, rids, prompts,
                                         F32_GAP)
    del own
    return {"tokens_checked_vs_own_dense": checked,
            "near_ties_vs_own_dense": near}


def _free_card() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_serve_wq(params, cfg, f32_streams):
    """GPT-2 124M served with the block matmuls' weights packed by each
    layout policy (``weights_dtype``: fake_quant, bf16, int8, fp8) on
    the serve phase's script from an f32 pool, counts zeroed just before
    each run and read just after (K4 as the serve phase counts it):
    fake_quant's streams equal the f32 run's bit for bit; bf16, int8 and
    fp8 against the dense forward of their own dequantized weights under
    the serve rule (a flip only at a top-2 gap < 1e-3), and against the
    f32 dense greedy under the narrow-layout rule (>= 90% of tokens
    equal; a flip only at a gap < 0.05 for bf16 and int8, ``WQ_GAP``).
    Then
    teacher-forced NLL through an f32 pool (``paged_eval_nll``, 4 rows x
    256 tokens) with the weights packed: fake_quant's equal to f32's,
    int8's and fp8's within 0.05 of it; and the targeted weights' bytes,
    f32 / int8 >= 3.5. Returns (results, each run's K4 launches by
    path)."""
    from quintnet_tpu_torch.ops.paged_attention import paged_attention
    from quintnet_tpu_torch.serve import KVPool, gpt2_family
    from quintnet_tpu_torch.serve.kv_quant import paged_eval_nll
    from quintnet_tpu_torch.serve.weight_quant import (present_targets,
                                                       weight_bytes)

    out, runs = {}, []
    for name in WQ_POLICIES:
        eng, warmup_s = _serve_engine(params, cfg, weights_dtype=name)
        # this policy's main path: counts zeroed just before, read after
        _zero_counts()
        rids, prompts, steps, _rng = _serve_script(eng, cfg)
        launches = _launches()
        _check_serve_run(eng, cfg, rids, launches)
        res = {"phase": "serve_wq", "weights_dtype": name,
               "model": "gpt2-124M (random init, seed 0)",
               "kv_dtype": "f32", "weight_bytes": eng.weight_bytes,
               "warmup_s": warmup_s, "launches": launches}
        if name == "fake_quant":
            if not all(np.array_equal(eng.result(r), w)
                       for r, w in zip(rids, f32_streams)):
                raise AssertionError("fake_quant weights: token streams "
                                     "differ from the f32 run's")
            res["streams_identical_to_f32"] = True
        else:
            res.update(_check_own_dense(params, gpt2_family(cfg), cfg, eng,
                                        rids, prompts, name))
            checked, mism = _check_against_dense(params, cfg, eng, rids,
                                                 prompts, WQ_GAP[name])
            agree = 1.0 - len(mism) / checked
            res.update({"tokens_checked_vs_dense": checked,
                        "agree_with_dense": agree, "mismatches": mism,
                        "gap_limit": WQ_GAP[name]})
            if agree < 0.9:
                raise AssertionError(f"{name} weights: {agree:.3f} of "
                                     f"tokens agree with the dense greedy "
                                     f"(< 0.9)")
        res.update(_serve_numbers(eng, rids, prompts, steps))
        _emit(res)
        runs.append(launches["by_path"])
        out[name] = res
        del eng
        _free_card()

    targets = present_targets(params, gpt2_family(cfg).weight_targets)
    f32_bytes = weight_bytes(params, targets)
    ratio = f32_bytes / out["int8"]["weight_bytes"]
    if ratio < WQ_BYTES_RATIO:
        raise AssertionError(f"f32 / int8 weight bytes {ratio} < "
                             f"{WQ_BYTES_RATIO}")
    # teacher-forced NLL through the pool with the weights packed
    rows = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (NLL_ROWS, NLL_LEN)).astype(np.int32)
    nll = {}
    for name in ("f32",) + WQ_POLICIES:
        pool = KVPool(n_layers=cfg.n_layer, n_kv_heads=cfg.n_head,
                      head_dim=cfg.n_embd // cfg.n_head, block_size=16,
                      num_blocks=1 + NLL_ROWS * NLL_LEN // 16,
                      device=DEVICE)
        _zero_counts()
        nll[name] = paged_eval_nll(gpt2_family(cfg),
                                   _packed(params, cfg, name), pool, rows)
        launched = dict(paged_attention.launches_by_variant)
        if torch.device(DEVICE).type == "cuda" and launched != {
                "f32": cfg.n_layer}:
            raise AssertionError(f"paged_eval_nll {name} weights: "
                                 f"launches {launched}")
    if nll["fake_quant"] != nll["f32"]:
        raise AssertionError(f"fake_quant weights' NLL {nll['fake_quant']}"
                             f" != f32's {nll['f32']}")
    for name in ("int8", "fp8"):
        if not abs(nll[name] - nll["f32"]) <= WQ_NLL_LIMIT:
            raise AssertionError(f"{name} weights' NLL {nll[name]} vs f32 "
                                 f"{nll['f32']}: |delta| > {WQ_NLL_LIMIT}")
    summary = {"phase": "serve_wq_nll", "rows": NLL_ROWS,
               "tokens": NLL_LEN, "paged_eval_nll": nll,
               "gate": WQ_NLL_LIMIT, "weight_bytes": {
                   "f32": f32_bytes, **{n: out[n]["weight_bytes"]
                                        for n in WQ_POLICIES}},
               "f32_over_int8_bytes": ratio}
    _emit(summary)
    out["nll"] = summary
    return out, runs


# ---------------------------------------------------------------------
# phase 3d: the host KV tier (serve/kv_tier.py)
# ---------------------------------------------------------------------

# three shared 256-token prefixes, each request one of them + its own
# 32-token tail and 16 new tokens, one request at a time, three rounds:
# a request needs 19 blocks of 16, the tier engine's pool holds 40, so
# each round's third prefix evicts (demotes) the oldest chain and the
# next round finds it in the host tier
TIER_PREFIX, TIER_TAIL, TIER_NEW, TIER_ROUNDS = 256, 32, 16, 3
TIER_BLOCKS = 41
TIER_BYTES = 1 << 30


def _tier_prompts(cfg):
    rng = np.random.default_rng(51)
    prefixes = [rng.integers(0, cfg.vocab_size, TIER_PREFIX).astype(np.int32)
                for _ in range(3)]
    return [np.concatenate([prefixes[i % 3], rng.integers(
        0, cfg.vocab_size, TIER_TAIL).astype(np.int32)])
        for i in range(3 * TIER_ROUNDS)]


def _one_at_a_time(eng, prompts):
    """Each request alone, run to its end: (rids, streams, TTFT s
    each)."""
    rids, streams, ttfts = [], [], []
    for prompt in prompts:
        rid = eng.submit(prompt, TIER_NEW)
        while eng.has_work:
            eng.step()
        req = eng.request(rid)
        rids.append(rid)
        streams.append(eng.result(rid))
        ttfts.append(req.first_token_time - req.submit_time)
    return rids, streams, ttfts


def _record_bytes(t):
    return t.contiguous().view(torch.uint8)


def _tier_round_trip(eng, tokens):
    """The published chain of ``tokens`` exported from the device, every
    cached block then evicted (demoted), the chain promoted back and
    exported again: the records (K/V as stored, and the scale rows)
    byte-equal. Returns (blocks, demote ms a block, promote ms a
    block)."""
    pool, tier = eng.pool, eng.kv_tier
    before = pool.export_chain(tokens)
    n = len(before["blocks"])
    d0 = tier.demotions
    _sync()
    t0 = time.perf_counter()
    held = pool.acquire(pool.num_available)     # evicts every cached block
    _sync()
    demote_s = time.perf_counter() - t0
    pool.release(held)
    demoted = tier.demotions - d0
    covered, keys = pool.plan_promotion(tokens)
    if len(keys) != n or covered != before["n_tokens"]:
        raise AssertionError(f"host tier holds {len(keys)} of the chain's "
                             f"{n} blocks ({covered} tokens)")
    _sync()
    t0 = time.perf_counter()
    taken, promoted = pool.promote_chain(keys)
    _sync()
    promote_s = time.perf_counter() - t0
    after = pool.export_chain(tokens)
    if promoted != n or len(after["blocks"]) != n:
        raise AssertionError(f"promoted {promoted} of {n} blocks")
    for a, b in zip(before["blocks"], after["blocks"]):
        for f in a:
            same = (a[f] == b[f] if f == "fill" else torch.equal(
                _record_bytes(a[f]), _record_bytes(b[f])))
            if not same:
                raise AssertionError(f"demoted and promoted block's {f} "
                                     f"differs from the block before")
    return n, demote_s * 1e3 / max(demoted, 1), promote_s * 1e3 / n


def _check_k4(eng, cfg, launches):
    """K4 of one engine run: layers x (decode steps + prefills) by path,
    all in the pool's variant (on the card)."""
    m = eng.metrics
    L = _depth(cfg)
    want = {"decode": L * m.decode_steps, "prefill": L * m.admitted}
    if torch.device(DEVICE).type == "cuda":
        _check_launches(launches, _variant(eng.pool), want)
    return want


def phase_serve_tier(params, cfg):
    """GPT-2 124M with the prefix cache and a host tier
    (``kv_tier_bytes``, the default promote budget of 4 blocks a step)
    on a pool of 40 blocks: three rounds of three 256-token prefixes,
    each request alone (``TIER_*``), counts zeroed just before and read
    just after. Gates: demotions, promotions and host-hit tokens > 0,
    ``_decode_blocked_demotions`` == 0; the streams equal bit for bit
    those of an engine whose pool (320 blocks) never evicts (the same
    calls on the bytes the tier restores), and the dense greedy up to
    near-ties (``F32_GAP``); the same pool with the tier off (which
    re-prefills the evicted prefixes in other call shapes) up to
    near-ties; K4 == 12 x (decode steps + prefills). Then a chain
    demoted and promoted back byte for byte, from the f32 pool and from
    an int8 pool (the scale rows too). Reported: each request's TTFT,
    host hit against the tier-off re-prefill, and the demotion and
    promotion ms a block."""
    prompts = _tier_prompts(cfg)
    engines = {
        "tier": _engine_on_card(params, cfg, num_blocks=TIER_BLOCKS,
                                kv_tier_bytes=TIER_BYTES),
        "no_tier": _engine_on_card(params, cfg, num_blocks=TIER_BLOCKS),
        "never_evicts": _engine_on_card(params, cfg),
    }
    res = {"phase": "serve_tier", "model": "gpt2-124M (random init, seed 0)",
           "prefix_tokens": TIER_PREFIX, "tail_tokens": TIER_TAIL,
           "new_tokens": TIER_NEW, "requests": len(prompts),
           "pool_blocks": TIER_BLOCKS - 1, "runs": {}}
    streams, rids, runs = {}, {}, []
    for name, eng in engines.items():
        _zero_counts()
        rids[name], streams[name], ttfts = _one_at_a_time(eng, prompts)
        want = _check_k4(eng, cfg, _launches())
        runs.append(want)
        res["runs"][name] = {"ttft_ms": [t * 1e3 for t in ttfts],
                             "cache_evictions": eng.pool.cache_evictions,
                             "launches_by_path": want}
    on = engines["tier"]
    tier, m = on.kv_tier, on.metrics.summary()
    if not (tier.demotions > 0 and tier.promotions > 0
            and m["host_hit_tokens"] > 0):
        raise AssertionError(f"the tier saw no traffic: {tier.summary()}")
    if on._decode_blocked_demotions != 0:
        raise AssertionError(f"{on._decode_blocked_demotions} demotions "
                             f"during a decode dispatch")
    if engines["never_evicts"].pool.cache_evictions != 0:
        raise AssertionError("the reference pool evicted")
    first = _first_divergence(streams["tier"], streams["never_evicts"])
    if first is not None:
        raise AssertionError(f"tier-on stream differs from the never-"
                             f"evicting pool's at (request, position) "
                             f"{first}")
    agree, compared, div = _near_tie_compare(
        params, cfg, streams["no_tier"], streams["tier"], prompts)
    checked, near = _check_against_dense(params, cfg, on, rids["tier"],
                                         prompts, F32_GAP)
    res.update({"tier": tier.summary(), "host_hit_tokens":
                m["host_hit_tokens"],
                "decode_blocked_demotions": on._decode_blocked_demotions,
                "streams_identical_to_never_evicting_pool": True,
                "tokens_agreeing_tier_off_same_pool": agree,
                "tokens_compared": compared,
                "divergences_at_near_ties": div,
                "tokens_checked_vs_dense": checked, "near_ties": near})
    # TTFT: the later rounds host-hit with the tier and re-prefill without
    hits = range(3, len(prompts))
    res["ttft_ms_p50_host_hit"] = float(np.median(
        [res["runs"]["tier"]["ttft_ms"][i] for i in hits]))
    res["ttft_ms_p50_reprefill"] = float(np.median(
        [res["runs"]["no_tier"]["ttft_ms"][i] for i in hits]))
    last = streams["tier"][-1][:-1]
    n, demote_ms, promote_ms = _tier_round_trip(on, last)
    res["round_trip"] = {"f32": {"blocks": n, "demote_ms_per_block":
                                 demote_ms, "promote_ms_per_block":
                                 promote_ms}}
    del engines
    _free_card()
    # an int8 pool: one request, then the round trip (scales included)
    eng = _engine_on_card(params, cfg, num_blocks=TIER_BLOCKS,
                          kv_tier_bytes=TIER_BYTES, kv_dtype="int8")
    _zero_counts()
    _, out, _ = _one_at_a_time(eng, prompts[:1])
    res["runs"]["int8_tier"] = {"launches_by_path": _check_k4(
        eng, cfg, _launches())}
    n, demote_ms, promote_ms = _tier_round_trip(eng, out[0][:-1])
    res["round_trip"]["int8"] = {"blocks": n, "demote_ms_per_block":
                                 demote_ms, "promote_ms_per_block":
                                 promote_ms}
    del eng
    _free_card()
    _emit(res)
    return res, runs


# ---------------------------------------------------------------------
# phase 3e: multi-tenant LoRA (serve/adapters.py)
# ---------------------------------------------------------------------

# three tenants (adapters of ranks 4, 8, 16 on qkv/proj/fc from
# lora_init at these seeds, b moved off zero) and the base model, 8
# requests of 33-150 tokens arriving over 10 steps, 24 new tokens each:
# rank 16 is bound first and retires first, so the decode bucket steps
# down 16 -> 8 -> 4 near the end
LORA_TENANTS = (("t4", 4, 101), ("t8", 8, 102), ("t16", 16, 103))
LORA_AIDS = ("t16", "t8", None, "t4", "t16", None, "t8", "t4")
LORA_LENS = (40, 96, 64, 150, 72, 33, 120, 80)
LORA_ARRIVALS = (0, 0, 0, 2, 4, 6, 8, 10)
LORA_SEEDS = tuple(range(400, 408))
LORA_NEW = 24
LORA_B_STD = 0.02
LORA_SEQ, LORA_MAX_RANK = 256, 16


def _lora_tenants(params):
    """id -> (adapter tree on the card, LoRAConfig)."""
    from quintnet_tpu_torch.models.lora import LoRAConfig, lora_init
    from quintnet_tpu_torch.serve.adapters import (adapter_factor_paths,
                                                   tree_at)

    out = {}
    for aid, rank, seed in LORA_TENANTS:
        lcfg = LoRAConfig(rank=rank, alpha=2.0 * rank)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        lora = lora_init(gen, params["blocks"], lcfg)
        for path in adapter_factor_paths(lora):
            node = tree_at(lora, path)
            node["b"] = torch.randn(node["b"].shape, generator=gen,
                                    device=DEVICE) * LORA_B_STD
        out[aid] = (lora, lcfg)
    return out


def _lora_traffic(eng, prompts):
    """``LORA_AIDS``' requests at ``LORA_ARRIVALS`` steps, each at its
    seed; every decode call's rank bucket recorded beside the largest
    rank bound then. Returns (streams, [(bucket, bound rank)])."""
    calls = []
    decode = eng._decode

    def recorded(*a, **k):
        top = max((int(eng._slot_rank[s]) for s in eng._active_slots()),
                  default=0)
        calls.append((eng._decode_rank_bucket(), top))
        return decode(*a, **k)

    eng._decode = recorded
    rids, done, step = {}, 0, 0
    while done < len(prompts) or eng.has_work:
        while done < len(prompts) and LORA_ARRIVALS[done] <= step:
            rids[done] = eng.submit(prompts[done], LORA_NEW,
                                    seed=LORA_SEEDS[done],
                                    adapter_id=LORA_AIDS[done])
            done += 1
        eng.step()
        step += 1
    return [eng.result(rids[i]) for i in range(len(prompts))], calls


def _check_buckets(eng, calls):
    """Each decode call at the smallest ladder bucket covering the
    largest rank bound then; returns the calls per bucket."""
    for bucket, top in calls:
        want = min(b for b in eng.lora_rank_buckets if b >= top)
        if bucket != want:
            raise AssertionError(f"decode at rank bucket {bucket} with "
                                 f"rank {top} bound (want {want})")
    return dict(collections.Counter(b for b, _ in calls))


def _lora_dedicated(params, cfg, tenants, got, prompts, mode_kw):
    """Each tenant's requests against a dedicated engine serving its
    ``lora_merge_tree`` weights (the base model's against the plain
    weights), at the same seeds: equal up to near-ties (the dense top-2
    gap of the merged model < ``F32_GAP`` greedy, the perturbed gap
    sampled). Returns (per tenant: agreeing, compared, divergences,
    the K4 launches by path of its run)."""
    from quintnet_tpu_torch.models.lora import lora_merge_tree

    out = {}
    for aid in ("t4", "t8", "t16", None):
        idx = [i for i, a in enumerate(LORA_AIDS) if a == aid]
        merged = (params if aid is None else
                  lora_merge_tree(params, *tenants[aid]))
        eng = _engine_on_card(merged, cfg, max_seq_len=LORA_SEQ, **mode_kw)
        _zero_counts()
        want, _ = _run_requests(eng, [prompts[i] for i in idx],
                                [LORA_NEW] * len(idx),
                                [LORA_SEEDS[i] for i in idx])
        launches = _check_k4(eng, cfg, _launches())
        seeds = [LORA_SEEDS[i] for i in idx] if mode_kw else None
        agree, compared, div = _near_tie_compare(
            merged, cfg, [got[i] for i in idx], want,
            [prompts[i] for i in idx], seeds)
        out[aid or "base"] = {"tokens_agreeing": agree,
                              "tokens_compared": compared,
                              "divergences_at_near_ties": div,
                              "launches_by_path": launches}
        del eng, merged
        _free_card()
    return out


def _common_prefix(a, b) -> int:
    """Tokens two streams share before their first difference."""
    n = min(len(a), len(b))
    d = np.nonzero(a[:n] != b[:n])[0]
    return n if d.size == 0 else int(d[0])


def phase_serve_lora(params, cfg):
    """GPT-2 124M serving three LoRA tenants (ranks 4, 8, 16; ``LORA_*``)
    and the base model in one heterogeneous batch with staggered
    arrivals, greedy and sampled (``SAMPLED``), from an f32 pool, counts
    zeroed just before each run and read just after. Gates: every
    stream equals a dedicated engine serving its tenant's merged weights
    up to near-ties; each decode call at the smallest rank bucket that
    covers the adapters bound then; every pin released at retire; K4 ==
    12 x (decode steps + prefills) in every run. Reported, not gated: the
    same greedy batch with int8 weights under the adapters (the delta in
    full precision on top), its agreement with the f32 batch."""
    from quintnet_tpu_torch.serve import AdapterRegistry

    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LORA_LENS]
    tenants = _lora_tenants(params)
    res = {"phase": "serve_lora", "model": "gpt2-124M (random init, seed 0)",
           "tenants": {aid: rank for aid, rank, _ in LORA_TENANTS},
           "requests": list(LORA_AIDS), "prompt_lens": list(LORA_LENS),
           "max_new_tokens": LORA_NEW, "runs": {}}
    runs, f32_greedy = [], None
    for mode, mode_kw, wkw in (("greedy", {}, {}), ("sampled", SAMPLED, {}),
                               ("greedy_int8_weights", {},
                                {"weights_dtype": "int8"})):
        reg = AdapterRegistry()
        for aid, (lora, lcfg) in tenants.items():
            reg.register(aid, tree=lora, cfg=lcfg)
        eng = _engine_on_card(params, cfg, adapters=reg,
                              max_seq_len=LORA_SEQ,
                              lora_max_rank=LORA_MAX_RANK, **mode_kw, **wkw)
        _zero_counts()
        _sync()
        t0 = time.perf_counter()
        got, calls = _lora_traffic(eng, prompts)
        _sync()
        wall = time.perf_counter() - t0
        launches = _check_k4(eng, cfg, _launches())
        runs.append(launches)
        pinned = {a: reg.entry(a).refs for a in reg.adapter_ids}
        if any(pinned.values()):
            raise AssertionError(f"pins left after retire: {pinned}")
        run = {"wall_s": wall, "launches_by_path": launches,
               "decode_calls_by_rank_bucket": _check_buckets(eng, calls),
               "peak_running": eng.metrics.peak_running,
               "per_adapter": {a: {k: v for k, v in d.items()
                                   if k in ("requests", "gen_tokens")}
                               for a, d in eng.metrics.summary()[
                                   "adapters"].items()},
               "weight_bytes": eng.weight_bytes}
        if mode == "greedy_int8_weights":
            run["new_tokens_equal_to_f32_run"] = [
                _common_prefix(g, w) - len(p)
                for g, w, p in zip(got, f32_greedy, prompts)]
        else:
            run["vs_dedicated_merged"] = _lora_dedicated(
                params, cfg, tenants, got, prompts, mode_kw)
            runs += [d["launches_by_path"]
                     for d in run["vs_dedicated_merged"].values()]
        if mode == "greedy":
            f32_greedy = got
            if len(run["decode_calls_by_rank_bucket"]) < 2:
                raise AssertionError("the decode rank bucket never "
                                     "changed with the bound adapters")
        res["runs"][mode] = run
        del eng, reg
        _free_card()
    _emit(res)
    return res, runs


# ---------------------------------------------------------------------
# phase 3f: the in-process serving fleet (obs, deadlines, migration)
# ---------------------------------------------------------------------

FLEET_REPLICAS = 3
FLEET_SLOTS = 4
FLEET_BLOCKS = 160               # 159 usable blocks of 16 a replica
FLEET_REQUESTS = 16
FLEET_NEW = 32
FLEET_KILL = ("r1", 8)           # the armed death: replica, after step
FLEET_THREADS = tuple(f"fleet-r{i}" for i in range(FLEET_REPLICAS))
# the inertness and deadline scripts on one engine
INERT_LENS = (32, 48, 40, 64)
INERT_NEW = 8
DEADLINE_TICK_S = 0.01           # the fake clock's step a read
DEADLINE_S = 0.5


def _fleet_prompts(cfg):
    rng = np.random.default_rng(71)
    return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(32, 257, FLEET_REQUESTS)]


def _fleet_engine(params, cfg, **kw):
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    return ServeEngine(gpt2_family(cfg), params, device=DEVICE,
                       max_slots=FLEET_SLOTS, block_size=16,
                       num_blocks=FLEET_BLOCKS, kv_dtype="f32", **kw)


def _fleet_run(params, cfg, prompts, crash_dir, mode_kw):
    """One fleet run, the main path: 3 replicas sharing ``params`` (the
    factory closes over the one tree on the card), obs on, a crash
    directory, r1 killed after its 8th step; every request submitted at
    once at its fid's seed (the default). K4's counts zeroed just before
    the submissions and read just after the last result. Returns (the
    fleet, closed; the fids; the streams; the launches; wall s)."""
    from quintnet_tpu_torch.fleet import ServeFleet
    from quintnet_tpu_torch.ft import ChaosMonkey

    fleet = ServeFleet(lambda: _fleet_engine(params, cfg, **mode_kw),
                       n_replicas=FLEET_REPLICAS, obs=True,
                       crash_dir=crash_dir,
                       chaos=ChaosMonkey(kill_at_step=FLEET_KILL[1],
                                         mode="raise",
                                         target=FLEET_KILL[0]))
    victim = next(r for r in fleet.replicas if r.name == FLEET_KILL[0])
    dead_pool = weakref.ref(victim.engine.pool.k)
    del victim
    try:
        _zero_counts()
        _sync()
        t0 = time.perf_counter()
        fids = [fleet.submit(p, FLEET_NEW) for p in prompts]
        outs = [fleet.result(f, timeout=600) for f in fids]
        _sync()
        wall = time.perf_counter() - t0
        launches = _launches()
        # the dump is written by the dispatcher outside the fleet lock
        t_wait = time.perf_counter()
        while not fleet.crash_dumps and time.perf_counter() - t_wait < 30:
            time.sleep(0.01)
    finally:
        fleet.close()
    # the restart dropped the dead engine: nothing keeps its pool
    gc.collect()
    if fleet.metrics.restarts and dead_pool() is not None:
        raise AssertionError("the dead replica's KV pool outlived its "
                             "restart")
    return fleet, fids, outs, launches, wall


def _check_fleet_run(fleet, cfg, launches):
    """The armed death and only it; a migration; every replica thread
    launched K4, and nothing else did; K4 == n_layer x (decode steps +
    prefills) over every engine that served, the dead one included."""
    from quintnet_tpu_torch.obs import load_crash_dump

    deaths = fleet.events.snapshot(kind="replica_death")
    armed = [(FLEET_KILL[0], f"ChaosKilled: chaos kill after global step "
                             f"{FLEET_KILL[1]}")]
    if [(d["replica"], d["error"]) for d in deaths] != armed:
        raise AssertionError(f"replica deaths {deaths}; expected only the "
                             f"armed one {armed}")
    m = fleet.metrics
    if m.migrations < 1 or m.finished != FLEET_REQUESTS or m.shed:
        raise AssertionError(f"fleet metrics {m.summary()}")
    if not fleet.crash_dumps:
        raise AssertionError("no crash dump written")
    dump = load_crash_dump(fleet.crash_dumps[0])
    if dump["replica"] != FLEET_KILL[0] or not dump["ring"]:
        raise AssertionError(f"crash dump of {dump['replica']} with "
                             f"{len(dump['ring'])} step records")
    engines = ([r.engine.metrics for r in fleet.replicas]
               + list(fleet._retired_metrics))
    L = _depth(cfg)
    want = {"decode": L * sum(e.decode_steps for e in engines),
            "prefill": L * sum(e.admitted for e in engines)}
    if torch.device(DEVICE).type == "cuda":
        _check_launches(launches, "f32", want)
        if set(launches["by_thread"]) != set(FLEET_THREADS):
            raise AssertionError(
                f"K4 launched by threads {launches['by_thread']}; "
                f"expected every replica thread {FLEET_THREADS} and no "
                f"other")
    return want, dump


def _fleet_numbers(fleet, wall):
    """Wall s, TTFT (fleet clock: queue wait included) and ITL
    percentiles, each replica's step p50 from its recorder ring (the
    dead one's from its crash dump), migrated and shed counts."""
    s = fleet.summary()
    rings = {r.name: r.engine.recorder.snapshot() for r in fleet.replicas}
    rings[FLEET_KILL[0] + " (dead)"] = fleet.last_crash["ring"]
    return {"wall_s": wall,
            "ttft_s": s["ttft_s"], "itl_s": s["engine"]["itl_s"],
            "latency_s": s["latency_s"],
            "step_ms_p50": {name: float(np.median(
                [r["t1"] - r["t0"] for r in ring]) * 1e3) if ring else None
                for name, ring in rings.items()},
            "steps": {name: len(ring) for name, ring in rings.items()},
            "migrations": s["migrations"], "shed": s["shed"],
            "replica_deaths": s["replica_deaths"],
            "restarts": s["restarts"],
            "gen_tokens": s["engine"]["gen_tokens"]}


def _op_census(run):
    """(host aten ops, device operations, device-to-host copies, lost
    records) of ``run()`` in one ``torch.profiler`` window: device
    operations are the device records (kernels, copies, sets) plus the
    launches whose records the profiler dropped (``_lost_records``)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(DEVICE).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run()
        _sync()
    host = dev = dtoh = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += 1
            dtoh += "DtoH" in e.name
        elif e.name.startswith("aten::"):
            host += 1
    lost = sum(_lost_records(prof).values())
    return {"host_aten_ops": host, "device_ops": dev + lost,
            "dtoh_copies": dtoh, "lost_records": lost}


CENSUS = ("steps", "host_aten_ops", "device_ops", "dtoh_copies")


def _census_run(params, cfg, prompts, observed):
    """The inertness script on a fresh warmed engine, tracer and recorder
    armed or not: its streams, steps and op census."""
    from quintnet_tpu_torch import obs

    eng = _fleet_engine(params, cfg)
    eng.warmup()
    if observed:
        eng.tracer = obs.Tracer(clock=eng.clock)
        eng.recorder = obs.StepRecorder(capacity=256, clock=eng.clock)
    streams = []

    def run():
        streams[:] = _run_requests(eng, prompts, [INERT_NEW] * len(prompts),
                                   [0] * len(prompts))[0]

    out = {**_op_census(run), "steps": eng.metrics.steps,
           "streams": [s.tobytes() for s in streams]}
    if observed:
        out["spans"] = sum(len(eng.tracer.spans(t))
                           for t in eng.tracer.trace_ids())
        out["records"] = len(eng.recorder)
    del eng
    _free_card()
    return out


def _inertness(params, cfg):
    """The same greedy script on two warmed engines, one with the tracer
    and the recorder armed: streams byte-equal, and the same steps, host
    ops, device operations and device-to-host copies. A census that
    differs beside records the profiler dropped is taken again, both
    sides (``PROFILED_WINDOWS`` at most: a dropped copy record cannot be
    told from a copy not made); one that differs without is a fault."""
    rng = np.random.default_rng(72)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in INERT_LENS]
    for window in range(1, PROFILED_WINDOWS + 1):
        off, on = (_census_run(params, cfg, prompts, observed)
                   for observed in (False, True))
        if on["streams"] != off["streams"]:
            raise AssertionError("tracing on changed the streams")
        differs = {k: (off[k], on[k]) for k in CENSUS if on[k] != off[k]}
        lost = off["lost_records"] + on["lost_records"]
        if not differs:
            break
        if not lost or window == PROFILED_WINDOWS:
            raise AssertionError(f"tracing on vs off differs: {differs}")
        _emit({"check": "inertness census differed beside lost records",
               "window": window, "differs": differs, "lost_records": lost})
    if not (on["spans"] and on["records"] == on["steps"]):
        raise AssertionError(f"the observer observed {on['spans']} "
                             f"spans, {on['records']} step records")
    return {"steps": on["steps"], "spans": on["spans"], "windows": window,
            **{f"{k}_per_step": on[k] / on["steps"] for k in CENSUS[1:]},
            "lost_records_off_on": [off["lost_records"],
                                    on["lost_records"]]}


class _TickClock:
    """A fake clock advancing ``dt`` on every read."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _deadline(params, cfg):
    """One engine on a clock that advances a fixed step a read: a running
    request past its deadline is retired with ``DeadlineExceeded`` mid
    decode, its blocks go back (nothing held after the run, its chain
    hits on a resubmission), and the other request finishes."""
    from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded

    rng = np.random.default_rng(73)
    p1, p2 = (rng.integers(0, cfg.vocab_size, n).astype(np.int32)
              for n in (64, 48))
    eng = _fleet_engine(params, cfg, clock=_TickClock(DEADLINE_TICK_S))
    r1 = eng.submit(p1, 4 * FLEET_NEW, deadline_s=DEADLINE_S)
    r2 = eng.submit(p2, FLEET_NEW)
    eng.run()
    try:
        eng.result(r1)
        raise AssertionError("the deadline did not retire its request")
    except DeadlineExceeded as e:
        got = e.generated
    if (not 0 < got < 4 * FLEET_NEW
            or len(eng.result(r2)) != len(p2) + FLEET_NEW):
        raise AssertionError(f"retired after {got} tokens")
    held = eng.pool.num_used
    hits0 = eng.metrics.prefix_hit_tokens
    eng.submit(p1, 4)
    eng.run()
    hit = eng.metrics.prefix_hit_tokens - hits0
    if held or hit < len(p1) // 2 or eng.metrics.deadline_exceeded != 1:
        raise AssertionError(f"after the deadline: {held} blocks held, "
                             f"{hit} tokens hit on resubmission")
    del eng
    _free_card()
    return {"generated_before_deadline": got, "blocks_held_after": held,
            "resubmission_prefix_hit_tokens": hit}


def phase_serve_fleet(params, cfg):
    """GPT-2 124M (12 layers, the serve phases' weights) served by a
    3-replica ``ServeFleet`` (``FLEET_*``: 4 slots, f32 pools, obs on, a
    crash directory), 16 requests of 32-256 tokens, 32 new each, all
    submitted at once; r1 killed after its 8th step (``ChaosMonkey``,
    mode raise). Greedy, then sampled (``SAMPLED``) at each fid's seed.
    Gates: greedy streams equal the dense greedy up to near-ties
    (``_check_against_dense``), sampled ones the port's single engine at
    the same seeds up to perturbed near-ties; a migration, exactly the
    armed death, a crash dump that loads, the fleet's exposition parses;
    K4 from all 3 replica threads and no other, n_layer x (decode steps
    + prefills) over every engine. Then on one engine: tracing on vs off
    equal in streams, host ops, device operations and device-to-host
    copies; a deadline on a ticking clock retires a running request
    typed with its blocks returned. Prints the fleet's wall s, TTFT and
    ITL percentiles, each replica's step p50, migrations, sheds, peak
    memory and the memory left after close, beside the card's name and
    power limit."""
    import tempfile

    from quintnet_tpu_torch.obs import parse_exposition, render_exposition

    prompts = _fleet_prompts(cfg)
    smi = _smi() if torch.device(DEVICE).type == "cuda" else "(no card)"
    res = {"phase": "serve_fleet", "model": "gpt2-124M (random init, "
           "seed 0)", "card": smi, "replicas": FLEET_REPLICAS,
           "max_slots": FLEET_SLOTS, "requests": FLEET_REQUESTS,
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": FLEET_NEW, "kill": list(FLEET_KILL),
           "runs": {}}
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces",
                               lambda: None)
    if torch.cuda.is_available():
        # the baseline: what the earlier phases still hold once collected
        gc.collect()
        clear_workspaces()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    totals = {"decode": 0, "prefill": 0}
    with tempfile.TemporaryDirectory() as crash_root:
        for mode, mode_kw in (("greedy", {}), ("sampled", SAMPLED)):
            fleet, fids, outs, launches, wall = _fleet_run(
                params, cfg, prompts, os.path.join(crash_root, mode),
                mode_kw)
            want, dump = _check_fleet_run(fleet, cfg, launches)
            for k in totals:
                totals[k] += want[k]
            run = _fleet_numbers(fleet, wall)
            run["launches_by_path"] = want
            run["launches_by_thread"] = launches["by_thread"]
            run["crash_dump"] = {"ring": len(dump["ring"]),
                                 "requests": len(dump["requests"]),
                                 "traces": len(dump["traces"])}
            text = render_exposition(fleet.metrics.summary(),
                                     fleet.engine_summaries(),
                                     health=fleet.health())
            run["exposition_samples"] = len(parse_exposition(text))
            if mode == "greedy":
                checked, ties = _check_against_dense(
                    params, cfg, fleet, fids, prompts, F32_GAP)
                run["tokens_checked_vs_dense"] = checked
                run["near_ties"] = ties
            else:
                one = _fleet_engine(params, cfg, **mode_kw)
                want_streams = _run_requests(one, prompts,
                                             [FLEET_NEW] * len(prompts),
                                             fids)[0]
                del one
                agree, compared, div = _near_tie_compare(
                    params, cfg, outs, want_streams, prompts, seeds=fids)
                run["tokens_agreeing_with_one_engine"] = agree
                run["tokens_compared"] = compared
                run["divergences_at_near_ties"] = div
            res["runs"][mode] = run
            del fleet, outs
            gc.collect()
            _free_card()
    res["inertness"] = _inertness(params, cfg)
    res["deadline"] = _deadline(params, cfg)
    if torch.cuda.is_available():
        gc.collect()
        res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        res["memory_allocated_after_close_bytes"] = (
            torch.cuda.memory_allocated() - before)
        # each thread's cuBLAS handle keeps a workspace (the size
        # CUBLAS_WORKSPACE_CONFIG sets) in the caching allocator
        clear_workspaces()
        res["memory_allocated_after_close_and_cublas_workspaces_cleared_"
            "bytes"] = torch.cuda.memory_allocated() - before
    _emit(res)
    return res, totals


# ---------------------------------------------------------------------
# phase 3g: the process fleet (replica processes, a SIGKILL, the
# disaggregated pools, the HTTP front door)
# ---------------------------------------------------------------------

PROC_REPLICAS = 3
PROC_KILL = ("p1", 8)            # SIGKILLed once the journal holds this
#                                  many of its streamed tokens
PROC_POOLS = {"prefill": 1, "decode": 2}
PROC_SPAWN_TIMEOUT_S = 120.0
PROC_WAIT_S = 120.0              # the bound of every wait of the phase
PROC_PROBE_NEW = 8               # the restarted replica's probe request
PROC_HEARTBEAT_S = 0.02          # beats carry the mirrored step records


def build_proc_engine(*, device=DEVICE, model=None, **kw):
    """The process fleet's engine builder: each replica process loads
    this file by path (``{"file": <this file>, "func":
    "build_proc_engine"}``; ``main`` stays behind its guard, so the
    import runs no phase) and builds GPT-2 (``model``: the config's
    fields; GPT-2 124M without) from the serve phases' seeded generator
    on ``device``, ``gpt2_init(torch.Generator(device).manual_seed(0))``
    — the call that made the parent's oracle weights, so every replica
    holds them — in serve_fleet's engine (4 slots, 160 blocks of 16, an
    f32 pool)."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)     # the CPU rehearsal's children
    cfg = GPT2Config(**model) if model else GPT2Config.base()
    params = gpt2_init(torch.Generator(device=device).manual_seed(0), cfg)
    return ServeEngine(gpt2_family(cfg), params, device=device,
                       max_slots=FLEET_SLOTS, block_size=16,
                       num_blocks=FLEET_BLOCKS, kv_dtype="f32", **kw)


def _proc_fleet(cfg, mode_kw, **kw):
    """A ``ProcessFleet`` of this file's builder on ``DEVICE``, obs on;
    (fleet, spawn-to-hello s)."""
    import dataclasses

    from quintnet_tpu_torch.fleet import ProcessFleet

    spec = {"file": os.path.abspath(__file__), "func": "build_proc_engine",
            "kwargs": {"model": dataclasses.asdict(cfg), **mode_kw}}
    t0 = time.perf_counter()
    fleet = ProcessFleet(spec, device=DEVICE, obs=True,
                         heartbeat_s=PROC_HEARTBEAT_S,
                         spawn_timeout_s=PROC_SPAWN_TIMEOUT_S, **kw)
    return fleet, time.perf_counter() - t0


class _BeatWatch:
    """The largest heartbeat age of a live replica, polled every 10 ms
    on a thread of its own while the run is in flight."""

    def __init__(self, fleet):
        import threading

        self.max_age_s = 0.0
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.01):
                for r in fleet.replicas:
                    if r.state == "healthy":
                        self.max_age_s = max(self.max_age_s, r.hb.age_s)

        self._thread = threading.Thread(target=poll, daemon=True,
                                        name="beat-watch")
        self._thread.start()

    def stop(self) -> float:
        self._stop.set()
        self._thread.join(timeout=5)
        return self.max_age_s


def _wait_for(pred, what):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > PROC_WAIT_S:
            raise AssertionError(f"timed out after {PROC_WAIT_S} s "
                                 f"waiting for {what}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _proc_k4(fleet, cfg):
    """Each replica incarnation that answers ``stats``: K4 == n_layer x
    (its decode steps + prefills), all f32, by path, and (on the card)
    launched at all. Returns {replica: {"decode", "prefill"}}."""
    L = _depth(cfg)
    out = {}
    for name, s in fleet.replica_stats().items():
        want = {"decode": L * s["decode_steps"], "prefill": L * s["admitted"]}
        if torch.device(DEVICE).type == "cuda":
            k4 = s["k4"]
            _check_launches({"total": k4["launches"],
                             "by_variant": k4["by_variant"],
                             "by_path": k4["by_path"]}, "f32", want)
            if not k4["launches"]:
                raise AssertionError(f"replica {name} launched no K4")
        out[name] = want
    names = {r.name for r in fleet.replicas}
    if set(out) != names:
        raise AssertionError(f"stats from {sorted(out)}; every replica "
                             f"{sorted(names)} should answer")
    return out


def _ring_p50_ms(ring):
    return (float(np.median([r["t1"] - r["t0"] for r in ring]) * 1e3)
            if ring else None)


def _sse(fd, prompt, max_new):
    """One streamed request through the front door: (fid, streamed
    tokens, the done event's output)."""
    import http.client

    conn = http.client.HTTPConnection(fd.host, fd.port, timeout=PROC_WAIT_S)
    conn.request("POST", "/v1/generate", json.dumps(
        {"prompt": [int(t) for t in prompt], "max_new_tokens": max_new,
         "stream": True}), {})
    r = conn.getresponse()
    if r.status != 200:
        raise AssertionError(f"front door stream: HTTP {r.status}")
    fid = int(r.getheader("X-Fleet-Fid"))
    events = [e for e in r.read().decode().split("\n\n") if e.strip()]
    conn.close()
    toks = [json.loads(e.split("data: ", 1)[1]) for e in events
            if e.startswith("data: ")]
    done = [json.loads(e.split("data: ", 1)[1]) for e in events
            if e.startswith("event: done")]
    if len(done) != 1 or [t["last"] for t in toks].count(True) != 1:
        raise AssertionError(f"front door stream: {len(done)} done "
                             f"events, last flags {toks}")
    return fid, [t["token"] for t in toks], np.asarray(done[0]["output"])


def _front_door(fleet, prompt, max_new):
    """One SSE request, /healthz and /metrics through ``FrontDoor`` in
    front of ``fleet``: the streamed tokens equal ``result()``, 200 on
    /healthz, an exposition that parses. Returns (output, numbers)."""
    import http.client

    from quintnet_tpu_torch.fleet import FrontDoor
    from quintnet_tpu_torch.obs import parse_exposition

    with FrontDoor(fleet) as fd:
        fid, toks, out = _sse(fd, prompt, max_new)
        result = fleet.result(fid, timeout=PROC_WAIT_S)
        if not (np.array_equal(out, result)
                and toks == [int(t) for t in result[len(prompt):]]):
            raise AssertionError("front door: SSE tokens != result()")
        got = {}
        for path in ("/healthz", "/metrics"):
            conn = http.client.HTTPConnection(fd.host, fd.port,
                                              timeout=PROC_WAIT_S)
            conn.request("GET", path)
            r = conn.getresponse()
            got[path] = (r.status, r.read().decode())
            conn.close()
    if got["/healthz"][0] != 200:
        raise AssertionError(f"/healthz: {got['/healthz']}")
    samples = len(parse_exposition(got["/metrics"][1]))
    if got["/metrics"][0] != 200 or not samples:
        raise AssertionError(f"/metrics: HTTP {got['/metrics'][0]}, "
                             f"{samples} samples")
    return result, {"fid": fid, "streamed_tokens": len(toks),
                    "healthz": json.loads(got["/healthz"][1])["status"],
                    "exposition_samples": samples}


def _proc_run(params, cfg, prompts, mode_kw, *, pools=None, crash_dir=None,
              front_door=False):
    """One process-fleet run of the main path: three replica processes
    (colocated, p1 SIGKILLed by a real signal once the journal holds
    ``PROC_KILL[1]`` of its tokens, restarted through the breaker and
    probed alone) or ``pools`` (disaggregated, no kill). Warm-up, then
    every child's counters and ledgers reset just before the
    submissions, the K4 gate read from each child just after; the
    parent's own counts zeroed before and read after (it launches
    none). Returns (the closed fleet, whose ``result`` still answers;
    the fids; the numbers; K4 by replica)."""
    from quintnet_tpu_torch.fleet import HEALTHY
    from quintnet_tpu_torch.obs import load_crash_dump

    kill = pools is None
    kw = ({"pools": pools} if pools is not None
          else {"n_replicas": PROC_REPLICAS, "crash_dir": crash_dir})
    fleet, spawn_s = _proc_fleet(cfg, mode_kw, **kw)
    handoff_ms = []
    if pools is not None:
        # the transfer's wall, each handoff thread timed around the
        # fleet's own routine (instance attribute: the fleet looks it
        # up when it starts the thread)
        run_handoff = fleet._run_handoff

        def timed_handoff(src, freq):
            t0 = time.perf_counter()
            try:
                run_handoff(src, freq)
            finally:
                handoff_ms.append((time.perf_counter() - t0) * 1e3)

        fleet._run_handoff = timed_handoff
    num = {"spawn_to_hello_s": spawn_s}
    try:
        t0 = time.perf_counter()
        fleet.warmup()
        num["warmup_s"] = time.perf_counter() - t0
        fleet.reset_metrics()
        streamed = collections.defaultdict(list)
        lasts = collections.Counter()

        def on_token(fid, tok, last):
            streamed[fid].append(int(tok))
            lasts[fid] += bool(last)

        _zero_counts()
        watch = _BeatWatch(fleet)
        t0 = time.perf_counter()
        fids = [fleet.submit(p, FLEET_NEW, on_token=on_token)
                for p in prompts]
        if kill:
            victim = fleet.replica(PROC_KILL[0])

            def journaled():
                with fleet._cv:
                    return sum(len(f.committed)
                               for f in victim.unfinished())

            # and once a heartbeat has mirrored its step records: the
            # crash dump's black box
            _wait_for(lambda: (journaled() >= PROC_KILL[1]
                               and victim.ring_snapshot()),
                      f"{PROC_KILL[1]} tokens journaled from "
                      f"{PROC_KILL[0]} and its ring mirrored")
            victim.kill()
            t_kill = time.perf_counter()
            num["journaled_at_kill"] = journaled()
        outs = [fleet.result(f, timeout=PROC_WAIT_S) for f in fids]
        num["wall_s"] = time.perf_counter() - t0
        num["max_heartbeat_age_s"] = watch.stop()
        for fid, p, out in zip(fids, prompts, outs):
            if (lasts[fid] != 1
                    or streamed[fid] != [int(t) for t in out[len(p):]]):
                raise AssertionError(
                    f"request {fid}: {lasts[fid]} last flags, streamed "
                    f"{len(streamed[fid])} tokens against {len(out) - len(p)}")
        if kill:
            _wait_for(lambda: (fleet.metrics.restarts >= 1
                               and fleet.replica(PROC_KILL[0]).state
                               == HEALTHY), f"{PROC_KILL[0]}'s restart")
            num["restart_s"] = time.perf_counter() - t_kill
            # the restarted incarnation serves alone: a probe of the first
            # request again, at its seed
            others = [r.name for r in fleet.replicas
                      if r.name != PROC_KILL[0]]
            for name in others:
                fleet.pause_replica(name, True)
            probe = fleet.submit(prompts[0], PROC_PROBE_NEW, seed=fids[0])
            num["probe"] = fleet.result(probe, timeout=PROC_WAIT_S)
            if fleet.request(probe).replica_name != PROC_KILL[0]:
                raise AssertionError("the probe missed the restarted "
                                     "replica")
            for name in others:
                fleet.pause_replica(name, False)
        if front_door:
            num["front_door_output"], num["front_door"] = _front_door(
                fleet, prompts[1], FLEET_NEW)
        k4 = _proc_k4(fleet, cfg)
        parent = _launches()
        if parent["total"]:
            raise AssertionError(f"the parent launched K4 during the "
                                 f"run: {parent}")
        s = fleet.summary()
        m = fleet.metrics
        if kill:
            deaths = [e["replica"] for e in
                      fleet.events.snapshot(kind="replica_death")]
            if deaths != [PROC_KILL[0]] or m.stalls or m.migrations < 1:
                raise AssertionError(f"deaths {deaths}, stalls {m.stalls}, "
                                     f"migrations {m.migrations}: "
                                     f"expected the kill alone")
            _wait_for(lambda: fleet.crash_dumps, "the crash dump")
            dump = load_crash_dump(fleet.crash_dumps[0])
            if dump["replica"] != PROC_KILL[0] or not dump["ring"]:
                raise AssertionError(f"crash dump of {dump['replica']} "
                                     f"with {len(dump['ring'])} records")
            num["crash_dump"] = {"ring": len(dump["ring"]),
                                 "requests": len(dump["requests"])}
            rings = {r.name: r.ring_snapshot() for r in fleet.replicas}
            rings[PROC_KILL[0] + " (dead)"] = dump["ring"]
        else:
            # every request needs more than its first token
            want_handoffs = len(prompts) if FLEET_NEW > 1 else 0
            if (m.handoffs != want_handoffs or m.handoff_fallbacks
                    or m.handoff_transfers != want_handoffs):
                raise AssertionError(
                    f"handoffs {m.handoffs}, transfers "
                    f"{m.handoff_transfers}, fallbacks "
                    f"{m.handoff_fallbacks}; expected {want_handoffs}, "
                    f"{want_handoffs}, 0")
            moved = [e["transferred_tokens"]
                     for e in fleet.events.snapshot(kind="handoff")]
            block = (2 * _depth(cfg) * 16 * cfg.n_head
                     * (cfg.n_embd // cfg.n_head) * 4)
            num["kv_bytes_shipped"] = sum(-(-n // 16) * block for n in moved)
            num["handoff_ms"] = {"p50": float(np.median(handoff_ms)),
                                 "max": float(max(handoff_ms)),
                                 "n": len(handoff_ms)}
            rings = {r.name: r.ring_snapshot() for r in fleet.replicas}
        if m.finished != len(outs) + kill + front_door or m.shed:
            raise AssertionError(f"fleet metrics {m.summary()}")
        num.update({
            "ttft_s": s["ttft_s"], "latency_s": s["latency_s"],
            "itl_s": {n: e["itl_s"] for n, e in s["engines"].items()},
            "step_ms_p50": {n: _ring_p50_ms(r) for n, r in rings.items()},
            "steps": {n: len(r) for n, r in rings.items()},
            "migrations": m.migrations, "replica_deaths": m.replica_deaths,
            "stalls": m.stalls, "restarts": m.restarts,
            "handoffs": m.handoffs, "handoff_transfers": m.handoff_transfers,
            "handoff_fallbacks": m.handoff_fallbacks,
            "tokens_delivered": s["tokens_delivered"]})
    finally:
        fleet.close()
    return fleet, fids, num, k4


def phase_serve_proc_fleet(params, cfg):
    """GPT-2 124M (12 layers; ``params`` the serve phases' weights, the
    oracle's) served by a ``ProcessFleet`` of replica PROCESSES on the one
    card, serve_fleet's traffic (16 requests of 32-256 tokens + 32, the
    fid's seed). Colocated greedy: 3 replicas, p1 SIGKILLed (a real
    signal) once the journal holds 8 of its tokens, restarted through
    the breaker and probed alone; every stream equals the dense greedy
    up to near-ties (< 1e-3), exactly one death, a migration, ``is_last``
    once a request, a crash dump holding the heartbeat-mirrored ring;
    then one request through the ``FrontDoor`` (SSE tokens equal
    ``result()``, /healthz 200, /metrics parses). Colocated sampled
    (``SAMPLED``), the same kill: streams equal one engine in the parent
    at the fids' seeds up to perturbed near-ties. Disaggregated
    (``PROC_POOLS``, greedy): streams equal the colocated greedy run's up
    to near-ties, a handoff (and a transfer) for every request, no
    fallback. K4: every replica incarnation that answers ``stats`` ==
    n_layer x (decode steps + prefills), all f32, by path, each one
    launched; the parent none. Reported: a replica's step p50 from its
    mirrored ring, wall, TTFT and ITL, spawn-to-hello and restart s, the
    largest heartbeat age, KV bytes shipped and handoff ms, the card's
    free memory before and after, its name and power limit. Returns
    (result, K4 launches by path over every run)."""
    import tempfile

    from quintnet_tpu_torch.ops import build

    prompts = _fleet_prompts(cfg)
    on_card = torch.device(DEVICE).type == "cuda"
    if on_card:
        build.load("paged_attention")   # children load it, never build
        gc.collect()
        torch.cuda.empty_cache()
    res = {"phase": "serve_proc_fleet",
           "model": "gpt2-124M (random init, seed 0)",
           "card": _smi() if on_card else "(no card)",
           "replicas": PROC_REPLICAS, "pools": PROC_POOLS,
           "max_slots": FLEET_SLOTS, "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": FLEET_NEW, "kill": list(PROC_KILL),
           "runs": {}}
    if on_card:
        res["card_free_bytes_before"] = torch.cuda.mem_get_info()[0]
    totals = {"decode": 0, "prefill": 0}

    def tally(k4):
        for want in k4.values():
            for path in totals:
                totals[path] += want[path]
        return k4

    with tempfile.TemporaryDirectory() as crash_root:
        fleet, fids, num, k4 = _proc_run(
            params, cfg, prompts, {},
            crash_dir=os.path.join(crash_root, "greedy"), front_door=True)
        greedy = [fleet.result(f) for f in fids]
        checked, ties = _check_against_dense(params, cfg, fleet, fids,
                                             prompts, F32_GAP)
        probe = num.pop("probe")
        fd_out = num.pop("front_door_output")
        agree, compared, div = _near_tie_compare(
            params, cfg, [probe, fd_out],
            [greedy[0][:len(probe)], greedy[1]], prompts[:2])
        num.update({"tokens_checked_vs_dense": checked, "near_ties": ties,
                    "probe_and_front_door_vs_run": [agree, compared, div],
                    "launches_by_replica": tally(k4)})
        res["runs"]["colocated_greedy"] = num

        fleet, fids, num, k4 = _proc_run(
            params, cfg, prompts, SAMPLED,
            crash_dir=os.path.join(crash_root, "sampled"))
        sampled = [fleet.result(f) for f in fids]
        one = _fleet_engine(params, cfg, **SAMPLED)
        want = _run_requests(one, prompts, [FLEET_NEW] * len(prompts),
                             fids)[0]
        del one
        _free_card()
        probe = num.pop("probe")
        agree, compared, div = _near_tie_compare(
            params, cfg, sampled + [probe],
            want + [want[0][:len(probe)]], prompts + prompts[:1],
            seeds=fids + fids[:1])
        num.update({"tokens_agreeing_with_one_engine": agree,
                    "tokens_compared": compared,
                    "divergences_at_near_ties": div,
                    "launches_by_replica": tally(k4)})
        res["runs"]["colocated_sampled"] = num

    fleet, fids, num, k4 = _proc_run(params, cfg, prompts, {},
                                     pools=PROC_POOLS)
    agree, compared, div = _near_tie_compare(
        params, cfg, [fleet.result(f) for f in fids], greedy, prompts)
    num.update({"tokens_agreeing_with_colocated": agree,
                "tokens_compared": compared,
                "divergences_at_near_ties": div,
                "launches_by_replica": tally(k4)})
    res["runs"]["disaggregated_greedy"] = num
    res["launches_by_path"] = totals
    if on_card:
        gc.collect()
        res["card_free_bytes_after_close"] = torch.cuda.mem_get_info()[0]
    _emit(res)
    return res, totals


# ---------------------------------------------------------------------
# phase 3b: Llama-3.2-1B served through K4's GQA path
# ---------------------------------------------------------------------

# 8 requests of 16-200 prompt tokens, 32 new tokens each, at these seeds
LLAMA_SERVE_LENS = (16, 200, 64, 120, 33, 180, 90, 150)
LLAMA_SERVE_NEW = 32
LLAMA_SERVE_SEEDS = tuple(range(200, 208))
# the spec-on run: 4 requests tiling a short pattern, 24 new tokens
LLAMA_SPEC_REQUESTS, LLAMA_SPEC_NEW = 4, 24


def _llama_engine(params, cfg, **kw):
    from quintnet_tpu_torch.serve import ServeEngine, llama_family

    kw = {"max_slots": 8, "block_size": 16, "num_blocks": 200,
          "max_seq_len": 512, "kv_dtype": "f32", **kw}
    eng = ServeEngine(llama_family(cfg), params, device=DEVICE, **kw)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _llama_script(eng, prompts):
    """Every request at once, stepped to the end: (rids, per-step (wall
    s, admissions, decode tokens))."""
    steps = []
    rids = [eng.submit(p, LLAMA_SERVE_NEW, seed=sd)
            for p, sd in zip(prompts, LLAMA_SERVE_SEEDS)]
    while eng.has_work:
        a0, d0 = eng.metrics.admitted, eng.metrics.decode_tokens
        t = time.perf_counter()
        eng.step()                  # ends in a device->host token copy
        steps.append((time.perf_counter() - t, eng.metrics.admitted - a0,
                      eng.metrics.decode_tokens - d0))
    return rids, steps


def phase_serve_llama():
    """Llama-3.2-1B uncut (16 layers, 32 query heads on 8 kv heads, vocab
    128,256; random weights, seed 0) served by the engine with
    ``llama_family``: the pool holds the 8 UNrepeated kv heads and K4
    takes the GQA group (group 4: the decode path at P = 1). Gates: greedy
    streams vs the dense ``llama_apply`` teacher-forced (near-tie rule),
    sampled streams vs ``llama_generate`` at each seed (near-tie rule),
    the int8 pool under the narrow-layout rule (>= 90% agreement, a flip
    only at a gap < 0.05), speculation's streams vs spec-off (its verify
    calls at P = 3, 5, 9 on the prefill path: 12-36 rows a kv head), and
    K4 == 16 x (decode steps + prefills [+ verifies]) by path in every
    run; the profiled decode steps 16 decode-path kernels a step.
    Reported: decode step ms, decode tokens/s, KV bytes a token."""
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_init
    from quintnet_tpu_torch.ops.paged_attention import _path

    cfg = LlamaConfig.llama32_1b()
    params = llama_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    L = cfg.n_layers
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LLAMA_SERVE_LENS]
    res = {"phase": "serve_llama",
           "model": "Llama-3.2-1B uncut (random init, seed 0)",
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "prompt_lens": list(LLAMA_SERVE_LENS),
           "max_new_tokens": LLAMA_SERVE_NEW, "runs": {}}
    by_variant = {}

    def main_path(name, gap, **kw):
        eng, warm = _llama_engine(params, cfg, **kw)
        _zero_counts()
        rids, steps = _llama_script(eng, prompts)
        launches = _launches()
        m = eng.metrics
        if m.finished != len(rids):
            raise AssertionError(f"{name}: {m.finished} of {len(rids)} "
                                 f"finished")
        _check_launches(launches, _variant(eng.pool),
                        {"decode": L * m.decode_steps,
                         "prefill": L * m.admitted})
        run = {"kv_dtype": eng.kv_policy.name, "warmup_s": warm,
               "weights_dtype": eng.weights_dtype,
               "weight_bytes": eng.weight_bytes,
               "launches_by_path": launches["by_path"]}
        run.update(_serve_numbers(eng, rids, prompts, steps))
        by_variant.setdefault(_variant(eng.pool), collections.Counter()
                              ).update(launches["by_path"])
        if gap is not None:
            checked, mism = _check_against_dense(params, cfg, eng, rids,
                                                 prompts, gap)
            run.update({"tokens_checked_vs_dense": checked,
                        "agree_with_dense": 1.0 - len(mism) / checked,
                        "mismatches": mism})
        res["runs"][name] = run
        return eng, rids

    eng, rids = main_path("greedy_f32", F32_GAP)
    res["runs"]["greedy_f32"].update(
        _kernel_share(eng, cfg, np.random.default_rng(5)))
    del eng
    torch.cuda.empty_cache()
    eng, rids = main_path("sampled_f32", None, **SAMPLED)
    agree, compared, div = _check_sampled_vs_dense(params, cfg, eng, rids,
                                                   prompts)
    res["runs"]["sampled_f32"].update({
        "sampling": SAMPLED, "seeds": list(LLAMA_SERVE_SEEDS),
        "tokens_agreeing_with_llama_generate": agree,
        "tokens_compared": compared, "divergences_at_near_ties": div})
    del eng
    torch.cuda.empty_cache()
    eng, _ = main_path("greedy_int8", NARROW_GAP, kv_dtype="int8")
    agree = res["runs"]["greedy_int8"]["agree_with_dense"]
    if agree < 0.9:
        raise AssertionError(f"int8 Llama: {agree} of tokens agree with "
                             f"the dense greedy (< 0.9)")
    del eng
    torch.cuda.empty_cache()
    # serve_wq on Llama: int8 weights (q/k/v/o, gate/up/down packed once),
    # the f32 pool, the narrow-layout rule against the f32 dense greedy
    eng, rids = main_path("greedy_int8_weights", NARROW_GAP,
                          weights_dtype="int8")
    run = res["runs"]["greedy_int8_weights"]
    run.update(_check_own_dense(params, eng.family, cfg, eng, rids,
                                prompts, "int8"))
    if run["agree_with_dense"] < 0.9:
        raise AssertionError(f"int8-weight Llama: {run['agree_with_dense']}"
                             f" of tokens agree with the dense greedy "
                             f"(< 0.9)")
    run["f32_over_int8_weight_bytes"] = (
        res["runs"]["greedy_f32"]["weight_bytes"] / run["weight_bytes"])
    run["decode_step_ms_p50_f32"] = res["runs"]["greedy_f32"][
        "decode_step_ms_p50"]
    del eng
    torch.cuda.empty_cache()

    # speculation: verify calls through the paged verify block
    srng = np.random.default_rng(37)
    sp_prompts = [np.tile(srng.integers(0, cfg.vocab_size,
                                        int(srng.integers(5, 12))), 12)[:96]
                  .astype(np.int32) for _ in range(LLAMA_SPEC_REQUESTS)]
    new = [LLAMA_SPEC_NEW] * LLAMA_SPEC_REQUESTS
    seeds = LLAMA_SERVE_SEEDS[:LLAMA_SPEC_REQUESTS]
    off, _ = _llama_engine(params, cfg)
    s_off, wall_off = _run_requests(off, sp_prompts, new, seeds)
    del off
    on, _ = _llama_engine(params, cfg, spec=True)
    calls = _Calls(on)
    _zero_counts()
    s_on, wall_on = _run_requests(on, sp_prompts, new, seeds)
    launches = _launches()
    m = on.metrics
    want = {"decode": L * calls.decode, "prefill": L * m.admitted}
    for P in calls.verify:
        want[_path(cfg.n_heads, cfg.n_kv_heads, P)] += L
    _check_launches(launches, "f32", want)
    by_variant["f32"].update(want)
    agree, compared, div = _near_tie_compare(params, cfg, s_on, s_off,
                                             sp_prompts)
    res["runs"]["spec_f32"] = {
        "launches_by_path": want, "verify_calls_by_width": dict(
            collections.Counter(calls.verify)),
        "verify_paths": {P: _path(cfg.n_heads, cfg.n_kv_heads, P)
                         for P in sorted(set(calls.verify))},
        "tokens_agreeing_spec_on_vs_off": agree,
        "tokens_compared": compared, "divergences_at_near_ties": div,
        "draft_acceptance_rate": m.summary()["draft_acceptance_rate"],
        "wall_s_on_off": [wall_on, wall_off]}
    del on, params
    torch.cuda.empty_cache()
    res["launches_by_variant_and_path"] = {v: dict(c)
                                           for v, c in by_variant.items()}
    res["card"] = _smi()
    _emit(res)
    return res


# ---------------------------------------------------------------------
# phase 4: GPT-2 124M trained on the card
# ---------------------------------------------------------------------

def _timed_then_profiled(trainer, params, opt_state, batches, expect=None):
    """Train steps over the first half of ``batches`` with no profiler
    (host clock, synced), then over the second half under
    ``torch.profiler`` (``_profiled``; ``expect``: kernel symbol ->
    launches a step). Returns (wall seconds a step, peak bytes, the
    profiled device ops by name, steps profiled)."""
    n = len(batches) // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[:n]:
        trainer.step_fn(params, opt_state, trainer.device_batch(*b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()

    def steps():
        for b in batches[n:]:
            trainer.step_fn(params, opt_state, trainer.device_batch(*b))

    _, by_name = _profiled(steps, expect=expect and {
        sym: k * (len(batches) - n) for sym, k in expect.items()})
    return wall, peak, by_name, len(batches) - n


def _train_share(trainer, params, opt_state, batches, want,
                 symbols=FLASH_SYMBOLS) -> dict:
    """The step's wall time over steps run WITHOUT the profiler, then the
    device's busy time and the flash kernels' device time from as many
    further steps under ``torch.profiler``. ``want``: each flash
    wrapper's launches a step; the profiled kernels (found by ``symbols``,
    the f32 or the bf16 names) must match it exactly (in a window where
    none of them lost a record to the profiler: ``_profiled``), so a
    renamed kernel fails here instead of reading 0 ms."""
    wall, peak, by_name, n = _timed_then_profiled(
        trainer, params, opt_state, batches,
        expect={symbols[name]: want[name] for name in FLASH_KERNELS})
    busy_us = sum(us for us, _ in by_name.values())
    tokens = len(batches[0][0]) * batches[0][0].shape[1]
    out = {"steps_timed": len(batches) - n, "step_ms": wall * 1e3,
           "input_positions_per_s": tokens / wall,
           "peak_memory_gib": peak / 2 ** 30, "steps_profiled": n}
    if busy_us <= 0:
        out["kernel_share_of_step"] = ("not measured (profiler reported no "
                                       "device time)")
        return out
    per_step = lambda us: us / 1e3 / n  # noqa: E731
    kern = {}
    for name in FLASH_KERNELS:
        us, k = (0.0, 0)
        for ev, (t, c) in by_name.items():
            if symbols[name] in ev:
                us, k = us + t, k + c
        launches = k / n
        if launches != want[name]:
            raise AssertionError(
                f"profiler: {symbols[name]} launched {launches} times a "
                f"step; {name} launches {want[name]} (n_layer x "
                f"micro-batches)")
        kern[name] = {"ms_per_step": per_step(us),
                      "launches_per_step": launches,
                      "share_of_step": per_step(us) / (wall * 1e3)}
    gemm_us = sum(us for ev, (us, _) in by_name.items()
                  if any(g in ev.lower() for g in GEMM_NAMES))
    out.update({
        "device_busy_ms_per_step": per_step(busy_us),
        "device_idle_share": 1.0 - per_step(busy_us) / (wall * 1e3),
        "flash_kernels": kern,
        "flash_share_of_step": sum(v["share_of_step"]
                                   for v in kern.values()),
        "gemm_ms_per_step": per_step(gemm_us),
        "device_ops_per_step": sum(k for _, k in by_name.values()) / n,
        "top_device_ops_ms_per_step": {
            name[:80]: per_step(us) for name, (us, _) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:8]}})
    return out


def phase_train():
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                                gpt2_model_spec)
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.parallel.train_step import accumulate_grads
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = GPT2Config.base()          # every dropout rate 0: deterministic
    seq, batch, steps, n_micro, remat = 512, 64, 4, 2, False
    tcfg = Config.from_dict({"training": {
        "batch_size": batch, "gradient_accumulation_steps": n_micro,
        "optimizer": "adamw", "learning_rate": 5e-5, "weight_decay": 0.01,
        "grad_clip_norm": 1.0, "log_every": 0, "seed": 0}})
    ds = SummarizationDataset.synthetic(batch * 4, ByteTokenizer(),
                                        max_length=seq, seed=0)
    # one global batch per "epoch", so History.train_loss is per step;
    # 4 more batches for the timed and the profiled steps
    host = [next(iter(ds.batches(batch, seed=i))) for i in range(steps + 4)]
    params0 = gpt2_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)

    def fresh():
        return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params0)

    def trainer(use_flash):
        return Trainer(tcfg, gpt2_model_spec(cfg, remat=remat,
                                             use_flash=use_flash),
                       task_type="clm", device=DEVICE, log_fn=lambda m: None)

    flash, plain = trainer(True), trainer(False)

    # the first global batch: loss and every gradient leaf, same weights
    b0 = flash.device_batch(*host[0])
    p = fresh()
    loss_f, g_f = accumulate_grads(flash.model.loss_fn, p, b0, n_micro)
    loss_p, g_p = accumulate_grads(plain.model.loss_fn, p, b0, n_micro)
    loss_rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    if not loss_rel <= 1e-5:
        raise AssertionError(f"first-step loss: flash {float(loss_f)} vs "
                             f"plain {float(loss_p)} (rel {loss_rel})")
    grad_err = {".".join(k): float((g_f[k] - g_p[k]).abs().max()
                                   / g_p[k].abs().max().clamp_min(1e-30))
                for k in g_p}
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= 1e-3:
        raise AssertionError(f"gradient {worst}: max |flash - plain| / "
                             f"max |plain| = {grad_err[worst]} > 1e-3")
    del p, g_f, g_p

    # main path: counts zeroed just before, read just after
    params, opt_state = fresh(), None
    opt_state = flash.optimizer.init(params)
    _zero_counts()
    hist_f = flash.fit(lambda ep: [host[ep]], epochs=steps, params=params,
                       opt_state=opt_state)
    counts = _counts()
    if flash_attention.routed:
        raise AssertionError(f"flash_attention routed {flash_attention.routed}"
                             f" calls to the blockwise attention on the main "
                             f"path; every call must reach the kernels")
    per_kernel = cfg.n_layer * n_micro * steps
    want = {"flash_fwd": per_kernel * (2 if remat else 1),
            "flash_bwd_dkv": per_kernel, "flash_bwd_dq": per_kernel,
            "paged_attention": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}; expected {want} (n_layer "
                             f"x micro-batches x steps)")

    pp = fresh()
    hist_p = plain.fit(lambda ep: [host[ep]], epochs=steps, params=pp,
                       opt_state=plain.optimizer.init(pp))
    del pp
    for i, (a, b) in enumerate(zip(hist_f.train_loss, hist_p.train_loss)):
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise AssertionError(f"step {i}: loss flash {a} vs plain {b}")

    res = {"phase": "train", "model": "gpt2-124M f32 (random init, seed 0)",
           "global_batch": batch, "micro_batches": n_micro,
           "seq_len": seq, "steps": steps, "remat": remat,
           "optimizer": "adamw lr 5e-5 wd 0.01 clip 1.0",
           "first_loss_flash": float(loss_f), "first_loss_plain":
           float(loss_p), "first_loss_rel_diff": loss_rel,
           "worst_grad_leaf": worst, "worst_grad_rel_err": grad_err[worst],
           "loss_flash": hist_f.train_loss, "loss_plain": hist_p.train_loss,
           "fit_wall_s_flash": hist_f.wall_time_s,
           "fit_wall_s_plain": hist_p.wall_time_s, "launches": counts,
           "flash_attention_routed": flash_attention.routed}
    res.update(_train_share(flash, params, opt_state, host[steps:],
                            {k: v // steps for k, v in want.items()}))
    _emit(res)
    return res, counts


# ---------------------------------------------------------------------
# phase 4a: LoRA adapters over GPT-2 124M through K1-K3
# ---------------------------------------------------------------------

LORA = {"rank": 8, "alpha": 16.0, "targets": ("qkv", "proj", "fc")}
LORA_STEPS, LORA_GRAD_TOL = 2, 1e-5


def phase_lora_train():
    """LoRA (``LORA``) over frozen GPT-2 124M f32 weights (seed 0) on the
    train phase's data and micro-batches (64 rows of 512 in 2), attention
    through the flash dispatcher: the adapters' gradients on the first
    batch through K1-K3 against plain attention (every adapter made
    non-trivial first, so every leaf carries a gradient; each leaf
    within ``LORA_GRAD_TOL`` of its largest magnitude), then the main
    path: ``LORA_STEPS`` Adam steps of ``make_lora_train_step`` from
    zero-init ``b``, counts zeroed just before and read just after (each
    of K1-K3 12 layers x 2 micro-batches x steps, none routed); the base
    unchanged bit for bit, the step time, the Adam state's bytes beside
    a full finetune's, ``save_lora``/``load_lora`` bit for bit and the
    merged model generating."""
    import tempfile

    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, clm_loss,
                                                gpt2_forward, gpt2_init)
    from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
    from quintnet_tpu_torch.models.lora import (LoRAConfig, load_lora,
                                                lora_init, lora_merge_tree,
                                                lora_param_count,
                                                make_lora_train_step,
                                                save_lora)
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.parallel.train_step import accumulate_grads
    from quintnet_tpu_torch.train.trainer import Optimizer

    cfg = GPT2Config.base()
    seq, batch, n_micro = 512, 64, 2
    ds = SummarizationDataset.synthetic(batch * 4, ByteTokenizer(),
                                        max_length=seq, seed=0)
    host = [next(iter(ds.batches(batch, seed=i)))
            for i in range(LORA_STEPS + 2)]
    dev = [tuple(torch.from_numpy(a.astype(np.int64)).to(DEVICE)
                 for a in b) for b in host]
    params = gpt2_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    base_copy = tree_map(lambda p: p.detach().clone(), params)
    lcfg = LoRAConfig(**LORA)

    def loss_fn(use_flash):
        def fn(base, lora, mb):
            merged = lora_merge_tree(base, lora, lcfg)
            return clm_loss(gpt2_forward(merged, mb[0], cfg,
                                         use_flash=use_flash)[0], mb[1])
        return fn

    # the gradient gate: every adapter non-trivial
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    probe = tree_map(lambda t: (t + 0.01 * torch.randn(
        t.shape, generator=gen, device=DEVICE)).requires_grad_(True),
        lora_init(torch.Generator(device=DEVICE).manual_seed(1),
                  params["blocks"], lcfg))
    grads = {}
    for use_flash in (True, False):
        fn = loss_fn(use_flash)
        grads[use_flash] = accumulate_grads(
            lambda lo, mb, _g: fn(params, lo, mb), probe, dev[0], n_micro)
    (loss_f, g_f), (loss_p, g_p) = grads[True], grads[False]
    grad_err = {".".join(k): float((g_f[k] - g_p[k]).abs().max()
                                   / g_p[k].abs().max().clamp_min(1e-30))
                for k in g_p}
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= LORA_GRAD_TOL:
        raise AssertionError(f"adapter gradient {worst}: max |flash - "
                             f"plain| / max |plain| = {grad_err[worst]} > "
                             f"{LORA_GRAD_TOL}")
    del probe, grads, g_f, g_p

    lora = lora_init(torch.Generator(device=DEVICE).manual_seed(1),
                     params["blocks"], lcfg)
    opt = Optimizer("adam", 1e-3)
    state = opt.init(lora)
    step = make_lora_train_step(None, loss_fn(True), opt,
                                grad_accum_steps=n_micro)
    # main path: counts zeroed just before, read just after
    _zero_counts()
    losses = []
    for b in dev[:LORA_STEPS]:
        lora, state, loss = step(params, lora, state, b)
        losses.append(float(loss))
    counts = _counts()
    per_kernel = cfg.n_layer * n_micro * LORA_STEPS
    want = {"flash_fwd": per_kernel, "flash_bwd_dkv": per_kernel,
            "flash_bwd_dq": per_kernel, "paged_attention": 0}
    if counts != want or flash_attention.routed:
        raise AssertionError(f"launches {counts}, routed "
                             f"{flash_attention.routed}; expected {want} "
                             f"(n_layer x micro-batches x steps), 0 routed")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"LoRA losses {losses}")
    for path, p in tree_leaves(params):
        if not torch.equal(p, dict(tree_leaves(base_copy))[path]):
            raise AssertionError(f"base parameter {'.'.join(path)} moved")
    del base_copy

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in dev[LORA_STEPS:]:
        lora, state, loss = step(params, lora, state, b)
    float(loss)
    step_ms = (time.perf_counter() - t0) / (len(dev) - LORA_STEPS) * 1e3
    peak = torch.cuda.max_memory_allocated()
    n_lora = lora_param_count(lora)
    n_base = sum(p.numel() for _, p in tree_leaves(params))
    adam_bytes = sum(t.numel() * t.element_size() for part in ("mu", "nu")
                     for _, t in tree_leaves(state[part]))

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "adapters.safetensors")
        save_lora(lora, lcfg, path)
        file_bytes = os.path.getsize(path)
        back, lcfg2 = load_lora(path, device=DEVICE)
    if lcfg2 != lcfg or {k: v for k, v in tree_leaves(back)}.keys() != {
            k: v for k, v in tree_leaves(lora)}.keys() or not all(
            torch.equal(v, dict(tree_leaves(back))[k])
            for k, v in tree_leaves(lora)):
        raise AssertionError("save_lora / load_lora did not round-trip "
                             "bit for bit")
    merged = lora_merge_tree(params, back, lcfg)
    out = gpt2_generate(merged, host[0][0][:1, :32], cfg, max_new_tokens=8)
    if out.shape != (1, 40) or (out[:, 32:] >= cfg.vocab_size).any():
        raise AssertionError(f"the merged model generated {out}")
    res = {"phase": "lora_train", "model": "gpt2-124M f32 (random init, "
           "seed 0), frozen", "lora": {**LORA, "targets":
                                       list(LORA["targets"])},
           "global_batch": batch, "micro_batches": n_micro, "seq_len": seq,
           "optimizer": "adam lr 1e-3 (adapters only)",
           "first_loss_flash": float(loss_f), "first_loss_plain":
           float(loss_p), "worst_adapter_grad_leaf": worst,
           "worst_adapter_grad_rel_err": grad_err[worst],
           "losses": losses, "launches": counts,
           "flash_attention_routed": flash_attention.routed,
           "base_unchanged": True, "step_ms": step_ms,
           "peak_memory_gib": peak / 2 ** 30,
           "adapter_params": n_lora, "base_params": n_base,
           "adam_state_bytes_lora": adam_bytes,
           "adam_state_bytes_full_finetune": 2 * 4 * n_base,
           "adapter_file_bytes": file_bytes,
           "save_load_bit_for_bit": True, "merged_generates": True}
    _emit(res)
    return res, counts


# ---------------------------------------------------------------------
# phase 4b: GPT-2 124M trained on the card in bf16
# ---------------------------------------------------------------------

TRAIN_BF16 = {"dtype": "bfloat16", "adam_mu_dtype": "bfloat16"}


def phase_train_bf16(f32_first_loss):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                                gpt2_model_spec)
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.parallel.train_step import accumulate_grads
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = GPT2Config.base()          # every dropout rate 0: deterministic
    seq, batch, steps, n_micro = 512, 64, 4, 2
    tcfg = Config.from_dict({"training": {
        "batch_size": batch, "gradient_accumulation_steps": n_micro,
        "optimizer": "adamw", "learning_rate": 5e-5, "weight_decay": 0.01,
        "grad_clip_norm": 1.0, "log_every": 0, "seed": 0, **TRAIN_BF16}})
    ds = SummarizationDataset.synthetic(batch * 4, ByteTokenizer(),
                                        max_length=seq, seed=0)
    host = [next(iter(ds.batches(batch, seed=i))) for i in range(steps + 4)]
    params0 = gpt2_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)

    def fresh():
        return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params0)

    def trainer(use_flash):
        # training.dtype as the example reads it: the model's compute dtype
        return Trainer(tcfg, gpt2_model_spec(cfg, use_flash=use_flash,
                                             compute_dtype=torch.bfloat16),
                       task_type="clm", device=DEVICE, log_fn=lambda m: None)

    flash, plain = trainer(True), trainer(False)
    if flash.optimizer.mu_dtype != torch.bfloat16:
        raise AssertionError(f"adam_mu_dtype bfloat16 gave mu_dtype "
                             f"{flash.optimizer.mu_dtype}")

    # the first global batch: loss and every gradient leaf, flash against
    # plain attention in bf16, same weights; and the loss against f32's
    b0 = flash.device_batch(*host[0])
    p = fresh()
    loss_f, g_f = accumulate_grads(flash.model.loss_fn, p, b0, n_micro)
    loss_p, g_p = accumulate_grads(plain.model.loss_fn, p, b0, n_micro)
    loss_rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    if not loss_rel <= 1e-2:
        raise AssertionError(f"bf16 first-step loss: flash {float(loss_f)} "
                             f"vs plain {float(loss_p)} (rel {loss_rel})")
    f32_rel = abs(float(loss_f) - f32_first_loss) / abs(f32_first_loss)
    if not f32_rel <= 2e-2:
        raise AssertionError(f"bf16 first-step loss {float(loss_f)} vs the "
                             f"f32 phase's {f32_first_loss} (rel {f32_rel})")
    not_f32 = [".".join(k) for k, g in g_f.items()
               if g.dtype != torch.float32]
    if not_f32:
        raise AssertionError(f"gradient leaves not f32: {not_f32}")
    grad_err = {".".join(k): float((g_f[k] - g_p[k]).abs().max()
                                   / g_p[k].abs().max().clamp_min(1e-30))
                for k in g_p}
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= 5e-2:
        raise AssertionError(f"bf16 gradient {worst}: max |flash - plain| / "
                             f"max |plain| = {grad_err[worst]} > 5e-2")
    del p, g_f, g_p

    # main path: counts zeroed just before, read just after
    params = fresh()
    opt_state = flash.optimizer.init(params)
    _zero_counts()
    hist_f = flash.fit(lambda ep: [host[ep]], epochs=steps, params=params,
                       opt_state=opt_state)
    counts = _counts()
    wrappers = _wrappers()
    by_dtype = {name: dict(wrappers[name].launches_by_dtype)
                for name in FLASH_KERNELS}
    if flash_attention.routed:
        raise AssertionError(f"flash_attention routed {flash_attention.routed}"
                             f" bf16 calls to the blockwise attention on the "
                             f"main path; every call must reach the kernels")
    per_kernel = cfg.n_layer * n_micro * steps
    want = {name: {"bf16": per_kernel} for name in FLASH_KERNELS}
    if by_dtype != want or counts["paged_attention"]:
        raise AssertionError(f"launches by dtype {by_dtype} (paged "
                             f"{counts['paged_attention']}); expected {want} "
                             f"(n_layer x micro-batches x steps, no f32)")
    moments = {m: {str(t.dtype) for _, t in tree_leaves(opt_state[m])}
               for m in ("mu", "nu")}
    if moments != {"mu": {"torch.bfloat16"}, "nu": {"torch.float32"}} or any(
            t.dtype != torch.float32 for _, t in tree_leaves(params)):
        raise AssertionError(f"moment dtypes {moments}; want mu bf16, nu and "
                             f"the parameters f32")

    pp = fresh()
    hist_p = plain.fit(lambda ep: [host[ep]], epochs=steps, params=pp,
                       opt_state=plain.optimizer.init(pp))
    del pp
    for i, (a, b) in enumerate(zip(hist_f.train_loss, hist_p.train_loss)):
        if not (np.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
            raise AssertionError(f"bf16 step {i}: loss flash {a} vs plain {b}")

    res = {"phase": "train_bf16",
           "model": "gpt2-124M, bf16 compute from f32 master weights (random "
                    "init, seed 0), Adam mu in bf16",
           "global_batch": batch, "micro_batches": n_micro, "seq_len": seq,
           "steps": steps, "optimizer": "adamw lr 5e-5 wd 0.01 clip 1.0",
           "first_loss_flash": float(loss_f),
           "first_loss_plain": float(loss_p), "first_loss_rel_diff": loss_rel,
           "first_loss_f32": f32_first_loss, "first_loss_rel_to_f32": f32_rel,
           "worst_grad_leaf": worst, "worst_grad_rel_err": grad_err[worst],
           "loss_flash": hist_f.train_loss, "loss_plain": hist_p.train_loss,
           "fit_wall_s_flash": hist_f.wall_time_s,
           "fit_wall_s_plain": hist_p.wall_time_s, "launches": counts,
           "launches_by_dtype": by_dtype, "moment_dtypes": {
               k: sorted(v) for k, v in moments.items()},
           "flash_attention_routed": flash_attention.routed}
    res.update(_train_share(flash, params, opt_state, host[steps:],
                            {k: per_kernel // steps for k in FLASH_KERNELS},
                            symbols=FLASH_SYMBOLS_BF16))
    _emit(res)
    return res, {name: v["bf16"] for name, v in by_dtype.items()}


# ---------------------------------------------------------------------
# phases 4c-4e: Llama-3.2-1B trained on the card
# ---------------------------------------------------------------------

LLAMA_SEQ = 1024
LLAMA_ROWS, LLAMA_MICRO, LLAMA_STEPS = 8, 2, 4
# Llama-3's <|end_of_text|>: the packed phase's document separator
LLAMA_EOS = 128001


def _llama_ids(cfg, rows, seq, seed):
    """[rows, seq] token ids drawn uniformly over the whole vocab from
    ``seed`` (int64), with no separator among them."""
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size - 1,
                                               (rows, seq))
    return np.where(ids >= LLAMA_EOS, ids + 1, ids).astype(np.int64)


def _llama_packed_ids(cfg, rows, seq, seed):
    """Packed rows: documents of 64-400 tokens, each ended by
    ``LLAMA_EOS`` (the layout ``PackedLMDataset`` produces), cut to
    ``seq`` a row."""
    rng = np.random.default_rng(seed)
    ids = _llama_ids(cfg, rows, seq, seed)
    for r in range(rows):
        pos = -1
        while True:
            pos += int(rng.integers(64, 400))
            if pos >= seq:
                break
            ids[r, pos] = LLAMA_EOS
    return ids


def _llama_trainer(cfg, use_flash, dtype=None):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.llama import llama_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    tcfg = Config.from_dict({"training": {
        "batch_size": LLAMA_ROWS, "gradient_accumulation_steps": LLAMA_MICRO,
        "optimizer": "adamw", "learning_rate": 3e-4, "weight_decay": 0.1,
        "lr_schedule": "cosine", "warmup_steps": 2, "decay_steps": 8,
        "grad_clip_norm": 1.0, "log_every": 0, "seed": 0,
        **(TRAIN_BF16 if dtype == torch.bfloat16 else {})}})
    return Trainer(tcfg, llama_model_spec(cfg, use_flash=use_flash,
                                          compute_dtype=dtype),
                   task_type="clm", device=DEVICE, log_fn=lambda m: None)


def _first_batch(flash, plain, params, batch, tols, name):
    """The first global batch's loss and every gradient leaf, flash
    against plain attention from the same weights, held to ``tols``
    (first_loss, grad); returns (flash loss, plain loss, rel diff, worst
    leaf, its error)."""
    from quintnet_tpu_torch.parallel.train_step import accumulate_grads

    loss_f, g_f = accumulate_grads(flash.model.loss_fn, params, batch,
                                   LLAMA_MICRO)
    loss_p, g_p = accumulate_grads(plain.model.loss_fn, params, batch,
                                   LLAMA_MICRO)
    rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    if not rel <= tols["first_loss"]:
        raise AssertionError(f"{name} first-step loss: flash {float(loss_f)}"
                             f" vs plain {float(loss_p)} (rel {rel})")
    not_f32 = [".".join(k) for k, g in g_f.items()
               if g.dtype != torch.float32]
    if not_f32:
        raise AssertionError(f"{name} gradient leaves not f32: {not_f32}")
    err = {".".join(k): float((g_f[k] - g_p[k]).abs().max()
                              / g_p[k].abs().max().clamp_min(1e-30))
           for k in g_p}
    worst = max(err, key=err.get)
    if not err[worst] <= tols["grad"]:
        raise AssertionError(f"{name} gradient {worst}: max |flash - plain| "
                             f"/ max |plain| = {err[worst]} > {tols['grad']}")
    return float(loss_f), float(loss_p), rel, worst, err[worst]


def phase_llama_train(dtype=None, f32_first_loss=None):
    """Llama-3.2-1B (``LlamaConfig.llama32_1b()``: full width, 16 layers,
    1.24 B parameters, f32 masters from seed 0) on rows of 1,024 token
    ids over the whole vocab: the first batch's loss and gradients flash
    against plain attention, then 4 steps of AdamW with a cosine
    schedule each way. The flash run is the main path (counts zeroed just
    before, read just after); ``dtype`` bfloat16 computes in bf16 with a
    bf16 first moment."""
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_init
    from quintnet_tpu_torch.ops.flash_attention import flash_attention

    bf16 = dtype == torch.bfloat16
    name = "llama_train_bf16" if bf16 else "llama_train"
    tol = MESH_TOL_BF16 if bf16 else MESH_TOL
    symbols = FLASH_SYMBOLS_BF16 if bf16 else FLASH_SYMBOLS
    cfg = LlamaConfig.llama32_1b()
    host = [(ids, ids) for ids in (
        _llama_ids(cfg, LLAMA_ROWS, LLAMA_SEQ, i)
        for i in range(LLAMA_STEPS + 4))]
    params0 = llama_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)
    n_params = sum(v.numel() for _, v in tree_leaves(params0))

    def fresh():
        return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params0)

    flash, plain = _llama_trainer(cfg, True, dtype), _llama_trainer(
        cfg, False, dtype)
    p = fresh()
    loss_f, loss_p, rel, worst, worst_err = _first_batch(
        flash, plain, p, flash.device_batch(*host[0]), tol, name)
    del p
    f32_rel = None
    if bf16:
        f32_rel = abs(loss_f - f32_first_loss) / abs(f32_first_loss)
        if not f32_rel <= 2e-2:
            raise AssertionError(f"{name}: first loss {loss_f} vs the f32 "
                                 f"phase's {f32_first_loss} (rel {f32_rel})")
    torch.cuda.empty_cache()

    params = fresh()
    opt_state = flash.optimizer.init(params)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    hist_f = flash.fit(lambda ep: [host[ep]], epochs=LLAMA_STEPS,
                       params=params, opt_state=opt_state)
    counts = _counts()
    peaks = {"flash_fit": torch.cuda.max_memory_allocated() / 2 ** 30}
    by_dtype = _launches_by_dtype()
    routed = flash_attention.routed
    per_kernel = cfg.n_layers * LLAMA_MICRO * LLAMA_STEPS
    want = {k: {"bf16" if bf16 else "f32": per_kernel} for k in FLASH_KERNELS}
    if routed or by_dtype != want or counts["paged_attention"]:
        raise AssertionError(f"{name}: launches {by_dtype} (routed {routed},"
                             f" paged {counts['paged_attention']}); expected "
                             f"{want} (n_layers x micro-batches x steps)")
    pp = fresh()
    torch.cuda.reset_peak_memory_stats()
    hist_p = plain.fit(lambda ep: [host[ep]], epochs=LLAMA_STEPS, params=pp,
                       opt_state=plain.optimizer.init(pp))
    # the plain fit holds the flash run's state beside its own
    peaks["plain_fit_beside_flash_state"] = (
        torch.cuda.max_memory_allocated() / 2 ** 30)
    del pp
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(hist_f.train_loss, hist_p.train_loss)):
        if not (np.isfinite(a) and abs(a - b) <= tol["step_loss"] * abs(b)):
            raise AssertionError(f"{name} step {i}: loss flash {a} vs plain "
                                 f"{b}")
    res = {"phase": name,
           "model": f"Llama-3.2-1B widths, all {cfg.n_layers} layers "
                    f"({n_params} parameters, random init, seed 0)"
                    + (", bf16 compute from f32 masters, Adam mu bf16"
                       if bf16 else ", f32"),
           "global_batch": LLAMA_ROWS, "micro_batches": LLAMA_MICRO,
           "seq_len": LLAMA_SEQ, "steps": LLAMA_STEPS,
           "data": "token ids uniform over the vocab (seed = step)",
           "optimizer": "adamw lr 3e-4 wd 0.1, cosine (2 warmup, 8 decay "
                        "steps), clip 1.0",
           "gates": dict(tol), "first_loss_flash": loss_f,
           "first_loss_plain": loss_p, "first_loss_rel_diff": rel,
           "worst_grad_leaf": worst, "worst_grad_rel_err": worst_err,
           "loss_flash": hist_f.train_loss, "loss_plain": hist_p.train_loss,
           "launches": counts, "launches_by_dtype": by_dtype,
           "flash_attention_routed": routed, "peak_memory_gib_runs": peaks}
    if bf16:
        res.update(first_loss_f32=f32_first_loss,
                   first_loss_rel_to_f32=f32_rel)
    res.update(_train_share(flash, params, opt_state, host[LLAMA_STEPS:],
                            {k: per_kernel // LLAMA_STEPS
                             for k in FLASH_KERNELS}, symbols=symbols))
    res["card"] = _smi()
    _emit(res)
    return res, {k: v["bf16" if bf16 else "f32"] for k, v in by_dtype.items()}


def phase_llama_packed():
    """One flash-vs-plain step of Llama-3.2-1B at full width on packed
    rows (``segment_eos_id`` = ``LLAMA_EOS``, documents of 64-400
    tokens): the kernels' packed-segment path at (4, 32, 1,024), the f32
    gates. Counts zeroed just before the flash step, read just after."""
    import dataclasses

    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.models.gpt2 import segment_ids_from_input
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_init
    from quintnet_tpu_torch.ops.flash_attention import flash_attention

    cfg = dataclasses.replace(LlamaConfig.llama32_1b(),
                              segment_eos_id=LLAMA_EOS)
    ids = _llama_packed_ids(cfg, LLAMA_ROWS, LLAMA_SEQ, 100)
    params = tree_map(lambda p: p.requires_grad_(True), llama_init(
        torch.Generator(device=DEVICE).manual_seed(0), cfg))
    flash, plain = _llama_trainer(cfg, True), _llama_trainer(cfg, False)
    batch = flash.device_batch(ids, ids)
    seg = segment_ids_from_input(batch[0], cfg)
    docs = int((seg.max(dim=1).values + 1).sum())
    _zero_counts()
    loss_f, loss_p, rel, worst, worst_err = _first_batch(
        flash, plain, params, batch, MESH_TOL, "llama_packed")
    by_dtype = _launches_by_dtype()
    routed = flash_attention.routed
    want = {k: {"f32": cfg.n_layers * LLAMA_MICRO} for k in FLASH_KERNELS}
    if routed or by_dtype != want:
        raise AssertionError(f"llama_packed: launches {by_dtype} (routed "
                             f"{routed}); expected {want}")
    dense = dataclasses.replace(cfg, segment_eos_id=None)
    with torch.no_grad():
        cross = float(_llama_trainer(dense, True).model.loss_fn(
            params, (batch[0][:LLAMA_ROWS // LLAMA_MICRO],
                     batch[1][:LLAMA_ROWS // LLAMA_MICRO])))
    res = {"phase": "llama_packed",
           "model": f"Llama-3.2-1B widths, all {cfg.n_layers} layers, f32 "
                    f"(seed 0), segment_eos_id {LLAMA_EOS}",
           "rows": LLAMA_ROWS, "micro_batches": LLAMA_MICRO,
           "seq_len": LLAMA_SEQ, "documents": docs,
           "gates": {k: MESH_TOL[k] for k in ("first_loss", "grad")},
           "first_loss_flash": loss_f, "first_loss_plain": loss_p,
           "first_loss_rel_diff": rel, "worst_grad_leaf": worst,
           "worst_grad_rel_err": worst_err,
           "first_micro_batch_loss_without_isolation": cross,
           "launches_by_dtype": by_dtype, "flash_attention_routed": routed,
           "card": _smi()}
    _emit(res)
    del params
    return res, {k: v["f32"] for k, v in by_dtype.items()}


# ---------------------------------------------------------------------
# phase 5: the reference ViT trained on the card
# ---------------------------------------------------------------------

# examples/config.yaml's model and training blocks (its 2 x 2 x 2 mesh
# forced to one device: the global batch and its 2 micro-batches stay)
VIT_CONFIG = {
    "model": {"name": "vit", "image_size": 28, "patch_size": 7,
              "in_channels": 1, "hidden_dim": 64, "depth": 8,
              "num_heads": 4, "num_classes": 10},
    "training": {"batch_size": 32, "gradient_accumulation_steps": 2,
                 "epochs": 1, "learning_rate": 3e-4, "optimizer": "adam",
                 "grad_clip_norm": 1.0, "log_every": 0, "seed": 0},
}
VIT_TRAIN, VIT_VAL = 8192, 2048
VIT_ATOL, VIT_RTOL = 1e-5, 1e-4


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _recording(trainer):
    """Make ``trainer.step_fn`` keep each step's loss (a device
    scalar); returns the list it appends to."""
    losses, step_fn = [], trainer.step_fn

    def step(*args, **kwargs):
        params, opt_state, loss = step_fn(*args, **kwargs)
        losses.append(loss)
        return params, opt_state, loss

    trainer.step_fn = step
    return losses


def _worst(got, want, atol, rtol):
    """(max |got - want| - (atol + rtol |want|), max |got - want|)."""
    d = (got - want).abs()
    return (float((d - atol - rtol * want.abs()).max()), float(d.max()))


def _step_share(trainer, params, opt_state, batches) -> dict:
    """The step's wall time with no profiler, samples/s, peak memory, and
    the device's busy time and idle share under ``torch.profiler``."""
    wall, peak, by_name, n = _timed_then_profiled(trainer, params, opt_state,
                                                  batches)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / n
    out = {"steps_timed": len(batches) - n, "step_ms": wall * 1e3,
           "samples_per_s": len(batches[0][0]) / wall,
           "peak_memory_mib": peak / 2 ** 20, "steps_profiled": n}
    if busy_ms <= 0:
        out["device_idle_share"] = ("not measured (profiler reported no "
                                    "device time)")
        return out
    out.update({"device_busy_ms_per_step": busy_ms,
                "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
                "device_ops_per_step": sum(k for _, k in by_name.values())
                / n})
    return out


def phase_vit():
    import itertools
    import tempfile

    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.data import (ArrayDataset, make_batches,
                                         synthetic_mnist)
    from quintnet_tpu_torch.models.vit import (ViTConfig, vit_apply,
                                               vit_init, vit_model_spec)
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.parallel.train_step import accumulate_grads
    from quintnet_tpu_torch.tools.verify_vit import verify_vit
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = Config.from_dict(VIT_CONFIG)
    vcfg = ViTConfig.from_model_config(cfg.model)
    spec = vit_model_spec(vcfg)
    bs = cfg.training.batch_size
    n_micro = cfg.training.gradient_accumulation_steps
    train = ArrayDataset(*synthetic_mnist(VIT_TRAIN, seed=0))
    val = ArrayDataset(*synthetic_mnist(VIT_VAL, seed=1))
    params0 = vit_init(torch.Generator(device=DEVICE).manual_seed(0), vcfg)

    def fresh(dev=DEVICE):
        return tree_map(lambda p: p.detach().to(dev).clone()
                        .requires_grad_(True), params0)

    # the first batch on the card against the CPU, same weights
    xb, yb = next(make_batches(train, bs, seed=0))
    out = {}
    for dev in ("cpu", DEVICE):
        p = fresh(dev)
        x, y = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).long().to(
            dev)
        with torch.no_grad():
            logits = vit_apply(p, x, vcfg)
        loss, grads = accumulate_grads(spec.loss_fn, p, (x, y), n_micro)
        out[dev] = (logits.cpu(), loss.detach().cpu(),
                    {k: g.cpu() for k, g in grads.items()})
    (lc, sc, gc), (lg, sg, gg) = out["cpu"], out[DEVICE]
    logit_err = float((lg - lc).abs().max())
    loss_err = float((sg - sc).abs())
    if not (logit_err <= VIT_ATOL and loss_err <= VIT_ATOL):
        raise AssertionError(f"vit card vs CPU: logits {logit_err}, loss "
                             f"{loss_err} > {VIT_ATOL}")
    grad_err = {".".join(k): _worst(gg[k], gc[k], VIT_ATOL, VIT_RTOL)
                for k in gc}
    worst = max(grad_err, key=lambda k: grad_err[k][0])
    if grad_err[worst][0] > 0:
        raise AssertionError(f"vit gradient {worst}: max |card - cpu| = "
                             f"{grad_err[worst][1]} beyond atol {VIT_ATOL}, "
                             f"rtol {VIT_RTOL}")
    del out, gc, gg

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "vit")
        trainer = Trainer(cfg, spec, task_type="classification",
                          checkpoint_dir=ck, device=DEVICE,
                          log_fn=lambda m: None)
        losses = _recording(trainer)
        params = fresh()
        opt_state = trainer.optimizer.init(params)
        # main path: counts zeroed just before, read just after
        _zero_counts()
        hist = trainer.fit(
            lambda ep, start=0: make_batches(train, bs, seed=ep,
                                             start_batch=start),
            val_batches_fn=lambda ep: make_batches(val, bs, shuffle=False),
            params=params, opt_state=opt_state)
        counts = _counts()
        if any(counts.values()) or flash_attention.routed:
            raise AssertionError(f"the ViT path launched kernels {counts} "
                                 f"(routed {flash_attention.routed}); its "
                                 f"attention is plain dense attention")
        steps = len(losses)
        vals = torch.stack(losses).tolist()
        first, last = np.mean(vals[:20]), np.mean(vals[-20:])
        acc = hist.val_metric[-1]
        if not (np.isfinite(vals).all() and last < first):
            raise AssertionError(f"vit loss did not fall: first 20 steps "
                                 f"{first}, last 20 {last}")
        if not acc > 0.1:
            raise AssertionError(f"vit val accuracy {acc} is not above "
                                 f"chance (0.1)")
        mgr = CheckpointManager(ck)
        ver = verify_vit(ck, vcfg, data=(val.x, val.y), batch_size=bs,
                         device=DEVICE)
        if ver["accuracy"] != acc:
            raise AssertionError(f"verify_vit accuracy {ver['accuracy']} != "
                                 f"the trainer's {acc}")
        ckpt = {"steps": mgr.all_steps(), "bytes": mgr.step_bytes()}
    # the step's time and the device's share, at the trained state
    timing = list(itertools.islice(make_batches(train, bs, seed=1), 40))
    res = {"phase": "vit",
           "model": "vit full width (examples/config.yaml; random init, "
                    "seed 0)",
           "data": f"synthetic_mnist({VIT_TRAIN}) train, "
                   f"synthetic_mnist({VIT_VAL}, seed=1) val (not MNIST)",
           "global_batch": bs, "micro_batches": n_micro,
           "optimizer": "adam lr 3e-4 clip 1.0",
           "first_batch": {"logits_max_abs_err": logit_err,
                           "loss_abs_err": loss_err,
                           "worst_grad_leaf": worst,
                           "worst_grad_max_abs_err": grad_err[worst][1]},
           "steps": steps, "loss_first20": float(first),
           "loss_last20": float(last),
           "train_loss_epoch": hist.train_loss[-1],
           "val_loss": hist.val_loss[-1], "val_accuracy_synthetic": acc,
           "verify_vit_accuracy": ver["accuracy"],
           "fit_wall_s": hist.wall_time_s,
           "fit_samples_per_s": steps * bs / hist.wall_time_s,
           "checkpoint": ckpt, "launches": counts, "card": _smi()}
    res.update(_step_share(trainer, *trainer.final_state, timing))
    _emit(res)
    return res


# ---------------------------------------------------------------------
# phase 6: GPT-2 124M cut, restored and continued, bit for bit
# ---------------------------------------------------------------------

class _Cut(Exception):
    """Raised by the data to cut a run between two steps."""


def _state_differs(a, b):
    """The leaves of two ``(params, opt_state)`` that are not bit-equal
    (parameters, both Adam moments), and the step counts."""
    from quintnet_tpu_torch.core.pytree import tree_leaves

    (pa, oa), (pb, ob) = a, b
    ref_p = dict(tree_leaves(pb))
    differ = [".".join(k) for k, v in tree_leaves(pa)
              if not torch.equal(v, ref_p[k])]
    for m in ("mu", "nu"):
        ref_m = dict(tree_leaves(ob[m]))
        differ += [f"{m}.{'.'.join(k)}" for k, v in tree_leaves(oa[m])
                   if not torch.equal(v, ref_m[k])]
    return differ, (oa["count"], ob["count"])


def _check_launches_exact(counts, want, what):
    from quintnet_tpu_torch.ops.flash_attention import flash_attention

    if flash_attention.routed:
        raise AssertionError(f"{what}: flash_attention routed "
                             f"{flash_attention.routed} calls away from the "
                             f"kernels")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}; expected {want}")


def phase_resume(cfg=None, *, seq=512, batch=64):
    """``cfg`` (GPT-2 124M by default), ``seq`` and ``batch``: the CPU
    rehearsal in ``tests/test_torch_chip_smoke.py`` runs the phase's own
    code at a tiny size."""
    import tempfile

    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                                gpt2_model_spec)
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = cfg or GPT2Config.base()   # every dropout rate 0
    steps, n_micro, cut = 4, 2, 2
    training = {
        "batch_size": batch, "gradient_accumulation_steps": n_micro,
        "optimizer": "adamw", "learning_rate": 5e-5, "weight_decay": 0.01,
        "grad_clip_norm": 1.0, "log_every": 0, "seed": 0,
        "save_every_steps": cut}
    tcfg = Config.from_dict({"training": training})
    # the preempted run saves on no cadence: the one step on disk when it
    # stops is its emergency snapshot
    ft_cfg = Config.from_dict({"training": {**training,
                                            "save_every_steps": 0}})
    ds = SummarizationDataset.synthetic(batch * 4, ByteTokenizer(),
                                        max_length=seq, seed=0)
    host = [next(iter(ds.batches(batch, seed=i))) for i in range(steps)]
    spec = gpt2_model_spec(cfg, use_flash=True)

    def data(ep, start=0):           # one epoch of 4 batches
        return iter(host[start:])

    def cut_data(ep, start=0):
        yield from host[:cut]
        raise _Cut

    def trainer(ckpt=None, config=tcfg):
        return Trainer(config, spec, task_type="clm", checkpoint_dir=ckpt,
                       device=DEVICE, log_fn=lambda m: None)

    params0 = gpt2_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)

    def fresh():
        return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params0)

    per_kernel = cfg.n_layer * n_micro       # launches of each a step
    seconds = {}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    torch.use_deterministic_algorithms(True)
    try:
        t_part = time.perf_counter()
        # main path: counts zeroed just before, read just after
        _zero_counts()
        ref = trainer()
        ref_losses = _recording(ref)
        p = fresh()
        hist_ref = ref.fit(data, epochs=1, params=p,
                           opt_state=ref.optimizer.init(p))
        ck = os.path.join(tmp, "gpt2")
        save_s = []

        def timed_saves(tr):
            save_state = tr.save_state

            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = save_state(*a, **kw)
                save_s.append(time.perf_counter() - t0)
                return out

            tr.save_state = timed

        first = trainer(ck)
        first_losses = _recording(first)
        timed_saves(first)
        p = fresh()
        try:
            first.fit(cut_data, epochs=1, params=p,
                      opt_state=first.optimizer.init(p))
            raise AssertionError("the cut run was not cut")
        except _Cut:
            pass
        del first, p
        mgr = CheckpointManager(ck)
        if mgr.all_steps() != [cut]:
            raise AssertionError(f"checkpoints {mgr.all_steps()} after "
                                 f"the cut; expected [{cut}]")
        ckpt_bytes = mgr.step_bytes(cut)
        second = trainer(ck)
        _sync()
        t0 = time.perf_counter()
        params, opt_state, cursor = second.resume_state()
        _sync()
        restore_s = time.perf_counter() - t0
        if (cursor.epoch, cursor.step_in_epoch,
                cursor.global_step) != (0, cut, cut):
            raise AssertionError(f"restored cursor {cursor}")
        second_losses = _recording(second)
        timed_saves(second)
        hist = second.fit(data, epochs=1, params=params,
                          opt_state=opt_state, cursor=cursor)
        counts = _counts()
        run = steps + cut + (steps - cut)
        _check_launches_exact(counts, {
            "flash_fwd": per_kernel * run, "flash_bwd_dkv": per_kernel * run,
            "flash_bwd_dq": per_kernel * run, "paged_attention": 0},
            f"cut and resume (n_layer x micro-batches x the {run} steps "
            f"run)")
        seconds["cut_resume"] = time.perf_counter() - t_part
        # a real SIGTERM: the preempted run and its resume, counts zeroed
        # just before, read just after
        t_part = time.perf_counter()
        ft_dir = os.path.join(tmp, "gpt2-ft")
        ft = _preempted_and_resumed(
            lambda: trainer(ft_dir, ft_cfg), data, fresh, cut)
        _check_launches_exact(ft["launches"], {
            "flash_fwd": per_kernel * steps,
            "flash_bwd_dkv": per_kernel * steps,
            "flash_bwd_dq": per_kernel * steps, "paged_attention": 0},
            f"preempted and resumed (n_layer x micro-batches x the {steps} "
            f"steps of the two attempts)")
        seconds["preempt_resume"] = time.perf_counter() - t_part
    finally:
        torch.use_deterministic_algorithms(False)
    try:
        losses = first_losses + second_losses
        if not all(torch.equal(a, b) for a, b in zip(losses, ref_losses)) \
                or len(losses) != steps:
            raise AssertionError(
                f"step losses: uncut {[float(v) for v in ref_losses]}, cut "
                f"and resumed {[float(v) for v in losses]}")
        for name, got, h in (("cut", second, hist),
                             ("preempted", ft["trainer"], ft["hist"])):
            if h.train_loss != hist_ref.train_loss:
                raise AssertionError(f"{name}: epoch loss {h.train_loss} != "
                                     f"uncut {hist_ref.train_loss}")
            differ, (c_got, c_ref) = _state_differs(got.final_state,
                                                    ref.final_state)
            if differ or c_got != c_ref:
                raise AssertionError(
                    f"{name}: after resume, not bit-identical to the uncut "
                    f"run: {differ[:8]} (count {c_got} vs {c_ref})")
        final_params = ft["trainer"].final_state[0]
        n_leaves = len(list(tree_leaves(final_params)))
        t_part = time.perf_counter()
        hf = _export_and_reload(ft_dir, final_params, tmp, cfg)
        seconds["export_reload"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        ppl = _perplexity(hf["path"], cfg)
        seconds["perplexity"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        fallback = _fallback(lambda: trainer(ft_dir, ft_cfg), ft_dir, cut,
                             steps)
        seconds["fallback"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        supervisor = _supervisor_on_card(tmp)
        seconds["supervisor"] = time.perf_counter() - t_part
    finally:
        tmp_dir.cleanup()
    res = {"phase": "resume",
           "model": "gpt2-124M f32 (random init, seed 0), flash attention",
           "global_batch": batch, "micro_batches": n_micro, "seq_len": seq,
           "steps_uncut": steps, "cut_after_step": cut,
           "deterministic_algorithms": True,
           "cublas_workspace_config": os.environ["CUBLAS_WORKSPACE_CONFIG"],
           "losses": [float(v) for v in ref_losses],
           "bit_identical": {"param_leaves": n_leaves,
                             "adam_moment_leaves": 2 * n_leaves,
                             "step_losses": steps, "epoch_loss": True,
                             "runs": ["cut", "preempted"]},
           "launches": counts,
           # save_s: the cut run's step-2 save, then the resumed run's
           # step-4 cadence save and its epoch-end rewrite
           "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
           "restore_s": restore_s,
           "preempted": {k: v for k, v in ft.items()
                         if k not in ("trainer", "hist")},
           "hf_export": hf, "perplexity": ppl, "fallback": fallback,
           "supervisor": supervisor, "seconds": seconds, "card": _smi()}
    _emit(res)
    # the kernels line counts every launch of the phase's main paths
    total = {k: counts[k] + ft["launches"][k] + ppl["launches"][k]
             for k in counts}
    return res, total


def _preempted_and_resumed(make_trainer, data, fresh, stop):
    """The preemption on the card: ``fit(ft=FTContext(...))`` with a
    ``PreemptionHandler`` entered in this (the main) thread, a
    ``ChaosMonkey`` that sends this process a real SIGTERM after global
    step ``stop``, and a ``GoodputMeter``; the run must raise
    ``TrainingPreempted`` at that step with only its emergency snapshot
    on disk. A fresh trainer with a fresh handler then resumes. Returns
    the stop, the goodput reports and their ``aggregate``, the
    emergency save's and the restore's seconds, the launch counts of
    both attempts, and the resumed trainer and History."""
    from quintnet_tpu_torch.ft import (ChaosMonkey, FTContext, GoodputMeter,
                                       PreemptionHandler, TrainingPreempted)
    from quintnet_tpu_torch.ft.goodput import aggregate
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager

    t_run = time.perf_counter()
    _zero_counts()
    meters = [GoodputMeter()]        # one a process attempt, from its start
    first = make_trainer()
    p = fresh()
    with PreemptionHandler() as handler:
        try:
            first.fit(data, epochs=1, params=p,
                      opt_state=first.optimizer.init(p),
                      ft=FTContext(preemption=handler,
                                   chaos=ChaosMonkey(kill_at_step=stop,
                                                     mode="sigterm"),
                                   goodput=meters[0]))
            raise AssertionError("the SIGTERM did not preempt the run")
        except TrainingPreempted as e:
            stopped = [e.epoch, e.step_in_epoch, e.global_step]
        signalled = handler.triggered
    reports = [meters[0].report(completed=False)]
    mgr = CheckpointManager(first.checkpoint_dir)
    on_disk = mgr.all_steps()
    if not signalled or stopped != [0, stop, stop] or on_disk != [stop]:
        raise AssertionError(
            f"preemption: signalled {signalled}, stopped at {stopped} "
            f"(want [0, {stop}, {stop}]), steps on disk {on_disk} "
            f"(want [{stop}]: the emergency snapshot)")
    snapshot_bytes = mgr.step_bytes(stop)
    del first, p
    meters.append(GoodputMeter())
    second = make_trainer()
    with PreemptionHandler() as handler:
        hist = second.fit(data, epochs=1,
                          ft=FTContext(preemption=handler,
                                       goodput=meters[1]))
    reports.append(meters[1].report(completed=True))
    launches = _counts()
    wall = time.perf_counter() - t_run
    agg = aggregate(reports, wall_s=wall)
    for rep in reports:
        print(json.dumps({"ft_attempt": rep}), flush=True)
    print(json.dumps({"ft_aggregate": agg}), flush=True)
    return {"stopped_at": stopped, "steps_on_disk": on_disk,
            "emergency_save_s": reports[0]["save_blocking_s"],
            "emergency_bytes": snapshot_bytes,
            "restore_s": reports[1]["restore_s"],
            "goodput_reports": reports, "goodput_aggregate": agg,
            "wall_s": wall, "launches": launches, "trainer": second,
            "hist": hist}


def _export_and_reload(ckpt_dir, final_params, tmp, cfg):
    """``tools/export_gpt2``'s ``main`` on the preempted run's directory
    (its newest step, the run's end; ``cfg``'s sizes), then
    ``load_hf_gpt2`` onto the card: every leaf bit-equal to the
    trainer's final parameters."""
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.models.gpt2_io import load_hf_gpt2
    from quintnet_tpu_torch.tools import export_gpt2

    path = os.path.join(tmp, "gpt2-124m-hf.safetensors")
    t0 = time.perf_counter()
    step = export_gpt2.main([
        "--checkpoint-dir", ckpt_dir, "--out", path,
        "--n-layer", str(cfg.n_layer), "--n-embd", str(cfg.n_embd),
        "--n-head", str(cfg.n_head), "--vocab-size", str(cfg.vocab_size),
        "--n-positions", str(cfg.n_positions)])
    export_s = time.perf_counter() - t0
    _sync()
    t0 = time.perf_counter()
    params, _cfg = load_hf_gpt2(path, device=DEVICE)
    _sync()
    load_s = time.perf_counter() - t0
    want = dict(tree_leaves(final_params))
    got = dict(tree_leaves(params))
    differ = sorted(".".join(k) for k in want
                    if k not in got or not torch.equal(got[k], want[k]))
    if differ or got.keys() != want.keys():
        raise AssertionError(f"exported and reloaded params differ from the "
                             f"trainer's: {differ[:8]}")
    return {"path": path, "step": step, "bytes": os.path.getsize(path),
            "export_s": export_s, "load_s": load_s,
            "leaves_bit_equal": len(want)}


PPL_TEXT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "README.md")
PPL_SEQ, PPL_BATCH = 1024, 8
PPL_RTOL = 1e-4           # the flash path's loss against the plain one's


def _perplexity(path, cfg):
    """``tools/eval_ppl``'s evaluation of the exported checkpoint over this
    repo's README.md (byte tokenizer, windows of 1,024) through the flash
    dispatcher, counts zeroed just before and read just after: K1 once a
    layer a batch, nothing else; then the same through the plain
    attention: the loss within ``PPL_RTOL`` relative."""
    import math

    from quintnet_tpu_torch.tools import eval_ppl

    text = PPL_TEXT
    _zero_counts()
    flash = eval_ppl.evaluate(text, checkpoint=path, seq=PPL_SEQ,
                              batch=PPL_BATCH, device=DEVICE)
    launches = _counts()
    batches = math.ceil(flash["windows"] / PPL_BATCH)
    _check_launches_exact(launches, {
        "flash_fwd": cfg.n_layer * batches, "flash_bwd_dkv": 0,
        "flash_bwd_dq": 0, "paged_attention": 0},
        f"eval_ppl (K1 once a layer for each of the {batches} batches)")
    plain = eval_ppl.evaluate(text, checkpoint=path, seq=PPL_SEQ,
                              batch=PPL_BATCH, device=DEVICE,
                              use_flash=False)
    rel = abs(flash["loss"] - plain["loss"]) / abs(plain["loss"])
    if not (math.isfinite(flash["loss"]) and rel <= PPL_RTOL):
        raise AssertionError(f"eval_ppl: flash loss {flash['loss']} vs plain "
                             f"{plain['loss']} (rel {rel} > {PPL_RTOL})")
    return {"text": os.path.basename(text), "seq": PPL_SEQ,
            "batch": PPL_BATCH,
            "windows": flash["windows"], "real_tokens": flash["real_tokens"],
            "loss": flash["loss"], "perplexity": flash["perplexity"],
            "seconds": flash["seconds"], "plain_loss": plain["loss"],
            "plain_seconds": plain["seconds"], "rel_diff": rel,
            "launches": launches}


def _fallback(make_trainer, ckpt_dir, good, newest):
    """The newest step of the preempted run's directory corrupted
    (``corrupt_checkpoint``): ``resume_state`` walks back to the older
    good step, the chaos hook called once for each attempt; then one
    restore failure injected through ``ChaosMonkey(fail_restores=1)``
    and the hook: again the older step."""
    from quintnet_tpu_torch.ft import (ChaosMonkey, GoodputMeter,
                                       corrupt_checkpoint)

    corrupt_checkpoint(ckpt_dir, newest, kind="truncate")
    out = {}
    for name, fail in (("corrupt", 0), ("injected", 1)):
        chaos = ChaosMonkey(fail_restores=fail)
        calls = []
        attempt = chaos.on_restore_attempt

        def hook(step, attempt=attempt, calls=calls):
            calls.append(step)
            attempt(step)

        chaos.on_restore_attempt = hook
        meter = GoodputMeter()
        tr = make_trainer()
        _sync()
        t0 = time.perf_counter()
        _p, _o, cursor = tr.resume_state(chaos=chaos, goodput=meter)
        _sync()
        wall = time.perf_counter() - t0
        if (cursor.global_step != good or calls != [newest, good]
                or chaos.restore_failures_injected != fail
                or meter.fallback_steps != 1):
            raise AssertionError(
                f"fallback ({name}): resumed at {cursor.global_step} (want "
                f"{good}), hook calls {calls} (want [{newest}, {good}]), "
                f"{chaos.restore_failures_injected} injected (want {fail}), "
                f"{meter.fallback_steps} skipped (want 1)")
        out[name] = {"resumed_at": cursor.global_step, "hook_calls": calls,
                     "restore_s": wall}
        del tr, _p, _o
    return out


FT_RUN_ARGS = ("--epochs", "2", "--samples", "32", "--batch-size", "16",
               "--save-every", "1", "--kill-at", "3", "--kill-mode",
               "sigterm")


def _supervisor_on_card(tmp):
    """``python -m quintnet_tpu_torch.tools.ft_run --device cuda`` at the
    JAX tool's smoke size: the child is preempted by a SIGTERM after
    step 3, relaunched, and completes (the tiny ViT runs no kernel: this
    proves the relaunch loop on the card)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "quintnet_tpu_torch.tools.ft_run",
           "--device", DEVICE, "--run-dir", os.path.join(tmp, "ft_run"),
           *FT_RUN_ARGS]
    env = {k: v for k, v in os.environ.items() if k != "QT_CHAOS"}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    try:
        rec = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        rec = None
    if (out.returncode != 0 or rec is None
            or rec.get("metric") != "ft_goodput"
            or rec["extras"]["faults_survived"] != 1
            or rec["extras"]["completed"] is not True):
        raise AssertionError(f"ft_run on the card: rc {out.returncode}, "
                             f"record {rec}\n{out.stdout[-2000:]}"
                             f"{out.stderr[-2000:]}")
    return {"command": " ".join(cmd[1:]), "rc": out.returncode,
            "wall_s": wall, "record": rec}


# ---------------------------------------------------------------------
# phase 7: GPT-2 124M on dp, tp and dp x tp meshes, the ranks on one card
# ---------------------------------------------------------------------

# name -> (mesh dims, mesh names, micro-batches a rank, global rows[,
# pipeline schedule, optimizer[, options]]); on a pp mesh the
# micro-batches are the pipeline's (training.gradient_accumulation_steps).
# Options (``_run_opts``): "model" (MESH_MODELS: the run's model, GPT-2
# 124M by default), "layers" (GPT-2 cut to that depth: the script's time
# limit), "time_deterministic" (steps timed with deterministic mode on
# and off in turns), "fsdp" (training.fsdp: ZeRO-3 over dp),
# "dtype" ("bfloat16": bf16 compute from f32 masters, Adam mu in bf16),
# "save" (checkpoint every step into the phase's work directory: the
# uncut run of the resume check), "resume" (a fresh world restores the
# named run's step 1 and takes step 2), "sp_mode" (on an sp mesh: "ring",
# "zigzag" or "ulysses"; only Ulysses runs the flash kernels), "vp" (the
# model's ``vocab_parallel``: its table's rows sharded over tp),
# "pad_vocab" (the table padded to that many rows; the reference is the
# single rank with the same padded table), "generate" (after training,
# ``gpt2_generate_tp`` that many greedy tokens from the vocab-sharded
# parameters, held to one device's ``gpt2_generate``)
MESH_RUNS = {
    # GPT-2 124M widths cut to 2 layers (4 in slices 19-20, 12 before):
    # the script's 1,200 s, with the process fleet's phase beside them
    # since slice 21 (ROADMAP.md, "Two budgets")
    "dp2": ([2], ["dp"], 1, 64, "afab", "adamw", {"layers": 2}),
    "tp2": ([2], ["tp"], 2, 64, "afab", "adamw", {"layers": 2}),
    "dp2tp2": ([2, 2], ["dp", "tp"], 2, 16, "afab", "adamw", {"layers": 2}),
    "fsdp_dp2": ([2], ["dp"], 1, 64, "afab", "adamw",
                 {"fsdp": True, "layers": 2}),
    "fsdp_dp2tp2": ([2, 2], ["dp", "tp"], 2, 16, "afab", "adamw",
                    {"fsdp": True, "layers": 2}),
    "pp2_afab": ([2], ["pp"], 4, 16, "afab", "adamw", {"layers": 2}),
    "dp2pp2_stored_zero2": ([2, 2], ["dp", "pp"], 4, 16, "1f1b_stored",
                            "zero2_adamw", {"layers": 2}),
    "3d_1f1b_zero1": ([2, 2, 2], ["dp", "tp", "pp"], 4, 16, "1f1b",
                      "zero1_adamw", {"save": True, "layers": 2}),
    "3d_ckpt_resume": ([2, 2, 2], ["dp", "tp", "pp"], 4, 16, "1f1b",
                       "zero1_adamw", {"resume": "3d_1f1b_zero1",
                                       "layers": 2}),
    "3d_bf16": ([2, 2, 2], ["dp", "tp", "pp"], 4, 16, "1f1b", "zero1_adamw",
                {"dtype": "bfloat16", "layers": 2}),
    # Llama-3.2-1B widths cut to 2 layers (4 before slice 19), rows of
    # 1,024
    "llama_tp2": ([2], ["tp"], 2, 8, "afab", "adamw", {"model": "llama"}),
    "llama_fsdp_dp2": ([2], ["dp"], 1, 8, "afab", "adamw",
                       {"model": "llama", "fsdp": True}),
    "llama_moe_ep2": ([2], ["ep"], 1, 4, "afab", "adamw",
                      {"model": "llama_moe", "time_deterministic": True}),
    "llama_dp2pp2_1f1b_zero1": ([2, 2], ["dp", "pp"], 2, 8, "1f1b",
                                "zero1_adamw", {"model": "llama"}),
    # GPT-2 124M, 8 mlp experts a block, top-2; cut to 6 layers since
    # the serving mesh runs joined the mesh phase, to 4 since slice 19,
    # to 2 since slice 21 (the script's 1,200 s: ROADMAP.md, "Two
    # budgets")
    "gpt2_moe_ep2tp2": ([2, 2], ["ep", "tp"], 1, 8, "afab", "adamw",
                        {"model": "gpt2_moe", "layers": 2}),
    # sequence parallel: GPT-2 124M widths at its 1,024 positions, 512 a
    # rank, in each mode, cut to 6 layers in slice 19 and to 4 since
    # slice 21 (the script's 1,200 s: ROADMAP.md, "Two budgets");
    # Llama-3.2-1B widths (2 layers) by Ulysses
    "sp2_ring": ([2], ["sp"], 2, 8, "afab", "adamw",
                 {"model": "gpt2_1k", "sp_mode": "ring", "layers": 4}),
    "sp2_zigzag": ([2], ["sp"], 2, 8, "afab", "adamw",
                   {"model": "gpt2_1k", "sp_mode": "zigzag", "layers": 4}),
    "sp2_ulysses": ([2], ["sp"], 2, 8, "afab", "adamw",
                    {"model": "gpt2_1k", "sp_mode": "ulysses", "layers": 4}),
    "llama_sp2_ulysses": ([2], ["sp"], 2, 8, "afab", "adamw",
                          {"model": "llama", "sp_mode": "ulysses"}),
    # vocab parallel: GPT-2 124M widths (4 layers since slice 21, 6 in
    # slices 19-20: the script's 1,200 s, ROADMAP.md "Two budgets"), its
    # table padded 50,257 -> 50,304 rows (25,152 a rank), then 16 greedy
    # tokens by gpt2_generate_tp; Llama-3.2-1B widths at 2 layers (128,256
    # rows, 64,128 a rank); GPT-2 at 4 layers on tp x sp by Ulysses
    # (clm_loss_vp with the sp shift)
    "vp_tp2": ([2], ["tp"], 2, 16, "afab", "adamw",
               {"vp": True, "pad_vocab": 50304, "generate": 16,
                "layers": 4}),
    "llama_vp_tp2": ([2], ["tp"], 2, 8, "afab", "adamw",
                     {"model": "llama", "vp": True}),
    "vp_tp2_sp2": ([2, 2], ["tp", "sp"], 2, 8, "afab", "adamw",
                   {"vp": True, "pad_vocab": 50304, "layers": 4,
                    "sp_mode": "ulysses"}),
}
# model -> (what it is, its sequence length); built by _run_model
MESH_MODELS = {
    "gpt2": ("gpt2-124M", 512),
    "gpt2_1k": ("gpt2-124M at its 1,024 positions", 1024),
    "gpt2_moe": ("gpt2-124M with 8 mlp experts a block, top-2", 512),
    "llama": ("Llama-3.2-1B widths cut to 2 layers", 1024),
    "llama_moe": ("Llama-3.2-1B widths cut to 2 layers, 8 SwiGLU experts "
                  "a block, top-2 (Mixtral's routing)", 1024),
}
# a flipped routing decision (flash vs plain, or across the mesh) is
# allowed only where its two router probabilities are this close: the
# serve phase's near-tie rule applied to the router
ROUTE_TIE = 1e-5
# the parts of a single-rank reference a mesh run may read (_ref_needs)
REF_PARTS = ("grads", "params", "mu", "nu")
MESH_STEPS = 2
# NCCL refuses two ranks of one communicator on one card: the ranks share
# the card over gloo, which stages every collective through host memory
MESH_BACKEND = "gloo"
MESH_TIMEOUT_S = 900             # one world, spawn to its last run's result
MESH_TOL = {"first_loss": 1e-5, "grad": 1e-3, "step_loss": 1e-4}
# bf16 mesh runs: the train_bf16 phase's gates (bf16 compute on both
# sides, rounded at every op), the moment chunks at the gradients' gate
MESH_TOL_BF16 = {"first_loss": 1e-2, "grad": 5e-2, "step_loss": 1e-2}
# the collectives tried on CUDA tensors over gloo (point-to-point is not:
# gloo would be handed a device pointer); "shift" is the pipeline's
# shift and "ppermute" a permutation with an idle sender (zigzag's
# relayout), both an all_to_all_single on gloo CUDA tensors whose split
# sizes are zero except toward the destination (core/collectives.py);
# "all_to_all_ulysses" is the sp2_ulysses run's q/k/v exchange at its
# shape (PROBE_ULYSSES), timed
PROBED = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
          "all_to_all", "shift", "ppermute", "all_to_all_ulysses",
          "all_reduce_bf16", "all_gather_bf16", "reduce_scatter_bf16")
# the probed collectives the mesh runs need: a failure stops the phase
# (bf16: tp's activation sums of the 3d_bf16 run)
PROBE_GATED = ("all_reduce", "all_gather", "reduce_scatter", "shift",
               "ppermute", "all_to_all_ulysses", "all_reduce_bf16",
               "all_to_all")
# q, k, v stacked [3, B, H, S / sp, D] of an sp2_ulysses micro-batch
PROBE_ULYSSES = (3, 4, 12, 512, 64)


def _run_parts(run):
    """(mesh dims, names, micro-batches a rank, rows, schedule,
    optimizer) of a MESH_RUNS entry."""
    mesh_dim, mesh_name, n_micro, rows, *rest = run
    schedule, optimizer = rest[:2] or ("afab", "adamw")
    return mesh_dim, mesh_name, n_micro, rows, schedule, optimizer


def _run_opts(run) -> dict:
    """The options of a MESH_RUNS entry (see there)."""
    return run[6] if len(run) > 6 else {}


def _run_training(run) -> dict:
    """The config's training keys a run's options set."""
    opts = _run_opts(run)
    out = {}
    if opts.get("fsdp"):
        out["fsdp"] = True
    if opts.get("dtype") == "bfloat16":
        out.update(TRAIN_BF16)
    return out


def _ref_micro(run):
    """The single-rank reference's micro-batches for a run: each batch
    rank's micro-batches times the ranks over the batch axes, dp and ep
    (the mean of each rank's mean of micro-batch means is the mean over
    all of them)."""
    mesh_dim, mesh_name, n_micro, *_ = _run_parts(run)
    sizes = dict(zip(mesh_name, mesh_dim))
    return n_micro * sizes.get("dp", 1) * sizes.get("ep", 1)


def _run_model(run):
    """The config of a run's model (``MESH_MODELS``). A MoE model's
    expert capacity is a micro-batch's token count: no assignment can
    drop (Mixtral is dropless), on a rank or in the reference."""
    import dataclasses

    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig

    opts = _run_opts(run)
    if opts.get("vp"):
        return dataclasses.replace(
            _run_model(run[:6] + ({k: v for k, v in opts.items()
                                   if k != "vp"},)),
            vocab_parallel=True, padded_vocab_size=opts.get("pad_vocab"))
    kind = opts.get("model", "gpt2")
    seq = MESH_MODELS[kind][1]
    tokens = run[3] // _ref_micro(run) * seq
    if kind in ("gpt2", "gpt2_1k"):
        return dataclasses.replace(
            GPT2Config.base(), n_layer=opts.get("layers", 12))
    if kind == "gpt2_moe":
        return dataclasses.replace(GPT2Config.base(), n_experts=8,
                                   expert_top_k=2, expert_capacity=tokens,
                                   n_layer=opts.get("layers", 12))
    cfg = dataclasses.replace(LlamaConfig.llama32_1b(), n_layers=2)
    if kind == "llama":
        return cfg
    return dataclasses.replace(cfg, n_layers=2, n_experts=8, expert_top_k=2,
                               expert_capacity=tokens)


def _model_dict(cfg) -> dict:
    """A model config as a picklable dict naming its family."""
    import dataclasses

    from quintnet_tpu_torch.models.llama import LlamaConfig

    family = "llama" if isinstance(cfg, LlamaConfig) else "gpt2"
    return {"family": family, **dataclasses.asdict(cfg)}


def _model_cfg(model: dict):
    """The inverse of :func:`_model_dict` (a dict without "family" is
    GPT-2's)."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig

    d = dict(model)
    if d.pop("family", "gpt2") == "llama":
        return LlamaConfig(**{**d, "rope_scaling": tuple(d["rope_scaling"])
                              if d["rope_scaling"] else None})
    return GPT2Config(**d)


def _depth(cfg) -> int:
    return getattr(cfg, "n_layer", None) or cfg.n_layers


def _heads(cfg) -> int:
    return getattr(cfg, "n_head", None) or cfg.n_heads


def _tp_layout(cfg, tree, tp, to_blocked=True):
    """A param-shaped tree to (or from) the tp layout of its family:
    GPT-2's tp-blocked fused QKV; Llama's identity."""
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config,
                                                gpt2_from_tp_layout,
                                                gpt2_to_tp_layout)

    if not isinstance(cfg, GPT2Config):
        return tree
    return (gpt2_to_tp_layout if to_blocked else gpt2_from_tp_layout)(
        tree, cfg, tp)


def _mesh_config(rows, n_micro, sizes=None, schedule="afab",
                 optimizer="adamw", **training):
    """The train phase's optimiser and batch on the mesh ``sizes``;
    ``training``: further keys (fsdp, the bf16 dtypes)."""
    from quintnet_tpu_torch.core.config import Config

    d = {"training": {
        "batch_size": rows, "gradient_accumulation_steps": n_micro,
        "optimizer": optimizer, "learning_rate": 5e-5, "weight_decay": 0.01,
        "grad_clip_norm": 1.0, "log_every": 0, "seed": 0,
        "schedule": schedule, **training}}
    if sizes:
        d["mesh_dim"], d["mesh_name"] = list(sizes.values()), list(sizes)
    return Config.from_dict(d)


def _flat_cpu(tree):
    from quintnet_tpu_torch.core.pytree import tree_leaves

    return {".".join(k): v.detach().cpu().clone()
            for k, v in tree_leaves(tree)}


def _mesh_model(cfg, dtype=None, sp_mode="ring"):
    """The mesh runs' training model of ``cfg``'s family (flash
    attention; bf16 compute from the f32 masters when ``dtype`` says
    so; ``sp_mode``: its attention on an sp mesh)."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.models.llama import llama_model_spec

    spec = gpt2_model_spec if isinstance(cfg, GPT2Config) else \
        llama_model_spec
    return spec(cfg, use_flash=True, sp_mode=sp_mode, compute_dtype=(
        torch.bfloat16 if dtype == "bfloat16" else None))


class _Routes:
    """Records every top-k routing decision while it is entered
    (``nn/moe._route`` wrapped): a list of (router probabilities [S, E],
    chosen experts [S, k]) on the CPU, one a MoE call in call order."""

    def __enter__(self):
        from quintnet_tpu_torch.nn import moe

        self.calls, self._route = [], moe._route

        def route(probs, k):
            vals, idx = self._route(probs, k)
            self.calls.append((probs.detach().cpu(), idx.detach().cpu()))
            return vals, idx

        moe._route = route
        return self

    def __exit__(self, *exc):
        from quintnet_tpu_torch.nn import moe

        moe._route = self._route
        return False


def _route_report(calls, ref_calls, capacity):
    """Routing of a run's first batch against the reference's (the
    reference's calls for this rank's micro-batches, in order): the share
    of decisions that agree, the largest router-probability gap of a
    flipped one (a flip is a near-tie only within ``ROUTE_TIE``), and
    the assignments past ``capacity`` (dropped)."""
    same = total = 0
    gap = 0.0
    dropped = 0
    for (p, idx), (p_ref, idx_ref) in zip(calls, ref_calls):
        if idx.shape != idx_ref.shape:
            raise AssertionError(f"routing shapes {tuple(idx.shape)} vs "
                                 f"{tuple(idx_ref.shape)}")
        eq = idx == idx_ref
        same, total = same + int(eq.sum()), total + eq.numel()
        if not eq.all():
            a = p_ref.gather(1, idx_ref)[~eq]
            b = p_ref.gather(1, idx)[~eq]
            gap = max(gap, float((a - b).abs().max()))
        counts = torch.bincount(idx.reshape(-1), minlength=p.shape[1])
        dropped += int((counts - capacity).clamp_min(0).sum())
    return {"decisions": total, "agree_share": same / max(total, 1),
            "max_flip_gap": gap, "dropped": dropped}


def _mesh_reference(cfg, host, n_micro, device, path, *, dtype=None,
                    keep=REF_PARTS):
    """The single-rank run a mesh run is held to, in deterministic mode:
    the first batch's loss and every gradient leaf (``n_micro``
    micro-batches; with experts, every routing decision), then
    ``MESH_STEPS`` steps of ``Trainer.fit`` from the
    same seed: the step losses, the parameters and both Adam moments
    (``dtype="bfloat16"``: bf16 compute and a bf16 first moment). Saved
    as CPU tensors to ``path``, with only the parts of ``REF_PARTS`` in
    ``keep`` (``_ref_needs``: the card's disk takes 45 GiB of writes a
    call); returns the losses and one more step's wall ms and peak memory
    (what a mesh run's step is set beside)."""
    from quintnet_tpu_torch.parallel.dp import accumulate_grads
    from quintnet_tpu_torch.train.trainer import Trainer

    extra = TRAIN_BF16 if dtype == "bfloat16" else {}
    tr = Trainer(_mesh_config(len(host[0][0]), n_micro, **extra),
                 _mesh_model(cfg, dtype), task_type="clm",
                 device=device, log_fn=lambda m: None)
    params, opt_state = tr.init_state()
    with _Routes() as routes:
        loss, grads = accumulate_grads(tr.model.loss_fn, params,
                                       tr.device_batch(*host[0]), n_micro)
    ref = {"first_loss": loss.detach().cpu(), "routes": routes.calls}
    if "grads" in keep:
        ref["grads"] = {".".join(k): g.cpu() for k, g in grads.items()}
    del grads
    losses = _recording(tr)
    tr.fit(lambda ep: [host[ep]], epochs=MESH_STEPS, params=params,
           opt_state=opt_state)
    p, st = tr.final_state
    ref["losses"] = [v.detach().cpu() for v in losses]
    for part, tree in (("params", p), ("mu", st["mu"]), ("nu", st["nu"])):
        if part in keep:
            ref[part] = _flat_cpu(tree)
    torch.save(ref, path)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    return {"first_loss": float(loss), "losses": [float(v) for v in losses],
            "step_ms": _wall_step_ms(tr, p, st, host[0]),
            "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if on_card else None)}


def _ref_needs(run) -> set:
    """The parts of its reference a run's gates read: a run gated bit for
    bit the final parameters and moments, the others the first-batch
    gradients, a ZeRO run the moments (its chunks), fsdp with tp the
    moments (gathered)."""
    sizes = dict(zip(run[1], run[0]))
    if _exact(run):
        return {"params", "mu", "nu"}
    need = {"grads"}
    if _run_parts(run)[5].startswith("zero") or (_run_opts(run).get("fsdp")
                                     and sizes.get("tp", 1) > 1):
        need |= {"mu", "nu"}
    return need


def _join_rank(rank, world, store, device):
    """Deterministic f32 on this rank, joined to the world over
    ``MESH_BACKEND``."""
    from quintnet_tpu_torch.core import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    return runtime.initialize(backend=MESH_BACKEND,
                              init_method=f"file://{store}", rank=rank,
                              world_size=world, device=device)


def _probe_rank(rank, world, store, device):
    """Which collectives gloo runs on this device's tensors: each one on a
    small tensor, its value checked; a collective that raises is reported
    with its message."""
    from quintnet_tpu_torch.core import collectives as cc
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.core.mesh import mesh_from_sizes

    dev = _join_rank(rank, world, store, device)
    try:
        ax = mesh_from_sizes(dp=world).axis("dp")
        x = torch.arange(4.0, device=dev) + 10 * rank
        ops = {
            "all_reduce": (lambda t: cc.all_reduce(t, ax),
                           sum(torch.arange(4.0) + 10 * r
                               for r in range(world))),
            "broadcast": (_broadcast, torch.arange(4.0)),
            "all_gather": (lambda t: cc.all_gather(t, ax, gather_dim=0),
                           torch.cat([torch.arange(4.0) + 10 * r
                                      for r in range(world)])),
            "reduce_scatter": (
                lambda t: cc.reduce_scatter(t, ax, scatter_dim=0),
                sum(torch.arange(4.0) + 10 * r for r in range(world))
                .chunk(world)[rank]),
            "all_to_all": (
                lambda t: cc.all_to_all(t, ax, split_dim=0, concat_dim=0),
                torch.cat([(torch.arange(4.0) + 10 * r).chunk(world)[rank]
                           for r in range(world)])),
            "shift": (
                lambda t: cc.ppermute_shift(t, ax, shift=1, wrap=False),
                torch.arange(4.0) + 10 * (rank - 1) if rank
                else torch.zeros(4)),
            # member 0 sends to 1, member 1 sends nothing: 0 gets zeros
            "ppermute": (
                lambda t: cc.ppermute(t, ax, [(0, 1)]),
                torch.arange(4.0) if rank == 1 else torch.zeros(4)),
        }
        tries = {name: (lambda fn=fn: fn(x), want)
                 for name, (fn, want) in ops.items()}
        # heads h and member s: h + 1000 s; after the exchange member r
        # holds its heads' chunk of every member's slice, in member order
        _, B, H, S, D = PROBE_ULYSSES
        head = torch.arange(float(H)).reshape(1, 1, H, 1, 1)
        qkv = (head + 1000.0 * rank).expand(PROBE_ULYSSES).to(dev)
        mine = head[:, :, rank * H // world:(rank + 1) * H // world]
        tries["all_to_all_ulysses"] = (
            lambda: cc.all_to_all(qkv, ax, split_dim=2, concat_dim=3),
            torch.cat([(mine + 1000.0 * r).expand(3, B, H // world, S, D)
                       for r in range(world)], dim=3))
        # bf16 (small integers: exact): the 3d_bf16 run's tp sums
        xb = x.to(torch.bfloat16)
        for name in ("all_reduce", "all_gather", "reduce_scatter"):
            fn, want = ops[name]
            tries[name + "_bf16"] = (lambda fn=fn: fn(xb),
                                     want.to(torch.bfloat16))
        out = {}
        for name in PROBED:
            fn, want = tries[name]
            try:
                got = fn()
                out[name] = ("ok" if torch.equal(got.cpu(), want) else
                             f"wrong value {got.flatten()[:8].tolist()}")
            except RuntimeError as e:
                out[name] = f"raised {type(e).__name__}: {str(e)[:160]}"
        if out["all_to_all_ulysses"] == "ok":
            out["all_to_all_ulysses_ms"] = _collective_ms(
                tries["all_to_all_ulysses"][0], torch.device(dev))
        return out
    finally:
        runtime.shutdown()


def _collective_ms(fn, dev, calls=5) -> float:
    """Mean wall ms of ``calls`` calls of a collective after one warm-up
    (host clock, a card drained before and after: gloo stages CUDA
    tensors through host memory)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / calls


def _broadcast(x):
    import torch.distributed as dist

    y = x.clone()
    dist.broadcast(y, src=0)
    return y


def _nest(flat):
    """{"a.b.c": leaf} -> nested dicts."""
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _gather_full(grads, specs, mesh, cfg, tp):
    """Every rank's shards of a gradient (or parameter) tree ({path:
    tensor}) gathered whole on the CPU (gloo) and taken back to the
    standard layout of ``cfg``'s family (GPT-2's fused QKV): {"a.b":
    tensor}."""
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.parallel.tp import gather_leaf

    spec = {".".join(k): v for k, v in tree_leaves(specs)}
    full = {}
    for path, g in grads.items():
        key = path if isinstance(path, str) else ".".join(path)
        full[key] = gather_leaf(g.detach().cpu().contiguous(), spec[key],
                                mesh)
    back = _tp_layout(cfg, _nest(full), tp, to_blocked=False)
    return {".".join(k): v for k, v in tree_leaves(back)}


def _table_key(cfg) -> str:
    """The flat key of the embedding table of ``cfg``'s family."""
    return "embedding.tok" if hasattr(cfg, "n_layers") else "embedding.wte"


def _vp_generate(dev, params, specs, mesh, cfg, tp, n_new):
    """``gpt2_generate_tp`` greedy (2 prompts) from a run's final
    vocab-sharded parameters against ``gpt2_generate`` on one device from
    the same parameters gathered whole: equal up to each row's first
    differing token, which must be a near-tie (the dense top-2 gap there
    below ``F32_GAP``)."""
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.models.gpt2_generate import (gpt2_generate,
                                                         gpt2_generate_tp)

    t0 = min(64, cfg.n_positions // 4)
    n_new = min(n_new, cfg.n_positions - t0)
    ids = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, t0)).astype(np.int32)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    got = gpt2_generate_tp(params, ids, cfg, mesh=mesh, max_new_tokens=n_new)
    sync()
    tp_s = time.perf_counter() - t
    one = tree_map(lambda v: v.to(dev), _nest(_gather_full(
        dict(tree_leaves(params)), specs, mesh, cfg, tp)))
    want = gpt2_generate(one, ids, cfg, max_new_tokens=n_new)
    div, agree = [], 0
    for r in range(len(ids)):
        d = np.nonzero(got[r, t0:] != want[r, t0:])[0]
        agree += n_new if d.size == 0 else int(d[0])
        if d.size:
            i = int(d[0])
            gap = _greedy_gap_check(one, cfg, got[r], t0, i, device=dev)
            div.append({"row": r, "step": i, "tp": int(got[r, t0 + i]),
                        "one_device": int(want[r, t0 + i]),
                        "top2_gap": gap})
    return {"rows": len(ids), "prompt": t0, "new_tokens": n_new,
            "tokens_agreeing": agree, "divergences": div,
            "tp_generate_s": tp_s,
            "padded_ids_emitted": int((got[:, t0:] >= cfg.vocab_size).sum())}


def _leaf_errors(got, want):
    """key -> max |got - want| / max |want| (want's largest magnitude)."""
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30)) for k in want}


def _first_difference(losses, state, ref):
    """None when a run's step losses and its ``state`` ({"params", "mu",
    "nu"}: {key: CPU tensor}) equal the reference bit for bit; else what
    differs first (a step loss, else the first leaf, with its largest
    difference)."""
    if len(losses) != len(ref["losses"]):
        return f"{len(losses)} steps, the reference {len(ref['losses'])}"
    for i, (a, b) in enumerate(zip(losses, ref["losses"])):
        if not torch.equal(a, b):
            return f"step {i} loss {float(a)!r} != {float(b)!r}"
    for part in ("params", "mu", "nu"):
        if set(state[part]) != set(ref[part]):
            odd = sorted(set(state[part]) ^ set(ref[part]))
            return f"{part}: leaves {odd}"
        for k, v in state[part].items():
            if not torch.equal(v, ref[part][k]):
                d = float((v.double() - ref[part][k].double()).abs().max())
                return f"{part}.{k}: max |diff| {d!r}"
    return None


def _first_grads(tr, params, batch, n_micro, schedule):
    """The first batch's loss (averaged over dp) and gradients (reduced
    over the mesh, every leaf whole as the optimizer would see it before
    ZeRO's chunking) on this rank, through the run's own path: the
    pipeline's schedule on a pp mesh, else the accumulated loss."""
    from quintnet_tpu_torch.parallel.dp import accumulate_grads
    from quintnet_tpu_torch.parallel.pp import (make_1f1b_grad_fn,
                                                make_afab_loss_fn)
    from quintnet_tpu_torch.parallel.train_step import reduce_grads

    strat = tr.strategy
    names = strat.mesh.axis_names
    if strat.uses_pp:
        fns = strat.pipeline_fns(tr.model)
        pspec = strat._pipeline_spec()
        if schedule == "afab":
            loss, grads = accumulate_grads(make_afab_loss_fn(*fns, pspec),
                                           params, batch, 1)
        else:
            loss, grads = make_1f1b_grad_fn(
                *fns, pspec, store_activations=schedule == "1f1b_stored")(
                    params, batch)
    else:
        loss_fn, _ = strat.model_fns(tr.model)
        loss, grads = accumulate_grads(loss_fn, params, batch, n_micro)
    reduce_grads(grads, strat.param_specs(tr.model), strat.mesh,
                 data_axes=tuple(a for a in strat.batch_axes if a in names),
                 model_axes=strat.model_axes,
                 partial_axes=strat.partial_axes)
    return strat.mean_over_batch(loss), grads


def _moment_chunk_errors(st, ref, strat, model, cfg, tp):
    """Under ZeRO: this rank's Adam moment chunks against the same chunk
    of the single-rank reference's moments (taken to the tp layout, cut
    to this rank's tp and pp shards, flattened in ZeRO's order): max
    |diff| / max |reference chunk| for mu and nu."""
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.parallel import zero
    from quintnet_tpu_torch.parallel.tp import shard_leaf

    ax = strat.mesh.axis(strat.zero1_axis)
    out = {}
    for m in ("mu", "nu"):
        full = _tp_layout(cfg, _nest(ref[m]), tp)
        local = tree_map(lambda t, sp: shard_leaf(t, sp, strat.mesh), full,
                         strat.param_specs(model))
        flat = zero.flatten(dict(tree_leaves(local)), zero.flat_order(local))
        want = zero.local_chunk(flat, ax.size, ax.index,
                                zero.chunk_size(flat.numel(), ax.size))
        got = st[m].detach().float().cpu()
        if got.shape != want.shape:
            raise AssertionError(f"{m} chunk {tuple(got.shape)}, want "
                                 f"{tuple(want.shape)}")
        out[m] = float((got - want).abs().max()
                       / want.abs().max().clamp_min(1e-30))
    return out


def _block_shares(params, specs, mesh):
    """(elements of the blocks this rank holds, elements it would hold
    without fsdp on the same mesh: each dp-sharded leaf times dp)."""
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.parallel.tp import spec_axes

    by_path = dict(tree_leaves(specs))
    held = unsharded = 0
    for path, v in tree_leaves(params):
        n = v.numel()
        full = n * (mesh.shape["dp"] if "dp" in spec_axes(by_path[path])
                    else 1)
        if path[0] == "blocks":
            held, unsharded = held + n, unsharded + full
    return held, unsharded


def _local_unsharded_numel(params, specs, mesh):
    """This rank's parameter elements without fsdp (each dp-sharded leaf
    times dp): what its replicated optimizer state would cover."""
    held, unsharded = _block_shares(params, specs, mesh)
    from quintnet_tpu_torch.core.pytree import tree_leaves

    total = sum(v.numel() for _, v in tree_leaves(params))
    return total - held + unsharded


def _gather_state(p, st, specs, mesh, cfg, tp):
    """The parameters and both Adam moments (sharded like them) gathered
    whole in the standard layout: {part: {"a.b": CPU tensor}}."""
    from quintnet_tpu_torch.core.pytree import tree_leaves

    return {part: _gather_full(dict(tree_leaves(tree)), specs, mesh, cfg,
                               tp)
            for part, tree in (("params", p), ("mu", st["mu"]),
                               ("nu", st["nu"]))}


def _state_errors(state, ref):
    """Per part of a gathered state (:func:`_gather_state`), the worst
    leaf against the reference's and its max |diff| / max |reference|."""
    out = {}
    for part, full in state.items():
        if part not in ref:
            continue
        err = _leaf_errors({k: v.float() for k, v in full.items()},
                           {k: v.float() for k, v in ref[part].items()})
        worst = max(err, key=err.get)
        out[part] = [worst, err[worst]]
    return out


def _timed_calls(obj, name):
    """Make ``obj.name`` record each call's wall seconds (synced on the
    card); returns the list it appends to."""
    times, fn = [], getattr(obj, name)

    def wrapped(*args, **kwargs):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        times.append(time.perf_counter() - t)
        return out

    setattr(obj, name, wrapped)
    return times


def _after_first_step(trainer, path):
    """Make the trainer's first step also gather the updated parameters
    whole over the mesh (the tp-blocked layout the run holds them in, on
    the CPU over gloo) and, on rank 0, save them to ``path``."""
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.parallel.tp import gather_leaf

    step_fn, done = trainer.step_fn, []
    strat = trainer.strategy

    def step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        if not done:
            done.append(True)
            specs = dict(tree_leaves(strat.param_specs(trainer.model)))
            full = {".".join(k): gather_leaf(v.detach().cpu().contiguous(),
                                             specs[k], strat.mesh)
                    for k, v in tree_leaves(out[0])}
            if strat.mesh.rank == 0:
                torch.save(full, path)
        return out

    trainer.step_fn = step


def _launches_by_dtype():
    wrappers = _wrappers()
    return {name: dict(wrappers[name].launches_by_dtype)
            for name in FLASH_KERNELS}


# ---------------------------------------------------------------------
# the serving meshes: one engine on every rank of a 2-rank world
# ---------------------------------------------------------------------

# name -> mesh, model, engine options, traffic. "short": SERVE_MESH_LENS
# prompts, greedy and sampled; "document": serve_chunked's 1,000-token
# document through sp = 2 chunks of 256 (128 positions a rank) while 3
# streams decode. Each joins the 2-rank world of MESH_RUNS.
# "gpt2_moe_drops" is serve_ep2's model at the default capacity factor:
# its decode calls drop assignments, so dead rows and pad columns compete
# with live tokens for expert slots (gated: the ranks agree bit for bit)
SERVE_MESH_RUNS = {
    "serve_tp2": ({"tp": 2}, "gpt2", {}, "short"),
    "serve_tp2_llama": ({"tp": 2}, "llama", {}, "short"),
    "serve_sp2": ({"sp": 2}, "gpt2", {
        "sp_axis": "sp", "max_slots": 4, "max_seq_len": 1024,
        "prefill_len": CHUNK_WINDOW, "chunked_prefill": True,
        "prefill_chunk_budget": CHUNK_BUDGET}, "document"),
    "serve_ep2": ({"ep": 2}, "gpt2_moe", {"ep_axis": "ep"}, "short"),
    "serve_ep2_drops": ({"ep": 2}, "gpt2_moe_drops", {"ep_axis": "ep"},
                        "short"),
}
# the kernels-line entry of each run's K4 launches by its rank's head
# shape: a tp rank's own (tag, query heads, kv heads), timed at cases of
# that shape; the rest (12 GPT-2 heads a rank) on GPT-2's lines
SERVE_MESH_LINES = {"serve_tp2": ("tp2_gpt2", 6, 6),
                    "serve_tp2_llama": ("tp2_llama", 16, 4)}
SERVE_MESH_LENS, SERVE_MESH_NEW = (32, 200, 120, 57), 24
SERVE_MESH_SEEDS = (300, 301, 302, 303)
# the steady window each run times (host clock, synced) and profiles
SERVE_MESH_WINDOW = 6


def _serve_mesh_cfg(model):
    """GPT-2 124M widths cut to 4 layers (6 in slices 19-20; since slice
    21 the script's 1,200 s holds the process fleet's phase too:
    ROADMAP.md, "Two budgets"); Llama-3.2-1B widths cut to 4 layers;
    GPT-2 124M widths cut to 4 layers with 8 mlp experts a block, top-2,
    dropless
    (capacity factor E / k = 4: C is each call's token count, so the
    dense forward routes every token as the engine does) or,
    "gpt2_moe_drops", at the default capacity factor 1.25."""
    import dataclasses

    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig

    if model == "llama":
        return dataclasses.replace(LlamaConfig.llama32_1b(), n_layers=4)
    if model == "gpt2_moe":
        return dataclasses.replace(GPT2Config.base(), n_layer=4,
                                   n_experts=8, expert_top_k=2,
                                   capacity_factor=4.0)
    if model == "gpt2_moe_drops":
        return dataclasses.replace(GPT2Config.base(), n_layer=4,
                                   n_experts=8, expert_top_k=2)
    return dataclasses.replace(GPT2Config.base(), n_layer=4)


def _serve_mesh_params(cfg, device):
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.models.llama import llama_init

    gen = torch.Generator(device=device).manual_seed(0)
    return (gpt2_init if isinstance(cfg, GPT2Config) else llama_init)(
        gen, cfg)


def _serve_mesh_traffic(name, cfg, params, device, mesh=None):
    """One serving run's main paths on this rank (``mesh``) or on one
    device (None): per mode a fresh engine, warmed, counts zeroed, the
    traffic, counts read; then the steady window (``_serve_window``).
    Returns a JSON-able report (streams as lists)."""
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family, \
        llama_family

    sizes, model, kw, traffic = SERVE_MESH_RUNS[name]
    family = (llama_family if model == "llama" else gpt2_family)(cfg)
    if mesh is None:
        kw = {k: v for k, v in kw.items() if k not in ("sp_axis",
                                                        "ep_axis")}
    elif sizes.get("tp", 1) > 1:
        params = _tp_layout(cfg, params, sizes["tp"])
    mesh_kw = {"mesh": mesh} if mesh is not None else {}
    L = _depth(cfg)
    out = {"runs": {}}
    modes = (("greedy", {}),) if traffic == "document" else (
        ("greedy", {}), ("sampled", SAMPLED))
    for mode, skw in modes:
        eng = ServeEngine(family, params, device=device, **{
            "max_slots": 8, "block_size": 16, "num_blocks": 320,
            "max_seq_len": 512, **kw, **skw}, **mesh_kw)
        eng.warmup()
        _sync()
        calls = _Calls(eng)
        run = {}
        if traffic == "document":
            logits = {}
            prefill = eng._prefill

            def recorded(ids, start, t0, *a):
                lg = prefill(ids, start, t0, *a)
                if t0 == CHUNK_PROMPT:
                    logits["doc"] = lg.detach().cpu()
                return lg

            eng._prefill = recorded
            _zero_counts()
            t0 = time.perf_counter()
            streams, prompts, during, _after = _chunk_script(
                eng, cfg, np.random.default_rng(23))
            run["wall_s"] = time.perf_counter() - t0
            run["document_last_logits"] = logits["doc"][0].tolist()
            run["chunk_step_ms"] = [w * 1e3 for w, _, _ in during]
            seeds = None
        else:
            rng = np.random.default_rng(41)
            prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in SERVE_MESH_LENS]
            seeds = SERVE_MESH_SEEDS
            _zero_counts()
            streams, run["wall_s"] = _run_requests(
                eng, prompts, [SERVE_MESH_NEW] * len(prompts), seeds)
        launches = _launches()
        m = eng.metrics
        # sp prefill is the ring (plain attention): no K4 prefill
        prefills = (0 if eng.sp_axis else m.prefill_chunks
                    if eng.chunked_prefill else m.admitted)
        want = {"decode": L * calls.decode, "prefill": L * prefills}
        if torch.device(device).type == "cuda":   # the CPU launches none
            _check_launches(launches, _variant(eng.pool), want)
        summary = m.summary()
        run.update({"streams": [x.tolist() for x in streams],
                    "prompt_lens": [len(p) for p in prompts],
                    "seeds": None if seeds is None else list(seeds),
                    "launches_by_path": want, "steps": m.steps,
                    "prefill_chunks": m.prefill_chunks,
                    "moe": {k: (v if not isinstance(v, dict) else dict(v))
                            for k, v in summary.items()
                            if k.startswith("moe")}})
        out["runs"][mode] = run
        if mode == "greedy":
            out.update(_serve_window(eng, cfg, mesh))
        del eng
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _serve_window(eng, cfg, mesh):
    """A steady window of decode steps (8 rows of 100-token prompts):
    ``SERVE_MESH_WINDOW`` steps timed with no profiler (host clock,
    synced), then as many under ``torch.profiler`` with every collective
    entered on a drained device (``core/collectives.communicate`` wrapped
    with a synchronize), so the ``collective:*`` ranges time the
    collectives alone: their share of the profiled steps, and K4's decode
    kernels a step by symbol (n_layer)."""
    from quintnet_tpu_torch.core import collectives as cc

    n = SERVE_MESH_WINDOW
    rng = np.random.default_rng(43)
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, cfg.vocab_size, 100),
                   (2 + PROFILED_WINDOWS) * n + 4)
    eng.step()
    eng.step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    wall = time.perf_counter() - t0
    walls = []

    def run():
        t = time.perf_counter()
        for _ in range(n):
            eng.step()
        _sync()
        walls.append(time.perf_counter() - t)

    communicate = cc.communicate

    def drained(*args, **kwargs):
        _sync()
        return communicate(*args, **kwargs)

    cc.communicate = drained
    try:
        prof, by_name = _profiled(
            run, expect={PAGED_SYMBOLS["decode"]: _depth(cfg) * n},
            agree=_any_rank if mesh is not None else None)
    finally:
        cc.communicate = communicate
    eng.run()
    coll = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("collective:")):
            coll[e.name] += e.cpu_time_total / 1e3
    decode_k = sum(k for name, (_, k) in by_name.items()
                   if PAGED_SYMBOLS["decode"] in name)
    busy = sum(us for us, _ in by_name.values())
    if busy > 0 and decode_k != _depth(cfg) * n:
        raise AssertionError(f"profiler: {decode_k} K4 decode kernels over "
                             f"{n} steps; expected {_depth(cfg) * n}")
    return {"decode_step_ms": wall / n * 1e3,
            "profiled_step_ms": walls[-1] / n * 1e3,
            "collective_ms_per_step": {k: v / n for k, v in coll.items()},
            "collective_share_of_profiled_step":
                sum(coll.values()) / (walls[-1] * 1e3),
            "k4_decode_kernels_profiled_per_step": decode_k / n}


def _serve_mesh_run(rank, dev, name, model):
    """One rank's part of a serving mesh run, in a joined world: the
    run's mesh, the params of ``model`` (``_model_dict``) from seed 0 on
    this rank's device, and :func:`_serve_mesh_traffic` on the mesh."""
    from quintnet_tpu_torch.core.mesh import MeshSpec, build_mesh

    sizes = SERVE_MESH_RUNS[name][0]
    mesh = build_mesh(MeshSpec.create(**sizes))
    cfg = _model_cfg(model)
    params = _serve_mesh_params(cfg, dev)
    # the ranks agree by the engine's own determinism, not by the
    # deterministic mode ``_join_rank`` sets for the training runs
    torch.use_deterministic_algorithms(False)
    try:
        out = _serve_mesh_traffic(name, cfg, params, dev, mesh)
    finally:
        torch.use_deterministic_algorithms(True)
    out.update({"rank": rank, "coords": mesh.coords})
    return out


def _check_serve_mesh(name, ranks, ref, params, cfg):
    """The gates of a serving mesh run: every rank's streams and routing
    summary the same as every other rank's, bit for bit; each rank's
    streams equal to one device's up to near-ties (the serve rule: tp
    re-associates the head and MLP sums, sp the attention's, ep changes
    the expert products' shapes); the document's last logits within 1e-4
    (sp); the routing summary equal to one device's (ep, dropless). With
    drops ("gpt2_moe_drops") one float-order flip of a routing decision
    may move which assignments drop, far from any near-tie: one device's
    engine is reported beside, and the traffic must drop. Returns its
    JSON line."""
    sizes, model, _, traffic = SERVE_MESH_RUNS[name]
    res = {"phase": "mesh", "run": name, "mesh": sizes,
           "model": _SERVE_MESH_MODELS[model], "traffic": traffic,
           "one_device": {"decode_step_ms": ref["decode_step_ms"],
                          "profiled_step_ms": ref["profiled_step_ms"]},
           "runs": {}, "ranks": []}
    drops = model == "gpt2_moe_drops"
    for mode, want in ref["runs"].items():
        first = ranks[0]["runs"][mode]
        for r in ranks[1:]:
            for key in ("streams", "moe"):
                if r["runs"][mode][key] != first[key]:
                    raise AssertionError(f"mesh {name} {mode}: ranks 0 and "
                                         f"{r['rank']} differ in {key}")
        got = [np.asarray(x, np.int32) for x in first["streams"]]
        wst = [np.asarray(x, np.int32) for x in want["streams"]]
        prompts = [x[:n] for x, n in zip(wst, want["prompt_lens"])]
        if drops:
            div = None
            agree = compared = 0
            for g, w, p in zip(got, wst, prompts):
                d = np.nonzero(g[len(p):] != w[len(p):])[0]
                agree += len(w) - len(p) if d.size == 0 else int(d[0])
                compared += len(w) - len(p)
        else:
            agree, compared, div = _near_tie_compare(
                params, cfg, got, wst, prompts, want["seeds"]
                if mode == "sampled" else None)
        run = {"tokens_agreeing_with_one_device": agree,
               "tokens_compared": compared,
               "divergences_at_near_ties": div,
               "launches_by_path_a_rank": first["launches_by_path"],
               "wall_s_a_rank": [r["runs"][mode]["wall_s"] for r in ranks],
               "wall_s_one_device": want["wall_s"]}
        if traffic == "document":
            err = max(float(np.abs(np.asarray(
                r["runs"][mode]["document_last_logits"])
                - np.asarray(want["document_last_logits"])).max())
                for r in ranks)
            if not err <= 1e-4:
                raise AssertionError(f"mesh {name}: the document's last "
                                     f"logits differ by {err} (> 1e-4)")
            run["document_last_logits_max_abs_err"] = err
            run["chunk_step_ms_a_rank"] = first["chunk_step_ms"]
            run["chunk_step_ms_one_device"] = want["chunk_step_ms"]
        if first["moe"]:
            same = first["moe"] == want["moe"]
            if drops and not first["moe"]["moe_dropped_tokens"] > 0:
                raise AssertionError(f"mesh {name} {mode}: no assignment "
                                     f"dropped")
            if not (same or drops):
                raise AssertionError(
                    f"mesh {name} {mode}: routing {first['moe']} != one "
                    f"device's {want['moe']}")
            run.update({"routing_summary": first["moe"],
                        "routing_summary_equal_one_device": same})
        res["runs"][mode] = run
    for r in ranks:
        res["ranks"].append({k: r[k] for k in (
            "rank", "coords", "decode_step_ms", "profiled_step_ms",
            "collective_ms_per_step", "collective_share_of_profiled_step",
            "k4_decode_kernels_profiled_per_step")})
    return res


_SERVE_MESH_MODELS = {
    "gpt2": "gpt2-124M widths cut to 4 layers (random init, seed 0)",
    "llama": "Llama-3.2-1B widths cut to 4 layers (random init, seed 0)",
    "gpt2_moe": "gpt2-124M widths cut to 4 layers, 8 mlp experts a "
                "block, top-2, capacity factor 4 (dropless; random init, "
                "seed 0)",
    "gpt2_moe_drops": "gpt2-124M widths cut to 4 layers, 8 mlp experts a "
                      "block, top-2, capacity factor 1.25 (random init, "
                      "seed 0)"}


def _mesh_rank(rank, world, store, run, host, ref_path, model, device,
               work=None):
    """One rank of a world that runs one mesh run (``_mesh_run``)."""
    from quintnet_tpu_torch.core import runtime

    dev = _join_rank(rank, world, store, device)
    try:
        return _mesh_run(rank, dev, run, host, ref_path, model, work)
    finally:
        runtime.shutdown()


def _mesh_world(rank, world, store, device, jobs):
    """One rank of a world that runs several mesh runs of its size in
    turn, ``jobs`` a list of ``(name, (run, host, ref_path, model,
    work))``: the costs of a rank's process (its start, torch's import,
    the card's context, the profiler's first use) are paid once, not
    once a run. Each run builds its own trainer and mesh, zeroes the
    counts before its main path and frees what it held after; returns
    ``{name: (this rank's report, its wall seconds)}``."""
    import gc

    from quintnet_tpu_torch.core import runtime

    dev = _join_rank(rank, world, store, device)
    try:
        out = {}
        for name, args in jobs:
            t0 = time.perf_counter()
            report = (_serve_mesh_run(rank, dev, name, *args)
                      if name in SERVE_MESH_RUNS
                      else _mesh_run(rank, dev, *args))
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            runtime.barrier()
            out[name] = (report, time.perf_counter() - t0)
        return out
    finally:
        runtime.shutdown()


def _mesh_run(rank, dev, run, host, ref_path, model, work=None):
    """One rank's part of a mesh run, in a joined world on ``dev``: the
    first batch's loss and gradients on a
    tp, pp or fsdp mesh (through the run's own schedule; gathered whole
    and held to the reference), then the main path (``Trainer.fit``,
    ``MESH_STEPS`` steps, launch counts zeroed just before and read just
    after), the run held to the reference (dp, fsdp or not: bit for
    bit; tp and pp: the f32 train tolerances (with fsdp the moments
    too), in
    bf16 the train_bf16 phase's; under ZeRO also each moment chunk), then
    on the card one step timed and one profiled. Given ``work``, a run
    with the "save" option checkpoints every step into it and leaves
    there what the resume check compares with: the parameters gathered
    whole after step 1 (rank 0) and each rank's final state."""
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.train.trainer import Trainer

    mesh_dim, mesh_name, n_micro, rows, schedule, optimizer = \
        _run_parts(run)
    opts = _run_opts(run)
    sizes = dict(zip(mesh_name, mesh_dim))
    tp, pp = sizes.get("tp", 1), sizes.get("pp", 1)
    cfg = _model_cfg(model)
    ckpt = (os.path.join(work, "ckpt") if opts.get("save") and work
            else None)
    tr = Trainer(_mesh_config(rows, n_micro, sizes, schedule, optimizer,
                              **_run_training(run)),
                 _mesh_model(cfg, opts.get("dtype"),
                             opts.get("sp_mode", "ring")),
                 task_type="clm", device=dev, log_fn=lambda m: None,
                 checkpoint_dir=ckpt)
    strat = tr.strategy
    specs = strat.param_specs(tr.model)
    ref = torch.load(ref_path, mmap=True)
    params, opt_state = tr.init_state()
    out = {"rank": rank, "coords": strat.mesh.coords,
           "strategy": strat.name, "device": str(dev),
           "zero": [strat.zero1_axis, strat.zero_stage],
           "fsdp": strat.fsdp_axis}
    experts = getattr(cfg, "n_experts", 0)
    exact = _exact(run)
    if not exact:
        with _Routes() as routes:
            loss, grads = _first_grads(tr, params,
                                       tr.device_batch(*host[0]), n_micro,
                                       schedule)
        if experts:
            batch = tuple(a for a in ("dp", "ep") if sizes.get(a, 1) > 1)
            c = strat.mesh.axis(batch).index if batch else 0
            L = _depth(cfg) // pp
            mine = ref["routes"][c * n_micro * L:(c + 1) * n_micro * L]
            out["routing"] = _route_report(routes.calls, mine,
                                           cfg.expert_capacity)
        first = float(loss)
        want = float(ref["first_loss"])
        out["first_loss"] = first
        out["first_loss_rel"] = abs(first - want) / abs(want)
        full = _gather_full(grads, specs, strat.mesh, cfg, tp)
        err = _leaf_errors(full, ref["grads"])
        if getattr(cfg, "padded_vocab_size", None):
            # a padded column takes no probability: its row's gradient
            # is exactly 0
            out["padded_rows_grad_max"] = float(
                full[_table_key(cfg)][cfg.vocab_size:].abs().max())
        del grads, full
        worst = max(err, key=err.get)
        out["worst_grad_leaf"], out["worst_grad_rel_err"] = (worst,
                                                             err[worst])
    if strat.fsdp_axis is not None:
        held, unsharded = _block_shares(params, specs, strat.mesh)
        out["resident_block_fraction"] = held / unsharded
    if getattr(cfg, "vocab_parallel", False):
        t = params["embedding"][_table_key(cfg).split(".")[1]]
        out["table_rows_a_rank"] = int(t.shape[0])
        out["table_mb_a_rank"] = t.numel() * t.element_size() / 1e6
    # the main path: counts zeroed just before, read just after
    losses = _recording(tr)
    if ckpt:
        saves = _timed_calls(tr, "save_state")
        _after_first_step(tr, os.path.join(work, "after1.pt"))
    _zero_counts()
    hist = tr.fit(lambda ep: [host[ep]], epochs=MESH_STEPS,
                  params=params, opt_state=opt_state)
    out["launches"] = _counts()
    out["launches_by_dtype"] = _launches_by_dtype()
    out["routed"] = flash_attention.routed
    p, st = tr.final_state
    out["losses"] = [float(v) for v in losses]
    out["loss_rel"] = [abs(float(a) - float(b)) / abs(float(b))
                       for a, b in zip(losses, ref["losses"])]
    mu_size = next(v for _, v in tree_leaves(st["mu"])).element_size()
    out["opt_state_bytes"] = sum(
        v.numel() * v.element_size() for m in ("mu", "nu")
        for _, v in tree_leaves(st[m]))
    out["replicated_opt_state_bytes"] = _local_unsharded_numel(
        p, specs, strat.mesh) * (mu_size + 4)
    if strat.zero1_axis is not None:
        out["moment_chunk_rel_err"] = _moment_chunk_errors(
            st, ref, strat, tr.model, cfg, tp)
    if exact or (strat.fsdp_axis is not None and "mu" in ref):
        state = _gather_state(p, st, specs, strat.mesh, cfg, tp)
        if exact:
            out["first_difference"] = _first_difference(
                [v.detach().cpu() for v in losses], state, ref)
        else:
            out["state_rel_err"] = _state_errors(state, ref)
        del state
    del ref
    if ckpt:
        out["save_s"] = saves
        if rank == 0:
            out["checkpoint_bytes"] = tr._manager().step_bytes(1)
        torch.save({"params": _flat_cpu(p),
                    "mu": st["mu"].detach().cpu(),
                    "nu": st["nu"].detach().cpu(),
                    "losses": [v.detach().cpu() for v in losses],
                    "train_loss": hist.train_loss},
                   os.path.join(work, f"final-{rank}.pt"))
    if opts.get("generate"):
        out["generate"] = _vp_generate(dev, p, specs, strat.mesh, cfg, tp,
                                       opts["generate"])
    if dev.type == "cuda":
        out.update(_mesh_step_share(
            tr, p, st, host[0], _per_step(run, _depth(cfg)),
            symbols=(FLASH_SYMBOLS_BF16 if opts.get("dtype") == "bfloat16"
                     else FLASH_SYMBOLS)))
        if opts.get("time_deterministic"):
            # what deterministic mode costs: steps with it on and off in
            # turns (on, off, off, on: gloo's host staging drifts); off,
            # the dispatch's index_add and its backward take atomics
            times = {True: [], False: []}
            for det in (True, False, False, True):
                torch.use_deterministic_algorithms(det)
                try:
                    times[det].append(_wall_step_ms(tr, p, st, host[0]))
                finally:
                    torch.use_deterministic_algorithms(True)
            out["step_ms_deterministic_on_off"] = [times[True], times[False]]
    return out


def _wall_step_ms(trainer, params, opt_state, b) -> float:
    """One step's wall time (no profiler; host clock, synced on the
    card)."""
    batch = trainer.device_batch(*b)
    sync = (torch.cuda.synchronize
            if torch.device(trainer.device).type == "cuda" else (lambda: None))
    sync()
    t0 = time.perf_counter()
    trainer.step_fn(params, opt_state, batch)
    sync()
    return (time.perf_counter() - t0) * 1e3


def _exact(run) -> bool:
    """A run gated bit for bit against its reference: dense GPT-2 on dp
    alone (fsdp or not). The others take the f32 (or bf16) tolerances."""
    sizes = dict(zip(run[1], run[0]))
    return (_run_opts(run).get("model", "gpt2") == "gpt2"
            and all(sizes.get(a, 1) == 1 for a in ("tp", "pp", "sp")))


def _resume_rank(rank, world, store, run, host, model, device, work):
    """One rank of a fresh world on the saved run's mesh: ``Trainer.fit``
    with its checkpoint directory (which holds step 1 alone: the cut
    run) restores this rank's part of step 1 and takes step 2 (launch
    counts zeroed just before and read just after); its step-2 loss, its
    History, its parameters and both moment chunks must equal the uncut
    run's on this rank bit for bit."""
    import quintnet_tpu_torch.ft.restore as ft_restore
    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.train.trainer import Trainer

    mesh_dim, mesh_name, n_micro, rows, schedule, optimizer = \
        _run_parts(run)
    sizes = dict(zip(mesh_name, mesh_dim))
    cfg = _model_cfg(model)
    dev = _join_rank(rank, world, store, device)
    try:
        tr = Trainer(_mesh_config(rows, n_micro, sizes, schedule, optimizer,
                                  **_run_training(run)),
                     _mesh_model(cfg), task_type="clm", device=dev,
                     log_fn=lambda m: None,
                     checkpoint_dir=os.path.join(work, "ckpt"))
        restores = _timed_calls(ft_restore, "restore_with_fallback")
        resumed = []
        resume_state = tr.resume_state

        def recorded(*args, **kwargs):
            got = resume_state(*args, **kwargs)
            resumed.append(got[2].global_step)
            return got

        tr.resume_state = recorded
        losses = _recording(tr)
        _zero_counts()
        hist = tr.fit(lambda ep: [host[ep]], epochs=MESH_STEPS)
        out = {"rank": rank, "coords": tr.strategy.mesh.coords,
               "launches": _counts(),
               "launches_by_dtype": _launches_by_dtype(),
               "routed": flash_attention.routed,
               "restored_global_step": resumed, "restore_s": restores,
               "losses": [float(v) for v in losses]}
        p, st = tr.final_state
        uncut = torch.load(os.path.join(work, f"final-{rank}.pt"))
        out["first_difference"] = _first_difference(
            [v.detach().cpu() for v in losses],
            {"params": _flat_cpu(p), "mu": {"chunk": st["mu"].detach().cpu()},
             "nu": {"chunk": st["nu"].detach().cpu()}},
            {"losses": uncut["losses"][1:], "params": uncut["params"],
             "mu": {"chunk": uncut["mu"]}, "nu": {"chunk": uncut["nu"]}})
        out["history_equal"] = hist.train_loss == uncut["train_loss"]
        out["train_loss"] = hist.train_loss
        return out
    finally:
        runtime.shutdown()


def _per_step(run, n_layer):
    """Each flash kernel's launches a step on one rank of ``run``: its
    stage's layers x its micro-batches, the forward twice under ``1f1b``
    (the backward sub-step reruns it); none on an sp mesh in ring or
    zigzag mode (plain attention per chunk pair, as in JAX)."""
    mesh_dim, mesh_name, n_micro, _, schedule, _ = _run_parts(run)
    sizes = dict(zip(mesh_name, mesh_dim))
    pp = sizes.get("pp", 1)
    ring = (sizes.get("sp", 1) > 1
            and _run_opts(run).get("sp_mode", "ring") != "ulysses")
    n = 0 if ring else n_layer // pp * n_micro
    return {"flash_fwd": n * (2 if pp > 1 and schedule == "1f1b" else 1),
            "flash_bwd_dkv": n, "flash_bwd_dq": n}


def _mesh_step_share(trainer, params, opt_state, b, per_step,
                     symbols=FLASH_SYMBOLS):
    """One step timed (no profiler; host clock, synced) with the rank's
    peak memory, then one step under ``torch.profiler`` in which every
    collective starts on a drained device (``core/collectives.
    communicate`` wrapped with a synchronize), so the ``collective:*``
    ranges time the collectives alone: their share of that step, and the
    flash kernels' launches in it by name."""
    from quintnet_tpu_torch.core import collectives as cc

    batch = trainer.device_batch(*b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.step_fn(params, opt_state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    walls = []

    def run():
        t = time.perf_counter()
        trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)

    communicate = cc.communicate

    def drained(*args, **kwargs):
        torch.cuda.synchronize()
        return communicate(*args, **kwargs)

    cc.communicate = drained
    try:
        prof, by_name = _profiled(run, expect={
            symbols[k]: per_step[k] for k in FLASH_KERNELS},
            agree=_any_rank)
    finally:
        cc.communicate = communicate
    coll = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("collective:")):
            coll[e.name] += e.cpu_time_total / 1e3
    launched = {k: sum(n for name, (_, n) in by_name.items()
                       if symbols[k] in name) for k in FLASH_KERNELS}
    return {"step_ms": wall * 1e3, "peak_memory_gib": peak / 2 ** 30,
            "profiled_step_ms": walls[-1] * 1e3,
            "collective_ms": dict(coll),
            "collective_share_of_profiled_step":
                sum(coll.values()) / (walls[-1] * 1e3),
            "profiled_launches": launched}


def _cut_after_first_step(work):
    """The saved run's checkpoint directory as a run cut after step 1
    leaves it: every later step removed. Returns the steps left."""
    import shutil

    from quintnet_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(work, "ckpt"))
    for step in mgr.all_steps():
        if step > 1:
            shutil.rmtree(os.path.join(mgr.directory, str(step)))
    return mgr.all_steps()


def _restore_without_mesh(work):
    """Step 1 of the saved run restored in this one process with no mesh
    (``CheckpointManager.restore()``: whole host arrays in the saved
    layout, the tp-blocked QKV): its seconds and bytes, and the first
    parameter that differs from the uncut run's parameters after step 1,
    gathered whole (None: every one bit for bit)."""
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(work, "ckpt"))
    t = time.perf_counter()
    state = mgr.restore(step=1)
    secs = time.perf_counter() - t
    got = {".".join(k): v for k, v in tree_leaves(state["params"])}
    want = torch.load(os.path.join(work, "after1.pt"))
    diff = None
    if set(got) != set(want):
        diff = f"leaves {sorted(set(got) ^ set(want))}"
    for k in sorted(want) if diff is None else ():
        if not torch.equal(got[k], want[k]):
            d = float((got[k].double() - want[k].double()).abs().max())
            diff = f"{k}: max |diff| {d!r}"
            break
    return {"restore_s": secs, "bytes": mgr.step_bytes(1),
            "first_difference": diff, "saved_mesh": mgr.sharding(1)["mesh"],
            "leaves": len(got)}


def _mesh_worlds():
    """World size -> the MESH_RUNS that share one world of that size, in
    the table's order; a run with the "resume" option gets a fresh world
    of its own ("resume"), after the run it resumes."""
    worlds = {}
    for name, run in MESH_RUNS.items():
        key = ("resume" if _run_opts(run).get("resume")
               else int(np.prod(run[0])))
        worlds.setdefault(key, []).append(name)
    return worlds


def _add_launches(counts, ranks):
    """Add each rank's launches, by kernel and dtype, to ``counts``."""
    for r in ranks:
        for kern, by in r["launches_by_dtype"].items():
            for dt, n in by.items():
                counts[dt][kern] += n


def _ref_key(run):
    """The reference a run is held to: (model, layers, rows,
    micro-batches, dtype, padded table rows). ``vocab_parallel`` without
    tp changes nothing, so a vp run shares its model's reference unless
    its table is padded."""
    opts = _run_opts(run)
    return (opts.get("model", "gpt2"), opts.get("layers", 0), run[3],
            _ref_micro(run), opts.get("dtype", ""), opts.get("pad_vocab", 0))


def _resume_world(name, run, refs, tmp):
    """The resume run: a fresh world restores the saved run's step 1 and
    takes step 2; then step 1 restored in this process with no mesh."""
    from quintnet_tpu_torch.core import runtime

    opts = _run_opts(run)
    host = refs[_ref_key(run)][0]
    cfg = _run_model(run)
    model = _model_dict(cfg)
    work = os.path.join(tmp, opts["resume"])
    world = int(np.prod(run[0]))
    print(f"mesh {name}: backend {MESH_BACKEND}, world size {world}, "
          f"every rank on cuda:0", flush=True)
    t0 = time.perf_counter()
    steps = _cut_after_first_step(work)
    ranks = runtime.spawn_world(_resume_rank, world, run, host, model,
                                "cuda:0", work, timeout=MESH_TIMEOUT_S)
    res = _check_resume_run(name, run, ranks, _depth(cfg))
    res["steps_left_by_the_cut"] = steps
    res["no_mesh_restore"] = one = _restore_without_mesh(work)
    if one["first_difference"] is not None:
        raise AssertionError(
            f"mesh {name}: step 1 restored with no mesh differs from the "
            f"uncut run's parameters after step 1: "
            f"{one['first_difference']}")
    res["world_wall_s"] = time.perf_counter() - t0
    return ranks, res


def _mesh_hosts(kind):
    """``MESH_STEPS`` host batches of 64 rows for a model of
    ``MESH_MODELS``: GPT-2's the train phase's summarization rows of 512
    byte tokens, Llama's 1,024 token ids over the vocab (seed = step)."""
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset

    seq = MESH_MODELS[kind][1]
    if kind.startswith("gpt2"):
        ds = SummarizationDataset.synthetic(64 * 4, ByteTokenizer(),
                                            max_length=seq, seed=0)
        return [next(iter(ds.batches(64, seed=i)))
                for i in range(MESH_STEPS)]
    from quintnet_tpu_torch.models.llama import LlamaConfig

    return [(ids, ids) for ids in (
        _llama_ids(LlamaConfig.llama32_1b(), 64, seq, 1000 + i)
        for i in range(MESH_STEPS))]


def phase_mesh():
    import tempfile

    from quintnet_tpu_torch.core import runtime

    counts = {"f32": collections.Counter(), "bf16": collections.Counter()}
    # K4 by path of the serving ranks, by kernels-line entry
    serve_paged = collections.defaultdict(collections.Counter)
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        try:
            hosts = {}
            for key in sorted({_ref_key(r) for r in MESH_RUNS.values()}):
                kind, _, rows, n_micro, dtype, _ = key
                run = next(r for r in MESH_RUNS.values()
                           if _ref_key(r) == key)
                if kind not in hosts:
                    hosts[kind] = _mesh_hosts(kind)
                host = [(x[:rows], y[:rows]) for x, y in hosts[kind]]
                path = os.path.join(tmp, "ref_" + "_".join(map(str, key))
                                    + ".pt")
                runs = [r for r in MESH_RUNS.values() if _ref_key(r) == key]
                keep = set().union(*(_ref_needs(r) for r in runs))
                refs[key] = (host, path, _mesh_reference(
                    _run_model(run), host, n_micro, DEVICE, path,
                    dtype=dtype or None, keep=keep))
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
        # the serving runs' one-device references (and the params their
        # near-tie checks read), on the card before the worlds start
        serve_refs = {}
        for name in SERVE_MESH_RUNS:
            cfg = _serve_mesh_cfg(SERVE_MESH_RUNS[name][1])
            params = _serve_mesh_params(cfg, DEVICE)
            serve_refs[name] = (_serve_mesh_traffic(name, cfg, params,
                                                    DEVICE), params, cfg)
            torch.cuda.empty_cache()
        _emit({"phase": "mesh", "references": len(refs),
               "serve_references": len(serve_refs),
               "references_s": round(time.perf_counter() - t0, 3)})
        probe = runtime.spawn_world(_probe_rank, 2, "cuda:0", timeout=120)
        _emit({"phase": "mesh", "check": "gloo collectives on CUDA "
               "tensors (2 ranks, cuda:0)", "results": probe,
               "gated": PROBE_GATED})
        bad = [k for k in PROBE_GATED
               if any(r[k] != "ok" for r in probe)]
        if bad:
            raise AssertionError(f"gloo {bad} on CUDA tensors: {probe}")
        for world, names in _mesh_worlds().items():
            if world == "resume":
                (name,) = names
                run = MESH_RUNS[name]
                ranks, res = _resume_world(name, run, refs, tmp)
                _emit(res)
                _add_launches(counts, ranks)
                continue
            jobs = []
            for name in names:
                run = MESH_RUNS[name]
                host, path, _ = refs[_ref_key(run)]
                work = os.path.join(tmp, name)
                os.makedirs(work, exist_ok=True)
                jobs.append((name, (run, host, path,
                                    _model_dict(_run_model(run)), work)))
            if world == 2:              # the serving runs join this world
                names = names + list(SERVE_MESH_RUNS)
                jobs += [(name, (_model_dict(serve_refs[name][2]),))
                         for name in SERVE_MESH_RUNS]
            print(f"mesh {', '.join(names)}: backend {MESH_BACKEND}, world "
                  f"size {world}, every rank on cuda:0, one world",
                  flush=True)
            t0 = time.perf_counter()
            got = runtime.spawn_world(_mesh_world, world, "cuda:0", jobs,
                                      timeout=MESH_TIMEOUT_S)
            wall = time.perf_counter() - t0
            for name in names:
                ranks = [g[name][0] for g in got]
                if name in SERVE_MESH_RUNS:
                    ref, params, cfg = serve_refs[name]
                    res = _check_serve_mesh(name, ranks, ref, params, cfg)
                    res.update({"run_wall_s": got[0][name][1],
                                "world_wall_s": wall, "card": _smi()})
                    _emit(res)
                    for r in ranks:
                        for run in r["runs"].values():
                            tag = SERVE_MESH_LINES.get(name, ("",))[0]
                            serve_paged[tag].update(run["launches_by_path"])
                    continue
                run = MESH_RUNS[name]
                res = _check_mesh_run(name, run, ranks,
                                      refs[_ref_key(run)][2],
                                      _run_model(run))
                res["run_wall_s"] = got[0][name][1]
                res["world_wall_s"] = wall
                res["world_runs"] = names
                _emit(res)
                _add_launches(counts, ranks)
        del serve_refs
    out = {dt: dict(c) for dt, c in counts.items()}
    out["serve_paged"] = {k: dict(c) for k, c in serve_paged.items()}
    return out


def _check_resume_run(name, run, ranks, n_layer):
    """The gates of the resumed world: each rank restored step 1, ran
    the flash kernels of one step (none routed), and ended equal to the
    uncut run bit for bit; returns the run's JSON line."""
    per_step = _per_step(run, n_layer)
    want = {k: {"f32": n} for k, n in per_step.items()}
    for r in ranks:
        where = f"mesh {name} rank {r['rank']} {r['coords']}"
        if r["restored_global_step"] != [1]:
            raise AssertionError(f"{where}: restored global step "
                                 f"{r['restored_global_step']}, not [1]")
        if r["launches_by_dtype"] != want or r["launches"][
                "paged_attention"] or r["routed"]:
            raise AssertionError(f"{where}: launches {r['launches_by_dtype']}"
                                 f" (routed {r['routed']}); expected {want}")
        if r["first_difference"] is not None or not r["history_equal"]:
            raise AssertionError(
                f"{where}: the resumed step 2 is not the uncut run's bit "
                f"for bit: {r['first_difference']}; History "
                f"{r['train_loss']}")
    mesh_dim, mesh_name, n_micro, rows, schedule, optimizer = \
        _run_parts(run)
    return {"phase": "mesh", "run": name,
            "mesh": dict(zip(mesh_name, mesh_dim)), "backend": MESH_BACKEND,
            "world_size": len(ranks), "ranks_device": "cuda:0 (shared)",
            "model": "gpt2-124M f32 (random init, seed 0), flash attention",
            "schedule": schedule, "optimizer": optimizer,
            "resumed_from": _run_opts(run)["resume"] + " step 1",
            "cut": f"{n_layer} of 12 layers",
            "gate": "bit for bit: step-2 loss, History, every parameter, "
                    "both moment chunks on every rank; no-mesh restore == "
                    "the uncut run's parameters after step 1",
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("launches", "routed")} for r in ranks],
            "launches_a_rank": want,
            "note": ("collectives staged through host memory by gloo; "
                     "every rank shares one card (not NVLink)"),
            "card": _smi()}


def _check_mesh_run(name, run, ranks, ref, cfg):
    """The gates of one mesh run over its ranks' reports (``cfg``: the
    run's model); returns the run's JSON line."""
    mesh_dim, mesh_name, n_micro, rows, schedule, optimizer = \
        _run_parts(run)
    opts = _run_opts(run)
    sizes = dict(zip(mesh_name, mesh_dim))
    bf16 = opts.get("dtype") == "bfloat16"
    tol = MESH_TOL_BF16 if bf16 else MESH_TOL
    fsdp = bool(opts.get("fsdp"))
    exact = _exact(run)
    n_layer = _depth(cfg)
    kind = opts.get("model", "gpt2")
    per_step = _per_step(run, n_layer)
    want = {k: n * MESH_STEPS for k, n in per_step.items()}
    want["paged_attention"] = 0
    want_dtype = {k: {"bf16" if bf16 else "f32": n * MESH_STEPS} if n
                  else {} for k, n in per_step.items()}
    for r in ranks:
        where = f"mesh {name} rank {r['rank']} {r['coords']}"
        if r["launches"] != want or r["launches_by_dtype"] != want_dtype:
            raise AssertionError(f"{where}: launches {r['launches']}, by "
                                 f"dtype {r['launches_by_dtype']}; expected "
                                 f"{want_dtype} (the stage's layers x "
                                 f"micro-batches x steps, the forward twice"
                                 f" under 1f1b)")
        if r["routed"]:
            raise AssertionError(f"{where}: {r['routed']} calls routed away "
                                 f"from the kernels")
        if "profiled_launches" in r and r["profiled_launches"] != per_step:
            raise AssertionError(f"{where}: profiler saw "
                                 f"{r['profiled_launches']} flash kernels a "
                                 f"step; expected {per_step}")
        if exact:
            if r["first_difference"] is not None:
                raise AssertionError(
                    f"{where}: not bit-identical to the single-rank run: "
                    f"{r['first_difference']}")
        else:
            if not r["first_loss_rel"] <= tol["first_loss"]:
                raise AssertionError(f"{where}: first loss {r['first_loss']}"
                                     f" vs {ref['first_loss']} (rel "
                                     f"{r['first_loss_rel']})")
            if not r["worst_grad_rel_err"] <= tol["grad"]:
                raise AssertionError(
                    f"{where}: gradient {r['worst_grad_leaf']}: max |diff| "
                    f"/ max |ref| = {r['worst_grad_rel_err']}")
            bad = [e for e in r["loss_rel"] if not e <= tol["step_loss"]]
            if bad or not all(np.isfinite(r["losses"])):
                raise AssertionError(f"{where}: step losses {r['losses']} vs"
                                     f" {ref['losses']}")
        if "routing" in r:
            rt = r["routing"]
            if rt["dropped"] or not rt["max_flip_gap"] <= ROUTE_TIE:
                raise AssertionError(
                    f"{where}: routing {rt}: a dropped assignment, or a "
                    f"flipped decision whose router probabilities are "
                    f"more than {ROUTE_TIE} apart")
        if fsdp:
            _check_fsdp_rank(where, r, sizes)
        if getattr(cfg, "vocab_parallel", False):
            _check_vp_rank(where, r, cfg, sizes)
        if optimizer.startswith("zero"):
            if r["zero"] != ["dp", int(optimizer[4])]:
                raise AssertionError(f"{where}: ZeRO {r['zero']} for "
                                     f"{optimizer}")
            bad = {m: e for m, e in r["moment_chunk_rel_err"].items()
                   if not e <= tol["grad"]}
            if bad:
                raise AssertionError(f"{where}: Adam moment chunks {bad} "
                                     f"(max |diff| / max |ref chunk|)")
    pp = sizes.get("pp", 1)
    gate = ("bit for bit: step losses, params, mu, nu" if exact
            else dict(tol))
    if fsdp and not exact:
        gate["state"] = f"mu, nu <= {tol['grad']}"
    if optimizer.startswith("zero"):
        gate["moment_chunks"] = tol["grad"]
    if getattr(cfg, "n_experts", 0):
        gate["routing"] = (f"no drop; a flipped decision within {ROUTE_TIE} "
                           f"of its router probabilities")
    vp = {}
    if getattr(cfg, "vocab_parallel", False):
        gate["vocab"] = (f"table rows a rank = {cfg.table_vocab_size} / tp;"
                         f" padded rows' gradient exactly 0; tp generation "
                         f"== one device up to a near-tie (< {F32_GAP})")
        vp = {"vocab": {"vocab_size": cfg.vocab_size,
                        "table_rows": cfg.table_vocab_size,
                        "table_rows_a_rank": ranks[0]["table_rows_a_rank"],
                        "table_mb_a_rank": ranks[0]["table_mb_a_rank"]}}
    return {"phase": "mesh", "run": name, "mesh": sizes,
            "backend": MESH_BACKEND,
            "world_size": len(ranks), "ranks_device": "cuda:0 (shared)",
            "model": (f"{MESH_MODELS[kind][0]} "
                      f"{'bf16 compute, mu bf16' if bf16 else 'f32'}"
                      f" (random init, seed 0), flash attention"),
            "cut": (f"{n_layer} of {16 if kind.startswith('llama') else 12}"
                    f" layers" + (f"; expert capacity {cfg.expert_capacity}"
                                  f" = a micro-batch's tokens (dropless)"
                                  if getattr(cfg, "n_experts", 0)
                                  else "")),
            "fsdp": fsdp,
            "global_rows": rows, "seq_len": MESH_MODELS[kind][1],
            "micro_batches_a_rank": n_micro, "steps": MESH_STEPS,
            "schedule": schedule if pp > 1 else None,
            "layers_a_rank": n_layer // pp,
            "heads_a_rank": _heads(cfg) // sizes.get("tp", 1),
            "optimizer": f"{optimizer} lr 5e-5 wd 0.01 clip 1.0",
            "reference": f"one rank, {rows} rows in {_ref_micro(run)} "
                         f"micro-batches{', bf16' if bf16 else ''}",
            "reference_losses": ref["losses"],
            "single_rank_step_ms": ref["step_ms"],
            "single_rank_peak_memory_gib": ref["peak_memory_gib"],
            **({"sp_mode": opts.get("sp_mode", "ring"),
                "seq_a_rank": MESH_MODELS[kind][1] // sizes["sp"]}
               if sizes.get("sp", 1) > 1 else {}),
            "gate": gate, **vp,
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("launches", "routed")} for r in ranks],
            "launches_a_rank": want_dtype,
            "note": ("collectives staged through host memory by gloo; "
                     "every rank shares one card (not NVLink)"),
            "card": _smi()}


def _check_vp_rank(where, r, cfg, sizes):
    """A vocab-parallel rank: it holds its 1/tp of the table's rows, a
    padded row took no gradient, and its tp generation (where the run
    asked for one) equals one device's up to a near-tie and emitted no
    padding id."""
    tp = sizes.get("tp", 1)
    if r["table_rows_a_rank"] != cfg.table_vocab_size // tp:
        raise AssertionError(f"{where}: {r['table_rows_a_rank']} table rows"
                             f" ({cfg.table_vocab_size} / {tp} expected)")
    if r.get("padded_rows_grad_max", 0.0) != 0.0:
        raise AssertionError(f"{where}: padded rows' gradient "
                             f"{r['padded_rows_grad_max']} (not 0)")
    g = r.get("generate")
    if g is not None:
        bad = [d for d in g["divergences"] if not d["top2_gap"] < F32_GAP]
        if bad or g["padded_ids_emitted"]:
            raise AssertionError(f"{where}: tp generation vs one device: "
                                 f"{g}")


def _check_fsdp_rank(where, r, sizes):
    """An fsdp rank: it holds half of the blocks (every block leaf on dp
    alone; on dp x tp the tp-sharded biases, which have no free dim, stay
    whole). On dp alone the run's gate is bit for bit (the caller's); with
    tp its gathered moments agree with the single-rank run's within the
    gradients' gate."""
    tp = sizes.get("tp", 1)
    frac = r["resident_block_fraction"]
    if not (frac == 0.5 if tp == 1 else 0.5 < frac < 0.51):
        raise AssertionError(f"{where}: holds {frac} of its blocks under "
                             f"fsdp over dp = 2")
    if tp == 1:
        return
    err = r["state_rel_err"]
    bound = MESH_TOL["grad"]
    bad = {p: err[p] for p in ("mu", "nu") if not err[p][1] <= bound}
    if bad:
        raise AssertionError(f"{where}: gathered {bad} (worst leaf, max "
                             f"|diff| / max |ref|) over {bound}")


# ---------------------------------------------------------------------

def _variant_of(by_variant):
    """The one K4 variant a serve run launched."""
    (variant,) = by_variant
    return variant


def _cache_bytecode_in_checkout():
    """Every rank of a mesh run is a fresh interpreter that imports torch
    (and, under the profiler, its compiler stack): where no bytecode can
    be kept beside the sources (a read-only install, or writing it turned
    off) each process compiles ~1,000 modules again, seconds of CPU
    apiece with every rank sharing the host. Keep it in the checkout's
    gitignored ``.pycache/`` instead, for this process and the ranks it
    spawns."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          ".pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import quintnet_tpu_torch  # noqa: F401  (fails here without the repo)

    _cache_bytecode_in_checkout()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *args):
        """Run one phase, its wall seconds into ``walls``, the card's
        cache emptied after it."""
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 3)
        torch.cuda.empty_cache()
        return out

    paged_rows, flash_rows = timed("kernels", phase_kernels)
    serve_res, _, (params, cfg, f32_streams) = timed("serve", phase_serve)
    sampled_res = timed("serve_sampled", phase_serve_sampled, params, cfg,
                        serve_res)
    spec_res = timed("serve_spec", phase_serve_spec, params, cfg)
    chunk_res = timed("serve_chunked", phase_serve_chunked, params, cfg)
    timed("generate", phase_generate, params, cfg)
    _res, kv_runs = timed("serve_kv", phase_serve_kv, params, cfg,
                          f32_streams)
    _res, wq_runs = timed("serve_wq", phase_serve_wq, params, cfg,
                          f32_streams)
    _res, tier_runs = timed("serve_tier", phase_serve_tier, params, cfg)
    _res, lora_runs = timed("serve_lora", phase_serve_lora, params, cfg)
    _res, fleet_runs = timed("serve_fleet", phase_serve_fleet, params, cfg)
    _res, proc_runs = timed("serve_proc_fleet", phase_serve_proc_fleet,
                            params, cfg)
    del params
    torch.cuda.empty_cache()
    llama_serve = timed("serve_llama", phase_serve_llama)
    train_res, train_counts = timed("train", phase_train)
    _res, lora_counts = timed("lora_train", phase_lora_train)
    _res, bf16_counts = timed("train_bf16", phase_train_bf16,
                              train_res["first_loss_flash"])
    llama_res, llama_counts = timed("llama_train", phase_llama_train)
    _res, llama_bf16_counts = timed(
        "llama_train_bf16", phase_llama_train, torch.bfloat16,
        llama_res["first_loss_flash"])
    _res, packed_counts = timed("llama_packed", phase_llama_packed)
    timed("vit", phase_vit)
    resume_res, resume_counts = timed("resume", phase_resume)
    mesh_counts = timed("mesh", phase_mesh)
    _emit({"phase": "walls", "seconds": walls,
           "resume_parts_s": {k: round(v, 3) for k, v in
                              resume_res["seconds"].items()},
           "total_s": round(time.perf_counter() - t_start, 3)})

    def entry(name, source, replaces, launches, rows, head):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"]}

    # each kernel's times at its main path's shape: for paged attention
    # one entry per (variant, path) with the launches of that path in the
    # variant's serve run, timed at the decode shape or at prefill P = 128
    # (start 0); the train micro-batch for flash attention
    # the f32 pool's launches: the greedy and the sampled serve runs, the
    # spec-on runs (verify by its width's path), the chunked and widened
    # document runs, the serving mesh ranks of GPT-2's 12 heads (sp2,
    # ep2), and since slice 19 the packed-weight, host-tier and LoRA runs;
    # since slice 20 the serving fleet's prefills (its decode launches are
    # on the fleet_s4 line, the replicas' 4-slot shape), since slice 21
    # the process fleet's (each replica process's own counts, from its
    # stats reply)
    serve_paged = mesh_counts["serve_paged"]
    f32_runs = ([serve_res["launches_by_path"],
                 sampled_res["launches_by_path"],
                 spec_res["launches_by_path"], serve_paged.get("", {}),
                 {"prefill": fleet_runs["prefill"]},
                 {"prefill": proc_runs["prefill"]}]
                + [r["launches_by_path"] for r in chunk_res["runs"].values()]
                + wq_runs + tier_runs + lora_runs)
    runs = {_variant_of(serve_res["launches_by_variant"]): {
        "by_path": {path: sum(r.get(path, 0) for r in f32_runs)
                    for path in PAGED_SYMBOLS}}}
    for launches in kv_runs.values():
        runs[_variant_of(launches["by_variant"])] = launches
    kernels = []
    for variant, launches in runs.items():
        for path in PAGED_SYMBOLS:
            rows = [r for r in paged_rows if r["variant"] == variant
                    and r["path"] == path and not r["line"]]
            head = next(r for r in rows if r["main"] == path)
            kernels.append(entry(
                f"paged_attention[{variant}, {path}]",
                "quintnet_tpu_torch/ops/csrc/paged_attention.cu",
                "quintnet_tpu/ops/paged_attention.py:91",
                launches["by_path"].get(path, 0), rows, head))
    # the serving slice's shapes: Llama-3.2-1B's GQA (launches of the
    # serve_llama runs) and a tp2 rank's heads (both ranks' K4 launches
    # in serve_tp2, in serve_tp2_llama), each timed at its case ("line")
    by_line = {("f32", tag): launches
               for tag, launches in serve_paged.items() if tag}
    for variant, launches in llama_serve[
            "launches_by_variant_and_path"].items():
        by_line[(variant, "llama_gqa4")] = launches
    by_line[("f32", "fleet_s4")] = {"decode": fleet_runs["decode"]
                                    + proc_runs["decode"]}
    for (variant, tag), launches in by_line.items():
        for path in PAGED_SYMBOLS:
            rows = [r for r in paged_rows if r["line"] == tag
                    and r["variant"] == variant and r["path"] == path]
            if not rows:
                continue
            kernels.append(entry(
                f"paged_attention[{variant}, {path}, {tag}]",
                "quintnet_tpu_torch/ops/csrc/paged_attention.cu",
                "quintnet_tpu/ops/paged_attention.py:91",
                launches.get(path, 0), rows,
                next(r for r in rows if r["main"] == path)))
    for name, replaces in FLASH_KERNELS.items():
        for tag, launches in (("", train_counts[name] + resume_counts[name]
                               + lora_counts[name]
                               + llama_counts[name] + packed_counts[name]
                               + mesh_counts["f32"].get(name, 0)),
                              ("[bf16]", bf16_counts[name]
                               + llama_bf16_counts[name]
                               + mesh_counts["bf16"].get(name, 0))):
            rows = [r for r in flash_rows if r["kernel"] == name + tag]
            kernels.append(entry(
                name + tag, "quintnet_tpu_torch/ops/csrc/flash_attention.cu",
                replaces, launches, rows,
                next(r for r in rows if r["case"] == TRAIN_CASE)))
    _emit({"kernels": kernels})
    print(_smi(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
