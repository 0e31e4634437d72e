"""QuintNet on PyTorch + CUDA: the port of ``quintnet_tpu`` to NVIDIA Hopper.

The package mirrors the subpackage and module names of the JAX package
(``core``, ``nn``, ``ops``, ``models``, ``train``, ``ft``, ``serve``, ...), so each
module's reference twin is easy to find. It imports ``torch`` and never
``jax``, and nothing of ``quintnet_tpu``: where the port needs a piece
of a JAX-package module, it keeps its own copy.

Parameters keep the JAX pytree layout (nested dicts; GPT-2 blocks
stacked ``[L, ...]``; linear weights ``[in, out]``), so
:mod:`quintnet_tpu_torch.bridge` is one function each way and the
parity tests compare like with like.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; asking for CUDA where there is none raises
(:func:`quintnet_tpu_torch.core.device.resolve_device`) — nothing falls
back to the CPU silently. Every Pallas kernel of the JAX package on a
ported path is a hand-written CUDA kernel under ``ops/csrc/``, built
with ``nvcc`` at first use (``ops/build.py``); its plain PyTorch twin
lives beside it and is what a CPU tensor runs through.

What is ported so far: GPT-2 paged serving (``serve.ServeEngine`` over
``ops/csrc/paged_attention.cu``), GPT-2 and ViT training on one device
(``train.Trainer``; GPT-2's flash attention over
``ops/csrc/flash_attention.cu``), and checkpoints with step-granular
resume (``train.checkpoint``, ``ft``). ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"
