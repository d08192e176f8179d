"""PyTorch/CUDA port of ``enarf_gan_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``nn/``, ``geometry/``, ``nerf/``, ``models/``) and its names, so
each function here has a counterpart of the same name there. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a hand-written
Hopper kernel under ``csrc/`` with a plain PyTorch twin beside its wrapper.

Ported so far: DSO full-image rendering with the exact (unirow) sampler and
with the patch-tiled (tilewin) sampler, both entered through
``models.generator.make_dso_full_renderer``. Weights load from the
reference-named state dict that
``enarf_gan_tpu.training.checkpoint.export_reference_state_dict`` writes
(``interop.load_reference_state_dict``).

Models and layers are built on ``DEFAULT_DEVICE``, the GPU, unless the
caller names another device (``device="cpu"``); without a GPU, building
on the default fails. Nothing falls back to the CPU.

Nothing here imports jax, flax, yaml or PIL.
"""
import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    this machine has none (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the GPU by default; pass "
            "device='cpu' to build on the CPU")
    return device
