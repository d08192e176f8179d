"""PyTorch/CUDA port of ``enarf_gan_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``nn/``, ``geometry/``, ``nerf/``, ``models/``) and its names, so
each function here has a counterpart of the same name there. Plain tensor
code is PyTorch; every Pallas kernel on a ported path is a hand-written
Hopper kernel under ``csrc/`` with a plain PyTorch twin beside its wrapper.

Ported so far: DSO training (``training.dso.train_loop``) and DSO
full-image rendering (``models.generator.make_dso_full_renderer``), each
with the exact (unirow) sampler, on bf16 or float32 planes, and with the
patch-tiled (tilewin) sampler on bf16 planes, and their CLIs
(``python -m enarf_gan_tpu_torch.train_DSO``, ``... .DSO_demo``); ENARF-GAN
training and sampling (``training.gan``); the combines' kernels have
backward kernels. Weights load from the
reference-named state dict that
``enarf_gan_tpu.training.checkpoint.export_reference_state_dict`` writes
(``interop.load_reference_state_dict``), and the port's ``torch.save``
snapshots use the same names.

Models and layers are built on ``DEFAULT_DEVICE``, the GPU, unless the
caller names another device (``device="cpu"``); without a GPU, building
on the default fails. Nothing falls back to the CPU.

Nothing here imports jax, flax, PyYAML or PIL: ``config.py`` reads the
YAML configs and ``utils/logging.py`` writes the PNGs itself.
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


def use_full_float32() -> None:
    """Full float32 in matmuls and convolutions on the card (cuDNN
    defaults to TF32 for convolutions): the precision the JAX package's
    float32 runs hold. The CLIs and ``chip_smoke.py`` call it where a run
    enters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
