"""Checkpoints as ``torch.save`` snapshots (port of the save/load half of
``enarf_gan_tpu/training/checkpoint.py``).

A DSO snapshot is ``{"iteration", "gen": gen.state_dict(), "gen_opt":
optimizer.state_dict()}``; a GAN snapshot ``{"iteration", "gen", "dis",
"gen_opt", "dis_opt"}``, its "gen" holding the mapping networks' ``w_avg``
beside the parameters (``gen_state_dict``). Both are written as
``snapshot_latest.pth`` and the rolling
``snapshot_{(iteration // 50000 + 1) * 50000}.pth``, the JAX package's
cadence. The port's parameter names are the reference's, so the JAX
package's ``convert_torch_snapshot`` reads these files.

``load_pretrained_background`` loads converted stylegan2-church weights
into a GAN generator's ``PretrainedStyleGAN``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

LATEST = "snapshot_latest.pth"


def save_checkpoint(out_dir: str, state: Dict[str, Any], iteration: int,
                    rolling_every: int = 50000) -> str:
    """Write snapshot_latest.pth (atomically) and the rolling snapshot."""
    os.makedirs(out_dir, exist_ok=True)
    latest = os.path.join(out_dir, LATEST)
    tmp = latest + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, latest)
    rolling = os.path.join(
        out_dir, f"snapshot_{(iteration // rolling_every + 1) * rolling_every}.pth")
    torch.save(state, rolling)
    return latest


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The snapshot's dict, tensors on ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(out_dir: str) -> Optional[str]:
    p = os.path.join(out_dir, LATEST)
    return p if os.path.exists(p) else None


def w_avg_buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The truncation centres of ``module``'s mapping networks, by name
    (buffers kept out of ``state_dict``, as reference checkpoints hold
    none)."""
    return {n: b for n, b in module.named_buffers() if n.endswith("w_avg")}


def gen_state_dict(gen: nn.Module) -> Dict[str, torch.Tensor]:
    """``gen.state_dict()`` plus its ``w_avg`` buffers."""
    return {**gen.state_dict(),
            **{n: b.detach().clone() for n, b in w_avg_buffers(gen).items()}}


def load_gen_state_dict(gen: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load what ``gen_state_dict`` wrote; strict both ways."""
    stats = w_avg_buffers(gen)
    if set(stats) - set(state):
        raise KeyError(f"snapshot lacks {sorted(set(stats) - set(state))}")
    gen.load_state_dict({k: v for k, v in state.items() if k not in stats},
                        strict=True)
    with torch.no_grad():
        for n, b in stats.items():
            b.copy_(state[n])


def load_pretrained_background(gen: nn.Module,
                               arrays: Mapping[str, np.ndarray]
                               ) -> Dict[str, List[str]]:
    """Converted stylegan2-church weights into ``gen.background_generator``
    (a ``PretrainedStyleGAN``), as the JAX function of this name.

    ``arrays`` maps raw rosinality ``g_ema`` names to numpy arrays (the npz
    that ``data_preprocess/convert_stylegan2_church.py`` writes; an
    ``np.load`` result works). The port's background carries rosinality's
    names and orientations, so each parameter loads by name; a styled
    conv's bias also loads from the legacy flat ``.activate.bias``. Every
    parameter of the background must be given and of its shape, or this
    raises before anything is loaded; names the background does not take
    (rosinality's noise buffers) are reported. The background stays frozen.
    Returns {"mapped": [...], "missing": [], "unused": [...]}."""
    params = dict(gen.background_generator.gen.named_parameters())
    legacy = {k.replace(".activate.bias", ".bias"): k
              for k in arrays if k.endswith(".activate.bias")}
    source = {name: name if name in arrays else legacy.get(name)
              for name in params}
    missing = [name for name, src in source.items() if src is None]
    if missing:
        raise ValueError(f"unmapped background parameters: {missing[:10]}")
    loaded = {}
    for name, src in source.items():
        arr = np.asarray(arrays[src], np.float32)
        want = tuple(params[name].shape)
        if src != name and arr.size == params[name].numel():
            arr = arr.reshape(want)
        if arr.shape != want:
            raise ValueError(f"shape mismatch loading {src} -> {name}: "
                             f"{arr.shape} vs {want}")
        loaded[name] = torch.from_numpy(arr)
    with torch.no_grad():
        for name, value in loaded.items():
            params[name].copy_(value)
    return {"mapped": sorted(params), "missing": [],
            "unused": sorted(set(arrays) - set(source.values()))}
