"""Checkpoints as ``torch.save`` snapshots (port of the save/load half of
``enarf_gan_tpu/training/checkpoint.py``).

A snapshot is ``{"iteration", "gen": gen.state_dict(), "gen_opt":
optimizer.state_dict()}``, written as ``snapshot_latest.pth`` and the
rolling ``snapshot_{(iteration // 50000 + 1) * 50000}.pth``, the JAX
package's cadence. The port's parameter names are the reference's, so the
JAX package's ``convert_torch_snapshot`` reads these files.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

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
