"""Weight bridge between the JAX package and the port.

The port's modules are named after the reference checkpoint's keys, the
same keys ``enarf_gan_tpu.training.checkpoint.export_reference_state_dict``
writes for a JAX model (``nerf.tri_plane``, ``nerf.canonical_pose``,
``nerf.flow_generator.synthesis.b8.conv0.weight``,
``nerf.tri_plane_gen.mapping.fc0.weight``, ``nerf.mlp.layers.0.bias``,
``background_generator.convs.0.noise.weight``, ...). So the bridge is a
strict ``load_state_dict`` of that dict of numpy arrays; the reverse is the
port's own ``state_dict()``.

The JAX ``stats`` collection (each mapping network's ``w_avg``, the centre
of truncation) is not in reference checkpoints; ``load_jax_stats`` carries
it. The discriminator has no reference names in the JAX package:
``load_flax_discriminator`` loads its flax parameters, flattened.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

# JAX stats path → the port's buffer (the tri-plane generator is
# ``generator`` in the JAX model, ``tri_plane_gen`` in the reference's)
_STATS_NAMES = {
    "nerf/generator/mapping/w_avg": "nerf.tri_plane_gen.mapping.w_avg",
    "nerf/flow_generator/mapping/w_avg": "nerf.flow_generator.mapping.w_avg",
    "background_generator/mapping/w_avg": "background_generator.w_avg",
}


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _flatten(tree, prefix=()):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def load_reference_state_dict(module: nn.Module,
                              state_dict: Mapping[str, np.ndarray]) -> None:
    """Copy reference-named numpy arrays into ``module`` (on its device);
    every key must match, both ways."""
    module.load_state_dict(
        {k: _tensor(v) for k, v in state_dict.items()}, strict=True)


def load_jax_stats(module: nn.Module, stats) -> None:
    """Copy the JAX ``stats`` collection (nested dicts of arrays, or one
    flat dict with "/"-joined paths) into the port's ``w_avg`` buffers;
    every statistic and every buffer must match."""
    buffers = dict(module.named_buffers())
    flat = _flatten(stats)
    targets = {_STATS_NAMES.get(k): v for k, v in flat.items()}
    if None in targets:
        raise KeyError(f"unknown JAX statistics: {sorted(set(flat) - set(_STATS_NAMES))}")
    wanted = {n for n in buffers if n.endswith("w_avg")}
    if set(targets) != wanted:
        raise KeyError(f"statistics {sorted(targets)} != buffers {sorted(wanted)}")
    with torch.no_grad():
        for name, v in targets.items():
            buffers[name].copy_(_tensor(v))


def load_flax_discriminator(dis: nn.Module,
                            params: Mapping[str, np.ndarray]) -> None:
    """The JAX ``Discriminator``'s flax parameters, flattened to
    "/"-joined paths (``res7/conv1/conv/weight``), into the port's
    ``Discriminator``, whose names are the paths with dots; strict both
    ways."""
    dis.load_state_dict({k.replace("/", "."): _tensor(v)
                         for k, v in _flatten(params).items()}, strict=True)
