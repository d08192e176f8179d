"""Weight bridge between the JAX package and the port.

The port's modules are named after the reference checkpoint's keys, the
same keys ``enarf_gan_tpu.training.checkpoint.export_reference_state_dict``
writes for a JAX model (``nerf.tri_plane``, ``nerf.canonical_pose``,
``nerf.flow_generator.synthesis.b8.conv0.weight``,
``nerf.tri_plane_gen.mapping.fc0.weight``, ``nerf.mlp.layers.0.bias``,
``background_generator.convs.0.noise.weight``, ...). So the bridge is a
strict ``load_state_dict`` of that dict of numpy arrays; the reverse is the
port's own ``state_dict()``.

The JAX reference key map leaves out ``MLPNARF``'s ``density_mlp`` and
``deformation_field``: ``load_reference_state_dict`` loads those from the
JAX model's flax parameters (``nerf_flax_params``, through
``flax_mlp_narf_state``) with the rest, and ``export_flax_mlp_narf``
writes them back. The JAX ``stats`` collection (each mapping network's ``w_avg``, the
centre of truncation) is not in reference checkpoints; ``load_jax_stats``
carries it. The discriminator has no reference names in the JAX package:
``load_flax_discriminator`` loads its flax parameters, flattened.
``load_flax_pretrained_background`` loads the JAX ``PretrainedStyleGAN``'s
subtree into the port's, whose names are rosinality's.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

# JAX stats path → the port's buffers it may be (the tri-plane generator is
# ``generator`` in the JAX model; the reference names the default variant's
# ``tri_plane_gen`` and constant_trimask's and selector_mlp's ``generator``)
_STATS_NAMES = {
    "nerf/generator/mapping/w_avg": ("nerf.tri_plane_gen.mapping.w_avg",
                                     "nerf.generator.mapping.w_avg"),
    "nerf/flow_generator/mapping/w_avg": (
        "nerf.flow_generator.mapping.w_avg",),
    "background_generator/mapping/w_avg": ("background_generator.w_avg",),
    "background_generator/gen/mapping/w_avg": (
        "background_generator.gen.w_avg",),
}
# MLPNARF's submodules that the reference key map leaves out
FLAX_ONLY = ("density_mlp", "deformation_field")


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
                              state_dict: Mapping[str, np.ndarray],
                              nerf_flax_params=None) -> None:
    """Copy reference-named numpy arrays into ``module`` (on its device);
    every key must match, both ways. An MLP NARF generator's
    ``density_mlp`` and ``deformation_field``, which reference names leave
    out, come from ``nerf_flax_params``: the JAX model's ``nerf``
    parameters (``flax_mlp_narf_state``)."""
    state = {k: _tensor(v) for k, v in state_dict.items()}
    if nerf_flax_params is not None:
        state.update({f"nerf.{k}": v for k, v in
                      flax_mlp_narf_state(nerf_flax_params).items()})
    module.load_state_dict(state, strict=True)


def load_jax_stats(module: nn.Module, stats) -> None:
    """Copy the JAX ``stats`` collection (nested dicts of arrays, or one
    flat dict with "/"-joined paths) into the port's ``w_avg`` buffers;
    every statistic and every buffer must match."""
    buffers = dict(module.named_buffers())
    flat = _flatten(stats)
    unknown = sorted(set(flat) - set(_STATS_NAMES))
    if unknown:
        raise KeyError(f"unknown JAX statistics: {unknown}")
    targets = {next((n for n in _STATS_NAMES[k] if n in buffers),
                    _STATS_NAMES[k][0]): v for k, v in flat.items()}
    wanted = {n for n in buffers if n.endswith("w_avg")}
    if set(targets) != wanted:
        raise KeyError(f"statistics {sorted(targets)} != buffers {sorted(wanted)}")
    with torch.no_grad():
        for name, v in targets.items():
            buffers[name].copy_(_tensor(v))


def _styled_leaf(rest: str, v: np.ndarray):
    """A flax ``StyledConv1d`` leaf → (the port's name, array): conv
    weights (1, out, in) gain a trailing 1, biases become (1, out, 1)."""
    if rest == "conv/weight":
        return "conv.weight", v[..., None]
    if rest == "bias":
        return "bias", v.reshape(1, -1, 1)
    return rest.replace("/", "."), v


def flax_mlp_narf_state(params) -> dict:
    """The JAX ``MLPNARF``'s ``density_mlp`` and ``deformation_field``
    leaves of its flax parameters (nested, or flattened to "/"-joined
    paths; other leaves are skipped) under the port's names relative to
    ``MLPNARF``: an ``MLP``'s ``EqualConv1d_{i}/weight`` keeps its path
    and shape, a ``StyledMLP``'s ``StyledConv1d_{i}/...`` (tnarf) becomes
    ``layers.{i}.*`` with the reference's shapes."""
    out = {}
    for path, v in _flatten(params).items():
        module, layer, rest = (path.split("/", 2) + ["", ""])[:3]
        if module not in FLAX_ONLY:
            continue
        v = np.asarray(v, np.float32)
        if layer.startswith("StyledConv1d_"):
            leaf, v = _styled_leaf(rest, v)
            key = f"{module}.layers.{layer.split('_')[-1]}.{leaf}"
        else:
            key = f"{module}.{layer}.{rest.replace('/', '.')}"
        out[key] = _tensor(v)
    return out


def export_flax_mlp_narf(nerf: nn.Module) -> dict:
    """The inverse of ``flax_mlp_narf_state``: the port's ``density_mlp``
    and ``deformation_field`` as the JAX model's flattened flax paths
    ({"density_mlp/EqualConv1d_0/weight": array, ...})."""
    out = {}
    for name in FLAX_ONLY:
        if not hasattr(nerf, name):
            continue
        for key, v in getattr(nerf, name).state_dict().items():
            v = v.detach().cpu().numpy()
            if key.startswith("layers."):
                _, i, leaf = key.split(".", 2)
                layer = f"StyledConv1d_{i}"
                if leaf == "conv.weight":
                    v = v[..., 0]
                elif leaf == "bias":
                    v = v.reshape(-1)
                out[f"{name}/{layer}/{leaf.replace('.', '/')}"] = v
            else:
                out[f"{name}/{key.replace('.', '/')}"] = v
    return out


def load_flax_discriminator(dis: nn.Module,
                            params: Mapping[str, np.ndarray]) -> None:
    """The JAX ``Discriminator``'s flax parameters, flattened to
    "/"-joined paths (``res7/conv1/conv/weight``), into the port's
    ``Discriminator``, whose names are the paths with dots; strict both
    ways."""
    dis.load_state_dict({k.replace("/", "."): _tensor(v)
                         for k, v in _flatten(params).items()}, strict=True)


def _ros_module(name: str) -> str:
    """A JAX synthesis child of the rosinality generator → the port's
    module: const, conv1, to_rgb1, conv_up{r}, conv{r}, to_rgb{r}."""
    fixed = {"const": "input", "conv1": "conv1", "to_rgb1": "to_rgb1"}
    if name in fixed:
        return fixed[name]
    for prefix, fmt in (("conv_up", "convs.{}"), ("to_rgb", "to_rgbs.{}"),
                        ("conv", "convs.{}")):
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            r = int(name[len(prefix):])
            index = {"conv_up": 2 * (r - 3), "to_rgb": r - 3,
                     "conv": 2 * (r - 3) + 1}[prefix]
            return fmt.format(index)
    raise KeyError(f"unknown synthesis layer {name}")


def _ros_leaf(module: str, up: bool, leaf: str, v: np.ndarray):
    """(port name, array in the port's orientation) of one leaf: conv
    weights gain rosinality's leading 1 (up-convolutions flipped in both
    spatial axes), biases become (1, C, 1, 1), noise weights (1,)."""
    if module == "input":
        return "input.input", v
    if leaf == "conv/weight":
        w = v[..., ::-1, ::-1] if up else v
        return f"{module}.conv.weight", np.ascontiguousarray(w)[None]
    if leaf == "bias":
        return f"{module}.bias", v.reshape(1, -1, 1, 1)
    if leaf == "noise_weight":
        return f"{module}.noise.weight", v.reshape(1)
    if leaf in ("conv/modulation/weight", "conv/modulation/bias"):
        return f"{module}.{leaf.replace('/', '.')}", v
    raise KeyError(f"unknown leaf {module}/{leaf}")


def load_flax_pretrained_background(module: nn.Module, params,
                                    stats=None) -> None:
    """The JAX ``PretrainedStyleGAN``'s parameters (its subtree,
    {"gen": {"mapping": ..., "synthesis": ...}}, numpy or jax arrays) and,
    if given, its statistics ({"gen": {"mapping": {"w_avg"}}}) into the
    port's ``PretrainedStyleGAN``; strict both ways."""
    state = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        gen, part, *rest = path.split("/")
        if gen != "gen":
            raise KeyError(f"unknown background parameter {path}")
        if part == "mapping":
            layer, leaf = rest
            state[f"style.{int(layer[2:]) + 1}.{leaf}"] = v
            continue
        name = _ros_module(rest[0])
        key, arr = _ros_leaf(name, rest[0].startswith("conv_up"),
                             "/".join(rest[1:]), v)
        state[key] = arr
    module.gen.load_state_dict({k: _tensor(v) for k, v in state.items()},
                               strict=True)
    if stats is not None:
        with torch.no_grad():
            module.gen.w_avg.copy_(
                _tensor(_flatten(stats)["gen/mapping/w_avg"]))
