"""The port imports none of jax, flax, yaml, PIL or torchvision, directly
or through the JAX package, the JAX probes of ``tools/`` or the JAX
evaluation scripts of ``evaluation/``: a fresh interpreter that
refuses those imports must import every module of ``enarf_gan_tpu_torch``
(its ``tools`` subpackage and the CLIs included) and ``chip_smoke.py``, read
a config pair with ``config.yaml_config`` and write and read a PNG."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "yaml", "PIL", "enarf_gan_tpu", "tools",
           "evaluation", "torchvision")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import enarf_gan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(enarf_gan_tpu_torch.__path__,
                                               "enarf_gan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from enarf_gan_tpu_torch.config import yaml_config
from enarf_gan_tpu_torch.utils.logging import decode_png, encode_png
import numpy as np
c = yaml_config("configs/DSO_train/ZJU/313_denarf.yml",
                "configs/DSO_train/default.yml")
assert c.generator_params.nerf_params.Nf == 64, c
rgb = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
assert (decode_png(encode_png(rgb)) == rgb).all()
print(" ".join(names))
"""


def test_port_imports_without_jax_flax_yaml_pil():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(proc.stdout.split())
    assert len(names) >= 40, proc.stdout
    for module in ("ops.unirow", "ops.tilewin", "ops.tilewin_kernel",
                   "nerf.rendering", "nerf.tiled", "nerf.ray_sampler",
                   "models.generator", "config", "eval_lib.metrics",
                   "utils.logging", "training.checkpoint", "training.dso",
                   "training.gan", "training.losses", "nn.stylegan2",
                   "interop", "data.cache", "data.mask2d",
                   "data.datasets", "data.loader", "data.fixtures",
                   "tools", "tools.timing", "tools.gather", "tools.mma",
                   "tools.ablate", "tools.constructs", "ops.quadtable",
                   "train_DSO", "DSO_demo", "train_ENARF_GAN",
                   "ENARF_GAN_demo", "mesh.extract", "mesh.raster",
                   "eval_lib", "eval_lib.fid", "eval_lib.inception",
                   "eval_lib.lpips", "evaluation", "evaluation.common",
                   "evaluation.compute_fid", "evaluation.compute_PCK",
                   "evaluation.compute_depth",
                   "evaluation.pck_estimators", "models.narf",
                   "models.nerf", "ops.triplane", "ops.grid_sample",
                   "nn.layers"):
        assert f"enarf_gan_tpu_torch.{module}" in names, module
