"""Disparity MSE of the GAN on the port against SURREAL's inverse depth
(the counterpart of ``evaluation/compute_depth.py``).

    python -m enarf_gan_tpu_torch.evaluation.compute_depth \
        [--surreal_path data/surreal] \
        [--config configs/enarfgan_train/SURREAL/config.yml] \
        [--default_config configs/enarfgan_train/default.yml] \
        [--iteration N] [--truncation 1.0] [--num_sample 10000]
        [--batch_size 4] [--device cpu]

Renders the poses of ``<surreal_path>/NARF_GAN_depth_cache`` (loader seed
0; z, the fine sampler and the background from a ``torch.Generator``
seeded 0) through the latest snapshot (or ``--iteration``'s) under
``<out_root>/result/<out>`` on the card (``--device`` names another
device) with their disparity, and writes the mean squared difference to
the ground-truth disparity over ``num_sample`` images' worth of pixels to
``disparity_mse{_trunc<t>}.txt`` there.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, use_full_float32
from enarf_gan_tpu_torch.config import AttrDict, yaml_config
from enarf_gan_tpu_torch.data.datasets import SurrealPoseDepthDataset
from enarf_gan_tpu_torch.data.loader import DataLoader, infinite_batches
from enarf_gan_tpu_torch.evaluation.common import (load_generator,
                                                   out_dir_of, render_batch,
                                                   truncation_suffix)


def disparity_se(gen_disp: np.ndarray, gt: np.ndarray) -> Tuple[float, int]:
    """One batch's sum of squared disparity differences and its pixel
    count."""
    return ((gen_disp - gt) ** 2).sum(), gt.size


def evaluate(config, surreal_path: str = "data/surreal",
             device=DEFAULT_DEVICE, iteration: int = -1,
             truncation: float = 1.0, num_sample: int = 10000,
             batch_size: int = 4) -> float:
    """The disparity MSE of the config's snapshot, written to
    ``disparity_mse{_trunc<t>}.txt``; returns it."""
    size = config.dataset.image_size
    ds = SurrealPoseDepthDataset(
        AttrDict({"data_root": f"{surreal_path}/NARF_GAN_depth_cache"}),
        size=size)
    gen = load_generator(config, ds.num_bone, ds.parents,
                         ds.canonical_pose, device, iteration)
    rng = torch.Generator(device=device).manual_seed(0)
    loader = infinite_batches(DataLoader(ds, batch_size, shuffle=True,
                                         drop_last=True, seed=0))
    se_sum, count = 0.0, 0
    for batch in loader:
        _, _, aux = render_batch(gen, batch, rng, truncation,
                                 return_disparity=True)
        se, n = disparity_se(aux["disparity"].cpu().numpy(),
                             np.asarray(batch["img"]))
        se_sum += se
        count += n
        if count / (size * size) >= num_sample:
            break
    disp_mse = float(se_sum / count)
    path = os.path.join(out_dir_of(config),
                        f"disparity_mse{truncation_suffix(truncation)}.txt")
    with open(path, "w") as f:
        f.write(f"{disp_mse}")
    print(path, disp_mse)
    return disp_mse


def main(argv: Optional[Sequence[str]] = None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--surreal_path", type=str, default="data/surreal")
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/SURREAL/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--num_sample", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    use_full_float32()
    config = yaml_config(args.config, args.default_config,
                         num_workers=args.num_workers)
    return evaluate(config, args.surreal_path, torch.device(args.device),
                    args.iteration, args.truncation, args.num_sample,
                    args.batch_size)


if __name__ == "__main__":
    main()
