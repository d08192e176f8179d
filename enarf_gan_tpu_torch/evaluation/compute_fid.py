"""FID of the GAN on the port (the counterpart of
``evaluation/compute_fid.py``).

    INCEPTION_WEIGHTS_NPZ=<npz, or random[:<seed>]> \
    python -m enarf_gan_tpu_torch.evaluation.compute_fid \
        --config configs/enarfgan_train/AIST/config.yml \
        --default_config configs/enarfgan_train/default.yml \
        [--iteration N] [--truncation 1.0] [--black_bg] [--num_sample 10000]
        [--batch_size 16] [--device cpu]

The real images' statistics: ``num_sample`` images of
``dataset.train.data_root`` (loader seed 0), cached there as
``fid_stats_<size>_<weight tag>.npz`` (the tag as the JAX package keys
it: the npz's name, ``random:<seed>``, or ``torchvision``). The generated
images: the latest snapshot (or ``--iteration``'s) under
``<out_root>/result/<out>`` renders poses of the pose prior (loader seed
1; z, the fine sampler and the background from a ``torch.Generator``
seeded 0), over a black background with ``--black_bg``, clipped to
[-1, 1] and mapped to [0, 255]. Both are resized to 299² and go through
InceptionV3 on the card (``--device`` names another device). Writes
``fid{_trunc<t>}.txt`` there.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, use_full_float32
from enarf_gan_tpu_torch.config import AttrDict, yaml_config
from enarf_gan_tpu_torch.data.datasets import HumanDataset, HumanPoseDataset
from enarf_gan_tpu_torch.data.loader import DataLoader, infinite_batches
from enarf_gan_tpu_torch.eval_lib.fid import (compute_statistics,
                                              frechet_distance,
                                              load_or_compute_dataset_stats,
                                              make_inception_extractor,
                                              resize_bilinear_299,
                                              weights_source)
from enarf_gan_tpu_torch.evaluation.common import (load_generator,
                                                   out_dir_of, render_batch,
                                                   truncation_suffix)


def stats_cache_path(data_root: str, size: int, weights_npz: str) -> str:
    """The real images' statistics file, keyed by the weight set as the
    JAX package keys it: the npz's base name without its extension,
    ``random[:<seed>]`` as it is, ``torchvision`` where none is named."""
    tag = os.path.splitext(os.path.basename(weights_npz))[0] \
        if weights_npz else "torchvision"
    return os.path.join(data_root, f"fid_stats_{size}_{tag}.npz")


def evaluate(config, device=DEFAULT_DEVICE, iteration: int = -1,
             truncation: float = 1.0, black_bg: bool = False,
             num_sample: int = 10000, batch_size: int = 16) -> float:
    """The FID of the config's snapshot, written to ``fid{_trunc<t>}.txt``;
    returns it."""
    size = config.dataset.image_size
    data_root = config.dataset.train.data_root
    pose_ds = HumanPoseDataset(size=size, data_root=data_root,
                               num_repeat_in_epoch=1)
    img_ds = HumanDataset(AttrDict({"data_root": data_root}), size=size,
                          return_bone_params=False, num_repeat_in_epoch=1)
    gen = load_generator(config, pose_ds.num_bone, pose_ds.parents,
                         pose_ds.canonical_pose, device,
                         iteration)
    extractor = make_inception_extractor(batch_size=batch_size,
                                         device=device)

    def real_feature_iter():
        loader = DataLoader(img_ds, batch_size, shuffle=True, drop_last=True,
                            seed=0)
        count = 0
        for batch in loader:
            imgs = torch.from_numpy(batch["img"]).to(device) * 127.5 + 127.5
            yield extractor(resize_bilinear_299(imgs))
            count += len(imgs)
            if count >= num_sample:
                break

    mu_real, sigma_real = load_or_compute_dataset_stats(
        stats_cache_path(data_root, size, weights_source()),
        real_feature_iter)

    rng = torch.Generator(device=device).manual_seed(0)
    pose_loader = infinite_batches(DataLoader(pose_ds, batch_size,
                                              shuffle=True, drop_last=True,
                                              seed=1))
    feats = []
    n_done = 0
    for batch in pose_loader:
        img, _, _ = render_batch(gen, batch, rng, truncation,
                                 black_bg_if_possible=black_bg)
        img = img.clamp(-1, 1) * 127.5 + 127.5
        feats.append(extractor(resize_bilinear_299(img)))
        n_done += len(img)
        if n_done >= num_sample:
            break
    feats = np.concatenate(feats)[:num_sample]
    mu_f, sigma_f = compute_statistics(feats)
    fid = frechet_distance(mu_f, sigma_f, mu_real, sigma_real)
    path = os.path.join(out_dir_of(config),
                        f"fid{truncation_suffix(truncation)}.txt")
    with open(path, "w") as f:
        f.write(f"{fid}")
    print(path, fid)
    return fid


def main(argv: Optional[Sequence[str]] = None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/AIST/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--black_bg", action="store_true")
    parser.add_argument("--num_sample", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    use_full_float32()
    config = yaml_config(args.config, args.default_config,
                         num_workers=args.num_workers)
    return evaluate(config, torch.device(args.device), args.iteration,
                    args.truncation, args.black_bg, args.num_sample,
                    args.batch_size)


if __name__ == "__main__":
    main()
