"""ENARF-GAN training CLI of the port (the counterpart of
``train_ENARF_GAN.py``).

    python -m enarf_gan_tpu_torch.train_ENARF_GAN \
        --config configs/enarfgan_train/AIST/config.yml \
        --default_config configs/enarfgan_train/default.yml \
        [--resume_latest] [--iterations N] [--device cpu]

Trains the config's generator and discriminator on the card (``--device``
names another device) over the real images of ``dataset.train.data_root``
and the poses of ``dataset.train.pose_prior_root`` (or the data root), and
writes ``snapshot_latest.pth`` (every ``save_interval`` iterations and
after the last one), ``iter_10_succeeded.txt``, the image grids
``rgb_<k>.png``, ``real.png`` and ``bone_<k>.png`` and ``command.txt``
under ``<out_root>/result/<out>``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, use_full_float32
from enarf_gan_tpu_torch.config import yaml_config
from enarf_gan_tpu_torch.data.datasets import HumanDataset, HumanPoseDataset
from enarf_gan_tpu_torch.data.loader import DataLoader
from enarf_gan_tpu_torch.training import gan


def create_dataset(config_dataset):
    """The real images (without bone parameters) and the pose prior."""
    size = config_dataset.image_size
    train_cfg = config_dataset.train
    print("loading datasets")
    img_dataset = HumanDataset(train_cfg, size=size, return_bone_params=False)
    pose_prior_root = train_cfg.get("pose_prior_root") or train_cfg.data_root
    print("pose prior:", pose_prior_root)
    pose_dataset = HumanPoseDataset(size=size, data_root=pose_prior_root)
    return img_dataset, pose_dataset


def create_dataloader(config_dataset):
    img_dataset, pose_dataset = create_dataset(config_dataset)
    bs = config_dataset.bs
    loader_img = DataLoader(img_dataset, bs, shuffle=True, drop_last=True,
                            seed=0)
    loader_pose = DataLoader(pose_dataset, bs, shuffle=True, drop_last=True,
                             seed=1)
    return (img_dataset, pose_dataset), (loader_img, loader_pose)


def train(config, device=DEFAULT_DEVICE, iterations: Optional[int] = None):
    """Train the config's GAN for ``iterations`` (default ``num_iter``)
    iterations; returns what ``training.gan.train_loop`` returns."""
    datasets, loaders = create_dataloader(config.dataset)
    _, pose_dataset = datasets
    gen, dis = gan.build_models(config, pose_dataset.num_bone,
                                pose_dataset.parents, device)
    return gan.train_loop(config, gen, dis, datasets, loaders,
                          pose_dataset.canonical_pose,
                          max_iterations=iterations)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configs/enarfgan_train/AIST/config.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/enarfgan_train/default.yml")
    parser.add_argument("--resume_latest", action="store_true")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--iterations", type=int, default=None,
                        help="override num_iter (smoke runs)")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    config = yaml_config(args.config, args.default_config, args.resume_latest,
                         args.num_workers)
    device = torch.device(args.device)
    use_full_float32()
    return train(config, device, args.iterations)


if __name__ == "__main__":
    main()
