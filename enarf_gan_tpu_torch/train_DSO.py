"""DSO training CLI of the port (the counterpart of ``train_DSO.py``).

    python -m enarf_gan_tpu_torch.train_DSO \
        --config configs/DSO_train/ZJU/313_denarf.yml \
        --default_config configs/DSO_train/default.yml \
        [--resume_latest] [--validation] [--iterations N] [--device cpu]

Trains on the card (``--device`` names another device) and writes
``snapshot_latest.pth`` (every ``save_interval`` iterations and after the
last one), ``log.json`` and the validation images under
``<out_root>/result/<out>``. ``--validation`` instead loads the latest
snapshot (or ``resume``) and writes ``val_metrics.json``: PSNR and SSIM of
every frame of the validation sets, each cropped to its mask's bounding
box (LPIPS waits for its weights).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE, use_full_float32
from enarf_gan_tpu_torch.config import yaml_config
from enarf_gan_tpu_torch.data.datasets import SSODataset
from enarf_gan_tpu_torch.data.loader import DataLoader
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training import dso
from enarf_gan_tpu_torch.utils.logging import record_command

VAL_METRICS = ("PSNR", "SSIM")


def create_dataset(config_dataset):
    """The training set and the validation sets that have a data root."""
    size = config_dataset.image_size
    print("loading datasets")
    dataset_train = SSODataset(config_dataset.train, size=size,
                               return_bone_params=True,
                               load_camera_intrinsics=True)
    datasets_val = {
        key: SSODataset(cfg, size=size, return_bone_params=True,
                        num_repeat_in_epoch=1, load_camera_intrinsics=True)
        for key, cfg in config_dataset.get("val", {}).items()
        if cfg.data_root is not None}
    return dataset_train, datasets_val


def create_dataloader(config_dataset):
    dataset_train, datasets_val = create_dataset(config_dataset)
    train_loader = DataLoader(dataset_train, config_dataset.bs, shuffle=True,
                              drop_last=True)
    val_loaders = {k: DataLoader(v, 1, shuffle=False, drop_last=False)
                   for k, v in datasets_val.items()}
    return (dataset_train, datasets_val), (train_loader, val_loaders)


def out_dir_of(config) -> str:
    return os.path.join(config.out_root, "result", config.out)


def train(config, device=DEFAULT_DEVICE, iterations: Optional[int] = None):
    """Train the config's model for ``iterations`` (default ``num_iter``)
    iterations; returns (gen, optimizer, loss history)."""
    datasets, loaders = create_dataloader(config.dataset)
    ds = datasets[0]
    gen = dso.build_generator(config, ds.num_bone, ds.parents, device)
    return dso.train_loop(config, gen, datasets, loaders, ds.canonical_pose,
                          max_iterations=iterations)


def validation(config, device=DEFAULT_DEVICE):
    """PSNR and SSIM of the latest snapshot (or ``resume``) on every frame
    of the validation sets, cropped; written to ``val_metrics.json``."""
    datasets, loaders = create_dataloader(config.dataset)
    ds = datasets[0]
    gen = dso.build_generator(config, ds.num_bone, ds.parents, device)
    out_dir = out_dir_of(config)
    path = ckpt.latest_checkpoint(out_dir) or config.get("resume")
    if not path:
        raise FileNotFoundError(f"no snapshot in {out_dir} and no resume: "
                                f"train a model first")
    gen.load_state_dict(ckpt.load_checkpoint(path, map_location=device)["gen"])
    val = dso.validate(gen, config, loaders[1], crop=True,
                       metrics=VAL_METRICS)
    with open(os.path.join(out_dir, "val_metrics.json"), "w") as f:
        json.dump(val, f)
    print(json.dumps(val, indent=2))
    return val


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", type=str,
                        default="configs/DSO_train/ZJU/313_denarf.yml")
    parser.add_argument("--default_config", type=str,
                        default="configs/DSO_train/default.yml")
    parser.add_argument("--resume_latest", action="store_true")
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--validation", action="store_true")
    parser.add_argument("--iterations", type=int, default=None,
                        help="override num_iter (smoke runs)")
    parser.add_argument("--device", type=str, default=str(DEFAULT_DEVICE))
    args = parser.parse_args(argv)
    config = yaml_config(args.config, args.default_config, args.resume_latest,
                         args.num_workers)
    device = torch.device(args.device)
    use_full_float32()
    if args.validation:
        return validation(config, device)
    record_command(out_dir_of(config))
    return train(config, device, args.iterations)


if __name__ == "__main__":
    main()
