"""Why a DSO learning run stays at the blank frame (port of
``tools/diag_learning.py``).

Three stages, each isolating one link of the chain a learning run needs:

A. GEOMETRY: the fixture's scene rendered with a forced density field (5
   inside any bone's cube, a constant color). If that mask does not cover
   the ground-truth mask, the camera, pose or frustum is misaligned and no
   optimiser can fix it.
B. LEARNING DYNAMICS: training, instrumented: every ``--log-every``
   iterations (and the first) the loss terms, the rendered mask's mean at
   the sampled foreground and background rays, the fine pass's density
   statistics, the gradient norm and those of the density head and the
   tri-planes.
C. QUALITY: the trained frame's PSNR against the blank frame's (the
   fresh model's render), the floor every learning gate must beat.

The model is the config's, from ``--seed``: its initial weights drawn
from ``torch.Generator().manual_seed(seed)``, the training's random
numbers from a generator on the device with the same seed, the loader's
order from seed 0, as ``chip_smoke.py``'s learning phase builds them; so
``--tile 4 --seed 2 --size 64 --iters 200`` is that phase's tiled run from
seed 2, step by step. ``--config`` is a DSO training YAML read over
``configs/DSO_train/default.yml`` (default: ``313_denarf_tpu.yml``, the
learning phase's model at full width, lr 1e-3), or ``quality``: the JAX
tool's own diagnostic model (hidden 32, 32² planes, w_dim 64, Nc 12 + Nf
16, 1024 rays, lr 0.02). The data is a synthetic cache of one frame at
``--size``² in a temporary directory.

    python -m enarf_gan_tpu_torch.tools.diag_learning [--size 32]
        [--iters 300] [--tile 0] [--seed 0] [--config PATH|quality]
        [--lr LR] [--log-every 20] [--device cpu]

One JSON line for stage A, one a logged iteration of stage B, and one for
stage C with the PSNR, the floor, whether the run left the blank frame (by
more than 2 dB) and the iteration from which its loss stayed within 1% of
the first (None if it did not), and the card; ``main`` returns them as
{"A": ..., "B": [...], "C": ...}.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from enarf_gan_tpu_torch.tools import benchkit

LEARN_CONFIG = ("configs/DSO_train/ZJU/313_denarf_tpu.yml",
                "configs/DSO_train/default.yml")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def quality_config(root, out_root, size, iters, tile_patch, lr=0.02):
    """The JAX tool's diagnostic model and schedule."""
    from enarf_gan_tpu_torch.config import AttrDict
    cfg = AttrDict({
        "out_root": out_root, "out": f"diag_dso_{tile_patch}",
        "dataset": {"bs": 1, "image_size": size, "bg_color": -1,
                    "num_workers": 1,
                    "train": {"data_root": root, "n_frames": 1}},
        "generator_params": {
            "use_triplane": True, "ray_batchsize": 1024,
            "nerf_params": {
                "w_dim": 64, "hidden_size": 32, "Nc": 12, "Nf": 16,
                "no_ray_direction": True,
                "origin_location": "center_fixed", "coordinate_scale": 3,
                "render_bs": 1024, "model_type": "narf",
                "multiply_density_with_triplane_wieght": False,
                "clamp_mask": False, "constant_triplane": False,
                "constant_trimask": False, "selector_mlp": False,
                "deformation_field": True, "no_selector": False,
                "time_conditional": True, "pose_conditional": False,
                "constant_trimask_lr_mul": 1, "tri_plane_size": 32}},
        "loss": {"color_coef": 1, "mask_coef": 1, "nerf_loss_type": "mse"},
        "num_iter": iters, "lr": lr, "scheduler_gamma": 0.99995,
        "resume": None, "resume_latest": False})
    if tile_patch:
        nerf = cfg.generator_params.nerf_params
        nerf.tile_patch = tile_patch
        nerf.plane_sample_dtype = "bfloat16"
        nerf.tile_coarse_corners = True
    return cfg


def learn_config(path, root, out_root, size, iters, tile_patch):
    """A DSO training config cut to one ``size``² frame at batch 1, as
    ``chip_smoke.py``'s learning phase cuts ``313_denarf_tpu.yml``."""
    from enarf_gan_tpu_torch.config import yaml_config
    cfg = yaml_config(path, os.path.join(REPO, LEARN_CONFIG[1]))
    cfg.out_root, cfg.out = out_root, f"diag_dso_{tile_patch}"
    cfg.dataset.image_size, cfg.dataset.bs = size, 1
    cfg.dataset.train.data_root, cfg.dataset.train.n_frames = root, 1
    cfg.generator_params.nerf_params.tile_patch = tile_patch
    cfg.num_iter = iters
    return cfg


def stage_a_geometry(gen, item, size, device):
    """Forced-density render: is the scene geometry visible at all?"""
    from enarf_gan_tpu_torch.nerf.rendering import render_entire_img
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.asarray(x, np.float32)[None]).to(device)
    pose_t, _ = gen.transform_pose(to(item["pose_3d"]),
                                   to(item["bone_length"]))

    def forced_fn(points, ray_dir, pose_scaled):
        R = pose_scaled[:, :, :3, :3]
        t = pose_scaled[:, :, :3, 3:]
        local = torch.einsum("bkji,bkjn->bkin", R, points[:, None] - t)
        valid = (local.abs() <= 1).all(dim=2).any(dim=1)       # (B, n)
        return valid[:, None].float() * 5.0, torch.full_like(points, 0.57)

    with torch.no_grad():
        _, mask, _ = render_entire_img(
            forced_fn, pose_t, to(np.linalg.inv(item["intrinsics"])),
            gen.render_cfg(), size, ray_batchsize=1024,
            camera_pose=to(item["camera_rotation"]),
            generator=torch.Generator(device=device).manual_seed(0))
    mask = mask.cpu().numpy()
    fg = np.asarray(item["mask"]) > 0.5
    rendered = mask > 0.5
    return {"gt_fg_fraction": float(fg.mean()),
            "forced_fg_fraction": float(rendered.mean()),
            "coverage": float((rendered & fg).sum() / max(fg.sum(), 1)),
            "forced_mask_mean": float(mask.mean()),
            "forced_mask_max": float(mask.max())}


def _norm(tensors) -> float:
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return -1.0
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)))


def density_head_grads(nerf):
    """The gradients of the density head: ``density_fc`` of a
    view-dependent model, else the color MLP's last layer's density row
    (output channel 3)."""
    if hasattr(nerf, "density_fc"):
        return [p.grad for p in nerf.density_fc.parameters()]
    last = nerf.mlp.layers[-1]
    w, b = last.conv.weight.grad, last.bias.grad
    return [None if w is None else w[:, 3], None if b is None else b[:, 3]]


def make_diag_step(gen, optimizer, loss_cfg, bg_color):
    """One training step (``training.dso.make_train_step`` at one
    micro-batch) that also returns stage B's diagnostics."""
    from enarf_gan_tpu_torch.training.losses import photometric_loss
    fine = {}
    name = "nerf_density_color_tiled" if gen.nerf.supports_tiled_sampling() \
        else "nerf_density_color"
    point_network = getattr(gen, name)

    def recording(*args, **kwargs):
        out = point_network(*args, **kwargs)
        fine["density"] = out[0].detach()      # the last call: the fine pass
        return out

    setattr(gen, name, recording)
    params = dict(gen.named_parameters())

    def step(batch, generator):
        optimizer.zero_grad()
        color, nerf_mask, ray_idx = gen(
            batch["pose_3d"], batch["camera_rotation"], batch["mask"],
            batch["frame_time"], batch["bone_length"],
            batch["inv_intrinsics"], background=bg_color, generator=generator)
        lc, lm = photometric_loss(ray_idx, color, nerf_mask, batch["img"],
                                  batch["mask"], loss_cfg.nerf_loss_type,
                                  float(loss_cfg.color_coef),
                                  float(loss_cfg.mask_coef))
        (lc + lm).backward()
        lc, lm = lc.detach(), lm.detach()
        B = batch["mask"].shape[0]
        gt = batch["mask"].reshape(B, -1).gather(1, ray_idx.long())
        nm = nerf_mask.detach()
        diag = {
            "loss": float(lc + lm), "lc": float(lc), "lm": float(lm),
            "fg_frac_sampled": float(gt.mean()),
            "mask_at_fg": float((nm * gt).sum() / (gt.sum() + 1e-8)),
            "mask_at_bg": float((nm * (1 - gt)).sum()
                                / ((1 - gt).sum() + 1e-8)),
            "fine_density_mean": float(fine["density"].mean()),
            "fine_density_max": float(fine["density"].max()),
            "gnorm": _norm(p.grad for p in params.values()),
            "g_density": _norm(density_head_grads(gen.nerf)),
            "g_tri_plane": _norm(p.grad for n, p in params.items()
                                 if "tri_plane" in n)}
        diag["applied"] = optimizer.step()
        return diag

    return step


def empty_since(history):
    """The iteration (from 1) from which the loss stays within 1% of the
    first iteration's, the fresh model's empty frame; None if it leaves."""
    h = np.asarray(history)
    empty = np.abs(h / h[0] - 1) <= 0.01
    if not empty[-1]:
        return None
    left = np.flatnonzero(~empty)
    return int(left[-1]) + 2 if left.size else 1


def main(argv=None):
    from enarf_gan_tpu_torch.data.datasets import SSODataset
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.data.loader import DataLoader
    from enarf_gan_tpu_torch.eval_lib.metrics import psnr
    from enarf_gan_tpu_torch.training import dso
    ap = benchkit.parser(__doc__)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default=os.path.join(REPO, LEARN_CONFIG[0]),
                    help="a DSO training YAML (over configs/DSO_train/"
                         "default.yml), or 'quality' for the JAX tool's "
                         "model")
    ap.add_argument("--lr", type=float, default=None,
                    help="the learning rate (default: the config's)")
    ap.add_argument("--log-every", type=int, default=20)
    args = ap.parse_args(argv)
    device = benchkit.resolve(args.device)
    tool = "diag_learning"
    with tempfile.TemporaryDirectory() as out:
        root = os.path.join(out, f"synth{args.size}")
        make_synthetic_human_cache(root, size=args.size, n_frames=1,
                                   n_camera=1)
        if args.config == "quality":
            config = quality_config(root, out, args.size, args.iters,
                                    args.tile)
        else:
            config = learn_config(args.config, root, out, args.size,
                                  args.iters, args.tile)
        if args.lr is not None:
            config.lr = args.lr
        ds = SSODataset(config.dataset.train, size=args.size,
                        return_bone_params=True,
                        num_repeat_in_epoch=args.iters)
        loader = DataLoader(ds, 1, seed=0)
        gen = dso.build_generator(
            config, ds.num_bone, ds.parents, device,
            generator=torch.Generator().manual_seed(args.seed))
        optimizer = dso.init_state(config, gen, ds.canonical_pose)
        item = ds[0]
        floor = psnr(item["img"][None], np.full_like(item["img"][None],
                                                     config.dataset.bg_color))
        common = dict(size=args.size, tile=args.tile, seed=args.seed,
                      config=os.path.basename(args.config),
                      lr=float(config.lr))
        out = {"A": benchkit.emit(
            tool, device, stage="A", **common,
            **stage_a_geometry(gen, item, args.size, device)), "B": []}

        step = make_diag_step(gen, optimizer, config.loss,
                              config.dataset.bg_color)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        history, it = [], 0
        while it < args.iters:
            for batch in loader:
                if it >= args.iters:
                    break
                d = step(dso.prepare_batch(batch, device), generator)
                it += 1
                history.append(d["loss"])
                if it % args.log_every == 0 or it == 1:
                    out["B"].append(benchkit.emit(tool, device, stage="B",
                                                  it=it, **d))

        got = dso.validate(gen, config, {"train": loader},
                           torch.Generator(device=device).manual_seed(5),
                           num_data=1)["train"]["color_PSNR"]
        out["C"] = benchkit.emit(tool, device, stage="C", **common,
                                 psnr=got, floor=float(floor),
                                 left_blank=bool(got > floor + 2.0),
                                 loss_first=history[0],
                                 loss_last=history[-1],
                                 empty_since=empty_since(history))
    return out


if __name__ == "__main__":
    main()
