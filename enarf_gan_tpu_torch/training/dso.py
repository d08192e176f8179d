"""DSO (dynamic scene overfitting) training (port of
``enarf_gan_tpu/training/dso.py``).

``train_loop`` is the entry point: it overfits a ``DSONARFGenerator`` to a
dataset of posed frames, one step at a time: a ray batch sampled from each
image's mask, rendered differentiably (``DSONARFGenerator.forward``), the
photometric loss, Adam with a per-step exponential learning-rate decay, and
the JAX package's skip of a step whose gradient is not finite. It writes
``torch.save`` snapshots (``training/checkpoint.py``), ``log.json`` at each
validation and scalars for tensorboard. On the card the renders run the
hand-written kernels forward and backward (unirow 1 and 1b on the exact
path, tilewin 2 and 2b, or 3 on the fine pass under
``ENARF_TILEWIN_KERNEL``, on the tiled path); the MLP baselines and the
dense tri-plane variants run plain PyTorch.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE
from enarf_gan_tpu_torch.eval_lib.metrics import mse, psnr as psnr_fn, \
    ssim as ssim_fn
from enarf_gan_tpu_torch.models.generator import (DSONARFGenerator,
                                                  make_dso_full_renderer,
                                                  register_canonical_pose)
from enarf_gan_tpu_torch.models.narf import NARFParams
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training.losses import photometric_loss
from enarf_gan_tpu_torch.utils.logging import (JsonLog, MetricsWriter,
                                              save_img_grid)

MAX_CONSECUTIVE_NONFINITE = 100    # optax.apply_if_finite's limit
BATCH_KEYS = ("img", "mask", "pose_3d", "frame_time", "bone_length",
              "camera_rotation")


def build_generator(config, num_bone: int, parent_id, device=DEFAULT_DEVICE,
                    generator: Optional[torch.Generator] = None
                    ) -> DSONARFGenerator:
    """The config's DSO generator, on ``device``: the tri-plane NARF, or
    with ``use_triplane: False`` the MLP NARF baseline of ``model_type``."""
    gp = config.generator_params
    return DSONARFGenerator(NARFParams.from_config(gp.nerf_params),
                            num_bone=num_bone,
                            parent_id=tuple(int(x) for x in parent_id),
                            device=device, generator=generator,
                            ray_batchsize=int(gp.ray_batchsize),
                            use_triplane=bool(gp.use_triplane))


class Optimizer:
    """Adam (``betas``, default (0.9, 0.99), eps 1e-8) with the learning
    rate lr * gamma^k after k applied updates (optax's
    ``exponential_decay`` with ``transition_steps=1``; none at gamma 1),
    and optax's ``apply_if_finite``: a step whose gradient is not finite
    moves neither the parameters, nor Adam's moments, nor the schedule,
    unless more than 100 such steps came in a row. A parameter that took
    no gradient takes a zero one, as in optax: its moments decay and its
    step counts (torch's Adam would skip it)."""

    def __init__(self, params, lr: float, gamma: float = 1.0,
                 betas=(0.9, 0.99)):
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=tuple(betas),
                                     eps=1e-8)
        self.schedule = torch.optim.lr_scheduler.ExponentialLR(
            self.adam, gamma=gamma) if gamma < 1 else None
        self.nonfinite = 0       # consecutive rejected steps

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Apply the gradients in ``.grad``; returns whether they were."""
        grads = [p.grad for p in self.params if p.grad is not None]
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all()) if grads else True
        self.nonfinite = 0 if finite else self.nonfinite + 1
        if not finite and self.nonfinite <= MAX_CONSECUTIVE_NONFINITE:
            return False
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()
        return True

    def state_dict(self):
        return self.adam.state_dict()

    def load_state_dict(self, state):
        self.adam.load_state_dict(state)


def init_state(config, gen: DSONARFGenerator,
               canonical_pose: np.ndarray) -> Optimizer:
    """Register the canonical pose and build the optimiser."""
    register_canonical_pose(gen, canonical_pose,
                            gen.nerf_params.origin_location, gen.parent_id)
    return Optimizer(gen.parameters(), float(config.lr),
                     float(config.scheduler_gamma))


def make_train_step(gen: DSONARFGenerator, optimizer: Optimizer, loss_cfg,
                    bg_color: float, n_accum: int = 1):
    """``train_step(batch, generator=None, randoms=None)`` → metrics.

    With ``n_accum`` > 1 the batch is split into that many micro-batches;
    each renders (and packs its own tables), and its loss / n_accum is
    backpropagated before the next one runs, so only one micro-batch's
    tables and activations are alive at a time (the memory reason the JAX
    package gives). The gradients are so averaged, then applied once.
    Random numbers come from ``generator`` or, per micro-batch, from
    ``randoms[i]`` = {"ray_noise": ..., "draws": ...}
    (``DSONARFGenerator.forward``).
    """
    loss_type = loss_cfg.nerf_loss_type
    color_coef = float(loss_cfg.color_coef)
    mask_coef = float(loss_cfg.mask_coef)

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   randoms: Optional[List[Dict]] = None) -> Dict[str, float]:
        B = batch["img"].shape[0]
        if B % n_accum:
            raise ValueError(f"batch of {B} does not split into {n_accum} "
                             f"micro-batches")
        mb = B // n_accum
        optimizer.zero_grad()
        lcs, lms = [], []
        for i in range(n_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            color, nerf_mask, ray_idx = gen(
                micro["pose_3d"], micro["camera_rotation"], micro["mask"],
                micro["frame_time"], micro["bone_length"],
                micro["inv_intrinsics"], background=bg_color,
                generator=generator, **(randoms[i] if randoms else {}))
            lc, lm = photometric_loss(ray_idx, color, nerf_mask, micro["img"],
                                      micro["mask"], loss_type, color_coef,
                                      mask_coef)
            ((lc + lm) / n_accum).backward()
            lcs.append(lc.detach())
            lms.append(lm.detach())
        applied = optimizer.step()
        lc = float(torch.stack(lcs).mean())
        lm = float(torch.stack(lms).mean())
        return {"loss": lc + lm, "loss_color": lc, "loss_mask": lm,
                "applied": applied}

    return train_step


def prepare_batch(batch: Dict[str, np.ndarray],
                  device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch → the tensors a train step takes."""
    out = {k: torch.from_numpy(np.asarray(batch[k])) for k in BATCH_KEYS}
    out["inv_intrinsics"] = torch.from_numpy(np.linalg.inv(batch["intrinsics"]))
    return {k: v.to(device) for k, v in out.items()}


def validate(gen: DSONARFGenerator, config, val_loaders,
             generator: Optional[torch.Generator] = None,
             num_data: Optional[int] = None, crop: bool = False,
             metrics=("SSIM", "PSNR"), save_dir: Optional[str] = None,
             iteration: int = 0, lpips_fn=None) -> Dict:
    """Full-image validation through ``make_dso_full_renderer``: over each
    loader's frames (only the "train" loader when ``num_data`` is 1, and
    its first ``num_data`` frames), the mean mask and color MSE and the
    color ``metrics`` ("PSNR", "SSIM", and "LPIPS" through ``lpips_fn``,
    e.g. ``eval_lib.metrics.lpips``; without it LPIPS is left out). With
    ``crop`` each frame is cropped to the bounding box of its ground-truth
    mask after the full-image render (a frame with an empty mask is
    skipped), as the JAX package does. With ``save_dir`` the
    last frame of each loader, rendered beside the ground truth, is saved
    as ``<loader>_<iteration rounded down to 5000>.png``."""
    device = next(gen.parameters()).device
    size = config.dataset.image_size
    bg_color = config.dataset.bg_color
    renderer = make_dso_full_renderer(gen, size)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)[None]).to(device)  # noqa: E731
    out = {}
    for key, loader in val_loaders.items():
        if num_data != 1 and key == "train":
            continue
        n_total = len(loader.dataset.imgs)
        n_eval = n_total if num_data is None else min(num_data, n_total)
        acc = {"color": 0.0, "mask": 0.0}
        acc.update({f"color_{m}": 0.0 for m in metrics
                    if m != "LPIPS" or lpips_fn is not None})
        done = 0
        for i in range(n_eval):
            item = loader.dataset[i]
            img = item["img"][None]
            mask = item["mask"][None]
            color, gmask, _ = renderer(
                to(item["pose_3d"]), to(np.linalg.inv(item["intrinsics"])),
                to(item["frame_time"]), to(item["bone_length"]),
                to(item["camera_rotation"]), generator=generator)
            color = color.cpu().numpy()[None]
            gmask = gmask.cpu().numpy()[None]
            if crop:
                ys, xs = np.where(item["mask"] > 0)
                if len(xs) == 0:
                    continue
                x0, y0, x1, y1 = xs.min(), ys.min(), xs.max(), ys.max()
                mask = mask[:, y0:y1, x0:x1]
                img = img[:, :, y0:y1, x0:x1]
                color = color[:, :, y0:y1, x0:x1]
                gmask = gmask[:, y0:y1, x0:x1]
            if np.isnan(color).any():
                print("NaN is detected")
            color = color + bg_color * (1 - gmask[:, None])
            acc["mask"] += mse(mask, gmask)
            acc["color"] += mse(img, color)
            for m in metrics:
                if m == "PSNR":
                    acc["color_PSNR"] += psnr_fn(img, color)
                elif m == "SSIM":
                    acc["color_SSIM"] += ssim_fn(img[0], color[0])
                elif m == "LPIPS" and lpips_fn is not None:
                    acc["color_LPIPS"] += float(lpips_fn(img, color))
            done += 1
            if save_dir and i == n_eval - 1:
                save_img_grid(np.concatenate([color, img], axis=-1),
                              os.path.join(save_dir, f"{key}_"
                                           f"{iteration // 5000 * 5000}.png"))
        out[key] = {k: v / max(done, 1) for k, v in acc.items()}
    return out


def train_loop(config, gen: DSONARFGenerator, datasets, loaders,
               canonical_pose: np.ndarray,
               max_iterations: Optional[int] = None, verbose: bool = True,
               generator: Optional[torch.Generator] = None):
    """Train ``gen`` (built on its device, e.g. by ``build_generator``) for
    ``config.num_iter`` (or ``max_iterations``) steps over
    ``loaders = (train_loader, {name: val_loader})``.

    Resumes from ``config.resume`` or, with ``resume_latest``, the output
    directory's latest snapshot: the iteration and the generator, not the
    optimiser (as the reference). Random numbers come from ``generator``
    (default: seeded with ``config.seed``, or 0, on the model's device).
    Snapshots are written every ``save_interval`` iterations and after the
    last one. Returns (gen, optimizer, loss history).
    """
    device = next(gen.parameters()).device
    out_dir = os.path.join(config.out_root, "result", config.out)
    os.makedirs(out_dir, exist_ok=True)
    writer = MetricsWriter(os.path.join(config.out_root, "runs", config.out))
    jlog = JsonLog(os.path.join(out_dir, "log.json"))
    train_loader, val_loaders = loaders
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(config.get("seed", 0)))
    optimizer = init_state(config, gen, canonical_pose)
    iteration = 0
    if config.get("resume") or config.get("resume_latest"):
        path = os.path.join(out_dir, ckpt.LATEST) \
            if config.get("resume_latest") else config.resume
        if path and os.path.exists(path):
            snap = ckpt.load_checkpoint(path, map_location=device)
            gen.load_state_dict(snap["gen"])
            iteration = int(snap["iteration"])
    train_step = make_train_step(gen, optimizer, config.loss,
                                 config.dataset.bg_color,
                                 n_accum=int(config.get("n_accum_step", 1)))

    def save(iteration):
        ckpt.save_checkpoint(out_dir, {
            "iteration": iteration, "gen": gen.state_dict(),
            "gen_opt": optimizer.state_dict()}, iteration)

    num_iter = max_iterations or config.num_iter
    start = time.time()
    accum_time = 0.0
    train_losses = {"color": 0.0, "mask": 0.0}
    history = []
    while iteration < num_iter:
        for batch in train_loader:
            if iteration >= num_iter:
                break
            m = train_step(prepare_batch(batch, device), generator)
            iteration += 1
            train_losses["color"] += m["loss_color"]
            train_losses["mask"] += m["loss_mask"]
            history.append(m["loss"])
            if verbose and iteration % config.print_interval == 0:
                print(f"{iteration} iter, "
                      f"{(time.time() - start) / max(iteration, 1):.3f} s/iter, "
                      f"loss {history[-1]:.4f}")
            if iteration % config.tensorboard_interval == 0:
                writer.scalar(iteration, history[-1], "gen")
            if iteration % config.save_interval == 0:
                save(iteration)
            if iteration % config.val_interval == 0 and val_loaders:
                accum_time += time.time() - start
                vloss = validate(gen, config, val_loaders, generator,
                                 num_data=1, save_dir=out_dir,
                                 iteration=iteration)
                entry = {"accumulated_train_time": accum_time,
                         "train_loss_color":
                             train_losses["color"] / config.val_interval,
                         "train_loss_mask":
                             train_losses["mask"] / config.val_interval}
                for k, metrics_d in vloss.items():
                    for name, v in metrics_d.items():
                        entry[f"val_loss_{k}_{name}"] = v
                jlog.update(iteration, entry)
                train_losses = {"color": 0.0, "mask": 0.0}
                start = time.time()
    if iteration % config.save_interval:
        save(iteration)
    writer.close()
    return gen, optimizer, history
