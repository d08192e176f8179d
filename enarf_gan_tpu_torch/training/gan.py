"""ENARF-GAN adversarial training (port of ``enarf_gan_tpu/training/gan.py``).

``train_loop`` is the entry point. Each iteration runs:

* the G step: ``n_accum_step`` micro-batches, each rendering its fake
  images (``TriNARFGenerator.forward`` in train mode: the tri-plane
  mapping's ``w_avg`` moves, the per-point network is recomputed in
  backward) and backpropagating its loss / n_accum (the adversarial loss
  against D, the bone-guided mask loss, the tri-plane L2 regulariser),
  then one Adam step of G; D's parameters take no gradient;
* the D step on the detached fakes and the real images;
* every 16th iteration (iteration 0 included) the R1 step, loss
  0.5 * r1 * 16 * r1_coef.

Adam (b1 0, b2 0.99, eps 1e-8) at lr 1e-3 * bs / 32 for G and
2e-3 * bs / 32 for D, with the JAX package's skip of a non-finite step
(``dso.Optimizer``). Metrics stay on the device and are fetched every 10
iterations. Snapshots hold {iteration, gen, dis, gen_opt, dis_opt}. The
real, fake and bone-mask image grids come with the GAN CLIs (ROADMAP Queue
1, item 4; the PNG writer is ``utils/logging.py::save_img_grid``). On the
card the renders run the hand-written
kernels forward and backward (tilewin 2 and 2b on the tiled path, unirow 1
and 1b on the exact one).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from enarf_gan_tpu_torch import DEFAULT_DEVICE
from enarf_gan_tpu_torch.models.generator import (TriNARFGenerator,
                                                  register_canonical_pose)
from enarf_gan_tpu_torch.models.narf import NARFParams
from enarf_gan_tpu_torch.nn.stylegan2 import Discriminator
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training.dso import Optimizer
from enarf_gan_tpu_torch.training.losses import (adv_loss_dis, adv_loss_gen,
                                                 nerf_patch_loss, r1_penalty,
                                                 triplane_l2_reg)
from enarf_gan_tpu_torch.utils.logging import MetricsWriter

R1_INTERVAL = 16
ADAM_BETAS = (0.0, 0.99)
POSE_KEYS = ("bone_mask", "pose_to_camera", "bone_length", "pose_to_world")


def build_models(config, num_bone: int, parent_id, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[TriNARFGenerator, Discriminator]:
    """The config's generator and discriminator, on ``device``. The GAN's
    tri-plane NARF is view-independent, as the reference's."""
    gp = config.generator_params
    params = NARFParams.from_config(gp.nerf_params, view_dependent=False)
    gen = TriNARFGenerator(
        params, size=config.dataset.image_size, num_bone=num_bone,
        parent_id=tuple(int(x) for x in parent_id), z_dim=int(gp.z_dim),
        crop_background=bool(gp.crop_background),
        pretrained_background=bool(gp.get("pretrained_background", False)),
        background_ratio=float(gp.background_ratio),
        channel_max=int(gp.get("channel_max", 512)),
        train_ray_chunk=int(gp.get("train_ray_chunk", 4096)),
        device=device, generator=generator)
    dp = config.discriminator_params
    dis = Discriminator(size=config.dataset.image_size,
                        minibatch_std=bool(dp.minibatch_std),
                        channel_max=int(dp.get("channel_max", 512)),
                        device=device, generator=generator)
    return gen, dis


def init_gan_state(config, gen: TriNARFGenerator, dis: Discriminator,
                   canonical_pose: np.ndarray
                   ) -> Tuple[Optimizer, Optimizer]:
    """Register the canonical pose; the optimisers of G and D."""
    register_canonical_pose(gen, canonical_pose,
                            gen.nerf_params.origin_location, gen.parent_id)
    bs = config.dataset.bs
    return (Optimizer(gen.parameters(), 1e-3 * bs / 32, betas=ADAM_BETAS),
            Optimizer(dis.parameters(), 2e-3 * bs / 32, betas=ADAM_BETAS))


def make_gan_steps(config, gen: TriNARFGenerator, dis: Discriminator,
                   gen_opt: Optimizer, dis_opt: Optimizer):
    """(g_step, d_step, r1_step).

    ``g_step(batch, generator=None, randoms=None)`` → (fake images, metrics)
    splits the batch into ``n_accum_step`` micro-batches; random numbers
    come from ``generator`` or, per micro-batch, from ``randoms[i]`` =
    {"z": (mb, 4 z_dim), "draws", "noise", "crop"} (``TriNARFGenerator.
    forward``). ``d_step(fake_img, real_img)`` and ``r1_step(real_img)`` →
    metrics. Metrics are tensors on the device.
    """
    n_accum = int(config.get("n_accum_step", 1))
    adv_type = config.loss.adv_loss_type
    bone_coef = float(config.loss.bone_guided_coef)
    r1_coef = float(config.loss.r1_loss_coef)
    reg_coef = float(config.loss.tri_plane_reg_coef)
    z_dim = int(config.generator_params.z_dim)
    bg_ratio = gen.background_ratio

    def g_step(batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               randoms: Optional[List[Dict]] = None):
        B = batch["pose_to_camera"].shape[0]
        if B % n_accum:
            raise ValueError(f"batch of {B} does not split into {n_accum} "
                             f"micro-batches")
        mb = B // n_accum
        gen_opt.zero_grad()
        losses, advs, bones, imgs = [], [], [], []
        dis.requires_grad_(False)
        try:
            for i in range(n_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                r = dict(randoms[i]) if randoms else {}
                z = r.pop("z", None)
                if z is None:
                    z = torch.randn((mb, z_dim * 4), generator=generator,
                                    device=generator.device).to(
                                        micro["pose_to_camera"].device)
                img, mask, aux = gen(
                    micro["pose_to_camera"], micro["pose_to_world"],
                    micro["bone_length"], z, micro["inv_intrinsics"],
                    train=True, generator=generator, **r)
                adv = adv_loss_gen(dis(img), adv_type)
                bone = nerf_patch_loss(mask, micro["bone_mask"], bg_ratio,
                                       coef=bone_coef)
                loss = adv + bone
                if reg_coef > 0:
                    loss = loss + triplane_l2_reg(
                        aux["tri_plane_feature"]) * reg_coef
                (loss / n_accum).backward()
                losses.append(loss.detach() / n_accum)
                advs.append(adv.detach())
                bones.append(bone.detach())
                imgs.append(img.detach())
        finally:
            dis.requires_grad_(True)
        gen_opt.step()
        return torch.cat(imgs), {
            "loss_gen": torch.stack(losses).sum(),
            "adv_loss_gen": torch.stack(advs).mean(),
            "bone_loss": torch.stack(bones).mean()}

    def d_step(fake_img: torch.Tensor, real_img: torch.Tensor):
        dis_opt.zero_grad()
        loss = adv_loss_dis(dis(real_img), dis(fake_img.detach()), adv_type)
        loss.backward()
        dis_opt.step()
        return {"adv_loss_dis": loss.detach()}

    def r1_step(real_img: torch.Tensor):
        dis_opt.zero_grad()
        r1 = r1_penalty(dis, real_img)
        (0.5 * r1 * R1_INTERVAL * r1_coef).backward()
        dis_opt.step()
        return {"r1_reg": r1.detach()}

    return g_step, d_step, r1_step


def prepare_gan_batch(img_batch: Dict[str, np.ndarray],
                      pose_batch: Dict[str, np.ndarray],
                      device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """A real-image batch and a pose-prior batch → the tensors the steps
    take (``real_img`` and the pose keys, with ``inv_intrinsics``)."""
    out = {"real_img": img_batch["img"],
           **{k: pose_batch[k] for k in POSE_KEYS},
           "inv_intrinsics": np.linalg.inv(pose_batch["intrinsics"])}
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            for k, v in out.items()}


def _next(it, loader):
    try:
        return next(it), it
    except StopIteration:
        it = iter(loader)
        return next(it), it


def train_loop(config, gen: TriNARFGenerator, dis: Discriminator, datasets,
               loaders, canonical_pose: np.ndarray,
               max_iterations: Optional[int] = None, verbose: bool = True,
               generator: Optional[torch.Generator] = None):
    """Train ``gen`` and ``dis`` (built on one device, e.g. by
    ``build_models``) for ``config.num_iter`` (or ``max_iterations``)
    iterations over ``loaders = (real-image loader, pose-prior loader)``,
    skipping batches not of ``config.dataset.bs``.

    Resumes from ``config.resume`` or, with ``resume_latest``, the output
    directory's latest snapshot: iteration, both models and both
    optimisers, as the JAX package. Random numbers come from ``generator``
    (default: seeded with ``config.seed``, or 0, on the model's device).
    Returns (gen_opt, dis_opt, history: one dict of floats an iteration).
    """
    device = next(gen.parameters()).device
    out_dir = os.path.join(config.out_root, "result", config.out)
    os.makedirs(out_dir, exist_ok=True)
    writer = MetricsWriter(os.path.join(config.out_root, "runs", config.out))
    loader_img, loader_pose = loaders
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(config.get("seed", 0)))
    gen_opt, dis_opt = init_gan_state(config, gen, dis, canonical_pose)
    iteration = 0
    if config.get("resume") or config.get("resume_latest"):
        path = os.path.join(out_dir, ckpt.LATEST) \
            if config.get("resume_latest") else config.resume
        if path and os.path.exists(path):
            snap = ckpt.load_checkpoint(path, map_location=device)
            ckpt.load_gen_state_dict(gen, snap["gen"])
            dis.load_state_dict(snap["dis"])
            gen_opt.load_state_dict(snap["gen_opt"])
            dis_opt.load_state_dict(snap["dis_opt"])
            iteration = int(snap["iteration"])
    g_step, d_step, r1_step = make_gan_steps(config, gen, dis, gen_opt,
                                             dis_opt)
    num_iter = max_iterations or config.num_iter
    bs = config.dataset.bs
    start = time.time()
    history, pending = [], []
    img_iter, pose_iter = iter(loader_img), iter(loader_pose)
    while iteration < num_iter:
        img_batch, img_iter = _next(img_iter, loader_img)
        pose_batch, pose_iter = _next(pose_iter, loader_pose)
        if img_batch["img"].shape[0] != bs or \
                pose_batch["bone_mask"].shape[0] != bs:
            continue
        batch = prepare_gan_batch(img_batch, pose_batch, device)
        real_img = batch.pop("real_img")
        fake_img, metrics = g_step(batch, generator)
        metrics.update(d_step(fake_img, real_img))
        if iteration % R1_INTERVAL == 0:
            metrics.update(r1_step(real_img))
        pending.append(metrics)
        iteration += 1
        if iteration % 10 == 0 or iteration >= num_iter:
            history.extend({k: float(v) for k, v in m.items()}
                           for m in pending)
            pending.clear()
            if verbose and iteration % 10 == 0:
                print(f"{iteration} iter, "
                      f"{(time.time() - start) / iteration:.3f} s/iter, "
                      f"G {history[-1]['loss_gen']:.3f} "
                      f"D {history[-1]['adv_loss_dis']:.3f}")
        if iteration % 100 == 0:
            for k, v in history[-1].items():
                writer.scalar(iteration, v, k)
        if iteration == 10:
            with open(os.path.join(out_dir, "iter_10_succeeded.txt"), "w") as f:
                f.write("ok")
        if (iteration % config.get("save_interval", 200) == 0
                or iteration >= num_iter):
            ckpt.save_checkpoint(out_dir, {
                "iteration": iteration, "gen": ckpt.gen_state_dict(gen),
                "dis": dis.state_dict(), "gen_opt": gen_opt.state_dict(),
                "dis_opt": dis_opt.state_dict()}, iteration)
    writer.close()
    return gen_opt, dis_opt, history
