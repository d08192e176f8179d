"""The GAN's G, D and R1 steps timed apart (port of
``tools/bench_gan_step.py``).

Reference geometry per image (128² = 16,384 rays, Nc 48 + Nf 64, 256²
tri-planes at w_dim 512, z_dim 256, ``tile_patch`` 4), a modest batch (bs
4 in 4 micro-batches), on a synthetic cache; the steps of
``training.gan.make_gan_steps``, weights from seed 0. Each step runs once
to warm up, then ``GAN_ITERS`` (3) times on the host clock (ending in a
synchronise); then, after all of them, each once more under
``profile_by_class``; the amortised
iteration is G + D + R1 / 16 (R1 every 16th iteration).

    python -m enarf_gan_tpu_torch.tools.gan_step [--device cpu]

Variables, with the JAX tool's defaults: GAN_BS (4), GAN_SIZE (128),
GAN_RAY_CHUNK (4096; ``config_tpu.yml`` ships 2048), GAN_PLANES (256),
GAN_NC (48), GAN_NF (64), GAN_TILED (4; 0 the exact path), GAN_ACCUM (4);
and GAN_ITERS (3), and for a smoke run on the CPU GAN_CHANNEL_MAX (512:
the StyleGAN2 networks' and the discriminator's widest layer).

One JSON line a step (host s, device ms, busy share, kernel launches, the
peak memory of its timed calls, the port kernels' launches a step, the
card), then one of the amortised iteration.
"""
from __future__ import annotations

import tempfile

import numpy as np
import torch

from enarf_gan_tpu_torch.tools import benchkit


def gan_config(root: str, bs: int, size: int):
    from enarf_gan_tpu_torch.config import AttrDict
    e = benchkit.env_int
    return AttrDict({
        "out_root": root, "out": "gan_bench",
        "dataset": {"bs": bs, "image_size": size,
                    "train": {"data_root": root}},
        "generator_params": {
            "z_dim": 256, "patch_size": 24, "background_ratio": 0.3,
            "use_triplane": True, "crop_background": True,
            "pretrained_background": False,
            "channel_max": e("GAN_CHANNEL_MAX", 512),
            "train_ray_chunk": e("GAN_RAY_CHUNK", 4096),
            "nerf_params": {
                "w_dim": 512, "tri_plane_size": e("GAN_PLANES", 256),
                "hidden_size": 256, "Nc": e("GAN_NC", 48),
                "Nf": e("GAN_NF", 64), "no_ray_direction": False,
                "origin_location": "center_fixed", "coordinate_scale": 3,
                "plane_sample_dtype": "bfloat16",
                "tile_patch": e("GAN_TILED", 4)}},
        "discriminator_params": {"minibatch_std": True,
                                 "channel_max": e("GAN_CHANNEL_MAX", 512)},
        "loss": {"adv_loss_type": "ce", "bone_guided_coef": 10,
                 "r1_loss_coef": 10, "tri_plane_reg_coef": 0.001},
        "n_accum_step": e("GAN_ACCUM", 4), "num_iter": 10, "resume": None})


def main(argv=None):
    from enarf_gan_tpu_torch.config import AttrDict
    from enarf_gan_tpu_torch.data.datasets import (HumanDataset,
                                                   HumanPoseDataset)
    from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
    from enarf_gan_tpu_torch.training import gan
    args = benchkit.parser(__doc__).parse_args(argv)
    device = benchkit.resolve(args.device)
    bs = benchkit.env_int("GAN_BS", 4)
    size = benchkit.env_int("GAN_SIZE", 128)
    iters = benchkit.env_int("GAN_ITERS", 3)
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_human_cache(root, size=size, n_frames=max(bs, 4),
                                   n_camera=2)
        config = gan_config(root, bs, size)
        img_ds = HumanDataset(AttrDict({"data_root": root}), size=size,
                              num_repeat_in_epoch=1)
        pose_ds = HumanPoseDataset(size=size, data_root=root,
                                   num_repeat_in_epoch=1)

        def stack(ds, keys):
            items = [ds[i % len(ds)] for i in range(bs)]
            return {k: np.stack([it[k] for it in items]) for k in keys}

        img_b = stack(img_ds, ["img"])
        pose_b = stack(pose_ds, ["bone_mask", "pose_to_camera",
                                 "bone_length", "pose_to_world",
                                 "intrinsics"])
        canonical = pose_ds.canonical_pose
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents,
                                device, generator=torch.Generator()
                                .manual_seed(0))
    gen_opt, dis_opt = gan.init_gan_state(config, gen, dis, canonical)
    g_step, d_step, r1_step = gan.make_gan_steps(config, gen, dis, gen_opt,
                                                 dis_opt)
    batch = gan.prepare_gan_batch(img_b, pose_b, device)
    real = batch["real_img"]
    rng = torch.Generator(device=device).manual_seed(0)
    fake = g_step(batch, rng)[0]
    steps = (("G", lambda: g_step(batch, rng)),
             ("D", lambda: d_step(fake, real)),
             ("R1", lambda: r1_step(real)))
    # every step on the host clock before the first profile: after a
    # torch.profiler session the host's launches may cost more
    timed = {}
    for name, fn in steps:
        fn()                                             # warm-up
        benchkit.reset_peak(device)
        benchkit.reset_launches()
        ms, out = benchkit.host_ms(fn, iters, device)
        timed[name] = dict(
            s=ms / 1e3, peak_gib=benchkit.peak_gib(device),
            launches_a_step={k: v / iters for k, v in
                             benchkit.launches().items()},
            metrics={k: float(v) for k, v in
                     (out[1] if name == "G" else out).items()})
    records = {name: benchkit.emit(
        "gan_step", device, step=name, bs=bs, size=size,
        n_accum=int(config.n_accum_step),
        tile_patch=int(config.generator_params.nerf_params.tile_patch),
        iters=iters, **timed[name],
        **benchkit.device_profile(fn, device, f"GAN {name} step",
                                  timed[name]["s"] * 1e3, f"{name} step"))
        for name, fn in steps}
    per_iter = records["G"]["s"] + records["D"]["s"] \
        + records["R1"]["s"] / gan.R1_INTERVAL
    device_ms = None if records["G"]["device_ms"] is None else \
        records["G"]["device_ms"] + records["D"]["device_ms"] \
        + records["R1"]["device_ms"] / gan.R1_INTERVAL
    records["iteration"] = benchkit.emit(
        "gan_step", device, step=f"iteration (R1 every {gan.R1_INTERVAL})",
        s=per_iter, device_ms=device_ms,
        mrays_per_s=bs * size * size / per_iter / 1e6)
    return records


if __name__ == "__main__":
    main()
