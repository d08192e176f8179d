"""The DSO workloads at the reference's production sizes (port of
``tools/bench_production.py``).

* ``dso512``: the DSO train step at 512² images, batch ``BENCH_BS`` (16),
  4096 rays an image, Nc 48 + Nf 64, deformation field, 256² planes
  (``configs/DSO_train/ZJU/313_denarf.yml``'s bs 16 and size 512, on
  ``bench.py``'s model), Adam at lr 1e-3, mse loss; one warm-up step, then
  ``BENCH_ITERS`` (30) timed;
* ``demo1024``: a 1024² demo frame (1.05 M rays), ``render_bs``
  ``BENCH_RENDER_BS`` (8192) rays a chunk
  (``configs/DSO_demo/NeuralActor/lan_denarf.yml``); one warm-up frame,
  then ``BENCH_REPS`` (3) timed.

Synthetic batches in memory (the data pipeline is not under test), the
model's weights from seed 0 (``benchkit.build_dso``).

    python -m enarf_gan_tpu_torch.tools.production [--device cpu]

Variables: BENCH_WORKLOAD (dso512, demo1024 or all), BENCH_BS,
BENCH_ITERS, BENCH_TILED (tile_patch: 4 or 0; unset: the exact path, then
the tiled one, where the JAX tool takes 4), BENCH_RENDER_BS, BENCH_REPS;
for a smoke run on the CPU also BENCH_IMAGE_SIZE (both workloads' image
size) and the widths of ``benchkit``.

One JSON line a workload and path, with the JAX tool's keys (``metric``,
``value``, ``unit``, ``bs``, ``tile_patch``, ``compile_s``: here the
first step's or frame's seconds, the kernels' first-use builds included;
``loss``, ``mrays_per_s``, ``render_bs``), ``peak_gib`` (the allocator's
peak, ``device_memory_stats``) in place of ``peak_hbm_gb``, and the device
ms, busy share and kernel launches of one more step or frame
(``profile_by_class``, after every workload was timed on the host
clock), the port kernels' launches a step or frame, and the card.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from enarf_gan_tpu_torch.tools import benchkit


def dso512(device, tile_patch: int):
    """The dso512 workload: (its JSON fields, one step, the timed count,
    what a call is)."""
    from enarf_gan_tpu_torch.config import AttrDict
    from enarf_gan_tpu_torch.training import dso
    size = benchkit.env_int("BENCH_IMAGE_SIZE", 512)
    bs = benchkit.env_int("BENCH_BS", 16)
    iters = benchkit.env_int("BENCH_ITERS", 30)
    gen = benchkit.build_dso(benchkit.bench_params(tile_patch, 4096), device)
    pose_cam, cam_rot, bl, inv_K = benchkit.scene(bs, size, device)
    rs = np.random.RandomState(0)
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, np.float32)).to(device)
    batch = {
        "img": to(rs.uniform(-1, 1, (bs, 3, size, size))),
        "mask": to(rs.uniform(0, 1, (bs, size, size)) > 0.6),
        "pose_3d": pose_cam, "camera_rotation": cam_rot,
        "frame_time": to(np.linspace(0, 1, bs)), "bone_length": bl,
        "inv_intrinsics": inv_K.expand(bs, 3, 3).contiguous()}
    opt = dso.Optimizer(gen.parameters(), 1e-3, betas=(0.9, 0.99))
    loss_cfg = AttrDict({"nerf_loss_type": "mse", "color_coef": 1.0,
                         "mask_coef": 1.0})
    step = dso.make_train_step(gen, opt, loss_cfg, bg_color=-1.0)
    g = torch.Generator(device=device).manual_seed(1)
    fields = dict(metric="dso512_train_s_per_iter", unit="s/iter", bs=bs,
                  size=size, tile_patch=tile_patch, iters=iters)
    return fields, lambda: step(batch, g), iters, "step"


def demo1024(device, tile_patch: int):
    """The demo1024 workload, as ``dso512``."""
    from enarf_gan_tpu_torch.models.generator import make_dso_full_renderer
    size = benchkit.env_int("BENCH_IMAGE_SIZE", 1024)
    render_bs = benchkit.env_int("BENCH_RENDER_BS", 8192)
    reps = benchkit.env_int("BENCH_REPS", 3)
    gen = benchkit.build_dso(benchkit.bench_params(tile_patch, render_bs),
                             device)
    pose_cam, _, bl, inv_K = benchkit.scene(1, size, device)
    ft = torch.tensor([0.5], device=device)
    renderer = make_dso_full_renderer(gen, size, ray_batchsize=render_bs)

    @torch.no_grad()
    def frame():
        return renderer(pose_cam, inv_K, ft, bl,
                        generator=torch.Generator(device=device)
                        .manual_seed(2))

    fields = dict(metric="demo1024_s_per_frame", unit="s/frame", size=size,
                  tile_patch=tile_patch, render_bs=render_bs, reps=reps)
    return fields, frame, reps, "frame"


def _result(fields, out):
    """The workload's result fields, after a check of its output."""
    if fields["unit"] == "s/iter":
        if not np.isfinite(out["loss"]):
            raise RuntimeError(f"dso512: non-finite loss {out['loss']}")
        return {"loss": out["loss"]}
    if not all(bool(torch.isfinite(x).all()) for x in out):
        raise RuntimeError("demo1024: non-finite frame")
    return {"mask_mean": float(out[1].mean())}


def main(argv=None):
    args = benchkit.parser(__doc__).parse_args(argv)
    device = benchkit.resolve(args.device)
    which = os.environ.get("BENCH_WORKLOAD", "all")
    if which not in ("dso512", "demo1024", "all"):
        raise SystemExit(f"BENCH_WORKLOAD={which!r}: dso512, demo1024 or all")
    tiled = os.environ.get("BENCH_TILED")
    workloads = [build(device, tile_patch)
                 for tile_patch in ([int(tiled)] if tiled is not None
                                    else [0, 4])
                 for name, build in (("dso512", dso512),
                                     ("demo1024", demo1024))
                 if which in (name, "all")]
    # every workload on the host clock before the first profile: after a
    # torch.profiler session the host's launches may cost more
    timed = []
    for fields, fn, reps, per in workloads:
        benchkit.reset_peak(device)
        t0 = time.perf_counter()
        fn()
        benchkit.sync(device)
        compile_s = time.perf_counter() - t0
        benchkit.reset_launches()
        ms, out = benchkit.host_ms(fn, reps, device)
        timed.append(dict(
            value=ms / 1e3, peak_gib=benchkit.peak_gib(device),
            compile_s=compile_s, **_result(fields, out),
            **{f"launches_a_{per}": {k: v / reps for k, v in
                                     benchkit.launches().items()}}))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    records = []
    for (fields, fn, reps, per), t in zip(workloads, timed):
        if fields["unit"] == "s/frame":
            t["mrays_per_s"] = fields["size"] ** 2 / t["value"] / 1e6
        records.append(benchkit.emit(
            "production", device, **fields, **t,
            **benchkit.device_profile(fn, device, fields["metric"],
                                      t["value"] * 1e3, per)))
    return records


if __name__ == "__main__":
    main()
