"""The 128² DSO frame split into sampler, heads and the rest (port of
``tools/bench_frame_ablate.py``).

Renders ``bench.py``'s frame (24-joint skeleton, deformation field, 256²
planes, Nc 48 + Nf 64, bf16 sampling, 4096-ray chunks, the model built on
``data.fixtures.tiny_scene``; ``benchkit.bench_params``) through the
port's entry point ``make_dso_full_renderer`` in three variants:

  full        the real frame
  nosampler   ENARF_ABLATE=sampler: no pack, no candidate rows or plan, no
              kernel 1 or 2 (``models/narf.py::_ablate_stage``)
  noheads     ENARF_ABLATE=heads: the heads' outputs a slice of the feature

so that sampler = full - nosampler and heads = full - noheads, on the host
clock and on the device's. JAX's XLA drops the stages as dead code inside
a jitted frame, which also drops the flow StyleGAN2 that makes the planes
(no consumer is left); the port runs eagerly and keeps it, so the port's
"rest" holds the plane generation (``frame_parts`` times it alone).

    python -m enarf_gan_tpu_torch.tools.frame_ablate [--device cpu]

Variables: REPS (3), ABLATE_VARIANTS (a comma-separated subset),
BENCH_RENDER_SIZE (128), BENCH_TILED (4 or 0: that path alone; unset: the
exact path, then the tiled one), BENCH_RAY_CHUNK (4096), BENCH_NC,
BENCH_NF, BENCH_FOCAL_SCALE (1.2), BENCH_PLANE_DTYPE; the smoke widths of
``benchkit``. ENARF_ABLATE is set for a variant and removed after it,
whatever happens.

One JSON line a variant: host ms a frame (each frame synchronised; after
a warm-up frame of each, the paths' variants take turns, REPS frames
each, all before the first profile: the mean, and the least and the most
beside it, for the host's spread from frame to frame is of the stages'
size), device ms, busy share and kernel launches of one more frame
(``profile_by_class``), the port kernels' launches a frame, and the card;
then one line a path with the split, and, on the card, the full frame's
host ms timed again after the profiles.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from enarf_gan_tpu_torch.tools import benchkit

VARIANTS = (("full", None), ("nosampler", "sampler"), ("noheads", "heads"))


def bench_frame(device: torch.device, tile_patch: int):
    """(frame(seed) → (color, mask, disparity), the model) of
    ``bench.py``'s frame on ``tile_patch``'s path."""
    from enarf_gan_tpu_torch.models.generator import make_dso_full_renderer
    size = benchkit.env_int("BENCH_RENDER_SIZE", 128)
    chunk = benchkit.env_int("BENCH_RAY_CHUNK", 4096)
    gen = benchkit.build_dso(benchkit.bench_params(tile_patch, chunk), device)
    pose_cam, _, bl, inv_K = benchkit.scene(
        1, size, device, benchkit.env_float("BENCH_FOCAL_SCALE", 1.2))
    ft = torch.tensor([0.5], device=device)
    render = make_dso_full_renderer(gen, size, ray_batchsize=chunk)

    @torch.no_grad()
    def frame(seed: int):
        g = torch.Generator(device=device).manual_seed(seed)
        return render(pose_cam, inv_K, ft, bl, generator=g)

    return frame, gen


@contextlib.contextmanager
def ablated(stage):
    """ENARF_ABLATE set to ``stage`` (or unset) inside the block only,
    whatever happens in it."""
    if stage:
        os.environ["ENARF_ABLATE"] = stage
    else:
        os.environ.pop("ENARF_ABLATE", None)
    try:
        yield
    finally:
        os.environ.pop("ENARF_ABLATE", None)


def _time(frames, device, cases, reps):
    """Host ms of each (path, variant, stage) in ``cases``: they take turns,
    one synchronised frame each, ``reps`` times, so that the host clock's
    drift falls on all of them alike; and each one's port kernel launches a
    frame."""
    times = {c[:2]: [] for c in cases}
    counts = {c[:2]: {} for c in cases}
    for _ in range(reps):
        for path, name, stage in cases:
            with ablated(stage):
                benchkit.reset_launches()
                ms, _ = benchkit.host_ms(lambda: frames[path](1), 1, device)
                for k, v in benchkit.launches().items():
                    counts[path, name][k] = counts[path, name].get(k, 0) \
                        + v / reps
            times[path, name].append(ms)
    return times, counts


def run_variants(frames, device, variants, reps: int):
    """Each (path, variant)'s record. Every frame on the host clock comes
    before the first profiled one: after a ``torch.profiler`` session the
    host's launches may cost more. A warm-up frame of each, then the timed
    turns (``_time``), then one profiled frame each; then each path's full
    frame is timed again, to show what the profiles left behind."""
    cases = [(path, name, stage) for path in frames
             for name, stage in variants]
    outs = {}
    for path, name, stage in cases:
        with ablated(stage):
            outs[path, name] = frames[path](0)          # warm-up
    times, counts = _time(frames, device, cases, reps)
    records = {path: [] for path in frames}
    for path, name, stage in cases:
        color, mask, _ = outs[path, name]
        if not bool(torch.isfinite(color).all()):
            raise RuntimeError(f"{path} {name}: non-finite frame")
        ms = float(np.mean(times[path, name]))
        with ablated(stage):
            prof = benchkit.device_profile(lambda: frames[path](1), device,
                                           f"{path} {name}", ms, "frame")
        c = counts[path, name]
        records[path].append(benchkit.emit(
            "frame_ablate", device, path=path, variant=name, ablate=stage,
            reps=reps, ms_host=ms, ms_host_min=min(times[path, name]),
            ms_host_max=max(times[path, name]), **prof, launches_a_frame=c,
            kernel1_launches=c["unirow_combine"] + c["unirow_combine_f32"],
            kernel2_launches=c["tilewin_combine"]
            + c["tilewin_combine_modes"],
            mask_mean=float(mask.mean())))
    full = [(path, "full", None) for path in frames
            if any(name == "full" for name, _ in variants)]
    after = _time(frames, device, full, reps)[0] if device.type == "cuda" \
        else {}
    return records, {path: float(np.mean(t)) for (path, _), t in
                     after.items()}


def split(records, device, path: str, after_ms=None):
    """sampler = full - nosampler, heads = full - noheads, rest = full -
    both, on each clock (None where a variant or the clock is missing);
    and the full frame's host ms after the profiles (``run_variants``)."""
    by = {r["variant"]: r for r in records}

    def stages(key):
        full = by.get("full", {}).get(key)
        out = {}
        for stage, variant in (("sampler", "nosampler"), ("heads", "noheads")):
            other = by.get(variant, {}).get(key)
            out[stage] = None if full is None or other is None \
                else full - other
        out["rest"] = None if None in (full, out["sampler"], out["heads"]) \
            else full - out["sampler"] - out["heads"]
        out["full"] = full
        return out

    return benchkit.emit("frame_ablate", device, path=path,
                         split_ms_host=stages("ms_host"),
                         split_device_ms=stages("device_ms"),
                         full_ms_host_after_profiles=after_ms)


def main(argv=None):
    args = benchkit.parser(__doc__).parse_args(argv)
    device = benchkit.resolve(args.device)
    reps = benchkit.env_int("REPS", 3)
    variants = VARIANTS
    if os.environ.get("ABLATE_VARIANTS"):
        want = set(os.environ["ABLATE_VARIANTS"].split(","))
        variants = [v for v in VARIANTS if v[0] in want]
    tiled = os.environ.get("BENCH_TILED")
    paths = [int(tiled)] if tiled is not None else [0, 4]
    frames = {f"tilewin{t}" if t else "exact": bench_frame(device, t)[0]
              for t in paths}
    records, after = run_variants(frames, device, variants, reps)
    return {path: {"variants": records[path],
                   "split": split(records[path], device, path,
                                  after.get(path))}
            for path in frames}


if __name__ == "__main__":
    main()
