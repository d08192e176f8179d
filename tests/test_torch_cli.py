"""The port's DSO CLIs (``enarf_gan_tpu_torch.train_DSO``,
``enarf_gan_tpu_torch.DSO_demo``) on the CPU, at 32² on the synthetic
cache, with two-file YAML configs read by the port's reader: a
``313_denarf.yml``-shaped model (deformation field, pose and time
conditioning, float32 planes, the exact sampler) at test widths.

Training writes its snapshot, log and validation image and resumes;
``--validation`` matches the JAX package's ``validate(crop=True)`` on the
same weights (the port's snapshot through ``convert_torch_snapshot``), the
same frames and the JAX renderer's own fine-sampler draws: PSNR and SSIM
within 1e-4 (both render in float32; the crop and the metrics are the same
numpy code), and with ``LPIPS_WEIGHTS_NPZ`` naming seeded VGG weights
LPIPS as JAX's ``validate(..., lpips_fn=metrics.lpips)`` computes it:
NaN on these crops (under VGG's 16 pixels) in both, and uncropped within
1e-3 relative (no ``color_LPIPS`` without the weights); the demo writes
one PNG a sample, read back with the port's decoder.
"""
import json
import os
import textwrap

import numpy as np
import jax
import pytest
import torch

from enarf_gan_tpu.config import yaml_config as jyaml_config
from enarf_gan_tpu.data.datasets import SSODataset as JSSODataset
from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu.data.loader import DataLoader as JDataLoader
from enarf_gan_tpu.eval_lib import metrics as jmetrics
from enarf_gan_tpu.training import checkpoint as jckpt
from enarf_gan_tpu.training import dso as jdso

from enarf_gan_tpu_torch import DSO_demo, train_DSO
from enarf_gan_tpu_torch.config import AttrDict
from enarf_gan_tpu_torch.data.datasets import SSODataset
from enarf_gan_tpu_torch.training import dso
from enarf_gan_tpu_torch.utils.logging import read_png

from _torch_parity import jax_fine_draws, seeded_lpips_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
NERF = """\
    w_dim: 32
    tri_plane_size: 16
    Nc: 6
    Nf: 8
    render_bs: 256
    deformation_field: True
    time_conditional: True
    pose_conditional: True
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The caches, the config files and a 3-iteration training run."""
    root = tmp_path_factory.mktemp("cli")
    train_root, val_root = str(root / "train"), str(root / "val")
    make_synthetic_human_cache(train_root, size=SIZE, n_frames=2, n_camera=2)
    make_synthetic_human_cache(val_root, size=SIZE, n_frames=1, n_camera=2,
                               seed=1)
    default = root / "default.yml"
    default.write_text(textwrap.dedent(f"""\
        out_root: {root}/out
        out: output_directory  # <- changed below
        dataset:
          bs: 2
          image_size: {SIZE}
          bg_color: -1
          train:
            data_root: {train_root}
            n_frames: 2
          val:
            novel_pose:
              data_root: {val_root}
              n_frames: 1
        generator_params:
          use_triplane: True
          ray_batchsize: 128
          nerf_params:
            hidden_size: 16
            no_ray_direction: True
            origin_location: center_fixed
            coordinate_scale: 3
            model_type: "narf"
        loss:
          color_coef: 1
          mask_coef: 1
          nerf_loss_type: mae
        num_iter: 150000
        lr: 0.01
        scheduler_gamma: 0.99995
        val_interval: 2
        print_interval: 100
        tensorboard_interval: 100
        save_interval: 500
        resume:
        """))
    config = root / "313_denarf.yml"
    config.write_text("out: DSO/ZJU/313_denarf\n"
                      "generator_params:\n  nerf_params:\n"
                      + textwrap.indent(NERF, "  "))
    argv = ["--config", str(config), "--default_config", str(default),
            "--device", "cpu"]
    _, _, history = train_DSO.main(argv + ["--iterations", "3"])
    out_dir = os.path.join(root, "out", "result", "DSO", "ZJU", "313_denarf")
    # a few steps from a fresh model still render an empty mask: perturb
    # the snapshot's parameters so that the renders below have a foreground
    # (from this seed about a quarter of each validation frame)
    path = os.path.join(out_dir, "snapshot_latest.pth")
    snap = torch.load(path, weights_only=True)
    g = torch.Generator().manual_seed(1)
    for name, v in snap["gen"].items():
        if not name.startswith("nerf.canonical_"):
            v.add_(0.3 * torch.randn(v.shape, generator=g))
    torch.save(snap, path)
    return dict(root=root, argv=argv, history=history, val_root=val_root,
                out_dir=out_dir)


def test_train_cli_writes_snapshot_log_and_resumes(run):
    out_dir, argv = run["out_dir"], run["argv"]
    assert len(run["history"]) == 3 and np.isfinite(run["history"]).all()
    snap = torch.load(os.path.join(out_dir, "snapshot_latest.pth"),
                      weights_only=True)
    assert snap["iteration"] == 3           # the last iteration is saved
    assert snap["gen"]["nerf.tri_plane"].dtype == torch.float32
    with open(os.path.join(out_dir, "log.json")) as f:
        log = json.load(f)
    assert "val_loss_novel_pose_color_PSNR" in log["2"]
    grid = read_png(os.path.join(out_dir, "novel_pose_0.png"))
    assert grid.shape == (SIZE, 2 * SIZE, 3)     # render beside the truth
    with open(os.path.join(out_dir, "command.txt")) as f:
        assert f.read().strip()
    _, _, more = train_DSO.main(argv + ["--resume_latest", "--iterations",
                                        "4"])
    assert len(more) == 1                   # iteration 4 of 4
    snap = torch.load(os.path.join(out_dir, "snapshot_latest.pth"),
                      weights_only=True)
    assert snap["iteration"] == 4


def test_validation_cli_matches_jax(run, monkeypatch):
    root, argv = run["root"], run["argv"]
    jconfig = jyaml_config(argv[1], argv[3])
    jds = JSSODataset(jconfig.dataset.val.novel_pose, size=SIZE,
                      return_bone_params=True, return_mask=True,
                      num_repeat_in_epoch=1, load_camera_intrinsics=True)
    jgen = jdso.build_generator(jconfig, jds.num_bone, jds.parents)
    b = jdso.prepare_batch({k: v[None] for k, v in jds[0].items()})
    # the snapshot's template: the variables' shapes, traced without
    # running the init (each leaf the snapshot carries is imported,
    # strict=True below; the rest, the mapping's w_avg statistics, start
    # at zero, as the init sets them)
    shapes = jax.eval_shape(lambda r: jgen.init(
        r, r, *(b[k] for k in ("pose_3d", "camera_rotation", "mask",
                               "frame_time", "bone_length",
                               "inv_intrinsics"))), jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), shapes)
    rng = jax.random.PRNGKey(0)
    # the port's validation renders with the JAX renderer's draws (JAX's
    # validate renders every frame from the same key)
    chunk = jgen.nerf_params.render_bs
    draws = jax_fine_draws(rng, SIZE * SIZE // chunk, chunk,
                           jgen.nerf_params.Nf)
    real = dso.make_dso_full_renderer
    masks = []

    def with_jax_draws(gen, size, **kw):
        render = real(gen, size, **kw)

        def draw(*a, generator=None, **k):
            out = render(*a, draws=draws, **k)
            masks.append(out[1])
            return out

        return draw

    monkeypatch.setattr(dso, "make_dso_full_renderer", with_jax_draws)
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
    got = train_DSO.main(argv + ["--validation"])
    with open(os.path.join(run["out_dir"], "val_metrics.json")) as f:
        assert json.load(f) == got
    # LPIPS weights named: the same validation with LPIPS as well, and
    # again without the crop (the crops here, 8 and 10 pixels wide, are
    # too small for VGG's four pools: LPIPS is NaN there in both packages)
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", seeded_lpips_npz(
        run["root"] / "lpips_vgg.npz", "vgg", seed=3))
    got_lpips = train_DSO.main(argv + ["--validation"])
    cropped = dso.validate
    monkeypatch.setattr(dso, "validate",
                        lambda *a, **k: cropped(*a, **{**k, "crop": False}))
    got_full = train_DSO.main(argv + ["--validation"])
    snap = jckpt.convert_torch_snapshot(
        os.path.join(run["out_dir"], "snapshot_latest.pth"),
        {"iteration": 0, "gen": variables}, strict=True)
    loaders = {"novel_pose": JDataLoader(jds, 1, shuffle=False,
                                         drop_last=False)}
    want = jdso.validate(jgen, snap["gen"], jconfig, loaders, rng, crop=True,
                         metrics=("PSNR", "SSIM"))
    # JAX's validate given the LPIPS its train_DSO.py leaves out (it lists
    # the metric but passes no lpips_fn, and writes 0.0)
    want_full = jdso.validate(jgen, snap["gen"], jconfig, loaders, rng,
                              metrics=("LPIPS",), lpips_fn=jmetrics.lpips)
    # two frames, each with a foreground, so that the parity says something
    # (rendered without LPIPS, with it, and with it uncropped)
    assert len(masks) == 6 and all(float((m > 0.05).sum()) > 20
                                   for m in masks)
    assert set(got) == set(got_lpips) == set(want) == {"novel_pose"}
    assert set(got["novel_pose"]) == set(want["novel_pose"])
    assert set(got_lpips["novel_pose"]) == set(got["novel_pose"]) | {
        "color_LPIPS"}
    assert "color_LPIPS" not in got["novel_pose"]
    for key in ("color_PSNR", "color_SSIM"):
        np.testing.assert_allclose(got["novel_pose"][key],
                                   want["novel_pose"][key], rtol=0, atol=1e-4)
        assert got_lpips["novel_pose"][key] == got["novel_pose"][key]
    assert np.isfinite(got["novel_pose"]["color_PSNR"])
    # NaN, as JAX's LPIPS is on images under VGG's 16 pixels
    # (tests/test_torch_eval.py::test_lpips_matches_jax)
    assert np.isnan(got_lpips["novel_pose"]["color_LPIPS"])
    lp = got_full["novel_pose"]["color_LPIPS"]
    assert np.isfinite(lp) and lp > 0
    np.testing.assert_allclose(lp, want_full["novel_pose"]["color_LPIPS"],
                               rtol=1e-3)


def test_demo_cli_writes_the_samples(run):
    root = run["root"]
    ds = SSODataset(AttrDict(data_root=run["val_root"], n_frames=1),
                    size=SIZE, num_repeat_in_epoch=1)
    samples = root / "samples"
    samples.mkdir()
    np.savez(samples / "sample_data.npz",
             **{k: np.stack([ds[i][k] for i in range(2)])
                for k in ("pose_3d", "bone_length", "intrinsics")})
    config = root / "demo_313_denarf.yml"
    config.write_text(
        f"out_root: {root}/out\nout: DSO/ZJU/313_denarf\n"
        f"sample_path: {samples}\n"
        f"canonical_pose_path: {run['val_root']}/canonical.npy\n"
        f"dataset:\n  image_size: {SIZE}\n"
        "generator_params:\n  use_triplane: True\n  nerf_params:\n"
        + textwrap.indent(NERF, "  "))
    paths = DSO_demo.main(["--config", str(config), "--default_config",
                           os.path.join(REPO, "configs/DSO_demo/default.yml"),
                           "--render_bs", "256", "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["0000.png", "0001.png"]
    for p in paths:
        img = read_png(p)
        assert img.shape == (SIZE, SIZE, 3) and img.min() < img.max()
