"""The port's ENARF-GAN CLIs (``enarf_gan_tpu_torch.train_ENARF_GAN``,
``enarf_gan_tpu_torch.ENARF_GAN_demo``) on the CPU, at 16² and test widths
on the synthetic cache, with a two-file YAML config read by the port's
reader: ``config.yml``'s model (float32 planes, the exact sampler, the
cropped learned background) made small.

Training writes its snapshot, ``iter_10_succeeded.txt``, ``command.txt``
and the image grids of iteration 1, and resumes with ``--resume_latest``;
the JAX package's ``convert_torch_snapshot`` reads the snapshot, every
generator parameter equal to the port's. The demo writes the image, mask
and mesh PNGs of a sample, read back with the port's decoder at their
shapes, and raises without a snapshot. (The CLIs draw their random numbers
from torch; the forward, the mesh and the backgrounds are held to JAX's
in tests/test_torch_gan_background.py and tests/test_torch_mesh.py.)
"""
import os
import textwrap

import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch import ENARF_GAN_demo, train_ENARF_GAN
from enarf_gan_tpu_torch.data.datasets import HumanPoseDataset
from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.utils.logging import read_png

SIZE = 16


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
    """The cache, the sample data, the config and a 10-iteration run."""
    root = tmp_path_factory.mktemp("gan_cli")
    data = str(root / "data")
    make_synthetic_human_cache(data, size=SIZE, n_frames=2, n_camera=2)
    poses = HumanPoseDataset(size=SIZE, data_root=data, num_repeat_in_epoch=1)
    samples = str(root / "samples")
    os.makedirs(samples)
    np.savez(os.path.join(samples, "sample_data.npz"), **{
        k: np.stack([poses[i][k] for i in range(2)])
        for k in ("pose_to_camera", "pose_to_world", "bone_length",
                  "intrinsics")})
    config = root / "config.yml"
    config.write_text(textwrap.dedent(f"""\
        out_root: {root}/out
        out: gan
        sample_path: {samples}
        canonical_pose_path: {data}/canonical.npy
        dataset:
          bs: 2
          image_size: {SIZE}
          train:
            data_root: {data}
        generator_params:
          z_dim: 8
          background_ratio: 0.7
          crop_background: true
          pretrained_background: false
          channel_max: 32
          nerf_params:
            w_dim: 32
            tri_plane_size: 16
            hidden_size: 16
            Nc: 4
            Nf: 4
            origin_location: center_fixed
            coordinate_scale: 3
        discriminator_params:
          minibatch_std: false
          channel_max: 32
        loss:
          adv_loss_type: ce
          bone_guided_coef: 10
          r1_loss_coef: 10
          tri_plane_reg_coef: 0.001
        n_accum_step: 1
        num_iter: 800000
        save_interval: 200
        """))
    args = ["--config", str(config), "--default_config", str(config),
            "--device", "cpu"]
    _, _, history = train_ENARF_GAN.main(args + ["--iterations", "10"])
    return root, args, history


def test_train_cli_writes_its_outputs(run):
    root, _, history = run
    out = root / "out" / "result" / "gan"
    assert len(history) == 10
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert (out / "iter_10_succeeded.txt").read_text() == "ok"
    assert (out / "command.txt").read_text().strip()
    # the grids of iteration 1: bs 2 makes a 1 x 1 grid
    for name in ("rgb_0.png", "real.png", "bone_0.png"):
        img = read_png(str(out / name))
        assert img.shape == (SIZE, SIZE, 3), (name, img.shape)
    bone = read_png(str(out / "bone_0.png"))
    assert set(np.unique(bone)) <= {0, 255} and bone.max() == 255
    snap = ckpt.load_checkpoint(str(out / ckpt.LATEST))
    assert snap["iteration"] == 10
    assert set(snap) == {"iteration", "gen", "dis", "gen_opt", "dis_opt"}


def test_train_cli_snapshot_reads_into_jax(run):
    """The JAX package's ``convert_torch_snapshot`` maps every generator
    parameter of the CLI's snapshot, equal to the port's."""
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import yaml_config as jyaml_config
    from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
    from enarf_gan_tpu.training import checkpoint as jckpt
    from enarf_gan_tpu.training import gan as jgan
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    root, args, _ = run
    config = jyaml_config(args[1], args[3])
    jgen, _ = jgan.build_models(config, 24, SMPL_PARENTS)
    pose_cam, world, bl, inv_K, _, _ = tiny_scene(1, SIZE)
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(jgen.init, key, key, *map(jnp.asarray, (
        pose_cam, world, bl, np.zeros((1, 32), np.float32), inv_K)))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   jckpt.jax_tree_to_dict(template))
    path = str(root / "out" / "result" / "gan" / ckpt.LATEST)
    state = jckpt.convert_torch_snapshot(path, {"iteration": 0,
                                                "gen": zeros}, strict=True)
    assert state["iteration"] == 10
    exported = jckpt.export_reference_state_dict(state["gen"])
    snap = ckpt.load_checkpoint(path)["gen"]
    params = {k for k in snap if not k.endswith("w_avg")}
    assert params <= set(exported)
    for k in params:
        np.testing.assert_array_equal(exported[k], snap[k].numpy(), err_msg=k)


def test_train_cli_resumes(run):
    root, args, _ = run
    _, _, history = train_ENARF_GAN.main(
        args + ["--resume_latest", "--iterations", "11"])
    assert len(history) == 1
    snap = ckpt.load_checkpoint(
        str(root / "out" / "result" / "gan" / ckpt.LATEST))
    assert snap["iteration"] == 11


def test_demo_cli_writes_images_and_mesh(run):
    root, args, _ = run
    paths = ENARF_GAN_demo.main(args + [
        "--num_samples", "1", "--black_bg", "--mesh",
        "--mesh_voxel_size", "0.2"])
    names = sorted(os.path.basename(p) for p in paths)
    assert names == ["img_0000.png", "mask_0000.png", "mesh_0000.png"]
    shapes = {os.path.basename(p): read_png(p).shape for p in paths}
    assert shapes == {"img_0000.png": (SIZE, SIZE, 3),
                      "mask_0000.png": (SIZE, SIZE, 3),
                      "mesh_0000.png": (512, 512, 3)}
    for p in paths:
        assert os.path.dirname(p) == str(root / "out" / "result" / "gan"
                                          / "samples")


def test_demo_cli_raises_without_snapshot(run, tmp_path):
    _, args, _ = run
    config = tmp_path / "config.yml"
    text = open(args[1]).read().replace("out: gan", "out: never_trained")
    config.write_text(text)
    with pytest.raises(FileNotFoundError, match="model not loaded"):
        ENARF_GAN_demo.main(["--config", str(config), "--default_config",
                             str(config), "--num_samples", "1",
                             "--device", "cpu"])
