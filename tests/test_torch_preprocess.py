"""The port's data preparation (``enarf_gan_tpu_torch/data_preprocess``)
against the top-level JAX scripts (``data_preprocess/``), on the CPU.

Each port CLI (``main(argv)`` with ``--device cpu``) and its JAX script
(run once, in a subprocess, as ``tests/test_preprocess.py`` runs it) read
the same synthetic inputs, built as that file builds them: a tiny SMPL
model, ZJU annotations and frames, NeuralActor videos and joint files,
a SURREAL clip with its sidecars and AIST++ frames behind a stub SDK
(the ZJU frames and the SURREAL clip get nonzero poses and betas where
that file's are zero, so that each frame's forward kinematics differs).
The caches must agree: ``imgs`` byte for byte, the SMPL poses and the
canonical poses (the forward kinematics, float64 in the port, float32 in
JAX) within 1e-5, every other array exactly, and ``sample_data.npz``
exactly. One item of each cache then loads through the port's datasets.
The AIST++ crop geometry is also held to the JAX script's own helpers on
random cameras and poses.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
import scipy.io
import torch

from enarf_gan_tpu.data.fixtures import (camera_ring, make_synthetic_smpl_npz,
                                         synthetic_pose_sequence,
                                         synthetic_rest_joints)

from enarf_gan_tpu_torch.config import AttrDict
from enarf_gan_tpu_torch.data import datasets
from enarf_gan_tpu_torch.data_preprocess import (prepare_canonical_pose,
                                                 prepare_sample_data)
from enarf_gan_tpu_torch.data_preprocess.AIST import preprocess as aist
from enarf_gan_tpu_torch.data_preprocess.NeuralActor import \
    preprocess as neuralactor
from enarf_gan_tpu_torch.data_preprocess.surreal import preprocess as surreal
from enarf_gan_tpu_torch.data_preprocess.surreal import \
    preprocess_depth as surreal_depth
from enarf_gan_tpu_torch.data_preprocess.ZJU import preprocess as zju

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")
FK_TOL = 1e-5
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jax(script, args, extra_env=None):
    env = dict(ENV, **(extra_env or {}))
    res = subprocess.run([sys.executable, script] + args, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    return res


def assert_caches_agree(port_dir, jax_dir, fk_keys=("smpl_pose",)):
    """``imgs`` byte for byte, the forward kinematics' arrays within
    FK_TOL, everything else exactly; same keys, dtypes and shapes."""
    got = np.load(os.path.join(port_dir, "cache.npz"))
    want = np.load(os.path.join(jax_dir, "cache.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        if k in fk_keys:
            diff = np.abs(a.astype(np.float64) - b).max()
            assert diff <= FK_TOL, (k, diff)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def smpl_dir(tmp_path_factory):
    """SMPL_{NEUTRAL,MALE,FEMALE}.npz and JAX's canonical poses beside
    them, which the dataset scripts of both packages copy."""
    d = tmp_path_factory.mktemp("smpl")
    for gender, seed in (("NEUTRAL", 0), ("MALE", 0), ("FEMALE", 1)):
        make_synthetic_smpl_npz(str(d / f"SMPL_{gender}.npz"), seed)
    run_jax("data_preprocess/prepare_canonical_pose.py",
            ["--smpl_dir", str(d), "--out_dir", str(d)])
    return d


def test_prepare_canonical_pose(smpl_dir, tmp_path):
    written = prepare_canonical_pose.main(
        ["--smpl_dir", str(smpl_dir), "--out_dir", str(tmp_path)] + CPU)
    assert len(written) == 3
    for gender in ("neutral", "male", "female"):
        got = np.load(tmp_path / f"{gender}_canonical.npy")
        want = np.load(smpl_dir / f"{gender}_canonical.npy")
        assert got.dtype == want.dtype == np.float32
        assert got.shape == (24, 4, 4)
        assert np.abs(got.astype(np.float64) - want).max() <= FK_TOL, gender
        np.testing.assert_array_equal(got[:, :3, :3], np.eye(3)[None]
                                      .repeat(24, 0))


def _zju_inputs(tmp_path, pid, n_frame, n_view):
    root = tmp_path / "zju" / f"CoreView_{pid}"
    (root / "new_params").mkdir(parents=True)
    extr = camera_ring(n_view, radius=3.0)
    size0 = 128
    K = np.array([[150.0, 0, size0 / 2], [0, 150.0, size0 / 2], [0, 0, 1]])
    ims = []
    for f in range(n_frame + 1):
        paths = {"ims": []}
        for v in range(n_view):
            rel = f"Camera_B{v + 1}/{f:06d}.jpg"
            (root / os.path.dirname(rel)).mkdir(parents=True, exist_ok=True)
            (root / "mask" / os.path.dirname(rel)).mkdir(parents=True,
                                                         exist_ok=True)
            img = np.zeros((size0, size0, 3), np.uint8)
            img[30:90, 40:80] = (180, 120, 90)
            cv2.imwrite(str(root / rel), img)
            mask = np.zeros((size0, size0, 3), np.uint8)
            mask[30:90, 40:80] = 255
            cv2.imwrite(str(root / "mask" / (rel[:-3] + "png")), mask)
            paths["ims"].append(rel)
        ims.append(paths)
    annots = {"cams": {"K": [K] * n_view,
                       "R": [extr[v][:3, :3].astype(np.float64)
                             for v in range(n_view)],
                       "T": [extr[v][:3, 3:].astype(np.float64) * 1000
                             for v in range(n_view)],
                       "D": [np.zeros((5, 1))] * n_view},
              "ims": ims}
    np.save(str(root / "annots.npy"), annots, allow_pickle=True)
    rs = np.random.RandomState(5)
    for f in range(n_frame + 2):
        # per-frame poses and betas, so that the batched forward
        # kinematics meets a different body in each frame
        param = {"poses": rs.uniform(-0.3, 0.3, (1, 72)).astype(np.float32),
                 "shapes": rs.uniform(-1, 1, (1, 2)).astype(np.float32),
                 "Rh": np.array([0.0, 0.1 * (f + 1), 0.0]),
                 "Th": np.array([0.0, 0.05 * f, 0.0])}
        np.save(str(root / "new_params" / f"{f}.npy"), param,
                allow_pickle=True)
    return tmp_path / "zju"


def test_zju_preprocess_and_sample_data(smpl_dir, tmp_path):
    n_frame, n_view, pid = 2, 2, "313"
    data = _zju_inputs(tmp_path, pid, n_frame, n_view)
    args = ["--data_path", str(data), "--smpl_dir", str(smpl_dir),
            "--person_id", pid, "--n_train_frame", str(n_frame),
            "--n_test_frame", "1", "--training_views", "0"]
    run_jax("data_preprocess/ZJU/preprocess.py",
            args + ["--write_path", str(tmp_path / "jax")])
    zju.main(args + ["--write_path", str(tmp_path / "port")] + CPU)
    for name in (f"train_cache_{n_frame}", f"test_novel_view_cache_{n_frame}",
                 "test_novel_pose_cache_1"):
        assert_caches_agree(tmp_path / "port" / f"CoreView_{pid}" / name,
                            tmp_path / "jax" / f"CoreView_{pid}" / name)

    cache_dir = tmp_path / "port" / f"CoreView_{pid}" / f"train_cache_{n_frame}"
    ds = datasets.SSODataset(AttrDict({"data_root": str(cache_dir),
                                       "n_frames": n_frame}), size=512,
                             num_repeat_in_epoch=1)
    assert len(ds) == n_frame
    item = ds[0]
    assert item["img"].shape == (3, 512, 512) and item["mask"].sum() > 0
    assert np.isfinite(item["pose_3d"]).all()
    assert not np.allclose(ds[0]["pose_3d"], ds[1]["pose_3d"])

    # the demo's sample data from the JAX cache, by both scripts
    jax_cache = tmp_path / "jax" / f"CoreView_{pid}" / f"train_cache_{n_frame}"
    sample_args = ["--data_root", str(jax_cache), "--num", "2"]
    run_jax("data_preprocess/prepare_sample_data.py",
            sample_args + ["--out", str(tmp_path / "jax_samples")])
    path = prepare_sample_data.main(sample_args
                                    + ["--out", str(tmp_path / "samples")])
    got, want = np.load(path), np.load(tmp_path / "jax_samples"
                                       / "sample_data.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _write_fake_aist_sdk(pkg_root, motion_len, img_hw=(480, 640)):
    """A minimal aist_plusplus package: frames from <video>.npy, one
    deterministic camera and motion (the SDK calls the scripts make)."""
    pkg = pkg_root / "aist_plusplus"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "utils.py").write_text(textwrap.dedent("""
        import numpy as np
        def ffmpeg_video_read(path, fps):
            return np.load(str(path) + ".npy")
    """))
    (pkg / "loader.py").write_text(textwrap.dedent(f"""
        import numpy as np

        class _Cam:
            def __init__(self):
                self.matrix = np.array([[500.0, 0, {img_hw[1]} / 2],
                                        [0, 500.0, {img_hw[0]} / 2],
                                        [0, 0, 1.0]])
                self.rvec = np.zeros(3)
                self.tvec = np.array([0.0, 0.0, 400.0])  # cm
                self.dist = np.zeros(5)

        class _CamGroup:
            def __init__(self):
                self.cameras = [_Cam()]

        class AISTDataset:
            VIEWS = ["c01"]
            def __init__(self, annotation_path):
                self.motion_dir = annotation_path
                self.camera_dir = annotation_path
                self.mapping_seq2env = _Env()
            @staticmethod
            def get_seq_name(video_name):
                return video_name.replace("_c01", "_cAll"), "c01"
            @staticmethod
            def load_camera_group(camera_dir, env_name):
                return _CamGroup()
            @staticmethod
            def load_motion(motion_dir, seq_name):
                T = {motion_len}
                rs = np.random.RandomState(0)
                poses = rs.uniform(-0.1, 0.1, (T, 72))
                # cm; keeps the root joint off the principal point, where
                # the crop's corner would be the floor of an integer
                trans = np.tile([[7.3, -4.1, 2.9]], (T, 1))
                return poses, np.array([90.0]), trans

        class _Env(dict):
            def __getitem__(self, k):
                return "env0"
    """))


def test_aist_preprocess(smpl_dir, tmp_path, monkeypatch):
    n3fps, H, W = 3, 480, 640
    videos = tmp_path / "videos"
    videos.mkdir()
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 255, (n3fps, H, W, 3)).astype(np.uint8)
    vid = videos / "gBR_sBM_c01_d07_mBR0_ch01.mp4"
    vid.write_bytes(b"")
    np.save(str(vid) + ".npy", frames)
    sdk = tmp_path / "sdk"
    _write_fake_aist_sdk(sdk, motion_len=20 * n3fps, img_hw=(H, W))
    args = ["--data_path", str(videos),
            "--annotation_path", str(tmp_path / "annot"),
            "--smpl_dir", str(smpl_dir), "--person_ids", "7",
            "--n_per_person", "4"]
    run_jax("data_preprocess/AIST/preprocess.py",
            args + ["--write_path", str(tmp_path / "jax")],
            extra_env={"PYTHONPATH": str(sdk)})
    monkeypatch.syspath_prepend(str(sdk))
    try:
        aist.main(args + ["--write_path", str(tmp_path / "port")] + CPU)
    finally:
        for name in [m for m in sys.modules if m.startswith("aist_plusplus")]:
            del sys.modules[name]
    sub = "cache128_aligned_crop_fl1500"
    for name in ("07", "all_all"):
        assert_caches_agree(tmp_path / "port" / sub / name,
                            tmp_path / "jax" / sub / name)
    all_dir = tmp_path / "port" / sub / "all_all"
    np.testing.assert_array_equal(np.load(all_dir / "canonical.npy"),
                                  np.load(smpl_dir / "male_canonical.npy"))

    ds = datasets.HumanDataset(AttrDict({"data_root": str(all_dir)}), size=128,
                               num_repeat_in_epoch=1)
    item = ds[0]
    assert item["img"].shape == (3, 128, 128)
    assert np.isfinite(item["pose_3d"]).all()
    assert 1.0 < item["pose_3d"][:, 2, 3].mean() < 20.0
    pitem = datasets.HumanPoseDataset(size=128, data_root=str(all_dir),
                                      num_repeat_in_epoch=1)[0]
    assert pitem["bone_mask"].shape == (128, 128)
    assert np.isfinite(pitem["pose_to_camera"]).all()


def _jax_script(rel):
    """A top-level JAX script as a module (its top level imports numpy
    only)."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_aist_crop_geometry_matches_jax():
    """The aligned crop's geometry on the device against the JAX script's
    per-frame numpy, on random cameras and poses, some of whose joints
    leave the image."""
    jaist = _jax_script("data_preprocess/AIST/preprocess.py")
    rs = np.random.default_rng(11)
    H, W, N = 1080, 1920, 64
    for _ in range(3):
        focal = rs.uniform(900, 1800, 2)
        K = np.array([[focal[0], 0, rs.uniform(900, 1000)],
                      [0, focal[1], rs.uniform(500, 580)], [0, 0, 1]])
        rmat = cv2.Rodrigues(rs.normal(0, 0.2, 3))[0]
        tvec = np.array([[0.0], [0.0], [400.0]]) + rs.normal(0, 20, (3, 1))
        pose = np.tile(np.eye(4, dtype=np.float32), (N, 24, 1, 1))
        pose[:, :, :3, 3] = rs.normal(0, 60, (N, 24, 3)) \
            + rs.normal(0, 80, (N, 1, 3))
        valid, top_left, intr = aist.crop_geometry(pose, rmat, tvec, K, H, W,
                                                   "cpu")
        side = int(jaist.CROP_SIZE * focal.mean() / jaist.STANDARD_FOCAL) \
            // 2 * 2
        assert aist.crop_side(K) == side
        assert 0 < valid.sum() < N
        for i in range(N):
            j2d = jaist._project_joints(pose[i], rmat, tvec, K)
            assert valid[i] == jaist._all_joints_visible(j2d, H, W)
            corner = (math.floor(j2d[0, 0]) - side // 2,
                      math.floor(j2d[0, 1]) - side // 2) if valid[i] \
                else (0, 0)
            assert tuple(top_left[i]) == corner
            np.testing.assert_array_equal(
                intr[i], jaist._rebase_intrinsics(K, corner, side))
    # the image stage: reflect padding where the square leaves the frame
    img = rs.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    for center in ((80.5, 60.2), (3.7, 5.1), (150.2, 110.9)):
        crop, corner = jaist._square_crop_reflect(img, center, 90)
        want = cv2.resize(crop, (jaist.SAVE_SIZE,) * 2,
                          interpolation=cv2.INTER_CUBIC)[:, :, ::-1]
        np.testing.assert_array_equal(aist.crop_frame(img, corner, 90), want)


def _surreal_inputs(tmp_path):
    """One SURREAL clip (frame, segmentation, info and depth sidecars)
    under ``tmp_path / "surreal"``."""
    H, W = 240, 320
    clip = tmp_path / "surreal" / "run0" / "a" / "b"
    clip.mkdir(parents=True)
    video_path = str(clip / "clip0.mp4")
    wr = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                         (W, H))
    assert wr.isOpened(), "cv2 lacks an mp4 encoder"
    img = np.zeros((H, W, 3), np.uint8)
    img[60:180, 120:200] = (40, 90, 210)
    wr.write(img)
    wr.release()
    mask = np.zeros((H, W), np.uint8)
    mask[60:180, 120:200] = 1
    scipy.io.savemat(video_path[:-4] + "_segm.mat", {"segm_1": mask})
    scipy.io.savemat(video_path[:-4] + "_info.mat", {
        "gender": np.array([[1]]),
        "pose": np.random.RandomState(3).uniform(-0.2, 0.2, (72, 1)),
        "shape": np.array([[0.5], [-0.3]]),
        "zrot": np.array([[0.3]]),
        "joints3D": np.broadcast_to(
            np.array([-4.0, 0.0, 0.0])[:, None, None], (3, 24, 1)).copy(),
        "camLoc": np.zeros((3, 1)),
    })
    depth = np.full((H, W), 1e10)                      # the void
    depth[60:180, 120:200] = 4.0 + np.linspace(0, 0.5, 80)[None]
    scipy.io.savemat(video_path[:-4] + "_depth.mat", {"depth_1": depth})
    return tmp_path / "surreal"


def test_surreal_preprocess_and_depth(smpl_dir, tmp_path):
    _surreal_inputs(tmp_path)
    args = ["--data_path", str(tmp_path / "surreal"),
            "--smpl_dir", str(smpl_dir)]
    for script, module, name in (("preprocess.py", surreal, "VAE_cache"),
                                 ("preprocess_depth.py", surreal_depth,
                                  "NARF_GAN_depth_cache")):
        run_jax(f"data_preprocess/surreal/{script}",
                args + ["--write_path", str(tmp_path / "jax")])
        out = module.main(args + ["--write_path", str(tmp_path / "port")]
                          + CPU)
        assert out == str(tmp_path / "port" / name)
        assert_caches_agree(out, tmp_path / "jax" / name)
        np.testing.assert_array_equal(
            np.load(os.path.join(out, "canonical.npy")),
            np.load(smpl_dir / "neutral_canonical.npy"))

    ds = datasets.HumanDataset(
        AttrDict({"data_root": str(tmp_path / "port" / "VAE_cache")}),
        size=128, num_repeat_in_epoch=1, return_mask=True)
    assert len(ds) == 1
    item = ds[0]
    assert item["img"].shape == (3, 128, 128)
    assert 0 < item["mask"].mean() < 0.9
    assert 2.0 < item["pose_3d"][:, 2, 3].mean() < 6.0
    depth_ds = datasets.SurrealPoseDepthDataset(
        AttrDict({"data_root": str(tmp_path / "port" /
                                   "NARF_GAN_depth_cache")}), size=128)
    ditem = depth_ds[0]
    assert ditem["img"].shape == (128, 128)
    assert ditem["img"].max() > 0.2 and ditem["img"].min() == 0
    assert np.isfinite(ditem["pose_3d"]).all()


def test_neuralactor_preprocess(tmp_path):
    pid, n_cam, n_frame, n_test = "lan", 2, 4, 2
    H = W = 96
    root = tmp_path / "na" / pid
    rest = synthetic_rest_joints()
    for split, nf in (("training", n_frame), ("testing", n_test)):
        (root / split / "rgb_video").mkdir(parents=True)
        tdir = root / split / "transform_smoth3e-2_withmotion"
        tdir.mkdir(parents=True)
        world = synthetic_pose_sequence(rest, nf)
        for cam in range(n_cam):
            path = str(root / split / "rgb_video" / f"{cam:03d}.avi")
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                                 25, (W, H))
            for f in range(nf):
                img = np.full((H, W, 3), 255, np.uint8)
                img[20 + f:60 + f, 30:70] = (50, 80, 200)
                wr.write(img)
            wr.release()
        for f in range(nf):
            data = {"joints_RT": world[f].transpose(1, 2, 0).tolist(),
                    "rotation": np.eye(3).tolist(),
                    "joints": world[f][:, :3, 3].tolist()}
            (tdir / f"{f:06d}.json").write_text(json.dumps(data))
    (root / "intrinsic").mkdir()
    (root / "pose").mkdir()
    extr = camera_ring(n_cam, radius=2.5)
    K = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]])
    for cam in range(n_cam):
        np.savetxt(str(root / "intrinsic" / f"0_train_{cam:04d}.txt"), K)
        cam2world = np.linalg.inv(extr[cam].astype(np.float64))
        np.savetxt(str(root / "pose" / f"0_train_{cam:04d}.txt"), cam2world)

    args = ["--data_path", str(tmp_path / "na"), "--person_id", pid,
            "--n_train_frame", str(n_frame), "--n_test_frame", str(n_test),
            "--n_camera", str(n_cam), "--n_process", "2"]
    run_jax("data_preprocess/NeuralActor/preprocess.py",
            args + ["--write_path", str(tmp_path / "jax")])
    neuralactor.main(args + ["--write_path", str(tmp_path / "port")])
    for name in (f"train_cache_{n_frame}", f"test_cache_{n_test}",
                 f"train_debug_cache_{n_frame}", f"test_debug_cache_{n_test}"):
        assert_caches_agree(tmp_path / "port" / pid / name,
                            tmp_path / "jax" / pid / name, fk_keys=())

    cache_dir = tmp_path / "port" / pid / f"train_cache_{n_frame}"
    ds = datasets.SSODataset(AttrDict({"data_root": str(cache_dir),
                                       "n_frames": n_frame}), size=H,
                             num_repeat_in_epoch=1)
    assert len(ds) == n_frame * n_cam
    item = ds[0]
    assert item["img"].shape == (3, H, W)
    assert 0 < item["mask"].mean() < 0.9
    assert np.isfinite(item["pose_3d"]).all()


def test_surreal_without_segmentation(smpl_dir, tmp_path):
    """``--no-segmentation`` writes the three-channel GAN_cache (JAX's
    flag is ``store_true`` with a true default, so it has no off switch)."""
    out = surreal.main(["--data_path", str(_surreal_inputs(tmp_path)),
                        "--smpl_dir", str(smpl_dir), "--write_path",
                        str(tmp_path / "port"), "--no-segmentation"] + CPU)
    assert out == str(tmp_path / "port" / "GAN_cache")
    cache = np.load(os.path.join(out, "cache.npz"))
    assert cache["imgs"].shape == (1, 3, 128, 128)
    assert cache["imgs"].dtype == np.uint8 and cache["imgs"].max() > 0


@pytest.mark.parametrize("script", ["zju", "surreal", "surreal_depth",
                                    "aist"])
def test_image_stage_without_cv2_raises(script, smpl_dir, tmp_path,
                                        monkeypatch):
    """Each pipeline with an image stage raises ImportError without cv2,
    before it writes anything; none turns it into skipped clips."""
    if script == "zju":
        main = zju.main
        args = ["--data_path", str(_zju_inputs(tmp_path, "313", 1, 1)),
                "--person_id", "313", "--n_train_frame", "1",
                "--n_test_frame", "1", "--training_views", "0"]
    elif script == "aist":
        main = aist.main
        _write_fake_aist_sdk(tmp_path / "sdk", motion_len=20)
        monkeypatch.syspath_prepend(str(tmp_path / "sdk"))
        (tmp_path / "videos").mkdir()
        args = ["--data_path", str(tmp_path / "videos"),
                "--annotation_path", str(tmp_path), "--person_ids", "7"]
    else:
        main = {"surreal": surreal.main,
                "surreal_depth": surreal_depth.main}[script]
        args = ["--data_path", str(_surreal_inputs(tmp_path))]
    monkeypatch.setitem(sys.modules, "cv2", None)
    try:
        with pytest.raises(ImportError):
            main(args + ["--smpl_dir", str(smpl_dir), "--write_path",
                         str(tmp_path / "out")] + CPU)
    finally:
        for name in [m for m in sys.modules if m.startswith("aist_plusplus")]:
            del sys.modules[name]
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("script", ["surreal", "surreal_depth"])
def test_surreal_device_errors_propagate(script, smpl_dir, tmp_path,
                                        monkeypatch):
    """A fault of the forward kinematics' device stops the run: only a
    clip's broken files are reported and skipped."""
    module = {"surreal": surreal, "surreal_depth": surreal_depth}[script]
    def failing(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(surreal, "smpl_forward", failing)
    with pytest.raises(RuntimeError, match="CUDA error"):
        module.main(["--data_path", str(_surreal_inputs(tmp_path)),
                     "--smpl_dir", str(smpl_dir), "--write_path",
                     str(tmp_path / "out")] + CPU)
