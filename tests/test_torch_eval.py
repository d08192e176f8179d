"""The port's evaluation modules against the JAX package's, on the same
seeded numpy inputs, on the CPU.

* ``inception.random_weights(0)`` equals JAX's on every key, bit for bit
  (the same ``RandomState`` stream), so ``"random:0"`` is one weight set.
* InceptionV3 features of 2 images at 299² (the port's extractor, its
  whitening included, against JAX's ``inception_features`` run eagerly,
  once for the file: under ``jax.jit`` XLA constant-folds the average
  pools and takes longer): max |d| within 1e-4 of the features' max
  (1.6e-6 of it here).
* ``resize_bilinear_299`` from 32², 128² (enlarging) and 512² (shrinking,
  the triangle filter widened): max |d| 1e-3 in 0–255 units (5.3e-4).
* ``compute_statistics`` and ``frechet_distance`` (scipy in both): rtol
  1e-10, also where the covariances' product has no finite square root
  and the eps retry runs; the stats cache one package writes, the other
  reads; ``make_inception_extractor``'s sources.
* LPIPS with VGG and AlexNet backbones on a seeded npz at 64²: rtol 1e-4;
  ``lpips_available`` and ``lpips`` follow ``LPIPS_WEIGHTS_NPZ`` alike.
* PCK's math and ``StubEstimator``; the depth dataset's items and
  ``infinite_batches``: equal. The synthetic depth cache: intrinsics and
  canonical pose equal, poses and disparity to 2 ulps of 1 (JAX's
  fixture turns the bones with XLA's sin and cos).
"""
import os
import warnings

import numpy as np
import pytest
import torch

from enarf_gan_tpu.data import fixtures as jfixtures
from enarf_gan_tpu.data import loader as jloader
from enarf_gan_tpu.data.datasets import SurrealPoseDepthDataset as JDepth
from enarf_gan_tpu.eval_lib import fid as jfid
from enarf_gan_tpu.eval_lib import inception_jax
from enarf_gan_tpu.eval_lib import lpips_jax
from enarf_gan_tpu.eval_lib import metrics as jmetrics

from enarf_gan_tpu_torch.config import AttrDict
from enarf_gan_tpu_torch.data import fixtures, loader
from enarf_gan_tpu_torch.data.datasets import SurrealPoseDepthDataset
from enarf_gan_tpu_torch.eval_lib import fid, inception, lpips, metrics
from enarf_gan_tpu_torch.evaluation import compute_PCK, pck_estimators

from _torch_parity import seeded_lpips_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_random_weights_equal_jax():
    ours, ref = inception.random_weights(0), inception_jax.random_weights(0)
    assert list(ours) == list(ref)
    assert [s[0] for s in inception._conv_specs()] == \
        [s[0] for s in inception_jax._conv_specs()]
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.fixture(scope="module")
def images_299():
    """Two seeded 299² images in [0, 255] and JAX's features of them from
    ``random:0``, computed eagerly once."""
    import jax.numpy as jnp
    imgs = np.random.RandomState(0).uniform(
        0, 255, (2, 3, 299, 299)).astype(np.float32)
    weights = {k: jnp.asarray(v)
               for k, v in inception_jax.random_weights(0).items()}
    want = np.asarray(inception_jax.inception_features(
        jnp.asarray(imgs / 127.5 - 1.0), weights))
    return imgs, want


def test_inception_features_match_jax(images_299):
    imgs, want = images_299
    got = inception.make_extractor("random:0", batch_size=1,
                                   device="cpu")(imgs)
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert scale > 0 and np.abs(got - want).max() <= 1e-4 * scale


@pytest.mark.parametrize("size", [32, 128, 512])
def test_resize_bilinear_299_matches_jax(size):
    imgs = np.random.RandomState(size).uniform(
        0, 255, (2, 3, size, size)).astype(np.float32)
    got = fid.resize_bilinear_299(_t(imgs))
    want = jfid.resize_bilinear_299(imgs)
    assert got.shape == want.shape == (2, 3, 299, 299)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def _singular_pair():
    """Integer features of 2 samples in 3 dimensions whose covariances'
    product has no finite square root: the eps retry's case."""
    rs = np.random.RandomState(2)
    d = rs.randint(3, 7)
    n = rs.randint(2, d)
    return (rs.randint(-2, 3, (n, d)).astype(float),
            rs.randint(-2, 3, (n, d)).astype(float))


@pytest.mark.parametrize("case", ["full_rank", "rank_deficient"])
def test_statistics_and_frechet_distance_match_jax(case):
    from scipy import linalg
    if case == "full_rank":
        rs = np.random.RandomState(3)
        f1 = rs.randn(40, 8).astype(np.float32)
        f2 = (rs.randn(50, 8) * 1.3 + 0.2).astype(np.float32)
    else:
        f1, f2 = _singular_pair()
    got = [fid.compute_statistics(f) for f in (f1, f2)]
    want = [jfid.compute_statistics(f) for f in (f1, f2)]
    for (a_mu, a_s), (b_mu, b_s) in zip(got, want):
        np.testing.assert_array_equal(a_mu, b_mu)
        np.testing.assert_array_equal(a_s, b_s)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case == "rank_deficient":
            first, _ = linalg.sqrtm(want[0][1].dot(want[1][1]), disp=False)
            assert not np.isfinite(first).all()
        d_got = fid.frechet_distance(*got[0], *got[1])
        d_want = jfid.frechet_distance(*want[0], *want[1])
        f_got = fid.fid_between(f1, *got[1])
        f_want = jfid.fid_between(f1, *want[1])
    assert np.isfinite(d_got) and isinstance(d_got, float)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-10)
    np.testing.assert_allclose(f_got, f_want, rtol=1e-10)


def test_stats_cache_reads_across_packages(tmp_path):
    feats = np.random.RandomState(4).randn(30, 6).astype(np.float32)

    def never():
        raise AssertionError("the cache was not read")

    for write, read in ((fid, jfid), (jfid, fid)):
        path = str(tmp_path / f"{write.__name__.split('.')[0]}"
                   / "fid_stats_16_random:0.npz")
        mu, sigma = write.load_or_compute_dataset_stats(
            path, lambda: iter([feats[:10], feats[10:]]))
        assert os.path.exists(path)
        mu2, sigma2 = read.load_or_compute_dataset_stats(path, never)
        np.testing.assert_array_equal(mu2, mu)
        np.testing.assert_array_equal(sigma2, sigma)


def test_make_inception_extractor_sources(monkeypatch, tmp_path):
    monkeypatch.delenv("INCEPTION_WEIGHTS_NPZ", raising=False)
    with pytest.raises(RuntimeError, match="No InceptionV3 weights"):
        fid.make_inception_extractor(device="cpu")
    with pytest.raises(RuntimeError, match="No InceptionV3 weights"):
        fid.make_inception_extractor(str(tmp_path / "missing.npz"),
                                     device="cpu")
    # an exported npz: the graph's weights plus the heads the extractor drops
    w = inception.random_weights(1)
    path = str(tmp_path / "inception.npz")
    np.savez(path, **w, **{"AuxLogits/fc/weight": np.ones((2, 2), np.float32),
                           "fc/weight": np.ones((2, 2), np.float32),
                           "fc/bias": np.ones(2, np.float32)})
    img = np.random.RandomState(5).uniform(
        0, 255, (1, 3, 299, 299)).astype(np.float32)
    from_seed = fid.make_inception_extractor("random:1", device="cpu")(img)
    from_npz = fid.make_inception_extractor(path, device="cpu")(img)
    np.testing.assert_array_equal(from_npz, from_seed)
    monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", path)
    np.testing.assert_array_equal(
        fid.make_inception_extractor(device="cpu")(img), from_seed)
    assert set(inception.load_weights(path, "cpu")) == set(w)


@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_lpips_matches_jax(tmp_path, net_type):
    path = seeded_lpips_npz(tmp_path / f"lpips_{net_type}.npz", net_type)
    rs = np.random.RandomState(6)
    a = rs.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    b = np.clip(a + 0.3 * rs.randn(*a.shape), -1, 1).astype(np.float32)
    got = lpips.lpips_distance(a, b, path, device="cpu")
    want = lpips_jax.lpips_distance(a, b, path)
    assert isinstance(got, float) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert lpips.lpips_distance(a, a, path, device="cpu") == 0.0
    # an image the backbone shrinks to nothing (VGG under 16 pixels,
    # AlexNet under about 32): NaN in both
    small = (a[:, :, :16, :8], b[:, :, :16, :8])
    assert np.isnan(lpips.lpips_distance(*small, path, device="cpu"))
    assert np.isnan(lpips_jax.lpips_distance(*small, path))


def test_lpips_follows_the_weights_variable(monkeypatch, tmp_path):
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
    assert not metrics.lpips_available() and not jmetrics.lpips_available()
    rs = np.random.RandomState(7)
    a = rs.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    b = rs.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    for module in (metrics, jmetrics):
        with pytest.raises(FileNotFoundError, match="LPIPS_WEIGHTS_NPZ"):
            module.lpips(a, b)
    missing = str(tmp_path / "none.npz")
    assert not metrics.lpips_available(missing) and \
        not jmetrics.lpips_available(missing)
    path = seeded_lpips_npz(tmp_path / "lpips.npz", "vgg", seed=1)
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", path)
    assert metrics.lpips_available() and jmetrics.lpips_available()
    np.testing.assert_allclose(metrics.lpips(a, b, device="cpu"),
                               jmetrics.lpips(a, b), rtol=1e-4)


def test_pck_math_and_stub_estimator_match_jax():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_compute_pck", os.path.join(REPO, "evaluation", "compute_PCK.py"))
    jpck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jpck)
    spec = importlib.util.spec_from_file_location(
        "jax_pck_estimators",
        os.path.join(REPO, "evaluation", "pck_estimators.py"))
    jest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jest)
    rs = np.random.RandomState(8)
    gt = rs.uniform(0, 64, (6, 24, 2))
    pred = gt + rs.randn(6, 24, 2) * 4
    mask = rs.rand(6, 24) > 0.2
    mask[:, 5] = False                          # a keypoint never valid
    norm = compute_PCK.interocular_distance(gt, 16, 17)
    np.testing.assert_array_equal(norm, jpck.interocular_distance(gt, 16, 17))
    np.testing.assert_array_equal(compute_PCK.interocular_distance(gt),
                                  jpck.interocular_distance(gt))
    norm[2] = 0                                 # a sample without a norm
    for thr in (0.2, 0.5):
        got = compute_PCK.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        want = jpck.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[0][5] == -1 and got[2] == 23
    imgs = rs.uniform(-1, 1, (3, 3, 16, 20)).astype(np.float32)
    np.testing.assert_array_equal(
        pck_estimators.StubEstimator(24)(imgs), jest.StubEstimator(24)(imgs))
    for name in ("mmpose", "vitpose"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            compute_PCK.make_estimator(name, 24)


@pytest.fixture(scope="module")
def depth_caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth")
    ours, ref = str(root / "port"), str(root / "jax")
    a = fixtures.make_synthetic_depth_cache(ours, size=24, n_items=5, seed=2)
    b = jfixtures.make_synthetic_depth_cache(ref, size=24, n_items=5, seed=2)
    return ours, ref, a, b


def test_synthetic_depth_cache_matches_jax(depth_caches):
    ours, ref, a, b = depth_caches
    assert a["n_items"] == b["n_items"] == 5
    np.testing.assert_array_equal(a["canonical_pose"], b["canonical_pose"])
    mine, theirs = np.load(os.path.join(ours, "cache.npz")), \
        np.load(os.path.join(ref, "cache.npz"))
    assert set(mine.files) == set(theirs.files) == {
        "disparity", "camera_intrinsic", "smpl_pose"}
    for k in mine.files:
        assert mine[k].dtype == theirs[k].dtype == np.float32, k
    np.testing.assert_array_equal(mine["camera_intrinsic"],
                                  theirs["camera_intrinsic"])
    # JAX's fixture turns the bones with XLA's sin and cos, which round
    # some angles an ulp otherwise than numpy's: the poses and the
    # disparity they rasterise to agree to 2 ulps of 1
    for k in ("smpl_pose", "disparity"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=0, atol=2.4e-7,
                                   err_msg=k)
    assert (mine["disparity"] > 0).mean() > 0.02
    np.testing.assert_array_equal(
        np.load(os.path.join(ours, "canonical.npy")),
        np.load(os.path.join(ref, "canonical.npy")))


def test_depth_dataset_and_infinite_batches_match_jax(depth_caches):
    ours, _, _, _ = depth_caches
    mine = SurrealPoseDepthDataset(AttrDict({"data_root": ours}), size=24)
    ref = JDepth(AttrDict({"data_root": ours}), size=24)
    assert len(mine) == len(ref) == 5
    np.testing.assert_array_equal(mine.canonical_pose, ref.canonical_pose)
    for i in range(5):
        a, b = mine[i], ref[i]
        assert set(a) == set(b)
        assert a["img"].dtype == np.float32 and a["img"].shape == (24, 24)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
        np.testing.assert_array_equal(a["pose_to_camera"],
                                      a["pose_to_world"])
    # 3 epochs of batches of 2 (2 a shuffled epoch, one item dropped)
    got = loader.infinite_batches(loader.DataLoader(mine, 2, seed=3))
    want = jloader.infinite_batches(jloader.DataLoader(ref, 2, seed=3))
    for _ in range(6):
        a, b = next(got), next(want)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
