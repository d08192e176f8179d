"""The port's evaluation slice on the CPU at 16²: the GAN's forward that
the three scripts render through, their per-batch rules and the
Inception pipeline against the JAX package's, and the three CLIs
(``enarf_gan_tpu_torch.evaluation.compute_fid``, ``compute_PCK`` and
``compute_depth``) end to end on a tiny snapshot. JAX's CLIs are not run.

* The forward: one batch of 2 at 16² on float32 planes (the published
  ``config.yml`` files' sampler), the port's seeded weights carried into
  JAX (``_torch_parity.gan_pair_from_port``) and JAX's draws, with the
  disparity: as tests/test_torch_gan_background.py bounds it (JAX's
  jitted forward decides near ties otherwise), at most 10% of the pixels
  off by more than 1e-4 in image, mask or disparity, and the mean |d| of
  each within 2e-2.
* JAX's arrays of that batch go into both sides of the per-batch rules
  (the JAX scripts' lines, quoted below, beside the port's functions)
  and into both Inception pipelines (resize to 299² and the ``random:0``
  features; JAX's eager): the rules equal, the features within 1e-4 of
  their max.
* The CLIs write their metric files with finite values, the same on a
  second run; the FID caches the real statistics under the JAX package's
  key; each raises without a snapshot. The FID runs on an Inception npz
  of the exporter's names at a sixteenth of the width (128 features): the
  pipeline as it is, where a 2048² ``sqrtm`` would take tens of seconds.
"""
import os

import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.config import yaml_config
from enarf_gan_tpu_torch.data.fixtures import (make_synthetic_depth_cache,
                                               make_synthetic_human_cache)
from enarf_gan_tpu_torch.eval_lib import fid, inception
from enarf_gan_tpu_torch.evaluation import (compute_depth, compute_fid,
                                            compute_PCK)
from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training import gan

B, SIZE = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def forward_pair():
    """The port's and JAX's forward of one batch of 2, with the
    disparity, from the same weights and JAX's draws."""
    import jax
    import jax.numpy as jnp
    from _torch_parity import gan_pair_from_port, jax_gan_randoms
    jgen, variables, port, scene, z = gan_pair_from_port(
        size=SIZE, B=B, plane_sample_dtype="float32")
    assert port.nerf.texel_dtype == torch.float32
    pose_cam, world, bl, inv_K, _, _ = scene
    rng = jax.random.PRNGKey(3)
    img, mask, aux = jax.jit(lambda v, *a: jgen.apply(
        v, *a, truncation_psi=0.7, return_disparity=True))(
        variables, rng, *map(jnp.asarray, (pose_cam, world, bl, z, inv_K)))
    want = {"image": np.asarray(img), "mask": np.asarray(mask),
            "disparity": np.asarray(aux["disparity"])}
    with torch.no_grad():
        g_img, g_mask, g_aux = port(
            *map(_t, (pose_cam, world, bl, z, inv_K)), truncation_psi=0.7,
            return_disparity=True, **jax_gan_randoms(rng, port, B))
    got = {"image": g_img.numpy(), "mask": g_mask.numpy(),
           "disparity": g_aux["disparity"].numpy()}
    return got, want


def test_forward_matches_jax(forward_pair):
    got, want = forward_pair
    diff = np.maximum.reduce([
        np.abs(got["image"] - want["image"]).max(axis=1),
        np.abs(got["mask"] - want["mask"]),
        np.abs(got["disparity"] - want["disparity"])])
    assert (got["mask"] > 0.05).sum() > 40
    assert (got["disparity"] > 0).any()
    assert float((diff > 1e-4).mean()) <= 0.10
    for name in got:
        assert got[name].shape == want[name].shape
        assert np.abs(got[name] - want[name]).mean() <= 2e-2, name


def _jax_depth_batch(gen_disp, gt):
    """evaluation/compute_depth.py:71-74's reduction of a batch."""
    return ((gen_disp - gt) ** 2).sum(), gt.size


def _jax_projected_batch(m, p2d, size):
    """evaluation/compute_PCK.py:127-135's rule for a batch."""
    xi = np.clip(p2d[..., 0].round().astype(int), 0, size - 1)
    yi = np.clip(p2d[..., 1].round().astype(int), 0, size - 1)
    hit = m[np.arange(len(m))[:, None], yi, xi] > 0.5
    pred = np.where(hit[..., None], p2d, p2d + size)
    return pred, p2d


def test_per_batch_rules_match_jax(forward_pair):
    _, want = forward_pair
    rs = np.random.RandomState(4)
    gt = rs.uniform(0, 0.4, (B, SIZE, SIZE)).astype(np.float32)
    se, n = compute_depth.disparity_se(want["disparity"], gt)
    se_ref, n_ref = _jax_depth_batch(want["disparity"], gt)
    assert n == n_ref == B * SIZE * SIZE and se == se_ref and se > 0
    # joints over the frame and off it, half of them where the mask is
    ys, xs = np.nonzero(want["mask"][0] > 0.5)
    p2d = rs.uniform(-2, SIZE + 2, (B, 24, 2)).astype(np.float32)
    p2d[:, :12] = np.stack([xs[:12], ys[:12]], axis=1)[None] + 0.3
    pred, g = compute_PCK.projected_keypoints(want["mask"], p2d, SIZE)
    pred_ref, g_ref = _jax_projected_batch(want["mask"], p2d, SIZE)
    np.testing.assert_array_equal(pred, pred_ref)
    np.testing.assert_array_equal(g, g_ref)
    hit = (pred == p2d).all(axis=-1)
    assert hit[:, :12].all() and not hit.all()


def test_inception_pipeline_matches_jax(forward_pair):
    import jax.numpy as jnp
    from enarf_gan_tpu.eval_lib import fid as jfid
    from enarf_gan_tpu.eval_lib import inception_jax
    _, want = forward_pair
    imgs = np.clip(want["image"], -1, 1) * 127.5 + 127.5
    weights = {k: jnp.asarray(v)
               for k, v in inception_jax.random_weights(0).items()}
    ref = np.asarray(inception_jax.inception_features(
        jnp.asarray(jfid.resize_bilinear_299(imgs) / 127.5 - 1.0), weights))
    got = inception.make_extractor("random:0", device="cpu")(
        fid.resize_bilinear_299(_t(imgs)))
    assert got.shape == ref.shape == (B, 2048)
    scale = float(np.abs(ref).max())
    assert scale > 0 and np.abs(got - ref).max() <= 1e-4 * scale


CONFIG = """\
out_root: {root}/out
out: {out}
dataset:
  bs: 2
  image_size: {size}
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
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A synthetic cache, a depth cache, a config (one file as both) and a
    snapshot of its generator, seeded and perturbed so that it renders a
    foreground."""
    root = tmp_path_factory.mktemp("eval_cli")
    data = str(root / "data")
    make_synthetic_human_cache(data, size=SIZE, n_frames=2, n_camera=2)
    surreal = str(root / "surreal")
    make_synthetic_depth_cache(os.path.join(surreal, "NARF_GAN_depth_cache"),
                               size=SIZE, n_items=4)
    config = root / "config.yml"
    config.write_text(CONFIG.format(root=root, out="gan", size=SIZE,
                                    data=data))
    cfg = yaml_config(str(config), str(config))
    g = torch.Generator().manual_seed(0)
    gen = gan.build_generator(cfg, 24, SMPL_PARENTS, "cpu", generator=g)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    out_dir = str(root / "out" / "result" / "gan")
    ckpt.save_checkpoint(out_dir, {"iteration": 1,
                                   "gen": ckpt.gen_state_dict(gen)}, 1)
    args = ["--config", str(config), "--default_config", str(config),
            "--device", "cpu"]
    return dict(root=root, args=args, data=data, surreal=surreal,
                out_dir=out_dir)


def _read(path):
    with open(path) as f:
        return float(f.read())


def test_compute_depth_cli(run):
    argv = run["args"] + ["--surreal_path", run["surreal"], "--num_sample",
                          "4", "--batch_size", "2", "--truncation", "0.5"]
    first = compute_depth.main(argv)
    path = os.path.join(run["out_dir"], "disparity_mse_trunc0.5.txt")
    assert np.isfinite(first) and first > 0 and _read(path) == first
    assert compute_depth.main(argv) == first


def test_compute_pck_cli(run):
    for estimator in ("projected", "stub"):
        argv = run["args"] + ["--num_sample", "4", "--batch_size", "2",
                              "--estimator", estimator]
        first = compute_PCK.main(argv)
        path = os.path.join(run["out_dir"], f"pck_{estimator}.txt")
        assert np.isfinite(first) and 0 <= first <= 1
        assert _read(path) == first and compute_PCK.main(argv) == first
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compute_PCK.main(run["args"] + ["--estimator", "mmpose"])


def narrow_inception_npz(path, seed=0, div=16):
    """An Inception weight file in the exporter's names with every channel
    count of the graph divided by ``div`` (128 features at 16), He-init
    from ``seed``: the CLI's pipeline as it is, with a covariance whose
    square root takes milliseconds, where the full 2048² one takes tens of
    seconds here."""
    rs = np.random.RandomState(seed)
    w = {}
    for name, co, ci, kh, kw in inception._conv_specs():
        co, ci = co // div, ci if ci == 3 else ci // div
        w[f"{name}/conv/weight"] = rs.normal(
            0, np.sqrt(2.0 / (ci * kh * kw)), (co, ci, kh, kw)).astype(
                np.float32)
        w[f"{name}/bn/weight"] = np.ones(co, np.float32)
        w[f"{name}/bn/bias"] = np.zeros(co, np.float32)
        w[f"{name}/bn/running_mean"] = np.zeros(co, np.float32)
        w[f"{name}/bn/running_var"] = np.ones(co, np.float32)
    np.savez(path, **w)
    return str(path)


def test_compute_fid_cli(run, monkeypatch):
    weights = narrow_inception_npz(run["root"] / "inception_narrow.npz")
    monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", weights)
    argv = run["args"] + ["--num_sample", "4", "--batch_size", "2",
                          "--black_bg"]
    first = compute_fid.main(argv)
    # the real statistics' cache, under evaluation/compute_fid.py:86-89's
    # name for the weight set
    wnpz = os.environ.get("INCEPTION_WEIGHTS_NPZ", "")
    wtag = os.path.splitext(os.path.basename(wnpz))[0] if wnpz \
        else "torchvision"
    cache = os.path.join(run["data"], f"fid_stats_{SIZE}_{wtag}.npz")
    assert wtag == "inception_narrow" and os.path.exists(cache)
    assert compute_fid.stats_cache_path(run["data"], SIZE, wnpz) == cache
    stats = np.load(cache)
    assert stats["mu"].shape == (128,) and stats["sigma"].shape == (128, 128)
    path = os.path.join(run["out_dir"], "fid.txt")
    assert np.isfinite(first) and first > 0 and _read(path) == first
    assert compute_fid.main(argv) == first
    # the same images over the learned background score otherwise
    assert compute_fid.main(argv[:-1]) != first
    assert compute_fid.stats_cache_path(run["data"], SIZE, "random:0") \
        .endswith("fid_stats_16_random:0.npz")


def test_clis_raise_without_snapshot(run, tmp_path, monkeypatch):
    monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", "random:0")
    config = tmp_path / "config.yml"
    config.write_text(CONFIG.format(root=run["root"], out="never_trained",
                                    size=SIZE, data=run["data"]))
    args = ["--config", str(config), "--default_config", str(config),
            "--device", "cpu"]
    for main, extra in ((compute_fid.main, []), (compute_PCK.main, []),
                        (compute_depth.main,
                         ["--surreal_path", run["surreal"]])):
        with pytest.raises(FileNotFoundError, match="pretrained model"):
            main(args + extra)
    with pytest.raises(FileNotFoundError, match="iteration 7"):
        compute_depth.main(run["args"] + ["--surreal_path", run["surreal"],
                                          "--iteration", "7"])
