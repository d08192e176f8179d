"""The port's training pieces against the JAX package's: the ray samplers,
the photometric loss, the config merge, the optimiser, checkpoints, the
data path; and the port's gradient accumulation against one pass.

Tolerances: the samplers (the same noise) and the config are exact; the
loss 1e-6 (the
same float32 arithmetic); the optimiser 1e-6 on the parameters (the same
Adam update, summed in another order); the data bit-equal, except the
normalised image within 2e-7 (the JAX package computes x / 127.5 - 1 in
its compiled native helper, whose rounding differs from numpy's by one
float32 ulp); gradient accumulation 1e-5 relative L2 (two
micro-batches against one pass sum in another order).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from enarf_gan_tpu.config import AttrDict as JAttrDict
from enarf_gan_tpu.config import yaml_config as jyaml_config
from enarf_gan_tpu.data import datasets as jdatasets
from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache as jcache
from enarf_gan_tpu.nerf import ray_sampler as jrs
from enarf_gan_tpu.training import checkpoint as jckpt
from enarf_gan_tpu.training import dso as jdso
from enarf_gan_tpu.training import losses as jlosses

from enarf_gan_tpu_torch.config import AttrDict, yaml_config
from enarf_gan_tpu_torch.data import datasets
from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu_torch.data.loader import DataLoader
from enarf_gan_tpu_torch.nerf import ray_sampler
from enarf_gan_tpu_torch.training import checkpoint, dso, losses

from _torch_parity import jax_dso_variables, tiny_dso_config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_loop")
    jcache(str(root), size=32, n_frames=3, n_camera=2)
    return str(root)


def _mask(B=2, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    m = np.zeros((B, h, w), np.float32)
    m[:, 10:20, 12:18] = 1.0
    m[1, 2:5, 25:30] = rng.random((3, 5)) > 0.5
    return m


@pytest.mark.parametrize("rb", [100, 4096])
def test_mask_based_sampler_matches_jax(rb):
    mask = _mask()
    key = jax.random.PRNGKey(3)
    ref_idx, ref_homo = jrs.mask_based_sampler(key, jnp.asarray(mask), rb)
    noise = np.array(jax.random.uniform(key, (2, 32 * 32), jnp.float32))
    idx, homo = ray_sampler.mask_based_sampler(
        torch.from_numpy(mask), rb, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(homo.numpy(), np.asarray(ref_homo))


@pytest.mark.parametrize("rb,P", [(128, 4), (4096, 4), (40, 2)])
def test_patch_based_sampler_matches_jax(rb, P):
    mask = _mask()
    key = jax.random.PRNGKey(4)
    ref_idx, ref_homo = jrs.patch_based_sampler(key, jnp.asarray(mask), rb, P)
    noise = np.array(jax.random.uniform(key, (2, (32 // P) ** 2),
                                          jnp.float32))
    idx, homo = ray_sampler.patch_based_sampler(
        torch.from_numpy(mask), rb, P, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(homo.numpy(), np.asarray(ref_homo))


@pytest.mark.parametrize("loss_type", ["mse", "mae"])
def test_photometric_loss_matches_jax(loss_type):
    rng = np.random.default_rng(5)
    B, H, W, n = 2, 16, 16, 50
    img = rng.uniform(-1, 1, (B, 3, H, W)).astype(np.float32)
    mask = (rng.random((B, H, W)) > 0.5).astype(np.float32)
    ray_idx = rng.integers(0, H * W, (B, n)).astype(np.int32)
    color = rng.uniform(-1, 1, (B, 3, n)).astype(np.float32)
    color[0, 0, :5] = img.reshape(B, 3, -1)[0, 0, ray_idx[0, :5]]  # |d| < 0.01
    nmask = rng.random((B, n)).astype(np.float32)
    ref = jlosses.photometric_loss(jnp.asarray(ray_idx), jnp.asarray(color),
                                   jnp.asarray(nmask), jnp.asarray(img),
                                   jnp.asarray(mask), loss_type, 1.5, 0.5)
    got = losses.photometric_loss(torch.from_numpy(ray_idx.astype(np.int64)),
                                  torch.from_numpy(color),
                                  torch.from_numpy(nmask),
                                  torch.from_numpy(img),
                                  torch.from_numpy(mask), loss_type, 1.5, 0.5)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)


def test_yaml_config_matches_jax(tmp_path):
    """The port's copy of the two-file YAML config merges as the JAX one."""
    import yaml
    default = tiny_dso_config("data", "out")
    override = {"out": "run1", "lr": 0.002, "seed": 3,
                "dataset": {"bs": 4, "train": {"n_frames": 7}},
                "generator_params": {"nerf_params": {"tile_patch": 4}}}
    paths = []
    for name, d in (("o.yml", override), ("d.yml", default)):
        (tmp_path / name).write_text(yaml.safe_dump(d))
        paths.append(str(tmp_path / name))
    got = yaml_config(*paths, resume_latest=True, num_workers=3)
    assert got == jyaml_config(*paths, resume_latest=True, num_workers=3)
    assert got.generator_params.nerf_params.tile_patch == 4
    assert got.generator_params.nerf_params.Nf == 8
    assert got.dataset.train.n_frames == 7
    assert got.dataset.train.data_root == "data"
    assert got.dataset.num_workers == 3 and got.resume_latest is True


def test_optimiser_matches_optax():
    """Adam (b1 0.9, b2 0.99), lr 1e-3 * 0.9^k, and apply_if_finite over a
    gradient sequence with a non-finite step: the skipped step moves
    neither the parameters, nor Adam's moments, nor the schedule."""
    rng = np.random.default_rng(6)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    grads[2]["b"][1] = np.nan
    lr, gamma = 1e-3, 0.9
    tx = optax.apply_if_finite(optax.adam(optax.exponential_decay(
        lr, transition_steps=1, decay_rate=gamma), b1=0.9, b2=0.99), 100)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    opt = dso.Optimizer(tparams.values(), lr, gamma)
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        assert opt.step() == (i != 2)
        for k in p0:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(params[k]), rtol=0,
                                       atol=1e-6)
    assert opt.adam.param_groups[0]["lr"] == pytest.approx(lr * gamma ** 5)


def test_synthetic_cache_and_dataset_match_jax(synth_root, tmp_path):
    """The port's fixture writes the JAX fixture's arrays, and the port's
    SSODataset returns JAX's items from the JAX cache."""
    make_synthetic_human_cache(str(tmp_path), size=32, n_frames=3,
                               n_camera=2)
    mine = np.load(os.path.join(str(tmp_path), "cache.npz"))
    ref = np.load(os.path.join(synth_root, "cache.npz"))
    assert sorted(mine.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(mine[k], ref[k])
    cfg = {"data_root": synth_root, "n_frames": 3}
    jd = jdatasets.SSODataset(JAttrDict(cfg), size=32,
                              return_bone_params=True, num_repeat_in_epoch=2)
    td = datasets.SSODataset(AttrDict(cfg), size=32, return_bone_params=True,
                             num_repeat_in_epoch=2)
    assert len(td) == len(jd) == 12
    np.testing.assert_array_equal(td.canonical_pose, jd.canonical_pose)
    for i in (0, 5, 7):
        a, b = td[i], jd[i]
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            if k == "img":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-7)
            else:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]))


def _port_setup(synth_root, out_root, **nerf):
    config = AttrDict(tiny_dso_config(synth_root, out_root, **nerf))
    ds = datasets.SSODataset(config.dataset.train, size=32,
                             return_bone_params=True, num_repeat_in_epoch=4)
    gen = dso.build_generator(config, ds.num_bone, ds.parents, device="cpu")
    return config, ds, gen


@pytest.mark.parametrize("tile_patch", [0, 4])
def test_gradient_accumulation_matches_one_pass(synth_root, tmp_path,
                                                tile_patch):
    """n_accum_step = 2 on a duplicated batch, with the same draws for each
    micro-batch, against one pass over the batch."""
    config, ds, gen = _port_setup(synth_root, str(tmp_path),
                                  tile_patch=tile_patch)
    with torch.no_grad():                  # a non-empty foreground
        g = torch.Generator().manual_seed(7)
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    item = {k: v[None] for k, v in ds[0].items()}
    one = dso.prepare_batch(item, "cpu")
    two = {k: torch.cat([v, v]) for k, v in one.items()}
    g = torch.Generator().manual_seed(8)
    P = tile_patch
    n = 128
    noise = torch.rand((1, (32 // P) ** 2 if P else 32 * 32), generator=g)
    rows = n // (P * P) if P else n
    u, jit = (torch.rand((rows, config.generator_params.nerf_params.Nf),
                         generator=g)
              for _ in range(2))
    micro = {"ray_noise": noise, "draws": (u, jit)}
    both = {"ray_noise": torch.cat([noise, noise]),
            "draws": (torch.cat([u, u]), torch.cat([jit, jit]))}
    state = {k: v.clone() for k, v in gen.state_dict().items()}
    results = []
    for n_accum, randoms in ((1, [both]), (2, [micro, micro])):
        gen.load_state_dict(state)
        opt = dso.init_state(config, gen, ds.canonical_pose)
        step = dso.make_train_step(gen, opt, config.loss, -1.0, n_accum)
        m = step(two, randoms=randoms)
        assert m["applied"] and np.isfinite(m["loss"])
        results.append((m, {k: p.grad.clone() for k, p in
                            gen.named_parameters() if p.grad is not None}))
    (m1, g1), (m2, g2) = results
    assert m1["loss"] == pytest.approx(m2["loss"], rel=1e-5)
    assert set(g1) == set(g2) and "nerf.tri_plane" in g1
    for k in g1:
        err = float((g1[k] - g2[k]).norm() / g1[k].norm().clamp_min(1e-30))
        assert err <= 1e-5, (k, err)


def test_checkpoints_round_trip_through_jax_and_resume(synth_root, tmp_path):
    """The port's snapshot loads strictly into the JAX model through
    convert_torch_snapshot; the port resumes from its own snapshot at the
    saved iteration."""
    config, ds, gen = _port_setup(synth_root, str(tmp_path))
    config.num_iter = 2
    config.save_interval = 2
    loader = DataLoader(ds, 1, seed=0)
    g = torch.Generator().manual_seed(0)
    gen, opt, hist = dso.train_loop(config, gen, (ds, {}), (loader, {}),
                                    ds.canonical_pose, verbose=False,
                                    generator=g)
    assert len(hist) == 2 and np.isfinite(hist).all()
    out_dir = os.path.join(config.out_root, "result", config.out)
    path = checkpoint.latest_checkpoint(out_dir)
    assert path and os.path.exists(os.path.join(out_dir,
                                                "snapshot_50000.pth"))
    snap = checkpoint.load_checkpoint(path)
    assert snap["iteration"] == 2 and "state" in snap["gen_opt"]

    jconfig = JAttrDict(tiny_dso_config(synth_root, str(tmp_path)))
    jgen = jdso.build_generator(jconfig, ds.num_bone, ds.parents)
    batch = jdso.prepare_batch({k: v[None] for k, v in ds[0].items()})
    variables = jax_dso_variables(jgen, batch, ds.canonical_pose)
    out = jckpt.convert_torch_snapshot(path, {"iteration": 0,
                                              "gen": variables}, strict=True)
    assert out["iteration"] == 2
    exported = jckpt.export_reference_state_dict(out["gen"])
    state = gen.state_dict()
    assert set(exported) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(exported[k], np.float32),
                                      v.numpy())

    # resume: the generator and the iteration come back, the run goes on
    config.resume_latest = True
    config.num_iter = 3
    _, ds2, gen2 = _port_setup(synth_root, str(tmp_path))
    gen2, _, hist2 = dso.train_loop(config, gen2, (ds2, {}),
                                    (DataLoader(ds2, 1, seed=0), {}),
                                    ds2.canonical_pose, verbose=False,
                                    generator=torch.Generator().manual_seed(1))
    assert len(hist2) == 1                 # iterations 3 of 3
    resumed = checkpoint.load_checkpoint(path)
    assert resumed["iteration"] == 3       # the last iteration is saved too
