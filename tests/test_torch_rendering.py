"""The port's renderer against the JAX one with an analytic field (no
model), so the test is about the renderer alone: frustum probe, coarse
sampling, importance sampling with JAX's own draws, compositing, and the
view-dependent ray directions.

Tolerances: the frustum probe and the coarse samples are the same float32
expressions (1e-5). Composited pixels can differ where an ulp moves a fine
sample across a bin of the discontinuous inverse-CDF pick, so they are
bounded by a high quantile and the mean of |Δ| (where no bin moves they
agree to ~1e-6).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.nerf import rendering as jr
from enarf_gan_tpu_torch.data.fixtures import tiny_scene
from enarf_gan_tpu_torch.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu_torch.nerf import rendering as tr

from _torch_parity import t

SIZE, NC, NF = 16, 8, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rays():
    pose_cam, _, _, inv_K, _, _ = tiny_scene(1, SIZE)
    # re-rooted bone frames, as the model hands them to the renderer
    parent = SMPL_PARENTS[1:]
    pose = np.concatenate(
        [pose_cam[:, parent, :, :3],
         (pose_cam[:, 1:, :, 3:] + pose_cam[:, parent, :, 3:]) / 2], axis=-1)
    idx = np.arange(SIZE * SIZE)
    coords = np.stack([idx % SIZE + 0.5, idx // SIZE + 0.5,
                       np.ones(SIZE * SIZE)]).astype(np.float32)
    return pose.astype(np.float32), inv_K, coords[None, None]


def _jax_field(points, ray_dir, pose_scaled):
    """A smooth blob at the skeleton's centre, colored by position (and by
    ray direction when given)."""
    c = pose_scaled[:, :, :3, 3].mean(axis=1)[:, :, None]          # (B, 3, 1)
    density = 4.0 * jnp.exp(-((points - c) ** 2).sum(axis=1, keepdims=True))
    color = jnp.tanh(points)
    if ray_dir is not None:
        rep = points.shape[-1] // ray_dir.shape[-1]
        color = color + 0.5 * jnp.repeat(ray_dir, rep, axis=2)
    return density, color


def _torch_field(points, ray_dir, pose_scaled):
    c = pose_scaled[:, :, :3, 3].mean(dim=1)[:, :, None]
    density = 4.0 * torch.exp(-((points - c) ** 2).sum(dim=1, keepdim=True))
    color = torch.tanh(points)
    if ray_dir is not None:
        rep = points.shape[-1] // ray_dir.shape[-1]
        color = color + 0.5 * torch.repeat_interleave(ray_dir, rep, dim=2)
    return density, color


def test_frustum_and_coarse_samples_match():
    pose, inv_K, coords = _rays()
    pose_s = pose.copy()
    pose_s[:, :, :3, 3] *= 3.0
    ref = jr.decide_frustum_range(jnp.asarray(coords), jnp.asarray(pose_s),
                                  jnp.asarray(inv_K), 0.3, 5.0)
    got = tr.decide_frustum_range(t(coords), t(pose_s), t(inv_K), 0.3, 5.0)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[3].any() and not got[3].all()
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    rot = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    cam = rot[None].astype(np.float32)
    ref_c = jr.coarse_sample(jnp.asarray(coords), jnp.asarray(pose_s),
                             jnp.asarray(inv_K), Nc=NC,
                             camera_pose=jnp.asarray(cam), view_dependent=True)
    got_c = tr.coarse_sample(t(coords), t(pose_s), t(inv_K), Nc=NC,
                             camera_pose=t(cam), view_dependent=True)
    for a, b in zip(got_c, ref_c):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("view_dependent", [False, True])
def test_render_rays_matches(view_dependent):
    pose, inv_K, coords = _rays()
    cfg_kw = dict(Nc=NC, Nf=NF, coordinate_scale=3.0,
                  view_dependent=view_dependent)
    rot = np.linalg.qr(np.random.default_rng(1).normal(size=(3, 3)))[0]
    cam = rot[None].astype(np.float32) if view_dependent else None
    rng = jax.random.PRNGKey(5)
    ref = jr.render_rays(rng, _jax_field, jnp.asarray(coords),
                         jnp.asarray(pose), jnp.asarray(inv_K),
                         jr.RenderConfig(**cfg_kw),
                         camera_pose=None if cam is None else jnp.asarray(cam))
    k_bin, k_jit = jax.random.split(rng)
    draws = tuple(t(jax.random.uniform(k, (SIZE * SIZE, NF), jnp.float32))
                  for k in (k_bin, k_jit))
    got = tr.render_rays(_torch_field, t(coords), t(pose), t(inv_K),
                         tr.RenderConfig(**cfg_kw), draws,
                         camera_pose=None if cam is None else t(cam))
    assert float(got[1].max()) > 0.5          # the blob is in view
    for a, b in zip(got, ref[:3]):
        d = np.abs(a.numpy() - np.asarray(b))
        assert np.quantile(d, 0.99) <= 1e-3, np.quantile(d, 0.99)
        assert d.mean() <= 1e-3, d.mean()
