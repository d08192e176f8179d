"""The port's basic ops against the JAX package on the same numpy inputs.

Tolerances: these are the same float32 expressions in both packages, so
values agree to a few float32 ulps (1e-6 relative, 1e-5 where a value is a
sum of products); index and boolean results agree exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.geometry import encoding as jenc
from enarf_gan_tpu.geometry import pose as jpose
from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu.ops import activation as jact
from enarf_gan_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from enarf_gan_tpu.ops.triplane import select_candidate_bones as j_select
from enarf_gan_tpu.ops.upfirdn import make_blur_kernel, upfirdn2d as j_upfirdn

from enarf_gan_tpu_torch.geometry import encoding as tenc
from enarf_gan_tpu_torch.geometry import pose as tpose
from enarf_gan_tpu_torch.ops import activation as tact
from enarf_gan_tpu_torch.ops.grid_sample import grid_sample_2d
from enarf_gan_tpu_torch.ops.triplane import select_candidate_bones
from enarf_gan_tpu_torch.ops.upfirdn import upfirdn2d

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def test_density_relu_values_and_leaky_gradient():
    rs = np.random.default_rng(0)
    x = rs.normal(size=(4, 1, 50)).astype(np.float32)
    g = rs.normal(size=x.shape).astype(np.float32)
    y_ref, vjp = jax.vjp(jact.density_relu, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tact.density_relu(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), rtol=1e-7)
    # the leak: only where x < 0 and the cotangent is negative
    leak = (x < 0) & (g < 0)
    assert leak.any() and ((x < 0) & (g > 0)).any()
    np.testing.assert_allclose(xt.grad.numpy()[leak], 0.1 * g[leak], rtol=1e-6)


def test_straight_through_clamp():
    x = np.linspace(-4, 7, 23, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tact.straight_through_clamp(xt)
    y.sum().backward()
    close(y, jact.straight_through_clamp(jnp.asarray(x)), 0, 0)
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


@pytest.mark.parametrize("cos_first,cat_dim", [(True, 2), (False, 1),
                                               (True, 1), (False, 2)])
def test_positional_encoding(cos_first, cat_dim):
    x = np.random.default_rng(1).uniform(-2, 2, (2, 3, 17)).astype(np.float32)
    close(tenc.positional_encoding(torch.from_numpy(x), 5, cos_first, cat_dim),
          jenc.positional_encoding(jnp.asarray(x), 5, cos_first, cat_dim))


def test_multi_part_and_scalar_encoding():
    rs = np.random.default_rng(2)
    v = rs.uniform(-1.3, 1.3, (2, 23 * 3, 9)).astype(np.float32)
    close(tenc.multi_part_positional_encoding(torch.from_numpy(v), 4, 23),
          jenc.multi_part_positional_encoding(jnp.asarray(v), 4, 23))
    bl = rs.uniform(0.05, 1.5, (2, 23, 1)).astype(np.float32)
    close(tenc.multi_part_positional_encoding(torch.from_numpy(bl), 4, 23),
          jenc.multi_part_positional_encoding(jnp.asarray(bl), 4, 23))
    ft = rs.uniform(0, 1, (3,)).astype(np.float32)
    close(tenc.scalar_positional_encoding(torch.from_numpy(ft), 10),
          jenc.scalar_positional_encoding(jnp.asarray(ft), 10))


def test_in_cube_and_to_local():
    rs = np.random.default_rng(3)
    p = rs.uniform(-1.5, 1.5, (2, 3 * 5, 40)).astype(np.float32)
    for x in (p, p[:, :3]):
        np.testing.assert_array_equal(
            tenc.in_cube(torch.from_numpy(x)).numpy(),
            np.asarray(jenc.in_cube(jnp.asarray(x))))
    pose = rs.normal(size=(2, 5, 4, 4)).astype(np.float32)
    pts = rs.normal(size=(2, 3, 40)).astype(np.float32)
    close(tenc.to_local(torch.from_numpy(pts), torch.from_numpy(pose)),
          jenc.to_local(jnp.asarray(pts), jnp.asarray(pose)))


@pytest.mark.parametrize("origin", ["center", "center_fixed", "center+head"])
def test_transform_pose(origin):
    rs = np.random.default_rng(4)
    pose = rs.normal(size=(2, 24, 4, 4)).astype(np.float32)
    bl = rs.uniform(0.1, 0.5, (2, 23, 1)).astype(np.float32)
    out, blo = tpose.transform_pose(torch.from_numpy(pose), torch.from_numpy(bl),
                                    origin, SMPL_PARENTS)
    ref, blr = jpose.transform_pose(jnp.asarray(pose), jnp.asarray(bl), origin,
                                    SMPL_PARENTS)
    close(out, ref, 0, 0)
    close(blo, blr, 0, 0)
    canon = rs.normal(size=(24, 4, 4)).astype(np.float32)
    for a, b in zip(tpose.transform_canonical_pose(canon, SMPL_PARENTS, origin),
                    jpose.transform_canonical_pose(canon, SMPL_PARENTS, origin)):
        np.testing.assert_array_equal(a, b)


def test_grid_sample_2d():
    rs = np.random.default_rng(5)
    img = rs.normal(size=(3, 4, 7, 9)).astype(np.float32)
    grid = rs.uniform(-1.3, 1.3, (3, 60, 2)).astype(np.float32)
    grid[:, :4] = [[-1, -1], [1, 1], [-0.999, 0.999], [2, 2]]
    close(grid_sample_2d(torch.from_numpy(img), torch.from_numpy(grid)),
          j_grid_sample(jnp.asarray(img), jnp.asarray(grid)))


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (1, 1, (1, 1))])
def test_upfirdn2d(up, down, pad):
    rs = np.random.default_rng(6)
    x = rs.normal(size=(2, 3, 8, 8)).astype(np.float32)
    # the blur kernel, and an asymmetric one that would show a flip
    for kernel in (make_blur_kernel(upsample_factor=up),
                   rs.normal(size=(4, 4)).astype(np.float32)):
        close(upfirdn2d(torch.from_numpy(x), kernel, up, down, pad),
              j_upfirdn(jnp.asarray(x), kernel, up, down, pad))


@pytest.mark.parametrize("M", [1, 4])
def test_select_candidate_bones(M):
    rs = np.random.default_rng(7)
    pos = rs.uniform(-1.4, 1.4, (2, 23, 3, 200)).astype(np.float32)
    pos[..., :10] = 1.5          # points that no bone covers
    valid = (np.abs(pos) < 1).all(axis=2)
    got = select_candidate_bones(torch.from_numpy(pos), torch.from_numpy(valid), M)
    ref = j_select(jnp.asarray(pos), jnp.asarray(valid), M)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # ties (all invalid) resolve to the lowest bone ids, as in JAX
    assert (~valid).all(axis=1).any()


def test_numpy_scene_matches_the_jax_fixture():
    import __graft_entry__
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    for size, focal in ((16, 1.2), (128, 0.35)):
        got = tiny_scene(2, size, focal_scale=focal)
        ref = __graft_entry__._tiny_scene(2, size, focal_scale=focal)
        for a, b in zip(got, ref):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("groups,lr_mul", [(1, 1.0), (3, 0.5)])
def test_equal_conv1d(groups, lr_mul):
    from enarf_gan_tpu.nn.layers import EqualConv1d as JEqualConv1d
    from enarf_gan_tpu_torch.nn.layers import EqualConv1d
    rs = np.random.default_rng(8)
    x = rs.normal(size=(2, 6, 30)).astype(np.float32)
    jm = JEqualConv1d(12, groups=groups, lr_mul=lr_mul)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    bias = rs.normal(size=(12,)).astype(np.float32)
    ref = jm.apply({"params": {"weight": params["weight"],
                               "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    m = EqualConv1d(6, 12, groups=groups, lr_mul=lr_mul, device="cpu")
    m.load_state_dict({"weight": torch.from_numpy(np.array(params["weight"])),
                       "bias": torch.from_numpy(bias)})
    close(m(torch.from_numpy(x)), ref)
