"""The port's SMPL forward kinematics, pose helpers and SMPL fixture
(``enarf_gan_tpu_torch/geometry/{smpl,pose}.py``,
``data/fixtures.make_synthetic_smpl_npz``) against the JAX package's, on
the CPU, from seeded numpy inputs.

The float32 transforms agree within 1e-5 (the port's forward kinematics
computes in float64 and regresses the joints in another order; JAX's runs
in float32 at ``Precision.HIGHEST``); the root rotation ``rvec_to_matrix``
agrees with ``cv2.Rodrigues`` within 1e-12; the fixture and the numpy
helpers equal JAX's exactly. The forward kinematics forms no (B, V, 3)
vertex array, and without a GPU it refuses the default device.
"""
import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from enarf_gan_tpu.data import fixtures as jfixtures
from enarf_gan_tpu.geometry import pose as jpose
from enarf_gan_tpu.geometry import smpl as jsmpl

from enarf_gan_tpu_torch.data import fixtures
from enarf_gan_tpu_torch.geometry import pose as tpose
from enarf_gan_tpu_torch.geometry import smpl as tsmpl

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed, V=200, L=10):
    """A random SMPL-shaped model: V vertices, L betas, a non-negative
    row-normalised regressor."""
    rs = np.random.default_rng(seed)
    J_regressor = rs.random((24, V)).astype(np.float32)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    return {"v_template": rs.normal(0, 0.3, (V, 3)).astype(np.float32),
            "shapedirs": rs.normal(0, 0.01, (V, 3, L)).astype(np.float32),
            "J_regressor": J_regressor, "parents": tsmpl.SMPL_PARENTS}


def _poses(seed, B, scale=0.6):
    rs = np.random.default_rng(seed)
    return (rs.normal(0, scale, (B, 72)).astype(np.float32),
            rs.normal(0, 1.0, (B, 10)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())


def test_rodrigues_matches_jax():
    aa = _poses(0, 40)[0].reshape(-1, 3)
    aa[:3] = 0                                   # the eps path at zero
    want = np.asarray(jsmpl.rodrigues(jnp.asarray(aa)))
    assert _max_diff(tsmpl.rodrigues(_t(aa)), want) <= TOL
    np.testing.assert_allclose(tsmpl.rodrigues_plain(aa), want, atol=TOL)


def test_rvec_to_matrix_matches_cv2():
    rs = np.random.default_rng(1)
    rvec = np.concatenate([rs.normal(0, 1.5, (30, 3)),
                           [[0.0, 0.0, 0.0], [1e-17, 0.0, 0.0],
                            [0.0, 3e-9, -1e-9], [np.pi, 0.0, 0.0]]])
    got = tsmpl.rvec_to_matrix(_t(rvec))
    assert got.dtype == torch.float64
    for r, R in zip(rvec, got.numpy()):
        assert np.abs(R - cv2.Rodrigues(r)[0]).max() <= 1e-12, r
    np.testing.assert_allclose(tsmpl.rvec_to_matrix_plain(rvec), got.numpy(),
                               rtol=0, atol=1e-12)
    # SMPL's rodrigues adds eps before the norm: not cv2's formula
    assert np.abs(tsmpl.rodrigues(_t(rvec[:1])).numpy()
                  - cv2.Rodrigues(rvec[0])[0]).max() > 1e-10


def test_blend_shapes_and_vertices2joints_match_jax():
    model = _model(2)
    _, betas = _poses(2, 6)
    want = np.asarray(jsmpl.blend_shapes(jnp.asarray(betas),
                                         jnp.asarray(model["shapedirs"])))
    got = tsmpl.blend_shapes(_t(betas), _t(model["shapedirs"]))
    assert _max_diff(got, want) <= TOL
    verts = model["v_template"][None] + want
    want_j = np.asarray(jsmpl.vertices2joints(
        jnp.asarray(model["J_regressor"]), jnp.asarray(verts)))
    got_j = tsmpl.vertices2joints(_t(model["J_regressor"]), _t(verts))
    assert _max_diff(got_j, want_j) <= TOL


def test_rigid_transform_matches_jax():
    aa, _ = _poses(3, 5)
    rots = np.asarray(jsmpl.rodrigues(jnp.asarray(aa.reshape(-1, 3))))
    rots = rots.reshape(5, 24, 3, 3)
    joints = np.random.default_rng(3).normal(0, 0.4, (5, 24, 3)) \
        .astype(np.float32)
    want = np.asarray(jsmpl.rigid_transform(jnp.asarray(rots),
                                            jnp.asarray(joints),
                                            jsmpl.SMPL_PARENTS))
    got = tsmpl.rigid_transform(_t(rots), _t(joints), tsmpl.SMPL_PARENTS)
    assert _max_diff(got, want) <= TOL
    assert _max_diff(tsmpl.rigid_transform_plain(rots, joints,
                                                 tsmpl.SMPL_PARENTS),
                     want) <= TOL


@pytest.mark.parametrize("pose2rot", [True, False])
def test_smpl_pose_transforms_matches_jax(pose2rot):
    model = _model(4)
    aa, betas = _poses(4, 7)
    pose = aa if pose2rot else np.asarray(
        jsmpl.rodrigues(jnp.asarray(aa.reshape(-1, 3)))).reshape(7, 24, 3, 3)
    args = (betas, pose, model["v_template"], model["shapedirs"],
            model["J_regressor"])
    want = np.asarray(jsmpl.smpl_pose_transforms(
        *map(jnp.asarray, args), model["parents"], pose2rot=pose2rot))
    got = tsmpl.smpl_pose_transforms(*map(_t, args), model["parents"],
                                     pose2rot=pose2rot)
    assert got.dtype == torch.float32 and got.shape == (7, 24, 4, 4)
    assert _max_diff(got, want) <= TOL
    if pose2rot:
        plain = tsmpl.smpl_pose_transforms_plain(*args, model["parents"])
        assert plain.dtype == np.float64 and _max_diff(plain, want) <= TOL
        assert _max_diff(tsmpl.smpl_forward(model, aa.reshape(7, 24, 3),
                                             betas, "cpu"), want) <= TOL


def test_smpl_forward_zero_betas_and_default_device():
    model = _model(5)
    aa, _ = _poses(5, 3)
    want = np.asarray(jsmpl.smpl_pose_transforms(
        jnp.zeros((3, 10), jnp.float32), jnp.asarray(aa),
        *(jnp.asarray(model[k]) for k in ("v_template", "shapedirs",
                                          "J_regressor"))))
    got = tsmpl.smpl_forward(model, aa, None, device="cpu")
    assert got.dtype == np.float32 and _max_diff(got, want) <= TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsmpl.smpl_forward(model, aa)


class _LargestOutput(TorchDispatchMode):
    """Records the most elements any operation's output holds."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_smpl_pose_transforms_forms_no_vertex_array():
    V, B = 6890, 256
    model = _model(6, V=V)
    aa, betas = _poses(6, B)
    args = [_t(x) for x in (betas, aa, model["v_template"],
                            model["shapedirs"], model["J_regressor"])]
    with _LargestOutput() as mode:
        out = tsmpl.smpl_pose_transforms(*args)
    assert out.shape == (B, 24, 4, 4)
    # the template and the 10 shape directions once: (11, V, 3)
    assert mode.most <= 11 * V * 3 < B * V * 3, mode.most


@pytest.mark.parametrize("batch", [2, 4])
def test_move_to_origin_and_axis_transformation(batch):
    aa, betas = _poses(7, batch)
    model = _model(7)
    A = tsmpl.smpl_forward(model, aa, betas, "cpu")
    # JAX's move_to_origin averages its hips over the batch (numpy puts the
    # [1, 2] index's axis first): it runs only on a batch of 2 and raises
    # on any other; the port does what it does
    if batch == 2:
        want = jsmpl.move_to_origin(A.copy(), 0.5)
        got = tsmpl.move_to_origin(_t(A.copy()), 0.5)
        assert _max_diff(got, want) <= TOL
        np.testing.assert_array_equal(got[:, :, :3, :3].numpy(),
                                      A[:, :, :3, :3])
    else:
        with pytest.raises(ValueError):
            jsmpl.move_to_origin(A.copy(), 0.5)
        with pytest.raises(RuntimeError):
            tsmpl.move_to_origin(_t(A.copy()), 0.5)
    want = jsmpl.axis_transformation(A[0].copy())     # (J, 4, 4)
    got = tsmpl.axis_transformation(_t(A[0].copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_canonical_pose_from_rest_joints_equals_jax():
    rest = fixtures.synthetic_rest_joints(3)
    np.testing.assert_array_equal(
        tsmpl.canonical_pose_from_rest_joints(rest),
        jsmpl.canonical_pose_from_rest_joints(rest))


@pytest.mark.parametrize("seed,n_betas", [(0, 2), (3, 10)])
def test_make_synthetic_smpl_npz_equals_jax(tmp_path, seed, n_betas):
    got = fixtures.make_synthetic_smpl_npz(str(tmp_path / "port.npz"), seed,
                                           n_betas)
    want = jfixtures.make_synthetic_smpl_npz(str(tmp_path / "jax.npz"), seed,
                                             n_betas)
    np.testing.assert_array_equal(got["rest_joints"], want["rest_joints"])
    assert got["n_vertices"] == want["n_vertices"]
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # at zero betas the model reproduces the rest skeleton
    model = dict(a)
    A = tsmpl.smpl_forward(model, np.zeros((1, 72), np.float32), None, "cpu")
    np.testing.assert_allclose(A[0, :, :3, 3], got["rest_joints"], atol=1e-6)


def test_make_synthetic_smpl_npz_full_size(tmp_path):
    """At SMPL's 6,890 vertices: blocks of 287 or 288 vertices a joint, a
    non-negative, row-normalised regressor, and the rest skeleton at zero
    betas."""
    got = fixtures.make_synthetic_smpl_npz(str(tmp_path / "full.npz"), 5,
                                           n_betas=10, n_vertices=6890)
    model = dict(np.load(tmp_path / "full.npz"))
    assert model["v_template"].shape == (6890, 3)
    assert model["shapedirs"].shape == (6890, 3, 10)
    J = model["J_regressor"]
    assert J.shape == (24, 6890) and (J >= 0).all()
    assert set(np.count_nonzero(J, axis=1)) == {287, 288}
    assert (np.count_nonzero(J, axis=0) == 1).all()
    np.testing.assert_allclose(J.sum(axis=1), 1, atol=1e-6)
    A = tsmpl.smpl_forward(model, np.zeros((1, 72), np.float32), None, "cpu")
    np.testing.assert_allclose(A[0, :, :3, 3], got["rest_joints"], atol=1e-5)


def test_rotations_match_jax():
    rs = np.random.default_rng(8)
    theta = rs.uniform(0, 2 * np.pi, 5).astype(np.float32)
    np.testing.assert_allclose(
        tpose.rotation_matrix(_t(theta)).numpy(),
        np.asarray(jpose.rotation_matrix(jnp.asarray(theta))), atol=TOL)
    aa, betas = _poses(8, 5)
    pose = tsmpl.smpl_forward(_model(8), aa, betas, "cpu")
    want = np.asarray(jpose.rotate_pose_by_angle(jnp.asarray(pose),
                                                 jnp.asarray(theta)))
    assert _max_diff(tpose.rotate_pose_by_angle(_t(pose), _t(theta)),
                     want) <= TOL
    R = rs.normal(size=(5, 4, 4)).astype(np.float32)
    want = np.asarray(jpose.rotate_pose(jnp.asarray(pose), jnp.asarray(R)))
    assert _max_diff(tpose.rotate_pose(_t(pose), _t(R)), want) <= TOL
    # JAX's draws cannot be made in torch: the angle drawn from the
    # generator is fed to JAX
    gen = torch.Generator().manual_seed(3)
    angle = torch.rand(5, generator=torch.Generator().manual_seed(3)) \
        * (2 * np.pi)
    got = tpose.rotate_pose_randomly(gen, _t(pose))
    want = np.asarray(jpose.rotate_pose_by_angle(
        jnp.asarray(pose), jnp.asarray(angle.numpy())))
    assert _max_diff(got, want) <= TOL
    assert (angle >= 0).all() and (angle < 2 * np.pi).all()


@pytest.mark.parametrize("loop", [True, False])
def test_interpolate_pose_equals_jax(loop):
    aa, betas = _poses(9, 3, scale=0.4)
    keys = tsmpl.smpl_forward(_model(9), aa, betas, "cpu").astype(np.float64)
    got = tpose.interpolate_pose(keys, tsmpl.SMPL_PARENTS, num=12, loop=loop)
    want = jpose.interpolate_pose(keys, jsmpl.SMPL_PARENTS, num=12, loop=loop)
    assert got.shape == (12, 24, 4, 4)
    np.testing.assert_array_equal(got, want)

