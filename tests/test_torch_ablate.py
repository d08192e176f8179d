"""The ENARF_ABLATE stand-ins of the port (``models/narf.py::_ablate_stage``)
against the JAX package's, and what they leave out.

* ``tests/test_ablate.py``'s four cases on the port: a warning when
  active, and every output shape as on the real path (the tiled path with
  ``with_stats`` included).
* Density and color under each stage, on both paths, against JAX's on the
  same weights and points: within 1e-5 of their scale. The sampler's
  stand-ins are functions of the candidate positions, and under "heads"
  the real sampler runs, so JAX computes its samplers in float32 as the
  port does (``_torch_parity.float32_jax_samplers``). A point for which
  the two packages pick other candidate bones (a near-tie of two bones'
  centralities an ulp apart, which their last-bit differences decide
  otherwise) is left out; at most 5% of the points may be (1 of 400
  here).
* Under "sampler" a whole frame on both paths packs no table and calls no
  kernel wrapper, nor builds the candidate rows or the tiled plan.
* With the variable unset (or empty) the outputs are the unablated ones,
  bit for bit, also after an ablated call.
"""
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.models import narf as jnarf
from enarf_gan_tpu_torch.models import generator as tgen
from enarf_gan_tpu_torch.models import narf as narf_mod
from enarf_gan_tpu_torch.ops import tilewin, unirow
from enarf_gan_tpu_torch.ops.tilewin import select_patch_slots
from enarf_gan_tpu_torch.ops.triplane import select_candidate_bones

from _torch_parity import PARENTS, build_pair, float32_jax_samplers, t

SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the models are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ablate(monkeypatch):
    """Set ENARF_ABLATE for the test, with both packages' warn-once flags
    reset, as ``tests/test_ablate.py`` does."""
    def set_stage(stage):
        monkeypatch.setenv("ENARF_ABLATE", stage)
        monkeypatch.setattr(narf_mod._ablate_stage, "_warned", False)
        monkeypatch.setattr(jnarf._ablate_stage, "_warned", False)
    monkeypatch.delenv("ENARF_ABLATE", raising=False)
    return set_stage


@pytest.fixture(scope="module")
def pairs():
    """Per path (JAX model, variables, port model, scene, inputs): the
    exact pair, and its tiled twin (tile_patch 4, coarse corners) with the
    same weights."""
    gen, variables, port, scene = build_pair(size=SIZE, ray_batchsize=64)
    over = dict(tile_patch=4, tile_coarse_corners=True)
    jtiled = gen.clone(nerf_params=dataclasses.replace(gen.nerf_params,
                                                       **over))
    tiled = tgen.DSONARFGenerator(
        dataclasses.replace(port.nerf_params, **over), num_bone=24,
        parent_id=PARENTS, device="cpu")
    tiled.load_state_dict(port.state_dict())
    inputs = _inputs(gen, variables, port, scene)
    return {"exact": (gen, variables, port, scene, inputs),
            "tiled": (jtiled, variables, tiled, scene, inputs)}


def _inputs(gen, variables, port, scene):
    """z, the scaled pose, the planes (op by op, as
    tests/test_torch_models.py computes them) and random points near the
    bones for each path: patch-coherent on the tiled one (6 patches x 16
    members x 8 samples)."""
    pose_cam, _, bl, _, _, _ = scene
    ft = jnp.asarray(np.array([0.5], np.float32))
    z = gen.apply(variables, ft, jnp.asarray(pose_cam), method="get_latents")
    pose_t, bl_t = gen.apply(variables, jnp.asarray(pose_cam),
                             jnp.asarray(bl), method="transform_pose")
    planes = gen.apply(variables, z, bl_t, method="compute_tri_plane_feature")
    pose_s = np.array(pose_t)
    pose_s[:, :, :3, 3] *= port.nerf_params.coordinate_scale
    rs = np.random.default_rng(0)
    n_patch, m, S = 6, 16, 8
    centres = pose_s[0, rs.integers(0, 23, (n_patch, 1, S)), :3, 3]
    centres = centres + rs.normal(scale=0.3, size=centres.shape)
    tiled = centres + rs.normal(scale=0.01, size=(n_patch, m, S, 3))
    centres = pose_s[0, rs.integers(0, 23, 400), :3, 3]
    exact = centres + rs.normal(scale=0.3, size=centres.shape)
    pts = {k: v.reshape(-1, 3).T[None].astype(np.float32)
           for k, v in (("exact", exact), ("tiled", tiled))}
    return z, pose_s, bl_t, planes, pts


def _run(pair, path, with_stats=False):
    """(JAX's outputs, the port's) of the point network on the path."""
    gen, variables, port, _, (z, pose_s, bl_t, planes, pts) = pair
    pts = pts[path]
    with torch.no_grad():
        if path == "tiled":
            tables = gen.apply(variables, planes, method="pack_planes_tiled")
            ref = gen.apply(variables, jnp.asarray(pts), jnp.asarray(pose_s),
                            bl_t, tables, z, 6, 16, 8, None, with_stats,
                            method="nerf_density_color_tiled")
            got = port.nerf_density_color_tiled(
                t(pts), t(pose_s), t(bl_t), port.pack_planes_tiled(t(planes)),
                t(z), 6, 16, 8, with_stats=with_stats)
        else:
            ref = gen.apply(variables, jnp.asarray(pts), jnp.asarray(pose_s),
                            bl_t, planes, z, None,
                            method="nerf_density_color")
            got = port.nerf_density_color(t(pts), t(pose_s), t(bl_t),
                                          port.pack_planes(t(planes)), t(z),
                                          None)
    return ref, got


@pytest.mark.parametrize("with_stats", [False, True])
def test_ablate_sampler_tiled_shapes(pairs, ablate, with_stats):
    """``tests/test_ablate.py``'s case on the port: under sampler, with and
    without the stats, the outputs keep the real path's shapes, and the
    stats their "clamped" share."""
    _, got0 = _run(pairs["tiled"], "tiled", with_stats)
    ablate("sampler")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, got1 = _run(pairs["tiled"], "tiled", with_stats)
    assert any("ENARF_ABLATE" in str(x.message) for x in w)
    assert len(got1) == len(got0)
    assert got1[0].shape == got0[0].shape and got1[1].shape == got0[1].shape
    if with_stats:
        assert float(got1[2]["clamped"]) == 0.0


@pytest.mark.parametrize("stage", ["sampler", "heads"])
def test_ablate_exact_path_shapes(pairs, ablate, stage):
    _, (d0, c0) = _run(pairs["exact"], "exact")
    ablate(stage)
    _, (d1, c1) = _run(pairs["exact"], "exact")
    assert d1.shape == d0.shape and c1.shape == c0.shape
    assert bool(torch.isfinite(d1).all())


def _same_candidates(pair, path):
    """The points for which both packages pick the same candidate bones
    (exact) or patch slots (tiled). Bones whose centralities are a float32
    ulp apart are picked otherwise where the two packages' canonical
    coordinates differ in the last bit."""
    from enarf_gan_tpu.geometry.encoding import in_cube
    from enarf_gan_tpu.ops.tilewin import select_patch_slots as jslots
    from enarf_gan_tpu.ops.triplane import select_candidate_bones as jbones
    gen, variables, port, _, (z, pose_s, bl_t, planes, pts) = pair
    x = pts[path]
    local, canonical = gen.apply(
        variables, jnp.asarray(x), jnp.asarray(pose_s), bl_t,
        method=lambda m, *a: m.nerf.to_local_and_canonical(*a))
    jvalid = in_cube(local) & (jnp.abs(canonical) < 1).all(axis=2)
    tcan, tvalid = port.nerf._canonical_validity(t(x), t(pose_s), t(bl_t))
    M = port.nerf_params.max_bones_per_point
    if path == "exact":
        ji = np.asarray(jbones(canonical, jvalid, M)[0])[0]      # (n, M)
        ti = select_candidate_bones(tcan, tvalid, M)[0][0].numpy()
        return (ji == ti).all(axis=1)
    ji = np.asarray(jslots(canonical, jvalid, 6, 16, 8, M)[0])[0]
    ti = select_patch_slots(tcan, tvalid, 6, 16, 8, M)[0][0].numpy()
    same = (ji == ti).all(axis=0)                               # (np, S)
    return np.broadcast_to(same[:, None], (6, 16, 8)).reshape(-1)


@pytest.mark.parametrize("path", ["exact", "tiled"])
@pytest.mark.parametrize("stage", ["sampler", "heads"])
def test_ablated_outputs_match_jax(pairs, ablate, path, stage):
    decided = _same_candidates(pairs[path], path)
    assert decided.mean() >= 0.95, decided.mean()
    ablate(stage)
    with float32_jax_samplers():
        ref, got = _run(pairs[path], path)
    assert (np.asarray(ref[0]) > 0).mean() > 0.05     # not all zero
    for a, b in zip(got[:2], ref[:2]):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy()[..., decided],
                                   b[..., decided], rtol=0,
                                   atol=1e-5 * scale)


def test_warns_once_a_process(pairs, ablate):
    ablate("heads")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _run(pairs["exact"], "exact")
        _run(pairs["tiled"], "tiled")
    assert sum("ENARF_ABLATE" in str(x.message)
               and "enarf_gan_tpu_torch" in x.filename for x in w) == 1


def _refuse(name):
    def refuse(*a, **k):
        raise AssertionError(f"{name} ran under ENARF_ABLATE=sampler")
    return refuse


@pytest.mark.parametrize("path", ["exact", "tiled"])
def test_sampler_stage_packs_and_launches_nothing(pairs, ablate,
                                                   monkeypatch, path):
    """A whole frame through ``make_dso_full_renderer``: no pack, no
    candidate rows or plan, no kernel wrapper."""
    port, scene = pairs[path][2:4]
    ablate("sampler")
    for module, name in ((unirow, "pack_texels"), (tilewin, "pack_texels"),
                         (narf_mod, "pack_texels"),
                         (narf_mod, "pack_tilewin_texels"),
                         (narf_mod, "sample_candidates_unirow"),
                         (narf_mod, "sample_tilewin_fused"),
                         (unirow, "candidate_rows"),
                         (unirow, "unirow_combine"),
                         (tilewin, "texel_plan"),
                         (tilewin, "tilewin_combine")):
        monkeypatch.setattr(module, name, _refuse(name))
    pose_cam, _, bl, inv_K, _, _ = scene
    render = tgen.make_dso_full_renderer(port, SIZE, ray_batchsize=64)
    with torch.no_grad():
        color, mask, disp = render(
            t(pose_cam), t(inv_K), torch.tensor([0.5]), t(bl),
            generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(x).all()) for x in (color, mask, disp))
    assert isinstance(port.pack_planes_tiled(torch.zeros(1)) if path ==
                      "tiled" else port.pack_planes(torch.zeros(1))[0],
                      narf_mod.AblatedTable)


@pytest.mark.parametrize("path", ["exact", "tiled"])
def test_unset_changes_nothing(pairs, ablate, monkeypatch, path):
    """Unset, then empty, then unset again after an ablated call: the
    outputs are the unablated ones bit for bit."""
    _, ref = _run(pairs[path], path)
    monkeypatch.setenv("ENARF_ABLATE", "")
    _, empty = _run(pairs[path], path)
    ablate("sampler")
    _run(pairs[path], path)
    monkeypatch.delenv("ENARF_ABLATE")
    _, again = _run(pairs[path], path)
    for a, b, c in zip(ref, empty, again):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_packed_under_sampler_refuses_the_real_sampler(pairs, ablate,
                                                      monkeypatch):
    """Planes packed under sampler, then the variable removed: the real
    sampler refuses the placeholder instead of reading it."""
    _, _, port, _, (z, pose_s, bl_t, planes, pts) = pairs["exact"]
    ablate("sampler")
    table = port.pack_planes(t(planes))
    monkeypatch.delenv("ENARF_ABLATE")
    with pytest.raises(ValueError, match="ENARF_ABLATE"):
        port.nerf_density_color(t(pts["exact"]), t(pose_s), t(bl_t), table,
                                t(z), None)
