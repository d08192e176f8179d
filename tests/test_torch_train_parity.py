"""The port's DSO training render and train-step gradients against the JAX
package's on the exact path (the tiled path's cases run the same tests in
tests/test_torch_train_parity_tiled.py, and the float32 planes' of a
313_denarf.yml-shaped model, pose conditioning and the "mae" loss, on the
exact path, in tests/test_torch_train_parity_f32.py), at the tiny widths of
tests/test_training.py.

Same synthetic data (the JAX fixture's cache, read by the JAX dataset), the
same weights (the JAX model's perturbed parameters through the weight
bridge) and JAX's own random draws (``jax_train_randoms``).

The JAX reference runs with its packed tables in float32, holding the bf16
tables' values: the forward is the same function, and the table cotangents
then accumulate in float32, as the port's do (ROADMAP Queue 3). With the
bf16 tables, JAX's bf16 scatter-adds alone move the gradients of everything
upstream of the tables (the planes, the flow generator) by 2-3% relative L2
from the float32 sums, while the port sits within 0.1% of them.

Tolerances:
* ray_idx: identical (the same noise on the same dilated mask);
* color and mask: the exact sampler's JAX combine forms the feature
  products in bf16 and the tiled JAX path rounds the bilinear weights to
  bf16 (the port keeps float32), and the fine sampler's inverse-CDF bin
  pick is discontinuous: max |d| <= 5e-2, mean |d| <= 5e-3;
* gradients of the loss, parameter by parameter (matched by reference
  name): relative L2 error <= 2e-2 (as tests/test_torch_backward.py).
"""
import numpy as np
import jax
import pytest
import torch

from enarf_gan_tpu.config import AttrDict as JAttrDict
from enarf_gan_tpu.data.datasets import SSODataset
from enarf_gan_tpu.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu.training import dso as jdso
from enarf_gan_tpu.training.checkpoint import export_reference_state_dict
from enarf_gan_tpu.training.losses import photometric_loss as jloss_fn

from enarf_gan_tpu_torch.config import AttrDict
from enarf_gan_tpu_torch.interop import load_reference_state_dict
from enarf_gan_tpu_torch.training import dso
from enarf_gan_tpu_torch.training.losses import photometric_loss

from _torch_parity import (float32_jax_tables, jax_dso_variables,
                           jax_train_randoms, perturbed, tiny_dso_config)

FRAMES = (0, 3)   # two frames of the cache: B = 2
PATHS = {"exact": dict(tile_patch=0, loss="mse"),
         "tiled": dict(tile_patch=4, tile_coarse_corners=True, loss="mae"),
         "float32": dict(tile_patch=0, plane_sample_dtype="float32",
                         pose_conditional=True, loss="mae")}


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
    root = tmp_path_factory.mktemp("train_parity")
    make_synthetic_human_cache(str(root), size=32, n_frames=3, n_camera=2)
    return str(root)


@pytest.fixture(scope="module")
def case(synth_root, tmp_path_factory):
    return make_case("exact", synth_root, tmp_path_factory)


def make_case(name, synth_root, tmp_path_factory):
    """Both models with the same weights, one batch of two frames, JAX's
    draws, and JAX's (color, mask, ray_idx, loss gradients)."""
    path = dict(PATHS[name])
    loss_type = path.pop("loss")
    raw = tiny_dso_config(synth_root, str(tmp_path_factory.mktemp("out")),
                          **path)
    raw["loss"]["nerf_loss_type"] = loss_type
    jconfig = JAttrDict(raw)
    ds = SSODataset(jconfig.dataset.train, size=32, return_bone_params=True,
                    return_mask=True, num_repeat_in_epoch=1)
    batch = {k: np.stack([ds[i][k] for i in FRAMES])
             for k in ("img", "mask", "pose_3d", "frame_time", "bone_length",
                       "camera_rotation", "intrinsics")}
    jgen = jdso.build_generator(jconfig, ds.num_bone, ds.parents)
    jbatch = jdso.prepare_batch(batch)
    variables = perturbed(jax_dso_variables(jgen, jbatch, ds.canonical_pose),
                          seed=7)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    rng = jax.random.PRNGKey(4)

    def micro_loss(params):
        color, nerf_mask, ray_idx, _ = jgen.apply(
            {"params": params, **rest}, rng, jbatch["pose_3d"],
            jbatch["camera_rotation"], jbatch["mask"], jbatch["frame_time"],
            jbatch["bone_length"], jbatch["inv_intrinsics"], background=-1.0)
        lc, lm = jloss_fn(ray_idx, color, nerf_mask, jbatch["img"],
                          jbatch["mask"], loss_type, 1.0, 1.0)
        return lc + lm, (color, nerf_mask, ray_idx)

    with float32_jax_tables():
        (loss, (color, nerf_mask, ray_idx)), grads = jax.jit(
            jax.value_and_grad(micro_loss, has_aux=True))(params)
    ref_grads = export_reference_state_dict({**variables, "params": grads})

    port = dso.build_generator(AttrDict(raw), ds.num_bone, ds.parents,
                               device="cpu")
    load_reference_state_dict(port, export_reference_state_dict(variables))
    B, h, w = batch["mask"].shape
    n = int(ray_idx.shape[1])
    if path["tile_patch"]:
        P = path["tile_patch"]
        randoms = jax_train_randoms(rng, (B, (h // P) * (w // P)),
                                    B * n // (P * P), jgen.nerf_params.Nf)
    else:
        randoms = jax_train_randoms(rng, (B, h * w), B * n,
                                    jgen.nerf_params.Nf)
    return dict(port=port, batch=dso.prepare_batch(batch, "cpu"),
                randoms=randoms, loss_type=loss_type,
                ref=dict(loss=float(loss), color=np.asarray(color),
                         mask=np.asarray(nerf_mask),
                         ray_idx=np.asarray(ray_idx), grads=ref_grads))


def _render_and_loss(case):
    b = case["batch"]
    color, mask, ray_idx = case["port"](
        b["pose_3d"], b["camera_rotation"], b["mask"], b["frame_time"],
        b["bone_length"], b["inv_intrinsics"], background=-1.0,
        **case["randoms"])
    lc, lm = photometric_loss(ray_idx, color, mask, b["img"], b["mask"],
                              case["loss_type"], 1.0, 1.0)
    return color, mask, ray_idx, lc + lm


def test_training_render_matches_jax(case):
    with torch.no_grad():
        color, mask, ray_idx, loss = _render_and_loss(case)
    ref = case["ref"]
    np.testing.assert_array_equal(ray_idx.numpy(), ref["ray_idx"])
    assert float(ref["mask"].max()) > 0.05       # a non-empty foreground
    for got, want in ((color, ref["color"]), (mask, ref["mask"])):
        d = np.abs(got.numpy() - want)
        assert d.max() <= 5e-2 and d.mean() <= 5e-3, (d.max(), d.mean())
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=2e-2)


def test_train_step_gradients_match_jax(case):
    port = case["port"]
    port.zero_grad(set_to_none=True)
    _render_and_loss(case)[3].backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    ref = case["ref"]["grads"]
    assert set(grads) <= set(ref)
    checked = 0
    for name, g in grads.items():
        want = np.asarray(ref[name], np.float32)
        if not np.abs(want).max() > 0:
            assert g is None or float(g.abs().max()) < 1e-6, name
            continue
        err = float(np.linalg.norm(g.numpy() - want) / np.linalg.norm(want))
        assert err <= 2e-2, (name, err)
        checked += 1
    assert checked >= 0.8 * len(grads)
    assert grads["nerf.tri_plane"] is not None
