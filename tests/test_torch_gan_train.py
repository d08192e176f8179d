"""The port's GAN training (training/gan.py) and its data against the JAX
package's, at the sizes of tests/test_training.py::tiny_gan_config (32²
images, batch 4, two micro-batches, 16² planes, z_dim 16, channel_max 32)
on the exact path.

* Data: the pose prior's bone masks and every other key equal JAX's
  exactly (the same rasteriser on the same cache); the real images too,
  flips included (the same seed of ``random``), to the ulp by which JAX's
  native normaliser rounds otherwise (2e-7, as
  tests/test_torch_train_loop.py).
* One iteration, G step then D step then R1, from the same state (JAX's
  perturbed weights through the bridges) on the same batch with JAX's
  draws (z, fine sampler, background noise and crop, per micro-batch).
  Adam's first step with b1 = 0 moves each weight by about lr * sign of
  its gradient, so an update compares gradients' signs. G's gradients
  carry the rays that JAX's jitted float32 flips (see
  tests/test_torch_gan_model.py), which turns the sign of some gradients
  near 0: of all G's elements at most 2% may move otherwise than JAX's by
  more than lr / 2 (1.03% at this seed), at most 10% of any one tensor
  (the smallest hold 16 elements); of D's, at most 0.5% of each tensor
  in the D and in the R1 step (D's gradients follow the fakes). The losses: the
  adversarial and bone losses within 2e-2 relative, R1 within 1e-4. The
  tri-plane w_avg after the two micro-batches: 1e-5. JAX samples in
  float32 (``float32_jax_samplers``) as the port's combines do.
* The gradients themselves, for their scale: with b1 = 0 Adam's first
  moment after a step is that step's gradient, in the port's
  ``exp_avg`` as in optax's ``mu``. The flipped rays move D's verdict on
  the fakes and so every tensor of G's gradient by about 4%, so G's are
  held to 5e-2 relative L2 over all tensors together (3.8% at this seed),
  each tensor to 0.2 (0.154 at most, single noise weights) and to a
  projection <g, g_jax> / |g_jax|² within [0.8, 1.25]; a gradient off by
  a factor (a loss left undivided by n_accum, a wrong coefficient, one
  micro-batch weighted otherwise) misses these by far. D's after the R1
  step, which sees only real images, 1e-2 relative L2 a tensor (2e-3 at
  most at this seed).
* A step whose gradient is not finite moves nothing, on both sides.
* ``train_loop``: 5 iterations with finite metrics, R1 at iteration 0, and
  a snapshot that resumes.

The ``cuda`` test runs a G step at the same config through kernels 2 and
2b and through the plain combine on the card: generator gradients within
1e-2 relative L2 (see tests/test_torch_gan_model.py). It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gan_train.py
"""
import os
import random
from unittest import mock

import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.config import AttrDict
from enarf_gan_tpu_torch.data.datasets import HumanDataset, HumanPoseDataset
from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu_torch.data.loader import DataLoader
from enarf_gan_tpu_torch.training import checkpoint as ckpt
from enarf_gan_tpu_torch.training import gan

BS = 4


def tiny_gan_config(root, out_root, tile_patch=0):
    """tests/test_training.py's tiny GAN config with bf16 plane sampling
    (the port's samplers), as a plain dict for either package's AttrDict."""
    return {
        "out_root": out_root, "out": "smoke_gan",
        "dataset": {"bs": BS, "image_size": 32, "num_workers": 1,
                    "train": {"data_root": root, "pose_prior_root": None}},
        "generator_params": {
            "z_dim": 16, "patch_size": 24, "background_ratio": 0.3,
            "use_triplane": True, "crop_background": True, "channel_max": 32,
            "pretrained_background": False,
            "nerf_params": {
                "w_dim": 32, "hidden_size": 16, "Nc": 4, "Nf": 4,
                "no_ray_direction": True, "origin_location": "center_fixed",
                "coordinate_scale": 3, "render_bs": 1024, "mask_input": False,
                "multiply_density_with_triplane_wieght": False,
                "clamp_mask": False, "constant_triplane": False,
                "constant_trimask": False, "constant_trimask_lr_mul": 1,
                "deformation_field": False, "selector_mlp": False,
                "no_selector": False, "tri_plane_size": 16,
                "plane_sample_dtype": "bfloat16", "tile_patch": tile_patch,
                "tile_coarse_corners": bool(tile_patch)}},
        "discriminator_params": {"minibatch_std": True, "channel_max": 32},
        "loss": {"adv_loss_type": "ce", "bone_guided_coef": 10,
                 "r1_loss_coef": 0.01, "tri_plane_reg_coef": 0.001},
        "num_iter": 5, "n_accum_step": 2,
        "resume": None, "resume_latest": False}


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
    root = tmp_path_factory.mktemp("gan_train")
    make_synthetic_human_cache(str(root), size=32, n_frames=3, n_camera=2)
    return str(root)


def test_pose_prior_matches_jax(synth_root):
    from enarf_gan_tpu.data.datasets import HumanPoseDataset as JPose
    ours = HumanPoseDataset(size=32, data_root=synth_root,
                            num_repeat_in_epoch=2)
    ref = JPose(size=32, data_root=synth_root, num_repeat_in_epoch=2)
    assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours.canonical_pose, ref.canonical_pose)
    for i in (0, 3, 7):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        assert a["bone_mask"].sum() > 20
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_real_images_and_flips_match_jax(synth_root):
    from enarf_gan_tpu.config import AttrDict as JAttrDict
    from enarf_gan_tpu.data.datasets import HumanDataset as JHuman
    ours = HumanDataset(AttrDict({"data_root": synth_root}), size=32,
                        return_bone_params=False, num_repeat_in_epoch=10,
                        flip_rng=random.Random(3))
    ref = JHuman(JAttrDict({"data_root": synth_root}), size=32,
                 return_bone_params=False, num_repeat_in_epoch=10)
    random.seed(3)
    flips = 0
    for i in range(8):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        np.testing.assert_array_equal(a["idx"], b["idx"])
        # JAX's native normaliser rounds x / 127.5 - 1 otherwise by an ulp
        np.testing.assert_allclose(a["img"], b["img"], rtol=0, atol=2e-7)
        flips += not np.array_equal(a["img"], ours.preprocess_img(
            ours.imgs[i % len(ours.imgs)][:3]))
    assert 0 < flips < 8


def _batches(synth_root):
    """One real-image and one pose batch of BS from the JAX datasets."""
    from enarf_gan_tpu.config import AttrDict as JAttrDict
    from enarf_gan_tpu.data.datasets import HumanDataset as JHuman
    from enarf_gan_tpu.data.datasets import HumanPoseDataset as JPose
    random.seed(0)
    imgs = JHuman(JAttrDict({"data_root": synth_root}), size=32,
                  return_bone_params=False, num_repeat_in_epoch=1)
    poses = JPose(size=32, data_root=synth_root, num_repeat_in_epoch=1)
    stack = lambda ds, idx: {k: np.stack([ds[i][k] for i in idx])  # noqa
                             for k in ds[0]}
    return stack(imgs, [0, 2, 4, 5]), stack(poses, [1, 2, 3, 4]), poses


def _jitted(init):
    """A flax module's ``init`` compiled with ``jax.jit`` over its
    positional arguments."""
    import jax

    def run(module, *args):
        return jax.jit(lambda *a: init(module, *a))(*args)

    return run


@pytest.fixture(scope="module")
def iteration(synth_root, tmp_path_factory):
    """One JAX iteration (G, D, R1) and the port's from the same state."""
    import jax
    import jax.numpy as jnp
    from enarf_gan_tpu.config import AttrDict as JAttrDict
    from enarf_gan_tpu.training import gan as jgan
    from enarf_gan_tpu.training.checkpoint import export_reference_state_dict
    from enarf_gan_tpu_torch import interop
    from _torch_parity import (float32_jax_samplers, jax_gan_randoms,
                               perturbed)
    raw = tiny_gan_config(synth_root, str(tmp_path_factory.mktemp("out")))
    jconfig = JAttrDict(raw)
    img_b, pose_b, poses = _batches(synth_root)
    jgen, jdis = jgan.build_models(jconfig, 24, poses.parents)
    jbatch = jgan.prepare_gan_batch(img_b, pose_b)
    real = jbatch.pop("real_img")
    # the inits jitted: JAX's eager init of G walks its forward op by op
    # (about a minute); compiled, the same variables come in a third of it
    with mock.patch.object(type(jgen), "init", _jitted(type(jgen).init)), \
            mock.patch.object(type(jdis), "init", _jitted(type(jdis).init)):
        state, gen_tx, dis_tx = jgan.init_gan_state(
            jconfig, jgen, jdis, poses.canonical_pose,
            jax.random.PRNGKey(0),
            {k: np.asarray(v) for k, v in pose_b.items()})
    state["gen"] = perturbed(state["gen"], seed=7)
    state["dis"] = perturbed(state["dis"], seed=8)
    g_step, d_step, r1_step = jgan.make_gan_steps(jconfig, jgen, jdis,
                                                  gen_tx, dis_tx)
    rng = jax.random.PRNGKey(11)
    with float32_jax_samplers():
        s1, fake, gm = g_step(state, rng, jbatch)
        s2, dm = d_step(s1, fake, real)
        s3, rm = r1_step(s2, real)
    # the port, from the same state
    config = AttrDict(raw)
    gen, dis = gan.build_models(config, 24, poses.parents, device="cpu")
    interop.load_reference_state_dict(gen, export_reference_state_dict(
        state["gen"]))
    interop.load_jax_stats(gen, state["gen"]["stats"])
    interop.load_flax_discriminator(dis, jax.tree_util.tree_map(
        np.asarray, dict(state["dis"]["params"])))
    gen_opt, dis_opt = gan.init_gan_state(config, gen, dis,
                                          poses.canonical_pose)
    tg, td, tr = gan.make_gan_steps(config, gen, dis, gen_opt, dis_opt)
    randoms = []
    mb = BS // 2
    for key in jax.random.split(rng, 2):
        z_rng, f_rng = jax.random.split(key)
        randoms.append({"z": torch.from_numpy(np.array(jax.random.normal(
            z_rng, (mb, 16 * 4)))), **jax_gan_randoms(f_rng, gen, mb)})
    batch = gan.prepare_gan_batch(img_b, pose_b, "cpu")
    t_real = batch.pop("real_img")
    before = ({k: v.clone() for k, v in gen.state_dict().items()},
              {k: v.clone() for k, v in dis.state_dict().items()})
    t_fake, t_gm = tg(batch, randoms=randoms)
    after_g = {k: v.clone() for k, v in dis.state_dict().items()}
    t_dm = td(t_fake, t_real)
    after_d = {k: v.clone() for k, v in dis.state_dict().items()}
    t_rm = tr(t_real)
    return dict(jax=(state, s1, s2, s3, np.asarray(fake), gm, dm, rm),
                port=(gen, dis, before, after_g, after_d, t_fake.numpy(),
                      t_gm, t_dm, t_rm),
                lrs=(1e-3 * BS / 32, 2e-3 * BS / 32), g_step=g_step,
                tg=tg, jbatch=jbatch, batch=batch, rng=rng,
                randoms=randoms, opts=(gen_opt, dis_opt))


def _flip_share(new, old, ref_new, ref_old, lr):
    """Share of elements whose update differs from JAX's by more than lr/2."""
    d = np.abs((new - old) - (ref_new - ref_old))
    return float((d > lr / 2).mean())


def test_g_step_matches_jax(iteration):
    from enarf_gan_tpu.training.checkpoint import export_reference_state_dict
    state, s1 = iteration["jax"][:2]
    fake_ref, gm = iteration["jax"][4], iteration["jax"][5]
    gen, _, before, _, _, fake, t_gm = iteration["port"][:7]
    lr = iteration["lrs"][0]
    for k in ("adv_loss_gen", "bone_loss", "loss_gen"):
        np.testing.assert_allclose(float(t_gm[k]), float(gm[k]), rtol=2e-2,
                                   err_msg=k)
    assert np.abs(fake - fake_ref).mean() <= 2e-2
    np.testing.assert_allclose(
        gen.nerf.tri_plane_gen.mapping.w_avg.numpy(),
        np.asarray(s1["gen"]["stats"]["nerf"]["generator"]["mapping"]
                   ["w_avg"]), rtol=1e-5, atol=1e-6)
    ref_old = export_reference_state_dict(state["gen"])
    ref_new = export_reference_state_dict(s1["gen"])
    moved, flipped, total = 0, 0.0, 0
    for name, p in gen.named_parameters():
        share = _flip_share(p.detach().numpy(), before[0][name].numpy(),
                            ref_new[name], ref_old[name], lr)
        assert share <= 0.1, (name, share)
        flipped += share * p.numel()
        total += p.numel()
        moved += bool((p.detach() != before[0][name]).any())
    assert flipped / total <= 0.02, flipped / total
    assert moved >= 0.9 * len(list(gen.parameters()))
    # the gradients' scale: Adam's first moment is the gradient at b1 = 0
    mu = export_reference_state_dict(
        {**state["gen"], "params": s1["gen_opt"].inner_state[0].mu})
    adam = iteration["opts"][0].adam.state
    num = den = 0.0
    for name, p in gen.named_parameters():
        g = adam[p]["exp_avg"].numpy().astype(np.float64).ravel()
        want = np.asarray(mu[name], np.float64).ravel()
        norm2 = float(want @ want)
        assert norm2 > 0, name
        err = float(np.linalg.norm(g - want)) / norm2 ** 0.5
        assert err <= 0.2, (name, err)
        assert 0.8 <= float(g @ want) / norm2 <= 1.25, (name, g @ want / norm2)
        num += float((g - want) @ (g - want))
        den += norm2
    assert (num / den) ** 0.5 <= 5e-2, (num / den) ** 0.5


def test_g_step_leaves_the_discriminator_alone(iteration):
    before, after_g = iteration["port"][2:4]
    for k, v in before[1].items():
        torch.testing.assert_close(after_g[k], v, rtol=0, atol=0)


def test_d_and_r1_steps_match_jax(iteration):
    from enarf_gan_tpu_torch.interop import _flatten
    _, s1, s2, s3, _, _, dm, rm = iteration["jax"]
    _, dis, _, after_g, after_d, _, _, t_dm, t_rm = iteration["port"]
    lr = iteration["lrs"][1]
    np.testing.assert_allclose(float(t_dm["adv_loss_dis"]),
                               float(dm["adv_loss_dis"]), rtol=2e-2)
    np.testing.assert_allclose(float(t_rm["r1_reg"]), float(rm["r1_reg"]),
                               rtol=1e-4)
    flat = [_flatten(jax_np(s["dis"]["params"])) for s in (s1, s2, s3)]
    final = dis.state_dict()
    for name in final:
        key = name.replace(".", "/")
        d_share = _flip_share(after_d[name].numpy(), after_g[name].numpy(),
                              flat[1][key], flat[0][key], lr)
        r_share = _flip_share(final[name].numpy(), after_d[name].numpy(),
                              flat[2][key], flat[1][key], lr)
        assert d_share <= 5e-3 and r_share <= 5e-3, (name, d_share, r_share)
    # R1's gradient, Adam's first moment after the R1 step (b1 = 0)
    mu = _flatten(jax_np(s3["dis_opt"].inner_state[0].mu))
    adam = iteration["opts"][1].adam.state
    checked = 0
    for name, p in dis.named_parameters():
        want = mu[name.replace(".", "/")]
        g = adam[p]["exp_avg"].numpy()
        if not np.abs(want).max() > 0:
            assert float(np.abs(g).max()) < 1e-8, name
            continue
        err = float(np.linalg.norm(g - want) / np.linalg.norm(want))
        assert err <= 1e-2, (name, err)
        checked += 1
    assert checked >= 0.8 * len(list(dis.parameters()))


def jax_np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def test_nonfinite_g_step_moves_nothing_on_either_side(iteration):
    import jax
    import jax.numpy as jnp
    from _torch_parity import float32_jax_samplers
    state = iteration["jax"][3]
    jbatch = dict(iteration["jbatch"])
    jbatch["bone_length"] = jbatch["bone_length"].at[0, 3].set(jnp.nan)
    with float32_jax_samplers():
        s, _, _ = iteration["g_step"](state, iteration["rng"], jbatch)
    for a, b in zip(jax.tree_util.tree_leaves(s["gen"]["params"]),
                    jax.tree_util.tree_leaves(state["gen"]["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    gen = iteration["port"][0]
    gen_opt = iteration["opts"][0]
    batch = dict(iteration["batch"])
    batch["bone_length"] = batch["bone_length"].clone()
    batch["bone_length"][0, 3] = float("nan")
    params = {k: v.clone() for k, v in gen.state_dict().items()}
    adam = {k: v["exp_avg_sq"].clone()
            for k, v in gen_opt.adam.state_dict()["state"].items()}
    iteration["tg"](batch, randoms=iteration["randoms"])
    assert gen_opt.nonfinite == 1
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    for k, v in gen_opt.adam.state_dict()["state"].items():
        torch.testing.assert_close(v["exp_avg_sq"], adam[k], rtol=0, atol=0)


def test_train_loop_smoke_and_resume(synth_root, tmp_path):
    config = AttrDict(tiny_gan_config(synth_root, str(tmp_path),
                                      tile_patch=4))
    img_ds = HumanDataset(AttrDict({"data_root": synth_root}), size=32,
                          return_bone_params=False, num_repeat_in_epoch=10)
    pose_ds = HumanPoseDataset(size=32, data_root=synth_root,
                               num_repeat_in_epoch=10)
    loaders = (DataLoader(img_ds, BS, seed=0), DataLoader(pose_ds, BS, seed=1))
    gen, dis = gan.build_models(config, pose_ds.num_bone, pose_ds.parents,
                                device="cpu")
    _, _, history = gan.train_loop(config, gen, dis, (img_ds, pose_ds),
                                   loaders, pose_ds.canonical_pose,
                                   verbose=False)
    assert len(history) == 5
    for h in history:
        for k, v in h.items():
            assert np.isfinite(v), (k, v)
    assert "r1_reg" in history[0]
    assert all("r1_reg" not in h for h in history[1:])
    out_dir = os.path.join(config.out_root, "result", config.out)
    path = ckpt.latest_checkpoint(out_dir)
    snap = ckpt.load_checkpoint(path)
    assert snap["iteration"] == 5 and set(snap) == {
        "iteration", "gen", "dis", "gen_opt", "dis_opt"}
    assert "nerf.tri_plane_gen.mapping.w_avg" in snap["gen"]
    gen2, dis2 = gan.build_models(config, pose_ds.num_bone, pose_ds.parents,
                                  device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    ckpt.load_gen_state_dict(gen2, snap["gen"])
    dis2.load_state_dict(snap["dis"])
    for (k, a), b in zip(ckpt.gen_state_dict(gen).items(),
                         ckpt.gen_state_dict(gen2).values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    config.resume_latest = True
    config.num_iter = 6
    _, _, more = gan.train_loop(config, gen2, dis2, (img_ds, pose_ds),
                                loaders, pose_ds.canonical_pose,
                                verbose=False)
    assert len(more) == 1 and "r1_reg" not in more[0]


# ------------------------------------------------------------------ #
# on the card: a G step through kernels 2 and 2b and the plain combine
# ------------------------------------------------------------------ #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_g_step_through_kernels_on_card(cuda_device, synth_root, tmp_path):
    from enarf_gan_tpu_torch.ops import tilewin, tilewin_kernel
    config = AttrDict(tiny_gan_config(synth_root, str(tmp_path),
                                      tile_patch=4))
    img_ds = HumanDataset(AttrDict({"data_root": synth_root}), size=32,
                          return_bone_params=False)
    pose_ds = HumanPoseDataset(size=32, data_root=synth_root)
    collate = lambda ds: {k: np.stack([ds[i][k] for i in range(BS)])  # noqa
                          for k in ds[0]}
    batch = gan.prepare_gan_batch(collate(img_ds), collate(pose_ds),
                                  cuda_device)
    batch.pop("real_img")
    gen, dis = gan.build_models(config, 24, pose_ds.parents,
                                device=cuda_device)
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in gen.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g).to(cuda_device))
    w_avg = ckpt.w_avg_buffers(gen)["nerf.tri_plane_gen.mapping.w_avg"]
    start = (w_avg.clone(), {k: v.clone() for k, v in gen.state_dict().items()})

    def grads_of_a_step():
        gen.load_state_dict(start[1])
        w_avg.copy_(start[0])
        gen_opt, dis_opt = gan.init_gan_state(config, gen, dis,
                                              pose_ds.canonical_pose)
        step = gan.make_gan_steps(config, gen, dis, gen_opt, dis_opt)[0]
        gen_opt.step = lambda: True          # keep the gradients, no update
        rng = torch.Generator(device=cuda_device).manual_seed(2)
        step(batch, rng)
        return {k: p.grad.clone() for k, p in gen.named_parameters()
                if p.grad is not None}

    before = (tilewin_kernel.KERNEL.launches,
              tilewin_kernel.KERNEL_BWD.launches)
    grads = grads_of_a_step()
    assert tilewin_kernel.KERNEL.launches > before[0]
    assert tilewin_kernel.KERNEL_BWD.launches > before[1]
    with mock.patch.object(tilewin, "tilewin_combine",
                           lambda *a, mode=None:
                           tilewin_kernel.tilewin_combine_texels_plain(*a)):
        plain = grads_of_a_step()
    for name, gp in plain.items():
        if float(gp.norm()) == 0:
            continue
        err = float((grads[name] - gp).norm() / gp.norm())
        assert err <= 1e-2, (name, err)
