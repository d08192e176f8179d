"""Shared builders for the port's parity tests (tests/test_torch_*.py).

Both packages get the same scene (the port's numpy fixture), the same
weights (the JAX model's perturbed parameters, carried over by the weight
bridge) and the same random draws (rebuilt with JAX's own key splits).
"""
import contextlib
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import torch

from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                            TriNARFGenerator,
                                            register_canonical_pose)
from enarf_gan_tpu.models.narf import NARFParams
from enarf_gan_tpu.ops import tilewin as jtw
from enarf_gan_tpu.ops import unirow as junirow
from enarf_gan_tpu.training.checkpoint import export_reference_state_dict

from enarf_gan_tpu_torch.data.fixtures import tiny_scene
from enarf_gan_tpu_torch.interop import (load_jax_stats,
                                         load_reference_state_dict)
from enarf_gan_tpu_torch.models import generator as tgen
from enarf_gan_tpu_torch.models.narf import NARFParams as TNARFParams

PARENTS = tuple(int(x) for x in SMPL_PARENTS)

# the slice's model at test width: 32² planes, w_dim 32 (channel_max 64)
SMALL = dict(Nc=8, Nf=8, hidden_size=16, tri_plane_size=32, w_dim=32,
             coordinate_scale=3.0, view_dependent=False,
             origin_location="center_fixed", deformation_field=True,
             time_conditional=True, pose_conditional=False,
             plane_sample_dtype="bfloat16")


def perturbed(variables, seed=7):
    """Perturb the parameters (fresh DSO models render an all-zero mask);
    buffers keep the registered canonical pose, and the mapping's w_avg
    stays at its init, which the port does not carry."""
    from conftest import perturb_params
    out = dict(variables)
    out["params"] = perturb_params(variables["params"], seed=seed)
    return out


def lifted_mlp_density(variables, shift=2.0):
    """The MLP NARF's variables with its density head's bias raised by
    ``shift``: its raw density logit (no ReLU, as the JAX model keeps it)
    comes out negative at every point from the perturbed init, which
    renders an empty (negative) mask; raised, the renders have a
    foreground."""
    from enarf_gan_tpu.training.checkpoint import jax_tree_to_dict
    out = jax_tree_to_dict(variables)
    heads = out["params"]["nerf"]["heads"]
    if "density_fc" in heads:
        heads["density_fc"]["bias"] = heads["density_fc"]["bias"] + shift
    else:      # the view-independent head: density is the 4th output
        last = sorted(heads["color_mlp"])[-1]
        bias = heads["color_mlp"][last]["bias"]
        heads["color_mlp"][last]["bias"] = bias.at[3].add(shift)
    return out


def build_pair(size=16, ray_batchsize=64, seed=7, use_triplane=True,
               **overrides):
    """(jax gen, jax variables, port gen, scene) for one DSO model: the
    tri-plane NARF, or with ``use_triplane=False`` the MLP NARF of
    ``model_type`` (no canonical-pose buffers; its ``density_mlp`` and
    ``deformation_field`` carried by their flax paths; its density lifted,
    ``lifted_mlp_density``)."""
    kw = {**SMALL, "render_bs": ray_batchsize, **overrides}
    gen = DSONARFGenerator(nerf_params=NARFParams(**kw), size=size,
                           num_bone=24, parent_id=PARENTS,
                           use_triplane=use_triplane,
                           ray_batchsize=ray_batchsize)
    scene = tiny_scene(1, size)
    pose_cam, world, bl, inv_K, canonical, _ = scene
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(gen.init)(rng, rng, jnp.asarray(pose_cam),
                         jnp.asarray(world[:, 0, :3, :3]),
                         jnp.ones((1, size, size)), jnp.array([0.5]),
                         jnp.asarray(bl), jnp.asarray(inv_K))
    if use_triplane:
        variables = register_canonical_pose(
            variables, canonical, kw["origin_location"],
            np.asarray(SMPL_PARENTS))
    variables = perturbed(variables, seed)
    if not use_triplane:
        variables = lifted_mlp_density(variables)
    port = tgen.DSONARFGenerator(TNARFParams(**kw), num_bone=24,
                                 parent_id=PARENTS, device="cpu",
                                 use_triplane=use_triplane)
    load_reference_state_dict(
        port, export_reference_state_dict(variables),
        nerf_flax_params=None if use_triplane else variables["params"]["nerf"])
    return gen, variables, port, scene


def jax_dso_variables(jgen, jbatch, canonical_pose, seed=0):
    """``jdso.init_state``'s variables with the init jitted: seconds, where
    the op-by-op init takes about half a minute on the CPU. The MLP
    baselines have no canonical-pose buffers (``init_state`` would assert
    that they do)."""
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(jgen.init)(key, key, *(
        jbatch[k] for k in ("pose_3d", "camera_rotation", "mask",
                            "frame_time", "bone_length", "inv_intrinsics")))
    if not jgen.use_triplane:
        return variables
    return register_canonical_pose(variables, canonical_pose,
                                   jgen.nerf_params.origin_location,
                                   np.asarray(jgen.parent_id))


def port_named(variables):
    """A JAX DSO model's variables (or a gradient of them) under the port's
    names: the reference-named bridge, and for the MLP baselines the flax
    paths of ``density_mlp`` and ``deformation_field``."""
    from enarf_gan_tpu_torch.interop import flax_mlp_narf_state
    out = export_reference_state_dict(variables)
    out.update({f"nerf.{k}": v.numpy() for k, v in
                flax_mlp_narf_state(variables["params"]["nerf"]).items()})
    return out


def dso_train_case(raw, frames, rng_seed=4):
    """Both DSO models of the config dict ``raw`` (either package's
    AttrDict takes it) with the JAX model's perturbed weights, a batch of
    ``frames`` of its training cache, JAX's draws, and JAX's training
    render of the batch with the loss's gradients (its packed tables held
    in float32, ``float32_jax_tables``). Returns dict(port, batch, randoms,
    loss_type, ref={loss, color, mask, ray_idx, grads}), the gradients
    under the port's names."""
    from enarf_gan_tpu.config import AttrDict as JAttrDict
    from enarf_gan_tpu.data.datasets import SSODataset
    from enarf_gan_tpu.training import dso as jdso
    from enarf_gan_tpu.training.losses import photometric_loss as jloss_fn
    from enarf_gan_tpu_torch.config import AttrDict
    from enarf_gan_tpu_torch.training import dso
    jconfig = JAttrDict(raw)
    loss_type = raw["loss"]["nerf_loss_type"]
    size = raw["dataset"]["image_size"]
    ds = SSODataset(jconfig.dataset.train, size=size, return_bone_params=True,
                    return_mask=True, num_repeat_in_epoch=1)
    batch = {k: np.stack([ds[i][k] for i in frames])
             for k in ("img", "mask", "pose_3d", "frame_time", "bone_length",
                       "camera_rotation", "intrinsics")}
    jgen = jdso.build_generator(jconfig, ds.num_bone, ds.parents)
    jbatch = jdso.prepare_batch(batch)
    variables = perturbed(jax_dso_variables(jgen, jbatch, ds.canonical_pose),
                          seed=7)
    if not jgen.use_triplane:
        variables = lifted_mlp_density(variables)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    rng = jax.random.PRNGKey(rng_seed)

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
    port = dso.build_generator(AttrDict(raw), ds.num_bone, ds.parents,
                               device="cpu")
    load_reference_state_dict(
        port, export_reference_state_dict(variables),
        nerf_flax_params=None if jgen.use_triplane
        else variables["params"]["nerf"])
    B, h, w = batch["mask"].shape
    n = int(ray_idx.shape[1])
    P = jgen.nerf_params.tile_patch if jgen.use_triplane else 0
    if P and port.nerf.supports_tiled_sampling():
        randoms = jax_train_randoms(rng, (B, (h // P) * (w // P)),
                                    B * n // (P * P), jgen.nerf_params.Nf)
    else:
        randoms = jax_train_randoms(rng, (B, h * w), B * n,
                                    jgen.nerf_params.Nf)
    return dict(port=port, batch=dso.prepare_batch(batch, "cpu"),
                randoms=randoms, loss_type=loss_type,
                ref=dict(loss=float(loss), color=np.asarray(color),
                         mask=np.asarray(nerf_mask),
                         ray_idx=np.asarray(ray_idx),
                         grads=port_named({**variables, "params": grads})))


def jax_fine_draws(rng, n_chunks, chunk, Nf):
    """The (u, jitter) pair JAX's render_entire_img draws for each chunk."""
    out = []
    for key in jax.random.split(rng, n_chunks):
        k_bin, k_jit = jax.random.split(key)
        out.append(tuple(
            torch.from_numpy(np.array(jax.random.uniform(k, (chunk, Nf),
                                                         jnp.float32)))
            for k in (k_bin, k_jit)))
    return out


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def jax_train_randoms(rng, noise_shape, fine_rows, Nf):
    """The random numbers JAX's DSO training render draws from ``rng``:
    the ray sampler's noise (``noise_shape``) and the fine sampler's
    (u, jitter), each (fine_rows, Nf), as the port's ``forward`` takes
    them."""
    rng_rays, rng_fine = jax.random.split(rng)
    k_bin, k_jit = jax.random.split(rng_fine)
    draw = lambda k, s: torch.from_numpy(np.array(  # noqa: E731
        jax.random.uniform(k, s, jnp.float32)))
    return {"ray_noise": draw(rng_rays, noise_shape),
            "draws": (draw(k_bin, (fine_rows, Nf)),
                      draw(k_jit, (fine_rows, Nf)))}


def tiny_dso_config(root, out_root, **nerf_overrides):
    """tests/test_training.py's tiny DSO config, with bf16 plane sampling
    (the port's samplers), as a plain dict for either package's AttrDict."""
    nerf = {"w_dim": 32, "hidden_size": 16, "Nc": 6, "Nf": 8,
            "no_ray_direction": True, "origin_location": "center_fixed",
            "coordinate_scale": 3, "render_bs": 256, "model_type": "narf",
            "multiply_density_with_triplane_wieght": False,
            "clamp_mask": False, "constant_triplane": False,
            "constant_trimask": False, "selector_mlp": False,
            "deformation_field": True, "no_selector": False,
            "time_conditional": True, "pose_conditional": False,
            "constant_trimask_lr_mul": 1, "tri_plane_size": 16,
            "plane_sample_dtype": "bfloat16", **nerf_overrides}
    return {
        "out_root": out_root, "out": "smoke_dso",
        "dataset": {"bs": 2, "image_size": 32, "bg_color": -1,
                    "num_workers": 1,
                    "train": {"data_root": root, "n_frames": 3}},
        "generator_params": {"use_triplane": True, "ray_batchsize": 128,
                             "nerf_params": nerf},
        "loss": {"color_coef": 1, "mask_coef": 1, "nerf_loss_type": "mse"},
        "num_iter": 40, "lr": 0.001, "scheduler_gamma": 0.99995,
        "val_interval": 1000, "print_interval": 1000,
        "tensorboard_interval": 20, "save_interval": 20,
        "resume": None, "resume_latest": False}


@contextlib.contextmanager
def float32_jax_tables():
    """JAX's table packs with the bf16 tables' values held in float32."""
    pack_u, pack_t = junirow.pack_unirow, jtw.pack_tilewin

    def unirow32(*a, **k):
        return pack_u(*a, **k).astype(jnp.float32)

    def tilewin32(*a, **k):
        t = pack_t(*a, **k)
        return jtw.TilewinTables(t.feat.astype(jnp.float32),
                                 t.mask.astype(jnp.float32), *t[2:])

    with mock.patch.object(junirow, "pack_unirow", unirow32), \
            mock.patch.object(jtw, "pack_tilewin", tilewin32):
        yield


class _Float32Numpy:
    """``jax.numpy`` with ``bfloat16`` meaning float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float32_jax_samplers():
    """``float32_jax_tables``, and JAX's tiled sampler computing in float32
    where it rounds to bf16 (its window weights), as the port's combines
    do; the tilewin tables still hold the planes' bf16 values."""
    pack_t = jtw.pack_tilewin

    def tilewin_bf16_values(planes, *a, **k):
        return pack_t(planes.astype(jnp.bfloat16).astype(jnp.float32),
                      *a, **k)

    with float32_jax_tables(), \
            mock.patch.object(jtw, "pack_tilewin", tilewin_bf16_values), \
            mock.patch.object(jtw, "jnp", _Float32Numpy()):
        yield


# the GAN at test width: 16² planes and images, w_dim 32, z_dim 8,
# background channel_max 32 (tests/test_models.py's sizes)
GAN_SMALL = dict(Nc=6, Nf=6, hidden_size=16, tri_plane_size=16, w_dim=32,
                 coordinate_scale=3.0, view_dependent=False,
                 origin_location="center_fixed",
                 plane_sample_dtype="bfloat16")
GAN_KW = dict(z_dim=8, crop_background=True, channel_max=32)


def build_gan_pair(size=16, B=2, train_ray_chunk=128, seed=7,
                   variables=None, **overrides):
    """(jax gen, jax variables, port gen, scene, z) for one GAN generator:
    JAX's weights perturbed, its w_avg statistics random (so truncation
    and their update show), both carried into the port. ``variables``
    (another pair's; they depend neither on B nor on the planes' sampling
    dtype) skips JAX's init."""
    kw = {**GAN_SMALL, "render_bs": train_ray_chunk, **overrides}
    gen = TriNARFGenerator(nerf_params=NARFParams(**kw), size=size,
                           num_bone=24, parent_id=PARENTS,
                           train_ray_chunk=train_ray_chunk, **GAN_KW)
    scene = tiny_scene(B, size)
    pose_cam, world, bl, inv_K, canonical, _ = scene
    z = np.random.RandomState(seed).randn(
        B, GAN_KW["z_dim"] * 4).astype(np.float32)
    if variables is None:
        rng = jax.random.PRNGKey(0)
        variables = jax.jit(gen.init)(rng, rng, jnp.asarray(pose_cam),
                                      jnp.asarray(world), jnp.asarray(bl),
                                      jnp.asarray(z), jnp.asarray(inv_K))
        variables = register_canonical_pose(
            variables, canonical, "center_fixed", np.asarray(SMPL_PARENTS))
        variables = perturbed(variables, seed)
        leaves, tree = jax.tree_util.tree_flatten(variables["stats"])
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
        variables["stats"] = jax.tree_util.tree_unflatten(
            tree, [0.5 * jax.random.normal(k, x.shape) for k, x in
                   zip(keys, leaves)])
    port = tgen.TriNARFGenerator(
        TNARFParams(**kw), size=size, num_bone=24, parent_id=PARENTS,
        train_ray_chunk=train_ray_chunk, device="cpu", **GAN_KW)
    load_reference_state_dict(port, export_reference_state_dict(variables))
    load_jax_stats(port, variables["stats"])
    return gen, variables, port, scene, z


def _np_to_t(x):
    return torch.from_numpy(np.array(x))


def jax_render_draws(rng, port, B, chunk):
    """The fine sampler's (u, jitter) JAX's GAN forward draws from its
    ``rng_fine`` (one key a ``chunk`` of rays, or of whole patches on the
    tiled path), batch-major as ``TriNARFGenerator.forward`` takes them."""
    n = port.size * port.size
    P = port.nerf_params.tile_patch if port.nerf.supports_tiled_sampling() \
        else 1
    m = P * P
    Nf = port.nerf_params.Nf
    c = chunk - chunk % m if chunk and n > chunk else n
    keys = jax.random.split(rng, n // c) if c < n else [rng]
    u, jit = [], []
    for key in keys:
        k_bin, k_jit = jax.random.split(key)
        for k, out in ((k_bin, u), (k_jit, jit)):
            out.append(np.array(jax.random.uniform(
                k, (B * (c // m), Nf), jnp.float32)).reshape(B, c // m, Nf))
    return tuple(torch.from_numpy(np.concatenate(x, axis=1).reshape(-1, Nf))
                 for x in (u, jit))


def jax_noise(noise_rng, bg, B):
    """The noise JAX's synthesis draws from ``noise_rng``, one tensor a
    styled conv of the port's ``BackgroundGenerator`` ``bg``."""
    out = []
    for shape in bg.noise_shapes(B):
        noise_rng, r = jax.random.split(noise_rng)
        out.append(_np_to_t(jax.random.normal(r, shape, jnp.float32)))
    return out


def jax_crop(crop_rng, size):
    """The (y0, x0) JAX's background draws for its training crop of the
    (size, 2 size) canvas."""
    kx, ky = jax.random.split(crop_rng)
    x0 = int(jax.random.randint(kx, (), 0, size + 1))
    y0 = int(jax.random.randint(ky, (), 0, 1))
    return y0, x0


def jax_background_randoms(rng, port, B):
    """The background's noise and crop JAX's ``TriNARFGenerator.
    background`` draws from ``rng``."""
    crop_rng, noise_rng = jax.random.split(rng)
    return {"noise": jax_noise(noise_rng, port.background_generator, B),
            "crop": jax_crop(crop_rng, port.size)}


def jax_gan_randoms(rng, port, B):
    """Everything JAX's ``TriNARFGenerator.__call__`` draws from ``rng``,
    as the port's forward takes it."""
    rng_fine, rng_bg = jax.random.split(rng)
    return {"draws": jax_render_draws(rng_fine, port, B,
                                      port.train_ray_chunk),
            **jax_background_randoms(rng_bg, port, B)}


def gan_pair_from_port(size=16, B=1, seed=7, **overrides):
    """(jax gen, jax variables, port gen, scene, z) for one GAN generator,
    the other way round from ``build_gan_pair``: the port's seeded weights
    perturbed by 0.3 and its w_avg statistics random, carried into JAX
    variables shaped by ``jax.eval_shape`` of the init (seconds, where
    JAX's jitted init takes about 20)."""
    from enarf_gan_tpu.training.checkpoint import (import_reference_state_dict,
                                                   jax_tree_to_dict)
    kw = {**GAN_SMALL, "render_bs": 128, **overrides}
    gen = TriNARFGenerator(nerf_params=NARFParams(**kw), size=size,
                           num_bone=24, parent_id=PARENTS,
                           train_ray_chunk=128, **GAN_KW)
    scene = tiny_scene(B, size)
    pose_cam, world, bl, inv_K, canonical, _ = scene
    z = np.random.RandomState(seed).randn(
        B, GAN_KW["z_dim"] * 4).astype(np.float32)
    port = tgen.TriNARFGenerator(
        TNARFParams(**kw), size=size, num_bone=24, parent_id=PARENTS,
        train_ray_chunk=128, device="cpu",
        generator=torch.Generator().manual_seed(seed), **GAN_KW)
    tgen.register_canonical_pose(port, canonical, "center_fixed", PARENTS)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in port.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
        for name, b in port.named_buffers():
            if name.endswith("w_avg"):
                b.copy_(0.5 * torch.randn(b.shape, generator=g))
    rng = jax.random.PRNGKey(0)
    template = jax.eval_shape(gen.init, rng, rng, *map(
        jnp.asarray, (pose_cam, world, bl, z, inv_K)))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   jax_tree_to_dict(template))
    variables, _ = import_reference_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, zeros,
        strict=True)
    w_avg = {n: b.numpy() for n, b in port.named_buffers()
             if n.endswith("w_avg")}
    # the default variant's planes come from tri_plane_gen, constant_trimask's
    # and selector_mlp's from generator: JAX's nerf/generator either way
    plane_w_avg = next(v for n, v in w_avg.items() if n.startswith("nerf."))
    variables["stats"] = {
        "nerf": {"generator": {"mapping": {"w_avg": plane_w_avg}}},
        "background_generator": {"mapping": {
            "w_avg": w_avg["background_generator.w_avg"]}}}
    return gen, variables, port, scene, z


# LPIPS backbones at test widths: (slice, conv index, out channels, kernel)
# with the lpips package's indices, VGG16's and AlexNet's
LPIPS_CONVS = {
    "vgg": [(1, 0, 8, 3), (1, 2, 8, 3), (2, 5, 16, 3), (2, 7, 16, 3),
            (3, 10, 24, 3), (3, 12, 24, 3), (3, 14, 24, 3),
            (4, 17, 32, 3), (4, 19, 32, 3), (4, 21, 32, 3),
            (5, 24, 32, 3), (5, 26, 32, 3), (5, 28, 32, 3)],
    "alex": [(1, 0, 16, 11), (2, 3, 24, 5), (3, 6, 32, 3), (4, 8, 24, 3),
             (5, 10, 24, 3)]}


def seeded_lpips_npz(path, net_type="vgg", seed=0):
    """An LPIPS weight file in the layout of
    data_preprocess/export_lpips_weights.py (``net_type``, the backbone's
    ``net/slice{i}/{j}/weight|bias``, the heads ``lins/{i}/model/1/weight``
    and the scaling layer), narrow, He-initialised from ``seed``, with
    non-negative heads as the trained ones have."""
    rs = np.random.RandomState(seed)
    arrays = {"net_type": np.array(net_type)}
    cin, outs = 3, []
    for s, j, cout, k in LPIPS_CONVS[net_type]:
        arrays[f"net/slice{s}/{j}/weight"] = rs.normal(
            0, np.sqrt(2.0 / (cin * k * k)), (cout, cin, k, k)).astype(
                np.float32)
        arrays[f"net/slice{s}/{j}/bias"] = rs.normal(
            0, 0.05, cout).astype(np.float32)
        cin = cout
        if len(outs) < s:
            outs.append(cout)
        outs[s - 1] = cout
    for i, c in enumerate(outs):
        arrays[f"lins/{i}/model/1/weight"] = rs.uniform(
            0, 0.2, (1, c, 1, 1)).astype(np.float32)
    arrays["scaling_layer/shift"] = np.array(
        [-.030, -.088, -.188], np.float32).reshape(1, 3, 1, 1)
    arrays["scaling_layer/scale"] = np.array(
        [.458, .448, .450], np.float32).reshape(1, 3, 1, 1)
    np.savez(path, **arrays)
    return str(path)
