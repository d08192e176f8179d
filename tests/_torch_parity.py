"""Shared builders for the port's parity tests (tests/test_torch_*.py).

Both packages get the same scene (the port's numpy fixture), the same
weights (the JAX model's perturbed parameters, carried over by the weight
bridge) and the same random draws (rebuilt with JAX's own key splits).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from enarf_gan_tpu.geometry.smpl import SMPL_PARENTS
from enarf_gan_tpu.models.generator import (DSONARFGenerator,
                                            register_canonical_pose)
from enarf_gan_tpu.models.narf import NARFParams
from enarf_gan_tpu.training.checkpoint import export_reference_state_dict

from enarf_gan_tpu_torch.data.fixtures import tiny_scene
from enarf_gan_tpu_torch.interop import load_reference_state_dict
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


def build_pair(size=16, ray_batchsize=64, seed=7, **overrides):
    """(jax gen, jax variables, port gen, scene) for one DSO model."""
    kw = {**SMALL, "render_bs": ray_batchsize, **overrides}
    gen = DSONARFGenerator(nerf_params=NARFParams(**kw), size=size,
                           num_bone=24, parent_id=PARENTS, use_triplane=True,
                           ray_batchsize=ray_batchsize)
    scene = tiny_scene(1, size)
    pose_cam, world, bl, inv_K, canonical, _ = scene
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(gen.init)(rng, rng, jnp.asarray(pose_cam),
                         jnp.asarray(world[:, 0, :3, :3]),
                         jnp.ones((1, size, size)), jnp.array([0.5]),
                         jnp.asarray(bl), jnp.asarray(inv_K))
    variables = register_canonical_pose(variables, canonical, "center_fixed",
                                        np.asarray(SMPL_PARENTS))
    variables = perturbed(variables, seed)
    port = tgen.DSONARFGenerator(TNARFParams(**kw), num_bone=24,
                                 parent_id=PARENTS, device="cpu")
    load_reference_state_dict(port, export_reference_state_dict(variables))
    return gen, variables, port, scene


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
