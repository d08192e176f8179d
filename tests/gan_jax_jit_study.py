"""Why tests/test_torch_gan_model.py bounds a share of pixels: the port's
GAN forward against JAX's, run jitted and op by op, on the test's tiled
model (16² images and planes, JAX's perturbed weights, seed 7).

    JAX_PLATFORMS=cpu python tests/gan_jax_jit_study.py     # ~2 min

Prints, for the mask: the port against the eager JAX forward, the port
against the jitted one, and the jitted against the eager one (max |d|, the
share of pixels off by more than 1e-3); then density at random points
near the bones through the tiled sampler, the port against JAX with its
window weights rounded to bf16 (its default) and computed in float32, and
how many of the points' patch slots JAX chooses otherwise (a near-tie of
the bones' scores, from canonical positions that differ by an ulp).
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on the CPU, float32 matmuls)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (build_gan_pair, float32_jax_samplers,  # noqa: E402
                           float32_jax_tables, jax_gan_randoms, t)


def main():
    jgen, v, port, scene, z = build_gan_pair(tile_patch=4,
                                             tile_coarse_corners=True)
    pose_cam, world, bl, inv_K, _, _ = scene
    rng = jax.random.PRNGKey(3)
    args = (rng, jnp.asarray(pose_cam), jnp.asarray(world), jnp.asarray(bl),
            jnp.asarray(z), jnp.asarray(inv_K))
    with torch.no_grad():
        mask = port(t(pose_cam), t(world), t(bl), t(z), t(inv_K),
                    **jax_gan_randoms(rng, port, 2))[1].numpy()
    with float32_jax_samplers():
        with jax.disable_jit():
            eager = np.asarray(jgen.apply(v, *args)[1])
        jitted = np.asarray(jax.jit(lambda v, *a: jgen.apply(v, *a))(
            v, *args)[1])
    for name, a, b in (("port - eager JAX", mask, eager),
                       ("port - jitted JAX", mask, jitted),
                       ("jitted - eager JAX", jitted, eager)):
        d = np.abs(a - b)
        print(f"mask, {name}: max |d| {d.max():.3g}, pixels off by more "
              f"than 1e-3 {(d > 1e-3).mean():.4f}")

    z_nerf, z_rend, _ = port.split_z(t(z))
    pose_t, bl_t = port.transform_pose(t(pose_cam), t(bl))
    with torch.no_grad():
        planes = port.compute_tri_plane_feature(z_nerf, bl_t)
    jplanes = jnp.asarray(planes.numpy())
    pose_s = pose_t.numpy().copy()
    pose_s[:, :, :3, 3] *= port.nerf_params.coordinate_scale
    n_patch, m, S = 24, 16, 6
    rs = np.random.default_rng(0)
    centres = pose_s[:, rs.integers(0, 23, n_patch * m * S)][:, :, :3, 3]
    pts = (centres + rs.normal(scale=0.3, size=centres.shape)) \
        .transpose(0, 2, 1).astype(np.float32)
    from enarf_gan_tpu.geometry.encoding import in_cube
    from enarf_gan_tpu.ops.tilewin import select_patch_slots as jsel
    from enarf_gan_tpu_torch.ops.tilewin import select_patch_slots
    local, jcan = jgen.apply(
        v, jnp.asarray(pts), jnp.asarray(pose_s), jnp.asarray(bl_t.numpy()),
        method=lambda mdl, *a: mdl.nerf.to_local_and_canonical(*a))
    jval = in_cube(local) & (jnp.abs(jcan) < 1).all(axis=2)
    with torch.no_grad():
        can, val = port.nerf._canonical_validity(t(pts), t(pose_s), bl_t)
        slots = select_patch_slots(can, val, n_patch, m, S, 4)[0].numpy()
    jslots = np.asarray(jsel(jcan, jval, n_patch, m, S, 4)[0])
    print(f"patch slots at the random points chosen otherwise by JAX: "
          f"{int((slots != jslots).sum())} of {slots.size} (canonical "
          f"positions differ by {float(np.abs(np.asarray(jcan) - can.numpy()).max()):.3g})")
    with torch.no_grad():
        d_port, _ = port.nerf_density_color_tiled(
            t(pts), t(pose_s), bl_t, port.pack_planes_tiled(planes), z_rend,
            n_patch, m, S)
    for name, ctx in (("bf16 window weights", float32_jax_tables),
                      ("float32 window weights", float32_jax_samplers)):
        with ctx():
            tables = jgen.apply(v, jplanes, method="pack_planes_tiled")
            d_ref = np.asarray(jgen.apply(
                v, jnp.asarray(pts), jnp.asarray(pose_s),
                jnp.asarray(bl_t.numpy()), tables,
                jnp.asarray(z_rend.numpy()), n_patch, m, S, None,
                method="nerf_density_color_tiled")[0])
        d = np.abs(d_port.numpy() - d_ref)
        i = np.unravel_index(d.argmax(), d.shape)
        print(f"density at random points, JAX with {name}: max |d| "
              f"{d.max():.4g} (port {d_port.numpy()[i]:.4g}, JAX "
              f"{d_ref[i]:.4g}), mean |d| {d.mean():.4g}, largest density "
              f"{np.abs(d_ref).max():.4g}, planes' amplitude "
              f"{float(planes.abs().max()):.3g}")


if __name__ == "__main__":
    main()
