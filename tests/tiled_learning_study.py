"""Does the JAX package's tiled DSO run leave the blank frame from the
port's seed-2 initial weights? (The card's 64² tiled learning run from seed
2 stays at the blank frame in some runs; ``chip_smoke.py --learn-collapse``,
``enarf_gan_tpu_torch.tools.diag_learning``.)

    JAX_PLATFORMS=cpu python tests/tiled_learning_study.py [--seed 2]
        [--draws-seed N] [--iters 200] [--size 64] [--port]

Builds the learning cell's model (``configs/DSO_train/ZJU/313_denarf_tpu.yml``
cut to one 64² frame at batch 1, ``diag_learning.learn_config``: 256²
planes, w_dim 512, Nc 48 + Nf 64, 4096 rays, ``tile_patch`` 4 with coarse
corners, lr 1e-3) with the port's initial weights from
``torch.Generator().manual_seed(seed)`` on the CPU (they do not depend on
the device), carries them into JAX's variables
(``enarf_gan_tpu/training/checkpoint.py::import_reference_state_dict``,
strict) and trains JAX's tiled model on the port's synthetic one-frame
cache for ``--iters`` iterations with JAX's own step
(``training.dso.make_train_step``, Adam with the config's decay and
``apply_if_finite``) and random numbers (``PRNGKey(seed)``, or of
``--draws-seed``, split each step as ``train_loop`` splits them). Prints
the loss every 20 iterations, then JAX's validation PSNR of the frame
against the blank frame's, whether the run left it (by more than 2 dB),
and the iteration from which the loss stayed within 1% of the first.
With ``--port`` it then trains the port on the CPU from the same weights
(``diag_learning``: the plain combines, no atomics) and prints its stage
C beside.

Not collected by pytest (no ``test_`` prefix): at full width it takes
minutes a run on the CPU.
"""
import argparse
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on the CPU, float32 matmuls)

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from enarf_gan_tpu.config import AttrDict as JAttrDict  # noqa: E402
from enarf_gan_tpu.data.datasets import SSODataset as JSSODataset  # noqa: E402
from enarf_gan_tpu.data.loader import DataLoader as JDataLoader  # noqa: E402
from enarf_gan_tpu.eval_lib.metrics import psnr  # noqa: E402
from enarf_gan_tpu.models.generator import (  # noqa: E402
    register_canonical_pose)
from enarf_gan_tpu.training import dso as jdso  # noqa: E402
from enarf_gan_tpu.training.checkpoint import (  # noqa: E402
    import_reference_state_dict, jax_tree_to_dict)

from enarf_gan_tpu_torch.data.datasets import SSODataset  # noqa: E402
from enarf_gan_tpu_torch.data.fixtures import (  # noqa: E402
    make_synthetic_human_cache)
from enarf_gan_tpu_torch.tools import diag_learning  # noqa: E402
from enarf_gan_tpu_torch.training import dso  # noqa: E402


def jax_variables(jgen, port, batch, canonical):
    """The port's weights and buffers as JAX variables shaped by
    ``jax.eval_shape`` of JAX's init."""
    rng = jax.random.PRNGKey(0)
    template = jax.eval_shape(jgen.init, rng, rng, *(
        jnp.asarray(batch[k]) for k in ("pose_3d", "camera_rotation", "mask",
                                        "frame_time", "bone_length",
                                        "inv_intrinsics")))
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                   jax_tree_to_dict(template))
    variables, _ = import_reference_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, zeros,
        strict=True)
    return register_canonical_pose(variables, canonical,
                                   jgen.nerf_params.origin_location,
                                   np.asarray(jgen.parent_id))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--tile", type=int, default=4)
    ap.add_argument("--draws-seed", type=int, default=None,
                    help="the seed of JAX's random numbers (default: "
                         "--seed)")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as out:
        root = os.path.join(out, "learn")
        make_synthetic_human_cache(root, size=args.size, n_frames=1,
                                   n_camera=1)
        config = diag_learning.learn_config(
            os.path.join(diag_learning.REPO, diag_learning.LEARN_CONFIG[0]),
            root, out, args.size, args.iters, args.tile)
        ds = SSODataset(config.dataset.train, size=args.size,
                        return_bone_params=True,
                        num_repeat_in_epoch=args.iters)
        port = dso.build_generator(
            config, ds.num_bone, ds.parents, "cpu",
            generator=torch.Generator().manual_seed(args.seed))
        dso.init_state(config, port, ds.canonical_pose)

        jconfig = JAttrDict(dict(config))
        jds = JSSODataset(jconfig.dataset.train, size=args.size,
                          return_bone_params=True,
                          num_repeat_in_epoch=args.iters)
        loader = JDataLoader(jds, 1, seed=0)
        jgen = jdso.build_generator(jconfig, jds.num_bone, jds.parents)
        first = jdso.prepare_batch(next(iter(loader)))
        variables = jax_variables(jgen, port, first, jds.canonical_pose)
        schedule = optax.exponential_decay(
            jconfig.lr, transition_steps=1,
            decay_rate=jconfig.scheduler_gamma)
        tx = optax.apply_if_finite(optax.adam(schedule, b1=0.9, b2=0.99),
                                   100)
        opt_state = tx.init(variables["params"])
        step = jdso.make_train_step(jgen, tx, jconfig.loss,
                                    jconfig.dataset.bg_color)
        draws = args.seed if args.draws_seed is None else args.draws_seed
        rng = jax.random.PRNGKey(draws)
        history, it, t0 = [], 0, time.time()
        while it < args.iters:
            for batch in loader:
                if it >= args.iters:
                    break
                rng, key = jax.random.split(rng)
                variables, opt_state, m = step(variables, opt_state, key,
                                               jdso.prepare_batch(batch))
                it += 1
                history.append(float(m["loss"]))
                if it % 20 == 0 or it == 1:
                    print(f"JAX it {it}: loss {history[-1]:.5f} "
                          f"({time.time() - t0:.0f} s)", flush=True)
        got = jdso.validate(jgen, variables, jconfig, {"train": loader},
                            jax.random.PRNGKey(5),
                            num_data=1)["train"]["color_PSNR"]
        item = jds[0]
        floor = psnr(item["img"][None], np.full_like(item["img"][None],
                                                     jconfig.dataset.bg_color))
        print(f"JAX tiled run from the port's seed-{args.seed} weights "
              f"(JAX's draws from seed {draws}), "
              f"{args.size}², {args.iters} iterations: PSNR {got:.3f} dB, "
              f"blank frame {floor:.3f} dB, left the blank frame "
              f"{got > floor + 2.0}; loss {history[0]:.5f} -> "
              f"{history[-1]:.5f}, at the first iteration's from "
              f"{diag_learning.empty_since(history)}", flush=True)
    if args.port:
        diag_learning.main(["--device", "cpu", "--size", str(args.size),
                            "--iters", str(args.iters), "--tile",
                            str(args.tile), "--seed", str(args.seed)])


if __name__ == "__main__":
    main()
