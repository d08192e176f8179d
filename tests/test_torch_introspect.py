"""The port's ``utils/introspect.py`` against the JAX package's.

* ``param_count`` and ``param_bytes`` of the port's DSO and GAN generators
  equal JAX's over the same parameters (``_torch_parity.build_pair``'s
  DSO model, JAX's tree traced by ``jax.eval_shape``, and
  ``gan_pair_from_port``'s GAN generator; both give JAX's parameter tree in
  seconds, where its jitted init takes tens of seconds);
* ``flops_estimate`` of a bias-free dense layer equals JAX's (XLA's cost
  analysis) within 1%, and is None where the call fails;
* ``device_memory_stats`` of the CPU is ``{}``, as JAX's for a backend
  without statistics; ``trace`` writes a Chrome trace; ``Timer``
  accumulates; ``profile_by_class``'s kernel classes.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.utils import introspect as jintrospect
from enarf_gan_tpu_torch.utils import introspect

from _torch_parity import PARENTS, SMALL, gan_pair_from_port


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dso_pair():
    """(JAX's variables as shapes, the port's model) of ``build_pair``'s
    DSO model: JAX's init traced by ``jax.eval_shape`` (its parameter tree
    without computing it)."""
    from enarf_gan_tpu.models.generator import DSONARFGenerator
    from enarf_gan_tpu.models.narf import NARFParams
    from enarf_gan_tpu_torch.models import generator as tgen
    from enarf_gan_tpu_torch.models.narf import NARFParams as TNARFParams
    from enarf_gan_tpu_torch.data.fixtures import tiny_scene
    kw = {**SMALL, "render_bs": 64}
    gen = DSONARFGenerator(nerf_params=NARFParams(**kw), size=16,
                           num_bone=24, parent_id=PARENTS, use_triplane=True,
                           ray_batchsize=64)
    pose_cam, world, bl, inv_K, _, _ = tiny_scene(1, 16)
    rng = jax.random.PRNGKey(0)
    variables = jax.eval_shape(gen.init, rng, rng, jnp.asarray(pose_cam),
                               jnp.asarray(world[:, 0, :3, :3]),
                               jnp.ones((1, 16, 16)), jnp.array([0.5]),
                               jnp.asarray(bl), jnp.asarray(inv_K))
    port = tgen.DSONARFGenerator(TNARFParams(**kw), num_bone=24,
                                 parent_id=PARENTS, device="cpu")
    return variables, port


@pytest.mark.parametrize("model", ["dso", "gan"])
def test_param_count_and_bytes_match_jax(model):
    if model == "dso":
        variables, port = _dso_pair()
    else:
        _, variables, port, _, _ = gan_pair_from_port(size=16)
    n = jintrospect.param_count(variables["params"])
    assert introspect.param_count(port) == n > 0
    assert introspect.param_bytes(port) == \
        jintrospect.param_bytes(variables["params"]) == 4 * n
    # a state dict counts its buffers too; a dict of tensors what it holds
    sd = port.state_dict()
    assert introspect.param_count(sd) == sum(v.numel() for v in sd.values())
    half = {k: v.half() for k, v in port.named_parameters()}
    assert introspect.param_count(half) == n
    assert introspect.param_bytes(half) == 2 * n


def test_flops_estimate_of_a_dense_layer_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 96).astype(np.float32)
    w = rs.randn(96, 48).astype(np.float32)
    ref = jintrospect.flops_estimate(lambda a, b: a @ b, jnp.asarray(x),
                                     jnp.asarray(w))
    got = introspect.flops_estimate(lambda a, b: a @ b, torch.from_numpy(x),
                                    torch.from_numpy(w))
    assert ref is not None and got == 2 * 64 * 96 * 48
    assert abs(got - ref) <= 0.01 * ref, (got, ref)
    layer = torch.nn.Linear(96, 48, bias=False)
    assert introspect.flops_estimate(layer, torch.from_numpy(x)) == got


def test_flops_estimate_is_none_where_counting_fails():
    def broken(x):
        raise RuntimeError("no")
    assert introspect.flops_estimate(broken, torch.ones(2)) is None


def test_device_memory_stats_of_the_cpu_is_empty():
    assert introspect.device_memory_stats("cpu") == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with introspect.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = os.path.join(tmp_path, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_timer_accumulates():
    timer = introspect.Timer()
    x = torch.ones(8)
    for _ in range(2):
        with timer.section("a", sync_on=x):
            torch.ones(64, 64).sum()
    with timer.section("b"):
        pass
    assert set(timer.totals) == {"a", "b"}
    assert timer.totals["a"] > 0 and timer.totals["b"] >= 0
    with pytest.raises(ValueError):
        with timer.section("c"):
            raise ValueError("counted all the same")
    assert "c" in timer.totals


@pytest.mark.parametrize("name,cls", [
    ("unirow_combine_kernel(...)", "unirow kernels"),
    ("void tilewin_combine_kernel<16, 0>(...)", "tilewin kernels"),
    ("grid_sampler_2d_kernel", "grid sample"),
    ("sm80_xmma_fprop_implicit_gemm_indexed", "convolution"),
    ("sm80_xmma_gemm_f32f32_f32f32", "gemm"),
    ("cutlass_80_tensorop_s1688gemm", "gemm"),
    ("radixsortblock", "sort"),
    ("index_elementwise_kernel", "index/gather"),
    ("reduce_kernel<512, 1>", "reduce"),
    ("vectorized_elementwise_kernel", "elementwise/other")])
def test_profile_classes(name, cls):
    assert introspect._kernel_class(name.lower()) == cls


def test_card_of_the_cpu():
    assert introspect.card("cpu") == "cpu"
