"""The tests of tests/test_torch_train_parity.py on float32 planes (JAX's
quad tables, the port's float32 texel table: kernels 1f and 1bf on the
card, their plain twin here) for a 313_denarf.yml-shaped model (deformation
field, pose and time conditioning, the "mae" loss, the exact sampler), in a
file of its own so that its JAX compile runs beside the others."""
import pytest

from test_torch_train_parity import (make_case, one_thread,  # noqa: F401
                                     synth_root,
                                     test_train_step_gradients_match_jax,
                                     test_training_render_matches_jax)


@pytest.fixture(scope="module")
def case(synth_root, tmp_path_factory):  # noqa: F811
    return make_case("float32", synth_root, tmp_path_factory)
