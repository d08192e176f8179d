"""The tests of tests/test_torch_train_parity.py on the patch-tiled path
(tile_patch 4, coarse corners, the "mae" loss), in a file of their own so
that the two paths' JAX compiles run in parallel."""
import pytest

from test_torch_train_parity import (make_case, one_thread,  # noqa: F401
                                     synth_root,
                                     test_train_step_gradients_match_jax,
                                     test_training_render_matches_jax)


@pytest.fixture(scope="module")
def case(synth_root, tmp_path_factory):  # noqa: F811
    return make_case("tiled", synth_root, tmp_path_factory)
