"""Learning on the CPU: the port's ``train_loop`` overfits one 32² frame in
200 iterations at lr 1e-3 (tests/test_training.py:105-151's configuration)
on the exact sampler; tests/test_torch_overfit_tiled.py runs the same on
the patch-tiled one. The rendered frame must beat the blank (all
background) frame's PSNR by more than 2 dB, and 15 dB."""
import numpy as np
import pytest
import torch

from enarf_gan_tpu_torch.config import AttrDict
from enarf_gan_tpu_torch.data.datasets import SSODataset
from enarf_gan_tpu_torch.data.fixtures import make_synthetic_human_cache
from enarf_gan_tpu_torch.data.loader import DataLoader
from enarf_gan_tpu_torch.eval_lib.metrics import psnr
from enarf_gan_tpu_torch.training import dso

from _torch_parity import tiny_dso_config


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("overfit")
    make_synthetic_human_cache(str(root), size=32, n_frames=3, n_camera=2)
    return str(root)


@pytest.fixture
def one_thread():
    """One intra-op thread: the model is tiny, so more threads barely help
    it alone and slow it many times over while other test processes hold
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overfit_psnr(synth_root, out_root, tile_patch):
    raw = tiny_dso_config(synth_root, out_root, tile_patch=tile_patch)
    raw["dataset"]["bs"] = 1
    raw["dataset"]["train"]["n_frames"] = 1
    raw["generator_params"]["ray_batchsize"] = 512
    raw["num_iter"] = 200
    config = AttrDict(raw)
    ds = SSODataset(config.dataset.train, size=32, return_bone_params=True,
                    num_repeat_in_epoch=200)
    loader = DataLoader(ds, 1, seed=0)
    gen = dso.build_generator(config, ds.num_bone, ds.parents, device="cpu")
    gen, _, history = dso.train_loop(
        config, gen, (ds, {}), (loader, {}), ds.canonical_pose,
        verbose=False, generator=torch.Generator().manual_seed(0))
    assert len(history) == 200 and np.isfinite(history).all()
    out = dso.validate(gen, config, {"train": loader},
                       torch.Generator().manual_seed(5), num_data=1)
    item = ds[0]
    blank = psnr(item["img"][None],
                 np.full_like(item["img"][None], config.dataset.bg_color))
    return out["train"]["color_PSNR"], blank


def test_port_overfits_a_frame(synth_root, tmp_path, one_thread):
    got, blank = overfit_psnr(synth_root, str(tmp_path), tile_patch=0)
    print(f"exact: 32² overfit PSNR {got:.3f} dB (blank {blank:.3f} dB)")
    assert got > blank + 2.0 and got > 15.0, (got, blank)
