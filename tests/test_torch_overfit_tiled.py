"""tests/test_torch_overfit.py's learning check on the patch-tiled sampler
(tile_patch 4), in a file of its own so that the two run in parallel."""
from test_torch_overfit import one_thread, overfit_psnr, synth_root  # noqa: F401


def test_port_overfits_a_frame_tiled(synth_root, tmp_path,  # noqa: F811
                                     one_thread):  # noqa: F811
    got, blank = overfit_psnr(synth_root, str(tmp_path), tile_patch=4)
    print(f"tiled: 32² overfit PSNR {got:.3f} dB (blank {blank:.3f} dB)")
    assert got > blank + 2.0 and got > 15.0, (got, blank)
