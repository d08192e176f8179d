"""The measurement tools of ``enarf_gan_tpu_torch.tools`` (frame_ablate,
frame_parts, production, gan_step, diag_learning) run end to end on the
CPU at a tiny size (``--device cpu`` and the smoke widths of
``tools/benchkit.py``) and print their documented JSON lines; the device
fields are None there, since only a run on the card measures them. On the
card ``python3 chip_smoke.py`` runs each at full width (phase "tools").
"""
import json
import os

import pytest
import torch

from enarf_gan_tpu_torch.tools import (diag_learning, frame_ablate,
                                       frame_parts, gan_step, production)

SMALL_DSO = dict(BENCH_RENDER_SIZE=8, BENCH_PLANES=32, BENCH_W_DIM=32,
                 BENCH_NC=8, BENCH_NF=8, BENCH_RAY_CHUNK=64, REPS=1)
DEVICE_KEYS = {"device_ms", "busy", "kernel_launches", "device_ms_by_class"}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, and denormals flushed: R1's double backward
    through a freshly stepped discriminator slows some 40x on denormal
    floats on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_num_threads(n)
    torch.set_flush_denormal(False)


def _lines(capsys, tool):
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out and all(r["tool"] == tool and r["card"] == "cpu" for r in out)
    return out


def _env(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def test_frame_ablate(monkeypatch, capsys):
    _env(monkeypatch, SMALL_DSO)
    monkeypatch.delenv("ENARF_ABLATE", raising=False)
    out = frame_ablate.main(["--device", "cpu"])
    lines = _lines(capsys, "frame_ablate")
    assert set(out) == {"exact", "tilewin4"} and len(lines) == 8
    for path, rec in out.items():
        assert [r["variant"] for r in rec["variants"]] == \
            ["full", "nosampler", "noheads"]
        for r in rec["variants"]:
            assert {"ms_host", "launches_a_frame", "kernel1_launches",
                    "kernel2_launches", "ablate", "reps"} | DEVICE_KEYS <= \
                set(r)
            assert r["ms_host"] > 0 and r["device_ms"] is None
        split = rec["split"]["split_ms_host"]
        assert set(split) == {"full", "sampler", "heads", "rest"}
        assert abs(split["full"] - split["sampler"] - split["heads"]
                   - split["rest"]) < 1e-9
    assert "ENARF_ABLATE" not in os.environ      # removed after each variant


def test_frame_ablate_one_path_and_variant(monkeypatch, capsys):
    _env(monkeypatch, {**SMALL_DSO, "BENCH_TILED": 0,
                       "ABLATE_VARIANTS": "nosampler"})
    out = frame_ablate.main(["--device", "cpu"])
    assert list(out) == ["exact"]
    assert [r["variant"] for r in out["exact"]["variants"]] == ["nosampler"]
    assert out["exact"]["split"]["split_ms_host"]["sampler"] is None
    _lines(capsys, "frame_ablate")


def test_frame_parts(monkeypatch, capsys):
    _env(monkeypatch, {**SMALL_DSO, "BENCH_RENDER_SIZE": 16})
    frame_parts.main(["--device", "cpu"])
    lines = _lines(capsys, "frame_parts")
    by_path = {p: [r["piece"] for r in lines if r["path"] == p]
               for p in ("exact", "tilewin4")}
    for names in by_path.values():
        assert names[0] == "latents+transform" and names[-1] == "frame"
    assert any("unirow_combine fine" in n for n in by_path["exact"])
    for piece in ("pack_planes_tiled", "select_patch_slots fine",
                  "texel_plan coarse", "tilewin_combine fine"):
        assert any(piece in n for n in by_path["tilewin4"]), piece
    assert all({"ms_host", "reps"} | DEVICE_KEYS <= set(r) for r in lines)


def test_production(monkeypatch, capsys):
    _env(monkeypatch, {**SMALL_DSO, "BENCH_IMAGE_SIZE": 16, "BENCH_BS": 2,
                       "BENCH_ITERS": 1, "BENCH_REPS": 1,
                       "BENCH_RENDER_BS": 128})
    out = production.main(["--device", "cpu"])
    lines = _lines(capsys, "production")
    assert [(r["metric"], r["tile_patch"]) for r in lines] == [
        ("dso512_train_s_per_iter", 0), ("demo1024_s_per_frame", 0),
        ("dso512_train_s_per_iter", 4), ("demo1024_s_per_frame", 4)]
    assert out == lines
    for r in lines:
        assert {"metric", "value", "unit", "tile_patch", "compile_s",
                "peak_gib"} | DEVICE_KEYS <= set(r)
        assert r["value"] > 0 and r["peak_gib"] is None
    assert {"bs", "loss"} <= set(lines[0])
    assert {"mrays_per_s", "render_bs"} <= set(lines[1])


def test_gan_step(monkeypatch, capsys):
    _env(monkeypatch, dict(GAN_BS=2, GAN_SIZE=16, GAN_PLANES=16, GAN_NC=4,
                           GAN_NF=4, GAN_ACCUM=1, GAN_RAY_CHUNK=256,
                           GAN_ITERS=1, GAN_CHANNEL_MAX=32))
    out = gan_step.main(["--device", "cpu"])
    lines = _lines(capsys, "gan_step")
    assert [r["step"] for r in lines] == ["G", "D", "R1",
                                          "iteration (R1 every 16)"]
    for r in lines[:3]:
        assert {"s", "peak_gib", "launches_a_step", "metrics"} | \
            DEVICE_KEYS <= set(r)
    assert abs(out["iteration"]["s"] - out["G"]["s"] - out["D"]["s"]
               - out["R1"]["s"] / 16) < 1e-9
    assert "r1_reg" in out["R1"]["metrics"]


def test_diag_learning(capsys):
    out = diag_learning.main(["--device", "cpu", "--config", "quality",
                              "--size", "16", "--iters", "5",
                              "--log-every", "2", "--tile", "4",
                              "--seed", "2"])
    lines = _lines(capsys, "diag_learning")
    assert [r["stage"] for r in lines] == ["A", "B", "B", "B", "C"]
    assert [r["it"] for r in lines[1:4]] == [1, 2, 4]
    assert out["A"]["coverage"] > 0.9       # the fixture's scene is in view
    assert {"loss", "lc", "lm", "mask_at_fg", "mask_at_bg",
            "fine_density_mean", "fine_density_max", "gnorm", "g_density",
            "g_tri_plane", "applied"} <= set(lines[1])
    assert {"psnr", "floor", "left_blank", "empty_since"} <= set(out["C"])
    assert out["C"]["lr"] == 0.02 and out["C"]["seed"] == 2


def test_diag_learning_reads_a_config_file(tmp_path, capsys):
    """A training YAML read over configs/DSO_train/default.yml (here a
    tiny tri-plane override) and cut to one frame, as the learning phase
    cuts 313_denarf_tpu.yml; ``--lr`` replaces the config's rate."""
    cfg = tmp_path / "tiny.yml"
    cfg.write_text("generator_params:\n  ray_batchsize: 64\n"
                   "  nerf_params:\n    hidden_size: 16\n    Nc: 4\n"
                   "    Nf: 4\n    tri_plane_size: 16\n    w_dim: 16\n"
                   "    use_triplane: true\n    deformation_field: true\n"
                   "    time_conditional: true\n    render_bs: 64\n"
                   "  use_triplane: true\n")
    out = diag_learning.main(["--device", "cpu", "--config", str(cfg),
                              "--size", "8", "--iters", "2", "--lr",
                              "0.01"])
    assert out["C"]["lr"] == 0.01 and out["C"]["config"] == "tiny.yml"
    _lines(capsys, "diag_learning")


def test_tools_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for main in (frame_ablate.main, frame_parts.main, production.main,
                 gan_step.main, diag_learning.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([])
