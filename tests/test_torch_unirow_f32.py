"""The float32 candidate sampler of kernels 1f and 1bf
(``ops/unirow.py::pack_texels_f32``, ``sample_f32``; on the CPU its plain
twin ``sample_f32_plain``) against the JAX package's float32 sampler,
``ops/quadtable.py`` (``pack_quadtable`` + ``sample_candidates_quadtable``,
XLA row gathers and autodiff), against the earlier float32 layout
(``pack_texels(..., float32)``), and the kernels' own arithmetic emulated
lane by lane in numpy.

Tolerances against JAX are tests/test_quadtable.py's: part probabilities
2e-5, features 2e-4, gradients 2e-3 (all float32; the sums run in another
order). The layouts hold the same floats, so those comparisons are exact.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from enarf_gan_tpu.ops import quadtable as jquad
from enarf_gan_tpu_torch.ops import unirow
from enarf_gan_tpu_torch.ops.quadtable import _quad_cells_weights
from enarf_gan_tpu_torch.tools import ablate

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the inputs are tiny, and threads on cores that
    other test workers hold only slow them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(H, W, F, K, n, M, seed=0, B=2):
    """Planes and candidates as tests/test_torch_quadtable.py makes them:
    positions in range, on the edges and far out of range (2), about 30%
    invalid; and point 4 on a cell's corner, x = (px + 1) * W/2 - 0.5 = 1
    (fx = 0) and y likewise where the arithmetic is exact (W, H even and
    3/W, 3/H binary fractions), where a corner's weight is 0 but not its
    derivative."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(B, (F + K) * 3, H, W)).astype(np.float32)
    pos = rng.uniform(-1.4, 1.4, (B, n, M, 3)).astype(np.float32)
    pos[:, :4] = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                           [-0.999, 0.999, 0.0], [2.0, 2.0, 2.0]],
                          np.float32)[None, :, None, :]
    if n > 4:
        pos[:, 4] = np.array([3 / W - 1, 3 / H - 1, 3 / W - 1], np.float32)
    idx = rng.integers(0, K, (B, n, M)).astype(np.int32)
    valid = rng.random((B, n, M)) > 0.3
    return planes, pos, idx, valid


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _jax(planes, pos, idx, valid, F, K, H, W, clamp):
    tables = jquad.pack_quadtable(planes, F, K, jnp.float32)
    return jquad.sample_candidates_quadtable(tables, pos, idx, valid, F, K,
                                             H, W, clamp_mask=clamp)


def _twin(planes, pos, idx, valid, F, K, clamp):
    return unirow.sample_f32_plain(unirow.pack_texels_f32(planes, F, K), pos,
                                   idx, valid, F, clamp)


@pytest.mark.parametrize("H,W,F,K,n,M,clamp", [
    (16, 16, 32, 23, 64, 4, False), (16, 16, 32, 24, 64, 4, True),
    (8, 12, 8, 23, 33, 3, True), (12, 12, 32, 24, 50, 7, False)])
def test_plain_twin_matches_jax_quadtable(H, W, F, K, n, M, clamp):
    planes, pos, idx, valid = _inputs(H, W, F, K, n, M)
    f_ref, w_ref = _jax(planes, pos, idx, valid, F, K, H, W, clamp)
    feat, w = _twin(T(planes), T(pos), T(idx), T(valid), F, K, clamp)
    assert feat.shape == (2, F, n) and w.shape == (2, n, M)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(f_ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("H,F,K,M,clamp", [(8, 4, 23, 3, False),
                                           (16, 32, 24, 4, True),
                                           (12, 32, 23, 4, True),
                                           (8, 8, 24, 2, False)])
def test_plain_twin_gradients_match_jax(H, F, K, M, clamp):
    """Gradients of a loss of both outputs with respect to the planes and
    the positions: autograd through ``pack_texels_f32`` and the twin
    against ``jax.grad`` through the quad tables (invalid candidates
    included: their cand_w depends on their positions too)."""
    planes, pos, idx, valid = _inputs(H, H, F, K, 17, M, seed=2)
    rng = np.random.default_rng(3)
    cf = rng.normal(size=(2, F, 17)).astype(np.float32)
    cw = rng.normal(size=(2, 17, M)).astype(np.float32)

    def jloss(planes, pos):
        f, w = _jax(planes, pos, idx, valid, F, K, H, H, clamp)
        return (f * cf).sum() + (w * cw).sum()

    g_ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(planes),
                                                     jnp.asarray(pos))
    tp = T(planes).requires_grad_(True)
    tq = T(pos).requires_grad_(True)
    f, w = _twin(tp, tq, T(idx), T(valid), F, K, clamp)
    g = torch.autograd.grad((f * T(cf)).sum() + (w * T(cw)).sum(), [tp, tq])
    assert float(g[0].abs().max()) > 0 and float(g[1].abs().max()) > 0
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("F,K", [(32, 23), (8, 24)])
def test_f32_tables_hold_pack_texels_values(F, K):
    """The feature table is ``pack_texels(..., float32)``'s feature half and
    the mask planes its mask lanes 32..32+K, bone-major, bit for bit; the
    32 - K lanes of padding are gone."""
    planes, *_ = _inputs(10, 14, F, K, 4, 1)
    old = unirow.pack_texels(T(planes), F, K, dtype=torch.float32)
    new = unirow.pack_texels_f32(T(planes), F, K)
    assert isinstance(new, unirow.Float32Texels)
    assert new.feature.shape == (2, 3, 12, 16, 32)
    assert new.feature.is_contiguous()
    assert new.mask.shape == (2, 3, K, 12, 16) and new.mask.is_contiguous()
    assert new.dtype == torch.float32
    assert torch.equal(new.feature, old[..., :32])
    assert torch.equal(new.mask,
                       old[..., 32:32 + K].permute(0, 1, 4, 2, 3))
    assert not old[..., 32 + K:].any()


@pytest.mark.parametrize("F,K", [(32, 23), (4, 24)])
def test_f32_pack_backward_matches_old_layout(F, K):
    """The pack's backward gives the planes the gradient that the old
    layout's gives for the same table cotangents, bit for bit."""
    planes, *_ = _inputs(9, 9, F, K, 4, 1)
    rng = np.random.default_rng(4)
    cot_f = T(rng.normal(size=(2, 3, 11, 11, 32)).astype(np.float32))
    cot_m = T(rng.normal(size=(2, 3, K, 11, 11)).astype(np.float32))
    p_new = T(planes).requires_grad_(True)
    new = unirow.pack_texels_f32(p_new, F, K)
    (g_new,) = torch.autograd.grad((new.feature * cot_f).sum()
                                   + (new.mask * cot_m).sum(), [p_new])
    p_old = T(planes).requires_grad_(True)
    old = unirow.pack_texels(p_old, F, K, dtype=torch.float32)
    cot = torch.cat([cot_f, cot_m.permute(0, 1, 3, 4, 2),
                     torch.zeros(2, 3, 11, 11, 32 - K)], dim=-1)
    (g_old,) = torch.autograd.grad((old * cot).sum(), [p_old])
    assert float(g_new.abs().max()) > 0
    assert torch.equal(g_new, g_old)


@pytest.mark.parametrize("clamp", [False, True])
def test_twin_is_the_earlier_float32_path(clamp):
    """``sample_f32_plain`` on the new tables computes what the parent's
    float32 path computed (``candidate_rows`` + ``unirow_combine`` on the
    64-lane float32 texel table), number for number."""
    F, K = 32, 23
    planes, pos, idx, valid = _inputs(16, 16, F, K, 40, 4, seed=5)
    old = unirow.pack_texels(T(planes), F, K, dtype=torch.float32)
    f_old, w_old = unirow.sample_candidates_unirow(
        old, T(pos), T(idx), T(valid), F, K, 16, 16, clamp_mask=clamp)
    f_new, w_new = unirow.sample_candidates_unirow(
        unirow.pack_texels_f32(T(planes), F, K), T(pos), T(idx), T(valid),
        F, K, 16, 16, clamp_mask=clamp)
    assert torch.equal(w_new, w_old) and torch.equal(f_new, f_old)


# ------------------------------------------------ the kernels' arithmetic

def _corner_of(px, py, H, W, q):
    """unirow_f32.cuh's corner_of in numpy float32 (each operation rounded
    once, no fused multiply-add): (w, gx, gy, texel)."""
    f32 = np.float32
    x = f32(f32(f32(px) + f32(1)) * f32(0.5 * W)) - f32(0.5)
    y = f32(f32(f32(py) + f32(1)) * f32(0.5 * H)) - f32(0.5)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = f32(x - x0), f32(y - y0)
    right, down = q & 1, q >> 1
    in_x = (-1 <= x0 <= W - 2) if right else (0 <= x0 <= W - 1)
    in_y = (-1 <= y0 <= H - 2) if down else (0 <= y0 <= H - 1)
    cx = (fx if right else f32(1) - fx) if in_x else f32(0)
    wy = (fy if down else f32(1) - fy) if in_y else f32(0)
    s = int(min(max(x0, -1), W - 1)) + 1
    t = int(min(max(y0, -1), H - 1)) + 1
    gx = (wy if right else -wy) if in_x else f32(0)
    gy = (cx if down else -cx) if in_y else f32(0)
    return f32(cx * wy), gx, gy, (t + down) * (W + 2) + s + right


def test_kernel_corner_weights_are_pytorchs():
    """The kernels' cells and corner weights, computed lane by lane from
    the positions, are ``_quad_cells_weights``' bit for bit (the floor
    lands on the same cell), the edges and the far-out positions
    included."""
    H, W = 16, 12
    _, pos, _, _ = _inputs(H, W, 4, 3, 40, 3, seed=6, B=1)
    pos[0, 5, 0] = (-1.0, 1.0, np.nextafter(np.float32(-1), np.float32(0)))
    cells, wq = _quad_cells_weights(T(pos).permute(0, 3, 2, 1), H, W)
    for i in range(pos.shape[1]):
        for m in range(pos.shape[2]):
            for p in range(3):
                px, py = pos[0, i, m, p], pos[0, i, m, (p + 1) % 3]
                cell = int(cells[0, p, m, i])
                t, s = cell // (W + 1), cell % (W + 1)
                for q in range(4):
                    w, _, _, tex = _corner_of(px, py, H, W, q)
                    assert tex == (t + q // 2) * (W + 2) + s + q % 2
                    assert np.float32(wq[q][0, p, m, i]).tobytes() == \
                        np.float32(w).tobytes(), (i, m, p, q)


@pytest.mark.parametrize("grad", [False, True])
def test_f32_table_bytes_counts_what_the_kernels_load(grad):
    """The bound's table bytes (``tools/ablate.py::f32_table_bytes``) are
    the distinct feature lines and mask sectors that kernel 1f (1bf with
    ``grad``) loads, found corner by corner with the kernels' arithmetic:
    a corner of nonzero weight, or in the backward of nonzero derivative
    (point 4's corners on the cell's edges)."""
    F, K, H = 32, 5, 6
    planes, pos, idx, valid = _inputs(H, H, F, K, 9, 3, seed=9)
    plane = (H + 2) ** 2
    lines, sectors, edge = set(), set(), 0
    for b, i, m, p, q in np.ndindex(2, 9, 3, 3, 4):
        w, gx, gy, tex = _corner_of(pos[b, i, m, p],
                                    pos[b, i, m, (p + 1) % 3], H, H, q)
        if w or (grad and (gx or gy)):
            edge += not w
            sectors.add((((b * 3 + p) * K + idx[b, i, m]) * plane + tex)
                        // 8)
            if valid[b, i, m]:
                lines.add((b * 3 + p) * plane + tex)
    assert bool(edge) == grad
    got = ablate.f32_table_bytes(unirow.pack_texels_f32(T(planes), F, K),
                                 T(pos), T(idx), T(valid), grad=grad)
    assert got == (len(lines) * 128 + len(sectors) * 32, len(lines),
                   len(sectors))


def _sum4_entry(c):
    return ((c & 1) << 1) | (c >> 1)


def _kernel_1bf(tables, pos, idx, valid, dfeature, dcand_w, clamp):
    """Kernel 1bf emulated a lane's values at a time: half h's candidate,
    lane (q, c) with its plane pe = sum4_entry(c), the shuffles written out
    as sums over the lanes they reach, the position's y term taken from
    lane y_lane, the mask pair added from the even corner at its texel and
    the next one. Returns (dfeat, dmask, dpos) in numpy."""
    ft, mt = (t.numpy() for t in tables)
    B, _, Hp, Wp, _ = ft.shape
    K, H, W = mt.shape[2], Hp - 2, Wp - 2
    n, M = pos.shape[1:3]
    dft, dmt = np.zeros_like(ft), np.zeros_like(mt)
    dpos = np.full(pos.shape, np.nan, np.float32)
    for b in range(B):
        for i in range(n):
            df = dfeature[b, :, i]
            for m in range(M):
                k = min(max(int(idx[b, i, m]), 0), K - 1)
                v = float(valid[b, i, m])
                cr = [[_corner_of(pos[b, i, m, p], pos[b, i, m, (p + 1) % 3],
                                  H, W, q) for p in range(3)]
                      for q in range(4)]
                w = np.array([[cr[q][p][0] for p in range(3)]
                              for q in range(4)])
                tex = [[cr[q][p][3] for p in range(3)] for q in range(4)]
                # a corner loads where its weight or the weight's
                # derivative is not 0 (load_planes<true>)
                live = [[any(cr[q][p][:3]) for p in range(3)]
                        for q in range(4)]
                mask = np.array([[mt[b, p, k].reshape(-1)[tex[q][p]]
                                  if live[q][p] else 0 for p in range(3)]
                                 for q in range(4)])
                line = np.array([[ft[b, p].reshape(-1, 32)[tex[q][p]]
                                  if live[q][p] and v else np.zeros(32)
                                  for p in range(3)] for q in range(4)])
                logit = (w * mask).sum(0)
                if clamp:
                    logit = np.clip(logit, -2, 5)
                sig = 1 / (1 + np.exp(-logit))
                cw = sig.prod()
                dots = line @ df                         # (q, p)
                g = (w * dots).sum()
                wt, dcw = cw * v, g * v + dcand_w[b, i, m]
                dlogit = dcw * cw * (1 - sig)
                dw = wt * dots + mask * dlogit           # (q, p)
                # the lanes (q, c): plane pe = sum4_entry(c); summed over q
                sx = {c: sum(dw[q, _sum4_entry(c)] * cr[q][_sum4_entry(c)][1]
                             for q in range(4)) for c in range(3)
                      if _sum4_entry(c) < 3}
                sy = {c: sum(dw[q, _sum4_entry(c)] * cr[q][_sum4_entry(c)][2]
                             for q in range(4)) for c in sx}
                for c in sx:
                    pe = _sum4_entry(c)
                    y_lane = _sum4_entry(2 if pe == 0 else pe - 1)
                    dpos[b, i, m, pe] = sx[c] * (0.5 * W) \
                        + sy[y_lane] * (0.5 * H)
                    for q in (0, 2):             # the even corners
                        at = tex[q][pe]
                        assert tex[q + 1][pe] == at + 1
                        add = dmt[b, pe, k].reshape(-1)
                        add[at] += w[q, pe] * dlogit[pe]
                        add[at + 1] += w[q + 1, pe] * dlogit[pe]
                for q in range(4):
                    for p in range(3):
                        if w[q, p] * wt:
                            dft[b, p].reshape(-1, 32)[tex[q][p]] += \
                                w[q, p] * wt * df
    return dft, dmt, dpos


@pytest.mark.parametrize("clamp", [False, True])
def test_kernel_1bf_arithmetic_is_autograds(clamp):
    """Kernel 1bf's formulas and lane mapping, emulated in numpy: both
    tables' gradients and the positions' against autograd through the
    plain twin (relative L2 1e-5: float64 sums against float32)."""
    F, K, H = 32, 5, 6
    planes, pos, idx, valid = _inputs(H, H, F, K, 7, 3, seed=7, B=1)
    rng = np.random.default_rng(8)
    dfeature = rng.normal(size=(1, F, 7)).astype(np.float32)
    dcand_w = rng.normal(size=(1, 7, 3)).astype(np.float32)
    tables = unirow.pack_texels_f32(T(planes), F, K)
    leaves = [t.clone().requires_grad_(True) for t in tables] \
        + [T(pos).requires_grad_(True)]
    f, w = unirow.sample_f32_plain(unirow.Float32Texels(*leaves[:2]),
                                   leaves[2], T(idx), T(valid), F, clamp)
    want = torch.autograd.grad((f * T(dfeature)).sum()
                               + (w * T(dcand_w)).sum(), leaves)
    got = _kernel_1bf(tables, pos, idx, valid, dfeature, dcand_w, clamp)
    for a, b in zip(got, want):
        b = b.double().numpy()
        assert np.isfinite(a).all() and np.abs(b).max() > 0
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
