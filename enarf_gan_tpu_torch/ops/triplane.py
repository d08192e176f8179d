"""Tri-plane sampling (port of ``enarf_gan_tpu/ops/triplane.py``).

The dense samplers (``sample_feature``, ``sample_triplane_part_prob``,
``sample_weighted_feature``) sample through ``F.grid_sample`` (bilinear,
zeros, ``align_corners=False``; ``ops/grid_sample.py``), the semantics of
the JAX package's quad-row gather. They serve the variants off the
candidate path: ``no_selector``, ``selector_mlp`` and ``max_bones_per_point
>= num_bone``, where every bone of every point is sampled. Invalid
positions sit at coordinate 2, outside every plane, so zero padding drops
them. ``select_candidate_bones`` picks the candidate path's bones; the
candidate samplers (``sample_part_prob_candidates``,
``sample_weighted_feature_candidates``) are the JAX package's grid-sample
oracle of that path, which the unirow kernels replace on the card.

Plane 0 is indexed by (x, y), plane 1 by (y, z), plane 2 by (z, x); the
first coordinate of each pair is the grid-sample x (width) axis.
"""
from __future__ import annotations

from typing import Optional

import torch

from enarf_gan_tpu_torch.ops.activation import straight_through_clamp
from enarf_gan_tpu_torch.ops.grid_sample import grid_sample_2d

PLANE_COORDS = ((0, 1), (1, 2), (2, 0))


def _sample_planes(tri_plane_features: torch.Tensor,
                   position: torch.Tensor) -> torch.Tensor:
    """(B, F*3, H, W) planes at (B, 3, m) positions → (B, 3, F, m)."""
    B, C3, H, W = tri_plane_features.shape
    F = C3 // 3
    m = position.shape[-1]
    planes = tri_plane_features.reshape(B * 3, F, H, W)
    coords = torch.stack(
        [torch.stack([position[:, i], position[:, j]], dim=-1)
         for i, j in PLANE_COORDS], dim=1).reshape(B * 3, m, 2)
    return grid_sample_2d(planes, coords).reshape(B, 3, F, m)


def sample_feature(tri_plane_features: torch.Tensor, position: torch.Tensor,
                   reduction: str = "sum",
                   clamp_mask: bool = False) -> torch.Tensor:
    """Tri-plane features (B, F*3, H, W) at positions (B, 3, n) in [-1, 1]
    (zeros outside) → (B, F, n): the sum over the planes, or with
    ``reduction="prod"`` the product of their sigmoids (logits clamped
    straight-through first with ``clamp_mask``)."""
    feat = _sample_planes(tri_plane_features, position)
    if reduction == "sum":
        return feat.sum(dim=1)
    if reduction == "prod":
        if clamp_mask:
            feat = straight_through_clamp(feat)
        return torch.sigmoid(feat).prod(dim=1)
    raise ValueError(f"unknown reduction {reduction!r}")


def sample_triplane_part_prob(tri_plane_weights: torch.Tensor,
                              position: torch.Tensor,
                              position_validity: Optional[torch.Tensor] = None,
                              mode: str = "prod",
                              clamp_mask: bool = False) -> torch.Tensor:
    """Part probabilities from per-bone mask tri-planes.

    Args:
        tri_plane_weights: (B*K, 3, H, W), a 1-channel tri-plane a bone.
        position: (B, K, 3, n); position_validity: (B, K, n) bool, used by
            the "sum" mode's softmax.
    Returns:
        (B, K, n): "prod" the product of the planes' sigmoids, "sum" a
        softmax over the bones of the planes' sum (invalid bones at -1e4),
        any other mode 1/K.
    """
    bs, K, _, n = position.shape
    pos = position.reshape(bs * K, 3, n)
    if mode == "prod":
        w = sample_feature(tri_plane_weights, pos, "prod", clamp_mask)
        return w.reshape(bs, K, n)
    if mode == "sum":
        w = sample_feature(tri_plane_weights, pos, "sum", clamp_mask)
        w = w.reshape(bs, K, n) - (~position_validity) * 1e4
        return torch.softmax(w, dim=1)
    return torch.full((bs, K, n), 1.0 / K, dtype=position.dtype,
                      device=position.device)


def select_candidate_bones(canonical_pos: torch.Tensor, validity: torch.Tensor,
                           max_bones: int):
    """Pick the M most-central valid bones per point.

    Centrality is 1 - max|coord|; every valid bone is kept whenever at most
    M are valid. M repeated argmax sweeps make the same selection as the JAX
    package (lowest index first on ties).

    Args:
        canonical_pos: (B, K, 3, n); validity: (B, K, n) bool.
    Returns:
        cand_idx (B, n, M) int32, cand_valid (B, n, M) bool,
        cand_pos (B, n, M, 3), invalid candidates at coordinate 2.
    """
    B, K, _, n = canonical_pos.shape
    M = min(max_bones, K)
    centrality = 1.0 - canonical_pos.abs().amax(dim=2)      # (B, K, n)
    sc = torch.where(validity, 1.0 + centrality,
                     torch.full_like(centrality, -1.0))
    idx_l, val_l = [], []
    for _ in range(M):
        i = sc.argmax(dim=1)                                # (B, n)
        idx_l.append(i)
        val_l.append(sc.gather(1, i[:, None])[:, 0])
        sc = sc.scatter(1, i[:, None], float("-inf"))
    top_s = torch.stack(val_l, dim=-1)                      # (B, n, M)
    top_idx = torch.stack(idx_l, dim=-1)
    pos = canonical_pos.permute(0, 3, 1, 2)                 # (B, n, K, 3)
    cand_pos = torch.gather(pos, 2, top_idx[..., None].expand(B, n, M, 3))
    cand_valid = top_s > 0
    cand_pos = torch.where(cand_valid[..., None], cand_pos,
                           torch.full_like(cand_pos, 2.0))
    return top_idx.to(torch.int32), cand_valid, cand_pos


def _bilinear_flat(table_flat: torch.Tensor, base: torch.Tensor,
                   x: torch.Tensor, y: torch.Tensor, H: int,
                   W: int) -> torch.Tensor:
    """Bilinear sample of 1-channel H x W planes stored flat in
    ``table_flat``: ``base`` is each sample's plane offset, (x, y) its
    pixel coordinates (grid-sample's unnormalised ones); zeros outside.
    All index arrays share one shape, which the result takes."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    out = torch.zeros_like(x)
    for cx, cy, w in ((x0, y0, (1 - (x - x0)) * (1 - (y - y0))),
                      (x0 + 1, y0, (x - x0) * (1 - (y - y0))),
                      (x0, y0 + 1, (1 - (x - x0)) * (y - y0)),
                      (x0 + 1, y0 + 1, (x - x0) * (y - y0))):
        inb = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        idx = base + cy.clamp(0, H - 1).long() * W + cx.clamp(0, W - 1).long()
        out = out + table_flat[idx] * (w * inb)
    return out


def sample_part_prob_candidates(mask_planes: torch.Tensor,
                                cand_idx: torch.Tensor,
                                cand_pos: torch.Tensor,
                                clamp_mask: bool = False) -> torch.Tensor:
    """Part probability (the product of the 3 planes' sigmoids) of the
    candidate bones only: the candidate counterpart of
    ``sample_triplane_part_prob(mode="prod")``.

    Args:
        mask_planes: (B, K*3, H, W); cand_idx: (B, n, M) bone a candidate;
        cand_pos: (B, n, M, 3), invalid candidates at 2.
    Returns:
        (B, n, M).
    """
    B, KC, H, W = mask_planes.shape
    table = mask_planes.reshape(-1)
    batch_off = (torch.arange(B, device=cand_idx.device)
                 * (KC * H * W))[:, None, None]
    prob = torch.ones(cand_idx.shape, dtype=cand_pos.dtype,
                      device=cand_pos.device)
    for p, (i, j) in enumerate(PLANE_COORDS):
        base = batch_off + (cand_idx.long() * 3 + p) * (H * W)
        x = (cand_pos[..., i] + 1) * (W / 2) - 0.5
        y = (cand_pos[..., j] + 1) * (H / 2) - 0.5
        logit = _bilinear_flat(table, base, x, y, H, W)
        if clamp_mask:
            logit = straight_through_clamp(logit)
        prob = prob * torch.sigmoid(logit)
    return prob


def sample_weighted_feature_candidates(feat_dim: int,
                                       tri_plane_features: torch.Tensor,
                                       cand_pos: torch.Tensor,
                                       cand_weight: torch.Tensor,
                                       cand_valid: torch.Tensor,
                                       clamp_mask: bool = False
                                       ) -> torch.Tensor:
    """Weighted feature sum over pre-selected candidate bones: planes
    (B, F*3, H, W), cand_pos (B, n, M, 3), cand_weight and cand_valid
    (B, n, M) → (B, F, n)."""
    B, n, M, _ = cand_pos.shape
    p = cand_pos.permute(0, 3, 1, 2).reshape(B, 3, n * M)
    feat = sample_feature(tri_plane_features, p, "sum", clamp_mask)
    feat = feat.reshape(B, feat_dim, n, M)
    w = (cand_weight * cand_valid).to(feat.dtype)
    return torch.einsum("bfnm,bnm->bfn", feat, w)


def sample_weighted_feature_topm(feat_dim: int,
                                 tri_plane_features: torch.Tensor,
                                 position: torch.Tensor, weight: torch.Tensor,
                                 position_validity: torch.Tensor,
                                 max_bones: int = 4,
                                 clamp_mask: bool = False) -> torch.Tensor:
    """The weighted feature sum over each point's ``max_bones``
    highest-weight valid bones (lowest index first on ties, as
    ``lax.top_k``); exact whenever no more bones are valid at a point."""
    bs, K, _, n = position.shape
    M = min(max_bones, K)
    score = (weight * position_validity).permute(0, 2, 1)   # (B, n, K)
    top_w, top_idx = torch.sort(score, dim=2, descending=True, stable=True)
    top_w, top_idx = top_w[..., :M], top_idx[..., :M]
    pos = position.permute(0, 3, 1, 2)                      # (B, n, K, 3)
    top_pos = torch.gather(pos, 2, top_idx[..., None].expand(bs, n, M, 3))
    top_pos = torch.where(top_w[..., None] > 0, top_pos,
                          torch.full_like(top_pos, 2.0))
    p = top_pos.permute(0, 3, 1, 2).reshape(bs, 3, n * M)
    feat = sample_feature(tri_plane_features, p, "sum", clamp_mask)
    feat = feat.reshape(bs, feat_dim, n, M)
    return torch.einsum("bfnm,bnm->bfn", feat, top_w)


def sample_weighted_feature(feat_dim: int, tri_plane_features: torch.Tensor,
                            position: torch.Tensor, weight: torch.Tensor,
                            position_validity: torch.Tensor,
                            clamp_mask: bool = False,
                            max_bones: Optional[int] = None) -> torch.Tensor:
    """Validity-masked, part-weighted sum over bones of the shared feature
    planes sampled at each bone's canonical position.

    Args:
        tri_plane_features: (B, F*3, H, W); position: (B, K, 3, n), invalid
            at 2; weight: (B, K, n); position_validity: (B, K, n) bool.
        max_bones: below K, ``sample_weighted_feature_topm``.
    Returns:
        (B, F, n).

    The JAX function broadcasts the planes over the bones, which XLA never
    materialises; here the bones are folded into the sample axis instead
    (each plane sampled at K*n positions), the same function without K
    copies of the planes.
    """
    bs, K, _, n = position.shape
    if max_bones is not None and max_bones < K:
        return sample_weighted_feature_topm(
            feat_dim, tri_plane_features, position, weight,
            position_validity, max_bones, clamp_mask)
    p = position.permute(0, 2, 1, 3).reshape(bs, 3, K * n)
    feat = _sample_planes(tri_plane_features, p).sum(dim=1)  # (B, F, K*n)
    feat = feat.reshape(bs, feat_dim, K, n)
    w = (weight * position_validity).to(feat.dtype)
    return torch.einsum("bfkn,bkn->bfn", feat, w)
