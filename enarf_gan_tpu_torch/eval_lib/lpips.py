"""LPIPS in PyTorch (the port's counterpart of
``enarf_gan_tpu/eval_lib/lpips_jax.py``): the metric of Zhang et al. with
a VGG16 or AlexNet backbone, from the weights that
``data_preprocess/export_lpips_weights.py`` writes, with the names of the
``lpips`` pip package: ``net/slice{i}/{j}/weight`` and ``.../bias`` for the
backbone's convolutions, ``lins/{i}/model/1/weight`` for the linear heads
(1, C, 1, 1), ``scaling_layer/shift`` and ``scale`` for the input, and
``net_type`` ("vgg", the default, or "alex").

Each slice's features are unit-normalised over channels, their squared
difference weighted by the slice's head and averaged over the image; the
slices' sum, averaged over the batch, is the distance.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch import DEFAULT_DEVICE

# the convolutions' indices in each torch Sequential slice, per backbone
_VGG_SLICES = {0: [0, 2], 1: [5, 7], 2: [10, 12, 14], 3: [17, 19, 21],
               4: [24, 26, 28]}
_VGG_POOL_BEFORE = {1: True, 2: True, 3: True, 4: True}
_ALEX_SLICES = {0: [0], 1: [3], 2: [6], 3: [8], 4: [10]}
_ALEX_STRIDES = {(0, 0): 4}
_ALEX_PADS = {(0, 0): 2, (1, 3): 2, (2, 6): 1, (3, 8): 1, (4, 10): 1}
_ALEX_POOL_BEFORE = {1: True, 2: True}

_CACHE: Dict[Tuple[str, str], Tuple[str, Dict[str, torch.Tensor]]] = {}


def load_weights(path: str, device=DEFAULT_DEVICE
                 ) -> Tuple[str, Dict[str, torch.Tensor]]:
    """(net_type, weights on ``device``) of the npz at ``path``, read once
    a path and device."""
    key = (path, str(device))
    if key not in _CACHE:
        data = dict(np.load(path, allow_pickle=True))
        net_type = str(data.pop("net_type")) if "net_type" in data else "vgg"
        _CACHE[key] = (net_type, {
            k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in data.items()})
    return _CACHE[key]


def _conv(x, w, b=None, stride=1, pad=0):
    """A convolution whose output may be empty: an image the backbone has
    shrunk to nothing (a crop under 16 pixels through VGG's four pools)
    gives empty features, and the distance NaN, as the JAX package's
    convolutions do."""
    out = [(n + 2 * pad - k) // stride + 1
           for n, k in zip(x.shape[-2:], w.shape[-2:])]
    if min(x.shape[-2:]) == 0 or min(out) <= 0:
        return x.new_zeros(x.shape[0], w.shape[0], *(max(n, 0) for n in out))
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def _maxpool2(x):
    """2x2 max pool of stride 2 (the last odd row and column dropped),
    empty where the input is under 2 pixels."""
    H, W = x.shape[-2] // 2, x.shape[-1] // 2
    return x[..., :2 * H, :2 * W].reshape(*x.shape[:2], H, 2, W, 2).amax(
        dim=(3, 5))


def _backbone_features(x: torch.Tensor, weights: Dict[str, torch.Tensor],
                       net_type: str) -> List[torch.Tensor]:
    alex = net_type == "alex"
    slices = _ALEX_SLICES if alex else _VGG_SLICES
    pools = _ALEX_POOL_BEFORE if alex else _VGG_POOL_BEFORE
    feats = []
    h = x
    for s in sorted(slices):
        if pools.get(s, False):
            h = _maxpool2(h)
        for j in slices[s]:
            w = weights[f"net/slice{s + 1}/{j}/weight"]
            b = weights[f"net/slice{s + 1}/{j}/bias"]
            stride = _ALEX_STRIDES.get((s, j), 1) if alex else 1
            pad = _ALEX_PADS.get((s, j)) if alex else w.shape[-1] // 2
            h = F.relu(_conv(h, w, b, stride=stride, pad=pad))
        feats.append(h)
    return feats


def _normalize_tensor(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_distance(img1, img2, weights_path: str,
                   device=DEFAULT_DEVICE) -> float:
    """LPIPS between two (B, 3, H, W) images in [-1, 1] (arrays or
    tensors), computed on ``device``."""
    net_type, weights = load_weights(weights_path, device)
    shift = weights["scaling_layer/shift"]
    scale = weights["scaling_layer/scale"]

    def prep(x):
        return (torch.as_tensor(x).to(device=device, dtype=torch.float32)
                - shift) / scale

    f1 = _backbone_features(prep(img1), weights, net_type)
    f2 = _backbone_features(prep(img2), weights, net_type)
    total = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
        val = _conv(d, weights[f"lins/{i}/model/1/weight"])
        total = total + val.mean(dim=(2, 3))
    return float(total.mean())
