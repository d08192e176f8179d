"""InceptionV3 pool3 features in PyTorch (the port's counterpart of
``enarf_gan_tpu/eval_lib/inception_jax.py``).

torchvision's inception_v3 graph as a plain function of a weight dict
(names as ``data_preprocess/export_inception_weights.py`` writes them:
``Mixed_5b/branch1x1/conv/weight`` and so on): BasicConv2d is a
convolution, BatchNorm with eps 1e-3 and a ReLU; the mixed blocks A to E;
2048-d features from the global average pool. The 3x3 average pools of
the branches divide by the count of in-bounds elements
(``count_include_pad=False``), as the JAX graph does.

``random_weights(seed)`` draws the same He-init weight set as the JAX
package's from the same ``np.random.RandomState`` stream, so that
``"random:<seed>"`` names one weight set in both packages. FID computed
with it is self-consistent, and comparable with no published number.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

import numpy as np
import torch
import torch.nn.functional as F

from enarf_gan_tpu_torch import DEFAULT_DEVICE

Weights = Dict[str, torch.Tensor]


def _conv_bn(x, w: Weights, name: str, stride=1, padding=(0, 0)):
    if isinstance(padding, int):
        padding = (padding, padding)
    y = F.conv2d(x, w[f"{name}/conv/weight"], stride=stride, padding=padding)
    scale = torch.rsqrt(w[f"{name}/bn/running_var"] + 1e-3)
    y = (y - w[f"{name}/bn/running_mean"][None, :, None, None]) \
        * scale[None, :, None, None]
    y = y * w[f"{name}/bn/weight"][None, :, None, None] \
        + w[f"{name}/bn/bias"][None, :, None, None]
    return F.relu(y)


def _maxpool(x, k=3, s=2):
    return F.max_pool2d(x, k, s)


def _avgpool3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _inception_a(x, w, name):
    b1 = _conv_bn(x, w, f"{name}/branch1x1")
    b5 = _conv_bn(x, w, f"{name}/branch5x5_1")
    b5 = _conv_bn(b5, w, f"{name}/branch5x5_2", padding=2)
    b3 = _conv_bn(x, w, f"{name}/branch3x3dbl_1")
    b3 = _conv_bn(b3, w, f"{name}/branch3x3dbl_2", padding=1)
    b3 = _conv_bn(b3, w, f"{name}/branch3x3dbl_3", padding=1)
    bp = _conv_bn(_avgpool3(x), w, f"{name}/branch_pool")
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(x, w, name):
    b3 = _conv_bn(x, w, f"{name}/branch3x3", stride=2)
    bd = _conv_bn(x, w, f"{name}/branch3x3dbl_1")
    bd = _conv_bn(bd, w, f"{name}/branch3x3dbl_2", padding=1)
    bd = _conv_bn(bd, w, f"{name}/branch3x3dbl_3", stride=2)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _inception_c(x, w, name):
    b1 = _conv_bn(x, w, f"{name}/branch1x1")
    b7 = _conv_bn(x, w, f"{name}/branch7x7_1")
    b7 = _conv_bn(b7, w, f"{name}/branch7x7_2", padding=(0, 3))
    b7 = _conv_bn(b7, w, f"{name}/branch7x7_3", padding=(3, 0))
    bd = _conv_bn(x, w, f"{name}/branch7x7dbl_1")
    bd = _conv_bn(bd, w, f"{name}/branch7x7dbl_2", padding=(3, 0))
    bd = _conv_bn(bd, w, f"{name}/branch7x7dbl_3", padding=(0, 3))
    bd = _conv_bn(bd, w, f"{name}/branch7x7dbl_4", padding=(3, 0))
    bd = _conv_bn(bd, w, f"{name}/branch7x7dbl_5", padding=(0, 3))
    bp = _conv_bn(_avgpool3(x), w, f"{name}/branch_pool")
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(x, w, name):
    b3 = _conv_bn(x, w, f"{name}/branch3x3_1")
    b3 = _conv_bn(b3, w, f"{name}/branch3x3_2", stride=2)
    b7 = _conv_bn(x, w, f"{name}/branch7x7x3_1")
    b7 = _conv_bn(b7, w, f"{name}/branch7x7x3_2", padding=(0, 3))
    b7 = _conv_bn(b7, w, f"{name}/branch7x7x3_3", padding=(3, 0))
    b7 = _conv_bn(b7, w, f"{name}/branch7x7x3_4", stride=2)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _inception_e(x, w, name):
    b1 = _conv_bn(x, w, f"{name}/branch1x1")
    b3 = _conv_bn(x, w, f"{name}/branch3x3_1")
    b3 = torch.cat([
        _conv_bn(b3, w, f"{name}/branch3x3_2a", padding=(0, 1)),
        _conv_bn(b3, w, f"{name}/branch3x3_2b", padding=(1, 0))], dim=1)
    bd = _conv_bn(x, w, f"{name}/branch3x3dbl_1")
    bd = _conv_bn(bd, w, f"{name}/branch3x3dbl_2", padding=1)
    bd = torch.cat([
        _conv_bn(bd, w, f"{name}/branch3x3dbl_3a", padding=(0, 1)),
        _conv_bn(bd, w, f"{name}/branch3x3dbl_3b", padding=(1, 0))], dim=1)
    bp = _conv_bn(_avgpool3(x), w, f"{name}/branch_pool")
    return torch.cat([b1, b3, bd, bp], dim=1)


def inception_features(x: torch.Tensor, w: Weights) -> torch.Tensor:
    """(B, 3, 299, 299) whitened input → (B, 2048) pool3 features, on the
    device of ``x`` and ``w``."""
    x = _conv_bn(x, w, "Conv2d_1a_3x3", stride=2)
    x = _conv_bn(x, w, "Conv2d_2a_3x3")
    x = _conv_bn(x, w, "Conv2d_2b_3x3", padding=1)
    x = _maxpool(x)
    x = _conv_bn(x, w, "Conv2d_3b_1x1")
    x = _conv_bn(x, w, "Conv2d_4a_3x3")
    x = _maxpool(x)
    x = _inception_a(x, w, "Mixed_5b")
    x = _inception_a(x, w, "Mixed_5c")
    x = _inception_a(x, w, "Mixed_5d")
    x = _inception_b(x, w, "Mixed_6a")
    for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(x, w, n)
    x = _inception_d(x, w, "Mixed_7a")
    x = _inception_e(x, w, "Mixed_7b")
    x = _inception_e(x, w, "Mixed_7c")
    return x.mean(dim=(2, 3))


def _conv_specs():
    """(name, out_ch, in_ch, kh, kw) of every conv + BN block of the graph,
    torchvision inception_v3's channel plan."""
    specs = [("Conv2d_1a_3x3", 32, 3, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
             ("Conv2d_2b_3x3", 64, 32, 3, 3), ("Conv2d_3b_1x1", 80, 64, 1, 1),
             ("Conv2d_4a_3x3", 192, 80, 3, 3)]

    def block_a(n, cin, pf):
        return [(f"{n}/branch1x1", 64, cin, 1, 1),
                (f"{n}/branch5x5_1", 48, cin, 1, 1),
                (f"{n}/branch5x5_2", 64, 48, 5, 5),
                (f"{n}/branch3x3dbl_1", 64, cin, 1, 1),
                (f"{n}/branch3x3dbl_2", 96, 64, 3, 3),
                (f"{n}/branch3x3dbl_3", 96, 96, 3, 3),
                (f"{n}/branch_pool", pf, cin, 1, 1)]

    def block_c(n, c7):
        return [(f"{n}/branch1x1", 192, 768, 1, 1),
                (f"{n}/branch7x7_1", c7, 768, 1, 1),
                (f"{n}/branch7x7_2", c7, c7, 1, 7),
                (f"{n}/branch7x7_3", 192, c7, 7, 1),
                (f"{n}/branch7x7dbl_1", c7, 768, 1, 1),
                (f"{n}/branch7x7dbl_2", c7, c7, 7, 1),
                (f"{n}/branch7x7dbl_3", c7, c7, 1, 7),
                (f"{n}/branch7x7dbl_4", c7, c7, 7, 1),
                (f"{n}/branch7x7dbl_5", 192, c7, 1, 7),
                (f"{n}/branch_pool", 192, 768, 1, 1)]

    def block_e(n, cin):
        return [(f"{n}/branch1x1", 320, cin, 1, 1),
                (f"{n}/branch3x3_1", 384, cin, 1, 1),
                (f"{n}/branch3x3_2a", 384, 384, 1, 3),
                (f"{n}/branch3x3_2b", 384, 384, 3, 1),
                (f"{n}/branch3x3dbl_1", 448, cin, 1, 1),
                (f"{n}/branch3x3dbl_2", 384, 448, 3, 3),
                (f"{n}/branch3x3dbl_3a", 384, 384, 1, 3),
                (f"{n}/branch3x3dbl_3b", 384, 384, 3, 1),
                (f"{n}/branch_pool", 192, cin, 1, 1)]

    specs += block_a("Mixed_5b", 192, 32)
    specs += block_a("Mixed_5c", 256, 64)
    specs += block_a("Mixed_5d", 288, 64)
    specs += [("Mixed_6a/branch3x3", 384, 288, 3, 3),
              ("Mixed_6a/branch3x3dbl_1", 64, 288, 1, 1),
              ("Mixed_6a/branch3x3dbl_2", 96, 64, 3, 3),
              ("Mixed_6a/branch3x3dbl_3", 96, 96, 3, 3)]
    for n, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                  ("Mixed_6e", 192)):
        specs += block_c(n, c7)
    specs += [("Mixed_7a/branch3x3_1", 192, 768, 1, 1),
              ("Mixed_7a/branch3x3_2", 320, 192, 3, 3),
              ("Mixed_7a/branch7x7x3_1", 192, 768, 1, 1),
              ("Mixed_7a/branch7x7x3_2", 192, 192, 1, 7),
              ("Mixed_7a/branch7x7x3_3", 192, 192, 7, 1),
              ("Mixed_7a/branch7x7x3_4", 192, 192, 3, 3)]
    specs += block_e("Mixed_7b", 1280)
    specs += block_e("Mixed_7c", 2048)
    return specs


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """The architecture-complete He-init weight set of ``seed``: normal
    filters of std sqrt(2 / fan_in), identity BatchNorm."""
    rng = np.random.RandomState(seed)
    w = {}
    for name, co, ci, kh, kw in _conv_specs():
        std = np.sqrt(2.0 / (ci * kh * kw))
        w[f"{name}/conv/weight"] = rng.normal(
            0, std, (co, ci, kh, kw)).astype(np.float32)
        w[f"{name}/bn/weight"] = np.ones(co, np.float32)
        w[f"{name}/bn/bias"] = np.zeros(co, np.float32)
        w[f"{name}/bn/running_mean"] = np.zeros(co, np.float32)
        w[f"{name}/bn/running_var"] = np.ones(co, np.float32)
    return w


def is_random(weights_npz: str) -> bool:
    return weights_npz == "random" or weights_npz.startswith("random:")


def load_weights(weights_npz: str, device=DEFAULT_DEVICE) -> Weights:
    """The graph's weights from an npz, or the seeded set of
    ``"random"`` / ``"random:<seed>"``, on ``device``; the auxiliary
    classifier and the final fc are dropped."""
    if is_random(weights_npz):
        seed = int(weights_npz.split(":", 1)[1]) if ":" in weights_npz else 0
        raw = random_weights(seed).items()
    else:
        raw = np.load(weights_npz).items()
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
            for k, v in raw
            if "AuxLogits" not in k and k not in ("fc/weight", "fc/bias")}


def make_extractor(weights_npz: str, batch_size: int = 64,
                   device=DEFAULT_DEVICE
                   ) -> Callable[[Union[np.ndarray, torch.Tensor]],
                                 np.ndarray]:
    """Feature extractor over (B, 3, 299, 299) images in [0, 255] (resized
    by the caller), a tensor or an array, run on ``device`` in batches of
    ``batch_size``: whitened as x / 127.5 - 1, (B, 2048) float32 features
    returned to the host."""
    weights = load_weights(weights_npz, device)

    @torch.no_grad()
    def extract(imgs) -> np.ndarray:
        outs = []
        for i in range(0, len(imgs), batch_size):
            x = torch.as_tensor(imgs[i:i + batch_size]).to(
                device=device, dtype=torch.float32)
            outs.append(inception_features(x / 127.5 - 1.0, weights)
                        .cpu().numpy())
        return np.concatenate(outs)

    return extract
