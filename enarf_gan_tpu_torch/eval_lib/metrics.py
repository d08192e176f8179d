"""Image metrics in numpy: MSE, PSNR, SSIM (the port's own copy of
``enarf_gan_tpu/eval_lib/metrics.py``; LPIPS needs weights the repository
does not hold and waits).

PSNR takes images in [-1, 1]: 20 log10(2) - 10 log10(mse). SSIM follows
skimage's structural_similarity defaults as the reference calls it: [0, 1]
images, data_range 1, a uniform 7x7 window, channels averaged.
"""
from __future__ import annotations

import numpy as np


def mse(img1: np.ndarray, img2: np.ndarray) -> float:
    return float(np.mean((np.asarray(img1, np.float64)
                          - np.asarray(img2, np.float64)) ** 2))


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """Images in [-1, 1]."""
    return float(20 * np.log10(2) - 10 * np.log10(mse(img1, img2)))


def _ssim_single(im1: np.ndarray, im2: np.ndarray, data_range: float,
                 win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    from scipy.ndimage import uniform_filter
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    ux = uniform_filter(im1, win_size)
    uy = uniform_filter(im2, win_size)
    uxx = uniform_filter(im1 * im1, win_size)
    uyy = uniform_filter(im2 * im2, win_size)
    uxy = uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / \
        ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return float(S[pad:-pad, pad:-pad].mean())


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0) -> float:
    """SSIM over (C, H, W) or (H, W) images ((1, C, H, W) too); channels
    averaged. [-1, 1] images are mapped to [0, 1] when data_range is 1."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if img1.ndim == 4:
        img1, img2 = img1[0], img2[0]
    if data_range == 1.0:
        img1 = img1 * 0.5 + 0.5
        img2 = img2 * 0.5 + 0.5
    if img1.ndim == 2:
        return _ssim_single(img1, img2, data_range)
    return float(np.mean([_ssim_single(img1[c], img2[c], data_range)
                          for c in range(img1.shape[0])]))
