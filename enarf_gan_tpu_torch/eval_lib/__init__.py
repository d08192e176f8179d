"""Port of enarf_gan_tpu/eval_lib: image metrics (``metrics``), FID
(``fid`` over ``inception``) and LPIPS (``lpips``)."""
from enarf_gan_tpu_torch.eval_lib.metrics import psnr, ssim, mse
from enarf_gan_tpu_torch.eval_lib.fid import (
    frechet_distance,
    compute_statistics,
    FeatureExtractor,
)
