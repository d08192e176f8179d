"""ZJU-MoCap → caches:
``python -m enarf_gan_tpu_torch.data_preprocess.ZJU.preprocess``."""
