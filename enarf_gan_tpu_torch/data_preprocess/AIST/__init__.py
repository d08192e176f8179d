"""AIST++ → cache:
``python -m enarf_gan_tpu_torch.data_preprocess.AIST.preprocess``."""
