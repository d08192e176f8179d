"""SURREAL → the image cache and the depth cache:
``python -m enarf_gan_tpu_torch.data_preprocess.surreal.preprocess`` and
``... .preprocess_depth``."""
