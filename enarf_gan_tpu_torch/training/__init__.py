"""Port of enarf_gan_tpu/training (see the package docstring)."""
