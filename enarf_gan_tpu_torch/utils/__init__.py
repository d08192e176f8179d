"""Port of enarf_gan_tpu/utils (see the package docstring)."""
