"""Port of enarf_gan_tpu/mesh (see the package docstring)."""
