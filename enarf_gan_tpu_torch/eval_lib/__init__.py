"""Port of enarf_gan_tpu/eval_lib (see the package docstring)."""
