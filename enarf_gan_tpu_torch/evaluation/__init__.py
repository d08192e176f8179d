"""The GAN's evaluation scripts on the port (the counterparts of the
repository's ``evaluation/``): ``compute_fid`` (FID against the real
images), ``compute_PCK`` (PCK of the posed renders) and ``compute_depth``
(disparity MSE against SURREAL's depth), each run as ``python -m
enarf_gan_tpu_torch.evaluation.<script>`` on a snapshot of
``enarf_gan_tpu_torch.train_ENARF_GAN``."""
