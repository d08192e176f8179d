"""The port's data preparation: SMPL canonical poses, the dataset caches of
ZJU-MoCap, NeuralActor, SURREAL and AIST++, and the demos' sample data
(counterparts of the top-level ``data_preprocess/`` scripts, without JAX).

Each script runs as ``python -m enarf_gan_tpu_torch.data_preprocess.<name>``
with the top-level script's arguments; those that run the SMPL forward
kinematics or the crop geometry do so on the GPU unless ``--device`` names
another device. The image stages (reading, undistorting and resizing
frames) use cv2 on the host, as the top-level scripts do.
"""
