"""The benchmark's plain reference of AdaMML: plain PyTorch and NumPy,
float32 with TF32 off, written from the published description and the
configuration files under ``benchmark/configs``. It imports nothing of the
program under test (``adamml_tpu_torch``) and nothing of JAX; it is the
yardstick that decides ``correct`` and counts the work."""
