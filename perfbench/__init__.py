"""The benchmark of mmlspark_tpu_torch on NVIDIA GPUs (see README.md)."""
