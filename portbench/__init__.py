"""The benchmark of f2nerf_tpu_torch (see harness.py)."""
