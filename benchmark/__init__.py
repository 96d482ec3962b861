"""The benchmark of biscuit_tpu_torch (see README.md)."""
