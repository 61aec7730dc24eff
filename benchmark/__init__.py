"""The benchmark of ngsamg_tpu_torch (see README.md)."""
