"""The benchmark of ``depth_completion_tpu_torch`` (see README.md)."""
