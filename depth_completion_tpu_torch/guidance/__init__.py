"""guidance (PyTorch port)."""
