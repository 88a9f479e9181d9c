"""sched (PyTorch port)."""
