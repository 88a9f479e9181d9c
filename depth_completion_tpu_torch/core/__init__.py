"""core (PyTorch port)."""
