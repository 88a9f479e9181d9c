"""Parallel sampling: ensembles (``parallel.ensemble``)."""
