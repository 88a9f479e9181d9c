"""The benchmark's plain reference of guided depth completion, in float32
PyTorch: the networks (``models``), the guided sampler (``sampler``) and
the numerics they run in (``nn``). It imports nothing of the system under
test, and takes nothing that the system made: the harness hands it the
same seed-made weights and frames, and it works out everything else again.
"""
