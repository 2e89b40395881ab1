"""Time-sharded (stream x time) chains on a one-card mesh (PyTorch).

Counterpart of sdr_pmr446_tpu/parallel/: ``halo`` (the collectives),
``fused_halo`` (the exact-state pre-pass and its corrections),
``scanner_sharded``, ``dsd_sharded`` and ``single_sharded``.
"""
