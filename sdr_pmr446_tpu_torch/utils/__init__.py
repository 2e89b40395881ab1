"""utils of the PyTorch port (counterpart of sdr_pmr446_tpu.utils)."""
