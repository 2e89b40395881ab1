"""tools of the PyTorch port (counterpart of the repository's tools/)."""
