"""Models of the PyTorch port (``apex_tpu.models``)."""
