"""Contributed ops of the PyTorch port (``apex_tpu.contrib``)."""
