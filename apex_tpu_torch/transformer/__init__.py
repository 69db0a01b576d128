"""Transformer building blocks of the PyTorch port
(``apex_tpu.transformer``)."""
