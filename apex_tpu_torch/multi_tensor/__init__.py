"""Multi-tensor primitives of the PyTorch port (``apex_tpu.multi_tensor``)."""
