"""Serving stack of the PyTorch port (``apex_tpu.serve``): the slot KV
cache, decode attention, the engine, the continuous-batching scheduler
and the serve CLI."""
