"""Examples of the port (counterparts of ``bigdl_tpu.example``)."""
