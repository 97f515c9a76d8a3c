"""Long-context training example (counterpart of
``bigdl_tpu.example.longcontext``)."""
