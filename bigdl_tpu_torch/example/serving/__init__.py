"""The serving walkthrough (counterpart of ``bigdl_tpu.example.serving``)."""
