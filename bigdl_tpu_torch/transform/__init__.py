from bigdl_tpu_torch.transform import vision  # noqa: F401
