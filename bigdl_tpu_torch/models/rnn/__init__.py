from bigdl_tpu_torch.models.rnn.model import SimpleRNN

__all__ = ["SimpleRNN"]
