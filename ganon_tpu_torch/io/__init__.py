from ganon_tpu_torch.io.sequence import SequenceReader, read_batches

__all__ = ["SequenceReader", "read_batches"]
