from repro_torch.data.pipeline import (SyntheticLMDataset, make_batch_fn,
                                       pack_documents)

__all__ = ["SyntheticLMDataset", "make_batch_fn", "pack_documents"]
