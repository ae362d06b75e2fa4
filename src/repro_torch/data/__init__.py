from repro_torch.data.pipeline import (LoaderState, ShardedLoader,
                                       SyntheticLMDataset, make_batch_fn)

__all__ = ["LoaderState", "ShardedLoader", "SyntheticLMDataset",
           "make_batch_fn"]
