from repro_torch.data.pipeline import DataPipeline, rank_batch, synthetic_batch

__all__ = ["DataPipeline", "rank_batch", "synthetic_batch"]
