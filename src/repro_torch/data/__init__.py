from repro_torch.data.pipeline import DataPipeline, synthetic_batch

__all__ = ["DataPipeline", "synthetic_batch"]
