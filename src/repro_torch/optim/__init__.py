"""Optimisers, schedules, compression and DiLoCo on PyTorch: the counterpart
of ``repro.optim``.  Every update writes into the state handed in."""
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.compression import (int8_compress, int8_decompress,
                                           topk_compress, topk_decompress)
from repro_torch.optim.diloco import (diloco_init, diloco_local_delta,
                                      diloco_outer_update)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "adamw_init", "adamw_update", "adafactor_init", "adafactor_update",
    "int8_compress", "int8_decompress", "topk_compress", "topk_decompress",
    "diloco_init", "diloco_local_delta", "diloco_outer_update",
    "warmup_cosine",
]
