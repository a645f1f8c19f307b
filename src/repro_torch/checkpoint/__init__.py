from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.serializer import deserialize_tree, serialize_tree

__all__ = ["CheckpointManager", "deserialize_tree", "serialize_tree"]
