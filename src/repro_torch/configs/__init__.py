from repro_torch.configs.base import ReplicationPolicy

__all__ = ["ReplicationPolicy"]
