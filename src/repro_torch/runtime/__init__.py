from repro_torch.runtime.elastic import ElasticMembership, MembershipStats
from repro_torch.runtime.failure import (ChaosEvent, ChaosPlan,
                                         FailureInjector, chaos_schedule,
                                         run_chaos)
from repro_torch.runtime.health import HealthMonitor
from repro_torch.runtime.straggler import StragglerPolicy

__all__ = ["ElasticMembership", "MembershipStats", "ChaosEvent", "ChaosPlan",
           "FailureInjector", "chaos_schedule", "run_chaos", "HealthMonitor",
           "StragglerPolicy"]
