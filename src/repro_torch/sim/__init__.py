"""Federation simulation (mirrors ``repro/sim``): partial participation,
heterogeneous links, straggler deadlines, buffered-async aggregation and a
virtual clock charged from measured wire bytes, around any `FedEngine`
(no forked training loop).  `runner.SimRunner` is the dense entry point,
`runner.CohortRunner` the million-client one."""
from .clients import (COHORT_SAMPLERS, ClientPopulation, SAMPLERS,
                      cohort_available, cohort_uniform, floyd_sample,
                      sample_available, sample_uniform)
from .clock import CohortTiming, RoundTiming, VirtualClock
from .history import SimHistory
from .runner import CohortRunner, SimRunner
from .scheduler import (AsyncBufferScheduler, CohortPlan, RoundPlan,
                        SyncScheduler)

__all__ = [
    "AsyncBufferScheduler", "COHORT_SAMPLERS", "ClientPopulation",
    "CohortPlan", "CohortRunner", "CohortTiming", "RoundPlan", "RoundTiming",
    "SAMPLERS", "SimHistory", "SimRunner", "SyncScheduler", "VirtualClock",
    "cohort_available", "cohort_uniform", "floyd_sample", "sample_available",
    "sample_uniform",
]
