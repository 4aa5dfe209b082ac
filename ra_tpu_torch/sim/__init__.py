"""Deterministic simulation plane (docs/INTERNALS.md §19).

One seeded run queue over virtual time replaces every concurrency
source of the threaded runtime; a ``Schedule`` fully determines
execution, failures auto-shrink to minimal standalone repros.
"""

from ra_tpu_torch.sim.clock import SIM_EPOCH_S, VirtualClock
from ra_tpu_torch.sim.schedule import Schedule, dumps, loads
from ra_tpu_torch.sim.scheduler import SimScheduler, SimTimerService
from ra_tpu_torch.sim.shrink import shrink
from ra_tpu_torch.sim.transport import SimNetwork
from ra_tpu_torch.sim.world import SimResult, SimWorld, run_schedule
from ra_tpu_torch.sim.workloads import WORKLOADS

__all__ = [
    "SIM_EPOCH_S",
    "VirtualClock",
    "Schedule",
    "dumps",
    "loads",
    "SimScheduler",
    "SimTimerService",
    "shrink",
    "SimNetwork",
    "SimResult",
    "SimWorld",
    "run_schedule",
    "WORKLOADS",
]
