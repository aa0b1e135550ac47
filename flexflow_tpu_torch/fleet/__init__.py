"""Many jobs on one pool of cards, with the strategy search as the
scheduler (PyTorch port of ``flexflow_tpu/fleet/``).

* :mod:`fleet.job`: :class:`JobSpec` and the lifecycle state machine
  (pending -> placing -> running -> draining -> resized -> done /
  failed) over the port's training step and
  :class:`~flexflow_tpu_torch.serve.engine.ServeEngine`, each job on a
  slice of the pool's world, moved by a slice move inside the world
  (``utils.elastic.slice_move``);
* :mod:`fleet.arbiter`: placement as search, each (job, slice size)
  priced through the native simulator (``sim.search.price_on_slice``),
  with the logged data-parallel proxy where it is unavailable;
* :mod:`fleet.coordinator`: the loop of admissions, packings, quantum
  rounds and directed resizes, with the exact device-step account.

Record kinds: ``fleet_job``, ``fleet_placement``, ``fleet_rebalance``,
``fleet_wait``, ``fleet_util``, ``fleet_summary``.  ``apps.fleet`` is the
driver (``--smoke``: the two-job mix that trades devices), and
``apps.fleetsim`` the trace-driven simulation in virtual time.
"""

from flexflow_tpu_torch.fleet.arbiter import Arbiter
from flexflow_tpu_torch.fleet.coordinator import (FleetCoordinator,
                                                  VirtualClock,
                                                  check_fleet_util)
from flexflow_tpu_torch.fleet.job import Job, JobSpec

__all__ = ["Arbiter", "FleetCoordinator", "Job", "JobSpec",
           "VirtualClock", "check_fleet_util"]
