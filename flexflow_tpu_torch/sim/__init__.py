"""The strategy search (PyTorch port of ``flexflow_tpu/sim/``): per-op
cost models (an analytic roofline over the H100's published peaks, or
shard times measured on the card), the collectives' costs, the native
C++ simulator and its Metropolis search, and the search that writes a
strategy file the training drivers run (reference: scripts/simulator.cc
and the measure_* harness of scripts/cnn.h)."""

from flexflow_tpu_torch.sim.cost_model import (AnalyticCostModel,
                                               HopperChipPerf,
                                               MeasuredCostModel)
from flexflow_tpu_torch.sim.search import StrategySearch

__all__ = ["AnalyticCostModel", "HopperChipPerf", "MeasuredCostModel",
           "StrategySearch"]
