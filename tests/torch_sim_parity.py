"""Shared pieces of the strategy-search parity tests
(``tests/test_torch_sim.py``, ``tests/test_torch_search_app.py``,
``tests/test_torch_plan.py``): the same model graph, machine and cost
constants in both packages.

The port prices with the H100's published peaks by default; the tests
hand it the JAX package's ``TpuChipPerf`` constants instead
(:func:`jax_perf`, every flops rate set to its one peak), so that both
searches price the same numbers and must give the same tables,
simulated times and strategies.
"""

from __future__ import annotations

import dataclasses

CNNS = ("alexnet", "inception", "vgg16", "resnet101", "densenet")
MODELS = CNNS + ("nmt", "transformer", "gpt-1.3b")


def jax_perf():
    """The port's perf object holding the JAX package's constants."""
    from flexflow_tpu.sim.cost_model import TpuChipPerf

    from flexflow_tpu_torch.sim.cost_model import HopperChipPerf

    tp = dataclasses.asdict(TpuChipPerf())
    return HopperChipPerf(fp32_flops=tp["peak_flops"], **tp)


def machines(n: int, ici: int = None):
    """(JAX, port) virtual machines of ``n`` devices in groups of ``ici``
    (default all), on the JAX package's modeled links."""
    from flexflow_tpu.machine import MachineModel as JaxMachine
    from flexflow_tpu.machine import Topology as JaxTopology

    from flexflow_tpu_torch.machine import MachineModel, Topology

    g = ici or n
    return (JaxMachine.virtual(n, JaxTopology(devices_per_ici_group=g)),
            MachineModel.virtual(n, Topology(devices_per_ici_group=g)))


def models(name: str, jm, tm, batch: int = 64):
    """(JAX, port) graphs of ``apps.search``'s model ``name``."""
    from flexflow_tpu.apps.search import build_model as jax_build

    from flexflow_tpu_torch.apps.search import build_model

    return jax_build(name, jm, batch), build_model(name, tm, batch)


def port_analytic(model):
    """The port's default analytic model, on the JAX constants."""
    from flexflow_tpu_torch.sim.cost_model import (AnalyticCostModel,
                                                   param_byte_scale)

    return AnalyticCostModel(perf=jax_perf(),
                             param_scale=param_byte_scale(model.config),
                             dtype=model.config.compute_dtype)


def searches(jax_model, port_model, jm, tm, **kw):
    """(JAX, port) ``StrategySearch`` of the two graphs."""
    from flexflow_tpu.sim.search import StrategySearch as JaxSearch

    from flexflow_tpu_torch.sim.search import StrategySearch

    cost = kw.pop("cost_model", None)
    jax_cost = kw.pop("jax_cost_model", None)
    return (JaxSearch(jax_model, jm, cost_model=jax_cost, **kw),
            StrategySearch(port_model, tm,
                           cost_model=cost or port_analytic(port_model),
                           **kw))


def pair(name: str, n: int, ici: int = None, batch: int = 64, **kw):
    """(JAX search, port search) of model ``name`` on ``n`` devices."""
    jm, tm = machines(n, ici)
    jax_model, port_model = models(name, jm, tm, batch)
    return searches(jax_model, port_model, jm, tm, **kw)


def repo_root():
    from pathlib import Path

    return Path(__file__).resolve().parents[1]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-300)
