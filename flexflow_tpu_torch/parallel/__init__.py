"""Execution over several ranks (PyTorch port of ``flexflow_tpu/parallel/``):
the regrid planner and its hops (``regrid.py``) and the collectives they
run (``collectives.py``)."""
