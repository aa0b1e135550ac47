"""Static verification of a plan (PyTorch port of the parts of
``flexflow_tpu/verify/`` the strategy search uses): structured
:class:`~flexflow_tpu_torch.verify.findings.Finding` records and their
exemption policy, the plan checker (:mod:`.plan`: a (model, strategy,
machine) triple's legality) and the per-device HBM prediction
(:mod:`.memory`).  The JAX package's compiled-program passes (sync,
donation, predicted) lint XLA programs and have no counterpart here."""

from flexflow_tpu_torch.verify.findings import (Finding, apply_exemptions,
                                                load_exemptions)

__all__ = ["Finding", "apply_exemptions", "load_exemptions"]
