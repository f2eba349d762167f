"""
The port's analysis package: the launch contracts of the search plans
and the peak-memory model (:mod:`.launch_contract`, the semantic pass
behind ``python -m riptide_tpu_torch.apps.rprove``), the schedule
exploration model checker of the port's protocols (:mod:`.sched`,
behind ``python -m riptide_tpu_torch.apps.ripsched``) and their SARIF
writer (:mod:`.sarif`). Importable without a card: the contracts come
from the shape-only walk on the ``meta`` device, and the model checker
loads its targets without torch's CUDA.
"""
from .launch_contract import (HBM_PROBES, PROBE_D, RULES, HBMModel,
                              build_contract_plan, check_contracts,
                              extract_contract, hbm_model, load_contracts,
                              reuse_report)
from .sched import MODELS, explore_model, replay

__all__ = ["HBM_PROBES", "PROBE_D", "RULES", "HBMModel",
           "build_contract_plan", "check_contracts", "extract_contract",
           "hbm_model", "load_contracts", "reuse_report", "MODELS",
           "explore_model", "replay"]
