"""The port's static-analysis suite.

``python -m repro_torch.analysis`` runs every registered pass over the
include roots of the port's own settings
(``src/repro_torch/analysis/analysis.toml``) and reports structured
findings; ``--strict`` exits non-zero on any finding not in the committed
baseline (``src/repro_torch/analysis/baseline.json``, empty).

PyTorch port of ``repro.analysis``; pass families:

* :mod:`~repro_torch.analysis.passes_locks` — lock-order + blocking call
  under a lock, against :data:`repro_torch.obs.locks.LOCK_HIERARCHY`
  (whose runtime ``LockWitness`` covers the dynamic side).
* :mod:`~repro_torch.analysis.passes_api` — deprecated shims, per-k keys,
  metrics bypasses, wall-clock misuse, bare asserts.
* :mod:`~repro_torch.analysis.passes_torch` — the hot path's device reads
  and the no-fallback constraint (``silent-fallback``, ``cpu-fallback``);
  it replaces the reference's JAX tracing rules.
* :mod:`~repro_torch.analysis.passes_kernels` — the CUDA launch sites
  (``launch-contract``, ``launch-rc``), int32 narrowing and the device
  layout, on the :mod:`~repro_torch.analysis.shapeflow` interpreter
  (runtime counterpart: :mod:`repro_torch.kernels.contracts`, armed by
  ``REPRO_KERNEL_WITNESS=1``).

Adding a pass: write ``(module, config) -> Iterable[Finding]``, register
it in :data:`PASSES` under its rule-family name, and add a violations
fixture and a clean twin under ``tests/fixtures/analysis_torch/``.
"""

from .core import (AnalysisConfig, Baseline, Finding, Module,
                   run_analysis)
from .passes_api import pass_api_discipline
from .passes_kernels import pass_kernel_contracts
from .passes_locks import pass_lock_discipline
from .passes_torch import pass_torch_discipline

#: name -> pass callable; config ``passes = [...]`` selects a subset.
PASSES = {
    "locks": pass_lock_discipline,
    "api": pass_api_discipline,
    "torch": pass_torch_discipline,
    "kernels": pass_kernel_contracts,
}

__all__ = [
    "AnalysisConfig", "Baseline", "Finding", "Module", "PASSES",
    "run_analysis", "pass_lock_discipline", "pass_api_discipline",
    "pass_torch_discipline", "pass_kernel_contracts",
]
