"""A pytest plugin: the port's kernel-witness gate for an armed run.

``tests/conftest.py`` gates the reference's witness; this plugin does the
same for the port's (``repro_torch.kernels.contracts.WITNESS``). Load it
by name, with ``tests`` on the path:

    REPRO_KERNEL_WITNESS=1 PYTHONPATH=src:tests python -m pytest \\
        -p torch_witness_gate tests/test_torch_*.py

After the last test of an armed session (of each worker, under xdist) it
writes the port's report (``REPRO_TORCH_KERNEL_WITNESS_REPORT``, default
``kernel_contract_report_torch.json``; a worker's name is appended) and
fails the run on any problem that some call went through with
(``KernelWitness.unrefused``). The argument-check tests' deliberate
violations, each refused by the wrapper's own checks, are reported and
pass. Without the flag it does nothing.
"""

import json
import os

import pytest

from repro_torch.kernels import contracts


@pytest.fixture(scope="session", autouse=True)
def _torch_kernel_witness_gate():
    yield
    if not contracts.witness_enabled():
        return
    report = contracts.WITNESS.report()
    out = os.environ.get("REPRO_TORCH_KERNEL_WITNESS_REPORT",
                         "kernel_contract_report_torch.json")
    worker = os.environ.get("PYTEST_XDIST_WORKER")
    if worker:
        root, ext = os.path.splitext(out)
        out = f"{root}.{worker}{ext}"
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    through = contracts.WITNESS.unrefused()
    if through:
        raise contracts.KernelContractViolation(
            f"armed kernel calls went through with contract problems "
            f"({len(through)}; report: {out}):\n"
            + json.dumps(through, indent=2))
