"""The port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: Path):
    """Absolute module names imported anywhere in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_has_files():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


#: the training path's modules (slice 13): each a file of the port, each
#: importable without JAX or the reference package
TRAIN_MODULES = ("repro_torch.optim.adamw", "repro_torch.data.lm_data",
                 "repro_torch.data.recsys_data", "repro_torch.models.recsys",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.launch.train")


#: the runtime and launch modules (slice 19)
RUNTIME_MODULES = ("repro_torch.launch.mesh", "repro_torch.launch.roofline",
                   "repro_torch.launch.dryrun", "repro_torch.launch.report",
                   "repro_torch.runtime.sharding",
                   "repro_torch.runtime.moe_a2a",
                   "repro_torch.runtime.elastic",
                   "repro_torch.optim.compression")


#: the tooling (slice 20): the static-analysis suite and the contracts
TOOLING_MODULES = ("repro_torch.analysis", "repro_torch.analysis.__main__",
                   "repro_torch.analysis.core",
                   "repro_torch.analysis.passes_locks",
                   "repro_torch.analysis.passes_api",
                   "repro_torch.analysis.passes_torch",
                   "repro_torch.analysis.passes_kernels",
                   "repro_torch.analysis.shapeflow",
                   "repro_torch.kernels.contracts")


@pytest.mark.parametrize("module",
                         TRAIN_MODULES + RUNTIME_MODULES + TOOLING_MODULES)
def test_training_modules_stand_alone(module):
    """Each module is among the files checked above, and imports in a fresh
    interpreter without loading ``jax`` or ``repro``."""
    import os
    import subprocess
    import sys
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    if not path.exists():                   # a package
        path = path.with_suffix("") / "__init__.py"
    assert path in PORT_FILES
    code = (f"import sys; import {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                   timeout=120)


def test_analysis_loads_no_torch():
    """A lint run stays light: the suite and the contracts table it reads
    import the standard library only."""
    import os
    import subprocess
    import sys
    code = ("import sys; import repro_torch.analysis; "
            "import repro_torch.kernels.contracts; "
            "assert 'torch' not in sys.modules and 'numpy' not in "
            "sys.modules, sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                   timeout=120)
