"""Kernel contracts, the device-layout table, and the runtime shape witness.

PyTorch port of ``repro.kernels.contracts``. The port's CUDA wrappers hand
raw device pointers to their kernels through ``ctypes``: a wrong rank,
dtype or extent there reads out of bounds on the card instead of failing
in a tracer. The static ``kernels`` pass (``repro_torch.analysis``) checks
the launch sites from the AST; this module is its runtime counterpart,
mirroring the lock-witness split of :mod:`repro_torch.obs.locks`:
declarations live next to the code they constrain, production pays one
environment read per call (a dict membership test, in a pass-through
with the wrapper's own parameters), and an armed run records every
call.

* :data:`LAYOUT_CONTRACTS` — the declared dtype+rank of every array in
  the :class:`~repro_torch.core.batch_query.DeviceIndex` layout (equal to
  the reference's table; ``batch_query._ARRAY_FIELDS`` is derived from
  it). :func:`check_layout` validates the host arrays on every upload
  while the witness is armed.
* :func:`kernel_contract` — decorator for the launch wrappers of this
  package. It always registers the declaration in :data:`CONTRACTS` (so
  coverage is assertable without arming anything) and attaches it as
  ``__kernel_contract__``; per call it is a pass-through unless
  ``REPRO_KERNEL_WITNESS=1``, read at *call* time.
* :class:`KernelWitness` — records every armed call, validates tensor
  rank/dtype/symbolic-dim bindings against the contract *before* the
  wrapper runs, checks the wrapper's declared dynamic shared memory per
  block (``smem_bound``, from the wrapper's own launch plan) against the
  H100's :data:`SMEM_PER_BLOCK`, and deduplicates violations into a
  JSON-able report. Each violation counts the calls that showed it and,
  of those, the calls the wrapper then refused (raised): a violation
  whose every call was refused was caught by the wrapper's own checks;
  one that went through (:meth:`KernelWitness.unrefused`) reached a
  kernel or a plain version.

This file is the one home of the card's shared-memory sizes. It imports
the standard library only: the analysis pass imports it for
:data:`LAYOUT_CONTRACTS`, and dtypes are read by name
(``str(t.dtype)`` without its ``torch.`` prefix), so a lint run never
loads torch.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import threading
from typing import Callable, Mapping, Sequence

_ENV_FLAG = "REPRO_KERNEL_WITNESS"

#: dynamic shared memory one block may use on an H100 (227 KB, after
#: opting in with cudaFuncAttributeMaxDynamicSharedMemorySize)
SMEM_PER_BLOCK = 232_448
#: shared memory an SM gives its blocks (228 KB; 1 KB of each block's is
#: reserved by the runtime)
SMEM_PER_SM = 233_472

#: dtype families for contract specs, by torch's names (``torch.int32``
#: -> ``"int32"``); each a subset of the reference's family of that name.
#: ANY_INT: the integer operands a wrapper casts to its kernel's int32
ANY_INT = ("int32", "int64", "int16", "int8", "uint8")
ANY_FLOAT = ("float32", "bfloat16", "float16", "float64")
INT_OR_BOOL = ANY_INT + ("bool",)
INT32 = ("int32",)
F32 = ("float32",)
BF16 = ("bfloat16",)


#: values of the flag that leave the witness disarmed
_OFF = ("", "0", "false", "no")


def witness_enabled() -> bool:
    """True when the process-wide kernel witness is armed (checked per
    call, so a long-lived process can arm without re-importing)."""
    return os.environ.get(_ENV_FLAG, "") not in _OFF


def _flag_store():
    """The mapping the flag is read from, and its key there, at call time.
    CPython keeps ``os.environ`` in a dict of encoded keys (``_data``,
    which ``os.environ``'s setters and deleters update); a membership test
    there takes tens of ns, where ``os.environ.get`` of an unset name
    raises and catches a ``KeyError`` inside (1.6-3.0 us a call on the
    host of an H100 80GB HBM3 at 700 W, chip_smoke.py's ``[contracts]``).
    Elsewhere: ``os.environ`` itself."""
    data = getattr(os.environ, "_data", None)
    encode = getattr(os.environ, "encodekey", None)
    if isinstance(data, dict) and callable(encode):
        return data, encode(_ENV_FLAG)
    return os.environ, _ENV_FLAG


_ENV, _FLAG_KEY = _flag_store()


class KernelContractViolation(Exception):
    """Raised by a gate (a test session, ``chip_smoke.py``'s
    ``[contracts]``) when an armed run recorded contract problems."""


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Declared shape+dtype of one kernel operand or output.

    ``dims`` entries are either exact ints or symbol strings bound at
    validation time — first from same-named scalar int arguments, then
    from the first dim they appear at; every later occurrence must agree,
    which is how cross-operand constraints (label/link/active rows all
    (B, N)) are expressed. ``dtypes`` is the set of accepted dtype names
    (torch's, without the ``torch.`` prefix)."""

    dims: tuple
    dtypes: tuple[str, ...]

    def describe(self) -> str:
        return (f"({', '.join(str(d) for d in self.dims)})"
                f":{'|'.join(self.dtypes)}")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """The declared interface of one launch wrapper."""

    name: str
    in_specs: tuple[tuple[str, ArraySpec], ...]   # (param name, spec)
    out_specs: tuple[ArraySpec, ...]
    #: bound-arguments dict -> dynamic shared memory of one block of the
    #: wrapper's launch, in bytes; None where the wrapper does not know it
    smem_bound: Callable[[dict], int | None] | None = None
    #: param name -> how to read its tensor from an operand that is not
    #: one (a segment plan's ids)
    views: tuple[tuple[str, Callable], ...] = ()


#: every decorated wrapper's declaration, keyed by name — lets tests assert
#: that each launch wrapper carries a contract without arming the witness.
CONTRACTS: dict[str, KernelContract] = {}


#: The device-layout table: dtype + rank of every array entering
#: ``to_device`` / ``refresh_device`` (the host layout of
#: ``batch_query._host_layout``). The static layout-contract rule checks
#: construction sites against this both ways; the armed witness checks
#: the real arrays on upload.
LAYOUT_CONTRACTS: dict[str, tuple[str, int]] = {
    "node_u": ("int32", 1),
    "node_v": ("int32", 1),
    "node_ct": ("int32", 1),
    "live_from": ("int32", 1),
    "live_to": ("int32", 1),
    "row_ptr": ("int32", 1),
    "ent_ts": ("int32", 1),
    "ent_left": ("int32", 1),
    "ent_right": ("int32", 1),
    "ent_parent": ("int32", 1),
    "vrow_ptr": ("int32", 1),
    "vent_ts": ("int32", 1),
    "vent_node": ("int32", 1),
    "ver_ts_from": ("int32", 1),
    "ver_ts_to": ("int32", 1),
    "ver_ct": ("int32", 1),
    "ver_src": ("int32", 1),
    "ver_k": ("int32", 1),
}


# ---------------------------------------------------------------------------
# the witness
# ---------------------------------------------------------------------------

def _dtype_name(value) -> str:
    """``"int32"`` for a tensor or array of int32 (torch's prefix
    dropped), else the type's name."""
    dt = getattr(value, "dtype", None)
    if dt is None:
        return type(value).__name__
    return str(dt).removeprefix("torch.")


class KernelWitness:
    """Validates armed kernel calls against their contracts and records a
    process-wide report.

    Thread-safe (the serving plane launches from several threads);
    violations are deduplicated by (kind, kernel, message) so a hot loop
    cannot grow the report without bound."""

    def __init__(self, smem_limit: int = SMEM_PER_BLOCK):
        self.smem_limit = smem_limit
        self._mu = threading.Lock()
        # kernel name -> {"calls": int, "max_smem": int}
        self._kernels: dict[str, dict] = {}
        # (kind, kernel, message) -> {"count": int, ...}
        self._violations: dict[tuple[str, str, str], dict] = {}
        self.calls = 0

    # -- recording --------------------------------------------------------
    def on_call(self, kernel: str, smem_bytes: int | None) -> None:
        with self._mu:
            self.calls += 1
            entry = self._kernels.setdefault(
                kernel, {"calls": 0, "max_smem": None})
            entry["calls"] += 1
            if smem_bytes is not None:
                entry["max_smem"] = max(entry["max_smem"] or 0,
                                        int(smem_bytes))

    def note(self, kind: str, kernel: str, message: str) -> tuple:
        """Record one violation; returns its key."""
        key = (kind, kernel, message)
        with self._mu:
            v = self._violations.setdefault(
                key, {"kind": kind, "kernel": kernel, "message": message,
                      "count": 0, "refused": 0})
            v["count"] += 1
        return key

    def refused(self, keys) -> None:
        """The call that showed the violations ``keys`` raised in the
        wrapper (its own checks refused it)."""
        with self._mu:
            for key in set(keys):
                self._violations[key]["refused"] += 1

    # -- validation -------------------------------------------------------
    def validate_arrays(self, kernel: str,
                        named: Sequence[tuple[str, object, ArraySpec]],
                        symbols: dict[str, int]) -> list[tuple]:
        """Check (label, tensor, spec) triples, binding/checking symbolic
        dims through the shared ``symbols`` map; returns the keys of the
        violations noted."""
        keys = []
        for label, arr, spec in named:
            shape = getattr(arr, "shape", None)
            if shape is None:
                keys.append(self.note(
                    "shape-contract", kernel, f"{label}: expected a tensor "
                    f"with .shape, got {type(arr).__name__}"))
                continue
            if len(shape) != len(spec.dims):
                keys.append(self.note(
                    "shape-contract", kernel, f"{label}: rank {len(shape)} "
                    f"!= declared rank {len(spec.dims)} {spec.describe()}"))
                continue
            for dim, actual in zip(spec.dims, shape):
                actual = int(actual)
                if isinstance(dim, int):
                    if actual != dim:
                        keys.append(self.note(
                            "shape-contract", kernel, f"{label}: dim "
                            f"{actual} != declared {dim} in "
                            f"{spec.describe()}"))
                elif dim in symbols:
                    if actual != symbols[dim]:
                        keys.append(self.note(
                            "shape-contract", kernel, f"{label}: dim "
                            f"{dim}={actual} conflicts with {dim}="
                            f"{symbols[dim]} bound earlier"))
                else:
                    symbols[dim] = actual
            dt = _dtype_name(arr)
            if dt not in spec.dtypes:
                keys.append(self.note(
                    "dtype-contract", kernel, f"{label}: dtype {dt} not in "
                    f"declared {{{'|'.join(spec.dtypes)}}}"))
        return keys

    def validate_smem(self, kernel: str, smem_bytes: int) -> list[tuple]:
        if smem_bytes > self.smem_limit:
            return [self.note(
                "smem-bound", kernel, f"declared dynamic shared memory "
                f"{smem_bytes} B per block exceeds the card's "
                f"{self.smem_limit} B")]
        return []

    # -- reading ----------------------------------------------------------
    def problems(self) -> list[dict]:
        with self._mu:
            return [dict(v) for v in self._violations.values()]

    def unrefused(self) -> list[dict]:
        """The problems some call of which the wrapper did not refuse: it
        went on to a kernel or a plain version."""
        return [p for p in self.problems() if p["count"] > p["refused"]]

    def report(self) -> dict:
        """JSON-able summary."""
        with self._mu:
            kernels = {k: dict(v) for k, v in sorted(self._kernels.items())}
        return {
            "smem_limit": self.smem_limit,
            "calls": self.calls,
            "contracts": sorted(CONTRACTS),
            "kernels": kernels,
            "problems": self.problems(),
        }

    def reset(self) -> None:
        with self._mu:
            self._kernels.clear()
            self._violations.clear()
            self.calls = 0


#: Process-wide witness the armed wrappers report into.
WITNESS = KernelWitness()


# ---------------------------------------------------------------------------
# the decorator
# ---------------------------------------------------------------------------

def _validate_call(contract: KernelContract, signature: inspect.Signature,
                   witness: KernelWitness, fn: Callable, args: tuple,
                   kwargs: dict):
    try:
        bound = signature.bind(*args, **kwargs)
    except TypeError:
        # a mis-called wrapper fails in fn itself with the real traceback
        return fn(*args, **kwargs)
    bound.apply_defaults()
    values = dict(bound.arguments)
    views = dict(contract.views)

    # symbols seed: scalar int args whose names appear in the specs
    symbols: dict[str, int] = {}
    spec_syms = {d for _, s in contract.in_specs for d in s.dims
                 if isinstance(d, str)}
    spec_syms |= {d for s in contract.out_specs for d in s.dims
                  if isinstance(d, str)}
    for name, val in values.items():
        if (name in spec_syms and isinstance(val, int)
                and not isinstance(val, bool)):
            symbols[name] = val

    operands = []
    for name, spec in contract.in_specs:
        val = values.get(name)
        if val is None:
            continue
        if name in views:
            val = views[name](val)
        operands.append((name, val, spec))
    keys = witness.validate_arrays(contract.name, operands, symbols)

    smem = None
    if contract.smem_bound is not None:
        try:
            smem = contract.smem_bound(values)
        except Exception as e:  # a broken bound is itself a finding
            keys.append(witness.note(
                "smem-bound", contract.name,
                f"smem_bound raised {type(e).__name__}: {e}"))
        else:
            if smem is not None:
                smem = int(smem)
                keys += witness.validate_smem(contract.name, smem)
    witness.on_call(contract.name, smem)

    try:
        out = fn(*args, **kwargs)
    except BaseException:
        witness.refused(keys)
        raise
    if contract.out_specs:
        outs = out if isinstance(out, tuple) else (out,)
        witness.validate_arrays(
            contract.name,
            [(f"out[{i}]", o, spec)
             for i, (o, spec) in enumerate(zip(outs, contract.out_specs))],
            symbols)
    return out


def kernel_contract(*, in_specs: Mapping[str, ArraySpec],
                    out_specs: Sequence[ArraySpec] | ArraySpec = (),
                    smem_bound: Callable[[dict], int | None] | None = None,
                    views: Mapping[str, Callable] | None = None):
    """Declare a launch wrapper's interface and arm it for the witness.

    Always registers the contract (coverage is checkable unarmed); the
    per-call validation path only runs under ``REPRO_KERNEL_WITNESS=1``,
    and validates the operands before the wrapper runs, so a call the
    wrapper's own checks refuse is recorded too.
    """
    if isinstance(out_specs, ArraySpec):
        out_specs = (out_specs,)

    def deco(fn: Callable) -> Callable:
        contract = KernelContract(
            name=fn.__name__,
            in_specs=tuple(in_specs.items()),
            out_specs=tuple(out_specs),
            smem_bound=smem_bound,
            views=tuple((views or {}).items()))
        CONTRACTS[fn.__name__] = contract
        signature = inspect.signature(fn)

        def armed(args, kwargs):
            return _validate_call(contract, signature, WITNESS, fn, args,
                                  kwargs)

        wrapper = functools.update_wrapper(_pass_through(fn, armed), fn)
        wrapper.__kernel_contract__ = contract
        return wrapper

    return deco


def _pass_through(fn: Callable, armed: Callable) -> Callable:
    """A function with ``fn``'s own parameters and defaults that, while the
    witness is disarmed (one membership test in the environment's dict),
    calls ``fn`` with them, and else returns ``armed(args, kwargs)``.
    Spelling the parameters out spares the disarmed call the packing and
    unpacking of ``*args, **kwargs``, which took most of a generic
    wrapper's time. ``fn`` takes named parameters only."""
    names, keywords, params, scope = [], [], [], {}
    for p in inspect.signature(fn).parameters.values():
        if p.kind not in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
            raise TypeError(f"kernel_contract: {fn.__name__} takes "
                            f"{p.kind.description} parameter {p.name}")
        if p.kind is p.KEYWORD_ONLY and not keywords:
            params.append("*")
        (keywords if p.kind is p.KEYWORD_ONLY else names).append(p.name)
        if p.default is p.empty:
            params.append(p.name)
        else:
            scope[f"_default_{p.name}"] = p.default
            params.append(f"{p.name}=_default_{p.name}")
    call = ", ".join(names + [f"{k}={k}" for k in keywords])
    packed = (f"({''.join(n + ', ' for n in names)}), "
              f"{{{', '.join(f'{k!r}: {k}' for k in keywords)}}}")
    source = (f"def {fn.__name__}({', '.join(params)}):\n"
              f"    if _key not in _env or not _enabled():\n"
              f"        return _fn({call})\n"
              f"    return _armed({packed})\n")
    scope.update(_key=_FLAG_KEY, _env=_ENV, _enabled=witness_enabled,
                 _fn=fn, _armed=armed)
    exec(source, scope)
    return scope[fn.__name__]


# ---------------------------------------------------------------------------
# device-layout validation
# ---------------------------------------------------------------------------

def check_layout(arrays: Mapping[str, object],
                 witness: KernelWitness | None = None) -> list[str]:
    """Cross-check a host layout dict against :data:`LAYOUT_CONTRACTS`
    both ways (undeclared / missing keys, dtype, rank). Returns the
    problem strings; when a witness is given they are also recorded as
    ``layout-contract`` violations. ``to_device`` and ``refresh_device``
    call this on every upload while the witness is armed."""
    problems: list[str] = []
    for name in arrays:
        if name not in LAYOUT_CONTRACTS:
            problems.append(f"{name}: not declared in LAYOUT_CONTRACTS")
    for name, (dtype, rank) in LAYOUT_CONTRACTS.items():
        if name not in arrays:
            problems.append(f"{name}: declared but absent from the layout")
            continue
        arr = arrays[name]
        if _dtype_name(arr) != dtype:
            problems.append(
                f"{name}: dtype {_dtype_name(arr)} != declared {dtype}")
        ndim = len(getattr(arr, "shape", ()))
        if ndim != rank:
            problems.append(f"{name}: rank {ndim} != declared {rank}")
    if witness is not None:
        for p in problems:
            witness.note("layout-contract", "to_device", p)
    return problems
