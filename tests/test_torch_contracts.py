"""Tests of the port's kernel contracts and their runtime witness
(``repro_torch.kernels.contracts``), on the CPU.

The witness validates each armed call's operands before the wrapper runs,
so these tests arm it around the wrappers' plain versions: the operands,
the symbols and the shared-memory bounds the card's kernels would get are
the same. Each test arms a witness of its own (``armed``), so deliberate
violations here never reach the process-wide one.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels.contracts as kc
from repro_torch.core import batch_query as bq
from repro_torch.core import kcore
from repro_torch.core.pecb_index import build_stratified_index
from repro_torch.core.query_api import ResultMode, TCCSQuery
from repro_torch.core.temporal_graph import gen_temporal_graph
from repro_torch.kernels import (flash_attention, kcore_peel, label_prop,
                                 segment_matmul, segmented_select)
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
CSRC = KERNELS / "csrc"

#: every launch wrapper of the port, by name, and the module it lives in
WRAPPERS = {
    "label_prop_round": label_prop, "segmented_count_le": segmented_select,
    "kth_smallest": segmented_select, "stratum_sweep": segmented_select,
    "degree_count": kcore_peel, "peel_threshold": kcore_peel,
    "kcore_fixpoint": kcore_peel, "matmul": segment_matmul,
    "wgmma_probe": segment_matmul, "segment_sum": segment_matmul,
    "segment_gather": segment_matmul, "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention, "rs_probe": flash_attention,
}

#: the reference's contract -> its counterpart in the port
COUNTERPARTS = {
    "label_prop_round": "label_prop_round",
    "segmented_count_le": "segmented_count_le",
    "kth_smallest_pallas": "kth_smallest",
    "degree_count": "degree_count",
    "peel_round": "peel_threshold",          # B3b, the threshold half
    "matmul": "matmul", "segment_sum": "segment_sum",
    "flash_attention": "flash_attention",
}


@pytest.fixture()
def armed(monkeypatch):
    """A witness of the test's own, wired into the decorators."""
    w = kc.KernelWitness()
    monkeypatch.setenv("REPRO_KERNEL_WITNESS", "1")
    monkeypatch.setattr(kc, "WITNESS", w)
    return w


def kinds(w: kc.KernelWitness) -> set:
    return {p["kind"] for p in w.problems()}


def i32(*xs):
    return torch.tensor(xs, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the witness
# ---------------------------------------------------------------------------

def test_disarmed_is_passthrough(monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_WITNESS", raising=False)
    before = kc.WITNESS.calls

    def boom(*a, **k):
        raise AssertionError("a disarmed call validated")

    monkeypatch.setattr(kc, "_validate_call", boom)
    out = segmented_select.segmented_count_le(i32(1, 2, 3, 4),
                                              i32(0, 0, 1, 1), i32(2, 3), 2)
    assert out.tolist() == [2, 1] and kc.WITNESS.calls == before


def test_the_flag_is_read_at_call_time(monkeypatch):
    """The wrapper's one read sees the process environment as it is now,
    through ``os.environ``'s setters and deleters."""
    monkeypatch.delenv("REPRO_KERNEL_WITNESS", raising=False)
    assert kc._FLAG_KEY not in kc._ENV and not kc.witness_enabled()
    monkeypatch.setenv("REPRO_KERNEL_WITNESS", "1")
    assert kc._FLAG_KEY in kc._ENV and kc.witness_enabled()
    monkeypatch.setenv("REPRO_KERNEL_WITNESS", "0")
    assert kc._FLAG_KEY in kc._ENV and not kc.witness_enabled()
    w = kc.KernelWitness()
    monkeypatch.setattr(kc, "WITNESS", w)
    segmented_select.segmented_count_le(i32(1), i32(0), i32(1), 1)
    assert w.calls == 0                      # "0" leaves it disarmed


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_the_pass_through_has_the_wrappers_own_parameters(name):
    """The function a contract puts in place of a wrapper declares the
    wrapper's parameters, kinds and defaults itself (no ``*args,
    **kwargs`` to pack on a disarmed call)."""
    fn = getattr(WRAPPERS[name], name)
    own = inspect.signature(fn, follow_wrapped=False).parameters
    want = inspect.signature(fn.__wrapped__).parameters
    assert [(p.name, p.kind, p.default) for p in own.values()] == \
        [(p.name, p.kind, p.default) for p in want.values()]
    assert fn.__code__.co_flags & (inspect.CO_VARARGS
                                   | inspect.CO_VARKEYWORDS) == 0


@pytest.mark.parametrize("arm", ["", "1"])
def test_the_pass_through_forwards_every_argument(monkeypatch, arm):
    """Positional, defaulted and keyword-only arguments reach the wrapped
    function as given, disarmed and armed; a mis-call raises TypeError."""
    monkeypatch.setenv("REPRO_KERNEL_WITNESS", arm)
    monkeypatch.setattr(kc, "WITNESS", kc.KernelWitness())
    monkeypatch.setattr(kc, "CONTRACTS", {})

    @kc.kernel_contract(in_specs={})
    def toy(a, b=2, *, c, d=(4,)):
        return a, b, c, d

    assert toy(1, c=3) == (1, 2, 3, (4,))
    assert toy(a=1, b=5, c=3, d=None) == (1, 5, 3, None)
    assert kc.WITNESS.calls == (2 if arm else 0)
    with pytest.raises(TypeError):
        toy(1, 2, 3)


def test_a_contract_refuses_a_wrapper_without_named_parameters(monkeypatch):
    monkeypatch.setattr(kc, "CONTRACTS", {})
    with pytest.raises(TypeError, match="variadic"):
        kc.kernel_contract(in_specs={})(lambda *xs: xs)


def test_armed_clean_call_recorded(armed):
    out = segmented_select.segmented_count_le(i32(1, 2, 3, 4),
                                              i32(0, 0, 1, 1), i32(2, 3), 2)
    assert out.tolist() == [2, 1]
    assert armed.calls == 1 and armed.problems() == []
    rep = armed.report()["kernels"]["segmented_count_le"]
    assert rep == {"calls": 1, "max_smem": 0}


def test_arm_disarm_roundtrip(armed, monkeypatch):
    args = (i32(0, 1), i32(1, 2), torch.ones(2, dtype=torch.bool), 3)
    kcore_peel.degree_count(*args)
    assert armed.calls == 1
    monkeypatch.delenv("REPRO_KERNEL_WITNESS")
    kcore_peel.degree_count(*args)
    assert armed.calls == 1


def test_symbol_conflict_detected(armed):
    """src and dst share the symbolic length E."""
    with pytest.raises(ValueError):
        kcore_peel.degree_count(i32(0, 1, 2), i32(1, 2),
                                torch.ones(3, dtype=torch.bool), 3)
    msgs = [p["message"] for p in armed.problems()
            if p["kind"] == "shape-contract"]
    assert msgs and "E=2 conflicts with E=3" in msgs[0]


def test_dtype_violation_detected(armed):
    with pytest.raises(TypeError):
        segmented_select.segmented_count_le(
            torch.tensor([1.5, 2.5]), i32(0, 0), i32(2), 1)
    assert kinds(armed) == {"dtype-contract"}


def test_wrong_operand_recorded_before_the_wrapper_raises(armed):
    """A (B, N + 1) ``active``: the witness records it, then B1's own
    check refuses the call."""
    B, N = 2, 5
    labels = torch.zeros((B, N), dtype=torch.int32)
    links = [torch.full((B, N), -1, dtype=torch.int32) for _ in range(3)]
    active = torch.ones((B, N + 1), dtype=torch.bool)
    with pytest.raises(ValueError):
        label_prop.label_prop_round(labels, *links, active,
                                    changed=torch.zeros(1, dtype=torch.int32))
    (p,) = armed.problems()
    assert p["kind"] == "shape-contract" and p["kernel"] == "label_prop_round"
    assert "active" in p["message"] and "N=6 conflicts with N=5" in \
        p["message"]
    assert armed.calls == 1


def test_refused_calls_are_told_apart(armed):
    """A violation the wrapper's own check refuses counts as refused; one
    whose call went through is :meth:`unrefused`."""
    with pytest.raises(TypeError):
        segmented_select.segmented_count_le(
            torch.tensor([1.5]), i32(0), i32(2), 1)
    (p,) = armed.problems()
    assert (p["count"], p["refused"]) == (1, 1) and armed.unrefused() == []
    armed.smem_limit = 16
    segment_matmul.matmul(torch.zeros((128, 64), dtype=torch.bfloat16),
                          torch.zeros((64, 64), dtype=torch.bfloat16))
    (q,) = armed.unrefused()
    assert q["kind"] == "smem-bound" and q["refused"] == 0


def test_the_wrapper_casts_what_its_contract_admits(armed):
    """B2's wrapper casts any integer operand to its kernel's int32: an
    int64 or int16 operand is within the contract."""
    out = segmented_select.segmented_count_le(
        torch.tensor([1, 2, 3], dtype=torch.int64),
        torch.tensor([0, 0, 1], dtype=torch.int16), i32(2, 9), 2)
    assert out.tolist() == [2, 1] and armed.problems() == []


def test_smem_violation_detected(armed):
    armed.smem_limit = 16
    a = torch.zeros((128, 64), dtype=torch.bfloat16)
    segment_matmul.matmul(a, torch.zeros((64, 64), dtype=torch.bfloat16))
    (p,) = armed.problems()
    assert p["kind"] == "smem-bound" and "197632 B" in p["message"]


def test_broken_smem_bound_is_a_problem(armed):
    fn = segmented_select.segmented_count_le.__wrapped__
    broken = dataclasses.replace(kc.CONTRACTS["segmented_count_le"],
                                 smem_bound=lambda v: v["nope"])
    out = kc._validate_call(broken, inspect.signature(fn), armed, fn,
                            (i32(1), i32(0), i32(1), 1), {})
    assert out.tolist() == [1]
    (p,) = armed.problems()
    assert p["kind"] == "smem-bound" and "KeyError" in p["message"]


def test_violations_deduplicate(armed):
    armed.smem_limit = 16
    a = torch.zeros((128, 64), dtype=torch.bfloat16)
    for _ in range(3):
        segment_matmul.matmul(a, torch.zeros((64, 64), dtype=torch.bfloat16))
    (p,) = armed.problems()
    assert p["count"] == 3 and armed.calls == 3


def test_report_is_json_serializable(armed):
    segmented_select.segmented_count_le(i32(1), i32(0), i32(1), 1)
    rep = json.loads(json.dumps(armed.report()))
    assert rep["smem_limit"] == kc.SMEM_PER_BLOCK == 232_448
    assert rep["contracts"] == sorted(kc.CONTRACTS)


def test_views_read_a_plan_ids(armed):
    """B4 takes a SegmentPlan for its ids; the witness reads its ids."""
    vals = torch.ones((4, 3))
    plan = segment_matmul.segment_plan(i32(0, 1, 1, 3), 2)
    segment_matmul.segment_sum(vals, plan, 2)
    assert armed.problems() == []
    with pytest.raises(ValueError):
        segment_matmul.segment_sum(torch.ones((5, 3)), plan, 2)
    assert "E=4 conflicts with E=5" in armed.problems()[0]["message"]


# ---------------------------------------------------------------------------
# coverage: every launch under a contract, and the reference's names
# ---------------------------------------------------------------------------

def _launch_functions():
    """(module, function) of every ``*_launch`` call in the kernels'
    Python files, by AST."""
    out = set()
    for path in sorted(KERNELS.glob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            if any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr.endswith("_launch")
                   for n in ast.walk(fn)):
                out.add((path.stem, fn.name))
    return out


def test_every_launch_site_is_under_a_contract():
    sites = _launch_functions()
    assert len(sites) == 13
    for module, name in sites:
        assert name in kc.CONTRACTS, f"{module}.{name} has no contract"
        assert WRAPPERS[name].__name__.endswith(module)
        fn = getattr(WRAPPERS[name], name)
        assert fn.__kernel_contract__ is kc.CONTRACTS[name]
        assert fn.__wrapped__.__name__ == name
    assert set(kc.CONTRACTS) == set(WRAPPERS)


def test_contracts_cover_the_reference():
    """Each reference contract has a port contract on its counterpart:
    the same operands at the same ranks, each accepting a subset of the
    reference's dtypes."""
    from repro.kernels import contracts as ref_kc
    import repro.kernels.flash_attention  # noqa: F401
    import repro.kernels.kcore_peel  # noqa: F401
    import repro.kernels.label_prop  # noqa: F401
    import repro.kernels.segment_matmul  # noqa: F401
    import repro.kernels.segmented_select  # noqa: F401
    assert set(ref_kc.CONTRACTS) == set(COUNTERPARTS)
    for ref_name, name in COUNTERPARTS.items():
        ref_specs = dict(ref_kc.CONTRACTS[ref_name].in_specs)
        specs = dict(kc.CONTRACTS[name].in_specs)
        for param, spec in ref_specs.items():
            assert param in specs, (name, param)
            assert len(specs[param].dims) == len(spec.dims), (name, param)
            assert set(specs[param].dtypes) <= set(spec.dtypes), \
                (name, param, specs[param].dtypes)


def test_layout_contracts_equal_the_reference():
    from repro.kernels.contracts import LAYOUT_CONTRACTS as REF
    assert kc.LAYOUT_CONTRACTS == REF
    assert list(kc.LAYOUT_CONTRACTS) == list(REF)


def test_array_fields_follow_the_layout():
    assert bq._ARRAY_FIELDS == tuple(kc.LAYOUT_CONTRACTS)
    fields = [f.name for f in dataclasses.fields(bq.DeviceIndex)]
    assert [f for f in fields if f in kc.LAYOUT_CONTRACTS] == \
        list(bq._ARRAY_FIELDS)


def test_smem_constant_has_one_home():
    assert segmented_select.SMEM_PER_BLOCK is kc.SMEM_PER_BLOCK
    assert flash_attention.SMEM_PER_SM is kc.SMEM_PER_SM
    for path in KERNELS.glob("*.py"):
        if path.name != "contracts.py":
            assert not re.search(r"^SMEM_PER_\w+\s*=", path.read_text(),
                                 re.M), path.name


# ---------------------------------------------------------------------------
# the shared-memory bounds, from the wrappers' plans
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _cu_consts(name: str) -> dict:
    """``constexpr int NAME = <expr>;`` of a csrc file, evaluated in
    order (integer division as C's)."""
    out: dict = {}
    for m in re.finditer(r"^constexpr int ([^;]+);",
                         (CSRC / name).read_text(), re.M):
        for decl in m.group(1).split(","):
            key, expr = (x.strip() for x in decl.split("=", 1))
            out[key] = eval(re.sub(r"(?<!/)/(?!/)", "//", expr), {},
                            dict(out))
    return out


def test_smem_constants_match_the_sources():
    mm = _cu_consts("matmul.cu")
    assert (mm["TMA_BK"], mm["BOX_BYTES"], mm["MK_SMEM"]) == (
        segment_matmul.TMA_BK, segment_matmul.TMA_BOX_BYTES,
        segment_matmul.MASKED_SMEM)
    fa = _cu_consts("flash_attention.cu")
    assert fa["MMA_STAGES"] == flash_attention.MMA_STAGES
    assert (fa["W_BQ"], fa["W_BK"], fa["BKV"]) == (
        128, 128, flash_attention.ROUTE_TILES["split"][1])
    src = (CSRC / "matmul.cu").read_text()
    assert "launch_tma<128, 256, false, 4>" in src
    assert "launch_tma<16, 128, true, 8>" in src
    assert "launch_tma<64, 128, true, 8>" in src


@pytest.mark.parametrize("shapes,dtype,route,smem", [
    (((4096, 4096), (4096, 4096)), torch.bfloat16, "wgmma", 197_632),
    (((16, 4096), (4096, 4096)), torch.bfloat16, "skinny", 148_480),
    (((64, 4096), (4096, 4096)), torch.bfloat16, "skinny", 197_632),
    (((512, 30), (30, 64)), torch.bfloat16, "masked", 27_136),
    (((4096, 602), (602, 128)), torch.float32, "f32", 0),
])
def test_matmul_smem_by_route(shapes, dtype, route, smem):
    (M, K), (_, N) = shapes
    assert segment_matmul.plan(M, N, K, dtype).route == route
    v = {"a": _meta(*shapes[0], dtype=dtype),
         "b": _meta(*shapes[1], dtype=dtype)}
    assert segment_matmul._matmul_smem(v) == smem <= kc.SMEM_PER_BLOCK


@pytest.mark.parametrize("q,kv,dtype,route,smem", [
    ((1, 4096, 32, 128), (1, 4096, 2, 128), torch.bfloat16, "wgmma",
     164_864),
    ((1, 512, 8, 64), (1, 512, 2, 64), torch.bfloat16, "wgmma", 82_944),
    ((16, 1, 32, 128), (16, 32768, 2, 128), torch.bfloat16, "split",
     104_448),
    ((4, 96, 4, 16), (4, 96, 4, 16), torch.bfloat16, "mma", 18_432),
    ((2, 64, 4, 64), (2, 64, 4, 64), torch.float32, "f32", 0),
])
def test_flash_smem_by_route(q, kv, dtype, route, smem):
    v = {"q": _meta(*q, dtype=dtype), "k": _meta(*kv, dtype=dtype),
         "t_real": None, "causal": True}
    p = flash_attention.plan(q[0], q[1], q[2], kv[2], kv[1], True,
                             flash_attention.kernel_width(q[3]), dtype)
    assert p.route == route
    assert flash_attention._flash_smem(v) == smem <= kc.SMEM_PER_BLOCK


@pytest.mark.parametrize("q,kv,dtype,route,smem", [
    ((1, 4096, 32, 128), (1, 4096, 2, 128), torch.bfloat16, "wgmma",
     133_120),
    ((4, 96, 4, 16), (4, 96, 4, 16), torch.bfloat16, "mma", 12_800),
    ((2, 64, 4, 256), (2, 64, 4, 256), torch.float32, "wide", 49_664),
])
def test_flash_bwd_smem_by_route(q, kv, dtype, route, smem):
    v = {"q": _meta(*q, dtype=dtype), "k": _meta(*kv, dtype=dtype),
         "t_real": None, "causal": True}
    assert flash_attention.bwd_plan(q[0], q[1], q[2], kv[2], kv[1], True,
                                    q[3], dtype).route == route
    assert flash_attention._flash_bwd_smem(v) == smem <= kc.SMEM_PER_BLOCK


def test_probe_and_sweep_smem():
    assert flash_attention.PROBE_SMEM == 99_328
    assert segment_matmul.PROBE_SMEM == 25_600
    n_max = kc.SMEM_PER_BLOCK // 8
    assert segmented_select.sweep_smem_bytes(1899) == 8 * 1899
    assert segmented_select.sweep_smem_bytes(n_max) == 8 * n_max
    assert segmented_select.sweep_smem_bytes(n_max + 1) == 0


# ---------------------------------------------------------------------------
# layout checks on upload
# ---------------------------------------------------------------------------

def test_check_layout_roundtrip():
    z = np.zeros(4, np.int32)
    good = {name: z for name in kc.LAYOUT_CONTRACTS}
    assert kc.check_layout(good) == []
    bad = dict(good)
    bad["node_u"] = z.astype(np.int64)
    bad["node_v"] = z.reshape(2, 2)
    bad["bogus_plane"] = z
    del bad["ver_k"]
    w = kc.KernelWitness()
    problems = kc.check_layout(bad, witness=w)
    assert len(problems) == 4
    assert any("int64" in p for p in problems)
    assert any("rank 2" in p for p in problems)
    assert any("bogus_plane" in p for p in problems)
    assert any("ver_k" in p for p in problems)
    assert {p["kind"] for p in w.problems()} == {"layout-contract"}


@pytest.fixture(scope="module")
def small_index():
    g = gen_temporal_graph(n=40, m=260, t_max=12, seed=3)
    return g, build_stratified_index(g, device="cpu")


def test_uploads_check_the_layout_when_armed(armed, small_index,
                                             monkeypatch):
    g, sx = small_index
    bq.to_device(sx, "cpu")
    assert armed.problems() == []
    real = bq._host_layout

    def widened(index):
        meta, arrays = real(index)
        return meta, {**arrays, "node_u": arrays["node_u"].astype(np.int64)}

    monkeypatch.setattr(bq, "_host_layout", widened)
    dix = bq.to_device(sx, "cpu")          # device_index narrows it back
    assert dix.node_u.dtype == torch.int32
    (p,) = armed.problems()
    assert p["kind"] == "layout-contract" and "node_u" in p["message"]
    armed.reset()
    bq.refresh_device(sx, dix, sx)
    assert [p["kind"] for p in armed.problems()] == ["layout-contract"]


# ---------------------------------------------------------------------------
# armed end to end: the TCCS main path on the CPU
# ---------------------------------------------------------------------------

def test_armed_end_to_end_mixed_k_device_query(armed):
    """The card's main path with CPU tensors: the build (the sweep and the
    fixpoints of the k range, through their wrappers), ``to_device``
    (layout checked) and one mixed-k batch through the executor (B1 to
    the fixpoint); every answer equal to Algorithm 1, no problem."""
    g = gen_temporal_graph(n=60, m=420, t_max=16, seed=5)
    sx = build_stratified_index(g, engine="device", device="cpu")
    dix = bq.to_device(sx, "cpu")
    rng = np.random.default_rng(0)
    specs = [TCCSQuery(int(u), int(ts), int(min(ts + w, g.t_max)), int(k),
                       ResultMode.VERTICES)
             for u, ts, w, k in zip(rng.integers(0, g.n, 48),
                                    rng.integers(1, g.t_max + 1, 48),
                                    rng.integers(0, g.t_max, 48),
                                    rng.choice(sx.supported_ks, 48))]
    results = serve.answer_batch(sx, dix, specs, max_batch=64)
    assert all(serve._matches(sx, q, r) for q, r in zip(specs, results))
    for q, r in list(zip(specs, results))[:8]:
        assert set(r.vertices) == kcore.tccs_oracle(g, q.k, q.u, q.ts, q.te)
    rep = armed.report()
    assert rep["problems"] == []
    assert {"stratum_sweep", "kcore_fixpoint",
            "label_prop_round"} <= set(rep["kernels"])


def _calls():
    """One call of every contract at small shapes: (name, thunk)."""
    g = torch.Generator().manual_seed(0)
    bf = dict(dtype=torch.bfloat16)
    q = torch.randn((1, 20, 4, 16), generator=g).to(**bf)
    k = torch.randn((1, 20, 2, 16), generator=g).to(**bf)
    o, lse = flash_attention.flash_attention(q, k, k, causal=True,
                                             return_lse=True)
    flag = torch.zeros(1, dtype=torch.int32)
    lab = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    links = torch.full((2, 3), -1, dtype=torch.int32)
    src, dst = i32(0, 1, 2), i32(1, 2, 0)
    alive = torch.ones(3, dtype=torch.bool)
    return {
        "label_prop_round": lambda: label_prop.label_prop_round(
            lab, links, links, links, torch.ones((2, 3), dtype=torch.bool),
            changed=flag),
        "segmented_count_le": lambda: segmented_select.segmented_count_le(
            i32(1, 2, 3), i32(0, 0, 1), i32(2, 2), 2),
        "kth_smallest": lambda: segmented_select.kth_smallest(
            i32(1, 2, 3), i32(0, 0, 1), 2, 1, 9),
        "stratum_sweep": lambda: segmented_select.stratum_sweep(
            i32(1, 1, 1, 1).reshape(1, 4), i32(0, 0, 1, 1), i32(0, 2, 4),
            i32(1, 1, 0, 0), i32(1),
            torch.zeros((1, 2), dtype=torch.int32), 5),
        "degree_count": lambda: kcore_peel.degree_count(src, dst, alive, 3),
        "peel_threshold": lambda: kcore_peel.peel_threshold(
            src, dst, alive, i32(2, 2, 2), 2, changed=flag),
        "kcore_fixpoint": lambda: kcore_peel.kcore_fixpoint(src, dst, 3, 2),
        "matmul": lambda: segment_matmul.matmul(
            torch.ones((3, 4)), torch.ones((4, 5))),
        "segment_sum": lambda: segment_matmul.segment_sum(
            torch.ones((3, 2)), i32(0, 1, 1), 2),
        "segment_gather": lambda: segment_matmul.segment_gather(
            torch.ones((2, 2)), i32(0, 1, 1)),
        "flash_attention": lambda: flash_attention.flash_attention(
            q, k, k, causal=True),
        "flash_attention_bwd": lambda: flash_attention.flash_attention_bwd(
            q, k, k, o, torch.ones_like(o), causal=True, lse=lse),
        "wgmma_probe": lambda: segment_matmul.wgmma_probe(
            torch.zeros((64, 16), **bf), torch.zeros((16, 128), **bf)),
        "rs_probe": lambda: flash_attention.rs_probe(
            torch.zeros((64, 128), **bf), torch.zeros((128, 128), **bf),
            torch.zeros((128, 128), **bf)),
    }


def test_every_contract_recorded_armed(armed):
    """Each contract once on CPU tensors: recorded with no problem (the
    probes, card-only, are recorded and then refuse the CPU)."""
    for name, call in _calls().items():
        if name in ("wgmma_probe", "rs_probe"):
            with pytest.raises(ValueError, match="no .* kernel for device"):
                call()
        else:
            call()
    rep = armed.report()
    assert rep["problems"] == []
    assert set(rep["kernels"]) == set(kc.CONTRACTS)
    assert rep["kernels"]["rs_probe"]["max_smem"] == 99_328
