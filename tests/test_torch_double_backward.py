"""The port's kernels as NequIP's and MACE's force losses use them: B5
(``ops.matmul``), B4 (``ops.segment_sum``), the row gather
(``ops.gather_rows``) and B4's gather twice differentiable through the
port's own ``autograd.Function``s (``gradgradcheck`` in f64, and the
Function nodes a ``create_graph`` gradient carries), B6 once
differentiable, and the kernel wrappers each GNN entry point calls, with
contiguous operands, at each architecture's full depth: the launches
``chip_smoke.py``'s [mgn], [geo] and [train] hold on the card. All on the
CPU, through the plain versions."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import gnn  # noqa: E402


def params_grads(model, loss_fn, batch):
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    for p in params.values():
        p.requires_grad_(False)
    return float(loss.detach()), dict(zip(params, grads))


@pytest.fixture
def f64_plain(monkeypatch):
    """The plain versions in the inputs' dtype (they compute in f32, as the
    reference does with x64 off), so that gradgradcheck's finite
    differences in f64 see the port's Functions and their backward
    formulas exactly."""
    def segment_sum(vals, ids, S):
        ok = (ids >= 0) & (ids < S)
        return vals.new_zeros((S, vals.shape[1])).index_add_(
            0, ids[ok].long(), vals[ok])
    monkeypatch.setattr(ref, "matmul", lambda a, b: a @ b)
    monkeypatch.setattr(ref, "segment_sum", segment_sum)


def t64(rng, *shape):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float64,
                        requires_grad=True)


def test_ops_pass_gradgradcheck_in_f64(f64_plain):
    rng = np.random.default_rng(9)
    ids = torch.tensor([0, 3, -1, 3, 9, 1, 0], dtype=torch.int32)
    assert torch.autograd.gradgradcheck(ops.matmul, (t64(rng, 5, 4),
                                                     t64(rng, 4, 3)))
    assert torch.autograd.gradgradcheck(
        lambda x: ops.segment_sum(x, ids, 4), (t64(rng, 7, 3),))
    idx = torch.tensor([2, 0, 2, 4, 1, 1], dtype=torch.int32)
    assert torch.autograd.gradgradcheck(
        lambda x: ops.gather_rows(x, idx), (t64(rng, 5, 3),))
    assert torch.autograd.gradgradcheck(
        lambda d: ops._SegmentGather.apply(d, ids, torch.float64),
        (t64(rng, 4, 3),))
    # a chain as the models run it: gather, product, sum
    assert torch.autograd.gradgradcheck(
        lambda x, w: ops.segment_sum(ops.matmul(ops.gather_rows(x, idx), w)
                                     .tanh(), idx, 5),
        (t64(rng, 5, 3), t64(rng, 3, 2)))


def test_create_graph_gradients_carry_the_ports_functions():
    """A gradient taken with ``create_graph=True`` through ops.matmul,
    ops.segment_sum and ops.gather_rows has the port's own Function node
    as its grad_fn (a product, the gather, a sum), not a plain torch node:
    its own gradient runs through the kernels too."""
    rng = np.random.default_rng(10)
    a = torch.tensor(rng.normal(size=(6, 4)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(4, 3)), dtype=torch.float32,
                     requires_grad=True)
    ids = torch.tensor([0, 1, 1, 3, 2, 0], dtype=torch.int32)
    (ga, gw) = torch.autograd.grad(ops.matmul(a, w).pow(2).sum(), (a, w),
                                   create_graph=True)
    assert type(ga.grad_fn).__name__ == "_MatMulBackward"
    assert type(gw.grad_fn).__name__ == "_MatMulBackward"
    (gs,) = torch.autograd.grad(ops.segment_sum(a, ids, 4).pow(2).sum(), a,
                                create_graph=True)
    assert type(gs.grad_fn).__name__ == "_SegmentGatherBackward"
    (gg,) = torch.autograd.grad(ops.gather_rows(a, ids).pow(2).sum(), a,
                                create_graph=True)
    assert type(gg.grad_fn).__name__ == "_SegmentSumBackward"


def test_attention_is_once_differentiable():
    """B6's backward is marked once differentiable: a second backward
    through it raises instead of returning a partial result."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.tensor(rng.normal(size=(1, 4, 2, 8)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    (gq,) = torch.autograd.grad(ops.flash_attention(q, k, v, causal=True)
                                .pow(2).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gq.sum().backward()


def test_first_order_sage_step_calls_the_kernels_as_before(monkeypatch):
    """The kernel wrappers a first-order GraphSAGE train step calls (on the
    card, its launches): B5 13 (5 forward, 8 gradients), B4 5 (4 forward,
    the gather's gradient), B4's gather 1, B5's gradient 8 counted as
    ``matmul_grads``; the counts ``chip_smoke.py``'s [train] holds."""
    calls = {"matmul": 0, "segment_sum": 0, "segment_gather": 0}
    for name in calls:
        fn = getattr(sm, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(sm, name, counted)
    spec = configs.get("graphsage-reddit")
    cfg = configs.cell_model_cfg(spec, "minibatch_lg", smoke=True)
    dims = dict(configs.smoke_dims(spec, "minibatch_lg"), n=64)
    batch = train.make_batch_fn(spec, cfg, dims, device="cpu")(0)
    model = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_grads(model, configs.loss_for(spec, cfg), batch)
    assert calls == {"matmul": 13, "segment_sum": 5, "segment_gather": 1}


#: (B5, B4, B4's gather) calls of one serve step, one energy-and-forces
#: pass and one train step at each architecture's full config: the
#: launches chip_smoke.py's [mgn] and [geo] hold on the card
GNN_CALLS = {
    "meshgraphnet": {"serve": (99, 15, 0), "train": (295, 45, 15)},
    "nequip": {"serve": (33, 16, 0), "forces": (62, 30, 14),
               "train": (207, 56, 42)},
    "mace": {"serve": (27, 7, 0), "forces": (51, 12, 7),
             "train": (171, 22, 19)},
}


@pytest.mark.parametrize("arch", sorted(GNN_CALLS))
def test_kernel_calls_per_step(arch, monkeypatch):
    """The kernel wrappers each entry point calls (on the card, its
    launches), at each full config's depth with narrow widths (the counts
    depend on the layers, not their widths) on a smoke-sized batch:
    MeshGraphNet's
    serve step 9 + 6 per layer B5 and one B4 per layer; its train step
    three times the products less the two whose input needs no gradient,
    B4 for the sums and both gathers' gradients, one gather per sum; the
    geometric models' serve, force and train passes as counted. Every
    call hands the kernels contiguous operands where the card's wrappers
    require them (B5's two operands, B4's values; B4's gather copies its
    input itself)."""
    calls = {"matmul": 0, "segment_sum": 0, "segment_gather": 0}
    for name in calls:
        fn = getattr(sm, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            operands = {"matmul": a[:2], "segment_sum": a[:1]}.get(_name, ())
            assert all(t.is_contiguous() for t in operands), _name
            return _fn(*a, **kw)
        monkeypatch.setattr(sm, name, counted)
    spec = configs.get(arch)
    shape = "full_graph_sm" if arch == "meshgraphnet" else "molecule"
    narrow = (dict(d_node_in=8, d_hidden=16) if arch == "meshgraphnet"
              else dict(d_species=8, d_hidden=8, radial_hidden=8))
    cfg = dataclasses.replace(configs.cell_model_cfg(spec, shape), **narrow)
    batch = train.make_batch_fn(spec, cfg, configs.smoke_dims(spec, shape),
                                device="cpu")(0)
    model = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {}

    def count(what, fn):
        for k in calls:
            calls[k] = 0
        fn()
        got[what] = tuple(calls.values())

    count("serve", lambda: configs.make_serve_step(spec, shape, cfg)(
        model, batch))
    if "forces" in GNN_CALLS[arch]:
        count("forces", lambda: gnn.energy_and_forces(model, batch))
    count("train", lambda: params_grads(model, configs.loss_for(spec, cfg),
                                        batch))
    assert got == GNN_CALLS[arch]
