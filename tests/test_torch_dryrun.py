"""The port's dry run (``repro_torch.launch.dryrun``), its roofline terms
(``launch.roofline``) and report (``launch.report``) against the
reference's arithmetic and tables.

* One cell per family runs ``run_cell`` on meta tensors on the CPU's
  (1, 1) mesh, launching no kernel. Its argument bytes equal the sum over
  the reference's ``abstract_params`` (with its batch and, to train,
  AdamW's state) on (1, 1), and the ceil-divided shards under the
  reference's specs on 16 x 16 and 2 x 16 x 16; ``model_flops`` equals
  the reference's; the traced FLOPs and bytes of ``probe2``, ``probe4``
  and the full depth are affine in ``n_layer``.
* ``report``'s tables equal the reference's string for string on the
  same JSON records.
* ``roofline_terms`` equals the reference's formulas under the
  reference's constants and under the port's.
* Meta tensors take the kernels' plain versions (no launch); CUDA
  tensors never do (``_args.plain``).
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.launch import report as jax_report  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.kernels import _args  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import segment_matmul as sm  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch.mesh import (HW, MeshShape,  # noqa: E402
                                     make_production_mesh, make_smoke_mesh)

#: one cell per family: lm-dense, lm-moe, gnn (two), recsys
CELLS = [("codeqwen1.5-7b", "decode_32k"), ("qwen2-moe-a2.7b", "decode_32k"),
         ("graphsage-reddit", "full_graph_sm"), ("nequip", "molecule"),
         ("mind", "train_batch")]
PROD = {"16x16:data,model": make_production_mesh(),
        "2x16x16:pod,data,model": make_production_mesh(multi_pod=True)}


def counts() -> tuple:
    return (sm.matmul.launches, sm.segment_sum.launches,
            sm.segment_gather.launches, sm.segment_plan.builds,
            fa.flash_attention.launches, fa.flash_attention_bwd.launches)


def ref_arg_bytes(arch: str, shape: str, mesh) -> int:
    """Per-device argument bytes of a reference cell on ``mesh``: every
    leaf of its params, batch (and to train AdamW's state) under its spec,
    each split dimension ceil-divided."""
    jspec = jax_configs.get(arch)
    jcfg = jax_configs.cell_model_cfg(jspec, shape)
    params = jax_configs.abstract_params(jspec, jcfg)
    p_specs = jax_configs.param_specs(jspec, params, mesh)
    batch = jax_configs.input_specs(jspec, shape, model_cfg=jcfg)
    trees = [(params, p_specs),
             (batch, jax_configs.batch_specs(jspec, shape, batch, mesh))]
    if jspec.shapes[shape]["kind"] == "train":
        trees.append((jax.eval_shape(jax_adamw.init_state, params),
                      jax_base.opt_specs(p_specs)))
    sizes = dict(mesh.shape)
    total = 0
    for tree, specs in trees:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs,
                                      is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(spec_leaves)
        for leaf, spec in zip(leaves, spec_leaves):
            parts = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
            n = 1
            for dim, part in zip(leaf.shape, parts):
                axes = () if part is None else \
                    (part,) if isinstance(part, str) else tuple(part)
                n *= -(-dim // math.prod(sizes[a] for a in axes))
            total += n * leaf.dtype.itemsize
    return total


@pytest.fixture(scope="module")
def records():
    mesh = make_smoke_mesh("cpu")
    before = counts()
    recs = {cell: dryrun.run_cell(*cell, mesh=mesh, verbose=False)
            for cell in CELLS}
    assert counts() == before, "the meta trace launched a kernel"
    return recs


@pytest.mark.parametrize("cell", CELLS, ids=["__".join(c) for c in CELLS])
def test_run_cell_record(records, cell):
    arch, shape = cell
    rec = records[cell]
    assert rec["mesh"] == "1x1:data,model" and rec["n_devices"] == 1
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    jspec = jax_configs.get(arch)
    assert rec["model_flops"] == jax_configs.model_flops(
        jspec, shape, model_cfg=jax_configs.cell_model_cfg(jspec, shape))
    one = MeshShape(("data", "model"), (1, 1))
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref_arg_bytes(arch, shape, one)
    assert set(rec["production"]) == set(PROD)
    for name, m in PROD.items():
        prod = rec["production"][name]
        assert prod["argument_size_in_bytes"] == ref_arg_bytes(arch, shape,
                                                               m)
        assert prod["flops_per_device"] is None and prod["why_none"]
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    if arch == "mind":           # the vp take's exchanges are counted
        assert rec["collectives"]["counts"]["all-reduce"] >= 1
    assert json.loads(json.dumps(rec, default=str))["arch"] == arch


@pytest.mark.parametrize("cell", CELLS[:2], ids=["__".join(c)
                                                 for c in CELLS[:2]])
def test_traced_counts_affine_in_layers(records, cell):
    """Every layer is traced, so FLOPs and bytes at n_layer L equal the
    line through the 2- and 4-layer probes."""
    rec = records[cell]
    L = rec["n_layer"]
    p2, p4 = rec["probes"]["probe2"], rec["probes"]["probe4"]
    for key in ("flops_per_device", "bytes_per_device"):
        slope = (p4[key] - p2[key]) / 2.0
        assert rec[key] == pytest.approx(p2[key] + (L - 2) * slope,
                                         rel=1e-9), key


def test_report_tables_equal_reference(records, tmp_path):
    """The port's tables are the reference's on the same JSON records (the
    records relabelled to the reference's single-pod mesh for
    ``pick_hillclimb``, which reads only those)."""
    for i, rec in enumerate(records.values()):
        with open(tmp_path / f"{i}.json", "w") as f:
            json.dump(rec, f, default=str)
    recs = report.load(str(tmp_path))
    assert recs == jax_report.load(str(tmp_path))
    assert report.dryrun_table(recs) == jax_report.dryrun_table(recs)
    assert report.roofline_table(recs, "1x1") == \
        jax_report.roofline_table(recs, "1x1")
    single = [{**r, "mesh": "16x16:data,model"} for r in recs]
    assert report.roofline_table(single) == jax_report.roofline_table(single)
    assert report.pick_hillclimb(single) == jax_report.pick_hillclimb(single)
    for b in (None, 5e5, 2.5e9):
        assert report.fmt_bytes(b) == jax_report.fmt_bytes(b)
    table = report.production_table(recs)
    assert "arg B/dev 2x16x16" in table and len(table.splitlines()) == 7
    report.main([str(tmp_path)])


@pytest.mark.parametrize("terms", [(1e15, 3e12, 0.0), (2e12, 8e9, 4e9),
                                   (0.0, 0.0, 0.0)])
def test_roofline_terms_equal_reference(terms, monkeypatch):
    kw = dict(model_flops_global=5e14, n_devices=256)
    ref_hw = {"peak_flops_bf16": jax_roofline.HW["peak_flops_bf16"],
              "hbm_bw": jax_roofline.HW["hbm_bw"],
              "link_bw": jax_roofline.HW["ici_bw"]}
    assert roofline.roofline_terms(*terms, hw=ref_hw, **kw) == \
        jax_roofline.roofline_terms(*terms, **kw)
    monkeypatch.setitem(jax_roofline.HW, "peak_flops_bf16",
                        HW["peak_flops_bf16"])
    monkeypatch.setitem(jax_roofline.HW, "hbm_bw", HW["hbm_bw"])
    monkeypatch.setitem(jax_roofline.HW, "ici_bw", HW["link_bw"])
    assert roofline.roofline_terms(*terms, **kw) == \
        jax_roofline.roofline_terms(*terms, **kw)


def test_dryrun_cli(tmp_path, capsys):
    """``main`` writes a record per cell and exits 0; a cell that fails
    makes it exit 1."""
    out = tmp_path / "recs"
    assert dryrun.main(["--arch", "mind", "--shape", "serve_p99",
                        "--single-pod-only", "--device", "cpu",
                        "--out", str(out)]) == 0
    rec = json.loads((out / "mind__serve_p99.json").read_text())
    assert list(rec["production"]) == ["16x16:data,model"]
    assert dryrun.main(["--arch", "mind", "--shape", "no_such_shape",
                        "--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out


@pytest.mark.parametrize("opt", ["moea2a", "actshard", "weightgather",
                                 "nodeshard_bf16"])
def test_opts_trace_on_the_card_mesh(opt):
    """The variants trace on the (1, 1) mesh: the a2a MoE's exchanges are
    counted, the hooks are layout checks; every hook is reset after."""
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tfm
    cell = ("nequip", "molecule") if opt.startswith("node") else \
        ("qwen2-moe-a2.7b", "decode_32k")
    rec = dryrun.run_cell(*cell, mesh=make_smoke_mesh("cpu"),
                          multi_pod=False, probes=False, opt=opt,
                          verbose=False)
    if opt == "moea2a":
        assert rec["collectives"]["counts"]["all-to-all"] == 2 * 24
    assert tfm.MOE_IMPL is None and tfm.ACT_SHARDING is None
    assert tfm.WEIGHT_USE_SHARDING is None and gnn.NODE_SHARDING is None


def test_meta_takes_plain_versions_cuda_never():
    """Meta tensors take the plain versions, shaped and launching nothing;
    a CUDA device never counts as plain (its tensors launch or raise)."""
    assert _args.plain(torch.device("cpu"))
    assert _args.plain(torch.device("meta"))
    assert not _args.plain(torch.device("cuda"))
    assert not _args.plain(torch.device("cuda", 0))
    before = counts()
    meta = dict(device="meta")
    a = torch.empty(64, 32, dtype=torch.bfloat16, **meta)
    b = torch.empty(32, 48, dtype=torch.bfloat16, **meta)
    assert sm.matmul(a, b).shape == (64, 48)
    vals = torch.empty(100, 8, **meta)
    ids = torch.empty(100, dtype=torch.int32, **meta)
    assert sm.segment_sum(vals, ids, 7).shape == (7, 8)
    assert sm.segment_gather(torch.empty(7, 8, **meta), ids).shape == (100, 8)
    q = torch.empty(1, 16, 4, 64, dtype=torch.bfloat16, **meta)
    assert fa.flash_attention(q, q, q, causal=True).device.type == "meta"
    assert counts() == before
    with pytest.raises(ValueError, match="no matmul kernel"):
        _args.cuda_only(torch.device("meta"), "matmul")


def test_mesh_descriptions_build_no_group():
    m = make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert make_production_mesh().axis_names == ("data", "model")
    from repro_torch.launch.mesh import backend_for
    if torch.cuda.is_available() and torch.distributed.is_nccl_available():
        assert backend_for("cuda") == "nccl"
    else:                             # no fallback to gloo
        with pytest.raises(RuntimeError, match="card|NCCL"):
            backend_for("cuda")
    assert backend_for("cpu") == "gloo"
    assert np.isclose(HW["peak_flops_bf16"], 989e12)
