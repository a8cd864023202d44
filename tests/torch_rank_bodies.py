"""Rank bodies of the port's multi-rank CPU tests
(``tests/test_torch_runtime.py``, ``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_moe.py``, ``tests/test_torch_mesh_gnn.py``,
``tests/test_torch_mesh_mind.py``, ``tests/test_torch_mesh_nodeshard.py``).

Each of ``world`` processes runs::

    python -m torch_rank_bodies <rank> <world> <store file> <inputs.npz> <out prefix> <suite>

joins a gloo group of ``world`` ranks through a ``FileStore``, builds every
mesh of :data:`MESHES` for its world size, runs each body of the suite
(:data:`SUITES`: ``runtime``, ``mesh``, ``moe``, ``gnn``, ``mind`` or
``nodeshard``) on each mesh
and writes its results to ``<out prefix>.<rank>.npz``, keyed
``<body>|<mesh>|<name>``.
Only ``torch`` and the port are imported here; the test compares the
results with the reference and with single-device answers.
:func:`run_world` starts the processes and waits for them, each under a
hard timeout, killing them all if one fails or hangs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: the (data, model) meshes built at each world size; (2, 4) is the
#: reference's own sharded train step's (tests/test_distributed.py)
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1)], 8: [(2, 4)]}

ROOT = Path(__file__).resolve().parent.parent


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def moe_cfg(E: int = 8):
    """The a2a test's layer, the reference's own test's
    (``tests/test_distributed.py``): 8 experts, top-2, d 64, capacity 8."""
    import torch
    from repro_torch.models import transformer as tfm
    mcfg = tfm.MoEConfig(n_experts=E, top_k=2, d_ff_expert=32,
                         capacity_factor=8.0, n_shared=1)
    return tfm.LMConfig("t", n_layer=1, d_model=64, n_head=2, n_kv=2, d_ff=0,
                        vocab=64, d_head=16, moe=mcfg, dtype=torch.float32,
                        remat=False)


def moe_module(inp: dict):
    """The layer's ``MoE`` parameters from the inputs' ``moe.<name>``."""
    import torch
    from repro_torch.models import transformer as tfm
    p = tfm.MoE(moe_cfg(), device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(inp[f"moe.{name}"]))
            t.requires_grad_(True)
    return p


def vp_take_body(mesh, inp: dict) -> dict:
    """The vp take of the global table by the global ids, its rows split
    over the data axis: this rank's rows and the whole table's gradient of
    ``sum(rows * w)`` over every rank's rows."""
    import torch
    from repro_torch.runtime import sharding as shd
    table = torch.from_numpy(inp["table"]).requires_grad_(True)
    ids = torch.from_numpy(inp["ids"])
    take = shd.make_vp_take(mesh, leading=("data",))
    out = take(table, ids)
    w = shd.local_shard(torch.from_numpy(inp["w"]), mesh,
                        shd.P(("data",), None, None))
    (grad,) = torch.autograd.grad((out * w).sum(), table)
    return {"out": out.detach().numpy(), "grad": grad.numpy()}


def a2a_body(mesh, inp: dict) -> dict:
    """The a2a MoE on the global x: this rank's output rows, aux, and the
    gradients of ``sum(out * w)`` (every rank's rows) with respect to x and
    every parameter."""
    import torch
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.moe_a2a import make_a2a_moe
    p = moe_module(inp)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    out, aux = make_a2a_moe(mesh, ("data",))(p, moe_cfg(), x)
    w = shd.local_shard(torch.from_numpy(inp["w_moe"]), mesh,
                        shd.P(("data",), None, None))
    params = dict(p.named_parameters())
    grads = torch.autograd.grad((out * w).sum(), [x, *params.values()])
    res = {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
           "grad.x": grads[0].numpy()}
    res.update({f"grad.{n}": g.numpy() for n, g in zip(params, grads[1:])})
    return res


def compress_body(mesh, inp: dict) -> dict:
    """The compressed mean over the data axis of this rank's own gradient
    and error (``g[i]``, ``e[i]``, i its data index)."""
    import torch
    from repro_torch.optim import compression
    from repro_torch.runtime import sharding as shd
    i = shd.axis_index(mesh, "data")
    g = torch.from_numpy(inp["g"][i])
    e = torch.from_numpy(inp["e"][i])
    f = compression.make_compressed_grad_allreduce(mesh, axis="data")
    mean, new_e = f({"w": g}, {"w": e})
    return {"mean": mean["w"].numpy(), "new_error": new_e["w"].numpy()}


def double_body(mesh, inp: dict) -> dict:
    """A force-like second derivative through the collectives, in f64:
    node energies ``psum`` of a sum over this rank's edges (its share of
    the global ``dd.src``, ``dd.dst`` over every axis) of ``tanh(rvec @
    w)``, ``rvec = pos[src] - pos[dst]`` gathered from ``grad_sum(pos)``
    with ``grad_sum(w)``; the forces ``-dE/dpos`` taken with
    ``create_graph``; the gradient of ``w`` of the forces' squared error.
    ``mesh`` None: the same on one device with no collective."""
    import torch
    from repro_torch.runtime import sharding as shd
    src = torch.from_numpy(inp["dd.src"]).long()
    dst = torch.from_numpy(inp["dd.dst"]).long()
    if mesh is None:
        def rep(x):
            return x
        agg = rep
    else:
        axes = shd.all_axes(mesh)
        src, dst = (shd.local_shard(t, mesh, shd.P(axes)) for t in (src, dst))

        def rep(x):
            return shd.grad_sum(x, mesh, axes)

        def agg(x):
            return shd.psum(x, mesh, axes)
    pos = torch.from_numpy(inp["dd.pos"]).requires_grad_(True)
    w = torch.from_numpy(inp["dd.w"]).requires_grad_(True)
    pr = rep(pos)
    e = torch.tanh((pr[src] - pr[dst]) @ rep(w))
    node = agg(torch.zeros(pos.shape[0], e.shape[1], dtype=e.dtype
                           ).index_add(0, dst, e))
    energy = (node ** 2).sum()
    (dpos,) = torch.autograd.grad(energy, pos, create_graph=True)
    loss = ((-dpos - torch.from_numpy(inp["dd.target"])) ** 2).sum()
    (gw,) = torch.autograd.grad(loss, w)
    return {"forces": (-dpos).detach().numpy(), "grad": gw.numpy()}


def ordered_sum_body(mesh, inp: dict) -> dict:
    """``sharding.all_reduce``'s sum of this rank's ``os.x[rank]`` over
    each axis by both of its routes: the gather (small tensors; every
    route's threshold as shipped) and the exchange (``GATHER_SUM_BYTES``
    at 0, and ``_exchange_sum`` called directly, as two ranks never take
    it), on the whole (9, 7) tensor (63 elements: zero-padded chunks) and
    on its first 8 rows (56: whole chunks); the sum of its first 2 rows
    alone; and the global ranks of each axis's group in rank order."""
    from unittest import mock

    import torch
    import torch.distributed as dist
    from repro_torch.runtime import sharding as shd
    x = torch.from_numpy(inp["os.x"][dist.get_rank()])
    res = {}
    for a in shd.axis_names(mesh):
        n = shd.axis_sizes(mesh)[a]
        group = shd._group(mesh, a)
        res[f"{a}|ranks"] = np.array(dist.get_process_group_ranks(group))
        res[f"{a}|gather"] = shd.all_reduce(x, mesh, a).numpy()
        res[f"{a}|rows"] = shd.all_reduce(x[:2], mesh, a).numpy()
        with mock.patch.object(shd, "GATHER_SUM_BYTES", 0):
            res[f"{a}|exchange"] = shd.all_reduce(x, mesh, a).numpy()
        if n > 1:
            for what, t in (("whole", x), ("rows8", x[:8])):
                res[f"{a}|direct.{what}"] = shd._exchange_sum(
                    t.reshape(-1), n, group).view(t.shape).numpy()
    return res


BODIES = {"vp": vp_take_body, "a2a": a2a_body, "compress": compress_body,
          "double": double_body, "ordered": ordered_sum_body}


# ----------------------------------------------------------------------
# the dense LM step under the partitioner (tests/test_torch_mesh.py)
# ----------------------------------------------------------------------

def tree_of(inp: dict, prefix: str) -> dict:
    """The nested dict saved flat as ``<prefix>/a/b`` keys."""
    tree: dict = {}
    for key, val in inp.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *path, leaf = key[len(prefix) + 1:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree


def lm_cfg(arch: str, dtype: str, over: dict | None = None,
           moe_over: dict | None = None):
    """The arch's smoke config in ``dtype`` (glm4's: n_head 4 over n_kv 2,
    d_model 64, the reference's sharded test's shapes; codeqwen's: 4 over
    4), with ``over`` replacing LMConfig fields and ``moe_over`` MoEConfig
    fields."""
    import dataclasses
    import torch
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch).smoke_cfg,
                              dtype=getattr(torch, dtype), **(over or {}))
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_over))
    return cfg


def placed_model(mesh, inp: dict, arch: str, dtype: str, cfg=None,
                 key: str | None = None):
    """The carried reference parameters (``<key>.p``, key
    ``<arch>.<dtype>`` by default), this rank's shards of them
    (``lm_params_from_reference(tree, mesh)``), as a placed model of
    ``cfg`` (the arch's smoke config in ``dtype`` by default)."""
    from repro_torch.core.carry import lm_params_from_reference
    from repro_torch.models import transformer as tfm
    cfg = cfg or lm_cfg(arch, dtype)
    shards = lm_params_from_reference(
        tree_of(inp, f"{key or f'{arch}.{dtype}'}.p"), mesh)
    meta = dict(tfm.Transformer(cfg, device="meta").named_parameters())
    shards = {n: t.to(meta[n].dtype) for n, t in shards.items()}
    if mesh is None:                          # whole tensors, no mesh
        model = tfm.Transformer(cfg, device="cpu")
        model.load_state_dict(shards)
        return cfg, model
    return cfg, tfm.placed(cfg, shards, mesh)


def gathered_logits(x, mesh):
    """Logits split (data rows, model columns) gathered whole."""
    from repro_torch.runtime import sharding as shd
    if mesh is None:
        return x
    return shd.gather(shd.gather(x, mesh, "model", dim=-1), mesh, "data")


def lm_body(mesh, inp: dict, arch: str = "glm4-9b",
            dtype: str = "float32", cfg=None, key: str | None = None,
            tok: str = "", routes=None, local: bool = False) -> dict:
    """The carried model (the reference's after one step, with its AdamW
    state; ``key`` and ``cfg`` as :func:`placed_model` takes them): the
    prefill's logits and four decode steps from an empty cache of
    ``lm_cache_spec``'s layout, gathered; then one train step: its
    metrics, every updated parameter and both moments, gathered. The
    tokens are the inputs' ``<tok>fwd``, ``<tok>dec``, ``<tok>tokens`` and
    ``<tok>labels``; ``routes`` (a :class:`Routes`, for a MoE model) runs
    each of the three as its phase. With ``local`` the parameters and
    moments are this rank's shards, left for the test to assemble
    (:func:`assemble`): no exchange."""
    import contextlib
    import torch
    from repro_torch import configs
    from repro_torch.core.carry import adamw_state_from_reference
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    spec = configs.get(arch)
    cfg, model = placed_model(mesh, inp, arch, dtype, cfg, key)
    pre = key or f"{arch}.{dtype}"
    phase = routes.phase if routes else (lambda name: contextlib.nullcontext())
    res = {}
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)
    with phase("prefill"):
        logits = prefill(model, {"tokens": torch.from_numpy(inp[tok + "fwd"])})
    res["logits"] = gathered_logits(logits, mesh).numpy()
    decode = configs.make_serve_step(spec, "decode_32k", cfg, mesh=mesh)
    dec = torch.from_numpy(inp[tok + "dec"])
    cache = tfm.init_cache(cfg, dec.shape[1], dec.shape[0] + 2,
                           device="cpu", mesh=mesh)
    with phase("decode"):
        for i in range(dec.shape[0]):
            out, cache = decode(model, {"tokens": dec[i], "cache": cache,
                                        "cache_len": i})
            res[f"decode.{i}"] = gathered_logits(out, mesh).numpy()
    state = adamw_state_from_reference(
        {"mu": tree_of(inp, f"{pre}.mu"), "nu": tree_of(inp, f"{pre}.nu"),
         "step": inp[f"{pre}.step"]}, mesh)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
    batch = {k: torch.from_numpy(inp[tok + k]) for k in ("tokens", "labels")}
    shd.reset_collectives()
    with phase("step"):
        _, state, m = step(model, state, batch)
    counts = shd.collective_counts()
    res.update({k: v.numpy() for k, v in m.items()})
    res["calls"] = np.array([counts.get(k, {}).get("calls", 0) for k in
                             ("all-gather", "reduce-scatter", "all-reduce")])
    for what, tree in (("param", dict(model.named_parameters())),
                       ("mu", state["mu"]), ("nu", state["nu"])):
        if mesh is not None and not local:
            specs = shd.lm_param_spec_tree(tfm.abstract_params(cfg), mesh)
            tree = shd.unshard_params(tree, specs, mesh)
        for n, t in tree.items():
            res[f"{what}.{n}"] = t.detach().float().numpy()
    if routes is not None:
        res.update(routes.results(tfm.partition_of(model), cfg.n_layer))
    return res


class Routes:
    """A MoE model's routing on this rank, by phase (:meth:`phase`): each
    call of ``transformer.route`` (this rank's (T_local, K) expert ids) and
    of ``transformer.dispatch`` (a group's global ``dest``, the same on
    every rank) kept. With ``replay`` (another run's kept ids by phase, of
    the GLOBAL rows), each route call instead returns this rank's rows of
    the next kept ids, counting in ``flips`` the assignments its own
    routing would have sent to another expert."""

    def __init__(self, replay: dict | None = None):
        from repro_torch.models import transformer as tfm
        self.tfm, self.route, self.dispatch = tfm, tfm.route, tfm.dispatch
        self.sum_aux = tfm._sum_aux
        self.replay, self.d_index = replay, 0
        self.kept, self.dests, self.aux, self.flips = {}, {}, {}, 0
        self.name, self.i = None, 0

    def phase(self, name: str):
        import contextlib
        from unittest import mock
        self.name, self.i = name, 0
        self.kept[name], self.dests[name] = [], []
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(self.tfm, "route", self._route))
        stack.enter_context(mock.patch.object(self.tfm, "dispatch",
                                              self._dispatch))
        stack.enter_context(mock.patch.object(self.tfm, "_sum_aux",
                                              self._sum_aux))
        return stack

    def _sum_aux(self, auxes, device):
        self.aux[self.name] = out = self.sum_aux(auxes, device)
        return out

    def _route(self, probs, k):
        own = self.route(probs, k)
        if self.replay is None:
            self.kept[self.name].append(own)
            return own
        n = probs.shape[0]
        ids = self.replay[self.name][self.i][self.d_index * n:
                                             (self.d_index + 1) * n]
        self.i += 1
        self.flips += int((ids[:, :, None] != own[:, None, :]).all(-1).sum())
        self.kept[self.name].append(ids)
        return ids

    def _dispatch(self, eidx, E, C):
        out = self.dispatch(eidx, E, C)
        self.dests[self.name].append(out[5])
        return out

    def results(self, part, L: int) -> dict:
        """Per layer, the prefill's expert ids of every rank's tokens
        (``route.<l>``, gathered over the data axes), every group's
        ``dest`` (``dest``, (L * G, Tg * K)) and its aux loss (``aux``, the
        layers' sum, global); ``flips``."""
        import torch
        calls = self.kept["prefill"]
        per = len(calls) // L
        res = {f"route.{l}": part.gather_ids(torch.cat(
            calls[l * per:(l + 1) * per])).numpy() for l in range(L)}
        res["dest"] = torch.stack(self.dests["prefill"]).numpy()
        res["aux"] = self.aux["prefill"].numpy()
        res["flips"] = np.array(self.flips)
        return res


def bf16_body(mesh, inp: dict) -> dict:
    return lm_body(mesh, inp, dtype="bfloat16")


def codeqwen_body(mesh, inp: dict) -> dict:
    return lm_body(mesh, inp, arch="codeqwen1.5-7b")


def hooks_body(mesh, inp: dict) -> dict:
    """The hooks on placed models: glm4's residual ``P(dp, None, None)``
    and the gathered-at-use weights the partitioner produces check clean
    (logits equal to the run without hooks), as do qwen2-moe's: its
    experts' buffers and intermediates (EP or expert TP, C over ``data``)
    and the weights at use, ``moe.*`` among them; the dry run's
    ``seqshard`` ``P(dp, "model", None)`` and a MoE placement the
    partitioner does not produce, ``P("data", None, None)`` (experts over
    the data axis), raise ``NotImplementedError`` naming the spec."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding as shd
    P = shd.P
    cfg, model = placed_model(mesh, inp, "glm4-9b", "float32")
    toks = shd.local_shard(torch.from_numpy(inp["fwd"]), mesh,
                           P("data", None)).contiguous()
    want, _ = tfm.forward(model, toks)
    mcfg = lm_cfg("qwen2-moe-a2.7b", "float32")
    moe = tfm.init_params(mcfg, torch.Generator().manual_seed(0),
                          device="cpu", mesh=mesh)
    want_moe, _ = tfm.forward(moe, toks % mcfg.vocab)
    res = {}
    ms = shd.axis_sizes(mesh)["model"]
    ep = mcfg.moe.e_total % ms == 0

    def table(c) -> dict:
        """The weights at use of a model of config c."""
        kv = P(None, "model") if c.n_kv % ms == 0 else P(None, None)
        t = {"attn.wq": P(None, "model"), "attn.wk": kv, "attn.wv": kv,
             "attn.wo": P("model", None), "ffn.wi": P(None, "model"),
             "ffn.wg": P(None, "model"), "ffn.wo": P("model", None),
             "moe.wi": P("model", None, None) if ep else P(None, None,
                                                           "model"),
             "moe.wg": P("model", None, None) if ep else P(None, None,
                                                           "model"),
             "moe.wo": P("model", None, None) if ep else P(None, "model",
                                                           None),
             "moe.shared_wi": P(None, None, "model"),
             "moe.shared_wg": P(None, None, "model"),
             "moe.shared_wo": P(None, "model", None)}
        tfm.set_weight_use_sharding({k: shd.named(mesh, v)
                                     for k, v in t.items()})
    moe_layouts = ((P("model", "data", None), P("model", "data", None))
                   if ep else (P(None, "data", None), P(None, "data",
                                                        "model")))
    raised = []
    try:
        tfm.set_activation_sharding(shd.named(mesh, P("data", None, None)))
        tfm.set_moe_sharding(tuple(shd.named(mesh, v) for v in moe_layouts))
        table(cfg)
        got, _ = tfm.forward(model, toks)
        res["hooked_equal"] = np.array(torch.equal(got, want))
        table(mcfg)
        got_moe, _ = tfm.forward(moe, toks % mcfg.vocab)
        res["hooked_moe_equal"] = np.array(torch.equal(got_moe, want_moe))
        for what, setup in (
                ("seqshard", lambda: tfm.set_activation_sharding(
                    shd.named(mesh, P("data", "model", None)))),
                ("moe", lambda: tfm.set_moe_sharding(
                    (shd.named(mesh, P("data", None, None)),
                     shd.named(mesh, moe_layouts[1]))))):
            tfm.set_activation_sharding(None)
            tfm.set_moe_sharding(None)
            table(mcfg if what == "moe" else cfg)
            setup()
            try:
                tfm.forward(moe if what == "moe" else model,
                            toks % mcfg.vocab if what == "moe" else toks)
                raised.append(f"{what}: nothing raised")
            except NotImplementedError as e:
                raised.append(f"{what}: {e}")
    finally:
        tfm.set_activation_sharding(None)
        tfm.set_weight_use_sharding(None)
        tfm.set_moe_sharding(None)
    res["raised"] = np.array(raised)
    return res


def collectives_body(mesh, inp: dict) -> dict:
    """The partitioner's collectives on small tensors: ``gather_at_use``
    over each axis along dims 0 and 1, with each rank's own cotangent
    (the backward must sum them, then keep this rank's chunk); the plain
    ``gather`` of a column-split matrix; ``adamw.global_norm`` of placed
    leaves of every spec the LM uses."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    P = shd.P
    res = {}
    rank = torch.distributed.get_rank()
    full = torch.from_numpy(inp["mat"])                    # (8, 12)
    for axis in ("data", "model"):
        for dim in (0, 1):
            spec = P(axis, None) if dim == 0 else P(None, axis)
            local = shd.shard_of(full, mesh, spec).requires_grad_(True)
            got = shd.gather_at_use(local, mesh, axis, dim)
            w = torch.from_numpy(inp["w"][rank])
            (g,) = torch.autograd.grad((got * w).sum(), local)
            res[f"gather.{axis}.{dim}"] = got.detach().numpy()
            res[f"grad.{axis}.{dim}"] = g.numpy()
            res[f"plain.{axis}.{dim}"] = shd.gather(
                local.detach(), mesh, axis, dim).numpy()
    specs = {"wq": P("data", "model"), "wo": P("model", "data"),
             "embed": P(None, "model"), "ln": P(None), "bq": P("model")}
    tree = {n: torch.from_numpy(inp[f"norm.{n}"]) for n in specs}
    placed = shd.shard_params(tree, specs, mesh)
    res["norm"] = adamw.global_norm(placed, specs, mesh).numpy()
    res["norm_whole"] = adamw.global_norm(tree).numpy()
    return res


# ----------------------------------------------------------------------
# the MoE layer under the partitioner (tests/test_torch_mesh_moe.py)
# ----------------------------------------------------------------------

#: the moe suite's f32 cases, each held to the reference's single-device
#: step: (arch, LMConfig overrides, MoEConfig overrides). qwen2-moe's smoke
#: layer (6 experts, top-2, one shared expert) is EP on 2 model ranks and
#: expert TP on 4; dbrx's (4 experts) EP on both, its 2 kv heads gathered
#: on 4. At the test's 76 tokens capacity 1.25 binds (C = 32: one group
#: of 76, or two of 38, each spanning two of 4 data ranks), 8.0 does not
#: (C = 64 over one group).
MOE_CASES = {
    "qwen": ("qwen2-moe-a2.7b", {"remat": True}, {}),
    "qwen_g2": ("qwen2-moe-a2.7b", {}, {"groups": 2}),
    "dbrx_cf8": ("dbrx-132b", {}, {"capacity_factor": 8.0}),
}


def moe_case_cfg(case: str, dtype: str = "float32"):
    arch, over, moe_over = MOE_CASES[case]
    return lm_cfg(arch, dtype, over, moe_over)


def moe_body(mesh, inp: dict, case: str) -> dict:
    """:func:`lm_body` of a MoE case on the carried reference state
    (``moe.<case>``), with the prefill's routes, every group's ``dest``
    and its aux loss."""
    return lm_body(mesh, inp, MOE_CASES[case][0], "float32",
                   cfg=moe_case_cfg(case), key=f"moe.{case}", tok="moe.",
                   routes=Routes(), local=True)


def moe_bf16_body(mesh, inp: dict) -> dict:
    """qwen2-moe in bf16: the port's own step on whole tensors (``want.*``,
    its routes kept), then the placed one replaying those routes
    (``got.*``), from the same carried reference state."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding as shd
    args = dict(arch="qwen2-moe-a2.7b", dtype="bfloat16",
                cfg=lm_cfg("qwen2-moe-a2.7b", "bfloat16"), key="moe.qwen",
                tok="moe.")
    whole = Routes()
    want = lm_body(None, inp, routes=whole, **args)
    replay = Routes({k: [t for t in v] for k, v in whole.kept.items()})
    replay.d_index = shd._combined_index(mesh, shd.dp_axes(mesh))[0]
    got = lm_body(mesh, inp, routes=replay, local=True, **args)
    out = {f"want.{k}": v for k, v in want.items()}
    out.update({f"got.{k}": v for k, v in got.items()})
    return out


def moe_a2a_body(mesh, inp: dict) -> dict:
    """``set_moe_impl(make_a2a_moe(...))`` on a model placed on the mesh:
    the a2a reads plain tensors as global values, the placed model holds
    shards, so the layer raises ``NotImplementedError`` naming both."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.moe_a2a import make_a2a_moe
    cfg = lm_cfg("qwen2-moe-a2.7b", "float32")
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", mesh=mesh)
    toks = shd.local_shard(torch.from_numpy(inp["moe.fwd"]), mesh,
                           shd.P("data", None)).contiguous()
    try:
        tfm.set_moe_impl(make_a2a_moe(mesh, ("data",)))
        tfm.forward(model, toks)
        msg = "nothing raised"
    except NotImplementedError as e:
        msg = str(e)
    finally:
        tfm.set_moe_impl(None)
    return {"raised": np.array(msg)}


# ----------------------------------------------------------------------
# the GNN family, edge-parallel (tests/test_torch_mesh_gnn.py)
# ----------------------------------------------------------------------

#: the gnn suite's cases, each at its arch's smoke config and held to the
#: reference's single-device step: (arch, shape, edge mask)
GNN_CASES = {"sage": ("graphsage-reddit", "minibatch_lg", True),
             "sage_unmasked": ("graphsage-reddit", "minibatch_lg", False),
             "mgn": ("meshgraphnet", "full_graph_sm", True),
             "nequip": ("nequip", "molecule", True),
             "mace": ("mace", "molecule", True)}
#: the node-sharded suite's cases besides those: a graph of 27 nodes,
#: which no world divides, and NequIP under ``bf16_state`` (the dry run's
#: ``nodeshard_bf16``): (arch, shape, edge mask, config fields replaced,
#: batch sizes replaced)
NODE_CASES = {"sage_odd": ("graphsage-reddit", "minibatch_lg", True, {},
                           {"n": 27}),
              "nequip_bf16": ("nequip", "molecule", True,
                              {"bf16_state": True}, {})}
#: the one train step's AdamW settings (the reference's the same)
GNN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def gnn_case_of(case: str) -> tuple:
    """(arch, shape, edge mask, config fields replaced, batch sizes
    replaced) of a case of either suite."""
    if case in GNN_CASES:
        return (*GNN_CASES[case], {}, {})
    return NODE_CASES[case]


def gnn_case(inp: dict, case: str, mesh):
    """(spec, shape, cfg, model, batch) of a case: the smoke config, the
    reference's parameters carried in the inputs (``gnn.<case>.p.<name>``)
    on a model placed on ``mesh`` (replicated; whole where ``mesh`` is
    None) and the global batch (``gnn.<case>.b.<key>``)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import gnn
    from repro_torch.runtime import sharding as shd
    arch, shape, _, over, _ = gnn_case_of(case)
    spec = configs.get(arch)
    cfg = dataclasses.replace(configs.cell_model_cfg(spec, shape, smoke=True),
                              **over)
    model = gnn.model_of(cfg, device="cpu")
    pre, bpre = f"gnn.{case}.p.", f"gnn.{case}.b."
    model.load_state_dict({k[len(pre):]: torch.from_numpy(v)
                           for k, v in inp.items() if k.startswith(pre)})
    if mesh is not None:
        shd.shard_params(model, shd.gnn_param_specs(model), mesh)
    batch = {k[len(bpre):]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith(bpre)}
    return spec, shape, cfg, model, batch


def gnn_body(mesh, inp: dict, case: str) -> dict:
    """A GNN case on ``mesh`` (or whole with ``mesh`` None): the serve
    step's outputs; the loss and every parameter's gradient of this
    rank's edges (``gnn_batch_specs``), NequIP's and MACE's forces; one
    ``make_train_step`` step from a zero AdamW state: its metrics, every
    updated parameter and both moments (whole on every rank) and the
    collectives it made, as ``reduces`` (all-reduces), ``other_collectives``
    and ``calls`` (all-gathers, reduce-scatters, all-reduces)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    spec, shape, cfg, model, batch = gnn_case(inp, case, mesh)
    geo = isinstance(cfg, (gnn.NequIPConfig, gnn.MACEConfig))
    res = {}
    out = configs.make_serve_step(spec, shape, cfg, mesh=mesh)(model, batch)
    if geo:
        res["energy"], res["s"] = out[0].numpy(), out[1][0].float().numpy()
    else:
        res["out"] = out.numpy()
    specs = None if mesh is None else shd.gnn_batch_specs(batch, mesh)
    local = batch if mesh is None else {
        k: shd.local_shard(v, mesh, specs[k]).contiguous()
        for k, v in batch.items()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = configs.loss_for(spec, cfg)(model, local)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    res["grad_loss"] = loss.detach().numpy()
    res.update({f"grad.{n}": g.numpy() for n, g in zip(params, grads)})
    if geo:
        res["forces"] = gnn.energy_and_forces(model, local)[1].numpy()
    state = adamw.init_state(params)
    step = configs.make_train_step(spec, cfg, adamw.AdamWConfig(**GNN_OPT),
                                   mesh=mesh)
    shd.reset_collectives()
    _, state, m = step(model, state, batch)
    counts = shd.collective_counts()
    res["calls"] = np.array([counts.get(k, {}).get("calls", 0) for k in
                             ("all-gather", "reduce-scatter", "all-reduce")])
    res["reduces"] = np.array(counts.pop("all-reduce", {}).get("calls", 0))
    res["other_collectives"] = np.array(sum(c["calls"]
                                            for c in counts.values()))
    res.update({k: v.numpy() for k, v in m.items()})
    for what, tree in (("param", dict(model.named_parameters())),
                       ("mu", state["mu"]), ("nu", state["nu"])):
        res.update({f"{what}.{n}": t.detach().numpy()
                    for n, t in tree.items()})
    return res


def gnn_planted_body(mesh, inp: dict) -> dict:
    """GraphSAGE's masked serve step with a mean of the ranks' own means
    planted in place of the summed mean (``models.gnn.edge_mean``)."""
    from unittest import mock
    from repro_torch import configs
    from repro_torch.models import gnn
    spec, shape, cfg, model, batch = gnn_case(inp, "sage", mesh)

    def per_rank_mean(part, sums, counts):
        return part.agg(sums / counts.clamp_min(1.0)) / part.size

    with mock.patch.object(gnn, "edge_mean", per_rank_mean):
        out = configs.make_serve_step(spec, shape, cfg, mesh=mesh)(model,
                                                                   batch)
    return {"out": out.numpy()}


# ----------------------------------------------------------------------
# the GNNs node-sharded (tests/test_torch_mesh_nodeshard.py)
# ----------------------------------------------------------------------

def node_sharded(mesh):
    """A context in which the node-sharding hook is set as the dry run's
    ``nodeshard`` sets it, ``P(all_axes)`` on ``mesh``; reset after."""
    import contextlib
    from repro_torch.models import gnn
    from repro_torch.runtime import sharding as shd

    @contextlib.contextmanager
    def hooked():
        gnn.set_node_sharding(shd.named(mesh, shd.P(shd.all_axes(mesh))))
        try:
            yield
        finally:
            gnn.set_node_sharding(None)
    return hooked()


def nodeshard_body(mesh, inp: dict, case: str) -> dict:
    """:func:`gnn_body` under the node-sharding hook: the serve outputs
    and (s, V, T) are this rank's real node rows (the test concatenates
    the ranks' in rank order), the rest as there."""
    with node_sharded(mesh):
        return gnn_body(mesh, inp, case)


def nodeshard_agg_body(mesh, inp: dict) -> dict:
    """The node-sharded aggregation against the edge-parallel one: this
    rank's partial sums ``ns.partial[rank]`` (27 rows, padded to the
    world) summed over the mesh by ``NodeShard.agg`` (this rank's rows)
    and by ``EdgeShard.agg`` (all rows); GraphSAGE's first aggregated
    mean (``sage_odd``, its 27 nodes) in both variants, recorded at the
    hook's site; and the rows ``[lo, hi)`` this rank holds."""
    import torch
    import torch.distributed as dist
    from unittest import mock
    from repro_torch import configs
    from repro_torch.models import gnn
    part, edge = gnn.NodeShard(mesh), gnn.EdgeShard(mesh)
    x = torch.from_numpy(inp["ns.partial"][dist.get_rank()])
    x = part.whole(x)
    lo, hi = part._span(inp["ns.partial"].shape[1])
    res = {"node": part.agg(x).numpy(), "edge": edge.agg(x).numpy(),
           "span": np.array([lo, hi])}
    seen = []
    constrain = gnn._constrain_nodes

    def record(t, p=None):
        seen.append(t.detach().clone())
        return constrain(t, p)
    for name, hooked in (("sage.edge", False), ("sage.node", True)):
        spec, shape, cfg, model, batch = gnn_case(inp, "sage_odd", mesh)
        step = configs.make_serve_step(spec, shape, cfg, mesh=mesh)
        seen.clear()
        with mock.patch.object(gnn, "_constrain_nodes", record):
            if hooked:
                with node_sharded(mesh):
                    step(model, batch)
            else:
                step(model, batch)
        res[name] = seen[0].numpy()
    return res


# ----------------------------------------------------------------------
# MIND under the partitioner (tests/test_torch_mesh_mind.py)
# ----------------------------------------------------------------------

#: the one train step's AdamW settings (the reference's the same)
MIND_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def mind_model(mesh, inp: dict):
    """(spec, cfg, model): MIND's smoke config with the reference's
    weights carried from the inputs' ``mind.p.<name>``, this rank's shards
    of them on a model placed on ``mesh`` (whole where it is None)."""
    from repro_torch import configs
    from repro_torch.core.carry import mind_params_from_reference
    from repro_torch.models import recsys
    spec = configs.get("mind")
    cfg = spec.smoke_cfg
    tree = {n: inp[f"mind.p.{n}"] for n in ("item_embed", "S")}
    if mesh is None:
        model = recsys.MIND(cfg, device="cpu")
        model.load_state_dict(mind_params_from_reference(tree))
        return spec, cfg, model
    return spec, cfg, recsys.placed(
        cfg, mind_params_from_reference(tree, mesh), mesh)


def mind_batch(inp: dict, what: str) -> dict:
    import torch
    pre = f"mind.{what}."
    return {k[len(pre):]: torch.from_numpy(v) for k, v in inp.items()
            if k.startswith(pre)}


def data_rows(x, mesh):
    """This rank's rows over the data axes gathered whole (no gradient)."""
    from repro_torch.runtime import sharding as shd
    if mesh is None:
        return x
    sizes = shd.axis_sizes(mesh)
    return shd.gather_over(x, mesh, tuple(a for a in shd.dp_axes(mesh)
                                          if sizes[a] > 1))


def mind_body(mesh, inp: dict) -> dict:
    """The carried MIND on ``mesh`` (whole with None): serve_p99's scores
    (``mind.serve.*``), retrieval's (``mind.ret.*``), each gathered over
    the data axes; one ``make_train_step`` step (``mind.train.*``) from a
    zero AdamW state: its metrics, the collectives it made (``calls``:
    all-gathers, reduce-scatters, all-reduces, others), and every updated
    parameter and both moments gathered whole."""
    from repro_torch import configs
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    spec, cfg, model = mind_model(mesh, inp)
    res = {}
    for what, shape in (("serve", "serve_p99"), ("ret", "retrieval_cand")):
        out = configs.make_serve_step(spec, shape, cfg, mesh=mesh)(
            model, mind_batch(inp, what))
        res[what] = data_rows(out, mesh).numpy()
    params = dict(model.named_parameters())
    state = adamw.init_state(params)
    step = configs.make_train_step(spec, cfg, adamw.AdamWConfig(**MIND_OPT),
                                   mesh=mesh)
    shd.reset_collectives()
    _, state, m = step(model, state, mind_batch(inp, "train"))
    counts = shd.collective_counts()
    kinds = ("all-gather", "reduce-scatter", "all-reduce")
    res["calls"] = np.array([counts.get(k, {}).get("calls", 0) for k in kinds]
                            + [sum(c["calls"] for k, c in counts.items()
                                   if k not in kinds)])
    res.update({k: v.numpy() for k, v in m.items()})
    for what, tree in (("param", params), ("mu", state["mu"]),
                       ("nu", state["nu"])):
        if mesh is not None and shd.mesh_size(mesh) > 1:
            tree = shd.unshard_params(tree, shd.mind_param_specs(tree), mesh)
        res.update({f"{what}.{n}": t.detach().numpy()
                    for n, t in tree.items()})
    return res


def mind_planted_body(mesh, inp: dict) -> dict:
    """One train step's loss with a per-rank softmax planted in place of
    the global one: each data rank's users scored against its own targets
    only, the ranks' means averaged (a plain data-parallel step)."""
    import math
    from unittest import mock
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    spec, cfg, model = mind_model(mesh, inp)

    def per_rank(user, tgt, part=None):
        loss = recsys._InBatchSoftmax.apply(
            ops.matmul(user, tgt.t().contiguous()), None)
        if part is None or not part.dp:
            return loss
        sizes = shd.axis_sizes(part.mesh)
        return part.total(loss) / math.prod(sizes[a] for a in part.dp)

    step = configs.make_train_step(spec, cfg, adamw.AdamWConfig(**MIND_OPT),
                                   mesh=mesh)
    with mock.patch.object(recsys, "in_batch_softmax_loss", per_rank):
        _, _, m = step(model, adamw.init_state(dict(
            model.named_parameters())), mind_batch(inp, "train"))
    return {"loss": m["loss"].numpy()}


def card_operands() -> None:
    """Make B5's and B6's CPU paths refuse what their card wrappers refuse:
    operands that are not contiguous (the kernels read them with their
    shapes' strides), so a layout the card would reject fails here too."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    mm, attn = sm.matmul, fa.flash_attention

    def matmul(a, b):
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("the matmul kernel takes contiguous operands")
        return mm(a, b)

    def flash_attention(q, k, v, **kw):
        if not all(t.is_contiguous() for t in (q, k, v)):
            raise ValueError("the flash_attention kernel takes contiguous "
                             "q, k and v")
        return attn(q, k, v, **kw)

    sm.matmul, fa.flash_attention = matmul, flash_attention


SUITES = {"runtime": BODIES,
          "mesh": {"lm": lm_body, "bf16": bf16_body,
                   "codeqwen": codeqwen_body, "hooks": hooks_body,
                   "collectives": collectives_body},
          "moe": {**{case: (lambda mesh, inp, case=case:
                            moe_body(mesh, inp, case))
                     for case in MOE_CASES},
                  "moe_bf16": moe_bf16_body, "a2a_placed": moe_a2a_body},
          "gnn": {**{case: (lambda mesh, inp, case=case:
                            gnn_body(mesh, inp, case))
                     for case in GNN_CASES},
                  "planted": gnn_planted_body},
          "nodeshard": {**{case: (lambda mesh, inp, case=case:
                                  nodeshard_body(mesh, inp, case))
                           for case in ("sage", "mgn", "nequip", "mace",
                                        *NODE_CASES)},
                        "agg": nodeshard_agg_body},
          "mind": {"mind": lambda mesh, inp: mind_body(mesh, inp),
                   "planted": lambda mesh, inp: mind_planted_body(mesh,
                                                                  inp)}}
#: bodies of a suite run on only some meshes (the rest run on every one)
ONLY = {"bf16": ("2x2",), "codeqwen": ("2x2", "1x4"), "moe_bf16": ("2x2",),
        "a2a_placed": ("2x2",)}


def main(rank: int, world: int, store_path: str, inputs: str,
         out_prefix: str, suite: str = "runtime") -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    inp = dict(np.load(inputs))
    if suite in ("mesh", "moe", "gnn", "nodeshard", "mind"):
        card_operands()
    store = dist.FileStore(store_path, world)
    res = {}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu", store=store,
                         rank=rank)
        for name, body in SUITES[suite].items():
            if mesh_key(shape) not in ONLY.get(name, (mesh_key(shape),)):
                continue
            for k, v in body(mesh, inp).items():
                res[f"{name}|{mesh_key(shape)}|{k}"] = v
    np.savez(f"{out_prefix}.{rank}.npz", **res)
    dist.destroy_process_group()


def assemble(parts: list, spec, shape) -> np.ndarray:
    """The whole tensor from every rank's shard (rank r at ``divmod(r,
    model)`` of a ``(data, model)`` mesh of ``shape``) under ``spec``:
    each split dimension's chunks in the order of their axes' combined
    index, the first axis major."""
    coords = [dict(zip(("data", "model"), divmod(r, shape[1])))
              for r in range(len(parts))]
    sizes = dict(zip(("data", "model"), shape))
    spec = tuple(spec) + (None,) * (parts[0].ndim - len(spec))
    axes = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
            for e in spec]
    local = parts[0].shape
    out = np.empty([n * int(np.prod([sizes[a] for a in ax]))
                    for n, ax in zip(local, axes)], parts[0].dtype)
    for part, c in zip(parts, coords):
        where = []
        for n, ax in zip(local, axes):
            i = 0
            for a in ax:
                i = i * sizes[a] + c[a]
            where.append(slice(i * n, (i + 1) * n))
        out[tuple(where)] = part
    return out


def start_world(world: int, inputs: str, tmp: Path, suite: str = "runtime"):
    """:func:`main`'s ``world`` processes, started."""
    # one intra-op thread a rank: the ranks of a world share the cores,
    # and PyTorch's default pool, one thread a core in every rank, makes
    # each small op wait on the others' threads
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")])}
    store = tmp / f"store_{suite}_{world}"
    prefix = tmp / f"out_{suite}_{world}"
    return prefix, [subprocess.Popen(
        [sys.executable, "-m", "torch_rank_bodies", str(r), str(world),
         str(store), str(inputs), str(prefix), suite],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def wait_world(started, timeout: float = 240.0) -> list[dict]:
    """Each rank's results of a :func:`start_world`. Raises if a rank
    fails or the world outlives ``timeout`` seconds (counted from now)."""
    prefix, procs = started
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(logs))
    return [dict(np.load(f"{prefix}.{r}.npz")) for r in range(len(procs))]


def run_world(world: int, inputs: str, tmp: Path, timeout: float = 240.0,
              suite: str = "runtime") -> list[dict]:
    """Run :func:`main` on ``world`` processes; each rank's results. Raises
    if a rank fails or the world outlives ``timeout`` seconds."""
    return wait_world(start_world(world, inputs, tmp, suite), timeout)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], *sys.argv[6:7])
