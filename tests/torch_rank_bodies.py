"""Rank bodies of the port's multi-rank CPU tests
(``tests/test_torch_runtime.py``, ``tests/test_torch_mesh.py``).

Each of ``world`` processes runs::

    python -m torch_rank_bodies <rank> <world> <store file> <inputs.npz> <out prefix> <suite>

joins a gloo group of ``world`` ranks through a ``FileStore``, builds every
mesh of :data:`MESHES` for its world size, runs each body of the suite
(:data:`SUITES`: ``runtime`` or ``mesh``) on each mesh and writes its
results to ``<out prefix>.<rank>.npz``, keyed ``<body>|<mesh>|<name>``.
Only ``torch`` and the port are imported here; the test compares the
results with the reference and with single-device answers.
:func:`run_world` starts the processes and waits for them, each under a
hard timeout, killing them all if one fails or hangs.
"""

from __future__ import annotations

import os
import subprocess
import sys
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


BODIES = {"vp": vp_take_body, "a2a": a2a_body, "compress": compress_body}


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


def lm_cfg(arch: str, dtype: str):
    """The arch's smoke config in ``dtype`` (glm4's: n_head 4 over n_kv 2,
    d_model 64, the reference's sharded test's shapes; codeqwen's: 4 over
    4)."""
    import dataclasses
    import torch
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch).smoke_cfg,
                               dtype=getattr(torch, dtype))


def placed_model(mesh, inp: dict, arch: str, dtype: str):
    """The carried reference parameters (``<arch>.<dtype>.p``), this
    rank's shards of them (``lm_params_from_reference(tree, mesh)``), as a
    placed model."""
    from repro_torch.core.carry import lm_params_from_reference
    from repro_torch.models import transformer as tfm
    cfg = lm_cfg(arch, dtype)
    shards = lm_params_from_reference(tree_of(inp, f"{arch}.{dtype}.p"),
                                      mesh)
    meta = dict(tfm.Transformer(cfg, device="meta").named_parameters())
    return cfg, tfm.placed(cfg, {n: t.to(meta[n].dtype)
                                 for n, t in shards.items()}, mesh)


def gathered_logits(x, mesh):
    """Logits split (data rows, model columns) gathered whole."""
    from repro_torch.runtime import sharding as shd
    return shd.gather(shd.gather(x, mesh, "model", dim=-1), mesh, "data")


def lm_body(mesh, inp: dict, arch: str = "glm4-9b",
            dtype: str = "float32") -> dict:
    """The carried model (the reference's after one step, with its AdamW
    state): the prefill's logits and four decode steps from an empty
    cache of ``lm_cache_spec``'s layout, gathered; then one train step:
    its metrics, every updated parameter and both moments, gathered."""
    import torch
    from repro_torch import configs
    from repro_torch.core.carry import adamw_state_from_reference
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    spec = configs.get(arch)
    cfg, model = placed_model(mesh, inp, arch, dtype)
    pre = f"{arch}.{dtype}"
    res = {}
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)
    logits = prefill(model, {"tokens": torch.from_numpy(inp["fwd"])})
    res["logits"] = gathered_logits(logits, mesh).numpy()
    decode = configs.make_serve_step(spec, "decode_32k", cfg, mesh=mesh)
    dec = torch.from_numpy(inp["dec"])
    cache = tfm.init_cache(cfg, dec.shape[1], dec.shape[0] + 2,
                           device="cpu", mesh=mesh)
    for i in range(dec.shape[0]):
        out, cache = decode(model, {"tokens": dec[i], "cache": cache,
                                    "cache_len": i})
        res[f"decode.{i}"] = gathered_logits(out, mesh).numpy()
    state = adamw_state_from_reference(
        {"mu": tree_of(inp, f"{pre}.mu"), "nu": tree_of(inp, f"{pre}.nu"),
         "step": inp[f"{pre}.step"]}, mesh)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
    batch = {k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")}
    shd.reset_collectives()
    _, state, m = step(model, state, batch)
    counts = shd.collective_counts()
    res.update({k: v.numpy() for k, v in m.items()})
    res["calls"] = np.array([counts.get(k, {}).get("calls", 0) for k in
                             ("all-gather", "reduce-scatter", "all-reduce")])
    specs = shd.lm_param_spec_tree(tfm.abstract_params(cfg), mesh)
    for what, tree in (("param", dict(model.named_parameters())),
                       ("mu", state["mu"]), ("nu", state["nu"])):
        for n, t in shd.unshard_params(tree, specs, mesh).items():
            res[f"{what}.{n}"] = t.float().numpy()
    return res


def bf16_body(mesh, inp: dict) -> dict:
    return lm_body(mesh, inp, dtype="bfloat16")


def codeqwen_body(mesh, inp: dict) -> dict:
    return lm_body(mesh, inp, arch="codeqwen1.5-7b")


def hooks_body(mesh, inp: dict) -> dict:
    """The hooks on a placed model: the residual's ``P(dp, None, None)``
    and the gathered-at-use weights the partitioner produces check clean
    (logits equal to the run without hooks); the dry run's ``seqshard``
    ``P(dp, "model", None)`` and a MoE placement raise
    ``NotImplementedError`` naming the spec, as a MoE model placed on more
    than one rank does."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding as shd
    P = shd.P
    cfg, model = placed_model(mesh, inp, "glm4-9b", "float32")
    toks = shd.local_shard(torch.from_numpy(inp["fwd"]), mesh,
                           P("data", None)).contiguous()
    want, _ = tfm.forward(model, toks)
    res = {}
    kv = P(None, "model") if cfg.n_kv % shd.axis_sizes(mesh)["model"] == 0         else P(None, None)
    table = {"attn.wq": P(None, "model"), "attn.wk": kv, "attn.wv": kv,
             "attn.wo": P("model", None), "ffn.wi": P(None, "model"),
             "ffn.wg": P(None, "model"), "ffn.wo": P("model", None)}
    try:
        tfm.set_activation_sharding(shd.named(mesh, P("data", None, None)))
        tfm.set_weight_use_sharding({k: shd.named(mesh, v)
                                     for k, v in table.items()})
        got, _ = tfm.forward(model, toks)
        res["hooked_equal"] = np.array(torch.equal(got, want))
        raised = []
        for what, setup in (
                ("seqshard", lambda: tfm.set_activation_sharding(
                    shd.named(mesh, P("data", "model", None)))),
                ("moe", lambda: tfm.set_moe_sharding(
                    (shd.named(mesh, P(None, "data", None)),
                     shd.named(mesh, P(None, "data", "model")))))):
            tfm.set_activation_sharding(None)
            setup()
            try:
                if what == "moe":
                    tfm.check_layout(torch.zeros(4, 8, 64),
                                     tfm.MOE_SHARDING[0])
                else:
                    tfm.forward(model, toks)
                raised.append(f"{what}: nothing raised")
            except NotImplementedError as e:
                raised.append(f"{what}: {e}")
    finally:
        tfm.set_activation_sharding(None)
        tfm.set_weight_use_sharding(None)
        tfm.set_moe_sharding(None)
    moe = dataclasses.replace(configs.get("qwen2-moe-a2.7b").smoke_cfg,
                              dtype=torch.float32)
    try:
        tfm.init_params(moe, torch.Generator().manual_seed(0), device="cpu",
                        mesh=mesh)
        raised.append("moe model: nothing raised")
    except NotImplementedError as e:
        raised.append(f"moe model: {e}")
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
                   "collectives": collectives_body}}
#: bodies of a suite run on only some meshes (the rest run on every one)
ONLY = {"bf16": ("2x2",), "codeqwen": ("2x2", "1x4")}


def main(rank: int, world: int, store_path: str, inputs: str,
         out_prefix: str, suite: str = "runtime") -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    inp = dict(np.load(inputs))
    if suite == "mesh":
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


def run_world(world: int, inputs: str, tmp: Path, timeout: float = 240.0,
              suite: str = "runtime") -> list[dict]:
    """Run :func:`main` on ``world`` processes; each rank's results. Raises
    if a rank fails or the world outlives ``timeout`` seconds."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")])}
    store = tmp / f"store_{suite}_{world}"
    prefix = tmp / f"out_{suite}_{world}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_rank_bodies", str(r), str(world),
         str(store), str(inputs), str(prefix), suite],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(logs))
    return [dict(np.load(f"{prefix}.{r}.npz")) for r in range(world)]


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], *sys.argv[6:7])
