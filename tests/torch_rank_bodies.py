"""Rank bodies of the port's multi-rank CPU tests
(``tests/test_torch_runtime.py``).

Each of ``world`` processes runs::

    python -m torch_rank_bodies <rank> <world> <store file> <inputs.npz> <out prefix>

joins a gloo group of ``world`` ranks through a ``FileStore``, builds every
mesh of :data:`MESHES` for its world size, runs each body on each mesh and
writes its results to ``<out prefix>.<rank>.npz``, keyed
``<body>|<mesh>|<name>``. Only ``torch`` and the port are imported here;
the test compares the results with the reference and with single-device
answers. :func:`run_world` starts the processes and waits for them, each
under a hard timeout, killing them all if one fails or hangs.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

#: the (data, model) meshes built at each world size
MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4), (4, 1)]}

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


def main(rank: int, world: int, store_path: str, inputs: str,
         out_prefix: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    inp = dict(np.load(inputs))
    store = dist.FileStore(store_path, world)
    res = {}
    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu", store=store,
                         rank=rank)
        for name, body in BODIES.items():
            for k, v in body(mesh, inp).items():
                res[f"{name}|{mesh_key(shape)}|{k}"] = v
    np.savez(f"{out_prefix}.{rank}.npz", **res)
    dist.destroy_process_group()


def run_world(world: int, inputs: str, tmp: Path, timeout: float = 240.0
              ) -> list[dict]:
    """Run :func:`main` on ``world`` processes; each rank's results. Raises
    if a rank fails or the world outlives ``timeout`` seconds."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")])}
    store = tmp / f"store_{world}"
    prefix = tmp / f"out_{world}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_rank_bodies", str(r), str(world),
         str(store), str(inputs), str(prefix)],
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
         sys.argv[5])
