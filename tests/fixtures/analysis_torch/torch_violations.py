"""Seeded PyTorch-discipline violations — parsed by tests, never imported.

Expected findings (with this module on the hot-path list):
  * hot-path-transfer: .item(), .cpu(), .numpy(), .tolist(), .to("cpu"),
    .to(device="cpu") and torch.cuda.synchronize() (7)
  * silent-fallback: a swallowed build, a swallowed launch, a launch
    answered by the plain version (3)
  * cpu-fallback: an assigned, a returned and a passed CPU device, and a
    conditional expression (4)
"""

import torch

from repro_torch.kernels import label_prop, ref


def reads_back(flag, mask, dist):
    done = flag.item()                       # hot-path-transfer
    host = mask.cpu()                        # hot-path-transfer
    arr = host.numpy()                       # hot-path-transfer
    ids = dist.tolist()                      # hot-path-transfer
    cpu = dist.to("cpu")                     # hot-path-transfer
    cpu2 = dist.to(device="cpu")             # hot-path-transfer
    torch.cuda.synchronize()                 # hot-path-transfer
    return done, arr, ids, cpu, cpu2


def swallows_build():
    try:
        label_prop.build()
    except RuntimeError:                     # silent-fallback
        pass


def swallows_launch(lib, ptr):
    try:
        rc = lib.label_prop_round_launch(ptr)
    except OSError:                          # silent-fallback
        rc = 0
    return rc


def falls_back_to_plain(labels, link_l, link_r, link_p, active, lib):
    try:
        lib = label_prop._library()[0]
        return lib
    except OSError:                          # silent-fallback
        return ref.label_prop_round(labels, link_l, link_r, link_p, active)


def picks_cpu(x):
    if torch.cuda.is_available():
        dev = "cuda"
    else:
        dev = "cpu"                          # cpu-fallback
    return x.to(dev)


def returns_cpu():
    if not torch.cuda.is_available():
        return torch.device("cpu")           # cpu-fallback
    return torch.device("cuda")


def passes_cpu(build):
    if not torch.cuda.is_available():
        return build(device="cpu")           # cpu-fallback
    return build(device="cuda")


def chooses_cpu():
    return "cuda" if torch.cuda.is_available() else "cpu"   # cpu-fallback
