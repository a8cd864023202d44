"""Clean PyTorch usage — the negatives: none of this may be flagged, even
with this module on the hot-path list."""

import torch

from repro_torch.kernels import label_prop


def stays_on_the_card(labels, mask):
    n = labels.shape[1]                      # metadata, no transfer
    kept = mask.to(torch.int32)              # a dtype cast, on the card
    moved = mask.to(labels.device)           # a device the caller chose
    # repro: ignore[hot-path-transfer] — the one measured flag read
    done = bool(kept.sum().item())
    return n, moved, done


def surfaces_build_errors():
    try:
        label_prop.build()
    except OSError as e:
        raise RuntimeError("the label_prop kernel did not build") from e


def hands_the_error_on(fut, build):
    try:
        fut.set_result(build())
    except BaseException as exc:
        fut.set_exception(exc)


def other_work_may_fall_back(path):
    try:
        with open(path) as f:                # no build or launch inside
            return f.read()
    except OSError:
        return ""


def raises_without_a_card(device):
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA run needs a card; none is visible")
    return torch.device(device)


def reads_the_card_when_present(hw):
    if torch.cuda.is_available():
        hw["card"] = torch.cuda.get_device_name(0)
    return hw
