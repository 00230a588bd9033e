"""The cards a run asks for, and what the result line says about them."""

import gc
import subprocess

import torch


class NoCard(Exception):
    pass


def require(chips):
    """Fail unless ``chips`` CUDA cards are visible; never the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "runs on NVIDIA cards only")
    n = torch.cuda.device_count()
    if n < chips:
        raise NoCard(f"the cell asks for {chips} cards, {n} visible")


def card(rank=0):
    """The device a rank runs on: its card."""
    return torch.device("cuda", rank)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def pinned_copy(t):
    """A host copy of ``t``, in pinned memory where a card is used."""
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda").copy_(t)


def quiesce(device):
    """Before a window: wait for the device, collect the set-up's garbage
    and freeze what survives, so that no collection inside the window
    walks the set-up's objects (a gen-2 pass over them stalled a step by
    140-260 ms on the card's host)."""
    sync(device)
    gc.collect()
    gc.freeze()


def describe(count, peak_bytes):
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"
    return {"platform": "gpu", "kind": kind,
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_line():
    """``nvidia-smi``'s name and power limit of each card, one line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        text = out.stdout.strip().replace("\n", "; ")
        return text or f"nvidia-smi: {out.stderr.strip()[:200]}"
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
