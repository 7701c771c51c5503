"""The card: its published peaks, the check that the cell's cards are
there, and what the result line says of them."""
from __future__ import annotations

import subprocess
import sys
from typing import Dict

import torch

__all__ = ["BF16_FLOPS", "HBM_BYTES_PER_S", "require_cards", "describe",
           "power_limit"]

# one NVIDIA H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate
# and HBM3 bandwidth (at the 700 W limit)
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


class NoCards(RuntimeError):
    pass


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCards("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCards(f"the cell needs {n} card(s), "
                      f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def describe(n: int) -> Dict[str, object]:
    """The result's `device`: platform, the card's name, the cards used
    and the allocator's peak on the fullest of them."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": n,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n, "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
