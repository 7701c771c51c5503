"""What the repo's ablation and A/B scripts share.

`attention_ablation.py`, `resample_ablation.py`, `rle_ablation.py` and
`jpeg_route_bench.py` (at the repository's root, run on a CUDA card)
build patched copies of a kernel's source and time them beside the
package's own: `patched` applies a script's patch strings to a source
and stops the script where a string no longer matches, `build_variants`
starts one nvcc for each copy, all together, into
`csrc/build/ablation/`, `queued_ms` times a call on the device alone and
`card` gives the card's name and power limit for the record.  Nothing
in the package imports this module.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Iterable, Sequence, Tuple

from . import _build

__all__ = ["SPIN_CYCLES", "patched", "build_variants", "queued_ms", "card"]

SPIN_CYCLES = 20_000_000


def patched(text: str, patches: Iterable[Tuple[str, str]], name: str) -> str:
    """`text` with each (old, new) replaced; stops the script when `old`
    is no longer in the source, so a stale patch cannot time the
    package's own kernel under another name."""
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(texts: Dict[str, str], stem: str,
                   flags: Sequence[str] = ()) -> Dict[str, ctypes.CDLL]:
    """name -> loaded library of each CUDA source text, built by one nvcc
    each, all started together; prints each build's ptxas register
    lines."""
    out_dir = os.path.join(_build.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(cu, "w", encoding="utf-8") as f:
            f.write(text)
        so = os.path.join(out_dir, f"{stem}_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        print(f"[build] {stem} {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one fn(): events around `iters` calls enqueued while
    a spin kernel holds the card, so the host's launch cost is hidden."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The first card's `name, power limit` as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
