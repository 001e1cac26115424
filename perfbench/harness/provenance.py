"""The lines a run prints before anything else: the card, its power limit
and clocks, the software, and the build hash of each of the program's
kernel libraries (the hash of its source and flags, in its file name)."""
from __future__ import annotations

import subprocess
import sys
import time

__all__ = ["lines", "SMI_FIELDS", "host_probe"]

SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm",
              "clocks.max.sm", "clocks.mem", "temperature.gpu",
              "driver_version")


def _smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if proc.returncode != 0:
        return f"nvidia-smi failed: {proc.stderr.strip()}"
    return proc.stdout.strip()


def lines(torch, cell) -> list:
    from repro_torch.kernels import build
    out = [f"[provenance] cell {cell.name}: config {cell.entry['config']}, "
           f"traffic {cell.entry['traffic']}, {cell.chips} chip(s)",
           f"[provenance] cards: {torch.cuda.device_count()} x "
           f"{torch.cuda.get_device_name(0)}"]
    for row in _smi().splitlines():
        out.append(f"[provenance] nvidia-smi ({', '.join(SMI_FIELDS)}): "
                   f"{row}")
    out.append(f"[provenance] python {sys.version.split()[0]}, torch "
               f"{torch.__version__}, cuda {torch.version.cuda}")
    for name in build.SOURCES:
        out.append(f"[provenance] kernel library {name}: "
                   f"{build.library_path(name).name}")
    return out


def host_probe(torch, device) -> str:
    """How fast this host runs the serving loop's kind of work just now:
    a fixed pure-Python loop, and 2000 launches of a tiny kernel (the
    host's launch path), each timed on the host's clock."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    py_ms = 1e3 * (time.perf_counter() - t0)
    x = torch.zeros(16, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    torch.cuda.synchronize()
    launch_us = 1e6 * (time.perf_counter() - t0) / 2000
    return (f"python loop {py_ms:.3f} ms, launch {launch_us:.3f} us "
            "(host probe)")
