"""Visualize what SDDS actually schedules: the command mix, stall sources,
and how each optimization changes the slot count — an ASCII rendition of
the paper's Figure 11 story on one matrix.  The twin of
``examples/espim_schedule_viz.py`` on the port's copies of the PIM
model (``repro_torch.core.{pim_sim, pruning, sdds}``: host numpy, no
device): the same output on the same seed.

Run:  PYTHONPATH=src python examples/espim_schedule_viz_torch.py
"""
import numpy as np

from repro_torch.core.pim_sim import espim_cycles, simulate_matrix
from repro_torch.core.pruning import magnitude_prune
from repro_torch.core.sdds import ESPIMConfig, schedule_matrix

rng = np.random.default_rng(0)
W = magnitude_prune(rng.standard_normal((352, 2048)), 0.9)
print(f"matrix 352x2048 @ 90% sparsity, nnz={int((W != 0).sum())}\n")

STEPS = [
    ("fine-grained base", dict(prefetch=False, reorder=False, balance=False)),
    ("+ decoupled prefetch", dict(reorder=False, balance=False)),
    ("+ switch reorder", dict(balance=False)),
    ("+ greedy balance", dict()),
    ("(16x11 brute switch)", dict(full_switch=True)),
]

base = None
print(f"{'configuration':24s} {'slots':>7s} {'br':>6s} {'stall':>6s} "
      f"{'dummy':>7s} {'cycles':>8s}  speedup   bar")
for name, kw in STEPS:
    cfg = ESPIMConfig(**kw)
    sched, _ = schedule_matrix(W, cfg)
    cyc = espim_cycles(sched, cfg).cycles
    if base is None:
        base = cyc
    bar = "#" * int(40 * cyc / base)
    print(f"{name:24s} {sched.compute_slots:7d} {sched.comp_br:6d} "
          f"{sched.comp_nobr:6d} {sched.dummy_cells:7d} {cyc:8.0f}  "
          f"{base / cyc:6.2f}x   {bar}")

print("\ncommand mix of the full configuration:")
cfg = ESPIMConfig()
sched, _ = schedule_matrix(W, cfg)
total = sched.column_reads
for cmd, n in (("COMP-BR (broadcast)", sched.comp_br),
               ("COMP-NoBR (stall)", sched.comp_nobr),
               ("LOAD-IDX (prefetch)", sched.load_idx)):
    print(f"  {cmd:22s} {n:6d}  {'#' * int(50 * n / total)}")
mac_slots = sched.compute_slots * cfg.n_banks * cfg.macs_per_bank
print(f"  MAC occupancy: {sched.mac_ops}/{mac_slots} slots = "
      f"{sched.mac_ops / mac_slots:.1%} "
      f"(dummy cells are the paper's statically scheduled bubbles)")

reps = simulate_matrix(W, cfg, archs=("espim", "newton"))
print(f"\nvs Newton: {reps['newton'].cycles / reps['espim'].cycles:.2f}x "
      f"speedup at 90% sparsity")
