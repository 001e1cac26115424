"""Quickstart of the PyTorch/CUDA port: the ESPIM pipeline end to end on
one weight matrix, the twin of ``examples/quickstart.py``.

  prune -> SparTen balance + column-chunked ELL pack
        -> ops.pack_to_device -> ops.espim_matvec with a 1-D x (the
           unbatched SpMV kernel on the GPU; its plain version on the CPU)
        -> SDDS cycle-level schedule -> PIM cycles + energy vs Newton.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The cycles and energy of step 4 come from the paper's PIM model (host
numpy), not from the device that ran step 3.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.energy import (espim_energy, gpu_dram_energy,
                                     newton_energy)
from repro_torch.core.pim_sim import simulate_matrix
from repro_torch.core.pruning import magnitude_prune
from repro_torch.core.sdds import ESPIMConfig, schedule_matrix
from repro_torch.core.sparse_format import pack_ell_chunked
from repro_torch.device import resolve_device
from repro_torch.kernels import espim_spmv as K
from repro_torch.kernels import ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the sparse MV (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # 1. a "trained" projection, magnitude-pruned to 90% (Section IV)
    w = magnitude_prune(rng.standard_normal((512, 2048)).astype(np.float32),
                        0.9)
    x = rng.standard_normal(2048).astype(np.float32)
    print(f"weight 512x2048, sparsity={(w == 0).mean():.2f}")

    # 2. offline packing: column-chunked ELL — each packed row's cells
    #    grouped by 512-wide column chunks of x
    pack = pack_ell_chunked(w, chunk_cols=512)
    print(f"packed: {pack.n_chunks} chunks x Lc={pack.chunk_width}, "
          f"padding(frac of slots acting as SDDS stalls)="
          f"{pack.stats.padding_frac:.2f}, x slab per chunk "
          f"{pack.plan.x_bytes_per_step}B (full x {pack.plan.x_bytes_full}B)")

    # 3. sparse MV on the device, checked against dense
    weights = ops.pack_to_device(pack, device=dev)
    K.reset_launches()
    y = ops.espim_matvec(weights, torch.tensor(x, device=dev))
    err = np.abs(y.cpu().numpy() - w @ x).max()
    how = (f"espim_spmv kernel, {K.LAUNCHES['espim_spmv']} launch"
           if dev.type == "cuda" else "plain version")
    print(f"espim_matvec on {dev} ({how}) vs dense matmul: max err "
          f"{err:.2e}")

    # 4. the paper's machine (PIM model on the host): SDDS schedule +
    #    cycle simulation vs Newton
    cfg = ESPIMConfig()
    sched, yv = schedule_matrix(w, cfg, values=w, x=x.astype(np.float64),
                                verify=True)
    print(f"SDDS: {sched.compute_slots} column slots "
          f"({sched.comp_br} broadcasts, {sched.comp_nobr} stalls, "
          f"{sched.load_idx} LOAD-IDX), dataflow err "
          f"{np.abs(yv - w @ x.astype(np.float64)).max():.2e}")

    reps = simulate_matrix(w, cfg, archs=("espim", "newton", "ideal_nonpim"))
    print(f"simulated PIM cycles: espim={reps['espim'].cycles:.0f} "
          f"newton={reps['newton'].cycles:.0f} "
          f"-> {reps['newton'].cycles / reps['espim'].cycles:.2f}x speedup")

    base = gpu_dram_energy(*w.shape).total
    ee = espim_energy(sched).normalized(base)
    en = newton_energy(w.shape[0], w.shape[1], int((w != 0).sum())
                       ).normalized(base)
    print(f"simulated energy vs conventional DRAM: espim={ee.total:.2f}x "
          f"newton={en.total:.2f}x ({(1 - ee.total / en.total) * 100:.0f}% "
          f"saved)")


if __name__ == "__main__":
    main()
