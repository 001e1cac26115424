"""Energy and area models (Figure 14, Table IV).

Units: one open-row 256-bit column read = 1.0 energy unit.  Anchors taken
from the paper:

* PIM compute for a full column's worth of MACs costs ~4x a column read
  (Section IV "Energy and area") -> e_mac = 4/16 per MAC operation.
* Pin I/O per 256 bits costs ~0.8 units, chosen so dense Newton lands at
  ~2.8x the conventional-DRAM (GPU) energy (Section V-E: "Newton's dense
  matrix energy overhead of around 1.8x is almost entirely due to its
  compute", on top of the 1.0 access).
* Newton gates its MACs on zero values (Section V-E) but still pays access
  for the full uncompressed matrix.
* ESPIM's "rest" = iFIFO/eFIFO flip-flop pushes + switch traversals; the
  paper notes its flip-flop FIFOs make this conservative.

Area (Table IV): per-MAC area = 25%/16 of a DRAM die; FIFO area scales with
bit count calibrated on the eFIFO row (11 FIFOs x 8 entries x 16 bits =
7.1%); switch + other logic constants from the table.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sdds import ESPIMConfig, Schedule

__all__ = ["EnergyConfig", "EnergyReport", "espim_energy", "newton_energy",
           "gpu_dram_energy", "AreaModel", "area_table"]


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    e_col: float = 1.0            # 256-bit open-row column read
    e_pin_256b: float = 0.8       # host<->DRAM pin transfer per 256 bits
    e_mac: float = 4.0 / 16.0     # per MAC op (4x col read per 16-MAC column)
    e_bcast: float = 0.25         # vector-slice broadcast to all banks
    e_fifo_push: float = 0.012    # flip-flop FIFO push (iFIFO or eFIFO)
    e_switch: float = 0.008       # one 4-to-1 mux traversal


@dataclasses.dataclass
class EnergyReport:
    arch: str
    access: float
    compute: float
    rest: float

    @property
    def total(self) -> float:
        return self.access + self.compute + self.rest

    def normalized(self, baseline: float) -> "EnergyReport":
        return EnergyReport(
            self.arch,
            self.access / baseline,
            self.compute / baseline,
            self.rest / baseline,
        )


def _pin_energy(n_bytes: float, ecfg: EnergyConfig) -> float:
    return n_bytes * 8 / 256 * ecfg.e_pin_256b


def gpu_dram_energy(
    n_rows: int, n_cols: int, cfg: ESPIMConfig = ESPIMConfig(),
    ecfg: EnergyConfig = EnergyConfig(),
) -> EnergyReport:
    """Conventional-DRAM energy for the GPU reading the full dense matrix
    (the Figure 14 normalizer).  Compute energy on the GPU side is
    conservatively ignored, as in the paper."""
    cells = n_rows * n_cols
    col_reads = cells / cfg.dense_macs_per_bank
    access = col_reads * ecfg.e_col + _pin_energy(cells * 2, ecfg)
    return EnergyReport("gpu", access, 0.0, 0.0)


def newton_energy(
    n_rows: int, n_cols: int, nnz: int,
    cfg: ESPIMConfig = ESPIMConfig(), ecfg: EnergyConfig = EnergyConfig(),
) -> EnergyReport:
    """Newton on an (uncompressed) sparse matrix with zero-gated MACs."""
    cells = n_rows * n_cols
    col_reads = cells / cfg.dense_macs_per_bank
    n_vr = max(1, -(-n_cols // cfg.vector_row_elems))
    access = (
        col_reads * ecfg.e_col
        + col_reads * ecfg.e_bcast           # one broadcast per column read
        + _pin_energy(n_cols * 2, ecfg)      # vector load
        + _pin_energy(n_rows * n_vr * 2, ecfg)  # partial-result readout
    )
    compute = nnz * ecfg.e_mac               # zero-gated
    return EnergyReport("newton", access, compute, 0.0)


def espim_energy(
    sched: Schedule, cfg: ESPIMConfig = ESPIMConfig(),
    ecfg: EnergyConfig = EnergyConfig(),
) -> EnergyReport:
    # column_reads are global lockstep *slots*: every bank reads one column
    # per slot, so access energy scales by n_banks.  The broadcast is one
    # shared-bus drive per COMP-BR slot.
    access = (
        sched.column_reads * cfg.n_banks * ecfg.e_col
        + sched.broadcasts * ecfg.e_bcast
        + _pin_energy(sched.load_gb_bytes, ecfg)
        + _pin_energy(sched.rdres_elems * 2, ecfg)
    )
    compute = sched.mac_ops * ecfg.e_mac
    rest = (
        (sched.ififo_pushes + sched.efifo_pushes) * ecfg.e_fifo_push
        + sched.efifo_pushes * ecfg.e_switch
    )
    return EnergyReport("espim", access, compute, rest)


# --------------------------------------------------------------------------
# Area (Table IV)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AreaModel:
    """Component areas as fractions of a conventional DRAM die."""

    mac_area: float = 0.25 / 16          # one MAC (from Newton's 25% / 16)
    fifo_area_per_bit: float = 0.071 / (11 * 8 * 16)  # eFIFO row calibration
    ififo_ctl_per_fifo: float = 0.0004   # valid/start handling (iFIFO only)
    switch_other_sparse: float = 0.030   # 11x 16b 4-1 mux + other logic
    switch_other_flex: float = 0.041     # + dense/sparse input muxing

    def espim(self, cfg: ESPIMConfig = ESPIMConfig(), flexible: bool = False) -> dict:
        k = cfg.macs_per_bank
        n_macs = cfg.dense_macs_per_bank if flexible else k
        ififo_bits = k * cfg.fifo_depth * 7    # idx(4) + valid + start + select
        efifo_bits = k * cfg.fifo_depth * 16   # FP16 elements
        comp = {
            "macs": n_macs * self.mac_area,
            "ififo": ififo_bits * self.fifo_area_per_bit
            + k * self.ififo_ctl_per_fifo,
            "efifo": efifo_bits * self.fifo_area_per_bit,
            "switch_other": (
                self.switch_other_flex if flexible else self.switch_other_sparse
            ),
        }
        comp["total"] = sum(comp.values())
        return comp

    def newton(self, cfg: ESPIMConfig = ESPIMConfig()) -> dict:
        return {"macs": cfg.dense_macs_per_bank * self.mac_area,
                "total": cfg.dense_macs_per_bank * self.mac_area}


def area_table(cfg: ESPIMConfig = ESPIMConfig()) -> dict:
    """Reproduce Table IV: area over conventional DRAM for Newton, ESPIM
    sparse-only, and the flexible sparse+dense configuration."""
    m = AreaModel()
    newton = m.newton(cfg)
    sparse = m.espim(cfg, flexible=False)
    flex = m.espim(cfg, flexible=True)
    return {
        "newton": newton,
        "espim_sparse_only": sparse,
        "espim_flexible": flex,
        "espim_over_newton_sparse_only": sparse["total"] - newton["total"],
        "espim_over_newton_flexible": flex["total"] - newton["total"],
    }
