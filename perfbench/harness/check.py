"""What decides ``correct``: the served tokens of a sample of the requests
the window finished, held against the plain reference.

Once the window has closed and the program's state is freed, the
reference makes the run's weights again from the seed, works out what the
deployment serves from them (pruning and the value codes,
``reference/espim_pack.py``), and runs each sampled request's prompt and
served tokens through one causal float32 pass (the family's
``forward_logits``).  The number compared is the widest gap by which a
served token's logit lies below the reference's best at its position.
Every request finished in the window must also have served its whole
output.

A cell's control (``cells/<workload>.json``, ``control``) is either the
program's own lower-precision path (``program_quant``), judged as above,
or the reference with its weights coded lower (``reference_code``), whose
best token at each served position then stands in for the served one.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import espim_pack
from perfbench.reference.common import fp32_exact, serve_gaps

__all__ = ["sample", "ReferenceModel", "gap_readings"]

_SAMPLE = 3             # seed-sequence tag of the sample draw


def sample(records: list, seed: int, n: int) -> list:
    """The longest of ``records`` (prompt + output) and n - 1 others
    drawn from the seed, in finish order."""
    if len(records) <= n:
        return list(records)
    longest = max(range(len(records)),
                  key=lambda i: (records[i].prompt_len + records[i].n_out,
                                 -i))
    rest = [i for i in range(len(records)) if i != longest]
    s = int(seed) % 2 ** 64
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, _SAMPLE])
    pick = rng.choice(len(rest), size=n - 1, replace=False)
    keep = sorted([longest] + [rest[int(i)] for i in pick])
    return [records[i] for i in keep]


class ReferenceModel:
    """The cell's model as the deployment serves it, in float32: the
    weights of ``seed`` made again, then pruned and coded as the
    configuration's ``serving`` section says."""

    def __init__(self, cell, dims, table_rows: int, seed: int, device):
        fam = self.family = cell.family
        raw = fam.make_weights(dims, table_rows, seed, device)
        serving = cell.config["serving"]
        projs = {name: raw.pop(name) for name, *_ in fam.PROJECTIONS}
        if serving.get("sparse"):
            served, self.nnz = espim_pack.served_projections(
                projs, fam.GROUPS, float(serving["sparsity"]), cell.codes,
                int(serving["chunk_cols"]))
        else:
            served = {n: w.float() for n, w in projs.items()}
            self.nnz = None
        del projs
        self.w = {n: t.float() for n, t in raw.items()}
        self.w.update(served)
        self.dims = dims

    def logits(self, rec, weights: dict | None = None) -> torch.Tensor:
        """Logits at the positions that chose each of ``rec``'s served
        tokens, (n_out, vocab)."""
        tokens = torch.tensor(list(rec.prompt) + list(rec.req.output[:-1]),
                              dtype=torch.long)
        return self.family.forward_logits(weights or self.w, self.dims,
                                          tokens, first=rec.prompt_len - 1)


def gap_readings(ref: ReferenceModel, records: list,
                 control: dict | None = None) -> dict:
    """{"widest", "mean", "tokens", "off_best"} of the gaps of the served
    tokens of ``records``; with ``control`` (weights), under ``"control"``
    the same of the tokens the control model puts first at the same
    positions."""
    gaps, ctl = [], []
    with fp32_exact(), torch.no_grad():
        for rec in records:
            lg = ref.logits(rec)
            served = torch.tensor(rec.req.output, dtype=torch.long)
            gaps.append(serve_gaps(lg, served).cpu())
            if control is not None:
                best = ref.logits(rec, control).argmax(dim=-1)
                ctl.append(serve_gaps(lg, best).cpu())
    out = _summary(gaps)
    if control is not None:
        out["control"] = _summary(ctl)
    return out


def _summary(parts: list) -> dict:
    g = torch.cat(parts) if parts else torch.zeros(0)
    if g.numel() == 0:
        return {"widest": None, "mean": None, "tokens": 0, "off_best": 0}
    return {"widest": float(g.max()), "mean": float(g.mean()),
            "tokens": int(g.numel()), "off_best": int((g > 0).sum())}
