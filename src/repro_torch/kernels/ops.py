"""The kernels package's public ops: the reference's signatures and
errors (``src/repro/kernels/ops.py``), dispatching between the
hand-written CUDA kernels and their plain PyTorch versions, and the
packed-weights API (``EspimWeights``, ``QuantEspimWeights``,
``pack_to_device``, ``espim_matvec``).

Dispatch, per call, on ``impl``:

* ``None`` — the kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"cuda"`` — the kernel; a CPU tensor raises;
* ``"ref"`` — the plain version on any device (the parity reference).

``ESPIM_IMPL=ref|cuda`` in the environment pins the whole process and
wins over every per-call ``impl=``, as in the reference; ``ref`` hides
every kernel (``Provenance.env`` records the pin), and an unknown value
raises.  ``provenance()`` names where a call would run right now.

A CUDA tensor never silently takes the plain version: a build or launch
failure raises.  Both the column-chunked ``(R_pad, K, Lc)`` layout and
the plain ``(R_pad, L)`` ELL layout are accepted, the array rank selects
the family; only the chunked family has kernels, so a plain pack needs
``impl="ref"``, as the reference's plain packs need its ref lowering.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.sdds import KernelSchedule
from repro_torch.core.sparse_format import ELLChunkedPack, ELLPack, chunk_pack
from repro_torch.device import resolve_device
from repro_torch.kernels import dense_mv as _dk
from repro_torch.kernels import espim_spmv as _k
from repro_torch.kernels import ref as _ref
from repro_torch.telemetry.trace import get_tracer

__all__ = ["espim_spmv", "espim_spmv_batched", "espim_spmv_batched_quant",
           "espim_spmv_group", "dense_mv", "espim_matvec", "EspimWeights",
           "QuantEspimWeights", "pack_to_device", "Provenance", "provenance",
           "DEFAULT_CHUNK_COLS", "IMPLS", "ENV_IMPL", "ENV_PLAN_CACHE"]

DEFAULT_CHUNK_COLS = 512
IMPLS = (None, "cuda", "ref")

# Environment overrides, so runs can pin the implementation explicitly:
#   ESPIM_IMPL=ref|cuda     force the lowering everywhere (wins over
#                           per-call ``impl=`` arguments — that is the
#                           point: pin the whole process)
#   ESPIM_PLAN_CACHE=PATH   the autotuner's on-disk plan cache
#                           (``autotune.cache``), recorded beside the pin
ENV_IMPL = "ESPIM_IMPL"
ENV_PLAN_CACHE = "ESPIM_PLAN_CACHE"

_PLAIN_REF_ONLY = ("the kernels consume the column-chunked layout; re-pack "
                   "with pack_ell_chunked (plain ELL is ref-only: "
                   "impl='ref')")


def _check_impl(impl) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (None | 'cuda' | 'ref')")


def _resolve(impl: str | None) -> str | None:
    """The impl a call runs: the ``ESPIM_IMPL`` pin when set (``ref`` or
    ``cuda``; anything else raises), else the caller's ``impl``."""
    env = os.environ.get(ENV_IMPL, "").strip()
    if env:
        if env not in ("cuda", "ref"):
            raise ValueError(f"unknown {ENV_IMPL}={env!r} (cuda | ref)")
        impl = env
    _check_impl(impl)
    return impl


def _use_kernel(impl: str | None, *tensors) -> bool:
    """True when this call launches the CUDA kernel; ``impl`` is already
    resolved (``_resolve``: the pin is read once a call)."""
    if impl == "ref":
        return False
    on_cuda = any(t is not None and t.is_cuda for t in tensors)
    if impl == "cuda" and not on_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; use impl='ref' "
                         "(or None) for tensors on the CPU")
    return on_cuda


def _check_chunk_cols(cols, x, chunk_cols) -> int:
    if chunk_cols is None:
        raise ValueError(
            "chunk_cols is required for the chunked (R_pad, K, Lc) layout; "
            f"got cols of shape {tuple(cols.shape)}")
    cc = int(chunk_cols)
    n_chunks = cols.shape[1]
    if n_chunks > 1 and n_chunks * cc - x.shape[0] >= cc:
        # the last chunk would sit entirely past x: chunk_cols cannot be
        # the width this pack was built with (silent-corruption guard)
        raise ValueError(
            f"chunk_cols={cc} inconsistent with pack: {n_chunks} chunks x "
            f"{cc} cols span past x of length {x.shape[0]}")
    return cc


def _sched_kw(schedule: KernelSchedule | None) -> dict:
    """The streaming kernels' launch knobs from a tuned schedule (``None``
    keeps the wrappers' defaults — the launch before schedules existed).
    ``chunk_cols`` stays the pack's: re-chunking is an offline transform,
    not a launch knob."""
    if schedule is None:
        return {}
    return {"wpr": schedule.warps_per_row, "u": schedule.u}


def _dispatch_spmv(values, cols, x, chunk_cols, impl, plain_ref,
                   chunked_ref, kernel, kernel_kw: dict) -> torch.Tensor:
    """Layout/impl dispatch shared by the (un)batched ops: plain
    (R_pad, L) packs take the plain version (``impl="ref"`` only);
    chunked (R_pad, K, Lc) packs take the kernel or the chunked plain
    version."""
    impl = _resolve(impl)
    if values.dim() == 2:
        if impl != "ref":
            raise ValueError(_PLAIN_REF_ONLY)
        return plain_ref(values, cols, x)
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if _use_kernel(impl, values, cols, x):
        return kernel(values, cols, x, chunk_cols=cc, **kernel_kw)
    return chunked_ref(values, cols, x, cc)


def espim_spmv(values, cols, x, *, chunk_cols: int | None = None,
               impl: str | None = None,
               schedule: KernelSchedule | None = None) -> torch.Tensor:
    """ELL sparse MV, x (M,) -> (R_pad,) float32.

    Chunked layout: values (float32 or bfloat16) / cols (R_pad, K, Lc) +
    ``chunk_cols``.  Plain layout: values/cols (R_pad, L), plain version
    only.  ``schedule`` is taken for the reference's signature: the
    unbatched kernel (5, the mv body: a persistent grid over whole rows,
    x staged in shared memory, the planes streamed through a ring of
    bulk copies) launches on the plan ``kernels/espim_spmv._mv_plan``
    derives from the pack's shape, the same under every schedule, whose
    only live knob here is ``chunk_cols`` — the pack's own.
    """
    return _dispatch_spmv(values, cols, x, chunk_cols, impl,
                          _ref.espim_spmv_ref, _ref.espim_spmv_chunked_ref,
                          _k.espim_spmv_cuda, {})


def espim_spmv_batched(values, cols, x, *, chunk_cols: int | None = None,
                       impl: str | None = None,
                       schedule: KernelSchedule | None = None,
                       epilogue: str | None = None, act: str = "silu",
                       residual=None) -> torch.Tensor:
    """Batched ELL sparse MV: x (M, B) -> (R_pad, B) float32 (see
    ``espim_spmv``).

    ``schedule`` applies a tuned ``core.sdds.KernelSchedule``'s warps a
    row and U to the kernel's launch (``chunk_cols`` stays the pack's); a
    value the kernel is not built for raises.

    ``epilogue`` fuses a decode epilogue into the launch:

    * ``"glu"`` — values/cols hold a half-major (2*Rg, K, Lc) gate+up
      group sharing one balance perm; returns act(gate) * up (Rg, B) in
      packed order.
    * ``"residual"`` — adds ``residual`` (R_pad, B) float32, already in
      packed row order, to the reduced sum in the same launch.
    """
    kw = _sched_kw(schedule)
    if epilogue is None:
        return _dispatch_spmv(values, cols, x, chunk_cols, impl,
                              _ref.espim_spmv_batched_ref,
                              _ref.espim_spmv_batched_chunked_ref,
                              _k.espim_spmv_batched_cuda, kw)
    impl = _resolve(impl)
    if values.dim() != 3:
        raise ValueError(
            f"epilogue={epilogue!r} needs the column-chunked layout; got "
            f"values of shape {tuple(values.shape)}")
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if epilogue == "glu":
        if _use_kernel(impl, values, cols, x):
            return _k.espim_spmv_batched_glu_cuda(values, cols, x,
                                                  chunk_cols=cc, act=act,
                                                  **kw)
        return _ref.espim_spmv_batched_chunked_glu_ref(values, cols, x, cc,
                                                       act)
    if epilogue == "residual":
        if residual is None:
            raise ValueError("epilogue='residual' needs the residual "
                             "operand (packed row order)")
        if _use_kernel(impl, values, cols, x, residual):
            return _k.espim_spmv_batched_res_cuda(values, cols, x, residual,
                                                  chunk_cols=cc, **kw)
        return _ref.espim_spmv_batched_chunked_ref(values, cols, x,
                                                   cc) + residual
    raise ValueError(f"unknown epilogue {epilogue!r}")


def espim_spmv_batched_quant(values, cols, scales, x, *,
                             chunk_cols: int | None = None,
                             group_rows: int = 1, impl: str | None = None,
                             schedule: KernelSchedule | None = None,
                             epilogue: str | None = None, act: str = "silu",
                             srow=None, residual=None) -> torch.Tensor:
    """Quantized batched ELL sparse MV: int8 codes (or nibble-packed
    uint8 — inferred from the width mismatch vs ``cols``) plus one float32
    scale per ``group_rows`` packed rows; x (M, B) -> (R_pad, B) float32.

    ``scales=None`` returns the unscaled code-domain accumulator (the
    serving path folds its per-row scales into one multiply per bucket).
    ``schedule`` applies a tuned schedule's warps a row and U, as in
    ``espim_spmv_batched``.  ``epilogue="glu"`` accumulates the
    half-major (2*Rg, K, Lc) code plane, multiplies both halves by the
    per-row scales ``srow`` (2*Rg,), then forms act(gate) * up — the
    unfused path's exact op order.  ``epilogue="residual"`` adds the
    packed-order residual to the scaled output (op-level for the quant
    family, as in the reference: the kernel, then ``srow`` when
    ``scales`` is None, then the add).  The plain (R_pad, L) layout takes
    the plain version as a one-chunk plane.
    """
    impl = _resolve(impl)
    kw = _sched_kw(schedule)
    if epilogue == "glu":
        if srow is None:
            raise ValueError("epilogue='glu' needs srow (pre-expanded "
                             "per-row scales, half-major)")
        if cols.dim() != 3:
            raise ValueError(
                "epilogue='glu' needs the column-chunked layout; got "
                f"cols of shape {tuple(cols.shape)}")
        cc = _check_chunk_cols(cols, x, chunk_cols)
        if _use_kernel(impl, values, cols, srow, x):
            return _k.espim_spmv_batched_quant_glu_cuda(
                values, cols, srow, x, chunk_cols=cc, act=act, **kw)
        return _ref.espim_spmv_batched_chunked_quant_glu_ref(
            values, cols, srow, x, cc, act)
    if epilogue == "residual":
        if residual is None:
            raise ValueError("epilogue='residual' needs the residual "
                             "operand (packed row order)")
        y = espim_spmv_batched_quant(
            values, cols, scales, x, chunk_cols=chunk_cols,
            group_rows=group_rows, impl=impl, schedule=schedule)
        if scales is None and srow is not None:
            y = y * srow[:, None]
        return y + residual
    if epilogue is not None:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if cols.dim() == 2:
        if impl != "ref":
            raise ValueError(_PLAIN_REF_ONLY)
        return _ref.espim_spmv_batched_chunked_quant_ref(
            values[:, None, :], cols[:, None, :], scales, x, x.shape[0],
            group_rows)
    cc = _check_chunk_cols(cols, x, chunk_cols)
    if _use_kernel(impl, values, cols, scales, x):
        return _k.espim_spmv_batched_quant_cuda(
            values, cols, scales, x, chunk_cols=cc, group_rows=group_rows,
            **kw)
    return _ref.espim_spmv_batched_chunked_quant_ref(
        values, cols, scales, x, cc, group_rows)


def espim_spmv_group(values, cols, x, *, chunk_cols: int,
                     srow=None, act: str | None = None, perm=None,
                     n_out: int | None = None, impl: str | None = None,
                     schedule: KernelSchedule | None = None) -> torch.Tensor:
    """One packed group's buckets in one call: x (M, B) -> (n_out, B)
    float32, what the decode step ran as one launch a bucket followed by
    a scale multiply, a concatenation and a take.

    ``values`` / ``cols``: the buckets' column-chunked planes (f32, bf16,
    int8 or nibble-packed int4 codes); ``srow``: each quantized bucket's
    per-row scales, one multiply after its sum; ``act``: half-major
    gate+up buckets with the GLU epilogue fused, act(gate) * up;
    ``perm``: a take group's packed row -> logical row (-1 pad), with
    ``n_out`` its logical rows; else the buckets' outputs concatenated in
    packed order.  ``schedule`` applies a tuned schedule's warps a row and
    U (the per-bucket kernels' rule).  A CUDA x launches the grouped
    kernel (``kernels/espim_spmv.espim_spmv_group_cuda``); the plain
    version (``kernels/ref.espim_spmv_group_ref``) runs the per-bucket
    plain versions and the same scale, concatenation and take."""
    impl = _resolve(impl)
    for c in cols:
        _check_chunk_cols(c, x, chunk_cols)
    if _use_kernel(impl, x, *values):
        return _k.espim_spmv_group_cuda(values, cols, x,
                                        chunk_cols=int(chunk_cols),
                                        srow=srow, perm=perm, n_out=n_out,
                                        act=act, **_sched_kw(schedule))
    return _ref.espim_spmv_group_ref(values, cols, x, int(chunk_cols),
                                     srow=srow, perm=perm, n_out=n_out,
                                     act=act)


def dense_mv(w, x, *, impl: str | None = None) -> torch.Tensor:
    """Dense MV (the Newton-analogue path): w (R, C) @ x (C,) -> (R,)
    float32."""
    if _use_kernel(_resolve(impl), w, x):
        return _dk.dense_mv_cuda(w, x)
    return _ref.dense_mv_ref(w, x)


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where a kernel call would run right now — recorded by scripts and
    trace headers so every result carries its backend/impl context; the
    reference's fields and ``to_dict()`` key order.

    ``backend`` is the device type (``cuda`` or ``cpu``) and ``impl`` the
    resolved impl (``cuda`` or ``ref``: the ``ESPIM_IMPL`` pin, else the
    caller's, else the device's).  The reference's ``pallas_interpret``
    (whether its Pallas kernels ran interpreted) has no counterpart: in
    its place ``device`` names the card (``torch.cuda.get_device_name``)
    or ``"cpu"``.  ``quant`` names the value-plane encoding the caller is
    timing (none/int8/int4); ``attn`` the attention projection datapath
    (dense = MLP-only packs, sparse = whole-layer packs, sweep = both);
    ``packs`` maps a label to the bound pack fingerprint the run served,
    so a result is tied to the exact plane bytes; ``schedule`` is a tuned
    plan's ``TunedPlan.to_provenance()`` (``None`` = the default launch);
    ``env`` records ``ESPIM_IMPL`` and ``ESPIM_PLAN_CACHE``.
    """
    backend: str
    impl: str
    quant: str
    attn: str
    device: str
    packs: dict | None
    env: dict
    schedule: dict | None = None

    @classmethod
    def collect(cls, impl: str | None = None, quant: str | None = None,
                attn: str | None = None, packs: dict | None = None,
                schedule: dict | None = None, device=None) -> "Provenance":
        dev = resolve_device(device)
        impl = _resolve(impl)
        if impl is None:
            impl = "cuda" if dev.type == "cuda" else "ref"
        return cls(
            backend=dev.type,
            impl=impl,
            quant=quant or "none",
            attn=attn or "dense",
            device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else dev.type),
            packs=dict(packs) if packs else None,
            env={ENV_IMPL: os.environ.get(ENV_IMPL) or None,
                 ENV_PLAN_CACHE: os.environ.get(ENV_PLAN_CACHE) or None},
            schedule=dict(schedule) if schedule else None,
        )

    def to_dict(self) -> dict:
        """Stable key order, JSON-ready: the reference's, with ``device``
        in ``pallas_interpret``'s place."""
        return {
            "backend": self.backend,
            "impl": self.impl,
            "quant": self.quant,
            "attn": self.attn,
            "device": self.device,
            "packs": dict(self.packs) if self.packs else None,
            "schedule": dict(self.schedule) if self.schedule else None,
            "env": dict(self.env),
        }


def provenance(impl: str | None = None, quant: str | None = None,
               attn: str | None = None, packs: dict | None = None,
               schedule: dict | None = None, device=None) -> dict:
    """Functional form: ``Provenance.collect(...).to_dict()`` (see the
    dataclass for field semantics); ``device`` defaults to cuda and
    raises without one unless asked for the CPU."""
    return Provenance.collect(impl=impl, quant=quant, attn=attn,
                              packs=packs, schedule=schedule,
                              device=device).to_dict()


# --------------------------------------------------------------------------
# Packed-weights API
# --------------------------------------------------------------------------
@dataclasses.dataclass
class EspimWeights:
    """Device-resident column-chunked ESPIM pack of one weight matrix
    (W @ x semantics, W of shape (n_out, n_in))."""

    values: torch.Tensor      # (R_pad, K, Lc) float32 or bfloat16
    cols: torch.Tensor        # (R_pad, K, Lc) int32, chunk-local
    perm: torch.Tensor        # (R_pad,) int32, -1 = pad row
    n_rows: int
    n_cols: int
    chunk_cols: int
    schedule: object = None   # the TunedPlan of pack_to_device(autotune=True)


@dataclasses.dataclass
class QuantEspimWeights:
    """Device-resident column-chunked pack with a quantized value plane
    (``repro_torch.quant``): int8 codes or nibble-packed uint8 plus
    per-row-group scales; indices and perm as in ``EspimWeights``."""

    values: torch.Tensor      # (R_pad, K, Lc) int8 | (R_pad, K, Lc/2) uint8
    cols: torch.Tensor        # (R_pad, K, Lc) int32, chunk-local
    perm: torch.Tensor        # (R_pad,) int32, -1 = pad row
    scales: torch.Tensor      # (R_pad // group_rows,) float32
    n_rows: int
    n_cols: int
    chunk_cols: int
    group_rows: int
    bits: int
    schedule: object = None   # the TunedPlan of pack_to_device(autotune=True)


def pack_to_device(pack: ELLPack | ELLChunkedPack, dtype=torch.float32,
                   chunk_cols: int = DEFAULT_CHUNK_COLS, quant=None,
                   verify: bool = True, autotune: bool = False,
                   tune: dict | None = None, device=None
                   ) -> EspimWeights | QuantEspimWeights:
    """Move an offline pack onto the tensors the kernels consume, on
    ``device`` (default cuda; raises without one unless asked for the
    CPU).

    A plain ELLPack is run through the SDDS chunk pass first (with
    ``chunk_cols``); an ELLChunkedPack is uploaded as-is.  ``quant``
    ("int8" | "int4" | a ``repro_torch.quant.QuantSpec``) quantizes the
    value plane on the way up (or reuses an already-attached
    ``pack.qplane`` made by the same spec) and returns
    ``QuantEspimWeights``.

    ``autotune=True`` asks ``repro_torch.autotune`` for a schedule first,
    on the same device: a plan-cache hit (keyed by the pack's plan-free
    fingerprint + launch context) skips the search entirely; a miss
    times the cost-ranked candidates and caches the winner.  The tuned
    ``chunk_cols`` replaces the argument for the chunk pass, and the
    ``TunedPlan`` rides on the returned weights as ``.schedule`` (None
    without autotune).  ``tune`` forwards extra ``autotune_pack`` kwargs
    (``b``, ``max_candidates``, ``iters``, ``cache``, ...).

    ``verify=True`` runs ``core.integrity.verify_pack`` on the host pack
    first: corruption between build and upload raises
    ``PackIntegrityError`` here.
    """
    dev = resolve_device(device)
    tr = get_tracer()
    with tr.span("pack.to_device", cat="pack",
                 args={"quant": getattr(quant, "bits", quant) or "none",
                       "verify": verify, "autotune": autotune}):
        plan = None
        if autotune:
            from repro_torch.autotune import autotune_pack, default_cache
            kw = dict(tune or {})
            kw.setdefault("cache", default_cache())
            with tr.span("pack.autotune", cat="pack"):
                plan = autotune_pack(pack, quant=quant, device=dev, **kw)
            if isinstance(pack, ELLPack):
                chunk_cols = plan.schedule.chunk_cols
        w = _pack_to_device(pack, dtype, chunk_cols, quant, verify, dev, tr)
        w.schedule = plan
        return w


def _pack_to_device(pack, dtype, chunk_cols, quant, verify, dev, tr):
    if verify:
        from repro_torch.core.integrity import verify_pack
        with tr.span("pack.verify", cat="pack"):
            verify_pack(pack)
    if isinstance(pack, ELLPack):
        pack = chunk_pack(pack, chunk_cols)
    # torch.tensor copies: the device planes never alias the host pack
    cols = torch.tensor(pack.cols, dtype=torch.int32, device=dev)
    perm = torch.tensor(np.asarray(pack.perm), dtype=torch.int32,
                        device=dev)
    if quant is None:
        return EspimWeights(
            values=torch.tensor(pack.values, dtype=dtype, device=dev),
            cols=cols, perm=perm, n_rows=pack.n_rows,
            n_cols=pack.n_cols, chunk_cols=pack.chunk_cols)
    from repro_torch.quant import QuantSpec, default_spec, quantize_pack
    spec = quant if isinstance(quant, QuantSpec) else default_spec(quant)
    plane = pack.qplane
    # reuse the attached plane only when this exact spec produced it
    if plane is None or plane.spec != spec:
        plane = quantize_pack(pack, spec)
    return QuantEspimWeights(
        values=torch.tensor(plane.device_codes(), device=dev),
        cols=cols, perm=perm,
        scales=torch.tensor(plane.scales, device=dev),
        n_rows=pack.n_rows, n_cols=pack.n_cols,
        chunk_cols=pack.chunk_cols, group_rows=plane.group_rows,
        bits=plane.bits)


def espim_matvec(w: EspimWeights | QuantEspimWeights, x: torch.Tensor, *,
                 impl: str | None = None) -> torch.Tensor:
    """y (n_rows,) or (n_rows, B) = W @ x with packed-row unscatter.  A
    1-D x on an fp pack takes the unbatched op; a quantized pack takes
    the batched quant op at B = 1.  As in the reference, a tuned
    ``w.schedule`` reaches the launch only through the pack's
    ``chunk_cols``: no other knob is applied here."""
    if x.dim() not in (1, 2):
        raise ValueError(f"x must be 1-D or 2-D, got {tuple(x.shape)}")
    if isinstance(w, QuantEspimWeights):
        xb = x[:, None] if x.dim() == 1 else x
        yp = espim_spmv_batched_quant(w.values, w.cols, w.scales, xb,
                                      chunk_cols=w.chunk_cols,
                                      group_rows=w.group_rows, impl=impl)
        yp = yp[:, 0] if x.dim() == 1 else yp
    elif x.dim() == 1:
        yp = espim_spmv(w.values, w.cols, x, chunk_cols=w.chunk_cols,
                        impl=impl)
    else:
        yp = espim_spmv_batched(w.values, w.cols, x,
                                chunk_cols=w.chunk_cols, impl=impl)
    return _ref.scatter_rows_ref(yp, w.perm, w.n_rows)
