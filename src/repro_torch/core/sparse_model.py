"""ESPIM-format sparse serving of a whole dense-family LM, in PyTorch.

Mirrors ``src/repro/core/sparse_model.py``.  The offline pack-group
compiler (``sparsify_model``) runs the same host numpy pipeline as the
reference — prune -> fuse -> balance -> chunk -> width-bucket ->
[quantize], from the port's own copies of ``core/pruning``, ``core/sdds``,
``core/sparse_format`` and ``quant`` — and uploads the planes to the
device, so the port serves the same pack bytes and its group
fingerprints equal the reference's.

The decode step runs every covered per-token MV through the packed
kernels (``kernels/ops``): the fused QKV group and its static ``take``,
the O group, the gate+up group with the GLU epilogue fused in, and the
perm-composed down group.  The layer loop is a Python loop over the
stacked layer leaves in place of the reference's ``lax.scan``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import integrity
from repro_torch.core.pruning import magnitude_prune
from repro_torch.core.sdds import decoder_layer_groups, validate_group_specs
from repro_torch.core.sparse_format import (BucketedStackedPack,
                                            bucketed_stack_to_dense,
                                            compose_cols_with_pack,
                                            pack_group,
                                            projection_padded_slots)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.telemetry.trace import get_tracer

__all__ = ["sparsify_model", "sparsify_mlps", "pruned_param_tree",
           "decode_step_sparse", "prefill_chunk_sparse", "sparse_stats",
           "verify_sparse"]

# the standard decoder-layer projections NOT covered by a group still
# stream their dense bytes every decode token — sparse_stats charges them
_DENSE_MODULES = ("attn", "mlp")


def _np(a) -> np.ndarray:
    """A plane as host numpy (torch tensors are copied off the device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _to_device(pack: BucketedStackedPack, device: torch.device) -> dict:
    """BucketedStackedPack -> the tensor dict the decode step consumes.
    ``valid`` masks, nnz stats and the host QuantizedValuePlanes stay on
    the host; quantized packs upload only the codes (``q``) and the
    pre-expanded per-row scales (``srow``) in place of the fp values."""

    def up(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    if pack.qplanes is None:
        buckets = [{"values": up(b["values"]),
                    "cols": up(b["cols"].astype(np.int32)),
                    "valid": b["valid"]}
                   for b in pack.buckets]
        quant_meta = None
    else:
        buckets = [{"q": up(plane.device_codes()),     # (L, HR, K, Lc[/2])
                    "cols": up(b["cols"].astype(np.int32)),
                    "srow": up(plane.row_scales()),
                    "valid": b["valid"]}
                   for b, plane in zip(pack.buckets, pack.qplanes)]
        quant_meta = tuple(
            {"bits": p.bits, "group_rows": p.group_rows, "storage": p.storage}
            for p in pack.qplanes)
    g = {
        "halves": pack.halves,
        "n_rows": pack.n_rows,
        "n_cols": pack.n_cols,
        "r_pad": pack.r_pad,
        "chunk_cols": pack.chunk_cols,
        "bucket_rows": pack.bucket_rows,
        "widths": pack.widths,
        "buckets": buckets,
        "perm": up(np.asarray(pack.perm, np.int32)),
        "inv_perm": up(np.asarray(pack.inv_perm, np.int32)),
        "nnz": pack.nnz,
        "nnz_per_layer": np.asarray(pack.nnz_per_layer),
        "nnz_per_half": np.asarray(pack.nnz_per_half),
        "padded_per_layer": pack.padded_slots_per_layer,
        "plan": pack.plan,
        "quant": quant_meta,
        "qplanes": pack.qplanes,
    }
    # fingerprint the device form (nibble-packed codes, expanded srow,
    # int32 perms), exactly the bytes the reference hashes
    g["plane_fingerprints"], g["fingerprint"] = _group_fingerprint(g)
    return g


def _group_fingerprint(g: dict) -> tuple[dict, str]:
    """Per-plane digests + bound digest over exactly the tensors decode
    gathers (plus the host valid masks and the SDDS plan meta)."""
    planes = {}
    for gi, b in enumerate(g["buckets"]):
        for nm in ("values", "q", "cols", "srow", "valid"):
            if nm in b:
                planes[f"b{gi}.{nm}"] = _np(b[nm])
    planes["perm"] = _np(g["perm"])
    planes["inv_perm"] = _np(g["inv_perm"])
    meta = {
        "halves": g["halves"], "n_rows": g["n_rows"], "n_cols": g["n_cols"],
        "r_pad": g["r_pad"], "chunk_cols": g["chunk_cols"],
        "bucket_rows": list(g["bucket_rows"]), "widths": list(g["widths"]),
        "quant": ([dict(q) for q in g["quant"]] if g["quant"] else None),
        "plan": integrity.plan_fingerprint(g["plan"]),
    }
    fps = integrity.fingerprint_planes(planes)
    return fps, integrity.bind_fingerprint(fps, meta)


def _validate_group(name: str, g: dict) -> None:
    """Bounds-validate one serving group's planes: chunk-local column ids
    against the gather domain, perm/inv_perm consistency, and quantized
    planes against their scale-group layout."""
    err = integrity.PackIntegrityError
    cc, n_cols = g["chunk_cols"], g["n_cols"]
    for gi, b in enumerate(g["buckets"]):
        cols = _np(b["cols"])
        valid = np.asarray(b["valid"], bool)
        what = f"group {name!r} bucket {gi}"
        if cols.shape != valid.shape:
            raise err(f"{what}: cols/valid shape mismatch")
        k = cols.shape[-2]
        lim = np.minimum(cc, n_cols - np.arange(k) * cc)
        lim = lim.reshape((1,) * (cols.ndim - 2) + (k, 1))
        if (valid & ((cols < 0) | (cols >= lim))).any():
            raise err(f"{what}: index plane out of bounds for input dim "
                      f"{n_cols} (chunk_cols={cc})")
        if "values" in b:
            if not bool(torch.isfinite(b["values"]).all()):
                raise err(f"{what}: non-finite entries in the value plane")
        if "srow" in b:
            srow = _np(b["srow"])
            if not bool(np.isfinite(srow).all()):
                raise err(f"{what}: non-finite quant scales")
            if srow.shape != cols.shape[:2]:
                raise err(f"{what}: srow scale layout {srow.shape} does not "
                          f"cover the packed rows {cols.shape[:2]}")
            qm = g["quant"][gi]
            if cols.shape[1] % max(1, qm["group_rows"]):
                raise err(f"{what}: rows not divisible by scale "
                          f"group_rows={qm['group_rows']}")
            q = b["q"]
            if qm["storage"] == "nib4":
                want = cols.shape[:-1] + ((cols.shape[-1] + 1) // 2,)
                if q.dtype != torch.uint8 or tuple(q.shape) != want:
                    raise err(f"{what}: nibble-packed codes layout "
                              f"{q.dtype}{tuple(q.shape)} != uint8{want}")
            elif q.dtype != torch.int8 or tuple(q.shape) != cols.shape:
                raise err(f"{what}: int8 codes layout {q.dtype}"
                          f"{tuple(q.shape)} diverges from the index plane "
                          f"{cols.shape}")
    integrity.validate_perm_layers(f"group {name!r}", _np(g["perm"]),
                                   _np(g["inv_perm"]), g["n_rows"])


def verify_sparse(sparse: dict) -> dict:
    """The serving-side upload check: every group's planes are
    bounds-validated and re-fingerprinted against the digests
    ``sparsify_model`` recorded.  Raises ``PackIntegrityError`` naming the
    group and diverging planes; returns ``{group: digest}``."""
    out = {}
    for name, g in sparse.get("groups", {}).items():
        _validate_group(name, g)
        fps, bound = _group_fingerprint(g)
        recorded = g.get("fingerprint")
        if recorded is not None and recorded != bound:
            diverged = integrity.diverging_planes(
                {"planes": g.get("plane_fingerprints", {})}, {"planes": fps})
            raise integrity.PackIntegrityError(
                f"group {name!r}: device plane fingerprint mismatch "
                f"(diverged: {diverged or ['<meta/schedule>']}) — the pack "
                "was corrupted after build or paired with the wrong "
                "schedule")
        out[name] = bound
    return out


def _dequantized_projs(pack: BucketedStackedPack, offsets: dict,
                       upstream: BucketedStackedPack | None) -> dict:
    """The dense (L, in, out) matrices a quantized group encodes: they
    replace the pruned copies, so the dense prefill path and the parity
    references run the same weights as the quantized kernels."""
    deq = dataclasses.replace(pack, buckets=[
        dict(b, values=plane.dequantize())
        for b, plane in zip(pack.buckets, pack.qplanes)])
    out = {}
    for name, (hf, r0, r1) in offsets.items():
        mats = []
        for l in range(pack.n_layers):
            m = bucketed_stack_to_dense(deq, l, hf)[r0:r1]
            if upstream is not None:
                m = m[:, upstream.inv_perm[l]]       # back to logical cols
            mats.append(m.T)                         # (in, out)
        out[name] = np.stack(mats)
    return out


def _uncovered_dense_bytes(params: dict, covered: set) -> int:
    """Per-token weight bytes of the standard decoder projections NOT
    compiled into a pack group (stacked 2-D weights only)."""
    total = 0
    for module in _DENSE_MODULES:
        sub = params.get("layers", {}).get(module, {})
        for name, w in sub.items():
            if (module, name) in covered or w.dim() != 3:
                continue
            total += int(w.numel()) * w.element_size()
    return total


def _resolve_specs(cfg: ModelConfig, projections) -> dict:
    if projections == "all":
        specs = decoder_layer_groups(cfg.gated_mlp, attn=True, mlp=True)
    elif projections == "mlp":
        specs = decoder_layer_groups(cfg.gated_mlp, attn=False, mlp=True)
    elif projections == "attn":
        specs = decoder_layer_groups(cfg.gated_mlp, attn=True, mlp=False)
    elif isinstance(projections, str):
        raise ValueError(f"unknown projections preset {projections!r} "
                         "(all | mlp | attn | explicit PackGroupSpec list)")
    else:
        specs = tuple(projections)
    by_name = validate_group_specs(specs)
    # the decode runtime drives each module through its canonical group
    # names and projection sets: a spec list it cannot serve fails here
    runtime = {"attn": {"qkv": {"wq", "wk", "wv"}, "attn_out": {"wo"}},
               "mlp": {"gateup": ({"w_gate", "w_up"} if cfg.gated_mlp
                                  else {"w_up"}),
                       "down": {"w_down"}}}
    for module, req in runtime.items():
        covering = {s.name: set(s.projections) for s in by_name.values()
                    if s.module == module}
        if covering and covering != req:
            raise ValueError(
                f"the fused decode runtime serves {module} via groups "
                f"{ {n: sorted(p) for n, p in req.items()} }; "
                f"got { {n: sorted(p) for n, p in covering.items()} }")
    return by_name


def sparsify_model(cfg: ModelConfig, params: dict, sparsity: float, *,
                   projections="all", row_tile: int = 128,
                   chunk_cols: int = ops.DEFAULT_CHUNK_COLS,
                   n_buckets: int = 4, quant: str | None = None,
                   quant_spec=None, device=None) -> dict:
    """Offline pack-group compiler: prune + fuse + pack (+ quantize) the
    decoder layer's projections per a declarative group-spec list, and
    upload the planes to ``device`` (``cuda`` unless named).

    Same arguments and returned dict as the reference: per-group packs
    under ``"groups"`` (also aliased by group name), pruned — or, with
    ``quant``, dequantized — dense copies per projection under
    ``"pruned"`` (+ ``"<name>_pruned"``), the compiled ``"specs"`` and the
    model ``"fingerprint"``.
    """
    tr = get_tracer()
    with tr.span("pack.build", cat="pack"):
        dev = resolve_device(device)
        quant = None if quant in (None, "none") else quant
        by_name = _resolve_specs(cfg, projections)
        n_layers = cfg.n_layers

        qspec = None
        if quant is not None or quant_spec is not None:
            from repro_torch.quant import QuantSpec, default_spec
            qspec = (quant_spec if isinstance(quant_spec, QuantSpec)
                     else default_spec(quant))
            quant = quant or f"int{qspec.bits}"

        # ---- prune every covered projection -----------------------------
        pruned: dict = {}
        dtypes: dict = {}
        with tr.span("pack.prune", cat="pack"):
            for spec in by_name.values():
                sub = params["layers"].get(spec.module, {})
                missing = [n for n in spec.projections if n not in sub]
                if missing:
                    raise ValueError(
                        f"params missing {spec.module} projection(s) "
                        f"{missing} for group {spec.name!r} "
                        f"(gated_mlp={cfg.gated_mlp})")
                for name in spec.projections:
                    w = _np(sub[name].float())               # (L, in, out)
                    pruned[name] = np.stack([magnitude_prune(w[l], sparsity)
                                             for l in range(n_layers)])
                    dtypes[name] = sub[name].dtype

        # ---- compile the groups in spec order ---------------------------
        host_packs: dict = {}
        groups: dict = {}
        for spec in by_name.values():
            upstream = host_packs.get(spec.compose_with)
            with tr.span("pack.group", cat="pack", args={"group": spec.name}):
                # rows of the packed matrix are W^T's rows (the output dim)
                mats = {n: [pruned[n][l].T for l in range(n_layers)]
                        for n in spec.projections}
                proj_nnz = {n: np.asarray([(pruned[n][l] != 0).sum()
                                           for l in range(n_layers)],
                                          np.int64)
                            for n in spec.projections}
                if upstream is not None:
                    mats = {n: compose_cols_with_pack(ms, upstream)
                            for n, ms in mats.items()}
                pack, offsets = pack_group(mats, fuse=spec.fuse,
                                           row_tile=row_tile,
                                           chunk_cols=chunk_cols,
                                           n_buckets=n_buckets)
            if qspec is not None:
                from repro_torch.quant import quantize_bucketed_stack
                with tr.span("pack.quantize", cat="pack"):
                    quantize_bucketed_stack(pack, qspec)
                    for name, arr in _dequantized_projs(pack, offsets,
                                                        upstream).items():
                        pruned[name] = arr
            host_packs[spec.name] = pack
            with tr.span("pack.upload", cat="pack"):
                g = _to_device(pack, dev)
            g.update({
                "name": spec.name,
                "module": spec.module,
                "projections": tuple(spec.projections),
                "fuse": spec.fuse,
                "output": spec.output,
                "compose_with": spec.compose_with,
                "row_offsets": offsets,
                "proj_nnz": proj_nnz,
                "proj_padded": projection_padded_slots(pack, offsets),
            })
            groups[spec.name] = g

        covered = {(s.module, n) for s in by_name.values()
                   for n in s.projections}
        out: dict = {
            "format": "espim-packgroups/v3",
            "sparsity": sparsity,
            "gated": bool(cfg.gated_mlp),
            "quant": quant or "none",
            "attn_sparse": "qkv" in groups,
            "mlp_sparse": "gateup" in groups,
            "specs": tuple(by_name.values()),
            "groups": groups,
            "dense_proj_bytes": _uncovered_dense_bytes(params, covered),
        }
        with tr.span("pack.upload", cat="pack"):
            out["pruned"] = {
                n: torch.from_numpy(np.ascontiguousarray(w)).to(
                    device=dev, dtype=dtypes[n])
                for n, w in pruned.items()}
        if qspec is not None:
            out["quant_spec"] = qspec
        # one model-level digest binding every group's device fingerprint
        out["fingerprint"] = integrity.bind_fingerprint(
            {n: g["fingerprint"] for n, g in groups.items()},
            meta={"format": out["format"], "sparsity": sparsity,
                  "quant": out["quant"]})
        for name, g in groups.items():             # top-level aliases
            out[name] = g
        for name, w in out["pruned"].items():
            out[f"{name}_pruned"] = w
        return out


def sparsify_mlps(cfg: ModelConfig, params: dict, sparsity: float,
                  row_tile: int = 128,
                  chunk_cols: int = ops.DEFAULT_CHUNK_COLS,
                  n_buckets: int = 4, quant: str | None = None,
                  quant_spec=None, device=None) -> dict:
    """MLP-only preset of ``sparsify_model`` (attention stays dense)."""
    return sparsify_model(cfg, params, sparsity, projections="mlp",
                          row_tile=row_tile, chunk_cols=chunk_cols,
                          n_buckets=n_buckets, quant=quant,
                          quant_spec=quant_spec, device=device)


def pruned_param_tree(params: dict, sparse: dict) -> dict:
    """A params dict with every covered projection replaced by the sparse
    dict's pruned (or dequantized) copy — the dense reference model."""
    out = dict(params)
    out["layers"] = {m: dict(sub) for m, sub in params["layers"].items()}
    for module in _DENSE_MODULES:
        sub = out["layers"].get(module, {})
        for name in sub:
            if name in sparse["pruned"]:
                sub[name] = sparse["pruned"][name]
    return out


# --------------------------------------------------------------------------
# Fused runtime path
# --------------------------------------------------------------------------
def _layer_bufs(sparse: dict, i: int) -> dict:
    """Layer ``i``'s slice of every group's planes: (codes, cols, srow)
    triples for quantized packs, (values, cols) pairs otherwise; the same
    as the lists the grouped op takes (``values``, ``cols``, ``srow``);
    and the ``perm`` (packed -> logical) and ``inv_perm`` of
    ``take``-output groups."""

    def bufs(g):
        if g["quant"] is not None:
            b = [(b["q"][i], b["cols"][i], b["srow"][i])
                 for b in g["buckets"]]
        else:
            b = [(b["values"][i], b["cols"][i]) for b in g["buckets"]]
        entry = {"bufs": b, "values": [t[0] for t in b],
                 "cols": [t[1] for t in b],
                 "srow": [t[2] for t in b] if g["quant"] else None}
        if g["output"] == "take":
            entry["perm"] = g["perm"][i]
            entry["inv"] = g["inv_perm"][i]
        return entry

    return {name: bufs(g) for name, g in sparse["groups"].items()}


def _bucket_spmv(pack: dict, buf: tuple, g: int, xt: torch.Tensor,
                 impl: str | None, epilogue: str | None = None,
                 act: str = "silu") -> torch.Tensor:
    """One bucket's SpMV launch, fp or quantized per the pack's meta.
    Quantized launches return the code-domain accumulator and dequantize
    with one multiply by the pre-expanded per-row scales; ``epilogue="glu"``
    fuses act(gate)·up into the launch (half-major gate+up bucket)."""
    if pack["quant"] is not None:
        codes, cols, srow = buf
        if epilogue == "glu":
            return ops.espim_spmv_batched_quant(
                codes, cols, None, xt, chunk_cols=pack["chunk_cols"],
                group_rows=pack["quant"][g]["group_rows"], impl=impl,
                epilogue="glu", act=act, srow=srow)
        yp = ops.espim_spmv_batched_quant(
            codes, cols, None, xt, chunk_cols=pack["chunk_cols"],
            group_rows=pack["quant"][g]["group_rows"], impl=impl)
        return yp * srow[:, None]
    vals, cols = buf
    if epilogue == "glu":
        return ops.espim_spmv_batched(vals, cols, xt,
                                      chunk_cols=pack["chunk_cols"],
                                      impl=impl, epilogue="glu", act=act)
    return ops.espim_spmv_batched(vals, cols, xt,
                                  chunk_cols=pack["chunk_cols"], impl=impl)


def _col_major(h: torch.Tensor) -> torch.Tensor:
    """(N, D) activations -> the (D, N) fp32 contiguous x every bucket
    launch of a group shares: one cast-and-transpose copy per group, so
    the kernel wrappers find x ready and copy nothing."""
    xt = torch.empty((h.shape[1], h.shape[0]), dtype=torch.float32,
                     device=h.device)
    return xt.copy_(h.T)


def _group_apply(pack: dict, gb: dict, xt: torch.Tensor, impl,
                 act: str | None = None) -> torch.Tensor:
    """One group's buckets in one grouped op (one launch on the card): the
    reference's per-bucket launches, each quantized bucket's ``srow``
    multiply, the concatenation and, for a ``take`` group, its one static
    take to logical row order (``_group_apply`` then ``_group_take`` of
    ``src/repro/core/sparse_model.py``); ``act`` fuses act(gate) * up
    into a half-major gate+up group."""
    perm = gb.get("perm")
    return ops.espim_spmv_group(gb["values"], gb["cols"], xt,
                                chunk_cols=pack["chunk_cols"],
                                srow=gb["srow"], act=act, perm=perm,
                                n_out=None if perm is None else pack["n_rows"],
                                impl=impl)


def _fused_qkv(cfg: ModelConfig, sparse: dict, bufs: dict, attn_p: dict,
               hn: torch.Tensor, impl):
    """The fused QKV pack: hn (B, T, D) -> q (B, T, H, hd), k/v
    (B, T, KV, hd) in logical head order (one launch per bucket, one
    static take; biases added after the take)."""
    g = sparse["groups"]["qkv"]
    gb = bufs["qkv"]
    b, t = hn.shape[0], hn.shape[1]
    xt = _col_major(hn.reshape(-1, hn.shape[-1]))            # (D, B*T)
    y = _group_apply(g, gb, xt, impl)                         # (rows, B*T)

    def cut(name: str, n_heads: int) -> torch.Tensor:
        _, r0, r1 = g["row_offsets"][name]
        seg = y[r0:r1]
        bias = attn_p.get("b" + name[1])                      # wq -> bq
        if bias is not None:
            seg = seg + bias.float()[:, None]
        return seg.T.reshape(b, t, n_heads, cfg.hd).to(hn.dtype)

    return (cut("wq", cfg.n_heads), cut("wk", cfg.n_kv_heads),
            cut("wv", cfg.n_kv_heads))


def _fused_o(cfg: ModelConfig, sparse: dict, bufs: dict,
             out_h: torch.Tensor, impl) -> torch.Tensor:
    """The packed O projection: heads (B, T, H, hd) -> (B, T, D)."""
    g = sparse["groups"]["attn_out"]
    gb = bufs["attn_out"]
    b, t = out_h.shape[0], out_h.shape[1]
    xt = _col_major(out_h.reshape(b * t, -1))                # (H*hd, B*T)
    y = _group_apply(g, gb, xt, impl)                         # (D, B*T)
    return y.T.reshape(b, t, -1).to(out_h.dtype)


def _pruned_qkv(cfg: ModelConfig, px: dict, attn_p: dict, hn: torch.Tensor):
    """Dense-path QKV from the pruned copies (GEMM prefill); biases come
    from the layer params."""
    p = {"wq": px["wq"], "wk": px["wk"], "wv": px["wv"]}
    for bn in ("bq", "bk", "bv"):
        if bn in attn_p:
            p[bn] = attn_p[bn]
    return T._qkv(cfg, p, hn)


def _fused_mlp(cfg: ModelConfig, sparse: dict, bufs: dict, hn: torch.Tensor,
               impl, epilogue: bool = True) -> torch.Tensor:
    """One layer's MLP through the fused packs, hn (B, T, D) -> (B, T, D).

    ``epilogue=True`` folds act(gate)·up into the gate+up launch;
    ``epilogue=False`` applies it as separate ops — the two give the same
    bits in the plain version (same accumulate, same op order)."""
    act = L.act_fn(cfg.activation)
    gu = sparse["groups"]["gateup"]
    dn = sparse["groups"]["down"]
    b, t = hn.shape[0], hn.shape[1]
    xt = _col_major(hn.reshape(-1, hn.shape[-1]))            # (in, B*T)

    if sparse["gated"] and epilogue:
        inter = _group_apply(gu, bufs["gateup"], xt, impl,
                             act=cfg.activation)
    elif sparse["gated"]:
        # each bucket's gate and up rows share packed order: its 2 * rg
        # rows of the group's output, gate first
        yp, parts, r0 = _group_apply(gu, bufs["gateup"], xt, impl), [], 0
        for rg in gu["bucket_rows"]:
            parts.append(act(yp[r0:r0 + rg]) * yp[r0 + rg:r0 + 2 * rg])
            r0 += 2 * rg
        inter = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    else:
        inter = act(_group_apply(gu, bufs["gateup"], xt, impl))

    y = _group_apply(dn, bufs["down"], inter, impl)
    return y.T.reshape(b, t, -1).to(hn.dtype)                 # (B, T, D)


def _pruned_mlp(cfg: ModelConfig, sparse: dict, wl: dict, hn: torch.Tensor
                ) -> torch.Tensor:
    """The dense datapath over the pruned copies (GEMM prefill)."""
    if sparse["gated"]:
        return L.mlp_gated(hn, wl["w_gate"], wl["w_up"], wl["w_down"],
                           cfg.activation)
    return L.mlp_relu2(hn, wl["w_up"], wl["w_down"], cfg.activation)


def _layer_stack(cfg: ModelConfig, params: dict, sparse: dict, cache: dict,
                 h, attn_step, attn_core, impl, proj_path: str = "kernel",
                 epilogue: bool = True):
    """Shared layer loop of decode and prefill.

    ``attn_step`` is the whole dense attention used when the sparse dict
    does not cover attention; ``attn_core`` is the projection-free middle
    (RoPE + cache + attention) wrapped by the packed QKV / O groups when
    it does.  An uncovered MLP runs dense from the layer params.  Traced
    by layer group as the dense loop is (``transformer._layer_loop``):
    ``layer.slice``, ``attn`` (its ``attn.qkv`` / ``attn.core`` /
    ``attn.out``), ``mlp``, then ``cache.stack``."""
    if proj_path not in ("kernel", "dense"):
        raise ValueError(f"unknown proj_path {proj_path!r}")
    attn_sparse = sparse.get("attn_sparse", False)
    mlp_sparse = sparse.get("mlp_sparse", "gateup" in sparse["groups"])
    tr = get_tracer()
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        with tr.span("layer.slice", cat="forward"):
            lp = T.layer_slice(params["layers"], i)
            kc, vc = cache["k"][i], cache["v"][i]
            px = (_layer_bufs(sparse, i) if proj_path == "kernel"
                  else {n: w[i] for n, w in sparse["pruned"].items()})
        with tr.span("attn", cat="forward"):
            hn = T._norm(cfg, lp["ln1"], h)
            if attn_sparse:
                with tr.span("attn.qkv", cat="forward"):
                    if proj_path == "kernel":
                        q, k, v = _fused_qkv(cfg, sparse, px, lp["attn"],
                                             hn, impl)
                    else:
                        q, k, v = _pruned_qkv(cfg, px, lp["attn"], hn)
                with tr.span("attn.core", cat="forward"):
                    a_h, kc, vc = attn_core(q, k, v, kc, vc)
                with tr.span("attn.out", cat="forward"):
                    if proj_path == "kernel":
                        a = _fused_o(cfg, sparse, px, a_h, impl)
                    else:
                        b, t = hn.shape[0], hn.shape[1]
                        a = L.dense(a_h.reshape(b, t, -1), px["wo"])
            else:
                a, kc, vc = attn_step(lp, hn, kc, vc)
            h = h + a
        with tr.span("mlp", cat="forward"):
            hn = T._norm(cfg, lp["ln2"], h)
            if not mlp_sparse:
                h = h + T.mlp_apply(cfg, lp["mlp"], hn)
            elif proj_path == "kernel":
                h = h + _fused_mlp(cfg, sparse, px, hn, impl,
                                   epilogue=epilogue)
            else:
                h = h + _pruned_mlp(cfg, sparse, px, hn)
        k_new.append(kc)
        v_new.append(vc)
    with tr.span("cache.stack", cat="forward"):
        return h, torch.stack(k_new), torch.stack(v_new)


def _check_device(params: dict, device) -> torch.device:
    dev = resolve_device(device)
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"params live on {have}, the step was asked to run "
                         f"on {dev}")
    return have


def decode_step_sparse(cfg: ModelConfig, params: dict, sparse: dict,
                       cache: dict, batch: dict, impl: str | None = None,
                       epilogue: bool = True, device=None):
    """One decode step with ESPIM-format projections: tokens (B, 1) ->
    logits (B, 1, V) and a new cache (the input cache is not modified).

    Runs on ``cuda`` unless ``device`` names another; ``impl`` picks the
    SpMV datapath (None: the CUDA kernels on the card, the plain
    versions on the CPU; "ref": the plain versions)."""
    dev = _check_device(params, device)
    tr = get_tracer()
    with tr.span("embed", cat="forward"):
        tokens = batch["tokens"].to(dev)
        h = T.embed_tokens(cfg, params, tokens)

    def attn_step(lp, hn, kc, vc):
        return T.attn_decode_apply(cfg, lp["attn"], hn, kc, vc,
                                   cache["len"])[:3]

    def attn_core(q, k, v, kc, vc):
        return T.attn_decode_core(cfg, q, k, v, kc, vc, cache["len"])[:3]

    h, k_new, v_new = _layer_stack(cfg, params, sparse, cache, h, attn_step,
                                   attn_core, impl, epilogue=epilogue)
    with tr.span("lm_head", cat="forward"):
        logits = T.logits_from_hidden(cfg, params, h)
    return logits, {"k": k_new, "v": v_new, "len": cache["len"] + 1}


def prefill_chunk_sparse(cfg: ModelConfig, params: dict, sparse: dict,
                         cache: dict, batch: dict, impl: str | None = None,
                         proj_path: str = "dense", epilogue: bool = True,
                         device=None):
    """One chunked-prefill step: a C-token chunk lands at
    cache["len"]..; ``batch["n_valid"]`` (B,) marks the real tokens of a
    padded final chunk.  ``proj_path="dense"`` (default) runs the covered
    projections as GEMMs over the pruned copies; ``"kernel"`` feeds the
    packs with B*C columns."""
    dev = _check_device(params, device)
    tr = get_tracer()
    start = cache["len"]
    with tr.span("embed", cat="forward"):
        tokens = batch["tokens"].to(dev)
        n_valid = batch.get("n_valid")
        if n_valid is None:
            n_valid = torch.full_like(start, tokens.shape[1])
        h = T.embed_tokens(cfg, params, tokens)

    def attn_step(lp, hn, kc, vc):
        return T.attn_prefill_apply(cfg, lp["attn"], hn, kc, vc, start)[:3]

    def attn_core(q, k, v, kc, vc):
        return T.attn_prefill_core(cfg, q, k, v, kc, vc, start)[:3]

    h, k_new, v_new = _layer_stack(cfg, params, sparse, cache, h, attn_step,
                                   attn_core, impl, proj_path=proj_path,
                                   epilogue=epilogue)
    with tr.span("lm_head", cat="forward"):
        logits = T.logits_from_hidden(cfg, params, h)
    return logits, {"k": k_new, "v": v_new,
                    "len": start + n_valid.to(start.device)}


# --------------------------------------------------------------------------
# Stats
# --------------------------------------------------------------------------
def _plane_bytes(p: dict) -> tuple:
    """(value_bytes_total, index_bytes_total, per-layer value bytes): fp32
    planes cost 4 bytes/slot, quantized planes their packed accounting;
    the index plane is int32."""
    n_layers = len(p["nnz_per_layer"])
    index_total = 4 * p["padded_per_layer"] * n_layers
    if p["qplanes"] is not None:
        per_layer = np.sum([pl.value_bytes_by_lead() for pl in p["qplanes"]],
                           axis=0)
        return int(per_layer.sum()), index_total, [int(b) for b in per_layer]
    per = 4 * p["padded_per_layer"]
    return per * n_layers, index_total, [per] * n_layers


def _pack_stats(p: dict) -> dict:
    n_layers = len(p["nnz_per_layer"])
    padded = p["padded_per_layer"] * n_layers
    vbytes, ibytes, vbytes_layer = _plane_bytes(p)
    return {
        "nnz": int(p["nnz"]),
        "padded_slots": int(padded),
        "pad_frac": 1 - p["nnz"] / padded,
        "pad_frac_per_layer": [
            1 - int(n) / p["padded_per_layer"]
            for n in p["nnz_per_layer"]
        ],
        "bucket_rows": list(p["bucket_rows"]),
        "bucket_widths": list(p["widths"]),
        "single_bucket_pad_frac": 1 - p["nnz"] / max(
            1, p["plan"].single_bucket_slots * p["buckets"][0]["cols"].shape[2]
            * p["halves"] * n_layers),
        "value_plane_bytes": vbytes,
        "index_plane_bytes": ibytes,
        "value_plane_bytes_per_layer": vbytes_layer,
        "bits_per_nnz": 8.0 * vbytes / max(1, int(p["nnz"])),
        "bits_per_nnz_per_layer": [
            8.0 * b / max(1, int(n))
            for b, n in zip(vbytes_layer, p["nnz_per_layer"])
        ],
    }


def _proj_stats(g: dict, group_stats: dict, proj: str) -> dict:
    """Per-projection stats inside a group: exact nnz and padded slots
    (``proj_nnz`` / ``proj_padded``); a quantized value plane is
    attributed by padded-slot share (scale groups can straddle
    projections)."""
    n_layers = len(g["nnz_per_layer"])
    nnz_l = g["proj_nnz"][proj]
    padded_l = g["proj_padded"][proj]
    nnz, padded = int(nnz_l.sum()), int(padded_l.sum())
    share = padded / max(1, g["padded_per_layer"] * n_layers)
    vbytes = (int(round(group_stats["value_plane_bytes"] * share))
              if g["qplanes"] is not None else 4 * padded)
    return {
        "nnz": nnz,
        "padded_slots": padded,
        "pad_frac": 1 - nnz / max(1, padded),
        "pad_frac_per_layer": [1 - int(n) / max(1, int(p))
                               for n, p in zip(nnz_l, padded_l)],
        "value_plane_bytes": vbytes,
        "index_plane_bytes": 4 * padded,
        "bits_per_nnz": 8.0 * vbytes / max(1, nnz),
    }


def sparse_stats(sparse: dict) -> dict:
    """Whole-model, per-group, per-projection and per-layer padding and
    byte-plane stats: group entries carry the pack-level figures, each
    projection its own exact nnz / padded split under its own name
    (``w_gate``, ``wq``, ...).  ``total.bytes_per_token`` is the bytes a
    decode token streams, including the dense bytes of projections no
    group covers."""
    out: dict = {"quant": sparse.get("quant", "none"),
                 "attn_sparse": sparse.get("attn_sparse", False)}
    tot_nnz = tot_padded = tot_value = tot_index = 0
    for name, g in sparse["groups"].items():
        gs = _pack_stats(g)
        out[name] = gs
        for proj in g["projections"]:
            out[proj] = _proj_stats(g, gs, proj)
        n_layers = len(g["nnz_per_layer"])
        tot_nnz += g["nnz"]
        tot_padded += g["padded_per_layer"] * n_layers
        tot_value += gs["value_plane_bytes"]
        tot_index += gs["index_plane_bytes"]
    dense_bytes = int(sparse.get("dense_proj_bytes", 0))
    out["total"] = {
        "nnz": int(tot_nnz),
        "padded_slots": int(tot_padded),
        "pad_frac": 1 - tot_nnz / max(1, tot_padded),
        "value_plane_bytes": int(tot_value),
        "index_plane_bytes": int(tot_index),
        "bits_per_nnz": 8.0 * tot_value / max(1, tot_nnz),
        "packed_bytes_per_token": int(tot_value + tot_index),
        "dense_proj_bytes_per_token": dense_bytes,
        "bytes_per_token": int(tot_value + tot_index + dense_bytes),
    }
    return out
