"""The sharded decode step (``serve_step.make_serve_step``: tensor-parallel
products on params at ``serve_param_pspecs``, the KV cache at
``cache_pspecs``) of all six families on gloo process groups against
the world-size-1 ``serve_step_fn``.

One launch per mesh -- 4 processes on (2, 2), 2 on (1, 2), 2 on (2, 1)
and 4 on (1, 4), spawned as subprocesses on a ``FileStore`` and started
together -- runs every case of ``CASES`` on reduced configs (float32): a
cache primed with a 3-token prompt by ``factory.prefill_chunk`` (token
replay for the families without it; S_max 8), then 4 greedy decode
steps, which cross from one sequence shard to the next.  The cases, on
granite unless named:

  * heads: 2 KV heads, split on ``model`` (the cache's KV dim): the
    Megatron pattern, each rank's own q / k / v columns and wo rows;
  * seq: one KV head, so the sequence splits on ``model``, the q / k / v
    columns are all-gathered along ``model`` and each rank combines its
    partial softmax with the others' (compute-dtype cache and int8 cache
    with its scales);
  * odd batch: B 3 does not divide ``data``, so the batch stays whole
    and the sequence splits over (data, model);
  * heads_moe: phi3.5-moe, each rank running its ``n_experts / model``
    experts' F slice on ``data`` over the whole decode group;
  * heads_vlm: qwen2-vl, M-RoPE positions from the local sequences'
    lengths;
  * b1, b1_moe, b1_vlm: B 1 on the ``global_batch=1`` layout (the dry
    run's ``long_500k``): the attention's contraction dim and w_down's
    output split on ``data`` too, so their partial products are summed
    over it (qwen2-vl's QKV biases added after the sum);
  * zamba2 (2 layers, one application of the shared block), whisper
    (its cross K / V primed from random frames first, then written
    again on the shards by ``prime_cross_sharded``) and rwkv6 (1
    layer), and zamba2 and rwkv6 at B 1 on the ``global_batch=1``
    layout: the Mamba2 conv window by channel and SSM state by head dim
    on ``model``, rwkv6's WKV state by K.  The depth cuts keep the
    cache inside the bounds of the row-parallel sums' rounding: at
    their reduced depth (6 and 4 layers) the worst cache leaf reads
    1.8e-6 (zamba2's SSM state) and 1.0e-6 (rwkv6's WKV state), beside
    3.6e-6 and 2.3e-6 that a 1e-7 relative perturbation of the params
    moves the world-size-1 step by (``scripts/spmd_depth_gap.py``).

Each step's greedy tokens equal the world-size-1 step's and its logits
are within 1e-5 (max |diff| / max |ref|); after the steps each rank's
cache shards equal the slices of the world-size-1 cache (the K / V
writes are exact; within 1e-6 where the float32 K / V differ in the
last bits, 3e-6 for zamba2's SSM state), every leaf of params and
cache is at its spec's shard shape, the donated state leaves are the
step's own (written in place) and a step with ``donate_cache=False``
leaves its input cache as it was.  No collective of the step moves a
param leaf: every all-gather's output is at most B_global x the widest
activation row (d_model, the q width, the padded vocab, zamba2's
``in_proj`` output), and no collective's operand has the shape of a
param leaf, whole or shard, stacked or one layer's."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LOGIT_REL_TOL = 1e-5
CACHE_REL_TOL = 1e-6
# zamba2's SSM state: each step adds dt * x * B, the product of three
# projections, each within the K / V cache's rounding of the
# world-size-1 step's (read 1.45e-6 at most)
SSM_REL_TOL = 3 * CACHE_REL_TOL
TIMEOUT_S = 300
MESHES = ((2, 2), (1, 2), (2, 1), (1, 4))
MOE, VLM = "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b"
# name -> (arch, config overrides, batch, serve_param_pspecs'
# global_batch: None for make_serve_step's layout)
CASES = {
    "heads": ("granite-3-2b", {}, 4, None),
    "heads_int8": ("granite-3-2b", {"kv_cache_dtype": "int8"}, 4, None),
    "seq": ("granite-3-2b", {"n_kv_heads": 1}, 4, None),
    "seq_int8": ("granite-3-2b", {"n_kv_heads": 1, "kv_cache_dtype": "int8"},
                 4, None),
    "odd_batch": ("granite-3-2b", {"n_kv_heads": 1}, 3, None),
    "heads_moe": (MOE, {}, 4, None),
    "heads_vlm": (VLM, {}, 4, None),
    "b1": ("granite-3-2b", {}, 1, 1),
    "b1_moe": (MOE, {}, 1, 1),
    "b1_vlm": (VLM, {}, 1, 1),
    "zamba2": ("zamba2-2.7b", {"n_layers": 2}, 4, None),
    "whisper": ("whisper-small", {}, 4, None),
    "rwkv6": ("rwkv6-1.6b", {"n_layers": 1}, 4, None),
    "b1_zamba2": ("zamba2-2.7b", {"n_layers": 2}, 1, 1),
    "b1_rwkv6": ("rwkv6-1.6b", {"n_layers": 1}, 1, 1),
}
PROMPT, STEPS, MAX_LEN = 3, 4, 8

_WORKER = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5]
    shape = tuple(json.loads(sys.argv[5]))
    cases = json.loads(sys.argv[6])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs.registry import get_config
    from repro_torch.models import factory, whisper
    from repro_torch.serve.serve_step import make_serve_step, serve_step_fn
    from repro_torch.sharding import partition as PP
    from repro_torch.tree import flatten, tree_map

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    res = {}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / max(float(b.double().abs().max()), 1e-30))

    # the collectives of the step: (kind, operand shape, output numel)
    seen, spying = [], [False]

    def spy(kind, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if spying[0] and out is not args[0]:
                seen.append((kind, list(args[0].shape), out.numel()))
            return out
        return wrapped

    for kind, name in (("all-gather", "_all_gather_dim"),
                       ("reduce-scatter", "_reduce_scatter_dim"),
                       ("all-reduce", "all_reduce")):
        setattr(PP, name, spy(kind, getattr(PP, name)))
    for name, (arch, over, b, gb) in cases.items():
        cfg = get_config(arch, reduced=True).replace(**over)
        gen = torch.Generator().manual_seed(0)
        params = factory.init_params(cfg, gen, device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (b, %(prompt)d),
                               generator=gen, dtype=torch.int32)
        cache = factory.init_cache(cfg, b, %(max_len)d, device="cpu")
        frames = None
        if cfg.family == "audio":       # the encoder's cross K / V first
            frames = torch.randn((b, cfg.encoder_seq, cfg.d_model),
                                 generator=gen)
            with torch.no_grad():
                cache = whisper.prime_cross(cfg, params, cache, frames)
        with torch.no_grad():
            if factory.supports_chunked_prefill(cfg):
                _, cache = factory.prefill_chunk(cfg, params, cache,
                                                 {"tokens": prompt})
            else:
                for j in range(%(prompt)d):
                    _, cache = factory.decode_step(
                        cfg, params, cache, {"tokens": prompt[:, j:j + 1]})
        tok = {"tokens": prompt[:, -1:]}
        step, sp, cs, bs = make_serve_step(cfg, mesh, params, cache, tok)
        if gb is not None:
            sp = PP.serve_param_pspecs(params, mesh, global_batch=gb)
        placed_p = PP.logical_to_sharding(params, sp, mesh)
        placed_c = PP.logical_to_sharding(tree_map(torch.clone, cache), cs,
                                          mesh)
        state_keys = [k for k in cache if k != "len"]
        kv_before = {k: placed_c[k] for k in state_keys}
        primed = None
        if frames is not None:
            # the cross K / V written on the shards: each rank's slices
            with torch.no_grad():
                mine = whisper.prime_cross_sharded(
                    cfg, tree_map(lambda t: t.to_local(), placed_p),
                    tree_map(lambda t: t.to_local(), placed_c),
                    PP.local_slice(frames, (cs["k"][1], None, None), mesh),
                    PP.Layout.of(placed_p), PP.Layout.of(placed_c))
            primed = max(rel(mine[k], PP.local_slice(cache[k], cs[k], mesh))
                         for k in ("cross_k", "cross_v"))
        # a step that does not donate leaves its input as it was
        keep = {k: v.to_local().clone() for k, v in placed_c.items()}
        nodon, _, _, _ = make_serve_step(cfg, mesh, params, cache, tok,
                                         donate_cache=False)
        nodon(placed_p, placed_c, PP.logical_to_sharding(tok, bs, mesh))
        kept = all(torch.equal(placed_c[k].to_local(), v)
                   for k, v in keep.items())
        want_c, errs, same = cache, [], []
        del seen[:]
        for _ in range(%(steps)d):
            batch = PP.logical_to_sharding(tok, bs, mesh)
            spying[0] = True
            nxt, logits, placed_c = step(placed_p, placed_c, batch)
            spying[0] = False
            with torch.no_grad():
                want_n, want_l, want_c = serve_step_fn(cfg, params, want_c,
                                                       tok)
            errs.append(rel(logits, want_l))
            same.append(bool(torch.equal(nxt, want_n)))
            tok = {"tokens": want_n}
        flat_s = dict(flatten(cs))
        cache_err, shapes = {}, {}
        for path, t in flatten(placed_c):
            ref = PP.local_slice(dict(flatten(want_c))[path], flat_s[path],
                                 mesh)
            shapes[path] = [list(t.to_local().shape), list(ref.shape)]
            cache_err[path] = ("equal" if torch.equal(t.to_local(), ref)
                               else rel(t.to_local(), ref))
        p_specs = dict(flatten(sp))
        leaf_shapes = set()
        for path, t in flatten(placed_p):
            local = list(t.to_local().shape)
            shapes["params/" + path] = [
                local, list(PP.local_slice(t, p_specs[path], mesh).shape)]
            for sh in (local, list(t.shape)):
                leaf_shapes.update({tuple(sh), tuple(sh[1:])})
        # the attention cache, or rwkv6's WKV state (batch, H, K, V):
        # its dims 2 and 3 take the sequence's and the KV heads' rules
        key = "k" if "k" in cs else "wkv"
        widths = [cfg.d_model, cfg.n_heads * cfg.hd, cfg.padded_vocab]
        if cfg.family == "hybrid":      # the Mamba2 in_proj's output row
            d_inner = cfg.ssm_expand * cfg.d_model
            widths.append(2 * d_inner + 2 * cfg.ssm_state
                          + d_inner // cfg.ssm_head_dim)
        res[name] = {
            "logit_err": errs, "tokens_equal": same, "cache_err": cache_err,
            "shapes": shapes, "kept": kept,
            "donated": all(placed_c[k] is v for k, v in kv_before.items()),
            "cache_spec": [list(PP.axis_names(a)) for a in cs[key]],
            "split": [PP.mesh_axis_size(mesh, a) > 1 for a in cs[key]],
            "collectives": len(seen),
            "largest_gather": max([n for k, _, n in seen
                                   if k == "all-gather"], default=0),
            "row_bound": b * max(widths),
            "param_moved": [s_ for _, s_, _ in seen
                            if tuple(s_) in leaf_shapes],
            "n_kv_heads": cache[key].shape[3], "batch": b,
            "path": "sharded" if factory.shards(cfg, mesh) else "gathered",
            "primed": primed}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""") % {"prompt": PROMPT, "max_len": MAX_LEN, "steps": STEPS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_decode")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    launches = {}
    for shape in MESHES:
        tag = "x".join(map(str, shape))
        world = shape[0] * shape[1]
        launches[shape] = (tmp / f"{tag}.json", [subprocess.Popen(
            [sys.executable, str(script), str(r), str(world),
             str(tmp / f"store_{tag}"), str(tmp / f"{tag}.json"),
             json.dumps(shape), json.dumps(CASES)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)])
    out = {}
    try:
        for shape, (path, procs) in launches.items():
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
            assert all(p.returncode == 0 for p in procs), \
                "\n".join(logs)[-4000:]
            out[shape] = json.loads(path.read_text())
    finally:
        for _, procs in launches.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


_CASES = [(shape, name) for shape in MESHES for name in CASES]
_IDS = [f"{'x'.join(map(str, s))}-{n}" for s, n in _CASES]


@pytest.mark.parametrize("shape,name", _CASES, ids=_IDS)
def test_sharded_decode_matches_one_rank(runs, shape, name):
    """Tokens equal, logits and cache within their bounds, on the
    sharded path; whisper's cross K / V written on the shards
    (``prime_cross_sharded``) within the cache's bound of the slices of
    ``prime_cross``'s."""
    res = runs[shape][name]
    assert res["path"] == "sharded"
    assert all(res["tokens_equal"]), res["tokens_equal"]
    assert max(res["logit_err"]) <= LOGIT_REL_TOL, res["logit_err"]
    bad = {k: v for k, v in res["cache_err"].items()
           if v != "equal" and not v <= (SSM_REL_TOL if k == "ssm"
                                         else CACHE_REL_TOL)}
    assert not bad, bad
    if res["primed"] is not None:
        assert res["primed"] <= CACHE_REL_TOL, res["primed"]


@pytest.mark.parametrize("shape,name", _CASES, ids=_IDS)
def test_decode_holds_only_its_shards(runs, shape, name):
    """Every leaf of params and cache at its spec's shard shape, the cache
    split as the case says (for rwkv6 its WKV state (L, B, H, K, V),
    whose H and K take the sequence's and the KV heads' rules), every
    state leaf donated in place, and a step without donation leaves its
    input cache as it was."""
    res = runs[shape][name]
    bad = {p: s for p, s in res["shapes"].items() if s[0] != s[1]}
    assert not bad, bad
    assert res["donated"] and res["kept"]
    data, model = shape
    _, b_ax, s_ax, kv_ax, _ = res["cache_spec"]
    _, b_split, s_split, kv_split, _ = res["split"]
    idle = res["batch"] % data != 0        # the batch stays whole
    if idle:
        assert not b_split and "data" in s_ax and s_split
    else:
        assert b_ax == ["data"] and b_split == (data > 1)
    if res["n_kv_heads"] % model == 0:     # the heads split on model
        assert kv_ax == ["model"] and kv_split == (model > 1)
        assert s_split == idle
    else:                                  # the sequence picks model up
        assert not kv_split and "model" in s_ax and s_split


@pytest.mark.parametrize("shape,name", _CASES, ids=_IDS)
def test_decode_moves_no_param_leaf(runs, shape, name):
    """The step moves activations only: its largest all-gather output is
    at most B_global x the widest activation row, and no collective's
    operand has a param leaf's shape (whole, shard, or one layer's)."""
    res = runs[shape][name]
    assert res["collectives"] > 0
    assert res["largest_gather"] <= res["row_bound"], res
    assert not res["param_moved"], res["param_moved"]
