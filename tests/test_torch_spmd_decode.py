"""The sharded decode step (``serve_step.make_serve_step``: params at
``serve_param_pspecs`` gathered a layer at a time, the KV cache at
``cache_pspecs``) of the dense, MoE and VLM families on gloo process
groups against the world-size-1 ``serve_step_fn``.

One launch of 4 processes on a (2, 2) mesh and one of 2 on (1, 2),
spawned as subprocesses on a ``FileStore``, run every case of ``CASES``
on reduced configs (float32): a cache primed with a 3-token prompt by
``factory.prefill_chunk`` (token replay for the families without it;
S_max 8), then 4 greedy decode steps, which cross from one sequence
shard to the next.  The cases, on granite unless named:

  * heads: 2 KV heads, split on ``model`` (the cache's KV dim);
  * seq: one KV head, so the sequence splits on ``model`` and each rank
    combines its partial softmax with the others' (compute-dtype cache
    and int8 cache with its scales);
  * odd batch: B 3 does not divide ``data``, so the batch stays whole
    and the sequence splits over (data, model);
  * heads_moe: phi3.5-moe, each rank running its ``n_experts / model``
    experts (gathered along ``data`` only: no gather along ``model``
    returns an expert axis whole); at (2, 2) the decode group (the global
    batch of 4) spans the two data ranks;
  * heads_vlm: qwen2-vl, M-RoPE positions from the local sequences'
    lengths.

Each step's greedy tokens equal the world-size-1 step's and its logits
are within 1e-5 (max |diff| / max |ref|); after the steps each rank's
cache shards equal the slices of the world-size-1 cache (the K / V
writes are exact; within 1e-6 where the float32 K / V differ in the
last bits), every leaf of params and cache is at its spec's shard shape,
the donated K / V leaves are the step's own (written in place) and a
step with ``donate_cache=False`` leaves its input cache as it was."""
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
TIMEOUT_S = 300
MESHES = ((2, 2), (1, 2))
# name -> (arch, config overrides, batch)
CASES = {
    "heads": ("granite-3-2b", {}, 4),
    "heads_int8": ("granite-3-2b", {"kv_cache_dtype": "int8"}, 4),
    "seq": ("granite-3-2b", {"n_kv_heads": 1}, 4),
    "seq_int8": ("granite-3-2b", {"n_kv_heads": 1, "kv_cache_dtype": "int8"},
                 4),
    "odd_batch": ("granite-3-2b", {"n_kv_heads": 1}, 3),
    "heads_moe": ("phi3.5-moe-42b-a6.6b", {}, 4),
    "heads_vlm": ("qwen2-vl-2b", {}, 4),
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
    from repro_torch.models import factory
    from repro_torch.serve.serve_step import make_serve_step, serve_step_fn
    from repro_torch.sharding import partition as PP
    from repro_torch.tree import flatten, tree_map

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    res = {}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()
                     / max(float(b.double().abs().max()), 1e-30))

    gathered = []

    def spy(t, spec, mesh_, axes):
        out = gather_along(t, spec, mesh_, axes)
        gathered.append(list(out.shape))
        return out

    gather_along, PP.gather_along = PP.gather_along, spy
    for name, (arch, over, b) in cases.items():
        cfg = get_config(arch, reduced=True).replace(**over)
        gen = torch.Generator().manual_seed(0)
        params = factory.init_params(cfg, gen, device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (b, %(prompt)d),
                               generator=gen, dtype=torch.int32)
        cache = factory.init_cache(cfg, b, %(max_len)d, device="cpu")
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
        placed_p = PP.logical_to_sharding(params, sp, mesh)
        placed_c = PP.logical_to_sharding(tree_map(torch.clone, cache), cs,
                                          mesh)
        kv_before = {k: placed_c[k] for k in ("k", "v")}
        # a step that does not donate leaves its input as it was
        keep = {k: v.to_local().clone() for k, v in placed_c.items()}
        nodon, _, _, _ = make_serve_step(cfg, mesh, params, cache, tok,
                                         donate_cache=False)
        nodon(placed_p, placed_c, PP.logical_to_sharding(tok, bs, mesh))
        kept = all(torch.equal(placed_c[k].to_local(), v)
                   for k, v in keep.items())
        want_c, errs, same = cache, [], []
        del gathered[:]
        for _ in range(%(steps)d):
            nxt, logits, placed_c = step(placed_p, placed_c,
                                         PP.logical_to_sharding(tok, bs,
                                                                mesh))
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
        for path, t in flatten(placed_p):
            shapes["params/" + path] = [
                list(t.to_local().shape),
                list(PP.local_slice(t, p_specs[path], mesh).shape)]
        res[name] = {
            "logit_err": errs, "tokens_equal": same, "cache_err": cache_err,
            "shapes": shapes, "kept": kept,
            "donated": all(placed_c[k] is v for k, v in kv_before.items()),
            "cache_spec": [list(PP.axis_names(a)) for a in cs["k"]],
            "split": [PP.mesh_axis_size(mesh, a) > 1 for a in cs["k"]],
            # the leading dim of each (E, D, F) / (E, F, D) expert leaf
            # the steps gathered
            "expert_rows": sorted({s[0] for s in gathered if s[1:] in (
                [cfg.d_model, cfg.d_ff], [cfg.d_ff, cfg.d_model])}),
            "n_experts": cfg.n_experts,
            "model": PP.mesh_axis_size(mesh, "model")}
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
    res = runs[shape][name]
    assert all(res["tokens_equal"]), res["tokens_equal"]
    assert max(res["logit_err"]) <= LOGIT_REL_TOL, res["logit_err"]
    bad = {k: v for k, v in res["cache_err"].items()
           if v != "equal" and not v <= CACHE_REL_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shape,name", _CASES, ids=_IDS)
def test_decode_holds_only_its_shards(runs, shape, name):
    """Every leaf of params and cache at its spec's shard shape, the cache
    split as the case says, the K / V leaves donated in place, and a
    step without donation leaves its input cache as it was."""
    res = runs[shape][name]
    bad = {p: s for p, s in res["shapes"].items() if s[0] != s[1]}
    assert not bad, bad
    assert res["donated"] and res["kept"]
    _, b_ax, s_ax, kv_ax, _ = res["cache_spec"]
    _, b_split, s_split, kv_split, _ = res["split"]
    if name.startswith("heads"):
        assert kv_ax == ["model"] and kv_split and not s_split
    elif name == "odd_batch" and shape[0] > 1:
        assert not b_split and s_ax == ["data", "model"] and s_split
    else:
        assert s_ax == ["model"] and s_split and not kv_split
    if shape[0] > 1 and name != "odd_batch":
        assert b_ax == ["data"] and b_split
    if name == "heads_moe":
        assert res["expert_rows"] == [res["n_experts"] // res["model"]]
    else:
        assert res["expert_rows"] == []
