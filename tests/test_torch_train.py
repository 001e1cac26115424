"""The port's training core against the JAX package's: ``loss_fn`` and
every gradient against ``jax.value_and_grad(repro.models.factory.loss_fn)``
at the smoke configs of all six families (MoE aux included, and an MoE
config that drops tokens), ``cross_entropy`` with a mask, one AdamW
step with and without the float32 master, ``lr_at``, the int8
error-feedback round trip, the microbatch split, and — inside the port —
microbatch against full batch, remat none / full / dots in bits, and the
pipeline as a pure function of (seed, step).

Tolerances: the loss within 5e-5 relative (the families' forward bound);
each gradient leaf within 2e-4 of its max|reference| (float32 backward
passes reorder sums in both packages: the reduced configs read at most
2.8e-5, rwkv6's through its per-token WKV recurrence, the rest under
6e-6); optimizer leaves within 1e-6 relative, bf16 params within one
bf16 step of 2^-8 relative; microbatches within 5e-5, the reference's own
bound for the same reordering."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro.train import train_step as RT  # noqa: E402

from _torch_parity import to_np  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim import compression as PC  # noqa: E402
from repro_torch.train import train_step as PT  # noqa: E402
from repro_torch.tree import flatten, map_with_path  # noqa: E402

FAMILIES = ["granite-3-2b", "phi3.5-moe-42b-a6.6b", "qwen2-vl-2b",
            "whisper-small", "rwkv6-1.6b", "zamba2-2.7b"]
LOSS_REL = 5e-5
GRAD_REL = 2e-4
B, S = 2, 24


def _cfgs(arch, **kw):
    return (ref_config(arch, reduced=True).replace(**kw),
            get_config(arch, reduced=True).replace(**kw))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, kw=()):
    cfg = ref_config(arch, reduced=True).replace(**dict(kw))
    params = RF.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch(cfg, seed=0):
    """tokens, labels, and Whisper's frames / the VLM's embeddings and
    vis_mask, as ``tests/test_models_smoke.py`` builds them, from numpy."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["embeddings"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        vis = np.zeros((B, S), bool)
        vis[:, :4] = True
        b["vis_mask"] = vis
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _port_value_and_grad(pcfg, tparams, pb):
    live = {k: p.detach().requires_grad_(True) for k, p in flatten(tparams)}
    loss, metrics = PF.loss_fn(
        pcfg, map_with_path(lambda k, _: live[k], tparams), pb)
    gs = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(live, gs)))


CASES = [(a, ()) for a in FAMILIES] + [
    # capacity 4 of 8 routed slots a group: tokens drop, and only the kept
    # ones carry gradient into the experts
    ("phi3.5-moe-42b-a6.6b", (("capacity_factor", 1.0),
                              ("moe_group_size", 8)))]


@pytest.mark.parametrize("arch,kw", CASES)
def test_loss_and_every_grad_match_reference(arch, kw):
    cfg, pcfg = _cfgs(arch, **dict(kw))
    params = _ref_params(arch, kw)
    rb, pb = _batch(cfg)

    def loss_of(p):
        return RF.loss_fn(cfg, p, rb)

    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ploss, pmet, pgrads = _port_value_and_grad(
        pcfg, params_from_numpy(params, "cpu"), pb)
    assert abs(float(ploss) - float(rloss)) <= LOSS_REL * abs(float(rloss))
    assert abs(float(pmet["aux"]) - float(rmet["aux"])) <= LOSS_REL * max(
        1.0, abs(float(rmet["aux"])))
    if cfg.family == "moe":
        assert float(pmet["aux"]) > 0
    want = dict(flatten(jax.tree.map(np.asarray, rgrads)))
    assert set(pgrads) == set(want)
    for name, g in pgrads.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-12)
        got = np.zeros_like(w) if g is None else to_np(g)
        err = float(np.abs(got - w).max()) / scale
        assert err <= GRAD_REL, (name, err)


def test_cross_entropy_with_mask_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = RF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        got = PF.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def _opt_trees(dtype):
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.standard_normal((8, 6)).astype(np.float32)},
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{"a": {"w": rng.standard_normal((8, 6)).astype(np.float32)},
              "b": rng.standard_normal((5,)).astype(np.float32) * 3}
             for _ in range(3)]
    rp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    pp = {"a": {"w": torch.from_numpy(params["a"]["w"])},
          "b": torch.from_numpy(params["b"])}
    pp = {"a": {"w": pp["a"]["w"].to(getattr(torch, dtype))},
          "b": pp["b"].to(getattr(torch, dtype))}
    return rp, pp, grads


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_steps_match_reference(dtype):
    """Three steps (the second clipped: its grads are scaled up) with the
    master on for bf16 params, off for float32 ones."""
    ocfg = PA.OptConfig(warmup_steps=2, decay_steps=20, peak_lr=1e-2,
                        grad_clip=5.0)
    rcfg = RA.OptConfig(warmup_steps=2, decay_steps=20, peak_lr=1e-2,
                        grad_clip=5.0)
    rp, pp, grads = _opt_trees(dtype)
    rs, ps = RA.init_opt_state(rcfg, rp), PA.init_opt_state(ocfg, pp)
    assert ("master" in ps) == ("master" in rs) == (dtype == "bfloat16")
    for i, g in enumerate(grads):
        if i == 1:
            g = jax.tree.map(lambda a: a * 10, g)
        rp, rs, rm = RA.apply_updates(rcfg, rp, jax.tree.map(jnp.asarray, g),
                                      rs)
        tg = {"a": {"w": torch.from_numpy(g["a"]["w"])},
              "b": torch.from_numpy(g["b"])}
        out, ps2, pm = PA.apply_updates(ocfg, pp, tg, ps)
        assert out is pp and ps2 is ps             # in place
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(ps["step"]) == int(rs["step"]) == 3
    for key in ("mu", "nu") + (("master",) if "master" in rs else ()):
        for (name, got), (_, want) in zip(flatten(ps[key]),
                                          flatten(jax.tree.map(np.asarray,
                                                               rs[key]))):
            np.testing.assert_allclose(to_np(got), want, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key}/{name}")
    rtol = 2 ** -8 if dtype == "bfloat16" else 1e-6
    for (name, got), (_, want) in zip(flatten(pp), flatten(
            jax.tree.map(lambda a: np.asarray(a, np.float32), rp))):
        assert str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(to_np(got), want, rtol=rtol, atol=1e-7,
                                   err_msg=name)


def test_lr_schedule_matches_reference():
    ocfg = PA.OptConfig(warmup_steps=2, decay_steps=200, peak_lr=1e-3)
    rcfg = RA.OptConfig(warmup_steps=2, decay_steps=200, peak_lr=1e-3)
    for s in (0, 1, 2, 3, 50, 199, 200, 400):
        np.testing.assert_allclose(float(PA.lr_at(ocfg, s)),
                                   float(RA.lr_at(rcfg, s)), rtol=1e-6)
    assert float(PA.lr_at(ocfg, 0)) == 0.0
    assert float(PA.lr_at(ocfg, 2)) == pytest.approx(ocfg.peak_lr)
    assert float(PA.lr_at(ocfg, 200)) == pytest.approx(
        ocfg.peak_lr * ocfg.min_lr_frac, rel=1e-3)


def test_compression_round_trip_matches_reference():
    """The error-feedback round trip over several steps, and rounding
    half to even (127 pins the scale at 1: .5 cases land on even codes)."""
    rng = np.random.default_rng(5)
    err_r = RC.init_error_state({"w": jnp.zeros((16, 16))})
    err_p = PC.init_error_state({"w": torch.zeros((16, 16))})
    for _ in range(4):
        g = (rng.standard_normal((16, 16)) * 1e-3).astype(np.float32)
        deq_r, err_r = RC.ef_compress_grads({"w": jnp.asarray(g)}, err_r)
        deq_p, err_p = PC.ef_compress_grads({"w": torch.from_numpy(g)}, err_p)
        np.testing.assert_allclose(to_np(deq_p["w"]), np.asarray(deq_r["w"]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(to_np(err_p["w"]), np.asarray(err_r["w"]),
                                   rtol=1e-5, atol=1e-10)
    half = np.array([127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5], np.float32)
    (qp, sp), = PC.compress_tree({"h": torch.from_numpy(half)}).values()
    (qr, sr), = RC.compress_tree({"h": jnp.asarray(half)}).values()
    assert qp.tolist() == np.asarray(qr).tolist() == [127, 0, 2, 2, -2, 0, 4]
    assert float(sp) == float(sr) == 1.0
    back = PC.decompress_tree({"h": (qp, sp)})["h"]
    assert back.tolist() == [127, 0, 2, 2, -2, 0, 4]


def test_microbatch_split_matches_reference():
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 9, (4, 3)).astype(np.int32),
             "positions3": rng.integers(0, 9, (3, 4, 3)).astype(np.int32)}
    want = RT._split_microbatches(jax.tree.map(jnp.asarray, batch), 2)
    got = PT._split_microbatches(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    for i, mb in enumerate(got):
        for k, v in mb.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k][i]))


def _state(pcfg, ocfg, seed=0):
    return PT.init_train_state(pcfg, ocfg, torch.Generator().manual_seed(seed),
                               device="cpu")


def test_microbatch_matches_full_batch():
    _, pcfg = _cfgs("granite-3-2b", n_layers=2)
    ocfg = PA.OptConfig(warmup_steps=2, decay_steps=200, peak_lr=1e-3)
    pipe = SyntheticPipeline.for_model(pcfg, ShapeConfig("t", 16, 4, "train"),
                                       device="cpu")
    s1, s2 = _state(pcfg, ocfg), _state(pcfg, ocfg)
    for step in range(3):
        _, m1 = PT.train_step_fn(pcfg, ocfg, s1, pipe.batch_at(step))
        _, m2 = PT.train_step_fn(pcfg, ocfg, s2, pipe.batch_at(step),
                                 microbatches=2)
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-5
    assert set(m2) == {"loss", "grad_norm", "lr"}
    for (name, a), (_, b) in zip(flatten(s1["params"]),
                                 flatten(s2["params"])):
        assert float((a - b).abs().max()) < 5e-5, name


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gives_the_same_bits(arch, remat):
    """Loss and every gradient equal in bits under "none" and a remat
    policy (the layer body is recomputed, not changed)."""
    cfg, pcfg = _cfgs(arch)
    tparams = params_from_numpy(_ref_params(arch), "cpu")
    _, pb = _batch(cfg, seed=7)
    l0, _, g0 = _port_value_and_grad(pcfg.replace(remat="none"), tparams, pb)
    l1, _, g1 = _port_value_and_grad(pcfg.replace(remat=remat), tparams, pb)
    assert torch.equal(l0, l1)
    for name, g in g0.items():
        assert (g is None and g1[name] is None) or torch.equal(g, g1[name]), \
            name


def test_pipeline_is_a_pure_function_of_seed_and_step():
    cfg = get_config("granite-3-2b", reduced=True)
    shape = ShapeConfig("t", 32, 4, "train")
    a = SyntheticPipeline.for_model(cfg, shape, seed=3, device="cpu")
    b = SyntheticPipeline.for_model(cfg, shape, seed=3, device="cpu")
    for step in (0, 5, 1000):
        x, y = a.batch_at(step), b.batch_at(step)
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["labels"], y["labels"])
        assert x["tokens"].dtype == torch.int32
        assert x["tokens"].shape == (4, 32)
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    c = SyntheticPipeline.for_model(cfg, shape, seed=4, device="cpu")
    assert not torch.equal(a.batch_at(0)["tokens"], c.batch_at(0)["tokens"])
    toks = torch.cat([a.batch_at(s)["tokens"].flatten() for s in range(50)])
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    # the square of a uniform: mean vocab / 3, skewed to small ids
    assert abs(float(toks.float().mean()) / cfg.vocab_size - 1 / 3) < 0.02
    assert float((toks < cfg.vocab_size // 4).float().mean()) > 0.45
    pipe, step = SyntheticPipeline.restore(cfg, shape, a.state(9),
                                           device="cpu")
    assert step == 9 and torch.equal(pipe.batch_at(9)["tokens"],
                                     a.batch_at(9)["tokens"])
