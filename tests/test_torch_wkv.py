"""The WKV recurrence as one op (``kernels/wkv.py``) on the CPU: its plain
versions (``kernels/ref.wkv6_ref`` / ``wkv6_bwd_ref``), the op's
``torch.autograd.Function`` (``_WKV6``, which launches the kernels; here
run with the plain versions in their place, ``plain_kernels``), the
dispatch of ``wkv6`` and ``models/rwkv._wkv``, and the op as the dry run
traces it, at the reduced rwkv6 config (d_model 128, 2 heads of 64) and
small S.

Tolerances: the explicit backward against autograd of the per-token loop
within 1e-6 of each gradient's max (two float32 orders of the same sums
over S <= 24 steps: ~2e-7 read); the port's ``time_mix_apply`` through
the Function against ``jax.value_and_grad`` of the reference's, the
output and the state within 2e-6 of max|reference| and every gradient
within 5e-6 of its max (read over the six cases, seeds 0-2 with and
without ``valid``: outputs and states within 3.3e-7, gradients within
7.4e-7, worst last_x; ``tests/test_torch_train.py``'s 2e-4 would sit
~300x above the reading); chunks of the sequence in
bits (the loop runs one token at a time); the K slices' partial ``y``
summed within 1e-6 of max|y| (one more float32 rounding a slice)."""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import factory as RF  # noqa: E402
from repro.models import rwkv as RR  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ref as KR  # noqa: E402
from repro_torch.kernels import wkv as WKV  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_analysis import CostMode  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.models import rwkv as PR  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "rwkv6-1.6b"
GRAD_TOL = 1e-6         # explicit backward vs autograd of the loop
REF_REL, REF_GRAD = 2e-6, 5e-6      # the port vs the JAX package
SLICE_TOL = 1e-6        # K-slice partials summed vs the whole y


@pytest.fixture
def plain_kernels(monkeypatch):
    """``_WKV6`` on CPU tensors: its two kernel calls replaced by the plain
    versions, the forward saving the initial state as its "checkpoints",
    from which ``wkv6_bwd_ref`` recomputes the states."""
    def fwd(r, k, v, w, u, state, chunk=0):
        return (*KR.wkv6_ref(r, k, v, w, u, state), state)

    monkeypatch.setattr(WKV, "wkv6_cuda", fwd)
    monkeypatch.setattr(WKV, "wkv6_bwd_cuda", KR.wkv6_bwd_ref)
    return WKV._WKV6.apply


def _inputs(b, s, h, kp, vd, seed=0, dtype=torch.float32):
    """Seeded numpy r, k, v, w in (0, 1), u and a nonzero state."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    r, k = t(b, s, h, kp), t(b, s, h, kp)
    v = t(b, s, h, vd)
    w = torch.from_numpy(rng.uniform(0.3, 0.99, (b, s, h, kp))
                         .astype(np.float32))
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, t(h, kp, scale=0.1),
            t(b, h, kp, vd, scale=0.5))


@pytest.mark.parametrize("kp", [64, 16])
def test_plain_backward_matches_autograd_of_the_loop(kp, plain_kernels):
    """(a) ``wkv6_bwd_ref`` against ``torch.autograd`` of ``wkv6_ref``:
    all six gradients, at the whole head (K' 64) and a K slice (16), from
    a nonzero initial state; the Function on the plain versions gives the
    same."""
    ins = _inputs(2, 11, 2, kp, 64, seed=kp)
    live = [t.clone().requires_grad_(True) for t in ins]
    y, st = KR.wkv6_ref(*live)
    rng = np.random.default_rng(1)
    gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    gs = torch.from_numpy(rng.standard_normal(st.shape).astype(np.float32))
    want = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), live)
    got = KR.wkv6_bwd_ref(*ins, gy, gs)
    for name, g, w in zip("r k v w u state".split(), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert float((g - w).abs().max()) <= GRAD_TOL * float(
            w.abs().max()), name
    live2 = [t.clone().requires_grad_(True) for t in ins]
    y2, st2 = plain_kernels(*live2)
    assert torch.equal(y2, y.detach()) and torch.equal(st2, st.detach())
    fn = torch.autograd.grad((y2 * gy).sum() + (st2 * gs).sum(), live2)
    for g, h in zip(fn, got):
        assert torch.equal(g, h)


def test_function_returns_grads_in_the_inputs_dtypes(plain_kernels):
    """bf16 r / k / v get bf16 gradients, as autograd of the loop's
    ``.float()`` casts gives them, and equal its values."""
    ins = _inputs(1, 6, 2, 16, 16, seed=4, dtype=torch.bfloat16)
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    ya, sa = plain_kernels(*a)
    yb, sb = KR.wkv6_ref(*b)
    ga = torch.autograd.grad(ya.sum() + sa.sum(), a)
    gb = torch.autograd.grad(yb.sum() + sb.sum(), b)
    for x, z in zip(ga, gb):
        assert x.dtype == z.dtype
        assert float((x.float() - z.float()).abs().max()) <= 1e-2 * float(
            z.float().abs().max())


def _tm_case(valid: bool, seed: int = 0):
    """Layer 0's time-mix params of the reduced rwkv6 (reference init), a
    seeded x, last_x, state, output and state cotangents, and a valid
    mask with a padded tail."""
    cfg = ref_config(ARCH, reduced=True)
    params = RF.init_params(cfg, jax.random.PRNGKey(seed))
    tm = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["tm"])
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    b, s = 2, 12
    rng = np.random.default_rng(seed + 7)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    st = (0.3 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    gout = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    gst = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    mask = None
    if valid:
        mask = np.ones((b, s), bool)
        mask[1, 7:] = False
    return cfg, tm, x, last, st, gout, gst, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("valid", [False, True])
def test_time_mix_through_the_op_matches_reference(valid, seed, monkeypatch,
                                                  plain_kernels):
    """(b) the port's ``time_mix_apply`` with the WKV through the op's
    Function (on ``wkv6_ref`` / ``wkv6_bwd_ref``) against
    ``jax.value_and_grad`` of the reference's, with and without
    ``valid``: the output, the new state, and the gradients of every
    param, x, last_x and the initial state."""
    cfg, tm, x, last, st, gout, gst, mask = _tm_case(valid, seed)
    pcfg = get_config(ARCH, reduced=True)

    def ref_loss(p, x, last, st):
        out, _, new = RR.time_mix_apply(
            cfg, p, x, last, st, None if mask is None else jnp.asarray(mask))
        return (out * gout).sum() + (new * gst).sum(), (out, new)

    (_, (rout, rst)), rgrads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jax.tree.map(jnp.asarray, tm), jnp.asarray(x), jnp.asarray(last),
        jnp.asarray(st))

    calls = []

    def through_op(*args):
        calls.append(1)
        return plain_kernels(*args)

    monkeypatch.setattr(PR, "_wkv", through_op)
    tp = params_from_numpy(tm, "cpu")
    live = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx, tlast, tst = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, last, st))
    out, _, new = PR.time_mix_apply(
        pcfg, live, tx, tlast, tst,
        None if mask is None else torch.from_numpy(mask))
    loss = ((out * torch.from_numpy(gout)).sum()
            + (new * torch.from_numpy(gst)).sum())
    names = list(live)
    grads = torch.autograd.grad(loss, [live[k] for k in names]
                                + [tx, tlast, tst])
    assert calls == [1]
    for got, want in ((out, rout), (new, rst)):
        w = np.asarray(want)
        err = np.abs(got.detach().numpy() - w).max()
        assert err <= REF_REL * np.abs(w).max()
    want = [np.asarray(rgrads[0][k]) for k in names] + [
        np.asarray(g) for g in rgrads[1:]]
    for name, g, w in zip(names + ["x", "last_x", "state"], grads, want):
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= REF_GRAD * max(np.abs(w).max(), 1e-12), name


@pytest.mark.parametrize("impl", ["plain", "op"])
def test_chunks_carry_the_state_in_bits(impl):
    """(c) one call over S against two over S / 2 that carry the state:
    ``y`` and the final state equal in bits (the plain loop, and the
    op's entry point on the CPU)."""
    fn = KR.wkv6_ref if impl == "plain" else WKV.wkv6
    r, k, v, w, u, st = _inputs(2, 24, 2, 64, 64, seed=5)
    y, s1 = fn(r, k, v, w, u, st)
    h = 12
    ya, sa = fn(r[:, :h], k[:, :h], v[:, :h], w[:, :h], u, st)
    yb, sb = fn(r[:, h:], k[:, h:], v[:, h:], w[:, h:], u, sa)
    assert torch.equal(torch.cat([ya, yb], 1), y)
    assert torch.equal(sb, s1)
    # decode: one token at a time from the carried state
    ys, s = [], st
    for t in range(r.shape[1]):
        yt, s = fn(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                   w[:, t:t + 1], u, s)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, 1), y) and torch.equal(s, s1)


def test_k_slice_partials_sum_to_the_whole():
    """(c) the sharded decode's split: each K slice of every head (K' 16
    of 64) gives a partial ``y`` and its slice of the state; the
    partials summed are the whole ``y`` within ``SLICE_TOL`` and the
    slices of the state are the whole state's in bits."""
    r, k, v, w, u, st = _inputs(2, 6, 2, 64, 64, seed=6)
    y, s1 = KR.wkv6_ref(r, k, v, w, u, st)
    total = torch.zeros_like(y)
    for lo in range(0, 64, 16):
        sl = slice(lo, lo + 16)
        yp, sp = KR.wkv6_ref(r[..., sl], k[..., sl], v, w[..., sl],
                             u[:, sl], st[:, :, sl])
        total += yp
        assert torch.equal(sp, s1[:, :, sl])
    assert float((total - y).abs().max()) <= SLICE_TOL * float(
        y.abs().max())


def test_dispatch_sends_cpu_tensors_to_the_plain_loop(monkeypatch):
    """``wkv6`` (through ``rwkv._wkv``) gives ``wkv6_ref``'s bits on CPU
    tensors, with or without the ``ESPIM_IMPL=ref`` pin, and launches
    nothing; under grad autograd differentiates the loop itself (no
    Function); the ``ESPIM_IMPL=cuda`` pin on CPU tensors raises."""
    ins = _inputs(1, 5, 2, 64, 64, seed=8)
    want = KR.wkv6_ref(*ins)
    WKV.reset_launches()
    for pin in (None, "ref"):
        if pin:
            monkeypatch.setenv("ESPIM_IMPL", pin)
        got = PR._wkv(*ins)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    monkeypatch.delenv("ESPIM_IMPL")
    live = [t.clone().requires_grad_(True) for t in ins]
    y, _ = WKV.wkv6(*live)
    assert torch.equal(y, want[0])
    assert "WKV6" not in type(y.grad_fn).__name__
    assert WKV.LAUNCHES == {"wkv6": 0, "wkv6_bwd": 0}
    monkeypatch.setenv("ESPIM_IMPL", "cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        PR._wkv(*ins)


def _indexing():
    if torch.backends.cuda.is_built():
        return contextlib.nullcontext()
    return dryrun._CudaIndexing()


def test_ops_on_fake_cuda_tensors_at_full_width():
    """(d) at rwkv6-1.6b's full width (H 32, hd 64), bf16 r / k / v:
    the forward op with checkpoints and the backward op give their
    outputs' shapes and dtypes on fake ``cuda`` tensors, count no launch,
    and the cost analysis reads their formulas and every operand's
    bytes."""
    b, s, h, kp = 2, 100, 32, 64
    bf, f32 = torch.bfloat16, torch.float32
    before = dict(WKV.LAUNCHES)
    with FakeTensorMode(), _indexing():
        def z(*shape, dt=f32):
            return torch.empty(shape, dtype=dt, device="cuda")
        r, k, v = (z(b, s, h, kp, dt=bf) for _ in range(3))
        w, u, st = z(b, s, h, kp), z(h, kp), z(b, h, kp, kp)
        with CostMode() as m:
            y, s1, ck = WKV.wkv6_cuda(r, k, v, w, u, st, WKV.CHUNK)
        assert y.device.type == "cuda"
        assert (tuple(y.shape), tuple(s1.shape), tuple(ck.shape)) == (
            (b, s, h, kp), (b, h, kp, kp), (b, h, 4, kp, kp))
        assert y.dtype == s1.dtype == ck.dtype == f32
        fwd = m.cost
        gy = z(b, s, h, kp)
        with CostMode() as m:
            grads = WKV.wkv6_bwd_cuda(r, k, v, w, u, ck, gy, st)
        bwd = m.cost
        shapes = [(b, s, h, kp)] * 4 + [(h, kp), (b, h, kp, kp)]
        assert [tuple(g.shape) for g in grads] == shapes
        assert all(g.dtype == f32 for g in grads)
    assert WKV.LAUNCHES == before
    nr = b * s * h * kp                 # elements of r, k, v and w
    n = nr * kp                         # (b, t, h) x K' x V
    ins = 3 * nr * 2 + nr * 4 + h * kp * 4 + st.numel() * 4
    outs = 4 * (y.numel() + s1.numel() + ck.numel())
    assert (fwd.dot_flops, fwd.bytes) == (2 * n, ins + outs)
    assert bwd.dot_flops == 4 * n
    assert bwd.bytes == (ins + 4 * (ck.numel() + gy.numel())
                         + 4 * sum(g.numel() for g in grads))


def _count_step(cfg, s, train: bool, pin_ref: bool, monkeypatch):
    """(dot FLOPs, ops dispatched) of one reduced rwkv6 train step (loss
    and backward) or prefill forward (no grad) at B 2 x S ``s`` on fake
    CPU tensors, as the dry run traces a train cell here; ``pin_ref``
    runs the WKV as the plain loop."""
    if pin_ref:
        monkeypatch.setenv("ESPIM_IMPL", "ref")
    else:
        monkeypatch.delenv("ESPIM_IMPL", raising=False)

    class Count(CostMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    with FakeTensorMode():
        params = PF.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        toks = torch.zeros((2, s), dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks}
        if train:
            for t in leaves(params):
                t.requires_grad_(True)
        with Count() as m:
            if train:
                PF.loss_fn(cfg, params, batch)[0].backward()
            else:
                with torch.no_grad():
                    PF.apply_train(cfg, params, batch)
    return m.cost.dot_flops, m.n


@pytest.mark.parametrize("train", [True, False])
def test_traced_steps_count_the_loops_flops_in_ops_independent_of_s(
        train, monkeypatch):
    """(e) the reduced rwkv6 train step (remat "full": the forward twice,
    the backward once) and prefill forward under ``CostMode``: the op
    path's dot FLOPs equal the per-token loop's, and its ops dispatched
    at S 64 equal those at S 256 (the loop's grow with S)."""
    cfg = get_config(ARCH, reduced=True).replace(n_layers=2, remat="full")
    flops_op, n16 = _count_step(cfg, 16, train, False, monkeypatch)
    flops_loop, n_loop = _count_step(cfg, 16, train, True, monkeypatch)
    assert flops_op == flops_loop > 0
    assert n_loop > n16
    f64, n64 = _count_step(cfg, 64, train, False, monkeypatch)
    f256, n256 = _count_step(cfg, 256, train, False, monkeypatch)
    assert n64 == n256 == n16
    assert f256 == 4 * f64


# the launch plans: rwkv6-1.6b's shapes (``chip_smoke.WKV_CASES``: B, K',
# 32 heads of 64) and a sweep of widths
PLAN_SHAPES = ([(1, 32, 64, 64), (4, 32, 64, 64), (4, 32, 4, 64),
                (4, 32, 8, 64), (4, 32, 16, 64), (4, 32, 32, 64),
                (8, 32, 64, 64)]
               + [(b, h, kp, vd) for b, h in ((1, 1), (2, 32))
                  for kp in (1, 4, 16, 63, 64) for vd in (1, 16, 64)])


def _owners(kg, vs, kp, vd):
    """{(k, j): owners} over the ceil(V / vs) CTAs of one (b, h), as
    ``wkv6_fwd_kernel`` indexes its state: thread t of CTA c keeps rows
    ROWS (t % kg) .. ROWS (t % kg) + ROWS - 1 of column c vs + t / kg;
    rows past K' and columns past V are padding."""
    seen = {}
    for cta in range(-(-vd // vs)):
        for tid in range(kg * vs):
            j, g = cta * vs + tid // kg, tid % kg
            for k in range(g * WKV.ROWS, (g + 1) * WKV.ROWS):
                if k < kp and j < vd:
                    seen[k, j] = seen.get((k, j), 0) + 1
    return seen


@pytest.mark.parametrize("b,h,kp,vd", PLAN_SHAPES)
def test_plan_gives_every_state_element_one_thread(b, h, kp, vd):
    """``_plan``, the forward's launch: every (k, j) of a head's K' x V
    state is owned by exactly one thread of its (b, h)'s CTAs; a CTA is
    whole warps, at most 256 compute threads, its k-groups (a power of 2
    from K' alone) cover K'."""
    kg, vs = WKV._plan(b, h, kp, vd)
    want = {(k, j): 1 for k in range(kp) for j in range(vd)}
    assert _owners(kg, vs, kp, vd) == want
    assert kg in (1, 2, 4, 8, 16) and WKV.ROWS * kg >= kp
    assert kg == WKV._plan(1, 1, kp, 1).kg      # from K' alone
    assert (kg * vs) % 32 == 0 and 32 <= kg * vs <= 256 and vs % 2 == 0


def test_plan_fills_the_card_at_rwkv6_prefill_and_refuses_wide_heads():
    """At B 1 x H 32 x 64 x 64 (rwkv6-1.6b's prefill) the forward's grid
    is at least 128 CTAs (of 256 threads: 16 k-groups of 4 rows x 16
    columns); widths above 64 (or below 1) raise."""
    kg, vs = WKV._plan(1, 32, 64, 64)
    assert (kg, vs) == (16, 16) and 1 * 32 * -(-64 // vs) >= 128
    for kp, vd in ((65, 64), (64, 65), (0, 64), (64, 0)):
        with pytest.raises(ValueError):
            WKV._plan(1, 32, kp, vd)


def test_wrappers_allocate_outputs_and_pass_the_plan(monkeypatch):
    """The launch wrappers on fake CUDA tensors at rwkv6's full width
    (B 8 x H 32 x 64 x 64): the backward allocates its six outputs and
    one scratch (``du_part``, B x H x K'), no workspace that grows with S
    (the chunks' states live in shared memory); the forward passes its
    plan's k-groups and columns to the C entry point, the backward no
    plan, each with as many arguments as ``build._SIGNATURES`` binds."""
    from repro_torch.kernels import build
    b, h, kp, vd = 8, 32, 64, 64
    with FakeTensorMode(), _indexing():
        def z(s, last):
            return torch.empty((b, s, h, last), device="cuda")
        scratch = {}
        for s in (128, 4096):
            bufs = WKV._bwd_buffers(z(s, kp), z(s, vd))
            assert "work" not in bufs
            assert {n: tuple(t.shape) for n, t in bufs.items()} == {
                "dr": (b, s, h, kp), "dk": (b, s, h, kp),
                "dv": (b, s, h, vd), "dw": (b, s, h, kp), "du": (h, kp),
                "ds0": (b, h, kp, vd), "du_part": (b, h, kp)}
            assert all(t.device.type == "cuda" and t.dtype == torch.float32
                       for t in bufs.values())
            scratch[s] = bufs["du_part"].numel()
        assert scratch[128] == scratch[4096] == b * h * kp
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def launch(*args):
                calls.append((fn, args))
                return 0
            return launch

    monkeypatch.setattr(WKV, "load_library", lambda name: Lib())
    monkeypatch.setattr(WKV, "_stream", lambda t: 0)
    ins = _inputs(1, 3, h, kp, vd, seed=9, dtype=torch.bfloat16)
    y, s1, ck = WKV._fwd_kernel(*WKV._operands(*ins), WKV.CHUNK)
    g = WKV._bwd_kernel(*WKV._operands(*ins)[:5], ck, torch.zeros_like(y),
                        ins[5], WKV.CHUNK)
    (f_fn, f_args), (b_fn, b_args) = calls
    sig = build._SIGNATURES["wkv"]
    assert (f_fn, len(f_args), b_fn, len(b_args)) == (
        "wkv6_fwd", len(sig["wkv6_fwd"]), "wkv6_bwd", len(sig["wkv6_bwd"]))
    plan = WKV._plan(1, h, kp, vd)
    assert f_args[-3:-1] == (plan.kg, plan.vs)
    assert f_args[9:16] == (1, 1, 3, h, kp, vd, WKV.CHUNK)
    assert b_args[-8:-1] == (1, 1, 3, h, kp, vd, WKV.CHUNK)
    assert [t.data_ptr() for t in g] == list(b_args[8:14])
    assert WKV.LAUNCHES["wkv6"] >= 1
    with pytest.raises(ValueError, match="multiple"):
        WKV.wkv6_cuda(*ins, 24)
