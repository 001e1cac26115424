"""zamba2's SSD scan (``models/mamba.ssd_chunked``) differentiates at any
chunk length.  ``exp(cs[t] - cs[j])`` overflows above the diagonal of a
long chunk; the reference (``src/repro/models/mamba.py:73-75``) selects
the triangle after the exp, so its backward multiplies that inf by the
zero it routes there and the gradients turn NaN (reduced zamba2-2.7b at
B 8 x S 128).  The port masks the exponent before the exp: the same
forward values, finite gradients, and wherever the reference's gradient
is finite (the short chunks of S 32) the port's equals it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as ref_config  # noqa: E402
from repro.models import factory as RF  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import factory as PF  # noqa: E402
from repro_torch.tree import flatten, map_with_path  # noqa: E402

ARCH = "zamba2-2.7b"
LOSS_REL, GRAD_REL = 1e-5, 5e-5        # tests/test_torch_train.py's


def _both(seq: int):
    cfg, pcfg = ref_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    params = jax.tree.map(np.asarray, RF.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, seq)).astype(np.int32)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(
        lambda p: RF.loss_fn(cfg, p, {"tokens": toks, "labels": toks}),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    tparams = params_from_numpy(params, "cpu")
    live = {k: p.detach().requires_grad_(True) for k, p in flatten(tparams)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    ploss, _ = PF.loss_fn(pcfg, map_with_path(lambda k, _: live[k], tparams),
                          tb)
    pgrads = torch.autograd.grad(ploss, list(live.values()),
                                 allow_unused=True)
    want = dict(flatten(jax.tree.map(np.asarray, rgrads)))
    got = {k: (np.zeros_like(want[k]) if g is None
               else g.detach().float().numpy())
           for k, g in zip(live, pgrads)}
    return float(rloss), float(ploss), want, got


@pytest.mark.parametrize("seq", [32, 128])
def test_ssd_grads_finite_and_equal_where_the_reference_is(seq):
    rloss, ploss, want, got = _both(seq)
    assert abs(ploss - rloss) <= LOSS_REL * abs(rloss)
    assert all(np.isfinite(g).all() for g in got.values())
    finite = {k for k, w in want.items() if np.isfinite(w).all()}
    if seq == 128:      # the reference's overflow, which the port avoids
        assert finite != set(want)
    else:
        assert finite == set(want)
    for k in finite:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        assert float(np.abs(got[k] - want[k]).max()) / scale <= GRAD_REL, k
