"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: one seeded reference model, its params as numpy, and the same
params as the port's tensors on the CPU."""
import jax
import numpy as np

from repro.configs.registry import get_config
from repro.models import factory

from repro_torch.configs.registry import get_config as port_get_config
from repro_torch.convert import params_from_numpy

ARCH = "llama7b-espim"


def smoke_model(n_layers: int = 2, seed: int = 0):
    """(ref cfg, port cfg, ref params, port params): smoke(llama7b-espim)
    in float32 with ``n_layers`` layers, reference init from ``seed``."""
    cfg = get_config(ARCH, reduced=True).replace(n_layers=n_layers)
    pcfg = port_get_config(ARCH, reduced=True).replace(n_layers=n_layers)
    params = factory.init_params(cfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, pcfg, params, tparams


def to_np(x):
    """A jax array or a torch tensor as float numpy."""
    if hasattr(x, "detach"):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def drain(eng, reqs, on_step=None, max_steps: int = 2000) -> int:
    """Submit ``reqs`` and step ``eng`` until its queue and slots are
    empty, calling ``on_step(eng, step)`` after each tick; returns the
    ticks taken."""
    for r in reqs:
        eng.submit(r)
    steps = 0
    while steps < max_steps and (eng.scheduler.has_pending
                                 or any(s is not None for s in eng.slots)):
        eng.step()
        steps += 1
        if on_step is not None:
            on_step(eng, steps)
    assert steps < max_steps, "engine failed to drain"
    return steps
