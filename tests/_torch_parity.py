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
