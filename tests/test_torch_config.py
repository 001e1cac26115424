"""The port's ModelConfig mirror equals the JAX package's registry field by
field, for every entry and for ``smoke()`` of each."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as RB  # noqa: E402
from repro.configs import registry as RR  # noqa: E402

from repro_torch.configs import base as PB  # noqa: E402
from repro_torch.configs import registry as PR  # noqa: E402


def test_registry_names_match():
    assert list(PR.REGISTRY) == list(RR.REGISTRY)
    assert PR.ASSIGNED == RR.ASSIGNED
    assert PB.SHAPES == {k: PB.ShapeConfig(**dataclasses.asdict(v))
                         for k, v in RB.SHAPES.items()}


@pytest.mark.parametrize("name", list(RR.REGISTRY))
def test_config_and_smoke_equal_reference(name):
    ref, port = RR.REGISTRY[name], PR.REGISTRY[name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PB.smoke(port)) == \
        dataclasses.asdict(RB.smoke(ref))
    assert PR.get_config(name, reduced=True) == PB.smoke(port)
    for cfg in (port, PB.smoke(port)):
        assert cfg.dtype == getattr(torch, cfg.param_dtype)
        assert cfg.cdtype == getattr(torch, cfg.compute_dtype)
        assert (cfg.hd, cfg.padded_vocab) == (ref.replace(
            **dataclasses.asdict(cfg)).hd, ref.replace(
            **dataclasses.asdict(cfg)).padded_vocab)


def test_torch_dtype_rejects_unknown_names():
    with pytest.raises(ValueError):
        PB.torch_dtype("float7")
