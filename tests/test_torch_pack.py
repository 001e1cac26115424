"""The port's pack-group compiler builds the same pack bytes as the JAX
package's: every group fingerprint, every plane digest and the model
fingerprint are equal, for fp, int8 and int4 planes, whole-layer and
MLP-only."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import sparse_model as RSM  # noqa: E402

from _torch_parity import smoke_model  # noqa: E402
from repro_torch.core import integrity  # noqa: E402
from repro_torch.core import sparse_model as PSM  # noqa: E402


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("projections", ["all", "mlp"])
def test_fingerprints_equal_reference(quant, projections):
    cfg, pcfg, params, tparams = smoke_model(n_layers=2)
    rs = RSM.sparsify_model(cfg, params, 0.9, projections=projections,
                            quant=quant)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, projections=projections,
                            quant=quant, device="cpu")
    assert list(ps["groups"]) == list(rs["groups"])
    for name, g in ps["groups"].items():
        assert g["plane_fingerprints"] == rs["groups"][name][
            "plane_fingerprints"], name
        assert g["fingerprint"] == rs["groups"][name]["fingerprint"], name
    assert ps["fingerprint"] == rs["fingerprint"]
    assert ps["quant"] == rs["quant"]
    assert ps["dense_proj_bytes"] == rs["dense_proj_bytes"]
    # the dequantized / pruned dense copies are the same weights
    for name, w in ps["pruned"].items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(rs["pruned"][name]))
    # verification recomputes the same digests from the port's tensors
    assert PSM.verify_sparse(ps) == RSM.verify_sparse(rs)


def test_verify_sparse_catches_a_flipped_plane():
    _, pcfg, _, tparams = smoke_model(n_layers=2)
    ps = PSM.sparsify_model(pcfg, tparams, 0.9, quant="int8", device="cpu")
    ps["groups"]["qkv"]["buckets"][0]["q"][0, 0, 0, 0] += 1
    with pytest.raises(integrity.PackIntegrityError, match="b0.q"):
        PSM.verify_sparse(ps)


def test_sparse_stats_counts_plane_bytes():
    _, pcfg, _, tparams = smoke_model(n_layers=2)
    fp = PSM.sparse_stats(PSM.sparsify_model(pcfg, tparams, 0.9,
                                             device="cpu"))["total"]
    q8 = PSM.sparse_stats(PSM.sparsify_model(pcfg, tparams, 0.9,
                                             quant="int8",
                                             device="cpu"))["total"]
    # same index plane; the int8 value plane is a quarter of fp32's plus
    # its scales
    assert fp["index_plane_bytes"] == q8["index_plane_bytes"]
    assert fp["padded_slots"] == q8["padded_slots"]
    assert q8["value_plane_bytes"] < fp["value_plane_bytes"] / 3
    assert fp["bytes_per_token"] == (fp["value_plane_bytes"]
                                     + fp["index_plane_bytes"])
