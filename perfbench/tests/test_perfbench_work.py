"""The operation and byte counts against hand counts of a toy model, the
device trace's arithmetic on a hand-made op list, and the readers on a
hand-made run."""
from __future__ import annotations

import types

import numpy as np
import pytest

from perfbench.harness import devtrace
from perfbench.harness.loop import ReqRecord, Tick
from perfbench.harness.manifest import load_reader
from perfbench.metrics._common import percentile
from perfbench.metrics._work import WorkModel, bound_seconds, index_bytes
from perfbench.reference import granite

# d 4, 2 heads of 2, 1 kv head, ff 8, vocab 10, one layer
NNZ = {"wq": [3], "wk": [2], "wv": [1], "wo": [4], "w_gate": [5],
       "w_up": [6], "w_down": [7]}
FULL = {"wq": [16], "wk": [8], "wv": [8], "wo": [16], "w_gate": [32],
        "w_up": [32], "w_down": [32]}


TOY = granite.Dims({"num_hidden_layers": 1, "hidden_size": 4,
                    "num_attention_heads": 2, "num_key_value_heads": 1,
                    "head_dim": 2, "intermediate_size": 8, "vocab_size": 10,
                    "rope_theta": 1e4, "rms_norm_eps": 1e-6})
INT8 = {"value": 1, "index": 2, "scale": 4, "scale_rows": 128}


def _model(weights, sparse):
    return WorkModel(1, 4, 2, 1, 2, 10, granite.group_shapes(TOY), weights,
                     INT8 if sparse else None)


def test_dense_weights_and_index_bytes():
    assert granite.dense_weights(TOY) == FULL
    assert [index_bytes(c) for c in (16, 256, 257, 512, 65536, 65537)] == \
        [1, 1, 2, 2, 2, 4]


def test_spmv_bytes_by_hand():
    m = _model(NNZ, True)
    # qkv: 6 nnz * 3 + one scale + x 2*2*4 + y 2*2*8
    assert m.group_bytes("qkv", 0, 2) == 18 + 4 + 16 + 32
    assert m.group_bytes("attn_out", 0, 2) == 12 + 4 + 16 + 16
    assert m.group_bytes("gateup", 0, 2) == 33 + 4 + 16 + 32
    assert m.group_bytes("down", 0, 2) == 21 + 4 + 32 + 16
    assert m.spmv_bytes(2) == 276


def test_decode_tick_by_hand():
    flops, nbytes = _model(NNZ, True).decode_tick((3, 5))
    # projections 2*2*28, lm_head 2*2*10*4, attention 4*(3+5)*2*2
    assert flops == 112 + 160 + 128
    # SpMV 276, lm_head 80, logits 40, embedding 16, K/V (3+5) rows of 8
    assert nbytes == 276 + 80 + 40 + 16 + 64


def test_prefill_by_hand():
    flops, nbytes = _model(NNZ, True).prefill(3)
    # projections 2*3*28, last token's logits 2*10*4, causal 4*6*2*2
    assert flops == 168 + 80 + 96
    # weights 100, activations 2*3*44, lm_head 80 + logits 20,
    # embedding 24, K/V written 3 rows of 8
    assert nbytes == 100 + 264 + 100 + 24 + 24


def test_dense_counts_every_weight():
    m = _model(FULL, False)
    assert m.group_bytes("qkv", 0, 1) == 32 * 2 + 2 * (4 + 8)
    assert m.projections(1)[0] == 2 * 144


def test_bound_is_the_larger_of_the_two():
    peaks = {"bf16_flops": 100.0, "bytes_per_s": 10.0}
    assert bound_seconds(300, 20, peaks) == 3.0
    assert bound_seconds(100, 50, peaks) == 5.0


def _op(name, s, e):
    return devtrace.DeviceOp(name, s, e)


def test_trace_split_busy_and_gaps():
    ops = [_op("M", 0, 1), _op("A", 2, 5), _op("B", 4, 8), _op("M", 10, 11),
           _op("C", 12, 13), _op("Memcpy HtoD", 14, 15)]
    ticks, work = devtrace.split_ticks(ops, "M")
    assert [[o.name for o in t.ops] for t in ticks] == [["A", "B"],
                                                        ["C", "Memcpy HtoD"]]
    assert [o.kernel for o in ticks[1].ops] == [True, False]
    assert devtrace.busy_seconds(work) == pytest.approx(8e-9)
    gaps = devtrace.idle_gaps(ticks, ["decode", "prefill"])
    assert gaps == pytest.approx({"between ticks": 4e-9,
                                  "inside prefill ticks": 1e-9})


def test_percentile_is_numpys():
    xs = [5.0, 1.0, 4.0, 9.0, 2.5, 7.0, 3.0]
    for q in (0, 50, 95, 100):
        assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert percentile([], 95) is None


def _rec(k, t_send, t_first, t_last, t_done, n_out, max_new=None):
    r = ReqRecord(k, [1] * 10, max_new or n_out, None, t_send)
    r.t_first, r.t_last, r.t_done, r.n_out = t_first, t_last, t_done, n_out
    return r


def _run():
    ticks = [Tick(10.0, 10.5, "prefill", 1, (), (10,)),
             Tick(10.5, 11.0, "decode", 2, (11, 12)),
             Tick(11.0, 12.0, "decode", 2, (12, 13))]
    finished = [_rec(0, 9.0, 10.5, 11.5, 11.5, 3),
                _rec(1, 1.0, 2.0, 5.0, 5.0, 4)]
    inflight = [_rec(2, 10.0, 11.0, 11.0, None, 1, 5)]
    work = _model(NNZ, True)
    return types.SimpleNamespace(
        setup_s=4.0, t_open=10.0, t_close=12.0, window_s=2.0, ticks=ticks,
        finished=finished, inflight=inflight, work=work,
        peaks={"bf16_flops": 1e3, "bytes_per_s": 1e3}, trace=None,
        in_window=lambda t: t is not None and 10.0 <= t <= 12.0)


def test_readers_on_a_hand_made_run():
    run = _run()
    read = {n: load_reader(n) for n in (
        "setup_s", "decode_tok_s", "prefill_tok_s", "decode_tick_ms",
        "prefill_tick_ms", "tpot_p95_ms.chat", "ttft_p95_ms.chat",
        "decode_mfu", "prefill_mfu", "spmv_roofline",
        "kernels_per_decode_tick", "device_idle_share.chat")}
    assert read["setup_s"](run) == 4.0
    assert read["decode_tok_s"](run) == 2.5
    assert read["prefill_tok_s"](run) == 5.0
    assert read["decode_tick_ms"](run) == pytest.approx(750.0)
    assert read["prefill_tick_ms"](run) == pytest.approx(500.0)
    assert read["tpot_p95_ms.chat"](run) == pytest.approx(500.0)
    # first tokens in the window: 1.5 s and 1.0 s after their sends
    assert read["ttft_p95_ms.chat"](run) == pytest.approx(1475.0)
    dec = [run.work.decode_tick(t.contexts) for t in run.ticks[1:]]
    want = 100.0 * sum(max(f, b) / 1e3 for f, b in dec) / 1.5
    assert read["decode_mfu"](run) == pytest.approx(want)
    f, b = run.work.prefill(10)
    assert read["prefill_mfu"](run) == pytest.approx(100 * max(f, b) / 1e3
                                                     / 0.5)
    for name in ("spmv_roofline", "kernels_per_decode_tick",
                 "device_idle_share.chat"):
        assert read[name](run) is None           # no trace: no reading


def test_trace_readers():
    run = _run()
    ops = [_op("M", 0, 1), _op("pre", 1, 3), _op("M", 4, 5),
           _op("espim_spmv_stream_kernel<1>", 5, 15), _op("gemm", 15, 20),
           _op("M", 30, 31), _op("espim_spmv_stream_glu_kernel", 31, 41),
           _op("Memset", 41, 42)]
    ticks, work = devtrace.split_ticks(ops, "M")
    run.trace = {"ticks": ticks, "kinds": ["prefill", "decode", "decode"],
                 "busy_s": devtrace.busy_seconds(work), "window_s": 1e-7}
    assert load_reader("kernels_per_decode_tick")(run) == 1.5
    spent = 20e-9
    bound = 2 * run.work.spmv_bytes(2) / 1e3
    assert load_reader("spmv_roofline")(run) == pytest.approx(
        100 * bound / spent)
    assert load_reader("device_idle_share.chat")(run) == pytest.approx(
        100 * (1 - 28e-9 / 1e-7))
