"""The check that decides ``correct``, driven through whole runs of the two
tiny cells on the CPU (the harness's look for a card skipped): a sound run
passes, each cell's control in the program's place fails, and each fault a
served cell can have, planted under the timed path, makes ``correct``
false.  The loop's clock moves a fixed step each read, so each run's
window holds the same ticks on a busy host."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness.cell import run_cell
from perfbench.tests._tiny import TickClock, tiny_cell

WINDOW_S = 1.5
SEED = 2 ** 31 + 11           # above 32 signed bits, as the driver's are
CELLS = ("tiny-espim-int8", "tiny-dense-bf16")


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _run(name, **kw):
    return run_cell(tiny_cell(name), SEED, WINDOW_S, False, device="cpu",
                    clock=TickClock(), log=lambda m: None, **kw)


def state_unchanged(eng):
    """The decode step hands back the cache it was given."""
    step = eng._decode

    def fn(p, cache, batch):
        nxt, ok, _new = step(p, cache, batch)
        return nxt, ok, cache
    eng._decode = fn


def half_batch(eng):
    """The decode step computes the first half of the batch; the second
    half gets the first half's tokens."""
    step = eng._decode

    def fn(p, cache, batch):
        nxt, ok, new = step(p, cache, batch)
        nxt = nxt.clone()
        half = nxt.shape[0] // 2
        nxt[half:] = nxt[:nxt.shape[0] - half]
        return nxt, ok, new
    eng._decode = fn


def token_altered(eng):
    """Every fifth token the engine emits is the next vocabulary id."""
    emit, seen = eng._emit_token, [0]
    vocab = eng.cfg.vocab_size

    def fn(slot, tok):
        seen[0] += 1
        if seen[0] % 5 == 0:
            tok = (tok + 1) % vocab
        emit(slot, tok)
    eng._emit_token = fn


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"
    assert r["check"]["logit_gap"]["value"] <= \
        r["check"]["logit_gap"]["limit"]


def test_espim_control_int4_is_not_correct():
    r = _run("tiny-espim-int8", control=True)
    assert not r["correct"]
    assert r["check"]["logit_gap"]["value"] > \
        r["check"]["logit_gap"]["limit"]


def test_dense_control_fp8_fails_the_limit():
    r = _run("tiny-dense-bf16", control=True)
    assert not r["correct"]
    assert r["failed"] == 0
    # the control's tokens are judged, not the program's, which pass
    gap = r["check"]["logit_gap"]
    assert gap["value"] == r["readings"]["control"]["widest"] > gap["limit"]
    assert r["readings"]["widest"] <= gap["limit"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
def test_fault_is_not_correct(name, fault):
    r = _run(name, fault=fault)
    assert not r["correct"], r["check"]
