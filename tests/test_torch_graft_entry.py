"""The port's graft entry (``copycat_tpu_torch/graft_entry.py``) against the
reference's (``__graft_entry__.py``), on the CPU.

The reference's ``entry()`` runs in a worker process
(``torch_reference.LONG_RUNS``): its state, submits and delivery mask, and
the two timer draws its ``step`` makes from its key, go to the port's
``entry()`` function as they are (``convert``), and every output and state
leaf of one ``fn(*args)`` must equal the reference's, bit for bit; then
both step on from there, on the reference's draws, through the first
elections, equal every round. The port's ``entry(device="cpu")``
builds the documented shapes; ``entry()`` without a card raises, and the
module's ``__main__`` exits 2.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from torch_reference import (  # noqa: E402,F401
    LONG_RUNS,
    SUITE_AHEAD,
    as_numpy,
    assert_same_leaves,
    release_jax_programs,
)

from copycat_tpu_torch import convert, graft_entry  # noqa: E402
from copycat_tpu_torch.ops import consensus as tcons  # noqa: E402

#: Rounds after the entry's call: most groups elect a leader within the
#: timer range (4-9 rounds) and send their first heartbeats.
MORE_ROUNDS = 12


def _reference_entry():
    """The reference's ``entry()``: its arguments, and per round (the
    entry's call, then :data:`MORE_ROUNDS` more, each on a key split from
    the last) the two timer draws its step makes from the key, its state
    and its outputs."""
    import __graft_entry__ as ref
    from copycat_tpu.ops.consensus import Config

    fn, (state, submits, deliver, key) = ref.entry()
    cfg = Config()
    G, P = state.term.shape
    jfn = jax.jit(fn)
    rounds = []
    for _ in range(1 + MORE_ROUNDS):
        key_t, key_c = jax.random.split(key)
        draws = [jax.random.randint(k, (G, P), cfg.timer_min, cfg.timer_max)
                 for k in (key_t, key_c)]
        state_after, out = jfn(state, submits, deliver, key)
        rounds.append((draws, state_after, out))
        state = state_after
        key = jax.random.split(key)[0]
    _, (state0, submits, deliver, _) = ref.entry()
    return as_numpy(dict(args=(state0, submits, deliver), rounds=rounds))


_FILE = os.path.basename(__file__)
LONG_RUNS[f"{_FILE}::test_entry_step_matches_the_reference"] = [
    (("graft_entry",), _reference_entry, ())]


def test_entry_step_matches_the_reference():
    ref = SUITE_AHEAD.get(("graft_entry",), _reference_entry)
    fn, _ = graft_entry.entry(device="cpu")
    state0, submits, deliver = ref["args"]
    state = convert.state_to_torch(state0, "cpu")
    sub = convert.submits_to_torch(submits, "cpu")
    dl = torch.from_numpy(np.asarray(deliver))
    for r, ((fresh, cand), want_state, want_out) in enumerate(ref["rounds"]):
        state, out = fn(state, sub, dl, torch.from_numpy(fresh),
                        torch.from_numpy(cand))
        assert_same_leaves(want_out, out, f"outputs, round {r}")
        assert_same_leaves(want_state, state, f"state, round {r}")
    # the rounds after the entry's call covered the elections
    assert (out.leader >= 0).float().mean() > 0.5


def test_entry_builds_the_reference_shapes_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    state, submits, deliver, fresh, cand = args
    G, P, L, S = 256, 3, 32, 4
    assert (graft_entry.NUM_GROUPS, graft_entry.NUM_PEERS,
            graft_entry.LOG_SLOTS, graft_entry.SUBMIT_SLOTS) == (G, P, L, S)
    assert fn.func is tcons.step and fn.keywords == {"config": tcons.Config()}
    assert tuple(state.term.shape) == (G, P)
    assert tuple(state.log_term.shape) == (G, P, L)
    assert tuple(state.next_index.shape) == (G, P, P)
    assert all(tuple(x.shape) == (G, S) for x in submits)
    assert not submits.valid.any()
    assert tuple(deliver.shape) == (G, P, P) and bool(deliver.all())
    cfg = tcons.Config()
    for draw in (state.timer, fresh, cand):
        assert draw.dtype == torch.int32 and tuple(draw.shape) == (G, P)
        assert cfg.timer_min <= int(draw.min()) \
            and int(draw.max()) < cfg.timer_max
    assert not torch.equal(fresh, cand)
    leaves = [x for x in convert.flat_leaves(state).values()
              if x is not None]
    assert all(x.shape[0] == G for x in leaves)
    assert all(t.device.type == "cpu" for t in (*state[:4], fresh, cand,
                                                  deliver))
    # seeded: a second call builds the same arguments
    _, again = graft_entry.entry(device="cpu")
    for a, b in ((state, again[0]), (fresh, again[3]), (cand, again[4])):
        assert_same_leaves(a, b, "entry(device='cpu') twice") \
            if hasattr(a, "_asdict") else torch.equal(a, b)
    out_state, out = fn(*args)
    assert tuple(out.leader.shape) == (G,)
    assert tuple(out_state.term.shape) == (G, P)


def test_entry_without_a_card_raises_and_main_exits_2(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card answers here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "1")
    monkeypatch.setenv("COPYCAT_ENTRY_DEVICE_TIMEOUT", "60")
    with pytest.raises(SystemExit) as e:
        graft_entry.main()
    assert e.value.code == 2
    out = capsys.readouterr()
    assert "entry: ok" not in out.out
    assert "no CUDA card answered" in out.err
