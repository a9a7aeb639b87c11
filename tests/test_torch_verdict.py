"""``copycat_tpu_torch/testing`` against the JAX reference's harness.

- The checker: the fuzz scripts of ``tests/test_linearize_fuzz.py`` (400
  random and 400 valid-by-construction histories per model, through the
  monolithic, windowed and per-key checkers) and the hand-made cases of
  ``tests/test_linearizability.py`` run through both packages' checkers,
  which must give the same verdict and search the same number of nodes.
- The nemesis: ``Nemesis._mask`` draws the reference's masks for the same
  seed and fault sequence, and ``tick`` installs them on the engine's
  device.
- The verdicts on the port's engine (CPU): ``run_deep_verdict`` at the
  size of ``tests/test_verdict_deep.py`` (32 groups, 8 sampled, 8 epochs)
  and a small ``run_verdict`` with membership churn, both linearizable;
  ``main`` prints the JSON result and exits 1 on a violation.
"""

import json
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from copycat_tpu.testing import linearize as jlin  # noqa: E402
from copycat_tpu.testing import nemesis as jnem  # noqa: E402
from test_linearize_fuzz import _random_history, _valid_history  # noqa: E402

from copycat_tpu_torch.testing import linearize as tlin  # noqa: E402
from copycat_tpu_torch.testing import nemesis as tnem  # noqa: E402
from copycat_tpu_torch.testing import verdict as tverdict  # noqa: E402

MODELS = ("RegisterModel", "MapModel", "LockModel")


def _port_history(hist):
    return [tlin.HOp(op_id=h.op_id, op=h.op, result=h.result,
                     invoke=h.invoke, complete=h.complete) for h in hist]


def _both(checker: str, hist, model: str | None):
    """The verdicts and search sizes of the two packages' ``checker``."""
    out = []
    for lin, h in ((jlin, hist), (tlin, _port_history(hist))):
        args = (h,) if model is None else (h, getattr(lin, model))
        res = getattr(lin, checker)(*args)
        out.append((res.ok, res.nodes))
    assert out[1] == out[0], hist
    return out[0][0]


@pytest.mark.parametrize("checker,model,seed", [
    ("check_linearizable", m, 97) for m in MODELS] + [
    ("check_linearizable_windowed", m, 131) for m in MODELS] + [
    ("check_map_linearizable", None, 173)],
    ids=lambda x: str(x))
def test_fuzzed_histories_get_the_same_verdict(checker, model, seed):
    rng = random.Random(seed)
    jmodel = getattr(jlin, model or "MapModel")
    yes = no = 0
    for k in range(400):
        hist = (_valid_history(rng, jmodel) if k % 2 == 0
                else _random_history(rng, jmodel))
        ok = _both(checker, hist, model)
        yes += ok
        no += not ok
    assert yes > 40 and no > 40, (yes, no)


def _h(*ops):
    return [jlin.HOp(i + 1, op, res, invoke=a, complete=b)
            for i, (op, res, a, b) in enumerate(ops)]


CASES = {
    "stale_read": (_h((("set", 1), 0, 0, 1), (("get",), 0, 2, 3)),
                   "RegisterModel", False),
    "concurrent_read": (_h((("set", 1), 0, 0, 5), (("get",), 0, 1, 2)),
                        "RegisterModel", True),
    "incomplete_may_apply": (_h((("set", 5), None, 0, math.inf),
                                (("get",), 5, 3, 4)), "RegisterModel", True),
    "incomplete_may_never_apply": (_h((("set", 5), None, 0, math.inf),
                                      (("get",), 0, 3, 4)),
                                   "RegisterModel", True),
    "cas_chain": (_h((("set", 1), 0, 0, 1), (("cas", 1, 2), 1, 2, 3),
                     (("cas", 1, 9), 0, 4, 5), (("get",), 2, 6, 7)),
                  "RegisterModel", True),
    "cas_chain_double_win": (_h((("set", 1), 0, 0, 1),
                                (("cas", 1, 2), 1, 2, 3),
                                (("cas", 1, 9), 1, 4, 5)),
                             "RegisterModel", False),
    "lock": (_h((("acquire", 7), 1, 0, 1), (("acquire", 8), 0, 2, 3),
                (("release", 7), 1, 4, 5), (("acquire", 8), 1, 6, 7)),
             "LockModel", True),
    "lock_two_holders": (_h((("acquire", 7), 1, 0, 1),
                            (("acquire", 8), 1, 2, 3)), "LockModel", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_checker_cases_get_the_same_verdict(case):
    hist, model, want = CASES[case]
    assert _both("check_linearizable", hist, model) is want


class _Engine:
    """What a nemesis reads of an engine."""

    def __init__(self, G, P):
        self.num_groups, self.num_peers = G, P
        self.rounds, self.telemetry = 0, None
        self.device = torch.device("cpu")
        self.deliver = None


def test_nemesis_draws_the_reference_masks():
    """Every fault's mask, drawn in one sequence from one seed, equals the
    reference's; the schedule's ticks install the same masks."""
    ref, port = (m.Nemesis(_Engine(64, 5), seed=7, period=3)
                 for m in (jnem, tnem))
    for fault in ("loss", "partition", "isolate", "heal", "loss",
                  "isolate", "partition"):
        np.testing.assert_array_equal(port._mask(fault), ref._mask(fault))
    ref._rg.deliver = None
    for r in range(20):
        assert port.tick() == ref.tick()
        got = port._rg.deliver
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref._rg.deliver))
    port.heal()
    assert port.current == "heal" and bool(port._rg.deliver.all())
    with pytest.raises(ValueError, match="unknown fault"):
        port._mask("flood")


def test_deep_verdict_on_the_port():
    res = tverdict.run_deep_verdict(groups=32, sample=8, epochs=8,
                                    device="cpu")
    assert res["linearizable"] is True
    assert res["violations"] == 0 and res["undecided_groups"] == 0
    assert res["checked_ops"] >= 8 * 8 * 4 // 2
    assert res["sampled_groups"] == 8
    assert res["device_telemetry"]["invariants"]["violations"] == 0


def test_verdict_with_churn_on_the_port(monkeypatch, capsys):
    """``main`` on the CPU with small knobs: the client-plane verdict under
    the nemesis and membership churn, printed as one JSON line."""
    for knob, value in (("GROUPS", 32), ("SAMPLE", 9), ("ROUNDS", 40),
                        ("DEEP", 0)):
        monkeypatch.setenv(f"COPYCAT_VERDICT_{knob}", str(value))
    tverdict.main(["--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["linearizable"] is True and res["violations"] == 0
    assert res["groups"] == 32 and res["sampled_groups"] == 9
    assert res["checked_ops"] > 9 * 15
    assert res["membership_changes_applied"] > 0
    assert "deep_plane" not in res


def test_verdict_main_exits_1_on_a_violation(monkeypatch, capsys):
    monkeypatch.setattr(tverdict, "run_verdict",
                        lambda device: {"linearizable": False})
    monkeypatch.setenv("COPYCAT_VERDICT_DEEP", "0")
    with pytest.raises(SystemExit) as exc:
        tverdict.main(["--device", "cpu"])
    assert exc.value.code == 1
    assert json.loads(capsys.readouterr().out) == {"linearizable": False}


def test_verdict_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tverdict.run_deep_verdict(groups=4, sample=1, epochs=1)
