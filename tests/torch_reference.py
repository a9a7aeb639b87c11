"""Helpers for the tests that hold ``copycat_tpu_torch`` against the JAX
reference: a port engine that draws its election timers as the
reference's ``RaftGroups`` does, and leaf-by-leaf state comparison."""

import jax
import numpy as np
import torch

from copycat_tpu_torch import convert
from copycat_tpu_torch.models import RaftGroups


class ReferenceDrawnGroups(RaftGroups):
    """The port's ``RaftGroups`` on the CPU, stepping the reference's
    exact step (``convert.config_to_torch``) with the timer draws the
    reference's ``RaftGroups`` makes from the same seed: per round, one
    split of the engine key, then ``key_t, key_c`` inside the step; for
    ``step_rounds(n)``, one split and ``n`` keys (``_fused_rounds_program``).
    """

    def __init__(self, groups, peers, log_slots, submit_slots, jcfg,
                 seed=0, voters=None):
        super().__init__(groups, peers, log_slots=log_slots,
                         submit_slots=submit_slots,
                         config=convert.config_to_torch(jcfg), seed=seed,
                         device="cpu", voters=voters)
        self._key, init_key = jax.random.split(jax.random.PRNGKey(seed))
        self.state = self.state._replace(timer=self._randint(init_key))

    def _randint(self, key):
        cfg = self.config
        return torch.tensor(np.asarray(jax.random.randint(
            key, (self.num_groups, self.num_peers), cfg.timer_min,
            cfg.timer_max)))

    def _step_draws(self, key):
        key_t, key_c = jax.random.split(key)
        return self._randint(key_t), self._randint(key_c)

    def _draw_timers(self):
        self._key, key = jax.random.split(self._key)
        return self._step_draws(key)

    def _draw_rounds(self, n):
        self._key, key = jax.random.split(self._key)
        return [self._step_draws(k) for k in jax.random.split(key, n)]


def assert_same_state(ref, port, what):
    """Every state leaf of two engines equal, value and dtype."""
    want = convert.flat_leaves(ref.state)
    got = convert.flat_leaves(port.state)
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, (name, what)
        np.testing.assert_array_equal(got[name], w,
                                      err_msg=f"{name} at {what}")


def assert_same_leaves(ref, port, what):
    """Every leaf of two NamedTuples (either package's) equal."""
    want, got = convert.flat_leaves(ref), convert.flat_leaves(port)
    assert want.keys() == got.keys(), what
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, (what, name)
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


def isolate(G, P, lanes):
    """Full delivery except ``lanes``, cut from every other lane."""
    dl = np.ones((G, P, P), bool)
    for lane in lanes:
        dl[:, lane, :] = False
        dl[:, :, lane] = False
    return dl
