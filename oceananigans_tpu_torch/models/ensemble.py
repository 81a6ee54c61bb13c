"""Ensembles: many independent copies of one model.

Counterpart of ``oceananigans_tpu/models/ensemble.py``, which vmaps the
model's step over stacked states. Here each member's state is its own set
of tensors and ``time_step`` steps the members one after another through
the model's own step, so each member takes exactly the kernels and the
arithmetic of a model run alone, and equals its solo run bit for bit.
"""

from __future__ import annotations

import torch


def clone_state(obj):
    """A model state with every tensor in it copied (dicts, lists and
    tuples rebuilt; other values shared)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: clone_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone_state(v) for v in obj)
    return obj


class EnsembleModel:
    """``n`` independent copies of ``model``::

        ens = EnsembleModel(model, n=4)
        ens.set(member=2, b=lambda x, y, z: ...)   # or set_all(fn(i))
        ens.time_step(60.0)                        # every member
        s2 = ens.member_state(2)
    """

    def __init__(self, model, n):
        self.model = model
        self.n = int(n)
        self.states = [clone_state(model.state) for _ in range(self.n)]

    def _with_member(self, member, fn):
        saved = self.model.state
        self.model.state = self.states[member]
        try:
            out = fn(self.model)
            self.states[member] = self.model.state
        finally:
            self.model.state = saved
        return out

    def set(self, member, **fields):
        """Set fields of one member (``model.set``'s arguments)."""
        self._with_member(member, lambda m: m.set(**fields))

    def set_all(self, fn):
        """``fn(member) -> dict`` of ``set`` arguments, for each member."""
        for m in range(self.n):
            self.set(m, **fn(m))

    def member_state(self, member):
        return self.states[member]

    def time_step(self, dt):
        """One step of ``dt`` for every member."""
        for m in range(self.n):
            self._with_member(m, lambda model: model.time_step(dt))
        return self

    def field(self, member, name):
        return self._with_member(member, lambda m: m.field(name))
