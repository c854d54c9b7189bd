"""The discrete decisions of a step, recorded on one side and imposed on the
other.

A TTA step takes its graph nodes from the detections of box inference
(top-k and NMS) and its pseudo-labels from GA-GM's exact-LAP finale; a
source step samples its ROIs from the RPN's proposals (top-k and NMS) and
pulls its matching scores towards HiPPI's fixed point.  Each of
these chooses, so a difference at the last bit of a score, a power step or
a Sinkhorn sweep can flip a detection, an assignment or the fixed point,
and the loss after it is another loss.  The reference therefore follows
the program's choices: at each choice point it records what it would have
chosen, then goes on with the program's (when the two have the same
shape).  The choosers are checked by themselves where they are well-posed
(``jobs/tta.py:match_gap``, ``jobs/source.py``'s ``sinkhorn_gap``, and
the scores of the detections and proposals, ``det_gap`` and
``proposal_gap``).  Every continuous stage (backbone, FPN,
RPN head, box and mask heads, node sampler, attention, affinity, Sinkhorn,
the losses, the backward pass and the optimizer) is the reference's own.

:class:`Decisions` wraps each choice point ``(owner, attribute, key)``
between :meth:`begin` and :meth:`end` of each step.
"""

from __future__ import annotations

import torch


def _map(x, fn):
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    return x


def _flat(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _flat(v)
    else:
        yield x


def _cpu(x):
    return _map(x, lambda t: t.detach().to("cpu", copy=True))


def _shape(x):
    """The shapes of ``x``'s tensors (anything else reads as None)."""
    if torch.is_tensor(x):
        return tuple(x.shape)
    if isinstance(x, (tuple, list)):
        return tuple(_shape(v) for v in x)
    return None


class Decisions:
    """Record what each choice point returns in each step, with the
    arguments of the points named in ``keep_args``; with ``follow`` (another
    run's ``steps``) return that run's choice instead.  ``alter`` maps a
    key to a planted fault ``fn(out, *args)`` applied where the choice is
    made."""

    def __init__(self, points, follow=None, alter=None, keep_args=()):
        self.steps: list = []
        self.follow = follow
        self.alter = alter or {}
        self.keep_args = set(keep_args)
        self.active = False
        self._undo = []
        for owner, attr, key in points:
            real = getattr(owner, attr)
            self._undo.append((owner, attr, real, attr in vars(owner)))
            setattr(owner, attr, self._wrap(real, key))

    def begin(self) -> None:
        self.steps.append({})
        self.active = True

    def end(self) -> None:
        self.active = False

    def close(self) -> None:
        for owner, attr, real, own in reversed(self._undo):
            if own:
                setattr(owner, attr, real)
            else:
                delattr(owner, attr)          # an instance's method: drop the shadow

    def _wrap(self, real, key):
        def choose(*args, **kwargs):
            out = real(*args, **kwargs)
            if not self.active:
                return out
            if key in self.alter:
                out = self.alter[key](out, *args)
            rec = self.steps[-1]
            if key in rec:                    # the first call of a step is the one kept
                return out
            rec[key] = {"out": _cpu(out)}
            if key in self.keep_args:
                rec[key]["args"] = (_cpu(args), dict(kwargs))
            if self.follow is None:
                return out
            theirs = self.follow[len(self.steps) - 1].get(key)
            if theirs is None or _shape(theirs["out"]) != _shape(out):
                return out                    # another batch: nothing to impose
            dev = next(t for t in _flat(out) if torch.is_tensor(t)).device
            return _map(theirs["out"], lambda t: t.to(dev))

        return choose


def shift_assignments(out, A, W, U0, ms, *rest):
    """A planted fault in GA-GM's answer: each graph's assignments moved one
    node on (node ``i`` takes node ``i + 1``'s universe slot, cyclically
    over its valid nodes)."""
    U, steps = out
    G = ms.shape[0]
    M = U.shape[0] // G
    shifted = U.clone()
    for g in range(G):
        n = int(ms[g])
        if n > 1:
            shifted[g * M:g * M + n] = torch.roll(U[g * M:g * M + n], 1, dims=0)
    return shifted, steps


def perturb_projection(out, *args):
    """A planted fault in a Sinkhorn projection's answer: each slice's rows
    rolled by one."""
    return torch.roll(out, 1, dims=-2)
