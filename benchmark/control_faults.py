"""``control.py`` with the faults of the ViTDet and mean-teacher cells added
to the faults it plants in the program (``--program --plant <name>``):

* ``_no_rel_pos``: the relative-position bias left out of the program's
  attention (kernel F's ``rel_h`` and ``rel_w`` zeroed at
  ``ops/vit_attention.py:vit_attention``);
* ``_teacher_not_updated``: the mean-teacher trainer's teacher never
  updated: neither copied from the student at burn-up nor moved by the
  moving average;
* ``_ema_skipped``: the copy at burn-up kept, the moving average skipped;
* ``_wrong_keep_rate``: the moving average with keep 0.999 in place of the
  configuration's.

    python3 benchmark/control_faults.py --workload <cell> --seeds <n> ... --program --plant <name>
"""

from __future__ import annotations

import functools
import sys

import control


def _no_rel_pos(patch):
    """The relative-position bias left out of the program's attention."""
    import torch

    from ttdg_mgm_torch.ops import vit_attention as op

    real = op.vit_attention

    def attention(q, k, v, rel_h, rel_w, scale):
        return real(q, k, v, torch.zeros_like(rel_h), torch.zeros_like(rel_w), scale)

    patch(op, "vit_attention", functools.update_wrapper(attention, real))


def _teacher_not_updated(patch):
    """The teacher left as it was built: its copy of the student at burn-up
    and its moving average skipped."""
    from ttdg_mgm_torch.engine import mean_teacher as mt_mod

    real_init = mt_mod.ATeacherTrainer.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.teacher.load_state_dict = lambda *args, **kwargs: None

    patch(mt_mod.ATeacherTrainer, "__init__", init)
    patch(mt_mod, "ema_update", lambda *a, **kw: None)


def _ema_skipped(patch):
    """The teacher copied from the student at burn-up, its moving average
    skipped."""
    from ttdg_mgm_torch.engine import mean_teacher as mt_mod

    patch(mt_mod, "ema_update", lambda *a, **kw: None)


def _wrong_keep_rate(patch):
    """The teacher's moving average with keep 0.999, whatever the
    configuration gives."""
    from ttdg_mgm_torch.engine import mean_teacher as mt_mod

    real = mt_mod.ema_update
    patch(mt_mod, "ema_update", lambda teacher, student, keep_rate: real(teacher, student, 0.999))


for fault in (_no_rel_pos, _teacher_not_updated, _ema_skipped, _wrong_keep_rate):
    control.PROGRAM_FAULTS[fault.__name__] = fault


if __name__ == "__main__":
    sys.exit(control.main(sys.argv[1:]))
