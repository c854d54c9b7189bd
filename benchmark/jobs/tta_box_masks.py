"""The eval-only TTA job of ``jobs/tta.py`` (set-up, window, reference and
every check of it), with the pasted masks compared detection by detection:
``mask_gap`` is the mean mask miss over the detections both sides made.

``jobs/tta.py`` reads ``mask_gap`` over the reference's ten top-scoring
detections of each image, each against the program's best-overlapping
detection of its class.  Where the detector's scores lie close together, as
under random weights, a last bit reorders those ten and lets NMS keep a
neighbouring box on one side and its twin on the other; each such swap is a
whole miss, so the number counts the ties a run happens to hit.  Here every
detection of the reference is matched to the program's of its class with
the widest box overlap; a pair at :data:`SAME_BOX_IOU` or more is the same
detection, and its two masks are compared.  A reference detection without
such a twin is a decision that went the other way (``det_gap`` and
``score_gap`` hold the scores); if fewer than half have a twin the number
is 1.
"""

from __future__ import annotations

import numpy as np

import compare
from jobs import tta
from jobs.common import flop_counter, free_program
from jobs.tta import check_choosers, reference, setup, window  # noqa: F401  (the job's API)

FOLLOW = tta.FOLLOW

#: box IoU at which two detections of one class are the same detection
SAME_BOX_IOU = 0.9


def twin_misses(prog: dict, ref: dict) -> tuple[list, int] | None:
    """The mask miss of each reference detection that has a twin in the
    program's (same class, box IoU at least :data:`SAME_BOX_IOU`): one
    minus the two pasted masks' IoU, 0 when both are empty; and the count
    of the reference's detections.  None for an image the program lacks."""
    misses, total = [], 0
    for image_id, r in ref.items():
        p = prog.get(image_id)
        if p is None:
            return None
        n = len(r["scores"])
        total += n
        if not n or not len(p["boxes"]):
            continue
        iou = np.where(r["classes"][:, None] == p["classes"][None, :],
                       compare._box_iou(r["boxes"], p["boxes"]), -1.0)
        twin = iou.argmax(1)
        for i in np.nonzero(iou[np.arange(n), twin] >= SAME_BOX_IOU)[0]:
            a, b = r["masks"][i].astype(bool), p["masks"][twin[i]].astype(bool)
            union = np.logical_or(a, b).sum()
            misses.append(1.0 - np.logical_and(a, b).sum() / union if union else 0.0)
    return misses, total


def mask_gap(prog: dict, ref: dict) -> float:
    """The mean of :func:`twin_misses`; 1 for an image one side lacks, or
    when fewer than half of the reference's detections have a twin."""
    out = twin_misses(prog, ref)
    if out is None or len(out[0]) < out[1] / 2:
        return 1.0
    return float(np.mean(out[0])) if out[0] else 0.0


def numbers(got: dict, ref: dict, run, log=None) -> dict:
    out = tta.numbers(got, ref, run, log=log)
    if log is not None:
        twins = twin_misses(got["detections"], ref["detections"])
        log(f"masks: twins {twins and (len(twins[0]), twins[1])}; the top-{compare.TOP_MASKS} "
            f"form of jobs/tta.py reads {out['mask_gap']!r}")
    out["mask_gap"] = mask_gap(got["detections"], ref["detections"])
    return out


def check(run) -> dict:
    from ttdg_mgm_torch.ops import gagm

    got = run.state["got"]
    free_program(run)
    check_choosers(got, run.device, solve=gagm.ga_gm_fused)
    counter = flop_counter(run) if run.trace else None
    ref = reference(run, follow=got, counter=counter)
    if run.trace:
        tta._kernel_work(run)
    return numbers(got, ref, run, log=run.log)
