"""Host milliseconds per evaluated image in the paste
(``engine/trainer.py:postprocess_detections`` over ``ops/mask_paste.py``,
the masks' copy to the host included) and the evaluator's ``process``
(``evaluation/dice.py``)."""

UNIT = "ms"
MOVES = "tta_images_per_s"


def read(record):
    spans = [s for s in record["spans"] if s[0] in ("eval.paste", "eval.process")]
    n = record["counts"].get("images")
    if not spans or not n or "passes" not in record["counts"]:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / n
