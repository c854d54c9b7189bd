"""Share of the window in which the eval-only loops (the TTA steps' loop in
``BaselineTrainer.test`` and ``evaluate_dataset``'s) block in the test
loader's ``next``."""

UNIT = "%"
MOVES = "tta_images_per_s"


def read(record):
    spans = [s for s in record["spans"] if s[0] == "tta.loader_wait"]
    if not spans:
        return None
    return 100.0 * sum(s[2] - s[1] for s in spans) / record["window_s"]
