"""Share of the window in which ``ATeacherTrainer.train_semisup`` blocks in
``next`` of the two-crop loader (``data/loader.py:build_two_crop_loader``)."""

UNIT = "%"
MOVES = "peak_mem_gib"


def read(record):
    spans = [s for s in record["spans"] if s[0] == "mt.loader_wait"]
    if not spans:
        return None
    return 100.0 * sum(s[2] - s[1] for s in spans) / record["window_s"]
