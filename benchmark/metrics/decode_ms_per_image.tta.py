"""Host milliseconds per ``data/loader.py:load_image`` call of the test
loader (in its prefetch thread), over the window."""

UNIT = "ms"
MOVES = "tta_images_per_s"


def read(record):
    if "passes" not in record["counts"]:
        return None
    spans = [s for s in record["spans"] if s[0] == "decode"]
    if not spans:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / len(spans)
