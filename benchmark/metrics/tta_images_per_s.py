"""Test images that went through the whole eval-only pass in the window
(adapted, inferred, pasted and scored), over the window's seconds."""

UNIT = "images/s"
MOVES = None


def read(record):
    if "passes" not in record["counts"]:
        return None
    return record["counts"]["images"] / record["window_s"]
