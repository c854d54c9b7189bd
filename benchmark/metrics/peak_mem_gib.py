"""``torch.cuda.max_memory_allocated()`` over the window (reset after
set-up), in GiB."""

UNIT = "GiB"
MOVES = None


def read(record):
    return record["memory_peak_bytes"] / 2 ** 30
