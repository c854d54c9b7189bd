"""From the start of the process to the start of the window: imports, the
kernel library's load (its build on a checkout's first run), writing the
data, making the weights, building the trainer and the warm-up."""

UNIT = "s"
MOVES = None


def read(record):
    return record["setup_s"]
