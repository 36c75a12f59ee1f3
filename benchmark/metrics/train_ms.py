"""train_ms: the window's milliseconds over the trains it completed."""


def read(run):
    trains = [e for e in run.log if "rows" not in e]
    return 1e3 * run.window_s / len(trains) if trains else None
