"""rows_per_s: real rows answered in the window (padding not counted) over
the window's seconds."""


def read(run):
    rows = sum(e["rows"] for e in run.log if "rows" in e)
    return rows / run.window_s if rows else None
