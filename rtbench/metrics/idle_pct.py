"""idle_pct.<kind> (idle_pct.render, idle_pct.train): the share, in %,
of the traced passes' or steps' wall time in which no device event ran."""


def read(record):
    if not record.get("busy_s") or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
