"""scatter_pct: the share, in %, of a traced step's device time that the
kernels under `index_put_` (the backward of the shading path's row
gathers, outermost op by name) took."""


def read(record):
    if not record.get("scatter_us") or not record.get("device_us"):
        return None
    return 100.0 * record["scatter_us"] / record["device_us"]
