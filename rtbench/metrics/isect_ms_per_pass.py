"""isect_ms_per_pass: device ms a traced pass of the intersection
kernels, the renderer's csrc launchers (tracing.ISECT_KERNELS)."""


def read(record):
    if not record.get("isect_us"):
        return None
    return record["isect_us"] / 1e3 / record["units"]
