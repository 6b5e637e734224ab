"""launches_per_pass: device events (kernels, copies, sets) a traced
sample pass, from the profiler's trace."""


def read(record):
    if not record.get("device_events"):
        return None
    return record["device_events"] / record["units"]
