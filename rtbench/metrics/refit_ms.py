"""refit_ms: the median ms of the window's geometry.refit.refit calls,
host clock between two synchronises."""


def read(record):
    return record.get("refit_ms")
