"""Structured logging (counterpart of raytracingrenderer_tpu/utils/log.py;
replaces RTBase's bare std::cout prints, Main.cpp:112-118): loggers
under `rtr.*` with one stderr handler on `rtr`."""
from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    log = logging.getLogger(f"rtr.{name}")
    if not logging.getLogger("rtr").handlers:
        root = logging.getLogger("rtr")
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return log
