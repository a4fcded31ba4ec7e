"""Logging setup (reference src/utils/logging.rs: tracing + EnvFilter;
here stdlib logging with the TM_LOG env var mirroring RUST_LOG; counterpart
of ``trackmaker_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname)5s %(name)s: %(message)s"
_initialized = False


def init_logging(level: str | None = None) -> None:
    global _initialized
    if _initialized:
        return
    lvl = (level or os.environ.get("TM_LOG", "info")).upper()
    logging.basicConfig(level=getattr(logging, lvl, logging.INFO),
                        format=_FORMAT, datefmt="%H:%M:%S")
    _initialized = True


def get_logger(name: str) -> logging.Logger:
    init_logging()
    return logging.getLogger(name)
