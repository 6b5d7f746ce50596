"""Central logging configuration.

Copied from ``otto_tpu/logging_utils.py`` with the logger renamed
``otto_tpu_torch``.

Replaces the reference's module-level logging setup (reference:
src/settings.py:14-28 — timestamped file handler + stream handler) with an
explicit, idempotent configurator that does not run at import time.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

_FORMAT = "%(asctime)s - %(levelname)s - %(name)s - %(message)s"
_configured = False


def configure_logging(log_dir: str | Path | None = None, level: int = logging.INFO) -> logging.Logger:
    """Configure the root ``otto_tpu_torch`` logger once.

    Parameters
    ----------
    log_dir: optional directory; when given, a timestamped log file is created
        there (mirroring the reference's per-run log files).
    """
    global _configured
    logger = logging.getLogger("otto_tpu_torch")
    if _configured:
        return logger
    logger.setLevel(level)
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(stream)
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_dir / f"otto_tpu_torch_{time.strftime('%Y%m%d_%H%M%S')}.log")
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    logger.propagate = False
    _configured = True
    return logger


def get_logger(name: str = "otto_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
