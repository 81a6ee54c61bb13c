"""A timestamped logger: ``setup_logger`` installs one handler on the
package's logger (the JAX package's ``OceananigansLogger``)."""

from __future__ import annotations

import logging
import sys


class _Formatter(logging.Formatter):
    def format(self, record):
        record.shortlevel = record.levelname[0]
        return super().format(record)


def setup_logger(level=logging.INFO, stream=None):
    """The package's logger at ``level``, writing timestamped lines to
    ``stream`` (standard error by default)."""
    logger = logging.getLogger("oceananigans_tpu_torch")
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(_Formatter(
            "[%(asctime)s] %(shortlevel)s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
    return logger


logger = setup_logger()
