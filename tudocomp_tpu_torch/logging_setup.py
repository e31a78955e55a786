"""Command-line logging wiring (--logdir / --loglevel / --logverbosity).

The port's copy of tudocomp_tpu/logging_setup.py. Mirror of the reference's
glog flag mapping (include/tudocomp_driver/Options.hpp:239-249:
log_output_dir -> FLAGS_log_dir, log_level -> FLAGS_minloglevel,
log_verbosity -> FLAGS_v) on Python logging of the `tudocomp_tpu_torch`
logger: levels 0..3 map INFO/WARNING/ERROR/CRITICAL; any verbosity > 0
lowers it to DEBUG (the DVLOG analogue: StatPhase logs each phase's time
there); --logdir adds a timestamped file handler beside stderr.
"""

from __future__ import annotations

import logging
import os
import time

_GLOG_LEVELS = {0: logging.INFO, 1: logging.WARNING, 2: logging.ERROR, 3: logging.CRITICAL}

logger = logging.getLogger("tudocomp_tpu_torch")


def setup_logging(
    logdir: str | None = None,
    loglevel: str | int | None = None,
    logverbosity: str | int | None = None,
) -> None:
    level = logging.WARNING  # glog default: log WARNING+ to stderr
    if loglevel is not None:
        level = _GLOG_LEVELS.get(int(loglevel), logging.WARNING)
    if logverbosity is not None and int(logverbosity) > 0:
        level = logging.DEBUG

    logger.setLevel(level)
    # own handlers only: without this, records also propagate to any
    # root-logger handler an embedding app configured (duplicate lines)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(levelname).1s%(asctime)s %(name)s] %(message)s", datefmt="%m%d %H:%M:%S"
    )
    has_stream = any(
        type(h) is logging.StreamHandler for h in logger.handlers
    )
    if not has_stream:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(
            logdir, time.strftime("tdc.%Y%m%d-%H%M%S.log", time.localtime())
        )
        if not any(
            isinstance(h, logging.FileHandler)
            and os.path.dirname(getattr(h, "baseFilename", "")) == os.path.abspath(logdir)
            for h in logger.handlers
        ):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
