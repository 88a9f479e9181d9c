"""Logging, PyTorch-port counterpart of ``depth_completion_tpu.logger``.

A thin standard-``logging`` wrapper with a loguru-style surface: a
level-filtered stderr sink plus an optional 100 MB rotating file sink,
``logger.{trace,debug,info,success,warning,error,critical}`` and
``configure(level, log_path)``; and ``Progress``, a progress line through
the logger where the JAX package's CLIs draw a tqdm bar.
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
import time
from pathlib import Path
from typing import Any

TRACE = 5
SUCCESS = 25
logging.addLevelName(TRACE, "TRACE")
logging.addLevelName(SUCCESS, "SUCCESS")

_LEVELS = {
    "TRACE": TRACE,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "SUCCESS": SUCCESS,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "CRITICAL": logging.CRITICAL,
}

_FORMAT = "%(asctime)s | %(levelname)-8s | %(message)s"


class _Logger:
    def __init__(self) -> None:
        self._logger = logging.getLogger("depth_completion_tpu_torch")
        self._logger.setLevel(TRACE)
        self._configured = False

    def configure(self, level: str = "INFO", log_path: Path | None = None) -> None:
        """(Re)build sinks: stderr + optional rotating file (100 MB)."""
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
        lvl = _LEVELS.get(level.upper(), logging.INFO)
        sh = logging.StreamHandler(sys.stderr)
        sh.setLevel(lvl)
        sh.setFormatter(logging.Formatter(_FORMAT))
        self._logger.addHandler(sh)
        if log_path is not None:
            log_path = Path(log_path)
            log_path.parent.mkdir(parents=True, exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                log_path, maxBytes=100 * 1024 * 1024, backupCount=10
            )
            fh.setLevel(lvl)
            fh.setFormatter(logging.Formatter(_FORMAT))
            self._logger.addHandler(fh)
        self._configured = True

    def _log(self, level: int, msg: str) -> None:
        if not self._configured:
            self.configure()
        self._logger.log(level, msg)

    def trace(self, msg: str) -> None:
        self._log(TRACE, msg)

    def debug(self, msg: str) -> None:
        self._log(logging.DEBUG, msg)

    def info(self, msg: str) -> None:
        self._log(logging.INFO, msg)

    def success(self, msg: str) -> None:
        self._log(SUCCESS, msg)

    def warning(self, msg: str) -> None:
        self._log(logging.WARNING, msg)

    def error(self, msg: str) -> None:
        self._log(logging.ERROR, msg)

    def critical(self, msg: str) -> None:
        self._log(logging.CRITICAL, msg)


logger = _Logger()
LOG_LEVELS = list(_LEVELS)


class Progress:
    """A progress line per update, logged at INFO: ``desc: n/total``, the
    elapsed seconds and the last postfix values."""

    def __init__(self, total: int | None = None, desc: str = "") -> None:
        self.total, self.desc, self.n = total, desc, 0
        self.postfix: dict[str, Any] = {}
        self.t0 = time.perf_counter()

    def set_postfix(self, postfix: dict[str, Any]) -> None:
        self.postfix = dict(postfix)

    def update(self, n: int = 1) -> None:
        self.n += n
        done = f"{self.n}/{self.total}" if self.total is not None else str(self.n)
        extra = "".join(f", {k}={v:.3f}" if isinstance(v, float) else f", {k}={v}"
                        for k, v in self.postfix.items())
        logger.info(f"{self.desc}: {done} [{time.perf_counter() - self.t0:.1f} s{extra}]")
