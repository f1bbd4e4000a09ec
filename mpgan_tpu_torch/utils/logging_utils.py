"""Logging setup (``mpgan_tpu/utils/logging_utils.py``; setup_training.py:30-66,
1113-1131): a level-coloured console format with a debug format that carries
file, line and function, or a plain log file, and the level by name. Both
training entry points (``cli.train``, ``cli.train_mnist``) call
:func:`init_logging` before anything logs.
"""

from __future__ import annotations

import logging
import sys


class ColorFormatter(logging.Formatter):
    """Level-coloured console output; a file handler gets the plain formats."""

    RESET = "\x1b[0m"
    COLORS = {
        logging.DEBUG: "\x1b[1;34m",  # blue
        logging.INFO: "\x1b[38;21m",  # grey
        logging.WARNING: "\x1b[33;21m",  # yellow
        logging.ERROR: "\x1b[31;21m",  # red
        logging.CRITICAL: "\x1b[31;1m",  # bold red
    }
    INFO_FORMAT = "%(asctime)s %(message)s"
    DEBUG_FORMAT = "%(asctime)s [%(filename)s:%(lineno)d in %(funcName)s] %(message)s"

    def __init__(self, colored: bool = True):
        super().__init__()
        self.colored = colored

    def format(self, record: logging.LogRecord) -> str:
        fmt = self.INFO_FORMAT if record.levelno == logging.INFO else self.DEBUG_FORMAT
        if self.colored:
            fmt = self.COLORS.get(record.levelno, "") + fmt + self.RESET
        return logging.Formatter(fmt, datefmt="%d/%m %H:%M:%S").format(record)


def init_logging(level: str = "INFO", log_file: str = "") -> None:
    """``log_file`` ``''`` or ``'stdout'`` logs to the console (coloured); any
    other value logs to that file (plain)."""
    to_stdout = log_file in ("", "stdout")
    handler = logging.StreamHandler(sys.stdout) if to_stdout else logging.FileHandler(log_file)
    lvl = getattr(logging, str(level).upper(), logging.INFO)
    handler.setLevel(lvl)
    handler.setFormatter(ColorFormatter(colored=to_stdout))
    logging.basicConfig(handlers=[handler], level=lvl, force=True)
    logging.getLogger("matplotlib.font_manager").setLevel(logging.WARNING)
