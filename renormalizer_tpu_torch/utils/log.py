"""Package logging setup (reference ``renormalizer/utils/log.py``)."""

import logging
import os
import sys

DEFAULT_FORMAT = "%(asctime)s[%(levelname)s] %(message)s"
package_logger = logging.getLogger("renormalizer_tpu_torch")


def init_log(level=None):
    if level is None:
        level_name = os.environ.get("RENO_LOG_LEVEL", "INFO").upper()
        level = getattr(logging, level_name, logging.INFO)
    package_logger.setLevel(level)
    if not package_logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(DEFAULT_FORMAT))
        package_logger.addHandler(handler)


def set_stream_level(level):
    """Level of every handler of the package logger."""
    for h in package_logger.handlers:
        h.setLevel(level)


def register_file_output(file_path, mode="w", level=logging.DEBUG):
    """Also write the package's log records to ``file_path``; returns the
    handler (remove it from ``package_logger`` to stop)."""
    handler = logging.FileHandler(file_path, mode=mode)
    handler.setFormatter(logging.Formatter(DEFAULT_FORMAT))
    handler.setLevel(level)
    package_logger.addHandler(handler)
    return handler


init_log()


def getLogger(name=None):
    """The reference's public ``getLogger``."""
    return logging.getLogger(name)


def disable_stream_output():
    """Remove the root logger's stream handlers (file handlers stay)."""
    root = logging.getLogger()
    for h in list(root.handlers):
        if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler):
            root.removeHandler(h)
