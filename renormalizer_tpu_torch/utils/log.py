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


init_log()
