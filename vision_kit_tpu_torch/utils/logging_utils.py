"""Logging: Rich console (plain stream without rich) and a per-run file.

Counterpart of vision_kit_tpu/utils/logging_utils.py: the port logs under
the name "vision_kit_tpu_torch", and setup_logger writes `<output_dir>/log.log`.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("vision_kit_tpu_torch")


def setup_logger(output_dir: str | None = None, level=logging.INFO):
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    try:
        from rich.logging import RichHandler

        handler = RichHandler(rich_tracebacks=True, show_path=False)
    except ImportError:
        handler = logging.StreamHandler()
    handler.setLevel(level)
    logger.addHandler(handler)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
    return logger
