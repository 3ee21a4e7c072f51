"""Logging — the reference's Dev/Log facility (Log.{h,cpp}); port of
`vk3dgaussiansplatting_tpu.utils.log` on its own logger,
"vk3dgs_tpu_torch".

The same four severities (`write`, `warning`, `error`, `alert`); errors
raise instead of popping a Win32 message box, alerts print prominently.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("vk3dgs_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("[Log]: %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)


def write(msg: str) -> None:
    _logger.info(msg)


def warning(msg: str) -> None:
    _logger.warning("~~~ WARNING ~~~ %s", msg)


def error(msg: str) -> None:
    _logger.error("~~~ ERROR ~~~ %s", msg)
    raise RuntimeError(msg)


def alert(title: str, msg: str) -> None:
    """Log::writeAlert (the reference's final benchmark averages)."""
    _logger.info("=== %s ===\n%s", title, msg)
