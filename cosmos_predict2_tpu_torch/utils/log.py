"""Process-0-filtered logging, the port's counterpart of
cosmos_predict2_tpu/utils/log.py (after the reference's loguru wrapper,
cosmos_predict2/_src/imaginaire/utils/log.py).

In a job of several processes only process 0 emits, unless a record asks
for ``all_hosts=True``. The process index is ``torch.distributed``'s rank
once a process group is initialised, else the ``RANK`` environment variable
(torchrun sets it), else 0. Records go to the logger
``cosmos_predict2_tpu_torch`` at INFO, or DEBUG under ``COSMOS_VERBOSE``.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER = logging.getLogger("cosmos_predict2_tpu_torch")
_FORMAT = "[%(asctime)s|%(levelname)s|%(filename)s:%(lineno)d] %(message)s"
_initialised = False


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def _root_unconfigured(record: logging.LogRecord) -> bool:
    """The stderr handler's filter: it prints only while the root logger has
    no handler. Once one is there (``logging.basicConfig`` in an entry point,
    pytest's capture) the record reaches it by propagation, and is printed
    once."""
    return not logging.getLogger().handlers


def init(level: int | str | None = None, log_file: str | None = None) -> None:
    """Set the level and the handlers. Safe to call more than once."""
    global _initialised
    from cosmos_predict2_tpu_torch.utils.flags import VERBOSE

    if level is None:
        level = logging.DEBUG if VERBOSE else logging.INFO
    _LOGGER.setLevel(level)
    if not _LOGGER.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        handler.addFilter(_root_unconfigured)
        _LOGGER.addHandler(handler)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        _LOGGER.addHandler(fh)
    _initialised = True


def _log(level: int, msg: str, all_hosts: bool = False) -> None:
    if not _initialised:
        init()
    if all_hosts or _process_index() == 0:
        _LOGGER.log(level, msg, stacklevel=3)


def debug(msg: str, all_hosts: bool = False) -> None:
    _log(logging.DEBUG, msg, all_hosts)


def info(msg: str, all_hosts: bool = False) -> None:
    _log(logging.INFO, msg, all_hosts)


def warning(msg: str, all_hosts: bool = False) -> None:
    _log(logging.WARNING, msg, all_hosts)


def error(msg: str, all_hosts: bool = False) -> None:
    _log(logging.ERROR, msg, all_hosts)


def critical(msg: str, all_hosts: bool = False) -> None:
    _log(logging.CRITICAL, msg, all_hosts)
