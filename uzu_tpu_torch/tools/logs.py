"""File logging + local event journal.

Counterpart of `uzu_tpu/tools/logs.py`: a rotating log file for the
`uzu_tpu_torch` logger tree and a JSONL journal of events, each with the
card's name when a card is present. Events stay local, in a file the
operator owns.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import threading
import time
from typing import Optional

import torch

_journal_lock = threading.Lock()
_journal_path: Optional[str] = None


def start(log_dir: str, *, level: int = logging.INFO,
          max_bytes: int = 16 * 1024 * 1024, backups: int = 3) -> str:
    """Attach a rotating file handler for the uzu_tpu_torch logger tree and
    open the event journal. Returns the log file path."""
    global _journal_path
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "uzu_tpu_torch.log")
    handler = logging.handlers.RotatingFileHandler(
        path, maxBytes=max_bytes, backupCount=backups
    )
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root = logging.getLogger("uzu_tpu_torch")
    root.setLevel(level)
    root.addHandler(handler)
    _journal_path = os.path.join(log_dir, "events.jsonl")
    return path


def event(name: str, **payload) -> None:
    """Append an event to the local journal (name + timestamp + payload +
    the card's name, where there is a card)."""
    if _journal_path is None:
        return
    record = {"event": name, "ts": time.time(), **payload}
    if torch.cuda.is_available():
        record.setdefault("device", torch.cuda.get_device_name())
    line = json.dumps(record)
    with _journal_lock:
        with open(_journal_path, "a") as f:
            f.write(line + "\n")


def logger(name: str = "uzu_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)
