"""Resumable multi-file model downloads with CRC validation and lock files.

Role parity: crates/download-manager (~6.2k LoC) — per-file phase state
machine deciding actions from on-disk observations (reducer/), CRC32
validation, cross-process lock files (lock_manager.rs), resumable ranged
fetches. Redesigned compactly around the same observable contract:

- a manifest lists files with sizes and (optionally) crc32 checksums;
- each file downloads to `<name>.part`, resuming from the partial length
  with a Range request; completion validates size + crc32 and renames;
- a `.lock` file (pid + mtime) serializes cross-process access; stale locks
  (dead pid or old mtime) are broken, like the reference's stale-lock
  recovery;
- `plan()` is the pure reducer: it inspects disk state and returns the
  action per file (done / resume(offset) / start / corrupt-restart), so the
  decision logic is unit-testable without any network (the reference's
  reducer/ tests in mock-registry style).

file:// URLs work throughout, which is how CI exercises the full pipeline
offline (the mock-registry role).

The port's copy of `uzu_tpu/engine/downloads.py` (standard library only).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import urllib.error
import urllib.request
import zlib
from typing import Optional

LOCK_STALE_SECONDS = 300


@dataclasses.dataclass(frozen=True)
class FileSpec:
    name: str
    url: str
    size: int | None = None
    crc32: int | None = None


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str  # "done" | "start" | "resume" | "restart"
    offset: int = 0
    reason: str = ""


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def plan(spec: FileSpec, dest_dir: str) -> Action:
    """Pure reducer: disk state -> action (download-manager/src/reducer/)."""
    final = os.path.join(dest_dir, spec.name)
    part = final + ".part"
    if os.path.exists(final):
        if spec.size is not None and os.path.getsize(final) != spec.size:
            return Action("restart", reason="final size mismatch")
        if spec.crc32 is not None and file_crc32(final) != spec.crc32:
            return Action("restart", reason="final crc mismatch")
        return Action("done")
    if os.path.exists(part):
        have = os.path.getsize(part)
        if spec.size is not None and have > spec.size:
            return Action("restart", reason="partial larger than expected")
        return Action("resume", offset=have)
    return Action("start")


class LockError(RuntimeError):
    pass


class DirLock:
    """Cross-process lock file with stale-lock breaking
    (download-manager/src/lock_manager.rs)."""

    def __init__(self, dest_dir: str):
        self.path = os.path.join(dest_dir, ".uzu_download.lock")

    def _is_stale(self) -> bool:
        try:
            with open(self.path) as f:
                info = json.load(f)
            pid = int(info.get("pid", -1))
            alive = pid > 0 and _pid_alive(pid)
            old = time.time() - os.path.getmtime(self.path) > LOCK_STALE_SECONDS
            return (not alive) or old
        except (OSError, ValueError):
            return True

    def __enter__(self):
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        for _ in range(2):
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    json.dump({"pid": os.getpid(), "time": time.time()}, f)
                return self
            except FileExistsError:
                if self._is_stale():
                    try:
                        os.unlink(self.path)
                    except FileNotFoundError:
                        pass
                    continue
                raise LockError(f"download dir locked by {self.path}")
        raise LockError(f"could not acquire {self.path}")

    def __exit__(self, *exc):
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


class DownloadError(RuntimeError):
    pass


def download_file(spec: FileSpec, dest_dir: str, *, chunk: int = 1 << 20,
                  progress=None) -> str:
    """Execute one file's plan to completion; returns the final path."""
    final = os.path.join(dest_dir, spec.name)
    part = final + ".part"
    os.makedirs(os.path.dirname(final) or dest_dir, exist_ok=True)

    for attempt in range(2):
        action = plan(spec, dest_dir)
        if action.kind == "done":
            return final
        if action.kind == "restart":
            for p in (final, part):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
            action = Action("start")

        offset = action.offset
        req = urllib.request.Request(spec.url)
        if offset:
            req.add_header("Range", f"bytes={offset}-")
        mode = "ab" if offset else "wb"
        try:
            with urllib.request.urlopen(req) as resp:
                ranged = getattr(resp, "status", 200) == 206
                if offset and not ranged:
                    # server (or file://) ignored the range: skip what we have
                    to_skip = offset
                    while to_skip > 0:
                        skipped = resp.read(min(chunk, to_skip))
                        if not skipped:
                            break
                        to_skip -= len(skipped)
                with open(part, mode) as f:
                    while True:
                        block = resp.read(chunk)
                        if not block:
                            break
                        f.write(block)
                        if progress:
                            progress(spec.name, f.tell(), spec.size)
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
            # transient server/socket failure (incl. HTTP 5xx, dropped
            # connections mid-transfer): whatever landed in .part stays,
            # the next attempt re-plans and RESUMES from it (the reference's
            # wiremock Behavior fault matrix, mock-registry behavior.rs)
            if attempt == 0:
                continue
            raise DownloadError(f"{spec.name}: transfer failed ({e})") from e

        have = os.path.getsize(part)
        if spec.size is not None and have != spec.size:
            if attempt == 0:
                continue  # truncated transfer: re-plan (resume)
            raise DownloadError(f"{spec.name}: got {have} bytes, want {spec.size}")
        if spec.crc32 is not None and file_crc32(part) != spec.crc32:
            os.unlink(part)
            if attempt == 0:
                continue
            raise DownloadError(f"{spec.name}: crc mismatch")
        os.replace(part, final)
        return final
    raise DownloadError(f"{spec.name}: retries exhausted")


def download_model(files: list[FileSpec], dest_dir: str, progress=None) -> list[str]:
    """Download a model's files under a directory lock; fully resumable."""
    os.makedirs(dest_dir, exist_ok=True)
    with DirLock(dest_dir):
        return [download_file(f, dest_dir, progress=progress) for f in files]


def manifest_for_dir(src_dir: str) -> list[FileSpec]:
    """Build a file:// manifest with sizes + crc32 from a local model dir
    (the mock-registry fixture role)."""
    out = []
    for name in sorted(os.listdir(src_dir)):
        path = os.path.join(src_dir, name)
        if not os.path.isfile(path):
            continue
        out.append(
            FileSpec(
                name=name,
                url="file://" + os.path.abspath(path),
                size=os.path.getsize(path),
                crc32=file_crc32(path),
            )
        )
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
