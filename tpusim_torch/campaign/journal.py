"""Crash-safe campaign journal — incremental JSONL state on disk.

A multi-hour campaign must survive its process dying: every completed
scenario appends ONE JSON line to ``<dir>/journal.jsonl``, flushed +
fsync'd before the runner moves on, so the journal is always a prefix
of the campaign's true progress.  Appends are single ``write`` calls of
a complete line; a crash mid-write leaves at most one trailing partial
line, which the reader detects (no terminating newline, or unparsable
JSON) and drops — the scenario simply re-prices on resume.

Record kinds::

    {"kind": "header", "v": 1, "spec_hash": ..., "seed": ...,
     "model_version": ..., "name": ...}
    {"kind": "healthy", "slice": "v5p-64", ...baseline row...}
    {"kind": "scenario", "slice": "v5p-64", "index": 7, ...outcome row...}

The header is written exactly once, first; :meth:`Journal.open_resume`
refuses a journal whose header identity (spec hash, seed, model
version) differs from the resuming campaign — splicing two different
campaigns, or two timing-model versions, into one report would be
silently wrong.

Port of ``tpusim/campaign/journal.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

__all__ = ["Journal", "JournalError"]

JOURNAL_VERSION = 1
JOURNAL_NAME = "journal.jsonl"


class JournalError(RuntimeError):
    """The on-disk journal cannot back this campaign run."""


class Journal:
    """Append-only JSONL journal for one campaign directory."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.path = self.dir / JOURNAL_NAME
        self._fh = None

    # -- reading -----------------------------------------------------------

    def iter_records(self):
        """Lazily yield every complete record currently on disk, one
        line at a time — a 10^5-scenario campaign resumes in O(1 record)
        memory instead of materializing the whole JSONL (tpusim_torch.guard).
        A trailing partial line (torn write from a crash) is dropped
        silently; a corrupt line in the MIDDLE raises — that is damage,
        not a crash artifact."""
        if not self.path.is_file():
            return
        with open(self.path, "rb") as fh:
            for lineno, raw in enumerate(fh, 1):
                # a line missing its terminating newline is the torn
                # final append of a crash (file iteration only ever
                # yields such a line LAST)
                complete = raw.endswith(b"\n")
                line = raw.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if not complete:
                        return          # torn final append: re-price it
                    raise JournalError(
                        f"{self.path}: corrupt journal line {lineno} "
                        f"(not a crash artifact — refusing to guess)"
                    )
                # complete JSON but no newline: the write made it, the
                # newline flush did not — still a usable record
                if not isinstance(rec, dict) or "kind" not in rec:
                    raise JournalError(
                        f"{self.path}: journal line {lineno} is not a "
                        f"record object"
                    )
                yield rec

    def read_records(self) -> list[dict]:
        """Every complete record, materialized (small journals / tests);
        resume paths iterate :meth:`iter_records` instead."""
        return list(self.iter_records())

    # -- writing -----------------------------------------------------------

    def _open(self) -> None:
        if self._fh is None:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "ab")

    def append(self, rec: dict) -> None:
        """Append one record: a single write of the full line, flushed
        and fsync'd — after this returns, the record survives SIGKILL."""
        self._open()
        line = json.dumps(rec, sort_keys=True) + "\n"
        self._fh.write(line.encode())
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- campaign state ----------------------------------------------------

    def open_fresh(self, header: dict) -> None:
        """Start a new journal.  Refuses to clobber an existing one —
        an accidental re-run must not erase a resumable campaign."""
        if self.path.exists() and self.path.stat().st_size > 0:
            raise JournalError(
                f"{self.path} already exists; resume it (--resume / "
                f"resume=True) or choose a fresh directory"
            )
        self.append({"kind": "header", "v": JOURNAL_VERSION, **header})

    def open_resume(self, header: dict):
        """Resume: validate the on-disk header against ``header`` and
        return ``(header_record, completed_records_iterator)`` — the
        records stream lazily (O(1) memory however long the campaign
        ran).  An empty or missing journal degrades to a fresh start."""
        it = self.iter_records()
        head = next(it, None)
        if head is None:
            self.open_fresh(header)
            return {"kind": "header", "v": JOURNAL_VERSION, **header}, iter(())
        if head.get("kind") != "header":
            it.close()
            raise JournalError(
                f"{self.path}: first record is not a header"
            )
        for key in ("spec_hash", "seed", "model_version"):
            if head.get(key) != header.get(key):
                it.close()
                raise JournalError(
                    f"{self.path}: journal {key} {head.get(key)!r} does "
                    f"not match this campaign's {header.get(key)!r} — "
                    f"refusing to resume a different campaign"
                )
        return head, it

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
