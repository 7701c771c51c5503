"""Disk-backed request journal: serving survives process restart.

Reference: Spark serving recovers a restarted streaming query from its
`checkpointLocation` — uncommitted epochs are replayed through the pipeline
(HTTPSourceV2.scala:488-505 recoveredPartitions + the streaming engine's
offset log).  The in-memory epoch history in `WorkerServer` covers consumer
(task) death; this journal covers PROCESS death: every accepted request is
appended to an append-only JSONL file before it enters the queue, replies
are journaled as they are written, and a fresh server pointed at the same
journal path requeues every unanswered request (at-least-once processing —
replies to connections that died with the old process are discarded, as the
reference's are).

Durability model: `log_request` flushes to the OS (survives process crash;
an OS crash is out of scope, as it is for the reference's local checkpoint
dirs).  Reply lines are buffered and flushed on epoch commit, so a crash
may replay an already-answered request — at-least-once, never lost.

The file is compacted in place (rewritten with only outstanding requests)
once the dead-record count passes `compact_every`, so long-running servers
don't grow the journal without bound.

A copy of the JAX package's `serving/journal.py` for this package.
"""
from __future__ import annotations

import base64
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["EpochJournal"]


class EpochJournal:
    """Append-only request/reply journal with in-place compaction."""

    def __init__(self, path: str, compact_every: int = 1024):
        self.path = path
        self.compact_every = int(compact_every)
        self._lock = threading.Lock()
        # id -> (entity, headers) of journaled-but-unanswered requests;
        # doubles as the compaction source and the recovery result
        self._outstanding: Dict[str, Tuple[bytes, dict]] = {}
        self._dead_records = 0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._recovered = self._load()
        # append-only log: records are flushed per write and replay
        # tolerates a torn tail; atomicity (tmp+fsync+replace) lives in
        # _compact_locked, which rewrites the whole file
        self._f = open(path, "a", encoding="utf-8")  # graftlint: disable=G404
        if self._recovered:
            # drop answered records from the recovered file ATOMICALLY
            # (tmp + rename) — the unanswered requests are never off disk,
            # so a crash at any point during startup cannot lose them
            with self._lock:
                self._compact_locked()

    # ---- write path ----------------------------------------------------
    def log_request(self, req_id: str, entity: bytes,
                    headers: Optional[dict] = None):
        """Journal an accepted request; flushed so a process crash after
        accept cannot lose it."""
        rec = {"t": "req", "id": req_id,
               "e": base64.b64encode(entity or b"").decode("ascii")}
        if headers:
            rec["h"] = dict(headers)
        with self._lock:
            self._outstanding[req_id] = (entity or b"", dict(headers or {}))
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def log_reply(self, req_id: str):
        """Journal an answered request (buffered; flushed on commit)."""
        with self._lock:
            if req_id not in self._outstanding:
                return
            del self._outstanding[req_id]
            self._dead_records += 2  # the req line + this reply line
            self._f.write(json.dumps({"t": "rep", "id": req_id}) + "\n")

    def flush(self):
        """Epoch-commit barrier: replies written so far become durable; may
        trigger compaction."""
        with self._lock:
            self._f.flush()
            if self._dead_records >= self.compact_every:
                self._compact_locked()

    def close(self):
        with self._lock:
            self._f.close()

    # ---- recovery ------------------------------------------------------
    def recovered_requests(self) -> List[Tuple[str, bytes, dict]]:
        """(id, entity, headers) of every request journaled by a previous
        process and never answered — requeue these on start."""
        out, self._recovered = self._recovered, []
        return out

    def _load(self) -> List[Tuple[str, bytes, dict]]:
        """Read a previous process's journal: unanswered requests become
        both the recovery result and this journal's initial outstanding
        set (they stay journaled under their original ids until answered —
        the file is never truncated, only compacted atomically)."""
        if not os.path.exists(self.path):
            return []
        reqs: Dict[str, Tuple[bytes, dict]] = {}
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from the crash: ignore
                if not isinstance(rec, dict) or "id" not in rec:
                    # valid JSON but not a journal record (torn write that
                    # happens to parse, or foreign junk): recovery must
                    # salvage the rest of the file, not die on one line
                    continue
                if rec.get("t") == "req":
                    try:
                        entity = base64.b64decode(rec.get("e", ""))
                    except (ValueError, TypeError):
                        continue  # corrupt payload: unrecoverable record
                    reqs[rec["id"]] = (entity, rec.get("h", {}))
                elif rec.get("t") == "rep":
                    reqs.pop(rec["id"], None)
        self._outstanding = dict(reqs)
        return [(i, e, h) for i, (e, h) in reqs.items()]

    def _compact_locked(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for req_id, (entity, headers) in self._outstanding.items():
                rec = {"t": "req", "id": req_id,
                       "e": base64.b64encode(entity).decode("ascii")}
                if headers:
                    rec["h"] = headers
                f.write(json.dumps(rec) + "\n")
            f.flush()
            # fsync BEFORE the rename: os.replace is atomic for the name,
            # but without it a power loss can leave the new name pointing
            # at un-persisted blocks — losing every outstanding request
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        self._dead_records = 0
