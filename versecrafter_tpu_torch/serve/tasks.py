"""Thread-safe task registry for the serving tiers' asynchronous jobs.

The port's own copy of ``versecrafter_tpu.serve.tasks``: a Task with id,
status, progress, message, result and error, created and updated under one
lock, and a locked store for chunked uploads (the proxy-traversal upload
path).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional

PENDING, RUNNING, COMPLETED, FAILED = "PENDING", "RUNNING", "COMPLETED", "FAILED"


@dataclass
class Task:
    task_id: str
    task_type: str
    status: str = PENDING
    progress: int = 0
    message: str = ""
    result: Optional[dict] = None
    error: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id,
            "type": self.task_type,
            "status": self.status,
            "progress": self.progress,
            "message": self.message,
            "result": self.result,
            "error": self.error,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }


class TaskRegistry:
    def __init__(self):
        self._tasks: Dict[str, Task] = {}
        self._lock = threading.Lock()

    def create(self, task_type: str) -> Task:
        t = Task(task_id=uuid.uuid4().hex[:16], task_type=task_type)
        with self._lock:
            self._tasks[t.task_id] = t
        return t

    def update(self, task_id: str, **kw) -> None:
        with self._lock:
            t = self._tasks.get(task_id)
            if t is None:
                return
            for k, v in kw.items():
                setattr(t, k, v)
            t.updated_at = time.time()

    def get(self, task_id: str) -> Optional[dict]:
        with self._lock:
            t = self._tasks.get(task_id)
            return t.to_dict() if t else None

    def all(self) -> list:
        with self._lock:
            return [t.to_dict() for t in self._tasks.values()]


class ChunkStore:
    """Locked store for chunked uploads."""

    def __init__(self):
        self._chunks: Dict[str, Dict[int, bytes]] = {}
        self._meta: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def put(self, upload_id: str, index: int, data: bytes,
            total: Optional[int] = None, filename: Optional[str] = None):
        with self._lock:
            self._chunks.setdefault(upload_id, {})[index] = data
            meta = self._meta.setdefault(upload_id, {})
            if total is not None:
                meta["total"] = total
            if filename is not None:
                meta["filename"] = filename

    def complete(self, upload_id: str) -> Optional[bytes]:
        """The joined upload once every chunk arrived (then forgotten), else
        None."""
        with self._lock:
            chunks = self._chunks.get(upload_id)
            meta = self._meta.get(upload_id, {})
            if not chunks:
                return None
            total = meta.get("total", len(chunks))
            if len(chunks) < total:
                return None
            data = b"".join(chunks[i] for i in sorted(chunks))
            del self._chunks[upload_id]
            self._meta.pop(upload_id, None)
            return data
