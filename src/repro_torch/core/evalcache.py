"""Pluggable eval-cache backends (DESIGN.md §6/§11).

The cross-call eval cache used to be a module-level dict in
`repro_torch.core.evaluator`; fleet-scale campaign execution (repro_torch.explore.fleet)
needs (a) bounded memory over long campaigns and (b) evaluation sharing
across *processes* and *successive campaigns* — fig8's methods revisit the
same candidates, so cross-campaign sharing is free hypervolume. Both live
behind the `EvalCacheBackend` protocol:

    InMemoryEvalCache     LRU dict with a configurable entry cap and an
                          eviction counter (the default backend — same
                          semantics the evaluator always had, plus LRU
                          instead of FIFO eviction).
    DiskSegmentEvalCache  the in-memory LRU fronting a shared directory of
                          append-only segment files, one per writer
                          process, merged on read. Writes never contend
                          (single writer per segment); readers pick up
                          other processes' entries by replaying segment
                          bytes they have not consumed yet, tolerating a
                          truncated in-flight tail record.

Keys are the evaluator's existing tuple
(design, workload, fidelity, n_wafers, max_strategies, params-digest) —
frozen dataclasses with content equality, so a pickled key round-trips
across processes and still compares equal. The params element must be the
content *digest* (`evaluator.gnn_params_digest`), never the process-local
pin token: tokens are monotonic per process and would alias across workers.

Every backend is thread-safe: async proposal mode (DESIGN.md §11)
evaluates batches on worker threads that hit the cache concurrently with
the proposer.

The port's own copy of `repro.core.evalcache`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import threading
import uuid
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

Key = Tuple
SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".evalcache.pkl"

# per-thread cache-traffic accumulator (see `attribute_cache_traffic`):
# lets the exploration loop attribute hits/misses/entries to a fidelity
# stage even when async proposal mode evaluates batches on concurrent
# threads — global before/after counter snapshots would race.
_TLS = threading.local()


@contextlib.contextmanager
def attribute_cache_traffic():
    """Context manager yielding a {hits, misses, entries_added} dict that
    accumulates every cache access made by THIS thread inside the block
    (nested blocks stack: traffic lands in the innermost)."""
    acc = {"hits": 0, "misses": 0, "entries_added": 0}
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(acc)
    try:
        yield acc
    finally:
        stack.pop()


def _bump(field: str, n: int = 1) -> None:
    stack = getattr(_TLS, "stack", None)
    if stack:
        stack[-1][field] += n


class EvalCacheBackend:
    """Protocol + shared bookkeeping for eval-cache backends. Subclasses
    implement `_get`/`_put`/`_clear`/`_extra_stats`; this base keeps the
    hit/miss counters and the lock."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.set_many_calls = 0
        self.set_many_entries = 0

    # -- protocol ----------------------------------------------------------

    def get(self, key: Key):
        with self._lock:
            v = self._get(key)
            if v is None:
                self.misses += 1
                _bump("misses")
            else:
                self.hits += 1
                _bump("hits")
            return v

    def put(self, key: Key, value):
        with self._lock:
            self._put(key, value)
            _bump("entries_added")
        return value

    def set_many(self, items) -> int:
        """Batch insert of (key, value) pairs: one lock acquisition — and
        for disk-backed caches one segment append + flush — per call, so
        the fused evaluation path writes a whole iteration's results in a
        single operation. Returns the number of entries written."""
        items = list(items)
        with self._lock:
            self._put_many(items)
            self.set_many_calls += 1
            self.set_many_entries += len(items)
            _bump("entries_added", len(items))
        return len(items)

    def clear(self) -> None:
        with self._lock:
            self._clear()
            self.hits = self.misses = 0
            self.set_many_calls = self.set_many_entries = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            s = {"hits": self.hits, "misses": self.misses,
                 "entries": self._entries(),
                 "set_many_calls": self.set_many_calls,
                 "set_many_entries": self.set_many_entries}
            s.update(self._extra_stats())
            return s

    # -- subclass surface --------------------------------------------------

    def _get(self, key: Key):
        raise NotImplementedError

    def _put(self, key: Key, value) -> None:
        raise NotImplementedError

    def _put_many(self, items) -> None:
        for key, value in items:
            self._put(key, value)

    def _clear(self) -> None:
        raise NotImplementedError

    def _entries(self) -> int:
        raise NotImplementedError

    def _extra_stats(self) -> Dict[str, int]:
        return {}


class InMemoryEvalCache(EvalCacheBackend):
    """Bounded LRU over an OrderedDict: a hit refreshes recency, inserts
    over `max_entries` evict the least-recently-used entry (counted in
    `evictions`) — long campaigns no longer grow the cache without bound."""

    def __init__(self, max_entries: int = 100_000) -> None:
        super().__init__()
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self.evictions = 0
        self._d: "OrderedDict[Key, object]" = OrderedDict()

    def _get(self, key: Key):
        v = self._d.get(key)
        if v is not None:
            self._d.move_to_end(key)
        return v

    def _put(self, key: Key, value) -> None:
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def _clear(self) -> None:
        self._d.clear()
        self.evictions = 0

    def _entries(self) -> int:
        return len(self._d)

    def _extra_stats(self) -> Dict[str, int]:
        return {"evictions": self.evictions, "max_entries": self.max_entries}


def _iter_records(path: str, offset: int) -> Iterator[Tuple[Key, object,
                                                            int]]:
    """Replay (key, value) records appended to a segment file from
    `offset`, yielding the end offset of each good record. A truncated tail
    (a writer mid-append, or a crash mid-record) terminates the replay at
    the last complete record instead of raising."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            while True:
                try:
                    key, value = pickle.load(f)
                except EOFError:
                    return
                except Exception:
                    # torn tail record: stop here; the consumed offset
                    # stays at the last good record so a later refresh
                    # retries once the writer finishes the append
                    return
                yield key, value, f.tell()
    except OSError:
        return


class DiskSegmentEvalCache(EvalCacheBackend):
    """Shared persistent cache: an in-memory LRU front + one append-only
    segment file per writer process in a shared directory, merged on read.

    put(): insert into the LRU and append the pickled (key, value) record
    to this process's own segment (single writer — no locking across
    processes). get(): LRU first; on a miss, re-scan the directory for
    segments that grew since the last merge and replay their new records,
    then retry. Eviction only trims the memory front — the on-disk
    history is append-only, so a cold process rebuilds the merged view by
    replaying every segment."""

    def __init__(self, cache_dir: str, max_entries: int = 100_000) -> None:
        super().__init__()
        self.cache_dir = os.path.abspath(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        self.mem = InMemoryEvalCache(max_entries=max_entries)
        self._offsets: Dict[str, int] = {}      # segment path -> bytes read
        self._own_path: Optional[str] = None
        self._own_file = None
        self.merged_in = 0                      # records adopted from peers
        self.refreshes = 0
        self._refresh_locked()

    # -- segment plumbing --------------------------------------------------

    def _segments(self):
        try:
            names = sorted(os.listdir(self.cache_dir))
        except OSError:
            return []
        return [os.path.join(self.cache_dir, n) for n in names
                if n.startswith(SEGMENT_PREFIX)
                and n.endswith(SEGMENT_SUFFIX)]

    def _ensure_own(self):
        if self._own_file is None:
            name = (f"{SEGMENT_PREFIX}{os.getpid()}-"
                    f"{uuid.uuid4().hex[:8]}{SEGMENT_SUFFIX}")
            self._own_path = os.path.join(self.cache_dir, name)
            self._own_file = open(self._own_path, "ab")
        return self._own_file

    def _refresh_locked(self) -> int:
        """Replay new bytes from peer segments into the memory front.
        Returns the number of records merged."""
        n = 0
        for path in self._segments():
            if path == self._own_path:
                continue
            off = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size <= off:
                continue
            for key, value, end in _iter_records(path, off):
                # peers' entries refresh the LRU like local inserts
                self.mem._put(key, value)
                off = end
                n += 1
            self._offsets[path] = off
        self.merged_in += n
        self.refreshes += 1
        return n

    def refresh(self) -> int:
        with self._lock:
            return self._refresh_locked()

    # -- backend surface ---------------------------------------------------

    def _get(self, key: Key):
        v = self.mem._get(key)
        if v is not None:
            return v
        if self._refresh_locked():
            return self.mem._get(key)
        return None

    def _put(self, key: Key, value) -> None:
        self.mem._put(key, value)
        f = self._ensure_own()
        pickle.dump((key, value), f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()

    def _put_many(self, items) -> None:
        """One buffered append + flush for the whole batch; the record
        stream stays `_iter_records`-compatible (back-to-back pickles)."""
        for key, value in items:
            self.mem._put(key, value)
        if not items:
            return
        f = self._ensure_own()
        f.write(b"".join(
            pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)
            for rec in items))
        f.flush()

    def _clear(self) -> None:
        """Drop the memory front and forget merge offsets. Segment files
        are append-only shared state — other workers may be reading them —
        so clear() never deletes from disk; use `purge()` for that."""
        self.mem._clear()
        self._offsets.clear()
        self.merged_in = 0
        # skip our own already-written records on the next refresh: clear()
        # means "forget what this process has seen", not "unshare it"
        if self._own_path is not None:
            try:
                self._offsets[self._own_path] = os.path.getsize(
                    self._own_path)
            except OSError:
                pass

    def purge(self) -> None:
        """Delete every segment file (tests / explicit cache resets)."""
        with self._lock:
            self.close()
            for path in self._segments():
                try:
                    os.remove(path)
                except OSError:
                    pass
            self.mem._clear()
            self._offsets.clear()
            self.merged_in = 0
            self.hits = self.misses = 0

    def close(self) -> None:
        if self._own_file is not None:
            self._own_file.close()
            self._own_file = None
            self._own_path = None

    def _entries(self) -> int:
        return self.mem._entries()

    def _extra_stats(self) -> Dict[str, int]:
        return {"evictions": self.mem.evictions,
                "max_entries": self.mem.max_entries,
                "segments": len(self._segments()),
                "merged_in": self.merged_in,
                "refreshes": self.refreshes}


__all__ = ["DiskSegmentEvalCache", "EvalCacheBackend", "InMemoryEvalCache",
           "SEGMENT_PREFIX", "SEGMENT_SUFFIX", "attribute_cache_traffic"]
