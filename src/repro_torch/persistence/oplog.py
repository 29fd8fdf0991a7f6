"""Append-only write-ahead op log (WAL) for the durable index lifecycle: the
port of ``repro.persistence.oplog``, writing and reading the same bytes.

Every mutating facade call appends one record *before* applying it
(write-ahead discipline), so after any crash the durable state is exactly:
latest valid snapshot + the log tail — and an op whose append completed is
recovered even if the process died before applying it in memory.

Frame format (little-endian), one per record:

    magic  b"HWAL"   (4)
    seq    uint64    (8)   monotonic, 1-based, global across segments
    len    uint32    (4)   payload byte length
    crc32  uint32    (4)   zlib.crc32(payload)
    payload:
        hlen   uint32                    header byte length
        header json utf-8                {"op", "meta", "arrays": [[key,
                                          dtype, shape], ...]}
        raw array bytes, C-order, concatenated in header order

Torn-tail handling: a crash mid-append leaves a final frame that is short,
has a bad magic, or fails its CRC — ``scan`` stops at the first invalid
frame and ``open_for_append`` truncates the segment back to the last valid
frame boundary before new appends land. A crash can only tear the *tail*
(appends are sequential and earlier bytes were already fsync'd), so one
truncation point suffices; anything invalid *before* the tail is real
corruption and recovery stops there with a warning rather than guessing.

Segmentation: records live in ``wal_<firstseq>.log`` files. A snapshot at
seq S rotates to a fresh segment (``wal_<S+1>.log``) and deletes segments
whose records all precede the *oldest retained* snapshot — the fallback
path (corrupt newest snapshot -> previous snapshot + longer replay) always
finds the records it needs.

fsync policy: ``sync_every`` batches fsyncs (1 = every append is durable at
return; N = up to N-1 trailing ops may be lost to a crash — they are also
not yet applied-and-acknowledged anywhere durable, so recovery still
matches a valid uninterrupted prefix).

Arrays (numpy, or torch tensors on any device) are serialised raw, dtype
and shape in the header; the exotic dtypes map through the checkpoint
substrate's integer views and decode to torch tensors. A record is written
and checksummed from the arrays' own buffers, piece by piece, so a large
ingest record is never assembled in memory; ``scan`` decodes a record only
when it yields it.
"""
from __future__ import annotations

import json
import os
import re
import struct
import zlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint.checkpoint import (EXOTIC, from_saved, fsync_dir,
                                               fsync_file, to_savable)
from repro_torch.persistence.faultpoints import crash_point

MAGIC = b"HWAL"
_FRAME = struct.Struct("<4sQII")        # magic, seq, len, crc32


class OpRecord(NamedTuple):
    seq: int
    op: str
    meta: dict
    arrays: Dict[str, np.ndarray]


def _payload_parts(op: str, meta: dict, arrays: Dict[str, object]) -> list:
    """The payload as a list of buffers (length prefix, header, one per
    array's bytes) whose concatenation is the record's payload."""
    specs, blobs = [], []
    for key, arr in arrays.items():
        savable, name = to_savable(arr)
        specs.append([key, name, list(savable.shape)])
        blobs.append(savable.reshape(-1).view(np.uint8))
    header = json.dumps({"op": op, "meta": meta, "arrays": specs}).encode()
    return [struct.pack("<I", len(header)), header, *blobs]


def decode_payload(payload) -> Tuple[str, dict, Dict[str, object]]:
    payload = memoryview(payload)
    (hlen,) = struct.unpack_from("<I", payload, 0)
    header = json.loads(bytes(payload[4:4 + hlen]).decode())
    arrays: Dict[str, object] = {}
    off = 4 + hlen
    for key, name, shape in header["arrays"]:
        base = np.dtype(EXOTIC[name][1] if name in EXOTIC else name)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * base.itemsize
        arr = np.frombuffer(payload[off:off + nbytes], dtype=base)
        arrays[key] = from_saved(arr.reshape(shape).copy(), name)
        off += nbytes
    return header["op"], header["meta"], arrays


def _segment_seq(name: str) -> Optional[int]:
    m = re.fullmatch(r"wal_(\d+)\.log", name)
    return int(m.group(1)) if m else None


def _read_frames(path: str) -> Tuple[List[Tuple[int, memoryview]], int, bool]:
    """([(seq, payload)], valid_end_offset, clean) — stops at the first frame
    that is short, mis-magic'd, or CRC-corrupt. Payloads are views of the
    segment's bytes, not yet decoded."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    frames = []
    off = 0
    while off + _FRAME.size <= len(data):
        magic, seq, plen, crc = _FRAME.unpack_from(data, off)
        end = off + _FRAME.size + plen
        if magic != MAGIC or end > len(data):
            return frames, off, False
        payload = data[off + _FRAME.size:end]
        if zlib.crc32(payload) != crc:
            return frames, off, False
        frames.append((seq, payload))
        off = end
    return frames, off, off == len(data)


class OpLog:
    """One writer, segmented WAL under ``directory``."""

    def __init__(self, directory: str, sync_every: int = 1):
        self.directory = directory
        self.sync_every = max(int(sync_every), 1)
        os.makedirs(directory, exist_ok=True)
        self._f = None                   # open append handle (current segment)
        self._unsynced = 0
        self.last_seq = 0                # last *valid* seq on disk
        self.torn_tail = False           # a truncated/invalid tail was seen
        # (path, valid_end, clean) of the last segment the latest walk read
        self._walked: Optional[Tuple[str, int, bool]] = None

    # ----------------------------------------------------------------- layout
    def segments(self) -> List[Tuple[int, str]]:
        """[(first_seq, path)] ascending."""
        out = []
        for name in os.listdir(self.directory):
            s = _segment_seq(name)
            if s is not None:
                out.append((s, os.path.join(self.directory, name)))
        return sorted(out)

    # ------------------------------------------------------------------- read
    def _valid_seqs(self) -> Iterator[Tuple[int, memoryview]]:
        """(seq, payload) of every valid frame, in order, across segments.
        Stops (sets ``torn_tail``) at the first invalid frame or sequence
        gap; updates ``last_seq`` to the last frame passed."""
        self.torn_tail = False
        self._walked = None
        prev = None
        for _, path in self.segments():
            frames, valid_end, clean = _read_frames(path)
            self._walked = (path, valid_end, clean)
            for seq, payload in frames:
                if prev is not None and seq != prev + 1:
                    self.torn_tail = True       # gap: stop, don't guess
                    return
                prev = seq
                self.last_seq = seq
                yield seq, payload
            if not clean:
                self.torn_tail = True
                return

    def scan(self, min_seq: int = 0) -> Iterator[OpRecord]:
        """Valid records with seq > min_seq, in order, across segments.
        Stops (sets ``torn_tail``) at the first invalid frame or sequence
        gap; updates ``last_seq`` to the last record yielded-or-skipped."""
        for seq, payload in self._valid_seqs():
            if seq > min_seq:
                yield OpRecord(seq, *decode_payload(payload))

    # ------------------------------------------------------------------ write
    def open_for_append(self) -> None:
        """Positions the writer after the last valid record: scans segments,
        truncates a torn tail of the newest one, opens it for append. A
        fresh directory starts at ``wal_1.log``."""
        segs = self.segments()
        if not segs:
            self.last_seq = 0
            self._open_segment(1)
            return
        # walk the frames to settle last_seq / torn_tail
        for _ in self._valid_seqs():
            pass
        # an empty newest segment (rotated right after a snapshot, no appends
        # yet) still pins the sequence: its name says records start at
        # first_seq, so the last durable seq is at least first_seq - 1
        self.last_seq = max(self.last_seq, segs[-1][0] - 1)
        last_path = segs[-1][1]
        if self._walked is not None and self._walked[0] == last_path:
            _, valid_end, clean = self._walked
        else:
            _, valid_end, clean = _read_frames(last_path)
        if not clean:
            with open(last_path, "r+b") as f:
                f.truncate(valid_end)
            fsync_file(last_path)
        self._f = open(last_path, "ab")
        self._unsynced = 0

    def _open_segment(self, first_seq: int) -> None:
        crash_point("wal.pre_rotate")
        if self._f is not None:
            self._sync()
            self._f.close()
        path = os.path.join(self.directory, f"wal_{first_seq:016d}.log")
        self._f = open(path, "ab")
        fsync_dir(self.directory)       # the new segment's name is durable
        self._unsynced = 0

    def append(self, op: str, meta: dict, arrays: Dict[str, object]) -> int:
        """Appends one record; returns its seq. Durable at return whenever
        the fsync batch flushed (always, at sync_every=1)."""
        with obs.span("wal.append"):
            if self._f is None:
                self.open_for_append()
            parts = _payload_parts(op, meta, arrays)
            crc = 0
            for p in parts:
                crc = zlib.crc32(p, crc)
            seq = self.last_seq + 1
            crash_point("wal.pre_append")
            plen = sum(memoryview(p).nbytes for p in parts)
            self._f.write(_FRAME.pack(MAGIC, seq, plen, crc))
            for p in parts:
                self._f.write(p)
            self.last_seq = seq
            self._unsynced += 1
            if self._unsynced >= self.sync_every:
                self._sync()
            crash_point("wal.post_append")
            return seq

    def _sync(self) -> None:
        if self._f is not None and self._unsynced:
            # group-commit accounting: how many appends each fsync covers
            obs.histogram("wal.sync_batch",
                          obs.COUNT_BUCKETS).observe(self._unsynced)
            with obs.span("wal.fsync"):
                self._f.flush()
                os.fsync(self._f.fileno())
            self._unsynced = 0

    def sync(self) -> None:
        self._sync()

    # -------------------------------------------------- snapshot coordination
    def rotate(self, next_seq: Optional[int] = None) -> None:
        """Starts a fresh segment (after a snapshot): future records land in
        ``wal_<next_seq>.log`` so fully-superseded segments become unlinkable
        units."""
        self._open_segment(self.last_seq + 1 if next_seq is None else next_seq)

    def gc(self, floor_seq: int) -> int:
        """Unlinks segments whose records are *all* ≤ ``floor_seq`` (the
        oldest retained snapshot's last applied seq). A segment qualifies
        exactly when the next segment starts at or before floor_seq + 1 —
        the newest segment never qualifies. Returns segments removed."""
        segs = self.segments()
        removed = 0
        crash_point("wal.pre_gc")
        for (first, path), (nxt_first, _) in zip(segs, segs[1:]):
            if nxt_first <= floor_seq + 1:
                os.unlink(path)
                removed += 1
        if removed:
            fsync_dir(self.directory)
        crash_point("wal.post_gc")
        return removed

    def close(self) -> None:
        if self._f is not None:
            self._sync()
            self._f.close()
            self._f = None
