"""Zero-copy same-host bus lanes — the "shm1" shared-memory ring transport.

The message plane's measured wall is the kernel socket path: busd relays
at ~3.5 µs/msg even on the fast frames (results/bus_scaling_r08.json) and
the profiling plane attributes 58% of a small fleet's wall clock to
``bus_client:recv`` (results/prof_r18.flame.folded) — a write(2), a
wakeup, and a read(2) per frame per peer.  Same-host peers don't need any
of that: this module maps one small file per (client, busd-shard) pair
into both address spaces and moves the EXACT fast-path frames (the
``P<topic> <payload>`` / ``M<topic> <from> <payload>`` lines of the
relay1 framing) through a pair of single-producer
single-consumer rings, so the steady-state cost per frame is a memcpy
plus two relaxed cursor stores.

Layout of a lane file (version "SHL1", all little-endian; the C++ mirror
``cpp/common/shmlane.hpp`` is layout-identical and both sides validate
magic/version/geometry before attaching):

    0    u32 magic        "SHL1" (0x314C4853)
    4    u16 version      1
    6    u16 reserved
    8    u32 slot_size    payload capacity per slot (bytes)
    12   u32 nslots       slots per ring (power of two)
    16   u32 creator_pid  the client that built the file (stale-lane
                          reclaim checks its liveness on reconnect)
    20   u32 attached_pid busd's pid once it mapped the lane (0 = never)
    24   u32 detached     either side stores 1: lane is torn down and
                          every frame goes back to TCP (never a stall)
    64   c2s ring head    u64 (client writes; monotone slot sequence)
    128  c2s ring tail    u64 (busd writes)
    192  c2s parked       u32 (busd is blocked in poll; writer rings the
                          doorbell after clearing it)
    256  s2c ring head    u64 (busd writes)
    320  s2c ring tail    u64 (client writes)
    384  s2c parked       u32
    4096 c2s slots        nslots * stride   stride = 64-byte-rounded
    ...  s2c slots        nslots * stride   (4 + slot_size)

Each slot is ``u32 len`` + payload.  SPSC discipline: the writer fills
the slot at ``head % nslots``, then publishes ``head+1``; the reader
consumes at ``tail % nslots`` and publishes ``tail+1``.  Cursors are
8-byte aligned and each side writes only its own, so plain mapped stores
are safe on every platform the runtime targets (x86-64/aarch64 TSO-ish
ordering; the C++ side uses real atomics).

Doorbell: a reader that finds the ring empty PARKS — it stores 1 to its
``parked`` word, re-checks the ring (the standard lost-wakeup guard), and
blocks in poll/select on a named FIFO next to the lane file.  A writer
that observes ``parked == 1`` clears it and writes one byte to the FIFO.
Under load the reader never parks and the doorbell never fires — the
spin-then-park shape that turns the 58% recv-park into a ring poll.
(An eventfd would be the single-process choice; the doorbell must cross
unrelated processes that only share a filesystem, which is exactly what
a FIFO is.)

Overflow / death contract: a full ring NEVER blocks the
writer — the frame falls back to the TCP link verbatim and
``bus.shm_fallbacks`` counts it.  Only the droppable stream class rides
the lane (position beacons, metrics, path samples — busd's own shed
class), so a rare TCP/ring interleave reorders nothing the consumers
don't already tolerate; the ordered control plane stays on TCP, which
also carries oversized frames and remains the only transport for
cross-host links.  A dead peer (pid gone, or the TCP session it rode on
closed) tears the lane down; a stale lane file left by a dead client is
reclaimed (unlinked and rebuilt) on the next connect.

Kill switch: lanes are offered only when ``JG_BUS_SHM`` is truthy; unset
(the default) keeps the TCP wire byte-identical — pinned by
tests/test_shmlane.py against a raw socket.
"""

from __future__ import annotations

import errno
import mmap
import os
import stat
import struct
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

MAGIC = 0x314C4853  # b"SHL1" little-endian
VERSION = 1
DEFAULT_SLOT_SIZE = 768
DEFAULT_NSLOTS = 256
HEADER_BYTES = 4096

_OFF_MAGIC = 0
_OFF_VERSION = 4
_OFF_SLOT_SIZE = 8
_OFF_NSLOTS = 12
_OFF_CREATOR_PID = 16
_OFF_ATTACHED_PID = 20
_OFF_DETACHED = 24
# per-ring control offsets (cacheline-separated)
_RING_CTRL = ((64, 128, 192), (256, 320, 384))  # (head, tail, parked)

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

SHM_ENV = "JG_BUS_SHM"
SHM_DIR_ENV = "JG_BUS_SHM_DIR"


def shm_enabled() -> bool:
    """Lanes are OPT-IN: offered only when JG_BUS_SHM is a truthy value.
    Unset/0 keeps the TCP wire byte-identical (the pin test's contract)."""
    return os.environ.get(SHM_ENV, "") not in ("", "0", "false")


def lane_dir() -> Path:
    """Where lane files live: JG_BUS_SHM_DIR (the fleet runner points it
    at the run dir) or a per-uid tmp subdir."""
    d = os.environ.get(SHM_DIR_ENV, "")
    if d:
        p = Path(d)
    else:
        p = Path(tempfile.gettempdir()) / f"jg_shm_{os.getuid()}"
    p.mkdir(parents=True, exist_ok=True)
    return p


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _round_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


class _Ring:
    """One SPSC ring over a shared mapping.  The same class serves both
    roles; the owner of each cursor is fixed by the lane direction."""

    def __init__(self, mm: mmap.mmap, ctrl: Tuple[int, int, int],
                 data_off: int, nslots: int, slot_size: int):
        self._mm = mm
        self._head_off, self._tail_off, self._parked_off = ctrl
        self._data_off = data_off
        self._nslots = nslots
        self._slot_size = slot_size
        self._stride = _round_up(4 + slot_size, 64)

    # cursor accessors (8-byte aligned single-word loads/stores)
    def _load(self, off: int) -> int:
        return _U64.unpack_from(self._mm, off)[0]

    def _store(self, off: int, v: int) -> None:
        _U64.pack_into(self._mm, off, v)

    @property
    def head(self) -> int:
        return self._load(self._head_off)

    @property
    def tail(self) -> int:
        return self._load(self._tail_off)

    def empty(self) -> bool:
        return self.tail >= self.head

    def push(self, payload: bytes) -> bool:
        """Write one frame; False when it doesn't fit (ring full or
        oversized payload) — the caller falls back to TCP, never blocks."""
        if len(payload) > self._slot_size:
            return False
        head = self.head
        if head - self.tail >= self._nslots:
            return False
        off = self._data_off + (head % self._nslots) * self._stride
        self._mm[off + 4:off + 4 + len(payload)] = payload
        _U32.pack_into(self._mm, off, len(payload))
        # publish AFTER the slot contents: the reader acquires via head
        self._store(self._head_off, head + 1)
        return True

    def pop(self) -> Optional[bytes]:
        tail = self.tail
        if tail >= self.head:
            return None
        off = self._data_off + (tail % self._nslots) * self._stride
        (n,) = _U32.unpack_from(self._mm, off)
        out = bytes(self._mm[off + 4:off + 4 + n])
        self._store(self._tail_off, tail + 1)
        return out

    # -- spin-then-park doorbell protocol ---------------------------------
    def reader_park(self) -> bool:
        """Announce the reader is about to block.  Returns False when the
        ring became non-empty in the race window (caller must drain
        instead of blocking)."""
        _U32.pack_into(self._mm, self._parked_off, 1)
        if not self.empty():
            _U32.pack_into(self._mm, self._parked_off, 0)
            return False
        return True

    def reader_unpark(self) -> None:
        _U32.pack_into(self._mm, self._parked_off, 0)

    def reader_parked(self) -> bool:
        return _U32.unpack_from(self._mm, self._parked_off)[0] != 0

    def writer_should_ring(self) -> bool:
        """After a push: True once per park — clears the flag so one
        doorbell byte wakes the reader however many frames follow."""
        if _U32.unpack_from(self._mm, self._parked_off)[0]:
            _U32.pack_into(self._mm, self._parked_off, 0)
            return True
        return False


class ShmLane:
    """One mapped lane: a c2s and an s2c ring plus their doorbells.

    ``role`` is "client" (creates the file, writes c2s, reads s2c) or
    "hub" (attaches, reads c2s, writes s2c).
    """

    def __init__(self, path: Path, role: str, mm: mmap.mmap,
                 slot_size: int, nslots: int):
        assert role in ("client", "hub")
        self.path = Path(path)
        self.role = role
        self._mm = mm
        self.slot_size = slot_size
        self.nslots = nslots
        stride = _round_up(4 + slot_size, 64)
        c2s = _Ring(mm, _RING_CTRL[0], HEADER_BYTES, nslots, slot_size)
        s2c = _Ring(mm, _RING_CTRL[1], HEADER_BYTES + nslots * stride,
                    nslots, slot_size)
        self.tx = c2s if role == "client" else s2c
        self.rx = s2c if role == "client" else c2s
        self._bell_rx_fd = -1  # our read side (parked reader wakes here)
        self._bell_tx_fd = -1  # peer's bell (opened lazily on first ring)
        self._open_bell_rx()

    # -- lane file naming -------------------------------------------------
    @staticmethod
    def bell_paths(path: Path) -> Tuple[Path, Path]:
        """(c2s bell, s2c bell) FIFOs next to the lane file."""
        return (Path(str(path) + ".c2s.bell"),
                Path(str(path) + ".s2c.bell"))

    def _bell_rx_path(self) -> Path:
        c2s, s2c = self.bell_paths(self.path)
        return s2c if self.role == "client" else c2s

    def _bell_tx_path(self) -> Path:
        c2s, s2c = self.bell_paths(self.path)
        return c2s if self.role == "client" else s2c

    def _open_bell_rx(self) -> None:
        try:
            self._bell_rx_fd = os.open(self._bell_rx_path(),
                                       os.O_RDONLY | os.O_NONBLOCK)
        except OSError:
            self._bell_rx_fd = -1  # no doorbell: poll-timeout paced

    # -- header fields ----------------------------------------------------
    def _get_u32(self, off: int) -> int:
        return _U32.unpack_from(self._mm, off)[0]

    def _set_u32(self, off: int, v: int) -> None:
        _U32.pack_into(self._mm, off, v)

    @property
    def creator_pid(self) -> int:
        return self._get_u32(_OFF_CREATOR_PID)

    @property
    def attached_pid(self) -> int:
        return self._get_u32(_OFF_ATTACHED_PID)

    @property
    def detached(self) -> bool:
        return self._get_u32(_OFF_DETACHED) != 0

    def mark_attached(self, pid: int) -> None:
        self._set_u32(_OFF_ATTACHED_PID, pid)

    def detach(self) -> None:
        """Tear the lane down: both sides observe ``detached`` and route
        every subsequent frame over TCP."""
        self._set_u32(_OFF_DETACHED, 1)

    def peer_alive(self) -> bool:
        """The OTHER side's pid still exists (hub checks the creator,
        client checks whoever attached; an unattached lane reads alive —
        negotiation may still be in flight)."""
        pid = (self.attached_pid if self.role == "client"
               else self.creator_pid)
        return pid == 0 or _pid_alive(pid)

    # -- frame I/O --------------------------------------------------------
    def send(self, frame: bytes) -> bool:
        """Push one frame (the exact relay line, no trailing newline);
        rings the peer's doorbell if it parked.  False = caller must use
        TCP (full / oversized / torn down)."""
        if self.detached:
            return False
        if not self.tx.push(frame):
            return False
        if self.tx.writer_should_ring():
            self._ring_bell()
        return True

    def recv(self) -> Optional[bytes]:
        return self.rx.pop()

    def rx_pending(self) -> bool:
        return not self.rx.empty()

    def _ring_bell(self) -> None:
        if self._bell_tx_fd < 0:
            try:
                self._bell_tx_fd = os.open(self._bell_tx_path(),
                                           os.O_WRONLY | os.O_NONBLOCK)
            except OSError:
                return  # peer's read side not open yet: it isn't parked
        try:
            os.write(self._bell_tx_fd, b"x")
        except OSError as e:
            if e.errno in (errno.EPIPE, errno.ENXIO):
                try:
                    os.close(self._bell_tx_fd)
                except OSError:
                    pass
                self._bell_tx_fd = -1
            # EAGAIN: bell already full of wakeup bytes — that's a wakeup

    # -- parking (reader side) -------------------------------------------
    def bell_fd(self) -> int:
        """The fd a parked reader selects/polls on (-1 = none)."""
        return self._bell_rx_fd

    def park(self) -> bool:
        """Arm the parked flag; False when frames raced in (drain now)."""
        return self.rx.reader_park()

    def unpark(self) -> None:
        self.rx.reader_unpark()
        if self._bell_rx_fd >= 0:
            try:  # drain accumulated doorbell bytes
                while os.read(self._bell_rx_fd, 4096):
                    pass
            except OSError:
                pass

    def close(self, unlink: bool = False) -> None:
        for fd in (self._bell_rx_fd, self._bell_tx_fd):
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._bell_rx_fd = self._bell_tx_fd = -1
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass
        if unlink:
            for p in (self.path, *self.bell_paths(self.path)):
                try:
                    os.unlink(p)
                except OSError:
                    pass


def _map_bytes(slot_size: int, nslots: int) -> int:
    stride = _round_up(4 + slot_size, 64)
    return HEADER_BYTES + 2 * nslots * stride


def create_lane(path, slot_size: int = DEFAULT_SLOT_SIZE,
                nslots: int = DEFAULT_NSLOTS) -> ShmLane:
    """Client side: build (or rebuild) the lane file + doorbell FIFOs.

    A leftover file whose creator pid is dead is RECLAIMED — unlinked and
    rebuilt — so a SIGKILLed client's next incarnation negotiates a clean
    lane instead of inheriting mid-stream cursors (the stale-ring test).
    A live creator's file is also replaced: lane names are per-peer-id,
    so a same-name rebuild means a reconnect of the same logical client.
    """
    if nslots & (nslots - 1):
        raise ValueError(f"nslots {nslots} not a power of two")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    for p in (path, *ShmLane.bell_paths(path)):
        try:
            os.unlink(p)
        except OSError:
            pass
    for bell in ShmLane.bell_paths(path):
        os.mkfifo(bell, 0o600)
    size = _map_bytes(slot_size, nslots)
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        os.ftruncate(fd, size)
        mm = mmap.mmap(fd, size)
    finally:
        os.close(fd)
    _U32.pack_into(mm, _OFF_MAGIC, MAGIC)
    struct.pack_into("<HH", mm, _OFF_VERSION, VERSION, 0)
    _U32.pack_into(mm, _OFF_SLOT_SIZE, slot_size)
    _U32.pack_into(mm, _OFF_NSLOTS, nslots)
    _U32.pack_into(mm, _OFF_CREATOR_PID, os.getpid())
    return ShmLane(path, "client", mm, slot_size, nslots)


class LaneError(ValueError):
    """Unattachable lane file (bad magic/version/geometry)."""


def attach_lane(path) -> ShmLane:
    """Hub side: map a client-created lane after validating its header.
    Raises :class:`LaneError` on anything that isn't a well-formed,
    current-version lane of sane geometry (the handshake-fuzz contract:
    a malformed offer must never crash or half-attach the hub)."""
    path = Path(path)
    st = os.stat(path)
    if not stat.S_ISREG(st.st_mode):
        raise LaneError(f"lane {path} is not a regular file")
    if st.st_size < HEADER_BYTES:
        raise LaneError(f"lane {path} too short ({st.st_size} B)")
    fd = os.open(path, os.O_RDWR)
    try:
        mm = mmap.mmap(fd, st.st_size)
    finally:
        os.close(fd)
    try:
        (magic,) = _U32.unpack_from(mm, _OFF_MAGIC)
        if magic != MAGIC:
            raise LaneError(f"bad lane magic 0x{magic:08x}")
        (version,) = struct.unpack_from("<H", mm, _OFF_VERSION)
        if version != VERSION:
            raise LaneError(f"unsupported lane version {version}")
        (slot_size,) = _U32.unpack_from(mm, _OFF_SLOT_SIZE)
        (nslots,) = _U32.unpack_from(mm, _OFF_NSLOTS)
        if not (0 < slot_size <= 1 << 20):
            raise LaneError(f"bad slot_size {slot_size}")
        if not (0 < nslots <= 1 << 16) or nslots & (nslots - 1):
            raise LaneError(f"bad nslots {nslots}")
        if st.st_size < _map_bytes(slot_size, nslots):
            raise LaneError(f"lane {path} shorter than its geometry")
    except LaneError:
        mm.close()
        raise
    lane = ShmLane(path, "hub", mm, slot_size, nslots)
    lane.mark_attached(os.getpid())
    return lane


def reclaim_stale(dir_path: Optional[Path] = None) -> List[Path]:
    """Sweep ``dir_path`` (default: the lane dir) for lane files whose
    creator is dead and unlink them (plus their bells).  Returns the
    reclaimed paths — buspool calls this at spawn so a crashed fleet's
    litter never accumulates."""
    d = Path(dir_path) if dir_path is not None else lane_dir()
    reclaimed: List[Path] = []
    if not d.is_dir():
        return reclaimed
    for p in sorted(d.glob("*.shl")):
        try:
            with open(p, "rb") as f:
                head = f.read(HEADER_BYTES)
            if len(head) < 24:
                continue
            (magic,) = _U32.unpack_from(head, _OFF_MAGIC)
            if magic != MAGIC:
                continue
            (pid,) = _U32.unpack_from(head, _OFF_CREATOR_PID)
            if _pid_alive(pid):
                continue
        except OSError:
            continue
        for q in (p, *ShmLane.bell_paths(p)):
            try:
                os.unlink(q)
            except OSError:
                pass
        reclaimed.append(p)
    return reclaimed


def lane_path_for(peer_id: str, shard: int,
                  dir_path: Optional[Path] = None) -> Path:
    """Canonical lane file path for a (peer, busd-shard) pair.  Peer ids
    are sanitized to a filename-safe alphabet (they're alnum in practice:
    "py-…", "12D3KooW…")."""
    safe = "".join(c if c.isalnum() or c in "-_." else "_"
                   for c in peer_id)[:80]
    d = Path(dir_path) if dir_path is not None else lane_dir()
    return d / f"{safe}-s{shard}.shl"
