"""Guest filesystem emulation: fake file I/O syscalls without a disk.

Reference design (src/wtf/fshooks.cc:115-929, guestfile.h:22-106,
fshandle_table.{h,cc}, handle_table.h:56-141, restorable.h): breakpoints
on the Nt* file syscalls parse guest arguments (OBJECT_ATTRIBUTES /
UNICODE_STRING), consult a table of host-backed GuestFile streams keyed
by filename, hand out fake handles counting down from 0x7ffffffe, fake
the whole syscall with SimulateReturnFromFunction, and roll every bit of
it back per testcase via the Restorable save/restore pair — so file
content mutations, cursors, and open handles are deterministic across
runs.

Batch semantics (a delta from the single-VM reference): every LANE is an
independent guest, so file content, cursors, and handle tables are kept
per lane (`backend.current_lane`), cloned lazily from the init-time
template and discarded wholesale on restore().

Hooked symbols (registered when present in the snapshot's symbol store,
like the reference's Windows-image hooks):
  ntdll!NtCreateFile, nt!NtOpenFile  -> open known files / not-found
  ntdll!NtReadFile                   -> stream read + IO_STATUS_BLOCK
  ntdll!NtWriteFile                  -> stream write + IO_STATUS_BLOCK
  ntdll!NtClose                      -> release the fake handle
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from wtf_tpu_torch.core import nt

SYM_NTCREATEFILE = "ntdll!NtCreateFile"
SYM_NTOPENFILE = "nt!NtOpenFile"
SYM_NTREADFILE = "ntdll!NtReadFile"
SYM_NTWRITEFILE = "ntdll!NtWriteFile"
SYM_NTCLOSE = "ntdll!NtClose"

# Fake handles count DOWN from here; the range below 0x7ffffffe avoids
# colliding with the pseudo-handles (-1/-2/...) and any real low handles
# the snapshot may hold (reference handle_table.h:56-141).
HANDLE_BASE = 0x7FFF_FFFE

# A guest write can place the file pointer anywhere; bound host memory.
MAX_FILE_SIZE = 16 * 1024 * 1024

# LARGE_INTEGER ByteOffset sentinels (wdm.h semantics)
_OFFSET_USE_CURSOR = 0xFFFF_FFFF_FFFF_FFFE   # FILE_USE_FILE_POINTER_POSITION
_OFFSET_APPEND = 0xFFFF_FFFF_FFFF_FFFF       # FILE_WRITE_TO_END_OF_FILE


def _leaf(name: str) -> str:
    return name.replace("/", "\\").rsplit("\\", 1)[-1]


class Restorable:
    """save() at harness-init time; restore() per testcase
    (reference restorable.h:4-7)."""

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError


class GuestFile(Restorable):
    """One host-backed guest file stream (guestfile.h:22-106): content +
    cursor + existence, snapshot/rollback semantics."""

    def __init__(self, name: str, data: bytes = b"", exists: bool = True):
        self.name = name
        self.data = bytearray(data)
        self.cursor = 0
        self.exists = exists
        self.delete_on_close = False
        self._saved = None

    def clone(self) -> "GuestFile":
        c = GuestFile(self.name, bytes(self.data), self.exists)
        c.cursor = self.cursor
        c.delete_on_close = self.delete_on_close
        return c

    def save(self) -> None:
        self._saved = (bytes(self.data), self.cursor, self.exists,
                       self.delete_on_close)

    def restore(self) -> None:
        if self._saved is not None:
            data, cursor, exists, doc = self._saved
            self.data = bytearray(data)
            self.cursor = cursor
            self.exists = exists
            self.delete_on_close = doc

    def read(self, size: int, offset: Optional[int] = None) -> bytes:
        pos = self.cursor if offset is None else offset
        out = bytes(self.data[pos:pos + size])
        self.cursor = pos + len(out)
        return out

    def write(self, data: bytes, offset: Optional[int] = None) -> int:
        pos = self.cursor if offset is None else offset
        end = pos + len(data)
        if end > MAX_FILE_SIZE:
            raise ValueError("write beyond MAX_FILE_SIZE")
        if end > len(self.data):
            self.data.extend(b"\x00" * (end - len(self.data)))
        self.data[pos:end] = data
        self.cursor = end
        return len(data)


class HandleTable(Restorable):
    """handle -> GuestFile map with fake-handle allocation
    (handle_table.h:56-141)."""

    def __init__(self):
        self._next = HANDLE_BASE
        self._handles: Dict[int, GuestFile] = {}
        self._saved = None

    def allocate(self, obj: GuestFile) -> int:
        handle = self._next
        self._next -= 2  # stay even-ish like real handles
        self._handles[handle] = obj
        return handle

    def get(self, handle: int) -> Optional[GuestFile]:
        return self._handles.get(handle)

    def close(self, handle: int) -> bool:
        return self._handles.pop(handle, None) is not None

    def save(self) -> None:
        self._saved = (self._next, dict(self._handles))

    def restore(self) -> None:
        if self._saved is not None:
            self._next, handles = self._saved
            self._handles = dict(handles)


class FsHandleTable(Restorable):
    """filename -> GuestFile registry + unknown-file policy
    (fshandle_table.h:70-113).  Filenames are matched on the final path
    component as well, so guests opening '\\??\\C:\\x\\in.txt' find a file
    mapped as 'in.txt'; the blacklist applies with the same leaf-name
    rule so path variants cannot bypass it."""

    def __init__(self):
        self.files: Dict[str, GuestFile] = {}
        self.blacklist: set = set()
        # policy for files never mapped: called with the name, returns a
        # GuestFile or None (=> STATUS_OBJECT_NAME_NOT_FOUND)
        self.unknown_file_handler: Optional[
            Callable[[str], Optional[GuestFile]]] = None

    def map_existing_guest_file(self, name: str,
                                data: bytes = b"") -> GuestFile:
        f = GuestFile(name, data, exists=True)
        self.files[name] = f
        return f

    def map_nonexisting_guest_file(self, name: str) -> GuestFile:
        f = GuestFile(name, exists=False)
        self.files[name] = f
        return f

    def blacklist_file(self, name: str) -> None:
        self.blacklist.add(name)

    def _is_blacklisted(self, name: str) -> bool:
        if name in self.blacklist:
            return True
        leaf = _leaf(name)
        return any(_leaf(b) == leaf for b in self.blacklist)

    def lookup(self, name: str) -> Optional[GuestFile]:
        if self._is_blacklisted(name):
            return None
        f = self.files.get(name)
        if f is not None:
            return f
        leaf = _leaf(name)
        for key, f in self.files.items():
            if _leaf(key) == leaf:
                return f
        if self.unknown_file_handler is not None:
            return self.unknown_file_handler(name)
        return None

    def clone(self) -> "FsHandleTable":
        c = FsHandleTable()
        c.files = {k: f.clone() for k, f in self.files.items()}
        c.blacklist = self.blacklist        # policy: shared, not state
        c.unknown_file_handler = self.unknown_file_handler
        return c

    def save(self) -> None:
        for f in self.files.values():
            f.save()

    def restore(self) -> None:
        for f in self.files.values():
            f.restore()


class GuestFs:
    """The hook set + its restorable per-lane state; one per target.

    `fs` is the init-time TEMPLATE: targets map files into it once.  Each
    lane gets a lazy clone (files + fresh handle table) the first time it
    is touched; restore() drops all lane clones, so every testcase starts
    from the template — the Restorable contract batched."""

    def __init__(self):
        self.fs = FsHandleTable()
        self.stats = {"opens": 0, "reads": 0, "writes": 0, "closes": 0,
                      "not_found": 0, "faults": 0}
        self._lanes: Dict[int, Tuple[FsHandleTable, HandleTable]] = {}

    # -- per-lane state ----------------------------------------------------
    def lane_state(self, lane: int) -> Tuple[FsHandleTable, HandleTable]:
        state = self._lanes.get(lane)
        if state is None:
            state = (self.fs.clone(), HandleTable())
            self._lanes[lane] = state
        return state

    def lane_file(self, backend, name: str) -> GuestFile:
        """The named file as `backend`'s current lane sees it (targets use
        this in insert_testcase to plant per-lane file content)."""
        fs, _ = self.lane_state(backend.current_lane)
        return fs.files[name]

    # -- Restorable plumbing (call from target init/restore) --------------
    def save(self) -> None:
        self.fs.save()

    def restore(self) -> None:
        self.fs.restore()
        self._lanes.clear()

    # -- hook installation -------------------------------------------------
    def install(self, backend) -> None:
        hooks = {
            SYM_NTCREATEFILE: self._on_create_file,
            SYM_NTOPENFILE: self._on_create_file,  # same arg shape
            SYM_NTREADFILE: self._on_read_file,
            SYM_NTWRITEFILE: self._on_write_file,
            SYM_NTCLOSE: self._on_close,
        }
        for name, handler in hooks.items():
            backend.set_breakpoint_if_symbol(name, self._guard(handler))

    def _guard(self, handler):
        """guard_guest_faults (base.py) semantics plus a stats counter: a
        guest-controlled bad pointer in a syscall argument fails the
        TESTCASE, not the campaign."""
        from wtf_tpu_torch.cpu.emu import MemFault
        from wtf_tpu_torch.interp.runner import HostFault

        def with_stats(b):
            try:
                handler(b)
            except (MemFault, HostFault) as e:
                self.stats["faults"] += 1
                kind = "write" if getattr(e, "write", False) else "read"
                b.save_crash(getattr(e, "gva", 0), kind)
        return with_stats

    # -- syscall fakes (fshooks.cc:115-929) --------------------------------
    def _object_name(self, b, objattr_ptr: int) -> str:
        raw = b.virt_read(objattr_ptr, nt.ObjectAttributes.SIZE)
        attrs = nt.ObjectAttributes.parse(raw)
        if attrs.object_name_ptr == 0:
            return ""
        return nt.read_unicode_string(b.virt_read, attrs.object_name_ptr)

    def _on_create_file(self, b) -> None:
        """NtCreateFile(FileHandle*, DesiredAccess, ObjectAttributes*,
        IoStatusBlock*, ...) — open a known file or fail not-found."""
        fs, handles = self.lane_state(b.current_lane)
        handle_ptr = b.get_arg(0)
        objattr_ptr = b.get_arg(2)
        iosb_ptr = b.get_arg(3)
        name = self._object_name(b, objattr_ptr)
        f = fs.lookup(name)
        if f is None or not f.exists:
            self.stats["not_found"] += 1
            b.simulate_return_from_function(nt.STATUS_OBJECT_NAME_NOT_FOUND)
            return
        self.stats["opens"] += 1
        handle = handles.allocate(f)
        b.virt_write_u64(handle_ptr, handle)
        if iosb_ptr:
            b.virt_write(iosb_ptr, nt.IoStatusBlock(
                status=nt.STATUS_SUCCESS, information=1).pack())  # FILE_OPENED
        b.simulate_return_from_function(nt.STATUS_SUCCESS)

    def _read_write_args(self, b):
        """NtReadFile/NtWriteFile(Handle, Event, ApcRoutine, ApcContext,
        IoStatusBlock*, Buffer, Length, ByteOffset*, Key)."""
        handle = b.get_arg(0)
        iosb_ptr = b.get_arg(4)
        buffer = b.get_arg(5)
        length = b.get_arg(6)
        offset_ptr = b.get_arg(7)
        offset = None
        if offset_ptr:
            off = b.virt_read_u64(offset_ptr)
            if off == _OFFSET_APPEND:
                offset = -1          # resolved against the file below
            elif off != _OFFSET_USE_CURSOR:
                offset = off
        return handle, iosb_ptr, buffer, length, offset

    def _on_read_file(self, b) -> None:
        fs, handles = self.lane_state(b.current_lane)
        handle, iosb_ptr, buffer, length, offset = self._read_write_args(b)
        f = handles.get(handle)
        if f is None:
            b.simulate_return_from_function(nt.STATUS_INVALID_HANDLE)
            return
        if offset is not None and (offset < 0 or offset > MAX_FILE_SIZE):
            b.simulate_return_from_function(nt.STATUS_INVALID_PARAMETER)
            return
        data = f.read(length, offset)
        # a zero-length read at a valid position is SUCCESS (Information=0)
        # on real NT; END_OF_FILE only when bytes were wanted and none left
        status = (nt.STATUS_SUCCESS if data or length == 0
                  else nt.STATUS_END_OF_FILE)
        if data:
            b.virt_write(buffer, data)
        if iosb_ptr:
            b.virt_write(iosb_ptr, nt.IoStatusBlock(
                status=status, information=len(data)).pack())
        self.stats["reads"] += 1
        b.simulate_return_from_function(status)

    def _on_write_file(self, b) -> None:
        fs, handles = self.lane_state(b.current_lane)
        handle, iosb_ptr, buffer, length, offset = self._read_write_args(b)
        f = handles.get(handle)
        if f is None:
            b.simulate_return_from_function(nt.STATUS_INVALID_HANDLE)
            return
        if offset == -1:
            offset = len(f.data)     # FILE_WRITE_TO_END_OF_FILE
        if (length > MAX_FILE_SIZE
                or (offset is not None
                    and not 0 <= offset <= MAX_FILE_SIZE - length)):
            b.simulate_return_from_function(nt.STATUS_INVALID_PARAMETER)
            return
        try:
            written = f.write(b.virt_read(buffer, length), offset)
        except ValueError:           # cursor-relative write past the cap
            b.simulate_return_from_function(nt.STATUS_INVALID_PARAMETER)
            return
        if iosb_ptr:
            b.virt_write(iosb_ptr, nt.IoStatusBlock(
                status=nt.STATUS_SUCCESS, information=written).pack())
        self.stats["writes"] += 1
        b.simulate_return_from_function(nt.STATUS_SUCCESS)

    def _on_close(self, b) -> None:
        _, handles = self.lane_state(b.current_lane)
        handle = b.get_arg(0)
        ok = handles.close(handle)
        self.stats["closes"] += 1
        b.simulate_return_from_function(
            nt.STATUS_SUCCESS if ok else nt.STATUS_INVALID_HANDLE)
