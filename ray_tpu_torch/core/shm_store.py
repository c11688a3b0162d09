"""SharedMemoryStore: the Python client of a node's shared-memory arena.

Port of ray_tpu/core/shm_store.py over the same native store
(``src/objstore/objstore.cc``, built by ``_native.build.load_host_library``
with g++ at first use). The node daemon creates one arena per node;
every process on the node (the driver, each worker) attaches to it by
name, so an object written once is read by any of them without another
copy through a socket. ``put_parts`` scatters buffers straight into the
arena (its pages faulted in with one ``madvise`` first); ``get`` returns
a zero-copy view that pins the object until ``release``. When the arena is full, ``put`` spills least-recently-used
objects to files under the config's ``temp_dir`` and ``get`` restores
them. Out: the cut-through progress watermark and ``abort`` (the native
transfer plane's, ROADMAP Queue A item 7(b)).
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import threading

from ray_tpu_torch._native.build import load_host_library

_ID_SIZE = 20
# madvise(2)'s MADV_POPULATE_WRITE (Linux 5.14): fault an entry's pages in
# with one call before the copy instead of one trap a page.
_MADV_POPULATE_WRITE = 23

OK = 0
ERR_EXISTS = -1
ERR_NOT_FOUND = -2
ERR_OOM = -3
ERR_NOT_SEALED = -4
ERR_BUSY = -5


class ShmStoreError(RuntimeError):
    pass


def _lib():
    lib = load_host_library("objstore", ["objstore/objstore.cc"])
    if not hasattr(lib.store_create, "_configured"):
        P = ctypes.c_void_p
        u64 = ctypes.c_uint64
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.store_create.restype = P
        lib.store_create.argtypes = [ctypes.c_char_p, u64, u64]
        lib.store_open.restype = P
        lib.store_open.argtypes = [ctypes.c_char_p]
        lib.store_close.argtypes = [P]
        lib.store_destroy.argtypes = [ctypes.c_char_p]
        lib.store_create_object.restype = ctypes.c_int
        lib.store_create_object.argtypes = [P, u8p, u64, ctypes.POINTER(u64)]
        lib.store_seal.restype = ctypes.c_int
        lib.store_seal.argtypes = [P, u8p]
        lib.store_get.restype = ctypes.c_int
        lib.store_get.argtypes = [P, u8p, ctypes.POINTER(u64),
                                  ctypes.POINTER(u64)]
        lib.store_release.restype = ctypes.c_int
        lib.store_release.argtypes = [P, u8p]
        lib.store_contains.restype = ctypes.c_int
        lib.store_contains.argtypes = [P, u8p]
        lib.store_delete.restype = ctypes.c_int
        lib.store_delete.argtypes = [P, u8p]
        lib.store_evict_candidates.restype = ctypes.c_int
        lib.store_evict_candidates.argtypes = [P, u64, u8p, ctypes.c_int]
        lib.store_stats.argtypes = [P, ctypes.POINTER(u64), ctypes.POINTER(u64),
                                    ctypes.POINTER(u64)]
        lib.store_create._configured = True
    return lib


def _hashed(object_id: bytes) -> bytes:
    object_id = bytes(object_id)
    if len(object_id) != _ID_SIZE:
        return hashlib.sha1(object_id).digest()
    return object_id


def _id_buf(object_id: bytes):
    return (ctypes.c_uint8 * _ID_SIZE).from_buffer_copy(_hashed(object_id))


class SharedMemoryStore:
    """One per node (created by the node daemon); other processes attach
    with ``create=False``."""

    def __init__(self, name: str, capacity_bytes: int = 1 << 28,
                 create: bool = True, spill_dir: str | None = None,
                 num_slots: int = 4096):
        self._libh = _lib()
        self.name = name if name.startswith("/") else f"/{name}"
        if create:
            self._h = self._libh.store_create(self.name.encode(),
                                              capacity_bytes, num_slots)
        else:
            self._h = self._libh.store_open(self.name.encode())
        if not self._h:
            raise ShmStoreError(
                f"could not {'create' if create else 'open'} shm store "
                f"{self.name!r}")
        self._created = create
        fd = os.open(f"/dev/shm{self.name}", os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        if spill_dir is None:
            from ray_tpu_torch.utils.config import get_config

            spill_dir = os.path.join(get_config().temp_dir,
                                     "shm_spill" + self.name)
        self._spill_dir = spill_dir
        self._spilled: dict[bytes, str] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- object API --

    def _alloc(self, object_id: bytes, size: int) -> int | None:
        """Allocate an unsealed entry, spilling LRU objects on OOM. Returns
        the arena offset, or None when the object already exists."""
        idb = _id_buf(object_id)
        off = ctypes.c_uint64()
        for _ in range(3):
            rc = self._libh.store_create_object(self._h, idb, size,
                                                ctypes.byref(off))
            if rc == OK:
                return off.value
            if rc == ERR_EXISTS:
                return None
            if rc == ERR_OOM:
                if not self._spill(size):
                    raise ShmStoreError(
                        f"object of {size} bytes does not fit "
                        f"(capacity {self.stats()['capacity']})")
                continue
            raise ShmStoreError(f"create failed rc={rc}")
        raise ShmStoreError(f"object of {size} bytes does not fit")

    def put(self, object_id: bytes, data) -> None:
        self.put_parts(object_id, [data])

    def put_parts(self, object_id: bytes, parts) -> None:
        """Allocate once and copy each buffer straight into the arena,
        then seal. Idempotent: an object already there is left alone."""
        parts = [memoryview(p).cast("B") for p in parts]
        size = sum(len(p) for p in parts)
        pos = self._alloc(object_id, size)
        if pos is None:
            return
        if size:
            start = pos - pos % mmap.PAGESIZE
            try:
                self._mm.madvise(_MADV_POPULATE_WRITE, start,
                                 pos + size - start)
            except (OSError, ValueError):
                pass  # an older kernel: the copy faults the pages in
        for p in parts:
            self._mm[pos:pos + len(p)] = p
            pos += len(p)
        self._libh.store_seal(self._h, _id_buf(object_id))

    def get(self, object_id: bytes) -> memoryview:
        """Zero-copy view; call release(object_id) when done. KeyError
        when the object is not here (or not sealed yet)."""
        idb = _id_buf(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._libh.store_get(self._h, idb, ctypes.byref(off),
                                  ctypes.byref(size))
        if rc == ERR_NOT_FOUND and self._restore(object_id):
            rc = self._libh.store_get(self._h, idb, ctypes.byref(off),
                                      ctypes.byref(size))
        if rc in (ERR_NOT_FOUND, ERR_NOT_SEALED):
            raise KeyError(object_id)
        if rc != OK:
            raise ShmStoreError(f"get failed rc={rc}")
        return memoryview(self._mm)[off.value:off.value + size.value]

    def get_bytes(self, object_id: bytes) -> bytes:
        view = self.get(object_id)
        try:
            return bytes(view)
        finally:
            view.release()
            self.release(object_id)

    def release(self, object_id: bytes) -> None:
        self._libh.store_release(self._h, _id_buf(object_id))

    def contains(self, object_id: bytes) -> bool:
        if self._libh.store_contains(self._h, _id_buf(object_id)):
            return True
        with self._lock:
            return _hashed(object_id) in self._spilled

    def delete(self, object_id: bytes) -> None:
        rc = self._libh.store_delete(self._h, _id_buf(object_id))
        if rc == ERR_BUSY:
            raise ShmStoreError("object is pinned (refcount > 0)")
        with self._lock:
            path = self._spilled.pop(_hashed(object_id), None)
        if path and os.path.exists(path):
            os.unlink(path)

    def stats(self) -> dict:
        cap = ctypes.c_uint64()
        used = ctypes.c_uint64()
        n = ctypes.c_uint64()
        self._libh.store_stats(self._h, ctypes.byref(cap), ctypes.byref(used),
                               ctypes.byref(n))
        return {"capacity": cap.value, "used": used.value,
                "num_objects": n.value,
                "num_spilled": len(self._spilled)}

    # -- spill/restore --

    def _spill(self, bytes_needed: int) -> bool:
        max_out = 64
        buf = (ctypes.c_uint8 * (_ID_SIZE * max_out))()
        n = self._libh.store_evict_candidates(
            self._h, max(bytes_needed, 1), buf, max_out)
        if n <= 0:
            return False
        os.makedirs(self._spill_dir, exist_ok=True)
        for i in range(n):
            oid = bytes(buf[i * _ID_SIZE:(i + 1) * _ID_SIZE])
            idb = _id_buf(oid)
            off = ctypes.c_uint64()
            size = ctypes.c_uint64()
            if self._libh.store_get(self._h, idb, ctypes.byref(off),
                                    ctypes.byref(size)) != OK:
                continue
            path = os.path.join(self._spill_dir, oid.hex())
            try:
                with open(path, "wb") as f:
                    f.write(self._mm[off.value:off.value + size.value])
            finally:
                self._libh.store_release(self._h, idb)
            if self._libh.store_delete(self._h, idb) == OK:
                with self._lock:
                    self._spilled[oid] = path
            else:
                os.unlink(path)
        return True

    def _restore(self, object_id: bytes) -> bool:
        oid = _hashed(object_id)
        with self._lock:
            path = self._spilled.get(oid)
        if path is None or not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            data = f.read()
        self.put(object_id, data)
        with self._lock:
            self._spilled.pop(oid, None)
        os.unlink(path)
        return True

    # -- lifecycle --

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._mm.close()
        except BufferError:
            pass  # a view is still exported; the mapping goes with the process
        self._libh.store_close(self._h)

    def destroy(self) -> None:
        self.close()
        self._libh.store_destroy(self.name.encode())
