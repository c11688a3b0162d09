"""The cluster's RPC layer: framing, server, clients and the io loop.

Port of ray_tpu/core/cluster/protocol.py. A frame is an 8-byte length and
a pickle (stdlib, protocol 5) of one message tuple:

- ``("q", id, method, kwargs)``: a request; the peer answers it with
- ``("r", id, ok, value)``: the handler's return value, or the exception
  it raised (``ok`` False; one that does not pickle becomes a
  ``RuntimeError`` carrying its repr);
- ``("n", method, kwargs)``: a one-way note, either way (a server pushes
  a streaming task's items to its caller this way).

``RpcServer`` dispatches a request ``m`` to its handler object's
``_handle_m(conn, **kwargs)`` (a coroutine function or a plain one), each
request as its own task, so a slow handler holds no other request of its
connection. ``AsyncRpcClient`` is the loop-side client, ``RpcClient`` its
blocking twin for other threads, and ``EventLoopThread`` the process's
one io loop thread. Out: the chaos hooks, the RPC counters, the
partition rules and the zero-copy buffer framing.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import itertools
import pickle
import struct
import threading
from typing import Any, Callable

_LEN = struct.Struct("<Q")


def _dumps(msg) -> bytes:
    return pickle.dumps(msg, protocol=5)


async def _read_frame(reader: asyncio.StreamReader):
    head = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(head)
    return pickle.loads(await reader.readexactly(n))


def _write_frame(writer: asyncio.StreamWriter, msg) -> None:
    data = _dumps(msg)
    writer.write(_LEN.pack(len(data)))
    writer.write(data)


def _error_value(e: BaseException) -> BaseException:
    try:
        pickle.dumps(e)
        return e
    except Exception:  # noqa: BLE001 - an unpicklable error travels as text
        return RuntimeError(f"{type(e).__name__}: {e}")


_live_tasks: set = set()


def spawn(coro) -> asyncio.Task:
    """``asyncio.ensure_future`` that keeps the task referenced until it
    is done (the loop itself holds tasks only weakly)."""
    t = asyncio.ensure_future(coro)
    _live_tasks.add(t)
    t.add_done_callback(_live_tasks.discard)
    return t


class EventLoopThread:
    """One asyncio loop on a daemon thread per process."""

    _instance: "EventLoopThread | None" = None
    _lock = threading.Lock()

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._main, daemon=True,
                                        name="rtpu-io")
        self._thread.start()

    def _main(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    @classmethod
    def get(cls) -> "EventLoopThread":
        with cls._lock:
            if cls._instance is None:
                cls._instance = EventLoopThread()
            return cls._instance

    def in_loop(self) -> bool:
        try:
            return asyncio.get_running_loop() is self.loop
        except RuntimeError:
            return False

    def submit(self, coro) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def run(self, coro, timeout: float | None = None):
        """Run ``coro`` on the loop and wait for it (not from the loop)."""
        if self.in_loop():
            raise RuntimeError("EventLoopThread.run called on its own loop")
        return self.submit(coro).result(timeout)

    def call_soon(self, fn: Callable, *args) -> None:
        self.loop.call_soon_threadsafe(fn, *args)


class ServerConnection:
    """One accepted connection: the server side can push notes on it."""

    def __init__(self, server: "RpcServer", reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.peer = writer.get_extra_info("peername")
        self.closed = False
        self.on_close: list[Callable[["ServerConnection"], Any]] = []
        self.state: dict = {}  # the handler object's per-connection state

    def notify(self, _method: str, **kwargs) -> None:
        """Push a note to the client; callable from any thread."""
        msg = ("n", _method, kwargs)
        io = EventLoopThread.get()
        if io.in_loop():
            self._send(msg)
        else:
            io.call_soon(self._send, msg)

    def _send(self, msg) -> None:
        if not self.closed:
            _write_frame(self.writer, msg)

    def close(self) -> None:
        if not self.closed:
            self.writer.close()


class RpcServer:
    def __init__(self, handler: Any, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: asyncio.base_events.Server | None = None
        self.connections: set[ServerConnection] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port, limit=1 << 20)
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> tuple[str, int]:
        return self.host, self.port

    async def _serve(self, reader, writer) -> None:
        conn = ServerConnection(self, reader, writer)
        self.connections.add(conn)
        try:
            while True:
                msg = await _read_frame(reader)
                kind = msg[0]
                if kind == "q":
                    spawn(self._dispatch(conn, msg))
                elif kind == "n":
                    await self._note(conn, msg[1], msg[2])
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            conn.closed = True
            self.connections.discard(conn)
            for cb in conn.on_close:
                try:
                    r = cb(conn)
                    if inspect.isawaitable(r):
                        await r
                except Exception:  # noqa: BLE001 - one callback's fault
                    pass
            try:
                writer.close()
            except Exception:  # noqa: BLE001 - already gone
                pass

    async def _call(self, conn, method: str, kwargs: dict):
        fn = getattr(self.handler, f"_handle_{method}", None)
        if fn is None:
            raise AttributeError(f"no RPC method {method!r}")
        r = fn(conn, **kwargs)
        if inspect.isawaitable(r):
            r = await r
        return r

    async def _dispatch(self, conn, msg) -> None:
        _, mid, method, kwargs = msg
        try:
            reply = ("r", mid, True, await self._call(conn, method, kwargs))
        except BaseException as e:  # noqa: BLE001 - sent to the caller
            if isinstance(e, asyncio.CancelledError):
                raise
            reply = ("r", mid, False, _error_value(e))
        if not conn.closed:
            try:
                _write_frame(conn.writer, reply)
            except Exception as e:  # noqa: BLE001 - a reply that does not pickle
                _write_frame(conn.writer, ("r", mid, False, _error_value(e)))

    async def _note(self, conn, method: str, kwargs: dict) -> None:
        try:
            await self._call(conn, method, kwargs)
        except Exception:  # noqa: BLE001 - a note has nobody to answer
            pass

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for conn in list(self.connections):
            conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except (asyncio.TimeoutError, Exception):  # noqa: BLE001
                pass


class AsyncRpcClient:
    """A client connection used from the io loop. ``on_note(method,
    kwargs)`` receives the server's notes; ``on_close()`` runs once the
    connection is gone (every pending call then raises ConnectionError)."""

    def __init__(self, host: str, port: int, on_note: Callable | None = None,
                 on_close: Callable | None = None):
        self.host, self.port = host, int(port)
        self.on_note = on_note
        self.on_close = on_close
        self._ids = itertools.count()
        self._pending: dict[int, asyncio.Future] = {}
        self._writer = None
        self._reader_task = None
        self.closed = False

    async def connect(self) -> "AsyncRpcClient":
        reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=1 << 20)
        self._reader_task = spawn(self._read(reader))
        return self

    async def _read(self, reader) -> None:
        try:
            while True:
                msg = await _read_frame(reader)
                if msg[0] == "r":
                    fut = self._pending.pop(msg[1], None)
                    if fut is not None and not fut.done():
                        if msg[2]:
                            fut.set_result(msg[3])
                        else:
                            fut.set_exception(msg[3])
                elif msg[0] == "n" and self.on_note is not None:
                    r = self.on_note(msg[1], msg[2])
                    if inspect.isawaitable(r):
                        await r
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                asyncio.CancelledError):
            pass
        finally:
            self._lost()

    def _lost(self) -> None:
        if self.closed:
            return
        self.closed = True
        err = ConnectionError(f"connection to {self.host}:{self.port} lost")
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - already gone
            pass
        if self.on_close is not None:
            self.on_close()

    async def call(self, _method: str, _timeout: float | None = None,
                   **kwargs):
        if self.closed:
            raise ConnectionError(f"connection to {self.host}:{self.port} "
                                  "is closed")
        mid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        _write_frame(self._writer, ("q", mid, _method, kwargs))
        if _timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(fut, _timeout)
        finally:
            self._pending.pop(mid, None)

    def send(self, _method: str, **kwargs) -> asyncio.Future:
        """Write a request now (frames leave in the order of ``send``
        calls) and return the future of its reply."""
        fut = asyncio.get_running_loop().create_future()
        if self.closed:
            fut.set_exception(ConnectionError(
                f"connection to {self.host}:{self.port} is closed"))
            return fut
        mid = next(self._ids)
        self._pending[mid] = fut
        _write_frame(self._writer, ("q", mid, _method, kwargs))
        return fut

    def notify(self, _method: str, **kwargs) -> None:
        if not self.closed:
            _write_frame(self._writer, ("n", _method, kwargs))

    async def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
        self._lost()


class RpcClient:
    """Blocking client for threads other than the io loop's."""

    def __init__(self, host: str, port: int, on_note: Callable | None = None,
                 on_close: Callable | None = None):
        self.io = EventLoopThread.get()
        self.addr = (host, int(port))
        self._client = self.io.run(
            AsyncRpcClient(host, port, on_note, on_close).connect(), 30)

    @property
    def closed(self) -> bool:
        return self._client.closed

    @property
    def aclient(self) -> AsyncRpcClient:
        return self._client

    def call(self, _method: str, _timeout: float | None = None, **kwargs):
        return self.io.run(self._client.call(_method, _timeout, **kwargs))

    def notify(self, _method: str, **kwargs) -> None:
        self.io.call_soon(lambda: self._client.notify(_method, **kwargs))

    def close(self) -> None:
        try:
            self.io.run(self._client.close(), 5)
        except Exception:  # noqa: BLE001 - the loop or peer is gone
            pass
