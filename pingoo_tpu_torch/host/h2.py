"""HTTP/2 via a ctypes binding to the system libnghttp2.

The reference serves h1+h2 through hyper's auto builder
(pingoo/listeners/http_listener.rs:276-278) and proxies upstream over
h1/h2 (services/http_proxy_service.rs:54-71). The port needs no
Python h2/hpack package: it binds the system's libnghttp2.so.14 (the
reference C HTTP/2 implementation), declares the small ABI surface
needed and wraps it in two sans-io session objects:

  H2ServerSession — feed()/pull() byte pump + completed-request events;
    submit_response() answers a stream (HPACK, flow control, framing all
    handled by nghttp2).
  H2ClientSession — submit_request() -> stream id; completed-response
    events. Used for h2 prior-knowledge upstream proxying.

Sessions are sans-io on purpose: the asyncio listener (host/httpd.py)
and proxy service own the sockets and drive feed/pull, exactly like the
h1 path drives h11.
"""

from __future__ import annotations

import ctypes
from ctypes import (
    CFUNCTYPE,
    POINTER,
    Structure,
    c_char_p,
    c_int,
    c_int32,
    c_size_t,
    c_ssize_t,
    c_uint8,
    c_uint32,
    c_void_p,
    cast,
)
from typing import Callable, Optional

H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

NGHTTP2_NV_FLAG_NONE = 0
NGHTTP2_FLAG_END_STREAM = 0x1
NGHTTP2_FRAME_DATA = 0
NGHTTP2_FRAME_HEADERS = 1
NGHTTP2_DATA_FLAG_EOF = 0x1
NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS = 3
# One connection may not park unbounded streams (each buffers up to the body
# cap): advertise the same 128-stream ceiling the native plane enforces.
MAX_CONCURRENT_STREAMS = 128


class SettingsEntry(Structure):
    # nghttp2_settings_entry
    _fields_ = [("settings_id", c_int32), ("value", c_uint32)]


class NV(Structure):
    _fields_ = [("name", c_char_p), ("value", c_char_p),
                ("namelen", c_size_t), ("valuelen", c_size_t),
                ("flags", c_uint8)]


class FrameHd(Structure):
    # nghttp2_frame_hd: every nghttp2_frame union member starts with it.
    _fields_ = [("length", c_size_t), ("stream_id", c_int32),
                ("type", c_uint8), ("flags", c_uint8),
                ("reserved", c_uint8)]


class DataSource(ctypes.Union):
    _fields_ = [("fd", c_int), ("ptr", c_void_p)]


READ_CB = CFUNCTYPE(c_ssize_t, c_void_p, c_int32, POINTER(c_uint8), c_size_t,
                    POINTER(c_uint32), c_void_p, c_void_p)


class DataProvider(Structure):
    _fields_ = [("source", DataSource), ("read_callback", READ_CB)]


ON_HEADER_CB = CFUNCTYPE(c_int, c_void_p, c_void_p, POINTER(c_uint8),
                         c_size_t, POINTER(c_uint8), c_size_t, c_uint8,
                         c_void_p)
ON_FRAME_RECV_CB = CFUNCTYPE(c_int, c_void_p, c_void_p, c_void_p)
ON_DATA_CHUNK_CB = CFUNCTYPE(c_int, c_void_p, c_uint8, c_int32,
                             POINTER(c_uint8), c_size_t, c_void_p)
ON_STREAM_CLOSE_CB = CFUNCTYPE(c_int, c_void_p, c_int32, c_uint32, c_void_p)
ON_BEGIN_HEADERS_CB = CFUNCTYPE(c_int, c_void_p, c_void_p, c_void_p)

_lib = None


def load_lib():
    """-> the nghttp2 CDLL, or None when unavailable (h2 then disabled)."""
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libnghttp2.so.14", "libnghttp2.so"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.nghttp2_session_callbacks_new.argtypes = [POINTER(c_void_p)]
    lib.nghttp2_session_callbacks_new.restype = c_int
    lib.nghttp2_session_callbacks_del.argtypes = [c_void_p]
    for fn, cbt in (
        ("nghttp2_session_callbacks_set_on_header_callback", ON_HEADER_CB),
        ("nghttp2_session_callbacks_set_on_frame_recv_callback",
         ON_FRAME_RECV_CB),
        ("nghttp2_session_callbacks_set_on_data_chunk_recv_callback",
         ON_DATA_CHUNK_CB),
        ("nghttp2_session_callbacks_set_on_stream_close_callback",
         ON_STREAM_CLOSE_CB),
        ("nghttp2_session_callbacks_set_on_begin_headers_callback",
         ON_BEGIN_HEADERS_CB),
    ):
        getattr(lib, fn).argtypes = [c_void_p, cbt]
    lib.nghttp2_session_server_new.argtypes = [POINTER(c_void_p), c_void_p,
                                               c_void_p]
    lib.nghttp2_session_server_new.restype = c_int
    lib.nghttp2_session_client_new.argtypes = [POINTER(c_void_p), c_void_p,
                                               c_void_p]
    lib.nghttp2_session_client_new.restype = c_int
    lib.nghttp2_session_del.argtypes = [c_void_p]
    lib.nghttp2_session_mem_recv.argtypes = [c_void_p, c_char_p, c_size_t]
    lib.nghttp2_session_mem_recv.restype = c_ssize_t
    lib.nghttp2_session_mem_send.argtypes = [c_void_p, POINTER(c_void_p)]
    lib.nghttp2_session_mem_send.restype = c_ssize_t
    lib.nghttp2_submit_settings.argtypes = [c_void_p, c_uint8, c_void_p,
                                            c_size_t]
    lib.nghttp2_submit_settings.restype = c_int
    lib.nghttp2_submit_response.argtypes = [c_void_p, c_int32, POINTER(NV),
                                            c_size_t, POINTER(DataProvider)]
    lib.nghttp2_submit_response.restype = c_int
    lib.nghttp2_submit_request.argtypes = [c_void_p, c_void_p, POINTER(NV),
                                           c_size_t, POINTER(DataProvider),
                                           c_void_p]
    lib.nghttp2_submit_request.restype = c_int32
    lib.nghttp2_session_want_read.argtypes = [c_void_p]
    lib.nghttp2_session_want_read.restype = c_int
    lib.nghttp2_session_want_write.argtypes = [c_void_p]
    lib.nghttp2_session_want_write.restype = c_int
    _lib = lib
    return lib


def available() -> bool:
    return load_lib() is not None


def _nv_array(headers: list[tuple[bytes, bytes]]):
    arr = (NV * len(headers))()
    # Keep the encoded byte strings alive alongside the array.
    keep = []
    for i, (name, value) in enumerate(headers):
        keep.append((name, value))
        arr[i].name = name
        arr[i].value = value
        arr[i].namelen = len(name)
        arr[i].valuelen = len(value)
        arr[i].flags = NGHTTP2_NV_FLAG_NONE
    return arr, keep


class _Stream:
    __slots__ = ("headers", "body", "headers_done", "closed", "send_body",
                 "send_off")

    def __init__(self):
        self.headers: list[tuple[bytes, bytes]] = []
        self.body = bytearray()
        self.headers_done = False
        self.closed = False
        self.send_body = b""
        self.send_off = 0


class _Session:
    """Shared sans-io plumbing for server/client sessions."""

    def __init__(self, server: bool):
        lib = load_lib()
        if lib is None:
            raise RuntimeError("libnghttp2 unavailable")
        self._lib = lib
        self._streams: dict[int, _Stream] = {}
        self.dead = False

        # Per-instance callback closures (kept referenced for GC safety).
        self._cbs = [
            ON_HEADER_CB(self._on_header),
            ON_FRAME_RECV_CB(self._on_frame_recv),
            ON_DATA_CHUNK_CB(self._on_data_chunk),
            ON_STREAM_CLOSE_CB(self._on_stream_close),
        ]
        self._read_cb = READ_CB(self._data_read)

        callbacks = c_void_p()
        lib.nghttp2_session_callbacks_new(ctypes.byref(callbacks))
        lib.nghttp2_session_callbacks_set_on_header_callback(
            callbacks, self._cbs[0])
        lib.nghttp2_session_callbacks_set_on_frame_recv_callback(
            callbacks, self._cbs[1])
        lib.nghttp2_session_callbacks_set_on_data_chunk_recv_callback(
            callbacks, self._cbs[2])
        lib.nghttp2_session_callbacks_set_on_stream_close_callback(
            callbacks, self._cbs[3])
        self._session = c_void_p()
        new = (lib.nghttp2_session_server_new if server
               else lib.nghttp2_session_client_new)
        rv = new(ctypes.byref(self._session), callbacks, None)
        lib.nghttp2_session_callbacks_del(callbacks)
        if rv != 0:
            raise RuntimeError(f"nghttp2 session init: {rv}")
        if server:
            entry = SettingsEntry(NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS,
                                  MAX_CONCURRENT_STREAMS)
            lib.nghttp2_submit_settings(
                self._session, 0, ctypes.byref(entry), 1)
        else:
            lib.nghttp2_submit_settings(self._session, 0, None, 0)

    def close(self) -> None:
        if self._session:
            self._lib.nghttp2_session_del(self._session)
            self._session = c_void_p()

    # -- byte pump -----------------------------------------------------------

    def feed(self, data: bytes) -> bool:
        """Process inbound bytes; False = protocol error, hang up."""
        n = self._lib.nghttp2_session_mem_recv(self._session, data, len(data))
        if n < 0 or n != len(data):
            self.dead = True
            return False
        return True

    def pull(self) -> bytes:
        """Outbound bytes nghttp2 wants on the wire (may be b"")."""
        out = bytearray()
        while True:
            ptr = c_void_p()
            n = self._lib.nghttp2_session_mem_send(self._session,
                                                   ctypes.byref(ptr))
            if n <= 0:
                break
            out += ctypes.string_at(ptr, n)
        return bytes(out)

    def wants_more(self) -> bool:
        return bool(self._lib.nghttp2_session_want_read(self._session) or
                    self._lib.nghttp2_session_want_write(self._session))

    # -- nghttp2 callbacks ---------------------------------------------------

    def _stream(self, stream_id: int) -> _Stream:
        st = self._streams.get(stream_id)
        if st is None:
            st = _Stream()
            self._streams[stream_id] = st
        return st

    def _on_header(self, session, frame, name, namelen, value, valuelen,
                   flags, user_data):
        hd = cast(frame, POINTER(FrameHd)).contents
        st = self._stream(hd.stream_id)
        st.headers.append((ctypes.string_at(name, namelen),
                           ctypes.string_at(value, valuelen)))
        return 0

    def _on_frame_recv(self, session, frame, user_data):
        hd = cast(frame, POINTER(FrameHd)).contents
        if hd.type == NGHTTP2_FRAME_HEADERS:
            st = self._stream(hd.stream_id)
            st.headers_done = True
            if hd.flags & NGHTTP2_FLAG_END_STREAM:
                self._on_message(hd.stream_id, st)
        elif hd.type == NGHTTP2_FRAME_DATA and \
                hd.flags & NGHTTP2_FLAG_END_STREAM:
            st = self._stream(hd.stream_id)
            self._on_message(hd.stream_id, st)
        return 0

    def _on_data_chunk(self, session, flags, stream_id, data, length,
                       user_data):
        st = self._stream(stream_id)
        if len(st.body) + length > 16 * 1024 * 1024:
            return 0x01  # NGHTTP2_ERR_CALLBACK_FAILURE -> connection error
        st.body += ctypes.string_at(data, length)
        return 0

    def _on_stream_close(self, session, stream_id, error_code, user_data):
        st = self._streams.pop(stream_id, None)
        if st is not None and not st.closed:
            st.closed = True
            self._on_closed(stream_id, st, error_code)
        return 0

    def _data_read(self, session, stream_id, buf, length, data_flags, source,
                   user_data):
        st = self._streams.get(stream_id)
        body = st.send_body if st else b""
        off = st.send_off if st else 0
        n = min(len(body) - off, length)
        if n > 0:
            ctypes.memmove(buf, body[off: off + n], n)
            if st:
                st.send_off = off + n
        if st is None or st.send_off >= len(body):
            data_flags[0] = NGHTTP2_DATA_FLAG_EOF
        return n

    # -- overridden by subclasses -------------------------------------------

    def _on_message(self, stream_id: int, st: _Stream) -> None:
        raise NotImplementedError

    def _on_closed(self, stream_id: int, st: _Stream, error: int) -> None:
        pass


class H2ServerSession(_Session):
    """Server half: completed requests surface via `on_request(stream_id,
    headers, body)`; answer with submit_response()."""

    def __init__(self, on_request: Callable[[int, list, bytes], None]):
        super().__init__(server=True)
        self._on_request = on_request

    def _on_message(self, stream_id: int, st: _Stream) -> None:
        self._on_request(stream_id, list(st.headers), bytes(st.body))

    def submit_response(self, stream_id: int, status: int,
                        headers: list[tuple[str, str]], body: bytes,
                        content_length: Optional[int] = None) -> None:
        """Answer a stream. `content_length` overrides the advertised
        length (HEAD responses carry the real entity size with an empty
        body). A stream the peer already reset is dropped silently —
        re-creating its state would pin the body forever."""
        st = self._streams.get(stream_id)
        if st is None or st.closed:
            return  # peer reset the stream while the handler ran
        nv_list = [(b":status", str(status).encode())]
        for k, v in headers:
            lk = k.lower()
            if lk in ("connection", "keep-alive", "transfer-encoding",
                      "content-length", "upgrade"):
                continue  # connection-specific headers are illegal in h2
            nv_list.append((lk.encode("latin-1"), v.encode("latin-1")))
        length = len(body) if content_length is None else content_length
        nv_list.append((b"content-length", str(length).encode()))
        arr, keep = _nv_array(nv_list)
        st.send_body = body
        st.send_off = 0
        provider = DataProvider()
        provider.read_callback = self._read_cb
        rv = self._lib.nghttp2_submit_response(
            self._session, stream_id, arr, len(nv_list),
            ctypes.byref(provider))
        if rv != 0:
            self._streams.pop(stream_id, None)
        del keep


class H2ClientSession(_Session):
    """Client half (h2 prior-knowledge upstream): submit_request() ->
    stream id; completed responses surface via `on_response(stream_id,
    headers, body, error)` (error != 0 => stream reset)."""

    def __init__(self,
                 on_response: Callable[[int, list, bytes, int], None]):
        super().__init__(server=False)
        self._on_response = on_response
        self._done: set[int] = set()

    def _on_message(self, stream_id: int, st: _Stream) -> None:
        self._done.add(stream_id)
        self._on_response(stream_id, list(st.headers), bytes(st.body), 0)

    def _on_closed(self, stream_id: int, st: _Stream, error: int) -> None:
        if stream_id not in self._done:
            self._on_response(stream_id, list(st.headers), bytes(st.body),
                              error or 1)
        self._done.discard(stream_id)

    def submit_request(self, method: str, scheme: str, authority: str,
                       path: str, headers: list[tuple[str, str]],
                       body: bytes = b"") -> int:
        nv_list = [(b":method", method.encode()),
                   (b":scheme", scheme.encode()),
                   (b":authority", authority.encode("latin-1")),
                   (b":path", path.encode("latin-1"))]
        for k, v in headers:
            lk = k.lower()
            if lk in ("connection", "keep-alive", "transfer-encoding",
                      "host", "content-length", "upgrade", "te"):
                continue
            nv_list.append((lk.encode("latin-1"), v.encode("latin-1")))
        if body:
            nv_list.append((b"content-length", str(len(body)).encode()))
        arr, keep = _nv_array(nv_list)
        provider = DataProvider()
        provider.read_callback = self._read_cb
        stream_id = self._lib.nghttp2_submit_request(
            self._session, None, arr, len(nv_list),
            ctypes.byref(provider) if body else None, None)
        del keep  # nv bytes were copied by nghttp2 during the call
        if stream_id > 0:
            # ALWAYS materialize the stream entry — a server can
            # RST_STREAM before any response headers arrive, and
            # _on_stream_close only surfaces the failure for tracked
            # streams. (The provider struct is copied at submit time;
            # body bytes are served later through _data_read.)
            st = self._stream(stream_id)
            st.send_body = body
            st.send_off = 0
        return stream_id


class H2UpstreamConnection:
    """One h2 prior-knowledge upstream connection multiplexing requests
    (asyncio; the proxy-service side of http_proxy_service.rs:54-71).

    request() submits a stream and awaits its response; a connection
    error fails every in-flight future (callers map that to 502)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._session: Optional[H2ClientSession] = None
        self._reader = None
        self._writer = None
        self._futures: dict[int, "object"] = {}
        self._read_task = None
        self._lock = None

    @property
    def alive(self) -> bool:
        return (self._session is not None and not self._session.dead
                and self._writer is not None)

    async def connect(self, ssl=None, server_hostname=None) -> None:
        import asyncio

        self._lock = self._lock or asyncio.Lock()
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=ssl, server_hostname=server_hostname)
        self._session = H2ClientSession(self._on_response)
        await self._flush()
        self._read_task = asyncio.get_running_loop().create_task(
            self._read_loop())

    def _on_response(self, stream_id, headers, body, error):
        fut = self._futures.pop(stream_id, None)
        if fut is not None and not fut.done():
            if error:
                fut.set_exception(ConnectionError(f"h2 stream reset {error}"))
            else:
                fut.set_result((headers, body))

    async def _flush(self) -> None:
        out = self._session.pull()
        if out:
            self._writer.write(out)
            await self._writer.drain()

    async def _read_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(65536)
                if not data or not self._session.feed(data):
                    break
                await self._flush()
        except Exception:
            pass
        finally:
            self._fail_all(ConnectionError("h2 upstream connection lost"))

    def _fail_all(self, exc: Exception) -> None:
        if self._session is not None:
            self._session.dead = True
        for fut in list(self._futures.values()):
            if not fut.done():
                fut.set_exception(exc)
        self._futures.clear()

    async def request(self, method: str, authority: str, path: str,
                      headers: list[tuple[str, str]], body: bytes = b""
                      ) -> tuple[int, list[tuple[str, str]], bytes]:
        import asyncio

        fut = asyncio.get_running_loop().create_future()
        async with self._lock:
            stream_id = self._session.submit_request(
                method, "http", authority, path, headers, body)
            if stream_id <= 0:
                raise ConnectionError(f"h2 submit failed: {stream_id}")
            self._futures[stream_id] = fut
            await self._flush()
        raw_headers, raw_body = await fut
        status = 502
        out: list[tuple[str, str]] = []
        for name, value in raw_headers:
            if name == b":status":
                status = int(value)
            elif not name.startswith(b":"):
                out.append((name.decode("latin-1"), value.decode("latin-1")))
        return status, out, raw_body

    async def close(self) -> None:
        if self._read_task is not None:
            self._read_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
        if self._session is not None:
            self._session.close()
            self._session = None
