# Copied from ray_tpu/util/rpdb.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Remote pdb over TCP (reference: python/ray/util/rpdb.py —
ray.util.pdb.set_trace() opening a socket-backed pdb a developer telnets
into; debugpy variant in _private/worker debugger hooks).

``set_trace()`` from inside a task/actor binds a listener on a free port,
announces host:port on stderr (which streams to the driver via the log
monitor), and blocks the worker until a client attaches:

    nc 127.0.0.1 <port>
"""

from __future__ import annotations

import pdb
import socket
import sys


class _SocketIO:
    def __init__(self, conn: socket.socket):
        self._file = conn.makefile("rw", buffering=1)

    def readline(self):
        return self._file.readline()

    def write(self, data):
        self._file.write(data)

    def flush(self):
        self._file.flush()


class RemotePdb(pdb.Pdb):
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        bound = self._sock.getsockname()
        print(f"RemotePdb session waiting at {bound[0]}:{bound[1]} — "
              f"attach with: nc {bound[0]} {bound[1]}",
              file=sys.stderr, flush=True)
        conn, _ = self._sock.accept()
        self._conn = conn
        io = _SocketIO(conn)
        super().__init__(stdin=io, stdout=io)

    def do_quit(self, arg):
        try:
            self._conn.close()
            self._sock.close()
        except OSError:
            pass
        return super().do_quit(arg)

    do_q = do_exit = do_quit


def set_trace(host: str = "127.0.0.1", port: int = 0) -> None:
    """Breakpoint inside a remote task/actor (reference: ray.util.rpdb
    set_trace)."""
    debugger = RemotePdb(host=host, port=port)
    debugger.set_trace(sys._getframe().f_back)
