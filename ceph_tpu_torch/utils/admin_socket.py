"""Admin socket: per-daemon introspection endpoint.

The common/admin_socket.{h,cc} analog: components register command
hooks ("perf dump", "dump_ops_in_flight", "config show", ...); the
daemon answers JSON over a unix domain socket (the `ceph daemon
<name> <cmd>` path) and the same registry is callable in-process.

Wire protocol (like the reference's admin socket): the client sends one
JSON line {"prefix": "perf dump", ...}\n and receives one JSON document
back, connection closed after each command.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Callable


class AdminSocket:
    def __init__(self, name: str, path: str = ""):
        self.name = name
        self.path = path
        self._hooks: dict[str, Callable[[dict], object]] = {}
        self._server: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stopped = False
        self.register("help", lambda cmd: sorted(self._hooks))

    def register(self, prefix: str,
                 hook: Callable[[dict], object]) -> None:
        self._hooks[prefix] = hook

    def execute(self, cmd: dict | str) -> object:
        if isinstance(cmd, str):
            cmd = {"prefix": cmd}
        hook = self._hooks.get(cmd.get("prefix", ""))
        if hook is None:
            return {"error": f"unknown command {cmd.get('prefix')!r}; "
                             f"try 'help'"}
        return hook(cmd)

    # -- unix socket front-end ---------------------------------------------

    def start(self) -> None:
        if not self.path:
            return
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self.path)
        self._server.listen(8)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"asok-{self.name}")
        self._thread.start()

    def _serve(self) -> None:
        while not self._stopped:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            # thread-per-connection + recv timeout: one stalled client
            # must not wedge introspection for the daemon's lifetime
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(5.0)
            buf = b""
            while not buf.endswith(b"\n") and len(buf) < 1 << 20:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
            cmd = json.loads(buf.decode() or "{}")
            out = self.execute(cmd)
            conn.sendall(json.dumps(out, default=str).encode())
        except Exception as e:
            try:
                conn.sendall(json.dumps({"error": str(e)}).encode())
            except OSError:
                pass
        finally:
            conn.close()

    def shutdown(self) -> None:
        self._stopped = True
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        if self.path:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass


def admin_command(path: str, cmd: dict | str) -> object:
    """Client side: the `ceph daemon <sock> <cmd>` analog."""
    if isinstance(cmd, str):
        cmd = {"prefix": cmd}
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.connect(path)
        s.sendall(json.dumps(cmd).encode() + b"\n")
        buf = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
        return json.loads(buf.decode())
    finally:
        s.close()
