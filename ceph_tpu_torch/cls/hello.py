"""cls_hello: the reference's example/test class (cls/hello/cls_hello.cc)."""

from __future__ import annotations

from ..utils import denc
from . import RD, WR, ClsError, MethodContext, cls_method


@cls_method("hello", "say_hello", RD)
def say_hello(ctx: MethodContext) -> bytes:
    name = ctx.input.decode() if ctx.input else "world"
    return f"Hello, {name}!".encode()


@cls_method("hello", "record_hello", WR)
def record_hello(ctx: MethodContext) -> bytes | None:
    """Writes a greeting into the object (exercises the WR path)."""
    name = ctx.input.decode() if ctx.input else "world"
    if ctx.exists() and ctx.read():
        raise ClsError(17, "already greeted")        # EEXIST
    ctx.write_full(f"Hello, {name}!".encode())
    return None


@cls_method("hello", "replay", RD)
def replay(ctx: MethodContext) -> bytes:
    return ctx.read()


@cls_method("hello", "turn_it_to_11", WR)
def turn_it_to_11(ctx: MethodContext) -> bytes:
    """Uppercases the object in place (read + write in one method)."""
    data = ctx.read()
    ctx.write_full(data.upper())
    return denc.dumps(len(data))
