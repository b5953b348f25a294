"""Shared raw-socket HTTP client for the serving stack's own consumers (a
copy of repro/serving/http_client.py, which imports no JAX either).

The port's tests and ``chip_smoke.py`` drive ``CompletionServer`` through
this one asyncio-streams HTTP/1.1 client.  It deliberately speaks the
same minimal protocol the server does — request line + headers +
Content-Length body, ``Connection: close`` responses — with no external
dependency, so exercising it IS exercising the wire format a load
balancer sees.

The surface splits by how much of the exchange the caller wants to own:

* ``request`` / ``get_json`` — one whole request/response round trip;
* ``sse_request`` — POST a streaming completion, drain the SSE body, and
  parse it into chunk dicts (``parse_sse`` validates the framing:
  ``data:`` lines, blank-line separation, terminal ``data: [DONE]``);
* ``open_request`` + ``read_head`` + ``iter_sse`` — incremental control
  for live-streaming consumers and disconnect scenarios (open, read a
  chunk or two, hang up).
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

__all__ = [
    "format_request",
    "open_request",
    "read_head",
    "request",
    "get_json",
    "parse_sse",
    "sse_request",
    "iter_sse",
]


def format_request(method: str, path: str, payload: Any = None,
                   host: str = "client") -> bytes:
    """Serialize one HTTP/1.1 request with an optional JSON body."""
    body = json.dumps(payload).encode() if payload is not None else b""
    head = (
        f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode()
    return head + body


async def open_request(
    port: int, method: str, path: str, payload: Any = None,
    host: str = "127.0.0.1",
) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    """Connect, send the request, and hand back the raw streams — for
    callers that read incrementally (SSE consumers) or disconnect early
    (abort scenarios).  The caller owns closing the writer."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(format_request(method, path, payload))
    await writer.drain()
    return reader, writer


async def request(
    port: int, method: str, path: str, payload: Any = None,
    host: str = "127.0.0.1",
) -> Tuple[int, str, bytes]:
    """One whole round trip: returns (status, response head, body bytes)."""
    reader, writer = await open_request(port, method, path, payload, host)
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    return status, head.decode("latin-1"), body


async def get_json(
    port: int, path: str, host: str = "127.0.0.1",
) -> Tuple[int, Any]:
    """GET a JSON endpoint: returns (status, decoded body)."""
    status, _head, body = await request(port, "GET", path, host=host)
    return status, json.loads(body) if body else None


async def read_head(reader: asyncio.StreamReader) -> str:
    """Consume and return the response head (through the blank line)."""
    head = await reader.readuntil(b"\r\n\r\n")
    return head.decode("latin-1")


def parse_sse(body: bytes) -> List[Optional[Dict[str, Any]]]:
    """Parse a complete SSE body into chunk dicts, validating the framing:
    every event is a single ``data: `` line, events are blank-line
    separated, and the stream ends with ``data: [DONE]`` (not included in
    the returned list).  Raises ``AssertionError`` on violations — the
    framing contract is part of what the tests and the CI smoke check."""
    events = [e for e in body.decode().split("\n\n") if e.strip()]
    assert events, "empty SSE body"
    assert events[-1] == "data: [DONE]", f"missing [DONE]: {events[-1]!r}"
    for e in events:
        assert e.startswith("data: ") and "\n" not in e, f"bad SSE event {e!r}"
    return [json.loads(e[len("data: "):]) for e in events[:-1]]


async def sse_request(
    port: int, payload: Dict[str, Any], path: str = "/v1/completions",
    host: str = "127.0.0.1",
) -> Tuple[int, str, List[Dict[str, Any]]]:
    """POST a streaming completion and drain it: returns (status, response
    head, parsed chunks).  Non-200 responses return the error body parsed
    as no chunks (the JSON error stays in the head's connection)."""
    reader, writer = await open_request(
        port, "POST", path, dict(payload, stream=True), host
    )
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    if status != 200:
        return status, head.decode("latin-1"), []
    return status, head.decode("latin-1"), parse_sse(body)


async def iter_sse(
    reader: asyncio.StreamReader,
) -> AsyncIterator[Dict[str, Any]]:
    """Yield SSE chunk dicts as they arrive (after ``read_head``); stops
    at ``data: [DONE]``.  For live consumers that act per token."""
    while True:
        event = (await reader.readuntil(b"\n\n")).decode().strip()
        if event == "data: [DONE]":
            return
        yield json.loads(event[len("data: "):])
