"""Streaming HTTP completion server over ``AsyncEngine`` — stdlib only
(torch counterpart of repro/serving/server.py).

A dependency-free front-end on raw asyncio streams (no web framework):
one long-lived accept loop, one coroutine per connection,
one ``AsyncEngine.generate`` iterator per completion.  Endpoints::

    POST /v1/completions   {"prompt": [ids...], "max_tokens": 32,
                            "stream": true, "temperature": 0.8,
                            "top_k": 0, "top_p": 0.9, "seed": 1,
                            "stop": ["7 "], "wait": true}
    GET  /healthz          liveness: {"status": "ok"}
    GET  /stats            AsyncEngine.stats(): queue depth, pool residency,
                           fused PAR telemetry, throughput counters — all
                           from ONE worker-published snapshot
    GET  /metrics          Prometheus text exposition of the engine's
                           MetricsRegistry (docs/OBSERVABILITY.md catalog)

``"stream": true`` answers with Server-Sent Events: one ``data:`` chunk per
token (id + detokenized text + running index), a final chunk carrying
``finish_reason``, then ``data: [DONE]``.  Non-streaming requests block and
return the whole completion as JSON.  In both cases the tokens are
bit-identical to a synchronous ``Engine.run()`` of the same (prompt,
SamplingParams) — the server only changes delivery, never sampling.

Service semantics:

* **client disconnect → abort** — every in-flight completion watches its
  socket; EOF (or a failed write) cancels the generator, which aborts the
  request on the engine's worker thread and returns its pool pages
  immediately.
* **backpressure** — admission beyond ``AsyncEngine.max_queued`` either
  awaits capacity (default) or, with ``"wait": false``, fails fast as
  HTTP 429.
* **errors** — malformed JSON / bad params are HTTP 400 with a JSON error
  body; unknown routes 404.

The protocol layer speaks minimal HTTP/1.1: requests are parsed from the
request line + headers + Content-Length body; responses close the
connection (``Connection: close``) so streamed bodies need no chunked
framing.  That is all a load balancer or the bench harness needs, and it
keeps the hot path free of framework overhead.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.serving.api import SamplingParams, default_detokenize
from repro_torch.serving.async_engine import AsyncEngine, QueueFullError

__all__ = ["CompletionServer", "main"]

_MAX_BODY_BYTES = 10 * 1024 * 1024


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


_STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 429: "Too Many Requests",
    500: "Internal Server Error",
}


def _response(status: int, body: bytes, content_type: str) -> bytes:
    return (
        f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        "Connection: close\r\n\r\n"
    ).encode() + body


def _json_response(status: int, obj: Any) -> bytes:
    return _response(
        status, json.dumps(obj).encode(), "application/json"
    )


async def _read_request(
    reader: asyncio.StreamReader,
) -> Tuple[str, str, Dict[str, str], bytes]:
    """Parse one HTTP/1.1 request: (method, path, headers, body).

    Oversized headers surface as ``asyncio.LimitOverrunError`` from
    ``readuntil`` (the StreamReader's 64 KiB limit) — mapped to a 400 by
    the connection handler alongside the ``_HTTPError``s raised here."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        raise _HTTPError(400, f"malformed request line: {lines[0]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    raw_len = headers.get("content-length", "0") or "0"
    try:
        length = int(raw_len)
    except ValueError:
        raise _HTTPError(400, f"bad Content-Length: {raw_len!r}")
    if not 0 <= length <= _MAX_BODY_BYTES:
        raise _HTTPError(400, f"bad body length {length}")
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


def _parse_sampling(payload: Dict[str, Any]) -> SamplingParams:
    try:
        return SamplingParams(
            temperature=float(payload.get("temperature", 0.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            seed=int(payload.get("seed", 0)),
            max_tokens=int(payload.get("max_tokens", 64)),
            # SamplingParams normalizes: bare string -> 1-tuple, list -> tuple
            stop=payload.get("stop", ()),
        )
    except (TypeError, ValueError) as e:
        raise _HTTPError(400, f"bad sampling params: {e}")


class CompletionServer:
    """The HTTP front-end: routes completions into an ``AsyncEngine``.

    ``start()`` binds the listening socket (``port=0`` picks a free port,
    exposed as ``.port`` — how the tests and the smoke script run
    side-effect-free); ``serve_forever()`` blocks in the accept loop;
    ``stop()`` closes the listener and the engine (aborting any in-flight
    requests)."""

    def __init__(
        self,
        async_engine: AsyncEngine,
        detokenize: Optional[Callable[[int], str]] = None,
    ):
        self.engine = async_engine
        self._detokenize = (
            detokenize if detokenize is not None
            else getattr(async_engine.engine, "_detokenize", default_detokenize)
        )
        self._server: Optional[asyncio.AbstractServer] = None
        self.requests_served = 0
        m = async_engine.metrics
        self._m_http = m.counter(
            "http_requests_total", "HTTP requests answered, by route/status",
            ("route", "status"),
        )
        self._m_429 = m.counter(
            "http_429_total",
            "Completions rejected with 429 (backpressure fail-fast)",
        )

    # -- lifecycle -----------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        assert self._server is not None, "server not started"
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.engine.aclose()

    # -- connection handling -------------------------------------------------

    _ROUTES = (
        "/healthz", "/stats", "/metrics", "/debug/flight", "/v1/completions",
    )

    def _count(self, route: str, status: int) -> None:
        self._m_http.labels(route=route, status=str(status)).inc()
        if status == 429:
            self._m_429.inc()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        route = "unknown"
        try:
            try:
                try:
                    method, path, _headers, body = await _read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return  # client went away before sending a full request
                except asyncio.LimitOverrunError:
                    raise _HTTPError(400, "headers too large")
                # /debug/flight takes a ?dump=1 query; strip it for routing
                bare = path.split("?", 1)[0]
                route = bare if bare in self._ROUTES else "other"
                self.requests_served += 1
                self.engine.tracer.instant(
                    "http", "request", cat="http", method=method, route=route
                )
                if bare == "/healthz" and method == "GET":
                    writer.write(_json_response(200, {"status": "ok"}))
                    self._count(route, 200)
                elif bare == "/stats" and method == "GET":
                    stats = self.engine.stats()
                    stats["requests_served"] = self.requests_served
                    writer.write(_json_response(200, stats))
                    self._count(route, 200)
                elif bare == "/metrics" and method == "GET":
                    # count BEFORE rendering so the scrape sees itself —
                    # Prometheus convention, and it keeps the series
                    # non-empty from the very first scrape
                    self._count(route, 200)
                    writer.write(_response(
                        200, self.engine.metrics.render().encode(),
                        "text/plain; version=0.0.4",
                    ))
                elif bare == "/debug/flight" and method == "GET":
                    dump = "dump=1" in (path.split("?", 1) + [""])[1]
                    writer.write(_json_response(
                        200, self.engine.flight_snapshot(dump=dump)
                    ))
                    self._count(route, 200)
                elif bare == "/v1/completions" and method == "POST":
                    await self._completion(reader, writer, body)
                    self._count(route, 200)
                elif bare in self._ROUTES:
                    raise _HTTPError(405, f"{method} not allowed on {bare}")
                else:
                    raise _HTTPError(404, f"no route for {path}")
            except _HTTPError as e:
                writer.write(_json_response(e.status, {"error": e.message}))
                self._count(route, e.status)
            except (ConnectionError, asyncio.CancelledError):
                raise
            except Exception as e:  # engine/worker failure: a real 500
                writer.write(_json_response(
                    500, {"error": f"{type(e).__name__}: {e}"}
                ))
                self._count(route, 500)
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _parse_completion(self, body: bytes):
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise _HTTPError(400, f"bad JSON body: {e}")
        if not isinstance(payload, dict):
            raise _HTTPError(400, "body must be a JSON object")
        prompt = payload.get("prompt")
        if (
            not isinstance(prompt, list) or len(prompt) < 2
            or not all(isinstance(t, int) for t in prompt)
        ):
            raise _HTTPError(
                400, "prompt must be a list of >= 2 token ids (ints)"
            )
        return prompt, _parse_sampling(payload), payload

    async def _completion(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        body: bytes,
    ) -> None:
        prompt, sp, payload = self._parse_completion(body)
        wait = bool(payload.get("wait", True))
        stream = bool(payload.get("stream", False))
        try:
            agen = self.engine.generate(prompt, sp, wait=wait)
            if stream:
                await self._stream_sse(reader, writer, agen, prompt)
            else:
                await self._respond_whole(reader, writer, agen, prompt)
        except QueueFullError as e:
            raise _HTTPError(429, str(e))
        except ValueError as e:  # add_request validation (e.g. max_model_len)
            raise _HTTPError(400, str(e))

    # -- delivery ------------------------------------------------------------

    async def _watch_disconnect(self, reader: asyncio.StreamReader):
        """Resolves when the client hangs up (EOF on the request socket —
        completion requests send nothing after the body, so any EOF means
        the peer is gone).  Stray non-EOF bytes are drained and ignored.

        Deliberate trade-off: a client that half-closes its write side
        after the request (rare for SSE consumers) is treated as gone and
        its request aborted — the protocol here is one request per
        connection with the read side held open, and failing to abort on
        real disconnects would leak decode work, which is the worse
        error for a saturated accelerator."""
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                return

    _SSE_HEAD = (
        b"HTTP/1.1 200 OK\r\n"
        b"Content-Type: text/event-stream\r\n"
        b"Cache-Control: no-cache\r\n"
        b"Connection: close\r\n\r\n"
    )

    async def _stream_sse(self, reader, writer, agen, prompt) -> None:
        """SSE delivery.  The response head is written only once the FIRST
        output arrives: ``generate`` is a lazy async generator, so admission
        rejections (QueueFullError / validation) surface at the first
        ``__anext__`` and must still become proper 429/400 responses."""
        watcher = asyncio.ensure_future(self._watch_disconnect(reader))
        gen = agen.__aiter__()
        head_sent = False
        index = 0
        rid = None
        tracer = self.engine.tracer
        try:
            while True:
                nxt = asyncio.ensure_future(gen.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, watcher}, return_when=asyncio.FIRST_COMPLETED
                )
                if nxt not in done:  # client disconnected mid-stream
                    nxt.cancel()
                    await asyncio.gather(nxt, return_exceptions=True)
                    tracer.instant("http", "disconnect", cat="http", rid=rid)
                    await gen.aclose()  # -> Engine.abort, pages freed
                    return
                try:
                    out = nxt.result()
                except StopAsyncIteration:
                    break
                except (ConnectionError, asyncio.CancelledError):
                    raise
                except Exception as e:
                    if head_sent:
                        # the SSE body is already underway: a second HTTP
                        # response would corrupt the stream — just drop
                        # the connection (the finally's aclose aborts)
                        return
                    if isinstance(e, QueueFullError):
                        raise _HTTPError(429, str(e))
                    if isinstance(e, ValueError):
                        raise _HTTPError(400, str(e))
                    raise _HTTPError(500, f"{type(e).__name__}: {e}")
                if not head_sent:
                    writer.write(self._SSE_HEAD)
                    head_sent = True
                rid = out.request_id
                finish_reason = out.outputs[0].finish_reason
                for i, tok in enumerate(out.new_token_ids):
                    is_final = (
                        out.finished and i == len(out.new_token_ids) - 1
                    )
                    chunk = {
                        "id": out.request_id,
                        "object": "completion.chunk",
                        "index": index,
                        "token": int(tok),
                        "text": self._detokenize(int(tok)),
                        "finish_reason": finish_reason if is_final else None,
                    }
                    writer.write(
                        b"data: " + json.dumps(chunk).encode() + b"\n\n"
                    )
                    index += 1
                if out.finished and not out.new_token_ids:
                    # stop-truncation can finish a request with an empty
                    # delta; the client still needs the finish_reason
                    writer.write(
                        b"data: " + json.dumps({
                            "id": out.request_id,
                            "object": "completion.chunk",
                            "index": index, "token": None, "text": "",
                            "finish_reason": finish_reason,
                        }).encode() + b"\n\n"
                    )
                await writer.drain()
            if not head_sent:
                writer.write(self._SSE_HEAD)
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
            tracer.instant(
                "http", "completion", cat="http", rid=rid, tokens=index
            )
        except (ConnectionError, OSError):
            pass  # failed write: the finally's aclose aborts the request
        finally:
            watcher.cancel()
            await asyncio.gather(watcher, return_exceptions=True)
            await gen.aclose()

    async def _respond_whole(self, reader, writer, agen, prompt) -> None:
        watcher = asyncio.ensure_future(self._watch_disconnect(reader))
        collect = asyncio.ensure_future(self._collect(agen))
        tracer = self.engine.tracer
        try:
            done, _ = await asyncio.wait(
                {collect, watcher}, return_when=asyncio.FIRST_COMPLETED
            )
            if collect not in done:  # disconnected while we were decoding
                collect.cancel()  # cancels generate() -> abort
                await asyncio.gather(collect, return_exceptions=True)
                tracer.instant("http", "disconnect", cat="http", rid=None)
                return
            rid, token_ids, finish_reason = collect.result()
            tracer.instant(
                "http", "completion", cat="http", rid=rid,
                tokens=len(token_ids),
            )
            writer.write(_json_response(200, {
                "id": rid,
                "object": "completion",
                "token_ids": token_ids,
                "text": "".join(self._detokenize(t) for t in token_ids),
                "finish_reason": finish_reason,
                "usage": {
                    "prompt_tokens": len(prompt),
                    "completion_tokens": len(token_ids),
                },
            }))
            await writer.drain()
        finally:
            watcher.cancel()
            await asyncio.gather(watcher, return_exceptions=True)

    @staticmethod
    async def _collect(agen):
        rid, token_ids, finish_reason = None, [], None
        async for out in agen:
            rid = out.request_id
            token_ids = [int(t) for t in out.token_ids]
            finish_reason = out.outputs[0].finish_reason
        return rid, token_ids, finish_reason


# ---------------------------------------------------------------------------
# CLI: serve the smoke-scale toy pair
# ---------------------------------------------------------------------------


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="serve the smoke-scale TLM/DLM pair over HTTP"
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models and the engine (cuda, or cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-queued", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--par-mode", choices=["off", "wdos"], default="off")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages across requests "
                         "(radix tree, copy-on-write; tokens stay "
                         "bit-identical to sharing off)")
    ap.add_argument("--tokenizer", default=None, metavar="VOCAB_JSON",
                    help="BPE vocab file (BPETokenizer.save) used to "
                         "detokenize streamed tokens; 'builtin' trains the "
                         "self-contained default vocab; omitted -> decimal "
                         "token ids")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Chrome-trace/Perfetto JSON timeline of "
                         "the whole serving session to PATH on shutdown")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="stream structured span/instant events to PATH as "
                         "JSONL while serving")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import build_pair
    from repro_torch.serving.api import EngineConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.tracing import Tracer

    tracer = None
    if args.trace_out or args.trace_jsonl:
        tracer = Tracer(jsonl_path=args.trace_jsonl)

    detokenize = None
    if args.tokenizer is not None:
        from repro_torch.serving.tokenizer import BPETokenizer

        tok = (
            BPETokenizer.trained() if args.tokenizer == "builtin"
            else BPETokenizer.load(args.tokenizer)
        )
        detokenize = tok.piece

    print(f"building TLM/DLM pair (quantize={not args.no_quant}) ...")
    target, draft = build_pair(seed=0, s_max=256, quantize=not args.no_quant,
                               device=args.device)
    engine = Engine(target, draft, EngineConfig(
        max_batch=args.max_batch, page_size=args.page_size,
        par_mode=args.par_mode, prefix_cache=args.prefix_cache,
    ), device=args.device, trace=tracer, detokenize=detokenize)

    async def _run():
        server = CompletionServer(
            AsyncEngine(engine, max_queued=args.max_queued)
        )
        await server.start(args.host, args.port)
        print(f"listening on http://{args.host}:{server.port}  "
              "(POST /v1/completions, GET /healthz, GET /stats, "
              "GET /metrics)")
        try:
            await server.serve_forever()
        finally:
            await server.stop()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    finally:
        if tracer is not None:
            if args.trace_out:
                tracer.export(args.trace_out)
                print(f"trace written to {args.trace_out} "
                      "(load in https://ui.perfetto.dev)")
            tracer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
