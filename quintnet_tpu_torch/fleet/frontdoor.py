"""The network front door: an asyncio HTTP/SSE server (stdlib only)
in front of ``fleet.submit``/stream.

Port of ``quintnet_tpu/fleet/frontdoor.py``: pure host code, the same
routes, status mapping and bodies; a request's ``"seed"`` goes to
``fleet.submit(seed=)`` where JAX's makes a key of it.

Everything upstream of this module speaks Python; everything
downstream speaks HTTP — this is where the fleet's typed backpressure
becomes a protocol a load balancer or client library can act on,
instead of a queue silently converting overload into latency:

====================================  =======================================
fleet signal                          HTTP response
====================================  =======================================
``Overloaded('queue_full')``          **429 Too Many Requests** + Retry-After
``Overloaded('shutdown')``            **503 Service Unavailable** + Retry-After
``Overloaded('deadline')``            **503 Service Unavailable** + Retry-After
``Overloaded('pool_down')``           **503 Service Unavailable** + Retry-After
``serve.DeadlineExceeded``            **504 Gateway Timeout** (typed body)
request timeout / unmet result        **504 Gateway Timeout**
malformed request / never admissible  **400 Bad Request**
====================================  =======================================

``GET /healthz`` on a disaggregated fleet (fleet/proc.py pools) is
three-valued: 200 ``"ok"`` (every pool live), 200 ``"degraded"`` (one
pool down, the fallback ladder still serves — the body's ``"pools"``
map says which), 503 ``"unavailable"`` + Retry-After (nothing can
serve).

The degradation ladder under trouble is explicit and this is its
first rung: **shed new work** (the typed 429/503 above, the queue
stays bounded) → **pause admissions** → **drain** → **migrate** — the
later rungs live in the fleet itself (``pause_all``/``drain`` and the
journal migration of fleet/proc.py). Retry-with-jittered-backoff on
replica connection failure is likewise the fleet dispatcher's job
(re-queue at the front + breaker-gated backoff restarts); the front
door's contract is that a client NEVER sees a replica death — only
tokens, a typed rejection, or its own deadline.

Endpoints:

- ``POST /v1/generate`` — body ``{"prompt": [ints],
  "max_new_tokens": N, "stream": bool, "priority": int,
  "deadline_s": float, "adapter_id": str, "seed": int}``.
  Non-streaming: one JSON response ``{"fid", "output"}``. Streaming
  (``"stream": true``): ``text/event-stream`` with one
  ``data: {"token": t, "last": bool}`` event per generated token —
  across migrations, each token exactly once — then an ``event: done``
  carrying the full output (or ``event: error`` with the typed
  rejection; tokens already streamed stand).
- ``GET /healthz`` — cheap liveness snapshot (``fleet.health()``);
  200 while any replica serves, 503 when none can.
- ``GET /v1/metrics`` — JSON (explicit ``application/json``): the
  fleet's front-door counters (``FleetMetrics.summary()``) under
  ``"frontdoor"`` plus each replica engine's
  ``ServeMetrics.summary()`` under ``"engine_summary"`` (shipped over
  the process fleet's existing stats frame — no second accounting
  path).
- ``GET /metrics`` — the SAME ledgers in Prometheus text exposition
  format (``text/plain; version=0.0.4``; obs/prom.py):
  ``quintnet_fleet_*`` counters, ``quintnet_engine_*{replica="..."}``
  per-replica series, ``quintnet_replica_up`` liveness plus
  heartbeat-staleness and breaker-state gauges — and, when the SLO
  engine / signal plane is armed (obs/slo.py, obs/signals.py), the
  ``quintnet_slo_*`` burn-rate families and
  ``quintnet_pool_pressure_*`` per-pool gauges. Every existing
  counter scrapeable as a time series. Kept separate from
  ``/v1/metrics``: one path per format, both read-only.

With an armed SLO engine, ``GET /healthz`` additionally carries
``"slo": {"breaching": [...], "objectives": {...}}`` and a breach
downgrades 200 ``"ok"`` to 200 ``"degraded"`` — the degraded body
NAMES the breaching objectives; 429/503 ``Retry-After`` is raised to
the admission queue's oldest-wait age when that exceeds the
configured floor.

Works identically over a thread :class:`ServeFleet` and a process
:class:`ProcessFleet` — both expose submit/result/health with the
same typed errors, which is the point of the shared contract.
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
from typing import Dict, Optional, Tuple

from quintnet_tpu_torch.fleet.admission import Overloaded
from quintnet_tpu_torch.fleet.health import HEALTHY
from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded

_REASONS = {400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout",
            200: "OK"}


class FrontDoor:
    """See module docstring. ``request_timeout_s`` bounds how long one
    HTTP request may wait on the fleet end to end (a deadline the
    CLIENT did not set; ``deadline_s`` in the body is the client's own
    and is enforced by the engines mid-decode). ``retry_after_s``
    seeds the Retry-After header on 429/503 — the client-visible half
    of backpressure."""

    def __init__(self, fleet, *, host: str = "127.0.0.1", port: int = 0,
                 retry_after_s: float = 1.0,
                 request_timeout_s: float = 300.0,
                 max_body_bytes: int = 8 * 1024 * 1024):
        self.fleet = fleet
        self.host = host
        self.port = port          # 0 = ephemeral; real port after start
        self.retry_after_s = float(retry_after_s)
        self.request_timeout_s = float(request_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Bind + serve on a background thread; returns (host, port)."""
        if self._thread is not None:
            return self.host, self.port
        started = threading.Event()
        boot_err: Dict = {}

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                self._server = loop.run_until_complete(
                    asyncio.start_server(self._handle, self.host,
                                         self.port))
                self.port = self._server.sockets[0].getsockname()[1]
            except OSError as e:
                boot_err["e"] = e
                started.set()
                return
            started.set()
            try:
                loop.run_forever()
            finally:
                self._server.close()
                loop.run_until_complete(self._server.wait_closed())
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fleet-frontdoor")
        self._thread.start()
        started.wait(10.0)
        if "e" in boot_err:
            self._thread = None
            raise boot_err["e"]
        return self.host, self.port

    def close(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "FrontDoor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------------
    # HTTP plumbing
    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, body = await asyncio.wait_for(
                    self._read_request(reader), timeout=30.0)
            except (asyncio.TimeoutError, ValueError,
                    asyncio.IncompleteReadError) as e:
                await self._respond(writer, 400,
                                    {"error": "bad_request",
                                     "message": str(e)})
                return
            if path == "/healthz" and method == "GET":
                await self._healthz(writer)
            elif path == "/v1/metrics" and method == "GET":
                await self._v1_metrics(writer)
            elif path == "/metrics" and method == "GET":
                await self._prometheus(writer)
            elif path == "/v1/generate":
                if method != "POST":
                    await self._respond(
                        writer, 405, {"error": "method_not_allowed",
                                      "message": "POST /v1/generate"})
                else:
                    await self._generate(writer, body)
            else:
                await self._respond(writer, 404,
                                    {"error": "not_found",
                                     "message": f"no route {path!r}"})
        except (ConnectionResetError, BrokenPipeError):
            pass            # client went away mid-response
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _read_request(self, reader) -> Tuple[str, str, bytes]:
        line = (await reader.readline()).decode("latin-1").strip()
        if not line:
            raise ValueError("empty request line")
        parts = line.split()
        if len(parts) != 3:
            raise ValueError(f"malformed request line {line!r}")
        method, path = parts[0].upper(), parts[1]
        headers = {}
        while True:
            h = (await reader.readline()).decode("latin-1")
            if h in ("\r\n", "\n", ""):
                break
            k, _, v = h.partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        if n > self.max_body_bytes:
            raise ValueError(
                f"body of {n} bytes exceeds the {self.max_body_bytes} "
                f"byte limit")
        body = await reader.readexactly(n) if n else b""
        return method, path, body

    async def _respond(self, writer, status: int, obj: Dict,
                       headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(obj).encode("utf-8")
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                "Content-Type: application/json",
                f"Content-Length: {len(data)}",
                "Connection: close"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + data)
        await writer.drain()

    # ------------------------------------------------------------------
    # routes
    # ------------------------------------------------------------------
    async def _healthz(self, writer) -> None:
        """POOL-AWARE liveness: a disaggregated fleet (fleet/proc.py)
        reports per-pool membership, and the status encodes the
        degradation ladder rather than a binary —

        - ``ok`` (200): every pool has a live replica;
        - ``degraded`` (200): a pool is not serving but the node is
          still making progress — the ``pools`` map says HOW: state
          ``"down"`` means the fallback ladder is engaged (prefill
          down -> the decode pool absorbs prefill work; decode down
          -> admitted work requeues behind the breaker-gated
          restart), state ``"recovering"`` means a restart is in
          flight and that pool's work is HELD for it rather than
          absorbed — 200 either way because a load balancer must NOT
          pull a node that is still making progress;
        - ``unavailable`` (503 + Retry-After): nothing can serve (no
          live replica anywhere, or draining).

        Colocated fleets (and the thread fleet, which reports no
        pools) keep the original any-replica-serving mapping."""
        h = self.fleet.health()
        pools = h.get("pools") or {}
        if len(pools) > 1:
            n_up = sum(1 for p in pools.values()
                       if p.get("state") == "up")
            if h["draining"] or n_up == 0:
                h["status"] = "unavailable"
            elif n_up < len(pools):
                h["status"] = "degraded"
            else:
                h["status"] = "ok"
        else:
            serving = any(r["state"] == HEALTHY
                          for r in h["replicas"].values())
            h["status"] = ("ok" if serving and not h["draining"]
                           else "unavailable")
        # SLO status (obs/slo.py, fleets with the engine armed): the
        # body always names the breaching objectives and their burns,
        # and a breach downgrades "ok" to "degraded" — the node still
        # serves (a load balancer must NOT pull it for a latency
        # contract slip), but the body says exactly which promise is
        # burning budget and which pool to blame
        slo = getattr(self.fleet, "slo", None)
        if slo is not None:
            status = slo.status()
            h["slo"] = {"breaching": status["breaching"],
                        "objectives": status["objectives"]}
            if status["breaching"] and h["status"] == "ok":
                h["status"] = "degraded"
        unavailable = h["status"] == "unavailable"
        await self._respond(
            writer, 503 if unavailable else 200, h,
            headers=({"Retry-After": self._retry_after()}
                     if unavailable else None))

    def _retry_after(self) -> str:
        """Retry-After seconds: at least the configured floor, raised
        to the oldest queued request's wait age when the fleet exposes
        it — a client told to come back sooner than the queue is
        already waiting would only bounce off the same 429."""
        hint = self.retry_after_s
        probe = getattr(self.fleet, "queue_oldest_wait_s", None)
        if callable(probe):
            hint = max(hint, probe())
        return str(int(math.ceil(hint)))

    def _engine_summaries(self) -> Dict:
        """Per-replica engine summaries. For the process fleet this is
        an RPC fan-out over the stats frames, so callers run it in an
        executor — the event loop must keep streaming tokens while a
        slow replica answers (or times out)."""
        getter = getattr(self.fleet, "engine_summaries", None)
        return getter() if getter is not None else {}

    async def _v1_metrics(self, writer) -> None:
        loop = asyncio.get_running_loop()
        engines = await loop.run_in_executor(None,
                                             self._engine_summaries)
        await self._respond(writer, 200,
                            {"frontdoor": self.fleet.metrics.summary(),
                             "engine_summary": engines})

    async def _prometheus(self, writer) -> None:
        """Prometheus text exposition over the existing ledgers
        (obs/prom.py renders; nothing new is counted here)."""
        from quintnet_tpu_torch.obs.prom import render_exposition

        loop = asyncio.get_running_loop()
        engines = await loop.run_in_executor(None,
                                             self._engine_summaries)
        slo = getattr(self.fleet, "slo", None)
        signals = getattr(self.fleet, "signals", None)
        audit = getattr(self.fleet, "lock_audit", None)
        text = render_exposition(
            self.fleet.metrics.summary(), engines,
            health=self.fleet.health(),
            slo=slo.status() if slo is not None else None,
            pressure=signals.gauges() if signals is not None else None,
            locks=audit.summary() if audit is not None else None)
        data = text.encode("utf-8")
        head = ["HTTP/1.1 200 OK",
                "Content-Type: text/plain; version=0.0.4; "
                "charset=utf-8",
                f"Content-Length: {len(data)}",
                "Connection: close"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + data)
        await writer.drain()

    def _error_response(self, e: BaseException) -> Tuple[int, Dict,
                                                         Dict]:
        """(status, body, headers) for a typed fleet error — THE
        mapping table in the module docstring."""
        if isinstance(e, Overloaded):
            status = 429 if e.reason == "queue_full" else 503
            return status, {"error": "overloaded", "reason": e.reason,
                            "message": str(e)}, \
                {"Retry-After": self._retry_after()}
        if isinstance(e, DeadlineExceeded):
            return 504, {"error": "deadline_exceeded",
                         "generated": e.generated,
                         "message": str(e)}, {}
        if isinstance(e, TimeoutError):
            return 504, {"error": "timeout", "message": str(e)}, {}
        if isinstance(e, (ValueError, KeyError, TypeError)):
            # TypeError included: a wrong-typed JSON field (e.g.
            # "max_new_tokens": null) is the client's error, and a 500
            # would make load balancers blame the server
            return 400, {"error": "bad_request", "message": str(e)}, {}
        return 500, {"error": "internal",
                     "message": f"{type(e).__name__}: {e}"}, {}

    def _submit(self, spec: Dict, on_token=None) -> int:
        """Parse + submit (runs on the event loop thread — fleet.submit
        only takes the fleet lock briefly)."""
        prompt = spec.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError(
                "'prompt' must be a non-empty list of token ids")
        if "max_new_tokens" not in spec:
            raise ValueError("'max_new_tokens' is required")
        seed = spec.get("seed")
        return self.fleet.submit(
            prompt, int(spec["max_new_tokens"]),
            seed=None if seed is None else int(seed),
            priority=int(spec.get("priority", 0)),
            deadline_s=spec.get("deadline_s"),
            adapter_id=spec.get("adapter_id"),
            on_token=on_token)

    async def _generate(self, writer, body: bytes) -> None:
        try:
            spec = json.loads(body.decode("utf-8") or "{}")
            if not isinstance(spec, dict):
                raise ValueError("body must be a JSON object")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            await self._respond(writer, 400,
                                {"error": "bad_request",
                                 "message": f"invalid JSON body: {e}"})
            return
        if spec.get("stream"):
            await self._generate_stream(writer, spec)
            return
        loop = asyncio.get_running_loop()
        try:
            fid = self._submit(spec)
        except BaseException as e:  # noqa: BLE001 — typed mapping
            status, payload, headers = self._error_response(e)
            await self._respond(writer, status, payload, headers)
            return
        try:
            out = await loop.run_in_executor(
                None, lambda: self.fleet.result(
                    fid, timeout=self.request_timeout_s))
        except BaseException as e:  # noqa: BLE001
            status, payload, headers = self._error_response(e)
            payload["fid"] = fid
            await self._respond(writer, status, payload, headers)
            return
        await self._respond(writer, 200,
                            {"fid": fid,
                             "output": [int(t) for t in out]})

    async def _generate_stream(self, writer, spec: Dict) -> None:
        """SSE: one event per token as replicas produce them (exactly
        once each, across migrations — the fleet's stream contract),
        a final ``done`` event with the full output, or an ``error``
        event carrying the typed rejection."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_token(fid, token, last):
            if loop.is_closed():
                return      # server shut down mid-stream; the fleet
                #             finishes the request, nobody is watching
            try:
                loop.call_soon_threadsafe(q.put_nowait,
                                          ("tok", int(token),
                                           bool(last)))
            except RuntimeError:
                pass        # loop closed between the check and call

        try:
            fid = self._submit(spec, on_token=on_token)
        except BaseException as e:  # noqa: BLE001
            status, payload, headers = self._error_response(e)
            await self._respond(writer, status, payload, headers)
            return

        def watch():
            try:
                out = self.fleet.result(fid,
                                        timeout=self.request_timeout_s)
                item = ("done", [int(t) for t in out], None)
            except BaseException as e:  # noqa: BLE001
                item = ("error", e, None)
            try:
                if not loop.is_closed():
                    loop.call_soon_threadsafe(q.put_nowait, item)
            except RuntimeError:
                pass        # server shut down while we waited

        threading.Thread(target=watch, daemon=True,
                         name=f"frontdoor-watch-{fid}").start()

        writer.write((f"HTTP/1.1 200 OK\r\n"
                      f"Content-Type: text/event-stream\r\n"
                      f"Cache-Control: no-cache\r\n"
                      f"Connection: close\r\n"
                      f"X-Fleet-Fid: {fid}\r\n\r\n").encode("latin-1"))
        await writer.drain()
        while True:
            kind, a, b = await q.get()
            if kind == "tok":
                writer.write(
                    f"data: {json.dumps({'token': a, 'last': b})}"
                    f"\n\n".encode("utf-8"))
                await writer.drain()
                continue
            if kind == "done":
                writer.write(
                    f"event: done\ndata: "
                    f"{json.dumps({'fid': fid, 'output': a})}"
                    f"\n\n".encode("utf-8"))
            else:
                status, payload, _h = self._error_response(a)
                payload["fid"] = fid
                payload["status"] = status
                writer.write(
                    f"event: error\ndata: {json.dumps(payload)}"
                    f"\n\n".encode("utf-8"))
            await writer.drain()
            return
