"""ModelServer — HTTP data plane serving V1 + V2 protocols.

Parity: SURVEY.md §2.4 — the reference's kserve.ModelServer (FastAPI) with
V1 (`/v1/models/X:predict`, `:explain`) and V2 Open Inference
(`/v2/models/X/infer`, metadata, health) endpoints plus the model-repository
hot load/unload API. Built on the stdlib ThreadingHTTPServer (no fastapi in
this environment); the PyTorch compute inside is what matters on the GPU.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import request as urlrequest

from kubeflow_tpu_torch.obs import expo as obs_expo
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.serving.model import (
    Model, ModelMissing, ModelNotReady, ModelRepository,
)
from kubeflow_tpu_torch.serving.protocol import InferRequest, InferResponse

_V1_PREDICT = re.compile(r"^/v1/models/([^/:]+):predict$")
_V1_STREAM = re.compile(r"^/v1/models/([^/:]+):generate_stream$")
_V1_EXPLAIN = re.compile(r"^/v1/models/([^/:]+):explain$")
_V1_MODEL = re.compile(r"^/v1/models/([^/:]+)$")
_V2_INFER = re.compile(r"^/v2/models/([^/:]+)/infer$")
_V2_MODEL = re.compile(r"^/v2/models/([^/:]+)$")
_V2_MODEL_READY = re.compile(r"^/v2/models/([^/:]+)/ready$")
_V2_MODEL_STATS = re.compile(r"^/v2/models/([^/:]+)/stats$")
_V2_DISAGG = re.compile(
    r"^/v2/models/([^/:]+)/disagg/(prefill|collect|probe|release)$")
_REPO_LOAD = re.compile(r"^/v2/repository/models/([^/:]+)/(load|unload)$")


class ModelServer:
    """Serves a ModelRepository over HTTP. ``start()`` runs in a daemon
    thread and returns (host, port); in production this is the predictor
    container's entrypoint."""

    def __init__(self, repository: Optional[ModelRepository] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 obs: Optional[obs_trace.SpanCollector] = None):
        self.repository = repository or ModelRepository()
        self.request_count = 0
        self.error_count = 0
        # concurrency gauge: the autoscaler's scale signal (KPA role)
        self.in_flight = 0
        self._gauge_lock = threading.Lock()
        # span collector: every infer/stream handler opens a server span
        # chained to the caller's traceparent header (router -> server ->
        # engine is one trace)
        self.obs = obs or obs_trace.collector()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                return json.loads(raw or b"{}")

            def do_GET(self):
                outer.request_count += 1
                with outer._gauge_lock:
                    outer.in_flight += 1
                try:
                    self._get()
                except BrokenPipeError:
                    pass
                finally:
                    with outer._gauge_lock:
                        outer.in_flight -= 1

            def _get(self):
                path = self.path
                if path in ("/", "/v2", "/v2/"):
                    return self._json(200, {
                        "name": "kubeflow-tpu-modelserver",
                        "extensions": ["model_repository"],
                    })
                if path in ("/v2/health/live", "/healthz"):
                    return self._json(200, {"live": True})
                if path == "/v2/health/ready":
                    return self._json(200, {
                        "ready": outer.repository.all_ready()})
                if path == "/v2/repository/index":
                    return self._json(200, [
                        {"name": n, "state": "READY"
                         if outer.repository.get(n).ready else "UNAVAILABLE"}
                        for n in outer.repository.names()
                    ])
                if path == "/metrics":
                    body = outer._render_metrics().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                m = _V2_MODEL_READY.match(path)
                if m:
                    return self._with_model(m.group(1), lambda mod:
                        self._json(200, {"name": mod.name, "ready": mod.ready}))
                m = _V2_MODEL_STATS.match(path)
                if m:
                    # JSON view of the model's stats() families (sched
                    # signals, depot outcome): what the fleet autoscaler
                    # and router scrape without parsing prometheus text
                    return self._with_model(m.group(1), lambda mod:
                        self._json(200, {
                            "name": mod.name,
                            **(getattr(mod, "stats", dict)() or {})}))
                m = _V2_MODEL.match(path)
                if m:
                    return self._with_model(m.group(1), lambda mod:
                        self._json(200, mod.metadata()))
                m = _V1_MODEL.match(path)
                if m:
                    return self._with_model(m.group(1), lambda mod:
                        self._json(200, {"name": mod.name, "ready": mod.ready}))
                self._json(404, {"error": f"no route {path}"})

            def do_POST(self):
                outer.request_count += 1
                with outer._gauge_lock:
                    outer.in_flight += 1
                try:
                    self._post()
                except BrokenPipeError:
                    pass
                finally:
                    with outer._gauge_lock:
                        outer.in_flight -= 1

            def _post(self):
                path = self.path
                m = _V1_PREDICT.match(path)
                if m:
                    return self._infer(m.group(1), v1=True)
                m = _V1_STREAM.match(path)
                if m:
                    return self._stream(m.group(1))
                m = _V2_INFER.match(path)
                if m:
                    return self._infer(m.group(1), v1=False)
                m = _V1_EXPLAIN.match(path)
                if m:
                    return self._explain(m.group(1))
                m = _V2_DISAGG.match(path)
                if m:
                    return self._disagg(m.group(1), m.group(2))
                m = _REPO_LOAD.match(path)
                if m:
                    name, action = m.group(1), m.group(2)
                    try:
                        if action == "load":
                            outer.repository.get(name).load()
                        else:
                            outer.repository.unload(name)
                        return self._json(200, {"name": name, "ok": True})
                    except (ModelMissing, ModelNotReady) as e:
                        outer.error_count += 1
                        return self._json(404, {"error": str(e)})
                    except Exception as e:   # load() failures become a 500
                        outer.error_count += 1
                        return self._json(
                            500, {"error": f"{type(e).__name__}: {e}"})
                self._json(404, {"error": f"no route {path}"})

            def _with_model(self, name, fn):
                try:
                    return fn(outer.repository.get(name))
                except ModelMissing as e:
                    outer.error_count += 1
                    return self._json(404, {"error": str(e)})

            def _infer(self, name: str, v1: bool):
                span = None
                try:
                    model = outer.repository.get(name)
                    body = self._read_body()
                    if v1:
                        req = InferRequest.from_v1(name, body)
                    else:
                        req = InferRequest.from_dict(name, body)
                    # trace propagation: the W3C traceparent header (or
                    # the request-parameter fallback for clients that
                    # can't set headers) chains this server span under
                    # the caller's; the model continues the chain via
                    # the parameter we overwrite with OUR context
                    incoming = (self.headers.get(
                        obs_trace.TRACEPARENT_HEADER)
                        or req.parameters.get("traceparent"))
                    span = outer.obs.start(
                        "server.infer", parent=incoming,
                        attrs={"model": name,
                               "protocol": "v1" if v1 else "v2"})
                    req.parameters["traceparent"] = span.traceparent()
                    resp = model(req)
                    outer.obs.end(span)
                    return self._json(
                        200, resp.to_v1() if v1 else resp.to_dict())
                except ModelMissing as e:
                    outer.error_count += 1
                    self._end_err(span, e)
                    return self._json(404, {"error": str(e)})
                except ModelNotReady as e:
                    outer.error_count += 1
                    self._end_err(span, e)
                    return self._json(503, {"error": str(e)})
                except Exception as e:
                    outer.error_count += 1
                    self._end_err(span, e)
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

            @staticmethod
            def _end_err(span, e):
                if span is not None and span.t1 is None:
                    outer.obs.end(span, error=type(e).__name__)

            def _stream(self, name: str):
                """SSE token streaming (every LLM server's generate path):
                `data: {json}` events per decode chunk, `data: [DONE]` at
                the end. Body: {"inputs": <str | [token ids]>,
                "parameters": {...}}."""
                try:
                    model = outer.repository.get(name)
                    if not hasattr(model, "generate_stream"):
                        return self._json(
                            400, {"error": f"{name!r} is not a generative "
                                           "model"})
                    body = self._read_body()
                    params = dict(body.get("parameters") or {})
                    # server span for the whole stream (setup -> [DONE]),
                    # chained under the caller's header or param context;
                    # the engine chains its queue span under OURS
                    incoming = (self.headers.get(
                        obs_trace.TRACEPARENT_HEADER)
                        or params.get("traceparent"))
                    span = outer.obs.start(
                        "server.generate_stream", parent=incoming,
                        attrs={"model": name})
                    params["traceparent"] = span.traceparent()
                    try:
                        gen = model.generate_stream(
                            body.get("inputs", ""), params)
                    except BaseException as e:
                        outer.obs.end(span, error=type(e).__name__)
                        raise
                except ModelMissing as e:
                    outer.error_count += 1
                    return self._json(404, {"error": str(e)})
                except Exception as e:
                    outer.error_count += 1
                    return self._json(
                        400, {"error": f"{type(e).__name__}: {e}"})
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                # unframed body (no length, no chunking): the connection
                # must close after [DONE] or keep-alive clients reading to
                # EOF hang and pipelined requests misread the stream
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()
                events = 0
                try:
                    for event in gen:
                        events += 1
                        self.wfile.write(
                            b"data: " + json.dumps(event).encode() + b"\n\n")
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    outer.obs.end(span, events=events)
                except (BrokenPipeError, ConnectionResetError):
                    gen.close()        # aborts the request, frees the slot
                    outer.obs.end(span, events=events,
                                  aborted="client disconnect")
                except Exception as e:
                    # headers are gone: surface mid-stream failures
                    # (timeouts etc.) as an SSE error event, never a
                    # silently truncated stream
                    outer.error_count += 1
                    outer.obs.end(span, events=events,
                                  error=type(e).__name__)
                    try:
                        self.wfile.write(
                            b"data: " + json.dumps(
                                {"error": f"{type(e).__name__}: {e}"}
                            ).encode() + b"\n\ndata: [DONE]\n\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass

            def _disagg(self, name: str, op: str):
                """Migration control plane of a disaggregated tier replica
                (serving/disagg.TierRuntime): ``prefill`` runs a prompt to
                first token and migrates its paged-KV to the decode_addr
                in the body; ``collect`` blocks on an injected handoff's
                finish; ``probe`` answers the router's bypass question
                (cached full blocks + this pod's kv_addr); ``release``
                drops an injected handoff (abort-on-the-wire cleanup)."""
                try:
                    model = outer.repository.get(name)
                except ModelMissing as e:
                    outer.error_count += 1
                    return self._json(404, {"error": str(e)})
                rt = getattr(model, "disagg", None)
                if rt is None:
                    outer.error_count += 1
                    return self._json(400, {
                        "error": f"{name!r} is not a disaggregated tier "
                                 "replica"})
                try:
                    body = self._read_body()
                    if op == "prefill":
                        inputs = body.get("inputs", [])
                        if isinstance(inputs, str):
                            prompt = model.tokenizer.encode(inputs, bos=True)
                        else:
                            prompt = [int(t) for t in inputs]
                        params = dict(body.get("parameters") or {})
                        incoming = (self.headers.get(
                            obs_trace.TRACEPARENT_HEADER)
                            or params.get("traceparent"))
                        host, port = body["decode_addr"]
                        out = rt.prefill_and_migrate(
                            prompt, model._sampling(params),
                            (host, int(port)), str(body["handoff_id"]),
                            trace=incoming,
                            timeout_s=float(body.get("timeout_s", 120.0)))
                    elif op == "collect":
                        out = rt.collect(
                            str(body["handoff_id"]),
                            timeout_s=float(body.get("timeout_s", 120.0)))
                        if "error" in out:
                            outer.error_count += 1
                            return self._json(409, out)
                    elif op == "release":
                        out = {"released":
                               rt.release_handoff(str(body["handoff_id"]))}
                    else:                                      # probe
                        prompt = [int(t)
                                  for t in body.get("inputs", [])]
                        out = {"cached_blocks":
                               rt.cached_prefix_blocks(prompt),
                               "kv_addr": (list(rt.kv_addr)
                                           if rt.kv_addr else None),
                               "tier": rt.tier,
                               # the router's bypass rule counts FULL
                               # prompt blocks — its block_size must be
                               # the engine's, not a guessed default
                               "block_size": rt.engine.paged.block_size}
                    return self._json(200, out)
                except Exception as e:
                    outer.error_count += 1
                    return self._json(
                        500, {"error": f"{type(e).__name__}: {e}"})

            def _explain(self, name: str):
                try:
                    model = outer.repository.get(name)
                    req = InferRequest.from_v1(name, self._read_body())
                    return self._json(200, model.explain(req))
                except ModelMissing as e:
                    outer.error_count += 1
                    return self._json(404, {"error": str(e)})
                except Exception as e:
                    outer.error_count += 1
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

        # socketserver's default listen backlog is 5 — a synchronized
        # burst from a fleet router (or a load generator) gets kernel RSTs
        # past that while the accept loop waits on the GIL
        ThreadingHTTPServer.request_queue_size = 128
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.address: tuple[str, int] = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def _render_metrics(self) -> str:
        """The /metrics body, rendered through the ONE shared exposition
        helper (obs/expo.py): # HELP/# TYPE per family, counters typed by
        their _total/_sum/_count suffix, and each model's
        ``request_histograms`` stats family expanded into real Prometheus
        histograms (kft_model_request_{ttft,itl,e2e}_seconds)."""
        counters: dict[str, list] = {
            "kft_requests_total": [(None, self.request_count)],
            "kft_request_errors_total": [(None, self.error_count)],
        }
        gauges: dict[str, list] = {
            # minus this scrape itself
            "kft_requests_in_flight": [(None, max(0, self.in_flight - 1))],
        }
        hists: dict[str, list] = {}
        # per-model engine stats (models exposing stats()); tolerate hot
        # unload racing the scrape. A nested dict is a FAMILY (e.g. the
        # step scheduler's "sched" set) flattened to kft_model_<fam>_<k>;
        # non-numeric values (depot outcome strings) feed only the JSON
        # stats endpoint, never the exposition
        for mname in self.repository.names():
            try:
                mdl = self.repository.get(mname)
                stats = getattr(mdl, "stats", dict)() or {}
            except ModelMissing:
                continue
            # tier-attributed exposition: a disaggregated replica stamps
            # tier="prefill"|"decode" on EVERY family it exports (the
            # request histograms included), through the one shared label
            # formatter so model= and tier= compose identically everywhere
            label = obs_expo.format_labels(
                model=mname, tier=stats.pop("tier", None))
            for hname, snap in (stats.pop("request_histograms", None)
                                or {}).items():
                hists.setdefault(
                    f"kft_model_request_{hname}_seconds",
                    []).append((label, snap))
            # the migration plane's own families (MigrationStats snapshot
            # riding stats()["disagg"]): kft_disagg_*, counter-vs-gauge by
            # the same suffix rule
            for k, v in (stats.pop("disagg", None) or {}).items():
                if not isinstance(v, (int, float, bool)):
                    continue
                fam = f"kft_disagg_{k}"
                target = (counters
                          if fam.endswith(obs_expo.COUNTER_SUFFIXES)
                          else gauges)
                target.setdefault(fam, []).append((label, float(v)))
            flat = []
            for k, v in stats.items():
                if isinstance(v, dict):
                    flat.extend((f"{k}_{k2}", v2) for k2, v2 in v.items())
                else:
                    flat.append((k, v))
            for k, v in flat:
                if not isinstance(v, (int, float, bool)):
                    continue
                fam = f"kft_model_{k}"
                target = (counters
                          if fam.endswith(obs_expo.COUNTER_SUFFIXES)
                          else gauges)
                target.setdefault(fam, []).append((label, float(v)))
        families = (
            [(n, "counter", s) for n, s in counters.items()]
            + [(n, "gauge", s) for n, s in gauges.items()]
            + [(n, "histogram", s) for n, s in hists.items()])
        return obs_expo.render_exposition(families)

    def start(self) -> "ModelServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def url(self) -> str:
        return f"http://{self.address[0]}:{self.address[1]}"


class InferenceClient:
    """Minimal HTTP client for both protocols (tests + router transport)."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict,
              headers: Optional[dict] = None) -> dict:
        req = urlrequest.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     **(headers or {})}, method="POST")
        with urlrequest.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _get(self, path: str) -> dict:
        with urlrequest.urlopen(self.url + path, timeout=self.timeout) as r:
            return json.loads(r.read())

    def generate_stream(self, model: str, inputs, **params):
        """Iterate SSE events from :generate_stream (dicts; ends on [DONE])."""
        req = urlrequest.Request(
            f"{self.url}/v1/models/{model}:generate_stream",
            data=json.dumps({"inputs": inputs,
                             "parameters": params}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urlrequest.urlopen(req, timeout=self.timeout) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[len("data: "):]
                if payload == "[DONE]":
                    return
                yield json.loads(payload)

    def predict_v1(self, model: str, instances: list, **params) -> dict:
        body = {"instances": instances}
        if params:
            body["parameters"] = params
        return self._post(f"/v1/models/{model}:predict", body)

    def infer(self, request: InferRequest) -> InferResponse:
        # propagate trace context as the W3C header too (proxies that
        # strip unknown body params still chain the trace)
        headers = {}
        tp = request.parameters.get("traceparent")
        if tp:
            headers["traceparent"] = tp
        out = self._post(f"/v2/models/{request.model_name}/infer",
                         request.to_dict(), headers=headers)
        return InferResponse.from_dict(out)

    def explain_v1(self, model: str, instances: list) -> dict:
        return self._post(f"/v1/models/{model}:explain",
                          {"instances": instances})

    def metadata(self, model: str) -> dict:
        return self._get(f"/v2/models/{model}")

    def ready(self) -> bool:
        return bool(self._get("/v2/health/ready").get("ready"))

    def load(self, model: str) -> dict:
        return self._post(f"/v2/repository/models/{model}/load", {})

    def unload(self, model: str) -> dict:
        return self._post(f"/v2/repository/models/{model}/unload", {})
