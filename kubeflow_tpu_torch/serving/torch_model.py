"""PyTorch predictor runtimes (counterparts of ``kubeflow_tpu.serving.
jax_model``): ``TorchModel``, any ``fn(params, batch)`` with padded batch
buckets, and ``LLMModel``, the generate endpoint over the
continuous-batching engine.

``TorchModel`` serves ``fn(params, x) -> y`` with batch-size bucketing
as ``JAXModel`` does: a request is cut into chunks of the largest
bucket, each chunk zero-padded up to the next bucket, and the pad sliced
off. Where ``jax.jit`` compiles one program per bucket, ``load()``
captures one: on a card, with ``warmup`` set and ``example_shape`` given,
each bucket's ``fn(params, static_in) -> static_out`` becomes a CUDA
graph (``cuda_graph.capture``, one memory pool), and ``predict`` copies
the padded chunk into that bucket's static input and replays it. The
replays share their static buffers, so ``predict`` holds a lock. A
capture that fails fails the load; nothing falls back to the eager
call. Without ``example_shape``, or on the CPU, ``fn`` runs eagerly on
the chunk. ``compile_cache_dir`` is accepted and unused, as
``KFT_COMPILE_CACHE`` is: a CUDA graph lives in its process.

``LLMModel`` drives one ``LLMEngine`` from a background stepping thread,
so concurrent HTTP requests share one decode batch. It runs on ``device``
(CUDA unless ``"cpu"`` is asked for; ``load()`` raises when no GPU is
visible and none was asked for), or with ``mesh=`` (a
``parallel.mesh.TensorMesh`` of ``expert`` x ``tensor`` ranks) over the
mesh's ranks:
``load()`` starts them, ``unload()`` stops and joins them.

A disaggregated tier replica (``tier="prefill"|"decode"``) carries the
KV-migration glue in ``disagg`` (a ``serving.disagg.TierRuntime``,
attached by the runtime or the caller), which the server's ``/disagg``
routes dispatch to; ``stats()`` then reports ``tier`` and ``disagg``.

On a card, ``load()`` captures the engine's steady-state decode program
as a CUDA graph (``LLMEngine.precompile``), where the JAX model
precompiles through its depot: without a mesh and not on a prefill
tier, whose steady-state program is chunked prefill. A capture that
fails fails the load. With ``KFT_DEPOT`` set, as the JAX model does,
``load()`` names the depot (``parallel/depot.depot_from_env``) and hands
it to that capture, which stays local (a CUDA graph cannot be serialized
to another process): ``stats()`` reports ``depot_outcome`` "compiled"
and the counters under ``depot``. Where the port does not capture (the
CPU, a mesh, the prefill tier), ``KFT_DEPOT`` changes nothing. Capture
under a mesh or of the prefill tier's program, and meshes over axes
other than ``expert`` and ``tensor``, belong to later slices.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.parallel.depot import DepotStats, depot_from_env
from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
from kubeflow_tpu_torch.serving.model import Model
from kubeflow_tpu_torch.serving.protocol import InferRequest, InferResponse


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TorchModel(Model):
    """Serves ``fn(params, inputs) -> outputs`` on ``device`` (CUDA unless
    ``"cpu"`` is asked for) with batch-size bucketing (module
    docstring): requests are padded up to the nearest bucket, so the
    card replays a handful of captured shapes, never one per request
    size."""

    def __init__(self, name: str, fn: Callable, params=None, *,
                 batch_buckets: Sequence[int] = (1, 4, 16, 64),
                 compile_cache_dir: Optional[str] = None,
                 warmup: bool = True,
                 example_shape: Optional[Sequence[int]] = None,
                 device: DeviceLike = None):
        super().__init__(name)
        self.fn = fn
        self.params = params
        self.buckets = sorted(batch_buckets)
        self.compile_cache_dir = compile_cache_dir
        self.warmup = warmup
        self.example_shape = tuple(example_shape) if example_shape else None
        self.device = device
        self._device: Optional[torch.device] = None
        # bucket -> (static input, graph); outputs by bucket
        self._graphs: dict = {}
        self._out: dict = {}
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self._lock = threading.Lock()

    def load(self) -> bool:
        from kubeflow_tpu_torch.cuda_graph import capture

        self._device = resolve_device(self.device)
        if (self.warmup and self.example_shape is not None
                and self._device.type == "cuda"):
            statics = {b: torch.zeros((b, *self.example_shape),
                                      dtype=torch.float32,
                                      device=self._device)
                       for b in self.buckets}

            def part(b):
                def run():
                    self._out[b] = self.fn(self.params, statics[b])
                return run

            # the outputs are those the captures allocate (in the graphs'
            # pool), which every replay rewrites
            with torch.no_grad():
                cap = capture([part(b) for b in self.buckets],
                              lambda: {f"in{b}": statics[b]
                                       for b in self.buckets},
                              (), self._device,
                              f"{self.name} bucket inputs")
            self._graphs = {b: (statics[b], g)
                            for b, g in zip(self.buckets, cap.graphs)}
            self.capture_seconds = cap.capture_seconds
            self.pool_bytes = cap.pool_bytes
        self.ready = True
        return True

    def unload(self) -> None:
        with self._lock:
            self._graphs, self._out = {}, {}
        self.ready = False

    def _run(self, part: np.ndarray) -> np.ndarray:
        """``fn`` on one padded chunk: its bucket's replay, or eagerly."""
        b = part.shape[0]
        if b in self._graphs:
            static, graph = self._graphs[b]
            static.copy_(torch.from_numpy(part))
            graph.replay()
            y = self._out[b]
        else:
            with torch.no_grad():
                y = self.fn(self.params, torch.as_tensor(part,
                                                         device=self._device))
        if y.dtype == torch.bfloat16:            # numpy has no bfloat16
            y = y.float()
        return y.cpu().numpy()

    def predict(self, request: InferRequest) -> InferResponse:
        x = request.as_numpy()
        n = x.shape[0]
        # batches beyond the largest bucket run in largest-bucket chunks,
        # so the set of captured shapes stays bounded whatever the size
        top = self.buckets[-1]
        chunks = []
        with self._lock:
            for start in range(0, n, top):
                part = x[start:start + top]
                m = part.shape[0]
                bucket = _next_bucket(m, self.buckets)
                if bucket > m:
                    pad = np.zeros((bucket - m, *part.shape[1:]), part.dtype)
                    part = np.concatenate([part, pad], axis=0)
                chunks.append(self._run(part)[:m])
        out = np.concatenate(chunks, axis=0)
        return InferResponse.from_numpy(self.name, {"output-0": out},
                                        id=request.id)


class _StopMatcher:
    """Incremental text-level stop-string watcher for one request.

    Feeds token ids through the tokenizer's context-free byte stream and
    tracks, per token, the cumulative decoded length — so a match can be
    cut EXACTLY: text truncates at the match start (stop string excluded,
    the vLLM/HF convention) and tokens truncate to those fully before it.
    ``safe_len`` is how much text streaming may emit while unmatched: a
    stop string split across decode chunks must never leak its prefix.
    """

    def __init__(self, tokenizer, stops: list[str]):
        import codecs

        self._tok = tokenizer
        self._utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        self.stops = stops
        self.max_stop = max(len(s) for s in stops)
        self.text = ""
        self._cum: list[int] = []       # text length after each token
        self.match_at: Optional[int] = None

    def feed(self, new_tokens) -> bool:
        prev_len = len(self.text)
        for t in new_tokens:
            self.text += self._utf8.decode(self._tok.decode_bytes([t]))
            self._cum.append(len(self.text))
        # scan only the window a NEW match could occupy (old text minus a
        # possible straddle) — O(total chars), not O(chars x chunks)
        for s in self.stops:
            start = max(0, prev_len - len(s) + 1)
            i = self.text.find(s, start)
            if i >= 0 and (self.match_at is None or i < self.match_at):
                self.match_at = i
        return self.match_at is not None

    @property
    def final_text(self) -> str:
        return self.text if self.match_at is None \
            else self.text[:self.match_at]

    @property
    def token_cut(self) -> int:
        """Tokens to keep: those decoded entirely before the match."""
        if self.match_at is None:
            return len(self._cum)
        return sum(1 for n in self._cum if n <= self.match_at)

    @property
    def safe_len(self) -> int:
        if self.match_at is not None:
            return self.match_at
        return max(0, len(self.text) - (self.max_stop - 1))

    def finish(self) -> None:
        """Flush bytes buffered mid-multibyte-character (a generation can
        end on a split character; predict's full decode renders the
        replacement char, so the stream must too)."""
        self.text += self._utf8.decode(b"", final=True)


class LLMModel(Model):
    """Generate endpoint over the continuous-batching engine.

    Request contract (V2): INT32/INT64 input tensor of token ids [B, S]
    (right-padded with pad_id) or a single sequence [S], or BYTES text
    when a tokenizer is present; parameters: max_tokens, temperature,
    top_k, top_p, eos_id, stop_token_ids, stop, logprobs. Response:
    "tokens" [B, max_new] (right-padded with pad_id) + "lengths" [B]
    (+ "text", "logprobs").
    """

    def __init__(self, name: str, params, cfg, *, max_batch: int = 8,
                 max_seq: int = 1024, pad_id: int = 0,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512),
                 tokenizer=None, request_timeout: float = 600.0,
                 scheduler=None, quant=None, device: DeviceLike = None,
                 mesh=None, tier: str = ""):
        super().__init__(name)
        self._params = params
        self.cfg = cfg
        self.scheduler = scheduler     # SchedulerConfig
        self.quant = quant             # QuantConfig
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.prefill_buckets = prefill_buckets
        self.tokenizer = tokenizer
        self.request_timeout = request_timeout
        self.device = device
        self.mesh = mesh
        # disaggregated serving: which tier this replica plays ("" =
        # co-located); it labels stats and /metrics, and ``disagg`` holds
        # the TierRuntime the server's /disagg routes dispatch to
        self.tier = str(tier or "")
        self.disagg = None
        self.engine: Optional[LLMEngine] = None
        # engine build and decode-program capture seconds (stats())
        self.load_seconds: Optional[float] = None
        self.precompile_seconds: Optional[float] = None
        self._depot_stats: Optional[DepotStats] = None
        self._wake = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False

    @classmethod
    def from_pretrained(cls, name: str, model_dir: str, *,
                        dtype=torch.bfloat16, device: DeviceLike = None,
                        mesh=None, **kw) -> "LLMModel":
        """Build from an HF-layout checkpoint directory (config.json +
        model*.safetensors [+ tokenizer.json]). Text in/text out when a
        tokenizer is present; token ids otherwise. Weights load straight
        onto the serving device; with ``mesh``, each rank loads its own
        shard when ``load()`` starts it (the sharded load). MoE serves
        dropless (``moe_capacity_factor=0.0``): capacity buffers are a
        training regulariser, and served, the same prompt must decode
        the same at any batch size."""
        from kubeflow_tpu_torch.device import resolve_device
        from kubeflow_tpu_torch.models import hf_llama
        from kubeflow_tpu_torch.serving.tokenizer import load_tokenizer

        if mesh is not None:
            cfg = hf_llama.load_config(model_dir, dtype=dtype,
                                       moe_capacity_factor=0.0)
            params = hf_llama.CheckpointParams(model_dir, dtype)
            dev = None
        else:
            dev = resolve_device(device)
            cfg, params = hf_llama.load_pretrained(
                model_dir, dtype=dtype, device=dev, moe_capacity_factor=0.0)
        tok = load_tokenizer(model_dir)
        kw.setdefault("max_seq", min(cfg.max_seq, 1024))
        return cls(name, params, cfg, tokenizer=tok, device=dev, mesh=mesh,
                   **kw)

    def load(self) -> bool:
        t0 = time.perf_counter()
        self.engine = LLMEngine(
            self._params, self.cfg, max_batch=self.max_batch,
            max_seq=self.max_seq,
            prefill_buckets=[b for b in self.prefill_buckets
                             if b <= self.max_seq] or [self.max_seq],
            scheduler=self.scheduler, quant=self.quant, device=self.device,
            mesh=self.mesh)
        t1 = time.perf_counter()
        self.load_seconds = round(t1 - t0, 3)
        # the JAX model precompiles only under a depot, since its lazy jit
        # does the same work later; the eager decode is not that work, so
        # the capture happens here, before any request can wait on it
        if (self.engine.device.type == "cuda" and self.mesh is None
                and self.tier != "prefill"):
            depot = None
            if os.environ.get("KFT_DEPOT"):
                self._depot_stats = DepotStats()
                depot = depot_from_env(stats=self._depot_stats)
            self.engine.precompile(depot=depot, stats=self._depot_stats,
                                   tier=self.tier)
            self.precompile_seconds = round(time.perf_counter() - t1, 3)
        self._shutdown = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.ready = True
        return True

    def unload(self) -> None:
        self._shutdown = True
        with self._wake:
            self._wake.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
        if self.engine is not None:
            self.engine.close()
        self.engine = None
        self.ready = False

    def kick(self) -> None:
        """Wake the stepping thread (a control op was queued on the
        engine, or work arrived by a path that did not notify)."""
        with self._wake:
            self._wake.notify_all()

    def _loop(self) -> None:
        while not self._shutdown:
            with self._wake:
                while not self._shutdown and not self.engine.has_work():
                    self._wake.wait(timeout=0.1)
            if self._shutdown:
                return
            self.engine.step()
            # requests can also finish inside admit (instant EOS / 1-token
            # budget), so wake waiters after every step unconditionally
            with self._wake:
                self._wake.notify_all()

    def _sampling(self, p: dict) -> SamplingParams:
        """ONE place request parameters become SamplingParams — predict and
        the streaming path must never drift on defaults."""
        eos_default = (self.tokenizer.eos_id
                       if self.tokenizer is not None else None)
        return SamplingParams(
            max_tokens=int(p.get("max_tokens", 64)),
            temperature=float(p.get("temperature", 0.0)),
            top_k=int(p.get("top_k", 0)),
            top_p=float(p.get("top_p", 1.0)),
            eos_id=(int(p["eos_id"]) if "eos_id" in p else eos_default),
            stop_token_ids=tuple(
                int(t) for t in (p.get("stop_token_ids") or ())),
        )

    def _stop_strings(self, p: dict) -> list[str]:
        stop = p.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        stop = [str(s) for s in stop if s]
        if stop and self.tokenizer is None:
            raise ValueError(
                f"model {self.name!r} has no tokenizer; stop strings need "
                "one (use stop_token_ids)")
        return stop

    def stats(self) -> dict:
        """Engine gauges for the /metrics scrape: generated token count,
        decode steps, KV pool occupancy, prefix hits, downgrades, the
        active and requested quant config (nested under "quant"), the step
        scheduler's counter set (nested under "sched") and the
        request-latency histograms; under a mesh, the mesh (tensor size,
        collective backend, devices); on a tier replica, the tier and the
        migration counters (nested under "disagg")."""
        eng = self.engine
        if eng is None:
            return {}
        out = {
            "generated_tokens_total": eng.generated_tokens,
            "decode_steps_total": eng.steps,
            "prefill_dispatches_total": eng.prefill_dispatches,
            "active_requests": len(eng._active),
            "waiting_requests": len(eng._waiting),
            "kv_free_blocks": eng.paged.allocator.free_blocks,
            "kv_reclaimable_blocks": eng.paged.reclaimable_blocks,
            "prefix_cache_hits_total": eng.paged.prefix_hits,
            "kernel_downgrades_total": eng.kernel_downgrades,
            # the ACTIVE (post-resolution) quant config and what was
            # requested: a downgrade is visible, not inferred from logs
            "quant": {
                "kv_dtype": eng.quant.kv_dtype,
                "weight_dtype": eng.quant.weight_dtype,
                "exact_parity": eng.quant.exact_parity,
                "active": eng.quant.tag(),
                "requested": (eng.quant_requested.tag()
                              if eng.quant_requested is not None
                              else "none"),
            },
            "quant_downgrades_total": eng.quant_downgrades,
            "sched": eng.scheduler_stats(),
            "request_histograms": {
                k: h.snapshot() for k, h in eng.request_hists.items()},
        }
        if eng.mesh is not None:
            out["mesh"] = eng.mesh.describe()
        if self.load_seconds is not None:
            # engine build vs decode-program capture (the JAX model's
            # replica-add decomposition); "none" where nothing was
            # captured, "no_depot" after a capture, "compiled" after one
            # under KFT_DEPOT (with the depot's counters)
            out["load_seconds"] = self.load_seconds
            out["precompile_seconds"] = self.precompile_seconds
            out["depot_outcome"] = eng.depot_outcome or "none"
            if self._depot_stats is not None:
                out["depot"] = self._depot_stats.snapshot()
        if eng.decode_graph is not None:
            g = eng.decode_graph
            out["decode_graph"] = {"capture_seconds": g.capture_seconds,
                                   "pool_bytes": g.pool_bytes,
                                   "replays_total": g.replays}
        if self.tier:
            # tier attribution: the /metrics renderer labels every family
            # of this replica with it
            out["tier"] = self.tier
        if self.disagg is not None:
            out["disagg"] = self.disagg.snapshot()
        return out

    def predict(self, request: InferRequest) -> InferResponse:
        arr = request.as_numpy()
        p = request.parameters
        text_in = arr.dtype.kind in ("U", "S", "O")
        if text_in and self.tokenizer is None:
            raise ValueError(
                f"model {self.name!r} has no tokenizer; send token ids")
        sampling = self._sampling(p)
        if text_in:
            texts = [str(t) for t in arr.reshape(-1)]
            prompts = [self.tokenizer.encode(t, bos=True) for t in texts]
        else:
            ids = arr if arr.ndim > 1 else arr[None, :]
            prompts = []
            for row in ids:
                prompt = [int(t) for t in row]
                # strip only TRAILING padding — pad_id may be a real token
                # elsewhere in the sequence
                while prompt and prompt[-1] == self.pad_id:
                    prompt.pop()
                prompts.append(prompt)
        # validate EVERY row (including its KV-block reservation, which
        # needs the sampling params) before enqueuing ANY: a mid-batch
        # rejection must not leave earlier rows generating with no caller
        # to collect them
        for prompt in prompts:
            self.engine.validate_prompt(prompt, sampling)
        stop = self._stop_strings(p)
        # trace context: the router/server span's traceparent rides the
        # request parameters; every row's queue span chains under it so
        # the whole request yields ONE trace across processes
        traceparent = p.get("traceparent")
        reqs = []
        with self._wake:
            for prompt in prompts:
                reqs.append(self.engine.add_request(
                    prompt, sampling, trace=traceparent))
            self._wake.notify_all()
        matchers: dict[int, _StopMatcher] = {}
        fed: dict[int, int] = {}
        if stop:
            for r in reqs:
                matchers[r.id] = _StopMatcher(self.tokenizer, stop)
                fed[r.id] = 0

        def _ready() -> bool:
            if self._shutdown:
                return True
            # stop-string watch runs on the waiter's wakeups (chunk
            # granularity): on a match the request aborts as a clean
            # "stop" and its slot frees immediately
            for r in reqs:
                m = matchers.get(r.id)
                if m is None or m.match_at is not None:
                    continue
                n = len(r.generated)
                if n > fed[r.id]:
                    if m.feed(r.generated[fed[r.id]:n]):
                        # even when the request already ended by length,
                        # output IS stop-truncated: report "stop"
                        r.stop_matched = True
                        if not r.done:
                            self.engine.abort([r])
                    fed[r.id] = n
            return all(r.done for r in reqs)

        with self._wake:
            self._wake.wait_for(_ready, timeout=self.request_timeout)
        if not all(r.done for r in reqs):
            # free the decode slots before surfacing the failure — otherwise
            # the timed-out requests occupy slots until max_tokens
            self.engine.abort(reqs)
            with self._wake:
                self._wake.notify_all()
            raise TimeoutError("generation did not finish")
        def _final(r):
            """(tokens, logprobs, text) with stop-string truncation applied:
            text cuts at the match start (stop excluded), tokens/logprobs to
            those fully before it."""
            m = matchers.get(r.id)
            if m is not None and m.match_at is not None:
                cut = m.token_cut
                return r.generated[:cut], r.logprobs[:cut], m.final_text
            toks = list(r.generated)
            return toks, list(r.logprobs), (
                self.tokenizer.decode(toks)
                if text_in and self.tokenizer is not None else None)

        finals = [_final(r) for r in reqs]
        lengths = np.asarray([len(t) for t, _, _ in finals], np.int32)
        outputs: dict[str, np.ndarray] = {}
        if text_in:
            outputs["text"] = np.asarray(
                [txt for _, _, txt in finals], dtype=object)
        max_new = max(1, max(len(t) for t, _, _ in finals))
        tokens = np.full((len(reqs), max_new), self.pad_id, np.int32)
        for i, (toks, _, _) in enumerate(finals):
            tokens[i, :len(toks)] = toks
        outputs["tokens"] = tokens
        outputs["lengths"] = lengths
        if p.get("logprobs"):
            lp = np.zeros((len(reqs), max_new), np.float32)
            for i, (_, lps, _) in enumerate(finals):
                lp[i, :len(lps)] = lps
            outputs["logprobs"] = lp
        return InferResponse.from_numpy(self.name, outputs, id=request.id)

    def generate_stream(self, inputs, parameters: Optional[dict] = None):
        """Incremental generation (the SSE data plane): returns an iterator
        of ``{"tokens": [...], "text_delta": str?}`` chunks as the engine
        decodes (chunk granularity = engine decode_chunk), then a final
        ``{"done": True, "finish_reason": ..., "length": N}``. Closing the
        iterator aborts the request and frees its slot.

        NOT itself a generator: validation and enqueue happen EAGERLY so a
        bad request raises here — before the transport commits to a 200 —
        instead of on the first next()."""
        p = parameters or {}
        if isinstance(inputs, str):
            if self.tokenizer is None:
                raise ValueError(
                    f"model {self.name!r} has no tokenizer; send token ids")
            prompt = self.tokenizer.encode(inputs, bos=True)
            text_out = True
        else:
            prompt = [int(t) for t in inputs]
            text_out = self.tokenizer is not None
        sampling = self._sampling(p)
        stop = self._stop_strings(p)
        with self._wake:
            # add_request validates eagerly (prompt + KV reservation) in
            # THIS thread — a bad request raises before any 200 commits
            req = self.engine.add_request(prompt, sampling,
                                          trace=p.get("traceparent"))
            self._wake.notify_all()
        return self._stream_events(req, text_out, stop,
                                   want_logprobs=bool(
                                       p.get("logprobs")))

    def _stream_events(self, req, text_out: bool, stop: list[str],
                       want_logprobs: bool = False):
        """With stop strings, text deltas are exact (held back behind any
        possible partial match) and the final ``length`` is the authoritative
        truncated token count — a stop straddling a chunk boundary may have
        already streamed a few of its leading tokens in the prior chunk, so
        token reassembly should cut to ``length``."""
        import codecs

        # incremental utf-8: token->bytes is context-free, and the decoder
        # buffers split multi-byte characters across chunks — prefix-stable
        # deltas in O(n) total, unlike re-decoding the whole prefix
        utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        # with stop strings, the matcher owns the text and deltas hold back
        # the last len(stop)-1 chars so a stop split across chunks can
        # never leak its prefix to the client
        matcher = (_StopMatcher(self.tokenizer, stop)
                   if stop and text_out else None)
        sent = 0
        emitted = 0
        tokens_emitted = 0
        deadline = time.time() + self.request_timeout
        try:
            while True:
                with self._wake:
                    self._wake.wait_for(
                        lambda: len(req.generated) > sent or req.done
                        or self._shutdown,
                        timeout=max(0.0, deadline - time.time()))
                if self._shutdown or (
                        time.time() >= deadline and not req.done):
                    self.engine.abort([req])
                    raise TimeoutError("generation did not finish")
                if len(req.generated) > sent:
                    # the engine appends generated then logprobs; cap the
                    # read at what BOTH lists cover so a mid-append wakeup
                    # can never mis-pair the stream (the straggler token
                    # flushes on the next wake)
                    n_avail = len(req.generated)
                    if want_logprobs:
                        n_avail = min(n_avail, len(req.logprobs))
                        if n_avail <= sent and not req.done:
                            continue
                    new = list(req.generated[sent:n_avail])
                    new_lps = list(req.logprobs[sent:n_avail])
                    sent = n_avail
                    chunk = {"tokens": new}
                    if want_logprobs:
                        chunk["logprobs"] = new_lps
                    if matcher is not None:
                        if matcher.feed(new):
                            req.stop_matched = True
                            if not req.done:
                                self.engine.abort([req])
                                with self._wake:
                                    self._wake.notify_all()
                        # token stream truncates like predict(): never emit
                        # tokens at/after the match
                        keep = matcher.token_cut - tokens_emitted
                        chunk["tokens"] = new[:max(0, keep)]
                        if want_logprobs:
                            chunk["logprobs"] = new_lps[:len(chunk["tokens"])]
                        tokens_emitted += len(chunk["tokens"])
                        safe = matcher.safe_len
                        chunk["text_delta"] = matcher.text[emitted:safe]
                        emitted = safe
                    elif text_out:
                        chunk["text_delta"] = utf8.decode(
                            self.tokenizer.decode_bytes(new),
                            final=req.done)
                    if chunk["tokens"] or chunk.get("text_delta"):
                        yield chunk
                if req.done:
                    if matcher is not None:
                        matcher.finish()
                        tail = matcher.final_text[emitted:]
                        if tail:
                            yield {"tokens": [], "text_delta": tail}
                        length = matcher.token_cut
                    else:
                        if text_out:
                            # a race between the last token chunk and the
                            # done flag can leave buffered partial bytes
                            tail = utf8.decode(b"", final=True)
                            if tail:
                                yield {"tokens": [], "text_delta": tail}
                        length = len(req.generated)
                    yield {"done": True, "finish_reason": req.finish_reason,
                           "length": length}
                    return
        finally:
            if not req.done:
                # client went away mid-stream: free the decode slot
                self.engine.abort([req])
                with self._wake:
                    self._wake.notify_all()
