"""LLM serving engine — continuous batching over the Llama decode path
(counterpart of ``kubeflow_tpu.serving.llm``).

- the KV cache is ONE block-paged pool (serving/paged_kv.py) updated in
  place; slots own block tables;
- prompts prefill into padded length buckets and their KV rows are
  inserted into the pool in one scatter per admission batch; prompts
  longer than the largest bucket stream through chunked prefill,
  interleaved with decode;
- every dispatch runs ``decode_chunk`` decode+sample steps over all slots
  on the device; requests join and leave between dispatches;
- sampling (greedy/temperature/top-k/top-p) runs on the device with the
  engine's own ``torch.Generator``, so only sampled token ids cross back
  to the host;
- quantized serving (``quant=``, serving/quant.py): int8 weights are
  quantized once at build, int8/fp8 KV pools quantize on insert and on
  write, and decode reads them through the fused-dequant kernel.

Pipelined decode keeps the JAX engine's structure: chunk N+1 is
dispatched before chunk N's tokens are read back. CUDA launches are
asynchronous, so the device runs chunk N while the host launches N+1;
chunk N's tokens travel through a pinned buffer and an event, so the
read-back waits for chunk N only.

Not in this slice (each raises or is absent, never quietly different):
the executable depot (``precompile``), speculative decoding
(``spec_decode=True`` raises), the disaggregated hold/export/inject
methods, tensor-parallel meshes.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs import trace as obs_trace
from kubeflow_tpu_torch.obs.histogram import Histogram, log_buckets
from kubeflow_tpu_torch.serving.paged_kv import (
    PagedKV, _lm_head, blocks_for, paged_decode_step, paged_insert_batch,
    paged_prefill_chunk, resolve_decode_kernel,
)
from kubeflow_tpu_torch.serving.quant import (
    is_weight_quantized, quantize_weights, resolve_quant,
)
from kubeflow_tpu_torch.serving.scheduler import (
    QuantConfig, SchedulerConfig, StepScheduler,
)

logger = logging.getLogger(__name__)

# Request-latency buckets at factor 2**0.25 (~19% relative error), the
# JAX engine's choice: A/B comparisons discriminate inside one octave.
_REQ_LAT_BUCKETS = log_buckets(0.001, 64.0, factor=2 ** 0.25)

SPEC_SLICE = ("speculative decoding (paged_verify_step + drafter) is a "
              "later slice of the PyTorch port")

# downgrade reasons already logged this process: counted per engine
# (kft_model_kernel_downgrades_total) but LOGGED once — a fleet restarting
# many replicas must not print one identical warning each
_downgrades_logged: set = set()


def _log_quant_downgrade_once(requested: str, reason: str) -> None:
    """A quant fallback is never a silent dtype change: the message says
    which mode the engine is NOT serving at."""
    if reason in _downgrades_logged:
        return
    _downgrades_logged.add(reason)
    logger.warning(
        "quant mode %s downgraded to unquantized (%s): serving at full "
        "bytes-per-weight / bytes-per-KV-token", requested, reason)


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = off
    top_p: float = 1.0                # 1 = off
    eos_id: Optional[int] = None
    # any of these ends generation like eos (finish_reason "stop"); text
    # stop STRINGS live a layer up in LLMModel, which owns the tokenizer
    stop_token_ids: tuple = ()


@dataclasses.dataclass
class GenRequest:
    id: int
    prompt: list[int]
    sampling: SamplingParams
    generated: list[int] = dataclasses.field(default_factory=list)
    # per-generated-token logprob under the model distribution
    logprobs: list[float] = dataclasses.field(default_factory=list)
    done: bool = False
    aborted: bool = False
    # set by a text-level stop-string watcher before aborting: the abort
    # then reads as a clean "stop" finish, not a client disconnect
    stop_matched: bool = False
    slot: Optional[int] = None
    # observability: trace context ((trace_id, span_id) of the queue
    # span), wall-clock latency marks feeding the request histograms, and
    # the live span handles the engine closes as the request advances
    trace: Optional[tuple] = None
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    t_last_commit: float = 0.0
    t_done: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)

    @property
    def finish_reason(self) -> str:
        if self.stop_matched:
            return "stop"
        if self.aborted:
            return "abort"
        if self.generated and (
                (self.sampling.eos_id is not None
                 and self.generated[-1] == self.sampling.eos_id)
                or self.generated[-1] in self.sampling.stop_token_ids):
            return "stop"
        return "length"


@dataclasses.dataclass
class _ChunkedPrefill:
    """A long prompt streaming through chunked prefill across engine
    steps. ``offset`` is the next position to prefill; positions <
    ``share_len`` are radix-shared; ``tables`` is the device snapshot of
    the block tables taken at reservation."""

    req: GenRequest
    offset: int
    share_len: int
    tables: Any
    x_last: Any = None


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy pick with an EXPLICIT lowest-index tie-break: the minimum
    index among the maximizers, decided by value comparison alone, so
    every greedy path breaks exact ties the same way on the same values
    (``torch.argmax`` makes no such promise across devices). [..., V] ->
    [...] int32."""
    vocab = logits.shape[-1]
    is_max = logits == logits.amax(dim=-1, keepdim=True)
    idx = torch.arange(vocab, device=logits.device, dtype=torch.int32)
    return torch.where(is_max, idx, vocab).amin(dim=-1).to(torch.int32)


def sample_logits(logits, generator: torch.Generator, temperature, top_k,
                  top_p, greedy_only: bool = False):
    """On-device sampling: greedy where temperature == 0, else
    temperature/top-k/top-p, with the random draws from ``generator``
    (which lives on the logits' device). temperature/top_k/top_p are [B]
    tensors; top_k == 0 / top_p == 1 disable the respective filter; top-p
    applies to the top-k-masked distribution. ``greedy_only`` skips the
    full-vocab sort."""
    vocab = logits.shape[-1]
    greedy = greedy_argmax(logits)
    if greedy_only:
        return greedy
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    sorted_asc = torch.sort(scaled, dim=-1).values
    # top-k: kth-largest value per row; rows with top_k == 0 keep all
    k_idx = (vocab - top_k.long()).clamp(0, vocab - 1)
    kth = sorted_asc.gather(-1, k_idx[:, None])
    kth = torch.where((top_k > 0)[:, None], kth, neg_inf)
    scaled = torch.where(scaled < kth, neg_inf, scaled)
    # top-p over the top-k-masked distribution, from the same sort
    sorted_desc = torch.where(sorted_asc < kth, neg_inf,
                              sorted_asc).flip(-1)
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(-1).clamp(max=vocab - 1)
    cutoff = sorted_desc.gather(-1, cutoff_idx[:, None])
    scaled = torch.where(scaled < cutoff, neg_inf, scaled)
    # Gumbel-max draw of the categorical over the surviving logits
    u = torch.rand(scaled.shape, generator=generator,
                   device=logits.device).clamp_(min=1e-20)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature > 0, sampled.to(torch.int32), greedy)


def chosen_logprob(logits, tok):
    """log softmax(logits)[tok] without materializing the [B, V] log
    softmax (OpenAI convention: pre-temperature/filtering)."""
    return (logits.gather(-1, tok.long()[:, None])[:, 0]
            - torch.logsumexp(logits, dim=-1))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMEngine:
    """Continuous-batching generation over the paged prefill/decode path.

    Runs on ``device`` (resolved by ``device.resolve_device``: CUDA
    unless ``"cpu"`` is asked for; raises with no GPU and no request).
    ``params`` move there if they are elsewhere. ``kernel``: the decode
    attention path (serving/paged_kv.resolve_decode_kernel)."""

    def __init__(self, params, cfg: llama.LlamaConfig, *,
                 max_batch: int = 8, max_seq: int = 1024,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512),
                 kv_block_size: Optional[int] = None,
                 kv_num_blocks: Optional[int] = None,
                 decode_chunk: int = 8,
                 decode_pipeline: bool = True,
                 kernel: str = "auto",
                 scheduler: Optional[SchedulerConfig] = None,
                 quant: Optional[QuantConfig] = None,
                 obs: Optional[obs_trace.SpanCollector] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        llama.check_dense(cfg)
        self.cfg = cfg
        self.kernel = resolve_decode_kernel(kernel)
        self.kernel_downgrades = 0
        # quantized serving: resolve the requested config against the
        # build/model. A mode that can't be honored (no fp8 dtype, MoE
        # weights) falls back to unquantized, counted on the kernel
        # downgrade surface as well as its own, logged once per process.
        # The explicit quant= argument wins over the scheduler's copy.
        if quant is None and scheduler is not None:
            quant = scheduler.quant
        self.quant_requested = quant
        self.quant, quant_downgrades = resolve_quant(quant, cfg=cfg)
        self.quant_downgrades = len(quant_downgrades)
        self.kernel_downgrades += self.quant_downgrades
        for q_requested, q_reason in quant_downgrades:
            _log_quant_downgrade_once(q_requested, q_reason)
        params = _tree_to(params, self.device)
        if (self.quant.weight_dtype == "int8"
                and not is_weight_quantized(params)):
            # quantize ONCE at build: decode, chunked prefill and bucket
            # prefill all read the same int8 tree
            params = quantize_weights(params, cfg)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.buckets = sorted(b for b in prefill_buckets if b <= max_seq)
        if not self.buckets:
            raise ValueError("no prefill bucket fits max_seq")
        # block size must divide max_seq and every bucket (prefill writes
        # whole blocks); the default is the largest power of 2 <= 64 that
        # does
        if kv_block_size is None:
            kv_block_size = 1
            while (kv_block_size < 64
                   and max_seq % (kv_block_size * 2) == 0
                   and all(b % (kv_block_size * 2) == 0
                           for b in self.buckets)):
                kv_block_size *= 2
        for b in self.buckets + [max_seq]:
            if b % kv_block_size:
                raise ValueError(
                    f"kv_block_size={kv_block_size} must divide max_seq and "
                    f"every prefill bucket (got {b})")
        if kv_num_blocks is None:
            kv_num_blocks = max_batch * (max_seq // kv_block_size) + 1
        self.paged = PagedKV(cfg=cfg, max_batch=max_batch, max_seq=max_seq,
                             block_size=kv_block_size,
                             num_blocks=kv_num_blocks, device=self.device,
                             quant_kv=self.quant.kv_dtype)
        self.cache = self.paged.cache
        self._free: list[int] = list(range(max_batch))
        self._active: dict[int, GenRequest] = {}     # slot -> request
        self._waiting: list[GenRequest] = []
        self._aborted: set[int] = set()              # request ids to retire
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._tokens = np.zeros((max_batch,), np.int32)   # next input token
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(0)
        self.steps = 0
        self.generated_tokens = 0
        self.prefill_dispatches = 0
        # multi-step decode: one dispatch runs `decode_chunk` decode+sample
        # steps; requests finishing mid-chunk are trimmed on the host (their
        # overshoot writes land in their own blocks or the scratch block)
        self.decode_chunk = max(1, int(decode_chunk))
        # double-buffered decode (module docstring); the next chunk's input
        # token is the DEVICE-side carry, overridden per slot by fresh host
        # tokens (admissions since that dispatch)
        self.decode_pipeline = bool(decode_pipeline)
        self._inflight: Optional[dict] = None
        self._fresh = np.ones((max_batch,), bool)
        self.sched = StepScheduler(scheduler, default_budget=self.buckets[-1],
                                   decode_chunk=self.decode_chunk)
        if self.sched.cfg.spec_decode:
            raise NotImplementedError(SPEC_SLICE)
        self.obs = obs or obs_trace.collector()
        self.request_hists = {"ttft": Histogram(_REQ_LAT_BUCKETS),
                              "itl": Histogram(_REQ_LAT_BUCKETS),
                              "e2e": Histogram(_REQ_LAT_BUCKETS)}
        self.paged.prefix_cache = self.sched.cfg.radix_cache
        # in-flight chunked prefills, slot -> state (insertion order = FIFO)
        self._chunked: dict[int, _ChunkedPrefill] = {}
        # chunk width: the largest bucket, capped by the quota so one
        # chunk always fits one step's budget
        self._chunk_width = max(1, min(self.buckets[-1],
                                       self.sched.prefill_budget()))

    # ---------------- device helpers ----------------

    def _dev(self, arr) -> torch.Tensor:
        """Host numpy -> a device tensor (a copy: the host array may change
        right after)."""
        return torch.tensor(arr, device=self.device)

    def _start_readback(self, *tensors):
        """Begin copying device tensors to the host without waiting: pinned
        buffers + an event on CUDA, so a later read waits for exactly the
        work that produced them."""
        if self.device.type != "cuda":
            return list(tensors), None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _finish_readback(host, event) -> list[np.ndarray]:
        if event is not None:
            event.synchronize()
        return [h.numpy() for h in host]

    # ---------------- device bodies ----------------

    def _decode_impl(self, token, tables, active, temperature, top_k,
                     top_p, greedy_only: bool, chunk_len: int):
        """``chunk_len`` decode+sample steps over every slot. Returns
        (toks [chunk, B], lps [chunk, B], next_tok [B]) on the device."""
        toks, lps = [], []
        for _ in range(chunk_len):
            logits, self.cache = paged_decode_step(
                self.params, token, self.cfg, self.cache, tables,
                kernel=self.kernel)
            nxt = sample_logits(logits, self._rng, temperature, top_k,
                                top_p, greedy_only=greedy_only)
            lps.append(chosen_logprob(logits, nxt))
            toks.append(nxt)
            # idle slots: pin len to 0 so the cursor can't creep toward
            # max_seq (their scatter lands in the scratch block 0)
            self.cache["len"] = torch.where(active, self.cache["len"], 0)
            token = nxt
        return torch.stack(toks), torch.stack(lps), token

    # ---------------- public API ----------------

    def validate_prompt(self, prompt: Sequence[int],
                        sampling: Optional[SamplingParams] = None) -> None:
        """Raise if the prompt can't be served. Called by add_request; also
        callable up front to vet a whole batch before enqueuing any of it."""
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + 1 > self.max_seq:
            raise ValueError(f"prompt too long for max_seq={self.max_seq}")
        if sampling is not None:
            # a reservation that can NEVER succeed must fail fast here
            need = min(
                blocks_for(len(prompt) + sampling.max_tokens,
                           self.paged.block_size),
                self.paged.max_blocks_per_seq)
            usable = self.paged.num_blocks - 1       # block 0 is scratch
            if need > usable:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only has "
                    f"{usable}; raise kv_num_blocks or lower max_tokens")

    def add_request(self, prompt: Sequence[int],
                    sampling: Optional[SamplingParams] = None,
                    trace: Optional[str] = None) -> GenRequest:
        """``trace``: an incoming W3C traceparent (router/server span) —
        the request's queue span roots under it."""
        sampling = sampling or SamplingParams()
        self.validate_prompt(prompt, sampling)
        req = GenRequest(id=next(self._ids), prompt=list(map(int, prompt)),
                         sampling=sampling)
        req.t_enqueue = time.time()
        qspan = self.obs.start(
            "request.queue", parent=trace,
            attrs={"request_id": req.id, "prompt_tokens": len(req.prompt)})
        req.spans["queue"] = qspan
        req.trace = (qspan.trace_id, qspan.span_id)
        with self._lock:
            self._waiting.append(req)
        return req

    def abort(self, reqs: Sequence[GenRequest]) -> None:
        """Give up on requests: waiting ones leave the queue immediately;
        active ones release their slot at the start of the next step."""
        ids = set()
        for r in reqs:
            r.aborted = True
            r.done = True
            ids.add(r.id)
            for sp in r.spans.values():
                if sp.t1 is None:
                    self.obs.end(sp, aborted=True)
        with self._lock:
            self._waiting = [r for r in self._waiting if r.id not in ids]
            self._aborted.update(ids)

    # ---------------- observability hooks ----------------

    def _end_queue_span(self, req: GenRequest, slot: int,
                        n_shared: int) -> None:
        sp = req.spans.get("queue")
        if sp is not None and sp.t1 is None:
            self.obs.end(sp, slot=slot, shared_blocks=n_shared)

    def _dispatch_span(self, name: str, reqs: Sequence[GenRequest],
                       **attrs) -> Any:
        """Engine-level span owned by ONE trace when every covered request
        shares it, else top-level with the ids in ``attrs.trace_ids``."""
        tids = sorted({r.trace[0] for r in reqs if r.trace})
        kw: dict = {}
        if len(tids) == 1:
            kw["trace_id"] = tids[0]
            if len(reqs) == 1 and reqs[0].spans.get("queue") is not None:
                kw["parent"] = reqs[0].spans["queue"]
        elif tids:
            attrs["trace_ids"] = tids
        return self.obs.start(name, attrs=attrs, **kw)

    def _note_request_latency(self, req: GenRequest, n_new: int) -> None:
        """Feed the request histograms after committing ``n_new`` tokens in
        one read-back: the first token closes TTFT; later commits spread
        the read-back gap evenly over the chunk's tokens."""
        if n_new <= 0:
            return
        now = time.time()
        if req.t_first_token == 0.0:
            req.t_first_token = now
            if req.t_enqueue:
                self.request_hists["ttft"].observe(now - req.t_enqueue)
            n_new -= 1
        if n_new > 0 and req.t_last_commit:
            gap = max(0.0, now - req.t_last_commit) / n_new
            itl = self.request_hists["itl"]
            for _ in range(n_new):
                itl.observe(gap)
        req.t_last_commit = now

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._waiting or self._active or self._chunked)

    def scheduler_stats(self) -> dict:
        with self._lock:
            waiting = len(self._waiting)
            backlog = sum(len(r.prompt) + r.sampling.max_tokens
                          for r in self._waiting)
        backlog += sum(max(0, len(st.req.prompt) - st.offset)
                       for st in list(self._chunked.values()))
        return self.sched.snapshot(
            active=len(self._active), waiting=waiting,
            chunked=len(self._chunked), max_batch=self.max_batch,
            prefix_hits=self.paged.prefix_hits,
            prefix_queries=self.paged.prefix_queries,
            backlog_tokens=backlog)

    def step(self) -> list[GenRequest]:
        """Admit waiting requests, dispatch one decode chunk, retire
        finished. Pipelined (default): the dispatch goes out BEFORE the
        previous chunk's tokens are read, so results lag one chunk.
        Returns requests that finished this step."""
        self.sched.note_step()
        with self._lock:
            aborted, self._aborted = self._aborted, set()
        if aborted:
            for slot, req in list(self._active.items()):
                if req.id in aborted:
                    del self._active[slot]
                    self.paged.release(slot)
                    self._free.append(slot)
            for slot, st in list(self._chunked.items()):
                if st.req.id in aborted:
                    self._cancel_chunked(slot)
        self._admit()
        new_inflight = None
        if self._active and self._need_dispatch():
            active_mask = np.zeros((self.max_batch,), bool)
            temp = np.zeros((self.max_batch,), np.float32)
            top_k = np.zeros((self.max_batch,), np.int32)
            top_p = np.ones((self.max_batch,), np.float32)
            for slot, req in self._active.items():
                active_mask[slot] = True
                temp[slot] = req.sampling.temperature
                top_k[slot] = req.sampling.top_k
                top_p[slot] = req.sampling.top_p
            if self._inflight is None or self._fresh.all():
                token_in = self._dev(self._tokens)
            else:
                # device carry from the in-flight chunk; fresh host tokens
                # (admissions since that dispatch) override their slots
                token_in = torch.where(self._dev(self._fresh),
                                       self._dev(self._tokens),
                                       self._inflight["next"])
            self._fresh[:] = False
            chunk_len = self.sched.decode_chunk_len(
                self._min_deterministic_remaining(),
                pressure=bool(self._waiting))
            self.sched.note_decode_dispatch(chunk_len)
            dspan = self._dispatch_span(
                "decode.step", [r for _, r in self._active.items()],
                chunk_len=chunk_len, batch=len(self._active))
            toks, lps, next_tok = self._decode_impl(
                token_in, self._dev(self._dispatch_tables()),
                self._dev(active_mask), self._dev(temp), self._dev(top_k),
                self._dev(top_p), greedy_only=not bool((temp > 0).any()),
                chunk_len=chunk_len)
            host, event = self._start_readback(toks, lps)
            new_inflight = {
                "host": host, "event": event, "next": next_tok,
                "chunk_len": chunk_len, "span": dspan,
                # tokens belong to the requests active at DISPATCH time
                "snapshot": list(self._active.items()),
            }
        prev, self._inflight = self._inflight, new_inflight
        finished = self._process_chunk(prev) if prev is not None else []
        if not self.decode_pipeline and self._inflight is not None:
            flush, self._inflight = self._inflight, None
            finished += self._process_chunk(flush)
        return finished

    def _need_dispatch(self) -> bool:
        """Skip the next dispatch when the in-flight chunk already covers
        every active request's remaining budget."""
        if self._inflight is None:
            return True
        snapshot_reqs = {id(r) for _, r in self._inflight["snapshot"]}
        chunk = self._inflight["chunk_len"]
        for _, req in self._active.items():
            if id(req) not in snapshot_reqs:
                return True
            if (len(req.generated) + chunk < req.sampling.max_tokens
                    and len(req.prompt) + len(req.generated) + chunk
                    < self.max_seq):
                return True
        return False

    def _min_deterministic_remaining(self) -> Optional[int]:
        """Earliest deterministic finish (max_tokens / max_seq bound) among
        active requests, net of the in-flight chunk's tokens."""
        snapshot_reqs = (
            {id(r) for _, r in self._inflight["snapshot"]}
            if self._inflight is not None else set())
        pending = (self._inflight["chunk_len"]
                   if self._inflight is not None else 0)
        rem = None
        for _, req in self._active.items():
            r = min(req.sampling.max_tokens - len(req.generated),
                    self.max_seq - len(req.prompt) - len(req.generated))
            if id(req) in snapshot_reqs:
                r -= pending
            r = max(1, r)
            rem = r if rem is None else min(rem, r)
        return rem

    def _commit_token(self, req, slot: int, tok: int, lp: float) -> bool:
        """Append ONE committed token and report whether it finishes the
        request (eos / stop ids / max_tokens / max_seq)."""
        req.generated.append(tok)
        req.logprobs.append(lp)
        self.generated_tokens += 1
        self._tokens[slot] = tok
        eos = req.sampling.eos_id
        return ((eos is not None and tok == eos)
                or tok in req.sampling.stop_token_ids
                or len(req.generated) >= req.sampling.max_tokens
                or len(req.prompt) + len(req.generated) >= self.max_seq)

    def _retire(self, req, slot: int) -> None:
        req.done = True
        req.t_done = time.time()
        if not req.aborted and req.t_enqueue:
            self.request_hists["e2e"].observe(req.t_done - req.t_enqueue)
        if self._active.get(slot) is req:
            del self._active[slot]
            self.paged.release(slot)
            self._free.append(slot)

    def _dispatch_tables(self) -> np.ndarray:
        """Block tables for a decode dispatch: mid-prefill slots' rows
        zeroed so their idle scatter lands in the scratch block, never a
        half-prefilled prompt block."""
        tab = self.paged.tables
        if self._chunked:
            tab = tab.copy()
            for s in self._chunked:
                tab[s] = 0
        return tab

    def _process_chunk(self, inflight: dict) -> list[GenRequest]:
        toks, lps = self._finish_readback(inflight["host"],
                                          inflight["event"])
        self.steps += toks.shape[0]
        finished = []
        committed_total = 0
        for slot, req in inflight["snapshot"]:
            if req.done:
                continue               # aborted/retired after dispatch
            n0 = len(req.generated)
            done = False
            for t in range(toks.shape[0]):
                if self._commit_token(req, slot, int(toks[t, slot]),
                                      float(lps[t, slot])):
                    done = True
                    break
            n_new = len(req.generated) - n0
            committed_total += n_new
            self._note_request_latency(req, n_new)
            if done:
                finished.append(req)
                self._retire(req, slot)
        span = inflight.get("span")
        if span is not None:
            self.obs.end(span, tokens_committed=committed_total,
                         device_steps=int(toks.shape[0]))
        return finished

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling: Optional[SamplingParams] = None,
                 ) -> list[GenRequest]:
        """Synchronous batch API: submit all, step until drained."""
        reqs = [self.add_request(p, sampling) for p in prompts]
        while self.has_work():
            self.step()
        return reqs

    # ---------------- internals ----------------

    def _start_chunked(self, req, slot: int, n_shared: int) -> None:
        """Begin streaming a long prompt through chunked prefill; chunks
        whose every row is radix-shared are skipped outright."""
        L = len(req.prompt)
        W = self._chunk_width
        share_len = n_shared * self.paged.block_size
        start = min((share_len // W) * W, ((L - 1) // W) * W)
        self._chunked[slot] = _ChunkedPrefill(
            req=req, offset=start, share_len=share_len,
            tables=self._dev(self.paged.tables))
        self.sched.note_chunked_started()

    def _advance_chunked(self, slot: int) -> int:
        """One prefill chunk for the slot's long prompt; the final chunk
        also runs the lm head + first-token sample and publishes the
        slot's cache len. Returns the budget tokens consumed."""
        st = self._chunked[slot]
        req = st.req
        L = len(req.prompt)
        W = self._chunk_width
        pspan = self._dispatch_span(
            "prefill.chunk", [req], slot=slot, offset=st.offset,
            width=W, prompt_tokens=L)
        piece = np.zeros((1, W), np.int32)
        part = req.prompt[st.offset:st.offset + W]
        piece[0, :len(part)] = part
        st.x_last, self.cache = paged_prefill_chunk(
            self.params, self._dev(piece), self.cfg, self.cache, st.tables,
            slot, st.offset, L, st.share_len)
        st.offset += W
        self.sched.note_prefill_chunk(W)
        self.obs.end(pspan, final=st.offset >= L)
        # publish completed read-only blocks: every position < offset is
        # written and its write enqueued, so a later sharer's reads are
        # stream-ordered behind the content
        self.paged.publish_prompt_blocks(slot, req.prompt,
                                         min(st.offset, L))
        if st.offset >= L:
            logits = _lm_head(self.params, st.x_last, self.cfg)
            tok, lp = self._sample_rows(logits, [req])
            self.cache["len"][slot] = L
            del self._chunked[slot]
            self.sched.note_chunked_admitted()
            self._post_admit(req, slot, int(tok[0]), float(lp[0]))
        return W

    def _chunked_phase(self, interleave: bool, budget: int,
                       spent: int) -> int:
        """Advance in-flight chunked prefills, oldest first: ONE chunk per
        step when interleaving, to completion otherwise."""
        while self._chunked and (spent < budget or not interleave):
            slot = next(iter(self._chunked))
            if self._chunked[slot].req.aborted:
                self._cancel_chunked(slot)
                continue
            spent += self._advance_chunked(slot)
            if interleave:
                break
        return spent

    def _cancel_chunked(self, slot: int) -> None:
        del self._chunked[slot]
        self.paged.release(slot)
        self._free.append(slot)
        self.sched.note_preempt()

    def _admit(self) -> None:
        """The scheduler's prefill phase: spend this step's token quota on
        one chunk of the oldest in-flight chunked prefill, then on
        admissions (the first unit always runs)."""
        bs = self.paged.block_size
        budget = self.sched.prefill_budget()
        interleave = self.sched.cfg.interleave_prefill
        spent = self._chunked_phase(interleave, budget, 0)
        if self._chunked and interleave:
            return
        while spent < budget or spent == 0:
            with self._lock:
                if not self._waiting or not self._free:
                    return
                req = self._waiting.pop(0)
                slot = self._free.pop()
            # reserve every block the request can ever touch; an exhausted
            # pool keeps the request at the HEAD of the queue (FIFO)
            chunked = len(req.prompt) > self.buckets[-1]
            n_shared = self.paged.reserve(
                slot, len(req.prompt), req.sampling.max_tokens,
                min_blocks=blocks_for(len(req.prompt), bs),
                prompt=req.prompt, defer_publish=chunked)
            if n_shared is None:
                with self._lock:
                    self._waiting.insert(0, req)
                self._free.append(slot)
                self.sched.note_stall()
                return
            self._end_queue_span(req, slot, n_shared)
            if chunked:
                self._start_chunked(req, slot, n_shared)
                spent = self._chunked_phase(interleave, budget, spent)
                if self._chunked and interleave:
                    return
                continue
            # batched admission: the FIFO prefix of same-bucket requests
            # shares ONE prefill + insert + sample
            bucket = _bucket(len(req.prompt), self.buckets)
            batch = [(req, slot, n_shared)]
            while len(batch) < self.max_batch:
                with self._lock:
                    if not self._waiting or not self._free:
                        break
                    nxt = self._waiting[0]
                    if len(nxt.prompt) > self.buckets[-1] or \
                            _bucket(len(nxt.prompt),
                                    self.buckets) != bucket:
                        break
                    self._waiting.pop(0)
                    s2 = self._free.pop()
                ns2 = self.paged.reserve(
                    s2, len(nxt.prompt), nxt.sampling.max_tokens,
                    min_blocks=blocks_for(len(nxt.prompt), bs),
                    prompt=nxt.prompt)
                if ns2 is None:
                    with self._lock:
                        self._waiting.insert(0, nxt)
                    self._free.append(s2)
                    self.sched.note_stall()
                    break
                self._end_queue_span(nxt, s2, ns2)
                batch.append((nxt, s2, ns2))
            self._admit_prefill_batch(batch, bucket)
            self.sched.note_admitted(len(batch))
            spent += bucket * len(batch)

    def _admit_prefill_batch(self, batch, bucket: int) -> None:
        """One prefill + insert + first-token sample for a same-bucket
        admission batch. Rows pad to the next power of two; pad rows
        carry slot -1 and their writes land in the scratch block / are
        dropped."""
        bs = self.paged.block_size
        width = min(self.max_batch, 1 << (len(batch) - 1).bit_length())
        nbmax = bucket // bs
        toks = np.zeros((width, bucket), np.int32)
        lengths = np.zeros((width,), np.int32)
        blk = np.zeros((width, nbmax), np.int32)
        slots = np.full((width,), -1, np.int32)
        for i, (req, slot, n_shared) in enumerate(batch):
            toks[i, :len(req.prompt)] = req.prompt
            lengths[i] = len(req.prompt)
            nb_prefill = blocks_for(len(req.prompt), bs)
            ids = self.paged.slot_blocks(slot)
            blk[i, n_shared:nb_prefill] = ids[n_shared:nb_prefill]
            slots[i] = slot
        scratch = llama.init_cache(self.cfg, width, bucket,
                                   device=self.device)
        self.prefill_dispatches += 1
        pspan = self._dispatch_span(
            "prefill.batch", [r for r, _, _ in batch],
            bucket=bucket, batch=len(batch))
        lengths_dev = self._dev(lengths)
        logits, filled = llama.prefill(
            self.params, self._dev(toks), self.cfg, scratch,
            lengths=lengths_dev)
        paged_insert_batch(self.cache, filled["k"], filled["v"],
                           self._dev(blk), lengths_dev, self._dev(slots))
        tok, lp = self._sample_rows(logits, [r for r, _, _ in batch],
                                    width=width)
        self.obs.end(pspan)
        for i, (req, slot, _) in enumerate(batch):
            self._post_admit(req, slot, int(tok[i]), float(lp[i]))

    def _sample_rows(self, logits, reqs, width: Optional[int] = None):
        """First-token sampling for admission rows -> host (tok, lp)."""
        width = width or len(reqs)
        temp = np.zeros((width,), np.float32)
        top_k = np.zeros((width,), np.int32)
        top_p = np.ones((width,), np.float32)
        for i, r in enumerate(reqs):
            temp[i] = r.sampling.temperature
            top_k[i] = r.sampling.top_k
            top_p[i] = r.sampling.top_p
        tok = sample_logits(logits, self._rng, self._dev(temp),
                            self._dev(top_k), self._dev(top_p))
        lp = chosen_logprob(logits, tok)
        return tok.cpu().numpy(), lp.cpu().numpy()

    def _post_admit(self, req, slot: int, first_tok: int,
                    first_lp: float) -> None:
        """Bookkeeping after a request's KV is resident: the prefill-
        sampled token is generation token #1; decode continues from it
        (or the request finishes at once on eos/budget)."""
        req.slot = slot
        self._fresh[slot] = True       # override any device token carry
        self._active[slot] = req
        done = self._commit_token(req, slot, first_tok, first_lp)
        self._note_request_latency(req, 1)       # TTFT closes here
        if done:
            self._retire(req, slot)
