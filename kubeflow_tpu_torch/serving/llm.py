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
  write, and decode reads them through the fused-dequant kernel;
- tensor-parallel serving (``mesh=``, a ``parallel.mesh.TensorMesh`` of
  tp ranks): this engine is rank 0 and spawns the other ranks, each an
  ``LLMEngine`` on its shard of the weights and of the KV heads. The
  device bodies (``_body_*``) take host inputs only; ``_run`` sends each
  one to every rank (serving/tp.py) and runs it here. Every rank samples
  the same all-gathered logits with the same seeded generator, and folds
  the tokens it sampled into a running digest on its device (no
  collective, no readback); ``tp_status`` reports each rank's digest,
  so a caller checks that the ranks agree;
- speculative decoding (``SchedulerConfig(spec_decode=True)``): a
  host-side drafter (serving/spec_decode.py) proposes up to ``spec_k``
  tokens per stream, ONE verify dispatch (``paged_kv.paged_verify_step``)
  scores them all, and the longest prefix matching the target's greedy
  chain commits, plus the target's own next token — greedy streams equal
  the non-speculative ones, and every round commits at least one token;
- disaggregated prefill/decode (serving/disagg.py): a prefill tier parks
  a request after its first token (``hold_after_prefill``) and exports
  its prompt blocks to host numpy (``export_held_kv``); a decode tier
  scatters them into its own pool and resumes (``inject_request``).
  Every touch of the pool from another thread queues through
  ``submit_ctl`` and runs at the top of the next ``step()``.

Pipelined decode keeps the JAX engine's structure: chunk N+1 is
dispatched before chunk N's tokens are read back. CUDA launches are
asynchronous, so the device runs chunk N while the host launches N+1;
chunk N's tokens travel through a pinned buffer and an event, so the
read-back waits for chunk N only.

The decode program (serving/decode_graph.py): every decode dispatch
stages its host inputs into static buffers (one asynchronous copy) and
runs ONE body over them, ``_decode_steps``. ``precompile()`` captures
that body once as a CUDA graph (``decode_chunk`` greedy steps), as the
JAX engine's ``precompile`` installs its AOT-compiled decode program;
``LLMModel.load`` calls it on a card. A dispatch then replays the graph
where JAX would run that program (an all-greedy batch and a full
``decode_chunk``) and runs the same body eagerly otherwise (a sampled
request in the batch, a chunk trimmed by the scheduler). Verify
dispatches stay eager.

Under an executable depot (``KFT_DEPOT``) ``precompile`` captures as
without one: a CUDA graph cannot be serialized to another process, so the
outcome is the reference's for a program it cannot serialize,
``"compiled"``, counted (``parallel/depot.local_capture``).

Not in this slice (each raises or is absent, never quietly different):
capture of the prefill tier's chunked-prefill program or under a mesh
(``precompile`` raises ``GRAPH_SLICE``), meshes over axes other than
``tensor``, and
disaggregated serving under a tensor mesh (a rank's pool holds only its
KV heads: hold, export and inject raise ``DISAGG_SLICE``).
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
from kubeflow_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_quant,
)
from kubeflow_tpu_torch.parallel.depot import local_capture
from kubeflow_tpu_torch.parallel.mesh import tensor_parallel
from kubeflow_tpu_torch.parallel.sharding import (
    shard_tree, validate_divisibility,
)
from kubeflow_tpu_torch.serving import tp as tp_serving
from kubeflow_tpu_torch.serving.decode_graph import DecodeBuffers, DecodeGraph
from kubeflow_tpu_torch.serving.paged_kv import (
    PagedKV, _lm_head, blocks_for, gather_kv_blocks, init_paged_cache,
    paged_decode_step, paged_insert_batch, paged_prefill_chunk,
    paged_verify_step, resolve_decode_kernel, scatter_kv_blocks, wire_dtype,
)
from kubeflow_tpu_torch.serving.quant import (
    is_weight_quantized, quant_logical_axes, quantize_weights, resolve_quant,
)
from kubeflow_tpu_torch.serving.scheduler import (
    QuantConfig, SchedulerConfig, StepScheduler, ceil_pow2,
)
from kubeflow_tpu_torch.serving.spec_decode import make_drafter

logger = logging.getLogger(__name__)

# Request-latency buckets at factor 2**0.25 (~19% relative error), the
# JAX engine's choice: A/B comparisons discriminate inside one octave.
_REQ_LAT_BUCKETS = log_buckets(0.001, 64.0, factor=2 ** 0.25)
# modulus of a rank's running token digest (``_note_tokens``): a prime
# that keeps digest * 1000003 + one dispatch's weighted sum inside int64
_DIGEST_PRIME = 2 ** 31 - 1

DISAGG_SLICE = ("disaggregated serving under a tensor mesh (hold, export "
                "and inject of a pool that holds one rank's KV heads) is a "
                "later slice of the PyTorch port (ROADMAP queue 1 item 8.7)")

GRAPH_SLICE = {
    "mesh": ("capture of the decode program under a tensor mesh (NCCL "
             "collectives in a CUDA graph) is a later slice of the PyTorch "
             "port (ROADMAP queue 1 item 6.3)"),
    "prefill": ("capture of the prefill tier's chunked-prefill program is a "
                "later slice of the PyTorch port (ROADMAP queue 1 item 6.2)"),
}

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
    # disaggregated prefill tier (serving/disagg.py): park the request
    # after prefill + first token instead of decoding; its KV stays
    # resident (blocks refcount-pinned) until export_held_kv/release_held
    hold_after_prefill: bool = False
    # observability: trace context ((trace_id, span_id) of the queue
    # span), wall-clock latency marks feeding the request histograms, and
    # the live span handles the engine closes as the request advances
    trace: Optional[tuple] = None
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    # first DECODE commit (token #2): on a decode tier it closes the
    # migration's inject -> first commit interval
    t_second_token: float = 0.0
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
    tables: np.ndarray


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
    neg_inf = float("-inf")
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
    """log softmax(logits)[tok] without materializing the [..., V] log
    softmax (OpenAI convention: pre-temperature/filtering). logits
    [..., V], tok [...]."""
    return (logits.gather(-1, tok.long()[..., None])[..., 0]
            - torch.logsumexp(logits, dim=-1))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def local_params(params, cfg: llama.LlamaConfig, mesh, device):
    """The parameters this rank serves, on ``device``. ``params`` is a
    full tree (float or int8), cut to the rank's shard under a mesh, or a
    source: a callable ``source(cfg, mesh, device)`` that builds the
    rank's tree itself (``llama.SeededParams``,
    ``hf_llama.CheckpointParams``), so no rank needs the full tree."""
    if callable(params):
        return params(cfg, mesh, device)
    if mesh is not None:
        axes = (quant_logical_axes(cfg) if is_weight_quantized(params)
                else llama.param_logical_axes(cfg))
        params = shard_tree(params, axes, mesh.rank, mesh.tp)
    return _tree_to(params, device)


class LLMEngine:
    """Continuous-batching generation over the paged prefill/decode path.

    Runs on ``device`` (resolved by ``device.resolve_device``: CUDA
    unless ``"cpu"`` is asked for; raises with no GPU and no request).
    ``params`` move there if they are elsewhere (``local_params``: a
    full tree or a source). ``kernel``: the decode attention path
    (serving/paged_kv.resolve_decode_kernel).

    ``mesh``: tensor-parallel serving (module docstring) on the mesh's
    devices; rank 0's device is this engine's, ``device`` must be None
    or the same. A full tree ``params`` must then lie on the CPU (it is
    handed to the spawned ranks); ``close()`` stops them."""

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
                 device: DeviceLike = None,
                 mesh=None):
        # what every other rank builds its engine from
        rank_kwargs = dict(
            max_batch=max_batch, max_seq=max_seq,
            prefill_buckets=tuple(prefill_buckets),
            kv_block_size=kv_block_size, kv_num_blocks=kv_num_blocks,
            decode_chunk=decode_chunk, decode_pipeline=decode_pipeline,
            kernel=kernel, scheduler=scheduler, quant=quant)
        self.mesh = tensor_parallel(mesh)
        llama.check_moe_mesh(cfg, self.mesh)
        if self.mesh is not None:
            tp = self.mesh.tp
            if cfg.n_kv_heads % tp:
                raise ValueError(f"n_kv_heads={cfg.n_kv_heads} not "
                                 f"divisible by tensor={tp}")
            validate_divisibility(self.mesh, llama.param_logical_axes(cfg),
                                  llama.param_shapes(cfg))
            if device is not None and \
                    resolve_device(device) != self.mesh.device:
                raise ValueError(f"device={device} is not rank "
                                 f"{self.mesh.rank}'s {self.mesh.device}")
            device = self.mesh.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kernel = resolve_decode_kernel(kernel, mesh=self.mesh,
                                            n_kv_heads=cfg.n_kv_heads)
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
        # speculative decoding (scheduler knob): the host-side drafter; a
        # verify dispatch scores its proposals (_spec_step)
        self.spec = None
        if scheduler is not None and scheduler.spec_decode:
            self.spec = make_drafter(scheduler.spec_drafter, scheduler.spec_k)
        # every check that can fail on the host is behind us: rank 0 now
        # starts the other ranks, which build the same engine on theirs
        self.tp = None
        if self.mesh is not None and self.mesh.rank == 0:
            self.tp = tp_serving.launch(self.mesh, params, cfg, rank_kwargs)
        try:
            params = local_params(params, cfg, self.mesh, self.device)
            if (self.quant.weight_dtype == "int8"
                    and not is_weight_quantized(params)):
                # quantize ONCE at build: decode, chunked prefill and
                # bucket prefill all read the same int8 tree
                params = quantize_weights(params, cfg, mesh=self.mesh)
            self.params = params
            self.paged = PagedKV(cfg=cfg, max_batch=max_batch,
                                 max_seq=max_seq, block_size=kv_block_size,
                                 num_blocks=kv_num_blocks, device=self.device,
                                 quant_kv=self.quant.kv_dtype, mesh=self.mesh)
        except BaseException:
            self.close()
            raise
        self.cache = self.paged.cache
        self._free: list[int] = list(range(max_batch))
        self._active: dict[int, GenRequest] = {}     # slot -> request
        self._waiting: list[GenRequest] = []
        self._aborted: set[int] = set()              # request ids to retire
        # disaggregated prefill tier: slot -> request parked after prefill
        # (hold_after_prefill) awaiting KV export; its blocks stay
        # refcount-pinned so eviction can never reach them
        self._held: dict[int, GenRequest] = {}
        # control ops (export/inject/release from other threads): every
        # touch of the pool runs on the stepping thread, drained at the
        # top of step()
        self._ctl: list = []
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._tokens = np.zeros((max_batch,), np.int32)   # next input token
        # the same seed on every rank: the ranks sample the same logits
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(0)
        # under a mesh: this rank's sampling bodies and a running digest
        # of every token it sampled (``_note_tokens``)
        self.tp_samples = 0
        self._token_digest = (torch.zeros((), dtype=torch.int64,
                                          device=self.device)
                              if self.mesh is not None else None)
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
        # the decode program's static inputs/outputs, and its captured
        # graph once precompile() ran (serving/decode_graph.py)
        self._dec = DecodeBuffers(max_batch, self.paged.max_blocks_per_seq,
                                  self.decode_chunk, self.device)
        self.decode_graph: Optional[DecodeGraph] = None
        self.depot_outcome: Optional[str] = None
        self.sched = StepScheduler(scheduler, default_budget=self.buckets[-1],
                                   decode_chunk=self.decode_chunk)
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
        work that produced them (copies either way: the decode outputs
        are static buffers the next dispatch overwrites)."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
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
    # Each ``_body_<name>`` takes host inputs only (numpy arrays, Python
    # scalars) and is run through ``_run``: on every rank under a mesh.

    def _run(self, name: str, **host):
        body = getattr(self, "_body_" + name)
        if self.tp is None:
            return body(**host)
        return self.tp.run(name, host, body)

    def _note_tokens(self, toks) -> None:
        """Under a mesh, fold the tokens this rank sampled into its
        running digest: position-weighted, modulo a prime, on the device
        (a few elementwise ops; no collective, no readback)."""
        if self._token_digest is None:
            return
        flat = toks.reshape(-1).to(torch.int64)
        pos = torch.arange(1, flat.numel() + 1, device=flat.device)
        self._token_digest = ((self._token_digest * 1000003
                               + (flat * pos).sum()) % _DIGEST_PRIME)
        self.tp_samples += 1

    def _sample(self, logits, temperature, top_k, top_p):
        """First-token sampling of admission rows -> device (tok, lp)."""
        tok = sample_logits(logits, self._rng, self._dev(temperature),
                            self._dev(top_k), self._dev(top_p))
        self._note_tokens(tok)
        return tok, chosen_logprob(logits, tok)

    def _body_decode(self, tokens, fresh, tables, active, temperature,
                     top_k, top_p, greedy_only: bool, chunk_len: int):
        """``chunk_len`` decode+sample steps over every slot: the host
        inputs are staged into the decode program's static buffers, then
        the captured program replays (``precompile``; an all-greedy full
        chunk) or ``_decode_steps`` runs eagerly. A slot's input token is
        its ``tokens`` entry where ``fresh`` is set, else the previous
        dispatch's device-side next token. Returns (toks [chunk, B], lps
        [chunk, B]) on the device: views of the static outputs, which the
        next dispatch overwrites."""
        d = self._dec
        d.stage(tokens, fresh, active, tables, temperature, top_k, top_p)
        if (self.decode_graph is not None and greedy_only
                and chunk_len == self.decode_chunk):
            self.decode_graph.replay()
        else:
            self._decode_steps(chunk_len, greedy_only)
        toks, lps = d.toks[:chunk_len], d.lps[:chunk_len]
        self._note_tokens(toks)
        return toks, lps

    def _decode_steps(self, chunk_len: int, greedy_only: bool) -> None:
        """The decode program, over the static buffers alone
        (serving/decode_graph.DecodeBuffers): ``chunk_len`` decode+sample
        steps writing the output rows, then the carry. This is the body
        ``precompile`` captures."""
        d = self._dec
        token = torch.where(d.fresh != 0, d.tokens, d.carry)
        active = d.active != 0
        for t in range(chunk_len):
            logits, self.cache = paged_decode_step(
                self.params, token, self.cfg, self.cache, d.tables,
                kernel=self.kernel, mesh=self.mesh)
            nxt = sample_logits(logits, self._rng, d.temperature, d.top_k,
                                d.top_p, greedy_only=greedy_only)
            d.lps[t].copy_(chosen_logprob(logits, nxt))
            d.toks[t].copy_(nxt)
            # idle slots: pin len to 0 so the cursor can't creep toward
            # max_seq (their scatter lands in the scratch block 0)
            self.cache["len"].masked_fill_(~active, 0)
            token = nxt
        d.carry.copy_(token)

    def _body_verify(self, tokens, tables, limit):
        """One speculative verify dispatch (``paged_verify_step``) over
        the [B, S] candidate tokens: the target's greedy chain with the
        decode sampler's tie-break, and each chosen token's logprob.
        Returns (toks [B, S], lps [B, S]) on the device."""
        logits, self.cache = paged_verify_step(
            self.params, self._dev(tokens), self.cfg, self.cache,
            self._dev(tables), self._dev(limit), mesh=self.mesh)
        nxt = greedy_argmax(logits)
        self._note_tokens(nxt)
        return nxt, chosen_logprob(logits, nxt)

    def _body_set_lens(self, lens):
        """Commit the slots' lengths after a verify (host-side acceptance),
        in place."""
        self.cache["len"].copy_(torch.from_numpy(lens))

    def _body_prefill_chunk(self, piece, tables, slot: int, offset: int,
                            length: int, share_len: int, final: bool,
                            temperature, top_k, top_p):
        """One chunk of a long prompt into the pool; the final one also
        runs the LM head, samples the first token and publishes the
        slot's length. Returns ``_sample``'s pair, or None."""
        x_last, self.cache = paged_prefill_chunk(
            self.params, self._dev(piece), self.cfg, self.cache,
            self._dev(tables), slot, offset, length, share_len,
            mesh=self.mesh)
        if not final:
            return None
        logits = _lm_head(self.params, x_last, self.cfg, self.mesh)
        out = self._sample(logits, temperature, top_k, top_p)
        self.cache["len"][slot] = length
        return out

    def _body_admit(self, toks, lengths, blk, slots, temperature, top_k,
                    top_p):
        """Prefill of a padded admission batch into a scratch cache, one
        insert into the pool, first-token sampling (``_sample``)."""
        width, bucket = toks.shape
        scratch = llama.init_cache(self.cfg, width, bucket,
                                   device=self.device, mesh=self.mesh)
        lengths_dev = self._dev(lengths)
        logits, filled = llama.prefill(
            self.params, self._dev(toks), self.cfg, scratch,
            lengths=lengths_dev, mesh=self.mesh)
        paged_insert_batch(self.cache, filled["k"], filled["v"],
                           self._dev(blk), lengths_dev, self._dev(slots))
        return self._sample(logits, temperature, top_k, top_p)

    def _body_score(self, streams):
        """Teacher-forced logits of equal-length token streams [S, n]
        through this engine's decode path, one slot a stream, over a
        fresh pool of the engine's KV dtype and block size (the live pool
        is untouched)."""
        n_streams, n = streams.shape
        bs = self.paged.block_size
        nb = blocks_for(n, bs)
        cache = init_paged_cache(self.cfg, n_streams, nb * bs, bs,
                                 n_streams * nb + 1, device=self.device,
                                 quant_kv=self.quant.kv_dtype, mesh=self.mesh)
        tables = torch.arange(1, n_streams * nb + 1, dtype=torch.int32,
                              device=self.device).reshape(n_streams, nb)
        rows = []
        with torch.no_grad():
            for t in range(n):
                logits, cache = paged_decode_step(
                    self.params, self._dev(streams[:, t]), self.cfg, cache,
                    tables, kernel=self.kernel, mesh=self.mesh)
                rows.append(logits)
        return torch.stack(rows, dim=1)

    def teacher_forced_logits(self, streams) -> torch.Tensor:
        """f32 [S, n, V] logits of S token streams of length n, each fed
        one token per decode step through this engine's decode path
        (kernel, quantized pool and weights, and mesh): row t of a
        stream predicts its token t + 1. Call it while the engine is
        idle."""
        return self._run("score", streams=np.asarray(streams, np.int32))

    def close(self) -> None:
        """Stop the other ranks of a mesh (no-op without one)."""
        if self.tp is not None:
            self.tp.close()
            self.tp = None

    def tp_status(self, reset_launches: bool = False) -> list:
        """Per-rank identity and kernel launch counts
        (``serving.tp.status``), in rank order; [] without a mesh."""
        return [] if self.tp is None else self.tp.status(self,
                                                         reset_launches)

    # ---------------- public API ----------------

    def precompile(self, depot=None, stats=None, wait_s: float = 0.0,
                   tier: str = "") -> str:
        """Capture the steady-state decode program as a CUDA graph, the
        counterpart of the JAX engine's ``precompile`` (which AOT-lowers
        the same variant): ``decode_chunk`` greedy steps of
        ``_decode_steps``, warmed up and captured on the idle engine, so
        the warm-up's writes land in the scratch block 0 alone
        (serving/decode_graph.DecodeGraph). From then on every dispatch
        of an all-greedy batch over a full chunk replays it. Returns
        "no_depot" (JAX's outcome without a depot) or, with a ``depot``,
        "compiled" with ``stats`` counting the capture and its
        serialize failure (``parallel/depot.local_capture``: the graph
        never leaves this process), also kept as
        ``self.depot_outcome``; ``wait_s`` is unused (no publish to wait
        for).

        Raises NotImplementedError naming the later slice for
        ``tier="prefill"`` and under a mesh (``GRAPH_SLICE``), ValueError
        on a CPU engine (there is no graph and no stand-in), and
        RuntimeError when the engine is not idle."""
        if tier == "prefill":
            raise NotImplementedError(GRAPH_SLICE["prefill"])
        if self.mesh is not None:
            raise NotImplementedError(GRAPH_SLICE["mesh"])
        if self.device.type != "cuda":
            raise ValueError(f"precompile captures a CUDA graph; this engine "
                             f"runs on {self.device}")
        if self.has_work() or self._held or self._inflight is not None:
            raise RuntimeError("precompile needs an idle engine (no request "
                               "queued, decoding, held or in flight)")
        b = self.max_batch
        self._dec.stage(
            tokens=np.zeros((b,), np.int32), fresh=np.ones((b,), bool),
            active=np.zeros((b,), bool),
            tables=np.zeros_like(self.paged.tables),
            temperature=np.zeros((b,), np.float32),
            top_k=np.zeros((b,), np.int32), top_p=np.ones((b,), np.float32))
        with torch.no_grad():
            self.decode_graph = DecodeGraph(
                lambda: self._decode_steps(self.decode_chunk, True),
                self.cache,
                (paged_decode_attention, paged_decode_attention_quant),
                self.device)
        self.depot_outcome = local_capture(depot, stats)
        return self.depot_outcome

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
                    trace: Optional[str] = None,
                    hold_after_prefill: bool = False) -> GenRequest:
        """``trace``: an incoming W3C traceparent (router/server span) —
        the request's queue span roots under it. ``hold_after_prefill``:
        disaggregated prefill tier — park after prefill + first token for
        KV export instead of decoding."""
        sampling = sampling or SamplingParams()
        self.validate_prompt(prompt, sampling)
        if hold_after_prefill:
            self._check_disagg()
        req = GenRequest(id=next(self._ids), prompt=list(map(int, prompt)),
                         sampling=sampling,
                         hold_after_prefill=bool(hold_after_prefill))
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

    # ------------- disaggregated prefill/decode (serving/disagg.py) -------
    # Stepping-thread only: these touch the pool, so callers on other
    # threads go through submit_ctl. Single-threaded tests may call them
    # directly between step()s.

    def _check_disagg(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(DISAGG_SLICE)

    def held_requests(self) -> list[GenRequest]:
        return list(self._held.values())

    def export_held_kv(self, req: GenRequest) -> Optional[dict]:
        """Package a held request's PROMPT blocks for migration: the first
        ``blocks_for(len(prompt))`` blocks of its reservation (the empty
        generation-budget tail never travels) as host numpy
        (``paged_kv.gather_kv_blocks``, with ``kv_dtype`` naming the
        pool dtype its bytes are in), plus what the decode tier needs to
        resume: prompt, the prefill-sampled token #1 and its logprob,
        sampling params and the original enqueue time. Returns None when
        the request was aborted or released before export."""
        self._check_disagg()
        slot = req.slot
        if slot is None or self._held.get(slot) is not req:
            return None
        bs = self.paged.block_size
        n = blocks_for(len(req.prompt), bs)
        ids = self.paged.slot_blocks(slot)[:n]
        return {
            "prompt": list(req.prompt),
            "first_token": int(req.generated[0]),
            "first_lp": float(req.logprobs[0]),
            "sampling": dataclasses.asdict(req.sampling),
            "t_enqueue": req.t_enqueue,
            "t_prefill_done": req.t_first_token,
            "block_size": bs,
            "n_blocks": n,
            "kv_dtype": wire_dtype(self.cache),
            "blocks": gather_kv_blocks(self.cache, ids),
        }

    def release_held(self, req: GenRequest) -> bool:
        """Drop a held request's slot and blocks: the prefill side of the
        ownership edge, after the decode tier acked the handoff or on a
        failed/aborted migration (its radix-published blocks stay cached
        and evictable, so a local re-prefill is one cheap chunk)."""
        slot = req.slot
        if slot is None or self._held.get(slot) is not req:
            return False
        del self._held[slot]
        req.done = True
        self.paged.release(slot)
        self._free.append(slot)
        return True

    def inject_request(self, prompt: Sequence[int],
                       sampling: SamplingParams, *, first_token: int,
                       first_lp: float, blocks: dict, n_blocks: int,
                       t_enqueue: float = 0.0,
                       kv_dtype: Optional[str] = None
                       ) -> Optional[GenRequest]:
        """Decode-tier admission of a migrated prefill: reserve a slot,
        scatter the imported prompt blocks into the pool in place
        (radix-shared prefix blocks are skipped — the pool already holds
        them), set the slot's length and commit token #1 as a local
        admission does. The reservation refcounts every imported block
        BEFORE the scatter, so eviction can never reclaim a mid-handoff
        block. Returns None when no slot or pool capacity is free (the
        caller nacks and the prefill side falls back to local
        generation). A payload whose ``kv_dtype`` or block size is not
        this pool's raises."""
        self._check_disagg()
        if kv_dtype is not None and kv_dtype != wire_dtype(self.cache):
            raise ValueError(f"payload KV dtype {kv_dtype} is not this "
                             f"pool's {wire_dtype(self.cache)}")
        bs = self.paged.block_size
        if n_blocks != blocks_for(len(prompt), bs):
            raise ValueError(f"{n_blocks} blocks for a {len(prompt)}-token "
                             f"prompt at block size {bs}")
        self.validate_prompt(prompt, sampling)
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop()
        L = len(prompt)
        n_shared = self.paged.reserve(
            slot, L, sampling.max_tokens, min_blocks=n_blocks,
            prompt=prompt, defer_publish=True)
        if n_shared is None:
            with self._lock:
                self._free.append(slot)
            return None
        req = GenRequest(id=next(self._ids),
                         prompt=list(map(int, prompt)), sampling=sampling)
        req.t_enqueue = t_enqueue or time.time()
        ids = self.paged.slot_blocks(slot)[:n_blocks]
        if n_shared < n_blocks:
            scatter_kv_blocks(self.cache, ids[n_shared:],
                              {k: v[:, n_shared:n_blocks]
                               for k, v in blocks.items()})
        self.cache["len"][slot] = L
        # publish the imported full prompt blocks to THIS pool's radix
        # tree: a later request sharing the prefix admits here at
        # radix-hit cost
        self.paged.publish_prompt_blocks(slot, prompt, L)
        self._post_admit(req, slot, int(first_token), float(first_lp))
        return req

    def submit_ctl(self, fn) -> None:
        """Queue ``fn`` to run on the stepping thread at the top of the
        next step(): the only safe way for another thread to touch engine
        or pool state. Callers needing the result wrap ``fn`` to capture
        it and wake the model loop (serving/disagg.TierRuntime)."""
        with self._lock:
            self._ctl.append(fn)

    def _drain_ctl(self) -> None:
        with self._lock:
            ops, self._ctl = self._ctl, []
        for fn in ops:
            fn()

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
        elif req.t_second_token == 0.0:
            req.t_second_token = now
        if n_new > 0 and req.t_last_commit:
            gap = max(0.0, now - req.t_last_commit) / n_new
            itl = self.request_hists["itl"]
            for _ in range(n_new):
                itl.observe(gap)
        req.t_last_commit = now

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._waiting or self._active or self._chunked
                        or self._ctl)

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
        self._drain_ctl()
        with self._lock:
            aborted, self._aborted = self._aborted, set()
        if aborted:
            for slot, req in list(self._active.items()):
                if req.id in aborted:
                    del self._active[slot]
                    self.paged.release(slot)
                    self._free.append(slot)
            # a held prefill whose request aborted mid-migration releases
            # its side here: the prefill half of the "releases on both
            # sides" contract (the decode half is disagg release/collect)
            for slot, req in list(self._held.items()):
                if req.id in aborted:
                    del self._held[slot]
                    self.paged.release(slot)
                    self._free.append(slot)
            for slot, st in list(self._chunked.items()):
                if st.req.id in aborted:
                    self._cancel_chunked(slot)
        self._admit()
        finished_pre: list[GenRequest] = []
        if self.spec is not None and self._active:
            if all(r.sampling.temperature == 0
                   for r in self._active.values()):
                # speculative path: flush the pipelined chunk first (its
                # tokens are this round's draft context), then one
                # draft+verify round, synchronous by construction
                if self._inflight is not None:
                    prev, self._inflight = self._inflight, None
                    finished_pre = self._process_chunk(prev)
                if not self._active:
                    return finished_pre
                spec_finished = self._spec_step()
                if spec_finished is not None:
                    return finished_pre + spec_finished
                # no stream drafted anything: a width-1 verify would
                # commit ONE token a dispatch where plain multistep decode
                # commits chunk_len; fall through to it (counted)
                self.sched.note_spec_undrafted()
            else:
                # a non-greedy request in the batch: acceptance is exact
                # only for greedy, so this dispatch decodes (counted)
                self.sched.note_spec_fallback()
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
            # the device carry of the in-flight chunk, except where fresh
            # host tokens (admissions since that dispatch) override it;
            # with nothing in flight every slot takes the host token
            fresh = (self._fresh.copy() if self._inflight is not None
                     else np.ones_like(self._fresh))
            self._fresh[:] = False
            chunk_len = self.sched.decode_chunk_len(
                self._min_deterministic_remaining(),
                pressure=bool(self._waiting))
            self.sched.note_decode_dispatch(chunk_len)
            dspan = self._dispatch_span(
                "decode.step", [r for _, r in self._active.items()],
                chunk_len=chunk_len, batch=len(self._active))
            toks, lps = self._run(
                "decode", tokens=self._tokens.copy(), fresh=fresh,
                tables=self._dispatch_tables(),
                active=active_mask, temperature=temp, top_k=top_k,
                top_p=top_p, greedy_only=not bool((temp > 0).any()),
                chunk_len=chunk_len)
            host, event = self._start_readback(toks, lps)
            new_inflight = {
                "host": host, "event": event,
                "chunk_len": chunk_len, "span": dspan,
                # tokens belong to the requests active at DISPATCH time
                "snapshot": list(self._active.items()),
            }
        prev, self._inflight = self._inflight, new_inflight
        finished = self._process_chunk(prev) if prev is not None else []
        if not self.decode_pipeline and self._inflight is not None:
            flush, self._inflight = self._inflight, None
            finished += self._process_chunk(flush)
        return finished_pre + finished

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
        """Block tables for a decode/verify dispatch: mid-prefill and held
        slots' rows zeroed so their idle scatter lands in the scratch
        block, never in a half-prefilled prompt block or in the prompt
        blocks a held request is about to export."""
        tab = self.paged.tables
        if self._chunked or self._held:
            tab = tab.copy()
            for s in itertools.chain(self._chunked, self._held):
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

    def _spec_step(self) -> Optional[list[GenRequest]]:
        """One speculative draft+verify round over the active batch, or
        None when no stream drafted anything (the caller decodes).

        The drafter proposes up to spec_k tokens per stream from its
        committed context; ONE verify dispatch writes every candidate's
        KV row (tail rows past a slot's blocks go to scratch) and returns
        the target's greedy chain + logprobs; the longest draft prefix
        matching that chain commits, plus the target's own next token.
        ``cache["len"]`` then advances by the COMMITTED count only:
        rejected rows sit beyond it, invisible to attention, and the next
        dispatch rewrites them before they could be unmasked."""
        bs = self.paged.block_size
        drafts: dict[int, list[int]] = {}
        for slot, req in self._active.items():
            # drafts past the deterministic remaining budget can never
            # commit; they would only widen the verify for nothing
            rem = min(req.sampling.max_tokens - len(req.generated),
                      self.max_seq - len(req.prompt) - len(req.generated))
            drafts[slot] = self.spec.draft(
                req.prompt + req.generated)[:max(0, rem - 1)]
        k_max = max(len(d) for d in drafts.values())
        if k_max == 0:
            return None
        # pow-2 verify width (input column + drafts): the JAX engine's
        # static widths, log2(spec_k + 1) of them
        width = ceil_pow2(1 + k_max)
        tokens = np.zeros((self.max_batch, width), np.int32)
        limit = np.zeros((self.max_batch,), np.int32)
        for slot, d in drafts.items():
            tokens[slot, 0] = self._tokens[slot]
            tokens[slot, 1:1 + len(d)] = d
            # rows at/after the slot's reserved tokens scatter to scratch
            limit[slot] = len(self.paged.slot_blocks(slot)) * bs
        drafted = sum(len(d) for d in drafts.values())
        self.sched.note_spec_dispatch(drafted)
        vspan = self._dispatch_span(
            "decode.verify", [r for _, r in self._active.items()],
            width=width, drafted=drafted, batch=len(self._active))
        toks, lps = self._read_sample(self._run(
            "verify", tokens=tokens, tables=self._dispatch_tables(),
            limit=limit))
        self.steps += 1
        finished = []
        committed_total = 0
        new_len = np.zeros((self.max_batch,), np.int32)
        for slot, req in list(self._active.items()):
            if req.done:
                continue               # aborted after dispatch
            d = drafts[slot]
            # acceptance: position i's target token commits; a matching
            # draft i validates position i + 1
            accepted = 0
            committed: list[tuple[int, float]] = []
            for i in range(len(d) + 1):
                committed.append((int(toks[slot, i]), float(lps[slot, i])))
                if i < len(d) and d[i] == committed[-1][0]:
                    accepted += 1
                    continue
                break
            n_appended = 0
            done = False
            for tok, lp in committed:
                n_appended += 1
                if self._commit_token(req, slot, tok, lp):
                    done = True
                    break
            # only draft tokens that actually committed count: an early
            # stop (eos/budget) truncates acceptance too
            self.sched.note_spec_result(min(accepted, n_appended),
                                        n_appended)
            committed_total += n_appended
            self._note_request_latency(req, n_appended)
            if done:
                finished.append(req)
                self._retire(req, slot)
            else:
                # committed length only: rejected rows stay beyond it
                new_len[slot] = len(req.prompt) + len(req.generated) - 1
        self._run("set_lens", lens=new_len)
        self.obs.end(vspan, tokens_committed=committed_total)
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
            tables=self.paged.tables.copy())
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
        final = st.offset + W >= L
        first = self._run("prefill_chunk", piece=piece, tables=st.tables,
                          slot=slot, offset=st.offset, length=L,
                          share_len=st.share_len, final=final,
                          **self._sampling_arrays([req]))
        st.offset += W
        self.sched.note_prefill_chunk(W)
        self.obs.end(pspan, final=st.offset >= L)
        # publish completed read-only blocks: every position < offset is
        # written and its write enqueued, so a later sharer's reads are
        # stream-ordered behind the content
        self.paged.publish_prompt_blocks(slot, req.prompt,
                                         min(st.offset, L))
        if final:
            tok, lp = self._read_sample(first)
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
        self.prefill_dispatches += 1
        pspan = self._dispatch_span(
            "prefill.batch", [r for r, _, _ in batch],
            bucket=bucket, batch=len(batch))
        tok, lp = self._read_sample(self._run(
            "admit", toks=toks, lengths=lengths, blk=blk, slots=slots,
            **self._sampling_arrays([r for r, _, _ in batch], width)))
        self.obs.end(pspan)
        for i, (req, slot, _) in enumerate(batch):
            self._post_admit(req, slot, int(tok[i]), float(lp[i]))

    @staticmethod
    def _sampling_arrays(reqs, width: Optional[int] = None) -> dict:
        """Admission rows' sampling parameters as host arrays (pad rows
        greedy)."""
        width = width or len(reqs)
        temp = np.zeros((width,), np.float32)
        top_k = np.zeros((width,), np.int32)
        top_p = np.ones((width,), np.float32)
        for i, r in enumerate(reqs):
            temp[i] = r.sampling.temperature
            top_k[i] = r.sampling.top_k
            top_p[i] = r.sampling.top_p
        return {"temperature": temp, "top_k": top_k, "top_p": top_p}

    @staticmethod
    def _read_sample(sampled):
        """``_sample``'s device pair -> host (tok, lp)."""
        tok, lp = sampled
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
        elif req.hold_after_prefill:
            # disagg prefill tier: park the request for export_held_kv
            # instead of decoding; the slot and its refcount-pinned blocks
            # stay until release_held moves or drops ownership
            del self._active[slot]
            self._held[slot] = req
