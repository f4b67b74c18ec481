"""Block-paged KV cache for the LLM engine (counterpart of
``kubeflow_tpu.serving.paged_kv``).

KV lives in a pool of fixed-size blocks ([L, num_blocks, block_size, KV,
D]) and each slot owns a *block table* — the ordered block ids backing
its logical sequence — so pool memory scales with tokens actually
resident. Tables are host-managed numpy (the scheduler allocates blocks at
admission — enough for prompt + max_tokens, so decode can never run out
mid-flight) and travel to the device as int32 tensors per dispatch.

Where the JAX package donated the pool buffers to each jitted step, the
port updates the pool IN PLACE: every function here that takes a
``cache`` dict writes its ``k``/``v`` tensors where they lie and returns
the same dict (``len`` replaced by a new tensor where the JAX version
returned a new one).

Decode attention has two paths, selected by ``paged_decode_step(...,
kernel=)`` with the JAX package's switch values:

- ``"gather"`` — materialize each slot's logical [max_seq] view
  (``k_pool[tables]``) and run dense GQA attention over it: the
  reference oracle.
- ``"auto"`` / ``"pallas"`` (resolved to ``"paged"``) — the block-resident
  paged kernel (``ops/paged_attention.py``): the hand-written CUDA kernel
  on a CUDA pool, its plain PyTorch version on a CPU pool. ``"pallas"``
  stays accepted so configs carry over.

Quantized pools (``quant_kv`` "int8" | "fp8_e4m3") store K/V in that
dtype with per-block per-kv-head f32 scales ``k_scale``/``v_scale``
[L, num_blocks, KV] beside them; the presence of those keys is the
marker every path keys on. Writes quantize (``quant_scatter_rows``,
``paged_insert_batch``); the paged path hands the scales to the
fused-dequant kernel, the gather path reads ``dequant_gather_view``.
fp8 pools are indexed through a ``uint8`` view of the same bytes
(``_raw``), so no index op ever needs an fp8 kernel.

Tensor parallelism (``mesh=``, a launched ``parallel.mesh.TensorMesh``;
None is the one-card path): every rank runs the same step on its shard.
Its pool and scale tables hold its ``n_kv_heads / tp`` KV heads, its
tables and lengths are the same as every rank's, the decode attention is
``ops.paged_attention.paged_decode_attention_shard`` (rows 1-2's kernels
on the rank's heads) or the gather oracle over the rank's heads, and the
model's collectives are those of ``models/llama.py``.

Block 0 is the pool's scratch block: idle slots (len 0, all-zero table
row) and pad rows scatter into it, several idle slots into the same row,
which is harmless only because nothing live ever reads block 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.ops.attention import _xla_attention, decode_attention
from kubeflow_tpu_torch.ops.norms import rms_norm
from kubeflow_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_shard,
    shard_unsupported_reason,
)
from kubeflow_tpu_torch.ops.rotary import apply_rope
from kubeflow_tpu_torch.serving.quant import KV_QMAX, kv_store_dtype


def init_paged_cache(cfg: llama.LlamaConfig, max_batch: int, max_seq: int,
                     block_size: int, num_blocks: int, dtype=None,
                     device: DeviceLike = None,
                     quant_kv: str = "none", mesh=None) -> dict:
    """Pool + per-slot lengths on ``device`` (``device.resolve_device``:
    CUDA unless ``"cpu"`` is asked for). ``num_blocks`` bounds total
    resident tokens (num_blocks * block_size), independent of
    max_batch * max_seq. Under ``mesh`` the pool and scales hold the
    rank's KV heads, allocated as tensors of their own.

    ``quant_kv`` != "none" stores the pools in the quantized dtype
    ("int8" | "fp8_e4m3") and adds per-block per-kv-head f32 scale
    tables ``k_scale``/``v_scale`` [L, num_blocks, KV] beside them."""
    if max_seq % block_size:
        raise ValueError(f"max_seq={max_seq} not a multiple of "
                         f"block_size={block_size}")
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    reason = shard_unsupported_reason(mesh, cfg.n_kv_heads)
    if reason is not None:
        raise ValueError(reason)
    kv = cfg.n_kv_heads // (mesh.tp if mesh is not None else 1)
    shape = (cfg.n_layers, num_blocks, block_size, kv, cfg.head_dim)
    if quant_kv and quant_kv != "none":
        sdtype = kv_store_dtype(quant_kv)
        sshape = (cfg.n_layers, num_blocks, kv)
        return {
            "k": torch.zeros(shape, dtype=sdtype, device=device),
            "v": torch.zeros(shape, dtype=sdtype, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "len": torch.zeros((max_batch,), dtype=torch.int32,
                               device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((max_batch,), dtype=torch.int32, device=device),
    }


class BlockAllocator:
    """Host-side free list over the pool's block ids.

    Block 0 is never handed out: idle slots' table rows are all-zero and
    the decode scatter still writes their (masked, garbage) row somewhere —
    block 0 is that scratch target, so it must never back live data."""

    def __init__(self, num_blocks: int):
        self._free = list(range(1, num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > len(self._free):
            return None
        out = self._free[:n]
        del self._free[:n]
        return out

    def free(self, ids) -> None:
        self._free.extend(int(i) for i in ids)


def blocks_for(tokens: int, block_size: int) -> int:
    return -(-tokens // block_size)


class _RadixNode:
    """One cached KV block: the edge from its parent is the block's token
    tuple, so a root-path spells a block-aligned prompt prefix."""

    __slots__ = ("parent", "key", "children", "block", "tick")

    def __init__(self, parent, key, block, tick):
        self.parent = parent
        self.key = key
        self.children: dict[tuple, "_RadixNode"] = {}
        self.block = block
        self.tick = tick


class RadixPrefixCache:
    """Refcount-aware radix tree over FULL KV blocks (the vLLM/SGLang
    radix-attention role). Each node owns one pool block whose KV is a
    pure function of (tokens, positions, params); matching walks token
    tuples from the root, so only identical prefixes at identical
    positions share. Eviction is LRU over unpinned LEAVES — a node with
    live descendants (or a nonzero refcount, tracked by the owner) can
    never be unlinked, which makes stale partial chains structurally
    impossible (the flaw the old flat hash map had to heal by hand)."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root = _RadixNode(None, None, None, 0)
        self._by_block: dict[int, _RadixNode] = {}
        self._tick = 0
        self.evictions = 0

    def _keys(self, prompt) -> list[tuple]:
        bs = self.block_size
        return [tuple(int(t) for t in prompt[k * bs:(k + 1) * bs])
                for k in range(len(prompt) // bs)]

    def __len__(self) -> int:
        return len(self._by_block)

    def __contains__(self, block: int) -> bool:
        return block in self._by_block

    def blocks(self) -> set:
        return set(self._by_block)

    def match(self, prompt) -> list[int]:
        """Block ids of the longest cached block-aligned prefix of
        ``prompt`` (LRU-touching the whole path)."""
        node, out = self._root, []
        for key in self._keys(prompt):
            child = node.children.get(key)
            if child is None:
                break
            self._tick += 1
            child.tick = self._tick
            out.append(child.block)
            node = child
        return out

    def insert(self, prompt, blocks, n_blocks: Optional[int] = None) -> list:
        """Publish ``blocks[k]`` as the cached KV for prompt block k, for
        every FULL block (or the first ``n_blocks``). Existing nodes are
        walked through unchanged — a concurrent publisher keeps the first
        registration and the caller's copy stays private. Returns the
        block ids actually registered."""
        keys = self._keys(prompt)
        if n_blocks is not None:
            keys = keys[:n_blocks]
        node, registered = self._root, []
        for k, key in enumerate(keys):
            if k >= len(blocks):
                break
            child = node.children.get(key)
            if child is None:
                blk = int(blocks[k])
                if blk in self._by_block:
                    break          # one node per block, ever
                self._tick += 1
                child = _RadixNode(node, key, blk, self._tick)
                node.children[key] = child
                self._by_block[blk] = child
                registered.append(blk)
            node = child
        return registered

    def evictable_count(self, refs: dict) -> int:
        """Nodes reclaimable under ``refs`` pins: a node counts iff its
        whole subtree is unpinned (leaves-first eviction can reach it)."""
        def rec(node):
            cnt, ok_all = 0, True
            for c in node.children.values():
                c_cnt, c_ok = rec(c)
                cnt += c_cnt
                ok_all = ok_all and c_ok
            if node is self._root:
                return cnt, True
            ok = ok_all and refs.get(node.block, 0) == 0
            return cnt + (1 if ok else 0), ok
        return rec(self._root)[0]

    def evict_lru(self, n: int, refs: dict) -> list[int]:
        """Unlink up to ``n`` unpinned leaves, LRU-first (evicting a leaf
        may expose its parent as the next candidate). Pinned blocks and
        interior nodes are untouchable. One scan seeds a tick-ordered
        heap; exposed parents push locally — O(N log N) per call, not
        O(n*N) rescans in the admission hot path."""
        import heapq

        heap = [(node.tick, blk) for blk, node in self._by_block.items()
                if not node.children and refs.get(blk, 0) == 0]
        heapq.heapify(heap)
        freed: list[int] = []
        while heap and len(freed) < n:
            tick, blk = heapq.heappop(heap)
            node = self._by_block.get(blk)
            if (node is None or node.children or node.tick != tick
                    or refs.get(blk, 0) > 0):
                continue                       # stale heap entry
            parent = node.parent
            del parent.children[node.key]
            del self._by_block[blk]
            freed.append(blk)
            self.evictions += 1
            if (parent is not self._root and not parent.children
                    and refs.get(parent.block, 0) == 0):
                heapq.heappush(heap, (parent.tick, parent.block))
        return freed


@dataclasses.dataclass
class PagedKV:
    """The engine-facing bundle: pool dict + host block tables/allocator,
    with automatic prefix caching (the vLLM APC role) through a
    refcounted RADIX tree: full prompt blocks are keyed by their token
    tuples along the root path (position-dependence from tree depth) and
    shared across requests by refcount. Shared blocks are never rewritten
    — the KV inside is a pure function of (tokens, positions, params).
    When a block's refcount hits zero it stays cached and LRU-evictable
    (leaves first) until the pool needs it back. Chunked prefills
    participate too: they share cached prefixes at reserve time (with
    ``defer_publish=True``) and publish completed read-only blocks chunk
    by chunk via ``publish_prompt_blocks``."""

    cfg: llama.LlamaConfig
    max_batch: int
    max_seq: int
    block_size: int
    num_blocks: int
    prefix_cache: bool = True
    device: DeviceLike = None        # where the pool lives (resolve_device)
    quant_kv: str = "none"           # "none" | "int8" | "fp8_e4m3"
    mesh: object = None              # the rank's KV heads (init_paged_cache)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.cache = init_paged_cache(
            self.cfg, self.max_batch, self.max_seq, self.block_size,
            self.num_blocks, device=self.device, quant_kv=self.quant_kv,
            mesh=self.mesh)
        self.max_blocks_per_seq = self.max_seq // self.block_size
        self.tables = np.zeros(
            (self.max_batch, self.max_blocks_per_seq), np.int32)
        self.allocator = BlockAllocator(self.num_blocks)
        self._slot_blocks: dict[int, list[int]] = {}
        # prefix cache state
        self._ref: dict[int, int] = {}              # block -> live users
        self.radix = RadixPrefixCache(self.block_size)
        self.prefix_hits = 0                        # blocks shared
        self.prefix_queries = 0                     # full blocks looked up

    def _alloc_evicting(self, n: int):
        """Allocator alloc with LRU eviction of unpinned cached blocks.
        A doomed allocation (free + evictable < n) returns None WITHOUT
        evicting: a head-of-line request retrying every step must not
        flush everyone else's prefix cache for nothing."""
        ids = self.allocator.alloc(n)
        if ids is not None:
            return ids
        if (self.allocator.free_blocks
                + self.radix.evictable_count(self._ref)) < n:
            return None
        self.allocator.free(self.radix.evict_lru(
            n - self.allocator.free_blocks, self._ref))
        return self.allocator.alloc(n)

    # ---- host-side scheduling ----

    def reserve(self, slot: int, prompt_len: int, max_tokens: int,
                min_blocks: int = 0, prompt=None,
                defer_publish: bool = False) -> Optional[int]:
        """Reserve every block the request can ever touch (prompt + all
        generated tokens) so decode never exhausts the pool mid-flight.
        With ``prompt`` tokens and prefix caching on, the longest cached
        block-aligned prefix is SHARED (refcounted) instead of
        reallocated. Returns the number of shared prefix blocks, or None
        if the pool cannot satisfy the reservation. ``min_blocks`` lets
        prefill demand bucket-coverage. ``defer_publish`` (chunked
        prefill) skips registering the private full-prompt blocks — their
        content lands over FUTURE steps, so the engine publishes them
        chunk by chunk instead (a premature match would read garbage)."""
        need = max(blocks_for(prompt_len + max_tokens, self.block_size),
                   min_blocks)
        need = min(need, self.max_blocks_per_seq)
        shared: list[int] = []
        n_full = 0
        if self.prefix_cache and prompt is not None:
            n_full = len(prompt) // self.block_size
            self.prefix_queries += n_full
            shared = self.radix.match(prompt)
            for blk in shared:
                # refcount BEFORE any allocation below: eviction skips
                # referenced blocks, so the allocator can never hand a
                # shared block back out as someone's private block
                self._ref[blk] = self._ref.get(blk, 0) + 1
        private = self._alloc_evicting(need - len(shared))
        if private is None:
            for blk in shared:          # roll the refcounts back
                self._ref[blk] -= 1
                if self._ref[blk] <= 0:
                    self._ref.pop(blk, None)
            return None
        self.prefix_hits += len(shared)
        for blk in private:
            self._ref[blk] = self._ref.get(blk, 0) + 1
        ids = shared + private
        if (self.prefix_cache and prompt is not None
                and not defer_publish):
            # private blocks holding FULL prompt blocks become cacheable:
            # after this step's prefill-insert they contain exactly the
            # keyed content, ordered before any later sharer's reads
            self.radix.insert(prompt, ids, n_blocks=n_full)
        self._slot_blocks[slot] = ids
        row = np.zeros((self.max_blocks_per_seq,), np.int32)
        row[:len(ids)] = ids
        self.tables[slot] = row
        return len(shared)

    def publish_prompt_blocks(self, slot: int, prompt,
                              upto_tokens: int) -> int:
        """Chunked-prefill publication: register this slot's blocks whose
        content is complete (every position < ``upto_tokens`` written and
        dispatched) as shareable read-only radix nodes. Safe mid-prefill
        and after an abort — the published KV is already valid."""
        if not self.prefix_cache:
            return 0
        ids = self._slot_blocks.get(slot)
        if not ids:
            return 0
        n = min(int(upto_tokens), len(prompt)) // self.block_size
        return len(self.radix.insert(prompt, ids, n_blocks=n))

    def release(self, slot: int) -> None:
        ids = self._slot_blocks.pop(slot, None)
        for blk in ids or []:
            self._ref[blk] = self._ref.get(blk, 1) - 1
            if self._ref[blk] <= 0:
                self._ref.pop(blk, None)
                if blk in self.radix:
                    continue    # stays cached + evictable, not free-listed
                self.allocator.free([blk])
        self.tables[slot] = 0

    @property
    def reclaimable_blocks(self) -> int:
        """Free-list blocks plus cached blocks eviction could reach."""
        return (self.allocator.free_blocks
                + self.radix.evictable_count(self._ref))

    def cached_block_ids(self) -> set:
        return self.radix.blocks()

    def slot_blocks(self, slot: int) -> list[int]:
        return list(self._slot_blocks.get(slot, []))


# ------------------------------------------------------------- step bodies

def _layer_qkv(lp, x, positions, cfg, inv_freq):
    """Shared attention-input path of the paged decode AND chunked-prefill
    layer bodies: norm, projections, RoPE."""
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = llama.qkv_proj(lp, h, cfg)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    return q, k, v


def _layer_out(lp, x, o, cfg, mesh=None):
    """Shared attention-output + FFN path (see _layer_qkv)."""
    x = x + llama.out_proj(lp, o, cfg, mesh)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + llama._ffn(h, lp, cfg, mesh)


def _lm_head(params, x_last, cfg, mesh=None):
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return llama.head_logits(params, x_last, cfg, mesh).float()


# ---- quantized-pool value path (int8 / fp8_e4m3 KV) ----

def _raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor itself, or for fp8 a ``uint8`` view of its bytes: index
    reads and writes go through it, so they need no fp8 kernel."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _upcast(raw: torch.Tensor, store_dtype) -> torch.Tensor:
    """Bytes read through ``_raw`` -> their f32 values."""
    if store_dtype == torch.float8_e4m3fn:
        raw = raw.view(store_dtype)
    return raw.float()


def _kv_store(x, store_dtype):
    """f32 values -> pool storage, as ``_raw`` bytes: round (half to
    even) + clip for int8, a cast (round to nearest even) for fp8."""
    if store_dtype == torch.int8:
        return torch.round(x).clamp_(-127, 127).to(torch.int8)
    return _raw(x.to(store_dtype))


def _kv_qmax(store_dtype) -> float:
    return KV_QMAX["int8" if store_dtype == torch.int8 else "fp8_e4m3"]


def quant_scatter_rows(pool, scale, blk, off, rows):
    """Quantize-on-write for the per-step KV scatters (decode, chunked
    prefill), in place: write ``rows`` into the quantized ``pool`` at
    (blk, off) under the per-block per-kv-head ``scale``, growing scales
    monotonically (scatter-max) and requantizing each touched block's
    resident rows when its scale grows — so earlier rows stay decodable
    under the one scale the read path (kernel and oracle alike) applies.
    When the scale does NOT grow the requant ratio is exactly 1.0 and the
    stored content round-trips unchanged.

    pool [NB, bs, KV, D]; scale [NB, KV] f32; blk/off: integer, any
    common shape; rows: [..., KV, D]. Duplicate blk entries are benign:
    the scatter-max folds all their amaxes first, every duplicate then
    computes the identical grown scale and requantized resident content,
    and the new rows land at distinct offsets. Rows routed to the
    scratch block 0 only ever pollute scratch scales, which nothing
    reads. Returns (pool, scale), the same tensors."""
    blk = blk.reshape(-1).long()
    off = off.reshape(-1).long()
    rows = rows.reshape(blk.shape[0], *rows.shape[-2:]).float()
    qmax = _kv_qmax(pool.dtype)
    amax = rows.abs().amax(dim=-1)                       # [N, KV]
    old = scale[blk]                                     # [N, KV]
    scale.scatter_reduce_(0, blk[:, None].expand_as(amax), amax / qmax,
                          "amax", include_self=True)
    new = scale[blk]
    safe = new.clamp(min=1e-30)
    ratio = torch.where(new > 0, old / safe, 0.0)        # <= 1.0 always
    raw = _raw(pool)
    resident = _upcast(raw[blk], pool.dtype) * ratio[:, None, :, None]
    raw[blk] = _kv_store(resident, pool.dtype)
    q = torch.where(new[:, :, None] > 0, rows / safe[:, :, None], 0.0)
    raw[blk, off] = _kv_store(q, pool.dtype)
    return pool, scale


def dequant_gather_view(pool, scale, tables, cfg):
    """Slot-logical [B, T, KV, D] view of a QUANTIZED pool: gather the
    table's blocks, upcast, multiply each block's per-kv-head scale,
    cast to the compute dtype (the JAX package's oracle view; the fused
    kernel does the same in f32 and never rounds K/V to the compute
    dtype)."""
    idx = tables.long()
    b = idx.shape[0]
    v = (_upcast(_raw(pool)[idx], pool.dtype)
         * scale[idx][:, :, None, :, None]).to(cfg.dtype)
    return v.reshape(b, -1, *pool.shape[2:])


def paged_insert_batch(cache, k_new, v_new, blk_ids, lengths, slots):
    """Batched prefill insert: all admitted requests' KV lands in ONE
    scatter per pool, in place.

    k_new/v_new: [L, B, T, KV, D] with T == blk_ids.shape[1] * block_size;
    blk_ids: [B, nb] pool destinations where id 0 means "skip this block"
    (already-resident shared prefix blocks and pad regions — the scratch
    block absorbs those writes); lengths/slots: [B] with slot < 0 marking
    an inert pad row whose length write is DROPPED (redirected past the
    end of the length vector and discarded), never clamped onto a real
    slot.

    Quantized pools (``k_scale`` in cache) quantize-on-insert: per-block
    per-kv-head amax over the incoming rows -> scale, values round/clip
    into the storage dtype, scales scatter beside the pool. Rows past
    each request's ``lengths`` are zeroed FIRST so pad garbage can never
    inflate a final block's scale (pad rows are never attended)."""
    L, _, bs = cache["k"].shape[:3]
    b, nb = blk_ids.shape
    idx = blk_ids.long()
    if "k_scale" in cache:
        t = k_new.shape[2]
        live = (torch.arange(t, device=k_new.device)[None, :]
                < lengths[:, None])[None, :, :, None, None]
        for name in ("k", "v"):
            pool, new = cache[name], (k_new if name == "k" else v_new)
            blocks = torch.where(live, new, 0).float().reshape(
                L, b, nb, bs, *new.shape[3:])
            sc = blocks.abs().amax(dim=(3, 5)) / _kv_qmax(pool.dtype)
            safe = sc.clamp(min=1e-30)[:, :, :, None, :, None]
            _raw(pool)[:, idx] = _kv_store(
                torch.where(safe > 1e-30, blocks / safe, 0.0), pool.dtype)
            cache[name + "_scale"][:, idx] = sc
    else:
        cache["k"][:, idx] = k_new.reshape(
            L, b, nb, bs, *k_new.shape[3:]).to(cache["k"].dtype)
        cache["v"][:, idx] = v_new.reshape(
            L, b, nb, bs, *v_new.shape[3:]).to(cache["v"].dtype)
    n = cache["len"].shape[0]
    dest = torch.where(slots >= 0, slots, n).long()
    ext = torch.cat([cache["len"], cache["len"].new_zeros(1)])
    ext.scatter_(0, dest, lengths.to(ext.dtype))
    cache["len"] = ext[:n].clone()
    return cache


def resolve_decode_kernel(kernel: str, mesh=None,
                          n_kv_heads: Optional[int] = None) -> str:
    """The ``kernel=`` switch -> the path ``paged_decode_step`` runs:
    "gather" (the view oracle) or "paged" (the paged kernel: CUDA on a
    CUDA pool, its plain version on a CPU pool). "auto" and "pallas" both
    mean "paged"; the JAX names stay so configs carry over. Resolved
    names resolve to themselves.

    Under a mesh both paths run per rank on the rank's KV heads. Where
    the JAX package downgrades an unshardable topology to "gather", the
    port has no path at all (a rank's pool is its KV-head slice), so
    that raises with the JAX reason."""
    if kernel not in ("auto", "pallas", "paged", "gather"):
        raise ValueError(f"kernel={kernel!r} (want auto|pallas|gather)")
    reason = shard_unsupported_reason(
        mesh, n_kv_heads if n_kv_heads is not None else 0)
    if reason is not None:
        raise ValueError(f"cannot shard paged attention: {reason}")
    return "gather" if kernel == "gather" else "paged"


def paged_decode_step(params, token, cfg: llama.LlamaConfig, cache, tables,
                      kernel: str = "gather", mesh=None):
    """One decode step over the paged pool. token: [B] integer; tables:
    [B, max_blocks_per_seq] int32 -> (logits [B, V] float32, cache). Each
    slot's new KV row is scattered in place at its current length, then
    attention runs over ``len + 1`` rows; ``cache["len"]`` advances by
    one. Idle slots (len 0, zero table row) write scratch block 0.
    A quantized pool quantizes the new rows on write and dequantizes on
    read: inside the fused kernel ("paged") or through the dequant view
    ("gather"). ``mesh``: the rank's step (module docstring)."""
    kernel = resolve_decode_kernel(kernel, mesh=mesh,
                                   n_kv_heads=cfg.n_kv_heads)
    quantized = "k_scale" in cache
    b = token.shape[0]
    bs = cache["k"].shape[2]
    n_tab = tables.shape[1]
    pos = cache["len"]                                   # [B] int32
    positions = pos[:, None]
    inv_freq = llama.inv_freq_for(cfg, token.device)
    x = llama.embed_tokens(params, token[:, None], cfg, mesh)
    # the write cursor's block; past the table's end (a request finishing
    # mid-chunk keeps stepping) it clamps to the last entry, as the JAX
    # gather does, instead of indexing out of bounds
    blk = tables.long()[torch.arange(b, device=token.device),
                        (pos // bs).long().clamp(max=n_tab - 1)]
    off = (pos % bs).long()
    kv_len = pos + 1
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        k_pool, v_pool = cache["k"][i], cache["v"][i]    # [NB, bs, KV, D]
        q, k, v = _layer_qkv(lp, x, positions, cfg, inv_freq)
        k_sc = v_sc = None
        if quantized:
            k_sc, v_sc = cache["k_scale"][i], cache["v_scale"][i]
            quant_scatter_rows(k_pool, k_sc, blk, off, k[:, 0])
            quant_scatter_rows(v_pool, v_sc, blk, off, v[:, 0])
        else:
            k_pool[blk, off] = k[:, 0].to(k_pool.dtype)
            v_pool[blk, off] = v[:, 0].to(v_pool.dtype)
        if kernel == "paged" and mesh is not None:
            o = paged_decode_attention_shard(
                q[:, 0].contiguous(), k_pool, v_pool, tables, kv_len,
                mesh=mesh, n_kv_heads=cfg.n_kv_heads, k_scale=k_sc,
                v_scale=v_sc)[:, None]
        elif kernel == "paged":
            o = paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                       tables, kv_len, k_scale=k_sc,
                                       v_scale=v_sc)[:, None]
        elif quantized:
            k_view = dequant_gather_view(k_pool, k_sc, tables, cfg)
            v_view = dequant_gather_view(v_pool, v_sc, tables, cfg)
            o = decode_attention(q, k_view, v_view, kv_len)
        else:
            # block j of slot b holds logical positions [j*bs, (j+1)*bs):
            # table order IS sequence order
            k_view = k_pool[tables.long()].reshape(b, -1, *k_pool.shape[2:])
            v_view = v_pool[tables.long()].reshape(b, -1, *v_pool.shape[2:])
            o = decode_attention(q, k_view, v_view, kv_len)
        x = _layer_out(lp, x, o, cfg, mesh)
    logits = _lm_head(params, x[:, 0], cfg, mesh)
    cache["len"] = pos + 1
    return logits, cache


def paged_prefill_chunk(params, tokens, cfg: llama.LlamaConfig, cache,
                        tables, slot: int, offset: int, length: int,
                        share_len: int = 0, mesh=None):
    """Chunked prefill straight into the paged pool: processes ``tokens``
    [1, C] as positions offset..offset+C-1 of ``slot``'s sequence,
    attending to everything the slot's blocks already hold.

    Rows at positions >= ``length`` (the final chunk's padding) scatter to
    block 0, the pool's scratch block; so do rows at positions <
    ``share_len`` (a radix-shared prefix, whose read-only blocks must
    never be rewritten while other slots read them). Returns (x_last
    [1, D]: the PRE-final-norm hidden state at the chunk's last true row,
    and the cache). ``cache["len"]`` for the slot is NOT advanced here;
    the engine sets it once after the last chunk. A quantized pool
    quantizes on write and attends over the dequant view. ``mesh``: the
    rank's chunk (module docstring)."""
    _, c = tokens.shape
    bs = cache["k"].shape[2]
    device = tokens.device
    inv_freq = llama.inv_freq_for(cfg, device)
    pos = offset + torch.arange(c, device=device)              # [C]
    row = tables[slot].long()                                   # [nb]
    live = (pos < length) & (pos >= share_len)
    blk = torch.where(live, row[(pos // bs).clamp(max=row.shape[0] - 1)],
                      torch.zeros_like(pos))
    off = pos % bs
    positions = pos[None, :]
    x = llama.embed_tokens(params, tokens, cfg, mesh)
    quantized = "k_scale" in cache
    for i in range(cfg.n_layers):
        lp = llama.layer_params(params, i)
        k_pool, v_pool = cache["k"][i], cache["v"][i]
        q, k, v = _layer_qkv(lp, x, positions, cfg, inv_freq)
        if quantized:
            k_sc, v_sc = cache["k_scale"][i], cache["v_scale"][i]
            quant_scatter_rows(k_pool, k_sc, blk, off, k[0])
            quant_scatter_rows(v_pool, v_sc, blk, off, v[0])
            k_view = dequant_gather_view(k_pool, k_sc, row[None], cfg)
            v_view = dequant_gather_view(v_pool, v_sc, row[None], cfg)
        else:
            k_pool[blk, off] = k[0].to(k_pool.dtype)
            v_pool[blk, off] = v[0].to(v_pool.dtype)
            k_view = k_pool[row].reshape(1, -1, *k_pool.shape[2:])
            v_view = v_pool[row].reshape(1, -1, *v_pool.shape[2:])
        # row i (absolute position offset+i) attends kv rows <= offset+i
        o = _xla_attention(q, k_view, v_view, causal=True, q_offset=offset)
        x = _layer_out(lp, x, o, cfg, mesh)
    last_row = min(max(length - offset - 1, 0), c - 1)
    return x[:, last_row], cache
