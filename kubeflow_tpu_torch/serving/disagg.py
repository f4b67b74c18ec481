"""Disaggregated prefill/decode serving — the two-tier fleet's KV
migration plane (counterpart of ``kubeflow_tpu.serving.disagg``).

Prefill is compute-bound and decode is param-read-bound; co-locating them
makes chunked prefills and decode steps fight for one step budget — long
prompts inflate every live stream's ITL while queued prompts inflate
TTFT. This module splits the fleet: a PREFILL tier runs prompts to their
first token and a DECODE tier runs the steady-state token loop, joined
by live paged-KV migration over a host-staged point-to-point transport:
length-prefixed pickle frames over TCP, byte for byte the JAX package's
framing (``kubeflow_tpu.parallel.mpmd._encode``), copied here as
``_encode``. The payload's blocks are host numpy in the pool's bytes
(``paged_kv.gather_kv_blocks``: bf16 as uint16, fp8 as uint8) with the
pool dtype's name beside them (``kv_dtype``).

Ownership handoff state machine (abort-safe; blocks owned by exactly one
tier at any instant):

    PREFILL_OWNED --export+send--> MIGRATING --ack(ok)--> DECODE_OWNED
         |                            |
       abort                    ack(fail) / abort
         |                            |
         v                            v
      released                 released on BOTH sides

- PREFILL_OWNED: the finished prefill is parked in the engine's held set
  (``hold_after_prefill``); its blocks stay refcount-pinned, so eviction
  can never reach them.
- MIGRATING: the payload is on the wire / injecting. The decode side
  refcounts every imported block at ``reserve`` BEFORE scattering bytes,
  so decode-side eviction pressure cannot reclaim a mid-handoff block.
- The ack is the ownership edge: only an ``ok`` ack releases the prefill
  side. A failed ack (decode pod dead, pool full) leaves nothing live on
  the decode side and the prefill pod falls back to local re-prefill —
  its radix-published blocks make that one cheap chunk — counted as
  ``kft_disagg_migration_failures_total``.
- An abort mid-flight releases BOTH sides: the prefill engine drains its
  held slot on the next step; the decode side gets a ``release`` frame
  (or aborts at collect-abandon), and duplicate ``kv`` delivery is
  idempotent (the first injection's ack replays).

Bypass rule: a request whose every FULL prompt block is radix-cached on
its prefix-affine decode replica skips the prefill tier entirely and
admits there as a normal request at radix-hit cost (serving/router.py
``TieredRouter`` counts ``prefill_bypasses``). Imported handoffs publish
their prompt blocks to the decode pool's radix tree, which is what makes
later sharers bypassable.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
from typing import Callable, Optional

from kubeflow_tpu_torch.serving.llm import SamplingParams

# role defaults for per-tier autoscaling (the JAX package's
# serving/types.TIER_DEFAULT_SCALE_METRIC): prefill scales on the work it
# has not yet scheduled, decode on the slots its streams occupy — the two
# kft_model_sched_* signals that track each tier's actual bottleneck
TIER_DEFAULT_SCALE_METRIC = {
    "prefill": "token_backlog",
    "decode": "occupancy_slots",
}
PREFILL_SCALE_METRIC = TIER_DEFAULT_SCALE_METRIC["prefill"]
DECODE_SCALE_METRIC = TIER_DEFAULT_SCALE_METRIC["decode"]
TIERS = ("prefill", "decode")


def _encode(key: tuple, payload) -> bytes:
    """One frame: an 8-byte big-endian length, then the pickled
    ``(key, payload)`` (protocol 4)."""
    body = pickle.dumps((key, payload), protocol=4)
    return struct.pack(">Q", len(body)) + body


def _recv_exact(conn: socket.socket, n: int):
    """Exactly ``n`` bytes into one preallocated buffer (a 92 MB KV frame
    must not be rebuilt by repeated bytes concatenation), or None on a
    cleanly closed peer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = conn.recv_into(view[got:], min(1 << 22, n - got))
        if not k:
            return None
        got += k
    return buf


def _read_msg(conn: socket.socket):
    """Inverse of ``_encode``: one length-prefixed pickled frame, or
    None on a cleanly closed peer."""
    hdr = _recv_exact(conn, 8)
    if hdr is None:
        return None
    (n,) = struct.unpack(">Q", hdr)
    body = _recv_exact(conn, n)
    return None if body is None else pickle.loads(body)


class MigrationStats:
    """Thread-safe counter/seconds accumulator for the migration plane.
    ``snapshot()`` keys surface on /metrics as ``kft_disagg_*`` (the
    server renders them with model+tier labels) and in /v2 stats under
    ``disagg``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: dict[str, float] = {}

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                self._c[k] = self._c.get(k, 0) + v

    def get(self, key: str) -> float:
        with self._lock:
            return self._c.get(key, 0)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for k, v in sorted(self._c.items()):
                out[k] = round(v, 6) if isinstance(v, float) else v
            return out


class KVReceiver:
    """Decode-pod listener for KV handoffs (one frame kind per protocol
    edge):

    - ``("kv", handoff_id) + payload`` -> inject, reply
      ``("ack", handoff_id) + (ok, reason)``. Duplicate delivery replays
      the first injection's ack without re-injecting (idempotent).
    - ``("release", handoff_id)`` -> abort the injected request if it is
      still live (the prefill side lost its request mid-flight and both
      sides must release).
    """

    def __init__(self, sink: Callable, on_release: Callable,
                 bind: str = "127.0.0.1:0",
                 stats: Optional[MigrationStats] = None):
        host, _, port = bind.rpartition(":")
        self._sink = sink
        self._on_release = on_release
        self.stats = stats or MigrationStats()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host or "127.0.0.1", int(port or 0)))
        self._srv.listen(16)
        self.addr = self._srv.getsockname()     # (host, port) actually bound
        self._stop = False
        self._lock = threading.Lock()
        self._acks: dict[str, tuple] = {}       # handoff_id -> (ok, reason)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def close(self) -> None:
        """Stop listening and end the accept thread. Closing the socket
        alone does not wake an ``accept()`` blocked in another thread (on
        Linux): the thread, and through the sink the engine and its
        weights, would live on. ``shutdown`` wakes it."""
        self._stop = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                msg = _read_msg(conn)
                if msg is None:
                    return
                (kind, handoff_id), payload = msg
                if kind == "kv":
                    with self._lock:
                        dup = handoff_id in self._acks
                    if dup:
                        # duplicate delivery (sender retry after a torn
                        # connection): the first injection's ack replays —
                        # never a second slot/blocks for the same handoff
                        self.stats.add(duplicate_deliveries_total=1)
                        with self._lock:
                            ok, reason = self._acks[handoff_id]
                    else:
                        ok, reason = self._sink(handoff_id, payload)
                        with self._lock:
                            self._acks[handoff_id] = (ok, reason)
                    conn.sendall(
                        _encode(("ack", handoff_id), (ok, reason)))
                elif kind == "release":
                    self._on_release(handoff_id)
                    conn.sendall(
                        _encode(("ack", handoff_id), (True, "released")))
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass


class KVMigrator:
    """Prefill-pod sender: one connection per migration (migrations are
    per-request-rate events, and a fresh connect is what makes a dead
    decode pod a clean, counted failure instead of a wedged stream)."""

    def __init__(self, stats: Optional[MigrationStats] = None,
                 timeout_s: float = 30.0):
        self.stats = stats or MigrationStats()
        self.timeout_s = timeout_s

    def send(self, addr, handoff_id: str, payload) -> tuple:
        """-> (ok, reason). Failures (refused/reset/timeout/nack) never
        raise — the caller owns the fallback path."""
        t0 = time.perf_counter()
        frame = _encode(("kv", handoff_id), payload)
        try:
            with socket.create_connection(
                    (addr[0], int(addr[1])),
                    timeout=self.timeout_s) as s:
                s.sendall(frame)
                s.settimeout(self.timeout_s)
                msg = _read_msg(s)
            if msg is None:
                return False, "connection closed before ack"
            (kind, hid), (ok, reason) = msg
            if kind != "ack" or hid != handoff_id:
                return False, f"bad ack frame {kind!r}/{hid!r}"
            self.stats.add(bytes_sent_total=len(frame),
                           wire_seconds_total=time.perf_counter() - t0)
            return bool(ok), str(reason)
        except OSError as e:
            return False, f"transport: {e}"

    def release(self, addr, handoff_id: str) -> bool:
        """Best-effort both-sides release after a mid-flight abort."""
        try:
            with socket.create_connection(
                    (addr[0], int(addr[1])), timeout=5.0) as s:
                s.sendall(_encode(("release", handoff_id), None))
                s.settimeout(5.0)
                _read_msg(s)
            return True
        except OSError:
            return False


class TierRuntime:
    """Per-replica migration glue between the HTTP surface
    (serving/server.py /disagg routes) and the engine's held/inject
    hooks (serving/llm.py).

    Threading contract: every engine/pool touch routes through
    ``run_on_engine`` — a control op drained at the top of the engine's
    next step() — because the stepping thread updates the pool in place.
    Built against a bare engine (``model=None``), ops run inline for
    single-threaded tests that own the stepping.
    """

    def __init__(self, engine, tier: str, *, model=None,
                 stats: Optional[MigrationStats] = None):
        if tier not in TIERS:
            raise ValueError(f"tier={tier!r} (want prefill|decode)")
        self.engine = engine
        self.tier = tier
        self.model = model
        self.stats = stats or MigrationStats()
        self.migrator = KVMigrator(self.stats)
        # "no capacity" nacks are transient — a decode slot frees every
        # stream-finish — so resend for a bounded window before burning
        # a full local re-prefill on the fallback path. Retries cost only
        # the caller's thread: the prefill device slot frees at export.
        self.inject_retry_s = 6.0
        self.receiver: Optional[KVReceiver] = None
        self.kv_addr: Optional[tuple] = None
        self._lock = threading.Lock()
        self._handoffs: dict[str, object] = {}   # handoff_id -> GenRequest
        self._import_times: dict[str, float] = {}

    # ------------------------------------------------------- plumbing --

    def run_on_engine(self, fn, timeout_s: float = 30.0):
        if self.model is None:
            return fn()                 # single-threaded test mode
        box: dict = {}
        ev = threading.Event()

        def op():
            try:
                box["r"] = fn()
            except BaseException as e:          # noqa: BLE001 — relayed
                box["e"] = e
            finally:
                ev.set()

        self.engine.submit_ctl(op)
        self.model.kick()
        if not ev.wait(timeout_s):
            raise TimeoutError("engine control op timed out")
        if "e" in box:
            raise box["e"]
        return box.get("r")

    def _wait(self, pred, timeout_s: float) -> bool:
        """Wait for a request-state predicate: on the model's wake
        condition when a scheduler thread runs, sleep-poll otherwise."""
        deadline = time.monotonic() + timeout_s
        if self.model is not None:
            with self.model._wake:
                return bool(self.model._wake.wait_for(
                    pred, timeout=timeout_s))
        while not pred():
            if time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def snapshot(self) -> dict:
        out = dict(self.stats.snapshot())
        out["tier"] = self.tier
        if self.kv_addr is not None:
            out["kv_addr"] = list(self.kv_addr)
        out["handoffs_live"] = len(self._handoffs)
        return out

    # --------------------------------------------------- prefill side --

    def prefill_and_migrate(self, prompt, sampling: SamplingParams,
                            decode_addr, handoff_id: str,
                            trace: Optional[str] = None,
                            timeout_s: float = 120.0) -> dict:
        """Run the prompt through prefill to its first token, migrate the
        paged-KV blocks to ``decode_addr``, and hand ownership over.

        Returns a status dict: ``migrated`` (go collect on the decode
        pod), ``finished`` (the request ended at prefill — eos or a
        1-token budget; nothing to migrate), or a full local ``fallback``
        generation when migration failed (decode pod dead / pool full) —
        the re-prefill path, counted as a migration failure."""
        eng = self.engine
        req = eng.add_request(prompt, sampling, trace=trace,
                              hold_after_prefill=True)
        if self.model is not None:
            self.model.kick()
        if not self._wait(lambda: req.t_first_token > 0 or req.done,
                          timeout_s):
            eng.abort([req])
            raise TimeoutError("prefill did not finish")
        timings = {"prefill_s": round(req.t_first_token - req.t_enqueue, 6),
                   "t_prefill_done": req.t_first_token}
        if req.done and req.finish_reason != "abort":
            # finished AT prefill: token #1 was also the last token
            return {"status": "finished", "handoff_id": handoff_id,
                    "tokens": list(req.generated),
                    "logprobs": list(req.logprobs),
                    "finish_reason": req.finish_reason,
                    "timings": timings}
        t0 = time.perf_counter()
        payload = self.run_on_engine(lambda: eng.export_held_kv(req))
        timings["export_s"] = round(time.perf_counter() - t0, 6)
        if payload is None:
            # aborted before export: the engine already released the held
            # slot (both-sides contract — there is no decode side yet)
            self.stats.add(migration_aborts_total=1)
            return {"status": "aborted", "handoff_id": handoff_id,
                    "timings": timings}
        # The export gathered the KV to host memory, so custody moves to
        # the in-flight payload (host-staged) and the DEVICE slot frees
        # NOW — before the send. Holding it through
        # send+retries would let decode-tier backpressure eat prefill
        # slots and push the very TTFT tail disaggregation exists to cut.
        aborted = not self.run_on_engine(lambda: eng.release_held(req))
        t1 = time.perf_counter()
        ok, reason = self.migrator.send(decode_addr, handoff_id, payload)
        while (not ok and "no capacity" in str(reason)
               and not (aborted or req.aborted)
               and time.perf_counter() - t1 < self.inject_retry_s):
            time.sleep(0.1)
            self.stats.add(migration_retries_total=1)
            ok, reason = self.migrator.send(decode_addr, handoff_id,
                                            payload)
        timings["transfer_s"] = round(time.perf_counter() - t1, 6)
        if ok and (aborted or req.aborted):
            # the request died while the payload was on the wire: the
            # decode side now holds a live injected request nobody will
            # collect — release it (our side already freed at export)
            self.migrator.release(decode_addr, handoff_id)
            self.stats.add(migration_aborts_total=1)
            return {"status": "aborted", "handoff_id": handoff_id,
                    "timings": timings}
        if ok:
            self.stats.add(migrations_total=1,
                           migrated_blocks_total=payload["n_blocks"],
                           export_seconds_total=timings["export_s"],
                           transfer_seconds_total=timings["transfer_s"])
            return {"status": "migrated", "handoff_id": handoff_id,
                    "first_token": payload["first_token"],
                    "migrated_blocks": payload["n_blocks"],
                    "timings": timings}
        if aborted or req.aborted:
            # failed send AND a dead request: nothing to fall back for
            self.stats.add(migration_aborts_total=1)
            return {"status": "aborted", "handoff_id": handoff_id,
                    "timings": timings}
        # decode pod dead / pool full: fall back to re-prefill locally.
        # The held blocks were radix-published at admission, so this
        # re-prefill shares every full prompt block — one cheap chunk.
        self.stats.add(migration_failures_total=1)
        out = self.local_generate(prompt, sampling, timeout_s=timeout_s)
        out.update({"status": "fallback", "handoff_id": handoff_id,
                    "reason": reason, "timings": timings})
        return out

    def local_generate(self, prompt, sampling: SamplingParams,
                       timeout_s: float = 120.0) -> dict:
        eng = self.engine
        req = eng.add_request(prompt, sampling)
        if self.model is not None:
            self.model.kick()
        if not self._wait(lambda: req.done, timeout_s):
            eng.abort([req])
            raise TimeoutError("fallback generation did not finish")
        return {"tokens": list(req.generated),
                "logprobs": list(req.logprobs),
                "finish_reason": req.finish_reason}

    # ---------------------------------------------------- decode side --

    def attach_receiver(self, bind: str = "127.0.0.1:0") -> tuple:
        """Start the KV listener (decode tier). Returns the bound
        (host, port) — exported via stats so the router/bench learn the
        real port even under an ephemeral bind."""
        self.receiver = KVReceiver(self._import_handoff,
                                   self.release_handoff, bind=bind,
                                   stats=self.stats)
        self.kv_addr = self.receiver.addr
        return self.kv_addr

    def _import_handoff(self, handoff_id: str, payload) -> tuple:
        """Receiver sink: inject the migrated request on the engine
        thread. -> (ok, reason); a False ack leaves nothing live here and
        the prefill side keeps ownership."""
        sd = dict(payload["sampling"])
        sd["stop_token_ids"] = tuple(sd.get("stop_token_ids") or ())
        sampling = SamplingParams(**sd)

        def op():
            return self.engine.inject_request(
                payload["prompt"], sampling,
                first_token=payload["first_token"],
                first_lp=payload["first_lp"],
                blocks=payload["blocks"], n_blocks=payload["n_blocks"],
                t_enqueue=payload.get("t_enqueue", 0.0),
                kv_dtype=payload.get("kv_dtype"))

        try:
            req = self.run_on_engine(op)
        except BaseException as e:              # noqa: BLE001 — nacked
            self.stats.add(handoff_rejects_total=1)
            return False, f"inject: {e}"
        if req is None:
            self.stats.add(handoff_rejects_total=1)
            return False, "no capacity"
        with self._lock:
            self._handoffs[handoff_id] = req
            self._import_times[handoff_id] = time.time()
        self.stats.add(handoffs_injected_total=1,
                       imported_blocks_total=payload["n_blocks"])
        if self.model is not None:
            self.model.kick()
        return True, ""

    def collect(self, handoff_id: str, timeout_s: float = 120.0) -> dict:
        """Block until the injected request finishes; return its tokens
        plus the decode half of the migration decomposition."""
        with self._lock:
            req = self._handoffs.get(handoff_id)
            t_inject = self._import_times.get(handoff_id, 0.0)
        if req is None:
            return {"error": f"unknown handoff {handoff_id!r}"}
        if not self._wait(lambda: req.done, timeout_s):
            self.engine.abort([req])
            if self.model is not None:
                self.model.kick()
            return {"error": "collect timed out"}
        with self._lock:
            self._handoffs.pop(handoff_id, None)
            self._import_times.pop(handoff_id, None)
        timings = {"t_injected": t_inject,
                   "t_first_decode_commit": req.t_second_token}
        if req.t_second_token and t_inject:
            timings["inject_to_first_commit_s"] = round(
                req.t_second_token - t_inject, 6)
        return {"tokens": list(req.generated),
                "logprobs": list(req.logprobs),
                "finish_reason": req.finish_reason,
                "timings": timings}

    def release_handoff(self, handoff_id: str) -> bool:
        """Both-sides release: abort the injected request (prefill lost
        its caller mid-flight). Idempotent; unknown ids are no-ops."""
        with self._lock:
            req = self._handoffs.pop(handoff_id, None)
            self._import_times.pop(handoff_id, None)
        if req is None or req.done:
            return False
        self.engine.abort([req])
        self.stats.add(releases_total=1)
        if self.model is not None:
            self.model.kick()
        return True

    def cached_prefix_blocks(self, prompt) -> int:
        """Radix probe for the router's bypass rule: how many of the
        prompt's FULL blocks this pool already holds. Runs on the engine
        thread — match() touches LRU ticks, and the tree mutates under
        concurrent admissions."""
        return self.run_on_engine(
            lambda: len(self.engine.paged.radix.match(prompt)))
