"""The ONE Prometheus text-exposition helper — and its lint validator.

Every ``/metrics`` surface in this repo (operator daemon, model server)
renders through ``render_exposition`` so the format rules live in one
place instead of three hand-rolled f-string blocks:

- exactly one ``# HELP`` + ``# TYPE`` header per family, emitted before
  the family's first sample;
- counter families MUST end in ``_total`` (or be the ``_sum``/``_count``
  components of a timing pair) — enforced, a violation raises at render
  time instead of shipping a malformed family;
- histogram families MUST end in ``_seconds`` (every timing family in
  this repo measures seconds) and render the full cumulative
  ``_bucket``/``_sum``/``_count`` triplet via ``Histogram.render_lines``.

``validate_exposition`` is the matching lint used by the test suite and
the obs smoke: it re-parses scraped text and returns every violation,
so a counter rename or a hand-rolled exposition sneaking back in
regresses visibly.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Union

from kubeflow_tpu_torch.obs.histogram import Histogram

# counter component suffixes: _total for plain counters; _sum/_count are
# the monotonic halves of a timing pair or histogram
COUNTER_SUFFIXES = ("_total", "_sum", "_count")

# family name -> human help line (optional; a generic line otherwise)
HELP: dict[str, str] = {
    "kft_model_request_ttft_seconds":
        "Time to first token per request (enqueue -> first commit)",
    "kft_model_request_itl_seconds":
        "Inter-token latency per generated token (chunk-amortized)",
    "kft_model_request_e2e_seconds":
        "End-to-end request latency (enqueue -> finish)",
    # trial swarm (hpo/swarm.py SwarmTrialRunner + warm-pool reclaim arc)
    "kft_swarm_trials_running_total":
        "HPO trials that entered RUNNING (per experiment)",
    "kft_swarm_trials_succeeded_total":
        "HPO trials that finished with an objective value",
    "kft_swarm_trials_stopped_total":
        "HPO trials early-stopped/killed by the controller",
    "kft_swarm_pool_starvation_total":
        "Trials that cold-started because the warm pool was dry",
    "kft_swarm_reclaims_total":
        "Early-stopped trial pods returned to the warm pool as standbys",
    "kft_swarm_claim_seconds":
        "Trial submit -> worker exec latency (warm claim or cold path)",
    "kft_warm_pool_reclaims_total":
        "Claimed pods returned to standby (worker killed, token rotated)",
    "kft_warm_pool_reclaim_noops_total":
        "Reclaims of finished/dead/gone pods (counted no-op, never a crash)",
    # disaggregated serving (serving/disagg.py MigrationStats)
    "kft_disagg_migrations_total":
        "Completed prefill->decode paged-KV migrations",
    "kft_disagg_migrated_blocks_total":
        "Paged-KV blocks moved prefill->decode over the DCN transport",
    "kft_disagg_migration_failures_total":
        "Handoffs that fell back to local generation on the prefill pod",
    "kft_disagg_migration_retries_total":
        "KV sends retried after a transient no-capacity nack",
    "kft_disagg_migration_aborts_total":
        "Handoffs aborted mid-flight (released on both tiers)",
    "kft_disagg_handoffs_injected_total":
        "Handoffs admitted into a decode engine's slot map",
    "kft_disagg_imported_blocks_total":
        "Paged-KV blocks scattered into a decode pool from handoffs",
    "kft_disagg_handoff_rejects_total":
        "Handoffs a decode pod refused (pool full, bad payload)",
    "kft_disagg_duplicate_deliveries_total":
        "Duplicate kv frames answered by ack replay (idempotent)",
    "kft_disagg_releases_total":
        "Release frames that dropped an injected handoff",
    "kft_disagg_prefill_bypasses_total":
        "Requests that skipped the prefill tier on a full radix hit",
    "kft_disagg_export_seconds_total":
        "Cumulative device->host KV gather time across migrations",
    "kft_disagg_transfer_seconds_total":
        "Cumulative wire+inject time across migrations",
    "kft_disagg_bytes_sent_total":
        "Bytes of paged-KV payload sent over the migration transport",
    "kft_disagg_wire_seconds_total":
        "Cumulative socket round-trip time of kv frames",
    # elastic MPMD pipeline (parallel/mpmd.py ElasticStats)
    "kft_pipeline_recv_timeouts_total":
        "Stage recv_act/recv_grad waits that hit the recv timeout "
        "(KFT_PIPE_RECV_TIMEOUT_S) — a wedged or dead neighbor",
    "kft_pipeline_mailbox_poisons_total":
        "Microbatch windows aborted through the mailbox-poison path "
        "(sender-thread transport failures + epoch-bump signals)",
    "kft_pipeline_stale_frames_fenced_total":
        "Channel frames from a dead rendezvous incarnation dropped by "
        "the epoch fence (ingress mismatch + reform-time mailbox drain)",
}


def format_labels(**labels) -> Optional[str]:
    """The ONE inner-label-block formatter for /metrics surfaces: sorted
    ``name="value"`` pairs with empty/None values dropped, or None when
    nothing survives (so ``model=``/``tier=`` compose identically on
    every family instead of each renderer hand-rolling f-strings)."""
    kept = {k: v for k, v in labels.items() if v not in (None, "")}
    if not kept:
        return None

    def esc(v) -> str:
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    return ",".join(f'{k}="{esc(v)}"' for k, v in sorted(kept.items()))

Sample = tuple[Optional[str], Union[float, Histogram, dict]]
Family = tuple[str, str, list[Sample]]


def _check_name(name: str, mtype: str) -> None:
    if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name):
        raise ValueError(f"invalid metric family name {name!r}")
    if mtype == "counter" and not name.endswith(COUNTER_SUFFIXES):
        raise ValueError(
            f"counter family {name!r} must end in _total (or _sum/_count)")
    if mtype == "histogram" and not name.endswith("_seconds"):
        raise ValueError(
            f"histogram family {name!r} must end in _seconds "
            "(timing families are measured in seconds)")


def render_exposition(families: Iterable[Family]) -> str:
    """Families -> Prometheus text. Each family is
    ``(name, type, samples)`` with type in counter|gauge|histogram and
    samples ``[(inner_label_str_or_None, value)]``; histogram sample
    values are ``Histogram`` objects or their ``snapshot()`` dicts."""
    lines: list[str] = []
    seen: set[str] = set()
    for name, mtype, samples in families:
        if mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric type {mtype!r} for {name!r}")
        _check_name(name, mtype)
        if name in seen:
            raise ValueError(f"family {name!r} rendered twice")
        seen.add(name)
        lines.append(f"# HELP {name} "
                     f"{HELP.get(name, f'kubeflow_tpu {mtype}')}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if mtype == "histogram":
                hist = (value if isinstance(value, Histogram)
                        else Histogram.from_snapshot(value))
                lines.extend(hist.render_lines(name, labels))
            else:
                tail = f"{{{labels}}}" if labels else ""
                lines.append(f"{name}{tail} {float(value)}")
    return "\n".join(lines) + "\n"


def family_of(sample_name: str) -> str:
    """Sample name -> family name (histogram components fold in)."""
    bare = sample_name.split("{", 1)[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if bare.endswith(suffix):
            return bare[: -len(suffix)]
    return bare


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def validate_exposition(text: str) -> list[str]:
    """Lint a scraped /metrics body; returns problems ([] = valid).

    Checks: parsable sample lines; one HELP+TYPE per family before its
    first sample; counters end in _total/_sum/_count; histogram families
    end in _seconds with cumulative le-ordered buckets, a +Inf bucket
    equal to _count, and both _sum and _count present."""
    problems: list[str] = []
    types: dict[str, str] = {}
    helped: set[str] = set()
    # histogram family -> labelset -> [(le, cum)], count, sum-present
    hist: dict[str, dict[str, dict]] = {}
    samples_seen: set[str] = set()

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                problems.append(f"line {lineno}: HELP without text")
            else:
                helped.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(f"line {lineno}: malformed TYPE: {line!r}")
                continue
            fam, mtype = parts[2], parts[3]
            if fam in types:
                problems.append(f"line {lineno}: duplicate TYPE for {fam}")
            if fam in samples_seen:
                problems.append(
                    f"line {lineno}: TYPE for {fam} after its samples")
            types[fam] = mtype
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {lineno}: unparsable sample: {line!r}")
            continue
        name, labelblock, value = m.group(1), m.group(2) or "", m.group(3)
        try:
            fval = float(value)
        except ValueError:
            problems.append(f"line {lineno}: non-numeric value: {line!r}")
            continue
        fam = family_of(name)
        samples_seen.add(fam)
        mtype = types.get(fam)
        if mtype is None:
            # a bare name that IS its own family (e.g. a gauge named
            # *_count would fold wrongly) — accept exact-name TYPE too
            mtype = types.get(name)
            if mtype is not None:
                fam = name
                samples_seen.add(fam)
        if mtype is None:
            problems.append(
                f"line {lineno}: sample {name!r} has no TYPE header")
            continue
        if fam not in helped:
            problems.append(f"line {lineno}: family {fam} missing HELP")
        if mtype == "counter":
            if not fam.endswith(COUNTER_SUFFIXES):
                problems.append(
                    f"counter family {fam} must end in _total/_sum/_count")
            if fval < 0:
                problems.append(f"line {lineno}: negative counter {fam}")
        if mtype == "histogram":
            if not fam.endswith("_seconds"):
                problems.append(
                    f"histogram family {fam} must end in _seconds")
            # group the series by its labels MINUS le: split the block
            # into name="value" pairs and drop le, so the grouping is
            # independent of label ORDER (a producer emitting le first
            # must not lint as a broken histogram) and an le-only block
            # matches the bare _sum/_count lines
            pairs = re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]'
                               r'|\\.)*)"', labelblock)
            kept = [f'{k}="{v}"' for k, v in pairs if k != "le"]
            labels = "{" + ",".join(sorted(kept)) + "}" if kept else ""
            entry = hist.setdefault(fam, {}).setdefault(
                labels, {"buckets": [], "count": None, "sum": False})
            if name.endswith("_bucket"):
                le = re.search(r'le="([^"]*)"', labelblock)
                if le is None:
                    problems.append(
                        f"line {lineno}: histogram bucket without le")
                else:
                    entry["buckets"].append((le.group(1), fval))
            elif name.endswith("_count"):
                entry["count"] = fval
            elif name.endswith("_sum"):
                entry["sum"] = True
            else:
                problems.append(
                    f"line {lineno}: stray histogram sample {name!r}")

    for fam, series in hist.items():
        for labels, entry in series.items():
            where = f"{fam}{labels or ''}"
            buckets = entry["buckets"]
            if not buckets:
                problems.append(f"{where}: histogram with no buckets")
                continue
            if buckets[-1][0] != "+Inf":
                problems.append(f"{where}: last bucket is not le=+Inf")
            finite = [float(le) for le, _ in buckets[:-1]]
            if finite != sorted(finite):
                problems.append(f"{where}: bucket bounds not ascending")
            counts = [c for _, c in buckets]
            if counts != sorted(counts):
                problems.append(f"{where}: bucket counts not cumulative")
            if entry["count"] is None:
                problems.append(f"{where}: missing _count")
            elif buckets[-1][1] != entry["count"]:
                problems.append(
                    f"{where}: +Inf bucket != _count "
                    f"({buckets[-1][1]} vs {entry['count']})")
            if not entry["sum"]:
                problems.append(f"{where}: missing _sum")
    return problems
