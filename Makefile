# One-command CI for the whole framework (SURVEY.md §5 sanitizers row).
#
#   make ci          - sanitized C++ store tests, full pytest, multichip dryrun
#   make test        - pytest only
#   make native-asan - build the metadata store with ASan+UBSan
#   make dryrun      - 8-virtual-device sharded-training compile+execute check

PY ?= python
ASAN_FLAGS = -O1 -g -std=c++17 -Wall -Wextra -pthread \
             -fsanitize=address,undefined -fno-omit-frame-pointer

.PHONY: ci test test-torch test-kube kube-bench test-warmpool test-compile-depot test-serving-sched test-spec-decode test-fleet test-elastic test-obs test-pipeline test-pipeline-elastic test-quant test-disagg test-swarm native native-asan test-native-asan dryrun scale-proof clean

ci: test-native-asan test test-kube test-warmpool test-compile-depot test-serving-sched test-spec-decode test-fleet test-elastic test-obs test-pipeline test-pipeline-elastic test-quant test-disagg test-swarm dryrun
	@echo "CI OK"

# ONE kube-backend latency bench run (cold / warm-claim / warm-resubmit,
# ~2 min) feeding BOTH the warm-pool and the compile-depot assertions:
# phony, so each standalone target still produces a fresh JSON, but a
# single `make ci` invocation runs the bench once. No pipe — a pipe
# would swallow bench.py's own nonzero exit (no real claim / no real
# depot publish / resubmit missing the compile split).
KUBE_BENCH_JSON := /tmp/kft-kube-bench.json
kube-bench:
	JAX_PLATFORMS=cpu $(PY) bench.py --cluster kube > $(KUBE_BENCH_JSON)

test:
	$(PY) -m pytest tests/ -x -q

# the PyTorch port (kubeflow_tpu_torch) against the JAX package on the CPU;
# test_torch_xgb_kinds.py is the JAX package's PyTorchJob suite, not the
# port's. Kernel tests marked `cuda` skip without a GPU; on the card,
# `python3 chip_smoke.py` builds and checks the kernels.
TORCH_TESTS := $(filter-out tests/test_torch_xgb_kinds.py,$(wildcard tests/test_torch_*.py))
test-torch:
	JAX_PLATFORMS=cpu $(PY) -m pytest $(TORCH_TESTS) -q

# the controller/gang suites again, UNCHANGED, over KubeCluster + the fake
# apiserver (SURVEY.md §4.2 envtest role): proves the reconciler drives the
# Kubernetes REST API, not just in-memory fakes
test-kube:
	KFT_TEST_CLUSTER=kube $(PY) -m pytest \
		tests/test_controller.py tests/test_gang.py \
		tests/test_kube_cluster.py -x -q

# kube-backend warm-pool e2e (fits the tier-1 timeout budget): the race/
# claim suite, then the shared kube bench — asserting the warm_pool
# claim/fallback counters are IN the bench JSON so a silently-dead pool
# regresses visibly. Two independent teeth: bench exits nonzero unless a
# REAL warm claim happened, then the JSON contract is checked from the
# captured file.
test-warmpool: kube-bench
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_warmpool.py -x -q
	$(PY) -c "import json; \
		d = json.loads(open('$(KUBE_BENCH_JSON)').read().strip().splitlines()[-1]); \
		wp = d['extra']['warm_pool']; \
		assert wp['claims'] >= 1, ('no warm claim happened', d); \
		assert wp['fallbacks'] >= 1, ('cold fallback not counted', d); \
		assert d['extra']['warm_claim']['phases']['imports'] < 1.0, d; \
		print('warm-pool bench OK:', json.dumps(wp))"

# executable-depot e2e (compile-once-per-gang): the unit suite, then the
# shared kube bench JSON — asserting the submit→first-step phases carry
# the compile split for ALL THREE runs (cold / warm-claim /
# warm-resubmit) and the depot publish + worker-hit + claim-prefetch
# counters are IN the bench JSON. bench.py itself exits nonzero unless a
# real claim, a real publish, and a resubmit with the split all happened
# — two independent teeth, like test-warmpool.
test-compile-depot: kube-bench
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_depot.py -x -q
	$(PY) -c "import json; \
		d = json.loads(open('$(KUBE_BENCH_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; \
		assert 'compile' in e['cold']['phases'], d; \
		assert 'compile' in e['warm_claim']['phases'], d; \
		assert 'compile' in e['warm_resubmit']['phases'], d; \
		assert e['depot'].get('kft_depot_publishes_total', 0) >= 1, d; \
		assert e['depot'].get('kft_depot_worker_hits_total', 0) >= 1, d; \
		assert e['warm_pool'].get('prefetched_entries', 0) >= 1, d; \
		print('compile-depot bench OK: depot=' + json.dumps(e['depot']) \
			+ ' compile_ratio=' + str(e.get('depot_compile_ratio')))"

# serving-scheduler e2e: the scheduler + radix-cache unit suites, then a
# bounded 128-stream shared-system-prompt bench smoke. Two independent
# teeth (like test-warmpool): bench.py exits nonzero unless every stream
# completed, the radix cache REALLY hit, and the scheduler counters are
# in the JSON; the JSON contract is then re-checked from the captured
# file so a silently-dead cache or counter rename regresses visibly.
SERVING_SMOKE_JSON := /tmp/kft-serving-smoke.json
test-serving-sched:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_scheduler.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --serving-smoke > $(SERVING_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(SERVING_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; s = e['sched']; \
		assert e['prefix_hit_blocks'] > 0, ('no prefix hits', d); \
		assert e['completed'] == e['streams'] == 128, d; \
		assert e['e2e_vs_device_only'] is not None, d; \
		assert s['decode_dispatches_total'] > 0, d; \
		assert all(k in s for k in ('occupancy_ratio', 'queue_depth', \
			'preempts_total', 'prefix_hit_rate', 'admission_stalls_total')), d; \
		print('serving-sched bench OK: rps=' + str(e['requests_per_sec']) \
			+ ' prefix_hit_rate=' + str(e['prefix_hit_rate']) \
			+ ' e2e_vs_device_only=' + str(e['e2e_vs_device_only']))"

# speculative decoding + sharded-kernel e2e (ISSUE 11): the drafter/
# token-identity suite and the sharded Pallas-vs-gather parity suite,
# then a bounded spec-vs-baseline bench smoke. Two independent teeth
# (like test-serving-sched): bench.py exits nonzero unless greedy output
# was TOKEN-IDENTICAL to the non-speculative path and
# accepted_tokens_per_step held its >= 1.0 floor; the JSON contract is
# then re-checked from the captured file so a silently-vanished counter
# or ratio regresses visibly.
SPEC_SMOKE_JSON := /tmp/kft-spec-smoke.json
test-spec-decode:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_spec_decode.py \
		tests/test_paged_attention_kernel.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --spec-smoke > $(SPEC_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(SPEC_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; s = e['spec']['sched']; \
		assert e['token_identical'] is True, ('spec decode diverged', d); \
		assert e['accepted_tokens_per_step'] >= 1.0, d; \
		assert 'spec_decode_speedup' in e and 'device_step_speedup' in e, d; \
		assert s['spec_dispatches_total'] > 0, d; \
		assert s['spec_committed_tokens_total'] >= s['spec_slot_rounds_total'], d; \
		print('spec-decode bench OK: accepted/step=' \
			+ str(e['accepted_tokens_per_step']) \
			+ ' device_step_speedup=' + str(e['device_step_speedup']) \
			+ ' e2e_speedup=' + str(e['spec_decode_speedup']))"

# multi-replica serving fleet e2e (ISSUE 12): the fleet unit suite
# (ring stability, bounded-load spill, sticky canary split, autoscaler
# hysteresis, serving-vs-train claim race, canary rollback), then the
# fleet bench smoke. Two independent teeth (like test-serving-sched):
# bench.py exits nonzero unless >=2 replicas really served traffic, a
# REAL warm-claim scale-up occurred, and the JSON carries per-replica
# hit-rate + scale-latency fields; the JSON contract is then re-checked
# from the captured file so a silently-vanished counter regresses
# visibly.
FLEET_SMOKE_JSON := /tmp/kft-fleet-smoke.json
test-fleet:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_fleet.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --fleet-smoke > $(FLEET_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(FLEET_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; k = e['kube_fleet']; s = k['scale_up']; \
		assert k['warm_pool']['claims'] >= 1, ('no warm claim', d); \
		served = [p for p in k['replicas_2_affine']['per_replica'].values() \
			if p.get('generated_tokens', 0) > 0]; \
		assert len(served) >= 2, ('fewer than 2 replicas served', d); \
		assert all('prefix_hit_rate' in p for p in \
			k['replicas_2_affine']['per_replica'].values()), d; \
		assert s['total_replica_add_seconds'] is not None, d; \
		assert s['model_load_seconds'] is not None, d; \
		assert s['precompile_seconds'] is not None, d; \
		assert s['depot_outcome'] is not None, d; \
		r = e['affinity_sweep']['hit_rate_vs_baseline_2_replicas']; \
		assert r['affine'] >= 0.85, ('affine hit rate diluted', r); \
		assert k['canary']['decision'] == 'promote', d; \
		print('fleet bench OK: scale_up=' + json.dumps(s['depot_outcome']) \
			+ ' add_s=' + str(s['total_replica_add_seconds']) \
			+ ' affine_vs_baseline=' + str(r['affine']) \
			+ ' random_diluted=' + str(r['random_diluted']))"

# elastic preemption-tolerant training e2e (ISSUE 13): the elasticity +
# chaos suites (incl. the slow-marked real-process recovery e2es the
# tier-1 time-bounded run skips), then the recovery bench smoke. Two
# independent teeth (like test-warmpool): bench.py exits nonzero unless
# a REAL kill→warm-claim→resume cycle completed — a per-worker
# replacement with ZERO gang restarts, depot_outcome=hit with a warm
# claim and no cold fallback, the full recovery_seconds phase
# decomposition (detect/claim/load/rendezvous/first_step_after), and
# post-resume losses EXACTLY matching the uninterrupted baseline; the
# JSON contract is then re-checked from the captured file so a silently
# vanished phase or counter regresses visibly. (On rigs where
# cross-process CPU collectives are unsupported, the pre-existing
# 2-worker chaos e2e fails for that env reason — same as `make test`.)
RECOVERY_SMOKE_JSON := /tmp/kft-recovery-smoke.json
test-elastic:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_elastic.py \
		tests/test_chaos.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --recovery-smoke > $(RECOVERY_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(RECOVERY_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; p = e['phases']; c = e['loss_continuity']; \
		assert e['worker_replacements'] >= 1, ('no replacement', d); \
		assert e['gang_restarts'] == 0, ('fell back to gang restart', d); \
		assert e['depot_outcome'] == 'hit', ('cold compile on replacement', d); \
		assert e['replacement_warm_claims'] >= 1, ('no warm claim', d); \
		assert e['replacement_cold_fallbacks'] == 0, ('cold fallback', d); \
		assert all(k in p for k in ('detect', 'claim', 'load', 'rendezvous', 'first_step_after')), d; \
		assert c['exact'] is True and c['steps_compared'] >= 1, ('loss diverged', d); \
		t = e['trace']; \
		assert t['coherent'] is True and t['agrees_within_10pct'] is True, \
			('operator job trace disagrees with measured phases', t); \
		print('elastic recovery bench OK: recovery_seconds=' + str(d['value']) \
			+ ' phases=' + json.dumps(p) \
			+ ' resumed_from=' + str(e['resumed_from_step']))"

# end-to-end observability (ISSUE 14): the obs unit suite (span
# collector ring/races, histogram percentiles, exposition lint against
# BOTH /metrics surfaces, trace propagation under failure, profiler env
# wiring), then the obs bench smoke. Two independent teeth (like
# test-serving-sched): bench.py exits nonzero unless ONE real served
# request produced a >=6-span trace (router/server/queue/prefill-chunk/
# decode-step sharing a propagated trace id), the Perfetto export
# loads, /metrics lints clean and all three request histograms have
# nonzero counts; the JSON contract is then re-checked from the
# captured file so a silently-vanished span family or histogram
# regresses visibly.
OBS_SMOKE_JSON := /tmp/kft-obs-smoke.json
test-obs:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_obs.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --obs-smoke > $(OBS_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(OBS_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; names = set(e['span_names']); \
		assert e['trace_spans'] >= 6, ('trace too shallow', d); \
		assert {'router.route', 'server.infer', 'request.queue', \
			'prefill.chunk', 'decode.step'} <= names, names; \
		assert e['trace_coherent'] is True, ('orphan spans', d); \
		assert all(e['histogram_counts'][k] > 0 for k in ('ttft', 'itl', 'e2e')), d; \
		assert e['metrics_valid'] is True, ('exposition lint failed', e.get('metrics_lint')); \
		assert e['perfetto_events'] >= 6, d; \
		print('obs bench OK: spans=' + str(e['trace_spans']) \
			+ ' hist_counts=' + json.dumps(e['histogram_counts']) \
			+ ' export=' + str(e['perfetto_export']))"

# MPMD pipeline parallelism e2e (ISSUE 15 + interleaved ISSUE 19): the
# mpmd unit + parity suites (schedule math, transport, GPipe==1F1B
# bitwise identity, SPMD pipeline_apply oracle parity, stage rendezvous
# + per-worker replacement, per-stage depot keys, interleaved tick-plan
# validity / stash bounds / per-chunk depot keys / llama-vs-oracle
# parity), then the pipeline bench smoke. Two independent teeth (like
# test-warmpool): bench.py exits nonzero unless a REAL multi-process
# >=2-stage 1F1B run completed with its loss trajectory matching the
# SPMD oracle, measured GPipe bubble within 35% of the analytic
# (S-1)/(S+M-1) fill-drain bound (wide: machine load shifts absolute
# timings; the ORDERING gates below are load-invariant and strict),
# 1F1B (at GPipe's activation budget) STRICTLY below both, the REAL
# transformer (pipeline_llama) through the runner with the interleaved
# V=2 leg measuring STRICTLY below both the plain-1F1B llama
# measurement and the single-stage analytic floor at matched M,
# activation stash within the V-chunk accounting bound, warm-vs-cold
# interleaved loss bitwise, llama-vs-SPMD-oracle step-0 bitwise +
# <=2e-5 trajectory, per-chunk depot hits on the warm leg, per-chunk
# trace lanes, the v5p-128 bubble re-projection present,
# dcn_overlap_fraction reported, and pipeline.tick/dcn.transfer spans
# in the operator job trace; the JSON contract is then re-checked from
# the captured file so a silently vanished field regresses visibly.
PIPELINE_SMOKE_JSON := /tmp/kft-pipeline-smoke.json
test-pipeline:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_mpmd.py \
		tests/test_mpmd_interleaved.py tests/test_depot.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --pipeline-smoke > $(PIPELINE_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(PIPELINE_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; s = e['summary']; p = e['parity']; lp = e['llama_parity']; \
		assert p['schedules_bitwise_identical'] is True, ('gpipe != 1f1b', p); \
		assert p['oracle_step0_bitwise'] is True and p['oracle_max_rel_diff'] <= 2e-5, p; \
		b = s['gpipe_bubble_measured']; a = s['gpipe_bubble_analytic']; \
		assert abs(b - a) / a <= 0.35, ('gpipe bubble vs analytic', b, a); \
		f = s['one_f1b_2m_bubble_measured']; \
		assert f < b and f < a, ('1f1b did not beat gpipe', f, b, a); \
		assert s['dcn_overlap_fraction'] is not None, s; \
		assert e['one_f1b']['depot_outcome'] == 'hit', ('stage depot miss', e['one_f1b']['depot']); \
		assert e['trace']['has_pipeline_ticks'] and e['trace']['has_dcn_transfers'], e['trace']; \
		li = s['llama_interleaved_bubble_measured']; \
		lpm = s['llama_1f1b_bubble_measured']; \
		lf = s['llama_plain_floor_analytic']; \
		assert li < lpm and li < lf, ('interleaved did not beat plain+floor', li, lpm, lf); \
		assert all(x <= y for x, y in zip(s['llama_interleaved_stash'], s['llama_interleaved_stash_bound'])), s; \
		assert lp['warm_bitwise_identical'] is True, lp; \
		assert lp['oracle_step0_bitwise'] is True and lp['oracle_max_rel_diff'] <= 2e-5, lp; \
		assert lp['plain_max_rel_diff'] <= 2e-5, lp; \
		assert e['trace']['has_chunk_lanes'] is True, e['trace']; \
		assert s['v5p128_bubble_projected'] is not None, s; \
		assert 'measured' in s['est_basis'], s; \
		print('pipeline bench OK: gpipe_bubble=' + str(b) + ' (analytic ' + str(a) + ')' \
			+ ' 1f1b_2m=' + str(f) \
			+ ' llama_inter=' + str(li) + ' < 1f1b=' + str(lpm) + ' < floor=' + str(lf) \
			+ ' v5p128_proj=' + str(s['v5p128_bubble_projected']) \
			+ ' overlap=' + str(s['dcn_overlap_fraction']) \
			+ ' oracle_drift=' + str(lp['oracle_max_rel_diff']))"

# elastic MPMD pipeline e2e (ISSUE 20): the elastic suites (snapshot
# store prune/common-step, epoch fencing at TCP ingress, rollback-and-
# replay bitwise parity, mailbox poison with cause, close() frees the
# stage port for in-process rebind, double-failure and budget-exhaustion
# reconciler model tests, counter exposition lint) plus the wrap-link
# poison regressions, then the chaos bench smoke. Two independent teeth
# (like test-pipeline): bench.py exits nonzero unless a stage worker
# SIGKILLed mid-run was REPLACED (not gang-restarted) via the warm pool
# with depot hits, survivors reformed in process at the bumped epoch,
# the post-recovery loss trajectory is bitwise-equal to an unkilled
# control leg, the replayed-microbatch count equals its accounting
# bound, and the stale-frame fence counted at least one dropped frame;
# the JSON contract is then re-checked from the captured file so a
# silently vanished recovery field regresses visibly.
PIPELINE_ELASTIC_SMOKE_JSON := /tmp/kft-pipeline-elastic-smoke.json
test-pipeline-elastic:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_mpmd_elastic.py -x -q
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_mpmd_interleaved.py \
		-x -q -k "wrap_next_peer or wrap_prev_peer"
	JAX_PLATFORMS=cpu $(PY) bench.py --pipeline-chaos-smoke > $(PIPELINE_ELASTIC_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(PIPELINE_ELASTIC_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; r = e['replacement']; p = e['parity']; rec = e['pipeline.recovery']; \
		assert r['worker_replacements'] >= 1 and r['gang_restarts'] == 0, r; \
		assert r['zygote_fallbacks_during_recovery'] == 0, ('cold fork', r); \
		assert r['depot_outcome'] == 'hit', ('replacement depot miss', r); \
		assert p['full_length'] is True and p['bitwise_equal'] is True, ('replay not bitwise', p); \
		assert rec['replayed_microbatches'] == rec['replay_bound'], rec; \
		assert rec['stale_frames_fenced'] > 0 and rec['rendezvous_epoch'] >= 1, rec; \
		ph = rec['phases']; \
		assert all(k in ph for k in ('detect', 'claim', 're_rendezvous', 'restore', 'compile', 'replay_window', 'first_tick_after')), ph; \
		print('pipeline elastic bench OK: recovery=' + str(round(rec['recovery_seconds'], 3)) + 's' \
			+ ' restored_step=' + str(rec['restored_step']) \
			+ ' replayed_mb=' + str(rec['replayed_microbatches']) \
			+ ' fenced=' + str(rec['stale_frames_fenced']) \
			+ ' epoch=' + str(rec['rendezvous_epoch']))"

# quantized serving e2e (ISSUE 16): the quant suites (quantized-kernel
# vs quantized-gather-oracle exactness incl. sharded tensor=2, write-path
# scale growth, exact-parity proven bitwise, spec x quant token identity,
# counted downgrades, per-config depot keys, KFT_QUANT_* env roundtrip)
# plus the kernel parity suite unchanged, then the quant bench smoke.
# Two independent teeth (like test-serving-sched): bench.py exits
# nonzero unless int8-KV served real decode steps, teacher-forced greedy
# agreement + max logit drift landed within the budgets STATED in the
# same JSON, exact-parity mode proved bitwise, and the quantized
# param_read roofline fields (bytes_per_weight / bytes_per_kv_token /
# est_basis naming the quant config) are present; the JSON contract is
# then re-checked from the captured file so a silently-loosened budget
# or vanished field regresses visibly.
QUANT_SMOKE_JSON := /tmp/kft-quant-smoke.json
test-quant:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_quant.py \
		tests/test_paged_attention_kernel.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --quant-smoke > $(QUANT_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(QUANT_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; q = e['quality']; b = e['param_read']; \
		assert e['device_step_ms']['int8'] is not None, ('int8 never served', d); \
		assert q['within_budget'] is True, ('quality outside budget', q); \
		assert q['greedy_token_agreement'] >= q['greedy_agreement_budget'], q; \
		assert q['max_logit_drift'] <= q['max_logit_drift_budget'], q; \
		assert e['exact_parity_bitwise'] is True, ('parity hatch not bitwise', d); \
		assert b['bytes_per_weight']['quantized'] < b['bytes_per_weight']['baseline'], b; \
		assert b['bytes_per_kv_token']['quantized'] < b['bytes_per_kv_token']['baseline'], b; \
		assert 'int8' in b['est_basis'], b; \
		print('quant bench OK: agreement=' + str(q['greedy_token_agreement']) \
			+ ' drift=' + str(q['max_logit_drift']) \
			+ ' bytes/weight=' + str(b['bytes_per_weight']['quantized']) \
			+ ' bytes/kv_token=' + str(b['bytes_per_kv_token']['quantized']))"

# disaggregated prefill/decode serving e2e (ISSUE 17): the disagg unit
# suite (engine hold/export/inject hooks, TCP handoff races — abort,
# duplicate delivery, eviction pinning, decode-pod death fallback —
# tier-aware controller/autoscaler, spill-saturation trigger, tier
# labels on /metrics, TieredRouter bypass), then the disagg bench
# smoke. Two independent teeth (like test-fleet): bench.py exits
# nonzero unless a REAL cross-pod KV migration moved blocks between
# real tier processes, BOTH tier scale-up replicas depot-hit their
# stage-scoped programs, the migration decomposition landed, and the
# radix-bypass leg skipped the prefill tier with a counted
# prefill_bypasses; the JSON contract is then re-checked from the
# captured file so a silently-vanished counter regresses visibly.
DISAGG_SMOKE_JSON := /tmp/kft-disagg-smoke.json
test-disagg:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_disagg.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --disagg-smoke > $(DISAGG_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(DISAGG_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; dis = e['disagg_1p1d']; sc = e['tier_scale_up']; \
		bp = e['bypass']; hl = e['high_load_p95']; \
		assert dis['migrated_blocks'] > 0, ('no real migration', d); \
		assert dis['statuses'].get('migrated', 0) > 0, d; \
		assert dis['decode_tier']['handoffs_injected_total'] > 0, d; \
		mdc = dis['migration_decomposition']; \
		assert mdc['prefill_done_to_first_commit_s'] is not None, d; \
		assert mdc['export_s'] is not None and mdc['transfer_s'] is not None, d; \
		assert sc['prefill']['depot_outcome'] == 'hit', ('prefill tier depot miss', sc); \
		assert sc['decode']['depot_outcome'] == 'hit', ('decode tier depot miss', sc); \
		assert bp['plan_warm_prompt']['bypass'] is True, ('bypass never fired', bp); \
		assert bp['router']['prefill_bypasses'] >= 1, bp; \
		assert hl['ttft_disagg_s'] is not None and hl['itl_disagg_s'] is not None, d; \
		print('disagg bench OK: migrated_blocks=' + str(dis['migrated_blocks']) \
			+ ' handoff_p95=' + str(mdc['prefill_done_to_first_commit_s'].get('p95_s')) \
			+ ' ttft_p95 co=' + str(hl['ttft_colocated_s']) + ' dsg=' + str(hl['ttft_disagg_s']) \
			+ ' itl_p95 co=' + str(hl['itl_colocated_s']) + ' dsg=' + str(hl['itl_disagg_s']))"

# Podracer trial swarm e2e (ISSUE 18 + suggestion batching ISSUE 19):
# the swarm unit suite (shared-compile fingerprint keying,
# one-publish-then-hits through a real depot, reclaim races — kill vs
# completion exactly one terminal state, token fence against a stale
# trial's late exec, dead/gone pod counted no-op, concurrent
# convergence — suggestion determinism across controller restart,
# operator metric surface) plus the suggestion-batching suite (one
# batched draw per reconcile pass, buffered-tail re-derivation on
# restart), then the swarm bench smoke. Two independent teeth (like
# test-elastic): bench.py exits nonzero unless trials REALLY claimed
# warm zygote pods, the shared-compile invariant held (depot publishes
# == distinct structural configs, every other recorded trial a hit,
# zero local compiles), at least one early-stopped trial's pod
# completed a reclaim→re-claim cycle, the whole sweep cost exactly ONE
# suggestion-service call (max 1 per pass — ROADMAP 4c amortization),
# and trials_per_hour was measured; the JSON contract is then
# re-checked from the captured file so a silently-vanished counter or
# a collapsed warm path regresses visibly.
SWARM_SMOKE_JSON := /tmp/kft-swarm-smoke.json
test-swarm:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_swarm.py \
		tests/test_hpo_batching.py -x -q
	JAX_PLATFORMS=cpu $(PY) bench.py --swarm-smoke > $(SWARM_SMOKE_JSON)
	$(PY) -c "import json; \
		d = json.loads(open('$(SWARM_SMOKE_JSON)').read().strip().splitlines()[-1]); \
		e = d['extra']; s = e['swarm']; sc = e['shared_compile']; \
		dec = e['submit_to_first_step']; \
		assert s['warm_claims'] >= 1, ('no warm claim', d); \
		assert sc['holds'] is True, ('shared-compile invariant broken', sc); \
		assert sc['published'] == sc['distinct_structural_configs'], sc; \
		assert sc['local_compiles'] == 0, ('a trial compiled locally', sc); \
		assert e['counts'].get('EarlyStopped', 0) >= 1, ('nothing early-stopped', d); \
		assert s['reclaims'] >= 1, ('no pod reclaimed', d); \
		assert e['reclaim_cycles'] >= 1, ('no reclaim→re-claim cycle', d); \
		assert dec['warm']['trials'] >= 1 and dec['warm']['total'] is not None, dec; \
		assert e['trials_per_hour'] is not None, d; \
		assert e['metrics_exposition']['clean'] is True, e['metrics_exposition']; \
		assert e['trace']['coherent'] is True, e['trace']; \
		sg = e['suggestions']; \
		assert sg['calls_total'] == 1 and sg['max_calls_per_pass'] == 1, ('suggestion draws not batched', sg); \
		print('swarm bench OK: trials_per_hour=' + str(e['trials_per_hour']) \
			+ ' warm=' + str(s['warm_claims']) + '/' + str(s['trials_running']) \
			+ ' publishes=' + str(sc['published']) + ' hits=' + str(sc['hits']) \
			+ ' suggestion_calls=' + str(sg['calls_total']) + ' (x' + str(sg['trials_per_call']) + ')' \
			+ ' reclaim_cycles=' + str(e['reclaim_cycles']))"

native:
	$(MAKE) -C native/metadata_store

native-asan:
	$(MAKE) -C native/metadata_store clean
	$(MAKE) -C native/metadata_store CXXFLAGS="$(ASAN_FLAGS)"

# run the metadata tests against the sanitized binary, then drop it so later
# builds rebuild the optimized one (build_native() rebuilds on mtime)
test-native-asan: native-asan
	$(PY) -m pytest tests/test_metadata.py -x -q
	$(MAKE) -C native/metadata_store clean

dryrun:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
		$(PY) __graft_entry__.py dryrun 8

# AOT scale proofs (BASELINE.md rows 4-5): compile 8B serving for a v5p-8
# slice and the 70B FSDP train step for a 2-slice v5p-128 with the REAL
# XLA:TPU compiler (compile-only topology, no TPU attached); fails if the
# per-chip HBM requirement exceeds the 95G budget
scale-proof:
	JAX_PLATFORMS=cpu $(PY) -m kubeflow_tpu.parallel.aot

clean:
	$(MAKE) -C native/metadata_store clean
