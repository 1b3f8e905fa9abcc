#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``policy_server_tpu_torch``) on
one NVIDIA card: ``python3 chip_smoke.py`` from the repository root.

Phases, each reported on its own line(s), every line of numbers with the
card's name and power limit:

1. card and build — the card's name and power limit, the torch and CUDA
   versions, an nvcc build of the kernel library from ``csrc/`` (timed,
   with ptxas' registers and spills for both instances of the
   policy-matrix kernel: arenas in shared memory and spilled) beside a g++
   build of the native encoder from ``csrc/fastenc.cpp``, and the
   ``probe`` kernel against ``x + 1`` (exact), timed beside ``torch.add``
   (where it is slower, with the host's cost per call of each);
2. ``policy_matrix`` against its plain PyTorch version on the card — the
   32-policy flagship set, firehose batches at B = 51, 128 and 1024 for
   both schema buckets in the narrow and transport forms, the
   every-opcode tape (``tests/torch_tape_coverage.py``, divisors as shifts
   and as divisions) at B = 51, 129 and 1029 on sparse random bytes, and
   an allow-list at the shared-memory limit (arenas spilled) at B = 51 and
   129; allowed and rule matrices must be exactly equal (tolerance 0:
   verdicts are booleans and int32 rule indices, f32 values are only
   compared); median kernel and plain times per call, from CUDA events
   around back-to-back calls, beside PR 1's kernel times; and the
   environment's device step at B = 128 split into its phases, beside the
   serving path's page-locked enqueue and fetch;
3. the main path over HTTP — the port's server on 127.0.0.1 with the
   flagship set on the card, 1,024 distinct firehose AdmissionReviews
   POSTed to /validate across all 32 policy ids from 128 client threads,
   at the default flags and with no host routing and no verdict cache
   (``--host-fastpath-threshold 0 --verdict-cache-size 0
   --latency-budget-ms 0``, the kernel-only run), each with the batcher's
   four pipeline workers and again with one; every body must equal what
   the port's host oracle gives for the same request; launch counts are
   zeroed just before each server is built and read after its warmup and
   after the run: ``probe`` must have run at the build, and in the
   kernel-only run every micro-batch must launch ``policy_matrix`` after
   the warmup (at the default flags, batches of at most 64 rows are
   answered on the host, so this traffic may launch it only in the
   warmup: the serving launches are printed, not required); no kernel or
   CUDA error, no breaker trip; requests/s, p50/p99 latency, host-routed
   and device batches, serving launches, dedup hits, the slowest
   answer's time from submission against the 2 s ``policy_timeout``, and
   the garbage collections during the run (full ones, the longest). Each
   server runs with ``--enable-metrics`` and its readiness port on any
   free port: /readiness there must answer 200, /metrics must count one
   ``kubewarden_policy_evaluations_total`` per request and, with
   ``accepted="false"``, the oracle's rejections (the verdict before the
   mode's constraints), and /debug/timeline must parse with the run's
   phases; the flight recorder's attribution of each run is printed (µs
   per row of each phase, the residual's share of batch wall time, the
   cache-hit/miss batch split). One more kernel-only run with one
   pipeline worker and ``--flight-recorder off`` gives its rate beside
   the recorder-on run's, with the recorder's modeled overhead (events
   written × the measured cost of one event ÷ wall);
4. the native pipeline — the encoder's build, its packed rows byte-equal
   to the Python trie's on phase 3's reviews in both buckets; the 1,024
   reviews, their exact replay (no launch: the blob tier answers) and a
   replay with new uids (no launch: the row tier answers), every body
   equal to the oracle's, with ``dedup_stats``; and the breaker tripped by
   five ``device.fetch`` faults, answering from the oracle while open, and
   recovered by a half-open probe that launches the kernel again;
5. the host fast path against the device path per batch size (B = 1, 8,
   16, 32, 64, 128; median wall over distinct flagship batches, the
   verdict cache off, both answers equal) and the crossover; routing and
   defaults do not change;
6. a short kernel-only HTTP run (256 requests) under
   ``profiling.start_device_trace``: the card's busy share (the union of
   its kernel, copy and memset intervals in the ``torch.profiler`` trace)
   and idle share over the traced window; a trace without a kernel fails;
   with the flight recorder merged into the trace on its clock, the
   recorder's ``idle_by_phase`` summary, and K1's launches that start
   inside a ``submit`` span (99% at least, and the summary summing to the
   idle time within 1%, or the phase fails);
7. the native HTTP frontend on the card — the server with the flagship
   set, ``--frontend native --enable-metrics``, driven by a client in a
   separate process (this script re-invoked with ``--native-client``: raw
   sockets, 32 keep-alive connections, 8 requests pipelined on each):
   phase 3's 1,024 reviews in 4 waves, each wave with fresh uids, at the
   default flags, kernel-only with four pipeline workers and kernel-only
   with one; every body must equal the port's host oracle's; in the
   kernel-only runs every micro-batch must launch ``policy_matrix`` after
   the warmup; ``policy_server_native_http_requests_total`` and
   ``kubewarden_policy_evaluations_total`` must rise by exactly the
   requests sent (the latter's ``accepted="false"`` part by the oracle's
   rejections), with 0 parse fallbacks, breaker trips, device errors and
   deadline rejections; requests/s per wave and in all, p50/p99, rows per
   micro-batch and per admitted burst, host-routed and device batches,
   serving launches, the flight recorder's attribution with the native
   phases, phase 3's numbers from this call beside them, and one more
   kernel-only run (one wave) under ``profiling.start_device_trace`` for
   the card's busy share and phase 6's checks of the merged trace.

8. reload, rollback and self-heal on the card — the server built through
   the command line (``__main__.build_cli`` + ``server_from_args``) from a
   policies file (JSON) at the default flags plus ``--frontend native
   --enable-metrics --reload-admin-token`` and ``--selfheal-interval-seconds
   0.2`` (so ``--policy-reload-mode auto`` watches the file), driven by the
   phase 7 client process: wave A under the flagship set; the file
   rewritten to a changed set (trusted-repos' settings changed,
   ``baseline-canary`` removed) and wave B sent while the watch reloads
   (every body equal to the old set's oracle or the new one's); wave C
   after the promotion (the new set's oracle, ``policy_server_policy_epoch``
   1); ``POST /policies/rollback`` and wave D (the old set's); a
   ``reload.canary`` raise armed and the file rewritten with the same set
   in other bytes: the reload is rejected, the failure and rollback
   counters rise by one, wave E is the old set's; five reload-and-rollback
   cycles through the admin endpoints with no traffic, each reload's wall
   time per stage, its K2 launches (the candidate's build) and its K1
   launches in the warmup and in the canary apart, and after each cycle
   ``torch.cuda.memory_allocated`` and ``max_memory_reserved`` (the phase
   fails if the allocation after the fifth cycle exceeds the second's by
   more than 1 MiB); the drainer killed (a ``frontend.accept`` action that
   ends its thread; the burst it held answers 500) and the dispatch loop
   killed (``shard.dispatch``), both revived by the watchdog, each revive
   counter +1 on /metrics, wave F answered by the serving set's oracle;
   then ``stop()`` with a wave in flight: every answer a verdict of the
   serving set or the in-band 503 "policy server shutting down", none a
   500. p50/p99 of waves A, B and C. The changed set's K1 programs are
   held against their plain version at B = 128 in both buckets. Launch
   counts are zeroed just before the server is built and read after it
   stops.

9. tenants, shedding and shards on the card — the server built through
   the command line at the default flags plus ``--frontend native
   --enable-metrics --serving-shards 2`` and a JSON ``--tenants`` manifest:
   ``team-a`` serves phase 8's changed set, ``team-b`` the first 12 of the
   flagship set's ids with a quota (400 rows/s, burst 400) and a 500 ms
   ``request-timeout-ms``; every tenant's plane is a shard router over two
   environments (six on the card). Waves from the phase 7 client process:
   T, 1,024 reviews over the default tenant, team-a and team-b (every body
   its tenant's oracle's) and an unknown tenant (the 404 of the port's
   ``unknown_tenant_message``), with ``/readiness/team-a`` 200; Q, team-b
   past its quota (its 1,024 rows all in flight at once over 128
   connections) beside a team-a wave (team-b answers its oracle's body
   or 429 with Retry-After and the shed body, as many 429s as
   ``policy_server_tenant_shed_rows{tenant="team-b"}`` rises; team-a's
   bodies its oracle's); X, a ``device.fetch`` sleep scoped to team-b
   (its batchers sent to the device for the wave) past its deadline:
   queued rows answer the in-band 504 "request deadline exceeded before
   evaluation", as many as team-b's expired-row counter rises (the
   /metrics family, as the JAX package's, reads the default tenant); S,
   ``shard.dispatch`` killing the default tenant's shard 0 under a wave:
   fenced within one heartbeat (plus ``S_FENCE_ALLOWANCE_S``) of its
   thread's end, its rows re-routed or answered the fenced 503, every request answered once, the shard revived in place,
   ``policy_server_shard_fences`` and the self-heal revives +1 each. Per
   environment: tenant, shard, build and warmup seconds, K1 program build
   seconds, ``memory_allocated`` of its build and warmup, K2 and K1
   launches; ``memory_allocated`` after the stop. Team-b's K1 programs
   (the one set no other phase holds) exact against their plain version
   at B = 128, both buckets. Then req/s and p50/p99
   of a default-flag native server at ``--serving-shards 1`` and 2
   (measured only).

10. audit on the card — the server built through the command line at the
   default flags plus ``--frontend native --enable-metrics
   --reload-admin-token`` and ``--audit-mode interval
   --audit-interval-seconds 1 --audit-matrix --audit-matrix-whatif
   --audit-resources-file`` (a JSON file of 1,024 distinct pod objects
   from the seeded firehose, one in eight widened). Wave B: the boot sweep
   (1,024 × 32 pairs on the audit lane) timed from ``start()`` while the
   phase 7 client sends 1,024 /validate reviews (every body the oracle's),
   with its rows, audit batches, preemptions and K1 launches (the audit
   lane's from the flight recorder's ``device_execute`` events without a
   batch id, every audit batch at least one, no host fallback), the live
   p50/p99 beside the same wave sent again after it (the verdict cache
   cleared); ``GET /audit/reports`` on the readiness port equal, row by
   row and in its summary, to the host oracle's audit-origin verdicts of
   the snapshot's rows, and 304 for its ETag; a second full sweep with
   ``memory_allocated`` within 1 MiB of the first's. Wave M: 512 UPDATE
   reviews, their dirty sweep, then the same with fresh uids: every body
   the oracle's, ``policy_server_audit_matrix_lookup_hits`` up by the
   frag-eligible pairs, only the ineligible rows reach the batcher and
   K1. Wave P: a stream client (this script re-invoked with
   ``--stream-client``) from cursor 0, then phase 8's changed set through
   ``POST /policies/reload``: the what-if names the changed column and
   counts the oracle's flips in the snapshot's first 256 rows (the JAX
   package's sample of 32 bounds that count), the promotion's sweep is a
   dirty-column sweep of one column over the inventory, and the matrix
   and the client's view equal the new set's oracle (the stream's deltas
   exactly the oracle's changes unless the client overflowed and
   resynced, which is printed). Wave R: ``POST /policies/rollback`` marks
   the promoted epoch's rows stale, a full sweep follows, the reports
   equal the old set's oracle again and the stream carries the flips
   back; a reconnect at a cursor 100 entries back replays exactly those.
   Launch counts are zeroed before the build and read after the stop;
   ``memory_allocated`` after the stop within 1 MiB of before the build.
   Then K1 exact against its plain version on the inventory's packed rows
   at B = 8, 16 and 64, both buckets, timed.

11. TLS and the prefork workers — servers built through the command line
   at the kernel-only flags with the flagship set, certificates made with
   ``cryptography`` under ``build/chip_smoke_tls/``. Wave L: ``--frontend
   native`` with ``--cert-file``, ``--key-file`` and ``--client-ca-file``;
   the phase 7 client in its TLS mode, presenting a client certificate the
   CA issued, sends 1,024 reviews (every body the oracle's, K1 launched,
   ``policy_server_tls_native_termination`` 1, one handshake per
   connection); a client with no certificate and one with another CA's are
   refused, each counted once in ``handshakes_failed``. Wave R, on the same
   server, under client waves that keep sending: a cert-only write changes
   nothing; with the key written too, new connections see the new serial
   within a digest poll plus 1 s while a connection opened before keeps
   being answered under the old one; ``tls_reloads`` and
   ``tls_generations`` rise by 1; a corrupt PEM (SIGHUP) keeps the last good
   identity and counts 1 reload failure; the expiry gauge is the serving
   certificate's notAfter. Wave S: the same reviews over TLS on
   ``--frontend python``. Wave P: plaintext ``--http-workers 4`` and 1
   under each frontend, 1,024 reviews over 64 connections (every body the
   oracle's; workers answered part of them: the native main loop framed
   fewer than were evaluated, or the bridge carried frames); one worker
   SIGKILLed is respawned once within 2 s plus 1 s, and the next 256
   reviews are answered; ``stop()`` leaves no worker, socket or directory.
   Rates (req/s, p50, p99) of every wave, beside phase 7's plaintext
   native kernel-only run.

12. host-executed policies — the native wasm core (g++ of
   ``policy_server_tpu_torch/csrc/wasmint.cpp`` in phase 1) on each ABI's
   fixture (``tests/torch_wasm_fixtures.py``: waPC, OPA/Gatekeeper with
   host builtins, WASI) over 256 firehose requests: its verdicts equal
   the interpreter's (``PSTPU_NO_NATIVE_WASM=1``), µs per evaluation for
   each engine and the engine counts. The lowered CEL programs (a
   variable, ``all``, ``exists_one``, the CEL tests' corpus) on K1 against
   its plain version at B = 51, 128 and 1,024, both buckets, narrow and
   transport, tolerance 0, timed beside phase 2's flagship program. Then
   the flagship set plus seven host-executed entries (39 ids: a lowered
   CEL policy under ``builtin://cel-policy`` and under its upstream
   ``registry://`` reference, a host-interpreted CEL policy, waPC, OPA and
   WASI policies, and the group ``wasm-guard = wasmpriv() && ns()``)
   through ``PolicyServer(module_resolver=...)`` under ``--frontend
   native``: phase 3's 1,024 reviews over all 39 ids and a flagship-only
   wave of the same shape, at the default flags and kernel-only (every
   micro-batch holding a device-routed row launches K1), then a replay
   with the verdict cache on (the wasm engine runs again, only batches
   with ``wasm-guard`` rows launch K1); every body the port's oracle's
   over the same modules, the /metrics counts exact, the host evaluators'
   time beside the flight recorder's attribution. Last, a spinning guest
   under ``--policy-timeout 0.2``: its rows answer "execution deadline
   exceeded" 500, flagship rows sent alone answer normally, rows batched
   with (or queued behind) a spinning one answer the same deadline body
   (counted), and the breaker does not trip.

13. policy acquisition, cluster context and the audit watch feed —
   servers built through the command line (``build/chip_smoke_fetch/``).
   Wave F: the flagship policies whose programs ``serde`` carries (27 of
   32; the signature policies, the mutating ones and the groups stay
   builtins) written as ``.tpp.json`` artifacts, each signed with an
   ed25519 key and with a keyless bundle of this script's own PKI (trust
   root in ``--sigstore-cache-dir``), served a third each over
   ``file://``, ``https://`` (an in-script HTTPS host whose CA is only in
   ``sources.json``'s ``source_authorities``) and ``registry://`` (an
   in-script OCI registry: the anonymous token flow, one repository
   behind basic auth from ``--docker-config-json-path``, two whose blobs
   answer 307 to a storage host that refuses ``Authorization``);
   ``verification.json`` requires the key and the keyless identity on
   every artifact. Each frontend boots it kernel-only (boot seconds split
   into fetch, verify and the rest) and answers 1,024 reviews, every body
   the host oracle's over the same artifacts, every device batch with a
   K1 launch; K1 exact against its plain version on the fetched programs.
   A tampered artifact fails the boot with ``VerificationError``; under
   ``--continue-on-errors`` its id answers that error and the others
   serve; ``fetch.http`` faults are retried 3 times (counted), then the
   boot fails with the downloader's ``FetchError``. Wave R: 8 reloads
   through ``POST /policies/reload`` (the file watch may add one of the
   same file), one registry policy switched between tags ``:v1`` and
   ``:v2`` (another policy's rules): after each, 128 kernel-only reviews
   (a quarter to that policy) equal that set's oracle, and
   ``memory_allocated`` and ``max_memory_reserved`` are printed (the
   allocation after the last cycle within 1 MiB of the second's). Wave
   C: a fake Kubernetes API over HTTPS (token and ``ca.crt`` in a
   service-account directory; the client's address and directory set
   in-process before the servers are built) listing 200 namespaces;
   ``namespace-exists`` with ``contextAwareResources`` beside the
   flagship set at the default flags and kernel-only, 1,024 reviews over
   220 namespace names (half to namespace-exists), then 20 DELETED and 20
   ADDED events, the seconds from the last event's send to the first
   answer that reflects it, and a second wave: every body the oracle's
   with the same snapshot, the default verdict cache on; K1 exact on
   rows carrying 200 and 256 namespaces (B = 128, both buckets); at 257
   namespaces every context row goes to the host and no K1 launches.
   Wave W: ``--audit-mode interval --audit-watch
   --audit-watch-resources v1/Pod`` against the fake API listing 512
   pods, then 512 ADDED, MODIFIED and DELETED events with a 410 ERROR
   between the halves: the feed and the watch families on /metrics count
   exactly 512 events, 0 drops and 1 resync, every report row equals
   the oracle's, and the seconds from an event's send to its report row
   (p50, p99) and the audit lane's K1 launches are printed.

14. crash recovery — phase 13's fetched set (27 artifacts, its sources
   and signatures) served by server processes (``python -m
   policy_server_tpu_torch``, run by this script re-invoked with
   ``--recovery-server``, which adds a SIGUSR1 command channel for the
   launch counts and the chaos sites) with ``--state-dir``,
   ``--enable-metrics`` and the kernel-only flags, under
   ``build/chip_smoke_recovery/``. Cold boot: 1,024 reviews, every body
   the oracle's, every micro-batch launching K1 (counts set to 0 just
   before each wave and read just after; no host-routed batch). SIGKILL
   with 256 requests in flight (the dispatch loop stalled by a
   ``shard.dispatch`` sleep, the kill once all 256 wait in its queue;
   none answered). Warm boot with the registry and HTTPS hosts stopped,
   the ``file://`` sources deleted and ``FAILPOINTS=fetch.http=raise``:
   ``policy_server_boot_warm`` 1, 27 artifact-cache hits, 0 degraded
   sources, 0 quarantined files and 0 files downloaded; K2 at the build;
   the same 1,024 reviews as at the cold boot. A changed policies file
   (one builtin id dropped) with the sources still down: the boot
   degrades loudly (``degraded_sources`` ≥ 1) and 256 reviews equal the
   changed set's oracle. A flipped byte in ``manifests.journal``'s newest
   record: quarantined at the next boot (``--serving-shards 2``), which
   lands on the generation before it and serves; a ``shard.dispatch``
   raise in shard 0 fences it and the heartbeat revives it; SIGKILL; the
   next boot's shard counters on /metrics equal those before the crash.
   Each boot's time to ready (the metric, and the wall clock from the
   process's start to /readiness 200), each wave's rate, p50 and p99,
   and K1 and K2 launches are printed.

15. the audit side's warm resume and the OTLP export — server processes
   as in phase 14 under ``build/chip_smoke_resume/``. Wave A:
   ``--state-dir --audit-mode interval --audit-matrix --audit-watch``,
   kernel-only, with both spill cadences at 5 s
   (``--state-audit-spill-seconds``, ``--audit-matrix-spill-seconds``),
   over phase 13's fake Kubernetes API listing 4,096 pods. The cold boot's
   time to compliance runs from the process's start until no row is dirty
   and no sweep runs; then every snapshot row, matrix cell and report row
   is checked against the oracle. Each kind of spill's seconds and bytes
   (on the cadence, and forced); 1,024 live reviews with the cadence
   spills held off, then 1,024 more with one forced spill of each kind
   inside (p99 beside p99; there an answer is the oracle's or, past the
   2 s policy timeout while the spill holds the GIL, the in-band
   "execution deadline exceeded", counted); once a cadence spill of each
   kind covers the
   settled state, SIGKILL with 128 requests queued behind a stalled
   dispatch loop; 64 MODIFIED and 8 DELETED events while it is down. The
   warm boot: 0 LISTs, every spilled row and cell restored and none left
   dirty, exactly the 64 modified pods re-judged (no column sweep) and the
   8 deleted ones evicted, K1 launched on the audit lane, every cell and
   the re-judged report rows the oracle's, and its time to compliance
   beside the cold one. Then a flipped byte in the matrix journal's head
   record: quarantined, 0 cells restored, one full sweep, every row, cell
   and report row the oracle's. Wave O: where ``grpc`` and
   ``google.protobuf`` import, an in-process gRPC collector
   (``tests/torch_otlp_collector.py``) and servers with ``--enable-metrics
   --log-fmt otlp`` (``OTEL_EXPORTER_OTLP_ENDPOINT`` the collector's)
   under the native frontend (1,024 kernel-only reviews) and the standard
   library's (256), each request with a ``traceparent`` of its own: every
   body the oracle's, each header's trace and parent ids on the spans the
   JAX package's rule emits for it (native: one ``policy_evaluation``;
   standard library: ``validation`` and its ``policy_evaluation`` child),
   spans received + dropped = emitted, and the last metrics push's
   ``kubewarden_policy_evaluations_total`` equal to the /metrics pull
   after the wave; req/s and p99 beside the same waves under ``--log-fmt
   json``. Without ``grpc``: each otlp server's ERROR lines, every body
   the oracle's, and a line saying the export was verified by the CPU
   tests only. For the time limit, phase 10's inventory is 1,024 pods,
   phase 13's wave W lists 512 pods and sends 512 events (8,192 and 2,048
   before this phase) and its wave R makes 8 reloads (20 before); phase
   16 cut this phase's inventory to 4,096 pods (8,192 before).

16. the columnar delta-plane path, the compile cache and the lock-order
   sanitizer. Wave X: the flagship set built from the command line under
   ``--frontend native``, kernel-only, ``--policy-timeout 30`` (a slow
   host's queueing is not a deadline there), once each at ``--kernel xla``,
   ``--kernel xla --columnar off``, ``--kernel xla --donate-buffers off``
   and ``--kernel pallas --no-warmup``, each answering phase 7's 1,024
   reviews (one in eight large; twice, with new uids, without the warmup)
   with every body the oracle's; under
   ``xla`` no ``policy_matrix`` launch, under ``pallas`` every bucket
   armed and one launch per K1 dispatch; each run's seven columnar
   families, ``plane_program_compiles``, ``pallas_stats``, shipped bytes
   per row against the transport form's, delta columns shipped against
   available, and peak ``memory_allocated`` over the wave. The device step
   at B = 128 and 1,024 in each bucket, one environment, the same rows:
   the columnar program (delta planes, rebuild, the non-Pallas program),
   the packed non-Pallas program and K1's step, their outputs equal, each
   with stream ms per step (CUDA events around the enqueue and its fetch),
   host wall ms, and the kernels and copies of one step in a
   ``torch.profiler`` trace. Wave C: two server processes (this script
   re-invoked with ``--cache-boot``) over one fresh
   ``--compilation-cache-dir``: the first builds the kernel library, the
   encoder, the native frontend and the wasm core there (each one's build
   seconds), the second builds none; both answer 128 reviews with the
   oracle's bodies. Wave L: ``tests/torch_locksan_drive.py`` on the card,
   the port's sanitizer armed before the package is imported: 512 reviews
   through the native frontend and 128 through the standard library's,
   one reload; its acquisitions, order edges and long holds; any
   lock-order inversion fails.

17. the device mesh — wave A: phase 7's 1,024 reviews through the native
   frontend, kernel-only, under ``--mesh auto`` and ``--mesh data:1``
   (servers from the command line): on one card neither lays a mesh,
   every body is the oracle's and every device batch launches K1 (once
   per schema bucket it reaches; launches per batch beside phase 7's run
   without the flag); ``--mesh data:2`` on one card must
   end ``python -m policy_server_tpu_torch`` non-zero with "mesh 2x1 does
   not match device count 1". Wave V: meshes over one card taken four
   times (``make_mesh(..., devices=[cuda:0] * 4)``) at ``data:4``,
   ``data:2,policy:2`` and ``data:1,policy:4``, each under armed
   ``--kernel pallas`` and under ``--kernel xla`` with columnar on, beside
   no mesh: the 1,024 reviews through ``validate_batch``, every body the
   oracle's, K1 launched once per position per K1 step (none under xla);
   each policy shard's K1 program against its plain version on the card
   at B = 128 and 1,024 in both buckets, exact; each form's device step at
   B = 128 (K1's step, or the plane step under xla): stream ms, host wall
   ms, and the kernels and copies of one step in a ``torch.profiler``
   trace. Wave D: two server processes (``tests/torch_mesh_drive.py``)
   with ``--distributed-coordinator 127.0.0.1:PORT
   --distributed-num-processes 2 --distributed-process-id {0,1} --mesh
   auto`` on one card: one ``torch.distributed`` group over gloo, a global
   ``data:2`` mesh, each process serving its own 512 reviews through the
   native frontend with the oracle's bodies, launching K1, columnar off.
   Wave R: ``--mesh data:N`` and ``data:N/2,policy:2`` through the
   command line over the N cards, native, kernel-only: every body the
   oracle's, K1 launched once per position per K1 step, rates and p99.
   On one card a line says the multi-card wave was skipped and why, and
   the wave runs its 512 reviews over that card taken twice (the mesh's
   default device list replaced), so its code runs on every machine.

18. the threaded policy-shard dispatcher (``--mesh-dispatch threaded``,
   ``PolicyShardedEvaluator``) — wave T: phase 7's 1,024 reviews through
   the command line at ``--mesh data:1,policy:2`` and ``data:2,policy:2
   --mesh-dispatch threaded``, native, kernel-only, over the cards where
   there are enough, else card 0 taken 2 or 4 times (the mesh's default
   device list replaced): every body the oracle's, K1's launches the sum
   over shards of that shard's K1 steps times its row's positions, the
   probe once per shard environment built, every shard's K1 program equal
   to its plain version at B = 128 and 1,024 in both buckets; rates and
   p99 beside the fused form's at the same mesh on the same wave (and
   phase 17's where it ran that mesh), and a step of every
   shard at B = 128 (stream ms, host wall ms, kernels and copies). Wave Z:
   an in-process evaluator at ``data:2,policy:2`` serves 1,024 reviews on
   four threads while it resizes to 2 entries and back to 4: every answer
   the oracle's, 2 resizes, every retired snapshot's environments closed
   once drained, ``memory_allocated`` before, between and after. Wave P:
   ``acceptance_psum`` over ``data:4`` on the card equals numpy's column
   sums of a 1,024-row K1 step's allowed bits, which are the oracle's.
   (Phase 17's wave D also sums each rank's bits through the gloo group.)

Then one JSON line of per-kernel numbers, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line is printed. Needs one card; imports nothing of JAX.

``python3 chip_smoke.py --native-client PORT CORPUS OUT CONNS DEPTH
[tolerate-close] [tls | tls=CERT,KEY]`` is the load generator of phases 7
to 13: it needs neither torch nor the package (``tolerate-close``: a
connection the server closes leaves its unanswered requests empty instead
of failing the run; ``tls``: HTTPS, with a client certificate for mTLS).
``python3 chip_smoke.py --stream-client PORT CURSOR OUT STOP`` is phase
10's ``/audit/stream`` reader. ``python3 chip_smoke.py --recovery-server
CONTROL COUNTS ARGS...`` is the server process of phases 14 and 15.
``python3 chip_smoke.py --cache-boot DIR POLICIES CORPUS OUT [ARGS...]``
is phase 16's wave C server process.
"""

from __future__ import annotations

import copy
import gc
import http.client
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bandwidth and non-tensor-core
# float32 rate — the tape's element operations are 32-bit compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

N_REQUESTS = 1024
CLIENT_THREADS = 128
PHASE2_BATCHES = (51, 128, 1024)
SWEEP_BATCHES = (1, 8, 16, 32, 64, 128)
SWEEP_REPS = 7
TRACED_REQUESTS = 256
NATIVE_CONNS = 32
NATIVE_DEPTH = 8
NATIVE_WAVES = 4
# phase 8: wave sizes, reload-and-rollback cycles, the admin token and
# the self-heal cadence
RELOAD_WAVE = 512
RELOAD_B_WAVE = 256
RELOAD_F_WAVE = 256
RELOAD_STOP_WAVE = 1024
RELOAD_CYCLES = 5
RELOAD_TOKEN = "chip-smoke-admin-token"
RELOAD_SELFHEAL_SECONDS = 0.2
# a plateau: the allocation after the last cycle within this of the
# second cycle's
RELOAD_MEMORY_SLACK = 1 << 20
# phase 9: team-b's policies (the first of the flagship set's sorted ids),
# its quota (a bucket that holds wave T's share of team-b, refilled in
# one second) and deadline, the wave sizes (wave X's after a plug of
# single requests that occupies team-b's batch workers), the sleep of its
# device fetch in wave X, and the waves of each rate run
TEAM_B_POLICIES = 12
TEAM_B_RATE = 400
TEAM_B_BURST = 400
TEAM_B_TIMEOUT_MS = 500
T_WAVE = 1024
Q_WAVE = 1024
X_WAVE = 256
X_PLUG = 12
X_SLEEP_SECONDS = 1.0
S_WAVE = 1024
# wave S's limit on the delay from the killed loop's thread ending to its
# fence, past one heartbeat: the heartbeat pass's own time, its thread's
# wake beside the serving threads and this script's 1 ms poll
S_FENCE_ALLOWANCE_S = 0.1
RATE_WAVES = 2
# phase 10: the inventory (distinct objects), the live wave during the boot
# sweep, the UPDATE wave of lookup admission, the what-if's bound on rows
# and on the flips it counts (the JAX package's whatif_diff keeps a sample
# of 32 and reports its length), K1's holds at the audit path's batch
# sizes, and the entries a reconnect replays
# cut from 8,192 to 1,024 (and phase 13's wave W to 512 pods) to make
# room for phase 15, which keeps 8,192
AUDIT_OBJECTS = 1024
AUDIT_LIVE_WAVE = 1024
AUDIT_UPDATE_WAVE = 512
AUDIT_WHATIF_ROWS = 256
AUDIT_WHATIF_FLIP_SAMPLE = 32
AUDIT_HOLD_BATCHES = (8, 16, 64)
AUDIT_RESUME_ENTRIES = 100
COVER_BATCHES = (51, 129, 1029)
SPILL_BATCHES = (51, 129)

# policy_matrix's time per call in PR 1 (one block per row and policy
# tile; H100 80GB HBM3, 700 W), by (bucket, form, B)
PR1_MS = {
    (0, "narrow", 128): 0.1386, (0, "transport", 128): 0.1421,
    (0, "narrow", 1024): 0.2228, (0, "transport", 1024): 0.2248,
    (1, "narrow", 128): 0.3288, (1, "transport", 128): 0.3306,
    (1, "narrow", 1024): 0.4938, (1, "transport", 1024): 0.7078,
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_cuda(fn, iters: int, reps: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` repetitions of the milliseconds per call of
    ``fn()``, each repetition timed with CUDA events around ``iters``
    back-to-back calls on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of ``fn()`` with the host's launch cost taken
    out: ``iters`` calls captured in one CUDA graph, the graph's replay
    timed as ``time_cuda`` times a call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_cuda(graph.replay, 5) / iters


def host_us(fn, n: int = 200) -> float:
    """Microseconds of host time per call of ``fn()`` over ``n`` calls
    issued back to back (the device drained before; ``n`` well under the
    launch queue's depth, so the host never waits on the device)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def step_phases(env, buf, program):
    """``env.evaluate_packed(buf)`` step by step with a CUDA event between
    phases → (its output, [h2d, policy_matrix, combine, d2h ms on the
    stream, host wall ms of the whole step])."""
    import numpy as np
    import torch

    from policy_server_tpu_torch.ops import cuda_kernels as ck

    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    dev = torch.from_numpy(np.ascontiguousarray(buf)).to(env.device)
    events[1].record()
    a_mat, r_mat = ck.policy_matrix(dev, program)
    events[2].record()
    out = env._combine_outputs(a_mat, r_mat, program.column_of)
    events[3].record()
    host = out.cpu().numpy()
    events[4].record()
    events[4].synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return host, [
        events[i].elapsed_time(events[i + 1]) for i in range(4)
    ] + [wall]


def widen(doc: dict, n_containers: int = 12) -> dict:
    """A firehose review whose container array overflows the small schema
    bucket (8), so it encodes into the large bucket."""
    doc = copy.deepcopy(doc)
    pod = doc["request"]["object"]
    base = pod["spec"]["containers"]
    pod["spec"]["containers"] = [
        dict(base[i % len(base)], name=f"c{i}") for i in range(n_containers)
    ]
    return doc


def request_of(body: bytes):
    """A /validate body as the request the service evaluates."""
    from policy_server_tpu_torch.models import (
        AdmissionReviewRequest,
        ValidateRequest,
    )

    return ValidateRequest.from_admission(
        AdmissionReviewRequest.from_dict(json.loads(body)).request
    )


def oracle_body(oracle, pid: str, body: bytes) -> bytes:
    """The /validate response body the port's host oracle gives."""
    from policy_server_tpu_torch.api.service import RequestOrigin, evaluate
    from policy_server_tpu_torch.models import AdmissionReviewResponse

    return json.dumps(
        AdmissionReviewResponse(
            evaluate(oracle, pid, request_of(body), RequestOrigin.VALIDATE)
        ).to_dict()
    ).encode()


def recorder_event_seconds(n: int = 2000) -> float:
    """Seconds one flight-recorder phase event costs here: ``n``
    ``record_phase`` calls on a recorder feeding a registry's phase
    histogram, as the server's does (a registry of its own, so the
    process's histograms are untouched)."""
    from policy_server_tpu_torch.telemetry import flightrec
    from policy_server_tpu_torch.telemetry.metrics import MetricsRegistry

    probe = flightrec.FlightRecorder(capacity=4096, registry=MetricsRegistry())
    t0 = time.perf_counter()
    for i in range(n):
        probe.record_phase(flightrec.PH_DISPATCH, i, i + 100, rows=16, batch=i)
    return (time.perf_counter() - t0) / n


def host_device_sweep(reviews, policy_ids, card: str) -> list:
    """The host fast path against the device path per batch size, with
    the verdict cache off: the median wall of the two calls the batcher's
    dispatch makes, ``validate_batch(pairs, run_hooks=False,
    prefer_host=True)`` and ``validate_batch(pairs, run_hooks=False)``
    (encode, the enqueue of the copies, K1 and the combine, the fetch, the
    materialize), over distinct flagship batches of each size in
    SWEEP_BATCHES; both answers must agree. A flight recorder splits the
    device path's time into its stamped phases; the rest is mostly the
    unstamped enqueue."""
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.models import ValidateRequest
    from policy_server_tpu_torch.policies.flagship import flagship_policies
    from policy_server_tpu_torch.telemetry import flightrec
    from policy_server_tpu_torch.telemetry.metrics import MetricsRegistry

    env = EvaluationEnvironmentBuilder(
        device="cuda", verdict_cache_size=0
    ).build(flagship_policies())
    env.warmup(SWEEP_BATCHES)
    items = [
        (
            policy_ids[i % len(policy_ids)],
            ValidateRequest.from_admission(
                AdmissionReviewRequest.from_dict(d).request
            ),
        )
        for i, d in enumerate(reviews)
    ]
    stamped = ("prepare", "encode", "fetch", "device_execute", "materialize")
    rec = flightrec.install(flightrec.FlightRecorder(registry=MetricsRegistry()))
    rows = []
    try:
        for batch in SWEEP_BATCHES:
            times = {"host": [], "device": []}
            device_bids = set()
            for r in range(SWEEP_REPS + 1):
                lo = (r * batch) % (len(items) - batch + 1)
                pairs = items[lo : lo + batch]
                got = {}
                for way, prefer_host in (("host", True), ("device", False)):
                    bid = rec.next_batch()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with flightrec.batch_scope(bid):
                        got[way] = env.validate_batch(
                            pairs, run_hooks=False, prefer_host=prefer_host
                        )
                    elapsed = time.perf_counter() - t0
                    if r:  # the first repetition warms this size
                        times[way].append(elapsed * 1e3)
                        if way == "device":
                            device_bids.add(bid)
                if [x.to_dict() for x in got["host"]] != [
                    x.to_dict() for x in got["device"]
                ]:
                    fail(f"host and device answers differ at B={batch}")
            phase_ns = dict.fromkeys(stamped, 0)
            for ev in rec.snapshot():
                if ev["batch"] in device_bids and ev["phase"] in phase_ns:
                    phase_ns[ev["phase"]] += ev["end_ns"] - ev["start_ns"]
            host_ms = statistics.median(times["host"])
            device_ms = statistics.median(times["device"])
            n_rows = batch * SWEEP_REPS
            split = {k: round(v / 1e3 / n_rows, 2) for k, v in phase_ns.items()}
            nested = sum(v for k, v in phase_ns.items() if k != "device_execute")
            split["rest"] = round(
                (sum(times["device"]) * 1e6 - nested) / 1e3 / n_rows, 2
            )
            rows.append((batch, host_ms, device_ms))
            print(
                f"phase5 host vs device, B={batch}: host {host_ms:.4f} ms "
                f"({host_ms / batch * 1e3:.2f} us/row), device "
                f"{device_ms:.4f} ms ({device_ms / batch * 1e3:.2f} us/row; "
                f"us/row by phase {json.dumps(split)}), median of "
                f"{SWEEP_REPS} distinct batches, verdict cache off [{card}]"
            )
    finally:
        flightrec.install(None)
    if env.breaker_stats["trips"] or env.device_errors:
        fail(f"the sweep tripped the breaker or saw device errors: {env.breaker_stats}")
    return rows


def device_busy(trace_path: str, window_s: float) -> dict:
    """From a ``torch.profiler`` Chrome trace: the card's kernel, copy and
    memset intervals, summed and as their union, over the traced window's
    wall time. Fails when the trace holds no kernel."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = []
    kinds: dict = {}
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            kinds[cat] = kinds.get(cat, 0) + 1
    if not kinds.get("kernel"):
        fail(f"the device trace holds no CUDA kernel: {kinds}")
    summed = sum(e - s for s, e in spans)
    union = 0.0
    end = -1.0
    for s, e in sorted(spans):
        if e <= end:
            continue
        union += e - max(s, end)
        end = e
    window_us = window_s * 1e6
    return {
        "events": kinds, "window_ms": window_us / 1e3,
        "summed_ms": summed / 1e3, "union_ms": union / 1e3,
        "busy_share": union / window_us, "idle_share": 1.0 - union / window_us,
    }


def merged_trace(trace_path: str) -> dict:
    """From a trace ``profiling.stop_device_trace`` wrote with the flight
    recorder merged in: its ``idle_by_phase`` summary, and K1's launches
    (the ``cudaLaunchKernel`` calls whose correlation id is a
    ``policy_matrix`` kernel's) that start inside a recorder ``submit``
    span. Fails when the recorder's events or the clock anchors are
    missing."""
    from policy_server_tpu_torch.api import profiling

    with open(profiling.summary_path(trace_path)) as f:
        summary = json.load(f)
    if summary["clock"] is None or not summary["recorder_events"]:
        fail(f"the trace holds no clock anchors or no recorder events: {summary}")
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    k1 = {
        ev["args"].get("correlation") for ev in events
        if ev.get("cat") == "kernel" and "policy_matrix" in ev.get("name", "")
    }
    launches = sorted(
        float(ev["ts"]) for ev in events
        if ev.get("cat") in ("cuda_runtime", "cuda_driver")
        and "LaunchKernel" in ev.get("name", "")
        and ev.get("args", {}).get("correlation") in k1
    )
    submits = sorted(
        (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])) for ev in events
        if ev.get("pid") == profiling.RECORDER_PID and ev.get("ph") == "X"
        and ev.get("name") == "submit"
    )
    inside = sum(
        1 for t in launches
        if any(s <= t <= e for s, e in submits)
    )
    idle = summary["idle_by_phase"]
    charged = sum(idle["phase_s"].values()) + idle["no_phase_s"]
    return {
        "clock": summary["clock"], "recorder_events": summary["recorder_events"],
        "idle_by_phase": idle, "charged_over_idle": charged / idle["idle_s"],
        "k1_launches": len(launches), "k1_launches_in_submit": inside,
    }


def check_merged_trace(merged: dict, label: str) -> None:
    """K1's launches fall inside ``submit`` spans (99% at least, after the
    anchors' conversion), and ``idle_by_phase`` sums to the idle time
    within 1%."""
    n, inside = merged["k1_launches"], merged["k1_launches_in_submit"]
    if not n or inside < 0.99 * n:
        fail(f"{label}: {inside} of {n} K1 launches inside a submit span")
    if abs(merged["charged_over_idle"] - 1.0) > 0.01:
        fail(f"{label}: idle_by_phase sums to {merged['charged_over_idle']} of the idle time")


def response_body(result) -> bytes:
    """A batcher result as /validate writes it (a fragment verdict as the
    response its template gives)."""
    from policy_server_tpu_torch.models import AdmissionReviewResponse
    from policy_server_tpu_torch.models.admission import FragVerdict

    if type(result) is FragVerdict:
        result = result.to_response()
    return json.dumps(AdmissionReviewResponse(result).to_dict()).encode()


def http_get(port: int, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def evaluation_counts(port: int) -> tuple[float, float]:
    """``kubewarden_policy_evaluations_total`` on the readiness port's
    /metrics, summed over its label sets: (all, ``accepted="false"``)."""
    status, text = http_get(port, "/metrics")
    if status != 200:
        fail(f"/metrics answered {status}")
    total = rejected = 0.0
    for line in text.decode().splitlines():
        if line.startswith("kubewarden_policy_evaluations_total"):
            head, _, value = line.rpartition(" ")
            total += float(value)
            if 'accepted="false"' in head:
                rejected += float(value)
    return total, rejected


def print_attribution(
    label: str, att: dict, card: str, phase: str = "phase3"
) -> None:
    """The flight recorder's attribution of one run: µs per row of each
    stamped phase, wall and on the CPU, the host spans' off-CPU share, the
    residual's share of batch wall time, and the same for the batches
    whose rows were all cache hits, none, or some."""
    def brief(a: dict) -> dict:
        return {
            "batches": a["batches_complete"], "rows": a["rows"],
            "wall_us_per_row": a["wall_us_per_row"],
            "phase_us_per_row": a["phase_us_per_row"],
            "cpu_us_per_row": a.get("cpu_us_per_row"),
            "off_cpu_share": a.get("off_cpu_share"),
            "residual_us_per_row": a["residual_us_per_row"],
            "residual_fraction_of_wall": a["residual_fraction_of_wall"],
        }

    doc = brief(att)
    doc["mix"] = {k: brief(v) for k, v in att["mix_groups"].items()}
    print(f"{phase} attribution ({label}): {json.dumps(doc)} [{card}]")


def http_run(
    label: str, work: list, oracle_bodies: list, oracle_rejected: int,
    card: str, trace_dir: str | None = None, **flags,
):
    """The port's server on 127.0.0.1 with the flagship set on the card,
    ``work`` POSTed to /validate from CLIENT_THREADS clients; every body
    must equal the oracle's and the breaker must not trip. Launch counts
    are zeroed just before the server is built and read after the run
    (and after the build, to split warmup from serving). The server runs
    with ``--enable-metrics`` and its readiness port on any free port:
    /readiness there must answer 200, the run must add one evaluation to
    /metrics per request and ``oracle_rejected`` of them with
    ``accepted="false"``, and, with the recorder on, /debug/timeline must
    parse with the run's phases (404 with it off). ``trace_dir``: the run
    under ``profiling.start_device_trace``, for the card's busy share."""
    import torch

    from policy_server_tpu_torch.api import profiling
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policies
    from policy_server_tpu_torch.runtime.batcher import DEFAULT_POLICY_TIMEOUT
    from policy_server_tpu_torch.server import PolicyServer
    from policy_server_tpu_torch.telemetry import flightrec

    ck.reset_launch_counts()
    server = PolicyServer(
        flagship_policies(), host="127.0.0.1", port=0, readiness_probe_port=0,
        device="cuda", enable_metrics=True, **flags
    )
    torch.cuda.synchronize()
    warm = ck.launch_counts()
    rec = flightrec.recorder()  # the server's own, installed at its build
    rec_cursor = rec.events_recorded() if rec is not None else 0
    # garbage collections during the run: how many were full, and the
    # longest (a collection runs on whichever thread triggered it)
    collections: list = []
    gc_start = [0.0]

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            collections.append(
                (info["generation"], time.perf_counter() - gc_start[0])
            )

    gc.callbacks.append(on_gc)
    server.start()
    status, text = http_get(server.readiness_port, "/readiness")
    if status != 200:
        fail(f"/readiness on the readiness port answered {status} {text!r} ({label})")
    evals_before = evaluation_counts(server.readiness_port)
    results: list = [None] * len(work)
    latencies: list = [0.0] * len(work)
    starts: list = [0.0] * len(work)
    errors: list = []

    def client(tid: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
        try:
            for i in range(tid, len(work), CLIENT_THREADS):
                pid, body = work[i]
                t0 = time.perf_counter()
                starts[i] = t0
                conn.request(
                    "POST", f"/validate/{pid}", body=body,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                data = resp.read()
                latencies[i] = time.perf_counter() - t0
                results[i] = (resp.status, data)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"client {tid}: {type(e).__name__}: {e}")
        finally:
            conn.close()

    if trace_dir is not None:
        profiling.start_device_trace(trace_dir)
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=client, args=(t,)) for t in range(CLIENT_THREADS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    trace_path = profiling.stop_device_trace() if trace_dir is not None else None
    traced_wall = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    alive = any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    evals_after = evaluation_counts(server.readiness_port)
    timeline_status, timeline = http_get(server.readiness_port, "/debug/timeline")
    b = server.batcher
    env = server.env
    run = {
        "launches": counts,
        "warmup_launches": warm,
        "serving_launches": counts["policy_matrix"] - warm["policy_matrix"],
        "batches": b.batches,
        "rows": b.batch_rows,
        "host_batches": b.host_fastpath_batches,
        "budget_routed": b.budget_routed_batches,
        "device_batches": b.batches - b.host_fastpath_batches,
        "dispatched_chunks": env.host_profile["dispatched_chunks"],
        "dispatched_rows": env.host_profile["dispatched_rows"],
        "dedup": env.dedup_stats,
        "breaker": env.breaker_stats,
        "device_errors": env.device_errors,
        "abandoned": b.deadline_abandoned_batches,
        "deadline_rejections": b.deadline_rejections,
        "max_answer_ms": b.max_answer_seconds * 1e3,
        "full_collections": sum(1 for g, _ in collections if g == 2),
        "longest_collection_ms": max((d for _, d in collections), default=0.0) * 1e3,
        "evaluations": evals_after[0] - evals_before[0],
        "evaluations_rejected": evals_after[1] - evals_before[1],
        "events": rec.events_recorded() - rec_cursor if rec is not None else 0,
        "kernel_batches": (
            kernel_batches(rec, rec_cursor) if rec is not None else None
        ),
        "attribution": rec.attribution(since=rec_cursor) if rec is not None else None,
        "wall": wall,
        "trace_path": trace_path,
        "traced_wall": traced_wall,
    }
    server.stop()
    if alive:
        fail(f"HTTP clients did not finish ({label})")
    if errors:
        fail("; ".join(errors[:3]))
    mismatches = [
        (i, status, data[:400], want[:400])
        for i, ((status, data), want) in enumerate(zip(results, oracle_bodies))
        if status != 200 or data != want
    ]
    lat_ms = sorted(x * 1e3 for x in latencies)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]
    d = run["dedup"]
    run.update(req_s=len(work) / wall, p50=p50, p99=p99)
    print(
        f"phase3 http /validate ({label}): {len(work)} requests, "
        f"{len({p for p, _ in work})} policy ids, {CLIENT_THREADS} clients, "
        f"{len(mismatches)} bodies differ from the oracle; "
        f"{run['req_s']:.1f} req/s p50 {p50:.3f} ms p99 {p99:.3f} ms; "
        f"{run['batches']} micro-batches, mean "
        f"{run['rows'] / max(1, run['batches']):.1f} rows: host-routed "
        f"{run['host_batches']} (by budget {run['budget_routed']}), device "
        f"{run['device_batches']} ({run['dispatched_chunks']} dispatches of "
        f"{run['dispatched_rows']} rows); policy_matrix serving launches "
        f"{run['serving_launches']} (warmup {warm['policy_matrix']}), probe "
        f"{counts['probe']}; per batch {json.dumps(run['kernel_batches'])}; "
        f"dedup: blob hits "
        f"{d['blob_cache_hits']} row hits {d['cache_hits']} in-batch "
        f"{d['batch_dup_hits']} fragments {d['fragment_hits']}; breaker "
        f"{run['breaker']}; device errors {run['device_errors']}; "
        f"deadline-abandoned batches {run['abandoned']}, deadline "
        f"rejections {run['deadline_rejections']}, slowest answer "
        f"{run['max_answer_ms']:.3f} ms after submission (deadline "
        f"{DEFAULT_POLICY_TIMEOUT * 1e3:.0f} ms); garbage collections: "
        f"{run['full_collections']} full, longest "
        f"{run['longest_collection_ms']:.1f} ms [{card}]"
    )
    if mismatches:
        slowest = sorted(range(len(work)), key=lambda i: -latencies[i])[:8]
        print(
            f"phase3 slowest ({label}): "
            + ", ".join(
                f"#{i} start +{(starts[i] - t0) * 1e3:.0f} ms took "
                f"{latencies[i] * 1e3:.0f} ms"
                for i in slowest
            )
        )
        for i, status, got, want in mismatches[:3]:
            print(
                f"phase3 mismatch ({label}) request {i} {work[i][0]} after "
                f"{latencies[i] * 1e3:.1f} ms: status {status} body {got!r} "
                f"oracle {want!r}"
            )
        fail(
            f"{len(mismatches)} of {len(work)} HTTP bodies differ from the "
            f"oracle ({label})"
        )
    if counts["probe"] <= 0:
        fail(f"probe was not launched at the environment's build ({label})")
    if run["device_errors"]:
        fail(f"{run['device_errors']} kernel or CUDA errors ({label})")
    if run["breaker"]["trips"]:
        fail(f"the device breaker tripped in the HTTP run ({label}): {run['breaker']}")
    if run["evaluations"] != len(work) or run["evaluations_rejected"] != oracle_rejected:
        fail(
            f"/metrics counted {run['evaluations']} evaluations, "
            f"{run['evaluations_rejected']} rejected, for {len(work)} requests "
            f"of which the oracle rejects {oracle_rejected} ({label})"
        )
    print(
        f"phase3 /metrics ({label}): kubewarden_policy_evaluations_total +"
        f"{run['evaluations']:.0f} (accepted=\"false\" +"
        f"{run['evaluations_rejected']:.0f}, the oracle rejects "
        f"{oracle_rejected}); /readiness 200 on the readiness port [{card}]"
    )
    if rec is None:
        if timeline_status != 404:
            fail(f"/debug/timeline answered {timeline_status} with the recorder off")
        return run
    if timeline_status != 200:
        fail(f"/debug/timeline answered {timeline_status} ({label})")
    doc = json.loads(timeline)
    stamped: dict = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X":
            stamped[ev["name"]] = stamped.get(ev["name"], 0) + 1
    need = {"queue_wait", "form", "dispatch", "handoff", "deliver"}
    if run["device_batches"]:
        need |= {"prepare", "encode", "fetch", "materialize", "device_execute"}
    if not need <= set(stamped):
        fail(f"/debug/timeline lacks phases {sorted(need - set(stamped))} ({label})")
    print(
        f"phase3 /debug/timeline ({label}): {len(doc['traceEvents'])} trace "
        f"events, slices by phase {json.dumps(stamped, sort_keys=True)}, "
        f"{run['events']} recorder events in the run [{card}]"
    )
    print_attribution(label, run["attribution"], card)
    return run


def native_phase(reviews, policy_ids, oracle, enc_build, card: str) -> None:
    """The native pipeline on the card: the encoder against its plain
    version (the Python trie), the verdict cache over a first pass, an
    exact replay and a uid-changed replay, and the breaker tripped through
    the ``device.fetch`` failpoint and recovered by a probe."""
    import torch

    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import (
        AdmissionReviewRequest,
        ValidateRequest,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policies
    from policy_server_tpu_torch.runtime.batcher import MicroBatcher

    print(
        f"phase4 g++ build {enc_build.build_seconds:.3f} s -> "
        f"{enc_build.path.name} [{card}]"
    )
    env = EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())

    # the native encoder against the Python trie, both buckets, the trie
    # first so both see the same intern ids
    per_bucket: dict[int, list] = {0: [], 1: []}
    for doc in reviews:
        payload = AdmissionReviewRequest.from_dict(doc).request.to_dict()
        idx, enc = env.encode_bucketed(payload)
        per_bucket[idx].append(
            (enc, json.dumps(payload, separators=(",", ":")).encode())
        )
    for idx, rows in per_bucket.items():
        schema = env.schemas[idx]
        want = schema.pack(schema.stack([e for e, _ in rows], batch_size=len(rows)))
        got, status = schema.native.encode_batch(
            [b for _, b in rows], len(rows), env.table
        )
        if not (status == 0).all():
            fail(f"the native encoder refused rows the trie took (bucket {idx})")
        if got["__packed__"].tobytes() != want["__packed__"].tobytes():
            bad = int((got["__packed__"] != want["__packed__"]).any(axis=1).sum())
            fail(f"native encoder and trie differ in {bad} rows of bucket {idx}")
        print(
            f"phase4 fastenc == trie: bucket {idx}, {len(rows)} rows of "
            f"{want['__packed__'].shape[1]} B, byte-equal [{card}]"
        )

    # the verdict cache: a first pass, its exact replay, a uid-changed
    # replay, through a batcher with no host routing
    def items_of(docs):
        return [
            (
                policy_ids[i % len(policy_ids)],
                ValidateRequest.from_admission(
                    AdmissionReviewRequest.from_dict(d).request
                ),
            )
            for i, d in enumerate(docs)
        ]

    replay_uid = []
    for d in reviews:
        d = copy.deepcopy(d)
        d["request"]["uid"] = d["request"]["uid"] + "-replay"
        replay_uid.append(d)
    batcher = MicroBatcher(
        env, host_fastpath_threshold=0, latency_budget_ms=0,
        batch_timeout_ms=5.0,
    ).start()
    try:
        passes = []
        for name, docs in (
            ("first", reviews), ("exact replay", reviews),
            ("uid replay", replay_uid),
        ):
            items = items_of(docs)
            want = [
                oracle_body(oracle, pid, json.dumps(d).encode())
                for (pid, _r), d in zip(items, docs)
            ]
            before = env.dedup_stats
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            futures = batcher.submit_many(items)
            got = [response_body(f.result(timeout=120)) for f in futures]
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = ck.launch_counts()["policy_matrix"]
            after = env.dedup_stats
            bad = sum(1 for g, w in zip(got, want) if g != w)
            if bad:
                fail(f"{bad} bodies of the {name} pass differ from the oracle")
            delta = {
                k: after[k] - before[k] for k in after if "capacity" not in k
            }
            passes.append((name, launches, delta))
            print(
                f"phase4 {name}: {len(items)} reviews in {wall * 1e3:.1f} ms, "
                f"all bodies equal to the oracle; policy_matrix launches "
                f"{launches}; dedup delta {delta} [{card}]"
            )
        if passes[0][1] <= 0:
            fail("the first pass launched no policy_matrix")
        if passes[1][1] != 0:
            fail(f"the exact replay launched policy_matrix {passes[1][1]} times")
        if passes[2][1] != 0:
            fail(f"the uid replay launched policy_matrix {passes[2][1]} times")
        hp = env.host_profile
        print(
            f"phase4 dedup_stats {env.dedup_stats}; host_profile {hp}; "
            f"native encode {hp['encode_ns'] / max(1, hp['encode_rows']) / 1e3:.2f} "
            f"us/row [{card}]"
        )
        if env.breaker_stats["trips"]:
            fail(f"the breaker tripped in the cache passes: {env.breaker_stats}")
    finally:
        batcher.shutdown()

    # the breaker: five injected fetch faults trip it, tripped batches
    # answer from the host oracle, a probe after the cooldown recovers it
    cooldown = 0.5
    benv = EvaluationEnvironmentBuilder(
        device="cuda", verdict_cache_size=0,
        breaker_config={"cooldown_seconds": cooldown},
    ).build(flagship_policies())
    # every bucket armed, as after a server's boot: the probe is K1's
    benv.warmup((1,))
    items = items_of(reviews[:64])
    # the environment's own answers (no service-layer constraints): the
    # oracle backend's validate_batch on the same items
    want = [response_body(r) for r in oracle.validate_batch(items)]
    failpoints.configure("device.fetch=raise:injected-fetch-fault*5")
    try:
        for k in range(5):
            try:
                benv.validate_batch(items[k : k + 1])
            except failpoints.FailpointError:
                continue
            fail("an injected fetch fault did not raise")
    finally:
        failpoints.reset()
    tripped = benv.breaker_stats
    if tripped["trips"] != 1 or not tripped["open_shards"]:
        fail(f"five fetch faults did not trip the breaker: {tripped}")
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    got = [response_body(r) for r in benv.validate_batch(items)]
    open_launches = ck.launch_counts()["policy_matrix"]
    if got != want:
        fail("bodies answered while the breaker was open differ from the oracle")
    if open_launches:
        fail("the device was used while the breaker was open")
    time.sleep(cooldown + 0.1)
    ck.reset_launch_counts()
    got = [response_body(r) for r in benv.validate_batch(items)]
    torch.cuda.synchronize()
    probe_launches = ck.launch_counts()["policy_matrix"]
    recovered = benv.breaker_stats
    if got != want:
        fail("bodies after the breaker's recovery differ from the oracle")
    if probe_launches <= 0 or recovered["recoveries"] != 1 or recovered["open_shards"]:
        fail(f"the half-open probe did not recover the breaker: {recovered}")
    print(
        f"phase4 breaker: 5 device.fetch faults -> {tripped}; open: "
        f"{len(items)} bodies equal to the oracle, policy_matrix launches "
        f"{open_launches}; after {cooldown} s: probe launches "
        f"{probe_launches}, {recovered} [{card}]"
    )


def native_client_main(argv: list[str]) -> int:
    """Phase 7's load generator, in a process of its own: ``CONNS``
    keep-alive connections per wave, each sending its share of the wave's
    requests ``DEPTH`` at a time pipelined and reading the answers before
    the next ``DEPTH``; a response's latency runs from its pipelined
    group's send. CORPUS is the waves' raw HTTP requests (u32 wave, u32
    length, bytes each); OUT receives one JSON document: each wave's wall
    time and, per request in corpus order, its status, latency, body and
    Retry-After header (None without one). Options after DEPTH:
    ``tolerate-close``, and ``tls`` or ``tls=CERT,KEY`` (HTTPS, with a
    client certificate for mTLS)."""
    import socket

    port, corpus_path, out_path = int(argv[0]), argv[1], argv[2]
    conns, depth = int(argv[3]), int(argv[4])
    tolerate_close = "tolerate-close" in argv[5:]
    # "tls" or "tls=CERT,KEY": every connection shakes hands first (trusting
    # any server), presenting the client certificate when given one
    tls_ctx = None
    for opt in argv[5:]:
        if opt == "tls" or opt.startswith("tls="):
            import ssl

            tls_ctx = ssl.create_default_context()
            tls_ctx.check_hostname = False
            tls_ctx.verify_mode = ssl.CERT_NONE
            if opt.startswith("tls="):
                tls_ctx.load_cert_chain(*opt[4:].split(","))
    waves: list[list[bytes]] = []
    with open(corpus_path, "rb") as f:
        blob = f.read()
    off = 0
    while off < len(blob):
        wave = int.from_bytes(blob[off : off + 4], "little")
        n = int.from_bytes(blob[off + 4 : off + 8], "little")
        off += 8
        while len(waves) <= wave:
            waves.append([])
        waves[wave].append(blob[off : off + n])
        off += n
    results: list = []
    walls: list = []
    errors: list = []

    def one_conn(reqs: list[bytes], idx: list[int], out: list) -> None:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=120)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if tls_ctx is not None:
                s = tls_ctx.wrap_socket(s)
            buf = b""
            for lo in range(0, len(idx), depth):
                group = idx[lo : lo + depth]
                t0 = time.perf_counter()
                s.sendall(b"".join(reqs[i] for i in group))
                got = 0
                while got < len(group):
                    he = buf.find(b"\r\n\r\n")
                    if he >= 0:
                        cl = 0
                        for ln in buf[:he].split(b"\r\n")[1:]:
                            if ln[:15].lower() == b"content-length:":
                                cl = int(ln[15:])
                                break
                        total = he + 4 + cl
                        if len(buf) >= total:
                            retry = None
                            for ln in buf[:he].split(b"\r\n")[1:]:
                                if ln[:12].lower() == b"retry-after:":
                                    retry = int(ln[12:])
                            out[group[got]] = (
                                int(buf[9:12]),
                                (time.perf_counter() - t0) * 1e3,
                                buf[he + 4 : total].decode("latin-1"),
                                retry,
                            )
                            buf = buf[total:]
                            got += 1
                            continue
                    chunk = s.recv(1 << 18)
                    if not chunk:
                        raise ConnectionError("server closed mid-wave")
                    buf += chunk
            s.close()
        except (ConnectionError, OSError) as e:
            if not tolerate_close:
                errors.append(f"{type(e).__name__}: {e}")
        except Exception as e:  # noqa: BLE001 — reported in OUT
            errors.append(f"{type(e).__name__}: {e}")

    for reqs in waves:
        out: list = [None] * len(reqs)
        threads = [
            threading.Thread(
                target=one_conn,
                args=(reqs, list(range(c, len(reqs), conns)), out),
            )
            for c in range(conns)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        walls.append(time.perf_counter() - t0)
        results.extend(out)
    with open(out_path, "w") as f:
        json.dump({"walls": walls, "results": results, "errors": errors}, f)
    if tolerate_close:
        return 1 if errors else 0
    return 1 if errors or any(r is None for r in results) else 0


def metric_value(port: int, name: str) -> float:
    """An unlabelled family's value on the readiness port's /metrics."""
    status, text = http_get(port, "/metrics")
    if status != 200:
        fail(f"/metrics answered {status}")
    for line in text.decode().splitlines():
        head, _, value = line.rpartition(" ")
        if head == name:
            return float(value)
    fail(f"/metrics has no {name}")
    return 0.0


NATIVE_PHASES = (
    "native_accept", "native_parse", "ring_cross", "admit", "native_serialize",
)


def kernel_batches(rec, since: int) -> dict:
    """Per-batch proof that K1 ran, from the flight recorder's events since
    the cursor ``since``: the serving batches (one ``dispatch`` event each)
    and the ``device_execute`` events, one per fetched K1 launch, each
    stamped with its batch's id. ``without_kernel`` counts the batches with
    no such event; ``wrapped`` says the ring overwrote events of the run,
    so the count cannot be trusted."""
    evs = [ev for ev in rec.snapshot() if ev["seq"] >= since]
    wrapped = rec.events_recorded() > since and (
        not evs or evs[0]["seq"] > since
    )
    dispatched = {
        ev["batch"] for ev in evs
        if ev["phase"] == "dispatch" and ev["kind"] == "batch"
    }
    executes = [
        ev["batch"] for ev in evs
        if ev["phase"] == "device_execute" and ev["batch"] >= 0
    ]
    return {
        "dispatched": len(dispatched),
        "device_executes": len(executes),
        "without_kernel": len(dispatched - set(executes)),
        "wrapped": wrapped,
    }


def check_kernel_batches(run: dict, what: str, positions: int = 1) -> None:
    """Fail unless every serving batch of a kernel-only run launched K1:
    no batch host-routed, every batch with a fetched launch of its own,
    and the fetched launches, times the mesh positions each step launches
    K1 on, equal to the wrapper's serving count."""
    kb = run["kernel_batches"]
    if run["host_batches"]:
        fail(f"{what} routed {run['host_batches']} batches to the host")
    if kb is None or kb["wrapped"]:
        fail(f"{what}: the flight recorder cannot account for every batch ({kb})")
    if kb["dispatched"] != run["batches"]:
        fail(
            f"{what}: {kb['dispatched']} batches stamped, "
            f"{run['batches']} dispatched"
        )
    if kb["without_kernel"]:
        fail(
            f"{what}: {kb['without_kernel']} of {run['batches']} "
            f"micro-batches launched no policy_matrix"
        )
    if kb["device_executes"] * positions != run["serving_launches"]:
        fail(
            f"{what}: {kb['device_executes']} fetched steps over {positions} "
            f"positions, {run['serving_launches']} policy_matrix launches "
            "counted"
        )


def native_phase_split(rec, since: int) -> dict:
    """µs per row of each native-frontend phase since the event cursor
    ``since`` (burst-level events: no batch id, so outside the per-batch
    attribution)."""
    ns = dict.fromkeys(NATIVE_PHASES, 0)
    rows = dict.fromkeys(NATIVE_PHASES, 0)
    for ev in rec.snapshot():
        if ev["seq"] >= since and ev["phase"] in ns:
            ns[ev["phase"]] += max(0, ev["end_ns"] - ev["start_ns"])
            rows[ev["phase"]] += ev["rows"]
    return {
        p: round(ns[p] / 1e3 / max(1, rows[p]), 2) for p in NATIVE_PHASES
    }


def write_corpus(path: str, waves: list) -> None:
    """The client's corpus: each wave's (policy id, body) pairs, or (policy
    id, body, header lines) triples, as raw POSTs to /validate (u32 wave,
    u32 length, bytes each)."""
    with open(path, "wb") as f:
        for w, wave in enumerate(waves):
            for item in wave:
                pid, body = item[0], item[1]
                extra = item[2] if len(item) > 2 else b""
                req = (
                    f"POST /validate/{pid} HTTP/1.1\r\nHost: smoke\r\n"
                    f"Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n"
                ).encode() + extra + b"\r\n" + body
                f.write(w.to_bytes(4, "little") + len(req).to_bytes(4, "little"))
                f.write(req)


def native_http_run(
    label: str, waves: list, oracle_bodies: list, oracle_rejected: int,
    card: str, trace_dir: str | None = None, **flags,
) -> dict:
    """The port's server with ``--frontend native`` on the card, the waves
    of (policy id, body) sent by the ``--native-client`` process; every
    body must equal the oracle's; the native and evaluation counters must
    rise by exactly the requests sent; no parse fallback, trip, device
    error or deadline rejection. Launch counts are zeroed just before the
    server is built and read after its warmup and after the run."""
    import torch

    from policy_server_tpu_torch.api import profiling
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policies
    from policy_server_tpu_torch.server import PolicyServer
    from policy_server_tpu_torch.telemetry import flightrec

    work_dir = os.path.join(REPO, "build", "chip_smoke_native")
    os.makedirs(work_dir, exist_ok=True)
    corpus_path = os.path.join(work_dir, "corpus.bin")
    out_path = os.path.join(work_dir, "results.json")
    flat = [item for wave in waves for item in wave]
    write_corpus(corpus_path, waves)
    ck.reset_launch_counts()
    server = PolicyServer(
        flagship_policies(), host="127.0.0.1", port=0, readiness_probe_port=0,
        device="cuda", enable_metrics=True, frontend="native", **flags
    )
    try:
        torch.cuda.synchronize()
        warm = ck.launch_counts()
        rec = flightrec.recorder()
        rec_cursor = rec.events_recorded() if rec is not None else 0
        server.start()
        status, text = http_get(server.readiness_port, "/readiness")
        if status != 200:
            fail(f"/readiness answered {status} {text!r} ({label})")
        rp = server.readiness_port
        evals_before = evaluation_counts(rp)
        native_before = metric_value(rp, "policy_server_native_http_requests_total")
        front_before = server.native_frontend.stats()
        b0 = server.batcher.stats_snapshot()
        if trace_dir is not None:
            profiling.start_device_trace(trace_dir)
        t0 = time.perf_counter()
        client = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--native-client",
             str(server.port), corpus_path, out_path, str(NATIVE_CONNS),
             str(NATIVE_DEPTH)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        try:
            _out, client_err = client.communicate(timeout=600)
        finally:
            if client.poll() is None:
                client.kill()
                client.wait(30)
        wall = time.perf_counter() - t0
        trace_path = (
            profiling.stop_device_trace() if trace_dir is not None else None
        )
        traced_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        # the last batch's metrics are recorded just after its delivery
        time.sleep(0.2)
        counts = ck.launch_counts()
        evals_after = evaluation_counts(rp)
        native_after = metric_value(rp, "policy_server_native_http_requests_total")
        front = server.native_frontend.stats()
        b1 = server.batcher.stats_snapshot()
        b = server.batcher
        env = server.env
        run = {
            "serving_launches": counts["policy_matrix"] - warm["policy_matrix"],
            "warmup_launches": warm,
            "launches": counts,
            "batches": b1["batches_dispatched"] - b0["batches_dispatched"],
            "rows": b1["requests_dispatched"] - b0["requests_dispatched"],
            "host_batches": b1["host_fastpath_batches"] - b0["host_fastpath_batches"],
            "bursts": b1["bulk_submits"] - b0["bulk_submits"],
            "burst_rows": b1["bulk_submitted_rows"] - b0["bulk_submitted_rows"],
            "dedup": env.dedup_stats,
            "breaker": env.breaker_stats,
            "device_errors": env.device_errors,
            "deadline_rejections": b.deadline_rejections,
            "max_answer_ms": b.max_answer_seconds * 1e3,
            "evaluations": evals_after[0] - evals_before[0],
            "evaluations_rejected": evals_after[1] - evals_before[1],
            "native_requests": native_after - native_before,
            "front": {k: front[k] - front_before[k] for k in (
                "http_requests", "requests_parsed_native", "parse_fallbacks",
                "responses_native_serialized", "responses_python_serialized",
                "ring_full_rejections", "framing_ns", "connections_accepted",
            )},
            "attribution": rec.attribution(since=rec_cursor) if rec else None,
            "native_phases": native_phase_split(rec, rec_cursor) if rec else None,
            "kernel_batches": kernel_batches(rec, rec_cursor) if rec else None,
            "wall": wall,
            "trace_path": trace_path,
            "traced_wall": traced_wall,
        }
    finally:
        server.stop()
    if client.returncode != 0 or not os.path.exists(out_path):
        fail(f"the native client failed ({label}): {client_err[-2000:]}")
    with open(out_path) as f:
        doc = json.load(f)
    os.unlink(out_path)
    if doc["errors"]:
        fail(f"native client errors ({label}): {doc['errors'][:3]}")
    results = doc["results"]
    mismatches = [
        (i, st, body[:300], want[:300])
        for i, ((st, _lat, body, _retry), want) in enumerate(zip(results, oracle_bodies))
        if st != 200 or body.encode("latin-1") != want
    ]
    lat = sorted(r[1] for r in results)
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    n = len(flat)
    run.update(
        req_s=n / sum(doc["walls"]), wave_req_s=[len(w) / t for w, t in zip(waves, doc["walls"])],
        p50=p50, p99=p99,
    )
    d = run["dedup"]
    print(
        f"phase7 native /validate ({label}): {n} requests in "
        f"{len(waves)} waves, {NATIVE_CONNS} connections x depth "
        f"{NATIVE_DEPTH}, {len(mismatches)} bodies differ from the oracle; "
        f"{run['req_s']:.1f} req/s (waves "
        f"{', '.join(f'{x:.1f}' for x in run['wave_req_s'])}) p50 {p50:.3f} "
        f"ms p99 {p99:.3f} ms; {run['batches']} micro-batches, mean "
        f"{run['rows'] / max(1, run['batches']):.1f} rows: host-routed "
        f"{run['host_batches']}, device "
        f"{run['batches'] - run['host_batches']}; {run['bursts']} admitted "
        f"bursts, mean {run['burst_rows'] / max(1, run['bursts']):.1f} rows; "
        f"policy_matrix serving launches {run['serving_launches']} (warmup "
        f"{warm['policy_matrix']}), probe {counts['probe']}; per batch "
        f"{json.dumps(run['kernel_batches'])}; dedup: blob hits "
        f"{d['blob_cache_hits']} row hits {d['cache_hits']} fragments "
        f"{d['fragment_hits']}; frontend {json.dumps(run['front'])}; breaker "
        f"trips {run['breaker']['trips']}; device errors "
        f"{run['device_errors']}; deadline rejections "
        f"{run['deadline_rejections']}, slowest answer "
        f"{run['max_answer_ms']:.3f} ms [{card}]"
    )
    if mismatches:
        for i, st, got, want in mismatches[:3]:
            print(f"phase7 mismatch ({label}) request {i}: status {st} body {got!r} oracle {want!r}")
        fail(f"{len(mismatches)} of {n} native bodies differ from the oracle ({label})")
    if counts["probe"] <= 0:
        fail(f"probe was not launched at the environment's build ({label})")
    if run["device_errors"] or run["breaker"]["trips"]:
        fail(f"device errors or breaker trips in the native run ({label}): {run['breaker']}")
    if run["deadline_rejections"]:
        fail(f"{run['deadline_rejections']} deadline rejections ({label})")
    if run["front"]["parse_fallbacks"]:
        fail(f"{run['front']['parse_fallbacks']} parse fallbacks on the firehose ({label})")
    if run["native_requests"] != n or run["evaluations"] != n:
        fail(
            f"/metrics counted {run['native_requests']} native requests and "
            f"{run['evaluations']} evaluations for {n} requests ({label})"
        )
    if run["evaluations_rejected"] != oracle_rejected:
        fail(
            f"/metrics counted {run['evaluations_rejected']} rejections, the "
            f"oracle {oracle_rejected} ({label})"
        )
    print(
        f"phase7 /metrics ({label}): policy_server_native_http_requests_total "
        f"+{run['native_requests']:.0f}, kubewarden_policy_evaluations_total "
        f"+{run['evaluations']:.0f} (accepted=\"false\" "
        f"+{run['evaluations_rejected']:.0f}, the oracle rejects "
        f"{oracle_rejected}) [{card}]"
    )
    if run["attribution"] is not None:
        print_attribution(label, run["attribution"], card, phase="phase7")
        print(
            f"phase7 native phases, us per row ({label}): "
            f"{json.dumps(run['native_phases'])} [{card}]"
        )
    return run


# -- phase 8: reload, rollback and self-heal ---------------------------------


def changed_specs(specs: dict) -> dict:
    """The reload's new set: trusted-repos allows one registry only, and
    baseline-canary is removed."""
    out = copy.deepcopy(specs)
    out["trusted-repos"]["settings"]["registries"]["allow"] = ["docker.io"]
    del out["baseline-canary"]
    return out


def expected_answer(oracle, pid: str, body: bytes) -> tuple[int, bytes]:
    """(status, body) the API writes for ``body`` under ``oracle``'s set:
    the verdict, or the 404 of a policy the set does not have."""
    from policy_server_tpu_torch.evaluation.errors import PolicyNotFoundError

    try:
        return 200, oracle_body(oracle, pid, body)
    except PolicyNotFoundError as e:
        return 404, json.dumps({"message": str(e), "status": 404}).encode()


def stopping_body(body: bytes) -> bytes:
    """The in-band 503 of a request answered while the server stops."""
    from policy_server_tpu_torch.models import (
        AdmissionResponse,
        AdmissionReviewResponse,
    )

    uid = json.loads(body)["request"]["uid"]
    return json.dumps(AdmissionReviewResponse(
        AdmissionResponse.reject(uid, "policy server shutting down", 503)
    ).to_dict()).encode()


def wave_of(work_docs: list, n: int, tag: str) -> list:
    """The first ``n`` (policy id, doc) pairs as request bodies with uids
    of their own."""
    out = []
    for pid, d in work_docs[:n]:
        d = copy.deepcopy(d)
        d["request"]["uid"] = f"{d['request']['uid']}-{tag}"
        out.append((pid, json.dumps(d).encode()))
    return out


def start_client(port: int, wave: list, name: str, tolerate_close: bool = False,
                 tls: str | None = None, conns: int = NATIVE_CONNS,
                 depth: int = NATIVE_DEPTH, work_dir: str | None = None):
    """The ``--native-client`` process sending one wave → (process, OUT);
    ``tls`` is its ``tls`` or ``tls=CERT,KEY`` option."""
    work_dir = work_dir or os.path.join(REPO, "build", "chip_smoke_reload")
    os.makedirs(work_dir, exist_ok=True)
    corpus = os.path.join(work_dir, f"{name}.bin")
    out = os.path.join(work_dir, f"{name}.json")
    write_corpus(corpus, [wave])
    args = [sys.executable, os.path.abspath(__file__), "--native-client",
            str(port), corpus, out, str(conns), str(depth)]
    if tolerate_close:
        args.append("tolerate-close")
    if tls is not None:
        args.append(tls)
    proc = subprocess.Popen(
        args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return proc, out


def finish_client(proc, out: str, label: str) -> list:
    """Wait for a client process → its results (status, ms, body,
    Retry-After) or None per request."""
    try:
        _o, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    if proc.returncode != 0 or not os.path.exists(out):
        fail(f"the client of {label} failed: {err[-2000:]}")
    with open(out) as f:
        doc = json.load(f)
    os.unlink(out)
    return doc["results"]


def client_wave(port: int, wave: list, name: str) -> list:
    return finish_client(*start_client(port, wave, name), name)


def check_wave(label: str, results: list, wave: list, expectations: list,
               allow_stopping: bool = False) -> dict:
    """Every answer must equal one of ``expectations`` (lists of (status,
    body) per request), or under ``allow_stopping`` the in-band 503; an
    unanswered request counts only under ``allow_stopping``. → counts per
    expectation that only it matched, 503s, unanswered, p50/p99 ms."""
    only = [0] * len(expectations)
    stopping = missing = 0
    bad = []
    lat = []
    for i, r in enumerate(results):
        if r is None:
            if not allow_stopping:
                fail(f"{label}: request {i} unanswered")
            missing += 1
            continue
        status, ms, body, _retry = r
        got = (status, body.encode("latin-1"))
        lat.append(ms)
        hits = [k for k, exp in enumerate(expectations) if exp[i] == got]
        if len(hits) == 1:
            only[hits[0]] += 1
        if hits:
            continue
        if allow_stopping and got == (200, stopping_body(wave[i][1])):
            stopping += 1
            continue
        bad.append((i, status, body[:300]))
    if bad:
        for i, status, body in bad[:3]:
            print(f"mismatch ({label}) request {i}: status {status} body {body!r}")
        fail(f"{len(bad)} answers of {label} match no expected body")
    lat.sort()
    return {
        "answered": len(lat), "only": only, "stopping_503": stopping,
        "unanswered": missing,
        "p50": lat[len(lat) // 2] if lat else None,
        "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else None,
    }


def admin_post(port: int, path: str) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=b"",
                     headers={"Authorization": f"Bearer {RELOAD_TOKEN}"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def wait_until(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def join_retirements() -> None:
    """Wait for the lifecycle's background retirements (drain, shut the
    batcher down, close the environment past the pin)."""
    for t in threading.enumerate():
        if t.name.startswith("epoch-") and t.name.endswith("-retire"):
            t.join(60)


def hold_set_against_plain(specs: dict, docs: list, card: str, label: str,
                           timings: dict | None = None,
                           **builder_kwargs) -> int:
    """A policy set's K1 programs on the card against their plain version
    at B = 128, both buckets, narrow form → max abs error. ``label`` names
    the set in the messages; ``timings``, when given, gets each bucket's
    K1 device ms; ``builder_kwargs`` go to the environment's builder (a
    module resolver for fetched artifacts)."""
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    env = EvaluationEnvironmentBuilder(device="cuda", **builder_kwargs).build(
        parse_policies(specs)
    )
    err = 0
    for idx, schema in enumerate(env.schemas):
        encs = []
        for d in docs:
            d = widen(d) if idx == 1 else d
            payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
            got_idx, enc = env.encode_bucketed(payload)
            if got_idx == idx:
                encs.append(enc)
            if len(encs) == 128:
                break
        if len(encs) < 128:
            fail(f"{label} has {len(encs)} reviews for bucket {idx}, not 128")
        wide = schema.pack(schema.stack(encs, batch_size=128))
        buf = schema.to_transport(wide, vocab_size=len(env.table))["__packed__"]
        program = env.program_for(idx, True, True)
        dev = torch.from_numpy(buf).to("cuda")
        want_a, want_r = ck.policy_matrix_plain(dev, program)
        got_a, got_r = ck.policy_matrix(dev, program)
        torch.cuda.synchronize()
        if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
            fail(f"{label}: policy_matrix disagrees with its plain version (bucket {idx})")
        err = max(err, int((got_r - want_r).abs().max()))
        if timings is not None:
            timings[idx] = graph_ms(lambda: ck.policy_matrix(dev, program))
    env.close()
    print(
        f"{label}: policy_matrix exact against its plain version "
        f"at B=128, both buckets, narrow [{card}]"
    )
    return err


def reload_phase(work_docs: list, card: str) -> dict:
    """Phase 8 (see the module docstring) → its numbers for the kernels
    line."""
    import torch

    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    old_specs = flagship_policy_specs()
    new_specs = changed_specs(old_specs)
    work_dir = os.path.join(REPO, "build", "chip_smoke_reload")
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "policies.json")
    with open(path, "w") as f:
        json.dump(old_specs, f)
    old = EvaluationEnvironmentBuilder(backend="oracle").build(parse_policies(old_specs))
    new = EvaluationEnvironmentBuilder(backend="oracle").build(parse_policies(new_specs))

    def expect(oracle, wave):
        return [expected_answer(oracle, pid, body) for pid, body in wave]

    args = build_cli().parse_args([
        "--policies", path, "--addr", "127.0.0.1", "--port", "0",
        "--readiness-probe-port", "0", "--frontend", "native",
        "--enable-metrics", "--reload-admin-token", RELOAD_TOKEN,
        "--selfheal-interval-seconds", str(RELOAD_SELFHEAL_SECONDS),
    ])
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t_build = time.perf_counter()
    server = server_from_args(args)
    build_s = time.perf_counter() - t_build
    boot = ck.launch_counts()
    server.start()
    rp = server.readiness_port
    lc = server.lifecycle
    out: dict = {"build_s": build_s, "boot_launches": boot}
    candidates: list = []
    stopped = False
    try:
        if args.policy_reload_mode != "auto" or args.selfheal_interval_seconds <= 0:
            fail("phase 8 does not run at the default reload mode")
        status, text = http_get(rp, "/readiness")
        if status != 200:
            fail(f"/readiness answered {status} {text!r} (phase 8)")

        # A: the flagship set
        wave = wave_of(work_docs, RELOAD_WAVE, "r8a")
        out["A"] = check_wave("wave A", client_wave(server.port, wave, "a"),
                              wave, [expect(old, wave)])

        # B: the file rewritten; waves while the watch reloads
        with open(path, "w") as f:
            json.dump(new_specs, f)
        t_rewrite = time.perf_counter()
        b_results, b_waves, n = [], [], 0
        while True:
            done = lc.stats()["reloads"] >= 1 and not lc.reload_in_flight()
            wave = wave_of(work_docs, RELOAD_B_WAVE, f"r8b{n}")
            res = client_wave(server.port, wave, f"b{n}")
            b_results += res
            b_waves += wave
            n += 1
            if done or time.perf_counter() - t_rewrite > 120:
                break
        out["B"] = check_wave("wave B", b_results, b_waves,
                              [expect(old, b_waves), expect(new, b_waves)])
        out["B"]["waves"] = n
        stats = lc.stats()
        if stats["reloads"] != 1 or stats["epoch"] != 1:
            fail(f"the file watch did not promote the changed set: {stats}")
        out["reload_B"] = dict(lc.last_stage_seconds)

        # C: the new set, epoch 1
        wave = wave_of(work_docs, RELOAD_WAVE, "r8c")
        exp_new, exp_old = expect(new, wave), expect(old, wave)
        if exp_new == exp_old:
            fail("the changed set answers wave C as the old one does")
        out["C"] = check_wave("wave C", client_wave(server.port, wave, "c"),
                              wave, [exp_new])
        out["C"]["differs_from_old"] = sum(a != b for a, b in zip(exp_new, exp_old))
        if metric_value(rp, "policy_server_policy_epoch") != 1.0:
            fail("policy_server_policy_epoch is not 1 after the promotion")

        # D: rollback to the old set
        status, body = admin_post(rp, "/policies/rollback")
        if (status, body) != (200, {"status": "rolled-back", "epoch": 0}):
            fail(f"POST /policies/rollback answered {status} {body}")
        wave = wave_of(work_docs, RELOAD_WAVE, "r8d")
        out["D"] = check_wave("wave D", client_wave(server.port, wave, "d"),
                              wave, [expect(old, wave)])

        # E: a canary fault rejects the reload; the old set keeps serving
        failures0 = metric_value(rp, "policy_server_policy_reload_failures_total")
        rollbacks0 = metric_value(rp, "policy_server_policy_reload_rollbacks_total")

        def canary_fault() -> None:
            raise failpoints.FailpointError("injected canary fault")

        failpoints.set_failpoint("reload.canary", canary_fault, count=1)
        with open(path, "w") as f:
            json.dump(new_specs, f, indent=1)
        wait_until(
            lambda: lc.stats()["reload_failures"] >= 1 and not lc.reload_in_flight(),
            120, "the rejected reload",
        )
        failpoints.reset()
        failures1 = metric_value(rp, "policy_server_policy_reload_failures_total")
        rollbacks1 = metric_value(rp, "policy_server_policy_reload_rollbacks_total")
        if (failures1 - failures0, rollbacks1 - rollbacks0) != (1.0, 1.0):
            fail(f"a rejected canary moved the counters by {failures1 - failures0}, {rollbacks1 - rollbacks0}")
        if lc.stats()["last_outcome"] != "rejected:canary" or lc.current_epoch != 0:
            fail(f"the rejected reload changed the serving epoch: {lc.stats()}")
        wave = wave_of(work_docs, RELOAD_WAVE, "r8e")
        out["E"] = check_wave("wave E", client_wave(server.port, wave, "e"),
                              wave, [expect(old, wave)])
        out["rejected"] = {"failures": failures1, "rollbacks": rollbacks1}

        # five reload-and-rollback cycles through the admin endpoints
        marks: dict = {}

        def mark(name):
            def fn() -> None:
                marks[name] = ck.launch_counts()
            return fn

        cycles = []
        for c in range(RELOAD_CYCLES):
            failpoints.set_failpoint("reload.compile", mark("compile"))
            failpoints.set_failpoint("reload.canary", mark("canary"))
            reloads = lc.stats()["reloads"]
            status, body = admin_post(rp, "/policies/reload")
            if status != 202 or body.get("status") != "reload started":
                fail(f"POST /policies/reload answered {status} {body}")
            wait_until(
                lambda: lc.stats()["reloads"] > reloads and not lc.reload_in_flight(),
                120, f"reload {c + 1}",
            )
            end = ck.launch_counts()
            failpoints.reset()
            candidates.append({
                "stages_s": dict(lc.last_stage_seconds),
                "probe": marks["canary"]["probe"] - marks["compile"]["probe"],
                "k1_warmup": (
                    marks["canary"]["policy_matrix"]
                    - marks["compile"]["policy_matrix"]
                ),
                "k1_canary": end["policy_matrix"] - marks["canary"]["policy_matrix"],
            })
            status, body = admin_post(rp, "/policies/rollback")
            if status != 200 or body.get("status") != "rolled-back":
                fail(f"POST /policies/rollback answered {status} {body}")
            join_retirements()
            gc.collect()
            torch.cuda.synchronize()
            cycles.append({
                "memory_allocated": torch.cuda.memory_allocated(),
                "max_memory_reserved": torch.cuda.max_memory_reserved(),
            })
        out["candidates"] = candidates
        out["cycles"] = cycles
        for cand in candidates:
            if cand["probe"] < 1 or cand["k1_warmup"] < 1 or cand["k1_canary"] < 1:
                fail(f"a reload candidate did not launch both kernels: {cand}")
        grown = cycles[-1]["memory_allocated"] - cycles[1]["memory_allocated"]
        out["memory_growth_after_cycle_2"] = grown
        if grown > RELOAD_MEMORY_SLACK:
            fail(f"device memory keeps growing over the reload cycles: {cycles}")

        # F: kill the drainer and the dispatch loop; the watchdog revives
        front0 = metric_value(rp, "policy_server_selfheal_frontend_revives_total")
        batch0 = metric_value(rp, "policy_server_selfheal_batcher_revives_total")

        class DrainerDeath(BaseException):
            """Ends the thread it is raised on."""

        def kill_drainer() -> None:
            raise DrainerDeath()

        failpoints.set_failpoint("frontend.accept", kill_drainer, count=1)
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        try:
            conn.request("POST", f"/validate/{work_docs[0][0]}",
                         body=json.dumps(work_docs[0][1]).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            killed = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()
        if killed != (500, {"message": "Something went wrong", "status": 500}):
            fail(f"the drainer's last burst was answered {killed}")
        wait_until(lambda: metric_value(
            rp, "policy_server_selfheal_frontend_revives_total") == front0 + 1,
            30, "the drainer's revive")

        def kill_loop() -> None:
            raise failpoints.FailpointError("injected dispatch-loop death")

        failpoints.set_failpoint("shard.dispatch", kill_loop, count=1)
        wait_until(lambda: metric_value(
            rp, "policy_server_selfheal_batcher_revives_total") == batch0 + 1,
            30, "the dispatch loop's revive")
        failpoints.reset()
        wave = wave_of(work_docs, RELOAD_F_WAVE, "r8f")
        out["F"] = check_wave("wave F", client_wave(server.port, wave, "f"),
                              wave, [expect(old, wave)])
        out["revives"] = server.state.supervisor.stats()

        # G: stop with a wave in flight
        wave = wave_of(work_docs, RELOAD_STOP_WAVE, "r8g")
        requests0 = server.native_frontend.stats()["http_requests"]
        proc, res_path = start_client(server.port, wave, "g", tolerate_close=True)
        wait_until(
            lambda: server.native_frontend.stats()["http_requests"] - requests0
            >= RELOAD_STOP_WAVE // 8 or proc.poll() is not None,
            60, "the stop wave to start",
        )
        t_stop = time.perf_counter()
        server.stop()
        stopped = True
        out["stop_s"] = time.perf_counter() - t_stop
        results = finish_client(proc, res_path, "the stop wave")
        out["G"] = check_wave("wave G (stop)", results, wave,
                              [expect(old, wave)], allow_stopping=True)
    finally:
        failpoints.reset()
        if not stopped:
            server.stop()
    torch.cuda.synchronize()
    out["launches"] = ck.launch_counts()
    out["k1_err"] = hold_set_against_plain(
        new_specs, [d for _pid, d in work_docs], card, "phase8 changed set"
    )
    return out


def print_reload_phase(r8: dict, card: str) -> None:
    for name in ("A", "B", "C", "D", "E", "F"):
        w = r8[name]
        print(
            f"phase8 wave {name}: {w['answered']} answered, p50 {w['p50']:.3f} "
            f"ms p99 {w['p99']:.3f} ms, matched only by each expected set "
            f"{w['only']}" + (f", {w['waves']} client waves" if "waves" in w else "")
            + f" [{card}]"
        )
    g = r8["G"]
    print(
        f"phase8 stop with a wave in flight: {g['answered']} answered "
        f"({g['stopping_503']} the in-band 503, the rest verdicts of the "
        f"serving set, 0 of them 500), {g['unanswered']} unanswered "
        f"(connections closed); stop() {r8['stop_s']:.3f} s [{card}]"
    )
    print(
        f"phase8 server build {r8['build_s']:.3f} s (launches "
        f"{r8['boot_launches']}); watch-triggered reload under wave B, "
        f"stage seconds {json.dumps(r8['reload_B'])}; rejected canary: "
        f"{json.dumps(r8['rejected'])} [{card}]"
    )
    for i, (cand, cyc) in enumerate(zip(r8["candidates"], r8["cycles"])):
        print(
            f"phase8 cycle {i + 1}: reload stage seconds "
            f"{json.dumps(cand['stages_s'])}; candidate launches probe "
            f"{cand['probe']}, policy_matrix warmup {cand['k1_warmup']} "
            f"canary {cand['k1_canary']}; after rollback "
            f"memory_allocated {cyc['memory_allocated']} "
            f"max_memory_reserved {cyc['max_memory_reserved']} [{card}]"
        )
    print(
        f"phase8 revives {json.dumps(r8['revives'])}; phase launches "
        f"{json.dumps(r8['launches'])}; allocation after cycle 5 minus "
        f"cycle 2: {r8['memory_growth_after_cycle_2']} B [{card}]"
    )


# -- phase 9: tenants, shedding and shards -----------------------------------


def tenant_specs() -> dict:
    """Phase 9's policy sets: the default tenant's flagship set, team-a's
    the phase 8 changed set, team-b's a subset of the flagship set."""
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    base = flagship_policy_specs()
    return {
        "default": base,
        "team-a": changed_specs(base),
        "team-b": {k: base[k] for k in sorted(base)[:TEAM_B_POLICIES]},
    }


def tenant_wave(work_docs: list, n: int, tag: str, tenants: tuple,
                subsets: dict) -> list:
    """``n`` requests spread round-robin over ``tenants`` → (route, body,
    tenant, policy id) each; a tenant's rows address its own set's ids."""
    out = []
    for i, (pid, d) in enumerate(work_docs[:n]):
        tenant = tenants[i % len(tenants)]
        ids = subsets[tenant]
        if pid not in ids:
            pid = ids[i % len(ids)]
        d = copy.deepcopy(d)
        d["request"]["uid"] = f"{d['request']['uid']}-{tag}"
        route = pid if tenant == "default" else f"{tenant}/{pid}"
        out.append((route, json.dumps(d).encode(), tenant, pid))
    return out


def client_run(port: int, wave: list, name: str,
               conns: int = NATIVE_CONNS) -> tuple:
    """Start the client process on one wave of (route, body, ...) → (the
    process, its OUT path) for ``finish_run``."""
    work_dir = os.path.join(REPO, "build", "chip_smoke_tenants")
    corpus = os.path.join(work_dir, f"{name}.bin")
    out = os.path.join(work_dir, f"{name}.json")
    write_corpus(corpus, [[(route, body) for route, body, *_ in wave]])
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--native-client",
         str(port), corpus, out, str(conns), str(NATIVE_DEPTH)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, out


def finish_run(proc, out: str, label: str) -> tuple[list, float]:
    """Wait for a ``client_run`` → (its results, the wave's wall
    seconds)."""
    try:
        _o, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    if proc.returncode != 0 or not os.path.exists(out):
        fail(f"the client of {label} failed: {err[-2000:]}")
    with open(out) as f:
        doc = json.load(f)
    os.unlink(out)
    return doc["results"], sum(doc["walls"])


def classify(label: str, results: list, wave: list, kinds: dict) -> dict:
    """Each answer must match one kind: ``kinds`` maps a name to a
    function (wave item, status, body bytes, Retry-After) → bool. → count
    per kind and p50/p99 ms; fails on an unanswered request or one that
    matches no kind."""
    counts = dict.fromkeys(kinds, 0)
    lat, bad = [], []
    for i, (r, item) in enumerate(zip(results, wave)):
        if r is None:
            fail(f"{label}: request {i} unanswered")
        status, ms, body, retry = r
        body = body.encode("latin-1")
        lat.append(ms)
        for name, match in kinds.items():
            if match(item, status, body, retry):
                counts[name] += 1
                break
        else:
            bad.append((i, status, retry, body[:300]))
    if bad:
        for row in bad[:3]:
            print(f"mismatch ({label}) request {row[0]}: {row[1:]}")
        fail(f"{len(bad)} answers of {label} match no expected answer")
    lat.sort()
    counts["p50"] = lat[len(lat) // 2]
    counts["p99"] = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    return counts


def post_one(port: int, item: tuple, out: list, i: int) -> None:
    """POST one (route, body, ...) on a connection of its own → ``out[i]``
    as the client process records it."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/validate/{item[0]}", body=item[1],
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        retry = resp.getheader("Retry-After")
        out[i] = (resp.status, (time.perf_counter() - t0) * 1e3,
                  resp.read().decode("latin-1"),
                  None if retry is None else int(retry))
    finally:
        conn.close()


def labelled_value(port: int, name: str, label: str) -> float:
    status, text = http_get(port, "/metrics")
    for line in text.decode().splitlines():
        head, _, value = line.rpartition(" ")
        if head == f"{name}{{{label}}}":
            return float(value)
    return 0.0


def in_band_body(body: bytes, message: str, code: int) -> bytes:
    """The 200 AdmissionReview body of an in-band rejection of ``body``."""
    from policy_server_tpu_torch.models import (
        AdmissionResponse,
        AdmissionReviewResponse,
    )

    uid = json.loads(body)["request"]["uid"]
    return json.dumps(AdmissionReviewResponse(
        AdmissionResponse.reject(uid, message, code)
    ).to_dict()).encode()


class EnvLedger:
    """Per-environment accounting of a server's build: seconds and
    ``memory_allocated`` of each build and warmup, probe (K2) launches at
    the build, seconds building K1 programs; installed around the builder
    for the phase, then removed."""

    def __init__(self) -> None:
        import torch

        from policy_server_tpu_torch.evaluation import environment as em
        from policy_server_tpu_torch.ops import cuda_kernels as ck

        self.rows: dict[int, dict] = {}
        # K1 programs are built inside the environment's constructor, before
        # its row exists
        self.k1_build_s: dict[int, float] = {}
        builder, env_cls = em.EvaluationEnvironmentBuilder, em.EvaluationEnvironment
        self._saved = (builder.build, env_cls.warmup, env_cls.program_for)
        real_build, real_warmup, real_program = self._saved
        rows, k1_build_s = self.rows, self.k1_build_s

        def build(b, policies):
            if b.backend != "torch":
                return real_build(b, policies)
            torch.cuda.synchronize()
            m0, p0, t0 = torch.cuda.memory_allocated(), ck.launch_counts()["probe"], time.perf_counter()
            env = real_build(b, policies)
            torch.cuda.synchronize()
            rows[id(env)] = {
                "env": env, "build_s": time.perf_counter() - t0,
                "build_bytes": torch.cuda.memory_allocated() - m0,
                "probe": ck.launch_counts()["probe"] - p0,
                "warmup_s": 0.0, "warmup_bytes": 0, "warmup_k1": 0,
            }
            return env

        def warmup(env, batch_sizes=(1,)):
            row = rows.get(id(env))
            torch.cuda.synchronize()
            m0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
            k0 = ck.launch_counts()["policy_matrix"]
            real_warmup(env, batch_sizes)
            torch.cuda.synchronize()
            if row is not None:
                row["warmup_s"] += time.perf_counter() - t0
                row["warmup_bytes"] += torch.cuda.memory_allocated() - m0
                row["warmup_k1"] += ck.launch_counts()["policy_matrix"] - k0

        def program_for(env, schema_idx, transport, narrow, shard=None):
            key = (schema_idx, transport, narrow)
            new = (key if shard is None else key + (shard,)) not in env._programs
            t0 = time.perf_counter()
            program = real_program(env, schema_idx, transport, narrow, shard)
            if new:
                k1_build_s[id(env)] = (
                    k1_build_s.get(id(env), 0.0) + time.perf_counter() - t0
                )
            return program

        builder.build, env_cls.warmup, env_cls.program_for = build, warmup, program_for
        self._classes = (builder, env_cls)

    def remove(self) -> None:
        builder, env_cls = self._classes
        builder.build = self._saved[0]
        env_cls.warmup, env_cls.program_for = self._saved[1:]

    def table(self, server) -> list:
        """One row per serving environment of ``server``: its tenant and
        shard, build and warmup seconds, the bytes both allocated, K1
        program build seconds, K2 launches at the build, and K1 launches in
        the warmup and in serving (its K1 dispatches past the warmup)
        so far."""
        out = []
        for t in server.state.tenants.all():
            plane = t.state.batcher
            shards = getattr(plane, "_shards", None)
            pairs = [(s.index, s.env) for s in shards] if shards else [(0, plane.env)]
            for idx, env in pairs:
                row = self.rows.get(id(env))
                if row is None:
                    fail(f"tenant {t.name} shard {idx} has an unrecorded environment")
                out.append({
                    "tenant": t.name, "shard": idx,
                    "build_s": round(row["build_s"], 4),
                    "warmup_s": round(row["warmup_s"], 4),
                    "k1_build_s": round(self.k1_build_s.get(id(env), 0.0), 4),
                    "memory_allocated": row["build_bytes"] + row["warmup_bytes"],
                    "probe_launches": row["probe"],
                    "policy_matrix_warmup_launches": row["warmup_k1"],
                    # K1's dispatches past those of the warmup
                    "policy_matrix_serving_launches": (
                        env.pallas_stats["dispatches"] - row["warmup_k1"]
                    ),
                })
        return out


def tenants_phase(work_docs: list, card: str) -> dict:
    """Phase 9 (see the module docstring) → its numbers."""
    import torch

    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.api.api_error import api_error_body, shed_body
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.runtime.batcher import (
        DEADLINE_MESSAGE,
        EXPIRED_MESSAGE,
        FencedError,
        ShedError,
    )
    from policy_server_tpu_torch.runtime.shards import ShardRouter
    from policy_server_tpu_torch.tenancy import unknown_tenant_message

    specs = tenant_specs()
    work_dir = os.path.join(REPO, "build", "chip_smoke_tenants")
    os.makedirs(work_dir, exist_ok=True)
    for name, s in specs.items():
        with open(os.path.join(work_dir, f"{name}.json"), "w") as f:
            json.dump(s, f)
    manifest = os.path.join(work_dir, "tenants.json")
    with open(manifest, "w") as f:
        json.dump({"tenants": {
            "team-a": {"policies": "team-a.json"},
            "team-b": {
                "policies": "team-b.json",
                "quota-rows-per-second": TEAM_B_RATE,
                "quota-burst": TEAM_B_BURST,
                "request-timeout-ms": TEAM_B_TIMEOUT_MS,
            },
        }}, f)
    oracles = {
        name: EvaluationEnvironmentBuilder(backend="oracle").build(parse_policies(s))
        for name, s in specs.items()
    }
    subsets = {name: sorted(s) for name, s in specs.items()}
    args = build_cli().parse_args([
        "--policies", os.path.join(work_dir, "default.json"),
        "--addr", "127.0.0.1", "--port", "0", "--readiness-probe-port", "0",
        "--frontend", "native", "--enable-metrics", "--serving-shards", "2",
        "--tenants", manifest,
    ])
    if (args.request_timeout_ms, args.shard_heartbeat_seconds) != (10000.0, 0.5):
        fail("phase 9 does not run at the default request timeout and heartbeat")

    def verdict(item, status, body, _retry):
        _route, req, tenant, pid = item
        return tenant in oracles and (
            (status, body) == expected_answer(oracles[tenant], pid, req)
        )

    def shed(_item, status, body, retry):
        return (status == ShedError.http_status and retry is not None
                and body == shed_body(retry, ShedError.message))

    def fenced(_item, status, body, retry):
        return (status == FencedError.http_status and retry is not None
                and body == shed_body(retry, FencedError.message))

    def expired(item, status, body, _retry):
        return (status, body) == (200, in_band_body(item[1], EXPIRED_MESSAGE, 504))

    def deadline(item, status, body, _retry):
        return (status, body) == (200, in_band_body(item[1], DEADLINE_MESSAGE, 500))

    out: dict = {}
    # the earlier phases' garbage first: freed later, it would read as this
    # phase's release
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ledger = EnvLedger()
    ck.reset_launch_counts()
    t_build = time.perf_counter()
    try:
        server = server_from_args(args)
    finally:
        ledger.remove()
    out["build_s"] = time.perf_counter() - t_build
    out["boot_launches"] = ck.launch_counts()
    server.start()
    rp = server.readiness_port
    stopped = False
    try:
        tenants = server.state.tenants
        planes = {t.name: t.state.batcher for t in tenants.all()}
        if sorted(planes) != ["default", "team-a", "team-b"] or not all(
            type(p) is ShardRouter and p.serving_shards == 2 for p in planes.values()
        ):
            fail(f"phase 9's tenants are not each served by two shards: {planes}")

        # T: every tenant's set, and an unknown tenant
        wave = tenant_wave(work_docs, T_WAVE, "t9",
                           ("default", "default", "team-a", "team-b"), subsets)
        for _route, body, _t, pid in wave[:8]:
            wave.append((f"nope/{pid}", body, "nope", pid))
        nope = api_error_body(404, unknown_tenant_message("nope"))
        results, wall = finish_run(*client_run(server.port, wave, "t"), "wave T")
        out["T"] = classify("wave T", results, wave, {
            "verdict": verdict,
            "unknown_tenant": lambda it, st, b, _r: it[2] == "nope" and (st, b) == (404, nope),
        })
        out["T"]["req_s"] = len(wave) / wall
        if out["T"]["unknown_tenant"] != 8:
            fail(f"wave T: unknown tenant answers {out['T']}")
        for path in ("/readiness", "/readiness/team-a", "/readiness/team-b"):
            status, text = http_get(rp, path)
            if status != 200:
                fail(f"{path} answered {status} {text!r}")

        # Q: team-b over its quota beside team-a
        time.sleep(TEAM_B_BURST / TEAM_B_RATE + 0.5)  # team-b's bucket refills
        shed0 = labelled_value(rp, "policy_server_tenant_shed_rows_total", 'tenant="team-b"')
        q_expired0 = planes["team-b"].stats_snapshot()["expired_dropped"]
        q_default_expired0 = metric_value(rp, "policy_server_expired_dropped_rows_total")
        q_b = tenant_wave(work_docs, Q_WAVE, "q9b", ("team-b",), subsets)
        q_a = tenant_wave(work_docs, Q_WAVE // 2, "q9a", ("team-a",), subsets)
        # team-b's whole wave in flight at once (128 connections x depth
        # 8): its overflow then does not hang on how fast the card's host
        # answers (at 32 connections a wave slower than the bucket's
        # refill was admitted whole)
        runs = [client_run(server.port, q_b, "qb", conns=Q_WAVE // NATIVE_DEPTH),
                client_run(server.port, q_a, "qa")]
        (res_b, wall_b), (res_a, _wall_a) = (
            finish_run(*runs[0], "wave Q team-b"), finish_run(*runs[1], "wave Q team-a")
        )
        # on a slow host team-b's queued rows can pass its 500 ms request
        # deadline: those answer the in-band 504, each counted once by
        # team-b's expired_dropped (checked below)
        out["Q_b"] = classify("wave Q team-b", res_b, q_b,
                              {"verdict": verdict, "shed_429": shed,
                               "expired_504": expired})
        out["Q_a"] = classify("wave Q team-a", res_a, q_a, {"verdict": verdict})
        shed1 = labelled_value(rp, "policy_server_tenant_shed_rows_total", 'tenant="team-b"')
        out["Q_tenant_shed_rows"] = shed1 - shed0
        out["Q_b_expired_rows"] = (
            planes["team-b"].stats_snapshot()["expired_dropped"] - q_expired0
        )
        if not (0 < out["Q_b"]["shed_429"] < len(q_b)):
            fail(f"wave Q: team-b did not overflow its quota in part: {out['Q_b']}")
        if shed1 - shed0 != out["Q_b"]["shed_429"]:
            fail(f"policy_server_tenant_shed_rows{{tenant=\"team-b\"}} moved by "
                 f"{shed1 - shed0}, not the {out['Q_b']['shed_429']} answers 429")
        if out["Q_b_expired_rows"] != out["Q_b"]["expired_504"]:
            fail(f"wave Q: team-b's expired_dropped moved by "
                 f"{out['Q_b_expired_rows']}, not the "
                 f"{out['Q_b']['expired_504']} answers 504")
        # the family reads the default tenant's plane, which expired nothing
        q_default_expired1 = metric_value(rp, "policy_server_expired_dropped_rows_total")
        if q_default_expired1 != q_default_expired0 or q_default_expired1 != (
            planes["default"].stats_snapshot()["expired_dropped"]
        ):
            fail("wave Q: policy_server_expired_dropped_rows is not the default "
                 "tenant's count")

        # X: team-b's device fetch sleeps past its request timeout
        time.sleep(TEAM_B_BURST / TEAM_B_RATE + 0.5)
        plane_b = planes["team-b"]
        expired0 = plane_b.stats_snapshot()["expired_dropped"]
        default_expired0 = metric_value(rp, "policy_server_expired_dropped_rows_total")
        # every team-b batch to the device, where the fetch sleeps; its
        # verdict caches emptied, since they hold waves T and Q's answers
        # and a cache hit never reaches the fetch
        for s in plane_b._shards:
            s.batcher.host_fastpath_threshold = 0
            s.env._verdict_cache.clear()
            s.env._blob_cache.clear()
        failpoints.set_failpoint(
            "device.fetch", lambda: time.sleep(X_SLEEP_SECONDS), scope="team-b"
        )
        try:
            # first the plug: single requests a few ms apart, each its own
            # batch, until every team-b batch worker waits on the fetch;
            # then the wave, whose rows queue behind them past 500 ms
            plug = tenant_wave(work_docs, X_PLUG, "x9p", ("team-b",), subsets)
            plug_res: list = [None] * len(plug)
            threads = []
            for i, item in enumerate(plug):
                threads.append(threading.Thread(
                    target=post_one, args=(server.port, item, plug_res, i)
                ))
                threads[-1].start()
                time.sleep(0.01)
            x = tenant_wave(work_docs, X_WAVE, "x9", ("team-b",), subsets)
            res_x, _w = finish_run(*client_run(server.port, x, "x"), "wave X")
            for t in threads:
                t.join(60)
        finally:
            failpoints.clear("device.fetch")
            for s in plane_b._shards:
                s.batcher.host_fastpath_threshold = args.host_fastpath_threshold
        x, res_x = plug + x, plug_res + res_x
        out["X"] = classify("wave X", res_x, x, {
            "verdict": verdict, "expired_504": expired,
            "deadline_500": deadline, "shed_429": shed,
        })
        out["X_expired_rows"] = plane_b.stats_snapshot()["expired_dropped"] - expired0
        if out["X"]["expired_504"] < 1 or out["X_expired_rows"] != out["X"]["expired_504"]:
            fail(f"wave X: {out['X']}; team-b's expired rows moved by {out['X_expired_rows']}")
        # the family reads the default tenant's plane, as the JAX package's
        out["X_default_family"] = metric_value(
            rp, "policy_server_expired_dropped_rows_total"
        )
        if out["X_default_family"] != default_expired0 or default_expired0 != (
            planes["default"].stats_snapshot()["expired_dropped"]
        ):
            fail("policy_server_expired_dropped_rows is not the default tenant's count")
        out["X_breaker"] = plane_b.env.breaker_stats

        # S: kill one of the default tenant's shards under a wave
        plane = planes["default"]
        victim = plane._shards[0].batcher
        fences0 = metric_value(rp, "policy_server_shard_fences_total")
        revives0 = server.state.supervisor.stats()["batcher_revives"]
        killed: dict = {}

        def kill() -> None:
            if not killed and threading.current_thread() is victim._thread:
                killed["at"] = time.perf_counter()
                killed["thread"] = threading.current_thread()
                raise failpoints.FailpointError("injected shard death")

        wave = tenant_wave(work_docs, S_WAVE, "s9", ("default",), subsets)
        requests0 = server.native_frontend.stats()["http_requests"]
        proc, res_path = client_run(server.port, wave, "s")
        wait_until(
            lambda: server.native_frontend.stats()["http_requests"] - requests0
            >= S_WAVE // 8 or proc.poll() is not None,
            60, "wave S to start",
        )
        f0 = plane.stats_snapshot()["shard_fences"]
        failpoints.set_failpoint("shard.dispatch", kill, scope="shard-0")
        # the death is the thread's end, what the heartbeat can see: the
        # raise ends the thread only after the loop and the interpreter's
        # thread-exception hook have run
        dead_at = fenced_at = None
        give_up = time.perf_counter() + 10
        while fenced_at is None and time.perf_counter() < give_up:
            now = time.perf_counter()
            if dead_at is None and "thread" in killed and not killed["thread"].is_alive():
                dead_at = now
            if plane.stats_snapshot()["shard_fences"] > f0:
                fenced_at = now
            time.sleep(0.001)
        if fenced_at is None:
            fail("timed out waiting for the killed shard's fence")
        dead_at = dead_at or fenced_at
        out["S_death_s"] = dead_at - killed["at"]
        out["S_fence_s"] = fenced_at - dead_at
        failpoints.clear("shard.dispatch")
        wait_until(lambda: plane.stats_snapshot()["shard_respawns"] >= 1, 10,
                   "the killed shard's revive")
        res_s, _w = finish_run(proc, res_path, "wave S")
        out["S"] = classify("wave S", res_s, wave,
                            {"verdict": verdict, "fenced_503": fenced})
        snap = plane.stats_snapshot()
        out["S_router"] = {k: snap[k] for k in (
            "shard_fences", "shard_reroutes", "shard_fenced_rows", "shard_respawns",
        )}
        out["S_metric_fences"] = metric_value(rp, "policy_server_shard_fences_total") - fences0
        out["S_revives"] = server.state.supervisor.stats()["batcher_revives"] - revives0
        if (out["S_metric_fences"], out["S_revives"], snap["shard_respawns"]) != (1.0, 1, 1):
            fail(f"wave S: fences {out['S_metric_fences']}, revives {out['S_revives']}, {snap}")
        out["S_fence_limit_s"] = args.shard_heartbeat_seconds + S_FENCE_ALLOWANCE_S
        if out["S_fence_s"] > out["S_fence_limit_s"]:
            fail(f"the killed shard was fenced {out['S_fence_s']:.3f} s after its thread ended")
        if not all(h["healthy"] and h["dispatch_alive"] for h in plane.shard_health()):
            fail(f"the killed shard is not back: {plane.shard_health()}")
        out["envs"] = ledger.table(server)
        server.stop()
        stopped = True
    finally:
        failpoints.reset()
        if not stopped:
            server.stop()
    join_retirements()
    gc.collect()
    torch.cuda.synchronize()
    out["memory_after_stop"] = torch.cuda.memory_allocated() - mem0
    out["launches"] = ck.launch_counts()
    if out["launches"]["probe"] < 6 or out["launches"]["policy_matrix"] < 1:
        fail(f"phase 9 did not launch both kernels in its six environments: {out['launches']}")
    # team-b's subset is the one K1 program this phase adds (the default
    # set is held in phase 2, team-a's in phase 8)
    out["k1_err"] = hold_set_against_plain(
        specs["team-b"], [d for _pid, d in work_docs], card, "phase9 team-b set"
    )
    out["rates"] = shard_rates(work_docs, oracles["default"], card)
    return out


def shard_rates(work_docs: list, oracle, card: str) -> dict:
    """req/s and p50/p99 of a default-flag native server with one serving
    shard and with two, the same waves, every body the oracle's; measured,
    not compared."""
    import torch

    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    path = os.path.join(REPO, "build", "chip_smoke_tenants", "default.json")
    rates = {}
    for shards in (1, 2):
        args = build_cli().parse_args([
            "--policies", path, "--addr", "127.0.0.1", "--port", "0",
            "--readiness-probe-port", "0", "--frontend", "native",
            "--serving-shards", str(shards),
        ])
        ck.reset_launch_counts()
        server = server_from_args(args)
        server.start()
        try:
            boot = ck.launch_counts()
            rows, wall, lat = 0, 0.0, []
            for w in range(RATE_WAVES):
                wave = [
                    (pid, body, "default", pid)
                    for pid, body in wave_of(work_docs, N_REQUESTS, f"r9s{shards}w{w}")
                ]
                res, wall_w = finish_run(
                    *client_run(server.port, wave, f"rate{shards}"), f"rate {shards}"
                )
                for (route, body, _t, pid), r in zip(wave, res):
                    if r is None or (r[0], r[2].encode("latin-1")) != expected_answer(oracle, pid, body):
                        fail(f"--serving-shards {shards}: an answer differs from the oracle's")
                    lat.append(r[1])
                rows += len(wave)
                wall += wall_w
            end = ck.launch_counts()
        finally:
            server.stop()
        lat.sort()
        rates[shards] = {
            "req_s": rows / wall, "p50": lat[len(lat) // 2],
            "p99": lat[int(0.99 * (len(lat) - 1))],
            "serving_launches": end["policy_matrix"] - boot["policy_matrix"],
            "probe": end["probe"],
        }
    torch.cuda.synchronize()
    return rates


def print_tenants_phase(r9: dict, card: str) -> None:
    t = r9["T"]
    print(
        f"phase9 server build {r9['build_s']:.3f} s (3 tenants x 2 shards; "
        f"launches {json.dumps(r9['boot_launches'])}) [{card}]"
    )
    print(
        f"phase9 wave T: {t['verdict']} verdicts of their tenant's oracle, "
        f"{t['unknown_tenant']} unknown-tenant 404s, {t['req_s']:.1f} req/s, "
        f"p50 {t['p50']:.3f} ms p99 {t['p99']:.3f} ms [{card}]"
    )
    print(
        f"phase9 wave Q: team-b {r9['Q_b']['verdict']} verdicts, "
        f"{r9['Q_b']['shed_429']} answers 429 with Retry-After "
        f"(policy_server_tenant_shed_rows{{tenant=\"team-b\"}} +"
        f"{r9['Q_tenant_shed_rows']:.0f}), {r9['Q_b']['expired_504']} in-band "
        f"504s past its 500 ms deadline (team-b's expired_dropped "
        f"+{r9['Q_b_expired_rows']}); team-a beside it "
        f"{r9['Q_a']['verdict']} verdicts, p50 {r9['Q_a']['p50']:.3f} ms "
        f"p99 {r9['Q_a']['p99']:.3f} ms [{card}]"
    )
    x = r9["X"]
    print(
        f"phase9 wave X (team-b fetch sleeps {X_SLEEP_SECONDS} s past its "
        f"{TEAM_B_TIMEOUT_MS} ms deadline): {x['verdict']} verdicts, "
        f"{x['expired_504']} expired 504s (team-b's expired_dropped "
        f"+{r9['X_expired_rows']}), {x['deadline_500']} deadline 500s, "
        f"{x['shed_429']} shed 429s; team-b breaker {json.dumps(r9['X_breaker'])} [{card}]"
    )
    s = r9["S"]
    print(
        f"phase9 wave S (default tenant's shard 0 killed): its thread "
        f"ended {r9['S_death_s']:.3f} s after the raise, fenced "
        f"{r9['S_fence_s']:.3f} s after that (limit "
        f"{r9['S_fence_limit_s']:.3f} s); {s['verdict']} verdicts, "
        f"{s['fenced_503']} fenced 503s; router {json.dumps(r9['S_router'])}; "
        f"policy_server_shard_fences +{r9['S_metric_fences']:.0f}, self-heal "
        f"batcher revives +{r9['S_revives']}; p50 {s['p50']:.3f} ms p99 "
        f"{s['p99']:.3f} ms [{card}]"
    )
    for row in r9["envs"]:
        print(f"phase9 environment {json.dumps(row)} [{card}]")
    print(
        f"phase9 launches {json.dumps(r9['launches'])}; memory_allocated "
        f"after stop minus before build: {r9['memory_after_stop']} B [{card}]"
    )
    for shards, r in sorted(r9["rates"].items()):
        print(
            f"phase9 rate --serving-shards {shards}, default flags, native: "
            f"{r['req_s']:.1f} req/s, p50 {r['p50']:.3f} ms p99 {r['p99']:.3f} "
            f"ms over {RATE_WAVES} waves of {N_REQUESTS}; {r['serving_launches']} "
            f"policy_matrix launches after the warmup [{card}]"
        )


# -- phase 10: audit on the card ----------------------------------------------


def stream_client_main(argv: list[str]) -> int:
    """Phase 10's ``/audit/stream`` client, in a process of its own: reads
    the NDJSON stream from ``CURSOR`` and appends every entry to OUT (one
    JSON line each); after an OVERFLOW line, or a connection the server
    closes, it writes a RECONNECT line and reconnects with the last
    matrixVersion it holds (a RESYNC marker's, or a delta's). OUT.progress
    holds the entries read, the last version and the reconnects; the
    client stops once the file STOP exists and a quiet half second
    passed."""
    import select
    import socket

    port, cursor, out_path, stop_path = (
        int(argv[0]), int(argv[1]), argv[2], argv[3]
    )
    n = reconnects = 0
    last = cursor
    in_state = False
    out = open(out_path, "w")

    def progress() -> None:
        with open(out_path + ".tmp", "w") as f:
            json.dump({"entries": n, "last_version": last,
                       "reconnects": reconnects}, f)
        os.replace(out_path + ".tmp", out_path + ".progress")

    progress()
    while True:
        s = socket.create_connection(("127.0.0.1", port), timeout=30)
        s.sendall(
            f"GET /audit/stream?cursor={last} HTTP/1.1\r\nHost: smoke\r\n\r\n"
            .encode()
        )
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("the stream closed before its headers")
            buf += chunk
        head, _, buf = buf.partition(b"\r\n\r\n")
        if b" 200 " not in head.split(b"\r\n")[0]:
            raise ConnectionError(f"the stream answered {head[:200]!r}")
        body = b""
        quiet_since = time.monotonic()
        reconnect = False
        while not reconnect:
            # decode whole chunks, then whole lines
            while True:
                size_end = buf.find(b"\r\n")
                if size_end < 0:
                    break
                size = int(buf[:size_end], 16)
                if len(buf) < size_end + 2 + size + 2:
                    break
                if size == 0:
                    reconnect = True
                    break
                body += buf[size_end + 2 : size_end + 2 + size]
                buf = buf[size_end + 2 + size + 2 :]
            lines = body.split(b"\n")
            body = lines.pop()
            for line in lines:
                entry = json.loads(line)
                out.write(line.decode() + "\n")
                n += 1
                kind = entry["type"]
                if kind == "RESYNC":
                    in_state = True
                    last = entry["matrixVersion"]
                elif kind == "OVERFLOW":
                    reconnect = True
                elif in_state and entry["matrixVersion"] <= last:
                    pass  # the resynced state, each cell at its own version
                else:
                    in_state = False
                    last = entry["matrixVersion"]
            if lines:
                out.flush()
                progress()
                quiet_since = time.monotonic()
            if reconnect:
                break
            ready, _w, _x = select.select([s], [], [], 0.1)
            if ready:
                chunk = s.recv(1 << 20)
                if not chunk:
                    reconnect = True
                    break
                buf += chunk
            elif (
                os.path.exists(stop_path)
                and time.monotonic() - quiet_since > 0.5
            ):
                s.close()
                out.close()
                progress()
                return 0
        s.close()
        reconnects += 1
        out.write(json.dumps({"type": "RECONNECT", "cursor": last}) + "\n")
        out.flush()
        progress()


def read_progress(out_path: str) -> dict:
    try:
        with open(out_path + ".progress") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"entries": 0, "last_version": -1, "reconnects": 0}


def replay_stream(entries: list) -> dict:
    """The stream client's entries → its matrix view ((resource, policy) →
    allowed), the delta entries (not resynced state), the RESYNC markers'
    versions, the OVERFLOW lines and the reconnects. Fails unless every
    delta's matrixVersion rises past the last delta's and the last
    RESYNC marker's."""
    view: dict = {}
    deltas: list = []
    resyncs: list = []
    overflows = reconnects = 0
    marker = 0
    last_delta = 0
    in_state = False
    for e in entries:
        kind = e["type"]
        if kind == "RECONNECT":
            reconnects += 1
            in_state = False
            continue
        if kind == "OVERFLOW":
            overflows += 1
            continue
        if kind == "RESYNC":
            view = {}
            marker = e["matrixVersion"]
            resyncs.append(marker)
            in_state = True
            continue
        v = e["matrixVersion"]
        if in_state and v <= marker:
            pass
        else:
            in_state = False
            if v <= last_delta or v <= marker:
                fail(f"the stream's matrixVersion did not rise: {v} after "
                     f"{max(last_delta, marker)}")
            last_delta = v
            deltas.append(e)
        key = (e["resource"], e["policy"])
        if kind == "DELETE":
            view.pop(key, None)
        else:
            view[key] = e["allowed"]
    return {"view": view, "deltas": deltas, "resyncs": resyncs,
            "overflows": overflows, "reconnects": reconnects}


def read_stream(out_path: str) -> list:
    with open(out_path) as f:
        return [json.loads(line) for line in f if line.strip()]


def audit_inventory(n: int, seed: int) -> list:
    """``n`` distinct pod objects from the flagship firehose (seeded), one
    in eight widened into the large schema bucket, each with a name of its
    own."""
    from policy_server_tpu_torch.policies.flagship import synthetic_firehose

    objects = []
    for i, d in enumerate(synthetic_firehose(n, seed=seed)):
        if i % 8 == 0:
            d = widen(d)
        obj = copy.deepcopy(d["request"]["object"])
        obj["metadata"]["name"] = f"{obj['metadata']['name']}-inv{i:05d}"
        objects.append(obj)
    return objects


def oracle_results(oracle, req, policy_ids: list) -> dict:
    """policy id → the oracle backend's raw result for ``req`` (what its
    ``validate_batch(..., run_hooks=False)`` gives), with its host
    interpreter run once per distinct evaluation payload rather than once
    per policy."""
    from policy_server_tpu_torch.evaluation.policy_id import PolicyID

    outputs: dict = {}
    out = {}
    for pid in policy_ids:
        try:
            target = oracle._lookup_top_level(PolicyID.parse(pid))
            payload = oracle.payload_for(target, req)
            hit = outputs.get(id(payload))
            if hit is None:
                hit = outputs[id(payload)] = (
                    payload, oracle._oracle_outputs(payload)
                )
            out[pid] = oracle._materialize(target, req, hit[1])
        except Exception as e:  # noqa: BLE001 — an error row
            out[pid] = e
    return out


def oracle_verdicts(oracle, rows: list, policy_ids: list, cache: dict) -> dict:
    """(resource, policy) → the oracle's raw (audit-origin) verdict fields
    (allowed, mutated, message, code, error) for every snapshot row ×
    policy, memoized by the row's payload. Pre-eval hooks do not run, as
    on the audit lane (the flagship set's signature policies have hooks
    where ``cryptography`` is installed: their verdicts depend on the
    images the live requests' hooks verified)."""
    from policy_server_tpu_torch.audit import normalized_payload_hash

    out = {}
    for key, req in rows:
        phash = normalized_payload_hash(req)
        results = None
        for pid in policy_ids:
            hit = cache.get((key, pid))
            if hit is None or hit[0] != phash:
                # as the audit lane evaluates: no pre-eval hooks
                if results is None:
                    results = oracle_results(oracle, req, policy_ids)
                r = results[pid]
                if isinstance(r, Exception):
                    v = (None, False, f"audit error: {r}", None, True)
                else:
                    st = r.status
                    v = (bool(r.allowed), r.patch is not None,
                         st.message if st else None, st.code if st else None,
                         False)
                hit = cache[(key, pid)] = (phash, v)
            out[key, pid] = hit[1]
    return out


def check_reports(label: str, rp: int, scanner, oracle, policy_ids: list,
                  cache: dict, epoch: int, card: str,
                  phase: str = "phase10") -> dict:
    """GET /audit/reports on the readiness port, with no sweep running and
    nothing dirty: every (resource, policy) row's verdict equals the
    oracle's for the snapshot's row, the summary counts agree, and the
    same GET with the ETag answers 304."""
    t0 = time.perf_counter()
    with scanner._sweep_lock:
        if scanner.snapshot.stats()["dirty"]:
            fail(f"{label}: rows are dirty with no sweep running")
        rows = scanner.snapshot.rows_snapshot()
        conn = http.client.HTTPConnection("127.0.0.1", rp, timeout=300)
        try:
            conn.request("GET", "/audit/reports")
            resp = conn.getresponse()
            raw = resp.read()
            etag = resp.getheader("ETag")
            status = resp.status
            conn.request("GET", "/audit/reports",
                         headers={"If-None-Match": etag})
            resp = conn.getresponse()
            not_modified = (resp.status, resp.read(), resp.getheader("ETag"))
        finally:
            conn.close()
    get_s = time.perf_counter() - t0
    if status != 200:
        fail(f"{label}: GET /audit/reports answered {status}")
    if not_modified != (304, b"", etag):
        fail(f"{label}: If-None-Match answered {not_modified[0]}, not 304")
    body = json.loads(raw)
    t1 = time.perf_counter()
    want = oracle_verdicts(oracle, rows, policy_ids, cache)
    oracle_s = time.perf_counter() - t1
    got = {}
    for r in body["reports"]:
        got[r["resource"], r["policy_id"]] = (
            r["allowed"], r["mutated"], r["message"], r["code"], r["error"],
        )
        if r["stale"] or r["epoch"] != epoch:
            fail(f"{label}: row {r['resource']} {r['policy_id']} is stale "
                 f"or of epoch {r['epoch']}, not {epoch}")
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        extra = [k for k in got if k not in want]
        first = (bad or extra)[0]
        fail(f"{label}: {len(bad)} report rows differ from the oracle, "
             f"{len(extra)} extra (first {first}: {got.get(first)} against "
             f"{want.get(first)})")
    summary = {
        "results": len(want),
        "resources": len({k for k, _p in want}),
        "pass": sum(1 for v in want.values() if v[0] is True),
        "fail": sum(1 for v in want.values() if v[0] is False),
        "error": sum(1 for v in want.values() if v[4]),
        "mutated": sum(1 for v in want.values() if v[1]),
        "stale": 0,
    }
    if body["summary"] != summary:
        fail(f"{label}: summary {body['summary']} is not the oracle's {summary}")
    print(
        f"{phase} {label}: GET /audit/reports {len(raw)} B, "
        f"{summary['results']} rows of {summary['resources']} resources "
        f"equal the oracle's audit-origin verdicts (summary "
        f"{json.dumps(summary)}); If-None-Match -> 304; GET {get_s:.3f} s, "
        f"oracle {oracle_s:.3f} s [{card}]"
    )
    return summary


def settle(scanner, what: str, timeout: float = 300) -> None:
    """Wait until no row is dirty and no sweep is running (one that
    collected rows clears their marks when it starts, so the sweep lock is
    what says their verdicts have landed)."""
    while True:
        wait_until(lambda: not scanner.snapshot.stats()["dirty"], timeout, what)
        with scanner._sweep_lock:
            if not scanner.snapshot.stats()["dirty"]:
                return


def update_wave(work_docs: list, n: int, tag: str) -> list:
    """``n`` UPDATE reviews of distinct objects (names of their own), with
    uids tagged ``tag``."""
    out = []
    for i, (pid, d) in enumerate(work_docs[:n]):
        d = copy.deepcopy(d)
        req = d["request"]
        req["operation"] = "UPDATE"
        req["name"] = f"{req['name']}-m{i:04d}"
        req["object"]["metadata"]["name"] = req["name"]
        req["oldObject"] = req["object"]
        req["uid"] = f"{req['uid']}-m{i:04d}-{tag}"
        out.append((pid, json.dumps(d).encode()))
    return out


def retag(wave: list, tag: str) -> list:
    """The same requests with fresh uids."""
    out = []
    for pid, body in wave:
        d = json.loads(body)
        d["request"]["uid"] = f"{d['request']['uid']}-{tag}"
        out.append((pid, json.dumps(d).encode()))
    return out


def recorder_executes(rec, since: int) -> dict:
    """The flight recorder's ``device_execute`` events since the cursor: one
    per fetched K1 launch, with the rows (pairs) its verdicts answer; the
    audit lane's carry no batch id (-1), the serving batches' their
    own."""
    evs = [ev for ev in rec.snapshot() if ev["seq"] >= since]
    wrapped = rec.events_recorded() > since and (
        not evs or evs[0]["seq"] > since
    )
    audit = [ev for ev in evs
             if ev["phase"] == "device_execute" and ev["batch"] < 0]
    live = [ev for ev in evs
            if ev["phase"] == "device_execute" and ev["batch"] >= 0]
    return {
        "audit_launches": len(audit),
        "audit_pairs": sum(ev["rows"] for ev in audit),
        "live_launches": len(live),
        "live_rows": sum(ev["rows"] for ev in live),
        "wrapped": wrapped,
    }


ENV_PHASES = ("prepare", "blob_dedup", "encode", "bookkeeping", "fetch",
              "materialize")


class AuditLaneTimes:
    """Stamps each audit job's submission and completion (the batcher's
    ``submit_audit`` wrapped on the instance), for a sweep's attribution:
    the lane (submission → result, which holds the pacing wait and the
    environment's work) and the scanner (a result → the next submission:
    report rows, matrix cells)."""

    def __init__(self, batcher) -> None:
        self.jobs: list = []
        real = batcher.submit_audit

        def submit_audit(pairs):
            stamp = [time.perf_counter(), None]
            self.jobs.append(stamp)
            future = real(pairs)
            future.add_done_callback(
                lambda _f: stamp.__setitem__(1, time.perf_counter())
            )
            return future

        batcher.submit_audit = submit_audit

    def since(self, rec, cursor: int, first_job: int, wall: float) -> dict:
        """ms per audit batch of each part of the sweep from ``first_job``,
        with the environment's phases (the recorder's events without a
        batch id since ``cursor``) inside the lane's time."""
        jobs = [j for j in self.jobs[first_job:] if j[1] is not None]
        n = max(1, len(jobs))
        lane = sum(done - sub for sub, done in jobs)
        scanner = sum(
            nxt[0] - cur[1] for cur, nxt in zip(jobs, jobs[1:])
        )
        env_ns = dict.fromkeys(ENV_PHASES, 0)
        evs = [ev for ev in rec.snapshot() if ev["seq"] >= cursor]
        if rec.events_recorded() > cursor and (not evs or evs[0]["seq"] > cursor):
            fail("phase10: the flight recorder ring wrapped during a sweep")
        for ev in evs:
            if ev["batch"] < 0 and ev["phase"] in env_ns:
                env_ns[ev["phase"]] += ev["end_ns"] - ev["start_ns"]
        env = sum(env_ns.values()) / 1e6
        return {
            "batches": len(jobs),
            "wall_ms_per_batch": wall * 1e3 / n,
            "lane_ms_per_batch": lane * 1e3 / n,
            "env_ms_per_batch": env / n,
            "env_phase_ms_per_batch": {
                k: round(v / 1e6 / n, 4) for k, v in env_ns.items()
            },
            "lane_wait_ms_per_batch": (lane * 1e3 - env) / n,
            "scanner_ms_per_batch": scanner * 1e3 / n,
        }


def device_memory() -> int:
    import torch

    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def hold_inventory_against_plain(objects: list, card: str) -> dict:
    """K1 on the card against its plain version, exact, on packed rows of
    the inventory's reviews at the audit path's batch sizes, both buckets,
    narrow form → per (bucket, B) the error and times."""
    import torch

    from policy_server_tpu_torch.audit import synthesize_review
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policies

    env = EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())
    per: dict = {}
    need = max(AUDIT_HOLD_BATCHES)
    for i, obj in enumerate(objects):
        payload = synthesize_review(obj, uid=f"hold-{i}").payload()
        idx, enc = env.encode_bucketed(payload)
        encs = per.setdefault(idx, [])
        if len(encs) < need:
            encs.append(enc)
        if len(per) == len(env.schemas) and all(
            len(v) == need for v in per.values()
        ):
            break
    rows = {}
    for idx, schema in enumerate(env.schemas):
        encs = per.get(idx, [])
        if len(encs) < need:
            fail(f"the inventory has {len(encs)} reviews for bucket {idx}")
        program = env.program_for(idx, True, True)
        for batch in AUDIT_HOLD_BATCHES:
            wide = schema.pack(schema.stack(encs[:batch], batch_size=batch))
            buf = schema.to_transport(wide, vocab_size=len(env.table))["__packed__"]
            dev = torch.from_numpy(buf).to("cuda")
            want_a, want_r = ck.policy_matrix_plain(dev, program)
            got_a, got_r = ck.policy_matrix(dev, program)
            torch.cuda.synchronize()
            if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
                fail(f"phase10: policy_matrix disagrees with its plain version "
                     f"on the inventory (bucket {idx}, B={batch})")
            err = int((got_r - want_r).abs().max()) + int(
                (got_a.to(torch.int32) - want_a.to(torch.int32)).abs().max()
            )
            nbytes = buf.nbytes + batch * program.out_cols * 5
            ops = batch * program.element_ops_per_row()
            bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            bound_ops_ms = ops / PEAK_OPS_PER_S * 1e3
            rows[idx, batch] = {
                "bucket": idx, "batch": batch, "width": int(buf.shape[1]),
                "max_abs_err": err,
                "ms": time_cuda(lambda: ck.policy_matrix(dev, program), 20),
                "device_ms": graph_ms(lambda: ck.policy_matrix(dev, program)),
                "plain_ms": time_cuda(
                    lambda: ck.policy_matrix_plain(dev, program), 2, warmup=1
                ),
                "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                "bound_by": (
                    "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
                ),
                "card": card,
            }
            print(f"phase10 policy_matrix exact on the inventory: "
                  f"{json.dumps(rows[idx, batch])}")
    env.close()
    return rows


def audit_phase(work_docs: list, card: str) -> dict:
    """Phase 10 (see the module docstring) → its numbers for the kernels
    line."""
    import torch

    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.evaluation.policy_id import PolicyID
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs
    from policy_server_tpu_torch.telemetry import flightrec

    old_specs = flagship_policy_specs()
    new_specs = changed_specs(old_specs)
    changed = "trusted-repos"
    removed = "baseline-canary"
    work_dir = os.path.join(REPO, "build", "chip_smoke_audit")
    os.makedirs(work_dir, exist_ok=True)
    policies_path = os.path.join(work_dir, "policies.json")
    old_bytes = json.dumps(old_specs).encode()
    with open(policies_path, "wb") as f:
        f.write(old_bytes)
    objects = audit_inventory(AUDIT_OBJECTS, seed=10)
    resources_path = os.path.join(work_dir, "resources.json")
    with open(resources_path, "w") as f:
        json.dump({"items": objects}, f)
    old = EvaluationEnvironmentBuilder(backend="oracle").build(parse_policies(old_specs))
    new = EvaluationEnvironmentBuilder(backend="oracle").build(parse_policies(new_specs))
    old_ids, new_ids = sorted(old_specs), sorted(new_specs)

    def expect(oracle, wave):
        return [expected_answer(oracle, pid, body) for pid, body in wave]

    args = build_cli().parse_args([
        "--policies", policies_path, "--addr", "127.0.0.1", "--port", "0",
        "--readiness-probe-port", "0", "--frontend", "native",
        "--enable-metrics", "--reload-admin-token", RELOAD_TOKEN,
        "--audit-mode", "interval", "--audit-interval-seconds", "1",
        "--audit-matrix", "--audit-matrix-whatif",
        "--audit-resources-file", resources_path,
    ])
    mem_before = device_memory()
    ck.reset_launch_counts()
    t_build = time.perf_counter()
    server = server_from_args(args)
    out: dict = {"build_s": time.perf_counter() - t_build,
                 "boot_launches": ck.launch_counts()}
    scanner, matrix, lc = server.state.audit, server.state.audit_matrix, server.lifecycle
    rp = server.readiness_port
    snap = scanner.snapshot.stats()
    if snap["resources"] != AUDIT_OBJECTS or snap["evicted"]:
        fail(f"phase10 seeded {snap} from {AUDIT_OBJECTS} objects")
    out["snapshot"] = snap
    out["memory"] = []
    cache_old: dict = {}
    stream_proc = None
    stop_path = os.path.join(work_dir, "stream.stop")
    stream_out = os.path.join(work_dir, "stream.jsonl")
    if os.path.exists(stop_path):
        os.unlink(stop_path)
    stopped = False
    try:
        # B: the boot sweep under a live wave
        rec = flightrec.recorder()
        cursor = rec.events_recorded()
        env = server.env
        launches0 = ck.launch_counts()
        b0 = server.batcher.stats_snapshot()
        env0 = (env.oracle_fallbacks, env.breaker_stats.get("short_circuited_requests", 0),
                env.device_errors)
        unique0 = env.host_profile["dispatched_rows"]
        wave = wave_of(work_docs, AUDIT_LIVE_WAVE, "r10b")
        lane_times = AuditLaneTimes(server.batcher)
        t0 = time.perf_counter()
        server.start()
        proc, res_path = start_client(server.port, wave, "audit-b")
        wait_until(lambda: scanner.stats()["full_sweeps"] >= 1, 900, "the boot sweep")
        boot_s = time.perf_counter() - t0
        launches1 = ck.launch_counts()
        b1 = server.batcher.stats_snapshot()
        ex = recorder_executes(rec, cursor)
        boot_parts = lane_times.since(rec, cursor, 0, boot_s)
        live = check_wave("phase10 wave B", finish_client(proc, res_path, "wave B"),
                          wave, [expect(old, wave)])
        env1 = (env.oracle_fallbacks, env.breaker_stats.get("short_circuited_requests", 0),
                env.device_errors)
        unique = env.host_profile["dispatched_rows"] - unique0
        audit_batches = b1["audit_batches_dispatched"] - b0["audit_batches_dispatched"]
        k1 = launches1["policy_matrix"] - launches0["policy_matrix"]
        if ex["wrapped"]:
            fail("phase10: the flight recorder ring wrapped during the boot sweep")
        if k1 != ex["audit_launches"] + ex["live_launches"]:
            fail(f"phase10: {k1} K1 launches in the boot sweep, "
                 f"{ex['audit_launches']} + {ex['live_launches']} fetched")
        if ex["audit_launches"] < audit_batches or audit_batches < 1:
            fail(f"phase10: {audit_batches} audit batches, {ex['audit_launches']} K1 launches")
        if env1 != env0:
            fail(f"phase10: host fallbacks, breaker short-circuits or device "
                 f"errors during the boot sweep: {env0} -> {env1}")
        sstats = scanner.stats()
        out["B"] = {
            "boot_sweep_s": boot_s, "rows_scanned": sstats["rows_scanned"],
            "audit_batches": audit_batches,
            "lane_rows": b1["audit_rows_dispatched"] - b0["audit_rows_dispatched"],
            "unique_rows": unique,
            "preemptions": b1["audit_preemptions"] - b0["audit_preemptions"],
            "k1_launches": k1, **ex,
            "launches_per_audit_batch": ex["audit_launches"] / audit_batches,
            "live": live,
            "attribution": boot_parts,
        }
        out["memory"].append(("after the boot sweep", device_memory()))
        # the same wave again after the sweep, both tiers of the verdict
        # cache cleared so it meets the cold cache the first did
        env._verdict_cache.clear()
        env._blob_cache.clear()
        wave2 = retag(wave, "again")
        out["B"]["live_after"] = check_wave(
            "phase10 wave B again", client_wave(server.port, wave2, "audit-b2"),
            wave2, [expect(old, wave2)])
        # a second full sweep under the same epoch, after every live request:
        # the allocation stays flat, and the signature policies' verdicts
        # (their pre-eval hooks, which the audit lane does not run, verify
        # the images of the live requests addressed to them, on the server
        # as on the oracle) are judged with the same verified images the
        # oracle holds
        f = scanner.stats()["full_sweeps"]
        settle(scanner, "the dirty sweep of wave B's objects")
        cursor, first_job = rec.events_recorded(), len(lane_times.jobs)
        t1 = time.perf_counter()
        scanner.request_full_sweep("chip smoke memory check")
        wait_until(lambda: scanner.stats()["full_sweeps"] > f, 900, "the second full sweep")
        out["B"]["second_sweep_s"] = time.perf_counter() - t1
        out["B"]["second_attribution"] = lane_times.since(
            rec, cursor, first_job, out["B"]["second_sweep_s"]
        )

        out["memory"].append(("after a second full sweep", device_memory()))
        grown = out["memory"][1][1] - out["memory"][0][1]
        if abs(grown) > RELOAD_MEMORY_SLACK:
            fail(f"phase10: memory_allocated moved {grown} B between full sweeps")
        settle(scanner, "the dirty sweep of wave B's objects")
        out["B"]["summary"] = check_reports(
            "wave B reports", rp, scanner, old, old_ids, cache_old, 0, card)
        print(f"phase10 progress, wave B: {json.dumps(out['B'])} [{card}]")

        # M: lookup admission
        wave = update_wave(work_docs, AUDIT_UPDATE_WAVE, "m1")
        out["M"] = {"first": check_wave(
            "phase10 wave M first", client_wave(server.port, wave, "audit-m1"),
            wave, [expect(old, wave)])}
        settle(scanner, "the dirty sweep of wave M's objects")
        env = server.env

        def gates(pid: str) -> tuple[bool, bool]:
            """(hookless, fragment-eligible): the batcher asks the matrix
            only for a hookless target, and a hit needs the fragment lane's
            proof."""
            target = env._lookup_top_level(PolicyID.parse(pid))
            return not env._hooks_of(target), env._frag_eligible(target)

        n_asked = sum(gates(pid)[0] for pid, _b in wave)
        n_eligible = sum(all(gates(pid)) for pid, _b in wave)
        hits0 = metric_value(rp, "policy_server_audit_matrix_lookup_hits_total")
        misses0 = metric_value(rp, "policy_server_audit_matrix_lookup_misses_total")
        b0 = server.batcher.stats_snapshot()
        cursor = rec.events_recorded()
        wave2 = retag(wave, "m2")
        out["M"]["again"] = check_wave(
            "phase10 wave M again", client_wave(server.port, wave2, "audit-m2"),
            wave2, [expect(old, wave2)])
        ex = recorder_executes(rec, cursor)
        b1 = server.batcher.stats_snapshot()
        hits = metric_value(rp, "policy_server_audit_matrix_lookup_hits_total") - hits0
        misses = metric_value(rp, "policy_server_audit_matrix_lookup_misses_total") - misses0
        dispatched = b1["requests_dispatched"] - b0["requests_dispatched"]
        if hits != n_eligible or misses != n_asked - n_eligible:
            fail(f"phase10 wave M: {hits} lookup hits and {misses} misses; "
                 f"{n_asked} of {len(wave)} pairs hookless, {n_eligible} of "
                 f"them frag-eligible")
        if dispatched != len(wave) - n_eligible or ex["live_rows"] > dispatched:
            fail(f"phase10 wave M: {dispatched} rows reached the batcher and "
                 f"K1 served {ex['live_rows']}, {len(wave) - n_eligible} ineligible")
        out["M"].update(eligible=n_eligible, asked=n_asked, hits=hits, misses=misses,
                        dispatched=dispatched, serving_k1=ex["live_launches"],
                        serving_k1_rows=ex["live_rows"])
        print(f"phase10 progress, wave M: {json.dumps(out['M'])} [{card}]")

        # P: the promotion, with the what-if and a stream client
        settle(scanner, "a quiet scanner")
        cells0 = matrix.stats()["cells_resident"]
        # the readiness port: the native frontend's API port answers only
        # the evaluation POSTs
        stream_proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--stream-client",
             str(rp), "0", stream_out, stop_path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

        def streamed(pred) -> bool:
            if stream_proc.poll() is not None:
                fail(f"the stream client exited: {stream_proc.stderr.read()[-2000:]}")
            return pred(read_progress(stream_out))

        wait_until(lambda: streamed(lambda p: p["entries"] >= 1 + cells0),
                   300, "the stream client's resync")
        v_before = matrix.version
        rows = scanner.snapshot.rows_snapshot()
        keys = [k for k, _r in rows]
        want_new = oracle_verdicts(new, rows, new_ids, {})
        old_now = oracle_verdicts(old, rows, old_ids, cache_old)
        head_flips = sum(
            old_now[k, changed][0] != want_new[k, changed][0]
            for k, _r in rows[:AUDIT_WHATIF_ROWS]
        )
        m0 = matrix.stats()
        f_sweeps = scanner.stats()["full_sweeps"]
        # the POST alone triggers the promotion: the changed set is on disk
        # only inside that reload (written at its fetch stage, the old
        # bytes back at its compile stage), so the file watch's 1 s poll
        # never lands a trigger of its own (a poll during the reload finds
        # one in flight and keeps its baseline, the old bytes' digest)
        def write_changed_file() -> None:
            with open(policies_path, "w") as f:
                json.dump(new_specs, f)

        def restore_policies_file() -> None:
            with open(policies_path, "wb") as f:
                f.write(old_bytes)

        reloads0 = lc.stats()["reloads"]
        failpoints.set_failpoint("reload.fetch", write_changed_file, count=1)
        failpoints.set_failpoint("reload.compile", restore_policies_file, count=1)
        status, body = admin_post(rp, "/policies/reload")
        if (status, body.get("status")) != (202, "reload started"):
            fail(f"POST /policies/reload answered {status} {body}")
        wait_until(lambda: lc.stats()["reloads"] > reloads0
                   and not lc.reload_in_flight(), 300, "the promotion")
        failpoints.reset()
        whatif = lc.stats()["whatif"]
        if whatif is None or whatif["columns_changed"] != [changed]:
            fail(f"phase10: the what-if names {whatif and whatif['columns_changed']}")
        if (whatif["rows_evaluated"], whatif["verdict_flips"]) != (
            min(AUDIT_WHATIF_ROWS, len(rows)),
            min(AUDIT_WHATIF_FLIP_SAMPLE, head_flips),
        ):
            fail(f"phase10: the what-if evaluated {whatif['rows_evaluated']} "
                 f"rows with {whatif['verdict_flips']} flips; the oracle "
                 f"flips {head_flips} of the first {AUDIT_WHATIF_ROWS}")
        # the hook's dirty sweep notes its column rows when it starts
        wait_until(lambda: matrix.stats()["column_sweep_rows"] > m0["column_sweep_rows"],
                   600, "the dirty-column sweep")
        settle(scanner, "the dirty-column sweep")
        m1 = matrix.stats()
        column_rows = m1["column_sweep_rows"] - m0["column_sweep_rows"]
        if column_rows != len(rows) or scanner.stats()["full_sweeps"] != f_sweeps:
            fail(f"phase10: the promotion's sweep judged {column_rows} column "
                 f"rows of {len(rows)} (full sweeps {f_sweeps} -> "
                 f"{scanner.stats()['full_sweeps']})")
        v_after_p = matrix.version
        wait_until(lambda: streamed(lambda p: p["last_version"] == matrix.version),
                   300, "the stream client after the promotion")
        # a column whose policy content is unchanged keeps its cells (re-
        # stamped, not re-judged): the old set's verdicts, the changed
        # column the new set's
        want_view = {
            (k, p): (want_new if p == changed else old_now)[k, p][0]
            for k in keys for p in new_ids
        }
        got_cells = {k: v[0] for k, v in matrix.cells_snapshot().items()}
        if got_cells != want_view:
            bad = [k for k in set(got_cells) | set(want_view)
                   if got_cells.get(k) != want_view.get(k)]
            fail(f"phase10: {len(bad)} matrix cells after the promotion are "
                 f"not the oracle's (first {bad[0]}: "
                 f"{got_cells.get(bad[0])} against {want_view.get(bad[0])})")
        st = replay_stream(read_stream(stream_out))
        if st["view"] != want_view:
            fail("phase10: the stream client's view after the promotion is not "
                 "the oracle's")
        p_deltas = [e for e in st["deltas"] if v_before < e["matrixVersion"] <= v_after_p]
        # a verdict change is one of allowed, code or message (the matrix
        # emits on any of them)
        def verdict(v: tuple) -> tuple:
            return v[0], v[3], v[2]

        flips_new = {(k, changed) + verdict(want_new[k, changed]) for k in keys
                     if verdict(want_new[k, changed]) != verdict(old_now[k, changed])}
        resynced_p = any(v > v_before for v in st["resyncs"])
        exact_p = None
        if not resynced_p:
            got_v = {(e["resource"], e["policy"], e["allowed"], e["code"],
                      e["message"]) for e in p_deltas if e["type"] == "VERDICT"}
            got_d = {(e["resource"], e["policy"]) for e in p_deltas
                     if e["type"] == "DELETE"}
            exact_p = got_v == flips_new and got_d == {(k, removed) for k in keys}
            if not exact_p:
                fail(f"phase10: the promotion's stream deltas are not the "
                     f"oracle's verdict changes: {len(got_v)} verdicts "
                     f"({len(got_v - flips_new)} not the oracle's, "
                     f"{len(flips_new - got_v)} missing), {len(got_d)} "
                     f"deletes of {len(keys)} rows")
        out["P"] = {
            "whatif": {k: whatif[k] for k in ("columns_changed", "rows_evaluated",
                                              "verdict_flips")},
            "oracle_head_flips": head_flips, "column_rows": column_rows,
            "oracle_changes": len(flips_new),
            "oracle_flips": sum(
                want_new[k, changed][0] != old_now[k, changed][0] for k in keys
            ), "matrix_version": [v_before, v_after_p],
            "stream": {k: st[k] if not isinstance(st[k], list) else len(st[k])
                       for k in ("resyncs", "overflows", "reconnects")},
            "deltas": len(p_deltas), "deltas_exact": exact_p,
            "stages_s": dict(lc.last_stage_seconds),
        }
        print(f"phase10 progress, wave P: {json.dumps(out['P'])} [{card}]")

        # R: the rollback, of exactly one promotion (a file-watch reload
        # beside the POST's would make it roll back to epoch 1)
        if (lc.stats()["reloads"], lc.current_epoch) != (reloads0 + 1, 1):
            fail(f"phase10: {lc.stats()['reloads'] - reloads0} reloads "
                 f"promoted before the rollback, epoch {lc.current_epoch}; "
                 "exactly one promotion was triggered")
        reports = scanner.reports.payload()["reports"]
        promoted = sum(1 for r in reports if r["epoch"] == 1)
        del reports
        f_sweeps = scanner.stats()["full_sweeps"]
        with scanner._sweep_lock:
            status, body = admin_post(rp, "/policies/rollback")
            stale = scanner.reports.stats()["stale"]
        if (status, body) != (200, {"status": "rolled-back", "epoch": 0}):
            fail(f"POST /policies/rollback answered {status} {body}")
        if stale != promoted or not promoted:
            fail(f"phase10: {stale} rows marked stale, the promoted epoch wrote {promoted}")
        wait_until(lambda: scanner.stats()["full_sweeps"] > f_sweeps, 900,
                   "the full sweep after the rollback")
        out["memory"].append(("after the rollback's full sweep (the rolled-back "
                              "epoch's environment stays pinned)", device_memory()))
        settle(scanner, "no dirty row")
        out["R"] = {"stale": stale, "summary": check_reports(
            "wave R reports", rp, scanner, old, old_ids, cache_old, 0, card)}
        v_after_r = matrix.version
        wait_until(lambda: streamed(lambda p: p["last_version"] == matrix.version),
                   300, "the stream client after the rollback")
        st = replay_stream(read_stream(stream_out))
        want_old = {(k, p): old_now[k, p][0] for k in keys for p in old_ids}
        if st["view"] != want_old:
            fail("phase10: the stream client's view after the rollback is not "
                 "the old set's oracle")
        r_deltas = [e for e in st["deltas"] if v_after_p < e["matrixVersion"] <= v_after_r]
        resynced_r = any(v > v_after_p for v in st["resyncs"])
        exact_r = None
        if not resynced_r:
            got_v = {(e["resource"], e["policy"], e["allowed"], e["code"],
                      e["message"]) for e in r_deltas}
            want_v = {(k, changed) + verdict(old_now[k, changed]) for k in keys
                      if verdict(want_new[k, changed]) != verdict(old_now[k, changed])}
            want_v |= {(k, removed) + verdict(old_now[k, removed]) for k in keys}
            exact_r = got_v == want_v and all(e["type"] == "VERDICT" for e in r_deltas)
            if not exact_r:
                fail("phase10: the rollback's stream deltas are not the flips back")
        out["R"].update(deltas=len(r_deltas), deltas_exact=exact_r,
                        matrix_version=v_after_r,
                        stream={k: st[k] if not isinstance(st[k], list) else len(st[k])
                                for k in ("resyncs", "overflows", "reconnects")})
        # a reconnect with a cursor the ring still covers replays exactly
        # the entries after it
        cursor_v = v_after_r - AUDIT_RESUME_ENTRIES
        replay = stream_entries(rp, cursor_v, AUDIT_RESUME_ENTRIES)
        seen = {e["matrixVersion"]: e for e in st["deltas"]
                if e["matrixVersion"] > cursor_v}
        if [e["matrixVersion"] for e in replay] != list(
            range(cursor_v + 1, v_after_r + 1)
        ) or any(seen.get(e["matrixVersion"], e) != e for e in replay):
            fail("phase10: a reconnect at a covered cursor did not replay "
                 "exactly the missed entries")
        out["R"]["resume"] = {"cursor": cursor_v, "replayed": len(replay)}
        print(f"phase10 progress, wave R: {json.dumps(out['R'])} [{card}]")
        out["scanner"] = scanner.stats()
        out["matrix"] = matrix.stats()
        open(stop_path, "w").close()
        _o, err = stream_proc.communicate(timeout=60)
        if stream_proc.returncode != 0:
            fail(f"the stream client failed: {err[-2000:]}")
        stream_proc = None
        server.stop()
        stopped = True
    finally:
        failpoints.reset()
        if stream_proc is not None:
            stream_proc.kill()
            stream_proc.wait(30)
        if not stopped:
            server.stop()
    join_retirements()
    out["launches"] = ck.launch_counts()
    out["memory_after_stop"] = device_memory() - mem_before
    if abs(out["memory_after_stop"]) > RELOAD_MEMORY_SLACK:
        fail(f"phase10: {out['memory_after_stop']} B still allocated after the stop")
    if out["launches"]["policy_matrix"] < 1 or out["launches"]["probe"] < 1:
        fail(f"phase 10 did not launch both kernels: {out['launches']}")
    out["holds"] = hold_inventory_against_plain(objects, card)
    out["k1_err"] = max(r["max_abs_err"] for r in out["holds"].values())
    return out


def stream_entries(port: int, cursor: int, n: int) -> list:
    """The first ``n`` entries GET /audit/stream?cursor= gives."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", f"/audit/stream?cursor={cursor}")
        resp = conn.getresponse()
        if resp.status != 200:
            fail(f"/audit/stream?cursor={cursor} answered {resp.status}")
        out = []
        while len(out) < n:
            line = resp.readline()
            if not line:
                break
            if line.strip():
                out.append(json.loads(line))
        return out
    finally:
        conn.close()


def print_audit_phase(r10: dict, card: str) -> None:
    b = r10["B"]
    print(
        f"phase10 server build {r10['build_s']:.3f} s (launches "
        f"{json.dumps(r10['boot_launches'])}); snapshot "
        f"{json.dumps(r10['snapshot'])} ({r10['snapshot']['bytes'] / max(1, r10['snapshot']['resources']):.1f} B per object) [{card}]"
    )
    print(
        f"phase10 wave B: boot sweep {b['boot_sweep_s']:.3f} s from start(): "
        f"{b['rows_scanned']} rows in {b['audit_batches']} audit batches "
        f"({b['lane_rows']} pairs), {b['preemptions']} preemptions; "
        f"{b['k1_launches']} policy_matrix launches in the window, "
        f"{b['audit_launches']} by the audit lane answering {b['audit_pairs']} "
        f"pairs ({b['launches_per_audit_batch']:.3f} launches per audit batch), "
        f"{b['live_launches']} by live batches; {b['unique_rows']} unique rows "
        f"copied to the card in the window (audit and live); a second full sweep "
        f"{b['second_sweep_s']:.3f} s [{card}]"
    )
    for name, att in (("boot sweep, under the live wave", b["attribution"]),
                      ("second full sweep, quiet", b["second_attribution"])):
        print(f"phase10 attribution of the {name}: {json.dumps(att)} [{card}]")
    for name, w in (("during the boot sweep", b["live"]),
                    ("after it (verdict cache cleared)", b["live_after"])):
        print(
            f"phase10 wave B live /validate {name}: {w['answered']} answered, "
            f"every body the oracle's, p50 {w['p50']:.3f} ms p99 {w['p99']:.3f} ms "
            f"[{card}]"
        )
    m = r10["M"]
    print(
        f"phase10 wave M: {m['first']['answered']} UPDATEs, then again with fresh "
        f"uids (p50 {m['again']['p50']:.3f} ms p99 {m['again']['p99']:.3f} ms): "
        f"lookup hits +{m['hits']:.0f} = the {m['eligible']} frag-eligible pairs, "
        f"misses +{m['misses']:.0f} (the matrix is asked for the {m['asked']} "
        f"pairs of hookless targets); {m['dispatched']} rows reached the batcher, "
        f"K1 served {m['serving_k1_rows']} of them in {m['serving_k1']} launches "
        f"[{card}]"
    )
    p = r10["P"]
    print(
        f"phase10 wave P: what-if {json.dumps(p['whatif'])} (oracle flips in "
        f"the first {AUDIT_WHATIF_ROWS} rows: {p['oracle_head_flips']}); dirty-"
        f"column sweep {p['column_rows']} rows; {p['oracle_flips']} verdicts "
        f"flip and {p['oracle_changes']} change (allowed, code or message) "
        f"in the snapshot; stream {json.dumps(p['stream'])}, "
        f"{p['deltas']} deltas, exact {p['deltas_exact']}; stage seconds "
        f"{json.dumps(p['stages_s'])} [{card}]"
    )
    r = r10["R"]
    print(
        f"phase10 wave R: {r['stale']} rows stale after the rollback; stream "
        f"{json.dumps(r['stream'])}, {r['deltas']} deltas, exact "
        f"{r['deltas_exact']}; resume at cursor {r['resume']['cursor']} "
        f"replayed {r['resume']['replayed']} entries exactly [{card}]"
    )
    for label, mem in r10["memory"]:
        print(f"phase10 memory_allocated {label}: {mem} B [{card}]")
    print(
        f"phase10 memory_allocated after the stop: {r10['memory_after_stop']} B "
        f"beyond the phase's start; launches {json.dumps(r10['launches'])}; "
        f"scanner {json.dumps({k: v for k, v in r10['scanner'].items() if k != 'rows_scanned_by_epoch'})}; "
        f"matrix {json.dumps(r10['matrix'])} [{card}]"
    )


# -- phase 11: TLS, rotation and the prefork workers ---------------------------


def make_identity(cn: str, issuer=None, is_ca: bool = False):
    """(key, certificate) from ``cryptography``: self-signed, or signed by
    ``issuer`` = (key, certificate); a new random serial each call."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    issuer_key, issuer_cert = issuer if issuer is not None else (key, None)
    now = datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)
    cert = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(issuer_cert.subject if issuer_cert is not None else subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(
            x509.BasicConstraints(ca=is_ca, path_length=None), critical=True
        )
        .sign(issuer_key, hashes.SHA256())
    )
    return key, cert


def write_pem(path: str, key=None, cert=None) -> None:
    from cryptography.hazmat.primitives import serialization

    if cert is not None:
        data = cert.public_bytes(serialization.Encoding.PEM)
    else:
        data = key.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )
    with open(path, "wb") as f:
        f.write(data)


def tls_connect(port: int, cert: str | None = None, key: str | None = None):
    """A TLS socket to the API port (any server trusted), presenting the
    client certificate when given one."""
    import socket
    import ssl

    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    if cert:
        ctx.load_cert_chain(cert, key)
    return ctx.wrap_socket(
        socket.create_connection(("127.0.0.1", port), timeout=30)
    )


def served_serial(port: int, cert: str, key: str) -> int:
    """The serial of the certificate a new connection is served."""
    from cryptography import x509

    s = tls_connect(port, cert, key)
    try:
        return x509.load_der_x509_certificate(
            s.getpeercert(binary_form=True)
        ).serial_number
    finally:
        s.close()


def refused(port: int, cert: str | None = None, key: str | None = None) -> bool:
    """True when the server serves no HTTP to this client: the handshake
    ends in an alert or a bare close."""
    import ssl

    try:
        s = tls_connect(port, cert, key)
        s.settimeout(10)
        s.sendall(b"GET / HTTP/1.1\r\nHost: smoke\r\n\r\n")
        data = s.recv(1000)
        s.close()
        return data == b""
    except (OSError, ssl.SSLError):
        return True


def keepalive_answer(sock, pid: str, body: bytes) -> tuple[int, bytes]:
    """One POST on a kept-alive socket → (status, body)."""
    sock.sendall(
        f"POST /validate/{pid} HTTP/1.1\r\nHost: smoke\r\n"
        f"Content-Length: {len(body)}\r\n\r\n".encode() + body
    )
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(65536)
        if not chunk:
            fail("the server closed a kept-alive connection")
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    n = 0
    for ln in head.split(b"\r\n")[1:]:
        if ln[:15].lower() == b"content-length:":
            n = int(ln[15:])
    while len(rest) < n:
        rest += sock.recv(65536)
    return int(head[9:12]), rest[:n]


def tls_prefork_phase(work_docs: list, phase7: dict, card: str) -> dict:
    """Phase 11 (see the module docstring) → its numbers for the kernels
    line."""
    import signal

    import torch

    try:
        import cryptography  # noqa: F401 — the certificates are made with it
    except ImportError:
        fail("phase 11 needs the cryptography package for its certificates")
    from cryptography import x509

    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.certs import WATCH_INTERVAL_SECONDS
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    work_dir = os.path.join(REPO, "build", "chip_smoke_tls")
    os.makedirs(work_dir, exist_ok=True)
    specs = flagship_policy_specs()
    policies_path = os.path.join(work_dir, "policies.json")
    with open(policies_path, "w") as f:
        json.dump(specs, f)
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        parse_policies(specs)
    )
    pem = {n: os.path.join(work_dir, f"{n}.pem") for n in (
        "cert", "key", "ca", "good_cert", "good_key", "bad_cert", "bad_key",
    )}
    server_id = make_identity("original")
    ca = make_identity("client-ca", is_ca=True)
    good = make_identity("good-client", issuer=ca)
    bad = make_identity("bad-client", issuer=make_identity("other-ca", is_ca=True))
    write_pem(pem["cert"], cert=server_id[1])
    write_pem(pem["key"], key=server_id[0])
    write_pem(pem["ca"], cert=ca[1])
    write_pem(pem["good_cert"], cert=good[1])
    write_pem(pem["good_key"], key=good[0])
    write_pem(pem["bad_cert"], cert=bad[1])
    write_pem(pem["bad_key"], key=bad[0])
    good_tls = f"tls={pem['good_cert']},{pem['good_key']}"
    kernel_flags = ["--host-fastpath-threshold", "0", "--verdict-cache-size",
                    "0", "--latency-budget-ms", "0"]
    # the workers log at warn: a span line per request would bury the
    # phase's own lines
    base = ["--policies", policies_path, "--addr", "127.0.0.1", "--port", "0",
            "--readiness-probe-port", "0", "--enable-metrics",
            "--log-level", "warn", *kernel_flags]
    tls_flags = ["--cert-file", pem["cert"], "--key-file", pem["key"],
                 "--client-ca-file", pem["ca"]]
    out: dict = {"launches": {"policy_matrix": 0, "probe": 0}}

    def expect(wave):
        return [expected_answer(oracle, pid, body) for pid, body in wave]

    def build(extra: list):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        server = server_from_args(build_cli().parse_args(base + extra))
        server.start()
        return server, ck.launch_counts()

    def finish(server, boot: dict, label: str) -> dict:
        """Stop the server → its launches after the build; added to the
        phase's."""
        server.stop()
        torch.cuda.synchronize()
        got = ck.launch_counts()
        for k in out["launches"]:
            out["launches"][k] += got[k]
        serving = got["policy_matrix"] - boot["policy_matrix"]
        if got["probe"] < 1:
            fail(f"{label}: the environment's build launched no probe")
        if serving < 1:
            fail(f"{label}: no policy_matrix launch served its traffic")
        return {"serving_launches": serving, "probe": got["probe"]}

    def run_wave(port: int, wave: list, name: str, label: str, tls=None,
                 conns: int = NATIVE_CONNS, depth: int = NATIVE_DEPTH) -> dict:
        proc, path = start_client(port, wave, name, tls=tls, conns=conns,
                                  depth=depth, work_dir=work_dir)
        results, wall = finish_run(proc, path, label)
        r = check_wave(label, results, wave, [expect(wave)])
        r["req_s"] = len(wave) / wall
        return r

    # -- wave L: native TLS with mTLS --------------------------------------
    server, boot = build(["--frontend", "native", *tls_flags])
    rp = server.readiness_port
    try:
        if server.state.native_tls is None:
            fail("TLS does not terminate on the native loops")
        if metric_value(rp, "policy_server_tls_native_termination") != 1.0:
            fail("policy_server_tls_native_termination is not 1")
        ok0 = metric_value(rp, "policy_server_tls_handshakes_ok_total")
        l_wave = wave_of(work_docs, N_REQUESTS, "l11")
        k0 = ck.launch_counts()["policy_matrix"]
        out["L"] = run_wave(server.port, l_wave, "l", "wave L", tls=good_tls)
        out["L"]["launches"] = ck.launch_counts()["policy_matrix"] - k0
        if out["L"]["launches"] < 1:
            fail("wave L launched no policy_matrix")
        ok1 = metric_value(rp, "policy_server_tls_handshakes_ok_total")
        if ok1 - ok0 != NATIVE_CONNS:
            fail(f"wave L: {ok1 - ok0} handshakes for {NATIVE_CONNS} connections")
        failed0 = metric_value(rp, "policy_server_tls_handshakes_failed_total")
        refusals = []
        for who, cert, key in (("no certificate", None, None),
                               ("another CA", pem["bad_cert"], pem["bad_key"])):
            if not refused(server.port, cert, key):
                fail(f"a client with {who} was served")
            time.sleep(0.2)
            refusals.append(
                metric_value(rp, "policy_server_tls_handshakes_failed_total") - failed0
            )
        if refusals != [1.0, 2.0]:
            fail(f"each refusal did not count once in handshakes_failed: {refusals}")
        out["L"]["handshakes_ok"] = ok1 - ok0
        out["L"]["refusals"] = refusals

        # -- wave R: rotation under load -----------------------------------
        reloads0 = metric_value(rp, "policy_server_tls_reloads_total")
        gens0 = metric_value(rp, "policy_server_tls_generations_total")
        old_serial = server_id[1].serial_number
        established = tls_connect(server.port, pem["good_cert"], pem["good_key"])
        e_pid, e_body = wave_of(work_docs, 1, "r11e")[0]
        if keepalive_answer(established, e_pid, e_body) != expected_answer(
            oracle, e_pid, e_body
        ):
            fail("wave R: the established connection's first answer")
        # the load: client processes, one wave after another, until the
        # rotation's checks are done (fail() would only end this thread,
        # so its errors are kept for the check below)
        # each wave's start (its client process started) and end (its
        # results read) on this clock; r_live is the wave in flight
        r_stop = threading.Event()
        r_runs: list = []
        r_errors: list = []
        r_live: dict = {}

        def r_traffic() -> None:
            n = 0
            try:
                while not r_stop.is_set():
                    wave = wave_of(work_docs, N_REQUESTS, f"r11-{n}")
                    started = time.perf_counter()
                    proc, path = start_client(
                        server.port, wave, f"r{n}", tls=good_tls, conns=8,
                        depth=2, work_dir=work_dir,
                    )
                    r_live.update(index=n, started=started,
                                  requests=server.native_frontend.stats()[
                                      "http_requests"])
                    _o, err = proc.communicate(timeout=300)
                    if proc.returncode != 0:
                        r_errors.append(err[-2000:])
                        return
                    with open(path) as f:
                        doc = json.load(f)
                    os.unlink(path)
                    r_runs.append((wave, doc["results"], sum(doc["walls"]),
                                   started, time.perf_counter()))
                    r_live.clear()
                    n += 1
            except BaseException as e:  # noqa: BLE001 — checked below
                r_errors.append(repr(e))

        def r_in_flight() -> bool:
            # a wave whose client has reached the server and not finished
            if r_errors:
                fail(f"wave R's load: {r_errors}")
            live = dict(r_live)
            return bool(live) and (
                server.native_frontend.stats()["http_requests"]
                > live["requests"]
            )

        r_thread = threading.Thread(target=r_traffic, daemon=True)
        r_thread.start()
        wait_until(r_in_flight, 120, "wave R's first client wave")
        new_key, new_cert = make_identity("rotated")
        t_half = time.perf_counter()
        write_pem(pem["cert"], cert=new_cert)  # half a rotation: cert only
        time.sleep(WATCH_INTERVAL_SECONDS + 0.5)
        half = (
            metric_value(rp, "policy_server_tls_reloads_total") == reloads0
            and metric_value(rp, "policy_server_tls_generations_total") == gens0
            and served_serial(server.port, pem["good_cert"], pem["good_key"])
            == old_serial
        )
        if not half:
            fail("wave R: a half-written rotation changed the identity")
        write_pem(pem["key"], key=new_key)
        t_rot = time.perf_counter()
        while served_serial(
            server.port, pem["good_cert"], pem["good_key"]
        ) != new_cert.serial_number:
            if time.perf_counter() - t_rot > WATCH_INTERVAL_SECONDS + 1.0:
                fail("wave R: new connections did not see the new serial in time")
            time.sleep(0.05)
        t_seen = time.perf_counter()
        rotation_s = t_seen - t_rot
        if keepalive_answer(established, e_pid, e_body) != expected_answer(
            oracle, e_pid, e_body
        ):
            fail("wave R: the established connection stopped being answered")
        if x509.load_der_x509_certificate(
            established.getpeercert(binary_form=True)
        ).serial_number != old_serial:
            fail("wave R: the established connection changed identity")
        established.close()
        d_reloads = metric_value(rp, "policy_server_tls_reloads_total") - reloads0
        d_gens = metric_value(rp, "policy_server_tls_generations_total") - gens0
        if (d_reloads, d_gens) != (1.0, 1.0):
            fail(f"wave R: reloads +{d_reloads}, generations +{d_gens}, not +1 each")
        # a corrupt PEM (SIGHUP's forced reload): the last good identity
        # keeps serving, one failure counted
        fail0 = metric_value(rp, "policy_server_tls_reload_failures_total")
        with open(pem["cert"], "w") as f:
            f.write("-----NOT A CERT-----\n")
        server.reload_signal()
        wait_until(
            lambda: metric_value(rp, "policy_server_tls_reload_failures_total") > fail0,
            10, "the corrupt PEM's reload failure",
        )
        time.sleep(WATCH_INTERVAL_SECONDS + 0.5)
        d_fail = metric_value(rp, "policy_server_tls_reload_failures_total") - fail0
        if d_fail != 1.0:
            fail(f"wave R: the corrupt PEM counted {d_fail} failures, not 1")
        if served_serial(server.port, pem["good_cert"], pem["good_key"]) != (
            new_cert.serial_number
        ):
            fail("wave R: the corrupt PEM replaced the last good identity")
        expiry = metric_value(rp, "policy_server_tls_cert_expiry_seconds")
        not_after = getattr(new_cert, "not_valid_after_utc", None)
        if not_after is None:  # cryptography before 42
            import datetime

            not_after = new_cert.not_valid_after.replace(
                tzinfo=datetime.timezone.utc
            )
        if abs((not_after.timestamp() - time.time()) - expiry) > 5:
            fail(f"wave R: the expiry gauge {expiry} is not the serving notAfter")
        # the load spans the rotation: a wave was in flight when the half
        # rotation's cert was written, and a wave ended after the new
        # serial was seen; the thread goes on until two waves are done
        wait_until(
            lambda: bool(r_errors) or (
                len(r_runs) >= 2 and any(end > t_seen for *_x, end in r_runs)
            ), 600, "wave R's client waves past the rotation",
        )
        r_stop.set()
        r_thread.join(600)
        if r_errors or len(r_runs) < 2:
            fail(f"wave R's load: {len(r_runs)} waves, errors {r_errors}")
        if not any(start <= t_half <= end for *_x, start, end in r_runs):
            fail("wave R: no client wave was in flight when the half "
                 "rotation's cert was written")
        r_wave = [item for wave, *_x in r_runs for item in wave]
        out["R"] = check_wave(
            "wave R", [x for _w, res, *_x in r_runs for x in res], r_wave,
            [expect(r_wave)],
        )
        out["R"].update(
            req_s=len(r_wave) / sum(t for _w, _r, t, *_x in r_runs),
            waves=len(r_runs), rotation_s=rotation_s,
            reloads=d_reloads, generations=d_gens, reload_failures=d_fail,
            expiry_s=expiry,
        )
        with open(pem["cert"], "wb") as f:  # the last good pair on disk again
            from cryptography.hazmat.primitives import serialization

            f.write(new_cert.public_bytes(serialization.Encoding.PEM))
    finally:
        out["L_launches"] = finish(server, boot, "wave L")

    # -- wave S: TLS on the standard-library frontend --------------------
    server, boot = build(["--frontend", "python", *tls_flags])
    try:
        if server.frontend != "python" or server.state.native_tls is not None:
            fail("wave S does not terminate TLS on the standard-library frontend")
        s_wave = wave_of(work_docs, N_REQUESTS, "s11")
        out["S"] = run_wave(server.port, s_wave, "s", "wave S", tls=good_tls)
    finally:
        out["S_launches"] = finish(server, boot, "wave S")

    # -- wave P: the prefork workers, and the rates at 1 and 4 -----------
    out["P"] = {}
    for frontend in ("native", "python"):
        for workers in (4, 1):
            label = f"wave P --frontend {frontend} --http-workers {workers}"
            server, boot = build(["--frontend", frontend,
                                  "--http-workers", str(workers)])
            rp = server.readiness_port
            row: dict = {}
            try:
                if workers > 1:
                    wait_until(
                        lambda: server.bridge.stats()["connections"] == workers - 1,
                        60, f"{label}: every worker on the bridge",
                    )
                p_wave = wave_of(work_docs, N_REQUESTS, f"p11{frontend}{workers}")
                native0 = (metric_value(rp, "policy_server_native_http_requests_total")
                           if frontend == "native" else 0.0)
                frames0 = server.bridge.stats()["frames"] if workers > 1 else 0
                row.update(run_wave(server.port, p_wave, f"p{frontend}{workers}",
                                    label, conns=64, depth=4))
                if workers > 1:
                    # every request was framed by this process's loop or
                    # crossed the bridge from a worker
                    frames = server.bridge.stats()["frames"] - frames0
                    main_loop = (
                        metric_value(rp, "policy_server_native_http_requests_total")
                        - native0 if frontend == "native" else None
                    )
                    if frames < 1:
                        fail(f"{label}: no worker forwarded a request")
                    if frontend == "native" and (
                        main_loop >= len(p_wave)
                        or main_loop + frames != len(p_wave)
                    ):
                        fail(f"{label}: main loop {main_loop} and worker frames "
                             f"{frames} for {len(p_wave)} requests")
                    row.update(worker_frames=frames, main_loop_requests=main_loop)
                    # one worker killed: respawned once within the
                    # supervisor's interval plus 1 s, and serving goes on
                    victim = server.worker_procs[0]
                    t_kill = time.perf_counter()
                    os.kill(victim.pid, signal.SIGKILL)
                    wait_until(
                        lambda: server.state.supervisor.stats()["worker_respawns"] >= 1,
                        server._WORKER_RESPAWN_INTERVAL_SECONDS + 1.0,
                        f"{label}: the killed worker's respawn",
                    )
                    row["respawn_s"] = time.perf_counter() - t_kill
                    wait_until(
                        lambda: server.bridge.stats()["connections"] == workers - 1,
                        30, f"{label}: the respawned worker on the bridge",
                    )
                    after = wave_of(work_docs[N_REQUESTS - 256:], 256,
                                    f"p11k{frontend}")
                    row["after_kill"] = run_wave(
                        server.port, after, f"pk{frontend}",
                        f"{label}, after the kill", conns=64, depth=4,
                    )
                    respawns = server.state.supervisor.stats()["worker_respawns"]
                    if respawns != 1:
                        fail(f"{label}: {respawns} respawns for one kill")
                    procs = [p for p in server.worker_procs if hasattr(p, "pid")]
                    bridge_dir = server._bridge_dir
                    bridge_socket = server._bridge_socket
            finally:
                row["launches"] = finish(server, boot, label)
            if workers > 1:
                alive = [p.pid for p in procs if p.poll() is None]
                if alive or os.path.exists(bridge_socket) or os.path.exists(bridge_dir):
                    fail(f"{label}: stop() left workers {alive}, the socket "
                         "or the directory behind")
            out["P"][frontend, workers] = row
    out["phase7_native"] = phase7
    return out


def print_tls_prefork_phase(r: dict, card: str) -> None:
    L, R, S = r["L"], r["R"], r["S"]
    p7 = r["phase7_native"]
    print(
        f"phase11 wave L native mTLS: {L['answered']} answers equal to the "
        f"oracle's, {L['req_s']:.1f} req/s p50 {L['p50']:.3f} p99 "
        f"{L['p99']:.3f} ms, {L['launches']} policy_matrix launches, "
        f"{L['handshakes_ok']:.0f} handshakes for {NATIVE_CONNS} connections, "
        f"refusals counted {L['refusals']}; phase 7 plaintext native "
        f"kernel-only x4 in this call: {p7['req_s']:.1f} req/s p50 "
        f"{p7['p50']:.3f} p99 {p7['p99']:.3f} ms [{card}]"
    )
    print(
        f"phase11 wave R rotation under load: new serial on new connections "
        f"{R['rotation_s']:.3f} s after the key landed, reloads +"
        f"{R['reloads']:.0f}, generations +{R['generations']:.0f}, corrupt "
        f"PEM failures +{R['reload_failures']:.0f}, expiry gauge "
        f"{R['expiry_s']:.0f} s, {R['answered']} answers equal to the oracle's "
        f"in {R['waves']} client waves through the rotation ({R['req_s']:.1f} "
        f"req/s, 8 connections x depth 2) [{card}]"
    )
    print(
        f"phase11 wave S stdlib TLS: {S['answered']} answers equal to the "
        f"oracle's, {S['req_s']:.1f} req/s p50 {S['p50']:.3f} p99 "
        f"{S['p99']:.3f} ms, {r['S_launches']['serving_launches']} "
        f"policy_matrix launches [{card}]"
    )
    for (frontend, workers), row in r["P"].items():
        extra = ""
        if workers > 1:
            extra = (
                f", worker frames {row['worker_frames']}, main-loop requests "
                f"{row['main_loop_requests']}, respawn {row['respawn_s']:.3f} s "
                f"after SIGKILL, "
                f"{row['after_kill']['answered']} answers after it"
            )
        print(
            f"phase11 wave P --frontend {frontend} --http-workers {workers}: "
            f"{row['answered']} answers equal to the oracle's, "
            f"{row['req_s']:.1f} req/s p50 {row['p50']:.3f} p99 "
            f"{row['p99']:.3f} ms (64 connections x depth 4), "
            f"{row['launches']['serving_launches']} policy_matrix launches"
            f"{extra} [{card}]"
        )


# -- phase 12: host-executed policies ----------------------------------------

WASM_ENGINE_PAYLOADS = 256
CEL_BATCHES = (51, 128, 1024)
WASM_DEADLINE_TIMEOUT = 0.2
# a spinning row holds its pipeline worker for the whole budget after the
# watchdog answered it, so the spinning waves are small, and the next wave
# waits until every spinning row's budget has run out
WASM_DEADLINE_SPIN = 16
WASM_DEADLINE_OTHER = 256
# the deadline waves keep at most 64 rows in flight, so their batches stay
# at or under the default host fast-path threshold (64), as small batches
# at the default flags do
WASM_DEADLINE_CONNS = 8
WASM_DEADLINE_DEPTH = 8
WASM_DEADLINE_MESSAGE = "execution deadline exceeded"
# the guest's own budget in the in-band wave, below the watchdog's: at
# equal budgets the watchdog (whose deadline runs from admission) answers
# a spinning row first, with the same body
WASM_DEADLINE_IN_BAND = 0.05

# the CEL policy that lowers onto K1: a variable, a bound on replicas, an
# all() and an exists_one() over the containers
CEL_LOWERED_SETTINGS = {
    "variables": [{"name": "cs", "expression": "object.spec.containers"}],
    "validations": [
        {"expression": "!has(object.spec.replicas) || object.spec.replicas <= 5",
         "message": "at most 5 replicas"},
        {"expression": "variables.cs.all(c, !c.image.startsWith('ghcr.io/'))",
         "message": "no ghcr.io images"},
        {"expression": "variables.cs.exists_one(c, c.image.startsWith('docker.io/'))",
         "message": "exactly one docker.io image"},
    ],
}
# arithmetic, a ternary and size(): outside the lowerable subset, served by
# the host CEL interpreter
CEL_HOST_SETTINGS = {"validations": [{
    "expression": (
        "has(object.spec.replicas) ? object.spec.replicas * 2 <= 10 "
        ": size(object.spec.containers) <= 3"
    ),
    "message": "too many containers",
    "messageExpression": "'too many containers: ' + string(size(object.spec.containers))",
}]}
# more lowerable expressions for the K1 hold (the corpus of the CEL tests)
CEL_CORPUS = [
    "object.spec.containers.all(c, !(c.securityContext.privileged == true))",
    "request.operation in ['CREATE', 'UPDATE']",
    "object.metadata.name.startsWith('pod-1')",
    "object.metadata.name.matches('^pod-[0-9]+$')",
    "object.spec.containers.exists(c, c.image.contains('nginx'))",
    "!(request.operation == 'DELETE')",
]


def wasm_fixture_modules() -> dict:
    """URL → module for the phase's wasm fixtures, each loaded through
    ``fetch.load_artifact`` from a file under ``build/chip_smoke_wasm/``."""
    import torch_wasm_fixtures as fixtures

    from policy_server_tpu_torch.evaluation.wasm_policy import WasmPolicyModule
    from policy_server_tpu_torch.fetch import load_artifact
    from policy_server_tpu_torch.wasm.wat import assemble

    work_dir = os.path.join(REPO, "build", "chip_smoke_wasm")
    os.makedirs(work_dir, exist_ok=True)
    out = {}
    for name, data in (
        ("priv.wasm", fixtures.wapc_privileged_wasm()),
        ("opa.wasm", fixtures.builtin_oracle_wasm()),
        ("wasi.wasm", fixtures.wasi_policy_wasm()),
    ):
        path = os.path.join(work_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        out[f"file:///{name}"] = load_artifact(path)
    out["file:///spin.wasm"] = WasmPolicyModule(
        assemble(fixtures.SPIN_ON_VALIDATE_WAPC), name="spin", digest="spin",
        fuel=None,
    )
    return out


def module_resolver_of(modules: dict):
    from policy_server_tpu_torch.policies import resolve_builtin

    def resolve(url: str):
        if url in modules:
            return modules[url]
        builtin = resolve_builtin(url)
        if builtin is None:
            fail(f"phase12: no module for {url}")
        return builtin

    return resolve


def wasm_set_specs() -> dict:
    """The flagship set and the seven host-executed entries: 39 ids."""
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    specs = flagship_policy_specs()
    specs.update({
        "cel-lowered": {"module": "builtin://cel-policy",
                        "settings": CEL_LOWERED_SETTINGS},
        "cel-upstream": {
            "module": "registry://ghcr.io/kubewarden/policies/cel-policy:v1.0.0",
            "settings": CEL_LOWERED_SETTINGS,
        },
        "cel-host": {"module": "builtin://cel-policy", "settings": CEL_HOST_SETTINGS},
        "wasm-priv": {"module": "file:///priv.wasm"},
        "opa-gk": {"module": "file:///opa.wasm"},
        "wasi-priv": {"module": "file:///wasi.wasm"},
        "wasm-guard": {
            "expression": "wasmpriv() && ns()",
            "message": "the wasm guard rejected the pod",
            "policies": {
                "wasmpriv": {"module": "file:///priv.wasm"},
                "ns": {"module": "builtin://namespace-validate",
                       "settings": {"denied_namespaces": ["kube-system"]}},
            },
        },
    })
    if len(specs) != 39:
        fail(f"phase12: the set has {len(specs)} ids, not 39")
    return specs


class EngineTimes:
    """Seconds spent in the host evaluators of the wasm and host-CEL
    policies (their programs' ``host_evaluator``, wrapped at build) and
    the evaluations counted, for the flight recorder's attribution."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.ns = 0
        self.calls = 0

    def wrap_module(self, module) -> None:
        real_build = module.build

        def build(settings):
            program = real_build(settings)
            he = program.host_evaluator
            if he is not None:
                def timed(payload, _he=he):
                    t0 = time.perf_counter_ns()
                    try:
                        return _he(payload)
                    finally:
                        with self.lock:
                            self.ns += time.perf_counter_ns() - t0
                            self.calls += 1

                import dataclasses

                program = dataclasses.replace(program, host_evaluator=timed)
            return program

        module.build = build

    def snapshot(self) -> tuple[int, int]:
        with self.lock:
            return self.ns, self.calls


def engines_phase(card: str) -> dict:
    """Each ABI's fixture on the firehose's requests: the native core's
    verdicts against the interpreter's (``PSTPU_NO_NATIVE_WASM=1``), µs
    per evaluation for each engine and the engine counts."""
    import torch_wasm_fixtures as fixtures

    from policy_server_tpu_torch.policies.flagship import synthetic_firehose
    from policy_server_tpu_torch.wasm import native_exec
    from policy_server_tpu_torch.wasm.opa import OpaPolicy, gatekeeper_validate
    from policy_server_tpu_torch.wasm.wapc import KubewardenWapcPolicy
    from policy_server_tpu_torch.wasm.wasi import WasiPolicy

    requests = [
        copy.deepcopy(d["request"])
        for d in synthetic_firehose(WASM_ENGINE_PAYLOADS, seed=12)
    ]
    wapc = KubewardenWapcPolicy(fixtures.wapc_privileged_wasm())
    opa = OpaPolicy(fixtures.builtin_oracle_wasm())
    wasi = WasiPolicy(fixtures.wasi_policy_wasm())
    hosts = {
        "waPC": lambda r: wapc.validate(r, {}),
        "OPA/Gatekeeper": lambda r: gatekeeper_validate(opa, r),
        "WASI": lambda r: wasi.validate(r, {}),
    }
    out = {}
    for abi, fn in hosts.items():
        row = {}
        verdicts = {}
        for engine in ("native", "interp"):
            if engine == "interp":
                os.environ["PSTPU_NO_NATIVE_WASM"] = "1"
            try:
                c0 = native_exec.engine_counts()
                t0 = time.perf_counter()
                verdicts[engine] = [fn(r) for r in requests]
                dt = time.perf_counter() - t0
                c1 = native_exec.engine_counts()
            finally:
                os.environ.pop("PSTPU_NO_NATIVE_WASM", None)
            row[f"{engine}_us"] = dt / len(requests) * 1e6
            row[f"{engine}_instances"] = {k: c1[k] - c0[k] for k in c1}
        if verdicts["native"] != verdicts["interp"]:
            bad = sum(a != b for a, b in zip(verdicts["native"], verdicts["interp"]))
            fail(f"phase12 {abi}: the native core disagrees with the interpreter on {bad} of {len(requests)} requests")
        if row["native_instances"]["native"] != len(requests) or row["native_instances"]["interp"]:
            fail(f"phase12 {abi}: the native run's engine counts are {row['native_instances']}")
        if row["interp_instances"]["interp"] != len(requests) or row["interp_instances"]["native"]:
            fail(f"phase12 {abi}: the interpreter run's engine counts are {row['interp_instances']}")
        rejected = sum(
            1 for v in verdicts["native"]
            if (v[0] if isinstance(v, tuple) else v.get("accepted")) is False
        )
        if not 0 < rejected < len(requests):
            fail(f"phase12 {abi}: {rejected} of {len(requests)} rejected: a vacuous run")
        row["rejected"] = rejected
        out[abi] = row
        print(
            f"phase12 engines {abi}: {len(requests)} firehose requests, native "
            f"core == interpreter (0 differing verdicts, {rejected} rejected); "
            f"native {row['native_us']:.1f} us/evaluation, interpreter "
            f"{row['interp_us']:.1f} us/evaluation; instances "
            f"{json.dumps(row['native_instances'])} then "
            f"{json.dumps(row['interp_instances'])} [{card}]"
        )
    return out


def cel_k1_phase(flagship_rows: list, card: str) -> dict:
    """The set's lowered CEL programs on the card against their plain
    version at B = 51, 128 and 1,024, both buckets, narrow and transport
    forms, tolerance 0; kernel and device times beside the flagship
    program's from phase 2 (the same call)."""
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import synthetic_firehose

    specs = {
        "cel-lowered": {"module": "builtin://cel-policy", "settings": CEL_LOWERED_SETTINGS},
        "cel-upstream": {
            "module": "registry://ghcr.io/kubewarden/policies/cel-policy:v1.0.0",
            "settings": CEL_LOWERED_SETTINGS,
        },
        **{
            f"cel-c{i}": {"module": "builtin://cel-policy", "settings": {
                "validations": [{"expression": e, "message": f"corpus {i}"}]}}
            for i, e in enumerate(CEL_CORPUS)
        },
    }
    probe0 = ck.launch_counts()["probe"]
    env = EvaluationEnvironmentBuilder(device="cuda").build(parse_policies(specs))
    probe = ck.launch_counts()["probe"] - probe0
    for pid in specs:
        bp = env._bound[pid]
        if bp.precompiled.program.host_evaluator is not None:
            fail(f"phase12: {pid} did not lower onto the device program")
    docs = synthetic_firehose(max(CEL_BATCHES), seed=13)
    flag = {(r["bucket"], r["batch"], r["form"]): r for r in flagship_rows}
    rows = []
    err = 0
    for idx, schema in enumerate(env.schemas):
        encs = []
        for d in docs:
            d = widen(d) if idx == 1 else d
            payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
            got_idx, enc = env.encode_bucketed(payload)
            if got_idx == idx:
                encs.append(enc)
        if len(encs) < max(CEL_BATCHES) // 2:
            fail(f"phase12: {len(encs)} reviews fit bucket {idx}")
        for batch in CEL_BATCHES:
            chosen = [encs[i % len(encs)] for i in range(batch)]
            wide = schema.pack(schema.stack(chosen, batch_size=batch))
            for narrow in (True, False):
                buf = schema.to_transport(
                    wide, vocab_size=len(env.table) if narrow else None
                )["__packed__"]
                program = env.program_for(idx, True, narrow)
                dev = torch.from_numpy(buf).to("cuda")
                want_a, want_r = ck.policy_matrix_plain(dev, program)
                got_a, got_r = ck.policy_matrix(dev, program)
                torch.cuda.synchronize()
                if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
                    bad = int((got_a != want_a).sum() + (got_r != want_r).sum())
                    fail(
                        f"phase12: policy_matrix disagrees with its plain version "
                        f"on the CEL programs: bucket {idx} B={batch} "
                        f"narrow={narrow}: {bad} cells"
                    )
                e = int((got_r - want_r).abs().max()) + int(
                    (got_a.to(torch.int32) - want_a.to(torch.int32)).abs().max()
                )
                err = max(err, e)
                cols = [program.column_of[p] for p in specs]
                if bool(want_a[:, cols].all()) or not bool(want_a[:, cols].any()):
                    fail(f"phase12: a vacuous CEL batch (bucket {idx} B={batch})")
                form = "narrow" if narrow else "transport"
                ms = time_cuda(lambda: ck.policy_matrix(dev, program), 20)
                device_ms = graph_ms(lambda: ck.policy_matrix(dev, program))
                plain_ms = time_cuda(
                    lambda: ck.policy_matrix_plain(dev, program), 2, warmup=1
                )
                nbytes = buf.nbytes + batch * program.out_cols * 5
                ops = batch * program.element_ops_per_row()
                fl = flag.get((idx, batch, form), {})
                row = {
                    "bucket": idx, "batch": batch, "form": form,
                    "width": int(buf.shape[1]), "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S) * 1e3,
                    "part_instructions": program.part_lengths,
                    "flagship_ms": fl.get("ms"), "flagship_device_ms": fl.get("device_ms"),
                    "max_abs_err": e, "card": card,
                }
                rows.append(row)
                print(f"phase12 CEL programs on policy_matrix exact: {json.dumps(row)}")
    env.close()
    return {"rows": rows, "err": err, "probe": probe}


def wasm_server_run(
    label: str, specs: dict, modules: dict, waves: list, oracle, card: str,
    engine_times: EngineTimes, check_batches: bool, **flags,
) -> dict:
    """The port's server with ``module_resolver=`` and ``--frontend
    native`` on the card; each wave of (policy id, body) pairs sent by the
    phase 7 client, every body equal to ``oracle``'s (the port's host
    oracle over the same modules). Per wave: K1 launches, engine
    instances and host-evaluator time, batches, rate and latency, the
    /metrics counts and the flight recorder's attribution. With
    ``check_batches``, every micro-batch that holds a row routed to the
    device must launch K1 (the environment's ``validate_batch_begin`` is
    wrapped to see each batch's rows and dispatched chunks)."""
    import torch

    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.server import PolicyServer
    from policy_server_tpu_torch.telemetry import flightrec
    from policy_server_tpu_torch.wasm import native_exec

    work_dir = os.path.join(REPO, "build", "chip_smoke_wasm")
    ck.reset_launch_counts()
    server = PolicyServer(
        parse_policies(specs), host="127.0.0.1", port=0,
        readiness_probe_port=0, device="cuda", enable_metrics=True,
        frontend="native", module_resolver=module_resolver_of(modules), **flags,
    )
    results = []
    try:
        torch.cuda.synchronize()
        build_counts = ck.launch_counts()
        server.start()
        env = server.env
        batch_log: list = []
        if check_batches:
            # per pipeline worker: a batch's encode and enqueue run on the
            # thread that began it, so thread-local counts are its own
            mine = threading.local()
            real_begin = env.validate_batch_begin
            real_enqueue = env._enqueue_features

            def enqueue(features):
                mine.chunks += 1
                return real_enqueue(features)

            def begin(items, run_hooks=True):
                device_rows = bits_rows = 0
                for pid, _req in items:
                    target = env._fast_target(pid)
                    if not env._host_executed(target):
                        device_rows += 1
                    if getattr(target, "name", None) in env._groups_with_wasm:
                        bits_rows += 1
                mine.chunks = 0
                handle = real_begin(items, run_hooks)
                batch_log.append((
                    len(items), device_rows, bits_rows, mine.chunks,
                    sorted({pid for pid, _r in items}),
                ))
                return handle

            env._enqueue_features = enqueue
            env.validate_batch_begin = begin
        rp = server.readiness_port
        rec = flightrec.recorder()
        for w, wave in enumerate(waves):
            name = wave["name"]
            items = wave["items"]
            want = [oracle_body(oracle, pid, body) for pid, body in items]
            want_rejected = sum(
                not oracle.validate(pid, request_of(body)).allowed
                for pid, body in items
            )
            torch.cuda.synchronize()
            k0 = ck.launch_counts()
            e0 = native_exec.engine_counts()
            t_ns0, t_calls0 = engine_times.snapshot()
            b0 = server.batcher.stats_snapshot()
            evals0 = evaluation_counts(rp)
            native0 = metric_value(rp, "policy_server_native_http_requests_total")
            cursor = rec.events_recorded() if rec is not None else 0
            n_log = len(batch_log)
            t0 = time.perf_counter()
            got = client_wave(server.port, items, f"phase12-{label}-{w}")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            time.sleep(0.2)
            k1 = ck.launch_counts()
            e1 = native_exec.engine_counts()
            t_ns1, t_calls1 = engine_times.snapshot()
            b1 = server.batcher.stats_snapshot()
            evals1 = evaluation_counts(rp)
            native1 = metric_value(rp, "policy_server_native_http_requests_total")
            mismatches = [
                (i, r[0], (r[2] or "")[:300], want[i][:300])
                for i, r in enumerate(got)
                if r is None or r[0] != 200 or r[2].encode("latin-1") != want[i]
            ]
            for i, st, body, wbody in mismatches[:3]:
                print(f"phase12 mismatch ({label}, wave {name}) request {i}: status {st} body {body!r} oracle {wbody!r}")
            if mismatches:
                fail(f"phase12: {len(mismatches)} of {len(items)} bodies differ from the oracle ({label}, wave {name})")
            lat = sorted(r[1] for r in got)
            batches = b1["batches_dispatched"] - b0["batches_dispatched"]
            host_batches = b1["host_fastpath_batches"] - b0["host_fastpath_batches"]
            att = rec.attribution(since=cursor) if rec is not None else None
            engine_s = (t_ns1 - t_ns0) / 1e9
            row = {
                "label": label, "wave": name, "requests": len(items),
                "req_s": len(items) / wall, "wall": wall,
                "p50": lat[len(lat) // 2],
                "p99": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                "batches": batches, "host_batches": host_batches,
                "k1_launches": k1["policy_matrix"] - k0["policy_matrix"],
                "instances": {k: e1[k] - e0[k] for k in e1},
                "host_evaluations": t_calls1 - t_calls0,
                "host_evaluator_s": engine_s,
                "evaluations": evals1[0] - evals0[0],
                "evaluations_rejected": evals1[1] - evals0[1],
                "native_requests": native1 - native0,
                "oracle_rejected": want_rejected,
                "batch_log": batch_log[n_log:],
            }
            if att is not None:
                per_row = att["phase_us_per_row"]
                rows = max(1, att["rows"])
                row["attribution"] = {
                    "wall_us_per_row": att["wall_us_per_row"],
                    "phase_us_per_row": per_row,
                    "residual_us_per_row": att["residual_us_per_row"],
                }
                row["host_evaluator_us_per_row"] = engine_s * 1e6 / rows
                # of the batch wall, and of prepare: on the device path the
                # host evaluators run inside it (standalone wasm answers,
                # the wasm group members' bits); the host fast path stamps
                # no phase of its own
                row["host_evaluator_share"] = {
                    p: (engine_s * 1e6 / rows) / v
                    for p, v in (("wall", att["wall_us_per_row"]),
                                 ("prepare", per_row.get("prepare")))
                    if v
                }
            if row["native_requests"] != len(items) or row["evaluations"] != len(items):
                fail(f"phase12: /metrics counted {row['native_requests']} native requests and {row['evaluations']} evaluations for {len(items)} ({label}, wave {name})")
            if row["evaluations_rejected"] != want_rejected:
                fail(f"phase12: /metrics counted {row['evaluations_rejected']} rejections, the oracle {want_rejected} ({label}, wave {name})")
            if check_batches and not row["batch_log"]:
                fail(f"phase12: no micro-batch reached the device ({label}, wave {name}): {batches} batches, {host_batches} host-routed")
            if check_batches and not flags.get("verdict_cache_size", 1):
                missing = [b for b in row["batch_log"] if b[1] and b[3] < 1]
                if missing:
                    fail(f"phase12: {len(missing)} micro-batches with device-routed rows launched no policy_matrix ({label}, wave {name}): {missing[:5]}")
            results.append(row)
            print(
                f"phase12 server ({label}) wave {name}: {len(items)} requests, "
                f"0 bodies differ from the oracle; {row['req_s']:.1f} req/s "
                f"p50 {row['p50']:.3f} ms p99 {row['p99']:.3f} ms; {batches} "
                f"micro-batches ({host_batches} host-routed); policy_matrix "
                f"launches {row['k1_launches']}; engine instances "
                f"{json.dumps(row['instances'])}, host evaluations "
                f"{row['host_evaluations']} in {engine_s:.4f} s; /metrics "
                f"native +{row['native_requests']:.0f} evaluations "
                f"+{row['evaluations']:.0f} rejected "
                f"+{row['evaluations_rejected']:.0f} (oracle {want_rejected}); "
                f"attribution {json.dumps(row.get('attribution'))}, host "
                f"evaluator share {json.dumps(row.get('host_evaluator_share'))} "
                f"[{card}]"
            )
        breaker = server.env.breaker_stats
        if server.env.device_errors or breaker["trips"]:
            fail(f"phase12: device errors or breaker trips ({label}): {breaker}")
        if server.batcher.deadline_rejections:
            fail(f"phase12: {server.batcher.deadline_rejections} deadline rejections ({label})")
    finally:
        server.stop()
    torch.cuda.synchronize()
    return {"waves": results, "build": build_counts, "launches": ck.launch_counts()}


def deadline_phase(modules: dict, work_docs: list, card: str) -> dict:
    """The spin-loop module under ``--policy-timeout 0.2`` beside the
    flagship set: a wave of spinning rows alone, one of flagship rows
    alone, then both at once, and last the spinning rows one at a time
    with the guest's budget cut below the watchdog's. Every spinning row
    answers "execution deadline exceeded" 500; every flagship row sent
    alone answers its oracle's body; in the mixed wave a flagship row
    batched with a spinning one, or queued behind one past its deadline,
    answers the same deadline body from the batcher's watchdog (which runs
    from admission, as in the JAX package), counted, and no more flagship
    rows answer it than the watchdog answered. In the last wave the
    guest's own wall-clock cut answers every row and the watchdog none;
    no breaker trip."""
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs
    from policy_server_tpu_torch.server import PolicyServer

    specs = flagship_policy_specs()
    specs["spin"] = {"module": "file:///spin.wasm"}
    resolver = module_resolver_of(modules)
    probe0 = ck.launch_counts()["probe"]
    server = PolicyServer(
        parse_policies(specs), host="127.0.0.1", port=0,
        readiness_probe_port=0, device="cuda", frontend="native",
        module_resolver=resolver, policy_timeout=WASM_DEADLINE_TIMEOUT,
    )
    flagship = EvaluationEnvironmentBuilder(backend="oracle").build(
        parse_policies(flagship_policy_specs())
    )
    out = {"probe": ck.launch_counts()["probe"] - probe0}
    try:
        if modules["file:///spin.wasm"].wall_clock_budget != WASM_DEADLINE_TIMEOUT:
            fail("phase12: the server did not give the wasm module its policy timeout")
        server.start()
        spin = [("spin", body) for _pid, body in wave_of(work_docs, WASM_DEADLINE_SPIN, "spin")]
        other = wave_of(work_docs[WASM_DEADLINE_SPIN:], WASM_DEADLINE_OTHER, "other")
        mixed_spin = [("spin", body) for _pid, body in wave_of(work_docs, WASM_DEADLINE_SPIN, "mixed-spin")]
        mixed_other = wave_of(work_docs[WASM_DEADLINE_SPIN:], WASM_DEADLINE_OTHER, "mixed-other")
        mixed = [x for pair in zip(mixed_other[::4], mixed_spin) for x in pair]
        mixed += [x for i, x in enumerate(mixed_other) if i % 4]
        in_band = [("spin", body) for _pid, body in wave_of(work_docs, WASM_DEADLINE_SPIN, "in-band")]
        for name, wave in (("spin alone", spin), ("flagship alone", other),
                           ("both", mixed), ("spin in-band", in_band)):
            if name != "spin alone":
                # the spinning rows' abandoned evaluations end within their
                # budget each, one after another on a worker at worst
                time.sleep(WASM_DEADLINE_SPIN * WASM_DEADLINE_TIMEOUT)
            sequential = name == "spin in-band"
            if sequential:
                modules["file:///spin.wasm"].wall_clock_budget = WASM_DEADLINE_IN_BAND
            watchdog0 = server.batcher.deadline_rejections
            t0 = time.perf_counter()
            got = finish_client(*start_client(
                server.port, wave, f"phase12-deadline-{len(out)}",
                conns=1 if sequential else WASM_DEADLINE_CONNS,
                depth=1 if sequential else WASM_DEADLINE_DEPTH,
                work_dir=os.path.join(REPO, "build", "chip_smoke_wasm"),
            ), name)
            wall = time.perf_counter() - t0
            watchdog = server.batcher.deadline_rejections - watchdog0
            spin_ok = deadline_others = normal = 0
            for (pid, body), r in zip(wave, got):
                deadline_body = in_band_body(body, WASM_DEADLINE_MESSAGE, 500)
                if r is None or r[0] != 200:
                    fail(f"phase12 deadline ({name}): status {None if r is None else r[0]} for {pid}")
                answer = r[2].encode("latin-1")
                if pid == "spin":
                    if answer != deadline_body:
                        fail(f"phase12 deadline ({name}): a spinning row answered {answer[:200]!r}")
                    spin_ok += 1
                elif answer == oracle_body(flagship, pid, body):
                    normal += 1
                elif answer == deadline_body and name == "both":
                    deadline_others += 1
                else:
                    fail(f"phase12 deadline ({name}): {pid} answered {answer[:200]!r}")
            if deadline_others > watchdog:
                fail(f"phase12 deadline ({name}): {deadline_others} flagship rows "
                     f"answered the deadline body, the watchdog answered {watchdog}")
            if sequential and watchdog:
                fail(f"phase12 deadline ({name}): the watchdog answered {watchdog} "
                     f"spinning rows under a guest budget of {WASM_DEADLINE_IN_BAND} s")
            lat = sorted(r[1] for r in got)
            out[name] = {
                "requests": len(wave), "spin_deadline": spin_ok,
                "answered_normally": normal, "others_deadline": deadline_others,
                "watchdog": watchdog, "in_band": spin_ok + deadline_others - watchdog,
                "wall": wall, "p50": lat[len(lat) // 2], "max_ms": lat[-1],
            }
            budget = WASM_DEADLINE_IN_BAND if sequential else WASM_DEADLINE_TIMEOUT
            print(
                f"phase12 deadline --policy-timeout {WASM_DEADLINE_TIMEOUT}, guest "
                f"budget {budget} s ({name}): "
                f"{len(wave)} requests, {spin_ok} spinning rows answered "
                f"\"{WASM_DEADLINE_MESSAGE}\" 500, {normal} answered as the "
                f"oracle, {deadline_others} batched with or queued behind a "
                f"spinning row answered the deadline body; deadline bodies from "
                f"the watchdog {watchdog}, in-band {out[name]['in_band']}; "
                f"p50 {out[name]['p50']:.3f} ms, slowest "
                f"{lat[-1]:.3f} ms, wall {wall:.2f} s [{card}]"
            )
        if out["flagship alone"]["answered_normally"] != len(other):
            fail("phase12 deadline: a flagship row sent alone did not answer normally")
        b = server.batcher.stats_snapshot()
        breaker = server.env.breaker_stats
        out["breaker"] = breaker
        out["host_batches"] = b["host_fastpath_batches"]
        out["batches"] = b["batches_dispatched"]
        out["deadline_rejections"] = server.batcher.deadline_rejections
        if breaker["trips"]:
            fail(f"phase12 deadline: the breaker tripped: {breaker}")
        print(
            f"phase12 deadline: breaker trips {breaker['trips']}, "
            f"{out['batches']} micro-batches ({out['host_batches']} on the "
            f"host fast path), watchdog answers "
            f"{out['deadline_rejections']} [{card}]"
        )
    finally:
        server.stop()
    return out


def wasm_phase(work_docs: list, k1_rows: list, card: str) -> dict:
    """Phase 12: the native wasm core's verdicts against the interpreter's
    per ABI, the lowered CEL programs on K1, the 39-policy set at full
    width through the native server (default flags, kernel-only, and a
    replay with the verdict cache on), and the wall-clock deadline."""
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.policies import resolve_builtin
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    r = {"engines": engines_phase(card)}
    t = time.perf_counter()
    r["cel"] = cel_k1_phase(k1_rows, card)
    r["cel_wall"] = time.perf_counter() - t

    modules = wasm_fixture_modules()
    times = EngineTimes()
    for m in list(modules.values()) + [resolve_builtin("builtin://cel-policy")]:
        times.wrap_module(m)
    specs = wasm_set_specs()
    ids = sorted(specs)
    flagship_ids = sorted(flagship_policy_specs())
    oracle = EvaluationEnvironmentBuilder(
        backend="oracle", module_resolver=module_resolver_of(modules)
    ).build(parse_policies(specs))
    docs = [d for _pid, d in work_docs]

    def wave(name: str, pids: list, tag: str) -> dict:
        items = []
        for i, d in enumerate(docs):
            d = copy.deepcopy(d)
            d["request"]["uid"] = f"{d['request']['uid']}-{tag}"
            items.append((pids[i % len(pids)], json.dumps(d).encode()))
        return {"name": name, "items": items}

    mixed = wave("39 ids", ids, "w12")
    flagship_only = wave("32 flagship ids", flagship_ids, "f12")
    kernel_only = dict(
        host_fastpath_threshold=0, verdict_cache_size=0, latency_budget_ms=0
    )
    r["default"] = wasm_server_run(
        "default flags", specs, modules, [mixed, flagship_only], oracle, card,
        times, check_batches=False,
    )
    r["kernel"] = wasm_server_run(
        "--host-fastpath-threshold 0 --verdict-cache-size 0 --latency-budget-ms 0",
        specs, modules, [mixed, flagship_only], oracle, card, times,
        check_batches=True, **kernel_only,
    )
    # the replay: the verdict cache on, every batch on the device path
    replay = dict(host_fastpath_threshold=0, latency_budget_ms=0)
    again = {"name": "39 ids again", "items": mixed["items"]}
    r["replay"] = wasm_server_run(
        "--host-fastpath-threshold 0 --latency-budget-ms 0 (cache on), replay",
        specs, modules, [mixed, again], oracle, card, times,
        check_batches=True, **replay,
    )
    first, second = r["replay"]["waves"]
    wasm_rows = sum(
        1 for pid, _b in mixed["items"]
        if pid in ("wasm-priv", "opa-gk", "wasi-priv", "wasm-guard")
    )
    if second["instances"] != first["instances"] or sum(second["instances"].values()) < wasm_rows:
        fail(f"phase12 replay: the wasm engine ran {second['instances']} instances, the first pass {first['instances']} ({wasm_rows} wasm rows)")
    if second["host_evaluations"] != first["host_evaluations"]:
        fail("phase12 replay: the host evaluators did not run again for every wasm row")
    # every replay dispatch carries wasm-guard rows (their bits are never
    # cached); the cached IR rows launch nothing
    launched = [b for b in second["batch_log"] if b[3]]
    ir_only = [b for b in launched if not b[2]]
    if ir_only:
        fail(f"phase12 replay: {len(ir_only)} batches launched policy_matrix without a wasm-guard row (rows, device rows, guard rows, chunks, ids): {ir_only[:5]}")
    bits_batches = len(launched)
    print(
        f"phase12 replay: the wasm engine re-ran ({json.dumps(second['instances'])} "
        f"instances, {second['host_evaluations']} host evaluations, as the "
        f"first pass); policy_matrix launches {second['k1_launches']} against "
        f"{first['k1_launches']} on the first pass, in {bits_batches} batches "
        f"(those with wasm-guard rows, whose bits are never cached) [{card}]"
    )
    r["replay_k1"] = (first["k1_launches"], second["k1_launches"])
    t = time.perf_counter()
    r["deadline"] = deadline_phase(modules, work_docs, card)
    r["deadline_wall"] = time.perf_counter() - t
    r["k1_launches"] = {
        name: sum(w["k1_launches"] for w in r[name]["waves"])
        for name in ("default", "kernel", "replay")
    }
    r["probe"] = (
        sum(r[name]["launches"]["probe"] for name in ("default", "kernel", "replay"))
        + r["cel"]["probe"] + r["deadline"]["probe"]
    )
    return r


def print_wasm_phase(r: dict, card: str) -> None:
    rows = {w["wave"]: w for w in r["kernel"]["waves"]}
    mixed, flag = rows["39 ids"], rows["32 flagship ids"]
    print(
        "phase12 summary: "
        + json.dumps({
            "engines_us": {abi: {"native": round(v["native_us"], 2),
                                 "interp": round(v["interp_us"], 2)}
                           for abi, v in r["engines"].items()},
            "kernel_only_rate_vs_flagship": mixed["req_s"] / flag["req_s"],
            "kernel_only_p99_ms": {"39 ids": mixed["p99"], "flagship": flag["p99"]},
            "default_rate_vs_flagship": (
                r["default"]["waves"][0]["req_s"] / r["default"]["waves"][1]["req_s"]
            ),
            "cel_k1_device_ms": {
                f"b{row['bucket']} {row['form']} B={row['batch']}":
                    [round(row["device_ms"], 5), row["flagship_device_ms"]]
                for row in r["cel"]["rows"]
            },
            "k1_launches": r["k1_launches"],
            "replay_k1": r["replay_k1"],
            "deadline": {k: v for k, v in r["deadline"].items()
                         if k not in ("breaker", "probe")},
        })
        + f" [{card}]"
    )


# -- phase 13: policy acquisition, cluster context and the audit watch feed -

FETCH_WAVE = 1024
FETCH_NEGATIVE_WAVE = 256
FETCH_DIR = os.path.join(REPO, "build", "chip_smoke_fetch")
RELOAD_TAG_CYCLES = 8
RELOAD_TAG_WAVE = 128
CONTEXT_NAMESPACES = 200
CONTEXT_NAMES = 220
CONTEXT_WAVE = 1024
CONTEXT_EVENTS = 20
CONTEXT_OVERFLOW = 257
CONTEXT_OVERFLOW_WAVE = 256
CONTEXT_HOLD_NAMESPACES = (200, 256)
WATCH_OBJECTS = 512
WATCH_EVENTS = 512
KEYLESS_SUBJECT = "release@example.com"
KEYLESS_ISSUER = "https://issuer.example.com"
KERNEL_ONLY_ARGS = [
    "--host-fastpath-threshold", "0", "--verdict-cache-size", "0",
    "--latency-budget-ms", "0",
]
NS_AWARE = [{"apiVersion": "v1", "kind": "Namespace"}]


def carried_artifacts() -> dict:
    """policy id → ``.tpp.json`` bytes of each flagship policy whose program
    ``serde`` carries: no mutator, context provider, pre-eval hook or host
    evaluator (the two signature policies, the mutating ones and the groups
    stay builtins)."""
    from policy_server_tpu_torch.fetch import dump_artifact
    from policy_server_tpu_torch.policies import resolve_builtin
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    out = {}
    for name, spec in flagship_policy_specs().items():
        if "module" not in spec:
            continue
        program = resolve_builtin(spec["module"]).build(spec.get("settings") or {})
        if (program.mutator or program.context_provider
                or program.pre_eval_hook or program.host_evaluator):
            continue
        out[name] = json.dumps(
            dump_artifact(name, list(program.rules)), sort_keys=True
        ).encode()
    return out


class FetchRig:
    """The acquisition set-up of phase 13 under ``build/chip_smoke_fetch``:
    the carried flagship artifacts, each signed with an ed25519 key and a
    keyless bundle of this script's own PKI (trust root in the sigstore
    cache directory), a third each behind ``file://``, ``https://`` (an
    in-script HTTPS host whose CA is only in ``sources.json``'s
    ``source_authorities``) and ``registry://`` (an in-script OCI registry
    with the anonymous token flow, one repository behind basic auth from
    the docker config, two with blobs behind a 307 to a storage host that
    refuses ``Authorization``); ``sources.json`` and ``verification.json``
    (the public key and the keyless identity required on every
    artifact)."""

    def __init__(self) -> None:
        import shutil

        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey,
        )

        from policy_server_tpu_torch.fetch import keyless
        from policy_server_tpu_torch.fetch.verify import (
            SIGNATURE_PAYLOAD_TYPE,
            make_signature_entry,
        )
        from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

        import torch_fetch_fixtures as fx

        self.fx = fx
        self.stopped = False
        shutil.rmtree(FETCH_DIR, ignore_errors=True)
        os.makedirs(FETCH_DIR)
        key = Ed25519PrivateKey.generate()
        self.priv = key.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        )
        pub = key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo,
        ).decode()
        ca_cert, ca_key = keyless.make_test_ca()
        rekor_key = ec.generate_private_key(ec.SECP256R1())
        self.sigstore = os.path.join(FETCH_DIR, "sigstore")
        os.makedirs(self.sigstore)
        with open(os.path.join(self.sigstore, "trust_root.json"), "w") as f:
            json.dump(keyless.make_test_trust_root_doc(ca_cert, rekor_key), f)

        def sidecar(data: bytes) -> bytes:
            return json.dumps({"signatures": [
                make_signature_entry(self.priv, data, keyid="chip"),
                keyless.make_keyless_entry(
                    data, ca_cert, ca_key, rekor_key,
                    subject=KEYLESS_SUBJECT, issuer_claim=KEYLESS_ISSUER,
                    payload_type=SIGNATURE_PAYLOAD_TYPE,
                ),
            ]}).encode()

        self.sidecar = sidecar
        https_ca = fx.make_ca("chip-smoke-source-ca")
        self.https = fx.FileHost(fx.server_context(
            __import__("pathlib").Path(FETCH_DIR) / "https", https_ca
        ))
        self.registry = fx.Registry()
        artifacts = carried_artifacts()
        self.artifacts = artifacts
        files = os.path.join(FETCH_DIR, "files")
        os.makedirs(files)
        specs = flagship_policy_specs()
        self.where: dict = {}
        registry_names = []
        for i, (name, data) in enumerate(sorted(artifacts.items())):
            signature = sidecar(data)
            if i % 3 == 0:
                path = os.path.join(files, f"{name}.tpp.json")
                with open(path, "wb") as f:
                    f.write(data)
                with open(path + ".sig.json", "wb") as f:
                    f.write(signature)
                url = f"file://{path}"
                self.where[name] = "file"
            elif i % 3 == 1:
                self.https.files[f"/{name}.tpp.json"] = data
                self.https.files[f"/{name}.tpp.json.sig.json"] = signature
                url = f"https://{self.https.netloc}/{name}.tpp.json"
                self.where[name] = "https"
            else:
                self.registry.publish(f"fetched/{name}", "v1", data)
                self.registry.sign(f"fetched/{name}", data, signature)
                url = f"registry://{self.registry.netloc}/fetched/{name}:v1"
                self.where[name] = "registry"
                registry_names.append(name)
            spec = {k: v for k, v in specs[name].items() if k != "settings"}
            spec["module"] = url
            specs[name] = spec
        self.specs = specs
        # one repository behind basic auth, two blobs behind a 307
        self.basic_repo = f"fetched/{registry_names[0]}"
        self.registry.basic_auth[self.basic_repo] = "chip:smoke-secret"
        self.registry.redirect_repos.update(
            f"fetched/{n}" for n in registry_names[1:3]
        )
        # the reload wave's policy: tag v2 serves another policy's rules
        self.moving = registry_names[-1]
        donor = "pod-privileged" if self.moving != "pod-privileged" else next(
            n for n in sorted(artifacts) if n != self.moving
        )
        v2 = json.loads(artifacts[donor])
        v2["metadata"]["name"] = self.moving
        v2 = json.dumps(v2, sort_keys=True).encode()
        self.registry.publish(f"fetched/{self.moving}", "v2", v2)
        self.registry.sign(f"fetched/{self.moving}", v2, sidecar(v2))
        self.docker_config = fx.docker_config(
            __import__("pathlib").Path(FETCH_DIR) / "docker-config.json",
            self.registry.netloc, "chip:smoke-secret",
        )
        self.sources_path = os.path.join(FETCH_DIR, "sources.json")
        self.sources_doc = {
            "insecure_sources": [self.registry.netloc],
            "source_authorities": {
                "127.0.0.1": [{"type": "Data", "data": fx.pem_of(https_ca[1])}],
            },
        }
        with open(self.sources_path, "w") as f:
            json.dump(self.sources_doc, f)
        self.verification_path = os.path.join(FETCH_DIR, "verification.json")
        self.verification_doc = {"apiVersion": "v1", "allOf": [
            {"kind": "pubKey", "owner": "chip-smoke", "key": pub},
            {"kind": "genericIssuer", "issuer": KEYLESS_ISSUER,
             "subject": {"equal": KEYLESS_SUBJECT}},
        ]}
        with open(self.verification_path, "w") as f:
            json.dump(self.verification_doc, f)

    def tagged(self, tag: str) -> dict:
        specs = copy.deepcopy(self.specs)
        url = specs[self.moving]["module"]
        specs[self.moving]["module"] = url.rsplit(":", 1)[0] + f":{tag}"
        return specs

    def write_policies(self, name: str, specs: dict) -> str:
        path = os.path.join(FETCH_DIR, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(specs, f)
        os.replace(tmp, path)
        return path

    def args(self, policies_path: str, download: str) -> list:
        return [
            "--policies", policies_path, "--addr", "127.0.0.1", "--port", "0",
            "--readiness-probe-port", "0", "--enable-metrics",
            "--sources-path", self.sources_path,
            "--verification-path", self.verification_path,
            "--sigstore-cache-dir", self.sigstore,
            "--docker-config-json-path", str(self.docker_config),
            "--policies-download-dir", os.path.join(FETCH_DIR, download),
        ]

    def oracle(self, specs: dict, download: str, **kw):
        """The host oracle over the same artifacts, fetched and verified
        through a resolver of its own."""
        from policy_server_tpu_torch.config import (
            read_sources_file,
            read_verification_file,
        )
        from policy_server_tpu_torch.evaluation.environment import (
            EvaluationEnvironmentBuilder,
        )
        from policy_server_tpu_torch.fetch import FetchConfig, make_module_resolver
        from policy_server_tpu_torch.models.policy import parse_policies

        resolver = make_module_resolver(FetchConfig(
            sources=read_sources_file(self.sources_path),
            verification_config=read_verification_file(self.verification_path),
            docker_config_json_path=str(self.docker_config),
            policies_download_dir=os.path.join(FETCH_DIR, download),
            sigstore_cache_dir=self.sigstore,
        ))
        env = EvaluationEnvironmentBuilder(
            backend="oracle", module_resolver=resolver, **kw
        ).build(parse_policies(specs))
        return env, resolver

    def stop(self) -> None:
        if not self.stopped:
            self.stopped = True
            self.https.stop()
            self.registry.stop()


class BootClock:
    """Seconds a boot spends fetching and verifying artifacts (the
    downloader's ``fetch_policy`` and the resolver's ``verify_artifact``
    wrapped while it is armed); the rest of the boot is the build."""

    def __init__(self) -> None:
        self.fetch = self.verify = 0.0

    def __enter__(self) -> "BootClock":
        from policy_server_tpu_torch import fetch
        from policy_server_tpu_torch.fetch.downloader import Downloader

        self._fetch = Downloader.fetch_policy
        self._verify = fetch.verify_artifact
        clock = self

        def fetch_policy(dl, url, dest):
            t0 = time.perf_counter()
            try:
                return clock._fetch(dl, url, dest)
            finally:
                clock.fetch += time.perf_counter() - t0

        def verify_artifact(*a, **kw):
            t0 = time.perf_counter()
            try:
                return clock._verify(*a, **kw)
            finally:
                clock.verify += time.perf_counter() - t0

        Downloader.fetch_policy = fetch_policy
        fetch.verify_artifact = verify_artifact
        return self

    def __exit__(self, *exc) -> None:
        from policy_server_tpu_torch import fetch
        from policy_server_tpu_torch.fetch.downloader import Downloader

        Downloader.fetch_policy = self._fetch
        fetch.verify_artifact = self._verify


def boot_server(argv: list, label: str) -> tuple:
    """A server from the command line (``__main__.build_cli`` +
    ``server_from_args``), started → (server, boot seconds split into
    fetch, verify and the rest, and the build's launches: the counts set
    to 0 just before it)."""
    import torch

    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    args = build_cli().parse_args(argv)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with BootClock() as clock:
        server = server_from_args(args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = ck.launch_counts()
    server.start()
    status, text = http_get(server.readiness_port, "/readiness")
    if status != 200:
        server.stop()
        fail(f"{label}: /readiness answered {status} {text!r}")
    return server, {
        "boot_s": total, "fetch_s": clock.fetch, "verify_s": clock.verify,
        "build_s": total - clock.fetch - clock.verify, "launches": launches,
    }


def served_wave(server, wave: list, expectations: list, label: str,
                kernel_only: bool, expect_launches: bool = True,
                positions: int = 1) -> dict:
    """One wave from the ``--native-client`` process (raw sockets, either
    frontend): every answer must equal one of ``expectations``. The launch
    counts are set to 0 just before it and read just after; kernel-only,
    every device batch must launch K1 (``check_kernel_batches``, each step
    on ``positions`` mesh positions), or, with ``expect_launches`` False
    (an all-overflow batch), none may."""
    import torch

    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.telemetry import flightrec

    rec = flightrec.recorder()
    cursor = rec.events_recorded() if rec is not None else 0
    b0 = server.batcher.stats_snapshot()
    fb0 = server.env.oracle_fallbacks
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    results = client_wave(server.port, wave, label.replace(" ", "-"))
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    time.sleep(0.1)  # the last batch's bookkeeping lands after delivery
    counts = ck.launch_counts()
    b1 = server.batcher.stats_snapshot()
    run = check_wave(label, results, wave, expectations)
    run.update({
        "serving_launches": counts["policy_matrix"],
        "probe_launches": counts["probe"],
        "batches": b1["batches_dispatched"] - b0["batches_dispatched"],
        "rows": b1["requests_dispatched"] - b0["requests_dispatched"],
        "host_batches": b1["host_fastpath_batches"] - b0["host_fastpath_batches"],
        "oracle_fallbacks": server.env.oracle_fallbacks - fb0,
        "kernel_batches": kernel_batches(rec, cursor) if rec else None,
        "req_s": len(wave) / wall,
    })
    if kernel_only and expect_launches:
        check_kernel_batches(run, label, positions)
    if not expect_launches and run["serving_launches"]:
        fail(f"{label}: an all-overflow wave launched policy_matrix "
             f"{run['serving_launches']} times")
    return run


def fetch_waves(rig: FetchRig, work_docs: list, card: str) -> dict:
    """Wave F and wave R (see the module docstring)."""
    import gc as _gc

    import torch

    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.fetch.downloader import retry_stats
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    out: dict = {"where": {k: sum(1 for v in rig.where.values() if v == k)
                           for k in ("file", "https", "registry")}}
    v1 = rig.tagged("v1")
    policies = rig.write_policies("policies.json", v1)
    oracle, _resolver = rig.oracle(v1, "oracle-store")
    out["k1_device_ms"] = {}
    out["k1_err"] = hold_set_against_plain(
        v1, [d for _pid, d in work_docs], card,
        "phase13 fetched set", timings=out["k1_device_ms"],
        module_resolver=_resolver,
    )
    print(f"phase13 fetched set: K1 device ms at B=128 narrow by bucket "
          f"{json.dumps(out['k1_device_ms'])} [{card}]")
    wave = wave_of(work_docs, FETCH_WAVE, "f13")
    exp = [expected_answer(oracle, pid, body) for pid, body in wave]
    out["F"] = {}
    servers = {}
    try:
        # python first: a server's stop() uninstalls its flight recorder,
        # and wave R reads the native server's
        for frontend in ("python", "native"):
            if "python" in servers:
                servers.pop("python").stop()
            argv = rig.args(policies, f"store-{frontend}") + KERNEL_ONLY_ARGS + [
                "--frontend", frontend, "--reload-admin-token", RELOAD_TOKEN,
            ]
            server, boot = boot_server(argv, f"phase13 wave F {frontend}")
            servers[frontend] = server
            run = served_wave(server, wave, [exp],
                              f"phase13 wave F {frontend}", kernel_only=True)
            run["boot"] = boot
            out["F"][frontend] = run
            print(
                f"phase13 wave F --frontend {frontend}: boot "
                f"{boot['boot_s']:.3f} s (fetch {boot['fetch_s']:.3f}, verify "
                f"{boot['verify_s']:.3f}, build {boot['build_s']:.3f}) of "
                f"{len(rig.artifacts)} artifacts ({json.dumps(out['where'])}); "
                f"{len(wave)} kernel-only reviews, every body the oracle's over "
                f"the same artifacts; {run['req_s']:.1f} req/s p50 "
                f"{run['p50']:.3f} p99 {run['p99']:.3f} ms; {run['batches']} "
                f"batches, policy_matrix {run['serving_launches']} launches, per "
                f"batch {json.dumps(run['kernel_batches'])} [{card}]"
            )
        reg = rig.registry
        print(
            f"phase13 registry: {reg.requests} requests, storage 307 hits "
            f"{reg.storage_hits}, refusals of Authorization "
            f"{reg.storage_refusals} [{card}]"
        )
        if reg.storage_refusals or not reg.storage_hits:
            fail("phase13: a redirected blob carried Authorization, or none "
                 "was redirected")

        # wave R: the moving policy between tags v1 and v2, 8 reloads
        server = servers["native"]
        lc = server.lifecycle
        rp = server.readiness_port
        v2 = rig.tagged("v2")
        oracle_v2, _r2 = rig.oracle(v2, "oracle-store-v2")
        cycles = []
        for c in range(RELOAD_TAG_CYCLES):
            specs, orc, tag = (v2, oracle_v2, "v2") if c % 2 == 0 else (v1, oracle, "v1")
            rig.write_policies("policies.json", specs)
            reloads = lc.stats()["reloads"]
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            status, body = admin_post(rp, "/policies/reload")
            if status != 202:
                fail(f"phase13 wave R: POST /policies/reload answered {status} {body}")
            wait_until(
                lambda: lc.stats()["reloads"] > reloads and not lc.reload_in_flight(),
                120, f"phase13 reload {c + 1}",
            )
            reload_s = time.perf_counter() - t0
            # the policies-file watch may start one more reload of the same
            # file; let it land before the wave
            time.sleep(1.2)
            wait_until(lambda: not lc.reload_in_flight(), 120, "the file watch's reload")
            torch.cuda.synchronize()
            built = ck.launch_counts()
            # every fourth review to the moving policy
            wave_r = [
                (rig.moving if i % 4 == 0 else pid, body) for i, (pid, body)
                in enumerate(wave_of(work_docs, RELOAD_TAG_WAVE, f"r13-{c}"))
            ]
            exp_r = [expected_answer(orc, pid, b) for pid, b in wave_r]
            run = served_wave(server, wave_r, [exp_r],
                              f"phase13 wave R cycle {c + 1}", kernel_only=True)
            join_retirements()
            _gc.collect()
            torch.cuda.synchronize()
            cycles.append({
                "tag": tag, "reload_s": reload_s,
                "reloads": lc.stats()["reloads"], "epoch": lc.current_epoch,
                "memory_allocated": torch.cuda.memory_allocated(),
                "max_memory_reserved": torch.cuda.max_memory_reserved(),
                "launches": run["serving_launches"], "p99": run["p99"],
                "reload_launches": built,
            })
            print(f"phase13 wave R cycle {c + 1}: {json.dumps(cycles[-1])} [{card}]")
        differs = sum(
            expected_answer(oracle, rig.moving, b)
            != expected_answer(oracle_v2, rig.moving, b)
            for _pid, b in wave_of(work_docs, RELOAD_TAG_WAVE, "r13-x")
        )
        if not differs:
            fail("phase13 wave R: tags v1 and v2 answer every review alike")
        out["R"] = {"cycles": cycles, "differs": differs}
        grown = cycles[-1]["memory_allocated"] - cycles[1]["memory_allocated"]
        if grown > RELOAD_MEMORY_SLACK:
            fail(f"phase13 wave R: memory_allocated grew {grown} B over the cycles")
    finally:
        for server in servers.values():
            server.stop()

    # the negative runs: a tampered artifact, then fetch.http faults
    tampered = copy.deepcopy(v1)
    victim = next(n for n in sorted(rig.where) if rig.where[n] == "file")
    src = tampered[victim]["module"][len("file://"):]
    bad = os.path.join(FETCH_DIR, "files", f"tampered-{victim}.tpp.json")
    with open(src, "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data + b" ")
    with open(src + ".sig.json", "rb") as f, open(bad + ".sig.json", "wb") as g:
        g.write(f.read())
    tampered[victim]["module"] = f"file://{bad}"
    bad_policies = rig.write_policies("tampered.json", tampered)
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args

    try:
        server_from_args(build_cli().parse_args(
            rig.args(bad_policies, "store-tampered")
        ))
        fail("phase13: the tampered artifact booted")
    except Exception as e:  # noqa: BLE001 — the expected failure
        text = f"{type(e).__name__}: {e}"
    if not (text.startswith("VerificationError: artifact ")
            and "failed verification" in text):
        fail(f"phase13: the tampered artifact failed the boot with {text}")
    out["tampered"] = text
    server, _boot = boot_server(
        rig.args(bad_policies, "store-tampered") + ["--continue-on-errors"],
        "phase13 tampered --continue-on-errors",
    )
    try:
        orc, _r = rig.oracle(tampered, "store-tampered", continue_on_errors=True)
        wave_t = wave_of(work_docs, FETCH_NEGATIVE_WAVE, "t13")
        run = served_wave(server, wave_t,
                          [[expected_answer(orc, p, b) for p, b in wave_t]],
                          "phase13 tampered --continue-on-errors", kernel_only=False)
        errors = dict(server.env._init_errors)
    finally:
        server.stop()
    if list(errors) != [victim]:
        fail(f"phase13: init errors {errors}, not only {victim}")
    print(
        f"phase13 tampered artifact: the boot fails with {text[:160]}...; under "
        f"--continue-on-errors {victim} answers its init error and the other "
        f"{len(tampered) - 1} ids serve ({run['answered']} bodies equal the "
        f"oracle's) [{card}]"
    )
    before = retry_stats()
    failpoints.configure("fetch.http=raise:registry unreachable")
    try:
        try:
            server_from_args(build_cli().parse_args(rig.args(policies, "store-fp")))
            fail("phase13: the boot survived fetch.http faults")
        except Exception as e:  # noqa: BLE001 — the expected failure
            text = f"{type(e).__name__}: {e}"
    finally:
        failpoints.reset()
    after = retry_stats()
    counted = {k: after[k] - before[k] for k in after}
    if counted != {"attempts": 3, "giveups": 1} or not (
        text.startswith("FetchError: GET ") and text.endswith("registry unreachable")
    ):
        fail(f"phase13 fetch.http: {text}, retries {counted}")
    out["failpoint"] = {"error": text, "retries": counted}
    print(
        f"phase13 fetch.http faults: {counted['attempts']} retries counted, "
        f"{counted['giveups']} give-up, then {text} [{card}]"
    )
    return out


def context_docs(work_docs: list, names: list, n: int, tag: str) -> list:
    """``n`` (policy id, body) pairs: every other one to namespace-exists,
    the rest to the flagship ids, each review moved into one of ``names``."""
    out = []
    for i in range(n):
        pid, d = work_docs[i % len(work_docs)]
        d = copy.deepcopy(d)
        ns = names[(i * 7) % len(names)]
        d["request"]["namespace"] = ns
        obj = d["request"].get("object") or {}
        if isinstance(obj.get("metadata"), dict):
            obj["metadata"]["namespace"] = ns
        d["request"]["uid"] = f"{d['request']['uid']}-{tag}-{i}"
        out.append(("namespace-exists" if i % 2 == 0 else pid,
                    json.dumps(d).encode()))
    return out


def context_oracle(specs: dict, objects: list):
    from policy_server_tpu_torch.context import (
        ContextSnapshotService,
        StaticContextFetcher,
    )
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import (
        ContextAwareResource,
        parse_policies,
    )

    service = ContextSnapshotService(
        StaticContextFetcher({"v1/Namespace": list(objects)}),
        wanted=[ContextAwareResource("v1", "Namespace")],
    )
    service.refresh()
    return EvaluationEnvironmentBuilder(
        backend="oracle", context_service=service
    ).build(parse_policies(specs))


def hold_context_rows(specs: dict, n_namespaces: int, work_docs: list,
                      card: str) -> dict:
    """K1 on rows that carry a ``__context__`` slice of ``n_namespaces``
    namespaces against its plain version at B = 128 (namespace-exists
    beside the flagship set, both buckets, narrow) → timings and error."""
    import torch

    import torch_fetch_fixtures as fx
    from policy_server_tpu_torch.context import (
        ContextSnapshotService,
        StaticContextFetcher,
    )
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.evaluation.policy_id import PolicyID
    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.models import ValidateRequest
    from policy_server_tpu_torch.models.policy import (
        ContextAwareResource,
        parse_policies,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    names = [f"ns-{i}" for i in range(n_namespaces)]
    service = ContextSnapshotService(
        StaticContextFetcher({"v1/Namespace": [fx.namespace(n) for n in names]}),
        wanted=[ContextAwareResource("v1", "Namespace")],
    )
    service.refresh()
    env = EvaluationEnvironmentBuilder(
        device="cuda", context_service=service
    ).build(parse_policies(specs))
    target = env._lookup_top_level(PolicyID.parse("namespace-exists"))
    out = {"namespaces": n_namespaces, "err": 0, "rows": {}}
    for idx, schema in enumerate(env.schemas):
        encs, ghosts = [], 0
        for i, (_pid, d) in enumerate(work_docs):
            d = widen(d) if idx == 1 else copy.deepcopy(d)
            d["request"]["namespace"] = names[i % n_namespaces] if i % 4 else "ghost"
            req = ValidateRequest.from_admission(
                AdmissionReviewRequest.from_dict(d).request
            )
            got_idx, enc = env.encode_bucketed(env.payload_for(target, req))
            if got_idx == idx:
                encs.append(enc)
                ghosts += i % 4 == 0
            if len(encs) == 128:
                break
        if len(encs) < 128:
            fail(f"phase13 context rows: {len(encs)} rows in bucket {idx}")
        wide = schema.pack(schema.stack(encs, batch_size=128))
        buf = schema.to_transport(wide, vocab_size=len(env.table))["__packed__"]
        program = env.program_for(idx, True, True)
        dev = torch.from_numpy(buf).to("cuda")
        want_a, want_r = ck.policy_matrix_plain(dev, program)
        got_a, got_r = ck.policy_matrix(dev, program)
        torch.cuda.synchronize()
        if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
            fail(f"phase13: policy_matrix disagrees with its plain version on "
                 f"context rows ({n_namespaces} namespaces, bucket {idx})")
        col = program.column_of.get("namespace-exists")
        rejected = int((~want_a[:, col]).sum()) if col is not None else -1
        ms = time_cuda(lambda: ck.policy_matrix(dev, program), 20)
        out["rows"][idx] = {
            "width": int(buf.shape[1]), "ms": ms,
            "device_ms": graph_ms(lambda: ck.policy_matrix(dev, program)),
            "plain_ms": time_cuda(
                lambda: ck.policy_matrix_plain(dev, program), 2, warmup=1
            ),
            "namespace_exists_rejected": rejected,
        }
        if rejected != ghosts:
            fail(f"phase13 context rows: namespace-exists rejected {rejected} "
                 f"of 128 rows, not the {ghosts} sent outside the cluster")
    env.close()
    print(
        f"phase13 context rows ({n_namespaces} namespaces in __context__): "
        f"policy_matrix exact against its plain version at B=128: "
        f"{json.dumps(out['rows'])} [{card}]"
    )
    return out


def context_waves(work_docs: list, card: str) -> dict:
    """Wave C (see the module docstring)."""
    import pathlib

    import torch_fetch_fixtures as fx
    from policy_server_tpu_torch.context import service as ctx_service
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    specs = flagship_policy_specs()
    specs["namespace-exists"] = {
        "module": "builtin://namespace-exists", "contextAwareResources": NS_AWARE,
    }
    work_dir = pathlib.Path(FETCH_DIR) / "context"
    work_dir.mkdir(parents=True, exist_ok=True)
    with open(work_dir / "policies.json", "w") as f:
        json.dump(specs, f)
    out: dict = {"holds": [hold_context_rows(specs, n, work_docs, card)
                           for n in CONTEXT_HOLD_NAMESPACES]}
    names = [f"team-{i:03d}" for i in range(CONTEXT_NAMES)]
    path = fx.list_path("v1", "Namespace")
    saved = (ctx_service.SERVICE_ACCOUNT_DIR, ctx_service.KUBE_API_SERVER)
    api = fx.KubeApi(work_dir / "kube")
    servers = []
    try:
        api.register(path, [fx.namespace(n) for n in names[:CONTEXT_NAMESPACES]])
        ctx_service.SERVICE_ACCOUNT_DIR = api.write_service_account(work_dir / "sa")
        ctx_service.KUBE_API_SERVER = api.url
        base = ["--policies", str(work_dir / "policies.json"), "--addr",
                "127.0.0.1", "--port", "0", "--readiness-probe-port", "0",
                "--enable-metrics", "--frontend", "native"]
        default, _b = boot_server(base, "phase13 wave C default flags")
        servers.append(default)
        kernel, _b = boot_server(base + KERNEL_ONLY_ARGS, "phase13 wave C kernel-only")
        servers.append(kernel)
        live = [fx.namespace(n) for n in names[:CONTEXT_NAMESPACES]]
        oracle = context_oracle(specs, live)
        wave1 = context_docs(work_docs, names, CONTEXT_WAVE, "c1")
        exp1 = [expected_answer(oracle, p, b) for p, b in wave1]
        out["C1"] = {
            "default": served_wave(default, wave1, [exp1], "phase13 wave C1 default",
                                   kernel_only=False),
            "kernel": served_wave(kernel, wave1, [exp1], "phase13 wave C1 kernel-only",
                                  kernel_only=True),
        }
        # 20 DELETED, 20 ADDED; the time from an event's send to the first
        # answer that reflects it
        for n in names[:CONTEXT_EVENTS]:
            api.delete(path, fx.namespace(n))
        added = names[CONTEXT_NAMESPACES:CONTEXT_NAMESPACES + CONTEXT_EVENTS]
        rvs = [api.add(path, fx.namespace(n)) for n in added]
        probe_doc = copy.deepcopy(work_docs[0][1])
        probe_doc["request"]["namespace"] = added[-1]
        lags = {}
        for label, server in (("default", default), ("kernel", kernel)):
            t_sent = api.sent_at[rvs[-1]]
            while True:
                conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
                try:
                    conn.request("POST", "/validate/namespace-exists",
                                 body=json.dumps(probe_doc).encode(),
                                 headers={"Content-Type": "application/json"})
                    answer = json.loads(conn.getresponse().read())
                finally:
                    conn.close()
                if answer["response"]["allowed"]:
                    break
                if time.monotonic() - t_sent > 60:
                    fail(f"phase13: {label} never answered the added namespace")
                time.sleep(0.005)
            lags[label] = time.monotonic() - t_sent
        want = sorted(names[CONTEXT_EVENTS:CONTEXT_NAMESPACES + CONTEXT_EVENTS])
        for server in servers:
            wait_until(lambda: sorted(
                o["metadata"]["name"]
                for o in server.context_service.snapshot().resources["v1/Namespace"]
            ) == want, 60, "the snapshot after the events")
        live = [fx.namespace(n) for n in want]
        oracle2 = context_oracle(specs, live)
        wave2 = context_docs(work_docs, names, CONTEXT_WAVE, "c2")
        exp2 = [expected_answer(oracle2, p, b) for p, b in wave2]
        if exp2 == [expected_answer(oracle, p, b) for p, b in wave2]:
            fail("phase13: the events change no answer of wave C2")
        out["C2"] = {
            "default": served_wave(default, wave2, [exp2], "phase13 wave C2 default",
                                   kernel_only=False),
            "kernel": served_wave(kernel, wave2, [exp2], "phase13 wave C2 kernel-only",
                                  kernel_only=True),
        }
        out["event_to_answer_s"] = lags
        for s in servers:
            s.stop()
        servers.clear()
        api.stop()

        # 257 namespaces: every context row overflows to the host
        api = fx.KubeApi(work_dir / "kube-257")
        over = [f"wide-{i:03d}" for i in range(CONTEXT_OVERFLOW)]
        api.register(path, [fx.namespace(n) for n in over])
        ctx_service.SERVICE_ACCOUNT_DIR = api.write_service_account(work_dir / "sa-257")
        ctx_service.KUBE_API_SERVER = api.url
        server, _b = boot_server(base + KERNEL_ONLY_ARGS, "phase13 wave C 257")
        servers.append(server)
        oracle3 = context_oracle(specs, [fx.namespace(n) for n in over])
        wave3 = [
            ("namespace-exists", b)
            for _p, b in context_docs(work_docs, over + ["ghost"],
                                      2 * CONTEXT_OVERFLOW_WAVE, "c3")[::2]
        ]
        exp3 = [expected_answer(oracle3, p, b) for p, b in wave3]
        run = served_wave(server, wave3, [exp3], "phase13 wave C 257 namespaces",
                          kernel_only=True, expect_launches=False)
        if run["oracle_fallbacks"] != len(wave3):
            fail(f"phase13: {run['oracle_fallbacks']} of {len(wave3)} rows "
                 "overflowed at 257 namespaces")
        out["C257"] = run
    finally:
        for s in servers:
            s.stop()
        api.stop()
        ctx_service.SERVICE_ACCOUNT_DIR, ctx_service.KUBE_API_SERVER = saved
    for name in ("C1", "C2"):
        for label in ("default", "kernel"):
            r = out[name][label]
            print(
                f"phase13 wave {name} {label}: {r['answered']} reviews over "
                f"{CONTEXT_NAMES} namespace names, every body the oracle's with "
                f"the same snapshot; {r['req_s']:.1f} req/s p50 {r['p50']:.3f} "
                f"p99 {r['p99']:.3f} ms; {r['batches']} batches "
                f"({r['host_batches']} host-routed), policy_matrix "
                f"{r['serving_launches']} launches [{card}]"
            )
    print(
        f"phase13 wave C events: {CONTEXT_EVENTS} DELETED + {CONTEXT_EVENTS} "
        f"ADDED; seconds from the last event's send to the first answer that "
        f"reflects it: {json.dumps(lags)} [{card}]"
    )
    r = out["C257"]
    print(
        f"phase13 wave C {CONTEXT_OVERFLOW} namespaces: {r['answered']} "
        f"namespace-exists reviews, all {r['oracle_fallbacks']} rows to the "
        f"host oracle, {r['batches']} batches, policy_matrix "
        f"{r['serving_launches']} launches, every body the oracle's [{card}]"
    )
    return out


def watch_wave(work_docs: list, card: str) -> dict:
    """Wave W (see the module docstring)."""
    import pathlib

    import torch

    import torch_fetch_fixtures as fx
    from policy_server_tpu_torch.audit import resource_key, synthesize_review
    from policy_server_tpu_torch.context import service as ctx_service
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    work_dir = pathlib.Path(FETCH_DIR) / "watch"
    work_dir.mkdir(parents=True, exist_ok=True)
    specs = flagship_policy_specs()
    with open(work_dir / "policies.json", "w") as f:
        json.dump(specs, f)
    objects = audit_inventory(WATCH_OBJECTS, seed=13)
    for obj in objects:
        obj["metadata"]["uid"] = f"uid-{obj['metadata']['name']}"
    path = fx.list_path("v1", "Pod")
    api = fx.KubeApi(work_dir / "kube")
    api.register(path, copy.deepcopy(objects))
    saved = (ctx_service.SERVICE_ACCOUNT_DIR, ctx_service.KUBE_API_SERVER)
    ctx_service.SERVICE_ACCOUNT_DIR = api.write_service_account(work_dir / "sa")
    ctx_service.KUBE_API_SERVER = api.url
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(parse_policies(specs))
    policy_ids = sorted(specs)
    out: dict = {}
    server = None
    try:
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        server, boot = boot_server([
            "--policies", str(work_dir / "policies.json"), "--addr", "127.0.0.1",
            "--port", "0", "--readiness-probe-port", "0", "--enable-metrics",
            "--frontend", "native", "--audit-mode", "interval",
            "--audit-interval-seconds", "1", "--audit-watch",
            "--audit-watch-resources", "v1/Pod", "--context-refresh-seconds", "5",
        ], "phase13 wave W")
        scanner, feed = server.state.audit, server.state.audit_watch
        rp = server.readiness_port
        wait_until(lambda: len(scanner.snapshot) == WATCH_OBJECTS, 120,
                   "the watch feed's LIST")
        wait_until(lambda: scanner.stats()["full_sweeps"] >= 1, 600, "the boot sweep")
        settle(scanner, "the boot sweep")
        out["boot_sweep_s"] = time.perf_counter() - t0
        b0 = server.batcher.stats_snapshot()
        launches0 = ck.launch_counts()["policy_matrix"]
        rng = random.Random(13)
        alive = {o["metadata"]["name"]: o for o in objects}
        fresh = iter(audit_inventory(WATCH_OBJECTS + WATCH_EVENTS, seed=29)[WATCH_OBJECTS:])
        sent: list = []  # (etype, key, rv)

        def one_event() -> None:
            kind = rng.choice(("ADDED", "MODIFIED", "DELETED"))
            if kind == "ADDED" or not alive:
                obj = next(fresh)
                obj["metadata"]["name"] += "-w13"
                obj["metadata"]["uid"] = f"uid-{obj['metadata']['name']}"
                rv = api.add(path, obj)
                alive[obj["metadata"]["name"]] = obj
                kind = "ADDED"
            elif kind == "MODIFIED":
                name = rng.choice(sorted(alive))
                obj = copy.deepcopy(alive[name])
                obj["metadata"].setdefault("labels", {})["w13"] = str(rng.random())
                rv = api.modify(path, obj)
                alive[name] = obj
            else:
                name = rng.choice(sorted(alive))
                obj = alive.pop(name)
                rv = api.delete(path, obj)
            sent.append((kind, resource_key(synthesize_review(obj, "UPDATE")), rv))

        rows = scanner.reports._rows  # (resource, policy) → row
        lags: list = []

        def event_lags(events: list) -> None:
            """Seconds from each object's last event's send to its report
            row's stamp (deleted objects have no row)."""
            last = {key: (kind, rv) for kind, key, rv in events}
            for key, (kind, rv) in last.items():
                if kind == "DELETED":
                    continue
                row = rows.get((key, policy_ids[0]))
                if row is None:
                    fail(f"phase13 wave W: no report row for {key}")
                lags.append(row["scanned_at"] - api.sent_wall[rv])

        # each half is measured once its dirty sweeps have settled, so no
        # later sweep re-stamps its rows; the 410 between them re-LISTs
        # the kind, and the re-LIST records (so dirties) every object
        half = WATCH_EVENTS // 2
        for _ in range(half):
            one_event()
        wait_until(lambda: feed.stats()["events_applied"] >= half, 120,
                   "the first half of the events")
        settle(scanner, "the first half's dirty sweeps")
        event_lags(sent)
        api.expire(path)
        t_resync = time.perf_counter()
        # the boot LIST was the first replace; the resync's is the second
        wait_until(lambda: feed.stats()["resyncs"] >= 1
                   and feed.stats()["replaces"] >= 2
                   and feed.stats()["queue_depth"] == 0, 120, "the 410 resync")
        settle(scanner, "the resync's sweep")
        out["resync_sweep_s"] = time.perf_counter() - t_resync
        resync_at = len(sent)
        for _ in range(WATCH_EVENTS - half):
            one_event()
        wait_until(lambda: feed.stats()["events_applied"] >= WATCH_EVENTS, 120,
                   "the second half of the events")
        wait_until(lambda: len(scanner.snapshot) == len(alive), 60,
                   "the snapshot to match the cluster")
        settle(scanner, "the events' dirty sweeps")
        event_lags(sent[resync_at:])
        stats = feed.stats()
        if (stats["events_applied"], stats["events_dropped"], stats["resyncs"]) != (
            WATCH_EVENTS, 0, 1
        ):
            fail(f"phase13 wave W: the feed counted {stats}")
        families = {
            name: metric_value(rp, f"policy_server_audit_{name}_total")
            for name in ("watch_events_applied", "watch_events_dropped",
                         "watch_resyncs")
        }
        if families != {"watch_events_applied": float(WATCH_EVENTS),
                         "watch_events_dropped": 0.0, "watch_resyncs": 1.0}:
            fail(f"phase13 wave W: /metrics watch families read {families}")
        summary = check_reports("wave W", rp, scanner, oracle, policy_ids,
                                {}, 0, card, phase="phase13")
        lags.sort()
        b1 = server.batcher.stats_snapshot()
        out.update({
            "boot": boot, "feed": stats, "families": families, "summary": summary,
            "event_to_report_p50_s": lags[len(lags) // 2],
            "event_to_report_p99_s": lags[min(len(lags) - 1, int(0.99 * len(lags)))],
            "audit_batches": b1["audit_batches_dispatched"] - b0["audit_batches_dispatched"],
            "audit_launches": ck.launch_counts()["policy_matrix"] - launches0,
        })
        # rows the verdict cache answers launch nothing (the resync's
        # re-judge of unchanged objects), so a batch may launch no K1
        if out["audit_batches"] < 1 or out["audit_launches"] < 1:
            fail(f"phase13 wave W: {out['audit_batches']} audit batches, "
                 f"{out['audit_launches']} policy_matrix launches")
    finally:
        if server is not None:
            server.stop()
        api.stop()
        ctx_service.SERVICE_ACCOUNT_DIR, ctx_service.KUBE_API_SERVER = saved
    torch.cuda.synchronize()
    out["launches"] = ck.launch_counts()
    print(
        f"phase13 wave W: {WATCH_OBJECTS} pods listed, boot sweep "
        f"{out['boot_sweep_s']:.1f} s; {WATCH_EVENTS} ADDED/MODIFIED/DELETED "
        f"events with one 410 (feed {json.dumps(out['feed'])}, /metrics "
        f"{json.dumps(out['families'])}; the 410's re-LIST re-judged the "
        f"inventory in {out['resync_sweep_s']:.1f} s); every report row the "
        f"oracle's; "
        f"event to report row p50 {out['event_to_report_p50_s']:.3f} s p99 "
        f"{out['event_to_report_p99_s']:.3f} s over {len(lags)} objects; audit "
        f"lane {out['audit_batches']} batches, policy_matrix "
        f"{out['audit_launches']} launches for the events [{card}]"
    )
    return out


def acquisition_phase(rig: FetchRig, work_docs: list, card: str) -> dict:
    """Phase 13 (see the module docstring) → its numbers for the kernels
    line. The rig's sources stay up for phase 14."""
    out = {"fetch": fetch_waves(rig, work_docs, card)}
    out["context"] = context_waves(work_docs, card)
    out["watch"] = watch_wave(work_docs, card)
    return out


RECOVERY_DIR = os.path.join(REPO, "build", "chip_smoke_recovery")
RECOVERY_WAVE = 1024
RECOVERY_KILL_WAVE = 256
RECOVERY_SMALL_WAVE = 256
# the dispatch loop's stall that holds the kill wave in flight: every row
# waits in the batcher's queue, and the kill comes once all are there
RECOVERY_STALL_SECONDS = 30.0
SHARD_FAMILIES = (
    "policy_server_shard_fences_total", "policy_server_shard_rerouted_rows_total",
    "policy_server_shard_fenced_rows_total", "policy_server_shard_respawns_total",
    "policy_server_shard_heartbeat_faults_total",
)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def recovery_server_main(argv: list[str]) -> int:
    """The server process of phases 14 and 15: ``python -m
    policy_server_tpu_torch ARGS`` run in this process (``runpy``), with
    one addition: on SIGUSR1 it reads the JSON command in CONTROL
    (``{"seq": n, "op": ..., ...}``), applies it and writes ``{"seq": n,
    "counts": ..., ...}`` (the kernel wrappers' launch counts and the op's
    answer) to COUNTS. Ops: ``counts``; ``reset`` sets the launch counts
    to 0; ``stall`` arms a ``shard.dispatch`` sleep (the dispatch loop
    stops popping its queue); ``kill-shard`` arms one ``shard.dispatch``
    raise in a shard's scope; ``audit`` answers the audit side's facts
    (``audit_facts``), and with ``dump`` writes its rows, report rows and
    matrix cells to that file; ``spill`` forces the matrix and snapshot
    spills on a thread; ``otlp`` answers the span processor's drops. A
    command with ``hold`` holds the cadence spills off (true) or lets them
    run again (false). Where ``CHIP_SMOKE_KUBE_API`` is set, the in-cluster client reads that
    API server with the service account in ``CHIP_SMOKE_KUBE_SA``. ARGV is
    CONTROL COUNTS then the server's arguments."""
    import runpy
    import signal

    control, counts_path = argv[0], argv[1]
    sys.path.insert(0, REPO)
    from policy_server_tpu_torch import failpoints
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    if os.environ.get("CHIP_SMOKE_KUBE_API"):
        import pathlib

        from policy_server_tpu_torch.context import service as ctx_service

        ctx_service.KUBE_API_SERVER = os.environ["CHIP_SMOKE_KUBE_API"]
        ctx_service.SERVICE_ACCOUNT_DIR = pathlib.Path(
            os.environ["CHIP_SMOKE_KUBE_SA"]
        )
    facts = instrument_audit_side()

    def die() -> None:
        raise RuntimeError("chip smoke: shard killed")

    def on_signal(_signum, _frame) -> None:
        with open(control) as f:
            cmd = json.load(f)
        answer: dict = {}
        if "hold" in cmd:
            facts["hold"] = cmd["hold"]
        if cmd["op"] == "reset":
            ck.reset_launch_counts()
        elif cmd["op"] == "stall":
            failpoints.configure(f"shard.dispatch=sleep:{cmd['seconds']}")
        elif cmd["op"] == "kill-shard":
            failpoints.set_failpoint("shard.dispatch", die, count=1,
                                     scope=cmd["scope"])
        elif cmd["op"] == "audit":
            answer = audit_facts(facts, cmd.get("dump"))
        elif cmd["op"] == "spill":
            threading.Thread(target=force_spills, args=(facts,),
                             daemon=True).start()
        elif cmd["op"] == "otlp":
            from policy_server_tpu_torch.telemetry import otlp

            proc = otlp.processor()
            answer = {"dropped": None if proc is None else proc.dropped,
                      "tracer": otlp.tracer() is not None}
        tmp = counts_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"seq": cmd["seq"], "counts": ck.launch_counts(),
                       **answer}, f)
        os.replace(tmp, counts_path)

    signal.signal(signal.SIGUSR1, on_signal)
    sys.argv = ["policy_server_tpu_torch", *argv[2:]]
    runpy.run_module("policy_server_tpu_torch", run_name="__main__",
                     alter_sys=True)
    return 0


class RecoveryServer:
    """One server process of phases 14 and 15 (``recovery_server_main``) on
    free ports, waited for until /readiness answers 200: ``wall_ready_s``
    runs from the process's start (``started``, on the perf_counter clock)
    to that answer. ``env`` is added to this process's environment."""

    def __init__(self, argv: list, label: str, work_dir: str = RECOVERY_DIR,
                 env: dict | None = None, wait: bool = True) -> None:
        self.label = label
        self.port, self.readiness_port = free_port(), free_port()
        tag = label.replace(" ", "-")
        self.control = os.path.join(work_dir, f"{tag}.control")
        self.counts = os.path.join(work_dir, f"{tag}.counts")
        self.log = os.path.join(work_dir, f"{tag}.log")
        self.seq = 0
        self.started = time.perf_counter()
        with open(self.log, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--recovery-server",
                 self.control, self.counts, *argv, "--port", str(self.port),
                 "--readiness-probe-port", str(self.readiness_port)],
                stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, **(env or {})),
            )
        if wait:
            self.wait_ready()

    def wait_ready(self) -> None:
        """Wait until /readiness answers 200 (``wall_ready_s``)."""
        deadline = time.monotonic() + 300
        while True:
            if self.proc.poll() is not None:
                fail(f"{self.label}: the server exited {self.proc.returncode}:"
                     f" {self.tail()}")
            try:
                if http_get(self.readiness_port, "/readiness")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                self.kill()
                fail(f"{self.label}: /readiness never answered 200: "
                     f"{self.tail()}")
            time.sleep(0.05)
        self.wall_ready_s = time.perf_counter() - self.started

    def tail(self) -> str:
        with open(self.log, "rb") as f:
            return f.read()[-3000:].decode("utf-8", "replace")

    def command(self, op: str, **kw) -> dict:
        """Send one command (``recovery_server_main``) → the launch counts
        it answered with."""
        return self.ask(op, **kw)["counts"]

    def ask(self, op: str, wait: float = 30.0, **kw) -> dict:
        """Send one command → its whole answer (within ``wait`` seconds)."""
        import signal

        self.seq += 1
        with open(self.control, "w") as f:
            json.dump({"seq": self.seq, "op": op, **kw}, f)
        os.kill(self.proc.pid, signal.SIGUSR1)
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline:
            try:
                with open(self.counts) as f:
                    doc = json.load(f)
                if doc["seq"] == self.seq:
                    return doc
            except (OSError, ValueError):
                pass
            time.sleep(0.02)
        fail(f"{self.label}: the server did not answer command {op}")
        return {}

    def metric(self, name: str) -> float:
        return metric_value(self.readiness_port, name)

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(30)

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGINT)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.kill()


def recovery_wave(server: RecoveryServer, wave: list, expectations: list,
                  label: str) -> dict:
    """A kernel-only wave from the ``--native-client`` process: every body
    must equal the oracle's, no batch may be host-routed, and every
    micro-batch must launch K1 (the launch counts set to 0 just before the
    wave, read just after; beside them the batches and shard 0's device
    dispatches on /metrics)."""
    m = "policy_server_{}_total".format
    b0 = {k: server.metric(m(k)) for k in
          ("batches_dispatched", "host_fastpath_batches", "pallas_dispatches")}
    server.command("reset")
    t0 = time.perf_counter()
    results = client_wave(server.port, wave, label.replace(" ", "-"))
    wall = time.perf_counter() - t0
    time.sleep(0.1)  # the last batch's bookkeeping lands after delivery
    counts = server.command("counts")
    b1 = {k: server.metric(m(k)) for k in b0}
    run = check_wave(label, results, wave, expectations)
    run.update({
        "req_s": len(wave) / wall,
        "batches": int(b1["batches_dispatched"] - b0["batches_dispatched"]),
        "host_batches": int(
            b1["host_fastpath_batches"] - b0["host_fastpath_batches"]
        ),
        "dispatches": int(b1["pallas_dispatches"] - b0["pallas_dispatches"]),
        "serving_launches": counts["policy_matrix"],
        "probe_launches": counts["probe"],
    })
    if run["host_batches"] or not run["batches"] or (
        run["serving_launches"] < run["batches"]
    ):
        fail(f"{label}: {run['batches']} batches ({run['host_batches']} "
             f"host-routed), {run['dispatches']} device dispatches, "
             f"policy_matrix {run['serving_launches']} launches")
    return run


def boot_numbers(server: RecoveryServer) -> dict:
    """The boot families on /metrics and K2's launches at the build."""
    m = server.metric
    return {
        "ttr_metric_s": m("policy_server_boot_time_to_ready_seconds"),
        "ttr_wall_s": server.wall_ready_s,
        "warm": m("policy_server_boot_warm"),
        "degraded_sources": m("policy_server_boot_degraded_sources"),
        "cache_hits": m("policy_server_statestore_artifact_cache_hits_total"),
        "cache_misses": m(
            "policy_server_statestore_artifact_cache_misses_total"
        ),
        "quarantined": m("policy_server_statestore_fsck_quarantined_total"),
        "artifacts_resident": m("policy_server_statestore_artifacts_resident"),
        "build_launches": server.command("counts"),
    }


def recovery_phase(rig: FetchRig, work_docs: list, card: str) -> dict:
    """Phase 14 (see the module docstring) → its numbers."""
    import shutil

    shutil.rmtree(RECOVERY_DIR, ignore_errors=True)
    os.makedirs(RECOVERY_DIR)
    state = os.path.join(RECOVERY_DIR, "state")
    v1 = rig.tagged("v1")
    drop = next(n for n in sorted(v1) if n not in rig.where)
    changed = {k: v for k, v in v1.items() if k != drop}
    policies = os.path.join(RECOVERY_DIR, "policies.json")
    with open(policies, "w") as f:
        json.dump(v1, f)
    # the oracles over the same artifacts, fetched while the sources are up
    oracle, _r = rig.oracle(v1, "oracle-store-14")
    oracle_changed, _r2 = rig.oracle(changed, "oracle-store-14c")
    wave = wave_of(work_docs, RECOVERY_WAVE, "c14")
    exp = [expected_answer(oracle, pid, b) for pid, b in wave]

    def argv(download: str, *extra: str) -> list:
        args = rig.args(policies, download) + KERNEL_ONLY_ARGS + [
            "--state-dir", state, *extra,
        ]
        # the ports are the process's own (RecoveryServer)
        for flag in ("--port", "--readiness-probe-port"):
            i = args.index(flag)
            del args[i:i + 2]
        return args

    out: dict = {}
    servers: list = []

    def boot(label: str, *extra: str, download: str = "dl") -> RecoveryServer:
        server = RecoveryServer(
            argv(os.path.join(RECOVERY_DIR, download), *extra), label
        )
        servers.append(server)
        return server

    try:
        # 1. the cold boot fetches all 27 artifacts and fills the store
        cold = boot("phase14 cold")
        out["cold"] = boot_numbers(cold)
        out["cold"]["wave"] = recovery_wave(cold, wave, [exp], "phase14 cold wave")
        # 2. SIGKILL with a wave in flight: the dispatch loop stalls (its
        # running iteration ends first), and the kill comes once every row
        # waits in the queue
        kill_wave = wave_of(work_docs, RECOVERY_KILL_WAVE, "k14")
        cold.command("stall", seconds=RECOVERY_STALL_SECONDS)
        time.sleep(0.2)
        # one request per connection: the standard-library frontend reads
        # a connection's next request only after answering the last
        proc, path = start_client(cold.port, kill_wave, "phase14-kill",
                                  tolerate_close=True, work_dir=RECOVERY_DIR,
                                  conns=RECOVERY_KILL_WAVE, depth=1)
        deadline = time.monotonic() + 20
        admitted = 0.0
        while time.monotonic() < deadline:
            admitted = cold.metric("policy_server_queue_depth")
            if admitted >= RECOVERY_KILL_WAVE:
                break
            time.sleep(0.02)
        cold.kill()
        killed = finish_client(proc, path, "phase14 kill wave")
        answered = sum(r is not None for r in killed)
        out["kill"] = {"admitted": admitted, "answered": answered,
                       "returncode": cold.proc.returncode}
        if answered:
            fail(f"phase14: {answered} of the kill wave's requests were "
                 "answered before the SIGKILL")
        # 3. the warm boot: the sources down, the file:// artifacts gone,
        # the network failpoint armed; a fresh download directory stays
        # empty (no fetch)
        rig.stop()
        for name, where in rig.where.items():
            if where == "file":
                src = v1[name]["module"][len("file://"):]
                os.unlink(src)
                os.unlink(src + ".sig.json")
        os.environ["FAILPOINTS"] = "fetch.http=raise:the sources are down"
        try:
            warm = boot("phase14 warm", download="dl-warm")
        finally:
            del os.environ["FAILPOINTS"]
        out["warm"] = boot_numbers(warm)
        fetched = os.listdir(os.path.join(RECOVERY_DIR, "dl-warm")) if os.path.isdir(
            os.path.join(RECOVERY_DIR, "dl-warm")) else []
        out["warm"]["downloads"] = len(fetched)
        w = out["warm"]
        if (w["warm"] != 1 or w["cache_hits"] != len(rig.artifacts)
                or w["quarantined"] or w["degraded_sources"] or fetched
                or w["build_launches"]["probe"] < 1):
            fail(f"phase14 warm boot: {json.dumps(w)}")
        w["wave"] = recovery_wave(warm, wave, [exp], "phase14 warm wave")
        warm.stop()
        # 4. a changed policies file with the sources still down: every
        # artifact degrades loudly to its cached bytes
        with open(policies, "w") as f:
            json.dump(changed, f)
        degraded = boot("phase14 changed", download="dl-changed")
        out["changed"] = boot_numbers(degraded)
        if out["changed"]["degraded_sources"] < 1:
            fail(f"phase14 changed file: {json.dumps(out['changed'])}")
        small = wave_of([(p, d) for p, d in work_docs if p != drop],
                        RECOVERY_SMALL_WAVE, "d14")
        out["changed"]["wave"] = recovery_wave(
            degraded, small, [[expected_answer(oracle_changed, p, b)
                               for p, b in small]],
            "phase14 changed wave",
        )
        degraded.stop()
        # 5. a flipped byte in the newest manifest record: quarantined, and
        # the boot lands on the generation before it (the first file's),
        # with two serving shards for step 6
        journal = os.path.join(state, "manifests.journal")
        with open(journal, "rb") as f:
            data = bytearray(f.read())
        data[-10] ^= 0x01
        with open(journal, "wb") as f:
            f.write(bytes(data))
        with open(policies, "w") as f:
            json.dump(v1, f)
        flipped = boot("phase14 flipped", "--serving-shards", "2",
                       download="dl-flipped")
        out["flipped"] = boot_numbers(flipped)
        fl = out["flipped"]
        if fl["quarantined"] < 1:
            fail(f"phase14 flipped byte: nothing quarantined {json.dumps(fl)}")
        small = wave_of(work_docs, RECOVERY_SMALL_WAVE, "f14")
        exp_small = [expected_answer(oracle, p, b) for p, b in small]
        fl["wave"] = recovery_wave(flipped, small, [exp_small],
                                   "phase14 flipped wave")
        # 6. fence a shard, SIGKILL, boot again: the shard counters resume
        # from the incident journal
        flipped.command("kill-shard", scope="shard-0")
        wait_until(
            lambda: flipped.metric("policy_server_shard_respawns_total") >= 1,
            30, "phase14: the fenced shard's respawn",
        )
        before = {n: flipped.metric(n) for n in SHARD_FAMILIES}
        fenced_wave = wave_of(work_docs, RECOVERY_SMALL_WAVE, "s14")
        fl["shard_wave"] = recovery_wave(
            flipped, fenced_wave,
            [[expected_answer(oracle, p, b) for p, b in fenced_wave]],
            "phase14 fenced-shard wave",
        )
        flipped.kill()
        again = boot("phase14 shards again", "--serving-shards", "2",
                     download="dl-again")
        out["again"] = boot_numbers(again)
        after = {n: again.metric(n) for n in SHARD_FAMILIES}
        out["shards"] = {"before": before, "after": after}
        if after != before or before["policy_server_shard_fences_total"] < 1:
            fail(f"phase14 shard counters: before the crash {before}, "
                 f"after {after}")
        out["again"]["wave"] = recovery_wave(
            again, small, [exp_small], "phase14 shards-again wave"
        )
        again.stop()
    finally:
        for server in servers:
            server.kill()
    return out


def print_recovery_phase(r: dict, card: str) -> None:
    for step in ("cold", "warm", "changed", "flipped", "again"):
        b = r[step]
        run = b["wave"]
        print(
            f"phase14 {step} boot: time to ready {b['ttr_metric_s']:.3f} s "
            f"(metric) / {b['ttr_wall_s']:.3f} s (process start to "
            f"/readiness 200); warm {b['warm']:.0f}, cache hits "
            f"{b['cache_hits']:.0f}, degraded sources "
            f"{b['degraded_sources']:.0f}, quarantined {b['quarantined']:.0f}; "
            f"K2 {b['build_launches']['probe']} at the build; "
            f"{run['answered']} kernel-only reviews, every body the oracle's; "
            f"{run['req_s']:.1f} req/s p50 {run['p50']:.3f} p99 "
            f"{run['p99']:.3f} ms; {run['batches']} batches, policy_matrix "
            f"{run['serving_launches']} launches [{card}]"
        )
    k = r["kill"]
    print(
        f"phase14 SIGKILL: {k['admitted']:.0f} of {RECOVERY_KILL_WAVE} "
        f"requests admitted and in flight, {k['answered']} answered, exit "
        f"{k['returncode']} [{card}]"
    )
    print(
        f"phase14 warm boot: {r['warm']['downloads']} files downloaded; "
        f"shard counters before the crash {json.dumps(r['shards']['before'])}"
        f", after the reboot {json.dumps(r['shards']['after'])}; fenced-shard "
        f"wave policy_matrix {r['flipped']['shard_wave']['serving_launches']} "
        f"launches [{card}]"
    )


# -- phase 15: the audit side's warm resume, and the OTLP export ---------------

RESUME_DIR = os.path.join(REPO, "build", "chip_smoke_resume")
RESUME_OBJECTS = 4096
RESUME_MODIFIED = 64
RESUME_DELETED = 8
RESUME_SPILL_SECONDS = 5
RESUME_LIVE_WAVE = 1024
RESUME_KILL_WAVE = 128
RESUME_SWEEP_TIMEOUT = 400
OTLP_NATIVE_WAVE = 1024
OTLP_STDLIB_WAVE = 256


def instrument_audit_side() -> dict:
    """In a server process of phases 14 and 15: the facts ``audit_facts``
    answers. The server is captured where ``serve_forever`` starts (with
    the launch counts then: the build's and the warmup's, before the
    audit scanner starts); each spill is timed (its wall-clock start, its
    seconds in all, the state store's write and the file's bytes), and so
    is a warm boot's restore, with the rows it left dirty. While
    ``facts["hold"]`` is set the cadence spills are skipped (a quiet wave's
    baseline); a forced spill still runs. ``facts["active"]`` counts the
    spills running now."""
    from policy_server_tpu_torch import server as server_mod
    from policy_server_tpu_torch import statestore
    from policy_server_tpu_torch.audit import matrix as matrix_mod
    from policy_server_tpu_torch.audit import snapshot as snapshot_mod
    from policy_server_tpu_torch.audit import watch_feed as feed_mod
    from policy_server_tpu_torch.ops import cuda_kernels as ck

    facts: dict = {"server": None, "launches_at_start": None, "spills": [],
                   "restore": {}, "hold": False, "active": 0}
    active_lock = threading.Lock()

    def running(delta: int) -> None:
        with active_lock:
            facts["active"] += delta
    serve = server_mod.PolicyServer.serve_forever

    def serve_forever(self):
        facts["server"] = self
        facts["launches_at_start"] = ck.launch_counts()
        return serve(self)

    server_mod.PolicyServer.serve_forever = serve_forever
    writes: dict = {}

    def timed_write(name: str, rel: str) -> None:
        orig = getattr(statestore.StateStore, name)

        def write(self, *a, **kw):
            t0 = time.perf_counter()
            out = orig(self, *a, **kw)
            try:
                size = os.path.getsize(self.root / rel)
            except OSError:
                size = 0
            writes[name] = (time.perf_counter() - t0, size)
            return out

        setattr(statestore.StateStore, name, write)

    timed_write("spill_audit", statestore.StateStore.AUDIT_SPILL)
    timed_write("spill_matrix", statestore.StateStore.MATRIX_SPILL)

    def record(kind: str, start: float, t0: float, write: str,
               forced: bool) -> None:
        seconds, size = writes.pop(write, (0.0, 0))
        facts["spills"].append({
            "kind": kind, "start": start, "end": time.time(),
            "seconds": time.perf_counter() - t0, "write_s": seconds,
            "bytes": size, "forced": forced,
        })

    maybe_spill = matrix_mod.VerdictMatrix.maybe_spill

    def matrix_spill(self, force=False):
        if facts["hold"] and not force:
            return False
        start, t0 = time.time(), time.perf_counter()
        running(1)
        try:
            spilled = maybe_spill(self, force)
        finally:
            running(-1)
        if spilled:
            record("matrix", start, t0, "spill_matrix", force)
        return spilled

    matrix_mod.VerdictMatrix.maybe_spill = matrix_spill
    spill_once = feed_mod.WatchFeed._spill_once

    def feed_spill(self, forced=False):
        if facts["hold"] and not forced:
            return None
        start, t0 = time.time(), time.perf_counter()
        running(1)
        try:
            spill_once(self)
        finally:
            running(-1)
        if "spill_audit" in writes:
            record("audit", start, t0, "spill_audit", forced)
        return None

    feed_mod.WatchFeed._spill_once = feed_spill
    restore_rows = snapshot_mod.SnapshotStore.restore_rows

    def timed_restore_rows(self, pairs):
        t0 = time.perf_counter()
        n = restore_rows(self, pairs)
        facts["restore"].update(rows=n, rows_s=time.perf_counter() - t0)
        return n

    snapshot_mod.SnapshotStore.restore_rows = timed_restore_rows
    restore = matrix_mod.VerdictMatrix.restore

    def timed_restore(self):
        t0 = time.perf_counter()
        n = restore(self)
        facts["restore"].update(
            cells=n, cells_s=time.perf_counter() - t0,
            uncovered_rows=len(self.snapshot.dirty_keys()),
        )
        return n

    matrix_mod.VerdictMatrix.restore = timed_restore
    return facts


def force_spills(facts: dict) -> None:
    """The ``spill`` op: the matrix spill, then the snapshot's."""
    state = facts["server"].state
    state.audit.matrix.maybe_spill(force=True)
    if state.audit_watch is not None:
        state.audit_watch._spill_once(forced=True)


def audit_facts(facts: dict, dump: str | None) -> dict:
    """The ``audit`` op: whether the scanner has settled (no row dirty and
    no sweep running), its counters, the matrix's, the watch feed's, the
    state store's, the boot report, the launch counts at the scanner's
    start, the spills and the restore; with ``dump`` (settled only), the
    snapshot's rows, the report rows and the matrix cells written there."""
    server = facts["server"]
    if server is None:
        return {"ready": False}
    state = server.state
    scanner = state.audit
    snap = scanner.snapshot
    locked = (
        scanner._sweep_lock.acquire(timeout=120) if dump
        else scanner._sweep_lock.acquire(blocking=False)
    )
    try:
        dirty = len(snap.dirty_keys())
        out: dict = {"ready": True, "settled": bool(locked) and not dirty,
                     "dirty": dirty, "resources": len(snap)}
        if dump and out["settled"]:
            doc = {
                "rows": [[k, r.payload_json().decode()]
                         for k, r in snap.rows_snapshot()],
                "reports": [
                    [r["resource"], r["policy_id"], r["allowed"], r["mutated"],
                     r["message"], r["code"], r["error"], r["stale"]]
                    for r in scanner.report_payload()["reports"]
                ],
                "cells": [[k, p, v[0], v[1], v[2]] for (k, p), v in
                          scanner.matrix.cells_snapshot().items()],
            }
            with open(dump + ".tmp", "w") as f:
                json.dump(doc, f)
            os.replace(dump + ".tmp", dump)
        out["dumped"] = bool(dump) and out["settled"]
    finally:
        if locked:
            scanner._sweep_lock.release()
    sstats = scanner.stats()
    mstats = scanner.matrix.stats()
    feed = state.audit_watch
    fstats = feed.stats() if feed is not None else {}
    store = state.statestore.stats() if state.statestore is not None else {}
    out.update(
        scanner={k: sstats[k] for k in (
            "full_sweeps", "dirty_sweeps", "rows_scanned", "sweep_errors")},
        matrix={k: mstats[k] for k in (
            "cells_resident", "row_sweep_rows", "column_sweep_rows",
            "cells_restored", "spills")},
        feed={k: fstats.get(k) for k in (
            "events_applied", "events_dropped", "resyncs", "replaces",
            "queue_depth")},
        store={k: store.get(k) for k in (
            "audit_spills", "audit_rows_restored", "fsck_quarantined")},
        boot=dict(state.boot_report or {}),
        audit_batches=server.batcher.stats_snapshot()["audit_batches_dispatched"],
        launches_at_start=facts["launches_at_start"], spilling=facts["active"],
        spills=facts["spills"], restore=facts["restore"],
    )
    return out


def audit_until(server: RecoveryServer, what: str, cond,
                timeout: float) -> tuple[dict, float]:
    """Ask a server's audit facts every 0.25 s until ``cond(facts)`` → the
    facts and the seconds from the process's start to that answer."""
    deadline = time.monotonic() + timeout
    while True:
        facts = server.ask("audit")
        if facts.get("ready") and cond(facts):
            return facts, time.perf_counter() - server.started
        if server.proc.poll() is not None:
            fail(f"{what}: the server exited: {server.tail()}")
        if time.monotonic() > deadline:
            fail(f"{what}: not within {timeout} s: "
                 f"{json.dumps({k: v for k, v in facts.items() if k != 'spills'})}")
        time.sleep(0.25)


def audit_dump(server: RecoveryServer, label: str) -> dict:
    """The settled server's rows, report rows and matrix cells."""
    path = os.path.join(RESUME_DIR, label.replace(" ", "-") + ".dump.json")
    facts = server.ask("audit", wait=300, dump=path)
    if not facts.get("dumped"):
        fail(f"{label}: the server had not settled for the dump")
    with open(path) as f:
        doc = json.load(f)
    os.unlink(path)
    return doc


def check_compliance(label: str, doc: dict, judges: list, policy_ids: list,
                     want_keys: set, report_keys: set) -> dict:
    """Every snapshot row present (its keys ``want_keys``), every matrix
    cell the oracle's verdict of its row (no cell where the oracle errs),
    and the report rows of ``report_keys`` exactly the oracle's, none
    stale. ``judges`` is ``[(oracle, cache, keys), ...]``: the oracle that
    judges the rows of ``keys``, as its pre-eval hooks have run (the
    signature policies' audit verdicts name the images that no hook has
    verified in the judging process yet)."""
    from policy_server_tpu_torch.models import AdmissionRequest, ValidateRequest

    rows = [
        (k, ValidateRequest.from_admission(
            AdmissionRequest.from_dict(json.loads(p))))
        for k, p in doc["rows"]
    ]
    keys = {k for k, _r in rows}
    if keys != want_keys:
        fail(f"{label}: the snapshot holds {len(keys)} rows: "
             f"{len(keys - want_keys)} unexpected, {len(want_keys - keys)} "
             f"missing (e.g. {sorted(keys ^ want_keys)[:2]})")
    t0 = time.perf_counter()
    want: dict = {}
    for oracle, cache, judged in judges:
        want.update(oracle_verdicts(
            oracle, [(k, r) for k, r in rows if k in judged], policy_ids, cache,
        ))
    oracle_s = time.perf_counter() - t0
    cells = {(k, p): (a, c, m) for k, p, a, c, m in doc["cells"]}
    want_cells = {kp: (v[0], v[3], v[2]) for kp, v in want.items() if not v[4]}
    if cells != want_cells:
        bad = [kp for kp in want_cells if cells.get(kp) != want_cells[kp]]
        extra = [kp for kp in cells if kp not in want_cells]
        first = (bad or extra)[0]
        fail(f"{label}: {len(bad)} matrix cells differ from the oracle, "
             f"{len(extra)} extra (first {first}: {cells.get(first)} against "
             f"{want_cells.get(first)})")
    reports = {(r[0], r[1]): tuple(r[2:7]) for r in doc["reports"]}
    if any(r[7] for r in doc["reports"]):
        fail(f"{label}: a report row is stale")
    want_reports = {kp: v for kp, v in want.items() if kp[0] in report_keys}
    if reports != want_reports:
        bad = [kp for kp in want_reports if reports.get(kp) != want_reports[kp]]
        extra = [kp for kp in reports if kp not in want_reports]
        fail(f"{label}: {len(bad)} report rows differ from the oracle, "
             f"{len(extra)} extra")
    return {"rows": len(rows), "cells": len(cells), "report_rows": len(reports),
            "errors": sum(1 for v in want.values() if v[4]),
            "oracle_s": oracle_s}


def spill_numbers(spills: list, kind: str, since: float = 0.0) -> dict | None:
    """The newest spill of ``kind`` that started after ``since``."""
    rows = [s for s in spills if s["kind"] == kind and s["start"] >= since]
    return rows[-1] if rows else None


def resume_live_wave(server: RecoveryServer, wave: list, exp: list,
                     label: str, spill: bool) -> dict:
    """A live wave of kernel-only reviews with the cadence spills held off,
    and with ``spill`` one forced matrix and snapshot spill inside it.
    Every body is the oracle's; inside a spill a request may instead be
    answered the in-band "execution deadline exceeded" (the matrix spill
    holds the GIL for seconds, as the JAX package's does, past the 2 s
    policy timeout), and those answers are counted."""
    server.ask("audit", hold=True)
    # a spill that was running when the hold came ends first
    audit_until(server, f"{label}: the running spills",
                lambda f: not f["spilling"], 60)
    server.command("reset")
    start_wall = time.time()
    t0 = time.perf_counter()
    proc, out = start_client(server.port, wave, label.replace(" ", "-"),
                             work_dir=RESUME_DIR)
    if spill:
        time.sleep(0.3)
        server.ask("spill")
    results = finish_client(proc, out, label)
    wall = time.perf_counter() - t0
    end_wall = time.time()
    counts = server.command("counts")
    facts = server.ask("audit", hold=False)
    expectations = [exp]
    if spill:
        expectations.append([
            (200, in_band_body(b, "execution deadline exceeded", 500))
            for _p, b in wave
        ])
    run = check_wave(label, results, wave, expectations)
    run["deadline_answers"] = run["only"][1] if spill else 0
    inside = [s for s in facts["spills"]
              if s["start"] < end_wall and s["end"] > start_wall]
    if spill and sorted((s["kind"], s["forced"]) for s in inside) != [
        ("audit", True), ("matrix", True)
    ]:
        fail(f"{label}: not the two forced spills inside the wave: {inside}")
    if not spill and inside:
        fail(f"{label}: a spill ran inside the quiet wave: {inside}")
    run.update(req_s=len(wave) / wall, launches=counts["policy_matrix"],
               spills=inside)
    return run


def resume_phase(work_docs: list, card: str) -> dict:
    """Phase 15 wave A (see the module docstring) → its numbers."""
    import pathlib
    import shutil

    import torch_fetch_fixtures as fx
    from policy_server_tpu_torch.audit import resource_key, synthesize_review
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    os.makedirs(RESUME_DIR)
    work = pathlib.Path(RESUME_DIR)
    specs = flagship_policy_specs()
    policies = work / "policies.json"
    policies.write_text(json.dumps(specs))
    policy_ids = sorted(specs)
    # two oracles: ``oracle`` answers the live waves (running their pre-eval
    # hooks, as the server does); ``audit_oracle`` runs no hook, as a
    # server process that has answered no live request
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        parse_policies(specs)
    )
    audit_oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        parse_policies(specs)
    )
    objects = audit_inventory(RESUME_OBJECTS, seed=15)
    for obj in objects:
        obj["metadata"]["uid"] = f"uid-{obj['metadata']['name']}"
    path = fx.list_path("v1", "Pod")
    api = fx.KubeApi(work / "kube")
    api.register(path, copy.deepcopy(objects))
    sa = api.write_service_account(work / "sa")

    def key_of(obj: dict) -> str:
        return resource_key(synthesize_review(obj, "UPDATE"))

    inventory = {key_of(o): o for o in objects}
    live_q = wave_of(work_docs, RESUME_LIVE_WAVE, "q15")
    live_s = wave_of(work_docs, RESUME_LIVE_WAVE, "s15")
    # the firehose's DELETE reviews evict their keys (none is in the
    # inventory); the others are recorded as rows of their own
    live_keys = {
        resource_key(request_of(b)) for _p, b in live_q
        if json.loads(b)["request"]["operation"] != "DELETE"
    }
    exp_q = [expected_answer(oracle, p, b) for p, b in live_q]
    exp_s = [expected_answer(oracle, p, b) for p, b in live_s]
    state = str(work / "state")
    argv = [
        "--policies", str(policies), "--addr", "127.0.0.1", "--enable-metrics",
        "--state-dir", state, "--audit-mode", "interval",
        "--audit-interval-seconds", "1", "--audit-matrix", "--audit-watch",
        "--audit-watch-resources", "v1/Pod",
        # a long refresh: no interval re-LIST (10 refreshes) in a process
        "--context-refresh-seconds", "60",
        "--state-audit-spill-seconds", str(RESUME_SPILL_SECONDS),
        "--audit-matrix-spill-seconds", str(RESUME_SPILL_SECONDS),
        *KERNEL_ONLY_ARGS,
    ]
    env = {"CHIP_SMOKE_KUBE_API": api.url, "CHIP_SMOKE_KUBE_SA": str(sa)}
    cold_cache: dict = {}
    live_cache: dict = {}
    out: dict = {}
    servers: list = []

    def boot(label: str) -> RecoveryServer:
        server = RecoveryServer(argv, label, work_dir=RESUME_DIR, env=env)
        servers.append(server)
        return server

    def audit_launches(facts: dict, counts: dict) -> int:
        return counts["policy_matrix"] - facts["launches_at_start"]["policy_matrix"]

    # the audit oracle judges the inventory as the feed's LIST records it
    # (CREATE reviews) while the cold server boots and sweeps: the check
    # after the boot then finds each row's verdicts in the cache (keyed by
    # the payload hash, which ignores the uid)
    warm_oracle = threading.Thread(
        target=oracle_verdicts,
        args=(audit_oracle,
              [(key_of(o), synthesize_review(o, "CREATE")) for o in objects],
              policy_ids, cold_cache),
        daemon=True,
    )
    try:
        # 1-2. the cold boot LISTs the pods and judges every cell
        cold = boot("phase15 cold")
        warm_oracle.start()
        facts, ttc = audit_until(
            cold, "phase15 cold: the boot sweep",
            lambda f: f["settled"] and f["resources"] == RESUME_OBJECTS
            and f["scanner"]["full_sweeps"] >= 1, RESUME_SWEEP_TIMEOUT,
        )
        counts = cold.command("counts")
        warm_oracle.join()
        t0 = time.perf_counter()
        doc = audit_dump(cold, "phase15 cold")
        comp = check_compliance(
            "phase15 cold", doc, [(audit_oracle, cold_cache, set(inventory))],
            policy_ids, set(inventory), set(inventory),
        )
        comp["check_s"] = time.perf_counter() - t0
        out["cold"] = {
            "ttr_wall_s": cold.wall_ready_s, "compliance_s": ttc,
            "lists": api.lists.get(path, 0), "rows_scanned": facts["scanner"]["rows_scanned"],
            "audit_batches": facts["audit_batches"],
            "audit_launches": audit_launches(facts, counts),
            "build_launches": facts["launches_at_start"], "check": comp,
        }
        # 3. a spill of each kind on the cadence, then the live waves: a
        # quiet one and one with a forced spill inside it
        spilled, _s = audit_until(
            cold, "phase15: a cadence spill of each kind",
            lambda f: spill_numbers(f["spills"], "matrix")
            and spill_numbers(f["spills"], "audit"), 60,
        )
        out["cadence_spills"] = {
            k: spill_numbers(spilled["spills"], k) for k in ("matrix", "audit")
        }
        out["quiet"] = resume_live_wave(cold, live_q, exp_q,
                                        "phase15 quiet wave", spill=False)
        audit_until(cold, "phase15: the quiet wave's rows",
                    lambda f: f["settled"] and f["resources"]
                    == RESUME_OBJECTS + len(live_keys), RESUME_SWEEP_TIMEOUT)
        out["spill_wave"] = resume_live_wave(cold, live_s, exp_s,
                                             "phase15 spill wave", spill=True)
        audit_until(
            cold, "phase15: the spill wave's rows",
            lambda f: f["settled"] and f["resources"]
            == RESUME_OBJECTS + len(live_keys), RESUME_SWEEP_TIMEOUT,
        )
        # 4. once a cadence spill of each kind has covered the settled
        # state, SIGKILL with a wave in flight
        since = time.time()
        final, _s = audit_until(
            cold, "phase15: the spills after the live rows' sweep",
            lambda f: spill_numbers(f["spills"], "matrix", since)
            and spill_numbers(f["spills"], "audit", since)
            and f["settled"], 60,
        )
        spilled_rows = final["resources"]
        spilled_cells = final["matrix"]["cells_resident"]
        # CREATE reviews: an UPDATE the matrix has judged is answered at
        # admission (lookup admission), never queued
        kill_wave = []
        for pid, body in wave_of(work_docs, RESUME_KILL_WAVE, "k15"):
            d = json.loads(body)
            d["request"]["operation"] = "CREATE"
            kill_wave.append((pid, json.dumps(d).encode()))
        cold.command("stall", seconds=RECOVERY_STALL_SECONDS)
        time.sleep(0.2)
        proc, kpath = start_client(cold.port, kill_wave, "phase15-kill",
                                   tolerate_close=True, work_dir=RESUME_DIR,
                                   conns=RESUME_KILL_WAVE, depth=1)
        deadline = time.monotonic() + 20
        admitted = 0.0
        while time.monotonic() < deadline:
            admitted = cold.metric("policy_server_queue_depth")
            if admitted >= RESUME_KILL_WAVE:
                break
            time.sleep(0.02)
        cold.kill()
        killed = finish_client(proc, kpath, "phase15 kill wave")
        out["kill"] = {"admitted": admitted,
                       "answered": sum(r is not None for r in killed)}
        if out["kill"]["answered"]:
            fail(f"phase15: {out['kill']['answered']} requests of the kill "
                 "wave were answered before the SIGKILL")
        # while the server is down: 64 MODIFIED and 8 DELETED events
        rng = random.Random(15)
        names = rng.sample(sorted(inventory), RESUME_MODIFIED + RESUME_DELETED)
        modified, deleted = names[:RESUME_MODIFIED], names[RESUME_MODIFIED:]
        for key in modified:
            obj = copy.deepcopy(inventory[key])
            obj["metadata"].setdefault("labels", {})["p15"] = "modified"
            api.modify(path, obj)
            inventory[key] = obj
        for key in deleted:
            api.delete(path, inventory.pop(key))
        api.lists.clear()
        # 5. the warm boot: every row and cell restored, no LIST, the 64
        # modified pods re-judged and the 8 deleted ones evicted
        warm = boot("phase15 warm")
        events = RESUME_MODIFIED + RESUME_DELETED
        facts, ttc = audit_until(
            warm, "phase15 warm: the resumed watch and the re-judge",
            lambda f: f["settled"] and f["feed"]["events_applied"] == events
            and f["feed"]["queue_depth"] == 0, RESUME_SWEEP_TIMEOUT,
        )
        counts = warm.command("counts")
        boot_report = facts["boot"]
        want_keys = set(inventory) | live_keys
        doc = audit_dump(warm, "phase15 warm")
        # the live rows' cells were judged after the live waves' hooks ran
        # in the killed process; the rest by processes that ran none
        comp = check_compliance(
            "phase15 warm", doc,
            [(oracle, live_cache, live_keys),
             (audit_oracle, cold_cache, set(inventory))],
            policy_ids, want_keys, set(modified),
        )
        uncovered = facts["restore"].get("uncovered_rows")
        rejudged = facts["matrix"]["row_sweep_rows"] // len(policy_ids)
        out["warm"] = {
            "ttr_wall_s": warm.wall_ready_s, "compliance_s": ttc,
            "lists": api.lists.get(path, 0),
            "rows_restored": boot_report.get("audit_rows_restored"),
            "cells_restored": boot_report.get("matrix_cells_restored"),
            "uncovered_rows": uncovered, "restore": facts["restore"],
            "rejudged_rows": rejudged, "matrix": facts["matrix"],
            "rows_scanned": facts["scanner"]["rows_scanned"],
            "feed": facts["feed"], "audit_batches": facts["audit_batches"],
            "audit_launches": audit_launches(facts, counts),
            "build_launches": facts["launches_at_start"], "check": comp,
        }
        w = out["warm"]
        if (w["lists"] or w["rows_restored"] != spilled_rows
                or w["cells_restored"] != spilled_cells or uncovered != 0
                or rejudged != RESUME_MODIFIED
                or w["rows_scanned"] != RESUME_MODIFIED * len(policy_ids)
                or w["matrix"]["column_sweep_rows"]
                or w["audit_launches"] < 1):
            fail(f"phase15 warm boot: spilled {spilled_rows} rows and "
                 f"{spilled_cells} cells, then {json.dumps(w)}")
        # 6. a flipped byte in the matrix journal's head record: the file
        # is quarantined, nothing restores, the boot sweeps everything
        warm.stop()
        journal = work / "state" / "audit" / "matrix.journal"
        data = bytearray(journal.read_bytes())
        data[24] ^= 0x01
        journal.write_bytes(bytes(data))
        api.lists.clear()
        flipped = boot("phase15 flipped")
        rows = len(want_keys)
        facts, ttc = audit_until(
            flipped, "phase15 flipped: the full sweep",
            lambda f: f["settled"] and f["scanner"]["full_sweeps"] >= 1
            and f["resources"] == rows, RESUME_SWEEP_TIMEOUT,
        )
        counts = flipped.command("counts")
        doc = audit_dump(flipped, "phase15 flipped")
        comp = check_compliance(
            "phase15 flipped", doc, [(audit_oracle, cold_cache, want_keys)],
            policy_ids, want_keys, want_keys,
        )
        out["flipped"] = {
            "ttr_wall_s": flipped.wall_ready_s, "compliance_s": ttc,
            "lists": api.lists.get(path, 0),
            "quarantined": facts["store"]["fsck_quarantined"],
            "rows_restored": facts["boot"].get("audit_rows_restored"),
            "cells_restored": facts["boot"].get("matrix_cells_restored"),
            "rows_scanned": facts["scanner"]["rows_scanned"],
            "audit_batches": facts["audit_batches"],
            "audit_launches": audit_launches(facts, counts),
            "build_launches": facts["launches_at_start"], "check": comp,
        }
        fl = out["flipped"]
        if (fl["quarantined"] < 1 or fl["cells_restored"] != 0
                or fl["lists"] or fl["rows_restored"] != rows
                or fl["rows_scanned"] != rows * len(policy_ids)):
            fail(f"phase15 flipped matrix journal: {json.dumps(fl)}")
        flipped.stop()
    finally:
        for server in servers:
            server.kill()
        api.stop()
    return out


def otlp_phase(work_docs: list, card: str) -> dict:
    """Phase 15 wave O (see the module docstring) → its numbers."""
    import pathlib

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models.policy import parse_policies
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    work = pathlib.Path(RESUME_DIR) / "otlp"
    work.mkdir(parents=True, exist_ok=True)
    specs = flagship_policy_specs()
    policies = work / "policies.json"
    policies.write_text(json.dumps(specs))
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        parse_policies(specs)
    )
    rng = random.Random(151)

    def traced(n: int, tag: str) -> list:
        wave = []
        for pid, body in wave_of(work_docs, n, tag):
            tid, sid = f"{rng.getrandbits(128):032x}", f"{rng.getrandbits(64):016x}"
            wave.append((pid, body, f"traceparent: 00-{tid}-{sid}-01\r\n".encode(),
                         tid, sid))
        return wave

    waves = {"native": traced(OTLP_NATIVE_WAVE, "o15n"),
             "python": traced(OTLP_STDLIB_WAVE, "o15p")}
    exps = {fe: [expected_answer(oracle, p, b) for p, b, *_ in wave]
            for fe, wave in waves.items()}
    try:
        import grpc  # noqa: F401 — the export's transport
        import google.protobuf  # noqa: F401

        from policy_server_tpu_torch.telemetry import otlp_pb2
        from torch_otlp_collector import Collector

        collector = Collector(otlp_pb2)
    except ImportError as e:
        collector = None
        missing = str(e)
    out: dict = {"grpc": collector is not None, "runs": {}}
    servers: dict = {}

    def spawn(fmt: str, fe: str) -> RecoveryServer:
        env = None
        if fmt == "otlp":
            env = {"OTEL_EXPORTER_OTLP_ENDPOINT": (
                collector.endpoint if collector is not None
                else "http://127.0.0.1:9")}
        servers[fmt, fe] = RecoveryServer(
            ["--policies", str(policies), "--addr", "127.0.0.1",
             "--enable-metrics", "--frontend", fe, "--log-fmt", fmt,
             *KERNEL_ONLY_ARGS],
            f"phase15 {fmt} {fe}", work_dir=str(work), env=env, wait=False,
        )
        return servers[fmt, fe]

    # two servers boot side by side (a process start is most of a boot),
    # one of each log format, so one exporter at a time pushes to the
    # collector; each wave runs alone, the other server idle
    pairs = ((("json", "native"), ("otlp", "python")),
             (("json", "python"), ("otlp", "native")))
    try:
        for pair in pairs:
            booted = [spawn(fmt, fe) for fmt, fe in pair]
            for server in booted:
                server.wait_ready()
            for (fmt, fe), server in zip(pair, booted):
                one_otlp_run(out, fmt, fe, server, waves[fe], exps[fe],
                             collector, work)
    finally:
        for server in servers.values():
            server.kill()
        if collector is not None:
            collector.stop()
    if collector is None:
        out["missing"] = missing
    return out


def one_otlp_run(out: dict, fmt: str, fe: str, server: RecoveryServer,
                 wave: list, exp: list, collector, work) -> None:
    """One wave of wave O on its server, then the server stopped (its
    spans flushed, its last metrics pushed) and the export checked."""
    label = server.label
    try:
        mark = collector.mark() if collector is not None else None
        server.command("reset")
        t0 = time.perf_counter()
        results = finish_client(*start_client(
            server.port, [w[:3] for w in wave], label.replace(" ", "-"),
            work_dir=str(work),
        ), label)
        wall = time.perf_counter() - t0
        counts = server.command("counts")
        run = check_wave(label, results, wave, [exp])
        run.update(req_s=len(wave) / wall, launches=counts["policy_matrix"])
        if run["launches"] < 1:
            fail(f"{label}: policy_matrix was not launched")
        pulled = evaluation_counts(server.readiness_port)[0]
        answer = server.ask("otlp")
    finally:
        server.stop()
    if fmt == "otlp" and collector is not None:
        run.update(check_export(label, collector, mark, wave, fe, answer,
                                pulled))
    elif fmt == "otlp":
        errors = [
            json.loads(line)["message"]
            for line in open(server.log, encoding="utf-8")
            if line.startswith("{") and '"ERROR"' in line
        ]
        if len(errors) != 2 or not all(
            "grpcio/protobuf are not available" in m for m in errors
        ):
            fail(f"{label}: without grpc the log says {errors}")
        run["errors"] = errors
    out["runs"][fmt, fe] = run


def check_export(label: str, collector, mark, wave: list, frontend: str,
                 answer: dict, pulled: float) -> dict:
    """The spans and the pushed metrics of one wave: each request's
    ``traceparent`` parents the spans the JAX package's rule emits for it
    (native: one ``policy_evaluation``; stdlib: ``validation`` with a
    ``policy_evaluation`` child), received + dropped = emitted, and the
    last push's evaluation counter equals the /metrics pull after the
    wave."""
    from torch_otlp_collector import counter_total

    spans = collector.spans(mark)
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s.trace_id.hex(), []).append(s)
    per_request = 1 if frontend == "native" else 2
    emitted = per_request * len(wave)
    dropped = answer.get("dropped") or 0
    if len(spans) + dropped != emitted:
        fail(f"{label}: {len(spans)} spans received + {dropped} dropped, "
             f"{emitted} emitted")
    for pid, _b, _h, tid, sid in wave:
        mine = by_trace.get(tid, [])
        if dropped == 0 and len(mine) != per_request:
            fail(f"{label}: trace {tid} has {len(mine)} spans")
        attrs = {s.name: {kv.key: kv.value.string_value for kv in s.attributes}
                 for s in mine}
        if frontend == "native":
            ok = all(s.name == "policy_evaluation"
                     and s.parent_span_id.hex() == sid for s in mine)
        else:
            val = [s for s in mine if s.name == "validation"]
            child = [s for s in mine if s.name == "policy_evaluation"]
            ok = (len(val) == len(child) == 1
                  and val[0].parent_span_id.hex() == sid
                  and child[0].parent_span_id == val[0].span_id)
        if mine and (not ok or any(a.get("policy_id") != pid
                                   for a in attrs.values())):
            fail(f"{label}: the spans of trace {tid} are not the rule's: "
                 f"{[(s.name, s.parent_span_id.hex()) for s in mine]}")
    pushed = [m for m in collector.metrics(mark)
              if m.name == "kubewarden_policy_evaluations_total"]
    if not pushed or counter_total(pushed[-1]) != pulled:
        fail(f"{label}: the last push counts "
             f"{counter_total(pushed[-1]) if pushed else None} evaluations, "
             f"the pull {pulled}")
    return {"spans": len(spans), "dropped": dropped, "emitted": emitted,
            "pushed": counter_total(pushed[-1]), "pulled": pulled,
            "pushes": len(pushed)}


def print_phase15(r: dict, card: str) -> None:
    a = r["A"]
    print(
        f"phase15 wave A: kernel-only, spill cadences {RESUME_SPILL_SECONDS} s "
        f"(--state-audit-spill-seconds, --audit-matrix-spill-seconds); "
        f"{RESUME_OBJECTS} pods over the watch feed [{card}]"
    )
    for step in ("cold", "warm", "flipped"):
        b = a[step]
        c = b["check"]
        extra = ""
        if step == "warm":
            extra = (
                f"; rows restored {b['rows_restored']}, cells restored "
                f"{b['cells_restored']} (rows {b['restore'].get('rows_s', 0):.3f}"
                f" s, cells {b['restore'].get('cells_s', 0):.3f} s), rows the "
                f"restore left dirty {b['uncovered_rows']}; re-judged "
                f"{b['rejudged_rows']} modified pods ({b['rows_scanned']} "
                f"pairs), {RESUME_DELETED} deleted evicted; feed "
                f"{json.dumps(b['feed'])}"
            )
        elif step == "flipped":
            extra = (
                f"; quarantined {b['quarantined']}, rows restored "
                f"{b['rows_restored']}, cells restored {b['cells_restored']}, "
                f"full sweep {b['rows_scanned']} pairs"
            )
        print(
            f"phase15 {step} boot: /readiness {b['ttr_wall_s']:.3f} s, time to "
            f"compliance {b['compliance_s']:.3f} s from the process's start; "
            f"LIST requests v1/Pod {b['lists']}; audit lane "
            f"{b['audit_batches']} batches, policy_matrix "
            f"{b['audit_launches']} launches (K2 {b['build_launches']['probe']} "
            f"at the build){extra}; {c['rows']} rows, {c['cells']} matrix "
            f"cells and {c['report_rows']} report rows the oracle's "
            f"({c['errors']} oracle errors; oracle {c['oracle_s']:.1f} s) "
            f"[{card}]"
        )
    for kind, s in a["cadence_spills"].items():
        print(
            f"phase15 {kind} spill (cadence): {s['seconds']:.3f} s, of which "
            f"the write {s['write_s']:.3f} s, {s['bytes']} B [{card}]"
        )
    q, sw = a["quiet"], a["spill_wave"]
    for s in sw["spills"]:
        print(
            f"phase15 {s['kind']} spill (forced, inside the spill wave): "
            f"{s['seconds']:.3f} s, of which the write {s['write_s']:.3f} s, "
            f"{s['bytes']} B [{card}]"
        )
    print(
        f"phase15 live waves of {RESUME_LIVE_WAVE} kernel-only reviews: "
        f"quiet (every body the oracle's) {q['req_s']:.1f} req/s p50 {q['p50']:.3f} "
        f"p99 {q['p99']:.3f} ms; with a spill of each kind inside "
        f"{sw['req_s']:.1f} req/s p50 {sw['p50']:.3f} p99 {sw['p99']:.3f} ms "
        f"({sw['p99'] / q['p99']:.2f}x the quiet p99), "
        f"{sw['deadline_answers']} answered \"execution deadline exceeded\" "
        f"(the 2 s policy timeout) and the rest the oracle's; policy_matrix "
        f"{q['launches']} / {sw['launches']} launches [{card}]"
    )
    k = a["kill"]
    print(
        f"phase15 SIGKILL: {k['admitted']:.0f} of {RESUME_KILL_WAVE} requests "
        f"in flight, {k['answered']} answered; warm time to compliance "
        f"{a['warm']['compliance_s']:.3f} s against cold "
        f"{a['cold']['compliance_s']:.3f} s [{card}]"
    )
    o = r["O"]
    if not o["grpc"]:
        print(
            f"phase15 wave O: grpc or protobuf is absent here ({o['missing']}): "
            f"each --log-fmt otlp server logged the ERROR lines and served "
            f"every body; the export was verified by the CPU tests only "
            f"[{card}]"
        )
    for (fmt, fe), run in o["runs"].items():
        tail = ""
        if fmt == "otlp" and o["grpc"]:
            tail = (
                f"; spans received {run['spans']} + dropped {run['dropped']} ="
                f" emitted {run['emitted']}; pushed evaluations "
                f"{run['pushed']:.0f} = pulled {run['pulled']:.0f} "
                f"({run['pushes']} pushes)"
            )
        print(
            f"phase15 wave O {fe} --log-fmt {fmt}: {run['answered']} reviews, "
            f"every body the oracle's; {run['req_s']:.1f} req/s p50 "
            f"{run['p50']:.3f} p99 {run['p99']:.3f} ms; policy_matrix "
            f"{run['launches']} launches{tail} [{card}]"
        )
    for fe in ("native", "python"):
        j, t = o["runs"]["json", fe], o["runs"]["otlp", fe]
        print(
            f"phase15 wave O {fe}: otlp / json rate {t['req_s'] / j['req_s']:.3f}x,"
            f" p99 {t['p99'] / j['p99']:.3f}x [{card}]"
        )


COLUMNAR_DIR = os.path.join(REPO, "build", "chip_smoke_columnar")
COLUMNAR_WAVE = 1024
# wave X: the device path's forms, each kernel-only
COLUMNAR_CONFIGS = (
    ("xla", ["--kernel", "xla"]),
    ("xla columnar off", ["--kernel", "xla", "--columnar", "off"]),
    ("xla donate off", ["--kernel", "xla", "--donate-buffers", "off"]),
    ("pallas no warmup", ["--kernel", "pallas", "--no-warmup"]),
)
# wave X's watchdog: the wave holds each form's bodies to the oracle's,
# and its 256 requests in flight queue for about 256 / rate seconds (1.3 s
# at the 194 req/s of a slow host under --kernel xla); under the default
# 2 s timeout a slower form's tail then answers the watchdog's deadline
# body instead of a verdict
COLUMNAR_POLICY_TIMEOUT_S = 30
COLUMNAR_STEP_BATCHES = (128, 1024)
COLUMNAR_STEP_ITERS = 5
CACHE_WAVE = 128
LOCKSAN_NATIVE = 512
LOCKSAN_STDLIB = 128
COLUMNAR_FAMILIES = (
    "policy_server_wire_bytes_shipped_total",
    "policy_server_wire_bytes_packed_equivalent_total",
    "policy_server_wire_rows_total",
    "policy_server_delta_columns_shipped_total",
    "policy_server_delta_columns_available_total",
    "policy_server_donated_buffer_dispatches_total",
    "policy_server_device_resident_constant_bytes_total",
)


def columnar_wave(policies: str, waves: list, name: str, flags: list,
                  card: str) -> dict:
    """One wave X server: built from the command line, kernel-only, under
    ``flags``; each of ``waves`` ((requests, the oracle's answers)) from
    the native client, every body the oracle's; the columnar families,
    the environment's counters and peak ``memory_allocated`` over the
    waves."""
    import torch

    argv = ["--policies", policies, "--port", "0", "--readiness-probe-port",
            "0", "--enable-metrics", "--frontend", "native",
            "--policy-timeout", str(COLUMNAR_POLICY_TIMEOUT_S),
            *KERNEL_ONLY_ARGS, *flags]
    server, boot = boot_server(argv, f"phase16 wave X {name}")
    try:
        env = server.env
        hp0 = env.host_profile
        ps0 = env.pallas_stats
        compiles0 = env.plane_program_compiles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        runs = [
            served_wave(server, wave, [exp], f"phase16 wave X {name} {k}",
                        kernel_only=False)
            for k, (wave, exp) in enumerate(waves)
        ]
        run = dict(runs[0])
        for key in ("serving_launches", "batches", "rows", "host_batches"):
            run[key] = sum(r[key] for r in runs)
        run["req_s_by_wave"] = [r["req_s"] for r in runs]
        run["p99_by_wave"] = [r["p99"] for r in runs]
        torch.cuda.synchronize()
        run["peak_allocated_over_base"] = torch.cuda.max_memory_allocated() - base
        hp, ps = env.host_profile, env.pallas_stats
        run["profile"] = {k: hp[k] - hp0[k] for k in (
            "wire_bytes_shipped", "wire_bytes_packed_equiv", "wire_rows",
            "delta_cols_shipped", "delta_cols_total", "donated_dispatches",
            "resident_const_bytes", "dispatched_chunks", "dispatched_rows",
        )}
        run["pallas"] = {
            "dispatches": ps["dispatches"] - ps0["dispatches"],
            "buckets_armed": ps["buckets_armed"],
            "interpret_mode": ps["interpret_mode"],
        }
        run["plane_program_compiles"] = env.plane_program_compiles - compiles0
        run["families"] = {
            n: metric_value(server.readiness_port, n) for n in COLUMNAR_FAMILIES
        }
        run["boot"] = boot
        run["buckets"] = len(env.schemas)
    finally:
        server.stop()
    k1 = run["serving_launches"]
    if name.startswith("xla"):
        if k1 or run["pallas"]["dispatches"]:
            fail(f"phase16 wave X {name}: --kernel xla launched policy_matrix "
                 f"{k1} times")
    else:
        if run["pallas"]["buckets_armed"] != run["buckets"]:
            fail(f"phase16 wave X {name}: {run['pallas']['buckets_armed']} "
                 f"of {run['buckets']} buckets armed")
        if k1 != run["pallas"]["dispatches"] or not k1:
            fail(f"phase16 wave X {name}: {k1} policy_matrix launches for "
                 f"{run['pallas']['dispatches']} K1 dispatches")
    if boot["launches"]["probe"] != 1:
        fail(f"phase16 wave X {name}: the build launched probe "
             f"{boot['launches']['probe']} times")
    p = run["profile"]
    if name != "xla columnar off" and not p["wire_rows"]:
        fail(f"phase16 wave X {name}: no batch took the columnar path")
    if name == "xla columnar off" and p["wire_rows"]:
        fail("phase16 wave X --columnar off shipped delta planes")
    return run


STEP_PROFILE_TRIES = 4


def step_trace_counts(fn, launches_k1: bool) -> dict:
    """The kernels and copies one step launches, from a ``torch.profiler``
    trace of one step. A trace with no kernel event (CUPTI can drop a
    session's device records), or, for a step that launched K1 by its
    count, none named ``policy_matrix_kernel``, is taken again, up to
    ``STEP_PROFILE_TRIES`` traces; then the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from policy_server_tpu_torch.ops import cuda_kernels as ck

    trace = os.path.join(COLUMNAR_DIR, "step_trace.json")
    for attempt in range(1, STEP_PROFILE_TRIES + 1):
        before = ck.policy_matrix.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn().wait()
            torch.cuda.synchronize()
        k1_moved = ck.policy_matrix.launches - before
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(trace)
        kinds: dict = {}
        k1_kernels = 0
        for ev in events:
            cat = ev.get("cat", "")
            if ev.get("ph") == "X" and cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                kinds[cat] = kinds.get(cat, 0) + 1
                if cat == "kernel" and "policy_matrix_kernel" in ev.get("name", ""):
                    k1_kernels += 1
        if bool(k1_moved) != launches_k1:
            fail(f"phase16 device step: K1 launched {k1_moved} times in a "
                 f"step that should launch it {int(launches_k1)} times")
        if kinds.get("kernel") and k1_kernels == k1_moved:
            return {"kernels": kinds["kernel"],
                    "copies": kinds.get("gpu_memcpy", 0) + kinds.get("gpu_memset", 0),
                    "profile_tries": attempt}
        print(f"phase16 device step: trace {attempt} held "
              f"{kinds.get('kernel', 0)} kernel events, {k1_kernels} of K1 "
              f"for {k1_moved} K1 launches; tracing again")
    fail(f"phase16 device step: {STEP_PROFILE_TRIES} traces of a step held "
         "no usable kernel count")


def step_numbers(fn, card: str, launches_k1: bool) -> dict:
    """One device step form: ``fn()`` enqueues and returns the step →
    stream ms per step (CUDA events around the enqueue and its fetch,
    back to back), host wall ms, and the kernels and copies one step
    launches (``step_trace_counts``)."""
    import torch

    ms = time_cuda(lambda: fn().wait(), COLUMNAR_STEP_ITERS, reps=3, warmup=2)
    walls = []
    for _ in range(COLUMNAR_STEP_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn().wait()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"stream_ms": ms, "host_wall_ms": statistics.median(walls),
            **step_trace_counts(fn, launches_k1)}


def device_steps(work_docs: list, card: str) -> list:
    """The columnar program, the packed non-Pallas program and K1's step
    at B = 128 and 1,024 in each bucket, one environment, the same rows:
    the three outputs equal, then each form's numbers."""
    import numpy as np

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )

    env = EvaluationEnvironmentBuilder(device="cuda", kernel="xla").build(
        flagship_policies()
    )
    docs = synthetic_firehose(max(COLUMNAR_STEP_BATCHES), seed=16)
    rows = []
    for idx, schema in enumerate(env.schemas):
        encs = []
        for d in docs:
            d = widen(d) if idx == 1 else d
            payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
            got, enc = env.encode_bucketed(payload)
            if got != idx:
                fail(f"phase16 doc encoded into bucket {got}, not {idx}")
            encs.append(enc)
        for batch in COLUMNAR_STEP_BATCHES:
            wide = schema.pack(schema.stack(encs[:batch], batch_size=batch))
            feats = {"__packed__": wide["__packed__"]}
            tbuf = np.asarray(env._transport(feats)["__packed__"])
            forms = {
                "columnar": lambda: env._enqueue_planes(idx, feats),
                "packed": lambda: env._enqueue_unpacked(tbuf),
                "k1": lambda: env.enqueue_packed(tbuf),
            }
            outs = {name: fn().wait() for name, fn in forms.items()}
            for name, out in outs.items():
                if not np.array_equal(out, outs["k1"]):
                    fail(f"phase16 device step {name} disagrees with K1's at "
                         f"bucket {idx} B={batch}")
            _spec, delta = env._build_delta(idx, feats)
            shipped = sum(a.nbytes for a in delta.values())
            for name, fn in forms.items():
                row = {"bucket": idx, "batch": batch, "form": name,
                       **step_numbers(fn, card, launches_k1=name == "k1")}
                if name == "columnar":
                    row["shipped_bytes"] = shipped
                    row["planes"] = sorted(delta)
                else:
                    row["shipped_bytes"] = int(tbuf.nbytes)
                rows.append(row)
                print(f"phase16 device step: {json.dumps(row)} [{card}]")
    env.close()
    return rows


def cache_boot_main(argv: list[str]) -> int:
    """Wave C's server process: ``python3 chip_smoke.py --cache-boot DIR
    POLICIES CORPUS OUT [ARGS...]``. Boots the server from the command
    line with ``--compilation-cache-dir DIR --frontend native``
    (kernel-only, then ARGS), builds (or finds) the four native libraries,
    answers the corpus's requests, stops, and writes each library's file
    and build seconds, the boot's seconds and the bodies to OUT."""
    cache, policies, corpus, out_path = argv[:4]
    t0 = time.perf_counter()
    sys.path.insert(0, REPO)
    from policy_server_tpu_torch.__main__ import build_cli, server_from_args
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.ops import fastenc
    from policy_server_tpu_torch.runtime import native_frontend as nf
    from policy_server_tpu_torch.wasm import native_exec

    args = build_cli().parse_args([
        "--policies", policies, "--port", "0", "--readiness-probe-port", "0",
        "--frontend", "native", "--compilation-cache-dir", cache,
        *KERNEL_ONLY_ARGS, *argv[4:],
    ])
    server = server_from_args(args)
    server.start()
    boot_s = time.perf_counter() - t0
    try:
        kernels = ck.build_library()
        enc = fastenc.build_library()
        front = nf.build_library()
        native_exec.build_library()
        libs = {
            "kernels": [str(kernels.path), kernels.build_seconds],
            "encoder": [str(enc.path), enc.build_seconds],
            "frontend": [str(front.path), front.build_seconds],
            "wasm core": [str(native_exec.library_path()),
                          native_exec.build_seconds],
        }
        with open(corpus) as f:
            work = [(pid, body.encode("latin-1")) for pid, body in json.load(f)]
        bodies = [None] * len(work)

        def post(part: list) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            try:
                for i, (pid, body) in part:
                    conn.request("POST", f"/validate/{pid}", body=body,
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    bodies[i] = [resp.status, resp.read().decode("latin-1")]
            finally:
                conn.close()

        indexed = list(enumerate(work))
        threads = [threading.Thread(target=post, args=(indexed[k::8],))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.stop()
    with open(out_path, "w") as f:
        json.dump({"libs": libs, "boot_s": boot_s, "bodies": bodies}, f)
    return 0


def cache_wave(work_docs: list, card: str) -> dict:
    """Wave C: two server processes over one fresh
    ``--compilation-cache-dir``; the first builds the four libraries there,
    the second none; both answer the same reviews with the oracle's
    bodies."""
    import shutil

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.policies.flagship import flagship_policies

    cache = os.path.join(COLUMNAR_DIR, "compile-cache")
    shutil.rmtree(cache, ignore_errors=True)
    policies = os.path.join(COLUMNAR_DIR, "policies.json")
    wave = wave_of(work_docs, CACHE_WAVE, "c16")
    corpus = os.path.join(COLUMNAR_DIR, "cache_corpus.json")
    with open(corpus, "w") as f:
        json.dump([(pid, body.decode("latin-1")) for pid, body in wave], f)
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    exp = [list(expected_answer(oracle, pid, body)) for pid, body in wave]
    exp = [[s, b.decode("latin-1")] for s, b in exp]
    boots = []
    for k in range(2):
        out = os.path.join(COLUMNAR_DIR, f"cache_boot_{k}.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cache-boot", cache,
             policies, corpus, out],
            capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"phase16 wave C boot {k + 1} failed: {proc.stderr[-3000:]}")
        with open(out) as f:
            doc = json.load(f)
        doc["process_wall_s"] = wall
        bad = [i for i, (g, w) in enumerate(zip(doc["bodies"], exp)) if g != w]
        if bad:
            fail(f"phase16 wave C boot {k + 1}: {len(bad)} bodies differ from "
                 f"the oracle's (first {bad[0]}: {doc['bodies'][bad[0]]})")
        boots.append(doc)
    first, second = boots
    real = os.path.realpath(cache)
    for name, (path, seconds) in first["libs"].items():
        if os.path.dirname(path) != real or seconds <= 0:
            fail(f"phase16 wave C: the first boot did not build the {name} "
                 f"into the cache ({path}, {seconds} s)")
        if second["libs"][name] != [path, 0.0]:
            fail(f"phase16 wave C: the second boot rebuilt the {name}: "
                 f"{second['libs'][name]}")
    print(
        "phase16 wave C --compilation-cache-dir: first boot builds s "
        + json.dumps({n: round(s, 3) for n, (_p, s) in first["libs"].items()})
        + f"; second boot 0 builds; process walls {first['process_wall_s']:.2f}"
        f" / {second['process_wall_s']:.2f} s, boots {first['boot_s']:.2f} / "
        f"{second['boot_s']:.2f} s; {2 * CACHE_WAVE} bodies the oracle's "
        f"[{card}]"
    )
    return {"first": first["libs"], "walls": [b["process_wall_s"] for b in boots],
            "boots": [b["boot_s"] for b in boots]}


def locksan_wave(card: str) -> dict:
    """Wave L: ``tests/torch_locksan_drive.py`` on the card in a process
    of its own, the sanitizer armed before the package is imported: 512
    reviews through the native frontend and 128 through the standard
    library's, one reload; any inversion fails."""
    out = os.path.join(COLUMNAR_DIR, "locksan.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_locksan_drive.py"),
         out, "--device", "cuda", "--native", str(LOCKSAN_NATIVE), "--stdlib",
         str(LOCKSAN_STDLIB)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    if proc.returncode != 0:
        fail(f"phase16 wave L failed: {proc.stderr[-3000:]}")
    with open(out) as f:
        rep = json.load(f)
    print(f"phase16 wave L: {rep['report']} [{card}]")
    facts = rep["facts"]
    if rep["inversions"]:
        fail(f"phase16 wave L: lock-order inversion(s): {rep['inversions']}")
    if facts["native"] != {"200": LOCKSAN_NATIVE} or facts["stdlib"] != {
        "200": LOCKSAN_STDLIB
    } or facts["reload"] != "promoted":
        fail(f"phase16 wave L: {facts}")
    print(
        f"phase16 wave L: {rep['acquisitions']} acquisitions, {rep['edges']} "
        f"order edges, 0 inversions, {len(rep['long_holds'])} long holds "
        f"(longest hold {rep['max_hold_ms']:.1f} ms), {rep['seconds']:.1f} s "
        f"[{card}]"
    )
    return rep


def columnar_phase(work_docs: list, card: str) -> dict:
    """Phase 16 (see the module docstring)."""
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        flagship_policy_specs,
    )

    os.makedirs(COLUMNAR_DIR, exist_ok=True)
    policies = os.path.join(COLUMNAR_DIR, "policies.json")
    with open(policies, "w") as f:
        json.dump(flagship_policy_specs(), f)
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    waves = []
    for tag in ("x16", "x16b"):
        wave = wave_of(work_docs, COLUMNAR_WAVE, tag)
        waves.append(
            (wave, [expected_answer(oracle, pid, body) for pid, body in wave])
        )
    out: dict = {"X": {}}
    for name, flags in COLUMNAR_CONFIGS:
        # without a warmup, a second wave (new uids) makes sure every
        # bucket crosses the hotness threshold
        run = columnar_wave(
            policies, waves if "no warmup" in name else waves[:1], name,
            flags, card,
        )
        out["X"][name] = run
        p = run["profile"]
        rows = max(1, p["wire_rows"])
        print(
            f"phase16 wave X --{name}: {run['rows']} bodies the oracle's in "
            f"{len(run['req_s_by_wave'])} wave(s), req/s "
            f"{[round(r, 1) for r in run['req_s_by_wave']]} p99 "
            f"{[round(p, 3) for p in run['p99_by_wave']]} ms; "
            f"{run['batches']} batches; K1 launches "
            f"{run['serving_launches']}, pallas_stats {json.dumps(run['pallas'])}"
            f", plane_program_compiles {run['plane_program_compiles']}; wire "
            f"bytes per row {p['wire_bytes_shipped'] / rows:.1f} against the "
            f"transport form's {p['wire_bytes_packed_equiv'] / rows:.1f} over "
            f"{p['wire_rows']} rows; delta columns {p['delta_cols_shipped']} of "
            f"{p['delta_cols_total']}; donated {p['donated_dispatches']} of "
            f"{p['dispatched_chunks']} dispatches; peak memory_allocated over "
            f"the wave {run['peak_allocated_over_base']} B [{card}]"
        )
        print(f"phase16 wave X --{name} columnar families: "
              f"{json.dumps(run['families'])} [{card}]")
    out["steps"] = device_steps(work_docs, card)
    out["C"] = cache_wave(work_docs, card)
    out["L"] = locksan_wave(card)
    return out


MESH_DIR = os.path.join(REPO, "build", "chip_smoke_mesh")
MESH_WAVE = 1024
# wave V: meshes laid over one card taken four times, each under armed
# pallas and under xla with columnar on
MESH_ONE_CARD = ("data:4", "data:2,policy:2", "data:1,policy:4")
MESH_FORMS = (("pallas", True), ("xla", True))
MESH_HOLD_BATCHES = (128, 1024)
MESH_STEP_BATCH = 128
MESH_D_WAVE = 512
# wave R over one card taken twice, where there is one card
MESH_R_REHEARSAL_WAVE = 512
MESH_D_TIMEOUT_S = 300


def mesh_wave_a(policies: str, work_docs: list, native_k1: dict,
                card: str) -> dict:
    """Wave A: phase 7's reviews through the native frontend, kernel-only,
    under ``--mesh auto`` and ``--mesh data:1``: on one card neither lays
    a mesh, every body is the oracle's and every device batch launches K1
    (once per schema bucket it reaches, as in phase 7's run without the
    flag: ``check_kernel_batches``); then ``--mesh data:2`` must end the
    process non-zero, naming the device count."""
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.policies.flagship import flagship_policies

    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    wave = wave_of(work_docs, MESH_WAVE, "m17a")
    exp = [expected_answer(oracle, pid, body) for pid, body in wave]
    out: dict = {}
    n_cards = torch.cuda.device_count()
    for spec in ("auto", "data:1"):
        argv = ["--policies", policies, "--port", "0", "--readiness-probe-port",
                "0", "--frontend", "native", *KERNEL_ONLY_ARGS, "--mesh", spec]
        server, boot = boot_server(argv, f"phase17 wave A --mesh {spec}")
        try:
            meshed = server.env._mesh is not None
            run = served_wave(server, wave, [exp], f"phase17 wave A --mesh {spec}",
                              kernel_only=True)
        finally:
            server.stop()
        if n_cards == 1 and meshed:
            fail(f"phase17 wave A: --mesh {spec} laid a mesh on one card")
        run["per_batch"] = run["serving_launches"] / max(1, run["batches"])
        run["boot"] = boot
        out[spec] = run
        print(
            f"phase17 wave A --mesh {spec}: {run['answered']} bodies the "
            f"oracle's, mesh laid {meshed}; {run['req_s']:.1f} req/s p50 "
            f"{run['p50']:.3f} p99 {run['p99']:.3f} ms; {run['batches']} "
            f"device batches, {run['serving_launches']} K1 launches "
            f"({run['per_batch']:.3f} per batch; phase 7's run without the "
            f"flag {native_k1['serving_launches'] / max(1, native_k1['batches']):.3f})"
            f" [{card}]"
        )
    if n_cards == 1:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "policy_server_tpu_torch", "--policies",
             policies, "--port", "0", "--readiness-probe-port", "0",
             "--mesh", "data:2"],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO},
        )
        text = proc.stderr + proc.stdout
        want = "mesh 2x1 does not match device count 1"
        if proc.returncode == 0 or want not in text:
            fail(f"phase17 wave A: --mesh data:2 on one card exited "
                 f"{proc.returncode} without {want!r}: {text[-2000:]}")
        print(f"phase17 wave A --mesh data:2 on one card: exit "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s, "
              f"\"{want}\" [{card}]")
        out["data:2 exit"] = proc.returncode
    return out


def mesh_items(work_docs: list) -> list:
    from policy_server_tpu_torch.models import (
        AdmissionReviewRequest,
        ValidateRequest,
    )

    return [
        (pid, ValidateRequest.from_admission(
            AdmissionReviewRequest.from_dict(copy.deepcopy(d)).request
        ))
        for pid, d in work_docs[:MESH_WAVE]
    ]


def mesh_step_rows(env, docs: list) -> dict:
    """bucket → (wide features, transport buffer) of MESH_STEP_BATCH rows
    and the largest hold batch, encoded by ``env``."""
    import numpy as np

    from policy_server_tpu_torch.models import AdmissionReviewRequest

    out = {}
    for idx, schema in enumerate(env.schemas):
        encs = []
        for d in docs:
            d = widen(d) if idx == 1 else d
            payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
            got, enc = env.encode_bucketed(payload)
            if got != idx:
                fail(f"phase17 doc encoded into bucket {got}, not {idx}")
            encs.append(enc)
        for batch in MESH_HOLD_BATCHES:
            wide = schema.pack(schema.stack(encs[:batch], batch_size=batch))
            feats = {"__packed__": wide["__packed__"]}
            out[idx, batch] = (
                feats, np.asarray(env._transport(feats)["__packed__"])
            )
    return out


def hold_shard_programs(env, rows: dict, spec: str, card: str) -> int:
    """Each policy shard's K1 program against its plain version on the
    card, per bucket at every hold batch: exact, or the phase fails.
    → the number of programs held."""
    import numpy as np
    import torch

    from policy_server_tpu_torch.ops import cuda_kernels as ck

    held = 0
    for (idx, batch), (_feats, tbuf) in rows.items():
        _i, _lo, transport, narrow = env._layout_for_buffer(tbuf.shape[1])
        dev = torch.from_numpy(tbuf).to("cuda")
        for p in range(len(env._mesh_buckets)):
            program = env.program_for(idx, transport, narrow, p)
            a, r = ck.policy_matrix(dev, program)
            pa, pr = ck.policy_matrix_plain(dev, program)
            torch.cuda.synchronize()
            if not (torch.equal(a, pa) and torch.equal(r, pr)):
                bad = int((a != pa).sum() + (r != pr).sum())
                fail(f"phase17 wave V {spec}: shard {p}'s K1 disagrees with "
                     f"its plain version at bucket {idx} B={batch} ({bad} "
                     f"cells)")
            if program.out_cols != env._mesh_block_width:
                fail(f"phase17 wave V {spec}: shard {p}'s block is "
                     f"{program.out_cols} columns, not the plan's "
                     f"{env._mesh_block_width}")
            held += 1
    print(f"phase17 wave V {spec}: {held} per-shard K1 programs "
          f"(policy shards x buckets x B in {MESH_HOLD_BATCHES}) equal their "
          f"plain versions on the card, max_abs_err 0 [{card}]")
    return held


def mesh_wave_v(work_docs: list, card: str) -> dict:
    """Wave V (see the module docstring)."""
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )

    cuda0 = torch.device("cuda", 0)
    items = mesh_items(work_docs)
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    want = [r.to_dict() for r in oracle.validate_batch(items)]
    step_docs = synthetic_firehose(max(MESH_HOLD_BATCHES), seed=17)
    out: dict = {"forms": {}, "held": 0}
    for spec in (None, *MESH_ONE_CARD):
        for kernel, columnar in MESH_FORMS:
            label = f"{spec or 'no mesh'} --kernel {kernel}" + (
                "" if columnar else " --columnar off"
            )
            env = EvaluationEnvironmentBuilder(
                device="cuda", kernel=kernel, columnar=columnar,
                verdict_cache_size=0,
            ).build(flagship_policies())
            positions = 1
            if spec is not None:
                mesh = mesh_mod.make_mesh(
                    mesh_mod.MeshSpec.parse(spec), devices=[cuda0] * 4
                )
                env.attach_mesh(mesh)
                positions = mesh.size
            env.warmup((MESH_STEP_BATCH,))
            torch.cuda.synchronize()
            ps0 = env.pallas_stats["dispatches"]
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            got = env.validate_batch(items)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ck.launch_counts()["policy_matrix"]
            dispatches = env.pallas_stats["dispatches"] - ps0
            bad = [
                i for i, r in enumerate(got)
                if isinstance(r, Exception) or r.to_dict() != want[i]
            ]
            if bad:
                fail(f"phase17 wave V {label}: {len(bad)} of {len(items)} "
                     f"bodies differ from the oracle's (first {bad[0]}: "
                     f"{got[bad[0]]!r:.300})")
            if kernel == "pallas":
                if not dispatches or launches != positions * dispatches:
                    fail(f"phase17 wave V {label}: {launches} K1 launches for "
                         f"{dispatches} K1 steps over {positions} positions")
            elif launches:
                fail(f"phase17 wave V {label}: --kernel xla launched K1 "
                     f"{launches} times")
            rows = mesh_step_rows(env, step_docs)
            feats, tbuf = rows[0, MESH_STEP_BATCH]
            if kernel == "pallas":
                step = {**step_numbers(lambda: env.enqueue_packed(tbuf), card,
                                       launches_k1=True)}
            else:
                step = {**step_numbers(lambda: env._enqueue_planes(0, feats),
                                       card, launches_k1=False)}
            if spec is not None and env._mesh_buckets and kernel == "pallas":
                out["held"] += hold_shard_programs(env, rows, spec, card)
            env.close()
            row = {"mesh": spec, "kernel": kernel, "columnar": columnar,
                   "positions": positions, "bodies": len(items),
                   "validate_ms": wall * 1e3, "k1_launches": launches,
                   "k1_steps": dispatches, "step_bucket": 0,
                   "step_batch": MESH_STEP_BATCH, **step}
            out["forms"][label] = row
            print(f"phase17 wave V: {json.dumps(row)} [{card}]")
    return out


def mesh_wave_d(card: str) -> dict:
    """Wave D: two server processes on one card
    (``tests/torch_mesh_drive.py``) with ``--distributed-coordinator
    127.0.0.1:PORT --distributed-num-processes 2 --distributed-process-id
    {0,1} --mesh auto`` — one ``torch.distributed`` group over gloo, a
    global ``data:2`` mesh, one position each — each serving its own 512
    reviews through the native frontend, every body the oracle's, each
    launching K1."""
    coordinator = f"127.0.0.1:{free_port()}"
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        out = os.path.join(MESH_DIR, f"wave_d_rank{rank}.json")
        if os.path.exists(out):
            os.unlink(out)
        procs.append((out, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_mesh_drive.py"),
             out, coordinator, str(rank), str(MESH_D_WAVE), "--device", "cuda",
             "--frontend", "native"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO,
        )))
    reports = []
    try:
        for out, proc in procs:
            try:
                text, _ = proc.communicate(timeout=MESH_D_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"phase17 wave D: a server process ran past "
                     f"{MESH_D_TIMEOUT_S} s")
            if proc.returncode != 0:
                fail(f"phase17 wave D failed: {text[-3000:]}")
            with open(out) as f:
                reports.append(json.load(f))
    finally:
        for _out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for rep in reports:
        r = rep["rank"]
        if rep["mesh"] != {"data": 2, "policy": 1} or rep["world"] != 2:
            fail(f"phase17 wave D rank {r}: mesh {rep['mesh']} in a group of "
                 f"{rep['world']}")
        if rep["mismatches"] or rep["answered"] != MESH_D_WAVE:
            fail(f"phase17 wave D rank {r}: {rep['mismatches']} bodies differ "
                 f"from the oracle's, {rep['answered']} answered (first "
                 f"{rep['first_mismatch']})")
        if not rep["launches"] or rep["launches"] != rep["k1_dispatches"]:
            fail(f"phase17 wave D rank {r}: {rep['launches']} K1 launches for "
                 f"{rep['k1_dispatches']} K1 steps")
        if rep["columnar_ok"] or rep["wire_rows"]:
            fail(f"phase17 wave D rank {r}: columnar ran on a multi-process mesh")
        if (not rep["k1_bits_are_the_oracles"] or rep["psum"] != rep["oracle_counts"]
                or rep["psum_device"] != "cuda:0"):
            fail(f"phase17 wave D rank {r}: acceptance_psum {rep['psum']} on "
                 f"{rep['psum_device']}, the oracle's counts over both ranks "
                 f"{rep['oracle_counts']}, K1's bits the oracle's "
                 f"{rep['k1_bits_are_the_oracles']}")
        print(
            f"phase17 wave D rank {r}: mesh {json.dumps(rep['mesh'])}, local "
            f"shards {rep['local_shards']}, {rep['answered']} bodies the "
            f"oracle's in {rep['wave_s']:.3f} s, {rep['dispatched_chunks']} "
            f"device batches, {rep['launches']} K1 launches, columnar off "
            f"[{card}]"
        )
    if reports[0]["psum"] != reports[1]["psum"]:
        fail(f"phase17 wave D: the ranks' acceptance counts differ: "
             f"{reports[0]['psum']} against {reports[1]['psum']}")
    psum_s = ", ".join(f"{rep['psum_s']:.4f}" for rep in reports)
    print(f"phase17 wave D: acceptance_psum over the gloo group gives both "
          f"ranks the oracle's counts over both ranks' rows "
          f"({sum(reports[0]['psum'])} accepted of "
          f"{2 * MESH_D_WAVE * reports[0]['psum_policies']} cells; {psum_s} s "
          f"by rank) [{card}]")
    print(f"phase17 wave D: two processes in {wall:.1f} s (process start, "
          f"group, boots, waves and stops) [{card}]")
    return {"reports": reports, "wall_s": wall}


def mesh_phase(work_docs: list, native_k1: dict, card: str) -> dict:
    """Phase 17 (see the module docstring)."""
    import torch

    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    os.makedirs(MESH_DIR, exist_ok=True)
    os.makedirs(COLUMNAR_DIR, exist_ok=True)  # step_trace_counts' trace file
    policies = os.path.join(MESH_DIR, "policies.json")
    with open(policies, "w") as f:
        json.dump(flagship_policy_specs(), f)
    out = {"A": mesh_wave_a(policies, work_docs, native_k1, card)}
    out["V"] = mesh_wave_v(work_docs, card)
    out["D"] = mesh_wave_d(card)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        out["R"] = mesh_wave_r(policies, work_docs, cards, MESH_WAVE, card)
    else:
        print(f"phase17 wave R over several cards skipped: "
              f"torch.cuda.device_count() is {n_cards}; its code runs below "
              f"over one card taken twice [{card}]")
        out["R"] = mesh_wave_r(
            policies, work_docs, [torch.device("cuda", 0)] * 2,
            MESH_R_REHEARSAL_WAVE, card,
        )
    return out


def mesh_wave_r(policies: str, work_docs: list, devices: list, n_wave: int,
                card: str) -> dict:
    """Wave R: the server through the command line at ``--mesh data:N``
    and, for an even N, ``data:N/2,policy:2`` over the N ``devices``,
    native, kernel-only: every body the oracle's, every device batch with
    a K1 step (``check_kernel_batches`` over the positions), K1 launched
    once per position per K1 step (a batch that reaches both schema
    buckets makes two steps: ``pallas_stats['dispatches']``); rates and
    p99. With more than one card ``devices`` are the cards; on one card
    that card taken twice stands in, through the mesh's default device
    list (``global_devices``), so the wave's code runs on every machine."""
    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import flagship_policies

    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    wave = wave_of(work_docs, n_wave, "m17r")
    exp = [expected_answer(oracle, pid, body) for pid, body in wave]
    n = len(devices)
    specs = [f"data:{n}"]
    if n % 2 == 0:
        specs.append(f"data:{n // 2},policy:2")
    over = ("the cards" if len(set(devices)) == n
            else f"{devices[0]} taken {n} times")
    out = {}
    real_devices = mesh_mod.global_devices
    mesh_mod.global_devices = lambda _type="cuda": list(devices)
    try:
        for spec in specs:
            label = f"phase17 wave R --mesh {spec}"
            argv = ["--policies", policies, "--port", "0",
                    "--readiness-probe-port", "0", "--frontend", "native",
                    *KERNEL_ONLY_ARGS, "--mesh", spec]
            server, _boot = boot_server(argv, label)
            try:
                positions = server.env._mesh.size
                d0 = server.env.pallas_stats["dispatches"]
                run = served_wave(server, wave, [exp], label,
                                  kernel_only=True, positions=positions)
                run["k1_steps"] = server.env.pallas_stats["dispatches"] - d0
            finally:
                server.stop()
            if positions != n:
                fail(f"{label}: a mesh of {positions} positions over {n} devices")
            if (not run["k1_steps"]
                    or run["serving_launches"] != positions * run["k1_steps"]):
                fail(f"{label}: {run['serving_launches']} K1 launches for "
                     f"{run['k1_steps']} K1 steps over {positions} positions")
            out[spec] = run
            print(f"{label} over {over}: {run['answered']} bodies the "
                  f"oracle's; {run['req_s']:.1f} req/s p50 {run['p50']:.3f} "
                  f"p99 {run['p99']:.3f} ms; {run['batches']} device batches, "
                  f"{run['k1_steps']} K1 steps, {run['serving_launches']} K1 "
                  f"launches [{card}]")
    finally:
        mesh_mod.global_devices = real_devices
    return out


THREADED_DIR = os.path.join(REPO, "build", "chip_smoke_threaded")
THREADED_WAVE = 1024
THREADED_SPECS = ("data:1,policy:2", "data:2,policy:2")
THREADED_Z_SPEC = "data:2,policy:2"
THREADED_Z_THREADS = 4
THREADED_Z_CHUNK = 64
THREADED_P_SPEC = "data:4"
THREADED_P_ROWS = 1024


def threaded_devices(n: int) -> tuple[list, str]:
    """The phase's ``n`` mesh entries: the cards where there are ``n``,
    else card 0 taken ``n`` times; and how to say which."""
    import torch

    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)], "the cards"
    return [torch.device("cuda", 0)] * n, f"cuda:0 taken {n} times"


class ShardSteps:
    """The device steps of one row batch on every policy shard, enqueued
    shard by shard; ``wait`` fetches them all."""

    def __init__(self, steps: list) -> None:
        self.steps = steps

    def wait(self) -> list:
        return [s.wait() for s in self.steps]


def k1_steps(ev) -> list:
    """(K1 steps so far, mesh positions) of each shard environment."""
    return [
        (s.pallas_stats["dispatches"], s._mesh.size if s._mesh is not None else 1)
        for s in ev.shards
    ]


def threaded_wave_t(policies: str, work_docs: list, r17: dict,
                    card: str) -> dict:
    """Wave T (see the module docstring)."""
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.parallel import PolicyShardedEvaluator
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )

    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    wave = wave_of(work_docs, THREADED_WAVE, "t18")
    exp = [expected_answer(oracle, pid, body) for pid, body in wave]
    step_docs = synthetic_firehose(max(MESH_HOLD_BATCHES), seed=18)
    out: dict = {}
    real_devices = mesh_mod.global_devices
    try:
        for spec in THREADED_SPECS:
            parsed = mesh_mod.MeshSpec.parse(spec)
            devices, over = threaded_devices(
                parsed.data_size() * parsed.policy_size()
            )
            mesh_mod.global_devices = lambda _type="cuda", d=devices: list(d)
            label = f"phase18 wave T --mesh {spec} --mesh-dispatch threaded"
            argv = ["--policies", policies, "--port", "0",
                    "--readiness-probe-port", "0", "--frontend", "native",
                    *KERNEL_ONLY_ARGS, "--mesh", spec, "--mesh-dispatch",
                    "threaded"]
            server, boot = boot_server(argv, label)
            try:
                ev = server.env
                if not isinstance(ev, PolicyShardedEvaluator):
                    fail(f"{label}: the server built {type(ev).__name__}")
                shards = len(ev.shards)
                if shards != parsed.policy_size():
                    fail(f"{label}: {shards} shard environments")
                if boot["launches"]["probe"] != shards:
                    fail(f"{label}: the probe launched "
                         f"{boot['launches']['probe']} times for {shards} "
                         "shard environments built")
                before = k1_steps(ev)
                run = served_wave(server, wave, [exp], label, kernel_only=False)
                after = k1_steps(ev)
                steps = [a - b for (a, _p), (b, _q) in zip(after, before)]
                positions = [p for _d, p in after]
                want = sum(s * p for s, p in zip(steps, positions))
                if run["host_batches"] or not all(steps):
                    fail(f"{label}: {run['host_batches']} host batches, K1 "
                         f"steps by shard {steps}")
                if run["serving_launches"] != want:
                    fail(f"{label}: {run['serving_launches']} K1 launches, "
                         f"the shards' K1 steps {steps} over positions "
                         f"{positions} make {want}")
                held = 0
                step_rows = []
                for i, shard in enumerate(ev.shards):
                    rows = mesh_step_rows(shard, step_docs)
                    for (idx, batch), (_f, tbuf) in rows.items():
                        _i, _lo, transport, narrow = shard._layout_for_buffer(
                            tbuf.shape[1]
                        )
                        program = shard.program_for(idx, transport, narrow)
                        dev = torch.from_numpy(tbuf).to(shard.device)
                        a, r = ck.policy_matrix(dev, program)
                        pa, pr = ck.policy_matrix_plain(dev, program)
                        torch.cuda.synchronize()
                        if not (torch.equal(a, pa) and torch.equal(r, pr)):
                            fail(f"{label}: shard {i}'s K1 disagrees with its "
                                 f"plain version at bucket {idx} B={batch}")
                        held += 1
                    step_rows.append(rows[0, MESH_STEP_BATCH][1])
                step = step_numbers(
                    lambda: ShardSteps([
                        s.enqueue_packed(b) for s, b in zip(ev.shards, step_rows)
                    ]),
                    card, launches_k1=True,
                )
            finally:
                server.stop()
            # the fused form at the same mesh, on the same wave in this call
            flabel = f"phase18 wave T --mesh {spec} (fused)"
            fserver, _fboot = boot_server(argv[:-2], flabel)
            try:
                positions_f = fserver.env._mesh.size
                f0 = fserver.env.pallas_stats["dispatches"]
                frun = served_wave(fserver, wave, [exp], flabel, kernel_only=True,
                                   positions=positions_f)
                fsteps = fserver.env.pallas_stats["dispatches"] - f0
            finally:
                fserver.stop()
            if frun["serving_launches"] != positions_f * fsteps:
                fail(f"{flabel}: {frun['serving_launches']} K1 launches for "
                     f"{fsteps} K1 steps over {positions_f} positions")
            fused = r17.get("R", {}).get(spec)
            row = {
                "mesh": spec, "over": over, "shards": shards,
                "answered": run["answered"], "req_s": run["req_s"],
                "p50": run["p50"], "p99": run["p99"],
                "batches": run["batches"], "k1_steps_by_shard": steps,
                "positions_by_shard": positions,
                "serving_launches": run["serving_launches"],
                "boot_probe_launches": boot["launches"]["probe"],
                "boot_s": boot["boot_s"], "held": held,
                "step_batch": MESH_STEP_BATCH, **step,
                "fused": {"req_s": frun["req_s"], "p50": frun["p50"],
                          "p99": frun["p99"], "k1_steps": fsteps,
                          "serving_launches": frun["serving_launches"]},
                "fused_phase17": None if fused is None else {
                    k: fused[k] for k in ("req_s", "p50", "p99")
                },
            }
            out[spec] = row
            print(f"phase18 wave T: {json.dumps(row)} [{card}]")
    finally:
        mesh_mod.global_devices = real_devices
    return out


def threaded_wave_z(work_docs: list, card: str) -> dict:
    """Wave Z (see the module docstring)."""
    import queue

    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.parallel import PolicyShardedEvaluator
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import flagship_policies

    items = mesh_items(work_docs)[:THREADED_WAVE]
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    want = [r.to_dict() for r in oracle.validate_batch(items)]
    parsed = mesh_mod.MeshSpec.parse(THREADED_Z_SPEC)
    devices, over = threaded_devices(parsed.data_size() * parsed.policy_size())
    memory = []
    gc.collect()
    torch.cuda.synchronize()
    memory.append(("before the build", torch.cuda.memory_allocated()))
    ev = PolicyShardedEvaluator(
        flagship_policies(), mesh_mod.make_mesh(parsed, devices),
        builder_kwargs=dict(device="cuda", verdict_cache_size=0),
    )
    ev.warmup((THREADED_Z_CHUNK,))
    torch.cuda.synchronize()
    envs = {id(s): [s, s.pallas_stats["dispatches"]] for s in ev.shards}
    retired: list = []
    chunks: queue.Queue = queue.Queue()
    for c in range(0, len(items), THREADED_Z_CHUNK):
        chunks.put(c)
    got: list = [None] * len(items)
    done = [0]
    errors: list = []
    lock = threading.Lock()

    def serve() -> None:
        while True:
            try:
                c = chunks.get_nowait()
            except queue.Empty:
                return
            try:
                res = ev.validate_batch(items[c : c + THREADED_Z_CHUNK])
            except BaseException as e:  # noqa: BLE001 — checked below
                errors.append(repr(e))
                return
            got[c : c + THREADED_Z_CHUNK] = res
            with lock:
                done[0] += 1

    n_chunks = chunks.qsize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=serve, daemon=True)
               for _ in range(THREADED_Z_THREADS)]
    for t in threads:
        t.start()
    resize_s = []
    for frac, n in ((1, 2), (2, parsed.data_size() * parsed.policy_size())):
        wait_until(lambda: errors or done[0] >= frac * n_chunks // 3, 120,
                   "wave Z's chunks before a resize")
        retired.append(list(ev.shards))
        r0 = time.perf_counter()
        ev.resize(devices[:n])
        resize_s.append(time.perf_counter() - r0)
        for s in ev.shards:
            envs.setdefault(id(s), [s, s.pallas_stats["dispatches"]])
        if n == 2:
            torch.cuda.synchronize()
            memory.append(("between the resizes (the first set retired)",
                           torch.cuda.memory_allocated()))
    for t in threads:
        t.join(300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()["policy_matrix"]
    if errors:
        fail(f"phase18 wave Z: {errors[:3]}")
    bad = [i for i, r in enumerate(got)
           if r is None or isinstance(r, Exception) or r.to_dict() != want[i]]
    if bad:
        fail(f"phase18 wave Z: {len(bad)} of {len(items)} answers are not the "
             f"oracle's (first {bad[0]}: {got[bad[0]]!r:.300})")
    if ev.resizes != 2 or ev._retired:
        fail(f"phase18 wave Z: {ev.resizes} resizes, {len(ev._retired)} "
             "snapshots still retired and open")
    still_open = [i for i, snap in enumerate(retired) for s in snap if not s._closed]
    if still_open:
        fail(f"phase18 wave Z: retired snapshots {sorted(set(still_open))} "
             "kept an environment open after they drained")
    k1_want = sum(
        (s.pallas_stats["dispatches"] - d0) * (s._mesh.size if s._mesh else 1)
        for s, d0 in envs.values()
    )
    if not launches or launches != k1_want:
        fail(f"phase18 wave Z: {launches} K1 launches, the environments' K1 "
             f"steps over their positions make {k1_want}")
    shape = dict(ev.mesh.shape)
    ev.close()
    del ev
    gc.collect()
    torch.cuda.synchronize()
    memory.append(("after close", torch.cuda.memory_allocated()))
    row = {"mesh": THREADED_Z_SPEC, "over": over, "answers": len(items),
           "threads": THREADED_Z_THREADS, "chunk": THREADED_Z_CHUNK,
           "resizes": 2, "resize_s": resize_s, "final_mesh": shape,
           "environments": len(envs), "serving_launches": launches,
           "wall_s": wall, "memory_allocated": memory}
    print(f"phase18 wave Z: {json.dumps(row)} [{card}]")
    return row


def threaded_wave_p(card: str) -> dict:
    """Wave P (see the module docstring)."""
    import numpy as np
    import torch

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.parallel import acceptance_psum
    from policy_server_tpu_torch.parallel import mesh as mesh_mod
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_mesh_drive import oracle_bits

    docs = synthetic_firehose(THREADED_P_ROWS, seed=181)
    env = EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())
    try:
        feats_buf = mesh_step_rows(env, docs)[0, THREADED_P_ROWS][1]
        _i, _lo, transport, narrow = env._layout_for_buffer(feats_buf.shape[1])
        program = env.program_for(0, transport, narrow)
        pids = sorted(program.column_of)
        allowed, _rule = ck.policy_matrix(
            torch.from_numpy(feats_buf).to(env.device), program
        )
        bits = allowed[:, [program.column_of[p] for p in pids]]
        parsed = mesh_mod.MeshSpec.parse(THREADED_P_SPEC)
        devices, over = threaded_devices(parsed.data_size())
        count = acceptance_psum(mesh_mod.make_mesh(parsed, devices))
        counts = count(bits)
        torch.cuda.synchronize()
        host_bits = bits.cpu().numpy()
        want = host_bits.sum(axis=0)
        if counts.device != bits.device or counts.dtype != torch.int32:
            fail(f"phase18 wave P: counts {counts.dtype} on {counts.device}")
        if counts.cpu().tolist() != want.tolist():
            fail(f"phase18 wave P: acceptance_psum {counts.cpu().tolist()} is "
                 f"not numpy's column sums {want.tolist()}")
        payload_docs = [copy.deepcopy(d) for d in docs]
        if not np.array_equal(host_bits, oracle_bits(env, payload_docs, pids)):
            fail("phase18 wave P: K1's allowed bits are not the oracle's")
        ms = time_cuda(lambda: count(bits), 20)
    finally:
        env.close()
    row = {"mesh": THREADED_P_SPEC, "over": over, "rows": THREADED_P_ROWS,
           "policies": len(pids), "accepted": int(want.sum()),
           "cells": int(host_bits.size), "psum_ms": ms}
    print(f"phase18 wave P: {json.dumps(row)}; counts equal numpy's column "
          f"sums and the oracle's bits [{card}]")
    return row


def threaded_phase(work_docs: list, r17: dict, card: str) -> dict:
    """Phase 18 (see the module docstring)."""
    from policy_server_tpu_torch.policies.flagship import flagship_policy_specs

    os.makedirs(THREADED_DIR, exist_ok=True)
    os.makedirs(COLUMNAR_DIR, exist_ok=True)  # step_trace_counts' trace file
    policies = os.path.join(THREADED_DIR, "policies.json")
    with open(policies, "w") as f:
        json.dump(flagship_policy_specs(), f)
    out = {}
    for name, fn in (
        ("T", lambda: threaded_wave_t(policies, work_docs, r17, card)),
        ("Z", lambda: threaded_wave_z(work_docs, card)),
        ("P", lambda: threaded_wave_p(card)),
    ):
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"phase18 wave {name} wall {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    if not os.path.isdir(os.path.join(REPO, "policy_server_tpu_torch")):
        fail("the policy_server_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import numpy as np

    from policy_server_tpu_torch.evaluation.environment import (
        EvaluationEnvironmentBuilder,
    )
    from policy_server_tpu_torch.models import AdmissionReviewRequest
    from policy_server_tpu_torch.ops import cuda_kernels as ck
    from policy_server_tpu_torch.ops import fastenc
    from policy_server_tpu_torch.runtime import native_frontend
    from policy_server_tpu_torch.policies.flagship import (
        flagship_policies,
        synthetic_firehose,
    )
    from policy_server_tpu_torch.runtime.batcher import (
        DEFAULT_HOST_FASTPATH_THRESHOLD,
    )
    from policy_server_tpu_torch.wasm import native_exec

    import torch_tape_coverage as tape_coverage

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: card and build ------------------------------------------
    print(f"phase1 card: {card}")
    print(
        f"phase1 python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()} [{card}]"
    )
    # the four builds run side by side: g++ of the encoder, of the HTTP
    # frontend and of the native wasm core on threads while nvcc compiles
    # the kernel library
    t_phase = time.perf_counter()
    builds: dict = {}

    def build(name: str, fn) -> None:
        try:
            builds[name] = fn(force=True)
        except Exception as e:  # noqa: BLE001 — reported below
            builds[name] = e

    build_threads = [
        threading.Thread(target=build, args=(name, fn))
        for name, fn in (
            ("encoder", fastenc.build_library),
            ("frontend", native_frontend.build_library),
            ("wasm core", native_exec.build_library),
        )
    ]
    for t in build_threads:
        t.start()
    lib = ck.build_library(force=True)
    for t in build_threads:
        t.join()
    for name, got in builds.items():
        if isinstance(got, Exception):
            fail(f"the native {name} did not build: {got}")
    enc_build = builds["encoder"]
    front_build = builds["frontend"]
    print(
        f"phase1 g++ build of the HTTP frontend {front_build.build_seconds:.3f} "
        f"s -> {front_build.path.name} [{card}]"
    )
    print(
        f"phase1 g++ build of the native wasm core "
        f"{native_exec.build_seconds:.3f} s -> "
        f"{native_exec.library_path().name} [{card}]"
    )
    ptxas = [
        line.strip() for line in lib.build_log.splitlines()
        if "registers" in line or "spill" in line or "smem" in line
        or "Compiling entry" in line
    ]
    print(
        f"phase1 nvcc build {lib.build_seconds:.3f} s -> {lib.path.name} "
        f"[{card}]"
    )
    for line in ptxas:
        print(f"phase1 ptxas: {line} [{card}]")
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128)
    y = ck.probe(x)
    torch.cuda.synchronize()
    if not torch.equal(y, x + 1.0):
        fail("probe kernel disagrees with x + 1")
    probe_err = float((y - (x + 1.0)).abs().max())
    probe_ms = time_cuda(lambda: ck.probe(x), 100)
    probe_plain_ms = time_cuda(lambda: ck.probe_plain(x), 100)
    probe_lib_ms = time_cuda(lambda: torch.add(x, 1.0), 100)
    print(
        f"phase1 probe ok: max_abs_err {probe_err} kernel {probe_ms:.6f} ms "
        f"plain {probe_plain_ms:.6f} ms torch.add {probe_lib_ms:.6f} ms "
        f"[{card}]"
    )
    if probe_ms > probe_lib_ms:
        # both are host-bound: where the probe is slower, its host cost
        print(
            f"phase1 probe slower than torch.add; host us per call: probe "
            f"{host_us(lambda: ck.probe(x)):.3f} torch.add "
            f"{host_us(lambda: torch.add(x, 1.0)):.3f} [{card}]"
        )

    print(f"phase1 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 2: policy_matrix against its plain version -----------------
    t_phase = time.perf_counter()
    env = EvaluationEnvironmentBuilder(device="cuda").build(flagship_policies())
    docs = synthetic_firehose(max(PHASE2_BATCHES), seed=7)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k1_rows = []
    k1_err = 0
    for idx, schema in enumerate(env.schemas):
        encs = []
        for d in docs:
            d = widen(d) if idx == 1 else d
            payload = AdmissionReviewRequest.from_dict(d).request.to_dict()
            got_idx, enc = env.encode_bucketed(payload)
            if got_idx != idx:
                fail(f"firehose doc encoded into bucket {got_idx}, not {idx}")
            encs.append(enc)
        if idx == 0:
            small_encs = encs
        for batch in PHASE2_BATCHES:
            wide = schema.pack(schema.stack(encs[:batch], batch_size=batch))
            for narrow in (True, False):
                buf = schema.to_transport(
                    wide, vocab_size=len(env.table) if narrow else None
                )["__packed__"]
                program = env.program_for(idx, True, narrow)
                dev = torch.from_numpy(buf).to(device)
                want_a, want_r = ck.policy_matrix_plain(dev, program)
                got_a, got_r = ck.policy_matrix(dev, program)
                torch.cuda.synchronize()
                if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
                    bad = int((got_a != want_a).sum() + (got_r != want_r).sum())
                    fail(
                        f"policy_matrix disagrees with its plain version: "
                        f"bucket {idx} B={batch} narrow={narrow}: {bad} cells"
                    )
                err = int((got_r - want_r).abs().max()) + int(
                    (got_a.to(torch.int32) - want_a.to(torch.int32)).abs().max()
                )
                k1_err = max(k1_err, err)
                if not bool((~want_a[:, list(program.column_of.values())]).any()):
                    fail("phase 2 batch is vacuous: no policy rejects any row")
                ms = time_cuda(lambda: ck.policy_matrix(dev, program), 20)
                device_ms = graph_ms(lambda: ck.policy_matrix(dev, program))
                plain_ms = time_cuda(
                    lambda: ck.policy_matrix_plain(dev, program), 2, warmup=1
                )
                form = "narrow" if narrow else "transport"
                nbytes = buf.nbytes + batch * program.out_cols * 5
                ops = batch * program.element_ops_per_row()
                bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                bound_ops_ms = ops / PEAK_OPS_PER_S * 1e3
                shape = program.launch_shape(batch, n_sm)
                row = {
                    "bucket": idx, "batch": batch, "form": form,
                    "width": int(buf.shape[1]), "ms": ms,
                    "pr1_ms": PR1_MS.get((idx, form, batch)),
                    "device_ms": device_ms,
                    "plain_ms": plain_ms,
                    "bytes": nbytes, "ops": ops,
                    "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                    "bound_by": (
                        "bytes" if bound_bytes_ms >= bound_ops_ms
                        else "operations"
                    ),
                    "layout": ck.LAYOUT_NAMES[shape.layout],
                    "part_instructions": program.part_lengths,
                    "rows_per_block": shape.rows_per_block,
                    "arena_bytes": program.arena_bytes,
                    "smem_bytes": shape.smem_bytes,
                    "max_abs_err": err,
                    "card": card,
                }
                k1_rows.append(row)
                print(f"phase2 policy_matrix exact: {json.dumps(row)}")

    # the every-opcode tape on sparse random bytes, shifts and divisions
    cover_env = EvaluationEnvironmentBuilder(device="cuda").build(
        flagship_policies()
    )
    gen = torch.Generator().manual_seed(5)
    n_cover = 0
    for idx in range(len(cover_env.schemas)):
        for transport, narrow in ((True, True), (True, False), (False, False)):
            cover = tape_coverage.every_opcode_program(
                cover_env, idx, transport, narrow
            )
            for batch in COVER_BATCHES:
                shape = (batch, cover.buf_width)
                keep = torch.rand(shape, generator=gen) < 0.15
                noise = torch.randint(
                    0, 256, shape, generator=gen, dtype=torch.uint8
                )
                dev = torch.where(keep, noise, torch.zeros_like(noise)).to(device)
                want_a, want_r = ck.policy_matrix_plain(dev, cover)
                for prog in (cover, tape_coverage.with_division_divisors(cover)):
                    got_a, got_r = ck.policy_matrix(dev, prog)
                    torch.cuda.synchronize()
                    if not (torch.equal(got_a, want_a)
                            and torch.equal(got_r, want_r)):
                        bad = int((got_a != want_a).sum()
                                  + (got_r != want_r).sum())
                        fail(
                            f"every-opcode tape disagrees with its plain "
                            f"version: bucket {idx} transport={transport} "
                            f"narrow={narrow} B={batch}: {bad} cells"
                        )
                    n_cover += 1
    print(
        f"phase2 every-opcode tape exact: {n_cover} cases, opcodes "
        f"{sorted(tape_coverage.opcodes_of(cover))}, B in {COVER_BATCHES}, "
        f"0 differing cells [{card}]"
    )
    # an allow-list part at the shared-memory limit: arenas spilled
    n_list = tape_coverage.allow_list_at_limit(cover_env)
    spill, offset = tape_coverage.allow_list_program(cover_env, [n_list])
    if spill.arena_layout != ck.LAYOUT_WARPS_SPILL:
        fail("the allow-list at the limit does not spill its arenas")
    for batch in SPILL_BATCHES:
        dev = torch.from_numpy(
            tape_coverage.allow_list_rows(spill, offset, batch, seed=batch)
        ).to(device)
        want_a, want_r = ck.policy_matrix_plain(dev, spill)
        got_a, got_r = ck.policy_matrix(dev, spill)
        torch.cuda.synchronize()
        if not (torch.equal(got_a, want_a) and torch.equal(got_r, want_r)):
            fail(f"spilled-arena allow-list disagrees at B={batch}")
    print(
        f"phase2 spilled arenas exact: one part of {n_list} InSet "
        f"constants, {spill.smem_plan(spill.arena_layout, 1)[-1]} B of "
        f"shared memory, B in {SPILL_BATCHES}, 0 differing cells [{card}]"
    )
    print(
        f"phase2 policy_matrix launches so far: "
        f"{ck.policy_matrix.launches} [{card}]"
    )

    # the environment's device step at the headline shape, phase by phase
    # (stream time between CUDA events, so the host's enqueue is in it)
    schema = env.schemas[0]
    batch = 128
    wide = schema.pack(schema.stack(small_encs[:batch], batch_size=batch))
    buf = schema.to_transport(wide, vocab_size=len(env.table))["__packed__"]
    program = env.program_for(0, True, True)
    if not np.array_equal(env.evaluate_packed(buf), step_phases(env, buf, program)[0]):
        fail("the split device step disagrees with evaluate_packed")
    split = [step_phases(env, buf, program)[1] for _ in range(20)]
    names = ("h2d", "policy_matrix", "combine", "d2h", "host_wall")
    med = {n: statistics.median(s[i] for s in split) for i, n in enumerate(names)}
    # the serving path's split step: page-locked copies, enqueue then fetch
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env.evaluate_packed(buf)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(
        "phase2 device step split, bucket 0 narrow B=128, median of 20, ms: "
        + " ".join(f"{n} {v:.5f}" for n, v in med.items())
        + f"; enqueue+fetch host wall {statistics.median(walls):.5f} [{card}]"
    )
    print(f"phase2 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 3: the main path over HTTP, twice -------------------------
    rng = random.Random(11)
    reviews = synthetic_firehose(N_REQUESTS, seed=2024)
    reviews = [widen(d) if i % 8 == 0 else d for i, d in enumerate(reviews)]
    policy_ids = sorted(flagship_policies())
    work_docs = [
        (policy_ids[i % len(policy_ids)], d) for i, d in enumerate(reviews)
    ]
    rng.shuffle(work_docs)
    work = [(pid, json.dumps(d).encode()) for pid, d in work_docs]
    oracle = EvaluationEnvironmentBuilder(backend="oracle").build(
        flagship_policies()
    )
    oracle_bodies = [oracle_body(oracle, pid, body) for pid, body in work]
    # the metric counts the verdict before the mode's constraints (a
    # monitor-mode rejection is answered allowed): the environment's own
    rejected = [
        not oracle.validate(pid, request_of(body)).allowed for pid, body in work
    ]
    oracle_rejected = sum(rejected)
    t_phase = time.perf_counter()
    # the kernel-only run: no host routing (the latency budget off too, so
    # no batch is routed by it) and no cache, so every micro-batch
    # launches policy_matrix
    kernel_only = dict(
        host_fastpath_threshold=0, verdict_cache_size=0, latency_budget_ms=0
    )
    kernel_label = (
        "--host-fastpath-threshold 0 --verdict-cache-size 0 "
        "--latency-budget-ms 0"
    )
    # the pipeline's width is the batcher's constant (four, as the JAX
    # package's); a run with one worker shows what the width does to
    # batch size, rate and tail latency
    from policy_server_tpu_torch.runtime import batcher as batcher_mod

    if batcher_mod.PIPELINE_WORKERS != 4:
        fail(f"the batcher has {batcher_mod.PIPELINE_WORKERS} pipeline workers, not 4")
    runs = {}
    for workers in (4, 1):
        batcher_mod.PIPELINE_WORKERS = workers
        for name, label, flags in (
            ("default", "default flags", {}),
            ("kernel", kernel_label, kernel_only),
        ):
            runs[name, workers] = http_run(
                f"{label}, {workers} pipeline worker{'s' if workers > 1 else ''}",
                work, oracle_bodies, oracle_rejected, card, **flags,
            )
    # the kernel-only run with one worker once more with the recorder
    # off: its rate beside the recorder-on run's (one pair: a direction),
    # and the overhead the recorder's own writes model
    runs["kernel-off", 1] = http_run(
        f"{kernel_label} --flight-recorder off, 1 pipeline worker",
        work, oracle_bodies, oracle_rejected, card, flight_recorder=False,
        **kernel_only,
    )
    batcher_mod.PIPELINE_WORKERS = 4
    on, off = runs["kernel", 1], runs["kernel-off", 1]
    per_event_s = recorder_event_seconds()
    print(
        f"phase3 flight recorder, kernel-only, 1 pipeline worker: on "
        f"{on['req_s']:.1f} req/s, off {off['req_s']:.1f} req/s (one pair, a "
        f"direction); modeled overhead: {on['events']} events x "
        f"{per_event_s * 1e6:.3f} us / {on['wall']:.3f} s wall = "
        f"{on['events'] * per_event_s / on['wall'] * 100:.3f}% [{card}]"
    )
    for workers in (4, 1):
        check_kernel_batches(
            runs["kernel", workers],
            f"the kernel-only run ({workers} pipeline workers)",
        )
    cells = []
    for name in ("default", "kernel"):
        for w in (4, 1):
            run = runs[name, w]
            cells.append(
                f"{name} x{w}: {run['rows'] / max(1, run['batches']):.1f} rows "
                f"{run['req_s']:.1f} req/s p99 {run['p99']:.3f} ms"
            )
    print(
        "phase3 pipeline workers 4 against 1 (mean rows per micro-batch): "
        + "; ".join(cells) + f" [{card}]"
    )
    print(f"phase3 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 4: the native pipeline on the card -------------------------
    t_phase = time.perf_counter()
    native_phase(reviews, policy_ids, oracle, enc_build, card)
    print(f"phase4 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 5: the host fast path against K1 per batch size ------------
    t_phase = time.perf_counter()
    sweep = host_device_sweep(reviews, policy_ids, card)
    faster = [b for b, host_ms, device_ms in sweep if device_ms < host_ms]
    print(
        f"phase5 crossover: the device path is faster than the host fast "
        f"path from B={faster[0] if faster else 'none of ' + str(SWEEP_BATCHES)}"
        f"; batches where it is faster: {faster} (routing unchanged: the "
        f"host threshold stays {DEFAULT_HOST_FASTPATH_THRESHOLD}) [{card}]"
    )
    print(f"phase5 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 6: the card's busy share under a short kernel-only run ------
    t_phase = time.perf_counter()
    traced = http_run(
        f"{kernel_label}, 4 pipeline workers, {TRACED_REQUESTS} requests under "
        f"profiling.start_device_trace",
        work[:TRACED_REQUESTS], oracle_bodies[:TRACED_REQUESTS],
        sum(rejected[:TRACED_REQUESTS]), card,
        trace_dir=os.path.join(REPO, "build", "chip_smoke_trace"),
        **kernel_only,
    )
    busy = device_busy(traced["trace_path"], traced["traced_wall"])
    print(
        f"phase6 device busy share over the traced window: "
        f"{json.dumps(busy)}; {traced['serving_launches']} policy_matrix "
        f"launches, {traced['req_s']:.1f} req/s under the trace [{card}]"
    )
    merged = merged_trace(traced["trace_path"])
    print(f"phase6 flight recorder on the trace's clock: {json.dumps(merged)} [{card}]")
    check_merged_trace(merged, "phase6")
    print(f"phase6 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 7: the native HTTP frontend on the card --------------------
    t_phase = time.perf_counter()
    waves = []
    for w in range(NATIVE_WAVES):
        wave = []
        for pid, d in work_docs:
            d = copy.deepcopy(d)
            d["request"]["uid"] = f"{d['request']['uid']}-w{w}"
            wave.append((pid, json.dumps(d).encode()))
        waves.append(wave)
    flat = [item for wave in waves for item in wave]
    native_bodies = [oracle_body(oracle, pid, body) for pid, body in flat]
    native_rejected = sum(
        not oracle.validate(pid, request_of(body)).allowed for pid, body in flat
    )
    native_runs = {}
    for workers, name, label, flags in (
        (4, "default", "default flags", {}),
        (4, "kernel", kernel_label, kernel_only),
        (1, "kernel", kernel_label, kernel_only),
    ):
        batcher_mod.PIPELINE_WORKERS = workers
        native_runs[name, workers] = native_http_run(
            f"--frontend native, {label}, {workers} pipeline "
            f"worker{'s' if workers > 1 else ''}",
            waves, native_bodies, native_rejected, card, **flags,
        )
    batcher_mod.PIPELINE_WORKERS = 4
    for workers in (4, 1):
        check_kernel_batches(
            native_runs["kernel", workers],
            f"the native kernel-only run ({workers} pipeline workers)",
        )
    cells = []
    for name, w in (("default", 4), ("kernel", 4), ("kernel", 1)):
        std, nat = runs[name, w], native_runs[name, w]
        cells.append(
            f"{name} x{w}: stdlib {std['req_s']:.1f} req/s p50 "
            f"{std['p50']:.3f} p99 {std['p99']:.3f} ms "
            f"{std['rows'] / max(1, std['batches']):.1f} rows/batch; native "
            f"{nat['req_s']:.1f} req/s p50 {nat['p50']:.3f} p99 "
            f"{nat['p99']:.3f} ms {nat['rows'] / max(1, nat['batches']):.1f} "
            f"rows/batch, {nat['batches'] - nat['host_batches']} device "
            f"batches, {nat['serving_launches']} serving launches"
        )
    print(
        "phase7 native against phase 3's stdlib frontend, this call: "
        + "; ".join(cells) + f" [{card}]"
    )
    batcher_mod.PIPELINE_WORKERS = 4
    traced_native = native_http_run(
        f"--frontend native, {kernel_label}, 4 pipeline workers, one wave "
        f"under profiling.start_device_trace",
        waves[:1], native_bodies[: len(waves[0])],
        sum(
            not oracle.validate(pid, request_of(body)).allowed
            for pid, body in waves[0]
        ),
        card, trace_dir=os.path.join(REPO, "build", "chip_smoke_trace"),
        **kernel_only,
    )
    busy = device_busy(traced_native["trace_path"], traced_native["traced_wall"])
    print(
        f"phase7 device busy share over the traced native window: "
        f"{json.dumps(busy)}; {traced_native['serving_launches']} "
        f"policy_matrix launches, {traced_native['req_s']:.1f} req/s under "
        f"the trace [{card}]"
    )
    merged = merged_trace(traced_native["trace_path"])
    print(f"phase7 flight recorder on the trace's clock: {json.dumps(merged)} [{card}]")
    check_merged_trace(merged, "phase7")
    print(f"phase7 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 8: reload, rollback and self-heal on the card ---------------
    t_phase = time.perf_counter()
    r8 = reload_phase(work_docs, card)
    print_reload_phase(r8, card)
    print(f"phase8 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 9: tenants, shedding and shards on the card ------------------
    t_phase = time.perf_counter()
    r9 = tenants_phase(work_docs, card)
    print_tenants_phase(r9, card)
    print(f"phase9 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 10: audit on the card ----------------------------------------
    t_phase = time.perf_counter()
    r10 = audit_phase(work_docs, card)
    print_audit_phase(r10, card)
    print(f"phase10 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 11: TLS, rotation and the prefork workers on the card --------
    t_phase = time.perf_counter()
    r11 = tls_prefork_phase(work_docs, native_runs["kernel", 4], card)
    print_tls_prefork_phase(r11, card)
    print(f"phase11 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 12: host-executed policies on the card ------------------------
    t_phase = time.perf_counter()
    r12 = wasm_phase(work_docs, k1_rows, card)
    print_wasm_phase(r12, card)
    print(f"phase12 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 13: policy acquisition, context and the audit watch feed -----
    # -- phase 14: crash recovery on phase 13's fetched set ------------------
    t_phase = time.perf_counter()
    rig = FetchRig()
    try:
        r13 = acquisition_phase(rig, work_docs, card)
        print(f"phase13 wall {time.perf_counter() - t_phase:.1f} s [{card}]")
        t_phase = time.perf_counter()
        r14 = recovery_phase(rig, work_docs, card)
    finally:
        rig.stop()
    print_recovery_phase(r14, card)
    print(f"phase14 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 15: the audit side's warm resume and the OTLP export ---------
    t_phase = time.perf_counter()
    r15 = {"A": resume_phase(work_docs, card)}
    r15["O"] = otlp_phase(work_docs, card)
    print_phase15(r15, card)
    print(f"phase15 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 16: the columnar delta-plane path, the compile cache, locksan -
    t_phase = time.perf_counter()
    r16 = columnar_phase(work_docs, card)
    print(f"phase16 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 17: the device mesh ------------------------------------------
    t_phase = time.perf_counter()
    r17 = mesh_phase(work_docs, native_runs["kernel", 4], card)
    print(f"phase17 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- phase 18: the threaded policy-shard dispatcher and the psum -------
    t_phase = time.perf_counter()
    r18 = threaded_phase(work_docs, r17, card)
    print(f"phase18 wall {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- the kernels line -------------------------------------------------
    main_row = next(
        r for r in k1_rows
        if r["bucket"] == 0 and r["batch"] == 128 and r["form"] == "narrow"
    )
    probe_bytes = 2 * x.numel() * 4
    probe_bound_bytes_ms = probe_bytes / PEAK_BYTES_PER_S * 1e3
    probe_bound_ops_ms = x.numel() / PEAK_OPS_PER_S * 1e3
    kernels = [
        {
            "name": "policy_matrix",
            "route": "cuda",
            "source": "policy_server_tpu_torch/csrc/policy_matrix.cu",
            "replaces": "policy_server_tpu/ops/pallas_kernels.py:164",
            # this slice's path: the native frontend, kernel-only, four
            # pipeline workers (launches after the server's warmup); at
            # the default flags small batches are answered on the host
            "launches": native_runs["kernel", 4]["serving_launches"],
            "launches_from": (
                f"phase 7 native HTTP run {kernel_label}, 4 pipeline "
                f"workers: launches after the server's warmup"
            ),
            "launches_by_path": {
                **{
                    f"phase3 stdlib {name} x{w}": run["serving_launches"]
                    for (name, w), run in runs.items()
                },
                **{
                    f"phase7 native {name} x{w}": run["serving_launches"]
                    for (name, w), run in native_runs.items()
                },
                "phase8 reload path (server build, 1 watch reload under "
                "traffic, 1 rejected, 5 admin reloads, 6 rollbacks, serving "
                "waves)": r8["launches"]["policy_matrix"],
                "phase9 tenants and shards (3 tenants x 2 shards: build, "
                "waves T, Q, X, S)": r9["launches"]["policy_matrix"],
                **{
                    f"phase9 --serving-shards {n} after the warmup": r["serving_launches"]
                    for n, r in r9["rates"].items()
                },
                "phase10 audit path (server build, boot sweep under a live "
                "wave, a second full sweep, lookup admission, promotion with "
                "the what-if and its dirty-column sweep, rollback and its "
                "full sweep)": r10["launches"]["policy_matrix"],
                "phase10 boot sweep: audit lane": r10["B"]["audit_launches"],
                "phase10 boot sweep: live batches": r10["B"]["live_launches"],
                "phase11 native mTLS (waves L and R) after the warmup":
                    r11["L_launches"]["serving_launches"],
                "phase11 stdlib TLS (wave S) after the warmup":
                    r11["S_launches"]["serving_launches"],
                **{
                    f"phase11 prefork --frontend {fe} --http-workers {w} "
                    "after the warmup": row["launches"]["serving_launches"]
                    for (fe, w), row in r11["P"].items()
                },
                **{
                    f"phase12 39-policy set with wasm and CEL, native, "
                    f"{run['waves'][0]['label']}, wave {w['wave']}": w["k1_launches"]
                    for run in (r12["default"], r12["kernel"], r12["replay"])
                    for w in run["waves"]
                },
                **{
                    f"phase13 wave F fetched set, --frontend {fe}, kernel-only":
                        run["serving_launches"]
                    for fe, run in r13["fetch"]["F"].items()
                },
                f"phase13 wave R, {RELOAD_TAG_CYCLES} tag reloads, kernel-only "
                "waves": sum(
                    c["launches"] for c in r13["fetch"]["R"]["cycles"]
                ),
                **{
                    f"phase13 wave {w} context, {label}":
                        r13["context"][w][label]["serving_launches"]
                    for w in ("C1", "C2") for label in ("default", "kernel")
                },
                "phase13 wave C, 257 namespaces (all rows to the host)":
                    r13["context"]["C257"]["serving_launches"],
                "phase13 wave W audit lane, the watch events":
                    r13["watch"]["audit_launches"],
                **{
                    f"phase14 {step} boot's kernel-only wave":
                        r14[step]["wave"]["serving_launches"]
                    for step in ("cold", "warm", "changed", "flipped", "again")
                },
                "phase14 fenced-shard wave":
                    r14["flipped"]["shard_wave"]["serving_launches"],
                **{
                    f"phase15 wave A {step} boot: audit lane to compliance":
                        r15["A"][step]["audit_launches"]
                    for step in ("cold", "warm", "flipped")
                },
                "phase15 wave A quiet live wave (with the audit lane)":
                    r15["A"]["quiet"]["launches"],
                "phase15 wave A live wave with the spills (with the audit "
                "lane)": r15["A"]["spill_wave"]["launches"],
                **{
                    f"phase15 wave O --frontend {fe} --log-fmt {fmt}, "
                    "kernel-only": run["launches"]
                    for (fmt, fe), run in r15["O"]["runs"].items()
                },
                **{
                    f"phase16 wave X --{name}, kernel-only (0 under xla)":
                        run["serving_launches"]
                    for name, run in r16["X"].items()
                },
                **{
                    f"phase17 wave A --mesh {spec}, native, kernel-only":
                        r17["A"][spec]["serving_launches"]
                    for spec in ("auto", "data:1")
                },
                **{
                    f"phase17 wave V {label}, {MESH_WAVE} reviews through "
                    "validate_batch (positions x K1 steps)": row["k1_launches"]
                    for label, row in r17["V"]["forms"].items()
                },
                **{
                    f"phase17 wave D rank {rep['rank']} of a global data:2 "
                    "mesh on one card, native": rep["launches"]
                    for rep in r17["D"]["reports"]
                },
                **{
                    f"phase17 wave R --mesh {spec}, native, kernel-only "
                    "(positions x K1 steps)": run["serving_launches"]
                    for spec, run in r17["R"].items()
                },
                **{
                    f"phase18 wave T --mesh {spec} --mesh-dispatch threaded, "
                    "native, kernel-only (sum over shards of K1 steps x row "
                    "positions)": row["serving_launches"]
                    for spec, row in r18["T"].items()
                },
                f"phase18 wave Z {THREADED_Z_SPEC} threaded evaluator, "
                f"{THREADED_WAVE} reviews on {THREADED_Z_THREADS} threads "
                "across two resizes": r18["Z"]["serving_launches"],
            },
            "phase9_launches_by_environment": [
                {k: row[k] for k in (
                    "tenant", "shard", "policy_matrix_warmup_launches",
                    "policy_matrix_serving_launches",
                )}
                for row in r9["envs"]
            ],
            "reload_candidates": [
                {"warmup": c["k1_warmup"], "canary": c["k1_canary"]}
                for c in r8["candidates"]
            ],
            "max_abs_err": max(
                k1_err, r8["k1_err"], r9["k1_err"], r10["k1_err"],
                r12["cel"]["err"], r13["fetch"]["k1_err"],
                *(h["err"] for h in r13["context"]["holds"]),
            ),
            "max_abs_err_by_program": {
                "phase13 fetched flagship artifacts": r13["fetch"]["k1_err"],
                **{
                    f"phase13 context rows, {h['namespaces']} namespaces":
                        h["err"]
                    for h in r13["context"]["holds"]
                },
                "phase12 lowered CEL programs, B in "
                f"{CEL_BATCHES}, both buckets and forms": r12["cel"]["err"],
                "phase2 flagship set": k1_err,
                "phase8 changed set (team-a in phase 9)": r8["k1_err"],
                "phase9 team-b set": r9["k1_err"],
                "phase10 flagship set on the audit inventory, B in "
                f"{AUDIT_HOLD_BATCHES}": r10["k1_err"],
                f"phase17 per-shard programs ({r17['V']['held']}: "
                f"{', '.join(m for m in MESH_ONE_CARD if 'policy' in m)}, both "
                f"buckets, B in {MESH_HOLD_BATCHES})": 0,
                f"phase18 threaded shard programs "
                f"({sum(r['held'] for r in r18['T'].values())}: "
                f"{', '.join(THREADED_SPECS)}, both buckets, B in "
                f"{MESH_HOLD_BATCHES})": 0,
            },
            "audit_inventory_holds": [
                {k: row[k] for k in ("bucket", "batch", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "max_abs_err")}
                for row in r10["holds"].values()
            ],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "probe",
            "route": "cuda",
            "source": "policy_server_tpu_torch/csrc/policy_matrix.cu",
            "replaces": "policy_server_tpu/ops/pallas_kernels.py:83",
            "launches": native_runs["kernel", 4]["launches"]["probe"],
            "launches_from": (
                f"phase 7 native HTTP run {kernel_label}, 4 pipeline "
                f"workers: the environment's build"
            ),
            "launches_by_path": {
                "phase8 reload path (server build and every candidate's "
                "build)": r8["launches"]["probe"],
                "phase9 tenants and shards (one per environment)": r9["launches"]["probe"],
                **{
                    f"phase9 --serving-shards {n} (server build)": r["probe"]
                    for n, r in r9["rates"].items()
                },
                "phase10 audit path (server build and the reload "
                "candidate's build)": r10["launches"]["probe"],
                "phase11 TLS and prefork servers (one build each)":
                    r11["launches"]["probe"],
                "phase12 wasm set servers, the deadline server and the "
                "CEL hold (one build each)": r12["probe"],
                **{
                    f"phase13 wave F --frontend {fe} (the boot's build)":
                        run["boot"]["launches"]["probe"]
                    for fe, run in r13["fetch"]["F"].items()
                },
                f"phase13 wave R ({RELOAD_TAG_CYCLES} reloads: each candidate's "
                "build and the "
                "file watch's)": sum(
                    c["reload_launches"]["probe"]
                    for c in r13["fetch"]["R"]["cycles"]
                ),
                "phase13 wave W (server build and the audit run)":
                    r13["watch"]["launches"]["probe"],
                **{
                    f"phase14 {step} boot (its build)":
                        r14[step]["build_launches"]["probe"]
                    for step in ("cold", "warm", "changed", "flipped", "again")
                },
                **{
                    f"phase15 wave A {step} boot (its build)":
                        r15["A"][step]["build_launches"]["probe"]
                    for step in ("cold", "warm", "flipped")
                },
                **{
                    f"phase16 wave X --{name} (its build)":
                        run["boot"]["launches"]["probe"]
                    for name, run in r16["X"].items()
                },
                **{
                    f"phase18 wave T --mesh {spec} --mesh-dispatch threaded "
                    "(one per shard environment built)":
                        row["boot_probe_launches"]
                    for spec, row in r18["T"].items()
                },
            },
            "reload_candidates": [c["probe"] for c in r8["candidates"]],
            "max_abs_err": probe_err,
            "ms": probe_ms,
            "plain_ms": probe_plain_ms,
            "bound_ms": max(probe_bound_bytes_ms, probe_bound_ops_ms),
            "bound_by": (
                "bytes" if probe_bound_bytes_ms >= probe_bound_ops_ms
                else "operations"
            ),
            "library_ms": probe_lib_ms,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": kind,
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--native-client"]:
        sys.exit(native_client_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--stream-client"]:
        sys.exit(stream_client_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--recovery-server"]:
        sys.exit(recovery_server_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--cache-boot"]:
        sys.exit(cache_boot_main(sys.argv[2:]))
    sys.exit(main())
