#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing one line (any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc for every ``antidote_ccrdt_tpu_torch/csrc/*.cu`` at once,
   with each kernel's registers and spills from ``-Xptxas -v``;
3. kernels: K1 (in place), K1c (out of place, on a contiguous table and
   on a stride-0 broadcast view), K2 and K3 against their plain PyTorch
   versions on the card at the main path's shapes (``torch.equal``),
   timed with CUDA events beside their byte bound and one library call
   computing the same function; K1c also at the shapes of
   ``benchmarks/micro_tombstone.py``'s ``pallas_bf16`` probe;
4. main path: ``DenseReplay(make_dense("topk_rmv", ...), 32)`` for 8
   rounds of 32 768 adds + 2 048 removals per replica, a sync every 4
   rounds and an observe; every apply round must launch each of the main
   path's kernels (K1c, K2, K3);
5. profile: one more round and sync of the main path under
   torch.profiler — device time by kernel and the device's idle share;
   then each kernel of phase 3 alone under torch.profiler, its device
   time without the launch (no profiler session runs before phase 4,
   whose host launches it could slow);
6. identity: a reduced seeded replay on the CPU (plain versions) and on
   the card (kernels) must end in bit-identical states;
7. batch_merge: the north-star ``batch_merge("topk_rmv", states)`` of 32
   scalar states (one DC each, 8 192 adds and 512 removals per state over
   100 000 ids, K = 100), built from seeded draws (and checked against
   the scalar ``update`` at a reduced size), held against an independent
   host set join; the converter's canonicalising K3 call (W = M <= 16, a
   half-warp a row) and every fold level's K3 join (W = 2M > 16, a warp a
   row) held against their plain versions on their full inputs and timed
   (CUDA events and device-only) beside their times before the warp
   kernel's redesign, their byte bounds and their data-dependent bounds;
   host convert, fold and extract times; a reduced ``batch_merge`` of each
   other type at its BASELINE.json replica count equal on the card and the
   CPU; both K3 paths must have launched;
8. wide rows: ``batch_merge("topk_rmv", states)`` whose capacity M = 8 400
   (> 8 192, so the converter's call at W = M and the fold's at W = 2M take
   K3's global path) against the host set join, and that path held
   against its plain version on the converter's and the first fold level's
   full inputs; then the same at M = 2 000, where both calls take K3's
   block path (256 < W <= 8 192); then the block path at 65 536 rows of
   W = 512 (a fold at M = 256), held likewise. Each call timed (CUDA events,
   and on the device every kernel of K3's chain per call) beside the plain
   version and its bound as the inputs need it (W comparisons a row of two
   sorted runs, W log2 W a row to sort, each byte moved once);
9. coalesced replay: ``DenseReplay.apply_coalesced`` of 4 batches at the
   main path's shapes (whole-log compaction of 139 264 ops per replica,
   then one apply that must launch K1c, K2 and K3), the coalesce and the
   apply timed apart, the peak memory of the coalesce, the op counts in
   and out, beside the same 4 batches applied one by one; the coalesced
   batch applied again with every K1c, K2 and K3 call held against its
   plain version on that call's inputs, ending in the same state; one
   coalesce under torch.profiler (device time by kernel, idle share); at a
   reduced size the coalesced ops and the applied state equal on the CPU
   and the card;
10. MONOID engines, deltas and laws: ``DenseReplay`` of average,
   wordcount and worddocumentcount (``apply_doc_ops_compact``) at
   ``benchmarks/bench_all.py``'s shapes, 4 rounds with a duplicated
   contributor in the sync after round 2, bit-identical to the same run on
   the CPU; ``make_delta``/``apply_any_delta`` on phase 9's state give it
   back bit for bit; ``coalesce_deltas`` of 3 chained wordcount deltas
   equals the interval's delta; ``check_engine_laws`` holds for the six
   registered fixtures on the card (the topk_rmv fixture's merges must
   launch K3, each call held against the plain K3) and catches the broken
   merge;
11. durable host: ``scripts/end_to_end_demo.py``'s flow at the main
   path's width (R = 32, 100 000 ids, M = 4, K = 100), 4 rounds: seeded
   adds and removals (each removal carrying its origin's frontier) go
   into the native C++ host, every replica drains its causal batch onto
   the card, and the stacked round is applied (each round must launch
   K1c, K2 and K3); every round is logged to an ``ElasticWal`` (group
   durability, 8 partitions over 4 streams) and flushed, with a
   checkpoint after round 2; the log is dropped without a close, and a
   fresh one recovers the live state leaf for leaf and digest for digest
   (K3 launched in the recovery, each call held against the plain K3);
   the state after round 3 is repaired to the live one by the psnaps of
   its divergent partitions, through the CCPT and dense-blob encodings,
   and must equal their join; the 32 replica rows fold to a full top-K;
   all backlogs drain. Then ``benchmarks/bench_all.py``'s
   worddocumentcount corpus as raw strings through the native tokenizer
   (replica 0 equal to the pure-Python path) onto the card;
12. gossip: ``tests/test_net_chaos.py``'s chaos drill at the main path's
   width: four members on the port's ``SimNet`` (seed 7, 5 % loss, 5 %
   duplication, a partition that heals, a crash), each with its own
   R = 32 x 100 000-id state on the card, applying elastic_demo-seeded
   batches (32 768 Zipf(1.2) adds and 2 048 removals a replica) for the
   replicas it owns, adopting replicas by re-applying their history,
   publishing chained deltas and anchors (``DeltaPublisher``) and
   sweeping its peers' (``sweep_deltas``) every second step, then a
   fault-free tail until every survivor's digest (the observable top-100
   of all replicas folded) equals the sequential reference; every sweep
   must skip nothing, the simulator's fault counters must all have
   fired, K1c, K2 and K3 must have launched, and every kernel call of
   member m0 is held against its plain version. The same drill at
   R = 4, I = 4 096 on the CPU and on the card ends in equal states and
   counters. Then two ``TcpTransport`` members on 127.0.0.1 at
   I = 40 000 (the widest anchor under ``MAX_FRAME``) pass an anchor and
   three chained deltas, the receiver's state equal to the sender's;
13. served fleet: (a) the read plane at the main path's width: phase 4's
   engine and seeded batches, 2 apply rounds each swapped into a
   ``ServePlane``, materialized (the fold's K3 joins, ``observe``, the host
   pull, timed apart) and read by 4 client threads sending frames of
   1 024 queries in ``scripts/serve_demo.py``'s mix through ``handle()``
   (one frame a round over a ``TcpTransport`` query frame): every value
   equals the engine's ``value()`` of the snapshot at its ``as_of_seq``,
   every staleness bound covers the snapshot's true age; (b)
   ``scripts/serve_demo.py``'s fleet with ``scripts/write_tier_demo.py``'s
   writers, in process on the card: 3 workers (``TcpTransport``,
   ``GossipNode``, ``ServePlane``, ``IngestPlane``, ``ElasticWal``) over
   R = 32 replicas, NK = 4 keys, 4 096 ids, a full-snapshot sweep every
   step for 7 steps, 4 query threads and 3 write sessions (acks
   ``durable`` and ``replicated_to_k``, every ack read back by its
   session) under the demos' seeded faults, the hot key's owner failing
   after its publish at step 3; gates: no bound violation, no identity
   mismatch, both certificates verified, the survivors at the sequential
   reference digest (every replica's ops and every folded client write),
   the write tier's counters lit, worker w0's K1c, K2 and K3 calls held
   against their plain versions; the same flow at R = 4, 1 024 ids with
   no threads or faults gives equal answer bytes, certificates and
   digests on the CPU and the card (run beside phase 24's start-up);
14. overlap and pager: (a) ``tests/test_overlap.py``'s overlapped chaos
   drill at the main path's width: phase 12's members, faults, ops and
   adoption, the inbound half of every member through an
   ``OverlapPipeline`` (queue depth 3, a threadless ``prefetch.poll()``
   every round, ``drain_into`` every third round, so that the queue
   sheds); gates: the survivors at the sequential reference, folds and
   dropped deltas counted, no apply error, m0's kernel calls held against
   their plain versions; (b) 3 members on ``FsTransport``, 3 rounds
   serially (publish, ``sweep_deltas``) and 3 overlapped (publishes on the
   ``HostStage``, fetches on the ``DeltaPrefetcher`` thread,
   ``drain_into``), each arm closed by a serial tail: equal digests at the
   reference, round p50/p99 of each arm, the host stage's stalls; (c)
   ``scripts/working_set_demo.py``'s drill at the main path's width: 3
   workers, 32 partitions, each ``PartitionPager``'s budget a tenth of the
   563 MB state (the cold tier in pinned host memory), Zipf(2.2) accesses
   through ``ensure_resident`` before every apply, the partition plane's
   publisher, partial anti-entropy and delta sweeps through the pager;
   the demo's gates (converged, equal to an all-resident sequential
   reference, state >= 10x the budget, evictions, hydrations and cold
   folds, hit rates >= 0.9, no wasted psnap, the hydrate span lit) and an
   all-resident arm with equal digests; then (a) and (c) at R = 4,
   I = 4 096 on the CPU and the card, equal states, digests and counters
   (run after phase 17, beside phase 22's reap);
15. bridge: (a) ``bridge/server.py`` and ``bridge/client.py`` over TCP on
   127.0.0.1, both in this process: a topk_rmv grid of the main path's
   geometry (563 MB on the card) fed phase 4's op stream (seed 7, 32 768
   Zipf(1.2) adds and 2 048 removals a replica and round) as 2
   ``grid_apply_packed_multi`` calls of 4 batches (each frame under the
   256 MiB limit), one ``grid_apply_extras_packed`` round,
   ``grid_merge_all``, ``grid_observe(0, 0)`` and the snapshot round trip
   (``grid_to_binary``, ``grid_from_binary`` into a second grid,
   ``grid_to_binary`` again; through the server's dispatch, the snapshot
   being past the frame limit); gates: the snapshot equals the engine
   driven directly on the same planes (9 applies, the same fold), the
   round trip is byte-equal, the replies equal the direct engine's; the
   client's time a call, the server's split of it (parse, build, pack,
   stack, upload, apply, readback), wire ops/s beside phase 4's rate,
   peak memory; the same calls again on a second grid with every K1c, K2
   and K3 call held against its plain version (same end state), while (c)
   a second connection's scalar round trips are counted against their
   idle rate (at least a tenth); (b) ``benchmarks/bench_all.py``'s
   bench_grid_wire mix at its own shapes (R = 8, B = 4 096, 3 calls a
   surface: the tuple and packed surfaces of the six types, packed multi
   of 8 batches, batch_merge of 32 scalar binaries of 200 adds equal to
   the direct batch_merge, its fold's K3 calls held), and the same calls
   at R = 4, I = 4 096 on the CPU and the card with equal replies,
   snapshots and batch_merge states;
16. mesh: (a) phase 4's engine and op stream, each replica row fed its
   own batches for 3 rounds, placed on a (dc, key) = (2, 4) ``MeshPlan``
   over eight logical devices of the card (P = 8), then ``ici_reduce``
   (8 K3 joins, each held against the plain K3 in a second reduce): each
   row is the join of its dc block, the fold's observable is unchanged, a
   second reduce changes no bit, the leaves stay tagged, the stitched
   digest vector, every shard's psnap blobs and ``save_mesh_checkpoint``'s
   files equal the unsharded producers', the plan over the real device
   list is (1, 1) and ``install_from_env`` is None; (b)
   ``IdShardedTopkRmv`` on the same mesh at the main path's width (25 000
   ids a shard) fed phase 4's global-id batches for 4 rounds against the
   unsharded engine: equal ``observe`` and tables, ``merge_replicas`` rows
   the dc block joins, one round's K1c, K2 and K3 calls held; (c)
   ``tests/test_mesh.py``'s mesh chaos drill (seed 7) and
   ``tests/test_parallel.py``'s sharded leaderboard, topk and wordcount at
   their own shapes, equal on the CPU and the card;
17. multihost: (a) 2 worker processes of
   ``antidote_ccrdt_tpu_torch/scripts/multihost_demo.py`` on the card
   (gloo, 16 logical devices each, R = 32), each applying its rows of one
   round of phase 4's stream and joining them with
   ``parallel.multihost.hierarchical_reconcile`` (the dc reduce inside
   the process, the dcn exchange of whole 282 MB blocks through pinned
   host memory), then saving the global state collectively with DCP
   (``harness/orbax_ckpt.py``); this process restores the checkpoint
   whole onto another layout, and it must equal PR 13's single-process
   ``parallel.sharded.hierarchical_all_reduce`` over (2, 16) logical
   devices leaf for leaf, its observable the sequential fold's; that
   reference's apply of one process's rows and its reduce held against
   the plain kernels; (b) ``tests/test_multihost.py``'s world (2 x 4, 256
   ids) on the CPU, on the card and as one process under nccl, equal; (c)
   two ``OrbaxGossip`` sites at the main path's width on (4, 1) and (2,
   1) meshes of the card: one exchange converges and keeps each site's
   layout, a second publish is seen, a cursor sweep of an unchanged peer
   merges nothing; every spawned world killed after a timeout; each
   17a worker and each card worker of 17b must launch K1c, K2 and K3;
   17a's and 17b's worlds (processes only) run beside phase 14c's drill;
18. elastic workers: the drill workers of
   ``antidote_ccrdt_tpu_torch/scripts/`` as real processes. (a) 3
   ``elastic_demo.py`` workers on the card at the main path's width
   (``--shape main``: R = D = 32, 100 000 ids, K = 100, M = 4, phase
   12's stream of 32 768 Zipf(1.2) adds and 2 048 removals a replica and
   step), each with its own 563 MB state, gossiping chained deltas and
   anchors through a shared directory for 10 steps, w1 dying at step 4
   (the failure detector slowed to an 8 s timeout and a 0.25 s heartbeat,
   the final barrier's window to 60 s, so that an anchor publish is not
   taken for a death), the span plane and the device observatory on,
   their spill kept for phase 19d; gates: w1 exits 1, the survivors 0 with digests
   equal to a sequential reference this process computes on the card from
   phase 12's ``GossipOps`` (every replica, every step) before the phase,
   which runs beside phases 11 and 16, w1 out of their
   alive view, each survivor's first K1c, K2 and K3 call equal to the
   plain version; (b) ``crash_recovery_demo.py``'s wal and adopt arms
   (group durability) at elastic_demo's width on the card and on the CPU,
   the four supervisors at once: every verdict ok, the card fleets'
   final digests the CPU fleets'; (c) ``net_gossip_demo.py``'s TCP crash
   drill (3 workers, w1 dying at step 4) at elastic_demo's width:
   survivors at the reference, retries and received frames counted; (b)
   and (c) run beside (a). Each fleet is killed, every process group of
   it, after a time limit; each 18a worker must launch K1c, K2 and K3;
19. observability fleets: the operator tools of
   ``antidote_ccrdt_tpu_torch/scripts/`` as subprocesses on the card. (a)
   ``obs_dashboard --demo`` (3 TCP workers of ``net_gossip_demo.py`` at
   elastic_demo's width, live HTTP and in-band scrapes, every delta's
   complete path, ``ccrdt_trace``); (b) ``spans_demo`` (coverage at least
   0.5, every phase lit, clock offsets, each worker's rounds), its
   coverage, rounds, offset edges and each phase's p50; (c)
   ``overlap_demo`` whole: both arms' digests the reference, the pipeline's
   counters, round.e2e p50 at least 0.30 below the serial arm's, each
   arm's dispatch gap; (d) the spill of phase 18a's crash drill
   (``CCRDT_SPANS=1``, ``CCRDT_DEVPROF=1``), read at once by
   ``ccrdt_spans merge`` (spans of both survivors) and ``attribute``,
   ``ccrdt_trace summary`` and ``ccrdt_devprof churn`` and
   ``watermarks``, each survivor's step loop printed from its spans (each
   phase's p50, the step at which the first peer window was applied, the
   anchor snapshots beside the steps); (e) ``ccrdt_audit laws`` on the card
   equal byte for byte to the CPU's, ``laws --selftest``, and ``certify
   --final-dir`` and ``verify`` over (b)'s fleet against this process's
   reference; (a), (b) and (e)'s law checks at once beside phase 14a's
   drill, (e)'s certify once (b) is done, (d)'s reads at once beside
   phase 14c's drill (after 17's worlds), (c) alone; the worker reports
   of (a)-(c) counted, each of them must launch K1c, K2 and K3;
20. anti-entropy gates: (a) a TCP probe (1, 130 and 225 MB deltas between
   two ``TcpTransport``s, landed byte for byte), then
   ``partition_demo.run_drill`` in this process at R = D = 32, 40 000 ids (225 MB a member, the widest anchor under
   ``MAX_FRAME``), K = 100, M = 4, 32 768 uniform adds and 2 048 removals
   a replica and step, P = 8, 10 steps (cut from the demo's 12): 3
   ``TcpTransport`` members, w2 out of the
   gossip for steps 4-8 while every op hits one partition p*, then the
   whole-snapshot and the digest-and-psnap repair from the same state;
   all seven of the demo's checks (at least 5x fewer repair bytes,
   bit-identical repair digests, the fleet's digest vectors agreeing and
   equal to the sequential reference with every replica owned,
   divergence confined to p* and meta, resyncs counted, no wasted
   psnap), every K1c, K2 and K3 call held against its plain version, and
   the seconds from each peer's last pre-outage delta landing at w2 to
   w2's sweep logged; the drill at the demo's width on the CPU and the card, equal reports but
   for the counters that hang on thread timing; (b) ``topo_demo`` whole
   (two legs of six ``net_gossip_demo`` workers at elastic_demo's width,
   two zones, the za anchor SIGKILLed in the first): every survivor at
   the reference in both legs, cross-zone frames and relays, a failover
   event off the victim, at most half the full mesh's cross-zone sends,
   each worker's first K1c, K2 and K3 call equal to the plain version,
   its fleet run beside phase 12's drill; each of (a) and (b) must
   launch K1c, K2 and K3;
21. certified convergence: (a) ``audit_demo``'s divergent arm at the
   main path's width in this process (three steps of elastic_demo's
   stream on every replica, a twin with one more add of id 17, each
   K1c, K2 and K3 call held against its plain version): p* among the
   divergent partitions, the watchdog's ok, diverged, wedged, ok, and a
   failed, verified certificate naming exactly the divergent partitions;
   the arm at the demo's width equal on the CPU and the card (a frozen
   wall clock); two fleets at once on the card (beside phase 12's
   drill, after 20b's topo_demo), then the law checker (every registered
   type, 32 pairs, the broken merge caught): ``run_healthy`` (3 ``net_gossip_demo`` workers at
   elastic_demo's width, seeded ``tcp.send`` drops, 8 partitions, each's
   first kernel calls held: certificate OK and verified, no wedge alarm),
   ``run_durability`` (the async wal crash drill certified with its
   durability watermark, the fabricated pre-fsync loss flagged with
   [6, 9] uncovered); (b) ``multichip_demo.phase_b`` (3 ``elastic_demo``
   workers of 8 logical devices each at the main path's width, each's
   first kernel calls held, ``CCRDT_MESH=1``, w1 SIGKILLed at anchor seq
   3-7: every check of the demo) beside its phase A in this process, at
   the same width (a (2, 4) mesh of 8 logical devices, an ``FsTransport`` pair, one partition diverged and repaired
   through the mesh-grouped partial anti-entropy: at least 5x fewer
   bytes, bit-identical digests, the cross-slice counters lit, no wasted
   psnap, the anchor published per shard; 20 ``ici_reduce`` calls timed),
   then at the demo's width equal on the CPU and the card, digest vectors
   included; each of the divergent arm, the fleets and phase A must
   launch K1c, K2 and K3;
22. write tier: ``write_tier_demo`` whole as a subprocess on the card:
   4 ``net_gossip_demo`` workers (serve and ingest planes, a crash WAL
   each, seeded ``tcp.send`` drops and ``serve.write`` delays) at R = D =
   32, 10 000 ids, K = 100, M = 4 (18a's Zipf stream, 56 MB a worker,
   the slowed detector of 18a), each worker's first K1c, K2 and K3 call
   held, 3 write sessions through a ``WriteRouter`` (``router.write``
   drops, acks ``durable`` and ``replicated_to_k``, each ack read back
   through a ``FleetRouter``), the hot key's owner SIGKILLed at step 13
   of 24 (the demo's steps, kill and pacing); gates: all 17 of
   the demo's checks, the SIGKILL mid-load after hard acks from the
   victim, each survivor's launches of K1c, K2 and K3 and its held calls
   equal to the plain versions, the honest and session certificates
   verified, the violating arm's counterexample naming [8, 20];
23. read tier: ``read_tier_demo`` whole as a subprocess on the card: 4
   ``net_gossip_demo`` workers (the serve plane, seeded ``tcp.send`` drops
   and ``serve.query`` delays) at phase 22's width and stream with the
   slowed detector of 18a, each worker's first K1c, K2 and K3 call held,
   3 clients reading through two ``FleetRouter``s (HRW order, breakers,
   retries, ``router.route`` drops, one hedging, ``ClientSession``
   tokens), the rendezvous head of "k0" SIGKILLed mid-load at step 5 of
   the workers' 10 (the demo's depth, kill and pacing); gates: all 11 of
   the demo's checks at its bounds (at least 300 reads/s, p99 at most
   1 500 ms, a blip of at most 5 000 ms, no read over 10 s, no read
   ``unavailable``), the SIGKILL, reports from exactly the three
   survivors, each's launches of K1c, K2 and K3 and its held calls equal
   to the plain versions, the clean session certificate with reads and
   writes, the violating arm's counterexample (session demo-violating,
   origin w0, have < want);
24. request tracing: ``rtrace_demo`` whole as a subprocess on the card:
   4 ``net_gossip_demo`` workers (the serve plane, the rtrace plane
   armed, seeded ``tcp.send`` drops and ``serve.query`` stalls, a 60 s
   serve linger after the final) at phase 23's width and stream with the
   slowed detector of 18a, each worker's first K1c, K2 and K3 call held,
   3 traced clients (sample 1.0) through two ``FleetRouter``s
   (``router.route`` drops, one hedging), the rendezvous head of "k0"
   SIGKILLed 2 s into the storm with a probe held in flight at it, then
   the paired overhead window against ``CCRDT_RTRACE=0`` on the quiesced
   survivors (the demo's 14 steps at 1.4 s and its windows); gates: all
   14 of the demo's checks at its bounds (overhead at most 5 %,
   attribution coverage at least 0.9 at p50 and p99, at least 99 % of
   waterfalls complete, a blip of at most 5 000 ms, no read over 10 s,
   no read ``unavailable``), the SIGKILL with the probe in flight,
   reports from exactly the three survivors, each's launches of K1c, K2
   and K3 and its held calls equal to the plain versions, and the port's
   ``ccrdt_rtrace`` over the run's own spill: the report's dead_reroute
   trace's waterfall shows the victim's ``dead_reroute`` row, a stored
   trace that failed over shows that row and then a survivor's answer,
   ``attribute`` names a p99 dominant bucket. Phases
   22, 23 and 24 run last, one after the other, each demo's storm with
   nothing beside it: phase 17 and then phase 14's reduced twin run
   beside 22's reap (the survivors' detector, adoption and final barrier,
   which no check of the demo times), phase 21 beside 23's, and phase
   13's reduced twin beside 24's start-up (the script fails if it ran
   into 24's storm); 24's wait for the finals and its overhead window run
   alone;
25. the kernels line (launches on each path that drives a kernel, phases
   9-24 included; phase 17's are its workers' and its sites', not the
   reference's; phases 18-24 their card workers', 20a's drill, 21a's
   divergent arm and 21b's phase A with phase B's reference), then the
   ok line.

Imports nothing of JAX. Without a card, or outside the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SECTOR_BYTES = 32  # the device memory's access granule
INT32_OPS_PER_S = 67e12  # H100 SXM scalar 32-bit rate (the fp32 non-tensor peak)

# The main path's shapes (bench.py main(): R=32, I=100 000, B=32 768,
# Br=2 048, D=R, M=4, K=100).
R, I, B, BR, M, K = 32, 100_000, 32_768, 2_048, 4, 100
ROUNDS, SYNC_EVERY = 8, 4

# The north-star batch_merge (BASELINE.json "topk_rmv K=100 with concurrent
# add/rmv, 100k keys, 32 replicas"): N states, one DC each, uniform ids.
BM_N, BM_IDS, BM_ADDS, BM_RMVS = 32, 100_000, 8_192, 512
# The other types at their BASELINE.json replica counts, reduced in ops.
BM_OTHERS = {"topk": 8, "leaderboard": 16, "wordcount": 64, "worddocumentcount": 64, "average": 2}
# K3's times on those calls before the warp kernel's redesign, as PERF.md
# records them (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W): the
# converter's call at W = 13, then the fold's levels at W = 26.
EARLIER_K3_MS = {"convert": 1.492, "levels": [2.27, 1.15, 0.59, 0.30, 0.16]}
# Capacity of the wide-row check: past K3's shared-memory rows (8 192).
WIDE_M = 8_400
# Capacity of the block-path check: 256 < M and 2M <= 8 192.
BLOCK_M = 2_000
# Batches per coalesced round: the rounds between two syncs in phase 4.
COALESCE_K = 4
# The durable host (scripts/end_to_end_demo.py's distributions at the
# main path's width): adds U[512, 1024] and removals U[0, 64] per origin
# and round; partitions of the WAL and the digests.
DH_ADDS, DH_RMVS, DH_ROUNDS, DH_PARTS = 1_024, 64, 4, 8
# benchmarks/bench_all.py's worddocumentcount corpus: replicas x documents
# x words of a 50 000-word Zipf(1.1) vocabulary, 2^16 buckets.
DOC_SHAPE, DOC_VOCAB, DOC_BUCKETS = (64, 512, 64), 50_000, 1 << 16
# benchmarks/micro_tombstone.py's probe (pallas_bf16): removal rows per
# replica.
PROBE_BR = 1_024
# Phase 12's gossip drill: tests/test_net_chaos.py's members, steps,
# virtual seconds a step and ownership horizon, and its fault schedule
# (partition {m0, m1} | {m2, m3} at step 3, heal at 6, crash m3 at 7);
# SimNet(seed=7, latency=(0.001, 0.02), loss=0.05, dup=0.05); a quiescent
# tail of at most 40 rounds. The ops of each (step, replica) are seeded as
# scripts/elastic_demo.py seeds them, at the main path's width.
GOSSIP_MEMBERS, GOSSIP_STEPS, GOSSIP_DT, GOSSIP_TIMEOUT, GOSSIP_TAIL = 4, 10, 0.1, 0.35, 40
GOSSIP_SEED, GOSSIP_LATENCY, GOSSIP_LOSS, GOSSIP_DUP = 7, (0.001, 0.02), 0.05, 0.05
# The reduced width (R, I, B, Br) of the CPU == card run of the same drill.
GOSSIP_SMALL = (4, 4_096, 256, 32)
# The TCP pair: the largest id count whose anchor fits the frame limit of
# bridge/protocol.py (MAX_FRAME, 256 MiB), and the chained deltas after it.
TCP_IDS, TCP_DELTAS = 40_000, 3
# Phase 13a, the read plane at the main path's width: apply rounds each
# swapped into a ServePlane, client threads sending frames of queries in
# scripts/serve_demo.py's mix for a window after each swap (cut from 4
# rounds to 2 for time).
SERVE_ROUNDS, SERVE_CLIENTS, SERVE_FRAME, SERVE_WINDOW_S = 2, 4, 1_024, 1.0
# Phase 13b, the served fleet: scripts/serve_demo.py's flow (3 workers on
# TcpTransport sockets, a full-snapshot sweep every step, 4 query threads
# sending frames of 1 024 queries over NK = 4 keys) with
# scripts/write_tier_demo.py's writers (3 write sessions through a
# WriteRouter, acks durable and replicated_to_k, bursts of 3 ids x 4 adds
# kept to M per id) and its fault plans; the hot key's owner fails after
# its publish at FLEET_KILL_AT. Width (R, I, B, Br): R = D = 32, M = 4,
# K = 100 as the main path, the demo's 4:1 adds to removals, I cut to
# 4 096 ids a key for time (every step publishes each worker's whole
# state over TCP). Cut from 10 steps with the kill after step 5 to 7 steps
# with the kill after step 3, for time; the writers still run a step past
# the kill (they stop at step FLEET_STEPS - 2).
FLEET_MEMBERS, FLEET_STEPS, FLEET_KILL_AT, FLEET_NK, FLEET_TAIL = ("w0", "w1", "w2"), 7, 3, 4, 10
FLEET = (32, 4_096, 2_048, 512)
FLEET_WRITERS, FLEET_IDS_PER_BURST, FLEET_ADDS_PER_ID, FLEET_STALENESS_S = 3, 3, 4, 60.0
# The fleet's query threads wait this long between frames, so that the
# workers' steps keep a share of the interpreter (13a reads flat out).
FLEET_QUERY_GAP_S = 1.0
# How long a write's read-back may keep asking until a worker's snapshot
# covers its session (at least a step of the fleet).
FLEET_READBACK_S = 120.0
FLEET_FAULTS = {  # serve_demo's and write_tier_demo's plans, in one process
    "tcp.send": [{"action": "drop", "rate": 0.02}],
    "serve.query": [{"action": "delay", "rate": 0.01, "delay_s": 0.002}],
    "serve.write": [{"action": "delay", "rate": 0.05, "delay_s": 0.002}],
    "router.write": [{"action": "drop", "rate": 0.05}],
}
# write_tier_demo's counters that must be nonzero after the storm.
FLEET_NONZERO = ("router.writes", "router.write_successes", "router.write_failovers",
                 "write_session.flushes", "write_session.staged_ops")
# The reduced width of the CPU == card run of the same flow (no threads,
# no faults, frozen clocks, so that its bytes are comparable).
FLEET_SMALL = (4, 1_024, 64, 16)
# Phase 14a, tests/test_overlap.py's run_overlap_chaos at the main path's
# width: phase 12's members, simulator, faults, ops and publisher, with the
# inbound half through one OverlapPipeline a member (queue depth 3, a
# threadless poll() every round, drain_into every third round, so that the
# queue sheds).
OVERLAP_DEPTH, OVERLAP_DRAIN_EVERY = 3, 3
# Phase 14b, serial against overlapped rounds with live threads: 3 members
# on FsTransport (wall clock), DeltaPublisher(full_every=4); the overlapped
# arm publishes on the pipeline's HostStage and fetches on its
# DeltaPrefetcher thread; a serial tail then converges each arm. Cut from
# 4 rounds an arm to 3, for time: the serial arm's tail then publishes a
# delta where it published a 563 MB anchor (full_every=4).
PIPE_MEMBERS, PIPE_STEPS, PIPE_TAIL = ("p0", "p1", "p2"), 3, 20
# Phase 14c, scripts/working_set_demo.py's run_drill at the main path's
# width: 3 workers on FsTransport, P = 32 partitions, each pager's budget a
# tenth of the state, the demo's add-only batches (96 Zipf(2.2) ids a
# replica and step, seeded per (seed, step, replica)), `ensure_resident`
# before every apply, hit counters reset after step WS_WARM, a tail of at
# most 80 rounds; the demo's gates. Replica rows split over the workers as
# phase 12 splits them. Cut from the demo's 10 steps to 2 for time (each
# step of each arm publishes and sweeps 563 MB anchors on the host; the
# publisher's full_every=2 makes the first and third steps' publishes
# anchors, so the third step was the dearest), the hit counters reset
# after the first step's applies, so that the second step's accesses are
# counted after a warm-up of one.
WS_MEMBERS, WS_STEPS, WS_WARM, WS_TAIL, WS_P, WS_ZIPF, WS_SEED = ("w0", "w1", "w2"), 2, 0, 80, 32, 2.2, 7
WS_B, WS_BR, WS_MIN_HIT, WS_MIN_RATIO = 96, 8, 0.9, 10.0
# The reduced widths (R, I, B, Br) of the CPU == card runs of 14a and 14c.
OVERLAP_SMALL, WS_SMALL = GOSSIP_SMALL, (4, 4_096, WS_B, WS_BR)
# Phase 15a, the bridge at the main path's width: one BridgeServer on the
# card and one BridgeClient over 127.0.0.1, a topk_rmv grid of phase 4's
# geometry fed phase 4's op stream (seed 7) as BRIDGE_CALLS
# grid_apply_packed_multi calls of BRIDGE_MB batches, then one
# grid_apply_extras_packed round.
BRIDGE_CALLS, BRIDGE_MB = 2, 4
# Phase 15b, benchmarks/bench_all.py's bench_grid_wire mix at its own
# shapes: R replicas x B ops a call, CALLS timed calls a surface (after one
# untimed call), packed multi calls of MB batches, and batch_merge of
# BM_STATES scalar topk_rmv binaries of BM_ADDS adds; WIRE_SMALL (R, I, B)
# is the CPU == card run of the same calls (B cut from 4 096 for the CPU's
# time).
WIRE_R, WIRE_B, WIRE_CALLS, WIRE_MB, WIRE_BM_STATES, WIRE_BM_ADDS = 8, 4_096, 3, 8, 32, 200
WIRE_SMALL = (4, 4_096, 512)
# Phase 15c, benchmarks/bench_bridge_contention.py's check: scalar round
# trips a second for CONTENTION_S on an idle server, then while 15a's grid
# applies run on another connection; the second rate must be at least
# CONTENTION_MIN of the first.
CONTENTION_S, CONTENTION_MIN = 2.0, 0.1
# Phase 16, the single-process mesh plane: a (dc, key) = (2, 4) MeshPlan
# over eight logical devices on the card, P = 8 partitions
# (tests/test_mesh.py's geometry). 16a: phase 4's engine and op stream,
# each replica row fed its own batches for MESH_ROUNDS rounds, so that
# the rows diverge, then the dc all-reduce. 16b: IdShardedTopkRmv over the
# same mesh at the main path's width (I / 4 ids a shard), phase 4's
# global-id batches for MESH_ID_ROUNDS rounds.
MESH_DC, MESH_KEY, MESH_PARTS, MESH_ROUNDS, MESH_ID_ROUNDS = 2, 4, 8, 3, 4
# 16c: tests/test_mesh.py's run_mesh_chaos at scripts/elastic_demo.py's
# shapes (R = D = 4, I = 64, B = 32, Br = 8, K = 8, M = 2, uniform ids; 4
# members on SimNet(seed, loss 3 %, duplication 3 %), a partition at step
# 3 healed at 6, m3 crashed at 7, 10 steps, a tail of at most 40 rounds),
# and tests/test_parallel.py's sharded leaderboard, topk and wordcount.
MESH_CHAOS_GEO, MESH_CHAOS_K, MESH_CHAOS_M, MESH_CHAOS_SEED = (4, 64, 32, 8), 8, 2, 7
# Phase 17, the multi-process plane. 17a: MULTIHOST_PROCS workers of
# antidote_ccrdt_tpu_torch/scripts/multihost_demo.py on the card (gloo),
# MULTIHOST_LOCAL logical devices each, so R = 32 replicas; one round of
# phase 4's stream, reconciled and saved with DCP. 17b: the JAX test's
# world (tests/test_multihost.py: 2 x 4 devices, 256 ids, 8 DCs, K = 8,
# M = 2, 64 adds a replica) on the CPU, on the card and as one process
# under nccl. 17c: two OrbaxGossip sites at the main path's width, their
# states on (dc, key) meshes of SITE_DCS[i] x 1 logical devices of the
# card. Every world is killed after MULTIHOST_TIMEOUT_S.
MULTIHOST_PROCS, MULTIHOST_LOCAL, MULTIHOST_TIMEOUT_S = 2, 16, 300.0
SITE_DCS = (4, 2)
# The environment of the spawned workers (None: this process's), and how
# long a fleet past its time limit has after SIGTERM before SIGKILL.
WORKER_ENV, TERM_GRACE_S = None, 30.0
# Phase 18, the elastic drill workers as real processes
# (antidote_ccrdt_tpu_torch/scripts/). 18a: ELASTIC_MEMBERS workers of
# elastic_demo.py at ELASTIC_SHAPE (the main path's width: R = D = 32,
# 100 000 ids, K = 100, M = 4, phase 12's op stream of 32 768 Zipf(1.2)
# adds and 2 048 removals a replica and step) over a shared-directory
# GossipStore with --delta, ELASTIC_STEPS steps, the victim w1 dying at
# ELASTIC_DIE_AT. Its failure detector is slowed from elastic_demo's 0.4 s
# timeout and 0.05 s heartbeat to ELASTIC_TIMEOUT and ELASTIC_HB, so that
# a 563 MB anchor publish is not taken for a death, and its final barrier
# waits ELASTIC_SETTLE_S for progress (10 s in elastic_demo). 18b:
# crash_recovery_demo.py's wal and adopt arms (group durability) at
# elastic_demo's width, on the card and on the CPU. 18c: net_gossip_demo.py's
# TCP crash drill (3 workers, w1 dying at step 4) at elastic_demo's width.
# Every fleet is killed after ELASTIC_FLEET_TIMEOUT_S.
ELASTIC_MEMBERS, ELASTIC_SHAPE, ELASTIC_STEPS, ELASTIC_DIE_AT = ("w0", "w1", "w2"), "main", 10, 4
ELASTIC_TIMEOUT, ELASTIC_HB, ELASTIC_SETTLE_S, ELASTIC_FLEET_TIMEOUT_S = 8.0, 0.25, 60.0, 420.0
ELASTIC_VICTIM = "w1"
# Phase 19, the operator's observability tools of
# antidote_ccrdt_tpu_torch/scripts/ (ccrdt_{trace,spans,rtrace,devprof,audit},
# obs_dashboard, spans_demo, overlap_demo), each run as `python -m`: 19a
# obs_dashboard --demo, 19b spans_demo and 19c overlap_demo (3 TCP workers of
# net_gossip_demo.py at elastic_demo's width each, the demos' own settings),
# 19d phase 18a's spill (its drill runs with the span plane and the device
# observatory on) read by ccrdt_spans, ccrdt_trace and ccrdt_devprof, 19e
# ccrdt_audit laws on the card and the CPU (every registered type, 512
# pairs) and its certify and verify over 19b's fleet. A demo is killed
# after OBS_TIMEOUT_S, a CLI after OBS_CLI_TIMEOUT_S.
OBS_TIMEOUT_S, OBS_CLI_TIMEOUT_S = 300.0, 120.0
TOOLS = "antidote_ccrdt_tpu_torch.scripts."
# A fleet line of obs.spans.format_report (the demos print one a fleet).
SPANS_FLEET_LINE = re.compile(r"rounds=(\d+) e2e p50 ([\d.]+)ms \| serial ([\d.]+)ms overlappable ([\d.]+)ms "
                              r"gap ([\d.]+)ms \(coverage ([\d.]+)%\)")
# Phase 20, the anti-entropy gates of antidote_ccrdt_tpu_torch/scripts/. 20a:
# partition_demo's drill in this process (3 TcpTransport members, AE_PARTS
# partitions, w2 out of the gossip for steps 4-8 while every op hits one
# partition) at AE_SHAPE: R = D = 32, 40 000 ids (the widest anchor under
# MAX_FRAME, as phase 12's TCP pair: 225 MB a member), K = 100, M = 4,
# 32 768 uniform adds and 2 048 removals a replica and step; the
# transports' send timeout AE_SEND_TIMEOUT (the demo's 2 s is for its
# 86 kB anchors). Then the drill at the demo's width on the CPU and on the
# card. 20b: topo_demo whole (two legs of six net_gossip_demo workers at
# elastic_demo's width, the za anchor killed in the first), its workers'
# failure detector at TOPO_TIMEOUT s (the demo's own). topo_demo is
# killed after AE_TIMEOUT_S.
AE_SHAPE, AE_PARTS, AE_SEND_TIMEOUT = "32,40000,32768,2048,4,100", 8, 120.0
# 20a's drill at AE_SHAPE runs AE_STEPS steps, cut from the demo's 12 for
# time (one step with every member gossiping after the outage, not three:
# each round publishes 225 MB anchors over TCP); the demo-width runs keep 12.
AE_STEPS = 10
TOPO_TIMEOUT, AE_TIMEOUT_S = 0.5, 600.0
# Phase 21, the certified-convergence gates of antidote_ccrdt_tpu_torch/scripts/.
# 21a: audit_demo's divergent arm at CERT_SHAPE (the main path's width,
# elastic_demo's stream) in this process, then at the demo's width on the
# CPU and the card; its healthy fleet (3 net_gossip_demo workers at
# elastic_demo's width, seeded tcp.send drops, 8 partitions), its
# durability leg (crash_recovery_demo's async wal drill at that width, and
# the fabricated pre-fsync loss) and the law checker (CERT_PAIRS pairs,
# JAX's). 21b: multichip_demo's phase A at MULTICHIP_SHAPE (R = D = 32,
# 100 000 ids, K = 100, M = 4, 32 768 uniform adds and 2 048 removals a
# replica and step, P = 8, a (2, 4) mesh of 8 logical devices, over
# FsTransport, which has no frame limit), then at the demo's width on the
# CPU and the card; its phase B (3 elastic_demo workers of 8 logical
# devices each at MULTICHIP_SHAPE, elastic_demo's Zipf stream as in 18a,
# with 18a's slowed failure detector, w1 SIGKILLed mid-load) beside
# phase A. Then the healthy and durability fleets at once. Each fleet is
# killed after CERT_TIMEOUT_S.
CERT_SHAPE, CERT_PAIRS, MULTICHIP_SHAPE, CERT_TIMEOUT_S = "main", 32, "main", 300.0
# Phase 22, the fleet write tier: write_tier_demo of antidote_ccrdt_tpu_torch/scripts/
# whole as a subprocess: 4 net_gossip_demo workers (the serve and ingest
# planes, a crash WAL each, the demo's seeded faults) at WRITE_SHAPE (R = D
# = 32, 10 000 ids, K = 100, M = 4, 18a's Zipf stream of 32 768 adds and
# 2 048 removals a replica and step, 56 MB a worker) with multichip_demo's
# WIDE_WORKER_ARGS, every worker's first K1c, K2 and K3 call held, 3 writer
# sessions through a WriteRouter, the hot key's owner SIGKILLed at step
# WRITE_KILL_AT of WRITE_STEPS, WRITE_STEP_SLEEP s between steps (the
# demo's 24 steps, its kill at 13 and its 1 s; 24 * 32 768 adds stay below
# the writers' 900 000 ts base). 10 000 ids, not
# the 40 000 of the widest anchor under MAX_FRAME: at 40 000 every worker's
# host stage (a 225 MB WAL checkpoint, record and publish each step) fell
# behind its steps and the durable acks missed the ingest plane's 8 s
# deadline, whether acked at the fsync or after the publish; at 20 000 the
# phase took 101-125 s against 74-89 s at 10 000 (PERF.md section 4). The
# demo is stopped after WRITE_TIMEOUT_S.
WRITE_SHAPE, WRITE_STEPS, WRITE_KILL_AT, WRITE_STEP_SLEEP, WRITE_TIMEOUT_S = "32,10000,32768,2048,4,100", 24, 13, 1.0, 480.0
# Phase 23, the fleet read tier: read_tier_demo of antidote_ccrdt_tpu_torch/scripts/
# whole as a subprocess: 4 net_gossip_demo workers (the serve plane, the
# demo's seeded tcp.send drops and serve.query delays) at READ_SHAPE (phase
# 22's width and stream) with multichip_demo's WIDE_WORKER_ARGS, every
# worker's first K1c, K2 and K3 call held, 3 clients through two
# FleetRouters (router.route drops, one hedging, ClientSession tokens), the
# rendezvous head of "k0" SIGKILLed at step READ_KILL_AT of the workers' 10,
# READ_STEP_SLEEP s between steps (the demo's own depth, kill and pacing),
# and READ_BOUNDS, the demo's bounds: reads/s at least, read p99 and
# failover blip at most (ms). Phase 22's width. At 40 000 ids
# survivors_converged failed in 3 of 4 runs on slower machines: relayed
# liveness kept the victim alive, so the survivors adopted its replicas
# only 53-55 s after the kill and left their final barrier on its 60 s
# settle window without confirming it dead, the adoption racing that
# window. The transport now ages relayed liveness (net/tcp.py), and 40 000
# has held every check in 2 of 2 runs since, fewer than the three a
# committed width needs (PERF.md section 6). The demo is stopped after
# READ_TIMEOUT_S.
READ_SHAPE, READ_KILL_AT, READ_STEP_SLEEP, READ_TIMEOUT_S = "32,10000,32768,2048,4,100", 5, 1.0, 420.0
READ_BOUNDS = (300.0, 1500.0, 5000.0)
# Phase 24, the request-tracing gate: rtrace_demo of antidote_ccrdt_tpu_torch/scripts/
# whole as a subprocess: 4 net_gossip_demo workers (the serve plane, the
# rtrace plane armed through CCRDT_RTRACE=1, the demo's seeded tcp.send
# drops and serve.query stalls, a 60 s serve linger after the final) at
# RTRACE_SHAPE (phase 23's width and stream) with multichip_demo's
# WIDE_WORKER_ARGS, every worker's first K1c, K2 and K3 call held, 3 traced
# clients through two FleetRouters (sample 1.0, router.route drops, one
# hedging), the rendezvous head of "k0" SIGKILLed with a probe held in
# flight at it, then the overhead window against the quiesced survivors.
# The demo's own depth, pacing and windows: RTRACE_STEPS worker steps,
# RTRACE_STEP_SLEEP s apart, RTRACE_WINDOWS (s: the storm before the kill,
# after it, the overhead window), and RTRACE_BOUNDS, its bounds: overhead
# % at most, attribution coverage at p50 and p99 and the share of complete
# waterfalls at least, failover blip ms at most. The demo is stopped after
# RTRACE_TIMEOUT_S.
RTRACE_SHAPE, RTRACE_STEPS, RTRACE_STEP_SLEEP, RTRACE_TIMEOUT_S = READ_SHAPE, 14, 1.4, 420.0
RTRACE_WINDOWS = (2.0, 4.0, 6.0)
RTRACE_BOUNDS = (5.0, 0.9, 0.99, 5000.0)
# 20a's TCP probe: a delta of each size (MB) sent between two TcpTransports
# on 127.0.0.1 (1 MB opens the link; 130 MB is the drill's last
# pre-outage delta, 225 MB its anchor).
AE_PROBE_MB = (1, 130, 225)


def tcp_landing_s(tcp) -> dict:
    """{MB: seconds from `publish_delta` to the blob in the peer's cache}
    for each size of AE_PROBE_MB, through a `net.tcp` module (this
    package's, or another checkout's); each blob is checked byte for
    byte."""
    a = tcp.TcpTransport("a", send_timeout=AE_SEND_TIMEOUT)
    b = tcp.TcpTransport("b", send_timeout=AE_SEND_TIMEOUT)
    try:
        a.add_peer("b", b.address)
        b.add_peer("a", a.address)
        out = {}
        for seq, mb in enumerate(AE_PROBE_MB):
            blob = os.urandom(mb * 1_000_000)
            t0 = time.perf_counter()
            a.publish_delta(seq, blob, keep=2)
            while seq not in b.delta_seqs("a"):
                if time.perf_counter() - t0 > AE_SEND_TIMEOUT:
                    raise AssertionError(f"the probe's {mb} MB delta did not land in {AE_SEND_TIMEOUT} s")
                time.sleep(0.0005)
            out[mb] = time.perf_counter() - t0
            if b.fetch_delta("a", seq) != blob:
                raise AssertionError(f"the probe's {mb} MB delta landed changed")
        return out
    finally:
        a.close()
        b.close()


@contextlib.contextmanager
def delta_landings_and_sweeps():
    """Watches partition_demo's drill, changing nothing it does: yields
    {"landed": {(member, origin, seq): t}, "sweeps": {member: [t, ...]}},
    when each delta reached each member's cache and when each of a
    member's sweeps began (perf_counter)."""
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport
    from antidote_ccrdt_tpu_torch.parallel import elastic

    seen = {"landed": {}, "sweeps": {}}
    store0, sweep0 = TcpTransport._store_delta, elastic.sweep_deltas

    def store(self, m, seq, keep, blob):
        ok = store0(self, m, seq, keep, blob)
        seen["landed"].setdefault((self.member, m, int(seq)), time.perf_counter())
        return ok

    def sweep(store_, *args, **kw):
        seen["sweeps"].setdefault(store_.member, []).append(time.perf_counter())
        return sweep0(store_, *args, **kw)

    TcpTransport._store_delta, elastic.sweep_deltas = store, sweep
    try:
        yield seen
    finally:
        TcpTransport._store_delta, elastic.sweep_deltas = store0, sweep0


def pre_outage_margin_s(seen: dict, lo: int) -> dict:
    """{peer: seconds from its step lo-1 delta landing at w2 to w2's last
    sweep before the outage} (negative: the sweep came first; None: it
    never landed). A member publishes once a step, so that delta's seq is
    lo - 1."""
    t_sweep = seen["sweeps"]["w2"][lo - 1]
    out = {}
    for peer in ("w0", "w1"):
        t = seen["landed"].get(("w2", peer, lo - 1))
        out[peer] = None if t is None else t_sweep - t
    return out


# Phase 4's merge rates, read again beside phase 15's wire rates.
MAIN_PATH_RATES: dict = {}


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, sort_keys=False), flush=True)


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    tb, to = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rmv_sector_bytes(torch, sides, rmv_vc) -> int:
    """Bytes of the distinct 32-byte `rmv_vc` sectors that K3 must read:
    those of the candidates with ts > 0 and a dc in [0, D) (any other
    candidate dies, or survives, without its tombstone)."""
    D = rmv_vc.shape[-1]
    lead = rmv_vc.shape[:-1]
    row = torch.arange(rmv_vc.numel() // D, device=rmv_vc.device).view(lead + (1,))
    per = SECTOR_BYTES // rmv_vc.element_size()
    addr = [((row * D + d.long()) // per)[(t > 0) & (d >= 0) & (d < D)] for _, d, t in sides]
    return int(torch.unique(torch.cat(addr)).numel()) * SECTOR_BYTES


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


@contextlib.contextmanager
def held_against_plain(torch, checks: dict, thread=None):
    """While open, every call the topk_rmv engine makes to K1c, K2 or K3
    also runs the kernel's plain version on the call's own arguments, and
    the two must be equal (``torch.equal``). `checks` gets one entry per
    wrapper and input shape: calls and max_abs_err. The wrappers count
    their launches as always; the plain calls count nothing. With
    `thread` (a ``threading.get_ident()``), only that thread's calls are
    held; other threads' go straight to the kernels."""
    from antidote_ccrdt_tpu_torch.models import topk_rmv_dense as trd
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place_plain

    def held(name, wrapper, plain, shape):
        def call(*args, **kw):
            if thread is not None and threading.get_ident() != thread:
                return wrapper(*args, **kw)
            got = wrapper(*args, **kw)
            want = plain(*args, **kw)
            got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(torch.equal(x, y) for x, y in zip(got_t, want_t)):
                raise AssertionError(f"{name} at {shape(*args, **kw)} disagrees with its plain version")
            entry = checks.setdefault(f"{name} {shape(*args, **kw)}", dict(calls=0, max_abs_err=0))
            entry["calls"] += 1
            entry["max_abs_err"] = max(entry["max_abs_err"], max_abs_err(got_t, want_t))
            return got
        return call

    def k3_shape(sides, m_keep, rmv_vc=None):
        return (f"W={sum(s[0].shape[-1] for s in sides)} rows={sides[0][0][..., 0].numel()} "
                f"fused={rmv_vc is not None}")

    # The engine's names are patched, not the wrappers' own: a wrapper
    # counts its launches on its module-level name.
    patches = [
        (trd, "scatter_max_rows", held(  # dense_table.scatter_max_rows: one K1c launch
            "K1c", trd.scatter_max_rows, kernels.scatter_max_rows_copy_plain,
            lambda table, rows, upd: f"table={list(table.shape)} rows={list(rows.shape)}")),
        (trd, "delta_place", held(
            "K2", trd.delta_place, delta_place_plain, lambda *a: f"stream={list(a[3].shape)} T={a[6]} M={a[7]}")),
        (trd, "sort_slots", held("K3", trd.sort_slots, kernels.sort_slots_plain, k3_shape)),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        yield checks
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def require_launches(got: dict, names, what: str) -> None:
    """Fail unless every wrapper in `names` launched in `got`'s run."""
    missing = [n for n in names if got.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"{what} did not launch {missing}: {got}")


def device_ms(torch, fn, kernel: str, reps: int = 20) -> float:
    """Mean device time per call of `fn` of the CUDA kernels matching
    `kernel`, every kernel of the call summed (``utils/time_k3.py``)."""
    from antidote_ccrdt_tpu_torch.utils import time_k3

    return time_k3.device_ms(torch, fn, reps, kernel)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return smi


def phase_build():
    from antidote_ccrdt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    regs = {}
    for name in _build.SOURCES:
        # One entry per kernel: its registers and its spills.
        regs[name] = {
            re.search(r"'(\w+)'", part).group(1): " ".join(
                re.findall(r"Used \d+ registers|\d+ bytes spill \w+", part))
            for part in _build.BUILD_LOG.get(name, "").split("Compiling entry function")[1:]
        }
    log("build", seconds=round(secs, 2), ptxas=regs)


def phase_kernels(torch):
    """K1, K1c, K2 and K3 against their plain versions at the main path's
    shapes."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place, delta_place_plain
    from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms
    from antidote_ccrdt_tpu_torch.utils.time_k3 import canonical_sides

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    D = R
    rows_out = {}
    device_jobs = []  # (label, call, kernel name), profiled after phase 5

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    # K1: tombstone scatter-max into [32, 100k, 32], Br=2048 per replica,
    # with duplicate and out-of-range rows.
    table = ri(0, 1 << 20, (R, I, D))
    rows = ri(0, I, (R, BR))
    rows[:, ::8] = rows[:, :1]
    rows[:, 1::97] = -1
    rows[:, 2::97] = I
    upd = ri(0, 1 << 20, (R, BR, D))
    got = kernels.scatter_max_rows_(table.clone(), rows, upd)
    want = kernels.scatter_max_rows_plain_(table.clone(), rows, upd)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1 scatter_max_rows disagrees with its plain version")
    valid = (rows >= 0) & (rows < I)
    flat = (torch.arange(R, device=dev)[:, None] * I + rows.long())[valid]
    n_rows = int(torch.unique(flat).numel())
    idx2 = flat[:, None].expand(-1, D).contiguous()
    src2 = upd[valid].contiguous()
    buf = table.clone()
    b, by = bound_ms(2 * n_rows * D * 4 + R * BR * 4 + R * BR * D * 4)
    rows_out["scatter_max_rows"] = dict(
        max_abs_err=max_abs_err([got], [want]),
        ms=cuda_time_ms(lambda: kernels.scatter_max_rows_(buf, rows, upd)),
        plain_ms=cuda_time_ms(lambda: kernels.scatter_max_rows_plain_(buf, rows, upd)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_time_ms(lambda: buf.view(R * I, D).scatter_reduce_(0, idx2, src2, "amax")),
    )
    log("kernel K1", touched_rows=n_rows, copy_ms=cuda_time_ms(lambda: table.clone()),
        copy_bound_ms=bound_ms(2 * R * I * D * 4)[0], **rows_out["scatter_max_rows"])
    device_jobs.append(("K1", lambda: kernels.scatter_max_rows_(table, rows, upd), "scatter_max_rows_kernel"))
    device_jobs.append(("K1 library", lambda b=buf, i=idx2, u=src2: b.view(R * I, D).scatter_reduce_(0, i, u, "amax"),
                        "_scatter_gather_elementwise_kernel"))
    del got, want

    # K1c: the same scatter-max out of place, on a contiguous table and on
    # DenseReplay's broadcast view after a sync (one row, replica stride 0).
    small = R * BR * 4 + R * BR * D * 4
    for form, tab in (("contiguous", table), ("view", table[:1].expand(R, I, D))):
        before = tab.clone()
        got = kernels.scatter_max_rows_copy(tab, rows, upd)
        want = kernels.scatter_max_rows_copy_plain(tab, rows, upd)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1c scatter_max_rows_copy ({form}) disagrees with its plain version")
        if not torch.equal(tab, before):
            raise AssertionError(f"K1c scatter_max_rows_copy ({form}) wrote its input")
        read = (1 if form == "view" else R) * I * D * 4
        b, by = bound_ms(read + R * I * D * 4 + small)
        entry = dict(
            max_abs_err=max_abs_err([got], [want]),
            ms=cuda_time_ms(lambda: kernels.scatter_max_rows_copy(tab, rows, upd)),
            plain_ms=cuda_time_ms(lambda: kernels.scatter_max_rows_copy_plain(tab, rows, upd)),
            bound_ms=b, bound_by=by,
            # One out-of-place call (after a reshape, which copies a view).
            library_ms=cuda_time_ms(lambda: tab.reshape(R * I, D).scatter_reduce(0, idx2, src2, "amax")),
        )
        log(f"kernel K1c {form}", **entry)
        device_jobs.append((f"K1c {form}", lambda tab=tab: kernels.scatter_max_rows_copy(tab, rows, upd),
                            "scatter_max_rows_copy_kernel"))
        if form == "contiguous":
            rows_out["scatter_max_rows_copy"] = entry
        del got, want, before

    # K1c at the shapes of benchmarks/micro_tombstone.py's pallas_bf16
    # probe (the same function with bf16 planes): uniform rows.
    prows = ri(0, I, (R, PROBE_BR))
    pupd = ri(0, 100_000, (R, PROBE_BR, D))
    got = kernels.scatter_max_rows_copy(table, prows, pupd)
    want = kernels.scatter_max_rows_copy_plain(table, prows, pupd)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K1c scatter_max_rows_copy disagrees with its plain version at the probe's shapes")
    pidx = (torch.arange(R, device=dev)[:, None] * I + prows.long()).reshape(-1, 1).expand(-1, D).contiguous()
    psrc = pupd.reshape(-1, D)
    b, by = bound_ms(2 * R * I * D * 4 + R * PROBE_BR * 4 + R * PROBE_BR * D * 4)
    log("kernel K1c at pallas_bf16's shapes", rows=PROBE_BR, max_abs_err=max_abs_err([got], [want]),
        ms=cuda_time_ms(lambda: kernels.scatter_max_rows_copy(table, prows, pupd)),
        plain_ms=cuda_time_ms(lambda: kernels.scatter_max_rows_copy_plain(table, prows, pupd)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_time_ms(lambda: table.reshape(R * I, D).scatter_reduce(0, pidx, psrc, "amax")))
    del got, want, pidx, psrc

    # K2: a real sorted add stream of the main path's first batch.
    eng = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7))
    st = eng.add_stream(gen.next_batch(B, BR), 1)
    args = (st.score, st.ts, st.dc, st.kid, st.rank, st.keep)  # the sorted kid, as the engine passes it
    got = delta_place(*args, I, M)
    want = delta_place_plain(*args, I, M)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("K2 delta_place disagrees with its plain version")
    addr = ((torch.arange(R, device=dev)[:, None] * I + st.kid.long()) * M + st.rank.long())[st.keep]
    vals = [st.score[st.keep], st.dc[st.keep], st.ts[st.keep]]

    def library_k2():
        for v, fill in zip(vals, (NEG_INF, 0, 0)):
            torch.full((R * I * M,), fill, dtype=torch.int32, device=dev).index_put_((addr,), v)

    b, by = bound_ms(3 * R * I * M * 4 + R * B * (5 * 4 + 1))
    rows_out["delta_place"] = dict(
        max_abs_err=max_abs_err(got, want),
        ms=cuda_time_ms(lambda: delta_place(*args, I, M)),
        plain_ms=cuda_time_ms(lambda: delta_place_plain(*args, I, M)),
        bound_ms=b, bound_by=by, library_ms=cuda_time_ms(library_k2),
    )
    tables = [torch.empty((R, I, M), dtype=torch.int32, device=dev) for _ in range(3)]
    device_jobs.append(("K2", lambda: delta_place(*args, I, M), "delta_place_kernel"))
    log("kernel K2", kept=int(st.keep.sum()),
        # The writes alone: three torch fills of the same tables.
        fill_ms=cuda_time_ms(lambda: [x.fill_(0) for x in tables]),
        **rows_out["delta_place"])
    del tables
    del got, want

    # K3: [32, 1, 100k] rows of 2 x 4 candidates against rmv_vc
    # [32, 1, 100k, 32], fused and unfused. Each side is a canonical slot
    # list (sorted, dup-free), as the state and the delta table are.
    sides, rmv_vc = canonical_sides(torch, kernels, g, (R, 1, I), M, D)
    n = R * I
    packed = torch.cat([s[0].long() * 2**32 + s[2].long() for s in sides], dim=-1)
    for fused in (True, False):
        vc = rmv_vc if fused else None
        got = kernels.sort_slots(sides, M, rmv_vc=vc)
        want = kernels.sort_slots_plain(sides, M, vc)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K3 sort_slots (fused={fused}) disagrees with its plain version")
        n_bytes = 6 * n * M * 4 + 3 * n * M * 4 + n * 4 + (n * D * 4 if fused else 0)
        b, by = bound_ms(n_bytes, n * (2 * 19 * 12 + 8 * 6))
        # The bound with only the tombstone sectors the live candidates need.
        data_bound = bound_ms(n_bytes - n * D * 4 + rmv_sector_bytes(torch, sides, rmv_vc), 0)[0] if fused else b
        entry = dict(
            max_abs_err=max_abs_err(got, want),
            ms=cuda_time_ms(lambda: kernels.sort_slots(sides, M, rmv_vc=vc)),
            plain_ms=cuda_time_ms(lambda: kernels.sort_slots_plain(sides, M, vc), reps=3, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=cuda_time_ms(lambda: torch.sort(packed, dim=-1, descending=True)),
        )
        log(f"kernel K3 fused={fused}", live=int((got[2] > 0).sum()), data_bound_ms=data_bound, **entry)
        device_jobs.append((f"K3 fused={fused}", lambda vc=vc: kernels.sort_slots(sides, M, rmv_vc=vc),
                            "sort_slots_kernel"))
        if fused:
            rows_out["sort_slots"] = entry
    return rows_out, device_jobs


def phase_main_path(torch, card: str):
    """The port's main path at full width, through the user's entry points."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=R, size=K, slots_per_id=M)
    rp = DenseReplay(dense, R)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7))
    batches = [gen.next_batch(B, BR) for _ in range(ROUNDS)]  # set-up, on the card
    wrappers = {
        "scatter_max_rows": kernels.scatter_max_rows_,
        "scatter_max_rows_copy": kernels.scatter_max_rows_copy,
        "delta_place": delta_place,
        "sort_slots": kernels.sort_slots,
    }
    main_path = ("scatter_max_rows_copy", "delta_place", "sort_slots")
    for w in wrappers.values():
        w.launches = 0
    # Earlier phases' garbage is collected here, not by a full collection
    # that the rounds' allocations would trigger inside the timed region.
    gc.collect()
    sync()
    # Phase 3's inputs stay allocated until their device times are taken
    # after phase 5: the main path's peak is counted above them.
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    apply_ms, sync_ms, per_round = [], [], []
    t_all = time.perf_counter()
    for rnd, ops in enumerate(batches):
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        rp.apply(ops)
        sync()
        apply_ms.append((time.perf_counter() - t0) * 1e3)
        per_round.append({n: w.launches - before[n] for n, w in wrappers.items()})
        if (rnd + 1) % SYNC_EVERY == 0:
            t0 = time.perf_counter()
            rp.sync()
            sync()
            sync_ms.append((time.perf_counter() - t0) * 1e3)
    obs = rp.observe()
    sync()
    total_s = time.perf_counter() - t_all
    launches = {n: w.launches for n, w in wrappers.items()}
    for rnd, got in enumerate(per_round):
        require_launches(got, main_path, f"apply round {rnd}")
    if tuple(obs.ids.shape) != (R, 1, K) or not bool(obs.valid.any()):
        raise AssertionError("empty or misshapen observable")
    if not rp.converged():
        raise AssertionError("replicas did not converge after the sync")
    if bool(rp.state.lossy.any()):
        print("[main] note: lossy capacity overflow flagged", flush=True)
    apply_sorted = sorted(apply_ms)
    merges = R * (B + BR) * ROUNDS
    MAIN_PATH_RATES.update(merges_per_s=merges / total_s, apply_merges_per_s=merges / (sum(apply_ms) / 1e3))
    log("main", card=card, rounds=ROUNDS, syncs=len(sync_ms), launches=launches,
        launches_per_apply=per_round[-1],
        apply_ms=apply_ms, sync_ms=sync_ms,
        p50_round_ms=apply_sorted[len(apply_sorted) // 2],
        merges_per_s=merges / total_s,
        apply_merges_per_s=merges / (sum(apply_ms) / 1e3),
        valid_observed=int(obs.valid.sum()),
        peak_mem_gb=(torch.cuda.max_memory_allocated() - mem_base) / 1e9)
    return launches, rp, gen


def phase_profile(torch, rp, ops):
    """One more apply round and a sync of the main path under
    torch.profiler: device time by kernel, and the device's idle share
    (profiler on, so the host side runs slower than in phase 4)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rp.apply(ops)
        rp.sync()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels, copies and memsets are the events on the device; the aten
    # ops that launched them carry the same time again, so they are left out.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    log("profile", wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top])


def phase_identity(torch):
    """A reduced seeded replay on the CPU and on the card: same bits."""
    from antidote_ccrdt_tpu_torch import convert, registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload

    r, i, b, br = 4, 4096, 2048, 128

    def run(device):
        dense = registry.make_dense("topk_rmv", n_ids=i, n_dcs=r, size=K, slots_per_id=M, device=device)
        rp = DenseReplay(dense, r)
        gen = TopkRmvEffectGen(Workload(r, i, zipf_a=1.2, score_max=1000, seed=11), device=device)
        for rnd in range(4):
            rp.apply(gen.next_batch(b, br))
            if rnd == 1:
                rp.sync([0, 0, 2])
        rp.sync()
        return convert.to_numpy(rp.state), convert.to_numpy(rp.observe())

    cpu, card = run("cpu"), run("cuda")
    import numpy as np

    for part_cpu, part_card in zip(cpu, card):
        for name in part_cpu:
            if not np.array_equal(part_cpu[name], part_card[name]):
                raise AssertionError(f"CPU and card disagree on {name}")
    log("identity", replicas=r, ids=i, adds=b, rmvs=br, rounds=4,
        fields=sorted(cpu[0]) + [f"observe.{k}" for k in cpu[1]], bit_identical=True)


def phase_batch_merge(torch, card: str, dev: str = "cuda"):
    """The north-star batch_merge through the entry point, its K3 joins at
    W = 2M on the wide path, and the other types on the card and the CPU."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import batch_merge, registry
    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms, sync

    # The one-pass construction against the scalar update, at a reduced size.
    small = ss.topk_rmv_effects(4, 3_000, 600, 40, seed=5)
    eng = registry.scalar("topk_rmv")
    if [ss.apply_effects("topk_rmv", eng.new(K), e) for e in small] != [ss.topk_rmv_direct(e, K) for e in small]:
        raise AssertionError("topk_rmv_direct disagrees with the scalar update")
    t0 = time.perf_counter()
    effects = ss.topk_rmv_effects(BM_N, BM_IDS, BM_ADDS, BM_RMVS, seed=13)
    states = [ss.topk_rmv_direct(e, K) for e in effects]
    build_s = time.perf_counter() - t0
    del effects

    wrappers = [kernels.scatter_max_rows_, kernels.scatter_max_rows_copy, delta_place, kernels.sort_slots]
    for w in wrappers:
        w.launches = 0
    kernels.sort_slots.wide_launches = 0
    kernels.sort_slots.global_launches = 0
    sync()
    t0 = time.perf_counter()
    merged = batch_merge("topk_rmv", states, device=dev)
    sync()
    call_s = time.perf_counter() - t0
    launches = {"sort_slots": kernels.sort_slots.launches, "sort_slots_wide": kernels.sort_slots.wide_launches,
                "sort_slots_global": kernels.sort_slots.global_launches,
                "scatter_max_rows": kernels.scatter_max_rows_.launches,
                "scatter_max_rows_copy": kernels.scatter_max_rows_copy.launches, "delta_place": delta_place.launches}
    if launches["sort_slots_wide"] < 1 or launches["sort_slots"] < 1:
        raise AssertionError(f"batch_merge did not launch both of K3's paths (W = M, W = 2M): {launches}")
    t0 = time.perf_counter()
    want = ss.topk_rmv_set_join(states)
    join_s = time.perf_counter() - t0
    if merged != want:
        raise AssertionError("batch_merge disagrees with the host set join")

    # The same call in its three stages, each timed. The converter's
    # canonicalising K3 call (W = M) and each fold level's K3 join (W = 2M)
    # are held against their plain versions on their full inputs, and timed
    # alone, by CUDA events and device-only.
    sync()
    t0 = time.perf_counter()
    dense, batch, ids, dcs = bm.topk_rmv_to_dense(states, dev)
    sync()
    convert_s = time.perf_counter() - t0
    batch_gb = bm.tree_nbytes(batch) / 1e9
    Mb, U, D = dense.M, len(ids), len(dcs)
    if not 8 < Mb <= 16:
        raise AssertionError(f"M = {Mb}: the converter's call would not take K3's half-warp path")
    raw = bm.topk_rmv_tables(states, dev)[0]
    side = [(raw.slot_score, raw.slot_dc, raw.slot_ts)]
    del raw
    got = kernels.sort_slots(side, Mb)
    ref = kernels.sort_slots_plain(side, Mb)
    sync()
    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError(f"K3 at W = M = {Mb} (the converter's call) disagrees with its plain version")
    if not all(torch.equal(x, y) for x, y in zip(got, (batch.slot_score, batch.slot_dc, batch.slot_ts))):
        raise AssertionError("the converter's canonical rows differ from K3's on the same tables")
    rows = BM_N * U
    b, by = bound_ms(rows * 4 * (3 * Mb + 3 * Mb + 1))
    canon = dict(W=Mb, rows=rows, max_abs_err=max_abs_err(got, ref),
                 # The rows K3 sorts; the others (absent ids) are the fill.
                 sorted_share=float((side[0][2] > 0).any(-1).float().mean()),
                 ms=cuda_time_ms(lambda: kernels.sort_slots(side, Mb)),
                 device_ms=device_ms(torch, lambda: kernels.sort_slots(side, Mb), "sort_slots_warp_kernel", reps=5),
                 earlier_ms=EARLIER_K3_MS["convert"],
                 plain_ms=cuda_time_ms(lambda: kernels.sort_slots_plain(side, Mb), reps=3, warmup=1),
                 bound_ms=b, bound_by=by)
    del got, ref, side
    levels, err = [], 0
    n = BM_N
    fold_ms = 0.0
    while n > 1:
        half = n // 2
        lhs = bm._tree_map(lambda x: x[:half], batch)
        rhs = bm._tree_map(lambda x: x[half:2 * half], batch)
        rmv = torch.maximum(lhs.rmv_vc, rhs.rmv_vc)
        sides = [(lhs.slot_score, lhs.slot_dc, lhs.slot_ts), (rhs.slot_score, rhs.slot_dc, rhs.slot_ts)]
        rows = half * U
        got = kernels.sort_slots(sides, Mb, rmv_vc=rmv)
        ref = kernels.sort_slots_plain(sides, Mb, rmv)
        sync()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"K3 wide disagrees with its plain version at fold level n={n}")
        err = max(err, max_abs_err(got, ref))
        del got, ref
        slot_bytes = rows * 4 * (2 * 3 * Mb + 3 * Mb + 1)
        b, by = bound_ms(slot_bytes + rows * D * 4)
        k = len(levels)
        lv = dict(n=n, rows=rows, W=2 * Mb,
                  # The rows K3 sorts: those with a candidate of ts > 0.
                  sorted_share=float(((lhs.slot_ts > 0).any(-1) | (rhs.slot_ts > 0).any(-1)).float().mean()),
                  ms=cuda_time_ms(lambda: kernels.sort_slots(sides, Mb, rmv_vc=rmv)),
                  device_ms=device_ms(torch, lambda: kernels.sort_slots(sides, Mb, rmv_vc=rmv),
                                      "sort_slots_warp_kernel", reps=5),
                  earlier_ms=EARLIER_K3_MS["levels"][k] if k < len(EARLIER_K3_MS["levels"]) else None,
                  bound_ms=b, bound_by=by,
                  data_bound_ms=bound_ms(slot_bytes + rmv_sector_bytes(torch, sides, rmv))[0])
        if n == BM_N:
            lv["plain_ms"] = cuda_time_ms(lambda: kernels.sort_slots_plain(sides, Mb, rmv), reps=3, warmup=1)
        sync()
        t0 = time.perf_counter()
        batch = dense.merge(lhs, rhs)
        sync()
        lv["merge_ms"] = (time.perf_counter() - t0) * 1e3
        fold_ms += lv["merge_ms"]
        levels.append(lv)
        n = half
    t0 = time.perf_counter()
    again = bm.topk_rmv_from_dense(batch, ids, dcs, K)
    extract_s = time.perf_counter() - t0
    if again != merged:
        raise AssertionError("the staged batch_merge disagrees with the entry point")
    live = sum(map(len, merged.masked.values()))
    log("batch_merge topk_rmv", card=card, states=BM_N, ids=U, dcs=D, M=Mb, K=K, build_s=build_s,
        call_s=call_s, merges_per_s=BM_N * U / call_s, convert_s=convert_s, fold_ms=fold_ms,
        extract_s=extract_s, set_join_s=join_s, batch_gb=batch_gb,
        live_adds=live, removals=len(merged.removals), observed=len(merged.observed), launches=launches,
        canonicalise=canon, levels=levels)

    # The other types, reduced, at their BASELINE.json replica counts.
    others = {}
    for name, n_rep in BM_OTHERS.items():
        kw = {"topk": dict(n_ops=4000, n_ids=10_000), "leaderboard": dict(n_ops=600, n_ids=100_000)}.get(name, {})
        sts = ss.seeded_states(name, n_rep, seed=21, size=K, **kw)
        t0 = time.perf_counter()
        on_card = batch_merge(name, sts, device=dev)
        sync()
        card_s = time.perf_counter() - t0
        if on_card != batch_merge(name, sts, device="cpu"):
            raise AssertionError(f"batch_merge({name!r}) differs between the card and the CPU")
        others[name] = dict(replicas=n_rep, s=card_s)
    log("batch_merge others", **others)
    first = levels[0]
    wide = dict(max_abs_err=err, ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None)
    narrow = {k: canon[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    return launches, wide, dict(narrow, library_ms=None)


def two_run_rows(torch, sides, rmv_vc):
    """Per row: whether every side's survivors (fused, the candidates that
    pass the add-wins filter; unfused, all) are already in K3's order, so
    that the row is two sorted runs to merge, not a row to sort."""
    from antidote_ccrdt_tpu_torch.ops.kernels import dom_lookup

    ok = None
    for s, d, t in sides:
        alive = t > dom_lookup(d, rmv_vc) if rmv_vc is not None else torch.ones_like(t, dtype=torch.bool)
        perm = torch.sort((~alive).to(torch.int8), dim=-1, stable=True).indices  # survivors first, in order
        s, d, t, alive = (torch.gather(x, -1, perm) for x in (s, d, t, alive))
        better = (s[..., 1:] > s[..., :-1]) | ((s[..., 1:] == s[..., :-1]) & (
            (t[..., 1:] > t[..., :-1]) | ((t[..., 1:] == t[..., :-1]) & (d[..., 1:] < d[..., :-1]))))
        side_ok = ~(better & alive[..., 1:]).any(-1)
        ok = side_ok if ok is None else ok & side_ok
    return ok


def k3_bound(torch, sides, rmv_vc, m_keep: int):
    """K3's bound on a call, as its inputs need it: each input byte read
    once (the slots, and fused the tombstone rows), each output byte
    written once; W comparisons (of three int32 keys each) a row of two
    sorted runs and W ceil(log2 W) a row to sort. Also the earlier
    yardstick, the bitonic network over the row padded to a power of two,
    for the record."""
    W = sum(side[0].shape[-1] for side in sides)
    rows = sides[0][0][..., 0].numel()
    n_bytes = rows * 4 * (3 * W + (rmv_vc.shape[-1] if rmv_vc is not None else 0) + 3 * m_keep + 1)
    merged = int(two_run_rows(torch, sides, rmv_vc).sum())
    lg = (W - 1).bit_length()
    b, by = bound_ms(n_bytes, 3 * (merged * W + (rows - merged) * W * lg))
    bitonic = bound_ms(n_bytes, rows * (1 << (lg - 1)) * lg * (lg + 1) // 2 * 12)[0]
    return b, by, dict(two_run_rows=merged, bitonic_bound_ms=bitonic)


ROW_KERNELS = r"sort_slots_row_\w+"  # the row paths' chain, every kernel of a call


def phase_wide_rows(torch, card: str, m: int, counter: str, dev: str = "cuda"):
    """batch_merge at capacity M = `m` (the converter's K3 call at W = m,
    the fold's at W = 2m), and the K3 path those calls take (its launches
    in `counter`) against its plain version on the converter's and the
    first fold level's full inputs, timed beside its bound."""
    from antidote_ccrdt_tpu_torch import batch_merge
    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    states = ss.topk_rmv_capacity_states(m)
    counters = ("launches", "wide_launches", "block_launches", "global_launches")
    for c in counters:
        setattr(kernels.sort_slots, c, 0)
    sync()
    t0 = time.perf_counter()
    merged = batch_merge("topk_rmv", states, device=dev)
    sync()
    call_s = time.perf_counter() - t0
    launches = {c: getattr(kernels.sort_slots, c) for c in counters}
    if launches[counter] < 2:
        raise AssertionError(f"batch_merge at M = {m} did not launch K3's {counter} path twice: {launches}")
    if merged != ss.topk_rmv_set_join(states):
        raise AssertionError(f"batch_merge at M = {m} disagrees with the host set join")

    raw = bm.topk_rmv_tables(states, dev)[0]
    Mb = raw.slot_ts.shape[-1]
    dense, batch, ids, _ = bm.topk_rmv_to_dense(states, dev)
    half = batch.slot_ts.shape[0] // 2
    lhs = bm._tree_map(lambda x: x[:half], batch)
    rhs = bm._tree_map(lambda x: x[half:2 * half], batch)
    rmv = torch.maximum(lhs.rmv_vc, rhs.rmv_vc)
    calls = {
        "convert": ([(raw.slot_score, raw.slot_dc, raw.slot_ts)], None),
        "fold": ([(lhs.slot_score, lhs.slot_dc, lhs.slot_ts), (rhs.slot_score, rhs.slot_dc, rhs.slot_ts)], rmv),
    }
    out = {label: k3_row_call(torch, kernels, sides, Mb, vc, f"{counter} path ({label})")
           for label, (sides, vc) in calls.items()}
    log("wide rows", card=card, M=Mb, path=counter, states=len(states), ids=len(ids), call_s=call_s,
        launches=launches, **out)
    fold = out["fold"]
    row = dict(max_abs_err=max(o["max_abs_err"] for o in out.values()), ms=fold["ms"], plain_ms=fold["plain_ms"],
               bound_ms=fold["bound_ms"], bound_by=fold["bound_by"], library_ms=None)
    return launches[counter], row


def k3_row_call(torch, kernels, sides, m_keep, vc, what: str) -> dict:
    """One K3 call on the row paths: held against the plain K3 on its full
    inputs (``torch.equal``), then timed by CUDA events (mean of 5) and
    on the device (every kernel of the chain, per call) beside the plain
    version and its bound."""
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms, sync

    got = kernels.sort_slots(sides, m_keep, rmv_vc=vc)
    ref = kernels.sort_slots_plain(sides, m_keep, vc)
    sync()
    W = sum(side[0].shape[-1] for side in sides)
    if not all(torch.equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError(f"K3's {what} at W = {W} disagrees with its plain version")
    b, by, extra = k3_bound(torch, sides, vc, m_keep)
    rows = sides[0][0][..., 0].numel()
    call = lambda: kernels.sort_slots(sides, m_keep, rmv_vc=vc)  # noqa: E731
    return dict(W=W, rows=rows, tile=kernels.row_tile(W), max_abs_err=max_abs_err(got, ref),
                ms=cuda_time_ms(call, reps=5, warmup=1),
                device_ms=device_ms(torch, call, ROW_KERNELS, reps=5),
                plain_ms=cuda_time_ms(lambda: kernels.sort_slots_plain(sides, m_keep, vc), reps=3, warmup=1),
                bound_ms=b, bound_by=by, **extra)


def phase_many_rows(torch, card: str):
    """K3's block path where many rows fill the card: 65 536 rows of two
    canonical 256-slot sides (W = 512) against D = 32 tombstones, fused (a
    fold of two states of 65 536 ids at M = 256), held against the plain
    K3 and timed."""
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.utils.time_k3 import MANY_D, MANY_M, MANY_ROWS, canonical_sides

    g = torch.Generator(device="cuda").manual_seed(2)
    sides, rmv = canonical_sides(torch, kernels, g, (MANY_ROWS,), MANY_M, MANY_D)
    before = kernels.sort_slots.block_launches
    out = k3_row_call(torch, kernels, sides, MANY_M, rmv, "block path (many rows)")
    if kernels.sort_slots.block_launches <= before:
        raise AssertionError("the many-row call did not take K3's block path")
    log("many rows", card=card, **out)


def phase_coalesced(torch, card: str, dev: str = "cuda"):
    """The coalesced replay at the main path's shapes: COALESCE_K batches
    fused by whole-log compaction and applied as one round."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert, registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms, sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=R, size=K, slots_per_id=M, device=dev)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    batches = [gen.next_batch(B, BR) for _ in range(COALESCE_K)]  # set-up, on the card

    # The same batches one round each, for comparison.
    gc.collect()
    seq = DenseReplay(dense, R)
    seq_ms = []
    for ops in batches:
        sync()
        t0 = time.perf_counter()
        seq.apply(ops)
        sync()
        seq_ms.append((time.perf_counter() - t0) * 1e3)

    wrappers = {"scatter_max_rows_copy": kernels.scatter_max_rows_copy, "delta_place": delta_place,
                "sort_slots": kernels.sort_slots}
    rp = DenseReplay(dense, R)
    prev = rp.state
    for w in wrappers.values():
        w.launches = 0
    sync()
    t0 = time.perf_counter()
    rp.apply_coalesced(batches)
    sync()
    round_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: w.launches for n, w in wrappers.items()}
    if min(launches.values()) < 1:
        raise AssertionError(f"the coalesced apply did not launch K1c, K2 and K3: {launches}")
    ops_in, ops_out = rp.metrics.counters["coalesce_ops_in"], rp.metrics.counters["coalesce_ops_out"]

    # The coalesce alone: its peak memory above what it was given, and its
    # time; then the apply of its output alone.
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    fused, n_add, n_rmv = dense.coalesce_ops(batches)
    sync()
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9
    coalesce_ms = cuda_time_ms(lambda: dense.coalesce_ops(batches), reps=3, warmup=1)
    start = dense.init(R)
    apply_ms = cuda_time_ms(lambda: dense.apply_ops(start, fused, collect_dominated="table"), reps=3, warmup=1)
    one_apply_ms = cuda_time_ms(lambda: dense.apply_ops(start, batches[0], collect_dominated="table"),
                                reps=3, warmup=1)
    # Where the coalesce's device time goes: one call under torch.profiler.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dense.coalesce_ops(batches)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    log("coalesce profile", wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
        idle_share=1 - busy_ms / prof_wall_ms if prof_wall_ms else None,
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top])
    # Every kernel call of the coalesced apply held against its plain
    # version on that call's own inputs: the coalesced batch, applied
    # again to the state the timed round started from, must end in the
    # timed round's state.
    held = {}
    with held_against_plain(torch, held):
        again, _ = dense.apply_ops(prev, fused, **getattr(dense, "replication_extras_kwargs", {}))
    sync()
    if not all(torch.equal(x, y) for x, y in zip(leaves(again), leaves(rp.state))):
        raise AssertionError("the coalesced batch applied again ends in another state than the coalesced round")
    if {k.split()[0] for k in held} != {"K1c", "K2", "K3"}:
        raise AssertionError(f"the coalesced apply did not call K1c, K2 and K3 under the check: {sorted(held)}")
    del again
    lossy_seq, lossy_c = int(seq.state.lossy.sum()), int(rp.state.lossy.sum())
    equal = dense.equal(seq.state, rp.state)
    log("coalesced", card=card, batches=COALESCE_K, log_rows=int(fused.add_key.shape[1] + fused.rmv_key.shape[1]),
        launches=launches, held_against_plain=held, round_ms=round_ms, coalesce_ms=coalesce_ms, apply_ms=apply_ms,
        one_batch_apply_ms=one_apply_ms, sequential_round_ms=seq_ms,
        ops_in=ops_in, ops_out=ops_out, out_over_in=ops_out / ops_in,
        live_adds=int(n_add.sum()), live_rmvs=int(n_rmv.sum()), coalesce_peak_gb=peak_gb,
        equal_to_sequential=equal, lossy_replicas_sequential=lossy_seq, lossy_replicas_coalesced=lossy_c)
    del seq, fused, start

    # Bit identity, CPU against card, at the reduced identity shapes.
    r, i, b, br = 4, 4096, 2048, 128

    def run(device):
        d = registry.make_dense("topk_rmv", n_ids=i, n_dcs=r, size=K, slots_per_id=M, device=device)
        g = TopkRmvEffectGen(Workload(r, i, zipf_a=1.2, score_max=1000, seed=11), device=device)
        bs = [g.next_batch(b, br) for _ in range(COALESCE_K)]
        ops, na, nr = d.coalesce_ops(bs)
        st, _ = d.apply_ops(d.init(r), ops, collect_dominated="table")
        return convert.to_numpy(ops), na, nr, convert.to_numpy(st)

    cpu, dev_out = run("cpu"), run(dev)
    for part_cpu, part_card in zip(cpu, dev_out):
        parts = part_cpu.items() if isinstance(part_cpu, dict) else [("counts", part_cpu)]
        for name, value in parts:
            other = part_card[name] if isinstance(part_card, dict) else part_card
            if not np.array_equal(value, other):
                raise AssertionError(f"coalesced round: CPU and card disagree on {name}")
    log("coalesced identity", replicas=r, ids=i, adds=b, rmvs=br, batches=COALESCE_K, bit_identical=True)
    return (dense, prev, rp.state), launches


def phase_monoid(torch, card: str, topk_rmv, dev: str = "cuda"):
    """The MONOID engines' replays on the card against the CPU, deltas and
    their coalescing, and the merge laws on the card."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert, registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
    from antidote_ccrdt_tpu_torch.models import average as av
    from antidote_ccrdt_tpu_torch.models import wordcount as wc
    from antidote_ccrdt_tpu_torch.ops import kernels, laws
    from antidote_ccrdt_tpu_torch.ops.compaction import coalesce_deltas
    from antidote_ccrdt_tpu_torch.parallel import delta
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    def t(a, device):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # benchmarks/bench_all.py's shapes: average (R, NK, B) = (2, 1000, 2^20),
    # wordcount (64, V = 2^16, 2^16 Zipf(1.1) tokens), worddocumentcount
    # (64, V = 2^16, 512 documents x 64 words of a 50 000-word vocabulary).
    words = [f"w{k}" for k in range(50_000)]
    table = wc.fnv1a_buckets(words, 1 << 16)

    def average_round(rng, device):
        R_, NK_, B_ = 2, 1000, 1 << 20
        return av.AverageOps(key=t(rng.integers(0, NK_, (R_, B_)).astype(np.int32), device),
                             value=t(rng.integers(-100, 100, (R_, B_)).astype(np.int32), device),
                             count=t(rng.integers(1, 3, (R_, B_)).astype(np.int32), device))

    def wordcount_round(rng, device):
        raw = rng.zipf(1.1, size=(64, 1 << 16))
        return wc.WordcountOps(key=t(np.zeros((64, 1 << 16), np.int32), device),
                               token=t(((raw - 1) % (1 << 16)).astype(np.int32), device))

    def worddoc_round(rng, device):
        uniq = ((rng.zipf(1.1, size=(64, 512 * 64)) - 1) % len(words)).astype(np.int32)
        return (t(uniq, device), t(np.full((64, 512), 64, np.int32), device),
                t(np.full(64, 512 * 64, np.int32), device))

    cases = {
        "average": (lambda dv: registry.make_dense("average", device=dv), 2, 1000, average_round, None),
        "wordcount": (lambda dv: registry.make_dense("wordcount", n_buckets=1 << 16, device=dv), 64, 1,
                      wordcount_round, None),
        "worddocumentcount": (lambda dv: registry.make_dense("worddocumentcount", n_buckets=1 << 16, device=dv),
                              64, 1, worddoc_round, "compact"),
    }
    results = {}
    gc.collect()
    for name, (make, n_rep, nk, draw, mode) in cases.items():
        runs = {}
        for device in ("cpu", dev):
            eng = make(device)
            rp = DenseReplay(eng, n_rep, n_keys=nk)
            rng = np.random.default_rng(31)
            tbl = t(table, device)
            round_ms, sync_ms = [], []
            for rnd in range(4):
                ops = draw(rng, device)
                if device != "cpu":
                    sync()
                t0 = time.perf_counter()
                if mode == "compact":
                    rp.state, _ = eng.apply_doc_ops_compact(rp.state, *ops, bucket_table=tbl)
                else:
                    rp.apply(ops)
                if device != "cpu":
                    sync()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                if rnd == 1:
                    t0 = time.perf_counter()
                    rp.sync([0] + list(range(n_rep)))  # replica 0 delivered twice
                    if device != "cpu":
                        sync()
                    sync_ms.append((time.perf_counter() - t0) * 1e3)
            parts = {f"rows.{f}": v for f, v in convert.to_numpy(rp.state).items()}
            parts.update({f"base.{f}": v for f, v in convert.to_numpy(rp.base).items()})
            rp.sync()
            parts.update({f"final base.{f}": v for f, v in convert.to_numpy(rp.base).items()})
            runs[device] = (parts, round_ms, sync_ms, rp.converged())
        for label, value in runs["cpu"][0].items():
            if not np.array_equal(value, runs[dev][0][label]):
                raise AssertionError(f"{name}: CPU and card disagree on {label}")
        if not runs[dev][3]:
            raise AssertionError(f"{name}: replicas did not converge after the last sync")
        results[name] = dict(replicas=n_rep, round_ms=runs[dev][1], sync_ms=runs[dev][2], bit_identical=True)
    log("monoid", card=card, **results)

    # A delta of phase 9's coalesced round gives its state back, bit for bit.
    dense, prev, cur = topk_rmv
    sync()
    t0 = time.perf_counter()
    d = delta.make_delta(dense, prev, cur)
    back = delta.apply_any_delta(dense, prev, d)
    sync()
    delta_s = time.perf_counter() - t0
    if not all(torch.equal(x, y) for x, y in zip(leaves(back), leaves(cur))):
        raise AssertionError("apply_any_delta(prev, make_delta(prev, cur)) differs from cur")
    full_bytes = sum(x.numel() * x.element_size() for x in leaves(cur))
    del back

    # Three chained wordcount deltas coalesce to the interval's delta.
    eng = registry.make_dense("wordcount", n_buckets=1 << 16, device=dev)
    rng = np.random.default_rng(41)
    chain = [eng.init(64, 1)]
    for _ in range(3):
        chain.append(eng.apply_ops(chain[-1], wordcount_round(rng, dev))[0])
    fused = coalesce_deltas(eng, [delta.make_delta(eng, a, b) for a, b in zip(chain, chain[1:])])
    whole = delta.make_delta(eng, chain[0], chain[-1])
    if not all(torch.equal(x, y) for x, y in zip(leaves(fused), leaves(whole))):
        raise AssertionError("coalesce_deltas of 3 wordcount deltas differs from the interval's delta")
    if not all(torch.equal(x, y) for x, y in zip(leaves(delta.apply_any_delta(eng, chain[0], fused)),
                                                  leaves(chain[-1]))):
        raise AssertionError("the coalesced wordcount delta does not give the last state back")

    # The merge laws on the card, and the broken merge caught. The
    # topk_rmv fixture's kernel calls are counted (counts reset just
    # before its check) and each is held against its plain version.
    reports, law_kernels = {}, {}
    for name, fx in sorted(registry.law_fixtures().items()):
        f = fx(3, 128, device=dev)
        if name == "topk_rmv":
            for c in ("launches", "wide_launches", "block_launches", "global_launches"):
                setattr(kernels.sort_slots, c, 0)
            with held_against_plain(torch, law_kernels):
                rep = laws.check_engine_laws(f["dense"], f["states"], f["chain"])
            law_launches = kernels.sort_slots.launches
            if law_launches < 1 or not any(k.startswith("K3") for k in law_kernels):
                raise AssertionError(f"the topk_rmv law check did not launch K3: {law_launches}, {law_kernels}")
        else:
            rep = laws.check_engine_laws(f["dense"], f["states"], f["chain"])
        if not rep["ok"]:
            raise AssertionError(f"law check failed for {name}: {rep}")
        reports[name] = sorted(rep["laws"])
    f = laws.broken_merge_fixture(3, 128, device=dev)
    broken = laws.check_engine_laws(f["dense"], f["states"], f["chain"])["laws"]
    if broken["commutativity"]["ok"] or broken["associativity"]["ok"] or not broken["idempotence"]["ok"]:
        raise AssertionError(f"the broken merge was not caught as expected: {broken}")
    if len(reports) != 6:
        raise AssertionError(f"expected six law fixtures, found {sorted(reports)}")
    log("deltas and laws", card=card, topk_rmv_delta_rows=int(d.rows.numel()),
        topk_rmv_delta_bytes=delta.delta_nbytes(d), topk_rmv_state_bytes=full_bytes, delta_round_trip_s=delta_s,
        wordcount_chain_coalesced_equal=True, wordcount_delta_cells=int(whole["idx"].numel()),
        laws_ok=reports, topk_rmv_law_k3_launches=law_launches, topk_rmv_law_kernels_held=law_kernels,
        broken_merge={k: v["ok"] for k, v in broken.items()})
    return {"sort_slots": law_launches}


def phase_durable_host(torch, card: str, dev: str = "cuda") -> dict:
    """The host path around the engine: native causal host, WAL,
    crash recovery, psnap repair, reconcile; then the native tokenizer.
    Every K1c, K2 and K3 call of the phase is held against its plain
    version on its own inputs. Returns the phase's K1c, K2 and K3
    launches."""
    import dataclasses
    import tempfile

    import numpy as np

    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.core import serial
    from antidote_ccrdt_tpu_torch.harness import native_host as nh
    from antidote_ccrdt_tpu_torch.harness import native_tokenizer as nt
    from antidote_ccrdt_tpu_torch.harness.wal import ElasticWal
    from antidote_ccrdt_tpu_torch.models import wordcount as wc
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.parallel.delta import like_delta_for
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    for lib in (nh, nt):
        if not lib.available():
            raise AssertionError(f"{lib.__name__} did not build: {lib.build_error()}")
    wrappers = {"scatter_max_rows_copy": kernels.scatter_max_rows_copy, "delta_place": delta_place,
                "sort_slots": kernels.sort_slots}

    def counts():
        return {n: w.launches for n, w in wrappers.items()}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    def row(state, x):
        return type(state)(**{f.name: getattr(state, f.name)[x:x + 1] for f in dataclasses.fields(state)})

    def ms_since(t0):
        return (time.perf_counter() - t0) * 1e3

    held = {}  # every call but the recovery's, held by running it again

    def held_again(what, fn, want):
        """`fn` run again with every kernel call held against its plain
        version; it must give `want`. Its launches do not count."""
        saved = counts()
        with held_against_plain(torch, held):
            got = fn()
        for n, w in wrappers.items():
            w.launches = saved[n]
        if not same(got, want):
            raise AssertionError(f"{what} run again under the plain check ends in another state")

    def held_calls(checks, kernel):
        return sum(v["calls"] for name, v in checks.items() if name.split()[0] == kernel)

    r, ids, k, m, rounds = R, I, K, M, DH_ROUNDS
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=k, slots_per_id=m, device=dev)
    state = dense.init(r, 1)
    # A replica drains every origin's ops, its own included: one round's
    # worth with slack, as the demo sizes it.
    cap_adds, cap_rmvs = 2 * r * DH_ADDS, 2 * r * DH_RMVS
    frontiers = np.zeros((r, r), np.int32)  # max ts each origin has seen per DC
    submitted = delivered = 0
    t = {"drain_ms": [], "apply_ms": [], "log_step_ms": [], "flush_ms": []}
    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    reset()
    with nh.NativeHost(r) as host, tempfile.TemporaryDirectory() as tmp:
        wal = ElasticWal(tmp, "w0", dense, "topk_rmv", partitions=DH_PARTS, durability="group")
        for step in range(rounds):
            for origin in range(r):
                na, nr = int(rng.integers(DH_ADDS // 2, DH_ADDS + 1)), int(rng.integers(0, DH_RMVS + 1))
                host.submit_batch(origin, np.full(na, nh.KIND_ADD, np.int32), np.zeros(na, np.int32),
                                  rng.integers(0, ids, na), rng.integers(1, 10_000, na))
                if nr:
                    host.submit_batch(origin, np.full(nr, nh.KIND_RMV, np.int32), np.zeros(nr, np.int32),
                                      rng.integers(0, ids, nr), vcs=np.repeat(frontiers[origin][None], nr, 0))
                submitted += na + nr
            t0 = time.perf_counter()
            drained = [host.drain_topk_rmv_ops(x, cap_adds, cap_rmvs, device=dev) for x in range(r)]
            ops = TopkRmvOps(*[torch.cat([getattr(d[0], f) for d in drained])
                               for f in TopkRmvOps.__dataclass_fields__])
            sync()
            t["drain_ms"].append(ms_since(t0))
            delivered += sum(na + nr for _, na, nr in drained)
            dc_h, ts_h = ops.add_dc.cpu().numpy(), ops.add_ts.cpu().numpy()
            live = ts_h > 0
            np.maximum.at(frontiers, (np.nonzero(live)[0], dc_h[live]), ts_h[live])
            before = counts()
            prev = state
            t0 = time.perf_counter()
            state = dense.apply_ops(state, ops, collect_dominated=False)[0]
            sync()
            t["apply_ms"].append(ms_since(t0))
            require_launches({n: c - before[n] for n, c in counts().items()}, wrappers, f"apply round {step}")
            held_again(f"apply round {step}", lambda: dense.apply_ops(prev, ops, collect_dominated=False)[0], state)
            t0 = time.perf_counter()
            wal.log_step(step, list(range(r)), prev, state)
            t["log_step_ms"].append(ms_since(t0))
            t0 = time.perf_counter()
            wal.flush()
            t["flush_ms"].append(ms_since(t0))
            if step == 1:
                t0 = time.perf_counter()
                wal.checkpoint(state, 1)
                checkpoint_s = time.perf_counter() - t0
            if step == rounds - 2:
                lagging = state
            del prev, ops, drained
        backlogs = [host.backlog(x) for x in range(r)]
        stats = host.stats()
        if any(backlogs) or stats["pending"]:
            raise AssertionError(f"backlogs left after the last round: {backlogs}, {stats}")
        if delivered != submitted * r or stats["delivered"] != delivered:
            raise AssertionError(f"delivered {delivered} ops ({stats}) for {submitted} submitted x {r} replicas")
        files = [os.path.join(d, f) for d, _, fs in os.walk(tmp) for f in fs]
        wal_bytes = sum(os.path.getsize(f) for f in files if f.endswith(".wal"))
        ckpt_bytes = sum(os.path.getsize(f) for f in files if f.endswith(ElasticWal.SNAP))
        pre_recover = counts()
        del wal  # the crash: no close, no last flush

        # A fresh log object on the same directory recovers the live state.
        metrics = Metrics()
        like = dense.init(r, 1)
        reset()
        held_recover = {}
        sync()
        t0 = time.perf_counter()
        wal = ElasticWal(tmp, "w0", dense, "topk_rmv", metrics=metrics, partitions=DH_PARTS, durability="group")
        with held_against_plain(torch, held_recover):
            rec, last_step, owned = wal.recover(like)
        sync()
        recover_s = time.perf_counter() - t0
        on_disk = sum(1 for st in wal.streams for _ in st.records())
        wal.close()
        del like
    recovered = int(metrics.counters.get("wal.recovered_records", 0))
    recover_k3 = kernels.sort_slots.launches
    require_launches({"sort_slots": recover_k3}, ["sort_slots"], "recover")
    # `recover` skips a record whose replay raises, a disagreeing K3
    # included: every record the log holds must replay, through one K3
    # call that held. Compaction keeps the active segment of each stream,
    # so the log holds the two steps after the checkpoint and may hold
    # earlier ones.
    if (recovered != on_disk or on_disk < rounds - 2 or held_calls(held_recover, "K3") != recovered
            or recover_k3 != recovered):
        raise AssertionError(f"recovery replayed {recovered} of the {on_disk} records on disk, with {recover_k3} K3 "
                             f"launches of which held against the plain K3: {held_recover}")
    if rec is None or not same(rec, state) or last_step != rounds - 1 or owned != set(range(r)):
        raise AssertionError(f"recovery: last_step {last_step}, records {recovered}, "
                             f"equal {rec is not None and same(rec, state)}")
    t0 = time.perf_counter()
    live_vec = pt.state_digests(state, DH_PARTS)
    digest_s = time.perf_counter() - t0
    if not np.array_equal(pt.state_digests(rec, DH_PARTS), live_vec):
        raise AssertionError("the recovered state's digests differ from the live state's")
    del rec

    # Anti-entropy: the lagging replica set repaired by psnaps of its
    # divergent partitions, through the wire encodings.
    div = pt.divergent_parts(pt.state_digests(lagging, DH_PARTS), live_vec)
    if not div:
        raise AssertionError("the state after round 3 has no divergent partition")
    like_delta = like_delta_for(dense, state)
    fixed, psnap_bytes, psnap_ms, psnaps = lagging, 0, [], []
    for part in div:
        sync()
        t0 = time.perf_counter()
        payload = serial.dumps_dense("topk_rmv_psnap", pt.restrict_psnap(dense, state, part, DH_PARTS))
        blob = pt.encode_psnap_blob(last_step, part, payload)
        _seq, got_part, back = pt.decode_psnap_blob(blob)
        _name, psnap = serial.loads_dense(back, like_delta)
        fixed = pt.apply_psnap(dense, fixed, psnap)
        sync()
        psnap_ms.append(ms_since(t0))
        psnap_bytes += len(blob)
        psnaps.append(psnap)
        if got_part != part:
            raise AssertionError(f"psnap blob of part {part} decoded as part {got_part}")

    def repair():
        out = lagging
        for psnap in psnaps:
            out = pt.apply_psnap(dense, out, psnap)
        return out

    held_again("the psnap repair", repair, fixed)
    del psnaps
    with held_against_plain(torch, held):
        joined_state = dense.merge(lagging, state)
    if not same(fixed, joined_state):
        raise AssertionError("the psnap repair differs from merge(lagging, live)")
    if not np.array_equal(pt.state_digests(fixed, DH_PARTS), live_vec):
        raise AssertionError("the repaired state's digests differ from the live state's")
    del fixed, lagging, joined_state

    # Reconcile: fold the replica rows by the join; the joined top-K is full.
    def reconcile():
        out = row(state, 0)
        for x in range(1, r):
            out = dense.merge(out, row(state, x))
        return out

    sync()
    t0 = time.perf_counter()
    acc = reconcile()
    sync()
    reconcile_ms = ms_since(t0)
    held_again("the reconcile fold", reconcile, acc)
    joined = dense.value(acc)[0][0]
    if len(joined) != k:
        raise AssertionError(f"the joined top-K holds {len(joined)} entries, not {k}")
    post = counts()
    launches = {n: pre_recover[n] + post[n] for n in wrappers}
    # Each launch of the phase was held: the recovery's as it ran, every
    # other one by the same call again under the check.
    calls = {n: held_calls(held, kern) + (held_calls(held_recover, kern) if kern == "K3" else 0)
             for n, kern in (("scatter_max_rows_copy", "K1c"), ("delta_place", "K2"), ("sort_slots", "K3"))}
    if calls != launches:
        raise AssertionError(f"phase 11 launched {launches}, of which held against the plain versions {calls}")
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9
    del state, acc

    # The tokenizer half: raw documents -> native tokenize, per-document
    # dedup and FNV-1a -> the card.
    n_rep, n_docs, n_words = DOC_SHAPE
    rng = np.random.default_rng(0)
    docs = [[" ".join(f"w{w}" for w in line) for line in (rng.zipf(1.1, size=(n_docs, n_words)) - 1) % DOC_VOCAB]
            for _ in range(n_rep)]
    tok = nt.NativeTokenizer(DOC_BUCKETS)
    t0 = time.perf_counter()
    enc = [tok.encode_batch(per_r, per_document=True, threads=0) for per_r in docs]
    encode_ms = ms_since(t0)
    start = 0
    for doc, end in zip(docs[0], enc[0][1].tolist()):
        want = sorted(wc.hash_token(w, DOC_BUCKETS) for w in set(wc.tokenize(doc)))
        if sorted(enc[0][0][start:end].tolist()) != want:
            raise AssertionError(f"replica 0's encoding differs from the Python path at {doc[:40]!r}")
        start = end
    tokens = np.full((n_rep, max(len(e[0]) for e in enc)), -1, np.int32)
    for x, (e, _) in enumerate(enc):
        tokens[x, :len(e)] = e
    eng = registry.make_dense("worddocumentcount", n_buckets=DOC_BUCKETS, device=dev)
    sync()
    t0 = time.perf_counter()
    doc_ops = wc.WordcountOps(key=torch.zeros(tokens.shape, dtype=torch.int32, device=dev),
                              token=torch.from_numpy(tokens).to(dev))
    doc_state, _ = eng.apply_ops(eng.init(n_rep, 1), doc_ops)
    sync()
    doc_apply_ms = ms_since(t0)
    want = np.stack([np.bincount(e, minlength=DOC_BUCKETS) for e, _ in enc])
    if not np.array_equal(doc_state.counts.cpu().numpy()[:, 0], want):
        raise AssertionError("the worddocumentcount counts on the card differ from the encoded corpus")
    raw_tokens = n_rep * n_docs * n_words

    log("11 durable host", card=card, replicas=r, ids=ids, M=m, K=k, rounds=rounds,
        submitted=submitted, delivered=delivered, **t,
        wal_bytes=wal_bytes, checkpoint_bytes=ckpt_bytes, checkpoint_s=checkpoint_s, recover_s=recover_s,
        records_on_disk=on_disk, records_recovered=recovered, recover_k3_held=held_recover, held_against_plain=held, digest_s=digest_s, state_bytes=sum(
            x.numel() * x.element_size() for x in leaves(dense.init(r, 1))),
        divergent_parts=div, psnap_count=len(div), psnap_bytes=psnap_bytes, psnap_apply_ms=psnap_ms,
        reconcile_ms=reconcile_ms, joined_top_k=len(joined), peak_mem_gb=peak_gb, launches=launches,
        tokenizer=dict(replicas=n_rep, documents=n_docs, words=n_words, raw_tokens=raw_tokens,
                       encoded_tokens=int(sum(len(e) for e, _ in enc)), encode_ms=encode_ms,
                       tokens_per_s=raw_tokens / (encode_ms / 1e3), apply_ms=doc_apply_ms),
        phase_s=time.perf_counter() - t_phase)
    return launches


class GossipOps:
    """scripts/elastic_demo.py's op streams at a given width: the ops of
    replica r at a step come from ``default_rng(10 000 (step + 1) + r)``
    (ids Zipf(1.2) over the id space as phase 4 draws them, or uniform
    as elastic_demo draws them with ``zipf=False``; scores in
    [1, 500), ts = step B + j + 1, dc = r mod D, Br removals carrying a
    vc on that dc); a batch holds the owned replicas' ops, the others'
    rows are padding."""

    def __init__(self, r: int, ids: int, b: int, br: int, dev: str, zipf: bool = True):
        self.r, self.ids, self.b, self.br, self.dev, self.zipf = r, ids, b, br, dev, zipf
        self._rows = {}

    def rows(self, step: int, x: int):
        got = self._rows.get((step, x))
        if got is None:
            import numpy as np

            rng = np.random.default_rng(10_000 * (step + 1) + x)
            if self.zipf:
                ids = ((rng.zipf(1.2, self.b) - 1) % self.ids).astype(np.int32)
            else:  # elastic_demo's own draw
                ids = rng.integers(0, self.ids, self.b).astype(np.int32)
            scores = rng.integers(1, 500, self.b).astype(np.int32)
            rmv_id = rng.integers(0, self.ids, self.br).astype(np.int32)
            rmv_t = rng.integers(1, max(2, step * self.b + 1), self.br).astype(np.int32)
            got = self._rows[(step, x)] = (ids, scores, rmv_id, rmv_t)
        return got

    def batch(self, step: int, owned):
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        r, b, br = self.r, self.b, self.br
        cols = dict(
            add_key=np.zeros((r, b), np.int32), add_id=np.zeros((r, b), np.int32),
            add_score=np.zeros((r, b), np.int32), add_dc=np.zeros((r, b), np.int32),
            add_ts=np.zeros((r, b), np.int32), rmv_key=np.zeros((r, br), np.int32),
            rmv_id=np.full((r, br), -1, np.int32), rmv_vc=np.zeros((r, br, r), np.int32),
        )
        for x in sorted(owned):
            ids, scores, rmv_id, rmv_t = self.rows(step, x)
            cols["add_id"][x], cols["add_score"][x] = ids, scores
            cols["add_dc"][x] = x % r
            cols["add_ts"][x] = step * b + np.arange(b) + 1
            cols["rmv_id"][x] = rmv_id
            cols["rmv_vc"][x, :, x % r] = rmv_t
        return convert.from_numpy(TopkRmvOps, cols, self.dev)


def run_gossip(torch, dev: str, geo, *, held=None, timing=None, launches=None, overlap: bool = False) -> dict:
    """tests/test_net_chaos.py's ``run_chaos("topk_rmv", seed=7,
    delta=True)`` on the port at width `geo` = (R, I, B, Br) on `dev`.
    With `held`, every kernel call of member m0 is held against its plain
    version (entries in `held`); with `timing`, publishes and sweeps are
    timed into it; `launches` maps wrapper names to their wrappers, for
    the launches of m0 and of the sweeps. Returns the members' states,
    digests, the reference digest, the fault counters and the sweeps'
    stats. With `overlap`, it is tests/test_overlap.py's
    ``run_overlap_chaos`` instead: every member's inbound half goes
    through an `OverlapPipeline` (depth OVERLAP_DEPTH, `prefetch.poll()`
    every round, `drain_into` every OVERLAP_DRAIN_EVERY rounds and every
    tail round, each timed into ``timing["drain_ms"]``), and the
    counters include the pipelines' ``overlap.*`` and ``ingest.*``."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows
    from antidote_ccrdt_tpu_torch.net.sim import SimNet
    from antidote_ccrdt_tpu_torch.net.transport import GossipNode
    from antidote_ccrdt_tpu_torch.parallel.elastic import DeltaPublisher, my_replicas, sweep_deltas
    from antidote_ccrdt_tpu_torch.parallel.overlap import OverlapPipeline
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    r, ids, b, br = geo
    on_card = torch.device(dev).type == "cuda"

    def wait():
        if on_card:
            sync()

    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=K, slots_per_id=M, device=dev)
    gen = GossipOps(r, ids, b, br, dev)
    launches = launches or {}

    def counts():
        return {n: w.launches for n, w in launches.items()}

    def apply(state, step, owned):
        return dense.apply_ops(state, gen.batch(step, owned), collect_dominated=False)[0]

    def adopt(state, gained, upto):
        for g in sorted(gained):
            for step in range(upto):
                state = apply(state, step, [g])
        return state

    def digest(state):
        obs = dense.value(fold_rows(dense, state, range(r)))[0][0]
        return sorted((int(i), int(sc)) for (i, sc) in obs)

    net = SimNet(seed=GOSSIP_SEED, latency=GOSSIP_LATENCY, loss=GOSSIP_LOSS, dup=GOSSIP_DUP)
    names = [f"m{i}" for i in range(GOSSIP_MEMBERS)]
    nodes = {m: GossipNode(net.join(m)) for m in names}
    states = {m: dense.init(r, 1) for m in names}
    cursors = {m: {} for m in names}
    pubs = {m: DeltaPublisher(nodes[m], dense, name="topk_rmv", full_every=4) for m in names}
    owned = {m: set() for m in names}
    crashed = set()
    sweeps = []
    m0_launches = dict.fromkeys(launches, 0)
    sweep_launches = dict.fromkeys(launches, 0)

    def timed_fetches(node):
        """`node`'s fetches (host: the medium, the blob's decode and its
        upload) timed into timing["fetch_decode_ms"] for one sweep."""
        spent = [0.0]
        for attr in ("fetch", "fetch_delta_framed"):
            inner = getattr(type(node), attr).__get__(node)

            def call(*a, _inner=inner, **kw):
                wait()
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **kw)
                finally:
                    wait()
                    spent[0] += (time.perf_counter() - t0) * 1e3
            setattr(node, attr, call)
        return spent

    def publish_and_sweep(m):
        node = nodes[m]
        snap_before = net.metrics.counters.get("net.snap_bytes", 0)
        wait()
        t0 = time.perf_counter()
        got = pubs[m].publish(states[m])
        wait()
        if timing is not None and m != "m0":
            ms = (time.perf_counter() - t0) * 1e3
            if got["kind"] == "full":
                timing["anchor_publish_ms"].append(ms)
                timing["anchor_bytes"].append(int(net.metrics.counters["net.snap_bytes"] - snap_before))
            else:
                timing["delta_publish_ms"].append(ms)
                timing["delta_bytes"].append(got["nbytes"])
        spent = timed_fetches(node) if timing is not None and m != "m0" else None
        before = counts()
        wait()
        t0 = time.perf_counter()
        states[m], stats = sweep_deltas(node, dense, states[m], cursors[m])
        wait()
        total = (time.perf_counter() - t0) * 1e3
        for n, c in counts().items():
            sweep_launches[n] += c - before[n]
        if spent is not None:
            for attr in ("fetch", "fetch_delta_framed"):
                delattr(node, attr)
            timing["sweep_ms"].append(total)
            timing["fetch_decode_ms"].append(spent[0])
            timing["join_ms"].append(total - spent[0])
        sweeps.append(dict(member=m, **stats))

    def drain(m):
        wait()
        t0 = time.perf_counter()
        states[m] = ovls[m].drain_into(states[m])
        wait()
        if timing is not None:
            timing["drain_ms"].append((time.perf_counter() - t0) * 1e3)

    def member_round(m, step, *, tail=False):
        node = nodes[m]
        node.heartbeat()
        now_owned = owned[m] | set(my_replicas(node, r, GOSSIP_TIMEOUT))
        gained = now_owned - owned[m]
        if gained:
            states[m] = adopt(states[m], sorted(gained), step)
        owned[m] = now_owned
        if not tail:
            states[m] = apply(states[m], step, sorted(owned[m]))
        if overlap:
            if tail or step % 2 == 0:
                pubs[m].publish(states[m])
            ovls[m].prefetch.poll()
            if tail or step % OVERLAP_DRAIN_EVERY == OVERLAP_DRAIN_EVERY - 1:
                drain(m)
        elif tail or step % 2 == 0:
            publish_and_sweep(m)

    def round_of(m, step, tail=False):
        if m != "m0" or held is None:
            return member_round(m, step, tail=tail)
        before = counts()
        with held_against_plain(torch, held):
            member_round(m, step, tail=tail)
        for n, c in counts().items():
            m0_launches[n] += c - before[n]

    for _ in range(3):  # bootstrap: the roster, fault-free
        for m in names:
            nodes[m].heartbeat()
        net.advance(GOSSIP_DT)
    for m in names:
        if set(nodes[m].members()) != set(names):
            raise AssertionError(f"gossip bootstrap incomplete at {m}: {nodes[m].members()}")
    ovls = {m: OverlapPipeline(nodes[m], dense, states[m], depth=OVERLAP_DEPTH, start_thread=False)
            for m in names} if overlap else {}
    for step in range(GOSSIP_STEPS):
        if step == 3:
            net.partition({"m0", "m1"}, {"m2", "m3"})
        if step == 6:
            net.heal()
        if step == 7:
            net.crash("m3")
            crashed.add("m3")
        for m in names:
            if m not in crashed:
                round_of(m, step)
        net.advance(GOSSIP_DT)
    steps_vt = net.time

    ref_state = dense.init(r, 1)
    for step in range(GOSSIP_STEPS):
        ref_state = apply(ref_state, step, range(r))
    ref = digest(ref_state)
    del ref_state
    net.loss = net.dup = 0.0
    live = [m for m in names if m not in crashed]

    # The tail ends when every survivor shows the reference's digest and
    # the victim's replicas have been adopted (a survivor owns each of
    # the R replicas): the digest, a top-K, can agree before the victim's
    # last steps are re-applied.
    tail = 0
    for tail in range(1, GOSSIP_TAIL + 1):
        for m in live:
            round_of(m, GOSSIP_STEPS, tail=True)
        net.advance(GOSSIP_DT)
        covered = set().union(*(owned[m] for m in live)) == set(range(r))
        if covered and all(digest(states[m]) == ref for m in live):
            break
    counters = dict(net.metrics.counters)
    for m in ovls:
        ovls[m].host.close()
        if m in live:
            for k, v in nodes[m].metrics.snapshot()["counters"].items():
                if k.startswith(("overlap.", "ingest.")):
                    counters[k] = counters.get(k, 0.0) + v
    return dict(dense=dense, states={m: states[m] for m in live}, digests={m: digest(states[m]) for m in live},
                ref=ref, covered=covered, counters=counters, sweeps=sweeps, tail_rounds=tail,
                steps_vt=steps_vt, converged_vt=net.time, m0_launches=m0_launches, sweep_launches=sweep_launches)


def phase_gossip(torch, card: str, dev: str = "cuda") -> dict:
    """The gossip plane at the main path's width: the chaos drill on the
    simulator, its reduced twin on the CPU and the card, and a TCP pair.
    Returns the phase's K1c, K2 and K3 launches."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.bridge.protocol import MAX_FRAME
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport
    from antidote_ccrdt_tpu_torch.net.transport import GossipNode
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.parallel.elastic import DeltaPublisher, sweep_deltas
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    wrappers = {"scatter_max_rows_copy": kernels.scatter_max_rows_copy, "delta_place": delta_place,
                "sort_slots": kernels.sort_slots}
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}

    def same(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(leaves(a), leaves(b)))

    def check_drill(out, what):
        bad = {m: d for m, d in out["digests"].items() if d != out["ref"]}
        if not out["ref"] or bad or not out["covered"]:
            raise AssertionError(f"{what}: survivors {sorted(bad)} differ from the sequential reference "
                                 f"after {out['tail_rounds']} tail rounds")
        skipped = [sw for sw in out["sweeps"] if sw["skipped"]]
        if skipped:
            raise AssertionError(f"{what}: sweeps skipped a blob: {skipped}")
        fired = {c: out["counters"].get(c, 0) for c in
                 ("net.sim_lost", "net.sim_duplicated", "net.sim_unreachable", "net.dead_events")}
        if not all(fired.values()):
            raise AssertionError(f"{what}: a fault never fired: {fired}")
        return fired

    t_phase = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    held = {}
    timing = {k: [] for k in ("anchor_publish_ms", "anchor_bytes", "delta_publish_ms", "delta_bytes",
                              "sweep_ms", "fetch_decode_ms", "join_ms")}
    t0 = time.perf_counter()
    out = run_gossip(torch, dev, (R, I, B, BR), held=held, timing=timing, launches=wrappers)
    drill_s = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    require_launches(launches, wrappers, "the gossip drill")
    require_launches(out["sweep_launches"], ["sort_slots"], "the gossip drill's sweeps")
    fired = check_drill(out, "the gossip drill")
    held_calls = {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in wrappers}
    if held_calls != out["m0_launches"] or not all(held_calls.values()):
        raise AssertionError(f"m0 launched {out['m0_launches']}, of which held against the plain versions "
                             f"{held_calls}")
    state_bytes = sum(x.numel() * x.element_size() for x in leaves(out["states"]["m0"]))
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9
    del out["states"], out["dense"]
    gc.collect()

    # The same drill at the reduced width, plain versions on the CPU
    # against the kernels on the card.
    small = {d: run_gossip(torch, d, GOSSIP_SMALL) for d in ("cpu", dev)}
    for d, o in small.items():
        check_drill(o, f"the reduced drill on {d}")
    cpu, card_run = small["cpu"], small[dev]
    if cpu["counters"] != card_run["counters"] or cpu["sweeps"] != card_run["sweeps"]:
        raise AssertionError("the reduced drill's fault counters or sweeps differ between the CPU and the card")
    if sorted(cpu["states"]) != sorted(card_run["states"]) or not all(
            same(cpu["states"][m], card_run["states"][m]) for m in cpu["states"]):
        raise AssertionError("the reduced drill's member states differ between the CPU and the card")

    log("12 gossip", card=card, members=GOSSIP_MEMBERS, steps=GOSSIP_STEPS, replicas=R, ids=I, adds=B,
        removals=BR, state_bytes=state_bytes, steps_virtual_s=out["steps_vt"],
        converged_virtual_s=out["converged_vt"], tail_rounds=out["tail_rounds"], survivors=sorted(out["digests"]),
        digest_entries=len(out["ref"]), **timing, sweeps=len(out["sweeps"]),
        deltas_applied=sum(sw["deltas"] for sw in out["sweeps"]),
        anchors_merged=sum(sw["fulls"] for sw in out["sweeps"]), launches=launches,
        sweep_launches=out["sweep_launches"], m0_launches=out["m0_launches"], held_against_plain=held,
        faults=fired, peak_mem_gb=peak_gb, drill_s=drill_s,
        reduced=dict(geometry=GOSSIP_SMALL, equal_cpu_card=True, tail_rounds=card_run["tail_rounds"]),
        phase_s=time.perf_counter() - t_phase)

    # TCP: the widest anchor under MAX_FRAME, then chained deltas.
    t_tcp = time.perf_counter()
    dense = registry.make_dense("topk_rmv", n_ids=TCP_IDS, n_dcs=R, size=K, slots_per_id=M, device=dev)
    gen = GossipOps(R, TCP_IDS, B, BR, dev)
    a = TcpTransport("a", send_timeout=120.0)
    b = TcpTransport("b", send_timeout=120.0)
    try:
        a.add_peer("b", b.address)
        b.add_peer("a", a.address)
        sender, receiver = GossipNode(a), GossipNode(b)
        pub = DeltaPublisher(sender, dense, name="topk_rmv", full_every=TCP_DELTAS + 1)
        state, got, cursors = dense.init(R, 1), dense.init(R, 1), {}
        tcp = {"anchor_ms": [], "delta_ms": [], "anchor_bytes": [], "delta_bytes": []}
        for step in range(TCP_DELTAS + 1):
            state = dense.apply_ops(state, gen.batch(step, range(R)), collect_dominated=False)[0]
            sync()
            t0 = time.perf_counter()
            kind = pub.publish(state)
            deadline = time.monotonic() + 300
            while not (receiver.snapshot_seq("a") == 0 if kind["kind"] == "full" else step in b.delta_seqs("a")):
                if time.monotonic() > deadline:
                    raise AssertionError(f"TCP {kind['kind']} {step} never arrived: {dict(a.metrics.counters)}")
                time.sleep(0.001)
            got, stats = sweep_deltas(receiver, dense, got, cursors)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            want = {"deltas": 0, "fulls": 1, "skipped": 0} if kind["kind"] == "full" else \
                {"deltas": 1, "fulls": 0, "skipped": 0}
            if (kind["kind"] == "full") != (step == 0) or stats != want:
                raise AssertionError(f"TCP step {step}: published {kind}, swept {stats}")
            tcp["anchor_ms" if step == 0 else "delta_ms"].append(ms)
            if step == 0:
                tcp["anchor_bytes"].append(int(a.metrics.counters["net.snap_bytes"]))
            else:
                tcp["delta_bytes"].append(kind["nbytes"])
        if not same(got, state):
            raise AssertionError("the TCP receiver's state differs from the sender's")
        if not tcp["anchor_bytes"][0] < MAX_FRAME:
            raise AssertionError(f"the TCP anchor of {tcp['anchor_bytes'][0]} bytes is past MAX_FRAME")
        counters = {k: v for k, v in a.metrics.counters.items() if k.startswith("net.")}
    finally:
        a.close()
        b.close()
    log("12 tcp", card=card, replicas=R, ids=TCP_IDS, deltas=TCP_DELTAS, max_frame=MAX_FRAME, **tcp,
        equal=True, sender_counters=counters, phase_s=time.perf_counter() - t_tcp)
    return launches


def ref_values(dense, state, rows: int):
    """The engine's own value() of the folded snapshot, JSON-shaped: what
    every served "value" must equal (scripts/serve_demo.py)."""
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows

    per_key = dense.value(fold_rows(dense, state, range(rows)))[0]
    return [[[int(i), int(sc)] for i, sc in row] for row in per_key]


def serve_mix(rng, n: int, n_keys: int):
    """scripts/serve_demo.py's query mix: 70 % value, 20 % topk 5, 10 %
    range [100, 400], keys uniform."""
    qs = []
    for _ in range(n):
        key, pick = rng.randrange(n_keys), rng.random()
        if pick < 0.7:
            qs.append({"op": "value", "key": key})
        elif pick < 0.9:
            qs.append({"op": "topk", "key": key, "k": 5})
        else:
            qs.append({"op": "range", "key": key, "lo": 100, "hi": 400})
    return qs


def audit_answers(frames, truth, eps: float = 1e-9) -> dict:
    """serve_demo's audit of served frames: each (member, t_send, dt,
    queries, doc). A "value" must equal the reference of the snapshot at
    its as_of_seq; a bound must cover the snapshot's true age at send
    time (one monotonic clock); stale refusals are counted, any other
    error fails the phase."""
    out = dict(served=0, stale=0, overloaded=0, violations=0, mismatches=0, other_errors=[], lat=[])
    for m, t_send, dt, qs, doc in frames:
        if "error" in doc:
            if str(doc["error"]).startswith("overloaded"):
                out["overloaded"] += 1
            else:
                out["other_errors"].append(doc["error"])
            continue
        out["lat"].append(dt)
        for q, r in zip(qs, doc["results"]):
            if "error" in r:
                if r["error"] == "stale":
                    out["stale"] += 1
                else:
                    out["other_errors"].append(r["error"])
                continue
            out["served"] += 1
            t_rec, vals = truth.get((m, r["as_of_seq"]), (None, None))
            if t_rec is None:
                continue  # the start-up snapshot (seq -1)
            if r["staleness_bound_s"] + eps < t_send - t_rec:
                out["violations"] += 1
            if q["op"] == "value" and r["value"] != vals[q["key"]]:
                out["mismatches"] += 1
    return out


def pct_ms(xs, p: float):
    xs = sorted(xs)
    return xs[int(p * (len(xs) - 1))] * 1e3 if xs else None


def phase_serve(torch, card: str, dev: str = "cuda") -> dict:
    """13a: the read plane at the main path's width. Phase 4's engine and
    seeded batches; after each of SERVE_ROUNDS apply rounds the state is
    swapped into a ServePlane, materialized (fold, observe, host pull
    timed apart), and SERVE_CLIENTS threads send frames of SERVE_FRAME
    queries through `handle()` for SERVE_WINDOW_S; one frame a round goes
    over a TcpTransport query frame. Returns the launches and the numbers."""
    import random

    from antidote_ccrdt_tpu_torch import registry, serve
    from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay, fold_rows
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport, query_peer
    from antidote_ccrdt_tpu_torch.ops.dense_table import observe_value
    from antidote_ccrdt_tpu_torch.serve import kernels as serve_kernels
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=R, size=K, slots_per_id=M, device=dev)
    rp = DenseReplay(dense, R)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    batches = [gen.next_batch(B, BR) for _ in range(SERVE_ROUNDS)]  # set-up
    plane = serve.ServePlane(dense, member="s0")
    tr = TcpTransport("s0")
    tr.install_serve(plane)
    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    truth, frames, split, swap_ms, tcp_frames = {}, [], [], [], 0
    storm_s = 0.0
    try:
        for rnd, ops in enumerate(batches):
            rp.apply(ops)
            sync()
            t0 = time.perf_counter()
            plane.swap(rp.state, rnd)
            sync()
            swap_ms.append((time.perf_counter() - t0) * 1e3)
            state = plane.replica.live().state
            # materialize's three parts, each synced, then the whole call.
            t0 = time.perf_counter()
            folded = fold_rows(dense, state, range(R))
            sync()
            t1 = time.perf_counter()
            o = dense.observe(folded)
            sync()
            t2 = time.perf_counter()
            table = observe_value(lambda _s: (o.ids, o.scores, o.valid), folded)[0]
            t3 = time.perf_counter()
            view = serve_kernels.materialize(dense, state)
            sync()
            t4 = time.perf_counter()
            if view.table != table:
                raise AssertionError(f"round {rnd}: materialize's view differs from fold + observe + pull")
            split.append(dict(fold_ms=(t1 - t0) * 1e3, observe_ms=(t2 - t1) * 1e3, pull_ms=(t3 - t2) * 1e3,
                              materialize_ms=(t4 - t3) * 1e3))
            truth[("s0", rnd)] = (time.monotonic(), [[[int(i), int(sc)] for i, sc in row] for row in table])
            del folded, o, view

            stop = threading.Event()
            got = [[] for _ in range(SERVE_CLIENTS)]

            def client(ci, _rnd=rnd):
                rng = random.Random(1000 * (_rnd + 1) + ci)
                while not stop.is_set():
                    qs = serve_mix(rng, SERVE_FRAME, 1)
                    # serve_demo's knob: mostly loose, rarely impossible
                    # (here also each thread's first frame, so that the
                    # refusal path always runs).
                    ms = 1e-6 if not got[ci] or rng.random() < 0.02 else 5.0
                    t_send = time.monotonic()
                    raw = plane.handle(serve.request_bytes(qs, max_staleness_s=ms))
                    got[ci].append(("s0", t_send, time.monotonic() - t_send, qs, json.loads(raw)))

            threads = [threading.Thread(target=client, args=(ci,), daemon=True) for ci in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            qs = serve_mix(random.Random(rnd), SERVE_FRAME, 1)
            t_send = time.monotonic()
            member, raw = query_peer(tr.address, serve.request_bytes(qs, max_staleness_s=60.0), timeout=30.0)
            if member != "s0":
                raise AssertionError(f"the TCP query frame was answered by {member}")
            got[0].append(("s0", t_send, time.monotonic() - t_send, qs, json.loads(raw)))
            tcp_frames += 1
            time.sleep(max(0.0, SERVE_WINDOW_S - (time.perf_counter() - t0)))
            stop.set()
            for th in threads:
                th.join(30.0)
            storm_s += time.perf_counter() - t0
            if any(th.is_alive() for th in threads):
                raise AssertionError(f"round {rnd}: a client thread hung")
            for g in got:
                frames.extend(g)
        peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9
    finally:
        tr.close()
    audit = audit_answers(frames, truth)
    if audit["violations"] or audit["mismatches"] or audit["other_errors"] or not audit["stale"]:
        raise AssertionError(f"13a read plane: {dict(audit, lat=len(audit['lat']), other_errors=audit['other_errors'][:3])}")
    counters = {k: int(v) for k, v in plane.metrics.snapshot()["counters"].items() if k.startswith("serve.")}
    return dict(rounds=SERVE_ROUNDS, clients=SERVE_CLIENTS, frame=SERVE_FRAME, frames=len(frames),
                tcp_frames=tcp_frames, served=audit["served"], stale_rejected=audit["stale"],
                reads_per_s=audit["served"] / max(storm_s, 1e-9), storm_s=storm_s,
                read_p50_ms=pct_ms(audit["lat"], 0.5), read_p99_ms=pct_ms(audit["lat"], 0.99),
                materialize=split, swap_ms=swap_ms, state_bytes=sum(
                    x.numel() * x.element_size() for x in leaves(rp.state)),
                peak_mem_gb=peak_gb, counters=counters, bound_violations=0, identity_mismatches=0)


class FleetOps:
    """scripts/serve_demo.py's op streams at a given width: replica x at a
    step from ``default_rng(55 000 (step + 1) + x)``, keys and ids uniform
    over NK and the id space, scores in [1, 500), dc = x mod D, ts =
    step B + j + 1, Br removals with a vc on that dc; rows of replicas not
    owned are padding."""

    def __init__(self, r: int, ids: int, nk: int, b: int, br: int, dev: str):
        self.r, self.ids, self.nk, self.b, self.br, self.dev = r, ids, nk, b, br, dev

    def batch(self, step: int, owned):
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        r, b, br = self.r, self.b, self.br
        cols = dict(
            add_key=np.zeros((r, b), np.int32), add_id=np.zeros((r, b), np.int32),
            add_score=np.zeros((r, b), np.int32), add_dc=np.zeros((r, b), np.int32),
            add_ts=np.zeros((r, b), np.int32), rmv_key=np.zeros((r, br), np.int32),
            rmv_id=np.full((r, br), -1, np.int32), rmv_vc=np.zeros((r, br, r), np.int32),
        )
        for x in sorted(owned):
            rng = np.random.default_rng(55_000 * (step + 1) + x)
            cols["add_key"][x] = rng.integers(0, self.nk, b)
            cols["add_id"][x] = rng.integers(0, self.ids, b)
            cols["add_score"][x] = rng.integers(1, 500, b)
            cols["add_dc"][x] = x % r
            cols["add_ts"][x] = step * b + np.arange(b) + 1
            cols["rmv_key"][x] = rng.integers(0, self.nk, br)
            cols["rmv_id"][x] = rng.integers(0, self.ids, br)
            cols["rmv_vc"][x, :, x % r] = rng.integers(1, max(2, step * b + 1), br)
        return convert.from_numpy(TopkRmvOps, cols, self.dev)

    def ingest(self, effects, row: int):
        """Client effect ops (``serve.effect_from_wire`` tuples) as one
        batch into replica row `row` (scripts/elastic_demo.py's drill
        ``ingest``): adds ("add"/"add_r", (id, score, (dc, ts))),
        removals ("rmv"/"rmv_r", (id, {dc: ts}))."""
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        adds = [p for k, p in effects if k in ("add", "add_r")]
        rmvs = [p for k, p in effects if k in ("rmv", "rmv_r")]
        r, nb, nr = self.r, max(len(adds), 1), max(len(rmvs), 1)
        cols = dict(
            add_key=np.zeros((r, nb), np.int32), add_id=np.zeros((r, nb), np.int32),
            add_score=np.zeros((r, nb), np.int32), add_dc=np.zeros((r, nb), np.int32),
            add_ts=np.zeros((r, nb), np.int32), rmv_key=np.zeros((r, nr), np.int32),
            rmv_id=np.full((r, nr), -1, np.int32), rmv_vc=np.zeros((r, nr, r), np.int32),
        )
        for j, (id_, score, (dc, ts)) in enumerate(adds):
            cols["add_id"][row, j], cols["add_score"][row, j] = int(id_), int(score)
            cols["add_dc"][row, j], cols["add_ts"][row, j] = int(dc) % r, int(ts)
        for j, (id_, vc) in enumerate(rmvs):
            cols["rmv_id"][row, j] = int(id_)
            for d, ts in vc.items():
                if 0 <= int(d) < r:
                    cols["rmv_vc"][row, j, int(d)] = int(ts)
        return convert.from_numpy(TopkRmvOps, cols, self.dev)


def run_fleet(torch, dev: str, geo, *, storm: bool, held=None) -> dict:
    """scripts/serve_demo.py's served fleet with scripts/write_tier_demo.py's
    write tier, in one process on `dev`, at width `geo` = (R, I, B, Br).

    Three workers, each a TcpTransport + GossipNode + LagTracker +
    ServePlane + IngestPlane + ElasticWal (group commit, a temp
    directory), own a block of replicas. A step, worker by worker: apply
    its replicas' ops, drain its ingest queue into its lowest replica row
    (scripts/elastic_demo.py's order: after the drill's ops, before the
    WAL record), log the step and flush it, publish the whole state and
    swap it into its plane; then, once every published snapshot has
    reached every peer (republished if a send was dropped), each worker
    sweeps and feeds its lag tracker. After its publish at FLEET_KILL_AT
    the owner of key "k0" fails: its transport closes, its parked writes
    fail, a probe write fails over, and the survivors adopt its replicas.
    A fault-free tail republishes until every survivor's digest equals
    the sequential reference (every replica's ops and every folded client
    write, in the rows and steps they landed in).

    `storm`: SERVE_CLIENTS query threads and FLEET_WRITERS writer threads
    run through the steps under FLEET_FAULTS (the demos' flows). Without
    it the same steps run with no threads, faults or clock reads in any
    answer: before each step one burst per writer is parked, every ack is
    read back after the step, and a fixed frame of queries is answered by
    every worker, so that the answer bytes, certificates and digests of
    two runs can be compared. With `held`, every K1c, K2 and K3 call of
    worker w0's turns (main thread) is held against its plain version."""
    import random
    import shutil
    import tempfile

    import numpy as np

    from antidote_ccrdt_tpu_torch import registry, serve
    from antidote_ccrdt_tpu_torch.harness.wal import ElasticWal
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport, query_peer
    from antidote_ccrdt_tpu_torch.net.transport import GossipNode
    from antidote_ccrdt_tpu_torch.obs import audit, events as obs_events
    from antidote_ccrdt_tpu_torch.obs.lag import LagTracker
    from antidote_ccrdt_tpu_torch.parallel.elastic import sweep
    from antidote_ccrdt_tpu_torch.serve.ingest import ACK_DURABLE, ACK_REPLICATED, WriteRouter, tcp_write_fn
    from antidote_ccrdt_tpu_torch.topo import rendezvous_order
    from antidote_ccrdt_tpu_torch.utils import faults
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    r, ids, b, br = geo
    nk, members = FLEET_NK, list(FLEET_MEMBERS)
    on_card = torch.device(dev).type == "cuda"
    main = threading.get_ident()
    mono = time.monotonic if storm else (lambda: 0.0)
    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=K, slots_per_id=M, device=dev)
    gen = FleetOps(r, ids, nk, b, br, dev)
    victim = rendezvous_order("k0", members)[0]
    owned = {m: {int(x) for x in blk} for m, blk in zip(members, np.array_split(range(r), len(members)))}
    alive, dead = list(members), set()

    def wait():
        if on_card:
            sync()

    obs_events.reset("clients")
    tmp = tempfile.mkdtemp(prefix="fleet-wal-")
    transports = {m: TcpTransport(m, send_timeout=120.0) for m in members}
    addrs = {m: transports[m].address for m in members}
    metrics = Metrics()  # the clients' counters
    step_ms, step_split, fold_log, member_logs = [], [], [], {m: [] for m in members}
    truth, frames = {}, []
    frame_errors = [0]
    wals = {}
    # Writers stop two steps before the last, so that every parked write
    # is folded (write_tier_demo stops them before the survivors' final
    # steps for the same reason); readers stop after the last step.
    stop, stop_writes = threading.Event(), threading.Event()
    try:
        for m in members:
            for n in members:
                if n != m:
                    transports[m].add_peer(n, addrs[n])
        stores = {m: GossipNode(transports[m]) for m in members}
        lags = {m: LagTracker(m, clock=mono, mono=mono) for m in members}
        planes = {m: serve.ServePlane(dense, member=m, metrics=stores[m].metrics, lag_tracker=lags[m], mono=mono)
                  for m in members}
        wals.update((m, ElasticWal(tmp, m, dense, "topk_rmv", metrics=stores[m].metrics, durability="group"))
                    for m in members)
        applied = {m: {} for m in members}  # m -> {peer: highest snapshot seq swept}
        ingest_step = dict.fromkeys(members, -1)
        iplanes = {m: serve.IngestPlane(
            m, metrics=stores[m].metrics, durable_fn=lambda m=m: int(wals[m].durable_seq),
            watermarks_fn=lambda m=m: {**{p: int(s) for p, s in applied[m].items()}, m: int(ingest_step[m])},
            ack_timeout_s=20.0, poll_s=0.01, mono=time.monotonic) for m in members}
        states = {m: dense.init(r, nk) for m in members}
        for m in members:
            transports[m].install_serve(planes[m])
            transports[m].install_ingest(iplanes[m])
            planes[m].swap(states[m], -1)
        deadline = time.monotonic() + 30.0
        while any(len(stores[m].members()) < len(members) for m in members):
            for m in members:
                stores[m].heartbeat()
            if time.monotonic() > deadline:
                raise AssertionError("the fleet's start barrier timed out")
            time.sleep(0.02)

        def member_events(m, fn, *a):
            """Run fn on this thread; the wal.* and snap.apply events it
            emitted go to m's flight log (in one process the recorder is
            shared; a worker process would have written them itself)."""
            top = max((e["seq"] for e in obs_events.events()), default=-1)
            out = fn(*a)
            member_logs[m].extend(dict(e, member=m) for e in obs_events.events()
                                  if e["seq"] > top and (e["kind"].startswith("wal.") or e["kind"] == "snap.apply"))
            return out

        def fold_ingest(m, step):
            row = min(owned[m])

            def fold(ops):
                effects = [serve.effect_from_wire(o) for o in ops]
                states[m] = dense.apply_ops(states[m], gen.ingest(effects, row), collect_dominated=False)[0]
                fold_log.append((step, row, effects))
            return fold

        def turn(m, step):
            stores[m].heartbeat()
            pre = states[m]
            states[m] = dense.apply_ops(states[m], gen.batch(step, owned[m]), collect_dominated=False)[0]
            ingest_step[m] = step
            iplanes[m].drain(step, fold_ingest(m, step))
            member_events(m, wals[m].log_step, step, sorted(owned[m]), pre, states[m])
            member_events(m, wals[m].flush)  # durable before visible (elastic_demo's group commit)
            publish(m, step)

        def publish(m, seq):
            # Durable before visible: the WAL record precedes the publish,
            # and the plane swaps the published state (elastic_demo's
            # order); its watermarks claim the peers swept before.
            stores[m].publish("topk_rmv", states[m], seq)
            vals = ref_values(dense, states[m], r)
            planes[m].swap(states[m], seq)
            truth[(m, seq)] = (time.monotonic(), vals)

        def settle(m):
            got, _n = member_events(m, sweep, stores[m], dense, states[m])
            states[m] = got
            for peer in members:
                hi = stores[m].snapshot_seq(peer)
                if peer != m and hi is not None:
                    applied[m][peer] = int(hi)
                    lags[m].observe_published(peer, hi)
                    lags[m].observe_applied(peer, hi)

        def delivered(step, publishers):
            """Wait until every alive worker holds every publisher's
            snapshot at `step`, republishing a lagging one after 3 s
            (a dropped send)."""
            t_pub = dict.fromkeys(publishers, time.monotonic())
            deadline = time.monotonic() + 120.0
            while True:
                late = [p for p in publishers if any(
                    stores[m].snapshot_seq(p) != step for m in alive if m != p)]
                if not late:
                    return
                if time.monotonic() > deadline:
                    raise AssertionError(f"step {step}: snapshots of {late} never arrived")
                for p in late:
                    if time.monotonic() - t_pub[p] > 3.0:
                        stores[p].publish("topk_rmv", states[p], step)
                        t_pub[p] = time.monotonic()
                time.sleep(0.005)

        def one_step(step):
            t0 = time.perf_counter()
            for m in list(alive):
                if m == "w0" and held is not None:
                    with held_against_plain(torch, held, thread=main):
                        turn(m, step)
                else:
                    turn(m, step)
            wait()
            t1 = time.perf_counter()
            delivered(step, list(alive))
            t2 = time.perf_counter()
            for m in list(alive):
                if m == "w0" and held is not None:
                    with held_against_plain(torch, held, thread=main):
                        settle(m)
                else:
                    settle(m)
            wait()
            split = dict(step=step, turns_ms=(t1 - t0) * 1e3, delivery_ms=(t2 - t1) * 1e3,
                         sweeps_ms=(time.perf_counter() - t2) * 1e3, frames=len(frames))
            step_split.append(split)
            if storm:
                print(f"[13 fleet step] {json.dumps(split)}", file=sys.stderr, flush=True)

        def verdict(p):
            return "dead" if p in dead else "alive"

        def failed_worker(_arg):
            raise RuntimeError("the worker failed")

        # -- the clients -------------------------------------------------
        # A FleetRouter learns a peer's watermarks only from that peer's
        # answers, and while every learned set misses a session's floor
        # it waits without asking anyone again (serve/router.py, as in
        # the JAX package): its session wait cannot see a peer catch up.
        # So a read-back asks through a router of its own (breakers
        # shared), and asks again until FLEET_READBACK_S has passed.
        board = serve.BreakerBoard(fail_threshold=6)

        def read_router():
            return serve.FleetRouter(members, serve.tcp_query_fn(addrs), metrics=metrics, verdict_fn=verdict,
                                     hedge=False, timeout_s=10.0, retries=2, backoff_base_s=0.02,
                                     session_wait_s=0.0, poll_s=0.002, seed=1, breakers=board)
        ts_lock, ts_cell = threading.Lock(), [0]
        sessions = [serve.ClientSession(f"fleet-w{ci}") for ci in range(FLEET_WRITERS)]
        wsessions = []
        for ci in range(FLEET_WRITERS):
            router = WriteRouter(members, tcp_write_fn(addrs), member=f"c{ci}", metrics=metrics,
                                 verdict_fn=verdict, timeout_s=60.0, retries=2, backoff_base_s=0.02,
                                 replication_wait_s=60.0, probe_timeout_s=5.0, poll_s=0.02, seed=ci,
                                 breaker_failures=6)
            wsessions.append(serve.WriteSession(
                router, "topk_rmv", session=sessions[ci], session_id=f"fleet-w{ci}", batch_max=999,
                ack=ACK_REPLICATED if ci == FLEET_WRITERS - 1 else ACK_DURABLE, k=2, m_keep=M,
                metrics=metrics, device=dev))

        def stage_burst(ci, rng, n_burst):
            key = "k0" if n_burst == 0 else f"k{rng.randrange(6)}"
            for id_ in rng.sample(range(min(40, ids)), FLEET_IDS_PER_BURST):
                for _ in range(FLEET_ADDS_PER_ID):
                    with ts_lock:
                        ts_cell[0] += 1
                        ts = 1_000_000 + ts_cell[0]
                    wsessions[ci].stage(key, ("add", (id_, rng.randrange(1, 1000), (ci % r, ts))))

        def flush_and_read(ci, st):
            t0 = time.monotonic()
            results = wsessions[ci].flush()
            dt = time.monotonic() - t0
            for out in results:
                st["results"] += 1
                st["lat"].append(dt)
                if out.get("error") is not None:
                    st["errors"].append(str(out.get("error")))
                    continue
                st["acked"] += 1
                lvl = str(out.get("level"))
                st["levels"][lvl] = st["levels"].get(lvl, 0) + 1
                st["victim_hard"] += int(out.get("origin") == victim and lvl in (ACK_DURABLE, ACK_REPLICATED))
                st["pending_reads"].append(out["key"])
            if storm:
                read_back(ci, st)

        def read_back(ci, st):
            for key in st["pending_reads"]:
                deadline = time.monotonic() + FLEET_READBACK_S
                while True:
                    rd = read_router().query([{"op": "value", "key": 0}], key=key,
                                             max_staleness_s=FLEET_STALENESS_S, session=sessions[ci])
                    if rd.get("error") != "session_unsatisfiable" or time.monotonic() > deadline:
                        break
                    st["ryw_waits"] += 1
                    time.sleep(0.25)
                if "peer" in rd and "error" not in rd:
                    st["ryw_ok"] += 1
                    st["read_docs"].append(json.dumps(rd, sort_keys=True))
                else:
                    st["ryw_failed"].append(dict(rd, key=key, floor=sessions[ci].token.floor(), watermarks={
                        m: planes[m].applied_watermarks(planes[m].replica.live().seq) for m in alive}))
            st["pending_reads"].clear()

        stats = [dict(results=0, acked=0, levels={}, victim_hard=0, lat=[], errors=[], ryw_ok=0,
                      ryw_waits=0, ryw_failed=[], pending_reads=[], read_docs=[]) for _ in range(FLEET_WRITERS)]
        threads = []
        if storm:
            faults.install(FLEET_FAULTS, seed=5)

            def writer(ci):
                rng, n = random.Random(200 + ci), 0
                while not stop_writes.is_set():
                    stage_burst(ci, rng, n)
                    n += 1
                    flush_and_read(ci, stats[ci])

            def client(ci):
                rng, n = random.Random(1000 + ci), 0
                while not stop.is_set():
                    m = members[rng.randrange(len(members))]
                    qs = serve_mix(rng, SERVE_FRAME, nk)
                    ms = 1e-6 if n == 0 or rng.random() < 0.02 else FLEET_STALENESS_S
                    n += 1
                    t_send = time.monotonic()
                    try:
                        _, raw = query_peer(addrs[m], serve.request_bytes(qs, max_staleness_s=ms), timeout=10.0)
                        doc = json.loads(raw.decode("utf-8"))
                    except Exception:  # noqa: BLE001 — a dropped frame, or the failed worker
                        frame_errors[0] += 1
                        time.sleep(0.01)
                        continue
                    frames.append((m, t_send, time.monotonic() - t_send, qs, doc))
                    time.sleep(FLEET_QUERY_GAP_S)

            threads = ([threading.Thread(target=writer, args=(ci,), daemon=True) for ci in range(FLEET_WRITERS)]
                       + [threading.Thread(target=client, args=(ci,), daemon=True) for ci in range(SERVE_CLIENTS)])
            for th in threads:
                th.start()
        rngs = [random.Random(200 + ci) for ci in range(FLEET_WRITERS)]
        answers = []
        probe = {}
        t_drill = time.perf_counter()
        for step in range(FLEET_STEPS):
            t_step = time.perf_counter()
            if step == FLEET_STEPS - 2:
                stop_writes.set()
            flushers = []
            if not storm:
                # One burst a writer, parked at its owner before the step.
                for ci in range(FLEET_WRITERS):
                    stage_burst(ci, rngs[ci], step)
                    base = sum(iplanes[m].depth() for m in alive)
                    flushers.append(threading.Thread(target=flush_and_read, args=(ci, stats[ci]), daemon=True))
                    flushers[-1].start()
                    deadline = time.monotonic() + 30.0
                    while sum(iplanes[m].depth() for m in alive) <= base:
                        if time.monotonic() > deadline:
                            raise AssertionError(f"step {step}: writer {ci}'s burst was never parked")
                        time.sleep(0.001)
            one_step(step)
            for th in flushers:
                th.join(120.0)
                if th.is_alive():
                    raise AssertionError(f"step {step}: a write never completed")
            if not storm:
                for ci in range(FLEET_WRITERS):
                    read_back(ci, stats[ci])
                frame = serve.request_bytes(serve_mix(random.Random(step), 64, nk))
                answers.extend(planes[m].handle(frame) for m in alive)
            if step == FLEET_KILL_AT:
                # The hot key's owner fails after its publish: its transport
                # closes, writes parked at it fail (the fold never ran),
                # a probe write to its key fails over, and the survivors
                # adopt its replicas.
                for install in (transports[victim].install_serve, transports[victim].install_ingest):
                    install(failed_worker)  # a frame that still reaches it finds its connection closed
                transports[victim].close()
                alive.remove(victim)
                iplanes[victim].drain(step + 1, failed_worker)
                failovers = metrics.counters.get("router.write_failovers", 0)
                probe_router = WriteRouter(members, tcp_write_fn(addrs), member="probe", metrics=metrics,
                                           verdict_fn=verdict, timeout_s=60.0, retries=2, backoff_base_s=0.02,
                                           poll_s=0.002, seed=99)
                th = threading.Thread(target=lambda: probe.update(out=probe_router.write(
                    [["add", [1, 5, [0, 2_000_000]]]], key="k0", ack="applied", write_id="probe:k0")), daemon=True)
                th.start()
                deadline = time.monotonic() + 30.0
                while metrics.counters.get("router.write_failovers", 0) <= failovers:
                    if time.monotonic() > deadline:
                        raise AssertionError("the probe write never failed over from the failed owner")
                    time.sleep(0.005)
                dead.add(victim)
                probe["thread"] = th
                gained = sorted(owned.pop(victim))
                for j, x in enumerate(gained):
                    owned[alive[j % len(alive)]].add(x)
            step_ms.append((time.perf_counter() - t_step) * 1e3)
        stop.set()
        for th in threads:
            th.join(180.0)
        if any(th.is_alive() for th in threads):
            raise AssertionError("a client thread never finished")
        probe["thread"].join(60.0)
        if not (probe.get("out") or {}).get("write_ack"):
            raise AssertionError(f"the probe write was not acked after failover: {probe.get('out')}")
        fault_hits = len(faults.trace()) if storm else 0
        faults.uninstall()
        drill_s = time.perf_counter() - t_drill

        # The sequential reference: every replica's ops and every folded
        # client write, in the rows and steps they landed in.
        ref_state = dense.init(r, nk)
        for step in range(FLEET_STEPS):
            ref_state = dense.apply_ops(ref_state, gen.batch(step, range(r)), collect_dominated=False)[0]
            for s, row, effects in fold_log:
                if s == step:
                    ref_state = dense.apply_ops(ref_state, gen.ingest(effects, row), collect_dominated=False)[0]
        ref = [sorted(map(tuple, row)) for row in ref_values(dense, ref_state, r)]
        del ref_state
        digests, tail = {}, 0
        for tail in range(1, FLEET_TAIL + 1):
            digests = {m: [sorted(map(tuple, row)) for row in ref_values(dense, states[m], r)] for m in alive}
            if all(d == ref for d in digests.values()):
                break
            seq = FLEET_STEPS + tail
            for m in alive:
                stores[m].heartbeat()
                publish(m, seq)
            delivered(seq, list(alive))
            for m in alive:
                settle(m)

        # -- certify ------------------------------------------------------
        client_log = obs_events.events("ingest.ack")
        session_log = sorted(obs_events.events("session.write") + obs_events.events("session.read"),
                             key=lambda e: e["seq"])
        folds = obs_events.events("ingest.fold")
        logs = {f"flight-{m}": member_logs[m] + [e for e in folds if e.get("member") == m] for m in members}
        logs["client-writes"] = client_log
        wcert = audit.certify_writes(logs=logs, meta={"arm": "honest", "drill": "served fleet", "killed": victim})
        scert = audit.certify_sessions(logs={"writer": session_log}, meta={"arm": "cross-tier-ryw",
                                                                             "drill": "served fleet"})
        counters = {k: int(v) for k, v in metrics.snapshot()["counters"].items()}
        serve_counters = {}
        for m in members:
            for k, v in stores[m].metrics.snapshot()["counters"].items():
                if k.startswith(("serve.", "ingest.", "net.queries", "net.writes")):
                    serve_counters[k] = serve_counters.get(k, 0) + int(v)
        return dict(victim=victim, survivors=list(alive), digests=digests, ref=ref, tail_rounds=tail, step_split=step_split,
                    wcert=wcert, scert=scert, stats=stats, frames=frames, frame_errors=frame_errors[0],
                    truth=truth, answers=answers, counters=counters, serve_counters=serve_counters,
                    folds=len(fold_log), step_ms=step_ms, drill_s=drill_s,
                    state_bytes=sum(x.numel() * x.element_size() for x in leaves(states[alive[0]])),
                    fault_hits=fault_hits)
    finally:
        stop.set()
        stop_writes.set()
        faults.uninstall()
        for t in transports.values():
            t.close()
        for w in wals.values():
            w.close()
        shutil.rmtree(tmp, ignore_errors=True)
        obs_events.reset("?")


def check_fleet(out: dict, what: str, storm: bool) -> dict:
    """The served fleet's gates. Returns the audit of its answers."""
    from antidote_ccrdt_tpu_torch.obs.audit import verify_certificate

    bad = {m: d for m, d in out["digests"].items() if d != out["ref"]}
    if not out["ref"] or bad or len(out["digests"]) != len(FLEET_MEMBERS) - 1:
        raise AssertionError(f"{what}: survivors {sorted(bad)} differ from the sequential reference "
                             f"after {out['tail_rounds']} tail rounds")
    acked = sum(st["acked"] for st in out["stats"])
    ryw = sum(st["ryw_ok"] for st in out["stats"])
    errors = [e for st in out["stats"] for e in st["errors"] + st["ryw_failed"]]
    if not acked or ryw != acked or errors:
        raise AssertionError(f"{what}: {acked} writes acked, {ryw} read back by their sessions; errors {errors[:4]}")
    levels = {}
    for st in out["stats"]:
        for lvl, n in st["levels"].items():
            levels[lvl] = levels.get(lvl, 0) + n
    if not (levels.get("durable") and levels.get("replicated_to_k")):
        raise AssertionError(f"{what}: hard ack levels not both exercised: {levels}")
    w, s = out["wcert"], out["scert"]
    if not (w["ok"] and verify_certificate(w) and w["n_acks"] > 0):
        raise AssertionError(f"{what}: write certificate {json.dumps(w)[:600]}")
    if not (s["ok"] and verify_certificate(s) and s["n_writes"] > 0 and s["n_reads"] > 0):
        raise AssertionError(f"{what}: session certificate {json.dumps(s)[:600]}")
    zero = [k for k in FLEET_NONZERO if not out["counters"].get(k)]
    if zero:
        raise AssertionError(f"{what}: counters never lit: {zero}")
    audit = audit_answers(out["frames"], out["truth"])
    if audit["violations"] or audit["mismatches"] or audit["other_errors"]:
        raise AssertionError(f"{what}: {audit['violations']} bound violations, {audit['mismatches']} identity "
                             f"mismatches, errors {audit['other_errors'][:3]}")
    if storm and not (audit["served"] and audit["stale"] and sum(st["victim_hard"] for st in out["stats"])):
        raise AssertionError(f"{what}: served {audit['served']}, stale {audit['stale']}, victim hard acks "
                             f"{sum(st['victim_hard'] for st in out['stats'])}")
    return dict(audit, levels=levels, acked=acked)


def phase_fleet(torch, card: str, dev: str = "cuda") -> dict:
    """Phase 13: the read plane at the main path's width (13a) and the
    served fleet drill (13b); its reduced twin is `fleet_reduced`, which
    main() runs beside phase 24's start-up. Returns the phase's K1c, K2 and K3
    launches (13a and 13b)."""
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    wrappers = {"scatter_max_rows_copy": kernels.scatter_max_rows_copy, "delta_place": delta_place,
                "sort_slots": kernels.sort_slots}
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}
    t_phase = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    read = phase_serve(torch, card, dev)
    read_launches = {n: w.launches for n, w in wrappers.items()}
    require_launches(read_launches, wrappers, "the read plane's rounds and materializations")
    log("13 serve", card=card, replicas=R, ids=I, adds=B, removals=BR, **read, launches=read_launches)

    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    held = {}
    t0 = time.perf_counter()
    out = run_fleet(torch, dev, FLEET, storm=True, held=held)
    fleet_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9
    launches = {n: w.launches for n, w in wrappers.items()}
    require_launches({n: launches[n] - read_launches[n] for n in wrappers}, wrappers, "the served fleet")
    print(f"[13 fleet drill] {json.dumps(dict(step_ms=out['step_ms'], drill_s=out['drill_s']))}",
          file=sys.stderr, flush=True)
    audit = check_fleet(out, "the served fleet", storm=True)
    held_calls = {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in wrappers}
    if not all(held_calls.values()) or any(v["max_abs_err"] for v in held.values()):
        raise AssertionError(f"w0's held calls {held_calls}: {held}")
    lat = [x for st in out["stats"] for x in st["lat"]]
    log("13 fleet", card=card, members=list(FLEET_MEMBERS), geometry=dict(zip(("R", "I", "B", "Br"), FLEET)),
        keys=FLEET_NK, steps=FLEET_STEPS, killed=out["victim"], kill_after_step=FLEET_KILL_AT,
        state_bytes=out["state_bytes"], step_ms=out["step_ms"], step_split=out["step_split"], drill_s=out["drill_s"],
        tail_rounds=out["tail_rounds"], frames=len(out["frames"]), frame_errors=out["frame_errors"],
        served=audit["served"], stale_rejected=audit["stale"], reads_per_s=audit["served"] / out["drill_s"],
        read_p50_ms=pct_ms(audit["lat"], 0.5), read_p99_ms=pct_ms(audit["lat"], 0.99),
        bound_violations=audit["violations"], identity_mismatches=audit["mismatches"],
        writes_acked=audit["acked"], acks_by_level=audit["levels"], write_results=sum(
            st["results"] for st in out["stats"]), write_p50_ms=pct_ms(lat, 0.5), write_p99_ms=pct_ms(lat, 0.99),
        victim_hard_acks=sum(st["victim_hard"] for st in out["stats"]), ryw_reads=sum(
            st["ryw_ok"] for st in out["stats"]), ryw_rereads=sum(st["ryw_waits"] for st in out["stats"]),
        client_writes_folded=out["folds"],
        write_certificate=dict(ok=out["wcert"]["ok"], n_acks=out["wcert"]["n_acks"],
                               origins=out["wcert"]["origins"]),
        session_certificate={k: out["scert"].get(k) for k in ("ok", "n_sessions", "n_reads", "n_writes",
                                                              "n_violations")},
        client_counters={k: v for k, v in out["counters"].items() if k.startswith(("router.", "write_session."))},
        serve_counters=out["serve_counters"], fault_hits=out["fault_hits"], launches={
            n: launches[n] - read_launches[n] for n in wrappers}, held_against_plain=held,
        peak_mem_gb=peak_gb, fleet_s=fleet_s, phase_s=time.perf_counter() - t_phase)
    del out
    gc.collect()

    return launches


def fleet_reduced(torch, card: str, dev: str = "cuda") -> None:
    """Phase 13's flow at FLEET_SMALL, plain versions on the CPU against the
    kernels on the card: equal answer bytes, certificates (one frozen wall
    clock) and digests. No wall clock gates it."""
    t_phase = time.perf_counter()
    small = {}
    for d in ("cpu", dev):
        with frozen_wall_clock():
            small[d] = run_fleet(torch, d, FLEET_SMALL, storm=False)
        check_fleet(small[d], f"the reduced fleet on {d}", storm=False)
    cpu, on_card = small["cpu"], small[dev]
    for key in ("answers", "digests", "ref"):
        if cpu[key] != on_card[key]:
            raise AssertionError(f"the reduced fleet's {key} differ between the CPU and the card")
    for key in ("wcert", "scert"):
        if json.dumps(cpu[key], sort_keys=True) != json.dumps(on_card[key], sort_keys=True):
            raise AssertionError(f"the reduced fleet's {key} differ between the CPU and the card")
    reads = [d for st in cpu["stats"] for d in st["read_docs"]]
    if reads != [d for st in on_card["stats"] for d in st["read_docs"]]:
        raise AssertionError("the reduced fleet's read-your-writes answers differ between the CPU and the card")
    log("13 reduced", card=card, geometry=dict(zip(("R", "I", "B", "Br"), FLEET_SMALL)), equal_cpu_card=True,
        answer_frames=len(cpu["answers"]), ryw_reads=len(reads), writes_acked=sum(
            st["acked"] for st in cpu["stats"]), write_signature=cpu["wcert"]["signature"][:16],
        session_signature=cpu["scert"]["signature"][:16], phase_s=time.perf_counter() - t_phase)


def pct(xs, p: float):
    """The p-quantile of `xs` (nearest rank below), None when empty."""
    xs = sorted(xs)
    return xs[int(p * (len(xs) - 1))] if xs else None


def _timed(obj, attr: str, into: list, wait) -> None:
    """Time every call of `obj.attr` (host clock around synced work) into
    `into`, by an attribute on the instance."""
    inner = getattr(obj, attr)

    def call(*a, **kw):
        wait()
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            wait()
            into.append((time.perf_counter() - t0) * 1e3)
    setattr(obj, attr, call)


def _observable(dense, state, rows: int):
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows

    obs = dense.value(fold_rows(dense, state, range(rows)))[0][0]
    return sorted((int(i), int(sc)) for (i, sc) in obs)


def run_pipeline(torch, dev: str, geo, *, overlapped: bool) -> dict:
    """One arm of 14b: PIPE_MEMBERS on FsTransport apply their replicas'
    ops (phase 12's) for PIPE_STEPS rounds, each round publishing and
    taking in their peers' windows — serially (`publish`, then
    `sweep_deltas`) or overlapped (the publish submitted to the pipeline's
    HostStage, the peers' windows fetched, decoded and expanded on its
    DeltaPrefetcher thread, `drain_into` on the round thread); then
    `close` and a serial tail until every member shows the sequential
    reference. Returns each member's round ms, the digests, the reference
    and the pipelines' counters."""
    import shutil
    import tempfile

    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.net.transport import FsTransport, GossipNode
    from antidote_ccrdt_tpu_torch.parallel.elastic import DeltaPublisher, owners, sweep_deltas
    from antidote_ccrdt_tpu_torch.parallel.overlap import OverlapPipeline
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    r, ids, b, br = geo
    on_card = torch.device(dev).type == "cuda"

    def wait():
        if on_card:
            sync()

    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=K, slots_per_id=M, device=dev)
    gen = GossipOps(r, ids, b, br, dev)
    members = list(PIPE_MEMBERS)
    own = owners(sorted(members), r)
    owned = {m: sorted(x for x, w in own.items() if w == m) for m in members}
    root = tempfile.mkdtemp(prefix="pipeline-")
    transports = {m: FsTransport(root, m) for m in members}
    try:
        nodes = {m: GossipNode(transports[m]) for m in members}
        states = {m: dense.init(r, 1) for m in members}
        cursors = {m: {} for m in members}
        pubs = {m: DeltaPublisher(nodes[m], dense, name="topk_rmv", full_every=4) for m in members}
        ovls = ({m: OverlapPipeline(nodes[m], dense, states[m], start_thread=True) for m in members}
                if overlapped else {})
        round_ms = []
        t_arm = time.perf_counter()
        for step in range(PIPE_STEPS):
            for m in members:
                wait()
                t0 = time.perf_counter()
                states[m] = dense.apply_ops(states[m], gen.batch(step, owned[m]), collect_dominated=False)[0]
                if overlapped:
                    ovls[m].submit(pubs[m].publish, states[m])
                    states[m] = ovls[m].drain_into(states[m])
                else:
                    pubs[m].publish(states[m])
                    states[m], _ = sweep_deltas(nodes[m], dense, states[m], cursors[m])
                wait()
                round_ms.append((time.perf_counter() - t0) * 1e3)
        steps_s = time.perf_counter() - t_arm
        for m in ovls:
            states[m] = ovls[m].close(states[m])
            cursors[m] = dict(ovls[m].cursors)
        ref_state = dense.init(r, 1)
        for step in range(PIPE_STEPS):
            ref_state = dense.apply_ops(ref_state, gen.batch(step, range(r)), collect_dominated=False)[0]
        ref = _observable(dense, ref_state, r)
        del ref_state
        tail = 0
        for tail in range(1, PIPE_TAIL + 1):
            if all(_observable(dense, states[m], r) == ref for m in members):
                break
            for m in members:
                pubs[m].publish(states[m])
            for m in members:
                states[m], _ = sweep_deltas(nodes[m], dense, states[m], cursors[m])
        counters = {}
        for m in members:
            for k, v in nodes[m].metrics.snapshot()["counters"].items():
                if k.startswith(("overlap.", "ingest.")):
                    counters[k] = counters.get(k, 0.0) + v
        return dict(round_ms=round_ms, steps_s=steps_s, digests={m: _observable(dense, states[m], r)
                                                                 for m in members},
                    ref=ref, tail_rounds=tail, counters=counters)
    finally:
        for t in transports.values():
            t.close()
        shutil.rmtree(root, ignore_errors=True)


class WorkingSetOps:
    """scripts/working_set_demo.py's ``gen_ops`` at a given width: replica
    x's adds at a step come from ``default_rng(seed 1 000 003 + 9 100
    (step + 1) + x)`` (B ids Zipf(2.2) over the id space, scores in
    [1, 500), dc = x mod D, ts = step B + j + 1); no removals (the demo's
    add-only stream); the rows of replicas not owned are padding."""

    def __init__(self, r: int, ids: int, b: int, br: int, dev: str, seed: int = WS_SEED):
        self.r, self.ids, self.b, self.br, self.dev, self.seed = r, ids, b, br, dev, seed

    def batch(self, step: int, owned):
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        r, b, br = self.r, self.b, self.br
        cols = dict(
            add_key=np.zeros((r, b), np.int32), add_id=np.zeros((r, b), np.int32),
            add_score=np.zeros((r, b), np.int32), add_dc=np.zeros((r, b), np.int32),
            add_ts=np.zeros((r, b), np.int32), rmv_key=np.zeros((r, br), np.int32),
            rmv_id=np.full((r, br), -1, np.int32), rmv_vc=np.zeros((r, br, r), np.int32),
        )
        access = []
        for x in sorted(owned):
            rng = np.random.default_rng(self.seed * 1_000_003 + 9_100 * (step + 1) + x)
            ids = ((rng.zipf(WS_ZIPF, size=b) - 1) % self.ids).astype(np.int32)
            cols["add_id"][x], cols["add_score"][x] = ids, rng.integers(1, 500, b)
            cols["add_dc"][x] = x % r
            cols["add_ts"][x] = step * b + np.arange(b) + 1
            access.append(ids)
        acc = np.concatenate(access) if access else np.zeros(0, np.int32)
        return convert.from_numpy(TopkRmvOps, cols, self.dev), acc


def run_working_set(torch, dev: str, geo, *, paged: bool = True, spans: bool = False, held=None,
                    launches=None, timing=None) -> dict:
    """scripts/working_set_demo.py's ``run_drill`` on the port at width `geo`
    on `dev`: WS_MEMBERS on FsTransport, a `PartitionPager` a worker (its
    budget a tenth of the state) unless `paged` is false (the all-resident
    arm), the partition plane's publisher, partial anti-entropy and delta
    sweeps through the pager, `ensure_resident` before every apply.
    `held`: w0's kernel calls held against their plain versions;
    `timing` gets ms of every publish and sweep, and (paged) of every
    full_state and cold fold. Returns the demo's measurement dict."""
    import contextlib
    import shutil
    import tempfile

    import numpy as np

    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.core import pager as pg
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.core.batch_merge import tree_nbytes
    from antidote_ccrdt_tpu_torch.net.transport import FsTransport, GossipNode
    from antidote_ccrdt_tpu_torch.obs import spans as obs_spans
    from antidote_ccrdt_tpu_torch.parallel.elastic import (DeltaPublisher, PartialAntiEntropy, owners,
                                                           sweep_deltas)
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    r, ids, b, br = geo
    P = WS_P
    on_card = torch.device(dev).type == "cuda"

    def wait():
        if on_card:
            sync()

    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=K, slots_per_id=M, device=dev)
    gen = WorkingSetOps(r, ids, b, br, dev)
    members = list(WS_MEMBERS)
    own = owners(sorted(members), r)
    owned = {m: sorted(x for x, w in own.items() if w == m) for m in members}
    launches = launches or {}
    w0_launches = dict.fromkeys(launches, 0)
    out = {"pager": paged, "partitions": P}
    root = tempfile.mkdtemp(prefix="workset-")
    transports = {m: FsTransport(root, m) for m in members}
    try:
        stores = {m: GossipNode(transports[m]) for m in members}
        states = {m: dense.init(r, 1) for m in members}
        cursors = {m: {} for m in members}
        pagers = dict.fromkeys(members)
        if paged:
            for m in members:
                probe = pg.PartitionPager(dense, states[m], P=P, name="workset", metrics=stores[m].metrics)
                total = probe.meta_bytes + sum(probe.part_bytes.values())
                budget = max(1, total // 10)  # forced 10x overcommit
                pagers[m] = pg.PartitionPager(dense, states[m], P=P, name="workset", hbm_budget_bytes=budget,
                                              metrics=stores[m].metrics)
                out.update(state_bytes=total, hbm_budget_bytes=budget, state_over_budget_x=total / budget)
                if timing is not None:
                    _timed(pagers[m], "full_state", timing["full_state_ms"], wait)
                    _timed(pagers[m], "_fold_into_cold", timing["cold_fold_ms"], wait)
        pubs = {m: DeltaPublisher(stores[m], dense, name="topk_rmv", full_every=2, keep=8, partitions=P,
                                  pager=pagers[m]) for m in members}
        partials = {m: PartialAntiEntropy(stores[m], partitions=P, max_tries=12, pager=pagers[m])
                    for m in members}

        def as_w0(m, hold=None):
            """w0's work: its launches counted, and its kernel calls held
            against their plain versions into `hold` (its steps' hydrations
            and applies; its publishes and sweeps run the same joins)."""
            if m != "w0":
                return contextlib.nullcontext()
            return _counting(held_against_plain(torch, hold) if hold is not None else contextlib.nullcontext(),
                             launches, w0_launches)

        def digest_vec(m):
            if pagers[m] is not None:
                return pagers[m].digest_vector(states[m])
            return pt.state_digests(states[m], P)

        def round_of():
            for m in members:
                stores[m].heartbeat()
                wait()
                t0 = time.perf_counter()
                with as_w0(m):
                    pubs[m].publish(states[m])
                wait()
                if timing is not None:
                    timing["publish_ms"].append((time.perf_counter() - t0) * 1e3)
            time.sleep(0.05)
            for m in members:
                t0 = time.perf_counter()
                with as_w0(m):
                    states[m], _ = sweep_deltas(stores[m], dense, states[m], cursors[m], partial=partials[m],
                                                pager=pagers[m])
                wait()
                if timing is not None:
                    timing["sweep_ms"].append((time.perf_counter() - t0) * 1e3)

        span_cm = obs_spans.installed("workset", metrics=stores["w0"].metrics) if spans else contextlib.nullcontext()
        span_names = set()
        t_drill = time.perf_counter()
        with span_cm:
            deadline = time.time() + 10.0
            while any(len(stores[m].members()) < len(members) for m in members):
                for m in members:
                    stores[m].heartbeat()
                if time.time() > deadline:
                    raise AssertionError("the working-set drill's start barrier timed out")
                time.sleep(0.05)
            for step in range(WS_STEPS):
                for m in members:
                    ops, acc = gen.batch(step, owned[m])
                    with as_w0(m, held):
                        if pagers[m] is not None:
                            # Front door before device writes: hydrate the
                            # batch's partitions (billed per access).
                            states[m] = pagers[m].ensure_resident(states[m], pt.part_of(acc, P))
                        states[m] = dense.apply_ops(states[m], ops, collect_dominated=False)[0]
                if step == WS_WARM and paged:
                    for m in members:
                        pagers[m].hits = pagers[m].misses = 0
                round_of()
            agree = False
            for tail in range(WS_TAIL):
                vecs = [digest_vec(m) for m in members]
                if all(np.array_equal(vecs[0], v) for v in vecs[1:]):
                    agree = True
                    break
                round_of()
            out.update(converged=agree, tail_rounds=tail)
            if spans:
                span_names = {rec.get("name") for rec in obs_spans.drain() if rec.get("k") == "span"}
        wait()
        out["drill_s"] = time.perf_counter() - t_drill
        ref = dense.init(r, 1)
        for step in range(WS_STEPS):
            ref = dense.apply_ops(ref, gen.batch(step, range(r))[0], collect_dominated=False)[0]
        ref_vec = pt.state_digests(ref, P)
        ref_obs = _observable(dense, ref, r)
        del ref
        vec = digest_vec("w0")
        finals = {m: _observable(dense, pagers[m].full_state(states[m]) if pagers[m] is not None else states[m], r)
                  for m in members}
        out.update(digest_vector=[int(x) for x in vec], observable=finals["w0"],
                   matches_reference=bool(np.array_equal(vec, ref_vec)) and all(
                       f == ref_obs for f in finals.values()))
        counters = {}
        for m in members:
            for k, v in stores[m].metrics.counters.items():
                if k.startswith(("pager.", "net.psnap", "net.partition")):
                    counters[k] = counters.get(k, 0) + int(v)
        out["counters"] = dict(sorted(counters.items()))
        if paged:
            out["hit_rates"] = {m: pagers[m].hit_rate() for m in members}
            out["min_hit_rate"] = min(out["hit_rates"].values())
            out["miss_ms"] = [x for m in members for x in stores[m].metrics.snapshot()["latencies"].get(
                "pager.miss_ms", [])]
            out["resident_bytes"] = {m: pagers[m].resident_bytes() for m in members}
            out["host_tier_bytes"] = {m: pagers[m].host_bytes() for m in members}
            subs = [pagers[m]._cold for m in members if pagers[m]._cold is not None]
            out["cold_tier_bytes"] = {m: tree_nbytes(pagers[m]._cold) if pagers[m]._cold is not None else 0
                                      for m in members}
            out["cold_tier_pinned"] = all(x.is_pinned() for sub in subs for x in leaves(sub))
        out["span_names"] = sorted(n for n in span_names if n is not None)
        out["w0_launches"] = w0_launches
        return out
    finally:
        for t in transports.values():
            t.close()
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _counting(cm, launches: dict, into: dict):
    """`cm` open, and the launches of `launches`' wrappers inside it added
    to `into`."""
    before = {n: w.launches for n, w in launches.items()}
    with cm:
        yield
    for n, w in launches.items():
        into[n] += w.launches - before[n]


def check_working_set(out: dict, what: str) -> dict:
    """The demo's gates on a paged run; returns the counters it read."""
    c = out["counters"]
    checks = {
        "converged": bool(out["converged"]),
        "matches_sequential_reference": bool(out["matches_reference"]),
        "state_ge_10x_budget": out["state_over_budget_x"] >= WS_MIN_RATIO,
        "pager_paged": all(c.get(k, 0) > 0 for k in ("pager.evictions", "pager.hydrations", "pager.cold_folds")),
        "hit_rate_ge_min": out["min_hit_rate"] >= WS_MIN_HIT,
        "no_wasted_psnaps": c.get("net.psnap_wasted", 0) == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{what}: {failed} ({ {k: out.get(k) for k in ('min_hit_rate', 'tail_rounds')} }, "
                             f"{c})")
    return c


def phase_overlap_pager(torch, card: str, dev: str = "cuda", before_14c=None) -> dict:
    """Phase 14: the overlapped drill (14a), serial against overlapped
    rounds with live threads (14b), the overcommitted working set (14c);
    its reduced twin is `overlap_pager_reduced`, which main() runs beside
    phase 22's reap. `before_14c`, if given, is called as 14c begins.
    Returns the phase's K1c, K2 and K3 launches (14a-c at the main path's
    width)."""
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    wrappers = {"scatter_max_rows_copy": kernels.scatter_max_rows_copy, "delta_place": delta_place,
                "sort_slots": kernels.sort_slots}
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}

    def held_calls(held):
        return {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in wrappers}

    def peak_start():
        gc.collect()
        sync()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    t_phase = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0

    # 14a: the overlapped chaos drill.
    base = peak_start()
    held, timing = {}, {"drain_ms": []}
    t0 = time.perf_counter()
    out = run_gossip(torch, dev, (R, I, B, BR), held=held, launches=wrappers, timing=timing, overlap=True)
    drill_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    bad = {m: d for m, d in out["digests"].items() if d != out["ref"]}
    c = out["counters"]
    if not out["ref"] or bad or not out["covered"]:
        raise AssertionError(f"the overlapped drill: survivors {sorted(bad)} differ from the sequential reference "
                             f"after {out['tail_rounds']} tail rounds")
    if not (c.get("overlap.folds", 0) > 0 and c.get("overlap.dropped_deltas", 0) > 0) or c.get(
            "overlap.apply_errors", 0):
        raise AssertionError(f"the overlapped drill's pipeline counters: {c}")
    if held_calls(held) != out["m0_launches"] or not all(held_calls(held).values()) or any(
            v["max_abs_err"] for v in held.values()):
        raise AssertionError(f"m0 launched {out['m0_launches']}, held {held}")
    a_launches = {n: w.launches for n, w in wrappers.items()}
    require_launches(a_launches, wrappers, "the overlapped drill")
    state_bytes = sum(x.numel() * x.element_size() for x in leaves(out["states"]["m0"]))
    log("14a overlap", card=card, members=GOSSIP_MEMBERS, steps=GOSSIP_STEPS, replicas=R, ids=I, adds=B,
        removals=BR, depth=OVERLAP_DEPTH, drain_every=OVERLAP_DRAIN_EVERY, state_bytes=state_bytes,
        tail_rounds=out["tail_rounds"], survivors=sorted(out["digests"]), drill_s=drill_s,
        drain_ms_p50=pct(timing["drain_ms"], 0.5), drain_ms_p99=pct(timing["drain_ms"], 0.99),
        drains=len(timing["drain_ms"]), windows_per_fold=c["overlap.folded_windows"] / c["overlap.folds"],
        staged_bytes=c.get("ingest.staged_bytes", 0), pipeline={k: v for k, v in c.items() if k.startswith(
            ("overlap.", "ingest."))}, faults={k: c.get(k, 0) for k in (
                "net.sim_lost", "net.sim_duplicated", "net.sim_unreachable", "net.dead_events")},
        launches=a_launches, m0_launches=out["m0_launches"], held_against_plain=held, peak_mem_gb=peak_gb)
    del out
    gc.collect()

    # 14b: serial against overlapped rounds, live threads.
    arms = {}
    base = peak_start()
    for overlapped in (False, True):
        t0 = time.perf_counter()
        arms[overlapped] = run_pipeline(torch, dev, (R, I, B, BR), overlapped=overlapped)
        arms[overlapped]["arm_s"] = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    for arm in arms.values():
        if any(d != arm["ref"] for d in arm["digests"].values()):
            raise AssertionError(f"14b: an arm ended off the sequential reference after {arm['tail_rounds']} "
                                 f"tail rounds")
    if arms[False]["digests"] != arms[True]["digests"] or arms[True]["counters"].get("overlap.apply_errors", 0):
        raise AssertionError(f"14b: the serial and overlapped arms differ: {arms[True]['counters']}")
    b_launches = {n: w.launches - a_launches[n] for n, w in wrappers.items()}
    require_launches(b_launches, wrappers, "14b's rounds")
    log("14b pipeline", card=card, members=list(PIPE_MEMBERS), steps=PIPE_STEPS, replicas=R, ids=I, **{
        f"{name}_{k}": v for overlapped, name in ((False, "serial"), (True, "overlapped")) for k, v in (
            ("round_ms_p50", pct(arms[overlapped]["round_ms"], 0.5)),
            ("round_ms_p99", pct(arms[overlapped]["round_ms"], 0.99)),
            ("steps_s", arms[overlapped]["steps_s"]), ("arm_s", arms[overlapped]["arm_s"]),
            ("tail_rounds", arms[overlapped]["tail_rounds"]))},
        stalls=arms[True]["counters"].get("overlap.stalls", 0), host_tasks=arms[True]["counters"].get(
            "overlap.host_tasks", 0), pipeline=arms[True]["counters"], equal_digests=True, launches=b_launches,
        peak_mem_gb=peak_gb)
    del arms
    gc.collect()

    # 14c: the overcommitted working set, then its all-resident arm.
    if before_14c is not None:
        before_14c()
    base = peak_start()
    held, timing = {}, {"full_state_ms": [], "cold_fold_ms": [], "publish_ms": [], "sweep_ms": []}
    ws = run_working_set(torch, dev, (R, I, WS_B, WS_BR), spans=True, held=held, launches=wrappers,
                         timing=timing)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    wc = check_working_set(ws, "the working-set drill")
    if "round.pager_hydrate" not in ws["span_names"] or ws["cold_tier_pinned"] != (torch.device(dev).type == "cuda"):
        raise AssertionError(f"the working-set drill: spans {ws['span_names']}, pinned {ws['cold_tier_pinned']}")
    if not all(held_calls(held).values()) or any(v["max_abs_err"] for v in held.values()):
        raise AssertionError(f"w0's held calls: {held}")
    flat_timing = {"publish_ms": [], "sweep_ms": []}
    flat = run_working_set(torch, dev, (R, I, WS_B, WS_BR), paged=False, timing=flat_timing)
    if not flat["converged"] or flat["digest_vector"] != ws["digest_vector"] or \
            flat["observable"] != ws["observable"]:
        raise AssertionError("the working-set drill's all-resident arm differs from the paged arm")
    launches = {n: w.launches for n, w in wrappers.items()}
    c_launches = {n: launches[n] - a_launches[n] - b_launches[n] for n in wrappers}
    require_launches(c_launches, wrappers, "the working-set drill")
    log("14c working set", card=card, workers=list(WS_MEMBERS), steps=WS_STEPS, replicas=R, ids=I,
        adds=WS_B, partitions=WS_P, state_bytes=ws["state_bytes"], hbm_budget_bytes=ws["hbm_budget_bytes"],
        state_over_budget_x=ws["state_over_budget_x"], tail_rounds=ws["tail_rounds"], drill_s=ws["drill_s"],
        all_resident_drill_s=flat["drill_s"], publish_s=sum(timing["publish_ms"]) / 1e3,
        sweep_s=sum(timing["sweep_ms"]) / 1e3, publish_ms_p50=pct(timing["publish_ms"], 0.5),
        publish_ms_p99=pct(timing["publish_ms"], 0.99), sweep_ms_p50=pct(timing["sweep_ms"], 0.5),
        sweep_ms_p99=pct(timing["sweep_ms"], 0.99), all_resident_publish_s=sum(flat_timing["publish_ms"]) / 1e3,
        all_resident_sweep_s=sum(flat_timing["sweep_ms"]) / 1e3, hit_rates=ws["hit_rates"], miss_ms_p50=pct(ws["miss_ms"], 0.5),
        miss_ms_p99=pct(ws["miss_ms"], 0.99), hydrations_timed=len(ws["miss_ms"]),
        full_state_ms_p50=pct(timing["full_state_ms"], 0.5), full_state_ms_p99=pct(
            timing["full_state_ms"], 0.99), full_states=len(timing["full_state_ms"]),
        cold_fold_ms_p50=pct(timing["cold_fold_ms"], 0.5), cold_fold_ms_p99=pct(timing["cold_fold_ms"], 0.99),
        cold_folds_timed=len(timing["cold_fold_ms"]), resident_bytes=ws["resident_bytes"],
        host_tier_bytes=ws["host_tier_bytes"], cold_tier_bytes=ws["cold_tier_bytes"], cold_tier_pinned=ws["cold_tier_pinned"],
        counters=wc, hydrate_span_lit=True, all_resident_equal=True, launches=c_launches,
        w0_launches=ws["w0_launches"], held_against_plain=held, peak_mem_gb=peak_gb,
        phase_s=time.perf_counter() - t_phase)
    del ws, flat
    gc.collect()

    return launches


def overlap_pager_reduced(torch, card: str, dev: str = "cuda") -> None:
    """14a and 14c at reduced widths: the CPU's plain versions against the
    card's kernels, equal states, digests and counters. No wall clock
    gates it."""
    t_small = time.perf_counter()
    small = {d: run_gossip(torch, d, OVERLAP_SMALL, overlap=True) for d in ("cpu", dev)}
    cpu, on_card = small["cpu"], small[dev]
    if cpu["counters"] != on_card["counters"] or cpu["digests"] != on_card["digests"] or not all(
            _same(torch, cpu["states"][m], on_card["states"][m]) for m in cpu["states"]):
        raise AssertionError("the reduced overlapped drill differs between the CPU and the card")
    if not cpu["covered"] or any(d != cpu["ref"] for d in cpu["digests"].values()):
        raise AssertionError("the reduced overlapped drill missed the sequential reference")
    wsmall = {d: run_working_set(torch, d, WS_SMALL) for d in ("cpu", dev)}
    for d, o in wsmall.items():
        check_working_set(o, f"the reduced working-set drill on {d}")
    for key in ("digest_vector", "observable", "counters", "hit_rates", "state_bytes", "hbm_budget_bytes"):
        if wsmall["cpu"][key] != wsmall[dev][key]:
            raise AssertionError(f"the reduced working-set drill's {key} differ between the CPU and the card")
    log("14 reduced", card=card, overlap_geometry=dict(zip(("R", "I", "B", "Br"), OVERLAP_SMALL)),
        working_set_geometry=dict(zip(("R", "I", "B", "Br"), WS_SMALL)), equal_cpu_card=True,
        overlap_counters={k: v for k, v in cpu["counters"].items() if k.startswith("overlap.")},
        working_set_counters=wsmall["cpu"]["counters"], reduced_s=time.perf_counter() - t_small)


@contextlib.contextmanager
def frozen_wall_clock(at: float = 1_700_000_000.0):
    """The port's flight recorder and certifier read one fixed wall clock
    (their event and certificate stamps), for runs whose bytes are
    compared."""
    import types

    from antidote_ccrdt_tpu_torch.obs import audit, events as obs_events

    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    fake.time = lambda: at
    saved = [(mod, mod.time) for mod in (audit, obs_events)]
    try:
        for mod, _ in saved:
            mod.time = fake
        yield
    finally:
        for mod, real in saved:
            mod.time = real


def packed_groups(ops) -> list:
    """One `TopkRmvOps` batch as bridge/client.py's packed-columns input
    ((tag, counts, [columns]) with replica-major columns): every add, and
    every removal with the nonzero entries of its vc."""
    import numpy as np

    host = {k: getattr(ops, k).cpu().numpy() for k in (
        "add_key", "add_id", "add_score", "add_dc", "add_ts", "rmv_key", "rmv_id", "rmv_vc")}
    n_rep, n_add = host["add_key"].shape
    live = host["rmv_id"] >= 0
    vc = host["rmv_vc"][live]
    nz = vc > 0
    return [
        ("add", np.full(n_rep, n_add, np.int32),
         [host[k].ravel() for k in ("add_key", "add_id", "add_score", "add_dc", "add_ts")]),
        ("rmv", live.sum(1).astype(np.int32),
         [host["rmv_key"][live], host["rmv_id"][live], nz.sum(1).astype(np.int32),
          np.nonzero(nz)[1].astype(np.int32), vc[nz]]),
    ]


def fold_broadcast(torch, dense, state, rows: int):
    """The JAX bridge's `merge_all` for a JOIN engine, written out apart
    from the port's: rows folded pairwise (top half with bottom half, an
    odd last row carried), the fold broadcast to every row."""
    from antidote_ccrdt_tpu_torch.utils.tree import tree_map

    r = rows
    while r > 1:
        half = r // 2
        merged = dense.merge(tree_map(lambda x: x[:half], state), tree_map(lambda x: x[half:2 * half], state))
        if r % 2:
            merged = tree_map(lambda m, x: torch.cat([m, x[2 * half:r]]), merged, state)
        state, r = merged, half + r % 2
    return tree_map(lambda x: x[:1].expand((rows,) + tuple(x.shape[1:])).contiguous(), state)


def scalar_rate(address, seconds: float = 0.0, stop=None) -> dict:
    """benchmarks/bench_bridge_contention.py's scalar load: average `update`
    round trips on a connection of its own, for `seconds` or until `stop`
    is set."""
    from antidote_ccrdt_tpu_torch.bridge import BridgeClient
    from antidote_ccrdt_tpu_torch.core.etf import Atom

    with BridgeClient(*address) as c:
        h = c.new("average")
        n, t0 = 0, time.perf_counter()
        done = stop.is_set if stop is not None else (lambda: time.perf_counter() - t0 >= seconds)
        while not done():
            c.update(h, (Atom("add"), (1, 1)))
            n += 1
        dt = time.perf_counter() - t0
        if c.value(h) != 1.0:
            raise AssertionError("the scalar load's average is off")
    return {"round_trips": n, "seconds": dt, "per_s": n / dt}


def run_wire(torch, dev: str, geo, *, snapshots: bool = False, counts=None, held=None) -> dict:
    """Phase 15b: benchmarks/bench_all.py's bench_grid_wire mix through the
    port's BridgeServer on `dev` and a BridgeClient, at `geo` = (R, I, B):
    WIRE_CALLS calls of the tuple surface (and one grid_apply_extras call)
    and of the packed surface for the six grid types, packed multi calls of
    WIRE_MB batches, and one batch_merge of WIRE_BM_STATES scalar topk_rmv
    binaries of WIRE_BM_ADDS adds, equal to the port's direct
    ``batch_merge`` on `dev`. Every reply is
    kept; with `snapshots`, every grid's snapshot too, each restored into
    a second grid and equal to it. `counts` (a callable giving the
    kernels' launch counters) adds the batch_merge op's own launches;
    `held` runs that op once more under `held_against_plain` (the checks'
    own launches in `check_launches`)."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.bridge import BridgeClient, BridgeServer
    from antidote_ccrdt_tpu_torch.core import wire
    from antidote_ccrdt_tpu_torch.core.batch_merge import batch_merge
    from antidote_ccrdt_tpu_torch.core.etf import Atom

    Rw, Iw, Bw = geo
    calls, mb = WIRE_CALLS, WIRE_MB
    n_topk = min(10_000, Iw)
    rng = np.random.default_rng(5)
    out = {"rates": {}, "replies": [], "snapshots": {}}
    frontier = [dict() for _ in range(Rw)]

    def tr_batch():
        per = []
        for r in range(Rw):
            ops = []
            for j in range(Bw):
                d, i = int(rng.integers(0, Rw)), int(rng.integers(0, Iw))
                if j % 16 == 15:
                    ops.append((Atom("rmv"), 0, i, list(frontier[r].items())))
                else:
                    frontier[r][d] = frontier[r].get(d, 0) + 1
                    ops.append((Atom("add"), 0, i, int(rng.integers(1, 10**6)), d, frontier[r][d]))
            per.append(ops)
        return per

    def tk():
        return [[(Atom("add"), 0, int(rng.integers(0, n_topk)), int(rng.integers(1, 10**6))) for _ in range(Bw)]
                for _ in range(Rw)]

    def lb():
        return [[(Atom("add"), 0, int(rng.integers(0, Iw)), int(rng.integers(1, 10**6))) for _ in range(Bw - 16)]
                + [(Atom("ban"), 0, int(rng.integers(0, Iw))) for _ in range(16)] for _ in range(Rw)]

    def av():
        return [[(Atom("add"), int(rng.integers(0, 64)), int(rng.integers(-100, 100)), 1) for _ in range(Bw)]
                for _ in range(Rw)]

    def wc():
        return [[(Atom("add"), 0, int(t)) for t in (rng.zipf(1.1, size=Bw) - 1) % 4096] for _ in range(Rw)]

    def seq_ts(dcs, base):
        order = np.argsort(dcs, kind="stable")
        sorted_dcs = dcs[order]
        grp = np.r_[True, sorted_dcs[1:] != sorted_dcs[:-1]]
        c = np.arange(dcs.size) - np.maximum.accumulate(np.where(grp, np.arange(dcs.size), 0))
        ts = np.empty_like(c)
        ts[order] = c + 1
        return ts + base[dcs]

    Ba, nr = Bw - Bw // 16, Bw // 16
    frontier_base = np.zeros((Rw, Rw), np.int64)

    def tr_packed():
        dc = rng.integers(0, Rw, Rw * Ba).astype(np.int32)
        ts_parts = []
        for r in range(Rw):
            dcr = dc[r * Ba:(r + 1) * Ba]
            ts_parts.append(seq_ts(dcr, frontier_base[r]))
            frontier_base[r] += np.bincount(dcr, minlength=Rw)
        return [
            ("add", np.full(Rw, Ba, np.int32), [
                np.zeros(Rw * Ba, np.int32), rng.integers(0, Iw, Rw * Ba).astype(np.int32),
                rng.integers(1, 10**6, Rw * Ba).astype(np.int32), dc, np.concatenate(ts_parts).astype(np.int32)]),
            ("rmv", np.full(Rw, nr, np.int32), [
                np.zeros(Rw * nr, np.int32), rng.integers(0, Iw, Rw * nr).astype(np.int32),
                np.full(Rw * nr, Rw, np.int32), np.tile(np.arange(Rw, dtype=np.int32), Rw * nr),
                rng.integers(1, 50, Rw * nr * Rw).astype(np.int32)]),
        ]

    counts_b = np.full(Rw, Bw, np.int32)
    packed_simple = {
        "w_tk": lambda: [("add", counts_b, [np.zeros(Rw * Bw, np.int32),
                                             rng.integers(0, n_topk, Rw * Bw).astype(np.int32),
                                             rng.integers(1, 10**6, Rw * Bw).astype(np.int32)])],
        "w_lb": lambda: [("add", np.full(Rw, Bw - 16, np.int32), [
            np.zeros(Rw * (Bw - 16), np.int32), rng.integers(0, Iw, Rw * (Bw - 16)).astype(np.int32),
            rng.integers(1, 10**6, Rw * (Bw - 16)).astype(np.int32)]),
            ("ban", np.full(Rw, 16, np.int32), [np.zeros(Rw * 16, np.int32),
                                                 rng.integers(0, Iw, Rw * 16).astype(np.int32)])],
        "w_av": lambda: [("add", counts_b, [rng.integers(0, 64, Rw * Bw).astype(np.int32),
                                             rng.integers(-100, 100, Rw * Bw).astype(np.int32),
                                             np.ones(Rw * Bw, np.int32)])],
        "w_wc": lambda: [("add", counts_b, [np.zeros(Rw * Bw, np.int32),
                                             ((rng.zipf(1.1, size=Rw * Bw) - 1) % 4096).astype(np.int32)])],
        "w_wd": lambda: [("add", counts_b, [np.zeros(Rw * Bw, np.int32),
                                             ((rng.zipf(1.1, size=Rw * Bw) - 1) % 4096).astype(np.int32)])],
    }

    def n_tuple(batch):
        return sum(len(x) for x in batch)

    def n_packed(groups):
        return sum(int(np.asarray(c).sum()) for _, c, _ in groups)

    with BridgeServer(device=dev) as srv, BridgeClient(*srv.address, timeout=600) as client:
        def timed(line, fn, gname, batches, n_of):
            out["replies"].append(fn(gname, batches[0]))  # one untimed call
            t0 = time.perf_counter()
            for b in batches[1:]:
                out["replies"].append(fn(gname, b))
            out["rates"][line] = sum(n_of(b) for b in batches[1:]) / (time.perf_counter() - t0)

        grids = (("w_tr", "topk_rmv", dict(n_ids=Iw, n_dcs=Rw, size=100)), ("w_tk", "topk", dict(n_ids=n_topk, size=100)),
                 ("w_lb", "leaderboard", dict(n_players=Iw, size=100)), ("w_av", "average", dict(n_keys=64)),
                 ("w_wc", "wordcount", dict(n_buckets=4096)), ("w_wd", "worddocumentcount", dict(n_buckets=4096)))
        for gname, tname, geom in grids:
            client.grid_new(gname, tname, n_replicas=Rw, **geom)
        timed("topk_rmv tuple", client.grid_apply, "w_tr", [tr_batch() for _ in range(calls + 1)], n_tuple)
        t0 = time.perf_counter()
        extras_batch = tr_batch()
        out["replies"].append(client.grid_apply_extras("w_tr", extras_batch))
        out["rates"]["topk_rmv tuple extras"] = n_tuple(extras_batch) / (time.perf_counter() - t0)
        for gname, tname, make in (("w_tk", "topk", tk), ("w_lb", "leaderboard", lb), ("w_av", "average", av),
                                   ("w_wc", "wordcount", wc), ("w_wd", "worddocumentcount", wc)):
            timed(f"{tname} tuple", client.grid_apply, gname, [make() for _ in range(calls + 1)], n_tuple)
        timed("topk_rmv packed", client.grid_apply_packed, "w_tr", [tr_packed() for _ in range(calls + 1)], n_packed)
        timed(f"topk_rmv packed multi x{mb}", client.grid_apply_packed_multi, "w_tr",
              [[tr_packed() for _ in range(mb)] for _ in range(calls + 1)],
              lambda batches: sum(n_packed(g) for g in batches))
        for gname, tname, _ in grids[1:]:
            timed(f"{tname} packed", client.grid_apply_packed, gname,
                  [packed_simple[gname]() for _ in range(calls + 1)], n_packed)

        n_states, n_adds = WIRE_BM_STATES, WIRE_BM_ADDS
        scalar = registry.scalar("topk_rmv")
        blobs = []
        for r in range(n_states):
            st = scalar.new(100)
            for j in range(n_adds):
                st, _ = scalar.update(("add", (int(rng.integers(0, 1000)), int(rng.integers(1, 10**6)), (r, j + 1))), st)
            blobs.append(wire.to_reference_binary("topk_rmv", st))
        before = counts() if counts else None
        t0 = time.perf_counter()
        h = client.batch_merge("topk_rmv", blobs)
        out["batch_merge_ms"] = (time.perf_counter() - t0) * 1e3
        if counts:
            after = counts()
            out["bm_launches"] = {n: after[n] - before[n] for n in after}
        out["batch_merge_blob"] = client.to_binary(h)
        # The checks' launches (the direct batch_merge, the held op) are
        # counted apart, for the caller to leave out.
        before = counts() if counts else None
        direct = wire.to_reference_binary("topk_rmv", batch_merge("topk_rmv", blobs, device=dev))
        if out["batch_merge_blob"] != direct:
            raise AssertionError("the batch_merge op's state differs from the direct batch_merge")
        if held is not None:
            with held_against_plain(torch, held):
                h2 = client.batch_merge("topk_rmv", blobs)
            if client.to_binary(h2) != direct:
                raise AssertionError("the held batch_merge op's state differs from the direct batch_merge")
        if counts:
            after = counts()
            out["check_launches"] = {n: after[n] - before[n] for n in after}
        if snapshots:
            for gname, _, _ in grids:
                blob = client.grid_to_binary(gname)
                client.grid_from_binary(gname + "_copy", blob)
                if client.grid_to_binary(gname + "_copy") != blob:
                    raise AssertionError(f"{gname}'s snapshot did not survive its round trip over the wire")
                out["snapshots"][gname] = blob
        out["grid_observe"] = [client.grid_observe(g, 0, 0) for g, _, _ in grids]
    return out


def phase_bridge(torch, card: str, dev: str = "cuda") -> dict:
    """Phase 15: the bridge server and client. (a) phase 4's geometry as
    one grid over TCP, fed phase 4's stream by grid_apply_packed_multi,
    then an extras round, grid_merge_all, grid_observe and the snapshot
    round trip, equal to the engine driven directly on the same planes;
    the same calls again with every K1c, K2 and K3 call held against its
    plain version while (c) a second connection's scalar round trips are
    counted; (b) bench_grid_wire's mix, and its calls at WIRE_SMALL equal
    on the CPU and the card. Returns the phase's launches by kernel line
    (the held runs' left out)."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.bridge import BridgeClient, BridgeServer
    from antidote_ccrdt_tpu_torch.bridge import protocol as P
    from antidote_ccrdt_tpu_torch.core import etf, serial
    from antidote_ccrdt_tpu_torch.core.etf import Atom
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    on_card = torch.device(dev).type == "cuda"
    wait = sync if on_card else (lambda: None)
    k3 = kernels.sort_slots
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}

    def counts():
        return {"scatter_max_rows": kernels.scatter_max_rows_.launches,
                "scatter_max_rows_copy": kernels.scatter_max_rows_copy.launches,
                "delta_place": delta_place.launches, "sort_slots": k3.launches,
                "sort_slots_wide": k3.wide_launches, "sort_slots_block": k3.block_launches,
                "sort_slots_global": k3.global_launches}

    def since(before):
        now = counts()
        return {n: now[n] - before[n] for n in now}

    t_phase = time.perf_counter()
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    ops = [gen.next_batch(B, BR) for _ in range(BRIDGE_CALLS * BRIDGE_MB + 1)]  # set-up
    groups = [packed_groups(o) for o in ops]
    calls = [groups[k * BRIDGE_MB:(k + 1) * BRIDGE_MB] for k in range(BRIDGE_CALLS)]
    # The column bytes of each multi call: its frame is these and a few
    # hundred bytes of ETF around them.
    call_bytes = [sum(a.nbytes for g in batch for _, c, cols in g for a in (c, *cols)) for batch in calls]
    if max(call_bytes) >= P.MAX_FRAME:
        raise AssertionError(f"a multi call of {max(call_bytes)} bytes is past the frame limit {P.MAX_FRAME}")
    geom = dict(n_ids=I, n_dcs=R, size=K, slots_per_id=M)
    ops_per_call = [sum(int(c.sum()) for g in batch for _, c, _ in g) for batch in calls]

    # (c), idle: scalar round trips on a server with nothing else to do.
    with BridgeServer(device=dev) as srv, BridgeClient(*srv.address, timeout=600) as client:
        idle = scalar_rate(srv.address, CONTENTION_S)

        # (a): the timed run.
        gc.collect()
        wait()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        mem_base = torch.cuda.memory_allocated() if on_card else 0
        before = counts()
        client.grid_new("ns", "topk_rmv", n_replicas=R, n_keys=1, **geom)
        grid = srv._grids[b"ns"]
        split = {k: [] for k in ("parse", "build", "pack_ids", "stack", "upload", "apply", "readback")}
        for key, attr in (("parse", "_parse_packed"), ("build", "_build_topk_rmv_arrays"), ("pack_ids", "_pack_ids"),
                          ("stack", "_stack"), ("upload", "_upload"), ("apply", "_scan"), ("readback", "_readback")):
            _timed(grid, attr, split[key], wait)
        call_ms, call_split, dominated = [], [], []
        for batch in calls:
            mark = {k: len(v) for k, v in split.items()}
            t0 = time.perf_counter()
            dominated.append(client.grid_apply_packed_multi("ns", batch))
            call_ms.append((time.perf_counter() - t0) * 1e3)
            call_split.append({k: sum(v[mark[k]:]) for k, v in split.items()})
        t0 = time.perf_counter()
        extras = client.grid_apply_extras_packed("ns", groups[-1])
        extras_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        client.grid_merge_all("ns")
        wait()
        merge_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        observed = client.grid_observe("ns", 0, 0)
        observe_ms = (time.perf_counter() - t0) * 1e3
        peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9 if on_card else 0.0
        a_launches = since(before)
        for n in ("scatter_max_rows_copy", "delta_place", "sort_slots"):
            if on_card and a_launches[n] < BRIDGE_CALLS * BRIDGE_MB + 1:
                raise AssertionError(f"15a launched {n} {a_launches[n]} times for {len(ops)} apply rounds")

        # The snapshot round trip, through the server's own dispatch: the
        # snapshot is past the frame limit, so no socket carries it.
        t0 = time.perf_counter()
        reply = srv._dispatch(P.call(1, (Atom("grid_to_binary"), b"ns")))
        snap_ms = (time.perf_counter() - t0) * 1e3
        blob = P.parse_reply(reply)[2]
        snap_bytes = len(blob)
        for req, op in ((2, (Atom("grid_from_binary"), b"ns2", blob)), (3, (Atom("grid_to_binary"), b"ns2"))):
            rid, ok, got = P.parse_reply(srv._dispatch(P.call(req, op)))
            if not ok:
                raise AssertionError(f"{op[0]}: {got}")
        if got != blob:
            raise AssertionError("the north-star grid's snapshot did not survive its round trip")
        del got

        # The engine driven directly on the same planes, then the same fold.
        dense = registry.make_dense("topk_rmv", **geom, device=dev)
        state = dense.init(R, 1)
        direct_dominated = []
        for k, o in enumerate(ops[:-1]):
            state, ex = dense.apply_ops(state, o)
            direct_dominated.append(int(ex.dominated.sum()))
        state, ex = dense.apply_ops(state, ops[-1], collect_promotions=True)
        want_rmv, want_add = int(ex.dominated.sum()), int(ex.promoted.valid.sum())
        del ex
        state = fold_broadcast(torch, dense, state, R)
        want = etf.encode(({Atom(k): v for k, v in grid.geometry.items()}, serial.dumps_dense("topk_rmv", state)))
        if blob != want:
            raise AssertionError("the wire-driven grid's snapshot differs from the engine driven directly")
        del want
        sums = [sum(direct_dominated[k * BRIDGE_MB:(k + 1) * BRIDGE_MB]) for k in range(BRIDGE_CALLS)]
        got_rmv, got_add = ({tag: int(c.sum()) for tag, c, _ in extras}.get(t, 0) for t in ("rmv", "add"))
        cell = dense.value(tree_map(lambda x: x[:1, :1], state))[0][0]
        if dominated != sums or (got_rmv, got_add) != (want_rmv, want_add) or observed != cell or len(observed) != K:
            raise AssertionError(f"15a's replies differ from the direct engine: dominated {dominated} / {sums}, "
                                 f"extras {(got_rmv, got_add)} / {(want_rmv, want_add)}, observe {len(observed)}")
        del state, dense, blob
        srv._grids.pop(b"ns2")
        gc.collect()

        # (a) again with every kernel call held, while (c)'s scalar load
        # runs on another connection.
        before = counts()
        held, load, stop = {}, {}, threading.Event()
        client.grid_new("held", "topk_rmv", n_replicas=R, n_keys=1, **geom)
        loader = threading.Thread(target=lambda: load.update(scalar_rate(srv.address, stop=stop)))
        with held_against_plain(torch, held):
            loader.start()
            t0 = time.perf_counter()
            for batch in calls:
                client.grid_apply_packed_multi("held", batch)
            held_window_s = time.perf_counter() - t0
            stop.set()
            loader.join()
            client.grid_apply_extras_packed("held", groups[-1])
            client.grid_merge_all("held")
        held_launches = since(before)
        held_calls = {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in kernel_of}
        if on_card and (held_calls != {n: held_launches[n] for n in kernel_of} or any(
                v["max_abs_err"] for v in held.values())):
            raise AssertionError(f"15a's held run launched {held_launches}, held {held}")
        if not all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(
                leaves(srv._grids[b"held"].state), leaves(srv._grids[b"ns"].state))):
            raise AssertionError("15a's held run ended in another state")
        ratio = load["per_s"] / idle["per_s"]
        if ratio < CONTENTION_MIN:
            raise AssertionError(f"15c: scalar round trips fell to {ratio:.3f} of the idle rate under grid applies")
    n_ops = sum(ops_per_call)
    wire_s = sum(call_ms) / 1e3
    log("15a bridge", card=card, replicas=R, ids=I, adds=B, removals=BR, calls=BRIDGE_CALLS,
        batches_per_call=BRIDGE_MB, call_bytes=call_bytes, frame_limit=P.MAX_FRAME, ops_per_call=ops_per_call,
        call_ms=call_ms, call_split_ms=call_split, extras_ms=extras_ms, merge_all_ms=merge_ms,
        observe_ms=observe_ms, snapshot_ms=snap_ms, snapshot_bytes=snap_bytes,
        wire_ops_per_s=n_ops / wire_s, main_path_merges_per_s=MAIN_PATH_RATES.get("merges_per_s"),
        main_path_apply_merges_per_s=MAIN_PATH_RATES.get("apply_merges_per_s"), dominated=dominated,
        extras_rmv=got_rmv, extras_add=got_add, equal_direct_engine=True, snapshot_round_trip=True,
        launches=a_launches, held_against_plain=held, peak_mem_gb=peak_gb)
    log("15c contention", card=card, idle_per_s=idle["per_s"], under_grid_applies_per_s=load["per_s"],
        ratio=ratio, min_ratio=CONTENTION_MIN, idle_round_trips=idle["round_trips"],
        loaded_round_trips=load["round_trips"], grid_window_s=held_window_s)

    # (b): bench_grid_wire's mix at its own shapes, then its calls at
    # WIRE_SMALL on the CPU and the card.
    before = counts()
    bm_held = {}
    t0 = time.perf_counter()
    full = run_wire(torch, dev, (WIRE_R, I, WIRE_B), counts=counts, held=bm_held)
    mix_s = time.perf_counter() - t0
    b_launches = {n: v - full["check_launches"][n] for n, v in since(before).items()}
    bm = full["bm_launches"]
    if any(v["max_abs_err"] for v in bm_held.values()):
        raise AssertionError(f"15b's batch_merge op disagrees with the plain K3: {bm_held}")
    if on_card and (b_launches["sort_slots_wide"] < 1 or bm["sort_slots"] < 1):
        raise AssertionError(f"15b's batch_merge op launched {bm}")
    # Narrow K3 launches of 9 to 16 candidates a row (the half-warp path):
    # the batch_merge op's converter call at W = M (its fold's held calls
    # run at W = 2M) and any fold call that narrow.
    fold_w = {}
    for k, v in bm_held.items():
        w = int(k.split()[1][2:])
        fold_w[w] = fold_w.get(w, 0) + v["calls"]
    converter = bm["sort_slots"] + bm["sort_slots_wide"] - sum(fold_w.values())
    half_warp = (converter if 9 <= max(fold_w, default=0) // 2 <= 16 else 0) + sum(
        n for w, n in fold_w.items() if 9 <= w <= 16) if on_card else 0
    small = {d: run_wire(torch, d, WIRE_SMALL, snapshots=True) for d in ("cpu", dev)}
    for key in ("replies", "snapshots", "batch_merge_blob", "grid_observe"):
        if small["cpu"][key] != small[dev][key]:
            raise AssertionError(f"15b's {key} at {WIRE_SMALL} differ between the CPU and the card")
    log("15b wire mix", card=card, replicas=WIRE_R, ops_per_call=WIRE_B, calls=WIRE_CALLS, multi_batches=WIRE_MB,
        ops_per_s=full["rates"], batch_merge_states=WIRE_BM_STATES, batch_merge_ms=full["batch_merge_ms"],
        batch_merge_launches=bm, batch_merge_half_warp=half_warp, held_against_plain=bm_held, launches=b_launches,
        mix_s=mix_s,
        small_geometry=dict(zip(("R", "I", "B"), WIRE_SMALL)), equal_cpu_card=True,
        phase_s=time.perf_counter() - t_phase)
    total = {n: a_launches[n] + b_launches[n] for n in a_launches}
    return {"scatter_max_rows": total["scatter_max_rows"], "scatter_max_rows_copy": total["scatter_max_rows_copy"],
            "delta_place": total["delta_place"], "sort_slots": total["sort_slots"] - half_warp,
            "sort_slots_9_16": half_warp, "sort_slots_wide": total["sort_slots_wide"],
            "sort_slots_block": total["sort_slots_block"], "sort_slots_global": total["sort_slots_global"]}


def _since(before: dict) -> dict:
    """The launches of the mesh and multi-process planes' kernels since
    `before` (a `launch_counts()`)."""
    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import launch_counts

    now = launch_counts()
    return {n: now[n] - before[n] for n in now}


def _same(torch, a, b) -> bool:
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _dc_block_joins(dense, state, n_dc: int):
    """Each row r replaced by the join of its dc block (the rows
    congruent to r mod R / n_dc), built with `dense.merge` as
    tests/test_mesh.py builds it: block 0 first, then the others in
    order."""
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    rows = leaves(state)[0].shape[0] // n_dc
    acc = tree_map(lambda x: x[:rows], state)
    for j in range(1, n_dc):
        acc = dense.merge(acc, tree_map(lambda x, j=j: x[j * rows:(j + 1) * rows], state))
    return tree_map(lambda x: x.repeat((n_dc,) + (1,) * (x.dim() - 1)), acc)


def run_mesh_reduce(torch, dev: str, geo, *, held=None, checks: bool = True) -> dict:
    """16a at width `geo` = (R, I, B, Br) on `dev`: phase 4's engine, each
    row fed its own batches for MESH_ROUNDS rounds, placed on a (2, 4)
    plan over eight logical devices of `dev`, then `ici_reduce`. Gates:
    each reduced row is the join of its dc block; the fold's observable
    is unchanged; a second reduce changes no bit; the leaves stay tagged;
    a reduce with every K3 call held against the plain K3 (`held`) ends in
    the same state; the stitched digests, every shard's psnap blobs and
    `save_mesh_checkpoint`'s files equal the unsharded producers'; the
    plan over the real device list is (1, 1) with an identity reduce, and
    `install_from_env` is None there. Times on the host clock, synced."""
    import tempfile

    from antidote_ccrdt_tpu_torch import mesh as mesh_mod
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.core import serial
    from antidote_ccrdt_tpu_torch.harness.checkpoint import save_mesh_checkpoint, save_partitioned_checkpoint
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.mesh import MeshPlan
    from antidote_ccrdt_tpu_torch.mesh import gossip as mesh_gossip
    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import launch_counts
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    r, ids, b, br = geo
    on_card = torch.device(dev).type == "cuda"
    wait = sync if on_card else (lambda: None)
    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=K, slots_per_id=M, device=dev)
    gen = TopkRmvEffectGen(Workload(r, ids, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    state = dense.init(r, 1)
    for _ in range(MESH_ROUNDS):
        state = dense.apply_ops(state, gen.next_batch(b, br), collect_dominated=False)[0]
    plan = MeshPlan.build(n_dc=MESH_DC, n_key=MESH_KEY, partitions=MESH_PARTS, devices=[dev] * (MESH_DC * MESH_KEY))
    placed = plan.place(state)
    gc.collect()
    wait()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated() if on_card else 0
    m = Metrics()
    before = launch_counts()
    t0 = time.perf_counter()
    red = mesh_mod.ici_reduce(dense, plan, placed, metrics=m)
    wait()
    reduce_ms = (time.perf_counter() - t0) * 1e3
    red2 = mesh_mod.ici_reduce(dense, plan, red)
    wait()
    launches = _since(before)
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9 if on_card else 0.0
    half = r // MESH_DC
    t0 = time.perf_counter()
    one_merge = dense.merge(tree_map(lambda x: x[:half], state), tree_map(lambda x: x[half:], state))
    wait()
    merge_ms = (time.perf_counter() - t0) * 1e3
    del one_merge
    out = dict(state=state, reduced=red, reduce_ms=reduce_ms, merge_ms=merge_ms, peak_gb=peak_gb,
               launches=launches, counters=dict(m.counters))
    if not checks:
        return out
    if not _same(torch, red, _dc_block_joins(dense, state, MESH_DC)):
        raise AssertionError("16a: a reduced row is not the join of its dc block")
    if _same(torch, red, state):
        raise AssertionError("16a: the reduce changed no row (the rows did not diverge)")

    def observable(st):
        return dense.value(fold_rows(dense, st, range(r)))[0][0]

    if observable(red) != observable(state):
        raise AssertionError("16a: the reduce changed the fold's observable")
    if not _same(torch, red2, red):
        raise AssertionError("16a: a second reduce changed the state")
    for st in (red, red2):
        if not all(getattr(x, "sharding", None) == sh for x, sh in zip(leaves(st), leaves(plan.shardings(st)))):
            raise AssertionError("16a: a reduced leaf lost its sharding")
    if held is not None:
        with held_against_plain(torch, held):
            again = mesh_mod.ici_reduce(dense, plan, placed)
        if not _same(torch, again, red):
            raise AssertionError("16a: the held reduce ended in another state")
    t0 = time.perf_counter()
    vec = mesh_gossip.sharded_digest_vector(state, plan)
    out["digest_s"] = time.perf_counter() - t0
    if not (vec == pt.state_digests(state, plan.P)).all():
        raise AssertionError("16a: the stitched digest vector differs from state_digests")
    t0 = time.perf_counter()
    n_blobs = 0
    for shard in range(plan.n_key):
        for part, blob in mesh_gossip.shard_psnap_blobs("topk_rmv", state, 7, dense, plan, shard):
            want = pt.encode_psnap_blob(7, part, serial.dumps_dense(
                "topk_rmv_psnap", pt.restrict_psnap(dense, state, part, plan.P)))
            if blob != want:
                raise AssertionError(f"16a: shard {shard}'s psnap blob of partition {part} differs")
            n_blobs += 1
    out["psnap_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["checkpoint_bytes"] = save_mesh_checkpoint(os.path.join(tmp, "mesh"), "topk_rmv", state, dense, 4, plan)
        out["checkpoint_s"] = time.perf_counter() - t0
        save_partitioned_checkpoint(os.path.join(tmp, "whole"), "topk_rmv", state, dense, 4, partitions=plan.P)
        names = sorted(os.listdir(os.path.join(tmp, "whole")))
        if names != sorted(os.listdir(os.path.join(tmp, "mesh"))):
            raise AssertionError("16a: the mesh checkpoint wrote other files")
        for fn in names:
            with open(os.path.join(tmp, "whole", fn), "rb") as f, open(os.path.join(tmp, "mesh", fn), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"16a: checkpoint file {fn} differs between the mesh and whole writers")
    one = MeshPlan.build(partitions=plan.P)
    if (one.n_dc, one.n_key) != (1, 1) or not _same(torch, mesh_mod.ici_reduce(dense, one, state), state):
        raise AssertionError(f"16a: the plan over {one.describe()['devices']} real device(s) is not an identity")
    if mesh_mod.install_from_env(dense, override=True) is not None:
        raise AssertionError("16a: install_from_env armed the mesh on one device")
    out.update(psnap_blobs=n_blobs, checkpoint_files=len(names), real_plan=one.describe())
    return out


def run_id_sharded(torch, dev: str, geo, *, held=None) -> dict:
    """16b at width `geo` = (R, I, B, Br) on `dev`: IdShardedTopkRmv on a
    (2, 4) mesh of logical devices of `dev` (I / 4 ids a shard) and the
    unsharded engine, both fed phase 4's global-id batches for
    MESH_ID_ROUNDS rounds. Gates: `observe` equals the unsharded observe
    leaf for leaf; the tables equal the unsharded tables (vc the max and
    lossy the or of the shard axis); `merge_replicas`' rows are the dc
    block joins of the unsharded state; with `held`, round 0 applied again
    with every K1c, K2 and K3 call held against its plain version ends in
    the same state (launches not counted). Times on the host clock, synced."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.parallel.dist import make_mesh
    from antidote_ccrdt_tpu_torch.parallel.sharded import make_id_sharded_topk_rmv
    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import launch_counts
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync

    r, ids, b, br = geo
    on_card = torch.device(dev).type == "cuda"
    wait = sync if on_card else (lambda: None)
    mesh = make_mesh(MESH_DC, MESH_KEY, devices=[dev] * (MESH_DC * MESH_KEY))
    eng = make_id_sharded_topk_rmv(mesh, ids, r, size=K, slots_per_id=M, n_replicas=r)
    ref = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=K, slots_per_id=M, device=dev)
    gen = TopkRmvEffectGen(Workload(r, ids, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    batches = [gen.next_batch(b, br) for _ in range(MESH_ID_ROUNDS)]  # set-up
    st, rs = eng.init(), ref.init(r, 1)
    apply_ms, ref_ms, launches = [], [], {n: 0 for n in launch_counts()}
    gc.collect()
    wait()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated() if on_card else 0
    for k, ops in enumerate(batches):
        before = launch_counts()
        t0 = time.perf_counter()
        nxt = eng.apply_ops(st, ops)
        wait()
        apply_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {n: launches[n] + v for n, v in _since(before).items()}
        if k == 0 and held is not None:
            with held_against_plain(torch, held):
                again = eng.apply_ops(st, ops)
            if not _same(torch, again, nxt):
                raise AssertionError("16b: the held round ended in another state")
            del again
        st = nxt
        t0 = time.perf_counter()
        rs = ref.apply_ops(rs, ops, collect_dominated=False)[0]
        wait()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    obs = eng.observe(st)
    wait()
    observe_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref_obs = ref.observe(rs)
    wait()
    ref_observe_ms = (time.perf_counter() - t0) * 1e3
    if not _same(torch, obs, ref_obs):
        raise AssertionError("16b: the id-sharded observe differs from the unsharded observe")

    def tables(s, sharded=True):
        """The leaves compared: vc and lossy of the sharded state taken
        over its shard axis (max and or)."""
        side = (s.vc.amax(1), s.lossy.any(1)) if sharded else (s.vc, s.lossy)
        return (s.slot_score, s.slot_dc, s.slot_ts, s.rmv_vc) + side

    if not _same(torch, tables(st), tables(rs, False)):
        raise AssertionError("16b: the id-sharded tables differ from the unsharded tables")
    before = launch_counts()
    t0 = time.perf_counter()
    merged = eng.merge_replicas(st)
    wait()
    merge_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: launches[n] + v for n, v in _since(before).items()}
    peak_gb = (torch.cuda.max_memory_allocated() - mem_base) / 1e9 if on_card else 0.0
    if not _same(torch, tables(merged), tables(_dc_block_joins(ref, rs, MESH_DC), False)):
        raise AssertionError("16b: a merged row is not the join of its dc block")
    return dict(state=st, merged=merged, observed=obs, apply_ms=apply_ms, unsharded_apply_ms=ref_ms,
                observe_ms=observe_ms, unsharded_observe_ms=ref_observe_ms, merge_replicas_ms=merge_ms,
                launches=launches, peak_gb=peak_gb, valid_observed=int(obs.valid.sum()))


def run_mesh_chaos(torch, dev: str, seed: int = MESH_CHAOS_SEED) -> dict:
    """tests/test_mesh.py's ``run_mesh_chaos(seed)`` on the port on `dev`:
    4 members on SimNet, each state placed on one (2, 4) plan over eight
    logical devices of `dev`, an ICI reduce at every publish boundary,
    per-shard anchors (``DeltaPublisher(mesh_plan=)``) and mesh-grouped
    partial repairs (``PartialAntiEntropy(mesh_plan=)``), a partition,
    a heal and a crash, then a fault-free tail until every survivor's
    digest is the sequential reference's. Returns the digests, the
    reference and the fleet's counters."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows
    from antidote_ccrdt_tpu_torch.mesh import MeshPlan
    from antidote_ccrdt_tpu_torch.mesh import reduce as mesh_reduce
    from antidote_ccrdt_tpu_torch.net.sim import SimNet
    from antidote_ccrdt_tpu_torch.net.transport import GossipNode
    from antidote_ccrdt_tpu_torch.parallel.elastic import (DeltaPublisher, PartialAntiEntropy, my_replicas,
                                                           sweep_deltas)

    r, ids, b, br = MESH_CHAOS_GEO
    steps, members, dt, timeout, P = 10, 4, 0.1, 0.35, MESH_PARTS
    dense = registry.make_dense("topk_rmv", n_ids=ids, n_dcs=r, size=MESH_CHAOS_K, slots_per_id=MESH_CHAOS_M,
                                device=dev)
    gen = GossipOps(r, ids, b, br, dev, zipf=False)

    def apply(state, step, owned):
        return dense.apply_ops(state, gen.batch(step, owned), collect_dominated=False)[0]

    def adopt(state, gained, upto):
        for g in sorted(gained):
            for step in range(upto):
                state = apply(state, step, [g])
        return state

    def digest(state):
        obs = dense.value(fold_rows(dense, state, range(r)))[0][0]
        return sorted((int(i), int(sc)) for (i, sc) in obs)

    ref = dense.init(r, 1)
    for step in range(steps):
        ref = apply(ref, step, range(r))
    ref = digest(ref)
    net = SimNet(seed=seed, latency=(0.001, 0.02), loss=0.03, dup=0.03)
    plan = MeshPlan.build(n_dc=2, n_key=4, partitions=P, devices=[dev] * 8)
    names = [f"m{i}" for i in range(members)]
    nodes = {m: GossipNode(net.join(m)) for m in names}
    states = {m: plan.place(dense.init(r, 1)) for m in names}
    cursors = {m: {} for m in names}
    pubs = {m: DeltaPublisher(nodes[m], dense, name="topk_rmv", full_every=4, keep=4, partitions=P,
                              mesh_plan=plan) for m in names}
    partials = {m: PartialAntiEntropy(nodes[m], partitions=P, max_tries=6, mesh_plan=plan) for m in names}
    owned = {m: set() for m in names}
    crashed = set()

    def publish_and_sweep(m):
        states[m] = mesh_reduce.try_ici_reduce(dense, plan, states[m], metrics=nodes[m].metrics)
        pubs[m].publish(states[m])
        states[m], _ = sweep_deltas(nodes[m], dense, states[m], cursors[m], partial=partials[m])

    def own(m, upto):
        node = nodes[m]
        node.heartbeat()
        now_owned = owned[m] | set(my_replicas(node, r, timeout))
        gained = now_owned - owned[m]
        if gained:
            states[m] = adopt(states[m], gained, upto)
        owned[m] = now_owned

    for _ in range(3):
        for m in names:
            nodes[m].heartbeat()
        net.advance(dt)
    for step in range(steps):
        if step == 3:
            net.partition({"m0", "m1"}, {"m2", "m3"})
        if step == 6:
            net.heal()
        if step == 7:
            net.crash("m3")
            crashed.add("m3")
        for m in names:
            if m in crashed:
                continue
            own(m, step)
            states[m] = apply(states[m], step, sorted(owned[m]))
            if step % 2 == 0:
                publish_and_sweep(m)
        net.advance(dt)
    net.loss = net.dup = 0.0
    live = [m for m in names if m not in crashed]
    for _ in range(40):
        for m in live:
            own(m, steps)
            publish_and_sweep(m)
        net.advance(dt)
        if all(digest(states[m]) == ref for m in live):
            break
    return dict(digests={m: digest(states[m]) for m in live}, ref=ref, counters=dict(net.metrics.counters),
                states={m: states[m] for m in live})


def run_sharded_small(torch, dev: str) -> dict:
    """tests/test_parallel.py's sharded leaderboard (seed 0), topk (seed 0)
    and vocab-sharded wordcount (seed 0) on a (1, 4, 2) mesh of logical
    devices of `dev`, 3 rounds each and the reconciliation: the states and
    reads, for comparison between devices."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert
    from antidote_ccrdt_tpu_torch.models.leaderboard import LeaderboardOps
    from antidote_ccrdt_tpu_torch.models.topk import TopkOps
    from antidote_ccrdt_tpu_torch.models.wordcount import WordcountOps
    from antidote_ccrdt_tpu_torch.parallel import sharded as sh

    mesh = sh.make_mesh2(1, 4, 2, devices=[dev] * 8)
    out = {}
    rng = np.random.default_rng(0)
    lb = sh.make_id_sharded_leaderboard(mesh, n_players_global=64, size=4)
    st = lb.init()
    for _ in range(3):
        ones, zeros = np.ones((4, 32), bool), np.zeros((4, 32), np.int32)
        cols = dict(add_key=zeros, add_id=rng.integers(0, 64, (4, 32)).astype(np.int32),
                    add_score=rng.integers(1, 500, (4, 32)).astype(np.int32), add_valid=ones,
                    ban_key=np.zeros((4, 6), np.int32), ban_id=rng.integers(0, 64, (4, 6)).astype(np.int32),
                    ban_valid=np.ones((4, 6), bool))
        st = lb.apply_ops(st, convert.from_numpy(LeaderboardOps, cols, dev))
    st = lb.merge_replicas(st)
    out["leaderboard"] = (st, lb.observe(st))
    rng = np.random.default_rng(0)
    tk = sh.make_id_sharded_topk(mesh, n_ids_global=64, size=4)
    st = tk.init()
    for _ in range(3):
        cols = dict(key=np.zeros((4, 24), np.int32), id=rng.integers(0, 64, (4, 24)).astype(np.int32),
                    score=rng.integers(1, 900, (4, 24)).astype(np.int32), valid=np.ones((4, 24), bool))
        st = tk.apply_ops(st, convert.from_numpy(TopkOps, cols, dev))
    st = tk.merge_replicas(st)
    out["topk"] = (st, tk.observe(st))
    rng = np.random.default_rng(0)
    wc = sh.make_vocab_sharded_wordcount(mesh, n_buckets_global=64)
    st = wc.init()
    for _ in range(3):
        tok = rng.integers(0, 64, (4, 32)).astype(np.int32)
        tok[:, :3] = -1
        tok[0, 3] = 64 + 5
        st = wc.apply_ops(st, convert.from_numpy(WordcountOps, dict(key=np.zeros((4, 32), np.int32), token=tok), dev))
    out["wordcount"] = (st, wc.global_counts(st))
    return out


def phase_mesh(torch, card: str, dev: str = "cuda") -> dict:
    """Phase 16: the single-process mesh plane. (a) phase 4's engine on a
    (2, 4) plan over eight logical devices of the card, the dc all-reduce
    and the plane's artifacts (`run_mesh_reduce`); (b) IdShardedTopkRmv at
    the main path's width against the unsharded engine (`run_id_sharded`);
    (c) tests/test_mesh.py's chaos drill and tests/test_parallel.py's
    sharded engines at their own shapes, equal on the CPU and the card.
    Every K1c, K2 and K3 call of one reduce and one id-sharded round is
    held against its plain version. Returns the launches of 16a's two
    reduces and 16b's rounds and merge (the held runs' left out)."""
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    on_card = torch.device(dev).type == "cuda"
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}

    def held_calls(held):
        return {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in kernel_of}

    t_phase = time.perf_counter()
    held_a = {}
    a = run_mesh_reduce(torch, dev, (R, I, B, BR), held=held_a)
    launches = a["launches"]
    if on_card and (a["launches"]["sort_slots"] < MESH_KEY * MESH_DC or any(v["max_abs_err"] for v in held_a.values())
                    or held_calls(held_a)["sort_slots"] != MESH_KEY * MESH_DC):
        raise AssertionError(f"16a launched {a['launches']}, held {held_a}")
    log("16 mesh", card=card, replicas=R, ids=I, rounds=MESH_ROUNDS, mesh=dict(dc=MESH_DC, key=MESH_KEY),
        partitions=MESH_PARTS, reduce_ms=a["reduce_ms"], unsharded_merge_ms=a["merge_ms"],
        digest_s=a["digest_s"], psnap_s=a["psnap_s"], psnap_blobs=a["psnap_blobs"], checkpoint_s=a["checkpoint_s"],
        checkpoint_bytes=a["checkpoint_bytes"], checkpoint_files=a["checkpoint_files"], peak_mem_gb=a["peak_gb"],
        reduce_counters=a["counters"], real_plan=a["real_plan"], launches=a["launches"], held_against_plain=held_a,
        rows_are_dc_block_joins=True, observable_unchanged=True, idempotent=True, leaves_tagged=True,
        digests_psnaps_checkpoint_equal=True, phase_s=time.perf_counter() - t_phase)
    del a
    gc.collect()

    t_b = time.perf_counter()
    held_b = {}
    b = run_id_sharded(torch, dev, (R, I, B, BR), held=held_b)
    blocks = MESH_DC * MESH_KEY
    if on_card and (any(b["launches"][n] < blocks * MESH_ID_ROUNDS for n in kernel_of)
                    or any(v["max_abs_err"] for v in held_b.values())
                    or held_calls(held_b) != {n: blocks for n in kernel_of}):
        raise AssertionError(f"16b launched {b['launches']}, held {held_b}")
    log("16 id-sharded", card=card, replicas=R, ids=I, ids_per_shard=I // MESH_KEY, rounds=MESH_ID_ROUNDS,
        apply_ms=b["apply_ms"], unsharded_apply_ms=b["unsharded_apply_ms"], observe_ms=b["observe_ms"],
        unsharded_observe_ms=b["unsharded_observe_ms"], merge_replicas_ms=b["merge_replicas_ms"],
        valid_observed=b["valid_observed"], peak_mem_gb=b["peak_gb"], launches=b["launches"],
        held_against_plain=held_b, observe_equal=True, tables_equal=True, merged_rows_are_dc_block_joins=True,
        phase_s=time.perf_counter() - t_b)
    launches = {n: v + b["launches"][n] for n, v in launches.items()}
    del b
    gc.collect()

    t_c = time.perf_counter()
    chaos = {d: run_mesh_chaos(torch, d) for d in ("cpu", dev)}
    for d, o in chaos.items():
        c = o["counters"]
        if any(dg != o["ref"] for dg in o["digests"].values()) or not o["ref"]:
            raise AssertionError(f"16c: the mesh chaos drill on {d} missed the sequential reference")
        if c.get("mesh.ici_reduces", 0) <= 0 or c.get("mesh.cross_slice_fetches", 0) <= 0 or c.get(
                "net.psnap_wasted", 0) != 0:
            raise AssertionError(f"16c: the mesh chaos drill's counters on {d}: {c}")
    if chaos["cpu"]["digests"] != chaos[dev]["digests"] or chaos["cpu"]["counters"] != chaos[dev]["counters"] or not all(
            _same(torch, chaos["cpu"]["states"][m], chaos[dev]["states"][m]) for m in chaos["cpu"]["states"]):
        raise AssertionError("16c: the mesh chaos drill differs between the CPU and the card")
    small = {d: run_sharded_small(torch, d) for d in ("cpu", dev)}
    for name in small["cpu"]:
        if not all(_same(torch, x, y) for x, y in zip(small["cpu"][name], small[dev][name])):
            raise AssertionError(f"16c: the sharded {name} differs between the CPU and the card")
    c = chaos["cpu"]["counters"]
    log("16 reduced", card=card, chaos_geometry=dict(zip(("R", "I", "B", "Br"), MESH_CHAOS_GEO)),
        chaos_seed=MESH_CHAOS_SEED, members=sorted(chaos["cpu"]["digests"]),
        mesh_counters={k: v for k, v in c.items() if k.startswith("mesh.")},
        psnap_wasted=c.get("net.psnap_wasted", 0), sharded_engines=sorted(small["cpu"]), equal_cpu_card=True,
        reduced_s=time.perf_counter() - t_c, phase_s=time.perf_counter() - t_phase)
    return launches


# Every kernel line: its source and the TPU kernel it replaces.
SOURCES = {
    "scatter_max_rows": ("antidote_ccrdt_tpu_torch/csrc/scatter_max_rows.cu",
                         "antidote_ccrdt_tpu/ops/pallas_kernels.py:254"),
    "scatter_max_rows_copy": ("antidote_ccrdt_tpu_torch/csrc/scatter_max_rows.cu",
                              "antidote_ccrdt_tpu/ops/pallas_kernels.py:332"),
    "delta_place": ("antidote_ccrdt_tpu_torch/csrc/delta_place.cu",
                    "antidote_ccrdt_tpu/ops/delta_place.py:136"),
    "sort_slots": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                   "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
    "sort_slots_9_16": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                        "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
    "sort_slots_wide": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                        "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
    "sort_slots_block": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                         "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
    "sort_slots_global": ("antidote_ccrdt_tpu_torch/csrc/sort_slots.cu",
                          "antidote_ccrdt_tpu/ops/pallas_kernels.py:150"),
}


def run_multihost_world(dev: str, nproc: int, local: int, shape: str, tmp: str, tag: str, *,
                        backend: str = "gloo", ckpt: bool = False):
    """A world of `nproc` multihost_demo workers on `dev` (each `local`
    logical devices, `shape`), killed after MULTIHOST_TIMEOUT_S: every
    worker's report and, for the small shape, its reconciled block. Fails
    unless every worker exits 0 and prints MULTIHOST-OK."""
    import numpy as np

    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import run_world

    def args(pid):
        return (["--device", dev, "--backend", backend, "--local", str(local), "--shape", shape,
                 "--report", os.path.join(tmp, f"{tag}-w{pid}.json")]
                + (["--ckpt", os.path.join(tmp, f"{tag}-ckpt")] if ckpt else []))

    got = run_world(nproc, args, timeout_s=MULTIHOST_TIMEOUT_S, env=WORKER_ENV)
    reports, blocks = [], []
    for pid, (rc, out) in enumerate(got):
        if rc != 0 or f"MULTIHOST-OK {pid}" not in out:
            raise AssertionError(f"17: worker {pid} of world {tag} exited {rc}:\n{out[-6000:]}")
        path = os.path.join(tmp, f"{tag}-w{pid}.json")
        with open(path) as f:
            reports.append(json.load(f))
        blocks.append(dict(np.load(path + ".npz")) if shape == "small" else None)
    return reports, blocks


def mesh2_reduce(dense, state, mesh):
    """PR 13's single-process path: ``parallel.sharded
    .hierarchical_all_reduce`` of `state`'s replica rows laid out over
    `mesh`'s (dcn, dc) axes, one replica a logical device."""
    from antidote_ccrdt_tpu_torch.parallel import dist, sharded
    from antidote_ccrdt_tpu_torch.utils.tree import tree_map

    n_dcn, n_dc = mesh.shape["dcn"], mesh.shape["dc"]

    def merge(x, y):  # blocks [1, 1, NK, ...]: one replica row each
        out = dense.merge(tree_map(lambda a: a[0], x), tree_map(lambda a: a[0], y))
        return tree_map(lambda a: a.unsqueeze(0), out)

    grid = tree_map(lambda a: a.view((n_dcn, n_dc) + tuple(a.shape[1:])), state)
    spec = tree_map(lambda _a: dist.P("dcn", "dc"), grid)
    out = dist.shard_map(lambda g: sharded.hierarchical_all_reduce(g, merge, mesh), mesh, (spec,), spec)(grid)
    return tree_map(lambda a: a.reshape((n_dcn * n_dc,) + tuple(a.shape[2:])), out)


def _rows_only(ops, rows):
    """`ops` with every replica outside `rows` padded out (no adds, no
    removals)."""
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

    keep = ops.add_ts.new_zeros(ops.add_ts.shape[0], dtype=bool)
    keep[list(rows)] = True
    return TopkRmvOps(ops.add_key, ops.add_id, ops.add_score, ops.add_dc, ops.add_ts * keep[:, None],
                      ops.rmv_key, ops.rmv_id.where(keep[:, None], -1), ops.rmv_vc)


def run_sites(torch, dev: str, root: str) -> dict:
    """17c: tests/test_orbax_gossip.py's two sites at the main path's
    width on `dev`: each state on a (SITE_DCS[i], 1) mesh of logical
    devices, site A applying phase 4's round for replicas [0, R/2), site B
    for [R/2, R); both publish (DCP) and sweep each other; then A applies a
    second round and publishes it, B sweeps it with cursors, and again with
    nothing new. Gates: one merge a sweep, equal values after each
    exchange, each state tagged with its own site's sharding, the cursor
    sweep skipping the unchanged peer. Times on the host clock, synced."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.harness.orbax_ckpt import dir_bytes
    from antidote_ccrdt_tpu_torch.parallel import dist
    from antidote_ccrdt_tpu_torch.parallel.orbax_gossip import OrbaxGossip
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    wait = sync if torch.device(dev).type == "cuda" else (lambda: None)
    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=R, size=K, slots_per_id=M, device=dev)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.2, score_max=100_000, seed=7), device=dev)
    first, second = gen.next_batch(B, BR), gen.next_batch(B, BR)  # set-up
    shardings = [dist.NamedSharding(dist.make_mesh(n, 1, devices=[dev] * n), dist.P("dc", "key")) for n in SITE_DCS]

    def place(state, sh):
        return tree_map(lambda a: dist.device_put(a, sh), state)

    def tagged(state, sh):
        return all(getattr(a, "sharding", None) == sh for a in leaves(state))

    def timed(fn, *a):
        wait()
        t0 = time.perf_counter()
        out = fn(*a)
        wait()
        return out, time.perf_counter() - t0

    half = R // 2
    sa = place(dense.apply_ops(dense.init(R, 1), _rows_only(first, range(half)), collect_dominated=False)[0],
               shardings[0])
    sb = place(dense.apply_ops(dense.init(R, 1), _rows_only(first, range(half, R)), collect_dominated=False)[0],
               shardings[1])
    out = {}
    with OrbaxGossip(root, "site-a") as ga, OrbaxGossip(root, "site-b") as gb:
        _, out["publish_a_s"] = timed(ga.publish, sa, 1)
        _, out["publish_b_s"] = timed(gb.publish, sb, 1)
        out["publish_bytes"] = dir_bytes(os.path.join(root, "ckpt-site-a", "1"))
        if set(ga.snapshot_members()) != {"site-a", "site-b"}:
            raise AssertionError(f"17c: members {ga.snapshot_members()}")
        (sa2, n_a), out["sweep_a_s"] = timed(ga.sweep, dense, sa)
        (sb2, n_b), out["sweep_b_s"] = timed(gb.sweep, dense, sb)
        if (n_a, n_b) != (1, 1) or dense.value(sa2) != dense.value(sb2):
            raise AssertionError(f"17c: the first exchange merged {n_a}, {n_b} or left the sites apart")
        if not (tagged(sa2, shardings[0]) and tagged(sb2, shardings[1])):
            raise AssertionError("17c: a swept state left its site's layout")
        sa3 = place(dense.apply_ops(sa2, _rows_only(second, range(half)), collect_dominated=False)[0], shardings[0])
        _, out["publish_a2_s"] = timed(ga.publish, sa3, 2)
        cursors: dict = {}
        (sb3, n1), out["sweep_b2_s"] = timed(gb.sweep, dense, sb2, cursors)
        if n1 != 1 or dense.value(sb3) != dense.value(sa3) or cursors != {"site-a": 2}:
            raise AssertionError(f"17c: the second publish was not seen ({n1}, {cursors})")
        (sb4, n2), out["cursor_sweep_s"] = timed(gb.sweep, dense, sb3, cursors)
        if n2 != 0 or not _same(torch, sb4, sb3):
            raise AssertionError("17c: a cursor sweep of an unchanged peer merged")
        out["steps_a"] = ga._mgr.all_steps()
    out["valid_observed"] = sum(len(v) for row in dense.value(sb3) for v in row)
    return out


def run_worlds(dev: str, root: str) -> dict:
    """Phase 17's worlds, all at once (only processes: no kernel runs in
    this process): 17a's MULTIHOST_PROCS workers at the main path's width
    on `dev`, their DCP checkpoint saved under `root`, and 17b's worlds
    (the JAX test's, on the CPU, on `dev` and as one nccl process; on the
    CPU a one-process gloo world for the nccl one). Returns 17a's reports
    and seconds, 17b's worlds, their reports and blocks, and `root`."""
    from concurrent.futures import ThreadPoolExecutor

    on_card = str(dev).startswith("cuda")
    worlds = {"cpu": ("cpu", 2, 4, "gloo")}
    worlds.update({"card": (dev, 2, 4, "gloo"), "nccl": (dev, 1, 8, "nccl")} if on_card else
                  {"one": ("cpu", 1, 8, "gloo")})

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(worlds) + 1) as pool:
        f_a = pool.submit(timed, run_multihost_world, dev, MULTIHOST_PROCS, MULTIHOST_LOCAL,
                          f"{I},{B},{BR},{M},{K}", root, "a", ckpt=True)
        futs = {name: pool.submit(run_multihost_world, d, n, loc, "small", root, f"b-{name}", backend=be)
                for name, (d, n, loc, be) in worlds.items()}
        small = {name: f.result() for name, f in futs.items()}
        (reports, _), world_s = f_a.result()
    return dict(reports=reports, world_s=world_s, worlds=worlds, small=small, worlds_s=time.perf_counter() - t0,
                root=root)


def phase_multihost(torch, card: str, worlds: dict, dev: str = "cuda") -> dict:
    """Phase 17: the multi-process plane. (a) MULTIHOST_PROCS workers on
    the card reconcile one round of phase 4's stream and save it with DCP;
    the checkpoint, restored whole onto another layout, must equal PR 13's
    single-process hierarchical reduce over (MULTIHOST_PROCS,
    MULTIHOST_LOCAL) logical devices leaf for leaf, and its observable the
    sequential fold's; (b) the JAX test's world on the CPU, on the card and
    as one nccl process, equal; (c) `run_sites`. (a) and (b)'s worlds are
    `worlds`, `run_worlds`' (main() runs them beside an earlier phase). The reference's apply and reduce run again with every K1c, K2
    and K3 call held against its plain version. Returns the path's
    launches for every kernel line: the workers' (17a and 17b's card
    worlds) and 17c's sites'; the reference's and the held runs' are left
    out. Each 17a worker must launch K1c, K2 and K3."""
    import tempfile

    import numpy as np

    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.harness.orbax_ckpt import DenseCheckpointManager
    from antidote_ccrdt_tpu_torch.parallel import dist
    from antidote_ccrdt_tpu_torch.parallel.sharded import make_mesh2
    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import (STREAM_SCORE_MAX, STREAM_SEED, STREAM_ZIPF,
                                                                 launch_counts)
    from antidote_ccrdt_tpu_torch.utils.benchtime import sync
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    on_card = torch.device(dev).type == "cuda"
    wait = sync if on_card else (lambda: None)
    t_phase = time.perf_counter()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()  # the workers share the card
    r, local = MULTIHOST_PROCS * MULTIHOST_LOCAL, MULTIHOST_LOCAL
    launches = {n: 0 for n in SOURCES}

    def add(got):
        for n, v in got.items():
            launches[n] += v

    with tempfile.TemporaryDirectory() as tmp:
        # 17a: the world at the main path's width (and 17b's worlds).
        reports, world_s, ckpt_root = worlds["reports"], worlds["world_s"], worlds["root"]
        for rep in reports:
            add(rep["launches"])
        idle = [(rep["pid"], n) for rep in reports for n, v in rep["launches"].items() if v < 1]
        if on_card and idle:
            raise AssertionError(f"17a: a worker launched no kernel of (pid, kernel) {idle}")
        dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=r, size=K, slots_per_id=M, device=dev)
        workload = Workload(r, I, zipf_a=STREAM_ZIPF, score_max=STREAM_SCORE_MAX, seed=STREAM_SEED)
        ops = TopkRmvEffectGen(workload, device=dev).next_batch(B, BR)
        with dist.logical_devices([dev] * r):
            mesh = make_mesh2(MULTIHOST_PROCS, local)
        before = launch_counts()
        wait()
        t0 = time.perf_counter()
        applied = dense.apply_ops(dense.init(r, 1), ops, collect_dominated=False)[0]
        wait()
        ref_apply_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ref = mesh2_reduce(dense, applied, mesh)
        wait()
        ref_reduce_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        one_merge = dense.merge(tree_map(lambda a: a[:local], applied), tree_map(lambda a: a[local:], applied))
        wait()
        merge_ms = (time.perf_counter() - t0) * 1e3
        del one_merge
        ref_launches = _since(before)  # another path's: not the phase's count
        other = dist.NamedSharding(dist.make_mesh(SITE_DCS[0], 1, devices=[dev] * SITE_DCS[0]), dist.P("dc", "key"))
        like = tree_map(lambda a: dist.ShapeDtypeStruct(a.shape, a.dtype, sharding=other), applied)
        t0 = time.perf_counter()
        with DenseCheckpointManager(os.path.join(ckpt_root, "a-ckpt")) as mgr:
            restored = mgr.restore(like)
        wait()
        restore_s = time.perf_counter() - t0
        if not _same(torch, restored, ref):
            raise AssertionError("17a: the world's checkpoint differs from the single-process hierarchical reduce")
        if not all(getattr(a, "sharding", None) == other for a in leaves(restored)):
            raise AssertionError("17a: a restored leaf is not in the layout asked for")
        fold_obs = dense.value(fold_rows(dense, applied, range(r)))[0][0]
        if dense.value(tree_map(lambda a: a[:1], restored))[0][0] != fold_obs or not fold_obs:
            raise AssertionError("17a: the reconciled observable differs from the sequential fold's")
        held = {}
        with held_against_plain(torch, held):
            again = dense.apply_ops(dense.init(local, 1), tree_map(lambda a: a[:local], ops), collect_dominated=False)[0]
            if not _same(torch, again, tree_map(lambda a: a[:local], applied)):
                raise AssertionError("17a: the held apply of process 0's rows ended in another state")
            if not _same(torch, mesh2_reduce(dense, applied, mesh), ref):
                raise AssertionError("17a: the held reduce ended in another state")
        del again, restored, ref
        if {k.split()[0] for k in held} != {"K1c", "K2", "K3"} or any(v["max_abs_err"] for v in held.values()):
            raise AssertionError(f"17a: the held calls were not K1c, K2 and K3, each equal to its plain version: {held}")
        keys = ("apply_ms", "dc_ms", "dcn_exchange_ms", "dcn_bytes", "dcn_ms", "reconcile_ms", "save_s",
                "save_bytes", "peak_gb", "launches")
        log("17 multihost", card=card, workers=MULTIHOST_PROCS, backend="gloo", local_devices=local, replicas=r,
            ids=I, adds=B, removals=BR, slots=M, k=K, world_s=world_s,
            per_worker=[{k: rep[k] for k in keys} for rep in reports], reference_apply_ms=ref_apply_ms,
            reference_hierarchical_reduce_ms=ref_reduce_ms, unsharded_merge_of_halves_ms=merge_ms,
            reference_launches=ref_launches,
            parent_restore_s=restore_s, held_against_plain=held, restored_equals_single_process=True,
            observable_equals_fold=True, valid_observed=len(fold_obs))
        del applied, ops, dense
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # 17b: the JAX test's world on the CPU, on the card, and one nccl process.
        small, worlds_def = worlds["small"], worlds["worlds"]
        whole = {name: {p: np.concatenate([blk[p] for blk in blocks]) for p in blocks[0]}
                 for name, (_reps, blocks) in small.items()}
        for name in worlds_def:
            if name != "cpu" and not all((whole[name][p] == whole["cpu"][p]).all() and
                                         whole[name][p].dtype == whole["cpu"][p].dtype for p in whole["cpu"]):
                raise AssertionError(f"17b: the {name} world differs from the CPU world")
        for name, (reps, _blocks) in small.items():
            if worlds_def[name][0] != "cpu":
                for rep in reps:
                    add(rep["launches"])
                    if any(v < 1 for v in rep["launches"].values()):
                        raise AssertionError(f"17b: worker {rep['pid']} of the {name} world launched {rep['launches']}")
        log("17 reduced", card=card, worlds={n: dict(device=d, processes=k, local_devices=loc, backend=be)
                                             for n, (d, k, loc, be) in worlds_def.items()},
            reconcile_ms={n: [rep["reconcile_ms"] for rep in reps] for n, (reps, _b) in small.items()},
            equal_across_worlds=True, worlds_s=worlds["worlds_s"])

        # 17c: cross-site gossip at the main path's width.
        t_c = time.perf_counter()
        before = launch_counts()
        sites = run_sites(torch, dev, os.path.join(tmp, "sites"))
        got = _since(before)
        add(got)
        if on_card and any(v < 1 for v in got.values()):
            raise AssertionError(f"17c launched {got}")
        log("17 site gossip", card=card, replicas=R, ids=I, site_dcs=list(SITE_DCS), **sites, launches=got,
            converged=True, second_publish_seen=True, cursor_skipped=True, sites_s=time.perf_counter() - t_c,
            phase_s=time.perf_counter() - t_phase)
    return launches


def _worker_env(extra=None) -> dict:
    """The spawned workers' environment: this process's (or WORKER_ENV),
    the repository on the path, one CPU thread a worker, then `extra`."""
    env = dict(os.environ if WORKER_ENV is None else WORKER_ENV)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra or {})
    return env


def run_procs(cmds: dict, root: str, timeout_s: float, env=None) -> dict:
    """Start one process a name of `cmds` (argument lists after ``python``,
    run from the repository root, each in a session of its own, with the
    further environment `env`), and wait for all: {name: dict(rc, out,
    spawn_t, exit_t)} on the wall clock. A fleet that outlives `timeout_s`
    is killed, every process group of it, and raises: each group gets
    SIGTERM and TERM_GRACE_S to end (a supervisor whose workers run in
    sessions of their own then kills them), then SIGKILL."""
    import signal

    env = _worker_env(env)
    logs = {n: open(os.path.join(root, f"proc-{n}.log"), "w+") for n in cmds}
    procs, got = {}, {}

    def wait(n, p):
        p.wait()
        got[n]["exit_t"] = time.time()

    threads = []
    try:
        for n, cmd in cmds.items():
            got[n] = dict(spawn_t=time.time())
            procs[n] = subprocess.Popen([sys.executable, *cmd], stdout=logs[n], stderr=subprocess.STDOUT, cwd=ROOT,
                                        env=env, start_new_session=True)
            threads.append(threading.Thread(target=wait, args=(n, procs[n]), daemon=True))
            threads[-1].start()
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(max(0.1, deadline - time.monotonic()))
        late = [n for n, p in procs.items() if p.poll() is None]
        if late:
            raise AssertionError(f"a fleet outlived {timeout_s} s: {late} still running")
    finally:
        if any(p.poll() is None for p in procs.values()):
            for p in procs.values():
                if p.poll() is None:
                    with contextlib.suppress(ProcessLookupError):
                        os.killpg(p.pid, signal.SIGTERM)
            deadline = time.monotonic() + TERM_GRACE_S
            while time.monotonic() < deadline and any(p.poll() is None for p in procs.values()):
                time.sleep(0.1)
        for p in procs.values():
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for n, f in logs.items():
            f.seek(0)
            got.setdefault(n, {})["out"] = f.read()
            f.close()
    for n, p in procs.items():
        got[n]["rc"] = p.returncode
    return got


def read_reports(rep_dir: str) -> dict:
    """{file stem: document} of the worker reports in `rep_dir`."""
    reports = {}
    for fn in sorted(f for f in os.listdir(rep_dir) if f.endswith(".json")):
        with open(os.path.join(rep_dir, fn)) as f:
            reports[fn[:-len(".json")]] = json.load(f)
    return reports


def gossip_reference(torch, dev: str, geo) -> list:
    """The sequential ground truth of an elastic drill of width `geo` (the
    port's ``elastic_demo.Geometry``), independent of the worker's code:
    every replica's GossipOps batch of every step applied to one state,
    the rows folded, the observable top K."""
    from antidote_ccrdt_tpu_torch import registry
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows

    dense = registry.make_dense("topk_rmv", n_ids=geo.I, n_dcs=geo.DCS, size=geo.K, slots_per_id=geo.M,
                                device=dev)
    gen = GossipOps(geo.R, geo.I, geo.B, geo.Br, dev, zipf=geo.zipf)
    state = dense.init(geo.R, geo.NK)
    for step in range(ELASTIC_STEPS):
        state = dense.apply_ops(state, gen.batch(step, range(geo.R)), collect_dominated=False)[0]
    obs = dense.value(fold_rows(dense, state, range(geo.R)))[0][0]
    return sorted([int(i), int(sc)] for (i, sc) in obs)


def _worker_numbers(rep: dict) -> dict:
    """A worker report's per-worker line: p50 step, publish and sweep ms
    (and their sums), the first apply, peak GB."""
    return dict(step_p50_ms=pct(rep["step_ms"], 0.5), publish_p50_ms=pct(rep["publish_ms"], 0.5),
                publish_ms_sum=sum(rep["publish_ms"]), publishes=len(rep["publish_ms"]),
                sweep_p50_ms=pct(rep["sweep_ms"], 0.5), sweep_ms_sum=sum(rep["sweep_ms"]), sweeps=len(rep["sweep_ms"]),
                pipeline_close_ms=sum(rep["close_ms"]), barrier_rounds=len(rep["barrier_sweep_ms"]),
                barrier_publish_ms_sum=sum(rep["barrier_publish_ms"]), barrier_sweep_ms_sum=sum(rep["barrier_sweep_ms"]),
                first_apply_ms=rep["first_apply_ms"], peak_gb=rep["peak_gb"], launches=rep["launches"])


def elastic_references(torch, dev: str) -> dict:
    """{width: `gossip_reference` at it} for phase 18's drills (18a at
    ELASTIC_SHAPE, 18c at the demo's), made on `dev` before the fleets
    start, so that the phase can run beside others' counts."""
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import parse_shape

    return {shape: gossip_reference(torch, dev, parse_shape(shape)) for shape in dict.fromkeys((ELASTIC_SHAPE, "demo"))}


def run_drill_fleet(reference: list, dev: str, module: str, root: str, shape: str, extra=(), hold: bool = False,
                    env=None) -> dict:
    """One crash drill of ELASTIC_MEMBERS workers of `module` on `dev`
    (the victim dying at ELASTIC_DIE_AT; `env` added to the workers'
    environment): each survivor's final document
    and report, the victim's exit time, the fleet's seconds from spawn to
    exit. Fails unless the victim exits 1 and the survivors 0, with
    digests equal to `reference` (`gossip_reference` at `shape`), the
    victim out of their alive view, and (with `hold`) their first K1c,
    K2 and K3 calls equal to the plain versions."""
    cmds = {}
    for m in ELASTIC_MEMBERS:
        cmds[m] = ["-m", module, "--root", root, "--member", m, "--n-members", str(len(ELASTIC_MEMBERS)),
                   "--type", "topk_rmv", "--device", dev, "--shape", shape, "--steps", str(ELASTIC_STEPS),
                   "--report", os.path.join(root, f"report-{m}.json"), *extra, *(["--hold"] if hold else []),
                   *(["--die-at", str(ELASTIC_DIE_AT)] if m == ELASTIC_VICTIM else [])]
    t0 = time.time()
    got = run_procs(cmds, root, ELASTIC_FLEET_TIMEOUT_S, env=env)
    fleet_s = max(g["exit_t"] for g in got.values()) - t0
    victim = got[ELASTIC_VICTIM]
    if victim["rc"] != 1:
        raise AssertionError(f"18: the victim exited {victim['rc']}, not 1:\n{victim['out'][-4000:]}")
    ref = reference
    if not ref:
        raise AssertionError("18: the reference observable is empty")
    out = dict(fleet_s=fleet_s, death_t=victim["exit_t"], finals={}, reports={})
    for m in ELASTIC_MEMBERS:
        if m == ELASTIC_VICTIM:
            continue
        if got[m]["rc"] != 0:
            raise AssertionError(f"18: survivor {m} exited {got[m]['rc']}:\n{got[m]['out'][-6000:]}")
        with open(os.path.join(root, f"final-{m}.json")) as f:
            final = json.load(f)
        with open(os.path.join(root, f"report-{m}.json")) as f:
            rep = json.load(f)
        if final["digest"] != ref:
            raise AssertionError(f"18: survivor {m}'s digest differs from the sequential reference")
        if ELASTIC_VICTIM in final["alive"]:
            raise AssertionError(f"18: survivor {m} still counts the victim alive")
        if hold and (set(rep["held"]) != {"K1c", "K2", "K3"} or
                     any(v["max_abs_err"] or not v["equal"] for v in rep["held"].values())):
            raise AssertionError(f"18: survivor {m}'s held calls {rep['held']}")
        out["finals"][m], out["reports"][m] = final, rep
    out["valid_observed"] = len(ref)
    return out


def _recovery_times(drill: dict) -> dict:
    """Seconds from the victim's death to each survivor's first adoption
    pass after it, and to the end of its final barrier."""
    out = {}
    for m, rep in drill["reports"].items():
        after = [a["t"] for a in rep["adoptions"] if a["t"] >= drill["death_t"] and a["step"] > 0]
        out[m] = dict(death_to_adoption_s=(min(after) - drill["death_t"]) if after else None,
                      death_to_final_barrier_s=rep["t_barrier_end"] - drill["death_t"])
    return out


def run_crash_recovery(dev: str, root: str, mode: str) -> dict:
    """18b: one ``crash_recovery_demo --mode <mode> --durability group`` on
    `dev`, its workers' reports kept: the verdict and every final
    incarnation's report."""
    rep_dir = os.path.join(root, "reports")
    got = run_procs({"supervisor": ["-m", "antidote_ccrdt_tpu_torch.scripts.crash_recovery_demo", "--mode", mode,
                                    "--durability", "group", "--device", dev, "--report-dir", rep_dir]},
                    root, ELASTIC_FLEET_TIMEOUT_S)["supervisor"]
    text = got["out"]
    try:
        verdicts = json.JSONDecoder().raw_decode(text[text.index("[\n"):])[0]
    except ValueError:
        raise AssertionError(f"18b: the {dev} supervisor printed no verdicts (rc {got['rc']}):\n{text[-6000:]}")
    if got["rc"] != 0 or [v["mode"] for v in verdicts] != [mode] or not all(v["ok"] for v in verdicts):
        raise AssertionError(f"18b: the {dev} drills failed (rc {got['rc']}): {json.dumps(verdicts)[:4000]}")
    return dict(verdicts=verdicts, reports=read_reports(rep_dir), supervisor_s=got["exit_t"] - got["spawn_t"])


def run_spanned_drill(reference: list, dev: str, root: str) -> dict:
    """18a: `run_drill_fleet` of elastic_demo.py at ELASTIC_SHAPE with
    --delta and the slowed failure detector, the survivors' first kernel
    calls held, the span plane and the device observatory on, held to
    `reference`: the drill's result, with `root` and its spill directory
    `obs` (read in 19d)."""
    obs = os.path.join(root, "obs")
    os.makedirs(root, exist_ok=True)
    slow = ["--delta", "--timeout", str(ELASTIC_TIMEOUT), "--hb-interval", str(ELASTIC_HB),
            "--settle-s", str(ELASTIC_SETTLE_S)]
    drill = run_drill_fleet(reference, dev, "antidote_ccrdt_tpu_torch.scripts.elastic_demo", root, ELASTIC_SHAPE, slow,
                            hold=True, env={"CCRDT_OBS_DIR": obs, "CCRDT_SPANS": "1", "CCRDT_DEVPROF": "1"})
    return dict(drill, root=root, obs=obs)


def phase_elastic(torch, card: str, root_a: str, references: dict, dev: str = "cuda"):
    """Phase 18: the elastic drill workers of antidote_ccrdt_tpu_torch/scripts
    as real processes. (a) `run_spanned_drill` in `root_a`, which the
    caller keeps for 19d; (b) crash_recovery_demo.py's wal and adopt arms
    on `dev` and on the CPU at once, every verdict ok and the card fleet's
    final digests the CPU fleet's; (c) net_gossip_demo.py's TCP crash drill
    at elastic_demo's width, converged with retries and received frames
    counted; (b) and (c) run beside (a). `references` are
    `elastic_references`' (no kernel runs in this process: main() runs
    the phase beside others). Returns the path's launches (every
    card worker's that wrote a report: the survivors and the restarted
    victims; a killed worker writes none) and 18a's drill."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()  # the workers share the card
    launches = {n: 0 for n in SOURCES}

    def add(rep):
        for n, v in rep["launches"].items():
            launches[n] += v

    tcp_module = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"
    with tempfile.TemporaryDirectory() as tmp:
        # 18a's drill in this thread, 18b's four supervisors (the arms on
        # the card and on the CPU) and 18c's TCP drill beside it: none of
        # them gates a time.
        devs = {"card": dev, "cpu": "cpu"} if on_card else {"cpu": "cpu"}
        runs = [(name, mode) for name in devs for mode in ("wal", "adopt")]
        for name, mode in runs:
            os.makedirs(os.path.join(tmp, f"b-{name}-{mode}"))
        root = os.path.join(tmp, "c")
        os.makedirs(root)
        t_abc = time.perf_counter()
        with ThreadPoolExecutor(len(runs) + 1) as pool:
            futs = {(name, mode): pool.submit(run_crash_recovery, devs[name], os.path.join(tmp, f"b-{name}-{mode}"),
                                              mode) for name, mode in runs}
            f_c = pool.submit(run_drill_fleet, references["demo"], dev, tcp_module, root, "demo")
            a = run_spanned_drill(references[ELASTIC_SHAPE], dev, root_a)
            done = {k: f.result() for k, f in futs.items()}
            c = f_c.result()
        abc_s = time.perf_counter() - t_abc

        # 18a: the crash drill at the main path's width, its spill kept.
        for rep in a["reports"].values():
            add(rep)
            if on_card:
                require_launches(rep["launches"], ("scatter_max_rows_copy", "delta_place", "sort_slots"),
                                 f"18a worker {rep['member']}")
        log("18a elastic", card=card, shape=ELASTIC_SHAPE, members=len(ELASTIC_MEMBERS), steps=ELASTIC_STEPS,
            die_at=ELASTIC_DIE_AT, timeout_s=ELASTIC_TIMEOUT, hb_interval_s=ELASTIC_HB, settle_s=ELASTIC_SETTLE_S,
            fleet_s=a["fleet_s"], per_worker={m: _worker_numbers(r) for m, r in a["reports"].items()},
            recovery=_recovery_times(a), held={m: r["held"] for m, r in a["reports"].items()},
            confirmed_dead={m: r["confirmed_dead"] for m, r in a["reports"].items()},
            converged=True, valid_observed=a["valid_observed"], spans_and_devprof_on=True,
            beside=["18b", "18c"])

        # 18b: crash_recovery_demo's two arms on the card and on the CPU.
        b = {name: dict(verdicts=[done[name, m]["verdicts"][0] for m in ("wal", "adopt")],
                        reports={k: r for m in ("wal", "adopt") for k, r in done[name, m]["reports"].items()},
                        supervisor_s={m: done[name, m]["supervisor_s"] for m in ("wal", "adopt")})
             for name in devs}
        card_b = b["card"] if on_card else b["cpu"]
        if set(card_b["reports"]) != set(b["cpu"]["reports"]):
            raise AssertionError(f"18b: the fleets' reports {sorted(card_b['reports'])}, {sorted(b['cpu']['reports'])}")
        for key, rep in b["cpu"]["reports"].items():
            if card_b["reports"][key]["digest"] != rep["digest"]:
                raise AssertionError(f"18b: worker {key}'s final digest differs between the fleets")
        for rep in card_b["reports"].values():
            if on_card:
                add(rep)
        victims = {k: dict(recovered_records=r["wal_recovered_records"], resume_step=r["wal_resume_step"],
                           recover_s=r.get("wal_recover_s"))
                   for k, r in card_b["reports"].items() if k.split("-")[2] == ELASTIC_VICTIM}
        log("18b crash recovery", card=card, arms=[f"{v['mode']}/{v['durability']}" for v in card_b["verdicts"]],
            verdicts_ok=True, kill_seq=[v["kill_seq"] for v in card_b["verdicts"]], victims=victims,
            supervisor_s={n: r["supervisor_s"] for n, r in b.items()},
            per_worker={k: _worker_numbers(r) for k, r in card_b["reports"].items()},
            card_equals_cpu=on_card)

        # 18c: the TCP crash drill at elastic_demo's width.
        for m, final in c["finals"].items():
            mets = final["metrics"]
            if not (mets.get("net.retries", 0) > 0 and mets.get("net.frames_recv", 0) > 0):
                raise AssertionError(f"18c: {m}'s net counters {mets}")
        for rep in c["reports"].values():
            if on_card:
                add(rep)
        log("18c tcp", card=card, fleet_s=c["fleet_s"], per_worker={m: _worker_numbers(r) for m, r in c["reports"].items()},
            recovery=_recovery_times(c),
            net={m: {k: f["metrics"].get(k) for k in ("net.retries", "net.frames_recv", "net.frames_sent")}
                 for m, f in c["finals"].items()},
            converged=True, abc_s=abc_s, phase_s=time.perf_counter() - t_phase)
    return launches, a


def run_cli(name: str, *args):
    """One of the port's operator CLIs as ``python -m``, from the
    repository root, killed after OBS_CLI_TIMEOUT_S: its CompletedProcess
    (stdout and stderr apart)."""
    return subprocess.run([sys.executable, "-m", TOOLS + name, *map(str, args)], capture_output=True, text=True,
                          timeout=OBS_CLI_TIMEOUT_S, cwd=ROOT, env=_worker_env())


def cli_out(p, what: str, rc: int = 0) -> str:
    """The standard output of a finished CLI, which must have exited `rc`."""
    if p.returncode != rc:
        raise AssertionError(f"{what} exited {p.returncode}, not {rc}:\n{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
    return p.stdout


def run_demo(name: str, root: str, dev: str, *args) -> dict:
    """One of the port's demos as ``python -m`` (with `args`) on `dev`, its temporary
    directories and its workers' reports under `root`; it must exit 0:
    its output, seconds and the reports (`read_reports`)."""
    rep_dir = os.path.join(root, "reports")
    got = run_procs({name: ["-m", TOOLS + name, *args, "--device", dev, "--report-dir", rep_dir]}, root, OBS_TIMEOUT_S,
                    env={"TMPDIR": root})[name]
    if got["rc"] != 0:
        raise AssertionError(f"19: {name} exited {got['rc']}:\n{got['out'][-6000:]}")
    return dict(out=got["out"], s=got["exit_t"] - got["spawn_t"], reports=read_reports(rep_dir))


@contextlib.contextmanager
def tempdir_under(path: str):
    """While open, this process's temporary directories are made in `path`."""
    import tempfile

    saved, tempfile.tempdir = tempfile.tempdir, path
    try:
        yield
    finally:
        tempfile.tempdir = saved


def read_step_loop(recs: list, steps: int) -> dict:
    """A worker's span records read for its step loop (its round.e2e spans
    of steps below `steps`): the steps' ms, the step in whose window the
    first peer window was applied (round.delta_apply) or "none in the
    loop", and, in s from the loop's start, that first apply and the first
    decode of a peer window off the round thread (the prefetcher); the
    anchor snapshots' ms (round.snapshot), how many began in the loop, and
    the sends' count, p50 and max ms (round.gossip_send)."""
    spans = sorted((r for r in recs if r.get("k") == "span"), key=lambda r: r["m0"])
    loop = [r for r in spans if r["name"] == "round.e2e" and r.get("step", steps) < steps]
    if not loop:
        raise AssertionError("19d: a survivor recorded no round.e2e span of its step loop")
    t0, t1, round_tid = loop[0]["m0"], loop[-1]["m1"], loop[0]["tid"]
    applies = [r for r in spans if r["name"] == "round.delta_apply"]
    in_loop = next((e["step"] for a in applies for e in loop if e["m0"] <= a["m0"] < e["m1"]), None)
    decode = next((r for r in spans if r["name"] == "round.delta_decode" and r["tid"] != round_tid), None)

    def ms(name):
        return [(r["m1"] - r["m0"]) * 1e3 for r in spans if r["name"] == name]

    step_ms = [(e["m1"] - e["m0"]) * 1e3 for e in loop]
    sends = ms("round.gossip_send")
    return dict(steps=len(loop), loop_s=t1 - t0, step_p50_ms=pct(step_ms, 0.5), step_ms=step_ms,
                first_window_step=in_loop if in_loop is not None else "none in the loop",
                first_apply_s=(applies[0]["m0"] - t0) if applies else None,
                first_prefetch_decode_s=(decode["m0"] - t0) if decode else None,
                anchor_snapshot_ms=ms("round.snapshot"),
                snapshots_in_loop=sum(1 for r in spans if r["name"] == "round.snapshot" and t0 <= r["m0"] < t1),
                gossip_sends=len(sends), gossip_send_p50_ms=pct(sends, 0.5),
                gossip_send_max_ms=max(sends, default=None))


def demo_reference_crc(torch) -> int:
    """The crc32 of elastic_demo's sequential reference at the demo's
    width (computed on the CPU: no kernel launches), as 19e's certify
    reads it."""
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import parse_shape

    ref = gossip_reference(torch, "cpu", parse_shape("demo"))
    return zlib.crc32(json.dumps(ref, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF


def run_obs_fleets(dev: str, root: str, crc: int) -> dict:
    """Phase 19's fleets and law checks, all at once under `root` (only
    processes: no kernel runs in this process): (a) obs_dashboard --demo,
    (b) spans_demo, (e) ccrdt_audit laws on `dev` and on the CPU and
    --selftest, and (e)'s certify and verify of (b)'s fleet against
    `crc` once (b) is done. None of them gates a time."""
    from concurrent.futures import ThreadPoolExecutor

    a_root, b_root = os.path.join(root, "a"), os.path.join(root, "b")
    os.makedirs(a_root)
    os.makedirs(b_root)
    cert = os.path.join(b_root, "cert.json")

    def certify_and_verify(fb):
        b = fb.result()
        (fleet_dir,) = [os.path.join(b_root, x) for x in os.listdir(b_root) if x.startswith("spans-demo-")]
        doc = json.loads(cli_out(run_cli("ccrdt_audit", "certify", os.path.join(fleet_dir, "obs"), "--final-dir",
                                         fleet_dir, "--reference", "%08x" % crc, "--out", cert, "--json"),
                                 "19e certify"))
        return dict(b, fleet_dir=fleet_dir), doc, json.loads(cli_out(run_cli("ccrdt_audit", "verify", cert, "--json"),
                                                                     "19e verify"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        fa = pool.submit(run_demo, "obs_dashboard", a_root, dev, "--demo")
        fb = pool.submit(run_demo, "spans_demo", b_root, dev)
        f_cert = pool.submit(certify_and_verify, fb)
        f_laws = {where: pool.submit(run_cli, "ccrdt_audit", "laws", "--device", where, "--json")
                  for where in dict.fromkeys((dev, "cpu"))}
        f_self = pool.submit(run_cli, "ccrdt_audit", "laws", "--selftest", "--device", dev)
        laws = {where: cli_out(f.result(), f"19e laws --device {where}") for where, f in f_laws.items()}
        selftest = cli_out(f_self.result(), "19e laws --selftest")
        laws_s = time.perf_counter() - t0
        a = fa.result()
        b, cert_doc, verify = f_cert.result()
    return dict(a=a, b=b, laws=laws, selftest=selftest, laws_s=laws_s, cert_doc=cert_doc, verify=verify,
                fleets_s=time.perf_counter() - t0)


def spill_reads(drill: dict, out_dir: str) -> dict:
    """19d's five reads of phase 18a's spill (`drill`), at once, as
    subprocesses that touch no device: ccrdt_spans merge (its trace in
    `out_dir`) and attribute, ccrdt_trace summary, ccrdt_devprof churn
    (its finished process: on the CPU it exits 1) and watermarks."""
    from concurrent.futures import ThreadPoolExecutor

    obs, trace = drill["obs"], os.path.join(out_dir, "spans_trace.json")
    t_d = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        f_merge = pool.submit(run_cli, "ccrdt_spans", "merge", obs, "-o", trace)
        f_att = pool.submit(run_cli, "ccrdt_spans", "attribute", obs, "--json")
        f_summary = pool.submit(run_cli, "ccrdt_trace", "summary", obs, "--json")
        f_churn = pool.submit(run_cli, "ccrdt_devprof", "churn", obs, "--json")
        f_marks = pool.submit(run_cli, "ccrdt_devprof", "watermarks", drill["root"])
        return dict(merge_out=cli_out(f_merge.result(), "19d ccrdt_spans merge"),
                    att=json.loads(cli_out(f_att.result(), "19d ccrdt_spans attribute")),
                    summary=json.loads(cli_out(f_summary.result(), "19d ccrdt_trace summary")),
                    churn=f_churn.result(), marks=cli_out(f_marks.result(), "19d ccrdt_devprof watermarks"),
                    trace=trace, reads_s=time.perf_counter() - t_d)


def phase_observability(torch, card: str, drill: dict, fleets: dict, reads: dict, dev: str = "cuda") -> dict:
    """Phase 19: the operator's observability tools of
    antidote_ccrdt_tpu_torch/scripts as subprocesses. (a) obs_dashboard
    --demo and (b) spans_demo, beside (e)'s law checks; (c) overlap_demo
    alone, whole on a card (on the CPU its fleets and its digest and
    counter gates, without the timing bar); (d) the spill of phase 18a's
    crash drill (`drill`, `run_spanned_drill`'s: the span plane and the
    device observatory on) read by ccrdt_spans merge and attribute,
    ccrdt_trace summary and ccrdt_devprof churn and watermarks, at once;
    (e) ccrdt_audit laws on `dev` equal byte for byte to the CPU's, the
    selftest, and certify and verify over 19b's fleet. (a), (b) and (e)
    are `fleets`, `run_obs_fleets`' (main() runs them beside an earlier
    phase), and (d)'s reads `reads`, `spill_reads`' (main() makes them
    beside 14c). Returns the workers' launches (19a-c's reports; 18a's are
    phase 18's)."""
    import tempfile

    from antidote_ccrdt_tpu_torch.obs import spans as obs_spans

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()  # the workers share the card
    launches = {n: 0 for n in SOURCES}
    kernels3 = ("scatter_max_rows_copy", "delta_place", "sort_slots")

    def add(reports, what):
        got = {n: 0 for n in kernels3}
        for rep in reports.values():
            for n, v in rep["launches"].items():
                launches[n] += v
                got[n] += v
        if on_card:
            require_launches(got, kernels3, what)
        return got

    with tempfile.TemporaryDirectory() as tmp:
        a, b, laws, selftest = fleets["a"], fleets["b"], fleets["laws"], fleets["selftest"]
        cert_doc, verify, fleet_dir = fleets["cert_doc"], fleets["verify"], fleets["b"]["fleet_dir"]

        # 19a: the dashboard's demo, its scrape and complete-path checks.
        ok = [ln for ln in a["out"].splitlines() if ln.startswith("OK: ")]
        log("19a dashboard", card=card, demo_s=a["s"], ok=ok[-1] if ok else None,
            launches=add(a["reports"], "19a's workers"))

        # 19b: the span plane's demo and its gates.
        by_member = obs_spans.scan_dir(os.path.join(fleet_dir, "obs"))
        att = obs_spans.attribute(by_member)
        log("19b spans", card=card, demo_s=b["s"], coverage_p50=att["fleet"]["coverage_p50"],
            rounds=att["fleet"]["rounds"], members=sorted(att["members"]),
            offset_edges=sum(len(v) for v in obs_spans.clock_offsets(by_member).values()),
            e2e_p50_ms=att["fleet"]["e2e_ms_p50"], gap_p50_ms=att["fleet"]["gap_ms_p50"],
            phase_p50_ms={m: row["phases_ms_p50"] for m, row in att["members"].items()},
            launches=add(b["reports"], "19b's workers"))

        # 19c: serial against overlapped rounds.
        root = os.path.join(tmp, "c")
        os.makedirs(root)
        if on_card:  # the whole demo, its 0.30 bar included
            c = run_demo("overlap_demo", root, dev)
            arms = [dict(e2e_ms_p50=float(f[1]), gap_ms_p50=float(f[4])) for f in SPANS_FLEET_LINE.findall(c["out"])]
            red = re.search(r"\(([+-][\d.]+)% vs the", c["out"])
            c.update(reduction_pct=float(red.group(1)) if red else None, bar_held=True)
        else:  # the demo's fleets and its digest and counter gates
            from antidote_ccrdt_tpu_torch.scripts import overlap_demo

            t_c = time.perf_counter()
            rep_dir = os.path.join(root, "reports")
            with tempdir_under(root):
                runs = overlap_demo.run_arms(dev, rep_dir)
            if overlap_demo.check_convergence(runs, dev) != 0:
                raise AssertionError("19c: the overlap fleets' digests or counters failed")
            arms = [runs[label][0]["fleet"] for label in ("serial", "overlap")]
            c = dict(s=time.perf_counter() - t_c, reports=read_reports(rep_dir), reduction_pct=None, bar_held=False)
        log("19c overlap", card=card, demo_s=c["s"], reduction_pct=c["reduction_pct"], bar_held=c["bar_held"],
            e2e_p50_ms=dict(zip(("serial", "overlap"), (f["e2e_ms_p50"] for f in arms))),
            gap_p50_ms=dict(zip(("serial", "overlap"), (f["gap_ms_p50"] for f in arms))),
            launches=add(c["reports"], "19c's workers"))

        # 19d: phase 18a's drill, its step loop read through the spans; the
        # five reads at once.
        d, obs = drill, drill["obs"]
        survivors = sorted(d["reports"])
        merge_out, d_att, summary, churn, marks = (reads[k] for k in ("merge_out", "att", "summary", "churn", "marks"))
        reads_s = reads["reads_s"]
        with open(reads["trace"]) as f:
            events = json.load(f)["traceEvents"]
        lanes = {e["pid"]: e["args"]["name"] for e in events if e.get("ph") == "M" and e.get("name") == "process_name"}
        per_lane = {m: sum(1 for e in events if e.get("ph") == "X" and lanes.get(e.get("pid")) == m) for m in survivors}
        if not all(per_lane.values()):
            raise AssertionError(f"19d: the merged trace's spans by survivor {per_lane}")
        # A compile is a kernel's first load: on the CPU none happens.
        if on_card:
            churn_rows = json.loads(cli_out(churn, "19d ccrdt_devprof churn"))
            if not churn_rows:
                raise AssertionError("19d: ccrdt_devprof churn listed no site")
        else:
            cli_out(churn, "19d ccrdt_devprof churn on the CPU", rc=1)
            if "no devprof.compile events" not in churn.stderr:
                raise AssertionError(f"19d: churn on the CPU said {churn.stderr[-2000:]}")
            churn_rows = []
        spill = obs_spans.scan_dir(obs)
        log("19d elastic spans", card=card, shape=ELASTIC_SHAPE, fleet_s=d["fleet_s"], survivors=survivors,
            merge=merge_out.splitlines()[:3], merged_spans_by_survivor=per_lane,
            coverage_p50=d_att["fleet"]["coverage_p50"], e2e_p50_ms=d_att["fleet"]["e2e_ms_p50"],
            loop={m: dict(read_step_loop(spill[m], ELASTIC_STEPS), phase_p50_ms=d_att["members"][m]["phases_ms_p50"])
                  for m in survivors},
            report_step_p50_ms={m: pct(r["step_ms"], 0.5) for m, r in d["reports"].items()},
            trace=dict(deltas_traced=summary["deltas_traced"], complete_paths=summary["complete_paths"],
                       apply_samples=summary.get("apply_samples"), never_applied=len(summary.get("never_applied", [])),
                       pairs_p50_ms={k: v["p50_ms"] for k, v in summary.get("pairs", {}).items()}),
            churn=churn_rows, watermarks=marks.splitlines()[1:], reads_s=reads_s,
            drill="phase 18a's (its launches counted there)", converged=True)
        gc.collect()

        # 19e: the law checker on the card and the CPU and the certificate
        # of 19b's fleet (made beside 19a and 19b).
        if laws[dev] != laws["cpu"]:
            raise AssertionError(f"19e: the law reports differ:\n{laws[dev][:2000]}\n{laws['cpu'][:2000]}")
        law_doc = json.loads(laws[dev])
        if not law_doc["ok"]:
            raise AssertionError(f"19e: a law failed: {laws[dev][:4000]}")
        if "CAUGHT" not in selftest:
            raise AssertionError(f"19e: {selftest}")
        if not (cert_doc["ok"] and cert_doc["checks"].get("matches_reference")):
            raise AssertionError(f"19e: the certificate {json.dumps(cert_doc)[:4000]}")
        log("19e audit", card=card, law_types=law_doc["n_types"], law_checks=law_doc["n_law_checks"],
            pairs=law_doc["pairs"], card_equals_cpu=on_card, selftest_caught=True,
            certificate=dict(checks=cert_doc["checks"], flight_logs=cert_doc["n_flight_logs"],
                             signature=cert_doc["signature"][:16]),
            verify=verify, laws_s=fleets["laws_s"], fleets_s=fleets["fleets_s"],
            phase_s=time.perf_counter() - t_phase)
    return launches


def run_topo(dev: str) -> dict:
    """20b's fleet: topo_demo whole as a subprocess on `dev` with --hold
    (only processes: no kernel runs in this process), killed after
    AE_TIMEOUT_S; it must exit 0. Its output, report, workers' reports and
    seconds."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        rep_dir, doc_path = os.path.join(tmp, "reports"), os.path.join(tmp, "topo.json")
        t_b = time.perf_counter()
        run = run_procs({"topo_demo": ["-m", TOOLS + "topo_demo", "--device", dev, "--hold", "--report-dir", rep_dir,
                                       "--timeout", str(TOPO_TIMEOUT), "--out", doc_path]},
                        tmp, AE_TIMEOUT_S, env={"TMPDIR": tmp})["topo_demo"]
        demo_s = time.perf_counter() - t_b
        if run["rc"] != 0:
            raise AssertionError(f"20b: topo_demo exited {run['rc']}:\n{run['out'][-8000:]}")
        with open(doc_path) as f:
            doc = json.load(f)
        return dict(out=run["out"], doc=doc, reports=read_reports(rep_dir), demo_s=demo_s)


def phase_antientropy(torch, card: str, topo: dict, dev: str = "cuda") -> dict:
    """Phase 20: the anti-entropy gates. (a) the TCP probe, then
    partition_demo.run_drill in this process at AE_SHAPE with every K1c,
    K2 and K3 call held against its plain version: all seven of the demo's
    checks, and w2's pre-outage margin logged; then the drill at
    the demo's width on the CPU and on `dev`, equal reports but for the
    counters that hang on thread timing. (b) topo_demo's fleet (`topo`,
    `run_topo`'s; main() runs it beside an earlier phase): every gate of
    the demo, each worker's first K1c, K2 and K3 calls equal to the plain
    versions. Returns the launches of 20a's drill and of 20b's workers."""
    from antidote_ccrdt_tpu_torch.scripts import partition_demo
    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import launch_counts

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    launches = {n: 0 for n in SOURCES}
    kernels3 = ("scatter_max_rows_copy", "delta_place", "sort_slots")
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}

    # 20a: the TCP probe, then the partition drill at 40 000 ids, every
    # kernel call held, w2's last sweep before the outage timed against
    # its peers' deltas landing.
    from antidote_ccrdt_tpu_torch.net import tcp

    probe_s = tcp_landing_s(tcp)
    log("20a tcp probe", card=card, landed_s=probe_s, send_timeout_s=AE_SEND_TIMEOUT)
    geo = partition_demo.parse_shape(AE_SHAPE)
    held = {}
    before = launch_counts()
    t0 = time.perf_counter()
    with held_against_plain(torch, held), delta_landings_and_sweeps() as seen:
        rep = partition_demo.run_drill(dev, geo, AE_PARTS, AE_SEND_TIMEOUT, AE_STEPS)
    drill_s = time.perf_counter() - t0
    margin_s = pre_outage_margin_s(seen, partition_demo.OUTAGE_LO)
    got = _since(before)
    if not rep["pass"]:
        raise AssertionError(f"20a: the partition drill failed {[k for k, ok in rep['checks'].items() if not ok]}: "
                             f"{json.dumps(rep)[:4000]}")
    held_calls = {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in kernels3}
    if on_card:
        require_launches(got, kernels3, "20a's drill")
        if held_calls != {n: got[n] for n in kernels3}:
            raise AssertionError(f"20a launched {got}, of which held against the plain versions {held_calls}")
    for n, v in got.items():
        launches[n] += v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    counters = rep["counters_w2"]
    log("20a partition drill", card=card, shape=AE_SHAPE, geometry=rep["geometry"], partitions=AE_PARTS,
        members=list(partition_demo.MEMBERS), owned=partition_demo.owned_replicas(geo.R),
        whole_resync_bytes=rep["whole_resync_bytes"], partial_resync_bytes=rep["partial_resync_bytes"],
        bytes_ratio=rep["bytes_ratio"], min_ratio=rep["min_ratio"], p_star=rep["p_star"],
        p_star_ids=rep["p_star_ids"], divergent_parts=rep["divergent_parts"],
        partition_resyncs=counters.get("net.partition_resyncs", 0), psnap_fetches=counters.get("net.psnap_fetches", 0),
        psnap_wasted=counters.get("net.psnap_wasted", 0), checks=rep["checks"], counters_w2=counters,
        drill_s=drill_s, drill_s_includes="every K1c, K2 and K3 call's plain version", peak_mem_gb=peak_gb,
        pre_outage_margin_s=margin_s,
        launches=got, held_against_plain=held)
    del rep
    gc.collect()

    # 20a at the demo's width: the CPU's plain versions against the card.
    small = {d: partition_demo.run_drill(d, partition_demo.DEMO, AE_PARTS) for d in dict.fromkeys(("cpu", dev))}

    def steady(r):
        return dict(r, counters_w2={k: v for k, v in r["counters_w2"].items()
                                    if k not in partition_demo.TIMING_COUNTERS})

    for d, r in small.items():
        if not r["pass"]:
            raise AssertionError(f"20a: the drill at the demo's width failed on {d}: {json.dumps(r)[:4000]}")
    if steady(small["cpu"]) != steady(small[dev]):
        raise AssertionError(f"20a: the demo-width reports differ:\n{json.dumps(small['cpu'])}\n"
                             f"{json.dumps(small[dev])}")
    log("20a demo width", card=card, equal_cpu_card=True, bytes_ratio=small[dev]["bytes_ratio"],
        partial_resync_bytes=small[dev]["partial_resync_bytes"], whole_resync_bytes=small[dev]["whole_resync_bytes"],
        timing_counters={d: {k: r["counters_w2"].get(k) for k in partition_demo.TIMING_COUNTERS}
                         for d, r in small.items()})
    del small

    # 20b: topo_demo whole, each worker's first kernel calls held.
    doc, reports, demo_s = topo["doc"], topo["reports"], topo["demo_s"]
    legs_s = [float(x) for x in re.findall(r"leg seconds: ([\d.]+)", topo["out"])]
    b_got = {n: 0 for n in kernels3}
    for name, r in reports.items():
        if set(r["held"]) != {"K1c", "K2", "K3"} or any(v["max_abs_err"] or not v["equal"]
                                                        for v in r["held"].values()):
            raise AssertionError(f"20b: worker {name}'s held calls {r['held']}")
        for n, v in r["launches"].items():
            b_got[n] += v
            launches[n] += v
    if on_card:
        require_launches(b_got, kernels3, "20b's workers")
    cz, c = doc["cross_zone"], doc["counters"]
    log("20b topo", card=card, demo_s=demo_s, legs_s=dict(zip(("topo", "mesh"), legs_s)),
        killed_anchor=doc["killed_anchor"], converged=doc["converged"], baseline_converged=doc["baseline_converged"],
        cross_zone_sends=dict(topo=cz["topo_frame_sends"], mesh=cz["mesh_frame_sends"], ratio=cz["ratio"]),
        cross_zone_frames=cz["frames"], cross_zone_bytes=cz["bytes"], relays=c.get("topo.relays", 0),
        anchor_changes=c.get("topo.anchor_changes", 0), failover_events=len(doc["failover_events"]),
        failovers=[{k: ev.get(k) for k in ("member", "old", "new", "t")} for ev in doc["failover_events"]],
        worker_timeout_s=TOPO_TIMEOUT, first_apply_ms={n: r["first_apply_ms"] for n, r in reports.items()},
        workers=len(reports), launches=b_got, phase_s=time.perf_counter() - t_phase)
    return launches


@contextlib.contextmanager
def recorded_digests(into: list):
    """Watches a run, changing nothing it does: every digest vector
    ``core.partition.state_digests`` returns is appended to `into`."""
    from antidote_ccrdt_tpu_torch.core import partition

    state_digests = partition.state_digests

    def record(state, P):
        vec = state_digests(state, P)
        into.append([int(x) for x in vec])
        return vec

    partition.state_digests = record
    try:
        yield into
    finally:
        partition.state_digests = state_digests


@contextlib.contextmanager
def one_thread_workers():
    """While open, the workers this process starts run one CPU thread each
    (unless the environment already says otherwise)."""
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)


def run_cert_fleets(dev: str, reference) -> dict:
    """21a's two fleets at once on `dev`, one CPU thread a worker:
    audit_demo's healthy TCP fleet, each worker's first kernel calls held,
    and its durability leg (the async crash drill and the fabricated log),
    both held to `reference` (elastic_demo.reference_digest's, made
    beforehand on the CPU): only processes, no kernel runs in this
    process. Their results, seconds and worker reports."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from antidote_ccrdt_tpu_torch.scripts import audit_demo

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp, one_thread_workers():
        rep_dir = {k: os.path.join(tmp, f"reports-{k}") for k in ("healthy", "durability")}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            f_healthy = pool.submit(timed, audit_demo.run_healthy, device=dev, report_dir=rep_dir["healthy"],
                                    hold=True, reference=reference)
            f_durability = pool.submit(timed, audit_demo.run_durability, CERT_TIMEOUT_S, dev, rep_dir["durability"],
                                       reference=reference)
            (healthy, healthy_s), (durability, durability_s) = (f.result() for f in (f_healthy, f_durability))
        return dict(healthy=healthy, healthy_s=healthy_s, durability=durability, durability_s=durability_s,
                    fleets_s=time.perf_counter() - t0, reports={k: read_reports(d) for k, d in rep_dir.items()})


def phase_certified(torch, card: str, fleets: dict, dev: str = "cuda") -> dict:
    """Phase 21: the certified-convergence gates. (a) audit_demo's
    divergent arm at CERT_SHAPE in this process with every K1c, K2 and
    K3 call held against its plain version, then at the demo's width on
    the CPU and on `dev` (equal reports under a frozen wall clock); (b)
    multichip_demo's phase B (3 elastic_demo workers of 8 logical
    devices each at MULTICHIP_SHAPE, each's first kernel calls
    held, w1 SIGKILLed mid-load) beside its phase A at MULTICHIP_SHAPE in
    this process; (a) again: its healthy fleet (3 TCP workers, each's
    first kernel calls held) and its durability leg (the async crash
    drill and the fabricated log), `fleets` (`run_cert_fleets`'; main()
    runs them beside an earlier phase), then the law checker
    (CERT_PAIRS pairs); (b) phase A at the demo's width on the CPU and on
    `dev` (equal reports but for the timings, equal digest vectors).
    Every gate of both demos. Returns the launches of the divergent arm,
    phase A (with phase B's sequential reference, made beside it) and the
    fleets' workers."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from antidote_ccrdt_tpu_torch.scripts import audit_demo, multichip_demo, partition_demo
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import parse_shape
    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import launch_counts

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.perf_counter()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    launches = {n: 0 for n in SOURCES}
    kernels3 = ("scatter_max_rows_copy", "delta_place", "sort_slots")
    kernel_of = {"scatter_max_rows_copy": "K1c", "delta_place": "K2", "sort_slots": "K3"}

    def add(got, what):
        for n, v in got.items():
            launches[n] += v
        if on_card:
            require_launches(got, kernels3, what)
        return got

    def add_reports(reports, what):
        got = {n: 0 for n in kernels3}
        for rep in reports.values():
            for n, v in rep["launches"].items():
                got[n] += v
        return add(got, what)

    # 21a: the divergent arm at CERT_SHAPE, every kernel call held.
    geo = parse_shape(CERT_SHAPE)
    held = {}
    before = launch_counts()
    t0 = time.perf_counter()
    with held_against_plain(torch, held):
        div = audit_demo.run_divergent(dev, geo)
    div_s = time.perf_counter() - t0
    got = _since(before)
    held_calls = {n: sum(v["calls"] for k, v in held.items() if k.split()[0] == kernel_of[n]) for n in kernels3}
    if on_card and held_calls != {n: got[n] for n in kernels3}:
        raise AssertionError(f"21a launched {got}, of which held against the plain versions {held_calls}")
    states = (div["states"]["agree"], div["states"]["first"], div["states"]["wedged"], div["states"]["healed"])
    if not (div["ok"] and div["p_star"] in div["divergent_parts"] and states == (0, 1, 2, 0)
            and div["counterexample_parts"] == div["divergent_parts"] and not div["cert"]["ok"]):
        raise AssertionError(f"21a: the divergent arm {json.dumps(div)[:4000]}")
    log("21a divergent", card=card, shape=CERT_SHAPE, geometry=geo._asdict(), p_star=div["p_star"],
        divergent_parts=div["divergent_parts"], counterexample_parts=div["counterexample_parts"],
        states=div["states"], tta_p50_s=div["tta_p50_s"], counters=div["counters"], cert_ok=div["cert"]["ok"],
        arm_s=div_s, arm_s_includes="every K1c, K2 and K3 call's plain version",
        launches=add(got, "21a's divergent arm"), held_against_plain=held)
    del div

    # The arm at the demo's width: the CPU's plain versions against `dev`.
    with frozen_wall_clock():
        small = {d: audit_demo.run_divergent(d) for d in dict.fromkeys(("cpu", dev))}
    if not small[dev]["ok"] or small["cpu"] != small[dev]:
        raise AssertionError(f"21a: the demo-width divergent reports differ or fail:\n{json.dumps(small['cpu'])}\n"
                             f"{json.dumps(small[dev])}")
    log("21a divergent demo width", card=card, equal_cpu_card=True, p_star=small[dev]["p_star"],
        divergent_parts=small[dev]["divergent_parts"], signature=small[dev]["cert"]["signature"][:16])
    del small

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        return fn(*args, **kw), time.perf_counter() - t0

    def check_held(reports, what):
        for name, r in reports.items():
            if set(r["held"]) != {"K1c", "K2", "K3"} or any(v["max_abs_err"] or not v["equal"]
                                                            for v in r["held"].values()):
                raise AssertionError(f"{what}: worker {name}'s held calls {r['held']}")

    with tempfile.TemporaryDirectory() as tmp, tempdir_under(tmp), one_thread_workers():
        rep_dir = {"mesh": os.path.join(tmp, "reports-mesh")}

        # 21b: phase B at MULTICHIP_SHAPE (each worker's first calls held)
        # in a thread, phase A at MULTICHIP_SHAPE in this one, at once.
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()  # the workers share the card
            torch.cuda.reset_peak_memory_stats()
        mc, a = {}, {}
        before = launch_counts()
        t_ab = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            f_mesh = pool.submit(timed, multichip_demo.phase_b, mc, CERT_TIMEOUT_S, dev, rep_dir["mesh"],
                                 MULTICHIP_SHAPE, hold=True)
            t0 = time.perf_counter()
            a_bad = multichip_demo.phase_a(a, dev, partition_demo.parse_shape(MULTICHIP_SHAPE))
            a_s = time.perf_counter() - t0
            b_bad, b_s = f_mesh.result()
        ab_s = time.perf_counter() - t_ab
        got = _since(before)  # phase A's and phase B's sequential reference's
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
        mesh_reports = read_reports(rep_dir["mesh"])

        # 21a's law checker (its fleets are `fleets`).
        t0 = time.perf_counter()
        laws = audit_demo.run_laws(CERT_PAIRS, device=dev)
        laws_s = time.perf_counter() - t0
    healthy, healthy_s, durability, durability_s = (fleets[k] for k in ("healthy", "healthy_s", "durability",
                                                                       "durability_s"))
    fleets_s, reports = fleets["fleets_s"], fleets["reports"]

    if not (laws["ok"] and laws["selftest_caught"] and laws["registry_ok"]):
        raise AssertionError(f"21a: the laws {laws}")
    log("21a laws", card=card, pairs=CERT_PAIRS, n_types=laws["n_types"], n_law_checks=laws["n_law_checks"],
        n_law_failures=laws["n_law_failures"], selftest_caught=laws["selftest_caught"], laws_s=laws_s)

    cert = healthy["cert"]
    if not (healthy["ok"] and cert["ok"] and healthy["verified"] and healthy["wedge_alarms"] == 0):
        raise AssertionError(f"21a: the healthy fleet {json.dumps({k: v for k, v in healthy.items()})[:4000]}")
    check_held(reports["healthy"], "21a's healthy fleet")
    log("21a healthy", card=card, cert_ok=cert["ok"], verified=healthy["verified"], checks=cert["checks"],
        flight_logs=cert["n_flight_logs"], wedge_alarms=healthy["wedge_alarms"], counters=healthy["counters"],
        fleet_s=healthy_s, first_apply_ms={n: r["first_apply_ms"] for n, r in reports["healthy"].items()},
        launches=add_reports(reports["healthy"], "21a's healthy fleet"))

    fleet = durability["fleet"]
    if not (durability["ok"] and fleet["certifier_checks"].get("durability_watermark") is True
            and durability["fabricated_flagged"] and not durability["fabricated_cert_ok"]
            and [x["uncovered"] for x in durability["fabricated_exposures"]] == [[6, 9]]):
        raise AssertionError(f"21a: the durability leg {json.dumps(durability)[:4000]}")
    log("21a durability", card=card, fleet=fleet, fabricated_flagged=True,
        fabricated_exposures=durability["fabricated_exposures"], leg_s=durability_s, fleets_s=fleets_s,
        launches=add_reports(reports["durability"], "21a's durability fleet"))

    checks_b = multichip_demo.checks_of(b_bad)
    b_checks = {k: checks_b[k] for k in ("survivors_match_sequential_reference", "every_survivor_ran_ici_reduces",
                                         "certificate_verifies", "kill_landed_mid_load")}
    if b_bad or not all(b_checks.values()):
        raise AssertionError(f"21b: phase B failed {sorted(b_bad)}: {json.dumps(mc)[:4000]}")
    check_held(mesh_reports, "21b's phase B")
    log("21b phase B", card=card, shape=MULTICHIP_SHAPE, local_devices=multichip_demo.N_DEVICES,
        kill_seq=mc["kill_seq"], victim_rc=mc["victim_rc"], checks=b_checks, zones=mc["zones_reported"],
        survivor_counters=mc["survivor_counters"], certifier_checks=mc["certifier_checks"], fleet_s=b_s,
        per_worker={n: _worker_numbers(r) for n, r in mesh_reports.items()},
        held={n: r["held"] for n, r in mesh_reports.items()},
        launches=add_reports(mesh_reports, "21b's phase B workers"))

    a_checks = {k: v for k, v in multichip_demo.checks_of(a_bad).items()
                if k in ("partial_ge_5x_smaller", "repair_digests_bit_identical", "shard_local_slices_only")}
    if a_bad:
        raise AssertionError(f"21b: phase A failed {a_bad}: {json.dumps(a)[:4000]}")
    log("21b phase A", card=card, shape=MULTICHIP_SHAPE, mesh=a["mesh"], partitions=multichip_demo.P,
        p_star=a["p_star"], p_star_ids=a["p_star_ids"], whole_resync_bytes=a["whole_resync_bytes"],
        partial_resync_bytes=a["partial_resync_bytes"], bytes_ratio=a["bytes_ratio"], checks=a_checks,
        cross_slice_bytes=a["cross_slice_bytes"], cross_slice_fetches=a["cross_slice_fetches"],
        shard_digest_slices=a["shard_digest_slices"], ici_reduce_ms_p50=a["ici_reduce_ms_p50"],
        mesh_merges_per_sec=a["mesh_merges_per_sec"], phase_a_s=a_s, beside_phase_b_s=ab_s,
        peak_mem_gb=peak_gb, launches=add(got, "21b's phase A"),
        launches_and_peak_include="phase B's sequential reference, made in this process beside phase A")
    del a

    # Phase A at the demo's width: the CPU against `dev`.
    small, vecs = {}, {}
    for d in dict.fromkeys(("cpu", dev)):
        small[d] = {}
        with recorded_digests(vecs.setdefault(d, [])):
            if multichip_demo.phase_a(small[d], d):
                raise AssertionError(f"21b: phase A at the demo's width failed on {d}: {json.dumps(small[d])}")

    def steady(r):
        return {k: v for k, v in r.items() if k not in ("ici_reduce_ms_p50", "mesh_merges_per_sec")}

    if steady(small["cpu"]) != steady(small[dev]) or vecs["cpu"] != vecs[dev] or not vecs[dev]:
        raise AssertionError(f"21b: the demo-width phase A differs:\n{json.dumps(small['cpu'])}\n"
                             f"{json.dumps(small[dev])}")
    log("21b phase A demo width", card=card, equal_cpu_card=True, digest_vectors=len(vecs[dev]),
        bytes_ratio=small[dev]["bytes_ratio"], partial_resync_bytes=small[dev]["partial_resync_bytes"],
        whole_resync_bytes=small[dev]["whole_resync_bytes"], phase_s=time.perf_counter() - t_phase)
    return launches

def start_tier_demo(torch, pool, name: str, dev: str, args: list, timeout_s: float) -> dict:
    """Start one of the fleet-tier demos in `pool`: ``python -m
    <TOOLS><name> --device <dev> <args>`` with a ``--report-dir`` and an
    ``--out`` in a directory of its own, through `run_procs`, stopped
    after `timeout_s`. Returns the handle `storm_over` and
    `finish_tier_demo` take."""
    import tempfile

    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()  # the workers share the card
    tmp = tempfile.TemporaryDirectory()
    rep_dir, out_path = os.path.join(tmp.name, "reports"), os.path.join(tmp.name, "report.json")
    cmd = ["-m", TOOLS + name, "--device", dev, *args, "--report-dir", rep_dir, "--out", out_path]
    fut = pool.submit(run_procs, {name: cmd}, tmp.name, timeout_s, {"TMPDIR": tmp.name})
    return dict(name=name, dev=dev, tmp=tmp, rep_dir=rep_dir, out_path=out_path, fut=fut, t0=time.perf_counter())


def start_write_tier(torch, pool, dev: str = "cuda") -> dict:
    """Phase 22's demo, started in `pool` (`start_tier_demo`)."""
    return start_tier_demo(torch, pool, "write_tier_demo", dev, [
        "--shape", WRITE_SHAPE, "--hold", "--steps", str(WRITE_STEPS), "--kill-at-step", str(WRITE_KILL_AT),
        "--step-sleep", str(WRITE_STEP_SLEEP)], WRITE_TIMEOUT_S)


def start_read_tier(torch, pool, dev: str = "cuda") -> dict:
    """Phase 23's demo, started in `pool` (`start_tier_demo`)."""
    min_reads, max_p99_ms, max_blip_ms = READ_BOUNDS
    return start_tier_demo(torch, pool, "read_tier_demo", dev, [
        "--shape", READ_SHAPE, "--hold", "--kill-at-step", str(READ_KILL_AT), "--step-sleep", str(READ_STEP_SLEEP),
        "--min-reads", str(min_reads), "--max-p99-ms", str(max_p99_ms), "--max-blip-ms", str(max_blip_ms)],
        READ_TIMEOUT_S)


def storm_over(demo: dict):
    """Wait until `demo`'s storm is over (its supervisor.json is written)
    or the demo has ended; returns that supervisor.json, or None if the
    demo ended without one. Whether what runs after this may touch a timed
    check is the demo's own: phases 22's and 23's read the storm only,
    phase 24's overhead window comes after it."""
    path = os.path.join(demo["rep_dir"], "supervisor.json")
    while not (demo["fut"].done() or os.path.exists(path)):
        time.sleep(0.2)
    if not os.path.exists(path):
        return None
    with open(path) as f:  # the demos replace it whole
        return json.load(f)


def finish_tier_demo(demo: dict) -> tuple:
    """Wait for `demo` to exit: (its run, its report or None, its
    supervisor.json or None, {member: worker report}). Its directory stays
    until the caller closes ``demo["tmp"]``."""
    run = demo["fut"].result()[demo["name"]]
    docs = read_reports(demo["rep_dir"]) if os.path.isdir(demo["rep_dir"]) else {}
    report = None
    if os.path.exists(demo["out_path"]):
        with open(demo["out_path"]) as f:
            report = json.load(f)
    workers = {n[len("report-"):]: r for n, r in docs.items() if n.startswith("report-")}
    return run, report, docs.get("supervisor"), workers


def adoption_after_kill(workers: dict, kill_t: float) -> dict:
    """Seconds from the SIGKILL to each survivor's first adoption after
    it: the survivors' detector is the slowed one, while the clients'
    routers read the supervisor's dead set at once (the blip is failover,
    not detection)."""
    return {m: min((a["t"] - kill_t for a in r["adoptions"] if a["t"] >= kill_t and a["step"] > 0), default=None)
            for m, r in workers.items()}


def survivors_launches(workers: dict, what: str, on_card: bool) -> dict:
    """The survivors' summed launches of K1c, K2 and K3. Fails unless each
    survivor's held first calls equal the plain versions and, on the card,
    it launched all three."""
    kernels3 = ("scatter_max_rows_copy", "delta_place", "sort_slots")
    got = {n: 0 for n in kernels3}
    for name, r in workers.items():
        if set(r["held"]) != {"K1c", "K2", "K3"} or any(v["max_abs_err"] or not v["equal"]
                                                        for v in r["held"].values()):
            raise AssertionError(f"{what}: worker {name}'s held calls {r['held']}")
        if on_card:
            require_launches(r["launches"], kernels3, f"{what}'s worker {name}")
        for n, v in r["launches"].items():
            got[n] += v
    return got


def per_worker(workers: dict) -> dict:
    """A tier demo's per-survivor line: first apply, p50 step, peak GB,
    launches."""
    return {m: dict(first_apply_ms=r["first_apply_ms"], step_p50_ms=pct(r["step_ms"], 0.5), peak_gb=r["peak_gb"],
                    launches=r["launches"]) for m, r in workers.items()}


def phase_write_tier(torch, card: str, demo: dict) -> dict:
    """Phase 22: the fleet write tier. write_tier_demo whole as a
    subprocess (`start_write_tier`'s `demo`) at WRITE_SHAPE, WRITE_STEPS
    steps, the hot key's owner SIGKILLed at WRITE_KILL_AT, each worker's
    first kernel calls held: all 17 of the demo's checks, the SIGKILL of
    k0's owner mid-load after hard acks from it, each survivor's launches
    of K1c, K2 and K3 and its held calls equal to the plain versions, both
    certificates verified and the violating arm's counterexample naming
    [8, 20]. Returns the survivors' launches (a killed worker writes no
    report)."""
    from antidote_ccrdt_tpu_torch.scripts import write_tier_demo

    on_card = torch.device(demo["dev"]).type == "cuda"
    with demo["tmp"]:
        run, rep, sup, workers = finish_tier_demo(demo)
    demo_s = run["exit_t"] - run["spawn_t"]
    if run["rc"] != 0:
        raise AssertionError(f"22: write_tier_demo exited {run['rc']}:\n{run['out'][-8000:]}")
    checks, victim = rep["checks"], rep["killed"]
    if not (rep["pass"] and len(checks) == 17 and all(checks.values())):
        raise AssertionError(f"22: the write tier failed {[k for k, ok in checks.items() if not ok]}: "
                             f"{json.dumps(rep)[:4000]}")
    survivors = [m for m in write_tier_demo.MEMBERS if m != victim]
    if not (victim == sup["victim"] and f"SIGKILL -> {victim} (mid-load)" in run["out"]
            and sup["kill_step"] >= WRITE_KILL_AT and rep["outcomes"]["victim_hard"] > 0):
        raise AssertionError(f"22: no mid-load SIGKILL of {victim} after hard acks from it: {sup}, "
                             f"{rep['outcomes']}")
    if sorted(workers) != survivors:
        raise AssertionError(f"22: reports from {sorted(workers)}, survivors {survivors}")
    cx = rep["violating_arm"]["counterexample"]
    if not (rep["write_certificate"]["ok"] and rep["session_certificate"]["ok"] and rep["violating_arm"]["ok"] is False
            and any(e["origin"] == "v0" and e["uncovered"] == [8, 20] for e in cx)):
        raise AssertionError(f"22: the certificates {rep['write_certificate']}, {rep['session_certificate']}, "
                             f"{rep['violating_arm']}")
    got = survivors_launches(workers, "22", on_card)
    log("22 write tier", card=card, shape=WRITE_SHAPE, members=write_tier_demo.MEMBERS, steps=WRITE_STEPS,
        kill_at_step=WRITE_KILL_AT, step_sleep_s=WRITE_STEP_SLEEP, killed=victim, kill_step=sup["kill_step"],
        checks=checks, writes_per_s=rep["fleet_writes_per_sec"], ops_per_s=rep["fleet_ops_per_sec"],
        write_p99_ms=rep["write_p99_ms"], write_max_ms=rep["write_max_ms"], failover_blip_ms=rep["failover_blip_ms"],
        writes_acked=rep["writes_acked"], acks_by_level=rep["acks_by_level"], coalesce_ratio=rep["coalesce_ratio"],
        outcomes=rep["outcomes"], load_s=rep["load_s"], write_faults_fired=rep["write_faults_fired"],
        write_certificate=rep["write_certificate"], session_certificate=rep["session_certificate"],
        violating_arm=rep["violating_arm"], shed_arm=rep["shed_arm"], per_worker=per_worker(workers),
        held={m: r["held"] for m, r in workers.items()}, kill_to_adoption_s=adoption_after_kill(workers, sup["kill_t"]),
        failover="routers read the supervisor's dead set at once", demo_s=demo_s,
        storm_end_to_exit_s=run["exit_t"] - sup["storm_t1"], launches=got, phase_s=time.perf_counter() - demo["t0"])
    return dict(dict.fromkeys(SOURCES, 0), **got)


def phase_read_tier(torch, card: str, demo: dict) -> dict:
    """Phase 23: the fleet read tier. read_tier_demo whole as a subprocess
    (`start_read_tier`'s `demo`) at READ_SHAPE, the rendezvous head of
    "k0" SIGKILLed at READ_KILL_AT, each worker's first kernel calls held:
    all 11 of the demo's checks at READ_BOUNDS, the SIGKILL of the victim
    mid-load, reports from exactly the three survivors, each survivor's
    launches of K1c, K2 and K3 and its held calls equal to the plain
    versions, the clean session certificate verified with reads and
    writes, and the violating arm's counterexample naming session
    demo-violating, origin w0, with have < want. Returns the survivors'
    launches."""
    from antidote_ccrdt_tpu_torch.scripts import read_tier_demo

    on_card = torch.device(demo["dev"]).type == "cuda"
    with demo["tmp"]:
        run, rep, sup, workers = finish_tier_demo(demo)
    demo_s = run["exit_t"] - run["spawn_t"]
    if rep is None:
        raise AssertionError(f"23: read_tier_demo exited {run['rc']} with no report:\n{run['out'][-8000:]}")
    checks, victim = rep["checks"], rep["killed"]
    if not (run["rc"] == 0 and rep["pass"] and len(checks) == 11 and all(checks.values())):
        tail = run["out"][run["out"].find("FAIL"):] if "FAIL" in run["out"] else run["out"][-4000:]
        raise AssertionError(f"23: read_tier_demo exited {run['rc']}, failed "
                             f"{[k for k, ok in checks.items() if not ok]}, unavailable {(sup or {}).get('unavailable')}: "
                             f"{json.dumps(rep)[:3000]}\n{tail[:6000]}")
    survivors = [m for m in read_tier_demo.MEMBERS if m != victim]
    if not (victim == sup["victim"] == read_tier_demo.MEMBERS[2] and f"SIGKILL -> {victim} (mid-load)" in run["out"]
            and sup["kill_step"] >= READ_KILL_AT):
        raise AssertionError(f"23: no mid-load SIGKILL of {victim}: {sup}")
    if sorted(workers) != survivors:
        raise AssertionError(f"23: reports from {sorted(workers)}, survivors {survivors}")
    sc, cx = rep["session_certificate"], rep["violating_arm"]["counterexample"]
    if not (sc["ok"] and sc["n_reads"] > 0 and sc["n_writes"] > 0 and sc["n_violations"] == 0
            and rep["violating_arm"]["ok"] is False
            and any(v["session"] == "demo-violating" and v["origin"] == "w0" and v["have"] < v["want"]
                    for v in cx.values())):
        raise AssertionError(f"23: the certificates {sc}, {rep['violating_arm']}")
    got = survivors_launches(workers, "23", on_card)
    log("23 read tier", card=card, shape=READ_SHAPE, members=read_tier_demo.MEMBERS, kill_at_step=READ_KILL_AT,
        step_sleep_s=READ_STEP_SLEEP, bounds=READ_BOUNDS, killed=victim, kill_step=sup["kill_step"], checks=checks,
        reads_per_s=rep["fleet_reads_per_sec"], read_p99_ms=rep["read_p99_ms"], read_max_ms=rep["read_max_ms"],
        failover_blip_ms=rep["failover_blip_ms"], reads=rep["reads"], load_s=rep["load_s"], outcomes=rep["outcomes"],
        counters=rep["counters"], route_faults_fired=rep["route_faults_fired"], session_certificate=sc,
        violating_arm=rep["violating_arm"], per_worker=per_worker(workers),
        held={m: r["held"] for m, r in workers.items()}, kill_to_adoption_s=adoption_after_kill(workers, sup["kill_t"]),
        confirmed_dead={m: r["confirmed_dead"] for m, r in workers.items()},
        failover="routers read the supervisor's dead set at once", demo_s=demo_s,
        storm_end_to_exit_s=run["exit_t"] - sup["storm_t1"], launches=got, phase_s=time.perf_counter() - demo["t0"])
    return dict(dict.fromkeys(SOURCES, 0), **got)


def start_rtrace(torch, pool, dev: str = "cuda") -> dict:
    """Phase 24's demo, started in `pool` (`start_tier_demo`)."""
    (pre_s, post_s, window_s), (max_pct, min_cov, min_complete, max_blip_ms) = RTRACE_WINDOWS, RTRACE_BOUNDS
    return start_tier_demo(torch, pool, "rtrace_demo", dev, [
        "--shape", RTRACE_SHAPE, "--hold", "--steps", str(RTRACE_STEPS), "--step-sleep", str(RTRACE_STEP_SLEEP),
        "--storm-prekill-s", str(pre_s), "--storm-postkill-s", str(post_s), "--overhead-window-s", str(window_s),
        "--max-overhead-pct", str(max_pct), "--min-coverage", str(min_cov), "--min-complete-frac", str(min_complete),
        "--max-blip-ms", str(max_blip_ms)], RTRACE_TIMEOUT_S)


def rtrace_readings(rep: dict, rep_dir: str, victim: str, survivors: list) -> dict:
    """The port's ccrdt_rtrace over the demo's kept obs directory (no
    device), three reads at once: the waterfall of the report's
    dead_reroute trace must show a ``dead_reroute`` row at `victim`; the
    waterfall of a trace the spill holds that failed over (its hops: a
    dead_reroute at `victim`, then an attempt answered by a survivor; the
    report's trace may instead be a session read that the victim alone
    covered) must show that row and then the survivor's attempt; the
    attribution must name a p99 dominant bucket. Returns the documents and
    their seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from antidote_ccrdt_tpu_torch.obs import rtrace

    obs, t0 = os.path.join(rep_dir, "obs"), time.perf_counter()

    def failed_over(tr):
        hops = tr.get("hops", ())
        at = next((i for i, h in enumerate(hops) if h.get("k") == "dead_reroute" and h.get("peer") == victim), None)
        return at is not None and any(h.get("k") == "attempt" and h.get("ok") and h.get("peer") in survivors
                                      for h in hops[at + 1:])

    over = sorted(t["id"] for t in rtrace.scan_traces(obs) if t.get("outcome") == "ok" and failed_over(t))
    if not over:
        raise AssertionError(f"24: no stored trace fails over from {victim} to a survivor")
    with ThreadPoolExecutor(3) as pool:
        f_report = pool.submit(run_cli, "ccrdt_rtrace", "waterfall", obs, "--trace", rep["dead_reroute_trace_id"],
                               "--json")
        f_over = pool.submit(run_cli, "ccrdt_rtrace", "waterfall", obs, "--trace", over[-1], "--json")
        f_att = pool.submit(run_cli, "ccrdt_rtrace", "attribute", obs, "--json")
        report_rows = json.loads(cli_out(f_report.result(), "24 ccrdt_rtrace waterfall"))["waterfall"]
        over_rows = json.loads(cli_out(f_over.result(), "24 ccrdt_rtrace waterfall"))["waterfall"]
        att = json.loads(cli_out(f_att.result(), "24 ccrdt_rtrace attribute"))

    def reroute_at(rows):
        return next((i for i, r in enumerate(rows) if r["name"] == "dead_reroute" and r.get("peer") == victim), None)

    if reroute_at(report_rows) is None:
        raise AssertionError(f"24: no dead_reroute row at {victim} in {rep['dead_reroute_trace_id']}: {report_rows}")
    at = reroute_at(over_rows)
    if at is None or not any(r["name"] == "attempt" and r.get("ok") and r.get("peer") in survivors
                             for r in over_rows[at + 1:]):
        raise AssertionError(f"24: the failover waterfall {over[-1]}: {over_rows}")
    if att.get("p99_dominant_bucket") not in rtrace.BUCKETS:
        raise AssertionError(f"24: ccrdt_rtrace attribute names no p99 dominant bucket: {att}")
    return dict(report_waterfall=report_rows, failover_trace_id=over[-1], failover_traces=len(over),
                failover_waterfall=over_rows, attribute=att, cli_s=time.perf_counter() - t0)


def phase_rtrace(torch, card: str, demo: dict) -> dict:
    """Phase 24: the request-tracing gate. rtrace_demo whole as a
    subprocess (`start_rtrace`'s `demo`) at RTRACE_SHAPE, each worker's
    first kernel calls held: all 14 of the demo's checks at RTRACE_BOUNDS,
    the SIGKILL of the victim with the probe in flight, reports from
    exactly the three survivors, each survivor's launches of K1c, K2 and K3
    and its held calls equal to the plain versions, and the port's
    ccrdt_rtrace over the run's own spill (`rtrace_readings`). Returns the
    survivors' launches."""
    from antidote_ccrdt_tpu_torch.scripts import rtrace_demo
    from antidote_ccrdt_tpu_torch.topo import rendezvous_order

    on_card = torch.device(demo["dev"]).type == "cuda"
    victim = rendezvous_order("k0", rtrace_demo.MEMBERS)[0]  # the demo's victim
    survivors = [m for m in rtrace_demo.MEMBERS if m != victim]
    with demo["tmp"]:
        run, rep, sup, workers = finish_tier_demo(demo)
        if rep is None:
            raise AssertionError(f"24: rtrace_demo exited {run['rc']} with no report:\n{run['out'][-8000:]}")
        checks = rep["checks"]
        if not (run["rc"] == 0 and rep["pass"] and len(checks) == 14 and all(checks.values())):
            tail = run["out"][run["out"].find("FAIL"):] if "FAIL" in run["out"] else run["out"][-4000:]
            raise AssertionError(f"24: rtrace_demo exited {run['rc']}, failed "
                                 f"{[k for k, ok in checks.items() if not ok]}: {json.dumps(rep)[:3000]}\n{tail[:6000]}")
        if not (rep["killed"] == sup["victim"] == victim and f"SIGKILL -> {victim} (probe in flight)" in run["out"]):
            raise AssertionError(f"24: no SIGKILL of {victim} with the probe in flight: {sup}")
        if sorted(workers) != survivors:
            raise AssertionError(f"24: reports from {sorted(workers)}, survivors {survivors}")
        got_cli = rtrace_readings(rep, demo["rep_dir"], victim, survivors)
    demo_s = run["exit_t"] - run["spawn_t"]
    got = survivors_launches(workers, "24", on_card)
    att = sup["attribution"]
    log("24 request tracing", card=card, shape=RTRACE_SHAPE, members=rtrace_demo.MEMBERS, steps=RTRACE_STEPS,
        step_sleep_s=RTRACE_STEP_SLEEP, windows_s=RTRACE_WINDOWS, bounds=RTRACE_BOUNDS, killed=victim,
        kill_step=sup["kill_step"], checks=checks, traced_reads_per_s=rep["traced_reads_per_sec"],
        untraced_reads_per_s=rep["untraced_reads_per_sec"], overhead_pct=rep["overhead_pct"],
        overhead_pairs=sup["pairs"], overhead_calm_pairs=sup["calm_pairs"],
        coverage_p50=rep["coverage_p50"], coverage_p99_req=rep["coverage_p99_req"],
        buckets_ms_p50=att.get("buckets_ms_p50"), buckets_ms_p99=att.get("buckets_ms_p99"),
        total_ms_p50=att.get("total_ms_p50"), total_ms_p99=att.get("total_ms_p99"),
        p99_dominant_bucket=rep["p99_dominant_bucket"], exemplar_dominant_bucket=rep["exemplar_dominant_bucket"],
        n_sampled_ok=rep["n_sampled_ok"], complete_frac=rep["complete_frac"],
        failover_blip_ms=rep["failover_blip_ms"], outcomes=rep["outcomes"], storm_reads=rep["storm_reads"],
        load_s=rep["load_s"], rtrace_counters=rep["rtrace_counters"], route_faults_fired=rep["route_faults_fired"],
        dead_reroute_trace_id=rep["dead_reroute_trace_id"],
        cli_report_waterfall=[(r["name"], r.get("peer")) for r in got_cli["report_waterfall"]],
        failover_trace_id=got_cli["failover_trace_id"], failover_traces=got_cli["failover_traces"],
        cli_failover_waterfall=[(r["name"], r.get("peer")) for r in got_cli["failover_waterfall"]],
        cli_p99_dominant_bucket=got_cli["attribute"]["p99_dominant_bucket"], cli_s=got_cli["cli_s"],
        per_worker=per_worker(workers), held={m: r["held"] for m, r in workers.items()},
        kill_to_adoption_s=adoption_after_kill(workers, sup["kill_t"]),
        confirmed_dead={m: r["confirmed_dead"] for m, r in workers.items()},
        failover="routers read the supervisor's dead set at once", demo_s=demo_s,
        storm_end_to_overhead_s=sup["overhead_t0"] - sup["storm_t1"],
        storm_end_to_exit_s=run["exit_t"] - sup["storm_t1"],
        storm_s=dict(start=sup["storm_t0"] - run["spawn_t"], end=sup["storm_t1"] - run["spawn_t"]),
        overhead_window_s=dict(start=sup["overhead_t0"] - run["spawn_t"], end=sup["overhead_t1"] - run["spawn_t"]),
        launches=got, phase_s=time.perf_counter() - demo["t0"])
    return dict(dict.fromkeys(SOURCES, 0), **got)


def middle_phases(torch, card: str, root: str) -> tuple:
    """Phases 11-16 and 18-20 as main() runs them: ({path name: its
    launches}, 17's worlds, 21a's fleets); the worlds' checkpoints and
    the fleets' files stay in `root`, which the caller keeps until phase
    17 has read them. Worker processes run beside in-process phases that
    no wall clock gates: phase 18's fleets beside phases 11 and 16, 20b's
    topo_demo and then 21a's healthy and durability fleets beside phase 12
    and phase 19's fleets and law checks beside 14a (both drills on a
    simulated network that keeps virtual time), 17a's and 17b's worlds and
    then 19d's reads of 18a's spill beside 14c (the working set's
    ownership is fixed); phases 17, 18, 19, 20 and 21 read them. The
    fleets' sequential references are made beforehand: no kernel runs in
    this process beside a phase's counts. Phases 13 and 14 run without
    their reduced twins (main() runs 13's beside phase 24's start-up and
    14's beside phase 22's reap)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest

    out = {}
    elastic_refs = elastic_references(torch, "cuda")
    with ThreadPoolExecutor(3) as beside, tempfile.TemporaryDirectory() as spill:  # 18a's drill, read again in 19d
        worlds_root, fleets_root = os.path.join(root, "worlds"), os.path.join(root, "fleets")
        os.makedirs(worlds_root)
        f_elastic = beside.submit(phase_elastic, torch, card, spill, elastic_refs)
        out["durable host (phase 11)"] = phase_durable_host(torch, card)
        out["mesh (phase 16)"] = phase_mesh(torch, card)
        out["elastic workers (phase 18)"], drill = f_elastic.result()
        cert_reference = reference_digest("topk_rmv", device="cpu")

        def topo_then_cert_fleets():
            return run_topo("cuda"), run_cert_fleets("cuda", cert_reference)

        f_12 = beside.submit(topo_then_cert_fleets)
        out["gossip (phase 12)"] = phase_gossip(torch, card)
        out["served fleet (phase 13)"] = phase_fleet(torch, card)
        f_fleets = beside.submit(run_obs_fleets, "cuda", fleets_root, demo_reference_crc(torch))

        def worlds_then_spill_reads():
            return run_worlds("cuda", worlds_root), spill_reads(drill, spill)

        f_14c = []
        out["overlap and pager (phase 14)"] = phase_overlap_pager(
            torch, card, before_14c=lambda: f_14c.append(beside.submit(worlds_then_spill_reads)))
        out["bridge (phase 15)"] = phase_bridge(torch, card)
        worlds, reads = f_14c[0].result()
        out["observability fleets (phase 19)"] = phase_observability(torch, card, drill, f_fleets.result(), reads)
        del drill
        topo, cert_fleets = f_12.result()
        out["anti-entropy gates (phase 20)"] = phase_antientropy(torch, card, topo)
    return out, worlds, cert_fleets


def main() -> int:
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, ROOT)
    import torch

    import antidote_ccrdt_tpu_torch  # noqa: F401  (fails outside the repository)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = phase_device(torch)
    phase_build()
    rows, device_jobs = phase_kernels(torch)
    launches, rp, gen = phase_main_path(torch, card)
    phase_profile(torch, rp, gen.next_batch(B, BR))
    del rp, gen
    log("device times", **{label: device_ms(torch, fn, kernel) for label, fn, kernel in device_jobs})
    del device_jobs
    phase_identity(torch)
    bm_launches, rows["sort_slots_wide"], rows["sort_slots_9_16"] = phase_batch_merge(torch, card)
    launches["sort_slots_wide"] = bm_launches["sort_slots_wide"]
    launches["sort_slots_9_16"] = bm_launches["sort_slots"]  # the converter's call, W = M = 13
    launches["sort_slots_global"], rows["sort_slots_global"] = phase_wide_rows(
        torch, card, WIDE_M, "global_launches")
    launches["sort_slots_block"], rows["sort_slots_block"] = phase_wide_rows(
        torch, card, BLOCK_M, "block_launches")
    phase_many_rows(torch, card)
    topk_rmv, coalesced = phase_coalesced(torch, card)
    laws = phase_monoid(torch, card, topk_rmv)
    del topk_rmv
    with tempfile.TemporaryDirectory() as root, ThreadPoolExecutor(1) as pool:  # root: 17's worlds
        mid, worlds, cert_fleets = middle_phases(torch, card, root)
        # Phases 22 and 23, each demo's storm with nothing beside it (three
        # of their checks read the wall clock), phase 17 and then phase 14's
        # reduced twin beside 22's reap and phase 21 beside 23's (the
        # survivors' detector, adoption and final barrier, which no check
        # times). 23 starts once 22's demo has exited.
        write = start_write_tier(torch, pool)
        storm_over(write)
        mid["multihost (phase 17)"] = phase_multihost(torch, card, worlds)
        overlap_pager_reduced(torch, card)
        mid["write tier (phase 22)"] = phase_write_tier(torch, card, write)
        read = start_read_tier(torch, pool)
        storm_over(read)
        mid["certified convergence (phase 21)"] = phase_certified(torch, card, cert_fleets)
        mid["read tier (phase 23)"] = phase_read_tier(torch, card, read)
        del worlds, cert_fleets
        # Phase 24 once 23's demo has exited: phase 13's reduced twin beside
        # its start-up, which must end before the storm begins; the storm,
        # the wait for the survivors' finals and the overhead window with
        # nothing beside them (five checks read the wall clock).
        tracing = start_rtrace(torch, pool)
        t0 = time.time()
        fleet_reduced(torch, card)
        t1 = time.time()
        sup = storm_over(tracing)
        if sup is not None:
            if t1 > sup["storm_t0"]:
                raise AssertionError(f"24: phase 13's reduced twin ran {t1 - sup['storm_t0']:.1f} s into the storm")
            log("24 start-up", card=card, beside="13 reduced", twin_s=t1 - t0,
                twin_end_to_storm_s=sup["storm_t0"] - t1)
        mid["request tracing (phase 24)"] = phase_rtrace(torch, card, tracing)
    # `launches` is the count of the path that drives the kernel first
    # (the main path, phase 4, for K1, K1c, K2 and K3 at W <= 8); every
    # path's own count, each read from 0, is in `launches_by_path`.
    first_path = {"sort_slots_9_16": "batch_merge (phase 7)", "sort_slots_wide": "batch_merge (phase 7)",
                  "sort_slots_block": "wide rows (phase 8)", "sort_slots_global": "wide rows (phase 8)"}
    by_path = {name: {first_path.get(name, "replay (phase 4)"): launches[name]} for name in SOURCES}
    for path, got in (("coalesced replay (phase 9)", coalesced), ("merge laws (phase 10)", laws), *mid.items()):
        for name, n in got.items():
            by_path[name][path] = n
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             launches_by_path=by_path[name], **rows[name])
        for name, (src, rep) in SOURCES.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
