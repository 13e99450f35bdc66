#!/usr/bin/env python3
"""Chip smoke for the torch port: the `torch://` main path on one CUDA card.

    python3 chip_smoke.py        (from the repository root; needs one card)

Drives the port's serving path at full size — the multitenant-1m
deployment (`models/workloads.py multitenant_1m()` with its defaults:
1,000,000 tuples, 200,000 pods, 50,000 users) loaded into
`create_endpoint("torch://")` — and checks it:

1. card identity (torch device name, the nvidia-smi name/power-limit line);
2. build: the CUDA kernels compiled from ops/kernels/csrc for sm_90a;
3. load: workload generation, store load, device graph build;
4. lookups: `lookup_resources_batch("pod", "view", 256 subjects)` batches;
5. checks: `check_bulk_permissions` over 10,000 (pod, subject) pairs;
   every read kernel (all but `scatter_rows`) must have launched during
   phases 4-5, and no standalone `sweep_delta`, `check_gather` or
   `check_gather3`: the checks ride every sweep's tail,
   `sweep_delta_checks` (also asserted for phases 10, 16, 20, 22, 23);
6. kernels against their plain-torch twins, on the card, on the real
   1M-row tables: every step of two real sweeps, the seed, the delta, the
   check gather, the fused check tail `sweep_delta_checks` (delta pair,
   packed answers and their pinned host copy; its answers against the
   standalone gather, the cache's replayed `checks_device` against the
   same, a warm check batch's launches and readbacks, (b) also from
   event nodes inside a graph) and the lookup transpose, bit for bit;
   then one whole
   lookup batch re-run on the CPU twins (state, trace and words equal)
   and launched step by step (equal to its CUDA graph replays), and a
   warm endpoint batch that must be one graph replay and one readback a
   sweep, its launch counts those of the steps; each sweep kernel's
   launches and the whole sweep, step by step and replayed, timed by
   `attribute`;
7. answers against the host oracle on a fixed-seed sample (4 full
   lookups, 2,000 checks);
8. the sweep byte model and the bound it implies at this card's peak;
9. the write path on the same endpoint: 16 rounds of churn (64 pod
   creates on spare rows, 32 pod deletes that reclaim them, 16 hub-group
   touches and 8 deletes, 2 grants that grow a full namespace row), each
   followed by a 256-lane lookup batch and a 10,000-pair check batch that
   read the round's writes; every kernel, `scatter_rows` included, must
   have launched during the rounds (each round's first batch recaptures
   the sweep graphs, whose host cost is logged).  No rebuild may happen;
   after every flush
   the card's tables equal the host's; `scatter_rows` is held against its
   twin on one round's real dirty rows (duplicates added); a batch
   captured before a round's writes extracts its old answers after the
   flush; the post-churn answers equal those after `force_rebuild()` and
   a sample of the host oracle's;
10. the caveated deployment on a second endpoint: the reference's
   caveated RBAC-with-deny workload (`caveated_rbac()`) at the users,
   groups and pods of multitenant-1m, whose undecidable caveats put the
   graph on the tri-state (definite/maybe bitplane) path.  Its read
   batches (256-lane lookups, 10,000-pair checks) must answer CONDITIONAL
   somewhere and route nothing to the oracle; every step of a real Jacobi
   sweep, the plane seed, `check_gather3` and the definite-half lookup
   must equal their twins on the full tables, and one whole batch must
   equal the CPU twins' and its step-by-step launch (the graph checks
   and `attribute` timings of phase 6, on the Jacobi sweep); a sample of checks (CONDITIONAL ones included)
   and one lookup must equal the host oracle's; then 8 rounds of caveat
   churn (new undecidable memberships, re-touches that flip decidability,
   deletes, caveated tuples made definite) must be absorbed without a
   rebuild, leave the card's tables equal to the host's after each
   flush, and answer as `force_rebuild()` and the oracle do.  Every kernel
   of the caveat path (all but the definite `check_gather`) must have
   launched during phase 10.
11. the segment kernel on the phase-3 store, before phase 10 frees the
   ELL endpoint: `create_endpoint("torch://", kernel="segment",
   store=...)`.  Its 256-lane lookup and 10,000-pair check batches must
   answer every lane and pair as the ELL endpoint does, and every kernel
   of the segment path (`edge_or` and the seed, permission, delta, check
   and lookup kernels) must have launched in them; `edge_or` is held
   against its twin on the full edge arrays (padding edges in), one real
   sweep step by step, one whole batch on the CPU twins; then 4 rounds
   of phase 9's churn through the shared store: no rebuild, the card's
   edge arrays equal the host's after each flush, `scatter_rows`
   launched from the segment flush, both endpoints' answers equal;
12. the Leopard index at the reference's group-explosion deployment
   (`group_explosion()` defaults: 100,000 groups in depth-8 chains,
   2,000 users, 5,000 docs): an indexed endpoint (A) and an index-free
   one (B) on one store.  `doc#view` must be indexed (and nothing at
   multitenant-1m, over the budget); A's read batches must be served
   from the closure plane (`check_gather` and `word_cols_T`, no sweep
   kernel) and equal B's and a sample of the oracle's; B's staged sweep
   over the chains is held against the twins step by step and against
   its step-by-step launch; the plane kernels are held against their
   twins on the full plane; then 4 rounds of the
   reference bench's tail-user moves (quarantine, background re-close),
   after which `wait_rebuilds()` leaves `doc#view` indexed and A serving
   from the plane again.

13. the mesh path: a 2 x 4 (data x graph) mesh over the visible cards
   (`cuda:0` repeated when fewer than eight are visible), each phase run
   while the deployment it reuses is alive.  (a) `TorchEndpoint(mesh=...)`
   on the phase-3 store: its 256-lane lookup and 10,000-pair check
   batches must answer as the single-device endpoint, every per-shard
   kernel must have launched in them, the all_gathers must move
   `comm_model`'s bytes per sweep, the seed and two sweeps must equal the
   twins shard by shard and a whole batch on the twins (on the card
   tensors) the kernels'; then 4 rounds of phase 9's churn: no rebuild,
   every table block of every data replica equal to the host table
   after each flush, `scatter_rows` launched by the sharded flush, answers
   equal the single-device endpoint's.  (b) `ShardedKernel` (the
   edge-sharded segment sweep) on the segment endpoint's program and
   edges: answers equal that endpoint's, `or_combine` (one launch a data
   shard, its 4 replicas) equal its twin on a real sweep's partials and
   timed beside the library chain (3 `bitwise_or_` + 3 `copy_`).  (c)
   the caveated deployment of phase 10 on a mesh endpoint: tri-state
   answers (CONDITIONAL included) equal the
   single-device endpoint's, nothing routed to the oracle, the block-form
   `cav_gather_or` launched and the sweep equal to the twins.  (d)
   group-explosion of phase 12 on a mesh endpoint with the index on:
   `doc#view` indexed in one plane block per graph shard, reads served
   from it with no sweep kernel, answers equal A's.

14. batched dispatch, BASELINE config 5, on the phase-3 endpoint wrapped
   in the port's `BatchingEndpoint` (phases 1-13 build their endpoints
   with `dispatch=direct`, the bare endpoint whose internals they read).
   (a) 256 concurrent `lookup_resources` calls, one a user, must answer
   as one direct 256-lane batch in fewer than 256 kernel calls, fused
   batches of more than one; (b) 64 concurrent `check_bulk_permissions`
   calls (10,000 pairs) interleaved with 256 concurrent lookups must
   answer as the direct endpoint; every read kernel must launch in (a)-(b)
   (counts from zero), and a fixed-seed sample equals the oracle; (e) one
   pinned side-stream readback ran for every fused lookup batch and none
   for a fused check batch (its answers come back with its last sweep,
   equal to `check_gather` on the converged state), and the readback's
   bytes
   equal a blocking copy of the same result; (c) (a) and (b) at pipeline
   depth 1 and 2 and through the direct endpoint, 3 runs each: median
   wall, per-request p50/p99 and batch counts, beside the `nvidia-smi`
   line; (d) a lookup and a check batch started before a round of phase
   9's churn and finished after its flush and sweep-graph recapture keep
   their pre-write answers.

15. off-loop rebuilds (the port's ASYNC_REBUILD switch, which phases 1-14
   keep off: each asserts that its churn rebuilds nothing) on the phase-3
   store.  (a) a fresh endpoint's `warm_start(prewarm=True)`: its seconds,
   the lane buckets warmed and the captures made; its first 256-lane
   lookup and 10,000-pair check batches run no eager sweep, make no
   capture and answer as the phase-3 endpoint; (b) unique-name pods
   created at ~200 a second past the pod spare pool while a reader thread
   issues 256-lane pod#view lookup batches, switch on (one preemptive
   background rebuild, no quarantine) and off (the pool runs dry and a
   read waits out the rebuild): the reader's p50/p99/max, the lock-held
   install and the card's memory before, at its peak during and after
   the swap; (c) more new tenants in one write than the tenant pool
   holds: pod#view quarantined to the oracle (checks) while the held
   candidate waits and group#member still on the kernel, then after the
   swap no quarantine, the card's tables equal the host's, the answers
   equal `force_rebuild()`'s and the oracle's; (d) launches from zero
   over one background swap whose candidate is prewarmed and replays
   writes at its install: every read kernel and `scatter_rows`.  The
   mesh endpoint of 13a and the caveated endpoint of 10 each take one
   background swap, after which their answers equal the single-device
   endpoint's and the oracle's.
16. the proxy's read path (`proxy/server.py` `ProxyServer`) over
   `torch://` at multitenant-1m, on its own endpoint built from the
   phase-3 workload and warm-started with the prewarm, in front of a
   fake kube-apiserver with 2,000 namespaces, 10,000 pods and 1,000
   events, with deploy/rules.yaml's read rules: 256 concurrent pod lists
   (BASELINE config 5 through the proxy), 1,000 pod gets, an events
   postfilter list, a protobuf and a Table list and the e2e tests' watch
   scenario, all through the embedded client.  Lists equal the seeded
   pods intersected with the endpoint's lookup (8 users: the oracle's),
   gets the oracle's checks; no read goes to the oracle; every read
   kernel launches for these requests, which rebuild nothing.  Logged:
   the lists' per-request p50/p99/max and wall, the proxy's own time
   (request less upstream), the upstream round trip, the prefilter and
   the largest wait on it, beside a direct 256-lane batch; the gets'
   p50/p99, the launches, the card's memory; with h11 installed also one
   list over a loopback socket.

Wherever `lookup_T` and `scatter_rows` are timed (phases 6, 9, 10, 11,
13a), their rows also carry the device-only time, the time with L2
flushed and the host cost per call, of the kernel and of its library
yardstick (`attribute`), so that a gap between the event-timed loops is
put down to the card or to the host.

17. dual writes and the command line.  (a) On phase 16's proxy, after
   `enable_dual_writes()` with a SQLite journal and with the workflow
   worker started (as `ProxyServer.start()` starts it), deploy/rules.yaml's
   pod-launch and pod-retire shapes on multitenant-1m: 256 concurrent
   pod creates (one a list user of phase 16, in a namespace it may
   view), each user's list of that namespace showing its new pod, 8
   pairs of racing creates of one name (one 201, one 409 each), one
   create through a `panicKubeWrite` crash, and every new pod deleted,
   256 at once; the store's new creator tuples equal the fake's new
   pods and the set asked for, none is left after the deletes, the
   journal has nothing pending, a sample of (user, new pod) checks
   equals the oracle, and `scatter_rows` and every read kernel launched
   in the proxy's traffic (the oracle sample's launches left out).
   Logged: each burst's wall and per-request p50/p99/max, the
   read-after-write lists', the endpoint's rebuild, spare-row and
   write-path counters, the lock/workflow/activity tuples, the card's
   memory.  (b) `python3 -m spicedb_kubeapi_proxy_tpu_torch` with no
   endpoint flag (the default `torch://`), a kubeconfig to the port's
   fake apiserver on a loopback socket, deploy/rules.yaml,
   deploy/bootstrap.yaml and a SQLite journal: /readyz, ada's list, create (201), list, delete, list,
   mallory's list, then SIGTERM: exit 0 with no traceback, the serving
   line naming the card; then `entry.entry()` on the card equal to the
   CPU's.

18. the decision cache and device telemetry, between 17 (a) and (b), on
   phase 16's store and fake apiserver: a second `ProxyServer` over
   `torch://?cache=1` (the cache above the batched dispatcher).  (a) The
   256 concurrent lists of phase 16 twice: the first all misses, the
   second all hits with no kernel launched, both bursts' lists equal to
   each other and, for phase 16's oracle sample, to the oracle over the
   fake's pods.  (b) A `workflow:` tuple that expires 1.5 s later leaves
   every list entry valid; its own check is a hit until the store clock
   passes the expiry, then a miss answering NO; a namespace grant makes
   its user's next list miss and answer the new set.  (c) The HBM
   ledger's bytes lie between the graph tables' storage and
   `torch.cuda.memory_allocated()`; after `force_rebuild()` the
   outgoing generation's rows read 0.  (d) The cold burst's
   kernel.device seconds of `authz_kernel_time_seconds` (its batches'
   seeds and sweeps on the card) agree within 10 % with the smoke's own
   CUDA events, recorded inside the seed and sweep graphs that the
   phase's endpoint captured and read after each replay of the burst
   (none of the burst's sweeps may run outside a graph), and the
   workload plane's measured sweep depth of pod#view is the trace's.
   (e) The timeline's roofline fraction over the burst lies in (0, 1]
   against the card's 3,350 GB/s, and its chrome trace holds
   device-track slices.  (f) `/debug/flight`, `/debug/timeline`,
   `/debug/workload` and `/debug/profile?seconds=1` answer 200 through
   the proxy and 401 without a user.  Logged: each burst's wall and the
   proxy's own time, the cache's counters and bytes, the ledger against
   `memory_allocated`, and the first 64 lists of phase 16's burst twice
   more on its proxy, with
   the DEVICE_TELEMETRY, TIMELINE and KERNEL_INTROSPECT switches on and
   then off (the telemetry's cost, reported, not enforced; phase 14
   times its (a) burst on the batched and the direct endpoint the same
   way, interleaved DISPATCH_REPEATS times).

19. the durable store and WAL-shipping read replication at multitenant-1m
   (phase 3's workload, uncut) over phase 16's fake apiserver, between
   18 and 17 (b).  (a) A leader `ProxyServer` over `torch://` with a
   `data_dir` and `wal_fsync="always"`, deploy/rules.yaml's read and
   dual-write shapes: the workload bulk-loaded (one snapshot record, its
   sidecar fsynced before it), a warm start with the prewarm, a
   checkpoint, then 16 rounds of 64 pod-churn writes through the
   endpoint and 64 dual-write creates through the proxy as the WAL tail.
   Logged: the journaled load's seconds, the checkpoint's and how long
   it held the store lock, the WAL's records and bytes, the durable
   writes' p50/p99 beside phase 9's in-memory ones.  (b) A dual write
   left pending by a crash in its SpiceDB write, then `walAfterAppend`
   on one more write and the leader abandoned without `stop()`; a fresh
   `ProxyServer` on the data dir recovers (checkpoint + tail, the
   bootstrap skipped) to the last journaled revision, its read-set
   equal to the pre-crash store's, warm-starts once, and its 256-lane
   lookup and 10,000-pair check batches equal the pre-crash endpoint's
   and a sample of the oracle's; its restarted worker completes the
   pending instance once and leaves nothing pending.  Logged: the
   recovery split, the warm start, the first batch, the card's memory.
   (c) `python3 -m spicedb_kubeapi_proxy_tpu_torch --data-dir D
   --wal-fsync always` on deploy/'s files: a create (201), SIGKILL, a
   restart on D that lists the pod with the revision continuing, SIGTERM
   to exit 0.  (d) A follower `ProxyServer` (`replicate_from`, through
   an in-process transport to (b)'s leader) bootstraps from the 1M-tuple
   checkpoint (read-set equal to the leader's) and warm-starts; then 16
   rounds of 64 writes on the leader while it tails, each followed by a
   256-lane lookup batch, a 10,000-pair check batch and 8 proxied lists
   with X-Authz-Min-Revision on the follower, equal to the leader's,
   served locally; every read
   kernel and `scatter_rows` launch on the follower, and no read goes to
   the oracle.  Logged: the bootstrap's split, commit-to-apply lag
   p50/p99/max, the read-after-write batch against the follower's warm
   median (printed, not enforced), the follower's launches and rebuilds,
   both endpoints' HBM ledger bytes, one list over a loopback socket.
   (e) The follower paused while the leader checkpoints (reclaiming the
   segment it tails) and writes on: its next pass re-bootstraps
   (`replica_reset`), the next read rebuilds the graph on the card
   synchronously (its latency logged) and answers as the leader.
20. leader failover at multitenant-1m on phase 19's leader (b) and
   follower (d), right after 19.  (a) The leader acknowledges 32 pod
   creates it never ships and dies (its transport dead); the follower is
   promoted through `POST /replication/promote` (timed: the epoch mint,
   the persistence open and attach, the anchor checkpoint, the hub
   attach; and promotion to the first acknowledged write), then takes 16
   rounds of 64 journaled writes, each followed by a 256-lane lookup
   batch and a 10,000-pair check batch: no rebuild, nothing routed to the
   oracle, every read kernel and `scatter_rows` launched, the last
   batches equal to a fixed-seed oracle sample.  (b) The old leader comes
   back: a poll carrying the new incarnation fences it (its create
   answers 503, its list 200), `demote_and_rejoin` collects its
   unshipped tail, resets its store and graph from the new leader's
   checkpoint and replays the tail; every acknowledged write of both
   nodes holds on both, and its first read after the reset (a
   synchronous rebuild) and the next equal the new leader's.  (c) The
   rejoined node relays the log from a mirror (`FanoutHub`, re-bootstrap
   into it) to a leaf `torch://` follower, which bootstraps from the
   mirror; 8 rounds of writes on the new leader: per-hop lag p50/p99,
   the leaf's read-after-write against its warm median, its batches
   equal to the leader's and its last ones to an oracle sample.  (d) The
   election: a leader and two followers with `promote_on_leader_loss`
   over `replica_peers` on a small multitenant store, one follower
   ahead; the leader dies, the one ahead promotes itself and the other
   repoints to it, both within the 10 s flight window.  Every read
   kernel and `scatter_rows` must launch on (a) and (c)'s leaf, every
   read kernel on (b).

21. tuple-space sharding at full width, after 20: a `ProxyServer` with
   `shards=2` on `torch://` and a data dir, shard 0 holding multitenant-1m
   uncut and shard 1 the reference bench's configmap and secret classes
   (200,000 of each over 2,000 namespaces of each kind, ~404,000 tuples),
   each shard its own graph on the card (`shard_path`).  (a) Each graph's
   build and prewarm, the HBM ledger against the memory allocated; (b) a
   burst of 32 pod lists and 32 configmap lists, each shard's dispatcher
   serving its own type, every list equal to the oracle over both shards'
   tuples; (c) 32 pod and 32 configmap dual writes at once through the
   worker, each on its owning shard, vector tokens read back, the vector
   gate, `scatter_rows` on each graph; (d) a 10,000-pair mixed bulk
   check in request order, an untyped read fanning out, a spanning batch
   refused, a merged watch, and a background rebuild of shard 1 (its
   candidate capturing sweep graphs) while shard 0 serves a pod burst;
   (e) the proxy dropped without a final checkpoint and recovered on its
   data dir, both graphs warm-started; (f) a spanning map refused before
   any graph is built; (g) two `python -m` shard leaders behind a
   `--shard-leaders` router process, and `--lint-schema-json`
   (`shard_cli`).  Every read kernel and `scatter_rows` must launch in
   (b)-(d).
22. the remote endpoint, between 18 and 19, on phase 16's batched
   `torch://` endpoint (multitenant-1m, uncut), served by the port's
   `PermissionsGrpcServer` with a bearer token (`remote_path`).  Its
   `transport` line says `grpc` (grpcio importable: a loopback gRPC
   server and four `RemoteEndpoint` clients) or `in-process` (the seven
   handlers called directly, requests and answers through the port's
   wire codecs).  REMOTE_CLIENTS x REMOTE_LOOKUPS concurrent
   namespace#view LookupResources fuse on the server (fewer fused
   batches than RPCs) and equal one direct 256-lane batch and the
   oracle; one pod#view LookupResources (thousands of ids, one stream
   message each) is timed against the direct call; a 10,000-pair
   CheckBulkPermissions equals the direct bulk check; REMOTE_WRITES
   WriteRelationships move the revision by one each, a ReadRelationships
   returns them, a DeleteRelationships takes them back, a Watch sees
   them; with grpc a wrong token gets UNAUTHENTICATED and `python3 -m
   spicedb_kubeapi_proxy_tpu_torch.permsd --spicedb-endpoint torch://`
   on deploy/'s bootstrap answers a check and exits 0 on SIGTERM;
   without it permsd and `grpc://` fail with the "requires grpcio"
   message.  Every read kernel and `scatter_rows` launch.
23. the fleet plane, after 21's (f), on its per-shard lineages
   (`fleet_path`): two `python3 -m spicedb_kubeapi_proxy_tpu_torch
   --spicedb-endpoint torch:// --data-dir <lineage>` shard-leader
   processes, each with its own CUDA context and graph on the card
   (shard 0 multitenant-1m, shard 1 the configmap and secret classes),
   a `--shard-leaders ... --fleet-peers ...` router process and phase
   21's fake kube-apiserver on a loopback socket, managed by the port's
   `ProcessFleet`.  The port's `OpenLoopRunner` offers FLEET_RATE
   requests a second (lists and checks, FLEET_MIX, zipfian users) for
   FLEET_WINDOW_S through the router; then the router's /debug/fleet
   must assemble most of its sampled list traces across the router and
   a leader (each child inside its hop span, the tier sums equal to the
   root latency), /debug/tail's deltas must sum to its gap, a sample of
   lists must equal the oracle, each leader's /metrics must show kernel
   launches, and authz_loadgen_lag_seconds must be exported; a second
   window kills leader 1 with SIGKILL, and /debug/fleet still answers
   with that member's error; the others exit 0 on SIGTERM.
24. a mesh across processes, after 13a-b, on the phase-3 store
   (`distributed_path`): `torch://?distributed=1&mesh=1x2` in a one-rank
   process group that the phase sets up (a loopback coordinator,
   NUM_PROCESSES=1, PROCESS_ID=0; NCCL for the card's tensors), both
   shards on the card.  Before and after a churn round its lookups and
   checks must equal the single-device endpoint's and an oracle sample,
   every sweep must make one delta all-reduce and every batch one
   readout all-reduce; `mesh_sweep` holds its kernels against their
   twins call by call, and the readout's `check_gather` and `lookup_T`
   are held against theirs on the final state.  The cross-rank calls and
   bytes are logged; the process group is destroyed before phase 14.

25. the port's own differential fuzz (`spicedb_kubeapi_proxy_tpu_torch.
   fuzz`), last (`fuzz_path`): its 31 fixed cells — the 3 x 3 gate x
   replication-role matrix, two `sharded2`, two `mesh` (2 x 2, co-located
   on the card) and two `leopard` cells — replayed through `torch://`
   endpoints on the card against the host oracle: zero divergences, every
   matrix cell twice or more, and the ELL, segment, mesh and Leopard
   kernels launched (counts from zero, printed per cell and per kernel);
   then the `wildcard-plane-skipped` mutation must be caught by the fixed
   seeds, and its shrunk artifact must diverge on replay under it and
   replay clean without it.

Phase 19 (a) parses its 1M-tuple text through the native bulk parser
(native/fastparse.cpp, built by g++ beside the kernels' nvcc in phase 2)
and holds a 100,000-line slice against `_from_text_py`.

Phases run in the order 1-9, 11, 13a-b, 24, 14, 15, 10, 13c, 12, 13d, 16,
17a, 18, 22, 19, 20, 21, 23, 21 (g), 17b, 25, and each phase's seconds are
logged.  Any failed phase raises and the script
exits non-zero.  The second-to-last line is the kernel table as JSON,
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import Optional

SEED = 20261017
N_WARM = 5              # warm batches per verb (medians over these)
LOOKUP_LANES = 256      # concurrent list subjects per lookup batch
N_CHECKS = 10_000       # (pod, subject) pairs per check batch
ORACLE_LOOKUPS = 1       # full oracle lookups of phase 7 (~60 s each)
ORACLE_CHECKS = 2_000
REPS = 10               # timing repetitions per kernel measurement
ATTR_CALLS = 50         # calls per device-only / host-cost measurement
L2_FLUSH_BYTES = 256 << 20   # scratch written before each cold call (> 5 x L2)

# phase 9, the write path (per round)
N_ROUNDS = 16
ROUND_CREATES = 64      # new pods, each dual-written (namespace + creator)
ROUND_DELETES = 32      # pods created two rounds earlier, both tuples
ROUND_GROUP_TOUCHES = 16
ROUND_GROUP_DELETES = 8
ROUND_GRANTS = 2        # namespace viewer grants on one namespace
ISOLATION_ROUND = 8
CHURN_ORACLE_CHECKS = 500
CHURN_ORACLE_PODS = 2_000   # pods outside a lookup the oracle checks too

# phase 10, the caveated deployment: caveated_rbac at multitenant-1m's
# users, groups and pods; the generator's own caveat mix and seed
CAVEAT_WORKLOAD = {"n_pods": 200_000, "n_users": 50_000, "n_groups": 2_000}
CAV_ROUNDS = 8
CAV_NEW = 16            # new undecidable memberships per round
CAV_RETOUCH = 8         # re-touches flipping decided <-> undecidable
CAV_DELETES = 8         # deletes of caveated tuples
CAV_DEFINITE = 4        # caveated tuples replaced by definite ones
CAV_ORACLE_CHECKS = 1_000
CAV_ORACLE_CONDITIONAL = 200
CAV_CHURN_ORACLE = 300

# phase 11, the segment kernel at multitenant-1m: churn rounds of phase
# 9's generator through the shared store
SEG_ROUNDS = 4
# phase 12, the Leopard index at group-explosion (its defaults: 100,000
# groups in depth-8 chains, 2,000 users, 5,000 docs)
LEO_ROUNDS = 4
LEO_ORACLE_LOOKUPS = 4
LEO_ORACLE_CHECKS = 500
# phase 13, the mesh path: a 2 x 4 (data x graph) mesh on every deployment
# above; churn rounds of phase 9's generator on its multitenant-1m endpoint
MESH_DATA, MESH_GRAPH = 2, 4
MESH_ROUNDS = 4
# phase 14, batched dispatch on the phase-3 endpoint: BASELINE config 5's
# 256 concurrent list requests, then mixed traffic with 64 concurrent
# check calls, each dispatch mode run DISPATCH_REPEATS times (3 since
# phase 19 joined the smoke, 2 since phase 21 did: the direct runs are
# most of the phase)
DISPATCH_CHECK_CALLS = 64
DISPATCH_REPEATS = 2
DISPATCH_ORACLE_CHECKS = 300
DISPATCH_ORACLE_SUBJECTS = 2    # lookups held against oracle checks
DISPATCH_ORACLE_PODS = 100      # allowed, and as many refused, pods each
# phase 15, off-loop rebuilds on the phase-3 store: unique-name pods
# created past the spare pool (pool + OFFLOOP_EXTRA_PODS a run, in writes
# of one pod, OFFLOOP_WRITE_PODS of them every OFFLOOP_WRITE_GAP_S: ~200
# pods/s, so the 25 % low watermark leaves a rebuild ~4 s of headroom),
# then more new tenants in one write than the tenant pool holds
OFFLOOP_EXTRA_PODS = 400
OFFLOOP_WRITE_PODS = 8
OFFLOOP_WRITE_GAP_S = 0.04
OFFLOOP_EXTRA_TENANTS = 16
OFFLOOP_ORACLE_CHECKS = 100
OFFLOOP_SWAP_ORACLE = 200   # oracle checks after the 13a / 10 swaps
# phase 16, the proxy's read path at multitenant-1m: the fake
# kube-apiserver's seeded objects, the traffic, and deploy/rules.yaml's
# read rules as mappings (proxyrule.parse_doc needs no yaml, which the
# card machine may lack; a CPU test holds them equal to the file's)
PROXY_NAMESPACES = 2_000
PROXY_PODS = 10_000         # the north star's 10k-pod list
PROXY_EVENTS = 1_000
PROXY_LIST_USERS = 256      # BASELINE config 5, through the proxy
PROXY_GETS = 1_000
PROXY_ORACLE_USERS = 8
_RULE = {"apiVersion": "authzed.com/v1alpha1", "kind": "ProxyRule"}
PROXY_READ_RULES = [
    {**_RULE, "metadata": {"name": "namespace-read"},
     "match": [{"apiVersion": "v1", "resource": "namespaces",
                "verbs": ["get"]}],
     "check": [{"tpl": "namespace:{{name}}#view@user:{{user.name}}"}]},
    {**_RULE, "metadata": {"name": "namespace-enumerate"},
     "match": [{"apiVersion": "v1", "resource": "namespaces",
                "verbs": ["list", "watch"]}],
     "prefilter": [{"fromObjectIDNameExpr": "{{resourceId}}",
                    "lookupMatchingResources": {
                        "tpl": "namespace:$#view@user:{{user.name}}"}}]},
    {**_RULE, "metadata": {"name": "pod-read"},
     "match": [{"apiVersion": "v1", "resource": "pods", "verbs": ["get"]}],
     "check": [{"tpl": "pod:{{namespacedName}}#view@user:{{user.name}}"}]},
    {**_RULE, "metadata": {"name": "pod-enumerate"},
     "match": [{"apiVersion": "v1", "resource": "pods",
                "verbs": ["list", "watch"]}],
     "prefilter": [{"fromObjectIDNamespaceExpr":
                    "{{split_namespace(resourceId)}}",
                    "fromObjectIDNameExpr": "{{split_name(resourceId)}}",
                    "lookupMatchingResources": {
                        "tpl": "pod:$#view@user:{{user.name}}"}}]},
    {**_RULE, "metadata": {"name": "event-postfilter"},
     "match": [{"apiVersion": "v1", "resource": "events",
                "verbs": ["list"]}],
     "postfilter": [{"checkPermissionTemplate": {
         "tpl": "namespace:{{namespace}}#view@user:{{user.name}}"}}]},
]
# phase 17 (a), dual writes on phase 16's proxy: deploy/rules.yaml's
# pod-launch and pod-retire shapes on multitenant-1m's schema (its pods
# have a namespace and a creator, and no viewer fan-out), one create a
# list user of phase 16, pairs of racing creates of one name, one create
# through a crash, then every new pod deleted
DUALWRITE_RULES = [
    {**_RULE, "metadata": {"name": "pod-launch"}, "lock": "Optimistic",
     "match": [{"apiVersion": "v1", "resource": "pods",
                "verbs": ["create"]}],
     "check": [{"tpl": "namespace:{{namespace}}#view@user:{{user.name}}"}],
     "update": {"creates": [
         {"tpl": "pod:{{namespacedName}}#namespace@namespace:{{namespace}}"},
         {"tpl": "pod:{{namespacedName}}#creator@user:{{user.name}}"}]}},
    {**_RULE, "metadata": {"name": "pod-retire"}, "lock": "Pessimistic",
     "match": [{"apiVersion": "v1", "resource": "pods",
                "verbs": ["delete"]}],
     "check": [{"tpl": "pod:{{namespacedName}}#view@user:{{user.name}}"}],
     "update": {"deleteByFilter": [{"tpl": "pod:{{namespacedName}}"
                                           "#$resourceRelation@$subjectType"
                                           ":$subjectID"}]}},
]
# phase 18, the decision cache and device telemetry on phase 16's store
CACHE_EXPIRY_S = 1.5        # lifetime of (b)'s expiring workflow tuple
KERNEL_TIME_TOL = 0.10      # (d): accounted kernel.device s vs own events
TELEMETRY_COST_USERS = 64   # lists of the burst run with the switches on/off
DUALWRITE_PAIRS = 8
# phase 19, the durable store and read replication at multitenant-1m
DURABLE_ROUNDS = 16         # rounds of pod-churn writes on the leader
DURABLE_ROUND_WRITES = 64   # writes a round, each one WAL record
DURABLE_CREATES = 64        # dual-write creates through the leader proxy
DURABLE_ORACLE_CHECKS = 200
FOLLOWER_ROUNDS = 16
FOLLOWER_LISTS = 8          # proxied lists on the follower a round
DUALWRITE_ORACLE = 64
CLI_READY_S = 300           # the command's warm start, prewarm included
# phase 20, leader failover on phase 19's leader and follower
FAILOVER_UNSHIPPED = 32     # pod creates the old leader acknowledges, unshipped
FAILOVER_ROUNDS = 16        # rounds of writes on the promoted node
FAILOVER_ROUND_WRITES = 64
LEAF_ROUNDS = 8             # rounds while the rejoined node relays to a leaf
FAILOVER_ORACLE_CHECKS = 200
FAILOVER_ORACLE_SUBJECTS = 2
FAILOVER_ORACLE_PODS = 100  # returned, and as many drawn, pods a lookup
# (d): the election's store (host logic), its grace and writes
ELECTION_WORKLOAD = {"n_pods": 2_000, "n_tuples": 20_000, "n_users": 500,
                     "n_namespaces": 200}
ELECTION_GRACE_S = 1.0
ELECTION_WRITES = 16
CLI_STOP_S = 10             # SIGTERM to exit
# phase 21, tuple-space sharding: shard 1's classes (the reference bench's
# write-shard-scale, bench.py:1338-1349) beside multitenant-1m on shard 0
SHARD_SCHEMA = "".join(
    f"definition {t} {{\n  relation creator: user\n"
    f"  permission view = creator\n}}\n"
    for t in ("cfgns", "configmap", "secns", "secret"))
SHARD_MAP = "configmap=1,cfgns=1,secret=1,secns=1"
SHARD_SPANNING_MAP = "pod=1"    # pod#view's closure then spans both shards
SHARD_CONFIGMAPS = 200_000
SHARD_SECRETS = 200_000
SHARD_NAMESPACES = 2_000        # ids of each of cfgns and secns
SHARD_KUBE_CONFIGMAPS = 10_000  # configmaps the fake apiserver holds
SHARD_LISTS = 32                # pod lists and configmap lists in (b)
SHARD_ORACLE_LISTS = 8          # of each type, held against the oracle
SHARD_CREATES = 32              # pod creates and configmap creates in (c)
SHARD_BULK_CHECKS = 10_000
SHARD_ISOLATION_LISTS = 32      # pod lists during shard 1's rebuild in (d)
# (g): the reference test's schema, rules and map
# (tests/test_tuple_sharding.py:77-132)
SHARD_CLI_SCHEMA = """
definition user {}
definition namespace {
  relation creator: user
  relation viewer: user
  permission view = viewer + creator
}
definition podns {
  relation creator: user
  permission view = creator
}
definition pod {
  relation creator: user
  relation viewer: user
  permission view = viewer + creator
}
"""
SHARD_CLI_RULES = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: get-namespaces}
match: [{apiVersion: v1, resource: namespaces, verbs: [get]}]
check: [{tpl: "namespace:{{name}}#view@user:{{user.name}}"}]
---
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: list-namespaces}
match: [{apiVersion: v1, resource: namespaces, verbs: [list]}]
prefilter:
- fromObjectIDNameExpr: "{{resourceId}}"
  lookupMatchingResources: {tpl: "namespace:$#view@user:{{user.name}}"}
---
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: list-pods}
match: [{apiVersion: v1, resource: pods, verbs: [list]}]
prefilter:
- fromObjectIDNamespaceExpr: "{{split_namespace(resourceId)}}"
  fromObjectIDNameExpr: "{{split_name(resourceId)}}"
  lookupMatchingResources: {tpl: "pod:$#view@user:{{user.name}}"}
---
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata: {name: create-pods}
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
lock: Optimistic
check: [{tpl: "podns:{{namespace}}#view@user:{{user.name}}"}]
update:
  creates:
  - tpl: "pod:{{namespacedName}}#creator@user:{{user.name}}"
"""
# phase 22, the remote endpoint on phase 16's endpoint
REMOTE_CLIENTS = 4          # RemoteEndpoint "proxies", each its own channel
REMOTE_LOOKUPS = 64         # concurrent LookupResources a client
REMOTE_BULK = 10_000        # pairs in the one CheckBulkPermissions
REMOTE_WRITES = 32          # WriteRelationships calls, one update each
REMOTE_ORACLE_USERS = 4     # burst lookups held against the oracle
REMOTE_ORACLE_CHECKS = 200  # bulk pairs held against the oracle
REMOTE_TOKEN = "phase-22-token"
# the burst's lookups: the list-namespaces prefilter's (tens of ids a
# user).  A pod#view lookup streams thousands of ids, one gRPC message
# each, at multitenant-1m (the burst's 256 took 117 s over loopback gRPC
# on the card); one is timed beside the burst
REMOTE_LOOKUP_TYPE = "namespace"
# phase 23, the fleet plane on phase 21's lineages: about half the rate
# phase 21 (b) sustained through the in-process proxy (~20 lists/s)
FLEET_WINDOW_S = 20.0
FLEET_RATE = 50.0           # requests a second, offered open-loop
FLEET_MIX = (("filter", 0.2), ("check", 0.8))   # ~10 lists/s, ~40 checks/s
FLEET_KILL_WINDOW_S = 6.0   # the second window, leader 1 killed in it
FLEET_KILL_AT_S = 2.0
FLEET_ORACLE_LISTS = 6      # lists of each type held against the oracle
FLEET_ORACLE_GETS = 50      # checks (gets) held against the oracle
FLEET_INSIDE_SHARE = 0.9    # assembled traces whose child fits its hop
SHARD_CLI_MAP = "pod=1,podns=1"
SHARD_CLI_TUPLES = ("namespace:team-a#creator@user:alice",
                    "podns:team-a#creator@user:alice",
                    "pod:team-a/p0#creator@user:alice")
UNDECIDED = '[caveat:within_quota:{"used": 1}]'
DECIDED = ('[caveat:within_quota:{"used": 1, "quota": 5}]',
           '[caveat:within_quota:{"used": 9, "quota": 5}]')

KERNEL_SOURCE = "spicedb_kubeapi_proxy_tpu_torch/ops/kernels/csrc/ell_kernels.cu"
REPLACES = {
    "ell_gather_or": "spicedb_kubeapi_proxy_tpu/ops/ell.py:444",
    "perm_program": "spicedb_kubeapi_proxy_tpu/ops/ell.py:215",
    "sweep_delta": "spicedb_kubeapi_proxy_tpu/ops/ell.py:613",
    "seed_bitplanes": "spicedb_kubeapi_proxy_tpu/ops/ell.py:556",
    "check_gather": "spicedb_kubeapi_proxy_tpu/ops/ell.py:878",
    "lookup_T": "spicedb_kubeapi_proxy_tpu/ops/ell.py:889",
    "scatter_rows": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:1004",
    "cav_gather_or": "spicedb_kubeapi_proxy_tpu/ops/ell.py:528",
    "check_gather3": "spicedb_kubeapi_proxy_tpu/ops/ell.py:853",
    "edge_or": "spicedb_kubeapi_proxy_tpu/ops/spmv.py:130",
    "word_cols_T": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:2970",
    "or_combine": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:69",
    "mesh_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:482",
    "mesh_cav_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/"
                          "sharding.py:503",
    "mesh_perm_program": "spicedb_kubeapi_proxy_tpu/parallel/"
                         "sharding.py:522",
    "mesh_sweep_delta": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:529",
    "sweep_delta_checks": "spicedb_kubeapi_proxy_tpu/ops/ell.py:853",
}
# further TPU kernels a ported kernel also stands for (PERF.md rows 9-11)
REPLACES_ALSO = {
    "edge_or": "spicedb_kubeapi_proxy_tpu/ops/spmv.py:195 (fixpoint), "
               ":155 (init_state), :320 (_pipe_fns)",
    "check_gather": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:2345 "
                    "(_leo_check_fill, the Leopard check route)",
    "scatter_rows": "spicedb_kubeapi_proxy_tpu/ops/jax_endpoint.py:690 "
                    "(_SegmentGraph.flush), spicedb_kubeapi_proxy_tpu/"
                    "parallel/sharding.py:396 (_scatter_rows, per table "
                    "block)",
    "mesh_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:491 "
                      "(the main gather) and the tiled all_gathers after "
                      "each pass (:488, :496), between replicas on one "
                      "device",
    "mesh_cav_gather_or": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:"
                          "506 (the maybe words' all_gather)",
    "mesh_sweep_delta": "spicedb_kubeapi_proxy_tpu/parallel/sharding.py:542 "
                        "(changed, pmax) and :545 (delta, psum over data)",
    "sweep_delta_checks": "spicedb_kubeapi_proxy_tpu/ops/ell.py:878 (the "
                          "definite run_checks) and :613 (the fixpoint "
                          "test and trace, with sweep_delta): the ELL "
                          "sweep's tail, one launch",
}
REPLACES_ALSO["edge_or"] += (", spicedb_kubeapi_proxy_tpu/parallel/"
                             "sharding.py:63 (make_sharded_evaluate, each "
                             "edge shard)")
# the kernels of the definite read path (phases 4-5) and of the caveat
# path (phase 10); on both the checks ride every sweep's tail
# (sweep_delta_checks), so neither launches sweep_delta, check_gather or
# check_gather3 (STANDALONE_TAIL), which serve the segment, mesh and
# Leopard paths
READ_KERNELS = ("ell_gather_or", "perm_program", "sweep_delta_checks",
                "seed_bitplanes", "lookup_T")
STANDALONE_TAIL = ("sweep_delta", "check_gather", "check_gather3")
CAVEAT_KERNELS = tuple(k for k in REPLACES
                       if k not in STANDALONE_TAIL + (
                           "edge_or", "word_cols_T", "or_combine")
                       and not k.startswith("mesh_"))
# the kernels of the mesh read path (phase 13a; the sharded sweep's own
# are MESH_SWEEP_KERNELS, plus mesh_cav_gather_or with planes)
MESH_SWEEP_KERNELS = ("mesh_gather_or", "mesh_perm_program",
                      "mesh_sweep_delta")
MESH_KERNELS = MESH_SWEEP_KERNELS + ("seed_bitplanes", "check_gather",
                                     "lookup_T")
# each in-memory write's seconds in phase 9, beside phase 19's durable ones
WRITE_SECONDS: dict = {}
POISON = 0x5A5A5A5A     # what a sweep's output buffers hold before it
# the segment path's kernels (phase 11; the init step is a plain copy of
# the seed when the program has no wildcard term, as multitenant-1m's)
SEGMENT_KERNELS = ("seed_bitplanes", "edge_or", "perm_program",
                   "sweep_delta", "check_gather", "lookup_T")
# 32-bit integer ALU rate used for the operations bound: one op per CUDA
# core lane per clock, i.e. half the 67 TFLOP/s fp32 FMA rate of an H100
# SXM at its 700 W limit (bitwise ops never reach the tensor cores)
INT_OPS_PER_S = 33.5e12


def hbm_peak(name: str) -> float:
    """Published device-memory bandwidth (bytes/s) for a card name."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name:
        return 3.35e12
    raise RuntimeError(f"no published memory bandwidth known for {name!r}")


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Device time of a callable: CUDA events around `reps` runs (warmed
    up once) on a CUDA device; host clock after a sync elsewhere."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, fn, reps: int = REPS) -> float:
        fn()
        self.sync()
        if self.cuda:
            ev0 = self.torch.cuda.Event(enable_timing=True)
            ev1 = self.torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(reps):
                fn()
            ev1.record()
            ev1.synchronize()
            return ev0.elapsed_time(ev1) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps


def _profile(fn, n: int, before=None) -> dict:
    """{name: [launches, microseconds]} of the device activity (kernels,
    copies, memsets) of `n` calls of `fn`, each after `before()` if
    given, as torch.profiler's CUDA activity records it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU or getattr(
                e, "is_user_annotation", False):
            continue
        acc = out.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us()
    return out


def _graph_ms(fn, n: int, before=None) -> float:
    """Device ms per call of `n` calls of `fn` (each after `before()` if
    given): CUDA events around one replay of a CUDA graph that captured
    them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(n):
            if before is not None:
                before()
            fn()
    graph.replay()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    graph.replay()
    ev1.record()
    ev1.synchronize()
    del graph
    return ev0.elapsed_time(ev1) / n


def _events_ms(fn, n: int, before=None) -> float:
    """Device ms per call of `n` back-to-back calls of `fn` (each after
    `before()` if given, which is timed alone and taken off): CUDA events
    around the loop.  For a call that is itself a CUDA graph replay, whose
    host cost per call is far below its device time."""
    import torch
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for f, sign in ((fn, 1), (None, -1)) if before is not None else \
            ((fn, 1),):
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(n):
            if before is not None:
                before()
            if f is not None:
                f()
        ev1.record()
        ev1.synchronize()
        total += sign * ev0.elapsed_time(ev1)
    return total / n


def attribute(fn, n: int = ATTR_CALLS, capturable: bool = True) -> dict:
    """One callable's time on the card, four ways, so that device time
    and per-call host cost are reported apart:

    event_ms   (a) CUDA events around REPS back-to-back calls (Timer.ms);
    device_ms  (b) device time per call of its kernels, copies and
               memsets over `n` back-to-back calls;
    host_us    (c) wall time of `n` calls with no synchronise, per call;
    cold_ms    (d) device time per call when each call follows a write of
               L2_FLUSH_BYTES of scratch (the 50 MB L2 flushed; the
               write itself not counted).

    (b) and (d) come from torch.profiler's CUDA activity (device_by
    "profiler"; it records the ctypes launches too) when its record is
    whole: every activity seen `n` times or a multiple of it, the same
    in both runs (in (d) the activities (b) did not see are the scratch
    write).  Otherwise (device_by "graph") from CUDA events around the
    replay of a CUDA graph of the `n` calls, (d) less a graph of the `n`
    scratch writes alone; a call that replays a graph itself
    (`capturable` False) is timed by CUDA events around the calls
    instead (device_by "events").  `launches` is the profiler's
    activities per call.
    """
    import torch

    timer = Timer(torch, torch.device("cuda"))
    out = {"event_ms": timer.ms(fn)}
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    flush = lambda: scratch.fill_(1)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    warm = _profile(fn, n)
    cold = {k: v for k, v in _profile(fn, n, flush).items() if k in warm}
    counts = {k: c for k, (c, _) in warm.items()}
    launches = sum(counts.values()) / n
    if counts and all(c % n == 0 for c in counts.values()) and counts == {
            k: c for k, (c, _) in cold.items()}:
        out.update(device_by="profiler",
                   device_ms=sum(t for _, t in warm.values()) / n / 1e3,
                   cold_ms=sum(t for _, t in cold.values()) / n / 1e3)
    elif capturable:
        out.update(device_by="graph", device_ms=_graph_ms(fn, n),
                   cold_ms=_graph_ms(fn, n, flush) - _graph_ms(flush, n))
    else:
        out.update(device_by="events", device_ms=_events_ms(fn, n),
                   cold_ms=_events_ms(fn, n, flush))
    out.update(launches=launches, device_names=sorted(warm))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out["host_us"] = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    del scratch
    return out


def _twin_sweeps(kc, tables, x0, live, n_words: int, label: str) -> tuple:
    """Two sweeps of a batch from its seed `x0`: every step on the card
    and on the twins from identical copies, compared after each step,
    then the deltas.  Returns ({kernel: max error}, the steps, the state
    after the two sweeps)."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    dead = kc.prog.dead_index
    steps = list(kc.sweep_steps(*tables, n_words=n_words))
    err = {"ell_gather_or": 0, "perm_program": 0, "sweep_delta": 0}
    x = x0.clone()
    for sweep in range(2):
        cur_k, cur_t = x.clone(), x.clone()
        for i, step in enumerate(steps):
            EllKernelCache.run_step(step, cur_k, x0, live, kernels, x_in=x)
            EllKernelCache.run_step(step, cur_t, x0, live, reference, x_in=x)
            e = _diff(cur_k, cur_t)
            err[step[0]] = max(err.get(step[0], 0), e)
            if e:
                raise AssertionError(f"{label}: {step[0]} differs from its "
                                     f"twin at step {i} of sweep {sweep}")
        d_k = kernels.sweep_delta(cur_k, x, dead)
        d_t = reference.sweep_delta(cur_t, x, dead)
        err["sweep_delta"] = max(err["sweep_delta"], _diff(d_k.cpu(), d_t)
                                 + _diff(cur_k, cur_t))
        x = cur_k
    return err, steps, x


def sweep_split(kc, tables, x0, live, x, steps, n_words: int,
                label: str) -> dict:
    """`attribute` of one sweep's launches on the state `x` (the input of
    the batch's third sweep): each gather/program kernel's launches of
    the sweep together, the sweep's input copy and delta, and the whole
    sweep launched step by step ("eager") and replayed from a CUDA graph
    ("graph"), as `EllKernelCache.evaluate` runs it."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache, _Arena
    cur = x.clone()
    dead = kc.prog.dead_index
    arena = _Arena(x0=x0, a=x, b=cur, live=live)
    kc.size_tail(arena, 32 * n_words)
    out = {}
    for kind in dict.fromkeys(s[0] for s in steps):
        mine = [s for s in steps if s[0] == kind]
        out[kind] = attribute(lambda mine=mine: [EllKernelCache.run_step(
            s, cur, x0, live, kernels, x_in=x) for s in mine])
        out[kind]["calls"] = len(mine)
    out["copy"] = attribute(lambda: cur.copy_(x))
    out["sweep_delta"] = attribute(lambda: kernels.sweep_delta(cur, x, dead))
    eager = lambda: kc._sweep(x, cur, arena, tables, n_words, kc.plan)
    out["eager"] = attribute(eager)
    graph = kernels.LaunchGraph(x.device)
    graph.capture(eager)
    out["graph"] = attribute(graph.replay, capturable=False)
    del graph
    torch.cuda.synchronize()
    for k, r in out.items():
        log(f"{label} {k}: event {r['event_ms']:.6f} ms, device "
            f"{r['device_ms']:.6f} ms ({r['device_by']}, {r['launches']:g} "
            f"activities), host {r['host_us']:.2f} us, cold "
            f"{r['cold_ms']:.6f} ms")
    return out


def _split_into(rows: dict, split: dict) -> None:
    """Fold `sweep_split` readings into the kernel rows: each kernel's
    device, cold and host time per sweep, and (under ell_gather_or) the
    whole sweep's, eager and replayed."""
    pick = lambda r: {"device_ms": r["device_ms"], "cold_ms": r["cold_ms"],
                      "host_us": r["host_us"], "event_ms": r["event_ms"],
                      "device_by": r["device_by"],
                      "launches_per_call": r["launches"]}
    for kind, r in split.items():
        if kind in rows:
            rows[kind].update(pick(r))
    rows["ell_gather_or"]["sweep"] = {k: pick(split[k]) for k in
                                      ("eager", "graph", "copy")}


def split_times(kernel_fn, library_fn) -> dict:
    """The device-only, cold and host columns (`attribute` (b)-(d)) of a
    kernel and of its library yardstick, as extra fields of a kernel row
    (PERF.md rows 4c, 8, 11, 13)."""
    k = attribute(kernel_fn)
    lib = attribute(library_fn)
    return {"device_ms": k["device_ms"], "cold_ms": k["cold_ms"],
            "host_us": k["host_us"], "device_by": k["device_by"],
            "launches_per_call": k["launches"],
            "library_device_by": lib["device_by"],
            "library_device_ms": lib["device_ms"],
            "library_cold_ms": lib["cold_ms"],
            "library_host_us": lib["host_us"]}


def _log_split(label: str, t: dict) -> None:
    log(f"{label}: device {t['device_ms']:.6f} ms ({t['device_by']}, "
        f"{t['launches_per_call']:g} launches a call), cold "
        f"{t['cold_ms']:.6f} ms, host {t['host_us']:.2f} us a call; library "
        f"device {t['library_device_ms']:.6f} ms, cold "
        f"{t['library_cold_ms']:.6f} ms, host {t['library_host_us']:.2f} us")


def direct_url(device: str) -> str:
    """The `torch://` URL of phases 1-13: the bare endpoint
    (`dispatch=direct`), whose graph, stats and kernels those phases read
    and write directly, as they did before batched dispatch became the
    default; phase 14 wraps one in the dispatcher itself."""
    if device == "cuda":
        return "torch://?dispatch=direct"
    return f"torch://?device={device}&dispatch=direct"


def load(device: str, workload_kwargs: dict, generator: str = "multitenant_1m"):
    """Phase 3 (and 10): generate, load and build; returns (endpoint,
    workload)."""
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    t0 = time.perf_counter()
    w = getattr(workloads, generator)(**workload_kwargs)
    text = "\n".join(w.relationships)
    t1 = time.perf_counter()
    url = direct_url(device)
    ep = create_endpoint(url, Bootstrap(w.schema_text, text))
    t2 = time.perf_counter()
    g = ep.graph()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    prog = g.prog
    log(f"load: {len(w.relationships)} tuples generated in {t1 - t0:.3f} s; "
        f"store load {t2 - t1:.3f} s; graph build {t3 - t2:.3f} s")
    log(f"graph: {prog.state_size} state rows, {len(prog.edge_src)} edges, "
        f"{g.dev_aux.shape[0]} aux rows, tree depth "
        f"{g.kernel.aux_passes - 1}, {len(g.kernel.stages)} stages "
        f"({'Jacobi step' if not g.kernel.stages else 'staged'}), "
        f"{len(prog.perm_ops)} permission ops, "
        f"{len(prog.object_ids['pod'])} pod rows")
    return ep, w


def drive(ep, w, timer):
    """Phases 4-5: the main path, through the endpoint's public verbs.
    Returns (lookup batches, their results, check requests, check results,
    per-verb timing/trace summaries)."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)
    rng = np.random.default_rng(SEED)
    users = w.subjects
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pods = [p for p in ep.graph().prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    subj = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", batches[0][s])
            for i, s in zip(pick, subj)]
    summary = {}
    lookups, checks = [], []
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                res = asyncio.run(ep.lookup_resources_batch(
                    "pod", "view", batches[k]))
                lookups.append(res)
            else:
                res = asyncio.run(ep.check_bulk_permissions(reqs))
                checks.append(res)
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(ep.graph().last_trace[0]))
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps,
                         "trace": ep.graph().last_trace[: 1 + sweeps[-1]]
                         .tolist()}
        log(f"{verb}: sweeps per batch {sweeps}; trace {summary[verb]['trace']}"
            f"; e2e per batch cold {e2e[0]:.4f} s, warm median "
            f"{statistics.median(e2e[1:]):.4f} s (all: "
            f"{', '.join(f'{t:.4f}' for t in e2e)})")
    n_allowed = sum(len(r) for r in lookups[0])
    log(f"lookup: batch 0 allowed {n_allowed} (subject, pod) pairs; "
        f"check: {sum(r.allowed for r in checks[0])} of {len(reqs)} allowed")
    return batches, lookups, reqs, checks, summary


def _diff(a, b) -> int:
    """max |a - b| over two int32 tensors (0 when bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def kernels_vs_twins(ep, batches, reqs, timer, peak):
    """Phase 6: every kernel against its twin on the real tables, with
    its time, its twin's time and its bound.  Returns {name: row}."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _unify_check_buckets)

    g = ep.graph()
    kc, prog = g.kernel, g.prog
    main, aux, _ = g.snapshot()
    dev = main.device
    q_arr, cols, _ = ep._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(dev)
    n_words = len(q_arr) // 32
    nt = prog.state_size + kc.n_aux_rows
    dead = prog.dead_index
    word = 4 * n_words
    rows = {}

    def row(name, err, ms, plain_ms, nbytes, ops, library_ms=None):
        b_bytes = nbytes / peak * 1e3
        b_ops = ops / INT_OPS_PER_S * 1e3
        rows[name] = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                      "replaces": REPLACES[name], "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(b_bytes, b_ops),
                      "bound_by": "bytes" if b_bytes >= b_ops
                      else "operations",
                      "library_ms": library_ms}

    # seed (one launch per batch)
    wc, live = kc._wc_ranges, None
    if wc is not None:
        live = torch.empty((wc.shape[0], n_words), dtype=torch.int32,
                           device=dev)
    x0 = kernels.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc, live=live)
    live_t = None if live is None else torch.empty_like(live)
    x0_t = reference.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc,
                                    live=live_t)
    err = _diff(x0, x0_t) + (0 if live is None else _diff(live, live_t))
    row("seed_bitplanes", err,
        timer.ms(lambda: kernels.seed_bitplanes(q, nt, n_words, dead,
                                                out=x0, wc_ranges=wc,
                                                live=live)),
        timer.ms(lambda: reference.seed_bitplanes(q, nt, n_words, dead,
                                                  wc_ranges=wc, live=live_t)),
        q.numel() * 4 + nt * word, q.numel())

    # two real sweeps, step by step: the kernel and the twin run every
    # step on identical copies, compared after each step
    err, steps, x = _twin_sweeps(kc, (main, aux, None), x0, live, n_words,
                                 "staged sweep")
    # per-sweep work of each sweep kernel, timed step by step on the
    # state after two sweeps; bytes: each input read once (distinct
    # gathered rows), each output written once
    per = {"ell_gather_or": [0.0, 0.0, 0, 0], "perm_program": [0.0, 0.0, 0, 0]}
    cur = x.clone()
    for step in steps:
        name = step[0]
        acc = per[name]
        acc[0] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, kernels))
        acc[1] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, reference), reps=2)
        if name == "ell_gather_or":
            idx, seeded, wcb = step[1], step[3], step[4]
            n, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            acc[2] += (n * k * 4 + uniq * word + n * word * (1 + seeded)
                       + (n * 4 + word * live.shape[0] if wcb is not None
                          else 0))
            acc[3] += n * n_words * (k + seeded)
        else:
            code, length = step[1], step[3]
            n_read = int((code[0::2] == 0).sum())
            acc[2] += code.numel() * 4 + length * word * (n_read + 2)
            acc[3] += length * n_words * (code.numel() // 2 + 1)
    for name, (ms, plain, nbytes, ops) in per.items():
        row(name, err[name], ms, plain, nbytes, ops)
    x_prev = x.clone()
    row("sweep_delta", err["sweep_delta"],
        timer.ms(lambda: kernels.sweep_delta(cur, x_prev, dead)),
        timer.ms(lambda: reference.sweep_delta(cur, x_prev, dead), reps=2),
        2 * nt * word + 8, 3 * nt * n_words)
    if timer.cuda:
        # device-only, cold and host time of each kernel's launches of a
        # sweep, and of the whole sweep step by step and replayed
        _split_into(rows, sweep_split(kc, (main, aux, None), x0, live, x,
                                      steps, n_words, "staged sweep"))
        sweep_bound = (sum(per[k][2] for k in per) + 4 * nt * word + 8)
        rows["ell_gather_or"]["sweep"]["bound_ms"] = sweep_bound / peak * 1e3

    # the converged state of this batch, from the endpoint's own entry
    x_final, _ = kc.evaluate(q, n_words, main, aux, kc.take_arena(n_words))
    gidx, gcol = [], []
    qa, cmap, _ = ep._encode_subjects(g, [r.subject for r in reqs])
    for r in reqs:
        gidx.append(prog.state_index("pod", "view", r.resource.id))
        gcol.append(cmap[r.subject])
    _, gi, gc = _unify_check_buckets(qa, gidx, gcol)
    gi, gc = torch.from_numpy(gi).to(dev), torch.from_numpy(gc).to(dev)
    out_k = kernels.check_gather(x_final, gi, gc)
    out_t = reference.check_gather(x_final, gi, gc)
    pairs = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    row("check_gather", _diff(out_k, out_t),
        timer.ms(lambda: kernels.check_gather(x_final, gi, gc)),
        timer.ms(lambda: reference.check_gather(x_final, gi, gc)),
        gi.numel() * 4 * 3 + pairs * 4, 3 * gi.numel())
    # the fused tail that carries these gathers on the main path
    rows["sweep_delta_checks"] = {
        "name": "sweep_delta_checks", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES["sweep_delta_checks"],
        **check_tail(ep, kc, q, n_words, (main, aux, None), x_final, x_prev,
                     reqs, gi.cpu().numpy(), gc.cpu().numpy(), timer, peak,
                     "phase 6")}
    off, length = prog.slot_range("pod", "view")
    lk = kernels.lookup_T(x_final, off, length)
    lt = reference.lookup_T(x_final, off, length)
    row("lookup_T", _diff(lk, lt),
        timer.ms(lambda: kernels.lookup_T(x_final, off, length)),
        timer.ms(lambda: reference.lookup_T(x_final, off, length)),
        2 * length * word, 0,
        library_ms=timer.ms(
            lambda: x_final.narrow(0, off, length).t().contiguous()))
    if timer.cuda:
        rows["lookup_T"].update(split_times(
            lambda: kernels.lookup_T(x_final, off, length),
            lambda: x_final.narrow(0, off, length).t().contiguous()))
        _log_split(f"lookup_T [{n_words}, {length}]", rows["lookup_T"])
    bad = {n: r["max_abs_err"] for n, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    log("kernels vs twins on the full tables: all bit-identical "
        f"({len(steps)} sweep steps x 2 sweeps, seed, delta, "
        f"{gi.numel()} check gathers, [{n_words}, {length}] lookup words)")

    # one whole lookup batch again on the CPU twins: final state, trace
    # and lookup words equal the card's
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    kc_cpu = EllKernelCache(prog, n_aux_rows=kc.n_aux_rows,
                            tree_depth=kc.tree_depth, device=cpu,
                            shared_tree_depth=kc.aux_passes - 1,
                            stages=kc.stages)
    if kc_cpu.num_iters != kc.num_iters:
        raise AssertionError("CPU twin cache has another iteration cap")
    x_dev, tr_dev = kc.evaluate(q, n_words, main, aux,
                                kc.take_arena(n_words))
    x_cpu, tr_cpu = kc_cpu.evaluate(q.cpu(), n_words, main.cpu(), aux.cpu(),
                                    kc_cpu.take_arena(n_words))
    if not (torch.equal(x_dev.cpu(), x_cpu)
            and np.array_equal(tr_dev, tr_cpu)):
        raise AssertionError("card and CPU-twin sweeps disagree")
    log(f"whole batch on the CPU twins: state and trace {tr_cpu[:1 + tr_cpu[0]]}"
        f" equal the card's ({time.perf_counter() - t0:.1f} s)")
    if timer.cuda:
        graph_batch_checks(ep, kc, q, n_words, (main, aux, None), x_dev,
                           tr_dev, steps, batches[1], "pod", "staged")
    return rows, per, nt


def graph_batch_checks(ep, kc, q, n_words: int, tables, x_dev, tr_dev,
                       steps, batch, rtype: str, label: str) -> None:
    """The graph-replayed batch (`x_dev`, `tr_dev`) equals the same batch
    launched step by step; then a warm batch of the endpoint's (its arena
    already captured) is one graph replay and one readback a sweep: no
    capture, no sweep launched step by step, and the launches its replays
    count equal the steps' own."""
    import asyncio
    from collections import Counter

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    x_e, tr_e = kc._evaluate_eager(q, n_words, tables[0], tables[1],
                                   kc.take_arena(n_words), tables[2])
    if not (torch.equal(x_dev, x_e) and np.array_equal(tr_dev, tr_e)):
        raise AssertionError(f"{label}: graph-replayed and step-by-step "
                             "sweeps disagree")
    # the first batch may capture (the arenas above left the pool)
    asyncio.run(ep.lookup_resources_batch(rtype, "view", batch))
    st0 = dict(kc.graph_stats)
    kernels.reset_launches()
    asyncio.run(ep.lookup_resources_batch(rtype, "view", batch))
    sweeps = int(ep.graph().last_trace[0])
    d = {k: kc.graph_stats[k] - st0[k] for k in ("captures", "replays",
                                                   "eager_sweeps")}
    want = Counter()
    for _ in range(sweeps):
        want.update(s[0] for s in steps)
        want["sweep_delta_checks"] += 1
    want.update(("seed_bitplanes", "lookup_T"))
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if d["captures"] or d["eager_sweeps"] or d["replays"] != sweeps or \
            got != dict(want):
        raise AssertionError(f"{label}: a warm batch was not one replay a "
                             f"sweep: graph stats {d}, launches {got}, "
                             f"want {dict(want)}")
    log(f"{label}: graph-replayed batch equals the step-by-step one (state, "
        f"trace {tr_dev[:1 + tr_dev[0]].tolist()}); a warm endpoint batch of "
        f"{sweeps} sweeps = {sweeps} graph replays + {sweeps} readbacks, "
        f"launches {got}; graph stats {kc.graph_stats}")


def _no_standalone_tail(launches: dict, label: str) -> None:
    """The ELL path gathers its checks in the sweep tail: fail if `label`'s
    launches hold a standalone delta or check gather."""
    bad = {k: launches.get(k, 0) for k in STANDALONE_TAIL
           if launches.get(k, 0)}
    if bad:
        raise AssertionError(f"{label}: the ELL path launched {bad} (its "
                             f"checks ride sweep_delta_checks)")
    log(f"{label}: no standalone sweep_delta / check_gather / check_gather3 "
        f"launch; sweep_delta_checks {launches.get('sweep_delta_checks', 0)}")


def check_tail(ep, kc, q, n_words: int, tables, x_final, x_prev, reqs,
               gidx, gcol, timer, peak, label: str) -> dict:
    """The fused sweep tail, `sweep_delta_checks`, at a real check batch
    (`gidx`, `gcol`: its gather slots, padded as the endpoint pads them):
    against its twin on the converged state (delta pair, packed answers,
    the pinned host copy, the dead row), its answers against the
    standalone `check_gather` (`check_gather3` with planes) on the same
    state, then the endpoint cache's replayed `checks_device` against the
    same gathers; a warm check batch of the endpoint counts its launches
    and readbacks.  Timed as the other rows, plus (b) from event nodes
    inside a replayed graph of the tail alone.  Returns the kernel row's
    fields."""
    import asyncio
    import statistics

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import _Arena
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    planes = kc.planes
    half = n_words if planes else None
    dead = kc.prog.dead_index
    nt, width = x_final.shape
    dev = x_final.device
    g = len(gidx)
    gi_np = np.asarray(gidx, np.int32)
    gc_np = np.asarray(gcol, np.int32)
    arena = _Arena(x0=x_final, a=x_final, b=x_prev)
    kc.size_tail(arena, max(g, 32 * n_words))
    kc._load_tail(arena, n_words, (gi_np, gc_np))
    cur_k, cur_t = x_final.clone(), x_final.clone()
    out_t = arena.out.clone()
    call = lambda: kernels.sweep_delta_checks(
        cur_k, x_prev, dead, arena.tail, arena.out, half=half,
        host=arena.host)
    call()
    reference.sweep_delta_checks(cur_t, x_prev, dead, arena.tail, out_t,
                                 half=half)
    timer.sync()
    err = _diff(arena.out, out_t) + _diff(cur_k, cur_t)
    if arena.host is not None:
        err += _diff(arena.host, arena.out.cpu())
    answers = kc._answers(arena)
    gi, gc = torch.from_numpy(gi_np).to(dev), torch.from_numpy(gc_np).to(dev)
    alone = (kernels.check_gather3(x_final, gi, gc, n_words) if planes
             else kernels.check_gather(x_final, gi, gc)).cpu()
    if err or not torch.equal(answers, alone):
        raise AssertionError(f"{label}: sweep_delta_checks differs from its "
                             f"twin ({err}) or from the standalone gather")
    # the endpoint cache's own entry, replayed from its graphs (the first
    # call may capture), against the standalone gather
    out_c, _ = kc.checks_device(q, n_words, gi_np, gc_np, *tables)
    st0 = dict(kc.graph_stats)
    kernels.reset_launches()
    out_c, tr = kc.checks_device(q, n_words, gi_np, gc_np, *tables)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    st = {k: kc.graph_stats[k] - st0[k] for k in st0}
    sweeps = int(tr[0])
    if (not torch.equal(out_c, alone) or out_c.device.type != "cpu"
            or st["replays"] != (sweeps if timer.cuda else 0)
            or (timer.cuda and launched.get("sweep_delta_checks") != sweeps)
            or any(launched.get(k) for k in STANDALONE_TAIL)):
        raise AssertionError(f"{label}: the replayed checks_device "
                             f"({sweeps} sweeps, graph stats {st}, launches "
                             f"{launched}) differs from the standalone "
                             f"gather")
    # a warm check batch through the endpoint: its launches and readbacks
    asyncio.run(ep.check_bulk_permissions(reqs))
    kernels.reset_launches()
    rb0 = ep.stats["readbacks"]
    asyncio.run(ep.check_bulk_permissions(reqs))
    batch = {k: v for k, v in kernels.LAUNCHES.items() if v}
    readbacks = ep.stats["readbacks"] - rb0
    batch_sweeps = int(ep.graph().last_trace[0])
    if (any(batch.get(k) for k in STANDALONE_TAIL) or readbacks
            or (timer.cuda and batch.get("sweep_delta_checks")
                != batch_sweeps)):
        raise AssertionError(f"{label}: a warm check batch launched "
                             f"{batch} and started {readbacks} readbacks")
    # bound: the delta's two states once, the slots' pairs and G once, the
    # distinct gathered words once (two planes), the delta pairs and
    # answer words written on the card and into the host copy
    cells = len(np.unique(gi_np.astype(np.int64) * n_words + gc_np // 32))
    out_bytes = arena.out.numel() * 4
    nbytes = 2 * nt * width * 4 + 8 * g + 4 \
        + cells * 4 * (2 if planes else 1) + 2 * out_bytes
    ops = 3 * nt * width + 5 * g
    b_bytes, b_ops = nbytes / peak * 1e3, ops / INT_OPS_PER_S * 1e3
    row = {"max_abs_err": err, "ms": timer.ms(call),
           "plain_ms": timer.ms(lambda: reference.sweep_delta_checks(
               cur_t, x_prev, dead, arena.tail, out_t, half=half), reps=2),
           "bound_ms": max(b_bytes, b_ops),
           "bound_by": "bytes" if b_bytes >= b_ops else "operations",
           "library_ms": None, "gathers": g, "replayed_sweeps": sweeps,
           "batch_launches": batch, "batch_readbacks": readbacks,
           "batch_sweeps": batch_sweeps}
    if timer.cuda:
        t = attribute(call)
        row.update({"device_ms": t["device_ms"], "cold_ms": t["cold_ms"],
                    "host_us": t["host_us"], "event_ms": t["event_ms"],
                    "device_by": t["device_by"],
                    "launches_per_call": t["launches"]})
        # (b) from the event nodes of a graph that holds the tail alone
        graph = kernels.LaunchGraph(dev)
        graph.capture(call)
        spans = []
        for _ in range(ATTR_CALLS):
            graph.replay()
            torch.cuda.current_stream(dev).synchronize()
            spans.append(graph.seconds() * 1e3)
        row["graph_event_ms"] = statistics.median(spans)
        del graph
    log(f"{label}: sweep_delta_checks on the converged batch ({g} slots, "
        f"{width} words a row): delta pair, answers and host copy "
        f"bit-identical to its twin, answers equal to the standalone "
        f"{'check_gather3' if planes else 'check_gather'}; the replayed "
        f"checks_device ({sweeps} sweeps) equals it with launches "
        f"{launched}; a warm check batch: launches {batch}, readbacks "
        f"{readbacks}; (a) {row['ms']:.6f} ms"
        + (f", (b) {row['device_ms']:.6f} ms ({row['device_by']}), in-graph "
           f"events {row['graph_event_ms']:.6f} ms, (c) "
           f"{row['host_us']:.2f} us, (d) {row['cold_ms']:.6f} ms"
           if timer.cuda else "")
        + f"; bound {row['bound_ms']:.6f} ms ({nbytes} B)")
    return row


def oracle_check(ep, batches, lookups, reqs, checks):
    """Phase 7: sampled answers against the host Evaluator."""
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    oracle = ep._oracle
    t0 = time.perf_counter()
    for i in rng.choice(LOOKUP_LANES, ORACLE_LOOKUPS, replace=False):
        want = sorted(oracle.lookup_resources("pod", "view", batches[0][i]))
        got = sorted(lookups[0][i])
        if got != want:
            raise AssertionError(f"lookup for {batches[0][i]} differs from "
                                 f"the oracle ({len(got)} vs {len(want)})")
    t1 = time.perf_counter()
    for i in rng.choice(len(reqs), ORACLE_CHECKS, replace=False):
        r = reqs[i]
        if oracle.check(r.resource, r.permission, r.subject) != \
                checks[0][i].allowed:
            raise AssertionError(f"check {r} differs from the oracle")
    log(f"oracle: {ORACLE_LOOKUPS} full lookups ({t1 - t0:.1f} s) and "
        f"{ORACLE_CHECKS} checks ({time.perf_counter() - t1:.1f} s) equal")


def _churn_plan(w, n_rounds: int, seed: int, tag: str = "w") -> list:
    """Phase 9's writes, from the seed: per round a list of writes, each
    a list of (op, relationship string) — one pod create or delete per
    write (the proxy's dual-write commits its two tuples together), one
    write per group or namespace tuple.  Also returns per round the new
    pods with their creators and the granted (namespace, user) pairs."""
    import random
    rng = random.Random(seed)
    users = w.subjects
    members: dict = {}
    one_viewer: list = []
    n_ns = 0
    for r in w.relationships:
        if r.startswith("group:") and "#member@user:" in r:
            g, u = r[len("group:"):].split("#member@user:")
            members.setdefault(g, []).append(u)
        elif r.startswith("namespace:") and "#viewer@" in r:
            one_viewer.append(r[len("namespace:"):].split("#", 1)[0])
        elif r.startswith("namespace:") and "#tenant@" in r:
            n_ns += 1
    # hub groups: the largest member lists (every one an OR-tree root)
    hubs = sorted(members, key=lambda g: (-len(members[g]), g))[:64]
    live_members = [(g, u) for g in hubs for u in members[g]]
    rng.shuffle(live_members)
    grant_ns = sorted(set(one_viewer))
    rng.shuffle(grant_ns)
    plan = []
    for r in range(n_rounds):
        writes, created, granted = [], [], []
        for i in range(ROUND_CREATES):
            k, u = rng.randrange(n_ns), rng.choice(users)
            pod = f"ns{k}/{tag}{r}-{i}"
            created.append((pod, k, u))
            writes.append([("touch", f"pod:{pod}#namespace@namespace:ns{k}"),
                           ("touch", f"pod:{pod}#creator@user:{u}")])
        if r >= 2:
            for pod, k, u in plan[r - 2]["created"][:ROUND_DELETES]:
                writes.append([
                    ("delete", f"pod:{pod}#namespace@namespace:ns{k}"),
                    ("delete", f"pod:{pod}#creator@user:{u}")])
        for _ in range(ROUND_GROUP_TOUCHES):
            writes.append([("touch", f"group:{rng.choice(hubs)}#member@user:"
                                     f"{rng.choice(users)}")])
        for _ in range(ROUND_GROUP_DELETES):
            g, u = live_members.pop()
            writes.append([("delete", f"group:{g}#member@user:{u}")])
        ns = grant_ns[r]
        for _ in range(ROUND_GRANTS):
            u = rng.choice(users)
            granted.append((ns, u))
            writes.append([("touch", f"namespace:{ns}#viewer@user:{u}")])
        rng.shuffle(writes)
        plan.append({"writes": writes, "created": created,
                     "granted": granted})
    return plan


def _tables_match(graph):
    """The card's gather tables equal the host's (after a flush)."""
    import torch
    for dev, host in zip(graph.snapshot(),
                         (graph.host_main, graph.host_aux, graph.host_cav)):
        if (dev is None) != (host is None) or (
                dev is not None
                and not torch.equal(dev.cpu(), torch.from_numpy(host))):
            raise AssertionError("device tables differ from the host tables "
                                 "after the flush")


def churn(ep, w, timer, peak, warm_lookup_s, n_rounds: int = N_ROUNDS):
    """Phase 9: the write path.  Returns the scatter_rows kernel row."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    plan = _churn_plan(w, n_rounds, SEED + 9)
    rng = np.random.default_rng(SEED + 9)
    users = w.subjects
    g = ep.graph()
    pods = [p for p in g.prog.object_ids["pod"] if "\x00" not in p]
    pods_in: dict = {}
    for p in pods:
        pods_in.setdefault(p.split("/", 1)[0], []).append(p)
    stats0 = dict(ep.stats)

    async def commit(writes):
        for wr in writes:
            t = time.perf_counter()
            await ep.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])
            WRITE_SECONDS.setdefault("phase 9", []).append(
                time.perf_counter() - t)

    def lookup(subjects):
        t0 = time.perf_counter()
        res = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        return res, time.perf_counter() - t0

    tables_match = _tables_match

    touched = []            # (pod, user) pairs the churn touched
    rounds = []
    subjects_of = []
    kernels.reset_launches()
    for r, rnd in enumerate(plan):
        creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
        extra = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                              replace=False)]
        names = list(dict.fromkeys(creators + extra))[:LOOKUP_LANES]
        subjects = [SubjectRef("user", u) for u in names]
        subjects_of.append(subjects)
        iso = None
        if r == ISOLATION_ROUND:
            # a batch over the subjects whose pods this round deletes,
            # captured before the writes and extracted after the flush
            iso_subj = subjects_of[r - 2]
            before, _ = lookup(iso_subj)
            ctx = ep._lookup_batch_capture("pod", "view", iso_subj)
            snap = ep.graph().snapshot()[:2]
            iso = (iso_subj, before, ctx, snap, [t.clone() for t in snap])
        if r == n_rounds - 1:
            prev_tables = ep.graph().snapshot()[:2]
            prev_host = (ep.graph().host_main.copy(),
                         ep.graph().host_aux.copy())
        a0, f0 = ep.stats["delta_apply_s"], ep.stats["flush_s"]
        gs0 = dict(ep._graph.kernel.graph_stats)
        t0 = time.perf_counter()
        asyncio.run(commit(rnd["writes"]))
        t_write = time.perf_counter() - t0
        res, t_lookup = lookup(subjects)
        graph = ep.graph()
        tables_match(graph)
        apply_ms = (ep.stats["delta_apply_s"] - a0) * 1e3
        flush_ms = (ep.stats["flush_s"] - f0) * 1e3
        gs = graph.kernel.graph_stats
        capture_ms = (gs["capture_s"] - gs0["capture_s"]) * 1e3
        captures = gs["captures"] - gs0["captures"]
        # the round's new pods are visible to their creators at once
        by_user = dict(zip(names, res))
        for pod, _, u in rnd["created"]:
            if pod not in set(by_user[u]):
                raise AssertionError(f"new pod {pod} missing from {u}'s "
                                     f"lookup right after the write")
        new = [(pod, u) for pod, _, u in rnd["created"]]
        pick = rng.choice(len(pods), N_CHECKS - len(new), replace=False)
        pairs = new + [(pods[i], names[j]) for i, j in
                       zip(pick, rng.integers(0, len(names), len(pick)))]
        reqs = [CheckRequest(ObjectRef("pod", p), "view",
                             SubjectRef("user", u)) for p, u in pairs]
        t0 = time.perf_counter()
        checks = asyncio.run(ep.check_bulk_permissions(reqs))
        timer.sync()
        t_check = time.perf_counter() - t0
        if not all(c.allowed for c in checks[: len(new)]):
            raise AssertionError("a creator cannot view the pod just created")
        touched += new + [(p, u) for ns, u in rnd["granted"]
                          for p in pods_in[ns][:4]]
        rounds.append({"write_ms": t_write * 1e3, "apply_ms": apply_ms,
                       "flush_ms": flush_ms, "lookup_s": t_lookup,
                       "check_s": t_check, "capture_ms": capture_ms,
                       "sweeps": int(graph.last_trace[0])})
        log(f"churn round {r}: {sum(len(x) for x in rnd['writes'])} updates "
            f"in {len(rnd['writes'])} writes {t_write * 1e3:.3f} ms; delta "
            f"application {apply_ms:.3f} ms, flush {flush_ms:.3f} ms (host); "
            f"read-after-write lookup batch {t_lookup:.4f} s, check batch "
            f"{t_check:.4f} s ({captures} sweep graph captures, "
            f"{capture_ms:.3f} ms of host); device tables equal host")
        if iso is not None:
            iso_subj, before, ctx, snap, snap0 = iso
            after = ep._lookup_batch_extract(ctx)
            if [sorted(x) for x in after] != [sorted(x) for x in before]:
                raise AssertionError("a batch captured before the writes "
                                     "changed its answers after the flush")
            if not all(torch.equal(a, b) for a, b in zip(snap, snap0)):
                raise AssertionError("the flush wrote a captured table")
            now, _ = lookup(iso_subj)
            changed = sum(sorted(a) != sorted(b) for a, b in zip(now, before))
            if not changed:
                raise AssertionError("isolation round: the writes changed "
                                     "no captured answer")
            log(f"snapshot isolation: a batch captured before round {r}'s "
                f"writes extracted its old answers after the flush ({changed}"
                f" of {len(iso_subj)} subjects' answers have since changed); "
                "the captured tables are unchanged")
    launches = dict(kernels.LAUNCHES)
    log(f"launches over the churn: {launches}")
    idle = [k for k in READ_KERNELS + ("scatter_rows",) if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched in phase 9: {idle}")
    d = {k: ep.stats[k] - stats0[k] for k in
         ("rebuilds", "spare_assignments", "spare_reclaims", "delta_batches",
          "stage_aux_flips", "stale_pair_marks")}
    graph = ep.graph()
    grown = len(graph._grow_extra)
    log(f"churn stats: {d}; rows grown {grown}; spare aux rows left "
        f"{len(graph._spare_aux)}")
    if d["rebuilds"] or not (d["spare_assignments"] and d["spare_reclaims"]
                             and (grown or d["stage_aux_flips"])):
        raise AssertionError(f"the churn was not absorbed incrementally: {d}")
    med = lambda k: statistics.median(x[k] for x in rounds)
    log(f"write path summary: median per round delta application "
        f"{med('apply_ms'):.3f} ms, flush {med('flush_ms'):.3f} ms (host), "
        f"sweep graph captures {med('capture_ms'):.3f} ms; read-after-write "
        f"lookup batch median {med('lookup_s'):.4f} s vs phase-4 warm median "
        f"{warm_lookup_s:.4f} s ({med('lookup_s') / warm_lookup_s:.3f}x; "
        f"limit 1.10x); check batch median {med('check_s'):.4f} s")

    # scatter_rows on the last round's real rows, against its twin, and
    # its times: main and aux table per flush
    last_lookup = [sorted(x) for x in res]
    last_checks = [c.allowed for c in checks]
    out_row = {"name": "scatter_rows", "route": "cuda",
               "source": KERNEL_SOURCE, "replaces": REPLACES["scatter_rows"],
               "launches": launches["scatter_rows"]}
    err, ms, plain, lib, nbytes, dims, work = 0, 0.0, 0.0, 0.0, 0, [], []
    for src, host_prev, host in zip(prev_tables, prev_host,
                                    (graph.host_main, graph.host_aux)):
        changed = np.nonzero((host != host_prev).any(axis=1))[0]
        if not len(changed):
            continue
        dev = src.device
        rows_np = changed.astype(np.int32)
        dup = np.concatenate([rows_np, rows_np[: max(1, len(rows_np) // 2)],
                              np.repeat(rows_np[-1:], 5)])
        t_rows = torch.from_numpy(dup).to(dev)
        t_vals = torch.from_numpy(host[dup]).to(dev)
        got = kernels.scatter_rows(src, t_rows, t_vals)
        want = reference.scatter_rows(src, t_rows, t_vals)
        live = graph.dev_main if host is graph.host_main else graph.dev_aux
        err = max(err, _diff(got, want), _diff(got, live))
        rows_t = torch.from_numpy(rows_np).to(dev)
        vals_t = torch.from_numpy(host[rows_np]).to(dev)
        rows64 = rows_t.long()
        ms += timer.ms(lambda: kernels.scatter_rows(src, rows_t, vals_t))
        plain += timer.ms(lambda: reference.scatter_rows(src, rows_t, vals_t))
        lib += timer.ms(lambda: torch.index_put(src, (rows64,), vals_t))
        work.append((src, rows_t, vals_t))
        r_, k_ = src.shape
        nbytes += 2 * r_ * k_ * 4 + len(rows_np) * (k_ + 1) * 4
        dims.append(f"[{r_}, {k_}] with {len(rows_np)} rows")
    if err:
        raise AssertionError(f"scatter_rows differs from its twin: {err}")
    log(f"scatter_rows vs twin on the last round's rows ({'; '.join(dims)}, "
        f"duplicates added): bit-identical; one flush {ms:.6f} ms, twin "
        f"{plain:.6f} ms, torch.index_put {lib:.6f} ms, bound "
        f"{nbytes / peak * 1e3:.6f} ms")
    out_row.update(max_abs_err=err, ms=ms, plain_ms=plain,
                   bound_ms=nbytes / peak * 1e3, bound_by="bytes",
                   library_ms=lib)
    if timer.cuda:
        # the flush (every touched table), then the main table alone
        out_row.update(split_times(
            lambda: [kernels.scatter_rows(*a) for a in work],
            lambda: [torch.index_put(t, (r.long(),), v) for t, r, v in work]))
        _log_split("scatter_rows, one flush", out_row)
        main = split_times(
            lambda: kernels.scatter_rows(*work[0]),
            lambda: torch.index_put(work[0][0], (work[0][1].long(),),
                                    work[0][2]))
        _log_split(f"scatter_rows, {dims[0]}", main)
        out_row.update({f"first_table_{k}": v for k, v in main.items()})

    # the incremental generation answers as a fresh build does
    t0 = time.perf_counter()
    ep.force_rebuild()
    timer.sync()
    t_rebuild = time.perf_counter() - t0
    res2, _ = lookup(subjects_of[-1])
    checks2 = asyncio.run(ep.check_bulk_permissions(reqs))
    if [sorted(x) for x in res2] != last_lookup or \
            [c.allowed for c in checks2] != last_checks:
        raise AssertionError("post-churn answers differ from force_rebuild()")
    log(f"force_rebuild() {t_rebuild:.3f} s (the per-write cost without "
        f"delta absorption); answers equal; check-batch sweeps "
        f"incremental {rounds[-1]['sweeps']}, rebuilt "
        f"{int(ep.graph().last_trace[0])}")

    # the host oracle on touched pairs and one creator's lookup
    oracle = ep._oracle
    t0 = time.perf_counter()
    sample = [touched[i] for i in rng.choice(len(touched),
                                             CHURN_ORACLE_CHECKS,
                                             replace=False)]
    got = asyncio.run(ep.check_bulk_permissions(
        [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
         for p, u in sample]))
    for (p, u), c in zip(sample, got):
        if oracle.check(ObjectRef("pod", p), "view",
                        SubjectRef("user", u)) != c.allowed:
            raise AssertionError(f"check pod:{p} user:{u} differs from the "
                                 "oracle")
    t1 = time.perf_counter()
    # the creator's lookup against the oracle's checks of every returned
    # pod, the pods it created and CHURN_ORACLE_PODS drawn at random (the
    # oracle's own lookup enumerates all 200,000 pods: ~60 s)
    creator = SubjectRef("user", plan[-1]["created"][0][2])
    got_ids = set(res2[subjects_of[-1].index(creator)])
    cand = got_ids | {c[0] for r in plan for c in r["created"]
                      if c[2] == creator.id} | {
        pods[int(i)] for i in rng.choice(len(pods), CHURN_ORACLE_PODS,
                                         replace=False)}
    if got_ids != _oracle_pods(oracle, sorted(cand), creator):
        raise AssertionError(f"lookup for {creator} differs from the oracle")
    log(f"oracle: {CHURN_ORACLE_CHECKS} touched-pair checks "
        f"({t1 - t0:.1f} s) and 1 creator lookup ({len(got_ids)} pods) "
        f"against the oracle's checks of {len(cand)} pods "
        f"({time.perf_counter() - t1:.1f} s) equal")
    log(f"phase 9 wall time {time.perf_counter() - t_phase:.1f} s")
    return out_row


def _cav_index(w):
    """From the caveated workload's tuples: user -> groups, group -> pods
    it is assigned to, and the caveated tuples (as written)."""
    member_of: dict = {}
    assigned: dict = {}
    caveated: list = []
    for r in w.relationships:
        if "[caveat:" in r:
            caveated.append(r)
        if r.startswith("group:") and "#member@user:" in r:
            g, u = r[len("group:"):].split("#member@user:")
            member_of.setdefault(u.split("[", 1)[0], []).append(g)
        elif "#assigned@group:" in r:
            p, g = r[len("pod:"):].split("#assigned@group:")
            assigned.setdefault(g.split("#", 1)[0], []).append(p)
    return member_of, assigned, caveated


def _cav_pairs(rng, users, pods, member_of, assigned, n):
    """`n` (pod, user) check pairs over `users`: half of them pods
    assigned to one of the user's groups (where HAS and CONDITIONAL
    live), half random pods."""
    out = []
    for k in range(n):
        u = users[int(rng.integers(len(users)))]
        groups = [g for g in member_of.get(u, ()) if g in assigned]
        if k % 2 == 0 and groups:
            g = groups[int(rng.integers(len(groups)))]
            out.append((assigned[g][int(rng.integers(len(assigned[g])))], u))
        else:
            out.append((pods[int(rng.integers(len(pods)))], u))
    return out


def _tri(results) -> list:
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import Permissionship
    code = {Permissionship.NO_PERMISSION: 0,
            Permissionship.CONDITIONAL_PERMISSION: 1,
            Permissionship.HAS_PERMISSION: 2}
    return [code[r.permissionship] for r in results]


def _cav_churn_plan(graph, caveated, member_of, assigned, users, seed):
    """Phase 10's writes, from the seed: per round (op, relationship) pairs
    and the (pod, user) pairs they touch.  Every caveated tuple is touched
    at most once; an undecidable insert goes only where its destination
    row of the caveat table still has a free slot (so the churn never
    needs a rebuild to grow a caveat tree)."""
    import random
    rng = random.Random(seed)
    prog = graph.prog
    dead = prog.dead_index
    free: dict = {}

    def take_slot(dst) -> bool:
        if dst not in free:
            free[dst] = int((graph.host_cav[dst] == dead).sum())
        if free[dst] <= 0:
            return False
        free[dst] -= 1
        return True

    def dst_of(rel: str):
        res, rest = rel.split("#", 1)
        t, rid = res.split(":", 1)
        return prog.state_index(t, rest.split("@", 1)[0], rid)

    def pairs_of(rel: str) -> list:
        res, rest = rel.split("#", 1)
        u = rest.split("@user:", 1)[1].split("[", 1)[0]
        if res.startswith("pod:"):
            return [(res[len("pod:"):], u)]
        return [(p, u) for p in assigned.get(res[len("group:"):], ())[:4]]

    pool = list(caveated)
    rng.shuffle(pool)
    groups = sorted(assigned)
    rng.shuffle(groups)
    plan = []
    for _ in range(CAV_ROUNDS):
        writes = []
        for _ in range(CAV_NEW):
            while True:
                g, u = groups.pop(), rng.choice(users)
                rel = f"group:{g}#member@user:{u}"
                if g not in member_of.get(u, ()) and take_slot(dst_of(rel)):
                    break
            writes.append(("touch", rel + UNDECIDED))
        flips = 0
        while flips < CAV_RETOUCH:
            rel = pool.pop()
            key, cav = rel.split("[caveat:", 1)
            if cav.startswith(UNDECIDED[len("[caveat:"):]):
                writes.append(("touch", key + DECIDED[flips % 2]))
            elif take_slot(dst_of(key)):
                writes.append(("touch", key + UNDECIDED))
            else:
                continue
            flips += 1
        for _ in range(CAV_DELETES):
            writes.append(("delete", pool.pop()))
        for _ in range(CAV_DEFINITE):
            writes.append(("touch", pool.pop().split("[caveat:", 1)[0]))
        rng.shuffle(writes)
        plan.append({"writes": writes,
                     "touched": [pr for _, rel in writes
                                 for pr in pairs_of(rel)]})
    return plan


def caveats(timer, peak, smi_line, device: str = "cuda",
            workload_kwargs: Optional[dict] = None) -> tuple:
    """Phase 10: the caveated deployment on a second endpoint.  Returns
    ({kernel name: measurements on the caveat path}, the endpoint, its
    workload, {"warm_lookup_s", "rounds"} of the write path)."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _sweep_bytes, _unify_check_buckets)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    ep, w = load(device, workload_kwargs or CAVEAT_WORKLOAD, "caveated_rbac")
    g = ep.graph()
    prog, kc = g.prog, g.kernel
    if not (g.has_cav and g.tri_state_capable and kc.planes):
        raise AssertionError("the caveated deployment compiled no planes")
    log(f"caveat planes: {len(prog.cav_src)} undecidable caveat edges; "
        f"tables main {list(g.dev_main.shape)}, aux {list(g.dev_aux.shape)} "
        f"({g.dev_aux.shape[0] - g._cav_aux_base + prog.state_size} caveat "
        f"OR-tree rows), caveat {list(g.dev_cav.shape)}; aux passes "
        f"{kc.aux_passes}, iteration cap {kc.num_iters}")
    member_of, assigned, caveated = _cav_index(w)
    users = w.subjects
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    rng = np.random.default_rng(SEED + 10)
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    lanes0 = [s.id for s in batches[0]]
    pairs = _cav_pairs(rng, lanes0, pods, member_of, assigned, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
            for p, u in pairs]
    res0 = ep.stats["oracle_residual_checks"]

    # the main path of this slice, launches counted from zero
    kernels.reset_launches()
    summary, lookups, checks = {}, [], []
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                lookups.append(asyncio.run(ep.lookup_resources_batch(
                    "pod", "view", batches[k])))
            else:
                checks.append(asyncio.run(ep.check_bulk_permissions(reqs)))
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(g.last_trace[0]))
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps}
        log(f"caveats {verb}: sweeps per batch {sweeps}; trace "
            f"{g.last_trace[: 1 + sweeps[-1]].tolist()}; e2e per batch cold "
            f"{e2e[0]:.4f} s, warm median {statistics.median(e2e[1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    log(f"launches on the caveat path: {launches}")
    _no_standalone_tail(launches, "phase 10")
    # the warm lookup batches again, split at the endpoint's two phases
    split = []
    for k in range(1, 1 + N_WARM):
        t0 = time.perf_counter()
        ctx = ep._lookup_batch_capture("pod", "view", batches[k])
        timer.sync()
        t1 = time.perf_counter()
        ep._lookup_batch_extract(ctx)
        split.append((t1 - t0, time.perf_counter() - t1))
    log(f"caveats lookup split over {N_WARM} warm batches: capture (encode, "
        f"sweeps, kernels) median "
        f"{statistics.median(a for a, _ in split):.4f} s, extract "
        f"(readback, per-subject column scan, id lists) median "
        f"{statistics.median(b for _, b in split):.4f} s")
    tri0 = _tri(checks[0])
    counts = {v: tri0.count(v) for v in (2, 1, 0)}
    log(f"caveats: check batch HAS {counts[2]}, CONDITIONAL {counts[1]}, NO "
        f"{counts[0]} of {len(reqs)}; lookup batch 0 allowed "
        f"{sum(len(r) for r in lookups[0])} (subject, pod) pairs")
    if not counts[1]:
        raise AssertionError("no CONDITIONAL answer: the MAYBE plane never "
                             "answered")
    if any(_tri(c) != tri0 for c in checks[1:]):
        raise AssertionError("repeated check batches disagree")
    if ep.stats["oracle_residual_checks"] != res0 or any(
            r.source != "kernel" for c in checks for r in c):
        raise AssertionError("caveat rows were routed to the oracle")

    # every kernel of a real Jacobi sweep against its twin, on the card,
    # on the full tables; then one whole batch on the CPU twins
    main, aux, cav = g.snapshot()
    dev = main.device
    q_arr, cmap, _ = ep._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(dev)
    n_words = len(q_arr) // 32
    width = kc.width(n_words)
    nt = prog.state_size + kc.n_aux_rows
    dead = prog.dead_index
    word = 4 * width
    rows = {}

    def row(name, err, ms, plain_ms, nbytes, ops, library_ms=None):
        b_bytes = nbytes / peak * 1e3
        b_ops = ops / INT_OPS_PER_S * 1e3
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(b_bytes, b_ops),
                      "bound_by": "bytes" if b_bytes >= b_ops
                      else "operations", "library_ms": library_ms}

    wc, live = kc._wc_ranges, None
    if wc is not None:
        live = torch.empty((wc.shape[0], width), dtype=torch.int32,
                           device=dev)
    x0 = kernels.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc,
                                live=live, planes=True)
    x0_t = reference.seed_bitplanes(q, nt, n_words, dead, wc_ranges=wc,
                                    live=None if live is None
                                    else torch.empty_like(live), planes=True)
    row("seed_bitplanes", _diff(x0, x0_t),
        timer.ms(lambda: kernels.seed_bitplanes(q, nt, n_words, dead, out=x0,
                                                wc_ranges=wc, live=live,
                                                planes=True)),
        timer.ms(lambda: reference.seed_bitplanes(q, nt, n_words, dead,
                                                  wc_ranges=wc, live=live,
                                                  planes=True)),
        q.numel() * 4 + nt * word, 2 * q.numel())
    err, steps, x = _twin_sweeps(kc, (main, aux, cav), x0, live, n_words,
                                 "Jacobi sweep")
    # per-sweep work of each sweep kernel at this batch's shapes; bytes:
    # each input read once (distinct gathered rows), each output written
    # once; the caveat gather reads and writes only the maybe half of the
    # rows it reaches
    per = {k: [0.0, 0.0, 0, 0] for k in ("ell_gather_or", "cav_gather_or",
                                         "perm_program")}
    x_in = x.clone()
    cur = x.clone()
    for step in steps:
        name = step[0]
        acc = per[name]
        acc[0] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, kernels, x_in=x_in))
        acc[1] += timer.ms(lambda: EllKernelCache.run_step(
            step, cur, x0, live, reference, x_in=x_in), reps=2)
        if name == "ell_gather_or":
            idx, seeded, wcb = step[1], step[3], step[4]
            n, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            acc[2] += (n * k * 4 + uniq * word + n * word * (1 + seeded)
                       + (n * 4 + word * live.shape[0] if wcb is not None
                          else 0))
            acc[3] += n * width * (k + seeded)
        elif name == "cav_gather_or":
            _, idx, half, _ = step
            r_, k = idx.shape
            uniq = int(torch.unique(idx).numel())
            reached = int((idx != dead).any(dim=1).sum())
            acc[2] += r_ * k * 4 + (uniq + 2 * reached) * 4 * half
            acc[3] += r_ * half * k
        else:
            code, length = step[1], step[3]
            n_read = int((code[0::2] == 0).sum())
            acc[2] += code.numel() * 4 + length * word * (n_read + 2)
            acc[3] += length * width * (code.numel() // 2 + 1)
    for name, (ms, plain, nbytes, ops) in per.items():
        row(name, err[name], ms, plain, nbytes, ops)
    x_prev = x.clone()
    row("sweep_delta", err["sweep_delta"],
        timer.ms(lambda: kernels.sweep_delta(cur, x_prev, dead)),
        timer.ms(lambda: reference.sweep_delta(cur, x_prev, dead), reps=2),
        2 * nt * word + 8, 3 * nt * width)
    if timer.cuda:
        _split_into(rows, sweep_split(kc, (main, aux, cav), x0, live, x,
                                      steps, n_words, "Jacobi sweep"))
        rows["ell_gather_or"]["sweep"]["bound_ms"] = (
            sum(per[k][2] for k in per) + 4 * nt * word + 8) / peak * 1e3

    x_final, trace = kc.evaluate(q, n_words, main, aux, kc.take_arena(n_words),
                                 cav)
    qa, cm, _ = ep._encode_subjects(g, [r.subject for r in reqs])
    gidx = [prog.state_index("pod", "view", r.resource.id) for r in reqs]
    gcol = [cm[r.subject] for r in reqs]
    _, gi, gc = _unify_check_buckets(qa, gidx, gcol)
    gi, gc = torch.from_numpy(gi).to(dev), torch.from_numpy(gc).to(dev)
    out_k = kernels.check_gather3(x_final, gi, gc, n_words)
    out_t = reference.check_gather3(x_final, gi, gc, n_words)
    cells = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    row("check_gather3", _diff(out_k, out_t),
        timer.ms(lambda: kernels.check_gather3(x_final, gi, gc, n_words)),
        timer.ms(lambda: reference.check_gather3(x_final, gi, gc, n_words)),
        gi.numel() * 4 * 3 + cells * 4 * 2, 5 * gi.numel())
    rows["sweep_delta_checks"] = check_tail(
        ep, kc, q, n_words, (main, aux, cav), x_final, x_prev, reqs,
        gi.cpu().numpy(), gc.cpu().numpy(), timer, peak, "phase 10")
    off, length = prog.slot_range("pod", "view")
    lk = kernels.lookup_T(x_final, off, length, n_words)
    row("lookup_T", _diff(lk, reference.lookup_T(x_final, off, length,
                                                 n_words)),
        timer.ms(lambda: kernels.lookup_T(x_final, off, length, n_words)),
        timer.ms(lambda: reference.lookup_T(x_final, off, length, n_words)),
        2 * length * 4 * n_words, 0,
        library_ms=timer.ms(lambda: x_final.narrow(0, off, length)
                            [:, :n_words].t().contiguous()))
    if timer.cuda:
        rows["lookup_T"].update(split_times(
            lambda: kernels.lookup_T(x_final, off, length, n_words),
            lambda: x_final.narrow(0, off, length)[:, :n_words].t()
            .contiguous()))
        _log_split(f"lookup_T, definite plane [{n_words}, {length}]",
                   rows["lookup_T"])
    bad = {n: r["max_abs_err"] for n, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise AssertionError(f"caveat-path kernels disagree with their "
                             f"twins: {bad}")
    log(f"caveat-path kernels vs twins on the full tables: all bit-identical"
        f" ({len(steps)} Jacobi steps x 2 sweeps, plane seed, delta over "
        f"{width} words, {gi.numel()} tri-state gathers, [{n_words}, "
        f"{length}] definite lookup words)")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    kc_cpu = EllKernelCache(prog, n_aux_rows=kc.n_aux_rows,
                            tree_depth=kc.tree_depth, device=cpu,
                            shared_tree_depth=kc.aux_passes - 1, planes=True)
    if kc_cpu.num_iters != kc.num_iters:
        raise AssertionError("CPU twin cache has another iteration cap")
    x_cpu, tr_cpu = kc_cpu.evaluate(q.cpu(), n_words, main.cpu(), aux.cpu(),
                                    kc_cpu.take_arena(n_words), cav.cpu())
    if not (torch.equal(x_final.cpu(), x_cpu) and np.array_equal(trace, tr_cpu)
            and torch.equal(lk.cpu(), reference.lookup_T(x_cpu, off, length,
                                                         n_words))):
        raise AssertionError("card and CPU-twin caveat sweeps disagree")
    log(f"whole caveat batch on the CPU twins: state, trace "
        f"{tr_cpu[:1 + tr_cpu[0]].tolist()} and lookup words equal the "
        f"card's ({time.perf_counter() - t0:.1f} s)")
    if timer.cuda:
        graph_batch_checks(ep, kc, q, n_words, (main, aux, cav), x_final,
                           trace, steps, batches[1], "pod", "Jacobi")
    model = _sweep_bytes(g, LOOKUP_LANES)
    sweep_ms = (sum(per[k][0] for k in per) + rows["sweep_delta"]["ms"])
    log(f"caveat sweep byte model (reference _sweep_bytes, planes): {model} "
        f"bytes per sweep at {LOOKUP_LANES} lanes; bound "
        f"{model / peak * 1e3:.6f} ms at {peak / 1e12:.2f} TB/s ({smi_line});"
        f" measured sweep kernels {sweep_ms:.6f} ms -> "
        f"{model / peak * 1e3 / sweep_ms:.4f} of the bound (ell_gather_or "
        f"{per['ell_gather_or'][0]:.6f}, cav_gather_or "
        f"{per['cav_gather_or'][0]:.6f}, perm_program "
        f"{per['perm_program'][0]:.6f}, sweep_delta "
        f"{rows['sweep_delta']['ms']:.6f})")

    # the host oracle: checks (CONDITIONAL ones included) and one lookup
    oracle = ep._oracle
    t0 = time.perf_counter()
    cond = [i for i, v in enumerate(tri0) if v == 1]
    pick = list(rng.choice(cond, min(len(cond), CAV_ORACLE_CONDITIONAL),
                           replace=False))
    rest = [i for i in range(len(reqs)) if tri0[i] != 1]
    pick += list(rng.choice(rest, CAV_ORACLE_CHECKS - len(pick),
                            replace=False))
    for i in pick:
        r = reqs[int(i)]
        if oracle.check3(r.resource, r.permission, r.subject) != tri0[int(i)]:
            raise AssertionError(f"check {r} differs from the oracle")
    t1 = time.perf_counter()
    # a subject with pods and an undecidable ban: its CONDITIONAL pod must
    # be missing from the lookup, as from the oracle's
    maybe_banned = {r.split("@user:")[1].split("[", 1)[0] for r in caveated
                    if r.startswith("pod:") and r.endswith(UNDECIDED)}
    i = max(range(len(lanes0)), key=lambda k: (lanes0[k] in maybe_banned,
                                               len(lookups[0][k])))
    want = sorted(oracle.lookup_resources("pod", "view", batches[0][i]))
    if sorted(lookups[0][i]) != want:
        raise AssertionError(f"lookup for {batches[0][i]} differs from the "
                             f"oracle")
    log(f"caveat oracle: {len(pick)} checks ({min(len(cond), CAV_ORACLE_CONDITIONAL)}"
        f" CONDITIONAL; {t1 - t0:.1f} s) and 1 lookup of {lanes0[i]} "
        f"({'an undecidable ban, ' if lanes0[i] in maybe_banned else ''}"
        f"{len(want)} pods; {time.perf_counter() - t1:.1f} s) equal")

    # caveat churn: absorbed without a rebuild, read back at once
    plan = _cav_churn_plan(g, caveated, member_of, assigned, users,
                           SEED + 11)
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    stats0 = dict(ep.stats)
    touched: list = []
    rounds = []
    churn_launches = dict.fromkeys(kernels.KERNEL_NAMES, 0)
    for r, rnd in enumerate(plan):
        a0, f0 = ep.stats["delta_apply_s"], ep.stats["flush_s"]
        t0 = time.perf_counter()

        async def commit():
            for o, rel in rnd["writes"]:
                await ep.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))])
        asyncio.run(commit())
        t_write = time.perf_counter() - t0
        touched += rnd["touched"]
        names = list(dict.fromkeys(u for _, u in rnd["touched"]))
        names += [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                               replace=False)]
        subjects = [SubjectRef("user", u)
                    for u in list(dict.fromkeys(names))[:LOOKUP_LANES]]
        kernels.reset_launches()
        gs0 = dict(kc.graph_stats)
        t0 = time.perf_counter()
        res = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
        lookup_capture_ms = (kc.graph_stats["capture_s"]
                             - gs0["capture_s"]) * 1e3
        # the same batch again with no write between: the batch's own cost,
        # so that lookup_s - again_s is what the round's writes added
        t0 = time.perf_counter()
        again = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                      subjects))
        timer.sync()
        t_again = time.perf_counter() - t0
        if [sorted(a) for a in again] != [sorted(a) for a in res]:
            raise AssertionError("a repeated lookup batch differs")
        _tables_match(g)
        round_pairs = touched + _cav_pairs(
            rng, [s.id for s in subjects], pods, member_of, assigned,
            N_CHECKS - len(touched))
        creqs = [CheckRequest(ObjectRef("pod", p), "view",
                              SubjectRef("user", u)) for p, u in round_pairs]
        t0 = time.perf_counter()
        cres = _tri(asyncio.run(ep.check_bulk_permissions(creqs)))
        timer.sync()
        t_check = time.perf_counter() - t0
        for k, v in kernels.LAUNCHES.items():
            churn_launches[k] += v
        for p, u in rnd["touched"][:24]:
            j = round_pairs.index((p, u))
            if oracle.check3(ObjectRef("pod", p), "view",
                             SubjectRef("user", u)) != cres[j]:
                raise AssertionError(f"read-after-write check pod:{p} "
                                     f"user:{u} differs from the oracle")
        rounds.append({"apply_ms": (ep.stats["delta_apply_s"] - a0) * 1e3,
                       "flush_ms": (ep.stats["flush_s"] - f0) * 1e3,
                       "lookup_s": t_lookup, "again_s": t_again,
                       "check_s": t_check,
                       "lookup_capture_ms": lookup_capture_ms,
                       "capture_ms": (kc.graph_stats["capture_s"]
                                      - gs0["capture_s"]) * 1e3})
        log(f"caveat churn round {r}: {len(rnd['writes'])} writes "
            f"{t_write * 1e3:.3f} ms; delta application "
            f"{rounds[-1]['apply_ms']:.3f} ms, flush "
            f"{rounds[-1]['flush_ms']:.3f} ms (host); read-after-write "
            f"lookup batch {t_lookup:.4f} s ({lookup_capture_ms:.3f} ms of "
            f"sweep graph capture; the same batch again {t_again:.4f} s), "
            f"check batch {t_check:.4f} s "
            f"(sweeps {int(g.last_trace[0])}, CONDITIONAL "
            f"{cres.count(1)}; {kc.graph_stats['captures'] - gs0['captures']}"
            f" sweep graph captures, {rounds[-1]['capture_ms']:.3f} ms of "
            f"host); device tables equal host")
    d = {k: ep.stats[k] - stats0[k] for k in
         ("rebuilds", "delta_batches", "stale_pair_marks",
          "oracle_residual_checks")}
    log(f"caveat churn stats: {d}; launches over the rounds "
        f"{churn_launches}")
    if d["rebuilds"] or d["stale_pair_marks"] or d["oracle_residual_checks"] \
            or ep.graph() is not g:
        raise AssertionError(f"the caveat churn was not absorbed "
                             f"incrementally: {d}")
    med = lambda k: statistics.median(x[k] for x in rounds)
    warm = statistics.median(summary["lookup"]["e2e_s"][1:])
    added = statistics.median(x["lookup_s"] - x["again_s"] for x in rounds)
    log(f"caveat write path summary: median per round delta application "
        f"{med('apply_ms'):.3f} ms, flush {med('flush_ms'):.3f} ms (host), "
        f"sweep graph captures {med('capture_ms'):.3f} ms "
        f"({med('lookup_capture_ms'):.3f} ms in the lookup); read-after-write "
        f"lookup batch median {med('lookup_s'):.4f} s vs warm median "
        f"{warm:.4f} s ({med('lookup_s') / warm:.3f}x; limit 1.10x); the "
        f"same batches again {med('again_s'):.4f} s "
        f"({med('again_s') / warm:.3f}x), the writes' share "
        f"{added * 1e3:.3f} ms; check batch median {med('check_s'):.4f} s")
    t0 = time.perf_counter()
    ep.force_rebuild()
    timer.sync()
    t_rebuild = time.perf_counter() - t0
    res2 = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    cres2 = _tri(asyncio.run(ep.check_bulk_permissions(creqs)))
    if [sorted(x) for x in res2] != [sorted(x) for x in res] or cres2 != cres:
        raise AssertionError("post-churn caveat answers differ from "
                             "force_rebuild()")
    t1 = time.perf_counter()
    for j in rng.choice(len(touched), min(len(touched), CAV_CHURN_ORACLE),
                        replace=False):
        p, u = touched[int(j)]
        if oracle.check3(ObjectRef("pod", p), "view",
                         SubjectRef("user", u)) != cres[int(j)]:
            raise AssertionError(f"check pod:{p} user:{u} differs from the "
                                 "oracle after the churn")
    log(f"force_rebuild() {t_rebuild:.3f} s; post-churn answers equal; "
        f"{min(len(touched), CAV_CHURN_ORACLE)} touched-pair checks equal "
        f"the oracle ({time.perf_counter() - t1:.1f} s)")
    need = [k for k in CAVEAT_KERNELS if not (launches[k]
                                              or churn_launches[k])]
    if need:
        raise AssertionError(f"kernels never launched in phase 10: {need}")
    log(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s")
    for name, r in rows.items():
        r["launches"] = launches[name]
    return rows, ep, w, {"warm_lookup_s": warm, "rounds": rounds}


def _seg_rows(rows, name, err, ms, plain_ms, nbytes, ops, peak,
              library_ms=None):
    """A kernel-table row: bound = max(bytes over the memory rate, integer
    operations over the integer rate)."""
    b_bytes = nbytes / peak * 1e3
    b_ops = ops / INT_OPS_PER_S * 1e3
    rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(b_bytes, b_ops),
                  "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                  "library_ms": library_ms}


def segment_path(ep, w, timer, peak, smi_line, device: str = "cuda",
                 n_rounds: int = SEG_ROUNDS) -> dict:
    """Phase 11: the segment kernel on the phase-3 store, beside the ELL
    endpoint.  Returns {kernel name: measurements on the segment path}."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.spmv import KernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _SegmentGraph, _sweep_bytes, _unify_check_buckets)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    url = direct_url(device)
    seg = create_endpoint(url, Bootstrap(w.schema_text, ""),
                          kernel="segment", store=ep.store)
    t0 = time.perf_counter()
    g = seg.graph()
    timer.sync()
    t_build = time.perf_counter() - t0
    if not isinstance(g, _SegmentGraph) or seg.kernel_kind != "segment":
        raise AssertionError("kernel='segment' built another graph kind")
    prog = g.prog
    cap = int(g.edge_src.shape[0])
    log(f"segment graph: {prog.state_size} state rows, {len(prog.edge_src)} "
        f"edges in a {cap}-edge capacity ({len(g.free)} free, padding "
        f"dead -> dead), {len(g.positions)} tuples positioned; build "
        f"{t_build:.3f} s (tuple-list compile, as the reference's); Leopard "
        f"statuses {seg._leopard.status_map()}")

    rng = np.random.default_rng(SEED + 11)
    users = w.subjects
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    subj = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", batches[0][s])
            for i, s in zip(pick, subj)]
    rebuilds0 = (seg.stats["rebuilds"], ep.stats["rebuilds"])

    # the segment path's read batches, launches counted from zero
    kernels.reset_launches()
    summary, lookups, checks = {}, [], []
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                lookups.append(asyncio.run(seg.lookup_resources_batch(
                    "pod", "view", batches[k])))
            else:
                checks.append(asyncio.run(seg.check_bulk_permissions(reqs)))
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(g.last_trace[0]))
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps}
        log(f"segment {verb}: sweeps per batch {sweeps}; trace "
            f"{g.last_trace[: 1 + sweeps[-1]].tolist()}; e2e per batch cold "
            f"{e2e[0]:.4f} s, warm median {statistics.median(e2e[1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    log(f"launches on the segment path: {launches}")
    idle = [k for k in SEGMENT_KERNELS if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched on the segment path: "
                             f"{idle}")

    # the ELL endpoint on the same batches: every lane and pair equal
    t0 = time.perf_counter()
    for k in range(1 + N_WARM):
        ell = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                    batches[k]))
        if [sorted(x) for x in ell] != [sorted(x) for x in lookups[k]]:
            raise AssertionError(f"segment lookup batch {k} differs from "
                                 "the ELL endpoint's")
    ell_checks = asyncio.run(ep.check_bulk_permissions(reqs))
    if any([c.allowed for c in ell_checks] != [c.allowed for c in cs]
           for cs in checks):
        raise AssertionError("segment checks differ from the ELL endpoint's")
    log(f"segment vs ELL: {1 + N_WARM} lookup batches x {LOOKUP_LANES} lanes "
        f"and {1 + N_WARM} check batches x {len(reqs)} pairs equal "
        f"({sum(len(x) for x in lookups[0])} allowed (subject, pod) pairs, "
        f"{sum(c.allowed for c in checks[0])} allowed checks; "
        f"{time.perf_counter() - t0:.1f} s)")

    # the kernels of one real sweep against their twins, on the full edge
    # arrays (padding edges in), step by step
    kc = g.kernel
    src, dst = g.snapshot()
    dev = src.device
    q_arr, _, _ = seg._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(dev)
    n_words = len(q_arr) // 32
    n, dead = prog.state_size, prog.dead_index
    word = 4 * n_words
    rows = {}
    x0, live = kc.init_state(q, n_words)
    x0_t = reference.seed_bitplanes(q, n, n_words, dead)
    _seg_rows(rows, "seed_bitplanes", _diff(x0, x0_t),
              timer.ms(lambda: kc.init_state(q, n_words, out=x0)),
              timer.ms(lambda: reference.seed_bitplanes(q, n, n_words, dead)),
              q.numel() * 4 + n * word, q.numel(), peak)
    steps = list(kc.sweep_steps(src, dst))
    err = {"edge_or": 0, "perm_program": 0, "sweep_delta": 0}
    x = x0.clone()
    for sweep in range(2):
        y_k = torch.empty_like(x)
        y_t = torch.empty_like(x)
        for i, step in enumerate(steps):
            kc.run_step(step, y_k, x, x0, live, kernels)
            kc.run_step(step, y_t, x, x0, live, reference)
            if step[0] in err:
                err[step[0]] = max(err[step[0]], _diff(y_k, y_t))
            if _diff(y_k, y_t):
                raise AssertionError(f"{step[0]} differs from its twin at "
                                     f"segment step {i} of sweep {sweep}")
        d_k = kernels.sweep_delta(y_k, x, dead)
        d_t = reference.sweep_delta(y_t, x, dead)
        err["sweep_delta"] = max(err["sweep_delta"], _diff(d_k.cpu(), d_t)
                                 + _diff(y_k, y_t))
        x = y_k
    # edge_or alone on the full arrays, from a zero state and from the
    # seed-initialized one, bit for bit, skipping the dead row's edges as
    # the sweep does and skipping nothing
    for base in (torch.zeros_like(x), x0):
        for skip in (dead, None):
            a, b = base.clone(), base.clone()
            kernels.edge_or(a, x, src, dst, dead=skip)
            reference.edge_or(b, x, src, dst)
            err["edge_or"] = max(err["edge_or"], _diff(a, b))
    if any(err.values()):
        raise AssertionError(f"segment kernels disagree with their twins: "
                             f"{err}")
    # per-sweep times at this batch's shapes, on the state after 2 sweeps
    y = torch.empty_like(x)
    per = {"init": [0.0, 0.0], "edge_or": [0.0, 0.0],
           "perm_program": [0.0, 0.0]}
    for step in steps:
        acc = per[step[0]]
        acc[0] += timer.ms(lambda: kc.run_step(step, y, x, x0, live,
                                               kernels))
        acc[1] += timer.ms(lambda: kc.run_step(step, y, x, x0, live,
                                               reference), reps=2)
    # edge_or's bound: the edge arrays, each distinct source row's words
    # read once and each distinct destination row's words read and
    # written once (the packed bytes the kernel must move; the
    # reference's model counts float32 lanes); one OR per edge word
    uniq_src = int(torch.unique(src).numel())
    uniq_dst = int(torch.unique(dst).numel())
    e_bytes = cap * 8 + uniq_src * word + 2 * uniq_dst * word
    # the library yardstick: the reference's float32 [N, B] layout, one
    # gather and one index_reduce_ "amax" (timed apart)
    lanes_f = 32 * n_words
    xf = ((x.view(torch.uint8).unsqueeze(-1) >> torch.arange(
        8, device=dev, dtype=torch.uint8)) & 1).reshape(n, lanes_f) \
        .to(torch.float32)
    src64, dst64 = src.long(), dst.long()
    gathered = xf[src64]
    yf = torch.zeros_like(xf)
    gather_ms = timer.ms(lambda: xf.index_select(0, src64), reps=3)
    reduce_ms = timer.ms(lambda: yf.index_reduce_(0, dst64, gathered,
                                                  "amax"), reps=3)
    del xf, gathered, yf
    _seg_rows(rows, "edge_or", err["edge_or"], per["edge_or"][0],
              per["edge_or"][1], e_bytes, cap * n_words, peak,
              library_ms=reduce_ms)
    code_ops = 0
    p_bytes = 0
    for step in steps:
        if step[0] == "perm_program":
            code, length = step[1], step[3]
            n_read = int((code[0::2] == 0).sum())
            p_bytes += code.numel() * 4 + length * word * (n_read + 2)
            code_ops += length * n_words * (code.numel() // 2 + 1)
    _seg_rows(rows, "perm_program", err["perm_program"],
              per["perm_program"][0], per["perm_program"][1], p_bytes,
              code_ops, peak)
    x_prev = x.clone()
    _seg_rows(rows, "sweep_delta", err["sweep_delta"],
              timer.ms(lambda: kernels.sweep_delta(y, x_prev, dead)),
              timer.ms(lambda: reference.sweep_delta(y, x_prev, dead),
                       reps=2),
              2 * n * word + 8, 3 * n * n_words, peak)
    sweep_ms = (per["init"][0] + per["edge_or"][0] + per["perm_program"][0]
                + rows["sweep_delta"]["ms"])
    model = _sweep_bytes(g, LOOKUP_LANES)
    log(f"segment kernels vs twins on the full edge arrays ({cap} edges, "
        f"{cap - len(prog.edge_src)} of them padding at the build): all "
        f"bit-identical ({len(steps)} steps x 2 sweeps, edge_or alone twice,"
        f" seed, delta); per sweep: init (seed copy) "
        f"{per['init'][0]:.6f} ms, edge_or {per['edge_or'][0]:.6f} ms "
        f"(bound {rows['edge_or']['bound_ms']:.6f} ms over {e_bytes} packed "
        f"bytes), perm_program {per['perm_program'][0]:.6f} ms, sweep_delta "
        f"{rows['sweep_delta']['ms']:.6f} ms; whole sweep {sweep_ms:.6f} ms. "
        f"Reference byte model (_sweep_bytes, float32 lanes): {model} bytes "
        f"-> {model / peak * 1e3:.6f} ms at {peak / 1e12:.2f} TB/s "
        f"({smi_line}). Library yardstick on the float32 [{n}, {lanes_f}] "
        f"layout: x[src] gather {gather_ms:.6f} ms, index_reduce_ amax "
        f"{reduce_ms:.6f} ms")

    # checks and lookups of the converged state, and one whole batch on
    # the CPU twins
    x_final, trace = kc.evaluate(q, n_words, src, dst,
                                 kc.take_arena(n_words))
    qa, cm, _ = seg._encode_subjects(g, [r.subject for r in reqs])
    gidx = [prog.state_index("pod", "view", r.resource.id) for r in reqs]
    gcol = [cm[r.subject] for r in reqs]
    _, gi, gc = _unify_check_buckets(qa, gidx, gcol)
    gi, gc = torch.from_numpy(gi).to(dev), torch.from_numpy(gc).to(dev)
    cells = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    _seg_rows(rows, "check_gather",
              _diff(kernels.check_gather(x_final, gi, gc),
                    reference.check_gather(x_final, gi, gc)),
              timer.ms(lambda: kernels.check_gather(x_final, gi, gc)),
              timer.ms(lambda: reference.check_gather(x_final, gi, gc)),
              gi.numel() * 4 * 3 + cells * 4, 3 * gi.numel(), peak)
    off, length = prog.slot_range("pod", "view")
    lk = kernels.lookup_T(x_final, off, length)
    _seg_rows(rows, "lookup_T", _diff(lk, reference.lookup_T(x_final, off,
                                                             length)),
              timer.ms(lambda: kernels.lookup_T(x_final, off, length)),
              timer.ms(lambda: reference.lookup_T(x_final, off, length)),
              2 * length * word, 0, peak,
              library_ms=timer.ms(lambda: x_final.narrow(0, off, length)
                                  .t().contiguous()))
    if timer.cuda:
        rows["lookup_T"].update(split_times(
            lambda: kernels.lookup_T(x_final, off, length),
            lambda: x_final.narrow(0, off, length).t().contiguous()))
        _log_split(f"segment lookup_T [{word // 4}, {length}]",
                   rows["lookup_T"])
    bad = {k: r["max_abs_err"] for k, r in rows.items() if r["max_abs_err"]}
    if bad:
        raise AssertionError(f"segment read kernels disagree: {bad}")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    kc_cpu = KernelCache(prog, cpu)
    if kc_cpu.num_iters != kc.num_iters:
        raise AssertionError("CPU twin cache has another iteration cap")
    x_cpu, tr_cpu = kc_cpu.evaluate(q.cpu(), n_words, src.cpu(), dst.cpu(),
                                    kc_cpu.take_arena(n_words))
    if not (torch.equal(x_final.cpu(), x_cpu) and np.array_equal(trace, tr_cpu)
            and torch.equal(lk.cpu(), reference.lookup_T(x_cpu, off,
                                                         length))):
        raise AssertionError("card and CPU-twin segment sweeps disagree")
    log(f"whole segment batch on the CPU twins: state, trace "
        f"{tr_cpu[:1 + tr_cpu[0]].tolist()} and lookup words equal the "
        f"card's ({time.perf_counter() - t0:.1f} s)")

    # churn through the shared store: both endpoints absorb it
    plan = _churn_plan(w, n_rounds, SEED + 11, tag="s")
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    scatter = 0
    flushes = []
    for r, rnd in enumerate(plan):
        f0 = seg.stats["flush_s"]
        a0 = seg.stats["delta_apply_s"]
        if r == n_rounds - 1:
            prev_dev = g.snapshot()
            prev_host = (g.host_src.copy(), g.host_dst.copy())

        async def commit():
            for wr in rnd["writes"]:
                await seg.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))
                     for o, rel in wr])
        asyncio.run(commit())
        creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
        extra = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                              replace=False)]
        names = list(dict.fromkeys(creators + extra))[:LOOKUP_LANES]
        subjects = [SubjectRef("user", u) for u in names]
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = asyncio.run(seg.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
        n_scatter = kernels.LAUNCHES["scatter_rows"]
        scatter += n_scatter
        if not n_scatter:
            raise AssertionError("the segment flush launched no scatter_rows")
        g2 = seg.graph()
        if g2 is not g:
            raise AssertionError("the segment endpoint rebuilt under churn")
        s_now, d_now = g.snapshot()
        if not (np.array_equal(s_now.cpu().numpy(), g.host_src)
                and np.array_equal(d_now.cpu().numpy(), g.host_dst)):
            raise AssertionError("card edge arrays differ from the host's "
                                 "after the flush")
        flushes.append((seg.stats["flush_s"] - f0) * 1e3)
        new = [(pod, u) for pod, _, u in rnd["created"]]
        pick = rng.choice(len(pods), N_CHECKS - len(new), replace=False)
        pairs = new + [(pods[i], names[j]) for i, j in
                       zip(pick, rng.integers(0, len(names), len(pick)))]
        creqs = [CheckRequest(ObjectRef("pod", p_), "view",
                              SubjectRef("user", u)) for p_, u in pairs]
        t0 = time.perf_counter()
        cres = asyncio.run(seg.check_bulk_permissions(creqs))
        timer.sync()
        t_check = time.perf_counter() - t0
        ell = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        ell_c = asyncio.run(ep.check_bulk_permissions(creqs))
        if [sorted(a) for a in res] != [sorted(b) for b in ell] or \
                [c.allowed for c in cres] != [c.allowed for c in ell_c]:
            raise AssertionError(f"segment and ELL answers differ after "
                                 f"churn round {r}")
        if not all(c.allowed for c in cres[: len(new)]):
            raise AssertionError("a creator cannot view the pod just created")
        log(f"segment churn round {r}: {sum(len(x) for x in rnd['writes'])} "
            f"updates; delta application "
            f"{(seg.stats['delta_apply_s'] - a0) * 1e3:.3f} ms, flush "
            f"{flushes[-1]:.3f} ms (host, {n_scatter} scatter_rows "
            f"launches); read-after-write lookup {t_lookup:.4f}"
            f" s, check {t_check:.4f} s (sweeps {int(g.last_trace[0])}); "
            f"{len(g.free)} free edge positions; card arrays equal host; "
            "answers equal the ELL endpoint's")
    if (seg.stats["rebuilds"], ep.stats["rebuilds"]) != rebuilds0:
        raise AssertionError("a rebuild happened during the segment churn")
    # edge_or again on the arrays the last flush produced: inserts sit in
    # free positions out of destination order
    src_c, dst_c = g.snapshot()
    descents = int((np.diff(g.host_dst.astype(np.int64)) < 0).sum())
    live_c = int((g.host_src != dead).sum())
    churn_err = 0
    for base in (torch.zeros_like(x), x0):
        a, b = base.clone(), base.clone()
        kernels.edge_or(a, x, src_c, dst_c, dead=dead)
        reference.edge_or(b, x, src_c, dst_c)
        churn_err = max(churn_err, _diff(a, b))
    if churn_err:
        raise AssertionError(f"edge_or differs from its twin on the "
                             f"churned edge arrays: {churn_err}")
    log(f"edge_or vs twin on the edge arrays after {n_rounds} churn rounds "
        f"({live_c} live edges of {cap}; {descents} positions whose "
        f"destination is below the one before it): bit-identical, "
        f"{timer.ms(lambda: kernels.edge_or(a, x, src_c, dst_c, dead=dead)):.6f}"
        f" ms a call")
    # scatter_rows at the segment flush's shapes: the last round's edge
    # positions into each [cap, 1] edge array, against its twin and
    # torch.index_put; the captured arrays are the pre-flush snapshot
    changed = np.nonzero((g.host_src != prev_host[0])
                         | (g.host_dst != prev_host[1]))[0].astype(np.int32)
    rows_t = torch.from_numpy(changed).to(dev)
    rows64 = rows_t.long()
    s_err, s_ms, s_plain, s_lib, s_work = 0, 0.0, 0.0, 0.0, []
    for old, host, live_arr in zip(prev_dev, (g.host_src, g.host_dst),
                                   g.snapshot()):
        old2 = old.view(cap, 1)
        vals = torch.from_numpy(host[changed][:, None].copy()).to(dev)
        s_work.append((old2, rows_t, vals))
        got = kernels.scatter_rows(old2, rows_t, vals)
        s_err = max(s_err, _diff(got, reference.scatter_rows(old2, rows_t,
                                                             vals)),
                    _diff(got.view(cap), live_arr))
        s_ms += timer.ms(lambda: kernels.scatter_rows(old2, rows_t, vals))
        s_plain += timer.ms(lambda: reference.scatter_rows(old2, rows_t,
                                                           vals))
        s_lib += timer.ms(lambda: torch.index_put(old2, (rows64,), vals))
    if s_err:
        raise AssertionError(f"scatter_rows differs on the edge arrays: "
                             f"{s_err}")
    s_bytes = 2 * (2 * cap * 4 + len(changed) * 2 * 4)
    log(f"scatter_rows vs twin on the last round's {len(changed)} edge "
        f"positions of both [{cap}, 1] arrays: bit-identical, equal to the "
        f"flushed arrays; one flush {s_ms:.6f} ms, twin {s_plain:.6f} ms, "
        f"torch.index_put {s_lib:.6f} ms, bound {s_bytes / peak * 1e3:.6f}"
        f" ms")
    med = lambda v: statistics.median(v[1:])
    log(f"segment summary: warm median lookup "
        f"{med(summary['lookup']['e2e_s']):.6f} s, check "
        f"{med(summary['check']['e2e_s']):.6f} s; sweeps "
        f"{summary['lookup']['sweeps'][-1]}; edge_or {per['edge_or'][0]:.6f} "
        f"ms per sweep vs bound {rows['edge_or']['bound_ms']:.6f} ms; whole "
        f"sweep {sweep_ms:.6f} ms; flush median "
        f"{statistics.median(flushes):.3f} ms host; scatter_rows launches "
        f"{scatter}")
    log(f"phase 11 wall time {time.perf_counter() - t_phase:.1f} s")
    rows["edge_or"]["max_abs_err"] = max(rows["edge_or"]["max_abs_err"],
                                         churn_err)
    for name, r in rows.items():
        r["launches"] = launches[name]
    rows["scatter_rows"] = {"launches": scatter, "max_abs_err": s_err,
                            "ms": s_ms, "plain_ms": s_plain,
                            "bound_ms": s_bytes / peak * 1e3,
                            "bound_by": "bytes", "library_ms": s_lib}
    if timer.cuda:
        rows["scatter_rows"].update(split_times(
            lambda: [kernels.scatter_rows(*a) for a in s_work],
            lambda: [torch.index_put(t, (r.long(),), v)
                     for t, r, v in s_work]))
        _log_split("segment flush scatter_rows", rows["scatter_rows"])
    return rows, summary, seg


def _leo_pairs(w, rng, n: int, depth: int = 8) -> list:
    """(doc, user) check pairs for group-explosion, as the reference
    bench draws them: half with the doc's own chain-tail user (HAS until
    a churn moves the user), half with a random user."""
    n_users = len(w.subjects)
    doc_user = {}
    for r in w.relationships:
        if r.startswith("doc:"):
            d, head = r[len("doc:"):].split("#viewer@group:g")
            doc_user[d] = f"u{(int(head.split('#')[0]) // depth) % n_users}"
    docs = sorted(doc_user)
    out = []
    for _ in range(n):
        d = docs[int(rng.integers(len(docs)))]
        u = (doc_user[d] if rng.random() < 0.5
             else f"u{int(rng.integers(n_users))}")
        out.append((d, u))
    return out, doc_user


def leopard_path(timer, peak, smi_line, mt_statuses: dict,
                 device: str = "cuda", workload_kwargs: Optional[dict] = None,
                 n_rounds: int = LEO_ROUNDS) -> dict:
    """Phase 12: the Leopard index at group-explosion's full size, an
    indexed endpoint (A) against an index-free one (B) on one store.
    Returns {kernel name: measurements on the plane reads}."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    over = {k: v for k, v in mt_statuses.items()
            if v == "ineligible(over-budget)"}
    log(f"multitenant-1m Leopard statuses (phase 3): {mt_statuses}")
    if not over or any(v.startswith("indexed") for v in mt_statuses.values()):
        raise AssertionError("multitenant-1m should index nothing: every "
                             "eligible nested pair is over the budget")
    depth = 8
    t0 = time.perf_counter()
    w = workloads.group_explosion(**(workload_kwargs or {}))
    text = "\n".join(w.relationships)
    url = direct_url(device)
    a = create_endpoint(url, Bootstrap(w.schema_text, text))
    b = create_endpoint(url, Bootstrap(w.schema_text, ""), store=a.store,
                        leopard=False)
    t1 = time.perf_counter()
    a.graph()
    timer.sync()
    t2 = time.perf_counter()
    b.graph()
    timer.sync()
    t3 = time.perf_counter()
    lp = a._leopard
    statuses = lp.status_map()
    frag = lp.lookup_frag("doc", "view")
    if statuses.get("doc#view") != "indexed" or frag is None:
        raise AssertionError(f"doc#view is not indexed: {statuses}")
    plane = frag.plane[0]
    n_users = len(w.subjects)
    log(f"group-explosion: {len(w.relationships)} tuples, generated and "
        f"loaded in {t1 - t0:.3f} s; build A (index on) {t2 - t1:.3f} s, B "
        f"(index off) {t3 - t2:.3f} s; statuses {statuses}; doc#view plane "
        f"{list(plane.shape)} int32 = {plane.numel() * 4} bytes on "
        f"{plane.device}, host closure (state + seeds) {frag.nbytes_host} "
        f"bytes over {frag.n_rows} fragment rows x {frag.words} words; "
        f"{lp.uploads} upload(s) {lp.upload_s * 1e3:.3f} ms")

    rng = np.random.default_rng(SEED + 12)
    oracle = a._oracle
    batches = [[SubjectRef("user", w.subjects[i]) for i in
                rng.choice(n_users, LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pairs, doc_user = _leo_pairs(w, rng, N_CHECKS - 400)
    # HAS pairs from oracle lookups, so both answers occur
    t0 = time.perf_counter()
    for s in batches[0][:LEO_ORACLE_LOOKUPS]:
        got = oracle.lookup_resources("doc", "view", s)
        pairs += [(d, s.id) for d in got[:100]]
    t_oracle_lookups = time.perf_counter() - t0
    pairs += [(d, f"u{int(rng.integers(n_users))}")
              for d in rng.choice(sorted(doc_user), N_CHECKS - len(pairs))]
    reqs = [CheckRequest(ObjectRef("doc", d), "view", SubjectRef("user", u))
            for d, u in pairs]

    def reads(ep, label):
        out_l, out_c, e2e = [], [], {"lookup": [], "check": []}
        sweeps = []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            out_l.append(asyncio.run(ep.lookup_resources_batch(
                "doc", "view", batches[k])))
            timer.sync()
            e2e["lookup"].append(time.perf_counter() - t0)
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            out_c.append(asyncio.run(ep.check_bulk_permissions(reqs)))
            timer.sync()
            e2e["check"].append(time.perf_counter() - t0)
            tr = ep.graph().last_trace
            sweeps.append(int(tr[0]) if tr is not None else 0)
        log(f"{label}: lookup e2e cold {e2e['lookup'][0]:.4f} s, warm median "
            f"{statistics.median(e2e['lookup'][1:]):.6f} s; check e2e cold "
            f"{e2e['check'][0]:.4f} s, warm median "
            f"{statistics.median(e2e['check'][1:]):.6f} s; last sweeps "
            f"{sweeps}")
        return out_l, out_c, e2e, sweeps

    kernels.reset_launches()
    s0 = dict(a.stats)
    a_l, a_c, a_e2e, _ = reads(a, "A (index on)")
    a_launch = dict(kernels.LAUNCHES)
    served = {k: a.stats[k] - s0[k] for k in ("leopard_checks",
                                              "leopard_lookups",
                                              "kernel_calls")}
    log(f"A launches {a_launch}; served {served}")
    swept = [k for k in ("ell_gather_or", "perm_program", "sweep_delta",
                         "sweep_delta_checks", "seed_bitplanes", "edge_or",
                         "lookup_T")
             if a_launch[k]]
    if swept or served["kernel_calls"]:
        raise AssertionError(f"A's batches reached the sweep: {swept}")
    # one closure column per distinct query column of each lookup batch
    n_cols = sum(len(set(a._encode_subjects(a.graph(), bt)[1].values()))
                 for bt in batches)
    if (served["leopard_checks"] != (1 + N_WARM) * len(reqs)
            or served["leopard_lookups"] != n_cols
            or not (a_launch["check_gather"] and a_launch["word_cols_T"])):
        raise AssertionError(f"A's batches were not served from the plane: "
                             f"{served}")
    kernels.reset_launches()
    b_l, b_c, b_e2e, b_sweeps = reads(b, "B (index off)")
    if b.stats["leopard_checks"] or b.stats["leopard_lookups"]:
        raise AssertionError("B consulted an index")
    if min(b_sweeps) < 2:
        raise AssertionError(f"B did not sweep the chains: {b_sweeps}")
    for k in range(1 + N_WARM):
        if [sorted(x) for x in a_l[k]] != [sorted(x) for x in b_l[k]] or \
                [c.allowed for c in a_c[k]] != [c.allowed for c in b_c[k]]:
            raise AssertionError(f"A and B disagree on batch {k}")
    n_has = sum(c.allowed for c in a_c[0])
    if not 0 < n_has < len(reqs):
        raise AssertionError(f"the check batch is one-sided: {n_has}")
    log(f"A and B agree on {1 + N_WARM} lookup batches and {1 + N_WARM} "
        f"check batches ({n_has} HAS of {len(reqs)}, "
        f"{sum(len(x) for x in a_l[0])} allowed (user, doc) pairs); B's "
        f"trace {b.graph().last_trace[: 1 + b_sweeps[-1]].tolist()}")
    t0 = time.perf_counter()
    for i in rng.choice(len(reqs), LEO_ORACLE_CHECKS, replace=False):
        r = reqs[int(i)]
        if oracle.check(r.resource, r.permission, r.subject) != \
                a_c[0][int(i)].allowed:
            raise AssertionError(f"check {r} differs from the oracle")
    for i in range(2):
        s = batches[0][i]
        if sorted(oracle.lookup_resources("doc", "view", s)) != \
                sorted(a_l[0][i]):
            raise AssertionError(f"lookup for {s} differs from the oracle")
    log(f"oracle: {LEO_ORACLE_CHECKS} checks and 2 lookups equal A's "
        f"({time.perf_counter() - t0:.1f} s; the HAS-pair lookups took "
        f"{t_oracle_lookups:.1f} s)")

    # the plane kernels against their twins, on the full plane
    rows = {}
    if timer.cuda:
        rows.update(staged_b_vs_twins(b, batches))
    dev = plane.device
    prog = a.graph().prog
    off = prog.slot_offsets[("doc", "view")]
    q_arr, cols, _ = a._encode_subjects(a.graph(), [r.subject for r in reqs])
    pr = np.asarray([prog.state_index("doc", "view", r.resource.id) - off
                     for r in reqs], np.int32)
    pc = np.asarray([frag.col_of[int(q_arr[cols[r.subject]])]
                     for r in reqs], np.int32)
    pr_t, pc_t = torch.from_numpy(pr).to(dev), torch.from_numpy(pc).to(dev)
    cells = len(set(zip(pr.tolist(), (pc // 32).tolist())))
    _seg_rows(rows, "check_gather",
              _diff(kernels.check_gather(plane, pr_t, pc_t),
                    reference.check_gather(plane, pr_t, pc_t)),
              timer.ms(lambda: kernels.check_gather(plane, pr_t, pc_t)),
              timer.ms(lambda: reference.check_gather(plane, pr_t, pc_t)),
              len(pr) * 4 * 3 + cells * 4, 3 * len(pr), peak)
    rows_n = frag.plane_rows
    all_w = torch.arange(plane.shape[1], dtype=torch.int32, device=dev)
    batch_w = torch.tensor(sorted({int(frag.col_of[int(q_arr[c])]) // 32
                                   for c in set(cols.values())}),
                           dtype=torch.int32, device=dev)
    err = 0
    # 1 and 7 words take the column read, the batch's and all words the
    # tiled one; repeated words both
    word_sets = (all_w[:1], batch_w[:7], batch_w, all_w,
                 all_w.flip(0)[:7].repeat(2), batch_w.repeat(2))
    for words in word_sets:
        err = max(err, _diff(kernels.word_cols_T(plane, rows_n, words),
                             reference.word_cols_T(plane, rows_n, words)))
    w64 = batch_w.long()
    _seg_rows(rows, "word_cols_T", err,
              timer.ms(lambda: kernels.word_cols_T(plane, rows_n, batch_w)),
              timer.ms(lambda: reference.word_cols_T(plane, rows_n, batch_w)),
              2 * batch_w.numel() * rows_n * 4 + batch_w.numel() * 4, 0,
              peak, library_ms=timer.ms(
                  lambda: plane[:rows_n, w64].t().contiguous()))
    if any(r["max_abs_err"] for r in rows.values()):
        raise AssertionError(f"plane kernels disagree with their twins: "
                             f"{rows}")
    log(f"plane kernels vs twins on the full [{rows_n}, {plane.shape[1]}] "
        f"plane: check_gather over {len(pr)} (row, col) pairs and "
        f"word_cols_T over {[int(w_.numel()) for w_ in word_sets]} words "
        f"(1, 7, the batch's, all, repeated): bit-identical; check_gather "
        f"{rows['check_gather']['ms']:.6f} ms (bound "
        f"{rows['check_gather']['bound_ms']:.6f}), word_cols_T "
        f"{rows['word_cols_T']['ms']:.6f} ms for the batch's words (bound "
        f"{rows['word_cols_T']['bound_ms']:.6f}, library "
        f"{rows['word_cols_T']['library_ms']:.6f})")

    # churn: the reference bench's tail-user moves
    ops_of = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    # one user membership per chain, at its tail
    n_chains = sum(1 for r in w.relationships
                   if r.startswith("group:") and "@user:" in r)
    rebuilds0 = a.stats["rebuilds"]
    crng = np.random.default_rng(SEED + 13)
    q0, r0 = lp.quarantines, lp.recloses
    rounds = []
    for r in range(n_rounds):
        writes = []
        for _ in range(4):
            c = int(crng.integers(n_chains))
            tail = c * depth + depth - 1
            writes.append(("delete", f"group:g{tail}#member@user:u"
                                     f"{c % n_users}"))
            writes.append(("touch", f"group:g{tail}#member@user:u"
                                    f"{int(crng.integers(n_users))}"))
        a0, u0, us0 = (a.stats["delta_apply_s"], lp.uploads, lp.upload_s)
        a.store.write([RelationshipUpdate(ops_of[o], parse_relationship(x))
                       for o, x in writes])
        t0 = time.perf_counter()
        a.graph()                       # apply + Leopard maintenance
        t_apply = time.perf_counter() - t0
        subjects = [SubjectRef("user", x.split("@user:")[1])
                    for _, x in writes[1::2]]
        subjects += batches[r % len(batches)][: LOOKUP_LANES - len(subjects)]
        cpairs, _ = _leo_pairs(w, crng, 2_000)
        creqs = [CheckRequest(ObjectRef("doc", d), "view",
                              SubjectRef("user", u)) for d, u in cpairs]
        al = asyncio.run(a.lookup_resources_batch("doc", "view", subjects))
        ac = asyncio.run(a.check_bulk_permissions(creqs))
        bl = asyncio.run(b.lookup_resources_batch("doc", "view", subjects))
        bc = asyncio.run(b.check_bulk_permissions(creqs))
        if [sorted(x) for x in al] != [sorted(x) for x in bl] or \
                [c.allowed for c in ac] != [c.allowed for c in bc]:
            raise AssertionError(f"A and B disagree after round {r}")
        for i in crng.choice(len(creqs), 100, replace=False):
            q_ = creqs[int(i)]
            if oracle.check(q_.resource, q_.permission, q_.subject) != \
                    ac[int(i)].allowed:
                raise AssertionError(f"check {q_} differs from the oracle "
                                     f"after round {r}")
        moved = subjects[0]
        if sorted(oracle.lookup_resources("doc", "view", moved)) != \
                sorted(al[0]):
            raise AssertionError(f"lookup for {moved} differs from the "
                                 f"oracle after round {r}")
        rounds.append({"apply_ms": (a.stats["delta_apply_s"] - a0) * 1e3,
                       "call_ms": t_apply * 1e3,
                       "uploads": lp.uploads - u0,
                       "upload_ms": (lp.upload_s - us0) * 1e3})
        log(f"leopard churn round {r}: 4 deletes + 4 touches; host delta "
            f"application {rounds[-1]['apply_ms']:.3f} ms (Leopard "
            f"maintenance inside); plane uploads since the write, by "
            f"inserts and background re-closes: {rounds[-1]['uploads']} in "
            f"{rounds[-1]['upload_ms']:.3f} ms; status "
            f"{lp.status_map()['doc#view']}; quarantines "
            f"{lp.quarantines - q0}, re-closes kicked "
            f"{a.stats['leopard_recloses']}, installed {lp.recloses - r0}; "
            "A equals B and the oracle sample")
    t0 = time.perf_counter()
    if not a.wait_rebuilds(timeout=300):
        raise AssertionError("re-closes did not quiesce")
    t_wait = time.perf_counter() - t0
    if a.stats["rebuilds"] != rebuilds0 or a._leopard is not lp:
        raise AssertionError("A rebuilt under the churn")
    if lp.quarantines - q0 < 1 or lp.recloses - r0 < 1:
        raise AssertionError("the churn made no quarantine and re-close")
    frag = lp.lookup_frag("doc", "view")
    if (lp.status_map().get("doc#view") != "indexed" or frag is None
            or frag.quarantined or not frag.live):
        raise AssertionError(f"doc#view is not live again: "
                             f"{lp.status_map()}")
    # insert propagation on the live fragment: a round of touches only
    # (the bench's rounds delete first, which quarantines the fragment and
    # leaves the inserts to the re-close)
    touches = []
    for _ in range(4):
        c = int(crng.integers(n_chains))
        touches.append(f"group:g{c * depth + depth - 1}#member@user:u"
                       f"{int(crng.integers(n_users))}")
    a0, u0, us0 = a.stats["delta_apply_s"], lp.uploads, lp.upload_s
    a.store.write([RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(x))
                   for x in touches])
    a.graph()
    insert_ms = (a.stats["delta_apply_s"] - a0) * 1e3
    if lp.lookup_frag("doc", "view") is None:
        raise AssertionError("inserts quarantined the fragment")
    moved = [SubjectRef("user", x.split("@user:")[1]) for x in touches]
    al = asyncio.run(a.lookup_resources_batch("doc", "view", moved))
    bl = asyncio.run(b.lookup_resources_batch("doc", "view", moved))
    if [sorted(x) for x in al] != [sorted(x) for x in bl] or \
            sorted(oracle.lookup_resources("doc", "view", moved[0])) != \
            sorted(al[0]):
        raise AssertionError("A differs after the inserts")
    log(f"insert round (4 touches, fragment live): host delta application "
        f"{insert_ms:.3f} ms, {lp.uploads - u0} plane uploads "
        f"{(lp.upload_s - us0) * 1e3:.3f} ms; A equals B and the oracle")
    kernels.reset_launches()
    s0 = dict(a.stats)
    al = asyncio.run(a.lookup_resources_batch("doc", "view", batches[1]))
    ac = asyncio.run(a.check_bulk_permissions(reqs))
    bl = asyncio.run(b.lookup_resources_batch("doc", "view", batches[1]))
    bc = asyncio.run(b.check_bulk_permissions(reqs))
    if [sorted(x) for x in al] != [sorted(x) for x in bl] or \
            [c.allowed for c in ac] != [c.allowed for c in bc]:
        raise AssertionError("A and B disagree after the re-closes")
    if a.stats["leopard_checks"] - s0["leopard_checks"] != len(reqs) or \
            a.stats["kernel_calls"] != s0["kernel_calls"]:
        raise AssertionError("A does not serve from the plane again")
    med = lambda k: statistics.median(x[k] for x in rounds)
    log(f"after wait_rebuilds() ({t_wait:.3f} s): doc#view indexed, live; A "
        f"serves from the plane again and equals B. Leopard summary: "
        f"re-closes {lp.recloses - r0} installed in {lp.reclose_s:.3f} s "
        f"(host, background); plane uploads {lp.uploads} in total, "
        f"{lp.upload_s / max(1, lp.uploads) * 1e3:.3f} ms each; delta "
        f"application median {med('apply_ms'):.3f} ms a round; warm "
        f"medians A lookup {statistics.median(a_e2e['lookup'][1:]):.6f} s, "
        f"check {statistics.median(a_e2e['check'][1:]):.6f} s; B lookup "
        f"{statistics.median(b_e2e['lookup'][1:]):.6f} s, check "
        f"{statistics.median(b_e2e['check'][1:]):.6f} s, {b_sweeps[-1]} "
        f"sweeps")
    log(f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s")
    for name, r in rows.items():
        r["launches"] = a_launch[name]
    return rows, a, w


# -- phase 13, the mesh path --------------------------------------------------

def staged_b_vs_twins(b, batches) -> dict:
    """Phase 12 (B): the index-free endpoint's staged sweep over the
    5-deep userset chains, two sweeps step by step against the twins,
    then one batch replayed from its graphs against the same batch
    launched step by step (`graph_batch_checks`).  Returns the kernels'
    errors as rows."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    g = b.graph()
    kc, prog = g.kernel, g.prog
    tables = g.snapshot()
    q_arr, _, _ = b._encode_subjects(g, batches[0])
    q = torch.from_numpy(q_arr).to(g.dev_main.device)
    n_words = len(q_arr) // 32
    nt = prog.state_size + kc.n_aux_rows
    live = (torch.empty((kc._wc_ranges.shape[0], n_words), dtype=torch.int32,
                        device=q.device)
            if kc._wc_ranges is not None else None)
    x0 = kernels.seed_bitplanes(q, nt, n_words, prog.dead_index,
                                wc_ranges=kc._wc_ranges, live=live)
    err, steps, _ = _twin_sweeps(kc, tables, x0, live, n_words,
                                 "group-explosion B")
    modes = [s[5] for s in steps if s[0] == "ell_gather_or"]
    log(f"group-explosion B: {len(steps)} staged steps x 2 sweeps "
        f"bit-identical to the twins (gathers in place {modes.count('in_place')}"
        f", through scratch {modes.count('scratch')})")
    x_g, tr_g = kc.evaluate(q, n_words, tables[0], tables[1],
                            kc.take_arena(n_words), plan=tables.plan)
    graph_batch_checks(b, kc, q, n_words, tables, x_g, tr_g, steps,
                       batches[1], "doc", "group-explosion B")
    return {k: {"max_abs_err": e} for k, e in err.items()
            if k in ("ell_gather_or", "perm_program")}


def make_smoke_mesh(device: str):
    """The 2 x 4 mesh of phase 13 over the visible cards, cuda:0 repeated
    when fewer than eight are visible (every shard on the CPU for a CPU
    rehearsal)."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import make_mesh
    n = MESH_DATA * MESH_GRAPH
    if device == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        devices = visible[:n] + [torch.device("cuda", 0)] * (n - len(
            visible[:n]))
    else:
        devices = [torch.device(device)] * n
    mesh = make_mesh(devices, data=MESH_DATA, graph=MESH_GRAPH)
    log(f"mesh placement: {mesh}")
    return mesh


def _mesh_endpoint(store, schema_text: str, mesh, device: str, **kw):
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    url = direct_url(device)
    return create_endpoint(url, Bootstrap(schema_text, ""), store=store,
                           mesh=mesh, **kw)


def _mesh_tables_match(graph) -> None:
    """Every block of every data replica equals the host table, remapped
    into the padded row space."""
    import numpy as np
    import torch
    want = graph.kernel.pad_tables(graph.host_main, graph.host_aux,
                                   graph.host_cav)
    for blocks, host in zip(graph.snapshot(), want):
        for d, row in enumerate(blocks):
            got = torch.cat([b.cpu() for b in row]).numpy()
            if not np.array_equal(got, host):
                raise AssertionError(f"data replica {d}'s table blocks "
                                     "differ from the host table")


def _flat(bufs) -> list:
    return [t for row in bufs for t in row]


def _uniq(t) -> int:
    import torch
    return int(torch.unique(t).numel())


def mesh_kernel_bytes(kern, tables: tuple, n_words: int) -> dict:
    """Bytes each mesh kernel must move in one sweep at these tables and
    this bucket (each input read once, each output written once), summed
    over its launches: a table block once a device, the distinct source
    rows and seed rows once a data shard a device, every replica's output
    rows once.  {kernel: bytes}."""
    main, aux = tables[0], tables[1]
    word = 4 * kern.width(n_words)
    wl = n_words // kern.mesh.shape["data"]
    out = {"mesh_gather_or": 0, "mesh_perm_program": 0,
           "mesh_sweep_delta": 0}
    if kern.planes:
        out["mesh_cav_gather_or"] = 0
    for dev, per_d in kern._placement.items():
        seen: set = set()
        for d, gs in per_d.items():
            n_rep = len(gs)
            for g in gs:
                for blk, passes in ((aux[d][g], kern.aux_passes),
                                    (main[d][g], 1)):
                    if id(blk) not in seen:
                        out["mesh_gather_or"] += passes * blk.numel() * 4
                    out["mesh_gather_or"] += passes * (
                        _uniq(blk) + blk.shape[0] * n_rep) * word
                out["mesh_gather_or"] += main[d][g].shape[0] * word   # seed
                seen.update((id(aux[d][g]), id(main[d][g])))
                if kern.planes:
                    c = tables[2][d][g]
                    if id(c) not in seen:
                        out["mesh_cav_gather_or"] += c.numel() * 4
                        seen.add(id(c))
                    reached = int((c != kern.prog.dead_index).any(
                        dim=1).sum())
                    out["mesh_cav_gather_or"] += (
                        _uniq(c) + 2 * reached * n_rep) * 4 * wl
            for code, _, length, _ in kern._plans[dev][2]:
                n_read = int((code[0::2] == 0).sum())
                out["mesh_perm_program"] += (code.numel() * 4 + length * word
                                             * (n_read + 1 + n_rep))
            out["mesh_sweep_delta"] += 2 * kern.rows * word + 8
    return out


def mesh_bound_bytes(kern, tables: tuple, n_words: int) -> dict:
    """The least bytes of one sharded sweep: {"bytes": each distinct table
    block read once a device, each data shard's input rows and seed rows
    once a device, each replica's rows written once; "old_bytes": the
    first design's count (every shard's kernels on its own replica, the
    input copies and every block copy, read and written)}."""
    main, aux = tables[0], tables[1]
    word = 4 * kern.width(n_words)
    wl = n_words // kern.mesh.shape["data"]
    n_graph = kern.mesh.shape["graph"]
    least = 0
    for dev, per_d in kern._placement.items():
        blocks = {id(t): t for d, gs in per_d.items() for g in gs
                  for t in (main[d][g], aux[d][g])
                  + ((tables[2][d][g],) if kern.planes else ())}
        least += sum(t.numel() * 4 for t in blocks.values())
        for d, gs in per_d.items():
            least += (kern.rows + kern.n_pad + len(gs) * kern.rows) * word
    old = 0
    for dev, per_d in kern._placement.items():
        for d, g in ((d, g) for d, gs in per_d.items() for g in gs):
            blk = main[d][g]
            n, k = blk.shape
            old += n * k * 4 + _uniq(blk) * word + 2 * n * word
            na, ka = aux[d][g].shape
            old += kern.aux_passes * (na * ka * 4 + _uniq(aux[d][g]) * word
                                      + na * word)
            if kern.planes:
                c = tables[2][d][g]
                nc, kc_ = c.shape
                old += nc * kc_ * 4 + _uniq(c) * 4 * wl + 2 * nc * 4 * wl
            for code, _, length, _ in kern._plans[dev][2]:
                n_read = int((code[0::2] == 0).sum())
                old += code.numel() * 4 + length * word * (n_read + 2)
            old += 2 * kern.rows * word
    per_block = ((kern.aux_passes * kern.a_pad + kern.n_pad) * word
                 + (kern.rows * 4 * wl if kern.planes else 0))
    moved = len(main) * per_block * (n_graph - 1)
    old += 2 * moved
    return {"bytes": least, "old_bytes": old, "copy_bytes": moved}


def _poisoned(kern, fn):
    """`fn()` with every sweep's output buffers (`cur` and the aux
    buffers) filled with POISON before the sweep writes them: no row may
    rely on what they held."""
    step = kern.step

    def poisoned(cur, x, x0, live, aux, *args, **kw):
        for t in _flat(cur) + _flat(aux):
            t.fill_(POISON)
        step(cur, x, x0, live, aux, *args, **kw)
    kern.step = poisoned
    try:
        return fn()
    finally:
        del kern.step


def mesh_sweep(kern, q_arr, n_words: int, tables: tuple, timer, peak,
               label: str) -> dict:
    """A sharded batch's kernels against their twins on the card: the
    seed, two sweeps call by call (every mesh_* launch and collective of
    `sweep_calls` on the kernels and on the twins from equal buffers,
    every replica and aux buffer compared after each, the output buffers
    poisoned first), the deltas; then the whole batch again on both, its
    output buffers poisoned before every sweep (state of every replica,
    trace and words equal).  Then one sweep's time, each kernel's share
    apart, and its bounds.  Returns the sweep's numbers and the mesh
    kernels' rows."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel.collectives import (
        reduce_data_deltas)

    dead = kern.prog.dead_index
    n_data = kern.mesh.shape["data"]
    dev0 = kern.mesh.devices[0][0]
    ar_k = kern._alloc_arenas(n_words)
    ar_t = kern._alloc_arenas(n_words)
    x0, live = kern.seed(q_arr, n_words, ar_k)
    x0_t, live_t = kern.seed(q_arr, n_words, ar_t, reference)
    seed_err = max(_diff(a, b) for a, b in zip(_flat(x0), _flat(x0_t)))
    errs: dict = {}
    fresh = lambda bufs: [[torch.full_like(t, POISON) for t in row]
                          for row in bufs]
    zeros = lambda: {dev: torch.zeros((1, n_data, 2), dtype=torch.int32,
                                      device=dev)
                     for dev in kern._placement}
    x, x_t = x0, x0_t
    aux_bufs = [[a.aux for a in row] for row in ar_k]
    for sweep in range(2):
        cur, cur_t = fresh(x), fresh(x)
        aux_k, aux_t = fresh(aux_bufs), fresh(aux_bufs)
        calls = zip(kern.sweep_calls(cur, x, x0, live, aux_k, tables,
                                     n_words),
                    kern.sweep_calls(cur_t, x_t, x0_t, live_t, aux_t,
                                     tables, n_words))
        for (name, fk), (_, ft) in calls:
            fk(kernels)
            ft(reference)
            e = max(_diff(a, b) for a, b in zip(_flat(cur) + _flat(aux_k),
                                                _flat(cur_t) + _flat(aux_t)))
            errs[name] = max(errs.get(name, 0), e)
            if e:
                raise AssertionError(f"{label}: {name} differs from its twin "
                                     f"in sweep {sweep}")
        d_k, d_t = zeros(), zeros()
        kern.sweep_deltas(cur, x, {k: t[0] for k, t in d_k.items()})
        kern.sweep_deltas(cur_t, x_t, {k: t[0] for k, t in d_t.items()},
                          reference)
        e = max([_diff(a, b) for a, b in zip(_flat(cur), _flat(cur_t))]
                + [_diff(d_k[k], d_t[k]) for k in d_k])
        errs["mesh_sweep_delta"] = max(errs.get("mesh_sweep_delta", 0), e)
        if e:
            raise AssertionError(f"{label}: mesh_sweep_delta differs from "
                                 f"its twin in sweep {sweep}")
        x, x_t = cur, cur_t
    log(f"{label}: seed and 2 sweeps on {kern.mesh.size} shards call by "
        f"call, every replica against the twins': errors {errs}, seed "
        f"{seed_err}")
    # the whole batch, kernels and twins, on the card
    t0 = time.perf_counter()
    xs_k, tr_k = _poisoned(kern, lambda: kern.evaluate(q_arr, n_words,
                                                       tables, ar_k))
    xs_t, tr_t = _poisoned(kern, lambda: kern.evaluate(
        q_arr, n_words, tables, ar_t, reference))
    off_len = (0, min(kern.prog.state_size, 4096))
    w_k = kern.finish_lookup(xs_k, *off_len, n_words)
    w_t = kern.finish_lookup(xs_t, *off_len, n_words, reference)
    err = max([seed_err, _diff(w_k, w_t)]
              + [_diff(a, b) for a, b in zip(_flat(xs_k), _flat(xs_t))])
    if err or not np.array_equal(tr_k, tr_t):
        raise AssertionError(f"{label}: the sharded batch on the twins "
                             "differs from the kernels'")
    log(f"{label}: the whole batch on the kernels and on the twins, output "
        f"buffers poisoned before every sweep (state of every replica, "
        f"trace {tr_k[:1 + tr_k[0]].tolist()}, lookup words): "
        f"bit-identical ({time.perf_counter() - t0:.1f} s)")
    # one sweep's time on the state after two sweeps, split by kernel
    cur, aux_k = fresh(x), fresh(aux_bufs)
    d_k = zeros()
    slots_of = {k: t[0] for k, t in d_k.items()}
    calls = kern.sweep_calls(cur, x, x0, live, aux_k, tables, n_words)
    names = list(dict.fromkeys(n for n, _ in calls))
    by = {n: [f for m, f in calls if m == n] for n in names}
    slots = kern.sweep_deltas(cur, x, slots_of)

    def sweep():
        kern.step(cur, x, x0, live, aux_k, tables, n_words)
        reduce_data_deltas(d_k[dev0][0], kern.sweep_deltas(cur, x,
                                                           slots_of))
    t = {n: timer.ms(lambda fs=fs: [f(kernels) for f in fs])
         for n, fs in by.items()}
    plain = {n: timer.ms(lambda fs=fs: [f(reference) for f in fs], reps=2)
             for n, fs in by.items() if n != "all_gather_rows"}
    t["mesh_sweep_delta"] = timer.ms(lambda: kern.sweep_deltas(cur, x,
                                                               slots_of))
    plain["mesh_sweep_delta"] = timer.ms(lambda: kern.sweep_deltas(
        cur, x, slots_of, reference), reps=2)
    t["readback"] = timer.ms(lambda: reduce_data_deltas(d_k[dev0][0], slots))
    t_sweep = timer.ms(sweep)
    t_plain = timer.ms(lambda: kern.step(cur, x, x0, live, aux_k, tables,
                                         n_words, reference), reps=2)
    att = attribute(sweep, capturable=False) if timer.cuda else {}
    bound = mesh_bound_bytes(kern, tables, n_words)
    per_kernel = mesh_kernel_bytes(kern, tables, n_words)
    rows = {}
    for name, nbytes in per_kernel.items():
        b_ms = nbytes / peak * 1e3
        rows[name] = {"max_abs_err": errs.get(name, 0), "ms": t[name],
                      "plain_ms": plain[name], "bound_ms": b_ms,
                      "bound_by": "bytes", "library_ms": None}
    out = {"sweep_ms": t_sweep, "split_ms": t, "plain_step_ms": t_plain,
           "bound_ms": bound["bytes"] / peak * 1e3,
           "old_bound_ms": bound["old_bytes"] / peak * 1e3,
           "bytes": bound["bytes"], "old_bytes": bound["old_bytes"],
           "copy_bytes": bound["copy_bytes"],
           "trace": tr_k[:1 + tr_k[0]].tolist(), "max_abs_err": err,
           "attribution": {k: v for k, v in att.items()
                           if k != "device_names"},
           "device_names": att.get("device_names", []), "rows": rows}
    log(f"{label}: one sweep on {kern.mesh.size} shards: "
        + ", ".join(f"{n} {v:.6f} ms" for n, v in t.items())
        + f"; whole sweep {t_sweep:.6f} ms (event-timed); device-only "
        f"{att.get('device_ms', float('nan')):.6f} ms "
        f"({att.get('device_by')}, {att.get('launches')} activities), cold "
        f"{att.get('cold_ms', float('nan')):.6f} ms, host "
        f"{att.get('host_us', float('nan')):.2f} us; device activities "
        f"{out['device_names']}; bound {out['bound_ms']:.6f} ms over "
        f"{bound['bytes']} bytes (the first design's count "
        f"{out['old_bound_ms']:.6f} ms over {bound['old_bytes']}); the "
        f"step on the twins {t_plain:.6f} ms")
    for name, r in rows.items():
        log(f"{label}: {name} {r['ms']:.6f} ms a sweep, twins "
            f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms over "
            f"{per_kernel[name]} bytes")
    return out


def _sweep_copies(kern, fn) -> tuple:
    """(fn(), the copies between two tensors on one device made through
    `Tensor.copy_` — the only way the mesh path copies state — while it
    runs, the seed's excepted: on the CPU its twin copies into the
    arena)."""
    import torch
    real, seed = torch.Tensor.copy_, kern.seed
    n, paused = [0], [False]

    def copy_(self, src, *args, **kw):
        if isinstance(src, torch.Tensor) and src.device == self.device \
                and not paused[0]:
            n[0] += 1
        return real(self, src, *args, **kw)

    def seed_(*args, **kw):
        paused[0] = True
        try:
            return seed(*args, **kw)
        finally:
            paused[0] = False
    torch.Tensor.copy_ = copy_
    kern.seed = seed_
    try:
        return fn(), n[0]
    finally:
        torch.Tensor.copy_ = real
        del kern.seed


def mesh_multitenant(ep, w, mesh, timer, peak, smi_line, device: str = "cuda",
                     n_rounds: int = MESH_ROUNDS) -> tuple:
    """Phase 13a: a 2 x 4 mesh endpoint on the phase-3 store at
    multitenant-1m.  Returns (mesh endpoint, numbers)."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _ShardedEllGraph)
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import comm_model
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)

    t_phase = time.perf_counter()
    m = _mesh_endpoint(ep.store, w.schema_text, mesh, device)
    t0 = time.perf_counter()
    g = m.graph()
    timer.sync()
    t_build = time.perf_counter() - t0
    if not isinstance(g, _ShardedEllGraph):
        raise AssertionError("the mesh endpoint built no sharded graph")
    kern, prog = g.kernel, g.prog
    log(f"mesh multitenant-1m: build {t_build:.3f} s; {prog.state_size} state "
        f"rows padded to {kern.n_pad} + {kern.a_pad} aux rows; blocks main "
        f"{kern.block_main}, aux {kern.block_aux}, caveat {kern.block_cav} "
        f"rows a shard; aux passes {kern.aux_passes}, iteration cap "
        f"{kern.num_iters}; Leopard statuses {m._leopard.status_map()}")

    rng = np.random.default_rng(SEED + 13)
    users = w.subjects
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(1 + N_WARM)]
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    subj = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", batches[0][s])
            for i, s in zip(pick, subj)]
    rebuilds0 = (m.stats["rebuilds"], ep.stats["rebuilds"])

    # the mesh path's read batches, launches and copies counted from zero
    kernels.reset_launches()
    collectives.reset_collectives()
    summary, lookups, checks = {}, [], []
    sweeps_all = 0
    for verb in ("lookup", "check"):
        e2e, sweeps = [], []
        for k in range(1 + N_WARM):
            t0 = time.perf_counter()
            if verb == "lookup":
                lookups.append(asyncio.run(m.lookup_resources_batch(
                    "pod", "view", batches[k])))
            else:
                checks.append(asyncio.run(m.check_bulk_permissions(reqs)))
            timer.sync()
            e2e.append(time.perf_counter() - t0)
            sweeps.append(int(g.last_trace[0]))
        sweeps_all += sum(sweeps)
        summary[verb] = {"e2e_s": e2e, "sweeps": sweeps}
        log(f"mesh {verb}: sweeps per batch {sweeps}; trace "
            f"{g.last_trace[: 1 + sweeps[-1]].tolist()}; e2e per batch cold "
            f"{e2e[0]:.4f} s, warm median {statistics.median(e2e[1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    coll = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
    log(f"launches on the mesh path: {launches}")
    idle = [k for k in MESH_KERNELS if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched on the mesh path: "
                             f"{idle}")
    # what a sweep costs in launches, copies and readbacks
    per_sweep = sum(launches[k] for k in MESH_SWEEP_KERNELS) / sweeps_all
    limit = MESH_DATA * (kern.aux_passes + 3 + len(prog.perm_ops))
    one_card = len({dev for row in mesh.devices for dev in row}) == 1
    q_arr, _, _ = m._encode_subjects(g, batches[0])
    ar = kern._alloc_arenas(len(q_arr) // 32)
    (_, tr), n_copies = _sweep_copies(kern, lambda: kern.evaluate(
        q_arr, len(q_arr) // 32, g.snapshot(), ar))
    log(f"mesh sweep: {per_sweep:g} launches a sweep (limit {limit}: "
        f"{MESH_DATA} x (aux passes {kern.aux_passes} + 3 + "
        f"{len(prog.perm_ops)} permission ops)); block copies "
        f"{coll['all_gather_rows']['copies']} over {sweeps_all} sweeps "
        f"({'every shard on one device' if one_card else 'several devices'}"
        f"); readbacks {coll['reduce_sweep_deltas']['calls']}; device "
        f"copies in one batch of {int(tr[0])} sweeps (input copies "
        f"included) {n_copies}")
    if per_sweep > limit:
        raise AssertionError(f"{per_sweep:g} launches a sweep > {limit}")
    if coll["reduce_sweep_deltas"]["calls"] != sweeps_all:
        raise AssertionError("not one readback a sweep")
    if one_card and (coll["all_gather_rows"]["copies"] or n_copies):
        raise AssertionError("a sweep copied between replicas on one card")
    cm = comm_model(prog.state_size, kern.a_pad, MESH_DATA, MESH_GRAPH,
                    LOOKUP_LANES, aux_passes=kern.aux_passes)
    per_sweep = coll["all_gather_rows"]["bytes"] / sweeps_all
    per_dev = per_sweep / mesh.size
    log(f"collectives over the mesh batches ({sweeps_all} sweeps): {coll}; "
        f"all_gather bytes per sweep {per_sweep:.0f}, per device "
        f"{per_dev:.0f}; comm_model "
        f"all_gather_recv_bytes_per_device_per_iter "
        f"{cm['all_gather_recv_bytes_per_device_per_iter']}")
    if per_dev != cm["all_gather_recv_bytes_per_device_per_iter"]:
        raise AssertionError("the all_gathers moved other bytes than "
                             "comm_model's")

    # the single-device ELL endpoint on the same batches, timed as the
    # mesh's were
    t0 = time.perf_counter()
    single = {"lookup": [], "check": []}
    for k in range(1 + N_WARM):
        t1 = time.perf_counter()
        one = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                    batches[k]))
        timer.sync()
        single["lookup"].append(time.perf_counter() - t1)
        if [sorted(x) for x in one] != [sorted(x) for x in lookups[k]]:
            raise AssertionError(f"mesh lookup batch {k} differs from the "
                                 "single-device endpoint's")
    for k in range(1 + N_WARM):
        t1 = time.perf_counter()
        one_c = asyncio.run(ep.check_bulk_permissions(reqs))
        timer.sync()
        single["check"].append(time.perf_counter() - t1)
        if [c.allowed for c in one_c] != [c.allowed for c in checks[k]]:
            raise AssertionError("mesh checks differ from the single-device "
                                 "endpoint's")
    for verb, e2e in single.items():
        summary[verb]["single_e2e_s"] = e2e
        log(f"single-device {verb} on the same batches: warm median "
            f"{statistics.median(e2e[1:]):.4f} s vs mesh "
            f"{statistics.median(summary[verb]['e2e_s'][1:]):.4f} s "
            f"(all: {', '.join(f'{t:.4f}' for t in e2e)})")
    log(f"mesh vs single device: {1 + N_WARM} lookup batches x "
        f"{LOOKUP_LANES} lanes and {1 + N_WARM} check batches x {len(reqs)} "
        f"pairs equal ({sum(len(x) for x in lookups[0])} allowed (subject, "
        f"pod) pairs, {sum(c.allowed for c in checks[0])} allowed checks; "
        f"{time.perf_counter() - t0:.1f} s)")

    sweep = mesh_sweep(kern, q_arr, len(q_arr) // 32, g.snapshot(), timer,
                       peak, "mesh multitenant-1m")
    sweep.update(launches_per_sweep=per_sweep, launch_limit=limit,
                 block_copies=coll["all_gather_rows"]["copies"],
                 batch_device_copies=n_copies)

    # churn through the shared store: both endpoints absorb it
    plan = _churn_plan(w, n_rounds, SEED + 13, tag="m")
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    scatter = 0
    for r, rnd in enumerate(plan):
        f0, a0 = m.stats["flush_s"], m.stats["delta_apply_s"]
        if r == n_rounds - 1:
            prev = (g.snapshot(), g.host_main.copy(), g.host_aux.copy())

        async def commit():
            for wr in rnd["writes"]:
                await m.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))
                     for o, rel in wr])
        asyncio.run(commit())
        creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
        extra = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                              replace=False)]
        names = list(dict.fromkeys(creators + extra))[:LOOKUP_LANES]
        subjects = [SubjectRef("user", u) for u in names]
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = asyncio.run(m.lookup_resources_batch("pod", "view", subjects))
        timer.sync()
        t_lookup = time.perf_counter() - t0
        n_scatter = kernels.LAUNCHES["scatter_rows"]
        scatter += n_scatter
        if not n_scatter:
            raise AssertionError("the sharded flush launched no scatter_rows")
        if m.graph() is not g:
            raise AssertionError("the mesh endpoint rebuilt under churn")
        _mesh_tables_match(g)
        new = [(pod, u) for pod, _, u in rnd["created"]]
        pk = rng.choice(len(pods), N_CHECKS - len(new), replace=False)
        pairs = new + [(pods[i], names[j]) for i, j in
                       zip(pk, rng.integers(0, len(names), len(pk)))]
        creqs = [CheckRequest(ObjectRef("pod", p_), "view",
                              SubjectRef("user", u)) for p_, u in pairs]
        t0 = time.perf_counter()
        cres = asyncio.run(m.check_bulk_permissions(creqs))
        timer.sync()
        t_check = time.perf_counter() - t0
        one = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
        one_c = asyncio.run(ep.check_bulk_permissions(creqs))
        if [sorted(a) for a in res] != [sorted(b) for b in one] or \
                [c.allowed for c in cres] != [c.allowed for c in one_c]:
            raise AssertionError(f"mesh and single-device answers differ "
                                 f"after churn round {r}")
        if not all(c.allowed for c in cres[: len(new)]):
            raise AssertionError("a creator cannot view the pod just created")
        log(f"mesh churn round {r}: {sum(len(x) for x in rnd['writes'])} "
            f"updates; delta application "
            f"{(m.stats['delta_apply_s'] - a0) * 1e3:.3f} ms, flush "
            f"{(m.stats['flush_s'] - f0) * 1e3:.3f} ms (host, {n_scatter} "
            f"scatter_rows launches); read-after-write lookup "
            f"{t_lookup:.4f} s, check {t_check:.4f} s (sweeps "
            f"{int(g.last_trace[0])}); every shard block equals the host "
            "table; answers equal the single-device endpoint's")
    if (m.stats["rebuilds"], ep.stats["rebuilds"]) != rebuilds0:
        raise AssertionError("a rebuild happened during the mesh churn")
    # the sharded flush's scatters at the last round's shapes: each
    # touched block of the main and aux tables, kernel against twin
    blocks_prev, main_prev, aux_prev = prev
    work = []
    for i, (host, old_host, b) in enumerate(
            ((g.host_main, main_prev, kern.block_main),
             (g.host_aux, aux_prev, kern.block_aux))):
        rows_c = np.nonzero((host != old_host).any(axis=1))[0]
        vals = kern.remap_values(host[rows_c])
        seen = set()
        for gg in np.unique(rows_c // b).tolist():
            sel = rows_c // b == gg
            for d in range(MESH_DATA):
                blk = blocks_prev[i][d][gg]
                if id(blk) in seen:
                    continue
                seen.add(id(blk))
                work.append((blk, torch.from_numpy(
                    (rows_c[sel] - gg * b).astype(np.int32)).to(blk.device),
                    torch.from_numpy(np.ascontiguousarray(vals[sel])).to(
                        blk.device)))
    s_err = max(_diff(kernels.scatter_rows(*a), reference.scatter_rows(*a))
                for a in work)
    s_ms = timer.ms(lambda: [kernels.scatter_rows(*a) for a in work])
    s_plain = timer.ms(lambda: [reference.scatter_rows(*a) for a in work])
    s_lib = timer.ms(lambda: [torch.index_put(b_, (r_.long(),), v_)
                              for b_, r_, v_ in work])
    s_bytes = sum(2 * b_.numel() * 4 + r_.numel() * 4 + v_.numel() * 4
                  for b_, r_, v_ in work)
    s_split = split_times(
        lambda: [kernels.scatter_rows(*a) for a in work],
        lambda: [torch.index_put(b_, (r_.long(),), v_)
                 for b_, r_, v_ in work]) if timer.cuda else {}
    if s_err:
        raise AssertionError(f"scatter_rows differs on the table blocks: "
                             f"{s_err}")
    log(f"sharded flush: the last round's {len(work)} touched (block, data "
        f"replica) scatters of the main and aux tables: bit-identical to "
        f"the twins; {s_ms:.6f} ms, twins {s_plain:.6f} ms, torch.index_put "
        f"{s_lib:.6f} ms, bound {s_bytes / peak * 1e3:.6f} ms over {s_bytes}"
        f" bytes")
    if s_split:
        _log_split("sharded flush scatter_rows", s_split)
    med = lambda v: statistics.median(v[1:])
    log(f"mesh summary: warm median lookup "
        f"{med(summary['lookup']['e2e_s']):.6f} s (single device on the "
        f"same batches {med(summary['lookup']['single_e2e_s']):.6f} s), "
        f"check {med(summary['check']['e2e_s']):.6f} s (single device "
        f"{med(summary['check']['single_e2e_s']):.6f} s); sweeps "
        f"{summary['lookup']['sweeps'][-1]} (lookup), "
        f"{summary['check']['sweeps'][-1]} (check); whole sweep "
        f"{sweep['sweep_ms']:.6f} ms (device-only "
        f"{sweep['attribution'].get('device_ms', float('nan')):.6f} ms) vs "
        f"bound {sweep['bound_ms']:.6f} ms (the first design's count "
        f"{sweep['old_bound_ms']:.6f} ms); scatter_rows launches {scatter} "
        f"({smi_line})")
    log(f"phase 13a wall time {time.perf_counter() - t_phase:.1f} s")
    out = {"launches": launches, "sweep": sweep, "summary": summary,
           "scatter": {"launches": scatter, "max_abs_err": s_err,
                       "ms": s_ms, "plain_ms": s_plain,
                       "bound_ms": s_bytes / peak * 1e3,
                       "library_ms": s_lib, **s_split}}
    return m, out


def or_chain(parts: list) -> None:
    """The all-reduce's library yardstick: the pairwise form in PyTorch
    calls, G - 1 `bitwise_or_` into parts[0], then G - 1 `copy_` back."""
    for t in parts[1:]:
        parts[0].bitwise_or_(t)
    for t in parts[1:]:
        t.copy_(parts[0])


def mesh_segment(seg, mesh, timer, peak, device: str = "cuda") -> dict:
    """Phase 13b: ShardedKernel (the edge-sharded segment sweep) at 2 x 4
    on the segment endpoint's program and current edge arrays; answers
    equal the segment endpoint's, the G-way `or_combine` against its twin
    on a real sweep's partials and timed beside the library chain.
    Returns the or_combine row and the sweep's numbers."""
    import dataclasses

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        ShardedKernel)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    t_phase = time.perf_counter()
    g = seg.graph()                 # applies the deltas of phase 13a
    # the current edges, padding included, as the program's edge list
    prog = dataclasses.replace(g.prog, edge_src=g.host_src.copy(),
                               edge_dst=g.host_dst.copy())
    cap = len(g.host_src)
    sk = ShardedKernel(prog, mesh)
    src, dst = sk.device_edges(cap)
    users = [u for u in prog.object_ids["user"] if "\x00" not in u]
    rng = np.random.default_rng(SEED + 14)
    names = [users[i] for i in rng.choice(len(users), LOOKUP_LANES,
                                          replace=False)]
    q = np.asarray([prog.subject_index("user", u) for u in names], np.int32)
    subjects = [SubjectRef("user", u) for u in names]
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    pick = rng.choice(len(pods), N_CHECKS, replace=False)
    cols = rng.integers(0, LOOKUP_LANES, N_CHECKS)
    gi = np.asarray([prog.state_index("pod", "view", pods[i]) for i in pick],
                    np.int32)
    off, length = prog.slot_range("pod", "view")
    kernels.reset_launches()
    collectives.reset_collectives()
    t0 = time.perf_counter()
    bitmap = sk.lookup(off, length, q, src, dst)
    timer.sync()
    t_lookup = time.perf_counter() - t0
    lk_sweeps = int(sk.last_trace[0])
    t0 = time.perf_counter()
    allowed = sk.checks(q, gi, cols, src, dst)
    t_check = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    coll = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
    log(f"ShardedKernel 2x4 on the segment program ({cap} edges, "
        f"{cap // MESH_GRAPH} a graph shard): lookup {t_lookup:.4f} s "
        f"({lk_sweeps} sweeps, trace "
        f"{sk.last_trace[:1 + lk_sweeps].tolist()}), check {t_check:.4f} s; "
        f"launches {launches}; collectives {coll}")
    idle = [k for k in ("seed_bitplanes", "edge_or", "or_combine",
                        "perm_program", "sweep_delta", "check_gather",
                        "lookup_T") if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched by ShardedKernel: "
                             f"{idle}")
    ids = prog.object_ids["pod"]
    look = asyncio.run(seg.lookup_resources_batch("pod", "view", subjects))
    for j, got in enumerate(look):
        mine = sorted(ids[i] for i in np.nonzero(bitmap[:, j])[0]
                      if "\x00" not in ids[i])
        if mine != sorted(got):
            raise AssertionError(f"ShardedKernel lookup for {names[j]} "
                                 "differs from the segment endpoint's")
    creqs = [CheckRequest(ObjectRef("pod", pods[i]), "view", subjects[c])
             for i, c in zip(pick, cols)]
    seg_c = asyncio.run(seg.check_bulk_permissions(creqs))
    if [c.allowed for c in seg_c] != [bool(x) for x in allowed]:
        raise AssertionError("ShardedKernel checks differ from the segment "
                             "endpoint's")
    log(f"ShardedKernel answers equal the segment endpoint's: "
        f"{LOOKUP_LANES} lookups ({int(bitmap.sum())} allowed) and "
        f"{N_CHECKS} checks ({int(allowed.sum())} allowed)")

    # or_combine on a real sweep's partials, and one sweep's time
    n_words = MESH_DATA * max(1, LOOKUP_LANES // 32 // MESH_DATA)
    qp = np.full(32 * n_words, prog.dead_index, np.int32)
    qp[:LOOKUP_LANES] = q
    x0, live = sk.seed(qp, n_words)
    x = [[t.clone() for t in row] for row in x0]
    y = [[torch.empty_like(t) for t in row] for row in x0]
    for _ in range(2):
        sk.partials(y, x, x0, live, src, dst)
        for reps in y:
            collectives.or_allreduce(reps)
        sk.finish_step(y, x, x0, live)
        x, y = y, x
    sk.partials(y, x, x0, live, src, dst)
    # edge_or on every shard's own edges (W = n_words / D), against the
    # twin, from the shard's init step as the sweep runs it
    dead = prog.dead_index
    e_err = 0
    for d in range(MESH_DATA):
        for gg in range(MESH_GRAPH):
            init = torch.empty_like(x[d][gg])
            sk._caches[x[d][gg].device].run_step(
                ("init", sk._caches[x[d][gg].device]._wc_bits), init,
                x[d][gg], x0[d][gg], live[d][gg])
            a, b = init.clone(), init.clone()
            kernels.edge_or(a, x[d][gg], src[d][gg], dst[d][gg], dead=dead)
            reference.edge_or(b, x[d][gg], src[d][gg], dst[d][gg])
            e_err = max(e_err, _diff(a, b))
    if e_err:
        raise AssertionError(f"edge_or differs from its twin on a shard: "
                             f"{e_err}")
    log(f"edge_or vs twin on all {MESH_DATA * MESH_GRAPH} shards' edges "
        f"([{x[0][0].shape[0]}, {x[0][0].shape[1]}] states, "
        f"{src[0][0].numel()} edges a shard): bit-identical")
    # the all-reduce on a real sweep's partials: each data shard's G
    # replicas in one launch, against the twin
    err = 0
    for reps in y:
        a = [t.clone() for t in reps]
        b = [t.clone() for t in reps]
        kernels.or_combine(a)
        reference.or_combine(b)
        err = max(err, max(_diff(u, v) for u, v in zip(a, b)))
    if err:
        raise AssertionError("or_combine differs from its twin")

    # timed over every data shard's replicas (8 buffers, more than the
    # 50 MB L2 holds), per all-reduce of one data shard
    sets = [[t.clone() for t in reps] for reps in y]
    numel = sets[0][0].numel()
    per = len(sets)
    rows = {}
    _seg_rows(rows, "or_combine", err,
              timer.ms(lambda: [kernels.or_combine(s_) for s_ in sets]) / per,
              timer.ms(lambda: [reference.or_combine(s_)
                                for s_ in sets]) / per,
              2 * MESH_GRAPH * numel * 4, (MESH_GRAPH - 1) * numel, peak,
              library_ms=timer.ms(lambda: [or_chain(s_)
                                           for s_ in sets]) / per)
    del sets
    rows["or_combine"]["launches"] = launches["or_combine"]
    t_part = timer.ms(lambda: sk.partials(y, x, x0, live, src, dst))
    t_red = timer.ms(lambda: [collectives.or_allreduce(reps) for reps in y])
    t_fin = timer.ms(lambda: sk.finish_step(y, x, x0, live))
    t_delta = timer.ms(lambda: [kernels.sweep_delta(a_, b_, dead)
                                for ra, rb in zip(y, x)
                                for a_, b_ in zip(ra, rb)])
    t_plain = (timer.ms(lambda: sk.partials(y, x, x0, live, src, dst,
                                            reference), reps=2)
               + timer.ms(lambda: [collectives.or_allreduce(reps, reference)
                                   for reps in y], reps=2)
               + timer.ms(lambda: sk.finish_step(y, x, x0, live, reference),
                          reps=2))
    word = 4 * (n_words // MESH_DATA)
    n = prog.state_size
    nbytes = 0
    for d in range(MESH_DATA):
        for gg in range(MESH_GRAPH):
            s_, d_ = src[d][gg], dst[d][gg]
            nbytes += (s_.numel() * 8 + int(torch.unique(s_).numel()) * word
                       + 2 * int(torch.unique(d_).numel()) * word
                       + 2 * n * word          # init: seed in, partial out
                       + 2 * n * word)         # delta
            for code, _, length, *_ in sk._caches[s_.device]._ops:
                n_read = int((code[0::2] == 0).sum())
                nbytes += code.numel() * 4 + length * word * (n_read + 2)
    # the all-reduce: each of the G partials read once and each of the G
    # replicas written once
    nbytes += MESH_DATA * MESH_GRAPH * 2 * n * word
    sweep = {"partials_ms": t_part, "allreduce_ms": t_red,
             "finish_ms": t_fin, "delta_ms": t_delta,
             "sweep_ms": t_part + t_red + t_fin + t_delta,
             "plain_ms": t_plain, "bound_ms": nbytes / peak * 1e3,
             "bytes": nbytes, "sweeps": lk_sweeps}
    log(f"ShardedKernel sweep at {LOOKUP_LANES} lanes on 8 shards: "
        f"partials (init + edge_or) {t_part:.6f} ms, or_allreduce (one "
        f"or_combine a data shard) {t_red:.6f} ms, permission ops "
        f"{t_fin:.6f} ms, deltas "
        f"{t_delta:.6f} ms; whole sweep {sweep['sweep_ms']:.6f} ms, bound "
        f"{sweep['bound_ms']:.6f} ms over {nbytes} bytes; twins "
        f"{t_plain:.6f} ms. or_combine of {MESH_GRAPH} real partials [{n}, "
        f"{n_words // MESH_DATA}]: bit-identical, "
        f"{rows['or_combine']['ms']:.6f} ms a data shard (bound "
        f"{rows['or_combine']['bound_ms']:.6f}, twin "
        f"{rows['or_combine']['plain_ms']:.6f}, library chain of "
        f"{MESH_GRAPH - 1} bitwise_or_ + {MESH_GRAPH - 1} copy_ "
        f"{rows['or_combine']['library_ms']:.6f})")
    log(f"phase 13b wall time {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "sweep": sweep, "launches": launches}


def mesh_caveats(ep, w, mesh, timer, peak, device: str = "cuda") -> dict:
    """Phase 13c: the caveated deployment of phase 10 on a 2 x 4 mesh
    endpoint over its store: tri-state answers equal the single-device
    endpoint's, CONDITIONAL included, nothing routed to the oracle, the
    block-form `cav_gather_or` launched and equal to its twin."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    t_phase = time.perf_counter()
    m = _mesh_endpoint(ep.store, w.schema_text, mesh, device)
    t0 = time.perf_counter()
    g = m.graph()
    timer.sync()
    kern = g.kernel
    if not (g.has_cav and kern.planes):
        raise AssertionError("the caveated mesh graph compiled no planes")
    log(f"mesh caveats: build {time.perf_counter() - t0:.3f} s; caveat "
        f"table sharded {kern.block_cav} rows a shard over {kern.rows} "
        f"rows; aux passes {kern.aux_passes}, cap {kern.num_iters}")
    member_of, assigned, _ = _cav_index(w)
    prog = g.prog
    users = w.subjects
    pods = [p for p in prog.object_ids["pod"] if "\x00" not in p]
    rng = np.random.default_rng(SEED + 15)
    batches = [[SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
               for _ in range(2)]
    pairs = _cav_pairs(rng, [s.id for s in batches[0]], pods, member_of,
                       assigned, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
            for p, u in pairs]
    res0 = m.stats["oracle_residual_checks"]
    kernels.reset_launches()
    e2e = {"lookup": [], "check": []}
    looks, chks = [], []
    for bt in batches:
        t0 = time.perf_counter()
        looks.append(asyncio.run(m.lookup_resources_batch("pod", "view",
                                                          bt)))
        timer.sync()
        e2e["lookup"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        chks.append(asyncio.run(m.check_bulk_permissions(reqs)))
        timer.sync()
        e2e["check"].append(time.perf_counter() - t0)
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    log(f"mesh caveats: lookup e2e {e2e['lookup']}, check e2e "
        f"{e2e['check']} s; sweeps {int(g.last_trace[0])}, trace "
        f"{g.last_trace[:1 + int(g.last_trace[0])].tolist()}; launches "
        f"{launches}")
    idle = [k for k in MESH_SWEEP_KERNELS + (
        "mesh_cav_gather_or", "seed_bitplanes", "check_gather3",
        "lookup_T") if not launches[k]]
    if idle:
        raise AssertionError(f"kernels never launched on the caveated mesh "
                             f"path: {idle}")
    for bt, lk in zip(batches, looks):
        one = asyncio.run(ep.lookup_resources_batch("pod", "view", bt))
        if [sorted(x) for x in one] != [sorted(x) for x in lk]:
            raise AssertionError("caveated mesh lookups differ from the "
                                 "single-device endpoint's")
    one_c = _tri(asyncio.run(ep.check_bulk_permissions(reqs)))
    tri = _tri(chks[0])
    if tri != one_c or _tri(chks[1]) != tri:
        raise AssertionError("caveated mesh checks differ from the "
                             "single-device endpoint's")
    counts = {v: tri.count(v) for v in (2, 1, 0)}
    if not counts[1]:
        raise AssertionError("no CONDITIONAL answer on the mesh")
    if m.stats["oracle_residual_checks"] != res0 or any(
            r.source != "kernel" for c in chks for r in c):
        raise AssertionError("caveat rows were routed to the oracle")
    log(f"mesh caveats equal the single-device endpoint: HAS {counts[2]}, "
        f"CONDITIONAL {counts[1]}, NO {counts[0]} of {len(reqs)}; nothing "
        "routed to the oracle")
    # the plane path is the Jacobi step on both: one batch, one trace
    asyncio.run(m.lookup_resources_batch("pod", "view", batches[0]))
    asyncio.run(ep.lookup_resources_batch("pod", "view", batches[0]))
    tr_m, tr_1 = g.last_trace, ep.graph().last_trace
    if not np.array_equal(tr_m[:1 + tr_m[0]], tr_1[:1 + tr_1[0]]):
        raise AssertionError(f"the mesh's Jacobi trace "
                             f"{tr_m[:1 + tr_m[0]].tolist()} differs from "
                             f"the single-device one's "
                             f"{tr_1[:1 + tr_1[0]].tolist()}")
    log(f"mesh caveats: one lookup batch sweeps as on a single device: "
        f"trace {tr_m[:1 + tr_m[0]].tolist()} on both")
    q_arr, _, _ = m._encode_subjects(g, batches[0])
    sweep = mesh_sweep(kern, q_arr, len(q_arr) // 32, g.snapshot(), timer,
                       peak, "mesh caveats")
    log(f"phase 13c wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "sweep": sweep, "e2e": e2e}


def mesh_leopard(a, w, mesh, timer, device: str = "cuda") -> dict:
    """Phase 13d: group-explosion (phase 12's store) on a 2 x 4 mesh
    endpoint with the index on: `doc#view` indexed with its plane in one
    block per graph shard, reads served from the sharded plane with no
    sweep kernel, answers equal endpoint A's."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    t_phase = time.perf_counter()
    m = _mesh_endpoint(a.store, w.schema_text, mesh, device)
    t0 = time.perf_counter()
    m.graph()
    timer.sync()
    lp = m._leopard
    frag = lp.lookup_frag("doc", "view")
    if lp.status_map().get("doc#view") != "indexed" or frag is None:
        raise AssertionError(f"doc#view is not indexed on the mesh: "
                             f"{lp.status_map()}")
    if not isinstance(frag.plane, tuple) or len(frag.plane) != MESH_GRAPH:
        raise AssertionError("the plane is not sharded over the graph axis")
    log(f"mesh group-explosion: build {time.perf_counter() - t0:.3f} s; "
        f"doc#view plane in {len(frag.plane)} blocks of "
        f"{list(frag.plane[0].shape)} on "
        f"{[str(b.device) for b in frag.plane]} for {frag.plane_rows} rows")
    rng = np.random.default_rng(SEED + 16)
    n_users = len(w.subjects)
    subjects = [SubjectRef("user", w.subjects[i]) for i in
                rng.choice(n_users, LOOKUP_LANES, replace=False)]
    pairs, _ = _leo_pairs(w, rng, N_CHECKS)
    reqs = [CheckRequest(ObjectRef("doc", d), "view", SubjectRef("user", u))
            for d, u in pairs]
    kernels.reset_launches()
    s0 = dict(m.stats)
    t0 = time.perf_counter()
    look = asyncio.run(m.lookup_resources_batch("doc", "view", subjects))
    timer.sync()
    t_look = time.perf_counter() - t0
    t0 = time.perf_counter()
    chk = asyncio.run(m.check_bulk_permissions(reqs))
    timer.sync()
    t_chk = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in kernels.KERNEL_NAMES}
    served = {k: m.stats[k] - s0[k] for k in ("leopard_checks",
                                              "leopard_lookups",
                                              "kernel_calls")}
    swept = [k for k in ("ell_gather_or", "perm_program", "sweep_delta",
                         "sweep_delta_checks", "seed_bitplanes", "lookup_T")
             if launches[k]]
    if swept or served["kernel_calls"] or served["leopard_checks"] != \
            len(reqs) or not (launches["check_gather"]
                              and launches["word_cols_T"]):
        raise AssertionError(f"the mesh reads were not served from the "
                             f"sharded plane: {served}, {launches}")
    a_l = asyncio.run(a.lookup_resources_batch("doc", "view", subjects))
    a_c = asyncio.run(a.check_bulk_permissions(reqs))
    if [sorted(x) for x in look] != [sorted(x) for x in a_l] or \
            [c.allowed for c in chk] != [c.allowed for c in a_c]:
        raise AssertionError("mesh plane answers differ from endpoint A's")
    log(f"mesh group-explosion reads from the sharded plane: lookup "
        f"{t_look:.4f} s, check {t_chk:.4f} s (cold); served {served}; "
        f"launches check_gather {launches['check_gather']}, word_cols_T "
        f"{launches['word_cols_T']}, no sweep kernel; answers equal A's "
        f"({sum(c.allowed for c in chk)} HAS of {len(reqs)})")
    log(f"phase 13d wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def _concurrent(calls: list) -> tuple:
    """Run the coroutine factories `calls` concurrently in one new event
    loop: (results in call order, each call's seconds from the common
    start to its answer, wall seconds)."""
    async def go():
        t0 = time.perf_counter()
        lat = [0.0] * len(calls)

        async def timed(i, make):
            out = await make()
            lat[i] = time.perf_counter() - t0
            return out

        res = await asyncio.gather(*(timed(i, c) for i, c in
                                     enumerate(calls)))
        return list(res), lat, time.perf_counter() - t0

    return asyncio.run(go())


def _pcts(xs: list) -> str:
    import numpy as np
    p50, p99 = np.percentile(np.asarray(xs), [50, 99])
    return f"p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms"


def batched_dispatch(ep, w, smi_line: str, device: str = "cuda") -> dict:
    """Phase 14: cross-request batched dispatch on the phase-3 endpoint,
    wrapped in the port's `BatchingEndpoint` (no second graph is built).
    (a) BASELINE config 5: 256 concurrent `lookup_resources` calls, one
    per user, must answer as one direct 256-lane batch, in fewer than 256
    inner kernel calls and fused batches of more than one; (b) 64
    concurrent `check_bulk_permissions` calls (10,000 pairs in all)
    interleaved with 256 concurrent lookups must answer as the direct
    endpoint; every read kernel must launch in (a)-(b); (e) the side-stream
    readback ran once for every fused batch, and a readback's bytes equal
    a blocking copy of the same result; (c) (a) and (b) at pipeline depth
    1 and 2 and through the direct endpoint, DISPATCH_REPEATS runs each,
    interleaved: wall times, per-request p50/p99 and batch counts; (d) a
    lookup and a check batch started before one round of phase 9's churn
    and finished after its flush and sweep-graph recapture return the
    pre-write answers.  A fixed-seed sample of (a)-(b) equals the oracle."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import _Readback
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import (
        BatchingEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, CheckResult, ObjectRef, RelationshipUpdate, SubjectRef,
        UpdateOp, parse_relationship)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    users = w.subjects
    subjects = [SubjectRef("user", users[i]) for i in
                rng.choice(len(users), LOOKUP_LANES, replace=False)]
    want_lr = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    pods = [p for p in ep.graph().prog.object_ids["pod"] if "\x00" not in p]
    # half the pairs from the subjects' own answers, half at random
    reqs = []
    for k in range(N_CHECKS):
        s = int(rng.integers(0, LOOKUP_LANES))
        own = want_lr[s]
        pod = (own[int(rng.integers(0, len(own)))] if k % 2 and len(own)
               else pods[int(rng.integers(0, len(pods)))])
        reqs.append(CheckRequest(ObjectRef("pod", pod), "view",
                                 subjects[s]))
    want_ck = [r.permissionship for r in
               asyncio.run(ep.check_bulk_permissions(reqs))]
    cuts = np.linspace(0, N_CHECKS, DISPATCH_CHECK_CALLS + 1).astype(int)
    chunks = [reqs[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    per_chunk = LOOKUP_LANES // DISPATCH_CHECK_CALLS

    def calls_a(target):
        return [lambda s=s: target.lookup_resources("pod", "view", s)
                for s in subjects]

    def calls_b(target):
        """Lookups and check calls interleaved: a check call after every
        `per_chunk` lookups."""
        out = []
        for i, s in enumerate(subjects):
            out.append(lambda s=s: target.lookup_resources("pod", "view", s))
            if i % per_chunk == per_chunk - 1:
                out.append(lambda c=chunks[i // per_chunk]:
                           target.check_bulk_permissions(c))
        return out

    def split_b(res, lat):
        """(lookup answers, check answers, lookup and check latencies)."""
        lr, ck, lat_l, lat_c = [], [], [], []
        for r, t in zip(res, lat):
            if isinstance(r, list) and r and isinstance(r[0], CheckResult):
                ck.extend(x.permissionship for x in r)
                lat_c.append(t)
            else:
                lr.append(list(r))
                lat_l.append(t)
        return lr, ck, lat_l, lat_c

    want_lists = [list(x) for x in want_lr]

    def agree(lr, ck, what):
        if lr is not None and lr != want_lists:
            bad = sum(a != b for a, b in zip(lr, want_lists))
            raise AssertionError(f"{what}: {bad} of {len(lr)} lookups differ "
                                 f"from the direct 256-lane batch")
        if ck is not None and ck != want_ck:
            bad = sum(a != b for a, b in zip(ck, want_ck))
            raise AssertionError(f"{what}: {bad} of {len(ck)} checks differ "
                                 f"from the direct endpoint")

    # (a) + (b) through the dispatcher at depth 2, launches counted from 0
    bep = BatchingEndpoint(ep, pipeline_depth=2)
    s0 = bep.stats
    kernels.reset_launches()
    res_a, lat_a, wall_a = _concurrent(calls_a(bep))
    s1 = bep.stats
    res_b, lat_b, wall_b = _concurrent(calls_b(bep))
    launches = {k: kernels.LAUNCHES[k] for k in READ_KERNELS}
    s2 = bep.stats
    agree([list(x) for x in res_a], None, "(a) batched")
    calls_made = s1["kernel_calls"] - s0["kernel_calls"]
    fused_a = (s1["fused_lookups"] - s0["fused_lookups"])
    if not calls_made < LOOKUP_LANES or s1["max_fused_batch"] <= 1:
        raise AssertionError(f"(a) did not batch: {calls_made} kernel calls, "
                             f"max fused batch {s1['max_fused_batch']}")
    log(f"dispatch (a): {LOOKUP_LANES} concurrent lookup_resources calls "
        f"answered as the direct {LOOKUP_LANES}-lane batch in {wall_a:.4f} s: "
        f"{calls_made} kernel calls, {fused_a} fused lookup batches, max "
        f"fused batch {s1['max_fused_batch']}; per request "
        f"{_pcts(lat_a)}; {smi_line}")
    lr_b, ck_b, lat_bl, lat_bc = split_b(res_b, lat_b)
    agree(lr_b, ck_b, "(b) batched")
    log(f"dispatch (b): {DISPATCH_CHECK_CALLS} concurrent "
        f"check_bulk_permissions calls ({N_CHECKS} pairs) and "
        f"{LOOKUP_LANES} lookups interleaved answered as the direct endpoint "
        f"in {wall_b:.4f} s: {s2['fused_checks'] - s1['fused_checks']} fused "
        f"check and {s2['fused_lookups'] - s1['fused_lookups']} fused lookup "
        f"batches, {s2['kernel_calls'] - s1['kernel_calls']} kernel calls; "
        f"lookups {_pcts(lat_bl)}, check calls {_pcts(lat_bc)}")
    log(f"launches on the batched path (a)-(b): {launches}")
    idle = [k for k, v in launches.items() if v == 0]
    if idle and device == "cuda":    # the CPU runs the twins, uncounted
        raise AssertionError(f"kernels never launched on the batched path: "
                             f"{idle}")

    # the oracle, on a fixed-seed sample: checks, and each sampled
    # subject's lookup through checks of its allowed and refused pods
    oracle = ep._oracle
    t0 = time.perf_counter()
    for i in rng.choice(N_CHECKS, DISPATCH_ORACLE_CHECKS, replace=False):
        r = reqs[i]
        if oracle.check3(r.resource, r.permission, r.subject) != \
                {"NO_PERMISSION": 0, "CONDITIONAL_PERMISSION": 1,
                 "HAS_PERMISSION": 2}[ck_b[i].name]:
            raise AssertionError(f"check {r} differs from the oracle")
    n_held = 0
    for j in rng.choice(LOOKUP_LANES, DISPATCH_ORACLE_SUBJECTS,
                        replace=False):
        got = set(res_a[j])
        allowed = sorted(got)
        refused = [p for p in (pods[int(i)] for i in
                               rng.choice(len(pods), 4 * DISPATCH_ORACLE_PODS,
                                          replace=False))
                   if p not in got][:DISPATCH_ORACLE_PODS]
        for want, sample in ((True, [allowed[int(i)] for i in rng.choice(
                len(allowed), min(len(allowed), DISPATCH_ORACLE_PODS),
                replace=False)] if allowed else []), (False, refused)):
            for pod in sample:
                if oracle.check(ObjectRef("pod", pod), "view",
                                subjects[j]) != want:
                    raise AssertionError(f"lookup of {subjects[j]} differs "
                                         f"from the oracle at {pod}")
                n_held += 1
    log(f"dispatch oracle: {DISPATCH_ORACLE_CHECKS} checks of (b) and "
        f"{n_held} checks of {DISPATCH_ORACLE_SUBJECTS} lookups of (a) "
        f"(allowed and refused pods) equal the oracle "
        f"({time.perf_counter() - t0:.1f} s)")

    # (e) the readback: one side-stream copy for every fused lookup batch
    # (nothing is served from a closure plane at multitenant-1m), its
    # bytes equal to a blocking copy of the same result; a fused check
    # batch starts none: its answers come back with its last sweep (the
    # ELL check tail), on the host, equal to the standalone gather
    fused_l = s2["fused_lookups"] - s0["fused_lookups"]
    fused_c = s2["fused_checks"] - s0["fused_checks"]
    rbs = s2["readbacks"] - s0["readbacks"]
    g = ep.graph()
    q_arr, cols, _ = ep._encode_subjects(g, subjects)
    off, length = g.prog.slot_range("pod", "view")
    dev_l, _, _ = g.run_lookup_packed_T_device(off, length, q_arr)
    gi = [g.prog.state_index("pod", "view", r.resource.id)
          for r in chunks[0]]
    gc = [cols[r.subject] for r in chunks[0]]
    host_c, _, _ = g.run_checks3_device(q_arr, gi, gc)
    kc = g.kernel
    main, aux, cav = g.snapshot()
    n_words = len(q_arr) // 32
    x_fin, _ = kc.evaluate(torch.from_numpy(q_arr).to(kc.device), n_words,
                           main, aux, kc.take_arena(n_words), cav)
    alone = kernels.check_gather(
        x_fin, torch.tensor(gi, dtype=torch.int32, device=kc.device),
        torch.tensor(gc, dtype=torch.int32, device=kc.device)).cpu()
    rb_c = _Readback(host_c)
    if (host_c.device.type != "cpu" or rb_c.event is not None
            or rb_c.wait() is not host_c
            or not torch.equal(host_c[:len(gi)], alone)):
        raise AssertionError("a check batch's answers did not arrive on the "
                             "host with its sweeps, equal to check_gather")
    rb = _Readback(dev_l)
    host = rb.wait()
    same = bool(torch.equal(host, dev_l.cpu()))
    if device == "cuda" and not (rb.event is not None and host.is_pinned()):
        raise AssertionError("the readback did not go through a pinned "
                             "side-stream copy")
    # host ms of each way, the result already computed (median of 10)
    times = []
    for fn in (lambda: _Readback(dev_l).wait(), dev_l.cpu):
        ts = []
        for _ in range(10):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        times.append(statistics.median(ts))
    if device == "cuda" and rbs != fused_l:
        raise AssertionError(f"{rbs} side-stream readbacks for {fused_l} "
                             f"fused lookup batches ({fused_c} check "
                             f"batches)")
    if not same:
        raise AssertionError("a readback differs from a blocking copy of the "
                             "same result")
    log(f"dispatch (e): {rbs} side-stream readbacks ({s2['readback_bytes'] - s0['readback_bytes']} "
        f"bytes) for {fused_l} fused lookup batches, none for {fused_c} "
        f"fused check batches (their answers arrive with the last sweep, "
        f"equal to check_gather on the converged state); a lookup's [W, L] "
        f"words read back equal to a blocking .cpu() copy; host ms (median "
        f"of 10), side-stream readback vs .cpu(): {times[0]:.4f} vs "
        f"{times[1]:.4f} ({dev_l.numel() * 4} B)")

    # (c) depth 1, depth 2 and direct dispatch, interleaved per repeat
    modes = {"depth 1": BatchingEndpoint(ep, pipeline_depth=1),
             "depth 2": BatchingEndpoint(ep, pipeline_depth=2),
             "direct": ep}
    runs = {(m, part): [] for m in modes for part in "ab"}
    for _ in range(DISPATCH_REPEATS):
        for m, target in modes.items():
            for part in "ab":
                st0 = dict(target.stats)
                res, lat, wall = _concurrent(
                    (calls_a if part == "a" else calls_b)(target))
                st1 = dict(target.stats)
                if part == "a":
                    agree([list(x) for x in res], None, f"(c) {m} (a)")
                    lat_l, lat_c = lat, []
                else:
                    lr, ck, lat_l, lat_c = split_b(res, lat)
                    agree(lr, ck, f"(c) {m} (b)")
                runs[(m, part)].append({
                    "wall": wall, "lat_l": lat_l, "lat_c": lat_c,
                    "calls": st1["kernel_calls"] - st0["kernel_calls"],
                    "fused": sum(st1.get(k, 0) - st0.get(k, 0) for k in
                                 ("fused_lookups", "fused_checks"))})
    summary = {}
    for (m, part), rs in runs.items():
        lat_l = [t for r in rs for t in r["lat_l"]]
        lat_c = [t for r in rs for t in r["lat_c"]]
        walls = [r["wall"] for r in rs]
        summary[(m, part)] = statistics.median(walls)
        log(f"dispatch (c) {m}, ({part}): median wall "
            f"{statistics.median(walls):.4f} s (all: "
            f"{', '.join(f'{t:.4f}' for t in walls)}); lookups "
            f"{_pcts(lat_l)}"
            + (f"; check calls {_pcts(lat_c)}" if lat_c else "")
            + f"; fused batches {[r['fused'] for r in rs]}, kernel calls "
            f"{[r['calls'] for r in rs]}; {smi_line}")

    # the telemetry's cost: (a) on the batched (depth 2) and the direct
    # endpoint with the DeviceTelemetry, Timeline and KernelIntrospect
    # switches on and off, interleaved per repeat
    from spicedb_kubeapi_proxy_tpu_torch.utils import features
    switches = ("DEVICE_TELEMETRY", "TIMELINE", "KERNEL_INTROSPECT")
    saved = {k: getattr(features, k) for k in switches}
    tel = {(m, on): [] for m in ("depth 2", "direct") for on in (1, 0)}
    try:
        for _ in range(DISPATCH_REPEATS):
            for m in ("depth 2", "direct"):
                for on in (1, 0):
                    for k in switches:
                        setattr(features, k, bool(on))
                    res, _, wall = _concurrent(calls_a(modes[m]))
                    agree([list(x) for x in res], None,
                          f"telemetry {m} {'on' if on else 'off'}")
                    tel[(m, on)].append(wall)
    finally:
        for k, v in saved.items():
            setattr(features, k, v)
    for m in ("depth 2", "direct"):
        on, off = (statistics.median(tel[(m, x)]) for x in (1, 0))
        log(f"dispatch telemetry cost, {m} (a): median wall {on:.4f} s with "
            f"the three switches on, {off:.4f} s off ({(on / off - 1) * 100:+.2f} "
            f"%); on {', '.join(f'{t:.4f}' for t in tel[(m, 1)])}; off "
            f"{', '.join(f'{t:.4f}' for t in tel[(m, 0)])}; {smi_line}")
    summary["telemetry"] = {f"{m} {'on' if x else 'off'}": v
                            for (m, x), v in tel.items()}

    # (d) batches started before a churn round finish on their snapshot
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    rnd = _churn_plan(w, 1, SEED + 14, tag="d")[0]
    creators = list(dict.fromkeys(u for _, _, u in rnd["created"]))
    d_subj = [SubjectRef("user", u) for u in creators]
    d_subj += [s for s in subjects if s.id not in set(creators)]
    d_subj = d_subj[:LOOKUP_LANES]
    d_reqs = [CheckRequest(ObjectRef("pod", pod), "view",
                           SubjectRef("user", u))
              for pod, _, u in rnd["created"]] + chunks[0]
    before_l = [list(x) for x in asyncio.run(
        ep.lookup_resources_batch("pod", "view", d_subj))]
    before_c = [r.permissionship for r in
                asyncio.run(ep.check_bulk_permissions(d_reqs))]
    ctx_l = asyncio.run(ep.lookup_resources_batch_start("pod", "view",
                                                        d_subj))
    ctx_c = asyncio.run(ep.check_bulk_permissions_start(d_reqs))
    st0 = dict(ep.stats)
    gs0 = dict(ep.graph().kernel.graph_stats)

    async def commit(writes):
        for wr in writes:
            await ep.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    asyncio.run(commit(rnd["writes"]))
    after_l = [list(x) for x in asyncio.run(
        ep.lookup_resources_batch("pod", "view", d_subj))]
    gs1 = ep.graph().kernel.graph_stats
    st1 = ep.stats
    if not (st1["delta_batches"] > st0["delta_batches"]
            and st1["rebuilds"] == st0["rebuilds"]
            and (device != "cuda" or gs1["captures"] > gs0["captures"])):
        raise AssertionError("the churn round did not flush and recapture "
                             "without a rebuild")
    fin_l = [list(x) for x in asyncio.run(
        ep.lookup_resources_batch_finish(ctx_l))]
    fin_c = [r.permissionship for r in asyncio.run(
        ep.check_bulk_permissions_finish(ctx_c))]
    changed = sum(a != b for a, b in zip(after_l, before_l))
    if fin_l != before_l or fin_c != before_c or not changed:
        raise AssertionError(
            f"(d): started batches did not keep their snapshot's answers "
            f"(lookups equal {fin_l == before_l}, checks equal "
            f"{fin_c == before_c}, {changed} answers changed by the writes)")
    log(f"dispatch (d): a {len(d_subj)}-lane lookup batch and a "
        f"{len(d_reqs)}-pair check batch started before a churn round "
        f"finished after its flush ({st1['delta_batches'] - st0['delta_batches']} "
        f"flushes, {gs1['captures'] - gs0['captures']} sweep graph captures, "
        f"no rebuild) with their pre-write answers; {changed} of "
        f"{len(d_subj)} lookups have since changed")
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "summary": summary}

# -- phase 15, off-loop rebuilds ------------------------------------------------

def _hold(ep, name: str, gate, reached=None, before: bool = True):
    """Make `ep.<name>` (a candidate build step) wait for `gate` before
    (or after) it runs, setting `reached` when it gets there.  Returns a
    function that restores the method."""
    import threading
    orig = getattr(ep, name)
    reached = reached if reached is not None else threading.Event()

    def held(*args):
        if before:
            reached.set()
            if not gate.wait(timeout=600):
                raise RuntimeError(f"{name} held for 600 s")
        out = orig(*args)
        if not before:
            reached.set()
            if not gate.wait(timeout=600):
                raise RuntimeError(f"{name} held for 600 s")
        return out

    setattr(ep, name, held)
    return lambda: delattr(ep, name)


def _switch(on: bool) -> None:
    """The port's ASYNC_REBUILD switch (phases 1-14 run with it off: each
    asserts that its churn rebuilds nothing)."""
    from spicedb_kubeapi_proxy_tpu_torch.utils import features
    features.ASYNC_REBUILD = on


def background_swap(x_ep, label: str) -> None:
    """One background swap on `x_ep` (switch on, candidate prewarmed):
    the rebuild is kicked directly, as a preemptive one would be, and
    `wait_rebuilds()` must see it installed with no failure."""
    _switch(True)
    try:
        x_ep.prewarm_rebuilds = True
        n0 = x_ep.stats["bg_rebuilds"]
        gen = x_ep._graph
        with x_ep._lock:
            x_ep._kick_background_rebuild("background")
        if not x_ep.wait_rebuilds(timeout=600):
            raise AssertionError(f"{label}: the background rebuild did not "
                                 "finish")
        if (x_ep.stats["bg_rebuilds"] != n0 + 1 or x_ep._graph is gen
                or x_ep.stats["rebuild_failures"]):
            raise AssertionError(f"{label}: no background swap "
                                 f"({x_ep.stats['bg_rebuilds'] - n0} "
                                 f"installs, "
                                 f"{x_ep.stats['rebuild_failures']} failures)")
    finally:
        x_ep.prewarm_rebuilds = False
        _switch(False)
    log(f"{label}: one background swap (candidate prewarmed), "
        f"{x_ep.stats['bg_install_s'] * 1e3:.3f} ms of lock-held installs "
        "so far")


def swap_and_agree(x_ep, ref_ep, rt: str, perm: str, subjects: list,
                   reqs: list, label: str) -> None:
    """One background swap on `x_ep`; before and after it, and on
    `ref_ep` (the single-device endpoint), the lookups and tri-state
    checks are equal, and a sample of the checks equals the oracle's."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)

    def answers(e):
        looked = [sorted(x) for x in asyncio.run(
            e.lookup_resources_batch(rt, perm, subjects))]
        checked = [r.permissionship for r in asyncio.run(
            e.check_bulk_permissions(reqs))]
        return looked, checked

    before = answers(x_ep)
    background_swap(x_ep, label)
    after = answers(x_ep)
    if after != before or after != answers(ref_ep):
        raise AssertionError(f"{label}: answers changed across the swap or "
                             "differ from the single-device endpoint's")
    tri = TorchEndpoint._TRISTATE
    bad = sum(tri[x_ep._oracle.check3(r.resource, r.permission, r.subject)]
              != after[1][i] for i, r in
              enumerate(reqs[:OFFLOOP_SWAP_ORACLE]))
    if bad:
        raise AssertionError(f"{label}: {bad} checks differ from the oracle")
    log(f"{label}: after the swap {len(subjects)} lookups and {len(reqs)} "
        f"tri-state checks equal those before it and the single-device "
        f"endpoint's; {OFFLOOP_SWAP_ORACLE} equal the oracle's")


def offloop_rebuild(ep, w, batches, reqs, smi_line: str,
                    device: str = "cuda") -> dict:
    """Phase 15: off-loop rebuilds at multitenant-1m, on the phase-3
    store.  (a) a fresh endpoint with `warm_start(prewarm=True)`: its
    first 256-lane lookup and 10,000-pair check batches run no eager
    sweep, make no capture and answer as the phase-3 endpoint; (b)
    unique-name pods created on spare rows past the pool's 25 % low
    watermark while a reader thread issues 256-lane pod#view lookup
    batches, once with ASYNC_REBUILD on (a preemptive background rebuild,
    no quarantine) and once off (the pool runs dry and the rebuild lands
    on a read): the reader's p50/p99/max, the lock-held install and the
    card's memory before, at its peak during and after the swap; (c)
    more new tenants in one write than the tenant pool holds: pod#view
    is quarantined to the oracle while the (held) candidate waits, a
    pair outside the closure (group#member) stays on the kernel, and
    after the swap the tables equal the host's and the answers equal a
    `force_rebuild()`'s and the oracle's; (d) launches counted from zero
    over one background swap with writes replayed at its install: the
    candidate's prewarm and replay flush launch every read kernel and
    `scatter_rows`.  Returns the launches of (d)."""
    import threading
    import weakref

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, Permissionship, RelationshipUpdate,
        SubjectRef, UpdateOp, parse_relationship)

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    rng = np.random.default_rng(SEED + 15)
    subjects = batches[0]
    ep.wait_rebuilds()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def answers(x_ep):
        looked = [sorted(x) for x in asyncio.run(
            x_ep.lookup_resources_batch("pod", "view", subjects))]
        checked = [r.permissionship for r in asyncio.run(
            x_ep.check_bulk_permissions(reqs))]
        return looked, checked

    # (a) a fresh endpoint on the store, prewarmed at its warm start
    _switch(True)
    t0 = time.perf_counter()
    fresh = create_endpoint(direct_url(device), Bootstrap(w.schema_text, ""),
                            store=ep.store)
    fresh.warm_start(prewarm=True)
    sync()
    t_warm = time.perf_counter() - t0
    g = fresh.graph()
    gs0 = dict(g.kernel.graph_stats)
    buckets = sorted(g.kernel._arenas)
    ranges = fresh._prewarm_slot_ranges(g)
    log(f"offloop (a): warm_start(prewarm=True) {t_warm:.3f} s (graph build "
        f"and prewarm): {len(buckets)} lane buckets warmed ({[32 * b for b in buckets]} "
        f"lanes) x {len(ranges)} lookup slot ranges + checks, "
        f"{gs0['captures']} sweep graph captures, {gs0['eager_sweeps']} "
        f"eager sweeps")
    t0 = time.perf_counter()
    got = answers(fresh)
    sync()
    t_first = time.perf_counter() - t0
    gs1 = dict(fresh.graph().kernel.graph_stats)
    if gs1["eager_sweeps"] != gs0["eager_sweeps"] or \
            gs1["captures"] != gs0["captures"]:
        raise AssertionError(f"(a): the first batches after the prewarm ran "
                             f"{gs1['eager_sweeps'] - gs0['eager_sweeps']} "
                             f"eager sweeps and made "
                             f"{gs1['captures'] - gs0['captures']} captures")
    if got != answers(ep):
        raise AssertionError("(a): the prewarmed endpoint's answers differ "
                             "from the phase-3 endpoint's")
    log(f"offloop (a): first {LOOKUP_LANES}-lane lookup and {len(reqs)}-pair "
        f"check batches after the prewarm {t_first:.4f} s: 0 eager sweeps, 0 "
        f"captures, {gs1['replays'] - gs0['replays']} graph replays; answers "
        "equal the phase-3 endpoint's")
    del g      # hold no generation: (b) checks that a swap frees it

    # (b) unique-name pod churn past the watermark under a reader
    ns_of = [n for n in fresh.graph().prog.object_ids["namespace"]
             if "\x00" not in n]
    users = w.subjects

    def create_pods(x_ep, tag: str, n: int) -> list:
        made = []
        for i in range(n):
            ns = ns_of[int(rng.integers(len(ns_of)))]
            u = users[int(rng.integers(len(users)))]
            pod = f"{ns}/{tag}-{i}"
            x_ep.store.write([
                RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
                    f"pod:{pod}#namespace@namespace:{ns}")),
                RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
                    f"pod:{pod}#creator@user:{u}"))])
            made.append((pod, u))
            if i % OFFLOOP_WRITE_PODS == OFFLOOP_WRITE_PODS - 1:
                time.sleep(OFFLOOP_WRITE_GAP_S)
        return made

    def churn_run(on: bool, tag: str) -> dict:
        _switch(on)
        fresh.wait_rebuilds()
        pool = len(fresh._spare_pool["pod"])
        n = pool + OFFLOOP_EXTRA_PODS
        st0 = dict(fresh.stats)
        outgoing = weakref.ref(fresh._graph)
        gc.collect()
        sync()
        mem0 = torch.cuda.memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        stop = threading.Event()
        lat, errors = [], []

        def reader():
            try:
                while not stop.is_set():
                    t = time.perf_counter()
                    asyncio.run(fresh.lookup_resources_batch(
                        "pod", "view", subjects))
                    lat.append(time.perf_counter() - t)
            except Exception as e:      # raised by the main thread
                errors.append(e)

        def no_oracle_lookups(*args):
            # a quarantined pod#view lookup would go to the host oracle
            # (minutes a subject at this size): fail at once instead
            raise AssertionError("(b): a pod#view lookup was routed to the "
                                 "oracle")

        fresh._oracle.lookup_resources = no_oracle_lookups
        th = threading.Thread(target=reader)
        th.start()
        t0 = time.perf_counter()
        try:
            made = create_pods(fresh, tag, n)
            t_write = time.perf_counter() - t0
            time.sleep(0.5)     # the reader applies the last writes
            if not fresh.wait_rebuilds(timeout=600):
                raise AssertionError("(b): background rebuilds did not "
                                     "settle")
        finally:
            stop.set()
            th.join(timeout=600)
            del fresh._oracle.lookup_resources
        if th.is_alive():
            raise AssertionError("(b): the reader thread did not stop")
        if errors:
            raise errors[0]
        gc.collect()
        sync()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        mem1 = torch.cuda.memory_allocated() if on_card else 0
        d = {k: fresh.stats[k] - st0[k] for k in
             ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
              "stale_routed", "stale_pair_marks", "spare_assignments")}
        p50, p99 = np.percentile(np.asarray(lat), [50, 99])
        if outgoing() is not None:
            raise AssertionError("(b): the outgoing generation is still "
                                 "alive after the swap")
        out = {"pool": pool, "pods": n, "write_s": t_write,
               "reads": len(lat), "p50_s": float(p50), "p99_s": float(p99),
               "max_s": max(lat), "install_ms": (fresh.stats["bg_install_s"]
                                                 - st0["bg_install_s"]) * 1e3,
               "mem_mb": (mem0 / 2 ** 20, peak / 2 ** 20, mem1 / 2 ** 20),
               **d}
        log(f"offloop (b) ASYNC_REBUILD {'on' if on else 'off'}: {n} pods "
            f"created on a {pool}-row spare pool in {t_write:.2f} s; reader "
            f"{len(lat)} {LOOKUP_LANES}-lane lookup batches p50 "
            f"{p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms, max "
            f"{max(lat) * 1e3:.3f} ms; rebuilds {d['rebuilds']} (background "
            f"{d['bg_rebuilds']}, preemptive {d['preemptive_rebuilds']}), "
            f"stale pairs {d['stale_pair_marks']}, stale-routed reads "
            f"{d['stale_routed']}; lock-held install {out['install_ms']:.3f} "
            f"ms; card memory before {out['mem_mb'][0]:.1f} MiB, peak "
            f"{out['mem_mb'][1]:.1f} MiB, after {out['mem_mb'][2]:.1f} MiB "
            f"({smi_line})")
        # the creators see their pods
        sample = made[:: max(1, len(made) // 500)]
        res = asyncio.run(fresh.check_bulk_permissions(
            [CheckRequest(ObjectRef("pod", p), "view", SubjectRef("user", u))
             for p, u in sample]))
        if not all(r.allowed for r in res):
            raise AssertionError("(b): a creator cannot view a created pod")
        _tables_match(fresh.graph())
        return out

    runs = {"on": churn_run(True, "q15on")}
    fresh.force_rebuild()           # a full pool again for the other run
    runs["off"] = churn_run(False, "q15off")
    on, off = runs["on"], runs["off"]
    if on["preemptive_rebuilds"] < 1 or on["stale_routed"] or \
            on["stale_pair_marks"]:
        raise AssertionError(f"(b) on: expected a preemptive rebuild and no "
                             f"quarantine: {on}")
    if off["rebuilds"] < 1 or off["bg_rebuilds"]:
        raise AssertionError(f"(b) off: expected a synchronous rebuild: {off}")

    # (c) a forced quarantine: more new tenants than the tenant pool holds
    _switch(True)
    fresh.wait_rebuilds()
    t_pool = len(fresh._spare_pool["tenant"])
    n_t = t_pool + OFFLOOP_EXTRA_TENANTS
    new_t = [(f"tq{k}", users[int(rng.integers(len(users)))])
             for k in range(n_t)]
    gate = threading.Event()
    restore = _hold(fresh, "_build_candidate", gate)
    st0 = dict(fresh.stats)
    try:
        fresh.store.write([RelationshipUpdate(UpdateOp.TOUCH,
                                              parse_relationship(
                                                  f"tenant:{t}#member@user:{u}"))
                           for t, u in new_t])
        pick = rng.choice(len(reqs), OFFLOOP_ORACLE_CHECKS, replace=False)
        q_reqs = [reqs[i] for i in pick]
        t0 = time.perf_counter()
        routed = asyncio.run(fresh.check_bulk_permissions(q_reqs))
        t_routed = time.perf_counter() - t0
        n_routed = fresh.stats["stale_routed"] - st0["stale_routed"]
        if ("pod", "view") not in fresh._stale_pairs or \
                n_routed != len(q_reqs) or \
                any(r.source != "oracle" for r in routed):
            raise AssertionError(f"(c): pod#view was not quarantined "
                                 f"({n_routed} routed)")
        if any(r.allowed != fresh._oracle.check(q.resource, q.permission,
                                                 q.subject)
               for r, q in zip(routed, q_reqs)):
            raise AssertionError("(c): quarantined answers differ from the "
                                 "oracle's")
        t0 = time.perf_counter()
        members = asyncio.run(fresh.lookup_resources_batch(
            "group", "member", subjects))
        t_outside = time.perf_counter() - t0
        if (fresh.stats["stale_routed"] - st0["stale_routed"] != n_routed
                or any(x.source != "kernel" for x in members)
                or not fresh.rebuild_inflight):
            raise AssertionError("(c): group#member left the kernel, or the "
                                 "build was not in flight")
        access = asyncio.run(fresh.check_bulk_permissions(
            [CheckRequest(ObjectRef("tenant", t), "access",
                          SubjectRef("user", u)) for t, u in new_t]))
        if not all(r.allowed for r in access):
            raise AssertionError("(c): a new tenant member has no access")
    finally:
        gate.set()
        restore()
    if not fresh.wait_rebuilds(timeout=600):
        raise AssertionError("(c): the background rebuild did not finish")
    d = {k: fresh.stats[k] - st0[k] for k in
         ("rebuilds", "bg_rebuilds", "stale_pair_marks", "stale_routed")}
    if d["bg_rebuilds"] < 1 or fresh._stale_pairs:
        raise AssertionError(f"(c): no clean background swap: {d}")
    _tables_match(fresh.graph())
    swapped = answers(fresh)
    access = [r.permissionship for r in asyncio.run(
        fresh.check_bulk_permissions(
            [CheckRequest(ObjectRef("tenant", t), "access",
                          SubjectRef("user", u)) for t, u in new_t]))]
    fresh.force_rebuild()
    if answers(fresh) != swapped or access != [r.permissionship for r in
                                                asyncio.run(
            fresh.check_bulk_permissions(
                [CheckRequest(ObjectRef("tenant", t), "access",
                              SubjectRef("user", u)) for t, u in new_t]))]:
        raise AssertionError("(c): the swapped generation's answers differ "
                             "from force_rebuild()'s")
    bad = sum(fresh._oracle.check(q.resource, q.permission, q.subject)
              != (swapped[1][i] == Permissionship.HAS_PERMISSION)
              for q, i in zip(q_reqs, pick))
    if bad:
        raise AssertionError(f"(c): {bad} answers differ from the oracle")
    log(f"offloop (c): {n_t} new tenants on a {t_pool}-row pool: "
        f"{d['stale_pair_marks']} pairs quarantined, {n_routed} pod#view "
        f"checks routed to the oracle in {t_routed:.4f} s while the candidate "
        f"was held; a {LOOKUP_LANES}-lane group#member lookup on the kernel "
        f"meanwhile {t_outside:.4f} s; after the swap ({d['bg_rebuilds']} "
        f"background installs) no pair is quarantined, the card's tables "
        f"equal the host's, and the answers equal force_rebuild()'s and "
        f"{len(q_reqs)} oracle checks")

    # (d) launches from zero over one background swap, writes replayed
    fresh.wait_rebuilds()
    fresh.prewarm_rebuilds = True
    gate, reached = threading.Event(), threading.Event()
    restore = _hold(fresh, "_prewarm_graph", gate, reached, before=False)
    kernels.reset_launches()
    f0 = fresh.stats["delta_batches"]
    try:
        with fresh._lock:
            fresh._kick_background_rebuild("background")
        if not reached.wait(timeout=600):
            raise AssertionError("(d): the candidate never prewarmed")
        create_pods(fresh, "q15d", 64)
    finally:
        gate.set()
        restore()
    if not fresh.wait_rebuilds(timeout=600):
        raise AssertionError("(d): the background rebuild did not finish")
    fresh.prewarm_rebuilds = False
    launches = dict(kernels.LAUNCHES)
    need = READ_KERNELS + ("scatter_rows",)
    # (CPU twins count no launches: on the CPU this checks nothing)
    idle = [k for k in need if on_card and not launches[k]]
    if idle or fresh.stats["delta_batches"] != f0:
        raise AssertionError(f"(d): kernels the candidate never launched: "
                             f"{idle}")
    _tables_match(fresh.graph())
    log(f"offloop (d): launches over one background swap (prewarm + replay "
        f"of 64 pod creates at the install), counted from zero after "
        f"wait_rebuilds(): { {k: v for k, v in launches.items() if v} }")
    _switch(False)
    del fresh
    gc.collect()
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "runs": runs}


# -- phase 16, the proxy's read path ------------------------------------------


def _seed_proxy_kube(n_namespaces: int, n_pods: int, n_events: int):
    """The fake kube-apiserver of phase 16: namespaces ns0.., pods
    ns{p % n}/p{p} and events ns{e % n}/ev{e}."""
    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    kube = FakeKubeApiServer()
    for n in range(n_namespaces):
        kube.seed("", "v1", "namespaces", {"metadata": {"name": f"ns{n}"}})
    for p in range(n_pods):
        kube.seed("", "v1", "pods", {"metadata": {
            "name": f"p{p}", "namespace": f"ns{p % n_namespaces}"}})
    for e in range(n_events):
        kube.seed("", "v1", "events", {"metadata": {
            "name": f"ev{e}", "namespace": f"ns{e % n_namespaces}"}})
    return kube


def _oracle_pods(oracle, pods: list, subject) -> set:
    """The oracle's answer for `subject` over `pods` ("ns/name" ids):
    its check of each, one memo shared by all, as its own
    lookup_resources shares one over every candidate."""
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.evaluator import YES, _Ctx
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import ObjectRef
    ctx = _Ctx()
    return {p for p in pods
            if oracle._check(ObjectRef("pod", p), "view", subject, 0,
                             ctx) == YES}


def proxy_path(w, smi_line: str, device: str = "cuda") -> dict:
    """Phase 16: the proxy's read path on the card.  `ProxyServer(Options(
    spicedb_endpoint="torch://"))` over multitenant-1m (`w`, loaded into
    the server's own batched endpoint and warm-started with the prewarm),
    a fake kube-apiserver holding PROXY_NAMESPACES namespaces, PROXY_PODS
    pods and PROXY_EVENTS events, and deploy/rules.yaml's read rules
    (PROXY_READ_RULES).  Every request goes through
    `get_embedded_client(user=...)`: (a) PROXY_LIST_USERS concurrent
    `GET /api/v1/pods`, one a user (BASELINE config 5 through the proxy);
    (b) PROXY_GETS pod gets over fixed-seed (user, pod) pairs, half of
    them on pods the user may see, in waves of 100 concurrent; (c) one
    `GET /api/v1/events` postfilter list; (d) one protobuf and one Table
    list; (e) the e2e tests' watch scenario (grant then event: delivered;
    an unauthorized event: buffered; a late grant: flushed) on one
    namespace.  Checks: each list equals the seeded pods intersected with
    the bare TorchEndpoint's lookup for its user, and PROXY_ORACLE_USERS
    of them the oracle's answer; every get's status the oracle's check;
    the events the oracle's namespace checks; the protobuf and Table
    lists the JSON list's names; no read routed to the oracle
    (`stale_routed` 0); every READ_KERNELS kernel launched by these
    requests (counted from zero after the warm start, and read as the
    traffic ends; the traffic must rebuild nothing, so no background
    rebuild adds launches of its own).  Logged: (a)'s per-request
    p50/p99/max and wall; per request, the proxy's own time (request less
    upstream), the upstream round trip, the prefilter and the largest
    wait on it against PREFILTER_TIMEOUT; one direct 256-lane
    `lookup_resources_batch` of the same users on the same endpoint
    beside them and the proxy's summed phase seconds; (b)'s p50/p99; the
    launches; the card's memory."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.authz.responsefilterer import (
        PREFILTER_TIMEOUT)
    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.proxy import k8sproto
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        ObjectRef, RelationshipUpdate, SubjectRef, UpdateOp,
        parse_relationship)
    from spicedb_kubeapi_proxy_tpu_torch.utils import tracing
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    _switch(True)   # the port's default rebuild path
    rng = np.random.default_rng(SEED + 16)
    kube = _seed_proxy_kube(PROXY_NAMESPACES, PROXY_PODS, PROXY_EVENTS)
    seeded = [f"ns{p % PROXY_NAMESPACES}/p{p}" for p in range(PROXY_PODS)]
    seeded_set = set(seeded)
    rules = [proxyrule.parse_doc(d) for d in PROXY_READ_RULES]
    t0 = time.perf_counter()
    url = "torch://" if on_card else f"torch://?device={device}"
    proxy = ProxyServer(Options(
        spicedb_endpoint=url, rule_configs=rules,
        bootstrap=Bootstrap(w.schema_text, "\n".join(w.relationships)),
        upstream_transport=HandlerTransport(kube), prewarm_compiles=True))
    t1 = time.perf_counter()
    asyncio.run(proxy.warm_start())
    t2 = time.perf_counter()
    ep = proxy.endpoint
    chain = []
    while ep is not None:
        chain.append(type(ep).__name__)
        if isinstance(ep, TorchEndpoint):
            break
        ep = getattr(ep, "inner", None)
    if chain != ["InstrumentedEndpoint", "BatchingEndpoint", "TorchEndpoint"]:
        raise AssertionError(f"proxy endpoint chain {chain}")
    if ep.device.type != torch.device(device).type:
        raise AssertionError(f"proxy endpoint on {ep.device}, not {device}")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    log(f"phase 16: {len(w.relationships)} tuples into ProxyServer({url!r}) "
        f"in {t1 - t0:.3f} s, warm start with prewarm {t2 - t1:.3f} s; "
        f"chain {' > '.join(chain)}; kube {PROXY_NAMESPACES} namespaces, "
        f"{PROXY_PODS} pods, {PROXY_EVENTS} events")

    users = [f"u{i}" for i in range(PROXY_LIST_USERS)]
    subjects = [SubjectRef("user", u) for u in users]
    gets_rng = [(users[int(i)], seeded[int(p)]) for i, p in zip(
        rng.integers(0, len(users), PROXY_GETS),
        rng.integers(0, len(seeded), PROXY_GETS))]

    def phase_sums() -> dict:
        h = REGISTRY.get("authz_request_phase_seconds")
        return {k[0]: v[1] for k, v in h.raw().items()} if h else {}

    async def timed_get(user, target, accept=None):
        client = proxy.get_embedded_client(user=user)
        t = time.perf_counter()
        resp = await client.get(target, headers=[("Accept", accept)]
                                if accept else None)
        return resp, time.perf_counter() - t

    def names_of(resp) -> set:
        if resp.status != 200:
            raise AssertionError(f"list answered {resp.status}: "
                                 f"{resp.body[:300]!r}")
        return {f"{i['metadata']['namespace']}/{i['metadata']['name']}"
                for i in json.loads(resp.body)["items"]}

    out = {}

    def span_s(trace: dict, name: str) -> float:
        return sum(sp["duration_ms"] for sp in trace["spans"]
                   if sp["name"] == name) / 1e3

    def span_start(trace: dict, name: str) -> float:
        return min(sp["start_ms"] for sp in trace["spans"]
                   if sp["name"] == name) / 1e3

    def span_end(trace: dict, name: str) -> float:
        return max(sp["start_ms"] + sp["duration_ms"]
                   for sp in trace["spans"] if sp["name"] == name) / 1e3

    async def traffic():
        # (a) the concurrent lists.  The server records every finished
        # request's trace; a recorder that holds all of them gives each
        # request's upstream time and prefilter wait by its trace id
        sums0 = phase_sums()
        recorder = tracing.RECORDER
        tracing.RECORDER = tracing.SlowTraceRecorder(capacity=2 * len(users))
        try:
            t_a = time.perf_counter()
            res = await asyncio.gather(*(timed_get(u, "/api/v1/pods")
                                         for u in users))
            out["a_wall"] = time.perf_counter() - t_a
            traces = {t["trace_id"]: t for t in tracing.RECORDER.snapshot()}
        finally:
            tracing.RECORDER = recorder
        out["a_lat"] = [s for _, s in res]
        out["a_lists"] = [names_of(r) for r, _ in res]
        sums1 = phase_sums()
        out["a_phases"] = {k: sums1[k] - sums0.get(k, 0.0) for k in sums1}
        a_traces = [traces[r.headers.get(tracing.TRACE_ID_HEADER)]
                    for r, _ in res]
        # the proxy's own time is the request's less its upstream round
        # trip, in which the fake apiserver encodes each list under its
        # lock, one list at a time; the prefilter runs beside the upstream
        out["a_upstream"] = [span_s(t, "upstream") for t in a_traces]
        out["a_own"] = [t["duration_ms"] / 1e3 - u
                        for t, u in zip(a_traces, out["a_upstream"])]
        out["a_wait"] = [span_s(t, "respfilter.wait") for t in a_traces]
        # what the pre-filter timeout measures: how long after a request
        # began to wait its prefilter ended (its resume may then queue
        # behind other requests' filtering on the loop, which the
        # timeout does not count)
        out["a_late"] = [max(0.0, span_end(t, "prefilter")
                             - span_start(t, "respfilter.wait"))
                         for t in a_traces]
        out["a_prefilter"] = [span_s(t, "prefilter") for t in a_traces]
        # (b) the gets: half on pods the user's list holds
        pairs = []
        for k in range(PROXY_GETS):
            i = k % len(users)
            mine = sorted(out["a_lists"][i])
            if k % 2 == 0 and mine:
                pairs.append((users[i], mine[int(rng.integers(len(mine)))]))
            else:
                pairs.append(gets_rng[k])
        out["b_pairs"] = pairs
        out["b_status"], out["b_lat"] = [], []
        for w0 in range(0, len(pairs), 100):
            res = await asyncio.gather(*(
                timed_get(u, "/api/v1/namespaces/{}/pods/{}".format(
                    *p.split("/"))) for u, p in pairs[w0: w0 + 100]))
            out["b_status"] += [r.status for r, _ in res]
            out["b_lat"] += [s for _, s in res]
        # (c) the postfilter list
        resp, out["c_s"] = await timed_get(users[0], "/api/v1/events")
        out["c_names"] = names_of(resp)
        # (d) protobuf and Table lists of the same user
        resp, out["d_proto_s"] = await timed_get(
            users[0], "/api/v1/pods", "application/vnd.kubernetes.protobuf")
        _, kind, raw, _ = k8sproto.decode_unknown(resp.body)
        out["d_proto"] = {"/".join(k8sproto.object_meta(i))
                          for i in k8sproto.iter_list_items(raw)}
        resp, out["d_table_s"] = await timed_get(
            users[0], "/api/v1/pods",
            "application/json;as=Table;v=v1;g=meta.k8s.io")
        out["d_table"] = {"{namespace}/{name}".format(
            **r["object"]["metadata"]) for r in json.loads(resp.body)["rows"]}
        # (e) the watch scenario on one namespace
        out["e"] = await watch_scenario()

    async def watch_scenario() -> list:
        ns = "ns0"
        client = proxy.get_embedded_client(user=users[0])
        resp = await client.get(f"/api/v1/namespaces/{ns}/pods?watch=true")
        if resp.status != 200 or resp.stream is None:
            raise AssertionError(f"watch answered {resp.status}")
        frames: asyncio.Queue = asyncio.Queue()

        async def consume():
            async for frame in resp.stream:
                await frames.put(json.loads(frame))

        task = asyncio.ensure_future(consume())
        key = ("", "v1", "pods")
        seen = []
        try:
            await proxy.endpoint.write_relationships([RelationshipUpdate(
                UpdateOp.TOUCH, parse_relationship(
                    f"pod:{ns}/pwatch#creator@user:{users[0]}"))])
            await asyncio.sleep(0.6)  # let the store watch propagate
            kube.seed("", "v1", "pods", {"metadata": {
                "name": "pwatch", "namespace": ns}})
            await kube._notify(key, "ADDED", kube.objects[key][ns]["pwatch"])
            seen.append((await asyncio.wait_for(frames.get(), 10))
                        ["object"]["metadata"]["name"])
            kube.seed("", "v1", "pods", {"metadata": {
                "name": "phidden", "namespace": ns}})
            await kube._notify(key, "ADDED",
                               kube.objects[key][ns]["phidden"])
            try:
                ev = await asyncio.wait_for(frames.get(), 0.7)
                seen.append(ev["object"]["metadata"]["name"])
            except asyncio.TimeoutError:
                seen.append("buffered")
            await proxy.endpoint.write_relationships([RelationshipUpdate(
                UpdateOp.TOUCH, parse_relationship(
                    f"pod:{ns}/phidden#creator@user:{users[0]}"))])
            seen.append((await asyncio.wait_for(frames.get(), 10))
                        ["object"]["metadata"]["name"])
        finally:
            task.cancel()
        return seen

    rebuild_keys = ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
                    "rebuild_failures")
    rebuilds0 = {k: ep.stats[k] for k in rebuild_keys}
    kernels.reset_launches()
    t3 = time.perf_counter()
    asyncio.run(traffic())
    t4 = time.perf_counter()
    launches = {k: kernels.LAUNCHES[k] for k in REPLACES}
    # a rebuild kicked by the watch scenario's writes would launch kernels
    # of its own in the background: the counts above hold only requests
    ep.wait_rebuilds()
    rebuilds1 = {k: ep.stats[k] for k in rebuild_keys}
    if rebuilds1 != rebuilds0:
        raise AssertionError(f"the traffic rebuilt the graph ({rebuilds0} "
                             f"-> {rebuilds1}): its launches are not all "
                             f"the requests'")
    mem = ((torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated(),
            torch.cuda.memory_reserved()) if on_card else (0, 0, 0))

    # the direct batch beside (a): the same users, the same endpoint
    direct_s = []
    for _ in range(2):
        t = time.perf_counter()
        asyncio.run(proxy.endpoint.lookup_resources_batch(
            "pod", "view", subjects))
        direct_s.append(time.perf_counter() - t)
    bare = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))

    # correctness
    for u, got, ids in zip(users, out["a_lists"], bare):
        want = seeded_set & set(ids)
        if got != want:
            raise AssertionError(f"{u}'s list differs from the endpoint's "
                                 f"lookup ({len(got)} vs {len(want)})")
    oracle = ep._oracle
    t5 = time.perf_counter()
    oracle_users = [int(i) for i in rng.choice(len(users), PROXY_ORACLE_USERS,
                                               replace=False)]
    for i in oracle_users:
        want = _oracle_pods(oracle, seeded, subjects[i])
        if out["a_lists"][i] != want:
            raise AssertionError(f"{users[i]}'s list differs from the "
                                 f"oracle ({len(out['a_lists'][i])} vs "
                                 f"{len(want)})")
    t6 = time.perf_counter()
    for (u, p), status in zip(out["b_pairs"], out["b_status"]):
        ok = oracle.check(ObjectRef("pod", p), "view", SubjectRef("user", u))
        if status != (200 if ok else 403):
            raise AssertionError(f"get of {p} by {u} answered {status}, "
                                 f"oracle {ok}")
    want_events = {f"ns{e % PROXY_NAMESPACES}/ev{e}"
                   for e in range(PROXY_EVENTS)
                   if oracle.check(ObjectRef(
                       "namespace", f"ns{e % PROXY_NAMESPACES}"), "view",
                       subjects[0])}
    if out["c_names"] != want_events:
        raise AssertionError(f"events list {len(out['c_names'])} differs "
                             f"from the oracle's {len(want_events)}")
    if not (out["d_proto"] == out["d_table"] == out["a_lists"][0]):
        raise AssertionError("protobuf / Table lists differ from the JSON "
                             "list")
    if out["e"] != ["pwatch", "buffered", "phidden"]:
        raise AssertionError(f"watch scenario saw {out['e']}")
    stale = ep.stats["stale_routed"]
    if stale:
        raise AssertionError(f"{stale} reads routed to the oracle")
    idle = [k for k in READ_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the proxy's "
                             f"requests: {idle}")
    n_allowed = sum(s == 200 for s in out["b_status"])
    sizes = [len(x) for x in out["a_lists"]]
    log(f"phase 16 (a) {len(users)} concurrent lists: wall "
        f"{out['a_wall']:.4f} s; per request {_pcts(out['a_lat'])}, max "
        f"{max(out['a_lat']) * 1e3:.3f} ms; items per list min "
        f"{min(sizes)} median {int(np.median(sizes))} max {max(sizes)} "
        f"({smi_line})")
    late_max = max(out["a_late"])
    log(f"phase 16 (a) per request, the proxy's own time (request less "
        f"upstream): {_pcts(out['a_own'])}, max "
        f"{max(out['a_own']) * 1e3:.3f} ms; upstream (the fake apiserver): "
        f"{_pcts(out['a_upstream'])}, max "
        f"{max(out['a_upstream']) * 1e3:.3f} ms; prefilter "
        f"{_pcts(out['a_prefilter'])}, max "
        f"{max(out['a_prefilter']) * 1e3:.3f} ms; respfilter.wait "
        f"{_pcts(out['a_wait'])}, max {max(out['a_wait']) * 1e3:.3f} ms; "
        f"latest prefilter end after its wait began "
        f"{late_max * 1e3:.3f} ms, {PREFILTER_TIMEOUT - late_max:.3f} s "
        f"under the {PREFILTER_TIMEOUT:.0f} s pre-filter timeout "
        f"({smi_line})")
    log(f"phase 16 (a) direct {len(users)}-lane lookup_resources_batch on "
        f"the same endpoint: {', '.join(f'{s:.4f}' for s in direct_s)} s; proxy "
        f"phase seconds summed over the burst: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            out["a_phases"].items())))
    log(f"phase 16 (b) {len(out['b_status'])} gets ({n_allowed} allowed) in "
        f"waves of 100: {_pcts(out['b_lat'])}; (c) events list "
        f"{out['c_s'] * 1e3:.3f} ms ({len(out['c_names'])} of "
        f"{PROXY_EVENTS} kept); (d) protobuf {out['d_proto_s'] * 1e3:.3f} "
        f"ms, Table {out['d_table_s'] * 1e3:.3f} ms, "
        f"{len(out['d_proto'])} items each; (e) watch {out['e']}")
    log(f"phase 16 launches by the proxy's requests: "
        f"{ {k: v for k, v in launches.items() if v} }; stale_routed "
        f"{stale}; card memory allocated {mem[0] / 2**20:.1f} MiB, peak "
        f"{mem[1] / 2**20:.1f} MiB, reserved {mem[2] / 2**20:.1f} MiB; "
        f"traffic {t4 - t3:.1f} s; oracle on {PROXY_ORACLE_USERS} users "
        f"{t6 - t5:.1f} s")
    # the watch scenario gave users[0] its two new pods
    socket = _proxy_socket(proxy, users[0], out["a_lists"][0]
                           | {"ns0/pwatch", "ns0/phidden"})
    log(f"phase 16 loopback: {socket}")
    log(f"phase 16 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "proxy": proxy, "kube": kube, "ep": ep,
            "users": users, "a_wall": out["a_wall"],
            "oracle_users": oracle_users}


def _proxy_socket(proxy, user: str, want: set) -> str:
    """One (a)-style list over a loopback socket (`start(port=0)` and
    `H11Transport`), when h11 is importable."""
    try:
        import h11  # noqa: F401
    except ImportError:
        return "skipped (h11 is not installed)"
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, Headers, Request)

    async def go():
        port = await proxy.start(port=0)
        try:
            t = time.perf_counter()
            resp = await H11Transport(f"http://127.0.0.1:{port}").round_trip(
                Request("GET", "/api/v1/pods", headers=Headers([
                    ("X-Remote-User", user), ("Accept", "application/json")])))
            return resp, time.perf_counter() - t
        finally:
            await proxy.stop()

    resp, secs = asyncio.run(go())
    got = {f"{i['metadata']['namespace']}/{i['metadata']['name']}"
           for i in json.loads(resp.body)["items"]}
    if resp.status != 200 or got != want:
        raise AssertionError(f"loopback list answered {resp.status} with "
                             f"{len(got)} items, want {len(want)}")
    return f"list of {len(got)} items in {secs * 1e3:.3f} ms"


# -- phase 17, dual writes and the command line -------------------------------


def dualwrite_path(p16: dict, smi_line: str, device: str = "cuda") -> dict:
    """Phase 17 (a): dual writes on phase 16's `ProxyServer` (its
    multitenant-1m endpoint and fake kube-apiserver), after
    `enable_dual_writes()` with a SQLite journal in a temporary directory
    (what `--workflow-database-path` gives) and DUALWRITE_RULES beside the
    read rules.  The workflow worker runs, as `ProxyServer.start()` (the
    served process) starts it, so the instances run one after another as
    they do there.  The embedded client drives: (1) one pod create a list
    user of phase 16,
    all at once, each in a namespace the user may view (the endpoint's
    lookup, confirmed by the oracle); (2) each user's list of that
    namespace, which must show the new pod (read after write); (3)
    DUALWRITE_PAIRS pairs of concurrent creates of one name by two users
    of its namespace: one 201 and one 409 a pair; (4) one create with
    `panicKubeWrite` armed once, which converges as in
    tests/test_dualwrite.py TestCrashMatrix; (5) every new pod deleted
    (the first-burst ones all at once), and the lists without them.
    Held: the store's new `creator` tuples equal the fake's new pods and
    the set asked for, and after the deletes none is left; the journal
    has no pending instance; a fixed-seed sample of (user, new pod)
    checks equals the oracle's; `scatter_rows` and every READ_KERNELS
    kernel launched in the proxy's traffic (counted from zero, the
    oracle sample's launches taken out).  Logged: each
    burst's wall and per-request p50/p99/max, the read-after-write
    lists', the deltas of the endpoint's rebuild, spare-row, quarantine
    and write-path counters, the lock/workflow/activity tuples left, and
    the card's memory."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.rules.engine import MapMatcher
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipFilter, SubjectRef)
    from spicedb_kubeapi_proxy_tpu_torch.utils import failpoints

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    proxy, kube, ep, users = (p16["proxy"], p16["kube"], p16["ep"],
                              p16["users"])
    rng = np.random.default_rng(SEED + 17)
    tmp = tempfile.mkdtemp(prefix="smoke-dualwrite-")
    try:
        proxy.opts.workflow_database_path = os.path.join(tmp, "wf.db")
        proxy.enable_dual_writes()
        journal = proxy.workflow_client.journal
        proxy.matcher = MapMatcher([proxyrule.parse_doc(d) for d in
                                    PROXY_READ_RULES + DUALWRITE_RULES])
        oracle = ep._oracle
        subjects = [SubjectRef("user", u) for u in users]
        ns_lists = asyncio.run(ep.lookup_resources_batch(
            "namespace", "view", subjects))
        home = []
        for u, s, ids in zip(users, subjects, ns_lists):
            if not ids:
                raise AssertionError(f"{u} may view no namespace")
            ns = sorted(ids)[int(rng.integers(len(ids)))]
            if not oracle.check(ObjectRef("namespace", ns), "view", s):
                raise AssertionError(f"the oracle refuses {u} on {ns}")
            home.append(ns)
        by_ns: dict = {}
        for u, ids in zip(users, ns_lists):
            for ns in ids:
                by_ns.setdefault(ns, []).append(u)
        shared = sorted(ns for ns, us in by_ns.items() if len(us) >= 2)
        if len(shared) < DUALWRITE_PAIRS:
            raise AssertionError(f"{len(shared)} namespaces with two list "
                                 f"users, {DUALWRITE_PAIRS} needed")
        pairs = [(shared[int(i)], by_ns[shared[int(i)]][:2]) for i in
                 rng.choice(len(shared), DUALWRITE_PAIRS, replace=False)]
        stat_keys = ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
                     "spare_assignments", "spare_reclaims", "stale_routed",
                     "delta_batches", "delta_apply_s", "flush_s")
        stats0 = {k: ep.stats[k] for k in stat_keys}

        def pods_path(ns, name=""):
            return f"/api/v1/namespaces/{ns}/pods" + (f"/{name}" if name
                                                      else "")

        async def timed(user, method, target, obj=None):
            client = proxy.get_embedded_client(user=user)
            body = json.dumps(obj).encode() if obj is not None else b""
            t = time.perf_counter()
            resp = await client.request(method, target, body=body)
            return resp, time.perf_counter() - t

        def pod_obj(ns, name):
            return {"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": name, "namespace": ns}}

        def listed(resp) -> set:
            if resp.status != 200:
                raise AssertionError(f"list answered {resp.status}: "
                                     f"{resp.body[:300]!r}")
            return {i["metadata"]["name"]
                    for i in json.loads(resp.body)["items"]}

        out: dict = {}

        async def burst(key, calls):
            t = time.perf_counter()
            res = await asyncio.gather(*calls)
            out[key + "_wall"] = time.perf_counter() - t
            out[key + "_lat"] = [s for _, s in res]
            return [r for r, _ in res]

        async def traffic():
            created = {}
            # (1) one create a user, all at once
            res = await burst("create", [
                timed(u, "POST", pods_path(ns), pod_obj(ns, f"dw-{i}"))
                for i, (u, ns) in enumerate(zip(users, home))])
            bad = [(u, r.status, r.body[:200]) for u, r in zip(users, res)
                   if r.status != 201]
            if bad:
                raise AssertionError(f"{len(bad)} creates failed: {bad[:3]}")
            for i, (u, ns) in enumerate(zip(users, home)):
                created[f"{ns}/dw-{i}"] = u
            # (2) read after write: each user's list of its namespace
            res = await burst("raw", [timed(u, "GET", pods_path(ns))
                                      for u, ns in zip(users, home)])
            missing = [f"{ns}/dw-{i}" for i, (ns, r) in
                       enumerate(zip(home, res)) if f"dw-{i}" not in
                       listed(r)]
            if missing:
                raise AssertionError(f"{len(missing)} lists miss their "
                                     f"user's new pod: {missing[:3]}")
            # (3) racing creates of one name
            calls = []
            for k, (ns, (a, b)) in enumerate(pairs):
                for u in (a, b):
                    calls.append(timed(u, "POST", pods_path(ns),
                                       pod_obj(ns, f"dup-{k}")))
            res = await burst("pairs", calls)
            out["pair_status"] = []
            for k, (ns, (a, b)) in enumerate(pairs):
                ra, rb = res[2 * k], res[2 * k + 1]
                st = sorted([ra.status, rb.status])
                out["pair_status"].append(st)
                if st != [201, 409]:
                    raise AssertionError(f"pair {k} on {ns} answered {st}: "
                                         f"{ra.body[:200]!r} "
                                         f"{rb.body[:200]!r}")
                created[f"{ns}/dup-{k}"] = a if ra.status == 201 else b
            # (4) one create through a crash before the kube write
            failpoints.enable_failpoint("panicKubeWrite", 1)
            try:
                resp, out["crash_s"] = await timed(
                    users[0], "POST", pods_path(home[0]),
                    pod_obj(home[0], "crash-0"))
            finally:
                failpoints.disable_all()
            out["crash_status"] = resp.status
            if resp.status not in (201, 409):
                raise AssertionError(f"the crashed create answered "
                                     f"{resp.status}: {resp.body[:300]!r}")
            created[f"{home[0]}/crash-0"] = users[0]
            return created

        async def teardown(created):
            first = [(created[f"{ns}/dw-{i}"], ns, f"dw-{i}")
                     for i, ns in enumerate(home)]
            res = await burst("delete", [timed(u, "DELETE",
                                               pods_path(ns, name))
                                         for u, ns, name in first])
            rest = [(u, *nn.split("/")) for nn, u in created.items()
                    if "/dw-" not in nn]
            for u, ns, name in rest:
                r, _ = await timed(u, "DELETE", pods_path(ns, name))
                res.append(r)
            bad = [(n, r.status, r.body[:200]) for n, r in
                   zip(list(created), res) if r.status != 200]
            if bad:
                raise AssertionError(f"{len(bad)} deletes failed: "
                                     f"{bad[:3]}")
            res = await burst("gone", [timed(u, "GET", pods_path(ns))
                                       for u, ns in zip(users, home)])
            stale = [f"{ns}/dw-{i}" for i, (ns, r) in
                     enumerate(zip(home, res)) if f"dw-{i}" in listed(r)]
            if stale:
                raise AssertionError(f"{len(stale)} lists still show a "
                                     f"deleted pod: {stale[:3]}")

        def new_creators() -> dict:
            rels = ep.store.read(RelationshipFilter(resource_type="pod",
                                                    relation="creator"))
            return {r.resource.id: r.subject.id for r in rels
                    if r.resource.id.split("/")[-1].startswith(
                        ("dw-", "dup-", "crash-"))}

        def new_kube_pods() -> set:
            pods = kube.objects.get(("", "v1", "pods"), {})
            return {f"{ns}/{name}" for ns, by_name in pods.items()
                    for name in by_name if name.startswith(
                        ("dw-", "dup-", "crash-"))}

        def internal_tuples() -> dict:
            return {t: len(ep.store.read(RelationshipFilter(
                resource_type=t))) for t in ("lock", "workflow",
                                             "activity")}

        def sample_requests(created) -> list:
            # a fixed-seed sample of (user, new pod) checks
            new_pods = sorted(created)
            reqs = []
            for k in range(DUALWRITE_ORACLE):
                p = new_pods[int(rng.integers(len(new_pods)))]
                u = created[p] if k % 2 == 0 else users[int(rng.integers(
                    len(users)))]
                reqs.append(CheckRequest(ObjectRef("pod", p), "view",
                                         SubjectRef("user", u)))
            return reqs

        marks: dict = {}

        async def run():
            await proxy._worker.start()
            try:
                marks["t0"] = time.perf_counter()
                created = await traffic()
                marks["t1"] = time.perf_counter()
                marks["traffic"] = dict(kernels.LAUNCHES)
                creators = new_creators()
                if creators != created:
                    diff = sorted(set(creators.items())
                                  ^ set(created.items()))
                    raise AssertionError(
                        f"the store's new creator tuples ({len(creators)}) "
                        f"differ from the creates asked for "
                        f"({len(created)}): {diff[:4]}")
                if new_kube_pods() != set(created):
                    raise AssertionError("the fake's new pods differ from "
                                         "the creates asked for")
                reqs = sample_requests(created)
                got = await ep.check_bulk_permissions(reqs)
                want = [oracle.check(r.resource, r.permission, r.subject)
                        for r in reqs]
                if [g.allowed for g in got] != want:
                    raise AssertionError("a (user, new pod) check differs "
                                         "from the oracle")
                marks["internal"] = internal_tuples()
                marks["sampled"] = dict(kernels.LAUNCHES)
                marks["t2"] = time.perf_counter()
                await teardown(created)
                marks["t3"] = time.perf_counter()
                marks["teardown"] = dict(kernels.LAUNCHES)
            finally:
                await proxy._worker.stop()

        kernels.reset_launches()
        # the fake's lock binds to the loop of its first contention
        # (phase 16's bursts); this asyncio.run is a loop of its own
        kube._lock = asyncio.Lock()
        asyncio.run(run())
        t0, t1, t2, t3 = (marks[k] for k in ("t0", "t1", "t2", "t3"))
        internal = marks["internal"]
        # the proxy's traffic only: the creates and the deletes, without
        # the oracle sample between them
        launches = {k: marks["traffic"].get(k, 0)
                    + marks["teardown"].get(k, 0) - marks["sampled"].get(k, 0)
                    for k in REPLACES}
        left = new_creators()
        if left or new_kube_pods():
            raise AssertionError(f"{len(left)} creator tuples and "
                                 f"{len(new_kube_pods())} pods left after "
                                 f"the deletes")
        pending = journal.pending_instances()
        if pending:
            raise AssertionError(f"{len(pending)} journal instances pending")
        idle = [k for k in READ_KERNELS + ("scatter_rows",)
                if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels never launched in phase 17 (a): "
                                 f"{idle}")
        ep.wait_rebuilds()
        stats1 = {k: ep.stats[k] for k in stat_keys}
        internal_end = internal_tuples()
        mem = ((torch.cuda.memory_allocated(),
                torch.cuda.max_memory_allocated(),
                torch.cuda.memory_reserved()) if on_card else (0, 0, 0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def lat(key):
        xs = out[key + "_lat"]
        return f"{_pcts(xs)}, max {max(xs) * 1e3:.3f} ms"
    log(f"phase 17 (a) {len(users)} concurrent creates, the worker running "
        f"the instances one after another: wall "
        f"{out['create_wall']:.4f} s; per request {lat('create')} "
        f"({smi_line})")
    log(f"phase 17 (a) read after write, {len(users)} concurrent namespace "
        f"lists: wall {out['raw_wall']:.4f} s; per request {lat('raw')}, "
        f"every new pod listed ({smi_line})")
    log(f"phase 17 (a) {DUALWRITE_PAIRS} racing pairs: wall "
        f"{out['pairs_wall']:.4f} s; statuses {out['pair_status']}; "
        f"per request {lat('pairs')}; crashed create "
        f"{out['crash_status']} in {out['crash_s'] * 1e3:.3f} ms")
    log(f"phase 17 (a) {len(users)} concurrent deletes: wall "
        f"{out['delete_wall']:.4f} s; per request {lat('delete')}; lists "
        f"after them: wall {out['gone_wall']:.4f} s, {lat('gone')} "
        f"({smi_line})")
    deltas = {k: (round(stats1[k] - stats0[k], 6)
                  if isinstance(stats1[k], float) else stats1[k] - stats0[k])
              for k in stat_keys}
    log(f"phase 17 (a) endpoint counters over the phase: {deltas}; "
        f"lock/workflow/activity tuples after the creates {internal}, "
        f"after the deletes {internal_end}; journal {journal.path}")
    log(f"phase 17 (a) launches: "
        f"{ {k: v for k, v in launches.items() if v} }; card memory "
        f"allocated {mem[0] / 2**20:.1f} MiB, peak {mem[1] / 2**20:.1f} "
        f"MiB, reserved {mem[2] / 2**20:.1f} MiB; creates and lists "
        f"{t1 - t0:.1f} s, oracle sample and counts {t2 - t1:.1f} s, "
        f"deletes {t3 - t2:.1f} s")
    log(f"phase 17 (a) wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_process(smi_line: str, device: str = "cuda") -> None:
    """Phase 17 (b): `python3 -m spicedb_kubeapi_proxy_tpu_torch` as a
    process, with no `--spicedb-endpoint` on the card (the default
    `torch://` is what runs; `torch://?device=cpu` for a CPU rehearsal),
    in front of the port's fake kube-apiserver served on a loopback
    socket and reached through a kubeconfig, with deploy/rules.yaml,
    deploy/bootstrap.yaml and a SQLite journal.  Over loopback with X-Remote-User headers: /readyz;
    ada lists acme-prod's pods, creates one through pod-launch (201) that
    the list then shows, deletes it through pod-retire, and it is gone;
    mallory's list lacks api-1.  SIGTERM must end the process with 0
    within CLI_STOP_S, no traceback on its stderr, and its serving line
    must name the card.  Then `entry.entry()` once on the card, equal to
    its `fn` on the CPU."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch import entry
    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, Headers, HttpServer, Request)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    deploy = os.path.join(root, "deploy")
    tmp = tempfile.mkdtemp(prefix="smoke-cli-")
    try:
        rules = os.path.join(deploy, "rules.yaml")
        boot = os.path.join(deploy, "bootstrap.yaml")
        want_device = (torch.cuda.get_device_name(0) if device == "cuda"
                       else "cpu")

        async def go():
            kube = FakeKubeApiServer()
            for ns in ("acme-prod", "initech-dev"):
                kube.seed("", "v1", "namespaces", {"metadata": {"name": ns}})
            for ns, name in (("acme-prod", "api-0"), ("acme-prod", "api-1"),
                             ("initech-dev", "tps-report")):
                kube.seed("", "v1", "pods", {"metadata": {
                    "name": name, "namespace": ns}})
            upstream = HttpServer(kube)
            kport = await upstream.start("127.0.0.1", 0)
            kubeconfig = os.path.join(tmp, "kubeconfig")
            with open(kubeconfig, "w") as f:
                json.dump({"current-context": "smoke",
                           "contexts": [{"name": "smoke", "context": {
                               "cluster": "fake"}}],
                           "clusters": [{"name": "fake", "cluster": {
                               "server": f"http://127.0.0.1:{kport}"}}]}, f)
            port = _free_port()
            argv = [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch",
                    "--embedded-mode", "--bind-address", "127.0.0.1",
                    "--secure-port", str(port), "--backend-kubeconfig",
                    kubeconfig, "--no-override-upstream", "--rule-config",
                    rules, "--spicedb-bootstrap", boot,
                    "--workflow-database-path", os.path.join(tmp, "wf.db"),
                    "-v", "2"]
            if device != "cuda":
                argv += ["--spicedb-endpoint", f"torch://?device={device}"]
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("KUBERNETES_SERVICE")}
            env["PYTHONPATH"] = root
            t_start = time.perf_counter()
            proc = await asyncio.create_subprocess_exec(
                *argv, cwd=root, env=env, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            client = H11Transport(f"http://127.0.0.1:{port}")

            async def call(method, target, user="ada", obj=None):
                h = Headers([("X-Remote-User", user),
                             ("Accept", "application/json")])
                body = b""
                if obj is not None:
                    body = json.dumps(obj).encode()
                    h.set("Content-Type", "application/json")
                t = time.perf_counter()
                resp = await client.round_trip(Request(method, target,
                                                       headers=h, body=body))
                return resp, time.perf_counter() - t

            def names(resp) -> list:
                if resp.status != 200:
                    raise AssertionError(f"list answered {resp.status}: "
                                         f"{resp.body[:300]!r}")
                return sorted(i["metadata"]["name"]
                              for i in json.loads(resp.body)["items"])

            pods = "/api/v1/namespaces/acme-prod/pods"
            seen, secs = {}, {}
            stderr = b""
            try:
                while True:
                    if proc.returncode is not None:
                        raise AssertionError(
                            f"the command exited {proc.returncode} before "
                            f"it served")
                    if time.perf_counter() - t_start > CLI_READY_S:
                        raise AssertionError("the command never answered "
                                             "/readyz")
                    try:
                        if (await call("GET", "/readyz"))[0].status == 200:
                            break
                    except OSError:
                        pass
                    await asyncio.sleep(0.25)
                secs["ready"] = time.perf_counter() - t_start
                steps = [
                    ("list", "GET", pods, "ada", None),
                    ("create", "POST", pods, "ada", {
                        "apiVersion": "v1", "kind": "Pod", "metadata": {
                            "name": "api-9", "namespace": "acme-prod"}}),
                    ("after_create", "GET", pods, "ada", None),
                    ("delete", "DELETE", f"{pods}/api-9", "ada", None),
                    ("after_delete", "GET", pods, "ada", None),
                    ("mallory", "GET", pods, "mallory", None)]
                for key, method, target, user, obj in steps:
                    resp, secs[key] = await call(method, target, user, obj)
                    seen[key] = (names(resp) if method == "GET"
                                 else resp.status)
            finally:
                if proc.returncode is None:
                    proc.send_signal(signal.SIGTERM)
                t_stop = time.perf_counter()
                try:
                    _, stderr = await asyncio.wait_for(proc.communicate(),
                                                       CLI_STOP_S)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
                    raise AssertionError(f"the command outlived SIGTERM by "
                                         f"{CLI_STOP_S} s") from None
                secs["stop"] = time.perf_counter() - t_stop
                await upstream.stop()
            return seen, secs, proc.returncode, stderr.decode()

        seen, secs, rc, stderr = asyncio.run(go())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = {"list": ["api-0", "api-1"], "create": 201,
            "after_create": ["api-0", "api-1", "api-9"], "delete": 200,
            "after_delete": ["api-0", "api-1"], "mallory": ["api-0"]}
    serving = [ln for ln in stderr.splitlines() if "serving on" in ln]
    if seen != want:
        raise AssertionError(f"the command answered {seen}; stderr tail "
                             f"{stderr[-2000:]}")
    if rc != 0 or "Traceback" in stderr:
        raise AssertionError(f"the command exited {rc}; stderr tail "
                             f"{stderr[-2000:]}")
    if not serving or not serving[0].endswith(f" on {want_device}"):
        raise AssertionError(f"serving line {serving} does not name "
                             f"{want_device}")
    log(f"phase 17 (b) {serving[0].split(': ', 1)[-1]}")
    log(f"phase 17 (b) python -m spicedb_kubeapi_proxy_tpu_torch: ready in "
        f"{secs['ready']:.2f} s; list {secs['list'] * 1e3:.3f} ms, create "
        f"{secs['create'] * 1e3:.3f} ms, list {secs['after_create'] * 1e3:.3f}"
        f" ms, delete {secs['delete'] * 1e3:.3f} ms, list "
        f"{secs['after_delete'] * 1e3:.3f} ms, mallory "
        f"{secs['mallory'] * 1e3:.3f} ms; SIGTERM to exit 0 in "
        f"{secs['stop']:.2f} s ({smi_line})")
    t0 = time.perf_counter()
    fn, args = entry.entry(device=None if device == "cuda" else device)
    got = fn(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu_fn, cpu_args = entry.entry(device="cpu")
    want_out = cpu_fn(*cpu_args).numpy()
    if not np.array_equal(got.cpu().numpy(), want_out):
        raise AssertionError("entry() on the card differs from the CPU")
    log(f"phase 17 (b) entry(): {tuple(got.shape)} {got.dtype} on "
        f"{got.device} in {(t1 - t0) * 1e3:.1f} ms, equal to the CPU's "
        f"({int(want_out.sum())} allowed bits)")
    log(f"phase 17 (b) wall time {time.perf_counter() - t_phase:.1f} s")


# -- phase 18, the decision cache and device telemetry -------------------------


def _list_burst(proxy, kube, users: list) -> tuple:
    """One concurrent `GET /api/v1/pods` per user through `proxy`'s
    embedded client, on a fresh event loop: (wall seconds, per-request
    proxy's own time — request less upstream —, each user's pod set)."""
    from spicedb_kubeapi_proxy_tpu_torch.utils import tracing

    async def one(user):
        resp = await proxy.get_embedded_client(user=user).get("/api/v1/pods")
        if resp.status != 200:
            raise AssertionError(f"{user}'s list answered {resp.status}: "
                                 f"{resp.body[:300]!r}")
        return resp

    async def go():
        # the fake's lock binds to the loop of its first contended use
        kube._lock = asyncio.Lock()
        recorder = tracing.RECORDER
        tracing.RECORDER = tracing.SlowTraceRecorder(capacity=2 * len(users))
        try:
            t = time.perf_counter()
            res = await asyncio.gather(*(one(u) for u in users))
            wall = time.perf_counter() - t
            traces = {tr["trace_id"]: tr
                      for tr in tracing.RECORDER.snapshot()}
        finally:
            tracing.RECORDER = recorder
        own = []
        for r in res:
            tr = traces[r.headers.get(tracing.TRACE_ID_HEADER)]
            up = sum(sp["duration_ms"] for sp in tr["spans"]
                     if sp["name"] == "upstream") / 1e3
            own.append(tr["duration_ms"] / 1e3 - up)
        lists = [{f"{i['metadata']['namespace']}/{i['metadata']['name']}"
                  for i in json.loads(r.body)["items"]} for r in res]
        return wall, own, lists

    return asyncio.run(go())


class _OwnGraphMarks:
    """The smoke's own timing events inside every CUDA graph captured while
    it is installed (`kernels.LaunchGraph`), read after each replay that
    the endpoint reports complete (`kernels.note_replay`, right after the
    sweep's readback) while `on` is set: the device seconds of each seed
    and sweep replayed, from events the endpoint's window never sees.
    Each of the pair is recorded one node after the graph's own mark (its
    start after the graph's start, its end after the graph's end), so
    each pair spans one node of the other: an event node costs the card
    microseconds, and nested pairs would put two of them in the outer
    one.  `uninstall()` restores both functions."""

    def __init__(self):
        import torch

        from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
        self.kernels = kernels
        self.on = False
        self.spans: list = []
        self._capture = capture = kernels.LaunchGraph.capture
        self._note = note = kernels.note_replay

        def own_capture(graph, fn):
            marks = tuple(torch.cuda.Event(enable_timing=True, external=True)
                          for _ in range(2))
            for ev in marks:
                ev.record()

            def marked():
                marks[0].record()
                return fn()

            cg = graph.graph

            def end():
                marks[1].record()
                type(cg).capture_end(cg)

            cg.capture_end = end
            try:
                out = capture(graph, marked)
            finally:
                del cg.capture_end
            graph.smoke_marks = marks
            return out

        def own_note(graph):
            note(graph)
            marks = getattr(graph, "smoke_marks", None)
            if self.on and marks is not None:
                self.spans.append(marks[0].elapsed_time(marks[1]) / 1e3)

        kernels.LaunchGraph.capture = own_capture
        kernels.note_replay = own_note

    def uninstall(self) -> None:
        self.kernels.LaunchGraph.capture = self._capture
        self.kernels.note_replay = self._note


def cache_telemetry_path(p16: dict, w, smi_line: str,
                         device: str = "cuda") -> dict:
    """Phase 18: the decision cache and device telemetry on phase 16's
    store and fake apiserver (see the module docstring)."""
    t_phase = time.perf_counter()
    on_card = device == "cuda"
    _switch(True)
    kube, users = p16["kube"], p16["users"]
    p16["ep"].wait_rebuilds()
    # (d)'s own events go into the graphs that this phase's endpoint
    # captures from here on
    marks = _OwnGraphMarks() if on_card else None
    try:
        return _cache_telemetry(p16, w, smi_line, device, t_phase, kube,
                                users, marks)
    finally:
        if marks is not None:
            marks.uninstall()


def _cache_telemetry(p16: dict, w, smi_line: str, device: str,
                     t_phase: float, kube, users: list, marks) -> dict:
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.decision_cache import (
        DecisionCacheEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, Permissionship, Relationship,
        RelationshipUpdate, SubjectRef, UpdateOp)
    from spicedb_kubeapi_proxy_tpu_torch.utils import (
        devtel, features, timeline, workload)
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY

    on_card = device == "cuda"
    rules = [proxyrule.parse_doc(d) for d in PROXY_READ_RULES]
    url = ("torch://?cache=1" if on_card
           else f"torch://?device={device}&cache=1")
    t0 = time.perf_counter()
    # the card's rate is detected from its name; the CPU rehearsal names
    # the H100's so that (e) has a denominator
    proxy = ProxyServer(Options(
        spicedb_endpoint=url, rule_configs=rules,
        bootstrap=Bootstrap(w.schema_text, ""),
        upstream_transport=HandlerTransport(kube), prewarm_compiles=True,
        endpoint_kwargs={"store": p16["ep"].store},
        device_hbm_peak_gbps=0.0 if on_card else 3350.0))
    asyncio.run(proxy.warm_start())
    t1 = time.perf_counter()
    chain, ep, cached = [], proxy.endpoint, None
    while ep is not None:
        chain.append(type(ep).__name__)
        if isinstance(ep, DecisionCacheEndpoint):
            cached = ep
        if isinstance(ep, TorchEndpoint):
            break
        ep = getattr(ep, "inner", None)
    if chain != ["InstrumentedEndpoint", "DecisionCacheEndpoint",
                 "BatchingEndpoint", "TorchEndpoint"]:
        raise AssertionError(f"phase 18 endpoint chain {chain}")
    cache = cached.cache
    log(f"phase 18: ProxyServer({url!r}) over phase 16's store "
        f"(revision {ep.store.revision}) warm-started with prewarm in "
        f"{t1 - t0:.3f} s; chain {' > '.join(chain)}")

    pods_key = ("", "v1", "pods")
    pods = [f"{ns}/{name}" for ns, objs in kube.objects[pods_key].items()
            for name in objs]
    oracle = ep._oracle
    sample = [users[i] for i in p16["oracle_users"]]
    want = {u: _oracle_pods(oracle, pods, SubjectRef("user", u))
            for u in sample}

    def counts() -> dict:
        return dict(cache.stats)

    def delta(a: dict, b: dict) -> dict:
        return {k: b[k] - a[k] for k in a}

    h = REGISTRY.get("authz_kernel_time_seconds")

    def device_s() -> float:
        return sum(v[1] for k, v in h.raw().items()
                   if k[0] == "kernel.device")

    # (a) cold, with (d)'s own events in the graphs of the same batches
    g = ep.graph()
    workload.WORKLOAD.reset()
    gs0 = dict(g.kernel.graph_stats)
    c0, k0, since = counts(), device_s(), timeline.now()
    kernels.reset_launches()
    if marks is not None:
        marks.on = True
    try:
        t_host = time.perf_counter()
        wall1, own1, lists1 = _list_burst(proxy, kube, users)
    finally:
        if marks is not None:
            marks.on = False
    k1, c1 = device_s(), counts()
    t_host = time.perf_counter() - t_host
    graph_d = {k: g.kernel.graph_stats[k] - gs0[k]
               for k in ("replays", "seed_replays", "eager_sweeps")}
    launches1 = {k: kernels.LAUNCHES[k] for k in REPLACES}
    cold = delta(c0, c1)
    if cold["misses"] != len(users) or cold["hits"]:
        raise AssertionError(f"cold burst cache counts {cold}")
    idle = [k for k in ("ell_gather_or", "perm_program", "sweep_delta_checks",
                        "seed_bitplanes", "lookup_T") if not launches1[k]]
    if idle:
        raise AssertionError(f"cold burst launched no {idle}")
    # warm
    kernels.reset_launches()
    wall2, own2, lists2 = _list_burst(proxy, kube, users)
    c2 = counts()
    launches2 = {k: v for k, v in kernels.LAUNCHES.items() if v}
    warm = delta(c1, c2)
    if warm["hits"] != len(users) or warm["misses"]:
        raise AssertionError(f"warm burst cache counts {warm}")
    if launches2:
        raise AssertionError(f"the warm burst launched kernels: {launches2}")
    if lists1 != lists2:
        raise AssertionError("the warm burst's lists differ from the cold's")
    for u in sample:
        got = lists1[users.index(u)]
        if got != want[u]:
            raise AssertionError(f"{u}'s list differs from the oracle "
                                 f"({len(got)} vs {len(want[u])})")
    log(f"phase 18 (a) {len(users)} concurrent lists, cold: wall "
        f"{wall1:.4f} s, own time {_pcts(own1)}; warm: wall {wall2:.4f} s, "
        f"own time {_pcts(own2)}; cache hits/misses cold {cold['hits']}/"
        f"{cold['misses']}, warm {warm['hits']}/{warm['misses']}; "
        f"{len(cache)} entries, {cache.resident_bytes} bytes; cold "
        f"launches { {k: v for k, v in launches1.items() if v} }, warm "
        f"none ({smi_line})")

    # (d) kernel accounting and sweeps: the burst's kernel.device seconds
    # against the smoke's own events in the seed and sweep graphs its
    # batches replayed (a batch launched outside its graphs would be in
    # the first and not in the second)
    acc_s = k1 - k0
    if on_card:
        own_s = sum(marks.spans)
        if (not own_s or graph_d["eager_sweeps"]
                or abs(acc_s - own_s) > KERNEL_TIME_TOL * own_s):
            raise AssertionError(
                f"kernel.device {acc_s:.6f} s against the smoke's own "
                f"{own_s:.6f} s over {len(marks.spans)} replays of the "
                f"cold burst (graph stats {graph_d})")
    else:
        own_s = acc_s
    rows = {(r["resource_type"], r["permission"]): r
            for r in workload.WORKLOAD.payload()["rows"]}
    depth = rows[("pod", "view")]["mean_sweep_depth"]
    trace_iters = int(g.last_trace[0])
    if depth != trace_iters:
        raise AssertionError(f"workload sweep depth {depth} against the "
                             f"trace's {trace_iters}")
    log(f"phase 18 (d) kernel.device over the cold burst {acc_s:.6f} s, "
        f"the smoke's own in-graph events {own_s:.6f} s "
        f"({(acc_s / own_s - 1) * 100 if own_s else 0.0:+.3f} %) over "
        f"{len(marks.spans) if marks else 0} replays (graph stats "
        f"{graph_d}); the burst's host wall {t_host:.4f} s; pod#view "
        f"measured sweep depth {depth}, trace "
        f"{g.last_trace[: 1 + trace_iters].tolist()} ({smi_line})")

    # (e) the timeline over the cold burst
    summ = timeline.summary(since=since)
    roof = summ["roofline_fraction"]
    if summ["hbm_peak_gbps"] != 3350.0 or roof is None or not 0 < roof <= 1:
        raise AssertionError(f"roofline {roof} against "
                             f"{summ['hbm_peak_gbps']} GB/s")
    trace = timeline.chrome_trace(since=since)
    dev_slices = [e for e in trace["traceEvents"]
                  if e.get("tid") == 3 and e["ph"] == "X"]
    if not dev_slices:
        raise AssertionError("no device-track slice in the chrome trace")
    log(f"phase 18 (e) timeline over the cold burst: roofline fraction "
        f"{roof} of {summ['hbm_peak_gbps']} GB/s ({summ['kernel_bytes_basis']}"
        f" bytes), {len(dev_slices)} device-track slices, stages ms "
        f"{summ['stage_ms']}, overlap {summ['overlap_ratio']}")

    # (b) invalidation: an expiring internal tuple, then a grant
    wf = Relationship(resource=ObjectRef("workflow", "smoke18"),
                      relation="idempotency_key",
                      subject=SubjectRef("activity", "a18"),
                      expires_at=time.time() + CACHE_EXPIRY_S)
    asyncio.run(proxy.endpoint.write_relationships(
        [RelationshipUpdate(UpdateOp.TOUCH, wf)]))
    still = sum(cache.contains_valid(("lr", "pod", "view",
                                      SubjectRef("user", u))) for u in users)
    if still != len(users):
        raise AssertionError(f"a workflow: write left {still} of "
                             f"{len(users)} list entries valid")
    c3 = counts()
    again = _list_burst(proxy, kube, users[2:4])[2]
    if delta(c3, counts())["hits"] != 2 or again != lists1[2:4]:
        raise AssertionError("lists after the workflow: write were not hits")
    req = CheckRequest(resource=wf.resource, permission=wf.relation,
                       subject=wf.subject)

    def check():
        return asyncio.run(proxy.endpoint.check_bulk_permissions([req]))[0]

    r1, r2 = check(), check()
    if (r1.permissionship != Permissionship.HAS_PERMISSION
            or r2.source != "cache"):
        raise AssertionError(f"expiring tuple checks {r1}, {r2}")
    time.sleep(max(0.0, wf.expires_at - time.time()) + 0.1)
    c4 = counts()
    r3 = check()
    if (r3.permissionship != Permissionship.NO_PERMISSION
            or r3.source == "cache" or not delta(c4, counts())[
                "invalidations"]):
        raise AssertionError(f"after its expiry the check answered {r3}")
    x = users[1]
    xs = SubjectRef("user", x)
    nss = sorted(name for objs in kube.objects[("", "v1", "namespaces")]
                 .values() for name in objs)
    grant = next(n for n in nss if not oracle.check(
        ObjectRef("namespace", n), "view", xs))
    asyncio.run(proxy.endpoint.write_relationships([RelationshipUpdate(
        UpdateOp.TOUCH, Relationship(resource=ObjectRef("namespace", grant),
                                     relation="viewer", subject=xs))]))
    c5 = counts()
    got = _list_burst(proxy, kube, [x])[2][0]
    want_x = _oracle_pods(oracle, pods, xs)
    if delta(c5, counts())["misses"] != 1 or got != want_x or not any(
            p.startswith(f"{grant}/") for p in got):
        raise AssertionError(f"{x}'s list after the grant of {grant}: "
                             f"{len(got)} pods, the oracle {len(want_x)}")
    log(f"phase 18 (b) a workflow: write left {still} list entries valid; "
        f"its check hit until the store clock passed {CACHE_EXPIRY_S} s, "
        f"then missed with {r3.permissionship.name}; granting {x} "
        f"namespace {grant} made its list miss with {len(got)} pods (from "
        f"{len(lists1[1])})")

    # (c) the HBM ledger
    ledger = devtel.LEDGER.total()
    tables = devtel.tensor_bytes(g.dev_main, g.dev_aux, g.dev_cav)
    alloc = torch.cuda.memory_allocated() if on_card else None
    if ledger < tables or (on_card and ledger > alloc):
        raise AssertionError(f"ledger {ledger} bytes against tables "
                             f"{tables} and allocated {alloc}")
    old_gen = ep._devtel_gen
    kinds = devtel.LEDGER.totals()
    t_rb = time.perf_counter()
    ep.force_rebuild()
    rebuild_s = time.perf_counter() - t_rb
    left = {k: devtel.LEDGER.generation_bytes(old_gen, k) for k in kinds}
    if any(left.values()) or ep._devtel_gen == old_gen:
        raise AssertionError(f"generation {old_gen} kept {left}")
    log(f"phase 18 (c) HBM ledger {ledger} bytes by kind {kinds}; graph "
        f"tables {tables} bytes; torch.cuda.memory_allocated {alloc}; "
        f"force_rebuild {rebuild_s:.3f} s retired generation {old_gen} "
        f"(0 bytes left in every kind), generation {ep._devtel_gen} "
        f"{devtel.LEDGER.generation_bytes(ep._devtel_gen)} bytes, peak "
        f"{devtel.LEDGER.peak}")

    # (f) the /debug surfaces, with and without a user
    proxy.flight.capture()

    async def surfaces():
        out = {}
        for path in ("/debug/flight", "/debug/timeline", "/debug/workload",
                     "/debug/profile?seconds=1"):
            a = await proxy.get_embedded_client(user=users[0]).get(path)
            b = await proxy.get_embedded_client().get(path)
            json.loads(a.body)
            out[path] = (a.status, b.status, len(a.body))
        return out

    served = asyncio.run(surfaces())
    bad = {p: s for p, s in served.items()
           if s[0] != 200 or s[1] not in (401, 403)}
    if bad:
        raise AssertionError(f"debug surfaces answered {bad}")
    log(f"phase 18 (f) debug surfaces (status with a user, without, "
        f"bytes): {served}")

    # the telemetry's cost: the first TELEMETRY_COST_USERS lists of
    # phase 16's burst again on its proxy, with the switches on and then
    # off (its first run, on a fresh proxy, beside)
    cost_users = users[:TELEMETRY_COST_USERS]
    wall_on, own_on, _ = _list_burst(p16["proxy"], kube, cost_users)
    saved = (features.DEVICE_TELEMETRY, features.TIMELINE,
             features.KERNEL_INTROSPECT)
    features.DEVICE_TELEMETRY = features.TIMELINE = False
    features.KERNEL_INTROSPECT = False
    try:
        wall_off, own_off, _ = _list_burst(p16["proxy"], kube, cost_users)
    finally:
        (features.DEVICE_TELEMETRY, features.TIMELINE,
         features.KERNEL_INTROSPECT) = saved
    log(f"phase 18 telemetry cost: {len(cost_users)} lists of phase 16's "
        f"{len(users)}-list burst on "
        f"its proxy, wall {wall_on:.4f} s with the switches on (own time "
        f"{_pcts(own_on)}), {wall_off:.4f} s off (own time "
        f"{_pcts(own_off)}); phase 16's first burst (all {len(users)}) "
        f"{p16['a_wall']:.4f} s; "
        f"reported, not enforced ({smi_line})")
    log(f"phase 18 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches1, "cold_wall": wall1, "warm_wall": wall2}


# -- phase 19, the durable store and WAL-shipping read replication -----------


class _LeaderLink:
    """A follower's transport to an in-process leader: the leader's
    current handler at every call (enable_dual_writes rebuilds it)."""

    def __init__(self, proxy):
        self.proxy = proxy

    async def round_trip(self, req):
        return await self.proxy.handler(req)


def _bare(proxy):
    """The TorchEndpoint under a proxy's wrappers."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    ep = proxy.endpoint
    while not isinstance(ep, TorchEndpoint):
        ep = ep.inner
    return ep


def _read_set(store, gid: dict):
    """A store's live tuples as one sorted [n, 7] int64 array: the six
    identity strings through the interning `gid` (shared by the stores
    compared) and the expiry's float64 bits, so two stores of a million
    tuples compare without a million Python objects each.  Caveats are
    not covered: a caveated tuple raises (multitenant-1m has none)."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.columnar import _COLS

    def ids(strings):
        return np.fromiter((gid.setdefault(x, len(gid)) for x in strings),
                           np.int64, len(strings))

    view = store.columnar_view()
    snap, rows, overlay = view if view is not None else (
        None, None, store.read(None))
    parts = []
    if snap is not None and len(rows):
        pool = ids(snap.pool)
        parts.append(np.stack(
            [pool[getattr(snap, c)[rows]] for c in _COLS]
            + [np.asarray(snap.expiry[rows], np.float64).view(np.int64)],
            1))
    if overlay:
        if any(r.caveat is not None for r in overlay):
            raise AssertionError("a caveated tuple in the read-set")
        cols = [ids([getattr(r.resource, "type") for r in overlay]),
                ids([r.resource.id for r in overlay]),
                ids([r.relation for r in overlay]),
                ids([r.subject.type for r in overlay]),
                ids([r.subject.id for r in overlay]),
                ids([r.subject.relation for r in overlay])]
        exp = np.array([np.nan if r.expires_at is None else r.expires_at
                        for r in overlay], np.float64).view(np.int64)
        parts.append(np.stack(cols + [exp], 1))
    if not parts:
        return np.zeros((0, 7), np.int64)
    a = np.concatenate(parts)
    return a[np.lexsort(a.T[::-1])]


def _durable_writes(rnd: dict, n: int) -> list:
    """A round of `_churn_plan`'s writes cut to `n`: its namespace
    grants first (the lists that read them change), then the rest in
    the plan's order."""
    grants = [wr for wr in rnd["writes"]
              if wr[0][1].startswith("namespace:")]
    rest = [wr for wr in rnd["writes"] if wr not in grants]
    return (grants + rest)[:n]


def durable_path(w, kube, smi_line: str, device: str = "cuda",
                 failover: bool = False) -> dict:
    """Phase 19: the durable store and WAL-shipping read replication at
    multitenant-1m (`w`, phase 3's workload), over phase 16's fake
    kube-apiserver (see the module docstring for (a)-(e)); with
    `failover`, phase 20 on its leader and follower after it.  Returns
    the follower's launches by kernel, phase 20's under "failover", and
    each phase's seconds under "phase_s"."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    _switch(True)   # the port's default rebuild path
    tmp = tempfile.mkdtemp(prefix="smoke-durable-")
    try:
        ctx = _durable_leader(w, kube, smi_line, device, tmp)
        ctx["tmp"] = tmp
        _durable_crash(ctx)
        cli_crash(smi_line, device=device)
        out = _durable_follower(ctx)
        _durable_rebootstrap(ctx)
        out["phase_s"] = {"19": time.perf_counter() - t_phase}
        log(f"phase 19 wall time {out['phase_s']['19']:.1f} s")
        if failover:
            t = time.perf_counter()
            out["failover"] = failover_path(ctx)
            out["phase_s"]["20"] = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _durable_leader(w, kube, smi_line: str, device: str, tmp: str) -> dict:
    """Phase 19 (a): a durable leader and its WAL tail."""
    import threading

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.columnar import (
        ColumnarSnapshot)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, SubjectRef, UpdateOp, parse_relationship)

    on_card = device == "cuda"
    url = "torch://" if on_card else f"torch://?device={device}"
    data = os.path.join(tmp, "data")
    text = "\n".join(w.relationships)
    rules = [proxyrule.parse_doc(d)
             for d in PROXY_READ_RULES + DUALWRITE_RULES]
    opts = dict(spicedb_endpoint=url, rule_configs=rules,
                upstream_transport=HandlerTransport(kube),
                prewarm_compiles=True, data_dir=data, wal_fsync="always",
                workflow_database_path=os.path.join(data, "dtx.sqlite"))
    leader = ProxyServer(Options(bootstrap=Bootstrap(w.schema_text), **opts))
    mgr = leader.persistence
    store = leader.endpoint.store
    # the bulk load: one snapshot record, its sidecar written and fsynced
    # before it
    from spicedb_kubeapi_proxy_tpu_torch import native
    if native.disabled():
        raise AssertionError("phase 19 (a) parses through the native parser")
    t0 = time.perf_counter()
    snap = ColumnarSnapshot.from_text(text)
    t1 = time.perf_counter()
    store.bulk_load_snapshot(snap)
    t2 = time.perf_counter()
    # the native parse against its Python twin on a slice of the text
    part = "\n".join(w.relationships[:PARSE_TWIN_LINES])
    tp0 = time.perf_counter()
    a = ColumnarSnapshot.from_text(part)
    tp1 = time.perf_counter()
    b = ColumnarSnapshot._from_text_py(part)
    tp2 = time.perf_counter()
    if a.pool != b.pool or not all(
            np.array_equal(getattr(a, c), getattr(b, c))
            for c in ("rtype", "rid", "rel", "stype", "sid", "srel")) or \
            not np.array_equal(a.expiry, b.expiry, equal_nan=True):
        raise AssertionError("phase 19 (a): the native parse differs from "
                             "_from_text_py")
    log(f"phase 19 (a) parse: {len(snap)} tuples through the native parser "
        f"in {t1 - t0:.3f} s; on a {len(a)}-line slice native "
        f"{tp1 - tp0:.3f} s, _from_text_py {tp2 - tp1:.3f} s, equal pools "
        f"({len(a.pool)} strings) and columns ({smi_line})")
    records = list(mgr.wal.replay())
    if [r["k"] for r in records] != ["s"] or store.revision != 1:
        raise AssertionError(f"the bulk load journaled {records}")
    sidecar = os.path.getsize(os.path.join(mgr.wal.dir, records[0]["f"]))
    asyncio.run(leader.warm_start())
    t3 = time.perf_counter()
    ep = _bare(leader)
    if ep.device.type != torch.device(device).type:
        raise AssertionError(f"leader endpoint on {ep.device}")

    # the checkpoint, and how long it holds the store lock: the capture
    # (the columnar view) and the WAL cut run under it, the serializing
    # after it; a probe thread takes the lock meanwhile
    held = {}
    view_fn, cut_fn = store.columnar_view, mgr.wal.cut

    def timed_view():
        held["t0"] = time.perf_counter()
        return view_fn()

    def timed_cut():
        out = cut_fn()
        held["t1"] = time.perf_counter()
        return out

    store.columnar_view, mgr.wal.cut = timed_view, timed_cut
    waits, stop = [], threading.Event()

    def probe():
        while not stop.is_set():
            t = time.perf_counter()
            with store.lock:
                pass
            waits.append(time.perf_counter() - t)
            time.sleep(0.0005)

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    try:
        t4 = time.perf_counter()
        manifest = mgr.checkpoint()
        t5 = time.perf_counter()
    finally:
        stop.set()
        th.join()
        del store.columnar_view, mgr.wal.cut
    if manifest is None or manifest["revision"] != store.revision:
        raise AssertionError(f"checkpoint manifest {manifest}")
    ckpt_bytes = os.path.getsize(os.path.join(mgr.ckpt_dir,
                                              manifest["checkpoint"]))
    log(f"phase 19 (a): durable leader ProxyServer({url!r}, data_dir, "
        f"wal_fsync='always'); {len(snap)} tuples parsed in "
        f"{t1 - t0:.3f} s, journaled bulk load (snapshot record + "
        f"{sidecar} byte sidecar, fsynced) {t2 - t1:.3f} s; warm start "
        f"with prewarm {t3 - t2:.3f} s; checkpoint at revision "
        f"{manifest['revision']} {t5 - t4:.3f} s ({ckpt_bytes} bytes), the "
        f"store lock held {held['t1'] - held['t0']:.6f} s (capture and WAL "
        f"cut), the longest wait of a thread taking it "
        f"{max(waits):.6f} s (interpreter lock included, {len(waits)} "
        f"takes) ({smi_line})")

    # the WAL tail: pod-churn rounds through the endpoint, then dual-write
    # creates through the proxy
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    plan = _churn_plan(w, DURABLE_ROUNDS + FOLLOWER_ROUNDS + 2, SEED + 19,
                       tag="d")
    lat = []

    async def churn_rounds():
        for rnd in plan[:DURABLE_ROUNDS]:
            for wr in _durable_writes(rnd, DURABLE_ROUND_WRITES):
                t = time.perf_counter()
                await leader.endpoint.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(r))
                     for o, r in wr])
                lat.append(time.perf_counter() - t)

    t6 = time.perf_counter()
    asyncio.run(churn_rounds())
    t7 = time.perf_counter()
    # the creates' users: the first who may view a namespace, each in
    # one of those
    cands = [f"u{i}" for i in range(4 * DURABLE_CREATES)]
    ns_lists = asyncio.run(ep.lookup_resources_batch(
        "namespace", "view", [SubjectRef("user", u) for u in cands]))
    rng = np.random.default_rng(SEED + 19)
    viewers = [(u, sorted(ids)) for u, ids in zip(cands, ns_lists) if ids]
    if len(viewers) < DURABLE_CREATES:
        raise AssertionError(f"{len(viewers)} of {len(cands)} users may "
                             f"view a namespace")
    users = [u for u, _ in viewers[:DURABLE_CREATES]]
    home = [ids[int(rng.integers(len(ids)))]
            for _, ids in viewers[:DURABLE_CREATES]]
    leader.enable_dual_writes()

    async def creates():
        kube._lock = asyncio.Lock()
        await leader._worker.start()
        try:
            res = await asyncio.gather(*(
                leader.get_embedded_client(user=u).post(
                    f"/api/v1/namespaces/{ns}/pods",
                    {"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"dur-{i}", "namespace": ns}})
                for i, (u, ns) in enumerate(zip(users, home))))
        finally:
            await leader._worker.stop()
        return res

    res = asyncio.run(creates())
    t8 = time.perf_counter()
    bad = [(r.status, r.body[:200]) for r in res if r.status != 201]
    if bad:
        raise AssertionError(f"{len(bad)} durable creates failed: {bad[:3]}")
    tail = [r for r in mgr.wal.replay() if r["r"] > manifest["revision"]]
    phase9 = WRITE_SECONDS.get("phase 9") or [float("nan")]
    log(f"phase 19 (a) {DURABLE_ROUNDS} rounds of {DURABLE_ROUND_WRITES} "
        f"pod-churn writes through the endpoint in {t7 - t6:.3f} s, per "
        f"write (WAL append + fsync under the store lock) {_pcts(lat)}, max "
        f"{max(lat) * 1e3:.3f} ms; phase 9's in-memory writes on the bare "
        f"endpoint {_pcts(phase9)} ({smi_line})")
    log(f"phase 19 (a) {DURABLE_CREATES} concurrent dual-write creates "
        f"through the proxy {t8 - t7:.3f} s, all 201; WAL tail past the "
        f"checkpoint {len(tail)} records, segments "
        f"{mgr.wal.segment_seqs()} {mgr.wal.total_bytes()} bytes")
    return {"w": w, "kube": kube, "smi_line": smi_line, "device": device,
            "url": url, "data": data, "text": text, "opts": opts,
            "leader": leader, "ep": ep, "plan": plan, "ops": ops,
            "users": users, "home": home, "rng": rng,
            "manifest": manifest, "tail": tail}


def _durable_crash(ctx: dict) -> None:
    """Phase 19 (b): an in-process crash and the recovery."""
    import gc

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.authz.distributedtx.workflow import (
        STRATEGY_PESSIMISTIC, _collect_updates, _lock_update)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipFilter, RelationshipUpdate,
        SubjectRef, UpdateOp, parse_relationship)
    from spicedb_kubeapi_proxy_tpu_torch.utils import failpoints

    on_card = ctx["device"] == "cuda"
    w, kube, leader, ep = ctx["w"], ctx["kube"], ctx["leader"], ctx["ep"]
    rng = ctx["rng"]
    subjects = [SubjectRef("user", w.subjects[i]) for i in
                rng.choice(len(w.subjects), LOOKUP_LANES, replace=False)]
    pods = [p for p in ep.graph().prog.object_ids["pod"] if "\x00" not in p]
    reqs = [CheckRequest(ObjectRef("pod", pods[int(i)]), "view",
                         subjects[int(s)]) for i, s in zip(
        rng.choice(len(pods), N_CHECKS, replace=False),
        rng.integers(0, LOOKUP_LANES, N_CHECKS))]
    sample_idx = [int(i) for i in rng.choice(len(reqs), DURABLE_ORACLE_CHECKS,
                                             replace=False)]
    sample = [reqs[i] for i in sample_idx]
    ctx.update(subjects=subjects, reqs=reqs)

    def answers(e):
        look = asyncio.run(e.lookup_resources_batch("pod", "view", subjects))
        chk = asyncio.run(e.check_bulk_permissions(reqs))
        return [sorted(x) for x in look], [c.allowed for c in chk]

    # a dual write left pending: its SpiceDB write (and idempotency key)
    # committed and journaled, the activity's completion not
    ns, user = ctx["home"][0], ctx["users"][0]
    inp = {"verb": "create", "request_uri": f"/api/v1/namespaces/{ns}/pods",
           "request_path": f"/api/v1/namespaces/{ns}/pods",
           "request_name": "", "api_group": "", "resource": "pods",
           "headers": {}, "user_name": user, "object_name": "revived",
           "body": json.dumps({"apiVersion": "v1", "kind": "Pod",
                               "metadata": {"name": "revived",
                                            "namespace": ns}}),
           "probe_uri": f"/api/v1/namespaces/{ns}/pods/revived",
           "creates": [f"pod:{ns}/revived#namespace@namespace:{ns}",
                       f"pod:{ns}/revived#creator@user:{user}"],
           "touches": [], "deletes": [], "preconditions": [],
           "delete_by_filter": []}
    engine = leader.workflow_client
    engine.journal.create_instance("smoke-revived", STRATEGY_PESSIMISTIC, inp)
    lock_rel, lock_pre = _lock_update(inp, "smoke-revived")

    async def crash_in_write():
        failpoints.enable_failpoint("panicSpiceDBWriteResp", 1)
        try:
            await engine._activities["write_to_spicedb"](
                {"updates": _collect_updates(inp) + [lock_rel],
                 "preconditions": [lock_pre]}, "smoke-revived")
        except failpoints.FailPointPanic:
            return True
        finally:
            failpoints.disable_all()
        return False

    if not asyncio.run(crash_in_write()):
        raise AssertionError("the pending dual write did not crash")
    gid: dict = {}
    t0 = time.perf_counter()
    before = _read_set(leader.endpoint.store, gid)
    t_digest = time.perf_counter() - t0
    pre = answers(ep)
    oracle = ep._oracle
    want_sample = [oracle.check(r.resource, r.permission, r.subject)
                   for r in sample]
    if [pre[1][i] for i in sample_idx] != want_sample:
        raise AssertionError("the leader's checks differ from the oracle "
                             "before the crash")
    last_rev = leader.endpoint.store.revision
    # the crash: walAfterAppend on a re-touch of a tuple the store holds
    # (the record is on disk, the commit never applied in memory), and
    # the process gone without stop(): no final checkpoint
    failpoints.enable_failpoint("walAfterAppend", 1)
    try:
        asyncio.run(leader.endpoint.write_relationships([RelationshipUpdate(
            UpdateOp.TOUCH, parse_relationship(
                f"pod:{ns}/dur-0#creator@user:{user}"))]))
        raise AssertionError("walAfterAppend did not fire")
    except failpoints.FailPointPanic:
        pass
    finally:
        failpoints.disable_all()
    if leader.endpoint.store.revision != last_rev:
        raise AssertionError("the crashed write became visible")
    ep.wait_rebuilds()
    del leader, ep, engine, oracle
    ctx.pop("leader"), ctx.pop("ep")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the restart: recover (checkpoint + WAL tail) into a fresh store,
    # a fresh torch:// endpoint over it, the bootstrap skipped
    t0 = time.perf_counter()
    leader = ProxyServer(Options(
        bootstrap=Bootstrap(w.schema_text, ctx["text"]), **ctx["opts"]))
    t1 = time.perf_counter()
    mgr = leader.persistence
    info = mgr.recovery_info
    store = leader.endpoint.store
    if not mgr.recovered or store.revision != last_rev + 1:
        raise AssertionError(f"recovered revision {store.revision}, the "
                             f"last journaled one is {last_rev + 1}")
    if info["checkpoint_revision"] != ctx["manifest"]["revision"] or \
            info["replayed_records"] != last_rev + 1 - info[
                "checkpoint_revision"]:
        raise AssertionError(f"recovery info {info}")
    if info["idempotency_keys"] != DURABLE_CREATES + 1:
        raise AssertionError(f"{info['idempotency_keys']} idempotency keys "
                             f"replayed, {DURABLE_CREATES + 1} journaled")
    after = _read_set(store, gid)
    if not np.array_equal(before, after):
        raise AssertionError(f"the recovered read-set ({len(after)} "
                             f"tuples) differs from the pre-crash one "
                             f"({len(before)})")
    t2 = time.perf_counter()
    asyncio.run(leader.warm_start())
    t3 = time.perf_counter()
    ep = _bare(leader)
    if ep.stats["rebuilds"] != 1:
        raise AssertionError(f"warm start made {ep.stats['rebuilds']} "
                             f"rebuilds")
    t4 = time.perf_counter()
    look = asyncio.run(ep.lookup_resources_batch("pod", "view", subjects))
    if on_card:
        torch.cuda.synchronize()
    t5 = time.perf_counter()
    chk = asyncio.run(ep.check_bulk_permissions(reqs))
    t6 = time.perf_counter()
    got = ([sorted(x) for x in look], [c.allowed for c in chk])
    if got != pre:
        raise AssertionError("the recovered endpoint's answers differ from "
                             "the pre-crash endpoint's")
    if [got[1][i] for i in sample_idx] != want_sample:
        raise AssertionError("the recovered checks differ from the oracle")
    if ep.stats["rebuilds"] != 1 or ep.stats["stale_routed"]:
        raise AssertionError(f"recovered reads rebuilt or went to the "
                             f"oracle: {ep.stats}")
    mem = ((torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
           if on_card else (0, 0))

    # the restarted worker: the pending instance replays against the
    # recovered store, detects its applied write, and writes it once
    leader.enable_dual_writes()

    async def replay():
        kube._lock = asyncio.Lock()
        return await leader.workflow_client.run_pending_once()

    n_replayed = asyncio.run(replay())
    journal = leader.workflow_client.journal
    rec = journal.get_instance("smoke-revived")
    pods_now = kube.objects.get(("", "v1", "pods"), {}).get(ns, {})
    if (n_replayed != 1 or rec.status != "completed"
            or rec.result.get("status_code") != 201
            or journal.pending_instances()
            or not all(store.has_exact(parse_relationship(r))
                       for r in inp["creates"])
            or "revived" not in pods_now
            or store.read(RelationshipFilter(resource_type="lock"))):
        raise AssertionError(f"the restarted worker: {n_replayed} replayed, "
                             f"{rec.status} {rec.result} {rec.error}")
    ctx.update(leader=leader, ep=ep, gid=gid)
    log(f"phase 19 (b) crash (walAfterAppend on revision {last_rev + 1}, "
        f"no stop()) and restart: recovered revision {store.revision} in "
        f"{info['total_s']:.3f} s (checkpoint load "
        f"{info['checkpoint_load_s']:.3f} s, {info['checkpoint_tuples']} "
        f"tuples; tail replay {info['wal_replay_s']:.3f} s, "
        f"{info['replayed_records']} records, {info['idempotency_keys']} "
        f"idempotency keys), ProxyServer built in {t1 - t0:.3f} s with the "
        f"bootstrap skipped; read-set equal ({len(after)} tuples, compared "
        f"in {t_digest:.3f} s); warm start with prewarm {t3 - t2:.3f} s; "
        f"first lookup batch after recovery {t5 - t4:.4f} s, check batch "
        f"{t6 - t5:.4f} s, both equal to the pre-crash endpoint's and "
        f"{DURABLE_ORACLE_CHECKS} oracle checks; card memory allocated "
        f"{mem[0] / 2**20:.1f} MiB, reserved {mem[1] / 2**20:.1f} MiB "
        f"({ctx['smi_line']})")
    log(f"phase 19 (b) restarted worker: {n_replayed} pending instance "
        f"replayed to {rec.status} ({rec.result.get('status_code')}), its "
        f"write applied once, nothing pending")


def _durable_follower(ctx: dict) -> dict:
    """Phase 19 (d): a follower of (b)'s leader."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, parse_relationship)
    from spicedb_kubeapi_proxy_tpu_torch.utils import devtel

    on_card = ctx["device"] == "cuda"
    w, kube, leader, l_ep = ctx["w"], ctx["kube"], ctx["leader"], ctx["ep"]
    subjects, reqs, ops = ctx["subjects"], ctx["reqs"], ctx["ops"]
    t0 = time.perf_counter()
    follower = ProxyServer(Options(
        spicedb_endpoint=ctx["url"],
        rule_configs=[proxyrule.parse_doc(d) for d in PROXY_READ_RULES],
        bootstrap=Bootstrap(w.schema_text),
        upstream_transport=HandlerTransport(kube), prewarm_compiles=True,
        replicate_from="http://leader.smoke",
        leader_transport=_LeaderLink(leader)))
    repl = follower.replication
    f_ep = _bare(follower)
    # the bootstrap's split: the checkpoint's fetch, its parse, and the
    # adoption into the store
    split = {"fetch": 0.0, "parse": 0.0, "adopt": 0.0}

    def timed(key, fn, is_async):
        if is_async:
            async def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return await fn(*a, **k)
                finally:
                    split[key] += time.perf_counter() - t
        else:
            def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    split[key] += time.perf_counter() - t
        return wrapped

    repl._fetch_artifact = timed("fetch", repl._fetch_artifact, True)
    repl._spool_npz = timed("parse", repl._spool_npz, True)
    repl.store.replica_reset = timed("adopt", repl.store.replica_reset, False)
    t1 = time.perf_counter()
    applied = asyncio.run(repl.sync_once())
    t2 = time.perf_counter()
    del repl._fetch_artifact, repl._spool_npz, repl.store.replica_reset
    if (not repl.bootstrapped
            or repl.store.revision != leader.endpoint.store.revision):
        raise AssertionError(f"follower at {repl.store.revision}, leader at "
                             f"{leader.endpoint.store.revision}")
    if not np.array_equal(_read_set(repl.store, ctx["gid"]),
                          _read_set(leader.endpoint.store, ctx["gid"])):
        raise AssertionError("the follower's read-set differs from the "
                             "leader's after its bootstrap")
    t3 = time.perf_counter()
    asyncio.run(follower.warm_start())
    t4 = time.perf_counter()
    log(f"phase 19 (d): follower ProxyServer({ctx['url']!r}, replicate_from"
        f") built in {t1 - t0:.3f} s; bootstrap {t2 - t1:.3f} s (checkpoint "
        f"fetch {split['fetch']:.3f} s, parse {split['parse']:.3f} s, "
        f"adoption {split['adopt']:.3f} s; then {applied} tail records) to "
        f"revision {repl.store.revision}, read-set equal to the leader's; "
        f"graph build with prewarm {t4 - t3:.3f} s ({ctx['smi_line']})")

    def look(e):
        return asyncio.run(e.lookup_resources_batch("pod", "view", subjects))

    warm = []
    for _ in range(N_WARM):
        t = time.perf_counter()
        look(f_ep)
        if on_card:
            torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    warm_med = statistics.median(warm)
    # the proxied lists of a round: its grants' (namespace, user) pairs,
    # then dual-write users in their home namespaces
    fixed = list(zip(ctx["home"], ctx["users"]))
    commit_t, apply_t = {}, {}

    def on_commit(kind, revision, payload):
        commit_t[revision] = time.perf_counter()

    apply_batch = repl.store.apply_replica_batch

    def timed_apply(updates):
        rev = apply_batch(updates)
        apply_t[rev] = time.perf_counter()
        return rev

    leader.endpoint.store.add_commit_listener(on_commit)
    repl.store.apply_replica_batch = timed_apply
    stats0 = dict(f_ep.stats)
    launches: dict = {}
    raw, lists_ok = [], 0

    def names(resp):
        if resp.status != 200:
            raise AssertionError(f"list answered {resp.status}: "
                                 f"{resp.body[:300]!r}")
        return sorted(i["metadata"]["name"]
                      for i in json.loads(resp.body)["items"])

    async def rounds():
        nonlocal lists_ok
        kube._lock = asyncio.Lock()
        repl.start()    # the tail: long-polls the leader's manifest
        try:
            for rnd in ctx["plan"][DURABLE_ROUNDS:
                                   DURABLE_ROUNDS + FOLLOWER_ROUNDS]:
                for wr in _durable_writes(rnd, DURABLE_ROUND_WRITES):
                    await leader.endpoint.write_relationships(
                        [RelationshipUpdate(ops[o], parse_relationship(r))
                         for o, r in wr])
                rev = leader.endpoint.store.revision
                if not await repl.wait_for_revision(rev, 60.0):
                    raise AssertionError(f"the follower never reached "
                                         f"revision {rev}")
                pairs = (list(rnd["granted"]) + fixed)[:FOLLOWER_LISTS]
                f_ep.wait_rebuilds()
                l0 = dict(kernels.LAUNCHES)
                t = time.perf_counter()
                got = await f_ep.lookup_resources_batch("pod", "view",
                                                        subjects)
                if on_card:
                    torch.cuda.synchronize()
                raw.append(time.perf_counter() - t)
                got_c = await f_ep.check_bulk_permissions(reqs)
                hdr = [("X-Authz-Min-Revision", str(rev))]
                f_lists = await asyncio.gather(*(
                    follower.get_embedded_client(user=u).get(
                        f"/api/v1/namespaces/{ns}/pods", headers=hdr)
                    for ns, u in pairs))
                f_ep.wait_rebuilds()
                for k, v in kernels.LAUNCHES.items():
                    launches[k] = launches.get(k, 0) + v - l0.get(k, 0)
                want = await l_ep.lookup_resources_batch("pod", "view",
                                                         subjects)
                want_c = await l_ep.check_bulk_permissions(reqs)
                if ([sorted(x) for x in got] != [sorted(x) for x in want]
                        or [c.allowed for c in got_c]
                        != [c.allowed for c in want_c]):
                    raise AssertionError(f"the follower's lookup or check "
                                         f"batch differs from the "
                                         f"leader's at revision {rev}")
                l_lists = await asyncio.gather(*(
                    leader.get_embedded_client(user=u).get(
                        f"/api/v1/namespaces/{ns}/pods")
                    for ns, u in pairs))
                for (ns, u), fr, lr in zip(pairs, f_lists, l_lists):
                    if (fr.headers.get("X-Authz-Forwarded-To")
                            or int(fr.headers.get("X-Authz-Revision"))
                            < rev or names(fr) != names(lr)):
                        raise AssertionError(f"the follower's list of {ns} "
                                             f"for {u} differs from the "
                                             f"leader's at revision {rev}")
                    lists_ok += 1
        finally:
            await repl.stop()

    t5 = time.perf_counter()
    asyncio.run(rounds())
    t6 = time.perf_counter()
    leader.endpoint.store.remove_commit_listener(on_commit)
    del repl.store.apply_replica_batch
    f_ep.wait_rebuilds()
    lag = [apply_t[r] - commit_t[r] for r in commit_t if r in apply_t]
    if len(lag) != FOLLOWER_ROUNDS * DURABLE_ROUND_WRITES:
        raise AssertionError(f"{len(lag)} replicated commits timed")
    idle = [k for k in READ_KERNELS + ("scatter_rows",)
            if not launches.get(k)]
    if idle:
        raise AssertionError(f"kernels never launched on the follower: "
                             f"{idle}")
    d = {k: f_ep.stats[k] - stats0[k] for k in
         ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
          "spare_assignments", "stale_routed", "delta_batches")}
    if d["stale_routed"]:
        raise AssertionError(f"follower reads went to the oracle: {d}")
    async def all_pods(user):
        resp = await leader.get_embedded_client(user=user).get(
            "/api/v1/pods")
        return {f"{i['metadata']['namespace']}/{i['metadata']['name']}"
                for i in json.loads(resp.body)["items"]}

    user0 = ctx["users"][0]
    socket = _proxy_socket(follower, user0, asyncio.run(all_pods(user0)))
    mem = {"leader": devtel.LEDGER.generation_bytes(l_ep._devtel_gen),
           "follower": devtel.LEDGER.generation_bytes(f_ep._devtel_gen)}
    cuda_mem = torch.cuda.memory_allocated() if on_card else 0
    raw_med = statistics.median(raw)
    log(f"phase 19 (d) {FOLLOWER_ROUNDS} rounds of {DURABLE_ROUND_WRITES} "
        f"writes on the leader in {t6 - t5:.1f} s: commit-to-apply lag "
        f"{_pcts(lag)}, max {max(lag) * 1e3:.3f} ms over {len(lag)} "
        f"commits; follower read-after-write lookup batch median "
        f"{raw_med:.4f} s vs its warm median {warm_med:.4f} s "
        f"({raw_med / warm_med:.3f}x; printed, not enforced); its "
        f"{len(reqs)}-pair check batches and {lists_ok} proxied lists with "
        f"X-Authz-Min-Revision equal to the leader's, served locally "
        f"({ctx['smi_line']})")
    log(f"phase 19 (d) follower launches "
        f"{ {k: v for k, v in launches.items() if v} }; counters {d}; HBM "
        f"ledger bytes {mem}, card memory allocated "
        f"{cuda_mem / 2**20:.1f} MiB; loopback {socket}")
    ctx.update(follower=follower, f_ep=f_ep)
    return {"launches": launches}


def _durable_rebootstrap(ctx: dict) -> None:
    """Phase 19 (e): the follower re-bootstraps past a reclaimed tail."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, parse_relationship)

    on_card = ctx["device"] == "cuda"
    leader, l_ep = ctx["leader"], ctx["ep"]
    follower, f_ep = ctx["follower"], ctx["f_ep"]
    repl, subjects, ops = follower.replication, ctx["subjects"], ctx["ops"]
    plan = ctx["plan"][DURABLE_ROUNDS + FOLLOWER_ROUNDS:]
    boots0, rebuilds0 = repl.stats["rebootstraps"], f_ep.stats["rebuilds"]

    async def write(rnd):
        for wr in _durable_writes(rnd, DURABLE_ROUND_WRITES):
            await leader.endpoint.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    # the follower paused; the leader checkpoints and reclaims the
    # segment the follower was tailing, then writes on
    asyncio.run(write(plan[0]))
    manifest = leader.persistence.checkpoint()
    asyncio.run(write(plan[1]))
    t0 = time.perf_counter()
    asyncio.run(repl.sync_once())
    t1 = time.perf_counter()
    if (repl.stats["rebootstraps"] != boots0 + 1
            or repl.store.revision != leader.endpoint.store.revision):
        raise AssertionError(f"no re-bootstrap: {repl.snapshot()}")
    got = asyncio.run(f_ep.lookup_resources_batch("pod", "view", subjects))
    if on_card:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    want = asyncio.run(l_ep.lookup_resources_batch("pod", "view", subjects))
    if [sorted(x) for x in got] != [sorted(x) for x in want]:
        raise AssertionError("after the re-bootstrap the follower's lookup "
                             "batch differs from the leader's")
    if f_ep.stats["rebuilds"] != rebuilds0 + 1:
        raise AssertionError(f"the reset made "
                             f"{f_ep.stats['rebuilds'] - rebuilds0} rebuilds")
    t3 = time.perf_counter()
    again = asyncio.run(f_ep.lookup_resources_batch("pod", "view", subjects))
    if on_card:
        torch.cuda.synchronize()
    t4 = time.perf_counter()
    if [sorted(x) for x in again] != [sorted(x) for x in want]:
        raise AssertionError("the follower's second batch differs")
    log(f"phase 19 (e) paused follower, leader checkpoint at revision "
        f"{manifest['revision']} reclaimed its segment: re-bootstrap "
        f"(replica_reset to the checkpoint, then the tail) "
        f"{t1 - t0:.3f} s; first read after the reset (a synchronous "
        f"{ctx['w'].name} graph rebuild on {f_ep.device} and the batch) "
        f"{t2 - t1:.4f} s, the next batch {t4 - t3:.4f} s; answers equal "
        f"the leader's ({ctx['smi_line']})")


class _DeadLink:
    """A transport to a leader that is gone (killed, or across a
    partition): every call fails as a refused connection would."""

    async def round_trip(self, req):
        raise ConnectionError("the leader is gone")


class _timed_attr:
    """Patch `obj.name` with a wrapper adding each call's seconds to
    `split[key]` (a coroutine function stays one), restored on exit."""

    def __init__(self, obj, name: str, split: dict, key: str):
        self.obj, self.name, self.split, self.key = obj, name, split, key

    def __enter__(self):
        import inspect
        fn = self.orig = getattr(self.obj, self.name)
        split, key = self.split, self.key
        split.setdefault(key, 0.0)
        if inspect.iscoroutinefunction(fn):
            async def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return await fn(*a, **k)
                finally:
                    split[key] += time.perf_counter() - t
        else:
            def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    split[key] += time.perf_counter() - t
        setattr(self.obj, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)
        return False


def _launch_delta(l0: dict) -> dict:
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    return {k: v - l0.get(k, 0) for k, v in kernels.LAUNCHES.items()
            if v - l0.get(k, 0)}


def _add(acc: dict, d: dict) -> None:
    for k, v in d.items():
        acc[k] = acc.get(k, 0) + v


def _require_launches(launches: dict, kernels_: tuple, where: str) -> None:
    idle = [k for k in kernels_ if not launches.get(k)]
    if idle:
        raise AssertionError(f"kernels never launched {where}: {idle}")


def _oracle_sample(ep, subjects, reqs, look, chk, rng, label: str) -> str:
    """A fixed-seed oracle sample of one lookup batch and one check batch
    of `ep`: FAILOVER_ORACLE_CHECKS checks, and FAILOVER_ORACLE_SUBJECTS
    lookups over the pods they returned and as many others."""
    oracle = ep._oracle
    idx = [int(i) for i in rng.choice(len(reqs), FAILOVER_ORACLE_CHECKS,
                                      replace=False)]
    for i in idx:
        r = reqs[i]
        if chk[i].allowed != oracle.check(r.resource, r.permission,
                                          r.subject):
            raise AssertionError(f"{label}: check {r} differs from the "
                                 f"oracle")
    pods = [p for p in ep.graph().prog.object_ids["pod"] if "\x00" not in p]
    for s in rng.choice(len(subjects), FAILOVER_ORACLE_SUBJECTS,
                        replace=False):
        s = int(s)
        got = set(look[s])
        cand = sorted(got)[:FAILOVER_ORACLE_PODS] + [
            pods[int(i)] for i in rng.choice(len(pods), FAILOVER_ORACLE_PODS,
                                             replace=False)]
        want = _oracle_pods(oracle, cand, subjects[s])
        if want != got & set(cand):
            raise AssertionError(f"{label}: the lookup of {subjects[s]} "
                                 f"differs from the oracle")
    return (f"{FAILOVER_ORACLE_CHECKS} checks and {FAILOVER_ORACLE_SUBJECTS}"
            f" lookups equal to the oracle's")


def failover_path(ctx: dict) -> dict:
    """Phase 20: leader failover at multitenant-1m on phase 19's leader
    (b) and its follower (d), over phase 16's fake apiserver (see the
    module docstring for (a)-(d)).  Returns the launches of (a)-(c) by
    kernel."""
    t_phase = time.perf_counter()
    # what phase 19 no longer needs
    for k in ("text", "tail", "manifest"):
        ctx.pop(k, None)
    gc.collect()
    a = _failover_promote(ctx)
    b = _failover_rejoin(ctx)
    c = _failover_chain(ctx)
    _failover_election(ctx)
    out: dict = {}
    for part in (a, b, c):
        _add(out, part)
    log(f"phase 20 launches: (a) {a}; (b) {b}; (c) {c}")
    log(f"phase 20 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": out}


def _failover_promote(ctx: dict) -> dict:
    """Phase 20 (a): the leader dies and its follower is promoted."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import persist
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.replication import (
        ReplicationHub, failover as replfo)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, parse_relationship)

    on_card = ctx["device"] == "cuda"
    leader, follower, f_ep = ctx["leader"], ctx["follower"], ctx["f_ep"]
    repl, subjects, reqs, ops = (follower.replication, ctx["subjects"],
                                 ctx["reqs"], ctx["ops"])
    w = ctx["w"]
    plan = _churn_plan(w, 1 + FAILOVER_ROUNDS + LEAF_ROUNDS, SEED + 20,
                       tag="f")
    ctx["fplan"] = plan
    asyncio.run(repl.sync_once())
    if repl.store.revision != leader.endpoint.store.revision:
        raise AssertionError("the follower did not catch up before the kill")
    # the old leader acknowledges a round of pod creates it never ships
    unshipped = [wr for wr in plan[0]["writes"]
                 if wr[0][1].startswith("pod:")][:FAILOVER_UNSHIPPED]

    async def ack():
        for wr in unshipped:
            await leader.endpoint.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    asyncio.run(ack())
    ctx["unshipped"] = [r for wr in unshipped for _, r in wr]
    shipped = repl.store.revision
    # the kill: the tail and the write forwarding both lose the leader
    repl.transport = follower._leader_transport = _DeadLink()
    follower.opts.promote_data_dir = os.path.join(ctx["tmp"], "promote")
    follower.opts.wal_fsync = "always"
    stats0 = dict(f_ep.stats)
    split: dict = {}
    admin = follower.get_embedded_client(user="admin",
                                         groups=["system:masters"])
    first = plan[1]
    writes = _durable_writes(first, FAILOVER_ROUND_WRITES)

    async def promote():
        t = time.perf_counter()
        resp = await admin.post("/replication/promote", {})
        t_resp = time.perf_counter()
        await f_ep.write_relationships(
            [RelationshipUpdate(ops[o], parse_relationship(r))
             for o, r in writes[0]])
        return resp, t_resp - t, time.perf_counter() - t

    manager = persist.PersistenceManager
    with _timed_attr(replfo, "mint_promotion_incarnation", split, "mint"), \
            _timed_attr(persist, "PersistenceManager", split, "open"), \
            _timed_attr(manager, "attach", split, "attach"), \
            _timed_attr(manager, "checkpoint", split, "checkpoint"), \
            _timed_attr(ReplicationHub, "attach", split, "hub"):
        resp, t_promote, t_first = asyncio.run(promote())
    if resp.status != 200:
        raise AssertionError(f"promotion answered {resp.status}: "
                             f"{resp.body[:300]!r}")
    info = json.loads(resp.body)
    if (follower.replication is not None or follower.replication_hub is None
            or info["revision"] != shipped
            or info["incarnation"] != leader.replication_hub.incarnation + 2):
        raise AssertionError(f"promotion {info}, shipped {shipped}")
    ctx.update(promoted=follower, p_ep=f_ep, info=info)
    lat = []
    launches: dict = {}
    raw = []
    look = chk = None

    async def rounds():
        nonlocal look, chk
        for n, rnd in enumerate(plan[1:1 + FAILOVER_ROUNDS]):
            for wr in _durable_writes(rnd, FAILOVER_ROUND_WRITES)[
                    1 if n == 0 else 0:]:
                t = time.perf_counter()
                await f_ep.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(r))
                     for o, r in wr])
                lat.append(time.perf_counter() - t)
            f_ep.wait_rebuilds()
            l0 = dict(kernels.LAUNCHES)
            t = time.perf_counter()
            look = await f_ep.lookup_resources_batch("pod", "view", subjects)
            if on_card:
                torch.cuda.synchronize()
            raw.append(time.perf_counter() - t)
            chk = await f_ep.check_bulk_permissions(reqs)
            _add(launches, _launch_delta(l0))

    t0 = time.perf_counter()
    asyncio.run(rounds())
    t1 = time.perf_counter()
    f_ep.wait_rebuilds()
    d = {k: f_ep.stats[k] - stats0[k] for k in
         ("rebuilds", "bg_rebuilds", "preemptive_rebuilds", "stale_routed",
          "delta_batches")}
    if d["rebuilds"] or d["bg_rebuilds"] or d["preemptive_rebuilds"] \
            or d["stale_routed"]:
        raise AssertionError(f"the promoted node rebuilt or went to the "
                             f"oracle: {d}")
    _require_launches(launches, READ_KERNELS + ("scatter_rows",),
                      "on the promoted node")
    sample = _oracle_sample(f_ep, subjects, reqs, look, chk,
                            np.random.default_rng(SEED + 20),
                            "the promoted node")
    t2 = time.perf_counter()
    log(f"phase 20 (a): leader killed {len(unshipped)} acknowledged, "
        f"unshipped writes past shipped revision {shipped}; POST "
        f"/replication/promote {t_promote:.4f} s (epoch mint "
        f"{split['mint']:.4f} s, persistence open {split['open']:.4f} s, "
        f"attach {split['attach']:.4f} s, anchor checkpoint "
        f"{split['checkpoint']:.4f} s, hub attach {split['hub']:.6f} s) "
        f"to incarnation {info['incarnation']} at revision "
        f"{info['revision']}; promotion to the first acknowledged write "
        f"{t_first:.4f} s ({ctx['smi_line']})")
    log(f"phase 20 (a) {FAILOVER_ROUNDS} rounds of {FAILOVER_ROUND_WRITES} "
        f"writes on the promoted node in {t1 - t0:.3f} s, per write "
        f"(journaled, wal_fsync='always') {_pcts(lat)}, max "
        f"{max(lat) * 1e3:.3f} ms; read-after-write lookup batch median "
        f"{statistics.median(raw):.4f} s; counters {d}; launches "
        f"{launches}; {sample} ({t2 - t1:.1f} s)")
    return launches


def _failover_rejoin(ctx: dict) -> dict:
    """Phase 20 (b): the old leader comes back fenced and rejoins."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.replication import (
        INCARNATION_HEADER, LEADER_ID_HEADER, ReplicaFollower,
        failover as replfo)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        parse_relationship)

    on_card = ctx["device"] == "cuda"
    old, promoted = ctx["leader"], ctx["promoted"]
    o_ep, p_ep, subjects, reqs = (ctx["ep"], ctx["p_ep"], ctx["subjects"],
                                  ctx["reqs"])
    hub = promoted.replication_hub
    # the partition heals: a follower's poll carries the new incarnation
    poll = asyncio.run(old.get_embedded_client(user="system:replica").get(
        "/replication/manifest", headers=[
            (INCARNATION_HEADER, str(hub.incarnation)),
            (LEADER_ID_HEADER, hub.leader_id)]))
    fenced = old.replication_hub.fenced_by
    if poll.status != 200 or fenced is None \
            or fenced["incarnation"] != hub.incarnation:
        raise AssertionError(f"the old leader was not fenced: {fenced}")
    write = asyncio.run(old.get_embedded_client(user=ctx["users"][0]).post(
        f"/api/v1/namespaces/{ctx['home'][0]}/pods",
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": "fenced-0", "namespace": ctx["home"][0]}}))
    read = asyncio.run(old.get_embedded_client(user=ctx["users"][0]).get(
        f"/api/v1/namespaces/{ctx['home'][0]}/pods"))
    if write.status != 503 or b"superseded" not in write.body \
            or read.status != 200:
        raise AssertionError(f"fenced old leader: write {write.status}, "
                             f"read {read.status}")
    old_rev = old.endpoint.store.revision
    rebuilds0 = o_ep.stats["rebuilds"]
    split: dict = {}
    syncs = []
    sync_once = ReplicaFollower.sync_once

    async def timed_sync(self, *a, **k):
        t = time.perf_counter()
        try:
            return await sync_once(self, *a, **k)
        finally:
            syncs.append(time.perf_counter() - t)

    ReplicaFollower.sync_once = timed_sync
    try:
        with _timed_attr(replfo, "collect_unshipped_tail", split, "tail"), \
                _timed_attr(replfo, "_peer_json", split, "peer"):
            t0 = time.perf_counter()
            res = asyncio.run(replfo.demote_and_rejoin(
                old, "http://promoted.smoke", _LeaderLink(promoted)))
            t1 = time.perf_counter()
    finally:
        ReplicaFollower.sync_once = sync_once
    n_tail = len(ctx["unshipped"])
    if (res["replayed"] != n_tail or res["skipped_records"]
            or res["reclaimed_window"] or old.replication_hub is not None
            or old.replication is None):
        raise AssertionError(f"rejoin {res}, {n_tail} unshipped updates")
    if old.endpoint.store.revision != p_ep.store.revision:
        raise AssertionError(f"rejoined at {old.endpoint.store.revision}, "
                             f"the new leader at {p_ep.store.revision}")
    # zero lost: the old leader's unshipped creates and the promoted
    # node's writes (each tuple's last op) hold on both nodes
    last: dict = {}
    for rnd in ctx["fplan"][1:1 + FAILOVER_ROUNDS]:
        for wr in _durable_writes(rnd, FAILOVER_ROUND_WRITES):
            for o, r in wr:
                last[r] = o
    for r in ctx["unshipped"]:
        last[r] = "touch"
    for store, who in ((old.endpoint.store, "rejoined node"),
                       (p_ep.store, "new leader")):
        lost = [r for r, o in last.items()
                if store.has_exact(parse_relationship(r)) != (o == "touch")]
        if lost:
            raise AssertionError(f"{len(lost)} acknowledged writes lost on "
                                 f"the {who}: {lost[:3]}")
    l0 = dict(kernels.LAUNCHES)
    t2 = time.perf_counter()
    got = asyncio.run(o_ep.lookup_resources_batch("pod", "view", subjects))
    if on_card:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    again = asyncio.run(o_ep.lookup_resources_batch("pod", "view", subjects))
    if on_card:
        torch.cuda.synchronize()
    t4 = time.perf_counter()
    got_c = asyncio.run(o_ep.check_bulk_permissions(reqs))
    launches = _launch_delta(l0)
    want = asyncio.run(p_ep.lookup_resources_batch("pod", "view", subjects))
    want_c = asyncio.run(p_ep.check_bulk_permissions(reqs))
    if ([sorted(x) for x in got] != [sorted(x) for x in want]
            or [sorted(x) for x in again] != [sorted(x) for x in want]
            or [c.allowed for c in got_c] != [c.allowed for c in want_c]):
        raise AssertionError("the rejoined node's batches differ from the "
                             "new leader's")
    if o_ep.stats["rebuilds"] != rebuilds0 + 1 or o_ep.stats["stale_routed"]:
        raise AssertionError(f"the reset made "
                             f"{o_ep.stats['rebuilds'] - rebuilds0} "
                             f"rebuilds, {o_ep.stats['stale_routed']} "
                             f"oracle reads")
    _require_launches(launches, READ_KERNELS, "on the rejoined node")
    reset_s = syncs[0] if syncs else float("nan")
    log(f"phase 20 (b) old leader (incarnation "
        f"{ctx['info']['incarnation'] - 2}, revision {old_rev}) fenced by a "
        f"poll: its create answered {write.status}, its list "
        f"{read.status}; demote_and_rejoin {t1 - t0:.3f} s (tail "
        f"collection {split['tail']:.4f} s, reset from the new leader's "
        f"checkpoint {reset_s:.3f} s, replay of {res['replayed']} updates "
        f"{split['peer']:.4f} s incl. the manifest probe, catch-up "
        f"{sum(syncs[1:]):.4f} s); revision {old.endpoint.store.revision} "
        f"on both, {len(last)} acknowledged tuples held, none lost; first "
        f"read after the reset (a synchronous graph rebuild on "
        f"{o_ep.device} and the batch) {t3 - t2:.4f} s, the next "
        f"{t4 - t3:.4f} s; launches {launches} ({ctx['smi_line']})")
    return launches


def _failover_chain(ctx: dict) -> dict:
    """Phase 20 (c): the rejoined node relays the log to a leaf."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.replication import (
        failover as replfo)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, parse_relationship)

    on_card = ctx["device"] == "cuda"
    relay, promoted, p_ep = ctx["leader"], ctx["promoted"], ctx["p_ep"]
    subjects, reqs, ops, w = (ctx["subjects"], ctx["reqs"], ctx["ops"],
                              ctx["w"])
    mirror = os.path.join(ctx["tmp"], "mirror")
    # the rejoined node serves replication: a relay over a mirror of
    # what it applies, filled by its re-bootstrap against the new leader
    relay.opts.serve_replication = True
    relay.fanout_hub = replfo.FanoutHub(relay.replication, mirror)
    t0 = time.perf_counter()
    relay.replication.repoint(relay._leader_transport,
                              relay.opts.replicate_from)
    asyncio.run(relay.replication.sync_once())
    t1 = time.perf_counter()
    leaf = ProxyServer(Options(
        spicedb_endpoint=ctx["url"],
        rule_configs=[proxyrule.parse_doc(d) for d in PROXY_READ_RULES],
        bootstrap=Bootstrap(w.schema_text),
        upstream_transport=HandlerTransport(ctx["kube"]),
        prewarm_compiles=True, replicate_from="http://relay.smoke",
        leader_transport=_LeaderLink(relay), replica_id="leaf"))
    lrepl, leaf_ep = leaf.replication, _bare(leaf)
    asyncio.run(lrepl.sync_once())
    t2 = time.perf_counter()
    asyncio.run(leaf.warm_start())
    t3 = time.perf_counter()
    if (lrepl.store.revision != p_ep.store.revision
            or lrepl.upstream_chain["path"][-1] != relay.replica_id):
        raise AssertionError(f"leaf at {lrepl.store.revision} via "
                             f"{lrepl.upstream_chain}")
    warm = []
    for _ in range(N_WARM):
        t = time.perf_counter()
        asyncio.run(leaf_ep.lookup_resources_batch("pod", "view", subjects))
        if on_card:
            torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
    warm_med = statistics.median(warm)
    commit_t, relay_t, leaf_t = {}, {}, {}

    def on_commit(kind, revision, payload):
        commit_t[revision] = time.perf_counter()

    def timed(store, into):
        apply = store.apply_replica_batch

        def wrapped(updates):
            rev = apply(updates)
            into[rev] = time.perf_counter()
            return rev
        store.apply_replica_batch = wrapped

    p_ep.store.add_commit_listener(on_commit)
    timed(relay.replication.store, relay_t)
    timed(lrepl.store, leaf_t)
    launches: dict = {}
    raw = []
    look = chk = None

    async def rounds():
        nonlocal look, chk
        relay.replication.start()
        lrepl.start()
        try:
            for rnd in ctx["fplan"][1 + FAILOVER_ROUNDS:]:
                for wr in _durable_writes(rnd, FAILOVER_ROUND_WRITES):
                    await p_ep.write_relationships(
                        [RelationshipUpdate(ops[o], parse_relationship(r))
                         for o, r in wr])
                rev = p_ep.store.revision
                if not await lrepl.wait_for_revision(rev, 60.0):
                    raise AssertionError(f"the leaf never reached revision "
                                         f"{rev}")
                leaf_ep.wait_rebuilds()
                l0 = dict(kernels.LAUNCHES)
                t = time.perf_counter()
                look = await leaf_ep.lookup_resources_batch("pod", "view",
                                                            subjects)
                if on_card:
                    torch.cuda.synchronize()
                raw.append(time.perf_counter() - t)
                chk = await leaf_ep.check_bulk_permissions(reqs)
                _add(launches, _launch_delta(l0))
                want = await p_ep.lookup_resources_batch("pod", "view",
                                                         subjects)
                if [sorted(x) for x in look] != [sorted(x) for x in want]:
                    raise AssertionError(f"the leaf's lookup batch differs "
                                         f"from the leader's at {rev}")
        finally:
            await lrepl.stop()
            await relay.replication.stop()

    t4 = time.perf_counter()
    asyncio.run(rounds())
    t5 = time.perf_counter()
    p_ep.store.remove_commit_listener(on_commit)
    del relay.replication.store.apply_replica_batch
    del lrepl.store.apply_replica_batch
    hop1 = [relay_t[r] - commit_t[r] for r in commit_t if r in relay_t]
    hop2 = [leaf_t[r] - relay_t[r] for r in relay_t if r in leaf_t]
    chain = [leaf_t[r] - commit_t[r] for r in commit_t if r in leaf_t]
    if not chain or len(chain) != len(hop1):
        raise AssertionError(f"{len(chain)} of {len(commit_t)} commits "
                             f"reached the leaf")
    _require_launches(launches, READ_KERNELS + ("scatter_rows",),
                      "on the leaf")
    if leaf_ep.stats["stale_routed"]:
        raise AssertionError("leaf reads went to the oracle")
    sample = _oracle_sample(leaf_ep, subjects, reqs, look, chk,
                            np.random.default_rng(SEED + 21), "the leaf")
    raw_med = statistics.median(raw)
    mirrored = relay.replication.stats["mirrored_bytes"]
    log(f"phase 20 (c) relay re-bootstrap into its mirror {t1 - t0:.3f} s "
        f"({mirrored} bytes mirrored); leaf bootstrap from the relay "
        f"{t2 - t1:.3f} s, graph build with prewarm {t3 - t2:.3f} s; "
        f"{LEAF_ROUNDS} rounds of {FAILOVER_ROUND_WRITES} writes on the "
        f"leader in {t5 - t4:.1f} s: lag leader->relay {_pcts(hop1)}, "
        f"relay->leaf {_pcts(hop2)}, leader->leaf {_pcts(chain)}, max "
        f"{max(chain) * 1e3:.3f} ms over {len(chain)} commits; leaf "
        f"read-after-write lookup batch median {raw_med:.4f} s vs its warm "
        f"median {warm_med:.4f} s ({raw_med / warm_med:.3f}x; printed, not "
        f"enforced); {sample}; path {lrepl.upstream_chain['path'][1:]}; "
        f"launches {launches} ({ctx['smi_line']})")
    return launches


def _failover_election(ctx: dict) -> None:
    """Phase 20 (d): the leader-loss watchdog's election, on a small
    multitenant store (host logic: the card serves each node's reads)."""
    import shutil
    import tempfile

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    from spicedb_kubeapi_proxy_tpu_torch.models import workloads
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import Bootstrap
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, UpdateOp, parse_relationship)

    small = workloads.multitenant_1m(**ELECTION_WORKLOAD)
    tmp = tempfile.mkdtemp(prefix="smoke-election-")
    kube = FakeKubeApiServer()
    rules = [proxyrule.parse_doc(d) for d in PROXY_READ_RULES]
    common = dict(spicedb_endpoint=ctx["url"], rule_configs=rules,
                  upstream_transport=HandlerTransport(kube))
    leader = ProxyServer(Options(
        bootstrap=Bootstrap(small.schema_text,
                            "\n".join(small.relationships)),
        data_dir=os.path.join(tmp, "leader"), wal_fsync="always", **common))
    links = {u: _LeaderLink(None) for u in ("http://a.smoke",
                                            "http://b.smoke")}
    nodes = {}
    for me, peer in (("a", "b"), ("b", "a")):
        nodes[me] = ProxyServer(Options(
            bootstrap=Bootstrap(small.schema_text),
            replicate_from="http://leader.smoke",
            leader_transport=_LeaderLink(leader), replica_id=f"node-{me}",
            promote_data_dir=os.path.join(tmp, f"p{me}"),
            promote_on_leader_loss=True,
            leader_loss_grace_s=ELECTION_GRACE_S,
            replica_peers=[f"http://{peer}.smoke"],
            peer_transports={f"http://{peer}.smoke":
                             links[f"http://{peer}.smoke"]},
            **common))
    for me in ("a", "b"):
        links[f"http://{me}.smoke"].proxy = nodes[me]
    a, b = nodes["a"], nodes["b"]
    users = small.subjects[:8]

    async def go():
        kube._lock = asyncio.Lock()
        await leader.start()
        await a.start()
        await b.start()
        try:
            for i in range(ELECTION_WRITES):
                await leader.endpoint.write_relationships([RelationshipUpdate(
                    UpdateOp.TOUCH, parse_relationship(
                        f"namespace:ns{i % 50}#viewer@user:{users[i % 8]}"))])
            rev = leader.endpoint.store.revision
            for n in (a, b):
                if not await n.replication.wait_for_revision(rev, 30.0):
                    raise AssertionError("a follower never caught up")
            # b falls behind: its tail pauses while a keeps tailing
            await b.replication.stop()
            for i in range(ELECTION_WRITES):
                await leader.endpoint.write_relationships([RelationshipUpdate(
                    UpdateOp.TOUCH, parse_relationship(
                        f"namespace:ns{50 + i % 50}#viewer@user:"
                        f"{users[i % 8]}"))])
            rev = leader.endpoint.store.revision
            if not await a.replication.wait_for_revision(rev, 30.0):
                raise AssertionError("a never caught up")
            revs = (a.replication.store.revision,
                    b.replication.store.revision)
            # the kill
            t0 = time.perf_counter()
            for n in (a, b):
                n.replication.transport = n._leader_transport = _DeadLink()
            b.replication.start()
            window = a.opts.flight_window_s
            t_a = t_b = None
            while time.perf_counter() - t0 < window:
                if t_a is None and a.replication_hub is not None:
                    t_a = time.perf_counter() - t0
                if (t_b is None and b.replication is not None
                        and b.opts.replicate_from == "http://a.smoke"):
                    t_b = time.perf_counter() - t0
                if t_a is not None and t_b is not None:
                    break
                await asyncio.sleep(0.02)
            if t_a is None or t_b is None or b.replication_hub is not None:
                raise AssertionError(
                    f"no failover within the {window} s flight window: a "
                    f"{a._debug_replication()}, b {b._debug_replication()}")
            rev = await a.endpoint.write_relationships([RelationshipUpdate(
                UpdateOp.TOUCH, parse_relationship(
                    f"namespace:ns0#viewer@user:{users[0]}"))])
            if not await b.replication.wait_for_revision(rev, 30.0):
                raise AssertionError("the loser never followed the winner")
            t_sync = time.perf_counter() - t0
            return revs, t_a, t_b, t_sync, dict(a._watchdog.stats), \
                dict(b._watchdog.stats)
        finally:
            for n in (b, a, leader):
                await n.stop()

    try:
        revs, t_a, t_b, t_sync, wa, wb = asyncio.run(go())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 20 (d) election over replica_peers on a "
        f"{len(small.relationships)}-tuple store, grace "
        f"{ELECTION_GRACE_S} s: node-a at revision {revs[0]} beat node-b at "
        f"{revs[1]}; leader loss to node-a writable {t_a:.3f} s, node-b "
        f"repointed to it {t_b:.3f} s, both within the "
        f"{a.opts.flight_window_s} s flight window; node-b held node-a's "
        f"next write {t_sync:.3f} s after the loss; watchdogs a {wa}, "
        f"b {wb} ({ctx['smi_line']})")
def cli_crash(smi_line: str, device: str = "cuda") -> None:
    """Phase 19 (c): `python3 -m spicedb_kubeapi_proxy_tpu_torch
    --data-dir D --wal-fsync always` on deploy/'s files, as phase 17 (b)
    runs it: one create answered 201, SIGKILL, a restart on D that lists
    the pod and stamps revisions continuing the first process's, and
    SIGTERM to exit 0."""
    import shutil
    import signal
    import tempfile

    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, Headers, HttpServer, Request)

    root = os.path.dirname(os.path.abspath(__file__))
    deploy = os.path.join(root, "deploy")
    tmp = tempfile.mkdtemp(prefix="smoke-cli-crash-")
    data = os.path.join(tmp, "data")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBERNETES_SERVICE")}
    env["PYTHONPATH"] = root

    async def go():
        kube = FakeKubeApiServer()
        kube.seed("", "v1", "namespaces", {"metadata": {"name": "acme-prod"}})
        kube.seed("", "v1", "pods", {"metadata": {
            "name": "api-0", "namespace": "acme-prod"}})
        upstream = HttpServer(kube)
        kport = await upstream.start("127.0.0.1", 0)
        kubeconfig = os.path.join(tmp, "kubeconfig")
        with open(kubeconfig, "w") as f:
            json.dump({"current-context": "smoke",
                       "contexts": [{"name": "smoke", "context": {
                           "cluster": "fake"}}],
                       "clusters": [{"name": "fake", "cluster": {
                           "server": f"http://127.0.0.1:{kport}"}}]}, f)

        async def call(client, method, target, obj=None):
            h = Headers([("X-Remote-User", "ada"),
                         ("Accept", "application/json")])
            body = b""
            if obj is not None:
                body = json.dumps(obj).encode()
                h.set("Content-Type", "application/json")
            return await client.round_trip(Request(method, target,
                                                   headers=h, body=body))

        async def spawn():
            port = _free_port()
            argv = [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch",
                    "--embedded-mode", "--bind-address", "127.0.0.1",
                    "--secure-port", str(port), "--backend-kubeconfig",
                    kubeconfig, "--no-override-upstream", "--rule-config",
                    os.path.join(deploy, "rules.yaml"),
                    "--spicedb-bootstrap",
                    os.path.join(deploy, "bootstrap.yaml"),
                    "--data-dir", data, "--wal-fsync", "always", "-v", "2"]
            if device != "cuda":
                argv += ["--spicedb-endpoint", f"torch://?device={device}"]
            t = time.perf_counter()
            proc = await asyncio.create_subprocess_exec(
                *argv, cwd=root, env=env, stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.PIPE)
            client = H11Transport(f"http://127.0.0.1:{port}")
            while True:
                if proc.returncode is not None:
                    raise AssertionError(f"the command exited "
                                         f"{proc.returncode} before it "
                                         f"served")
                if time.perf_counter() - t > CLI_READY_S:
                    proc.kill()
                    await proc.wait()
                    raise AssertionError("the command never answered "
                                         "/readyz")
                try:
                    if (await call(client, "GET", "/readyz")).status == 200:
                        return proc, client, time.perf_counter() - t
                except OSError:
                    pass
                await asyncio.sleep(0.25)

        pods = "/api/v1/namespaces/acme-prod/pods"
        seen = {}
        procs = []
        try:
            proc, client, seen["ready1"] = await spawn()
            procs.append(proc)
            resp = await call(client, "POST", pods, {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "api-9", "namespace": "acme-prod"}})
            seen["create"] = resp.status
            seen["rev1"] = int(resp.headers.get("X-Authz-Revision") or -1)
            proc.send_signal(signal.SIGKILL)
            await proc.wait()
            seen["killed"] = proc.returncode
            proc, client, seen["ready2"] = await spawn()
            procs.append(proc)
            resp = await call(client, "GET", pods)
            seen["listed"] = sorted(i["metadata"]["name"]
                                    for i in json.loads(resp.body)["items"])
            seen["rev2"] = int(resp.headers.get("X-Authz-Revision") or -1)
            resp = await call(client, "POST", pods, {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "api-10", "namespace": "acme-prod"}})
            seen["create2"] = resp.status
            seen["rev3"] = int(resp.headers.get("X-Authz-Revision") or -1)
        finally:
            for p in procs:
                if p.returncode is None:
                    p.send_signal(signal.SIGTERM)
            t = time.perf_counter()
            stderr = b""
            for p in procs:
                try:
                    _, err = await asyncio.wait_for(p.communicate(),
                                                    CLI_STOP_S)
                    stderr = err or stderr
                except asyncio.TimeoutError:
                    p.kill()
                    await p.wait()
                    raise AssertionError(f"the command outlived SIGTERM "
                                         f"by {CLI_STOP_S} s") from None
            seen["stop"] = time.perf_counter() - t
            await upstream.stop()
        return seen, procs[-1].returncode, stderr.decode()

    try:
        seen, rc, stderr = asyncio.run(go())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if (seen["create"] != 201 or seen["killed"] != -signal.SIGKILL
            or seen["listed"] != ["api-0", "api-9"]
            or seen["rev2"] < seen["rev1"] or seen["create2"] != 201
            or seen["rev3"] <= seen["rev2"]):
        raise AssertionError(f"the crashed command answered {seen}; stderr "
                             f"tail {stderr[-2000:]}")
    if rc != 0 or "Traceback" in stderr or \
            "recovered store at revision" not in stderr:
        raise AssertionError(f"the restarted command exited {rc}; stderr "
                             f"tail {stderr[-2000:]}")
    log(f"phase 19 (c) python -m spicedb_kubeapi_proxy_tpu_torch --data-dir "
        f"--wal-fsync always: ready in {seen['ready1']:.2f} s, create 201 "
        f"at revision {seen['rev1']}, SIGKILL; restart ready in "
        f"{seen['ready2']:.2f} s, the pod listed at revision {seen['rev2']},"
        f" the next create at {seen['rev3']}; SIGTERM to exit 0 in "
        f"{seen['stop']:.2f} s ({smi_line})")


# -- phase 21, tuple-space sharding --------------------------------------------


def shard1_relationships(n_configmaps: int, n_secrets: int,
                         n_namespaces: int, n_users: int,
                         seed: int) -> tuple:
    """Shard 1's tuples (the reference bench's write-shard-scale classes,
    bench.py:1338-1349, at phase 21's size): `cfgns`/`configmap` and
    `secns`/`secret`, each namespace type with `n_namespaces` ids (the
    kube namespaces ns0..), one creator a namespace and one a configmap
    or secret, drawn from u0..u{n_users - 1}.  Built as Relationship
    objects (no string parse).  Returns (relationships, the creator of
    each cfgns id, the creator of each configmap id)."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        ObjectRef, Relationship, SubjectRef)

    rng = np.random.default_rng(seed)
    users = [SubjectRef("user", f"u{i}") for i in range(n_users)]
    rels, cfg_creator, cm_creator = [], {}, {}
    for ns_type, draw in (("cfgns", cfg_creator), ("secns", None)):
        for k, u in enumerate(rng.integers(0, n_users, n_namespaces)):
            rels.append(Relationship(ObjectRef(ns_type, f"ns{k}"), "creator",
                                     users[int(u)]))
            if draw is not None:
                draw[f"ns{k}"] = f"u{int(u)}"
    for typ, prefix, n, draw in (("configmap", "cm", n_configmaps,
                                  cm_creator),
                                 ("secret", "sec", n_secrets, None)):
        for i, u in enumerate(rng.integers(0, n_users, n)):
            oid = f"ns{i % n_namespaces}/{prefix}{i}"
            rels.append(Relationship(ObjectRef(typ, oid), "creator",
                                     users[int(u)]))
            if draw is not None:
                draw[oid] = f"u{int(u)}"
    return rels, cfg_creator, cm_creator


def _shard_rules() -> list:
    """Phase 21's rules: deploy/rules.yaml's pod read rules and its
    pod-launch create (PROXY_READ_RULES, DUALWRITE_RULES), list and get
    rules for configmaps and secrets in the shape of the reference test's
    list-pods prefilter rule (tests/test_tuple_sharding.py:111-119), and
    the reference bench's configmap create and delete rules
    (bench.py:1350-1373)."""
    rules = [r for r in PROXY_READ_RULES
             if r["metadata"]["name"] in ("pod-read", "pod-enumerate")]
    rules.append(DUALWRITE_RULES[0])
    for res, typ in (("configmaps", "configmap"), ("secrets", "secret")):
        rules.append({**_RULE, "metadata": {"name": f"list-{res}"},
                      "match": [{"apiVersion": "v1", "resource": res,
                                 "verbs": ["list"]}],
                      "prefilter": [{
                          "fromObjectIDNamespaceExpr":
                              "{{split_namespace(resourceId)}}",
                          "fromObjectIDNameExpr": "{{split_name(resourceId)}}",
                          "lookupMatchingResources": {
                              "tpl": f"{typ}:$#view@user:{{{{user.name}}}}"}}]})
        rules.append({**_RULE, "metadata": {"name": f"get-{res}"},
                      "match": [{"apiVersion": "v1", "resource": res,
                                 "verbs": ["get"]}],
                      "check": [{"tpl": f"{typ}:{{{{namespacedName}}}}#view"
                                        f"@user:{{{{user.name}}}}"}]})
    rules.append({**_RULE, "metadata": {"name": "create-configmaps"},
                  "lock": "Optimistic",
                  "match": [{"apiVersion": "v1", "resource": "configmaps",
                             "verbs": ["create"]}],
                  "check": [{"tpl": "cfgns:{{namespace}}#view"
                                    "@user:{{user.name}}"}],
                  "update": {"creates": [{
                      "tpl": "configmap:{{namespacedName}}#creator"
                             "@user:{{user.name}}"}]}})
    rules.append({**_RULE, "metadata": {"name": "delete-configmaps"},
                  "lock": "Optimistic",
                  "match": [{"apiVersion": "v1", "resource": "configmaps",
                             "verbs": ["delete"]}],
                  "update": {"deleteByFilter": [{
                      "tpl": "configmap:{{namespacedName}}#$resourceRelation"
                             "@$subjectType:$subjectID"}]}})
    return rules


def _oracle_ids(oracle, rtype: str, ids, subject) -> set:
    """The oracle's answer for `subject` over the `rtype` objects `ids`:
    its check of each, one memo shared by all (as `_oracle_pods`)."""
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.evaluator import YES, _Ctx
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import ObjectRef
    ctx = _Ctx()
    return {i for i in ids
            if oracle._check(ObjectRef(rtype, i), "view", subject, 0,
                             ctx) == YES}


def _shard_eps(proxy) -> list:
    """The TorchEndpoint of each shard under a sharded proxy's wrappers."""
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        TorchEndpoint)
    out = []
    for ep in _sharded(proxy).shards:
        while not isinstance(ep, TorchEndpoint):
            ep = ep.inner
        out.append(ep)
    return out


def _record_lookup_types(ep) -> tuple:
    """Record the resource type of every lookup `ep` (a shard's
    TorchEndpoint, under its dispatcher) runs: (the set it fills, a
    function that removes the recording)."""
    seen: set = set()
    names = ("lookup_resources_batch_start", "lookup_resources_batch",
             "lookup_resources")
    for name in names:
        inner = getattr(ep, name)

        async def rec(resource_type, *a, _inner=inner, **k):
            seen.add(resource_type)
            return await _inner(resource_type, *a, **k)
        setattr(ep, name, rec)

    def undo():
        for name in names:
            delattr(ep, name)
    return seen, undo


def _sharded(proxy):
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding import (
        ShardedEndpoint)
    ep = proxy.endpoint
    while not isinstance(ep, ShardedEndpoint):
        ep = ep.inner
    return ep


def shard_path(w, smi_line: str, device: str = "cuda",
               keep: bool = False) -> dict:
    """Phase 21: a two-shard deployment at full width on the card.

    Shard 0 holds multitenant-1m uncut (`w`; its group, tenant, namespace
    and pod types are one co-location class); shard 1 holds the
    reference bench's write-shard-scale classes (`shard1_relationships`:
    SHARD_CONFIGMAPS configmaps and SHARD_SECRETS secrets over
    SHARD_NAMESPACES namespaces of each of cfgns and secns), under the
    map SHARD_MAP (0 SL007 errors).  The upstream is phase 16's fake
    apiserver plus SHARD_KUBE_CONFIGMAPS configmaps, the rules
    `_shard_rules()`.  The oracle is the port's Evaluator over one store
    holding both shards' tuples, kept equal to them by their delta
    listeners.

    (a) `ProxyServer(Options(shards=2, partition_map=SHARD_MAP,
    spicedb_endpoint="torch://", data_dir=...))`, both shard stores
    loaded (journaled) and each shard's graph built and prewarmed; the
    HBM ledger of the two generations at least 90 % of the memory the
    phase allocated.  (b) One burst of SHARD_LISTS pod lists and as many
    configmap lists: every list equals its shard's direct lookup of the
    same user, and SHARD_ORACLE_LISTS of each type the oracle's; each
    shard's dispatcher fused lookups of its own type only; the routed counter
    counts both shards.  (c) SHARD_CREATES pod creates and as many
    configmap creates at once, dual writes through the worker: each lands
    on its owning shard and no batch of the other type commits on a
    shard; the tokens are revision vectors and a list carrying its token
    reads its write; a token one revision ahead on shard 1 gets 503 (the
    in-process gate refuses a token ahead on any shard, as the
    reference's does; (g) shows the per-shard split through the router);
    read-after-write lists equal the oracle; `scatter_rows` runs on each
    graph.  (d) A check_bulk_permissions of SHARD_BULK_CHECKS mixed pairs
    in request order equal to the oracle; an untyped read fanning out; a
    spanning batch refused; a merged watch; a forced background rebuild
    of shard 1 during a pod burst on shard 0, every answer right.  (e)
    The proxy dropped without a final checkpoint and rebuilt on the data
    dir: both lineages recover, both graphs warm-start, the first lists
    equal the oracle.  (f) SHARD_SPANNING_MAP raises RouterConfigError
    before any graph is built.  Returns the launches of (b)-(d), counted
    from zero, and the phase's seconds; with `keep`, also what phase 23
    boots its shard-leader processes from (`out["fleet"]`: the temporary
    directory, left for the caller to remove, with the lineages under
    `data/shard-<k>`, the fake apiserver, the oracle, the schema, the
    rules and the user count)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.config import proxyrule
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        HandlerTransport)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        Options, ProxyServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb import schema as sch
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, merge_internal_definitions)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.evaluator import Evaluator
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.replication import (
        MIN_REVISION_HEADER, REVISION_HEADER)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding import (
        CrossShardWriteError, MergedWatcher, PartitionMap, RevisionVector,
        RouterConfigError)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding import (
        metrics as shard_metrics)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.store import TupleStore
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, RelationshipFilter, RelationshipUpdate,
        SubjectFilter, SubjectRef, UpdateOp, parse_relationship)
    from spicedb_kubeapi_proxy_tpu_torch.utils import devtel

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    _switch(True)   # the port's default rebuild path
    rng = np.random.default_rng(SEED + 21)
    schema_text = w.schema_text + SHARD_SCHEMA
    schema = merge_internal_definitions(sch.parse_schema(schema_text))
    rules = [proxyrule.parse_doc(d) for d in _shard_rules()]
    pmap = PartitionMap.parse(SHARD_MAP, n_shards=2)
    errors, warnings = pmap.validate_schema(schema, rules)
    if errors or warnings:
        raise AssertionError(f"{SHARD_MAP}: SL007 {errors}, SL008 {warnings}")
    n_users = len(w.subjects)
    t0 = time.perf_counter()
    rels0 = [parse_relationship(r) for r in w.relationships]
    rels1, cfg_creator, cm_creator = shard1_relationships(
        SHARD_CONFIGMAPS, SHARD_SECRETS, SHARD_NAMESPACES, n_users, SEED + 21)
    union = TupleStore()
    union.bulk_load(rels0 + rels1)
    oracle = Evaluator(schema, union)
    t_data = time.perf_counter() - t0

    kube = _seed_proxy_kube(PROXY_NAMESPACES, PROXY_PODS, PROXY_EVENTS)
    for c in range(SHARD_KUBE_CONFIGMAPS):
        kube.seed("", "v1", "configmaps", {"metadata": {
            "name": f"cm{c}", "namespace": f"ns{c % SHARD_NAMESPACES}"}})
    seeded_pods = [f"ns{p % PROXY_NAMESPACES}/p{p}" for p in range(PROXY_PODS)]
    seeded_cms = [f"ns{c % SHARD_NAMESPACES}/cm{c}"
                  for c in range(SHARD_KUBE_CONFIGMAPS)]
    tmp = tempfile.mkdtemp(prefix="smoke-shards-")
    url = "torch://" if on_card else f"torch://?device={device}"
    opts = dict(spicedb_endpoint=url, rule_configs=rules,
                bootstrap=Bootstrap(schema_text=schema_text),
                upstream_transport=HandlerTransport(kube),
                prewarm_compiles=True, shards=2, partition_map=SHARD_MAP,
                data_dir=os.path.join(tmp, "data"), wal_fsync="always",
                workflow_database_path=os.path.join(tmp, "wf.db"))
    out: dict = {"phase_s": {}}
    try:
        # (a) build: the proxy, both stores loaded, each graph built and
        # prewarmed on its own
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        alloc0 = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        proxy = ProxyServer(Options(**opts))
        proxy.enable_dual_writes()
        sharded = _sharded(proxy)
        stores = sharded.shard_stores()
        t1 = time.perf_counter()
        load_s, ckpt_s = [], []
        for st, rels, mgr in zip(stores, (rels0, rels1),
                                 proxy._shard_persistence):
            t = time.perf_counter()
            st.bulk_load(rels)
            load_s.append(time.perf_counter() - t)
            # each lineage's checkpoint, as its periodic loop would take
            # one: (e)'s recovery is the checkpoint and the WAL tail
            t = time.perf_counter()
            mgr.checkpoint()
            ckpt_s.append(time.perf_counter() - t)
        eps = _shard_eps(proxy)
        build_s, prewarm_s = [], []
        for ep in eps:
            t = time.perf_counter()
            ep.warm_start(prewarm=False)
            build_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            ep.warm_start(prewarm=True)
            prewarm_s.append(time.perf_counter() - t)
            if ep.device.type != torch.device(device).type:
                raise AssertionError(f"shard endpoint on {ep.device}")
        if on_card:
            torch.cuda.synchronize()
        gens = [ep._devtel_gen for ep in eps]
        ledger = [devtel.LEDGER.generation_bytes(g) for g in gens]
        alloc = (torch.cuda.memory_allocated() - alloc0) if on_card else 0
        share = sum(ledger) / alloc if alloc else None
        if on_card and share < 0.90:
            raise AssertionError(f"the HBM ledger holds {sum(ledger)} of "
                                 f"{alloc} bytes allocated by the phase "
                                 f"({share:.3f} < 0.90)")
        sizes = [st.revision for st in stores]
        log(f"phase 21 (a) data {t_data:.3f} s ({len(rels0)} + {len(rels1)} "
            f"tuples, the oracle's union store); ProxyServer(shards=2, "
            f"partition_map={SHARD_MAP!r}, {url!r}, data_dir) "
            f"{t1 - t0:.3f} s; journaled loads "
            + ", ".join(f"shard {k} {s:.3f} s" for k, s in
                        enumerate(load_s))
            + "; checkpoints " + ", ".join(f"shard {k} {s:.3f} s" for k, s
                                           in enumerate(ckpt_s))
            + "; graph build " + ", ".join(f"shard {k} {s:.3f} s" for k, s
                                           in enumerate(build_s))
            + "; prewarm " + ", ".join(f"shard {k} {s:.3f} s" for k, s
                                       in enumerate(prewarm_s))
            + "; HBM ledger " + ", ".join(f"shard {k} {b} bytes" for k, b
                                          in enumerate(ledger))
            + (f", {share * 100:.2f} % of the {alloc} bytes the phase "
               f"allocated" if share is not None else "")
            + f"; revisions {sizes} ({smi_line})")
        out["phase_s"]["a"] = time.perf_counter() - t_phase

        # the oracle follows both shards' commits
        def mirror(update):
            union.write([RelationshipUpdate(
                UpdateOp.DELETE if u.op == UpdateOp.DELETE else
                UpdateOp.TOUCH, u.rel) for u in update.updates])

        committed = ([], [])

        def on_commit(k):
            def fn(update):
                committed[k].append({u.rel.resource.type
                                     for u in update.updates})
                mirror(update)
            return fn

        listeners = [on_commit(k) for k in range(2)]
        for st, fn in zip(stores, listeners):
            st.add_delta_listener(fn)

        async def call(user, method, target, obj=None, headers=None):
            client = proxy.get_embedded_client(user=user)
            body = json.dumps(obj).encode() if obj is not None else b""
            t = time.perf_counter()
            resp = await client.request(method, target, body=body,
                                        headers=headers)
            return resp, time.perf_counter() - t

        def listed(resp) -> set:
            if resp.status != 200:
                raise AssertionError(f"list answered {resp.status}: "
                                     f"{resp.body[:300]!r}")
            return {f"{i['metadata']['namespace']}/{i['metadata']['name']}"
                    for i in json.loads(resp.body)["items"]}

        def fused():
            return [(s.get("fused_lookups", 0), s.get("fused_checks", 0))
                    for s in sharded.shard_stats()]

        # (b) one burst of pod lists and configmap lists
        pod_users = [f"u{i}" for i in range(SHARD_LISTS)]
        cm_users = []
        for oid in seeded_cms:
            u = cm_creator[oid]
            if u not in cm_users:
                cm_users.append(u)
            if len(cm_users) == SHARD_LISTS:
                break
        routed0 = dict(shard_metrics._routed.snapshot())
        fused0 = fused()
        recorders = [_record_lookup_types(ep) for ep in eps]
        kernels.reset_launches()
        kube._lock = asyncio.Lock()

        async def burst_b():
            t = time.perf_counter()
            res = await asyncio.gather(
                *(call(u, "GET", "/api/v1/pods") for u in pod_users),
                *(call(u, "GET", "/api/v1/configmaps") for u in cm_users))
            return res, time.perf_counter() - t

        try:
            res, b_wall = asyncio.run(burst_b())
        finally:
            for _, undo in recorders:
                undo()
        fused1 = fused()
        routed1 = dict(shard_metrics._routed.snapshot())
        pod_lists = [listed(r) for r, _ in res[:SHARD_LISTS]]
        cm_lists = [listed(r) for r, _ in res[SHARD_LISTS:]]
        # every list against its shard's direct lookup of the same user,
        # a sample of them against the oracle
        t_or = time.perf_counter()
        for typ, ep_k, users, lists, pool in (
                ("pod", eps[0], pod_users, pod_lists, seeded_pods),
                ("configmap", eps[1], cm_users, cm_lists, seeded_cms)):
            direct = asyncio.run(ep_k.lookup_resources_batch(
                typ, "view", [SubjectRef("user", u) for u in users]))
            pool_set = set(pool)
            for i, (u, got, ids) in enumerate(zip(users, lists, direct)):
                if got != set(ids) & pool_set or (typ == "configmap"
                                                  and not got):
                    raise AssertionError(f"{u}'s {typ} list ({len(got)}) "
                                         f"differs from the shard's lookup")
                if i < SHARD_ORACLE_LISTS and got != _oracle_ids(
                        oracle, typ, pool, SubjectRef("user", u)):
                    raise AssertionError(f"{u}'s {typ} list ({len(got)}) "
                                         f"differs from the oracle's")
        oracle_b_s = time.perf_counter() - t_or
        d_fused = [(a1 - a0, c1 - c0) for (a0, c0), (a1, c1)
                   in zip(fused0, fused1)]
        if d_fused[0][0] < 1 or d_fused[1][0] < 1:
            raise AssertionError(f"fused lookups by shard {d_fused}: a "
                                 f"shard's graph served no burst")
        lr_types = [sorted(seen) for seen, _ in recorders]
        if lr_types != [["pod"], ["configmap"]]:
            raise AssertionError(f"lookups by shard {lr_types}: a shard "
                                 f"served a type it does not own")
        d_routed = {k: routed1.get(k, 0) - routed0.get(k, 0)
                    for k in set(routed1) | set(routed0)}
        if not (d_routed.get(("0",), 0) >= SHARD_LISTS
                and d_routed.get(("1",), 0) >= SHARD_LISTS):
            raise AssertionError(f"authz_shard_routed_total moved by "
                                 f"{d_routed}")
        pod_lat = [s for _, s in res[:SHARD_LISTS]]
        cm_lat = [s for _, s in res[SHARD_LISTS:]]
        log(f"phase 21 (b) {SHARD_LISTS} pod lists + {SHARD_LISTS} configmap "
            f"lists at once: wall {b_wall:.4f} s; pods {_pcts(pod_lat)}, "
            f"configmaps {_pcts(cm_lat)}; items per pod list median "
            f"{int(np.median([len(x) for x in pod_lists]))}, per configmap "
            f"list median {int(np.median([len(x) for x in cm_lists]))}; "
            f"all {2 * SHARD_LISTS} equal their shard's direct lookup, "
            f"{2 * SHARD_ORACLE_LISTS} the oracle's ({oracle_b_s:.1f} s); "
            f"fused (lookups, checks) by shard {d_fused}, lookup types by "
            f"shard {lr_types}; authz_shard_routed_total moved {d_routed}; "
            f"launches so far { {k: v for k, v in kernels.LAUNCHES.items() if v} } "
            f"({smi_line})")
        out["phase_s"]["b"] = time.perf_counter() - t_phase

        # (c) dual writes on both shards at once, through the worker
        ns_lists = asyncio.run(eps[0].lookup_resources_batch(
            "namespace", "view", [SubjectRef("user", u) for u in pod_users]))
        pod_home = []
        for u, ids in zip(pod_users[:SHARD_CREATES], ns_lists):
            if not ids:
                raise AssertionError(f"{u} may view no namespace")
            pod_home.append(sorted(ids)[int(rng.integers(len(ids)))])
        cm_home = [f"ns{k}" for k in range(SHARD_CREATES)]
        cm_makers = [cfg_creator[ns] for ns in cm_home]
        stats_keys = ("rebuilds", "bg_rebuilds", "preemptive_rebuilds",
                      "delta_batches", "flush_s", "stale_routed")
        stats0 = [{k: ep.stats[k] for k in stats_keys} for ep in eps]
        fused_c0 = fused()
        revs0 = [st.revision for st in stores]
        n_commit0 = [len(c) for c in committed]

        def obj(kind, ns, name):
            return {"apiVersion": "v1", "kind": kind,
                    "metadata": {"name": name, "namespace": ns}}

        marks: dict = {}

        async def writes():
            kube._lock = asyncio.Lock()
            await proxy._worker.start()
            try:
                t = time.perf_counter()
                res = await asyncio.gather(
                    *(call(u, "POST", f"/api/v1/namespaces/{ns}/pods",
                           obj("Pod", ns, f"sp-{i}"))
                      for i, (u, ns) in enumerate(zip(pod_users, pod_home))),
                    *(call(u, "POST", f"/api/v1/namespaces/{ns}/configmaps",
                           obj("ConfigMap", ns, f"sc-{i}"))
                      for i, (u, ns) in enumerate(zip(cm_makers, cm_home))))
                marks["wall"] = time.perf_counter() - t
                marks["res"] = res
                bad = [(r.status, r.body[:200]) for r, _ in res
                       if r.status != 201]
                if bad:
                    raise AssertionError(f"{len(bad)} creates failed: "
                                         f"{bad[:3]}")
                marks["revs"] = [st.revision for st in stores]
                # read your write: each creator's list of its namespace,
                # carrying its create's token
                reads = []
                for i, ((r, _), u, ns, res_name) in enumerate(zip(
                        res, pod_users[:SHARD_CREATES] + cm_makers,
                        pod_home + cm_home,
                        ["pods"] * SHARD_CREATES
                        + ["configmaps"] * SHARD_CREATES)):
                    tok = r.headers.get(REVISION_HEADER)
                    reads.append(call(u, "GET",
                                      f"/api/v1/namespaces/{ns}/{res_name}",
                                      headers=[(MIN_REVISION_HEADER, tok)]))
                t = time.perf_counter()
                marks["reads"] = await asyncio.gather(*reads)
                marks["read_wall"] = time.perf_counter() - t
                # the in-process vector gate
                v = sharded.revision_vector()
                ahead = v.merged(1, v.component(1) + 1).encode()
                marks["gate"] = [
                    (await call(cm_makers[0], "GET",
                                f"/api/v1/namespaces/{cm_home[0]}/configmaps",
                                headers=[(MIN_REVISION_HEADER, ahead)]))[0],
                    (await call(pod_users[0], "GET",
                                f"/api/v1/namespaces/{pod_home[0]}/pods",
                                headers=[(MIN_REVISION_HEADER, ahead)]))[0],
                    (await call(pod_users[0], "GET",
                                f"/api/v1/namespaces/{pod_home[0]}/pods",
                                headers=[(MIN_REVISION_HEADER,
                                          f"0:{v.component(0)}")]))[0]]
            finally:
                await proxy._worker.stop()

        asyncio.run(writes())
        d_fused_c = [(a1 - a0, c1 - c0) for (a0, c0), (a1, c1)
                     in zip(fused_c0, fused())]
        if min(c for _, c in d_fused_c) < 1:
            raise AssertionError(f"fused (lookups, checks) by shard in (c) "
                                 f"{d_fused_c}: a shard's graph checked no "
                                 f"create")
        res = marks["res"]
        tokens = [RevisionVector.decode(r.headers.get(REVISION_HEADER))
                  for r, _ in res]
        if not all(t.parts and set(t.parts) == {0, 1} for t in tokens):
            raise AssertionError(f"response tokens {[t.encode() for t in tokens[:4]]} "
                                 f"are not revision vectors")
        pod_names = {f"{ns}/sp-{i}" for i, ns in enumerate(pod_home)}
        cm_names = {f"{ns}/sc-{i}" for i, ns in enumerate(cm_home)}
        for k, (typ, names) in enumerate((("pod", pod_names),
                                          ("configmap", cm_names))):
            here = {r.resource.id for r in stores[k].read(RelationshipFilter(
                resource_type=typ, relation="creator")) if r.resource.id in
                names}
            there = stores[1 - k].read(RelationshipFilter(resource_type=typ))
            if here != names or there:
                raise AssertionError(f"{typ} creates: {len(here)} of "
                                     f"{len(names)} on shard {k}, "
                                     f"{len(there)} on shard {1 - k}")
        foreign = ({"configmap", "cfgns", "secret", "secns"},
                   {"pod", "namespace", "tenant", "group"})
        for k in range(2):
            leaked = [t for t in committed[k][n_commit0[k]:]
                      if t & foreign[k]]
            if leaked:
                raise AssertionError(f"shard {k} committed batches of "
                                     f"another shard's types: {leaked[:3]}")
        d_rev = [b - a for a, b in zip(revs0, marks["revs"])]
        d_batches = [len(c) - n for c, n in zip(committed, n_commit0)]
        if min(d_rev) < SHARD_CREATES:
            raise AssertionError(f"revisions moved {d_rev}, batches "
                                 f"committed {d_batches}")
        missing = []
        for i, ((r, _), ns, name) in enumerate(zip(
                marks["reads"], pod_home + cm_home,
                [f"sp-{i}" for i in range(SHARD_CREATES)]
                + [f"sc-{i}" for i in range(SHARD_CREATES)])):
            if f"{ns}/{name}" not in listed(r):
                missing.append(f"{ns}/{name}")
        if missing:
            raise AssertionError(f"{len(missing)} lists with their token "
                                 f"miss their write: {missing[:3]}")
        gate = [r.status for r in marks["gate"]]
        if gate != [503, 503, 200]:
            raise AssertionError(f"the vector gate answered {gate}, want "
                                 f"[503, 503, 200]")
        # read-after-write lists equal the oracle
        kube_pods = {f"{ns}/{n}" for (ns, n) in (
            (ns, n) for ns, objs in kube.objects[("", "v1", "pods")].items()
            for n in objs)}
        kube_cms = {f"{ns}/{n}" for (ns, n) in (
            (ns, n) for ns, objs in kube.objects[
                ("", "v1", "configmaps")].items() for n in objs)}
        for i, ((r, _), u, ns) in enumerate(zip(
                marks["reads"], pod_users[:SHARD_CREATES] + cm_makers,
                pod_home + cm_home)):
            typ, pool = (("pod", kube_pods) if i < SHARD_CREATES
                         else ("configmap", kube_cms))
            want = _oracle_ids(oracle, typ, [p for p in pool
                                             if p.startswith(ns + "/")],
                               SubjectRef("user", u))
            if listed(r) != want:
                raise AssertionError(f"read-after-write {typ} list of {u} in "
                                     f"{ns} differs from the oracle")
        for ep in eps:
            ep.wait_rebuilds()
        stats1 = [{k: ep.stats[k] for k in stats_keys} for ep in eps]
        d_stats = [{k: round(s1[k] - s0[k], 6) for k in stats_keys}
                   for s0, s1 in zip(stats0, stats1)]
        if any(d["stale_routed"] for d in d_stats):
            raise AssertionError(f"reads routed to the oracle: {d_stats}")
        if any(d["delta_batches"] < 1 or d["rebuilds"] for d in d_stats):
            raise AssertionError(f"a shard absorbed no delta or rebuilt "
                                 f"synchronously: {d_stats}")
        # scatter_rows on each graph: one write on one shard, then a read
        # of it, launches counted from zero
        scatter = []
        for k, (ep, rel, rtype, subj) in enumerate((
                (eps[0], f"pod:{pod_home[0]}/sp-0#creator@user:u{SHARD_LISTS}",
                 "pod", f"u{SHARD_LISTS}"),
                (eps[1], f"configmap:{cm_home[0]}/sc-0#creator"
                         f"@user:u{SHARD_LISTS}", "configmap",
                 f"u{SHARD_LISTS}"))):
            base = dict(kernels.LAUNCHES)
            asyncio.run(sharded.write_relationships([RelationshipUpdate(
                UpdateOp.TOUCH, parse_relationship(rel))]))
            ids = asyncio.run(sharded.lookup_resources(
                rtype, "view", SubjectRef("user", subj)))
            n = kernels.LAUNCHES["scatter_rows"] - base["scatter_rows"]
            scatter.append(n)
            if rel.split("#")[0].split(":", 1)[1] not in ids or (
                    on_card and n < 1):
                raise AssertionError(f"shard {k}: scatter_rows {n}, the "
                                     f"write seen {ids[:3]}")
        log(f"phase 21 (c) {SHARD_CREATES} pod + {SHARD_CREATES} configmap "
            f"creates at once, the worker running them: wall "
            f"{marks['wall']:.4f} s, {_pcts([s for _, s in res])}; each on "
            f"its owning shard (revisions moved {d_rev}, batches committed "
            f"{d_batches}, none of a foreign type); tokens like "
            f"{tokens[0].encode()!r}, {tokens[-1].encode()!r}; "
            f"{2 * SHARD_CREATES} lists with their token read their write "
            f"(wall {marks['read_wall']:.4f} s) and equal the oracle; "
            f"vector gate: shard 1 ahead -> configmaps {gate[0]}, pods "
            f"{gate[1]} (any shard ahead refuses, as the reference's "
            f"in-process gate), pods with the shard-0 component only "
            f"{gate[2]}; fused (lookups, checks) by shard {d_fused_c}; "
            f"scatter_rows by shard {scatter}; stats moved by "
            f"shard {d_stats} ({smi_line})")
        out["phase_s"]["c"] = time.perf_counter() - t_phase

        # (d) fan-out and isolation
        pods_all = [p for p in eps[0].graph().prog.object_ids["pod"]
                    if "\x00" not in p]
        cms_all = [c for c in eps[1].graph().prog.object_ids["configmap"]
                   if "\x00" not in c]
        subs = [SubjectRef("user", f"u{int(i)}")
                for i in rng.integers(0, n_users, 256)]
        pairs = []
        for i in range(SHARD_BULK_CHECKS):
            pool, typ = ((pods_all, "pod") if rng.random() < 0.5
                         else (cms_all, "configmap"))
            pairs.append(CheckRequest(ObjectRef(typ, pool[int(
                rng.integers(len(pool)))]), "view",
                subs[int(rng.integers(len(subs)))]))
        # a quarter of the configmap pairs by their creators: allowed
        for i in range(0, SHARD_BULK_CHECKS, 8):
            r = pairs[i]
            if r.resource.type == "configmap":
                u = cm_creator.get(r.resource.id)
                if u is not None:
                    pairs[i] = CheckRequest(r.resource, "view",
                                            SubjectRef("user", u))
        t = time.perf_counter()
        got = asyncio.run(sharded.check_bulk_permissions(pairs))
        bulk_s = time.perf_counter() - t
        want = [oracle.check(r.resource, r.permission, r.subject)
                for r in pairs]
        if [g.allowed for g in got] != want:
            raise AssertionError("the mixed bulk check differs from the "
                                 "oracle in request order")
        n_allowed = sum(want)
        # (c)'s scatter writes gave this user a pod and a configmap
        flt = RelationshipFilter(relation="creator", subject=SubjectFilter(
            type="user", id=f"u{SHARD_LISTS}"))
        fan0 = dict(shard_metrics._fanout.snapshot())
        fan = asyncio.run(sharded.read_relationships(flt))
        fanned = (shard_metrics._fanout.snapshot().get(("read",), 0)
                  - fan0.get(("read",), 0))
        want_fan = union.read(flt)
        if (sorted(r.rel_string() for r in fan)
                != sorted(r.rel_string() for r in want_fan)
                or not {"pod", "configmap"} <= {r.resource.type
                                                for r in fan}
                or fanned != 1):
            raise AssertionError(f"the untyped read returned {len(fan)} "
                                 f"tuples, the union {len(want_fan)}")
        revs_b = [st.revision for st in stores]
        try:
            asyncio.run(sharded.write_relationships([
                RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
                    f"pod:{pod_home[0]}/sx#creator@user:u1")),
                RelationshipUpdate(UpdateOp.TOUCH, parse_relationship(
                    f"configmap:{cm_home[0]}/sx#creator@user:u1"))]))
            raise AssertionError("a batch spanning both shards was taken")
        except CrossShardWriteError:
            pass
        if [st.revision for st in stores] != revs_b:
            raise AssertionError("a refused spanning batch moved a shard")
        watch = sharded.watch(["pod", "configmap"])
        if not isinstance(watch, MergedWatcher):
            raise AssertionError(f"a two-type watch is {type(watch)}")

        async def watched():
            for rel in (f"pod:{pod_home[0]}/sw#creator@user:u1",
                        f"configmap:{cm_home[0]}/sw#creator@user:u1"):
                await sharded.write_relationships([RelationshipUpdate(
                    UpdateOp.TOUCH, parse_relationship(rel))])
            seen = set()
            for _ in range(2):
                batch = await watch.next(timeout=10.0)
                if batch is None:
                    break
                seen |= {u.rel.resource.type for u in batch.updates}
            watch.close()
            return seen

        seen = asyncio.run(watched())
        if seen != {"pod", "configmap"} or not watch.join(10):
            raise AssertionError(f"the merged watch saw {seen}")
        for ep in eps:
            ep.wait_rebuilds()
        launches = {k: kernels.LAUNCHES[k] for k in REPLACES}
        # a background rebuild of shard 1 (its candidate prewarmed, so it
        # captures sweep graphs) while a pod burst runs on shard 0
        eps[1].prewarm_rebuilds = True
        bg0 = eps[1].stats["bg_rebuilds"]
        gen1 = eps[1]._graph
        iso_users = [f"u{i}" for i in range(SHARD_ISOLATION_LISTS)]
        marks = {}
        fused_d0 = fused()

        async def isolation():
            kube._lock = asyncio.Lock()
            t = time.perf_counter()
            with eps[1]._lock:
                eps[1]._kick_background_rebuild("background")
            res = await asyncio.gather(*(call(u, "GET", "/api/v1/pods")
                                         for u in iso_users))
            marks["burst"] = time.perf_counter() - t
            marks["inflight_after_burst"] = eps[1]._bg_inflight
            return res

        res = asyncio.run(isolation())
        d_fused_d = [(a1 - a0, c1 - c0) for (a0, c0), (a1, c1)
                     in zip(fused_d0, fused())]
        if d_fused_d[0][0] < 1 or d_fused_d[1] != (0, 0):
            raise AssertionError(f"fused (lookups, checks) by shard during "
                                 f"the pod burst {d_fused_d}")
        t = time.perf_counter()
        if not eps[1].wait_rebuilds(timeout=600):
            raise AssertionError("shard 1's background rebuild never ended")
        wait_s = time.perf_counter() - t
        if on_card:
            torch.cuda.synchronize()   # surfaces an asynchronous CUDA error
        if (eps[1].stats["bg_rebuilds"] != bg0 + 1 or eps[1]._graph is gen1
                or eps[1].stats["rebuild_failures"]):
            raise AssertionError(f"shard 1: no background swap "
                                 f"({eps[1].stats})")
        eps[1].prewarm_rebuilds = False
        iso_lists = [listed(r) for r, _ in res]
        for u, got in zip(iso_users, iso_lists):
            want = _oracle_ids(oracle, "pod", sorted(kube_pods),
                               SubjectRef("user", u))
            if got != want:
                raise AssertionError(f"{u}'s pod list during shard 1's "
                                     f"rebuild differs from the oracle")
        cm_after = asyncio.run(sharded.lookup_resources_batch(
            "configmap", "view", [SubjectRef("user", u) for u in cm_users]))
        for u, ids in zip(cm_users, cm_after):
            # candidates: what the endpoint answered and every configmap
            # the user has a tuple on; the oracle decides each
            cand = set(ids) | {r.resource.id for r in union.read(
                RelationshipFilter(resource_type="configmap",
                                   subject=SubjectFilter(type="user",
                                                         id=u)))}
            want = _oracle_ids(oracle, "configmap", sorted(cand),
                               SubjectRef("user", u))
            if set(ids) != want:
                raise AssertionError(f"{u}'s configmaps after shard 1's "
                                     f"swap differ from the oracle")
        log(f"phase 21 (d) check_bulk_permissions of {SHARD_BULK_CHECKS} "
            f"mixed pod/configmap pairs in {bulk_s:.4f} s, in request order "
            f"and equal to the oracle ({n_allowed} allowed); the untyped "
            f"read fanned out ({len(fan)} tuples of "
            f"{sorted({r.resource.type for r in fan})}); the spanning batch "
            f"refused, no shard moved; the merged watch saw {sorted(seen)}; "
            f"shard 1 rebuilt in the background (candidate prewarmed) while "
            f"{SHARD_ISOLATION_LISTS} pod lists ran on shard 0 in "
            f"{marks['burst']:.4f} s (rebuild still in flight at the "
            f"burst's end: {marks['inflight_after_burst']}; waited "
            f"{wait_s:.3f} s more; fused (lookups, checks) by shard "
            f"{d_fused_d}), every list and the configmap lookups "
            f"after the swap equal the oracle, no CUDA error "
            f"({smi_line})")
        rebuilds = [{k: ep.stats[k] for k in ("rebuilds", "bg_rebuilds",
                                              "preemptive_rebuilds")}
                    for ep in eps]
        out["phase_s"]["d"] = time.perf_counter() - t_phase

        # (e) the proxy dropped without stop() (no final checkpoint) and
        # started again on the same data dir
        for st, fn in zip(stores, listeners):
            st.remove_delta_listener(fn)
        want_revs = [st.revision for st in stores]
        for ep in eps:
            ep.wait_rebuilds()
        del proxy, sharded, eps, stores, ep, gen1, watch
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proxy = ProxyServer(Options(**opts))
        t1 = time.perf_counter()
        sharded = _sharded(proxy)
        stores = sharded.shard_stores()
        infos = [m.recovery_info for m in proxy._shard_persistence]
        if [st.revision for st in stores] != want_revs or not all(
                m.recovered and i["checkpoint_revision"] == 1
                for m, i in zip(proxy._shard_persistence, infos)):
            raise AssertionError(f"recovered revisions "
                                 f"{[st.revision for st in stores]}, "
                                 f"journaled {want_revs}")
        eps = _shard_eps(proxy)
        warm = []
        for ep in eps:
            t = time.perf_counter()
            ep.warm_start(prewarm=True)
            warm.append(time.perf_counter() - t)
        kube._lock = asyncio.Lock()

        async def first_lists():
            return await asyncio.gather(
                *(call(u, "GET", "/api/v1/pods") for u in pod_users[:8]),
                *(call(u, "GET", "/api/v1/configmaps") for u in cm_users[:8]))

        t = time.perf_counter()
        res = asyncio.run(first_lists())
        first_s = time.perf_counter() - t
        for i, (r, _) in enumerate(res):
            typ, pool, u = (("pod", kube_pods, pod_users[i]) if i < 8 else
                            ("configmap", kube_cms, cm_users[i - 8]))
            if listed(r) != _oracle_ids(oracle, typ, sorted(pool),
                                        SubjectRef("user", u)):
                raise AssertionError(f"{u}'s first {typ} list after the "
                                     f"restart differs from the oracle")
        log(f"phase 21 (e) dropped without stop() and restarted on the data "
            f"dir: ProxyServer {t1 - t0:.3f} s; recovery "
            + "; ".join(f"shard {k} revision {st.revision} in "
                        f"{i['total_s']:.3f} s (checkpoint at "
                        f"{i['checkpoint_revision']} in "
                        f"{i['checkpoint_load_s']:.3f} s, "
                        f"{i['replayed_records']} WAL records in "
                        f"{i['wal_replay_s']:.3f} s, "
                        f"{i['idempotency_keys']} idempotency keys)"
                        for k, (st, i) in enumerate(zip(stores, infos)))
            + "; warm start with prewarm " + ", ".join(
                f"shard {k} {s:.3f} s" for k, s in enumerate(warm))
            + f"; first 8 + 8 lists {first_s:.4f} s, equal to the oracle "
            f"({smi_line})")
        for ep in eps:
            ep.wait_rebuilds()
        del proxy, sharded, eps, stores
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        out["phase_s"]["e"] = time.perf_counter() - t_phase

        # (f) a map whose pod closure spans both shards refuses to boot
        alloc_f = torch.cuda.memory_allocated() if on_card else 0
        try:
            ProxyServer(Options(**{**opts, "partition_map": SHARD_SPANNING_MAP,
                                   "data_dir": os.path.join(tmp, "f")}))
            raise AssertionError(f"{SHARD_SPANNING_MAP} booted")
        except RouterConfigError as e:
            why = str(e)
        if "SL007" not in why or "pod#view" not in why:
            raise AssertionError(f"the refusal says {why[:300]}")
        if on_card and torch.cuda.memory_allocated() != alloc_f:
            raise AssertionError("the refused map allocated card memory")
        log(f"phase 21 (f) partition_map={SHARD_SPANNING_MAP!r} refused "
            f"before any graph: {why.splitlines()[1].strip()[:160]}...; "
            f"card memory allocated unchanged")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep:
        out["fleet"] = {"tmp": tmp, "data": os.path.join(tmp, "data"),
                        "kube": kube, "oracle": oracle,
                        "schema_text": schema_text, "rules": _shard_rules(),
                        "n_users": n_users}
    else:
        shutil.rmtree(tmp, ignore_errors=True)
    idle = [k for k in READ_KERNELS + ("scatter_rows",) if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched in phase 21: {idle}")
    log(f"phase 21 launches of (b)-(d): "
        f"{ {k: v for k, v in launches.items() if v} }; rebuilds by shard "
        f"{rebuilds}")
    out["launches"] = launches
    out["rebuilds"] = rebuilds
    log(f"phase 21 wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def shard_cli(smi_line: str, device: str = "cuda") -> dict:
    """Phase 21 (g): the command line, at small depth.  Two single-shard
    `python3 -m spicedb_kubeapi_proxy_tpu_torch` leaders on `torch://`
    (with `--data-dir`, so each gates X-Authz-Min-Revision), over the
    reference test's schema and rules (tests/test_tuple_sharding.py:
    77-130, SHARD_CLI_SCHEMA and SHARD_CLI_RULES) with the tuples split
    by its map SHARD_CLI_MAP, in front of one fake kube-apiserver on a
    loopback socket; a `--shard-leaders` router process in front of
    them.  Through the router: its /readyz aggregates both leaders; a
    namespace get answers from shard 0 and a pod list from shard 1
    (X-Authz-Shard); a pod create lands on shard 1 with a vector token
    that a list carrying it honors; a token one revision ahead on shard
    1 gets 503 on pods and 200 on namespaces.  `--lint-schema-json` on
    deploy/'s bootstrap and rules exits 0, and with the spanning
    `--partition-map pod=1` exits 1 with an SL007 finding.  Every
    serving process exits 0 on SIGTERM within CLI_STOP_S, with no
    traceback."""
    import shutil
    import signal
    import tempfile

    from spicedb_kubeapi_proxy_tpu_torch.kubefake.apiserver import (
        FakeKubeApiServer)
    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, Headers, HttpServer, Request)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.replication import (
        MIN_REVISION_HEADER, REVISION_HEADER)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.sharding import (
        PartitionMap, RevisionVector)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        parse_relationship)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    deploy = os.path.join(root, "deploy")
    tmp = tempfile.mkdtemp(prefix="smoke-shard-cli-")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBERNETES_SERVICE")}
    env["PYTHONPATH"] = root
    pmap = PartitionMap.parse(SHARD_CLI_MAP, n_shards=2)
    shard_rels: dict = {0: [], 1: []}
    for line in SHARD_CLI_TUPLES:
        rel = parse_relationship(line)
        shard_rels[pmap.shard_of(rel.resource.type, rel.resource.id)].append(
            line)
    rules = os.path.join(tmp, "rules.yaml")
    with open(rules, "w") as f:
        f.write(SHARD_CLI_RULES)
    boots = []
    for k in (0, 1):
        boots.append(os.path.join(tmp, f"bootstrap-{k}.yaml"))
        with open(boots[k], "w") as f:
            json.dump({"schema": SHARD_CLI_SCHEMA,
                       "relationships": "\n".join(shard_rels[k])}, f)
    schema_only = os.path.join(tmp, "schema.yaml")
    with open(schema_only, "w") as f:
        json.dump({"schema": SHARD_CLI_SCHEMA}, f)
    module = [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch"]
    secs: dict = {}

    async def run(argv):
        proc = await asyncio.create_subprocess_exec(
            *argv, cwd=root, env=env, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(proc.communicate(), 300)
        return proc.returncode, out.decode(), err.decode()

    async def go():
        kube = FakeKubeApiServer()
        kube.seed("", "v1", "namespaces", {"metadata": {"name": "team-a"}})
        for name in ("p0", "p1"):
            kube.seed("", "v1", "pods", {"metadata": {
                "name": name, "namespace": "team-a"}})
        upstream = HttpServer(kube)
        kport = await upstream.start("127.0.0.1", 0)
        kubeconfig = os.path.join(tmp, "kubeconfig")
        with open(kubeconfig, "w") as f:
            json.dump({"current-context": "smoke",
                       "contexts": [{"name": "smoke", "context": {
                           "cluster": "fake"}}],
                       "clusters": [{"name": "fake", "cluster": {
                           "server": f"http://127.0.0.1:{kport}"}}]}, f)
        ports = [_free_port() for _ in range(3)]
        procs, labels = [], ["leader 0", "leader 1", "router"]
        # the lint runs beside the serving processes' start
        lint = asyncio.ensure_future(asyncio.gather(
            run(module + ["--lint-schema", "--lint-schema-json",
                          "--spicedb-bootstrap",
                          os.path.join(deploy, "bootstrap.yaml"),
                          "--rule-config",
                          os.path.join(deploy, "rules.yaml")]),
            run(module + ["--lint-schema", "--lint-schema-json",
                          "--spicedb-bootstrap",
                          os.path.join(deploy, "bootstrap.yaml"),
                          "--rule-config",
                          os.path.join(deploy, "rules.yaml"),
                          "--partition-map", SHARD_SPANNING_MAP])))
        t_start = time.perf_counter()
        for k in (0, 1):
            argv = module + [
                "--embedded-mode", "--bind-address", "127.0.0.1",
                "--secure-port", str(ports[k]), "--backend-kubeconfig",
                kubeconfig, "--no-override-upstream", "--rule-config",
                rules, "--spicedb-bootstrap", boots[k],
                "--data-dir", os.path.join(tmp, f"data-{k}"),
                "--wal-fsync", "never", "--replica-wait-ms", "50",
                "--no-prewarm-compiles", "-v", "2"]
            if device != "cuda":
                argv += ["--spicedb-endpoint", f"torch://?device={device}"]
            procs.append(await asyncio.create_subprocess_exec(
                *argv, cwd=root, env=env, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE))
        leaders = ",".join(f"http://127.0.0.1:{p}" for p in ports[:2])
        procs.append(await asyncio.create_subprocess_exec(
            *module, "--shard-leaders", leaders, "--partition-map",
            SHARD_CLI_MAP, "--rule-config", rules, "--spicedb-bootstrap",
            schema_only, "--embedded-mode", "--bind-address", "127.0.0.1",
            "--secure-port", str(ports[2]), "-v", "2", cwd=root, env=env,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE))
        router = H11Transport(f"http://127.0.0.1:{ports[2]}")

        async def call(method, target, headers=(), obj=None):
            h = Headers([("X-Remote-User", "alice"),
                         ("Accept", "application/json"), *headers])
            body = b""
            if obj is not None:
                body = json.dumps(obj).encode()
                h.set("Content-Type", "application/json")
            return await router.round_trip(Request(method, target,
                                                   headers=h, body=body))

        def names(resp) -> list:
            if resp.status != 200:
                raise AssertionError(f"list answered {resp.status}: "
                                     f"{resp.body[:300]!r}")
            return sorted(i["metadata"]["name"]
                          for i in json.loads(resp.body)["items"])

        seen: dict = {}
        stderr = ["", "", ""]
        try:
            while True:
                for p, n in zip(procs, labels):
                    if p.returncode is not None:
                        raise AssertionError(f"{n} exited {p.returncode} "
                                             f"before it served")
                if time.perf_counter() - t_start > CLI_READY_S:
                    raise AssertionError("the router never saw both "
                                         "leaders ready")
                try:
                    r = await router.round_trip(Request("GET", "/readyz"))
                    if r.status == 200 and r.body == b"ok shard 0\nok shard 1":
                        break
                except OSError:
                    pass
                await asyncio.sleep(0.25)
            secs["ready"] = time.perf_counter() - t_start
            seen["readyz"] = r.body.decode()
            r = await call("GET", "/api/v1/namespaces/team-a")
            seen["ns_get"] = (r.status, r.headers.get("X-Authz-Shard"))
            pods = "/api/v1/namespaces/team-a/pods"
            r = await call("GET", pods)
            seen["pods"] = (names(r), r.headers.get("X-Authz-Shard"))
            t = time.perf_counter()
            r = await call("POST", pods, obj={
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "p2", "namespace": "team-a"}})
            secs["create"] = time.perf_counter() - t
            tok = r.headers.get(REVISION_HEADER) or ""
            seen["create"] = (r.status, r.headers.get("X-Authz-Shard"),
                              tok)
            r = await call("GET", pods, headers=[(MIN_REVISION_HEADER, tok)])
            seen["read_own"] = names(r)
            vec = RevisionVector.decode(tok)
            ahead = vec.merged(1, vec.component(1) + 1).encode()
            seen["ahead"] = [
                (await call("GET", pods,
                            headers=[(MIN_REVISION_HEADER, ahead)])).status,
                (await call("GET", "/api/v1/namespaces/team-a",
                            headers=[(MIN_REVISION_HEADER, ahead)])).status]
        finally:
            for p in procs:
                if p.returncode is None:
                    p.send_signal(signal.SIGTERM)
            t_stop = time.perf_counter()
            for i, p in enumerate(procs):
                try:
                    _, err = await asyncio.wait_for(p.communicate(),
                                                    CLI_STOP_S)
                    stderr[i] = err.decode()
                except asyncio.TimeoutError:
                    p.kill()
                    await p.wait()
                    raise AssertionError(f"{labels[i]} outlived SIGTERM by "
                                         f"{CLI_STOP_S} s") from None
            secs["stop"] = time.perf_counter() - t_stop
            await upstream.stop()
            lints = await lint
        return seen, [p.returncode for p in procs], stderr, lints

    try:
        seen, rcs, stderr, lints = asyncio.run(go())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = {"readyz": "ok shard 0\nok shard 1", "ns_get": (200, "0"),
            "pods": (["p0"], "1"), "read_own": ["p0", "p2"],
            "ahead": [503, 200]}
    got = {k: v for k, v in seen.items() if k in want}
    tok = RevisionVector.decode(seen["create"][2])
    if (got != want or seen["create"][:2] != (201, "1")
            or not tok.component(1) or tok.component(0)):
        raise AssertionError(f"through the router: {seen}; stderr tails "
                             f"{[e[-1500:] for e in stderr]}")
    if rcs != [0, 0, 0] or any("Traceback" in e for e in stderr):
        raise AssertionError(f"exit codes {rcs}; stderr tails "
                             f"{[e[-1500:] for e in stderr]}")
    (rc0, out0, err0), (rc1, out1, err1) = lints
    clean, spanning = json.loads(out0), json.loads(out1)
    sl007 = [f for f in spanning["findings"] if f["code"] == "SL007"]
    if (rc0 != 0 or clean["summary"]["errors"] or rc1 != 1 or not sl007):
        raise AssertionError(f"--lint-schema-json exits {rc0}, {rc1}: "
                             f"{clean['summary']}, "
                             f"{spanning['summary']}; {err0[-500:]} "
                             f"{err1[-500:]}")
    log(f"phase 21 (g) two `python -m` leaders on "
        f"{'torch://' if device == 'cuda' else f'torch://?device={device}'}"
        f" and a --shard-leaders router: both ready behind the router in "
        f"{secs['ready']:.2f} s (/readyz {seen['readyz']!r}); namespace "
        f"get -> shard {seen['ns_get'][1]}, pod list -> shard "
        f"{seen['pods'][1]}; create 201 on shard 1 in "
        f"{secs['create'] * 1e3:.3f} ms with token {seen['create'][2]!r}, "
        f"read back with it {seen['read_own']}; a token ahead on shard 1: "
        f"pods {seen['ahead'][0]}, namespaces {seen['ahead'][1]}; "
        f"--lint-schema-json exits 0 ({clean['summary']}) and "
        f"{rc1} with the spanning map ({len(sl007)} SL007: "
        f"{sl007[0]['where']}); SIGTERM to exit 0 in {secs['stop']:.2f} s "
        f"({smi_line})")
    return {"s": time.perf_counter() - t_phase}


# -- phase 22, the remote endpoint ----------------------------------------------


class _Aborted(Exception):
    """An in-process handler's abort (grpc's own context raises too)."""


class _HandlerContext:
    """The servicer context the seven handlers see when called
    in-process: `abort` raises, `cancelled` turns true on close."""

    def __init__(self):
        self.done = False

    async def abort(self, code, details):
        raise _Aborted(f"{code}: {details}")

    def cancelled(self) -> bool:
        return self.done


class _HandlerClient:
    """The verbs of a `RemoteEndpoint` over a `PermissionsGrpcServer`'s
    handlers called in-process (where grpcio is absent): each request
    encoded with the port's wire encoders, each answer decoded with its
    decoders, as the gRPC transport would carry them."""

    def __init__(self, server):
        from spicedb_kubeapi_proxy_tpu_torch.spicedb import wire
        self.wire = wire
        self.handlers = server.handlers()

    def _fn(self, verb: str):
        path = ("/authzed.api.v1.WatchService/Watch" if verb == "Watch"
                else "/authzed.api.v1.PermissionsService/" + verb)
        return self.handlers[path][1]

    async def _unary(self, verb: str, payload: bytes) -> bytes:
        return await self._fn(verb)(payload, _HandlerContext())

    async def _stream(self, verb: str, payload: bytes) -> list:
        return [f async for f in self._fn(verb)(payload, _HandlerContext())]

    async def lookup_resources(self, resource_type, permission, subject):
        from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
            Permissionship)
        frames = await self._stream("LookupResources",
                                    self.wire.enc_lookup_request(
                                        resource_type, permission, subject))
        return [rid for rid, ship in map(self.wire.dec_lookup_response,
                                         frames)
                if ship == Permissionship.HAS_PERMISSION]

    async def check_permission(self, req):
        return self.wire.dec_check_response(await self._unary(
            "CheckPermission", self.wire.enc_check_request(req)))

    async def check_bulk_permissions(self, reqs):
        return self.wire.dec_bulk_response(await self._unary(
            "CheckBulkPermissions", self.wire.enc_bulk_request(reqs)))

    async def read_relationships(self, flt):
        return [self.wire.dec_read_response(f) for f in await self._stream(
            "ReadRelationships", self.wire.enc_read_request(flt))]

    async def write_relationships(self, updates, preconditions=()):
        return self.wire.dec_write_response(await self._unary(
            "WriteRelationships", self.wire.enc_write_request(
                list(updates), list(preconditions))))

    async def delete_relationships(self, flt, preconditions=()):
        return self.wire.dec_delete_response(await self._unary(
            "DeleteRelationships", self.wire.enc_delete_request(
                flt, list(preconditions))))

    def watch(self, object_types=None):
        """The Watch handler pumped on the running loop into a queue:
        `poll(timeout)` gives a WatchUpdate or None, `close()` ends it."""
        import queue

        from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import WatchUpdate
        q: queue.Queue = queue.Queue()
        ctx = _HandlerContext()
        gen = self._fn("Watch")(self.wire.enc_watch_request(object_types),
                                ctx)

        async def pump():
            async for frame in gen:
                revision, updates = self.wire.dec_watch_response(frame)
                q.put(WatchUpdate(updates=tuple(updates), revision=revision))

        task = asyncio.get_running_loop().create_task(pump())

        class _Watch:
            def poll(self, timeout: float):
                try:
                    return q.get(timeout=timeout)
                except queue.Empty:
                    return None

            def close(self):
                ctx.done = True
                task.cancel()

        return _Watch()

    async def close(self) -> None:
        pass


def _grpc_transport() -> str:
    """`grpc` where grpcio imports, else `in-process`."""
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.grpc_remote import _grpc
    try:
        _grpc()
    except ImportError:
        return "in-process"
    return "grpc"


def remote_path(p16: dict, smi_line: str, device: str = "cuda") -> dict:
    """Phase 22: the remote endpoint on phase 16's batched `torch://`
    endpoint at multitenant-1m (see the module docstring).  Returns the
    launches of the remote traffic, counted from zero, the transport
    and the phase's seconds."""
    import numpy as np

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.dispatch import (
        BatchingEndpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        EndpointConfigError, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.grpc_remote import (
        PermissionsGrpcServer)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, Relationship, RelationshipFilter,
        RelationshipUpdate, SubjectFilter, SubjectRef, UpdateOp)

    t_phase = time.perf_counter()
    _switch(True)
    proxy, ep = p16["proxy"], p16["ep"]
    ep.wait_rebuilds()
    served = proxy.endpoint
    while not isinstance(served, BatchingEndpoint):
        served = served.inner
    transport = _grpc_transport()
    log(f"phase 22 transport: {transport}")
    rng = np.random.default_rng(SEED + 22)
    n = REMOTE_CLIENTS * REMOTE_LOOKUPS
    subjects = [SubjectRef("user", f"u{i}") for i in range(n)]
    seeded = [f"ns{p % PROXY_NAMESPACES}/p{p}" for p in range(PROXY_PODS)]
    seeded_set = set(seeded)
    pairs = [CheckRequest(ObjectRef("pod", seeded[int(p)]), "view",
                          subjects[int(u)])
             for p, u in zip(rng.integers(0, len(seeded), REMOTE_BULK),
                             rng.integers(0, n, REMOTE_BULK))]
    writer = SubjectRef("user", f"u{n + 1}")
    write_pods = [seeded[int(i)] for i in rng.choice(len(seeded),
                                                      REMOTE_WRITES,
                                                      replace=False)]
    mine = RelationshipFilter(resource_type="pod", relation="creator",
                              subject=SubjectFilter(type="user",
                                                    id=writer.id))
    oracle = ep._oracle
    server = PermissionsGrpcServer(served, token=REMOTE_TOKEN)
    out: dict = {}
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    url = "torch://" if device == "cuda" else f"torch://?device={device}"
    permsd = [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.permsd",
              "--spicedb-endpoint", url]
    # permsd starts now, beside the in-process traffic (its imports and
    # CUDA context take seconds), and is asked once the traffic is done
    started = (_permsd_start(permsd, root, env) if transport == "grpc"
               else None)
    try:

        async def drive():
            port = None
            if transport == "grpc":
                from spicedb_kubeapi_proxy_tpu_torch.spicedb import (
                    grpc_remote)
                port = await server.start("127.0.0.1:0")
                clients = [grpc_remote.RemoteEndpoint(
                    f"127.0.0.1:{port}", insecure=True, token=REMOTE_TOKEN)
                    for _ in range(REMOTE_CLIENTS)]
            else:
                clients = [_HandlerClient(server)
                           for _ in range(REMOTE_CLIENTS)]
            try:
                # each client's channel up before the burst
                await asyncio.gather(*(c.lookup_resources("pod", "view",
                                                          subjects[0])
                                       for c in clients))
                kernels.reset_launches()
                stats0 = dict(served.stats)

                async def one(c, s):
                    t = time.perf_counter()
                    ids = await c.lookup_resources(REMOTE_LOOKUP_TYPE,
                                                   "view", s)
                    return ids, time.perf_counter() - t

                t = time.perf_counter()
                res = await asyncio.gather(*(
                    one(clients[i % REMOTE_CLIENTS], s)
                    for i, s in enumerate(subjects)))
                out["burst_wall"] = time.perf_counter() - t
                stats1 = dict(served.stats)
                out["lookups"] = [set(ids) for ids, _ in res]
                out["lat"] = [s for _, s in res]
                out["fused"] = (stats1["fused_lookups"]
                                - stats0["fused_lookups"])
                # one pod#view lookup (a proxied pod list's prefilter): the
                # stream carries one LookupResourcesResponse an id
                t = time.perf_counter()
                out["pod_ids"] = len(await clients[0].lookup_resources(
                    "pod", "view", subjects[0]))
                out["pod_s"] = time.perf_counter() - t
                t = time.perf_counter()
                bulk = await clients[0].check_bulk_permissions(pairs)
                out["bulk_s"] = time.perf_counter() - t
                out["bulk"] = [r.permissionship for r in bulk]
                watcher = clients[1].watch(["pod"])
                await asyncio.sleep(0.5)
                revs, write_s = [], []
                for i, p in enumerate(write_pods):
                    t = time.perf_counter()
                    revs.append(await clients[i % REMOTE_CLIENTS]
                                .write_relationships([RelationshipUpdate(
                                    UpdateOp.TOUCH, Relationship(
                                        ObjectRef("pod", p), "creator",
                                        writer))]))
                    write_s.append(time.perf_counter() - t)
                out["revs"], out["write_s"] = revs, write_s
                out["read"] = {r.resource.id for r in
                               await clients[2].read_relationships(mine)}
                out["after_write"] = set(await clients[3].lookup_resources(
                    "pod", "view", writer))
                out["oracle_after_write"] = _oracle_pods(oracle, seeded,
                                                         writer)
                out["rev_delete"] = await clients[0].delete_relationships(mine)
                out["after_delete"] = set(await clients[0].lookup_resources(
                    "pod", "view", writer))
                out["oracle_after_delete"] = _oracle_pods(oracle, seeded,
                                                          writer)
                seen = []
                loop = asyncio.get_running_loop()
                deadline = time.perf_counter() + 30
                while (len(seen) < REMOTE_WRITES + 1
                       and time.perf_counter() < deadline):
                    upd = await loop.run_in_executor(None, watcher.poll, 1.0)
                    if upd is not None:
                        seen.extend((u.op, u.rel.resource.id)
                                    for u in upd.updates)
                watcher.close()
                out["watch"] = seen
                out["launches"] = dict(kernels.LAUNCHES)
                if transport == "grpc":
                    bad = grpc_remote.RemoteEndpoint(
                        f"127.0.0.1:{port}", insecure=True,
                        token="not-" + REMOTE_TOKEN)
                    try:
                        await bad.check_permission(pairs[0])
                        out["bad_token"] = "answered"
                    except grpc_remote.RemoteEndpointError as e:
                        out["bad_token"] = str(e.code)
                    finally:
                        await bad.close()
                # the same burst and bulk on the bare endpoint, in-process
                t = time.perf_counter()
                out["direct"] = [set(x) for x in
                                 await ep.lookup_resources_batch(
                                     REMOTE_LOOKUP_TYPE, "view", subjects)]
                out["direct_s"] = time.perf_counter() - t
                t = time.perf_counter()
                out["direct_pod_ids"] = len(await ep.lookup_resources(
                    "pod", "view", subjects[0]))
                out["direct_pod_s"] = time.perf_counter() - t
                out["direct_bulk"] = [r.permissionship for r in
                                      await ep.check_bulk_permissions(pairs)]
            finally:
                for c in clients:
                    await c.close()
                if transport == "grpc":
                    await server.stop()

        asyncio.run(drive())
        launches = out["launches"]

        # checks
        if not 1 <= out["fused"] < n:
            raise AssertionError(f"{n} concurrent lookups fused into "
                                 f"{out['fused']} batches")
        if out["lookups"] != out["direct"]:
            bad = sum(a != b for a, b in zip(out["lookups"], out["direct"]))
            raise AssertionError(f"{bad} remote lookups differ from the "
                                 f"direct 256-lane batch")
        if out["pod_ids"] != out["direct_pod_ids"]:
            raise AssertionError(f"the remote pod lookup gave "
                                 f"{out['pod_ids']} ids, the direct one "
                                 f"{out['direct_pod_ids']}")
        objects = [i for i in ep.graph().prog.object_ids[REMOTE_LOOKUP_TYPE]
                   if "\x00" not in i]
        for i in rng.choice(n, REMOTE_ORACLE_USERS, replace=False):
            want = _oracle_ids(oracle, REMOTE_LOOKUP_TYPE, objects,
                               subjects[int(i)])
            if out["lookups"][int(i)] != want:
                raise AssertionError(f"{subjects[int(i)].id}'s remote lookup "
                                     f"differs from the oracle")
        if out["bulk"] != out["direct_bulk"]:
            raise AssertionError("the remote bulk check differs from the "
                                 "direct one")
        for i in rng.choice(REMOTE_BULK, REMOTE_ORACLE_CHECKS, replace=False):
            r = pairs[int(i)]
            ok = oracle.check(r.resource, r.permission, r.subject)
            if (out["bulk"][int(i)].name == "HAS_PERMISSION") != ok:
                raise AssertionError(f"remote check {r} differs from the "
                                     f"oracle")
        revs = out["revs"]
        if (revs != list(range(revs[0], revs[0] + REMOTE_WRITES))
                or out["rev_delete"] != revs[-1] + 1):
            raise AssertionError(f"revisions {revs}, delete at "
                                 f"{out['rev_delete']}")
        if not set(write_pods) <= out["read"]:
            raise AssertionError("ReadRelationships misses a write")
        if (not set(write_pods) <= out["after_write"]
                or out["after_write"] & seeded_set != out["oracle_after_write"]
                or out["after_delete"] & seeded_set
                != out["oracle_after_delete"]):
            raise AssertionError("read-after-write lookups differ from the "
                                 "oracle")
        watched = [p for op, p in out["watch"] if op == UpdateOp.TOUCH]
        if sorted(watched[:REMOTE_WRITES]) != sorted(write_pods):
            raise AssertionError(f"the watch saw {len(watched)} of "
                                 f"{REMOTE_WRITES} writes")
        if transport == "grpc" and out["bad_token"] != \
                "StatusCode.UNAUTHENTICATED":
            raise AssertionError(f"a wrong token got {out['bad_token']}")
        idle = [k for k in READ_KERNELS + ("scatter_rows",)
                if launches[k] == 0]
        if idle:
            raise AssertionError(f"kernels never launched in phase 22: {idle}")
        lat = out["lat"]
        ids = sum(len(x) for x in out["lookups"])
        log(f"phase 22 (a) {REMOTE_CLIENTS} x {REMOTE_LOOKUPS} concurrent "
            f"{REMOTE_LOOKUP_TYPE}#view LookupResources ({transport}): wall "
            f"{out['burst_wall']:.4f} s, per RPC {_pcts(lat)}, {ids} ids "
            f"streamed; fused on the server into {out['fused']} batches; the "
            f"same {n} lookups as one direct {n}-lane batch "
            f"{out['direct_s']:.4f} s; all equal to it, {REMOTE_ORACLE_USERS} "
            f"to the oracle; one pod#view lookup: {out['pod_ids']} ids in "
            f"{out['pod_s']:.4f} s remote "
            f"({out['pod_ids'] / out['pod_s']:.0f} ids/s), "
            f"{out['direct_pod_s']:.4f} s direct ({smi_line})")
        log(f"phase 22 (b) CheckBulkPermissions of {REMOTE_BULK} pairs "
            f"{out['bulk_s']:.4f} s, equal to the direct bulk check, "
            f"{REMOTE_ORACLE_CHECKS} to the oracle; {REMOTE_WRITES} "
            f"WriteRelationships {_pcts(out['write_s'])}, revisions "
            f"{revs[0]}..{revs[-1]}, DeleteRelationships at "
            f"{out['rev_delete']}; the watch saw {len(out['watch'])} updates; "
            f"read-after-write and after-delete lookups equal the oracle"
            + (f"; a wrong token: {out['bad_token']}"
               if transport == "grpc" else "") + f" ({smi_line})")
        log(f"phase 22 launches: { {k: v for k, v in launches.items() if v} }")

        # permsd and grpc:// as a user runs them
        if transport == "grpc":
            seen = _permsd_answers(*started)
            log(f"phase 22 (c) permsd on {url} over deploy/bootstrap.yaml: "
                f"answered in {seen['ready_s']:.2f} s ({seen['answers']}, "
                f"equal to embedded://), SIGTERM to exit 0 in "
                f"{seen['stop_s']:.2f} s")
        else:
            proc = subprocess.run(permsd, cwd=root, env=env,
                                  capture_output=True, text=True,
                                  timeout=120)
            if proc.returncode == 0 or "require grpcio" not in proc.stderr:
                raise AssertionError(f"permsd without grpcio exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-500:]}")
            try:
                create_endpoint("grpc://127.0.0.1:1")
                raise AssertionError("grpc:// built without grpcio")
            except EndpointConfigError as e:
                why = str(e)
            if "requires grpcio" not in why:
                raise AssertionError(f"grpc:// raised {why}")
            log(f"phase 22 (c) without grpcio: permsd exits "
                f"{proc.returncode} ({proc.stderr.strip().splitlines()[-1]}); "
                f"grpc:// raises EndpointConfigError ({why})")
    finally:
        if started is not None and started[0].poll() is None:
            started[0].kill()
            started[0].communicate()
    secs = time.perf_counter() - t_phase
    log(f"phase 22 wall time {secs:.1f} s")
    return {"launches": launches, "transport": transport, "s": secs}


def _permsd_start(argv: list, root: str, env: dict) -> tuple:
    """`python3 -m spicedb_kubeapi_proxy_tpu_torch.permsd` on deploy/'s
    bootstrap with a bearer token on a loopback port: (the process, its
    port, the bootstrap's path, its start instant)."""
    boot = os.path.join(root, "deploy", "bootstrap.yaml")
    port = _free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        argv + ["--spicedb-bootstrap", boot, "--listen-address",
                f"127.0.0.1:{port}", "--spicedb-token", REMOTE_TOKEN],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, port, boot, t0


def _permsd_answers(proc, port: int, boot: str, t0: float) -> dict:
    """Two checks and one lookup through a `RemoteEndpoint` to the
    started permsd, equal to an embedded endpoint's on the same
    bootstrap, then SIGTERM and exit 0 with no traceback."""
    import signal

    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.grpc_remote import (
        RemoteEndpoint, RemoteEndpointError)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    asks = [CheckRequest(ObjectRef("pod", "acme-prod/api-0"), "view",
                         SubjectRef("user", "grace")),
            CheckRequest(ObjectRef("pod", "acme-prod/api-1"), "view",
                         SubjectRef("user", "mallory"))]

    async def answers(ep):
        return ([(await ep.check_permission(r)).permissionship.name
                 for r in asks]
                + [sorted(await ep.lookup_resources(
                    "pod", "view", SubjectRef("user", "mallory")))])

    async def go():
        client = RemoteEndpoint(f"127.0.0.1:{port}", insecure=True,
                                token=REMOTE_TOKEN)
        try:
            while True:
                try:
                    return await answers(client)
                except RemoteEndpointError:
                    if proc.poll() is not None or \
                            time.perf_counter() - t0 > CLI_READY_S:
                        raise
                    await asyncio.sleep(0.25)
        finally:
            await client.close()

    try:
        got = asyncio.run(go())
        ready_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=CLI_STOP_S)
        stop_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    want = asyncio.run(answers(create_endpoint(
        "embedded://", Bootstrap.from_file(boot))))
    if got != want or proc.returncode != 0 or "Traceback" in err:
        raise AssertionError(f"permsd answered {got} (embedded {want}), "
                             f"exited {proc.returncode}: {err[-1500:]}")
    return {"ready_s": ready_s, "stop_s": stop_s, "answers": got}


# -- phase 23, the fleet plane -----------------------------------------------


class _LoopThread:
    """An event loop on a thread of its own, for a server that must keep
    accepting while the main thread runs its own loop (phase 23's fake
    kube-apiserver)."""

    def __init__(self):
        import threading
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="smoke-kube", daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _launch_counts(base: str, user: str) -> dict:
    """A member's `authz_kernel_launches{kernel=}` from its /metrics."""
    import re

    from spicedb_kubeapi_proxy_tpu_torch.utils.topology import http
    status, _, body = http("GET", base + "/metrics", user=user, timeout=30)
    if status != 200:
        raise AssertionError(f"{base}/metrics answered {status}")
    return {m.group(1): int(float(m.group(2))) for m in re.finditer(
        r'^authz_kernel_launches\{kernel="([^"]+)"\} (\S+)$',
        body.decode(), re.MULTILINE)}


def fleet_path(f21: dict, smi_line: str, device: str = "cuda") -> dict:
    """Phase 23: the fleet plane on phase 21's per-shard lineages (see
    the module docstring).  `f21` is what `shard_path(..., keep=True)`
    left: its temporary directory with the checkpointed lineages under
    `data/shard-<k>`, the fake kube-apiserver, the oracle over both
    shards' tuples, the schema and the rules.  Returns the launches of
    the first window summed over the two leader processes (from their
    /metrics), the members, the numbers logged and the phase's seconds."""
    import collections
    import signal

    import yaml

    from spicedb_kubeapi_proxy_tpu_torch.proxy.httpcore import (
        H11Transport, Headers, HttpServer, Request)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        ObjectRef, SubjectRef)
    from spicedb_kubeapi_proxy_tpu_torch.utils import tailexplain
    from spicedb_kubeapi_proxy_tpu_torch.utils.loadgen import (
        OpenLoopRunner, WorkloadSpec)
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import REGISTRY
    from spicedb_kubeapi_proxy_tpu_torch.utils.topology import (
        FleetSpec, ProcessFleet, free_port, http, single_thread_env)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    kube, oracle = f21["kube"], f21["oracle"]
    pods, cms = (sorted(f"{ns}/{n}" for ns, objs in kube.objects[
        ("", "v1", res)].items() for n in objs)
        for res in ("pods", "configmaps"))
    # the read rules of phase 21 (the traffic lists and gets): its
    # configmap delete rule's filter names no resource type, which the
    # router cannot place on one shard
    reads = [r for r in f21["rules"] if "update" not in r]
    fleet = ProcessFleet(FleetSpec(
        schema_text=f21["schema_text"],
        rules_yaml=yaml.safe_dump_all(reads), shard_leaders=0,
        router=False), workdir=os.path.join(f21["tmp"], "fleet"))
    upstream = _LoopThread()
    out: dict = {"phase_s": {}}
    try:
        async def serve_kube():
            kube._lock = asyncio.Lock()   # the loop of its first use
            server = HttpServer(kube)
            return server, await server.start("127.0.0.1", 0)

        kube_server, kport = upstream.run(serve_kube())
        kubeconfig = os.path.join(fleet.workdir, "kubeconfig")
        with open(kubeconfig, "w") as f:
            json.dump({"current-context": "smoke",
                       "contexts": [{"name": "smoke", "context": {
                           "cluster": "fake"}}],
                       "clusters": [{"name": "fake", "cluster": {
                           "server": f"http://127.0.0.1:{kport}"}}]}, f)
        env = single_thread_env({"PYTHONPATH": os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])})
        for k in [k for k in env if k.startswith("KUBERNETES_SERVICE")]:
            del env[k]
        module = [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch"]
        url = "torch://" if device == "cuda" else f"torch://?device={device}"
        common = ["--rule-config", fleet.rules_path, "--spicedb-bootstrap",
                  fleet.bootstrap_path, "--embedded-mode", "--bind-address",
                  "127.0.0.1", "-v", "2"]

        # (a) boot: two shard leaders on the lineages, then the router
        t0 = time.perf_counter()
        leaders = []
        for k in (0, 1):
            port = free_port()
            data = os.path.join(f21["data"], f"shard-{k}")
            fleet.spawn(f"leader-{k}", "leader", "leader", module + [
                "--spicedb-endpoint", url, "--data-dir", data,
                "--wal-fsync", "never", "--secure-port", str(port),
                "--backend-kubeconfig", kubeconfig,
                "--no-override-upstream"] + common, port, data_dir=data,
                env=env)
            leaders.append(f"http://127.0.0.1:{port}")
        for k in (0, 1):
            fleet.wait_ready(f"leader-{k}", CLI_READY_S)
        t1 = time.perf_counter()
        rport = free_port()
        fleet.spawn("router", "router", "router", module + [
            "--shard-leaders", ",".join(leaders), "--partition-map",
            SHARD_MAP, "--fleet-peers", ",".join(leaders), "--secure-port",
            str(rport)] + common, rport, env=env)
        fleet.wait_ready("router", CLI_READY_S)
        t2 = time.perf_counter()
        router_url = fleet.members["router"].url
        members = []
        for name, m in sorted(fleet.members.items()):
            text = fleet.log_text(name)
            found = [line.split("; endpoint ", 1)[1]
                     for line in text.splitlines() if "; endpoint " in line]
            members.append((name, m.proc.pid,
                            found[-1] if found else "no endpoint (router)"))
            if m.role == "leader" and not found:
                raise AssertionError(f"{name} logged no endpoint: "
                                     f"{text[-1500:]}")
            if (m.role == "leader" and device == "cuda"
                    and "NVIDIA" not in found[-1]):
                raise AssertionError(f"{name} serves {found[-1]}, not the "
                                     f"card")
            if m.role == "leader" and "recovered store at revision" \
                    not in text:
                raise AssertionError(f"{name} did not recover its lineage: "
                                     f"{text[-1500:]}")
        log(f"phase 23 members: " + "; ".join(
            f"{name} pid {pid} {what}" for name, pid, what in members))
        log(f"phase 23 (a) two shard leaders on phase 21's lineages ready in "
            f"{t1 - t0:.2f} s, the router in {t2 - t1:.2f} s more")
        out["members"] = members
        out["phase_s"]["a"] = time.perf_counter() - t_phase

        # (b) the open-loop window through the router
        user0 = "system:smoke"
        before = [_launch_counts(u, user0) for u in leaders]
        transport = H11Transport(router_url)
        statuses: collections.Counter = collections.Counter()
        sample = {"pod": [], "configmap": []}
        gets = []

        def target(ev) -> tuple:
            seq = ev["seq"]
            typ = "pod" if seq % 2 == 0 else "configmap"
            if ev["verb"] == "filter":
                return typ, f"/api/v1/{typ}s", None
            pool = pods if typ == "pod" else cms
            oid = pool[(seq * 7919) % len(pool)]
            ns, name = oid.split("/")
            return typ, f"/api/v1/namespaces/{ns}/{typ}s/{name}", oid

        def issue_with(strict: bool):
            async def issue(ev):
                user = f"u{int(ev['user'][1:]) - 1}"
                typ, path, oid = target(ev)
                resp = await transport.round_trip(Request(
                    "GET", path, headers=Headers([
                        ("X-Remote-User", user),
                        ("Accept", "application/json")])))
                statuses[(ev["verb"], typ, resp.status)] += 1
                if ev["verb"] == "filter":
                    if resp.status != 200:
                        raise RuntimeError(f"list {resp.status}")
                    if strict and len(sample[typ]) < FLEET_ORACLE_LISTS:
                        sample[typ].append((user, {
                            f"{i['metadata']['namespace']}/"
                            f"{i['metadata']['name']}"
                            for i in json.loads(resp.body)["items"]}))
                elif resp.status not in (200, 403):
                    raise RuntimeError(f"get {resp.status}")
                elif strict and len(gets) < FLEET_ORACLE_GETS:
                    gets.append((typ, oid, user, resp.status))
            return issue

        spec = WorkloadSpec(seed=SEED + 23, duration_s=FLEET_WINDOW_S,
                            rate_per_s=FLEET_RATE, users=f21["n_users"],
                            verb_mix=FLEET_MIX)
        runner = OpenLoopRunner(issue_with(True))
        report = asyncio.run(runner.run(spec.schedule()))
        after = [_launch_counts(u, user0) for u in leaders]
        launches = {k: sum(a.get(k, 0) - b.get(k, 0)
                           for a, b in zip(after, before))
                    for k in set().union(*after)}
        per_leader = [sum(a.get(k, 0) - b.get(k, 0) for k in a)
                      for a, b in zip(after, before)]
        lag_line = [line for line in REGISTRY.render().splitlines()
                    if line.startswith("authz_loadgen_lag_seconds")]
        if report["errors"] or report["achieved"] != report["offered"]:
            raise AssertionError(f"the window answered {report} "
                                 f"({dict(statuses)})")
        if device == "cuda" and min(per_leader) <= 0:
            # (the CPU twins count no launch)
            raise AssertionError(f"kernel launches by leader {per_leader}")
        if not lag_line:
            raise AssertionError("authz_loadgen_lag_seconds not exported")
        t_or = time.perf_counter()
        for typ, pool in (("pod", pods), ("configmap", cms)):
            for user, got in sample[typ]:
                want = _oracle_ids(oracle, typ, sorted(pool),
                                   SubjectRef("user", user))
                if got != want:
                    raise AssertionError(f"{user}'s {typ} list through the "
                                         f"router ({len(got)}) differs from "
                                         f"the oracle's ({len(want)})")
        for typ, oid, user, status in gets:
            ok = oracle.check(ObjectRef(typ, oid), "view",
                              SubjectRef("user", user))
            if status != (200 if ok else 403):
                raise AssertionError(f"{user}'s get of {typ} {oid} "
                                     f"answered {status}, oracle {ok}")
        oracle_s = time.perf_counter() - t_or
        log(f"phase 23 (b) open loop through the router, {FLEET_RATE:g}/s "
            f"offered for {FLEET_WINDOW_S:g} s ({dict(FLEET_MIX)}): "
            f"{report['offered']} offered, {report['achieved']} answered in "
            f"{report['window_s']} s; p50 {report['p50_ms']} ms, p99 "
            f"{report['p99_ms']} ms; per verb "
            + ", ".join(f"{v} {r['count']} p50 {r['p50_ms']} ms p99 "
                        f"{r['p99_ms']} ms" for v, r in
                        report["per_verb"].items())
            + f"; max scheduler lag {report['max_sched_lag_ms']} ms "
            f"({lag_line[-1]}); statuses {dict(statuses)}; "
            f"{len(sample['pod'])} + {len(sample['configmap'])} lists and "
            f"{len(gets)} gets equal the oracle ({oracle_s:.1f} s); kernel "
            f"launches by leader {per_leader} "
            f"({ {k: v for k, v in launches.items() if v} }) ({smi_line})")
        out["report"], out["launches"] = report, launches
        out["phase_s"]["b"] = time.perf_counter() - t_phase

        # (c) the merged view and the tail report
        t = time.perf_counter()
        status, _, body = http("GET", router_url + "/debug/traces",
                               user=user0, timeout=60)
        router_traces = json.loads(body)["traces"] if status == 200 else []
        status_f, _, body = http("GET", router_url + "/debug/fleet",
                                 user=user0, timeout=60)
        fleet_s = time.perf_counter() - t
        merged = json.loads(body)
        status_t, _, body = http("GET", router_url + "/debug/tail",
                                 user=user0, timeout=60)
        tail = json.loads(body)
        if (status, status_f, status_t) != (200, 200, 200):
            raise AssertionError(f"/debug answered {status}, {status_f}, "
                                 f"{status_t}")
        if any(m["error"] for m in merged["members"]):
            raise AssertionError(f"members {merged['members']}")
        assembled = {a["trace_id"]: a for a in merged["traces"]}
        lists = [t["trace_id"] for t in router_traces
                 if t["attrs"].get("target") in ("/api/v1/pods",
                                                 "/api/v1/configmaps")]
        joined = [tid for tid in lists if tid in assembled
                  and {"router", "leader"} <= set(assembled[tid]["tiers"])]
        if not lists or len(joined) * 2 <= len(lists):
            raise AssertionError(f"{len(joined)} of the router's "
                                 f"{len(lists)} sampled list traces "
                                 f"assembled across the fleet")
        inside = off = 0
        for a in assembled.values():
            if a["aligned_by_wall"] or a["wall_fallbacks"]:
                raise AssertionError(f"trace {a['trace_id']} aligned by "
                                     f"the wall clock")
            if abs(a["attributed_ms"] - a["duration_ms"]) > 0.05:
                off += 1
            segs = {s["tier"]: s for s in a["segments"]}
            hops = [sp for sp in segs["router"]["spans"]
                    if sp["name"] == "hop.shard_forward"]
            child = segs.get("leader")
            if child and hops and (
                    child["offset_ms"] == round(hops[0]["start_ms"], 3)
                    and child["offset_ms"] + child["duration_ms"]
                    <= hops[0]["start_ms"] + hops[0]["duration_ms"] + 1e-3):
                inside += 1
        if off or inside < FLEET_INSIDE_SHARE * len(assembled):
            raise AssertionError(f"{off} assembled traces do not reconcile "
                                 f"with their root; {inside} of "
                                 f"{len(assembled)} children inside their "
                                 f"hop span")
        full = tailexplain.explain(merged, top=10_000)
        total = sum(r["delta_ms"] for r in full["ranked"])
        if (not tail.get("enabled") or tail.get("requests", 0) < 2
                or abs(total - full["gap_ms"]) > 0.01 * full["gap_ms"] + 0.05):
            raise AssertionError(f"the tail report {tail}; over the merged "
                                 f"view its deltas sum to {total:.3f} ms "
                                 f"against a gap of {full['gap_ms']} ms")
        top = [(r["tier"], r["stage"], r["delta_ms"])
               for r in tail["ranked"][:4]]
        costly = [(r["tier"], r["stage"], r["body_mean_ms"],
                   r["tail_mean_ms"])
                  for r in sorted(full["ranked"],
                                  key=lambda r: -r["tail_mean_ms"])[:6]]
        tiers = merged["tiers"]
        log(f"phase 23 (c) /debug/fleet in {fleet_s:.3f} s: "
            f"{len(assembled)} traces assembled across the router and a "
            f"leader, {len(joined)} of the router's {len(lists)} sampled "
            f"list traces among them; {inside} children inside their hop "
            f"span, every trace's tier sums equal to its root latency; per "
            f"tier " + ", ".join(f"{k} p50 {v['p50_ms']} ms p99 "
                                 f"{v['p99_ms']} ms" for k, v in tiers.items())
            + f"; /debug/tail over {tail['requests']} traces: p50 "
            f"{tail['p50_ms']} ms, p99 {tail['p99_ms']} ms, gap "
            f"{tail['gap_ms']} ms, explained {tail['explained_fraction']}, "
            f"top {top}; the costliest components (tier, stage, body mean "
            f"ms, tail mean ms) {costly}; all deltas of the merged view sum "
            f"to {total:.3f} ms against its gap {full['gap_ms']} ms "
            f"({smi_line})")
        out["tiers"], out["tail"] = tiers, tail
        out["phase_s"]["c"] = time.perf_counter() - t_phase

        # (d) a second window with leader 1 killed in it
        async def killing():
            loop = asyncio.get_running_loop()
            await asyncio.sleep(FLEET_KILL_AT_S)
            await loop.run_in_executor(None, fleet.kill, "leader-1",
                                       signal.SIGKILL)

        async def window_d():
            kill = asyncio.ensure_future(killing())
            rep = await OpenLoopRunner(issue_with(False)).run(WorkloadSpec(
                seed=SEED + 230, duration_s=FLEET_KILL_WINDOW_S,
                rate_per_s=FLEET_RATE, users=f21["n_users"],
                verb_mix=FLEET_MIX).schedule())
            await kill
            return rep

        statuses.clear()
        report_d = asyncio.run(window_d())
        status, _, body = http("GET", router_url + "/debug/fleet",
                               user=user0, timeout=60)
        merged_d = json.loads(body)
        errs = {m["url"]: m["error"] for m in merged_d["members"]}
        if (status != 200 or not errs.get(leaders[1])
                or errs.get(leaders[0])):
            raise AssertionError(f"/debug/fleet with leader 1 dead: "
                                 f"{status} {errs}")
        log(f"phase 23 (d) leader 1 killed with SIGKILL {FLEET_KILL_AT_S:g} s "
            f"into a {FLEET_KILL_WINDOW_S:g} s window: {report_d['offered']} "
            f"offered, {report_d['achieved']} answered, "
            f"{report_d['errors']} failed; statuses {dict(statuses)}; "
            f"/debug/fleet still 200, leader 1's entry: "
            f"{errs[leaders[1]]!r}")

        # (e) SIGTERM to the rest
        t = time.perf_counter()
        rcs = fleet.stop(CLI_STOP_S)
        stop_s = time.perf_counter() - t
        bad = {n: rc for n, rc in rcs.items()
               if rc != (-signal.SIGKILL if n == "leader-1" else 0)}
        tracebacks = [n for n in rcs if n != "leader-1"
                      and "Traceback" in fleet.log_text(n)]
        if bad or tracebacks:
            raise AssertionError(f"exit codes {rcs}; tracebacks in "
                                 f"{tracebacks}: " + " | ".join(
                                     fleet.log_text(n)[-1500:]
                                     for n in list(bad) + tracebacks))
        log(f"phase 23 (e) SIGTERM: exit codes {rcs} in {stop_s:.2f} s, no "
            f"traceback")
        upstream.run(kube_server.stop())
    finally:
        fleet.teardown()
        upstream.close()
    out["s"] = time.perf_counter() - t_phase
    log(f"phase 23 wall time {out['s']:.1f} s")
    return out


PARSE_TWIN_LINES = 100_000  # phase 19 (a)'s slice parsed by both parsers
DIST_MESH = (1, 2)          # phase 24's mesh in its one-rank process group
DIST_BATCHES = 3            # lookup and check batches before and after
DIST_ORACLE_PODS = 1_000    # pods outside a lookup the oracle checks too


def distributed_path(ep, w, batches: list, reqs: list, timer, peak,
                     smi_line: str, device: str = "cuda") -> dict:
    """Phase 24: `torch://?distributed=1&mesh=1x2` on the phase-3 store,
    in a one-rank process group set up here (a loopback coordinator,
    NUM_PROCESSES=1, PROCESS_ID=0; NCCL for the card's tensors): both
    shards on this card, every sweep's deltas and the readout going
    through `torch.distributed`.  Its lookups and checks equal the
    single-device endpoint's and an oracle sample, before and after a
    churn round; its kernels are held against their twins (`mesh_sweep`);
    the process group is destroyed before returning."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _ShardedEllGraph)
    from spicedb_kubeapi_proxy_tpu_torch.parallel import (collectives,
                                                          distributed)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, SubjectRef, UpdateOp, parse_relationship)

    t_phase = time.perf_counter()
    if distributed.is_initialized():
        raise AssertionError("a process group is up before phase 24")
    env = {"SPICEDB_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "SPICEDB_TPU_NUM_PROCESSES": "1", "SPICEDB_TPU_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    d, g = DIST_MESH
    url = (f"torch://?distributed=1&mesh={d}x{g}&dispatch=direct"
           + ("" if device == "cuda" else f"&device={device}"))
    try:
        m = create_endpoint(url, Bootstrap(w.schema_text, ""),
                            store=ep.store)
        import torch.distributed as dist
        gr = m.graph()
        if not isinstance(gr, _ShardedEllGraph) or not \
                m.mesh.spans_processes or m.mesh.world != 1:
            raise AssertionError(f"{url} built {type(gr).__name__} on "
                                 f"{m.mesh!r}")
        kern = gr.kernel
        backend = dist.get_backend()
        log(f"phase 24: {url} on the phase-3 store: {m.mesh!r}, backend "
            f"{backend}; {kern.n_pad} + {kern.a_pad} rows, blocks main "
            f"{kern.block_main}, aux {kern.block_aux}")
        rounds = []

        def read(label):
            looks, chks, e2e = [], [], {"lookup": [], "check": []}
            kernels.reset_launches()
            collectives.reset_collectives()
            sweeps = 0
            for k in range(DIST_BATCHES):
                t0 = time.perf_counter()
                looks.append(asyncio.run(m.lookup_resources_batch(
                    "pod", "view", batches[k])))
                timer.sync()
                e2e["lookup"].append(time.perf_counter() - t0)
                sweeps += int(gr.last_trace[0])
                t0 = time.perf_counter()
                chks.append(asyncio.run(m.check_bulk_permissions(reqs)))
                timer.sync()
                e2e["check"].append(time.perf_counter() - t0)
                sweeps += int(gr.last_trace[0])
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            coll = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
            for k in range(DIST_BATCHES):
                one = asyncio.run(ep.lookup_resources_batch("pod", "view",
                                                            batches[k]))
                one_c = asyncio.run(ep.check_bulk_permissions(reqs))
                if [sorted(x) for x in one] != [sorted(x) for x in looks[k]]:
                    raise AssertionError(f"phase 24 {label}: lookup batch "
                                         f"{k} differs from the single-"
                                         "device endpoint's")
                if [c.permissionship for c in one_c] != \
                        [c.permissionship for c in chks[k]]:
                    raise AssertionError(f"phase 24 {label}: checks differ "
                                         "from the single-device endpoint's")
            # the oracle: a subject's lookup against its checks of the
            # returned pods and DIST_ORACLE_PODS others, and a sample of
            # the batch's checks
            rng = np.random.default_rng(SEED + 24 + len(rounds))
            pods = [p for p in gr.prog.object_ids["pod"] if "\x00" not in p]
            subj = batches[0][int(rng.integers(0, len(batches[0])))]
            got = set(looks[0][batches[0].index(subj)])
            cand = got | {pods[int(i)] for i in rng.choice(
                len(pods), DIST_ORACLE_PODS, replace=False)}
            oracle = ep._oracle
            if got != _oracle_pods(oracle, sorted(cand), subj):
                raise AssertionError(f"phase 24 {label}: lookup for {subj} "
                                     "differs from the oracle")
            for i in rng.choice(len(reqs), 64, replace=False).tolist():
                r = reqs[i]
                if oracle.check(r.resource, r.permission, r.subject) != \
                        chks[0][i].allowed:
                    raise AssertionError(f"phase 24 {label}: check {i} "
                                         "differs from the oracle")
            idle = [k for k in MESH_KERNELS if not launches.get(k)]
            if idle:
                raise AssertionError(f"phase 24 {label}: kernels never "
                                     f"launched: {idle}")
            red = coll["reduce_sweep_deltas"]
            if red["xrank_calls"] != sweeps or red["calls"] != sweeps:
                raise AssertionError(f"phase 24 {label}: {red} for {sweeps} "
                                     "sweeps: not one all-reduce a sweep")
            if coll["sum_across"]["xrank_calls"] != 2 * DIST_BATCHES:
                raise AssertionError(f"phase 24 {label}: readout "
                                     f"all-reduces {coll['sum_across']}")
            med = {v: statistics.median(t[1:]) for v, t in e2e.items()}
            log(f"phase 24 {label}: {DIST_BATCHES} lookup batches x "
                f"{len(batches[0])} lanes and {DIST_BATCHES} check batches "
                f"x {len(reqs)} pairs equal the single-device endpoint's; "
                f"the oracle agrees on {subj.id}'s lookup over {len(cand)} "
                f"pods and 64 checks; sweeps {sweeps}; warm median lookup "
                f"{med['lookup']:.6f} s, check {med['check']:.6f} s; "
                f"launches {launches}; cross-rank collectives "
                + ", ".join(f"{k} {v['xrank_calls']} calls "
                            f"{v['xrank_bytes']} bytes" for k, v in
                            coll.items())
                + f"; all_gather_rows delivered {coll['all_gather_rows']['bytes']}"
                f" bytes by the kernels' writes, {coll['all_gather_rows']['copies']}"
                f" copies ({smi_line})")
            rounds.append({"launches": launches, "collectives": coll,
                           "e2e_s": e2e, "sweeps": sweeps})
            return launches

        launches = dict(read("before churn"))
        # one churn round through the distributed endpoint: the shared
        # store's writes reach both endpoints
        rebuilds0 = m.stats["rebuilds"]
        plan = _churn_plan(w, 1, SEED + 24, tag="x")
        ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}

        async def commit():
            for wr in plan[0]["writes"]:
                await m.write_relationships(
                    [RelationshipUpdate(ops[o], parse_relationship(rel))
                     for o, rel in wr])
        asyncio.run(commit())
        for k, v in read("after a churn round").items():
            launches[k] = launches.get(k, 0) + v
        if m.stats["rebuilds"] != rebuilds0:
            raise AssertionError("phase 24: the churn round rebuilt")
        # the sharded batch's kernels against their twins, call by call,
        # then the readout's on its final state
        from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
        q_arr, _, _ = m._encode_subjects(gr, batches[0])
        n_words = len(q_arr) // 32
        sweep = mesh_sweep(kern, q_arr, n_words, gr.snapshot(), timer, peak,
                           "phase 24 distributed mesh")
        x, _ = kern.evaluate(q_arr, n_words, gr.snapshot(),
                             kern._alloc_arenas(n_words))
        rng = np.random.default_rng(SEED + 240)
        gi = rng.integers(0, gr.prog.state_size, N_CHECKS).astype(np.int32)
        gc_ = rng.integers(0, 32 * n_words, N_CHECKS).astype(np.int32)
        c_err = _diff(kern.finish_checks(x, gi, gc_, n_words),
                      kern.finish_checks(x, gi, gc_, n_words, reference))
        off, length = gr.prog.slot_range("pod", "view")
        l_err = _diff(kern.finish_lookup(x, off, length, n_words),
                      kern.finish_lookup(x, off, length, n_words, reference))
        if c_err or l_err:
            raise AssertionError(f"phase 24: the readout's check_gather "
                                 f"({c_err}) or lookup_T ({l_err}) differs "
                                 "from its twin")
        log(f"phase 24 readout on the final state: check_gather over "
            f"{N_CHECKS} pairs and lookup_T over pod#view's {length} rows "
            f"bit-identical to their twins (through the readout's "
            f"all-reduce)")
        del m, gr, kern
        gc.collect()
    finally:
        distributed.destroy()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if distributed.is_initialized():
        raise AssertionError("phase 24 left its process group up")
    secs = time.perf_counter() - t_phase
    log(f"phase 24 wall time {secs:.1f} s")
    return {"launches": launches, "rounds": rounds, "sweep": sweep,
            "s": secs}


FUZZ_SEEDS = 31            # phase 25: the fixed cells of the port's fuzz
FUZZ_MUTATION = "wildcard-plane-skipped"   # the tripwire it must catch
# kernels each role family must launch over phase 25's cells: the ELL
# sweep and readout, the segment sweep, the mesh sweep and the Leopard
# plane read (`check_gather` also reads the segment state and the plane)
FUZZ_FAMILIES = {
    "ell": ("ell_gather_or", "perm_program", "sweep_delta_checks",
            "seed_bitplanes", "lookup_T"),
    "segment": ("edge_or", "sweep_delta", "check_gather"),
    "mesh": ("mesh_gather_or", "mesh_perm_program", "mesh_sweep_delta"),
    "leopard": ("word_cols_T",),
}


def fuzz_path(smi_line: str, device: str = "cuda") -> dict:
    """Phase 25: the port's own differential fuzz (`fuzz/`) on the card.
    (a) The FUZZ_SEEDS fixed cells of `smoke_cell_for` — the 3 x 3 gate x
    role matrix (leader, 2-hop follower chain, promoted follower), two
    `sharded2` cells, two `mesh` cells (a 2 x 2 mesh co-located on the
    card against a single-device endpoint) and two `leopard` cells
    (indexed against index-free) — each a generated schema, load and
    burst stream replayed through `torch://` endpoints on the card and
    compared with the host oracle at `checkpoints="final"`: zero
    divergences, every matrix cell at least twice, every role family
    present, and every kernel of FUZZ_FAMILIES launched (counts from
    zero over the cells).  (b) The tripwire: under FUZZ_MUTATION the
    fixed seeds must catch a divergence on the card, whose shrunk
    artifact (written to a temporary directory) diverges on replay under
    the mutation and replays clean without it."""
    import tempfile

    from spicedb_kubeapi_proxy_tpu_torch.fuzz import (MUTATIONS,
                                                      replay_artifact)
    from spicedb_kubeapi_proxy_tpu_torch.fuzz.__main__ import (
        coverage_hole, mutation_check, run_cell)
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    kernels.reset_launches()
    cells_hit: dict = {}
    by_role: dict = {}
    failed = []
    for seed in range(FUZZ_SEEDS):
        l0 = dict(kernels.LAUNCHES)
        res = run_cell(seed, device)
        d = _launch_delta(l0)
        cell = (res["gates"], res["role"])
        cells_hit[cell] = cells_hit.get(cell, 0) + 1
        _add(by_role.setdefault(res["role"], {}), d)
        log(f"phase 25 (a) seed {seed} [{res['gates']}/{res['role']}/"
            f"{res['kernel']}] {len(res['divergences'])} divergences in "
            f"{res['elapsed']:.3f} s; launches {d}")
        failed.extend(res["divergences"])
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t_a = time.perf_counter() - t_phase
    log(f"phase 25 (a) launches per kernel over the {FUZZ_SEEDS} cells: "
        f"{launches}; by role: {by_role}")
    if failed:
        raise AssertionError(f"phase 25: {len(failed)} divergences: "
                             + "; ".join(failed))
    hole = coverage_hole(cells_hit, FUZZ_SEEDS)
    if hole:
        raise AssertionError(f"phase 25: {hole}")
    for role in ("sharded2", "mesh", "leopard"):
        if role not in by_role:
            raise AssertionError(f"phase 25: no {role} cell replayed")
    for family, names in FUZZ_FAMILIES.items():
        _require_launches(launches, names, f"in phase 25's {family} "
                          f"family")
    log(f"phase 25 (a) {FUZZ_SEEDS} cells replayed on the card, 0 "
        f"divergences, in {t_a:.1f} s; cells {dict(sorted(cells_hit.items()))}"
        f" ({smi_line})")

    # (b) the tripwire
    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fuzz25-") as tmp:
        caught = mutation_check(FUZZ_MUTATION, FUZZ_SEEDS, device, tmp,
                                log=lambda m: log(f"phase 25 (b) {m}"))
        if not caught:
            raise AssertionError(f"phase 25: {FUZZ_MUTATION} not caught by "
                                 f"the fixed seeds on the card")
        with MUTATIONS[FUZZ_MUTATION]():
            live = replay_artifact(caught["path"], device=device)
        fixed = replay_artifact(caught["path"], device=device)
    if not live or fixed:
        raise AssertionError(f"phase 25: the shrunk artifact replays "
                             f"{len(live)} divergences under the mutation "
                             f"and {len(fixed)} without it")
    log(f"phase 25 (b) {FUZZ_MUTATION} caught at seed {caught['seed']}, "
        f"shrunk to {caught['deltas']} deltas; the artifact diverges under "
        f"the mutation ({live[0].line()}) and replays clean without it, in "
        f"{time.perf_counter() - t_b:.1f} s")
    log(f"phase 25 wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "cells": cells_hit, "seconds_a": t_a}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import _sweep_bytes
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        CheckRequest, ObjectRef, SubjectRef)

    # 1. card identity
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    peak = hbm_peak(name)
    log(f"device: {name} ({torch.cuda.device_count()} visible); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi_line)

    # 2. build: the kernels (nvcc) and, beside them, the bulk parser (g++)
    import threading

    from spicedb_kubeapi_proxy_tpu_torch import native
    t0 = time.perf_counter()
    native_out: dict = {}

    def build_native():
        try:
            native.load()
            native_out["s"] = time.perf_counter() - t0
        except BaseException as e:      # re-raised below
            native_out["error"] = e
    th = threading.Thread(target=build_native)
    th.start()
    path = kernels.build()
    kernels._load()
    th.join()
    if "error" in native_out:
        raise native_out["error"]
    if native.disabled():
        raise AssertionError("SPICEDB_TPU_NO_NATIVE is set: the smoke "
                             "parses through the native parser")
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s; "
        f"{native.library_path().name} (g++, beside it) in "
        f"{native_out['s']:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())

    # phases 1-14 assert that their churn rebuilds nothing: they run with
    # the off-loop rebuild switch off; phase 15 and the swaps after 13a and
    # 10 turn it on where they need it
    _switch(False)

    # 3. load
    phase_s = {}
    t_ph = time.perf_counter()
    timer = Timer(torch, torch.device("cuda"))
    ep, w = load("cuda", {})
    mt_statuses = ep._leopard.status_map()
    log(f"Leopard statuses at multitenant-1m: {mt_statuses}")
    phase_s["1-3"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()

    # 4-5. the main path, launches counted from zero
    kernels.reset_launches()
    batches, lookups, reqs, checks, summary = drive(ep, w, timer)
    launches = dict(kernels.LAUNCHES)
    log(f"launches on the main path: {launches}; sweep graphs "
        f"{ep.graph().kernel.graph_stats}")
    idle = [k for k in READ_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    _no_standalone_tail(launches, "phases 4-5")

    # 6. kernels against twins, timings and bounds
    rows, per, nt = kernels_vs_twins(ep, batches, reqs, timer, peak)
    for r in rows.values():
        r["launches"] = launches[r["name"]]

    # 7. answers against the oracle
    oracle_check(ep, batches, lookups, reqs, checks)

    # 8. byte model and bound at this card's peak
    g = ep.graph()
    model = _sweep_bytes(g, LOOKUP_LANES)
    sweep_ms = (per["ell_gather_or"][0] + per["perm_program"][0]
                + rows["sweep_delta"]["ms"])
    log(f"sweep byte model (reference _sweep_bytes): {model} bytes per sweep "
        f"at {LOOKUP_LANES} lanes; bound {model / peak * 1e3:.6f} ms at "
        f"{peak / 1e12:.2f} TB/s ({smi_line}); measured sweep "
        f"kernels {sweep_ms:.6f} ms -> {model / peak * 1e3 / sweep_ms:.4f} "
        f"of the bound")
    for verb in ("lookup", "check"):
        s = summary[verb]
        log(f"{verb} summary: warm median e2e "
            f"{statistics.median(s['e2e_s'][1:]):.6f} s, sweeps "
            f"{s['sweeps'][-1]}")

    phase_s["4-8"] = time.perf_counter() - t_ph

    # 9. the write path, launches counted from zero over the churn
    t_ph = time.perf_counter()
    rows["scatter_rows"] = churn(
        ep, w, timer, peak,
        statistics.median(summary["lookup"]["e2e_s"][1:]))
    phase_s["9"] = time.perf_counter() - t_ph

    # 11. the segment kernel on the same store, beside the ELL endpoint
    t_ph = time.perf_counter()
    seg_rows, _, seg = segment_path(ep, w, timer, peak, smi_line)
    phase_s["11"] = time.perf_counter() - t_ph

    # 13a-b. the mesh path on the same store: the sharded ELL endpoint
    # against the single-device one, then ShardedKernel against the
    # segment endpoint
    t_ph = time.perf_counter()
    mesh = make_smoke_mesh("cuda")
    m_ep, mesh_mt = mesh_multitenant(ep, w, mesh, timer, peak, smi_line)
    swap_and_agree(m_ep, ep, "pod", "view", batches[0], reqs,
                   "phase 13a mesh endpoint")
    del m_ep
    gc.collect()
    mesh_seg = mesh_segment(seg, mesh, timer, peak)
    phase_s["13a-b"] = time.perf_counter() - t_ph

    # 24. the same store behind torch://?distributed=1&mesh=1x2 in a
    # one-rank process group
    t_ph = time.perf_counter()
    dist24 = distributed_path(ep, w, batches, reqs, timer, peak, smi_line)
    gc.collect()
    phase_s["24"] = time.perf_counter() - t_ph

    # 14. batched dispatch on the phase-3 endpoint, launches counted from 0
    t_ph = time.perf_counter()
    batched_dispatch(ep, w, smi_line)
    phase_s["14"] = time.perf_counter() - t_ph

    # 15. off-loop rebuilds on the same store
    t_ph = time.perf_counter()
    offloop = offloop_rebuild(ep, w, batches, reqs, smi_line)
    phase_s["15"] = time.perf_counter() - t_ph

    # 10. the caveated deployment on its own endpoint (the first one goes),
    # then 13c, the same store on a mesh endpoint
    t_ph = time.perf_counter()
    del ep, g, batches, lookups, reqs, checks, seg
    gc.collect()
    torch.cuda.empty_cache()
    cav_rows, cav_ep, cav_w, _ = caveats(timer, peak, smi_line)
    phase_s["10"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    mesh_cav = mesh_caveats(cav_ep, cav_w, mesh, timer, peak)
    cav_pods = [p for p in cav_ep.graph().prog.object_ids[
        cav_w.resource_type] if "\x00" not in p][:40]
    cav_subjects = [SubjectRef("user", u) for u in cav_w.subjects[:50]]
    swap_and_agree(cav_ep, cav_ep, cav_w.resource_type, cav_w.permission,
                   cav_subjects, [CheckRequest(ObjectRef(
                       cav_w.resource_type, p), cav_w.permission, s)
                       for p in cav_pods for s in cav_subjects],
                   "phase 10 caveated endpoint")
    del cav_ep, cav_w
    phase_s["13c"] = time.perf_counter() - t_ph

    # 12. the Leopard index at group-explosion, indexed against not, then
    # 13d, its store on a mesh endpoint with the index on
    t_ph = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    leo_rows, leo_a, leo_w = leopard_path(timer, peak, smi_line,
                                          mt_statuses)
    phase_s["12"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    mesh_leo = mesh_leopard(leo_a, leo_w, mesh, timer)
    del leo_a, leo_w
    phase_s["13d"] = time.perf_counter() - t_ph

    # 16. the proxy's read path over multitenant-1m on its own endpoint
    t_ph = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    proxy = proxy_path(w, smi_line)
    phase_s["16"] = time.perf_counter() - t_ph

    # 17. dual writes on phase 16's proxy, then the command line as a
    # process on the card
    t_ph = time.perf_counter()
    dual = dualwrite_path(proxy, smi_line)
    phase_s["17a"] = time.perf_counter() - t_ph

    # 18. the decision cache and device telemetry on phase 16's store
    t_ph = time.perf_counter()
    cached = cache_telemetry_path(proxy, w, smi_line)
    phase_s["18"] = time.perf_counter() - t_ph

    # 22. the remote endpoint on phase 16's batched endpoint
    t_ph = time.perf_counter()
    remote = remote_path(proxy, smi_line)
    del proxy["proxy"], proxy["ep"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["22"] = time.perf_counter() - t_ph

    # 19. the durable store and read replication, on phase 16's fake,
    # then 20, leader failover on its leader and follower
    durable = durable_path(w, proxy.pop("kube"), smi_line, failover=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s.update(durable["phase_s"])

    # 21. tuple-space sharding: two shard graphs on the card behind one
    # proxy, then the router and the lint as processes
    t_ph = time.perf_counter()
    sharded = shard_path(w, smi_line, keep=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["21"] = time.perf_counter() - t_ph

    # 23. the fleet plane: phase 21's lineages as shard-leader processes
    # behind a router process
    t_ph = time.perf_counter()
    f21 = sharded.pop("fleet")
    try:
        fleet = fleet_path(f21, smi_line)
    finally:
        shutil.rmtree(f21["tmp"], ignore_errors=True)
    del f21
    gc.collect()
    phase_s["23"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    shard_cli(smi_line)
    phase_s["21g"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    cli_process(smi_line)
    phase_s["17b"] = time.perf_counter() - t_ph

    # 25. the port's own fuzz: the fixed cells on the card, the tripwire
    t_ph = time.perf_counter()
    fz25 = fuzz_path(smi_line)
    phase_s["25"] = time.perf_counter() - t_ph
    for kname, r in cav_rows.items():
        if kname in rows:
            # a kernel of both paths: its plane-mode numbers beside the
            # definite ones
            rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"],
                                             r["max_abs_err"])
            rows[kname].update({f"planes_{k}": v for k, v in r.items()
                                if k != "max_abs_err"})
        else:
            rows[kname] = {"name": kname, "route": "cuda",
                           "source": KERNEL_SOURCE,
                           "replaces": REPLACES[kname], **r}
    # the segment path's and the plane reads' numbers: new kernels get
    # their row, shared ones the numbers beside their own (prefixed)
    for prefix, extra in (("segment", seg_rows), ("leopard", leo_rows)):
        for kname, r in extra.items():
            if kname in rows:
                rows[kname]["max_abs_err"] = max(
                    rows[kname]["max_abs_err"], r.get("max_abs_err", 0))
                rows[kname].update({f"{prefix}_{k}": v for k, v in r.items()
                                    if k != "max_abs_err"})
            else:
                rows[kname] = {"name": kname, "route": "cuda",
                               "source": KERNEL_SOURCE,
                               "replaces": REPLACES[kname], **r}
    # the mesh path (phase 13): or_combine's row, and every kernel's
    # launches on its read batches beside the single-device ones
    rows["or_combine"] = {"name": "or_combine", "route": "cuda",
                          "source": KERNEL_SOURCE,
                          "replaces": REPLACES["or_combine"],
                          **mesh_seg["rows"]["or_combine"]}
    # the sharded sweep's kernels: numbers and launches of phase 13a (13c
    # for the caveat gather), the caveated deployment's beside them
    for kname in MESH_SWEEP_KERNELS + ("mesh_cav_gather_or",):
        mt = mesh_mt["sweep"]["rows"].get(kname)
        cav = mesh_cav["sweep"]["rows"][kname]
        r = dict(mt) if mt is not None else dict(cav)
        r["launches"] = (mesh_mt if mt is not None else
                         mesh_cav)["launches"][kname]
        if mt is not None:
            r["max_abs_err"] = max(r["max_abs_err"], cav["max_abs_err"])
            r.update({f"planes_{k}": v for k, v in cav.items()
                      if k != "max_abs_err"})
        rows[kname] = {"name": kname, "route": "cuda",
                       "source": KERNEL_SOURCE, "replaces": REPLACES[kname],
                       **r}
    for kname in rows:
        rows[kname]["mesh_launches"] = {
            "multitenant": mesh_mt["launches"].get(kname, 0),
            "segment": mesh_seg["launches"].get(kname, 0),
            "caveats": mesh_cav["launches"].get(kname, 0),
            "leopard": mesh_leo["launches"].get(kname, 0)}
    rows["scatter_rows"].update({f"mesh_flush_{k}": v for k, v in
                                 mesh_mt["scatter"].items()})
    # phase 15 (d): one background swap's launches, counted from zero
    for kname in rows:
        rows[kname]["offloop_launches"] = offloop["launches"].get(kname, 0)
    # phase 16: the proxied requests' launches, counted from zero
    for kname in rows:
        rows[kname]["proxy_launches"] = proxy["launches"].get(kname, 0)
    # phase 17 (a): the dual writes' launches, counted from zero
    for kname in rows:
        rows[kname]["dualwrite_launches"] = dual["launches"].get(kname, 0)
    # phase 18 (a): the cold cached burst's launches (the warm one's are
    # all 0, asserted)
    for kname in rows:
        rows[kname]["cache_cold_launches"] = cached["launches"].get(kname, 0)
    # phase 22: the remote traffic's launches, counted from zero
    for kname in rows:
        rows[kname]["remote_launches"] = remote["launches"].get(kname, 0)
    # phase 19 (d): the follower's launches over its replicated rounds
    for kname in rows:
        rows[kname]["follower_launches"] = durable["launches"].get(kname, 0)
    # phase 20 (a)-(c): the promoted, rejoined and leaf nodes' launches
    for kname in rows:
        rows[kname]["failover_launches"] = durable["failover"][
            "launches"].get(kname, 0)
    # phase 21 (b)-(d): the two shard graphs' launches, counted from zero
    for kname in rows:
        rows[kname]["shard_launches"] = sharded["launches"].get(kname, 0)
    # phase 23 (b): the two leader processes' launches over the window,
    # from their /metrics
    for kname in rows:
        rows[kname]["fleet_launches"] = fleet["launches"].get(kname, 0)
    # phase 24: the distributed mesh endpoint's reads, counted from zero,
    # and its sweep kernels' numbers against their twins
    for kname in rows:
        rows[kname]["distributed_launches"] = dist24["launches"].get(kname,
                                                                     0)
    # phase 25 (a): the fuzz cells' launches, counted from zero
    for kname in rows:
        rows[kname]["fuzz_launches"] = fz25["launches"].get(kname, 0)
    for kname, r in dist24["sweep"]["rows"].items():
        rows[kname].update({f"distributed_{k}": v for k, v in r.items()
                            if k != "max_abs_err"})
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"],
                                         r["max_abs_err"])
    for kname, also in REPLACES_ALSO.items():
        rows[kname]["replaces_also"] = also
    # the ELL path's checks ride the sweep tail in every phase that serves
    # it: no standalone delta or gather launched there
    for key, label in (("proxy_launches", "phase 16"),
                       ("failover_launches", "phase 20"),
                       ("remote_launches", "phase 22"),
                       ("fleet_launches", "phase 23")):
        _no_standalone_tail({k: r.get(key, 0) for k, r in rows.items()},
                            label)
    log("sweep_delta_checks launches: " + ", ".join(
        f"{k} {v}" for k, v in rows["sweep_delta_checks"].items()
        if k == "launches" or k.endswith("_launches")
        and not isinstance(v, dict)))
    log("phase seconds: " + ", ".join(f"{k}: {v:.1f}"
                                      for k, v in phase_s.items()))
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
