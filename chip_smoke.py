"""Smoke run of the PyTorch/CUDA port (kwok_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line then):

1. Card and build: the card's name and power limit as nvidia-smi reports
   them, then g++ builds the native library and the native mock
   apiserver (kwok_tpu_torch/native, apiserver.cc) while nvcc builds
   kwok_tpu_torch/csrc/tick.cu from the checkout, all at once (build
   times and the ptxas report are printed). A native server that does
   not build fails the run: no phase falls back to the Python mock.
2. Kernel: the SASS of the build (cuobjdump -sass, sass_bound.py): each
   entry's substep loop and the shortest path through it, per functional
   unit (printed), which sets the operation bound. Then both entries of
   kwok_tpu_torch/csrc/tick.cu against their plain torch version on the
   card at 1,048,576 pod rows + 10,240 node rows, for the constant
   default rule set and the exponential chaos set, at K=1 and K=16
   substeps (dt=0.05): the fused dispatch (tick_dispatch: one launch
   ticks both kinds and writes the packed wire, a one-block epilogue
   completes it) and the per-kind entry (tick_steps). Constant rules:
   the fused wire byte for byte against the plain wire (tick_steps_plain
   per kind, then pack_wire), every state field, mask and counter
   bit-exact. Chaos rules: fire_at and next_due to rtol 1e-6, rows that
   differ in any field, mask or wire row at most 1e-5 of the rows. The
   two entries' states equal bit for bit under both. Times by CUDA
   events: the fused launches, the whole dispatch (with the wire's D2H
   copy), the per-kind launches, the plain version, the D2H copy alone.
2b. Graft: the port's twin of __graft_entry__.entry()
   (kwok_tpu_torch.graft): 65,536 pod rows seeded as the reference seeds
   them, chaos rules (mean 5 s), K=1. Its main path, three dispatches of
   its step, runs with the launch count zeroed just before and read just
   after (it must read 3); each dispatch is then held against the plain
   version from a copy of its starting state (fire_at rtol 1e-6, at most
   1e-5 of the rows differing). With the card kept busy by a device-side
   sleep, pack_wire must return before the stream drains (no host sync
   on the dispatch path). Kernel and plain times by CUDA events, beside
   the bound; the launches join the kernels line as the per-kind entry's.
3. Engine: the port's threaded single-lane ClusterEngine (the normal
   start() path, device="cuda") against the port's in-memory FakeKube
   holding 10,000 nodes and ENGINE_PODS = 12,500 pods (cut from 25,000)
   bound round-robin: every node
   Ready, every pod Running with a distinct pod IP in the CIDR; then 500
   finalizer-guarded pods are deleted gracefully and must be gone. The
   kernel's launch count is zeroed just before and read just after; it
   must be > 0. The kernel is then held bit-exact against its plain
   version at the engine's capacities.
4. Lanes: the same run with drain_shards = resolve_drain_shards(0) (the
   CLI's auto lane count): a router, a drain and an emit worker per lane
   and one coordinator over a stacked state per kind. More than one lane
   must have drained and emitted, the stacked state must have regrown,
   and the kernel is held bit-exact at the stacked capacities.
5. Restart: lanes on, 10,000 nodes and RESTART_PODS = 12,500 pods (cut
   from 25,000; the ha phase's width, whose RTO it bounds) under one
   Pending->Running rule with a constant 30 s delay, checkpoints every
   1 s. Once the checkpoint file covers every pod armed, 5 s more, then
   the engine stops (writing the final checkpoint) and a second engine
   starts on the same directory: it must become ready and close its
   restore with at least RESTART_PODS - 100 rows refined; each pod's fire_at - now,
   read back from the card, must lie within 2 s of its checkpointed
   residue; no pod may go Running in the store more than 1 s before that
   deadline (seen on a watch), the engine must have every pod Running
   within 10 s after it (its host mirror, polled), and every pod must
   reach Running in the store.
6. CLI: the real entry point, kwok_tpu_torch.kwok.cli.main, on a thread of
   this script, against the port's native mock apiserver in a subprocess
   of its own (the binary apiserver.cc builds, --port 0; its GET
   /debug/flight must name the server "native", or the phase fails), with a
   Stage file of JSON documents: the default pod-delete stage and two
   weighted Pending->Running stages (weights 3 and 1, uniform 0.1-0.5 s
   and 0.5-1.0 s). 10,000 nodes exist before the CLI starts; /readyz must
   answer 503 until the first re-list is ingested and 200 after. A spawned
   creator process then creates 25,000 pods over several keep-alive HTTP
   connections: every node Ready, every pod Running with a distinct pod IP
   in the CIDR, then 500 finalizer-guarded pods deleted with grace 30 s
   must be gone; /metrics must parse with kwok_ticks_total > 0 and
   kwok_status_patches_total >= 35,000; main must return 0 once stopped.
   The CLI's default --drain-shards must have built lanes of the auto
   count; the per-lane drain and emit seconds are read from /metrics.
   The launch count (zeroed before main) must be > 0. After the phase the
   kernel is held bit-exact against its plain version at the CLI engine's
   stacked capacities with the Stage rule tables, over two dispatches
   that re-arm half the pod rows through the weighted uniform draw and
   fire them.
   Every HTTP phase (6, 6b, 6c, 7, 8, 9) runs the native edge
   (kwok_tpu_torch/native, built with g++ at first use) and fails unless
   it did: the requests the native pump shipped
   (kwok_pump_requests_total, summed over the lane processes or the
   shard series) must be > 0; under lanes the events the router
   partitioned natively
   (kwok_route_partition_events_total, summed over the shards) must be
   > 0 and within the phase's kwok_watch_events_total (times the lane
   count for process lanes, whose node windows go to every lane); in a
   federation the batched parses (kwok_tick_stage_seconds{stage="parse"})
   must be > 0. Each reports the kwok process's CPU seconds per 1,000
   pods over its create->Running window, and the mock's CPU seconds per
   1,000 pods, the creator's seconds for its pods,
   kwok_watch_terminations_total{reason} from the mocks' /metrics
   and kwok_watch_relists_total from kwok's.
6a. Trace (run between 6 and 6c): the CLI phase's path on the native
   mock at TRACE_PODS = 5,000 pods (cut from 25,000, then 10,000) with
   --profile-dir, --trace-dump, --trace-sample-every 256 and
   KWOK_TPU_FLIGHT_DIR under a temporary directory. Each of these
   fails the run: /debug/trace must answer 200 during the flood with a
   document that passes the Chrome trace-event check and holds
   tick.dispatch, tick.emit, pump.send and at least one sampled
   pod.ingest_to_patch span; a fresh degradation (set, then cleared)
   must save the mock's /debug/flight into the flight directory; after
   stop the trace dump must exist and parse, the mock's /debug/flight
   must pass check_flight, and merge_timeline of the two must hold the
   engine's pid 0 and the apiserver's pid 1; the torch.profiler window
   (ticks [2, 102) on the coordinator's tick thread) must hold one
   tick_kernel event per launch its sidecar recorded; and the kernel is
   held bit-exact at the engine's capacities. Reported on a line before
   the kernels line: the device busy and idle share over the profiled
   window (the union of the GPU kernel, memcpy and memset intervals over
   the window's wall time), tick_kernel events with their summed and
   median µs, the profile's bytes, the spans recorded, and the phase's
   pods/s against the CLI phase's (the cost of tracing).
6b. Native A/B: the CLI phase's path again, in the same call, at 12,500
   pods (cut from 25,000), under
   KWOK_TPU_NATIVE=0 (json.loads per event, Python routing, one executor
   job per patch) against the native mock: the same checks but a
   partitioned count and pumped requests of exactly 0; printed beside the
   CLI phase: create->Running pods/s, the kwok CPU seconds per 1,000 pods
   and the mock's CPU seconds over the window, the lanes' summed drain
   and emit seconds, the pump's requests and kwok_pump_send_seconds_sum.
6c. Python mock (cli_python_mock, run between 6 and 6b): the CLI phase
   again, in the same call, against the port's Python mock (python3 -m
   kwok_tpu_torch.edge.mockserver --port 0; its /debug/flight must
   name the server "mock"),
   the apiserver of every HTTP phase before the native one: the numbers
   that compare with earlier runs. The same checks, at PY_MOCK_NODES =
   2,500 nodes and PY_MOCK_PODS = 2,500 pods (cut from 10,000 nodes and
   25,000 pods, then 5,000 pods, to keep the script inside its time).
   In every HTTP phase, once /readyz is 200, each mock's GET
   /debug/watchers must pass check_watchers and, outside the fault
   phases, hold the engine's two watches.
7. Process lanes: the same topology at HALF_PODS = 12,500 pods (cut from
   25,000), Stage file and native mock through
   main with --lane-procs true (auto lane count) and checkpoints every 1 s:
   one spawned lane process per lane, each running its own single-lane
   engine and tick kernel on the card. /readyz 503 then 200; every node
   Ready, every pod Running with a distinct pod IP in the CIDR, the
   deleted pods gone; every lane process on cuda with kernel launches,
   every lane<i>.ckpt.json written, the parent's --trace-dump and
   every lane process's <dump>.lane<i> written and parsed; /metrics with
   kwok_status_patches_total >= nodes + pods summed over the lanes and lane
   stage seconds for at least 2 shards. Lane 0 is then SIGKILLed: it
   must be back within 60 s, kwok_lane_proc_restarts_total{shard="0"}
   must read 1, the engine must not be degraded, and 1,000 more pods
   (some owned by lane 0) must reach Running. main must return 0 with no
   lane process and no shared-memory arena left. The kernel is then held
   bit-exact against its plain version at a lane's capacities with the
   Stage rule tables. The free bytes of /dev/shm are printed first.
8. Federation (BASELINE config 5, 8 kwok apiservers federated): 8 native
   mock apiservers, each in a subprocess of its own, 1,250 nodes in each,
   then main with --master naming all 8, checkpoints every 1 s, members 0-5 on
   the CLI phase's Stage file and members 6 and 7 on a --member-config of
   pod-delete plus one constant 1 s Pending->Running stage: two rule-set
   groups, each one stacked state per kind on the card. /readyz 503 until
   every member's first re-list is in, 200 after. One spawned creator per
   member creates its 6,250 pods: every node Ready, every pod Running with
   a pod IP distinct within its member and in the CIDR; then 500
   finalizer-guarded pods, spread over the members, deleted with grace
   30 s must be gone. /metrics must parse with kwok_status_patches_total
   >= 60,000 summed over the shard series, both
   kwok_group_dispatches_total{group} > 0 and kwok_fed_pods_managed at
   49,500; every member<i>.ckpt.json written; /debug/trace one document
   under the labels federation and shard0..shard7; launches > 0; main
   returns 0.
   The kernel is then held bit-exact against its plain version at each
   group's stacked capacities with that group's rule tables (a re-arm
   dispatch and a fire dispatch).
9. Watch (the reflector: resume, 410, bookmarks): the CLI phase again
   (auto threaded lanes, 10,000 nodes, the same Stage file) with 10,000
   pods, its native mock sending bookmarks every second
   (KWOK_TPU_BOOKMARK_INTERVAL=1) and keeping WATCH_RV_WINDOW events
   (KWOK_TPU_RV_WINDOW).
   /readyz 503 then 200. During the create flood the engine's live pods
   watch connection is dropped (stop() on its handle) every 3 s, 5 times,
   and the nodes one once; each time the seconds until a new handle is
   installed are taken (resume_s). Once, between two of those, a node
   label patch, POST /compact and a pods cut: that resume must get the
   410, and the seconds until every lane ingested the re-list's prune are
   taken (relist_s), beside the pods that LIST held. After the flood, 3 s of quiet, then
   kwok_watch_bookmarks_total must be > 0; POST /compact, and once a
   bookmark has followed it (node heartbeats keep writing), both
   connections are dropped: neither may re-list. Over the phase
   kwok_watch_relists_total must move by exactly 1 (the compaction's).
   Then the usual end state (every node Ready, every pod Running with a
   distinct pod IP in the CIDR, 500 graceful deletes gone, /metrics
   parsed, launches > 0, main returns 0) and the kernel bit-exact at the
   phase engine's stacked capacities with the Stage rules.

10. Chaos (ROADMAP item 13a, run after 7): the fault plane through main's
   --faults on three topologies, each against native mocks sending
   bookmarks every second (so an idle watch thread wakes into its pill).
   (a) Threaded lanes: the CLI phase's path at HALF_PODS = 12,500 pods
   (cut from 25,000) with --faults
   CHAOS_SPEC: every 3 s a WorkerKilled pill goes into the next of
   kwok-emit0, kwok-lane0, kwok-watch-nodes and kwok-watch-pods (the
   glob's sorted matches), besides 1% dropped and 1% short pump batches
   and a stream cut per 5,000 watch lines. After the flood the engine
   stays up until the kill log holds all four names (at most 20 s more),
   then the kill window closes and the deletes run. Hard checks: at least
   3 worker.kill faults, the kill log naming a kwok-lane*, a kwok-emit*
   and a kwok-watch* thread; once the pills have landed (at most 30 s)
   every kill matched by a restart in the watchdog's restart_log, and
   kwok_worker_restarts_total moved by as much for each name; every pod
   Running with a distinct IP, the deletes gone, no patch error; not
   degraded, /readyz 200; launches > 0; the kernel bit-exact at the
   engine's capacities. Its pods/s is printed beside the CLI phase's.
   (b) Federation: 2 native mocks, 1,250 nodes and 6,250 pods each, with
   worker.kill=kwok-watch-pods-m*:2.0 (each member builds its own plane,
   as kwok_tpu's do); once every pod is Running and a member has
   restarted (at most 20 s more) the kill windows close:
   kwok_fed_member_restarts_total > 0, not degraded, each group's kernel
   bit-exact. (c) Process lanes: --lane-procs true
   --drain-shards 2, 2,000 nodes and 5,000 pods, with 2% of the ring
   descriptors dropped and 2% garbled by the parent:
   kwok_shm_desc_rejects_total > 0 (each garbled descriptor rejected by
   the lane process before it touches the ring),
   kwok_faults_injected_total{kind="shm.desc_drop"} > 0, every pod
   Running, the deletes gone, not degraded; the kernel bit-exact at lane
   0's capacities. A part that fails fails the run.

11. Drift (ROADMAP item 13b, run after 10): the anti-entropy auditor.
   (a) Threaded lanes at half the CLI phase's width (cut from 10,000
   nodes and 25,000 pods when the mesh phase took the script past 850 s):
   the native mock under
   --rig-routes (routes that change its store behind the engine's back,
   driven by drift_rig.py; its 16,384-event watch backlog cap on),
   5,000 nodes, a ClusterEngine in this process on the card with auto
   lanes, audit_interval 1.0 and kwok_tpu's drift-soak
   storm DRIFT_SPEC (seed 42: garbled, truncated, duplicated and stale
   watch lines and LIST bodies, a skewed clock, stream cuts). 12,500 pods
   are created in two halves 1 s apart by the CLI phase's creator (a
   spawned process, 8 keep-alive connections); 2.5 s after the last, the
   storm closes (rates cleared, the watch cache compacted, every watch
   stopped) and the mock's watch-cache window widens from 4,096 to
   DRIFT_RV_WINDOW = 32,768 events, so the auditor's continue tokens
   outlive a scan cycle. Hard checks: every pod Running;
   kwok_faults_injected_total > 0 for wire.garble, wire.dup and
   wire.stale; kwok_wire_rejects_total rose; every lane's queues empty
   at one moment within 180 s; no worker crash outside supervision; not
   degraded (a drift streak the storm left must clear within 120 s).
   Then, faults off and the watches quiet, once the auditor's pods scan
   has begun a cycle on the quiet store (its pages show one snapshot per
   cycle, so a seed on a pod written after it would show only in the next
   cycle; the wait is reported), 16 divergences are seeded
   behind the engine's back in the first, middle and last windows of the
   scan: 4 pods set back to Pending, 4 deleted, 4 rows' revisions set
   ahead of the server's (under their lane's stage_lock), 4 bound pods
   stored with no event. kwok_drift_detected_total must rise by at least
   4 for each reason; every seeded object must be repaired (Running on
   the server, the ghost row gone, the missed row present, the row
   revision the server's), the stale, missed and double-applied ones
   within (13 + 1) x 1.0 s + 3 s = 17 s of the seeding (a scan cycle of
   ceil(12,500 / (256 x 4)) windows and a pass), the ghosts within
   (2 x 13 + 1) x 1.0 s + 3 s = 30 s (they become suspects only when the
   next cycle ends); not degraded 3 intervals later; the kernel
   bit-exact at the engine's capacities. Every 5 s the phase logs the
   pods Running, the queue depths, re-lists, rv rewinds, audit passes and
   the mock's CPU seconds; when the pods Running and the store's
   revision stand still STALL_DUMP_S while pods are left, it logs the
   mock's threads (CPU over 1 s from /proc/<pid>/task, wchan where the
   host has it) and GET /rig/threads (each connection thread's request
   and age, the store locks held), at most twice. The storm restores no store, so no row may
   cause a second rv rewind (the engine's rv_rewind_log names the (kind,
   key) of each). Reported: pods/s against the CLI phase's,
   the mock's and this process's CPU seconds in the storm, audit passes
   with the median and largest kwok_audit_pass_seconds, detections by
   reason in the storm and after the seeding, repair seconds and passes,
   re-lists, rv rewinds and the rows that caused them, slow-watcher
   terminations, the largest summed lane queue depth (items, polled every
   20 ms: a re-list's share of a lane is one item), the re-lists routed
   with their objects each, and the seconds from the storm's close until
   every pod was Running. (b) Process lanes over HTTP: kwok's entry point
   (cli.main) in a process of its own with --lane-procs true
   --drain-shards 2 --audit-interval 1.0 against an in-process Python
   mock, 500 nodes and 1,250 pods (cut from 2,000 and 5,000, then 1,000
   and 2,500, to keep the script inside its time), then 4 stale rows, 4 ghosts and 4
   missed events seeded: the parent's /metrics must show the lanes'
   kwok_drift_detected_total summed, at least 4 for each, the stale and
   missed pods Running and kwok_pods_managed back at 1,250 within 60 s,
   /readyz 200 at the end, the process exiting 0 with lane kernel
   launches > 0. A part that fails fails the run.

12. CNI (ROADMAP item 14, run after 11): the CLI phase's path and checks
   at HALF_PODS = 12,500 pods (cut from 25,000) through main with
   --enable-cni true and the provider that
   KWOK_TPU_CNI_PROVIDER names (smoke_cni:PROVIDER, beside this script:
   IPs from 100.64.0.0/10, every setup and remove recorded), on auto
   threaded lanes against the native mock. Hard checks: every pod
   Running with the IP the provider handed it, all distinct, none in the
   pool's CIDR; one remove for each of the 500 deleted pods and no more;
   /readyz 200 and not degraded; kwok_pump_requests_total > 0 (nodes,
   heartbeats and deletes; every pod patch takes the per-pod path under
   a live provider); launches > 0; the kernel bit-exact at the engine's
   capacities. Reported: pods/s and kwok CPU seconds per 1,000 pods
   against the CLI phase's.

13. HA (ROADMAP item 12, run after 12): a warm-standby pair through
   kwok's entry point, each cli.main in a process of its own (HA_MAIN) on
   auto threaded lanes with the CLI phase's Stage file, --lease-duration
   2 and one --checkpoint-dir (checkpoints every 1 s): --ha-role primary
   --ha-identity a, then --ha-role standby --ha-identity b, against a
   native mock under --rig-routes holding HA_NODES = 5,000 nodes;
   HA_PODS = 12,500 pods (both cut by half) from
   the CLI phase's creator. Two arms: (a) the primary SIGKILLed once half
   the pods are Running; (b) SIGSTOPped at the same point and SIGCONTed
   once the standby leads (the zombie). Hard checks: before the
   takeover the standby answers /readyz 503 with ha_standby, reports
   kwok_ha_role{role="standby"} 1, 0 status patches and 0 kernel
   launches; every pod Running with a distinct pod IP; no pod patched
   Running twice (the mock's GET /rig/writes); the standby ends leader
   with kwok_lease_transitions_total 1, /readyz 200, launches > 0 and the
   kernel bit-exact at its stacked capacities (checked in its process
   once main returned); in (b) the zombie ends role lost with
   ha_lost_lease and its late writes fenced (kwok_ha_fenced_writes_total
   or the mock's 409s > 0); every live process exits 0 on SIGTERM; the
   RTO (the kill or stop until the standby's /readyz 200) below the
   restart phase's restart_recovery_seconds in this call. Reported: the
   RTO, kwok_ha_takeover_seconds, rows refined at takeover and pods/s
   against the CLI phase's.

14. kwokctl (ROADMAP item 16, run last): `python3 -m
   kwok_tpu_torch.kwokctl --name smoke create cluster --runtime mock
   --wait 120s --config F` in a subprocess (F: the CLI phase's Stages and
   its CIDR as a KwokConfiguration), with KWOK_WORKDIR in a temporary
   directory, KWOK_KUBECTL_BINARY=file:///nonexistent/kubectl, no
   kubectl on the PATH and KWOK_TPU_PLATFORM unset: the native mock
   apiserver and the port's kwok-controller as detached processes, the
   controller on the card. 10,000 nodes and 25,000 pods from the CLI
   phase's creator, 500 graceful deletes. Hard checks: every pod Running
   with a distinct pod IP in the CIDR; the mock's GET /debug/flight
   names native; `kwokctl logs kwok-controller` says the engine started
   on cuda; kwok_ticks_total and the tick.dispatch spans of the
   controller's /debug/trace > 0; `kwokctl kubectl get pods -A -o name`
   through the built-in shim names every pod; `stop cluster` leaves no
   process, `start cluster` brings /readyz back with every pod Running,
   then 1,000 more pods go Running; `snapshot save`, `snapshot restore`
   leave /readyz 200 and every pod Running; `delete cluster` removes the
   workdir and leaves no process alive. The controller logs its launches
   and capacities at each stop (both incarnations' launches join the
   kernels line); the kernel is held bit-exact in this process at the
   controller's capacities, on an engine built from its command line and
   config. Reported: pods/s against the CLI phase's, each step's
   seconds, the phase's seconds.
   Then the secure arm (ROADMAP item 16b): `kwokctl --name smoke-tls
   create cluster --runtime mock --secure-port true` in the same
   environment: kwokctl mints the cluster PKI (the card's host has
   `cryptography`) and runs the port's Python mock on HTTPS requiring
   client certificates; 1,000 nodes and 2,500 pods from creators that
   authenticate with the kubeconfig's admin pair. Hard checks: a request
   without a client certificate is refused; every pod Running with a
   distinct pod IP; `kwokctl kubectl get pods -A -o name` over mTLS names
   every pod; `stop` leaves no process and `delete` no workdir; the
   controller's launches (from its stop line) > 0 and the kernel
   bit-exact at its capacities. Reported: the arm's seconds, its pods/s
   against the CLI phase's, and the mock's failed TLS handshakes (from
   its stop line; the refused probe is one).

15. Mesh (ROADMAP item 9b, the row split, run after 8): torch.cuda.
   device_count() and each of MESH_SHARDS = 4 shards' card (round-robin
   over the visible cards: all four on one card of a one-card host) are
   printed first. (a) The kernel phase's 1,048,576 pod + 10,240 node rows
   split into the 4 shards, for the default and the chaos rules at K=1
   and K=16: three dispatches each, every wire byte for byte against the
   unsplit MultiTickKernel on the same inputs and then every state field
   equal (any differing byte fails the run), 4 launches per split
   dispatch (one fused launch per shard); then ms per dispatch, split
   and unsplit (CUDA events, median of 40 in turns), beside the byte
   bound; then graft.dryrun_multichip(4) on the card (its federation's
   pods all reach Running). (b) ClusterEngine(use_mesh=
   True) over the 4 shards in process, auto threaded lanes, the engine
   phase's 10,000 nodes and 12,500 pods against FakeKube: every pod
   Running with a distinct IP, the 500 graceful deletes gone, the stacked
   states split, launches > 0 on every shard, the kernel bit-exact at the
   split stacked capacities. (c) python -m kwok_tpu_torch.kwok
   --use-mesh true through start_cli at 1,000 nodes and 2,500 pods (the
   mesh: every visible card once): /readyz 503 then 200, every pod
   Running, kwok_pump_requests_total > 0, the log names the mesh's
   devices, launches > 0, the kernel bit-exact at its capacities. The
   federation phase (8) runs over the mesh of every visible card too.

The line before the last is {"kernels": [...]}: the fused entry
(tick_dispatch, every engine phase's launches) and the per-kind entry
(tick, the graft phase's); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

POD_ROWS = 1_048_576
NODE_ROWS = 10_240
DT = 0.05
SUBSTEPS = (1, 16)
ENGINE_NODES = 10_000
# the in-process engine and lanes phases run half the other phases' pods,
# so the whole script, federation and kwokctl phases included, stays
# inside its time limit (25,000 took a slow host past 1,150 s with the
# kwokctl phase)
ENGINE_PODS = 12_500
ENGINE_DELETES = 500
ENGINE_DEADLINE_S = 600.0
# the poll counts 60,000 objects under the FakeKube lock; polling often
# would take the interpreter lock from the engine it measures
POLL_S = 0.25
CLI_NODES = 10_000
# 25,000 pods (50,000 before the federation phase came) in the CLI,
# process-lanes and restart phases keep the whole script inside half its
# time limit on a slow host
CLI_PODS = 25_000
CLI_DELETES = 500
CLI_DEADLINE_S = 600.0
CLI_CONNS = 8  # keep-alive connections of the creator process
# the watch phase: the CLI phase's 10,000 nodes, one pod each (at 25,000
# pods its flood and deletes alone took 159 s on an H100, which would
# bring the whole script near its limit on a slow host)
WATCH_PODS = 10_000
WATCH_POD_CUTS = 5  # dropped pods connections during the flood
WATCH_CUT_EVERY_S = 3.0
WATCH_BOOKMARK_WAIT_S = 3.0  # quiet time after the flood before the bookmark check
# the mock's watch cache in events: about 15 s of the H100 flood's
# ~2,200 writes/s, where 4,096 held under 2 s, two bookmark intervals (an
# apiserver's watch cache keeps at least 75 s)
WATCH_RV_WINDOW = 32_768
PROCS_MORE_PODS = 1_000  # created after the SIGKILL of lane 0
PROCS_RESPAWN_S = 60.0
FED_MEMBERS = 8  # BASELINE config 5: 8 kwok apiservers, federated
FED_NODES = 1_250  # per member: 10,000 in all, as in the other phases
FED_PODS = 6_250  # per member: 50,000 in all
FED_DELETES = 500  # spread over the members
FED_CONNS = 4  # keep-alive connections of each member's creator process
FED_MEMBER_CONFIG = frozenset({6, 7})  # members given --member-config
RESTART_NODES = 10_000
RESTART_PODS = 12_500  # HA_PODS: the cold restart the ha phase's RTO must beat
RESTART_DELAY_S = 30.0
RESTART_EXTRA_S = 5.0  # run on after the file covers every armed pod
RESTART_DEADLINE_S = 300.0
# the chaos phase (ROADMAP item 13a): the fault plane on each topology
CHAOS_SPEC = ("seed=13;worker.kill=kwok-[elw]*[0s]:3.0;pump.drop=0.01;"
              "pump.partial=0.01;watch.cut=0.0002")
# the names the glob matches: the rotation reaches each every 4 x 3.0 s
CHAOS_NAMES = ("kwok-emit0", "kwok-lane0", "kwok-watch-nodes", "kwok-watch-pods")
CHAOS_COVER_S = 20.0  # after the flood, until the kill log reaches every name
CHAOS_SETTLE_S = 30.0  # until every armed pill has landed and restarted
CHAOS_FED_MEMBERS = 2
CHAOS_FED_SPEC = "seed=17;worker.kill=kwok-watch-pods-m*:2.0"
CHAOS_PROCS_NODES = 2_000
CHAOS_PROCS_PODS = 5_000
CHAOS_PROCS_SPEC = "seed=5;shm.desc_garble=0.02;shm.desc_drop=0.02"
# the drift phase (ROADMAP item 13b): kwok_tpu's drift soak (its DRIFT_SPEC,
# seed 42) at the CLI phase's width, then divergence seeded behind the
# engine's back; 4 objects per reason, in the first, middle and last
# windows of the auditor's scan. Part (a)'s store is the native mock under
# --rig-routes, whose routes make the silent changes (drift_rig.py drives
# them). The Python mock, in process or in a process of its own, fell
# behind the engine's patches at this width (PERF.md §6)
# part (a) at half the CLI phase's width, cut from 10,000 nodes and
# 25,000 pods when the mesh phase took the script past 850 s
DRIFT_NODES = 5_000
DRIFT_PODS = 12_500
DRIFT_SPEC = ("seed=42;wire.garble=0.08;wire.truncate=0.02;wire.dup=0.10;"
              "wire.stale=0.10;clock.jump=0.5:0.3;watch.cut=0.005")
DRIFT_AUDIT_S = 1.0  # --audit-interval
# the Python mock's watch-cache window once the drift storm has closed
# (and in the process-lane part): the storm runs under the mock's default
# 4,096 events, whose compaction pressure is part of it, but at the
# heartbeats' 333 writes/s that window lives about 12 s, less than a
# 25-pass scan cycle, so every continue token of the auditor's scan would
# expire before its cycle ends (the real apiserver compacts every 5
# minutes)
DRIFT_RV_WINDOW = 32_768
DRIFT_STORM_TAIL_S = 2.5  # after the last create, before the storm closes
DRIFT_DEADLINE_S = 420.0  # from the engine's start until every pod is Running
DRIFT_DRAIN_S = 180.0  # after every pod is Running, until every lane's queues are empty at once
DRIFT_DEGRADED_WAIT_S = 120.0  # after that, until a drift streak the storm left has cleared
DRIFT_SEEDS = {  # pod index -> the divergence seeded there
    **{i: "stale-row" for i in (10, 500, 6_250, 12_400)},
    **{i: "ghost-row" for i in (20, 510, 6_260, 12_410)},
    **{i: "double-apply" for i in (30, 520, 6_270, 12_420)},
    **{i: "missed-event" for i in (40, 530, 6_280, 12_440)},
}
# the repair bounds in seconds: one scan cycle of ceil(pods / (256 x 4))
# windows plus a pass, at one pass per DRIFT_AUDIT_S, and 3 s; a ghost
# becomes a suspect only when the next cycle ends, so two cycles
# (kwok_tpu's 4 s bound holds only when one window covers the cluster).
# The passes each repair took are reported beside them
DRIFT_CYCLE = -(-DRIFT_PODS // (256 * 4))
DRIFT_REPAIR_S = (DRIFT_CYCLE + 1) * DRIFT_AUDIT_S + 3.0
DRIFT_GHOST_REPAIR_S = (2 * DRIFT_CYCLE + 1) * DRIFT_AUDIT_S + 3.0
# part (b), cut from 2,000 nodes and 5,000 pods, then 1,000 and 2,500
# (each after cli_python_mock), to keep the script inside its time with
# part (a) at full width
DRIFT_PROCS_NODES = 500
DRIFT_PROCS_PODS = 1_250
DRIFT_PROCS_SEEDS = {
    **{i: "stale-row" for i in (10, 350, 625, 1_200)},
    **{i: "ghost-row" for i in (20, 355, 630, 1_205)},
    **{i: "missed-event" for i in (30, 360, 640, 1_215)},
}
DRIFT_PROCS_REPAIR_S = 60.0
# the cli_python_mock phase's nodes and pods, cut from 10,000 and 25,000
# (pods to 5,000, then both to 2,500) to keep the script inside its time
PY_MOCK_NODES = 2_500
PY_MOCK_PODS = 2_500
# the ha phase (ROADMAP item 12): a warm-standby pair through main at
# half the CLI phase's width (cut to keep the script inside its time),
# its lease held 2 s (--lease-duration)
HA_NODES = 5_000
HA_PODS = 12_500
HA_LEASE_S = 2
HA_DEADLINE_S = 300.0
HA_TAKEOVER_S = 60.0  # the kill until the standby's /readyz 200, at most
HA_DEPOSE_S = 30.0  # SIGCONT until the zombie reports role lost, at most
# a drift run whose pods and store revision stand still this long dumps
# the native mock's threads (GET /rig/threads, /proc/<pid>/task)
STALL_DUMP_S = 20.0
TRACE_PODS = 5_000  # the trace phase's pods, cut from 25,000, then 10,000, likewise
AB_OFF_PODS = 12_500  # the native A/B's off arm, cut from 25,000 likewise
# the process-lanes, chaos and CNI phases' pods, cut from 25,000 likewise
# (their fixed waits stay)
HALF_PODS = 12_500
# the mesh phase: 4 shards round-robin over the visible cards (all four
# on one card of a one-card host); its entry-point leg at a tenth of the
# CLI phase's width
MESH_SHARDS = 4
MESH_CLI_NODES = 1_000
MESH_CLI_PODS = 2_500
MESH_REPS = 20  # timed dispatches per turn (two turns each: median of 40)
DEVICE = "cuda"
# the native mock apiserver's binary (kwok_tpu_torch/native/apiserver.cc),
# built once by main(); every HTTP phase but the cli_python_mock arm runs it
APISERVER: "str | None" = None
MOCK_START_S = 30.0  # a mock apiserver's start until its "listening on" line
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# bytes a row moves per fused dispatch (csrc/tick.cu): reads 2x1 B bools
# + 7x4 B fields, writes 6x4 B fields back and 5 B and 3 bits of wire
ROW_BYTES = 30 + 24 + 5 + 3 / 8
# ... and per launch of the per-kind entry: the same reads and state
# writes, and 3x1 B masks
ROW_BYTES_PER_KIND = 30 + 27


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def make_states(np, seed: int):
    """Node and pod populations (numpy, then on the card) from a seed:
    pods Pending or Running, a few with a deletionTimestamp; nodes
    Observed or Ready with the heartbeat bit set."""
    from kwok_tpu_torch.ops import state as ts

    nodes, pods = host_states(np, seed)
    return ts.from_numpy(nodes, DEVICE), ts.from_numpy(pods, DEVICE)


def host_states(np, seed: int):
    """``make_states``' populations as numpy states, on the host."""
    from kwok_tpu_torch.ops import state as ts

    rng = np.random.default_rng(seed)
    pods = ts.to_numpy(ts.new_row_state(POD_ROWS, "cpu"))
    pods.active[: POD_ROWS - 1000] = True
    pods.phase[:] = rng.choice([0, 1], POD_ROWS)  # Pending / Running ids
    pods.sel_bits[:] = 0b11
    pods.has_deletion[:] = rng.random(POD_ROWS) < 0.05
    nodes = ts.to_numpy(ts.new_row_state(NODE_ROWS, "cpu"))
    nodes.active[:] = True
    nodes.phase[:] = rng.choice([0, 1], NODE_ROWS)
    nodes.sel_bits[:] = 0b11
    nodes.hb_due[:] = (rng.random(NODE_ROWS) * 0.5).astype(np.float32)
    return nodes, pods


def clone(state):
    return type(state)(*(t.clone() for t in state))


def kernel_phase(torch, np, sass: dict):
    """Both entries of csrc/tick.cu at 10,240 + 1,048,576 rows, default
    and chaos rules, K = 1 and 16, three dispatches each from copies of
    one state: the fused dispatch (``tick_dispatch``: one launch for both
    kinds that writes the wire, and its epilogue) and the per-kind entry
    (``tick_steps``), each held against the plain version
    (``tick_steps_plain`` per kind, then ``pack_wire``). Default rules:
    the fused wire equals the plain wire byte for byte, and every state
    field of both entries and the per-kind masks equal the plain ones.
    Chaos rules: fire_at rtol 1e-6, next_due rtol 1e-6, at most 1e-5 of
    the rows differing in any field, mask, wire row or counter. Under
    every rule set the two entries' states are equal bit for bit (they
    share one substep function). Then ``time_dispatch``'s times against
    the byte bound and the operation bound of ``sass`` (the build's
    per-substep instruction counts, ``sass_bound.py``)."""
    from kwok_tpu_torch.models import compile_rules, default_node_rules, default_pod_rules
    from kwok_tpu_torch.models.defaults import chaos_pod_rules
    from kwok_tpu_torch.models.lifecycle import ResourceKind
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.cuda_tick import pack_wire
    from kwok_tpu_torch.ops.tick import unpack_wire

    import sass_bound

    ntab = compile_rules(default_node_rules(), ResourceKind.NODE)
    node_spec = cuda_tick.TickSpec(ntab, 30.0, (), 1)
    rule_sets = {
        "default": cuda_tick.TickSpec(
            compile_rules(default_pod_rules(), ResourceKind.POD), 30.0, (), -1),
        "chaos": cuda_tick.TickSpec(
            compile_rules(chaos_pod_rules(5.0), ResourceKind.POD), 30.0, (), -1),
    }
    caps = [NODE_ROWS, POD_ROWS]
    rows_total = sum(caps)
    configs = []
    max_abs_err = 0.0
    for rname, pod_spec in rule_sets.items():
        specs = (node_spec, pod_spec)
        exact = rname == "default"
        limit = 0 if exact else int(1e-5 * rows_total)
        for steps in SUBSTEPS:
            nodes0, pods0 = make_states(np, seed=steps)
            # three dispatches: fresh arming, firing, later completions
            for n, now in enumerate((0.0, 0.8, 6.0), start=1):
                seed = cuda_tick.SEED_BASE + n
                fused = [clone(nodes0), clone(pods0)]
                per_kind = [clone(nodes0), clone(pods0)]
                plain = [clone(nodes0), clone(pods0)]
                _, kwire = cuda_tick.tick_dispatch(fused, specs, now, seed, steps, DT)
                kres = [cuda_tick.tick_steps(st, spec, now, seed, steps, DT)
                        for st, spec in zip(per_kind, specs)]
                pres = []
                for st, spec in zip(plain, specs):
                    d, x, h, c = cuda_tick.tick_steps_plain(st, spec, now, seed, steps, DT)
                    pres.append(TickOutputs(st, d, x, h, c[0], c[1]))
                pwire = pack_wire(pres)
                torch.cuda.synchronize()
                for kind, fs, ks, (kd, kx, kh, kc), po in zip(
                        ("nodes", "pods"), fused, per_kind, kres, pres):
                    for f in fs._fields:
                        if not torch.equal(getattr(fs, f), getattr(ks, f)):
                            raise AssertionError(f"{rname} K={steps} {kind}: the entries' {f} differ")
                    kf, pf = fs.fire_at, po.state.fire_at
                    if not torch.equal(torch.isinf(kf), torch.isinf(pf)):
                        raise AssertionError(f"{rname} K={steps} {kind}: +inf fire_at positions differ")
                    fin = ~torch.isinf(kf)
                    err = float((kf[fin] - pf[fin]).abs().max()) if bool(fin.any()) else 0.0
                    max_abs_err = max(max_abs_err, err)
                    rel = (kf[fin] - pf[fin]).abs() / pf[fin].abs().clamp(min=1e-30)
                    if bool(fin.any()) and float(rel.max()) > (0.0 if exact else 1e-6):
                        raise AssertionError(f"{rname} K={steps} {kind}: fire_at rel err {float(rel.max())}")
                    differ = torch.zeros_like(kd)
                    for f in ("phase", "cond_bits", "pending_rule", "hb_due", "gen"):
                        differ |= getattr(fs, f) != getattr(po.state, f)
                    for km, pm in ((kd, po.dirty), (kx, po.deleted), (kh, po.hb_fired)):
                        differ |= km != pm
                    nd = int(differ.sum())
                    if nd > limit:
                        raise AssertionError(f"{rname} K={steps} {kind}: {nd} rows differ (limit {limit})")
                    if int((kc - torch.stack([po.transitions, po.heartbeats])).abs().max()) > limit:
                        raise AssertionError(f"{rname} K={steps} {kind}: counters differ")
                if exact:
                    if not torch.equal(kwire, pwire):
                        raise AssertionError(f"{rname} K={steps}: wire bytes differ")
                else:
                    kc_, km_, kd_, kr_ = unpack_wire(kwire.cpu().numpy(), caps, lazy=False, rows=True)
                    pc_, pm_, pd_, pr_ = unpack_wire(pwire.cpu().numpy(), caps, lazy=False, rows=True)
                    kr_, pr_ = kr_(), pr_()
                    if int(np.abs(kc_.astype(np.int64) - pc_).max()) > limit:
                        raise AssertionError(f"{rname} K={steps}: wire counters differ")
                    if not np.allclose(kd_, pd_, rtol=1e-6, atol=0.0):
                        raise AssertionError(f"{rname} K={steps}: next_due {kd_} against {pd_}")
                    for k, cap in enumerate(caps):
                        differ = np.zeros(cap, bool)
                        for a, b in zip(km_[k] + kr_[k], pm_[k] + pr_[k]):
                            differ |= a != b
                        if int(differ.sum()) > limit:
                            raise AssertionError(f"{rname} K={steps} kind {k}: {int(differ.sum())} "
                                                 f"wire rows differ (limit {limit})")
                nodes0, pods0 = fused
            t = time_dispatch(torch, node_spec, pod_spec, steps, make_states(np, seed=99), 0.8)
            t_bytes = rows_total * ROW_BYTES / HBM_BYTES_PER_S * 1e3
            t_ops, unit = sass_bound.bound_ms(sass["fused_tick_kernel"], rows_total, steps)
            per_kind_bytes = rows_total * ROW_BYTES_PER_KIND / HBM_BYTES_PER_S * 1e3
            pk_ops, _pk_unit = sass_bound.bound_ms(sass["tick_kernel"], rows_total, steps)
            configs.append({
                "rules": rname, "substeps": steps, "rows": rows_total,
                "ms": t["fused_ms"], "dispatch_ms": t["dispatch_ms"],
                "plain_ms": t["plain_ms"], "wire_d2h_ms": t["wire_d2h_ms"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops, "ops_bound_unit": unit,
                "bytes": rows_total * ROW_BYTES,
                "per_kind_ms": t["per_kind_ms"], "per_kind_plain_ms": t["plain_tick_ms"],
                "per_kind_bound_ms": max(per_kind_bytes, pk_ops),
                "per_kind_bound_by": "bytes" if per_kind_bytes >= pk_ops else "operations",
            })
            log(f"kernel {rname} K={steps}: checked; fused {t['fused_ms']:.4f} ms (bound "
                f"{max(t_bytes, t_ops):.4f}: bytes {t_bytes:.4f}, {unit} {t_ops:.4f}), whole "
                f"dispatch {t['dispatch_ms']:.4f} ms, per-kind {t['per_kind_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.3f} ms, wire D2H {t['wire_d2h_ms']:.4f} ms")
    return configs, max_abs_err


def graft_phase(torch, np, sass: dict):
    """The graft twin (kwok_tpu_torch.graft.entry, the flagship step of
    __graft_entry__.entry): its main path is three dispatches of its step
    on the card from the seeded 65,536-row state, with the launch count
    zeroed just before and read just after; each dispatch is then held
    against the plain version on a copy of the state it started from
    (fire_at rtol 1e-6, at most 1e-5 of the rows differing in any field
    or mask). Then, with the card kept busy by a device-side sleep, the
    dispatch's wire (pack_wire) must be enqueued while the stream is
    still running: no host sync on the dispatch path. Kernel and plain
    times are CUDA events around the launch."""
    import sass_bound

    from kwok_tpu_torch import graft
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.cuda_tick import pack_wire

    step, (state, now0, seed) = graft.entry()
    nows = (now0, 1.0, 6.0)
    starts = []
    cuda_tick.tick_steps.launches = 0
    outs = []
    for n, now in enumerate(nows):
        starts.append(clone(state))
        outs.append(step(state, now, seed + n))
        outs[-1] = (clone(state),) + tuple(outs[-1])
    launches = cuda_tick.tick_steps.launches
    if launches != len(nows):
        raise AssertionError(f"graft: {launches} launches for {len(nows)} dispatches")
    fields = ("phase", "cond_bits", "pending_rule", "hb_due", "gen")
    max_abs_err = 0.0
    rows = graft.ROWS
    for n, (now, st0, (kst, kd, kx, kh, kc)) in enumerate(zip(nows, starts, outs)):
        pst = clone(st0)
        pd, px, ph, pc = cuda_tick.tick_steps_plain(pst, step.spec, now, seed + n, 1, 0.0)
        kf, pf = kst.fire_at, pst.fire_at
        if not torch.equal(torch.isinf(kf), torch.isinf(pf)):
            raise AssertionError(f"graft dispatch {n}: +inf fire_at positions differ")
        fin = ~torch.isinf(kf)
        if bool(fin.any()):
            diff = (kf[fin] - pf[fin]).abs()
            max_abs_err = max(max_abs_err, float(diff.max()))
            rel = float((diff / pf[fin].abs().clamp(min=1e-30)).max())
            if rel > 1e-6:
                raise AssertionError(f"graft dispatch {n}: fire_at rel err {rel}")
        differ = torch.zeros_like(kd)
        for f in fields:
            differ |= getattr(kst, f) != getattr(pst, f)
        for km, pm in ((kd, pd), (kx, px), (kh, ph)):
            differ |= km != pm
        nd, limit = int(differ.sum()), int(1e-5 * rows)
        if nd > limit or int((kc - pc).abs().max()) > limit:
            raise AssertionError(f"graft dispatch {n}: {nd} rows differ (limit {limit})")
    # no host sync on the dispatch path: with the stream busy for ~0.1 s,
    # pack_wire must return before the stream drains
    kst, kd, kx, kh, kc = outs[-1]
    wire_outs = [TickOutputs(kst, kd, kx, kh, kc[0], kc[1])]
    pack_wire(wire_outs)  # its kernels loaded before the timed call
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t = time.perf_counter()
    pack_wire(wire_outs)
    pack_host_ms = (time.perf_counter() - t) * 1e3
    busy_after = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    if not busy_after:
        raise AssertionError(f"graft: pack_wire waited for the card ({pack_host_ms:.3f} ms)")
    # CUDA events around one launch from the seeded state, and the plain
    # version on the same inputs
    times = {"kernel": [], "plain": []}
    fresh = graft.seeded_pod_state(rows, DEVICE)
    for path in ("kernel", "plain", "kernel", "plain"):
        fn = cuda_tick.tick_steps if path == "kernel" else cuda_tick.tick_steps_plain
        for rep in range(20 if path == "kernel" else 3):
            st = clone(fresh)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            fn(st, step.spec, 0.0, seed, 1, 0.0)
            e1.record()
            torch.cuda.synchronize()
            times[path].append(e0.elapsed_time(e1))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    t_bytes = rows * ROW_BYTES_PER_KIND / HBM_BYTES_PER_S * 1e3
    t_ops, unit = sass_bound.bound_ms(sass["tick_kernel"], rows, 1)
    cfg = {
        "rules": "graft chaos (mean 5 s)", "substeps": 1, "rows": rows,
        "ms": med(times["kernel"]), "plain_ms": med(times["plain"]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": rows * ROW_BYTES_PER_KIND, "ops_bound_ms": t_ops, "ops_bound_unit": unit,
        "launches": launches,
        "max_abs_err": max_abs_err, "pack_wire_host_ms_while_busy": pack_host_ms,
    }
    log(f"graft: checked; kernel {cfg['ms']:.4f} ms, plain {cfg['plain_ms']:.3f} ms, "
        f"bound {cfg['bound_ms']:.5f} ms, pack_wire {pack_host_ms:.3f} ms on the host "
        "while the card was busy")
    return cfg


def time_dispatch(torch, node_spec, pod_spec, steps, states, now, reps: int = 20) -> dict:
    """Median ms (CUDA events) on ``states`` at engine time ``now`` of:
    ``fused_ms``, the fused dispatch's two launches (``tick_dispatch``:
    the kernel for both kinds and its epilogue); ``dispatch_ms``, the
    whole dispatch (those launches and the wire's D2H copy into pinned
    memory, as ``MultiTickKernel`` runs it); ``per_kind_ms``, the per-kind
    entry's two launches (nodes + pods); ``plain_ms``, the plain version
    (``tick_steps_plain`` per kind, then ``pack_wire``) and
    ``plain_tick_ms``, its ticks alone (the per-kind entry's plain
    version); and ``wire_d2h_ms``, the wire's D2H copy alone. Each rep starts from the
    same state, copied outside the timed window; at full size the ~60 MB
    state does not fit the 50 MB L2. A device-side sleep queued first
    keeps the card busy while the host enqueues, so the events time the
    device work, not the enqueue."""
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.tick import Wire

    specs = (node_spec, pod_spec)

    def fused(sts, seed):
        return cuda_tick.tick_dispatch(sts, specs, now, seed, steps, DT)[1]

    def dispatch(sts, seed):
        Wire(fused(sts, seed))

    def per_kind(sts, seed):
        for st, spec in zip(sts, specs):
            cuda_tick.tick_steps(st, spec, now, seed, steps, DT)

    def plain_tick(sts, seed):
        return [cuda_tick.tick_steps_plain(st, spec, now, seed, steps, DT)
                for st, spec in zip(sts, specs)]

    def plain(sts, seed):
        outs = [TickOutputs(st, d, x, h, c[0], c[1])
                for st, (d, x, h, c) in zip(sts, plain_tick(sts, seed))]
        cuda_tick.pack_wire(outs)

    paths = {"fused": fused, "dispatch": dispatch, "per_kind": per_kind,
             "plain_tick": plain_tick, "plain": plain}
    times: dict = {name: [] for name in (*paths, "wire_d2h")}
    order = list(paths)
    for path in order + order[::-1]:
        fn = paths[path]
        for rep in range(3 if path.startswith("plain") else reps):
            sts = [clone(st) for st in states]
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            out = fn(sts, cuda_tick.SEED_BASE + rep)
            e1.record()
            if path == "fused":
                w0, w1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                w0.record()
                Wire(out)
                w1.record()
            torch.cuda.synchronize()
            times[path].append(e0.elapsed_time(e1))
            if path == "fused":
                times["wire_d2h"].append(w0.elapsed_time(w1))
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {f"{name}_ms": med(xs) for name, xs in times.items()}


def rearmed(state, pending_phase: int):
    """A copy of a pod state with every other active row back in Pending
    and unarmed, so the next dispatch re-matches it (through the weighted
    draw and its delay, under the Stage rules)."""
    st = clone(state)
    rows = st.active.nonzero().flatten()[::2]
    st.phase[rows] = pending_phase
    st.pending_rule[rows] = -1
    st.fire_at[rows] = float("inf")
    return st


def engine_states(eng):
    """The device states an engine ticks: the stacked ones under lanes."""
    if eng._lanes is not None:
        return (eng._lanes.stacked["nodes"], eng._lanes.stacked["pods"])
    return (eng.nodes.state, eng.pods.state)


def engine_shape_check(torch, eng, rearm: bool = False, states=None, fire_after: float = 1.0,
                       timings: "dict | None" = None):
    """The tick kernel's two entries against their plain version at the
    shapes an engine run gave it: the engine's grown capacities, its rule
    tables and the rows it left on the card, K=1 dispatches at its clock,
    bit-exact (the -fmad=false build makes constant, uniform and weighted
    draws exact): the fused dispatch's wire against the plain wire, and
    both entries' states and the per-kind entry's masks against the plain
    ones. With ``rearm``, half the pod rows are put back in Pending first
    and a second dispatch ``fire_after`` s later fires them. Returns the
    capacities and the fused dispatch's launches', the plain version's
    and the wire D2H's ms there (``timings``, when given, takes every
    time of ``time_dispatch``). Runs after the engine's launch count was
    read. ``states`` replaces the engine's own (process lanes keep theirs
    in the lane processes, a federation one stacked state per group)."""
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import TickOutputs
    from kwok_tpu_torch.ops.cuda_tick import pack_wire

    from kwok_tpu_torch.ops import state as ts

    torch.cuda.synchronize()
    fused = eng._get_fused()
    if states is None:
        states = engine_states(eng)
    # a state split over a mesh is held whole: one card state per kind
    states = tuple(ts.from_numpy(ts.to_numpy(s), DEVICE) if isinstance(s, ts.SplitState) else s
                   for s in states)
    if rearm:
        states = (states[0], rearmed(states[1], eng._pod_phase_ids["Pending"]))
    now = eng._now()
    starts = {path: [clone(s) for s in states] for path in ("fused", "per_kind", "plain")}
    for n, at in enumerate((now, now + fire_after) if rearm else (now,), start=1):
        seed = cuda_tick.SEED_BASE + n
        _, fwire = cuda_tick.tick_dispatch(
            starts["fused"], fused.specs, at, seed, fused.steps, fused.dt)
        outs = {"per_kind": [], "plain": []}
        for path, fn in (("per_kind", cuda_tick.tick_steps), ("plain", cuda_tick.tick_steps_plain)):
            for spec, st in zip(fused.specs, starts[path]):
                d, x, h, c = fn(st, spec, at, seed, fused.steps, fused.dt)
                outs[path].append(TickOutputs(st, d, x, h, c[0], c[1]))
        pwire = pack_wire(outs["plain"])
        torch.cuda.synchronize()
        for kind, fs, ko, po in zip(("nodes", "pods"), starts["fused"], outs["per_kind"],
                                    outs["plain"]):
            for f in po.state._fields:
                for entry, st in (("fused", fs), ("per-kind", ko.state)):
                    if not torch.equal(getattr(st, f), getattr(po.state, f)):
                        raise AssertionError(f"engine shapes {kind} dispatch {n}: {entry} {f} differs")
            for m in ("dirty", "deleted", "hb_fired", "transitions", "heartbeats"):
                if not torch.equal(getattr(ko, m), getattr(po, m)):
                    raise AssertionError(f"engine shapes {kind} dispatch {n}: {m} differs")
        if not torch.equal(fwire, pwire):
            raise AssertionError(f"engine shapes dispatch {n}: wire bytes differ")
        if rearm and n == 2 and int(outs["plain"][1].transitions) == 0:
            raise AssertionError("re-armed pod rows did not fire")
    caps = [st.capacity for st in states]
    t = time_dispatch(torch, fused.specs[0], fused.specs[1], fused.steps, states, now)
    if timings is not None:
        timings.update(t)
    return caps, t["fused_ms"], t["plain_ms"], t["wire_d2h_ms"]


def engine_phase(drain_shards: int = 1, use_mesh: bool = False):
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
    from kwok_tpu_torch.ops import cuda_tick

    server = FakeKube()
    cfg = EngineConfig(manage_all_nodes=True, cidr="10.0.0.1/16",
                       drain_shards=drain_shards, use_mesh=use_mesh, device=DEVICE)
    eng = ClusterEngine(server, cfg)
    lanes = eng._lanes
    if (lanes.n if lanes is not None else 1) != drain_shards:
        raise AssertionError(f"asked for {drain_shards} lanes, got {lanes}")
    if (eng._mesh is not None) != use_mesh:
        raise AssertionError(f"use_mesh={use_mesh} but the engine's mesh is {eng._mesh}")
    r0 = lanes.r if lanes is not None else 0
    cuda_tick.tick_steps.launches = 0
    t0 = time.monotonic()
    eng.start()
    try:
        for i in range(ENGINE_NODES):
            server.create("nodes", {"metadata": {"name": f"node-{i}"}})
        t_pods = time.monotonic()
        for i in range(ENGINE_PODS):
            server.create("pods", {
                "metadata": {"name": f"pod-{i}", "namespace": "default",
                             "finalizers": ["kwok.x-k8s.io/smoke"]},
                "spec": {"nodeName": f"node-{i % ENGINE_NODES}",
                         "containers": [{"name": "c", "image": "busybox"}]},
                "status": {"phase": "Pending"},
            })
        t_created = time.monotonic()

        def ready(n):
            return any(c.get("type") == "Ready" and c.get("status") == "True"
                       for c in (n.get("status") or {}).get("conditions") or [])

        def running(p):
            st = p.get("status") or {}
            return st.get("phase") == "Running" and bool(st.get("podIP"))

        deadline = t0 + ENGINE_DEADLINE_S
        while True:
            n_ready = server.count("nodes", ready)
            n_run = server.count("pods", running)
            if n_ready == ENGINE_NODES and n_run == ENGINE_PODS:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"timeout: {n_ready} nodes Ready, {n_run} pods Running")
            time.sleep(POLL_S)
        t_running = time.monotonic()
        for i in range(ENGINE_DELETES):
            server.delete("pods", "default", f"pod-{i}", grace_seconds=30)
        while server.count("pods") > ENGINE_PODS - ENGINE_DELETES:
            if time.monotonic() > deadline:
                raise AssertionError(f"timeout: {server.count('pods')} pods left")
            time.sleep(POLL_S)
        t_deleted = time.monotonic()
    finally:
        eng.stop()
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the engine ran without launching the tick kernel")
    # every survivor Running on its node with a distinct pod IP in the CIDR
    pods = server.list("pods")
    ips = {p["status"]["podIP"] for p in pods}
    if len(pods) != ENGINE_PODS - ENGINE_DELETES or len(ips) != len(pods):
        raise AssertionError(f"{len(pods)} pods, {len(ips)} distinct IPs")
    if not all(ip.startswith("10.0.") for ip in ips):
        raise AssertionError("pod IP outside the configured CIDR")
    if not all(p["status"]["hostIP"] == cfg.node_ip for p in pods):
        raise AssertionError("hostIP mismatch")
    if server.delete_count != ENGINE_DELETES:
        raise AssertionError(f"delete_count {server.delete_count}")
    m = eng.metrics
    if m["patch_errors_total"]:
        raise AssertionError(f"{m['patch_errors_total']} patch errors")
    lane_info = {}
    if lanes is not None:
        drain_s = [ln.telemetry.stage_sums["drain"] for ln in lanes.lanes]
        emit_s = [ln.telemetry.stage_sums["emit"] for ln in lanes.lanes]
        if sum(x > 0 for x in drain_s) < 2 or sum(x > 0 for x in emit_s) < 2:
            raise AssertionError(f"lanes did not share the work: drain {drain_s}, emit {emit_s}")
        if lanes.r <= r0:
            raise AssertionError(f"the stacked state never regrew ({r0} rows per lane)")
        lane_info = {"lanes": lanes.n, "rows_per_lane_start": r0,
                     "rows_per_lane_end": lanes.r,
                     "lane_drain_s": drain_s, "lane_emit_s": emit_s,
                     "lane_pods": [len(ln.engine.pods.pool) for ln in lanes.lanes]}
    import torch

    if use_mesh:
        from kwok_tpu_torch.ops.state import SplitState

        split = engine_states(eng)
        if not all(isinstance(st, SplitState) and st.mesh is eng._mesh for st in split):
            raise AssertionError("the engine's stacked states are not split over its mesh")
        if not all(n > 0 for n in eng._mesh.launches):
            raise AssertionError(f"a shard never launched: {eng._mesh.launches}")
        lane_info["shards"] = [str(d) for d in eng._mesh.devices]
        lane_info["shard_launches"] = list(eng._mesh.launches)
    timings: dict = {}
    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(torch, eng, timings=timings)
    log(f"kernel at the engine's capacities {caps} ({drain_shards} lanes): checked; fused "
        f"{shape_ms:.4f} ms, whole dispatch {timings['dispatch_ms']:.4f} ms, per-kind "
        f"{timings['per_kind_ms']:.4f} ms, plain {shape_plain_ms:.3f} ms, wire D2H "
        f"{shape_wire_ms:.4f} ms")
    return {
        **lane_info,
        "nodes": ENGINE_NODES, "pods": ENGINE_PODS, "deleted": ENGINE_DELETES,
        "create_to_running_pods_per_s": ENGINE_PODS / (t_running - t_pods),
        "pod_create_s": t_created - t_pods,
        "create_to_running_s": t_running - t_pods,
        "delete_s": t_deleted - t_running,
        "elapsed_s": t_deleted - t0,
        "ticks": m["ticks_total"], "kernel_launches": launches,
        "transitions": m["transitions_total"],
        "status_patches": m["status_patches_total"],
        "heartbeats": m["heartbeats_total"],
        "watch_events": m["watch_events_total"],
        "tick_thread_s": m["tick_seconds_sum"],
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
        "wire_d2h_ms_at_capacities": shape_wire_ms,
        "dispatch_ms_at_capacities": timings["dispatch_ms"],
        "per_kind_ms_at_capacities": timings["per_kind_ms"],
    }


def restart_phase():
    """Checkpoint, stop, restart: the residues of RESTART_PODS armed pods carry
    over to a second engine on the same directory (lanes on)."""
    import numpy as np
    import torch

    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
    from kwok_tpu_torch.models.defaults import default_pod_rules
    from kwok_tpu_torch.models.lifecycle import Delay
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.resilience import checkpoint as ckpt_mod

    workdir = tempfile.mkdtemp(prefix="kwok-ckpt-")
    path = ckpt_mod.checkpoint_path(workdir, "engine")
    server = FakeKube()
    lanes = resolve_drain_shards(0)

    def config():
        return EngineConfig(
            manage_all_nodes=True, cidr="10.0.0.1/16", drain_shards=lanes,
            pod_rules=default_pod_rules(running_delay=Delay.constant(RESTART_DELAY_S)),
            checkpoint_dir=workdir, checkpoint_interval=1.0, device=DEVICE,
        )

    def running(p):
        return (p.get("status") or {}).get("phase") == "Running"

    cuda_tick.tick_steps.launches = 0
    deadline = time.monotonic() + RESTART_DEADLINE_S
    e1 = ClusterEngine(server, config())
    e1.start()
    try:
        for i in range(RESTART_NODES):
            server.create("nodes", {"metadata": {"name": f"node-{i}"}})
        for i in range(RESTART_PODS):
            server.create("pods", {
                "metadata": {"name": f"pod-{i}", "namespace": "default"},
                "spec": {"nodeName": f"node-{i % RESTART_NODES}",
                         "containers": [{"name": "c", "image": "busybox"}]},
                "status": {"phase": "Pending"},
            })

        def covered():
            doc = ckpt_mod.load(workdir, "engine")
            pods = (doc or {}).get("kinds", {}).get("pods", {})
            return len(pods) == RESTART_PODS and all(v[2] is not None for v in pods.values())

        while not covered():
            if time.monotonic() > deadline:
                raise AssertionError("the checkpoint never covered every armed pod")
            time.sleep(1.0)
        time.sleep(RESTART_EXTRA_S)
    finally:
        e1.stop()  # writes the final checkpoint
    m1 = e1.metrics
    if server.count("pods", running):
        raise AssertionError("pods went Running before the restart: the phase ran too slowly")
    residues = {k: v[2] for k, v in ckpt_mod.load(workdir, "engine")["kinds"]["pods"].items()}
    if len(residues) != RESTART_PODS or any(v is None for v in residues.values()):
        raise AssertionError("the final checkpoint does not hold every armed pod")
    file_bytes = os.path.getsize(path)

    # every pod's first Running event, stamped when this thread sees it
    # (never before the store committed it)
    seen: dict = {}
    w = server.watch("pods")

    def follow():
        for ev in w:
            if running(ev.object):
                seen.setdefault(ev.object["metadata"]["name"], time.time())

    follower = threading.Thread(target=follow, name="running-watch")
    follower.start()
    e2 = ClusterEngine(server, config())
    t_start = time.monotonic()
    e2.start()
    try:
        while not e2.ready:
            if time.monotonic() > deadline:
                raise AssertionError("the restarted engine never became ready")
            time.sleep(0.02)
        t_ready = time.monotonic()
        while e2._restore is not None:
            if time.monotonic() > deadline:
                raise AssertionError("the restore session never closed")
            time.sleep(0.02)
        # the deadlines on the card, read on the coordinator's stream
        ls = e2._lanes
        with torch.cuda.stream(e2._stream):
            fire = ls.stacked["pods"].fire_at.cpu().numpy()
        now, wall = e2._now(), time.time()
        expected = {}
        worst = 0.0
        for li, lane in enumerate(ls.lanes):
            with lane.stage_lock:
                rows = list(lane.engine.pods.pool.items())
            for (ns, name), idx in rows:
                res = float(fire[li * ls.r + idx]) - now
                worst = max(worst, abs(res - residues[f"{ns}/{name}"]))
                expected[name] = wall + res
        if len(expected) != RESTART_PODS:
            raise AssertionError(f"{len(expected)} pods in the restarted engine's pools")
        if worst > 2.0:
            raise AssertionError(f"a refined deadline is {worst:.3f} s off its checkpointed residue")
        # when the engine itself has each pod Running (its host mirror,
        # refreshed from the consumed wire; the patch is queued then),
        # polled every 0.1 s: the poll time is never before the flip
        running_id = e2._pod_phase_ids["Running"]
        views = []
        for lane in ls.lanes:
            with lane.stage_lock:
                rows = list(lane.engine.pods.pool.items())
            views.append((lane.engine.pods, np.array([i for _, i in rows]),
                          [key[1] for key, _ in rows], np.zeros(len(rows), bool)))
        flipped = {}
        limit = max(expected.values()) + 10.0
        while len(flipped) < RESTART_PODS:
            t = time.time()
            for k, idx, names, done in views:
                new = np.nonzero((k.phase_h[idx] == running_id) & ~done)[0]
                done[new] = True
                for j in new:
                    flipped[names[j]] = t
            if time.time() > limit:
                raise AssertionError(f"the engine had {len(flipped)} of {RESTART_PODS} pods "
                                     "Running 10 s past their deadlines")
            time.sleep(0.1)
        while len(seen) < RESTART_PODS:
            if time.monotonic() > deadline:
                raise AssertionError(f"{len(seen)} of {RESTART_PODS} pods Running in the store")
            time.sleep(0.25)
    finally:
        e2.stop()
        w.stop()
        follower.join(30)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the restart phase ran without launching the tick kernel")
    early = min(seen[n] - expected[n] for n in expected)
    late = max(seen[n] - expected[n] for n in expected)
    flip_late = max(flipped[n] - expected[n] for n in expected)
    if early < -1.0 or flip_late > 10.0:
        raise AssertionError(f"pods went Running {early:.3f} s before or {flip_late:.3f} s "
                             "after their deadlines")
    m2 = e2.metrics
    if m2["restore_refined_rows"] < RESTART_PODS - 100:
        raise AssertionError(f"only {m2['restore_refined_rows']} rows refined")
    return {
        "lanes": lanes, "nodes": RESTART_NODES, "pods": RESTART_PODS,
        "delay_s": RESTART_DELAY_S,
        "refined": m2["restore_refined_rows"], "stale": m2["restore_stale_rows"],
        "restart_recovery_seconds": m2["restart_recovery_seconds"],
        "ready_after_start_s": t_ready - t_start,
        "checkpoint_bytes": file_bytes,
        "checkpoint_writes": m1["checkpoint_writes_total"],
        "snapshot_s": m1["checkpoint_snapshot_seconds_last"],
        "write_s": m1["checkpoint_write_seconds_last"],
        "max_refined_residue_error_s": worst,
        "engine_running_after_deadline_max_s": flip_late,
        "store_running_vs_deadline_s": [early, late],
        "kernel_launches": launches,
    }


STAGE_RUNNING = {"phase": "Running",
                 "conditions": {"Initialized": True, "Ready": True, "ContainersReady": True}}


def stage_documents() -> list[dict]:
    """The CLI phase's pod Stages: the default pod-delete stage and two
    weighted Pending->Running stages with uniform delays, each with the
    Running conditions of default_pod_rules."""
    def stage(name, selector, nxt, delay=None, weight=None):
        spec = {"resourceRef": {"apiGroup": "v1", "kind": "Pod"},
                "selector": selector, "next": nxt}
        if delay is not None:
            spec["delay"] = delay
        if weight is not None:
            spec["weight"] = weight
        return {"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "Stage",
                "metadata": {"name": name}, "spec": spec}

    return [
        stage("pod-delete",
              {"matchPhases": ["Pending", "Running", "Succeeded", "Failed", "Terminating"],
               "matchDeletion": "present", "matchSelector": "on-managed-node"},
              {"delete": True}, delay={"duration": 0}),
        stage("pod-running-fast", {"matchPhases": ["Pending"]}, STAGE_RUNNING,
              delay={"uniform": {"min": "100ms", "max": "500ms"}}, weight=3),
        stage("pod-running-slow", {"matchPhases": ["Pending"]}, STAGE_RUNNING,
              delay={"uniform": {"min": "500ms", "max": "1s"}}, weight=1),
    ]


def create_over_http(url: str, kind: str, count: int, conns: int,
                     nodes: int, span, first: int = 0, pod_name: str = "pod-{}",
                     kubeconfig: str = "") -> None:
    """Create ``count`` nodes, or pods bound round-robin to ``nodes``
    nodes, numbered from ``first``, over ``conns`` keep-alive connections
    (one per thread; through ``kubeconfig``'s server and credentials when
    given). Runs in a spawned process, so the creator does not share an
    interpreter lock with the engine; ``span`` (a shared double array)
    gets the wall-clock start and end."""
    from concurrent.futures import ThreadPoolExecutor

    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    client = HttpKubeClient.from_kubeconfig(kubeconfig) if kubeconfig else HttpKubeClient(url)

    def make(i: int) -> dict:
        if kind == "nodes":
            return {"metadata": {"name": f"node-{i}"}}
        return {
            "metadata": {"name": pod_name.format(i), "namespace": "default",
                         "finalizers": ["kwok.x-k8s.io/smoke"]},
            "spec": {"nodeName": f"node-{i % nodes}",
                     "containers": [{"name": "c", "image": "busybox"}]},
            "status": {"phase": "Pending"},
        }

    def run(lane: int) -> None:
        for i in range(first + lane, first + count, conns):
            client.create(kind, make(i))

    span[0] = time.time()
    with ThreadPoolExecutor(max_workers=conns) as pool:
        for f in [pool.submit(run, lane) for lane in range(conns)]:
            f.result()
    span[1] = time.time()
    client.close()


def spawn_creator(url: str, kind: str, count: int, first: int = 0,
                  nodes: "int | None" = None, conns: "int | None" = None,
                  pod_name: str = "pod-{}", kubeconfig: str = ""):
    """Start create_over_http in a spawned process (pods bound to
    ``nodes`` nodes, CLI_NODES by default, over ``conns`` connections,
    CLI_CONNS by default); returns it and its (start, end) span."""
    import multiprocessing

    nodes = CLI_NODES if nodes is None else nodes
    conns = CLI_CONNS if conns is None else conns

    ctx = multiprocessing.get_context("spawn")
    span = ctx.Array("d", 2)
    proc = ctx.Process(target=create_over_http,
                       args=(url, kind, count, conns, nodes, span, first, pod_name,
                             kubeconfig),
                       name=f"create-{kind}")
    proc.start()
    return proc, span


def join_creator(proc, deadline: float) -> None:
    proc.join(max(1.0, deadline - time.monotonic()))
    if proc.is_alive():
        proc.terminate()
        proc.join(10)
        raise AssertionError(f"{proc.name}: did not finish in time")
    if proc.exitcode != 0:
        raise AssertionError(f"{proc.name}: exit code {proc.exitcode}")


def http_get(url: str):
    """(status, body text) of a GET; (None, "") when nothing listens."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""
    except OSError:
        return None, ""


def parse_metrics(text: str) -> dict[str, float]:
    """Prometheus text exposition -> {series: value}; raises on a sample
    line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of a live process (Linux /proc)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def running(p) -> bool:
    st = p.get("status") or {}
    return st.get("phase") == "Running" and bool(st.get("podIP"))


def mock_command(mock: str) -> list:
    """The command line of a mock apiserver: ``native``, the port's native
    server (APISERVER, built by main()), or ``python``, the port's Python
    mock."""
    if mock == "python":
        return [sys.executable, "-m", "kwok_tpu_torch.edge.mockserver", "--port", "0"]
    if mock != "native" or APISERVER is None:
        raise AssertionError(f"no {mock} mock apiserver (APISERVER {APISERVER})")
    return [APISERVER, "--port", "0"]


LISTENING = "mock apiserver listening on "


def mock_url(proc) -> str:
    """The URL on a mock's "listening on" line; the lines before it are
    skipped (the native server prints "restored store from ..." first
    when given --data-file). A reader thread hands the lines over, so a
    mock that prints nothing fails after MOCK_START_S too."""
    import queue

    lines: queue.Queue = queue.Queue()

    def read() -> None:
        for line in proc.stdout:
            lines.put(line)
            if line.startswith(LISTENING):
                return
        lines.put(None)  # end of output

    threading.Thread(target=read, name="mock-stdout", daemon=True).start()
    deadline = time.monotonic() + MOCK_START_S
    seen = []
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        if line.startswith(LISTENING):
            return line.split()[-1]
        seen.append(line)
    raise AssertionError(f"mock apiserver {proc.args[0]} printed no URL in {MOCK_START_S} s "
                         f"(exit code {proc.poll()}): {seen!r}")


def check_mock(url: str, mock: str) -> None:
    """Fail unless the server at ``url`` is the mock asked for: GET
    /debug/flight names its server, "native" for the native server and
    "mock" for the Python mock."""
    code, text = http_get(url + "/debug/flight")
    want = {"native": "native", "python": "mock"}[mock]
    server = json.loads(text).get("server") if code == 200 else None
    if server != want:
        raise AssertionError(f"{url} is not the {mock} mock apiserver: GET /debug/flight "
                             f"{code}, server {server!r}")


def mock_terminations(run: dict) -> dict:
    """kwok_watch_terminations_total{reason} from the mocks' /metrics,
    summed over the mocks (the Python mock has no slow-watcher cap: its
    slow closes read 0)."""
    out: dict = {}
    for url in run["urls"]:
        code, text = http_get(url + "/metrics")
        if code != 200:
            raise AssertionError(f"{url}/metrics answered {code}")
        for series, v in parse_metrics(text).items():
            if series.startswith("kwok_watch_terminations_total{"):
                reason = series.split('reason="', 1)[1].split('"', 1)[0]
                out[reason] = out.get(reason, 0.0) + v
    return out


def start_cli(extra_argv: list, members: int = 1, nodes: "int | None" = None,
              mock_env: "dict | None" = None, mock: str = "native") -> dict:
    """The kwok entry point as a user runs it: ``members`` mock
    apiservers (``mock``: the native server, or ``python``), each in a
    subprocess of its own (``mock_env`` added to their environment) and
    each checked to be that mock, ``nodes`` nodes (CLI_NODES by default)
    created in each by a spawned process, then
    kwok_tpu_torch.kwok.cli.main on a thread of this script with --master
    naming every mock, the phase's Stage file and ``extra_argv``. /readyz
    must answer 503 until the first re-list is ingested (every member's,
    for several) and 200 after. Returns the run's handles (the engine
    main built among them); stop_cli ends it."""
    import kwok_tpu_torch.engine as engine_mod
    from kwok_tpu_torch.kwok import cli

    here = os.path.dirname(os.path.abspath(__file__))
    nodes = CLI_NODES if nodes is None else nodes
    run = {"stop": threading.Event(), "engines": [], "rc": [], "thread": None,
           "real_engines": (engine_mod.ClusterEngine, engine_mod.FederatedEngine),
           "workdir": tempfile.mkdtemp(prefix="kwok-smoke-"), "mock_kind": mock, "mocks": []}
    engines = run["engines"]

    def recorded(real):
        class Recorded(real):
            """The CLI's engine, kept for the checks after the phase."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        return Recorded

    try:
        cmd = mock_command(mock)
        for _ in range(members):
            run["mocks"].append(subprocess.Popen(
                cmd, cwd=here, stdout=subprocess.PIPE, text=True,
                env={**os.environ, **(mock_env or {})}))
        run["mock"] = run["mocks"][0]
        urls = run["urls"] = [mock_url(p) for p in run["mocks"]]
        for u in urls:
            check_mock(u, mock)
        url = run["url"] = urls[0]
        deadline = run["deadline"] = time.monotonic() + CLI_DEADLINE_S
        creators = [spawn_creator(u, "nodes", nodes, nodes=nodes) for u in urls]
        for proc, _span in creators:
            join_creator(proc, deadline)
        workdir = run["workdir"]
        stage_path = os.path.join(workdir, "stages.json")
        with open(stage_path, "w") as f:
            f.write("---\n".join(json.dumps(d) + "\n" for d in stage_documents()))
        port = free_port()
        base = run["base"] = f"http://127.0.0.1:{port}"
        argv = ["--master", ",".join(urls), "--kubeconfig", os.path.join(workdir, "no-kubeconfig"),
                "--manage-all-nodes", "true", "--server-address", f"127.0.0.1:{port}",
                "--cidr", "10.0.0.1/16", "--config", stage_path, *extra_argv]
        readyz = run["readyz"] = []

        def poll_readyz():
            while not run["stop"].is_set() and time.monotonic() < deadline:
                code, _ = http_get(base + "/readyz")
                if code is not None:
                    readyz.append(code)
                    if code == 200:
                        return
                time.sleep(0.005)

        engine_mod.ClusterEngine, engine_mod.FederatedEngine = map(recorded, run["real_engines"])
        poller = threading.Thread(target=poll_readyz, name="readyz-poll")
        poller.start()
        t_main = time.monotonic()
        run["thread"] = threading.Thread(
            target=lambda: run["rc"].append(cli.main(argv, stop_event=run["stop"])),
            name="kwok-cli")
        run["thread"].start()
        poller.join(max(1.0, deadline - time.monotonic()))
        run["main_to_ready_s"] = time.monotonic() - t_main
        if not readyz or readyz[0] != 503 or readyz[-1] != 200:
            raise AssertionError(f"/readyz: want 503 before the first re-list, then 200; "
                                 f"got {readyz[:3]}...{readyz[-3:]}")
        run["engine"] = engines[0]
        # every mock's watch census under check_watchers, the engine's
        # two watches among its live ones (under a fault plane a stream
        # may be between a cut and its resume)
        run["watchers"] = [check_mock_watchers(u, 0 if "--faults" in extra_argv else 2)
                           for u in urls]
        if run["engine"].device.type != DEVICE:
            raise AssertionError(f"the CLI's engine runs on {run['engine'].device}, not {DEVICE}")
    except BaseException:
        stop_cli(run)
        raise
    return run


def stop_cli(run: dict) -> None:
    """Stop main (its graceful drain included), then the mock apiservers;
    main must have returned 0."""
    import kwok_tpu_torch.engine as engine_mod

    t_stop = time.monotonic()
    run["stop"].set()
    t = run["thread"]
    if t is not None:
        t.join(180)
    run["stop_s"] = time.monotonic() - t_stop
    engine_mod.ClusterEngine, engine_mod.FederatedEngine = run["real_engines"]
    for mock in run["mocks"]:
        mock.terminate()
    for mock in run["mocks"]:
        try:
            mock.wait(30)
        except subprocess.TimeoutExpired:
            mock.kill()
            mock.wait(30)
    if t is not None and (t.is_alive() or run["rc"] != [0]):
        raise AssertionError(f"cli.main did not return 0 after stop: {run['rc']}")


def scrape(run: dict) -> dict:
    """/metrics of the running CLI, parsed."""
    code, text = http_get(run["base"] + "/metrics")
    if code != 200:
        raise AssertionError(f"/metrics answered {code}")
    return parse_metrics(text)


def drive_pods(run: dict, pids=(), after_running=None, pods: "int | None" = None,
               during=None) -> dict:
    """``pods`` pods (CLI_PODS by default) from a spawned creator over
    CLI_CONNS connections until every pod is Running with a pod IP
    (progress from the engine's counters, each crossing confirmed by one
    full LIST; ``during()``, when given, at each progress poll until it
    returns true), every node Ready,
    ``after_running()`` when given, then CLI_DELETES graceful deletes
    until they are gone. Returns the times, the /metrics at the start and
    at the end of the create->Running window, the CPU seconds over that
    window of the mock and of ``pids``, and the mock's watch
    terminations."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    url, deadline, mock = run["url"], run["deadline"], run["mock"]
    pods = CLI_PODS if pods is None else pods
    m0 = scrape(run)
    cpu0 = {pid: cpu_seconds(pid) for pid in (mock.pid, *pids)}
    proc, span = spawn_creator(url, "pods", pods)
    join_creator(proc, deadline)
    client = HttpKubeClient(url)
    while True:
        m_run = scrape(run)
        if during is not None and during():
            during = None
        if m_run["kwok_status_patches_total"] >= CLI_NODES + pods:
            t_patched = time.time()
            cpu_run = {pid: cpu_seconds(pid) for pid in cpu0}
            if sum(map(running, client.list("pods"))) == pods:
                break
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout: {m_run['kwok_status_patches_total']} patches")
        time.sleep(POLL_S)
    nodes = client.list("nodes")
    n_ready = sum(
        any(c.get("type") == "Ready" and c.get("status") == "True"
            for c in (n.get("status") or {}).get("conditions") or [])
        for n in nodes)
    if n_ready != CLI_NODES:
        raise AssertionError(f"{n_ready} of {CLI_NODES} nodes Ready")
    if after_running is not None:
        after_running()
    t_del = time.time()
    for i in range(CLI_DELETES):
        client.delete("pods", "default", f"pod-{i}", grace_seconds=30)
    while True:
        if scrape(run)["kwok_deletes_total"] >= CLI_DELETES:
            if len(client.list("pods")) == pods - CLI_DELETES:
                break
        if time.monotonic() > deadline:
            raise AssertionError(f"timeout deleting: {scrape(run)['kwok_deletes_total']} deletes")
        time.sleep(POLL_S)
    t_deleted = time.time()
    t_pods, t_created = span[0], span[1]
    window = t_patched - t_pods
    mock_cpu = cpu_run[mock.pid] - cpu0[mock.pid]
    return {
        "client": client, "m0": m0, "m_run": m_run,
        # the create->Running window on the wall clock
        "t_flood": (t_pods, t_patched),
        "cpu_s": {pid: cpu_run[pid] - cpu0[pid] for pid in cpu0},
        "report": {
            "nodes": CLI_NODES, "pods": pods, "deleted": CLI_DELETES,
            "connections": CLI_CONNS,
            "create_to_running_pods_per_s": pods / window,
            "pod_create_s": t_created - t_pods,
            "create_to_running_s": window,
            "delete_s": t_deleted - t_del,
            # pod patches from the first pod create until all were Running
            "status_patches_per_s": (m_run["kwok_status_patches_total"]
                                     - m0["kwok_status_patches_total"]) / window,
            # CPU seconds from the first pod create until all were Running:
            # the mock apiserver's process and this process (engine + checks)
            "window_mock_cpu_s": mock_cpu,
            "window_kwok_process_cpu_s": (m_run["process_cpu_seconds_total"]
                                          - m0["process_cpu_seconds_total"]),
            "mock": run["mock_kind"],
            "mock_cpu_s_per_1000_pods": per_1000(mock_cpu, pods),
            "watch_terminations": mock_terminations(run),
        },
    }


def check_final_pods(pods: list, m: dict) -> None:
    """After a CLI phase: no patch errors, the deleted pods gone, every
    survivor with a distinct pod IP in the CIDR."""
    if m["kwok_patch_errors_total"]:
        raise AssertionError(f"{m['kwok_patch_errors_total']} patch errors")
    names = {p["metadata"]["name"] for p in pods}
    if any(f"pod-{i}" in names for i in range(CLI_DELETES)):
        raise AssertionError("a deleted pod is still listed")
    ips = {p["status"]["podIP"] for p in pods}
    if len(ips) != len(pods) or not all(ip.startswith("10.0.") for ip in ips):
        raise AssertionError(f"{len(pods)} pods, {len(ips)} distinct IPs in the CIDR")


def lane_seconds(m: dict, n_lanes: int) -> dict:
    """Per-shard drain and emit seconds from /metrics; at least two lanes
    must have done each."""
    lane_s = {stage: [m.get(f'kwok_lane_stage_seconds_sum{{shard="{i}",stage="{stage}"}}')
                      for i in range(n_lanes)] for stage in ("drain", "emit")}
    for stage, xs in lane_s.items():
        if None in xs or sum(x > 0 for x in xs) < 2:
            raise AssertionError(f"/metrics lane {stage} seconds: {xs}")
    return lane_s


def native_edge(m: dict, events: float, lanes: int = 0, procs: bool = False,
                off: bool = False) -> dict:
    """The native edge's share of an HTTP phase from its final /metrics:
    the events the router partitioned natively (summed over the shards),
    the batched parses, and the requests the native pump shipped with its
    send seconds (summed over the lane processes or the shard series).
    Raises when the phase did not run the path it should: the pump must
    have shipped requests; under lanes the partitioned events must be > 0
    and within the phase's ``events`` (times the lane count for process
    lanes, whose node windows go to every lane), else the parses > 0;
    with ``off`` (KWOK_TPU_NATIVE=0) the partitioned count and the pump's
    requests must be 0."""
    routed = summed(m, "kwok_route_partition_events_total")
    parses = stage_sum(m, "kwok_tick_stage_seconds_count", "parse")
    pumped = summed(m, "kwok_pump_requests_total")
    out = {"partitioned_events": routed, "parses": parses, "watch_events": events,
           "parse_s": stage_sum(m, "kwok_tick_stage_seconds_sum", "parse"),
           "route_batch_s": summed(m, "kwok_route_batch_seconds_sum"),
           "pump_requests": pumped,
           "pump_send_s": summed(m, "kwok_pump_send_seconds_sum"),
           "pump_batches": summed(m, "kwok_pump_send_seconds_count")}
    if off:
        if routed or pumped:
            raise AssertionError(f"KWOK_TPU_NATIVE=0 still partitioned {routed} events "
                                 f"and pumped {pumped} requests")
        return out
    if pumped <= 0:
        raise AssertionError("no request went through the native pump: the native emit did not run")
    if lanes:
        cap = events * (lanes if procs else 1)
        if not 0 < routed <= cap:
            raise AssertionError(f"native routing: {routed} partitioned events for "
                                 f"{events} watch events: the native path did not run")
    elif parses <= 0:
        raise AssertionError("no batched native parse: the native path did not run")
    return out


def per_1000(cpu_s: float, pods: int) -> float:
    return cpu_s * 1000.0 / pods


def dispatch_stats(doc: dict, t0: float, t1: float) -> dict:
    """The ``tick.dispatch`` spans of a Chrome trace document that start
    in [t0, t1) (wall-clock seconds): how many, per second, when the
    first one starts (seconds after t0), the gaps between consecutive
    starts (median, largest, and where the largest begins, in seconds
    after t0) and the spans' own lengths."""
    ep = doc["otherData"]["epoch_unix"]
    inside = sorted(
        (ep + e["ts"] / 1e6, e["dur"] / 1e6) for e in doc["traceEvents"]
        if e["ph"] == "X" and e["name"] == "tick.dispatch"
        and t0 <= ep + e["ts"] / 1e6 < t1)
    starts = [a for a, _ in inside]
    gaps = [(b - a, a) for a, b in zip(starts, starts[1:])]
    durs = sorted(d for _, d in inside)
    big = max(gaps) if gaps else (None, None)
    return {
        "dispatches": len(inside),
        "per_s": len(inside) / (t1 - t0) if t1 > t0 else 0.0,
        "first_at_s": starts[0] - t0 if starts else None,
        "gap_median_s": sorted(gaps)[len(gaps) // 2][0] if gaps else None,
        "gap_max_s": big[0],
        "gap_max_at_s": None if big[1] is None else big[1] - t0,
        "dispatch_median_ms": durs[len(durs) // 2] * 1e3 if durs else None,
        "dispatch_max_ms": durs[-1] * 1e3 if durs else None,
    }


def cli_phase(native_off: bool = False, mock: str = "native"):
    """The CLI phase against ``mock`` (see the module docstring, phases 6,
    6b and 6c)."""
    import torch

    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.ops import cuda_tick

    n_lanes = resolve_drain_shards(0, 0)
    cuda_tick.tick_steps.launches = 0
    if native_off:
        os.environ["KWOK_TPU_NATIVE"] = "0"
    try:
        run = start_cli([], mock=mock)
    finally:
        os.environ.pop("KWOK_TPU_NATIVE", None)
    try:
        eng = run["engine"]
        if eng._lanes is None or eng._lanes.n != n_lanes:
            raise AssertionError(f"the CLI's default --drain-shards did not run {n_lanes} lanes")
        if (eng._batch_parser is None) != native_off or (eng._emit_tpl is None) != native_off:
            raise AssertionError(f"native parser {eng._batch_parser}, emit templates "
                                 f"{eng._emit_tpl} with native_off={native_off}")
        load = drive_pods(run)
        flood = dispatch_stats(eng.trace_chrome(), *load["t_flood"])
        pods = load["client"].list("pods")
        m = scrape(run)
    finally:
        stop_cli(run)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the CLI ran without launching the tick kernel")
    if m["kwok_ticks_total"] <= 0 or m["kwok_status_patches_total"] < CLI_NODES + CLI_PODS:
        raise AssertionError(f"/metrics: {m}")
    check_final_pods(pods, m)
    lane_s = lane_seconds(m, n_lanes)
    log(f"cli lanes: drain s {lane_s['drain']}, emit s {lane_s['emit']}")
    timings: dict = {}
    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(
        torch, eng, rearm=True, timings=timings)
    log(f"kernel at the CLI engine's capacities {caps} with the Stage rules: checked; "
        f"fused {shape_ms:.4f} ms, whole dispatch {timings['dispatch_ms']:.4f} ms, plain "
        f"{shape_plain_ms:.3f} ms, wire D2H {shape_wire_ms:.4f} ms")
    m_run, m0 = load["m_run"], load["m0"]
    native = native_edge(m, summed(m, "kwok_watch_events_total"), lanes=n_lanes, off=native_off)
    return {
        "lanes": n_lanes, "lane_drain_s": lane_s["drain"], "lane_emit_s": lane_s["emit"],
        "lane_pods": [len(ln.engine.pods.pool) for ln in eng._lanes.lanes],
        "native": native, "native_off": native_off,
        "kwok_cpu_s_per_1000_pods": per_1000(load["report"]["window_kwok_process_cpu_s"],
                                             load["report"]["pods"]),
        **load["report"],
        "readyz_503_polls": run["readyz"].count(503),
        "watch_relists": m["kwok_watch_relists_total"],
        "status_patches": m["kwok_status_patches_total"],
        "ticks": m["kwok_ticks_total"], "kernel_launches": launches,
        # the coordinator's dispatches in the create->Running window
        "flood_dispatches": flood,
        "transitions": summed(m, "kwok_transitions_total"),
        "heartbeats": m["kwok_heartbeats_total"],
        "watch_events": summed(m, "kwok_watch_events_total"),
        "tick_thread_s": m["kwok_tick_seconds_sum"],
        # the tick thread's host seconds over the create->Running window
        "window_tick_thread_s": (m_run["kwok_tick_seconds_sum"]
                                 - m0["kwok_tick_seconds_sum"]),
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
        "wire_d2h_ms_at_capacities": shape_wire_ms,
        "dispatch_ms_at_capacities": timings["dispatch_ms"],
        "per_kind_ms_at_capacities": timings["per_kind_ms"],
    }


TRACE_SAMPLE_EVERY = 256  # the trace phase's --trace-sample-every


def trace_names(doc: dict) -> set:
    """The span names of a Chrome trace document."""
    return {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}


def trace_phase(cli_run):
    """The CLI phase's path with the engine's tracing on (see the module
    docstring, phase 6a)."""
    import torch

    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.profiling import profile_summary
    from kwok_tpu_torch.telemetry.timeline import check_flight, merge_timeline
    from kwok_tpu_torch.telemetry.trace import check_chrome_trace

    n_lanes = resolve_drain_shards(0, 0)
    tdir = tempfile.mkdtemp(prefix="kwok-trace-")
    prof_dir = os.path.join(tdir, "profile")
    trace_path = os.path.join(tdir, "trace.json")
    flight_dir = os.path.join(tdir, "flight")
    live: dict = {}
    cuda_tick.tick_steps.launches = 0
    os.environ["KWOK_TPU_FLIGHT_DIR"] = flight_dir
    try:
        run = start_cli(["--profile-dir", prof_dir, "--trace-dump", trace_path,
                         "--trace-sample-every", str(TRACE_SAMPLE_EVERY)])
        try:
            eng = run["engine"]
            if eng._lanes is None or eng._profiler is None:
                raise AssertionError("the trace phase's engine runs no lanes or no profiler")

            def poll_trace() -> bool:
                # /debug/trace while pods are still being patched: the
                # last answer that carries a sampled ingest->patch span
                code, text = http_get(run["base"] + "/debug/trace")
                if code != 200:
                    raise AssertionError(f"/debug/trace answered {code} during the flood")
                doc = json.loads(text)
                check_chrome_trace(doc)
                live["polls"] = live.get("polls", 0) + 1
                live["doc"] = doc
                return "pod.ingest_to_patch" in trace_names(doc)

            load = drive_pods(run, during=poll_trace)
            pods = load["client"].list("pods")
            # a fresh degradation edge saves the mock's flight recorder
            # into KWOK_TPU_FLIGHT_DIR; the reason is cleared again
            eng._degradation.set("smoke_probe")
            t_wait = time.monotonic() + 10.0
            while not (os.path.isdir(flight_dir) and any(
                    f.endswith(".json") for f in os.listdir(flight_dir))):
                if time.monotonic() > t_wait:
                    raise AssertionError(f"no flight dump in {flight_dir} after a degradation")
                time.sleep(0.05)
            eng._degradation.clear("smoke_probe")
            code, text = http_get(run["url"] + "/debug/flight")
            if code != 200:
                raise AssertionError(f"the mock's /debug/flight answered {code}")
            flight = json.loads(text)
            m = scrape(run)
        finally:
            stop_cli(run)
    finally:
        os.environ.pop("KWOK_TPU_FLIGHT_DIR", None)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the trace phase ran without launching the tick kernel")
    check_final_pods(pods, m)
    want = {"tick.dispatch", "tick.emit", "pump.send", "pod.ingest_to_patch"}
    if "doc" not in live or not want <= trace_names(live["doc"]):
        raise AssertionError(f"/debug/trace during the flood: spans "
                             f"{sorted(trace_names(live.get('doc', {'traceEvents': []})))}")
    with open(trace_path) as f:
        trace = json.load(f)
    check_chrome_trace(trace)
    dumps = sorted(f for f in os.listdir(flight_dir) if f.endswith(".json"))
    with open(os.path.join(flight_dir, dumps[0])) as f:
        check_flight(json.load(f))
    check_flight(flight)
    if flight.get("server") != "native":
        raise AssertionError(f"flight dump from {flight.get('server')!r}, not the native mock")
    merged = merge_timeline(trace, flight)
    pids = {e["pid"] for e in merged["traceEvents"] if e["ph"] == "X"}
    if not {0, 1} <= pids:
        raise AssertionError(f"merged timeline pids {sorted(pids)}: want the engine's 0 "
                             "and the apiserver's 1")
    prof = profile_summary(prof_dir)
    meta = prof["meta"]
    if meta["thread"] != "kwok-tick" or meta["ticks"][0] != 2 or meta["launches"] <= 0:
        raise AssertionError(f"profile window {meta}")
    if prof["kernel_events"] != meta["launches"]:
        raise AssertionError(f"the profile holds {prof['kernel_events']} tick_kernel events "
                             f"for {meta['launches']} launches in its window")
    # where the profiled window lay in the flood, and how often the
    # coordinator dispatched before and inside it (the CLI phase, the same
    # load without the profiler, for comparison)
    f0, f1 = load["t_flood"]
    w0, w1 = meta["start_unix"], meta["stop_unix"]
    placement = {
        "flood_s": f1 - f0, "start_after_first_create_s": w0 - f0,
        "stop_after_first_create_s": w1 - f0,
        "overlap_with_flood_s": max(0.0, min(w1, f1) - max(w0, f0)),
        "start_call_s": meta["start_call_s"], "stop_export_s": meta["stop_export_s"],
        "flood": dispatch_stats(trace, f0, f1),
        "flood_before_window": dispatch_stats(trace, f0, max(f0, min(w0, f1))),
        "window": dispatch_stats(trace, w0, w1),
        "cli_phase_flood": cli_run["flood_dispatches"],
    }
    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(torch, eng, rearm=True)
    log(f"kernel at the trace phase engine's capacities {caps}: checked; kernel "
        f"{shape_ms:.4f} ms, plain {shape_plain_ms:.3f} ms")
    sampled = sum(1 for e in trace["traceEvents"] if e["name"] == "pod.ingest_to_patch")
    report = load["report"]
    return {
        "lanes": n_lanes, **report, "kernel_launches": launches,
        "kwok_cpu_s_per_1000_pods": per_1000(report["window_kwok_process_cpu_s"],
                                             report["pods"]),
        "watch_relists": m["kwok_watch_relists_total"],
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "pods_per_s_vs_cli": (report["create_to_running_pods_per_s"]
                              / cli_run["create_to_running_pods_per_s"]),
        "debug_trace_polls": live["polls"],
        "spans_recorded": trace["otherData"]["spans_recorded"],
        "spans_in_dump": sum(1 for e in trace["traceEvents"] if e["ph"] == "X"),
        "sampled_ingest_to_patch": sampled, "trace_sample_every": TRACE_SAMPLE_EVERY,
        "kwok_trace_spans_total": m["kwok_trace_spans_total"],
        "trace_dump_bytes": os.path.getsize(trace_path),
        "flight_records": len(flight["records"]), "flight_dumps": len(dumps),
        "merged_events": len(merged["traceEvents"]),
        "profile": {k: v for k, v in prof.items() if k != "meta"},
        "profile_window": meta, "window_placement": placement,
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
    }


def cut_stream(eng, kind: str, deadline: float) -> float:
    """Drop the engine's live ``kind`` watch connection (``stop()`` on its
    handle) and return the seconds until its watch loop installed a new
    handle."""
    old = eng._watches[kind]
    t = time.monotonic()
    old.stop()
    while eng._watches.get(kind) is old:
        if time.monotonic() > deadline:
            # where every thread is, for the post-mortem
            import faulthandler

            faulthandler.dump_traceback(all_threads=True)
            raise AssertionError(f"the {kind} watch never reconnected")
        time.sleep(0.001)
    return time.monotonic() - t


def post_compact(url: str) -> int:
    """POST /compact on a mock apiserver; its compacted revision."""
    req = urllib.request.Request(url + "/compact", data=b"", method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())["compactedRevision"]


def watch_phase(cli_run):
    """The CLI phase's run with the reflector exercised (see the module
    docstring, phase 9)."""
    import torch

    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.ops import cuda_tick

    n_lanes = resolve_drain_shards(0, 0)
    cuda_tick.tick_steps.launches = 0
    run = start_cli([], mock_env={"KWOK_TPU_BOOKMARK_INTERVAL": "1",
                                  "KWOK_TPU_RV_WINDOW": str(WATCH_RV_WINDOW)})
    cuts = {"pods": [], "nodes": []}
    info: dict = {}
    try:
        eng = run["engine"]
        if eng._lanes is None or eng._lanes.n != n_lanes:
            raise AssertionError(f"the CLI's default --drain-shards did not run {n_lanes} lanes")
        deadline = run["deadline"]
        client = HttpKubeClient(run["url"])
        relists0 = scrape(run)["kwok_watch_relists_total"]
        # every lane's RESYNC ingest, stamped (the lanes call the parent's)
        resyncs: list = []
        mark = eng._mark_resync

        def marked(kind, lane=0):
            resyncs.append((kind, lane, time.monotonic()))
            mark(kind, lane)

        eng._mark_resync = marked
        # each LIST the engine makes: (kind, objects, when)
        lists: list = []
        real_list = eng.client.list

        def counted_list(kind, **kw):
            out = real_list(kind, **kw)
            lists.append((kind, len(out), time.monotonic()))
            return out

        eng.client.list = counted_list
        errors: list = []
        flood_over = threading.Event()

        def compaction_relist():
            # the pods stream resumes from the last revision it received,
            # and pod writes go on under the flood: its next handshake is
            # held until the stream is over (its resume revision fixed),
            # a node write the pods stream never sees has landed above
            # that revision, and the store is compacted there, so this
            # resume must get the 410 and re-list
            entered, release = threading.Event(), threading.Event()
            held: dict = {}
            watch = eng.client.watch

            def held_watch(kind, **kw):
                if kind == "pods" and not entered.is_set():
                    held["resume_rv"] = kw.get("resource_version", 0)
                    entered.set()
                    release.wait(max(1.0, deadline - time.monotonic()))
                return watch(kind, **kw)

            gen, n0 = eng._stream_gen.get("pods", 0), len(resyncs)
            eng.client.watch = held_watch
            try:
                t = time.monotonic()
                eng._watches["pods"].stop()
                if not entered.wait(max(1.0, deadline - time.monotonic())):
                    raise AssertionError("the cut pods stream never came back to its handshake")
                client.patch_meta("nodes", None, "node-0",
                                  {"metadata": {"labels": {"kwok-smoke": "compact"}}})
                info["compacted_mid_flood"] = post_compact(run["url"])
                if not 0 < held["resume_rv"] < info["compacted_mid_flood"]:
                    raise AssertionError(f"pods resume {held['resume_rv']} not below the "
                                         f"compaction at {info['compacted_mid_flood']}")
            finally:
                release.set()
                del eng.client.watch
            while {ln for k, ln, _ in resyncs[n0:] if k == "pods"} != set(range(n_lanes)):
                if time.monotonic() > deadline:
                    raise AssertionError("the re-list after the 410 never reached every lane")
                time.sleep(0.005)
            info["relist_s"] = max(ts for k, _, ts in resyncs[n0:] if k == "pods") - t
            info["relist_objects"] = next(n for k, n, ts in lists if k == "pods" and ts >= t)
            if eng._stream_gen.get("pods", 0) <= gen:
                raise AssertionError("the resume after the compaction did not get its 410")
            info["relist_during_flood"] = not flood_over.is_set()

        def cutter():
            # every WATCH_CUT_EVERY_S s a pods cut; the nodes cut and the
            # compaction between two of them; each step waits for the one
            # before (a cut during the 410's re-list would re-list again)
            try:
                for i in range(WATCH_POD_CUTS):
                    time.sleep(WATCH_CUT_EVERY_S)
                    cuts["pods"].append((cut_stream(eng, "pods", deadline),
                                         not flood_over.is_set()))
                    if i == 0:
                        time.sleep(WATCH_CUT_EVERY_S / 2)
                        cuts["nodes"].append((cut_stream(eng, "nodes", deadline),
                                              not flood_over.is_set()))
                    elif i == 1:
                        time.sleep(WATCH_CUT_EVERY_S / 2)
                        compaction_relist()
            except Exception as e:  # re-raised on the phase's thread
                errors.append(e)

        def bookmarks():
            # the flood is over: quiet pods stream, node heartbeats only
            flood_over.set()
            cut_thread.join(max(1.0, deadline - time.monotonic()))
            if errors:
                raise errors[0]
            if cut_thread.is_alive():
                raise AssertionError("the cuts during the flood did not finish by the deadline")
            time.sleep(WATCH_BOOKMARK_WAIT_S)
            m = scrape(run)
            info["bookmarks_before_compact"] = m["kwok_watch_bookmarks_total"]
            if info["bookmarks_before_compact"] <= 0:
                raise AssertionError("no bookmark reached the engine")
            relists = m["kwok_watch_relists_total"]
            gens = dict(eng._stream_gen)
            info["compacted_after_flood"] = post_compact(run["url"])
            # node heartbeats keep writing, so the bookmark a resume rides
            # is the first one after the compaction (one per interval)
            t_bm = time.monotonic() + 10.0
            while scrape(run)["kwok_watch_bookmarks_total"] < info["bookmarks_before_compact"] + 2:
                if time.monotonic() > t_bm:
                    raise AssertionError("no bookmark after the compaction")
                time.sleep(0.05)
            info["resume_after_compact_s"] = [cut_stream(eng, k, deadline) for k in ("nodes", "pods")]
            time.sleep(1.0)  # a 410 would have re-listed by now
            if scrape(run)["kwok_watch_relists_total"] != relists or dict(eng._stream_gen) != gens:
                raise AssertionError("a resume after the compaction re-listed: the bookmark "
                                     "revision did not carry it")

        cut_thread = threading.Thread(target=cutter, name="watch-cutter")
        cut_thread.start()
        try:
            load = drive_pods(run, after_running=bookmarks, pods=WATCH_PODS)
        finally:
            flood_over.set()
            cut_thread.join(60)
        if errors:
            raise errors[0]
        pods = load["client"].list("pods")
        m = scrape(run)
        client.close()
    finally:
        run["engine"].client.__dict__.pop("list", None)
        stop_cli(run)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the watch phase ran without launching the tick kernel")
    if len(cuts["pods"]) < WATCH_POD_CUTS or len(cuts["nodes"]) != 1:
        raise AssertionError(f"cuts: {cuts}")
    relists = m["kwok_watch_relists_total"] - relists0
    if relists != 1:
        raise AssertionError(f"{relists} re-lists after start; only the compaction's one may re-list")
    check_final_pods(pods, m)
    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(torch, eng, rearm=True)
    log(f"kernel at the watch phase's capacities {caps} with the Stage rules: checked; "
        f"kernel {shape_ms:.4f} ms, plain {shape_plain_ms:.3f} ms, wire D2H {shape_wire_ms:.4f} ms")
    resume = sorted(s for s, _ in cuts["pods"] + cuts["nodes"])
    native = native_edge(m, summed(m, "kwok_watch_events_total"), lanes=n_lanes)
    return {
        "lanes": n_lanes, **load["report"], "native": native,
        "kwok_cpu_s_per_1000_pods": per_1000(load["report"]["window_kwok_process_cpu_s"],
                                             WATCH_PODS),
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "readyz_503_polls": run["readyz"].count(503), "main_to_ready_s": run["main_to_ready_s"],
        "cuts": len(resume), "cuts_during_flood": sum(f for _, f in cuts["pods"] + cuts["nodes"]),
        "pods_resume_s": [s for s, _ in cuts["pods"]], "nodes_resume_s": [s for s, _ in cuts["nodes"]],
        "resume_s_median": resume[len(resume) // 2], "resume_s_max": resume[-1],
        **info,
        "relists_after_start": relists, "watch_relists": m["kwok_watch_relists_total"],
        "bookmarks": m["kwok_watch_bookmarks_total"],
        "stale_rv_rejects": m.get('kwok_wire_rejects_total{reason="stale_rv"}', 0.0),
        "client_throttle_seconds": m["kwok_client_throttle_seconds_total"],
        "status_patches": m["kwok_status_patches_total"],
        "ticks": m["kwok_ticks_total"], "kernel_launches": launches,
        "watch_events": summed(m, "kwok_watch_events_total"),
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
        "wire_d2h_ms_at_capacities": shape_wire_ms,
        "bound_ms_at_capacities": byte_bound_ms(caps),
    }


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def lane_states(np, eng, caps, seed: int = 7, shards: "int | None" = None):
    """Node and pod states at one lane process's capacities, populated
    like its shard (its share of the nodes Ready with heartbeats, its pods
    Pending or Running, all managed), with the engine's selector bits:
    what that lane's kernel launches see. ``shards`` is the number of
    shards the population splits into (the engine's lane processes by
    default; 1 fills a stacked state with the whole population, up to its
    capacity)."""
    from kwok_tpu_torch.models.defaults import (
        SEL_HEARTBEAT,
        SEL_MANAGED,
        SEL_ON_MANAGED_NODE,
    )
    from kwok_tpu_torch.models.lifecycle import NODE_PHASES
    from kwok_tpu_torch.ops import state as ts

    rng = np.random.default_rng(seed)
    n_cap, p_cap = caps
    nodes = ts.to_numpy(ts.new_row_state(n_cap, "cpu"))
    shards = eng._proc.n if shards is None else shards
    n_live = min(n_cap, -(-CLI_NODES // shards))
    nodes.active[:n_live] = True
    nodes.phase[:n_live] = NODE_PHASES.phase_id("Ready")
    nodes.sel_bits[:n_live] = (1 << eng.node_bits[SEL_MANAGED]) | (1 << eng.node_bits[SEL_HEARTBEAT])
    nodes.hb_due[:n_live] = (rng.random(n_live) * 0.5).astype(np.float32)
    pods = ts.to_numpy(ts.new_row_state(p_cap, "cpu"))
    p_live = min(p_cap, -(-CLI_PODS // shards))
    pods.active[:p_live] = True
    pods.phase[:p_live] = rng.choice([eng._pod_phase_ids["Pending"], eng._pod_phase_ids["Running"]], p_live)
    pods.sel_bits[:p_live] = (1 << eng.pod_bits[SEL_MANAGED]) | (1 << eng.pod_bits[SEL_ON_MANAGED_NODE])
    return ts.from_numpy(nodes, DEVICE), ts.from_numpy(pods, DEVICE)


def byte_bound_ms(caps) -> float:
    """The byte bound of one dispatch (both kinds) at these capacities."""
    return sum(caps) * ROW_BYTES / HBM_BYTES_PER_S * 1e3


def _alive(pid: int) -> bool:
    """A live (not zombie) process with this pid."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def procs_phase(cli_run):
    """The kwok entry point with --lane-procs true: one lane process per
    lane, each with its own single-lane engine and tick kernel on the
    card (see the module docstring, phase 7)."""
    import numpy as np
    import torch

    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.engine.rowpool import shard_of

    shm_free = shm_free_bytes()
    print(f"procs: /dev/shm free {shm_free} B", flush=True)
    from kwok_tpu_torch.telemetry.trace import check_chrome_trace

    n_lanes = resolve_drain_shards(0, 0)
    ckpt_dir = tempfile.mkdtemp(prefix="kwok-procs-ckpt-")
    trace_path = os.path.join(ckpt_dir, "trace.json")
    run = start_cli(["--lane-procs", "true", "--checkpoint-dir", ckpt_dir,
                     "--checkpoint-interval", "1", "--trace-dump", trace_path])
    arenas: list = []
    try:
        eng = run["engine"]
        pl = eng._proc
        if pl is None or pl.n != n_lanes or eng._lanes is not None:
            raise AssertionError(f"--lane-procs true did not run {n_lanes} lane processes")
        if eng._stream is not None or eng.nodes.state is not None:
            raise AssertionError("the parent engine holds a stream or device rows")
        arenas = [pl.bank.name] + [a.name for ln in pl.lanes for a in (ln.ring, ln.slot, ln.mbank)]
        pids = [s["pid"] for s in pl.status()]
        load = drive_pods(run, pids)
        client = load["client"]
        # every lane process on the card, launching; every lane checkpointed
        t_wait = time.monotonic() + 10.0
        while True:
            status = pl.status()
            if all(s["device"] == DEVICE and s["launches"] > 0 for s in status):
                break
            if time.monotonic() > t_wait:
                raise AssertionError(f"lane processes not all on {DEVICE} and launching: {status}")
            time.sleep(0.1)
        want = {f"lane{i}.ckpt.json" for i in range(n_lanes)}
        if not want <= set(os.listdir(ckpt_dir)):
            raise AssertionError(f"checkpoints: {sorted(os.listdir(ckpt_dir))}")
        m = scrape(run)
        if m["kwok_status_patches_total"] < CLI_NODES + CLI_PODS:
            raise AssertionError(f"kwok_status_patches_total {m['kwok_status_patches_total']}")
        lane_s = lane_seconds(m, n_lanes)
        before_kill = pl.status()
        # respawn: SIGKILL lane 0; back (its engine ready again) within the bound
        lane0 = pl.lanes[0]
        old_pid = lane0.proc.pid
        t_kill = time.monotonic()
        if not lane0.sigkill():
            raise AssertionError("could not SIGKILL lane 0")
        while True:
            st0 = pl.status()[0]
            if st0["restarts"] >= 1 and st0["alive"] and st0["ready"] and st0["pid"] != old_pid:
                break
            if time.monotonic() - t_kill > PROCS_RESPAWN_S:
                raise AssertionError(f"lane 0 not back within {PROCS_RESPAWN_S} s: {st0}")
            time.sleep(0.05)
        respawn_s = time.monotonic() - t_kill
        restarts0 = scrape(run).get('kwok_lane_proc_restarts_total{shard="0"}')
        if restarts0 != 1 or eng.degraded:
            raise AssertionError(f"restarts {restarts0}, degraded {eng._degradation.reasons}")
        proc, _span = spawn_creator(run["url"], "pods", PROCS_MORE_PODS, first=CLI_PODS)
        join_creator(proc, run["deadline"])
        more = [f"pod-{CLI_PODS + i}" for i in range(PROCS_MORE_PODS)]
        on_lane0 = sum(shard_of(("default", n), n_lanes) == 0 for n in more)
        if on_lane0 == 0:
            raise AssertionError("none of the later pods belongs to lane 0")
        while True:
            pods = client.list("pods")
            by_name = {p["metadata"]["name"]: p for p in pods}
            n_more = sum(running(by_name.get(n, {})) for n in more)
            if n_more == PROCS_MORE_PODS:
                break
            if time.monotonic() > run["deadline"]:
                raise AssertionError(f"{n_more} of {PROCS_MORE_PODS} later pods Running; "
                                     f"lanes {pl.status()}")
            time.sleep(POLL_S)
        more_s = time.monotonic() - t_kill
        status = pl.status()
        if status[0]["pods"] < before_kill[0]["pods"] + on_lane0 or eng.degraded:
            raise AssertionError(f"lane 0 after the respawn: {status[0]} (before {before_kill[0]})")
        code, _ = http_get(run["base"] + "/readyz")
        if code != 200:
            raise AssertionError(f"/readyz {code} after the respawn")
        m = scrape(run)
        pids_all = pids + [status[0]["pid"]]
    finally:
        stop_cli(run)
    final = pl.status()
    if any(s["alive"] for s in final) or any(_alive(pid) for pid in pids_all):
        raise AssertionError(f"lane processes left after stop: {final}")
    left = [a for a in arenas if os.path.exists(f"/dev/shm/{a}")]
    if left:
        raise AssertionError(f"shared-memory arenas left after stop: {left}")
    # the parent's span trace and one per lane process, each its own file
    lane_spans = []
    for path in [trace_path] + [f"{trace_path}.lane{i}" for i in range(n_lanes)]:
        if not os.path.exists(path):
            raise AssertionError(f"no trace dump {path} after stop")
        with open(path) as f:
            doc = json.load(f)
        check_chrome_trace(doc)
        lane_spans.append(doc["otherData"]["spans_recorded"])
    launches = sum(s["launches"] for s in final)
    if launches <= 0:
        raise AssertionError("the lane processes ran without launching the tick kernel")
    check_final_pods(pods, m)
    native = native_edge(m, summed(m, "kwok_watch_events_total"), lanes=n_lanes, procs=True)
    if native["parses"] <= 0:
        raise AssertionError("the lane processes parsed no routed window natively")
    # the kernel at a lane's starting capacity (ProcLaneSet.capacity) and
    # at the capacities lane 0 grew to, with the Stage rule tables
    start_caps, start_ms, _, _ = engine_shape_check(
        torch, eng, rearm=True, states=lane_states(np, eng, [pl.capacity] * 2))
    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(
        torch, eng, rearm=True, states=lane_states(np, eng, status[0]["capacities"]))
    log(f"kernel at a lane's starting capacities {start_caps}: checked, {start_ms:.4f} ms; "
        f"at lane 0's capacities {caps} with the Stage rules: checked; kernel "
        f"{shape_ms:.4f} ms, plain {shape_plain_ms:.3f} ms, wire D2H {shape_wire_ms:.4f} ms")
    return {
        "lanes": n_lanes, "shm_free_bytes": shm_free, "arena_bytes": pl.arena_bytes(),
        "lane_capacity_start": pl.capacity,
        "lane_capacities_end": [s["capacities"] for s in status],
        "lane_pods": [s["pods"] for s in before_kill],
        "lane_launches": [s["launches"] for s in final],
        "lane_drain_s": lane_s["drain"], "lane_emit_s": lane_s["emit"],
        **load["report"], "native": native,
        "kwok_cpu_s_per_1000_pods": per_1000(load["report"]["window_kwok_process_cpu_s"],
                                             CLI_PODS),
        "lanes_cpu_s_per_1000_pods": per_1000(sum(load["cpu_s"][pid] for pid in pids),
                                              CLI_PODS),
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "cli_phase_status_patches_per_s": cli_run["status_patches_per_s"],
        "readyz_503_polls": run["readyz"].count(503), "main_to_ready_s": run["main_to_ready_s"],
        "status_patches": m["kwok_status_patches_total"],
        "respawn_s": respawn_s, "stop_s": run["stop_s"], "more_pods": PROCS_MORE_PODS,
        "watch_relists": m.get("kwok_watch_relists_total", 0.0),
        "more_pods_on_lane0": on_lane0, "more_pods_running_s": more_s,
        "ticks": m["kwok_ticks_total"], "kernel_launches": launches,
        "transitions": summed(m, "kwok_transitions_total"),
        "watch_events": summed(m, "kwok_watch_events_total"),
        "lane_tick_thread_s": m["kwok_tick_seconds_sum"],
        # CPU seconds of each lane process over the create->Running window
        "window_lane_cpu_s": [load["cpu_s"][pid] for pid in pids],
        "start_capacities": start_caps, "kernel_ms_at_start_capacities": start_ms,
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
        "wire_d2h_ms_at_capacities": shape_wire_ms,
        "bound_ms_at_capacities": byte_bound_ms(caps),
        "trace_spans_parent_and_lanes": lane_spans,
    }


class sized:
    """CLI_NODES, CLI_PODS and CLI_DELETES set for one block (the helpers
    of the CLI phases read them at call time), restored after it."""

    def __init__(self, **sizes) -> None:
        self.sizes = sizes

    def __enter__(self):
        g = globals()
        self.saved = {k: g[k] for k in self.sizes}
        g.update(self.sizes)

    def __exit__(self, *exc) -> None:
        globals().update(self.saved)


def settle_kills(plane, wd, names, before: dict, deadline: float) -> dict:
    """Wait (until ``deadline``) for every kill the plane logged to be
    matched by a restart of that thread in the watchdog's restart_log and
    in kwok_worker_restarts_total (``before`` holds its values at the
    phase's start). A pill armed on a thread blocked in a C call lands
    when the call returns, hence the wait. Returns kills and restarts per
    name; raises when they still differ."""
    from kwok_tpu_torch.telemetry.errors import worker_restarts_total

    while True:
        kills = {n: 0 for n in names}
        for k in plane.kill_log():
            kills[k["thread"]] = kills.get(k["thread"], 0) + 1
        logged = {n: 0 for n in kills}
        for r in wd.restart_log():
            if not r.get("proc") and r["thread"] in logged:
                logged[r["thread"]] += 1
        counted = {n: worker_restarts_total(n) - before.get(n, 0.0) for n in kills}
        if kills == logged and all(counted[n] == kills[n] for n in kills):
            return {"kills": kills, "restarts": logged}
        if time.monotonic() > deadline:
            raise AssertionError(f"kills {kills} against restart_log {logged} and "
                                 f"kwok_worker_restarts_total {counted}: a pill was "
                                 f"not absorbed by the watchdog")
        time.sleep(0.1)


def chaos_lanes(cli_run):
    """Phase 10a: the CLI phase under CHAOS_SPEC (see the module
    docstring)."""
    import torch

    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.telemetry.errors import worker_restarts_total

    n_lanes = resolve_drain_shards(0, 0)
    before = {n: worker_restarts_total(n) for n in CHAOS_NAMES}
    cuda_tick.tick_steps.launches = 0
    run = start_cli(["--faults", CHAOS_SPEC], mock_env={"KWOK_TPU_BOOKMARK_INTERVAL": "1"})
    info: dict = {}
    try:
        eng = run["engine"]
        plane = eng._faults
        if plane is None or eng._lanes is None or eng._lanes.n != n_lanes:
            raise AssertionError(f"--faults did not build a plane on {n_lanes} lanes")
        if any(ln.engine._faults is not plane for ln in eng._lanes.lanes):
            raise AssertionError("a lane engine does not share the parent's plane")

        def cover():
            # the flood is over: stay up until every name was killed once,
            # then close the kill window (the storm, then the healing)
            t0 = time.monotonic()
            while {k["thread"] for k in plane.kill_log()} < set(CHAOS_NAMES):
                if time.monotonic() - t0 > CHAOS_COVER_S:
                    break
                time.sleep(0.1)
            info["cover_s"] = time.monotonic() - t0
            plane.spec.kill_glob = "chaos-window-closed"

        load = drive_pods(run, after_running=cover)
        pods = load["client"].list("pods")
        settled = settle_kills(plane, eng._watchdog, CHAOS_NAMES, before,
                               time.monotonic() + CHAOS_SETTLE_S)
        counts = plane.counts()
        killed = {k["thread"] for k in plane.kill_log()}
        if counts.get("worker.kill", 0) < 3 or not all(
                any(n.startswith(pre) for n in killed)
                for pre in ("kwok-lane", "kwok-emit", "kwok-watch")):
            raise AssertionError(f"worker kills {counts.get('worker.kill')}, names {sorted(killed)}")
        code, _ = http_get(run["base"] + "/readyz")
        if code != 200 or eng.degraded:
            raise AssertionError(f"/readyz {code}, degraded {eng._degradation.reasons}")
        m = scrape(run)
    finally:
        stop_cli(run)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the chaos run launched no tick kernel")
    check_final_pods(pods, m)
    native = native_edge(m, summed(m, "kwok_watch_events_total"), lanes=n_lanes)
    caps, shape_ms, shape_plain_ms, _wire_ms = engine_shape_check(torch, eng, rearm=True)
    log(f"chaos (lanes): kernel at the engine's capacities {caps}: checked, {shape_ms:.4f} ms")
    return {
        "lanes": n_lanes, "spec": CHAOS_SPEC, **load["report"],
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "pods_per_s_vs_cli": (load["report"]["create_to_running_pods_per_s"]
                              / cli_run["create_to_running_pods_per_s"]),
        "faults": counts, **settled, "kill_cover_s": info.get("cover_s"),
        "restart_latency_s": sorted(r["restart_latency_s"]
                                    for r in eng._watchdog.restart_log() if not r.get("proc")),
        "watch_relists": m["kwok_watch_relists_total"], "native": native,
        "kwok_cpu_s_per_1000_pods": per_1000(load["report"]["window_kwok_process_cpu_s"],
                                             load["report"]["pods"]),
        "kernel_launches": launches, "capacities": caps,
        "kernel_ms_at_capacities": shape_ms, "plain_ms_at_capacities": shape_plain_ms,
    }


def chaos_fed():
    """Phase 10b: a 2-member federation whose members' pods watch threads
    are killed every 2 s (see the module docstring)."""
    import torch

    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.ops import cuda_tick

    n = CHAOS_FED_MEMBERS
    cuda_tick.tick_steps.launches = 0
    run = start_cli(["--faults", CHAOS_FED_SPEC], members=n, nodes=FED_NODES,
                    mock_env={"KWOK_TPU_BOOKMARK_INTERVAL": "1"})
    try:
        fed = run["engine"]
        if not hasattr(fed, "groups") or len(fed.engines) != n:
            raise AssertionError(f"--master with {n} URLs did not run a federation of {n}")
        from kwok_tpu_torch.parallel.mesh import local_devices

        if fed.mesh.devices != tuple(local_devices(DEVICE)):
            raise AssertionError(f"the federation's mesh {fed.mesh} is not every visible card")
        planes = [e._faults for e in fed.engines]
        if any(p is None for p in planes):
            raise AssertionError("a member built no fault plane")
        creators = [spawn_creator(u, "pods", FED_PODS, nodes=FED_NODES, conns=FED_CONNS)
                    for u in run["urls"]]
        for proc, _span in creators:
            join_creator(proc, run["deadline"])
        clients = [HttpKubeClient(u) for u in run["urls"]]
        while True:
            m = scrape(run)
            if summed(m, "kwok_status_patches_total") >= n * (FED_NODES + FED_PODS):
                t_patched = time.time()
                if all(sum(map(running, c.list("pods"))) == FED_PODS for c in clients):
                    break
            if time.monotonic() > run["deadline"]:
                raise AssertionError(f"timeout: {summed(m, 'kwok_status_patches_total')} patches")
            time.sleep(POLL_S)
        # the kill window stays open until a member has restarted (a fast
        # flood can end before the first 2 s period), at most CHAOS_COVER_S
        deadline = time.monotonic() + CHAOS_COVER_S
        while (summed(scrape(run), "kwok_fed_member_restarts_total") < 1
               and time.monotonic() < deadline):
            time.sleep(0.1)
        for p in planes:
            p.spec.kill_glob = "chaos-window-closed"
        kills = sum(len(p.kill_log()) for p in planes)
        m = scrape(run)
        restarts = summed(m, "kwok_fed_member_restarts_total")
        if restarts <= 0 or kills <= 0:
            raise AssertionError(f"member restarts {restarts} after {kills} kills")
        code, _ = http_get(run["base"] + "/readyz")
        if code != 200 or fed.degraded:
            raise AssertionError(f"/readyz {code}, degraded {fed._degradation.reasons}")
        for c in clients:
            c.close()
    finally:
        stop_cli(run)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the chaos federation launched no tick kernel")
    groups = []
    for g in fed.groups:
        caps, ms, _plain_ms, _wire_ms = engine_shape_check(
            torch, GroupView(g), rearm=True, states=(g.stacked["nodes"], g.stacked["pods"]),
            fire_after=1.5)
        groups.append({"capacities": caps, "kernel_ms_at_capacities": ms})
    log(f"chaos (federation): kernel at each group's capacities: checked {groups}")
    window = t_patched - min(span[0] for _p, span in creators)
    return {
        "members": n, "spec": CHAOS_FED_SPEC, "pods": n * FED_PODS,
        "create_to_running_pods_per_s": n * FED_PODS / window,
        "member_restarts": {k: v for k, v in m.items()
                            if k.startswith("kwok_fed_member_restarts_total")},
        "kills": kills, "kernel_launches": launches, "groups": groups,
        "watch_relists": summed(m, "kwok_watch_relists_total"),
    }


def chaos_procs():
    """Phase 10c: 2 lane processes while the parent drops and garbles
    ring descriptors (see the module docstring)."""
    import numpy as np
    import torch

    with sized(CLI_NODES=CHAOS_PROCS_NODES, CLI_PODS=CHAOS_PROCS_PODS):
        run = start_cli(["--lane-procs", "true", "--drain-shards", "2",
                         "--faults", CHAOS_PROCS_SPEC])
        try:
            eng = run["engine"]
            pl = eng._proc
            if pl is None or pl.n != 2 or eng._faults is None:
                raise AssertionError("--lane-procs true --drain-shards 2 --faults did not run "
                                     "2 lane processes under a plane")
            load = drive_pods(run, [s["pid"] for s in pl.status()])
            pods = load["client"].list("pods")
            counts = eng._faults.counts()
            deadline = time.monotonic() + CHAOS_SETTLE_S
            while True:  # the lanes publish their counters once a second
                m = scrape(run)
                rejects = summed(m, "kwok_shm_desc_rejects_total")
                if rejects > 0 or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            if rejects <= 0 or counts.get("shm.desc_drop", 0) <= 0:
                raise AssertionError(f"descriptor rejects {rejects}, faults {counts}")
            if eng.degraded:
                raise AssertionError(f"degraded {eng._degradation.reasons}")
            status = pl.status()
        finally:
            stop_cli(run)
        launches = sum(s["launches"] for s in pl.status())
        if launches <= 0:
            raise AssertionError("the chaos lane processes launched no tick kernel")
        check_final_pods(pods, m)
        caps, ms, _plain_ms, _wire_ms = engine_shape_check(
            torch, eng, rearm=True, states=lane_states(np, eng, status[0]["capacities"]))
    log(f"chaos (process lanes): kernel at lane 0's capacities {caps}: checked, {ms:.4f} ms")
    return {
        "lanes": 2, "spec": CHAOS_PROCS_SPEC, **load["report"], "faults": counts,
        "desc_rejects": {k: v for k, v in m.items()
                         if k.startswith("kwok_shm_desc_rejects_total")},
        "watch_relists": m.get("kwok_watch_relists_total", 0.0),
        "kernel_launches": launches, "capacities": caps, "kernel_ms_at_capacities": ms,
    }


def chaos_phase(cli_run) -> dict:
    """Phase 10: the three parts in turn; any part's failure fails it."""
    out = {"lanes": chaos_lanes(cli_run)}
    out["federation"] = chaos_fed()
    out["procs"] = chaos_procs()
    out["kernel_launches"] = sum(out[k]["kernel_launches"] for k in ("lanes", "federation", "procs"))
    return out


def check_mock_watchers(url: str, at_least: int = 2) -> dict:
    """GET /debug/watchers of a mock under check_watchers (both mocks
    serve the census); the engine's watches must be among them."""
    from kwok_tpu_torch.telemetry.timeline import check_watchers

    code, text = http_get(url + "/debug/watchers")
    if code != 200:
        raise AssertionError(f"{url}/debug/watchers answered {code}")
    doc = json.loads(text)
    check_watchers(doc)
    if doc["count"] < at_least:
        raise AssertionError(f"{url}/debug/watchers: {doc['count']} watches, want {at_least}")
    return {"server": doc["server"], "count": doc["count"], "backlog_cap": doc["backlog_cap"],
            "max_lag": max((w["lag_events"] for w in doc["watchers"]), default=0)}


class PassTimes:
    """The auditor's kwok_audit_pass_seconds histogram, with each pass's
    seconds kept (the histogram keeps buckets only)."""

    def __init__(self, hist) -> None:
        self.hist = hist
        self.values: list = []

    def observe(self, v: float) -> None:
        self.values.append(v)
        self.hist.observe(v)


def drift_pod(i: int, nodes: int, prefix: str = "dpod") -> dict:
    return {"metadata": {"name": f"{prefix}-{i:05d}", "namespace": "default"},
            "spec": {"nodeName": f"node-{i % nodes}",
                     "containers": [{"name": "c", "image": "busybox"}]},
            "status": {"phase": "Pending"}}


def quiescent(relists, hold: float = 1.5, timeout: float = 20.0) -> bool:
    """Wait until ``relists()`` has not moved for ``hold`` seconds: a
    storm-era cut or resync landing while divergence is seeded would
    repair it through a re-list before the auditor sees it."""
    deadline = time.monotonic() + timeout
    last, since = None, time.monotonic()
    while time.monotonic() < deadline:
        cur = relists()
        if cur != last:
            last, since = cur, time.monotonic()
        elif time.monotonic() - since >= hold:
            return True
        time.sleep(0.1)
    return False


def seed_divergence(rig, seeds: dict, nodes: int, prefix: str, eng=None) -> dict:
    """Seed one divergence per entry of ``seeds`` (pod index -> reason)
    behind the engine's back through ``rig`` (drift_rig's RigClient or
    LocalRig): a phase set back to Pending, a silent delete, the row
    revision set ahead of the server's (the double-apply; in ``eng``'s
    owning lane, under its stage_lock), or a bound pod stored with a
    revision and no event beside the pod (the missed event). Returns
    {name: reason}."""
    import drift_rig

    out = {}
    for i, reason in sorted(seeds.items()):
        name = f"{prefix}-{i:05d}"
        if reason == "stale-row":
            ok = rig.silent(op="phase", kind="pods", namespace="default", name=name,
                            phase="Pending")["ok"]
        elif reason == "ghost-row":
            ok = rig.silent(op="delete", kind="pods", namespace="default", name=name)["ok"]
        elif reason == "double-apply":
            srv_rv = int(rig.get("pods", "default", name)["metadata"]["resourceVersion"])
            ok = drift_rig.set_row_rv(eng, "pods", ("default", name), srv_rv + 1_000_000)
        else:
            pod = drift_pod(i, nodes, prefix)
            name = pod["metadata"]["name"] = f"{name}-m"
            ok = rig.silent(op="create", kind="pods", object=pod)["ok"]
        if not ok:
            raise AssertionError(f"drift seed {reason} on {name}: no such object or row")
        out[name] = reason
    return out


def progress_logger(sample, stop: threading.Event, every: float = 5.0) -> None:
    """Log ``sample()`` every ``every`` seconds until ``stop`` is set: the
    drift phase's record of where it stood when a check fails."""
    t0 = time.monotonic()

    def loop() -> None:
        while not stop.wait(every):
            try:
                log(f"drift +{time.monotonic() - t0:.0f} s: {sample()}")
            except Exception as e:  # a sample must never end the phase
                log(f"drift +{time.monotonic() - t0:.0f} s: sample failed: {e!r}")

    threading.Thread(target=loop, name="drift-progress", daemon=True).start()


def thread_cpu(pid: int) -> dict:
    """Each thread of ``pid``: its CPU ticks, its state letter and its
    wchan, from /proc/<pid>/task/*/{stat,wchan}. A host without wchan
    files, or one that hides them, leaves the wchan empty: the stat line
    alone names the hot threads."""
    out = {}
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/{pid}/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue  # the thread ended
        wchan = ""
        try:
            with open(f"/proc/{pid}/task/{tid}/wchan") as f:
                wchan = f.read().strip()
        except OSError:
            pass
        out[int(tid)] = (int(fields[11]) + int(fields[12]), fields[0], wchan)
    return out


def mock_stall_dump(url: str, pid: int) -> dict:
    """What a stalled native mock is doing: its threads' CPU over 1 s
    (the hottest 8), and GET /rig/threads (each connection thread's
    request and age, and the store locks held at that moment)."""
    a = thread_cpu(pid)
    time.sleep(1.0)
    b = thread_cpu(pid)
    hot = sorted(((b[t][0] - a.get(t, (b[t][0],))[0], t, b[t][1], b[t][2]) for t in b),
                 reverse=True)[:8]
    code, text = http_get(url + "/rig/threads")
    census = json.loads(text) if code == 200 else {"error": code}
    busy = sorted((t for t in census.get("threads", []) if t.get("busy")),
                  key=lambda t: -t["age_s"])
    return {"threads": len(b), "hot": hot, "held": census.get("held"),
            "busy": busy[:16], "connections": len(census.get("threads", []))}


def drift_lanes(cli_run):
    """Phase 11a: the storm, then seeded divergence (see the module
    docstring)."""
    import statistics

    import torch

    import drift_rig
    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.engine import ClusterEngine, EngineConfig
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.resilience.antientropy import REASONS
    from kwok_tpu_torch.telemetry.errors import wire_rejects_total, worker_crash_ledger

    n_lanes = resolve_drain_shards(0, 0)
    info: dict = {"lanes": n_lanes, "spec": DRIFT_SPEC, "mock": "native --rig-routes"}
    mock = subprocess.Popen(mock_command("native") + ["--rig-routes"],
                            stdout=subprocess.PIPE, text=True)
    eng = None
    stop_progress = threading.Event()
    try:
        url = mock_url(mock)
        check_mock(url, "native")
        rig = drift_rig.RigClient(url)
        proc, _span = spawn_creator(url, "nodes", DRIFT_NODES)
        join_creator(proc, time.monotonic() + DRIFT_DEADLINE_S)
        eng = ClusterEngine(HttpKubeClient(url), EngineConfig(
            manage_all_nodes=True, cidr="10.0.0.1/16", drain_shards=n_lanes,
            faults=DRIFT_SPEC, audit_interval=DRIFT_AUDIT_S, device=DEVICE))
        plane = eng._faults

        def injected() -> dict:
            m = parse_metrics(eng.process_metrics_text())
            return {k.split('kind="', 1)[1].split('"', 1)[0]: v for k, v in m.items()
                    if k.startswith("kwok_faults_injected_total{")}

        def pod_views(names) -> dict:
            """For a failure's message: each pod's server status, its row's
            (uid, rv, phase, node), its node, whether that node is managed
            and the node's row."""
            views = {}
            for n in names:
                obj = rig.get("pods", "default", n) or {}
                node = (obj.get("spec") or {}).get("nodeName")
                views[n] = (obj.get("status"), aud._row_view("pods", ("default", n)),
                            node, node in eng.node_has, aud._row_view("nodes", node))
            return views

        inj0 = injected()
        rejects0 = wire_rejects_total()
        crashes0 = {k: len(v) for k, v in worker_crash_ledger().items()}
        cuda_tick.tick_steps.launches = 0
        eng.start()
        aud = eng._auditor
        if aud is None or plane is None or eng._lanes is None or eng._lanes.n != n_lanes:
            raise AssertionError(f"no auditor, plane or {n_lanes} lanes: {aud}, {plane}")
        aud._pass_hist = passes = PassTimes(aud._pass_hist)
        lanes = eng._lanes.lanes
        # the objects of every re-list the router hands the lanes, and the
        # largest summed lane queue depth (items: a re-list's share of a
        # lane is one item), polled
        listed: list = []
        route = eng._lanes.route

        def counted_route(kind, type_, obj):
            if type_ == "LIST":
                listed.append(len(obj[1]))
            route(kind, type_, obj)

        eng._lanes.route = counted_route
        depth_peak = [0]

        def depth_poll():
            while not stop_progress.wait(0.02):
                depth_peak[0] = max(depth_peak[0], sum(ln.q.qsize() for ln in lanes))

        threading.Thread(target=depth_poll, name="drift-depth", daemon=True).start()

        stall = {"key": None, "since": time.monotonic(), "passes": -1,
                 "passes_since": time.monotonic(), "dumps": []}

        def sample() -> str:
            st = rig.state()
            now = time.monotonic()
            key = (st["running"], st["rv"])
            if key != stall["key"]:
                stall["key"], stall["since"] = key, now
            passes = aud.snapshot()["passes"]
            if passes != stall["passes"]:
                stall["passes"], stall["passes_since"] = passes, now
            # the pods and the revision stand still with pods left, or
            # the auditor's passes (one a second) stopped
            if len(stall["dumps"]) < 2 and (
                    (st["running"] < st["pods"] and now - stall["since"] > STALL_DUMP_S)
                    or now - stall["passes_since"] > STALL_DUMP_S):
                dump = mock_stall_dump(url, mock.pid)
                stall["dumps"].append(dump)
                log(f"drift: the mock stands still: {json.dumps(dump)}")
            q = [ln.q.qsize() for ln in lanes]
            em = [ln.emit_q.qsize() for ln in lanes]
            m = eng.metrics
            return (f"{st['running']} of {st['pods']} pods Running; ingest queue "
                    f"{eng._q.qsize()}, lane queues {sum(q)} (largest {max(q)}), emit "
                    f"{sum(em)}; re-lists {m.get('watch_relists_total', 0):.0f}, rv rewinds "
                    f"{m.get('rv_rewinds_total', 0):.0f}; audit passes "
                    f"{aud.snapshot()['passes']}, detected {aud.detected_total()}, repaired "
                    f"{aud.repaired_total}; degraded {sorted(eng._degradation.reasons)}; "
                    f"slow terminations {st['terminations'].get('slow', 0)}; mock CPU "
                    f"{cpu_seconds(mock.pid):.1f} s")

        progress_logger(sample, stop_progress)
        deadline = time.monotonic() + DRIFT_DEADLINE_S
        while not eng.ready:
            if time.monotonic() > deadline:
                raise AssertionError("the drift engine never became ready")
            time.sleep(0.05)
        info["watchers_at_ready"] = check_mock_watchers(url, 0)
        # the storm: two halves about 1 s apart from the CLI phase's
        # creator (a spawned process over CLI_CONNS keep-alive
        # connections), so the wire tier corrupts live traffic
        t_first = time.monotonic()
        cpu0 = (cpu_seconds(mock.pid), cpu_seconds(os.getpid()))
        half = DRIFT_PODS // 2
        for lo, hi, gap in ((0, half, 1.0), (half, DRIFT_PODS, 0.0)):
            proc, _span = spawn_creator(url, "pods", hi - lo, first=lo,
                                        nodes=DRIFT_NODES, pod_name="dpod-{:05d}")
            join_creator(proc, deadline)
            time.sleep(gap)
        t_created = time.monotonic()
        time.sleep(DRIFT_STORM_TAIL_S)
        # close the storm as an outage ends: rates cleared, the watch
        # cache compacted, every stream cut (each re-lists); then the
        # window widens so the auditor's continue tokens outlive a cycle
        plane.spec.rates.clear()
        info["faults"] = plane.counts()
        t_heal = time.monotonic()
        rig.compact()
        rig.stop_watches()
        rig.window(DRIFT_RV_WINDOW)
        log(f"drift: storm closed {t_heal - t_first:.1f} s after the first create")
        while (st := rig.state())["running"] < DRIFT_PODS:
            if time.monotonic() > deadline:
                snap = aud.snapshot()
                raise AssertionError(
                    f"drift storm: {st['running']} of {DRIFT_PODS} Running, first not: "
                    f"{st['not_running']}; server status, (uid, rv, phase, node) of the "
                    f"row, the node, managed, its row: {pod_views(st['not_running'][:5])}; "
                    f"audit passes {snap['passes']}, cursor {snap['cursor']}, re-lists "
                    f"{eng.metrics['watch_relists_total']}, watch terminations "
                    f"{st['terminations']}")
            time.sleep(0.5)
        t_running = time.monotonic()
        cpu1 = (cpu_seconds(mock.pid), cpu_seconds(os.getpid()))
        log(f"drift: every pod Running {t_running - t_heal:.1f} s after the storm closed")
        inj = {k: v - inj0.get(k, 0.0) for k, v in injected().items()}
        missing = [k for k in ("wire.garble", "wire.dup", "wire.stale") if inj.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"kwok_faults_injected_total did not move for {missing}: {inj}")
        rejects = wire_rejects_total() - rejects0
        if rejects <= 0:
            raise AssertionError("kwok_wire_rejects_total did not rise in the storm")
        # every lane's queues empty at one moment: the node heartbeats
        # keep events flowing, so lanes that keep up are empty between
        # them, and a backlog that does not drain fails here
        t_q = time.monotonic() + DRIFT_DRAIN_S
        while True:
            sizes = [(ln.q.qsize(), ln.emit_q.qsize()) for ln in lanes]
            if not any(a or b for a, b in sizes):
                break
            if time.monotonic() > t_q:
                raise AssertionError(f"lane queues did not drain in {DRIFT_DRAIN_S} s: {sizes}")
            time.sleep(0.02)
        info["lanes_drained_s"] = time.monotonic() - t_running
        crashes = {k: len(v) - crashes0.get(k, 0) for k, v in worker_crash_ledger().items()}
        if any(crashes.values()):
            raise AssertionError(f"worker crashes outside supervision: {crashes}")
        # a drift streak the storm left clears once two scan cycles have
        # re-covered its window clean (the auditor's own rule)
        t_deg = time.monotonic() + DRIFT_DEGRADED_WAIT_S
        while eng.degraded:
            if time.monotonic() > t_deg:
                views = {}
                for ent, rec in list(aud._streaks.items())[:8]:
                    kind, key = ent[0], ent[1]
                    ns, name = key if kind == "pods" else (None, key)
                    views[repr(ent)] = (rec, aud._row_view(kind, key),
                                        rig.get(kind, ns, name) is not None)
                raise AssertionError(
                    f"degraded after the storm: {eng._degradation.reasons}; streaks "
                    f"(count and cycle, the row, on the server): {views}")
            time.sleep(0.2)
        info["degraded_after_storm_s"] = time.monotonic() - t_running
        storm_detected = {r: aud.detected_total(reason=r) for r in REASONS}
        relists_storm = eng.metrics["watch_relists_total"]
        if not quiescent(lambda: eng.metrics["watch_relists_total"]):
            raise AssertionError("the watch streams kept re-listing after the storm")
        # the pods scan pages one snapshot per cycle (its first page's
        # revision): a seed on a pod written after that snapshot shows
        # only in the next cycle, past the one-cycle bound. The bounds
        # are for a quiet store, so the seeds go in once the scan has
        # begun a cycle after every pod was Running
        t_wait = time.monotonic()
        cycles0 = aud._cycles["pods"]
        while aud._cycles["pods"] == cycles0:
            if time.monotonic() - t_wait > 2 * DRIFT_REPAIR_S:
                raise AssertionError(f"the pods scan did not finish a cycle in "
                                     f"{2 * DRIFT_REPAIR_S} s; the mock: "
                                     f"{json.dumps(mock_stall_dump(url, mock.pid))}")
            time.sleep(0.05)
        info["cycle_wait_s"] = time.monotonic() - t_wait
        # seeded divergence, faults off
        seeded = seed_divergence(rig, DRIFT_SEEDS, DRIFT_NODES, "dpod", eng)
        t_seed = time.monotonic()
        passes0 = aud.snapshot()["passes"]
        log(f"drift: {len(seeded)} divergences seeded "
            f"{t_seed - t_running:.1f} s after every pod was Running")
        bound = {r: DRIFT_GHOST_REPAIR_S if r == "ghost-row" else DRIFT_REPAIR_S
                 for r in REASONS}

        def repaired(name: str, reason: str) -> bool:
            row = drift_rig.row_rv(eng, "pods", ("default", name))
            if reason == "ghost-row":
                return row is None
            obj = rig.get("pods", "default", name)
            if obj is None or row is None:
                return False
            if reason == "double-apply":
                return row == int(obj["metadata"]["resourceVersion"])
            return (obj.get("status") or {}).get("phase") == "Running"

        repaired_at: dict = {}
        repaired_pass: dict = {}
        while len(repaired_at) < len(seeded):
            for name, reason in seeded.items():
                if name not in repaired_at and repaired(name, reason):
                    repaired_at[name] = time.monotonic() - t_seed
                    repaired_pass[name] = aud.snapshot()["passes"] - passes0
            if time.monotonic() - t_seed > max(bound.values()):
                break
            time.sleep(0.25)
        late = {n: (r, repaired_at.get(n), repaired_pass.get(n)) for n, r in seeded.items()
                if repaired_at.get(n) is None or repaired_at[n] > bound[r]}
        if late:
            raise AssertionError(
                f"seeded divergence not repaired in time (bounds {DRIFT_REPAIR_S} s, ghosts "
                f"{DRIFT_GHOST_REPAIR_S} s): {late}; {pod_views(list(late))}")
        log(f"drift: seeded divergence repaired in {max(repaired_at.values()):.1f} s")
        detected = {r: aud.detected_total(reason=r) - storm_detected[r] for r in REASONS}
        short = {r: n for r, n in detected.items() if n < 4}
        if short:
            raise AssertionError(f"kwok_drift_detected_total rose by less than 4: {short}")
        time.sleep(3 * DRIFT_AUDIT_S)
        if eng.degraded:
            raise AssertionError(f"degraded 3 intervals after the repairs: "
                                 f"{eng._degradation.reasons}")
        info["watchers_at_end"] = check_mock_watchers(url, 0)
        # the storm restores no store: a second rewind of one row is the
        # re-list loop (a row corrected by a re-list still queued)
        seen_rewinds: dict = {}
        for ent in eng.rv_rewind_log:
            seen_rewinds[ent] = seen_rewinds.get(ent, 0) + 1
        again = {repr(k): n for k, n in seen_rewinds.items() if n > 1}
        if again:
            raise AssertionError(f"a row caused more than one rv rewind: {again}")
        snap = aud.snapshot()
        info.update({
            "nodes": DRIFT_NODES, "pods": DRIFT_PODS,
            "create_to_running_pods_per_s": DRIFT_PODS / (t_running - t_first),
            "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
            "pod_create_s": t_created - t_first, "heal_to_running_s": t_running - t_heal,
            "storm_mock_cpu_s": cpu1[0] - cpu0[0],
            "storm_engine_process_cpu_s": cpu1[1] - cpu0[1],
            "faults_injected": inj, "wire_rejects": rejects,
            "audit_passes": snap["passes"],
            "audit_pass_s_median": statistics.median(passes.values),
            "audit_pass_s_max": max(passes.values),
            "detected_in_storm": storm_detected, "detected_seeded": detected,
            "repaired_total": snap["repaired_total"],
            "repair_s": {r: sorted(t for n, t in repaired_at.items() if seeded[n] == r)
                         for r in REASONS},
            "repair_passes": {r: sorted(p for n, p in repaired_pass.items() if seeded[n] == r)
                              for r in REASONS},
            "repair_bound_s": {"ghost-row": DRIFT_GHOST_REPAIR_S, "others": DRIFT_REPAIR_S},
            "watch_relists": eng.metrics["watch_relists_total"],
            "watch_relists_after_storm": relists_storm,
            "rv_rewinds": eng.metrics.get("rv_rewinds_total", 0),
            "rv_rewind_rows": [list(map(str, k)) for k in eng.rv_rewind_log],
            "slow_terminations": rig.state()["terminations"].get("slow", 0),
            "peak_lane_queue_items": depth_peak[0],
            "relists_routed": len(listed),
            "objects_per_relist": (sum(listed) / len(listed)) if listed else 0.0,
            "stall_dumps": stall["dumps"],
        })
    finally:
        stop_progress.set()
        if eng is not None:
            eng.stop()
        mock.terminate()
        try:
            mock.wait(30)
        except subprocess.TimeoutExpired:
            mock.kill()
            mock.wait(30)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the drift phase launched no tick kernel")
    caps, ms, plain_ms, _wire_ms = engine_shape_check(torch, eng)
    log(f"drift (lanes): kernel at the engine's capacities {caps}: checked, {ms:.4f} ms")
    info.update({"kernel_launches": launches, "capacities": caps,
                 "kernel_ms_at_capacities": ms, "plain_ms_at_capacities": plain_ms})
    return info


# the process-lane arm runs kwok's entry point in a process of its own
# (cli.main, as python -m kwok_tpu_torch.kwok runs it) and prints the
# lane processes' kernel launches once main has returned
DRIFT_PROCS_MAIN = """
import json, sys
import kwok_tpu_torch.engine as engine_mod
from kwok_tpu_torch.kwok import cli
engines = []
class Recorded(engine_mod.ClusterEngine):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        engines.append(self)
engine_mod.ClusterEngine = Recorded
rc = cli.main(sys.argv[1:])
pl = engines[0]._proc if engines else None
print("drift-procs " + json.dumps({"rc": rc, "launches": sum(
    s["launches"] for s in pl.status()) if pl is not None else 0}), flush=True)
sys.exit(rc)
"""


def drift_procs():
    """Phase 11b: the auditor in 2 lane processes over HTTP (see the
    module docstring)."""
    import drift_rig
    from kwok_tpu_torch.edge.mockserver import FakeKube, HttpFakeApiserver

    here = os.path.dirname(os.path.abspath(__file__))
    store = FakeKube()
    store.rv_window = DRIFT_RV_WINDOW
    srv = HttpFakeApiserver(store).start()
    proc = None
    info: dict = {"lanes": 2, "nodes": DRIFT_PROCS_NODES, "pods": DRIFT_PROCS_PODS}
    try:
        for i in range(DRIFT_PROCS_NODES):
            store.create("nodes", {"metadata": {"name": f"node-{i}"}})
        workdir = tempfile.mkdtemp(prefix="kwok-drift-")
        stage_path = os.path.join(workdir, "stages.json")
        with open(stage_path, "w") as f:
            f.write("---\n".join(json.dumps(d) + "\n" for d in stage_documents()))
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        proc = subprocess.Popen(
            [sys.executable, "-c", DRIFT_PROCS_MAIN, "--master", srv.url,
             "--kubeconfig", os.path.join(workdir, "no-kubeconfig"),
             "--manage-all-nodes", "true", "--server-address", f"127.0.0.1:{port}",
             "--cidr", "10.0.0.1/16", "--config", stage_path, "--lane-procs", "true",
             "--drain-shards", "2", "--audit-interval", str(DRIFT_AUDIT_S)],
            cwd=here, stdout=subprocess.PIPE, text=True)
        deadline = time.monotonic() + DRIFT_DEADLINE_S
        while http_get(base + "/readyz")[0] != 200:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"kwok --lane-procs never ready (exit {proc.poll()})")
            time.sleep(0.1)
        info["watchers_at_ready"] = check_mock_watchers(srv.url)
        t0 = time.monotonic()
        for i in range(DRIFT_PROCS_PODS):
            store.create("pods", drift_pod(i, DRIFT_PROCS_NODES, "ppod"))
        while store.count("pods", running) < DRIFT_PROCS_PODS:
            if time.monotonic() > deadline:
                raise AssertionError(f"{store.count('pods', running)} pods Running")
            time.sleep(POLL_S)
        info["create_to_running_pods_per_s"] = DRIFT_PROCS_PODS / (time.monotonic() - t0)

        def metrics() -> dict:
            code, text = http_get(base + "/metrics")
            if code != 200:
                raise AssertionError(f"kwok /metrics answered {code}")
            return parse_metrics(text)

        def detected(m: dict, reason: str) -> float:
            return sum(v for k, v in m.items() if k.startswith("kwok_drift_detected_total{")
                       and f'reason="{reason}"' in k)

        if not quiescent(lambda: metrics()["kwok_watch_relists_total"]):
            raise AssertionError("the watch streams kept re-listing")
        m0 = metrics()
        if m0["kwok_pods_managed"] != DRIFT_PROCS_PODS:
            raise AssertionError(f"kwok_pods_managed {m0['kwok_pods_managed']}")
        seeded = seed_divergence(drift_rig.LocalRig(store), DRIFT_PROCS_SEEDS,
                                 DRIFT_PROCS_NODES, "ppod")
        reasons = sorted(set(seeded.values()))
        t_seed = time.monotonic()
        while True:
            m = metrics()
            done = {r: detected(m, r) - detected(m0, r) for r in reasons}
            phases_ok = all(
                ((store.get("pods", "default", n) or {}).get("status") or {}).get("phase")
                == "Running" for n, r in seeded.items() if r != "ghost-row")
            # the missed pods' rows came in and the ghosts' went out
            if (all(v >= 4 for v in done.values()) and phases_ok
                    and m["kwok_pods_managed"] == DRIFT_PROCS_PODS):
                break
            if time.monotonic() - t_seed > DRIFT_PROCS_REPAIR_S:
                raise AssertionError(f"process lanes: detected {done}, phases repaired "
                                     f"{phases_ok}, kwok_pods_managed {m['kwok_pods_managed']}")
            time.sleep(0.2)
        info["repair_s"] = time.monotonic() - t_seed
        info["detected"] = done
        info["repaired_total"] = m.get("kwok_drift_repaired_total", 0.0) - m0.get(
            "kwok_drift_repaired_total", 0.0)
        info["audit_passes"] = m.get("kwok_audit_pass_seconds_count", 0.0)
        time.sleep(3 * DRIFT_AUDIT_S)
        code, _ = http_get(base + "/readyz")
        if code != 200:
            raise AssertionError(f"/readyz {code} at the end of the process-lane drift arm")
    finally:
        if proc is not None:
            proc.terminate()
            try:
                out, _ = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate(timeout=30)
        srv.stop()
    line = [ln for ln in out.splitlines() if ln.startswith("drift-procs ")]
    result = json.loads(line[-1].split(" ", 1)[1]) if line else {}
    if proc.returncode != 0 or result.get("rc") != 0:
        raise AssertionError(f"kwok --lane-procs exited {proc.returncode}: {result}")
    if result.get("launches", 0) <= 0:
        raise AssertionError("the drift lane processes launched no tick kernel")
    info["kernel_launches"] = result["launches"]
    return info


def drift_phase(cli_run) -> dict:
    """Phase 11: the auditor on threaded lanes, then in lane processes
    over HTTP; either part's failure fails it."""
    out = {"lanes": drift_lanes(cli_run), "procs": drift_procs()}
    out["kernel_launches"] = out["lanes"]["kernel_launches"] + out["procs"]["kernel_launches"]
    return out


CNI_PROVIDER = "smoke_cni:PROVIDER"  # KWOK_TPU_CNI_PROVIDER of the CNI phase
CNI_POOL = "10.0.0.0/16"  # the --cidr every CLI phase gives kwok


def cni_phase(cli_run):
    """Phase 12: the CLI phase with --enable-cni true and the provider
    that KWOK_TPU_CNI_PROVIDER names (see the module docstring)."""
    import ipaddress

    import torch

    import smoke_cni
    from kwok_tpu_torch import cni
    from kwok_tpu_torch.config.types import resolve_drain_shards
    from kwok_tpu_torch.ops import cuda_tick

    n_lanes = resolve_drain_shards(0, 0)
    prov = smoke_cni.PROVIDER
    prov.reset()
    cuda_tick.tick_steps.launches = 0
    os.environ["KWOK_TPU_CNI_PROVIDER"] = CNI_PROVIDER
    try:
        run = start_cli(["--enable-cni", "true"])
    finally:
        os.environ.pop("KWOK_TPU_CNI_PROVIDER", None)
    try:
        eng = run["engine"]
        if not eng._cni_live() or eng._lanes is None or eng._lanes.n != n_lanes:
            raise AssertionError(f"the CLI's engine runs no live CNI provider on {n_lanes} lanes")
        load = drive_pods(run)
        pods = load["client"].list("pods")
        # the Deleted events reach the engine after the deletes are gone
        # from the server: one remove each
        deleted = {("default", f"pod-{i}") for i in range(CLI_DELETES)}
        t_rm = time.monotonic() + 30.0
        while len(prov.removes) < CLI_DELETES and time.monotonic() < t_rm:
            time.sleep(0.05)
        time.sleep(1.0)
        removes = list(prov.removes)
        code, _ = http_get(run["base"] + "/readyz")
        degraded = sorted(eng._degradation.reasons)
        m = scrape(run)
    finally:
        stop_cli(run)
        cni._provider = None
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the CNI phase ran without launching the tick kernel")
    if code != 200 or degraded:
        raise AssertionError(f"/readyz {code}, degraded {degraded}")
    if m["kwok_patch_errors_total"]:
        raise AssertionError(f"{m['kwok_patch_errors_total']} patch errors")
    pool = ipaddress.ip_network(CNI_POOL)
    wrong = [p["metadata"]["name"] for p in pods
             if not running(p)
             or p["status"]["podIP"] != prov.setups.get(("default", p["metadata"]["name"]))
             or ipaddress.ip_address(p["status"]["podIP"]) in pool]
    ips = {p["status"]["podIP"] for p in pods}
    if wrong or len(ips) != len(pods) or len(pods) != CLI_PODS - CLI_DELETES:
        raise AssertionError(f"{len(pods)} pods, {len(ips)} distinct IPs; not Running with the "
                             f"provider's IP outside {CNI_POOL}: {wrong[:5]}")
    if len(removes) != CLI_DELETES or set(removes) != deleted:
        extra = sorted(set(removes) - deleted)[:5]
        raise AssertionError(f"{len(removes)} cni removes for {CLI_DELETES} deleted pods "
                             f"({len(set(removes))} distinct; not deleted: {extra})")
    caps, shape_ms, shape_plain_ms, _wire_ms = engine_shape_check(torch, eng, rearm=True)
    log(f"cni: kernel at the engine's capacities {caps}: checked, {shape_ms:.4f} ms")
    native = native_edge(m, summed(m, "kwok_watch_events_total"), lanes=n_lanes)
    return {
        "lanes": n_lanes, "provider": CNI_PROVIDER, **load["report"], "native": native,
        "cni_setups": len(prov.setups), "cni_removes": len(removes),
        "kwok_cpu_s_per_1000_pods": per_1000(load["report"]["window_kwok_process_cpu_s"],
                                             load["report"]["pods"]),
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "pods_per_s_vs_cli": (load["report"]["create_to_running_pods_per_s"]
                              / cli_run["create_to_running_pods_per_s"]),
        "cli_phase_kwok_cpu_s_per_1000_pods": cli_run["kwok_cpu_s_per_1000_pods"],
        "readyz_503_polls": run["readyz"].count(503),
        "watch_relists": m["kwok_watch_relists_total"],
        "status_patches": m["kwok_status_patches_total"],
        "kernel_launches": launches, "capacities": caps,
        "kernel_ms_at_capacities": shape_ms, "plain_ms_at_capacities": shape_plain_ms,
    }


# kwok's entry point in a process of its own for the ha phase (cli.main as
# python -m kwok_tpu_torch.kwok runs it): every 50 ms it writes its
# kernel launches and the rows its takeover refined to the file that
# KWOK_SMOKE_HA_STATUS names; once main has returned it holds the kernel
# against its plain version at its engine's stacked capacities and
# prints the launches and that check on a line of its own
HA_MAIN = """
import json, os, sys, threading, time
import kwok_tpu_torch.engine as engine_mod
from kwok_tpu_torch.kwok import cli
from kwok_tpu_torch.ops import cuda_tick
engines = []
class Recorded(engine_mod.ClusterEngine):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        engines.append(self)
engine_mod.ClusterEngine = Recorded
path = os.environ["KWOK_SMOKE_HA_STATUS"]
def report():
    e = engines[0] if engines else None
    r = e._restore if e is not None else None
    doc = {"launches": cuda_tick.tick_steps.launches,
           "refined": e.metrics.get("restore_refined_rows") if e is not None else None,
           "matched": r.matched if r is not None else None}
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)
def beat():
    while True:
        report()
        time.sleep(0.05)
threading.Thread(target=beat, name="ha-status", daemon=True).start()
rc = cli.main(sys.argv[1:])
out = {"rc": rc, "launches": cuda_tick.tick_steps.launches}
if engines and out["launches"]:
    import torch
    import chip_smoke
    caps, ms, plain_ms, _wire = chip_smoke.engine_shape_check(torch, engines[0], rearm=True)
    out.update(capacities=caps, kernel_ms=ms, plain_ms=plain_ms)
print("ha-main " + json.dumps(out), flush=True)
sys.exit(rc)
"""


def readyz(base: str):
    """(status, reason) of GET /readyz; the reason is the status line's
    text (a degraded engine names its reasons there)."""
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=10) as r:
            return r.status, r.reason
    except urllib.error.HTTPError as e:
        return e.code, str(e.reason)
    except OSError:
        return None, ""


def checkpoint_classes(path: str) -> dict:
    """The pod entries of a checkpoint file by what a restore does with
    them: ``timer`` (a delay residue), ``fired`` (no timer, gen above 0)
    and ``unarmed`` (no timer, gen 0), each split by the recorded phase
    id."""
    try:
        with open(path) as f:
            pods = json.load(f)["kinds"]["pods"]
    except (OSError, ValueError, KeyError):
        return {}
    out: dict = {}
    for _uid, _rv, fire, _hb, gen, phase in pods.values():
        cls = "timer" if fire is not None else ("fired" if gen else "unarmed")
        key = f"{cls}/phase{phase}"
        out[key] = out.get(key, 0) + 1
    return out


def ha_diag(url: str, rig, procs: dict, status) -> dict:
    """What an ha arm that failed leaves to read: the mock's pods not
    Running (a sample with their phase and revision), its Running-patch
    census, and each kwok process's HA, write and queue series."""
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    out: dict = {}
    try:
        out["state"] = rig.state()
        out["writes"] = json.loads(http_get(url + "/rig/writes")[1])
        client = HttpKubeClient(url)
        pods = client.list("pods")
        client.close()
        stuck = [p for p in pods if not running(p)]
        out["not_running"] = len(stuck)
        out["stuck_sample"] = [
            {"name": p["metadata"]["name"], "rv": p["metadata"].get("resourceVersion"),
             "phase": (p.get("status") or {}).get("phase"),
             "node": (p.get("spec") or {}).get("nodeName")} for p in stuck[:8]]
    except Exception as e:  # the dump is best effort: the arm has failed already
        out["mock_error"] = repr(e)
    keep = ("kwok_ha_", "kwok_lease_", "kwok_status_patches_total", "kwok_degraded",
            "kwok_watch_relists_total", "kwok_lane_queue_depth", "kwok_pump_")
    for name, k in procs.items():
        if name == "gone" or k["proc"].poll() is not None:
            continue
        code, text = http_get(k["base"] + "/metrics")
        out[name] = {"readyz": readyz(k["base"]), "status": status(k),
                     "metrics": {s: v for s, v in parse_metrics(text).items()
                                 if s.startswith(keep)} if code == 200 else code}
    return out


def ha_arm(arm: str, cli_run, restart) -> dict:
    """One arm of the ha phase: a primary and a standby through main on
    auto threaded lanes against one native mock under --rig-routes, the
    primary SIGKILLed (``sigkill``) or SIGSTOPped and later SIGCONTed
    (``sigstop``, the zombie) once half the pods are Running."""
    import signal

    from kwok_tpu_torch.edge.httpclient import HttpKubeClient

    here = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix=f"kwok-ha-{arm}-")
    stage_path = os.path.join(workdir, "stages.json")
    with open(stage_path, "w") as f:
        f.write("---\n".join(json.dumps(d) + "\n" for d in stage_documents()))
    ckpt_dir = os.path.join(workdir, "ckpt")
    os.mkdir(ckpt_dir)
    mock = subprocess.Popen(mock_command("native") + ["--rig-routes"], cwd=here,
                            stdout=subprocess.PIPE, text=True)
    procs: dict = {}
    outs: dict = {}
    info: dict = {"arm": arm, "nodes": HA_NODES, "pods": HA_PODS, "lease_s": HA_LEASE_S}
    try:
        url = mock_url(mock)
        check_mock(url, "native")
        import drift_rig

        rig = drift_rig.RigClient(url)
        deadline = time.monotonic() + HA_DEADLINE_S
        proc, _span = spawn_creator(url, "nodes", HA_NODES, nodes=HA_NODES)
        join_creator(proc, deadline)

        def start(role: str, ident: str) -> dict:
            port = free_port()
            status = os.path.join(workdir, f"{ident}.status.json")
            p = subprocess.Popen(
                [sys.executable, "-c", HA_MAIN, "--master", url,
                 "--kubeconfig", os.path.join(workdir, "no-kubeconfig"),
                 "--manage-all-nodes", "true", "--server-address", f"127.0.0.1:{port}",
                 "--cidr", "10.0.0.1/16", "--config", stage_path, "--ha-role", role,
                 "--ha-identity", ident, "--lease-duration", str(HA_LEASE_S),
                 "--checkpoint-dir", ckpt_dir, "--checkpoint-interval", "1"],
                cwd=here, stdout=subprocess.PIPE, text=True,
                env={**os.environ, "KWOK_SMOKE_HA_STATUS": status})
            return {"proc": p, "base": f"http://127.0.0.1:{port}", "status": status}

        def status(k: dict) -> dict:
            try:
                with open(k["status"]) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return {}

        def metrics(k: dict) -> dict:
            code, text = http_get(k["base"] + "/metrics")
            if code != 200:
                raise AssertionError(f"{arm}: kwok /metrics answered {code}")
            return parse_metrics(text)

        def wait(pred, what: str, limit: float, every: float = 0.02) -> float:
            t0 = time.monotonic()
            while not pred():
                if time.monotonic() - t0 > limit or time.monotonic() > deadline:
                    raise AssertionError(f"{arm}: {what} not within {limit} s")
                for k in procs.values():
                    if k["proc"].poll() is not None and k is not procs.get("gone"):
                        raise AssertionError(f"{arm}: a kwok process exited "
                                             f"{k['proc'].returncode} while waiting for {what}")
                time.sleep(every)
            return time.monotonic() - t0

        a = procs["a"] = start("primary", "a")
        wait(lambda: readyz(a["base"])[0] == 200, "the primary's /readyz 200", 120.0)
        b = procs["b"] = start("standby", "b")
        wait(lambda: "ha_standby" in readyz(b["base"])[1], "the standby's ha_standby", 120.0)

        def silent_standby(when: str) -> dict:
            m = metrics(b)
            seen = {"readyz": readyz(b["base"]),
                    "role_standby": m.get('kwok_ha_role{role="standby"}'),
                    "status_patches": m.get("kwok_status_patches_total", 0.0),
                    "launches": status(b).get("launches")}
            if (seen["readyz"][0] != 503 or "ha_standby" not in seen["readyz"][1]
                    or seen["role_standby"] != 1 or seen["status_patches"] != 0
                    or seen["launches"] != 0):
                raise AssertionError(f"{arm}: the standby {when} is not silent: {seen}")
            return seen

        info["standby_at_ready"] = silent_standby("at its start")
        t_first = time.time()
        creator, span = spawn_creator(url, "pods", HA_PODS, nodes=HA_NODES)
        wait(lambda: rig.state()["running"] >= HA_PODS // 2, "half the pods Running", 120.0,
             every=0.1)
        info["standby_before_kill"] = silent_standby("before the takeover")
        info["running_at_kill"] = rig.state()["running"]
        sig = signal.SIGKILL if arm == "sigkill" else signal.SIGSTOP
        t_kill = time.monotonic()
        os.kill(a["proc"].pid, sig)
        procs["gone"] = a  # killed, or stopped until SIGCONT: not polled
        info["rto_s"] = wait(lambda: readyz(b["base"])[0] == 200,
                             "the standby's /readyz 200", HA_TAKEOVER_S)
        t_led = time.monotonic()
        info["primary_checkpoint"] = checkpoint_classes(os.path.join(ckpt_dir, "a.ckpt.json"))
        if arm == "sigstop":
            os.kill(a["proc"].pid, signal.SIGCONT)
            procs.pop("gone")
            info["stopped_s"] = time.monotonic() - t_kill
            info["depose_s"] = wait(
                lambda: metrics(a).get('kwok_ha_role{role="lost"}') == 1
                and "ha_lost_lease" in readyz(a["base"])[1],
                "the zombie's role lost and ha_lost_lease", HA_DEPOSE_S)
        join_creator(creator, deadline)
        wait(lambda: rig.state()["running"] == HA_PODS, "every pod Running", 180.0, every=0.1)
        t_running = time.time()
        info["pod_create_s"] = span[1] - span[0]
        info["create_to_running_pods_per_s"] = HA_PODS / (t_running - t_first)
        info["cli_phase_pods_per_s"] = cli_run["create_to_running_pods_per_s"]
        info["takeover_to_running_s"] = time.monotonic() - t_led
        client = HttpKubeClient(url)
        pods = client.list("pods")
        client.close()
        ips = [(p.get("status") or {}).get("podIP") for p in pods]
        if len(pods) != HA_PODS or not all(ips) or len(set(ips)) != HA_PODS:
            raise AssertionError(f"{arm}: {len(pods)} pods, {len(set(ips))} distinct pod IPs")
        writes = json.loads(http_get(url + "/rig/writes")[1])
        info["running_patches"] = writes
        if writes["most"] != 1 or writes["running_patched_pods"] != HA_PODS:
            raise AssertionError(f"{arm}: a pod patched Running twice or not at all: {writes}")
        mb = metrics(b)
        info["standby_end"] = {
            "readyz": readyz(b["base"]), "role_leader": mb.get('kwok_ha_role{role="leader"}'),
            "lease_transitions": mb.get("kwok_lease_transitions_total"),
            "takeover_s": mb.get("kwok_ha_takeover_seconds"),
            "fenced_writes": mb.get("kwok_ha_fenced_writes_total"),
            "status_patches": mb.get("kwok_status_patches_total"), **status(b)}
        se = info["standby_end"]
        if (se["readyz"][0] != 200 or se["role_leader"] != 1 or se["lease_transitions"] != 1
                or not se.get("launches")):
            raise AssertionError(f"{arm}: the standby after the takeover: {se}")
        if arm == "sigstop":
            ma = metrics(a)
            info["zombie"] = {"readyz": readyz(a["base"]),
                              "role_lost": ma.get('kwok_ha_role{role="lost"}'),
                              "fenced_writes": ma.get("kwok_ha_fenced_writes_total", 0.0),
                              "mock_fenced_409": writes["fenced_409"]}
            z = info["zombie"]
            if z["role_lost"] != 1 or "ha_lost_lease" not in z["readyz"][1] or not (
                    z["fenced_writes"] > 0 or z["mock_fenced_409"] > 0):
                raise AssertionError(f"{arm}: the zombie was not fenced and deposed: {z}")
        info["restart_recovery_s"] = restart["restart_recovery_seconds"]
        if info["rto_s"] >= restart["restart_recovery_seconds"]:
            raise AssertionError(f"{arm}: failover took {info['rto_s']:.3f} s, not less than a "
                                 f"cold restart's {restart['restart_recovery_seconds']:.3f} s")
    except AssertionError:
        if "status" in locals():  # the kwok processes had started
            log(f"ha-diag {json.dumps(ha_diag(url, rig, procs, status))}")
        raise
    finally:
        for k in procs.values():
            p = k["proc"]
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)  # a stopped process must see its SIGTERM
                p.terminate()
        for name, k in procs.items():
            if name == "gone":
                continue
            p = k["proc"]
            try:
                out, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=30)
            line = [ln for ln in (out or "").splitlines() if ln.startswith("ha-main ")]
            outs[name] = {"returncode": p.returncode,
                          **(json.loads(line[-1].split(" ", 1)[1]) if line else {})}
        mock.terminate()
        try:
            mock.wait(30)
        except subprocess.TimeoutExpired:
            mock.kill()
            mock.wait(30)
    if arm == "sigkill":
        outs.pop("a", None)  # killed: it prints nothing
    info["exits"] = outs
    for name, o in outs.items():
        if o.get("returncode") != 0 or o.get("rc") != 0:
            raise AssertionError(f"{arm}: kwok {name} did not exit 0 on SIGTERM: {o}")
    sb = outs["b"]
    if sb.get("launches", 0) <= 0 or "kernel_ms" not in sb:
        raise AssertionError(f"{arm}: the standby launched no tick kernel after the takeover: {sb}")
    info["kernel_launches"] = sum(o.get("launches", 0) for o in outs.values())
    log(f"ha ({arm}): RTO {info['rto_s']:.3f} s against a {HA_LEASE_S} s lease and a cold "
        f"restart's {info['restart_recovery_s']:.3f} s; kernel at the standby's capacities "
        f"{sb['capacities']}: checked, {sb['kernel_ms']:.4f} ms")
    return info


def ha_phase(cli_run, restart) -> dict:
    """Phase 13: warm-standby HA through main, two arms (see the module
    docstring)."""
    out = {arm: ha_arm(arm, cli_run, restart) for arm in ("sigkill", "sigstop")}
    out["kernel_launches"] = sum(a["kernel_launches"] for a in out.values())
    return out


def member_stage_documents() -> list[dict]:
    """Federation members 6 and 7's pod Stages: the default pod-delete
    stage and one constant 1 s Pending->Running stage (a second rule-set
    group beside the CLI phase's weighted uniform stages)."""
    delete, _fast, _slow = stage_documents()
    running_1s = json.loads(json.dumps(_fast))
    running_1s["metadata"]["name"] = "pod-running-1s"
    running_1s["spec"]["delay"] = {"duration": "1s"}
    del running_1s["spec"]["weight"]
    return [delete, running_1s]


class GroupView:
    """One federation group seen as engine_shape_check sees an engine:
    its kernel specs, clock and pod phase ids."""

    def __init__(self, group) -> None:
        self._group = group
        e0 = group.engines[0]
        self._now = e0._now
        self._pod_phase_ids = e0._pod_phase_ids

    def _get_fused(self):
        return self._group.fused


def summed(m: dict, name: str) -> float:
    """The sum of a family's series over its labels (a federation's
    per-shard counters, the kind-labeled counters)."""
    return sum(v for k, v in m.items() if k == name or k.startswith(name + "{"))


def stage_sum(m: dict, name: str, stage: str) -> float:
    """``summed`` over the series of one ``stage`` label value."""
    return sum(v for k, v in m.items()
               if k.startswith(name + "{") and f'stage="{stage}"' in k)


def fed_phase(cli_run):
    """The kwok entry point with --master naming 8 mock apiservers (BASELINE
    config 5): one federation member per mock, two rule-set groups (see
    the module docstring, phase 8)."""
    import torch

    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.telemetry.trace import check_chrome_trace

    n = FED_MEMBERS
    ckpt_dir = tempfile.mkdtemp(prefix="kwok-fed-ckpt-")
    member_path = os.path.join(ckpt_dir, "member-stages.json")
    with open(member_path, "w") as f:
        f.write("---\n".join(json.dumps(d) + "\n" for d in member_stage_documents()))
    member_argv = []
    for c in range(n):
        member_argv += ["--member-config", member_path if c in FED_MEMBER_CONFIG else ""]
    cuda_tick.tick_steps.launches = 0
    run = start_cli(["--checkpoint-dir", ckpt_dir, "--checkpoint-interval", "1", *member_argv],
                    members=n, nodes=FED_NODES)
    try:
        fed = run["engine"]
        if not hasattr(fed, "groups") or len(fed.engines) != n:
            raise AssertionError(f"--master with {n} URLs did not run a federation of {n}")
        from kwok_tpu_torch.parallel.mesh import local_devices

        if fed.mesh.devices != tuple(local_devices(DEVICE)):
            raise AssertionError(f"the federation's mesh {fed.mesh} is not every visible card")
        parts = [[fed.engines.index(e) for e in g.engines] for g in fed.groups]
        if sorted(parts) != [sorted(set(range(n)) - FED_MEMBER_CONFIG), sorted(FED_MEMBER_CONFIG)]:
            raise AssertionError(f"rule-set groups {parts}")
        caps_start = [g.stacked["pods"].capacity for g in fed.groups]
        mocks = run["mocks"]
        m0 = scrape(run)
        cpu0 = {p.pid: cpu_seconds(p.pid) for p in mocks}
        creators = [spawn_creator(u, "pods", FED_PODS, nodes=FED_NODES, conns=FED_CONNS)
                    for u in run["urls"]]
        for proc, _span in creators:
            join_creator(proc, run["deadline"])
        clients = [HttpKubeClient(u) for u in run["urls"]]
        want = n * (FED_NODES + FED_PODS)
        while True:
            m_run = scrape(run)
            if summed(m_run, "kwok_status_patches_total") >= want:
                t_patched = time.time()
                cpu_run = {pid: cpu_seconds(pid) for pid in cpu0}
                if all(sum(map(running, c.list("pods"))) == FED_PODS for c in clients):
                    break
            if time.monotonic() > run["deadline"]:
                raise AssertionError(f"timeout: {summed(m_run, 'kwok_status_patches_total')} patches")
            time.sleep(POLL_S)
        for c, client in enumerate(clients):
            n_ready = sum(
                any(x.get("type") == "Ready" and x.get("status") == "True"
                    for x in (nd.get("status") or {}).get("conditions") or [])
                for nd in client.list("nodes"))
            if n_ready != FED_NODES:
                raise AssertionError(f"member {c}: {n_ready} of {FED_NODES} nodes Ready")
        # one merged span trace: the federated loop's and every member's
        code, text = http_get(run["base"] + "/debug/trace")
        if code != 200:
            raise AssertionError(f"/debug/trace answered {code}")
        trace = json.loads(text)
        check_chrome_trace(trace)
        labels = sorted(e["args"]["name"] for e in trace["traceEvents"]
                        if e["name"] == "process_name")
        if labels != sorted(["federation"] + [f"shard{c}" for c in range(n)]):
            raise AssertionError(f"/debug/trace process labels {labels}")
        trace_spans = trace_names(trace)
        # the graceful deletes, spread over the members
        per = [FED_DELETES // n + (c < FED_DELETES % n) for c in range(n)]
        t_del = time.time()
        for c, client in enumerate(clients):
            for i in range(per[c]):
                client.delete("pods", "default", f"pod-{i}", grace_seconds=30)
        while True:
            # the engine's counters first: a LIST of every member decodes
            # 50,000 objects in this process, beside the engine it measures
            m = scrape(run)
            if (summed(m, "kwok_deletes_total") >= FED_DELETES
                    and m.get("kwok_fed_pods_managed") == n * FED_PODS - FED_DELETES):
                pods = [c.list("pods") for c in clients]
                if all(len(p) == FED_PODS - per[i] for i, p in enumerate(pods)):
                    break
            if time.monotonic() > run["deadline"]:
                raise AssertionError(f"timeout deleting: {summed(m, 'kwok_deletes_total')} deletes, "
                                     f"kwok_fed_pods_managed {m.get('kwok_fed_pods_managed')}")
            time.sleep(POLL_S)
        t_deleted = time.time()
        for c in clients:
            c.close()
        terminations = mock_terminations(run)
    finally:
        stop_cli(run)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the federation ran without launching the tick kernel")
    dispatches = [m.get(f'kwok_group_dispatches_total{{group="{i}"}}', 0) for i in range(len(fed.groups))]
    if not all(d > 0 for d in dispatches):
        raise AssertionError(f"group dispatches {dispatches}")
    if summed(m, "kwok_status_patches_total") < want or summed(m, "kwok_patch_errors_total"):
        raise AssertionError(f"/metrics: {m}")
    for c, member_pods in enumerate(pods):
        names = {p["metadata"]["name"] for p in member_pods}
        if any(f"pod-{i}" in names for i in range(per[c])):
            raise AssertionError(f"member {c}: a deleted pod is still listed")
        ips = {p["status"]["podIP"] for p in member_pods}
        if len(ips) != len(member_pods) or not all(ip.startswith("10.0.") for ip in ips):
            raise AssertionError(f"member {c}: {len(member_pods)} pods, {len(ips)} distinct IPs in the CIDR")
    files = {f"member{c}.ckpt.json" for c in range(n)}
    if not files <= set(os.listdir(ckpt_dir)):
        raise AssertionError(f"checkpoints: {sorted(os.listdir(ckpt_dir))}")
    groups = []
    for g in fed.groups:
        caps, ms, plain_ms, wire_ms = engine_shape_check(
            torch, GroupView(g), rearm=True, states=(g.stacked["nodes"], g.stacked["pods"]),
            fire_after=1.5)
        groups.append({
            "members": [fed.engines.index(e) for e in g.engines],
            "rows_per_member": g.r, "capacities": caps,
            "dispatches": g.dispatches, "kernel_ms_at_capacities": ms,
            "plain_ms_at_capacities": plain_ms, "wire_d2h_ms_at_capacities": wire_ms,
            "bound_ms_at_capacities": byte_bound_ms(caps),
        })
        log(f"kernel at federation group {groups[-1]['members']}'s capacities {caps}: checked; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, wire D2H {wire_ms:.4f} ms")
    t_pods = min(span[0] for _p, span in creators)
    t_created = max(span[1] for _p, span in creators)
    window = t_patched - t_pods
    total = n * FED_PODS
    native = native_edge(m, summed(m, "kwok_watch_events_total"))
    kwok_cpu = m_run["process_cpu_seconds_total"] - m0["process_cpu_seconds_total"]
    mocks_cpu = sum(cpu_run[pid] - cpu0[pid] for pid in cpu0)
    return {
        "native": native, "kwok_cpu_s_per_1000_pods": per_1000(kwok_cpu, total),
        "mock": run["mock_kind"], "mock_cpu_s_per_1000_pods": per_1000(mocks_cpu, total),
        "watch_terminations": terminations,
        "watch_relists": summed(m, "kwok_watch_relists_total"),
        "members": n, "nodes": n * FED_NODES, "pods": total, "deleted": FED_DELETES,
        "connections_per_member": FED_CONNS, "groups": groups,
        "mesh": [str(d) for d in fed.mesh.devices],
        "pod_capacities_start": caps_start,
        "create_to_running_pods_per_s": total / window,
        "pod_create_s": t_created - t_pods, "create_to_running_s": window,
        "delete_s": t_deleted - t_del,
        "status_patches_per_s": (summed(m_run, "kwok_status_patches_total")
                                 - summed(m0, "kwok_status_patches_total")) / window,
        "window_kwok_process_cpu_s": (m_run["process_cpu_seconds_total"]
                                      - m0["process_cpu_seconds_total"]),
        "window_mocks_cpu_s": mocks_cpu,
        "window_mock_cpu_s": [cpu_run[pid] - cpu0[pid] for pid in cpu0],
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "cli_phase_status_patches_per_s": cli_run["status_patches_per_s"],
        "readyz_503_polls": run["readyz"].count(503), "main_to_ready_s": run["main_to_ready_s"],
        "stop_s": run["stop_s"],
        "status_patches": summed(m, "kwok_status_patches_total"),
        "ticks": summed(m, "kwok_ticks_total") / n, "kernel_launches": launches,
        "transitions": summed(m, "kwok_transitions_total"),
        "watch_events": summed(m, "kwok_watch_events_total"),
        "tick_thread_s": summed(m, "kwok_tick_seconds_sum") / n,
        "window_tick_thread_s": (summed(m_run, "kwok_tick_seconds_sum")
                                 - summed(m0, "kwok_tick_seconds_sum")) / n,
        "trace_labels": labels, "trace_span_names": sorted(trace_spans),
    }


def mesh_devices(n: int) -> list:
    """``n`` shards round-robin over the visible cards."""
    from kwok_tpu_torch.parallel.mesh import local_devices

    visible = local_devices(DEVICE)
    return [visible[i % len(visible)] for i in range(n)]


class shards_of:
    """``parallel.mesh.local_devices`` names MESH_SHARDS shards round-robin
    over the visible cards for one block, so an engine built inside it
    with ``use_mesh`` splits its rows into that many shards (several on
    one card of a host with fewer cards)."""

    def __enter__(self):
        from kwok_tpu_torch.parallel import mesh as mesh_mod

        self.mod, self.real = mesh_mod, mesh_mod.local_devices
        devs = mesh_devices(MESH_SHARDS)
        mesh_mod.local_devices = lambda device="cuda": list(devs)
        return devs

    def __exit__(self, *exc) -> None:
        self.mod.local_devices = self.real


def time_fused(torch, kern, states, now: float, reps: int) -> list:
    """CUDA-event ms of ``reps`` whole dispatches of ``kern`` (launches,
    gathers, the wire and its D2H copy) at engine time ``now``; a
    device-side sleep queued first keeps the card busy while the host
    enqueues, so the events time the device work."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        kern(states, now)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def mesh_kernel_leg(torch, np) -> list:
    """(a) The split dispatch against the unsplit one at the kernel
    phase's shapes (each kind padded to a multiple of MESH_SHARDS), over
    MESH_SHARDS shards round-robin on the visible cards: three dispatches
    per rule set and K, each wire byte for byte and then every state
    field equal; then ms per dispatch of both (CUDA events, median of
    2 x MESH_REPS, in turns unsplit, split, split, unsplit)."""
    from kwok_tpu_torch.models import compile_rules, default_node_rules, default_pod_rules
    from kwok_tpu_torch.models.defaults import chaos_pod_rules
    from kwok_tpu_torch.models.lifecycle import ResourceKind
    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops import state as ts
    from kwok_tpu_torch.ops.tick import MultiTickKernel
    from kwok_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple

    mesh = make_mesh(devices=mesh_devices(MESH_SHARDS))
    ntab = compile_rules(default_node_rules(), ResourceKind.NODE)
    pod_tabs = {"default": compile_rules(default_pod_rules(), ResourceKind.POD),
                "chaos": compile_rules(chaos_pod_rules(5.0), ResourceKind.POD)}
    caps = [pad_to_multiple(NODE_ROWS, mesh), pad_to_multiple(POD_ROWS, mesh)]
    if caps != [NODE_ROWS, POD_ROWS]:
        raise AssertionError(f"the kernel phase's rows {NODE_ROWS}, {POD_ROWS} do not split in "
                             f"{MESH_SHARDS}")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    configs = []
    for rname, ptab in pod_tabs.items():
        for steps in SUBSTEPS:
            specs = [(ntab, 30.0, (), 1), (ptab, 30.0, (), -1)]
            one = MultiTickKernel(specs, steps=steps, dt=DT, device=DEVICE)
            split = MultiTickKernel(specs, steps=steps, dt=DT, mesh=mesh)
            hosts = host_states(np, seed=steps)
            a = tuple(ts.from_numpy(h, DEVICE) for h in hosts)
            b = tuple(split.place(h) for h in hosts)
            split_launches = 0
            for n, now in enumerate((0.0, 0.8, 6.0), start=1):
                _, wa = one(a, now)
                before = cuda_tick.tick_steps.launches
                _, wb = split(b, now)
                split_launches += cuda_tick.tick_steps.launches - before
                # one fused launch per shard ticks both kinds of its rows
                if cuda_tick.tick_steps.launches - before != MESH_SHARDS:
                    raise AssertionError(f"mesh {rname} K={steps}: a split dispatch launched "
                                         f"{cuda_tick.tick_steps.launches - before} times")
                wa, wb = np.asarray(wa), np.asarray(wb)
                if wa.shape != wb.shape or not np.array_equal(wa, wb):
                    nd = int((wa != wb).sum()) if wa.shape == wb.shape else -1
                    raise AssertionError(f"mesh {rname} K={steps} dispatch {n}: the split wire "
                                         f"differs from the unsplit one in {nd} bytes")
            for kind, x, y in zip(("nodes", "pods"), a, b):
                hx, hy = ts.to_numpy(x), ts.to_numpy(y)
                for f in ts.RowState._fields:
                    if not np.array_equal(getattr(hx, f), getattr(hy, f)):
                        raise AssertionError(f"mesh {rname} K={steps} {kind}: {f} differs")
            times = {"unsplit": [], "split": []}
            for path in ("unsplit", "split", "split", "unsplit"):
                kern, states = (one, a) if path == "unsplit" else (split, b)
                times[path] += time_fused(torch, kern, states, 0.8, MESH_REPS)
            bound = byte_bound_ms(caps)
            configs.append({
                "rules": rname, "substeps": steps, "rows": sum(caps), "shards": MESH_SHARDS,
                "split_ms": med(times["split"]), "unsplit_ms": med(times["unsplit"]),
                "bound_ms": bound, "bound_by": "bytes", "split_launches": split_launches,
                "wire_identical": True,
            })
            log(f"mesh {rname} K={steps}: split wire and state identical to the unsplit ones; "
                f"dispatch {configs[-1]['split_ms']:.4f} ms split, "
                f"{configs[-1]['unsplit_ms']:.4f} ms unsplit, bound {bound:.4f} ms")
    return configs


def mesh_cli_leg() -> dict:
    """(c) ``python -m kwok_tpu_torch.kwok --use-mesh true`` through
    start_cli at MESH_CLI_NODES nodes and MESH_CLI_PODS pods: the mesh
    holds every visible card once."""
    import logging

    import torch

    from kwok_tpu_torch.ops import cuda_tick
    from kwok_tpu_torch.ops.state import SplitState
    from kwok_tpu_torch.parallel.mesh import local_devices

    lines: list = []

    class Keep(logging.Handler):
        def emit(self, record) -> None:
            lines.append(record.getMessage())

    keep = Keep(logging.INFO)
    engine_log = logging.getLogger("kwok_tpu_torch.engine")
    engine_log.addHandler(keep)
    cuda_tick.tick_steps.launches = 0
    try:
        with sized(CLI_NODES=MESH_CLI_NODES, CLI_PODS=MESH_CLI_PODS):
            run = start_cli(["--use-mesh", "true"])
            try:
                eng = run["engine"]
                want = tuple(local_devices(DEVICE))
                if eng._mesh is None or eng._mesh.devices != want:
                    raise AssertionError(f"--use-mesh true: mesh {eng._mesh}, want {want}")
                load = drive_pods(run)
                pods = load["client"].list("pods")
                m = scrape(run)
            finally:
                stop_cli(run)
            check_final_pods(pods, m)
    finally:
        engine_log.removeHandler(keep)
    launches = cuda_tick.tick_steps.launches
    if launches <= 0:
        raise AssertionError("the --use-mesh CLI ran without launching the tick kernel")
    if m["kwok_pump_requests_total"] <= 0:
        raise AssertionError("the --use-mesh CLI shipped nothing through the pump")
    names = ", ".join(str(d) for d in eng._mesh.devices)
    said = [ln for ln in lines if ln.startswith("row split over") and ln.endswith(names)]
    if not said:
        raise AssertionError(f"the log never named the mesh's devices ({names})")
    if not all(isinstance(st, SplitState) for st in engine_states(eng)):
        raise AssertionError("the CLI engine's stacked states are not split")
    caps, ms, plain_ms, wire_ms = engine_shape_check(torch, eng, rearm=True)
    return {
        **load["report"], "kernel_launches": launches,
        "shards": [str(d) for d in eng._mesh.devices], "shard_launches": list(eng._mesh.launches),
        "log_line": said[0], "readyz_503_polls": run["readyz"].count(503),
        "pump_requests": m["kwok_pump_requests_total"],
        "capacities": caps, "kernel_ms_at_capacities": ms, "plain_ms_at_capacities": plain_ms,
        "wire_d2h_ms_at_capacities": wire_ms, "bound_ms_at_capacities": byte_bound_ms(caps),
    }


def mesh_phase() -> dict:
    """The row split (ROADMAP item 9b), three legs: (a) the split kernel
    dispatch against the unsplit one, then ``graft.dryrun_multichip``
    over MESH_SHARDS shards of the card, (b) ClusterEngine(use_mesh=True)
    over MESH_SHARDS shards in process at the engine phase's width with
    auto threaded lanes, (c) the entry point with --use-mesh true."""
    import numpy as np
    import torch

    from kwok_tpu_torch import graft
    from kwok_tpu_torch.config.types import resolve_drain_shards

    print(f"mesh: torch.cuda.device_count() {torch.cuda.device_count()}", flush=True)
    for i, d in enumerate(mesh_devices(MESH_SHARDS)):
        print(f"mesh: shard {i} on {d} ({torch.cuda.get_device_name(d)})", flush=True)
    kernel = mesh_kernel_leg(torch, np)
    # graft.dryrun_multichip over MESH_SHARDS shards of the card: it raises
    # on a failed check; federation_running counts, per member, the pods
    # that reached Running (Running or, under member 1's chaos rules,
    # Succeeded)
    t = time.monotonic()
    dry = graft.dryrun_multichip(MESH_SHARDS)
    dry["seconds"] = time.monotonic() - t
    print(f"mesh: dryrun_multichip({MESH_SHARDS}) {json.dumps(dry)}", flush=True)
    with shards_of():
        engine = engine_phase(resolve_drain_shards(0), use_mesh=True)
    cli = mesh_cli_leg()
    return {"kernel": kernel, "dryrun_multichip": dry, "engine": engine, "cli": cli,
            "kernel_launches": engine["kernel_launches"] + cli["kernel_launches"]}


KWOKCTL_NAME = "smoke"
# the secure arm: the Python mock under mTLS (the native server is
# plaintext only) at a tenth of the CLI phase's width
KWOKCTL_TLS_NAME = "smoke-tls"
KWOKCTL_TLS_NODES = 1_000
KWOKCTL_TLS_PODS = 2_500
KWOKCTL_TLS_FAILED = re.compile(r"(\d+) TLS handshakes failed")
KWOKCTL_MORE_PODS = 1_000  # created after the stop and start
KWOKCTL_STOPPED = re.compile(r"engine stopped: (\d+) tick kernel launches, capacities (\[.*\])")


def kwokctl_documents() -> list[dict]:
    """The extra config of the kwokctl phase's cluster: the CLI phase's
    --cidr as a KwokConfiguration and its Stages, which kwokctl saves into
    the cluster's kwok.yaml for its kwok-controller."""
    return [{"apiVersion": "kwok.x-k8s.io/v1alpha1", "kind": "KwokConfiguration",
             "options": {"cidr": "10.0.0.1/16"}}, *stage_documents()]


def kwokctl_cli(name: str, env: dict, here: str):
    """``run(*argv, timeout=300)``: `python3 -m kwok_tpu_torch.kwokctl
    --name NAME ARGV...` in ``env``, its stdout; raises on a non-zero
    exit with the end of its stderr."""
    def run(*argv, timeout: float = 300.0) -> str:
        out = subprocess.run(
            [sys.executable, "-m", "kwok_tpu_torch.kwokctl", "--name", name, *argv],
            cwd=here, env=env, capture_output=True, text=True, timeout=timeout)
        if out.returncode != 0:
            raise AssertionError(f"kwokctl --name {name} {' '.join(argv)}: exit "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        return out.stdout

    return run


def controller_config(argv: list):
    """The EngineConfig the kwok-controller builds from ``argv``, its
    command line (the config file it names must exist): the rules and
    the lanes of the kernel check at that controller's capacities."""
    from kwok_tpu_torch.config.stages import Stage
    from kwok_tpu_torch.config.types import (
        KwokConfiguration,
        apply_env_overrides,
        first_of,
        load_documents,
    )
    from kwok_tpu_torch.kwok import cli

    config = next(a.split("=", 1)[1] for a in argv if a.startswith("--config="))
    docs = load_documents(config)
    conf = first_of(docs, KwokConfiguration) or KwokConfiguration()
    apply_env_overrides(conf.options)
    stages = [d for d in docs if isinstance(d, Stage)]
    args = cli.build_parser(conf.options).parse_args(argv)
    return cli._engine_config(args, stages, DEVICE)


def kwokctl_phase(cli_run):
    """kwokctl's mock runtime on the card (see the module docstring,
    phase 14): the cluster a user stands up with `python3 -m
    kwok_tpu_torch.kwokctl create cluster --runtime mock`, at the CLI
    phase's width."""
    import types

    import numpy as np
    import torch

    from kwok_tpu_torch.config.ctl import KwokctlConfiguration
    from kwok_tpu_torch.config.types import first_of, load_documents
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine

    here = os.path.dirname(os.path.abspath(__file__))
    home = tempfile.mkdtemp(prefix="kwok-smoke-kwokctl-")
    wd = os.path.join(home, "clusters", KWOKCTL_NAME)
    extra = os.path.join(home, "cluster-config.json")
    with open(extra, "w") as f:
        f.write("---\n".join(json.dumps(d) + "\n" for d in kwokctl_documents()))
    env = {**os.environ, "KWOK_WORKDIR": home,
           "KWOK_KUBECTL_BINARY": "file:///nonexistent/kubectl"}
    if DEVICE == "cuda":
        env.pop("KWOK_TPU_PLATFORM", None)  # the controller runs on the card
    # no kubectl on the PATH: the kubectl verb goes through the built-in shim
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "kubectl")))

    kwokctl = kwokctl_cli(KWOKCTL_NAME, env, here)

    def pids() -> dict:
        d = os.path.join(wd, "pids")
        return {f[:-len(".pid")]: int(open(os.path.join(d, f)).read()) for f in os.listdir(d)}

    def ready(deadline: float) -> None:
        while http_get(base + "/readyz")[0] != 200:
            if time.monotonic() > deadline:
                raise AssertionError("the kwok-controller's /readyz never answered 200; log: "
                                     + kwokctl("logs", "kwok-controller")[-2000:])
            time.sleep(POLL_S)

    def all_running(client, want: int, deadline: float) -> float:
        t0 = time.monotonic()
        while True:
            pods = client.list("pods")
            if len(pods) == want and all(map(running, pods)):
                return time.monotonic() - t0
            if time.monotonic() > deadline:
                raise AssertionError(f"{sum(map(running, pods))} of {want} pods Running "
                                     f"({len(pods)} listed)")
            time.sleep(POLL_S)

    def stopped() -> tuple[int, list]:
        """kwokctl stop cluster; the stopped controller's launches and
        capacities from its last log line, read with kwokctl logs."""
        before = pids()
        t = time.monotonic()
        kwokctl("stop", "cluster")
        stop_s.append(time.monotonic() - t)
        if any(_alive(p) for p in before.values()):
            raise AssertionError(f"stop cluster left a process alive: {before}")
        text = kwokctl("logs", "kwok-controller")
        found = KWOKCTL_STOPPED.search(text)
        if found is None:
            raise AssertionError(f"no 'engine stopped' line in the controller's log: {text[-2000:]}")
        return int(found.group(1)), json.loads(found.group(2))

    stop_s: list = []
    seen_pids: set = set()
    base = ""
    t_phase = time.monotonic()
    try:
        t = time.monotonic()
        kwokctl("create", "cluster", "--runtime", "mock", "--wait", "120s", "--config", extra)
        create_s = time.monotonic() - t
        seen_pids |= set(pids().values())
        with open(os.path.join(wd, "kubeconfig.yaml")) as f:
            url = json.load(f)["clusters"][0]["cluster"]["server"]
        opts = first_of(load_documents(os.path.join(wd, "kwok.yaml")), KwokctlConfiguration).options
        base = f"http://127.0.0.1:{opts.kwokControllerPort}"
        with open(os.path.join(wd, "cmdline", "kwok-controller")) as f:
            check_cfg = controller_config(f.read().split("\x00")[1:])
        check_mock(url, "native")
        run = {"url": url, "urls": [url], "base": base, "mock_kind": "native",
               "mock": types.SimpleNamespace(pid=pids()["kube-apiserver"]),
               "deadline": time.monotonic() + CLI_DEADLINE_S}
        ready(run["deadline"])
        controller_ready_s = time.monotonic() - t
        proc, _span = spawn_creator(url, "nodes", CLI_NODES)
        join_creator(proc, run["deadline"])
        load = drive_pods(run)
        client = load["client"]
        pods = client.list("pods")
        m = scrape(run)
        check_final_pods(pods, m)
        started = kwokctl("logs", "kwok-controller")
        if f"engine started on {DEVICE}" not in started:
            raise AssertionError(f"the controller's log does not say it started on {DEVICE}: "
                                 f"{started[-2000:]}")
        code, text = http_get(base + "/debug/trace")
        if code != 200:
            raise AssertionError(f"the controller's /debug/trace answered {code}")
        dispatch_spans = sum(1 for e in json.loads(text)["traceEvents"]
                             if e.get("name") == "tick.dispatch")
        if m["kwok_ticks_total"] <= 0 or dispatch_spans <= 0:
            raise AssertionError(f"kwok_ticks_total {m['kwok_ticks_total']}, "
                                 f"tick.dispatch spans {dispatch_spans}")
        t = time.monotonic()
        listed = kwokctl("kubectl", "get", "pods", "-A", "-o", "name").split()
        kubectl_s = time.monotonic() - t
        if not os.path.exists(os.path.join(wd, "bin", "kubectl-builtin.py")):
            raise AssertionError("kwokctl kubectl did not go through the built-in shim")
        if len(listed) != CLI_PODS - CLI_DELETES or not all(n.startswith("pod/") for n in listed):
            raise AssertionError(f"kwokctl kubectl get pods -A -o name: {len(listed)} names")
        launches_a, caps_a = stopped()
        t = time.monotonic()
        kwokctl("start", "cluster")
        seen_pids |= set(pids().values())
        ready(time.monotonic() + CLI_DEADLINE_S)
        restart_ready_s = time.monotonic() - t
        deadline = time.monotonic() + CLI_DEADLINE_S
        all_running(client, CLI_PODS - CLI_DELETES, deadline)
        proc, _span = spawn_creator(url, "pods", KWOKCTL_MORE_PODS, first=CLI_PODS)
        join_creator(proc, deadline)
        more_s = all_running(client, CLI_PODS - CLI_DELETES + KWOKCTL_MORE_PODS, deadline)
        snap = os.path.join(home, "snapshot.json")
        t = time.monotonic()
        kwokctl("snapshot", "save", "--path", snap)
        save_s = time.monotonic() - t
        with open(snap) as f:
            saved = len(json.load(f)["objects"]["pods"])
        if saved != CLI_PODS - CLI_DELETES + KWOKCTL_MORE_PODS:
            raise AssertionError(f"the snapshot holds {saved} pods")
        t_restore = time.monotonic()
        kwokctl("snapshot", "restore", "--path", snap)
        restore_s = time.monotonic() - t_restore
        ready(time.monotonic() + CLI_DEADLINE_S)
        restored_running_s = all_running(client, saved, time.monotonic() + CLI_DEADLINE_S)
        snapshot_s = time.monotonic() - t
        m_end = scrape(run)
        if m_end["kwok_patch_errors_total"]:
            raise AssertionError(f"{m_end['kwok_patch_errors_total']} patch errors after the restore")
        client.close()
        launches_b, caps_b = stopped()
        t = time.monotonic()
        kwokctl("delete", "cluster")
        delete_s = time.monotonic() - t
        if os.path.exists(wd) or any(_alive(p) for p in seen_pids):
            raise AssertionError(f"delete cluster left {wd} or a process of {sorted(seen_pids)}")
        tls = kwokctl_tls_arm(cli_run, env, here, extra)
    except BaseException:
        # leave no process behind
        for argv in (("stop", "cluster"), ("delete", "cluster")):
            try:
                kwokctl(*argv, timeout=120)
            except (AssertionError, OSError, subprocess.SubprocessError) as e:
                log(f"kwokctl cleanup ({argv[0]}): {e}")
        raise
    phase_s = time.monotonic() - t_phase
    if len(caps_b) != 1:
        raise AssertionError(f"the controller's capacities {caps_b}: want one [nodes, pods]")
    check_eng = ClusterEngine(FakeKube(), check_cfg)  # not started: its rules and lanes
    caps, shape_ms, shape_plain_ms, shape_wire_ms = engine_shape_check(
        torch, check_eng, rearm=True, states=lane_states(np, check_eng, caps_b[0], shards=1))
    log(f"kernel at the kwok-controller's capacities {caps} with the Stage rules: checked; "
        f"kernel {shape_ms:.4f} ms, plain {shape_plain_ms:.3f} ms, wire D2H {shape_wire_ms:.4f} ms")
    # last, so a rehearsal on the CPU (plain kernel, no launches) runs
    # every other check first
    if launches_a <= 0 or launches_b <= 0:
        raise AssertionError(f"the kwok-controller launched the tick kernel {launches_a} "
                             f"and {launches_b} times")
    report = load["report"]
    return {
        **report,
        "kwok_cpu_s_per_1000_pods": per_1000(report["window_kwok_process_cpu_s"],
                                             report["pods"]),
        "pump_requests": summed(m, "kwok_pump_requests_total"),
        "cli_phase_pods_per_s": cli_run["create_to_running_pods_per_s"],
        "pods_per_s_vs_cli": (report["create_to_running_pods_per_s"]
                              / cli_run["create_to_running_pods_per_s"]),
        "create_s": create_s, "controller_ready_s": controller_ready_s,
        "kubectl_get_pods_s": kubectl_s, "kubectl_names": len(listed),
        "stop_s": stop_s, "restart_ready_s": restart_ready_s,
        "more_pods": KWOKCTL_MORE_PODS, "more_pods_running_s": more_s,
        "snapshot_pods": saved, "snapshot_save_restore_running_s": snapshot_s,
        "snapshot_save_s": save_s, "snapshot_restore_s": restore_s,
        "running_after_restore_s": restored_running_s,
        "cluster_delete_s": delete_s, "phase_s": phase_s,
        "watch_relists": m_end["kwok_watch_relists_total"],
        "ticks": m["kwok_ticks_total"], "tick_dispatch_spans": dispatch_spans,
        "kernel_launches": launches_a + launches_b,
        "launches_by_incarnation": [launches_a, launches_b],
        "controller_capacities": [caps_a, caps_b],
        "capacities": caps, "kernel_ms_at_capacities": shape_ms,
        "plain_ms_at_capacities": shape_plain_ms,
        "wire_d2h_ms_at_capacities": shape_wire_ms,
        "bound_ms_at_capacities": byte_bound_ms(caps),
        "tls_arm": tls,
    }


def kwokctl_tls_arm(cli_run, env: dict, here: str, extra: str) -> dict:
    """The kwokctl phase's secure arm (see the module docstring, phase
    14): `kwokctl create cluster --runtime mock --secure-port true` in the
    plain run's environment, KWOKCTL_TLS_NODES nodes and KWOKCTL_TLS_PODS
    pods over mTLS, the controller on the card in a process of its own."""
    import ssl

    import numpy as np
    import torch

    from kwok_tpu_torch.config.ctl import KwokctlConfiguration
    from kwok_tpu_torch.config.types import first_of, load_documents
    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.edge.mockserver import FakeKube
    from kwok_tpu_torch.engine import ClusterEngine

    wd = os.path.join(env["KWOK_WORKDIR"], "clusters", KWOKCTL_TLS_NAME)
    kwokctl = kwokctl_cli(KWOKCTL_TLS_NAME, env, here)

    def pids() -> list:
        d = os.path.join(wd, "pids")
        return [int(open(os.path.join(d, f)).read()) for f in os.listdir(d)]

    seen_pids: set = set()
    t_arm = time.monotonic()
    try:
        kwokctl("create", "cluster", "--runtime", "mock", "--secure-port", "true",
                "--wait", "120s", "--config", extra)
        create_s = time.monotonic() - t_arm
        seen_pids |= set(pids())
        kubeconfig = os.path.join(wd, "kubeconfig.yaml")
        with open(kubeconfig) as f:
            url = json.load(f)["clusters"][0]["cluster"]["server"]
        with open(os.path.join(wd, "bin", "kube-apiserver")) as f:
            shim = f.read()
        if not url.startswith("https://") or "kwok_tpu_torch.edge.mockserver" not in shim:
            raise AssertionError(f"the secure cluster serves {url} from {shim[:200]!r}")
        no_cert = ssl.create_default_context()
        no_cert.check_hostname = False
        no_cert.verify_mode = ssl.CERT_NONE
        try:
            urllib.request.urlopen(url + "/healthz", context=no_cert, timeout=10).read()
        except OSError:
            pass
        else:
            raise AssertionError("the secure port answered a request without a client certificate")
        opts = first_of(load_documents(os.path.join(wd, "kwok.yaml")), KwokctlConfiguration).options
        base = f"http://127.0.0.1:{opts.kwokControllerPort}"
        with open(os.path.join(wd, "cmdline", "kwok-controller")) as f:
            check_cfg = controller_config(f.read().split("\x00")[1:])
        deadline = time.monotonic() + CLI_DEADLINE_S
        while http_get(base + "/readyz")[0] != 200:
            if time.monotonic() > deadline:
                raise AssertionError("the secure cluster's kwok-controller never became ready: "
                                     + kwokctl("logs", "kwok-controller")[-2000:])
            time.sleep(POLL_S)
        proc, _span = spawn_creator(url, "nodes", KWOKCTL_TLS_NODES, kubeconfig=kubeconfig)
        join_creator(proc, deadline)
        proc, span = spawn_creator(url, "pods", KWOKCTL_TLS_PODS, nodes=KWOKCTL_TLS_NODES,
                                   kubeconfig=kubeconfig)
        join_creator(proc, deadline)
        client = HttpKubeClient.from_kubeconfig(kubeconfig)
        try:
            while True:
                pods = client.list("pods")
                if len(pods) == KWOKCTL_TLS_PODS and all(map(running, pods)):
                    t_running = time.time()
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"{sum(map(running, pods))} of {KWOKCTL_TLS_PODS} "
                                         "pods Running on the secure cluster")
                time.sleep(POLL_S)
        finally:
            client.close()
        if len({p["status"]["podIP"] for p in pods}) != KWOKCTL_TLS_PODS:
            raise AssertionError("pod IPs are not distinct on the secure cluster")
        t = time.monotonic()
        listed = kwokctl("kubectl", "get", "pods", "-A", "-o", "name").split()
        kubectl_s = time.monotonic() - t
        if len(listed) != KWOKCTL_TLS_PODS or not all(n.startswith("pod/") for n in listed):
            raise AssertionError(f"kwokctl kubectl over mTLS: {len(listed)} names")
        before = pids()
        kwokctl("stop", "cluster")
        if any(_alive(p) for p in before):
            raise AssertionError(f"stop cluster (secure) left a process alive: {before}")
        found = KWOKCTL_STOPPED.search(kwokctl("logs", "kwok-controller"))
        failed = KWOKCTL_TLS_FAILED.search(kwokctl("logs", "kube-apiserver"))
        if found is None or failed is None:
            raise AssertionError("the secure cluster's logs lack the controller's or the "
                                 "mock's stop line")
        launches, caps_run = int(found.group(1)), json.loads(found.group(2))
        kwokctl("delete", "cluster")
        if os.path.exists(wd) or any(_alive(p) for p in seen_pids):
            raise AssertionError(f"delete cluster (secure) left {wd} or a process")
    except BaseException:
        for argv in (("stop", "cluster"), ("delete", "cluster")):
            try:
                kwokctl(*argv, timeout=120)
            except (AssertionError, OSError, subprocess.SubprocessError) as e:
                log(f"kwokctl cleanup (secure, {argv[0]}): {e}")
        raise
    arm_s = time.monotonic() - t_arm
    if len(caps_run) != 1:
        raise AssertionError(f"the secure controller's capacities {caps_run}")
    check_eng = ClusterEngine(FakeKube(), check_cfg)
    caps, shape_ms, shape_plain_ms, _wire = engine_shape_check(
        torch, check_eng, rearm=True, states=lane_states(np, check_eng, caps_run[0], shards=1))
    if launches <= 0:
        raise AssertionError(f"the secure cluster's kwok-controller launched {launches} times")
    pods_per_s = KWOKCTL_TLS_PODS / (t_running - span[0])
    out = {
        "nodes": KWOKCTL_TLS_NODES, "pods": KWOKCTL_TLS_PODS, "arm_s": arm_s,
        "create_s": create_s, "create_to_running_pods_per_s": pods_per_s,
        "pods_per_s_vs_cli": pods_per_s / cli_run["create_to_running_pods_per_s"],
        "kubectl_get_pods_s": kubectl_s, "tls_handshakes_failed": int(failed.group(1)),
        "kernel_launches": launches, "capacities": caps,
        "kernel_ms_at_capacities": shape_ms, "plain_ms_at_capacities": shape_plain_ms,
    }
    log(f"kwokctl secure arm: {json.dumps(out)}")
    return out


def main() -> int:
    t_main = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; nothing to run")
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "kwok_tpu_torch")):
        log("chip_smoke: kwok_tpu_torch/ is not beside this script")
        return 2
    import numpy as np

    from kwok_tpu_torch.ops import cuda_tick

    from kwok_tpu_torch import graft, native

    import sass_bound

    print(card_line(), flush=True)
    # g++ (the native library, the native mock apiserver) and nvcc (the
    # tick kernel), all at once; the phases before the first HTTP one
    # need no apiserver, so its build is joined only there
    t0 = time.perf_counter()
    native_build: dict = {}

    def build(key, fn):
        native_build[key] = fn()
        native_build[key + "_s"] = time.perf_counter() - t0

    builders = [threading.Thread(target=build, args=("lib", native.load), name="g++ library"),
                threading.Thread(target=build, args=("apiserver", native.apiserver_binary),
                                 name="g++ apiserver")]
    for b in builders:
        b.start()
    cuda_tick.tick_steps.library()
    build_s = time.perf_counter() - t0
    builders[0].join()
    print(f"build: nvcc {cuda_tick.NVCC_FLAGS[1]} tick.cu in {build_s:.2f} s", flush=True)
    log(cuda_tick.tick_steps.build_log)
    if native_build.get("lib") is None:
        raise AssertionError("the native library did not build (see the WARNING above)")
    print(f"build: g++ {' '.join(native.CXX_FLAGS)} native library in {native_build['lib_s']:.2f} s",
          flush=True)

    def apiserver_built() -> None:
        """Join the apiserver's build; no fallback to the Python mock: a
        phase that should measure kwok against the native server must not
        quietly run another one."""
        global APISERVER
        builders[1].join()
        APISERVER = native_build.get("apiserver")
        if APISERVER is None:
            log(native.apiserver_build_log)
            raise AssertionError("the native mock apiserver did not build (see the WARNING above)")
        print(f"build: g++ {' '.join(native.APISERVER_FLAGS)} native apiserver in "
              f"{native_build['apiserver_s']:.2f} s", flush=True)

    phase_s: dict = {"build": time.perf_counter() - t0}
    t = time.monotonic()
    # the operation bound's counts: the substep loop's shortest path in the
    # build's SASS (sass_bound.py), per entry
    sass = sass_bound.substep_counts(sass_bound.disassemble(cuda_tick.tick_steps.library_path))
    print("sass: " + json.dumps({k: {"loop": v["loop"], "body_instructions": v["body_instructions"],
                                     "path": v["path"]} for k, v in sass.items()}), flush=True)
    configs, max_abs_err = kernel_phase(torch, np, sass)
    phase_s["kernel"] = time.monotonic() - t
    t = time.monotonic()
    graft_cfg = graft_phase(torch, np, sass)
    phase_s["graft"] = time.monotonic() - t
    configs.append(graft_cfg)
    max_abs_err = max(max_abs_err, graft_cfg["max_abs_err"])
    for c in configs:
        print(json.dumps({"kernel_config": c}), flush=True)
    print(f"graft ({graft.ROWS} pod rows, chaos rules, K=1): kernel {graft_cfg['ms']:.4f} ms, "
          f"bound {graft_cfg['bound_ms']:.5f} ms ({graft_cfg['bound_by']}), plain "
          f"{graft_cfg['plain_ms']:.3f} ms, {graft_cfg['launches']} launches, pack_wire "
          f"{graft_cfg['pack_wire_host_ms_while_busy']:.3f} ms on the host while the card "
          f"was busy ({card_line()})", flush=True)
    from kwok_tpu_torch.config.types import resolve_drain_shards

    def timed(name: str, fn, *args, **sizes):
        """Run one phase (under ``sized(**sizes)`` when sizes are given),
        keep its wall seconds in phase_s and print its result."""
        t = time.monotonic()
        if sizes:
            with sized(**sizes):
                out = fn(*args)
        else:
            out = fn(*args)
        phase_s[name] = time.monotonic() - t
        print(json.dumps({name: out}), flush=True)
        return out

    engine = timed("engine", engine_phase)
    n_lanes = resolve_drain_shards(0)
    print(f"lanes: {n_lanes} (cpu_count {os.cpu_count()})", flush=True)
    lanes_run = timed("lanes_engine", engine_phase, n_lanes)
    restart = timed("restart", restart_phase)
    t = time.monotonic()
    apiserver_built()
    phase_s["apiserver_wait"] = time.monotonic() - t
    cli_run = timed("cli", cli_phase)
    traced = timed("trace", trace_phase, cli_run, CLI_PODS=TRACE_PODS)
    py_mock = timed("cli_python_mock", lambda: cli_phase(mock="python"),
                    CLI_NODES=PY_MOCK_NODES, CLI_PODS=PY_MOCK_PODS)
    ab_off = timed("ingest_ab_off", lambda: cli_phase(native_off=True), CLI_PODS=AB_OFF_PODS)
    watch = timed("watch", watch_phase, cli_run)
    procs = timed("procs", procs_phase, cli_run, CLI_PODS=HALF_PODS)
    chaos = timed("chaos", chaos_phase, cli_run, CLI_PODS=HALF_PODS)
    drift = timed("drift", drift_phase, cli_run)
    cni_run = timed("cni", cni_phase, cli_run, CLI_PODS=HALF_PODS)
    ha = timed("ha", ha_phase, cli_run, restart)
    fed = timed("federation", fed_phase, cli_run)
    mesh = timed("mesh", mesh_phase)
    kwokctl_run = timed("kwokctl", kwokctl_phase, cli_run)
    print(f"phase seconds: {json.dumps(phase_s)}; since main began {time.monotonic() - t_main:.1f} s",
          flush=True)
    card = card_line()
    print(f"engine: {engine['create_to_running_pods_per_s']:.1f} pods/s with 1 lane, "
          f"{lanes_run['create_to_running_pods_per_s']:.1f} pods/s with {n_lanes} lanes; "
          f"fused kernel {lanes_run['kernel_ms_at_capacities']:.4f} ms, whole dispatch "
          f"{lanes_run['dispatch_ms_at_capacities']:.4f} ms at the stacked "
          f"{lanes_run['capacities']} ({card})", flush=True)
    print(f"restart: recovery {restart['restart_recovery_seconds']:.3f} s, "
          f"{restart['refined']} rows refined, checkpoint {restart['checkpoint_bytes']} B, "
          f"snapshot {restart['snapshot_s']:.4f} s, write {restart['write_s']:.4f} s ({card})",
          flush=True)
    print(f"cli ({n_lanes} lanes): {cli_run['create_to_running_pods_per_s']:.1f} pods/s create->Running, "
          f"{cli_run['status_patches_per_s']:.1f} status patches/s, "
          f"tick thread {cli_run['tick_thread_s']:.2f} s, kernel "
          f"{cli_run['kernel_ms_at_capacities']:.4f} ms at {cli_run['capacities']}, "
          f"kwok CPU {cli_run['kwok_cpu_s_per_1000_pods']:.2f} s per 1,000 pods, "
          f"{cli_run['native']['partitioned_events']:.0f} events partitioned natively, "
          f"{cli_run['native']['pump_requests']:.0f} requests pumped ({card})",
          flush=True)
    http_phases = (("cli", cli_run), ("trace", traced), ("cli_python_mock", py_mock),
                   ("ingest_ab_off", ab_off), ("watch", watch), ("procs", procs),
                   ("cni", cni_run), ("federation", fed), ("kwokctl", kwokctl_run))
    for name, r in http_phases:
        print(f"{name}: {r['mock']} mock, {r['create_to_running_pods_per_s']:.1f} pods/s "
              f"create->Running ({r['pods']} pods), creator {r['pod_create_s']:.2f} s, kwok CPU "
              f"{r['kwok_cpu_s_per_1000_pods']:.3f} s and mock CPU "
              f"{r['mock_cpu_s_per_1000_pods']:.3f} s per 1,000 pods, watch terminations "
              f"{r['watch_terminations']}, kwok_watch_relists_total {r['watch_relists']:.0f} "
              f"({card})", flush=True)
    print(f"cli, native mock against the Python mock: "
          f"{cli_run['create_to_running_pods_per_s'] / py_mock['create_to_running_pods_per_s']:.3f}x "
          f"the pods/s, mock CPU {cli_run['mock_cpu_s_per_1000_pods']:.3f} against "
          f"{py_mock['mock_cpu_s_per_1000_pods']:.3f} s per 1,000 pods ({card})", flush=True)
    for arm, r in (("native", cli_run), ("KWOK_TPU_NATIVE=0", ab_off)):
        print(f"native A/B, {arm}: {r['create_to_running_pods_per_s']:.1f} pods/s "
              f"create->Running ({r['pods']} pods), kwok CPU {r['window_kwok_process_cpu_s']:.2f} s "
              f"({r['kwok_cpu_s_per_1000_pods']:.2f} per 1,000 pods), mock CPU "
              f"{r['window_mock_cpu_s']:.2f} s, lanes' drain {sum(r['lane_drain_s']):.2f} s, "
              f"emit {sum(r['lane_emit_s']):.2f} s, "
              f"partitioned {r['native']['partitioned_events']:.0f}, pump requests "
              f"{r['native']['pump_requests']:.0f}, pump_send_seconds_sum "
              f"{r['native']['pump_send_s']:.3f} ({card})", flush=True)
    print(f"watch ({n_lanes} lanes): {watch['create_to_running_pods_per_s']:.1f} pods/s "
          f"create->Running, {watch['cuts']} cuts ({watch['cuts_during_flood']} during the flood), "
          f"resume_s median {watch['resume_s_median']:.4f} max {watch['resume_s_max']:.4f}, "
          f"relist_s {watch['relist_s']:.3f} ({watch['relist_objects']} pods listed), "
          f"re-lists {watch['relists_after_start']}, "
          f"bookmarks {watch['bookmarks']:.0f}, stale_rv {watch['stale_rv_rejects']:.0f}, "
          f"throttle {watch['client_throttle_seconds']:.1f} s, kwok CPU "
          f"{watch['kwok_cpu_s_per_1000_pods']:.2f} s per 1,000 pods ({card})", flush=True)
    print(f"procs ({n_lanes} lane processes): {procs['create_to_running_pods_per_s']:.1f} pods/s "
          f"create->Running, {procs['status_patches_per_s']:.1f} status patches/s, respawn "
          f"{procs['respawn_s']:.2f} s, {procs['kernel_launches']} lane launches, kernel "
          f"{procs['kernel_ms_at_capacities']:.4f} ms at {procs['capacities']}, kwok CPU "
          f"{procs['kwok_cpu_s_per_1000_pods']:.2f} s and lanes' CPU "
          f"{procs['lanes_cpu_s_per_1000_pods']:.2f} s per 1,000 pods ({card})",
          flush=True)

    print(f"federation ({FED_MEMBERS} members, {len(fed['groups'])} groups): "
          f"{fed['create_to_running_pods_per_s']:.1f} pods/s create->Running, "
          f"{fed['status_patches_per_s']:.1f} status patches/s, ready "
          f"{fed['main_to_ready_s']:.2f} s, kwok CPU {fed['window_kwok_process_cpu_s']:.1f} s "
          f"({fed['kwok_cpu_s_per_1000_pods']:.2f} per 1,000 pods), "
          f"mocks CPU {fed['window_mocks_cpu_s']:.1f} s, "
          + ", ".join(f"group {g['members']}: {g['dispatches']} dispatches at {g['capacities']}, "
                      f"kernel {g['kernel_ms_at_capacities']:.4f} ms" for g in fed["groups"])
          + f" ({card})", flush=True)

    me, mc = mesh["engine"], mesh["cli"]
    print(f"mesh ({MESH_SHARDS} shards on {', '.join(me['shards'])}): "
          + ", ".join(f"{c['rules']} K={c['substeps']} split {c['split_ms']:.4f} ms against "
                      f"unsplit {c['unsplit_ms']:.4f} ms (bound {c['bound_ms']:.4f})"
                      for c in mesh["kernel"])
          + f", wires byte-identical; engine {me['create_to_running_pods_per_s']:.1f} pods/s "
          f"with {me['lanes']} lanes, shard launches {me['shard_launches']}, kernel "
          f"{me['kernel_ms_at_capacities']:.4f} ms at {me['capacities']}; --use-mesh true "
          f"({', '.join(mc['shards'])}) {mc['create_to_running_pods_per_s']:.1f} pods/s "
          f"({mc['pods']} pods), {mc['kernel_launches']} launches ({card})", flush=True)
    cl, cf, cp = chaos["lanes"], chaos["federation"], chaos["procs"]
    print(f"chaos ({n_lanes} lanes, {CHAOS_SPEC}): {cl['create_to_running_pods_per_s']:.1f} "
          f"pods/s create->Running against the cli phase's {cl['cli_phase_pods_per_s']:.1f} "
          f"({cl['pods_per_s_vs_cli']:.3f}x), kills {cl['kills']}, restarts {cl['restarts']}, "
          f"restart latency max {max(cl['restart_latency_s'] or [0.0]):.3f} s, faults "
          f"{cl['faults']}, kwok_watch_relists_total {cl['watch_relists']:.0f}; federation "
          f"({cf['members']} members): {cf['create_to_running_pods_per_s']:.1f} pods/s, "
          f"{cf['kills']} kills, {cf['member_restarts']}; process lanes: "
          f"{cp['create_to_running_pods_per_s']:.1f} pods/s, faults {cp['faults']}, "
          f"{cp['desc_rejects']} ({card})", flush=True)
    dl, dp = drift["lanes"], drift["procs"]
    print(f"drift ({n_lanes} lanes, {DRIFT_SPEC}, --audit-interval {DRIFT_AUDIT_S}): "
          f"{dl['create_to_running_pods_per_s']:.1f} pods/s create->Running against the cli "
          f"phase's {dl['cli_phase_pods_per_s']:.1f}; faults {dl['faults_injected']}, wire "
          f"rejects {dl['wire_rejects']:.0f}; audit passes {dl['audit_passes']}, pass s median "
          f"{dl['audit_pass_s_median']:.4f} max {dl['audit_pass_s_max']:.4f}; detected in the "
          f"storm {dl['detected_in_storm']}, seeded {dl['detected_seeded']}; repair s "
          f"{dl['repair_s']}; re-lists {dl['watch_relists']:.0f}, slow terminations "
          f"{dl['slow_terminations']}; rv rewinds {dl['rv_rewinds']:.0f} "
          f"{dl['rv_rewind_rows']}; peak lane queue {dl['peak_lane_queue_items']} items, "
          f"{dl['relists_routed']} re-lists routed, {dl['objects_per_relist']:.1f} objects "
          f"each; heal->Running {dl['heal_to_running_s']:.1f} s; process lanes: "
          f"{dp['create_to_running_pods_per_s']:.1f} "
          f"pods/s, detected {dp['detected']}, repaired {dp['repaired_total']:.0f} in "
          f"{dp['repair_s']:.2f} s, {dp['kernel_launches']} lane launches ({card})", flush=True)
    print(f"cni ({n_lanes} lanes, KWOK_TPU_CNI_PROVIDER={cni_run['provider']}): "
          f"{cni_run['create_to_running_pods_per_s']:.1f} pods/s create->Running against the "
          f"cli phase's {cni_run['cli_phase_pods_per_s']:.1f} "
          f"({cni_run['pods_per_s_vs_cli']:.3f}x), kwok CPU "
          f"{cni_run['kwok_cpu_s_per_1000_pods']:.2f} s per 1,000 pods against "
          f"{cni_run['cli_phase_kwok_cpu_s_per_1000_pods']:.2f}, {cni_run['cni_setups']} "
          f"setups, {cni_run['cni_removes']} removes ({card})", flush=True)
    for arm in ("sigkill", "sigstop"):
        h = ha[arm]
        se = h["standby_end"]
        print(f"ha ({arm}, {n_lanes} lanes, --lease-duration {HA_LEASE_S}): RTO "
              f"{h['rto_s']:.3f} s (kill until the standby's /readyz 200) against a cold "
              f"restart's {h['restart_recovery_s']:.3f} s, kwok_ha_takeover_seconds "
              f"{se['takeover_s']:.3f}, rows refined {se.get('refined')} (matched "
              f"{se.get('matched')}), {h['running_at_kill']} pods Running at the kill, "
              f"{h['create_to_running_pods_per_s']:.1f} pods/s against the cli phase's "
              f"{h['cli_phase_pods_per_s']:.1f}, Running patches {h['running_patches']}, "
              f"standby launches {h['exits']['b']['launches']}"
              + (f"; zombie {h['zombie']}, deposed {h['depose_s']:.3f} s after SIGCONT"
                 if arm == "sigstop" else "") + f" ({card})", flush=True)
    k = kwokctl_run
    print(f"kwokctl (--runtime mock, {n_lanes} lanes in its kwok-controller): "
          f"{k['create_to_running_pods_per_s']:.1f} pods/s create->Running against the cli "
          f"phase's {k['cli_phase_pods_per_s']:.1f} ({k['pods_per_s_vs_cli']:.3f}x); create "
          f"{k['create_s']:.2f} s, controller ready {k['controller_ready_s']:.2f} s; kubectl "
          f"get pods -A -o name through the built-in shim {k['kubectl_get_pods_s']:.2f} s "
          f"({k['kubectl_names']} names); stop {k['stop_s']}, start to ready "
          f"{k['restart_ready_s']:.2f} s, {k['more_pods']} more pods Running in "
          f"{k['more_pods_running_s']:.2f} s; snapshot save {k['snapshot_save_s']:.2f} s, "
          f"restore {k['snapshot_restore_s']:.2f} s, all Running again "
          f"{k['running_after_restore_s']:.2f} s later; delete {k['cluster_delete_s']:.2f} s; "
          f"launches {k['launches_by_incarnation']} at {k['controller_capacities']}; "
          f"phase {k['phase_s']:.1f} s ({card})", flush=True)
    tp, tw = traced["profile"], traced["profile_window"]
    print(f"trace ({n_lanes} lanes, profiled ticks {tw['ticks'][0]}-{tw['ticks'][1]} on "
          f"{tw['thread']}, {tw['wall_s']:.3f} s): device busy share {tp['busy_share']:.6f}, "
          f"idle share {tp['idle_share']:.6f} ({tp['device_events']} device events, "
          f"{tp['device_busy_us']:.1f} us busy); tick_kernel events {tp['kernel_events']} for "
          f"{tw['launches']} launches, sum {tp['kernel_us_sum']:.1f} us, median "
          f"{tp['kernel_us_median']:.3f} us; profile {tp['trace_bytes']} B; spans recorded "
          f"{traced['spans_recorded']} ({traced['sampled_ingest_to_patch']} sampled "
          f"ingest->patch in the dump); {traced['create_to_running_pods_per_s']:.1f} pods/s "
          f"against the cli phase's {traced['cli_phase_pods_per_s']:.1f} "
          f"({traced['pods_per_s_vs_cli']:.3f}x) ({card})", flush=True)
    wp = traced["window_placement"]

    def rate(d: dict) -> str:
        return (f"{d['dispatches']} dispatches, {d['per_s']:.2f}/s, first at "
                f"+{d['first_at_s'] or 0.0:.3f} s, largest gap {d['gap_max_s'] or 0.0:.3f} s "
                f"at +{d['gap_max_at_s'] or 0.0:.3f} s")

    print(f"trace window: profiled from +{wp['start_after_first_create_s']:.3f} s to "
          f"+{wp['stop_after_first_create_s']:.3f} s after the first pod create, in a "
          f"{wp['flood_s']:.3f} s create->Running window ({wp['overlap_with_flood_s']:.3f} s "
          f"shared); profiler start {wp['start_call_s']:.3f} s and stop+export "
          f"{wp['stop_export_s']:.3f} s on the tick thread; flood: trace phase "
          f"{rate(wp['flood'])} (before the window {rate(wp['flood_before_window'])}; "
          f"in it {rate(wp['window'])}), cli phase {rate(wp['cli_phase_flood'])} ({card})",
          flush=True)

    main_cfg = next(c for c in configs if c["rules"] == "default" and c["substeps"] == 1)
    kernels = {"kernels": [{
        "name": "tick_dispatch",
        "route": "cuda",
        "source": "kwok_tpu_torch/csrc/tick.cu",
        "replaces": "kwok_tpu/ops/pallas_tick.py:407",
        "launches": (engine["kernel_launches"] + lanes_run["kernel_launches"]
                     + restart["kernel_launches"] + cli_run["kernel_launches"]
                     + traced["kernel_launches"]
                     + py_mock["kernel_launches"] + ab_off["kernel_launches"]
                     + watch["kernel_launches"] + procs["kernel_launches"]
                     + chaos["kernel_launches"] + drift["kernel_launches"]
                     + cni_run["kernel_launches"] + ha["kernel_launches"]
                     + fed["kernel_launches"] + mesh["kernel_launches"]
                     + kwokctl_run["kernel_launches"]
                     + kwokctl_run["tls_arm"]["kernel_launches"]),
        "max_abs_err": max_abs_err,
        "ms": main_cfg["ms"],
        "plain_ms": main_cfg["plain_ms"],
        "bound_ms": main_cfg["bound_ms"],
        "bound_by": main_cfg["bound_by"],
        "library_ms": None,
        "dispatch_ms": main_cfg["dispatch_ms"],
        "wire_d2h_ms": main_cfg["wire_d2h_ms"],
        "shape": f"{POD_ROWS} pod + {NODE_ROWS} node rows, default rules, K=1: the fused "
                 "launch and its epilogue (dispatch_ms: with the wire's D2H copy)",
        "launches_by_phase": {
            "engine": engine["kernel_launches"], "lanes": lanes_run["kernel_launches"],
            "restart": restart["kernel_launches"], "cli": cli_run["kernel_launches"],
            "trace": traced["kernel_launches"],
            "cli_python_mock": py_mock["kernel_launches"],
            "ingest_ab_off": ab_off["kernel_launches"], "watch": watch["kernel_launches"],
            "procs": procs["kernel_launches"], "chaos": chaos["kernel_launches"],
            "drift": drift["kernel_launches"], "cni": cni_run["kernel_launches"],
            "ha": ha["kernel_launches"], "federation": fed["kernel_launches"],
            "mesh_engine": mesh["engine"]["kernel_launches"],
            "mesh_cli": mesh["cli"]["kernel_launches"],
            "kwokctl": kwokctl_run["kernel_launches"],
            "kwokctl_tls": kwokctl_run["tls_arm"]["kernel_launches"],
        },
        "watch_capacities": watch["capacities"],
        "watch_ms": watch["kernel_ms_at_capacities"],
        "watch_plain_ms": watch["plain_ms_at_capacities"],
        "watch_bound_ms": watch["bound_ms_at_capacities"],
        "stacked_capacities": lanes_run["capacities"],
        "stacked_ms": lanes_run["kernel_ms_at_capacities"],
        "stacked_plain_ms": lanes_run["plain_ms_at_capacities"],
        "stacked_dispatch_ms": lanes_run["dispatch_ms_at_capacities"],
        "stacked_bound_ms": byte_bound_ms(lanes_run["capacities"]),
        "lane_process_capacities": procs["capacities"],
        "lane_process_bound_ms": procs["bound_ms_at_capacities"],
        "lane_process_ms": procs["kernel_ms_at_capacities"],
        "lane_process_plain_ms": procs["plain_ms_at_capacities"],
        "kwokctl_capacities": kwokctl_run["capacities"],
        "kwokctl_ms": kwokctl_run["kernel_ms_at_capacities"],
        "kwokctl_plain_ms": kwokctl_run["plain_ms_at_capacities"],
        "kwokctl_bound_ms": kwokctl_run["bound_ms_at_capacities"],
        "federation_groups": [
            {k: g[k] for k in ("members", "capacities", "dispatches", "kernel_ms_at_capacities",
                               "plain_ms_at_capacities", "bound_ms_at_capacities")}
            for g in fed["groups"]],
        "configs": configs,
        # the row split (mesh phase): split against unsplit dispatches,
        # and the launches per shard on its engine and entry-point legs
        "split_configs": mesh["kernel"],
        "mesh_engine_shards": mesh["engine"]["shards"],
        "mesh_engine_shard_launches": mesh["engine"]["shard_launches"],
        "mesh_engine_capacities": mesh["engine"]["capacities"],
        "mesh_engine_ms": mesh["engine"]["kernel_ms_at_capacities"],
        "mesh_engine_plain_ms": mesh["engine"]["plain_ms_at_capacities"],
        "mesh_engine_bound_ms": byte_bound_ms(mesh["engine"]["capacities"]),
        "mesh_cli_shards": mesh["cli"]["shards"],
        "mesh_cli_shard_launches": mesh["cli"]["shard_launches"],
        "mesh_cli_capacities": mesh["cli"]["capacities"],
        "mesh_cli_ms": mesh["cli"]["kernel_ms_at_capacities"],
        "mesh_cli_plain_ms": mesh["cli"]["plain_ms_at_capacities"],
        "mesh_cli_bound_ms": mesh["cli"]["bound_ms_at_capacities"],
        "sass_substep_path": sass["fused_tick_kernel"]["path"],
    }, {
        "name": "tick",
        "route": "cuda",
        "source": "kwok_tpu_torch/csrc/tick.cu",
        "replaces": "kwok_tpu/ops/pallas_tick.py:407",
        # the per-kind entry's main path is the graft twin's step
        "launches": graft_cfg["launches"],
        "max_abs_err": max_abs_err,
        "ms": main_cfg["per_kind_ms"],
        "plain_ms": main_cfg["per_kind_plain_ms"],
        "bound_ms": main_cfg["per_kind_bound_ms"],
        "bound_by": main_cfg["per_kind_bound_by"],
        "library_ms": None,
        "shape": f"{POD_ROWS} pod + {NODE_ROWS} node rows, default rules, K=1: one launch "
                 "per kind, masks as bytes",
        "graft_rows": graft_cfg["rows"],
        "graft_ms": graft_cfg["ms"],
        "graft_plain_ms": graft_cfg["plain_ms"],
        "graft_bound_ms": graft_cfg["bound_ms"],
        "sass_substep_path": sass["tick_kernel"]["path"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
