"""The kwok CLI on the port's engine (mirrors kwok_tpu.kwok.cli, itself
after pkg/kwok/cmd/root.go + cmd/kwok/main.go).

    python -m kwok_tpu_torch.kwok --master http://HOST:PORT \\
        --manage-all-nodes true --config stages.yaml

The flag surface, defaults and precedence are the reference's: config file
< KWOK_* env < flags (config/flags.go:34-63 pattern: file values seed the
flag defaults, so unset flags inherit them). The engine runs on the CUDA
device unless ``KWOK_TPU_PLATFORM=cpu``; without a card and without that
variable the CLI exits non-zero with the engine's error.

A flag value that would switch on a subsystem the port does not have yet
exits non-zero with a message naming the ROADMAP item that brings it; so
do its KWOK_TPU_* environment twins. ``--drain-shards`` (default 0 =
auto) runs the threaded lanes, and with ``--lane-procs true`` (or
KWOK_LANE_PROCS=true) each lane is a process of its own
(``engine/proclanes.py``; it needs the HTTP ``--master``);
``--checkpoint-dir`` (or KWOK_TPU_CHECKPOINT_DIR) turns on crash-durable
checkpoints, and ``--faults`` (or KWOK_FAULTS; KWOK_TPU_FAULTS is the
engine's fallback) the deterministic fault plane
(``resilience/faults.py``). A comma-separated ``--master`` runs a federation
(``engine/federation.py``): one member engine per apiserver, with
per-member Stage files from the positional ``--member-config`` flags.
``--trace-dump`` (or KWOK_TPU_TRACE) writes the span trace at stop,
``--trace-sample-every`` sets the ingest->patch span sampling,
``--profile-dir`` writes a torch.profiler trace of ticks 2-102, and
KWOK_TPU_FLIGHT_DIR saves the apiserver's flight recorder on a fresh
degradation.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from kwok_tpu_torch.config.stages import Stage, stages_to_rules
from kwok_tpu_torch.config.types import (
    KwokConfiguration,
    apply_env_overrides,
    first_of,
    load_documents,
    parse_bool,
    resolve_drain_shards,
)
from kwok_tpu_torch.models.lifecycle import ResourceKind

logger = logging.getLogger("kwok_tpu_torch.kwok")

DEFAULT_CONFIG = os.path.expanduser("~/.kwok/kwok.yaml")


def build_parser(defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kwok",
        description="GPU fake kubelet: simulates node/pod lifecycle against "
        "a kube-apiserver with a batched device tick engine (PyTorch, "
        "CUDA).",
    )
    o = defaults
    p.add_argument("--config", default=DEFAULT_CONFIG,
                   help="config file (multi-doc YAML, or JSON documents "
                   "separated by '---' lines; kwok.x-k8s.io/v1alpha1)")
    p.add_argument("--kubeconfig", default=os.environ.get("KUBECONFIG", ""))
    p.add_argument("--master", default="",
                   help="apiserver URL override (like kube --master); a "
                   "comma-separated list federates N apiservers onto one "
                   "stacked tick")
    p.add_argument("--member-config", action="append", default=[],
                   help="per-member kwok config for --master federation, "
                   "repeatable and positional: the i-th flag applies to "
                   "the i-th master (its Stage documents replace that "
                   "member's lifecycle rules). An empty value inherits "
                   "--config. Fewer flags than masters: the remainder "
                   "inherit.")
    p.add_argument("--cidr", default=o.cidr)
    p.add_argument("--node-ip", default=o.nodeIP)
    p.add_argument("--manage-all-nodes", type=_bool, default=o.manageAllNodes)
    p.add_argument("--manage-nodes-with-annotation-selector",
                   default=o.manageNodesWithAnnotationSelector)
    p.add_argument("--manage-nodes-with-label-selector",
                   default=o.manageNodesWithLabelSelector)
    p.add_argument("--disregard-status-with-annotation-selector",
                   default=o.disregardStatusWithAnnotationSelector)
    p.add_argument("--disregard-status-with-label-selector",
                   default=o.disregardStatusWithLabelSelector)
    p.add_argument("--server-address", default=o.serverAddress,
                   help="healthz/metrics address, e.g. 0.0.0.0:10247")
    p.add_argument("--enable-cni", type=_bool, default=o.enableCNI,
                   help="CNI pod networking (refused when true: ROADMAP "
                   "item 14)")
    p.add_argument("--tick-interval", type=float, default=o.tickInterval)
    p.add_argument("--tick-substeps", type=int, default=o.tickSubsteps,
                   help="simulated ticks fused into one device dispatch")
    p.add_argument("--heartbeat-interval", type=float, default=o.heartbeatInterval)
    p.add_argument("--parallelism", type=int, default=o.parallelism)
    p.add_argument("--drain-shards", type=int, default=o.drainShards,
                   help="hash-partitioned host lanes (0 = auto: cpu_count "
                   "capped by --max-drain-shards)")
    p.add_argument("--max-drain-shards", type=int, default=o.maxDrainShards,
                   help="cap on the AUTO --drain-shards lane count "
                   "(0 = built-in default)")
    p.add_argument("--lane-procs", type=_bool, default=o.laneProcs,
                   help="run each drain shard as a worker process, each "
                   "with its own single-lane engine on the device")
    p.add_argument("--initial-capacity", type=int, default=o.initialCapacity)
    p.add_argument("--use-mesh", type=_bool, default=o.useMesh,
                   help="shard cluster state across all local devices "
                   "(refused when true: ROADMAP item 9b)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of ticks 2-102 here "
                   "(a lane process writes <dir>/lane<i>)")
    p.add_argument("--trace-dump", default="",
                   help="write the engine's span trace (Chrome trace-event "
                   "JSON, same document as /debug/trace) here at stop; "
                   "KWOK_TPU_TRACE=<path> works too")
    p.add_argument("--trace-sample-every", type=int, default=256,
                   help="sample 1-in-N watch events for end-to-end "
                   "ingest->patch spans (0 disables)")
    p.add_argument("--faults", default=o.faults,
                   help="deterministic fault-injection spec (e.g. "
                   "'seed=42;pump.drop=0.02;worker.kill=kwok-lane*:2.0'); "
                   "KWOK_TPU_FAULTS works too; empty = disabled (zero "
                   "overhead), 'off' = disabled even under the env var")
    p.add_argument("--shed-queue-depth", type=int, default=o.shedQueueDepth,
                   help="shed routed events when a lane queue is deeper "
                   "than this; 0 = never shed")
    p.add_argument("--worker-restart-budget", type=int,
                   default=o.workerRestartBudget,
                   help="watchdog: max restarts of one crashed worker "
                   "(a watch thread, a lane worker, a lane process) per "
                   "--worker-restart-window; past it the engine degrades")
    p.add_argument("--worker-restart-window", type=float,
                   default=o.workerRestartWindow,
                   help="watchdog restart-budget window in seconds")
    p.add_argument("--checkpoint-dir", default=o.checkpointDir,
                   help="crash-durable restarts: checkpoint the device "
                   "timer state here; KWOK_TPU_CHECKPOINT_DIR works too")
    p.add_argument("--checkpoint-interval", type=float,
                   default=o.checkpointInterval,
                   help="checkpoint cadence in seconds")
    p.add_argument("--audit-interval", type=float,
                   default=o.auditInterval,
                   help="anti-entropy auditor cadence in seconds: a paced "
                   "background pass diffs a budgeted window of apiserver "
                   "objects against engine rows by (uid, rv, phase), "
                   "classifies silent divergence (missed-event / "
                   "double-apply / stale-row / ghost-row) and repairs "
                   "per row via re-ingest (docs/resilience.md). "
                   "KWOK_TPU_AUDIT_INTERVAL works too; 0 = off "
                   "(no thread, no LISTs)")
    p.add_argument("--ha-role", default=o.haRole,
                   choices=["", "off", "primary", "standby"],
                   help="warm-standby HA (refused as primary or standby: "
                   "ROADMAP item 12). KWOK_HA_ROLE works too")
    p.add_argument("--ha-identity", default=o.haIdentity,
                   help="lease holderIdentity under HA")
    p.add_argument("--lease-name", default=o.leaseName,
                   help="coordination.k8s.io Lease object name of the HA "
                   "pair")
    p.add_argument("--lease-namespace", default=o.leaseNamespace)
    p.add_argument("--lease-duration", type=float,
                   default=o.leaseDuration,
                   help="lease TTL seconds")
    p.add_argument("--lease-renew-interval", type=float,
                   default=o.leaseRenewInterval,
                   help="leader renew cadence; 0 = lease-duration/3")
    p.add_argument("--drain-deadline", type=float,
                   default=o.drainDeadline,
                   help="SIGTERM graceful-drain bound: flush in-flight "
                   "ticks and patches within this many seconds, else "
                   "force-exit nonzero (a second SIGTERM force-exits "
                   "immediately)")
    from kwok_tpu_torch import log

    log.add_flags(p)
    return p


_bool = parse_bool


def refusals(args, masters: list[str]) -> list[str]:
    """Why this invocation asks for a subsystem the port does not have yet,
    one message per flag (or KWOK_TPU_* twin), each naming the ROADMAP item
    that brings it. Empty when the engine can run it."""
    out = []
    if args.use_mesh:
        out.append("--use-mesh true splits rows across cards (a "
                   "federation's stacked state too): ROADMAP item 9b")
    if args.ha_role in ("primary", "standby"):
        out.append(f"--ha-role {args.ha_role} needs HA and the lease "
                   "calls: ROADMAP item 12")
    if args.enable_cni:
        out.append("--enable-cni true needs CNI: ROADMAP item 14")
    return out


def check_federation(args, masters: list[str]) -> None:
    """The reference's own refusals around federation (exit non-zero
    before any network wait): ``--member-config`` without several
    masters, more of them than masters, or naming a missing file; and
    the single-cluster topologies ``--lane-procs`` and ``--ha-role``
    (or their environment twins) with several masters."""
    if args.member_config and len(masters) < 2:
        raise SystemExit(
            "--member-config is a federation flag: it needs a multi-master "
            "--master list (use --config for a single cluster)"
        )
    if len(args.member_config) > len(masters):
        raise SystemExit(
            f"--member-config given {len(args.member_config)} times "
            f"for {len(masters)} masters"
        )
    for mc in args.member_config:
        if mc and not os.path.exists(mc):
            # a typo'd path must not silently fall back to default rules
            raise SystemExit(f"--member-config {mc}: no such file")
    if len(masters) > 1 and args.lane_procs:
        raise SystemExit(
            "--lane-procs is a single-cluster flag; federation "
            "(multi-master --master) shards the host per member"
        )
    if len(masters) > 1 and args.ha_role not in ("", "off"):
        raise SystemExit(
            "--ha-role is a single-cluster flag; federation "
            "(multi-master --master) has its own member failover"
        )


def member_configs(args, stages: list[Stage], n_masters: int, device: str):
    """One EngineConfig per master from the positional --member-config
    files (an empty or missing entry inherits --config's Stages), or None
    without the flag. A file with no Stage documents is an error."""
    if not args.member_config:
        return None
    out = []
    for i in range(n_masters):
        path = args.member_config[i] if i < len(args.member_config) else ""
        mstages = stages
        if path:
            mstages = [d for d in load_documents(path) if isinstance(d, Stage)]
            if not mstages:
                # a file with no Stage docs (typo'd kind/apiVersion) must
                # not silently run the default rules
                raise SystemExit(f"--member-config {path}: no Stage documents")
        out.append(_engine_config(args, mstages, device))
    return out


def engine_device() -> str:
    """The engine's torch device from KWOK_TPU_PLATFORM: "cpu" when it is
    cpu, else (unset, cuda or gpu) "cuda"."""
    plat = os.environ.get("KWOK_TPU_PLATFORM", "").strip().lower()
    if plat in ("", "cuda", "gpu"):
        return "cuda"
    if plat == "cpu":
        return "cpu"
    raise SystemExit(
        f"KWOK_TPU_PLATFORM={plat!r}: this engine runs on cuda or cpu"
    )


def _engine_config(args, stages: list[Stage], device: str):
    from kwok_tpu_torch.engine import EngineConfig

    return EngineConfig(
        drain_shards=resolve_drain_shards(
            args.drain_shards, args.max_drain_shards
        ),
        max_drain_shards=args.max_drain_shards,
        manage_all_nodes=args.manage_all_nodes,
        manage_nodes_with_annotation_selector=args.manage_nodes_with_annotation_selector,
        manage_nodes_with_label_selector=args.manage_nodes_with_label_selector,
        disregard_status_with_annotation_selector=args.disregard_status_with_annotation_selector,
        disregard_status_with_label_selector=args.disregard_status_with_label_selector,
        cidr=args.cidr,
        node_ip=args.node_ip,
        tick_interval=args.tick_interval,
        tick_substeps=args.tick_substeps,
        heartbeat_interval=args.heartbeat_interval,
        parallelism=args.parallelism,
        initial_capacity=args.initial_capacity,
        lane_procs=args.lane_procs,
        worker_restart_budget=args.worker_restart_budget,
        worker_restart_window=args.worker_restart_window,
        shed_queue_depth=args.shed_queue_depth,
        faults=args.faults,
        audit_interval=args.audit_interval,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_interval=args.checkpoint_interval,
        profile_dir=args.profile_dir,
        trace_dump=args.trace_dump,
        trace_sample_every=args.trace_sample_every,
        node_rules=stages_to_rules(stages, ResourceKind.NODE),
        pod_rules=stages_to_rules(stages, ResourceKind.POD),
        device=device,
    )


def make_signal_handler(stop: threading.Event, force_exit=None):
    """First SIGTERM/SIGINT: set the stop event and let the graceful
    drain run (flush in-flight ticks and patches). A SECOND SIGTERM means
    the operator wants out NOW: force-exit 130 without waiting on the
    drain. Factored out so the escalation is unit testable without a
    subprocess."""
    force = force_exit if force_exit is not None else os._exit
    state = {"terms": 0}

    def handler(sig, frame=None):
        if sig == signal.SIGTERM:
            state["terms"] += 1
            if state["terms"] >= 2:
                force(130)
                return
        stop.set()

    return handler


def stop_with_deadline(
    stop_fns, deadline: float, force_exit=None
) -> None:
    """Run the shutdown callables under a wall-clock bound: a drain that
    wedges past ``deadline`` seconds force-exits nonzero instead of
    hanging the process manager's TERM->KILL escalation window."""
    force = force_exit if force_exit is not None else os._exit
    timer = threading.Timer(max(0.1, deadline), force, args=(3,))
    timer.daemon = True
    timer.start()
    try:
        for fn in stop_fns:
            fn()
    finally:
        timer.cancel()


def wait_for_apiserver(client, deadline_seconds: float = 120.0) -> None:
    """Exponential backoff until the apiserver answers (root.go:99-120)."""
    delay = 0.5
    deadline = time.time() + deadline_seconds
    while True:
        try:
            client.list("nodes", field_selector=None, label_selector=None)
            return
        except Exception as e:
            if time.time() > deadline:
                raise RuntimeError(f"apiserver not reachable: {e}") from e
            logger.info("waiting for apiserver: %s", e)
            time.sleep(delay)
            delay = min(delay * 2, 10)


def main(argv=None, stop_event: threading.Event | None = None) -> int:
    # pre-parse --config (flags.go:34-63: config parsed before cobra)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=DEFAULT_CONFIG)
    pre_args, _ = pre.parse_known_args(argv)
    docs = load_documents(pre_args.config)
    conf = first_of(docs, KwokConfiguration) or KwokConfiguration()
    apply_env_overrides(conf.options)
    stages = [d for d in docs if isinstance(d, Stage)]

    args = build_parser(conf.options).parse_args(argv)
    from kwok_tpu_torch import log

    log.setup(args.verbosity)

    from kwok_tpu_torch.edge.httpclient import HttpKubeClient
    from kwok_tpu_torch.engine import ClusterEngine, FederatedEngine
    from kwok_tpu_torch.kwok.server import EngineServer

    # --master takes a comma-separated list: N apiservers federate onto
    # one stacked tick per rule-set group (engine/federation.py)
    masters = [m.strip() for m in (args.master or "").split(",") if m.strip()]
    # validate BEFORE any network waiting: misconfiguration must fail fast
    check_federation(args, masters)
    refused = refusals(args, masters)
    if refused:
        raise SystemExit("not supported by kwok_tpu_torch yet: " + "; ".join(refused))
    device = engine_device()
    clients = [
        HttpKubeClient.from_kubeconfig(args.kubeconfig or None, m)
        for m in masters or [None]
    ]
    try:
        if len(clients) > 1:
            engine = FederatedEngine(
                clients, _engine_config(args, stages, device),
                member_configs=member_configs(args, stages, len(clients), device),
            )
        else:
            engine = ClusterEngine(clients[0], _engine_config(args, stages, device))
    except (RuntimeError, ValueError) as e:
        # no card for a cuda engine, or an invalid configuration (process
        # lanes without an HTTP apiserver among them)
        raise SystemExit(f"kwok: {e}") from e
    # wait for every member concurrently: startup is bounded by ONE
    # backoff window, not N sequential ones
    with ThreadPoolExecutor(max_workers=len(clients)) as pool:
        list(pool.map(wait_for_apiserver, clients))
    # liveness first, readiness after: the server comes up immediately (so
    # /healthz and /livez probes never kill the process mid-warm-up) but
    # /readyz answers 503 until the engine has built its kernel and
    # ingested the first full re-list of both kinds
    server = None
    if args.server_address:
        server = EngineServer(engine, args.server_address)
        server.start()
        # the bound port: --server-address HOST:0 takes a free one
        logger.info("serving healthz/metrics on %s (port %d)", args.server_address, server.port)

    engine.start()
    logger.info("engine started on %s (managing %s)", engine.device,
                "all nodes" if args.manage_all_nodes else "selected nodes")

    stop = stop_event or threading.Event()
    handler = make_signal_handler(stop)
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, handler)
        except ValueError:
            pass  # not main thread (tests)
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        # SIGTERM graceful drain: engine.stop() flushes in-flight device
        # ticks and patch jobs; the whole drain is bounded by
        # --drain-deadline (and a second SIGTERM skips it outright — see
        # make_signal_handler)
        stop_fns = [engine.stop]
        if server:
            stop_fns.append(server.stop)
        stop_with_deadline(stop_fns, args.drain_deadline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
