"""Cluster bring-up harness: the terraform/RUNNING-equivalent rig.

The reference deploys its control plane with ~3,100 lines of terraform
(mem_etcd systemd unit, k3s servers, dist-scheduler Deployments, kwok
StatefulSet, load-gen VMs — reference SURVEY.md §2.4); the experiment
recipe is a tfvars file per cluster shape.  Here the same topology is a
declarative ``ClusterSpec`` and one supervisor:

- the native store runs as a real subprocess serving the etcd v3 wire
  (store/server_main.py), WAL modes and no-write prefixes configured the
  way the reference's systemd unit passes --wal-default /
  --wal-no-write-prefix (etcd.tf:1-38);
- ``coordinators`` HACoordinator replicas (leader + standbys) and
  ``kwok_groups`` KWOK controllers connect over gRPC via RemoteStore —
  every component crosses a process boundary exactly as deployed;
- the webhook intake server fronts the current leader.

``tick(now)`` advances the whole cluster one step (tick-driven like the
KWOK simulator, so integration tests control time); ``run_pods`` is the
make_pods + wait-for-binds experiment loop (reference README.adoc:732-738).

The port's own copy of ``k8s1m_tpu/cluster/harness.py``.  Its children are
the port's: the store is ``python -m k8s1m_tpu_torch.store.server_main``
and each tier replica ``python -m k8s1m_tpu_torch.store.watch_cache``,
started from the repository root whatever the caller's directory.  The
coordinators run on ``ClusterSpec.device`` (default cuda; a missing card
raises before any child starts); ``backend="xla"`` (the default, as in
the JAX harness) is the scan path, ``"pallas"`` the fused kernel.  Nodes
and pods go to the store one put each, as in the JAX harness.
``tick_seconds`` splits the host seconds of every tick among the
coordinators, the KWOK controllers and compaction.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

from k8s1m_tpu_torch.cluster.kwok_controller import KwokController
from k8s1m_tpu_torch.config import PodSpec, TableSpec
from k8s1m_tpu_torch.control.coordinator import Coordinator
from k8s1m_tpu_torch.control.leader import HACoordinator, LeaderElector
from k8s1m_tpu_torch.control.objects import encode_node, encode_pod, node_key, pod_key
from k8s1m_tpu_torch.control.webhook import WebhookServer
from k8s1m_tpu_torch.device import resolve_device
from k8s1m_tpu_torch.plugins.registry import Profile
from k8s1m_tpu_torch.snapshot.pod_encoding import PodInfo
from k8s1m_tpu_torch.store.remote import RemoteStore
from k8s1m_tpu_torch.store.server_main import child_env
from k8s1m_tpu_torch.tools.make_nodes import build_node


@dataclasses.dataclass
class ClusterSpec:
    """One cluster shape — the tfvars equivalent."""

    nodes: int = 1000
    kwok_groups: int = 2
    coordinators: int = 2          # leader + standbys
    # >1 switches the control plane to a scheduler shard set
    # (control/shardset.py): N cooperating coordinators splitting the pod
    # stream by FNV hash and the node space by ownership masks, with a
    # lease-elected rebalancer — the reference's 256-replica scale-out
    # topology (schedulerset.go, leader_activities.go).  ``coordinators``
    # is ignored in shard mode.
    shards: int = 1
    # Minimum simulated seconds between rebalance rounds (the reference's
    # 30 s floor, leader_activities.go).
    rebalance_interval_s: float = 30.0
    zones: int = 8
    regions: int = 4
    # When set, every subprocess's stderr is shipped into ONE
    # timestamped JSONL under this directory (obs/logship.py — the
    # fluent-bit role at rig scale, reference terraform/kubernetes/
    # fluentbit.tf).  None = inherit stderr (test-friendly default).
    log_dir: str | None = None
    wal_mode: str = "buffered"
    # The reference skips the WAL for the lease-flood prefix
    # (--wal-no-write-prefix; leases are 100K writes/s of pure churn).
    no_write_prefixes: tuple[str, ...] = ("/registry/leases/",)
    # Periodic MVCC compaction, the apiserver's --etcd-compaction-interval
    # (the reference tunes it to 20m, server.tf:28-39; simulated seconds).
    compact_interval_s: float = 1200.0
    # Deploy the watch-cache fan-out tier (store/watch_cache.py) between
    # the store and the node-simulation consumers: KWOK controllers —
    # the stand-ins for the reference's kubelets, whose 18M watches hit
    # the apiserver's watch cache and never reach etcd
    # (README.adoc:410-416) — connect to the tier; writes proxy through.
    watch_cache: bool = False
    watch_cache_index: str = "hash"
    # Tier replica count: N watch-cache processes over the ONE store,
    # consumers assigned round-robin — the reference's 11-apiserver
    # fleet behind haproxy SRV round-robin (reference
    # README.adoc:721-723, terraform/k8s-server/server.tf:230-251).
    tier_replicas: int = 1
    # Serve the webhook intake over HTTPS with rig-provisioned certs
    # (cluster/certs.py — the reference's terraform-provisioned webhook
    # TLS, dist-scheduler.tf:713-740, webhook.go:33-35).
    webhook_tls: bool = False
    # Secure the watch-cache tier like the apiserver it stands in for:
    # rig-CA TLS + bearer-token auth on every RPC; the KWOK/kubelet
    # consumers behind the tier connect with the CA + token.  Requires
    # watch_cache=True.
    tier_tls: bool = False
    # Deterministic fault injection (faultline/): a FaultPlan
    # (or its JSON/dict form) installed process-wide for the in-process
    # components (coordinators, shard members, RemoteStore clients) and
    # inherited by the tier subprocesses via K8S1M_FAULT_PLAN — the
    # tfvars-level switch that turns a cluster shape into a drill.
    fault_plan: "object | None" = None
    table: TableSpec | None = None
    pod_batch: int = 256
    profile: Profile = dataclasses.field(
        default_factory=lambda: Profile(topology_spread=0, interpod_affinity=0)
    )
    chunk: int = 1 << 10
    backend: str = "xla"
    # Device-mesh execution (parallel/mesh.py): "DPxSP", "auto", or None
    # (None defers to K8S1M_MESH; unset = single-device).  The mesh and
    # the scheduler shard set are different scale-out axes — shard mode
    # pins its members single-device (compose meshes across processes).
    mesh: str | None = None
    # Where the coordinators' tables and waves live: "cuda" (default) or
    # "cpu"; asking for cuda without a card raises (device.py).
    device: str = "cuda"

    def __post_init__(self):
        # Fail before any subprocess is spawned: a bad value raised from
        # Cluster.__init__ after the store Popen would leak the server
        # until interpreter exit.
        if self.watch_cache_index not in ("hash", "btree"):
            raise ValueError(
                f"watch_cache_index must be hash|btree, "
                f"got {self.watch_cache_index!r}"
            )
        if self.tier_tls and not self.watch_cache:
            raise ValueError("tier_tls requires watch_cache=True")
        if self.tier_replicas < 1:
            raise ValueError("tier_replicas must be >= 1")
        if self.tier_replicas > 1 and not self.watch_cache:
            raise ValueError("tier_replicas > 1 requires watch_cache=True")
        if self.mesh and self.shards > 1:
            raise ValueError(
                "mesh and shards > 1 are different scale-out axes; "
                "compose them across processes, not inside one spec"
            )

    def table_spec(self) -> TableSpec:
        if self.table is not None:
            return self.table
        cap = 1 << max(6, (self.nodes - 1).bit_length())
        return TableSpec(
            max_nodes=cap,
            max_zones=max(16, self.zones + 1),
            max_regions=max(8, self.regions + 1),
        )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(
    port: int, timeout_s: float = 30.0,
    proc: subprocess.Popen | None = None,
) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"server for :{port} exited rc={proc.returncode} "
                "before listening"
            )
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            # Deadline-bounded port-readiness poll, not an op retry.
            time.sleep(0.05)  # graftlint: disable=retry-through-policy
    raise TimeoutError(f"store server did not listen on :{port}")


class Cluster:
    """Running instance of a ClusterSpec."""

    def __init__(self, spec: ClusterSpec, *, wal_dir: str | None = None):
        self.spec = spec
        self.device = resolve_device(spec.device)  # before any child starts
        self.wal_dir = wal_dir or tempfile.mkdtemp(prefix="k8s1m-wal-")
        # Fault plan: installed for in-process components, exported to
        # every subprocess this harness spawns (tier replicas read it at
        # their first injection hook).
        self.fault_plan = None
        self._root, self._sub_env = child_env()
        if spec.fault_plan is not None:
            from k8s1m_tpu_torch.faultline import FaultPlan, install_plan

            fp = spec.fault_plan
            if not isinstance(fp, FaultPlan):
                fp = FaultPlan.from_json(fp)
            self.fault_plan = fp
            install_plan(fp)
            self._sub_env["K8S1M_FAULT_PLAN"] = fp.to_json()
        # Everything shutdown() touches exists before anything can fail,
        # so a partial-init crash still tears the subprocess down cleanly
        # at exit.
        self._server = None
        self.log_shipper = None
        if spec.log_dir:
            from k8s1m_tpu_torch.obs.logship import LogShipper

            self.log_shipper = LogShipper(spec.log_dir)
            self.log_shipper.attach_logging()
        self._clients: list[RemoteStore] = []
        self.coordinators: list[HACoordinator] = []
        self.kwoks: list[KwokController] = []
        self.webhook: WebhookServer | None = None
        self.port = _free_port()
        cmd = [
            sys.executable, "-m", "k8s1m_tpu_torch.store.server_main",
            "--host", "127.0.0.1", "--port", str(self.port),
            "--metrics-port", "0",
            "--wal-dir", self.wal_dir, "--wal-default", spec.wal_mode,
        ]
        for p in spec.no_write_prefixes:
            cmd += ["--wal-no-write-prefix", p]
        self._server = self._spawn(cmd, "store")
        self._tier = None
        self.tier_port: int | None = None
        atexit.register(self.shutdown)
        wait_for_port(self.port, proc=self._server)

        # Rig TLS chain, shared by whichever endpoints are secured
        # (webhook https intake, tier wire) — the terraform-provisioned
        # cert chain role (cluster/certs.py).
        self.certs = None
        self.tier_token: str | None = None
        if spec.webhook_tls or spec.tier_tls:
            from k8s1m_tpu_torch.cluster.certs import provision

            self.certs = provision(f"{self.wal_dir}/certs")

        self._tiers: list = []
        self.tier_ports: list[int] = []
        self._tier_rr = 0
        if spec.watch_cache:
            if spec.tier_tls:
                import secrets

                self.tier_token = secrets.token_hex(16)
            for i in range(spec.tier_replicas):
                port = _free_port()
                tier_cmd = [
                    sys.executable, "-m", "k8s1m_tpu_torch.store.watch_cache",
                    "--upstream", f"127.0.0.1:{self.port}",
                    "--host", "127.0.0.1", "--port", str(port),
                    "--prefix", "/registry/",
                    "--index", spec.watch_cache_index,
                ]
                if spec.tier_tls:
                    tier_cmd += [
                        "--tls-cert", self.certs.cert_pem,
                        "--tls-key", self.certs.key_pem,
                        "--auth-token", self.tier_token,
                    ]
                self._tiers.append(self._spawn(tier_cmd, f"tier-{i}"))
                self.tier_ports.append(port)
            self._tier = self._tiers[0]
            self.tier_port = self.tier_ports[0]
            # Port bind happens after cache priming (watch_cache.py), so
            # this doubles as the primed signal.  Priming walks the whole
            # store, so the wait must scale with it (1M nodes would blow
            # the default 30s).
            prime_timeout = 30.0 + spec.nodes / 5000.0
            for proc, port in zip(self._tiers, self.tier_ports):
                wait_for_port(port, timeout_s=prime_timeout, proc=proc)

        self.shard_members: list = []
        self._rebalancer = None
        self._reb_elector = None
        if spec.shards > 1:
            from k8s1m_tpu_torch.control.shardset import Rebalancer, ShardMember

            for i in range(spec.shards):
                store = self._client()
                coord = Coordinator(
                    store, spec.table_spec(), PodSpec(batch=spec.pod_batch),
                    spec.profile, chunk=spec.chunk, backend=spec.backend,
                    with_constraints=spec.profile.topology_spread > 0
                    or spec.profile.interpod_affinity > 0,
                    # Shard members scale out by row masks; "none" also
                    # shuts out a K8S1M_MESH inherited from the rig env.
                    mesh="none", device=self.device,
                )
                self.shard_members.append(
                    ShardMember(store, coord, i, spec.shards)
                )
            for m in self.shard_members:
                m.start(now=0.0)
            # The rebalancer runs wherever the control-plane lease lands
            # (any member's host view works — they all track every node).
            self._reb_elector = LeaderElector(
                self._client(), "rebalancer", name="shardset-rebalancer"
            )
            self._rebalancer = Rebalancer(
                self._clients[0], self.shard_members[0].coordinator.host,
                spec.shards, min_interval=spec.rebalance_interval_s,
            )
        else:
            for i in range(spec.coordinators):
                store = self._client()
                self.coordinators.append(
                    HACoordinator(
                        LeaderElector(store, f"coordinator-{i}"),
                        lambda store=store: Coordinator(
                            store, spec.table_spec(),
                            PodSpec(batch=spec.pod_batch),
                            spec.profile, chunk=spec.chunk,
                            backend=spec.backend,
                            with_constraints=spec.profile.topology_spread > 0
                            or spec.profile.interpod_affinity > 0,
                            # spec.mesh ("DPxSP"/"auto"/None->K8S1M_MESH)
                            # is the tfvars-level production-mesh switch.
                            mesh=spec.mesh, device=self.device,
                        ),
                    )
                )
        self.kwoks = [
            KwokController(self._kwok_client(), group=g)
            for g in range(spec.kwok_groups)
        ]
        ssl_context = (
            self.certs.server_context() if spec.webhook_tls else None
        )
        self.webhook = WebhookServer(
            self._webhook_sink, ssl_context=ssl_context
        ).start()
        self._kwok_bootstrapped = False
        self.now = 0.0  # simulated time, monotonic across run_pods calls
        self._next_compact = spec.compact_interval_s
        self._compact_target = 0
        # Host seconds of every tick so far, by the component that took them.
        self.tick_seconds = {"coordinator": 0.0, "kwok": 0.0, "compaction": 0.0}

    # ---- plumbing ------------------------------------------------------

    def _client(
        self, port: int | None = None, *, secure: bool = False
    ) -> RemoteStore:
        c = RemoteStore(
            f"127.0.0.1:{port if port is not None else self.port}",
            ca_pem=self.certs.ca_pem if secure else None,
            token=self.tier_token if secure else None,
        )
        self._clients.append(c)
        return c

    def _kwok_client(self) -> RemoteStore:
        """Node-simulation consumers connect through the watch-cache tier
        when deployed (the kubelet→apiserver edge); else to the store.
        With ``tier_tls`` they authenticate like kubelets to an
        apiserver: rig-CA TLS + bearer token.  With ``tier_replicas`` > 1
        consumers are assigned round-robin over the LIVE replicas (the
        haproxy SRV round-robin role; a killed replica is skipped the
        way haproxy pulls a dead backend)."""
        port = self.tier_port
        if len(self.tier_ports) > 1:
            for _ in range(len(self.tier_ports)):
                i = self._tier_rr % len(self.tier_ports)
                self._tier_rr += 1
                if self._tiers[i].poll() is None:
                    port = self.tier_ports[i]
                    break
        return self._client(port, secure=self.spec.tier_tls)

    def kill_tier_replica(self, i: int) -> None:
        """Crash drill: SIGKILL tier replica ``i``.  Consumers connected
        to it lose their watches (stream reset -> resync, the same
        contract as a store watch cancel); new consumers round-robin
        over the survivors."""
        self._tiers[i].kill()
        self._tiers[i].wait()

    def _webhook_sink(self, obj: dict) -> None:
        if self.shard_members:
            # Route by the same FNV pod hash the members' intake filters
            # use (the reference webhook resolves GetTargetForScoring the
            # same way, schedulerset.go:130-143).
            from k8s1m_tpu_torch.control.shardset import pod_shard

            meta = obj.get("metadata", {})
            key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
            idx = pod_shard(key, len(self.shard_members))
            self.shard_members[idx].coordinator.submit_external(obj)
            return
        for ha in self.coordinators:
            if ha.elector.is_leader:
                ha.submit_external(obj)
                return

    @property
    def leader(self) -> HACoordinator | None:
        for ha in self.coordinators:
            if ha.elector.is_leader:
                return ha
        return None

    # ---- lifecycle -----------------------------------------------------

    def make_nodes(self, count: int | None = None) -> None:
        """Bulk-create KWOK nodes (make_nodes equivalent, in-harness)."""
        store = self._clients[0]
        n = count if count is not None else self.spec.nodes
        for i in range(n):
            node = build_node(
                i, zones=self.spec.zones, regions=self.spec.regions
            )
            node.labels["kwok-group"] = str(i % self.spec.kwok_groups)
            store.put(node_key(node.name), encode_node(node))

    def tick(self, now: float | None = None) -> dict:
        """Advance every component one step.  ``now=None`` advances the
        cluster's simulated clock by one second; an explicit ``now`` only
        moves it forward (time never rewinds across run_pods calls)."""
        self.now = self.now + 1.0 if now is None else max(self.now, now)
        now = self.now
        t0 = time.perf_counter()
        if not self._kwok_bootstrapped:
            for k in self.kwoks:
                k.bootstrap(now)
            self._kwok_bootstrapped = True
        t1 = time.perf_counter()
        bound = sum(ha.tick(now) for ha in self.coordinators)
        bound += sum(m.tick(now) for m in self.shard_members)
        if self._rebalancer is not None and self._reb_elector.tick(now):
            self._rebalancer.run_once(now)
        t2 = time.perf_counter()
        kwok = [k.tick(now) for k in self.kwoks]
        t3 = time.perf_counter()
        if now >= self._next_compact:
            # Windowed compaction like the apiserver's: compact away
            # history older than one full interval.
            self._next_compact = now + self.spec.compact_interval_s
            current = self._clients[0].current_revision
            target, self._compact_target = self._compact_target, current
            if 1 < target <= current:
                self._clients[0].compact(target)
        t4 = time.perf_counter()
        self.tick_seconds["coordinator"] += t2 - t1
        self.tick_seconds["kwok"] += (t1 - t0) + (t3 - t2)
        self.tick_seconds["compaction"] += t4 - t3
        return {
            "bound": bound,
            "leases_renewed": sum(s["renewed"] for s in kwok),
            "pods_started": sum(s["started"] for s in kwok),
        }

    _run_seq = 0

    def run_pods(
        self,
        count: int,
        *,
        max_ticks: int = 1000,
        tick_s: float = 1.0,
        via_webhook: bool = False,
        prefix: str | None = None,
    ) -> dict:
        """The make_pods experiment: create pods, tick until all bound and
        Running; returns timing/throughput stats (wall-clock based — this
        is the measurement loop, not the simulator).  Pod names get a
        per-run prefix: pod names are unique for the object's lifetime in
        Kubernetes, so runs must not reuse live names."""
        if prefix is None:
            Cluster._run_seq += 1
            prefix = f"bench{Cluster._run_seq}"
        store = self._clients[0]
        # Invariant across the loop; building it per request would charge
        # N cert parses to the measured window.
        tls_ctx = (
            self.certs.client_context() if self.spec.webhook_tls else None
        )
        t0 = time.perf_counter()
        for i in range(count):
            pod = encode_pod(
                PodInfo(f"{prefix}-{i}", cpu_milli=100, mem_kib=200 << 10)
            )
            if via_webhook:
                # Over real HTTP — the admission path under test is the
                # WebhookServer, not its sink function.
                review = {
                    "apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview",
                    "request": {"uid": f"{prefix}-{i}", "object": json.loads(pod)},
                }
                # Chain-verified when TLS is on: the client trusts only
                # the rig CA and checks the cert's 127.0.0.1 IP SAN.
                scheme = "https" if tls_ctx is not None else "http"
                req = urllib.request.Request(
                    f"{scheme}://127.0.0.1:{self.webhook.port}/validate",
                    data=json.dumps(review).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(
                    req, timeout=10, context=tls_ctx
                ) as resp:
                    assert json.loads(resp.read())["response"]["allowed"]
            store.put(pod_key("default", f"{prefix}-{i}"), pod)
        created_s = time.perf_counter() - t0

        bound = started = 0
        for _ in range(max_ticks):
            stats = self.tick(self.now + tick_s)
            bound += stats["bound"]
            started += stats["pods_started"]
            if bound >= count and started >= count:
                break
        total_s = time.perf_counter() - t0
        return {
            "pods": count,
            "prefix": prefix,
            "created_s": round(created_s, 3),
            "bound": bound,
            "running": started,
            "total_s": round(total_s, 3),
            "binds_per_sec": round(bound / total_s, 1),
        }

    def _ship(self, src: str):
        """stderr target for a subprocess: the log shipper's pipe when
        aggregation is on, else inherit."""
        return self.log_shipper.pipe(src) if self.log_shipper else None

    def _spawn(self, cmd: list, src: str) -> subprocess.Popen:
        """A child of the port from the repository root, its stderr
        shipped as ``src`` (its stdout, the port it prints, unread)."""
        return subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=self._ship(src),
            env=self._sub_env, cwd=self._root,
        )

    def _stop_server(self) -> None:
        self._server.terminate()
        try:
            self._server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._server.kill()
            self._server.wait()

    def restart_store(self) -> None:
        """Kill and restart the store server on the same port + WAL dir —
        the crash-recovery drill: WAL replay restores state, broken watch
        streams surface as dropped and every consumer relists."""
        cmd = self._server.args
        self._stop_server()
        self._server = self._spawn(cmd, "store")
        # WAL-skipped prefixes (leases) lower the replayed revision below
        # the pre-crash counter; a stale compaction target would then be
        # a future revision the store rejects.
        self._compact_target = 0
        wait_for_port(self.port)
        # Wait until every live watch stream has observed the break —
        # gRPC delivers it asynchronously (~100ms), while simulated ticks
        # can outrun wall time; a real cluster ticks in wall time, so the
        # drill should too.
        deadline = time.monotonic() + 5.0
        watchers = []
        for k in self.kwoks:
            watchers += [k._nodes_watch, k._pods_watch]
        for ha in self.coordinators:
            if ha.coord is not None:
                watchers += [ha.coord._nodes_watch, ha.coord._pods_watch]
        for w in watchers:
            while (
                w is not None and not w.canceled and not w.dropped
                and time.monotonic() < deadline
            ):
                time.sleep(0.02)

    def shutdown(self) -> None:
        if self._server is None:
            return
        if self.fault_plan is not None:
            # The injector is process-global: without this reset the
            # faulted cluster's plan would keep firing into whatever
            # cluster (or test) runs next in this process.
            from k8s1m_tpu_torch.faultline import install_plan

            install_plan(None)
        if self.webhook is not None:
            self.webhook.stop()
        for ha in self.coordinators:
            ha.stop()
        for m in self.shard_members:
            try:
                m.close()
            # Teardown ladder: one member's close must not strand the rest.
            except Exception:  # graftlint: disable=broad-except
                pass
        for k in self.kwoks:
            k.close()
        for c in self._clients:
            try:
                c.close()
            # Teardown ladder: one client's close must not strand the rest.
            except Exception:  # graftlint: disable=broad-except
                pass
        for tier in self._tiers:
            tier.terminate()
        for tier in self._tiers:
            try:
                tier.wait(timeout=10)
            except subprocess.TimeoutExpired:
                tier.kill()
                tier.wait()
        self._tiers = []
        self._tier = None
        self._stop_server()
        self._server = None
        if self.log_shipper is not None:
            # After the subprocesses exit: pipe readers only see EOF once
            # the last holder of the write fd is gone, so closing earlier
            # burns the join timeout and drops the store's final stderr
            # lines — the shutdown errors the shipper exists to capture.
            self.log_shipper.close()
            self.log_shipper = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
