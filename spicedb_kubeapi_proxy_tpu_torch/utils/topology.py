"""Shared process-fleet harness (the reference's utils/topology.py).

Every distributed measurement boots the same shape — N separate OS
processes (separate interpreter locks, event loops and WALs: the
deployment unit every scaling claim is about), optionally pinned to
fixed CPUs, gated on readiness, reaped on failure:

- `WorkerFleet`: stdio-protocol measurement workers.  Each worker
  prints `READY` after warm-up, runs one measured window per
  `RUN [json]` line on stdin answering `DONE <json>`, and exits on
  `EXIT`.  The fleet spawns them with taskset pinning and single-threaded
  host thread pools, and any member dying mid-boot or mid-window reaps
  the WHOLE fleet with an error naming the member — a half-dead fleet
  must never report numbers.
- `ProcessFleet`: real serving processes (fake kube apiserver, shard
  leaders, follower fan-out trees at depth D, the CLI router) with
  /readyz readiness gating, per-member log capture, chaos helpers
  (kill -9 a member mid-load), an orderly SIGTERM stop that reports
  each member's exit code, and teardown that reaps on failure.  The
  member roles live in this module's `__main__`; `spawn` takes any
  command line, so a caller can run the port's CLI as members.
- `cpu_pair_ceiling()`: this box's measured 2-process CPU scaling
  ceiling, recorded next to every scaling number so a throttled vCPU
  cannot be misread as a replication bottleneck.

The port's copy differs in two places.  `single_thread_env` pins only
the host thread pools (OMP, OpenBLAS, MKL): it sets nothing that hides
the card, so a member's device follows from its own endpoint URL.  The
role server takes that URL (`--endpoint`, default `embedded://`, the
reference's roles' endpoint).  Nothing here imports torch; the harness
is stdlib, so scripts import it before choosing a device.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional


class FleetError(RuntimeError):
    """A fleet member failed to boot, died mid-window, or missed its
    readiness deadline; the whole fleet has been reaped."""


# seconds a member that closed its output gets to exit before its death
# is reported without an exit code
EXIT_WAIT_S = 5.0


# -- process environment ------------------------------------------------------


def single_thread_env(extra: Optional[dict] = None) -> dict:
    """The pinned-worker environment: single-threaded host thread pools
    (OpenMP, which torch's CPU ops use, OpenBLAS and MKL).  Without this,
    one member's intra-op pool eats every local core and the 1-member
    baseline is already machine-saturated — the fleet would then measure
    contention, not scaling.  Nothing device-related is set: a member
    on `torch://` still sees the card."""
    env = dict(os.environ,
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    if extra:
        env.update(extra)
    return env


def pin_command(cmd: list, cpu: Optional[int],
                taskset: Optional[str] = None) -> list:
    """Prefix `cmd` with `taskset -c <cpu % ncores>` when pinning is
    requested and available (it is on every Linux CI box; the harness
    degrades to unpinned elsewhere rather than failing)."""
    if cpu is None:
        return cmd
    taskset = taskset if taskset is not None else shutil.which("taskset")
    if not taskset:
        return cmd
    # map through the ALLOWED cpu set, not plain cpu_count: on a
    # cgroup-restricted box the mask can be sparse (e.g. {0, 2}) and
    # `taskset -c` to a masked-out cpu is EINVAL, killing the member
    try:
        cpus = sorted(os.sched_getaffinity(0)) or [0]
    except (AttributeError, OSError):
        cpus = list(range(os.cpu_count() or 1))
    return [taskset, "-c", str(cpus[cpu % len(cpus)])] + cmd


def cpu_pair_ceiling(taskset: Optional[str] = None) -> float:
    """This box's measured 2-process CPU scaling ceiling: two pinned
    pure-python burners over one, same pinning as the fleet workers.
    Throttled or oversubscribed vCPUs cap well below 2.0 — no fleet
    scaling number can exceed this no matter how perfect the
    distribution layer is, so artifacts record it next to the raw
    scaling."""
    taskset = taskset if taskset is not None else shutil.which("taskset")
    burn = ("import time\nt0=time.time()\nn=0\n"
            "while time.time()-t0<1.5:\n"
            "    x=0\n"
            "    for i in range(100000):\n"
            "        x+=i*i\n"
            "    n+=1\n"
            "print(n)")

    def spawn(pin):
        return subprocess.Popen(
            pin_command([sys.executable, "-c", burn], pin, taskset),
            stdout=subprocess.PIPE, text=True)

    single = int(spawn(0).communicate(timeout=30)[0])
    pair = [spawn(0), spawn(1)]
    total = sum(int(p.communicate(timeout=30)[0]) for p in pair)
    return round(total / max(single, 1), 2)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http(method: str, url: str, user: str = "", body=None,
         timeout: float = 5.0, groups=(), headers: Optional[dict] = None):
    """Parent-side HTTP helper (urllib, header authn) shared by the
    scripts: -> (status, headers-dict, body-bytes)."""
    h = {"Accept": "application/json"}
    if user:
        h["X-Remote-User"] = user
    for g in groups:
        h["X-Remote-Group"] = g
    if headers:
        h.update(headers)
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        h["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=h, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def wait_http_ready(base: str, deadline_s: float,
                    want_degraded: bool = False) -> bytes:
    """Poll `base`/readyz until 200 (or degraded-but-200 when asked);
    raises AssertionError past the deadline.  The standalone flavor of
    ProcessFleet.wait_ready for callers that spawned a member
    themselves."""
    t0 = time.time()
    last = b""
    while time.time() - t0 < deadline_s:
        try:
            status, _, body = http("GET", base + "/readyz", timeout=2.0)
            last = body
            if status == 200 and (b"[!]" in body
                                  if want_degraded else True):
                return body
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(
        f"{base}/readyz not {'degraded' if want_degraded else 'ready'} "
        f"within {deadline_s}s (last: {last!r})")


# -- stdio-protocol measurement workers ---------------------------------------


@dataclass
class _Worker:
    label: str
    proc: subprocess.Popen


class WorkerFleet:
    """N stdio-protocol measurement workers under one lifecycle.

    Protocol: the worker prints `READY\\n` once warm;
    each `RUN\\n` or `RUN <json>\\n` on stdin runs one measured window
    and prints `DONE <json>\\n`; `EXIT\\n` (or EOF) quits.  stderr is
    inherited so worker diagnostics interleave with the parent's.

    Failure model: readiness and window collection detect a dead or
    wedged member (EOF / timeout), reap the WHOLE fleet, and raise
    FleetError naming the member — partial fleets never report."""

    def __init__(self, name: str = "fleet",
                 taskset: Optional[str] = None):
        self.name = name
        self.taskset = (taskset if taskset is not None
                        else shutil.which("taskset"))
        self.workers: list = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.shutdown()
        else:
            self.reap()

    def spawn(self, cmd: list, *, pin: Optional[int] = None,
              env: Optional[dict] = None, label: str = "") -> None:
        label = label or f"{self.name}-{len(self.workers)}"
        proc = subprocess.Popen(
            pin_command(list(cmd), pin, self.taskset),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env if env is not None else single_thread_env(),
            text=True, bufsize=1)
        self.workers.append(_Worker(label=label, proc=proc))

    # -- line plumbing -------------------------------------------------------

    def _fail(self, why: str) -> None:
        self.reap()
        raise FleetError(f"{self.name}: {why} — whole fleet reaped")

    def _readline(self, w: _Worker, timeout_s: float) -> str:
        """One line from the worker, bounded: EOF (member died) or a
        silent member past the deadline both fail the fleet."""
        deadline = time.time() + timeout_s
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                self._fail(f"member {w.label!r} silent for "
                           f"{timeout_s:.0f}s (pid {w.proc.pid})")
            # the pipe is line-buffered and the protocol strictly
            # request/response, so select on the raw fd never races a
            # line already sitting in the text-layer buffer
            ready, _, _ = select.select([w.proc.stdout], [], [],
                                        min(remaining, 1.0))
            if not ready:
                continue
            line = w.proc.stdout.readline()
            if not line:
                # EOF comes before the child is reaped: wait (bounded) for
                # its exit code, so that the message names it
                try:
                    rc = w.proc.wait(EXIT_WAIT_S)
                except subprocess.TimeoutExpired:
                    rc = None
                self._fail(f"member {w.label!r} died "
                           f"(exit {rc}) before responding")
            return line

    def wait_ready(self, timeout_s: float = 180.0) -> None:
        """Block until every member printed READY; a member crashing
        mid-boot (EOF before READY) reaps the whole fleet."""
        for w in self.workers:
            line = self._readline(w, timeout_s)
            if line.strip() != "READY":
                self._fail(f"member {w.label!r} said {line!r} "
                           f"instead of READY")

    def run_window(self, n: Optional[int] = None,
                   payloads: Optional[list] = None) -> list:
        """One measured window on the first `n` members (all by
        default): send every RUN first so the windows overlap in time
        (the point of a fleet measurement), then collect the DONE
        payloads in member order."""
        members = self.workers[:n] if n is not None else self.workers
        for i, w in enumerate(members):
            payload = payloads[i] if payloads is not None else None
            line = ("RUN\n" if payload is None
                    else "RUN " + json.dumps(payload) + "\n")
            try:
                w.proc.stdin.write(line)
                w.proc.stdin.flush()
            except OSError:
                self._fail(f"member {w.label!r} unwritable "
                           f"(exit {w.proc.poll()})")
        results = []
        for w in members:
            while True:
                line = self._readline(w, timeout_s=600.0)
                if line.startswith("DONE "):
                    results.append(json.loads(line[5:]))
                    break
        return results

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Orderly exit; stragglers are killed."""
        for w in self.workers:
            try:
                w.proc.stdin.write("EXIT\n")
                w.proc.stdin.flush()
            except OSError:
                pass
        for w in self.workers:
            try:
                w.proc.wait(timeout_s)
            except subprocess.TimeoutExpired:
                w.proc.kill()
        self.workers = []

    def reap(self) -> None:
        """Kill everything, unconditionally (the failure path)."""
        for w in self.workers:
            if w.proc.poll() is None:
                w.proc.kill()
        for w in self.workers:
            try:
                w.proc.wait(5)
            except subprocess.TimeoutExpired:
                pass
        self.workers = []


# -- real serving processes ---------------------------------------------------


@dataclass
class Member:
    name: str
    role: str
    tier: str
    url: str
    port: int
    proc: subprocess.Popen
    log_path: str
    data_dir: str = ""
    log_file: object = None


@dataclass
class FleetSpec:
    """Declarative shape for the standard topology: a fake kube
    apiserver, N shard leaders over embedded endpoints (each its own
    data dir + WAL), follower fan-out trees at depth D below leader 0,
    and optionally the CLI router fronting the leaders.

    `follower_levels` is members-per-level, e.g. (2, 6): 2 mid-tier
    followers replicating from the leader and re-serving the
    replication API (`--serve-replication` semantics), and 6 leaves
    distributed round-robin across the mids — an 8-follower 2-level
    tree."""
    schema_text: str
    rules_yaml: str
    shard_leaders: int = 1
    follower_levels: tuple = ()
    router: bool = True
    # what the router's --shard-leaders point at: "leaders" (write
    # scale-out shape) or "followers" (read fan-out shape: requests
    # travel router -> leaf follower -> leader, three tiers per trace)
    route_via: str = "leaders"
    partition_map: str = ""
    seed_rels: tuple = ()          # bulk-loaded into every shard leader
    wal_fsync: str = "never"
    pin: bool = False              # taskset-pin leaders + followers
    ready_timeout_s: float = 60.0
    # the role servers' endpoint URL: embedded:// (the reference's
    # roles), torch:// on the card, torch://?device=cpu
    endpoint: str = "embedded://"


class ProcessFleet:
    """Boot, gate, observe, and reap a FleetSpec's processes.

    Logs: each member's stdout+stderr land in `<workdir>/logs/<name>.log`
    so a readiness failure can quote the member's own words.  Teardown
    kills every member (SIGKILL after a grace wait) and removes the
    workdir; entering as a context manager guarantees teardown on any
    failure path."""

    def __init__(self, spec: FleetSpec, workdir: str = ""):
        self.spec = spec
        self.workdir = workdir or tempfile.mkdtemp(prefix="fleet-")
        self._own_workdir = not workdir
        os.makedirs(os.path.join(self.workdir, "logs"), exist_ok=True)
        self.members: dict = {}
        self.kube_url = ""
        self.router_url = ""
        self._next_pin = 0
        self._write_configs()

    # spec files the role processes + CLI router read
    def _write_configs(self) -> None:
        self.bootstrap_path = os.path.join(self.workdir, "bootstrap.yaml")
        self.rules_path = os.path.join(self.workdir, "rules.yaml")
        import yaml  # lazy: keeps the harness import pure-stdlib

        with open(self.bootstrap_path, "w") as f:
            yaml.safe_dump({"schema": self.spec.schema_text}, f)
        with open(self.rules_path, "w") as f:
            f.write(self.spec.rules_yaml)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.teardown()

    # -- spawning ------------------------------------------------------------

    def spawn(self, name: str, role: str, tier: str, cmd: list,
              port: int, data_dir: str = "",
              pin: Optional[int] = None, env: Optional[dict] = None) -> Member:
        """Start one member from any command line (its stdout and
        stderr into `<workdir>/logs/<name>.log`); `env` defaults to
        `single_thread_env()`."""
        log_path = os.path.join(self.workdir, "logs", f"{name}.log")
        log_file = open(log_path, "ab", buffering=0)
        proc = subprocess.Popen(
            pin_command(cmd, pin),
            stdout=log_file, stderr=subprocess.STDOUT,
            env=env if env is not None else single_thread_env())
        member = Member(name=name, role=role, tier=tier,
                        url=f"http://127.0.0.1:{port}", port=port,
                        proc=proc, log_path=log_path, data_dir=data_dir,
                        log_file=log_file)
        self.members[name] = member
        return member

    def _role_cmd(self, role: str, port: int, **kw) -> list:
        cmd = [sys.executable, "-m",
               "spicedb_kubeapi_proxy_tpu_torch.utils.topology",
               "--role", role, "--port", str(port),
               "--endpoint", self.spec.endpoint,
               "--bootstrap", self.bootstrap_path,
               "--rules", self.rules_path]
        for flag, val in kw.items():
            if val:
                cmd += ["--" + flag.replace("_", "-"), str(val)]
        return cmd

    def _pin(self) -> Optional[int]:
        if not self.spec.pin:
            return None
        cpu = self._next_pin
        self._next_pin += 1
        return cpu

    def boot(self) -> "ProcessFleet":
        """Spawn the whole spec and gate on readiness, bottom-up: kube,
        shard leaders, follower levels, router.  Any member missing its
        deadline (or dying first) reaps the fleet via FleetError."""
        spec = self.spec
        kp = free_port()
        self.kube_url = f"http://127.0.0.1:{kp}"
        self.spawn("kube", "kube", "kube",
                    self._role_cmd("kube", kp), kp)
        self.wait_port("kube", spec.ready_timeout_s)

        for i in range(spec.shard_leaders):
            p = free_port()
            self.spawn(
                f"leader-{i}", "leader", "leader",
                self._role_cmd(
                    "leader", p, kube=self.kube_url,
                    data_dir=os.path.join(self.workdir, f"leader-{i}"),
                    wal_fsync=spec.wal_fsync,
                    seed_rel=",".join(spec.seed_rels)),
                p, data_dir=os.path.join(self.workdir, f"leader-{i}"),
                pin=self._pin())
        for i in range(spec.shard_leaders):
            self.wait_ready(f"leader-{i}", spec.ready_timeout_s)

        # follower fan-out tree below leader 0: level l replicates from
        # a round-robin upstream in level l-1; non-leaf levels re-serve
        # the replication API to their children
        upstreams = [self.members["leader-0"].url] \
            if spec.shard_leaders else []
        for level, count in enumerate(spec.follower_levels):
            urls = []
            is_leaf = level == len(spec.follower_levels) - 1
            for i in range(count):
                p = free_port()
                name = f"follower-l{level}-{i}"
                self.spawn(
                    name, "follower", "follower",
                    self._role_cmd(
                        "follower", p, kube=self.kube_url,
                        leader=upstreams[i % len(upstreams)],
                        serve_replication="" if is_leaf else "1",
                        promote_data_dir=os.path.join(
                            self.workdir, name + "-promote")),
                    p, pin=self._pin())
                urls.append(f"http://127.0.0.1:{p}")
            for i in range(count):
                self.wait_ready(f"follower-l{level}-{i}",
                                spec.ready_timeout_s)
            upstreams = urls

        if spec.router:
            leaders = [self.members[f"leader-{i}"].url
                       for i in range(spec.shard_leaders)]
            followers = [m.url for m in self.members.values()
                         if m.role == "follower"]
            if spec.route_via == "followers" and followers:
                # read fan-out shape: the router fronts the leaf
                # followers (deepest level) and merges the leaders into
                # /debug/fleet as extra peers, so a write trace spans
                # router -> follower -> leader
                leaves = upstreams
                member = self.spawn_router(
                    "router", leaves,
                    partition_map=spec.partition_map,
                    fleet_peers=leaders
                    + [u for u in followers if u not in leaves])
            else:
                member = self.spawn_router(
                    "router", leaders,
                    partition_map=spec.partition_map,
                    fleet_peers=followers)
            self.router_url = member.url
            self.wait_ready("router", spec.ready_timeout_s)
        return self

    def spawn_router(self, name: str, shard_leader_urls: list,
                     partition_map: str = "",
                     fleet_peers=()) -> Member:
        """One CLI router (`--shard-leaders`) over the given members;
        callers comparing fleet widths spawn several routers with
        different partition maps over the same leaders."""
        rp = free_port()
        cmd = [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch",
               "--shard-leaders", ",".join(shard_leader_urls),
               "--rule-config", self.rules_path,
               "--spicedb-bootstrap", self.bootstrap_path,
               "--embedded-mode", "--bind-address", "127.0.0.1",
               "--secure-port", str(rp)]
        if partition_map:
            cmd += ["--partition-map", partition_map]
        if fleet_peers:
            cmd += ["--fleet-peers", ",".join(fleet_peers)]
        return self.spawn(name, "router", "router", cmd, rp)

    # -- readiness -----------------------------------------------------------

    def _log_tail(self, member: Member, lines: int = 12) -> str:
        try:
            with open(member.log_path, "rb") as f:
                return b"\n".join(
                    f.read().splitlines()[-lines:]).decode(
                        "utf-8", "replace")
        except OSError:
            return "<no log>"

    def _fail(self, why: str) -> None:
        self.teardown()
        raise FleetError(why + " — whole fleet reaped")

    def _gate(self, name: str, deadline_s: float, probe: Callable,
              what: str) -> None:
        member = self.members[name]
        t0 = time.time()
        while time.time() - t0 < deadline_s:
            if member.proc.poll() is not None:
                self._fail(
                    f"fleet member {name!r} died during boot "
                    f"(exit {member.proc.returncode}); last log lines:\n"
                    f"{self._log_tail(member)}")
            if probe(member):
                return
            time.sleep(0.1)
        self._fail(f"fleet member {name!r} not {what} within "
                   f"{deadline_s:.0f}s; last log lines:\n"
                   f"{self._log_tail(member)}")

    def wait_ready(self, name: str, deadline_s: float = 60.0,
                   want_degraded: bool = False) -> None:
        def probe(member):
            try:
                status, _, body = http("GET", member.url + "/readyz",
                                       timeout=2.0)
            except OSError:
                return False
            return status == 200 and (b"[!]" in body
                                      if want_degraded else True)

        self._gate(name, deadline_s, probe,
                   "degraded" if want_degraded else "ready")

    def wait_port(self, name: str, deadline_s: float = 60.0) -> None:
        """TCP-accept gate for members without /readyz (the kube
        fake)."""
        def probe(member):
            try:
                with socket.create_connection(
                        ("127.0.0.1", member.port), timeout=1.0):
                    return True
            except OSError:
                return False

        self._gate(name, deadline_s, probe, "accepting")

    # -- chaos + teardown ----------------------------------------------------

    def kill(self, name: str, sig: int = signal.SIGKILL) -> None:
        """Chaos helper: kill -9 one member, keep its corpse in the
        member table (its url/data_dir stay addressable for restart
        assertions)."""
        m = self.members[name]
        if m.proc.poll() is None:
            m.proc.send_signal(sig)
            m.proc.wait(10)

    def restart(self, name: str) -> Member:
        """Relaunch a killed member with its original command line (and
        data dir) — the crash-recovery half of a chaos pass."""
        old = self.members[name]
        if old.proc.poll() is None:
            raise FleetError(f"member {name!r} still running")
        log_file = open(old.log_path, "ab", buffering=0)
        proc = subprocess.Popen(old.proc.args, stdout=log_file,
                                stderr=subprocess.STDOUT,
                                env=single_thread_env())
        try:
            old.log_file.close()
        except Exception:
            pass
        self.members[name] = Member(
            name=old.name, role=old.role, tier=old.tier, url=old.url,
            port=old.port, proc=proc, log_path=old.log_path,
            data_dir=old.data_dir, log_file=log_file)
        return self.members[name]

    def stop(self, timeout_s: float = 10.0) -> dict:
        """Orderly stop: SIGTERM to every live member, wait, and return
        each member's exit code (a killed corpse keeps its own); a member
        outliving `timeout_s` is killed and reported as None."""
        for m in self.members.values():
            if m.proc.poll() is None:
                m.proc.send_signal(signal.SIGTERM)
        out = {}
        deadline = time.time() + timeout_s
        for name, m in self.members.items():
            try:
                out[name] = m.proc.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                m.proc.kill()
                m.proc.wait(5)
                out[name] = None
        return out

    def log_text(self, name: str) -> str:
        """A member's whole log (stdout and stderr)."""
        with open(self.members[name].log_path, "rb") as f:
            return f.read().decode("utf-8", "replace")

    def urls(self, role: str) -> list:
        return [m.url for m in self.members.values() if m.role == role]

    def teardown(self) -> None:
        for m in self.members.values():
            if m.proc.poll() is None:
                m.proc.kill()
        for m in self.members.values():
            try:
                m.proc.wait(5)
            except subprocess.TimeoutExpired:
                pass
            try:
                if m.log_file is not None:
                    m.log_file.close()
            except Exception:
                pass
        self.members = {}
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


# -- role processes (python -m spicedb_kubeapi_proxy_tpu_torch.utils.topology)


async def _until_signalled() -> None:
    """Wait for SIGTERM or SIGINT."""
    import asyncio
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()


def _serve_role(args) -> None:
    """One fleet member: the shared fake kube apiserver, or a proxy
    (leader / follower / shard leader) serving plain HTTP with header
    authn, owned by the harness so every caller composes identical
    members.  The proxy roles serve `args.endpoint` (default
    `embedded://`, the reference's).  SIGTERM or SIGINT stops a member
    with exit 0."""
    import asyncio
    import logging

    logging.basicConfig(
        level=logging.WARNING,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")

    from ..proxy.httpcore import H11Transport, HttpServer

    if args.role == "kube":
        from ..kubefake.apiserver import FakeKubeApiServer

        async def run_kube():
            kube = FakeKubeApiServer()
            for ns in (args.seed_ns or "team-a").split(","):
                if ns:
                    kube.seed("", "v1", "namespaces",
                              {"metadata": {"name": ns}})
            server = HttpServer(kube)
            await server.start("127.0.0.1", args.port)
            print(f"kube serving on {args.port}", flush=True)
            await _until_signalled()
            await server.stop()

        asyncio.run(run_kube())
        return

    import yaml

    from ..proxy.authn import HeaderAuthenticator
    from ..proxy.server import Options, ProxyServer
    from ..spicedb.endpoints import Bootstrap
    from ..spicedb.types import parse_relationship

    with open(args.bootstrap) as f:
        schema_text = yaml.safe_load(f)["schema"]
    with open(args.rules) as f:
        rules_yaml = f.read()

    opts = Options(
        spicedb_endpoint=args.endpoint,
        bootstrap=Bootstrap(schema_text=schema_text),
        rules_yaml=rules_yaml,
        upstream_transport=H11Transport(args.kube),
        authenticators=[HeaderAuthenticator()],
        workflow_database_path="",  # in-memory dual-write journal
    )
    if args.role == "leader":
        opts.data_dir = args.data_dir
        opts.wal_fsync = args.wal_fsync
        if args.peers:
            opts.replica_peers = [p for p in args.peers.split(",") if p]
    elif args.role == "follower":
        opts.replicate_from = args.leader
        opts.replica_user = "system:replica"
        if args.serve_replication:
            # mid-tier of a fan-out tree: mirror leader artifacts and
            # re-serve /replication/* to this member's children
            opts.serve_replication = True
        if args.promote_data_dir:
            opts.promote_data_dir = args.promote_data_dir
    else:
        raise SystemExit(f"unknown role {args.role!r}")

    async def run():
        proxy = ProxyServer(opts)
        if args.role == "leader" and proxy.endpoint.store.revision == 0:
            proxy.endpoint.store.bulk_load(
                [parse_relationship(r)
                 for r in (args.seed_rel or "").split(",") if r])
        proxy.enable_dual_writes()
        await proxy.start("127.0.0.1", args.port)
        print(f"{args.role} serving on {args.port}", flush=True)
        await _until_signalled()
        await proxy.stop()

    asyncio.run(run())


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="fleet member role server (ProcessFleet internal)")
    ap.add_argument("--role", required=True,
                    choices=["kube", "leader", "follower"])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--endpoint", default="embedded://")
    ap.add_argument("--bootstrap", default="")
    ap.add_argument("--rules", default="")
    ap.add_argument("--kube", default="")
    ap.add_argument("--leader", default="")
    ap.add_argument("--data-dir", default="")
    ap.add_argument("--wal-fsync", default="never")
    ap.add_argument("--seed-rel", default="")
    ap.add_argument("--seed-ns", default="")
    ap.add_argument("--peers", default="")
    ap.add_argument("--serve-replication", default="")
    ap.add_argument("--promote-data-dir", default="")
    _serve_role(ap.parse_args())


if __name__ == "__main__":
    _main()
