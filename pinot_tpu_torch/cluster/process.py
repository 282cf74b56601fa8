"""Multi-process cluster: each role an OS process, joined over HTTP.

A trimmed copy of `pinot_tpu/cluster/process.py`: the deployment shape of
the reference (one JVM a role, started by `PinotAdministrator`'s Start*
commands), here one Python process a role, started by
`python -m pinot_tpu_torch.cluster.process --role ...` or the admin CLI
(`tools/admin.py`). The controller process owns the catalog and the deep
store and runs the periodic tasks; server and broker processes join through
`RemoteCatalog` and speak the binary wire format (`wire.py`, `mux.py`). A
server process reports to the controller's LLC segment manager over HTTP
(`remote.RemoteCompletion`) and consumes its realtime tables on its own
loops (`auto_consume`): a REALTIME table over a kafkalite stream is consumed,
committed and queried across the processes.

A server process runs on CUDA unless it is started with `--device cpu`: it
owns the card through its `DeviceQueryPipeline` (`server.device.enabled`)
or through the per-segment executor, and runs its join stages there.
Started for CUDA on a machine without a card it exits non-zero at start; it
never becomes a CPU server. A broker process takes `--device` too: where a
funnel-path join partition runs when it runs on the broker (resolved when
one does).

`ProcessCluster` is the harness that starts the processes (new interpreters
through `subprocess`, never a fork of a parent that may hold a CUDA
context), waits for each role's ready file in `run_dir` and kills them all
on exit; a kill is a real process death, and `restart_server` starts a
fresh process under the same instance id. `ControllerClient` and
`BrokerClient` are its HTTP clients. The minion role (`run_minion`) waits:
ROADMAP.md queue 1, item 3.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.parse
from typing import Dict, List, Optional, Sequence

from .http_service import get_json, http_call, post_json

#: the repository root: a child interpreter imports this package from it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _write_ready(run_dir: str, name: str, payload: Dict) -> None:
    path = os.path.join(run_dir, f"{name}.ready")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _load_config(config_path: str, cli_port: int, port_key: str):
    """The role's configuration: defaults < file < environment < the CLI's
    port, when one is given."""
    from .. import plugins
    from ..config import Configuration
    overrides = {port_key: cli_port} if cli_port else {}
    cfg = Configuration.load(config_path or None, overrides=overrides)
    plugins.load_from_config(cfg)
    return cfg


def _setup_auth(cfg):
    """Access control for this role's endpoints, and this process's outgoing
    token (`auth.service.token`)."""
    from ..auth import StaticTokenAccessControl
    from .http_service import set_default_token
    set_default_token(cfg.get_str("auth.service.token"))
    return StaticTokenAccessControl.from_config(cfg)


def _apply_client_tls(cfg) -> bool:
    """The config's tls.* trust for this process's outgoing clients; returns
    whether TLS is on."""
    from .http_service import set_default_tls
    if not cfg.get_bool("tls.enabled"):
        return False
    set_default_tls(cafile=cfg.get_str("tls.ca"), insecure=cfg.get_bool("tls.insecure"))
    return True


def _setup_tls(cfg):
    """The server-side SSL context from `tls.enabled`, `tls.cert`, `tls.key`
    (PEM) and `tls.ca`, or None."""
    if not _apply_client_tls(cfg):
        return None
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.get_str("tls.cert"), cfg.get_str("tls.key"))
    return ctx


_STOP_SIGNALS = {signal.SIGTERM, signal.SIGINT}


def _block_stop_signals() -> None:
    """Block SIGTERM and SIGINT before any thread starts (threads inherit
    the mask), so `_wait_for_signal` takes them and the role shuts down."""
    signal.pthread_sigmask(signal.SIG_BLOCK, _STOP_SIGNALS)


def _wait_for_signal() -> None:
    signal.sigwait(_STOP_SIGNALS)


def _controller(work_dir: str, cfg):
    from .catalog import Catalog
    from .controller import Controller
    from .deepstore import create_fs
    deepstore = create_fs(cfg.get_str("controller.deepstore",
                                      f"local://{os.path.join(work_dir, 'deepstore')}"))
    return Controller("controller_0", Catalog(), deepstore,
                      os.path.join(work_dir, "controller"))


def _server(controller_url: str, instance_id: str, work_dir: str, cfg, device: str):
    """A ServerNode joined through the controller: on `device`, with the
    pipeline and the scheduler its configuration asks for, reporting its
    consuming segments over HTTP and consuming them on its own loops."""
    from ..query.scheduler import scheduler_from_config
    from .device_server import pipeline_from_config
    from .remote import ControllerDeepStore, RemoteCatalog, RemoteCompletion
    from .server import ServerNode
    pipeline = pipeline_from_config(cfg, device=device)
    catalog = RemoteCatalog(controller_url)
    return ServerNode(instance_id, catalog, ControllerDeepStore(controller_url),
                      os.path.join(work_dir, instance_id),
                      tags=cfg.get_list("server.tenant.tags") or None,
                      scheduler=scheduler_from_config(cfg), device=device,
                      device_pipeline=pipeline, completion=RemoteCompletion(controller_url),
                      auto_consume=True)


def run_controller(work_dir: str, run_dir: str, port: int = 0, config_path: str = "") -> None:
    _block_stop_signals()
    from .services import ControllerService
    cfg = _load_config(config_path, port, "controller.port")
    access_control = _setup_auth(cfg)
    ssl_ctx = _setup_tls(cfg)
    controller = _controller(work_dir, cfg)
    svc = ControllerService(controller, port=cfg.get_int("controller.port", 0),
                            access_control=access_control, ssl_context=ssl_ctx)
    controller.start_periodic_tasks()   # retention, status, realtime validation
    _write_ready(run_dir, "controller_0", {"url": svc.url})
    _wait_for_signal()
    controller.stop_periodic_tasks()
    svc.stop()


def run_server(controller_url: str, instance_id: str, work_dir: str, run_dir: str,
               port: int = 0, config_path: str = "", device: str = "cuda") -> None:
    """A server process: defaults < config file < PINOT_TPU_* environment <
    CLI arguments. On CUDA (the default) without a card, ServerNode raises
    before the ready file is written, and the process exits non-zero."""
    _block_stop_signals()
    from .services import ServerService
    cfg = _load_config(config_path, port, "server.port")
    access_control = _setup_auth(cfg)
    ssl_ctx = _setup_tls(cfg)
    server = _server(controller_url, instance_id, work_dir, cfg, device)
    svc = ServerService(server, port=cfg.get_int("server.port", 0),
                        access_control=access_control, ssl_context=ssl_ctx)
    _write_ready(run_dir, instance_id, {"url": svc.url, "device": str(server.executor.device)})
    _wait_for_signal()
    server.shutdown()
    svc.stop()
    server.catalog.close()


def run_broker(controller_url: str, instance_id: str, run_dir: str, port: int = 0,
               config_path: str = "", device: str = "cuda") -> None:
    _block_stop_signals()
    from .broker import Broker
    from .remote import RemoteCatalog
    from .services import BrokerService
    cfg = _load_config(config_path, port, "broker.port")
    access_control = _setup_auth(cfg)
    ssl_ctx = _setup_tls(cfg)
    catalog = RemoteCatalog(controller_url)
    broker = Broker(instance_id, catalog,
                    max_scatter_threads=cfg.get_int("broker.scatter.threads", 8),
                    device=device)
    svc = BrokerService(broker, port=cfg.get_int("broker.port", 0),
                        access_control=access_control, ssl_context=ssl_ctx)
    _write_ready(run_dir, instance_id, {"url": svc.url})
    _wait_for_signal()
    svc.stop()
    catalog.close()


def run_minion(*args, **kwargs) -> None:
    raise NotImplementedError("the minion role waits: ROADMAP.md queue 1, item 3")


def run_service_manager(work_dir: str, run_dir: str, port: int = 0, config_path: str = "",
                        block: bool = True, device: str = "cuda"):
    """Every role in one process from one configuration (reference:
    PinotServiceManager): a controller, one server on `device` and a broker,
    the server and the broker still joined to the controller over its HTTP
    catalog. With `block=False` returns the services to the caller."""
    from .broker import Broker
    from .remote import RemoteCatalog
    from .services import BrokerService, ControllerService, ServerService
    os.makedirs(run_dir, exist_ok=True)
    if block:
        _block_stop_signals()
    cfg = _load_config(config_path, port, "controller.port")
    access_control = _setup_auth(cfg)
    ssl_ctx = _setup_tls(cfg)
    controller = _controller(work_dir, cfg)
    csvc = ControllerService(controller, port=cfg.get_int("controller.port", 0),
                             access_control=access_control, ssl_context=ssl_ctx)
    controller.start_periodic_tasks()
    server = _server(csvc.url, "server_0", work_dir, cfg, device)
    ssvc = ServerService(server, port=cfg.get_int("server.port", 0),
                         access_control=access_control, ssl_context=ssl_ctx)
    broker_catalog = RemoteCatalog(csvc.url)
    broker = Broker("broker_0", broker_catalog,
                    max_scatter_threads=cfg.get_int("broker.scatter.threads", 8),
                    device=device)
    bsvc = BrokerService(broker, port=cfg.get_int("broker.port", 0),
                         access_control=access_control, ssl_context=ssl_ctx)
    for name, svc in (("controller_0", csvc), ("server_0", ssvc), ("broker_0", bsvc)):
        _write_ready(run_dir, name, {"url": svc.url})
    handles = {"controller": csvc, "server": ssvc, "broker": bsvc,
               "catalogs": (server.catalog, broker_catalog),
               "controller_obj": controller, "server_obj": server}
    if not block:
        return handles
    _wait_for_signal()
    server.shutdown()
    controller.stop_periodic_tasks()
    for svc in (bsvc, ssvc, csvc):
        svc.stop()
    for c in (server.catalog, broker_catalog):
        c.close()
    return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="pinot_tpu_torch.cluster.process")
    p.add_argument("--role", required=True,
                   choices=["controller", "server", "broker", "service-manager"])
    p.add_argument("--controller-url", default="")
    p.add_argument("--instance-id", default="")
    p.add_argument("--work-dir", default="")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--config", default="", help="properties or JSON config file")
    p.add_argument("--device", default="cuda",
                   help="the server's (and a broker's) device: cuda (the default) or cpu")
    a = p.parse_args(argv)
    if a.role == "controller":
        run_controller(a.work_dir, a.run_dir, a.port, config_path=a.config)
    elif a.role == "server":
        run_server(a.controller_url, a.instance_id, a.work_dir, a.run_dir, a.port,
                   config_path=a.config, device=a.device)
    elif a.role == "service-manager":
        run_service_manager(a.work_dir, a.run_dir, a.port, config_path=a.config,
                            device=a.device)
    else:
        run_broker(a.controller_url, a.instance_id, a.run_dir, a.port, config_path=a.config,
                   device=a.device)


class ControllerClient:
    """HTTP admin client of a controller; `token` rides each request."""

    def __init__(self, url: str, token: Optional[str] = None):
        self.url = url.rstrip("/")
        self.token = token

    def add_schema(self, schema) -> None:
        post_json(f"{self.url}/schemas", schema.to_json(), token=self.token)

    def add_table(self, config, num_partitions: int = 1) -> Dict:
        """Add a table; one with a stream config gets its first consuming
        segment in each of `num_partitions` stream partitions."""
        return post_json(f"{self.url}/tables", {"config": config.to_json(),
                                                "numPartitions": num_partitions},
                         token=self.token)

    def drop_table(self, table: str) -> None:
        http_call("DELETE", f"{self.url}/tables/{table}", token=self.token)

    def upload_segment(self, table: str, segment_dir: str) -> Dict:
        """Tar a built segment directory and push it."""
        from .deepstore import tar_segment
        name = os.path.basename(segment_dir.rstrip("/"))
        with tempfile.TemporaryDirectory() as tmp:
            tar_path = os.path.join(tmp, f"{name}.tar.gz")
            tar_segment(segment_dir, tar_path)
            with open(tar_path, "rb") as f:
                payload = f.read()
        q = urllib.parse.urlencode({"name": name})
        return json.loads(http_call("POST", f"{self.url}/segments/{table}?{q}", payload,
                                    content_type="application/octet-stream", timeout=300.0,
                                    token=self.token).decode())

    def table_status(self, table: str) -> Dict:
        return get_json(f"{self.url}/tableStatus/{table}", token=self.token)

    def get_schema(self, name: str) -> Dict:
        return get_json(f"{self.url}/schemas/{name}", token=self.token)

    def list_tables(self) -> Dict:
        return get_json(f"{self.url}/tables", token=self.token)

    def table_config(self, table: str) -> Dict:
        return get_json(f"{self.url}/tables/{table}", token=self.token)

    def segments_meta(self, table: str) -> Dict:
        return get_json(f"{self.url}/segmentsMeta/{table}", token=self.token)

    def reload_table(self, table: str) -> Dict:
        return post_json(f"{self.url}/reload/{table}", {}, token=self.token)

    def rebalance(self, table: str) -> Dict:
        return post_json(f"{self.url}/rebalance/{table}", {}, token=self.token)

    def set_cluster_config(self, key: str, value) -> Dict:
        return post_json(f"{self.url}/clusterConfigs", {"key": key, "value": value},
                         token=self.token)

    def pause_consumption(self, table: str) -> Dict:
        return post_json(f"{self.url}/pauseConsumption/{table}", {}, token=self.token)

    def resume_consumption(self, table: str) -> Dict:
        return post_json(f"{self.url}/resumeConsumption/{table}", {}, token=self.token)

    def ingestion_status(self, table: str) -> Dict:
        """The table's ingestion verdict (`GET /tables/{t}/ingestionStatus`),
        polled live from the servers."""
        return get_json(f"{self.url}/tables/{table}/ingestionStatus", timeout=60.0,
                        token=self.token)

    def memory_status(self, table: str) -> Dict:
        """The table's memory verdict (`GET /tables/{t}/memoryStatus`)."""
        return get_json(f"{self.url}/tables/{table}/memoryStatus", token=self.token)

    def run_memory_check(self) -> Dict:
        """One memory check now: {table: verdict}."""
        return post_json(f"{self.url}/memoryCheck", {}, timeout=60.0, token=self.token)

    def validate(self) -> Dict:
        """One realtime validation round: {"created", "reassigned", "healed"}."""
        return post_json(f"{self.url}/validate", {}, timeout=300.0, token=self.token)


class BrokerClient:
    def __init__(self, url: str, token: Optional[str] = None):
        self.url = url.rstrip("/")
        self.token = token

    def query(self, sql: str, timeout: float = 120.0) -> Dict:
        return post_json(f"{self.url}/query", {"sql": sql}, timeout=timeout, token=self.token)

    def query_stream(self, sql: str, timeout: float = 600.0):
        """Yields ("schema", columns) first, then ("rows", batch) as the
        broker streams them (chunked HTTP)."""
        import urllib.request

        from .http_service import client_ssl_context
        req = urllib.request.Request(
            f"{self.url}/queryStream", data=json.dumps({"sql": sql}).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.token}"} if self.token else {})})
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=client_ssl_context()) as resp:
            for line in resp:
                if not line.strip():
                    continue
                d = json.loads(line)
                if "error" in d:
                    # a failure mid-stream arrives as the last line
                    raise RuntimeError(f"stream failed: {d['error']}")
                if "columns" in d:
                    yield ("schema", d["columns"])
                else:
                    yield ("rows", d["rows"])


class ProcessCluster:
    """A controller, N servers and a broker as OS processes, ready when each
    has written its ready file. Servers (and the broker's local join
    partitions) run on `device` (CUDA unless the caller passes "cpu", as the
    tests do); `server_config` is a
    {key: value} map written to the servers' configuration file (say
    `{"server.device.enabled": "true"}` for the serving pipeline). Each wait
    has its own deadline (`startup_timeout_s`), and a context manager kills
    every child on exit."""

    def __init__(self, num_servers: int = 2, work_dir: Optional[str] = None,
                 device: str = "cuda", server_config: Optional[Dict[str, object]] = None,
                 startup_timeout_s: float = 60.0, config_path: str = ""):
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_proc_")
        self.run_dir = os.path.join(self.work_dir, "run")
        os.makedirs(self.run_dir, exist_ok=True)
        self.procs: Dict[str, subprocess.Popen] = {}
        self.device = device
        self._timeout = startup_timeout_s
        self._config_path = config_path
        self._server_config = ""
        if server_config:
            self._server_config = os.path.join(self.run_dir, "server.properties")
            lines = []
            if config_path:
                from ..config import read_config_file
                lines = [f"{k}={v}" for k, v in read_config_file(config_path).items()]
            lines += [f"{k}={v}" for k, v in server_config.items()]
            with open(self._server_config, "w") as f:
                f.write("\n".join(lines) + "\n")
        if config_path:
            from ..config import Configuration
            _apply_client_tls(Configuration.load(config_path))
        self._env = dict(os.environ)
        self._env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in self._env.get("PYTHONPATH", "").split(os.pathsep) if p])
        try:
            self._spawn("controller_0", ["--role", "controller", "--work-dir", self.work_dir])
            self.controller_url = self._await_ready("controller_0")
            # the broker starts beside the servers: it wires each server as the
            # server registers (a catalog event), whenever that comes
            for i in range(num_servers):
                self._spawn_server(f"server_{i}")
            self._spawn("broker_0", ["--role", "broker", "--instance-id", "broker_0",
                                     "--controller-url", self.controller_url,
                                     "--device", self.device])
            for i in range(num_servers):
                self._await_ready(f"server_{i}")
            self.broker_url = self._await_ready("broker_0")
        except BaseException:
            self.shutdown()
            raise
        self.controller = ControllerClient(self.controller_url)
        self.broker = BrokerClient(self.broker_url)

    def _spawn(self, name: str, args: List[str], config: str = "") -> None:
        cmd = [sys.executable, "-m", "pinot_tpu_torch.cluster.process",
               "--run-dir", self.run_dir] + args
        config = config or self._config_path
        if config:
            cmd += ["--config", config]
        with open(os.path.join(self.run_dir, f"{name}.log"), "ab") as log:
            # the child holds its own copy of the descriptor
            self.procs[name] = subprocess.Popen(cmd, env=self._env, cwd=self.work_dir,
                                                stdout=log, stderr=subprocess.STDOUT)

    def _spawn_server(self, instance_id: str) -> None:
        self._spawn(instance_id, ["--role", "server", "--instance-id", instance_id,
                                  "--controller-url", self.controller_url,
                                  "--work-dir", self.work_dir, "--device", self.device],
                    config=self._server_config)

    def log(self, name: str) -> str:
        with open(os.path.join(self.run_dir, f"{name}.log"), errors="replace") as f:
            return f.read()

    def _await_ready(self, name: str) -> str:
        path = os.path.join(self.run_dir, f"{name}.ready")
        deadline = time.time() + self._timeout
        while time.time() < deadline:
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)["url"]
            proc = self.procs.get(name)
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(f"{name} exited with {proc.returncode} at startup:\n"
                                   f"{self.log(name)[-4000:]}")
            time.sleep(0.05)
        raise TimeoutError(f"{name} not ready after {self._timeout}s:\n"
                           f"{self.log(name)[-4000:]}")

    def add_broker(self, instance_id: str) -> "BrokerClient":
        """Start one more broker process (it reads the cluster's
        `broker.mux.enabled` as it wires its servers) and wait for it."""
        self._spawn(instance_id, ["--role", "broker", "--instance-id", instance_id,
                                  "--controller-url", self.controller_url,
                                  "--device", self.device])
        return BrokerClient(self._await_ready(instance_id))

    def restart_server(self, instance_id: str) -> str:
        """Start a fresh server process under the same instance id (killing
        the old one if it lives): it registers again, loads its assigned
        segments (from its disk, the deep store or a peer) and consumes again
        from the committed offsets. Returns the new process's URL."""
        self.kill_server(instance_id)
        ready = os.path.join(self.run_dir, f"{instance_id}.ready")
        if os.path.exists(ready):
            os.remove(ready)   # the wait must see the new process's file
        self._spawn_server(instance_id)
        return self._await_ready(instance_id)

    def server_url(self, instance_id: str) -> str:
        with open(os.path.join(self.run_dir, f"{instance_id}.ready")) as f:
            return json.load(f)["url"]

    def query(self, sql: str) -> Dict:
        return self.broker.query(sql)

    def kill_server(self, instance_id: str) -> None:
        """SIGKILL a server process: a real process death, not a flag."""
        proc = self.procs.get(instance_id)
        if proc is not None:
            proc.kill()
            proc.wait()

    def shutdown(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def __enter__(self) -> "ProcessCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


if __name__ == "__main__":
    main()
