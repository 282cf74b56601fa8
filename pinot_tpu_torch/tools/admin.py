"""pinot_tpu_torch admin CLI: operate a cluster without writing Python.

A trimmed copy of `pinot_tpu/tools/admin.py` (the analog of the reference's
`pinot-admin.sh`, `PinotAdministrator.java`): the role starters, schema and
table management, segment push, queries and the segment tools, over the
controller's and broker's HTTP APIs. A server (and a broker's local join
partitions) runs on CUDA unless it is started with `--device cpu`.

    python -m pinot_tpu_torch.tools.admin start-controller --work-dir /data --run-dir /run
    python -m pinot_tpu_torch.tools.admin start-server --controller URL --work-dir /data \\
                                                       --run-dir /run --device cuda
    python -m pinot_tpu_torch.tools.admin start-broker --controller URL --run-dir /run
    python -m pinot_tpu_torch.tools.admin add-schema --controller URL --file schema.json
    python -m pinot_tpu_torch.tools.admin add-table --controller URL --file table.json \
                                                    --num-partitions 2   # a REALTIME table
    python -m pinot_tpu_torch.tools.admin upload-segment --controller URL --table t_OFFLINE \\
                                                         --dir seg/
    python -m pinot_tpu_torch.tools.admin query --broker URL --sql "SELECT ..."
    python -m pinot_tpu_torch.tools.admin dump-segment --dir seg/

A REALTIME table's config carries its stream (`streamType` "kafkalite" and
its `bootstrap`): `add-table` makes its consuming segments, the server
processes consume them, and `pause-consumption` / `resume-consumption` stop
and start them. The tuner, quickstart, data generator, ingest-job and
compatibility commands wait: ROADMAP.md queue 1, item 5.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Optional, Sequence


def _print(obj: Any) -> None:
    print(json.dumps(obj, indent=2, default=str))


def _controller(args):
    from ..cluster.process import ControllerClient
    return ControllerClient(args.controller)


def cmd_start_role(args) -> int:
    from ..cluster import process
    if args.cmd == "start-controller":
        process.run_controller(args.work_dir, args.run_dir, args.port, args.config)
    elif args.cmd == "start-server":
        process.run_server(args.controller, args.instance_id or "server_0", args.work_dir,
                           args.run_dir, args.port, args.config, device=args.device)
    else:
        process.run_broker(args.controller, args.instance_id or "broker_0", args.run_dir,
                           args.port, args.config, device=args.device)
    return 0


def cmd_start_service_manager(args) -> int:
    """All roles in one process (reference: StartServiceManagerCommand)."""
    from ..cluster.process import run_service_manager
    run_service_manager(args.work_dir, args.run_dir, args.port, args.config,
                        device=args.device)
    return 0


def cmd_add_schema(args) -> int:
    from ..schema import Schema
    with open(args.file) as f:
        schema = Schema.from_json(json.load(f))
    _controller(args).add_schema(schema)
    _print({"status": "OK", "schema": schema.name})
    return 0


def cmd_add_table(args) -> int:
    from ..table import TableConfig
    with open(args.file) as f:
        cfg = TableConfig.from_json(json.load(f))
    _print(_controller(args).add_table(cfg, num_partitions=args.num_partitions))
    return 0


def cmd_list_tables(args) -> int:
    _print(_controller(args).list_tables())
    return 0


def cmd_table_status(args) -> int:
    _print(_controller(args).table_status(args.table))
    return 0


def cmd_upload_segment(args) -> int:
    _print(_controller(args).upload_segment(args.table, args.dir))
    return 0


def cmd_build_segment(args) -> int:
    """Build a segment from a JSON-lines (or CSV) file and a schema JSON
    (reference: CreateSegmentCommand)."""
    from ..ingest.readers import reader_for
    from ..schema import Schema
    from ..segment.writer import SegmentBuilder, SegmentGeneratorConfig
    with open(args.schema) as f:
        schema = Schema.from_json(json.load(f))
    rows = list(reader_for(args.input, args.format or None).rows())
    cols = {c: [r.get(c) for r in rows] for c in schema.column_names}
    path = SegmentBuilder(schema, SegmentGeneratorConfig()).build(cols, args.out, args.name)
    _print({"status": "OK", "segmentDir": path, "rows": len(rows)})
    return 0


def cmd_reload_table(args) -> int:
    _print(_controller(args).reload_table(args.table))
    return 0


def cmd_query(args) -> int:
    from ..cluster.process import BrokerClient
    resp = BrokerClient(args.broker).query(args.sql)
    if args.json:
        _print(resp)
        return 0
    table = resp.get("resultTable", {})
    names = table.get("dataSchema", {}).get("columnNames", [])
    rows = table.get("rows", [])
    if names:
        print("\t".join(map(str, names)))
    for row in rows:
        print("\t".join(map(str, row)))
    stats = {k: v for k, v in resp.items() if k != "resultTable"}
    print(f"-- {len(rows)} rows, {json.dumps(stats, default=str)}", file=sys.stderr)
    return 0


def cmd_dump_segment(args) -> int:
    from .segment import dump_segment
    _print(dump_segment(args.dir, max_rows=args.rows))
    return 0


def cmd_verify_segment(args) -> int:
    from .segment import verify_segment
    report = verify_segment(args.dir)
    _print(report)
    return 0 if report["ok"] else 1


def cmd_cluster_info(args) -> int:
    """Reference: ShowClusterInfo / VerifyClusterState."""
    from ..cluster.http_service import get_json
    c = _controller(args)
    tables = c.list_tables().get("tables", {})
    print(f"tenants: {get_json(f'{c.url}/tenants', token=c.token).get('tenants', {})}")
    ok = True
    for name in tables:
        st = c.table_status(name)
        ok &= bool(st.get("converged"))
        print(f"{name}: segments={st.get('segments')} converged={st.get('converged')}")
    print("cluster state: " + ("GOOD" if ok else "NOT CONVERGED"))
    return 0 if ok else 1


def cmd_list_tenants(args) -> int:
    from ..cluster.http_service import get_json
    c = _controller(args)
    _print(get_json(f"{c.url}/tenants", token=c.token))
    return 0


def cmd_tag_instance(args) -> int:
    from ..cluster.http_service import post_json
    c = _controller(args)
    _print(post_json(f"{c.url}/instanceTags/{args.instance}",
                     {"tags": args.tags.split(",")}, token=c.token))
    return 0


def cmd_rebalance_table(args) -> int:
    _print(_controller(args).rebalance(args.table))
    return 0


def cmd_change_table_state(args) -> int:
    from ..cluster.http_service import http_call
    c = _controller(args)
    out = http_call("POST", f"{c.url}/tableState/{args.table}?state={args.state}", b"{}",
                    token=c.token)
    _print(json.loads(out.decode()))
    return 0


def cmd_cluster_config(args) -> int:
    """Reference: OperateClusterConfigCommand (list, set, delete)."""
    from ..cluster.http_service import get_json
    c = _controller(args)
    if args.set:
        key, _, value = args.set.partition("=")
        _print(c.set_cluster_config(key, value))
    elif args.delete:
        _print(c.set_cluster_config(args.delete, None))
    else:
        _print(get_json(f"{c.url}/clusterConfigs", token=c.token))
    return 0


def cmd_drop_table(args) -> int:
    _controller(args).drop_table(args.table)
    print(f"dropped {args.table}")
    return 0


def cmd_pause_consumption(args) -> int:
    _print(_controller(args).pause_consumption(args.table))
    return 0


def cmd_resume_consumption(args) -> int:
    _print(_controller(args).resume_consumption(args.table))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pinot-tpu-torch-admin", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def role(name):
        sp = sub.add_parser(name)
        # only the controller starts without a controller URL
        sp.add_argument("--controller", required=(name != "start-controller"), default="")
        sp.add_argument("--instance-id", default="")
        sp.add_argument("--work-dir", default="")
        sp.add_argument("--run-dir", required=True)
        sp.add_argument("--port", type=int, default=0)
        sp.add_argument("--config", default="")
        if name in ("start-server", "start-broker"):
            sp.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
        sp.set_defaults(fn=cmd_start_role)
    role("start-controller")
    role("start-server")
    role("start-broker")

    sp = sub.add_parser("start-service-manager")
    sp.add_argument("--work-dir", required=True)
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--config", default="")
    sp.add_argument("--device", default="cuda", help="the server's device: cuda or cpu")
    sp.set_defaults(fn=cmd_start_service_manager)

    def with_controller(name, fn, *extra):
        sp = sub.add_parser(name)
        sp.add_argument("--controller", required=True)
        for flag, kw in extra:
            sp.add_argument(flag, **kw)
        sp.set_defaults(fn=fn)
        return sp

    table = ("--table", {"required": True})
    with_controller("add-schema", cmd_add_schema, ("--file", {"required": True}))
    with_controller("add-table", cmd_add_table, ("--file", {"required": True}),
                    ("--num-partitions", {"type": int, "default": 1}))
    with_controller("list-tables", cmd_list_tables)
    with_controller("table-status", cmd_table_status, table)
    with_controller("upload-segment", cmd_upload_segment, table,
                    ("--dir", {"required": True}))
    with_controller("reload-table", cmd_reload_table, table)
    with_controller("cluster-info", cmd_cluster_info)
    with_controller("list-tenants", cmd_list_tenants)
    with_controller("tag-instance", cmd_tag_instance, ("--instance", {"required": True}),
                    ("--tags", {"required": True, "help": "comma-separated"}))
    with_controller("rebalance-table", cmd_rebalance_table, table)
    with_controller("change-table-state", cmd_change_table_state, table,
                    ("--state", {"required": True, "choices": ["enable", "disable"]}))
    with_controller("cluster-config", cmd_cluster_config,
                    ("--set", {"default": None, "help": "key=value (omit to list)"}),
                    ("--delete", {"default": None, "help": "key to delete"}))
    with_controller("drop-table", cmd_drop_table,
                    ("--table", {"required": True, "help": "table name with type"}))
    with_controller("pause-consumption", cmd_pause_consumption, table)
    with_controller("resume-consumption", cmd_resume_consumption, table)

    sp = sub.add_parser("build-segment")
    sp.add_argument("--schema", required=True)
    sp.add_argument("--input", required=True)
    sp.add_argument("--format", default="")
    sp.add_argument("--out", required=True)
    sp.add_argument("--name", required=True)
    sp.set_defaults(fn=cmd_build_segment)

    sp = sub.add_parser("query")
    sp.add_argument("--broker", required=True)
    sp.add_argument("--sql", required=True)
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("dump-segment")
    sp.add_argument("--dir", required=True)
    sp.add_argument("--rows", type=int, default=10)
    sp.set_defaults(fn=cmd_dump_segment)

    sp = sub.add_parser("verify-segment")
    sp.add_argument("--dir", required=True)
    sp.set_defaults(fn=cmd_verify_segment)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    import os
    token = os.environ.get("PINOT_TPU_AUTH_TOKEN")
    if token:   # the bearer identity of every remote call this run makes
        from ..cluster.http_service import set_default_token
        set_default_token(token)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    # end quietly when the downstream pipe closes (`... | head`)
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    sys.exit(main())
