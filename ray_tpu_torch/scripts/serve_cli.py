"""``ray-tpu serve …`` subcommands (reference: ray ``serve/scripts.py`` —
``serve deploy/status/shutdown``)."""

from __future__ import annotations

import json


def _connect(args):
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(address=args.address or "auto")


def cmd_serve_deploy(args) -> int:
    import ray_tpu_torch.serve as serve

    _connect(args)
    with open(args.config) as f:
        if args.config.endswith((".yaml", ".yml")):
            # Reference serve configs are YAML (ray serve/schema.py);
            # JSON stays the dependency-free default.
            import yaml

            config = yaml.safe_load(f)
        else:
            config = json.load(f)
    handles = serve.deploy_config(config)
    print(f"deployed: {sorted(handles)}")
    if args.http_port:
        url = serve.start_http_proxy(port=args.http_port)
        print(f"http proxy at {url}")
        import time

        while True:  # keep proxy alive in foreground
            time.sleep(3600)
    return 0


def cmd_serve_status(args) -> int:
    import ray_tpu_torch.serve as serve

    _connect(args)
    print(json.dumps(serve.status(), indent=2, default=str))
    return 0


def cmd_serve_shutdown(args) -> int:
    import ray_tpu_torch.serve as serve

    _connect(args)
    serve.shutdown()
    print("serve shut down")
    return 0


def register(sub) -> None:
    serve = sub.add_parser("serve", help="model serving").add_subparsers(
        dest="serve_cmd", required=True
    )

    p = serve.add_parser("deploy", help="deploy applications from a JSON config")
    p.add_argument("config")
    p.add_argument("--address", default=None)
    p.add_argument("--http-port", type=int, default=None,
                   help="also start an HTTP proxy and block")
    p.set_defaults(fn=cmd_serve_deploy)

    p = serve.add_parser("status")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_serve_status)

    p = serve.add_parser("shutdown")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_serve_shutdown)
