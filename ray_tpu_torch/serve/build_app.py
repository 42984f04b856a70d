"""Declarative app deployment from config files (counterpart of
`ray_tpu/serve/build_app.py`).

Parity: `serve deploy config.yaml` + `python/ray/serve/schema.py` /
`build_app.py` — a YAML/dict schema describing applications resolves import
paths, applies deployment overrides, and runs them. CLI: `python -m
ray_tpu_torch.scripts.cli serve deploy <config.yaml>` / `serve status` /
`serve shutdown`.

Schema (reference-shaped subset):

```yaml
applications:
  - name: app1
    route_prefix: /app1
    import_path: mypkg.mymodule:app       # Deployment or builder()
    args: {key: value}                    # passed to a builder callable
    deployments:                          # per-deployment overrides
      - name: Greeter
        num_replicas: 3
        max_ongoing_requests: 16
        compiled: true                    # proxies serve this deployment
        chain_config: {lanes: 4}          # over CompiledServeChain rings
```

Overrides map straight onto `Deployment.options(**opts)`, so every
dataclass field works — including `compiled`/`chain_config`, which flip
the deployment onto the proxies' compiled ingress (ring channels, lanes
spread across replicas; serve/compiled_chain.py).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional


def _resolve_import(path: str):
    mod_name, _, attr = path.partition(":")
    if not attr:
        raise ValueError(f"import_path {path!r} must be 'module:attr'")
    mod = importlib.import_module(mod_name)
    target = mod
    for part in attr.split("."):
        target = getattr(target, part)
    return target


def build_app(app_cfg: Dict[str, Any]):
    """Resolve one application entry to a bound Deployment."""
    from ray_tpu_torch.serve.api import Deployment

    target = _resolve_import(app_cfg["import_path"])
    if isinstance(target, Deployment):
        app = target
    elif callable(target):
        app = target(**(app_cfg.get("args") or {}))
    else:
        raise TypeError(f"{app_cfg['import_path']} resolved to {type(target)}; "
                        "expected a Deployment or a builder callable")
    for override in app_cfg.get("deployments") or []:
        oname = override.get("name")
        if oname not in (None, app.name):
            raise ValueError(
                f"deployment override names {oname!r} but the application's "
                f"deployment is {app.name!r}")
        opts = {k: v for k, v in override.items() if k != "name"}
        app = app.options(**opts)
    return app


def deploy_config(config: Dict[str, Any]) -> List[str]:
    """Deploy every application in a parsed config; returns app names."""
    from ray_tpu_torch.serve import api

    if not isinstance(config, dict) or "applications" not in config:
        raise ValueError("config must be a mapping with an 'applications' "
                         "list (got empty or malformed config)")
    deployed = []
    for app_cfg in config.get("applications", []):
        app = build_app(app_cfg)
        api.run(app, name=app_cfg.get("name"),
                route_prefix=app_cfg.get("route_prefix"))
        deployed.append(app_cfg.get("name") or app.name)
    return deployed


def deploy_config_file(path: str) -> List[str]:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "deploying from YAML needs pyyaml (pip install pyyaml); "
            "alternatively call deploy_config() with a parsed dict") from e

    import os
    import sys

    with open(path) as f:
        config = yaml.safe_load(f)
    # apps typically live next to their config; make them importable the
    # way the reference CLI does
    cfg_dir = os.path.dirname(os.path.abspath(path))
    for p in (cfg_dir, os.getcwd()):
        if p not in sys.path:
            sys.path.insert(0, p)
    return deploy_config(config)
