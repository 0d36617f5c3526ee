# Copied from ray_tpu/dashboard/grafana.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Grafana dashboard factory.

Reference: dashboard/modules/metrics/metrics_head.py — Ray ships generated
Grafana dashboard JSON (default_grafana_dashboard, serve/data dashboards)
wired to its Prometheus metrics. Here the factory emits dashboards over
the gauges this framework's agents publish (`ray_tpu_node_cpu_percent`,
`ray_tpu_node_mem_*`, `ray_tpu_resource_in_use`,
`ray_tpu_object_store_used_bytes`, … — `_private/agent.py` node-stats
loop + `util/metrics.py` user metrics) so a stock Grafana + Prometheus
pair pointed at `/metrics` shows the cluster with zero hand-editing.

The port's agent exports the reference's metric names unchanged, so the
core dashboard is the reference's, JSON for JSON. The reference's TPU
dashboard becomes :func:`generate_gpu_dashboard`: its leasing panel reads
``ray_tpu_resource_in_use{resource="GPU"}``. The reference's duty-cycle
panel has no counterpart: the port's agent publishes no GPU duty gauge.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

GRAFANA_SCHEMA_VERSION = 39
DATASOURCE_VAR = "${datasource}"


def _panel(panel_id: int, title: str, exprs: List[Dict], *,
           unit: str = "short", grid: Dict, stack: bool = False) -> Dict:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "datasource": {"type": "prometheus", "uid": DATASOURCE_VAR},
        "gridPos": grid,
        "fieldConfig": {
            "defaults": {
                "unit": unit,
                "custom": {
                    "drawStyle": "line",
                    "lineWidth": 2,
                    "fillOpacity": 10 if stack else 0,
                    "stacking": {"mode": "normal" if stack else "none"},
                    "showPoints": "never",
                },
            },
            "overrides": [],
        },
        "options": {
            "legend": {"displayMode": "list", "placement": "bottom"},
            "tooltip": {"mode": "multi"},
        },
        "targets": [
            {"expr": e["expr"], "legendFormat": e.get("legend", ""),
             "refId": chr(ord("A") + i)}
            for i, e in enumerate(exprs)
        ],
    }


def generate_core_dashboard() -> Dict:
    """Cluster-health dashboard: CPU/memory/workers/object-store/TPU per
    node plus scrape liveness."""
    half = {"w": 12, "h": 8}
    panels = [
        _panel(1, "Node CPU utilization",
               [{"expr": "ray_tpu_node_cpu_percent",
                 "legend": "{{node_id}}"}],
               unit="percent", grid={"x": 0, "y": 0, **half}),
        _panel(2, "Node memory used",
               [{"expr": "ray_tpu_node_mem_used_bytes",
                 "legend": "{{node_id}} used"},
                {"expr": "ray_tpu_node_mem_total_bytes",
                 "legend": "{{node_id}} total"}],
               unit="bytes", grid={"x": 12, "y": 0, **half}),
        _panel(3, "TPU chips leased (fraction)",
               [{"expr": "ray_tpu_tpu_utilization",
                 "legend": "{{node_id}}"}],
               unit="percentunit", grid={"x": 0, "y": 8, **half}),
        _panel(4, "Workers per node",
               [{"expr": "ray_tpu_node_workers",
                 "legend": "{{node_id}}"}],
               grid={"x": 12, "y": 8, **half}, stack=True),
        _panel(5, "Object store used",
               [{"expr": "ray_tpu_object_store_used_bytes",
                 "legend": "{{node_id}}"}],
               unit="bytes", grid={"x": 0, "y": 16, **half}, stack=True),
        _panel(6, "Scrape liveness",
               [{"expr": "ray_tpu_cluster_up", "legend": "up"}],
               grid={"x": 12, "y": 16, **half}),
    ]
    return _dashboard("ray_tpu core", "raytpu-core", panels,
                      tags=["ray_tpu", "core"])


def generate_gpu_dashboard() -> Dict:
    """GPU-focused dashboard: the cards leased on each node — the panel a
    GPU-cluster operator watches first."""
    half = {"w": 12, "h": 8}
    panels = [
        _panel(1, "GPUs leased",
               [{"expr": 'ray_tpu_resource_in_use{resource="GPU"}',
                 "legend": "{{node_id}}"}],
               grid={"x": 0, "y": 0, **half}),
    ]
    return _dashboard("ray_tpu GPU", "raytpu-gpu", panels,
                      tags=["ray_tpu", "gpu"])


def _dashboard(title: str, uid: str, panels: List[Dict],
               tags: Optional[List[str]] = None) -> Dict:
    return {
        "uid": uid,
        "title": title,
        "tags": tags or [],
        "schemaVersion": GRAFANA_SCHEMA_VERSION,
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource",
            "label": "Data source",
            "type": "datasource",
            "query": "prometheus",
        }]},
        "panels": panels,
    }


def save_grafana_dashboards(out_dir: str) -> List[str]:
    """Write every generated dashboard + a provisioning config into
    ``out_dir`` (what `ray_tpu.init` drops in the session dir, the way the
    reference's metrics_head writes grafana/dashboards into the temp dir)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for dash in (generate_core_dashboard(), generate_gpu_dashboard()):
        path = os.path.join(out_dir, f"{dash['uid']}.json")
        with open(path, "w") as f:
            json.dump(dash, f, indent=2, sort_keys=True)
        paths.append(path)
    prov = {
        "apiVersion": 1,
        "providers": [{
            "name": "ray_tpu",
            "folder": "ray_tpu",
            "type": "file",
            "options": {"path": os.path.abspath(out_dir)},
        }],
    }
    prov_path = os.path.join(out_dir, "provisioning.json")
    with open(prov_path, "w") as f:
        json.dump(prov, f, indent=2, sort_keys=True)
    paths.append(prov_path)
    return paths
