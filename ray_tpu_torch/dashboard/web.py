# Copied from ray_tpu/dashboard/web.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Minimal dashboard web UI.

Reference: dashboard/client/src/App.tsx — a React SPA over the dashboard
REST API. Here: ONE static page, zero build step, vanilla JS polling the
same REST endpoints this package already serves (`/api/nodes`,
`/api/actors`, `/api/jobs`, `/api/events`, `/api/cluster_status`,
`/api/node_stats`) and rendering stat tiles, tables, and inline-SVG
sparklines (client-side history). The tables ARE the accessible data
view; sparkline colors come from a CVD-validated palette; node/actor
state is never color-alone (dot + text label).

The reference's TPU tile and column read GPU here: the tile from
``/api/cluster_status`` and the column from each node's resources in
``/api/nodes`` (the port's agent publishes no GPU section in its node
stats).
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>ray_tpu_torch dashboard</title>
<style>
  :root {
    color-scheme: light;
    --surface-1: #fcfcfb; --surface-2: #f1f1ef;
    --text-primary: #0b0b0b; --text-secondary: #52514e;
    --border: #dddcd8;
    --series-1: #2a78d6; --series-2: #eb6834; --series-3: #1baf7a;
    --good: #008300; --warning: #eda100; --critical: #e34948;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      color-scheme: dark;
      --surface-1: #1a1a19; --surface-2: #242422;
      --text-primary: #ffffff; --text-secondary: #c3c2b7;
      --border: #3a3a37;
      --series-1: #3987e5; --series-2: #d95926; --series-3: #199e70;
      --good: #199e70; --warning: #c98500; --critical: #e66767;
    }
  }
  body { margin: 0; background: var(--surface-1); color: var(--text-primary);
         font: 14px/1.45 system-ui, sans-serif; }
  header { padding: 14px 20px; border-bottom: 1px solid var(--border);
           display: flex; align-items: baseline; gap: 14px; }
  header h1 { font-size: 17px; margin: 0; }
  header .sub { color: var(--text-secondary); font-size: 12px; }
  main { padding: 16px 20px; max-width: 1200px; margin: 0 auto; }
  .tiles { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 20px; }
  .tile { background: var(--surface-2); border: 1px solid var(--border);
          border-radius: 8px; padding: 10px 16px; min-width: 120px; }
  .tile .v { font-size: 26px; font-weight: 600; font-variant-numeric:
             tabular-nums; }
  .tile .k { color: var(--text-secondary); font-size: 12px; }
  section { margin-bottom: 26px; }
  h2 { font-size: 14px; margin: 0 0 8px; }
  table { border-collapse: collapse; width: 100%; }
  th { text-align: left; color: var(--text-secondary); font-weight: 500;
       font-size: 12px; border-bottom: 1px solid var(--border);
       padding: 4px 10px 4px 0; }
  td { padding: 5px 10px 5px 0; border-bottom: 1px solid var(--border);
       font-variant-numeric: tabular-nums; vertical-align: middle; }
  .dot { display: inline-block; width: 8px; height: 8px; border-radius: 50%;
         margin-right: 6px; }
  .muted { color: var(--text-secondary); }
  .spark { vertical-align: middle; margin-right: 6px; }
  .err { color: var(--critical); padding: 8px 0; display: none; }
  code { background: var(--surface-2); padding: 1px 5px; border-radius: 4px; }
</style>
</head>
<body>
<header>
  <h1>ray_tpu_torch</h1>
  <span class="sub" id="updated">connecting…</span>
</header>
<main>
  <div class="err" id="err"></div>
  <div class="tiles" id="tiles"></div>
  <section><h2>Nodes</h2>
    <table id="nodes"><thead><tr>
      <th>State</th><th>Node</th><th>CPU %</th><th>Memory</th>
      <th>Workers</th><th>GPU in use</th><th>Object store</th>
    </tr></thead><tbody></tbody></table></section>
  <section><h2>Actors</h2>
    <table id="actors"><thead><tr>
      <th>State</th><th>Name</th><th>Class</th><th>Actor ID</th><th>Node</th>
    </tr></thead><tbody></tbody></table></section>
  <section><h2>Jobs</h2>
    <table id="jobs"><thead><tr>
      <th>Status</th><th>Job</th><th>Entrypoint</th><th>Submitted</th>
    </tr></thead><tbody></tbody></table></section>
  <section><h2>Recent events</h2>
    <table id="events"><thead><tr>
      <th>Severity</th><th>Time</th><th>Source</th><th>Message</th>
    </tr></thead><tbody></tbody></table></section>
</main>
<script>
"use strict";
const HIST = {};           // node_id -> {cpu: [], mem: []}
const HLEN = 60;           // one sparkline point per poll, ~2 min window
const esc = s => String(s ?? "").replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));

function spark(values, color, label) {
  if (!values || values.length < 2) return "";
  const w = 90, h = 20, max = Math.max(...values, 1e-9);
  const pts = values.map((v, i) =>
    `${(i / (values.length - 1) * w).toFixed(1)},` +
    `${(h - 2 - (v / max) * (h - 4)).toFixed(1)}`).join(" ");
  return `<svg class="spark" width="${w}" height="${h}" role="img"` +
    ` aria-label="${esc(label)}"><title>${esc(label)}</title>` +
    `<polyline points="${pts}" fill="none" stroke="${color}"` +
    ` stroke-width="2" stroke-linejoin="round"/></svg>`;
}

function dot(state) {
  const m = {ALIVE: "--good", RUNNING: "--good", SUCCEEDED: "--good",
             PENDING: "--warning", RESTARTING: "--warning",
             STOPPED: "--warning", DEAD: "--critical",
             FAILED: "--critical"};
  const v = m[state] || "--text-secondary";
  return `<span class="dot" style="background: var(${v})"></span>` +
         `${esc(state || "?")}`;
}

const fmtGB = b => (b / 2 ** 30).toFixed(1) + " GiB";

async function jget(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(path + " -> " + r.status);
  return r.json();
}

function tiles(nodes, actors, jobs, cluster) {
  const total = cluster.total || {}, avail = cluster.available || {};
  const cpuT = total.CPU || 0, cpuA = avail.CPU || 0;
  const gpuT = total.GPU || 0, gpuA = avail.GPU || 0;
  const t = [
    [nodes.filter(n => n.alive !== false).length, "nodes alive"],
    [actors.length, "actors"],
    [jobs.filter(j => (j.status || "") === "RUNNING").length,
     "jobs running"],
    [`${(cpuT - cpuA).toFixed(0)}/${cpuT.toFixed(0)}`, "CPU in use"],
  ];
  if (gpuT > 0) t.push([`${(gpuT - gpuA).toFixed(0)}/${gpuT.toFixed(0)}`,
                        "GPUs in use"]);
  document.getElementById("tiles").innerHTML = t.map(([v, k]) =>
    `<div class="tile"><div class="v">${esc(v)}</div>` +
    `<div class="k">${esc(k)}</div></div>`).join("");
}

function nodeRows(nodes, stats) {
  const byId = Object.fromEntries(stats.map(s => [s.node_id, s]));
  document.querySelector("#nodes tbody").innerHTML = nodes.map(n => {
    const id = n.node_id || "", s = byId[id] || {};
    const h = HIST[id] = HIST[id] || {cpu: [], mem: []};
    if (s.cpu_percent !== undefined) {
      h.cpu.push(s.cpu_percent); h.mem.push(s.mem_percent || 0);
      if (h.cpu.length > HLEN) { h.cpu.shift(); h.mem.shift(); }
    }
    const gT = (n.resources_total || {}).GPU || 0;
    const gA = (n.resources_available || {}).GPU || 0;
    return `<tr><td>${dot(n.alive === false ? "DEAD" : "ALIVE")}</td>` +
      `<td><code>${esc(id.slice(0, 12))}</code></td>` +
      `<td>${spark(h.cpu, "var(--series-1)",
                   "CPU history " + esc(id.slice(0, 8)))}` +
      `${s.cpu_percent !== undefined ? s.cpu_percent.toFixed(0) : "–"}</td>` +
      `<td>${spark(h.mem, "var(--series-2)",
                   "memory history " + esc(id.slice(0, 8)))}` +
      `${s.mem_used_bytes ? fmtGB(s.mem_used_bytes) + " / " +
        fmtGB(s.mem_total_bytes) : "–"}</td>` +
      `<td>${s.num_workers ?? "–"}</td>` +
      `<td>${gT ? `${+(gT - gA).toFixed(2)}/${gT}` : "–"}</td>` +
      `<td>${s.object_store && s.object_store.used !== undefined
             ? fmtGB(s.object_store.used) : "–"}</td></tr>`;
  }).join("");
}

function actorRows(actors) {
  document.querySelector("#actors tbody").innerHTML =
    actors.slice(0, 200).map(a =>
      `<tr><td>${dot(a.state)}</td><td>${esc(a.name || "")}</td>` +
      `<td>${esc(a.class_name || "")}</td>` +
      `<td><code>${esc((a.actor_id || "").slice(0, 12))}</code></td>` +
      `<td><code>${esc((a.node_id || "").slice(0, 12))}</code></td></tr>`
    ).join("");
}

function jobRows(jobs) {
  document.querySelector("#jobs tbody").innerHTML = jobs.map(j =>
    `<tr><td>${dot(j.status)}</td>` +
    `<td><code>${esc(j.submission_id || j.job_id || "")}</code></td>` +
    `<td class="muted">${esc(j.entrypoint || "")}</td>` +
    `<td class="muted">${j.start_time
      ? new Date(j.start_time * 1000).toLocaleTimeString() : ""}</td></tr>`
  ).join("");
}

function sevDot(sev) {
  const v = {ERROR: "--critical", FATAL: "--critical",
             WARNING: "--warning"}[sev] || "--good";
  return `<span class="dot" style="background: var(${v})"></span>` +
         `${esc(sev || "INFO")}`;
}

function eventRows(events) {
  document.querySelector("#events tbody").innerHTML =
    events.slice(-50).reverse().map(e =>
      `<tr><td>${sevDot(e.severity)}</td>` +
      `<td class="muted">${e.timestamp
        ? new Date(e.timestamp * 1000).toLocaleTimeString() : ""}</td>` +
      `<td>${esc(e.source_type || e.component || "")}</td>` +
      `<td>${esc(e.message || "")}</td></tr>`).join("");
}

async function tick() {
  try {
    const [nodes, actors, jobs, events, cluster, stats] =
      await Promise.all([
        jget("/api/nodes"), jget("/api/actors"), jget("/api/jobs"),
        jget("/api/events"), jget("/api/cluster_status"),
        jget("/api/node_stats")]);
    tiles(nodes, actors, jobs, cluster);
    nodeRows(nodes, stats);
    actorRows(actors);
    jobRows(jobs);
    eventRows(events);
    document.getElementById("err").style.display = "none";
    document.getElementById("updated").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    const el = document.getElementById("err");
    el.textContent = "dashboard poll failed: " + e;
    el.style.display = "block";
  }
}
tick();
setInterval(tick, 2000);
</script>
</body>
</html>
"""
