"""Single-file dashboard UI over the JSON state API.

Reference scope: ray's dashboard ships a 24k-LoC React frontend
(``python/ray/dashboard/client``); the operational core of it — cluster
resources, nodes, actors, tasks, placement groups, jobs — is a handful of
auto-refreshing tables over the same state endpoints this process already
serves.  One dependency-free HTML page keeps the build toolchain at zero
while giving operators a live view (the timeline still exports
Chrome-trace JSON via ``/api/timeline`` for chrome://tracing).
"""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>ray_tpu_torch dashboard</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1.5rem; background: #fafafa; color: #222; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin: 1.2rem 0 .4rem; }
  .cards { display: flex; gap: .8rem; flex-wrap: wrap; }
  .card { background: #fff; border: 1px solid #e2e2e2; border-radius: 8px;
          padding: .7rem 1rem; min-width: 9rem; }
  .card .v { font-size: 1.4rem; font-weight: 600; }
  .card .k { color: #666; font-size: .8rem; }
  table { border-collapse: collapse; width: 100%; background: #fff;
          border: 1px solid #e2e2e2; font-size: .85rem; }
  th, td { text-align: left; padding: .35rem .6rem; border-bottom: 1px solid #eee; }
  th { background: #f3f3f3; position: sticky; top: 0; }
  .state-ALIVE, .state-RUNNING, .state-CREATED, .state-FINISHED { color: #0a7d32; }
  .state-DEAD, .state-FAILED, .state-REMOVED { color: #b3261e; }
  .state-PENDING_CREATION, .state-PENDING, .state-RESTARTING { color: #9a6b00; }
  #err { color: #b3261e; }
  .muted { color: #888; font-size: .8rem; }
</style>
</head>
<body>
<h1>ray_tpu_torch dashboard <span class="muted" id="ts"></span> <span id="err"></span></h1>
<div class="cards" id="cards"></div>
<h2>SLO violations</h2><div id="slo"></div>
<h2>Remediation</h2><div id="remediation"></div>
<h2>Nodes</h2><div id="nodes"></div>
<h2>Actors</h2><div id="actors"></div>
<h2>Placement groups</h2><div id="pgs"></div>
<h2>Jobs</h2><div id="jobs"></div>
<h2>Recent tasks</h2><div id="tasks"></div>
<p class="muted">JSON API: /api/cluster /api/nodes /api/actors /api/tasks
/api/jobs /api/placement_groups /api/timeline (chrome://tracing;
?cluster=1 for the stitched cluster trace) /api/slo /metrics
(Prometheus)</p>
<script>
async function j(u) { const r = await fetch(u); return r.json(); }
function esc(x) { return String(x).replace(/[&<>]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;'}[c])); }
function table(rows, cols) {
  if (!rows || !rows.length) return '<p class="muted">none</p>';
  let h = '<table><tr>' + cols.map(c => `<th>${esc(c)}</th>`).join('') + '</tr>';
  for (const r of rows.slice(0, 200)) {
    h += '<tr>' + cols.map(c => {
      let v = r[c]; if (v === undefined || v === null) v = '';
      if (typeof v === 'object') v = JSON.stringify(v);
      const cls = (c === 'state' || c === 'alive') ? ` class="state-${esc(v)}"` : '';
      return `<td${cls}>${esc(v)}</td>`;
    }).join('') + '</tr>';
  }
  return h + '</table>';
}
function card(k, v) {
  return `<div class="card"><div class="v">${esc(v)}</div><div class="k">${esc(k)}</div></div>`;
}
function fmtRes(o) {
  return Object.entries(o || {}).map(([k, v]) => `${k}: ${Math.round(v * 100) / 100}`).join('  ');
}
async function refresh() {
  try {
    const [cluster, nodes, actors, pgs, jobs, tasks, slo] = await Promise.all([
      j('/api/cluster'), j('/api/nodes'), j('/api/actors'),
      j('/api/placement_groups'), j('/api/jobs'), j('/api/tasks?limit=60'),
      j('/api/slo'),
    ]);
    document.getElementById('cards').innerHTML =
      card('nodes alive', `${cluster.nodes_alive}/${cluster.nodes_total}`) +
      card('jobs running', cluster.jobs_running) +
      card('available', fmtRes(cluster.resources_available) || '-') +
      card('total', fmtRes(cluster.resources_total) || '-') +
      Object.entries(cluster.actors_by_state || {}).map(
        ([s, n]) => card('actors ' + s, n)).join('');
    document.getElementById('slo').innerHTML =
      (slo.violations && slo.violations.length)
        ? table(slo.violations,
                ['rule', 'subject', 'value', 'threshold', 'ongoing',
                 'detail'])
        : `<p class="muted">none (${(slo.rules || []).join(', ')})</p>`;
    const rem = slo.remediation;
    const quarantined = rem && rem.quarantined
      ? Object.entries(rem.quarantined) : [];
    document.getElementById('remediation').innerHTML = !rem
      ? '<p class="muted">no remediation controller attached</p>'
      : (quarantined.length
          ? '<p><b>QUARANTINED</b> (self-healing stopped; human needed): '
            + quarantined.map(([t, e]) =>
                `${esc(t)} — ${esc(e.reason || '')}`).join('; ') + '</p>'
          : '') +
        ((rem.actions && rem.actions.length)
          ? table(rem.actions.slice(-20),
                  ['rule', 'action', 'target', 'outcome', 'detail'])
          : '<p class="muted">no actions taken'
            + ` (beats: ${rem.beats || 0})</p>`);
    document.getElementById('nodes').innerHTML =
      table(nodes, ['node_id', 'alive', 'total', 'available', 'idle_s']);
    document.getElementById('actors').innerHTML =
      table(actors, ['actor_id', 'name', 'state', 'address', 'incarnation']);
    document.getElementById('pgs').innerHTML =
      table(pgs, ['pg_id', 'state', 'strategy', 'bundles']);
    document.getElementById('jobs').innerHTML =
      table(jobs, ['job_id', 'state', 'driver_address']);
    document.getElementById('tasks').innerHTML =
      table(tasks, ['task_id', 'name', 'state', 'node_id', 'attempt']);
    document.getElementById('ts').textContent =
      'updated ' + new Date().toLocaleTimeString();
    document.getElementById('err').textContent = '';
  } catch (e) {
    document.getElementById('err').textContent = ' (refresh failed: ' + e + ')';
  }
}
async function loop() {
  // Re-arm only after the round completes: refresh cycles must never
  // stack up against a slow state API.
  try { await refresh(); } finally { setTimeout(loop, 2000); }
}
loop();
</script>
</body>
</html>
"""
