"""Embedded web console.

Behavioral reference: upstream NornicDB ui/ — a React SPA (query console,
AI assistant, login at ui/src/pages/Login.tsx, user admin at
AdminUsers.tsx, security/API-token page at Security.tsx) embedded via
go:embed; headless builds exclude it (-tags noui). This build embeds a
single-file SPA (no build step, no dependencies) with the same views:
login (cookie session via POST /auth/token), Cypher console, hybrid
search, Heimdall chat, admin (user management + live server stats), and
security (change password, generate API tokens) — all speaking the same
HTTP endpoints as the reference UI's utils/api.ts.

Browser-parity affordances (ref: ui/src/pages/Browser.tsx Edit/Trash/
History + DB switcher): query history in localStorage (click to restore,
clear), per-node edit/delete buttons on node-shaped result cells (edit
prompts for a properties JSON then issues `SET n = $props` by id; delete
issues DETACH DELETE), and a database switcher in the header populated
from SHOW DATABASES that retargets /db/{name}/tx/commit.

The port's copy of ``nornicdb_tpu/server/ui.py``.
"""

UI_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>NornicDB-TPU Console</title>
<style>
  :root { --bg:#11151c; --panel:#1a2029; --fg:#d8dee9; --accent:#5fb3b3;
          --muted:#6c7a89; --err:#bf616a; --ok:#a3be8c; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:14px/1.5 ui-monospace, Menlo, monospace; }
  header { padding:12px 20px; border-bottom:1px solid #2a313c;
           display:flex; justify-content:space-between; align-items:center; }
  header b { color:var(--accent); }
  nav a { color:var(--muted); margin-right:14px; cursor:pointer;
          text-decoration:none; }
  nav a.active, nav a:hover { color:var(--accent); }
  #stats, #whoami { color:var(--muted); font-size:12px; }
  main { display:grid; grid-template-columns:1fr 1fr; gap:14px; padding:14px; }
  section { background:var(--panel); border-radius:8px; padding:14px; }
  section.wide { grid-column: 1 / span 2; }
  h2 { margin:0 0 10px; font-size:13px; color:var(--accent);
       text-transform:uppercase; letter-spacing:1px; }
  textarea, input, select { width:100%; background:#0d1117; color:var(--fg);
      border:1px solid #2a313c; border-radius:6px; padding:8px;
      font:inherit; }
  textarea { min-height:72px; resize:vertical; }
  button { margin-top:8px; background:var(--accent); color:#0d1117;
      border:0; border-radius:6px; padding:7px 16px; font:inherit;
      font-weight:bold; cursor:pointer; }
  button.small { margin:0; padding:2px 8px; font-weight:normal; }
  button.danger { background:var(--err); color:#fff; }
  pre { background:#0d1117; border-radius:6px; padding:10px; overflow:auto;
        max-height:320px; white-space:pre-wrap; }
  .err { color:var(--err); }
  .ok { color:var(--ok); }
  table { border-collapse:collapse; width:100%; }
  td, th { border:1px solid #2a313c; padding:4px 8px; text-align:left; }
  th { color:var(--accent); }
  #login-view { max-width:360px; margin:80px auto; }
  #login-view input { margin-bottom:10px; }
  .hidden { display:none !important; }
  .row { display:flex; gap:8px; align-items:center; }
</style>
</head>
<body>
<header>
  <div><b>NornicDB-TPU</b> console</div>
  <nav id="nav" class="hidden">
    <a data-view="console" href="/" onclick="return go(event,'console')">Console</a>
    <a data-view="admin" href="/admin" onclick="return go(event,'admin')">Admin</a>
    <a data-view="security" href="/security" onclick="return go(event,'security')">Security</a>
  </nav>
  <div class="row">
    <select id="db-select" class="hidden" style="width:auto"
            onchange="switchDb(this.value)"></select>
    <div id="whoami"></div>
    <button id="logout-btn" class="small hidden" onclick="logout()">logout</button>
    <div id="stats">loading…</div>
  </div>
</header>

<div id="login-view" class="hidden">
  <section>
    <h2>Sign in</h2>
    <input id="login-user" placeholder="username" autocomplete="username">
    <input id="login-pass" placeholder="password" type="password"
           autocomplete="current-password">
    <button onclick="doLogin()">Sign in</button>
    <div id="login-oauth"></div>
    <pre id="login-err" class="err hidden"></pre>
  </section>
</div>

<main id="console-view" class="hidden">
  <section class="wide">
    <h2>Cypher</h2>
    <textarea id="cypher">MATCH (n) RETURN n LIMIT 10</textarea>
    <div class="row">
      <button onclick="runCypher()">Run (Ctrl-Enter)</button>
      <button class="small" onclick="toggleHistory()">History</button>
    </div>
    <div id="history-panel" class="hidden">
      <div class="row" style="justify-content:space-between">
        <h2 style="margin:10px 0 4px">Query history</h2>
        <button class="small danger" onclick="clearHistory()">clear</button>
      </div>
      <div id="history-list"></div>
    </div>
    <pre id="cypher-out"></pre>
  </section>
  <section>
    <h2>Hybrid search</h2>
    <input id="q" placeholder="semantic + fulltext query">
    <button onclick="runSearch()">Search</button>
    <pre id="search-out"></pre>
  </section>
  <section>
    <h2>Heimdall</h2>
    <input id="chat" placeholder="ask the assistant">
    <button onclick="runChat()">Send</button>
    <pre id="chat-out"></pre>
  </section>
</main>

<main id="admin-view" class="hidden">
  <section>
    <h2>Users</h2>
    <div id="users-table">loading…</div>
    <h2 style="margin-top:14px">Create user</h2>
    <div class="row">
      <input id="new-user" placeholder="username">
      <input id="new-pass" placeholder="password" type="password">
      <select id="new-role">
        <option>viewer</option><option>editor</option><option>admin</option>
      </select>
    </div>
    <button onclick="createUser()">Create</button>
    <pre id="admin-msg" class="hidden"></pre>
  </section>
  <section>
    <h2>Server stats</h2>
    <div id="admin-stats">loading…</div>
    <button onclick="loadStats()">Refresh</button>
  </section>
</main>

<main id="security-view" class="hidden">
  <section>
    <h2>Change password</h2>
    <input id="old-pass" placeholder="current password" type="password">
    <input id="new-pass2" placeholder="new password" type="password"
           style="margin-top:8px">
    <button onclick="changePassword()">Change</button>
    <pre id="pw-msg" class="hidden"></pre>
  </section>
  <section>
    <h2>Generate API token</h2>
    <input id="token-subject" placeholder="label, e.g. my-mcp-server">
    <select id="token-ttl" style="margin-top:8px">
      <option value="3600">1 hour</option>
      <option value="86400">1 day</option>
      <option value="2592000">30 days</option>
      <option value="31536000" selected>1 year</option>
    </select>
    <button onclick="genToken()">Generate</button>
    <pre id="token-out" class="hidden"></pre>
  </section>
</main>

<script>
let ME = null, AUTH_ON = false, DB = 'neo4j';

async function post(path, body) {
  const r = await fetch(path, {method:'POST', credentials:'include',
    headers:{'Content-Type':'application/json'}, body:JSON.stringify(body)});
  return r.json();
}
async function get(path) {
  const r = await fetch(path, {credentials:'include'});
  if (r.status === 401) throw new Error('unauthorized');
  return r.json();
}
function esc(s){return String(s).replace(/[&<>"']/g, c => ({
  '&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));}
function show(id){
  for (const v of ['login-view','console-view','admin-view','security-view'])
    document.getElementById(v).classList.add('hidden');
  document.getElementById(id).classList.remove('hidden');
}

function go(ev, view) {
  if (ev) ev.preventDefault();
  document.querySelectorAll('nav a').forEach(a =>
    a.classList.toggle('active', a.dataset.view === view));
  history.replaceState(null, '', {console:'/', admin:'/admin',
    security:'/security'}[view] || '/');
  show(view + '-view');
  if (view === 'admin') { loadUsers(); loadStats(); }
  return false;
}

async function boot() {
  let cfg = {securityEnabled: false, oauthProviders: []};
  try { cfg = await get('/auth/config'); } catch (e) {}
  AUTH_ON = cfg.securityEnabled;
  if (AUTH_ON) {
    try {
      ME = await get('/auth/me');
    } catch (e) {
      // not signed in -> login view
      const oa = document.getElementById('login-oauth');
      oa.innerHTML = (cfg.oauthProviders||[]).map(p =>
        `<button onclick="location='${p.url}'">${esc(p.displayName)}</button>`
      ).join('');
      show('login-view');
      return;
    }
  } else {
    ME = {username:'anonymous', roles:['admin']};
  }
  document.getElementById('nav').classList.remove('hidden');
  document.getElementById('whoami').innerText =
    ME.username + ' (' + (ME.roles||[]).join(',') + ')';
  if (AUTH_ON)
    document.getElementById('logout-btn').classList.remove('hidden');
  const isAdmin = (ME.roles||[]).includes('admin');
  document.querySelector('nav a[data-view=admin]')
    .classList.toggle('hidden', !isAdmin);
  const path = location.pathname;
  go(null, path === '/admin' && isAdmin ? 'admin'
        : path === '/security' ? 'security' : 'console');
  refreshStats();
  loadDatabases();
}

async function doLogin() {
  const errBox = document.getElementById('login-err');
  errBox.classList.add('hidden');
  const r = await fetch('/auth/token', {method:'POST', credentials:'include',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({
      username: document.getElementById('login-user').value,
      password: document.getElementById('login-pass').value})});
  if (!r.ok) {
    const e = await r.json().catch(() => ({error:'login failed'}));
    errBox.innerText = e.error || 'login failed';
    errBox.classList.remove('hidden');
    return;
  }
  await boot();
}

async function logout() {
  await post('/auth/logout', {});
  ME = null;
  document.getElementById('nav').classList.add('hidden');
  document.getElementById('logout-btn').classList.add('hidden');
  document.getElementById('whoami').innerText = '';
  show('login-view');
}

async function refreshStats() {
  try {
    const s = await get('/status');
    document.getElementById('stats').innerText =
      `${s.nodes} nodes · ${s.edges} edges · up ${Math.round(s.uptime_seconds)}s`;
  } catch (e) {}
}

// -- database switcher (ref: Browser.tsx DB selector) ------------------------
async function loadDatabases() {
  try {
    const r = await post(`/db/${DB}/tx/commit`,
      {statements:[{statement:'SHOW DATABASES'}]});
    const res = (r.results||[])[0];
    if (!res) return;
    const nameIdx = res.columns.indexOf('name');
    const sel = document.getElementById('db-select');
    sel.innerHTML = '';
    for (const row of res.data) {
      const o = document.createElement('option');
      o.value = o.text = row.row[nameIdx];
      o.selected = (o.value === DB);
      sel.add(o);
    }
    sel.classList.remove('hidden');
  } catch (e) {}
}
function switchDb(name) {
  DB = name;
  document.getElementById('cypher-out').innerHTML = '';
  refreshStats();
}

// -- query history (ref: Browser.tsx History affordance) ---------------------
const HIST_KEY = 'nornic_query_history', HIST_MAX = 50;
function loadHistory() {
  try { return JSON.parse(localStorage.getItem(HIST_KEY)) || []; }
  catch (e) { return []; }
}
function pushHistory(stmt) {
  stmt = stmt.trim();
  if (!stmt) return;
  const h = loadHistory().filter(q => q !== stmt);
  h.unshift(stmt);
  localStorage.setItem(HIST_KEY, JSON.stringify(h.slice(0, HIST_MAX)));
  renderHistory();
}
function clearHistory() {
  localStorage.removeItem(HIST_KEY);
  renderHistory();
}
function toggleHistory() {
  document.getElementById('history-panel').classList.toggle('hidden');
  renderHistory();
}
function renderHistory() {
  const box = document.getElementById('history-list');
  box.innerHTML = '';
  const h = loadHistory();
  if (!h.length) { box.innerText = '(empty)'; return; }
  for (const q of h) {
    const a = document.createElement('a');
    a.href = '#';
    a.style.display = 'block';
    a.style.color = 'var(--muted)';
    a.innerText = q.length > 120 ? q.slice(0, 120) + '…' : q;
    a.addEventListener('click', ev => {
      ev.preventDefault();
      document.getElementById('cypher').value = q;
    });
    box.appendChild(a);
  }
}

// -- node affordances in results (ref: Browser.tsx Edit/Trash) ---------------
function isNodeValue(v) {
  return v && typeof v === 'object' && !Array.isArray(v) &&
    typeof v.id === 'string' && Array.isArray(v.labels) &&
    typeof v.properties === 'object';
}
function txFailed(r) {
  // the tx API reports statement failures in errors[]; auth/transport
  // failures come back as {error: ...} — surface either, never swallow
  if (r && r.errors && r.errors.length) return r.errors[0].message;
  if (r && r.error) return r.error;
  return null;
}
async function editNode(node) {
  const txt = prompt('properties JSON for (' + node.labels.join(':') + ')',
                     JSON.stringify(node.properties));
  if (txt === null) return;
  let props;
  try { props = JSON.parse(txt); }
  catch (e) { alert('invalid JSON: ' + e); return; }
  const r = await post(`/db/${DB}/tx/commit`, {statements:[{
    statement: 'MATCH (n) WHERE id(n) = $id SET n = $props',
    parameters: {id: node.id, props}}]});
  const err = txFailed(r);
  if (err) { alert('edit failed: ' + err); return; }
  runCypher(true);
}
async function deleteNode(node) {
  if (!confirm('DETACH DELETE node ' + node.id + '?')) return;
  const r = await post(`/db/${DB}/tx/commit`, {statements:[{
    statement: 'MATCH (n) WHERE id(n) = $id DETACH DELETE n',
    parameters: {id: node.id}}]});
  const err = txFailed(r);
  if (err) { alert('delete failed: ' + err); return; }
  runCypher(true);
}

async function runCypher(rerun) {
  const out = document.getElementById('cypher-out');
  const stmt = document.getElementById('cypher').value;
  if (!rerun) pushHistory(stmt);
  try {
    const r = await post(`/db/${DB}/tx/commit`, {statements:[{statement:stmt}]});
    if (r.errors && r.errors.length) {
      out.innerHTML = '<span class="err">' + esc(r.errors[0].message) + '</span>';
    } else {
      const res = r.results[0] || {columns:[], data:[]};
      const table = document.createElement('table');
      const head = document.createElement('tr');
      head.innerHTML = res.columns.map(c=>'<th>'+esc(c)+'</th>').join('');
      table.appendChild(head);
      for (const row of res.data) {
        const tr = document.createElement('tr');
        for (const v of row.row) {
          const td = document.createElement('td');
          td.innerText = JSON.stringify(v);
          if (isNodeValue(v)) {
            td.append(document.createElement('br'));
            const ed = document.createElement('button');
            ed.className = 'small';
            ed.innerText = 'edit';
            ed.addEventListener('click', () => editNode(v));
            const del = document.createElement('button');
            del.className = 'small danger';
            del.innerText = 'delete';
            del.addEventListener('click', () => deleteNode(v));
            td.append(ed, del);
          }
          tr.appendChild(td);
        }
        table.appendChild(tr);
      }
      out.innerHTML = '';
      out.appendChild(table);
      if (res.stats && Object.keys(res.stats).length) {
        const d = document.createElement('div');
        d.innerText = JSON.stringify(res.stats);
        out.appendChild(d);
      }
    }
  } catch (e) { out.innerHTML = '<span class="err">'+esc(String(e))+'</span>'; }
  refreshStats();
}

async function runSearch() {
  const out = document.getElementById('search-out');
  const r = await post('/nornicdb/search',
    {query: document.getElementById('q').value, limit: 8});
  out.innerText = (r.results||[]).map(
    x => x.score.toFixed(3) + '  ' + x.content).join('\\n') || '(no results)';
}

async function runChat() {
  const out = document.getElementById('chat-out');
  const r = await post('/api/bifrost/chat/completions',
    {messages:[{role:'user', content: document.getElementById('chat').value}]});
  out.innerText = r.choices ? r.choices[0].message.content : JSON.stringify(r);
}

// -- admin view --------------------------------------------------------------
async function loadUsers() {
  const box = document.getElementById('users-table');
  try {
    const users = await get('/auth/users');
    // build rows with addEventListener, never string-interpolated inline
    // handlers — usernames are user-controlled input
    const table = document.createElement('table');
    table.innerHTML =
      '<tr><th>user</th><th>role</th><th>status</th><th></th></tr>';
    for (const u of users) {
      const role = (u.roles||[])[0] || 'viewer';
      const tr = document.createElement('tr');
      const tdName = document.createElement('td');
      tdName.innerText = u.username;
      const tdRole = document.createElement('td');
      const sel = document.createElement('select');
      for (const r of ['viewer','editor','admin']) {
        const o = document.createElement('option');
        o.text = r; o.selected = (r === role);
        sel.add(o);
      }
      sel.addEventListener('change', () => setRole(u.username, sel.value));
      tdRole.appendChild(sel);
      const tdStatus = document.createElement('td');
      tdStatus.innerHTML = u.disabled
        ? '<span class="err">disabled</span>'
        : '<span class="ok">active</span>';
      const tdActions = document.createElement('td');
      tdActions.className = 'row';
      const toggle = document.createElement('button');
      toggle.className = 'small';
      toggle.innerText = u.disabled ? 'enable' : 'disable';
      toggle.addEventListener('click', () =>
        setDisabled(u.username, !u.disabled));
      const del = document.createElement('button');
      del.className = 'small danger';
      del.innerText = 'delete';
      del.addEventListener('click', () => deleteUser(u.username));
      tdActions.append(toggle, del);
      tr.append(tdName, tdRole, tdStatus, tdActions);
      table.appendChild(tr);
    }
    box.innerHTML = '';
    box.appendChild(table);
  } catch (e) {
    box.innerHTML = '<span class="err">' + esc(String(e)) + '</span>';
  }
}
function adminMsg(text, isErr) {
  const m = document.getElementById('admin-msg');
  m.innerText = text; m.className = isErr ? 'err' : 'ok';
}
async function createUser() {
  const r = await fetch('/auth/users', {method:'POST', credentials:'include',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({
      username: document.getElementById('new-user').value,
      password: document.getElementById('new-pass').value,
      roles: [document.getElementById('new-role').value]})});
  const body = await r.json();
  adminMsg(r.ok ? 'created ' + body.username : (body.error||'failed'), !r.ok);
  loadUsers();
}
async function setRole(name, role) {
  await fetch('/auth/users/' + encodeURIComponent(name), {method:'PUT',
    credentials:'include', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({roles:[role]})});
  loadUsers();
}
async function setDisabled(name, disabled) {
  await fetch('/auth/users/' + encodeURIComponent(name), {method:'PUT',
    credentials:'include', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({disabled})});
  loadUsers();
}
async function deleteUser(name) {
  if (!confirm('delete user ' + name + '?')) return;
  await fetch('/auth/users/' + encodeURIComponent(name),
    {method:'DELETE', credentials:'include'});
  loadUsers();
}
async function loadStats() {
  const box = document.getElementById('admin-stats');
  try {
    const s = await get('/admin/stats');
    let rows = '';
    const flat = (obj, prefix) => {
      for (const [k, v] of Object.entries(obj)) {
        if (v && typeof v === 'object' && !Array.isArray(v))
          flat(v, prefix + k + '.');
        else
          rows += `<tr><td>${esc(prefix+k)}</td><td>${esc(JSON.stringify(v))}</td></tr>`;
      }
    };
    flat(s, '');
    box.innerHTML = '<table><tr><th>metric</th><th>value</th></tr>' + rows + '</table>';
  } catch (e) {
    box.innerHTML = '<span class="err">' + esc(String(e)) + '</span>';
  }
}

// -- security view -----------------------------------------------------------
async function changePassword() {
  const m = document.getElementById('pw-msg');
  m.classList.remove('hidden');
  const r = await fetch('/auth/password', {method:'POST', credentials:'include',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({
      old_password: document.getElementById('old-pass').value,
      new_password: document.getElementById('new-pass2').value})});
  const body = await r.json();
  m.innerText = r.ok ? 'password changed' : (body.error || 'failed');
  m.className = r.ok ? 'ok' : 'err';
}
async function genToken() {
  const out = document.getElementById('token-out');
  out.classList.remove('hidden');
  const r = await fetch('/auth/api-token', {method:'POST', credentials:'include',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({
      subject: document.getElementById('token-subject').value,
      expires_in: parseInt(document.getElementById('token-ttl').value)})});
  const body = await r.json();
  out.innerText = r.ok
    ? 'Token (copy now — not shown again):\\n' + body.token
    : (body.error || 'failed');
  out.className = r.ok ? '' : 'err';
}

document.getElementById('cypher').addEventListener('keydown', e => {
  if (e.key === 'Enter' && (e.ctrlKey || e.metaKey)) runCypher();
});
boot();
setInterval(refreshStats, 5000);
</script>
</body>
</html>
"""
