// Shared frontend runtime for the platform's web apps — the
// kubeflow-common-lib analog (`crud-web-apps/common/frontend/`):
// API client with the backend's success/error envelope, exponential
// backoff polling (`polling/exponential-backoff.ts`), status rendering,
// and small DOM helpers. Dependency-free ES module.

export async function api(path, opts = {}) {
  const resp = await fetch(path, {
    headers: { "content-type": "application/json", ...(opts.headers || {}) },
    method: opts.method || "GET",
    body: opts.body === undefined ? undefined : JSON.stringify(opts.body),
  });
  let payload = {};
  try { payload = await resp.json(); } catch { /* non-JSON error body */ }
  if (!resp.ok || payload.success === false) {
    throw new Error(payload.log || payload.error || `HTTP ${resp.status}`);
  }
  return payload;
}

// Exponential-backoff poller: fast after user actions, settling toward
// `max` when nothing changes. reset() after any mutation.
export class Poller {
  constructor(fn, { base = 1000, max = 16000 } = {}) {
    this.fn = fn; this.base = base; this.max = max;
    this.delay = base; this.timer = null; this.stopped = false;
  }
  start() { this.stopped = false; this.tick(); return this; }
  stop() { this.stopped = true; clearTimeout(this.timer); }
  reset() { this.delay = this.base; clearTimeout(this.timer); this.tick(); }
  async tick() {
    if (this.stopped) return;
    try { await this.fn(); } catch (e) { console.warn("poll failed", e); }
    this.delay = Math.min(this.delay * 1.5, this.max);
    this.timer = setTimeout(() => this.tick(), this.delay);
  }
}

export function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === "onclick") node.addEventListener("click", v);
    else if (k === "class") node.className = v;
    else node.setAttribute(k, v);
  }
  for (const child of children) {
    node.append(child instanceof Node ? child : document.createTextNode(child));
  }
  return node;
}

export function statusCell(phase) {
  const cls = ["running", "ready", "waiting", "stopped", "error"]
    .includes(phase) ? phase : "waiting";
  return el("span", { class: `status ${cls}` },
    el("span", { class: "dot" }), phase);
}

export function ageCell(epochSeconds) {
  if (!epochSeconds) return "—";
  let s = Math.max(0, (Date.now() / 1000) - epochSeconds);
  const units = [[86400, "d"], [3600, "h"], [60, "m"], [1, "s"]];
  for (const [span, suffix] of units) {
    if (s >= span) return `${Math.floor(s / span)}${suffix}`;
  }
  return "0s";
}

export function showError(message) {
  const banner = document.querySelector(".error-banner");
  if (!banner) { alert(message); return; }
  banner.textContent = message;
  banner.style.display = "block";
  clearTimeout(showError._t);
  showError._t = setTimeout(() => { banner.style.display = "none"; }, 8000);
}

export function namespaceFromUrl() {
  return new URLSearchParams(location.search).get("ns") || "default";
}

// Shared namespace selector — the kubeflow-common-lib NamespaceService
// analog: every CRUD app offers /api/namespaces, the selection lives in
// the URL (?ns=), so links are shareable and the dashboard can drive
// iframed sub-apps with the same parameter.
export async function namespaceSelector(container, { onchange } = {}) {
  const current = namespaceFromUrl();
  let namespaces = [current];
  try {
    namespaces = (await api("/api/namespaces")).namespaces || [current];
  } catch { /* standalone page without the endpoint: keep URL value */ }
  if (!namespaces.includes(current)) namespaces.unshift(current);
  const select = el("select", { id: "ns-select", title: "namespace" },
    ...namespaces.map(ns => {
      const opt = el("option", { value: ns }, ns);
      if (ns === current) opt.selected = true;
      return opt;
    }));
  select.addEventListener("change", () => {
    const url = new URL(location.href);
    url.searchParams.set("ns", select.value);
    if (onchange) { history.pushState({}, "", url); onchange(select.value); }
    else location.href = url;  // full reload re-boots the page for the ns
  });
  container.textContent = "namespace: ";
  container.append(select);
  return select;
}

// Optimistic row update — the snack-bar/optimistic pattern of the
// common lib: reflect the user's action immediately, let the next poll
// converge to observed state (and any error banner explain a rollback).
export function optimistic(row, label) {
  if (!row) return;
  const cell = row.querySelector(".status");
  if (cell) {
    cell.replaceWith(statusCell("waiting"));
    row.querySelector(".status").lastChild.textContent = label;
  }
  for (const btn of row.querySelectorAll("button")) btn.disabled = true;
}
