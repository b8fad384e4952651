// Recipes view: browse the preset catalog and apply one as a live capture.

import { api } from "../api.js";
import { el, clear, fmtHz, toast, modal } from "../ui.js";
import { refreshAll } from "../store.js";

let rootEl = null;
let recipes = null;

async function applyRecipe(r) {
  const single = (r.channels || []).length === 1;
  const vals = await modal({
    title: `Apply — ${r.name}`,
    fields: [
      ...(single ? [{
        name: "frequencyHz", label: "Frequency (MHz, blank = recipe default)",
        type: "number", optional: true, value: "", step: "0.0001",
      }] : []),
      { name: "start", label: "Start immediately", type: "checkbox", value: true },
    ],
    submitLabel: "Apply",
  });
  if (!vals) return;
  try {
    const body = { start: vals.start };
    if (vals.frequencyHz) body.frequencyHz = vals.frequencyHz * 1e6;
    const out = await api.post(`/recipes/${r.id}/apply`, body);
    toast(`Created capture ${out.capture.id}` +
      (out.trunkingSystemId ? ` + trunking ${out.trunkingSystemId}` : ""));
    refreshAll();
    location.hash = "#/monitor";
  } catch (e) { toast(e.message, true); }
}

function card(r) {
  const cap = r.capture || {};
  return el("div", { class: "recipe-card" },
    el("div", { class: "cat" }, r.category || r.source || "recipe"),
    el("div", { style: "font-weight:600" }, r.name || r.id),
    el("div", { class: "desc" }, r.description || ""),
    el("div", { class: "mono muted", style: "font-size:11.5px" },
      `${fmtHz(cap.center_hz)} @ ${fmtHz(cap.sample_rate)} · ` +
      `${(r.channels || []).length} ch` +
      (r.trunking ? " · trunking" : "")),
    el("div", {},
      el("button", { class: "small primary", onClick: () => applyRecipe(r) },
        "Apply")));
}

async function render() {
  if (!rootEl) return;
  if (recipes === null) {
    try { recipes = await api.get("/recipes"); } catch { recipes = []; }
  }
  const byCat = {};
  for (const r of recipes) (byCat[r.category || "Other"] ??= []).push(r);
  clear(rootEl);
  rootEl.append(el("h1", {}, "Recipes"));
  for (const [cat, list] of Object.entries(byCat).sort()) {
    rootEl.append(
      el("h2", { style: "margin-top:14px" }, cat),
      el("div", { class: "recipe-grid" }, list.map(card)));
  }
  if (!recipes.length)
    rootEl.append(el("div", { class: "empty" }, "No recipes found."));
}

export function mountRecipes(container) {
  rootEl = container;
  render();
  return () => { rootEl = null; };
}
